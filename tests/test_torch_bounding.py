"""The port's bounds against the JAX package's on the same points.

At 2048 points the friends radius comes from float32 leave-one-out
distances on the device (the port's plain version on the CPU, the JAX
package's jnp reference); below 2048 both stay on the host in float64."""

import numpy as np
import pytest
import torch

import dynesty_tpu.bounding as jb
import dynesty_tpu_torch.bounding as tb
from dynesty_tpu_torch.ops import hopper_kernels as hk
from dynesty_tpu_torch.utils.convert import (bound_arrays_to_torch,
                                             bound_from_arrays)

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3


def _points(n):
    rs = get_rstate()
    cov = np.full((NDIM, NDIM), 0.9) + 0.1 * np.eye(NDIM)
    return 0.5 + 0.05 * rs.multivariate_normal(np.zeros(NDIM), cov, n)


@pytest.mark.parametrize("cls", ["RadFriends", "SupFriends"])
@pytest.mark.parametrize("n", [500, 2048])
def test_friends_update_matches_jax(n, cls):
    pts = _points(n)
    jbound = getattr(jb, cls)(NDIM)
    tbound = getattr(tb, cls)(NDIM, device="cpu")
    calls = hk.pairwise_min_dist.calls
    jbound.update(pts, rstate=get_rstate(), bootstrap=0)
    tbound.update(pts, rstate=get_rstate(), bootstrap=0)
    # the device path is taken exactly at and above 2048 points
    assert hk.pairwise_min_dist.calls == calls + (n >= 2048)
    # float32 radii at 2048 (summation order differs): 1e-6 relative;
    # float64 host radii below: the same arithmetic
    rtol = 1e-6 if n >= 2048 else 1e-12
    np.testing.assert_allclose(tbound.cov, jbound.cov, rtol=rtol)
    np.testing.assert_allclose(tbound.axes, jbound.axes, rtol=rtol,
                               atol=rtol * np.abs(jbound.axes).max())
    np.testing.assert_allclose(tbound.logvol, jbound.logvol, rtol=rtol)
    assert np.array_equal(tbound.ctrs, jbound.ctrs)
    x = pts[0] + 1e-4
    assert tbound.contains(x) == jbound.contains(x)


def test_ellipsoid_update_matches_jax():
    pts = _points(500)
    jell, tell = jb.Ellipsoid(NDIM), tb.Ellipsoid(NDIM)
    jell.update(pts, bootstrap=0)
    tell.update(pts, bootstrap=0)
    for k in ("ctr", "cov", "am", "axes"):
        assert np.array_equal(getattr(tell, k), getattr(jell, k)), k
    assert tell.logvol == jell.logvol
    jell.scale_to_logvol(jell.logvol + np.log(1.25))
    tell.scale_to_logvol(tell.logvol + np.log(1.25))
    assert np.array_equal(tell.axes, jell.axes)


@pytest.mark.parametrize("kind", ["balls", "ellipsoids"])
def test_bound_state_carried_across(kind):
    """A bound fitted by the JAX package, rebuilt in the port from its
    numpy arrays, exports the same device arrays."""
    pts = _points(300)
    if kind == "balls":
        jbound = jb.RadFriends(NDIM)
        jbound.update(pts, bootstrap=0)
        arrays = {k: getattr(jbound, k) for k in
                  ("cov", "am", "axes", "axes_inv", "ctrs", "logvol")}
    else:
        jbound = jb.Ellipsoid(NDIM)
        jbound.update(pts, bootstrap=0)
        arrays = {k: getattr(jbound, k) for k in ("ctr", "cov", "am",
                                                  "axes", "logvol")}
    tbound = bound_from_arrays(kind, NDIM, arrays, device="cpu")
    jkind, jarr = jbound.device_spec()
    tkind, tarr = tbound.device_spec()
    assert jkind == tkind == kind
    dev = bound_arrays_to_torch(tkind, tarr, "cpu")
    for k, v in jarr.items():
        assert np.array_equal(dev[k][:len(v)].numpy(), v), k
    assert tbound.logvol == jbound.logvol


def test_unported_bounds_raise():
    with pytest.raises(NotImplementedError):
        tb.get_bound("multi", NDIM)
    with pytest.raises(NotImplementedError):
        tb.RadFriends(NDIM, device="cpu").update(_points(50), bootstrap=5)
