"""The port's integrator and geometry helpers against the JAX package's,
on identical float64 inputs."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import kstest

from dynesty_tpu.ops import geometry as jgeom
from dynesty_tpu.ops import integrals as jint
from dynesty_tpu_torch.ops import geometry as tgeom
from dynesty_tpu_torch.ops import integrals as tint
from dynesty_tpu_torch.utils.misc import torch_generator

from utils import get_rstate

torch.set_num_threads(1)


def _cases():
    """(loglstar, loglstar_new, logz, logzvar, logvol, dlogvol, h) rows:
    a generic run, a plateau (equal thresholds), the clamped -1e30
    sentinel of a run's start, and a true -inf death."""
    rs = get_rstate()
    n = 64
    loglstar = np.sort(rs.normal(size=n)) * 3.0
    rows = []
    for i in range(1, n):
        rows.append((loglstar[i - 1], loglstar[i], rs.normal() - 5.0,
                     abs(rs.normal()) * 0.1, -0.01 * i, 1.0 / (100 + i),
                     abs(rs.normal())))
    rows.append((1.5, 1.5, -2.0, 0.3, -3.0, 0.004, 1.2))  # plateau
    rows.append((-1e30, -4.0, -1e30, 0.0, -0.001, 0.001, 0.0))  # start
    rows.append((-1e30, -1e30, -1e30, 0.0, -0.001, 0.001, 0.0))
    rows.append((-math.inf, -3.0, -1e30, 0.0, -0.001, 0.001, 0.0))
    return np.array(rows)


def test_progress_integration_torch_matches_jax():
    for row in _cases():
        want = [np.float64(x) for x in jint.progress_integration_jax(
            *[jnp.float64(x) for x in row])]
        got = [t.item() for t in tint.progress_integration_torch(
            *[torch.tensor(x, dtype=torch.float64) for x in row])]
        # float64 on both sides, the same operations in the same order.
        # XLA's and torch's exp/logaddexp differ by one ulp at some
        # inputs, and log1p(-exp(-dlogvol)) magnifies that by 1/dlogvol,
        # so the bound is 1e-14 relative times that condition number
        tol = 1e-14 * max(1.0, 1.0 / row[5])
        scale = max(abs(w) for w in want if np.isfinite(w))
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                                   equal_nan=True, err_msg=str(row))


def test_integration_primitives_agree_to_an_ulp():
    x = torch.from_numpy(_cases()[:, 5])
    y = torch.from_numpy(_cases()[:, 1])
    for tf, jf in ((torch.exp, jnp.exp), (torch.log1p, jnp.log1p)):
        np.testing.assert_allclose(tf(-x).numpy(),
                                   np.asarray(jf(-jnp.asarray(x.numpy()))),
                                   rtol=4.5e-16, atol=0)
    np.testing.assert_allclose(
        torch.logaddexp(x, y).numpy(),
        np.asarray(jnp.logaddexp(x.numpy(), y.numpy())), rtol=4.5e-16,
        atol=0)


def test_host_integrals_match_jax():
    rs = get_rstate()
    logl = np.sort(rs.normal(size=200))
    logvol = -np.cumsum(rs.random(200) * 0.02 + 0.001)
    logvol[50] = logvol[49]  # a zero-width shell
    for got, want in zip(tint.compute_integrals(logl=logl, logvol=logvol),
                         jint.compute_integrals(logl=logl, logvol=logvol)):
        assert np.array_equal(got, want)
    for row in _cases()[:-1]:
        assert tint.progress_integration(*row) == \
            jint.progress_integration(*row)


@pytest.mark.parametrize("nonbounded", [None, [True, False, True]])
def test_unitcheck_batch_matches_jax(nonbounded):
    u = get_rstate().random((500, 3)) * 2.2 - 0.6
    want = np.asarray(jgeom.unitcheck_batch(jnp.asarray(u), nonbounded))
    got = tgeom.unitcheck_batch(torch.from_numpy(u), nonbounded).numpy()
    assert np.array_equal(got, want)


def test_randsphere_batch_uniform_in_ball():
    gen = torch_generator(5, "cpu")
    x = tgeom.randsphere_batch(gen, (4000,), 3, torch.float64, "cpu")
    r = torch.linalg.vector_norm(x, dim=-1).numpy()
    assert r.max() <= 1.0
    # uniform in the 3-ball: r^3 is uniform on (0, 1)
    assert kstest(r ** 3, "uniform").pvalue > 1e-4


def test_host_geometry_helpers_match_jax():
    rs = get_rstate()
    for n in (1, 3, 8):
        assert tgeom.logvol_prefactor(n) == jgeom.logvol_prefactor(n)
    cov = np.cov(rs.normal(size=(50, 4)), rowvar=False)
    cov[0, 1] = cov[1, 0] = 1e6  # not positive definite: repaired
    for got, want in zip(tgeom.improve_covar_mat(cov)[:4],
                         jgeom.improve_covar_mat(cov)[:4]):
        assert np.array_equal(got, want)
