"""End to end on the CPU: the port's first slice (RadFriends bounds,
rslice proposals, nlive = 2048, the canonical 3-D correlated Gaussian)
against the analytic evidence and against a JAX run of the same
configuration."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynesty_tpu as dytpu
import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.ops import hopper_kernels as hk

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
SEED = 56432
LOGZ_TRUTH = -8.987  # analytic: -ndim * ln(20), the prior box is +-10


def _problem():
    cov = np.identity(NDIM)
    cov[cov == 0] = 0.95
    cinv = np.linalg.inv(cov)
    lnorm = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(cov)))
    return cinv, lnorm


def _torch_sampler(nlive, bound, **kw):
    cinv, lnorm = _problem()
    cinv_t = torch.as_tensor(cinv)

    def loglike(x):
        return -0.5 * (x @ cinv_t @ x) + lnorm

    def ptform(u):
        return 10.0 * (2.0 * u - 1.0)

    return dyt.NestedSampler(loglike, ptform, NDIM, nlive=nlive,
                             bound=bound, sample="rslice", device="cpu",
                             rstate=get_rstate(SEED), **kw)


def _jax_results(nlive, bound):
    cinv, lnorm = _problem()

    def loglike(x):
        return -0.5 * jnp.dot(x, jnp.asarray(cinv) @ x) + lnorm

    def ptform(u):
        return 10.0 * (2.0 * u - 1.0)

    s = dytpu.NestedSampler(loglike, ptform, NDIM, nlive=nlive,
                            bound=bound, sample="rslice",
                            rstate=get_rstate(SEED))
    s.run_nested(print_progress=False)
    return s.results


def test_slice_balls_rslice_2048_against_truth_and_jax():
    calls = hk.pairwise_min_dist.calls
    s = _torch_sampler(2048, "balls")
    s.run_nested(print_progress=False)
    res = s.results
    logz, err = res.logz[-1], res.logzerr[-1]
    assert abs(logz - LOGZ_TRUTH) < 4 * err
    # the friends radius went through the kernel-path dispatch (on the
    # CPU that is its plain version) at the refits with >= 2048 points
    assert hk.pairwise_min_dist.calls - calls >= 1
    assert s.nbound > 2 and s.timings["n_refit"] == s.nbound - 1
    # every record has finite float64 integrals and the right shapes
    assert res.samples.shape == (res.niter + 2048, NDIM)
    assert np.all(np.isfinite(res.logwt)) and np.all(np.diff(res.logvol) < 0)

    jres = _jax_results(2048, "balls")
    jlogz, jerr = jres.logz[-1], jres.logzerr[-1]
    assert abs(logz - jlogz) < 3 * np.hypot(err, jerr)
    assert abs(res.niter - jres.niter) < 0.1 * jres.niter


def test_single_rslice_reproducible():
    runs = []
    for _ in range(2):
        s = _torch_sampler(256, "single")
        s.run_nested(print_progress=False)
        runs.append(s.results)
    a, b = runs
    assert abs(a.logz[-1] - LOGZ_TRUTH) < 4 * a.logzerr[-1]
    for key in ("logl", "logvol", "logwt", "logz", "logzerr", "ncall",
                "samples", "samples_u", "samples_it", "samples_id",
                "samples_n", "samples_birth", "scale"):
        assert np.array_equal(a[key], b[key]), key
    assert a.niter == b.niter


def test_progress_printing_path(capsys):
    s = _torch_sampler(64, "single", queue_size=16)
    s.run_nested(print_progress=True, maxiter=200)
    err = capsys.readouterr().err
    assert "iter:" in err and "logz:" in err
    assert s.results.niter >= 200


def test_unported_entry_points_raise():
    with pytest.raises(ValueError, match="device"):
        dyt.NestedSampler(lambda x: x.sum(), lambda u: u, 2, device=None)
    for bound, sample in (("multi", "rslice"), ("balls", "unif"),
                          ("balls", "rwalk"), ("balls", "slice")):
        with pytest.raises(NotImplementedError):
            dyt.NestedSampler(lambda x: -x @ x, lambda u: u, 2, nlive=20,
                              bound=bound, sample=sample, device="cpu")


def test_import_leaves_jax_out():
    code = ("import sys, dynesty_tpu_torch; "
            "assert 'jax' not in sys.modules; "
            "assert 'dynesty_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


@pytest.mark.parametrize("bound", ["none", "cubes", "balls"])
def test_small_runs_pass_the_gate(bound):
    s = _torch_sampler(128, bound, queue_size=32)
    s.run_nested(print_progress=False)
    res = s.results
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 4 * res.logzerr[-1]
    assert s.nbound > 1


def test_start_point_outside_the_bound_forces_a_refit():
    s = _torch_sampler(128, "single", queue_size=32)
    s.run_nested(print_progress=False, maxiter=600)
    nbound = s.nbound
    far = int(np.argmax([s.bound.distance(u) for u in s.live_u]))
    s.bound.scale_to_logvol(s.bound.logvol - 3.0)  # shrink: points escape
    assert not s.bound.contains(s.live_u[far])
    s.ensure_startpoints_bounded([far])
    assert s.nbound == nbound + 1 and s.bound.contains(s.live_u[far])
