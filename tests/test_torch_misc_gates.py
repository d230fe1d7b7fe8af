"""End-to-end gates of ``tests/test_misc.py`` held on the port, on the
CPU: an early first bound update, the refit cadence of
``update_interval``, the cost of repeated full batches, batches whose
live count differs from the base run's, and dispatches planned ahead of
their refit.  Each test keeps the JAX
package's name, configuration and gate; the problem is the 3-D correlated
Gaussian written in torch.
"""

import numpy as np
import pytest
import torch

import dynesty_tpu_torch as dyt

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
LOGZ_TRUTH = NDIM * (-np.log(20.0))


def _gau():
    cov = np.identity(NDIM)
    cov[cov == 0] = 0.95
    cinv = torch.as_tensor(np.linalg.inv(cov))
    lnorm = -0.5 * (np.log(2 * np.pi) * NDIM +
                    np.log(np.linalg.det(cov)))

    def loglike(x):
        return -0.5 * torch.dot(x, cinv @ x) + lnorm

    def ptform(u):
        return 10.0 * (2.0 * u - 1.0)

    return loglike, ptform


def test_batch_cost_stability():
    # repeated 'full' batches should cost comparably (reference #415,
    # test_misc.py:511-536)
    loglike, ptform = _gau()
    dns = dyt.DynamicNestedSampler(loglike, ptform, NDIM, bound="single",
                                   sample="unif", rstate=get_rstate(),
                                   queue_size=64, device="cpu")
    dns.run_nested(nlive_init=150, maxbatch=0, print_progress=False)
    costs = []
    for _ in range(5):
        nc0 = dns.ncall
        dns.add_batch(nlive=100, mode="manual",
                      logl_bounds=(-np.inf, np.inf), print_progress=False)
        costs.append(dns.ncall - nc0)
    assert max(costs) / min(costs) < 3, costs


def test_nlive_mismatch_batches():
    # batches with nlive different from the baseline merge correctly
    loglike, ptform = _gau()
    dns = dyt.DynamicNestedSampler(loglike, ptform, NDIM, bound="single",
                                   sample="unif", rstate=get_rstate(),
                                   queue_size=32, device="cpu")
    dns.run_nested(nlive_init=200, maxbatch=0, print_progress=False)
    dns.add_batch(nlive=37, print_progress=False)
    dns.add_batch(nlive=151, print_progress=False)
    res = dns.results
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 5 * res.logzerr[-1]
    assert np.all(np.diff(res.logl) >= 0)
    assert set(np.unique(res.samples_batch)) == {0, 1, 2}


def test_first_update():
    # forcing a very early first update switches off cube sampling fast
    loglike, ptform = _gau()
    sampler = dyt.NestedSampler(
        loglike, ptform, NDIM, nlive=120, bound="single", sample="unif",
        first_update={"min_ncall": 10, "min_eff": 100.0},
        rstate=get_rstate(), queue_size=32, device="cpu")
    sampler.run_nested(maxiter=300, print_progress=False)
    assert not sampler.unit_cube_sampling
    assert sampler.nbound > 1

    with pytest.raises(ValueError):
        dyt.NestedSampler(loglike, ptform, NDIM,
                          first_update={"bogus_key": 1}, device="cpu")


def test_update_interval_semantics():
    # small update_interval => more bound refits
    loglike, ptform = _gau()
    nbounds = []
    for interval in (0.2, 10.0):
        sampler = dyt.NestedSampler(loglike, ptform, NDIM, nlive=150,
                                    bound="single", sample="unif",
                                    update_interval=interval,
                                    rstate=get_rstate(), queue_size=32,
                                    device="cpu")
        sampler.run_nested(print_progress=False)
        nbounds.append(sampler.nbound)
    assert nbounds[0] > nbounds[1]


def test_pipelining_engages():
    """Regression gate for ``_pipeline_capable``: an ellipsoid-bound run
    with a traceable likelihood plans dispatches ahead of their refit, and
    a natural (dlogz-terminated) stop strands no planned work."""
    loglike, ptform = _gau()
    s = dyt.NestedSampler(loglike, ptform, NDIM, nlive=200, bound="single",
                          sample="unif", rstate=get_rstate(), queue_size=32,
                          device="cpu")
    s.run_nested(print_progress=False)
    t = s.timings
    assert t.get("n_prelaunch", 0) >= 1, \
        f"dispatches were never planned ahead: {dict(t)}"
    assert t["prelaunch"] >= 0.0
    # the run above terminated on dlogz: no planned dispatch was stranded
    assert t.get("nc_stranded_pipeline", 0) == 0
