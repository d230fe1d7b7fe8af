"""End-to-end gates of ``tests/test_static.py`` held on the port, on the
CPU: user-given live points, the generator API, the results API,
posterior moments against the analytic truth, and the determinism of the
queue proposal mode.  Each test keeps the JAX package's name,
configuration and gate; the problem is the 3-D correlated Gaussian
(rho = 0.95, prior +-10) written in torch.
"""

import warnings

import numpy as np
import pytest
import torch

import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.utils import mean_and_cov

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
CORR = 0.95
PRIOR_WIN = 10.0
LOGZ_TRUTH = NDIM * (-np.log(2 * PRIOR_WIN))


def _make_gau(ndim=NDIM, corr=CORR):
    cov = np.identity(ndim)
    cov[cov == 0] = corr
    cinv = torch.as_tensor(np.linalg.inv(cov))
    lnorm = -0.5 * (np.log(2 * np.pi) * ndim +
                    np.log(np.linalg.det(cov)))

    def loglike(x):
        return -0.5 * torch.dot(x, cinv @ x) + lnorm

    def ptform(u):
        return PRIOR_WIN * (2.0 * u - 1.0)

    return loglike, ptform


def _check_result_gau(results, sig=4):
    logz = results.logz[-1]
    logzerr = results.logzerr[-1]
    assert abs(logz - LOGZ_TRUTH) < sig * logzerr, (logz, logzerr)


def test_generator_api():
    loglike, ptform = _make_gau()
    sampler = dyt.NestedSampler(loglike, ptform, NDIM, nlive=150,
                                bound="single", sample="unif",
                                rstate=get_rstate(), queue_size=64,
                                device="cpu")
    for it, res in enumerate(sampler.sample(dlogz=0.5)):
        pass
    for it2, res in enumerate(sampler.add_live_points()):
        pass
    assert it2 == 149
    _check_result_gau(sampler.results, sig=5)


def test_user_live_points():
    loglike, ptform = _make_gau()
    rstate = get_rstate()
    nlive = 120
    live_u = rstate.random((nlive, NDIM))
    live_v = np.array([ptform(torch.as_tensor(u)).numpy() for u in live_u])
    live_logl = np.array([float(loglike(torch.as_tensor(v)))
                          for v in live_v])
    sampler = dyt.NestedSampler(loglike, ptform, NDIM, nlive=nlive,
                                bound="single", sample="unif",
                                live_points=[live_u, live_v, live_logl],
                                rstate=rstate, queue_size=32, device="cpu")
    sampler.run_nested(print_progress=False)
    _check_result_gau(sampler.results, sig=5)


def test_results_api():
    loglike, ptform = _make_gau()
    rstate = get_rstate()
    sampler = dyt.NestedSampler(loglike, ptform, NDIM, nlive=150,
                                bound="single", sample="unif",
                                rstate=rstate, queue_size=64, device="cpu")
    sampler.run_nested(print_progress=False)
    res = sampler.results
    assert not res.isdynamic()
    w = res.importance_weights()
    assert abs(w.sum() - 1) < 1e-10
    eq = res.samples_equal(rstate=rstate)
    assert eq.shape[1] == NDIM
    mean = eq.mean(axis=0)
    assert np.all(np.abs(mean) < 1.0)
    res.summary()
    # immutability
    with pytest.raises(RuntimeError):
        res.logz = None
    res2 = res.copy()
    assert np.allclose(res2.logz, res.logz)


def _bootstrap_tol(results, rstate):
    """Bootstrap uncertainty of posterior means/covs (the JAX package's
    helper, after reference test_gau.py:19-61)."""
    pos = np.asarray(results.samples)
    wts = results.importance_weights()
    means, covs = [], []
    for _ in range(50):
        sub = rstate.uniform(size=len(pos)) < wts / wts.max()
        idx0 = np.nonzero(sub)[0]
        idx = rstate.choice(idx0, size=len(idx0), replace=True)
        means.append(pos[idx].mean(axis=0))
        covs.append(np.cov(pos[idx].T))
    return np.std(means, axis=0), np.std(covs, axis=0)


def test_posterior_moments():
    # posterior mean/cov must match the analytic truth within bootstrap
    # tolerances (reference check_results pattern)
    loglike, ptform = _make_gau()
    cov_truth = np.identity(NDIM)
    cov_truth[cov_truth == 0] = CORR
    rstate = get_rstate()
    sampler = dyt.NestedSampler(loglike, ptform, NDIM, nlive=400,
                                bound="multi", sample="unif",
                                rstate=rstate, queue_size=128, device="cpu")
    sampler.run_nested(print_progress=False)
    res = sampler.results
    mean_tol, cov_tol = _bootstrap_tol(res, rstate)
    mean, cov = mean_and_cov(np.asarray(res.samples),
                             res.importance_weights())
    assert np.all(np.abs(mean) < 4 * mean_tol + 0.02), (mean, mean_tol)
    assert np.all(np.abs(cov - cov_truth) < 4 * cov_tol + 0.05), \
        (cov, cov_tol)


def test_queue_mode_determinism():
    loglike, ptform = _make_gau()
    runs = []
    for _ in range(2):
        s = dyt.NestedSampler(loglike, ptform, NDIM, nlive=100,
                              bound="single", sample="rwalk",
                              rstate=get_rstate(), queue_size=32,
                              proposal_mode="queue", device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.run_nested(print_progress=False, maxiter=300, add_live=False)
        runs.append(s.results)
    assert np.array_equal(runs[0].logl, runs[1].logl)
    assert np.array_equal(runs[0].logz, runs[1].logz)
