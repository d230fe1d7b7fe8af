"""End-to-end gates of ``tests/test_features.py`` held on the port, on the
CPU: the wedding-cake plateau likelihood (from
``dynesty_tpu_torch.models``), a flat likelihood inside a ball, a
likelihood that is -inf over half the cube, and the vectorized likelihood
mode.  Each test keeps the JAX package's name, configuration (nlive,
bound, sample, queue width, seed) and gate.
"""

import warnings

import numpy as np
import torch

import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.models import WeddingCake

from utils import get_rstate

torch.set_num_threads(1)


def test_wedding_cake():
    prob = WeddingCake(ndim=2, sig=0.2, alpha=0.7)
    sampler = dyt.NestedSampler(prob.loglike, prob.ptform, 2, nlive=300,
                                bound="single", sample="unif",
                                rstate=get_rstate(), queue_size=64,
                                device="cpu")
    sampler.run_nested(print_progress=False)
    res = sampler.results
    assert abs(res.logz[-1] - prob.logz_truth) < 4 * res.logzerr[-1], \
        (res.logz[-1], prob.logz_truth, res.logzerr[-1])


def test_flat_likelihood_shell():
    # constant likelihood inside a ball, -inf outside: logz is the log
    # volume fraction of the ball in the prior cube
    r0 = 0.3

    def loglike(x):
        r = torch.linalg.vector_norm(x - 0.5)
        return torch.where(r < r0, 1.0, -torch.inf).to(x.dtype)

    def ptform(u):
        return u

    truth = 1.0 + np.log(np.pi * r0 ** 2)  # 2-D ball volume
    sampler = dyt.NestedSampler(loglike, ptform, 2, nlive=300,
                                bound="single", sample="unif",
                                rstate=get_rstate(), queue_size=64,
                                device="cpu")
    sampler.run_nested(print_progress=False)
    res = sampler.results
    # plateau runs have larger uncertainties; the JAX package's generous
    # gate
    err = max(res.logzerr[-1], 1e-3)
    assert abs(res.logz[-1] - truth) < 5 * np.sqrt(err ** 2 + 0.01), \
        (res.logz[-1], truth)


def test_inf_edge():
    # half the cube is -inf: logz = log(0.5)
    def loglike(x):
        return torch.where(x[0] < 0.5, 0.0, -torch.inf).to(x.dtype)

    def ptform(u):
        return u

    sampler = dyt.NestedSampler(loglike, ptform, 2, nlive=200,
                                bound="single", sample="unif",
                                rstate=get_rstate(), queue_size=32,
                                device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sampler.run_nested(print_progress=False, maxiter=500)
    res = sampler.results
    assert np.isfinite(res.logz[-1])


def test_vectorized_likelihood_mode():
    """likelihood_mode='vectorized': the user callables already take
    (N, ndim) batches."""
    cov = np.identity(3)
    cov[cov == 0] = 0.95
    cinv = torch.as_tensor(np.linalg.inv(cov))
    lnorm = -0.5 * (np.log(2 * np.pi) * 3 + np.log(np.linalg.det(cov)))

    def loglike(x):  # (N, ndim) -> (N,)
        return -0.5 * torch.einsum("ni,ij,nj->n", x, cinv, x) + lnorm

    def ptform(u):  # (N, ndim) -> (N, ndim)
        return 10.0 * (2.0 * u - 1.0)

    sampler = dyt.NestedSampler(loglike, ptform, 3, nlive=150,
                                bound="single", sample="unif",
                                likelihood_mode="vectorized",
                                rstate=get_rstate(), queue_size=64,
                                device="cpu")
    sampler.run_nested(print_progress=False)
    res = sampler.results
    truth = 3 * (-np.log(20.0))
    assert abs(res.logz[-1] - truth) < 4 * res.logzerr[-1]
