"""End-to-end gates of ``tests/test_hard.py`` held on the port, on the
CPU: the Gaussian shells (from ``dynesty_tpu_torch.models``) and the
1/|x| pathology, each under the JAX package's name, configuration and
gate.  ``test_highdim`` and ``test_rosenbrock_posterior`` are marked slow
there and are not re-stated.
"""

import numpy as np
import torch

import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.models import GaussianShells

from utils import get_rstate

torch.set_num_threads(1)


def test_gaussian_shells():
    prob = GaussianShells()
    rstate = get_rstate()
    sampler = dyt.NestedSampler(prob.loglike, prob.ptform, 2, nlive=500,
                                bound="multi", sample="unif", rstate=rstate,
                                queue_size=128, device="cpu")
    sampler.run_nested(print_progress=False, dlogz=0.01)
    res = sampler.results
    assert abs(res.logz[-1] - prob.logz_truth) < 5 * res.logzerr[-1], \
        (res.logz[-1], res.logzerr[-1])
    # bimodal posterior: both shells populated
    eq = res.samples_equal(rstate=rstate)
    assert (eq[:, 0] < 0).mean() > 0.2
    assert (eq[:, 0] > 0).mean() > 0.2


def test_pathology():
    # 1/|x0| spike capped at alpha, flat in x1, with a tiny tilt to
    # avoid an exact plateau; logz = log(1 - log(alpha))
    alpha = 1e-8

    def loglike(x):
        logl = -torch.log(torch.clamp(torch.abs(x[0]), min=alpha))
        return logl - 1e-8 * torch.sum(x ** 2)

    def ptform(u):
        return 2.0 * u - 1.0

    truth = np.log(1 - np.log(alpha))
    sampler = dyt.NestedSampler(loglike, ptform, 2, nlive=500,
                                bound="multi", sample="rslice",
                                rstate=get_rstate(), queue_size=128,
                                device="cpu")
    sampler.run_nested(print_progress=False, dlogz=0.1)
    res = sampler.results
    assert abs(res.logz[-1] - truth) < 4 * res.logzerr[-1], \
        (res.logz[-1], truth, res.logzerr[-1])
