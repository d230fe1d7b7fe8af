"""The concentric-shell plateau suite of ``tests/test_plateau.py``, run on
the port at the same small sizes.

The ``Plateau`` likelihood is piecewise constant over concentric spheres:
the sharpest test of the plateau bookkeeping (the consume loop's plateau
entry and exit, the terminal plateau stop, the live-point recycling's
plateau branch, the merge's plateau volumes) against the analytic logz.
Gate: 3 logzerr, as in the JAX package's suite.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy.special import gammaln, logsumexp

import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.utils.runs import merge_runs

from utils import get_rstate

torch.set_num_threads(1)


class Plateau:
    """Value ``as_[k]`` between radii ``rs[k]`` and ``rs[k+1]``, ``as_[-1]``
    outside the last sphere, on the box ``-s < x < s``."""

    def __init__(self, ndim, rs=(1.0,), as_=(10.0, 1.0), s=3.0):
        assert len(rs) + 1 == len(as_)
        assert rs[-1] < s
        self.ndim = ndim
        self.s = s
        self.rs = np.concatenate([[0.0], np.asarray(rs, dtype=float)])
        self.log_as = np.log(np.asarray(as_, dtype=float))
        self._rs_t = torch.as_tensor(self.rs)
        self._log_as_t = torch.as_tensor(self.log_as)

    def loglike(self, x):
        r = torch.sqrt(torch.sum(x ** 2))
        xid = torch.searchsorted(self._rs_t, r.reshape(1), right=True)[0]
        return self._log_as_t[xid - 1]

    def ptform(self, u):
        return (2.0 * u - 1.0) * self.s

    @property
    def logz_true(self):
        n = self.ndim
        logmult = n / 2.0 * np.log(np.pi) - gammaln(n / 2.0 + 1)
        logvols = np.zeros(len(self.rs))
        logvols[:-1] = logmult + n * np.log(self.rs[1:]) + \
            np.log1p(-(self.rs[:-1] / self.rs[1:]) ** n)
        logvols[-1] = n * np.log(2 * self.s) + np.log1p(
            -np.exp(logmult + n * np.log(self.rs[-1] / (2 * self.s))))
        logprior = -n * np.log(2 * self.s)
        return logsumexp(self.log_as + logvols) + logprior


def _assert_close(res, plateau):
    assert np.abs(res.logz[-1] - plateau.logz_true) < 3 * res.logzerr[-1], \
        (res.logz[-1], plateau.logz_true, res.logzerr[-1])


@pytest.mark.parametrize("sample,dlogz", [("unif", 1), ("rwalk", 1),
                                          ("rslice", 1), ("unif", .01),
                                          ("rwalk", .01), ("rslice", .01)])
def test_static(sample, dlogz):
    nlive = 1000 if sample == "unif" else 400
    plateau = Plateau(2)
    sampler = dyt.NestedSampler(plateau.loglike, plateau.ptform,
                                plateau.ndim, nlive=nlive,
                                rstate=get_rstate(), bound="none",
                                sample=sample, queue_size=64, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sampler.run_nested(print_progress=False, dlogz=dlogz)
    _assert_close(sampler.results, plateau)
    if dlogz < 1:
        # the run ends on the live set's plateau (terminal cause 4), and
        # the recycled live points all sit on it
        assert any("plateau was reached" in str(w.message) for w in caught)
        assert np.ptp(sampler.results.logl[-nlive:]) == 0


@pytest.mark.parametrize("sample", ["unif", "rslice", "rwalk"])
def test_dynamic(sample):
    plateau = Plateau(2)
    sampler = dyt.DynamicNestedSampler(plateau.loglike, plateau.ptform,
                                       plateau.ndim, nlive=100,
                                       rstate=get_rstate(), bound="none",
                                       sample=sample, queue_size=32,
                                       device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sampler.run_nested(print_progress=False)
    _assert_close(sampler.results, plateau)


def test_merge():
    rstate = get_rstate()
    plateau = Plateau(2)
    res_list = []
    for _ in range(3):
        sampler = dyt.NestedSampler(plateau.loglike, plateau.ptform,
                                    plateau.ndim, nlive=100, rstate=rstate,
                                    bound="none", sample="unif",
                                    queue_size=32, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sampler.run_nested(print_progress=False)
        res_list.append(sampler.results)
    _assert_close(merge_runs(res_list), plateau)
