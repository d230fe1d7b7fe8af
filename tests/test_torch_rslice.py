"""Distributional tests of the port's raw proposal kernels (no nested
sampling loop), the pattern of tests/test_sampling.py: chains or
rejection rounds targeting a uniform density inside a hard constraint
must produce uniform samples."""

import numpy as np
import pytest
import torch
from scipy.stats import kstest

from dynesty_tpu_torch.internal.kernels import (make_slice_round,
                                                make_unif_round)
from dynesty_tpu_torch.internal.likelihood import LogLikelihood
from dynesty_tpu_torch.utils.misc import Timings, torch_generator

from utils import get_rstate

torch.set_num_threads(1)

Q = 512


def _diamond_like(mode="torch"):
    # uniform inside |x-0.5| + |y-0.5| < 0.5, -inf outside
    def loglike(x):
        inside = (x[..., 0] - 0.5).abs() + (x[..., 1] - 0.5).abs() < 0.5
        return torch.where(inside, 0.0, -torch.inf).to(x.dtype)

    like = LogLikelihood(loglike, lambda u: u, 2, device="cpu", mode=mode)
    like.eval_host(np.full((2, 2), 0.5))
    return like


@pytest.mark.parametrize("mode", ["torch", "vectorized"])
def test_rslice_chain_uniformity(mode):
    like = _diamond_like(mode)
    rstate = get_rstate()
    starts = []
    while len(starts) < Q:
        pts = rstate.random((4 * Q, 2))
        ok = np.abs(pts[:, 0] - 0.5) + np.abs(pts[:, 1] - 0.5) < 0.5
        starts.extend(pts[ok][:Q - len(starts)])
    u = np.array(starts)
    v, logl = u.copy(), np.zeros(Q)
    axes = np.tile(np.eye(2) * 0.5, (Q, 1, 1))
    timings = Timings()
    fn = make_slice_round(like, ndim=2, q=Q, slices=3, kind="rslice",
                          dtype=torch.float64, device="cpu",
                          timings=timings)
    for _ in range(3):  # chain rounds to decorrelate from the starts
        packed_in = torch.from_numpy(np.concatenate(
            [u, v, logl[:, None], axes.reshape(Q, -1)], axis=1))
        gen = torch_generator(int(rstate.integers(2**63)), "cpu")
        packed = fn(gen, packed_in, 1.0, -0.5).numpy()
        u, v, logl = packed[:, :2], packed[:, 2:4], packed[:, 4]
        nc, n_exp, n_con = packed[:, 5], packed[:, 6], packed[:, 7]
        # each of the 3 slice updates costs 2 initial evaluations, its
        # expansions and its contractions
        assert np.array_equal(nc, 2 * 3 + n_exp + n_con)
    assert timings["sync_slice"] > 0
    assert np.all(np.abs(u[:, 0] - 0.5) + np.abs(u[:, 1] - 0.5) < 0.5)
    a = (u[:, 0] - 0.5) + (u[:, 1] - 0.5)
    b = (u[:, 0] - 0.5) - (u[:, 1] - 0.5)
    for coord in (a, b):
        assert kstest(coord + 0.5, "uniform").pvalue > 1e-4
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.15


def test_unit_cube_round_uniformity_and_nc():
    # uniform inside the central cube of half-width 0.3
    def loglike(x):
        return -(x - 0.5).abs().max()

    like = LogLikelihood(loglike, lambda u: u, 3, device="cpu")
    like.eval_host(np.full((1, 3), 0.5))
    timings = Timings()
    fn = make_unif_round(like, ndim=3, q=Q, bound_kind="cube",
                         dtype=torch.float64, device="cpu",
                         timings=timings)
    packed = fn(torch_generator(7, "cpu"), -0.3).numpy()
    u, logl = packed[:, :3], packed[:, 6]
    nc, nc_total, n_prop, n_filled = (packed[:, 7], packed[0, 8],
                                      packed[0, 9], packed[0, 10])
    assert n_filled == Q and np.all(logl > -0.3)
    # per-slot nc is an exact split of the round's evaluations
    assert nc.sum() == nc_total and np.all(nc >= 1)
    # acceptance 0.6^3: evaluations ~ Q / 0.216, proposals >= evaluations
    assert n_prop >= nc_total > Q
    assert timings["sync_wave"] >= 2
    for k in range(3):
        assert kstest((u[:, k] - 0.2) / 0.6, "uniform").pvalue > 1e-4


def test_unported_kernels_raise():
    like = _diamond_like()
    with pytest.raises(NotImplementedError):
        make_slice_round(like, ndim=2, q=8, slices=2, kind="slice",
                         dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError):
        make_unif_round(like, ndim=2, q=8, bound_kind="ellipsoids",
                        dtype=torch.float64, device="cpu")
