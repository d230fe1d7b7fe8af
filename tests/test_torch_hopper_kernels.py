"""The port's leave-one-out NN-distance kernel against the JAX package's
Pallas kernel (run in interpret mode) and its jnp reference.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is checked against that plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py."""

import math

import jax
import numpy as np
import pytest
import torch

from dynesty_tpu.ops.pallas_kernels import (pairwise_min_dist as
                                            jax_pairwise_min_dist,
                                            pairwise_min_dist_reference)
from dynesty_tpu_torch.ops import hopper_kernels as hk

from utils import get_rstate

torch.set_num_threads(1)


def _points(n, d, seed=None):
    return get_rstate(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("d", [3, 8])
@pytest.mark.parametrize("n", [300, 1000, 2048])
def test_l2_matches_pallas_interpret(n, d):
    pts = _points(n, d)
    got = hk.pairwise_min_dist(torch.from_numpy(pts)).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    # the Pallas kernel forms |a|^2+|b|^2-2a.b in float32: its error sits
    # in the SQUARED distance (~eps32 * |a|^2, 1e-5 bounds it on
    # unit-normal data, as tests/test_math.py does for the distance at
    # 300 x 8); the square root magnifies it ~1/(2 d) at the closest
    # pairs of 2048 points, so distances are held to 1e-5 above d = 0.1
    pallas = np.asarray(jax_pairwise_min_dist(pts, p=2, interpret=True))
    assert np.abs(got ** 2 - pallas ** 2).max() < 1e-5
    far = got > 0.1
    assert np.abs(got - pallas)[far].max() < 1e-5
    # both sides take exact differences in float32: only the summation
    # order differs
    ref = np.asarray(pairwise_min_dist_reference(pts, p=2))
    assert np.abs(got - ref).max() < 1e-6


def test_l2_wide_matches_pallas_interpret():
    # any d: the plain version (what a CPU tensor runs) at d = 100, where
    # nearest-neighbour distances are ~10, not ~1 as at d = 3 or 8
    n, d = 2048, 100
    pts = _points(n, d)
    got = hk.pairwise_min_dist(torch.from_numpy(pts)).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    pallas = np.asarray(jax_pairwise_min_dist(pts, p=2, interpret=True))
    # the 1e-5 on distances above 0.1 holds as it stands; the Pallas form's
    # error in a SQUARED distance scales with |a|^2, i.e. with d, so the
    # 1e-5 that bounds it at d <= 8 becomes 1e-5 * d / 8
    assert np.abs(got - pallas).max() < 1e-5
    assert np.abs(got ** 2 - pallas ** 2).max() < 1e-5 * d / 8
    # exact differences on both sides, summed in another order: 1e-6 of
    # the distance (jit fuses the reference's (N, N, d) differences)
    ref = np.asarray(jax.jit(pairwise_min_dist_reference)(pts))
    assert np.all(np.abs(got - ref) < 1e-6 * ref)


@pytest.mark.parametrize("n", [300, 1000, 2048])
def test_linf_matches_reference(n):
    pts = _points(n, 3)
    got = hk.pairwise_min_dist(torch.from_numpy(pts), p=math.inf).numpy()
    ref = np.asarray(pairwise_min_dist_reference(pts, p=np.inf))
    assert np.abs(got - ref).max() < 1e-6


def test_plain_blocks_rows():
    # a block budget smaller than one row forces one row per block
    pts = torch.from_numpy(_points(257, 5))
    full = hk.pairwise_min_dist_plain(pts)
    old = hk._PLAIN_BLOCK_ELEMS
    try:
        hk._PLAIN_BLOCK_ELEMS = 100
        blocked = hk.pairwise_min_dist_plain(pts)
    finally:
        hk._PLAIN_BLOCK_ELEMS = old
    assert torch.equal(full, blocked)


def test_wrapper_counts_and_checks():
    pts = torch.from_numpy(_points(50, 3))
    calls, launches = hk.pairwise_min_dist.calls, \
        hk.pairwise_min_dist.launches
    hk.pairwise_min_dist(pts)
    hk.pairwise_min_dist(pts, p=math.inf)
    assert hk.pairwise_min_dist.calls == calls + 2
    # CPU tensors never count as kernel launches
    assert hk.pairwise_min_dist.launches == launches
    with pytest.raises(TypeError):
        hk.pairwise_min_dist(pts.double())
    with pytest.raises(ValueError):
        hk.pairwise_min_dist(pts[:1])
    with pytest.raises(ValueError):
        hk.pairwise_min_dist(pts.t())
    with pytest.raises(ValueError):
        hk.pairwise_min_dist(pts, p=1)


def test_wrapper_checks_paths():
    pts = torch.from_numpy(_points(50, 3))
    for kw in ({"path": "mma"}, {"path": "tc", "p": math.inf}):
        with pytest.raises(ValueError, match="no path"):
            hk.pairwise_min_dist(pts, **kw)
    wide = torch.zeros((50, hk.TC_MAX_D + 1))
    with pytest.raises(ValueError, match="no path"):
        hk.pairwise_min_dist(wide, path="tc")
    with pytest.raises(ValueError, match="d >= 1"):
        hk.pairwise_min_dist(torch.zeros((50, 0)))
    # a forced path is legal on the CPU, where the plain version runs
    assert torch.equal(hk.pairwise_min_dist(pts, path="exact"),
                       hk.pairwise_min_dist_plain(pts))


# both sides of each limit of the switch: N, d, N * d, the widest d
@pytest.mark.parametrize("n, d, p, path", [
    (2048, 3, 2, "exact"),
    (2047, 64, 2, "exact"), (2048, 64, 2, "tc"),
    (16384, 11, 2, "exact"), (16384, 12, 2, "tc"),
    (2048, 47, 2, "exact"), (2048, 48, 2, "tc"),
    (16384, hk.TC_MAX_D, 2, "tc"), (16384, hk.TC_MAX_D + 1, 2, "exact"),
    (16384, 64, math.inf, "exact"),
])
def test_kernel_path_switch(n, d, p, path):
    assert hk.kernel_path(n, d, p) == path
