"""The port's leave-one-out NN-distance kernel against the JAX package's
Pallas kernel (run in interpret mode) and its jnp reference.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is checked against that plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py."""

import math

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
