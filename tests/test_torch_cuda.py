"""Tests of the port that need an NVIDIA GPU; each skips itself without
one.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dynesty_tpu_torch.ops import build
from dynesty_tpu_torch.ops import hopper_kernels as hk

from utils import get_rstate


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_call_without_build_raises(cuda, monkeypatch):
    monkeypatch.setenv("DYNESTY_TPU_TORCH_NO_BUILD", "1")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(hk, "_ENTRY", {})
    launches = hk.pairwise_min_dist.launches
    pts = torch.randn(64, 3, device=cuda)
    with pytest.raises(RuntimeError, match="disabled"):
        hk.pairwise_min_dist(pts)
    assert hk.pairwise_min_dist.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 3), (1000, 8), (129, 64), (2, 1)])
def test_cuda_kernel_matches_plain(cuda, shape):
    pts = torch.from_numpy(
        get_rstate().normal(size=shape).astype(np.float32)).to(cuda)
    launches = hk.pairwise_min_dist.launches
    got = hk.pairwise_min_dist(pts)
    torch.cuda.synchronize()
    assert hk.pairwise_min_dist.launches == launches + 1
    ref = hk.pairwise_min_dist_plain(pts)
    # both take exact float32 differences; summation order differs
    assert torch.allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_kernel_rejects_wide_points(cuda):
    with pytest.raises(ValueError, match="d <= 64"):
        hk.pairwise_min_dist(torch.zeros((10, 65), device=cuda))


@pytest.mark.cuda
def test_cuda_run_reproducible(cuda):
    import dynesty_tpu_torch as dyt

    cinv = torch.linalg.inv(torch.full((3, 3), 0.95, dtype=torch.float64,
                                       device=cuda) +
                            0.05 * torch.eye(3, dtype=torch.float64,
                                             device=cuda))
    runs = []
    for _ in range(2):
        s = dyt.NestedSampler(lambda x: -0.5 * (x @ cinv @ x),
                              lambda u: 10.0 * (2.0 * u - 1.0), 3,
                              nlive=256, bound="single", sample="rslice",
                              device=cuda, rstate=get_rstate(56432))
        s.run_nested(print_progress=False)
        runs.append(s.results)
    for key in ("logl", "logz", "ncall", "samples", "samples_n"):
        assert np.array_equal(runs[0][key], runs[1][key]), key
