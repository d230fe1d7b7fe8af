"""Hand-written Hopper kernels and their plain PyTorch versions.

``pairwise_min_dist`` replaces the JAX package's only Pallas kernel,
``dynesty_tpu/ops/pallas_kernels.py:_min_dist_kernel_l2``: the
leave-one-out nearest-neighbour distance of each live point, which sets
the radius of the friends bounds.  On a CUDA tensor (p=2) it launches the
CUDA C++ kernel in ``csrc/pairwise_min_dist.cu`` (built lazily by
:mod:`.build`); the design notes are in that source.  On a CPU tensor it
runs :func:`pairwise_min_dist_plain`.  p=inf (cubes) takes the plain
version on either device, as the JAX package does.
"""

import ctypes
import math

import torch

from . import build

__all__ = ["pairwise_min_dist", "pairwise_min_dist_plain"]

_MAX_D = 64
# rows of the (rows, N) distance block the plain version forms at once
_PLAIN_BLOCK_ELEMS = 1 << 25


def pairwise_min_dist_plain(points, p=2):
    """Leave-one-out nearest-neighbour distances of ``points`` (N, d) by
    exact differences (p=2 or inf), chunked over rows so (16384, 64) fits
    in memory.  Returns (N,) in the input's dtype."""
    n = points.shape[0]
    p = float(p)
    chunk = max(1, _PLAIN_BLOCK_ELEMS // max(n, 1))
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    for i0 in range(0, n, chunk):
        blk = points[i0:i0 + chunk]
        dist = torch.cdist(blk[None], points[None], p=p,
                           compute_mode="donot_use_mm_for_euclid_dist")[0]
        rows = torch.arange(blk.shape[0], device=points.device)
        dist[rows, rows + i0] = math.inf
        out[i0:i0 + chunk] = dist.min(dim=1).values
    return out


_ENTRY = {}


def _entry_l2():
    fn = _ENTRY.get("l2")
    if fn is None:
        lib = build.load_library("pairwise_min_dist")
        fn = lib.dynesty_pairwise_min_dist_l2
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY["l2"] = fn
    return fn


def _launch_l2(points):
    n, d = points.shape
    fn = _entry_l2()
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), out.data_ptr(), n, d, stream)
    if err != 0:
        raise RuntimeError(f"pairwise_min_dist kernel launch failed "
                           f"(cudaError {err}) for shape ({n}, {d})")
    pairwise_min_dist.launches += 1
    return out


def pairwise_min_dist(points, p=2):
    """Leave-one-out nearest-neighbour distances of ``points``.

    ``points``: contiguous float32 (N, d) tensor, N >= 2.  CUDA tensors
    with p=2 (d <= 64) go through the CUDA kernel, or raise; CPU tensors
    and p=inf use :func:`pairwise_min_dist_plain`.  ``calls`` counts every
    call, ``launches`` only the CUDA kernel's launches."""
    if not isinstance(points, torch.Tensor):
        raise TypeError("pairwise_min_dist takes a torch.Tensor")
    if points.dtype != torch.float32:
        raise TypeError(f"pairwise_min_dist takes float32, got "
                        f"{points.dtype}")
    if points.dim() != 2 or points.shape[0] < 2:
        raise ValueError(f"pairwise_min_dist takes (N >= 2, d) points, got "
                         f"shape {tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("pairwise_min_dist takes a contiguous tensor")
    if p not in (2, math.inf):
        raise ValueError(f"p must be 2 or inf, got {p}")
    pairwise_min_dist.calls += 1
    if points.device.type == "cpu" or p != 2:
        return pairwise_min_dist_plain(points, p=p)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    if points.shape[1] > _MAX_D:
        raise ValueError(f"the CUDA kernel takes d <= {_MAX_D}, got "
                         f"{points.shape[1]}")
    return _launch_l2(points)


pairwise_min_dist.calls = 0
pairwise_min_dist.launches = 0
