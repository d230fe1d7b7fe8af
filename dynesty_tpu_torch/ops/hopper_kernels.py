"""Hand-written Hopper kernels and their plain PyTorch versions.

``pairwise_min_dist`` replaces the JAX package's only Pallas kernel,
``dynesty_tpu/ops/pallas_kernels.py:_min_dist_kernel_l2``, and its jnp
reference for p=inf: the leave-one-out nearest-neighbour distance of each
live point, which sets the radius of the friends bounds.  On a CUDA tensor
it launches one of two CUDA C++ kernels in ``csrc/pairwise_min_dist.cu``
(built lazily by :mod:`.build`; the design notes are in that source):
exact differences on the CUDA cores (p=2 and p=inf), or 3xTF32 wgmma
products on the expansion form (p=2, from :data:`TC_SWITCH` up to
:data:`TC_MAX_D`).  On a CPU tensor it runs :func:`pairwise_min_dist_plain`.
"""

import ctypes
import math

import torch

from . import build

__all__ = ["pairwise_min_dist", "pairwise_min_dist_plain", "kernel_path",
           "TC_SWITCH", "TC_MAX_D"]

# p=2 takes the tensor-core path from (min N, min d, min N * d): below it
# the exact path is as fast or faster (PERF.md); at small N the tensor-core
# grid is too small, at small d its padding to 32 wastes the products
TC_SWITCH = (2048, 12, 98304)
# widest d the tensor-core path takes (its split row tile fills shared memory)
TC_MAX_D = 128
PATHS = ("exact", "tc")
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


def kernel_path(n, d, p=2):
    """The CUDA path that ``pairwise_min_dist`` takes for (N, d) and p."""
    min_n, min_d, min_nd = TC_SWITCH
    if p == 2 and n >= min_n and min_d <= d <= TC_MAX_D and n * d >= min_nd:
        return "tc"
    return "exact"


_ENTRY = {}
_ARGTYPES = {
    "exact": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "tc": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def _entry(path):
    fn = _ENTRY.get(path)
    if fn is None:
        lib = build.load_library("pairwise_min_dist")
        fn = getattr(lib, f"dynesty_pairwise_min_dist_{path}")
        fn.argtypes = _ARGTYPES[path]
        fn.restype = ctypes.c_int
        _ENTRY[path] = fn
    return fn


def _launch(points, p, path):
    n, d = points.shape
    fn = _entry(path)
    dev = points.device
    # the kernels combine column splits with atomicMin: start from +inf
    out = torch.full((n,), math.inf, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if path == "tc":
            dpad = -(-d // 32) * 32
            mean = points.mean(dim=0)
            hi = torch.empty((n, dpad), dtype=torch.float32, device=dev)
            lo = torch.empty((n, dpad), dtype=torch.float32, device=dev)
            norms = torch.empty(n, dtype=torch.float32, device=dev)
            err = fn(points.data_ptr(), mean.data_ptr(), hi.data_ptr(),
                     lo.data_ptr(), norms.data_ptr(), out.data_ptr(), n, d,
                     dpad, stream)
        else:
            err = fn(points.data_ptr(), out.data_ptr(), n, d, int(p != 2),
                     stream)
    if err != 0:
        raise RuntimeError(f"pairwise_min_dist {path} kernel launch failed "
                           f"(cudaError {err}) for shape ({n}, {d})")
    pairwise_min_dist.launches += 1
    if path == "tc":
        pairwise_min_dist.launches_tc += 1
    else:
        pairwise_min_dist.launches_exact += 1
    return out


def pairwise_min_dist(points, p=2, path=None):
    """Leave-one-out nearest-neighbour distances of ``points``.

    ``points``: contiguous float32 (N, d) tensor, N >= 2, any d >= 1.  A
    CUDA tensor launches a kernel, or raises: ``path`` ('exact', or 'tc'
    for p=2 and d <= :data:`TC_MAX_D`) overrides :func:`kernel_path`.  A
    CPU tensor takes :func:`pairwise_min_dist_plain`.  ``calls`` counts
    every call, ``launches`` every kernel launch, ``launches_exact`` and
    ``launches_tc`` those of each path."""
    if not isinstance(points, torch.Tensor):
        raise TypeError("pairwise_min_dist takes a torch.Tensor")
    if points.dtype != torch.float32:
        raise TypeError(f"pairwise_min_dist takes float32, got "
                        f"{points.dtype}")
    if points.dim() != 2 or points.shape[0] < 2 or points.shape[1] < 1:
        raise ValueError(f"pairwise_min_dist takes (N >= 2, d >= 1) points,"
                         f" got shape {tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("pairwise_min_dist takes a contiguous tensor")
    if p not in (2, math.inf):
        raise ValueError(f"p must be 2 or inf, got {p}")
    if path is not None and (path not in PATHS or path != "exact" and (
            p != 2 or points.shape[1] > TC_MAX_D)):
        raise ValueError(f"no path {path!r} for p={p}, d={points.shape[1]}")
    pairwise_min_dist.calls += 1
    if points.device.type == "cpu":
        return pairwise_min_dist_plain(points, p=p)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    return _launch(points, p, path or kernel_path(*points.shape, p))


pairwise_min_dist.calls = 0
pairwise_min_dist.launches = 0
pairwise_min_dist.launches_exact = 0
pairwise_min_dist.launches_tc = 0
