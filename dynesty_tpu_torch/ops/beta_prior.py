"""The Beta prior's quantile and the regularized incomplete beta function:
a hand-written CUDA kernel each, as PyTorch operators that run under
``torch.func.vmap`` and inside a captured CUDA graph, and their plain
PyTorch versions.

The JAX package's ``Beta`` prior (``dynesty_tpu/models/priors.py:83``)
inverts ``jax.scipy.special.betainc`` by 50 bisection steps, which XLA
compiles into one device program.  ``torch.special`` has no ``betainc``,
so the port computes it (:func:`betainc_plain`: the continued fraction of
Numerical Recipes' ``betacf``, modified Lentz, a fixed 64 terms, no
data-dependent control flow) and bisects on it (:func:`beta_ppf_plain`):
some 1.6e5 elementwise operations a call.  On the card these are
``csrc/beta_prior.cu``'s two kernels, one thread an element, bit for bit
with the plain versions.

Each is a ``torch.library.custom_op`` (``dynesty_tpu_torch::beta_ppf``,
``dynesty_tpu_torch::betainc``): its ``"cuda"`` kernel launches the
ctypes entry on the current stream into an output made by
``torch.empty`` (no host sync, no copy from the host: a captured wave
records it), counts ``launches`` on the public wrapper and raises where
the launch fails or the dtype is not float32 or float64; its CPU
implementation runs the plain version on contiguous inputs; a vmap rule
calls the operator once on the batched tensor, so that a prior under
``torch.func.vmap`` (every proposal wave evaluates ``ptform`` so,
``internal/likelihood.py``) launches one kernel a Beta dimension.  A CUDA
tensor never reaches the plain version: the default implementation
raises for any device but the CPU.
"""

import ctypes

import torch

from . import build

__all__ = ["beta_ppf", "beta_ppf_plain", "betainc", "betainc_plain",
           "ENTRY_ARGTYPES", "zero_counts", "WRAPPERS"]

# continued-fraction terms: enough for a, b up to a few thousand (held to
# scipy.special.betainc in tests/test_torch_models.py)
_BETAINC_ITERS = 64
# Lentz's guard against a zero denominator
_TINY = 1e-300


# --------------------------------------------------------------------------
# the plain versions


def _guard(t):
    return torch.where(t.abs() < _TINY, _TINY, t)


def betainc_plain(a, b, x):
    """Regularized incomplete beta function I_x(a, b), elementwise over
    ``x`` (a tensor; ``a``, ``b`` numbers or tensors broadcasting with
    it), in ``x``'s floating dtype.

    The prefactor x^a (1-x)^b / (a B(a, b)) comes from ``lgamma``; the
    continued fraction converges fast for x < (a+1)/(a+b+2), and above
    that the symmetry I_x(a, b) = 1 - I_{1-x}(b, a) is used."""
    x = torch.as_tensor(x)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    swap = x > (a + 1.0) / (a + b + 2.0)
    p = torch.where(swap, b, a)
    q = torch.where(swap, a, b)
    y = torch.where(swap, 1.0 - x, x)
    log_front = (torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b) +
                 a * torch.log(x) + b * torch.log1p(-x))
    qab, qap, qam = p + q, p + 1.0, p - 1.0
    c = torch.ones_like(y)
    d = 1.0 / _guard(1.0 - qab * y / qap)
    h = d
    for m in range(1, _BETAINC_ITERS + 1):
        m2 = 2 * m
        for aa in (m * (q - m) * y / ((qam + m2) * (p + m2)),
                   -(p + m) * (qab + m) * y / ((p + m2) * (qap + m2))):
            d = 1.0 / _guard(1.0 + aa * d)
            c = _guard(1.0 + aa / c)
            h = h * d * c
    front = torch.exp(log_front) * h / p
    return torch.where(swap, 1.0 - front, front)


def beta_ppf_plain(u, alpha, beta, niter=50):
    """The quantile of Beta(alpha, beta) at ``u`` by ``niter`` bisection
    steps of :func:`betainc_plain` (a fixed iteration count, as the JAX
    package's)."""
    lo = torch.zeros_like(u)
    hi = torch.ones_like(u)
    for _ in range(niter):
        mid = 0.5 * (lo + hi)
        below = betainc_plain(alpha, beta, mid) < u
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


# --------------------------------------------------------------------------
# the kernels

_DTYPES = {torch.float64: "f64", torch.float32: "f32"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
# each entry's arguments after its name's type tag, as csrc/beta_prior.cu
# declares them (the stream last)
ENTRY_ARGTYPES = {
    "beta_ppf": [_P, _I, _P, _I, _D, _D, ctypes.c_int, _P],
    "betainc": [_P, _I, _P, _I, _P, _I, _P, _I, _P],
}
_ENTRY = {}


def _entry(fn, dtype):
    """The ctypes entry ``dynesty_<fn>_<f64|f32>`` (built at first use);
    raises for another dtype."""
    tag = _DTYPES.get(dtype)
    if tag is None:
        raise TypeError(f"{fn} on the card takes float64 or float32, got "
                        f"{dtype}")
    f = _ENTRY.get((fn, tag))
    if f is None:
        f = getattr(build.load_library("beta_prior"), f"dynesty_{fn}_{tag}")
        f.argtypes = ENTRY_ARGTYPES[fn]
        f.restype = ctypes.c_int
        _ENTRY[(fn, tag)] = f
    return f


def _launch(f, args, device, fn):
    """Run entry ``f`` with ``args`` on ``device``'s current stream; raises
    on a refused launch."""
    if torch.cuda.current_device() != device.index:
        with torch.cuda.device(device):
            return _launch(f, args, device, fn)
    err = f(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed (cudaError {err})")


def _operand(t, shape):
    """``t`` as the kernels read it over the broadcast ``shape``: the
    tensor and its element stride (0 for one element, a 1-D view's own
    stride), else a contiguous copy of it expanded to ``shape``."""
    if t.numel() == 1:
        return t, 0
    if tuple(t.shape) == tuple(shape):
        if t.is_contiguous():
            return t, 1
        if t.dim() == 1:
            return t, t.stride(0)
    return t.expand(shape).contiguous(), 1


def _cpu_only(fn, *tensors):
    for t in tensors:
        if t.device.type != "cpu":
            raise RuntimeError(f"{fn}: no kernel for a tensor on "
                               f"{t.device} (only the CPU runs the plain "
                               f"version)")


def _beta_ppf_default(u: torch.Tensor, a: float, b: float,
                      niter: int) -> torch.Tensor:
    _cpu_only("beta_ppf", u)
    return beta_ppf_plain(u.contiguous(), a, b, niter)


_beta_ppf_op = torch.library.custom_op("dynesty_tpu_torch::beta_ppf",
                                       _beta_ppf_default, mutates_args=())


@_beta_ppf_op.register_kernel("cuda")
def _beta_ppf_cuda(u, a, b, niter):
    f = _entry("beta_ppf", u.dtype)
    src, su = _operand(u, u.shape)
    out = torch.empty(u.shape, dtype=u.dtype, device=u.device)
    if out.numel():
        _launch(f, (src.data_ptr(), su, out.data_ptr(), out.numel(), a, b,
                    niter), u.device, "beta_ppf")
        beta_ppf.launches += 1
    return out


@_beta_ppf_op.register_fake
def _beta_ppf_fake(u, a, b, niter):
    return torch.empty(u.shape, dtype=u.dtype, device=u.device)


def _beta_ppf_vmap(info, in_dims, u, a, b, niter):
    # elementwise in its one tensor: the batched tensor goes through whole
    return _beta_ppf_op(u, a, b, niter), in_dims[0]


_beta_ppf_op.register_vmap(_beta_ppf_vmap)


def _betainc_default(a: torch.Tensor, b: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    _cpu_only("betainc", a, b, x)
    return betainc_plain(a.contiguous(), b.contiguous(), x.contiguous())


_betainc_op = torch.library.custom_op("dynesty_tpu_torch::betainc",
                                      _betainc_default, mutates_args=())


@_betainc_op.register_kernel("cuda")
def _betainc_cuda(a, b, x):
    f = _entry("betainc", x.dtype)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"betainc: {name} must be {x.dtype} on "
                            f"{x.device}, got {t.dtype} on {t.device}")
    shape = torch.broadcast_shapes(a.shape, b.shape, x.shape)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel():
        (xs, sx), (as_, sa), (bs, sb) = (_operand(t, shape)
                                         for t in (x, a, b))
        _launch(f, (xs.data_ptr(), sx, as_.data_ptr(), sa, bs.data_ptr(),
                    sb, out.data_ptr(), out.numel()), x.device, "betainc")
        betainc.launches += 1
    return out


@_betainc_op.register_fake
def _betainc_fake(a, b, x):
    shape = torch.broadcast_shapes(a.shape, b.shape, x.shape)
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def _betainc_vmap(info, in_dims, a, b, x):
    # each batched input's batch dimension first, its logical dimensions
    # right-aligned with the others' (broadcasting); one call on the lot
    ts = (a, b, x)
    rank = max(t.dim() - (d is not None) for t, d in zip(ts, in_dims))
    moved = []
    for t, d in zip(ts, in_dims):
        if d is not None:
            t = t.movedim(d, 0)
            t = t.reshape(t.shape[:1] + (1,) * (rank + 1 - t.dim()) +
                          t.shape[1:])
        moved.append(t)
    return _betainc_op(*moved), 0


_betainc_op.register_vmap(_betainc_vmap)


# --------------------------------------------------------------------------
# the wrappers


def beta_ppf(u, alpha, beta, niter=50):
    """The quantile of Beta(``alpha``, ``beta``) (numbers) at ``u`` (a
    float tensor) by ``niter`` bisection steps: on the card one launch of
    ``csrc/beta_prior.cu``'s ``beta_ppf_kernel``, on the CPU
    :func:`beta_ppf_plain`.  Runs under ``torch.func.vmap``."""
    return _beta_ppf_op(u, float(alpha), float(beta), int(niter))


def betainc(a, b, x):
    """I_x(a, b) elementwise in ``x``'s dtype (``a``, ``b`` numbers or
    tensors broadcasting with ``x``): on the card one launch of
    ``csrc/beta_prior.cu``'s ``betainc_kernel``, on the CPU
    :func:`betainc_plain`.  Runs under ``torch.func.vmap``."""
    x = torch.as_tensor(x)

    def param(v):
        # a number becomes a 0-d tensor by a fill on x's device, no copy
        # from the host
        if isinstance(v, torch.Tensor):
            return v.to(device=x.device, dtype=x.dtype)
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return _betainc_op(param(a), param(b), x)


WRAPPERS = (beta_ppf, betainc)


def zero_counts():
    """Zero each wrapper's ``launches``."""
    for w in WRAPPERS:
        w.launches = 0


zero_counts()
