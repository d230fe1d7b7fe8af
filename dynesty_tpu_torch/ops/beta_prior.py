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
some 1.4e5 elementwise operations a call.  On the card these are
``csrc/beta_prior.cu``'s two kernels, bit for bit with the plain versions.

``beta_ppf_kernel`` takes a table of up to :data:`TABLE` Beta dimensions
(a column of ``u`` and its ``a``, ``b`` each), so a ``PriorTransform``
runs every Beta dimension of a call in one launch
(:func:`beta_ppf_columns`; :func:`beta_ppf` is the one-column case).  Each
element gets a group of lanes that walks the bisection several levels a
round: the lanes evaluate ``betainc`` at every node of the round's tree at
once, each node's mid computed along its path as the serial loop computes
it, then replay the serial loop's comparisons from them, so the bits are
the serial loop's.  How many levels (:func:`beta_levels`) follows the
call's element count: five (a warp an element, ten rounds for 50 steps)
where a warp for every element fits in 16 warps an SM (what keeps the
card's pipes busy), fewer above, down to one thread an element; the
count never changes a bit.

Each is a ``torch.library.custom_op`` (``dynesty_tpu_torch::beta_ppf``,
``dynesty_tpu_torch::betainc``): its ``"cuda"`` kernel launches the
ctypes entry on the current stream into an output made by
``torch.empty`` (no host sync, no copy from the host: the table travels
in the kernel's parameters, so a captured wave records it), counts
``launches`` on :func:`beta_ppf` or :func:`betainc` and raises where the
launch fails or the dtype is not float32 or float64; its CPU
implementation runs the plain version on contiguous inputs (a column at a
time); a vmap rule calls the operator once on the batched tensor, so that
a prior under ``torch.func.vmap`` (every proposal wave evaluates
``ptform`` so, ``internal/likelihood.py``) launches one kernel for its
Beta dimensions.  A CUDA tensor never reaches the plain version: the
default implementation raises for any device but the CPU.
"""

import ctypes

import torch

from . import build

__all__ = ["beta_ppf", "beta_ppf_columns", "beta_ppf_plain", "betainc",
           "betainc_plain", "beta_levels", "ENTRY_ARGTYPES", "TABLE",
           "zero_counts", "WRAPPERS"]

# continued-fraction terms: enough for a, b up to a few thousand (held to
# scipy.special.betainc in tests/test_torch_models.py)
_BETAINC_ITERS = 64
# Lentz's guard against a zero denominator
_TINY = 1e-300
# Beta dimensions one beta_ppf launch takes (csrc/beta_prior.cu's TABLE)
TABLE = 32
# the most bisection levels a round: 31 nodes, a warp an element
MAX_LEVELS = 5


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
_P, _I, _N = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# each entry's arguments after its name's type tag, as csrc/beta_prior.cu
# declares them (the stream last)
ENTRY_ARGTYPES = {
    "beta_ppf": [_P, _I, _I, _P, _I, _I, _N, ctypes.POINTER(_I),
                 ctypes.POINTER(ctypes.c_double),
                 ctypes.POINTER(ctypes.c_double), _N, _N, _P],
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


def beta_levels(n, lanes):
    """The bisection levels a round of a ``beta_ppf`` launch of ``n``
    elements on a card that keeps ``lanes`` threads busy
    (:func:`_busy_lanes`): the most levels, up to :data:`MAX_LEVELS` (a
    warp an element), whose groups of 2^L lanes for every element fit,
    and one thread an element (1) where not even four lanes do.  It never
    changes a bit."""
    for levels in range(MAX_LEVELS, 1, -1):
        if n << levels <= lanes:
            return levels
    return 1


# threads an SM keeps busy with beta_ppf_kernel: 16 warps fill its pipes
# (PERF.md, chip_smoke.py's level sweep on an H100: past that a call is
# throughput-bound and another level costs more than it saves)
LANES_PER_SM = 512
_LANES = {}


def _busy_lanes(device):
    """The threads ``device`` keeps busy: its SMs times
    :data:`LANES_PER_SM`."""
    lanes = _LANES.get(device.index)
    if lanes is None:
        lanes = _LANES[device.index] = LANES_PER_SM * \
            torch.cuda.get_device_properties(device).multi_processor_count
    return lanes


def _check_table(u, cols, a, b):
    if not (len(cols) == len(a) == len(b)) or not cols:
        raise ValueError(f"beta_ppf: a table of columns, a and b of one "
                         f"length >= 1, got {len(cols)}, {len(a)}, "
                         f"{len(b)}")
    if u.dim() < 1 or any(not 0 <= c < u.shape[-1] for c in cols):
        raise ValueError(f"beta_ppf: columns {list(cols)} outside u's last "
                         f"axis (shape {tuple(u.shape)})")


def _beta_ppf_default(u: torch.Tensor, cols: list[int], a: list[float],
                      b: list[float], niter: int) -> torch.Tensor:
    _cpu_only("beta_ppf", u)
    _check_table(u, cols, a, b)
    return torch.stack([beta_ppf_plain(u[..., c].contiguous(), x, y, niter)
                        for c, x, y in zip(cols, a, b)], -1)


_beta_ppf_op = torch.library.custom_op("dynesty_tpu_torch::beta_ppf",
                                       _beta_ppf_default, mutates_args=())


@_beta_ppf_op.register_kernel("cuda")
def _beta_ppf_cuda(u, cols, a, b, niter):
    f = _entry("beta_ppf", u.dtype)
    _check_table(u, cols, a, b)
    k = len(cols)
    out = torch.empty(u.shape[:-1] + (k,), dtype=u.dtype, device=u.device)
    if not out.numel():
        return out
    # rows by the row stride where u's leading axes flatten to one (a
    # view), else a contiguous copy on the card
    src = u.reshape(-1, u.shape[-1])
    rows = src.shape[0]
    lanes = _busy_lanes(u.device)
    for j0 in range(0, k, TABLE):
        j1 = min(j0 + TABLE, k)
        kc = j1 - j0
        table = ((ctypes.c_longlong * kc)(*cols[j0:j1]),
                 (ctypes.c_double * kc)(*a[j0:j1]),
                 (ctypes.c_double * kc)(*b[j0:j1]))
        _launch(f, (src.data_ptr(), src.stride(0), src.stride(1),
                    out.data_ptr() + j0 * out.element_size(), k, rows, kc,
                    *table, niter, beta_levels(rows * kc, lanes)),
                u.device, "beta_ppf")
        beta_ppf.launches += 1
    return out


@_beta_ppf_op.register_fake
def _beta_ppf_fake(u, cols, a, b, niter):
    return torch.empty(u.shape[:-1] + (len(cols),), dtype=u.dtype,
                       device=u.device)


def _beta_ppf_vmap(info, in_dims, u, cols, a, b, niter):
    # the columns are u's last axis: the batch dimension first, one call on
    # the lot
    return _beta_ppf_op(u.movedim(in_dims[0], 0), cols, a, b, niter), 0


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
    return beta_ppf_columns(u.unsqueeze(-1), [0], [alpha], [beta],
                            niter).squeeze(-1)


def beta_ppf_columns(u, cols, alpha, beta, niter=50):
    """The quantiles of several Beta priors in one call: column ``j`` of
    the result (its last axis) is Beta(``alpha[j]``, ``beta[j]``) at
    ``u[..., cols[j]]`` by ``niter`` bisection steps, bit for bit as
    :func:`beta_ppf` gives it.  On the card one launch of
    ``beta_ppf_kernel`` for every :data:`TABLE` columns, reading ``u`` by
    its strides; on the CPU :func:`beta_ppf_plain` a column at a time.
    Runs under ``torch.func.vmap``."""
    return _beta_ppf_op(u, [int(c) for c in cols],
                        [float(x) for x in alpha],
                        [float(x) for x in beta], int(niter))


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
