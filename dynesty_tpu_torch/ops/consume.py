"""The consume scan of one fused round: a hand-written CUDA kernel and its
plain PyTorch version.

A fused round proposes ``q`` points, then consumes them in order against
the live set: worst-point selection, plateau entry and exit, the
streaming trapezoid evidence update, the counters and the stopping
checks.  The JAX package runs that as a ``lax.scan`` inside its jitted
round (``dynesty_tpu/internal/fused.py:212`` general body, ``:333`` thin
body, ``:423`` the ``lax.cond`` between them).

:func:`consume_round` on a CUDA tensor launches
``csrc/consume_scan.cu`` (built lazily by :mod:`.build`; the design notes
are in that source): one block consumes the whole round and picks the
thin or the general path on the device.  On a CPU tensor it runs
:func:`consume_round_plain`, the eager loop over 0-d tensors that the
kernel is held against bit for bit.

The integrator and counter state is a dict of 0-d tensors with the keys
:data:`STATE_KEYS`; both versions return a new dict and never write the
caller's tensors.  The per-step columns come back in the order (worsts,
srcs, accepts, logl, logvol, logwt, logz, logzvar, h, nc, delta_logz,
n): int64, int64, bool, then the state's type but nc (int64).
"""

import ctypes

import torch

from . import build
from .integrals import progress_integration_torch

__all__ = ["consume_round", "consume_round_plain", "integrator_step",
           "path_counts", "zero_counts", "STATE_KEYS"]

# the carried state: float (the sampler's dtype), then integer (int64) and
# boolean entries, in the order the kernel packs them
FLOAT_KEYS = ("logz", "logzvar", "h", "logvol", "loglstar",
              "plateau_logdvol")
INT_KEYS = ("plateau_mode", "plateau_counter", "n_acc", "n_cons", "nc_used",
            "nc_accum", "done", "reason", "racc")
BOOL_KEYS = ("plateau_mode", "done")
STATE_KEYS = FLOAT_KEYS + INT_KEYS
PATHS = ("thin", "general")
_DTYPES = {torch.float64: "f64", torch.float32: "f32"}
# threads of the one block (a multiple of 32, at most 1024)
BLOCK = 512


def _causes(delta_logz, loglstar, plateau, n_acc, nc_used, limits):
    return torch.stack([
        delta_logz < limits["dlogz"],
        loglstar > limits["logl_max"],
        plateau,
        n_acc >= limits["max_accepts"],
        nc_used >= limits["max_nc"],
    ])


def _stop(causes, done, reason, pow2):
    stop = causes.any()
    reason = torch.where(stop & ~done, (causes.to(torch.int64) * pow2).sum(),
                         reason)
    return done | stop, reason


def _kill(st, loglstar_new, npl, n_now, dlv_now, accept, consumed, e_nc):
    """One death at ``loglstar_new`` (``npl`` live points tied at it):
    plateau entry and exit, the shrinkage, the evidence update and the
    counters, applied where ``accept``.  Returns the step's (logvol,
    logwt, logz, logzvar, h, nc) record values."""
    p_mode, pc = st["plateau_mode"], st["plateau_counter"]
    enter = ~p_mode & (npl > 1) & ~st["done"]
    pc = torch.where(enter, npl, pc)
    st["plateau_logdvol"] = torch.where(
        enter, -torch.log(n_now + 1.0) + st["logvol"],
        st["plateau_logdvol"])
    p_mode = p_mode | enter
    cur_dlv = torch.where(
        p_mode, -torch.log1p(-torch.exp(st["plateau_logdvol"] -
                                        st["logvol"])), dlv_now)
    nc_entry = torch.where(consumed, e_nc, 0)
    nc_this = st["nc_accum"] + nc_entry
    logvol_new = st["logvol"] - cur_dlv
    logwt, logz_new, logzvar_new, h_new = progress_integration_torch(
        st["loglstar"], loglstar_new, st["logz"], st["logzvar"],
        logvol_new, cur_dlv, st["h"])
    for k, new in (("logz", logz_new), ("logzvar", logzvar_new),
                   ("h", h_new), ("logvol", logvol_new),
                   ("loglstar", loglstar_new)):
        st[k] = torch.where(accept, new, st[k])
    st["n_acc"] = st["n_acc"] + accept
    st["n_cons"] = st["n_cons"] + consumed
    st["nc_used"] = st["nc_used"] + nc_entry
    st["nc_accum"] = torch.where(accept, 0, nc_this)
    pc = torch.where(accept & p_mode, pc - 1, pc)
    st["plateau_counter"] = pc
    st["plateau_mode"] = p_mode & ~(p_mode & (pc == 0))
    st["racc"] = st["racc"] + accept
    return logvol_new, logwt, logz_new, logzvar_new, h_new, nc_this


def _run_general(st, live_logl0, qlogl, qnc, limits, batch, dlv_default):
    nlive, q = live_logl0.shape[0], qlogl.shape[0]
    dtype, device = live_logl0.dtype, live_logl0.device
    pow2 = torch.tensor([1, 2, 4, 8, 16], dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    nlive_f = torch.tensor(float(nlive), dtype=dtype, device=device)
    dlv_q = torch.tensor(dlv_default, dtype=dtype, device=device)
    live_logl = live_logl0.clone()
    occupant = torch.full((nlive,), -1, dtype=torch.int64, device=device)
    outs = []
    for i in range(q):
        e_logl, e_nc = qlogl[i], qnc[i]
        n_now = (nlive - st["racc"]).to(dtype) if batch else nlive_f
        lmax = live_logl.max()
        delta_logz = torch.logaddexp(zero, lmax + st["logvol"] - st["logz"])
        causes = _causes(delta_logz, st["loglstar"],
                         (lmax - live_logl.min()) == 0, st["n_acc"],
                         st["nc_used"], limits)
        st["done"], st["reason"] = _stop(causes, st["done"], st["reason"],
                                         pow2)
        worst = torch.argmin(live_logl)
        # a 0-d index tensor indexes like an int (a view): copy before the
        # in-place writes below
        loglstar_new = live_logl[worst].clone()
        nplateau = (live_logl == loglstar_new).sum()
        dlv_now = torch.log1p(1.0 / n_now) if batch else dlv_q
        accept = ~st["done"] & (e_logl > loglstar_new)
        vals = _kill(st, loglstar_new, nplateau, n_now, dlv_now, accept,
                     ~st["done"], e_nc)
        src = occupant[worst].clone()
        live_logl[worst] = torch.where(accept, e_logl, loglstar_new)
        occupant[worst] = torch.where(accept, i, src)
        outs.append((worst, src, accept, loglstar_new) + vals +
                    (delta_logz, n_now))
    return [torch.stack(c) for c in zip(*outs)]


def _run_thin(st, sort_idx, sorted_logl, qlogl, qnc, limits):
    # deaths are exactly the q sorted-worst originals, in order, and every
    # proposal is accepted while the run is not done
    nlive, q = sorted_logl.shape[0], qlogl.shape[0]
    dtype, device = sorted_logl.dtype, sorted_logl.device
    pow2 = torch.tensor([1, 2, 4, 8, 16], dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    victims = sort_idx[:q]
    vict_logl = sorted_logl[:q]
    npl_pre = thin_ties(sorted_logl, q)
    rmax = sorted_logl[-1]
    outs = []
    for i in range(q):
        e_logl, e_nc = qlogl[i], qnc[i]
        v_logl = vict_logl[i]
        n_now = (nlive - st["racc"]).to(dtype)
        delta_logz = torch.logaddexp(zero, rmax + st["logvol"] - st["logz"])
        causes = _causes(delta_logz, st["loglstar"], rmax == v_logl,
                         st["n_acc"], st["nc_used"], limits)
        st["done"], st["reason"] = _stop(causes, st["done"], st["reason"],
                                         pow2)
        accept = ~st["done"]
        vals = _kill(st, v_logl, npl_pre[i], n_now,
                     torch.log1p(1.0 / n_now), accept, accept, e_nc)
        rmax = torch.where(accept, torch.maximum(rmax, e_logl), rmax)
        outs.append((accept, v_logl) + vals + (delta_logz, n_now))
    outs = [torch.stack(c) for c in zip(*outs)]
    return [victims, torch.full((q,), -1, dtype=torch.int64, device=device)] \
        + outs


def thin_ties(sorted_logl, q):
    """The thin path's tie counts: at the i-th kill, the live points tied
    with the i-th victim.  Refills sit strictly above every victim, so
    only originals count: (# originals <= victim i) - i."""
    lanes = torch.arange(q, dtype=torch.int64, device=sorted_logl.device)
    return torch.searchsorted(sorted_logl, sorted_logl[:q], right=True) - \
        lanes


def consume_round_plain(st, live_logl, qlogl, qnc, limits, *, batch,
                        dlv_default, thin=None):
    """The consume scan as an eager loop over 0-d tensors.

    ``st``: the carried state (:data:`STATE_KEYS`, 0-d tensors; ``racc``
    holds the round's kills so far).  ``live_logl`` (nlive,) the live
    points' logl, ``qlogl`` (q,) and ``qnc`` (q,) int64 the proposals'.
    ``limits``: ``dlogz``, ``logl_max`` (floats), ``max_accepts``,
    ``max_nc`` (ints).  ``batch``: batch mode (the live count falls with
    each kill of the round) or queue mode (constant, shrinkage
    ``dlv_default``).  ``thin``: None, or ``(sort_idx, sorted_logl,
    thin_ok)`` where the round may take the thin path (``thin_ok`` a bool
    or a 0-d bool tensor, read here).  Returns (the per-step columns, the
    new state).
    """
    st = dict(st)
    if thin is not None and bool(thin[2]):
        outs = _run_thin(st, thin[0], thin[1], qlogl, qnc, limits)
    else:
        outs = _run_general(st, live_logl, qlogl, qnc, limits, batch,
                            dlv_default)
    return outs, st


# --------------------------------------------------------------------------
# the kernel


_ENTRY = {}
_PTR, _I, _D, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
    ctypes.c_longlong
_ARGTYPES = {
    "scan": [_PTR] * 17 + [_I] * 4 + [_D, _D, _LL, _LL, _D, _I, _PTR],
    "integrator": [_PTR] * 11 + [_I, _PTR],
}
_PATH_COUNTS = {}


def _entry(fn, tag):
    key = (fn, tag)
    f = _ENTRY.get(key)
    if f is None:
        lib = build.load_library("consume_scan")
        f = getattr(lib, f"dynesty_consume_{fn}_{tag}")
        f.argtypes = _ARGTYPES[fn]
        f.restype = ctypes.c_int
        _ENTRY[key] = f
    return f


def _path_counts(device):
    c = _PATH_COUNTS.get(device)
    if c is None:
        c = _PATH_COUNTS[device] = torch.zeros(2, dtype=torch.int64,
                                               device=device)
    return c


def path_counts():
    """The kernel's launches by the path each took (one read of the
    device counters): ``{"thin": n, "general": n}``."""
    out = dict.fromkeys(PATHS, 0)
    for c in _PATH_COUNTS.values():
        for k, n in zip(PATHS, c.tolist()):
            out[k] += n
    return out


def zero_counts():
    """Zero ``launches`` and the device path counters."""
    consume_round.launches = 0
    for c in _PATH_COUNTS.values():
        c.zero_()


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"consume_round: {name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"consume_round: {name} is on {t.device}, the "
                         f"live logl on {device}")
    if t.dtype != dtype:
        raise TypeError(f"consume_round: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"consume_round: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"consume_round: {name} must be contiguous")


def _launch(st, live_logl, qlogl, qnc, limits, batch, dlv_default, thin):
    nlive, q = live_logl.shape[0], qlogl.shape[0]
    dtype, dev = live_logl.dtype, live_logl.device
    i64 = torch.int64
    f = _entry("scan", _DTYPES[dtype])
    fst = torch.stack([st[k] for k in FLOAT_KEYS])
    ist = torch.stack([st[k].to(i64) for k in INT_KEYS])
    if thin is not None:
        sort_idx, sorted_logl, thin_ok = thin
        npl_pre = thin_ties(sorted_logl, q)
        thin_ptrs = (sort_idx.data_ptr(), sorted_logl.data_ptr(),
                     npl_pre.data_ptr(), thin_ok.data_ptr())
    else:
        thin_ptrs = (None,) * 4
    scratch = torch.empty(nlive, dtype=dtype, device=dev)
    occupant = torch.empty(nlive, dtype=i64, device=dev)
    fout = torch.empty((8, q), dtype=dtype, device=dev)
    iout = torch.empty((3, q), dtype=i64, device=dev)
    accepts = torch.empty(q, dtype=torch.bool, device=dev)
    fst_out = torch.empty_like(fst)
    ist_out = torch.empty(len(INT_KEYS), dtype=i64, device=dev)
    # the comparisons of the eager loop take the limits in the state's
    # type
    rnd = float if dtype == torch.float64 else (
        lambda x: float(torch.tensor(x, dtype=dtype)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = f(live_logl.data_ptr(), qlogl.data_ptr(), qnc.data_ptr(),
                *thin_ptrs, fst.data_ptr(), ist.data_ptr(),
                scratch.data_ptr(), occupant.data_ptr(), fout.data_ptr(),
                iout.data_ptr(), accepts.data_ptr(), fst_out.data_ptr(),
                ist_out.data_ptr(), _path_counts(dev).data_ptr(),
                nlive, q, int(batch), int(thin is not None),
                rnd(limits["dlogz"]), rnd(limits["logl_max"]),
                int(limits["max_accepts"]), int(limits["max_nc"]),
                rnd(dlv_default), BLOCK, stream)
    if err != 0:
        raise RuntimeError(f"consume_scan kernel launch failed (cudaError "
                           f"{err}) for nlive={nlive}, q={q}")
    consume_round.launches += 1
    new = dict(zip(FLOAT_KEYS, fst_out.unbind()))
    new.update(zip(INT_KEYS, ist_out.unbind()))
    for k in BOOL_KEYS:
        new[k] = new[k].to(torch.bool)
    (r_logl, r_logvol, r_logwt, r_logz, r_logzvar, r_h, r_dlogz,
     r_n) = fout.unbind()
    worsts, srcs, r_nc = iout.unbind()
    return [worsts, srcs, accepts, r_logl, r_logvol, r_logwt, r_logz,
            r_logzvar, r_h, r_nc, r_dlogz, r_n], new


def _validate(st, live_logl, qlogl, qnc, batch, thin):
    if not isinstance(live_logl, torch.Tensor):
        raise TypeError("consume_round takes torch tensors")
    dtype, dev = live_logl.dtype, live_logl.device
    if dtype not in _DTYPES:
        raise TypeError(f"consume_round takes float64 or float32, got "
                        f"{dtype}")
    if live_logl.dim() != 1 or not isinstance(qlogl, torch.Tensor) or \
            qlogl.dim() != 1:
        raise ValueError("consume_round takes (nlive,) and (q,) logl")
    nlive, q = live_logl.shape[0], qlogl.shape[0]
    if q < 1 or (batch and q >= nlive) or nlive >= 2 ** 31:
        raise ValueError(f"consume_round needs 1 <= q (< nlive in batch "
                         f"mode), got nlive={nlive}, q={q}")
    _check("live_logl", live_logl, (nlive,), dtype, dev)
    _check("qlogl", qlogl, (q,), dtype, dev)
    _check("qnc", qnc, (q,), torch.int64, dev)
    for k in STATE_KEYS:
        want = dtype if k in FLOAT_KEYS else (
            torch.bool if k in BOOL_KEYS else torch.int64)
        _check(k, st[k], (), want, dev)
    if thin is not None:
        _check("sort_idx", thin[0], (nlive,), torch.int64, dev)
        _check("sorted_logl", thin[1], (nlive,), dtype, dev)
        if dev.type == "cuda":
            _check("thin_ok", thin[2], (), torch.bool, dev)


def consume_round(st, live_logl, qlogl, qnc, limits, *, batch, dlv_default,
                  thin=None):
    """Consume one round's ``q`` proposals against the live set (the
    arguments of :func:`consume_round_plain`).

    Takes ``live_logl`` float64 or float32, contiguous (nlive,); ``qlogl``
    (q,) of the same type and ``qnc`` (q,) int64, with 1 <= q, and q <
    nlive in batch mode; the state's tensors 0-d, of the types the plain
    version makes; raises on anything else.  On a CPU tensor this is
    :func:`consume_round_plain`.  On a CUDA tensor it launches the
    ``consume_scan`` kernel or raises; ``thin``'s ``thin_ok`` is then a 0-d
    bool tensor that the kernel reads itself, and the new state also holds
    ``path`` (0 thin, 1 general, on the device).  ``calls`` counts every
    call, ``launches`` every kernel launch; the path of each launch is
    summed on the device (:func:`path_counts`)."""
    consume_round.calls += 1
    _validate(st, live_logl, qlogl, qnc, batch, thin)
    if live_logl.device.type == "cpu":
        return consume_round_plain(st, live_logl, qlogl, qnc, limits,
                                   batch=batch, dlv_default=dlv_default,
                                   thin=thin)
    if live_logl.device.type != "cuda":
        raise ValueError(f"no kernel for device {live_logl.device}")
    return _launch(st, live_logl, qlogl, qnc, limits, batch, dlv_default,
                   thin)


consume_round.calls = 0
consume_round.launches = 0


def integrator_step(loglstar, loglstar_new, logz, logzvar, logvol, dlogvol,
                    h):
    """The kernel's own device integrator step, elementwise over (N,)
    CUDA tensors of one type (float64 or float32): what
    :func:`progress_integration_torch` computes, for holding the two
    against each other on the card.  Returns (logwt, logz, logzvar, h)."""
    args = (loglstar, loglstar_new, logz, logzvar, logvol, dlogvol, h)
    n = loglstar.shape[0]
    for name, t in zip(("loglstar", "loglstar_new", "logz", "logzvar",
                        "logvol", "dlogvol", "h"), args):
        if t.device.type != "cuda":
            raise ValueError("integrator_step runs on CUDA tensors only")
        if t.dtype not in _DTYPES:
            raise TypeError(f"integrator_step takes float64 or float32, "
                            f"got {t.dtype}")
        _check(name, t, (n,), loglstar.dtype, loglstar.device)
    outs = [torch.empty_like(loglstar) for _ in range(4)]
    f = _entry("integrator", _DTYPES[loglstar.dtype])
    with torch.cuda.device(loglstar.device):
        stream = torch.cuda.current_stream(loglstar.device).cuda_stream
        err = f(*(t.data_ptr() for t in args + tuple(outs)), n, stream)
    if err != 0:
        raise RuntimeError(f"consume integrator kernel launch failed "
                           f"(cudaError {err})")
    return tuple(outs)
