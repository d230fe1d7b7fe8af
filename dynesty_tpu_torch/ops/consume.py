"""The consume scan of one fused round and the round's record and live
assembly: hand-written CUDA kernels and their plain PyTorch versions.

A fused round proposes ``q`` points, then consumes them in order against
the live set: worst-point selection, plateau entry and exit, the
streaming trapezoid evidence update, the counters and the stopping
checks.  The JAX package runs that as a ``lax.scan`` inside its jitted
round (``dynesty_tpu/internal/fused.py:212`` general body, ``:333`` thin
body, ``:423`` the ``lax.cond`` between them).

:func:`consume_round` on a CUDA tensor launches
``csrc/consume_scan.cu`` (built lazily by :mod:`.build`; the design notes
are in that source): one block consumes the whole round and picks the
thin or the general path on the device; one thread runs the evidence
chain while the rest of the block computes everything off it, and the
general path keeps the live logl in shared memory where it fits
(:func:`smem_layout`).  On a CPU tensor it runs
:func:`consume_round_plain`, the eager loop over 0-d tensors that the
kernel is held against bit for bit.

The integrator and counter state is a dict of 0-d tensors with the keys
:data:`STATE_KEYS`; both versions return a new dict and never write the
caller's tensors.  The per-step columns come back in the order (worsts,
srcs, accepts, logl, logvol, logwt, logz, logzvar, h, nc, delta_logz,
n): int64, int64, bool, then the state's type but nc (int64).

:func:`round_assemble` takes those columns on: the round's record rows,
its proposals block and the live matrix refilled with the last proposal
accepted into each slot (the JAX package's ``one_round`` after the scan,
``dynesty_tpu/internal/fused.py:146``).  On a CUDA tensor it launches
``csrc/round_assemble.cu`` (two kernels), writing straight into a
dispatch's output buffers at the round's index, which it reads from the
device; on a CPU tensor it runs :func:`round_assemble_plain`, the eager
assembly the kernels are held against bit for bit.
"""

import contextlib
import ctypes

import numpy as np
import torch

from . import build
from .integrals import progress_integration_torch

__all__ = ["consume_round", "consume_round_plain", "integrator_step",
           "chain_probe", "chain_probe_plain", "smem_layout",
           "resident_limit", "path_counts", "zero_counts", "STATE_KEYS",
           "device_limits", "round_assemble", "round_assemble_plain",
           "round_assemble_plain_into", "assemble_buffers"]

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
# threads of the one block, and steps of a chunk (the kernel's CHUNK)
BLOCK = 256


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
    "scan": [_PTR] * 17 + [_I] * 7 + [_D, _D, _LL, _LL, _D, _I, _PTR, _PTR],
    "integrator": [_PTR] * 11 + [_I, _PTR],
    "chain_probe": [_PTR] * 3 + [_I, _I, _PTR],
}
_PATH_COUNTS = {}
# None, or an int64 CUDA tensor of STAGES entries: each launch then writes
# the SM clock at its stages there (the kernel's Stage enum), a trace for
# timing its parts (bench_consume.py --stages); it changes no result
STAGE_CLOCKS = None
STAGES = ("start", "init", "prologue", "select", "terms", "chain",
          "delta", "info", "end")
_FSIZE = {torch.float64: 8, torch.float32: 4}
# the dynamic shared memory the kernel may take on Hopper: a block's 227
# KB less 1 KB kept for the kernel's static shared memory (under 300 bytes)
SMEM_MAX = 227 * 1024 - 1024


def _up16(n):
    return (n + 15) // 16 * 16


def smem_layout(nlive, dtype):
    """The kernel's dynamic shared memory for a round over ``nlive`` live
    points of ``dtype``: a chunk's per-step values (:data:`BLOCK` + 1
    steps), the partial reductions of the live logl's segments and, where
    they fit in :data:`SMEM_MAX`, the live logl and its occupant
    (``resident``); where they do not, those two stay in global memory.
    ``seg`` is the segment's length: the shortest multiple of 32 that
    cuts the live set into at most 32 segments, one partial for each lane
    of the warp that selects.  A pure function; ``csrc/consume_scan.cu``
    carves the same layout.  Returns ``{"bytes", "resident", "seg",
    "nseg"}``."""
    fsize = _FSIZE[dtype]
    chunk = _up16((BLOCK + 1) * (2 * 8 + 18 * fsize + 3 * 4 + 2))
    seg = 32 * max(1, -(-nlive // (32 * 32)))
    nseg = -(-nlive // seg)
    base = chunk + _up16(nseg * 16)
    resident = base + nlive * (fsize + 4) <= SMEM_MAX
    return {"bytes": base + nlive * (fsize + 4) if resident else base,
            "resident": resident, "seg": seg, "nseg": nseg}


def resident_limit(dtype):
    """The largest live set whose logl and occupant stay in shared
    memory (:func:`smem_layout`)."""
    n = SMEM_MAX // (_FSIZE[dtype] + 4)
    while not smem_layout(n, dtype)["resident"]:
        n -= 1
    return n


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
    """Zero ``launches`` (the consume scan's and :func:`round_assemble`'s)
    and the device path counters."""
    consume_round.launches = 0
    round_assemble.launches = 0
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


@contextlib.contextmanager
def _on_device(dev):
    """The device made current, and its current stream's handle."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def _outputs(q, dtype, dev):
    """Every output of a launch in one buffer: the 8 float and 3 integer
    columns, the accepts, and the new state (6 floats, 9 integers, and
    plateau_mode and done once more as bools)."""
    fsize = _FSIZE[dtype]
    off_i = 8 * q * fsize
    off_acc = off_i + 24 * q
    off_st = _up16(off_acc + q)
    buf = torch.empty(off_st + 128, dtype=torch.uint8, device=dev)
    return (buf[:off_i].view(dtype).view(8, q),
            buf[off_i:off_acc].view(torch.int64).view(3, q),
            buf[off_acc:off_acc + q].view(torch.bool),
            buf[off_st:off_st + 6 * fsize].view(dtype),
            buf[off_st + 48:off_st + 120].view(torch.int64),
            buf[off_st + 120:off_st + 122].view(torch.bool))


def _rounder(dtype):
    """The comparisons of the eager loop take the limits in the state's
    type: each limit as that type's nearest value, as a Python float."""
    if dtype == torch.float64:
        return float
    return lambda x: float(torch.tensor(x, dtype=dtype))


def device_limits(limits, dlv_default, dtype, out=None):
    """The limits of :func:`consume_round` as the kernel reads them from
    device memory (its ``Limits``: dlogz, logl_max and dlv_default rounded
    to ``dtype`` as doubles, then max_accepts and max_nc), as an int64
    (5,) CPU tensor, or copied into ``out`` (an int64 (5,) CUDA tensor,
    given as ``limits['device']``): a launch captured in a CUDA graph then
    reads each dispatch's limits."""
    rnd = _rounder(dtype)
    host = torch.from_numpy(np.concatenate([
        np.array([rnd(limits["dlogz"]), rnd(limits["logl_max"]),
                  rnd(dlv_default)], dtype=np.float64).view(np.int64),
        np.array([int(limits["max_accepts"]), int(limits["max_nc"])],
                 dtype=np.int64)]))
    if out is None:
        return host
    return out.copy_(host)


def _launch(st, live_logl, qlogl, qnc, limits, batch, dlv_default, thin):
    nlive, q = live_logl.shape[0], qlogl.shape[0]
    dtype, dev = live_logl.dtype, live_logl.device
    f = _entry("scan", _DTYPES[dtype])
    # the state goes in as a table of its tensors' addresses, by value
    state_in = (ctypes.c_void_p * len(STATE_KEYS))(
        *[st[k].data_ptr() for k in STATE_KEYS])
    if thin is not None:
        thin_ptrs = tuple(t.data_ptr() for t in thin)
    else:
        thin_ptrs = (None,) * 3
    lay = smem_layout(nlive, dtype)
    if lay["resident"]:
        scratch = occupant = None
    else:
        scratch = torch.empty(nlive, dtype=dtype, device=dev)
        occupant = torch.empty(nlive, dtype=torch.int32, device=dev)
    fout, iout, accepts, fst_out, ist_out, bst_out = _outputs(q, dtype, dev)
    rnd = _rounder(dtype)
    lim_dev = limits.get("device")
    with _on_device(dev) as stream:
        err = f(live_logl.data_ptr(), qlogl.data_ptr(), qnc.data_ptr(),
                *thin_ptrs, state_in,
                None if scratch is None else scratch.data_ptr(),
                None if occupant is None else occupant.data_ptr(),
                fout.data_ptr(), iout.data_ptr(), accepts.data_ptr(),
                fst_out.data_ptr(), ist_out.data_ptr(), bst_out.data_ptr(),
                _path_counts(dev).data_ptr(),
                None if STAGE_CLOCKS is None else STAGE_CLOCKS.data_ptr(),
                nlive, q, int(batch),
                int(thin is not None), int(lay["resident"]), lay["seg"],
                lay["bytes"], rnd(limits["dlogz"]), rnd(limits["logl_max"]),
                int(limits["max_accepts"]), int(limits["max_nc"]),
                rnd(dlv_default), BLOCK,
                None if lim_dev is None else lim_dev.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"consume_scan kernel launch failed (cudaError "
                           f"{err}) for nlive={nlive}, q={q}")
    consume_round.launches += 1
    new = dict(zip(FLOAT_KEYS, fst_out.unbind()))
    new.update(zip(INT_KEYS, ist_out.unbind()))
    new.update(zip(BOOL_KEYS, bst_out.unbind()))
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
    with _on_device(loglstar.device) as stream:
        err = f(*(t.data_ptr() for t in args + tuple(outs)), n, stream)
    if err != 0:
        raise RuntimeError(f"consume integrator kernel launch failed "
                           f"(cudaError {err})")
    return tuple(outs)


def chain_probe(logwt, logz0, reps=1):
    """The kernel's chain alone, for its bound: the ``q`` dependent
    evidence updates ``logz = logaddexp(logz, logwt[j])`` from ``logz0``
    on one thread, as the chain thread runs them, ``reps`` times in
    series.  ``logwt`` is a (q,) CUDA tensor (q <= :data:`BLOCK`) of
    float64 or float32, ``logz0`` a 0-d one of its type.  Returns the
    final logz (a 0-d tensor); :func:`chain_probe_plain` is its plain
    version."""
    q = logwt.shape[0] if logwt.dim() == 1 else 0
    for name, t, shape in (("logwt", logwt, (q,)), ("logz0", logz0, ())):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError("chain_probe runs on CUDA tensors only")
        if t.dtype not in _DTYPES:
            raise TypeError(f"chain_probe takes float64 or float32, got "
                            f"{t.dtype}")
        _check(name, t, shape, logwt.dtype, logwt.device)
    if not 1 <= q <= BLOCK or reps < 1:
        raise ValueError(f"chain_probe needs 1 <= q <= {BLOCK} and reps >= "
                         f"1, got q={q}, reps={reps}")
    out = torch.empty((), dtype=logwt.dtype, device=logwt.device)
    f = _entry("chain_probe", _DTYPES[logwt.dtype])
    with _on_device(logwt.device) as stream:
        err = f(logwt.data_ptr(), logz0.data_ptr(), out.data_ptr(), q, reps,
                stream)
    if err != 0:
        raise RuntimeError(f"consume chain probe launch failed (cudaError "
                           f"{err})")
    return out


def chain_probe_plain(logwt, logz0):
    """:func:`chain_probe` as an eager loop (one pass)."""
    logz = logz0
    for j in range(logwt.shape[0]):
        logz = torch.logaddexp(logz, logwt[j])
    return logz


# --------------------------------------------------------------------------
# the round's record and live assembly


def round_assemble_plain(outs, live, qu, qv, qlogl, qnc, lane_stats, it0,
                         birth_new):
    """The record and live assembly of one round as eager torch code.

    ``outs``: the consume scan's twelve columns (:func:`consume_round`);
    ``live`` (nlive, ndim + npdim + 4) the live matrix before the round;
    ``qu``, ``qv``, ``qlogl``, ``qnc`` (int64) and ``lane_stats`` (q, 2)
    the proposals; ``it0`` (0-d int64) the iteration at the round's start;
    ``birth_new`` (0-d) the refills' birth threshold.  Returns ``(recs (q,
    1 + ndim + npdim + 11), proposals (q, ndim + npdim + 4), live_out,
    last (nlive,) int64: the entry that refilled each slot or -1)``."""
    (worsts, srcs, accepts, r_logl, r_logvol, r_logwt, r_logz, r_logzvar,
     r_h, r_nc, _r_dlogz, r_n) = outs
    nlive, ndim = live.shape[0], qu.shape[1]
    il = ndim + qv.shape[1]
    ii, ib, ibirth = il + 1, il + 2, il + 3
    dtype, device = live.dtype, live.device
    i64 = torch.int64
    q = worsts.shape[0]
    lanes = torch.arange(q, dtype=i64, device=device)
    acc_i = accepts.to(i64)
    acc_before = torch.cumsum(acc_i, 0) - acc_i
    entry_it = (it0 + acc_before).to(dtype)
    from_orig = srcs < 0
    srcc = srcs.clamp(min=0)
    fo2 = from_orig[:, None]
    u_dead = torch.where(fo2, live[worsts, :ndim], qu[srcc])
    v_dead = torch.where(fo2, live[worsts, ndim:il], qv[srcc])
    it_dead = torch.where(from_orig, live[worsts, ii], entry_it[srcc])
    bound_dead = torch.where(from_orig, live[worsts, ib], -1.0)
    birth_dead = torch.where(from_orig, live[worsts, ibirth], birth_new)
    recs = torch.cat([
        worsts.to(dtype)[:, None], u_dead, v_dead,
        torch.stack([r_logl, r_logvol, r_logwt, r_logz, r_logzvar, r_h,
                     r_nc.to(dtype), it_dead, bound_dead,
                     r_n.to(dtype), birth_dead], dim=1),
    ], dim=1)

    # last accepted entry per live slot (slot nlive is the dump row)
    idx = torch.where(accepts, worsts, nlive)
    last = torch.full((nlive + 1,), -1, dtype=i64, device=device)
    last = last.scatter_reduce(0, idx, lanes, reduce="amax")[:nlive]
    replaced = last >= 0
    lastc = last.clamp(min=0)
    new_rows = torch.cat([
        qu[lastc], qv[lastc],
        torch.stack([qlogl[lastc], entry_it[lastc],
                     torch.full((nlive,), -1.0, dtype=dtype,
                                device=device),
                     birth_new.to(dtype).expand(nlive)], dim=1),
    ], dim=1)
    live_out = torch.where(replaced[:, None], new_rows, live)
    proposals = torch.cat([qu, qv, qlogl[:, None], qnc.to(dtype)[:, None],
                           lane_stats.to(dtype)], dim=1)
    return recs, proposals, live_out, last


def assemble_buffers(rounds, q, nlive, ndim, npdim, dtype, device):
    """The output buffers of a dispatch of ``rounds`` rounds that
    :func:`round_assemble` writes: ``recs`` (rounds * q, 1 + ndim + npdim
    + 11), ``props`` (rounds * q, ndim + npdim + 4), ``accepts``,
    ``dlogz`` (rounds * q,), ``lane`` (rounds * q, 2) and ``thresholds``
    (rounds,) of ``dtype``; ``last`` (nlive,) and the scratch ``entry_it``
    (q,), int64; and the kernels' scratch ``mark`` (nlive,) int32, made
    zeroed, which they leave zeroed (the plain version never touches it).
    The outputs are unfilled: the caller zeroes them once a dispatch (the
    mark with them, which keeps it)."""
    def e(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    n = rounds * q
    return {"recs": e((n, 1 + ndim + npdim + 11)),
            "props": e((n, ndim + npdim + 4)), "accepts": e((n,)),
            "dlogz": e((n,)), "lane": e((n, 2)), "thresholds": e((rounds,)),
            "last": e((nlive,), torch.int64),
            "entry_it": e((q,), torch.int64),
            "mark": torch.zeros((nlive,), dtype=torch.int32, device=device)}


def _check_assemble(outs, live, qrows, qnc, lane_stats, it0, birth_new,
                    threshold, out, ridx, ndim):
    fn = "round_assemble"
    if not isinstance(live, torch.Tensor) or live.dim() != 2:
        raise ValueError(f"{fn}: live must be a 2-d tensor")
    dtype, dev = live.dtype, live.device
    if dtype not in _DTYPES:
        raise TypeError(f"{fn} takes float64 or float32, got {dtype}")
    nlive, lw = live.shape
    il, q = lw - 4, outs[0].shape[0]
    if not 1 <= ndim <= il or q < 1:
        raise ValueError(f"{fn}: bad shape (q={q}, ndim={ndim}, live "
                         f"{tuple(live.shape)})")
    _check("live", live, (nlive, lw), dtype, dev)
    for name, t, dt in zip(("worsts", "srcs", "accepts"), outs[:3],
                           (torch.int64, torch.int64, torch.bool)):
        _check(name, t, (q,), dt, dev)
    for k, t in enumerate(outs[3:]):
        _check(f"column {k}", t, (q,),
               torch.int64 if k == 6 else dtype, dev)
    for name, t, width in (("qrows", qrows, il + 1),
                           ("lane_stats", lane_stats, 2)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2 or \
                t.shape[0] != q or t.shape[1] < width or \
                t.stride(1) != 1 or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{fn}: {name} must be ({q}, >= {width}) "
                             f"{dtype} on {dev} with unit column stride")
    _check("qnc", qnc, (q,), torch.int64, dev)
    _check("it0", it0, (), torch.int64, dev)
    for name, t in (("birth_new", birth_new), ("threshold", threshold)):
        _check(name, t, (), dtype, dev)
    if ridx is not None:
        _check("ridx", ridx, (), torch.int64, dev)
    n = out["thresholds"].shape[0] * q
    for k, shape in (("recs", (n, il + 12)), ("props", (n, il + 4)),
                     ("accepts", (n,)), ("dlogz", (n,)), ("lane", (n, 2)),
                     ("thresholds", (n // q,))):
        _check(k, out[k], shape, dtype, dev)
    _check("last", out["last"], (nlive,), torch.int64, dev)
    _check("entry_it", out["entry_it"], (q,), torch.int64, dev)
    _check("mark", out.get("mark"), (nlive,), torch.int32, dev)


def round_assemble_plain_into(outs, live, qrows, qnc, lane_stats, it0,
                              birth_new, threshold, out, ridx=None, *,
                              ndim):
    """:func:`round_assemble_plain` with :func:`round_assemble`'s
    arguments and effects (on any device; ``ridx`` read on the host)."""
    q, il = outs[0].shape[0], live.shape[1] - 4
    recs, props, live_out, last = round_assemble_plain(
        outs, live, qrows[:, :ndim], qrows[:, ndim:il], qrows[:, il], qnc,
        lane_stats[:, :2], it0, birth_new)
    r = 0 if ridx is None else int(ridx)
    rows = slice(r * q, (r + 1) * q)
    for k, t in (("recs", recs), ("props", props),
                 ("accepts", outs[2].to(live.dtype)), ("dlogz", outs[10]),
                 ("lane", props[:, -2:])):
        out[k][rows] = t
    out["thresholds"][r] = threshold
    out["last"].copy_(last)
    live.copy_(live_out)


def round_assemble(outs, live, qrows, qnc, lane_stats, it0, birth_new,
                   threshold, out, ridx=None, *, ndim):
    """Assemble one round after its consume scan, in place.

    ``outs``: the scan's twelve columns (:func:`consume_round`); ``live``
    (nlive, ndim + npdim + 4), refilled in place; ``qrows`` (q, >= ndim +
    npdim + 1) the proposals' ``u | v | logl`` and ``lane_stats`` (q, >=
    2), both with unit column stride; ``qnc`` (q,) int64; ``it0`` 0-d
    int64; ``birth_new`` and ``threshold`` (the round's loglstar) 0-d of
    the live matrix's type; ``out`` the dispatch's buffers
    (:func:`assemble_buffers`), whose rows ``ridx * q`` on (``ridx`` a 0-d
    int64 tensor on the live matrix's device, read there; None: round 0)
    take the round's records, proposals, accepts (as 0 or 1), delta_logz
    and lane stats, ``thresholds[ridx]`` its loglstar and ``last`` each
    slot's refill (-1: kept); ``mark`` is the kernels' scratch, zero
    before and after the call.

    On a CPU tensor this runs :func:`round_assemble_plain`
    (:func:`round_assemble_plain_into`, which leaves ``mark`` as it is);
    on a CUDA tensor it launches the two kernels of
    ``csrc/round_assemble.cu`` or raises.  ``launches`` counts the CUDA
    calls."""
    _check_assemble(outs, live, qrows, qnc, lane_stats, it0, birth_new,
                    threshold, out, ridx, ndim)
    q, il = outs[0].shape[0], live.shape[1] - 4
    if live.device.type == "cpu":
        round_assemble_plain_into(outs, live, qrows, qnc, lane_stats, it0,
                                  birth_new, threshold, out, ridx,
                                  ndim=ndim)
        return
    if live.device.type != "cuda":
        raise ValueError(f"no kernel for device {live.device}")
    ptrs = (ctypes.c_void_p * 29)(*[None if t is None else t.data_ptr()
                                    for t in (
        *outs[:3], *outs[3:9], outs[9], outs[10], outs[11], live, qrows,
        qnc, lane_stats, it0, birth_new, threshold, ridx, out["recs"],
        out["props"], out["accepts"], out["dlogz"], out["lane"],
        out["thresholds"], out["entry_it"], out["last"], out["mark"])])
    f = _assemble_entry(_DTYPES[live.dtype])
    with _on_device(live.device) as stream:
        err = f(ptrs, q, live.shape[0], ndim, il - ndim, qrows.stride(0),
                lane_stats.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"round_assemble kernel launch failed (cudaError "
                           f"{err}) for nlive={live.shape[0]}, q={q}")
    round_assemble.launches += 1


round_assemble.launches = 0


def _assemble_entry(tag):
    key = ("assemble", tag)
    f = _ENTRY.get(key)
    if f is None:
        lib = build.load_library("round_assemble")
        f = getattr(lib, f"dynesty_round_assemble_{tag}")
        f.argtypes = [ctypes.POINTER(ctypes.c_void_p)] + [_I] * 6 + [_PTR]
        f.restype = ctypes.c_int
        _ENTRY[key] = f
    return f
