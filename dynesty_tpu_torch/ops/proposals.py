"""The per-step updates of the proposal loops: hand-written CUDA kernels
and their plain PyTorch versions.

The JAX package runs each proposal round as one jitted device loop:
the rslice/slice stepping-out state machine as a ``lax.while_loop``
(``dynesty_tpu/internal/kernels.py:763`` ``round_fn_sm``, body ``:801``)
and the random walk as a ``lax.scan`` (``:486`` ``step``, scan ``:512``).
The port runs each round as a host loop around the user's batched
likelihood; the lane-wise updates before and after each likelihood call
are the kernels here:

* :func:`slice_propose` (the iteration's position by phase, the lane's
  direction, the point and its cube check) and :func:`slice_advance`
  (the masks, the interval, the counters, acceptance, the phase
  transitions and the sticky warning), ``csrc/slice_step.cu``;
* :func:`rwalk_propose` (the step, the extra dimensions, periodic and
  reflective wrapping, the cube check) and :func:`rwalk_accept`,
  ``csrc/rwalk_step.cu``.

Random draws and the matrix products stay torch calls (their Philox
streams and reduction orders are torch's own).  On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it runs its plain
version, the eager code the kernel is held against bit for bit.

The round's state is a dict of tensors (:func:`slice_init`,
:func:`rwalk_init`), its buffers the round's own.  Both versions update
the dict: the plain version rebinds its entries, the kernel writes its
tensors in place.
"""

import ctypes
import math

import torch

from . import build
from .geometry import unitcheck_batch, wrap_boundaries

__all__ = ["slice_init", "slice_propose", "slice_propose_plain",
           "slice_advance", "slice_advance_plain", "rwalk_init",
           "rwalk_propose", "rwalk_propose_plain", "rwalk_accept",
           "rwalk_accept_plain", "zero_counts", "WRAPPERS"]

PH_INIT_L, PH_INIT_R, PH_EXP_L, PH_EXP_R, PH_SHRINK = 0, 1, 2, 3, 4
_NEG_INF = -math.inf
_DTYPES = {torch.float64: "f64", torch.float32: "f32"}


def _fresh(t):
    """A contiguous copy that no caller holds (``.to(dtype)`` may return
    a view of the caller's tensor)."""
    return t.clone(memory_format=torch.contiguous_format)


# --------------------------------------------------------------------------
# the stepping-out state machine


def slice_init(start_u, start_v, start_logl, r0):
    """The state machine's state at the start of a round: every lane in
    its first slice step, phase INIT_L, interval ``(-r0, 1 - r0)``."""
    q, device = r0.shape[0], r0.device

    def zi():
        return torch.zeros((q,), dtype=torch.int64, device=device)

    return {
        "s": zi(), "phase": torch.full((q,), PH_INIT_L, dtype=torch.int64,
                                       device=device),
        "left": -r0, "right": 1.0 - r0,
        "fl": torch.full((q,), _NEG_INF, dtype=r0.dtype, device=device),
        "fr": torch.full((q,), _NEG_INF, dtype=r0.dtype, device=device),
        "u": _fresh(start_u), "v": _fresh(start_v),
        "logl": _fresh(start_logl), "u0": _fresh(start_u),
        "nc": zi(), "n_exp": zi(), "n_con": zi(), "exp_step": zi(),
        "warn": torch.zeros((), dtype=torch.bool, device=device),
        # is any lane short of its last slice step (read once an
        # iteration by the host loop)
        "any_active": torch.ones((), dtype=torch.bool, device=device),
    }


def slice_propose_plain(st, u_sh, directions, strict=None):
    """The iteration's position ``x`` of each lane by its phase (the
    interval's ends, one step beyond them, or a uniform point inside),
    the point ``upos = u0 + x * direction`` along the lane's current
    slice direction (``directions`` (q, n_steps, ndim), capped), and
    ``incube``: ``upos`` in the cube (loosely where ``strict`` is False)
    and the lane not done.  Returns ``(x, upos, incube)``."""
    s, phase, left, right = st["s"], st["phase"], st["left"], st["right"]
    q, n_steps = directions.shape[:2]
    active = s < n_steps
    lane = torch.arange(q, device=s.device)
    dirc = directions[lane, s.clamp(max=n_steps - 1)]
    x = torch.where(
        phase == PH_INIT_L, left,
        torch.where(phase == PH_INIT_R, right,
                    torch.where(phase == PH_EXP_L, left - 1.0,
                                torch.where(phase == PH_EXP_R,
                                            right + 1.0,
                                            left + u_sh *
                                            (right - left)))))
    upos = st["u0"] + x[:, None] * dirc
    incube = unitcheck_batch(upos, strict) & active
    return x, upos, incube


def slice_advance_plain(st, x, upos, v_x, logl_x, u_r0, loglstar, n_steps):
    """One step of every lane after the likelihood call at ``upos``:
    record the interval's end values, step out or shrink, accept a point
    above ``loglstar`` (the lane then starts its next slice step on the
    interval ``(-u_r0, 1 - u_r0)``), move to the next phase, flag an
    interval stepped out more than 1000 times.  Returns ``acc`` (q,)."""
    s, phase = st["s"], st["phase"]
    left, right, fl, fr = st["left"], st["right"], st["fl"], st["fr"]
    active = s < n_steps
    st["nc"] = st["nc"] + active

    is_il = active & (phase == PH_INIT_L)
    is_ir = active & (phase == PH_INIT_R)
    is_el = active & (phase == PH_EXP_L)
    is_er = active & (phase == PH_EXP_R)
    is_sh = active & (phase == PH_SHRINK)

    fl = torch.where(is_il | is_el, logl_x, fl)
    fr = torch.where(is_ir | is_er, logl_x, fr)
    left = torch.where(is_el, x, left)
    right = torch.where(is_er, x, right)
    expanding = is_el | is_er
    st["n_exp"] = st["n_exp"] + expanding
    exp_step = st["exp_step"] + expanding
    st["n_con"] = st["n_con"] + is_sh

    acc = is_sh & (logl_x > loglstar)
    rej = is_sh & ~acc
    left = torch.where(rej & (x < 0), x, left)
    right = torch.where(rej & (x > 0), x, right)

    # phase transitions (using the updated fl/fr)
    after_ir = torch.where(
        fl > loglstar, PH_EXP_L,
        torch.where(fr > loglstar, PH_EXP_R, PH_SHRINK))
    nphase = torch.where(is_il, PH_INIT_R, phase)
    nphase = torch.where(is_ir, after_ir, nphase)
    el_done = is_el & (logl_x <= loglstar)
    nphase = torch.where(
        el_done, torch.where(fr > loglstar, PH_EXP_R, PH_SHRINK),
        nphase)
    er_done = is_er & (logl_x <= loglstar)
    nphase = torch.where(er_done, PH_SHRINK, nphase)

    # acceptance: record the point and enter the next slice step
    acc2 = acc[:, None]
    st["u"] = torch.where(acc2, upos, st["u"])
    st["v"] = torch.where(acc2, v_x, st["v"])
    st["logl"] = torch.where(acc, logl_x, st["logl"])
    st["u0"] = torch.where(acc2, upos, st["u0"])
    s = s + acc
    st["s"] = s
    st["left"] = torch.where(acc, -u_r0, left)
    st["right"] = torch.where(acc, 1.0 - u_r0, right)
    st["fl"] = torch.where(acc, _NEG_INF, fl)
    st["fr"] = torch.where(acc, _NEG_INF, fr)
    st["phase"] = torch.where(acc, PH_INIT_L, nphase)
    st["warn"] = st["warn"] | (exp_step > 1000).any()
    st["exp_step"] = torch.where(acc, 0, exp_step)
    st["any_active"] = (s < n_steps).any()
    return acc


# --------------------------------------------------------------------------
# the random walk


def rwalk_init(start_u, start_v, start_logl):
    """The walk's state at the start of a round: the start points and
    zero tallies."""
    q, device = start_logl.shape[0], start_logl.device
    return {"u": _fresh(start_u), "v": _fresh(start_v),
            "logl": _fresh(start_logl),
            "n_acc": torch.zeros((q,), dtype=torch.int64, device=device),
            "n_rej": torch.zeros((q,), dtype=torch.int64, device=device)}


def rwalk_propose_plain(st, du, scale, u_ex=None, periodic=None,
                        reflective=None, nonbounded=None):
    """The proposals ``u[:, :ncdim] + du * scale`` (``du`` (q, ncdim) the
    axes times the unit-ball draws), the uniform draws ``u_ex`` appended
    in the other dimensions, wrapped where ``periodic``, reflected where
    ``reflective``, and their cube check (loosely where ``nonbounded`` is
    False).  Returns ``(u_prop, ok)``."""
    u_prop = st["u"][:, :du.shape[1]] + du * scale
    if u_ex is not None:
        u_prop = torch.cat([u_prop, u_ex], dim=1)
    u_prop = wrap_boundaries(u_prop, periodic, reflective)
    return u_prop, unitcheck_batch(u_prop, nonbounded)


def rwalk_accept_plain(st, u_prop, ok, v_prop, logl_prop, loglstar):
    """Move each lane whose proposal is in the cube and above
    ``loglstar``; tally moves and rejections.  Returns ``accept`` (q,)."""
    accept = ok & (logl_prop > loglstar)
    st["u"] = torch.where(accept[:, None], u_prop, st["u"])
    st["v"] = torch.where(accept[:, None], v_prop, st["v"])
    st["logl"] = torch.where(accept, logl_prop, st["logl"])
    st["n_acc"] = st["n_acc"] + accept
    st["n_rej"] = st["n_rej"] + ~accept
    return accept


# --------------------------------------------------------------------------
# the kernels


_ENTRY = {}


def _entry(lib, fn, tag):
    key = (fn, tag)
    f = _ENTRY.get(key)
    if f is None:
        f = getattr(build.load_library(lib), f"dynesty_{fn}_{tag}")
        f.argtypes = [ctypes.POINTER(ctypes.c_void_p)] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _ENTRY[key] = f
    return f


def _launch(lib, fn, tensors, ints, dtype, device):
    """Launch ``fn`` of library ``lib`` on the current stream: the
    tensors' pointers (None for an absent one) in the source's order,
    then four ints."""
    f = _entry(lib, fn, _DTYPES[dtype])
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    ints = tuple(ints) + (0,) * (4 - len(ints))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = f(ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed (cudaError {err}) "
                           f"at {ints}")


def _check(fn, name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _route(fn, t):
    """``'cpu'`` (the plain version) or ``'cuda'`` (the kernel) for the
    device of ``t``; raises on any other device or type."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn} takes torch tensors")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{fn} takes float64 or float32, got {t.dtype}")
    return t.device.type


def _scalar(fn, name, x, dtype, device):
    """A 0-d tensor of ``dtype`` on ``device`` (what torch compares or
    multiplies a Python number or 0-d tensor in)."""
    if isinstance(x, torch.Tensor):
        if x.dim() != 0:
            raise ValueError(f"{fn}: {name} must be a number or a 0-d "
                             f"tensor")
        if x.device != device:
            raise ValueError(f"{fn}: {name} is on {x.device}, not "
                             f"{device}")
        return x.to(dtype)
    return torch.tensor(float(x), dtype=dtype, device=device)


def _mask(fn, name, m, ndim, device):
    if m is not None:
        _check(fn, name, m, (ndim,), torch.bool, device)
    return m


def _check_slice_state(fn, st, q, ndim, npdim, dtype, device):
    i64 = torch.int64
    for k in ("s", "phase", "nc", "n_exp", "n_con", "exp_step"):
        _check(fn, k, st[k], (q,), i64, device)
    for k in ("left", "right", "fl", "fr", "logl"):
        _check(fn, k, st[k], (q,), dtype, device)
    for k in ("u", "u0"):
        _check(fn, k, st[k], (q, ndim), dtype, device)
    _check(fn, "v", st["v"], (q, npdim), dtype, device)
    for k in ("warn", "any_active"):
        _check(fn, k, st[k], (), torch.bool, device)


def slice_propose(st, u_sh, directions, strict=None):
    """:func:`slice_propose_plain` on a CPU tensor; on a CUDA tensor the
    ``slice_propose`` kernel of ``csrc/slice_step.cu``, which also sets
    ``st['any_active']`` to False for :func:`slice_advance` to raise.
    Takes ``directions`` float64 or float32 (q, n_steps, ndim), ``u_sh``
    (q,) of its type, the state of :func:`slice_init`, ``strict`` a bool
    (ndim,) or None; raises on anything else."""
    fn = "slice_propose"
    if _route(fn, directions) == "cpu":
        return slice_propose_plain(st, u_sh, directions, strict)
    q, n_steps, ndim = directions.shape
    dtype, dev = directions.dtype, directions.device
    _check(fn, "directions", directions, (q, n_steps, ndim), dtype, dev)
    _check(fn, "u_sh", u_sh, (q,), dtype, dev)
    _check_slice_state(fn, st, q, ndim, st["v"].shape[-1], dtype, dev)
    _mask(fn, "strict", strict, ndim, dev)
    x = torch.empty((q,), dtype=dtype, device=dev)
    upos = torch.empty((q, ndim), dtype=dtype, device=dev)
    incube = torch.empty((q,), dtype=torch.bool, device=dev)
    _launch("slice_step", "slice_propose",
            (st["s"], st["phase"], st["left"], st["right"], st["u0"], u_sh,
             directions, strict, x, upos, incube, st["any_active"]),
            (q, n_steps, ndim), dtype, dev)
    slice_propose.launches += 1
    return x, upos, incube


def slice_advance(st, x, upos, v_x, logl_x, u_r0, loglstar, n_steps):
    """:func:`slice_advance_plain` on a CPU tensor; on a CUDA tensor the
    ``slice_advance`` kernel of ``csrc/slice_step.cu``, which updates the
    state's tensors in place and sets ``st['any_active']`` where a lane
    is short of its last slice step.  ``loglstar`` is a number or a 0-d
    tensor; the others as :func:`slice_propose` gives and the likelihood
    returns them; raises on anything else."""
    fn = "slice_advance"
    if _route(fn, upos) == "cpu":
        return slice_advance_plain(st, x, upos, v_x, logl_x, u_r0,
                                   loglstar, n_steps)
    (q, ndim), npdim = upos.shape, st["v"].shape[-1]
    dtype, dev = upos.dtype, upos.device
    # the likelihood's outputs, in whatever layout the user's function
    # gave them
    v_x, logl_x = v_x.contiguous(), logl_x.contiguous()
    _check_slice_state(fn, st, q, ndim, npdim, dtype, dev)
    for name, t, shape in (("x", x, (q,)), ("upos", upos, (q, ndim)),
                           ("v_x", v_x, (q, npdim)),
                           ("logl_x", logl_x, (q,)), ("u_r0", u_r0, (q,))):
        _check(fn, name, t, shape, dtype, dev)
    ls = _scalar(fn, "loglstar", loglstar, dtype, dev)
    acc = torch.empty((q,), dtype=torch.bool, device=dev)
    _launch("slice_step", "slice_advance",
            (st["s"], st["phase"], st["left"], st["right"], st["fl"],
             st["fr"], st["u"], st["v"], st["logl"], st["u0"], st["nc"],
             st["n_exp"], st["n_con"], st["exp_step"], st["warn"],
             st["any_active"], acc, x, upos, v_x, logl_x, u_r0, ls),
            (q, n_steps, ndim, npdim), dtype, dev)
    slice_advance.launches += 1
    return acc


def rwalk_propose(st, du, scale, u_ex=None, periodic=None, reflective=None,
                  nonbounded=None):
    """:func:`rwalk_propose_plain` on a CPU tensor; on a CUDA tensor the
    ``rwalk_propose`` kernel of ``csrc/rwalk_step.cu``.  Takes ``du``
    float64 or float32 (q, ncdim), ``scale`` a number or a 0-d tensor,
    ``u_ex`` (q, ndim - ncdim) or None, the masks bool (ndim,) or None,
    the state of :func:`rwalk_init`; raises on anything else."""
    fn = "rwalk_propose"
    if _route(fn, du) == "cpu":
        return rwalk_propose_plain(st, du, scale, u_ex, periodic,
                                   reflective, nonbounded)
    (q, ncdim), ndim = du.shape, st["u"].shape[-1]
    dtype, dev = du.dtype, du.device
    _check(fn, "du", du, (q, ncdim), dtype, dev)
    _check(fn, "u", st["u"], (q, ndim), dtype, dev)
    if (u_ex is None) != (ncdim == ndim):
        raise ValueError(f"{fn}: u_ex must be given exactly when ncdim < "
                         f"ndim ({ncdim} < {ndim})")
    if u_ex is not None:
        _check(fn, "u_ex", u_ex, (q, ndim - ncdim), dtype, dev)
    masks = [_mask(fn, name, m, ndim, dev) for name, m in
             (("periodic", periodic), ("reflective", reflective),
              ("nonbounded", nonbounded))]
    sc = _scalar(fn, "scale", scale, dtype, dev)
    u_prop = torch.empty((q, ndim), dtype=dtype, device=dev)
    ok = torch.empty((q,), dtype=torch.bool, device=dev)
    _launch("rwalk_step", "rwalk_propose",
            (st["u"], du, sc, u_ex, *masks, u_prop, ok), (q, ndim, ncdim),
            dtype, dev)
    rwalk_propose.launches += 1
    return u_prop, ok


def rwalk_accept(st, u_prop, ok, v_prop, logl_prop, loglstar):
    """:func:`rwalk_accept_plain` on a CPU tensor; on a CUDA tensor the
    ``rwalk_accept`` kernel of ``csrc/rwalk_step.cu``, which updates the
    state's tensors in place.  ``loglstar`` is a number or a 0-d tensor;
    raises on anything else."""
    fn = "rwalk_accept"
    if _route(fn, u_prop) == "cpu":
        return rwalk_accept_plain(st, u_prop, ok, v_prop, logl_prop,
                                  loglstar)
    (q, ndim), npdim = u_prop.shape, st["v"].shape[-1]
    dtype, dev = u_prop.dtype, u_prop.device
    v_prop, logl_prop = v_prop.contiguous(), logl_prop.contiguous()
    for name, t, shape in (("u", st["u"], (q, ndim)),
                           ("v", st["v"], (q, npdim)),
                           ("logl", st["logl"], (q,)),
                           ("u_prop", u_prop, (q, ndim)),
                           ("v_prop", v_prop, (q, npdim)),
                           ("logl_prop", logl_prop, (q,))):
        _check(fn, name, t, shape, dtype, dev)
    _check(fn, "ok", ok, (q,), torch.bool, dev)
    for k in ("n_acc", "n_rej"):
        _check(fn, k, st[k], (q,), torch.int64, dev)
    ls = _scalar(fn, "loglstar", loglstar, dtype, dev)
    accept = torch.empty((q,), dtype=torch.bool, device=dev)
    _launch("rwalk_step", "rwalk_accept",
            (st["u"], st["v"], st["logl"], st["n_acc"], st["n_rej"], accept,
             u_prop, ok, v_prop, logl_prop, ls), (q, ndim, npdim), dtype,
            dev)
    rwalk_accept.launches += 1
    return accept


WRAPPERS = (slice_propose, slice_advance, rwalk_propose, rwalk_accept)


def zero_counts():
    """Zero every wrapper's ``launches``."""
    for w in WRAPPERS:
        w.launches = 0


zero_counts()
