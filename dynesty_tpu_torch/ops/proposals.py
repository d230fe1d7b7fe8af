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
  direction, the point, the point clamped into the cube and its cube
  check) and :func:`slice_advance` (the likelihood's -inf mask outside
  the cube, the masks, the interval, the counters, acceptance, the phase
  transitions and the sticky warning), ``csrc/slice_step.cu``;
* :func:`rwalk_propose` (the step, the extra dimensions, periodic and
  reflective wrapping, the cube check) and :func:`rwalk_accept`,
  ``csrc/rwalk_step.cu``.

Random draws and the matrix products stay torch calls (their Philox
streams and reduction orders are torch's own).  On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it runs its plain
version, the eager code the kernel is held against bit for bit.

A slice round runs on a :class:`SliceRound`: every tensor an iteration
touches, allocated, checked and bound to the two kernels' argument tables
once per round shape, so that a call does only its launch and an
iteration can be captured as a CUDA graph (``internal/kernels.py``,
``SliceGraph``).  The walk's state is a dict of tensors
(:func:`rwalk_init`), its buffers the round's own: the plain version
rebinds its entries, the kernel writes its tensors in place.
"""

import ctypes
import math

import torch

from . import build
from .geometry import unitcheck_batch, wrap_boundaries

__all__ = ["SliceRound", "slice_init", "slice_propose",
           "slice_propose_plain", "slice_advance", "slice_advance_plain",
           "rwalk_init",
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


def _slice_state(q, ndim, npdim, dtype, device):
    """The state machine's state tensors for ``q`` lanes, unfilled."""
    def e(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    st = {k: e((q,), torch.int64)
          for k in ("s", "phase", "nc", "n_exp", "n_con", "exp_step")}
    st.update({k: e((q,)) for k in ("left", "right", "fl", "fr", "logl")})
    st.update({"u": e((q, ndim)), "v": e((q, npdim)), "u0": e((q, ndim)),
               "warn": e((), torch.bool),
               # is any lane short of its last slice step (read once an
               # iteration by the host loop)
               "any_active": e((), torch.bool)})
    return st


def slice_init(start_u, start_v, start_logl, r0, rb=None):
    """The state machine's state at the start of a round: every lane in
    its first slice step, phase INIT_L, interval ``(-r0, 1 - r0)``.
    With ``rb`` (a :class:`SliceRound`) the round's own state buffers are
    filled in place and returned; without, fresh tensors."""
    q, ndim = start_u.shape
    st = rb.st if rb is not None else _slice_state(
        q, ndim, start_v.shape[-1], r0.dtype, r0.device)
    for k in ("s", "nc", "n_exp", "n_con", "exp_step"):
        st[k].zero_()
    st["phase"].fill_(PH_INIT_L)
    st["left"].copy_(-r0)
    st["right"].copy_(1.0 - r0)
    st["fl"].fill_(_NEG_INF)
    st["fr"].fill_(_NEG_INF)
    for k, t in (("u", start_u), ("v", start_v), ("logl", start_logl),
                 ("u0", start_u)):
        st[k].copy_(t)
    st["warn"].fill_(False)
    st["any_active"].fill_(True)
    return st


def slice_propose_plain(st, u_sh, directions, strict=None):
    """The iteration's position ``x`` of each lane by its phase (the
    interval's ends, one step beyond them, or a uniform point inside),
    the point ``upos = u0 + x * direction`` along the lane's current
    slice direction (``directions`` (q, n_steps, ndim), capped), the
    point clamped into the cube (where the likelihood is evaluated), and
    ``incube``: ``upos`` in the cube (loosely where ``strict`` is False)
    and the lane not done.  Returns ``(x, upos, uclamp, incube)``."""
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
    return x, upos, upos.clamp(0.0, 1.0), incube


def slice_advance_plain(st, x, upos, incube, v_x, logl_x, u_r0, loglstar,
                        n_steps):
    """One step of every lane after the likelihood call at the clamped
    ``upos``: mask ``logl_x`` to -inf outside ``incube``, record the
    interval's end values, step out or shrink, accept a point above
    ``loglstar`` (the lane then starts its next slice step on the
    interval ``(-u_r0, 1 - u_r0)``), move to the next phase, flag an
    interval stepped out more than 1000 times.  Returns ``acc`` (q,)."""
    logl_x = torch.where(incube, logl_x, _NEG_INF)
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


class SliceRound:
    """Every tensor one iteration of the stepping-out state machine
    touches, for one round shape ``(q, n_steps, ndim, npdim, dtype)`` on
    one device: the state (``st``, as :func:`slice_init` lays it out), the
    round's inputs (``directions`` (q, n_steps, ndim), ``loglstar`` 0-d,
    the cube check's ``strict`` mask), the iteration's draws (``draws``
    (2, q): the shrink positions, then the next intervals' offsets) and
    its outputs (``x``, ``upos``, ``uclamp``, ``incube``, ``acc``).

    Allocated, checked and, on the card, bound to the two kernels'
    argument tables once; :func:`slice_init` and :meth:`start` load a
    round into it, :func:`slice_propose` and :func:`slice_advance` run an
    iteration on it.  The buffers keep their addresses for the object's
    life, which is what lets an iteration be captured as a CUDA graph."""

    def __init__(self, q, n_steps, ndim, npdim, dtype, device, strict=None):
        fn = "SliceRound"
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"{fn}: no kernel for device {device}")
        if dtype not in _DTYPES:
            raise TypeError(f"{fn} takes float64 or float32, got {dtype}")
        if min(q, n_steps, ndim) < 1 or npdim < 0:
            raise ValueError(f"{fn}: bad shape {(q, n_steps, ndim, npdim)}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.q, self.n_steps, self.ndim, self.npdim = q, n_steps, ndim, npdim
        self.dtype, self.device = dtype, device

        def e(shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        self.st = _slice_state(q, ndim, npdim, dtype, device)
        self.directions = e((q, n_steps, ndim))
        self.loglstar = e(())
        self.draws = e((2, q))
        self.x, self.upos, self.uclamp = e((q,)), e((q, ndim)), e((q, ndim))
        self.incube = e((q,), torch.bool)
        self.acc = e((q,), torch.bool)
        self.strict = None
        if strict is not None:
            if not isinstance(strict, torch.Tensor):
                raise TypeError(f"{fn}: strict must be a torch.Tensor")
            self.strict = strict.to(device=device, dtype=torch.bool).clone(
                memory_format=torch.contiguous_format)
            _check(fn, "strict", self.strict, (ndim,), torch.bool, device)
        self._propose_args = self._advance_args = None
        if device.type == "cuda":
            self._bind()

    def start(self, start_u, start_v, start_logl, r0, directions, loglstar):
        """Load a round: the start state (:func:`slice_init`), the capped
        ``directions`` and the threshold (a number or a 0-d tensor,
        copied once a round); returns the state."""
        st = slice_init(start_u, start_v, start_logl, r0, rb=self)
        self.directions.copy_(directions)
        if isinstance(loglstar, torch.Tensor):
            self.loglstar.copy_(loglstar)
        else:
            self.loglstar.fill_(float(loglstar))
        return st

    def _bind(self):
        """Fill both kernels' argument tables; the likelihood's two outputs
        are written into the advance table at each launch."""
        st = self.st
        propose = (st["s"], st["phase"], st["left"], st["right"], st["u0"],
                   self.draws[0], self.directions, self.strict, self.x,
                   self.upos, self.uclamp, self.incube, st["any_active"])
        advance = (st["s"], st["phase"], st["left"], st["right"], st["fl"],
                   st["fr"], st["u"], st["v"], st["logl"], st["u0"],
                   st["nc"], st["n_exp"], st["n_con"], st["exp_step"],
                   st["warn"], st["any_active"], self.acc, self.x,
                   self.upos, self.incube, None, None, self.draws[1],
                   self.loglstar)
        self._propose_args = _pointer_table(propose)
        self._advance_args = _pointer_table(advance)
        tag = _DTYPES[self.dtype]
        self._propose_fn = _entry("slice_step", "slice_propose", tag)
        self._advance_fn = _entry("slice_step", "slice_advance", tag)

    def check_likelihood(self, v_x, logl_x):
        """Raise unless the likelihood's outputs are what
        :func:`slice_advance` reads: (q, npdim) and (q,) contiguous
        tensors of the round's dtype on its device."""
        for name, t, shape in (("v_x", v_x, (self.q, self.npdim)),
                               ("logl_x", logl_x, (self.q,))):
            _check("slice_advance", name, t, shape, self.dtype, self.device)


def slice_propose(rb):
    """One iteration's proposal on the round ``rb`` (a
    :class:`SliceRound`): :func:`slice_propose_plain` on the CPU (its
    outputs copied into the round's buffers), on the card the
    ``slice_propose`` kernel of ``csrc/slice_step.cu``, which also sets
    ``any_active`` to False for :func:`slice_advance` to raise.  Reads
    ``rb.draws[0]``; writes ``rb.x``, ``rb.upos``, ``rb.uclamp`` and
    ``rb.incube``."""
    if rb.device.type == "cpu":
        outs = slice_propose_plain(rb.st, rb.draws[0], rb.directions,
                                   rb.strict)
        for buf, t in zip((rb.x, rb.upos, rb.uclamp, rb.incube), outs):
            buf.copy_(t)
        return
    _run(rb._propose_fn, rb._propose_args,
         (rb.q, rb.n_steps, rb.ndim, 0), rb.device, "slice_propose")
    slice_propose.launches += 1


def slice_advance(rb, v_x, logl_x):
    """One iteration's update of the round ``rb`` after the likelihood's
    ``v_x`` (q, npdim) and raw ``logl_x`` (q,) at ``rb.uclamp`` (in the
    round's dtype): :func:`slice_advance_plain` on the CPU (the state
    copied back into the round's buffers), on the card the
    ``slice_advance`` kernel of ``csrc/slice_step.cu``, which masks
    ``logl_x`` outside ``rb.incube``, updates the state in place and sets
    ``any_active`` where a lane is short of its last slice step.  Reads
    ``rb.draws[1]`` and ``rb.loglstar``; writes ``rb.acc``."""
    if rb.device.type == "cpu":
        st = dict(rb.st)
        acc = slice_advance_plain(st, rb.x, rb.upos, rb.incube, v_x, logl_x,
                                  rb.draws[1], rb.loglstar, rb.n_steps)
        for k, buf in rb.st.items():
            buf.copy_(st[k])
        rb.acc.copy_(acc)
        return
    table = rb._advance_args
    table[20], table[21] = v_x.data_ptr(), logl_x.data_ptr()
    _run(rb._advance_fn, table, (rb.q, rb.n_steps, rb.ndim, rb.npdim),
         rb.device, "slice_advance")
    slice_advance.launches += 1


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


def _pointer_table(tensors):
    """The ctypes array of the tensors' pointers (None for an absent
    one), in the source's order."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _run(f, ptrs, ints, device, fn):
    """Launch entry ``f`` on ``device``'s current stream with the pointer
    table ``ptrs`` and four ints; raises on a refused launch."""
    if torch.cuda.current_device() != device.index:
        with torch.cuda.device(device):
            return _run(f, ptrs, ints, device, fn)
    err = f(ptrs, *ints, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed (cudaError {err}) "
                           f"at {ints}")


def _launch(lib, fn, tensors, ints, dtype, device):
    """Launch ``fn`` of library ``lib`` on the current stream: the
    tensors' pointers (None for an absent one) in the source's order,
    then four ints."""
    _run(_entry(lib, fn, _DTYPES[dtype]), _pointer_table(tensors),
         tuple(ints) + (0,) * (4 - len(ints)), device, fn)


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
