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
  reflective wrapping, the point clamped into the cube and its cube
  check) and :func:`rwalk_accept` (the likelihood's -inf mask outside the
  cube, the move, the tallies), ``csrc/rwalk_step.cu``;
* :func:`unif_valid` (a uniform wave's lane checks: the wave's width, the
  cube check, the union of ellipsoids' quadratic forms, membership count
  and overlap test, or over balls and cubes the candidate from its
  centre and offset, its distance to every centre, the count and the
  overlap test; and the likelihood's input, the candidates with the
  other dimensions, clamped) and
  :func:`unif_place` (the likelihood's
  -inf mask, the successes compacted into the round's free slots, the
  per-slot evaluations, the round's counts, the next wave's width and the
  done flag), ``csrc/unif_wave.cu``; the JAX package's wave is the body
  ``:366`` of ``make_unif_round``'s ``lax.while_loop``;
* :func:`doubling_point` (the step's two end probes of the doubling
  slice round: the point, its cube check with the round gate and the
  point clamped into the cube), :func:`doubling_expand` (the step's
  start after its end probes, and one doubling, each with the next
  probe: the next doubling's new end or the first shrink candidate),
  :func:`doubling_halve` (one halving of Neal's acceptance test and the
  next halving's probe) and :func:`doubling_shrink` (a shrink
  candidate's outcome with the first halving's probe, and its resolution
  with the next candidate's probe), ``csrc/slice_doubling.cu``;
  the JAX package's loop bodies ``:594-607``, ``:640-655``, ``:569-585``
  and ``:670-693`` of the doubling ``make_slice_round``.

Random draws and the matrix products around them stay torch calls
(their Philox streams and reduction orders are torch's own), but for the
products that ``unif_valid`` forms itself in a fixed order (the union of
ellipsoids' quadratic forms, the friends' candidates and distances).  On
a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version, the eager code the kernel is held
against bit for bit.

A slice round runs on a :class:`SliceRound` (a :class:`DoublingRound` in
doubling mode), a random-walk round on an :class:`RWalkRound`, a uniform
round on a :class:`UnifRound`: every tensor a step touches, allocated,
checked and bound to the kernels' argument tables once per round shape,
so that a call does only its launch and a step can be captured in a CUDA
graph (``internal/kernels.py``, ``SliceGraph``, ``DoublingGraph``,
``RWalkGraph`` and ``UnifGraph``).  A round's
state is a dict of the round's own tensors: the plain version rebinds
its entries and the wrapper copies them back, the kernel writes them in
place.
"""

import ctypes
import math

import torch

from . import build
from .geometry import unitcheck_batch, wrap_boundaries

__all__ = ["SliceRound", "slice_init", "slice_propose",
           "slice_propose_plain", "slice_advance", "slice_advance_plain",
           "RWalkRound", "rwalk_init",
           "rwalk_propose", "rwalk_propose_plain", "rwalk_accept",
           "rwalk_accept_plain", "UnifRound", "UNIF_ARRAYS",
           "unif_width_plain", "unif_valid", "unif_valid_plain",
           "ellipsoid_forms_plain", "unif_input_plain", "UNIF_FORMS",
           "UNIF_FRIENDS", "unif_laid_out", "friends_union_plain",
           "unif_valid_round_plain",
           "unif_place", "unif_place_plain", "DoublingRound",
           "doubling_point", "doubling_point_plain", "doubling_expand",
           "doubling_expand_plain", "doubling_halve",
           "doubling_halve_plain", "doubling_shrink",
           "doubling_shrink_plain", "zero_counts", "WRAPPERS"]

PH_INIT_L, PH_INIT_R, PH_EXP_L, PH_EXP_R, PH_SHRINK = 0, 1, 2, 3, 4
_NEG_INF = -math.inf
_DTYPES = {torch.float64: "f64", torch.float32: "f32"}


def _fresh(t):
    """A contiguous copy that no caller holds (``.to(dtype)`` may return
    a view of the caller's tensor)."""
    return t.clone(memory_format=torch.contiguous_format)


def _load_gate(buf, gate, active=None):
    """Copy the round gate ``gate`` (a 0-d bool tensor; None: open) into
    ``buf``, and clear ``active`` (a 0-d bool flag) where it is set."""
    if gate is None:
        buf.fill_(False)
        return
    buf.copy_(gate)
    if active is not None:
        active.masked_fill_(gate, False)


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
        # the flag the host reads and, beside it, the round gate
        self.flags = e((2,), torch.bool)
        self.st["any_active"], self.gate = self.flags[0], self.flags[1]
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

    def start(self, start_u, start_v, start_logl, r0, directions, loglstar,
              gate=None):
        """Load a round: the start state (:func:`slice_init`), the capped
        ``directions`` and the threshold (a number or a 0-d tensor,
        copied once a round); returns the state.  ``gate`` (a 0-d bool
        tensor, None: open) is the fused round's gate: where it is set no
        lane is active, and the host's first read of ``flags`` sees it."""
        st = slice_init(start_u, start_v, start_logl, r0, rb=self)
        _load_gate(self.gate, gate, st["any_active"])
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


def _rwalk_state(q, ndim, npdim, dtype, device):
    """The walk's state tensors for ``q`` lanes, unfilled."""
    return {"u": torch.empty((q, ndim), dtype=dtype, device=device),
            "v": torch.empty((q, npdim), dtype=dtype, device=device),
            "logl": torch.empty((q,), dtype=dtype, device=device),
            "n_acc": torch.empty((q,), dtype=torch.int64, device=device),
            "n_rej": torch.empty((q,), dtype=torch.int64, device=device)}


def rwalk_init(start_u, start_v, start_logl, rb=None):
    """The walk's state at the start of a round: the start points and
    zero tallies.  With ``rb`` (a :class:`RWalkRound`) the round's own
    state buffers are filled in place and returned; without, fresh
    tensors."""
    q, ndim = start_u.shape
    st = rb.st if rb is not None else _rwalk_state(
        q, ndim, start_v.shape[-1], start_logl.dtype, start_logl.device)
    for k, t in (("u", start_u), ("v", start_v), ("logl", start_logl)):
        st[k].copy_(t)
    st["n_acc"].zero_()
    st["n_rej"].zero_()
    return st


def rwalk_propose_plain(st, du, scale, u_ex=None, periodic=None,
                        reflective=None, nonbounded=None):
    """The proposals ``u[:, :ncdim] + du * scale`` (``du`` (q, ncdim) the
    axes times the unit-ball draws), the uniform draws ``u_ex`` appended
    in the other dimensions, wrapped where ``periodic``, reflected where
    ``reflective``, the proposals clamped into the cube (where the
    likelihood is evaluated), and their cube check (loosely where
    ``nonbounded`` is False).  Returns ``(u_prop, uclamp, ok)``."""
    u_prop = st["u"][:, :du.shape[1]] + du * scale
    if u_ex is not None:
        u_prop = torch.cat([u_prop, u_ex], dim=1)
    u_prop = wrap_boundaries(u_prop, periodic, reflective)
    return u_prop, u_prop.clamp(0.0, 1.0), unitcheck_batch(u_prop,
                                                           nonbounded)


def rwalk_accept_plain(st, u_prop, ok, v_prop, logl_prop, loglstar):
    """After the likelihood's ``v_prop`` and raw ``logl_prop`` at the
    clamped proposals: mask ``logl_prop`` to -inf outside the cube, move
    each lane whose proposal is in the cube and above ``loglstar``, tally
    moves and rejections.  Returns ``accept`` (q,)."""
    logl_prop = torch.where(ok, logl_prop, _NEG_INF)
    accept = ok & (logl_prop > loglstar)
    st["u"] = torch.where(accept[:, None], u_prop, st["u"])
    st["v"] = torch.where(accept[:, None], v_prop, st["v"])
    st["logl"] = torch.where(accept, logl_prop, st["logl"])
    st["n_acc"] = st["n_acc"] + accept
    st["n_rej"] = st["n_rej"] + ~accept
    return accept


def _strided_empty(shape, stride, offset, dtype, device):
    """An empty tensor of ``shape`` laid out with ``stride`` at element
    ``offset`` of its own storage."""
    n = offset + 1 + sum((s - 1) * st for s, st in zip(shape, stride))
    return torch.empty((n,), dtype=dtype, device=device).as_strided(
        shape, stride, offset)


class RWalkRound:
    """Every tensor a step of the random walk touches and that outlives
    the step, for one round shape ``(q, ndim, ncdim, npdim, dtype)`` on one
    device: the state (``st``: ``u, v, logl, n_acc, n_rej``), the round's
    inputs (``axes`` (q, ncdim, ncdim), ``scale`` and ``loglstar`` 0-d,
    the ``periodic``, ``reflective`` and ``nonbounded`` masks) and a
    step's outputs (``u_prop``, ``uclamp``, ``ok``, ``accept``).

    ``axes_layout`` (stride, storage offset) lays ``axes`` out as the
    round's caller lays out its own (a block of the packed start rows),
    so that the step's ``einsum`` reads the layout it read before the
    buffers existed, and sums in the order it summed.

    Allocated, checked and, on the card, bound to the two kernels'
    argument tables once; :meth:`start` loads a round into it,
    :func:`rwalk_propose` and :func:`rwalk_accept` run a step on it.  The
    buffers keep their addresses for the object's life, which is what
    lets a walk be captured as a CUDA graph."""

    def __init__(self, q, ndim, ncdim, npdim, dtype, device, periodic=None,
                 reflective=None, nonbounded=None, axes_layout=None):
        fn = "RWalkRound"
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"{fn}: no kernel for device {device}")
        if dtype not in _DTYPES:
            raise TypeError(f"{fn} takes float64 or float32, got {dtype}")
        if min(q, ncdim) < 1 or ncdim > ndim or npdim < 0:
            raise ValueError(f"{fn}: bad shape {(q, ndim, ncdim, npdim)}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.q, self.ndim, self.ncdim, self.npdim = q, ndim, ncdim, npdim
        self.dtype, self.device = dtype, device

        def e(shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        self.st = _rwalk_state(q, ndim, npdim, dtype, device)
        shape = (q, ncdim, ncdim)
        self.axes = e(shape) if axes_layout is None else _strided_empty(
            shape, *axes_layout, dtype, device)
        self.scale, self.loglstar = e(()), e(())
        self.u_prop, self.uclamp = e((q, ndim)), e((q, ndim))
        self.ok, self.accept = e((q,), torch.bool), e((q,), torch.bool)
        for name, m in (("periodic", periodic), ("reflective", reflective),
                        ("nonbounded", nonbounded)):
            if m is not None:
                if not isinstance(m, torch.Tensor):
                    raise TypeError(f"{fn}: {name} must be a torch.Tensor")
                m = _fresh(m.to(device=device, dtype=torch.bool))
                _check(fn, name, m, (ndim,), torch.bool, device)
            setattr(self, name, m)
        self._propose_args = self._accept_args = None
        if device.type == "cuda":
            self._bind()

    def start(self, start_u, start_v, start_logl, axes, scale, loglstar):
        """Load a round: the start state (:func:`rwalk_init`), the lanes'
        ``axes`` and the step scale and threshold (numbers or 0-d
        tensors, copied once a round); returns the state."""
        st = rwalk_init(start_u, start_v, start_logl, rb=self)
        self.axes.copy_(axes)
        for buf, x in ((self.scale, scale), (self.loglstar, loglstar)):
            if isinstance(x, torch.Tensor):
                buf.copy_(x)
            else:
                buf.fill_(float(x))
        return st

    def _bind(self):
        """Fill both kernels' argument tables; a step's draws (``du``,
        ``u_ex``) and the likelihood's two outputs are written into them
        at each launch."""
        st = self.st
        propose = (st["u"], None, self.scale, None, self.periodic,
                   self.reflective, self.nonbounded, self.u_prop,
                   self.uclamp, self.ok)
        accept = (st["u"], st["v"], st["logl"], st["n_acc"], st["n_rej"],
                  self.accept, self.u_prop, self.ok, None, None,
                  self.loglstar)
        self._propose_args = _pointer_table(propose)
        self._accept_args = _pointer_table(accept)
        tag = _DTYPES[self.dtype]
        self._propose_fn = _entry("rwalk_step", "rwalk_propose", tag)
        self._accept_fn = _entry("rwalk_step", "rwalk_accept", tag)

    def check_draws(self, du, u_ex):
        """Raise unless a step's draws are what :func:`rwalk_propose`
        reads: ``du`` (q, ncdim) and ``u_ex`` (q, ndim - ncdim), or None
        when ncdim == ndim, contiguous tensors of the round's dtype on its
        device."""
        q, ndim, ncdim = self.q, self.ndim, self.ncdim
        if (u_ex is None) != (ncdim == ndim):
            raise ValueError(f"rwalk_propose: u_ex must be given exactly "
                             f"when ncdim < ndim ({ncdim} < {ndim})")
        _check("rwalk_propose", "du", du, (q, ncdim), self.dtype,
               self.device)
        if u_ex is not None:
            _check("rwalk_propose", "u_ex", u_ex, (q, ndim - ncdim),
                   self.dtype, self.device)

    def check_likelihood(self, v_prop, logl_prop):
        """Raise unless the likelihood's outputs are what
        :func:`rwalk_accept` reads: (q, npdim) and (q,) contiguous tensors
        of the round's dtype on its device."""
        for name, t, shape in (("v_prop", v_prop, (self.q, self.npdim)),
                               ("logl_prop", logl_prop, (self.q,))):
            _check("rwalk_accept", name, t, shape, self.dtype, self.device)


def rwalk_propose(rb, du, u_ex=None):
    """One step's proposal on the round ``rb`` (a :class:`RWalkRound`)
    from ``du`` (q, ncdim), the lanes' axes times the unit-ball draws, and
    ``u_ex`` (q, ndim - ncdim), the extra dimensions' uniform draws (None
    when ncdim == ndim): :func:`rwalk_propose_plain` on the CPU (its
    outputs copied into the round's buffers), on the card the
    ``rwalk_propose`` kernel of ``csrc/rwalk_step.cu``, which takes the
    draws as they are (:meth:`RWalkRound.check_draws` holds them once a
    round).  Reads ``rb.st["u"]``, ``rb.scale`` and the masks; writes
    ``rb.u_prop``, ``rb.uclamp`` and ``rb.ok``."""
    if rb.device.type == "cpu":
        outs = rwalk_propose_plain(rb.st, du, rb.scale, u_ex, rb.periodic,
                                   rb.reflective, rb.nonbounded)
        for buf, t in zip((rb.u_prop, rb.uclamp, rb.ok), outs):
            buf.copy_(t)
        return
    table = rb._propose_args
    table[1] = du.data_ptr()
    table[3] = None if u_ex is None else u_ex.data_ptr()
    _run(rb._propose_fn, table, (rb.q, rb.ndim, rb.ncdim, 0), rb.device,
         "rwalk_propose")
    rwalk_propose.launches += 1


def rwalk_accept(rb, v_prop, logl_prop):
    """One step's update of the round ``rb`` after the likelihood's
    ``v_prop`` (q, npdim) and raw ``logl_prop`` (q,) at ``rb.uclamp`` (in
    the round's dtype): :func:`rwalk_accept_plain` on the CPU (the state
    copied back into the round's buffers), on the card the
    ``rwalk_accept`` kernel of ``csrc/rwalk_step.cu``, which masks
    ``logl_prop`` outside ``rb.ok`` and updates the state in place.  Reads
    ``rb.u_prop``, ``rb.ok`` and ``rb.loglstar``; writes ``rb.accept``."""
    if rb.device.type == "cpu":
        st = dict(rb.st)
        acc = rwalk_accept_plain(st, rb.u_prop, rb.ok, v_prop, logl_prop,
                                 rb.loglstar)
        for k, buf in rb.st.items():
            buf.copy_(st[k])
        rb.accept.copy_(acc)
        return
    table = rb._accept_args
    table[8], table[9] = v_prop.data_ptr(), logl_prop.data_ptr()
    _run(rb._accept_fn, table, (rb.q, rb.ndim, rb.npdim, 0), rb.device,
         "rwalk_accept")
    rwalk_accept.launches += 1


# --------------------------------------------------------------------------
# the uniform rejection wave

# the round's state vector: slots filled, waves run, evaluations, lanes
# launched, evaluations not yet charged to a slot, the next wave's width,
# the round's cap on waves
(U_FILLED, U_WAVES, U_NC, U_PROP, U_PENDING, U_WIDTH,
 U_MAX_WAVES) = range(7)
# the bound's arrays a wave reads, by bound kind
UNIF_ARRAYS = {"cube": (), "custom": (),
               "ellipsoids": ("ctrs", "axes", "ams", "logvols", "mask"),
               "balls": ("ctrs", "axes", "axes_inv"),
               "cubes": ("ctrs", "axes", "axes_inv")}
# the union of ellipsoids' arrays that unif_valid reads, which the round
# lays out itself: contiguous, the centres and matrices in its dtype (the
# draws' gather of the centres reads the same values in any layout)
UNIF_FORMS = ("ctrs", "ams", "mask")
# the friends' arrays (balls and cubes) that unif_valid reads, all laid out
# by the round: contiguous, in its dtype (the draws read none of them)
UNIF_FRIENDS = ("ctrs", "axes", "axes_inv")


def unif_laid_out(layout, friends=None):
    """The bound's arrays of ``layout`` that a :class:`UnifRound` lays out
    itself, contiguous in its dtype, for the ``unif_valid`` kernel: over
    balls and cubes (``friends``) ``UNIF_FRIENDS``, over a union of
    ellipsoids ``UNIF_FORMS``, else none."""
    return UNIF_FRIENDS if friends else \
        UNIF_FORMS if "ams" in layout else ()


def unif_width_plain(q, n_filled, n_prop):
    """The width of the next wave from the round's ``n_filled`` and
    ``n_prop`` (int64 tensors): ``q`` until a slot is filled, then ~1.25
    need / efficiency + 4 lanes, in float32 as the JAX package computes
    it, so that the lanes past it are masked before their outcome is
    seen."""
    f32 = torch.float32
    need = (q - n_filled).to(f32)
    eff = n_filled.to(f32) / n_prop.to(f32).clamp_min(1.0)
    est = torch.ceil(1.25 * need / eff.clamp_min(1e-6)) + 4.0
    width = torch.minimum(est, torch.tensor(float(q), dtype=f32,
                                            device=est.device))
    return torch.where((n_filled > 0) & (n_prop > 0), width.to(torch.int64),
                       q)


def ellipsoid_forms_plain(uc, ctrs, ams):
    """Each candidate's quadratic form in every slot of a union of
    ellipsoids, ``(x - c)^T A (x - c)`` (q, m), for the candidates ``uc``
    (q, n), the centres ``ctrs`` (m, n) and matrices ``ams`` (m, n, n), in
    the ``unif_valid`` kernel's order, one elementwise op at a time (each
    rounds once): ``d_l = x_l - c_l``; ``t_i = A_i0 d_0 + A_i1 d_1 + ...``
    summed left to right; ``sq = d_0 t_0 + d_1 t_1 + ...`` left to
    right."""
    n = uc.shape[1]
    d = uc[:, None, :] - ctrs[None, :, :]
    prod = ams[None] * d[:, :, None, :]
    t = prod[..., 0]
    for j in range(1, n):
        t = t + prod[..., j]
    p = d * t
    sq = p[..., 0]
    for i in range(1, n):
        sq = sq + p[..., i]
    return sq


def friends_union_plain(ftype, idx, offset, ua, ctrs, axes, axes_inv):
    """A wave's candidates and acceptance over a union of ``N`` identical
    balls or cubes (``ftype`` 'balls' or 'cubes') about the centres
    ``ctrs`` (N, n), from its draws: each lane's centre ``idx`` (q,), its
    offset in the unit ball or cube ``offset`` (q, n) and its acceptance
    uniform ``ua`` (q,); ``axes`` and ``axes_inv`` (n, n) map the unit
    ball or cube onto one ball or cube and back.  In the ``unif_valid``
    kernel's order, one elementwise op at a time (each rounds once): the
    candidate ``x_i = c_i + (o_0 A_0i + o_1 A_1i + ...)``, the sum left
    to right; for every centre ``d = c_j - x`` and ``t_i = d_0 B_0i + d_1
    B_1i + ...`` (B the inverse), left to right; its distance, over balls
    the square root of ``t_0 t_0 + t_1 t_1 + ...`` (left to right), over
    cubes the largest ``|t_i|`` (NaN where any is NaN); ``nin``, the
    centres at distance <= 1, at least 1 (the chosen centre holds x);
    and ``ua < 1 / nin``.  Returns ``(x (q, n), accept (q,))``."""
    n = offset.shape[1]
    s = offset[:, :1] * axes[0]
    for l in range(1, n):
        s = s + offset[:, l:l + 1] * axes[l]
    x = ctrs[idx] + s
    d = ctrs[None, :, :] - x[:, None, :]
    t = d[..., :1] * axes_inv[0]
    for l in range(1, n):
        t = t + d[..., l:l + 1] * axes_inv[l]
    if ftype == "balls":
        dist = t[..., 0] * t[..., 0]
        for i in range(1, n):
            dist = dist + t[..., i] * t[..., i]
        dist = torch.sqrt(dist)
    else:
        a = t.abs()
        dist = a[..., 0]
        for i in range(1, n):
            dist = torch.maximum(dist, a[..., i])
    nin = (dist <= 1.0).sum(dim=1).clamp_min(1)
    return x, ua < 1.0 / nin.to(ua.dtype)


def unif_valid_plain(uc, width, strict=None, ctrs=None, ams=None,
                     mask=None, ua=None, accept=None):
    """Which lanes of a wave count as launched, valid proposals: the lane
    is below ``width``, its candidate ``uc`` (q, ncdim) is in the cube
    (loosely where ``strict`` is False), and over a union of ellipsoids
    (``ctrs`` (m, ncdim) and ``ams`` (m, ncdim, ncdim), the candidates'
    quadratic forms :func:`ellipsoid_forms_plain`; ``mask`` (m,) the valid
    slots, ``ua`` (q,) the acceptance uniforms) it lies in ``nin`` > 0 of
    them (the round-off rescue counting ``sq <= 1 + 1e-3`` where no ``sq <
    1``) and passes the 1/nin overlap test; over balls and cubes, where
    ``accept`` (q,) holds (:func:`friends_union_plain`'s).  Returns
    ``valid`` (q,)."""
    lanes = torch.arange(uc.shape[0], device=uc.device)
    valid = (lanes < width) & unitcheck_batch(uc, strict)
    if ams is not None:
        sq = torch.where(mask[None, :], ellipsoid_forms_plain(uc, ctrs, ams),
                         math.inf)
        nin = (sq < 1.0).sum(dim=1)
        nin_loose = (sq <= 1.0 + 1e-3).sum(dim=1)
        nin = torch.where(nin > 0, nin, nin_loose)  # round-off rescue
        valid = valid & (ua < 1.0 / nin.clamp_min(1).to(ua.dtype)) & \
            (nin > 0)
    if accept is not None:
        valid = valid & accept
    return valid


def unif_valid_round_plain(rb, uc, ua=None, idx=None, u_ex=None):
    """What :func:`unif_valid` writes on the round ``rb`` for a wave's
    draws, from the round's state, arrays and mask: ``(valid, u_prop,
    uclamp)``; over balls and cubes ``uc`` holds the offsets and the
    candidates are :func:`friends_union_plain`'s."""
    accept = None
    if rb.friends is not None:
        a = rb.arrays
        uc, accept = friends_union_plain(rb.friends, idx, uc, ua,
                                         *(a[k] for k in UNIF_FRIENDS))
        ua = None
    forms = [rb.arrays[k] if rb.m else None for k in UNIF_FORMS]
    valid = unif_valid_plain(uc, rb.state[U_WIDTH], rb.strict, *forms, ua,
                             accept)
    return (valid,) + unif_input_plain(uc, u_ex)


def unif_input_plain(uc, u_ex=None):
    """The likelihood's input of a wave: the candidates ``uc`` (q, ncdim)
    with the other dimensions' uniforms ``u_ex`` (q, ndim - ncdim; None:
    none), and the same clamped into the cube (torch's clamp: NaN
    passes).  Returns ``(u_prop, uclamp)``."""
    u_prop = uc if u_ex is None else torch.cat([uc, u_ex], dim=1)
    return u_prop, u_prop.clamp(0.0, 1.0)


def unif_place_plain(state, slots, valid, u_prop, v_prop, logl_prop,
                     loglstar):
    """After the likelihood's ``v_prop`` and raw ``logl_prop`` at the
    wave's clamped candidates ``u_prop``: mask ``logl_prop`` to -inf off
    the ``valid`` lanes, place each success (above ``loglstar``) in the
    next free slot of ``slots`` (``u``, ``v``, ``logl``, ``nc``; row
    ``q`` takes what no free slot does), split the evaluations since the
    last successful wave over the slots filled (the remainder to the
    lowest ranks), and advance the round's ``state`` (int64, ``U_FILLED``
    ... ``U_MAX_WAVES``).  Returns ``(state, dest, done)``: the new state,
    each lane's row and whether the round is over."""
    q = valid.shape[0]
    n_filled, waves, nc, n_prop, pending, width, max_waves = state.unbind()
    logl_prop = torch.where(valid, logl_prop, _NEG_INF)
    success = valid & (logl_prop > loglstar)
    n_succ, nc_wave = success.sum(), valid.sum()
    rank = torch.cumsum(success, 0) - 1
    dest = n_filled + rank
    dest = torch.where(success & (dest < q), dest, q)
    slots["u"][dest] = u_prop
    slots["v"][dest] = v_prop
    slots["logl"][dest] = logl_prop
    n_new = torch.minimum(n_succ, q - n_filled)
    # exact per-slot attribution of the evaluations since the last
    # successful wave (remainder to the lowest ranks)
    avail = pending + nc_wave
    div = n_new.clamp_min(1)
    share = avail // div
    rem = avail - share * div
    slots["nc"][dest] = share + (rank < rem).to(torch.int64)
    n_filled = n_filled + n_new
    waves = waves + 1
    n_prop = n_prop + width
    new = torch.stack([n_filled, waves, nc + nc_wave, n_prop,
                       torch.where(n_new > 0, 0, avail),
                       unif_width_plain(q, n_filled, n_prop), max_waves])
    return new, dest, (n_filled >= q) | (waves >= max_waves)


class UnifRound:
    """Every tensor a wave of the uniform rejection round touches and
    that outlives the wave, for one wave shape on one device: the round's
    ``state`` (int64 (7,): ``U_FILLED`` ... ``U_MAX_WAVES``) and ``done``
    flag, its threshold ``loglstar`` (0-d), the output ``slots`` (``u``,
    ``v``, ``logl``, ``nc``, q + 1 rows: row ``q`` takes the successes
    past the last free slot), the bound's ``arrays`` (laid out as
    ``arrays_layout`` says: ``{name: (shape, stride, storage offset,
    dtype)}``, the caller's own layout, so that the draws' products -- the
    union's map through its axes, the friends' offsets -- read the layout
    they read before the buffers existed and sum in the order they
    summed; but a union of ellipsoids' ``UNIF_FORMS``, which the
    ``unif_valid`` kernel reads, contiguous, the centres and matrices in
    the round's dtype, and so every array of a union of balls or cubes,
    ``UNIF_FRIENDS``, where ``friends`` names it: 'balls' or 'cubes'),
    the cube check's ``strict`` mask, and a wave's
    outputs (``valid``; ``u_prop`` and ``uclamp`` (q, ndim), the
    likelihood's input and the same clamped into the cube; ``dest``: each
    lane's row, for the blob's indexed copy).

    Allocated, checked and, on the card, bound to the two kernels'
    argument tables once; :meth:`start` loads a round into it,
    :func:`unif_valid` and :func:`unif_place` run a wave on it.  The buffers keep their
    addresses for the object's life, which is what lets a wave be
    captured as a CUDA graph."""

    def __init__(self, q, ndim, ncdim, npdim, dtype, device, strict=None,
                 arrays_layout=None, friends=None):
        fn = "UnifRound"
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"{fn}: no kernel for device {device}")
        if dtype not in _DTYPES:
            raise TypeError(f"{fn} takes float64 or float32, got {dtype}")
        if min(q, ncdim) < 1 or ncdim > ndim or npdim < 0:
            raise ValueError(f"{fn}: bad shape {(q, ndim, ncdim, npdim)}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.q, self.ndim, self.ncdim, self.npdim = q, ndim, ncdim, npdim
        self.dtype, self.device = dtype, device

        def e(shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        self.state = e((7,), torch.int64)
        # the done flag the host reads and, beside it, the round gate
        self.flags = e((2,), torch.bool)
        self.done, self.gate = self.flags[0], self.flags[1]
        self.loglstar = e(())
        self.valid, self.dest = e((q,), torch.bool), e((q,), torch.int64)
        self.u_prop, self.uclamp = e((q, ndim)), e((q, ndim))
        self.slots = {"u": e((q + 1, ndim)), "v": e((q + 1, npdim)),
                      "logl": e((q + 1,)), "nc": e((q + 1,), torch.int64)}
        layout = arrays_layout or {}
        if friends not in (None, "balls", "cubes"):
            raise ValueError(f"{fn}: no friends kind {friends!r}")
        if friends is not None and set(layout) != set(UNIF_FRIENDS):
            raise ValueError(f"{fn}: {friends} take the arrays "
                             f"{UNIF_FRIENDS}, got {tuple(layout)}")
        self.friends = friends
        own = unif_laid_out(layout, friends)
        self.arrays = {
            k: e(shape, torch.bool if k == "mask" else dtype)
            if k in own else
            _strided_empty(shape, stride, offset, dt, device)
            for k, (shape, stride, offset, dt) in layout.items()}
        self.m = self.arrays["mask"].shape[0] if "mask" in self.arrays \
            else 0
        # the friends' centres
        self.nctrs = self.arrays["ctrs"].shape[0] if friends else 0
        self.strict = None
        if strict is not None:
            if not isinstance(strict, torch.Tensor):
                raise TypeError(f"{fn}: strict must be a torch.Tensor")
            self.strict = _fresh(strict.to(device=device, dtype=torch.bool))
            _check(fn, "strict", self.strict, (ncdim,), torch.bool, device)
        self._valid_args = self._place_args = None
        if device.type == "cuda":
            self._bind()

    def start(self, loglstar, arrays, max_waves, gate=None):
        """Load a round: the state of no wave run (the first wave launches
        every lane), unfilled slots (u 0.5, v 0, logl -inf, nc 0), the
        threshold (a number or a 0-d tensor) and the bound's arrays
        (:meth:`load_arrays`; None: loaded already), copied once a round,
        with device work only.  ``gate`` (a 0-d bool tensor, None: open)
        is the fused round's gate: where it is set the first wave's width
        is 0 (no lane launched, the likelihood counts none), and the
        host's read of ``flags`` after it sees the gate."""
        self.state.zero_()
        if gate is None:
            self.state[U_WIDTH].fill_(self.q)
        else:
            self.state[U_WIDTH].copy_(torch.where(gate, 0, self.q))
        self.state[U_MAX_WAVES].fill_(max_waves)
        self.done.fill_(max_waves < 1)
        _load_gate(self.gate, gate)
        if isinstance(loglstar, torch.Tensor):
            self.loglstar.copy_(loglstar)
        else:
            self.loglstar.fill_(float(loglstar))
        for k, fill in (("u", 0.5), ("v", 0.0), ("logl", _NEG_INF),
                        ("nc", 0)):
            self.slots[k].fill_(fill)
        if arrays is not None:
            self.load_arrays(arrays)

    def load_arrays(self, arrays):
        """Copy the bound's arrays into the round's buffers (the union's
        centres and matrices converted to the round's dtype, as the
        draws' ``.to(dtype)`` converted them)."""
        for k, buf in self.arrays.items():
            buf.copy_(arrays[k])

    def _bind(self):
        """Fill both kernels' argument tables (``unif_valid``'s in the
        order of its kernel's struct: ``ValidArgs``, over balls and cubes
        ``FriendsArgs``); a wave's candidates and draws and the
        likelihood's outputs are written into them at each launch."""
        s, a = self.slots, self.arrays
        outs = (self.strict, self.state, self.valid, self.u_prop,
                self.uclamp)
        tag = _DTYPES[self.dtype]
        if self.friends:
            valid = (None,) * 4 + tuple(a[k] for k in UNIF_FRIENDS) + outs
            self._valid_fn = _entry("unif_wave", f"unif_{self.friends}",
                                    tag)
        else:
            valid = (None,) * 3 + tuple(
                a.get(k) if self.m else None for k in UNIF_FORMS) + outs
            self._valid_fn = _entry("unif_wave", "unif_valid", tag)
        self._valid_ints = (self.q, self.ndim, self.ncdim,
                            self.nctrs if self.friends else self.m)
        place = (self.valid, None, None, None, self.loglstar, self.state,
                 self.done, s["u"], s["v"], s["logl"], s["nc"], self.dest)
        self._valid_args = _pointer_table(valid)
        self._place_args = _pointer_table(place)
        self._place_fn = _entry("unif_wave", "unif_place", tag)

    def check_draws(self, uc, ua, idx, u_ex):
        """Raise unless a wave's candidates and draws are what the kernels
        read: ``uc`` (q, ncdim; over balls and cubes the offsets), over
        ellipsoids, balls and cubes ``ua`` (q,), over balls and cubes
        ``idx`` (q,) int64, each lane's centre (checked to lie in range:
        one device read), and ``u_ex`` (q, ndim - ncdim; None exactly
        where ncdim == ndim), contiguous tensors of the round's dtype on
        its device."""
        q, dt, dev = self.q, self.dtype, self.device
        _check("unif_valid", "uc", uc, (q, self.ncdim), dt, dev)
        if (ua is None) != (self.m == 0 and self.friends is None):
            raise ValueError("unif_valid: ua must be given exactly over a "
                             "union of ellipsoids, balls or cubes")
        if ua is not None:
            _check("unif_valid", "ua", ua, (q,), dt, dev)
        if (idx is None) != (self.friends is None):
            raise ValueError("unif_valid: idx must be given exactly over "
                             "balls and cubes")
        if idx is not None:
            _check("unif_valid", "idx", idx, (q,), torch.int64, dev)
            if not bool(((idx >= 0) & (idx < self.nctrs)).all()):
                raise ValueError(f"unif_valid: a centre index outside [0, "
                                 f"{self.nctrs})")
        if (u_ex is None) != (self.ncdim == self.ndim):
            raise ValueError("unif_valid: u_ex must be given exactly where "
                             "ncdim < ndim")
        if u_ex is not None:
            _check("unif_valid", "u_ex", u_ex, (q, self.ndim - self.ncdim),
                   dt, dev)

    def check_likelihood(self, v_prop, logl_prop):
        """Raise unless the likelihood's outputs are what
        :func:`unif_place` reads: (q, npdim) and (q,) contiguous tensors
        of the round's dtype on its device."""
        for name, t, shape in (("v_prop", v_prop, (self.q, self.npdim)),
                               ("logl_prop", logl_prop, (self.q,))):
            _check("unif_place", name, t, shape, self.dtype, self.device)


def unif_valid(rb, uc, ua=None, idx=None, u_ex=None):
    """A wave's lane checks on the round ``rb`` (a :class:`UnifRound`)
    for the candidates ``uc`` (q, ncdim), with ``ua`` over a union of
    ellipsoids (whose quadratic forms it computes from the round's
    centres and matrices); over balls and cubes for the draws ``uc``
    (the offsets in the unit ball or cube), ``idx`` (each lane's centre)
    and ``ua``, from which it forms the candidates and their overlap test
    (:func:`friends_union_plain`); and the likelihood's input with the
    other dimensions' uniforms ``u_ex``: :func:`unif_valid_round_plain`
    on the CPU, on the card the ``unif_valid`` kernel of
    ``csrc/unif_wave.cu`` (over balls and cubes its friends mode), which
    takes the draws as they are (:meth:`UnifRound.check_draws` holds them
    once a round).  Reads the wave's width from ``rb.state`` and the
    bound's arrays and the cube check's mask from the round; writes
    ``rb.valid``, ``rb.u_prop`` and ``rb.uclamp``."""
    if rb.device.type == "cpu":
        for buf, t in zip((rb.valid, rb.u_prop, rb.uclamp),
                          unif_valid_round_plain(rb, uc, ua, idx, u_ex)):
            buf.copy_(t)
        return
    table = rb._valid_args
    for i, t in enumerate((uc, u_ex, ua, idx)[:4 if rb.friends else 3]):
        table[i] = None if t is None else t.data_ptr()
    _run(rb._valid_fn, table, rb._valid_ints, rb.device, "unif_valid")
    unif_valid.launches += 1


def unif_place(rb, u_prop, v_prop, logl_prop):
    """A wave's placement on the round ``rb`` after the likelihood's
    ``v_prop`` (q, npdim) and raw ``logl_prop`` (q,) at the candidates
    ``u_prop`` (q, ndim; a wave passes ``rb.u_prop``), clamped (in the
    round's dtype):
    :func:`unif_place_plain` on the CPU (the state, rows and flag copied
    into the round's buffers), on the card the ``unif_place`` kernel of
    ``csrc/unif_wave.cu``, one block that masks ``logl_prop`` off
    ``rb.valid``, fills the slots and advances ``rb.state`` in place.
    Writes ``rb.slots``, ``rb.dest``, ``rb.state`` and ``rb.done``."""
    if rb.device.type == "cpu":
        st, dest, done = unif_place_plain(rb.state, rb.slots, rb.valid,
                                          u_prop, v_prop, logl_prop,
                                          rb.loglstar)
        rb.state.copy_(st)
        rb.dest.copy_(dest)
        rb.done.copy_(done)
        return
    table = rb._place_args
    table[1], table[2], table[3] = (u_prop.data_ptr(), v_prop.data_ptr(),
                                    logl_prop.data_ptr())
    _run(rb._place_fn, table, (rb.q, rb.ndim, rb.npdim, 0), rb.device,
         "unif_place")
    unif_place.launches += 1


# --------------------------------------------------------------------------
# the doubling slice round

# doubling_point's modes: the step's left and right end probes; and, which
# only the plain version takes, a doubling's new end, a shrink candidate and
# a halving's mid (the kernel before each of them probes it)
P_START_L, P_START_R, P_DOUBLE, P_SHRINK, P_HALVE = range(5)
# doubling_expand's: the step's start after its end probes, a doubling
X_INIT, X_DOUBLE = 0, 1
# doubling_shrink's: a candidate's outcome, its resolution after the test
S_CANDIDATE, S_RESOLVE = 0, 1

# the doubling round's state by kind: the lanes' points and the step's
# start points, direction, shrink candidate and clamped probe (q, ndim);
# v and the candidate's v (q, npdim); per-lane values (q,): the doubling's
# interval and end values, the shrink's interval, the candidate's
# position and logl, the halving's interval and end values; the round's
# tallies and the doubling's growth (int64); the lanes that double,
# shrink, halve, the candidate above the threshold, the halving's
# divergence and rejection, the lanes that accept, the side of a lane's
# next doubling, the probes' cube checks (a doubling's or a halving's,
# the left end probe's, a shrink candidate's); the step index; and the
# two flags the host reads: ``any`` (does a lane double on / run a
# halving) and ``any_shrink``
_D_ROWS = ("u", "u0", "dir", "u_c", "uclamp")
_D_VROWS = ("v", "v_c")
_D_LANES = ("logl", "left", "right", "fl", "fr", "sl", "sr", "x1", "logl_c",
            "lhat", "rhat", "f_lhat", "f_rhat")
_D_COUNTS = ("nc", "n_exp", "n_con", "grow", "d_nc")
_D_MASKS = ("active", "s_active", "good", "h_active", "dflag", "reject",
            "newly", "go_left", "incube", "incube_l", "incube_s")


def _doubling_state(q, ndim, npdim, dtype, device):
    """The doubling round's state tensors for ``q`` lanes, unfilled."""
    def e(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    st = {k: e((q, ndim)) for k in _D_ROWS}
    st.update({k: e((q, npdim)) for k in _D_VROWS})
    st.update({k: e((q,)) for k in _D_LANES})
    st.update({k: e((q,), torch.int64) for k in _D_COUNTS})
    st.update({k: e((q,), torch.bool) for k in _D_MASKS})
    st.update({"step": e((1,), torch.int64), "any": e((), torch.bool),
               "any_shrink": e((), torch.bool)})
    return st


def doubling_point_plain(st, mode, draw, directions, strict=None,
                         gate=None):
    """The position of each lane's next likelihood call by ``mode``, and
    the point there: ``P_START_L`` takes the step's direction (row
    ``st['step']``, at most the last, of ``directions`` (q, n_steps,
    ndim), capped) and start points, and its interval ``(-r0, 1 - r0)``
    from ``draw`` (r0), and probes its left end; ``P_START_R`` its right
    end; ``P_DOUBLE`` doubles the active lanes' intervals to the side
    ``draw < 0.5`` picks (left, kept as ``go_left``) and probes the new
    end of that side; ``P_SHRINK`` the shrink candidate ``sl + draw * (sr
    - sl)`` (kept as ``x1``, its point as ``u_c``); ``P_HALVE`` the
    halving's mid ``0.5 * (lhat + rhat)``.  Sets ``uclamp``, the point
    ``u0 + x * dir`` clamped into the cube, and its cube check (loosely
    where ``strict`` is False) with the mode's lane mask (``incube_l`` for
    the left end probe; behind a set round ``gate``, a 0-d bool tensor,
    the end probes count no lane).  The wrapper takes the end probes
    only: the kernel before each other probe writes it, and its plain
    version composes this one in."""
    if mode == P_START_L:
        step = st["step"].clamp(max=directions.shape[1] - 1)
        st["dir"] = directions.index_select(1, step)[:, 0]
        st["u0"] = st["u"].clone()
        st["left"], st["right"] = -draw, 1.0 - draw
        x, mask = st["left"], None
    elif mode == P_START_R:
        x, mask = st["right"], None
    elif mode == P_DOUBLE:
        mask, left, right = st["active"], st["left"], st["right"]
        go_left = draw < 0.5
        width = right - left
        left = torch.where(mask & go_left, left - width, left)
        right = torch.where(mask & ~go_left, right + width, right)
        x = torch.where(go_left, left, right)
        st["go_left"] = go_left
    elif mode == P_SHRINK:
        x, mask = st["sl"] + draw * (st["sr"] - st["sl"]), st["s_active"]
        st["x1"] = x
    else:
        x, mask = 0.5 * (st["lhat"] + st["rhat"]), st["h_active"]
    u = st["u0"] + x[:, None] * st["dir"]
    incube = unitcheck_batch(u, strict)
    if mask is not None:
        incube = incube & mask
    if gate is not None and mode in (P_START_L, P_START_R):
        incube = incube & ~gate
    if mode == P_SHRINK:
        st["u_c"] = u
    st["incube_l" if mode == P_START_L else "incube"] = incube
    st["uclamp"] = u.clamp(0.0, 1.0)


def _shrink_probe(st, draw, strict):
    """The next shrink candidate's probe from ``draw``, as
    :func:`doubling_point_plain` in mode ``P_SHRINK`` makes it (its
    position ``x1``, its point ``u_c``, the point clamped into ``uclamp``,
    its cube check with ``s_active`` in ``incube``), on a copy of the
    state dict, which it returns."""
    shr = dict(st)
    doubling_point_plain(shr, P_SHRINK, draw, None, strict)
    return shr


def doubling_expand_plain(st, mode, logl_x, logl_l, draw, draw_x, loglstar,
                          strict=None):
    """After the likelihood's raw ``logl_x`` (q,) at the step's probe
    (each probe's logl masked to -inf outside its cube check ``incube``):
    ``X_INIT`` (after both end probes, ``logl_l`` the left one's, masked
    by ``incube_l``) starts the step: its end values, two evaluations a
    lane, ``grow`` 1, the lanes with an end above ``loglstar`` active,
    every lane shrinking, the next step's index; ``X_DOUBLE`` applies a
    doubling: the active lanes' interval doubled to the side ``go_left``
    kept, that end's value, one evaluation and ``grow`` expansions a lane,
    the growth doubled (clamped at 2^30), the lanes with an end still
    above ``loglstar`` active.  The shrink's interval follows the
    doubling's; ``any`` says whether a lane is active.

    Then each lane's next probe (the cube check loose where ``strict`` is
    False): a lane still active takes the next doubling's
    (:func:`doubling_point_plain` in mode ``P_DOUBLE``, from ``draw``:
    ``go_left``, ``uclamp``, its cube check in ``incube``), a lane that
    stopped the first shrink candidate's (:func:`_shrink_probe`, from
    ``draw_x``: ``x1``, ``u_c``, ``uclamp``, its cube check with
    ``s_active`` in ``incube_s``); ``incube`` is false on the one kind and
    ``incube_s`` on the other, and each lane keeps the other kind's
    entries."""
    logl_new = torch.where(st["incube"], logl_x, _NEG_INF)
    if mode == X_INIT:
        fl = torch.where(st["incube_l"], logl_l, _NEG_INF)
        fr = logl_new
        st["nc"] = st["nc"] + 2
        st["grow"] = torch.ones_like(st["grow"])
        active = (fl > loglstar) | (fr > loglstar)
        st["s_active"] = torch.ones_like(st["s_active"])
        st["step"] = st["step"] + 1
    else:
        active, left, right = st["active"], st["left"], st["right"]
        go_left = st["go_left"]
        width = right - left
        st["left"] = torch.where(active & go_left, left - width, left)
        st["right"] = torch.where(active & ~go_left, right + width, right)
        fl = torch.where(active & go_left, logl_new, st["fl"])
        fr = torch.where(active & ~go_left, logl_new, st["fr"])
        grow = st["grow"]
        st["nc"] = st["nc"] + active
        st["n_exp"] = st["n_exp"] + active * grow
        st["grow"] = torch.where(active, (grow * 2).clamp(max=1 << 30), grow)
        active = active & ((fl > loglstar) | (fr > loglstar))
    st["fl"], st["fr"], st["active"] = fl, fr, active
    st["sl"], st["sr"] = st["left"].clone(), st["right"].clone()
    st["any"] = active.any()
    dbl = dict(st)
    doubling_point_plain(dbl, P_DOUBLE, draw, None, strict)
    shr = _shrink_probe(st, draw_x, strict)
    st["go_left"] = torch.where(active, dbl["go_left"], st["go_left"])
    st["x1"] = torch.where(active, st["x1"], shr["x1"])
    st["u_c"] = torch.where(active[:, None], st["u_c"], shr["u_c"])
    st["uclamp"] = torch.where(active[:, None], dbl["uclamp"],
                               shr["uclamp"])
    st["incube"], st["incube_s"] = dbl["incube"], shr["incube"] & ~active


def doubling_halve_plain(st, logl_x, loglstar, strict=None):
    """One halving of Neal's (2003) acceptance test (algorithm 6) after
    the likelihood's raw ``logl_x`` at the mid of each lane's
    ``(lhat, rhat)``: the divergence flag (the mid between 0 and the
    candidate ``x1``), the side toward ``x1`` moved to the mid with its
    value, one evaluation a testing lane (``d_nc``), the lanes rejected
    (both ends at or below ``loglstar`` after a divergence), and the lanes
    whose interval is still wider than 1.1 testing on; ``any`` says
    whether a lane tests on.  Then the next halving's probe
    (:func:`doubling_point_plain` in mode ``P_HALVE``: its mid, the point
    clamped into the cube, its cube check, loose where ``strict`` is
    False, with the lanes that halve on)."""
    x1, lhat, rhat = st["x1"], st["lhat"], st["rhat"]
    active = st["h_active"]
    mid = 0.5 * (lhat + rhat)
    dflag = st["dflag"] | (((0.0 < mid) & (mid <= x1)) |
                           ((x1 < mid) & (mid <= 0.0)))
    go_right = x1 < mid  # shrink the right side toward x1
    logl_mid = torch.where(st["incube"], logl_x, _NEG_INF)
    st["d_nc"] = st["d_nc"] + active
    f_rhat = torch.where(active & go_right, logl_mid, st["f_rhat"])
    rhat = torch.where(active & go_right, mid, rhat)
    f_lhat = torch.where(active & ~go_right, logl_mid, st["f_lhat"])
    lhat = torch.where(active & ~go_right, mid, lhat)
    newly = active & dflag & (loglstar >= f_lhat) & (loglstar >= f_rhat)
    st["reject"] = st["reject"] | newly
    active = active & ~newly & ((rhat - lhat) > 1.1)
    st.update(dflag=dflag, lhat=lhat, rhat=rhat, f_lhat=f_lhat,
              f_rhat=f_rhat, h_active=active, any=active.any())
    doubling_point_plain(st, P_HALVE, None, None, strict)


def doubling_shrink_plain(st, mode, v_x, logl_x, loglstar, strict=None,
                          draw=None):
    """``S_CANDIDATE``, after the likelihood's ``v_x`` and raw ``logl_x``
    at the shrink candidate (masked by its cube check ``incube_s``): its
    v and masked logl kept (``v_c``, ``logl_c``), one evaluation and one
    contraction a shrinking lane, ``good`` where it is above ``loglstar``,
    and the acceptance test started on the doubling's interval for the
    shrinking lanes that are good and whose interval is wider than 1.1
    (``any`` says whether one is); ``any_shrink`` cleared; then the first
    halving's probe (:func:`doubling_point_plain` in mode ``P_HALVE``;
    ``v_x`` may be the probe's buffer, so it is copied first).
    ``S_RESOLVE``, after the test: its
    evaluations billed to the good lanes, the lanes that pass take the
    candidate (``newly``), the others shrink their interval to it and
    shrink on (``any_shrink`` says whether one does); then the next
    candidate's probe from ``draw`` (:func:`_shrink_probe`, on every
    lane; its cube check with the lanes that shrink on in
    ``incube_s``)."""
    active = st["s_active"]
    if mode == S_CANDIDATE:
        logl_c = torch.where(st["incube_s"], logl_x, _NEG_INF)
        good = logl_c > loglstar
        st["v_c"], st["logl_c"], st["good"] = v_x.clone(), logl_c, good
        st["nc"] = st["nc"] + active
        st["n_con"] = st["n_con"] + active
        st["h_active"] = ((st["right"] - st["left"]) > 1.1) & (active & good)
        for k, src in (("lhat", "left"), ("rhat", "right"),
                       ("f_lhat", "fl"), ("f_rhat", "fr")):
            st[k] = st[src].clone()
        for k in ("dflag", "reject", "d_nc"):
            st[k] = torch.zeros_like(st[k])
        st["any"] = st["h_active"].any()
        st["any_shrink"] = torch.zeros_like(st["any_shrink"])
        doubling_point_plain(st, P_HALVE, None, None, strict)
        return
    good = st["good"]
    st["nc"] = st["nc"] + torch.where(active & good, st["d_nc"], 0)
    good = good & ~st["reject"]
    newly = active & good
    st["u"] = torch.where(newly[:, None], st["u_c"], st["u"])
    st["v"] = torch.where(newly[:, None], st["v_c"], st["v"])
    st["logl"] = torch.where(newly, st["logl_c"], st["logl"])
    bad = active & ~good
    x1 = st["x1"]
    st["sl"] = torch.where(bad & (x1 < 0), x1, st["sl"])
    st["sr"] = torch.where(bad & (x1 > 0), x1, st["sr"])
    st.update(s_active=bad, newly=newly, any_shrink=bad.any())
    shr = _shrink_probe(st, draw, strict)
    st.update(x1=shr["x1"], u_c=shr["u_c"], uclamp=shr["uclamp"],
              incube_s=shr["incube"])


class DoublingRound:
    """Every tensor the doubling slice round touches, for one round shape
    ``(q, n_steps, ndim, npdim, dtype)`` on one device: the state (``st``,
    as ``_doubling_state`` lays it out), the round's inputs
    (``directions`` (q, n_steps, ndim), capped; ``loglstar`` 0-d; the
    cube check's ``strict`` mask) and a segment's draws (``draw`` (q,):
    the step's r0, a doubling's side, a shrink candidate's position; and
    ``draw_x``, the first shrink candidate's position where it is not the
    vector ``draw`` holds, as in the tests, which feed the JAX package's
    draws).

    Allocated, checked and, on the card, bound to the four kernels'
    argument tables once; :meth:`start` loads a round into it,
    :func:`doubling_point`, :func:`doubling_expand`,
    :func:`doubling_halve` and :func:`doubling_shrink` run it.  The
    buffers keep their addresses for the object's life, which is what
    lets each segment of the round be captured as a CUDA graph."""

    def __init__(self, q, n_steps, ndim, npdim, dtype, device, strict=None):
        fn = "DoublingRound"
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
        self.st = _doubling_state(q, ndim, npdim, dtype, device)
        # the flag the host reads and, beside it, the round gate
        self.flags = torch.empty((2,), dtype=torch.bool, device=device)
        self.st["any"], self.gate = self.flags[0], self.flags[1]
        self.directions = torch.empty((q, n_steps, ndim), dtype=dtype,
                                      device=device)
        self.loglstar = torch.empty((), dtype=dtype, device=device)
        self.draw = torch.empty((q,), dtype=dtype, device=device)
        self.draw_x = torch.empty((q,), dtype=dtype, device=device)
        # doubling_expand's count of blocks and their votes, zero between
        # its launches (the kernel's last block zeroes it)
        self.vote = torch.zeros((1,), dtype=torch.int64, device=device)
        self.strict = None
        if strict is not None:
            if not isinstance(strict, torch.Tensor):
                raise TypeError(f"{fn}: strict must be a torch.Tensor")
            self.strict = _fresh(strict.to(device=device, dtype=torch.bool))
            _check(fn, "strict", self.strict, (ndim,), torch.bool, device)
        self._args = None
        if device.type == "cuda":
            self._bind()

    def start(self, start_u, start_v, start_logl, directions, loglstar,
              gate=None):
        """Load a round: the start points, zero tallies, the first step,
        the capped ``directions`` and the threshold (a number or a 0-d
        tensor, copied once a round); returns the state.  ``gate`` (a 0-d
        bool tensor, None: open) is the fused round's gate: where it is set
        the step's end probes count no lane (``internal/kernels.py``,
        ``DoublingGraph.segment``), so no lane doubles, and the host's read
        of ``flags`` after them sees the gate."""
        st = self.st
        _load_gate(self.gate, gate)
        for k, t in (("u", start_u), ("v", start_v), ("logl", start_logl)):
            st[k].copy_(t)
        for k in ("nc", "n_exp", "n_con", "step"):
            st[k].zero_()
        self.directions.copy_(directions)
        if isinstance(loglstar, torch.Tensor):
            self.loglstar.copy_(loglstar)
        else:
            self.loglstar.fill_(float(loglstar))
        return st

    def _bind(self):
        """Fill the four kernels' argument tables; the likelihood's outputs
        (and ``doubling_expand``'s candidate draw) are written into them
        at each launch."""
        st = self.st
        point = (st["step"], self.directions, st["dir"], st["u"], st["u0"],
                 self.draw, st["left"], st["right"], self.gate, self.strict,
                 st["uclamp"], st["incube"], st["incube_l"])
        # the next probe: the step's rows, the clamped point (and a shrink
        # candidate's point and position)
        probe = (st["u0"], st["dir"], self.strict, st["uclamp"])
        expand = (st["incube_l"], st["incube"], None, None, self.draw, None,
                  self.loglstar, st["left"], st["right"], st["fl"],
                  st["fr"], st["sl"], st["sr"], st["active"],
                  st["s_active"], st["go_left"], st["grow"], st["nc"],
                  st["n_exp"], st["step"]) + probe + (
                      st["u_c"], st["x1"], st["incube_s"], st["any"],
                      self.vote)
        halve = (st["incube"], None, self.loglstar, st["x1"], st["lhat"],
                 st["rhat"], st["f_lhat"], st["f_rhat"], st["dflag"],
                 st["reject"], st["h_active"], st["d_nc"], st["any"]) + probe
        shrink = (st["incube_s"], None, None, self.loglstar, st["s_active"],
                  st["good"], st["left"], st["right"], st["fl"], st["fr"],
                  st["lhat"], st["rhat"], st["f_lhat"], st["f_rhat"],
                  st["dflag"], st["reject"], st["h_active"], st["d_nc"],
                  st["v_c"], st["logl_c"], st["nc"], st["n_con"], st["u"],
                  st["v"], st["logl"], st["u_c"], st["x1"], st["sl"],
                  st["sr"], st["newly"], st["any"], st["any_shrink"]) + \
            probe + (st["incube"], self.draw)
        tag = _DTYPES[self.dtype]
        self._args = {name: (_pointer_table(t), _entry("slice_doubling",
                                                       f"doubling_{name}",
                                                       tag))
                      for name, t in (("point", point), ("expand", expand),
                                      ("halve", halve), ("shrink", shrink))}

    def check_likelihood(self, v_x, logl_x):
        """Raise unless the likelihood's outputs are what the kernels read:
        (q, npdim) and (q,) contiguous tensors of the round's dtype on its
        device."""
        for name, t, shape in (("v_x", v_x, (self.q, self.npdim)),
                               ("logl_x", logl_x, (self.q,))):
            _check("doubling_round", name, t, shape, self.dtype,
                   self.device)

    def _plain(self, fn, *args):
        """``fn`` on a copy of the state dict, the entries it rebinds
        copied back into the round's buffers."""
        st = dict(self.st)
        fn(st, *args)
        for k, buf in self.st.items():
            if st[k] is not buf:
                buf.copy_(st[k])


def doubling_point(rb, mode):
    """The step's end probes (``P_START_L``, ``P_START_R``) on the round
    ``rb`` (a :class:`DoublingRound`): :func:`doubling_point_plain` on the
    CPU, on the card the ``doubling_point`` kernel of
    ``csrc/slice_doubling.cu``.  Reads ``rb.draw`` (r0, ``P_START_L``),
    ``rb.directions`` and the round gate ``rb.gate``; writes ``uclamp``
    and ``incube`` (``incube_l``) of ``rb.st``.  Every other probe is
    refused: the kernel before it writes it (:func:`doubling_expand`,
    :func:`doubling_shrink`, :func:`doubling_halve`)."""
    if mode not in (P_START_L, P_START_R):
        raise ValueError(f"doubling_point: no mode {mode}; a doubling's, a "
                         f"shrink candidate's and a halving's probe is "
                         f"written by the kernel before it")
    if rb.device.type == "cpu":
        rb._plain(doubling_point_plain, mode, rb.draw, rb.directions,
                  rb.strict, rb.gate)
        return
    table, f = rb._args["point"]
    _run(f, table, (rb.q, rb.ndim, rb.n_steps, mode), rb.device,
         "doubling_point")
    doubling_point.launches += 1


def doubling_expand(rb, mode, logl_x, logl_l=None, draw_x=None):
    """The step's start (``X_INIT``, after both end probes: ``logl_l``
    the left one's raw values) or one doubling (``X_DOUBLE``) on the round
    ``rb`` after the likelihood's raw ``logl_x`` (q,) in the round's dtype,
    with each lane's next probe from the vector just drawn into
    ``rb.draw`` (the next doubling's side) and ``draw_x`` (the first
    candidate's position; None: ``rb.draw``, the one vector a generator
    drew): :func:`doubling_expand_plain` on the CPU, on the card the
    ``doubling_expand`` kernel of ``csrc/slice_doubling.cu``, which masks
    the values outside their probes' cube checks, updates the state in
    place and writes the ``any`` flag."""
    draw_x = rb.draw if draw_x is None else draw_x
    if rb.device.type == "cpu":
        rb._plain(doubling_expand_plain, mode, logl_x, logl_l, rb.draw,
                  draw_x, rb.loglstar, rb.strict)
        return
    table, f = rb._args["expand"]
    table[2] = None if logl_l is None else logl_l.data_ptr()
    table[3] = logl_x.data_ptr()
    table[5] = draw_x.data_ptr()
    _run(f, table, (rb.q, rb.ndim, mode, 0), rb.device, "doubling_expand")
    doubling_expand.launches += 1


def doubling_halve(rb, logl_x):
    """One halving of the acceptance test on the round ``rb`` after the
    likelihood's raw ``logl_x`` (q,) at the mids, and the next halving's
    probe: :func:`doubling_halve_plain` on the CPU, on the card the
    ``doubling_halve`` kernel of ``csrc/slice_doubling.cu`` (one block,
    which also writes the ``any`` flag)."""
    if rb.device.type == "cpu":
        rb._plain(doubling_halve_plain, logl_x, rb.loglstar, rb.strict)
        return
    table, f = rb._args["halve"]
    table[1] = logl_x.data_ptr()
    _run(f, table, (rb.q, rb.ndim, 0, 0), rb.device, "doubling_halve")
    doubling_halve.launches += 1


def doubling_shrink(rb, mode, v_x=None, logl_x=None):
    """A shrink candidate's outcome (``S_CANDIDATE``, after the
    likelihood's ``v_x`` (q, npdim) and raw ``logl_x`` (q,) at it, in the
    round's dtype; ``v_x`` may be ``rb.st['uclamp']`` itself, as an
    identity prior transform returns it), with the first halving's probe,
    or its resolution after the acceptance test (``S_RESOLVE``), with the
    next candidate's probe from the vector just drawn into ``rb.draw``, on
    the round ``rb``: :func:`doubling_shrink_plain` on the CPU, on the
    card the ``doubling_shrink`` kernel of ``csrc/slice_doubling.cu``."""
    if rb.device.type == "cpu":
        rb._plain(doubling_shrink_plain, mode, v_x, logl_x, rb.loglstar,
                  rb.strict, rb.draw)
        return
    table, f = rb._args["shrink"]
    if mode == S_CANDIDATE:
        table[1], table[2] = v_x.data_ptr(), logl_x.data_ptr()
    _run(f, table, (rb.q, rb.ndim, rb.npdim, mode), rb.device,
         "doubling_shrink")
    doubling_shrink.launches += 1


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


WRAPPERS = (slice_propose, slice_advance, rwalk_propose, rwalk_accept,
            unif_valid, unif_place, doubling_point, doubling_expand,
            doubling_halve, doubling_shrink)


def zero_counts():
    """Zero every wrapper's ``launches``."""
    for w in WRAPPERS:
        w.launches = 0


zero_counts()
