"""Batched proposal rounds on the sampler's device (the counterpart of
``dynesty_tpu.internal.kernels``).

One round draws ``q`` independent constrained proposals at a fixed
likelihood threshold ``loglstar``:

* ``make_unif_round`` — rejection waves drawn uniformly from the unit
  cube, a union of ellipsoids (``make_ellipsoid_refit`` re-fits the stack
  to the live points before each chained round), a union of
  balls/cubes, or a user's bound drawn on the host between waves
  (``host_sampler``), successes compacted into output slots;
* ``make_rwalk_round`` — ``walks`` fixed random-walk steps per lane inside
  the lane's scaled ellipsoid (no data-dependent loop, so no host read);
* ``make_slice_round`` — slice sampling along random axes-transformed
  directions (``kind='rslice'``) or along the principal axes in a per-lane
  shuffled order (``kind='slice'``): the per-lane state machine in
  stepping-out mode, the barrier form with Neal's (2003) doubling
  procedure when ``doubling`` is set.

Every round carries the proposals' blobs beside ``packed`` (a tensor, or
a tuple, list or dict of them, leading axis over lanes; ``None`` without
blobs) and passes each likelihood call the mask of the lanes it counts,
so that a host-mode likelihood sees exactly those.

JAX's ``lax.while_loop`` over ``jnp.any(active)`` becomes a Python loop
that reads its condition from the device once per iteration; each read is
counted in the sampler's ``Timings`` (``sync_wave``, ``sync_slice``).  The
uniform wave's, the slice state machine's, the doubling round's and the
random walk's updates around each likelihood call are the kernels of
``ops/proposals.py`` on the card.  With a likelihood on the card the
uniform wave, the state machine's iteration, each segment of the doubling
round between two host reads and the random walk's whole walk are
captured once per round shape as CUDA graphs and replayed
(:class:`UnifGraph`, :class:`SliceGraph`, :class:`DoublingGraph`,
:class:`RWalkGraph`), as the JAX package traces its loop bodies once.
Random numbers come from one explicit ``torch.Generator`` per round, drawn
in a fixed order and in the kernel's dtype, so a seed reproduces the round.
"""

import math
import warnings

import numpy as np
import torch

from ..ops.ellipsoid_refit import (REFIT_FIELDS, EllipsoidRefit,
                                   ellipsoid_refit, ellipsoid_refit_plain)
from ..ops.geometry import randsphere_batch
from ..ops.proposals import (P_START_L, P_START_R, S_CANDIDATE, S_RESOLVE,
                             UNIF_ARRAYS, UNIF_FORMS,
                             U_FILLED, U_NC, U_PENDING, U_PROP, X_DOUBLE,
                             X_INIT, DoublingRound, RWalkRound, SliceRound,
                             UnifRound, doubling_expand, doubling_halve,
                             doubling_point, doubling_shrink, rwalk_accept,
                             rwalk_propose, slice_advance, slice_propose,
                             unif_place, unif_valid)
from ..utils.misc import release_default_generator, tree_map

__all__ = ["f32_precision", "pack_columns", "make_unif_round",
           "UnifRoundFn", "UnifGraph", "unif_graph", "unif_waves",
           "unif_start", "unif_loop", "make_ellipsoid_refit",
           "make_rwalk_round", "RWalkRoundFn", "rwalk_walk", "rwalk_start",
           "rwalk_loop", "rwalk_result", "RWalkGraph", "rwalk_graph",
           "make_slice_round", "SliceRoundFn", "slice_state_machine",
           "slice_start", "slice_loop", "SliceGraph", "slice_graph",
           "slice_directions", "DoublingGraph", "doubling_graph",
           "doubling_round", "doubling_start", "doubling_loop",
           "doubling_accept", "pad_ellipsoids"]

_NEG_INF = -math.inf


def f32_precision():
    """Switch TF32 off for float32 matrix products and convolutions, and
    check that it is off.  A likelihood must give the same value at every
    call site (a point accepted against a threshold in one kernel must not
    re-evaluate below it in another), which reduced-precision products
    break."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("could not disable TF32 matmul precision")


def _count(timings, key, n=1):
    if timings is not None:
        timings.count(key, n)


def _bool_mask(mask, device):
    """A bool vector (or None) as a device tensor."""
    if mask is None:
        return None
    return torch.as_tensor(np.asarray(mask, dtype=bool), device=device)


def _mask_from_indices(indices, ndim, device=None):
    """Bool mask (ndim,) that is True at ``indices``; None for None."""
    if indices is None:
        return None
    mask = np.zeros(ndim, dtype=bool)
    mask[np.asarray(indices)] = True
    return torch.as_tensor(mask, device=device)


def _device_of(device):
    """``device`` with its index (the current card's where none is
    given), as a tensor on it reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _masked_eval(like, u, incube):
    """Evaluate the batched likelihood at ``u`` clamped into the cube,
    counting the lanes of ``incube``, and mask the others to -inf.
    Returns ``(v, logl, blob)``."""
    v, logl, blob = like.batch_eval(u.clamp(0.0, 1.0), mask=incube)
    logl = torch.where(incube, logl, _NEG_INF).to(u.dtype)
    return v.to(u.dtype), logl, blob


def pack_columns(q, dtype, *cols, device=None):
    """Pack per-lane outputs into one (q, W) tensor; scalars (Python
    numbers or 0-d tensors) are broadcast to length-q columns."""
    parts = []
    for c in cols:
        c = torch.as_tensor(c, device=device).to(dtype)
        if c.dim() == 0:
            c = c.expand(q)
        if c.dim() == 1:
            c = c[:, None]
        parts.append(c)
    return torch.cat(parts, dim=1)


def pad_ellipsoids(ctrs, axes, ams, logvols, min_pad=1):
    """Pad stacked ellipsoid arrays (numpy) to a power-of-two count with a
    validity mask."""
    m = len(logvols)
    mpad = max(min_pad, 1 << (m - 1).bit_length())
    ndim = ctrs.shape[1]

    def pad(arr, fill=0.0):
        out = np.full((mpad,) + arr.shape[1:], fill, dtype=np.float64)
        out[:m] = arr
        return out

    ams_pad = pad(ams)
    ams_pad[m:] = np.eye(ndim)
    return {"ctrs": pad(ctrs), "axes": pad(axes), "ams": ams_pad,
            "logvols": pad(logvols, fill=-np.inf),
            "mask": np.arange(mpad) < m}


# ==========================================================================
# bound sampling (device side)


def _sample_ellipsoid_union(gen, arrays, q, ncdim, dtype):
    """Draw ``q`` candidates from a union of ellipsoids: volume-weighted
    ellipsoid choice, a ball sample mapped through its axes, and the
    uniforms the 1/q overlap rejection reads.  Random numbers come from
    ``gen`` in a fixed order: choice, ball, acceptance.  Returns (points
    (q, ncdim), the acceptance uniforms (q,));
    :func:`~dynesty_tpu_torch.ops.proposals.unif_valid` computes each
    point's quadratic form in every slot, counts the slots that hold it
    and applies the test."""
    ctrs = arrays["ctrs"].to(dtype)
    axes = arrays["axes"].to(dtype)
    mask = arrays["mask"]
    device = ctrs.device
    # masked slots get weight exp(-inf) = 0
    logp = torch.where(mask, arrays["logvols"].to(dtype), _NEG_INF)
    idx = torch.multinomial(torch.exp(logp - logp.max()), q,
                            replacement=True, generator=gen)
    ball = randsphere_batch(gen, (q,), ncdim, dtype, device)
    x = ctrs[idx] + torch.einsum("qij,qj->qi", axes[idx], ball)
    ua = torch.rand((q,), generator=gen, dtype=dtype, device=device)
    return x, ua


def _sample_friends_union(gen, arrays, q, ncdim, dtype, ftype):
    """Draw ``q`` candidates from a union of identical balls/cubes centred
    at ``arrays['ctrs']`` (the live points of the last refit), with 1/q
    overlap rejection.  Random numbers from ``gen`` in a fixed order:
    centre, offset, acceptance."""
    ctrs = arrays["ctrs"].to(dtype)
    axes = arrays["axes"].to(dtype)
    axes_inv = arrays["axes_inv"].to(dtype)
    device = ctrs.device
    idx = torch.randint(0, ctrs.shape[0], (q,), generator=gen,
                        device=device)
    if ftype == "balls":
        offset = randsphere_batch(gen, (q,), ncdim, dtype, device)
    else:
        offset = torch.rand((q, ncdim), generator=gen, dtype=dtype,
                            device=device) * 2.0 - 1.0
    x = ctrs[idx] + offset @ axes  # axes is symmetric (sqrtm)

    dt = torch.einsum("qmi,ij->qmj", ctrs[None, :, :] - x[:, None, :],
                      axes_inv)
    if ftype == "balls":
        dist = torch.linalg.vector_norm(dt, dim=-1)
    else:
        dist = dt.abs().amax(dim=-1)
    nin = (dist <= 1.0).sum(dim=1).clamp_min(1)  # the chosen centre holds x
    accept = torch.rand((q,), generator=gen, dtype=dtype, device=device) < \
        1.0 / nin.to(dtype)
    return x, accept


def make_ellipsoid_refit(ncdim, dtype=torch.float64):
    """One-step refit of a padded ellipsoid stack from the current live
    points, so that chained uniform rounds sample from a fresh bound (the
    host's BIC resplit and bootstrap still run between dispatches).

    Each live point joins its nearest ellipsoid (Mahalanobis under the
    previous fit); each slot takes its members' mean and MLE covariance,
    inflated so the worst member sits at distance ``1 - 1e-3``, then
    scaled by ``arrays['expand']`` (the host's bootstrap x enlarge linear
    factor).  A slot with fewer than ``ncdim + 1`` members, or whose
    Cholesky factorization fails, keeps its previous fit.

    Returns ``refit(u_live, arrays) -> arrays`` (the same padded schema):
    on the CPU :func:`~dynesty_tpu_torch.ops.ellipsoid_refit.
    ellipsoid_refit_plain`, on the card the two kernels of
    ``csrc/ellipsoid_refit.cu`` into new tensors.  A fused round runs the
    refit inside its prologue instead, into the wave's buffers
    (``_UnifProposer.begin``)."""

    def refit(u, arrays):
        if u.device.type != "cuda":
            return ellipsoid_refit_plain(u, arrays, ncdim, dtype)
        arrays = {k: (v if v.dtype == torch.bool else v.to(dtype))
                  .contiguous() for k, v in arrays.items()
                  if k in REFIT_FIELDS + ("expand",)}
        u = u.to(dtype).contiguous()
        rf = EllipsoidRefit(u.shape[0], arrays["ctrs"].shape[0], ncdim,
                            dtype, u.device)
        out = {k: torch.empty_like(arrays[k]) for k in REFIT_FIELDS}
        ellipsoid_refit(rf, u, arrays, out)
        return out

    return refit


# ==========================================================================
# uniform-in-bound kernel


def make_unif_round(like, *, ndim, q, bound_kind, dtype, device,
                    ncdim=None, nonbounded=None, max_waves=100000,
                    timings=None, host_sampler=None, rounds=None):
    """Uniform rejection sampling from the unit cube (``bound_kind``
    'cube'), a union of ellipsoids ('ellipsoids'), a union of
    balls/cubes ('balls'/'cubes'), or a user's bound ('custom'), whose
    ``host_sampler()`` gives each wave's ``(q, ncdim)`` points as a host
    array: a plain call between waves, every lane a draw.

    Returns a :class:`UnifRoundFn`, called as ``fn(gen, loglstar, arrays)
    -> (packed (q, ndim + npdim + 5), blob)`` with columns ``u | v | logl
    | nc | nc_total | n_proposals | n_filled``: per-slot ``nc`` splits the
    round's evaluations exactly (its sum is ``nc_total``); unfilled slots
    carry logl = -inf.  ``arrays`` is the bound's device dict (ignored for
    the cube).  The bound lives in the first ``ncdim`` dimensions (checked
    against the cube there, loosely where ``nonbounded`` is False); the
    other ``ndim - ncdim`` are drawn uniformly.  Each wave runs through
    the kernels of ``ops/proposals.py`` (:func:`unif_waves`); ``timings``
    and ``rounds`` are the sampler's (:func:`unif_graph`)."""
    if bound_kind not in UNIF_ARRAYS:
        raise ValueError(f"unknown bound kind '{bound_kind}'")
    if bound_kind == "custom" and host_sampler is None:
        raise ValueError("a custom bound needs a host_sampler")
    return UnifRoundFn(like, ndim, ncdim or ndim, q, bound_kind, dtype,
                       device, nonbounded, max_waves, timings, host_sampler,
                       rounds)


class UnifRoundFn:
    """The uniform round of :func:`make_unif_round` in the parts a fused
    round runs apart: :meth:`prepare` (the wave shape's buffers and the
    bound's arrays, on the host's command), :meth:`begin` (the round's
    start, device work only: a fused round's prologue captures it),
    :meth:`loop` (the waves, one host read each) and :meth:`finish` (the
    packed result, device work only: the epilogue captures it).  Calling
    it runs all four with the gate open."""

    def __init__(self, like, ndim, ncdim, q, bound_kind, dtype, device,
                 nonbounded, max_waves, timings, host_sampler, rounds):
        self.like, self.ndim, self.ncdim, self.q = like, ndim, ncdim, q
        self.kind, self.dtype = bound_kind, dtype
        self.device = torch.device(device)
        self.max_waves, self.timings = max_waves, timings
        self.host_sampler, self.rounds = host_sampler, rounds
        # on the host: the round keys its buffers by it and keeps its own
        # copy on the card
        self.nb = None if nonbounded is None else _bool_mask(
            np.asarray(nonbounded, dtype=bool)[:ncdim], "cpu")
        self.entry = None

    def prepare(self, arrays, load=True):
        """The wave shape of ``arrays`` (its :class:`UnifGraph`, kept as
        ``entry`` and returned), with the arrays copied into its buffers
        where ``load`` (False: the round's start fills them, as a fused
        round's ellipsoid refit does)."""
        self.entry = unif_graph(self.rounds, self.like, self.kind, self.q,
                                self.ndim, self.ncdim, self.dtype,
                                self.device, self.nb, arrays)
        if load:
            self.entry.rb.load_arrays(arrays)
        return self.entry

    def begin(self, loglstar, gate=None):
        unif_start(self.entry, loglstar, self.max_waves, gate)

    def loop(self, gen, gate_read=False):
        return unif_loop(self.entry, gen, max_waves=self.max_waves,
                         timings=self.timings,
                         host_sampler=self.host_sampler, gate_read=gate_read)

    def finish(self):
        return self.entry.finish()

    def __call__(self, gen, loglstar, arrays):
        self.prepare(arrays)
        self.begin(loglstar)
        self.loop(gen)
        return self.finish()


# ==========================================================================
# round buffers captured as CUDA graphs (UnifGraph, SliceGraph,
# DoublingGraph, RWalkGraph)


class _RoundGraph:
    """What :class:`UnifGraph`, :class:`SliceGraph`, :class:`DoublingGraph`
    and :class:`RWalkGraph` share: the likelihood, the round's buffers
    ``rb``, the blob buffers, and on the card, for a likelihood the
    capture rule allows, a side stream and, once captured, the graph and
    the generator it draws from."""

    # True (set before the captures) to keep every captured graph's nodes
    # beside its instance, for ``graph.debug_dump``, the file in which the
    # CUDA runtime names each node's kernel: ``chip_smoke.py`` reads a
    # replay's kernels there
    keep_nodes = False

    def __init__(self, like, rb):
        self.like, self.rb = like, rb
        self.blob = None
        self.graph = self.gen = None
        # False for good once a capture has raised (the rounds run eagerly)
        self.capturable = rb.device.type == "cuda" and like.capturable()
        self.stream = torch.cuda.Stream(rb.device) if self.capturable \
            else None

    def load_blob(self, start_blob):
        """The round's blob buffers, holding ``start_blob``."""
        if start_blob is None:
            return None
        if self.blob is None:
            self.blob = tree_map(lambda b: torch.empty_like(
                b, memory_format=torch.contiguous_format), start_blob)
        tree_map(lambda b, s: b.copy_(s), self.blob, start_blob)
        return self.blob

    def select_blob(self, acc, blob_x):
        """Take ``blob_x`` into the round's blob buffers where ``acc``."""
        if self.blob is not None:
            tree_map(lambda b, n: torch.where(
                acc.reshape(acc.shape + (1,) * (b.dim() - 1)), n, b, out=b),
                self.blob, blob_x)

    def on_side_stream(self, fn):
        """Run ``fn`` on the side stream, ordered after and before the
        current stream's work (the warm-up before a capture)."""
        main = torch.cuda.current_stream(self.rb.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            fn()
        main.wait_stream(self.stream)

    def _capture(self, body, wrappers, what, shape, gen=None):
        """Capture ``body(gen)`` on the side stream as a CUDA graph that
        draws from a generator of its own (or from ``gen``, which several
        graphs may share); True when it was captured.  A capture runs
        nothing, so what it counted (``ncall_launched``, the
        ``wrappers``' launches) is put back and kept as what each replay
        runs (``counted``, added by :meth:`count_replay`).  A capture that
        raises leaves the round shape eager (warned once, naming the
        error) and the device's default generator drawing
        (:func:`~dynesty_tpu_torch.utils.misc.release_default_generator`)."""
        rb, like = self.rb, self.like
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_nodes)
        if self.keep_nodes:
            graph.enable_debug_mode()
        if gen is None:
            gen = torch.Generator(device=rb.device)
        saved = (like.ncall_launched, [w.launches for w in wrappers])
        main = torch.cuda.current_stream(rb.device)
        self.stream.wait_stream(main)
        try:
            graph.register_generator_state(gen)
            with torch.cuda.stream(self.stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    body(gen)
                finally:
                    graph.capture_end()
            if self.keep_nodes:
                graph.instantiate()
        except Exception as err:  # noqa: BLE001 - reported, then eager
            self.capturable = False
            release_default_generator(rb.device)
            warnings.warn(
                f"{what} could not be captured as a CUDA graph "
                f"({type(err).__name__}: {err}); rounds of shape {shape} "
                f"run eagerly", RuntimeWarning)
            return False
        finally:
            counted = (like.ncall_launched - saved[0],
                       [(w, w.launches - n)
                        for w, n in zip(wrappers, saved[1])])
            like.ncall_launched = saved[0]
            for w, n in zip(wrappers, saved[1]):
                w.launches = n
            main.wait_stream(self.stream)
        self.graph, self.gen, self.counted = graph, gen, counted
        return True

    def count_replay(self, counted=None):
        """Count one replay (of the graph whose capture counted
        ``counted``, by default the last one): the evaluations and the
        kernel launches that its capture recorded, which the replay ran
        without Python."""
        ncall, launches = self.counted if counted is None else counted
        self.like.ncall_launched += ncall
        for w, n in launches:
            w.launches += n


# ==========================================================================
# uniform rejection waves


class UnifGraph(_RoundGraph):
    """One wave shape of the uniform rejection round on one device: its
    :class:`~dynesty_tpu_torch.ops.proposals.UnifRound` buffers, its blob
    slots (q + 1 rows, as the round's), and on the card, for a likelihood
    that :meth:`~.likelihood.LogLikelihood.capturable` allows and a bound
    drawn on the card, one wave captured as a CUDA graph (the draws,
    ``unif_valid``, the batched likelihood at its clamped input,
    ``unif_place``, the blob's indexed copy, the done flag's copy to
    pinned host memory) with the generator it draws from.  A
    sampler keeps one per wave shape (:func:`unif_graph`); it is never
    pickled and goes with the sampler."""

    def __init__(self, like, rb, kind):
        super().__init__(like, rb)
        self.kind = kind
        # the first wave of the shape ran eagerly, as the capture's warm-up
        self.warm = False
        self.flag = None
        self.blob = like.blob_zeros(rb.q + 1, rb.device) \
            if getattr(like, "blob", False) else None

    def draws(self, gen, host_sampler=None):
        """``draw() -> (uc, ua, accept, u_ex)``: a wave's candidates in
        the bound's dimensions, what the lane checks read (the ellipsoids'
        acceptance uniforms, the friends' acceptance), and the other
        dimensions' uniforms (None when ``ncdim == ndim``), drawn from
        ``gen`` in the eager round's order, or over a user's bound from
        ``host_sampler()``."""
        rb, kind = self.rb, self.kind
        q, ncdim, dtype, device = rb.q, rb.ncdim, rb.dtype, rb.device
        n_extra = rb.ndim - ncdim

        def draw():
            ua = accept = None
            if kind == "cube":
                uc = torch.rand((q, ncdim), generator=gen, dtype=dtype,
                                device=device)
            elif kind == "ellipsoids":
                uc, ua = _sample_ellipsoid_union(gen, rb.arrays, q, ncdim,
                                                 dtype)
            elif kind == "custom":
                uc = torch.as_tensor(np.asarray(host_sampler()),
                                     dtype=dtype, device=device).contiguous()
            else:
                uc, accept = _sample_friends_union(gen, rb.arrays, q, ncdim,
                                                   dtype, kind)
            u_ex = torch.rand((q, n_extra), generator=gen, dtype=dtype,
                              device=device) if n_extra > 0 else None
            return uc, ua, accept, u_ex

        return draw

    def wave(self, draw, check=False):
        """One wave on the round's buffers, on the current stream: the
        draws, ``unif_valid`` (the lane checks, and the likelihood's input
        into ``rb.u_prop`` and ``rb.uclamp``), the likelihood at the
        clamped candidates (counting the valid lanes), ``unif_place`` and
        the blob's copy into the slots; with ``check`` (on the card) the
        draws and the likelihood's outputs are held to what the kernels
        read."""
        rb = self.rb
        uc, ua, accept, u_ex = draw()
        check = check and rb.device.type == "cuda"
        if check:
            rb.check_draws(uc, ua, accept, u_ex)
        unif_valid(rb, uc, ua, accept, u_ex)
        v, logl, blob = self.like.batch_eval(rb.uclamp, mask=rb.valid)
        # the round's dtype, in the layout the kernel reads
        v = v.to(rb.dtype).contiguous()
        logl = logl.to(rb.dtype).contiguous()
        if check:
            rb.check_likelihood(v, logl)
        unif_place(rb, rb.u_prop, v, logl)
        if self.blob is not None:
            tree_map(lambda b, p: b.__setitem__(rb.dest, p), self.blob,
                     blob)

    def capture(self):
        """Capture one wave on the side stream; True when it was captured.
        A capture that raises leaves the wave shape eager (warned once,
        naming the error) and every count as it was."""
        rb = self.rb
        flag = torch.empty((2,), dtype=torch.bool, pin_memory=True)

        def body(gen):
            self.wave(self.draws(gen))
            flag.copy_(rb.flags, non_blocking=True)

        if not self._capture(body, (unif_valid, unif_place),
                             "the uniform rejection wave",
                             (self.kind, rb.q, rb.ndim)):
            return False
        # the flag read through a numpy view of the pinned tensor
        self.flag = (flag, flag.numpy())
        return True

    def replay(self):
        """One wave by replay; waits for it and returns the host copy of
        the done flag and the round gate."""
        self.graph.replay()
        torch.cuda.current_stream(self.rb.device).synchronize()
        self.count_replay()
        return bool(self.flag[1][0]), bool(self.flag[1][1])

    def finish(self):
        """The round's result from the device state, no host read: the
        packed columns (:func:`make_unif_round`) and copies of the blob
        slots (the next round of the shape refills them).  The
        evaluations no slot took (a fill cut by the cap on waves) are
        charged to slot 0, and unfilled slots read logl = -inf."""
        rb = self.rb
        q, st, s = rb.q, rb.state, rb.slots
        bnc = s["nc"][:q].clone()
        bnc[0] += st[U_PENDING]
        lanes = torch.arange(q, device=rb.device)
        bl = torch.where(lanes < st[U_FILLED], s["logl"][:q], _NEG_INF)
        return pack_columns(q, rb.dtype, s["u"][:q], s["v"][:q], bl, bnc,
                            st[U_NC], st[U_PROP], st[U_FILLED],
                            device=rb.device), \
            tree_map(lambda b: b[:q].clone(), self.blob)


def unif_graph(rounds, like, kind, q, ndim, ncdim, dtype, device,
               strict=None, arrays=None):
    """The :class:`UnifGraph` of this wave shape from the cache
    ``rounds`` (a dict a sampler keeps; None: a new one, kept nowhere).
    The shape includes the bound kind, the cube check's mask (read on the
    host: give it there), the blob, and the shapes, layouts and dtypes of
    the bound's arrays that a wave reads (the padded ellipsoid count
    among them); of the union's ``UNIF_FORMS``, which the round lays out
    itself, the shapes only."""
    layout = {k: (tuple(arrays[k].shape), arrays[k].stride(),
                  arrays[k].storage_offset(), arrays[k].dtype)
              for k in UNIF_ARRAYS[kind]}
    key = ("unif", kind, q, ndim, ncdim, like.npdim, dtype, str(device),
           _mask_key(strict), bool(getattr(like, "blob", False))) + \
        tuple(sorted((k, v[:1] if kind == "ellipsoids" and k in UNIF_FORMS
                      else v) for k, v in layout.items()))
    entry = None if rounds is None else rounds.get(key)
    if entry is None or entry.like is not like:
        entry = UnifGraph(like, UnifRound(q, ndim, ncdim, like.npdim, dtype,
                                          device, strict, layout), kind)
        if rounds is not None:
            rounds[key] = entry
    return entry


def unif_waves(entry, gen, loglstar, arrays, *, max_waves=100000,
               timings=None, host_sampler=None):
    """One uniform round on the wave shape ``entry`` (a
    :class:`UnifGraph`): :func:`unif_start` with the bound's ``arrays``,
    then :func:`unif_loop`.  Returns the round's ``(packed, blob)``
    (:meth:`UnifGraph.finish`)."""
    entry.rb.load_arrays(arrays)
    unif_start(entry, loglstar, max_waves)
    unif_loop(entry, gen, max_waves=max_waves, timings=timings,
              host_sampler=host_sampler)
    return entry.finish()


def unif_start(entry, loglstar, max_waves, gate=None):
    """Start a round on the wave shape ``entry`` (a :class:`UnifGraph`)
    at ``loglstar``, its blob slots zeroed, behind the round gate ``gate``
    (:meth:`UnifRound.start`); device work only."""
    entry.rb.start(loglstar, None, max_waves, gate)
    if entry.blob is not None:
        tree_map(lambda b: b.zero_(), entry.blob)


def unif_loop(entry, gen, *, max_waves=100000, timings=None,
              host_sampler=None, gate_read=False):
    """The rejection waves of a round started on ``entry``
    (:func:`unif_start`), drawn from ``gen`` (over a user's bound from
    ``host_sampler()``) until every slot is filled or ``max_waves`` waves
    ran, one host read of the done flag a wave (``sync_wave``).  On the
    card, with a likelihood that may be captured
    (:func:`~.likelihood.graph_capturable`) and a bound drawn on the card,
    each wave runs as one CUDA graph replay (``n_unif_replay``): the first
    wave of a shape runs eagerly on a side stream as the capture's
    warm-up, the next captures (``n_unif_graph``); a wave that replays
    nothing counts ``n_uncaptured``.

    With ``gate_read`` the first read also reports the round gate: where
    it is set (the first wave launched no lane) the read counts as
    ``sync_round`` and the loop stops.  Waves over a user's bound draw on
    the host, from the sampler's stream, so there the gate is read
    (``sync_round``) before the first draw, and a round behind it draws
    nothing.  Returns whether it was set."""
    rb = entry.rb
    if gate_read and host_sampler is not None:
        _count(timings, "sync_round")
        if bool(rb.gate):
            return True
        gate_read = False
    on_card = rb.device.type == "cuda"
    use_graph = host_sampler is None and entry.capturable
    draw = entry.draws(gen, host_sampler)
    done, first, replays, gated = max_waves < 1, True, 0, False
    while not done:
        if use_graph and entry.graph is None and entry.warm:
            use_graph = entry.capture()
            if use_graph:
                _count(timings, "n_unif_graph")
        if use_graph and entry.graph is not None:
            if not replays:
                # the graph's generator takes the round's seed and offset
                entry.gen.manual_seed(gen.initial_seed())
                entry.gen.set_offset(gen.get_offset())
            done, gated = entry.replay()
            replays += 1
        else:
            if use_graph:
                entry.on_side_stream(lambda: entry.wave(draw, check=True))
                entry.warm = True
            else:
                entry.wave(draw, check=first)
            done, gated = rb.flags.tolist()
            if on_card:
                _count(timings, "n_uncaptured")
        if first and gate_read and gated:
            _count(timings, "sync_round")
            break
        first = False
        _count(timings, "sync_wave")
    if replays:
        gen.set_offset(entry.gen.get_offset())
        _count(timings, "n_unif_replay", replays)
    return bool(gate_read and gated)


# ==========================================================================
# random-walk kernel


class RWalkGraph(_RoundGraph):
    """One round shape of the random walk on one device: its
    :class:`~dynesty_tpu_torch.ops.proposals.RWalkRound` buffers, its blob
    buffers, and on the card, for a likelihood that
    :meth:`~.likelihood.LogLikelihood.capturable` allows, one whole walk
    of ``walks`` steps captured as a CUDA graph (each step's draws, the
    axes ``einsum``, ``rwalk_propose``, the batched likelihood,
    ``rwalk_accept``, the blob select) with the generator it draws from.
    The walk has a fixed length, so a replay reads nothing back.  A
    sampler keeps one per round shape (:func:`rwalk_graph`); it is never
    pickled and goes with the sampler."""

    def __init__(self, like, rb, walks):
        super().__init__(like, rb)
        self.walks = walks
        # the first round of the shape ran eagerly, as the capture's
        # warm-up
        self.warm = False

    def draws(self, gen):
        """``draw(step) -> (dr, u_ex)`` from ``gen``: the unit-ball draws
        of the lanes, then the extra dimensions' uniforms (None when
        ``ncdim == ndim``), as the eager round drew them."""
        rb = self.rb
        n_extra = rb.ndim - rb.ncdim

        def draw(step):
            dr = randsphere_batch(gen, (rb.q,), rb.ncdim, rb.dtype,
                                  rb.device)
            u_ex = torch.rand((rb.q, n_extra), generator=gen,
                              dtype=rb.dtype, device=rb.device) \
                if n_extra > 0 else None
            return dr, u_ex

        return draw

    def step(self, draw, i):
        """Step ``i`` on the round's buffers, on the current stream: the
        draws, the product with the lanes' axes, the two kernels around
        the likelihood at the clamped proposals and the blob select.  The
        draws and the likelihood's outputs are checked at step 0."""
        rb = self.rb
        dr, u_ex = draw(i)
        du = torch.einsum("qij,qj->qi", rb.axes, dr)
        if i == 0 and rb.device.type == "cuda":
            rb.check_draws(du, u_ex)
        rwalk_propose(rb, du, u_ex)
        v_prop, logl_prop, blob_prop = self.like.batch_eval(rb.uclamp,
                                                            mask=rb.ok)
        # the round's dtype, in the layout the kernel reads
        v_prop = v_prop.to(rb.dtype).contiguous()
        logl_prop = logl_prop.to(rb.dtype).contiguous()
        if i == 0 and rb.device.type == "cuda":
            rb.check_likelihood(v_prop, logl_prop)
        rwalk_accept(rb, v_prop, logl_prop)
        self.select_blob(rb.accept, blob_prop)

    def walk(self, draw):
        """The round's ``walks`` steps (:meth:`step`)."""
        for i in range(self.walks):
            self.step(draw, i)

    def capture(self):
        """Capture one walk on the side stream; True when it was
        captured.  A capture that raises leaves the round shape eager
        (warned once, naming the error) and every count as it was."""
        rb = self.rb
        return self._capture(lambda gen: self.walk(self.draws(gen)),
                             (rwalk_propose, rwalk_accept),
                             "the random walk's round",
                             (rb.q, self.walks, rb.ndim))

    def replay(self, gen):
        """One walk by replay, on the current stream, drawing from
        ``gen``'s stream where the eager walk would: the graph's
        generator takes ``gen``'s seed and offset before and gives the
        offset back after.  Waits for nothing."""
        self.gen.manual_seed(gen.initial_seed())
        self.gen.set_offset(gen.get_offset())
        self.graph.replay()
        gen.set_offset(self.gen.get_offset())
        self.count_replay()


def _mask_key(m):
    """A bool mask (on the host) as part of a round shape's key."""
    return None if m is None else tuple(m.tolist())


def rwalk_graph(rounds, like, q, walks, ndim, axes, dtype, device,
                periodic=None, reflective=None, nonbounded=None):
    """The :class:`RWalkGraph` of this round shape from the cache
    ``rounds`` (a dict a sampler keeps; None: a new one, kept nowhere).
    The shape includes the masks (read on the host: give them there) and
    the layout of ``axes`` (:class:`RWalkRound`'s ``axes_layout``)."""
    ncdim = axes.shape[-1]
    layout = (axes.stride(), axes.storage_offset())
    key = ("rwalk", q, walks, ndim, ncdim, like.npdim, dtype, str(device),
           layout) + tuple(_mask_key(m) for m in (periodic, reflective,
                                                  nonbounded))
    entry = None if rounds is None else rounds.get(key)
    if entry is None or entry.like is not like:
        entry = RWalkGraph(like, RWalkRound(
            q, ndim, ncdim, like.npdim, dtype, device, periodic, reflective,
            nonbounded, axes_layout=layout), walks)
        if rounds is not None:
            rounds[key] = entry
    return entry


def rwalk_walk(like, u, v, logl, axes, scale, loglstar, draw, blob=None, *,
               walks, periodic=None, reflective=None, nonbounded=None,
               timings=None, rounds=None):
    """``walks`` random-walk steps of every lane from ``u, v, logl``
    (q lanes, their blobs ``blob``): each proposes ``u[:, :ncdim] + axes
    @ dr * scale`` (``axes`` (q, ncdim, ncdim)) with the uniform draws
    ``u_ex`` in the other dimensions, and moves where the proposal is in
    the cube and above ``loglstar``.  ``draw`` is the round's
    ``torch.Generator`` (:meth:`RWalkGraph.draws`) or a function
    ``draw(step) -> (dr, u_ex)`` (``u_ex`` None when ``ncdim == ndim``;
    the tests feed the JAX package's draws).  The per-step updates are
    the kernels of ``ops/proposals.py`` on the card (:func:`rwalk_loop`).
    ``rounds`` is the sampler's cache of round shapes
    (:func:`rwalk_graph`).  Returns ``(state, blob)``, copies of the
    round's buffers (the next round of the shape refills them): the state
    ``u, v, logl, n_acc, n_rej`` and the blob."""
    q, ndim = u.shape
    entry = rwalk_graph(rounds, like, q, walks, ndim, axes, u.dtype,
                        u.device, periodic, reflective, nonbounded)
    rwalk_start(entry, u, v, logl, axes, scale, loglstar, blob)
    rwalk_loop(entry, draw, timings=timings)
    return rwalk_result(entry)


def rwalk_start(entry, u, v, logl, axes, scale, loglstar, blob=None):
    """Load a walk into the round shape ``entry`` (a
    :class:`RWalkGraph`); device work only."""
    entry.rb.start(u, v, logl, axes, scale, loglstar)
    entry.load_blob(blob)


def rwalk_result(entry):
    """Copies of the round's state and blob (the next round of the shape
    refills its buffers)."""
    return ({k: t.clone() for k, t in entry.rb.st.items()},
            tree_map(torch.clone, entry.blob))


def rwalk_loop(entry, draw, *, timings=None):
    """The walk of a round loaded into ``entry`` (:func:`rwalk_start`).
    On the card, with a generator and a likelihood that may be captured
    (:func:`~.likelihood.graph_capturable`), the walk runs as one CUDA
    graph replay (``n_rwalk_replay``): the first round of a shape runs
    eagerly on a side stream as the capture's warm-up, the next captures
    the walk (``n_rwalk_graph``); a round that replays nothing counts
    ``n_uncaptured``.  The walk reads nothing back."""
    rb = entry.rb
    gen = draw if isinstance(draw, torch.Generator) else None
    use_graph = gen is not None and entry.capturable
    if use_graph and entry.graph is None and entry.warm:
        use_graph = entry.capture()
        if use_graph:
            _count(timings, "n_rwalk_graph")
    if use_graph and entry.graph is not None:
        entry.replay(gen)
        _count(timings, "n_rwalk_replay")
    else:
        steps = draw if gen is None else entry.draws(gen)
        if use_graph:
            entry.on_side_stream(lambda: entry.walk(steps))
            entry.warm = True
        else:
            entry.walk(steps)
        if rb.device.type == "cuda":
            _count(timings, "n_uncaptured")


def make_rwalk_round(like, *, ndim, ncdim, q, walks, dtype, device,
                     nonbounded=None, periodic=None, reflective=None,
                     timings=None, rounds=None):
    """Random-walk round: each of the ``q`` lanes makes exactly ``walks``
    proposals inside its scaled ellipsoid (axes per lane, in the first
    ``ncdim`` dimensions; the other dimensions are drawn uniformly),
    accepting moves with ``logl > loglstar``.  Periodic and reflective
    dimensions are wrapped before the cube check.  The loop has a fixed
    length, so the round never reads the device from the host.
    ``timings`` and ``rounds`` are the sampler's (:func:`rwalk_walk`).

    Returns an :class:`RWalkRoundFn`, called as ``fn(gen, packed_in,
    start_blob, scale, loglstar) -> (packed (q, ndim + npdim + 3), blob)``
    with columns ``u | v | logl | n_accept | n_reject``; ``packed_in`` is
    ``u | v | logl | axes (ncdim*ncdim)`` of the start points,
    ``start_blob`` their blobs.  A lane that never accepts keeps its
    start point."""
    return RWalkRoundFn(like, ndim, ncdim, q, walks, dtype, device,
                        nonbounded, periodic, reflective, timings, rounds)


class RWalkRoundFn:
    """The walk round of :func:`make_rwalk_round` in the parts a fused
    round runs apart: :meth:`prepare` (the round shape's buffers),
    :meth:`begin` (the walk's start, device work only: a fused round's
    prologue captures it), :meth:`loop` (the walk) and :meth:`finish`
    (the packed result, device work only: the epilogue captures it).  The
    walk reads no flag, so a fused round reads its gate on the host
    (``gate_read`` False).  Calling it runs all four."""

    gate_read = False

    def __init__(self, like, ndim, ncdim, q, walks, dtype, device,
                 nonbounded, periodic, reflective, timings, rounds):
        self.like, self.ndim, self.ncdim, self.q = like, ndim, ncdim, q
        self.walks, self.dtype = walks, dtype
        self.device = _device_of(device)
        self.timings, self.rounds = timings, rounds
        # on the host: the round keys its buffers by them and keeps its
        # own copy on the card
        self.masks = (_mask_from_indices(periodic, ndim),
                      _mask_from_indices(reflective, ndim),
                      _bool_mask(nonbounded, "cpu"))
        self.entry = None

    def _split(self, packed_in):
        il = self.ndim + self.like.npdim
        return (packed_in[:, :self.ndim].to(self.dtype),
                packed_in[:, self.ndim:il].to(self.dtype),
                packed_in[:, il].to(self.dtype),
                packed_in[:, il + 1:].reshape(
                    self.q, self.ncdim, self.ncdim).to(self.dtype))

    def prepare(self):
        """The round shape's :class:`RWalkGraph` (kept as ``entry`` and
        returned), keyed by the layout the lanes' axes have in
        ``packed_in`` (a fresh contiguous block)."""
        il = self.ndim + self.like.npdim
        block = torch.empty((self.q, il + 1 + self.ncdim ** 2),
                            dtype=self.dtype, device="meta")
        axes = self._split(block)[3]
        self.entry = rwalk_graph(self.rounds, self.like, self.q, self.walks,
                                 self.ndim, axes, self.dtype, self.device,
                                 *self.masks)
        return self.entry

    def begin(self, gen, packed_in, start_blob, scale, loglstar, gate=None):
        rwalk_start(self.entry, *self._split(packed_in), scale, loglstar,
                    start_blob)

    def loop(self, gen, gate_read=False):
        rwalk_loop(self.entry, gen, timings=self.timings)
        return False

    def finish(self):
        st, blob = rwalk_result(self.entry)
        return pack_columns(self.q, self.dtype, st["u"], st["v"], st["logl"],
                            st["n_acc"], st["n_rej"],
                            device=self.device), blob

    def __call__(self, gen, packed_in, start_blob, scale, loglstar):
        self.prepare()
        self.begin(gen, packed_in, start_blob, scale, loglstar)
        self.loop(gen)
        return self.finish()


# ==========================================================================
# slice kernels


def slice_directions(gen, axes, scale, kind, slices):
    """Per-lane slice directions, shape ``(q, n_steps, ndim)``, drawn in
    the dtype of ``axes``.

    ``kind='rslice'``: ``slices`` random isotropic directions per lane,
    transformed by the lane's axes.  ``kind='slice'``: ``slices`` passes
    over all ``ndim`` principal axes (the columns of the lane's axes) in an
    order shuffled per lane and pass.  The shuffle is the ``argsort`` of
    uniform draws: a tie, which would bias it, has probability ~ndim^2
    2^-53 per pass in float64 and ~ndim^2 2^-24 in float32."""
    q, ndim = axes.shape[0], axes.shape[-1]
    if kind == "rslice":
        drhat = torch.randn((q, slices, ndim), generator=gen,
                            dtype=axes.dtype, device=axes.device)
        drhat = drhat / torch.linalg.vector_norm(drhat, dim=-1,
                                                 keepdim=True)
        return torch.einsum("qij,qsj->qsi", axes, drhat) * scale
    keys = torch.rand((q, slices, ndim), generator=gen, dtype=axes.dtype,
                      device=axes.device)
    perm = torch.argsort(keys, dim=-1).reshape(q, slices * ndim)
    # axis i is column i of axes: gather rows of axes^T in shuffled order
    rows = perm[:, :, None].expand(q, slices * ndim, ndim)
    return torch.gather(axes.transpose(1, 2), 1, rows) * scale


def doubling_accept(feval, x1, loglstar, left, right, f_left, f_right,
                    timings=None, lanes=None):
    """Batched acceptance test of Neal (2003), algorithm 6: would the
    doubling procedure started from ``x1`` have reached the interval
    ``(left, right)`` that was built from 0?  ``feval(x, mask) -> logl``
    evaluates the lanes' positions, counting the lanes of ``mask``; only
    the lanes of ``lanes`` (default: all) are tested, the others accept
    untested.  Returns ``(accept (q,), nc (q,))`` with ``nc`` the
    evaluations each lane spent.  One host read per halving
    (``sync_slice``)."""
    active = (right - left) > 1.1
    if lanes is not None:
        active = active & lanes
    lhat, rhat, f_lhat, f_rhat = left, right, f_left, f_right
    dflag = torch.zeros_like(active)
    reject = torch.zeros_like(active)
    nc = torch.zeros(active.shape, dtype=torch.int64, device=active.device)
    while True:
        _count(timings, "sync_slice")
        if not bool(active.any()):
            break
        mid = 0.5 * (lhat + rhat)
        dflag = dflag | (((0.0 < mid) & (mid <= x1)) |
                         ((x1 < mid) & (mid <= 0.0)))
        go_right = x1 < mid  # shrink the right side toward x1
        logl_mid = feval(mid, active)
        nc = nc + active
        f_rhat = torch.where(active & go_right, logl_mid, f_rhat)
        rhat = torch.where(active & go_right, mid, rhat)
        f_lhat = torch.where(active & ~go_right, logl_mid, f_lhat)
        lhat = torch.where(active & ~go_right, mid, lhat)
        newly_rejected = active & dflag & (loglstar >= f_lhat) & \
            (loglstar >= f_rhat)
        reject = reject | newly_rejected
        active = active & ~newly_rejected & ((rhat - lhat) > 1.1)
    return ~reject, nc


class SliceGraph(_RoundGraph):
    """One round shape of the stepping-out state machine on one device:
    its :class:`~dynesty_tpu_torch.ops.proposals.SliceRound` buffers, its
    blob buffers, and on the card, for a likelihood that
    :meth:`~.likelihood.LogLikelihood.capturable` allows, one iteration
    captured as a CUDA graph (draws, ``slice_propose``, the batched
    likelihood, ``slice_advance``, the blob select, the flag's copy to
    pinned host memory) with the generator it draws from.  A sampler
    keeps one per round shape (:func:`slice_graph`); it is never pickled
    and goes with the sampler."""

    def __init__(self, like, rb):
        super().__init__(like, rb)
        self.flag = None

    def iterate(self, fill_draws):
        """One iteration on the round's buffers: ``fill_draws()`` fills
        ``rb.draws``, then the two kernels around the likelihood at the
        clamped point and the blob select, all on the current stream."""
        rb, like = self.rb, self.like
        fill_draws()
        slice_propose(rb)
        v_x, logl_x, blob_x = like.batch_eval(rb.uclamp, mask=rb.incube)
        # the round's dtype, in the layout the kernel reads
        v_x = v_x.to(rb.dtype).contiguous()
        logl_x = logl_x.to(rb.dtype).contiguous()
        if rb.device.type == "cuda":
            rb.check_likelihood(v_x, logl_x)
        slice_advance(rb, v_x, logl_x)
        self.select_blob(rb.acc, blob_x)

    def capture(self):
        """Capture one iteration on the side stream; True when it was
        captured.  A capture that raises leaves the round shape eager
        (warned once, naming the error) and every count as it was."""
        rb = self.rb
        flag = torch.empty((2,), dtype=torch.bool, pin_memory=True)

        def body(gen):
            self.iterate(lambda: rb.draws.uniform_(generator=gen))
            flag.copy_(rb.flags, non_blocking=True)

        if not self._capture(body, (slice_propose, slice_advance),
                             "the slice state machine's iteration",
                             (rb.q, rb.n_steps, rb.ndim)):
            return False
        # the flag read through a numpy view of the pinned tensor
        self.flag = (flag, flag.numpy())
        return True

    def replay(self):
        """One iteration by replay; waits for it and returns the host
        copy of ``any_active``."""
        self.graph.replay()
        torch.cuda.current_stream(self.rb.device).synchronize()
        self.count_replay()
        return bool(self.flag[1][0])


def slice_graph(rounds, like, q, n_steps, ndim, dtype, device, strict=None):
    """The :class:`SliceGraph` of this round shape from the cache
    ``rounds`` (a dict a sampler keeps; None: a new one, kept nowhere)."""
    key = (q, n_steps, ndim, like.npdim, dtype, str(device),
           _mask_key(strict))
    entry = None if rounds is None else rounds.get(key)
    if entry is None or entry.like is not like:
        entry = SliceGraph(like, SliceRound(q, n_steps, ndim, like.npdim,
                                            dtype, device, strict))
        if rounds is not None:
            rounds[key] = entry
    return entry


def slice_state_machine(like, directions, r0, draw, loglstar, start_u,
                        start_v, start_logl, start_blob=None, *, strict=None,
                        max_shrink_iters=10000, timings=None, rounds=None):
    """The per-lane slice state machine in stepping-out mode: every lane
    advances its own phase (init left, init right, expand left, expand
    right, shrink) through its ``n_steps`` slice updates along
    ``directions`` (q, n_steps, ndim, lengths capped), starting on the
    interval ``(-r0, 1 - r0)``.  Each iteration draws ``(2, q)`` uniforms:
    the shrink positions and the next intervals' offsets.  ``draw`` is
    the round's ``torch.Generator`` (``uniform_`` into the round's draw
    buffer, which draws what ``torch.rand`` draws) or a function
    ``draw(it) -> (2, q)`` (the tests feed the JAX package's draws).  One
    batched likelihood call an iteration between the kernels of
    ``ops/proposals.py`` on the card, and one host read of whether any
    lane is short of its last update (``sync_slice``; :func:`slice_loop`).
    ``rounds`` is the sampler's cache of round shapes
    (:func:`slice_graph`).  ``strict`` is the cube check's bool mask
    (None: every dimension).  Returns ``(state, blob)``, the state as
    ``ops.proposals.slice_init`` lays it out (``u, v, logl, nc, n_exp,
    n_con, warn`` among its entries)."""
    q, n_steps, ndim = directions.shape
    entry = slice_graph(rounds, like, q, n_steps, ndim, r0.dtype, r0.device,
                        strict)
    st = slice_start(entry, directions, r0, loglstar, start_u, start_v,
                     start_logl, start_blob)
    slice_loop(entry, draw, max_shrink_iters=max_shrink_iters,
               timings=timings)
    return st, tree_map(torch.clone, entry.blob)


def slice_start(entry, directions, r0, loglstar, start_u, start_v,
                start_logl, start_blob=None, gate=None):
    """Load a round into the round shape ``entry`` (a
    :class:`SliceGraph`) behind the round gate ``gate``
    (:meth:`SliceRound.start`); device work only.  Returns the state."""
    st = entry.rb.start(start_u, start_v, start_logl, r0, directions,
                        loglstar, gate)
    entry.load_blob(start_blob)
    return st


def slice_loop(entry, draw, *, max_shrink_iters=10000, timings=None,
               gate_read=False):
    """The iterations of a round loaded into ``entry``
    (:func:`slice_start`), one host read of the flags before each
    (``sync_slice``).  On the card, with a generator and a likelihood
    that may be captured (:func:`~.likelihood.graph_capturable`), the
    iteration runs as one CUDA graph replay (``n_slice_replay``): the
    first round of a shape runs its first iteration eagerly on a side
    stream, then captures the next (``n_slice_graph``); a round that
    replays nothing counts ``n_uncaptured``.

    With ``gate_read`` the first read also reports the round gate: where
    it is set (no lane active) the read counts as ``sync_round`` and the
    loop stops.  Returns whether it was set."""
    rb = entry.rb
    gen = draw if isinstance(draw, torch.Generator) else None
    use_graph = gen is not None and entry.capturable
    if gen is not None:
        def fill():
            rb.draws.uniform_(generator=gen)
    it, flag, replays = 0, None, 0
    max_total = rb.n_steps * max_shrink_iters
    while it < max_total:
        if flag is None:
            flag, gated = rb.flags.tolist()
            if gate_read and gated:
                _count(timings, "sync_round")
                return True
        _count(timings, "sync_slice")
        if not flag:
            break
        if use_graph and entry.graph is None and it > 0:
            use_graph = entry.capture()
            if use_graph:
                _count(timings, "n_slice_graph")
        if use_graph and entry.graph is not None:
            if not replays:
                # the graph's generator takes the round's seed and offset
                entry.gen.manual_seed(gen.initial_seed())
                entry.gen.set_offset(gen.get_offset())
            flag = entry.replay()
            replays += 1
        elif use_graph:
            # the warm-up: the first iteration of a new round shape, on a
            # side stream, before its capture
            entry.on_side_stream(lambda: entry.iterate(fill))
            flag = bool(rb.st["any_active"])
        else:
            step = it
            entry.iterate(fill if gen is not None else
                          lambda: rb.draws.copy_(draw(step)))
            flag = bool(rb.st["any_active"])
        it += 1
    if replays:
        gen.set_offset(entry.gen.get_offset())
        _count(timings, "n_slice_replay", replays)
    elif rb.device.type == "cuda":
        _count(timings, "n_uncaptured")
    return False


class DoublingGraph(_RoundGraph):
    """One round shape of the doubling slice round on one device: its
    :class:`~dynesty_tpu_torch.ops.proposals.DoublingRound` buffers, its
    blob buffers (the lanes' and the shrink candidate's), and on the card,
    for a likelihood that :meth:`~.likelihood.LogLikelihood.capturable`
    allows, each of the round's five segments between two host reads
    captured as a CUDA graph (``graphs``): the step's start (r0, both end
    probes), a doubling, a shrink candidate, a halving, and a shrink's
    resolution, each ending with its flag's copy to pinned host memory.
    The three that draw share one generator.  A sampler keeps one per
    round shape (:func:`doubling_graph`); it is never pickled and goes
    with the sampler.

    Each probe but the step's end probes is written by the kernel before
    it, with the next uniform vector of the round's stream drawn just
    before that kernel: the start and each doubling draw the vector of
    the next doubling's side, which is the first candidate's position
    where no lane doubles on, and a resolution the next candidate's.  The
    stream keeps the eager round's order (r0, the sides, the candidates);
    a vector drawn for a segment that does not follow (the gate set, the
    step's last resolution, the shrink cap) is given back
    (:meth:`rewind`)."""

    # the segments that draw: r0 and the next probe's vector, the next
    # probe's (a doubling's, a resolution's)
    DRAWS = ("start", "double", "resolve")

    def __init__(self, like, rb):
        super().__init__(like, rb)
        # each captured segment and what its capture counted
        self.graphs, self.counts, self.warm = {}, {}, set()
        self.blob_c = None
        # the round gate as the step's start segment last read it
        self.gated = False
        # where the round's generator stood before the last segment's
        # draw of the next probe's vector (its state on the CPU, its
        # offset on the card)
        self.undo = None
        if self.capturable:
            self.gen = torch.Generator(device=rb.device)
            # the flag a replay leaves (and, after a start segment, the
            # round gate), read through a numpy view
            self.flag = torch.empty((2,), dtype=torch.bool, pin_memory=True)
            self.flag_np = self.flag.numpy()

    def load_blob(self, start_blob):
        """The lanes' blob buffers, holding ``start_blob``, and the shrink
        candidate's."""
        blob = super().load_blob(start_blob)
        if blob is not None and self.blob_c is None:
            self.blob_c = tree_map(torch.empty_like, blob)
        return blob

    def _eval(self, mask):
        """The batched likelihood at the clamped probe, counting the lanes
        of ``mask``, its outputs in the round's dtype and the layout the
        kernels read."""
        rb = self.rb
        v, logl, blob = self.like.batch_eval(rb.st["uclamp"], mask=mask)
        v = v.to(rb.dtype).contiguous()
        logl = logl.to(rb.dtype).contiguous()
        if rb.device.type == "cuda":
            rb.check_likelihood(v, logl)
        return v, logl, blob

    def segment(self, name, fill=None):
        """The segment ``name`` on the round's buffers, on the current
        stream.  ``fill(which)`` fills ``rb.draw`` for the segments that
        draw: ``which`` 0 the step's r0, 1 the next probe's vector; it
        returns the buffer of the first shrink candidate's position
        (``rb.draw`` under a generator, which draws one vector)."""
        rb, st = self.rb, self.rb.st
        if name == "start":
            # behind a set round gate the end probes count no lane (the
            # kernel reads the gate)
            fill(0)
            doubling_point(rb, P_START_L)
            logl_l = self._eval(st["incube_l"])[1]
            doubling_point(rb, P_START_R)
            logl_r = self._eval(st["incube"])[1]
            doubling_expand(rb, X_INIT, logl_r, logl_l, fill(1))
        elif name == "double":
            # the lanes that shrink next are probed too, uncounted
            logl = self._eval(st["incube"])[1]
            doubling_expand(rb, X_DOUBLE, logl, draw_x=fill(1))
        elif name == "candidate":
            # doubling_shrink also probes the first halving's mid, over
            # the point the likelihood read: the blob is kept first
            v, logl, blob = self._eval(st["incube_s"])
            if self.blob_c is not None:
                tree_map(lambda c, b: c.copy_(b), self.blob_c, blob)
            doubling_shrink(rb, S_CANDIDATE, v, logl)
        elif name == "halve":
            # the mid was probed by the kernel before (the candidate's
            # doubling_shrink, or the last halving), which doubling_halve
            # does for the next one
            doubling_halve(rb, self._eval(st["incube"])[1])
        else:
            fill(1)
            doubling_shrink(rb, S_RESOLVE)
            self.select_blob(st["newly"], self.blob_c)

    def _flag_of(self, name):
        return self.rb.st["any_shrink" if name == "resolve" else "any"]

    def capture(self, name):
        """Capture the segment ``name`` on the side stream; True when it
        was captured.  A capture that raises leaves the round shape eager
        (warned once, naming the error), its segments captured before
        dropped, and every count as it was."""
        rb = self.rb
        draws = name in self.DRAWS

        def body(gen):
            self.segment(name, self._filler(gen, False) if draws else None)
            if name == "start":
                self.flag.copy_(rb.flags, non_blocking=True)
            else:
                self.flag[0].copy_(self._flag_of(name), non_blocking=True)

        if not self._capture(
                body, (doubling_point, doubling_expand, doubling_halve,
                       doubling_shrink),
                f"the doubling slice round's {name} segment",
                (rb.q, rb.n_steps, rb.ndim), gen=self.gen):
            self.graphs.clear()
            return False
        self.graphs[name] = self.graph
        self.counts[name] = self.counted
        return True

    def _filler(self, gen, mark=True):
        """A segment's ``fill`` drawing each vector from ``gen`` into
        ``rb.draw``; with ``mark`` it keeps where ``gen`` stood before the
        next probe's vector (:meth:`rewind`)."""
        rb = self.rb

        def fill(which):
            if which and mark:
                self.undo = gen.get_state() if gen.device.type == "cpu" \
                    else gen.get_offset()
            rb.draw.uniform_(generator=gen)
            return rb.draw
        return fill

    def rewind(self, gen):
        """Give back the vector that the last drawing segment drew for the
        next probe, which no segment reads: ``gen`` (the round's
        generator; None, a draw function: nothing) then stands where the
        eager round leaves it."""
        if gen is None:
            return
        if gen.device.type == "cpu":
            gen.set_state(self.undo)
        else:
            gen.set_offset(self.undo)

    def replay(self, name, gen):
        """The segment ``name`` by replay, drawing from ``gen``'s stream
        where the eager segment would (the shared generator takes its seed
        and offset before and gives the offset back after, and the offset
        before the next probe's vector is kept: the segment's vectors are
        alike, each the same span of the stream); waits for it and returns
        the host copy of its flag."""
        if name in self.DRAWS:
            before = gen.get_offset()
            self.gen.manual_seed(gen.initial_seed())
            self.gen.set_offset(before)
            self.graphs[name].replay()
            after = self.gen.get_offset()
            gen.set_offset(after)
            self.undo = after - (after - before) // (
                2 if name == "start" else 1)
        else:
            self.graphs[name].replay()
        torch.cuda.current_stream(self.rb.device).synchronize()
        self.count_replay(self.counts[name])
        if name == "start":
            self.gated = bool(self.flag_np[1])
        return bool(self.flag_np[0])

    def run(self, name, draw, use_graph, timings):
        """The segment ``name`` of a round: replayed once the shape's
        segment is captured (``n_doubling_replay``), else run eagerly --
        on the side stream as the capture's warm-up the first time
        (``use_graph``), the next time captured (``n_doubling_graph``) and
        replayed; ``draw`` is the round's ``torch.Generator`` or a
        segment's ``fill`` (:meth:`segment`).  Returns the host copy of
        the segment's flag; an eager segment on the card counts
        ``n_uncaptured``."""
        rb = self.rb
        if use_graph and self.capturable and name not in self.graphs and \
                name in self.warm:
            if self.capture(name):
                _count(timings, "n_doubling_graph")
        if use_graph and self.capturable and name in self.graphs:
            _count(timings, "n_doubling_replay")
            return self.replay(name, draw)
        fill = None
        if name in self.DRAWS:
            fill = self._filler(draw) if isinstance(draw, torch.Generator) \
                else draw
        if use_graph and self.capturable:
            self.on_side_stream(lambda: self.segment(name, fill))
            self.warm.add(name)
        else:
            self.segment(name, fill)
        if rb.device.type == "cuda":
            _count(timings, "n_uncaptured")
        if name == "start":
            flag, self.gated = rb.flags.tolist()
            return flag
        return bool(self._flag_of(name))


def doubling_graph(rounds, like, q, n_steps, ndim, dtype, device,
                   strict=None):
    """The :class:`DoublingGraph` of this round shape from the cache
    ``rounds`` (a dict a sampler keeps; None: a new one, kept nowhere).
    Its key is kept apart from :func:`slice_graph`'s: a sampler that
    switches to doubling in the middle of a run keeps both."""
    key = ("doubling", q, n_steps, ndim, like.npdim, dtype, str(device),
           _mask_key(strict))
    entry = None if rounds is None else rounds.get(key)
    if entry is None or entry.like is not like:
        entry = DoublingGraph(like, DoublingRound(
            q, n_steps, ndim, like.npdim, dtype, device, strict))
        if rounds is not None:
            rounds[key] = entry
    return entry


def doubling_round(like, directions, draw, loglstar, start_u, start_v,
                   start_logl, start_blob=None, *, strict=None,
                   max_shrink_iters=10000, timings=None, rounds=None):
    """The barrier form of the slice round with Neal's (2003) doubling
    procedure: all lanes take their ``n_steps`` slice updates along
    ``directions`` (q, n_steps, ndim, lengths capped) one step at a time.
    Each step starts on the interval ``(-r0, 1 - r0)`` and probes both
    ends; a random side of each lane's interval doubles until both ends
    are outside the slice; shrink candidates are drawn until each lane
    accepts one, each candidate above ``loglstar`` held to the doubling's
    acceptance test, halving by halving.  One host read of a device flag a
    loop turn (``sync_slice``; the shrink loop's first read, which is
    always true, is counted without one).

    ``draw`` is the round's ``torch.Generator`` (each draw a ``uniform_``
    into the round's draw buffer, which draws what ``torch.rand`` draws:
    r0, then each doubling's side for every lane, then each candidate;
    each vector is drawn in the segment before the one that reads it) or
    a function ``draw(what, step, i) -> (q,)``, ``what`` one of ``'r0'``,
    ``'side'``, ``'x'`` and ``i`` the doubling's or candidate's index in
    the step (the tests feed the JAX package's draws: the start and each
    doubling ask for the next side and the step's first candidate, each
    resolution for the next candidate, the step's last one's unread).
    The updates around each likelihood call are the kernels of
    ``ops/proposals.py`` on the card (:class:`DoublingGraph`).  On the
    card, with a generator and a likelihood that may be captured
    (:func:`~.likelihood.graph_capturable`)
    each segment between two reads runs as one CUDA graph replay after one
    eager warm-up of its kind; ``rounds`` is the sampler's cache of round
    shapes (:func:`doubling_graph`), ``strict`` the cube check's bool mask
    (None: every dimension).  Returns ``(state, blob)``, the state as
    ``ops.proposals.DoublingRound`` lays it out (``u, v, logl, nc, n_exp,
    n_con`` among its entries)."""
    q, n_steps, ndim = directions.shape
    entry = doubling_graph(rounds, like, q, n_steps, ndim, directions.dtype,
                           directions.device, strict)
    st = doubling_start(entry, directions, loglstar, start_u, start_v,
                        start_logl, start_blob)
    doubling_loop(entry, draw, max_shrink_iters=max_shrink_iters,
                  timings=timings)
    return st, tree_map(torch.clone, entry.blob)


def doubling_start(entry, directions, loglstar, start_u, start_v,
                   start_logl, start_blob=None, gate=None):
    """Load a round into the round shape ``entry`` (a
    :class:`DoublingGraph`) behind the round gate ``gate``
    (:meth:`DoublingRound.start`); device work only.  Returns the
    state."""
    st = entry.rb.start(start_u, start_v, start_logl, directions, loglstar,
                        gate)
    entry.load_blob(start_blob)
    return st


def doubling_loop(entry, draw, *, max_shrink_iters=10000, timings=None,
                  gate_read=False):
    """The segments of a round loaded into ``entry``
    (:func:`doubling_start`), as :func:`doubling_round` describes.  With
    ``gate_read`` the read after the first step's start also reports the
    round gate: where it is set (no lane probed, none doubles) the read
    counts as ``sync_round`` and the loop stops.  Returns whether it was
    set.  Each step ends with the generator given back its last vector,
    which the probe of a segment that does not follow read."""
    rb = entry.rb
    gen = draw if isinstance(draw, torch.Generator) else None
    use_graph = gen is not None

    def fills(name, s, i):
        """A segment's ``fill`` from the draw function: the start's r0,
        and the next doubling's side (``i`` + 1) with the step's first
        candidate; a resolution's next candidate (``i`` + 1)."""
        def fill(which):
            if not which:
                rb.draw.copy_(draw("r0", s, 0))
                return rb.draw
            if name == "resolve":
                rb.draw.copy_(draw("x", s, i + 1))
                return rb.draw
            rb.draw.copy_(draw("side", s, i + 1))
            rb.draw_x.copy_(draw("x", s, 0))
            return rb.draw_x
        return fill

    def run(name, s=0, i=-1):
        d = gen if gen is not None or name not in entry.DRAWS else \
            fills(name, s, i)
        return entry.run(name, d, use_graph, timings)

    for s in range(rb.n_steps):
        flag, i = run("start", s), 0
        if gate_read and s == 0 and entry.gated:
            entry.rewind(gen)
            _count(timings, "sync_round")
            return True
        while True:
            _count(timings, "sync_slice")
            if not flag:
                break
            flag, i = run("double", s, i), i + 1
        active = True
        for j in range(max_shrink_iters):
            _count(timings, "sync_slice")
            if not active:
                break
            flag = run("candidate")
            while True:
                _count(timings, "sync_slice")
                if not flag:
                    break
                flag = run("halve")
            active = run("resolve", s, j)
        # the step's last vector (its last resolution's, or the one that
        # ran into the shrink cap) is read by no segment
        entry.rewind(gen)
    return False


def make_slice_round(like, *, ndim, q, slices, kind, dtype, device,
                     nonperiodic=None, doubling=False,
                     max_shrink_iters=10000, timings=None, rounds=None):
    """Slice-sampling round.  ``kind='rslice'``: ``slices`` slice updates
    per lane along random directions transformed by the lane's axes.
    ``kind='slice'``: ``slices`` passes over all ``ndim`` principal axes in
    a per-lane shuffled order.  Directions are multiplied by ``scale``.

    Stepping-out mode runs the per-lane state machine (every lane advances
    its own phase through its whole budget of slice updates); with
    ``doubling`` the barrier form runs instead: all lanes take one slice
    update at a time, expanding by Neal's (2003) doubling procedure and
    shrinking with its acceptance test.

    Returns a :class:`SliceRoundFn`, called as ``fn(gen, packed_in,
    start_blob, scale, loglstar) -> (packed (q, ndim + npdim + 5), blob)``
    with columns ``u | v | logl | nc | n_expand | n_contract | warn``;
    ``packed_in`` is ``u | v | logl | axes (ndim*ndim)`` of the start
    points, ``start_blob`` their blobs.  ``nc`` counts out-of-cube probes
    too; ``warn`` flags an interval stepped out more than 1000 times (the
    host then switches to doubling when the dispatch is over)."""
    if kind not in ("slice", "rslice"):
        raise ValueError(f"Unknown slice kind '{kind}'")
    return SliceRoundFn(like, ndim, q, slices, kind, dtype, device,
                        nonperiodic, doubling, max_shrink_iters, timings,
                        rounds)


class SliceRoundFn:
    """The slice round of :func:`make_slice_round` in the parts a fused
    round runs apart: :meth:`prepare` (the round shape's buffers),
    :meth:`begin` (the directions' draws and the round's start, device
    work only: a fused round's prologue captures it), :meth:`loop` (the
    state machine's iterations or the doubling round's segments, one host
    read each) and :meth:`finish` (the packed result, device work only:
    the epilogue captures it).  Calling it runs all four with the gate
    open."""

    gate_read = True

    def __init__(self, like, ndim, q, slices, kind, dtype, device,
                 nonperiodic, doubling, max_shrink_iters, timings, rounds):
        self.like, self.ndim, self.q = like, ndim, q
        self.slices, self.kind, self.dtype = slices, kind, dtype
        self.device = _device_of(device)
        self.nb = _bool_mask(nonperiodic, self.device)
        self.doubling, self.max_shrink_iters = doubling, max_shrink_iters
        self.timings, self.rounds = timings, rounds
        self.maxlen = math.sqrt(ndim) / 2.0
        self.n_steps = slices * ndim if kind == "slice" else slices
        self.entry = None

    def cap(self, directions):
        """Each direction's length capped at the cube diagonal."""
        dirlen = torch.linalg.vector_norm(directions, dim=-1)
        dirnorm = torch.where(dirlen > self.maxlen, dirlen / self.maxlen,
                              1.0)
        return directions / dirnorm[..., None]

    def prepare(self):
        """The round shape's :class:`SliceGraph` or
        :class:`DoublingGraph` (kept as ``entry`` and returned)."""
        make = doubling_graph if self.doubling else slice_graph
        self.entry = make(self.rounds, self.like, self.q, self.n_steps,
                          self.ndim, self.dtype, self.device, self.nb)
        return self.entry

    def begin(self, gen, packed_in, start_blob, scale, loglstar, gate=None):
        ndim, npdim, q, dtype = self.ndim, self.like.npdim, self.q, \
            self.dtype
        start_u = packed_in[:, :ndim].to(dtype)
        start_v = packed_in[:, ndim:ndim + npdim].to(dtype)
        start_logl = packed_in[:, ndim + npdim].to(dtype)
        axes = packed_in[:, ndim + npdim + 1:].reshape(q, ndim, ndim)
        directions = self.cap(slice_directions(
            gen, axes.to(dtype), scale, self.kind, self.slices))
        if self.doubling:
            doubling_start(self.entry, directions, loglstar, start_u,
                           start_v, start_logl, start_blob, gate)
        else:
            r0 = torch.rand((q,), generator=gen, dtype=dtype,
                            device=self.device)
            slice_start(self.entry, directions, r0, loglstar, start_u,
                        start_v, start_logl, start_blob, gate)

    def loop(self, gen, gate_read=False):
        run = doubling_loop if self.doubling else slice_loop
        return run(self.entry, gen, max_shrink_iters=self.max_shrink_iters,
                   timings=self.timings, gate_read=gate_read)

    def finish(self):
        st = self.entry.rb.st
        # the doubling procedure has no expansion warning
        warn = torch.zeros((self.q,), dtype=self.dtype,
                           device=self.device) if self.doubling \
            else st["warn"]
        return pack_columns(self.q, self.dtype, st["u"], st["v"], st["logl"],
                            st["nc"], st["n_exp"], st["n_con"], warn,
                            device=self.device), \
            tree_map(torch.clone, self.entry.blob)

    def __call__(self, gen, packed_in, start_blob, scale, loglstar):
        self.prepare()
        self.begin(gen, packed_in, start_blob, scale, loglstar)
        self.loop(gen)
        return self.finish()
