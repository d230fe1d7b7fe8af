"""Fused proposal+consume rounds: the nested-sampling inner loop of one
queue refill, on the sampler's device (counterpart of
``dynesty_tpu.internal.fused``).

A round proposes ``q`` points at the round's threshold, then consumes
them in order: worst-point selection, plateau handling, the streaming
trapezoid evidence update, live-point replacement and the stopping
checks.  ``fused`` chains ``rounds`` such rounds and packs everything into
one flat float vector with the JAX package's layout (:func:`unpack_flat`).

A round is three parts (the JAX package's ``one_round``, ``:146``, run
under its ``lax.cond`` gate, ``:629``):

* the prologue: the round gate (the dispatch's sticky ``done`` and
  chain-stop flags), the batch threshold or the queue minimum, and the
  proposal's start (:meth:`Proposer.begin`: ``select_starts``, the start
  rows packed into the proposal loop's buffers, their blobs, the draws
  the loop starts from), all device work;
* the proposal loop (:meth:`Proposer.loop`), from the host, whose first
  flag read also reports the gate (the walk reads the gate on its own);
* the epilogue: the proposals packed, the consume scan
  (``ops.consume.consume_round``, which chooses the thin or the general
  scan on the device), the record and live assembly
  (``ops.consume.round_assemble``, writing straight into the dispatch's
  output buffers), the blob gathers, the integrator and counter updates,
  the tuning, all device work.

The dispatch's state (live set, integrator, counters, scale) and outputs
live in device buffers made once per dispatch shape (:class:`RoundState`).
On the card the prologue and the epilogue are each captured once per
round shape as a CUDA graph and replayed (``n_round_graph``,
``n_round_replay``), after one eager round of the shape; a mesh of
several devices, a proposer that may not be captured, and a capture
that raises keep the eager round.  The gate is sticky, so once a
read finds it set the host skips the dispatch's later rounds without a
read (``Timings['sync_round']`` counts the reads that found it, and on
the CPU the thin-path choice); ``Timings['n_round']`` counts the rounds
consumed.  The packed stop bitmask is read once per dispatch.

Blobs live in tensors of their own beside the float64 live matrix and
records (a blob's dtype is the user's): the live set's blob flows from
round to round, and every round yields the blob of each dead point and
of each proposal, gathered and scattered with the indices of the live
matrix.

Every chained round draws from its own ``torch.Generator``, seeded from
the dispatch's integer seed and the round's index (:func:`round_seed`), as
the JAX dispatch splits its key into one key per round: a continuation
that skips the first rounds of an interrupted dispatch gives the later
rounds the streams they had.
"""

import math
import warnings

import numpy as np
import torch

from ..ops import consume as _consume
from ..ops.consume import (STATE_KEYS, assemble_buffers, consume_round,
                           device_limits, round_assemble)
from ..utils.convert import integ_from_vector
from ..utils.misc import blob_where, torch_generator, tree_map

__all__ = ["make_fused_round", "unpack_flat", "record_columns",
           "select_starts", "round_seed", "Proposer", "RoundState"]

# Test knob: fused rounds without the thin scalar consume path (batch
# mode then always runs the general scan; the kernel is told so).  Read
# per round.
_FORCE_GENERAL_CONSUME = False

_NEG_INF = -math.inf
_INTEG_KEYS = ("logz", "logzvar", "h", "logvol", "loglstar",
               "plateau_mode", "plateau_counter", "plateau_logdvol", "it")
_COUNTER_KEYS = ("n_acc", "n_cons", "nc_accum", "nc_used", "done",
                 "reason")


def record_columns(ndim, npdim):
    """Names of the packed per-iteration record columns."""
    return (["worst"] + [f"u{i}" for i in range(ndim)] +
            [f"v{i}" for i in range(npdim)] +
            ["logl", "logvol", "logwt", "logz", "logzvar", "h", "nc",
             "worst_it", "boundidx", "n", "birth"])


def round_seed(seed, ridx):
    """The 63-bit generator seed of round ``ridx`` of the dispatch seeded
    with ``seed``: a pure function of both, so a round's stream does not
    depend on which rounds ran before it."""
    state = np.random.SeedSequence([int(seed), int(ridx)]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


class Proposer:
    """A round's proposals in the parts :func:`make_fused_round` runs
    apart.  ``prepare(live, axes_args)`` runs on the host's command
    before the prologue (the loop's round shape; work that cannot be
    captured) and returns the loop's round-shape object, which keys the
    round's graphs; ``begin(gen, live, live_blob, axes_args, scale,
    loglstar, gate)`` and ``finish(axes_args) -> (packed, qblob, qnc,
    stats, lane_stats)`` do device work only (``packed[:, :ndim + npdim
    + 1]`` the proposals' ``u | v | logl``); ``loop(gen)`` runs the
    proposal loop and returns whether its first read found the round gate
    set (``gate_read``; False: the loop reads no flag and the round reads
    the gate itself).  ``capturable``: begin and finish may be captured."""

    gate_read = False
    capturable = False


class RoundState:
    """The device state and outputs of a dispatch's rounds, made once per
    dispatch shape: the live matrix (``live``) and its blob
    (``live_blob``), the bound's arrays (``axes``), the integrator and
    counter 0-d tensors (``integ``, ``counters``, the sticky
    ``chain_stop``, the round's first kill count ``racc``), ``scale``,
    ``birth0``, the round index ``ridx`` (the epilogue advances it), the
    control vector in the live matrix's type (``ctrl``), the consume
    scan's device limits (``limits``), the assembly's output buffers
    (``out``, :func:`~dynesty_tpu_torch.ops.consume.assemble_buffers`),
    each round's stats (``stats``) and the dead points' and proposals'
    blobs (``old_blobs``, ``qblobs``); and the round graphs by the fused
    function that captured them and the loop's round shape (``graphs``).
    Fused functions of one shape share a state: each loads it whole at
    the start of its dispatch."""

    def __init__(self, nlive, ndim, npdim, q, rounds, dtype, device,
                 live_blob, axes_args, n_ctrl):
        i64 = torch.int64

        def e(shape=(), dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        def like(t):
            return torch.empty_like(t, memory_format=torch.contiguous_format)

        def rows(b):
            return torch.empty((rounds * q,) + tuple(b.shape[1:]),
                               dtype=b.dtype, device=device)

        self.live = e((nlive, ndim + npdim + 4))
        self.live_blob = tree_map(like, live_blob)
        self.axes = tree_map(like, axes_args)
        self.integ = {k: e((), torch.bool if k == "plateau_mode" else
                           i64 if k in ("plateau_counter", "it") else dtype)
                      for k in _INTEG_KEYS}
        self.counters = {k: e((), torch.bool if k == "done" else i64)
                         for k in _COUNTER_KEYS}
        self.chain_stop = e((), torch.bool)
        self.racc, self.ridx = e((), i64), e((), i64)
        self.scale, self.birth0 = e(), e()
        self.ctrl = e((n_ctrl,))
        self.limits = e((5,), i64)
        # the limits as numbers, for the consume scan's plain loop
        self.limit_values = None
        self.out = assemble_buffers(rounds, q, nlive, ndim, npdim, dtype,
                                    device)
        self.stats = e((rounds, 4))
        self.old_blobs = tree_map(rows, live_blob)
        self.qblobs = tree_map(rows, live_blob)
        self.graphs = {}

    def consume_state(self):
        """The consume scan's carried state (``STATE_KEYS``): views of
        the buffers."""
        st = dict(self.integ, **self.counters, racc=self.racc)
        return {k: st[k] for k in STATE_KEYS}


def _shape_key(tree):
    """The shapes and dtypes of a blob or a dict of arrays, as a key."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return tuple(_shape_key(t) for t in tree)
    if isinstance(tree, dict):
        return tuple((k, _shape_key(v)) for k, v in sorted(tree.items()))
    return (tuple(tree.shape), tree.dtype)


class RoundGraphs:
    """The prologue and epilogue of one round shape (a dispatch shape and
    the loop's round-shape object ``entry``) of one fused function
    (``owner``: a capture bakes in its proposer, tuning and chain-stop
    functions) on the card, captured as CUDA
    graphs once the shape has run one round eagerly (``warm``), on a
    side stream, with the generator the prologue draws from.  A capture
    that raises leaves the shape eager for good (warned once, naming the
    error).  ``P`` holds the captured prologue's outputs, which the
    epilogue reads."""

    def __init__(self, owner, entry, device, capturable):
        self.owner, self.entry = owner, entry
        self.capturable = capturable
        self.warm = False
        self.prologue = self.epilogue = self.P = None
        self.stream = torch.cuda.Stream(device) if capturable else None
        self.gen = torch.Generator(device=device) if capturable else None

    def on_side_stream(self, fn):
        """``fn()`` on the side stream, ordered after and before the
        current stream's work (the eager round before the capture)."""
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = fn()
        main.wait_stream(self.stream)
        return out

    def capture(self, prologue, epilogue, counted, shape):
        """Capture ``prologue(gen)`` and ``epilogue(P)`` (``P`` what the
        captured prologue returns); True when both were.  A capture runs
        nothing, so what it counted (the ``counted`` wrappers'
        ``launches`` and ``calls``) is put back."""
        main = torch.cuda.current_stream(self.stream.device)
        saved = [(w, dict(w.__dict__)) for w in counted]
        pro, epi = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        self.stream.wait_stream(main)
        try:
            pro.register_generator_state(self.gen)
            with torch.cuda.stream(self.stream):
                pro.capture_begin(capture_error_mode="thread_local")
                try:
                    P = prologue(self.gen)
                finally:
                    pro.capture_end()
                epi.capture_begin(capture_error_mode="thread_local")
                try:
                    epilogue(P)
                finally:
                    epi.capture_end()
        except Exception as err:  # noqa: BLE001 - reported, then eager
            self.capturable = False
            warnings.warn(
                f"the fused round's prologue and epilogue could not be "
                f"captured as CUDA graphs ({type(err).__name__}: {err}); "
                f"rounds of shape {shape} run eagerly", RuntimeWarning)
            return False
        finally:
            for w, d in saved:
                for k in ("launches", "calls"):
                    if k in d:
                        setattr(w, k, d[k])
            main.wait_stream(self.stream)
        self.prologue, self.epilogue, self.P = pro, epi, P
        return True

    def replay_prologue(self, gen):
        """The prologue by replay, drawing from ``gen``'s stream where the
        eager prologue would (the graph's generator takes its seed and
        offset before and gives the offset back after); waits for
        nothing.  Returns the captured prologue's outputs."""
        self.gen.manual_seed(gen.initial_seed())
        self.gen.set_offset(gen.get_offset())
        self.prologue.replay()
        gen.set_offset(self.gen.get_offset())
        return self.P

    def replay_epilogue(self):
        """The epilogue by replay; waits for nothing."""
        self.epilogue.replay()


def make_fused_round(propose_fn, *, nlive, ndim, npdim, q, dtype, device,
                     kind="?", rounds=1, tune_fn=None, mode="batch",
                     chain_stop_fn=None, timings=None, cache=None,
                     capture=True):
    """Wrap a proposal round into a chained propose+consume call.

    ``propose_fn`` is a :class:`Proposer`.  ``mode='batch'`` kills
    the ``q`` worst live points per round and refills them at the shared
    threshold (needs ``q < nlive``); ``mode='queue'`` consumes the
    proposals against the rising threshold at constant live count.
    ``tune_fn(scale, stats)`` updates the proposal scale between rounds;
    ``chain_stop_fn(integ, counters, ctrl)`` (``ctrl`` the control vector
    as a device tensor of the live matrix's type) skips the round it fires
    at and all later ones (bit 32 of the reported reason).  Every round
    past an in-flight stop is skipped too, whatever the kernel: a round
    that starts behind the gate proposes nothing, its loop's first read
    (or, for a loop that reads no flag, the round's own read) tells the
    host, and the host skips the dispatch's later rounds; a dispatch
    stopped by maxiter/maxcall then strands no round (an interrupted and
    resumed run bills exactly the evaluations of the uninterrupted one).

    ``kind='replay'`` marks a consume-only round whose proposals are given
    (the leftover tail of an interrupted round): its refills are born at
    ``birth0`` (ctrl[16], the interrupted round's threshold), its kill
    count starts at ``kills0`` (ctrl[14]), and it never takes the thin
    path.

    ``cache`` keeps the dispatch shapes' :class:`RoundState` and graphs
    (a dict the sampler keeps, never pickled; None: a dict of this
    function's own).  ``capture`` False keeps every round eager (a mesh
    of several devices).

    Returns ``(fused, layout)`` with ``fused(seed, live, live_blob,
    axes_args, ctrl) -> (flat, proposals, live_out, live_blob_out,
    old_blobs, qblobs)``; ``seed`` is the dispatch's integer seed and
    ``ctrl`` the host (numpy) control vector of
    ``InternalSampler.launch_fused``.  ``live_blob`` is the live points'
    blob (None without blobs); ``old_blobs`` holds the blob of each
    record's dead point and ``qblobs`` that of each proposal, row for row
    with the records and the proposals block.
    """
    assert mode in ("batch", "queue")
    if mode == "batch" and q >= nlive:
        raise ValueError(
            f"batch mode needs q < nlive (got q={q}, nlive={nlive})")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not isinstance(propose_fn, Proposer):
        raise TypeError(f"make_fused_round takes a Proposer, got "
                        f"{type(propose_fn).__name__}")
    proposer = propose_fn
    # the key of this function's graphs in a shared state
    owner = object()
    capture = capture and proposer.capturable and device.type == "cuda"
    cache = {} if cache is None else cache
    il = ndim + npdim  # logl column
    width = 1 + ndim + npdim + 11
    i64 = torch.int64
    lanes = torch.arange(q, dtype=i64, device=device)
    # queue mode's shrinkage, computed on the host as the JAX package does
    dlv_default = float(np.log1p(1.0 / nlive))
    # the wrappers whose counts a capture puts back and a replay adds to
    # (the wrappers themselves: a caller may swap the names this module
    # calls for its own spies)
    counted = (_consume.consume_round, _consume.round_assemble)

    def count(key, n=1):
        if timings is not None:
            timings.count(key, n)

    def prologue(S, gen):
        """The round gate, the threshold and the proposal's start; device
        work only.  Returns what the loop and the epilogue read."""
        gate = S.counters["done"]
        if chain_stop_fn is not None:
            # evaluated at every round boundary; once fired, the round
            # and all later rounds run and bill nothing
            integ = dict(S.integ)
            trig = S.chain_stop | chain_stop_fn(integ, S.counters, S.ctrl)
            S.chain_stop.copy_(trig)
            gate = trig | S.counters["done"]
        live_logl0 = S.live[:, il].contiguous()
        P = {"gate": gate, "live_logl0": live_logl0}
        if mode == "batch":
            # shared kill threshold: the q-th smallest live logl, or the
            # largest value strictly below the maximum when a plateau
            # reaches into the kill set
            sorted_logl, sort_idx = torch.sort(live_logl0, stable=True)
            lmax = sorted_logl[-1]
            cand = sorted_logl[q - 1]
            fallback = torch.where(live_logl0 < lmax, live_logl0,
                                   _NEG_INF).max()
            loglstar0 = torch.where(cand < lmax, cand, fallback)
            P.update(sorted_logl=sorted_logl, sort_idx=sort_idx, lmax=lmax,
                     cand=cand)
        else:
            loglstar0 = live_logl0.min()
        # replayed entries were proposed at the interrupted round's
        # threshold; the live set here is already partly refilled, so its
        # own threshold would overstate the births
        P["loglstar0"] = loglstar0
        P["birth_new"] = S.birth0 if kind == "replay" else loglstar0
        proposer.begin(gen, S.live, S.live_blob, S.axes, S.scale, loglstar0,
                       gate)
        return P

    def epilogue(S, P):
        """The proposals packed, the consume scan, the assembly, the blob
        gathers, the state's updates and the tuning; device work only."""
        packed, qblob, qnc, stats, lane_stats = proposer.finish(S.axes)
        qnc = qnc.to(i64)
        qlogl = packed[:, il]
        loglstar0 = P["loglstar0"]
        thin = None
        if mode == "batch" and kind != "replay" and \
                not _FORCE_GENERAL_CONSUME:
            # every proposal beats every victim: thin scalar scan.  The
            # kernel reads the flag on the card, the plain loop on the host
            thin_ok = (P["cand"] < P["lmax"]) & (qlogl.min() > loglstar0)
            if device.type != "cuda":
                thin_ok = bool(thin_ok)
                count("sync_round")
            thin = (P["sort_idx"], P["sorted_logl"], thin_ok)
        st0 = S.consume_state()
        was_done = S.counters["done"].clone()
        it0 = S.integ["it"].clone()
        n_acc0 = S.counters["n_acc"].clone()
        limits = {"dlogz": S.limit_values[0], "logl_max": S.limit_values[1],
                  "max_accepts": S.limit_values[2],
                  "max_nc": S.limit_values[3], "device": S.limits}
        outs, st = consume_round(st0, P["live_logl0"], qlogl.contiguous(),
                                 qnc.contiguous(), limits,
                                 batch=mode == "batch",
                                 dlv_default=dlv_default, thin=thin)
        worsts, srcs = outs[0], outs[1]
        if S.live_blob is not None:
            # blobs take the same gathers: the dead point's from the live
            # set or from the proposal that refilled its slot (before the
            # live set's blob is refilled)
            from_orig = srcs < 0
            srcc = srcs.clamp(min=0)
            old = blob_where(from_orig,
                             tree_map(lambda b: b[worsts], S.live_blob),
                             tree_map(lambda b: b[srcc], qblob))
            rows = S.ridx * q + lanes
            tree_map(lambda d, b: d.index_copy_(0, rows, b), S.old_blobs,
                     old)
            tree_map(lambda d, b: d.index_copy_(0, rows, b), S.qblobs,
                     qblob)
        round_assemble(outs, S.live, packed, qnc, lane_stats, it0,
                       P["birth_new"], loglstar0, S.out, S.ridx, ndim=ndim)
        if S.live_blob is not None:
            last = S.out["last"]
            lastc = last.clamp(min=0)
            new = blob_where(last >= 0, tree_map(lambda b: b[lastc], qblob),
                             S.live_blob)
            tree_map(lambda d, b: d.copy_(b), S.live_blob, new)
        S.integ["it"].copy_(it0 + (st["n_acc"] - n_acc0))
        for k in _INTEG_KEYS[:-1]:
            S.integ[k].copy_(st[k])
        for k in _COUNTER_KEYS:
            S.counters[k].copy_(st[k])
        S.racc.zero_()
        stats_vec = torch.zeros((4,), dtype=dtype, device=device)
        stats_vec[:len(stats)] = torch.stack(
            [torch.as_tensor(s, device=device).to(dtype) for s in stats])
        S.stats.index_copy_(0, S.ridx.view(1), stats_vec.view(1, 4))
        if tune_fn is not None:
            S.scale.copy_(torch.where(was_done, S.scale,
                                      tune_fn(S.scale, stats_vec).to(dtype)))
        S.ridx.add_(1)

    def state_for(live_blob, axes_args, n_ctrl):
        key = ("round", kind, mode, nlive, ndim, npdim, q, rounds, dtype,
               str(device), _shape_key(live_blob), _shape_key(axes_args),
               n_ctrl)
        S = cache.get(key)
        if S is None:
            S = cache[key] = RoundState(nlive, ndim, npdim, q, rounds, dtype,
                                        device, live_blob, axes_args, n_ctrl)
        return S

    def load(S, live, live_blob, axes_args, ctrl, rounds_skip):
        """The dispatch's inputs into the state's buffers, the outputs
        zeroed; once a dispatch."""
        S.live.copy_(live)
        tree_map(lambda d, b: d.copy_(b), S.live_blob, live_blob)
        tree_map(lambda d, b: d.copy_(b), S.axes, axes_args)
        integ = integ_from_vector(ctrl, device, dtype)
        for k in _INTEG_KEYS:
            S.integ[k].copy_(integ[k])
        for t in (*S.counters.values(), S.chain_stop):
            t.zero_()
        S.racc.fill_(int(ctrl[14]) if rounds_skip == 0 else 0)
        S.ridx.fill_(rounds_skip)
        S.scale.fill_(float(ctrl[13]))
        S.birth0.fill_(float(ctrl[16] if len(ctrl) > 16 else ctrl[4]))
        S.ctrl.copy_(torch.as_tensor(ctrl, dtype=dtype))
        S.limit_values = (float(ctrl[9]), float(ctrl[10]), int(ctrl[11]),
                          int(ctrl[12]))
        limits = dict(zip(("dlogz", "logl_max", "max_accepts", "max_nc"),
                          S.limit_values))
        S.limits.copy_(device_limits(limits, dlv_default, dtype))
        for t in (*S.out.values(), S.stats):
            t.zero_()
        tree_map(torch.Tensor.zero_, S.old_blobs)
        tree_map(torch.Tensor.zero_, S.qblobs)

    def run_round(S, ridx, seed):
        """One round; returns whether the round gate was found set."""
        gen = torch_generator(round_seed(seed, ridx), device)
        entry = proposer.prepare(S.live, S.axes)
        gkey = (id(owner), id(entry))
        g = S.graphs.get(gkey)
        if g is None or g.owner is not owner or g.entry is not entry:
            g = S.graphs[gkey] = RoundGraphs(owner, entry, device, capture)
        if g.capturable and g.warm and g.prologue is None:
            if g.capture(lambda gen_: prologue(S, gen_),
                         lambda P_: epilogue(S, P_), counted,
                         (nlive, q, rounds, mode)):
                count("n_round_graph")
        replay = g.capturable and g.prologue is not None
        if replay:
            P = g.replay_prologue(gen)
        elif g.capturable:
            P = g.on_side_stream(lambda: prologue(S, gen))
        else:
            P = prologue(S, gen)
        if proposer.gate_read:
            gated = proposer.loop(gen)
        else:
            # a loop that reads no flag: the round reads its gate
            gated = bool(P["gate"])
            count("sync_round")
            if not gated:
                proposer.loop(gen)
        if gated:
            return True
        count("n_round")
        if replay:
            g.replay_epilogue()
            # the replay ran the kernels without Python
            counted[0].calls += 1
            for w in counted:
                w.launches += 1
            count("n_round_replay")
        elif g.capturable:
            g.on_side_stream(lambda: epilogue(S, P))
            g.warm = True
        else:
            epilogue(S, P)
        return False

    def fused(seed, live, live_blob, axes_args, ctrl):
        ctrl = np.asarray(ctrl, dtype=np.float64)
        rounds_active = int(ctrl[15])
        rounds_skip = int(ctrl[17]) if len(ctrl) > 17 else 0
        S = state_for(live_blob, axes_args, len(ctrl))
        load(S, live, live_blob, axes_args, ctrl, rounds_skip)
        gated, ran = False, False
        for ridx in range(rounds_skip, min(rounds, rounds_active)):
            gated = run_round(S, ridx, seed)
            ran = True
            if gated:
                break
        if chain_stop_fn is not None and not gated and \
                (not ran or min(rounds, rounds_active) < rounds):
            # the gate is evaluated at every round boundary, the skipped
            # rounds' too
            S.chain_stop.copy_(S.chain_stop | chain_stop_fn(
                dict(S.integ), S.counters, S.ctrl))
        return finish(S, ctrl)

    def finish(S, ctrl):
        integ, counters, out = S.integ, S.counters, S.out
        integ_vec = torch.stack([
            integ["logz"], integ["logzvar"], integ["h"], integ["logvol"],
            integ["loglstar"], integ["plateau_mode"].to(dtype),
            integ["plateau_counter"].to(dtype), integ["plateau_logdvol"],
            (int(ctrl[8]) + counters["n_acc"]).to(dtype)])
        proposals = out["props"]
        # likelihood evaluations launched this dispatch, consumed or not
        nc_launched = proposals[:, ndim + npdim + 1].sum()
        reason_out = counters["reason"]
        if chain_stop_fn is not None:
            reason_out = reason_out + 32 * S.chain_stop.to(i64)
        info_vec = torch.stack([x.to(dtype) for x in (
            counters["n_acc"], counters["nc_used"], counters["done"],
            counters["n_cons"], reason_out, S.scale, nc_launched)])
        stats_vec = S.stats.sum(dim=0)
        flat = torch.cat([out["recs"].reshape(-1), integ_vec, info_vec,
                          stats_vec, out["accepts"], out["dlogz"],
                          out["lane"].reshape(-1), out["thresholds"]])
        # copies: the next dispatch of the shape refills the buffers
        return (flat, proposals.clone(), S.live.clone(),
                tree_map(torch.clone, S.live_blob),
                tree_map(torch.clone, S.old_blobs),
                tree_map(torch.clone, S.qblobs))

    layout = {
        "rec_shape": (rounds * q, width),
        "prop_shape": (rounds * q, ndim + npdim + 4),
        "n_integ": 9, "n_info": 7, "n_stats": 4,
        "q": rounds * q, "rounds": rounds, "ndim": ndim, "npdim": npdim,
    }
    return fused, layout


def unpack_flat(flat, layout):
    """Split the fused call's flat output (host numpy) into named parts."""
    q, w = layout["rec_shape"]
    pos = 0
    recs = flat[pos:pos + q * w].reshape(q, w); pos += q * w
    integ = flat[pos:pos + layout["n_integ"]]; pos += layout["n_integ"]
    info = flat[pos:pos + layout["n_info"]]; pos += layout["n_info"]
    stats = flat[pos:pos + layout["n_stats"]]; pos += layout["n_stats"]
    accepts = flat[pos:pos + q] > 0.5; pos += q
    delta_logz = flat[pos:pos + q]; pos += q
    lane_stats = flat[pos:pos + q * 2].reshape(q, 2); pos += q * 2
    rounds = layout.get("rounds", 1)
    round_thresholds = flat[pos:pos + rounds]; pos += rounds
    return {
        "records": recs,
        "integ": {
            "logz": integ[0], "logzvar": integ[1], "h": integ[2],
            "logvol": integ[3], "loglstar": integ[4],
            "plateau_mode": bool(integ[5] > 0.5),
            "plateau_counter": int(integ[6]),
            "plateau_logdvol": integ[7], "it": int(integ[8]),
        },
        "n_accepted": int(info[0]),
        "nc_used": int(info[1]),
        "done": bool(info[2] > 0.5),
        "n_consumed": int(info[3]),
        "done_reason": int(info[4]),
        "scale_final": float(info[5]),
        "nc_launched": int(info[6]),
        "stats": stats,
        "accepts": accepts,
        "delta_logz": delta_logz,
        "lane_stats": lane_stats,
        "round_thresholds": round_thresholds,
    }


# --------------------------------------------------------------------------
# device-side start/axes selection


def select_starts(gen, live, logl_col, q, bound_kind, axes_args, dtype,
                  eye_dim=None, loglstar=None):
    """Pick ``q`` start rows among live points above ``loglstar`` (default:
    the live minimum) and per-lane axes from the bound (a volume-weighted
    ellipsoid choice for ellipsoid stacks; the dispatch's one set of axes,
    broadcast, for friends and custom bounds)."""
    live_logl = live[:, logl_col]
    if loglstar is None:
        loglstar = live_logl.min()
    valid = live_logl > loglstar
    # degenerate plateau (nothing strictly above): any start will do —
    # the consume loop stops on the plateau cause before using them
    valid = valid | ~valid.any()
    idxs = torch.multinomial(valid.to(dtype), q, replacement=True,
                             generator=gen)
    starts = live[idxs]
    if bound_kind == "ellipsoids":
        logp = torch.where(axes_args["mask"], axes_args["logvols"], _NEG_INF)
        ell_idx = torch.multinomial(torch.exp(logp - logp.max()), q,
                                    replacement=True, generator=gen)
        axes = axes_args["axes"].to(dtype)[ell_idx]
    elif bound_kind in ("balls", "cubes", "custom"):
        a = axes_args["axes"].to(dtype)
        axes = a.expand((q,) + tuple(a.shape))
    else:  # unit cube: identity axes
        axes = torch.eye(eye_dim, dtype=dtype, device=live.device).expand(
            q, eye_dim, eye_dim)
    return idxs, starts, axes
