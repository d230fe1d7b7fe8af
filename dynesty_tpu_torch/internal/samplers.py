"""Host-side drivers of the proposal kernels ("internal samplers").

Each class owns the tuning state (proposal ``scale``, accept/expand
histories) and a cache of built fused round functions from :mod:`.fused`.
Counterpart of ``dynesty_tpu.internal.samplers``: the unit-cube phase,
uniform sampling from the bound ('unif'), random walks ('rwalk'), and
slice sampling along principal axes ('slice') or random directions
('rslice').  ``launch_fused`` runs the dispatch synchronously.
``propose_round`` is the non-fused form: one device round of ``q``
proposals whose rows come back to the host, where the dynamic sampler's
batch seeding pops them one at a time.
"""

import math
import warnings

import numpy as np
import torch

from ..ops.ellipsoid_refit import ellipsoid_refit, refit_buffers
from ..utils.misc import blob_row, tree_map
from .fused import Proposer, make_fused_round, select_starts, unpack_flat
from .kernels import make_rwalk_round, make_slice_round, make_unif_round

__all__ = ["InternalSampler", "UnitCubeSampler", "UniformBoundSampler",
           "RWalkSampler", "SliceSampler", "RSliceSampler",
           "INTERNAL_SAMPLER_LIST", "get_internal_sampler"]

INTERNAL_SAMPLER_LIST = ["rwalk", "unif", "rslice", "slice"]


class InternalSampler:
    """Base class: kwargs (the periodic/reflective/nonbounded masks, ndim
    and ncdim), the proposal scale and the fused-round cache."""

    # cap on fused rounds chained per dispatch (None = the sampler's
    # rounds_per_dispatch)
    max_rounds_per_dispatch = None
    # stop the chain once the host's ncall-cadence refit is due (ctrl[21])
    chain_stop_on_refit_due = False
    name = "?"

    def __init__(self, **kwargs):
        self.scale = 1.0
        self.input_kwargs = kwargs
        self.ndim = kwargs.get("ndim")
        self.ncdim = kwargs.get("ncdim") or self.ndim
        self.sampler_kwargs = {
            k: kwargs.get(k)
            for k in ("nonbounded", "periodic", "reflective", "nonperiodic")}
        self._round_cache = {}
        # the slice state machine's, the random walk's and the uniform
        # waves' buffers and CUDA graphs by round shape (kernels.slice_graph,
        # kernels.rwalk_graph and kernels.unif_graph: their keys start with
        # "rwalk" and "unif"), never pickled
        self._slice_rounds = {}

    def _new_from_template(self, template_kwargs):
        """A fresh instance of this class from its own kwargs plus the
        factory's defaults (boundary masks, ndim), so that two samplers
        never share tuning state."""
        merged = dict(self.input_kwargs)
        for k, v in template_kwargs.items():
            if k not in merged:
                merged[k] = v
        return self.__class__(**merged)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_round_cache"] = {}
        state["_slice_rounds"] = {}
        return state

    def drop_device_state(self):
        """Forget every built round, buffer and CUDA graph (the sampler
        moved to another device)."""
        self._round_cache = {}
        self._slice_rounds = {}

    def _slice_cache(self):
        # checkpoints written before the cache existed lack it
        return self.__dict__.setdefault("_slice_rounds", {})

    @property
    def update_bound_interval_ratio(self):
        """Bound-update cadence in units of ncall per live point."""
        return 1

    def _cached_round(self, key, make):
        fn = self._round_cache.get(key)
        if fn is None:
            fn = self._round_cache[key] = make()
        return fn

    def _gather_starts(self, ns, loglstar, q):
        """``q`` start points among the live points above ``loglstar`` and
        per-lane axes from the current bound, drawn from the host stream
        and packed ``u | v | logl | axes`` for a non-fused round, with the
        starts' blobs (None without blobs).  A start outside the bound
        forces a refit first."""
        valid = np.nonzero(ns.live_logl > loglstar)[0]
        if len(valid) == 0:
            raise RuntimeError(
                "No live points are above loglstar. Do you have a "
                "likelihood plateau, or are you sampling excessively "
                "around the peak of the posterior?")
        idxs = valid[ns.rstate.integers(0, len(valid), size=q)]
        ns.ensure_startpoints_bounded(idxs)
        axes = np.array([ns.bound.get_random_axes(ns.rstate)
                         for _ in range(q)])
        packed = np.concatenate([
            ns.live_u[idxs], ns.live_v[idxs], ns.live_logl[idxs][:, None],
            axes.reshape(q, -1)], axis=1)
        start_blob = tree_map(
            lambda b: torch.as_tensor(np.asarray(b)[idxs], device=ns.device),
            ns.live_blobs)
        return torch.as_tensor(packed, dtype=ns.dtype,
                               device=ns.device), start_blob

    def propose_round(self, ns, loglstar, q, gen):
        """One device round of ``q`` proposals above ``loglstar`` drawn
        from ``gen``; returns (list of per-proposal dicts ``{u, v, logl,
        nc, blob, proposal_stats}``, the round's tuning_info or None)."""
        raise NotImplementedError

    def _build_propose_fn(self, ns, bound_kind):
        """The :class:`~.fused.Proposer` of a fused round."""
        raise NotImplementedError

    def _fused_cfg_key(self):
        return ()

    def _max_rounds(self, ns, bound_kind):
        """Per-configuration cap on chained rounds (None = no cap)."""
        return self.max_rounds_per_dispatch

    def _refit_due_ncall(self, ns):
        """ctrl[21]: the absolute ncall at which the next host refit is
        due, or 2^30 (gate disarmed).  Armed only where the kernel opted
        in, after the unit-cube phase, and while the bound holds more than
        one ellipsoid.  A pure function of the sampler state at launch."""
        if (not self.chain_stop_on_refit_due or ns.unit_cube_sampling
                or getattr(ns.bound, "nells", 1) <= 1):
            return 2.0 ** 30
        return float(min(ns.ncall_at_last_update +
                         ns.bound_update_interval, 2.0 ** 30))

    def get_fused(self, ns, bound_kind):
        """(fused_fn, layout) for the current configuration, cached."""
        rounds = ns.rounds_per_dispatch
        cap = self._max_rounds(ns, bound_kind)
        if cap is not None:
            rounds = min(rounds, cap)
        cfg = ("fused", bound_kind, ns.queue_size, ns.nlive, rounds,
               ns.proposal_mode, self._fused_cfg_key())
        entry = self._round_cache.get(cfg)
        if entry is None:
            entry = make_fused_round(
                self._build_propose_fn(ns, bound_kind), nlive=ns.nlive,
                ndim=self.ndim, npdim=ns.loglikelihood.npdim,
                q=ns.queue_size, dtype=ns.dtype, device=ns.device,
                kind=self.name, rounds=rounds,
                tune_fn=self.device_tune_fn(),
                mode=ns.proposal_mode,
                chain_stop_fn=self.device_chain_stop_fn(),
                timings=ns.timings, cache=self._slice_cache(),
                capture=_capture_rounds(ns))
            self._round_cache[cfg] = entry
        return entry

    def launch_fused(self, ns, seed, live, live_blob, axes_args, integ,
                     limits, rounds_active=None, rounds_skip=0,
                     refit_due_ncall=None):
        """Run one fused dispatch (synchronously: the device work is
        enqueued here and waited for in :meth:`finish_fused`).  ``seed``
        is the dispatch's integer seed, ``live_blob`` the live points'
        blob (None without blobs); ``integ`` and ``limits`` are the
        host vectors of the JAX package's ``launch_fused``, and the
        control vector keeps its layout.  ``rounds_skip`` skips the
        leading rounds (the continuation of an interrupted dispatch, with
        its original seed).  ``refit_due_ncall`` is the ctrl[21] the
        dispatch was planned with; None reads it from the sampler now."""
        if refit_due_ncall is None:
            refit_due_ncall = self._refit_due_ncall(ns)
        fused_fn, layout = self.get_fused(ns, ns.device_bound_kind())
        if rounds_active is None:
            rounds_active = layout["rounds"]
        rounds_active = min(max(int(rounds_active), 1), layout["rounds"])
        ctrl = np.concatenate([
            integ, limits,
            [self.scale, 0.0, float(rounds_active), -1e30,
             float(rounds_skip),
             # [18:21] unit-cube chain-stop gate inputs: ncall at
             # launch, min_ncall, min_eff
             float(ns.ncall), float(ns.first_bound_update_ncall),
             float(ns.first_bound_update_eff),
             # [21] the ncall at which the next host refit is due
             float(refit_due_ncall)]])
        flat, proposals, live_out, blob_out, old_blobs, qblobs = fused_fn(
            seed, live, live_blob, axes_args, ctrl)
        return {"flat": flat, "proposals": proposals, "live": live_out,
                "live_blob": blob_out, "old_blobs": old_blobs,
                "qblobs": qblobs, "layout": layout,
                "rounds_active": rounds_active}

    def finish_fused(self, handle):
        """Download the flat result; returns (unpacked dict, live, live
        blob).  The dict keeps the device proposals block and blobs
        (``proposals_dev``, ``old_blobs_dev``, ``qblob_dev``)."""
        flat = handle["flat"].cpu().numpy()
        out = unpack_flat(flat, handle["layout"])
        out["proposals_dev"] = handle["proposals"]
        out["old_blobs_dev"] = handle["old_blobs"]
        out["qblob_dev"] = handle["qblobs"]
        return out, handle["live"], handle["live_blob"]

    def run_fused(self, ns, seed, live, live_blob, axes_args, integ, limits,
                  rounds_active=None, rounds_skip=0, refit_due_ncall=None):
        """Launch and finish one fused dispatch."""
        return self.finish_fused(self.launch_fused(
            ns, seed, live, live_blob, axes_args, integ, limits,
            rounds_active=rounds_active, rounds_skip=rounds_skip,
            refit_due_ncall=refit_due_ncall))

    def get_replay(self, ns):
        """(fused_fn, layout) of the consume-only round that replays given
        proposal entries (the leftover tail of an interrupted round)."""
        cfg = ("replay", ns.queue_size, ns.nlive, ns.proposal_mode)
        entry = self._round_cache.get(cfg)
        if entry is None:
            entry = make_fused_round(
                _ReplayProposer(ns.dtype, ns.device,
                                self.ndim + ns.loglikelihood.npdim),
                kind="replay", nlive=ns.nlive, ndim=self.ndim,
                npdim=ns.loglikelihood.npdim, q=ns.queue_size,
                dtype=ns.dtype, device=ns.device, mode=ns.proposal_mode,
                timings=ns.timings, cache=self._slice_cache(),
                capture=_capture_rounds(ns))
            self._round_cache[cfg] = entry
        return entry

    def run_replay(self, ns, live, live_blob, prop, prop_blob, integ, limits,
                   kills0=0, birth0=-1e30):
        """Consume the (queue_size, ndim + npdim + 4) proposal block
        ``prop`` (with its blob ``prop_blob``) against ``live``; no random
        number is drawn.  Returns (unpacked dict, live, live blob)."""
        fused_fn, layout = self.get_replay(ns)
        ctrl = np.concatenate([integ, limits,
                               [self.scale, float(kills0), 1.0,
                                max(float(birth0), -1e30), 0.0,
                                0.0, 0.0, 0.0]])
        flat, proposals, live_out, blob_out, old_blobs, qblobs = fused_fn(
            0, live, live_blob, {"prop": prop, "prop_blob": prop_blob},
            ctrl)
        out = unpack_flat(flat.cpu().numpy(), layout)
        out["stats"] = None
        out["proposals_dev"] = proposals
        out["old_blobs_dev"] = old_blobs
        out["qblob_dev"] = qblobs
        return out, live_out, blob_out

    def device_tune_fn(self):
        """``(scale, stats_vec) -> scale`` on device tensors, applied
        between chained rounds; None if the kernel has no tuning."""
        return None

    def device_chain_stop_fn(self):
        """``(integ, counters, ctrl) -> bool tensor`` evaluated at every
        chained round's start (``ctrl`` the control vector as a device
        tensor of the live matrix's type); None = no gate."""
        return None

    def apply_fused_tuning(self, out):
        """Adopt the tuning outcome of one fused dispatch on the host."""
        if self.device_tune_fn() is not None:
            self.scale = float(out["scale_final"])
            self._post_fused_stats(out.get("stats"))
        elif out.get("stats") is not None:
            tinfo = self.consume_tuning(out["stats"])
            if tinfo is not None:
                self.tune(tinfo, update=True)

    def _post_fused_stats(self, stats):
        """Kernel-specific bookkeeping from the dispatch's stats."""

    def end_dispatch(self):
        """Apply what a whole dispatch decided, once it is over: after its
        continuation, when it was interrupted."""

    def consume_tuning(self, stats):
        """The dispatch's stats vector as a tuning_info dict (kernel
        specific); None if the kernel has no tuning."""
        return None

    def tune(self, tuning_info, update=False):
        """Accumulate round statistics; apply the scale update if
        ``update``."""

    def row_stats(self, a, b):
        """Per-record proposal_stats from the two lane-stat columns."""
        return {"n_proposals": max(int(a), 1)}

    @property
    def citations(self):
        """(name, link) pairs of the method's references."""
        return []


def _capture_rounds(ns):
    """Whether the fused rounds of ``ns`` may capture their prologue and
    epilogue (they call no likelihood): on one device, not a mesh of
    several."""
    mesh = getattr(ns, "mesh", None)
    return mesh is None or mesh.size <= 1


class _ReplayProposer(Proposer):
    """The consume-only round's proposals: the given block
    ``axes_args['prop']`` (``u | v | logl | nc | lane stats``) and its
    blob ``axes_args['prop_blob']``; no draw, no loop."""

    capturable = True

    def __init__(self, dtype, device, il):
        self.dtype, self.device, self.il = dtype, device, il

    def prepare(self, live, axes_args):
        return self

    def begin(self, *args):
        pass

    def loop(self, gen):
        return False

    def finish(self, axes_args):
        prop, il = axes_args["prop"], self.il
        stats = (torch.zeros((), dtype=self.dtype, device=self.device),)
        return (prop, axes_args.get("prop_blob"),
                prop[:, il + 1].to(torch.int64), stats,
                prop[:, il + 2:il + 4])


class _StartsProposer(Proposer):
    """The proposals of a slice or walk round (``inner``, a
    :class:`~.kernels.SliceRoundFn` or :class:`~.kernels.RWalkRoundFn`)
    from ``q`` start rows drawn among the live points above the threshold
    (:func:`~.fused.select_starts`), packed ``u | v | logl | axes``;
    ``split(packed) -> (qnc, stats, lane_stats)`` reads the round's
    result."""

    capturable = True

    def __init__(self, inner, ns, bound_kind, eye_dim, split):
        self.inner, self.split = inner, split
        self.gate_read = inner.gate_read
        self.q, self.dtype = ns.queue_size, ns.dtype
        self.il = inner.ndim + ns.loglikelihood.npdim
        self.bound_kind, self.eye_dim = bound_kind, eye_dim

    def prepare(self, live, axes_args):
        return self.inner.prepare()

    def begin(self, gen, live, live_blob, axes_args, scale, loglstar, gate):
        q, il = self.q, self.il
        idxs, starts, axes = select_starts(
            gen, live, il, q, self.bound_kind, axes_args, self.dtype,
            eye_dim=self.eye_dim, loglstar=loglstar)
        packed_in = torch.cat([starts[:, :il + 1], axes.reshape(q, -1)],
                              dim=1)
        self.inner.begin(gen, packed_in,
                         tree_map(lambda b: b[idxs], live_blob), scale,
                         loglstar, gate)

    def loop(self, gen):
        return self.inner.loop(gen, gate_read=True)

    def finish(self, axes_args):
        packed, blob = self.inner.finish()
        return (packed, blob) + tuple(self.split(packed))


class _UnifProposer(Proposer):
    """The proposals of a uniform round (``inner``, a
    :class:`~.kernels.UnifRoundFn`) drawn from the dispatch's bound, or,
    for an ellipsoid stack (``refit``), from the stack re-fitted to the
    live points, every round from the dispatch's fit, by the round's
    prologue (:func:`~dynesty_tpu_torch.ops.ellipsoid_refit.
    ellipsoid_refit`: on the card two kernels that the prologue's capture
    records, writing straight into the wave's buffers)."""

    capturable = True
    gate_read = True

    def __init__(self, inner, ns, refit, ncdim):
        self.inner, self.refit, self.ncdim = inner, refit, ncdim
        self.il = inner.ndim + ns.loglikelihood.npdim
        # the refit's scratch by shape, kept as long as the rounds whose
        # captured prologues hold its addresses
        self._refits = {}
        self.rf = None

    def prepare(self, live, axes_args):
        # the refit keeps the arrays' shapes: the wave shape is the
        # dispatch's, and the prologue fills its buffers
        entry = self.inner.prepare(axes_args, load=not self.refit)
        if self.refit:
            self.rf = refit_buffers(self._refits, live.shape[0], entry.rb.m,
                                    self.ncdim, self.inner.dtype,
                                    self.inner.device)
        return entry

    def begin(self, gen, live, live_blob, axes_args, scale, loglstar, gate):
        if self.refit:
            ellipsoid_refit(self.rf, live[:, :self.ncdim], axes_args,
                            self.inner.entry.rb.arrays)
        self.inner.begin(loglstar, gate)

    def loop(self, gen):
        return self.inner.loop(gen, gate_read=True)

    def finish(self, axes_args):
        packed, blob = self.inner.finish()
        il = self.il
        qnc = packed[:, il + 1].to(torch.int64)
        stats = (packed[0, il + 2], packed[0, il + 3], packed[0, il + 4])
        lane_stats = torch.stack(
            [qnc.to(packed.dtype), torch.zeros_like(packed[:, 0])], dim=1)
        return packed, blob, qnc, stats, lane_stats


def _unpack_rows(out, ndim, npdim, extra_names, stats_fn, nc_from):
    """Split the output ``(packed (q, W), blob)`` of a round, columns ``u
    | v | logl | extras``, into a first-in-first-out list of proposal
    dicts (the blob row by row); also returns the extras columns by
    name."""
    packed, blob = out
    packed = packed.cpu().numpy().astype(np.float64)
    blob = tree_map(lambda b: b.cpu().numpy(), blob)
    il = ndim + npdim
    extras = {name: packed[:, il + 1 + j]
              for j, name in enumerate(extra_names)}
    rows = [{"u": packed[i, :ndim], "v": packed[i, ndim:il],
             "logl": packed[i, il], "nc": int(nc_from(i, extras)),
             "blob": blob_row(blob, i),
             "proposal_stats": stats_fn(i, extras)}
            for i in range(packed.shape[0])]
    return rows, extras


def _unif_rows(out, ndim, npdim, q):
    """Rows of a uniform round (columns ``... | nc | nc_total |
    n_proposals | n_filled``); raises if the round did not fill."""
    rows, extras = _unpack_rows(
        out, ndim, npdim, ("nc", "nc_total", "n_prop", "n_filled"),
        lambda i, e: {"n_proposals": max(int(e["n_prop"][0]) // q, 1)},
        nc_from=lambda i, e: e["nc"][i])
    n_filled = int(extras["n_filled"][0])
    if n_filled < q:
        raise RuntimeError("Uniform sampling failed to find enough "
                           f"points above loglstar ({n_filled}/{q}).")
    _warn_unif_inefficiency(int(extras["n_prop"][0]), q)
    return rows, None


def _warn_unif_inefficiency(n_prop, q):
    """Warn when a uniform fill took 10000 or more candidates per slot
    (one wave is one candidate per lane)."""
    if n_prop >= 10000 * q:
        warnings.warn("Uniform bound sampling is extremely inefficient "
                      f"({n_prop} candidates for {q} accepted points)",
                      category=RuntimeWarning)


def _unif_propose_fn(sampler, ns, bound_kind):
    """The propose function of the uniform kernels.  Ellipsoid stacks are
    re-fitted to the live points in every chained round's prologue."""
    like = ns.loglikelihood
    ndim, q = sampler.ndim, ns.queue_size
    il = ndim + like.npdim
    # the unit cube spans every dimension; a bound only the clustered ones
    ncdim = ndim if bound_kind == "cube" else sampler.ncdim
    nonbounded = None if bound_kind == "cube" else \
        sampler.sampler_kwargs.get("nonbounded")

    def host_sampler():
        # a user's bound may give float64 points outside the cube, or
        # every dimension where it bounds the first ncdim
        return np.asarray(ns.bound.samples(q, rstate=ns.rstate))[:, :ncdim]

    inner = make_unif_round(like, ndim=ndim, ncdim=ncdim, q=q,
                            bound_kind=bound_kind, nonbounded=nonbounded,
                            dtype=ns.dtype, device=ns.device,
                            timings=ns.timings,
                            rounds=sampler._slice_cache(),
                            host_sampler=host_sampler
                            if bound_kind == "custom" else None)
    return _UnifProposer(inner, ns, bound_kind == "ellipsoids", ncdim)


class UnitCubeSampler(InternalSampler):
    """Rejection sampling from the whole unit cube (active before the
    first bound update)."""

    name = "unitcube"
    max_rounds_per_dispatch = 8

    def _build_propose_fn(self, ns, bound_kind):
        return _unif_propose_fn(self, ns, "cube")

    def propose_round(self, ns, loglstar, q, gen):
        like = ns.loglikelihood
        fn = self._cached_round(
            ("cube", q),
            lambda: make_unif_round(like, ndim=self.ndim, ncdim=self.ndim,
                                    q=q, bound_kind="cube", dtype=ns.dtype,
                                    device=ns.device, timings=ns.timings,
                                    rounds=self._slice_cache()))
        return _unif_rows(fn(gen, loglstar, {}), self.ndim, like.npdim, q)

    def device_chain_stop_fn(self):
        """First-bound-update trigger: stop chaining once the efficiency
        drops below min_eff with at least min_ncall calls spent (inputs
        from ctrl[18:21], a device tensor of the live matrix's type)."""
        def gate(integ, counters, ctrl):
            # the count in the live matrix's type, as the JAX package's:
            # in a float32 run exact up to 2**24 (16.8 M) calls, past it
            # the stop may move by a round (bench.py's 25-D headline
            # spends 2.3 M)
            ncall_now = ctrl[18] + counters["nc_used"].to(
                integ["logz"].dtype)
            eff = 100.0 * (integ["it"].to(ncall_now.dtype) - 1.0) / \
                ncall_now.clamp_min(1.0)
            return (eff < ctrl[20]) & (ncall_now >= ctrl[19])
        return gate


class UniformBoundSampler(InternalSampler):
    """Uniform sampling within the current bounding distribution
    ('unif').

    Ellipsoid stacks chain up to ``unif_max_chain`` rounds per dispatch
    (each re-fitted to the live points on the device first), or the
    sampler's whole ``rounds_per_dispatch`` where the user set it;
    friends bounds take fresh centres from the host every dispatch and
    run one round, and so does a custom bound, whose waves draw through
    its ``samples`` on the host.  The chain stops at the first round
    boundary where the cumulative ncall reaches the host refit cadence
    (ctrl[21])."""

    name = "unif"
    chain_stop_on_refit_due = True
    unif_max_chain = 8

    def _max_rounds(self, ns, bound_kind):
        if bound_kind == "ellipsoids":
            # an explicit rounds_per_dispatch (expensive likelihoods:
            # dispatch amortization beats bound staleness) is honoured
            if ns.rounds_explicit:
                return None
            # a dynamic batch runs narrow bracketed rounds and chains
            # deeper: its configurator sets the sampler's unif_chain_cap
            return ns.unif_chain_cap or self.unif_max_chain
        return 1

    def _build_propose_fn(self, ns, bound_kind):
        return _unif_propose_fn(self, ns, bound_kind)

    def propose_round(self, ns, loglstar, q, gen):
        like = ns.loglikelihood
        kind = ns.device_bound_kind()
        if kind == "custom":
            # as in the JAX package: the non-fused round (a dynamic
            # batch's seeding) has no host-sampled form
            raise RuntimeError(
                f"Bound {type(ns.bound).__name__} has no device sampling "
                "spec; use rwalk/rslice/slice with custom bounds.")
        fn = self._cached_round(
            (kind, q),
            lambda: make_unif_round(
                like, ndim=self.ndim, ncdim=self.ncdim, q=q,
                bound_kind=kind,
                nonbounded=self.sampler_kwargs.get("nonbounded"),
                dtype=ns.dtype, device=ns.device, timings=ns.timings,
                rounds=self._slice_cache()))
        return _unif_rows(fn(gen, loglstar, ns.device_bound_arrays()),
                          self.ndim, like.npdim, q)

    def device_chain_stop_fn(self):
        """Host-refit-due trigger: stop the chain at the first round
        boundary whose cumulative ncall reaches ctrl[21] (``ctrl`` a device
        tensor of the live matrix's type)."""
        def gate(integ, counters, ctrl):
            # float32 counts exactly up to 2**24 calls (as the unit-cube
            # gate above)
            ncall_now = ctrl[18] + counters["nc_used"].to(
                integ["logz"].dtype)
            return ncall_now >= ctrl[21]
        return gate

    def consume_tuning(self, stats):
        # stats = (nc_total, n_proposals, n_filled) summed over rounds: no
        # scale tuning, only the rejection-inefficiency warning
        _warn_unif_inefficiency(int(stats[1]), max(int(stats[2]), 1))
        return None


class RWalkSampler(InternalSampler):
    """Random walks within the scaled bounding ellipsoid ('rwalk')."""

    name = "rwalk"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        walks = max(2, kwargs.get("walks") or 25)
        facc = kwargs.get("facc") or 0.5
        self.walks = walks
        self.facc = min(1.0, max(1.0 / walks, facc))
        self.rwalk_history = {"n_accept": 0, "n_reject": 0}

    @property
    def update_bound_interval_ratio(self):
        return self.walks

    def _fused_cfg_key(self):
        return (self.walks, self.facc, self.ncdim)

    def device_tune_fn(self):
        facc0, ncdim = self.facc, self.ncdim

        def tune_fn(scale, stats):  # stats = (n_accept, n_reject, ...)
            facc = stats[0] / (stats[0] + stats[1]).clamp_min(1.0)
            return scale * torch.exp((facc - facc0) / ncdim / facc0)

        return tune_fn

    def _build_propose_fn(self, ns, bound_kind):
        like = ns.loglikelihood
        ndim, ncdim, q = self.ndim, self.ncdim, ns.queue_size
        il = ndim + like.npdim
        walks = self.walks
        inner = make_rwalk_round(
            like, ndim=ndim, ncdim=ncdim, q=q, walks=walks,
            nonbounded=self.sampler_kwargs.get("nonbounded"),
            periodic=self.sampler_kwargs.get("periodic"),
            reflective=self.sampler_kwargs.get("reflective"),
            dtype=ns.dtype, device=ns.device, timings=ns.timings,
            rounds=self._slice_cache())

        def split(packed):
            qnc = torch.full((q,), walks, dtype=torch.int64,
                             device=packed.device)
            stats = (packed[:, il + 1].sum(), packed[:, il + 2].sum())
            return qnc, stats, packed[:, il + 1:il + 3]

        return _StartsProposer(inner, ns, bound_kind, ncdim, split)

    def propose_round(self, ns, loglstar, q, gen):
        like = ns.loglikelihood
        packed_in, start_blob = self._gather_starts(ns, loglstar, q)
        fn = self._cached_round(
            ("rwalk", q, self.walks),
            lambda: make_rwalk_round(
                like, ndim=self.ndim, ncdim=self.ncdim, q=q,
                walks=self.walks,
                nonbounded=self.sampler_kwargs.get("nonbounded"),
                periodic=self.sampler_kwargs.get("periodic"),
                reflective=self.sampler_kwargs.get("reflective"),
                dtype=ns.dtype, device=ns.device, timings=ns.timings,
                rounds=self._slice_cache()))
        rows, extras = _unpack_rows(
            fn(gen, packed_in, start_blob, self.scale, loglstar), self.ndim,
            like.npdim, ("n_accept", "n_reject"),
            lambda i, e: self.row_stats(e["n_accept"][i], e["n_reject"][i]),
            nc_from=lambda i, e: self.walks)
        return rows, {"accept": int(extras["n_accept"].sum()),
                      "reject": int(extras["n_reject"].sum()),
                      "scale": self.scale}

    def consume_tuning(self, stats):
        return {"accept": int(stats[0]), "reject": int(stats[1]),
                "scale": self.scale}

    def row_stats(self, a, b):
        """Per-record proposal_stats from the two lane-stat columns."""
        return {"n_accept": int(a), "n_reject": int(b)}

    @property
    def citations(self):
        return [("Skilling (2006)", "projecteuclid.org/euclid.ba/1340370944")]

    def tune(self, tuning_info, update=True):
        """Newton-like scale update toward the target acceptance rate
        (the host form of :meth:`device_tune_fn`)."""
        self.scale = tuning_info["scale"]
        hist = self.rwalk_history
        hist["n_accept"] += tuning_info["accept"]
        hist["n_reject"] += tuning_info["reject"]
        if not update:
            return
        accept, reject = hist["n_accept"], hist["n_reject"]
        facc = accept / max(accept + reject, 1)
        self.scale *= math.exp((facc - self.facc) / self.ncdim / self.facc)
        hist["n_accept"] = 0
        hist["n_reject"] = 0


class _SliceBase(InternalSampler):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.slices = kwargs.get("slices") or 5
        self.slice_history = {"n_expand": 0, "n_contract": 0}
        # a dispatch asked for the doubling procedure (end_dispatch)
        self._doubling_due = False
        self.sampler_kwargs.setdefault("slice_doubling",
                                       kwargs.get("slice_doubling", False))

    def _fused_cfg_key(self):
        return (self.slices,
                bool(self.sampler_kwargs.get("slice_doubling", False)))

    def device_tune_fn(self):
        def tune_fn(scale, stats):  # stats = (n_expand, n_contract, ...)
            nexp = stats[0].clamp_min(1.0)
            mult = (2.0 * nexp / (nexp + stats[1])).clamp(0.5, 2.0)
            return scale * mult
        return tune_fn

    def _post_fused_stats(self, stats):
        # the switch waits for the end of the dispatch: the continuation of
        # an interrupted one runs the kernel that the dispatch started with
        if stats is not None and bool(stats[2] > 0):
            self._doubling_due = True

    def end_dispatch(self):
        if getattr(self, "_doubling_due", False) and \
                not self.sampler_kwargs.get("slice_doubling", False):
            self.sampler_kwargs["slice_doubling"] = True
            warnings.warn("Slice interval expanded > 1000 times; enabling "
                          "Neal (2003) doubling strategy.")
        self._doubling_due = False

    def _build_propose_fn(self, ns, bound_kind):
        like = ns.loglikelihood
        ndim, q = self.ndim, ns.queue_size
        il = ndim + like.npdim
        inner = make_slice_round(
            like, ndim=ndim, q=q, slices=self.slices, kind=self.name,
            nonperiodic=self.sampler_kwargs.get("nonperiodic"),
            doubling=bool(self.sampler_kwargs.get("slice_doubling", False)),
            dtype=ns.dtype, device=ns.device, timings=ns.timings,
            rounds=self._slice_cache())

        def split(packed):
            stats = (packed[:, il + 2].sum(), packed[:, il + 3].sum(),
                     packed[:, il + 4].max())
            return (packed[:, il + 1].to(torch.int64), stats,
                    packed[:, il + 2:il + 4])

        return _StartsProposer(inner, ns, bound_kind, ndim, split)

    def propose_round(self, ns, loglstar, q, gen):
        like = ns.loglikelihood
        packed_in, start_blob = self._gather_starts(ns, loglstar, q)
        doubling = bool(self.sampler_kwargs.get("slice_doubling", False))
        fn = self._cached_round(
            (self.name, q, self.slices, doubling),
            lambda: make_slice_round(
                like, ndim=self.ndim, q=q, slices=self.slices,
                kind=self.name,
                nonperiodic=self.sampler_kwargs.get("nonperiodic"),
                doubling=doubling, dtype=ns.dtype, device=ns.device,
                timings=ns.timings, rounds=self._slice_cache()))
        rows, extras = _unpack_rows(
            fn(gen, packed_in, start_blob, self.scale, loglstar), self.ndim,
            like.npdim, ("nc", "n_expand", "n_contract", "warn"),
            lambda i, e: self.row_stats(e["n_expand"][i],
                                        e["n_contract"][i]),
            nc_from=lambda i, e: e["nc"][i])
        tuning_info = self.consume_tuning(
            (extras["n_expand"].sum(), extras["n_contract"].sum(),
             extras["warn"][0]))
        if tuning_info["expansion_warning_set"]:
            warnings.warn("Slice interval expanded > 1000 times; enabling "
                          "Neal (2003) doubling strategy.")
        return rows, tuning_info

    def consume_tuning(self, stats):
        return {"n_expand": int(stats[0]), "n_contract": int(stats[1]),
                "expansion_warning_set": bool(stats[2] > 0)}

    def row_stats(self, a, b):
        """Per-record proposal_stats from the two lane-stat columns."""
        return {"n_expand": int(a), "n_contract": int(b)}

    @property
    def citations(self):
        return [("Neal (2003)", "projecteuclid.org/euclid.aos/1056562461"),
                ("Handley, Hobson & Lasenby (2015)",
                 "ui.adsabs.harvard.edu/abs/2015MNRAS.453.4384H")]

    def tune(self, tuning_info, update=True):
        """Multiplicative scale update from the balance of expansions and
        contractions (the host form of :meth:`device_tune_fn`)."""
        hist = self.slice_history
        hist["n_expand"] += tuning_info["n_expand"]
        hist["n_contract"] += tuning_info["n_contract"]
        if tuning_info.get("expansion_warning_set"):
            self.sampler_kwargs["slice_doubling"] = True
        if not update:
            return
        n_expand = max(hist["n_expand"], 1)
        mult = n_expand * 2.0 / (n_expand + hist["n_contract"])
        self.scale = self.scale * min(max(mult, 0.5), 2.0)
        hist["n_expand"] = 0
        hist["n_contract"] = 0


class SliceSampler(_SliceBase):
    """Gibbs-style multivariate slice sampling along shuffled principal
    axes ('slice')."""

    name = "slice"

    @property
    def update_bound_interval_ratio(self):
        return self.slices * self.ndim


class RSliceSampler(_SliceBase):
    """Slice sampling along random axes-transformed directions
    ('rslice')."""

    name = "rslice"

    @property
    def update_bound_interval_ratio(self):
        return self.slices


def get_internal_sampler(sample, ndim, **kwargs):
    """Resolve a sampler spec ('auto', a name or an instance) to a fresh
    instance, with the reference's auto rules: unif for ndim < 10, rwalk
    for 10 <= ndim <= 20, rslice above."""
    if isinstance(sample, InternalSampler):
        return sample._new_from_template(dict(kwargs, ndim=ndim))
    if sample == "auto":
        sample = "unif" if ndim < 10 else "rwalk" if ndim <= 20 \
            else "rslice"
    kwargs = dict(kwargs, ndim=ndim)
    if sample == "unif":
        return UniformBoundSampler(**kwargs)
    if sample == "rwalk":
        if kwargs.get("walks") is None:
            kwargs["walks"] = ndim + 20
        return RWalkSampler(**kwargs)
    if sample == "slice":
        if kwargs.get("slices") is None:
            kwargs["slices"] = 3
        return SliceSampler(**kwargs)
    if sample == "rslice":
        if kwargs.get("slices") is None:
            kwargs["slices"] = 3 + ndim
        return RSliceSampler(**kwargs)
    raise ValueError(f"Unknown sample option '{sample}' (choose from "
                     f"{INTERNAL_SAMPLER_LIST} or pass an InternalSampler "
                     "instance)")
