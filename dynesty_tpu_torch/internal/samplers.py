"""Host-side drivers of the proposal kernels ("internal samplers").

Each class owns the tuning state (proposal ``scale``) and a cache of
built fused round functions from :mod:`.fused`.  Counterpart of
``dynesty_tpu.internal.samplers``; only the unit-cube phase and rslice
are ported so far.  ``launch_fused`` runs the dispatch synchronously.
"""

import numpy as np
import torch

from .fused import make_fused_round, select_starts, unpack_flat
from .kernels import make_slice_round, make_unif_round

__all__ = ["InternalSampler", "UnitCubeSampler", "RSliceSampler",
           "get_internal_sampler"]


class InternalSampler:
    """Base class: kwargs, the proposal scale and the fused-round cache."""

    # cap on fused rounds chained per dispatch (None = the sampler's
    # rounds_per_dispatch)
    max_rounds_per_dispatch = None
    # skip chained rounds past an in-flight stop (rejection kernels)
    gate_rounds_on_done = False
    name = "?"

    def __init__(self, **kwargs):
        self.scale = 1.0
        self.ndim = kwargs.get("ndim")
        self.sampler_kwargs = {"nonperiodic": kwargs.get("nonperiodic")}
        self._round_cache = {}

    @property
    def update_bound_interval_ratio(self):
        """Bound-update cadence in units of ncall per live point."""
        return 1

    def _build_propose_fn(self, ns, bound_kind):
        raise NotImplementedError

    def _fused_cfg_key(self):
        return ()

    def get_fused(self, ns, bound_kind):
        """(fused_fn, layout) for the current configuration, cached."""
        rounds = ns.rounds_per_dispatch
        if self.max_rounds_per_dispatch is not None:
            rounds = min(rounds, self.max_rounds_per_dispatch)
        cfg = ("fused", bound_kind, ns.queue_size, ns.nlive, rounds,
               ns.proposal_mode, self._fused_cfg_key())
        entry = self._round_cache.get(cfg)
        if entry is None:
            entry = make_fused_round(
                self._build_propose_fn(ns, bound_kind), nlive=ns.nlive,
                ndim=self.ndim, npdim=ns.loglikelihood.npdim,
                q=ns.queue_size, dtype=ns.dtype, device=ns.device,
                rounds=rounds, tune_fn=self.device_tune_fn(),
                mode=ns.proposal_mode,
                chain_stop_fn=self.device_chain_stop_fn(),
                gate_on_done=self.gate_rounds_on_done, timings=ns.timings)
            self._round_cache[cfg] = entry
        return entry

    def launch_fused(self, ns, gen, live, axes_args, integ, limits,
                     rounds_active=None, rounds_skip=0):
        """Run one fused dispatch (synchronously: the device work is
        enqueued here and waited for in :meth:`finish_fused`).  ``integ``
        and ``limits`` are the host vectors of the JAX package's
        ``launch_fused``; the control vector keeps its layout."""
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
             # [21] refit-due ncall (disarmed: only the unported
             # multi-ellipsoid unif kernel arms it)
             2.0 ** 30]])
        flat, proposals, live_out = fused_fn(gen, live, axes_args, ctrl)
        return {"flat": flat, "proposals": proposals, "live": live_out,
                "layout": layout, "rounds_active": rounds_active}

    def finish_fused(self, handle):
        """Download the flat result; returns (unpacked dict, live)."""
        flat = handle["flat"].cpu().numpy()
        out = unpack_flat(flat, handle["layout"])
        out["proposals_dev"] = handle["proposals"]
        return out, handle["live"]

    def run_fused(self, ns, gen, live, axes_args, integ, limits,
                  rounds_active=None, rounds_skip=0):
        """Launch and finish one fused dispatch."""
        return self.finish_fused(self.launch_fused(
            ns, gen, live, axes_args, integ, limits,
            rounds_active=rounds_active, rounds_skip=rounds_skip))

    def device_tune_fn(self):
        """``(scale, stats_vec) -> scale`` on device tensors, applied
        between chained rounds; None if the kernel has no tuning."""
        return None

    def device_chain_stop_fn(self):
        """``(integ, counters, ctrl) -> bool tensor`` evaluated at every
        chained round's start; None = no gate."""
        return None

    def apply_fused_tuning(self, out):
        """Adopt the tuning outcome of one fused dispatch on the host."""
        if self.device_tune_fn() is not None:
            self.scale = float(out["scale_final"])
            self._post_fused_stats(out.get("stats"))

    def _post_fused_stats(self, stats):
        """Kernel-specific bookkeeping from the dispatch's stats."""


class UnitCubeSampler(InternalSampler):
    """Rejection sampling from the whole unit cube (active before the
    first bound update)."""

    name = "unitcube"
    max_rounds_per_dispatch = 8

    def _build_propose_fn(self, ns, bound_kind):
        like = ns.loglikelihood
        ndim, q = self.ndim, ns.queue_size
        il = ndim + like.npdim
        inner = make_unif_round(like, ndim=ndim, q=q, bound_kind="cube",
                                dtype=ns.dtype, device=ns.device,
                                timings=ns.timings)

        def propose(gen, live, axes_args, scale, loglstar):
            packed = inner(gen, loglstar)
            qnc = packed[:, il + 1].to(torch.int64)
            stats = (packed[0, il + 2], packed[0, il + 3],
                     packed[0, il + 4])
            lane_stats = torch.stack(
                [qnc.to(packed.dtype), torch.zeros_like(packed[:, 0])],
                dim=1)
            return (packed[:, :ndim], packed[:, ndim:il], packed[:, il],
                    qnc, stats, lane_stats)

        return propose

    def device_chain_stop_fn(self):
        """First-bound-update trigger: stop chaining once the efficiency
        drops below min_eff with at least min_ncall calls spent (inputs
        from ctrl[18:21])."""
        def gate(integ, counters, ctrl):
            ncall_now = float(ctrl[18]) + counters["nc_used"].to(
                integ["logz"].dtype)
            eff = 100.0 * (integ["it"].to(ncall_now.dtype) - 1.0) / \
                ncall_now.clamp_min(1.0)
            return (eff < float(ctrl[20])) & (ncall_now >= float(ctrl[19]))
        return gate


class _SliceBase(InternalSampler):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.slices = kwargs.get("slices") or 5
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
        if stats is not None and bool(stats[2] > 0) and \
                not self.sampler_kwargs.get("slice_doubling", False):
            import warnings
            self.sampler_kwargs["slice_doubling"] = True
            warnings.warn("Slice interval expanded > 1000 times; enabling "
                          "Neal (2003) doubling strategy.")

    def _build_propose_fn(self, ns, bound_kind):
        like = ns.loglikelihood
        ndim, q = self.ndim, ns.queue_size
        il = ndim + like.npdim
        inner = make_slice_round(
            like, ndim=ndim, q=q, slices=self.slices, kind=self.name,
            nonperiodic=self.sampler_kwargs.get("nonperiodic"),
            doubling=bool(self.sampler_kwargs.get("slice_doubling", False)),
            dtype=ns.dtype, device=ns.device, timings=ns.timings)

        def propose(gen, live, axes_args, scale, loglstar):
            idxs, starts, axes = select_starts(
                gen, live, il, q, bound_kind, axes_args, ns.dtype,
                eye_dim=ndim, loglstar=loglstar)
            packed_in = torch.cat([starts[:, :il + 1], axes.reshape(q, -1)],
                                  dim=1)
            packed = inner(gen, packed_in, scale, loglstar)
            qnc = packed[:, il + 1].to(torch.int64)
            stats = (packed[:, il + 2].sum(), packed[:, il + 3].sum(),
                     packed[:, il + 4].max())
            return (packed[:, :ndim], packed[:, ndim:il], packed[:, il],
                    qnc, stats, packed[:, il + 2:il + 4])

        return propose

    def row_stats(self, a, b):
        """Per-record proposal_stats from the two lane-stat columns."""
        return {"n_expand": int(a), "n_contract": int(b)}


class RSliceSampler(_SliceBase):
    """Slice sampling along random axes-transformed directions
    ('rslice')."""

    name = "rslice"

    @property
    def update_bound_interval_ratio(self):
        return self.slices


def get_internal_sampler(sample, ndim, **kwargs):
    """Resolve a sampler name ('auto' or 'rslice'; the other kernels are
    not yet ported) to an instance, with the JAX package's auto rules."""
    if isinstance(sample, InternalSampler):
        return sample
    if sample == "auto":
        sample = "unif" if ndim < 10 else "rwalk" if ndim <= 20 \
            else "rslice"
    if sample == "rslice":
        if kwargs.get("slices") is None:
            kwargs["slices"] = 3 + ndim
        return RSliceSampler(**dict(kwargs, ndim=ndim))
    if sample in ("unif", "rwalk", "slice"):
        raise NotImplementedError(f"sample='{sample}' is not yet ported")
    raise ValueError(f"Unknown sample option '{sample}'")

