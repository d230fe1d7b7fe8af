"""Dynamic nested sampling: adaptive live-point allocation driven by
posterior/evidence weight functions, with ESS-based stopping (counterpart
of ``dynesty_tpu.dynamicsampler``).

Host-level orchestration over the static
:class:`~dynesty_tpu_torch.sampler.Sampler`, whose proposal rounds run on
the device.  Control flow mirrors the reference ``dynamicsampler.py``: a
baseline run, then batches bracketed by log-likelihood bounds chosen by
``weight_function``, merged into the combined run by a stable sort with
plateau-aware volume assignment, until ``stopping_function`` fires.  Every
batch is a ``Sampler.sample(logl_max=..., resume=...)`` over live points
seeded from the saved run; the merge, the weights and the stopping value
are float64 numpy on the host.  A batch stopped by ``maxiter``/``maxcall``
stays suspended in the pickled state and finishes bit for bit with
``add_batch(resume=True)``.  Blobs ride with the seeds and the records;
the pool passes to every inner sampler, and the Monte Carlo realisations
of ``stopping_function`` map over it where ``use_pool['stop_function']``.
"""

import copy
import math
import sys
import time
import warnings
from enum import Enum

import numpy as np
import torch

from .ops.integrals import compute_integrals, get_neff_from_logwt
from .sampler import (Sampler, check_mesh_support,
                      initialize_live_points)
from .utils.checkpoint import restore_sampler, save_sampler
from .utils.misc import (DelayTimer, IteratorResult, IteratorResultShort,
                         Timings, get_print_func, get_random_generator,
                         get_seed_sequence, stack_blob_rows)
from .utils.results import Results, RunRecord
from .utils.runs import _kld_error

__all__ = [
    "DynamicSampler", "DynamicSamplerStatesEnum", "weight_function",
    "stopping_function", "compute_weights",
]


class DynamicSamplerStatesEnum(Enum):
    INIT = 1
    LIVEPOINTSINIT = 2
    INBASE = 3
    BASE_DONE = 4
    INBATCH = 5
    BATCH_DONE = 6
    INBASEADDLIVE = 7
    INBATCHADDLIVE = 8
    RUN_DONE = 9


def compute_weights(results):
    """Evidence (remaining-mass) and posterior (importance) weights of
    each sample (reference ``dynamicsampler.py:48-81``)."""
    logl = np.asarray(results["logl"])
    logz = np.asarray(results["logz"])
    logvol = np.asarray(results["logvol"])
    logwt = np.asarray(results["logwt"])
    samples_n = np.asarray(results["samples_n"])

    if np.ptp(logz) == 0:
        warnings.warn("All samples share the same logz; the weight "
                      "calculation degenerates (check your likelihood).")
        zweight = np.ones(len(logl)) / len(logl)
    else:
        logz_remain = logl[-1] + logvol[-1]
        logz_tot = np.logaddexp(logz[-1], logz_remain)
        # ln(remaining evidence) = ln(exp(logz_tot) - exp(logz))
        diff = np.clip(logz - logz_tot, None, 0.0)
        with np.errstate(divide="ignore"):
            logzin = logz_tot + np.log1p(-np.exp(diff))
        logzweight = logzin - np.log(samples_n)
        m = logzweight.max()
        logzweight -= m + np.log(np.exp(logzweight - m).sum())
        zweight = np.exp(logzweight)

    pweight = np.exp(logwt - logz[-1])
    pweight /= pweight.sum()
    return zweight, pweight


def weight_function(results, args=None, return_weights=False):
    """Default batch-targeting function: combined weight
    ``pfrac * pweight + (1-pfrac) * zweight``; returns the logl interval
    where the weight exceeds ``maxfrac`` of its max, padded by ``pad``
    samples on each side (reference ``dynamicsampler.py:84-170``)."""
    args = args or {}
    pfrac = args.get("pfrac", 0.8)
    if not 0.0 <= pfrac <= 1.0:
        raise ValueError(f"pfrac {pfrac} not in [0, 1]")
    maxfrac = args.get("maxfrac", 0.8)
    if not 0.0 <= maxfrac <= 1.0:
        raise ValueError(f"maxfrac {maxfrac} not in [0, 1]")
    lpad = args.get("pad", 1)
    if lpad < 0:
        raise ValueError(f"pad {lpad} negative")

    zweight, pweight = compute_weights(results)
    weight = (1.0 - pfrac) * zweight + pfrac * pweight

    nsamps = len(weight)
    # Threshold on the weight DENSITY per unit log-volume: per-sample
    # pweight carries a 1/n_i volume-share factor, so under a varying
    # live-point profile (the batch-mode sawtooth, or mixed-nlive
    # dynamic runs) the raw per-sample weights are modulated by up to
    # 2x independent of the posterior.  Multiplying by samples_n
    # removes that modulation (zweight already divides by samples_n in
    # the same spirit); at constant nlive this is EXACTLY the reference
    # rule (``dynamicsampler.py:84-170``), and for varying profiles it
    # keeps the selected logl bracket density-independent.  (A
    # deficit-style rule — density divided by a smoothed allocation
    # profile — was evaluated and rejected: once a few batches have
    # equalized the per-sample weights, the whole run clears the
    # maxfrac threshold and the final batches degenerate to near-full
    # re-runs.)
    n_prof = np.asarray(results["samples_n"], dtype=np.float64)
    pdens = pweight * n_prof
    psum = pdens.sum()
    if psum > 0:
        pdens = pdens / psum
    wdens = (1.0 - pfrac) * zweight + pfrac * pdens
    sel = np.nonzero(wdens > maxfrac * wdens.max())[0]
    bounds = [sel[0] - lpad, sel[-1] + lpad]
    logl = np.asarray(results["logl"])
    if bounds[1] > nsamps - 1:
        bounds = [bounds[0] - (bounds[1] - (nsamps - 1)), nsamps - 1]
    if bounds[0] <= 0:
        logl_min = -np.inf
        logl_max = logl[min(bounds[1] - bounds[0], nsamps - 1)]
    else:
        logl_min, logl_max = logl[bounds[0]], logl[bounds[1]]
    if bounds[1] == nsamps - 1:
        logl_max = np.inf
    if return_weights:
        return (logl_min, logl_max), (pweight, zweight, weight)
    return (logl_min, logl_max)


def stopping_function(results, args=None, rstate=None, mapper=None,
                      return_vals=False):
    """Default stop rule: ``stop = pfrac * target_neff/neff +
    (1-pfrac) * logzerr/evid_thresh <= 1`` with optional Monte Carlo
    realizations of logz error (reference ``dynamicsampler.py:173-297``)."""
    args = args or {}
    if mapper is None:
        mapper = map
    pfrac = args.get("pfrac", 1.0)
    if not 0.0 <= pfrac <= 1.0:
        raise ValueError(f"pfrac {pfrac} not in [0, 1]")
    evid_thresh = args.get("evid_thresh", 0.1)
    if pfrac < 1.0 and evid_thresh < 0.0:
        raise ValueError("evid_thresh must be non-negative")
    target_n_effective = args.get("target_n_effective", 10000)
    if pfrac > 0.0 and target_n_effective < 0:
        raise ValueError("target_n_effective must be non-negative")
    n_mc = args.get("n_mc", 0)
    if n_mc < 0:
        raise ValueError("n_mc must be >= 0")
    if 0 < n_mc < 20:
        warnings.warn("Few MC realizations; stopping value estimates will "
                      "be noisy.")
    error = args.get("error", "jitter")
    if error not in ("jitter", "resample"):
        raise ValueError(f"Invalid error option {error}")
    approx = args.get("approx", True)

    if n_mc > 1:
        seeds = get_seed_sequence(rstate, n_mc)
        mc_args = [(results, error, approx, s) for s in seeds]
        outputs = list(mapper(_kld_error, mc_args))
        lnz_arr = np.array([out[1]["logz"][-1] for out in outputs])
        lnz_std = np.std(lnz_arr)
    else:
        lnz_std = results["logzerr"][-1]
    stop_evid = lnz_std / evid_thresh
    n_effective = get_neff_from_logwt(results["logwt"])
    stop_post = target_n_effective / n_effective
    stop = pfrac * stop_post + (1.0 - pfrac) * stop_evid
    if return_vals:
        return stop <= 1.0, (stop_post, stop_evid, stop)
    return stop <= 1.0


def _configure_batch_sampler(main_sampler, nlive_new, update_interval,
                             logl_bounds=None, save_bounds=None):
    """Build the inner Sampler for one batch: pick the logl bracket,
    seed its live points (fresh from the prior if the bracket reaches
    -inf, else volume-weighted resampling of saved dead points plus
    constrained sampling through one non-fused proposal round), and
    truncate its saved run to the join point (reference
    ``dynamicsampler.py:300-622``).  Every step draws from the main
    sampler's ``rstate`` in a fixed order, so the host side of a batch is
    a pure function of the pickled state."""
    ncall = 0
    niter = 0
    saved_u = np.array(main_sampler.saved_run["u"])
    saved_v = np.array(main_sampler.saved_run["v"])
    saved_logl = np.array(main_sampler.saved_run["logl"])
    saved_logvol = np.array(main_sampler.saved_run["logvol"])
    saved_scale = np.array(main_sampler.saved_run["scale"])
    saved_blobs = main_sampler.saved_run["blob"]
    blob = main_sampler.blob
    first_points = []

    # main_sampler.live_init is a placeholder: the live set is replaced
    # below (set_live_points drops what the sampler cached of it)
    batch_sampler = main_sampler._new_sampler(main_sampler.live_init,
                                              update_interval)
    batch_sampler.save_bounds = save_bounds
    batch_sampler.logl_first_update = main_sampler.sampler.logl_first_update

    if logl_bounds is None:
        # default bracket: everything above the volume where nlive_new
        # live points would remain
        pos = np.nonzero(saved_logvol < (saved_logvol[-1] +
                                         np.log(nlive_new)))[0]
        pos = pos[-1] if len(pos) > 0 else len(saved_logl) - 1
        logl_min, logl_max = -np.inf, saved_logl[pos]
    else:
        logl_min, logl_max = logl_bounds

    psel = np.all(saved_logl > logl_min)
    if psel:
        # bracket reaches below all samples: fresh points from the prior
        (live_u, live_v, live_logl, live_blobs), logvol0, init_ncalls = \
            initialize_live_points(None, main_sampler.loglikelihood,
                                   nlive_new, main_sampler.ndim,
                                   main_sampler.rstate, blob=blob)
        ncall += init_ncalls
        for i in range(nlive_new):
            first_points.append(
                IteratorResultShort(worst=-i - 1, ustar=live_u[i],
                                    vstar=live_v[i], loglstar=live_logl[i],
                                    nc=1, worst_it=main_sampler.it,
                                    boundidx=0, bounditer=0,
                                    eff=main_sampler.eff,
                                    delta_logz=np.nan,
                                    proposal_stats=None))
        batch_sampler.update_bound_if_needed(logl_min)
    else:
        # seed from saved dead points above the bracket, volume-weighted
        subset0 = np.nonzero(saved_logl > logl_min)[0]
        if len(subset0) == 0:
            raise RuntimeError(
                "No samples above the requested logl_min; "
                f"logl_min={logl_min} max={saved_logl.max()}")
        if len(subset0) < nlive_new:
            if len(saved_logl) < nlive_new:
                subset0 = np.arange(len(saved_logl))
            else:
                subset0 = np.arange(subset0[-1] - nlive_new + 1,
                                    subset0[-1] + 1)
            # lower the bracket so all seeds satisfy it strictly
            logl_min = saved_logl[subset0[0] - 1] if subset0[0] > 0 \
                else -np.inf

        live_scale = saved_scale[subset0[0]]
        wt = np.exp(saved_logvol[subset0] - saved_logvol[subset0].max())
        wt = wt / wt.sum()
        n_pos = int((wt > 0).sum())
        subset = main_sampler.rstate.choice(subset0,
                                            size=min(nlive_new, n_pos),
                                            p=wt, replace=False)
        cur_nlive = len(subset)
        if cur_nlive == 1:
            raise RuntimeError("Only one live point selected for the "
                               "batch seed; please report.")
        batch_sampler.set_live_points(
            saved_u[subset].copy(), saved_v[subset].copy(),
            saved_logl[subset].copy(),
            live_blobs=stack_blob_rows(saved_blobs[i] for i in subset)
            if blob else None)
        batch_sampler.update_bound_if_needed(logl_min)
        # the parent's scale at the join, for whichever proposal kernel is
        # active now or becomes so at the first bound update
        batch_sampler.internal_sampler.scale = live_scale
        batch_sampler.internal_sampler_next.scale = live_scale

        # seed with a queue exactly as wide as the seed count: every row
        # a proposal round returns satisfies logl > logl_min, so one
        # full-width fill is consumed completely: no stranded (billed)
        # leftovers, and the whole seeding runs as a single device round
        # instead of nlive_new/queue_size round trips
        # (rounded up to the mesh size under a mesh; the few stranded rows
        # are billed by the drain below)
        qseed = nlive_new
        mesh = main_sampler.mesh
        if mesh is not None and mesh.size > 1:
            qseed = -(-qseed // mesh.size) * mesh.size
        batch_sampler.queue_size = qseed
        live_u = np.empty((nlive_new, main_sampler.ndim))
        live_v = np.empty((nlive_new, saved_v.shape[1]))
        live_logl = np.empty(nlive_new)
        seed_blobs = []

        # constrained sampling of the batch's starting live points
        for i in range(nlive_new):
            (live_u[i], live_v[i], live_logl[i], nc_i, blob_i,
             pstats_i) = batch_sampler._new_point(logl_min)
            seed_blobs.append(blob_i)
            ncall += nc_i
            first_points.append(
                IteratorResultShort(worst=-i - 1, ustar=live_u[i],
                                    vstar=live_v[i], loglstar=live_logl[i],
                                    nc=nc_i, worst_it=main_sampler.it,
                                    boundidx=0, bounditer=0,
                                    eff=main_sampler.eff,
                                    delta_logz=np.nan,
                                    proposal_stats=pstats_i))
        live_blobs = stack_blob_rows(seed_blobs) if blob else None
    # bill and drop any proposals left in the seeding queue: the fused
    # batch loop below never consumes them, but their evaluations
    # happened (exact invocation accounting)
    if batch_sampler.queue:
        ncall += sum(r["nc"] for r in batch_sampler.queue)
        batch_sampler.queue = []
        batch_sampler._pending_tuning = None
    niter += nlive_new
    if main_sampler.sampling.name == "unif":
        # Narrow kill batches for bracketed uniform runs: a batch round
        # proposes above the shared threshold sorted_logl[q-1], whose
        # level sits e^{q/nlive} deeper in volume than the live minimum
        # (at q = nlive/2 that costs ~65% more rejections per accepted
        # point).  Batches are short (the bracket spans ~1-5 nats), so
        # the dispatch-amortization value of a wide queue is small;
        # q = nlive/8 keeps the rejection overhead under ~15% while
        # device-refit chaining keeps the dispatch count low.  MCMC
        # kernels keep the wide queue: their per-accept cost (walks /
        # slices evaluations) does not grow with threshold depth.
        batch_sampler.queue_size_req = min(
            batch_sampler.queue_size_req, max(16, nlive_new // 8))
        # narrow queues make dispatches short: chain deeper (the
        # est-based rounds_active gate stops billed overshoot, so the
        # extra compiled rounds only ever amortize dispatch latency)
        if not batch_sampler.rounds_explicit:
            batch_sampler.unif_chain_cap = 16
            batch_sampler.rounds_per_dispatch = max(
                batch_sampler.rounds_per_dispatch, 16)
    # thread birth threshold of the batch seeds: the prior (-inf) for a
    # fresh prior-sampled batch, else the batch's lower bracket
    batch_sampler.set_live_points(
        live_u, live_v, live_logl,
        live_birth=np.full(nlive_new, -np.inf if psel else logl_min),
        live_blobs=live_blobs)
    if psel:
        batch_sampler.logvol_init = logvol0

    # truncate the saved run to where the new run joins it
    if logl_min == -np.inf:
        vol_idx = 0
    else:
        vol_idx = int(np.argmin(np.abs(saved_logl - logl_min))) + 1
    for k in batch_sampler.saved_run.keys():
        batch_sampler.saved_run[k] = main_sampler.saved_run[k][:vol_idx]
    batch_sampler.first_points = first_points
    if np.isfinite(logl_max):
        # expected batch length: iterations ~ nlive_new * (log-volume
        # span of the bracket), read off the saved run.  The static
        # sampler uses it to size its dispatches from the batch's FIRST
        # round (the progress-based estimate only kicks in later), so a
        # short bracketed batch never strands a wide terminal round of
        # speculative evaluations at the logl_max stop.
        above = np.nonzero(saved_logl >= logl_max)[0]
        end_idx = int(above[0]) if len(above) else len(saved_logvol) - 1
        start_lv = saved_logvol[vol_idx] if vol_idx < len(saved_logvol) \
            else saved_logvol[-1]
        span = max(float(start_lv - saved_logvol[end_idx]), 0.0)
        batch_sampler._bracket_est_total = nlive_new * span
    return batch_sampler, ncall, niter, logl_min, logl_max


def _take_scales(run, sampler):
    """Give the records that ``run`` holds of ``sampler`` (its first ones,
    in order) the scale ``sampler`` saved for them: the records of a
    dispatch that was interrupted take the scale of the whole dispatch
    once it is over."""
    n = len(run["scale"])
    run["scale"][:] = sampler.saved_run["scale"][:n]


class DynamicSampler:
    """Adaptive-allocation nested sampler on ``device`` (reference
    ``dynamicsampler.py:625``)."""

    def __init__(self, loglikelihood, ndim, sampling, bounding, *, device,
                 nlive0=None, ncdim=None, rstate=None, queue_size=None,
                 bound_update_interval_ratio=None, first_bound_update=None,
                 bound_bootstrap=0, bound_enlarge=1.0,
                 rounds_per_dispatch=None, proposal_mode="batch",
                 dtype=torch.float64, blob=False, cite=None, mesh=None):
        self.device = torch.device(device)
        self.loglikelihood = loglikelihood
        self.blob = bool(blob)
        self.cite = cite or ""
        self.ndim = ndim
        self.ncdim = ncdim or ndim
        # a name, or a user's Bound as a template of which every inner
        # sampler refits its own copy (bounding.get_bound)
        self.bounding = bounding
        # a template: every inner sampler gets a fresh instance of it, so
        # that no tuning state passes from one run or batch to the next
        self.sampling = sampling
        self.bound_update_interval_ratio = bound_update_interval_ratio
        self.first_bound_update = first_bound_update or {}
        self.sampler = None
        self.bound_enlarge = bound_enlarge
        self.bound_bootstrap = bound_bootstrap
        self.rstate = rstate or get_random_generator()
        self.queue_size = queue_size
        self.rounds_explicit = rounds_per_dispatch is not None
        self.rounds_per_dispatch = rounds_per_dispatch or 8
        self.proposal_mode = proposal_mode
        self.dtype = dtype
        # a parallel.mesh.Mesh for the base run and every batch sampler
        # (not pickled)
        self.mesh = mesh
        if mesh is not None:
            check_mesh_support(mesh, loglikelihood.mode, bounding,
                               sampling.name)
            loglikelihood.mesh = mesh
        # the pool, its map and the per-site flags (set by the factory;
        # not pickled)
        self.pool = None
        self.mapper = map
        self.use_pool = {}

        self.it = 1
        self.batch = 0
        self.ncall = 0
        self.bound_list = []
        self.eff = 1.0
        self.nlive0 = nlive0 or 500
        self.internal_state = DynamicSamplerStatesEnum.INIT

        self.saved_run = RunRecord(dynamic=True)
        self.base_run = RunRecord(dynamic=True)
        self.new_run = None
        self.new_logl_min, self.new_logl_max = -np.inf, np.inf

        self.live_init = None
        self.nlive_init = None
        self.batch_sampler = None
        self.checkpoint_timer = None
        # evaluations billed for proposals that no batch consumed
        self.nc_waste_total = 0
        # wall-clock attribution of the dynamic layer itself (seeding,
        # merging, the weight and stopping functions) and of the batch
        # samplers that have ended; the ``timings`` property adds the
        # base sampler's and the running batch sampler's views
        self.timings_closed = Timings()

    @property
    def timings(self):
        """Wall-clock attribution summed over the base run, every batch
        and the dynamic layer's own host work (``dyn_*`` keys; see
        :class:`dynesty_tpu_torch.utils.misc.Timings`)."""
        t = Timings().merge(self.timings_closed)
        for s in (self.sampler, self.batch_sampler):
            if s is not None:
                t.merge(s.timings)
        return t

    @classmethod
    def create(cls, loglikelihood, prior_transform, ndim, nlive=500,
               bound="multi", sample="auto", periodic=None, reflective=None,
               update_interval=None, first_update=None, rstate=None,
               queue_size=None, pool=None, use_pool=None, logl_args=None,
               logl_kwargs=None, ptform_args=None, ptform_kwargs=None,
               enlarge=None, bootstrap=None, walks=None, facc=0.5,
               slices=None, ncdim=None, blob=False, likelihood_mode="torch",
               rounds_per_dispatch=None, proposal_mode="batch",
               dtype=torch.float64, mesh=None,
               save_evaluation_history=False, history_filename=None, *,
               device="cuda"):
        """Factory with the ``DynamicNestedSampler`` signature."""
        from .dynesty import _common_init
        cfg = _common_init(loglikelihood, prior_transform, ndim, nlive,
                           bound, sample, device, periodic, reflective,
                           walks, facc, slices, ncdim, blob, likelihood_mode,
                           pool, queue_size, rstate, logl_args, logl_kwargs,
                           ptform_args, ptform_kwargs, enlarge, bootstrap,
                           update_interval, first_update, dtype, mesh,
                           use_pool=use_pool,
                           save_evaluation_history=save_evaluation_history,
                           history_filename=history_filename)
        obj = cls(cfg["like"], ndim, cfg["internal_sampler"], bound,
                   device=cfg["device"], nlive0=nlive, ncdim=cfg["ncdim"],
                   rstate=cfg["rstate"], queue_size=cfg["queue_size"],
                   bound_update_interval_ratio=(
                       cfg["bound_update_interval"] / nlive),
                   first_bound_update=cfg["first_update"],
                   bound_bootstrap=cfg["bootstrap"],
                   bound_enlarge=cfg["enlarge"],
                   rounds_per_dispatch=rounds_per_dispatch,
                   proposal_mode=proposal_mode, dtype=dtype, blob=blob,
                   cite=cfg["cite"]("dynamic"), mesh=mesh)
        obj.pool = pool
        obj.use_pool = cfg["use_pool"]
        if pool is not None:
            obj.mapper = pool.map
        return obj

    def _new_sampler(self, live_points, update_interval, first_update=None,
                     logvol_init=0.0):
        """An inner static sampler (the base run's or a batch's) with this
        sampler's configuration, its likelihood and its ``rstate``, and a
        fresh proposal kernel made from the ``sampling`` template, and the
        pool."""
        if first_update is None:
            first_update = self.first_bound_update
        sampler = Sampler(
            self.loglikelihood, self.ndim, live_points,
            self.sampling._new_from_template({}), self.bounding,
            device=self.device, bound_update_interval=update_interval,
            first_bound_update=first_update, rstate=self.rstate,
            queue_size=self.queue_size, ncdim=self.ncdim,
            bound_bootstrap=self.bound_bootstrap,
            bound_enlarge=self.bound_enlarge, logvol_init=logvol_init,
            rounds_per_dispatch=self.rounds_per_dispatch,
            rounds_explicit=self.rounds_explicit,
            proposal_mode=self.proposal_mode, dtype=self.dtype,
            blob=self.blob, cite=self.cite, mesh=self.mesh)
        sampler.pool = self.pool
        sampler.use_pool = self.use_pool
        return sampler

    def _bill_unyielded(self, sampler):
        """Add to ``ncall`` the evaluations that an inner sampler made in
        dispatches without a record after its last yield (a terminal
        dispatch that stopped before its first death): it billed them to
        itself, but no record carried them out."""
        self.ncall += sampler._nc_carry
        sampler._nc_carry = 0

    # ------------------------------------------------------------------
    # persistence

    def __getstate__(self):
        state = self.__dict__.copy()
        for k in ("mapper", "pool", "mesh"):
            state.pop(k, None)
        state["device"] = str(self.device)  # stored by name
        return state

    def __setstate__(self, state):
        # checkpoints written before blobs, pools and citations existed
        for k, v in (("blob", False), ("use_pool", {}), ("cite", "")):
            state.setdefault(k, v)
        self.__dict__ = state
        self.device = torch.device(state["device"])
        self.pool = None
        self.mapper = map
        self.mesh = None

    def save(self, fname):
        """Write the whole sampler, a suspended batch included, to
        ``fname`` (atomically)."""
        save_sampler(self, fname)

    @staticmethod
    def restore(fname, device=None, pool=None, mesh=None):
        """The sampler saved in ``fname``, on the device it was saved from
        unless ``device`` names another (a ``cuda`` checkpoint raises
        where CUDA is absent), with ``pool`` and ``mesh`` attached to it
        and to its inner samplers."""
        return restore_sampler(fname, device=device, pool=pool, mesh=mesh)

    def set_device(self, device):
        """Move the run to ``device``: the likelihood, the proposal
        template, the base sampler and a suspended batch sampler."""
        self.device = torch.device(device)
        self.loglikelihood.device = self.device
        self.sampling.drop_device_state()
        for s in (self.sampler, self.batch_sampler):
            if s is not None:
                s.set_device(self.device)

    def __get_update_interval(self, update_interval, nlive):
        if update_interval is None:
            ratio = self.bound_update_interval_ratio
        elif isinstance(update_interval, int):
            ratio = update_interval / nlive
        elif isinstance(update_interval, float):
            ratio = update_interval
        else:
            raise RuntimeError(f"Invalid update_interval {update_interval}")
        return int(max(min(np.round(ratio * nlive), sys.maxsize), 1))

    def reset(self):
        """Re-initialize the sampler state."""
        DynamicSampler.__init__(
            self, self.loglikelihood, self.ndim, self.sampling,
            self.bounding, device=self.device, nlive0=self.nlive0,
            ncdim=self.ncdim, rstate=self.rstate,
            queue_size=self.queue_size,
            bound_update_interval_ratio=self.bound_update_interval_ratio,
            first_bound_update=self.first_bound_update,
            bound_bootstrap=self.bound_bootstrap,
            bound_enlarge=self.bound_enlarge,
            rounds_per_dispatch=(self.rounds_per_dispatch
                                 if self.rounds_explicit else None),
            proposal_mode=self.proposal_mode, dtype=self.dtype,
            blob=self.blob, cite=self.cite, mesh=self.mesh)

    @property
    def citations(self):
        """The references of this configuration, printable."""
        return self.cite

    @property
    def results(self):
        """Combined-run results (dynamic format).

        If a batch is currently suspended by maxiter/maxcall (see
        ``sample_batch``), its partial samples are merged into the view
        non-destructively so interrupted work is visible (the reference's
        truncate-and-merge semantics, its ``tests/test_misc.py:474-509``)
        while the suspended state stays
        intact for a bit-exact ``add_batch(resume=True)``.
        """
        saved = self.saved_run
        if (self.batch_sampler is not None and self.new_run is not None
                and len(self.new_run["id"]) > 0):
            state = (self.saved_run, self.new_run, self.new_logl_min,
                     self.new_logl_max, self.batch)
            try:
                self.combine_runs()
                saved = self.saved_run
            finally:
                (self.saved_run, self.new_run, self.new_logl_min,
                 self.new_logl_max, self.batch) = state
        d = {}
        for k in ("nc", "v", "id", "batch", "it", "u", "n", "birth",
                  "logwt", "logl", "logvol", "logz", "logzvar", "h",
                  "batch_nlive", "batch_logl_bounds", "blob",
                  "proposal_stats"):
            d[k] = np.array(saved[k])
        # decode the f32-safe clamp back to -inf (prior-born points)
        birth = d["birth"].astype(np.float64)
        birth[birth <= -1e29] = -np.inf
        d["birth"] = birth
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            results = [("niter", self.it - 1), ("ncall", d["nc"]),
                       ("eff", self.eff), ("samples", d["v"])]
            for k in ("id", "batch", "it", "u", "n", "birth"):
                results.append(("samples_" + k, d[k]))
            for k in ("logwt", "logl", "logvol", "logz", "batch_nlive",
                      "batch_logl_bounds", "blob", "proposal_stats"):
                results.append((k, d[k]))
            results.append(("logzerr", np.sqrt(np.maximum(d["logzvar"],
                                                          0))))
            results.append(("information", d["h"]))
            if self.sampler is not None and self.sampler.save_bounds:
                results.append(("bound", copy.deepcopy(self.bound_list)))
                results.append(
                    ("bound_iter", np.array(saved["bounditer"])))
                results.append(
                    ("samples_bound", np.array(saved["boundidx"])))
                results.append(("scale", np.array(saved["scale"])))
        return Results(results)

    @property
    def n_effective(self):
        logwt = self.saved_run["logwt"]
        if len(logwt) == 0 or np.isneginf(np.max(logwt)):
            return 0
        return get_neff_from_logwt(np.asarray(logwt))

    # ------------------------------------------------------------------

    def sample_initial(self, nlive=None, update_interval=None,
                       first_update=None, maxiter=None, maxcall=None,
                       logl_max=np.inf, dlogz=0.01, live_points=None,
                       resume=False):
        """Baseline run generator (reference
        ``dynamicsampler.py:927-1226``)."""
        maxcall = maxcall or sys.maxsize
        maxiter = maxiter or sys.maxsize
        nlive = nlive or self.nlive0
        update_interval = self.__get_update_interval(update_interval, nlive)
        if nlive <= 2 * self.ncdim:
            warnings.warn("Beware: `nlive_init <= 2 * ndim`!")

        if not resume:
            live, logvol_init, init_ncalls = initialize_live_points(
                live_points, self.loglikelihood, nlive, self.ndim,
                self.rstate, blob=self.blob)
            self.live_init = [np.array(a) for a in live[:3]] + [live[3]]
            self.nlive_init = len(self.live_init[0])
            self.ncall += init_ncalls

            self.sampler = self._new_sampler(
                self.live_init, update_interval, first_update=first_update,
                logvol_init=logvol_init)
            self.bound_list = self.sampler.bound_list
            self.internal_state = DynamicSamplerStatesEnum.LIVEPOINTSINIT

        for results in self.sampler.sample(maxiter=maxiter,
                                           maxcall=maxcall,
                                           logl_max=logl_max, dlogz=dlogz,
                                           resume=resume):
            add_info = dict(id=results.worst, u=results.ustar,
                            v=results.vstar, logl=results.loglstar,
                            logvol=results.logvol, logwt=results.logwt,
                            logz=results.logz, logzvar=results.logzvar,
                            h=results.h, nc=results.nc, it=results.worst_it,
                            n=results.n, birth=results.birth,
                            blob=results.blob,
                            boundidx=results.boundidx,
                            bounditer=results.bounditer,
                            scale=self.sampler.internal_sampler.scale,
                            proposal_stats=results.proposal_stats)
            self.base_run.append(add_info)
            self.saved_run.append(add_info)
            self.ncall += results.nc
            self.eff = 100.0 * self.it / self.ncall
            self.it += 1
            self.internal_state = DynamicSamplerStatesEnum.INBASE
            yield IteratorResult(worst=results.worst, ustar=results.ustar,
                                 vstar=results.vstar,
                                 loglstar=results.loglstar,
                                 logvol=results.logvol, logwt=results.logwt,
                                 logz=results.logz,
                                 logzvar=results.logzvar, h=results.h,
                                 nc=results.nc, blob=results.blob,
                                 worst_it=results.worst_it,
                                 boundidx=results.boundidx,
                                 bounditer=results.bounditer, eff=self.eff,
                                 delta_logz=results.delta_logz,
                                 proposal_stats=results.proposal_stats)

        for run in (self.base_run, self.saved_run):
            _take_scales(run, self.sampler)
        self._bill_unyielded(self.sampler)
        self.internal_state = DynamicSamplerStatesEnum.INBASEADDLIVE
        for it, results in enumerate(self.sampler.add_live_points()):
            add_info = dict(id=results.worst, u=results.ustar,
                            v=results.vstar, logl=results.loglstar,
                            logvol=results.logvol, logwt=results.logwt,
                            logz=results.logz, logzvar=results.logzvar,
                            h=results.h, blob=results.blob, nc=results.nc,
                            it=results.worst_it, n=results.n,
                            birth=results.birth,
                            boundidx=results.boundidx,
                            bounditer=results.bounditer,
                            scale=self.sampler.internal_sampler.scale,
                            proposal_stats=None)
            self.base_run.append(add_info)
            self.saved_run.append(add_info)
            self.eff = 100.0 * self.it / self.ncall
            self.it += 1
            yield IteratorResult(worst=results.worst, ustar=results.ustar,
                                 vstar=results.vstar,
                                 loglstar=results.loglstar,
                                 logvol=results.logvol, logwt=results.logwt,
                                 logz=results.logz,
                                 logzvar=results.logzvar, h=results.h,
                                 blob=results.blob, nc=results.nc,
                                 worst_it=results.worst_it,
                                 boundidx=results.boundidx,
                                 bounditer=results.bounditer, eff=self.eff,
                                 delta_logz=results.delta_logz,
                                 proposal_stats=None)

        new_logwt, new_logz, new_logzvar, new_h = compute_integrals(
            logl=self.saved_run["logl"], logvol=self.saved_run["logvol"])
        for k, vals in (("logwt", new_logwt), ("logz", new_logz),
                        ("logzvar", new_logzvar), ("h", new_h)):
            self.saved_run[k] = vals.tolist()
            self.base_run[k] = vals.tolist()
        self.saved_run["batch"] = np.zeros(len(self.saved_run["id"]),
                                           dtype=int)
        self.saved_run["batch_nlive"].append(self.nlive_init)
        self.saved_run["batch_logl_bounds"].append((-np.inf, np.inf))
        self.internal_state = DynamicSamplerStatesEnum.BASE_DONE

    def sample_batch(self, dlogz=0.01, nlive_new=None, update_interval=None,
                     logl_bounds=None, maxiter=None, maxcall=None,
                     save_bounds=True, resume=False):
        """One batch generator (reference
        ``dynamicsampler.py:1228-1465``)."""
        maxcall = maxcall or sys.maxsize
        maxiter = maxiter or sys.maxsize
        nlive_new = nlive_new or self.nlive0
        if nlive_new <= 2 * self.ncdim:
            warnings.warn("Beware: `nlive_batch <= 2 * ndim`!")

        if resume and self.batch_sampler is None:
            # killed between batches: nothing mid-flight to re-enter
            resume = False
        if not resume and self.batch_sampler is not None:
            # a previous batch was suspended by maxiter/maxcall; finish
            # it (same bracket) before anything else so its spent calls
            # and partial run are not orphaned
            warnings.warn("Resuming a batch previously interrupted by "
                          "maxiter/maxcall; the requested logl_bounds are "
                          "ignored in favor of the suspended batch's.")
            resume = True
        if not resume:
            update_interval = self.__get_update_interval(update_interval,
                                                         nlive_new)
            t0 = time.perf_counter()
            (batch_sampler, ncall, niter, logl_min,
             logl_max) = _configure_batch_sampler(
                 self, nlive_new, update_interval=update_interval,
                 logl_bounds=logl_bounds, save_bounds=save_bounds)
            # the seeding's wall less its bound refits, which the batch
            # sampler's own ``refit`` holds
            self.timings_closed.add(
                "dyn_seeding", time.perf_counter() - t0 -
                batch_sampler.timings.get("refit", 0.0))
            self.timings_closed.count("n_seeds", nlive_new)
            self.batch_sampler = batch_sampler
            self.bound_list = batch_sampler.bound_list
            self.new_logl_min, self.new_logl_max = logl_min, logl_max
            self.new_run = RunRecord(dynamic=True)
            self.ncall += ncall
            batch_sampler.it0 = self.it
            it0 = self.it
            maxcall_left = maxcall - ncall
            maxiter_left = maxiter - niter
        else:
            batch_sampler = self.batch_sampler
            it0 = batch_sampler.it0
            logl_min, logl_max = self.new_logl_min, self.new_logl_max
            maxcall_left = maxcall
            maxiter_left = maxiter

        # the batch's starting points, yielded for printing only; popped
        # so an interrupted+resumed batch does not replay them
        while batch_sampler.first_points:
            yield batch_sampler.first_points.pop(0)

        iterated_batch = False
        results = None
        for results in batch_sampler.sample(
                dlogz=dlogz, logl_max=logl_max, maxiter=maxiter_left,
                maxcall=maxcall_left, save_bounds=save_bounds,
                resume=resume):
            D = dict(id=results.worst, u=results.ustar, v=results.vstar,
                     logl=results.loglstar, nc=results.nc,
                     it=results.worst_it + it0, blob=results.blob,
                     n=results.n, birth=results.birth,
                     boundidx=results.boundidx,
                     bounditer=results.bounditer,
                     scale=batch_sampler.internal_sampler.scale,
                     proposal_stats=results.proposal_stats)
            self.new_run.append(D)
            self.ncall += results.nc
            self.eff = 100.0 * self.it / self.ncall
            self.it += 1
            maxiter_left -= 1
            maxcall_left -= results.nc
            iterated_batch = True
            self.internal_state = DynamicSamplerStatesEnum.INBATCH
            yield IteratorResultShort(worst=results.worst,
                                      ustar=results.ustar,
                                      vstar=results.vstar,
                                      loglstar=results.loglstar,
                                      nc=results.nc,
                                      worst_it=results.worst_it + it0,
                                      boundidx=results.boundidx,
                                      bounditer=results.bounditer,
                                      eff=self.eff,
                                      delta_logz=results.delta_logz,
                                      proposal_stats=results.proposal_stats)

        _take_scales(self.new_run, batch_sampler)
        if batch_sampler.interrupted_budget and iterated_batch:
            # maxiter/maxcall stopped the batch mid-flight: SUSPEND
            # instead of truncating.  The batch sampler (with its
            # leftover proposals, bracket and partial new_run) stays
            # alive in pickled state, so a later
            # ``add_batch(resume=True)``, before or after a restore from a
            # checkpoint, replays the identical round sequence and the
            # finished run is bit-identical to one whose batch was never
            # interrupted (reference analogue:
            # ``tests/test_resume.py:106-109``).
            self.internal_state = DynamicSamplerStatesEnum.INBATCH
            return
        # if the budget was exhausted before the batch produced any dead
        # point (e.g. maxiter < nlive_new so seeding consumed it all),
        # there is nothing mid-flight to suspend: complete the batch as a
        # seeds-only run (as the reference does: its maxiter interrupt
        # always adds the batch live points and merges)

        if (iterated_batch and results.loglstar < logl_max
                and np.isfinite(logl_max) and maxiter_left > 0
                and maxcall_left > 0):
            warnings.warn("Batch sampling terminated before reaching the "
                          "target maximum likelihood; you may need more "
                          "live points for multi-modal posteriors.")
        self.internal_state = DynamicSamplerStatesEnum.INBATCHADDLIVE
        self._bill_unyielded(batch_sampler)

        if not iterated_batch and len(batch_sampler.saved_run["logl"]) == 0:
            # only the initial batch live points were drawn
            batch_sampler.saved_run["logvol"] = [-np.inf]
            batch_sampler.saved_run["logl"] = [logl_min]
            batch_sampler.saved_run["logz"] = [-1e100]
            batch_sampler.saved_run["logzvar"] = [0]
            batch_sampler.saved_run["h"] = [0]
        # telemetry: speculative work stranded inside this batch
        self.nc_waste_total += batch_sampler.nc_waste_total
        batch_sampler.nc_waste_total = 0
        for it, results in enumerate(batch_sampler.add_live_points()):
            D = dict(id=results.worst, u=results.ustar, v=results.vstar,
                     logl=results.loglstar, nc=results.nc,
                     it=results.worst_it + it0, n=results.n,
                     birth=results.birth,
                     blob=results.blob, boundidx=results.boundidx,
                     bounditer=results.bounditer,
                     scale=batch_sampler.internal_sampler.scale,
                     proposal_stats=None)
            self.new_run.append(D)
            self.eff = 100.0 * self.it / self.ncall
            self.it += 1
            yield IteratorResultShort(worst=results.worst,
                                      ustar=results.ustar,
                                      vstar=results.vstar,
                                      loglstar=results.loglstar,
                                      nc=results.nc,
                                      worst_it=results.worst_it + it0,
                                      boundidx=results.boundidx,
                                      bounditer=results.bounditer,
                                      eff=self.eff, delta_logz=np.nan,
                                      proposal_stats=None)
        self.timings_closed.merge(batch_sampler.timings)
        self.batch_sampler = None

    def combine_runs(self):
        """Merge the newest batch into the combined run (two-pointer walk
        plus plateau-aware volume assignment; reference
        ``dynamicsampler.py:1467-1607``)."""
        if len(self.new_run["id"]) == 0:
            raise ValueError("No new samples are currently saved.")
        saved_d, new_d = {}, {}
        for k in ("id", "u", "v", "logl", "nc", "boundidx", "it",
                  "bounditer", "n", "birth", "scale", "blob", "logvol",
                  "proposal_stats"):
            saved_d[k] = np.array(self.saved_run[k])
            new_d[k] = np.array(self.new_run[k])
        saved_d["batch"] = np.array(self.saved_run["batch"])
        nsaved = len(saved_d["n"])
        new_d["id"] = new_d["id"] + max(saved_d["id"]) + 1
        nnew = len(new_d["n"])
        llmin, llmax = self.new_logl_min, self.new_logl_max

        old_batch_bounds = self.saved_run["batch_logl_bounds"]
        old_batch_nlive = self.saved_run["batch_nlive"]
        self.saved_run = RunRecord(dynamic=True)

        # Vectorized two-pointer merge: both inputs are sorted by logl,
        # so a stable argsort of the concatenation IS the merge order
        # (ties keep saved-before-new, matching the reference's
        # ``logl_s <= logl_n`` branch).
        all_logl = np.concatenate([saved_d["logl"], new_d["logl"]])
        order = np.argsort(all_logl, kind="stable")
        src_is_new = order >= nsaved
        # pointer positions BEFORE consuming step t (the loop reads the
        # next-to-die entries of both runs to compute the merged nlive)
        cons_saved = np.concatenate(
            [[0], np.cumsum(~src_is_new)[:-1]]).astype(int)
        cons_new = np.concatenate(
            [[0], np.cumsum(src_is_new)[:-1]]).astype(int)
        s_open = cons_saved < nsaved
        n_open = cons_new < nnew
        logl_s_t = np.where(
            s_open, saved_d["logl"][np.minimum(cons_saved, nsaved - 1)],
            np.inf)
        nlive_s_t = np.where(
            s_open, saved_d["n"][np.minimum(cons_saved, nsaved - 1)], 0)
        nlive_n_t = np.where(
            n_open, new_d["n"][np.minimum(cons_new, nnew - 1)], 0)
        nlive_arr = np.where(logl_s_t > self.new_logl_min,
                             nlive_s_t + nlive_n_t, nlive_s_t)
        batch_col = np.where(
            src_is_new, self.batch + 1,
            saved_d["batch"][np.minimum(order, nsaved - 1)])
        for k in ("id", "u", "v", "logl", "nc", "boundidx", "it",
                  "bounditer", "birth", "scale", "blob",
                  "proposal_stats"):
            merged = np.concatenate([np.asarray(saved_d[k]),
                                     np.asarray(new_d[k])], axis=0)[order]
            self.saved_run[k].extend(list(merged))
        self.saved_run["batch"].extend(list(batch_col))
        self.saved_run["n"].extend(list(nlive_arr))

        logl_array = np.array(self.saved_run["logl"])
        nlive_array = np.array(self.saved_run["n"])
        logvol_init = self.sampler.logvol_init
        if np.all(logl_array[1:] != logl_array[:-1]):
            # no plateaus: the shrinkage recursion is a running sum
            logvols = logvol_init - np.cumsum(
                np.log((nlive_array + 1.0) / nlive_array))
            self.saved_run["logvol"].extend(list(logvols))
        else:
            plateau_mode = False
            plateau_counter = 0
            plateau_logdvol = 0.0
            logvol = logvol_init
            for i, (cur_logl, nlive) in enumerate(zip(logl_array,
                                                      nlive_array)):
                if (not plateau_mode and i != len(nlive_array) - 1
                        and logl_array[i] == logl_array[i + 1]):
                    nplateau = (logl_array[i:] == cur_logl).sum()
                    if nplateau > 1:
                        plateau_counter = nplateau
                        plateau_logdvol = logvol + np.log(1.0 / (nlive + 1))
                        plateau_mode = True
                if not plateau_mode:
                    logvol -= math.log((nlive + 1.0) / nlive)
                else:
                    logvol = logvol + np.log1p(
                        -np.exp(plateau_logdvol - logvol))
                self.saved_run["logvol"].append(logvol)
                if plateau_mode:
                    plateau_counter -= 1
                    if plateau_counter == 0:
                        plateau_mode = False

        assert self.saved_run["logl"][0] == min(new_d["logl"][0],
                                                saved_d["logl"][0])
        assert self.saved_run["logl"][-1] == max(new_d["logl"][-1],
                                                 saved_d["logl"][-1])

        new_logwt, new_logz, new_logzvar, new_h = compute_integrals(
            logl=self.saved_run["logl"], logvol=self.saved_run["logvol"])
        self.saved_run["logwt"].extend(new_logwt.tolist())
        self.saved_run["logz"].extend(new_logz.tolist())
        self.saved_run["logzvar"].extend(new_logzvar.tolist())
        self.saved_run["h"].extend(new_h.tolist())

        self.new_run = None
        self.new_logl_min, self.new_logl_max = -np.inf, np.inf
        self.batch += 1
        self.saved_run["batch_nlive"] = old_batch_nlive + \
            [int(max(new_d["n"]))]
        self.saved_run["batch_logl_bounds"] = old_batch_bounds + \
            [(llmin, llmax)]

    # ------------------------------------------------------------------

    def run_nested(self, nlive_init=None, maxiter_init=None,
                   maxcall_init=None, dlogz_init=0.01, logl_max_init=np.inf,
                   nlive_batch=None, wt_function=None, wt_kwargs=None,
                   maxiter_batch=None, maxcall_batch=None, maxiter=None,
                   maxcall=None, maxbatch=None, n_effective=None,
                   stop_function=None, stop_kwargs=None, use_stop=True,
                   save_bounds=True, print_progress=True, print_func=None,
                   live_points=None, resume=False, checkpoint_file=None,
                   checkpoint_every=60):
        """The main dynamic loop: baseline run, then batches until the
        stopping criterion fires (reference
        ``dynamicsampler.py:1610-1928``)."""
        maxcall = sys.maxsize if maxcall is None else maxcall
        maxiter = sys.maxsize if maxiter is None else maxiter
        maxiter_batch = sys.maxsize if maxiter_batch is None \
            else maxiter_batch
        maxcall_batch = sys.maxsize if maxcall_batch is None \
            else maxcall_batch
        maxbatch = sys.maxsize if maxbatch is None else maxbatch
        maxiter_init = sys.maxsize if maxiter_init is None else maxiter_init
        maxcall_init = sys.maxsize if maxcall_init is None else maxcall_init
        wt_function = wt_function or weight_function
        wt_kwargs = wt_kwargs or {}
        if stop_function is None:
            stop_function = stopping_function
            stop_kwargs = dict(stop_kwargs or {})
            if n_effective is None:
                n_effective = max(self.ndim * self.ndim, 10000)
            stop_kwargs["target_n_effective"] = n_effective
        else:
            stop_kwargs = stop_kwargs or {}
        nlive_init = nlive_init or self.nlive0
        nlive_batch = nlive_batch or self.nlive0

        ncall = self.ncall
        niter = self.it - 1
        logl_bounds = (-np.inf, np.inf)
        maxcall_init = min(maxcall_init, maxcall)
        maxiter_init = min(maxiter_init, maxiter)

        if resume:
            if self.internal_state == DynamicSamplerStatesEnum.RUN_DONE:
                warnings.warn("Cannot resume a successfully finished run; "
                              "no sampling performed.", RuntimeWarning)
                return
        else:
            if self.internal_state not in (
                    DynamicSamplerStatesEnum.INIT,
                    DynamicSamplerStatesEnum.RUN_DONE):
                warnings.warn("run_nested() called from an unclear sampler "
                              "state; no sampling performed.",
                              RuntimeWarning)
                return

        pbar, print_func = get_print_func(print_func, print_progress)
        self.checkpoint_timer = DelayTimer(checkpoint_every)
        results = None
        t_run0 = time.perf_counter()
        try:
            if self.internal_state in (
                    DynamicSamplerStatesEnum.INIT,
                    DynamicSamplerStatesEnum.LIVEPOINTSINIT,
                    DynamicSamplerStatesEnum.INBASE,
                    DynamicSamplerStatesEnum.INBASEADDLIVE):
                t_base0 = time.perf_counter()
                for results in self.sample_initial(
                        nlive=nlive_init, dlogz=dlogz_init,
                        maxcall=maxcall_init, maxiter=maxiter_init,
                        logl_max=logl_max_init, live_points=live_points,
                        resume=resume):
                    resume = False
                    ncall += results.nc
                    niter += 1
                    if (checkpoint_file is not None and self.internal_state
                            != DynamicSamplerStatesEnum.INBASEADDLIVE
                            and self.checkpoint_timer.is_time()):
                        self.save(checkpoint_file)
                    if print_progress:
                        print_func(results, niter, ncall, nbatch=0,
                                   dlogz=dlogz_init,
                                   logl_max=logl_max_init)
                self.timings_closed.add("dyn_base",
                                        time.perf_counter() - t_base0)
            for n in range(self.batch, maxbatch):
                res = self.results
                mcall = min(maxcall - ncall, maxcall_batch)
                miter = min(maxiter - niter, maxiter_batch)
                # no stop check while a suspended batch is pending: it
                # must be finished (resume) before its samples can count
                if mcall > 0 and miter > 0 and use_stop \
                        and self.batch_sampler is None:
                    t0 = time.perf_counter()
                    # the Monte Carlo realisations map over the pool where
                    # use_pool['stop_function']
                    stop_mapper = self.mapper if self.use_pool.get(
                        "stop_function", True) else map
                    stop, stop_vals = stop_function(res, stop_kwargs,
                                                    rstate=self.rstate,
                                                    mapper=stop_mapper,
                                                    return_vals=True)
                    self.timings_closed.add("dyn_stop",
                                            time.perf_counter() - t0)
                    stop_val = stop_vals[2]
                else:
                    stop = False
                    stop_val = np.nan

                if mcall > 0 and miter > 0 and not stop:
                    passback = self.add_batch(
                        nlive=nlive_batch, wt_function=wt_function,
                        wt_kwargs=wt_kwargs, maxiter=miter, maxcall=mcall,
                        save_bounds=save_bounds,
                        print_progress=print_progress,
                        print_func=print_func, stop_val=stop_val,
                        resume=resume or self.batch_sampler is not None,
                        checkpoint_file=checkpoint_file)
                    resume = False
                    ncall, niter, logl_bounds, results = passback
                else:
                    break
            if self.batch_sampler is None:
                self.internal_state = DynamicSamplerStatesEnum.RUN_DONE
            if checkpoint_file is not None:
                self.save(checkpoint_file)
        finally:
            self.timings_closed.add("total", time.perf_counter() - t_run0)
            if pbar is not None:
                pbar.close()
            self.loglikelihood.finalize_history()
            if print_progress:
                sys.stderr.write("\n")

    def add_batch(self, nlive=500, dlogz=1e-2, mode="weight",
                  wt_function=None, wt_kwargs=None, maxiter=None,
                  maxcall=None, logl_bounds=None, save_bounds=True,
                  print_progress=True, print_func=None, stop_val=None,
                  resume=False, checkpoint_file=None,
                  checkpoint_every=None):
        """Allocate one additional batch (modes: auto/weight/full/manual;
        reference ``dynamicsampler.py:1930-2133``)."""
        maxcall = sys.maxsize if maxcall is None else maxcall
        maxiter = sys.maxsize if maxiter is None else maxiter
        wt_function = wt_function or weight_function
        wt_kwargs = wt_kwargs or {}
        stop_val = np.nan if stop_val is None else stop_val

        t0 = time.perf_counter()
        res = self.results
        if mode != "manual" and logl_bounds is not None:
            raise RuntimeError("explicit logl_bounds require mode='manual'")
        if mode == "manual" and logl_bounds is None:
            raise RuntimeError("mode='manual' requires logl_bounds")
        if mode in ("auto", "weight"):
            logl_bounds = wt_function(res, wt_kwargs)
        self.timings_closed.add("dyn_weight", time.perf_counter() - t0)
        if logl_bounds is None:
            logl_min, logl_max = -np.inf, np.inf
        else:
            logl_min, logl_max = logl_bounds
        logz, logzvar = res["logz"][-1], res["logzerr"][-1] ** 2

        ncall, niter, n = self.ncall, self.it - 1, self.batch
        if checkpoint_file is not None:
            timer = DelayTimer(checkpoint_every) \
                if checkpoint_every is not None else self.checkpoint_timer
        if maxcall <= 0 or maxiter <= 0:
            raise RuntimeError("add_batch called with no remaining calls "
                               "or iterations")
        pbar, print_func = get_print_func(print_func, print_progress)
        results = None
        t_batch0 = time.perf_counter()
        try:
            for cur in self.sample_batch(nlive_new=nlive, dlogz=dlogz,
                                         logl_bounds=logl_bounds,
                                         maxiter=maxiter, maxcall=maxcall,
                                         save_bounds=save_bounds,
                                         resume=resume):
                if cur.worst >= 0:
                    ncall += cur.nc
                    niter += 1
                # a record's blob is the batch run's row just appended
                blob = self.new_run["blob"][-1] if cur.worst >= 0 and \
                    self.new_run is not None else None
                results = IteratorResult(
                    worst=cur.worst, ustar=cur.ustar, vstar=cur.vstar,
                    loglstar=cur.loglstar, blob=blob, logvol=np.nan,
                    logwt=np.nan, logz=logz, logzvar=logzvar, h=np.nan,
                    nc=cur.nc, worst_it=cur.worst_it, boundidx=cur.boundidx,
                    bounditer=cur.bounditer, eff=cur.eff,
                    delta_logz=cur.delta_logz,
                    proposal_stats=cur.proposal_stats)
                if print_progress:
                    print_func(results, niter, ncall, nbatch=n + 1,
                               dlogz=dlogz, stop_val=stop_val,
                               logl_min=logl_min, logl_max=logl_max)
                if (checkpoint_file is not None and self.internal_state
                        not in (DynamicSamplerStatesEnum.INBATCHADDLIVE,
                                DynamicSamplerStatesEnum.BATCH_DONE)
                        and timer.is_time()):
                    self.save(checkpoint_file)
        finally:
            if pbar is not None:
                pbar.close()
        # seeding (dyn_seeding) and the batch's rounds together
        self.timings_closed.add("dyn_batch", time.perf_counter() - t_batch0)

        if self.batch_sampler is not None:
            # the batch was suspended by maxiter/maxcall (see
            # sample_batch): leave the partial run pending for a
            # bit-exact ``add_batch(resume=True)`` continuation
            return ncall, niter, logl_bounds, results
        t0 = time.perf_counter()
        self.combine_runs()
        self.timings_closed.add("dyn_combine", time.perf_counter() - t0)
        self.internal_state = DynamicSamplerStatesEnum.BATCH_DONE
        return ncall, niter, logl_bounds, results
