"""The static nested sampler: a synchronous host loop over fused device
dispatches (counterpart of ``dynesty_tpu.sampler``).

Each dispatch runs up to ``rounds_per_dispatch`` chained propose+consume
rounds on the device (``internal/fused.py``); between dispatches the host
appends the records, applies the proposal tuning, and refits the bound
when its cadence is due.  The live points stay on the device between
dispatches and are mirrored to the host only for a refit, a checkpoint and
at the end.

A run stopped by ``maxiter``/``maxcall`` can be re-entered with
``sample(resume=True)``, before or after a pickle round trip
(:meth:`Sampler.save`, :meth:`Sampler.restore`), and then continues bit
for bit as the uninterrupted run would have: the interrupted round's
unconsumed proposals are kept and replayed (consume only), and the
interrupted dispatch's remaining rounds are regenerated from its seed.

Over an ellipsoid bound with a torch likelihood (the JAX package's rule,
:meth:`Sampler._pipeline_capable`) the sampler plans the next dispatch as
soon as one is over, on the bound that dispatch ran on, and then runs the
refit trigger: the refit lags by one dispatch, and the host stream gives the
dispatch's seed before any bootstrap draw, as in the JAX package's
pipelined pre-launch.  The planned spec keeps a copy of its bound where
the refit moved it, and is launched at the loop top like a restored spec,
so nothing is launched early and a stop wastes no work.  Whether a run
plans ahead depends only on its dispatches, never on ``maxiter``,
``maxcall`` or a stop, so a stopped and resumed run stays the
uninterrupted one.

With blobs (``blob=True``) the live points' blobs ride beside the live
matrix (``live_blobs`` on the host, stacked; a device copy between
dispatches), and every record carries the blob of its dead point.  A
``pool`` is used for host-mode evaluations (through the likelihood) and,
where ``use_pool['update_bound']``, for the bounds' bootstrap
realisations; it is dropped when the sampler is pickled.

A device mesh (``mesh``, a :class:`~dynesty_tpu_torch.parallel.mesh.Mesh`)
splits every batched likelihood call by lane over its devices; the round
widths are kept divisible by its size, and host mode and a host-sampled
user's bound under ``unif`` are refused under a mesh of more than one
device.  The mesh is dropped when the sampler is pickled and attached
again by ``restore(..., mesh=)``.
"""

import copy
import math
import sys
import time
import warnings

import numpy as np
import torch

from .bounding import Bound, UnitCube, get_bound
from .internal.kernels import f32_precision
from .internal.samplers import UnitCubeSampler
from .ops.integrals import (LOWL_VAL, compute_integrals,
                            get_neff_from_logwt, progress_integration)
from .parallel.mesh import batch_sharding
from .utils.checkpoint import restore_sampler, save_sampler
from .utils.convert import bound_arrays_to_torch, live_to_torch
from .utils.misc import (DelayTimer, IteratorBlock, IteratorResult, Timings,
                         blob_row, get_print_func, get_random_generator,
                         get_torch_generator, stack_blob_rows, tree_map)
from .utils.results import Results, RunRecord

__all__ = ["Sampler", "initialize_live_points"]


def initialize_live_points(live_points, loglikelihood, nlive, ndim, rstate,
                           blob=False):
    """Draw the initial live points by batched rejection sampling from the
    unit cube until enough have finite log-likelihood.

    Returns ``(live_u, live_v, live_logl, live_blobs), logvol_init,
    ncalls``; ``live_blobs`` is the points' blob stacked along its first
    axis (None without ``blob``).  Given ``live_points``, their fourth
    entry holds the blobs, one per point."""
    logvol_init = 0.0
    ncalls = 0
    live_blobs = None
    if live_points is None:
        n_attempts = 1000
        min_npoints = min(nlive, max(ndim + 1, min(nlive - 20, 100)))
        live_u = np.zeros((nlive, ndim))
        live_logl = np.zeros(nlive)
        live_v = None
        # the blob of each live slot, in slot order
        picks = []
        ngoods = 0
        for iattempt in range(1, n_attempts + 1):
            cur_u = rstate.random(size=(nlive, ndim))
            cur_v, cur_logl, cur_blob = loglikelihood.eval_host(cur_u)
            if live_v is None:
                live_v = np.zeros((nlive, cur_v.shape[1]))
            ncalls += nlive
            finite = np.isfinite(cur_logl)
            ngood_cur = int(finite.sum())
            if ngood_cur > 0:
                nextra = min(nlive - ngoods, ngood_cur)
                sel = np.nonzero(finite)[0][:nextra]
                sl = slice(ngoods, ngoods + nextra)
                live_u[sl] = cur_u[sel]
                live_v[sl] = cur_v[sel]
                live_logl[sl] = cur_logl[sel]
                picks += [blob_row(cur_blob, i) for i in sel]
                ngoods += nextra
            if ngoods >= min_npoints:
                nextra = nlive - ngoods
                if nextra > 0:
                    sel = np.nonzero(~finite)[0][:nextra]
                    sl = slice(ngoods, ngoods + nextra)
                    live_u[sl] = cur_u[sel]
                    live_v[sl] = cur_v[sel]
                    live_logl[sl] = LOWL_VAL
                    picks += [blob_row(cur_blob, i) for i in sel]
                # k finite points out of N*n draws: the volume above the
                # -inf region is 1/N
                logvol_init = -np.log(iattempt)
                break
            if iattempt == n_attempts:
                if ngoods == 0:
                    raise RuntimeError(
                        f"After {n_attempts} attempts, not a single point "
                        "with a valid log-likelihood was found.")
                warnings.warn(
                    f"After {n_attempts} attempts, fewer than "
                    f"{min_npoints} points with valid log-likelihood were "
                    "found; initial sampling is very inefficient!")
        if blob:
            # slots left empty after the last attempt take a zero blob
            picks += [tree_map(np.zeros_like, picks[0])] * (nlive -
                                                            len(picks))
            live_blobs = stack_blob_rows(picks)
    else:
        live_u, live_v = np.array(live_points[0]), np.array(live_points[1])
        live_logl = np.array(live_points[2], dtype=np.float64)
        loglikelihood.eval_host(live_u[:1])
        if blob:
            live_blobs = stack_blob_rows(live_points[3])
        bad = ~np.isfinite(live_logl)
        if np.any(bad & (live_logl > 0)):
            raise ValueError("A provided live point has an invalid "
                             "log-likelihood.")
        live_logl[bad] = LOWL_VAL
        if np.all(live_logl == LOWL_VAL):
            raise ValueError("Not a single provided live point has a "
                             "valid log-likelihood!")
    if np.ptp(live_logl) == 0:
        warnings.warn(
            "All initial likelihood values are identical: likely a "
            "likelihood plateau; nested sampling may be inefficient.",
            RuntimeWarning)
    return (live_u, live_v, live_logl, live_blobs), logvol_init, ncalls


def check_mesh_support(mesh, likelihood_mode, bound, sample_name):
    """Refuse what has no meaning with a lane split over several devices
    (the JAX package's checks): a host-mode likelihood, and ``unif`` over
    a user's bound that is sampled on the host."""
    if mesh is None or mesh.size <= 1:
        return
    if likelihood_mode == "host":
        raise ValueError(
            "likelihood_mode='host' cannot run under a device mesh: a "
            "host-mode likelihood is mapped on the host, not split over "
            "devices. Use a torch likelihood ('torch'/'vectorized') or "
            "drop the mesh.")
    custom = isinstance(bound, Bound) and \
        type(bound).device_spec is Bound.device_spec
    if custom and sample_name == "unif":
        raise ValueError(
            "sample='unif' with a custom host-sampled Bound cannot run "
            "under a device mesh: the bound's samples are drawn on the "
            "host between device waves. Use rwalk/rslice/slice, a built-in "
            "bound, or drop the mesh.")


class Sampler:
    """Static nested sampler over fused device dispatches on ``device``."""

    def __init__(self, loglikelihood, ndim, live_points, sampling, bounding,
                 *, device, ncdim=None, rstate=None, queue_size=None,
                 bound_update_interval=None, first_bound_update=None,
                 bound_bootstrap=0, bound_enlarge=1.0, logvol_init=0.0,
                 rounds_per_dispatch=1, rounds_explicit=False,
                 proposal_mode="batch", dtype=torch.float64, blob=False,
                 cite=None, mesh=None):
        f32_precision()
        self.device = torch.device(device)
        self.dtype = dtype
        self.cite = cite or ""
        self.loglikelihood = loglikelihood
        self.ndim = ndim
        self.ncdim = ncdim or ndim
        self.blob = bool(blob)
        self.live_u, self.live_v, self.live_logl = live_points[:3]
        self.live_blobs = live_points[3] if self.blob else None
        self.nlive = len(self.live_u)
        self.live_bound = np.zeros(self.nlive, dtype=int)
        self._live_bound_marked = np.zeros(self.nlive, dtype=bool)
        self.live_it = np.zeros(self.nlive, dtype=int)
        self.live_birth = np.full(self.nlive, -np.inf)

        self.rstate = rstate or get_random_generator()
        self.internal_sampler_next = sampling
        self.internal_sampler = UnitCubeSampler(ndim=ndim)
        if proposal_mode not in ("batch", "queue"):
            raise ValueError(f"Unknown proposal_mode '{proposal_mode}'")
        self.proposal_mode = proposal_mode
        # a parallel.mesh.Mesh splitting the likelihood's lanes (not
        # pickled); the likelihood holds it too
        self.mesh = mesh
        if mesh is not None:
            check_mesh_support(mesh, loglikelihood.mode, bounding,
                               sampling.name)
            loglikelihood.mesh = mesh
        # the lane split of the last dispatch's proposal block
        self.last_proposals_sharding = None
        self.queue_size_req = max(int(queue_size or 64), 1)
        self._apply_queue_clamp()

        self.it = 1
        self.ncall = self.nlive
        self.added_live = False
        self.eff = 0.0
        self.save_bounds = True
        self.bound_update_interval = bound_update_interval
        first_bound_update = first_bound_update or {}
        self.first_bound_update_ncall = first_bound_update.get(
            "min_ncall", 2 * self.nlive)
        self.first_bound_update_eff = first_bound_update.get("min_eff", 10.0)
        self.logl_first_update = None
        self.ncall_at_last_update = 0

        self.unit_cube_sampling = True
        self.bound_version = 0
        self.bound = UnitCube(self.ncdim)
        self.bound_list = [self.bound]
        self.nbound = 1
        self.logvol_init = logvol_init
        self.plateau_mode = False
        self.plateau_counter = None
        self.plateau_logdvol = None
        self.saved_run = RunRecord()
        self.bound_bootstrap = bound_bootstrap
        self.bound_enlarge = bound_enlarge
        self.bounding = bounding
        self.bound_next = get_bound(bounding, self.ncdim, device=self.device)
        self.timings = Timings()
        self.rounds_per_dispatch = max(int(rounds_per_dispatch), 1)
        # the user chose the chain depth: the unif kernel's cap defers to it
        self.rounds_explicit = bool(rounds_explicit)
        # a deeper cap on chained unif rounds, set on a dynamic batch's
        # sampler (None: the kernel's own)
        self.unif_chain_cap = None
        self._live_dev = None
        self._live_blob_dev = None
        self._mirror_stale = False
        self._bound_upload = None
        # a pool for host-mode evaluations and bootstrap realisations, and
        # the per-site flags (set by the factories; not pickled)
        self.pool = None
        self.use_pool = {}
        self._init_resume_state()

    def _apply_queue_clamp(self):
        """The width of a round from ``queue_size_req`` and the current
        ``nlive``; run again whenever ``nlive`` changes.  Batch rounds
        kill ``queue_size`` points at once, so the width is capped at half
        the live count.  ``_q_narrow`` is the width of a bracketed run's
        last dispatches (see :meth:`_make_dispatch_spec`).  Under a mesh
        both are multiples of its size."""
        if self.proposal_mode == "batch":
            self.queue_size = max(1, min(self.queue_size_req,
                                         self.nlive // 2))
        else:
            self.queue_size = self.queue_size_req
        n = self.mesh.size if self.mesh is not None else 1
        if n > 1:
            self.queue_size = max(n, self.queue_size // n * n)
        self._q_full = self.queue_size
        qn = max(16, self.queue_size // 8)
        if n > 1:
            qn = max(n, qn // n * n)
        self._q_narrow = min(qn, self.queue_size)

    def set_live_points(self, live_u, live_v, live_logl, live_birth=None,
                        live_blobs=None):
        """Replace the live set of a built sampler (the dynamic sampler
        seeds its batches this way) by points from no bound and no
        iteration of this sampler, born at ``live_birth`` (the prior by
        default), with their stacked blobs.  Whatever was cached from the
        old set is dropped: the device copies, and the mark that would
        have refreshed the host arrays from them."""
        self.live_u, self.live_v, self.live_logl = live_u, live_v, live_logl
        self.live_blobs = live_blobs
        self.nlive = len(live_u)
        self.live_bound = np.zeros(self.nlive, dtype=int)
        self._live_bound_marked = np.zeros(self.nlive, dtype=bool)
        self.live_it = np.zeros(self.nlive, dtype=int)
        self.live_birth = np.full(self.nlive, -np.inf) \
            if live_birth is None else live_birth
        self._live_dev = None
        self._live_blob_dev = None
        self._mirror_stale = False
        self._apply_queue_clamp()

    def _init_resume_state(self):
        """The state that lets an interrupted run continue exactly; all
        of it is host data and pickled."""
        self._last_delta_logz = None
        self._nc_carry = 0
        # integrator carry after the last consumed dispatch
        self._integ = None
        # per-record yields staged but not yet drained
        self._pending_records = []
        # unconsumed tail of an interrupted round: {prop, kills, birth0,
        # cont}
        self._leftover = None
        # remaining rounds of an interrupted dispatch: {key_seed, skip,
        # rounds, queue_size, refit_due_ncall}, and under a custom bound
        # the dispatch's custom_axes
        self._continuation = None
        # first saved record of an interrupted dispatch: its records take
        # the scale of the whole dispatch once it is over
        self._dispatch_rec0 = None
        # evaluations of entries discarded since the last death, at the
        # point where an interrupted dispatch stopped: the device carries
        # this count from entry to entry within a dispatch, the host
        # carries it into the replay and the continuation
        self._nc_accum_carry = 0
        # the planned, not yet consumed dispatch
        self._next_spec = None
        self._terminal_done = False
        self.interrupted_budget = False
        # bracket progress of a run with a finite logl_max: where it
        # started, and the length its caller expects of it
        self._bracket_start = None
        self._bracket_it0 = None
        self._bracket_est_total = None
        # evaluations billed for proposals that were never consumed
        self.nc_waste_total = 0
        # rows of the non-fused round (the dynamic sampler's batch seeding
        # draws its points through them, one at a time)
        self.queue = []
        self._pending_tuning = None
        # set by the dynamic sampler on a batch's sampler: the seeds still
        # to be shown (popped as they are yielded, so that a resumed batch
        # does not replay them), and the combined run's iteration at which
        # the batch began
        self.first_points = []
        self.it0 = 0

    # ------------------------------------------------------------------
    # persistence

    def save(self, fname):
        """Write the whole sampler to ``fname`` (atomically)."""
        save_sampler(self, fname)

    @staticmethod
    def restore(fname, device=None, pool=None, mesh=None):
        """The sampler saved in ``fname``, on the device it was saved
        from unless ``device`` names another (a ``cuda`` checkpoint raises
        where CUDA is absent), with ``pool`` and ``mesh`` attached."""
        return restore_sampler(fname, device=device, pool=pool, mesh=mesh)

    def __getstate__(self):
        self._ensure_live_mirror()
        state = self.__dict__.copy()
        for k in ("_live_dev", "_live_blob_dev", "_bound_upload",
                  "_mirror_stale", "pool", "mesh",
                  "last_proposals_sharding"):
            state.pop(k, None)
        state["device"] = str(self.device)  # stored by name
        return state

    def __setstate__(self, state):
        # checkpoints written before blobs, pools and citations existed
        for k, v in (("blob", False), ("live_blobs", None),
                     ("use_pool", {}), ("cite", ""),
                     ("_dispatch_rec0", None),
                     ("_live_bound_marked",
                      np.zeros(len(state["live_u"]), dtype=bool))):
            state.setdefault(k, v)
        self.__dict__ = state
        self.device = torch.device(state["device"])
        self._live_dev = None
        self._live_blob_dev = None
        self._bound_upload = None
        self._mirror_stale = False
        self.pool = None
        self.mesh = None
        self.last_proposals_sharding = None

    def set_device(self, device):
        """Move the sampler to ``device``: the host mirrors are brought up
        to date, and every device tensor and built round is dropped, to be
        made anew there."""
        self._ensure_live_mirror()
        self.device = torch.device(device)
        self.loglikelihood.device = self.device
        for b in [self.bound, self.bound_next] + list(self.bound_list):
            if hasattr(b, "device"):
                b.device = self.device
        for s in (self.internal_sampler, self.internal_sampler_next):
            s.drop_device_state()
        self._live_dev = None
        self._live_blob_dev = None
        self._bound_upload = None

    def reset(self):
        """Re-initialize: fresh live points from the prior and a cleared
        run state."""
        live_points, logvol_init, init_ncalls = initialize_live_points(
            None, self.loglikelihood, self.nlive, self.ndim, self.rstate,
            blob=self.blob)
        self.live_u, self.live_v, self.live_logl = live_points[:3]
        self.live_blobs = live_points[3]
        self.live_bound = np.zeros(self.nlive, dtype=int)
        self._live_bound_marked = np.zeros(self.nlive, dtype=bool)
        self.live_it = np.zeros(self.nlive, dtype=int)
        self.live_birth = np.full(self.nlive, -np.inf)
        self.logvol_init = logvol_init
        self.it = 1
        self.ncall = init_ncalls
        self.added_live = False
        self.eff = 0.0
        self.unit_cube_sampling = True
        self.bound = UnitCube(self.ncdim)
        self.bound_list = [self.bound]
        self.nbound = 1
        self.bound_version += 1
        self.logl_first_update = None
        self.ncall_at_last_update = 0
        self.bound_next = get_bound(self.bounding, self.ncdim,
                                    device=self.device)
        self.internal_sampler = UnitCubeSampler(ndim=self.ndim)
        self.plateau_mode = False
        self.plateau_counter = None
        self.plateau_logdvol = None
        self.saved_run = RunRecord()
        self.timings = Timings()
        self._live_dev = None
        self._live_blob_dev = None
        self._mirror_stale = False
        self._bound_upload = None
        self._init_resume_state()

    # ------------------------------------------------------------------
    # bound management

    def update_bound(self, subset=slice(None)):
        """Refit the bound to the current live points; the bootstrap
        realisations map over the pool where ``use_pool['update_bound']``
        (the default when a pool is given)."""
        pool = self.pool if self.use_pool.get("update_bound", True) \
            else None
        self.bound.update(self.live_u[subset, :self.ncdim],
                          rstate=self.rstate,
                          bootstrap=self.bound_bootstrap, pool=pool)
        self.bound_version += 1
        if self.bound_enlarge != 1.0:
            self.bound.scale_to_logvol(self.bound.logvol +
                                       np.log(self.bound_enlarge))

    def _refit_due(self, loglstar, ncall):
        """Whether the refit trigger fires: the first update once
        unit-cube sampling becomes inefficient, then every
        ``bound_update_interval`` calls."""
        if self.unit_cube_sampling:
            return bool((self.eff < self.first_bound_update_eff
                         and ncall >= self.first_bound_update_ncall)
                        or (self.logl_first_update is not None
                            and loglstar > self.logl_first_update))
        return ncall >= self.bound_update_interval + \
            self.ncall_at_last_update

    def update_bound_if_needed(self, loglstar, ncall=None, force=False):
        """Refit the bound where :meth:`_refit_due` (checked between
        dispatches) or ``force``."""
        if ncall is None:
            ncall = self.ncall
        if force or self._refit_due(loglstar, ncall):
            self._ensure_live_mirror()
            t0 = time.perf_counter()
            subset = self.live_logl > loglstar if loglstar == LOWL_VAL \
                else slice(None)
            if self.unit_cube_sampling:
                self.unit_cube_sampling = False
                self.logl_first_update = loglstar
                self.bound = self.bound_next
                self.internal_sampler = self.internal_sampler_next
            self.update_bound(subset=subset)
            if self.save_bounds:
                self.bound_list.append(copy.deepcopy(self.bound))
            self.nbound += 1
            self.ncall_at_last_update = ncall
            self.timings.add("refit", time.perf_counter() - t0)
            self.timings.count("n_refit")

    def ensure_startpoints_bounded(self, idxs):
        """Force a bound refit if any selected start point escaped the
        bound."""
        if self.bound.need_centers:
            self.bound.ctrs = self.live_u
        for i in np.unique(idxs):
            u_fit = self.live_u[i, :self.ncdim]
            if not self.bound.contains(u_fit):
                self.update_bound_if_needed(-np.inf, force=True)
                if self.bound.need_centers:
                    self.bound.ctrs = self.live_u
                if not self.bound.contains(u_fit):
                    raise RuntimeError("Update of the bound failed")
                break

    # ------------------------------------------------------------------
    # device state

    def device_bound_kind(self):
        """Bound kind of the device rounds ('cube' before the first
        update; 'custom' for a bound without a device export, which is
        sampled on the host)."""
        if self.unit_cube_sampling:
            return "cube"
        spec = self.bound.device_spec()
        return "custom" if spec is None else spec[0]

    def device_bound_arrays(self, spec=None):
        """Device upload of the active bound's arrays, cached per refit.
        Ellipsoid stacks carry ``expand``, the host's latest bootstrap x
        enlarge calibration as a linear factor, for the device refit;
        friends centres are uploaded anew every dispatch.  A custom bound
        gives the axes its ``get_random_axes`` drew for the dispatch
        ``spec`` (a planned dispatch or a continuation).  A dispatch
        planned ahead of a refit that moved the bound runs on the copy
        its spec keeps (``bound_used``), uploaded past the cache."""
        if spec is not None and spec.get("bound_used") is not None and \
                spec["bound_version_used"] != self.bound_version:
            return self._upload_bound(spec["bound_used"], "ellipsoids")
        kind = self.device_bound_kind()
        if kind == "custom":
            return bound_arrays_to_torch(
                kind, {"axes": spec["custom_axes"]}, self.device, self.dtype)
        cached = self._bound_upload
        if cached is None or cached[0] != self.bound_version or \
                cached[1] != kind:
            dev = self._upload_bound(self.bound, kind)
            self._bound_upload = cached = (self.bound_version, kind, dev)
        dev = cached[2]
        if kind in ("balls", "cubes"):
            dev = dict(dev, ctrs=torch.as_tensor(
                np.asarray(self.bound.ctrs), dtype=self.dtype,
                device=self.device))
        return dev

    def _upload_bound(self, bound, kind):
        """``bound``'s arrays on the device, for a bound of ``kind``."""
        arrays = {} if kind == "cube" else dict(bound.device_spec()[1])
        if kind == "ellipsoids":
            arrays["expand"] = getattr(bound, "last_expand", 1.0) \
                * self.bound_enlarge ** (1.0 / self.ncdim)
        return bound_arrays_to_torch(kind, arrays, self.device, self.dtype)

    def _live_packed(self):
        """Host live mirrors packed as u | v | logl | it | bound | birth."""
        return np.concatenate([
            self.live_u, self.live_v, self.live_logl[:, None],
            self.live_it[:, None].astype(np.float64),
            np.where(self._live_bound_marked, -1,
                     self.live_bound)[:, None].astype(np.float64),
            np.asarray(self.live_birth, dtype=np.float64)[:, None],
        ], axis=1)

    def _sync_live(self, live, bounditer):
        """Write a downloaded live matrix into the host mirrors, resolving
        the device's -1 'current bound' marker."""
        ndim, npdim = self.ndim, self.loglikelihood.npdim
        self.live_u = np.array(live[:, :ndim], dtype=np.float64)
        self.live_v = np.array(live[:, ndim:ndim + npdim], dtype=np.float64)
        self.live_logl = np.array(live[:, ndim + npdim], dtype=np.float64)
        self.live_it = live[:, ndim + npdim + 1].astype(int)
        lb = live[:, ndim + npdim + 2].astype(int)
        # the device keeps the mark on a point born since the last upload,
        # and a record resolves it to the bound of the dispatch the point
        # dies in; a re-upload (a restored run) marks it again, so that
        # its record is the uninterrupted run's
        self._live_bound_marked = lb < 0
        lb[lb < 0] = bounditer
        self.live_bound = lb
        self.live_birth = np.array(live[:, ndim + npdim + 3],
                                   dtype=np.float64)

    def _ensure_live_mirror(self):
        """Refresh the host mirrors from the device-resident live state."""
        if self._mirror_stale:
            t0 = time.perf_counter()
            self._sync_live(self._live_dev.cpu().numpy(),
                            self._mirror_bounditer)
            if self._live_blob_dev is not None:
                self.live_blobs = tree_map(lambda b: b.cpu().numpy(),
                                           self._live_blob_dev)
            self._mirror_stale = False
            self.timings.add("mirror", time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # dispatch planning

    def _estimate_remaining(self, dlogz_eff, loglstar, logl_max=np.inf):
        """Accepts remaining before a stop, or None.  delta_logz decays
        ~exp(-i/nlive), which gives the accepts left to the dlogz
        criterion; a run bracketed by a finite ``logl_max`` (a dynamic
        batch) also extrapolates its progress through the bracket, and
        takes the length its configurator read off the saved run
        (``_bracket_est_total``), known from its first round on."""
        est = None
        last = self._last_delta_logz
        if last is not None and np.isfinite(dlogz_eff) and dlogz_eff > 0 \
                and last > 0:
            est = 1.1 * self.nlive * max(np.log(last) - np.log(dlogz_eff),
                                         0.0)
        if np.isfinite(logl_max):
            if self._bracket_start is None and np.isfinite(loglstar) \
                    and loglstar > LOWL_VAL / 2:
                self._bracket_start = float(loglstar)
                self._bracket_it0 = int(self.it)
            start = self._bracket_start
            if start is not None and loglstar > start and logl_max > start:
                prog = min((loglstar - start) / (logl_max - start), 0.999)
                done_iters = max(self.it - self._bracket_it0, 1)
                est2 = 1.2 * done_iters * (1.0 - prog) / prog
                est = est2 if est is None else min(est, est2)
            if self._bracket_est_total is not None:
                est3 = 1.2 * max(self._bracket_est_total - (self.it - 1),
                                 0.0)
                est = est3 if est is None else min(est, est3)
        return est

    def _make_dispatch_spec(self, dlogz_eff, loglstar, logl_max=np.inf,
                            refit=True):
        """Plan one fused dispatch: run the refit trigger (the only place
        host refits fire; ``refit=False`` leaves it to the caller, who plans
        ahead of it), choose the dispatch's width and active rounds
        from the remaining-work estimate, and draw the dispatch's seed
        from the host stream.  A bracketed run with less than three
        quarters of a full round left takes the narrow width, so that the
        stop at ``logl_max`` strands few proposals.

        The spec is kept as ``_next_spec`` until its dispatch is consumed,
        so the dispatch structure is a pure function of pickled state.  It
        records the refit-due ncall (ctrl[21]) it was planned with, and
        the launch uses the recorded value: a spec launched after the
        sampler's counters have moved (one planned ahead of its refit)
        still runs the gate it was planned with.  The
        maxiter/maxcall budgets must not shape the dispatch, for the same
        reason.  Under a custom bound the spec also holds the axes drawn
        from the host stream for the dispatch's proposals."""
        if refit:
            self.update_bound_if_needed(max(loglstar, np.float64(LOWL_VAL)),
                                        ncall=self.ncall)
        est = self._estimate_remaining(dlogz_eff, loglstar, logl_max)
        q = self._q_full
        if est is not None and est < 0.75 * q and self._q_narrow < q \
                and np.isfinite(logl_max):
            q = self._q_narrow
        if not self.unit_cube_sampling or est is None:
            # the device skips every chained round past a stop, so an
            # overshoot proposes and bills nothing: chain the full depth
            rounds_active = None
        else:
            rounds_active = max(1, int(math.ceil(
                (min(est, 2**30) + q // 2) / q)))
        spec = {"key_seed": int(self.rstate.integers(0, 2**63 - 1)),
                "queue_size": q, "rounds_active": rounds_active,
                "refit_due_ncall":
                    self.internal_sampler._refit_due_ncall(self)}
        if self.device_bound_kind() == "custom":
            # the dispatch's axes are part of its plan: a continuation of
            # the dispatch runs with them and draws none of its own
            spec["custom_axes"] = np.asarray(
                self.bound.get_random_axes(self.rstate))
        return spec

    def _pipeline_capable(self):
        """Whether a dispatch that is over plans the next one ahead of the
        refit trigger (the JAX package's rule): not in the unit-cube phase
        (its first refit swaps the proposal kernel), not with a host-mode
        likelihood, and only over ellipsoids (friends and custom bounds
        take fresh host centres or axes at launch)."""
        if self.unit_cube_sampling or self.loglikelihood.mode == "host":
            return False
        return self.device_bound_kind() == "ellipsoids"

    def _plan_ahead(self, dlogz_eff, loglstar, logl_max):
        """Plan the next dispatch on the current bound, then run the refit
        trigger: the JAX package's pre-launch order (the seed is drawn
        before any bootstrap draw).  Where the refit will move the bound,
        the spec keeps a copy of the bound it was planned on.  The spec
        waits in ``_next_spec`` and is launched at the loop top."""
        t0 = time.perf_counter()
        loglstar_round = max(loglstar, np.float64(LOWL_VAL))
        spec = self._make_dispatch_spec(dlogz_eff, loglstar, logl_max,
                                        refit=False)
        spec["bounditer"] = self.nbound - 1
        if self._refit_due(loglstar_round, self.ncall):
            spec["bound_used"] = copy.deepcopy(self.bound)
            spec["bound_version_used"] = self.bound_version
        self._next_spec = spec
        self.timings.add("prelaunch", time.perf_counter() - t0)
        self.timings.count("n_prelaunch")
        self.update_bound_if_needed(loglstar_round, ncall=self.ncall)

    # ------------------------------------------------------------------
    # proposal queue (non-fused rounds)

    def _fill_queue(self, loglstar):
        """Run one proposal round of width ``queue_size`` on the device
        and queue its rows on the host."""
        gen = get_torch_generator(self.rstate, self.device)
        self.queue, self._pending_tuning = \
            self.internal_sampler.propose_round(self, loglstar,
                                                self.queue_size, gen)

    def _get_point_value(self, loglstar):
        if not self.queue:
            self._fill_queue(loglstar)
        return self.queue.pop(0)

    def _new_point(self, loglstar):
        """Pop proposals until one beats ``loglstar``; when the queue
        drains, apply its round's tuning and run the refit trigger.
        Returns ``(u, v, logl, nc, blob, proposal_stats)`` with ``nc`` the
        evaluations of every popped row."""
        ncall = self.ncall
        ncall_accum = 0
        while True:
            ret = self._get_point_value(loglstar)
            ncall_accum += ret["nc"]
            ncall += ret["nc"]
            if not self.queue:
                if self._pending_tuning is not None \
                        and not self.unit_cube_sampling:
                    self.internal_sampler.tune(self._pending_tuning,
                                               update=True)
                self._pending_tuning = None
                self.update_bound_if_needed(loglstar, ncall=ncall)
            if ret["logl"] > loglstar:
                break
        return (ret["u"], ret["v"], ret["logl"], ncall_accum, ret["blob"],
                ret["proposal_stats"])

    # ------------------------------------------------------------------
    # results

    @property
    def n_effective(self):
        """Kish effective sample size of the current weights."""
        logwt = np.asarray(self.saved_run["logwt"])
        if len(logwt) == 0 or np.max(logwt) == -np.inf:
            return 0
        return get_neff_from_logwt(logwt)

    @property
    def citations(self):
        """The references of this configuration, printable."""
        return self.cite

    @property
    def results(self):
        """Results of the run packaged as an immutable record."""
        d = {}
        for k in ("nc", "v", "id", "it", "u", "n", "birth", "logwt",
                  "logl", "logvol", "logz", "logzvar", "h", "bounditer",
                  "boundidx", "scale", "blob", "proposal_stats"):
            d[k] = np.array(self.saved_run[k])
        birth = d["birth"].astype(np.float64)
        birth[birth <= -1e29] = -np.inf
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            results = [("nlive", self.nlive), ("niter", self.it - 1),
                       ("ncall", d["nc"]), ("eff", self.eff),
                       ("samples", d["v"]), ("blob", d["blob"]),
                       ("samples_id", d["id"]), ("samples_it", d["it"]),
                       ("samples_n", d["n"].astype(int)),
                       ("samples_birth", birth),
                       ("samples_u", d["u"]), ("logwt", d["logwt"]),
                       ("logl", d["logl"]), ("logvol", d["logvol"]),
                       ("logz", d["logz"]),
                       ("logzerr", np.sqrt(np.maximum(d["logzvar"], 0))),
                       ("information", d["h"]),
                       ("bound_iter", d["bounditer"]),
                       ("samples_bound", d["boundidx"]),
                       ("scale", d["scale"]),
                       ("proposal_stats", d["proposal_stats"])]
            if self.save_bounds:
                results.append(("bound", copy.deepcopy(self.bound_list)))
        return Results(results)

    # ------------------------------------------------------------------
    # the main loop

    def sample(self, maxiter=None, maxcall=None, dlogz=0.01,
               logl_max=np.inf, add_live=True, save_bounds=True,
               resume=False, per_dispatch=False):
        """Generator yielding one dead point per iteration, or one
        :class:`IteratorBlock` per dispatch with ``per_dispatch=True``.

        Synchronous: launch a dispatch, wait for its flat result, append
        its records and run the refit trigger before the next one; over
        ellipsoids the next one is planned before that refit
        (:meth:`_plan_ahead`).

        A stop by ``maxiter``/``maxcall`` sets ``interrupted_budget`` and
        keeps what the stopped dispatch left: ``sample(resume=True)``
        first replays the interrupted round's unconsumed proposals (no
        random number is drawn), then regenerates the dispatch's remaining
        rounds from its seed, and goes on as the uninterrupted run would.
        ``add_live`` is accepted for the callers' convention; the live
        points are added by :meth:`add_live_points`."""
        if maxcall is None:
            maxcall = sys.maxsize
        if maxiter is None:
            maxiter = sys.maxsize
        self.save_bounds = save_bounds
        self.interrupted_budget = False
        ncall = 0
        if self.it == 1 or len(self.saved_run["logl"]) == 0:
            h, logz, logzvar = 0.0, LOWL_VAL, 0.0
            logvol, loglstar = self.logvol_init, LOWL_VAL
        else:
            if self.added_live and not resume:
                warnings.warn("Repeatedly running sample() or run_nested() "
                              "(not resuming) is deprecated",
                              DeprecationWarning)
                self._remove_live_points()
            h, logz, logzvar, logvol, loglstar = [
                self.saved_run[k][-1]
                for k in ("h", "logz", "logzvar", "logvol", "logl")]
        ndim, npdim = self.ndim, self.loglikelihood.npdim
        il = ndim + npdim
        nc_col = il + 1  # nc column of the proposals block
        rec_off = 1 + il
        dlogz_eff = -np.inf if dlogz is None else dlogz
        accepted = 0
        # a natural stop can leave pending yields to drain, and a
        # checkpoint can fall into that drain: the stop is pickled state,
        # or a resumed run would plan a dispatch (and draw a seed) that
        # the uninterrupted run never made
        if not resume:
            self._terminal_done = False
        terminal = bool(self._terminal_done) and resume
        if self._integ is not None and resume:
            st = self._integ
            logz, logzvar = st["logz"], st["logzvar"]
            h, logvol, loglstar = st["h"], st["logvol"], st["loglstar"]
        pending_block = None

        def upload_live():
            if self._live_dev is None:
                self._live_dev = live_to_torch(
                    self._live_packed(), self.device, self.dtype,
                    ndim=ndim, npdim=npdim)
                self._live_blob_dev = tree_map(
                    lambda b: torch.as_tensor(np.asarray(b),
                                              device=self.device),
                    self.live_blobs)

        while True:
            # drain the staged yields (their rows are in saved_run already)
            while self._pending_records:
                row = self._pending_records.pop(0)
                accepted += 1
                ncall += row["nc"]
                yield IteratorResult(**row)
            if pending_block is not None:
                accepted += pending_block.n
                ncall += pending_block.nc
                yield pending_block
                pending_block = None
            if terminal:
                self.interrupted_budget = False
                break
            if accepted >= maxiter or ncall >= maxcall:
                self.interrupted_budget = True
                warnings.warn(
                    "Sampling stopped short by maxiter/maxcall before "
                    "reaching the dlogz criterion; posterior may be "
                    "poorly sampled.")
                break

            bounditer = 0 if self.unit_cube_sampling else self.nbound - 1
            # f32-safe clamp of the -1e300 sentinel
            integ = np.array([
                max(logz, -1e30), logzvar, h, logvol, max(loglstar, -1e30),
                float(bool(self.plateau_mode)),
                float(self.plateau_counter or 0),
                float(self.plateau_logdvol or 0.0), float(self.it)])
            limits = np.array([
                float(dlogz_eff), float(logl_max),
                float(min(maxiter - accepted, 2**30)),
                float(min(maxcall - ncall, 2**30))])

            t0 = time.perf_counter()
            if self._leftover is not None:
                # consume-only replay of an interrupted round's tail, one
                # queue_size chunk at a time, padded with rows that lose
                # every comparison (logl = -1e30, nc = 0)
                upload_live()
                qsz = self.queue_size
                prop = self._leftover["prop"][:qsz]
                n_real_limit = len(prop)
                pad = np.zeros((qsz - n_real_limit, prop.shape[1]))
                pad[:, il] = -1e30
                prop_dev = torch.as_tensor(
                    np.concatenate([prop, pad]), dtype=self.dtype,
                    device=self.device)
                # the padded rows' blobs are zeros
                prop_blob = tree_map(lambda b: torch.as_tensor(
                    np.concatenate([b[:qsz], np.zeros(
                        (qsz - n_real_limit,) + b.shape[1:], b.dtype)]),
                    device=self.device), self._leftover.get("blob"))
                out, live_out, blob_out = self.internal_sampler.run_replay(
                    self, self._live_dev, self._live_blob_dev, prop_dev,
                    prop_blob, integ, limits,
                    kills0=self._leftover["kills"],
                    birth0=self._leftover["birth0"])
                # the interrupted dispatch's bound, which a refit planned
                # behind it may have moved on from
                bounditer = self._leftover.get("bounditer", bounditer)
                skip_off = 0
                dispatch_spec = None
                self.timings.count("n_replay")
            elif self._continuation is not None:
                # the interrupted dispatch's remaining rounds, from its own
                # seed with the consumed rounds skipped: the replay has
                # brought the live set to where those rounds start.  No
                # refit and no draw from the host stream here.
                cont = self._continuation
                self._continuation = None
                self.queue_size = cont["queue_size"]
                bounditer = cont.get("bounditer", bounditer)
                upload_live()
                out, live_out, blob_out = self.internal_sampler.run_fused(
                    self, cont["key_seed"], self._live_dev,
                    self._live_blob_dev, self.device_bound_arrays(cont),
                    integ,
                    limits,
                    rounds_active=cont["rounds"], rounds_skip=cont["skip"],
                    refit_due_ncall=cont["refit_due_ncall"])
                skip_off = cont["skip"] * self.queue_size
                dispatch_spec = cont
                n_real_limit = min(len(out["accepts"]),
                                   cont["rounds"] * self.queue_size)
                if out["done_reason"] & 32 and not out["done_reason"] & 31:
                    # chain-stop gate: the gated rounds never ran
                    n_real_limit = skip_off + out["n_consumed"]
                self.timings.count("n_continuation")
            else:
                spec = self._next_spec
                if spec is None:
                    spec = self._make_dispatch_spec(dlogz_eff, loglstar,
                                                    logl_max)
                    self._next_spec = spec
                    # a refit may have run: the first one swaps the bound
                    bounditer = 0 if self.unit_cube_sampling \
                        else self.nbound - 1
                else:
                    # a spec planned ahead names the bound it runs on,
                    # which the refit behind it may have moved on from
                    bounditer = spec.get("bounditer", bounditer)
                self.queue_size = spec["queue_size"]
                axes_args = self.device_bound_arrays(spec)
                upload_live()
                t0 = time.perf_counter()
                handle = self.internal_sampler.launch_fused(
                    self, spec["key_seed"], self._live_dev,
                    self._live_blob_dev, axes_args, integ, limits,
                    rounds_active=spec["rounds_active"],
                    refit_due_ncall=spec["refit_due_ncall"])
                out, live_out, blob_out = \
                    self.internal_sampler.finish_fused(handle)
                # consumed below: this spec is no longer the next one
                self._next_spec = None
                skip_off = 0
                dispatch_spec = spec
                n_real_limit = min(len(out["accepts"]),
                                   handle["rounds_active"] * self.queue_size)
                if out["done_reason"] & 32 and not out["done_reason"] & 31:
                    n_real_limit = out["n_consumed"]  # chain-stop gate
            self.timings.add("dispatch", time.perf_counter() - t0)
            if self.mesh is not None:
                # each round's lanes were split over the mesh in equal
                # chunks (the likelihood's mesh_eval)
                self.last_proposals_sharding = batch_sharding(
                    self.mesh, out["proposals_dev"].dim())
            self.timings.count("n_dispatch")
            self.timings.count("sync_flat")
            t_cons0 = time.perf_counter()
            self.timings.count("nc_launched", out["nc_launched"])

            # ---- what the dispatch left unconsumed
            n_cons = min(out["n_consumed"], n_real_limit - skip_off)
            kept_nc = 0
            if self._leftover is not None:
                # chunked replay: drop the consumed prefix; the kill offset
                # advances by this chunk's deaths
                lo = self._leftover
                prop_rest = lo["prop"][n_cons:]
                if len(prop_rest):
                    kept_nc = int(prop_rest[:, nc_col].sum())
                    self._leftover = dict(
                        lo, prop=prop_rest,
                        blob=tree_map(lambda b: b[n_cons:], lo.get("blob")),
                        kills=lo["kills"] + out["n_accepted"])
                else:
                    # tail replayed: the interrupted dispatch's remaining
                    # rounds come next
                    self._continuation = lo["cont"]
                    self._leftover = None
            elif n_cons < n_real_limit - skip_off:
                # the dispatch ended early.  Only the interrupted round's
                # own tail can be replayed as it is; later rounds propose
                # from a live set that the replay still has to advance, so
                # they are recorded as a continuation.
                qr = self.queue_size
                g = skip_off + n_cons  # global entry index of the stop
                r0 = g // qr
                lo_end = min(n_real_limit, (r0 + 1) * qr)
                kills = int(np.sum(out["accepts"][r0 * qr:g])) \
                    if self.proposal_mode == "batch" else 0
                props = out["proposals_dev"][g:lo_end].cpu().numpy().astype(
                    np.float64)
                n_rounds_exec = n_real_limit // qr
                cont = None
                if r0 + 1 < n_rounds_exec:
                    cont = {"key_seed": dispatch_spec["key_seed"],
                            "skip": r0 + 1, "rounds": n_rounds_exec,
                            "queue_size": qr,
                            "refit_due_ncall":
                                dispatch_spec["refit_due_ncall"]}
                    # the dispatch's own bound: axes drawn for it, or the
                    # copy of the bound it was planned on
                    for k in ("custom_axes", "bounditer", "bound_used",
                              "bound_version_used"):
                        if k in dispatch_spec:
                            cont[k] = dispatch_spec[k]
                if len(props):
                    kept_nc = int(props[:, nc_col].sum())
                    # births of the refills made while replaying the tail:
                    # the interrupted round's threshold
                    self._leftover = {
                        "prop": props, "kills": kills, "cont": cont,
                        "bounditer": bounditer,
                        "birth0": float(out["round_thresholds"][r0]),
                        "blob": tree_map(
                            lambda b: b[g:lo_end].cpu().numpy(),
                            out["qblob_dev"])}
                else:
                    self._continuation = cont

            # ---- adopt the device-side state
            self._live_dev = live_out
            self._live_blob_dev = blob_out
            self._mirror_stale = True
            self._mirror_bounditer = bounditer
            if out["n_consumed"] > 0:
                last_i = min(skip_off + out["n_consumed"],
                             len(out["delta_logz"])) - 1
                self._last_delta_logz = float(out["delta_logz"][last_i])
            ig = out["integ"]
            logz, logzvar = float(ig["logz"]), float(ig["logzvar"])
            h, logvol = float(ig["h"]), float(ig["logvol"])
            loglstar = float(ig["loglstar"])
            self.plateau_mode = ig["plateau_mode"]
            self.plateau_counter = ig["plateau_counter"]
            self.plateau_logdvol = float(ig["plateau_logdvol"])
            self.it = ig["it"]
            self._integ = dict(logz=logz, logzvar=logzvar, h=h,
                               logvol=logvol, loglstar=loglstar)
            nc_round = out["nc_used"]
            # exact billing: evaluations launched by this dispatch that
            # were neither consumed nor kept for the replay are charged now
            extra_nc = max(out["nc_launched"] - nc_round - kept_nc, 0)
            self.ncall += nc_round + extra_nc
            self.nc_waste_total += extra_nc
            has_records = bool(out["accepts"].any())
            staged_nc = int(np.sum(
                out["records"][out["accepts"], rec_off + 6]))
            carry_in = self._nc_accum_carry if has_records else 0
            if per_dispatch:
                pending_block = IteratorBlock(n=0, nc=nc_round + extra_nc)
            else:
                # the yields bring staged_nc and carry_in: add the rest
                # (the discarded entries' calls) here
                ncall += nc_round - staged_nc - carry_in
            self.eff = 100.0 * (self.it - 1) / max(self.ncall, 1)
            if out["stats"] is not None and not self.unit_cube_sampling:
                self.internal_sampler.apply_fused_tuning(out)

            # terminal causes: 1=dlogz, 2=logl_max, 4=live plateau
            if out["done_reason"] & 0b111:
                if out["done_reason"] & 0b100:
                    warnings.warn("A likelihood plateau was reached; "
                                  "stopping the run.")
                terminal = True
                self._terminal_done = True
                if self._leftover is not None:
                    # the run is over: bill the kept evaluations, drop them
                    lo_nc = int(self._leftover["prop"][:, nc_col].sum())
                    self.ncall += lo_nc
                    extra_nc += lo_nc
                    self._leftover = None
                # a continuation is work never launched: nothing to bill
                self._continuation = None
                self._next_spec = None
                # nothing is launched ahead of its turn, so none strands
                self.timings.count("nc_stranded_pipeline", 0)
            if self._leftover is None and self._continuation is None:
                self._nc_accum_carry = 0  # the dispatch is over
                self.internal_sampler.end_dispatch()
                if not terminal and self._pipeline_capable():
                    # whatever stopped inside this dispatch has been
                    # replayed by now: the state is the uninterrupted run's
                    t_plan0 = time.perf_counter()
                    self._plan_ahead(dlogz_eff, loglstar, logl_max)
                    # the plan and its refit are timed as their own
                    # (prelaunch, refit), not as consume
                    t_cons0 += time.perf_counter() - t_plan0
            elif has_records:
                self._nc_accum_carry = nc_round - staged_nc
            else:
                self._nc_accum_carry += nc_round

            rec0 = len(self.saved_run.D["scale"])
            n_new = self._append_records(out, bounditer, extra_nc, carry_in,
                                         per_dispatch)
            if self._leftover is not None or self._continuation is not None:
                if self._dispatch_rec0 is None:
                    self._dispatch_rec0 = rec0
            elif self._dispatch_rec0 is not None:
                # as in the uninterrupted run, every record of the dispatch
                # carries the scale after its last round
                scales = self.saved_run.D["scale"]
                scales[self._dispatch_rec0:] = \
                    [self.internal_sampler.scale] * \
                    (len(scales) - self._dispatch_rec0)
                self._dispatch_rec0 = None
            if per_dispatch:
                pending_block = IteratorBlock(n=n_new, nc=pending_block.nc)
            self.timings.add("consume", time.perf_counter() - t_cons0)
        self._ensure_live_mirror()

    def _append_records(self, out, bounditer, extra_nc, carry_in,
                        per_dispatch):
        """Append one dispatch's accepted records to ``saved_run`` (each
        with the blob of its dead point) and, unless ``per_dispatch``,
        stage their per-record yields; returns the number of records."""
        ndim, npdim = self.ndim, self.loglikelihood.npdim
        rec_off = 1 + ndim + npdim
        recs = np.asarray(out["records"], dtype=np.float64)
        acc_idx = np.nonzero(out["accepts"])[0]
        n_new = len(acc_idx)
        # speculative work not tied to a death goes to the dispatch's last
        # record, carried over when a dispatch produced none
        extra_nc += self._nc_carry
        self._nc_carry = 0 if n_new else extra_nc
        if not n_new:
            return 0
        tail = recs[acc_idx, rec_off:rec_off + 11]
        tail[-1, 6] += extra_nc
        # discarded entries of the interrupted dispatch's earlier part
        tail[0, 6] += carry_in
        worsts = recs[acc_idx, 0].astype(int)
        bidx = tail[:, 8].astype(int)
        bidx[bidx < 0] = bounditer
        scale_now = self.internal_sampler.scale
        if self.unit_cube_sampling:
            row_stats = [None] * n_new
        else:
            ls = out["lane_stats"][acc_idx]
            row_stats = [self.internal_sampler.row_stats(*ls[j])
                         for j in range(n_new)]
        D = self.saved_run.D
        D["id"].extend(worsts.tolist())
        D["u"].extend(list(recs[acc_idx, 1:1 + ndim]))
        D["v"].extend(list(recs[acc_idx, 1 + ndim:rec_off]))
        for j, k in enumerate(("logl", "logvol", "logwt", "logz", "logzvar",
                               "h")):
            D[k].extend(tail[:, j].tolist())
        D["nc"].extend(tail[:, 6].astype(int).tolist())
        D["it"].extend(tail[:, 7].astype(int).tolist())
        D["n"].extend(tail[:, 9].astype(int).tolist())
        D["birth"].extend(tail[:, 10].tolist())
        D["bounditer"].extend([bounditer] * n_new)
        D["boundidx"].extend(bidx.tolist())
        D["scale"].extend([scale_now] * n_new)
        old_blobs = tree_map(lambda b: b.cpu().numpy()[acc_idx],
                             out["old_blobs_dev"])
        blobs = [blob_row(old_blobs, j) for j in range(n_new)]
        D["blob"].extend(blobs)
        D["proposal_stats"].extend(row_stats)
        if per_dispatch:
            return n_new
        dlz = out["delta_logz"]
        self._pending_records.extend(
            dict(worst=int(worsts[j]), ustar=recs[i, 1:1 + ndim],
                 vstar=recs[i, 1 + ndim:rec_off], loglstar=tail[j, 0],
                 logvol=tail[j, 1], logwt=tail[j, 2], logz=tail[j, 3],
                 logzvar=tail[j, 4], h=tail[j, 5], nc=int(tail[j, 6]),
                 n=int(tail[j, 9]), birth=tail[j, 10], blob=blobs[j],
                 worst_it=int(tail[j, 7]), boundidx=int(bidx[j]),
                 bounditer=bounditer, eff=self.eff,
                 delta_logz=float(dlz[i]), proposal_stats=row_stats[j])
            for j, i in enumerate(acc_idx))
        return n_new

    def add_live_points(self):
        """Recycle the final live points as dead points over the remaining
        volume."""
        if self.added_live:
            raise ValueError("The remaining live points have already "
                             "been added to the list of samples!")
        self._ensure_live_mirror()
        self.added_live = True
        if len(self.saved_run["logz"]) > 0:
            logz, logzvar, h, loglstar, logvol = [
                self.saved_run[k][-1]
                for k in ("logz", "logzvar", "h", "logl", "logvol")]
        else:
            h, logz, logzvar = 0.0, LOWL_VAL, 0.0
            logvol, loglstar = self.logvol_init, LOWL_VAL

        lsort_idx = np.argsort(self.live_logl)
        logl_sorted = self.live_logl[lsort_idx]
        births = np.asarray(self.live_birth, float)
        # thread-aware live counts: a point born at or above the current
        # death level is not active there
        cnt_ge = self.nlive - np.searchsorted(np.sort(births), logl_sorted,
                                              side="left")
        ramp_n = np.maximum(self.nlive - np.arange(self.nlive) - cnt_ge, 1)
        if not self.plateau_mode:
            logvols = np.cumsum(-np.log1p(1.0 / ramp_n))
        else:
            logvols = np.log1p(-((1 + np.arange(self.plateau_counter)) *
                                 np.exp(self.plateau_logdvol - logvol)))
            nrest = self.nlive - self.plateau_counter
            logvols = np.concatenate([
                logvols, logvols[-1] +
                np.log1p(-(1 + np.arange(nrest)) / (nrest + 1.0))])
        dlvs = -np.diff(logvols, prepend=0)
        logvols += logvol
        loglmax = max(self.live_logl)
        bounditer = self.nbound - 1 if not self.unit_cube_sampling else 0

        for i in range(self.nlive):
            idx = lsort_idx[i]
            logvol, dlv = logvols[i], dlvs[i]
            ustar = self.live_u[idx].copy()
            vstar = self.live_v[idx].copy()
            old_blob = tree_map(copy.copy, blob_row(self.live_blobs, idx))
            loglstar_new = self.live_logl[idx]
            n = int(ramp_n[i]) if not self.plateau_mode else self.nlive - i
            logwt, logz, logzvar, h = progress_integration(
                loglstar, loglstar_new, logz, logzvar, logvol, dlv, h)
            loglstar = loglstar_new
            delta_logz = np.logaddexp(0, loglmax + logvol - logz)
            row = dict(worst=idx, ustar=ustar, vstar=vstar,
                       loglstar=loglstar, logvol=logvol, logwt=logwt,
                       logz=logz, logzvar=logzvar, h=h, nc=1, n=n,
                       birth=births[idx], blob=old_blob,
                       worst_it=self.live_it[idx],
                       boundidx=self.live_bound[idx], bounditer=bounditer)
            self.saved_run.append(dict(
                id=idx, u=ustar, v=vstar, logl=loglstar, logvol=logvol,
                logwt=logwt, logz=logz, logzvar=logzvar, h=h, nc=1, n=n,
                birth=births[idx], boundidx=row["boundidx"],
                it=row["worst_it"], bounditer=bounditer,
                scale=self.internal_sampler.scale, blob=old_blob,
                proposal_stats=None))
            self.eff = 100.0 * (self.it + i) / self.ncall
            yield IteratorResult(eff=self.eff, delta_logz=delta_logz,
                                 proposal_stats=None, **row)

    def _remove_live_points(self):
        """Drop previously added live points from the saved run."""
        if not self.added_live:
            raise ValueError("No live points were added to the "
                             "list of samples!")
        self.added_live = False
        for k in self.saved_run.keys():
            del self.saved_run[k][-self.nlive:]

    def run_nested(self, maxiter=None, maxcall=None, dlogz=None,
                   logl_max=np.inf, add_live=True, print_progress=True,
                   print_func=None, save_bounds=True, checkpoint_file=None,
                   checkpoint_every=60, resume=False):
        """Run the full static fit (a loop around :meth:`sample`).  With
        ``checkpoint_file`` the sampler is saved there every
        ``checkpoint_every`` seconds and at the end; ``resume=True``
        continues a stopped (and possibly restored) run."""
        if resume and self.added_live:
            warnings.warn("Cannot resume a successfully finished run; "
                          "no sampling performed.", RuntimeWarning)
            return
        if dlogz is None:
            dlogz = 1e-3 * (self.nlive - 1.0) + 0.01 if add_live else 0.01
        pbar, print_func = get_print_func(print_func, print_progress)
        if checkpoint_file is not None:
            timer = DelayTimer(checkpoint_every)
        t_run0 = time.perf_counter()
        try:
            ncall = self.ncall
            for results in self.sample(maxiter=maxiter, maxcall=maxcall,
                                       dlogz=dlogz, logl_max=logl_max,
                                       save_bounds=save_bounds,
                                       resume=resume, add_live=add_live,
                                       per_dispatch=not print_progress):
                ncall += results.nc
                if print_progress:
                    print_func(results, self.it - 1, ncall, dlogz=dlogz)
                if checkpoint_file is not None and timer.is_time():
                    self.save(checkpoint_file)
            if add_live:
                t_al0 = time.perf_counter()
                for it, results in enumerate(self.add_live_points(), 1):
                    ncall += results.nc
                    if print_progress:
                        print_func(results, self.it - 1 + it, ncall,
                                   add_live_it=it, dlogz=dlogz)
                self.timings.add("add_live", time.perf_counter() - t_al0)
            # re-derive the integrals in one consistent pass
            t_int0 = time.perf_counter()
            new_logwt, new_logz, new_logzvar, new_h = compute_integrals(
                logl=self.saved_run["logl"],
                logvol=self.saved_run["logvol"])
            self.saved_run["logwt"] = new_logwt.tolist()
            self.saved_run["logz"] = new_logz.tolist()
            self.saved_run["logzvar"] = new_logzvar.tolist()
            self.saved_run["h"] = new_h.tolist()
            self.timings.add("integrals", time.perf_counter() - t_int0)
            if checkpoint_file is not None:
                self.save(checkpoint_file)
        finally:
            self.timings.add("total", time.perf_counter() - t_run0)
            if pbar is not None:
                pbar.close()
            self.loglikelihood.finalize_history()
            if print_progress:
                sys.stderr.write("\n")
