"""The static nested sampler: a synchronous host loop over fused device
dispatches (counterpart of ``dynesty_tpu.sampler``).

Each dispatch runs up to ``rounds_per_dispatch`` chained propose+consume
rounds on the device (``internal/fused.py``); between dispatches the host
appends the records, applies the proposal tuning, and refits the bound
when its cadence is due.  The live points stay on the device between
dispatches and are mirrored to the host only for a refit and at the end.
Pipelined pre-launch, leftover replay and checkpoint/resume are not yet
ported.
"""

import copy
import math
import sys
import time
import warnings

import numpy as np
import torch

from .bounding import UnitCube, get_bound
from .internal.kernels import f32_precision
from .internal.samplers import UnitCubeSampler
from .ops.integrals import LOWL_VAL, compute_integrals, progress_integration
from .utils.convert import bound_arrays_to_torch, live_to_torch
from .utils.misc import (IteratorBlock, IteratorResult, Timings,
                         get_print_func, get_random_generator,
                         get_torch_generator)
from .utils.results import Results, RunRecord

__all__ = ["Sampler", "initialize_live_points"]


def initialize_live_points(live_points, loglikelihood, nlive, ndim, rstate):
    """Draw the initial live points by batched rejection sampling from the
    unit cube until enough have finite log-likelihood.

    Returns ``(live_u, live_v, live_logl), logvol_init, ncalls``."""
    logvol_init = 0.0
    ncalls = 0
    if live_points is None:
        n_attempts = 1000
        min_npoints = min(nlive, max(ndim + 1, min(nlive - 20, 100)))
        live_u = np.zeros((nlive, ndim))
        live_logl = np.zeros(nlive)
        live_v = None
        ngoods = 0
        for iattempt in range(1, n_attempts + 1):
            cur_u = rstate.random(size=(nlive, ndim))
            cur_v, cur_logl, _ = loglikelihood.eval_host(cur_u)
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
                ngoods += nextra
            if ngoods >= min_npoints:
                nextra = nlive - ngoods
                if nextra > 0:
                    sel = np.nonzero(~finite)[0][:nextra]
                    sl = slice(ngoods, ngoods + nextra)
                    live_u[sl] = cur_u[sel]
                    live_v[sl] = cur_v[sel]
                    live_logl[sl] = LOWL_VAL
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
    else:
        live_u, live_v = np.array(live_points[0]), np.array(live_points[1])
        live_logl = np.array(live_points[2], dtype=np.float64)
        loglikelihood.eval_host(live_u[:1])
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
    return (live_u, live_v, live_logl), logvol_init, ncalls


class Sampler:
    """Static nested sampler over fused device dispatches on ``device``."""

    def __init__(self, loglikelihood, ndim, live_points, sampling, bounding,
                 *, device, ncdim=None, rstate=None, queue_size=None,
                 bound_update_interval=None, first_bound_update=None,
                 bound_bootstrap=0, bound_enlarge=1.0, logvol_init=0.0,
                 rounds_per_dispatch=1, proposal_mode="batch",
                 dtype=torch.float64):
        f32_precision()
        self.device = torch.device(device)
        self.dtype = dtype
        self.loglikelihood = loglikelihood
        self.ndim = ndim
        self.ncdim = ncdim or ndim
        self.live_u, self.live_v, self.live_logl = live_points[:3]
        self.nlive = len(self.live_u)
        self.live_bound = np.zeros(self.nlive, dtype=int)
        self.live_it = np.zeros(self.nlive, dtype=int)
        self.live_birth = np.full(self.nlive, -np.inf)

        self.rstate = rstate or get_random_generator()
        self.internal_sampler_next = sampling
        self.internal_sampler = UnitCubeSampler(ndim=ndim)
        if proposal_mode not in ("batch", "queue"):
            raise ValueError(f"Unknown proposal_mode '{proposal_mode}'")
        self.proposal_mode = proposal_mode
        q = max(int(queue_size or 64), 1)
        # batch rounds kill queue_size points at once: cap at nlive/2
        self.queue_size = max(1, min(q, self.nlive // 2)) \
            if proposal_mode == "batch" else q

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
        self._live_dev = None
        self._mirror_stale = False
        self._bound_upload = None
        self._last_delta_logz = None
        self._nc_carry = 0

    # ------------------------------------------------------------------
    # bound management

    def update_bound(self, subset=slice(None)):
        """Refit the bound to the current live points."""
        self.bound.update(self.live_u[subset, :self.ncdim],
                          rstate=self.rstate,
                          bootstrap=self.bound_bootstrap)
        self.bound_version += 1
        if self.bound_enlarge != 1.0:
            self.bound.scale_to_logvol(self.bound.logvol +
                                       np.log(self.bound_enlarge))

    def update_bound_if_needed(self, loglstar, ncall=None, force=False):
        """First update once unit-cube sampling becomes inefficient, then
        every ``bound_update_interval`` calls (checked between
        dispatches)."""
        if ncall is None:
            ncall = self.ncall
        call_check_first = ncall >= self.first_bound_update_ncall
        call_check = ncall >= self.bound_update_interval + \
            self.ncall_at_last_update
        efficiency_check = self.eff < self.first_bound_update_eff
        if ((self.unit_cube_sampling and efficiency_check
             and call_check_first)
                or (not self.unit_cube_sampling and call_check)
                or (self.unit_cube_sampling
                    and self.logl_first_update is not None
                    and loglstar > self.logl_first_update) or force):
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
        update)."""
        if self.unit_cube_sampling:
            return "cube"
        spec = self.bound.device_spec()
        if spec is None:
            raise NotImplementedError("custom bounds are not yet ported")
        return spec[0]

    def device_bound_arrays(self):
        """Device upload of the active bound's arrays, cached per refit."""
        kind = self.device_bound_kind()
        cached = self._bound_upload
        if cached is None or cached[0] != self.bound_version or \
                cached[1] != kind:
            arrays = {} if kind == "cube" else self.bound.device_spec()[1]
            dev = bound_arrays_to_torch(kind, arrays, self.device,
                                        self.dtype)
            self._bound_upload = cached = (self.bound_version, kind, dev)
        return cached[2]

    def _live_packed(self):
        """Host live mirrors packed as u | v | logl | it | bound | birth."""
        return np.concatenate([
            self.live_u, self.live_v, self.live_logl[:, None],
            self.live_it[:, None].astype(np.float64),
            self.live_bound[:, None].astype(np.float64),
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
            self._mirror_stale = False
            self.timings.add("mirror", time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # dispatch planning

    def _estimate_remaining(self, dlogz_eff):
        """Accepts remaining before the dlogz criterion (delta_logz decays
        ~exp(-i/nlive)), or None."""
        last = self._last_delta_logz
        if last is not None and np.isfinite(dlogz_eff) and dlogz_eff > 0 \
                and last > 0:
            return 1.1 * self.nlive * max(np.log(last) - np.log(dlogz_eff),
                                          0.0)
        return None

    def _make_dispatch_spec(self, dlogz_eff, loglstar):
        """Run the refit trigger (the only place host refits fire), size
        the dispatch's active rounds from the remaining-work estimate,
        and draw the dispatch's generator from the host stream."""
        self.update_bound_if_needed(max(loglstar, np.float64(LOWL_VAL)),
                                    ncall=self.ncall)
        est = self._estimate_remaining(dlogz_eff)
        q = self.queue_size
        gated = self.internal_sampler.gate_rounds_on_done and \
            not self.unit_cube_sampling
        if gated or est is None:
            rounds_active = None
        else:
            rounds_active = max(1, int(math.ceil(
                (min(est, 2**30) + q // 2) / q)))
        return {"gen": get_torch_generator(self.rstate, self.device),
                "rounds_active": rounds_active}

    # ------------------------------------------------------------------
    # results

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
               logl_max=np.inf, save_bounds=True, per_dispatch=False):
        """Generator yielding one dead point per iteration, or one
        :class:`IteratorBlock` per dispatch with ``per_dispatch=True``.

        Synchronous: launch a dispatch, wait for its flat result, append
        its records, then run the refit trigger before the next one."""
        if maxcall is None:
            maxcall = sys.maxsize
        if maxiter is None:
            maxiter = sys.maxsize
        self.save_bounds = save_bounds
        ncall = 0
        if self.it == 1 or len(self.saved_run["logl"]) == 0:
            h, logz, logzvar = 0.0, LOWL_VAL, 0.0
            logvol, loglstar = self.logvol_init, LOWL_VAL
        else:
            if self.added_live:
                self._remove_live_points()
            h, logz, logzvar, logvol, loglstar = [
                self.saved_run[k][-1]
                for k in ("h", "logz", "logzvar", "logvol", "logl")]
        ndim, npdim = self.ndim, self.loglikelihood.npdim
        rec_off = 1 + ndim + npdim
        dlogz_eff = -np.inf if dlogz is None else dlogz
        accepted = 0
        terminal = False
        pending, pending_block = [], None

        while True:
            while pending:
                row = pending.pop(0)
                accepted += 1
                ncall += row["nc"]
                yield IteratorResult(**row)
            if pending_block is not None:
                accepted += pending_block.n
                ncall += pending_block.nc
                yield pending_block
                pending_block = None
            if terminal:
                break
            if accepted >= maxiter or ncall >= maxcall:
                warnings.warn(
                    "Sampling stopped short by maxiter/maxcall before "
                    "reaching the dlogz criterion; posterior may be "
                    "poorly sampled.")
                break

            spec = self._make_dispatch_spec(dlogz_eff, loglstar)
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
            axes_args = self.device_bound_arrays()
            if self._live_dev is None:
                self._live_dev = live_to_torch(
                    self._live_packed(), self.device, self.dtype,
                    ndim=ndim, npdim=npdim)
            t0 = time.perf_counter()
            handle = self.internal_sampler.launch_fused(
                self, spec["gen"], self._live_dev, axes_args, integ, limits,
                rounds_active=spec["rounds_active"])
            out, live_out = self.internal_sampler.finish_fused(handle)
            self.timings.add("dispatch", time.perf_counter() - t0)
            self.timings.count("n_dispatch")
            self.timings.count("sync_flat")
            t_cons0 = time.perf_counter()
            self.timings.count("nc_launched", out["nc_launched"])

            self._live_dev = live_out
            self._mirror_stale = True
            self._mirror_bounditer = bounditer
            n_real = min(len(out["accepts"]),
                         handle["rounds_active"] * self.queue_size)
            if out["done_reason"] & 32 and not out["done_reason"] & 31:
                n_real = out["n_consumed"]  # chain-stop gate fired
            if out["n_consumed"] > 0:
                last_i = min(out["n_consumed"], n_real) - 1
                self._last_delta_logz = float(out["delta_logz"][last_i])
            ig = out["integ"]
            logz, logzvar = float(ig["logz"]), float(ig["logzvar"])
            h, logvol = float(ig["h"]), float(ig["logvol"])
            loglstar = float(ig["loglstar"])
            self.plateau_mode = ig["plateau_mode"]
            self.plateau_counter = ig["plateau_counter"]
            self.plateau_logdvol = float(ig["plateau_logdvol"])
            self.it = ig["it"]
            nc_round = out["nc_used"]
            # evaluations launched but not consumed are billed now (no
            # leftover replay in this port yet)
            extra_nc = max(out["nc_launched"] - nc_round, 0)
            self.ncall += nc_round + extra_nc
            if per_dispatch:
                pending_block = IteratorBlock(n=0, nc=nc_round + extra_nc)
            else:
                staged_nc = int(np.sum(
                    out["records"][out["accepts"], rec_off + 6]))
                ncall += nc_round - staged_nc
            self.eff = 100.0 * (self.it - 1) / max(self.ncall, 1)
            if not self.unit_cube_sampling:
                self.internal_sampler.apply_fused_tuning(out)

            # terminal causes: 1=dlogz, 2=logl_max, 4=live plateau
            if out["done_reason"] & 0b111:
                if out["done_reason"] & 0b100:
                    warnings.warn("A likelihood plateau was reached; "
                                  "stopping the run.")
                terminal = True

            pend, n_new = self._append_records(out, bounditer, extra_nc,
                                               per_dispatch)
            pending.extend(pend)
            if per_dispatch:
                pending_block = IteratorBlock(n=n_new, nc=pending_block.nc)
            self.timings.add("consume", time.perf_counter() - t_cons0)
        self._ensure_live_mirror()

    def _append_records(self, out, bounditer, extra_nc, per_dispatch):
        """Append one dispatch's accepted records to ``saved_run``;
        returns (per-record yield rows, number of records)."""
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
            return [], 0
        tail = recs[acc_idx, rec_off:rec_off + 11]
        tail[-1, 6] += extra_nc
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
        D["blob"].extend([None] * n_new)
        D["proposal_stats"].extend(row_stats)
        if per_dispatch:
            return [], n_new
        dlz = out["delta_logz"]
        rows = [dict(worst=int(worsts[j]), ustar=recs[i, 1:1 + ndim],
                     vstar=recs[i, 1 + ndim:rec_off], loglstar=tail[j, 0],
                     logvol=tail[j, 1], logwt=tail[j, 2], logz=tail[j, 3],
                     logzvar=tail[j, 4], h=tail[j, 5], nc=int(tail[j, 6]),
                     n=int(tail[j, 9]), birth=tail[j, 10], blob=None,
                     worst_it=int(tail[j, 7]), boundidx=int(bidx[j]),
                     bounditer=bounditer, eff=self.eff,
                     delta_logz=float(dlz[i]),
                     proposal_stats=row_stats[j])
                for j, i in enumerate(acc_idx)]
        return rows, n_new

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
            loglstar_new = self.live_logl[idx]
            n = int(ramp_n[i]) if not self.plateau_mode else self.nlive - i
            logwt, logz, logzvar, h = progress_integration(
                loglstar, loglstar_new, logz, logzvar, logvol, dlv, h)
            loglstar = loglstar_new
            delta_logz = np.logaddexp(0, loglmax + logvol - logz)
            row = dict(worst=idx, ustar=ustar, vstar=vstar,
                       loglstar=loglstar, logvol=logvol, logwt=logwt,
                       logz=logz, logzvar=logzvar, h=h, nc=1, n=n,
                       birth=births[idx], blob=None,
                       worst_it=self.live_it[idx],
                       boundidx=self.live_bound[idx], bounditer=bounditer)
            self.saved_run.append(dict(
                id=idx, u=ustar, v=vstar, logl=loglstar, logvol=logvol,
                logwt=logwt, logz=logz, logzvar=logzvar, h=h, nc=1, n=n,
                birth=births[idx], boundidx=row["boundidx"],
                it=row["worst_it"], bounditer=bounditer,
                scale=self.internal_sampler.scale, blob=None,
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
                   print_func=None, save_bounds=True):
        """Run the full static fit (driver around :meth:`sample`)."""
        if dlogz is None:
            dlogz = 1e-3 * (self.nlive - 1.0) + 0.01 if add_live else 0.01
        print_func = get_print_func(print_func, print_progress)
        t_run0 = time.perf_counter()
        try:
            ncall = self.ncall
            for results in self.sample(maxiter=maxiter, maxcall=maxcall,
                                       dlogz=dlogz, logl_max=logl_max,
                                       save_bounds=save_bounds,
                                       per_dispatch=not print_progress):
                ncall += results.nc
                if print_progress:
                    print_func(results, self.it - 1, ncall, dlogz=dlogz)
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
        finally:
            self.timings.add("total", time.perf_counter() - t_run0)
            if print_progress:
                sys.stderr.write("\n")
