"""Run algebra and error analysis: volume-jitter realizations, strand
bootstraps, run merging/unraveling, reweighting, and KL-divergence errors.

Host-side float64 numpy throughout.  Semantics mirror the reference
(``utils.py:1317-2239``): ``jitter_run`` simulates the stochastic prior
volume shrinkage (Beta compressions, uniform order statistics on
decreasing-nlive segments), ``resample_run`` bootstraps single-live-point
"strands", ``merge_runs`` merges runs by walking their sorted
log-likelihood sequences with plateau-aware volume assignment.  The merge
walk here is vectorized (stable argsort replaces the two-pointer loop) and
plateau handling uses run-length encoding of the sorted logl sequence.
"""

import math
import warnings

import numpy as np

from ..ops.integrals import compute_integrals
from .misc import get_random_generator
from .results import Results, results_substitute

__all__ = [
    "jitter_run", "resample_run", "reweight_run", "unravel_run",
    "merge_runs", "kld_error", "check_result_static",
]


def _get_nsamps_samples_n(res):
    """Total sample count and per-iteration live point counts of a run.

    Static runs from the batch (death/refill) sampler record their exact
    sawtooth profile in ``samples_n``; it takes precedence over the
    constant-``nlive`` reconstruction whenever present."""
    if res.isdynamic() or "samples_n" in res.keys():
        samples_n = np.asarray(res["samples_n"])
        return len(samples_n), samples_n
    niter, nlive = res["niter"], res["nlive"]
    nsamps = len(res["logvol"])
    if nsamps == niter:
        samples_n = np.full(niter, nlive, dtype=int)
    elif nsamps == niter + nlive:
        # final live points recycled one by one: nlive decreases at the end
        samples_n = np.minimum(np.arange(nsamps, 0, -1), nlive)
    else:
        raise ValueError("Number of samples disagrees with niter/nlive.")
    return nsamps, samples_n


def _find_decrease(samples_n):
    """Mask of constant-or-increasing iterations plus, for each maximal
    strictly-decreasing segment, the starting nlive and its index range.

    Vectorized run detection: the 0->1 / 1->0 flanks of the decreasing
    indicator delimit each maximal run; a segment includes the element
    just before its first drop."""
    nsamps = len(samples_n)
    decreasing = np.zeros(nsamps, dtype=bool)
    decreasing[1:] = np.diff(samples_n) < 0
    d = decreasing.astype(np.int8)
    first = np.nonzero(np.diff(np.concatenate(([0], d))) == 1)[0]
    last = np.nonzero(np.diff(np.concatenate((d, [0]))) == -1)[0]
    bounds = [(f - 1, l + 1) for f, l in zip(first, last)]
    nlive_start = samples_n[first - 1] if len(first) else []
    return ~decreasing, nlive_start, bounds


def jitter_run(res, rstate=None, approx=False):
    """Realize the stochastic prior-volume shrinkage of a run.

    Constant/increasing-nlive iterations compress by Beta(K, 1) draws; for
    strictly decreasing segments the joint uniform order statistics are
    simulated via exponential spacings.  Returns a new Results with
    re-derived logvol/logwt/logz/logzerr/h.
    """
    if rstate is None:
        rstate = get_random_generator()
    nsamps, samples_n = _get_nsamps_samples_n(res)
    logl = res["logl"]

    if approx:
        beta_mask = np.ones(nsamps, dtype=bool)
        nlive_start, bounds = [], []
    else:
        beta_mask, nlive_start, bounds = _find_decrease(samples_n)

    t_arr = np.zeros(nsamps)
    t_arr[beta_mask] = rstate.beta(a=samples_n[beta_mask], b=1)

    # Decreasing segments: the j-th largest of K uniforms, jointly, via
    # normalized cumulative exponentials.
    for nstart, bound in zip(nlive_start, bounds):
        seg_n = samples_n[bound[0]:bound[1]]
        y = rstate.exponential(scale=1.0, size=nstart + 1)
        ycum = y.cumsum()
        ycum /= ycum[-1]
        uorder = ycum[np.append(nstart, seg_n - 1)]
        t_arr[bound[0]:bound[1]] = uorder[1:] / uorder[:-1]

    logvol = np.log(t_arr).cumsum()
    logwt, logz, logzvar, h = compute_integrals(logl=logl, logvol=logvol)
    return results_substitute(
        res, {
            "logvol": logvol,
            "logwt": logwt,
            "logz": logz,
            "logzerr": np.sqrt(np.maximum(logzvar, 0)),
            "information": h,
        })


def _thread_counts(logl, birth):
    """Per-sample live-thread counts of a (sorted-by-logl) run whose
    samples carry birth thresholds: ``n_j = #{k : birth_k < logl_j <=
    logl_k}``.  Each sample is one thread, active on ``(birth, death]``;
    this reproduces the recorded sawtooth ``samples_n`` exactly for an
    unresampled batch-mode run (identity verified in
    ``tests/test_runs.py``)."""
    n = len(logl)
    starts = np.searchsorted(logl, birth, side="right")
    starts = np.minimum(starts, np.arange(n))
    ev = np.zeros(n + 1, dtype=int)
    np.add.at(ev, starts, 1)
    ev[1:] -= 1
    return np.cumsum(ev[:-1])


def _resample_run_threads(res, rstate, return_idx):
    """Thread bootstrap for runs with per-sample birth thresholds.

    Under batched death/refill a live slot is NOT one continuous
    single-live-point strand (its refill is drawn above the round
    threshold, not above the slot's own death), so the resampling unit
    is the individual thread: one (birth, death) pair per sample.
    Threads born from the prior (birth = -inf) form the baseline group;
    the rest are add-ons (reference ``utils.py:1560-1585`` groups its
    strands the same way by batch lower bound)."""
    logl_all = np.asarray(res["logl"])
    birth_all = np.asarray(res["samples_birth"])
    base_idx = np.nonzero(np.isneginf(birth_all))[0]
    addon_idx = np.nonzero(~np.isneginf(birth_all))[0]
    nbase, nadd = len(base_idx), len(addon_idx)
    if nbase == 0:
        raise ValueError("Run contains no threads sampled from the "
                         "prior!")
    sel = base_idx[rstate.integers(0, nbase, size=nbase)]
    if nadd > 0:
        sel = np.append(sel,
                        addon_idx[rstate.integers(0, nadd, size=nadd)])
    order = np.argsort(logl_all[sel], kind="stable")
    samp_idx = sel[order]
    logl = logl_all[samp_idx]
    birth = birth_all[samp_idx]
    n_new = len(samp_idx)
    samp_n = _thread_counts(logl, birth)
    logvol = np.cumsum(np.log(samp_n / (samp_n + 1.0)))
    logwt, logz, logzvar, h = compute_integrals(logl=logl, logvol=logvol)
    ncall = np.asarray(res["ncall"])[samp_idx]
    blob = np.asarray(res["blob"]) if res["blob"] is not None else None
    new_res = Results(
        dict(niter=n_new,
             ncall=ncall,
             eff=100.0 * n_new / ncall.sum(),
             blob=blob[samp_idx] if blob is not None else None,
             samples=np.asarray(res["samples"])[samp_idx],
             samples_id=np.asarray(res["samples_id"])[samp_idx],
             samples_it=np.asarray(res["samples_it"])[samp_idx],
             samples_u=np.asarray(res["samples_u"])[samp_idx],
             samples_n=samp_n,
             samples_birth=birth,
             logwt=logwt,
             logl=logl,
             logvol=logvol,
             logz=logz,
             logzerr=np.sqrt(np.maximum(logzvar, 0)),
             information=h))
    if return_idx:
        return new_res, samp_idx
    return new_res


def resample_run(res, rstate=None, return_idx=False):
    """Bootstrap the run's single-live-point strands into a new realization
    (sampling uncertainties).  Strands whose batch lower bound is -inf form
    the "baseline" group; others are "add-ons" resampled separately."""
    if rstate is None:
        rstate = get_random_generator()
    if "samples_birth" in res.keys():
        return _resample_run_threads(res, rstate, return_idx)

    nsamps = len(res["ncall"])
    if res.isdynamic():
        samples_n = np.asarray(res["samples_n"])
        samples_batch = np.asarray(res["samples_batch"])
        batch_logl_bounds = np.asarray(res["batch_logl_bounds"])
        added_final_live = True
    else:
        nlive, niter = res["nlive"], res["niter"]
        if nsamps == niter:
            added_final_live = False
        elif nsamps == niter + nlive:
            added_final_live = True
        else:
            raise ValueError("Number of samples disagrees with niter/nlive.")
        if "samples_n" in res.keys():
            samples_n = np.asarray(res["samples_n"])
        elif added_final_live:
            samples_n = np.minimum(np.arange(nsamps, 0, -1), nlive)
        else:
            samples_n = np.full(niter, nlive, dtype=int)
        samples_batch = np.zeros(nsamps, dtype=int)
        batch_logl_bounds = np.array([(-np.inf, np.inf)])
    batch_llmin = batch_logl_bounds[:, 0]

    samples_id = np.asarray(res["samples_id"])
    ids = np.unique(samples_id)
    base_ids, addon_ids = [], []
    for i in ids:
        sbatch = samples_batch[samples_id == i]
        if np.any(batch_llmin[sbatch] == -np.inf):
            base_ids.append(i)
        else:
            addon_ids.append(i)
    nbase, nadd = len(base_ids), len(addon_ids)
    base_ids, addon_ids = np.array(base_ids), np.array(addon_ids)

    if nbase > 0 and nadd > 0:
        live_idx = np.append(base_ids[rstate.integers(0, nbase, size=nbase)],
                             addon_ids[rstate.integers(0, nadd, size=nadd)])
    elif nbase > 0:
        live_idx = base_ids[rstate.integers(0, nbase, size=nbase)]
    elif nadd > 0:
        raise ValueError("Run contains no strands sampled from the prior!")
    else:
        raise ValueError("Run contains no particles!")

    all_idx = np.arange(nsamps)
    samp_idx = np.concatenate(
        [all_idx[samples_id == idx] for idx in live_idx])
    logls = np.asarray(res["logl"])[samp_idx]
    order = np.argsort(logls)
    samp_idx = samp_idx[order]
    logl = np.asarray(res["logl"])[samp_idx]
    n_new = len(samp_idx)

    if added_final_live:
        # Per-sample live point count: each strand contributes its
        # multiplicity between its batch lower bound and its top logl,
        # decreasing across its final (tied-top) points.
        samp_n = np.zeros(n_new, dtype=int)
        uidxs, counts = np.unique(live_idx, return_counts=True)
        for uidx, mult in zip(uidxs, counts):
            sel = samples_id == uidx
            lower = batch_llmin[samples_batch[sel][0]]
            upper = np.asarray(res["logl"])[sel].max()
            samp_n[(logl > lower) & (logl < upper)] += mult
            endsel = logl == upper
            n_end = np.count_nonzero(endsel)
            chunk = n_end / mult
            counters = (np.arange(n_end) / chunk).astype(int)
            samp_n[endsel] += counters[::-1] + 1
    else:
        samp_n = samples_n[samp_idx]

    logvol = np.cumsum(np.log(samp_n / (samp_n + 1.0)))
    logwt, logz, logzvar, h = compute_integrals(logl=logl, logvol=logvol)

    ncall = np.asarray(res["ncall"])[samp_idx]
    eff = 100.0 * n_new / ncall.sum()
    blob = np.asarray(res["blob"]) if res["blob"] is not None else None
    new_res = Results(
        dict(niter=n_new,
             ncall=ncall,
             eff=eff,
             blob=blob[samp_idx] if blob is not None else None,
             samples=np.asarray(res["samples"])[samp_idx],
             samples_id=samples_id[samp_idx],
             samples_it=np.asarray(res["samples_it"])[samp_idx],
             samples_u=np.asarray(res["samples_u"])[samp_idx],
             samples_n=samp_n,
             logwt=logwt,
             logl=logl,
             logvol=logvol,
             logz=logz,
             logzerr=np.sqrt(np.maximum(logzvar, 0)),
             information=h))
    if return_idx:
        return new_res, samp_idx
    return new_res


def reweight_run(res, logp_new, logp_old=None):
    """Reweight a run to a new target density evaluated at its samples."""
    if logp_old is None:
        logp_old = res["logl"]
    logwt, logz, logzvar, h = compute_integrals(
        logl=res["logl"], logvol=res["logvol"],
        reweight=np.asarray(logp_new) - np.asarray(logp_old))
    return results_substitute(
        res, {
            "logvol": res["logvol"],
            "logwt": logwt,
            "logz": logz,
            "logzerr": np.sqrt(np.maximum(logzvar, 0)),
            "information": h,
        })


def _unravel_run_threads(res):
    """Decompose a birth-carrying (batch-mode) run into birth cohorts.

    Slot ids are NOT valid strands under batched death/refill (a refill
    is born at the round threshold, not at the slot's own death), so the
    independent units are threads grouped by common birth threshold: the
    prior-born cohort (birth = -inf) is a complete little run, and each
    round's refill cohort is a lower-bounded batch run.  ``merge_runs``
    over the returned list reconstructs the original run's profile."""
    logl_all = np.asarray(res["logl"])
    birth_all = np.asarray(res["samples_birth"])
    out = []
    for bi, b in enumerate(np.unique(birth_all)):
        sel = np.nonzero(birth_all == b)[0]
        order = sel[np.argsort(logl_all[sel], kind="stable")]
        m = len(order)
        logl = logl_all[order]
        # m single-live threads with a common birth: at any level the
        # active count is the number not yet dead — a pure m..1 ramp
        samples_n = np.arange(m, 0, -1)
        logvol = np.cumsum(np.log(samples_n / (samples_n + 1.0)))
        logwt, logz, logzvar, h = compute_integrals(logl=logl,
                                                    logvol=logvol)
        ncall = np.asarray(res["ncall"])[order]
        blob = np.asarray(res["blob"])[order] \
            if res["blob"] is not None else None
        is_base = np.isneginf(b)
        out.append(Results(
            dict(niter=m,
                 ncall=ncall,
                 eff=100.0 * m / ncall.sum(),
                 samples=np.asarray(res["samples"])[order],
                 samples_id=np.asarray(res["samples_id"])[order],
                 samples_it=np.asarray(res["samples_it"])[order],
                 samples_u=np.asarray(res["samples_u"])[order],
                 samples_n=samples_n,
                 samples_birth=birth_all[order],
                 samples_batch=np.zeros(m, dtype=int) if is_base
                 else np.ones(m, dtype=int),
                 batch_logl_bounds=(np.array([(-np.inf, np.inf)])
                                    if is_base
                                    else np.array([(-np.inf, np.inf),
                                                   (b, np.inf)])),
                 blob=blob,
                 logwt=logwt,
                 logl=logl,
                 logvol=logvol,
                 logz=logz,
                 logzerr=np.sqrt(np.maximum(logzvar, 0)),
                 information=h)))
    return out


def unravel_run(res, print_progress=False):
    """Split a K-live-point run into K single-live-point strand runs
    (or, for batch-mode runs carrying per-sample birth thresholds, into
    birth cohorts — see :func:`_unravel_run_threads`).

    Ancillary quantities of a strand are only valid if that point was
    initialized from the prior.
    """
    if "samples_birth" in res.keys():
        return _unravel_run_threads(res)
    idxs = np.asarray(res["samples_id"])
    added_live = True
    try:
        if len(idxs) != (res["niter"] + res["nlive"]):
            added_live = False
    except KeyError:
        pass

    if (np.diff(res["logl"]) == 0).sum() > 0:
        warnings.warn("The likelihood seems to have plateaus; unraveling "
                      "may be inaccurate.")

    new_res = []
    unique_ids = np.unique(idxs)
    for counter, idx in enumerate(unique_ids):
        strand = idxs == idx
        nsamps = int(strand.sum())
        logl = np.asarray(res["logl"])[strand]

        # With one live point the volume halves per iteration; a final
        # live point sits at half the last dead volume.
        if added_live:
            niter = nsamps - 1
            logvol_dead = -math.log(2) * (1.0 + np.arange(niter))
            if niter > 0:
                logvol = np.append(logvol_dead,
                                   logvol_dead[-1] + math.log(0.5))
            else:
                logvol = np.array([math.log(0.5)])
        else:
            niter = nsamps
            logvol = -math.log(2) * (1.0 + np.arange(niter))

        logwt, logz, logzvar, h = compute_integrals(logl=logl, logvol=logvol)
        ncall = np.asarray(res["ncall"])[strand]
        blob = np.asarray(res["blob"])[strand] \
            if res["blob"] is not None else None
        rdict = dict(nlive=1,
                     niter=niter,
                     ncall=ncall,
                     eff=100.0 * nsamps / ncall.sum(),
                     samples=np.asarray(res["samples"])[strand],
                     samples_id=idxs[strand],
                     samples_it=np.asarray(res["samples_it"])[strand],
                     samples_u=np.asarray(res["samples_u"])[strand],
                     blob=blob,
                     logwt=logwt,
                     logl=logl,
                     logvol=logvol,
                     logz=logz,
                     logzerr=np.sqrt(np.maximum(logzvar, 0)),
                     information=h)
        if "samples_batch" in res.keys():
            rdict["samples_batch"] = np.asarray(res["samples_batch"])[strand]
        if "batch_logl_bounds" in res.keys():
            rdict["batch_logl_bounds"] = res["batch_logl_bounds"]
        new_res.append(Results(rdict))
        if print_progress:
            import sys
            sys.stderr.write(f"\rStrand: {counter + 1}/{len(unique_ids)}  ")
    return new_res


def _prepare_for_merge(res):
    """Extract per-sample arrays and the nlive profile of a run."""
    info = dict(id=np.asarray(res["samples_id"]),
                u=np.asarray(res["samples_u"]),
                v=np.asarray(res["samples"]),
                logl=np.asarray(res["logl"]),
                nc=np.asarray(res["ncall"]),
                it=np.asarray(res["samples_it"]),
                birth=(np.asarray(res["samples_birth"])
                       if "samples_birth" in res.keys() else None),
                blob=(np.asarray(res["blob"])
                      if res["blob"] is not None else None))
    nrun = len(info["id"])
    if res.isdynamic() or "samples_n" in res.keys():
        run_nlive = np.asarray(res["samples_n"])
    else:
        niter, nlive = res["niter"], res["nlive"]
        if nrun == niter:
            run_nlive = np.full(niter, nlive, dtype=int)
        elif nrun == niter + nlive:
            run_nlive = np.minimum(np.arange(nrun, 0, -1), nlive)
        else:
            raise ValueError("Number of samples disagrees with niter/nlive.")
    if res.isdynamic() or "batch_logl_bounds" in res.keys():
        info["batch"] = np.asarray(res["samples_batch"])
        info["batch_logl_bounds"] = np.asarray(res["batch_logl_bounds"])
    else:
        info["batch"] = np.zeros(nrun, dtype=int)
        info["batch_logl_bounds"] = np.array([(-np.inf, np.inf)])
    return run_nlive, info


def _assign_logvol_with_plateaus(logl_sorted, nlive):
    """Sequential plateau-aware log-volume assignment over a merged run.

    ``logl_sorted`` must be non-decreasing, so ties are contiguous: each
    maximal equal-logl run of length m > 1 is treated as a plateau whose
    total volume is m/(nlive+1) of the current volume, consumed linearly
    (reference ``utils.py:2159-2187``).
    """
    n = len(logl_sorted)
    logvol_out = np.empty(n)
    logvol = 0.0
    # run-length encoding of equal-logl runs
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(logl_sorted[1:], logl_sorted[:-1], out=change[1:])
    run_starts = np.nonzero(change)[0]
    run_ends = np.append(run_starts[1:], n)
    pos = 0
    for start, end in zip(run_starts, run_ends):
        m = end - start
        if m == 1:
            k = nlive[pos]
            logvol -= math.log((k + 1.0) / k)
            logvol_out[pos] = logvol
            pos += 1
        else:
            # plateau: delta-vol fixed at entry, applied m times
            k = nlive[pos]
            plateau_logdvol = logvol + math.log(1.0 / (k + 1.0))
            for _ in range(m):
                logvol = logvol + np.log1p(-np.exp(plateau_logdvol - logvol))
                logvol_out[pos] = logvol
                pos += 1
    return logvol_out


def _merge_two(res1, res2, compute_aux=False):
    """Merge two runs by interleaving their (sorted) dead points.

    The interleave is a stable argsort over the concatenated logl arrays
    (base first, matching the reference's tie-breaking); per-sample nlive
    sums the runs' profiles wherever both runs are "active" (above each
    other's lower logl bound).
    """
    base_nlive, base = _prepare_for_merge(res1)
    new_nlive, new = _prepare_for_merge(res2)
    nb, nn = len(base["id"]), len(new["id"])
    ntot = nb + nn

    # Merged batch-bound bookkeeping.
    combined_bounds = np.unique(np.concatenate(
        (base["batch_logl_bounds"], new["batch_logl_bounds"])), axis=0)

    def _bound_map(bounds):
        return np.array([
            np.where(np.all(b == combined_bounds, axis=1))[0][0]
            for b in bounds
        ])

    base_map = _bound_map(base["batch_logl_bounds"])
    new_map = _bound_map(new["batch_logl_bounds"])
    base_lowedge = base["batch_logl_bounds"][base["batch"], 0].min()
    new_lowedge = new["batch_logl_bounds"][new["batch"], 0].min()

    # Stable sort of [base; new] by logl == the two-pointer walk with
    # base winning ties.
    all_logl = np.concatenate([base["logl"], new["logl"]])
    src_is_new = np.concatenate(
        [np.zeros(nb, dtype=bool), np.ones(nn, dtype=bool)])
    order = np.argsort(all_logl, kind="stable")
    merged_logl = all_logl[order]
    merged_is_new = src_is_new[order]

    # Next-to-consume ("current") index within each source run at step i:
    # the number of that run's samples consumed in steps 0..i-1.
    new_pos = np.cumsum(merged_is_new) - merged_is_new
    base_pos = np.arange(ntot) - new_pos

    base_cur_logl = np.where(base_pos < nb,
                             base["logl"][np.minimum(base_pos, nb - 1)],
                             np.inf)
    base_cur_n = np.where(base_pos < nb,
                          base_nlive[np.minimum(base_pos, nb - 1)], 0)
    new_cur_logl = np.where(new_pos < nn,
                            new["logl"][np.minimum(new_pos, nn - 1)], np.inf)
    new_cur_n = np.where(new_pos < nn,
                         new_nlive[np.minimum(new_pos, nn - 1)], 0)

    both_active = (base_cur_logl > new_lowedge) & \
                  (new_cur_logl > base_lowedge)
    only_base = base_cur_logl <= new_lowedge
    merged_n = np.where(both_active, base_cur_n + new_cur_n,
                        np.where(only_base, base_cur_n, new_cur_n))

    src_idx = order - np.where(src_is_new[order], nb, 0)

    def _gather(key):
        a, b = base[key], new[key]
        if a is None or b is None:
            return None
        cat = np.concatenate([np.asarray(a), np.asarray(b)])
        return cat[order]

    merged_batch = np.where(
        merged_is_new, new_map[new["batch"][np.minimum(src_idx, nn - 1)]],
        base_map[base["batch"][np.minimum(src_idx, nb - 1)]])

    logvol = _assign_logvol_with_plateaus(merged_logl, merged_n)

    ncall = _gather("nc")
    r = dict(niter=ntot,
             ncall=ncall,
             eff=100.0 * ntot / ncall.sum(),
             samples=_gather("v"),
             logl=merged_logl,
             logvol=logvol,
             batch_logl_bounds=combined_bounds,
             blob=_gather("blob"),
             samples_id=_gather("id"),
             samples_it=_gather("it"),
             samples_n=merged_n,
             samples_u=_gather("u"),
             samples_batch=merged_batch)
    merged_birth = _gather("birth")
    if merged_birth is not None:
        r["samples_birth"] = merged_birth

    if compute_aux:
        logwt, logz, logzvar, h = compute_integrals(logl=r["logl"],
                                                    logvol=r["logvol"])
        r["logwt"], r["logz"], r["information"] = logwt, logz, h
        r["logzerr"] = np.sqrt(np.maximum(logzvar, 0))
        ids = r["samples_id"]
        r["batch_nlive"] = np.array([
            len(np.unique(ids[merged_batch == i]))
            for i in np.unique(merged_batch)
        ], dtype=int)

    return Results(r)


def merge_runs(res_list, print_progress=False):
    """Merge a list of runs (tree-merging baseline runs, then folding in
    add-on batches)."""
    rlist_base, rlist_add = [], []
    for r in res_list:
        try:
            if np.any(np.asarray(r["samples_batch"]) == 0):
                rlist_base.append(r)
            else:
                rlist_add.append(r)
        except KeyError:
            rlist_base.append(r)
    if len(rlist_base) == 1 and len(rlist_add) == 1:
        rlist_base, rlist_add = list(res_list), []

    if len(rlist_base) > 1:
        while len(rlist_base) > 2:
            nxt = []
            for i in range(0, len(rlist_base), 2):
                if i + 1 < len(rlist_base):
                    nxt.append(_merge_two(rlist_base[i], rlist_base[i + 1],
                                          compute_aux=False))
                else:
                    nxt.append(rlist_base[i])
            rlist_base = nxt
        res = _merge_two(rlist_base[0], rlist_base[1], compute_aux=True)
    else:
        res = rlist_base[0]

    for i, r in enumerate(rlist_add):
        res = _merge_two(res, r, compute_aux=(i == len(rlist_add) - 1))

    return check_result_static(res)


def check_result_static(res):
    """If a dynamic-format run has a constant live point profile, convert
    it to static format (with ``nlive``/``niter``)."""
    samples_n = _get_nsamps_samples_n(res)[1]
    nlive = int(max(samples_n))
    niter = res["niter"]
    standard = False
    if samples_n.size == niter and np.all(samples_n == nlive):
        standard = True
    nlive_test = np.minimum(np.arange(niter, 0, -1), nlive)
    if samples_n.size == niter and np.all(samples_n == nlive_test):
        standard = True
    # batch-mode baseline: a single prior-sampled batch with a sawtooth
    # live-count profile IS a static-format run (the same shape our
    # static sampler emits: scalar ``nlive`` plus the exact per-death
    # ``samples_n`` column, which survives the conversion)
    if not standard and "batch_logl_bounds" in res.keys():
        bounds = np.asarray(res["batch_logl_bounds"])
        if bounds.shape[0] == 1 and bounds[0, 0] == -np.inf:
            standard = True
    if standard:
        rd = res.asdict()
        rd["nlive"] = nlive
        rd["niter"] = niter - nlive
        res = Results(rd)
    return res


def kld_error(res, error="jitter", rstate=None, return_new=False,
              approx=False):
    """Cumulative KL divergence from ``res`` to a random realization of
    itself (jitter or strand-resample)."""
    logp2 = res["logwt"] - res["logz"][-1]
    if error == "jitter":
        new_res = jitter_run(res, rstate=rstate, approx=approx)
    elif error == "resample":
        new_res, samp_idx = resample_run(res, rstate=rstate, return_idx=True)
        logp2 = logp2[samp_idx]
    else:
        raise ValueError(f"Invalid error option '{error}'.")
    logp1 = new_res["logwt"] - new_res["logz"][-1]
    kld = np.cumsum(np.exp(logp1) * (logp1 - logp2))
    if return_new:
        return kld, new_res
    return kld


def _kld_error(args):
    """map-friendly wrapper used by the dynamic stopping function."""
    results, error, approx, rseed = args
    rstate = get_random_generator(rseed)
    return kld_error(results, error, rstate=rstate, return_new=True,
                     approx=approx)
