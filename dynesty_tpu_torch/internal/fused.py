"""Fused proposal+consume rounds: the nested-sampling inner loop of one
queue refill, on the sampler's device (counterpart of
``dynesty_tpu.internal.fused``).

A round proposes ``q`` points at the round's threshold, then consumes
them in order: worst-point selection, plateau handling, the streaming
trapezoid evidence update, live-point replacement and the stopping
checks.  ``fused`` chains ``rounds`` such rounds and packs everything into
one flat float vector with the JAX package's layout (:func:`unpack_flat`).

JAX's ``lax.scan`` consume is ``ops.consume.consume_round``: on
the card one launch of the hand-written ``consume_scan`` kernel a round,
which also chooses the thin or the general scan (JAX's ``lax.cond``) on
the device; on the CPU the plain loop over 0-d tensors, which reads that
choice from the device once a round.  The per-round skip gates read one
flag a round (``Timings['sync_round']``, which also counts the CPU's
choice); ``Timings['n_round']`` counts the rounds consumed.  The packed
stop bitmask is read once per dispatch.

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

import numpy as np
import torch

from ..ops.consume import consume_round
from ..utils.convert import integ_from_vector
from ..utils.misc import blob_where, torch_generator, tree_map

__all__ = ["make_fused_round", "unpack_flat", "record_columns",
           "select_starts", "round_seed"]

# Test knob: fused rounds without the thin scalar consume path (batch
# mode then always runs the general scan; the kernel is told so).  Read
# per round.
_FORCE_GENERAL_CONSUME = False

_NEG_INF = -math.inf


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


def make_fused_round(propose_fn, *, nlive, ndim, npdim, q, dtype, device,
                     kind="?", rounds=1, tune_fn=None, mode="batch",
                     chain_stop_fn=None, timings=None):
    """Wrap a proposal round into a chained propose+consume call.

    ``propose_fn(gen, live, live_blob, axes_args, scale, loglstar) -> (qu,
    qv, qlogl, qblob, qnc, stats, lane_stats)``.  ``mode='batch'`` kills
    the ``q`` worst live points per round and refills them at the shared
    threshold (needs ``q < nlive``); ``mode='queue'`` consumes the
    proposals against the rising threshold at constant live count.
    ``tune_fn(scale, stats)`` updates the proposal scale between rounds;
    ``chain_stop_fn(integ, counters, ctrl)`` skips the round it fires at
    and all later ones (bit 32 of the reported reason).  Every round past
    an in-flight stop is skipped too, whatever the kernel: the round loop
    runs on the host, so the gate costs one flag read per round, and a
    dispatch stopped by maxiter/maxcall then strands no round (an
    interrupted and resumed run bills exactly the evaluations of the
    uninterrupted one).

    ``kind='replay'`` marks a consume-only round whose proposals are given
    (the leftover tail of an interrupted round): its refills are born at
    ``birth0`` (ctrl[16], the interrupted round's threshold), its kill
    count starts at ``kills0`` (ctrl[14]), and it never takes the thin
    path.

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
    il = ndim + npdim  # logl column
    ii, ib, ibirth = il + 1, il + 2, il + 3
    width = 1 + ndim + npdim + 11
    i64 = torch.int64
    lanes = torch.arange(q, dtype=i64, device=device)
    # queue mode's shrinkage, computed on the host as the JAX package does
    dlv_default = float(np.log1p(1.0 / nlive))

    def one_round(gen, live, live_blob, integ, counters, limits, scale,
                  axes_args, kills0, birth0):
        """One propose+consume round; integrator state and counters flow
        in and out."""
        live_logl0 = live[:, il].contiguous()
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
        else:
            loglstar0 = live_logl0.min()
        # replayed entries were proposed at the interrupted round's
        # threshold; the live set here is already partly refilled, so its
        # own threshold would overstate the births
        birth_new = birth0 if kind == "replay" else loglstar0

        qu, qv, qlogl, qblob, qnc, stats, lane_stats = propose_fn(
            gen, live, live_blob, axes_args, scale, loglstar0)
        qnc = qnc.to(i64)
        it0 = integ["it"]
        st = dict(integ, **counters, racc=torch.as_tensor(
            kills0, dtype=i64, device=device))
        del st["it"]
        thin = None
        if mode == "batch" and kind != "replay" and \
                not _FORCE_GENERAL_CONSUME:
            # every proposal beats every victim: thin scalar scan.  The
            # kernel reads the flag on the card, the plain loop on the host
            thin_ok = (cand < lmax) & (qlogl.min() > loglstar0)
            if device.type != "cuda":
                thin_ok = bool(thin_ok)
                if timings is not None:
                    timings.count("sync_round")
            thin = (sort_idx, sorted_logl, thin_ok)
        if timings is not None:
            timings.count("n_round")
        outs, st = consume_round(st, live_logl0, qlogl.contiguous(),
                                 qnc.contiguous(), limits,
                                 batch=mode == "batch",
                                 dlv_default=dlv_default, thin=thin)
        (worsts, srcs, accepts, r_logl, r_logvol, r_logwt, r_logz,
         r_logzvar, r_h, r_nc, r_dlogz, r_n) = outs

        # -- vectorized record/live assembly -----------------------------
        acc_i = accepts.to(i64)
        acc_before = torch.cumsum(acc_i, 0) - acc_i
        entry_it = (it0 + acc_before).to(dtype)
        from_orig = srcs < 0
        srcc = srcs.clamp(min=0)
        fo2 = from_orig[:, None]
        u_dead = torch.where(fo2, live[worsts, :ndim], qu[srcc])
        v_dead = torch.where(fo2, live[worsts, ndim:il], qv[srcc])
        it_dead = torch.where(from_orig, live[worsts, ii], entry_it[srcc])
        bound_dead = torch.where(from_orig, live[worsts, ib], -1.0)
        birth_dead = torch.where(from_orig, live[worsts, ibirth], birth_new)
        recs = torch.cat([
            worsts.to(dtype)[:, None], u_dead, v_dead,
            torch.stack([r_logl, r_logvol, r_logwt, r_logz, r_logzvar, r_h,
                         r_nc.to(dtype), it_dead, bound_dead,
                         r_n.to(dtype), birth_dead], dim=1),
        ], dim=1)

        # last accepted entry per live slot (slot nlive is the dump row)
        idx = torch.where(accepts, worsts, nlive)
        last = torch.full((nlive + 1,), -1, dtype=i64, device=device)
        last = last.scatter_reduce(0, idx, lanes, reduce="amax")[:nlive]
        replaced = last >= 0
        lastc = last.clamp(min=0)
        new_rows = torch.cat([
            qu[lastc], qv[lastc],
            torch.stack([qlogl[lastc], entry_it[lastc],
                         torch.full((nlive,), -1.0, dtype=dtype,
                                    device=device),
                         birth_new.to(dtype).expand(nlive)], dim=1),
        ], dim=1)
        live_out = torch.where(replaced[:, None], new_rows, live)
        # blobs take the same gathers: the dead point's from the live set
        # or from the proposal that refilled its slot, the refills'
        old_blobs = blob_where(from_orig,
                               tree_map(lambda b: b[worsts], live_blob),
                               tree_map(lambda b: b[srcc], qblob))
        live_blob_out = blob_where(replaced,
                                   tree_map(lambda b: b[lastc], qblob),
                                   live_blob)

        integ_out = {k: st[k] for k in (
            "logz", "logzvar", "h", "logvol", "loglstar", "plateau_mode",
            "plateau_counter", "plateau_logdvol")}
        integ_out["it"] = it0 + (st["n_acc"] - counters["n_acc"])
        counters_out = {k: st[k] for k in (
            "n_acc", "n_cons", "nc_accum", "nc_used", "done", "reason")}
        stats_vec = torch.zeros((4,), dtype=dtype, device=device)
        stats_vec[:len(stats)] = torch.stack(
            [torch.as_tensor(s, device=device).to(dtype) for s in stats])
        proposals = torch.cat([qu, qv, qlogl[:, None], qnc.to(dtype)[:, None],
                               lane_stats.to(dtype)], dim=1)
        round_out = (recs, accepts, r_dlogz, proposals, stats_vec,
                     loglstar0.to(dtype), old_blobs, qblob)
        return live_out, live_blob_out, integ_out, counters_out, round_out

    def skipped_round(live_blob):
        z = torch.zeros
        zero_blob = tree_map(lambda b: z((q,) + b.shape[1:], dtype=b.dtype,
                                         device=device), live_blob)
        return (z((q, width), dtype=dtype, device=device),
                z((q,), dtype=torch.bool, device=device),
                z((q,), dtype=dtype, device=device),
                z((q, ndim + npdim + 4), dtype=dtype, device=device),
                z((4,), dtype=dtype, device=device),
                z((), dtype=dtype, device=device), zero_blob, zero_blob)

    def fused(seed, live, live_blob, axes_args, ctrl):
        ctrl = np.asarray(ctrl, dtype=np.float64)
        integ = integ_from_vector(ctrl, device, dtype)
        limits = {"dlogz": float(ctrl[9]), "logl_max": float(ctrl[10]),
                  "max_accepts": int(ctrl[11]), "max_nc": int(ctrl[12])}
        scale = torch.tensor(ctrl[13], dtype=dtype, device=device)
        kills0 = int(ctrl[14])
        birth0 = torch.tensor(ctrl[16] if len(ctrl) > 16 else ctrl[4],
                              dtype=dtype, device=device)
        rounds_active = int(ctrl[15])
        rounds_skip = int(ctrl[17]) if len(ctrl) > 17 else 0
        zi = torch.zeros((), dtype=i64, device=device)
        counters = {"n_acc": zi, "n_cons": zi, "nc_accum": zi,
                    "nc_used": zi,
                    "done": torch.zeros((), dtype=torch.bool, device=device),
                    "reason": zi}
        if chain_stop_fn is not None:
            counters["chain_stop"] = counters["done"]

        outs = []
        for ridx in range(rounds):
            off = ridx >= rounds_active or ridx < rounds_skip
            gate = counters["done"]
            if chain_stop_fn is not None:
                # evaluated at every round boundary; once fired, the
                # round and all later rounds run and bill nothing
                trig = counters["chain_stop"] | \
                    chain_stop_fn(integ, counters, ctrl)
                counters = dict(counters, chain_stop=trig)
                gate = trig | counters["done"]
            if not off:
                off = bool(gate)
                if timings is not None:
                    timings.count("sync_round")
            if off:
                outs.append(skipped_round(live_blob))
                continue
            was_done = counters["done"]
            chain_flag = counters.get("chain_stop")
            live, live_blob, integ, counters, round_out = one_round(
                torch_generator(round_seed(seed, ridx), device), live,
                live_blob, integ, counters, limits, scale, axes_args,
                kills0 if ridx == 0 else 0, birth0)
            if chain_flag is not None:
                counters["chain_stop"] = chain_flag
            if tune_fn is not None:
                scale = torch.where(was_done, scale,
                                    tune_fn(scale, round_out[4]).to(dtype))
            outs.append(round_out)

        old_blobs, qblobs = [tree_map(lambda *bs: torch.cat(bs), *x)
                             for x in list(zip(*outs))[6:]]
        recs, accepts, r_dlogz, proposals, stats_vecs, thresholds = \
            [torch.cat(x) if x[0].dim() else torch.stack(x)
             for x in list(zip(*outs))[:6]]
        lane_stats = proposals[:, -2:]
        integ_vec = torch.stack([
            integ["logz"], integ["logzvar"], integ["h"], integ["logvol"],
            integ["loglstar"], integ["plateau_mode"].to(dtype),
            integ["plateau_counter"].to(dtype), integ["plateau_logdvol"],
            (int(ctrl[8]) + counters["n_acc"]).to(dtype)])
        # likelihood evaluations launched this dispatch, consumed or not
        nc_launched = proposals[:, ndim + npdim + 1].sum()
        reason_out = counters["reason"]
        if chain_stop_fn is not None:
            reason_out = reason_out + 32 * counters["chain_stop"].to(i64)
        info_vec = torch.stack([x.to(dtype) for x in (
            counters["n_acc"], counters["nc_used"], counters["done"],
            counters["n_cons"], reason_out, scale, nc_launched)])
        stats_vec = stats_vecs.reshape(rounds, 4).sum(dim=0)
        flat = torch.cat([recs.reshape(-1), integ_vec, info_vec, stats_vec,
                          accepts.to(dtype), r_dlogz,
                          lane_stats.reshape(-1), thresholds.reshape(-1)])
        return flat, proposals, live, live_blob, old_blobs, qblobs

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
