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
counted in the sampler's ``Timings`` (``sync_wave``, ``sync_slice``).
Random numbers come from one explicit ``torch.Generator`` per round, drawn
in a fixed order and in the kernel's dtype, so a seed reproduces the round.
"""

import math

import numpy as np
import torch

from ..ops.geometry import apply_reflect, randsphere_batch, unitcheck_batch
from ..utils.misc import blob_where, tree_map

__all__ = ["f32_precision", "pack_columns", "make_unif_round",
           "make_ellipsoid_refit", "make_rwalk_round", "make_slice_round",
           "slice_directions", "doubling_accept", "pad_ellipsoids"]

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


def _count(timings, key):
    if timings is not None:
        timings.count(key)


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


def _wrap_boundaries(u, periodic_mask, reflective_mask):
    """Apply periodic wrapping / reflection on the marked dimensions."""
    if periodic_mask is not None:
        u = torch.where(periodic_mask, torch.remainder(u, 1.0), u)
    if reflective_mask is not None:
        u = torch.where(reflective_mask, apply_reflect(u), u)
    return u


def _masked_eval(like, u, incube):
    """Evaluate the batched likelihood at ``u`` clamped into the cube,
    counting the lanes of ``incube``, and mask the others to -inf.
    Returns ``(v, logl, blob)``."""
    v, logl, blob = like.batch_eval(u.clamp(0.0, 1.0), mask=incube)
    logl = torch.where(incube, logl, _NEG_INF).to(u.dtype)
    return v.to(u.dtype), logl, blob


def _zeros_like_batch(like, q, ndim, dtype, device):
    """Empty result buffers (u, v, logl, blob) for ``q`` lanes."""
    u = torch.full((q, ndim), 0.5, dtype=dtype, device=device)
    v = torch.zeros((q, like.npdim), dtype=dtype, device=device)
    logl = torch.full((q,), _NEG_INF, dtype=dtype, device=device)
    blob = like.blob_zeros(q, device) if getattr(like, "blob", False) \
        else None
    return u, v, logl, blob


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
    ellipsoid choice, a ball sample mapped through its axes, 1/q overlap
    rejection (with the q==0 round-off rescue).  Random numbers come from
    ``gen`` in a fixed order: choice, ball, acceptance.  Returns (points
    (q, ncdim), valid (q,))."""
    ctrs = arrays["ctrs"].to(dtype)
    axes = arrays["axes"].to(dtype)
    ams = arrays["ams"].to(dtype)
    mask = arrays["mask"]
    device = ctrs.device
    # masked slots get weight exp(-inf) = 0
    logp = torch.where(mask, arrays["logvols"].to(dtype), _NEG_INF)
    idx = torch.multinomial(torch.exp(logp - logp.max()), q,
                            replacement=True, generator=gen)
    ball = randsphere_batch(gen, (q,), ncdim, dtype, device)
    x = ctrs[idx] + torch.einsum("qij,qj->qi", axes[idx], ball)

    # membership count over all (masked) ellipsoids
    d = x[:, None, :] - ctrs[None, :, :]
    sq = torch.einsum("qmi,mij,qmj->qm", d, ams, d)
    sq = torch.where(mask[None, :], sq, math.inf)
    nin = (sq < 1.0).sum(dim=1)
    nin_loose = (sq <= 1.0 + 1e-3).sum(dim=1)
    nin = torch.where(nin > 0, nin, nin_loose)  # round-off rescue
    accept = torch.rand((q,), generator=gen, dtype=dtype, device=device) < \
        1.0 / nin.clamp_min(1).to(dtype)
    return x, accept & (nin > 0)


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

    Returns ``refit(u_live, arrays) -> arrays`` (the same padded
    schema)."""
    d = ncdim
    eps_contain = 1e-3
    # d-ball log-volume prefactor: device log-volumes on the host fit's
    # scale (the two mix when a slot keeps its previous fit)
    logvol_pref = (d / 2.0) * math.log(math.pi) - math.lgamma(d / 2.0 + 1.0)

    def refit(u, arrays):
        ctrs0 = arrays["ctrs"].to(dtype)
        axes0 = arrays["axes"].to(dtype)
        ams0 = arrays["ams"].to(dtype)
        logvols0 = arrays["logvols"].to(dtype)
        mask = arrays["mask"]
        expand = arrays.get("expand")
        expand = 1.0 if expand is None else expand.to(dtype)
        m = ctrs0.shape[0]
        u = u.to(dtype)

        diff = u[:, None, :] - ctrs0[None, :, :]
        d2 = torch.einsum("nmi,mij,nmj->nm", diff, ams0, diff)
        d2 = torch.where(mask[None, :], d2, math.inf)
        idx = torch.argmin(d2, dim=1)
        onehot = torch.nn.functional.one_hot(idx, m).to(dtype)
        counts = onehot.sum(dim=0)
        safe = counts.clamp_min(1.0)
        ctr = (onehot.T @ u) / safe[:, None]
        cent = u[:, None, :] - ctr[None, :, :]
        cov = torch.einsum("nm,nmi,nmj->mij", onehot, cent,
                           cent) / safe[:, None, None]
        # conditioning floor keeps degenerate clusters factorizable
        tr = torch.diagonal(cov, dim1=1, dim2=2).sum(dim=1) / d
        eye = torch.eye(d, dtype=dtype, device=u.device)
        cov = cov + (1e-10 * tr.clamp_min(1e-30))[:, None, None] * eye
        # cholesky_ex reports a failed factorization in `info` instead of
        # raising (jnp.linalg.cholesky returns NaN there)
        chol, info = torch.linalg.cholesky_ex(cov)
        ok = (info == 0) & torch.isfinite(chol.reshape(m, -1)).all(dim=1) \
            & (counts >= d + 1)
        chol_safe = torch.where(ok[:, None, None], chol, eye[None])
        linv = torch.linalg.solve_triangular(
            chol_safe, eye.expand(m, d, d), upper=False)
        am = torch.einsum("mki,mkj->mij", linv, linv)  # cov^-1

        # inflate to contain every member, then the host's calibration
        dd = u - ctr[idx]
        d2o = torch.einsum("ni,nij,nj->n", dd, am[idx], dd)
        fmax = torch.zeros((m,), dtype=dtype, device=u.device).scatter_reduce(
            0, idx, d2o, reduce="amax", include_self=True)
        f = torch.sqrt(fmax.clamp_min(1e-30) / (1.0 - eps_contain)) * expand
        axes = chol_safe * f[:, None, None]
        am = am / (f ** 2)[:, None, None]
        logvol = torch.log(torch.diagonal(chol_safe, dim1=1, dim2=2)
                           .abs()).sum(dim=1) + d * torch.log(f) + \
            logvol_pref

        keep = mask & ok
        k1, k3 = keep[:, None], keep[:, None, None]
        return {
            "ctrs": torch.where(k1, ctr, ctrs0),
            "axes": torch.where(k3, axes, axes0),
            "ams": torch.where(k3, am, ams0),
            "logvols": torch.where(keep, logvol, logvols0),
            "mask": mask,
        }

    return refit


# ==========================================================================
# uniform-in-bound kernel


def make_unif_round(like, *, ndim, q, bound_kind, dtype, device,
                    ncdim=None, nonbounded=None, max_waves=100000,
                    timings=None, host_sampler=None):
    """Uniform rejection sampling from the unit cube (``bound_kind``
    'cube'), a union of ellipsoids ('ellipsoids'), a union of
    balls/cubes ('balls'/'cubes'), or a user's bound ('custom'), whose
    ``host_sampler()`` gives each wave's ``(q, ncdim)`` points as a host
    array: a plain call between waves, every lane a draw.

    Returns ``fn(gen, loglstar, arrays) -> (packed (q, ndim + npdim + 5),
    blob)`` with columns ``u | v | logl | nc | nc_total | n_proposals |
    n_filled``: per-slot ``nc`` splits the round's evaluations exactly
    (its sum is ``nc_total``); unfilled slots carry logl = -inf.
    ``arrays`` is the bound's device dict (ignored for the cube).  The
    bound lives in the first ``ncdim`` dimensions (checked against the
    cube there, loosely where ``nonbounded`` is False); the other
    ``ndim - ncdim`` are drawn uniformly."""
    if bound_kind not in ("cube", "ellipsoids", "balls", "cubes", "custom"):
        raise ValueError(f"unknown bound kind '{bound_kind}'")
    if bound_kind == "custom" and host_sampler is None:
        raise ValueError("a custom bound needs a host_sampler")
    device = torch.device(device)
    f32 = np.float32
    ncdim = ncdim or ndim
    n_extra = ndim - ncdim
    nb_cluster = None if nonbounded is None else \
        _bool_mask(np.asarray(nonbounded, dtype=bool)[:ncdim], device)

    def draw_cluster(gen, arrays):
        if bound_kind == "cube":
            u = torch.rand((q, ncdim), generator=gen, dtype=dtype,
                           device=device)
            return u, None
        if bound_kind == "ellipsoids":
            return _sample_ellipsoid_union(gen, arrays, q, ncdim, dtype)
        if bound_kind == "custom":
            return torch.as_tensor(np.asarray(host_sampler()), dtype=dtype,
                                   device=device), None
        return _sample_friends_union(gen, arrays, q, ncdim, dtype,
                                     bound_kind)

    def round_fn(gen, loglstar, arrays):
        # one dump row (index q) takes the writes JAX drops with
        # mode="drop"; it is sliced off at the end
        bu, bv, bl, bb = _zeros_like_batch(like, q + 1, ndim, dtype,
                                           device)
        bnc = torch.zeros((q + 1,), dtype=torch.int64, device=device)
        lanes = torch.arange(q, device=device)
        n_filled = waves = nc = n_prop = pending = 0
        while n_filled < q and waves < max_waves:
            uc, drawn = draw_cluster(gen, arrays)
            u_prop = uc if n_extra == 0 else torch.cat([
                uc, torch.rand((q, n_extra), generator=gen, dtype=dtype,
                               device=device)], dim=1)
            # adaptive wave width (float32 arithmetic, as in the JAX
            # kernel): after the first wave only ~1.25 need/eff + 4 lanes
            # count as launched proposals
            if n_filled > 0 and n_prop > 0:
                need = f32(q - n_filled)
                eff = f32(n_filled) / max(f32(n_prop), f32(1.0))
                est = np.ceil(f32(1.25) * need / max(eff, f32(1e-6))) + \
                    f32(4.0)
                width = int(min(est, f32(q)))
            else:
                width = q
            valid = (lanes < width) & unitcheck_batch(uc, nb_cluster)
            if drawn is not None:
                valid = valid & drawn
            v_prop, logl_prop, blob_prop = _masked_eval(like, u_prop,
                                                        valid)
            success = valid & (logl_prop > loglstar)
            n_succ, nc_wave = torch.stack(
                [success.sum(), valid.sum()]).tolist()
            _count(timings, "sync_wave")
            rank = torch.cumsum(success, 0) - 1
            dest = n_filled + rank
            dest = torch.where(success & (dest < q), dest, q)
            bu[dest] = u_prop
            bv[dest] = v_prop
            bl[dest] = logl_prop
            tree_map(lambda b, p: b.__setitem__(dest, p), bb, blob_prop)
            n_new = min(n_succ, q - n_filled)
            # exact per-slot attribution of the evaluations since the
            # last successful wave (remainder to the lowest ranks)
            avail = pending + nc_wave
            share = avail // max(n_new, 1)
            rem = avail - share * max(n_new, 1)
            bnc[dest] = share + (rank < rem).to(torch.int64)
            pending = 0 if n_new > 0 else avail
            n_filled += n_new
            waves += 1
            nc += nc_wave
            n_prop += width
        bnc = bnc[:q].clone()
        # a failed fill (max_waves hit) leaves unflushed evaluations:
        # charge them to slot 0 so sum(per-slot nc) == total nc
        bnc[0] += pending
        # partial fill: unfilled slots read as rejected proposals
        bl = torch.where(lanes < n_filled, bl[:q], _NEG_INF)
        return pack_columns(q, dtype, bu[:q], bv[:q], bl, bnc, nc, n_prop,
                            n_filled, device=device), \
            tree_map(lambda b: b[:q], bb)

    return round_fn


# ==========================================================================
# random-walk kernel


def make_rwalk_round(like, *, ndim, ncdim, q, walks, dtype, device,
                     nonbounded=None, periodic=None, reflective=None):
    """Random-walk round: each of the ``q`` lanes makes exactly ``walks``
    proposals inside its scaled ellipsoid (axes per lane, in the first
    ``ncdim`` dimensions; the other dimensions are drawn uniformly),
    accepting moves with ``logl > loglstar``.  Periodic and reflective
    dimensions are wrapped before the cube check.  The loop has a fixed
    length, so the round never reads the device from the host.

    Returns ``fn(gen, packed_in, start_blob, scale, loglstar) -> (packed
    (q, ndim + npdim + 3), blob)`` with columns ``u | v | logl | n_accept
    | n_reject``; ``packed_in`` is ``u | v | logl | axes (ncdim*ncdim)``
    of the start points, ``start_blob`` their blobs.  A lane that never
    accepts keeps its start point."""
    device = torch.device(device)
    npdim = like.npdim
    nb = _bool_mask(nonbounded, device)
    pm = _mask_from_indices(periodic, ndim, device)
    rm = _mask_from_indices(reflective, ndim, device)
    n_extra = ndim - ncdim

    def round_fn(gen, packed_in, start_blob, scale, loglstar):
        u = packed_in[:, :ndim].to(dtype)
        v = packed_in[:, ndim:ndim + npdim].to(dtype)
        logl = packed_in[:, ndim + npdim].to(dtype)
        blob = start_blob
        axes = packed_in[:, ndim + npdim + 1:].reshape(
            q, ncdim, ncdim).to(dtype)
        n_acc = n_rej = torch.zeros((q,), dtype=torch.int64, device=device)
        for _ in range(walks):
            dr = randsphere_batch(gen, (q,), ncdim, dtype, device)
            u_prop = u[:, :ncdim] + \
                torch.einsum("qij,qj->qi", axes, dr) * scale
            if n_extra > 0:
                u_prop = torch.cat([u_prop, torch.rand(
                    (q, n_extra), generator=gen, dtype=dtype,
                    device=device)], dim=1)
            u_prop = _wrap_boundaries(u_prop, pm, rm)
            ok = unitcheck_batch(u_prop, nb)
            v_prop, logl_prop, blob_prop = _masked_eval(like, u_prop, ok)
            accept = ok & (logl_prop > loglstar)
            u = torch.where(accept[:, None], u_prop, u)
            v = torch.where(accept[:, None], v_prop, v)
            logl = torch.where(accept, logl_prop, logl)
            blob = blob_where(accept, blob_prop, blob)
            n_acc = n_acc + accept
            n_rej = n_rej + ~accept
        return pack_columns(q, dtype, u, v, logl, n_acc, n_rej,
                            device=device), blob

    return round_fn


# ==========================================================================
# slice kernels

PH_INIT_L, PH_INIT_R, PH_EXP_L, PH_EXP_R, PH_SHRINK = 0, 1, 2, 3, 4


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


def make_slice_round(like, *, ndim, q, slices, kind, dtype, device,
                     nonperiodic=None, doubling=False,
                     max_shrink_iters=10000, timings=None):
    """Slice-sampling round.  ``kind='rslice'``: ``slices`` slice updates
    per lane along random directions transformed by the lane's axes.
    ``kind='slice'``: ``slices`` passes over all ``ndim`` principal axes in
    a per-lane shuffled order.  Directions are multiplied by ``scale``.

    Stepping-out mode runs the per-lane state machine (every lane advances
    its own phase through its whole budget of slice updates); with
    ``doubling`` the barrier form runs instead: all lanes take one slice
    update at a time, expanding by Neal's (2003) doubling procedure and
    shrinking with its acceptance test.

    Returns ``fn(gen, packed_in, start_blob, scale, loglstar) -> (packed
    (q, ndim + npdim + 5), blob)`` with columns ``u | v | logl | nc |
    n_expand | n_contract | warn``; ``packed_in`` is ``u | v | logl | axes
    (ndim*ndim)`` of the start points, ``start_blob`` their blobs.
    ``nc`` counts out-of-cube probes too; ``warn`` flags an interval
    stepped out more than 1000 times (the host then switches to doubling
    when the dispatch is over)."""
    if kind not in ("slice", "rslice"):
        raise ValueError(f"Unknown slice kind '{kind}'")
    device = torch.device(device)
    npdim = like.npdim
    nb = _bool_mask(nonperiodic, device)
    maxlen = math.sqrt(ndim) / 2.0
    n_steps = slices * ndim if kind == "slice" else slices

    def one_doubling_step(gen, u0, v0, logl0, blob0, direction, loglstar):
        """One slice update of all lanes along per-lane ``direction``;
        each evaluation counts the in-cube lanes of its ``mask``."""
        dirlen = torch.linalg.vector_norm(direction, dim=1)
        dirnorm = torch.where(dirlen > maxlen, dirlen / maxlen, 1.0)
        direction = direction / dirnorm[:, None]

        def feval(x, mask=None):
            u = u0 + x[:, None] * direction
            incube = unitcheck_batch(u, nb)
            if mask is not None:
                incube = incube & mask
            return (u,) + _masked_eval(like, u, incube)

        r0 = torch.rand((q,), generator=gen, dtype=dtype, device=device)
        left, right = -r0, 1.0 - r0
        fl, fr = feval(left)[2], feval(right)[2]
        nc = torch.full((q,), 2, dtype=torch.int64, device=device)
        n_exp = torch.zeros_like(nc)
        grow = torch.ones_like(nc)
        # doubling expansion: a random side doubles the interval until both
        # ends are outside the slice
        active = (fl > loglstar) | (fr > loglstar)
        while True:
            _count(timings, "sync_slice")
            if not bool(active.any()):
                break
            go_left = torch.rand((q,), generator=gen, dtype=dtype,
                                 device=device) < 0.5
            width = right - left
            left = torch.where(active & go_left, left - width, left)
            right = torch.where(active & ~go_left, right + width, right)
            logl_new = feval(torch.where(go_left, left, right),
                             active)[2]
            fl = torch.where(active & go_left, logl_new, fl)
            fr = torch.where(active & ~go_left, logl_new, fr)
            nc = nc + active
            n_exp = n_exp + active * grow
            grow = torch.where(active, (grow * 2).clamp(max=1 << 30), grow)
            active = active & ((fl > loglstar) | (fr > loglstar))
        big = (left, right, fl, fr)

        # shrinkage, each candidate held to the doubling acceptance test
        u, v, logl, blob = u0, v0, logl0, blob0
        n_con = torch.zeros_like(nc)
        active = torch.ones((q,), dtype=torch.bool, device=device)
        for _ in range(max_shrink_iters):
            _count(timings, "sync_slice")
            if not bool(active.any()):
                break
            x = left + torch.rand((q,), generator=gen, dtype=dtype,
                                  device=device) * (right - left)
            u_prop, v_prop, logl_prop, blob_prop = feval(x, active)
            nc = nc + active
            n_con = n_con + active
            good = logl_prop > loglstar
            # only the lanes whose evaluations are billed are tested
            d_acc, d_nc = doubling_accept(
                lambda xm, m: feval(xm, m)[2], x, loglstar, *big,
                timings=timings, lanes=active & good)
            nc = nc + torch.where(active & good, d_nc, 0)
            good = good & d_acc
            newly = active & good
            u = torch.where(newly[:, None], u_prop, u)
            v = torch.where(newly[:, None], v_prop, v)
            logl = torch.where(newly, logl_prop, logl)
            blob = blob_where(newly, blob_prop, blob)
            bad = active & ~good
            left = torch.where(bad & (x < 0), x, left)
            right = torch.where(bad & (x > 0), x, right)
            active = bad
        return u, v, logl, blob, nc, n_exp, n_con

    def round_fn(gen, packed_in, start_blob, scale, loglstar):
        u = packed_in[:, :ndim].to(dtype)
        v = packed_in[:, ndim:ndim + npdim].to(dtype)
        logl = packed_in[:, ndim + npdim].to(dtype)
        blob = start_blob
        axes = packed_in[:, ndim + npdim + 1:].reshape(q, ndim, ndim)
        directions = slice_directions(gen, axes.to(dtype), scale, kind,
                                      slices)
        nc = n_exp = n_con = torch.zeros((q,), dtype=torch.int64,
                                         device=device)
        for s in range(n_steps):
            u, v, logl, blob, nc1, ne1, ncon1 = one_doubling_step(
                gen, u, v, logl, blob, directions[:, s], loglstar)
            nc, n_exp, n_con = nc + nc1, n_exp + ne1, n_con + ncon1
        # the doubling procedure has no expansion warning
        return pack_columns(q, dtype, u, v, logl, nc, n_exp, n_con, False,
                            device=device), blob

    def round_fn_sm(gen, packed_in, start_blob, scale, loglstar):
        start_u = packed_in[:, :ndim].to(dtype)
        start_v = packed_in[:, ndim:ndim + npdim].to(dtype)
        start_logl = packed_in[:, ndim + npdim].to(dtype)
        axes = packed_in[:, ndim + npdim + 1:].reshape(q, ndim, ndim)
        directions = slice_directions(gen, axes.to(dtype), scale, kind,
                                      slices)
        # cap each direction's length at the cube diagonal
        dirlen = torch.linalg.vector_norm(directions, dim=-1)
        dirnorm = torch.where(dirlen > maxlen, dirlen / maxlen, 1.0)
        directions = directions / dirnorm[..., None]

        r0 = torch.rand((q,), generator=gen, dtype=dtype, device=device)
        zi = torch.zeros((q,), dtype=torch.int64, device=device)
        lane = torch.arange(q, device=device)
        s, phase = zi, torch.full_like(zi, PH_INIT_L)
        u, v, logl, u0 = start_u, start_v, start_logl, start_u
        blob = start_blob
        left, right = -r0, 1.0 - r0
        fl = torch.full((q,), _NEG_INF, dtype=dtype, device=device)
        fr = fl
        nc = n_exp = n_con = exp_step = zi
        warn = torch.zeros((), dtype=torch.bool, device=device)

        it = 0
        max_total = n_steps * max_shrink_iters
        while it < max_total:
            active = s < n_steps
            _count(timings, "sync_slice")
            if not bool(active.any()):
                break
            u_sh, u_r0 = torch.rand((2, q), generator=gen, dtype=dtype,
                                    device=device)
            dirc = directions[lane, s.clamp(max=n_steps - 1)]
            x = torch.where(
                phase == PH_INIT_L, left,
                torch.where(phase == PH_INIT_R, right,
                            torch.where(phase == PH_EXP_L, left - 1.0,
                                        torch.where(phase == PH_EXP_R,
                                                    right + 1.0,
                                                    left + u_sh *
                                                    (right - left)))))
            upos = u0 + x[:, None] * dirc
            incube = unitcheck_batch(upos, nb) & active
            v_x, logl_x, blob_x = _masked_eval(like, upos, incube)
            nc = nc + active

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
            n_exp = n_exp + expanding
            exp_step = exp_step + expanding
            n_con = n_con + is_sh

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
            u = torch.where(acc2, upos, u)
            v = torch.where(acc2, v_x, v)
            logl = torch.where(acc, logl_x, logl)
            blob = blob_where(acc, blob_x, blob)
            u0 = torch.where(acc2, upos, u0)
            s = s + acc
            left = torch.where(acc, -u_r0, left)
            right = torch.where(acc, 1.0 - u_r0, right)
            fl = torch.where(acc, _NEG_INF, fl)
            fr = torch.where(acc, _NEG_INF, fr)
            phase = torch.where(acc, PH_INIT_L, nphase)
            warn = warn | (exp_step > 1000).any()
            exp_step = torch.where(acc, 0, exp_step)
            it += 1
        return pack_columns(q, dtype, u, v, logl, nc, n_exp, n_con, warn,
                            device=device), blob

    return round_fn if doubling else round_fn_sm
