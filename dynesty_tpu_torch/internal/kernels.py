"""Batched proposal rounds on the sampler's device (the counterpart of
``dynesty_tpu.internal.kernels``).

One round draws ``q`` independent constrained proposals at a fixed
likelihood threshold ``loglstar``:

* ``make_unif_round(bound_kind='cube')`` — rejection waves from the whole
  unit cube, successes compacted into output slots;
* ``make_slice_round(kind='rslice')`` — the per-lane slice-sampling state
  machine along random axes-transformed directions.

JAX's ``lax.while_loop`` over ``jnp.any(active)`` becomes a Python loop
that reads its condition from the device once per iteration; each read is
counted in the sampler's ``Timings`` (``sync_wave``, ``sync_slice``).
Random numbers come from one explicit ``torch.Generator`` per round, drawn
in a fixed order, so a seed reproduces the round.
"""

import math

import numpy as np
import torch

from ..ops.geometry import unitcheck_batch

__all__ = ["f32_precision", "pack_columns", "make_unif_round",
           "make_slice_round", "pad_ellipsoids"]

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


def _masked_eval(like, u, incube):
    """Evaluate the batched likelihood at ``u`` clamped into the cube and
    mask out-of-cube lanes to -inf."""
    v, logl, _ = like.batch_eval(u.clamp(0.0, 1.0), mask=incube)
    logl = torch.where(incube, logl, _NEG_INF).to(u.dtype)
    return v.to(u.dtype), logl


def _zeros_like_batch(like, q, ndim, dtype, device):
    """Empty result buffers (u, v, logl) for ``q`` lanes."""
    u = torch.full((q, ndim), 0.5, dtype=dtype, device=device)
    v = torch.zeros((q, like.npdim), dtype=dtype, device=device)
    logl = torch.full((q,), _NEG_INF, dtype=dtype, device=device)
    return u, v, logl


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
# uniform-in-cube kernel


def make_unif_round(like, *, ndim, q, bound_kind, dtype, device,
                    max_waves=100000, timings=None):
    """Uniform rejection sampling from the unit cube.

    Returns ``fn(gen, loglstar) -> packed (q, ndim + npdim + 5)`` with
    columns ``u | v | logl | nc | nc_total | n_proposals | n_filled``:
    per-slot ``nc`` splits the round's evaluations exactly (its sum is
    ``nc_total``); unfilled slots carry logl = -inf."""
    if bound_kind != "cube":
        raise NotImplementedError(
            f"uniform sampling from '{bound_kind}' bounds is not yet ported")
    device = torch.device(device)
    f32 = np.float32

    def round_fn(gen, loglstar):
        # one dump row (index q) takes the writes JAX drops with
        # mode="drop"; it is sliced off at the end
        bu, bv, bl = _zeros_like_batch(like, q + 1, ndim, dtype, device)
        bnc = torch.zeros((q + 1,), dtype=torch.int64, device=device)
        lanes = torch.arange(q, device=device)
        n_filled = waves = nc = n_prop = pending = 0
        while n_filled < q and waves < max_waves:
            u_prop = torch.rand((q, ndim), generator=gen, dtype=dtype,
                                device=device)
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
            valid = (lanes < width) & unitcheck_batch(u_prop)
            v_prop, logl_prop = _masked_eval(like, u_prop, valid)
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
        bl = torch.where(lanes < n_filled, bl[:q], _NEG_INF)
        return pack_columns(q, dtype, bu[:q], bv[:q], bl, bnc, nc, n_prop,
                            n_filled, device=device)

    return round_fn


# ==========================================================================
# rslice kernel (persistent-lane state machine)

PH_INIT_L, PH_INIT_R, PH_EXP_L, PH_EXP_R, PH_SHRINK = 0, 1, 2, 3, 4


def make_slice_round(like, *, ndim, q, slices, kind, dtype, device,
                     nonperiodic=None, doubling=False,
                     max_shrink_iters=10000, timings=None):
    """Slice-sampling round, kind ``'rslice'``: ``slices`` slice updates
    per lane along random directions transformed by the lane's axes and
    multiplied by ``scale``, stepping-out mode.

    Returns ``fn(gen, packed_in, scale, loglstar) -> packed (q, ndim +
    npdim + 5)`` with columns ``u | v | logl | nc | n_expand | n_contract
    | warn``; ``packed_in`` is ``u | v | logl | axes (ndim*ndim)`` of the
    start points."""
    if kind != "rslice" or doubling:
        raise NotImplementedError(
            f"slice kind '{kind}' (doubling={doubling}) is not yet ported")
    device = torch.device(device)
    npdim = like.npdim
    nb = None if nonperiodic is None else \
        torch.as_tensor(np.asarray(nonperiodic, dtype=bool), device=device)
    maxlen = math.sqrt(ndim) / 2.0
    n_steps = slices

    def _make_directions(gen, axes, scale):
        drhat = torch.randn((q, n_steps, ndim), generator=gen, dtype=dtype,
                            device=device)
        drhat = drhat / torch.linalg.vector_norm(drhat, dim=-1,
                                                 keepdim=True)
        return torch.einsum("qij,qsj->qsi", axes, drhat) * scale

    def round_fn(gen, packed_in, scale, loglstar):
        start_u = packed_in[:, :ndim].to(dtype)
        start_v = packed_in[:, ndim:ndim + npdim].to(dtype)
        start_logl = packed_in[:, ndim + npdim].to(dtype)
        axes = packed_in[:, ndim + npdim + 1:].reshape(q, ndim, ndim)
        directions = _make_directions(gen, axes.to(dtype), scale)
        # cap each direction's length at the cube diagonal
        dirlen = torch.linalg.vector_norm(directions, dim=-1)
        dirnorm = torch.where(dirlen > maxlen, dirlen / maxlen, 1.0)
        directions = directions / dirnorm[..., None]

        r0 = torch.rand((q,), generator=gen, dtype=dtype, device=device)
        zi = torch.zeros((q,), dtype=torch.int64, device=device)
        lane = torch.arange(q, device=device)
        s, phase = zi, torch.full_like(zi, PH_INIT_L)
        u, v, logl, u0 = start_u, start_v, start_logl, start_u
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
            v_x, logl_x = _masked_eval(like, upos, incube)
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
                            device=device)

    return round_fn
