"""The uniform rejection wave (``dynesty_tpu_torch/ops/proposals.py``,
``UnifRound``, ``unif_valid``, ``unif_place``; ``dynesty_tpu_torch/
internal/kernels.py``, ``UnifGraph``, ``make_unif_round``).

On the CPU: whole rounds through the round buffers and the plain versions
against the eager loop they replace (copied below as it was), bit for
bit: the unit cube, a union of ellipsoids, balls and cubes, with loose
dimensions and dimensions outside the bound, float64 and float32, 32 and
256 lanes, a wave with no success (its evaluations carried), a wave with
more successes than free slots and a fill cut by the cap on waves; the
plain placement on hand-made states against the eager wave's arithmetic;
the width formula against the host's numpy float32 (counts past 2**24
among them); gated, all-fail and overflowing waves through the round
buffers; the round-shape cache a sampler keeps; and, against the JAX
package, a round over a user's bound (the same host draws and
likelihood: integer columns and ``u`` equal, ``v`` and ``logl`` to 1e-12
relative, as XLA and torch may round the likelihood's sum differently in
the last ulp; the threshold keeps every candidate 1e-9 away) and the
union of ellipsoids' acceptance on the JAX package's own draws.

On a card (``cuda``-marked, skipped here): the two kernels against the
plain versions bit for bit (the placement also on those edge waves at
32, 256 and 700 lanes), captured waves against eager ones (columns,
blob, generator offset, counts), a capture that raises, and a run that
never reaches a plain version.  The JAX package is imported by a fixture
only, so that on the card

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_unif_wave.py

runs the card's tests (``tests/conftest.py`` sets JAX up, which they do
not use).
"""

import math
import pickle
import warnings

import numpy as np
import pytest
import torch

import dynesty_tpu_torch.internal.kernels as tk
from dynesty_tpu_torch.bounding import MultiEllipsoid
from dynesty_tpu_torch.internal.likelihood import LogLikelihood
from dynesty_tpu_torch.internal.samplers import UniformBoundSampler
from dynesty_tpu_torch.ops import proposals as pr
from dynesty_tpu_torch.ops.geometry import randsphere_batch, unitcheck_batch
from dynesty_tpu_torch.utils.convert import bound_arrays_to_torch
from dynesty_tpu_torch.utils.misc import Timings, tree_map

from utils import get_rstate

torch.set_num_threads(1)

_NEG_INF = -math.inf
# (kind, ndim, ncdim, nonbounded) of the whole-round comparisons
KINDS = [("cube", 3, 3, None),
         ("ellipsoids", 4, 3, [True, False, True, True]),
         ("balls", 3, 3, None),
         ("cubes", 4, 3, [True, True, False, True])]


@pytest.fixture(scope="module")
def jx():
    """jax, jax.numpy and the JAX package's kernels module."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("the JAX comparisons run under tests/conftest.py "
                    "(JAX on the CPU in float64)")
    import jax.numpy as jnp

    import dynesty_tpu.internal.kernels as jk
    return jax, jnp, jk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# the eager round as it was


def _old_ellipsoid_union(gen, arrays, q, ncdim, dtype):
    ctrs = arrays["ctrs"].to(dtype)
    axes = arrays["axes"].to(dtype)
    ams = arrays["ams"].to(dtype)
    mask = arrays["mask"]
    device = ctrs.device
    logp = torch.where(mask, arrays["logvols"].to(dtype), _NEG_INF)
    idx = torch.multinomial(torch.exp(logp - logp.max()), q,
                            replacement=True, generator=gen)
    ball = randsphere_batch(gen, (q,), ncdim, dtype, device)
    x = ctrs[idx] + torch.einsum("qij,qj->qi", axes[idx], ball)
    d = x[:, None, :] - ctrs[None, :, :]
    sq = torch.einsum("qmi,mij,qmj->qm", d, ams, d)
    sq = torch.where(mask[None, :], sq, math.inf)
    nin = (sq < 1.0).sum(dim=1)
    nin_loose = (sq <= 1.0 + 1e-3).sum(dim=1)
    nin = torch.where(nin > 0, nin, nin_loose)
    accept = torch.rand((q,), generator=gen, dtype=dtype, device=device) < \
        1.0 / nin.clamp_min(1).to(dtype)
    return x, accept & (nin > 0)


def _old_round(like, gen, loglstar, arrays, *, ndim, ncdim, q, kind, dtype,
               nonbounded=None, max_waves=100000, host_sampler=None,
               log=None):
    """``make_unif_round``'s round as it ran before its kernels: fresh
    buffers, the width in numpy float32 on the host, one device read in
    each wave.  ``log`` collects each wave's successes and free slots."""
    device = torch.device("cpu")
    f32 = np.float32
    n_extra = ndim - ncdim
    nb = None if nonbounded is None else torch.as_tensor(
        np.asarray(nonbounded, dtype=bool)[:ncdim])

    def draw_cluster():
        if kind == "cube":
            return torch.rand((q, ncdim), generator=gen, dtype=dtype), None
        if kind == "ellipsoids":
            return _old_ellipsoid_union(gen, arrays, q, ncdim, dtype)
        if kind == "custom":
            return torch.as_tensor(np.asarray(host_sampler()),
                                   dtype=dtype), None
        return tk._sample_friends_union(gen, arrays, q, ncdim, dtype, kind)

    bu = torch.full((q + 1, ndim), 0.5, dtype=dtype)
    bv = torch.zeros((q + 1, like.npdim), dtype=dtype)
    bl = torch.full((q + 1,), _NEG_INF, dtype=dtype)
    bb = like.blob_zeros(q + 1, device) if getattr(like, "blob", False) \
        else None
    bnc = torch.zeros((q + 1,), dtype=torch.int64)
    lanes = torch.arange(q)
    n_filled = waves = nc = n_prop = pending = 0
    while n_filled < q and waves < max_waves:
        uc, drawn = draw_cluster()
        u_prop = uc if n_extra == 0 else torch.cat([
            uc, torch.rand((q, n_extra), generator=gen, dtype=dtype)], dim=1)
        if n_filled > 0 and n_prop > 0:
            need = f32(q - n_filled)
            eff = f32(n_filled) / max(f32(n_prop), f32(1.0))
            est = np.ceil(f32(1.25) * need / max(eff, f32(1e-6))) + \
                f32(4.0)
            width = int(min(est, f32(q)))
        else:
            width = q
        valid = (lanes < width) & unitcheck_batch(uc, nb)
        if drawn is not None:
            valid = valid & drawn
        v_prop, logl_prop, blob_prop = like.batch_eval(
            u_prop.clamp(0.0, 1.0), mask=valid)
        logl_prop = torch.where(valid, logl_prop, _NEG_INF).to(dtype)
        v_prop = v_prop.to(dtype)
        success = valid & (logl_prop > loglstar)
        n_succ, nc_wave = torch.stack([success.sum(), valid.sum()]).tolist()
        if log is not None:
            log.append((n_succ, q - n_filled))
        rank = torch.cumsum(success, 0) - 1
        dest = n_filled + rank
        dest = torch.where(success & (dest < q), dest, q)
        bu[dest] = u_prop
        bv[dest] = v_prop
        bl[dest] = logl_prop
        tree_map(lambda b, p: b.__setitem__(dest, p), bb, blob_prop)
        n_new = min(n_succ, q - n_filled)
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
    bnc[0] += pending
    bl = torch.where(lanes < n_filled, bl[:q], _NEG_INF)
    return tk.pack_columns(q, dtype, bu[:q], bv[:q], bl, bnc, nc, n_prop,
                           n_filled), tree_map(lambda b: b[:q], bb)


# --------------------------------------------------------------------------
# the bounds and the likelihood


def blob_ll(x):
    l = -0.5 * (((x - 0.1) / 1.5) ** 2).sum()
    return l, torch.stack([l, x[0]])


def _like(ndim, dtype, device="cpu", cls=LogLikelihood, fn=blob_ll,
          blob=True, mode="torch"):
    like = cls(fn, lambda u: 4.0 * u - 2.0, ndim, device=device, blob=blob,
               dtype=dtype, mode=mode)
    like.eval_host(np.full((2, ndim), 0.5))
    return like


def _arrays(kind, ncdim, dtype, device="cpu"):
    """The bound's device arrays: three ellipsoids (padded to four slots,
    one reaching past the cube), or 60 live points as friends' centres."""
    rs = get_rstate(7)
    if kind == "ellipsoids":
        ctrs = np.array([[0.3, 0.4, 0.5], [0.6, 0.55, 0.5],
                         [0.9, 0.2, 0.6]])[:, :ncdim]
        covs = np.array([np.diag(rs.uniform(0.01, 0.03, ncdim))
                         for _ in ctrs])
        mb = MultiEllipsoid(ncdim, ctrs=ctrs, covs=covs)
        return bound_arrays_to_torch(kind, mb.device_spec()[1], device,
                                     dtype)
    if kind in ("balls", "cubes"):
        a = rs.normal(size=(ncdim, ncdim))
        w, vec = np.linalg.eigh(0.004 * (np.eye(ncdim) + 0.1 * (a + a.T)))
        axes = (vec * np.sqrt(w)) @ vec.T
        return {k: torch.as_tensor(v, dtype=dtype, device=device)
                for k, v in (("ctrs", rs.uniform(0.15, 0.85, (60, ncdim))),
                             ("axes", axes),
                             ("axes_inv", np.linalg.inv(axes)))}
    return {}


def _threshold(like, share, seed=3):
    """The likelihood that ``share`` of the cube's points beat."""
    u = get_rstate(seed).random((4000, like.ndim))
    return float(np.quantile(like.eval_host(u)[1], 1.0 - share))


def _bound_threshold(like, kind, ndim, ncdim, nonbounded, arrays, dtype,
                     share):
    """The likelihood that ``share`` of the bound's valid candidates beat
    (one wave of 2048 of them at no threshold)."""
    gen = torch.Generator()
    gen.manual_seed(99)
    out, _ = _old_round(like, gen, _NEG_INF, arrays, ndim=ndim, ncdim=ncdim,
                        q=2048, kind=kind, dtype=dtype,
                        nonbounded=nonbounded, max_waves=1)
    logl = out[:, ndim + like.npdim].numpy()
    return float(np.quantile(logl[np.isfinite(logl)], 1.0 - share))


# --------------------------------------------------------------------------
# whole rounds against the eager loop


@pytest.mark.parametrize("kind,ndim,ncdim,nonbounded", KINDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("q", [32, 256])
def test_round_equals_the_eager_round(kind, ndim, ncdim, nonbounded, dtype,
                                      q):
    """Three rounds on one sampler cache (the later ones reuse the first's
    buffers) against the eager loop: every column, the blob and the
    generator's state; a tight threshold gives waves with no success and
    a last wave with more successes than free slots."""
    like = _like(ndim, dtype)
    arrays = _arrays(kind, ncdim, dtype)
    cache, timings = {}, Timings()
    fn = tk.make_unif_round(like, ndim=ndim, ncdim=ncdim, q=q,
                            bound_kind=kind, nonbounded=nonbounded,
                            dtype=dtype, device="cpu", timings=timings,
                            rounds=cache)
    log = []
    for seed, share in ((1, 0.3), (2, 0.02), (3, 0.6)):
        loglstar = _bound_threshold(like, kind, ndim, ncdim, nonbounded,
                                    arrays, dtype, share)
        g_new, g_old = torch.Generator(), torch.Generator()
        g_new.manual_seed(seed)
        g_old.manual_seed(seed)
        got, got_blob = fn(g_new, loglstar, arrays)
        ref, ref_blob = _old_round(like, g_old, loglstar, arrays, ndim=ndim,
                                   ncdim=ncdim, q=q, kind=kind, dtype=dtype,
                                   nonbounded=nonbounded, log=log)
        assert torch.equal(got, ref)
        assert torch.equal(got_blob, ref_blob)
        assert torch.equal(g_new.get_state(), g_old.get_state())
        il = ndim + like.npdim
        assert int(got[0, il + 4]) == q
        assert int(got[:, il + 1].sum()) == int(got[0, il + 2])
    assert timings["sync_wave"] == len(log) > 3
    # a wave with more successes than free slots, and at the narrow
    # width a wave with no success
    assert any(n > free for n, free in log)
    assert q > 32 or any(n == 0 for n, _ in log)
    assert len(cache) == 1 and next(iter(cache))[0] == "unif"
    # the CPU never captures and counts nothing of the card's
    assert not any(k in timings for k in ("n_unif_replay", "n_unif_graph",
                                          "n_uncaptured"))


@pytest.mark.parametrize("kind,ndim,ncdim,nonbounded", KINDS[:2])
def test_a_fill_cut_by_the_cap_on_waves(kind, ndim, ncdim, nonbounded):
    """A round stopped by ``max_waves`` before it filled: the unfilled
    slots read -inf, the evaluations since the last success go to slot 0,
    every column as the eager loop gave it."""
    q, dtype = 32, torch.float64
    like = _like(ndim, dtype)
    arrays = _arrays(kind, ncdim, dtype)
    loglstar = _bound_threshold(like, kind, ndim, ncdim, nonbounded, arrays,
                                dtype, 0.01)
    fn = tk.make_unif_round(like, ndim=ndim, ncdim=ncdim, q=q,
                            bound_kind=kind, nonbounded=nonbounded,
                            dtype=dtype, device="cpu", max_waves=4)
    carried = 0
    for seed in range(5, 13):
        g_new, g_old = torch.Generator(), torch.Generator()
        g_new.manual_seed(seed)
        g_old.manual_seed(seed)
        log = []
        got, got_blob = fn(g_new, loglstar, arrays)
        ref, ref_blob = _old_round(like, g_old, loglstar, arrays, ndim=ndim,
                                   ncdim=ncdim, q=q, kind=kind, dtype=dtype,
                                   nonbounded=nonbounded, max_waves=4,
                                   log=log)
        assert torch.equal(got, ref) and torch.equal(got_blob, ref_blob)
        il = ndim + like.npdim
        n_filled = int(got[0, il + 4])
        assert len(log) == 4 and n_filled < q
        assert torch.all(got[n_filled:, il] == _NEG_INF)
        assert int(got[:, il + 1].sum()) == int(got[0, il + 2])
        # the last wave's evaluations went to slot 0
        carried += n_filled > 0 and log[-1][0] == 0
    assert carried


def test_the_plain_placement_equals_the_eager_wave_on_hand_made_states():
    """``unif_place_plain`` against the eager wave's arithmetic on Python
    ints: a wave with no success carries its evaluations, one with more
    successes than free slots drops the rest into row q, an ordinary one;
    ``unif_valid_plain`` against the eager lane checks."""
    q, ndim, npdim, dtype = 48, 3, 2, torch.float64
    rs = get_rstate(11)
    for n_filled, pending, above in ((5, 7, 0.0), (q - 3, 0, 0.7),
                                     (10, 2, 0.3)):
        u = torch.as_tensor(rs.random((q, ndim)))
        v = torch.as_tensor(rs.random((q, npdim)))
        logl = torch.as_tensor(np.where(rs.random(q) < above, 1.0, -1.0) +
                               rs.normal(0, 0.1, q))
        valid = torch.as_tensor(rs.random(q) < 0.8)
        width = 30
        state = torch.tensor([n_filled, 4, 100, 500, pending, width, 9])
        slots = {"u": torch.full((q + 1, ndim), 0.5, dtype=dtype),
                 "v": torch.zeros((q + 1, npdim), dtype=dtype),
                 "logl": torch.full((q + 1,), _NEG_INF, dtype=dtype),
                 "nc": torch.zeros((q + 1,), dtype=torch.int64)}
        old = {k: t.clone() for k, t in slots.items()}
        new, dest, done = pr.unif_place_plain(state, slots, valid, u, v,
                                              logl, torch.tensor(0.0))
        # the eager wave after its likelihood call
        lm = torch.where(valid, logl, _NEG_INF)
        success = valid & (lm > 0.0)
        n_succ, nc_wave = torch.stack([success.sum(), valid.sum()]).tolist()
        rank = torch.cumsum(success, 0) - 1
        d = torch.where(success & (n_filled + rank < q), n_filled + rank, q)
        old["u"][d], old["v"][d], old["logl"][d] = u, v, lm
        n_new = min(n_succ, q - n_filled)
        avail = pending + nc_wave
        share = avail // max(n_new, 1)
        old["nc"][d] = share + (rank < avail - share * max(n_new, 1)).to(
            torch.int64)
        assert torch.equal(dest, d)
        for k in slots:
            assert torch.equal(slots[k][:q], old[k][:q]), k
        f32 = np.float32
        filled, n_prop = n_filled + n_new, 500 + width
        est = np.ceil(f32(1.25) * f32(q - filled) / max(
            f32(filled) / f32(n_prop), f32(1e-6))) + f32(4.0)
        assert new.tolist() == [filled, 5, 100 + nc_wave, n_prop,
                                0 if n_new else avail,
                                int(min(est, f32(q))), 9]
        assert bool(done) == (filled >= q)
        if above == 0.0:
            assert n_succ == 0 and new[pr.U_PENDING] == pending + nc_wave
        if n_filled == q - 3:
            assert n_succ > 3 and bool(done) and (d == q).sum() > 0

    # the lane checks: width, cube (one loose dimension), the union's
    # quadratic forms and overlap test, the friends' acceptance
    uc = torch.as_tensor(rs.uniform(-0.6, 1.6, (q, ndim)))
    uc[:8] = torch.as_tensor(rs.uniform(0.3, 0.7, (8, ndim)))
    uc[0] = torch.tensor([0.55, 0.5, 0.5])
    strict = torch.tensor([True, False, True])
    ctrs = torch.as_tensor(np.array([[0.5] * 3, [0.2] * 3, [0.8] * 3,
                                     rs.uniform(0.2, 0.8, ndim)]))
    a = rs.normal(size=(4, ndim, ndim))
    ams = torch.as_tensor(np.eye(ndim) * 40.0 +
                          0.5 * (a + a.transpose(0, 2, 1)))
    # only the rescue holds lane 0: its form in slot 0 is 1.0005
    d0 = (uc[0] - ctrs[0]).numpy()
    ams[0] = torch.as_tensor(np.eye(ndim) * 1.0005 / (d0 @ d0))
    mask = torch.tensor([True, True, True, False])
    ua = torch.as_tensor(rs.random(q))
    ua[0] = 0.0
    acc = torch.as_tensor(rs.random(q) < 0.5)
    acc[0] = True
    got = pr.unif_valid_plain(uc, torch.tensor(40), strict, ctrs, ams, mask,
                              ua, acc)
    # the forms one product at a time, in the kernel's order
    sq = torch.empty((q, 4), dtype=dtype)
    for k in range(q):
        for j in range(4):
            d = [float(uc[k, i] - ctrs[j, i]) for i in range(ndim)]
            f = None
            for i in range(ndim):
                t = None
                for l in range(ndim):
                    p = float(ams[j, i, l]) * d[l]
                    t = p if t is None else t + p
                f = d[i] * t if f is None else f + d[i] * t
            sq[k, j] = f
    assert torch.equal(pr.ellipsoid_forms_plain(uc, ctrs, ams), sq)
    assert 1.0 < float(sq[0, 0]) <= 1.0 + 1e-3
    assert not bool((sq[0, :3] < 1.0).any())
    sqm = torch.where(mask[None, :], sq, math.inf)
    nin = (sqm < 1.0).sum(1)
    nin = torch.where(nin > 0, nin, (sqm <= 1.0 + 1e-3).sum(1))
    ref = (torch.arange(q) < 40) & unitcheck_batch(uc, strict) & \
        (ua < 1.0 / nin.clamp_min(1).to(dtype)) & (nin > 0) & acc
    assert torch.equal(got, ref) and 0 < int(ref.sum()) < 40
    assert bool(got[0])


@pytest.mark.parametrize("situation", ["gated", "all_fail", "overflow"])
def test_the_placement_on_edge_waves_through_the_round_buffers(situation):
    """On the CPU ``unif_valid`` and ``unif_place`` on a ``UnifRound``
    (their plain versions) in the card tests' edge waves: a gated wave
    launches no lane and only counts the wave, a wave with no success
    carries its evaluations, an overflow fills the two free slots and
    drops the rest into row q."""
    q = 48
    rb, inp = _kernel_inputs("cube", q, 4, 3, torch.float64, "cpu")
    _edge_wave(rb, inp, situation)
    st0 = rb.state.clone()
    pr.unif_valid(rb, inp["uc"], u_ex=inp["u_ex"])
    pr.unif_place(rb, inp["u_prop"], inp["v"], inp["logl"])
    n_valid = int(rb.valid.sum())
    filled, waves, nc, n_prop, pending, width, cap = st0.tolist()
    new = rb.state.tolist()
    assert new[pr.U_WAVES] == waves + 1 and new[pr.U_NC] == nc + n_valid
    assert new[pr.U_PROP] == n_prop + width
    if situation == "overflow":
        assert new[pr.U_FILLED] == q and bool(rb.done)
        assert int((rb.dest < q).sum()) == 2 < n_valid
        assert new[pr.U_PENDING] == 0
    else:
        assert (n_valid == 0) == (situation == "gated")
        assert new[pr.U_FILLED] == filled and not bool(rb.done)
        assert new[pr.U_PENDING] == pending + n_valid
        assert bool((rb.dest == q).all())


def _numpy_width(q, n_filled, n_prop):
    """The width as the host computed it before its kernel."""
    f32 = np.float32
    if n_filled > 0 and n_prop > 0:
        need = f32(q - n_filled)
        eff = f32(n_filled) / max(f32(n_prop), f32(1.0))
        est = np.ceil(f32(1.25) * need / max(eff, f32(1e-6))) + f32(4.0)
        return int(min(est, f32(q)))
    return q


def test_the_width_formula_equals_the_hosts_float32():
    """On a grid of fills and launched lanes, counts past 2**24 (where
    float32 rounds them) among them."""
    props = [0, 1, 2, 3, 7, 31, 100, 255, 256, 1000, 4097, 65537, 999983,
             2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1, 2 ** 24 + 3, 2 ** 25 + 5,
             30_000_001, 123_456_789, 2 ** 31 + 11]
    for q in (1, 7, 32, 256, 1000):
        filled = sorted({0, 1, 2, q // 3, q // 2, q - 1, q})
        grid = [(f, p) for f in filled for p in props]
        f = torch.tensor([g[0] for g in grid])
        p = torch.tensor([g[1] for g in grid])
        got = pr.unif_width_plain(q, f, p).tolist()
        assert got == [_numpy_width(q, a, b) for a, b in grid], q


# --------------------------------------------------------------------------
# the round-shape cache


def test_the_sampler_keeps_one_entry_per_wave_shape():
    """A second round of a shape reuses its entry, another width, bound
    or padded ellipsoid count adds one; pickling and a move to another
    device drop them; each round's result is the caller's own."""
    ndim, dtype = 3, torch.float64
    sampler = UniformBoundSampler(ndim=ndim)
    cache = sampler._slice_cache()
    like = _like(ndim, dtype)
    arrays = _arrays("ellipsoids", ndim, dtype)
    kw = dict(ndim=ndim, dtype=dtype, device="cpu", rounds=cache)
    outs = []
    for q, kind in ((16, "ellipsoids"), (16, "ellipsoids"), (8, "cube"),
                    (16, "cube")):
        gen = torch.Generator()
        gen.manual_seed(len(outs))
        outs.append(tk.make_unif_round(like, q=q, bound_kind=kind, **kw)(
            gen, -20.0, arrays))
    two = bound_arrays_to_torch("ellipsoids", MultiEllipsoid(
        ndim, ctrs=np.full((2, ndim), 0.5),
        covs=np.array([np.eye(ndim) * 0.01] * 2)).device_spec()[1], "cpu")
    assert two["mask"].all()
    tk.make_unif_round(like, q=16, bound_kind="ellipsoids", **kw)(
        torch.Generator(), -20.0, two)
    assert len(cache) == 4 and all(k[0] == "unif" for k in cache)
    assert sorted(e.rb.m for e in cache.values()) == [0, 0, 2, 4]
    assert all(isinstance(e, tk.UnifGraph) for e in cache.values())
    # the results are copies: the later rounds left the first as it was
    p0, b0 = outs[0]
    entry = next(e for e in cache.values() if e.rb.q == 16 and e.rb.m == 4)
    assert p0.untyped_storage().data_ptr() != \
        entry.rb.slots["u"].untyped_storage().data_ptr()
    assert b0.untyped_storage().data_ptr() != \
        entry.blob.untyped_storage().data_ptr()
    assert not torch.equal(outs[0][0], outs[1][0])
    clone = pickle.loads(pickle.dumps(sampler))
    assert clone._slice_rounds == {} and len(sampler._slice_rounds) == 4
    sampler.drop_device_state()
    assert sampler._slice_rounds == {}


def test_round_buffers_refuse_what_no_kernel_takes():
    with pytest.raises(ValueError, match="bad shape"):
        pr.UnifRound(8, 3, 4, 1, torch.float64, "cpu")
    with pytest.raises(TypeError, match="float64 or float32"):
        pr.UnifRound(8, 3, 3, 1, torch.float16, "cpu")
    with pytest.raises(ValueError, match="must have shape"):
        pr.UnifRound(8, 3, 3, 1, torch.float64, "cpu",
                     strict=torch.ones(4, dtype=torch.bool))
    layout = {"mask": ((4,), (1,), 0, torch.bool)}
    rb = pr.UnifRound(8, 3, 3, 1, torch.float64, "cpu",
                      arrays_layout=layout)
    uc = torch.zeros((8, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="exactly over a union"):
        rb.check_draws(uc, None, None, None)
    with pytest.raises(TypeError, match="must be torch.float64"):
        rb.check_draws(uc, torch.zeros(8, dtype=torch.float32), None, None)
    with pytest.raises(ValueError, match="exactly where ncdim < ndim"):
        rb.check_draws(uc, torch.zeros(8, dtype=torch.float64), None,
                       torch.zeros((8, 1), dtype=torch.float64))
    wide = pr.UnifRound(8, 4, 3, 1, torch.float64, "cpu")
    with pytest.raises(ValueError, match="exactly where ncdim < ndim"):
        wide.check_draws(uc, None, None, None)
    with pytest.raises(ValueError, match="must have shape"):
        wide.check_draws(uc, None, None,
                         torch.zeros((8, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        rb.check_likelihood(torch.zeros((8, 1), dtype=torch.float64),
                            torch.zeros((8, 2), dtype=torch.float64)[:, 0])


def test_a_sampler_run_waves_on_its_round_cache():
    """A static run over the ellipsoids on the CPU: its unit-cube phase
    and its bound's waves fill the two samplers' caches, and count
    nothing of the card's."""
    import dynesty_tpu_torch as dyt
    s = dyt.NestedSampler(lambda x: -0.5 * (x @ x),
                          lambda u: 10.0 * (2.0 * u - 1.0), 3, nlive=60,
                          bound="multi", sample="unif", queue_size=16,
                          device="cpu", rstate=get_rstate())
    s.run_nested(print_progress=False, maxiter=600)
    for sampler in (s.internal_sampler, s.internal_sampler_next):
        waves = [k for k in sampler._slice_rounds if k[0] != "round"]
        assert waves and all(k[0] == "unif" and k[2] == 16 for k in waves)
        # beside the waves' shapes, the fused rounds' state ("round")
        assert [k[:2] for k in sampler._slice_rounds if k[0] == "round"] \
            == [("round", sampler.name)]
    assert not any(k in s.timings for k in ("n_unif_replay", "n_unif_graph",
                                            "n_uncaptured"))


# --------------------------------------------------------------------------
# against the JAX package


def _stub_logl(u):
    """The stub likelihood's ``(v, logl)`` of a numpy or torch batch."""
    v = 10.0 * (2.0 * u - 1.0)
    return v, -0.5 * (v * v).sum(1)


class _TorchStub:
    npdim = 3

    def batch_eval(self, u, mask=None):
        return _stub_logl(u) + (None,)


def _block_sampler(seed, q, ncdim, calls):
    rs = np.random.Generator(np.random.PCG64(seed))

    def draw():
        calls.append(1)
        return rs.uniform(-0.05, 1.05, (q, ncdim))

    return draw


def test_custom_round_equals_the_jax_packages(jx):
    """The same host draws (seeded numpy blocks, some outside the cube)
    and the same likelihood through the JAX package's round and the
    port's, over rounds of three or more waves."""
    jax, jnp, jk = jx
    q, ndim = 32, 3

    class JaxStub:
        npdim, blob, blob_shape_dtype = ndim, False, None

        def batch_eval(self, u, mask=None):
            v = 10.0 * (2.0 * u - 1.0)
            return v, -0.5 * jnp.sum(v * v, axis=1), None

    jcalls, tcalls = [], []
    jfn = jk.make_unif_round(JaxStub(), ndim=ndim, ncdim=ndim, q=q,
                             bound_kind="custom", dtype=jnp.float64,
                             host_sampler=_block_sampler(9, q, ndim, jcalls))
    tfn = tk.make_unif_round(_TorchStub(), ndim=ndim, q=q,
                             bound_kind="custom", dtype=torch.float64,
                             device="cpu",
                             host_sampler=_block_sampler(9, q, ndim, tcalls))
    thresholds = (-20.0, -30.0, -12.0)
    il = 2 * ndim
    for loglstar in thresholds:
        n0 = len(tcalls)
        jp, _ = jax.device_get(jfn(jax.random.key(0), loglstar, {}))
        tp, _ = tfn(torch.Generator(), loglstar, {})
        tp, jp = tp.numpy(), np.asarray(jp)
        assert len(tcalls) - n0 >= 3 and len(jcalls) == len(tcalls)
        assert int(tp[0, il + 4]) == q
        np.testing.assert_array_equal(tp[:, :ndim], jp[:, :ndim])
        np.testing.assert_array_equal(tp[:, il + 1:], jp[:, il + 1:])
        np.testing.assert_allclose(tp[:, ndim:il + 1], jp[:, ndim:il + 1],
                                   rtol=1e-12, atol=0)
    # no candidate lies within 1e-9 of its round's threshold
    rs = np.random.Generator(np.random.PCG64(9))
    blocks = [rs.uniform(-0.05, 1.05, (q, ndim)) for _ in tcalls]
    logl = np.concatenate([_stub_logl(b)[1] for b in blocks])
    assert min(np.abs(logl - t).min() for t in thresholds) > 1e-9


def _union_arrays(ncdim, n_ell, seed):
    """A union of ``n_ell`` ellipsoids in ``ncdim`` dimensions inside the
    cube, overlapping, padded to a power of two (numpy, float64)."""
    rs = get_rstate(seed)
    ctrs = 0.5 + rs.uniform(-1.0, 1.0, (n_ell, ncdim)) * 0.06 / ncdim
    covs = []
    for _ in range(n_ell):
        a = rs.normal(size=(ncdim, ncdim))
        w, vec = np.linalg.eigh(np.eye(ncdim) + 0.2 * (a + a.T) / ncdim)
        covs.append((vec * np.abs(w)) @ vec.T * 0.1 ** 2 / ncdim)
    mb = MultiEllipsoid(ncdim, ctrs=ctrs, covs=np.array(covs))
    return bound_arrays_to_torch("ellipsoids", mb.device_spec()[1], "cpu")


@pytest.mark.parametrize("ncdim", [2, 3, 15])
@pytest.mark.parametrize("n_ell", [1, 4, 9])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_ellipsoid_acceptance_equals_the_jax_packages(jx, ncdim, n_ell,
                                                          dtype):
    """``unif_valid_plain`` on the JAX package's own draws (its points,
    the arrays, its acceptance uniforms from the key it splits), the
    quadratic forms computed in the kernel's order, gives its
    ``_sample_ellipsoid_union``'s ``valid`` (its einsum sums in another
    order: the draws keep every form 1e-9 (float64) or 2e-5 (float32)
    away from both thresholds, and the comparison takes the lanes so far
    away only, at least 99 % of them); every point lies in the cube, so
    the lane checks add nothing."""
    jax, jnp, jk = jx
    q = 2000
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    arrays = _union_arrays(ncdim, n_ell, 4 + ncdim + n_ell)
    assert arrays["mask"].shape[0] == 1 << (n_ell - 1).bit_length()
    jarrays = {k: jnp.asarray(v.numpy()) for k, v in arrays.items()}
    key = jax.random.key(4)
    x, valid = jk._sample_ellipsoid_union(key, jarrays, q, ncdim, jdt)
    _, _, ka = jax.random.split(key, 3)
    ua = torch.as_tensor(np.array(jax.random.uniform(ka, (q,), dtype=jdt)))
    x = torch.as_tensor(np.array(x))
    assert x.dtype == ua.dtype == dtype
    ctrs, ams = arrays["ctrs"].to(dtype), arrays["ams"].to(dtype)
    assert bool(unitcheck_batch(x).all())
    got = pr.unif_valid_plain(x, torch.tensor(q), None, ctrs, ams,
                              arrays["mask"], ua)
    sq = pr.ellipsoid_forms_plain(x, ctrs, ams).double()
    margin = 1e-9 if dtype == torch.float64 else 2e-5
    loose = float(torch.tensor(1.0 + 1e-3, dtype=dtype))
    far = (((sq - 1.0).abs() > margin) & ((sq - loose).abs() > margin) |
           ~arrays["mask"][None, :]).all(1)
    assert int(far.sum()) >= 0.99 * q
    ref = torch.as_tensor(np.asarray(valid))
    assert torch.equal(got[far], ref[far])
    assert 0 < int(got.sum()) <= q and (int(got.sum()) == q) == (n_ell == 1)


def test_the_forms_count_as_the_einsum_did_away_from_the_thresholds():
    """The lane checks on the forms in the kernel's order against the
    same checks on the einsum's forms (the union's products before the
    kernel took them in): the same count, and the same ``valid``, on every
    lane whose forms all lie farther than 1e-12 (float64) or 1e-4
    (float32) from 1 and from 1 + 1e-3; the two orders' forms differ by a
    few ulps at most."""
    q = 4096
    for ncdim, n_ell, dtype in ((2, 4, torch.float64), (3, 9, torch.float64),
                                (15, 4, torch.float64),
                                (3, 9, torch.float32)):
        arrays = _union_arrays(ncdim, n_ell, 21 + ncdim)
        gen = torch.Generator()
        gen.manual_seed(ncdim)
        x, ua = tk._sample_ellipsoid_union(gen, arrays, q, ncdim, dtype)
        ctrs, ams = arrays["ctrs"].to(dtype), arrays["ams"].to(dtype)
        mask = arrays["mask"]
        d = x[:, None, :] - ctrs[None, :, :]
        old = torch.einsum("qmi,mij,qmj->qm", d, ams, d)
        new = pr.ellipsoid_forms_plain(x, ctrs, ams)
        eps = torch.finfo(dtype).eps
        assert bool(((new - old).abs() <= 64 * eps * old.abs()).all())
        margin = 1e-12 if dtype == torch.float64 else 1e-4
        loose = float(torch.tensor(1.0 + 1e-3, dtype=dtype))
        far = (((new - 1.0).abs() > margin) &
               ((new - loose).abs() > margin) | ~mask[None, :]).all(1)
        assert int(far.sum()) > 0.99 * q

        def count(sq):
            sq = torch.where(mask[None, :], sq, math.inf)
            nin = (sq < 1.0).sum(1)
            return torch.where(nin > 0, nin, (sq <= 1.0 + 1e-3).sum(1))

        assert torch.equal(count(new)[far], count(old)[far])
        assert int((count(new) > 1).sum()) > 0
        got = pr.unif_valid_plain(x, torch.tensor(q), None, ctrs, ams, mask,
                                  ua)
        nin = count(old)
        ref = (ua < 1.0 / nin.clamp_min(1).to(dtype)) & (nin > 0) & \
            unitcheck_batch(x)
        assert torch.equal(got[far], ref[far])


def _threshold_round(q, ndim, dtype, device):
    """A round over a union of six ellipsoids (padded to eight slots, the
    two masked ones holding every lane) and one wave's draws whose forms
    lie exactly at the thresholds: lane k (k % 8 < 6) has the form
    ``TARGETS[k % 8]`` in slot k % 8 (the largest float below 1, 1, the
    smallest above 1, the same about 1 + 1e-3 in the round's dtype) and
    forms above 4 in the other valid slots, and ua 0; the other lanes
    are random, and the other dimensions' uniforms (ndim > 3) hold NaN,
    values outside the cube and edges, as does one candidate (NaN)."""
    rs = get_rstate(q + ndim)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    one = torch.tensor(1.0, dtype=dtype)
    loose = torch.tensor(1.0 + 1e-3, dtype=dtype)
    targets = torch.stack([torch.nextafter(one, -one), one,
                           torch.nextafter(one, 2 * one),
                           torch.nextafter(loose, -one), loose,
                           torch.nextafter(loose, 2 * one)])
    m, ncdim = 8, 3
    ctrs = np.full((m, ncdim), 0.5)
    ctrs[:6, 0] = 0.25
    ctrs[:6, 1] = 0.1 + 0.1 * np.arange(6)
    ams = np.zeros((m, ncdim, ncdim))
    ams[:6] = np.diag([0.0, 400.0, 400.0])
    ams[:6, 0, 0] = 4.0 * targets.double().numpy()  # 4 * target: exact
    ams[6:] = 1e-6 * np.eye(ncdim)
    arrays = {"ctrs": t(ctrs), "ams": t(ams), "axes": t(ams),
              "logvols": t(np.zeros(m)),
              "mask": t(np.arange(m) < 6, torch.bool)}
    layout = {k: (tuple(arrays[k].shape), arrays[k].stride(),
                  arrays[k].storage_offset(), arrays[k].dtype)
              for k in pr.UNIF_ARRAYS["ellipsoids"]}
    rb = pr.UnifRound(q, ndim, ncdim, ndim, dtype, device, None, layout)
    rb.start(0.0, arrays, 9)
    lane = np.arange(q)
    at = lane % 8 < 6
    uc = rs.uniform(0.05, 0.95, (q, ncdim))
    uc[at, 0] = 0.75  # d = (0.5, 0, 0): the form is exactly its target
    uc[at, 1] = ctrs[lane[at] % 8, 1]
    uc[at, 2] = 0.5
    ua = rs.random(q)
    ua[at] = 0.0
    if q > 7:
        uc[7, 1] = np.nan
    u_ex = None
    if ndim > ncdim:
        u_ex = rs.choice([np.nan, -0.25, 0.0, 0.3, 1.0, 1.75],
                         size=(q, ndim - ncdim))
        u_ex = t(u_ex)
    inp = {"uc": t(uc), "ua": t(ua), "u_ex": u_ex}
    # the target lanes: valid where the form is < 1, or (none being) at
    # most 1 + 1e-3
    expect = t([True, True, True, True, True, False], torch.bool)
    return rb, inp, targets, expect


def _same_values(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [3, 5])
def test_the_lane_checks_at_the_thresholds_and_the_likelihoods_input(
        dtype, ndim):
    """Through the round on the CPU (the plain versions): forms exactly at
    1 and at 1 + 1e-3 and at their neighbouring floats count as the eager
    checks said (the neighbour above the loose threshold alone fails),
    the masked slots count for nothing, and the likelihood's input is
    ``torch.cat(...).clamp(0, 1)`` of the draws, NaN included."""
    q = 64
    rb, inp, targets, expect = _threshold_round(q, ndim, dtype, "cpu")
    sq = pr.ellipsoid_forms_plain(inp["uc"], rb.arrays["ctrs"],
                                  rb.arrays["ams"])
    lane = torch.arange(q)
    at = lane % 8 < 6
    assert torch.equal(sq[at, lane[at] % 8], targets[lane[at] % 8])
    pr.unif_valid(rb, inp["uc"], inp["ua"], None, inp["u_ex"])
    assert torch.equal(rb.valid[at], expect[lane[at] % 8])
    u_prop = inp["uc"] if inp["u_ex"] is None else \
        torch.cat([inp["uc"], inp["u_ex"]], dim=1)
    assert _same_values(rb.u_prop, u_prop)
    assert _same_values(rb.uclamp, u_prop.clamp(0.0, 1.0))
    assert bool(rb.uclamp.isnan().any())
    assert not bool(rb.valid[7])


# --------------------------------------------------------------------------
# on the card


class _EagerLike(LogLikelihood):
    """A likelihood the rule keeps out of a graph: its waves launch both
    kernels eagerly."""

    def capturable(self):
        return False


def _card_rounds(like, kind, ndim, ncdim, nonbounded, q, dtype, device,
                 seeds, cache, timings, share=0.1):
    arrays = _arrays(kind, ncdim, dtype, device)
    fn = tk.make_unif_round(like, ndim=ndim, ncdim=ncdim, q=q,
                            bound_kind=kind, nonbounded=nonbounded,
                            dtype=dtype, device=device, timings=timings,
                            rounds=cache)
    loglstar = _threshold(like, share)
    outs = []
    for seed in seeds:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        packed, blob = fn(gen, loglstar, arrays)
        torch.cuda.synchronize()
        outs.append((packed, blob, gen.get_offset()))
    return outs


def _kernel_inputs(kind, q, ndim, ncdim, dtype, device, seed=2):
    """A round on the card with a hand-made state, and one wave's inputs:
    candidates in and out of the cube (over ellipsoids half of them about
    the centres), the other dimensions' uniforms (NaN and values outside
    the cube among them), a likelihood above and below the threshold."""
    rs = get_rstate(seed)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    arrays = _arrays(kind, ncdim, dtype, device)
    layout = {k: (tuple(arrays[k].shape), arrays[k].stride(),
                  arrays[k].storage_offset(), arrays[k].dtype)
              for k in pr.UNIF_ARRAYS[kind]}
    strict = torch.tensor([True, False, True][:ncdim])
    friends = kind if kind in ("balls", "cubes") else None
    rb = pr.UnifRound(q, ndim, ncdim, ndim, dtype, device, strict, layout,
                      friends)
    rb.start(0.0, arrays, 9)
    rb.state.copy_(torch.tensor([q // 3, 2, 50, 3 * q, 5, q - 7, 9]))
    m = rb.m
    uc = rs.uniform(-0.6, 1.6, (q, ncdim))
    if m:
        near = np.arange(q) % 2 == 0
        uc[near] = arrays["ctrs"].cpu().numpy()[np.arange(q)[near] % 3] + \
            rs.normal(0.0, 0.08, (int(near.sum()), ncdim))
    if friends:
        # the friends' draws: offsets in and about the unit ball or cube
        uc = rs.uniform(-1.2, 1.2, (q, ncdim))
    inp = {"uc": t(uc), "ua": t(rs.random(q)) if m or friends else None,
           "idx": t(rs.integers(0, rb.nctrs, q), torch.int64)
           if friends else None,
           "u_ex": t(rs.choice([np.nan, -0.2, 0.4, 1.0, 1.3],
                               size=(q, ndim - ncdim)))
           if ndim > ncdim else None,
           "u_prop": t(rs.random((q, ndim))), "v": t(rs.random((q, ndim))),
           "logl": t(rs.normal(size=q))}
    return rb, inp


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cube", "ellipsoids", "balls"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("q", [32, 256, 700])
def test_the_kernels_equal_the_plain_versions_on_the_card(cuda, kind, dtype,
                                                          q):
    ndim, ncdim = 4, 3
    rb, inp = _kernel_inputs(kind, q, ndim, ncdim, dtype, cuda)
    draws = (inp["uc"], inp["ua"], inp["idx"], inp["u_ex"])
    ref, u_prop, uclamp = pr.unif_valid_round_plain(rb, *draws)
    pr.unif_valid(rb, *draws)
    torch.cuda.synchronize()
    assert torch.equal(rb.valid, ref) and 0 < int(ref.sum()) < q
    assert _same_values(rb.u_prop, u_prop)
    assert _same_values(rb.uclamp, uclamp)
    slots = {k: t.clone() for k, t in rb.slots.items()}
    state, dest, done = pr.unif_place_plain(rb.state.clone(), slots,
                                            rb.valid, inp["u_prop"],
                                            inp["v"], inp["logl"],
                                            rb.loglstar)
    pr.unif_place(rb, inp["u_prop"], inp["v"], inp["logl"])
    torch.cuda.synchronize()
    assert torch.equal(rb.state, state) and torch.equal(rb.dest, dest)
    assert torch.equal(rb.done, done)
    for k in slots:
        assert torch.equal(rb.slots[k][:q], slots[k][:q]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [3, 5])
@pytest.mark.parametrize("q", [1, 256, 700, 1500])
def test_the_lane_checks_at_the_thresholds_on_the_card(cuda, dtype, ndim,
                                                       q):
    """The kernel against its plain version on forms exactly at 1 and at
    1 + 1e-3 and at their neighbouring floats, the likelihood's input
    with NaN and values outside the cube among the draws: every output
    bit for bit, the target lanes as the eager checks said."""
    rb, inp, targets, expect = _threshold_round(q, ndim, dtype, cuda)
    forms = [rb.arrays[k] for k in pr.UNIF_FORMS]
    ref = pr.unif_valid_plain(inp["uc"], rb.state[pr.U_WIDTH], None,
                              *forms, inp["ua"])
    u_prop, uclamp = pr.unif_input_plain(inp["uc"], inp["u_ex"])
    pr.unif_valid(rb, inp["uc"], inp["ua"], None, inp["u_ex"])
    torch.cuda.synchronize()
    assert torch.equal(rb.valid, ref)
    lane = torch.arange(q, device=cuda)
    at = lane % 8 < 6
    assert torch.equal(rb.valid[at], expect[lane[at] % 8])
    assert _same_values(rb.u_prop, u_prop)
    assert _same_values(rb.uclamp, uclamp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ncdim", [2, 8, 15])
@pytest.mark.parametrize("n_ell", [1, 4, 9, 40])
def test_the_union_forms_equal_the_plain_version_on_the_card(cuda, dtype,
                                                            ncdim, n_ell):
    """``unif_valid`` over unions of 1, 4, 9 and 40 ellipsoids (padded
    to 1, 4, 16 and 64 slots: one thread a lane up to a warp of them, and
    a warp looping over the slots past 32), in 2 and 8 dimensions (the
    row in registers) and 15 (read from memory), against its plain
    version bit for bit, the likelihood's input with a fourth of the
    dimensions outside the bound."""
    q = 700
    rs = get_rstate(ncdim + n_ell)
    arrays = {k: v.to(cuda) for k, v in
              _union_arrays(ncdim, n_ell, 5 + ncdim).items()}
    layout = {k: (tuple(arrays[k].shape), arrays[k].stride(),
                  arrays[k].storage_offset(), arrays[k].dtype)
              for k in pr.UNIF_ARRAYS["ellipsoids"]}
    ndim = ncdim + max(1, ncdim // 4)
    rb = pr.UnifRound(q, ndim, ncdim, ndim, dtype, cuda, None, layout)
    rb.start(0.0, arrays, 9)
    ctrs = arrays["ctrs"].cpu().numpy()
    uc = ctrs[np.arange(q) % n_ell] + rs.normal(0.0, 0.1 / ncdim,
                                                (q, ncdim))
    inp = {"uc": torch.as_tensor(uc, dtype=dtype, device=cuda),
           "ua": torch.as_tensor(rs.random(q), dtype=dtype, device=cuda),
           "u_ex": torch.as_tensor(rs.random((q, ndim - ncdim)),
                                   dtype=dtype, device=cuda)}
    forms = [rb.arrays[k] for k in pr.UNIF_FORMS]
    ref = pr.unif_valid_plain(inp["uc"], rb.state[pr.U_WIDTH], None,
                              *forms, inp["ua"])
    u_prop, uclamp = pr.unif_input_plain(inp["uc"], inp["u_ex"])
    pr.unif_valid(rb, inp["uc"], inp["ua"], None, inp["u_ex"])
    torch.cuda.synchronize()
    assert torch.equal(rb.valid, ref) and 0 < int(ref.sum()) <= q
    assert _same_values(rb.u_prop, u_prop)
    assert _same_values(rb.uclamp, uclamp)


def _edge_wave(rb, inp, situation):
    """Turn a hand-made wave into an edge case: 'gated' (width 0: no lane
    launched), 'all_fail' (no candidate above the threshold) or
    'overflow' (more successes than the two free slots)."""
    q = rb.q
    if situation == "gated":
        rb.state[pr.U_WIDTH] = 0
    elif situation == "all_fail":
        inp["logl"] = -1.0 - inp["logl"].abs()
    else:
        rb.state[pr.U_FILLED] = q - 2
        inp["logl"] = 1.0 + inp["logl"].abs()


@pytest.mark.cuda
@pytest.mark.parametrize("situation", ["gated", "all_fail", "overflow"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("q", [32, 256, 700])
def test_the_placement_equals_its_plain_version_on_edge_waves_on_the_card(
        cuda, situation, dtype, q):
    rb, inp = _kernel_inputs("cube", q, 4, 3, dtype, cuda)
    _edge_wave(rb, inp, situation)
    pr.unif_valid(rb, inp["uc"], None, None, inp["u_ex"])
    torch.cuda.synchronize()
    n_valid = int(rb.valid.sum())
    assert (n_valid == 0) == (situation == "gated")
    st0 = rb.state.clone()
    slots = {k: t.clone() for k, t in rb.slots.items()}
    state, dest, done = pr.unif_place_plain(st0.clone(), slots, rb.valid,
                                            inp["u_prop"], inp["v"],
                                            inp["logl"], rb.loglstar)
    pr.unif_place(rb, inp["u_prop"], inp["v"], inp["logl"])
    torch.cuda.synchronize()
    assert torch.equal(rb.state, state) and torch.equal(rb.dest, dest)
    assert torch.equal(rb.done, done)
    for k in slots:
        assert torch.equal(rb.slots[k][:q], slots[k][:q]), k
    placed = int(state[pr.U_FILLED] - st0[pr.U_FILLED])
    assert placed == {"gated": 0, "all_fail": 0, "overflow": 2}[situation]
    if situation != "overflow":
        assert int(state[pr.U_PENDING]) == int(st0[pr.U_PENDING]) + n_valid
    else:
        assert bool(done) and int((dest < q).sum()) == 2 < n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("kind,ndim,ncdim,nonbounded", KINDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_waves_equal_the_eager_waves_on_the_card(cuda, kind, ndim,
                                                          ncdim, nonbounded,
                                                          dtype):
    q, seeds = 256, (11, 12, 13)
    args = (kind, ndim, ncdim, nonbounded, q, dtype, cuda, seeds)
    t_g, t_e = Timings(), Timings()
    pr.zero_counts()
    got = _card_rounds(_like(ndim, dtype, cuda), *args, {}, t_g)
    assert pr.unif_valid.launches == pr.unif_place.launches == \
        t_g["sync_wave"]
    ref = _card_rounds(_like(ndim, dtype, cuda, _EagerLike), *args, {}, t_e)
    for (p, b, off), (pe, be, offe) in zip(got, ref):
        assert torch.equal(p, pe) and torch.equal(b, be) and off == offe
    waves = t_e["sync_wave"]
    assert t_g["sync_wave"] == waves > len(seeds)
    # the first wave warms up eagerly, the second captures, every later
    # one replays
    assert t_g["n_unif_graph"] == 1 and t_g["n_uncaptured"] == 1
    assert t_g["n_unif_replay"] == waves - 1
    assert t_e["n_uncaptured"] == waves and "n_unif_replay" not in t_e


def _syncing_ll(x):
    # a host read inside the likelihood: legal eagerly, not in a capture
    return -0.5 * (x * x).sum(-1) + 0.0 * float(x.sum().item() > 1e300)


@pytest.mark.cuda
def test_a_capture_that_raises_warns_once_and_runs_eagerly(cuda):
    dtype, q, seeds = torch.float64, 64, (1, 2, 3)
    like = _like(3, dtype, cuda, fn=_syncing_ll, blob=False,
                 mode="vectorized")
    eager = _like(3, dtype, cuda, _EagerLike, fn=_syncing_ll, blob=False,
                  mode="vectorized")
    t, te = Timings(), Timings()
    pr.zero_counts()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _card_rounds(like, "cube", 3, 3, None, q, dtype, cuda, seeds,
                           {}, t)
    msgs = [str(x.message) for x in w if "CUDA graph" in str(x.message)]
    assert len(msgs) == 1
    assert t["n_uncaptured"] == t["sync_wave"] and "n_unif_replay" not in t
    assert pr.unif_valid.launches == pr.unif_place.launches == \
        t["sync_wave"]
    ref = _card_rounds(eager, "cube", 3, 3, None, q, dtype, cuda, seeds, {},
                       te)
    for (p, _, off), (pe, _, offe) in zip(got, ref):
        assert torch.equal(p, pe) and off == offe


@pytest.mark.cuda
def test_a_card_run_never_takes_the_plain_versions(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(pr, "unif_valid_plain", refuse)
    monkeypatch.setattr(pr, "friends_union_plain", refuse)
    monkeypatch.setattr(pr, "unif_place_plain", refuse)
    pr.zero_counts()
    t = Timings()
    for kind, ndim, ncdim, nonbounded in KINDS:
        _card_rounds(_like(ndim, torch.float64, cuda), kind, ndim, ncdim,
                     nonbounded, 64, torch.float64, cuda, (1, 2), {}, t)
    assert pr.unif_valid.launches == pr.unif_place.launches == \
        t["sync_wave"] > 8
