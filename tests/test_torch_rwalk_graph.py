"""The random walk's round buffers and its captured walk
(``dynesty_tpu_torch/internal/kernels.py``, ``RWalkGraph``;
``dynesty_tpu_torch/ops/proposals.py``, ``RWalkRound``).

On the CPU: the plain steps with the clamp and the mask folded in against
the step they replace (the loop's ``_masked_eval`` around the steps as
they were), whole rounds through the round buffers against that eager
loop, the caller's ownership of what a round returns, and the round-shape
cache a sampler keeps.  On a card (``cuda``-marked, skipped here):
captured rounds against eager-launched rounds, the replay counts, the
narrow width's own graph and a capture that raises.

Every comparison is bit for bit: the folded clamp and mask are exact
operations, the draws the same Philox or Mersenne stream, and a replay
launches the kernels the eager loop launches on the same inputs.

On the card (``tests/conftest.py`` sets JAX up, which these tests do not
use):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_rwalk_graph.py
"""

import math
import pickle
import warnings

import numpy as np
import pytest
import torch

import dynesty_tpu_torch.internal.kernels as tk
from dynesty_tpu_torch.internal.likelihood import LogLikelihood
from dynesty_tpu_torch.internal.samplers import RWalkSampler
from dynesty_tpu_torch.ops import proposals as pr
from dynesty_tpu_torch.ops.geometry import (randsphere_batch,
                                            unitcheck_batch, wrap_boundaries)
from dynesty_tpu_torch.utils.misc import Timings, blob_where

from utils import get_rstate

torch.set_num_threads(1)

_NEG_INF = -math.inf
WALKS = 12
SHAPES = [(3, 3), (15, 15), (15, 12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _masks(ndim, on):
    """Periodic, reflective and nonbounded masks as a sampler gives them
    (indices, indices, bools): the first dimension wrapped, the second
    reflected, past 3 dimensions the last wrapped and reflected both,
    every third loose; or none."""
    if not on:
        return {"periodic": None, "reflective": None, "nonbounded": None}
    last = [ndim - 1] if ndim > 3 else []
    return {"periodic": [0] + last, "reflective": [1] + last,
            "nonbounded": list(np.arange(ndim) % 3 != 2)}


def _mask_tensors(ndim, on):
    m = _masks(ndim, on)
    return (tk._mask_from_indices(m["periodic"], ndim),
            tk._mask_from_indices(m["reflective"], ndim),
            tk._bool_mask(m["nonbounded"], "cpu"))


# --------------------------------------------------------------------------
# the eager walk as it was: _masked_eval around the two steps


def _old_masked_eval(like, u, incube):
    v, logl, blob = like.batch_eval(u.clamp(0.0, 1.0), mask=incube)
    logl = torch.where(incube, logl, _NEG_INF).to(u.dtype)
    return v.to(u.dtype), logl, blob


def _old_propose(st, du, scale, u_ex, periodic, reflective, nonbounded):
    u_prop = st["u"][:, :du.shape[1]] + du * scale
    if u_ex is not None:
        u_prop = torch.cat([u_prop, u_ex], dim=1)
    u_prop = wrap_boundaries(u_prop, periodic, reflective)
    return u_prop, unitcheck_batch(u_prop, nonbounded)


def _old_accept(st, u_prop, ok, v_prop, logl_prop, loglstar):
    accept = ok & (logl_prop > loglstar)
    st["u"] = torch.where(accept[:, None], u_prop, st["u"])
    st["v"] = torch.where(accept[:, None], v_prop, st["v"])
    st["logl"] = torch.where(accept, logl_prop, st["logl"])
    st["n_acc"] = st["n_acc"] + accept
    st["n_rej"] = st["n_rej"] + ~accept
    return accept


def _old_round(like, packed, start_blob, gen, scale, loglstar, ndim, ncdim,
               walks, masks, dtype):
    """A whole round as ``make_rwalk_round`` ran it: fresh state tensors,
    each step's draws from the round's generator, ``_masked_eval`` around
    the two steps, the blob through ``blob_where``."""
    q, npdim = packed.shape[0], like.npdim
    il = ndim + npdim
    axes = packed[:, il + 1:].reshape(q, ncdim, ncdim).to(dtype)
    st = {"u": packed[:, :ndim].to(dtype).clone(),
          "v": packed[:, ndim:il].to(dtype).clone(),
          "logl": packed[:, il].to(dtype).clone(),
          "n_acc": torch.zeros((q,), dtype=torch.int64),
          "n_rej": torch.zeros((q,), dtype=torch.int64)}
    loglstar = torch.as_tensor(loglstar, dtype=dtype)
    scale = torch.as_tensor(scale, dtype=dtype)
    blob = start_blob
    for _ in range(walks):
        dr = randsphere_batch(gen, (q,), ncdim, dtype, "cpu")
        u_ex = torch.rand((q, ndim - ncdim), generator=gen, dtype=dtype) \
            if ncdim < ndim else None
        du = torch.einsum("qij,qj->qi", axes, dr)
        u_prop, ok = _old_propose(st, du, scale, u_ex, *masks)
        v_prop, logl_prop, blob_prop = _old_masked_eval(like, u_prop, ok)
        accept = _old_accept(st, u_prop, ok, v_prop, logl_prop, loglstar)
        blob = blob_where(accept, blob_prop, blob)
    return tk.pack_columns(q, dtype, st["u"], st["v"], st["logl"],
                           st["n_acc"], st["n_rej"]), blob


# --------------------------------------------------------------------------
# the plain steps with the clamp and the mask folded in


def _hand_step(q, ndim, ncdim, npdim, dtype, seed=6):
    """A walk state and one step's inputs: steps from well inside the
    cube to well beyond it, raw likelihoods above, below and at the
    threshold, +-inf among them."""
    rs = get_rstate(seed)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt)

    st = {"u": t(rs.random((q, ndim))), "v": t(rs.random((q, npdim))),
          "logl": t(rs.normal(size=q)),
          "n_acc": t(rs.integers(0, 9, q), torch.int64),
          "n_rej": t(rs.integers(0, 9, q), torch.int64)}
    inp = {"du": t(rs.normal(size=(q, ncdim)) *
                   np.geomspace(1e-3, 2.0, q)[:, None]),
           "scale": t(0.7),
           "u_ex": t(rs.random((q, ndim - ncdim))) if ncdim < ndim else None,
           "logl_prop": t(rs.choice([_NEG_INF, -1.0, 0.25, 2.0, math.inf],
                                    size=q)),
           "v_prop": t(rs.random((q, npdim))), "loglstar": t(0.25),
           "blob_prop": t(rs.normal(size=(q, 2))),
           "blob": t(rs.normal(size=(q, 2)))}
    return st, inp


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,ncdim", SHAPES)
@pytest.mark.parametrize("masks", [False, True])
def test_plain_steps_equal_the_masked_eval_step(dtype, ndim, ncdim, masks):
    """The plain propose's clamp output and the plain accept's folded
    mask, directly and through the round's buffers, against the old
    propose, ``_masked_eval``'s clamp and mask and the old accept, blob
    select included, every output bit for bit."""
    q, npdim = 64, ndim + 1
    st, inp = _hand_step(q, ndim, ncdim, npdim, dtype)
    m = _mask_tensors(ndim, masks)

    # the old step, the likelihood's raw values given
    old = dict(st)
    u_prop, ok = _old_propose(old, inp["du"], inp["scale"], inp["u_ex"], *m)
    uclamp = u_prop.clamp(0.0, 1.0)
    logl_m = torch.where(ok, inp["logl_prop"], _NEG_INF).to(dtype)
    acc = _old_accept(old, u_prop, ok, inp["v_prop"].to(dtype), logl_m,
                      inp["loglstar"])
    blob = blob_where(acc, inp["blob_prop"], inp["blob"])

    # the plain steps directly
    new = dict(st)
    got = pr.rwalk_propose_plain(new, inp["du"], inp["scale"], inp["u_ex"],
                                 *m)
    acc_p = pr.rwalk_accept_plain(new, got[0], got[2], inp["v_prop"],
                                  inp["logl_prop"], inp["loglstar"])
    for a, b in zip(got + (acc_p,), (u_prop, uclamp, ok, acc)):
        assert torch.equal(a, b)
    for k in old:
        assert torch.equal(new[k], old[k]), k

    # the wrappers on a round's buffers, the blob selected in place
    rb = pr.RWalkRound(q, ndim, ncdim, npdim, dtype, "cpu", *m)
    for k, v in st.items():
        rb.st[k].copy_(v)
    rb.scale.copy_(inp["scale"])
    rb.loglstar.copy_(inp["loglstar"])
    pr.rwalk_propose(rb, inp["du"], inp["u_ex"])
    pr.rwalk_accept(rb, inp["v_prop"], inp["logl_prop"])
    for a, b in zip((rb.u_prop, rb.uclamp, rb.ok, rb.accept),
                    (u_prop, uclamp, ok, acc)):
        assert torch.equal(a, b)
    for k in old:
        assert torch.equal(rb.st[k], old[k]), k
    bb = inp["blob"].clone()
    torch.where(rb.accept[:, None], inp["blob_prop"], bb, out=bb)
    assert torch.equal(bb, blob)
    # points were clamped, finite likelihoods masked, moves and
    # rejections inside the cube both taken
    assert not torch.equal(u_prop, uclamp)
    assert (torch.isfinite(inp["logl_prop"]) & ~ok).any()
    assert acc.any() and (ok & ~acc).any()


def test_round_buffers_refuse_what_no_kernel_takes():
    with pytest.raises(ValueError, match="bad shape"):
        pr.RWalkRound(8, 3, 4, 1, torch.float64, "cpu")
    with pytest.raises(ValueError, match="must have shape"):
        pr.RWalkRound(8, 3, 3, 1, torch.float64, "cpu",
                      periodic=torch.zeros(4, dtype=torch.bool))
    rb = pr.RWalkRound(8, 4, 3, 1, torch.float32, "cpu")
    du = torch.zeros((8, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="u_ex must be given"):
        rb.check_draws(du, None)
    with pytest.raises(TypeError, match="must be torch.float32"):
        rb.check_draws(du.double(), torch.zeros((8, 1)))
    with pytest.raises(ValueError, match="contiguous"):
        rb.check_likelihood(torch.zeros((8, 1), dtype=torch.float32),
                            torch.zeros((8, 2), dtype=torch.float32)[:, 0])


# --------------------------------------------------------------------------
# whole rounds through the round buffers


def blob_ll(x):
    l = -0.5 * (((x - 0.1) / 1.5) ** 2).sum()
    return l, torch.stack([l, x[0]])


def _like(blob, dtype=torch.float64, device="cpu", ndim=3, cls=LogLikelihood,
          fn=None, mode="torch"):
    fn = fn or (blob_ll if blob else
                (lambda x: -0.5 * (((x - 0.1) / 1.5) ** 2).sum()))
    like = cls(fn, lambda u: 4.0 * u - 2.0, ndim, device=device, blob=blob,
               dtype=dtype, mode=mode)
    like.eval_host(np.full((2, ndim), 0.5))
    return like


def _round_inputs(like, q, ndim, ncdim, dtype, device="cpu", seed=21):
    """Start points near the cube's faces (so steps leave it), their blobs
    and per-lane axes packed as a walk round takes them, and a threshold
    below every start."""
    rs = get_rstate(seed)
    u = rs.uniform(0.02, 0.98, size=(q, ndim))
    v, logl, blob = like.eval_host(u)
    axes = 0.15 * (np.eye(ncdim) + 0.1 * rs.normal(size=(q, ncdim, ncdim)))
    packed = torch.as_tensor(np.concatenate(
        [u, v, logl[:, None], axes.reshape(q, -1)], axis=1), dtype=dtype,
        device=device)
    start_blob = None if blob is None else torch.as_tensor(
        np.asarray(blob), device=device)
    return packed, start_blob, float(np.quantile(logl, 0.3))


def _walk_round(like, q, ndim, ncdim, dtype, masks, timings=None,
                rounds=None, device="cpu", walks=WALKS):
    return tk.make_rwalk_round(like, ndim=ndim, ncdim=ncdim, q=q,
                               walks=walks, dtype=dtype, device=device,
                               timings=timings, rounds=rounds,
                               **_masks(ndim, masks))


@pytest.mark.parametrize("ndim,ncdim", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("blob", [False, True])
@pytest.mark.parametrize("masks", [False, True])
def test_round_through_the_round_buffers_equals_the_old_loop(ndim, ncdim,
                                                             dtype, blob,
                                                             masks):
    """Two rounds on one sampler cache (the second reuses the first's
    buffers) against the old loop: every column, the blob and the
    generator's state after the round."""
    q = 24
    like = _like(blob, dtype, ndim=ndim)
    cache, timings = {}, Timings()
    fn = _walk_round(like, q, ndim, ncdim, dtype, masks, timings, cache)
    m = _mask_tensors(ndim, masks)
    for seed in (3, 4):
        packed, start_blob, loglstar = _round_inputs(like, q, ndim, ncdim,
                                                     dtype, seed=seed)
        g_new, g_old = torch.Generator(), torch.Generator()
        g_new.manual_seed(seed)
        g_old.manual_seed(seed)
        got, got_blob = fn(g_new, packed, start_blob, 0.8, loglstar)
        ref, ref_blob = _old_round(like, packed, start_blob, g_old, 0.8,
                                   loglstar, ndim, ncdim, WALKS, m, dtype)
        assert torch.equal(got, ref)
        assert (got_blob is None) == (not blob)
        if blob:
            assert torch.equal(got_blob, ref_blob)
        assert torch.equal(g_new.get_state(), g_old.get_state())
        # the walk moved and rejected, and its tallies cover every step
        il = ndim + like.npdim
        n_acc, n_rej = got[:, il + 1], got[:, il + 2]
        assert torch.all(n_acc + n_rej == WALKS)
        assert 0 < n_acc.sum() < q * WALKS
    assert len(cache) == 1 and next(iter(cache))[0] == "rwalk"
    # the CPU never captures and counts nothing of the card's
    assert not any(k in timings for k in ("n_rwalk_replay", "n_rwalk_graph",
                                          "n_uncaptured"))


def test_round_state_comes_back_owned_by_the_caller():
    """The walk returns its state and blob as copies: the next round,
    which fills the same buffers, leaves an earlier round's result as it
    was."""
    q, ndim, dtype = 16, 3, torch.float64
    like = _like(True, dtype)
    cache = {}
    fn = _walk_round(like, q, ndim, ndim, dtype, False, rounds=cache)
    outs = []
    for seed in (1, 2):
        packed, start_blob, loglstar = _round_inputs(like, q, ndim, ndim,
                                                     dtype, seed=seed)
        gen = torch.Generator()
        gen.manual_seed(seed)
        packed_out, blob = fn(gen, packed, start_blob, 1.0, loglstar)
        outs.append((packed_out, blob, packed_out.clone(), blob.clone()))
    for packed_out, blob, p0, b0 in outs:
        assert torch.equal(packed_out, p0) and torch.equal(blob, b0)
    entry = next(iter(cache.values()))
    assert outs[1][1].untyped_storage().data_ptr() != \
        entry.blob.untyped_storage().data_ptr()
    assert not torch.equal(outs[0][1], outs[1][1])
    # the walk's own return: no tensor of its state is a round buffer
    packed, start_blob, loglstar = _round_inputs(like, q, ndim, ndim, dtype)
    gen = torch.Generator()
    gen.manual_seed(3)
    st, blob = tk.rwalk_walk(
        like, packed[:, :ndim], packed[:, ndim:2 * ndim], packed[:, 2 * ndim],
        packed[:, 2 * ndim + 1:].reshape(q, ndim, ndim), 1.0, loglstar, gen,
        start_blob, walks=WALKS, rounds=cache)
    bufs = {t.untyped_storage().data_ptr() for t in entry.rb.st.values()}
    assert len(cache) == 1 and entry.rb.st is not st
    assert not bufs & {t.untyped_storage().data_ptr() for t in st.values()}
    assert blob.untyped_storage().data_ptr() != \
        entry.blob.untyped_storage().data_ptr()


def test_the_sampler_keeps_one_entry_per_shape_and_never_pickles_it():
    """Both call sites, the fused round and the non-fused round of batch
    seeding, key their buffers in the sampler's cache by round shape: a
    second call of a shape reuses its entry, another width or mask set
    adds one; pickling and a move to another device drop them."""
    ndim, dtype = 4, torch.float64
    sampler = RWalkSampler(ndim=ndim, walks=4, periodic=[0])
    cache = sampler._slice_cache()
    like = _like(False, dtype, ndim=ndim)
    kw = dict(ndim=ndim, ncdim=ndim, walks=4, dtype=dtype, device="cpu",
              periodic=[0], rounds=cache)
    for q in (8, 8, 5):
        packed, _, loglstar = _round_inputs(like, q, ndim, ndim, dtype)
        gen = torch.Generator()
        gen.manual_seed(q)
        tk.make_rwalk_round(like, q=q, **kw)(gen, packed, None, 1.0,
                                             loglstar)
    kw["periodic"] = [1]
    packed, _, loglstar = _round_inputs(like, 8, ndim, ndim, dtype)
    tk.make_rwalk_round(like, q=8, **kw)(gen, packed, None, 1.0, loglstar)
    assert len(cache) == 3 and all(k[0] == "rwalk" for k in cache)
    assert sorted(e.rb.q for e in cache.values()) == [5, 8, 8]
    assert all(isinstance(e, tk.RWalkGraph) for e in cache.values())
    clone = pickle.loads(pickle.dumps(sampler))
    assert clone._slice_rounds == {} and len(sampler._slice_rounds) == 3
    sampler.drop_device_state()
    assert sampler._slice_rounds == {}


def test_a_sampler_run_walks_on_its_round_cache():
    """A static rwalk run on the CPU: its rounds fill the sampler's cache
    with one entry of the fused width and count nothing of the card's."""
    import dynesty_tpu_torch as dyt
    s = dyt.NestedSampler(lambda x: -0.5 * (x @ x),
                          lambda u: 10.0 * (2.0 * u - 1.0), 3, nlive=60,
                          bound="single", sample="rwalk", walks=5,
                          queue_size=16, device="cpu", rstate=get_rstate())
    s.run_nested(print_progress=False, maxiter=400)
    cache = s.internal_sampler._slice_rounds
    # beside the walk's round shape, the fused rounds' state ("round")
    assert [k[:3] for k in cache if k[0] != "round"] == [("rwalk", 16, 5)]
    assert [k[:2] for k in cache if k[0] == "round"] == [("round", "rwalk")]
    assert not any(k in s.timings for k in ("n_rwalk_replay",
                                            "n_rwalk_graph", "n_uncaptured"))


# --------------------------------------------------------------------------
# on the card


def _card_rounds(like, q, dtype, device, seeds, cache, timings, ndim=3,
                 ncdim=3, masks=True, walks=WALKS):
    fn = _walk_round(like, q, ndim, ncdim, dtype, masks, timings, cache,
                     device, walks)
    outs = []
    for seed in seeds:
        packed, start_blob, loglstar = _round_inputs(like, q, ndim, ncdim,
                                                     dtype, device, seed)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        packed_out, blob = fn(gen, packed, start_blob, 0.8, loglstar)
        torch.cuda.synchronize()
        outs.append((packed_out, blob, gen.get_offset()))
    return outs


class _EagerLike(LogLikelihood):
    """A likelihood the rule keeps out of a graph: its rounds launch
    every step eagerly, through the same kernels."""

    def capturable(self):
        return False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,ncdim", SHAPES)
def test_captured_round_equals_the_eager_round_on_the_card(cuda, dtype, ndim,
                                                           ncdim):
    q, seeds = 256, (11, 12, 13)
    like = _like(True, dtype, cuda, ndim)
    eager = _like(True, dtype, cuda, ndim, cls=_EagerLike)
    t_g, t_e = Timings(), Timings()
    got = _card_rounds(like, q, dtype, cuda, seeds, {}, t_g, ndim, ncdim)
    ref = _card_rounds(eager, q, dtype, cuda, seeds, {}, t_e, ndim, ncdim)
    for (p, b, off), (pe, be, offe) in zip(got, ref):
        assert torch.equal(p, pe) and torch.equal(b, be) and off == offe
    # the first round warms up eagerly, the second captures and replays
    assert t_g["n_rwalk_graph"] == 1 and t_g["n_uncaptured"] == 1
    assert t_g["n_rwalk_replay"] == len(seeds) - 1
    assert t_e["n_uncaptured"] == len(seeds) and "n_rwalk_replay" not in t_e


@pytest.mark.cuda
def test_replays_count_the_walks_and_launches(cuda):
    q, dtype, seeds = 128, torch.float64, (5, 6, 7)
    like = _like(False, dtype, cuda)
    pr.zero_counts()
    n0 = like.ncall_launched
    t = Timings()
    _card_rounds(like, q, dtype, cuda, seeds, {}, t)
    steps = WALKS * len(seeds)
    assert pr.rwalk_propose.launches == pr.rwalk_accept.launches == steps
    assert t["n_rwalk_replay"] == len(seeds) - 1 and t["n_rwalk_graph"] == 1
    # q lanes a step, and the start points' own evaluations
    assert like.ncall_launched - n0 == q * steps + len(seeds) * q


@pytest.mark.cuda
def test_the_narrow_width_gets_its_own_graph(cuda):
    dtype, cache, t = torch.float64, {}, Timings()
    like = _like(False, dtype, cuda)
    for q in (256, 32, 256, 32):
        _card_rounds(like, q, dtype, cuda, (q,), cache, t)
    assert len(cache) == 2 and t["n_rwalk_graph"] == 2
    graphs = [e.graph for e in cache.values()]
    assert all(g is not None for g in graphs) and graphs[0] is not graphs[1]
    assert sorted(e.rb.q for e in cache.values()) == [32, 256]


def _syncing_ll(x):
    # a host read inside the likelihood: legal eagerly, not in a capture
    return -0.5 * (x * x).sum(-1) + 0.0 * float(x.sum().item() > 1e300)


@pytest.mark.cuda
def test_a_capture_that_raises_warns_once_and_runs_eagerly(cuda):
    dtype, q, seeds = torch.float64, 64, (1, 2, 3)
    like = _like(False, dtype, cuda, fn=_syncing_ll, mode="vectorized")
    eager = _like(False, dtype, cuda, fn=_syncing_ll, mode="vectorized",
                  cls=_EagerLike)
    t, te = Timings(), Timings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _card_rounds(like, q, dtype, cuda, seeds, {}, t)
    ref = _card_rounds(eager, q, dtype, cuda, seeds, {}, te)
    msgs = [str(x.message) for x in w if "CUDA graph" in str(x.message)]
    assert len(msgs) == 1
    assert t["n_uncaptured"] == len(seeds) and "n_rwalk_replay" not in t
    assert "n_rwalk_graph" not in t
    for (p, _, off), (pe, _, offe) in zip(got, ref):
        assert torch.equal(p, pe) and off == offe
