"""The stepping-out state machine's round buffers and its captured
iteration (``dynesty_tpu_torch/internal/kernels.py``, ``SliceGraph``;
``dynesty_tpu_torch/ops/proposals.py``, ``SliceRound``).

On the CPU: the capture rule, the draws into the round's buffer, a
generator re-seeded in place, the plain steps with the clamp and the
mask folded in against the eager iteration they replace (the loop's
``_masked_eval`` around the steps as they were), and whole rslice and
slice rounds through the round buffers against that eager loop.  On a
card (``cuda``-marked, skipped here): captured rounds against
eager-launched rounds, the replay count and the narrow width's own graph.

Every comparison is bit for bit: the folded clamp and mask are exact
operations, the draws the same Philox or Mersenne stream, and a replay
launches the kernels the eager loop launches on the same inputs.

On the card (``tests/conftest.py`` sets JAX up, which these tests do not
use):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_slice_graph.py
"""

import math
import warnings

import numpy as np
import pytest
import torch

import dynesty_tpu_torch.internal.kernels as tk
from dynesty_tpu_torch.internal.fused import round_seed
from dynesty_tpu_torch.internal.likelihood import (LogLikelihood,
                                                   graph_capturable)
from dynesty_tpu_torch.ops import proposals as pr
from dynesty_tpu_torch.ops.geometry import unitcheck_batch
from dynesty_tpu_torch.utils.misc import Timings, blob_where

from utils import get_rstate

torch.set_num_threads(1)

_NEG_INF = -math.inf
PH_INIT_L, PH_INIT_R, PH_EXP_L, PH_EXP_R, PH_SHRINK = range(5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# the eager iteration as it was: _masked_eval around the two steps


def _old_propose(st, u_sh, directions, strict):
    s, phase, left, right = st["s"], st["phase"], st["left"], st["right"]
    q, n_steps = directions.shape[:2]
    active = s < n_steps
    lane = torch.arange(q, device=s.device)
    dirc = directions[lane, s.clamp(max=n_steps - 1)]
    x = torch.where(
        phase == PH_INIT_L, left,
        torch.where(phase == PH_INIT_R, right,
                    torch.where(phase == PH_EXP_L, left - 1.0,
                                torch.where(phase == PH_EXP_R,
                                            right + 1.0,
                                            left + u_sh *
                                            (right - left)))))
    upos = st["u0"] + x[:, None] * dirc
    return x, upos, unitcheck_batch(upos, strict) & active


def _old_masked_eval(like, u, incube):
    v, logl, blob = like.batch_eval(u.clamp(0.0, 1.0), mask=incube)
    logl = torch.where(incube, logl, _NEG_INF).to(u.dtype)
    return v.to(u.dtype), logl, blob


def _old_advance(st, x, upos, v_x, logl_x, u_r0, loglstar, n_steps):
    s, phase = st["s"], st["phase"]
    left, right, fl, fr = st["left"], st["right"], st["fl"], st["fr"]
    active = s < n_steps
    st["nc"] = st["nc"] + active
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
    st["n_exp"] = st["n_exp"] + expanding
    exp_step = st["exp_step"] + expanding
    st["n_con"] = st["n_con"] + is_sh
    acc = is_sh & (logl_x > loglstar)
    rej = is_sh & ~acc
    left = torch.where(rej & (x < 0), x, left)
    right = torch.where(rej & (x > 0), x, right)
    after_ir = torch.where(
        fl > loglstar, PH_EXP_L,
        torch.where(fr > loglstar, PH_EXP_R, PH_SHRINK))
    nphase = torch.where(is_il, PH_INIT_R, phase)
    nphase = torch.where(is_ir, after_ir, nphase)
    el_done = is_el & (logl_x <= loglstar)
    nphase = torch.where(
        el_done, torch.where(fr > loglstar, PH_EXP_R, PH_SHRINK), nphase)
    er_done = is_er & (logl_x <= loglstar)
    nphase = torch.where(er_done, PH_SHRINK, nphase)
    acc2 = acc[:, None]
    st["u"] = torch.where(acc2, upos, st["u"])
    st["v"] = torch.where(acc2, v_x, st["v"])
    st["logl"] = torch.where(acc, logl_x, st["logl"])
    st["u0"] = torch.where(acc2, upos, st["u0"])
    s = s + acc
    st["s"] = s
    st["left"] = torch.where(acc, -u_r0, left)
    st["right"] = torch.where(acc, 1.0 - u_r0, right)
    st["fl"] = torch.where(acc, _NEG_INF, fl)
    st["fr"] = torch.where(acc, _NEG_INF, fr)
    st["phase"] = torch.where(acc, PH_INIT_L, nphase)
    st["warn"] = st["warn"] | (exp_step > 1000).any()
    st["exp_step"] = torch.where(acc, 0, exp_step)
    st["any_active"] = (s < n_steps).any()
    return acc


def _old_loop(like, directions, r0, gen, loglstar, u, v, logl, blob,
              strict, max_shrink_iters=10000):
    """The state machine's loop as it was: a fresh state, one
    ``torch.rand((2, q))`` an iteration, the likelihood through
    ``_masked_eval``, the blob through ``blob_where``."""
    q, n_steps = directions.shape[:2]
    z = torch.zeros((q,), dtype=torch.int64)
    st = {"s": z, "phase": z.clone(), "left": -r0, "right": 1.0 - r0,
          "fl": torch.full((q,), _NEG_INF, dtype=r0.dtype),
          "fr": torch.full((q,), _NEG_INF, dtype=r0.dtype),
          "u": u.clone(), "v": v.clone(), "logl": logl.clone(),
          "u0": u.clone(), "nc": z, "n_exp": z, "n_con": z, "exp_step": z,
          "warn": torch.zeros((), dtype=torch.bool),
          "any_active": torch.ones((), dtype=torch.bool)}
    loglstar = torch.as_tensor(loglstar, dtype=r0.dtype)
    it = 0
    while it < n_steps * max_shrink_iters:
        if not bool(st["any_active"]):
            break
        u_sh, u_r0 = torch.rand((2, q), generator=gen, dtype=r0.dtype)
        x, upos, incube = _old_propose(st, u_sh, directions, strict)
        v_x, logl_x, blob_x = _old_masked_eval(like, upos, incube)
        acc = _old_advance(st, x, upos, v_x, logl_x, u_r0, loglstar, n_steps)
        blob = blob_where(acc, blob_x, blob)
        it += 1
    return st, blob, it


# --------------------------------------------------------------------------
# the capture rule, the draws, the generator


@pytest.mark.parametrize("mode,history,mesh_size,expected", [
    ("torch", False, 1, True), ("vectorized", False, 1, True),
    ("torch", False, 0, True), ("host", False, 1, False),
    ("torch", True, 1, False), ("vectorized", True, 1, False),
    ("torch", False, 2, False), ("vectorized", False, 8, False),
    ("host", True, 4, False)])
def test_capture_rule_is_a_pure_function_of_the_configuration(
        mode, history, mesh_size, expected):
    assert graph_capturable(mode, history, mesh_size) is expected
    # the likelihood reads the same rule from its own settings
    like = LogLikelihood(lambda x: -(x @ x), lambda u: u, 2, device="cpu",
                         mode=mode)
    # the switch alone (its file needs h5py, which the rule never reads)
    like.save_evaluation_history = history

    class _Mesh:
        size = mesh_size

    like.mesh = _Mesh() if mesh_size else None
    assert like.capturable() is expected


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_uniform_into_the_round_buffer_equals_torch_rand(dtype):
    q = 37
    a, b = torch.Generator(), torch.Generator()
    a.manual_seed(1234)
    b.manual_seed(1234)
    buf = torch.empty((2, q), dtype=dtype)
    for _ in range(5):
        ref = torch.rand((2, q), generator=a, dtype=dtype)
        buf.uniform_(generator=b)
        assert torch.equal(buf, ref)
    assert torch.equal(a.get_state(), b.get_state())


def test_a_generator_reseeded_in_place_equals_a_fresh_one():
    used = torch.Generator()
    used.manual_seed(7)
    torch.rand((100,), generator=used)
    torch.randn((17, 3), generator=used)
    seed = round_seed(99, 3)
    used.manual_seed(seed)
    fresh = torch.Generator()
    fresh.manual_seed(seed)
    assert torch.equal(used.get_state(), fresh.get_state())
    assert used.initial_seed() == fresh.initial_seed() == seed
    draws = [[torch.rand((2, 64), generator=g, dtype=torch.float64),
              torch.randn((64, 5), generator=g),
              torch.rand((3,), generator=g, dtype=torch.float32)]
             for g in (used, fresh)]
    for x, y in zip(*draws):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# the plain steps with the clamp and the mask folded in


def _hand_state(q, ndim, npdim, dtype, seed=5, n_steps=3):
    """Every phase, lanes done, intervals on both sides of 0 and wide
    enough to leave the cube (so points are clamped and masked), exp
    counts next to the warning's 1000, raw likelihoods above, below and
    at the threshold, +-inf among them."""
    rs = get_rstate(seed)
    lane = np.arange(q)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt)

    i64 = torch.int64
    st = {
        "s": t(np.where(lane % 7 == 6, n_steps, lane % n_steps), i64),
        "phase": t(lane % 5, i64), "left": t(-rs.random(q) * 2.0),
        "right": t(rs.random(q) * 2.0),
        "fl": t(rs.choice([_NEG_INF, -1.0, 0.25, 1.0], size=q)),
        "fr": t(rs.choice([_NEG_INF, -1.0, 0.25, 1.0], size=q)),
        "u": t(rs.random((q, ndim))), "v": t(rs.random((q, npdim))),
        "logl": t(rs.normal(size=q)), "u0": t(rs.random((q, ndim))),
        "nc": t(rs.integers(0, 50, q), i64),
        "n_exp": t(rs.integers(0, 50, q), i64),
        "n_con": t(rs.integers(0, 50, q), i64),
        "exp_step": t(np.where(lane % 3 == 0, 1000,
                               rs.integers(0, 999, q)), i64),
        "warn": t(False, torch.bool), "any_active": t(True, torch.bool)}
    inp = {"u_sh": t(rs.random(q)), "u_r0": t(rs.random(q)),
           "directions": t(rs.normal(size=(q, n_steps, ndim)) * 0.3),
           "logl_x": t(rs.choice([_NEG_INF, -2.0, 0.25, 0.5, 3.0,
                                  math.inf], size=q)),
           "v_x": t(rs.random((q, npdim))), "loglstar": t(0.25),
           "blob_x": t(rs.normal(size=(q, 2))),
           "blob": t(rs.normal(size=(q, 2)))}
    return st, inp


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("strict", [None, [True, False, True]])
def test_plain_steps_equal_the_masked_eval_iteration(dtype, strict):
    """The plain propose's clamp output and the plain advance's folded
    mask, through the round's buffers and directly, against the old
    propose, ``_masked_eval``'s clamp and mask and the old advance, blob
    select included, every output bit for bit."""
    q, ndim, npdim, n_steps = 64, 3, 4, 3
    st, inp = _hand_state(q, ndim, npdim, dtype)
    sm = None if strict is None else torch.tensor(strict)

    # the old iteration, the likelihood's raw values given
    old = {k: v.clone() for k, v in st.items()}
    x, upos, incube = _old_propose(old, inp["u_sh"], inp["directions"], sm)
    uclamp = upos.clamp(0.0, 1.0)
    logl_m = torch.where(incube, inp["logl_x"], _NEG_INF).to(dtype)
    acc = _old_advance(old, x, upos, inp["v_x"].to(dtype), logl_m,
                       inp["u_r0"], inp["loglstar"], n_steps)
    blob = blob_where(acc, inp["blob_x"], inp["blob"])

    # the plain steps directly
    new = {k: v.clone() for k, v in st.items()}
    got = pr.slice_propose_plain(new, inp["u_sh"], inp["directions"], sm)
    acc_p = pr.slice_advance_plain(new, got[0], got[1], got[3], inp["v_x"],
                                   inp["logl_x"], inp["u_r0"],
                                   inp["loglstar"], n_steps)
    for a, b in zip(got + (acc_p,), (x, upos, uclamp, incube, acc)):
        assert torch.equal(a, b)
    for k in old:
        assert torch.equal(new[k], old[k]), k

    # the wrappers on a round's buffers, the blob selected in place
    rb = pr.SliceRound(q, n_steps, ndim, npdim, dtype, "cpu", sm)
    for k, v in st.items():
        rb.st[k].copy_(v)
    rb.directions.copy_(inp["directions"])
    rb.draws.copy_(torch.stack([inp["u_sh"], inp["u_r0"]]))
    rb.loglstar.copy_(inp["loglstar"])
    pr.slice_propose(rb)
    pr.slice_advance(rb, inp["v_x"], inp["logl_x"])
    for a, b in zip((rb.x, rb.upos, rb.uclamp, rb.incube, rb.acc),
                    (x, upos, uclamp, incube, acc)):
        assert torch.equal(a, b)
    for k in old:
        assert torch.equal(rb.st[k], old[k]), k
    bb = inp["blob"].clone()
    torch.where(rb.acc[:, None], inp["blob_x"], bb, out=bb)
    assert torch.equal(bb, blob)
    # the state covers every phase and outcome, and points were clamped
    # and masked
    act = st["s"] < n_steps
    assert set(st["phase"][act].tolist()) == set(range(5))
    assert acc.any() and (~incube & act).any() and bool(old["warn"])
    assert not torch.equal(upos, uclamp)
    assert (torch.isfinite(inp["logl_x"]) & ~incube).any()


# --------------------------------------------------------------------------
# whole rounds through the round buffers


def blob_ll(x):
    l = -0.5 * (((x - 0.1) / 1.5) ** 2).sum()
    return l, torch.stack([l, x[0]])


def _like(blob, dtype=torch.float64, device="cpu", ndim=3):
    fn = blob_ll if blob else (lambda x: -0.5 * (((x - 0.1) / 1.5) ** 2)
                               .sum())
    like = LogLikelihood(fn, lambda u: 4.0 * u - 2.0, ndim, device=device,
                         blob=blob, dtype=dtype)
    like.eval_host(np.full((2, ndim), 0.5))
    return like


def _round_inputs(like, q, ndim, dtype, device="cpu", seed=21):
    """Start points, their blobs and per-lane axes packed as a slice round
    takes them, and a threshold below every start."""
    rs = get_rstate(seed)
    u = rs.uniform(0.3, 0.7, size=(q, ndim))
    v, logl, blob = like.eval_host(u)
    axes = 0.2 * (np.eye(ndim) + 0.1 * rs.normal(size=(q, ndim, ndim)))
    packed = torch.as_tensor(np.concatenate(
        [u, v, logl[:, None], axes.reshape(q, -1)], axis=1), dtype=dtype,
        device=device)
    start_blob = None if blob is None else torch.as_tensor(
        np.asarray(blob), device=device)
    # every start above the threshold, as a round's starts are
    return packed, start_blob, float(logl.min() - 0.5)


def _old_round(like, packed, start_blob, gen, kind, slices, scale, loglstar,
               strict, dtype):
    """A whole round as ``make_slice_round``'s stepping-out form ran it:
    the same directions and first intervals, then the old loop."""
    q, ndim, npdim = packed.shape[0], like.ndim, like.npdim
    axes = packed[:, ndim + npdim + 1:].reshape(q, ndim, ndim).to(dtype)
    directions = tk.slice_directions(gen, axes, scale, kind, slices)
    dirlen = torch.linalg.vector_norm(directions, dim=-1)
    maxlen = math.sqrt(ndim) / 2.0
    directions = directions / torch.where(dirlen > maxlen, dirlen / maxlen,
                                          1.0)[..., None]
    r0 = torch.rand((q,), generator=gen, dtype=dtype)
    st, blob, it = _old_loop(
        like, directions, r0, gen, loglstar, packed[:, :ndim].to(dtype),
        packed[:, ndim:ndim + npdim].to(dtype),
        packed[:, ndim + npdim].to(dtype), start_blob, strict)
    return tk.pack_columns(q, dtype, st["u"], st["v"], st["logl"], st["nc"],
                           st["n_exp"], st["n_con"], st["warn"]), blob, it


@pytest.mark.parametrize("kind,slices", [("rslice", 3), ("slice", 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("blob", [False, True])
def test_round_through_the_round_buffers_equals_the_old_loop(kind, slices,
                                                             dtype, blob):
    """Two rounds on one sampler cache (the second reuses the first's
    buffers) against the old loop: every column, the blob and the
    generator's state after the round."""
    q, ndim, strict = 24, 3, [True, False, True]
    like = _like(blob, dtype)
    cache, timings = {}, Timings()
    fn = tk.make_slice_round(
        like, ndim=ndim, q=q, slices=slices, kind=kind, dtype=dtype,
        device="cpu", nonperiodic=strict, timings=timings, rounds=cache)
    for seed in (3, 4):
        packed, start_blob, loglstar = _round_inputs(like, q, ndim, dtype,
                                                     seed=seed)
        g_new, g_old = torch.Generator(), torch.Generator()
        g_new.manual_seed(seed)
        g_old.manual_seed(seed)
        n0 = timings.get("sync_slice", 0)
        got, got_blob = fn(g_new, packed, start_blob, 0.8, loglstar)
        ref, ref_blob, iters = _old_round(
            like, packed, start_blob, g_old, kind, slices, 0.8, loglstar,
            torch.tensor(strict), dtype)
        assert torch.equal(got, ref)
        assert (got_blob is None) == (not blob)
        if blob:
            assert torch.equal(got_blob, ref_blob)
        assert torch.equal(g_new.get_state(), g_old.get_state())
        assert timings["sync_slice"] - n0 == iters + 1 and iters > 10
    assert len(cache) == 1
    # the CPU never captures and counts nothing of the card's
    assert not any(k in timings for k in ("n_slice_replay", "n_slice_graph",
                                          "n_uncaptured"))


def test_round_state_comes_back_owned_by_the_caller():
    """The round returns the blob as a copy: the next round, which fills
    the same buffers, leaves an earlier round's result as it was."""
    q, ndim, dtype = 16, 3, torch.float64
    like = _like(True, dtype)
    cache = {}
    fn = tk.make_slice_round(like, ndim=ndim, q=q, slices=2, kind="rslice",
                             dtype=dtype, device="cpu", rounds=cache)
    outs = []
    for seed in (1, 2):
        packed, start_blob, loglstar = _round_inputs(like, q, ndim, dtype,
                                                     seed=seed)
        gen = torch.Generator()
        gen.manual_seed(seed)
        packed_out, blob = fn(gen, packed, start_blob, 1.0, loglstar)
        outs.append((packed_out, blob, packed_out.clone(), blob.clone()))
    for packed_out, blob, p0, b0 in outs:
        assert torch.equal(packed_out, p0) and torch.equal(blob, b0)
    buf = next(iter(cache.values())).blob
    assert outs[1][1].untyped_storage().data_ptr() != \
        buf.untyped_storage().data_ptr()
    assert not torch.equal(outs[0][1], outs[1][1])


# --------------------------------------------------------------------------
# on the card


def _card_round(like, q, kind, slices, dtype, device, strict, seeds,
                cache, timings):
    fn = tk.make_slice_round(
        like, ndim=like.ndim, q=q, slices=slices, kind=kind, dtype=dtype,
        device=device, nonperiodic=strict, timings=timings, rounds=cache)
    outs = []
    for seed in seeds:
        packed, start_blob, loglstar = _round_inputs(like, q, like.ndim,
                                                     dtype, device, seed)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        packed_out, blob = fn(gen, packed, start_blob, 0.8, loglstar)
        torch.cuda.synchronize()
        outs.append((packed_out, blob, gen.get_offset()))
    return outs


class _EagerLike(LogLikelihood):
    """A likelihood the rule keeps out of a graph: its rounds launch
    every iteration eagerly, through the same kernels."""

    def capturable(self):
        return False


@pytest.mark.cuda
@pytest.mark.parametrize("kind,slices", [("rslice", 3), ("slice", 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_round_equals_the_eager_round_on_the_card(cuda, kind,
                                                           slices, dtype):
    q, ndim, strict = 256, 3, [True, False, True]
    seeds = (11, 12, 13)
    like = _like(True, dtype, cuda)
    eager = _EagerLike(blob_ll, lambda u: 4.0 * u - 2.0, ndim, device=cuda,
                       blob=True, dtype=dtype)
    eager.eval_host(np.full((2, ndim), 0.5))
    t_g, t_e = Timings(), Timings()
    got = _card_round(like, q, kind, slices, dtype, cuda, strict, seeds, {},
                      t_g)
    ref = _card_round(eager, q, kind, slices, dtype, cuda, strict, seeds,
                      {}, t_e)
    for (p, b, off), (pe, be, offe) in zip(got, ref):
        assert torch.equal(p, pe) and torch.equal(b, be) and off == offe
    assert t_g["n_slice_graph"] == 1 and t_g.get("n_uncaptured", 0) == 0
    assert t_e["n_uncaptured"] == len(seeds) and "n_slice_replay" not in t_e
    # every iteration but the first round's warm-up ran as a replay
    iters = t_e["sync_slice"] - len(seeds)
    assert t_g["n_slice_replay"] + t_g["n_slice_graph"] == iters
    assert t_g["sync_slice"] == t_e["sync_slice"]


@pytest.mark.cuda
def test_replays_count_the_iterations_and_launches(cuda):
    q, dtype = 128, torch.float64
    like = _like(False, dtype, cuda)
    pr.zero_counts()
    n0 = like.ncall_launched
    t = Timings()
    _card_round(like, q, "rslice", 2, dtype, cuda, None, (5, 6), {}, t)
    iters = t["sync_slice"] - 2
    assert pr.slice_propose.launches == pr.slice_advance.launches == iters
    assert t["n_slice_replay"] == iters - 1 and t["n_slice_graph"] == 1
    # q lanes an iteration, and the start points' own evaluations
    assert like.ncall_launched - n0 == q * iters + 2 * q


@pytest.mark.cuda
def test_the_narrow_width_gets_its_own_graph(cuda):
    dtype, cache, t = torch.float64, {}, Timings()
    like = _like(False, dtype, cuda)
    for q in (256, 32, 256, 32):
        _card_round(like, q, "rslice", 2, dtype, cuda, None, (q,), cache, t)
    assert len(cache) == 2 and t["n_slice_graph"] == 2
    graphs = [e.graph for e in cache.values()]
    assert all(g is not None for g in graphs) and graphs[0] is not graphs[1]
    assert sorted(e.rb.q for e in cache.values()) == [32, 256]


def _syncing_ll(x):
    # a host read inside the likelihood: legal eagerly, not in a capture
    return -0.5 * (x * x).sum(-1) + 0.0 * float(x.sum().item() > 1e300)


@pytest.mark.cuda
def test_a_capture_that_raises_warns_once_and_runs_eagerly(cuda):
    dtype, q = torch.float64, 64
    like = LogLikelihood(_syncing_ll, lambda u: 4.0 * u - 2.0, 3,
                         device=cuda, mode="vectorized", dtype=dtype)
    like.eval_host(np.full((2, 3), 0.5))
    eager = _EagerLike(_syncing_ll, lambda u: 4.0 * u - 2.0, 3, device=cuda,
                       mode="vectorized", dtype=dtype)
    eager.eval_host(np.full((2, 3), 0.5))
    t, te = Timings(), Timings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _card_round(like, q, "rslice", 2, dtype, cuda, None, (1, 2),
                          {}, t)
    ref = _card_round(eager, q, "rslice", 2, dtype, cuda, None, (1, 2), {},
                      te)
    msgs = [str(x.message) for x in w if "CUDA graph" in str(x.message)]
    assert len(msgs) == 1
    assert t["n_uncaptured"] == 2 and "n_slice_replay" not in t
    for (p, _, off), (pe, _, offe) in zip(got, ref):
        assert torch.equal(p, pe) and off == offe
