"""The doubling slice round (``dynesty_tpu_torch/internal/kernels.py``,
``doubling_round`` and ``DoublingGraph``; ``dynesty_tpu_torch/ops/
proposals.py``, ``DoublingRound`` and the ``doubling_*`` steps).

On the CPU: the round fed the JAX package's own draws against the JAX
package's jitted doubling round; each plain step against the eager loop
body it was moved from, on hand-made states; whole rounds against the
eager round as it was (output, blob, ``sync_slice`` reads, generator
state).  On a card (``cuda``-marked, skipped here): the four kernels
against their plain versions, and captured rounds against eager ones.

Tolerances.  Fed the JAX package's draws, the port takes the same steps:
every count (``nc``, ``n_expand``, ``n_contract``) is equal and u, v and
logl agree to 1e-12 relative in float64 (XLA and torch round the
direction norm, the axes product and the likelihood differently in the
last ulp).  The plain steps are the eager code itself, the kernels round
every operation as the eager ops do, and a replay launches what the eager
round launches: all of those bit for bit.

The JAX package is imported by a fixture, and its comparison runs only
under ``tests/conftest.py`` (JAX on the CPU in float64); on the card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_doubling.py
"""

import math
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import dynesty_tpu_torch.internal.kernels as tk
from dynesty_tpu_torch.internal.likelihood import LogLikelihood
from dynesty_tpu_torch.ops import proposals as pr
from dynesty_tpu_torch.ops.geometry import unitcheck_batch
from dynesty_tpu_torch.utils.misc import Timings, blob_where, tree_map

from utils import get_rstate

torch.set_num_threads(1)

Q = 32
RTOL, ATOL = 1e-12, 1e-15
_NEG_INF = -math.inf


@pytest.fixture(scope="module")
def jx():
    """jax, jax.numpy, and the JAX package's kernels and likelihood."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("the JAX comparisons run under tests/conftest.py "
                    "(JAX on the CPU in float64)")
    import jax.numpy as jnp

    import dynesty_tpu.internal.kernels as jk
    import dynesty_tpu.internal.likelihood as jlike
    return jax, jnp, jk, jlike


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _closure_fn(fn, name, seen=None):
    """The function called ``name`` among the closures under ``fn``."""
    seen = seen if seen is not None else set()
    fn = getattr(fn, "__wrapped__", fn)
    if id(fn) in seen or not hasattr(fn, "__closure__"):
        return None
    seen.add(id(fn))
    if getattr(fn, "__name__", None) == name:
        return fn
    for cell in fn.__closure__ or ():
        try:
            val = cell.cell_contents
        except ValueError:
            continue
        if callable(val):
            found = _closure_fn(val, name, seen)
            if found is not None:
                return found
    return None


# --------------------------------------------------------------------------
# the round fed the JAX package's draws


def _jax_doubling(jx, ndim, kind, slices, nonperiodic, seed):
    """The JAX package's doubling round and the port's on its draws: both
    results as dicts of numpy columns."""
    jax, jnp, jk, jlike = jx
    sigma, scale = 0.3, 1.0
    rs = get_rstate(seed)
    # starts near the edges and a wide slice: end probes and doublings
    # leave the cube
    u = rs.uniform(0.02, 0.98, size=(Q, ndim))
    logl = -0.5 * ((u - 0.5) ** 2).sum(1) / sigma ** 2
    loglstar = float(logl.min() - 1.0)
    axes = 0.2 * (np.eye(ndim) + 0.3 * rs.normal(size=(Q, ndim, ndim)))
    jl = jlike.LogLikelihood(
        lambda v: -0.5 * jnp.sum((v - 0.5) ** 2) / sigma ** 2,
        lambda x: x, ndim)
    jl.eval_host(u[:2])
    tl = LogLikelihood(lambda v: -0.5 * ((v - 0.5) ** 2).sum() / sigma ** 2,
                       lambda x: x, ndim, device="cpu")
    tl.eval_host(u[:2])
    packed_in = np.concatenate([u, u, logl[:, None], axes.reshape(Q, -1)],
                               axis=1)
    key = jax.random.PRNGKey(seed)
    jfn = jk.make_slice_round(jl, ndim=ndim, q=Q, slices=slices, kind=kind,
                              nonperiodic=nonperiodic, doubling=True,
                              dtype=jnp.float64)
    packed = np.asarray(jfn(key, jnp.asarray(packed_in), None, scale,
                            loglstar)[0])
    ref = {"u": packed[:, :ndim], "v": packed[:, ndim:2 * ndim],
           "logl": packed[:, 2 * ndim], "nc": packed[:, 2 * ndim + 1],
           "n_exp": packed[:, 2 * ndim + 2],
           "n_con": packed[:, 2 * ndim + 3]}

    # the JAX round's key schedule: the directions, then per step a key
    # split three ways: r0, the doubling's chain of splits (one uniform
    # draw a doubling), the shrink's (one a candidate)
    kdir, kstep = jax.random.split(key)
    make_dirs = _closure_fn(jfn, "_make_directions")
    assert make_dirs is not None
    dirs = np.array(make_dirs(kdir, jnp.asarray(axes), scale))
    n_steps = dirs.shape[1]
    step_keys = jax.random.split(kstep, n_steps)
    chains, calls = {}, []

    def draw(what, s, i):
        calls.append((what, s, i))
        k0, k1, k2 = jax.random.split(step_keys[s], 3)
        if what == "r0":
            sub = k0
        else:
            kk, subs = chains.setdefault((what, s), [
                k1 if what == "side" else k2, []])
            while len(subs) <= i:
                kk, kv = jax.random.split(kk)
                subs.append(kv)
            chains[(what, s)][0] = kk
            sub = subs[i]
        return torch.from_numpy(np.array(jax.random.uniform(
            sub, (Q,), dtype=jnp.float64)))

    # the JAX round caps a step's direction as it starts it, the port
    # caps them all before the first
    lens = np.linalg.norm(dirs, axis=-1)
    maxlen = math.sqrt(ndim) / 2.0
    capped = dirs / np.where(lens > maxlen, lens / maxlen, 1.0)[..., None]
    # the masks of the step's end probes are their cube checks alone
    masks, batch_eval = [], tl.batch_eval

    def recorded(x, mask=None):
        masks.append(mask.clone())
        return batch_eval(x, mask)

    tl.batch_eval = recorded
    start = torch.from_numpy(u)
    st, _ = tk.doubling_round(
        tl, torch.from_numpy(capped), draw, loglstar, start, start.clone(),
        torch.from_numpy(logl), strict=tk._bool_mask(nonperiodic, "cpu"))
    got = {k: st[k].numpy() for k in ("u", "v", "logl", "nc", "n_exp",
                                      "n_con")}
    assert not bool(masks[0].all() and masks[1].all()), "no probe left"
    return got, ref, calls


@pytest.mark.parametrize("kind,ndim,nonperiodic", [
    ("rslice", 2, None), ("slice", 2, [True, False]),
    ("rslice", 5, [True, True, False, True, True]), ("slice", 5, None)])
def test_doubling_round_matches_jax(jx, kind, ndim, nonperiodic):
    slices = 2 if kind == "rslice" else 1
    got, ref, calls = _jax_doubling(jx, ndim, kind, slices, nonperiodic,
                                    21 + ndim)
    for name in ("u", "v", "logl"):
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for name in ("nc", "n_exp", "n_con"):
        assert np.array_equal(got[name], ref[name]), name
    n_steps = slices * (ndim if kind == "slice" else 1)
    # every step drew r0 first, then its doublings, then its candidates
    assert [c for c in calls if c[0] == "r0"] == \
        [("r0", s, 0) for s in range(n_steps)]
    assert any(c[0] == "side" for c in calls)
    # two end probes and a candidate a step at least; some intervals
    # doubled and some candidates were held to the acceptance test
    assert np.all(got["nc"] >= 3 * n_steps)
    assert got["n_exp"].sum() > 0 and np.all(got["n_con"] >= n_steps)
    assert np.any(got["nc"] > 2 * n_steps + got["n_con"] +
                  np.log2(np.maximum(got["n_exp"], 1)))


# --------------------------------------------------------------------------
# the plain steps against the eager loop body they were moved from


def _hand_state(q, ndim, npdim, dtype, device="cpu", n_steps=4, seed=5):
    """A hand-made round state and a segment's inputs: lanes active and
    not, intervals on both sides of 0 and wide enough for the points to
    leave the cube (so they are clamped and masked), ``grow`` at and next
    to its clamp, end values of -inf and at the threshold, a candidate
    draw of 0 (the candidate on the interval's left end) and side draws of
    exactly 0.5."""
    rs = get_rstate(seed)
    lane = np.arange(q)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    def mask(p):
        return t(rs.random(q) < p, torch.bool)

    i64, ls = torch.int64, 0.25
    vals = [_NEG_INF, -1.0, ls, 1.0, 3.0]
    left = -rs.random(q) * 3.0
    right = rs.random(q) * 3.0
    st = pr._doubling_state(q, ndim, npdim, dtype, device)
    st.update({
        "u": t(rs.random((q, ndim))), "v": t(rs.random((q, npdim))),
        "logl": t(rs.normal(size=q)), "u0": t(rs.random((q, ndim))),
        "dir": t(rs.normal(size=(q, ndim)) * 0.3),
        "left": t(left), "right": t(right),
        "fl": t(rs.choice(vals, q)), "fr": t(rs.choice(vals, q)),
        "sl": t(left * rs.random(q)), "sr": t(right * rs.random(q)),
        "lhat": t(left * rs.random(q)), "rhat": t(right * rs.random(q)),
        "f_lhat": t(rs.choice(vals, q)), "f_rhat": t(rs.choice(vals, q)),
        "x1": t(rs.uniform(-3.0, 3.0, q)),
        "nc": t(rs.integers(0, 50, q), i64),
        "n_exp": t(rs.integers(0, 50, q), i64),
        "n_con": t(rs.integers(0, 50, q), i64),
        "grow": t(rs.choice([1, 2, 1 << 29, 1 << 30], q), i64),
        "d_nc": t(rs.integers(0, 5, q), i64),
        "active": mask(0.7), "s_active": mask(0.7), "h_active": mask(0.6),
        "good": mask(0.5), "dflag": mask(0.3), "reject": mask(0.2),
        "step": t([n_steps - 2], i64)})
    for k in ("u_c", "uclamp", "v_c", "logl_c", "newly", "incube",
              "incube_l", "incube_s"):
        st[k].zero_()
    st["any"].fill_(True)
    st["any_shrink"].fill_(True)
    draw = rs.random(q)
    draw[lane % 9 == 0] = 0.5
    draw[lane % 11 == 1] = 0.0
    # the side of each lane's doubling, as the probe before it kept it
    st["go_left"] = t(draw < 0.5, torch.bool)
    inp = {"directions": t(rs.normal(size=(q, n_steps, ndim)) * 0.4),
           "draw": t(draw), "loglstar": t(ls),
           "strict": t([d != 1 for d in range(ndim)], torch.bool),
           "logl": [t(rs.choice(vals + [0.5, 2.0], q)) for _ in range(8)],
           "v_x": t(rs.random((q, npdim)))}
    # the vectors drawn for the next probes: a doubling's side (some
    # exactly 0.5), a shrink candidate's position (some 0)
    nxt, nxt_x = rs.random(q), rs.random(q)
    nxt[lane % 7 == 3] = 0.5
    nxt_x[lane % 5 == 2] = 0.0
    inp.update(draw2=t(nxt), draw_x=t(nxt_x))
    return st, inp


def _masked(logl_raw, u, incube):
    """What the eager loop's ``_masked_eval`` made of a raw logl."""
    return torch.where(incube, logl_raw, _NEG_INF).to(u.dtype)


class _Probe:
    """The eager loop's ``feval``: the point, its cube check with the
    mask, the clamped point recorded (what the likelihood read) and the
    given raw values masked."""

    def __init__(self, u0, direction, strict, raws):
        self.u0, self.direction, self.strict = u0, direction, strict
        self.raws, self.seen = list(raws), []

    def __call__(self, x, mask=None):
        u = self.u0 + x[:, None] * self.direction
        incube = unitcheck_batch(u, self.strict)
        if mask is not None:
            incube = incube & mask
        self.seen.append((u.clamp(0.0, 1.0), incube))
        return u, _masked(self.raws.pop(0), u, incube)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b) or bool(((a == b) | (a.isnan() & b.isnan()))
                                      .all())


def _next_probe(u0, direction, strict, active, s_active, left, right,
                side, x_draw):
    """The eager loop's next probe after a doubling's update: the next
    doubling's new end where a lane is ``active`` (its side ``side <
    0.5``), else the first shrink candidate ``left + x_draw * (right -
    left)`` (counted where ``s_active``): the clamped point, both cube
    checks, the side, the candidate's position and point."""
    go_left = side < 0.5
    width = right - left
    xd = torch.where(go_left, left - width, right + width)
    xs = left + x_draw * (right - left)
    ud = u0 + xd[:, None] * direction
    us = u0 + xs[:, None] * direction
    return {"uclamp": torch.where(active[:, None], ud.clamp(0.0, 1.0),
                                  us.clamp(0.0, 1.0)),
            "incube": unitcheck_batch(ud, strict) & active,
            "incube_s": unitcheck_batch(us, strict) & s_active & ~active,
            "go_left": go_left, "x1": xs, "u_c": us}


def _check_next_probe(st, ref0, nxt):
    """The state's next probe against :func:`_next_probe`'s: the clamped
    point and both cube checks on every lane, the side on the lanes that
    double on, the candidate on the others (their old values kept on the
    lanes that double on)."""
    act = st["active"]
    for k in ("uclamp", "incube", "incube_s"):
        _same(st[k], nxt[k])
    _same(st["go_left"][act], nxt["go_left"][act])
    for k in ("x1", "u_c"):
        _same(st[k][~act], nxt[k][~act])
        _same(st[k][act], ref0[k][act])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("strict", [False, True])
def test_plain_start_and_doubling_equal_the_eager_body(dtype, strict):
    st, inp = _hand_state(64, 3, 2, dtype)
    ls, draw = inp["loglstar"], inp["draw"]
    side, x_draw = inp["draw2"], inp["draw_x"]
    sm = inp["strict"] if strict else None
    s = int(st["step"])
    # the step's start: both end probes, then the start state and the
    # next probe
    ref0 = {k: t.clone() for k, t in st.items()}
    pr.doubling_point_plain(st, pr.P_START_L, draw, inp["directions"], sm)
    seen = [(st["uclamp"], st["incube_l"])]
    pr.doubling_point_plain(st, pr.P_START_R, draw, inp["directions"], sm)
    seen.append((st["uclamp"], st["incube"]))
    pr.doubling_expand_plain(st, pr.X_INIT, inp["logl"][1], inp["logl"][0],
                             side, x_draw, ls, sm)
    direction = inp["directions"][:, s]
    feval = _Probe(ref0["u"], direction, sm, inp["logl"][:2])
    r0 = draw
    left, right = -r0, 1.0 - r0
    fl, fr = feval(left)[1], feval(right)[1]
    active = (fl > ls) | (fr > ls)
    for (a, b), (c, d) in zip(seen, feval.seen):
        _same(a, c)
        _same(b, d)
    for k, ref in (("left", left), ("right", right), ("fl", fl),
                   ("fr", fr), ("active", active), ("sl", left),
                   ("sr", right), ("dir", direction), ("u0", ref0["u"])):
        _same(st[k], ref)
    assert torch.equal(st["nc"], ref0["nc"] + 2)
    assert torch.equal(st["grow"], torch.ones_like(st["grow"]))
    assert bool(st["s_active"].all()) and int(st["step"]) == s + 1
    assert bool(st["any"]) == bool(active.any())
    _check_next_probe(st, ref0, _next_probe(
        ref0["u"], direction, sm, active, torch.ones_like(active), left,
        right, side, x_draw))
    assert 0 < int(active.sum()) < 64

    # one doubling, from the hand-made state (grow at its clamp among it)
    # and the probe the kernel before it wrote
    st, inp = _hand_state(64, 3, 2, dtype, seed=6)
    dbl = dict(st)
    pr.doubling_point_plain(dbl, pr.P_DOUBLE, draw, inp["directions"], sm)
    for k in ("uclamp", "incube", "go_left"):
        st[k] = dbl[k]
    ref0 = {k: t.clone() for k, t in st.items()}
    seen = (st["uclamp"], st["incube"])
    pr.doubling_expand_plain(st, pr.X_DOUBLE, inp["logl"][2], None, side,
                             x_draw, ls, sm)
    feval = _Probe(ref0["u0"], ref0["dir"], sm, inp["logl"][2:3])
    active, left, right = ref0["active"], ref0["left"], ref0["right"]
    fl, fr, grow = ref0["fl"], ref0["fr"], ref0["grow"]
    go_left = draw < 0.5
    width = right - left
    left = torch.where(active & go_left, left - width, left)
    right = torch.where(active & ~go_left, right + width, right)
    logl_new = feval(torch.where(go_left, left, right), active)[1]
    fl = torch.where(active & go_left, logl_new, fl)
    fr = torch.where(active & ~go_left, logl_new, fr)
    nc = ref0["nc"] + active
    n_exp = ref0["n_exp"] + active * grow
    grow = torch.where(active, (grow * 2).clamp(max=1 << 30), grow)
    active = active & ((fl > ls) | (fr > ls))
    _same(seen[0], feval.seen[0][0])
    _same(seen[1], feval.seen[0][1])
    for k, ref in (("left", left), ("right", right), ("fl", fl),
                   ("fr", fr), ("nc", nc), ("n_exp", n_exp), ("grow", grow),
                   ("active", active), ("sl", left), ("sr", right)):
        _same(st[k], ref)
    assert bool(st["any"]) == bool(active.any())
    assert int(ref0["grow"].max()) == 1 << 30 == int(st["grow"].max())
    assert bool((ref0["active"] & (ref0["grow"] == 1 << 29)).any())
    _check_next_probe(st, ref0, _next_probe(
        ref0["u0"], ref0["dir"], sm, active, ref0["s_active"], left, right,
        side, x_draw))
    # lanes that double on and lanes that stop, some of them not shrinking
    assert bool(active.any()) and bool((~active & ~ref0["s_active"]).any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("strict", [False, True])
def test_plain_shrink_and_halving_equal_the_eager_body(dtype, strict):
    """A shrink candidate, its halvings and its resolution against the
    eager shrink body with its acceptance test (``doubling_accept``),
    both reading the same raw likelihoods call by call; the candidate
    probed as the kernel before it writes it, the next candidate by the
    resolution."""
    st, inp = _hand_state(64, 3, 2, dtype, seed=7)
    ls, draw = inp["loglstar"], inp["draw"]
    sm = inp["strict"] if strict else None
    raws = inp["logl"]
    shr = pr._shrink_probe(st, draw, sm)
    for k in ("x1", "u_c", "uclamp"):
        st[k] = shr[k]
    st["incube_s"] = shr["incube"]
    ref0 = {k: t.clone() for k, t in st.items()}
    seen = [(st["uclamp"], st["incube_s"])]
    pr.doubling_shrink_plain(st, pr.S_CANDIDATE, inp["v_x"], raws[0], ls,
                             sm)
    assert not bool(st["any_shrink"])
    halvings = 0
    while bool(st["any"]):
        # each halving's mid, probed by the step before it
        seen.append((st["uclamp"], st["incube"]))
        halvings += 1
        pr.doubling_halve_plain(st, raws[halvings], ls, sm)
    pr.doubling_shrink_plain(st, pr.S_RESOLVE, None, None, ls, sm,
                             inp["draw_x"])

    # the eager shrink body on the hand-made state
    feval = _Probe(ref0["u0"], ref0["dir"], sm, raws)
    active = ref0["s_active"]
    left, right = ref0["sl"], ref0["sr"]
    big = (ref0["left"], ref0["right"], ref0["fl"], ref0["fr"])
    x = left + draw * (right - left)
    u_prop, logl_prop = feval(x, active)
    nc = ref0["nc"] + active
    good = logl_prop > ls
    d_acc, d_nc = tk.doubling_accept(lambda xm, m: feval(xm, m)[1], x, ls,
                                     *big, lanes=active & good)
    nc = nc + torch.where(active & good, d_nc, 0)
    good = good & d_acc
    newly = active & good
    u = torch.where(newly[:, None], u_prop, ref0["u"])
    v = torch.where(newly[:, None], inp["v_x"], ref0["v"])
    logl = torch.where(newly, logl_prop, ref0["logl"])
    bad = active & ~good
    left = torch.where(bad & (x < 0), x, left)
    right = torch.where(bad & (x > 0), x, right)
    # the next candidate of the lanes that shrink on
    x_next = left + inp["draw_x"] * (right - left)
    u_next = ref0["u0"] + x_next[:, None] * ref0["dir"]

    assert len(seen) == len(feval.seen) == halvings + 1 and halvings >= 2
    for (a, b), (c, d) in zip(seen, feval.seen):
        _same(a, c)
        _same(b, d)
    for k, ref in (("u", u), ("v", v), ("logl", logl), ("nc", nc),
                   ("n_con", ref0["n_con"] + active), ("sl", left),
                   ("sr", right), ("s_active", bad), ("newly", newly),
                   ("x1", x_next), ("u_c", u_next),
                   ("uclamp", u_next.clamp(0.0, 1.0)),
                   ("incube_s", unitcheck_batch(u_next, sm) & bad)):
        _same(st[k], ref)
    assert bool(st["any_shrink"]) == bool(bad.any())
    # rejected and accepted lanes, a lane that stops testing for its
    # interval, and a candidate on its interval's left end
    assert 0 < int(newly.sum()) < int(active.sum())
    assert bool((st["reject"] & active).any())
    assert bool((x == ref0["sl"]).any())


def test_wrappers_take_the_plain_steps_on_the_cpu():
    """On the CPU every wrapper runs its plain step on the round's
    buffers, in place, and counts no launch."""
    q, ndim, npdim, dtype = 16, 3, 2, torch.float64
    st, inp = _hand_state(q, ndim, npdim, dtype)
    rb = pr.DoublingRound(q, 4, ndim, npdim, dtype, "cpu", inp["strict"])
    ptrs = {k: t.data_ptr() for k, t in rb.st.items()}
    rb.start(st["u"], st["v"], st["logl"], inp["directions"], 0.25)
    for k, t in st.items():
        if k not in ("nc", "n_exp", "n_con", "step"):
            rb.st[k].copy_(t)
    rb.draw.copy_(inp["draw"])
    pr.zero_counts()
    ref = {k: t.clone() for k, t in rb.st.items()}
    for fn, args in ((pr.doubling_point_plain,
                      (pr.P_START_L, inp["draw"], inp["directions"],
                       inp["strict"])),
                     (pr.doubling_point_plain,
                      (pr.P_START_R, inp["draw"], inp["directions"],
                       inp["strict"])),
                     (pr.doubling_expand_plain,
                      (pr.X_INIT, inp["logl"][1], inp["logl"][0],
                       inp["draw"], inp["draw_x"], rb.loglstar,
                       inp["strict"])),
                     (pr.doubling_shrink_plain,
                      (pr.S_RESOLVE, None, None, rb.loglstar,
                       inp["strict"], inp["draw"]))):
        fn(ref, *args)
    pr.doubling_point(rb, pr.P_START_L)
    pr.doubling_point(rb, pr.P_START_R)
    pr.doubling_expand(rb, pr.X_INIT, inp["logl"][1], inp["logl"][0],
                       inp["draw_x"])
    pr.doubling_shrink(rb, pr.S_RESOLVE)
    for k in ref:
        _same(rb.st[k], ref[k])
    assert {k: t.data_ptr() for k, t in rb.st.items()} == ptrs
    assert all(w.launches == 0 for w in pr.WRAPPERS)


def test_round_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError):
        pr.DoublingRound(4, 2, 3, 3, torch.float16, "cpu")
    with pytest.raises(ValueError):
        pr.DoublingRound(0, 2, 3, 3, torch.float64, "cpu")
    with pytest.raises(ValueError):
        pr.DoublingRound(4, 2, 3, 3, torch.float64, "meta")
    with pytest.raises(ValueError):
        pr.DoublingRound(4, 2, 3, 3, torch.float64, "cpu",
                         torch.ones(2, dtype=torch.bool))
    with pytest.raises(TypeError):
        pr.DoublingRound(4, 2, 3, 3, torch.float64, "cpu", [True] * 3)


def test_source_names_the_jax_code_it_replaces():
    src = (Path(pr.__file__).resolve().parent.parent / "csrc" /
           "slice_doubling.cu").read_text()
    for ref in ("dynesty_tpu/internal/kernels.py:594-607", ":640-655",
                ":569-585", ":670-693"):
        assert ref in src
    assert "__dmul_rn" in src and "__dadd_rn" in src and "FMA" in src
    assert "cudaGetLastError" in src and "sm_90a" in src


def _struct_fields(src, name):
    """The pointer fields of the argument struct ``name`` in the CUDA
    source, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        m = re.match(r"\s*(?:const\s+)?[\w\s]+?\*\s*(\w+);",
                     line.split("//")[0])
        if m:
            fields.append(m.group(1))
    return fields


def test_the_argument_tables_follow_the_kernels_structs(monkeypatch):
    """Each kernel's pointer table, as ``DoublingRound`` binds it on the
    card, names the round's tensors in the order of the kernel's argument
    struct in ``csrc/slice_doubling.cu``; the likelihood's outputs and the
    first candidate's draw are left to each launch."""
    monkeypatch.setattr(pr, "_entry", lambda *a: None)
    rb = pr.DoublingRound(4, 2, 3, 2, torch.float64, "cpu",
                          torch.tensor([True, False, True]))
    rb._bind()
    names = {t.data_ptr(): k for k, t in rb.st.items()}
    for k, t in (("dirs", rb.directions), ("draw", rb.draw),
                 ("draw_x", rb.draw_x), ("loglstar", rb.loglstar),
                 ("gate", rb.gate), ("strict", rb.strict),
                 ("vote", rb.vote)):
        names[t.data_ptr()] = k
    assert len(names) == len(rb.st) + 7
    src = (Path(pr.__file__).resolve().parent.parent / "csrc" /
           "slice_doubling.cu").read_text()
    for kernel, struct in (("point", "PointArgs"), ("expand", "ExpandArgs"),
                           ("halve", "HalveArgs"), ("shrink", "ShrinkArgs")):
        table = rb._args[kernel][0]
        want = _struct_fields(src, struct)
        got = [names[p] if p is not None else None for p in table]
        assert len(got) == len(want), kernel
        for g, w in zip(got, want):
            assert g == w or (g is None and w in (
                "logl_l", "logl_x", "v_x", "draw_x")), (kernel, g, w)


# --------------------------------------------------------------------------
# whole rounds against the eager round as it was


def _parent_round(like, packed_in, start_blob, gen, kind, slices, scale,
                  loglstar, strict, dtype, timings, max_shrink_iters=10000):
    """The doubling round as the eager loop ran it: a direction capped as
    its step starts, ``torch.rand`` for every draw, the likelihood through
    ``_masked_eval``, the acceptance test through ``doubling_accept``, the
    blob through ``blob_where``."""
    q, ndim = packed_in.shape[0], like.ndim
    npdim = like.npdim
    maxlen = math.sqrt(ndim) / 2.0
    n_steps = slices * ndim if kind == "slice" else slices

    def count():
        timings.count("sync_slice")

    def one_step(u0, v0, logl0, blob0, direction):
        dirlen = torch.linalg.vector_norm(direction, dim=1)
        dirnorm = torch.where(dirlen > maxlen, dirlen / maxlen, 1.0)
        direction = direction / dirnorm[:, None]

        def feval(x, mask=None):
            u = u0 + x[:, None] * direction
            incube = unitcheck_batch(u, strict)
            if mask is not None:
                incube = incube & mask
            return (u,) + tk._masked_eval(like, u, incube)

        r0 = torch.rand((q,), generator=gen, dtype=dtype)
        left, right = -r0, 1.0 - r0
        fl, fr = feval(left)[2], feval(right)[2]
        nc = torch.full((q,), 2, dtype=torch.int64)
        n_exp = torch.zeros_like(nc)
        grow = torch.ones_like(nc)
        active = (fl > loglstar) | (fr > loglstar)
        while True:
            count()
            if not bool(active.any()):
                break
            go_left = torch.rand((q,), generator=gen, dtype=dtype) < 0.5
            width = right - left
            left = torch.where(active & go_left, left - width, left)
            right = torch.where(active & ~go_left, right + width, right)
            logl_new = feval(torch.where(go_left, left, right), active)[2]
            fl = torch.where(active & go_left, logl_new, fl)
            fr = torch.where(active & ~go_left, logl_new, fr)
            nc = nc + active
            n_exp = n_exp + active * grow
            grow = torch.where(active, (grow * 2).clamp(max=1 << 30), grow)
            active = active & ((fl > loglstar) | (fr > loglstar))
        big = (left, right, fl, fr)
        u, v, logl, blob = u0, v0, logl0, blob0
        n_con = torch.zeros_like(nc)
        active = torch.ones((q,), dtype=torch.bool)
        for _ in range(max_shrink_iters):
            count()
            if not bool(active.any()):
                break
            x = left + torch.rand((q,), generator=gen, dtype=dtype) * \
                (right - left)
            u_prop, v_prop, logl_prop, blob_prop = feval(x, active)
            nc = nc + active
            n_con = n_con + active
            good = logl_prop > loglstar
            d_acc, d_nc = tk.doubling_accept(
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

    u = packed_in[:, :ndim].to(dtype)
    v = packed_in[:, ndim:ndim + npdim].to(dtype)
    logl = packed_in[:, ndim + npdim].to(dtype)
    blob = start_blob
    axes = packed_in[:, ndim + npdim + 1:].reshape(q, ndim, ndim)
    directions = tk.slice_directions(gen, axes.to(dtype), scale, kind,
                                     slices)
    nc = n_exp = n_con = torch.zeros((q,), dtype=torch.int64)
    for s in range(n_steps):
        u, v, logl, blob, nc1, ne1, ncon1 = one_step(u, v, logl, blob,
                                                     directions[:, s])
        nc, n_exp, n_con = nc + nc1, n_exp + ne1, n_con + ncon1
    return tk.pack_columns(q, dtype, u, v, logl, nc, n_exp, n_con,
                           False), blob


def blob_ll(x):
    """A Gaussian with the blob ``(logl, x[0])``."""
    logl = -0.5 * (x * x).sum() / 0.3 ** 2
    return logl, torch.stack([logl, x[0]])


def _like(blob, dtype, device="cpu"):
    fn = blob_ll if blob else (lambda x: -0.5 * (x * x).sum() / 0.3 ** 2)
    like = LogLikelihood(fn, lambda u: 2.0 * u - 1.0, 3, device=device,
                         blob=blob, dtype=dtype)
    like.eval_host(np.full((2, 3), 0.5))
    return like


def _round_inputs(like, q, dtype, device="cpu", seed=3):
    """Start points near the edges above the round's threshold, with
    their blobs, and the lanes' axes."""
    rs = get_rstate(seed)
    u = rs.uniform(0.05, 0.95, size=(q, 3))
    v, logl, blob = like.eval_host(u)
    axes = 0.15 * (np.eye(3) + 0.3 * rs.normal(size=(q, 3, 3)))
    packed = torch.as_tensor(np.concatenate(
        [u, v, logl[:, None], axes.reshape(q, -1)], axis=1), dtype=dtype,
        device=device)
    start_blob = None if blob is None else torch.as_tensor(
        np.asarray(blob), device=device)
    return packed, start_blob, float(logl.min() - 0.5)


@pytest.mark.parametrize("kind,slices", [("rslice", 2), ("slice", 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("blob", [False, True])
def test_round_equals_the_eager_round(kind, slices, dtype, blob):
    """Rounds through the round buffers and the plain steps against the
    eager round as it was: packed columns, blob, the host reads and the
    generator's state bit for bit, two rounds on one cache."""
    q, strict = 24, [True, False, True]
    like = _like(blob, dtype)
    cache, t_new = {}, Timings()
    fn = tk.make_slice_round(like, ndim=3, q=q, slices=slices, kind=kind,
                             dtype=dtype, device="cpu", nonperiodic=strict,
                             doubling=True, timings=t_new, rounds=cache)
    for seed in (3, 4):
        packed, start_blob, loglstar = _round_inputs(like, q, dtype,
                                                     seed=seed)
        g_new, g_old = torch.Generator(), torch.Generator()
        g_new.manual_seed(seed)
        g_old.manual_seed(seed)
        t_old = Timings()
        n0 = t_new.get("sync_slice", 0)
        got, got_blob = fn(g_new, packed, start_blob, 1.3, loglstar)
        ref, ref_blob = _parent_round(like, packed, start_blob, g_old, kind,
                                      slices, 1.3, loglstar,
                                      torch.tensor(strict), dtype, t_old)
        assert torch.equal(got, ref)
        assert (got_blob is None) == (not blob)
        if blob:
            assert torch.equal(got_blob, ref_blob)
        assert torch.equal(g_new.get_state(), g_old.get_state())
        assert t_new["sync_slice"] - n0 == t_old["sync_slice"] > 20
    assert len(cache) == 1
    assert isinstance(next(iter(cache.values())), tk.DoublingGraph)
    # the CPU never captures and counts nothing of the card's
    assert not any(k in t_new for k in ("n_doubling_replay",
                                        "n_doubling_graph", "n_uncaptured"))


def test_round_cut_by_the_shrink_cap_equals_the_eager_round():
    """A cap of one shrink candidate a step leaves lanes unaccepted: the
    loop ends without its last read in both forms."""
    q, dtype = 24, torch.float64
    like = _like(False, dtype)
    packed, _, loglstar = _round_inputs(like, q, dtype, seed=8)
    # a threshold above most starts: candidates fail
    loglstar = float(packed[:, 6].max())
    t_new, t_old = Timings(), Timings()
    fn = tk.make_slice_round(like, ndim=3, q=q, slices=2, kind="rslice",
                             dtype=dtype, device="cpu", doubling=True,
                             max_shrink_iters=1, timings=t_new)
    g_new, g_old = torch.Generator(), torch.Generator()
    g_new.manual_seed(8)
    g_old.manual_seed(8)
    got, _ = fn(g_new, packed, None, 1.0, loglstar)
    ref, _ = _parent_round(like, packed, None, g_old, "rslice", 2, 1.0,
                           loglstar, None, dtype, t_old, max_shrink_iters=1)
    assert torch.equal(got, ref)
    assert torch.equal(g_new.get_state(), g_old.get_state())
    assert t_new["sync_slice"] == t_old["sync_slice"]
    # every lane's candidates were all it had: one a step
    assert torch.equal(got[:, 9], torch.full((q,), 2.0, dtype=dtype))


def test_doubling_rounds_keep_a_cache_entry_of_their_own():
    """A sampler that switches to doubling in the middle of a run keeps
    the stepping-out round and the doubling round of one shape apart."""
    q, dtype = 16, torch.float64
    like = _like(False, dtype)
    cache = {}
    packed, _, loglstar = _round_inputs(like, q, dtype, seed=9)
    for doubling in (False, True, False, True):
        fn = tk.make_slice_round(like, ndim=3, q=q, slices=2, kind="rslice",
                                 dtype=dtype, device="cpu",
                                 doubling=doubling, rounds=cache)
        gen = torch.Generator()
        gen.manual_seed(9)
        fn(gen, packed, None, 1.0, loglstar)
    kinds = sorted(type(e).__name__ for e in cache.values())
    assert kinds == ["DoublingGraph", "SliceGraph"]


# --------------------------------------------------------------------------
# the probes folded into the kernels before them


def _parent_halve(st, logl_x, loglstar):
    """The halving as it was before its probe moved into it."""
    x1, lhat, rhat = st["x1"], st["lhat"], st["rhat"]
    active = st["h_active"]
    mid = 0.5 * (lhat + rhat)
    dflag = st["dflag"] | (((0.0 < mid) & (mid <= x1)) |
                           ((x1 < mid) & (mid <= 0.0)))
    go_right = x1 < mid
    logl_mid = torch.where(st["incube"], logl_x, _NEG_INF)
    st["d_nc"] = st["d_nc"] + active
    f_rhat = torch.where(active & go_right, logl_mid, st["f_rhat"])
    rhat = torch.where(active & go_right, mid, rhat)
    f_lhat = torch.where(active & ~go_right, logl_mid, st["f_lhat"])
    lhat = torch.where(active & ~go_right, mid, lhat)
    newly = active & dflag & (loglstar >= f_lhat) & (loglstar >= f_rhat)
    st["reject"] = st["reject"] | newly
    active = active & ~newly & ((rhat - lhat) > 1.1)
    st.update(dflag=dflag, lhat=lhat, rhat=rhat, f_lhat=f_lhat,
              f_rhat=f_rhat, h_active=active, any=active.any())


def _parent_candidate(st, v_x, logl_x, loglstar):
    """A shrink candidate's outcome as it was before the first halving's
    probe moved into it: the candidate's logl masked by the cube check
    ``incube`` that its own segment's probe wrote."""
    active = st["s_active"]
    logl_c = torch.where(st["incube"], logl_x, _NEG_INF)
    good = logl_c > loglstar
    st["v_c"], st["logl_c"], st["good"] = v_x.clone(), logl_c, good
    st["nc"] = st["nc"] + active
    st["n_con"] = st["n_con"] + active
    st["h_active"] = ((st["right"] - st["left"]) > 1.1) & (active & good)
    for k, src in (("lhat", "left"), ("rhat", "right"),
                   ("f_lhat", "fl"), ("f_rhat", "fr")):
        st[k] = st[src].clone()
    for k in ("dflag", "reject", "d_nc"):
        st[k] = torch.zeros_like(st[k])
    st["any"] = st["h_active"].any()
    st["any_shrink"] = torch.zeros_like(st["any_shrink"])


def _parent_expand(st, mode, logl_x, logl_l, draw, loglstar):
    """The step's start or a doubling as it was before the next probe
    moved into it: a doubling's side read again from its own ``draw``."""
    logl_new = torch.where(st["incube"], logl_x, _NEG_INF)
    if mode == pr.X_INIT:
        fl = torch.where(st["incube_l"], logl_l, _NEG_INF)
        fr = logl_new
        st["nc"] = st["nc"] + 2
        st["grow"] = torch.ones_like(st["grow"])
        active = (fl > loglstar) | (fr > loglstar)
        st["s_active"] = torch.ones_like(st["s_active"])
        st["step"] = st["step"] + 1
    else:
        active, left, right = st["active"], st["left"], st["right"]
        go_left = draw < 0.5
        width = right - left
        st["left"] = torch.where(active & go_left, left - width, left)
        st["right"] = torch.where(active & ~go_left, right + width, right)
        fl = torch.where(active & go_left, logl_new, st["fl"])
        fr = torch.where(active & ~go_left, logl_new, st["fr"])
        grow = st["grow"]
        st["nc"] = st["nc"] + active
        st["n_exp"] = st["n_exp"] + active * grow
        st["grow"] = torch.where(active, (grow * 2).clamp(max=1 << 30), grow)
        active = active & ((fl > loglstar) | (fr > loglstar))
    st["fl"], st["fr"], st["active"] = fl, fr, active
    st["sl"], st["sr"] = st["left"].clone(), st["right"].clone()
    st["any"] = active.any()


def _parent_resolve(st, loglstar):
    """A shrink's resolution as it was before the next candidate's probe
    moved into it."""
    active, good = st["s_active"], st["good"]
    st["nc"] = st["nc"] + torch.where(active & good, st["d_nc"], 0)
    good = good & ~st["reject"]
    newly = active & good
    st["u"] = torch.where(newly[:, None], st["u_c"], st["u"])
    st["v"] = torch.where(newly[:, None], st["v_c"], st["v"])
    st["logl"] = torch.where(newly, st["logl_c"], st["logl"])
    bad = active & ~good
    x1 = st["x1"]
    st["sl"] = torch.where(bad & (x1 < 0), x1, st["sl"])
    st["sr"] = torch.where(bad & (x1 > 0), x1, st["sr"])
    st.update(s_active=bad, newly=newly, any_shrink=bad.any())


def _parent_segment(entry, name, fill=None, probed=None):
    """A segment in the parents' order, each probe at its own segment's
    start: the round gate applied by torch after the end probes, each
    doubling's new end, shrink candidate and halving's mid probed by
    ``doubling_point_plain`` (``P_DOUBLE``, ``P_SHRINK``, ``P_HALVE``)
    from the vector its own segment drew, then the update.  ``probed``
    is called with the state right after each such probe."""
    rb, st = entry.rb, entry.rb.st
    point = pr.doubling_point_plain
    args = (rb.draw, rb.directions, rb.strict)
    if fill is not None:
        fill()

    def probe(mode):
        rb._plain(point, mode, *args)
        if probed is not None:
            probed(st)

    if name == "start":
        rb._plain(point, pr.P_START_L, *args)
        st["incube_l"].masked_fill_(rb.gate, False)
        logl_l = entry._eval(st["incube_l"])[1]
        rb._plain(point, pr.P_START_R, *args)
        st["incube"].masked_fill_(rb.gate, False)
        rb._plain(_parent_expand, pr.X_INIT, entry._eval(st["incube"])[1],
                  logl_l, rb.draw, rb.loglstar)
    elif name == "double":
        probe(pr.P_DOUBLE)
        rb._plain(_parent_expand, pr.X_DOUBLE, entry._eval(st["incube"])[1],
                  None, rb.draw, rb.loglstar)
    elif name == "candidate":
        probe(pr.P_SHRINK)
        v, logl, blob = entry._eval(st["incube"])
        rb._plain(_parent_candidate, v, logl, rb.loglstar)
        if entry.blob_c is not None:
            tree_map(lambda c, b: c.copy_(b), entry.blob_c, blob)
    elif name == "halve":
        probe(pr.P_HALVE)
        rb._plain(_parent_halve, entry._eval(st["incube"])[1], rb.loglstar)
    else:
        rb._plain(_parent_resolve, rb.loglstar)
        entry.select_blob(st["newly"], entry.blob_c)


def _parent_loop(entry, gen, segment, max_shrink_iters, gate_read):
    """The round's loop in the parents' order: each segment draws its own
    vector (r0, a doubling's side, a candidate's position)."""
    rb = entry.rb

    def run(name):
        fill = (lambda: rb.draw.uniform_(generator=gen)) \
            if name in ("start", "double", "candidate") else None
        segment(entry, name, fill)
        if name == "start":
            flag, entry.gated = rb.flags.tolist()
            return flag
        return bool(rb.st["any_shrink" if name == "resolve" else "any"])

    for s in range(rb.n_steps):
        flag = run("start")
        if gate_read and s == 0 and entry.gated:
            return True
        while flag:
            flag = run("double")
        active = True
        for _ in range(max_shrink_iters):
            if not active:
                break
            flag = run("candidate")
            while flag:
                flag = run("halve")
            active = run("resolve")
    return False


def _recorded_rounds(monkeypatch, parent, q, blob, seeds, gate_second,
                     max_shrink_iters=10000, loglstar_max=False):
    """Doubling rounds on the CPU through ``DoublingGraph`` (or, with
    ``parent``, :func:`_parent_loop` and :func:`_parent_segment`): each
    segment's name, the state after it and, in the parents' order, the
    state after its probe; every likelihood call's counted lanes and
    their points; the packed columns, blobs and the generators' states
    after each round.  With ``gate_second`` the second round runs behind
    a set round gate (the fused round's prologue); with ``loglstar_max``
    the threshold is the best start's, so that candidates fail.  Asserts
    that ``any`` is false as each candidate segment starts."""
    snaps, calls, outs = [], [], []
    segment = tk.DoublingGraph.segment

    def recording(entry, name, fill=None):
        if name == "candidate":
            assert not bool(entry.rb.st["any"]), "any set at a candidate"
        probes = []
        if parent:
            _parent_segment(entry, name, fill, probed=lambda st: probes.append(
                {k: t.clone() for k, t in st.items()}))
        else:
            segment(entry, name, fill)
        snaps.append((name, {k: t.clone() for k, t in entry.rb.st.items()},
                      probes[0] if probes else None))

    orig = tk.DoublingGraph._eval

    def spy(entry, mask):
        calls.append((mask.clone(), entry.rb.st["uclamp"][mask].clone()))
        return orig(entry, mask)

    monkeypatch.setattr(tk.DoublingGraph, "segment", recording)
    monkeypatch.setattr(tk.DoublingGraph, "_eval", spy)
    dtype = torch.float64
    like = _like(blob, dtype)
    cache = {}
    for i, seed in enumerate(seeds):
        packed, start_blob, loglstar = _round_inputs(like, q, dtype,
                                                     seed=seed)
        if loglstar_max:
            loglstar = float(packed[:, 6].max())
        gen = torch.Generator()
        gen.manual_seed(seed)
        entry = tk.doubling_graph(cache, like, q, 2, 3, dtype, "cpu",
                                  torch.tensor([True, False, True]))
        if not i:
            # the buffers that no segment has written yet, alike in both
            for t in entry.rb.st.values():
                t.zero_()
        axes = packed[:, 7:].reshape(q, 3, 3)
        directions = tk.slice_directions(gen, axes, 1.3, "rslice", 2)
        gate = torch.tensor(gate_second and i == 1)
        tk.doubling_start(entry, directions, loglstar, packed[:, :3],
                          packed[:, 3:6], packed[:, 6], start_blob, gate)
        if parent:
            _parent_loop(entry, gen, recording, max_shrink_iters, True)
        else:
            tk.doubling_loop(entry, gen, max_shrink_iters=max_shrink_iters,
                             gate_read=True)
        outs.append(({k: entry.rb.st[k].clone() for k in
                      ("u", "v", "logl", "nc", "n_exp", "n_con")},
                     tree_map(torch.clone, entry.blob), gen.get_state()))
    monkeypatch.undo()
    return snaps, calls, outs


# the entries a fold writes early, or on lanes that no later read
# touches: each is checked where its next reader reads it
_PROBE_ENTRIES = ("uclamp", "incube", "incube_s", "x1", "u_c", "go_left")


def _check_against_the_parents_order(new, old):
    """After every segment every entry of the state but the probes'
    equals the parents'; each probe written early equals the parents'
    probe at that segment's start (a doubling's and a halving's on the
    lanes it counts, a candidate's on every lane; the cube check on every
    lane); a candidate's position and point equal the parents' while its
    test runs."""
    assert [n for n, _, _ in new] == [n for n, _, _ in old]
    for i, ((name, a, _), (_, b, _)) in enumerate(zip(new, old)):
        for k in b:
            if k not in _PROBE_ENTRIES:
                _same(a[k], b[k])
        if name in ("candidate", "halve"):
            for k in ("x1", "u_c"):
                _same(a[k], b[k])
        if i + 1 == len(old) or old[i + 1][2] is None:
            continue
        nxt, p = old[i + 1][0], old[i + 1][2]
        if nxt == "double":
            lanes, mask = p["active"], "incube"
            _same(a["go_left"][lanes], p["go_left"][lanes])
        elif nxt == "candidate":
            lanes, mask = torch.ones_like(p["s_active"]), "incube_s"
            for k in ("x1", "u_c"):
                _same(a[k], p[k])
        else:
            lanes, mask = p["h_active"], "incube"
        _same(a[mask], p["incube"])
        _same(a["uclamp"][lanes], p["uclamp"][lanes])


@pytest.mark.parametrize("q", [1, 37, 256])
def test_the_folded_halving_equals_the_parent_order(monkeypatch, q):
    """Whole rounds with every probe but the step's end probes written by
    the kernel before it -- the next doubling's or the first candidate's
    by ``doubling_expand``, the next candidate's by the resolution, each
    halving's by the candidate's ``doubling_shrink`` or the halving
    before -- from a vector drawn just before that kernel, and the round
    gate read by the end probes, against the same rounds in the parents'
    order (each probe at its own segment's start, from the vector its
    segment drew; the gate applied after the probes), the second round
    behind a set gate: every entry of the state after every segment but
    the probes', which equal the parents' where a later segment reads
    them; every likelihood call's counted lanes and points; the rounds'
    outputs, blobs and generators (a vector drawn for no segment given
    back); ``any`` false as every candidate starts."""
    seeds, blob = (3, 4, 5), q != 256
    new, new_calls, new_out = _recorded_rounds(
        monkeypatch, False, q, blob, seeds, True)
    old, old_calls, old_out = _recorded_rounds(
        monkeypatch, True, q, blob, seeds, True)
    names = [n for n, _, _ in new]
    assert names.count("halve") > 0 and names.count("double") > 0
    _check_against_the_parents_order(new, old)
    assert len(new_calls) == len(old_calls)
    for (ma, ua), (mb, ub) in zip(new_calls, old_calls):
        _same(ma, mb)
        _same(ua, ub)
    for (sa, ba, ga), (sb, bb, gb) in zip(new_out, old_out):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
        assert (ba is None) == (not blob)
        if blob:
            assert torch.equal(ba, bb)
        assert torch.equal(ga, gb)


@pytest.mark.parametrize("q", [1, 37])
def test_the_folded_probes_equal_the_parent_order_under_the_shrink_cap(
        monkeypatch, q):
    """Rounds cut by a shrink cap of one candidate a step, against the
    same rounds in the parents' order: the resolution that runs into the
    cap drew the next candidate's vector, which is given back, so every
    later step and round draws what the parents' order draws."""
    seeds = (8, 9)
    new, new_calls, new_out = _recorded_rounds(
        monkeypatch, False, q, False, seeds, False, max_shrink_iters=1,
        loglstar_max=True)
    old, old_calls, old_out = _recorded_rounds(
        monkeypatch, True, q, False, seeds, False, max_shrink_iters=1,
        loglstar_max=True)
    _check_against_the_parents_order(new, old)
    assert len(new_calls) == len(old_calls)
    for (ma, ua), (mb, ub) in zip(new_calls, old_calls):
        _same(ma, mb)
        _same(ua, ub)
    for (sa, _, ga), (sb, _, gb) in zip(new_out, old_out):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
        assert torch.equal(ga, gb)
    # every step ends on the cap: one candidate each, some lane still
    # shrinking
    names = [n for n, _, _ in new]
    assert names.count("candidate") == names.count("start") == 4
    cut = [st["any_shrink"] for n, st, _ in new if n == "resolve"]
    assert any(bool(c) for c in cut)


def test_an_identity_prior_transform_reads_its_probe_before_the_fold():
    """With an identity prior transform the likelihood's v is the clamped
    probe itself, which the candidate's ``doubling_shrink`` now overwrites
    with the first halving's probe: the candidate's v is kept first, and
    whole rounds equal the eager round as it was."""
    q, dtype = 24, torch.float64

    def ll(x):
        return -0.5 * (x * x).sum(-1) / 0.3 ** 2

    like = LogLikelihood(ll, lambda u: u, 3, device="cpu", dtype=dtype,
                         mode="vectorized")
    like.eval_host(np.full((2, 3), 0.5))
    seen = []
    orig = tk.DoublingGraph._eval

    def spy(self, mask):
        out = orig(self, mask)
        seen.append(out[0].data_ptr() == self.rb.st["uclamp"].data_ptr())
        return out

    fn = tk.make_slice_round(like, ndim=3, q=q, slices=2, kind="rslice",
                             dtype=dtype, device="cpu", doubling=True)
    for seed in (3, 4):
        packed, _, loglstar = _round_inputs(like, q, dtype, seed=seed)
        g_new, g_old = torch.Generator(), torch.Generator()
        g_new.manual_seed(seed)
        g_old.manual_seed(seed)
        tk.DoublingGraph._eval = spy
        try:
            got, _ = fn(g_new, packed, None, 1.3, loglstar)
        finally:
            tk.DoublingGraph._eval = orig
        ref, _ = _parent_round(like, packed, None, g_old, "rslice", 2, 1.3,
                               loglstar, None, dtype, Timings())
        assert torch.equal(got, ref)
        assert torch.equal(g_new.get_state(), g_old.get_state())
    assert seen and all(seen)


def test_the_plain_steps_keep_a_candidates_v_that_is_the_probe():
    """``doubling_shrink_plain`` given the probe's own buffer as the
    candidate's v keeps its values before the first halving's probe
    overwrites it, through the round's buffers on the CPU."""
    q, ndim = 16, 3
    st, inp = _hand_state(q, ndim, ndim, torch.float64, seed=9)
    rb = pr.DoublingRound(q, 4, ndim, ndim, torch.float64, "cpu")
    for k, t in st.items():
        rb.st[k].copy_(t)
    rb.st["uclamp"].copy_(inp["v_x"])
    rb.loglstar.copy_(inp["loglstar"])
    pr.doubling_shrink(rb, pr.S_CANDIDATE, rb.st["uclamp"], inp["logl"][0])
    assert torch.equal(rb.st["v_c"], inp["v_x"])
    ref = {k: t.clone() for k, t in st.items()}
    ref["uclamp"] = inp["v_x"].clone()
    pr.doubling_shrink_plain(ref, pr.S_CANDIDATE, inp["v_x"],
                             inp["logl"][0], inp["loglstar"])
    for k in ref:
        _same(rb.st[k], ref[k])
    assert not torch.equal(rb.st["uclamp"], inp["v_x"])


def test_the_resolution_keeps_a_candidates_v_that_was_the_probe():
    """With an identity prior transform the candidate's v is the probe
    buffer itself, which the resolution overwrites with the next
    candidate's probe: the lanes that accept take the candidate's point
    as their v (kept in ``v_c`` by the candidate's step), not the next
    probe, through the round's buffers on the CPU."""
    q, ndim = 64, 3
    st, inp = _hand_state(q, ndim, ndim, torch.float64, seed=9)
    rb = pr.DoublingRound(q, 4, ndim, ndim, torch.float64, "cpu")
    for k, t in st.items():
        rb.st[k].copy_(t)
    rb.loglstar.copy_(inp["loglstar"])
    # the candidate's probe, as the kernel before it writes it
    shr = pr._shrink_probe(rb.st, inp["draw"], None)
    for k in ("x1", "u_c", "uclamp"):
        rb.st[k].copy_(shr[k])
    rb.st["incube_s"].copy_(shr["incube"])
    rb.st["any"].fill_(False)
    cand = rb.st["uclamp"].clone()
    pr.doubling_shrink(rb, pr.S_CANDIDATE, rb.st["uclamp"], inp["logl"][0])
    raws = iter(inp["logl"][1:])
    while bool(rb.st["any"]):
        pr.doubling_halve(rb, next(raws))
    rb.draw.copy_(inp["draw_x"])
    pr.doubling_shrink(rb, pr.S_RESOLVE)
    newly, bad = rb.st["newly"], rb.st["s_active"]
    assert bool(newly.any()) and bool(bad.any())
    assert torch.equal(rb.st["v"][newly], cand[newly])
    assert not torch.equal(rb.st["uclamp"][newly], cand[newly])
    assert torch.equal(rb.st["v"][~newly], st["v"][~newly])


def test_the_wrapper_refuses_a_halvings_probe():
    """The wrapper takes the step's end probes only: every other probe is
    written by the kernel before it."""
    rb = pr.DoublingRound(4, 2, 3, 3, torch.float64, "cpu")
    for mode in (pr.P_DOUBLE, pr.P_SHRINK, pr.P_HALVE):
        with pytest.raises(ValueError, match="by the kernel before it"):
            pr.doubling_point(rb, mode)


# --------------------------------------------------------------------------
# on the card


def _sequence(rb, st, inp, kernels):
    """The segments' steps in the round's order on the hand-made state:
    the step's start (its end probes, then its state and next probe), a
    doubling with its next probe, a candidate, its halvings, its
    resolution with the next candidate's probe; through the wrappers on
    ``rb`` (``kernels``) or through the plain steps on ``st``.  Returns
    the state after each step."""
    draw, draw_x, ls = rb.draw, rb.draw_x, rb.loglstar
    raws = iter(inp["logl"])
    states = []

    def snap(d):
        states.append({k: t.clone() for k, t in d.items()})

    if kernels:
        d = rb.st
        for mode in (pr.P_START_L, pr.P_START_R):
            pr.doubling_point(rb, mode)
            snap(d)
        pr.doubling_expand(rb, pr.X_INIT, next(raws), next(raws), draw_x)
        snap(d)
        pr.doubling_expand(rb, pr.X_DOUBLE, next(raws), draw_x=draw_x)
        snap(d)
        pr.doubling_shrink(rb, pr.S_CANDIDATE, inp["v_x"], next(raws))
        snap(d)
        while bool(d["any"]):
            pr.doubling_halve(rb, next(raws))
            snap(d)
        pr.doubling_shrink(rb, pr.S_RESOLVE)
        snap(d)
        return states
    args = (draw, rb.directions, rb.strict)
    for mode in (pr.P_START_L, pr.P_START_R):
        pr.doubling_point_plain(st, mode, *args, rb.gate)
        snap(st)
    logl_r = next(raws)
    pr.doubling_expand_plain(st, pr.X_INIT, logl_r, next(raws), draw, draw_x,
                             ls, rb.strict)
    snap(st)
    pr.doubling_expand_plain(st, pr.X_DOUBLE, next(raws), None, draw, draw_x,
                             ls, rb.strict)
    snap(st)
    pr.doubling_shrink_plain(st, pr.S_CANDIDATE, inp["v_x"], next(raws), ls,
                             rb.strict)
    snap(st)
    while bool(st["any"]):
        pr.doubling_halve_plain(st, next(raws), ls, rb.strict)
        snap(st)
    pr.doubling_shrink_plain(st, pr.S_RESOLVE, None, None, ls, rb.strict,
                             draw)
    snap(st)
    return states


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [3, 15, 48])
@pytest.mark.parametrize("strict", [False, True])
def test_kernels_match_plain_on_the_card(cuda, dtype, ndim, strict):
    q, npdim = 256, ndim
    st, inp = _hand_state(q, ndim, npdim, dtype, cuda)
    rb = pr.DoublingRound(q, 4, ndim, npdim, dtype, cuda,
                          inp["strict"] if strict else None)
    for k, t in st.items():
        rb.st[k].copy_(t)
    # steps short enough in every dimension for some candidates to stay
    # in the cube and run the acceptance test
    rb.directions.copy_(inp["directions"] * (3.0 / ndim))
    rb.draw.copy_(inp["draw"])
    rb.draw_x.copy_(inp["draw_x"])
    rb.loglstar.copy_(inp["loglstar"])
    rb.gate.fill_(False)
    inp["logl"] = inp["logl"] * 4
    pr.zero_counts()
    got = _sequence(rb, None, inp, True)
    torch.cuda.synchronize()
    ref = _sequence(rb, {k: t.clone() for k, t in st.items()}, inp, False)
    # a halving at least
    assert len(got) == len(ref) >= 7
    for a, b in zip(got, ref):
        for k in b:
            _same(a[k], b[k])
    halvings = len(got) - 6
    # every probe but the end probes is written by the kernel before it
    assert pr.doubling_point.launches == 2
    assert pr.doubling_expand.launches == 2
    assert pr.doubling_halve.launches == halvings
    assert pr.doubling_shrink.launches == 2
    assert int(rb.vote) == 0


def _card_round(q, ndim, dtype, device, strict, seed=5):
    """A ``DoublingRound`` on the card holding the hand-made state, its
    steps short enough for some probes to stay in the cube; and the state
    and a segment's inputs."""
    st, inp = _hand_state(q, ndim, ndim, dtype, device, seed=seed)
    rb = pr.DoublingRound(q, 4, ndim, ndim, dtype, device,
                          inp["strict"] if strict else None)
    for k, t in st.items():
        rb.st[k].copy_(t)
    rb.directions.copy_(inp["directions"] * (3.0 / ndim))
    rb.draw.copy_(inp["draw"])
    rb.draw_x.copy_(inp["draw_x"])
    rb.loglstar.copy_(inp["loglstar"])
    rb.gate.fill_(False)
    # the probes' cube checks: some lanes in the cube
    rs = get_rstate(seed + 100)
    for k in ("incube", "incube_l", "incube_s"):
        rb.st[k].copy_(torch.as_tensor(rs.random(q) < 0.8))
    return rb, inp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [3, 48, 160])
@pytest.mark.parametrize("q", [1, 256, 1500])
def test_the_halving_writes_its_probe_and_flag_on_the_card(cuda, dtype,
                                                          ndim, q):
    """``doubling_halve`` (one block, passes over the lanes past its
    threads; at 160 dimensions its threads loop past their loaded rows)
    and a candidate's ``doubling_shrink`` with the next halving's
    probe against their plain versions, every entry of the state bit for
    bit, the halving from a stale ``any`` flag of either value; a state
    where a lane halves on and one where none does."""
    outcomes = set()
    for name in ("halve", "candidate", "none_halve"):
        for stale in (False, True):
            rb, inp = _card_round(q, ndim, dtype, cuda, strict=True)
            if name == "none_halve":
                rb.st["h_active"].fill_(False)
            # a candidate starts with the flag false (the loop before it
            # ended on it); a halving with whatever the segment before it
            # left
            rb.st["any"].fill_(stale and name != "candidate")
            ref = {k: t.clone() for k, t in rb.st.items()}
            raw = inp["logl"][1] * 4
            if name == "candidate":
                pr.doubling_shrink(rb, pr.S_CANDIDATE, inp["v_x"], raw)
                pr.doubling_shrink_plain(ref, pr.S_CANDIDATE, inp["v_x"],
                                         raw, rb.loglstar, rb.strict)
            else:
                pr.doubling_halve(rb, raw)
                pr.doubling_halve_plain(ref, raw, rb.loglstar, rb.strict)
            torch.cuda.synchronize()
            for k in ref:
                _same(rb.st[k], ref[k])
            outcomes.add(bool(ref["any"]))
            if name == "none_halve":
                assert not bool(rb.st["any"])
    if q > 1:
        assert outcomes == {False, True}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [2, 3, 15])
@pytest.mark.parametrize("q", [1, 256, 1500])
def test_the_expansion_and_resolution_write_their_probes_on_the_card(
        cuda, dtype, ndim, q):
    """``doubling_expand`` in both modes, with the next probe of each lane
    (the next doubling's or the first candidate's, from two draw
    vectors), and the resolution's ``doubling_shrink`` with the next
    candidate's, against their plain versions: every entry of the state
    bit for bit, from a stale ``any`` flag of either value (the expansion
    clears and raises it in one launch, its count word left zero; a
    resolution starts with ``any_shrink`` false, as the candidate leaves
    it)."""
    kinds = set()
    for name in ("init", "double", "resolve"):
        for stale in (False, True):
            rb, inp = _card_round(q, ndim, dtype, cuda, strict=True)
            rb.st["any"].fill_(stale)
            rb.st["any_shrink"].fill_(False)
            ref = {k: t.clone() for k, t in rb.st.items()}
            raw, raw_l = inp["logl"][1] * 4, inp["logl"][2] * 4
            if name == "resolve":
                pr.doubling_shrink(rb, pr.S_RESOLVE)
                pr.doubling_shrink_plain(ref, pr.S_RESOLVE, None, None,
                                         rb.loglstar, rb.strict, rb.draw)
            else:
                mode = pr.X_INIT if name == "init" else pr.X_DOUBLE
                pr.doubling_expand(rb, mode, raw, raw_l, rb.draw_x)
                pr.doubling_expand_plain(ref, mode, raw, raw_l, rb.draw,
                                         rb.draw_x, rb.loglstar, rb.strict)
                kinds.add((name, bool(ref["active"].any()),
                           bool((~ref["active"]).any())))
            torch.cuda.synchronize()
            for k in ref:
                _same(rb.st[k], ref[k])
            assert int(rb.vote) == 0
    if q > 1:
        # lanes that double on and lanes that stop, in both modes
        assert kinds == {("init", True, True), ("double", True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 32, 256, 1500])
def test_the_expansion_flag_is_voted_across_blocks_on_the_card(cuda, q):
    """The ``any`` flag of ``doubling_expand`` at 3 dimensions (32 lanes a
    block: one block at q 1 and 32, 8 and 47 blocks at 256 and 1,500)
    where no lane, only the first, only the last and every lane doubles
    on, from a stale flag of either value, against the plain version."""
    dtype = torch.float64
    for lanes in ("none", "first", "last", "all"):
        for stale in (False, True):
            rb, inp = _card_round(q, 3, dtype, cuda, strict=False)
            on = torch.zeros(q, dtype=torch.bool, device=cuda)
            if lanes == "all":
                on.fill_(True)
            elif lanes != "none":
                on[0 if lanes == "first" else q - 1] = True
            rb.st["active"].copy_(on)
            rb.st["fl"].fill_(3.0)
            rb.st["fr"].fill_(3.0)
            rb.st["any"].fill_(stale)
            ref = {k: t.clone() for k, t in rb.st.items()}
            raw = inp["logl"][1]
            pr.doubling_expand(rb, pr.X_DOUBLE, raw, draw_x=rb.draw_x)
            pr.doubling_expand_plain(ref, pr.X_DOUBLE, raw, None, rb.draw,
                                     rb.draw_x, rb.loglstar, rb.strict)
            torch.cuda.synchronize()
            for k in ref:
                _same(rb.st[k], ref[k])
            assert bool(rb.st["any"]) == (lanes != "none")
            assert int(rb.vote) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("gated", [False, True])
def test_the_end_probes_read_the_round_gate_on_the_card(cuda, dtype, gated):
    """``doubling_point``'s end probes against their plain versions with
    the round gate set and clear: behind a set gate no lane counts."""
    q, ndim = 256, 3
    rb, inp = _card_round(q, ndim, dtype, cuda, strict=True)
    rb.gate.fill_(gated)
    ref = {k: t.clone() for k, t in rb.st.items()}
    for mode, key in ((pr.P_START_L, "incube_l"), (pr.P_START_R, "incube")):
        pr.doubling_point(rb, mode)
        pr.doubling_point_plain(ref, mode, rb.draw, rb.directions,
                                rb.strict, rb.gate)
        torch.cuda.synchronize()
        for k in ref:
            _same(rb.st[k], ref[k])
        assert bool(rb.st[key].any()) != gated


def _card_rounds(like, q, kind, slices, dtype, device, seeds, cache,
                 timings):
    fn = tk.make_slice_round(
        like, ndim=3, q=q, slices=slices, kind=kind, dtype=dtype,
        device=device, nonperiodic=[True, False, True], doubling=True,
        timings=timings, rounds=cache)
    outs = []
    for seed in seeds:
        packed, start_blob, loglstar = _round_inputs(like, q, dtype, device,
                                                     seed)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        packed_out, blob = fn(gen, packed, start_blob, 1.3, loglstar)
        torch.cuda.synchronize()
        outs.append((packed_out, blob, gen.get_offset()))
    return outs


class _EagerLike(LogLikelihood):
    """A likelihood the rule keeps out of a graph: its rounds launch
    every segment eagerly, through the same kernels."""

    def capturable(self):
        return False


@pytest.mark.cuda
@pytest.mark.parametrize("kind,slices", [("rslice", 3), ("slice", 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_round_equals_the_eager_round_on_the_card(cuda, kind,
                                                           slices, dtype):
    q, seeds = 256, (11, 12, 13)
    like = _like(True, dtype, cuda)
    eager = _EagerLike(blob_ll, lambda u: 2.0 * u - 1.0, 3, device=cuda,
                       blob=True, dtype=dtype)
    eager.eval_host(np.full((2, 3), 0.5))
    t_g, t_e = Timings(), Timings()
    got = _card_rounds(like, q, kind, slices, dtype, cuda, seeds, {}, t_g)
    ref = _card_rounds(eager, q, kind, slices, dtype, cuda, seeds, {}, t_e)
    for (p, b, off), (pe, be, offe) in zip(got, ref):
        assert torch.equal(p, pe) and torch.equal(b, be) and off == offe
    assert t_g["sync_slice"] == t_e["sync_slice"]
    # five segment kinds, each warmed up once and captured once; every
    # other segment replayed
    assert t_g["n_doubling_graph"] == 5 and t_g["n_uncaptured"] == 5
    assert t_g["n_doubling_replay"] + 5 == t_e["n_uncaptured"]
    assert "n_doubling_replay" not in t_e


@pytest.mark.cuda
def test_a_card_run_never_takes_the_plain_steps(cuda, monkeypatch):
    """A doubling run on the card launches the four kernels for every
    segment (a replay counting its segment's launches) and never a plain
    step."""
    import dynesty_tpu_torch as dyt
    from dynesty_tpu_torch.internal.samplers import RSliceSampler

    def guarded(name):
        plain = getattr(pr, name)

        def fn(st, *a, **kw):
            assert all(t.device.type == "cpu" for t in st.values()), \
                f"{name} on the card"
            return plain(st, *a, **kw)
        return fn

    for name in ("doubling_point_plain", "doubling_expand_plain",
                 "doubling_halve_plain", "doubling_shrink_plain"):
        monkeypatch.setattr(pr, name, guarded(name))
    # the uniform rounds behind a fused round's gate: one wave each, whose
    # read counts as sync_round
    gated, loop = [], tk.unif_loop

    def unif_loop(*a, **kw):
        gated.append(loop(*a, **kw))
        return gated[-1]

    monkeypatch.setattr(tk, "unif_loop", unif_loop)
    pr.zero_counts()
    s = dyt.NestedSampler(lambda x: -0.5 * (x @ x),
                          lambda u: 10.0 * (2.0 * u - 1.0), 3, nlive=200,
                          bound="single",
                          sample=RSliceSampler(slice_doubling=True),
                          queue_size=32, rstate=get_rstate())
    s.run_nested(print_progress=False, dlogz=0.5)
    t = s.timings
    segments = pr.doubling_expand.launches + pr.doubling_halve.launches + \
        pr.doubling_shrink.launches
    assert segments > 0 and t["n_doubling_graph"] == 5
    assert t["n_doubling_replay"] + 5 == segments
    # the warm-ups, and the unit-cube phase's eager waves
    assert t["n_uncaptured"] - (t["sync_wave"] + sum(gated) -
                                t["n_unif_replay"]) == 5


def _syncing_ll(x):
    # a host read inside the likelihood: legal eagerly, not in a capture
    return -0.5 * (x * x).sum(-1) + 0.0 * float(x.sum().item() > 1e300)


@pytest.mark.cuda
def test_a_capture_that_raises_warns_once_and_runs_eagerly(cuda):
    dtype, q = torch.float64, 64
    like = LogLikelihood(_syncing_ll, lambda u: 2.0 * u - 1.0, 3,
                         device=cuda, mode="vectorized", dtype=dtype)
    like.eval_host(np.full((2, 3), 0.5))
    eager = _EagerLike(_syncing_ll, lambda u: 2.0 * u - 1.0, 3, device=cuda,
                       mode="vectorized", dtype=dtype)
    eager.eval_host(np.full((2, 3), 0.5))
    t, te = Timings(), Timings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _card_rounds(like, q, "rslice", 2, dtype, cuda, (1, 2), {}, t)
    ref = _card_rounds(eager, q, "rslice", 2, dtype, cuda, (1, 2), {}, te)
    msgs = [str(x.message) for x in w if "CUDA graph" in str(x.message)]
    assert len(msgs) == 1
    assert "n_doubling_replay" not in t
    assert t["n_uncaptured"] == te["n_uncaptured"]
    for (p, _, off), (pe, _, offe) in zip(got, ref):
        assert torch.equal(p, pe) and off == offe


@pytest.mark.cuda
def test_a_later_capture_that_raises_leaves_the_shape_wholly_eager(
        cuda, monkeypatch):
    """A segment whose capture raises after others of the shape were
    captured leaves every segment of the shape eager, as its warning says:
    no replay follows the failure, and the rounds equal eager ones."""
    segment, replay = tk.DoublingGraph.segment, tk.DoublingGraph.replay

    def failing(self, name, fill=None):
        if name == "resolve" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the resolution cannot be captured")
        return segment(self, name, fill)

    def checked(self, name, gen):
        assert self.capturable, "a replay after a capture raised"
        return replay(self, name, gen)

    monkeypatch.setattr(tk.DoublingGraph, "segment", failing)
    monkeypatch.setattr(tk.DoublingGraph, "replay", checked)
    dtype, q = torch.float64, 64
    like = _like(True, dtype, cuda)
    eager = _EagerLike(blob_ll, lambda u: 2.0 * u - 1.0, 3, device=cuda,
                       blob=True, dtype=dtype)
    eager.eval_host(np.full((2, 3), 0.5))
    cache, t, te = {}, Timings(), Timings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _card_rounds(like, q, "rslice", 2, dtype, cuda, (1, 2, 3),
                           cache, t)
    ref = _card_rounds(eager, q, "rslice", 2, dtype, cuda, (1, 2, 3), {}, te)
    msgs = [str(x.message) for x in w if "CUDA graph" in str(x.message)]
    assert len(msgs) == 1 and "resolve" in msgs[0]
    (entry,) = cache.values()
    assert entry.graphs == {} and not entry.capturable
    assert t["n_doubling_graph"] > 0
    assert t["n_doubling_replay"] + t["n_uncaptured"] == te["n_uncaptured"]
    for (p, b, off), (pe, be, offe) in zip(got, ref):
        assert torch.equal(p, pe) and torch.equal(b, be) and off == offe


@pytest.mark.cuda
def test_a_second_capture_that_raises_leaves_the_round_wholly_eager(
        cuda, monkeypatch):
    """The shape's second segment capture raises, after its first was
    captured and replayed: from the raise on no segment replays (the
    shape is wholly eager, as its warning says), and the rounds equal
    eager ones bit for bit, the generator's offset included."""
    segment, capture = tk.DoublingGraph.segment, tk.DoublingGraph.capture
    replay = tk.DoublingGraph.replay
    attempts, late = [], []

    def counted(self, name):
        attempts.append(name)
        return capture(self, name)

    def failing(self, name, fill=None):
        if len(attempts) == 2 and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the second segment cannot be captured")
        return segment(self, name, fill)

    def checked(self, name, gen):
        if not self.capturable:
            late.append(name)
        return replay(self, name, gen)

    monkeypatch.setattr(tk.DoublingGraph, "capture", counted)
    monkeypatch.setattr(tk.DoublingGraph, "segment", failing)
    monkeypatch.setattr(tk.DoublingGraph, "replay", checked)
    dtype, q = torch.float64, 64
    like = _like(True, dtype, cuda)
    eager = _EagerLike(blob_ll, lambda u: 2.0 * u - 1.0, 3, device=cuda,
                       blob=True, dtype=dtype)
    eager.eval_host(np.full((2, 3), 0.5))
    cache, t, te = {}, Timings(), Timings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = _card_rounds(like, q, "rslice", 2, dtype, cuda, (1, 2, 3),
                           cache, t)
    ref = _card_rounds(eager, q, "rslice", 2, dtype, cuda, (1, 2, 3), {}, te)
    msgs = [str(x.message) for x in w if "CUDA graph" in str(x.message)]
    assert len(msgs) == 1 and attempts[1] in msgs[0]
    (entry,) = cache.values()
    assert entry.graphs == {} and not entry.capturable and not late
    assert t["n_doubling_graph"] == 1 and t["n_doubling_replay"] >= 1
    assert t["n_doubling_replay"] + t["n_uncaptured"] == te["n_uncaptured"]
    for (p, b, off), (pe, be, offe) in zip(got, ref):
        assert torch.equal(p, pe) and torch.equal(b, be) and off == offe
