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
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import dynesty_tpu_torch.internal.kernels as tk
from dynesty_tpu_torch.internal.likelihood import LogLikelihood
from dynesty_tpu_torch.ops import proposals as pr
from dynesty_tpu_torch.ops.geometry import unitcheck_batch
from dynesty_tpu_torch.utils.misc import Timings, blob_where

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
              "incube_l"):
        st[k].zero_()
    st["any"].fill_(True)
    st["any_shrink"].fill_(True)
    draw = rs.random(q)
    draw[lane % 9 == 0] = 0.5
    draw[lane % 11 == 1] = 0.0
    inp = {"directions": t(rs.normal(size=(q, n_steps, ndim)) * 0.4),
           "draw": t(draw), "loglstar": t(ls),
           "strict": t([d != 1 for d in range(ndim)], torch.bool),
           "logl": [t(rs.choice(vals + [0.5, 2.0], q)) for _ in range(8)],
           "v_x": t(rs.random((q, npdim)))}
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("strict", [False, True])
def test_plain_start_and_doubling_equal_the_eager_body(dtype, strict):
    st, inp = _hand_state(64, 3, 2, dtype)
    ls, draw = inp["loglstar"], inp["draw"]
    sm = inp["strict"] if strict else None
    s = int(st["step"])
    # the step's start: both end probes, then the start state
    ref0 = {k: t.clone() for k, t in st.items()}
    pr.doubling_point_plain(st, pr.P_START_L, draw, inp["directions"], sm)
    seen = [(st["uclamp"], st["incube_l"])]
    pr.doubling_point_plain(st, pr.P_START_R, draw, inp["directions"], sm)
    seen.append((st["uclamp"], st["incube"]))
    pr.doubling_expand_plain(st, pr.X_INIT, inp["logl"][1], inp["logl"][0],
                             draw, ls)
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

    # one doubling, from the hand-made state (grow at its clamp among it)
    st, inp = _hand_state(64, 3, 2, dtype, seed=6)
    ref0 = {k: t.clone() for k, t in st.items()}
    pr.doubling_point_plain(st, pr.P_DOUBLE, draw, inp["directions"], sm)
    seen = (st["uclamp"], st["incube"])
    assert not bool(st["any"])
    pr.doubling_expand_plain(st, pr.X_DOUBLE, inp["logl"][2], None, draw,
                             ls)
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("strict", [False, True])
def test_plain_shrink_and_halving_equal_the_eager_body(dtype, strict):
    """A shrink candidate, its halvings and its resolution against the
    eager shrink body with its acceptance test (``doubling_accept``),
    both reading the same raw likelihoods call by call."""
    st, inp = _hand_state(64, 3, 2, dtype, seed=7)
    ls, draw = inp["loglstar"], inp["draw"]
    sm = inp["strict"] if strict else None
    raws = inp["logl"]
    ref0 = {k: t.clone() for k, t in st.items()}
    pr.doubling_point_plain(st, pr.P_SHRINK, draw, inp["directions"], sm)
    seen = [(st["uclamp"], st["incube"])]
    pr.doubling_shrink_plain(st, pr.S_CANDIDATE, inp["v_x"], raws[0], ls)
    assert not bool(st["any_shrink"])
    halvings = 0
    while bool(st["any"]):
        pr.doubling_point_plain(st, pr.P_HALVE, draw, inp["directions"], sm)
        seen.append((st["uclamp"], st["incube"]))
        halvings += 1
        pr.doubling_halve_plain(st, raws[halvings], ls)
    pr.doubling_shrink_plain(st, pr.S_RESOLVE, None, None, ls)

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

    assert len(seen) == len(feval.seen) == halvings + 1 and halvings >= 2
    for (a, b), (c, d) in zip(seen, feval.seen):
        _same(a, c)
        _same(b, d)
    for k, ref in (("u", u), ("v", v), ("logl", logl), ("nc", nc),
                   ("n_con", ref0["n_con"] + active), ("sl", left),
                   ("sr", right), ("s_active", bad), ("newly", newly),
                   ("x1", x)):
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
                       inp["draw"], rb.loglstar))):
        fn(ref, *args)
    pr.doubling_point(rb, pr.P_START_L)
    pr.doubling_point(rb, pr.P_START_R)
    pr.doubling_expand(rb, pr.X_INIT, inp["logl"][1], inp["logl"][0])
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
# on the card


def _sequence(rb, st, inp, kernels):
    """The segments' steps in the round's order on the hand-made state:
    the step's start, a doubling, a candidate, its halvings, its
    resolution; through the wrappers on ``rb`` (``kernels``) or through
    the plain steps on ``st``.  Returns the state after each step."""
    draw, ls = rb.draw, rb.loglstar
    raws = iter(inp["logl"])
    states = []

    def snap(d):
        states.append({k: t.clone() for k, t in d.items()})

    if kernels:
        d = rb.st
        for mode in (pr.P_START_L, pr.P_START_R):
            pr.doubling_point(rb, mode)
            snap(d)
        pr.doubling_expand(rb, pr.X_INIT, next(raws), next(raws))
        snap(d)
        pr.doubling_point(rb, pr.P_DOUBLE)
        pr.doubling_expand(rb, pr.X_DOUBLE, next(raws))
        snap(d)
        pr.doubling_point(rb, pr.P_SHRINK)
        pr.doubling_shrink(rb, pr.S_CANDIDATE, inp["v_x"], next(raws))
        snap(d)
        while bool(d["any"]):
            pr.doubling_point(rb, pr.P_HALVE)
            pr.doubling_halve(rb, next(raws))
            snap(d)
        pr.doubling_shrink(rb, pr.S_RESOLVE)
        snap(d)
        return states
    args = (draw, rb.directions, rb.strict)
    for mode in (pr.P_START_L, pr.P_START_R):
        pr.doubling_point_plain(st, mode, *args)
        snap(st)
    logl_r = next(raws)
    pr.doubling_expand_plain(st, pr.X_INIT, logl_r, next(raws), draw, ls)
    snap(st)
    pr.doubling_point_plain(st, pr.P_DOUBLE, *args)
    pr.doubling_expand_plain(st, pr.X_DOUBLE, next(raws), None, draw, ls)
    snap(st)
    pr.doubling_point_plain(st, pr.P_SHRINK, *args)
    pr.doubling_shrink_plain(st, pr.S_CANDIDATE, inp["v_x"], next(raws), ls)
    snap(st)
    while bool(st["any"]):
        pr.doubling_point_plain(st, pr.P_HALVE, *args)
        pr.doubling_halve_plain(st, next(raws), ls)
        snap(st)
    pr.doubling_shrink_plain(st, pr.S_RESOLVE, None, None, ls)
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
    rb.loglstar.copy_(inp["loglstar"])
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
    assert pr.doubling_point.launches == 4 + halvings
    assert pr.doubling_expand.launches == 2
    assert pr.doubling_halve.launches == halvings
    assert pr.doubling_shrink.launches == 2


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
