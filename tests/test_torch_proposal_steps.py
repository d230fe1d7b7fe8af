"""The proposal loops' per-step updates (``dynesty_tpu_torch/ops/
proposals.py``): the factored loops against the JAX package's jitted
rounds fed with the JAX package's own draws, the plain steps against the
eager code they were moved from, the wrappers' checks, and on a card the
``slice_step`` and ``rwalk_step`` kernels against the plain steps.

Tolerances.  Fed the JAX package's draws (its key schedule rebuilt here),
the port's state machine and walk take the same steps: every integer
column (``nc``, ``n_expand``, ``n_contract``, ``warn``, ``n_accept``,
``n_reject``) is equal, and u, v and logl agree to 1e-12 relative in
float64 (XLA and torch round the likelihood, the direction norm and the
axes product differently in the last ulp; an absolute 1e-15 admits a
periodic wrap that lands next to 0).  The plain steps are the eager code
itself, and on the card the kernels round every operation as the eager
ops do: both bit for bit.

The JAX package is imported by a fixture, and its comparisons run only
under ``tests/conftest.py`` (JAX on the CPU in float64), so that the card
tests of this file run on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_proposal_steps.py
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import dynesty_tpu_torch.internal.kernels as tk
from dynesty_tpu_torch.internal.likelihood import LogLikelihood
from dynesty_tpu_torch.ops import build
from dynesty_tpu_torch.ops import proposals as pr
from dynesty_tpu_torch.ops.geometry import unitcheck_batch, wrap_boundaries

from utils import get_rstate

torch.set_num_threads(1)

Q, SIGMA = 32, 0.1
RTOL, ATOL = 1e-12, 1e-15
_NEG_INF = -math.inf


@pytest.fixture(scope="module")
def jx():
    """jax, jax.numpy and the JAX package's kernels, likelihood and
    geometry modules."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("the JAX comparisons run under tests/conftest.py "
                    "(JAX on the CPU in float64)")
    import jax.numpy as jnp

    import dynesty_tpu.internal.kernels as jk
    import dynesty_tpu.internal.likelihood as jlike
    import dynesty_tpu.ops.geometry as jgeo
    return jax, jnp, jk, jlike, jgeo


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


def _likes(jx, ndim, sigma, centre=0.5):
    """The Gaussian at ``centre`` in both packages (identity prior)."""
    jnp, jlike = jx[1], jx[3]
    start = np.full((2, ndim), centre)
    jl = jlike.LogLikelihood(
        lambda v: -0.5 * jnp.sum((v - centre) ** 2) / sigma ** 2,
        lambda u: u, ndim)
    jl.eval_host(start)
    tl = LogLikelihood(lambda v: -0.5 * ((v - centre) ** 2).sum() /
                       sigma ** 2, lambda u: u, ndim, device="cpu")
    tl.eval_host(start)
    return jl, tl


def _starts(rs, ndim, sigma, lo=0.4, hi=0.6, centre=0.5):
    """Start points, their logl, and a threshold below all of them."""
    u = rs.uniform(lo, hi, size=(Q, ndim))
    logl = -0.5 * ((u - centre) ** 2).sum(1) / sigma ** 2
    return u, logl, float(logl.min() - 1.0)


def _assert_columns(got, ref, ints):
    """Float columns to RTOL/ATOL, integer columns equal."""
    for name in ("u", "v", "logl"):
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for name in ints:
        assert np.array_equal(got[name], ref[name]), name


# --------------------------------------------------------------------------
# the stepping-out state machine, fed the JAX package's draws


def _jax_slice(jx, ndim, kind, slices, scale, nonperiodic, seed):
    """The JAX round and the port's state machine on its draws: both
    results as dicts of numpy columns, and the port's iterations."""
    jax, jnp, jk = jx[:3]
    rs = get_rstate(seed)
    u, logl, loglstar = _starts(rs, ndim, SIGMA)
    axes = 0.05 * (np.eye(ndim) + 0.3 * rs.normal(size=(Q, ndim, ndim)))
    jl, tl = _likes(jx, ndim, SIGMA)
    packed_in = np.concatenate([u, u, logl[:, None], axes.reshape(Q, -1)],
                               axis=1)
    key = jax.random.PRNGKey(seed)
    jfn = jk.make_slice_round(jl, ndim=ndim, q=Q, slices=slices, kind=kind,
                              nonperiodic=nonperiodic, dtype=jnp.float64)
    packed, _ = jfn(key, jnp.asarray(packed_in), None, scale, loglstar)
    packed = np.asarray(packed)
    ref = {"u": packed[:, :ndim], "v": packed[:, ndim:2 * ndim],
           "logl": packed[:, 2 * ndim], "nc": packed[:, 2 * ndim + 1],
           "n_exp": packed[:, 2 * ndim + 2],
           "n_con": packed[:, 2 * ndim + 3],
           "warn": packed[0, 2 * ndim + 4]}

    # the JAX round's key schedule: directions (capped at the cube
    # diagonal as the round caps them), the first intervals, then one
    # (2, q) uniform draw per iteration from fold_in(kloop, it)
    kdir, kr0, kloop = jax.random.split(key, 3)
    make_dirs = _closure_fn(jfn, "_make_directions")
    assert make_dirs is not None
    dirs = make_dirs(kdir, jnp.asarray(axes), scale)
    dirlen = jnp.linalg.norm(dirs, axis=-1)
    maxlen = math.sqrt(ndim) / 2.0
    dirs = dirs / jnp.where(dirlen > maxlen, dirlen / maxlen, 1.0)[..., None]
    r0 = jax.random.uniform(kr0, (Q,), dtype=jnp.float64)
    block = jax.jit(jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(kloop, i), (2, Q), dtype=jnp.float64)))
    cache = {}

    def draw(it):
        b = it // 1024
        if b not in cache:
            cache[b] = np.asarray(block(jnp.arange(1024 * b, 1024 * b + 1024,
                                                   dtype=jnp.int32)))
        return torch.from_numpy(cache[b][it % 1024].copy())

    iters = []

    def counted(it):
        iters.append(it)
        return draw(it)

    start = torch.from_numpy(u)
    st, _ = tk.slice_state_machine(
        tl, torch.from_numpy(np.array(dirs)),
        torch.from_numpy(np.array(r0)), counted, loglstar, start,
        start.clone(), torch.from_numpy(logl),
        strict=tk._bool_mask(nonperiodic, "cpu"))
    got = {k: st[k].numpy() for k in ("u", "v", "logl", "nc", "n_exp",
                                      "n_con", "warn")}
    assert iters == list(range(len(iters)))
    return got, ref, len(iters)


@pytest.mark.parametrize("kind,nonperiodic", [
    ("rslice", None), ("slice", None),
    ("rslice", [True, False, True]), ("slice", [False, True, True])])
def test_state_machine_matches_jax(jx, kind, nonperiodic):
    got, ref, iters = _jax_slice(jx, 3, kind, 2, 1.0, nonperiodic, 11)
    _assert_columns(got, ref, ("nc", "n_exp", "n_con"))
    assert bool(got["warn"]) == bool(ref["warn"]) is False
    # every lane took its slice updates: each one at least two end probes
    # and one shrink; the loop ran to the last lane's end
    n_steps = 2 * (3 if kind == "slice" else 1)
    assert np.all(got["nc"] >= 3 * n_steps)
    assert np.all(got["n_con"] >= n_steps) and got["n_exp"].sum() > 0
    assert iters == got["nc"].max()


def test_state_machine_warning_matches_jax(jx):
    """A scale so small that the intervals step out more than 1000 times:
    the sticky warning is set in both packages, on the same lanes'
    counts."""
    got, ref, iters = _jax_slice(jx, 3, "rslice", 1, 4e-3, None, 12)
    _assert_columns(got, ref, ("nc", "n_exp", "n_con"))
    assert bool(got["warn"]) and bool(ref["warn"])
    assert got["n_exp"].max() > 1000 and iters > 1000


# --------------------------------------------------------------------------
# the random walk, fed the JAX package's draws


@pytest.mark.parametrize("ndim,ncdim,periodic,reflective,nonbounded", [
    (3, 3, None, None, None),
    (4, 3, [0], [1, 3], [True, True, False, True])])
def test_walk_matches_jax(jx, ndim, ncdim, periodic, reflective,
                          nonbounded):
    jax, jnp, jk, _, jgeo = jx
    walks, scale, sigma, seed = 25, 0.8, 0.5, 13
    rs = get_rstate(seed)
    # start near the edges so that steps leave the cube and wrap
    u, logl, loglstar = _starts(rs, ndim, sigma, lo=0.02, hi=0.98)
    axes = 0.3 * (np.eye(ncdim) + 0.2 * rs.normal(size=(Q, ncdim, ncdim)))
    jl, tl = _likes(jx, ndim, sigma)
    packed_in = np.concatenate([u, u, logl[:, None], axes.reshape(Q, -1)],
                               axis=1)
    key = jax.random.PRNGKey(seed)
    jfn = jk.make_rwalk_round(jl, ndim=ndim, ncdim=ncdim, q=Q, walks=walks,
                              nonbounded=nonbounded, periodic=periodic,
                              reflective=reflective, dtype=jnp.float64)
    packed, _ = jfn(key, jnp.asarray(packed_in), None, scale, loglstar)
    packed = np.asarray(packed)
    ref = {"u": packed[:, :ndim], "v": packed[:, ndim:2 * ndim],
           "logl": packed[:, 2 * ndim], "n_acc": packed[:, 2 * ndim + 1],
           "n_rej": packed[:, 2 * ndim + 2]}

    # the JAX round's key schedule: one key per step, split into the
    # unit-ball draw and the extra dimensions' uniforms
    keys = jax.random.split(key, walks)
    steps = []

    def draw(step):
        steps.append(step)
        kd, ke = jax.random.split(keys[step])
        dr = jgeo.randsphere_batch(kd, (Q,), ncdim, dtype=jnp.float64)
        u_ex = jax.random.uniform(ke, (Q, ndim - ncdim), dtype=jnp.float64) \
            if ncdim < ndim else None
        return torch.from_numpy(np.array(dr)), \
            None if u_ex is None else torch.from_numpy(np.array(u_ex))

    start = torch.from_numpy(u)
    st, _ = tk.rwalk_walk(
        tl, start, start.clone(), torch.from_numpy(logl),
        torch.from_numpy(axes), scale, loglstar, draw, walks=walks,
        periodic=tk._mask_from_indices(periodic, ndim),
        reflective=tk._mask_from_indices(reflective, ndim),
        nonbounded=tk._bool_mask(nonbounded, "cpu"))
    got = {k: st[k].numpy() for k in ("u", "v", "logl", "n_acc", "n_rej")}
    assert steps == list(range(walks))
    _assert_columns(got, ref, ("n_acc", "n_rej"))
    assert np.all(got["n_acc"] + got["n_rej"] == walks)
    assert 0 < got["n_acc"].sum() < Q * walks
    if periodic:
        # steps left the cube through the wrapped and reflected dimensions
        # and came back inside it
        strict = np.asarray(nonbounded)
        assert (got["u"] != u)[:, periodic + reflective].any()
        assert np.all((got["u"][:, strict] > 0) & (got["u"][:, strict] < 1))


# --------------------------------------------------------------------------
# the plain steps against the eager code they were moved from


def slice_state(q, ndim, npdim, dtype=torch.float64, device="cpu",
                n_steps=3, seed=5):
    """A hand-made state machine state and one iteration's inputs: every
    phase, lanes done (s == n_steps), intervals on both sides of 0, exp
    counts next to the warning's 1000, and likelihood values above,
    below and at the threshold, +-inf among them."""
    rs = get_rstate(seed)
    lane = np.arange(q)
    s = np.where(lane % 7 == 6, n_steps, lane % n_steps)
    left = -rs.random(q) * 2.0
    right = rs.random(q) * 2.0
    loglstar = 0.25
    fl = rs.choice([_NEG_INF, -1.0, 0.25, 1.0], size=q)
    fr = rs.choice([_NEG_INF, -1.0, 0.25, 1.0], size=q)
    logl_x = rs.choice([_NEG_INF, -2.0, 0.25, 0.5, 3.0, math.inf], size=q)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    i64 = torch.int64
    u0 = rs.random((q, ndim))
    st = {
        "s": t(s, i64), "phase": t(lane % 5, i64), "left": t(left),
        "right": t(right), "fl": t(fl), "fr": t(fr),
        "u": t(rs.random((q, ndim))), "v": t(rs.random((q, npdim))),
        "logl": t(rs.normal(size=q)), "u0": t(u0),
        "nc": t(rs.integers(0, 50, q), i64),
        "n_exp": t(rs.integers(0, 50, q), i64),
        "n_con": t(rs.integers(0, 50, q), i64),
        "exp_step": t(np.where(lane % 3 == 0, 1000, rs.integers(0, 999, q)),
                      i64),
        "warn": t(False, torch.bool), "any_active": t(True, torch.bool)}
    inputs = {
        "u_sh": t(rs.random(q)), "u_r0": t(rs.random(q)),
        "directions": t(rs.normal(size=(q, n_steps, ndim)) * 0.3),
        "logl_x": t(logl_x), "v_x": t(rs.random((q, npdim))),
        "loglstar": t(loglstar), "n_steps": n_steps,
        "strict": t(rs.random(ndim) < 0.7, torch.bool)}
    return st, inputs


def _eager_slice_iteration(st, u_sh, u_r0, directions, logl_x, v_x,
                           loglstar, nb):
    """One iteration of the state machine as the eager loop of
    ``make_slice_round`` wrote it before its steps were factored out, the
    likelihood's raw values given (masked to -inf outside the cube, and
    the point clamped into it, as the loop's ``_masked_eval`` did)."""
    s, phase, left, right = st["s"], st["phase"], st["left"], st["right"]
    fl, fr, u, v, logl, u0 = (st[k] for k in ("fl", "fr", "u", "v", "logl",
                                              "u0"))
    nc, n_exp, n_con, exp_step, warn = (
        st[k] for k in ("nc", "n_exp", "n_con", "exp_step", "warn"))
    q, n_steps = directions.shape[:2]
    lane = torch.arange(q)
    PH_INIT_L, PH_INIT_R, PH_EXP_L, PH_EXP_R, PH_SHRINK = 0, 1, 2, 3, 4
    active = s < n_steps
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
    uclamp = upos.clamp(0.0, 1.0)
    logl_x = torch.where(incube, logl_x, _NEG_INF)
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
    new = dict(s=s, phase=phase, left=left, right=right, fl=fl, fr=fr, u=u,
               v=v, logl=logl, u0=u0, nc=nc, n_exp=n_exp, n_con=n_con,
               exp_step=exp_step, warn=warn, any_active=(s < n_steps).any())
    return x, upos, uclamp, incube, acc, new


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.isnan(), b.isnan())
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)) if \
        a.is_floating_point() else torch.equal(a, b)


def _run_slice_steps(st, inp, propose, advance):
    st = {k: v.clone() for k, v in st.items()}
    x, upos, uclamp, incube = propose(st, inp["u_sh"], inp["directions"],
                                      inp["strict"])
    acc = advance(st, x, upos, incube, inp["v_x"], inp["logl_x"],
                  inp["u_r0"], inp["loglstar"], inp["n_steps"])
    return x, upos, uclamp, incube, acc, st


def slice_round(st, inp):
    """A :class:`SliceRound` holding the hand-made state and one
    iteration's inputs."""
    q, n_steps, ndim = inp["directions"].shape
    rb = pr.SliceRound(q, n_steps, ndim, st["v"].shape[1],
                       inp["directions"].dtype, inp["directions"].device,
                       inp["strict"])
    for k, t in st.items():
        rb.st[k].copy_(t)
    rb.directions.copy_(inp["directions"])
    rb.draws[0].copy_(inp["u_sh"])
    rb.draws[1].copy_(inp["u_r0"])
    rb.loglstar.copy_(inp["loglstar"])
    return rb


def _run_slice_wrappers(st, inp):
    """One iteration through the wrappers on a round holding ``st``."""
    rb = slice_round(st, inp)
    pr.slice_propose(rb)
    pr.slice_advance(rb, inp["v_x"], inp["logl_x"])
    return rb.x, rb.upos, rb.uclamp, rb.incube, rb.acc, rb.st


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [3, 15])
def test_slice_plain_steps_equal_the_eager_loop(dtype, ndim):
    st, inp = slice_state(64, ndim, ndim + 1, dtype)
    got = _run_slice_steps(st, inp, pr.slice_propose_plain,
                           pr.slice_advance_plain)
    ref = _eager_slice_iteration(
        st, inp["u_sh"], inp["u_r0"], inp["directions"], inp["logl_x"],
        inp["v_x"], inp["loglstar"], inp["strict"])
    for a, b in zip(got[:5], ref[:5]):
        _same(a, b)
    assert set(got[5]) == set(ref[5])
    for k in ref[5]:
        _same(got[5][k], ref[5][k])
    # the hand-made state visits every phase, active and done, and every
    # outcome: accepted and rejected shrinks, expansions that go on and
    # end, the warning, points clamped into the cube
    act = st["s"] < inp["n_steps"]
    assert set(st["phase"][act].tolist()) == set(range(5))
    assert (~act).any() and got[4].any() and (
        (st["phase"] == pr.PH_SHRINK) & act & ~got[4]).any()
    assert bool(got[5]["warn"]) and got[3].any() and (~got[3]).any()
    assert not torch.equal(got[1], got[2])


def test_slice_wrappers_take_the_plain_steps_on_the_cpu():
    st, inp = slice_state(16, 3, 2)
    before = [w.launches for w in pr.WRAPPERS]
    got = _run_slice_wrappers(st, inp)
    ref = _run_slice_steps(st, inp, pr.slice_propose_plain,
                           pr.slice_advance_plain)
    for a, b in zip(got[:5], ref[:5]):
        _same(a, b)
    for k in ref[5]:
        _same(got[5][k], ref[5][k])
    assert [w.launches for w in pr.WRAPPERS] == before


def rwalk_state(q, ndim, ncdim, npdim, dtype=torch.float64, device="cpu",
                seed=6):
    """A hand-made walk state and one step's inputs: steps that leave the
    cube on every side (wrapped, reflected, loose and strict dimensions),
    likelihood values above, below and at the threshold, +-inf."""
    rs = get_rstate(seed)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    st = {"u": t(rs.random((q, ndim))), "v": t(rs.random((q, npdim))),
          "logl": t(rs.normal(size=q)),
          "n_acc": t(rs.integers(0, 9, q), torch.int64),
          "n_rej": t(rs.integers(0, 9, q), torch.int64)}

    def mask(idx):
        m = np.zeros(ndim, dtype=bool)
        m[idx] = True
        return t(m, torch.bool)

    inputs = {
        # step lengths from well inside the cube to well beyond it
        "du": t(rs.normal(size=(q, ncdim)) *
                np.geomspace(1e-3, 2.0, q)[:, None]), "scale": t(0.7),
        "u_ex": t(rs.random((q, ndim - ncdim))) if ncdim < ndim else None,
        # past 3 dimensions the last is wrapped and reflected both
        "periodic": mask([0] + [ndim - 1] * (ndim > 3)),
        "reflective": mask([1] + [ndim - 1] * (ndim > 3)),
        "nonbounded": t(np.arange(ndim) % 3 != 2, torch.bool),
        "logl_prop": t(rs.choice([_NEG_INF, -1.0, 0.25, 2.0, math.inf],
                                 size=q)),
        "v_prop": t(rs.random((q, npdim))), "loglstar": t(0.25)}
    return st, inputs


def _rwalk_masks(inp, masks):
    return [inp[k] if masks else None for k in ("periodic", "reflective",
                                                "nonbounded")]


def _run_rwalk_steps(st, inp, masks=True):
    """One step through the plain steps on a copy of ``st``."""
    st = {k: v.clone() for k, v in st.items()}
    u_prop, uclamp, ok = pr.rwalk_propose_plain(
        st, inp["du"], inp["scale"], inp["u_ex"], *_rwalk_masks(inp, masks))
    acc = pr.rwalk_accept_plain(st, u_prop, ok, inp["v_prop"],
                                inp["logl_prop"], inp["loglstar"])
    return u_prop, uclamp, ok, acc, st


def rwalk_round(st, inp, masks=True):
    """An :class:`RWalkRound` holding the hand-made state and one step's
    scale and threshold."""
    q, ndim = st["u"].shape
    rb = pr.RWalkRound(q, ndim, inp["du"].shape[1], st["v"].shape[1],
                       inp["du"].dtype, inp["du"].device,
                       *_rwalk_masks(inp, masks))
    for k, t in st.items():
        rb.st[k].copy_(t)
    rb.scale.copy_(inp["scale"])
    rb.loglstar.copy_(inp["loglstar"])
    return rb


def _run_rwalk_wrappers(st, inp, masks=True):
    """One step through the wrappers on a round holding ``st``."""
    rb = rwalk_round(st, inp, masks)
    pr.rwalk_propose(rb, inp["du"], inp["u_ex"])
    pr.rwalk_accept(rb, inp["v_prop"], inp["logl_prop"])
    return rb.u_prop, rb.uclamp, rb.ok, rb.accept, rb.st


def _eager_rwalk_step(st, inp, masks=True):
    """One walk step as the eager loop of ``make_rwalk_round`` wrote it
    before its steps were factored out (the product given), the
    likelihood's raw values given (masked to -inf outside the cube, and
    the point clamped into it, as the loop's ``_masked_eval`` did)."""
    u, v, logl, n_acc, n_rej = (st[k] for k in ("u", "v", "logl", "n_acc",
                                                "n_rej"))
    ncdim = inp["du"].shape[1]
    u_prop = u[:, :ncdim] + inp["du"] * inp["scale"]
    if inp["u_ex"] is not None:
        u_prop = torch.cat([u_prop, inp["u_ex"]], dim=1)
    m = _rwalk_masks(inp, masks)
    u_prop = wrap_boundaries(u_prop, m[0], m[1])
    ok = unitcheck_batch(u_prop, m[2])
    uclamp = u_prop.clamp(0.0, 1.0)
    logl_prop = torch.where(ok, inp["logl_prop"], _NEG_INF)
    accept = ok & (logl_prop > inp["loglstar"])
    u = torch.where(accept[:, None], u_prop, u)
    v = torch.where(accept[:, None], inp["v_prop"], v)
    logl = torch.where(accept, logl_prop, logl)
    return u_prop, uclamp, ok, accept, dict(
        u=u, v=v, logl=logl, n_acc=n_acc + accept, n_rej=n_rej + ~accept)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,ncdim", [(3, 3), (15, 15), (15, 12)])
@pytest.mark.parametrize("masks", [True, False])
def test_rwalk_plain_steps_equal_the_eager_loop(dtype, ndim, ncdim, masks):
    st, inp = rwalk_state(64, ndim, ncdim, ndim + 1, dtype)
    got = _run_rwalk_steps(st, inp, masks)
    ref = _eager_rwalk_step(st, inp, masks)
    for a, b in zip(got[:4], ref[:4]):
        _same(a, b)
    for k in ref[4]:
        _same(got[4][k], ref[4][k])
    assert got[2].any() and (~got[2]).any()
    assert got[3].any() and (~got[3] & got[2]).any()
    assert not torch.equal(got[0], got[1])


def test_rwalk_wrappers_take_the_plain_steps_on_the_cpu():
    st, inp = rwalk_state(16, 4, 3, 2)
    before = [w.launches for w in pr.WRAPPERS]
    got = _run_rwalk_wrappers(st, inp)
    ref = _run_rwalk_steps(st, inp)
    for a, b in zip(got[:4], ref[:4]):
        _same(a, b)
    for k in ref[4]:
        _same(got[4][k], ref[4][k])
    assert [w.launches for w in pr.WRAPPERS] == before


def test_wrappers_refuse_what_no_kernel_takes():
    st, inp = slice_state(8, 3, 1)
    with pytest.raises(TypeError, match="float64 or float32"):
        pr.SliceRound(8, 3, 3, 1, torch.float16, "cpu")
    with pytest.raises(TypeError, match="torch.Tensor"):
        pr.SliceRound(8, 3, 3, 1, torch.float64, "cpu",
                      inp["strict"].numpy())
    with pytest.raises(ValueError, match="no kernel for device"):
        pr.SliceRound(8, 3, 3, 1, torch.float64, "meta")
    _, rin = rwalk_state(8, 3, 3, 1)
    with pytest.raises(TypeError, match="float64 or float32"):
        pr.RWalkRound(8, 3, 3, 1, torch.int64, "cpu")
    with pytest.raises(TypeError, match="torch.Tensor"):
        pr.RWalkRound(8, 3, 3, 1, torch.float64, "cpu",
                      reflective=rin["reflective"].numpy())
    with pytest.raises(ValueError, match="no kernel for device"):
        pr.RWalkRound(8, 3, 3, 1, torch.float64, "meta")


def test_round_state_never_aliases_the_caller():
    """The kernels update the round's state in place, so the state owns
    its buffers: a start block that ``.to(dtype)`` returns as a view of
    the caller's tensor stays untouched by a round."""
    packed = torch.rand(8, 7, dtype=torch.float64)
    u, v, logl = packed[:, :3], packed[:, 3:6], packed[:, 6]
    st = pr.slice_init(u, v, logl, torch.rand(8, dtype=torch.float64))
    rst = pr.rwalk_init(u, v, logl)
    for s in (st, rst):
        for k in ("u", "v", "logl"):
            assert s[k].is_contiguous()
            assert s[k].data_ptr() != packed.data_ptr()
            assert s[k].untyped_storage().data_ptr() != \
                packed.untyped_storage().data_ptr()
    ptrs = [t.data_ptr() for t in st.values()]
    assert len(set(ptrs)) == len(ptrs)


def test_sources_name_the_jax_code_they_replace():
    csrc = Path(pr.__file__).resolve().parent.parent / "csrc"
    slice_src = (csrc / "slice_step.cu").read_text()
    rwalk_src = (csrc / "rwalk_step.cu").read_text()
    assert "dynesty_tpu/internal/kernels.py:763" in slice_src
    assert "dynesty_tpu/internal/kernels.py:486" in rwalk_src
    for src in (slice_src, rwalk_src):
        assert "__dmul_rn" in src and "__dadd_rn" in src and "FMA" in src
        assert "cudaGetLastError" in src
    assert "fmod" in rwalk_src


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version on the same tensors


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [3, 15, 48])
def test_slice_kernels_match_plain_on_the_card(cuda, dtype, ndim):
    st, inp = slice_state(256, ndim, ndim, dtype, cuda)
    before = pr.slice_propose.launches, pr.slice_advance.launches
    got = _run_slice_wrappers(st, inp)
    ref = _run_slice_steps(st, inp, pr.slice_propose_plain,
                           pr.slice_advance_plain)
    torch.cuda.synchronize()
    assert (pr.slice_propose.launches, pr.slice_advance.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(got[:5], ref[:5]):
        _same(a, b)
    for k in ref[5]:
        _same(got[5][k], ref[5][k])
    # without a mask every dimension is strict
    st2, inp2 = slice_state(256, ndim, 2, dtype, cuda, seed=8)
    inp2["strict"] = None
    got = _run_slice_wrappers(st2, inp2)
    ref = _run_slice_steps(st2, inp2, pr.slice_propose_plain,
                           pr.slice_advance_plain)
    for a, b in zip(got[:5], ref[:5]):
        _same(a, b)
    for k in ref[5]:
        _same(got[5][k], ref[5][k])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim,ncdim", [(3, 3), (15, 15), (15, 12), (48, 48),
                                        (48, 40)])
@pytest.mark.parametrize("masks", [True, False])
def test_rwalk_kernels_match_plain_on_the_card(cuda, dtype, ndim, ncdim,
                                               masks):
    st, inp = rwalk_state(256, ndim, ncdim, ndim, dtype, cuda)
    before = pr.rwalk_propose.launches, pr.rwalk_accept.launches
    got = _run_rwalk_wrappers(st, inp, masks)
    ref = _run_rwalk_steps(st, inp, masks)
    torch.cuda.synchronize()
    assert (pr.rwalk_propose.launches, pr.rwalk_accept.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(got[:4], ref[:4]):
        _same(a, b)
    for k in ref[4]:
        _same(got[4][k], ref[4][k])


@pytest.mark.cuda
def test_cuda_steps_without_build_raise(cuda, monkeypatch):
    monkeypatch.setenv("DYNESTY_TPU_TORCH_NO_BUILD", "1")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(pr, "_ENTRY", {})
    st, inp = slice_state(16, 3, 1, torch.float64, cuda)
    before = pr.slice_propose.launches
    with pytest.raises(RuntimeError, match="disabled"):
        slice_round(st, inp)
    assert pr.slice_propose.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("sample", ["rslice", "rwalk"])
def test_a_card_run_never_takes_the_plain_steps(cuda, monkeypatch, sample):
    """A whole run on the card takes every step through the kernels: no
    plain step sees a CUDA tensor, the slice kernels launch once an
    iteration (a replay of the captured iteration counting one launch of
    each), the walk's once a step (a replay of the captured walk counting
    one launch of each a step)."""
    import dynesty_tpu_torch as dyt

    def guarded(name):
        plain = getattr(pr, name)

        def fn(st, *a, **kw):
            assert all(t.device.type == "cpu" for t in st.values()), \
                f"{name} on the card"
            return plain(st, *a, **kw)
        return fn

    for name in ("slice_propose_plain", "slice_advance_plain",
                 "rwalk_propose_plain", "rwalk_accept_plain"):
        monkeypatch.setattr(pr, name, guarded(name))
    draws, walk_rounds, gated = [], [], []
    # the walk takes its round's walks steps; the state machine's
    # iterations are its flag reads less one a round (a round behind the
    # fused round's gate reads once, as sync_round, and iterates none)
    real_walk, real_machine = tk.rwalk_loop, tk.slice_loop
    real_waves = tk.unif_loop

    def walk(entry, draw, **kw):
        walk_rounds.append(entry.walks)
        draws.extend(range(entry.walks))
        return real_walk(entry, draw, **kw)

    def machine(entry, draw, *, timings, **kw):
        n0 = timings.get("sync_slice", 0)
        out = real_machine(entry, draw, timings=timings, **kw)
        if not out:
            draws.extend(range(timings["sync_slice"] - n0 - 1))
        return out

    def waves(*a, **kw):
        # a uniform round behind the gate: one wave read as sync_round
        gated.append(real_waves(*a, **kw))
        return gated[-1]

    monkeypatch.setattr(tk, "rwalk_loop", walk)
    monkeypatch.setattr(tk, "slice_loop", machine)
    monkeypatch.setattr(tk, "unif_loop", waves)
    pr.zero_counts()
    s = dyt.NestedSampler(lambda x: -0.5 * (x @ x),
                          lambda u: 10.0 * (2.0 * u - 1.0), 3, nlive=200,
                          bound="single", sample=sample, queue_size=32,
                          rstate=get_rstate())
    s.run_nested(print_progress=False, dlogz=0.5)
    # the unit-cube phase's uniform waves: each replayed but the warm-up
    # wave of its shape, which counts n_uncaptured
    t = s.timings
    unif_eager = t["sync_wave"] + sum(gated) - t["n_unif_replay"]
    assert unif_eager == t["n_unif_graph"] == 1
    if sample == "rslice":
        assert pr.slice_propose.launches == pr.slice_advance.launches == \
            len(draws) > 0
        assert pr.rwalk_propose.launches == 0
        assert t["n_uncaptured"] == unif_eager and t["n_slice_graph"] >= 1
        assert t["n_slice_replay"] + t["n_slice_graph"] == len(draws)
    else:
        assert pr.rwalk_propose.launches == pr.rwalk_accept.launches == \
            len(draws) > 0
        assert pr.slice_propose.launches == 0
        # every round but the first of its shape replayed the walk
        assert t["n_rwalk_graph"] >= 1 and t["n_rwalk_replay"] > 0
        walk_eager = t["n_uncaptured"] - unif_eager
        assert t["n_rwalk_replay"] + walk_eager == len(walk_rounds)
        assert walk_eager == t["n_rwalk_graph"]
