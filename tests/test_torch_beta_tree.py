"""The Beta prior's grouped, tree-walking kernel (``csrc/beta_prior.cu``
``beta_ppf_kernel``; ``dynesty_tpu_torch/ops/beta_prior.py``
``beta_ppf_columns``, ``beta_levels``) and ``PriorTransform``'s grouping of
its Beta dimensions.

On the CPU: a torch model of the kernel's walk (each round's tree nodes,
their mids by path, the replay by heap index), the oracle of the kernel's
algorithm, bit for bit against ``beta_ppf_plain`` at every level count the
kernel takes and several ``niter``; the level rule; the grouped operator
under ``torch.func.vmap`` against the plain version column by column; the
operator's CUDA wrapper (its tables, strides, output offsets and launches,
more columns than one launch takes) with the entry emulated on the CPU;
``PriorTransform`` with Beta dimensions grouped against the same priors
called one by one, and against the JAX package's.

On a card (``cuda``-marked, skipped here): the grouped kernel on either
side of the level switch, numbers and a three-column table, both dtypes,
against the plain version; run there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_beta_tree.py
"""

import ctypes
import math

import numpy as np
import pytest
import torch

import dynesty_tpu_torch.models as tm
from dynesty_tpu_torch.ops import beta_prior as bp

from utils import get_rstate

torch.set_num_threads(1)

DTYPES = [torch.float64, torch.float32]
_AB = [0.5, 1.0, 2.0, 5.0, 30.0]
PAIRS = [(a, b) for a in _AB for b in _AB]
EDGES = [0.0, 1.0, 1e-12, 1 - 1e-12, math.nan]
# the threads an H100 SXM keeps busy with the kernel: 132 SMs of 16 warps
H100_LANES = 132 * 512


def _same(a, b):
    """Equal bits where both are numbers, NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def _sweep(dtype, per_pair=3, seed=21):
    """u of (25, 5 + per_pair): every pair's row holds the edges and
    seeded uniforms; a and b (25, 1) per pair."""
    u = get_rstate(seed).random((len(PAIRS), len(EDGES) + per_pair))
    u[:, :len(EDGES)] = EDGES
    a = torch.tensor([[p[0]] for p in PAIRS], dtype=dtype)
    b = torch.tensor([[p[1]] for p in PAIRS], dtype=dtype)
    return torch.as_tensor(u, dtype=dtype), a, b


def walk(u, a, b, niter, levels):
    """The kernel's algorithm in torch: rounds of ``levels`` bisection
    levels (fewer in the last), every node of the round's tree (heap
    order, children 2i not below and 2i + 1 below) evaluated at the mid
    its path gives by the serial recurrence, then the serial loop's
    comparisons replayed by heap index."""
    lo, hi = torch.zeros_like(u), torch.ones_like(u)
    done = 0
    while done < niter:
        lv = min(levels, niter - done)
        f = []
        for node in range(1, 2 ** lv):
            lo_n, hi_n = lo, hi
            for s in range(node.bit_length() - 2, -1, -1):
                mid = 0.5 * (lo_n + hi_n)
                if (node >> s) & 1:
                    lo_n = mid
                else:
                    hi_n = mid
            f.append(bp.betainc_plain(a, b, 0.5 * (lo_n + hi_n)))
        f = torch.stack(f)
        at = torch.ones(u.shape, dtype=torch.long)
        for _ in range(lv):
            fm = f.gather(0, (at - 1).unsqueeze(0)).squeeze(0)
            mid = 0.5 * (lo + hi)
            below = fm < u
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
            at = 2 * at + below
        done += lv
    return 0.5 * (lo + hi)


# --------------------------------------------------------------------------
# the walk's oracle and the level rule


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_the_tree_walk_is_the_serial_bisection(dtype, levels):
    """Every (a, b) of the sweep, the edges and NaN: the walk's bits are
    beta_ppf_plain's at niter 0, 1, 3, 13 and 50."""
    u, a, b = _sweep(dtype)
    for niter in (0, 1, 3, 13, 50):
        assert _same(walk(u, a, b, niter, levels),
                     bp.beta_ppf_plain(u, a, b, niter)), niter


def test_the_level_rule():
    """A warp an element where n warps fit the threads the card keeps
    busy (16 warps an SM), then 16, 8 and 4 lanes, then one thread an
    element; never more levels for more elements."""
    assert bp.MAX_LEVELS == 5 and bp.LANES_PER_SM == 512
    lanes = H100_LANES
    cases = {1: 5, 256: 5, 768: 5, 2112: 5, 2113: 4, 4224: 4, 4225: 3,
             8448: 3, 8449: 2, 16896: 2, 16897: 1, 2 ** 20: 1}
    assert {n: bp.beta_levels(n, lanes) for n in cases} == cases
    got = [bp.beta_levels(n, 1000) for n in range(1, 400)]
    assert got == sorted(got, reverse=True)
    assert all(n << lv <= 1000 or lv == 1 for n, lv in
               zip(range(1, 400), got))


# --------------------------------------------------------------------------
# the grouped operator on the CPU: the plain version, column by column


def _table(dtype, rows, seed):
    u = get_rstate(seed).random((rows, 6))
    u[:len(EDGES), 1] = EDGES
    u[len(EDGES):2 * len(EDGES), 4] = EDGES
    cols, a, b = [4, 1, 5], [2.0, 0.5, 30.0], [5.0, 0.5, 1.0]
    return torch.as_tensor(u, dtype=dtype), cols, a, b


def _plain_columns(u, cols, a, b, niter):
    return torch.stack([bp.beta_ppf_plain(u[:, c].contiguous(), x, y, niter)
                        for c, x, y in zip(cols, a, b)], 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("in_dims", [0, 1, "nested"])
def test_the_grouped_operator_under_vmap_is_the_plain_version(dtype,
                                                              in_dims):
    u, cols, a, b = _table(dtype, 12, seed=22)
    niter = 20 if in_dims == 0 else 7
    want = _plain_columns(u, cols, a, b, niter)

    def one(r):
        return bp.beta_ppf_columns(r, cols, a, b, niter)

    if in_dims == 0:
        got = torch.func.vmap(one)(u)
    elif in_dims == 1:
        got = torch.func.vmap(one, in_dims=1)(u.T.contiguous())
    else:
        got = torch.func.vmap(torch.func.vmap(one))(
            u.reshape(3, 4, 6)).reshape(12, 3)
    assert _same(got, want)
    if in_dims == 0:
        # and the one-column call of each entry
        for j, (c, x, y) in enumerate(zip(cols, a, b)):
            assert _same(got[:, j], torch.func.vmap(
                lambda r: bp.beta_ppf(r[c], x, y, niter))(u))


def test_the_grouped_operator_refuses_a_bad_table():
    u = torch.rand(4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="columns"):
        bp.beta_ppf_columns(u, [3], [2.0], [5.0])
    with pytest.raises(ValueError, match="one length"):
        bp.beta_ppf_columns(u, [0, 1], [2.0], [5.0])
    with pytest.raises(ValueError, match="one length"):
        bp.beta_ppf_columns(u, [], [], [])


def _emulated_entry(dtype, calls):
    """A stand-in for the ctypes entry that runs the kernel's contract on
    the CPU: u read at r * su_row + col * su_col, out written at r *
    so_row + j, by the plain version; records each call's table."""
    ctype = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
    np_t = np.float64 if dtype == torch.float64 else np.float32
    size = np.dtype(np_t).itemsize

    def f(src, su, sc, out, so, rows, k, cols, a, b, niter, levels):
        cols, a, b = list(cols[:k]), list(a[:k]), list(b[:k])
        calls.append({"rows": rows, "k": k, "cols": cols, "a": a, "b": b,
                      "levels": levels, "strides": (su, sc, so)})
        extent = (rows - 1) * su + max(cols) * sc + 1
        u = np.ctypeslib.as_array((ctype * extent).from_address(src))
        dst = np.ctypeslib.as_array(
            (ctype * ((rows - 1) * so + k)).from_address(out))
        for j, (c, x, y) in enumerate(zip(cols, a, b)):
            col = torch.as_tensor(np.lib.stride_tricks.as_strided(
                u[c * sc:], (rows,), (su * size,)).copy())
            dst[j::so][:rows] = bp.beta_ppf_plain(col, x, y, niter).numpy()
        return 0

    return f


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("layout", ["rows", "columns", "batched"])
def test_the_cuda_wrapper_tables_strides_and_launches(monkeypatch, dtype,
                                                      layout):
    """The CUDA wrapper, its entry emulated on the CPU: 34 Beta columns of
    a (rows, 40) u (row-major, column-major, or with two leading axes) in
    two launches of 32 and 2 entries, each reading u by its strides (no
    copy where u's rows flatten to one stride) and writing its block of
    the output's columns, levels by the rule; the result is the plain
    version's, column by column."""
    calls = []
    monkeypatch.setattr(bp, "_entry", lambda fn, dt: _emulated_entry(
        dt, calls))
    monkeypatch.setattr(bp, "_launch", lambda f, args, device, fn: f(*args))
    monkeypatch.setattr(bp, "_busy_lanes", lambda device: H100_LANES)
    rng = get_rstate(23)
    base = torch.as_tensor(rng.random((6, 40)), dtype=dtype)
    u = {"rows": base, "columns": base.T.contiguous().T,
         "batched": base.reshape(2, 3, 40)}[layout]
    cols = list(range(39, 5, -1))
    a = [_AB[i % 5] for i in range(34)]
    b = [_AB[(i // 5) % 5] for i in range(34)]
    n0 = bp.beta_ppf.launches
    got = bp._beta_ppf_cuda(u, cols, a, b, 2)
    assert bp.beta_ppf.launches == n0 + 2
    assert [(c["k"], c["rows"], c["levels"]) for c in calls] == \
        [(32, 6, 5), (2, 6, 5)]
    assert [c["cols"] for c in calls] == [cols[:32], cols[32:]]
    assert calls[0]["a"] + calls[1]["a"] == a
    su, sc = (40, 1) if layout != "columns" else (1, 6)
    assert all(c["strides"] == (su, sc, 34) for c in calls)
    assert got.shape == u.shape[:-1] + (34,)
    assert _same(got.reshape(6, 34), _plain_columns(base, cols, a, b, 2))


# --------------------------------------------------------------------------
# PriorTransform's grouping


class _MyBeta(tm.Beta):
    """A Beta subclass: called on its own, never grouped."""


def _mixed_priors():
    return [tm.Beta(2.0, 5.0, 12), tm.TopHat(-5.0, 5.0),
            tm.Beta(0.5, 0.5, 12), tm.Normal(1.0, 2.0), tm.Beta(5.0, 2.0, 5),
            tm.ClippedNormal(0.0, 1.0, -1.0, 2.0), _MyBeta(30.0, 1.0, 12),
            tm.LogNormal(0.0, 0.5), tm.Beta(1.0, 30.0, 5),
            tm.LogUniform(1e-3, 1e3), tm.Beta(2.0, 2.0, 12)]


def _ungrouped(priors, u):
    """The same priors called one dimension at a time under vmap."""
    return torch.stack([torch.func.vmap(p)(u[:, i].contiguous())
                        for i, p in enumerate(priors)], 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_prior_transform_groups_its_betas(dtype, monkeypatch):
    """Betas of two niter beside the other five priors and a Beta
    subclass: two grouped calls (niter 12 and 5), then the subclass's
    own one-column call; the result is the ungrouped stack's, bit for
    bit."""
    priors = _mixed_priors()
    u = torch.as_tensor(get_rstate(24).random((9, len(priors))),
                        dtype=dtype)
    u[0, [0, 2, 4, 6, 8, 10]] = 0.0
    u[1, [0, 2, 4, 6, 8, 10]] = math.nan
    groups = []
    real = bp.beta_ppf_columns

    def spy(u_, cols, alpha, beta, niter=50):
        groups.append((list(cols), list(alpha), list(beta), niter))
        return real(u_, cols, alpha, beta, niter)

    monkeypatch.setattr(bp, "beta_ppf_columns", spy)
    got = torch.func.vmap(tm.PriorTransform(priors))(u)
    assert groups == [([0, 2, 10], [2.0, 0.5, 2.0], [5.0, 0.5, 2.0], 12),
                      ([4, 8], [5.0, 1.0], [2.0, 30.0], 5),
                      ([0], [30.0], [1.0], 12)]
    assert _same(got, _ungrouped(priors, u))
    # unbatched: u's first axis the dimensions, a batch after it
    assert _same(tm.PriorTransform(priors)(u.T.contiguous()), got.T)


def test_prior_transform_past_one_launchs_table():
    """More Beta dimensions than one launch takes (34 > 32): the
    ungrouped stack's bits."""
    priors = [tm.Beta(_AB[i % 5], _AB[(i // 5) % 5], niter=3)
              for i in range(bp.TABLE + 2)]
    u = torch.as_tensor(get_rstate(25).random((5, len(priors))))
    got = torch.func.vmap(tm.PriorTransform(priors))(u)
    assert _same(got, _ungrouped(priors, u))


@pytest.fixture(scope="module")
def jx():
    """jax, jax.numpy and the JAX package's models."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("the JAX comparisons run under tests/conftest.py "
                    "(JAX on the CPU in float64)")
    import jax.numpy as jnp

    import dynesty_tpu.models as jm
    return jax, jnp, jm


def test_grouped_prior_transform_matches_jax(jx):
    """The grouped transform against the JAX package's (1e-8 absolute for
    the Betas, 1e-12 relative for the rest)."""
    jax, jnp, jm = jx

    def priors(m):
        return [m.Beta(2.0, 5.0), m.TopHat(-5.0, 5.0), m.Beta(0.5, 0.5),
                m.Normal(1.0, 2.0), m.Beta(5.0, 2.0, niter=20),
                m.LogUniform(1e-3, 1e3), m.Beta(30.0, 1.0)]

    u = get_rstate(26).random((60, 7))
    want = np.asarray(jax.vmap(jm.PriorTransform(priors(jm)))(
        jnp.asarray(u)))
    got = torch.func.vmap(tm.PriorTransform(priors(tm)))(
        torch.as_tensor(u)).numpy()
    beta, rest = [0, 2, 4, 6], [1, 3, 5]
    np.testing.assert_allclose(got[:, beta], want[:, beta], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got[:, rest], want[:, rest], rtol=1e-12,
                               atol=0)


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_either_side_of_the_level_switch_on_the_card(cuda, dtype):
    """The card's switch from a warp an element (n warps fit in 16 warps
    an SM) to fewer levels: numbers at n and n + 1 elements, and a
    three-column table at rows n // 3 and n // 3 + 1, against the plain
    version, one launch a call."""
    lanes = bp._busy_lanes(cuda)
    n = lanes >> bp.MAX_LEVELS
    assert bp.beta_levels(n, lanes) == 5
    assert bp.beta_levels(n + 1, lanes) == 4
    for m in (n, n + 1):
        u = torch.as_tensor(get_rstate(27).random(m), dtype=dtype,
                            device=cuda)
        u[:len(EDGES)] = torch.tensor(EDGES, dtype=dtype)
        n0 = bp.beta_ppf.launches
        assert _same(bp.beta_ppf(u, 2.0, 5.0), bp.beta_ppf_plain(u, 2.0, 5.0))
        assert bp.beta_ppf.launches == n0 + 1
    for rows in (n // 3, n // 3 + 1):
        u = torch.as_tensor(get_rstate(28).random((rows, 6)), dtype=dtype,
                            device=cuda)
        cols, a, b = [4, 1, 5], [2.0, 0.5, 30.0], [5.0, 0.5, 1.0]
        n0 = bp.beta_ppf.launches
        got = bp.beta_ppf_columns(u, cols, a, b)
        assert bp.beta_ppf.launches == n0 + 1
        assert _same(got, _plain_columns(u, cols, a, b, 50))
