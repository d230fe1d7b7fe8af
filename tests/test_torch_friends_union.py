"""The friends' union of a uniform wave: the candidates drawn about the
live points of a balls or cubes bound and their 1/q overlap test
(``dynesty_tpu_torch/ops/proposals.py``, ``friends_union_plain`` and
``unif_valid``'s friends mode; ``dynesty_tpu_torch/internal/kernels.py``,
``_friends_draws`` and ``_sample_friends_union``).

On the CPU: the plain version against the JAX package's
``_sample_friends_union`` on its own draws (the same key split into three,
its ``randint``, ball or cube offsets and acceptance uniforms) over balls
and cubes in 2, 3 and 7 dimensions about 1, 37 and 600 centres, in
float64: the candidates within 1e-13 absolute (XLA sums the offset's
product in its own order) and the acceptance equal on every lane but
those where a centre's distance lies within 1e-12 relative of 1 or ``ua``
within 1e-12 of 1 / nin, which must be few; the same against the eager
form it replaced (copied below as it was: a matrix product, an einsum,
``vector_norm`` or ``amax``) on one generator, whose state must end
equal; candidates that are NaN or outside the cube, a loose dimension and
dimensions outside the bound through the round's buffers; distances
exactly at 1 and at their neighbouring floats (a square root that rounds
to 1 counts as 1; a NaN entry of a cube's distance is NaN, as ``amax``
gives); the root's test as the kernel's threshold on the square; the
kernel's launch geometry; the kernels' argument tables against their
structs; and whole balls/unif and cubes/unif runs against the JAX
package's (logz within 4 combined errors, niter within 10 %).

On a card (``cuda``-marked, skipped here): the kernel against the plain
version bit for bit at q 1, 37 and 256, N 1, 2048 and 16384 and ncdim 3,
15 and 40 in both dtypes, on the threshold lanes, at narrowed widths,
where no chunk divides the centres (widths 1 to 17 and 70), over twenty
launches and twenty replays that each leave the counts zero, and a
captured friends wave against an eager one.  The JAX package is
imported by a fixture only, so that on the card

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_friends_union.py

runs the card's tests.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.internal.kernels as tk
from dynesty_tpu_torch.internal.likelihood import LogLikelihood
from dynesty_tpu_torch.ops import proposals as pr
from dynesty_tpu_torch.ops.geometry import randsphere_batch
from dynesty_tpu_torch.utils.misc import Timings

from utils import get_rstate

torch.set_num_threads(1)

FTYPES = ("balls", "cubes")
SEED = 56432
NDIM = 3
LOGZ_TRUTH = NDIM * (-np.log(20.0))
# the plain version against the JAX package's and the eager form's: the
# candidates' absolute difference, and the margin about a threshold past
# which a lane's acceptance must agree
X_ATOL = 1e-13
NEAR = 1e-12

_COV = np.identity(NDIM)
_COV[_COV == 0] = 0.95
_CINV_NP = np.linalg.inv(_COV)
_CINV = torch.as_tensor(_CINV_NP)
_LNORM = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(_COV)))


def gau_loglike(x):
    return -0.5 * (x @ _CINV @ x) + _LNORM


def gau_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


@pytest.fixture(scope="module")
def jx():
    """jax, jax.numpy, the JAX package's kernels and geometry modules and
    the package itself."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("the JAX comparisons run under tests/conftest.py "
                    "(JAX on the CPU in float64)")
    import jax.numpy as jnp

    import dynesty_tpu as dytpu
    import dynesty_tpu.internal.kernels as jk
    import dynesty_tpu.ops.geometry as jg
    return jax, jnp, jk, jg, dytpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _friends_arrays(ncdim, nctrs, seed, dtype=torch.float64, device="cpu",
                    lo=0.0, ftype="balls"):
    """``nctrs`` centres in [lo, 1 - lo]^ncdim and symmetric axes (a sqrtm,
    as the friends' fit gives) sized so that a candidate lies in ~2 balls
    or cubes (``ftype``) on average, and their inverse."""
    rs = get_rstate(seed)
    a = rs.normal(size=(ncdim, ncdim))
    w, vec = np.linalg.eigh(np.eye(ncdim) + 0.1 * (a + a.T))
    unit = math.pi ** (ncdim / 2) / math.gamma(ncdim / 2 + 1) \
        if ftype == "balls" else 2.0 ** ncdim
    r = min(0.5, ((1 - 2 * lo) ** ncdim * 2.0 / (nctrs * unit)) **
            (1.0 / ncdim))
    axes = (vec * np.sqrt(np.abs(w))) @ vec.T * r
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in (("ctrs", rs.uniform(lo, 1.0 - lo, (nctrs, ncdim))),
                         ("axes", axes), ("axes_inv", np.linalg.inv(axes)))}


def _distances(ftype, x, arrays):
    """Each candidate's distance to every centre in float64 (q, N)."""
    ctrs, binv = (arrays[k].double().cpu().numpy()
                  for k in ("ctrs", "axes_inv"))
    dt = (ctrs[None, :, :] - x.double().cpu().numpy()[:, None, :]) @ binv
    return np.sqrt((dt * dt).sum(-1)) if ftype == "balls" \
        else np.abs(dt).max(-1)


def _near(ftype, x, ua, arrays):
    """The lanes whose acceptance two orders of summation may decide
    apart: a centre's distance within NEAR relative of 1, or ``ua`` within
    NEAR of 1 / nin."""
    dist = _distances(ftype, x, arrays)
    nin = np.maximum((dist <= 1.0).sum(1), 1)
    return (np.abs(dist - 1.0) <= NEAR).any(1) | \
        (np.abs(ua.double().cpu().numpy() - 1.0 / nin) <= NEAR), nin


# --------------------------------------------------------------------------
# the eager form as it was


def _old_union_from_draws(ftype, idx, offset, ua, ctrs, axes, axes_inv):
    x = ctrs[idx] + offset @ axes
    dt = torch.einsum("qmi,ij->qmj", ctrs[None, :, :] - x[:, None, :],
                      axes_inv)
    if ftype == "balls":
        dist = torch.linalg.vector_norm(dt, dim=-1)
    else:
        dist = dt.abs().amax(dim=-1)
    nin = (dist <= 1.0).sum(dim=1).clamp_min(1)
    return x, ua < 1.0 / nin.to(ua.dtype)


def _old_friends_union(gen, arrays, q, ncdim, dtype, ftype):
    """``_sample_friends_union`` before the kernel: the centre, the
    offset, the candidate by a matrix product, the distances by an einsum
    and a norm, then the acceptance uniform."""
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
    x = ctrs[idx] + offset @ axes
    dt = torch.einsum("qmi,ij->qmj", ctrs[None, :, :] - x[:, None, :],
                      axes_inv)
    if ftype == "balls":
        dist = torch.linalg.vector_norm(dt, dim=-1)
    else:
        dist = dt.abs().amax(dim=-1)
    nin = (dist <= 1.0).sum(dim=1).clamp_min(1)
    accept = torch.rand((q,), generator=gen, dtype=dtype, device=device) < \
        1.0 / nin.to(dtype)
    return x, accept


# --------------------------------------------------------------------------
# against the JAX package and the eager form


@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("ncdim", [2, 3, 7])
@pytest.mark.parametrize("nctrs", [1, 37, 600])
def test_the_plain_union_equals_the_jax_packages(jx, ftype, ncdim, nctrs):
    """``friends_union_plain`` on the JAX package's own draws gives its
    ``_sample_friends_union``'s candidates and acceptance."""
    jax, jnp, jk, jg, _ = jx
    q = 400
    arrays = _friends_arrays(ncdim, nctrs, ncdim + nctrs, ftype=ftype)
    jarrays = {k: jnp.asarray(v.numpy()) for k, v in arrays.items()}
    key = jax.random.key(ncdim * 1000 + nctrs)
    jx_, jacc = jk._sample_friends_union(key, jarrays, q, ncdim,
                                         jnp.float64, ftype)
    kc, kb, ka = jax.random.split(key, 3)
    idx = jax.random.randint(kc, (q,), 0, nctrs)
    if ftype == "balls":
        offset = jg.randsphere_batch(kb, (q,), ncdim, dtype=jnp.float64)
    else:
        offset = jax.random.uniform(kb, (q, ncdim),
                                    dtype=jnp.float64) * 2.0 - 1.0
    ua = jax.random.uniform(ka, (q,), dtype=jnp.float64)

    def t(a):
        return torch.as_tensor(np.array(a))

    x, acc = pr.friends_union_plain(ftype, t(idx), t(offset), t(ua),
                                    *(arrays[k] for k in pr.UNIF_FRIENDS))
    assert x.dtype == torch.float64 and acc.dtype == torch.bool
    np.testing.assert_allclose(x.numpy(), np.array(jx_), rtol=0,
                               atol=X_ATOL)
    near, nin = _near(ftype, x, t(ua), arrays)
    assert int(near.sum()) <= 2
    ref = t(jacc)
    assert torch.equal(acc[~near], ref[~near])
    if nctrs > 1:
        assert (nin > 1).any() and 0 < int(acc.sum()) < q
    else:
        assert bool(acc.all())


@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("ncdim", [2, 3, 7])
@pytest.mark.parametrize("nctrs", [1, 37, 600])
def test_the_plain_union_equals_the_old_eager_form(ftype, ncdim, nctrs):
    """``_sample_friends_union`` (the draws, then the plain version)
    against the eager form it replaced, on one generator: the same draws
    in the same order, the candidates within 1e-13, the acceptance equal
    away from the thresholds."""
    q = 400
    arrays = _friends_arrays(ncdim, nctrs, 7 + ncdim + nctrs, ftype=ftype)
    g_new, g_old = torch.Generator(), torch.Generator()
    g_new.manual_seed(ncdim + nctrs)
    g_old.manual_seed(ncdim + nctrs)
    x, acc = tk._sample_friends_union(g_new, arrays, q, ncdim,
                                      torch.float64, ftype)
    x_old, acc_old = _old_friends_union(g_old, arrays, q, ncdim,
                                        torch.float64, ftype)
    assert torch.equal(g_new.get_state(), g_old.get_state())
    assert float((x - x_old).abs().max()) <= X_ATOL
    # the acceptance uniforms: the generator's last draw
    g = torch.Generator()
    g.manual_seed(ncdim + nctrs)
    _, _, ua = tk._friends_draws(g, nctrs, q, ncdim, torch.float64, ftype,
                                 "cpu")
    near, nin = _near(ftype, x, ua, arrays)
    assert int(near.sum()) <= 2
    assert torch.equal(acc[~near], acc_old[~near])
    if nctrs > 1:
        assert (nin > 1).any() and 0 < int(acc.sum()) < q


def _threshold_draws(ftype, dtype, device="cpu"):
    """Draws whose distances lie exactly at the thresholds: eight lane
    kinds, each at its own centre (the candidate: offset 0) with a second
    centre ``d`` away in the round's units (the inverse axes 16 I, so
    that the kinds' spacing, 1.75 / 16, is 1.75 there; every coordinate
    and difference a float of either dtype), ``d`` along the
    first axis the largest float below 1, 1, the smallest above 1 (and
    over cubes the same with the other axes at 0.5), then (1, h) and (1,
    2h) with h the square root of half an ulp of 1, whose squared length
    rounds to 1 (or 1 + 2 ulp: above); and ua 0.6, so that a lane accepts
    exactly where its second centre lies farther than 1.  Returns the
    arrays, ``idx``, ``offset``, ``ua`` and the expected acceptance."""
    one = torch.tensor(1.0, dtype=dtype)
    below, above = torch.nextafter(one, -one), torch.nextafter(one, 2 * one)
    h = 2.0 ** -26 if dtype == torch.float64 else 2.0 ** -12
    kinds = [(below, 0.0), (one, 0.0), (above, 0.0), (one, h),
             (one, 2 * h), (below, 0.5), (one, -0.5), (above, 0.25)]
    n = len(kinds)
    ctrs = torch.zeros((2 * n, 3), dtype=torch.float64)
    expect = []
    for r, (t0, t1) in enumerate(kinds):
        x = torch.tensor([1.0 / 16, (1.0 + 1.75 * r) / 16, 0.5],
                         dtype=torch.float64)
        ctrs[2 * r] = x
        # c - x = -(t0, t1, 0) / 16: exact (a power of two), as c is
        ctrs[2 * r + 1] = torch.stack([
            (1.0 - t0.double()) / 16, x[1] - t1 / 16, x[2]])
        if ftype == "balls":
            s = t0 * t0 + torch.tensor(t1, dtype=dtype) ** 2
            within = bool(torch.sqrt(s) <= 1.0)
        else:
            within = bool(max(t0, torch.tensor(abs(t1), dtype=dtype)) <= 1.0)
        expect.append(not within)
    arrays = {"ctrs": ctrs.to(dtype),
              "axes": (torch.eye(3, dtype=torch.float64) / 16).to(dtype),
              "axes_inv": (16 * torch.eye(3, dtype=torch.float64)).to(dtype)}
    arrays = {k: v.to(device) for k, v in arrays.items()}
    q = 4 * n
    lanes = torch.arange(q)
    idx = (2 * (lanes % n)).to(device)
    offset = torch.zeros((q, 3), dtype=dtype, device=device)
    ua = torch.full((q,), 0.6, dtype=dtype, device=device)
    expect = torch.tensor(expect)[lanes % n].to(device)
    return arrays, idx, offset, ua, expect


@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_distances_at_the_thresholds(ftype, dtype):
    """At 1 and its neighbouring floats the plain version counts as the
    eager form and the JAX package's order say: a distance of 1 holds, a
    square root that rounds to 1 holds (its square would not), the next
    float does not."""
    arrays, idx, offset, ua, expect = _threshold_draws(ftype, dtype)
    ctrs, axes, axes_inv = (arrays[k] for k in pr.UNIF_FRIENDS)
    x, acc = pr.friends_union_plain(ftype, idx, offset, ua, ctrs, axes,
                                    axes_inv)
    assert torch.equal(x, ctrs[idx])
    assert torch.equal(acc, expect)
    assert 0 < int(expect.sum()) < len(expect)
    _, acc_old = _old_union_from_draws(ftype, idx, offset, ua, ctrs, axes,
                                       axes_inv)
    assert torch.equal(acc_old, expect)
    if ftype == "balls" and dtype == torch.float64:
        # the kind (1, h): squared length 1 + 1 ulp, its root 1
        s = torch.tensor(1.0, dtype=dtype) + (2.0 ** -26) ** 2
        assert float(s) > 1.0 and float(torch.sqrt(s)) == 1.0
        assert not bool(expect[3])


@pytest.mark.parametrize("ftype", FTYPES)
def test_a_nan_entry_of_a_distance_is_nan(ftype):
    """A NaN in one entry of ``(c - x) @ axes_inv`` makes the distance NaN
    (not within), as ``amax`` and ``vector_norm`` gave, where ``fmax``
    would take the other entries: with a second centre 0.5 away along the
    first axis, every lane counts its own centre only (NaN there too) and
    accepts at ua 0.6."""
    q = 16
    ctrs = torch.tensor([[0.4, 0.5, 0.5], [0.45, 0.5, 0.5]],
                        dtype=torch.float64)
    axes = torch.eye(3, dtype=torch.float64) / 10
    binv = 10 * torch.eye(3, dtype=torch.float64)
    binv[1, 2] = math.nan
    idx = torch.arange(q) % 2
    offset = torch.zeros((q, 3), dtype=torch.float64)
    ua = torch.full((q,), 0.6, dtype=torch.float64)
    x, acc = pr.friends_union_plain(ftype, idx, offset, ua, ctrs, axes, binv)
    _, acc_old = _old_union_from_draws(ftype, idx, offset, ua, ctrs, axes,
                                       binv)
    assert bool(acc.all()) and torch.equal(acc, acc_old)
    # without the NaN both centres hold every candidate
    binv[1, 2] = 0.0
    _, acc = pr.friends_union_plain(ftype, idx, offset, ua, ctrs, axes, binv)
    assert not bool(acc.any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_root_test_is_a_threshold_on_the_square(dtype):
    """The friends kernel's ball test takes no root: ``sqrt(s) <= 1``
    (torch's correctly rounded root, the plain version's test) holds
    exactly where ``s <= nextafter(1, 2)``, over every float within 2,000
    ulps of 1, 10^5 uniform ``s`` in [0, 4), and at 0, -0, NaN and inf;
    the kernel's threshold constants (``Op::one_up`` in
    ``csrc/unif_wave.cu``) are that float."""
    one = torch.tensor(1.0, dtype=dtype)
    lim = torch.nextafter(one, 2 * one)
    ibits = torch.int64 if dtype == torch.float64 else torch.int32
    near = (one.view(ibits) + torch.arange(-2000, 2001, dtype=ibits)) \
        .view(dtype)
    rand = torch.as_tensor(get_rstate(SEED).uniform(0.0, 4.0, 10 ** 5),
                           dtype=dtype)
    special = torch.tensor([0.0, -0.0, math.nan, math.inf], dtype=dtype)
    s = torch.cat([near, rand, special])
    assert torch.equal(torch.sqrt(s) <= 1.0, s <= lim)
    assert bool(torch.sqrt(lim) <= 1.0)
    assert not bool(torch.sqrt(torch.nextafter(lim, 2 * one)) <= 1.0)
    src = (Path(pr.__file__).resolve().parent.parent / "csrc" /
           "unif_wave.cu").read_text()
    f64, f32 = re.findall(
        r"one_up\(\) \{\s*return (0x[0-9a-f.]+p[0-9]+)f?;\s*\}", src)
    assert float.fromhex(f64 if dtype == torch.float64 else f32) == \
        float(lim)


@pytest.mark.parametrize("nctrs", [1, 31, 2048, 16384])
@pytest.mark.parametrize("q", [1, 37, 256])
def test_the_friends_geometry_covers_every_centre_once(q, nctrs):
    """``friends_geometry``: groups of 32 lanes covering the wave, chunks
    that cover every centre exactly once (only the last one short), a
    block's shared memory as ``friends_layout`` lays it out and within the
    budget (the 46 kB default where a chunk of one centre fits it), the
    inverse axes staged wherever the kernel holds the candidate in
    registers, every warp given ``FRIENDS_MIN_WARP`` centres where there
    are enough, and at the drives' shape (q 256, 2048 centres) 32 chunks
    on an H100 SXM's 132 SMs (28 on a card of 114): about two blocks an
    SM."""
    for ncdim in (1, 3, 15, 16, 17, 40, 200):
        for itemsize in (8, 4):
            g = pr.friends_geometry(q, nctrs, ncdim, itemsize)
            assert (g.groups - 1) * 32 < q <= g.groups * 32
            cover = np.zeros(nctrs, dtype=int)
            for c in range(g.chunks):
                cover[c * g.per:(c + 1) * g.per] += 1
            assert (cover == 1).all()
            assert (g.chunks - 1) * g.per < nctrs <= g.chunks * g.per
            one = pr.friends_layout(ncdim, 1, itemsize, g.staged)
            assert pr.friends_layout(ncdim, g.per, itemsize, g.staged) <= (
                pr.FRIENDS_SMEM_DEFAULT if one <= pr.FRIENDS_SMEM_DEFAULT
                else pr.FRIENDS_SMEM_MAX)
            assert g.staged or ncdim > 16
            assert g.per >= min(nctrs, pr.FRIENDS_WARPS *
                                pr.FRIENDS_MIN_WARP) or g.chunks > 1 and \
                pr.friends_layout(ncdim, g.per + 1, itemsize, g.staged) > \
                pr.FRIENDS_SMEM_DEFAULT
    if (q, nctrs) == (256, 2048):
        g = pr.friends_geometry(q, nctrs, 3, 8)
        assert (g.groups, g.chunks, g.per) == (8, 32, 64)
        g = pr.friends_geometry(q, nctrs, 3, 8, 114)
        assert (g.groups, g.chunks, g.per) == (8, 28, 74)
    # the kernel's own constants are the geometry's
    src = (Path(pr.__file__).resolve().parent.parent / "csrc" /
           "unif_wave.cu").read_text()
    for name in ("FRIENDS_WARPS", "FRIENDS_SMEM_DEFAULT", "FRIENDS_SMEM_MAX"):
        value = re.search(r"const (?:int|size_t) %s = ([\d *]+);" % name,
                          src).group(1)
        assert math.prod(int(f) for f in value.split("*")) == \
            getattr(pr, name)


def _friends_round(ftype, q, ndim, ncdim, nctrs, dtype, device, strict=None,
                   seed=3):
    """A round over ``nctrs`` friends about the cube's middle on ``device``
    with a hand-made state (width q - 5) and one wave's draws: the
    centres, offsets in and about the unit ball or cube shrunk by
    sqrt(ncdim) (so that most candidates stay in the cube in every
    dimension), the other dimensions' uniforms (NaN and values outside
    the cube among them)."""
    rs = get_rstate(seed + q + nctrs + ncdim)
    arrays = _friends_arrays(ncdim, nctrs, seed + ncdim, dtype, device,
                             lo=0.3, ftype=ftype)
    layout = {k: (tuple(v.shape), v.stride(), v.storage_offset(), v.dtype)
              for k, v in arrays.items()}
    rb = pr.UnifRound(q, ndim, ncdim, ndim, dtype, device, strict, layout,
                      ftype)
    rb.start(0.0, arrays, 9)
    rb.state.copy_(torch.tensor([q // 3, 2, 50, 3 * q, 5, max(q - 5, 0),
                                 9]))

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    draws = {"uc": t(rs.uniform(-1.1, 1.1, (q, ncdim)) / math.sqrt(ncdim)),
             "ua": t(rs.random(q)),
             "idx": t(rs.integers(0, nctrs, q), torch.int64),
             "u_ex": t(rs.choice([np.nan, -0.2, 0.0, 0.4, 1.0, 1.3],
                                 size=(q, ndim - ncdim)))
             if ndim > ncdim else None}
    return rb, draws


@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nan_and_out_of_cube_candidates_through_the_round(ftype, dtype):
    """``unif_valid`` on the CPU over a friends round in 3 of 5 dimensions
    with a loose dimension: a NaN offset makes a NaN candidate (invalid,
    passed to the likelihood's input unclamped), a candidate past a
    bounded edge is invalid, one past the loose dimension's edge but
    within its margin is valid where accepted, one past the margin is
    not; lanes past the width are invalid; ``u_prop`` and ``uclamp`` are
    the candidate with the other dimensions' uniforms, plain and
    clamped."""
    q, ndim, ncdim = 48, 5, 3
    strict = torch.tensor([True, False, True])
    rb, d = _friends_round(ftype, q, ndim, ncdim, 37, dtype, "cpu", strict)
    ctrs = rb.arrays["ctrs"]
    # lane 0 NaN; lane 1 past the bounded edge; lanes 2 and 3 past the
    # loose dimension's edge, within and past its margin (a centre moved
    # there, its offset 0); lane 4 a centre well inside
    d["uc"][0, 1] = math.nan
    for lane, (dim, v) in enumerate(((0, -0.01), (1, 1.2), (1, 1.6),
                                     (2, 0.5)), start=1):
        ctrs[lane, dim] = v
        d["idx"][lane] = lane
        d["uc"][lane] = 0.0
        d["ua"][lane] = 0.0
    ctrs[1:5, 2] = 0.5
    ctrs[1:5, 0] = torch.where(torch.arange(1, 5) == 1, ctrs[1:5, 0], 0.5)
    draws = (d["uc"], d["ua"], d["idx"], d["u_ex"])
    pr.unif_valid(rb, *draws)
    x, acc = pr.friends_union_plain(ftype, d["idx"], d["uc"], d["ua"],
                                    *(rb.arrays[k] for k in pr.UNIF_FRIENDS))
    assert bool(x[0].isnan().all()) and not bool(rb.valid[0])
    assert [bool(v) for v in rb.valid[1:5]] == [False, True, False, True]
    assert not bool(rb.valid[q - 5:].any())
    lanes = torch.arange(q)
    inside = ((x > 0) & (x < 1) | (~strict & (x > -0.5) & (x < 1.5))).all(1)
    assert torch.equal(rb.valid, acc & inside & (lanes < q - 5))
    assert 0 < int(rb.valid.sum()) < q - 5
    u_prop = torch.cat([x, d["u_ex"]], dim=1)
    same = (rb.u_prop == u_prop) | (rb.u_prop.isnan() & u_prop.isnan())
    assert bool(same.all()) and bool(rb.u_prop.isnan().any())
    clamped = u_prop.clamp(0.0, 1.0)
    assert bool(((rb.uclamp == clamped) |
                 (rb.uclamp.isnan() & clamped.isnan())).all())


def test_the_round_refuses_what_the_friends_kernel_cannot_take():
    arrays = _friends_arrays(3, 8, 1)
    layout = {k: (tuple(v.shape), v.stride(), v.storage_offset(), v.dtype)
              for k, v in arrays.items()}
    with pytest.raises(ValueError, match="no friends kind"):
        pr.UnifRound(8, 3, 3, 1, torch.float64, "cpu", None, layout, "rings")
    with pytest.raises(ValueError, match="take the arrays"):
        pr.UnifRound(8, 3, 3, 1, torch.float64, "cpu", None,
                     {"ctrs": layout["ctrs"]}, "balls")
    rb = pr.UnifRound(8, 3, 3, 1, torch.float64, "cpu", None, layout,
                      "balls")
    assert rb.nctrs == 8 and rb.m == 0
    assert all(v.is_contiguous() and v.dtype == torch.float64
               for v in rb.arrays.values())
    uc = torch.zeros((8, 3), dtype=torch.float64)
    ua = torch.zeros(8, dtype=torch.float64)
    idx = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="ua must be given"):
        rb.check_draws(uc, None, idx, None)
    with pytest.raises(ValueError, match="idx must be given"):
        rb.check_draws(uc, ua, None, None)
    with pytest.raises(TypeError, match="must be torch.int64"):
        rb.check_draws(uc, ua, idx.int(), None)
    with pytest.raises(ValueError, match="outside"):
        rb.check_draws(uc, ua, idx + 8, None)
    rb.check_draws(uc, ua, idx + 7, None)


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


@pytest.mark.parametrize("kind", ["cube", "ellipsoids", "balls", "cubes"])
def test_the_argument_tables_follow_the_kernels_structs(monkeypatch, kind):
    """``unif_valid``'s pointer table, as ``UnifRound`` binds it on the
    card, names the round's tensors in the order of its kernel's struct
    in ``csrc/unif_wave.cu`` (``ValidArgs``; over balls and cubes
    ``FriendsArgs``, the friends kernel's counts last), the
    draws left to each launch; the launch's ints carry the centres' count
    and the launch's geometry over balls and cubes, the slots' count over
    ellipsoids."""
    entries = []
    monkeypatch.setattr(pr, "_entry", lambda *a: entries.append(a[1]))
    friends = kind if kind in FTYPES else None
    if friends:
        arrays = _friends_arrays(3, 37, 2)
    elif kind == "ellipsoids":
        arrays = {"ctrs": torch.zeros((4, 3), dtype=torch.float64),
                  "axes": torch.zeros((4, 3, 3), dtype=torch.float64),
                  "ams": torch.zeros((4, 3, 3), dtype=torch.float64),
                  "logvols": torch.zeros(4, dtype=torch.float64),
                  "mask": torch.ones(4, dtype=torch.bool)}
    else:
        arrays = {}
    layout = {k: (tuple(v.shape), v.stride(), v.storage_offset(), v.dtype)
              for k, v in arrays.items()}
    rb = pr.UnifRound(8, 4, 3, 2, torch.float64, "cpu",
                      torch.tensor([True, False, True]), layout, friends)
    rb._bind()
    names = {t.data_ptr(): k for k, t in rb.arrays.items()}
    for k in ("strict", "state", "valid", "u_prop", "uclamp") + \
            (("counts",) if friends else ()):
        names[getattr(rb, k).data_ptr()] = k
    src = (Path(pr.__file__).resolve().parent.parent / "csrc" /
           "unif_wave.cu").read_text()
    want = _struct_fields(src, "FriendsArgs" if friends else "ValidArgs")
    got = [names.get(p) if p is not None else None for p in rb._valid_args]
    draws = ("offset", "u_ex", "ua", "idx") if friends else \
        ("uc", "u_ex", "ua")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w or (g is None and (w in draws or kind != "ellipsoids"
                                         and w in pr.UNIF_FORMS)), (g, w)
    assert entries[0] == (f"unif_{friends}" if friends else "unif_valid")
    if friends:
        g = rb.geometry
        assert g == pr.friends_geometry(8, 37, 3, 8)
        assert rb._valid_ints == (8, 4, 3, 37, g.chunks, g.per, 1)
        assert rb.counts.shape == (32,) and rb.counts.dtype == torch.int64
        assert not bool(rb.counts.any())
    else:
        assert rb._valid_ints == (8, 4, 3, rb.m)
        assert rb.counts is None


# --------------------------------------------------------------------------
# whole runs against the JAX package


@pytest.mark.parametrize("bound", FTYPES)
def test_a_unif_run_matches_the_jax_packages(jx, bound):
    """``bound='balls'|'cubes', sample='unif'`` at nlive 200, every other
    argument at its default (bootstrap 5), in both packages: logz within
    4 combined errors and of the truth, niter within 10 %."""
    jax, jnp, _, _, dytpu = jx

    def jax_loglike(x):
        return -0.5 * jnp.dot(x, jnp.asarray(_CINV_NP) @ x) + _LNORM

    s = dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=200,
                          bound=bound, sample="unif",
                          rstate=get_rstate(SEED), device="cpu")
    s.run_nested(print_progress=False)
    assert s.device_bound_kind() == bound
    j = dytpu.NestedSampler(jax_loglike, gau_ptform, NDIM, nlive=200,
                            bound=bound, sample="unif",
                            rstate=get_rstate(SEED))
    j.run_nested(print_progress=False)
    res, jres = s.results, j.results
    sig = np.hypot(res.logzerr[-1], jres.logzerr[-1])
    assert abs(res.logz[-1] - jres.logz[-1]) < 4 * sig
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 4 * res.logzerr[-1]
    assert abs(res.niter - jres.niter) <= 0.1 * jres.niter
    assert int(np.sum(res.ncall)) == s.ncall


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("q", [1, 37, 256])
@pytest.mark.parametrize("nctrs", [1, 2048, 16384])
@pytest.mark.parametrize("ncdim", [3, 15, 40])
def test_the_kernel_equals_the_plain_version_on_the_card(cuda, ftype, dtype,
                                                         q, nctrs, ncdim):
    """Every output of ``unif_valid``'s friends mode bit for bit with the
    plain version on the same CUDA tensors, with a loose dimension and
    two dimensions outside the bound."""
    strict = torch.ones(ncdim, dtype=torch.bool)
    strict[1] = False
    rb, d = _friends_round(ftype, q, ncdim + 2, ncdim, nctrs, dtype, cuda,
                           strict)
    draws = (d["uc"], d["ua"], d["idx"], d["u_ex"])
    rb.check_draws(*draws)
    ref = pr.unif_valid_round_plain(rb, *draws)
    pr.zero_counts()
    pr.unif_valid(rb, *draws)
    torch.cuda.synchronize()
    assert pr.unif_valid.launches == 1
    for got, want in zip((rb.valid, rb.u_prop, rb.uclamp), ref):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    if q > 1:
        assert int(rb.valid.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_thresholds_on_the_card(cuda, ftype, dtype):
    """The threshold lanes through the kernel: bit for bit with the plain
    version and as the thresholds say."""
    arrays, idx, offset, ua, expect = _threshold_draws(ftype, dtype, cuda)
    q = len(idx)
    layout = {k: (tuple(v.shape), v.stride(), v.storage_offset(), v.dtype)
              for k, v in arrays.items()}
    rb = pr.UnifRound(q, 3, 3, 3, dtype, cuda, None, layout, ftype)
    rb.start(0.0, arrays, 9)
    ref = pr.unif_valid_round_plain(rb, offset, ua, idx)
    pr.unif_valid(rb, offset, ua, idx)
    torch.cuda.synchronize()
    assert torch.equal(rb.valid, ref[0]) and torch.equal(rb.valid, expect)
    assert torch.equal(rb.u_prop, ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", FTYPES)
def test_a_nan_entry_of_a_distance_on_the_card(cuda, ftype):
    ctrs = torch.tensor([[0.4, 0.5, 0.5], [0.45, 0.5, 0.5]],
                        dtype=torch.float64, device=cuda)
    binv = 10 * torch.eye(3, dtype=torch.float64, device=cuda)
    binv[1, 2] = math.nan
    arrays = {"ctrs": ctrs,
              "axes": torch.eye(3, dtype=torch.float64, device=cuda) / 10,
              "axes_inv": binv}
    layout = {k: (tuple(v.shape), v.stride(), v.storage_offset(), v.dtype)
              for k, v in arrays.items()}
    q = 16
    rb = pr.UnifRound(q, 3, 3, 3, torch.float64, cuda, None, layout, ftype)
    rb.start(0.0, arrays, 9)
    idx = torch.arange(q, device=cuda) % 2
    offset = torch.zeros((q, 3), dtype=torch.float64, device=cuda)
    ua = torch.full((q,), 0.6, dtype=torch.float64, device=cuda)
    ref = pr.unif_valid_round_plain(rb, offset, ua, idx)
    pr.unif_valid(rb, offset, ua, idx)
    torch.cuda.synchronize()
    assert torch.equal(rb.valid, ref[0]) and bool(rb.valid.all())


def _same_outputs(rb, ref):
    """``unif_valid``'s outputs on ``rb`` bit for bit with ``ref``, and the
    friends kernel's counts all zero."""
    return all(torch.equal(got.view(torch.uint8), want.view(torch.uint8))
               for got, want in zip((rb.valid, rb.u_prop, rb.uclamp),
                                    ref)) and not bool(rb.counts.any())


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("width", [0, 1, 37, 255])
def test_a_narrowed_width_on_the_card(cuda, ftype, dtype, width):
    """A wave narrowed to ``width`` of q 256 lanes (2048 centres in 3-D):
    the lanes past it count nothing and are invalid, their likelihood
    input still written; every output bit for bit with the plain
    version."""
    q = 256
    rb, d = _friends_round(ftype, q, NDIM + 2, NDIM, 2048, dtype, cuda)
    rb.state[pr.U_WIDTH] = width
    draws = (d["uc"], d["ua"], d["idx"], d["u_ex"])
    ref = pr.unif_valid_round_plain(rb, *draws)
    rb.valid.fill_(True)
    pr.unif_valid(rb, *draws)
    torch.cuda.synchronize()
    assert _same_outputs(rb, ref)
    assert not bool(rb.valid[width:].any())
    if width > 1:
        assert int(rb.valid.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_repeated_launches_and_replays_on_the_card(cuda, ftype, dtype):
    """Twenty launches back to back, then twenty replays of a captured
    launch, at the drives' shape (q 256, 2048 centres in 3-D) and at 15-D:
    each writes the plain version's bits (the outputs poisoned before
    it), and leaves the counts zero."""
    for ncdim in (NDIM, 15):
        rb, d = _friends_round(ftype, 256, ncdim + 2, ncdim, 2048, dtype,
                               cuda)
        draws = (d["uc"], d["ua"], d["idx"], d["u_ex"])
        ref = pr.unif_valid_round_plain(rb, *draws)

        def poison():
            rb.valid.fill_(True)
            rb.u_prop.fill_(-7.0)
            rb.uclamp.fill_(-7.0)

        for _ in range(20):
            poison()
            pr.unif_valid(rb, *draws)
            torch.cuda.synchronize()
            assert _same_outputs(rb, ref)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            pr.unif_valid(rb, *draws)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            pr.unif_valid(rb, *draws)
        for _ in range(20):
            poison()
            graph.replay()
            torch.cuda.synchronize()
            assert _same_outputs(rb, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ncdim", [1, 2, 4, 5, 8, 16, 17, 70])
@pytest.mark.parametrize("q,nctrs", [(37, 200), (256, 2047)])
def test_chunks_that_do_not_divide_the_centres_on_the_card(
        cuda, ftype, dtype, ncdim, q, nctrs):
    """Centre counts that no chunk divides (a short last chunk), at the
    register kernels' widths either side of their limits (B whole in
    registers up to 4 dimensions, the candidate up to 16), the generic
    loop's 17 and 70 (in float64 the inverse axes past the shared-memory
    default, read from device memory): bit for bit with the plain
    version."""
    strict = None
    if ncdim > 1:
        strict = torch.ones(ncdim, dtype=torch.bool)
        strict[1] = False
    rb, d = _friends_round(ftype, q, ncdim + 1, ncdim, nctrs, dtype, cuda,
                           strict)
    assert nctrs % rb.geometry.per != 0 and rb.geometry.chunks > 1
    assert rb.geometry.staged == (ncdim < 70 or dtype == torch.float32)
    draws = (d["uc"], d["ua"], d["idx"], d["u_ex"])
    ref = pr.unif_valid_round_plain(rb, *draws)
    pr.unif_valid(rb, *draws)
    torch.cuda.synchronize()
    assert _same_outputs(rb, ref)
    assert int(rb.valid.sum()) > 0


class _EagerLike(LogLikelihood):
    """A likelihood the rule keeps out of a graph: its waves launch both
    kernels eagerly."""

    def capturable(self):
        return False


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_captured_friends_wave_equals_an_eager_one_on_the_card(cuda, ftype,
                                                                 dtype):
    """Three rounds at the drives' width (q 256, 2048 centres in 3-D) on
    one round cache, captured waves against eager ones: every column, the
    generator's offset and the counts; ``unif_valid`` once a wave."""
    q, seeds = 256, (11, 12, 13)
    arrays = _friends_arrays(NDIM, 2048, 5, dtype, cuda)
    outs = {}
    for cls in (LogLikelihood, _EagerLike):
        like = cls(lambda x: -0.5 * (((x - 0.5) / 0.2) ** 2).sum(), lambda u: u,
                   NDIM, device=cuda, dtype=dtype)
        like.eval_host(np.full((2, NDIM), 0.5))
        timings = Timings()
        fn = tk.make_unif_round(like, ndim=NDIM, ncdim=NDIM, q=q,
                                bound_kind=ftype, dtype=dtype, device=cuda,
                                timings=timings, rounds={})
        pr.zero_counts()
        got = []
        for seed in seeds:
            gen = torch.Generator(device=cuda)
            gen.manual_seed(seed)
            packed, _ = fn(gen, -1.5, arrays)
            torch.cuda.synchronize()
            got.append((packed, gen.get_offset()))
        assert pr.unif_valid.launches == pr.unif_place.launches == \
            timings["sync_wave"] > len(seeds)
        outs[cls] = got, timings
    (got, tg), (ref, te) = outs[LogLikelihood], outs[_EagerLike]
    for (p, off), (pe, offe) in zip(got, ref):
        assert torch.equal(p, pe) and off == offe
    assert tg["n_unif_replay"] == tg["sync_wave"] - 1
    assert te["n_uncaptured"] == te["sync_wave"]
