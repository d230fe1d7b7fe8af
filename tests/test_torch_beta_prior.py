"""The Beta prior's kernels (``dynesty_tpu_torch/ops/beta_prior.py``,
``csrc/beta_prior.cu``): the operators ``dynesty_tpu_torch::beta_ppf``
and ``::betainc`` and the priors that call them.

On the CPU: each operator under ``torch.func.vmap`` (in_dims 0 and 1,
nested, a ``PriorTransform`` mixing Beta with the other five priors,
float32 and float64, the ends u = 0 and 1 and NaN, ``niter`` other than
50, tensor ``a``, ``b`` broadcast) bit for bit against the plain versions
on contiguous inputs; ``Beta`` and ``PriorTransform`` against the JAX
package's (1e-8 absolute for Beta, 1e-12 relative for the rest); a short
sampler run with a Beta prior in both packages against each other and a
``scipy.integrate.quad`` truth; the kernel source's constants and entry
signatures against the Python side's; and a CUDA call with building
disabled, which raises without reaching the plain version.

On a card (``cuda``-marked, skipped here): each kernel against its plain
version bit for bit over 25 (a, b) pairs at (256,) and (2^20,), under
``vmap`` and replayed from a captured graph, and a sampler whose waves
replay its Beta kernel, counted once a call and once a replay (a
``PriorTransform``'s Beta dimensions in one launch; the grouped kernel's
own tests are ``tests/test_torch_beta_tree.py``).  The JAX package is
imported by a fixture only, so that on the card

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_beta_prior.py

runs the card's tests.
"""

import ctypes
import math
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import scipy.integrate as si
import scipy.stats as st
import torch

import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.models as tm
from dynesty_tpu_torch.ops import beta_prior as bp
from dynesty_tpu_torch.ops import build

from utils import get_rstate

torch.set_num_threads(1)

DTYPES = [torch.float64, torch.float32]
_AB = [0.5, 1.0, 2.0, 5.0, 30.0]
# the ends of u and x, and a NaN
EDGES = [0.0, 1.0, 1e-12, 1 - 1e-12, math.nan]
SRC = Path(bp.__file__).resolve().parent.parent / "csrc" / "beta_prior.cu"


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u(shape, dtype, seed=5, device="cpu"):
    """Seeded uniforms with the edges first."""
    u = get_rstate(seed).random(shape).reshape(-1)
    u[:len(EDGES)] = EDGES
    return torch.as_tensor(u.reshape(shape), dtype=dtype, device=device)


def _same(a, b):
    """Equal bits where both are numbers, NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


# --------------------------------------------------------------------------
# the operators under vmap on the CPU: the plain version, bit for bit


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["dim0", "dim1", "nested"])
def test_beta_ppf_under_vmap_is_the_plain_version(dtype, mode):
    u = _u((6, 5), dtype)
    niter = {"dim0": 50, "dim1": 13, "nested": 7}[mode]

    def one(x):
        return bp.beta_ppf(x, 2.0, 5.0, niter)

    if mode == "dim0":
        got, want = torch.func.vmap(one)(u), bp.beta_ppf_plain(u, 2.0, 5.0,
                                                               niter)
    elif mode == "dim1":
        got = torch.func.vmap(one, in_dims=1)(u)
        want = bp.beta_ppf_plain(u, 2.0, 5.0, niter).T
    else:
        got = torch.func.vmap(torch.func.vmap(one))(u)
        want = bp.beta_ppf_plain(u, 2.0, 5.0, niter)
    assert _same(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["numbers", "tensors", "batched_a",
                                  "nested"])
def test_betainc_under_vmap_is_the_plain_version(dtype, mode):
    x = _u((7, 3), dtype, seed=6)
    a = torch.tensor([0.5, 2.0, 30.0], dtype=dtype)
    b = torch.tensor([1.0, 5.0, 0.5], dtype=dtype)
    if mode == "numbers":
        got = torch.func.vmap(lambda r: bp.betainc(2.0, 5.0, r))(x)
        want = bp.betainc_plain(2.0, 5.0, x)
    elif mode == "tensors":
        # (3,) a and b broadcast with each row
        got = torch.func.vmap(lambda r: bp.betainc(a, b, r))(x)
        want = bp.betainc_plain(a, b, x)
    elif mode == "batched_a":
        # a batched along x's columns, b unbatched, x batched along dim 1
        av = torch.tensor(_AB + [3.0, 7.0], dtype=dtype)
        got = torch.func.vmap(lambda ai, r: bp.betainc(ai, b, r),
                              in_dims=(0, 1))(av, x.T.contiguous())
        want = bp.betainc_plain(av[:, None], b, x)
    else:
        got = torch.func.vmap(torch.func.vmap(
            lambda xi, ai, bi: bp.betainc(ai, bi, xi)), in_dims=(0, None,
                                                                None))(
            x, a, b)
        want = bp.betainc_plain(a, b, x)
    assert _same(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_a_prior_transform_mixing_beta_with_every_prior(dtype):
    """Beta beside the other five priors under vmap: the Beta columns are
    the plain version's, the others unchanged (each prior alone)."""
    priors = [tm.TopHat(-5.0, 5.0), tm.Beta(2.0, 5.0), tm.Normal(1.0, 2.0),
              tm.ClippedNormal(0.0, 1.0, -1.0, 2.0), tm.LogNormal(0.0, 0.5),
              tm.LogUniform(1e-3, 1e3), tm.Beta(0.5, 0.5, niter=20)]
    u = _u((9, len(priors)), dtype, seed=7)
    u[0, 2:6] = 0.5  # the edges only where every prior takes them
    got = torch.func.vmap(tm.PriorTransform(priors))(u)
    assert got.dtype == dtype
    for i, p in enumerate(priors):
        col = u[:, i].contiguous()
        if isinstance(p, tm.Beta):
            want = bp.beta_ppf_plain(col, p.alpha, p.beta, p.niter)
        else:
            want = torch.func.vmap(p)(col)
        assert _same(got[:, i], want), type(p).__name__


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_the_ends_and_nan(dtype):
    """u = 0 bisects to the lowest midpoint, u = 1 and NaN as the plain
    version does (a NaN comparison is false: hi moves); I_0 = 0, I_1 = 1."""
    u = torch.tensor(EDGES, dtype=dtype)
    got = bp.beta_ppf(u, 30.0, 1.0)
    assert _same(got, bp.beta_ppf_plain(u, 30.0, 1.0))
    assert got[0].item() == 2.0 ** -51 and got[4].item() == got[0].item()
    x = torch.tensor([0.0, 1.0], dtype=dtype)
    for a, b in [(0.5, 0.5), (2.0, 5.0), (30.0, 1.0)]:
        assert bp.betainc(a, b, x).tolist() == [0.0, 1.0]


@pytest.mark.parametrize("niter", [0, 1, 3, 13])
def test_niter(niter):
    u = _u((40,), torch.float64, seed=8)
    assert _same(bp.beta_ppf(u, 5.0, 2.0, niter),
                 bp.beta_ppf_plain(u, 5.0, 2.0, niter))
    if niter == 0:
        assert (bp.beta_ppf(u, 5.0, 2.0, 0) == 0.5).all()


def test_tensor_a_b_broadcast():
    """Tensor a and b of other shapes, dtypes and 0-d, numbers, a Python
    float for x: the plain version's result, shape and dtype."""
    x = _u((4, 5), torch.float64, seed=9)
    cases = [
        (torch.tensor([[0.5], [2.0], [5.0], [30.0]]), 2.0),
        (torch.tensor(2.0, dtype=torch.float64), torch.tensor(_AB)),
        (3, torch.tensor(_AB, dtype=torch.float32)[None, :]),
    ]
    for a, b in cases:
        got = bp.betainc(a, b, x)
        assert _same(got, bp.betainc_plain(a, b, x))
    got = bp.betainc(torch.tensor([[2.0], [3.0]]), 5.0, x[0])
    assert got.shape == (2, 5)
    assert _same(got, bp.betainc_plain(torch.tensor([[2.0], [3.0]]), 5.0,
                                       x[0]))
    assert _same(bp.betainc(2.0, 5.0, 0.25), bp.betainc_plain(2.0, 5.0, 0.25))
    # the prior's module keeps its entry
    from dynesty_tpu_torch.models.priors import _betainc
    assert _same(_betainc(2.0, 5.0, x), bp.betainc_plain(2.0, 5.0, x))


def test_the_operators_have_cuda_and_batching_kernels():
    for op in ("dynesty_tpu_torch::beta_ppf", "dynesty_tpu_torch::betainc"):
        for key in ("CUDA", "FuncTorchBatched", "Meta",
                    "CompositeExplicitAutograd"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op, key), \
                (op, key)
    # shapes without data: the fake kernels
    meta = torch.empty((3, 4), dtype=torch.float64, device="meta")
    assert bp.beta_ppf(meta, 2, 5).shape == (3, 4)
    assert bp.betainc(torch.empty((3, 1), device="meta",
                                  dtype=torch.float64), 2.0, meta).shape == \
        (3, 4)


# --------------------------------------------------------------------------
# against the JAX package


@pytest.mark.parametrize("alpha,beta", [(2.0, 5.0), (0.5, 0.5), (30.0, 1.0),
                                        (5.0, 2.0)])
def test_beta_matches_jax(jx, alpha, beta):
    jax, jnp, jm = jx
    u = get_rstate(4).random(200)
    want = np.asarray(jax.vmap(jm.Beta(alpha, beta))(jnp.asarray(u)))
    got = torch.func.vmap(tm.Beta(alpha, beta))(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_prior_transform_matches_jax(jx):
    jax, jnp, jm = jx

    def priors(m):
        return m.PriorTransform([m.Beta(2.0, 5.0), m.TopHat(-5.0, 5.0),
                                 m.Beta(0.5, 0.5), m.Normal(1.0, 2.0),
                                 m.LogUniform(1e-3, 1e3), m.Beta(5.0, 2.0)])

    u = get_rstate(5).random((150, 6))
    want = np.asarray(jax.vmap(priors(jm))(jnp.asarray(u)))
    got = torch.func.vmap(priors(tm))(torch.as_tensor(u)).numpy()
    beta = [0, 2, 5]
    rest = [1, 3, 4]
    np.testing.assert_allclose(got[:, beta], want[:, beta], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got[:, rest], want[:, rest], rtol=1e-12,
                               atol=0)


# the short run: a Beta(2, 5) and a TopHat(0, 2) dimension under a
# Gaussian likelihood; its evidence by quadrature
RUN_MU, RUN_SIGMA = (0.3, 1.2), (0.1, 0.3)


def _run_truth(niter):
    """log Z = log of the Beta dimension's integral plus the TopHat's."""
    pdf = [lambda x: st.beta.pdf(x, 2.0, 5.0), lambda x: 0.5 + 0 * x]
    lims = [(0.0, 1.0), (0.0, 2.0)]
    out = 0.0
    for f, (lo, hi), mu, s in zip(pdf, lims, RUN_MU, RUN_SIGMA):
        v, _ = si.quad(lambda x: f(x) * st.norm.pdf(x, mu, s), lo, hi,
                       points=[mu], limit=200)
        out += math.log(v)
    return out


def _run_pair(jx, nlive, niter, q):
    jax, jnp, jm = jx
    mu, sig = np.array(RUN_MU), np.array(RUN_SIGMA)
    lnorm = float(-np.sum(np.log(sig * np.sqrt(2 * np.pi))))

    def jlike(x):
        return -0.5 * jnp.sum(((x - mu) / sig) ** 2) + lnorm

    mu_t, sig_t = torch.as_tensor(mu), torch.as_tensor(sig)

    def tlike(x):
        return -0.5 * (((x - mu_t) / sig_t) ** 2).sum() + lnorm

    def prior(m):
        return m.PriorTransform([m.Beta(2.0, 5.0, niter=niter),
                                 m.TopHat(0.0, 2.0)])

    common = dict(nlive=nlive, bound="single", sample="unif", queue_size=q)
    import dynesty_tpu as dytpu
    js = dytpu.NestedSampler(jlike, prior(jm), 2, rstate=get_rstate(),
                             **common)
    ts = dyt.NestedSampler(tlike, prior(tm), 2, rstate=get_rstate(),
                           device="cpu", **common)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js.run_nested(print_progress=False, dlogz=0.5)
        ts.run_nested(print_progress=False, dlogz=0.5)
    return js.results, ts.results


def _check_pair(jr, tr, truth):
    assert abs(tr.niter - jr.niter) <= 0.1 * jr.niter, (tr.niter, jr.niter)
    err = np.hypot(tr.logzerr[-1], jr.logzerr[-1])
    assert abs(tr.logz[-1] - jr.logz[-1]) < 3 * err, \
        (tr.logz[-1], jr.logz[-1], err)
    for r in (tr, jr):
        assert abs(r.logz[-1] - truth) < 4 * r.logzerr[-1], \
            (r.logz[-1], truth, r.logzerr[-1])
    # every sample of the Beta dimension in its support
    assert np.all((tr.samples[:, 0] > 0) & (tr.samples[:, 0] < 1))


def test_a_short_run_with_a_beta_prior_matches_jax(jx):
    """nlive 60 and 20 bisection steps (a Beta prior's quantile to ~1e-6)
    in both packages on the CPU: niter within 10 %, logz within 3 combined
    errors of each other and within 4 logzerr of the quadrature."""
    jr, tr = _run_pair(jx, nlive=60, niter=20, q=32)
    _check_pair(jr, tr, _run_truth(20))


@pytest.mark.slow
def test_a_run_with_a_beta_prior_matches_jax(jx):
    """The same at nlive 250 and the default 50 bisection steps."""
    jr, tr = _run_pair(jx, nlive=250, niter=50, q=64)
    _check_pair(jr, tr, _run_truth(50))


# --------------------------------------------------------------------------
# the kernel source against the Python side


def test_the_kernel_constants_are_the_plain_versions():
    """The continued fraction's terms and Lentz's guard in
    ``csrc/beta_prior.cu`` are the plain version's; in float32 the
    guard's constant rounds to 0, so the plain guard never fires and the
    kernel's float guard returns its argument."""
    src = SRC.read_text()
    iters = re.search(r"const int BETAINC_ITERS = (\d+);", src).group(1)
    tiny = re.search(r"const double TINY = ([\d.e+-]+);", src).group(1)
    assert int(iters) == bp._BETAINC_ITERS == 64
    assert float(tiny) == bp._TINY == 1e-300
    # beta_ppf's table capacity and its most levels a round (a warp an
    # element: 2^5 - 1 nodes in 32 lanes)
    table = re.search(r"const int TABLE = (\d+);", src).group(1)
    levels = re.search(r"const int MAX_LEVELS = (\d+);", src).group(1)
    assert int(table) == bp.TABLE == 32
    assert int(levels) == bp.MAX_LEVELS == 5
    assert re.search(r"int col\[TABLE\];\s+T a\[TABLE\], b\[TABLE\];", src)
    assert re.search(r"float guard\(float t\) \{ return t; \}", src)
    assert re.search(r"double guard\(double t\) \{ return fabs\(t\) < TINY "
                     r"\? TINY : t; \}", src)
    assert torch.tensor(bp._TINY, dtype=torch.float32).item() == 0.0
    small = torch.tensor([0.0, -0.0, 1e-45, -1e-45, math.nan],
                         dtype=torch.float32)
    assert _same(bp._guard(small), small)
    g = bp._guard(torch.tensor([0.0, -1e-301, 1e-299], dtype=torch.float64))
    assert g.tolist() == [1e-300, 1e-300, 1e-299]


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "i64": ctypes.c_longlong, "double": ctypes.c_double,
           "int": ctypes.c_int,
           "const i64*": ctypes.POINTER(ctypes.c_longlong),
           "const double*": ctypes.POINTER(ctypes.c_double)}


@pytest.mark.parametrize("fn", sorted(bp.ENTRY_ARGTYPES))
def test_each_entry_argtypes_follow_its_c_signature(fn):
    src = SRC.read_text()
    sig = re.search(r'extern "C" int dynesty_%s_##TAG\((.*?)\)' % fn,
                    src.replace("\\\n", " "), re.S).group(1)
    types = [re.sub(r"\s*\w+$", "", arg.strip()) for arg in sig.split(",")]
    assert [_CTYPES[re.sub(r"\s+", " ", t)] for t in types] == \
        bp.ENTRY_ARGTYPES[fn]
    assert types[-1] == "void*"  # the stream


@pytest.mark.parametrize("fn", ["beta_ppf", "betainc"])
def test_a_cuda_call_without_build_raises_before_any_plain_step(
        monkeypatch, fn):
    """The operators' CUDA kernels (called here as the dispatcher calls
    them on a CUDA tensor; ``beta_ppf`` with one column and with a
    three-column table) with building disabled raise and never reach the
    plain versions; the default implementation refuses a tensor off the
    CPU; another dtype raises on the card."""
    monkeypatch.setenv("DYNESTY_TPU_TORCH_NO_BUILD", "1")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(bp, "_ENTRY", {})

    def plain(*a, **kw):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(bp, "beta_ppf_plain", plain)
    monkeypatch.setattr(bp, "betainc_plain", plain)
    x = torch.full((8,), 0.3, dtype=torch.float64)
    launches = getattr(bp, fn).launches
    with pytest.raises(RuntimeError, match="disabled"):
        if fn == "beta_ppf":
            bp._beta_ppf_cuda(x[:, None], [0], [2.0], [5.0], 50)
        else:
            bp._betainc_cuda(x[:1], x[:1], x)
    if fn == "beta_ppf":
        with pytest.raises(RuntimeError, match="disabled"):
            bp._beta_ppf_cuda(x.reshape(2, 4), [3, 0, 1], [2.0, 0.5, 5.0],
                              [5.0, 0.5, 2.0], 50)
    assert getattr(bp, fn).launches == launches
    meta = torch.empty(8, dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        if fn == "beta_ppf":
            bp._beta_ppf_default(meta[:, None], [0], [2.0], [5.0], 50)
        else:
            bp._betainc_default(meta, meta, meta)
    if fn == "beta_ppf":
        with pytest.raises(RuntimeError, match="no kernel"):
            bp._beta_ppf_default(meta.reshape(2, 4), [3, 0, 1],
                                 [2.0, 0.5, 5.0], [5.0, 0.5, 2.0], 50)
    with pytest.raises(TypeError, match="float64 or float32"):
        bp._entry(fn, torch.float16)


# --------------------------------------------------------------------------
# on the card


def _pairs():
    return [(a, b) for a in _AB for b in _AB]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 2 ** 20])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_the_kernels_match_the_plain_versions_on_the_card(cuda, dtype, n):
    """Every (a, b) of the sweep: the kernel with numbers a, b over the
    whole of u against the plain version with a and b per element (pair
    k at the elements i = k mod 25; the edges at every pair's first
    elements), which on the card is the plain version with numbers; the
    Beta(2, 5) case also against the plain version with numbers, and
    betainc with per-element a, b in one call."""
    pairs = _pairs()
    k = len(pairs)
    u = _u((n,), dtype, seed=10, device=cuda)
    u[:len(EDGES) * k] = torch.tensor(EDGES, dtype=dtype).repeat_interleave(
        k).to(cuda)
    a = torch.tensor([p[0] for p in pairs], dtype=dtype,
                     device=cuda).repeat(n // k + 1)[:n]
    b = torch.tensor([p[1] for p in pairs], dtype=dtype,
                     device=cuda).repeat(n // k + 1)[:n]
    want = bp.beta_ppf_plain(u, a, b)
    for i, (pa, pb) in enumerate(pairs):
        got = bp.beta_ppf(u, pa, pb)
        assert _same(got[i::k], want[i::k]), (pa, pb)
    assert _same(bp.beta_ppf(u, 2.0, 5.0), bp.beta_ppf_plain(u, 2.0, 5.0))
    assert _same(bp.betainc(a, b, u), bp.betainc_plain(a, b, u))
    assert _same(bp.betainc(2.0, 5.0, u), bp.betainc_plain(2.0, 5.0, u))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_under_vmap_and_replayed_on_the_card(cuda, dtype):
    """A (256, 3) prior of three Betas under vmap: the plain version's
    bits, one launch (the three Beta dimensions in one table); captured
    once (one launch counted at the capture), replayed 20 times, the same
    bits each time."""
    ab = [(2.0, 5.0), (0.5, 0.5), (5.0, 2.0)]
    pt = tm.PriorTransform([tm.Beta(a, b) for a, b in ab])
    u = _u((256, 3), dtype, seed=11, device=cuda)
    want = torch.stack([bp.beta_ppf_plain(u[:, i].contiguous(), a, b)
                        for i, (a, b) in enumerate(ab)], 1)
    n0 = bp.beta_ppf.launches
    assert _same(torch.func.vmap(pt)(u), want)
    assert bp.beta_ppf.launches == n0 + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = torch.func.vmap(pt)(u)
    assert bp.beta_ppf.launches == n0 + 2
    for _ in range(20):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert _same(out, want)


def _beta_loglike(x):
    return -0.5 * ((x[0] - 0.3) / 0.1) ** 2


class _CountingPrior:
    """A prior's calls on the card (the eager and the captured ones)."""

    def __init__(self, pt):
        self.pt, self.calls = pt, 0

    def __call__(self, u):
        self.calls += u.device.type == "cuda"
        return self.pt(u)


@pytest.mark.cuda
def test_a_sampler_replays_its_beta_kernel_on_the_card(cuda):
    """A run with two Beta dimensions on the card: no capture warning,
    every wave but one warm-up a shape replayed, and ``beta_ppf`` counted
    once a prior call and once a replay (the two Betas in one launch; a
    capture records the call without running it).  The likelihood reads
    the first dimension only, so the others add nothing to log Z."""
    prior = _CountingPrior(tm.PriorTransform([tm.Beta(2.0, 5.0),
                                              tm.TopHat(0.0, 1.0),
                                              tm.Beta(0.5, 0.5)]))
    bp.zero_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        s = dyt.NestedSampler(_beta_loglike, prior, 3, nlive=200,
                              bound="single", sample="unif", queue_size=64,
                              rstate=get_rstate())
        s.run_nested(print_progress=False, dlogz=0.5)
    t = s.timings
    assert t["n_unif_replay"] > 0
    runs = prior.calls - t["n_unif_graph"] + t["n_unif_replay"]
    assert bp.beta_ppf.launches == runs
    assert abs(s.results.logz[-1] - _run_truth_beta_only()) < \
        4 * s.results.logzerr[-1]


def _run_truth_beta_only():
    v, _ = si.quad(lambda x: st.beta.pdf(x, 2.0, 5.0) *
                   math.exp(-0.5 * ((x - 0.3) / 0.1) ** 2), 0.0, 1.0,
                   points=[0.3], limit=200)
    return math.log(v)


@pytest.mark.cuda
def test_a_cuda_call_without_build_raises_on_the_card(cuda, monkeypatch):
    monkeypatch.setenv("DYNESTY_TPU_TORCH_NO_BUILD", "1")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(bp, "_ENTRY", {})
    monkeypatch.setattr(bp, "beta_ppf_plain", None)
    launches = bp.beta_ppf.launches
    with pytest.raises(RuntimeError, match="disabled"):
        bp.beta_ppf(torch.full((8,), 0.3, device=cuda), 2.0, 5.0)
    assert bp.beta_ppf.launches == launches
    with pytest.raises(TypeError, match="float64 or float32"):
        bp.beta_ppf(torch.full((8,), 0.3, device=cuda, dtype=torch.float16),
                    2.0, 5.0)
