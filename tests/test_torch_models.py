"""``dynesty_tpu_torch.models`` against ``dynesty_tpu.models`` on the CPU:
each problem's ``loglike`` and ``ptform``, each prior, the torch
``betainc``, and a short run of each problem in both packages.

Tolerances.  ``ptform`` is the same float64 arithmetic in both packages:
equal bits.  ``loglike`` is held at 1e-12 relative; Rosenbrock and the
wedding cake (elementwise arithmetic, a floor and a power of the same
inputs) give the same bits, and the wedding cake's centre reads -0.0 in
both.  A matrix product (the correlated Gaussian) sums in the library's
order and the transcendental functions are XLA's and ATen's, so those
agree to a few ulp.  The priors are held at 1e-12 relative, ``Beta`` at
1e-8 absolute (a bisection step flips where the two ``betainc`` agree only
to an ulp), and ``_betainc`` at 1e-10 absolute against
``scipy.special.betainc`` (the continued fraction agrees with scipy to
~1e-14 except where scipy loses digits near x = 1: 3.5e-11 at
I_{1-1e-12}(1/2, 1/2)).  Runs draw from torch Philox in the port and JAX
threefry in the JAX package: niter within 10 %, logz within 3 combined
errors, and the evidence gate where the truth is known.
"""

import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import scipy.stats as st
import torch

import dynesty_tpu as dytpu
import dynesty_tpu.models as jm
import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.models as tm
from dynesty_tpu_torch.models.priors import _betainc

from utils import get_rstate

torch.set_num_threads(1)

NPTS = 1000

PROBLEMS = [
    ("CorrelatedGaussian", {"ndim": 3}),
    ("CorrelatedGaussian", {"ndim": 15}),
    ("Eggbox", {}),
    ("GaussianShells", {}),
    ("Rosenbrock", {"ndim": 2}),
    ("Rosenbrock", {"ndim": 5}),
    ("WeddingCake", {}),
    ("LogGamma", {"ndim": 2}),
    ("LogGamma", {"ndim": 5}),
]
BIT_EXACT = {"Rosenbrock", "WeddingCake"}


def _ids(cases):
    return [f"{n}-{kw.get('ndim', '')}" for n, kw in cases]


def _jax_eval(fn, x):
    return np.asarray(jax.vmap(fn)(jnp.asarray(x)))


def _torch_eval(fn, x):
    return torch.func.vmap(fn)(torch.as_tensor(np.array(x))).numpy()


@pytest.mark.parametrize("name,kw", PROBLEMS, ids=_ids(PROBLEMS))
def test_problem_matches_jax(name, kw):
    jp, tp = getattr(jm, name)(**kw), getattr(tm, name)(**kw)
    assert tp.ndim == jp.ndim
    u = np.random.Generator(np.random.PCG64(7)).random((NPTS, jp.ndim))
    if name == "WeddingCake":
        u[0] = 0.5  # the centre: an infinite plateau index
    jv, tv = _jax_eval(jp.ptform, u), _torch_eval(tp.ptform, u)
    assert np.array_equal(jv, tv)
    jl, tl = _jax_eval(jp.loglike, jv), _torch_eval(tp.loglike, jv)
    assert np.all(np.isfinite(tl))
    if name in BIT_EXACT:
        assert np.array_equal(jl, tl)
    else:
        np.testing.assert_allclose(tl, jl, rtol=1e-12, atol=0)
    if name == "WeddingCake":
        assert jl[0] == 0.0 and np.signbit(jl[0])
        assert tl[0] == 0.0 and np.signbit(tl[0])


@pytest.mark.parametrize("name,kw", PROBLEMS, ids=_ids(PROBLEMS))
def test_logz_truth_matches_jax(name, kw):
    jp, tp = getattr(jm, name)(**kw), getattr(tm, name)(**kw)
    assert tp.logz_truth == jp.logz_truth


def test_wedding_cake_centre():
    # an unclamped int32 cast of +inf gives int32's minimum and -inf
    prob = tm.WeddingCake()
    x = torch.full((2,), 0.5, dtype=torch.float64)
    val = prob.loglike(x)
    assert val.item() == 0.0 and torch.signbit(val).item()
    assert prob.loglike(x.float()).item() == 0.0


def test_correlated_gaussian_rounds_cinv_to_float32():
    # the JAX package rounds the precision matrix to float32 and promotes
    # it where it meets a float64 point; without the rounding the values
    # move at ~1e-8 relative
    prob = tm.CorrelatedGaussian(ndim=3)
    assert prob._cinv.dtype == np.float32
    cov = np.identity(3)
    cov[cov == 0] = 0.95
    x = np.array([1.0, -2.0, 0.5])
    exact = -0.5 * x @ np.linalg.inv(cov) @ x + prob._lnorm
    rounded = -0.5 * x @ np.linalg.inv(cov).astype(np.float32).astype(
        np.float64) @ x + prob._lnorm
    got = prob.loglike(torch.as_tensor(x)).item()
    assert got == pytest.approx(rounded, rel=1e-15)
    assert abs(got - exact) > 1e-9 * abs(exact)


def test_constants_follow_the_point():
    prob = tm.CorrelatedGaussian(ndim=3)
    x64 = torch.ones(3, dtype=torch.float64)
    x32 = torch.ones(3, dtype=torch.float32)
    assert prob.loglike(x64).dtype == torch.float64
    assert prob.loglike(x32).dtype == torch.float32
    keys = set(prob._consts)
    assert {k[2] for k in keys} == {torch.float64, torch.float32}
    assert {k[1] for k in keys} == {torch.device("cpu")}
    shells = tm.GaussianShells()
    out = torch.func.vmap(shells.loglike)(torch.zeros((4, 2),
                                                      dtype=torch.float32))
    assert out.dtype == torch.float32
    assert all(v.device == torch.device("cpu") and v.dtype == torch.float32
               for v in shells._consts.values())
    # the meta device stands in for another device: the constants follow
    meta = torch.empty(3, dtype=torch.float64, device="meta")
    assert prob._const("_cinv", meta).device == torch.device("meta")


@pytest.mark.parametrize("name,kw", PROBLEMS[:1] + PROBLEMS[3:4],
                         ids=_ids(PROBLEMS[:1] + PROBLEMS[3:4]))
def test_problems_pickle(name, kw):
    prob = getattr(tm, name)(**kw)
    x = torch.full((prob.ndim,), 0.25, dtype=torch.float64)
    before = prob.loglike(x)
    assert prob._consts
    back = pickle.loads(pickle.dumps(prob))
    assert "_consts" not in back.__dict__
    assert torch.equal(back.loglike(x), before)


# --------------------------------------------------------------------------
# priors

PRIORS = [
    ("TopHat", (-5.0, 3.0)),
    ("Normal", (1.0, 2.0)),
    ("ClippedNormal", (0.0, 1.0, -1.0, 2.0)),
    ("ClippedNormal", (0.5, 2.0)),
    ("LogNormal", (0.0, 0.5)),
    ("LogUniform", (1e-3, 1e3)),
]


@pytest.mark.parametrize("name,args", PRIORS,
                         ids=[f"{n}{a}" for n, a in PRIORS])
def test_prior_matches_jax(name, args):
    jp, tp = getattr(jm, name)(*args), getattr(tm, name)(*args)
    u = np.random.Generator(np.random.PCG64(3)).random(NPTS)
    want = np.asarray(jax.vmap(jp)(jnp.asarray(u)))
    got = torch.func.vmap(tp)(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("alpha,beta", [(2.0, 5.0), (0.5, 0.5), (30.0, 1.0)])
def test_beta_prior_matches_jax_and_scipy(alpha, beta):
    u = np.random.Generator(np.random.PCG64(4)).random(200)
    want = np.asarray(jax.vmap(jm.Beta(alpha, beta))(jnp.asarray(u)))
    got = torch.func.vmap(tm.Beta(alpha, beta))(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got, st.beta.ppf(u, alpha, beta), rtol=0,
                               atol=1e-8)


def test_prior_transform_matches_jax():
    def priors(m):
        return m.PriorTransform([m.TopHat(-5.0, 5.0), m.Normal(1.0, 2.0),
                                 m.ClippedNormal(0.0, 1.0, -1.0, 2.0),
                                 m.LogNormal(0.0, 0.5),
                                 m.LogUniform(1e-3, 1e3), m.Beta(2.0, 5.0)])

    u = np.random.Generator(np.random.PCG64(5)).random((300, 6))
    want = np.asarray(jax.vmap(priors(jm))(jnp.asarray(u)))
    got = torch.func.vmap(priors(tm))(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=1e-12, atol=0)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=0, atol=1e-8)
    with pytest.raises(NotImplementedError):
        tm.Prior()(torch.zeros(()))


_AB = [0.5, 1.0, 2.0, 5.0, 30.0]
_X = np.concatenate([[1e-12, 1e-6, 1e-3], np.linspace(0.01, 0.99, 99),
                     [1 - 1e-3, 1 - 1e-6, 1 - 1e-12]])


@pytest.mark.parametrize("a", _AB)
def test_betainc_matches_scipy(a):
    for b in _AB:
        got = _betainc(a, b, torch.as_tensor(_X)).numpy()
        np.testing.assert_allclose(got, sp.betainc(a, b, _X), rtol=0,
                                   atol=1e-10, err_msg=f"a={a} b={b}")
    # tensor a and b broadcast with x, and the ends are exact
    ends = _betainc(torch.tensor([a, a]), torch.tensor([2.0, 2.0]),
                    torch.tensor([0.0, 1.0], dtype=torch.float64))
    assert ends.tolist() == [0.0, 1.0]


# --------------------------------------------------------------------------
# a short run of each problem in both packages

RUNS = [
    ("CorrelatedGaussian", {"ndim": 3}, dict(bound="single")),
    ("Eggbox", {}, dict(bound="multi")),
    ("GaussianShells", {}, dict(bound="multi")),
    ("Rosenbrock", {"ndim": 2}, dict(bound="single")),
    ("WeddingCake", {}, dict(bound="single")),
    ("LogGamma", {"ndim": 2}, dict(bound="multi")),
]


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


@pytest.mark.parametrize("name,kw,skw", RUNS,
                         ids=[r[0] for r in RUNS])
def test_short_run_matches_jax(name, kw, skw):
    jp, tp = getattr(jm, name)(**kw), getattr(tm, name)(**kw)
    common = dict(nlive=150, sample="unif", queue_size=32, **skw)
    js = dytpu.NestedSampler(jp.loglike, jp.ptform, jp.ndim,
                             rstate=get_rstate(), **common)
    _quiet(js.run_nested, print_progress=False, dlogz=0.5)
    ts = dyt.NestedSampler(tp.loglike, tp.ptform, tp.ndim,
                           rstate=get_rstate(), device="cpu", **common)
    _quiet(ts.run_nested, print_progress=False, dlogz=0.5)
    jr, tr = js.results, ts.results
    assert abs(tr.niter - jr.niter) <= 0.1 * jr.niter, (tr.niter, jr.niter)
    err = np.hypot(tr.logzerr[-1], jr.logzerr[-1])
    assert abs(tr.logz[-1] - jr.logz[-1]) < 3 * err, \
        (tr.logz[-1], jr.logz[-1], err)
    if tp.logz_truth is not None:
        assert abs(tr.logz[-1] - tp.logz_truth) < 5 * tr.logzerr[-1], \
            (tr.logz[-1], tp.logz_truth, tr.logzerr[-1])
