"""The port's argument surface and namespaces against the JAX package's, on
the CPU: the factories' signatures, the names a script imports, the
citations, the printers' entry points, the host statistics helpers and
``Results.__repr__`` (the patterns of ``tests/test_interface.py`` and
``tests/test_misc.py``).

Tolerances: the statistics helpers are the same float64 numpy code in both
packages and are held at 1e-12 relative; the citations are equal text;
runs are held to finite results only (their evidence is tested
elsewhere)."""

import inspect
import io
import os
import shutil
from contextlib import redirect_stderr

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynesty_tpu as dytpu
import dynesty_tpu.ops.geometry as jgeom
import dynesty_tpu.utils.misc as jmisc
import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.ops.geometry as tgeom
import dynesty_tpu_torch.utils.misc as tmisc

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
_COV = np.identity(NDIM)
_COV[_COV == 0] = 0.95
_CINV = torch.as_tensor(np.linalg.inv(_COV))
_LNORM = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(_COV)))


def loglike(x):
    return -0.5 * (x @ _CINV.to(x.dtype) @ x) + _LNORM


def ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def _sampler(**kw):
    kw = dict(dict(nlive=100, bound="single", sample="unif", queue_size=32,
                   rstate=get_rstate(), device="cpu"), **kw)
    return dyt.NestedSampler(loglike, ptform, NDIM, **kw)


# --------------------------------------------------------------------------
# the factories


@pytest.mark.parametrize("name", ["NestedSampler", "DynamicNestedSampler"])
def test_factory_signatures_match_jax(name):
    """The JAX package's parameters in its positional order; the only
    differences are the defaults of ``likelihood_mode`` and ``dtype`` and a
    keyword-only ``device`` at the end."""
    jsig = inspect.signature(getattr(dytpu, name))
    tsig = inspect.signature(getattr(dyt, name))
    jparams = list(jsig.parameters.values())
    tparams = list(tsig.parameters.values())
    assert [p.name for p in tparams] == [p.name for p in jparams] + \
        ["device"]
    for jp, tp in zip(jparams, tparams):
        assert tp.kind == jp.kind, tp.name
        if tp.name == "likelihood_mode":
            assert (jp.default, tp.default) == ("jax", "torch")
        elif tp.name == "dtype":
            assert jp.default is None and tp.default is torch.float64
        else:
            assert tp.default == jp.default, tp.name
    device = tparams[-1]
    assert device.kind == inspect.Parameter.KEYWORD_ONLY
    assert device.default == "cuda"


def test_positional_arguments_as_in_jax():
    # periodic (position 7) and queue_size (position 12) by position
    s = dyt.NestedSampler(loglike, ptform, NDIM, 60, "single", "unif", None,
                          None, None, None, get_rstate(), 16, device="cpu")
    assert (s.nlive, s.bounding, s.queue_size) == (60, "single", 16)
    assert s.internal_sampler_next.name == "unif"


def test_mesh_none_accepted_and_a_mesh_refused():
    s = _sampler(mesh=None)
    s.run_nested(maxiter=50, print_progress=False)
    d = dyt.DynamicNestedSampler(loglike, ptform, NDIM, mesh=None,
                                 device="cpu")
    assert d.device == torch.device("cpu")
    for factory in (dyt.NestedSampler, dyt.DynamicNestedSampler):
        with pytest.raises(NotImplementedError, match="mesh"):
            factory(loglike, ptform, NDIM, mesh="a mesh", device="cpu")


@pytest.mark.parametrize("bound,sample", [("multi", "unif"),
                                          ("balls", "rslice"),
                                          ("single", "rwalk"),
                                          ("none", "slice"),
                                          ("cubes", "auto")])
def test_citations_match_jax(bound, sample):
    def jll(x):
        return -0.5 * jnp.dot(x, x)

    j = dytpu.NestedSampler(jll, ptform, NDIM, nlive=20, bound=bound,
                            sample=sample, rstate=get_rstate())
    t = dyt.NestedSampler(loglike, ptform, NDIM, nlive=20, bound=bound,
                          sample=sample, rstate=get_rstate(), device="cpu")
    assert t.citations == j.citations and "Skilling (2004)" in t.citations
    jd = dytpu.DynamicNestedSampler(jll, ptform, NDIM, bound=bound,
                                    sample=sample)
    td = dyt.DynamicNestedSampler(loglike, ptform, NDIM, bound=bound,
                                  sample=sample, device="cpu")
    assert td.citations == jd.citations
    assert "Dynamic Nested Sampling" in td.citations
    assert "Dynamic Nested Sampling" not in t.citations


def test_unused_reference_kwargs_accepted():
    # use_pool and pool are part of the reference API surface
    s = _sampler(use_pool={"loglikelihood": True}, pool=None)
    s.run_nested(maxiter=100, print_progress=False)
    assert np.isfinite(s.results.logz[-1])


def test_dtype_kwarg():
    """``dtype=`` sets the device rounds' precision through both factories
    (the integrator stays host float64)."""
    s = dyt.NestedSampler(loglike, ptform, NDIM, nlive=50,
                          rstate=get_rstate(), dtype=torch.float32,
                          device="cpu")
    assert s.dtype == torch.float32
    s.run_nested(maxiter=120, print_progress=False)
    assert np.isfinite(s.results.logz[-1])
    dns = dyt.DynamicNestedSampler(loglike, ptform, NDIM,
                                   rstate=get_rstate(), dtype=torch.float32,
                                   device="cpu")
    dns.run_nested(nlive_init=50, maxbatch=1, print_progress=False)
    assert dns.sampler.dtype == torch.float32
    assert np.isfinite(dns.results.logz[-1])


def test_timings_populated():
    s = _sampler()
    s.run_nested(print_progress=False)
    t = s.timings
    for key in ("dispatch", "consume", "total", "n_dispatch",
                "nc_launched"):
        assert key in t, key
    assert t["n_dispatch"] >= 1 and t["dispatch"] > 0
    assert t["total"] >= t["dispatch"]
    assert t["nc_launched"] >= s.ncall - 100  # init draws not dispatched
    dns = dyt.DynamicNestedSampler(loglike, ptform, NDIM, bound="single",
                                   sample="unif", rstate=get_rstate(),
                                   queue_size=32, device="cpu")
    dns.run_nested(nlive_init=100, maxbatch=1, nlive_batch=50,
                   print_progress=False)
    dt = dns.timings
    assert dt["n_dispatch"] >= 2 and dt["dispatch"] > 0
    # event lists concatenate when timings merge
    a, b = tmisc.Timings(), tmisc.Timings()
    a.mark("marks", (0.0, 1))
    b.mark("marks", (1.0, 2))
    b.count("n", 2)
    assert a.merge(b) == {"marks": [(0.0, 1), (1.0, 2)], "n": 2}


# --------------------------------------------------------------------------
# namespaces


def test_namespace_parity():
    """A script written for the JAX package finds these names, spelled as
    there (``test_interface.py::test_namespace_parity``)."""
    from dynesty_tpu_torch.results import Results, print_fn  # noqa: F401
    from dynesty_tpu_torch.internal_samplers import (  # noqa: F401
        INTERNAL_SAMPLER_LIST, InternalSampler, UnitCubeSampler,
        UniformBoundSampler, RWalkSampler, SliceSampler, RSliceSampler)
    from dynesty_tpu_torch.pool import initializer  # noqa: F401
    from dynesty_tpu_torch.utils import (  # noqa: F401
        SQRTEPS, SamplerHistoryItem, IteratorResult, IteratorResultShort,
        PrintFnArgs, get_print_fn_args, print_fn_fallback, print_fn_tqdm)
    assert INTERNAL_SAMPLER_LIST == ["rwalk", "unif", "rslice", "slice"]
    assert 0 < SQRTEPS < 1e-7 and SQRTEPS == jmisc.SQRTEPS
    assert dyt.results is not None and dyt.dynamicsampler is not None
    assert dyt.plotting is not None and dyt.internal_samplers is not None
    import dynesty_tpu.utils as jutils
    import dynesty_tpu_torch.utils as tutils
    # every name of the JAX package's utils, get_jax_key replaced by the
    # port's torch generator
    assert set(tutils.__all__) == \
        (set(jutils.__all__) - {"get_jax_key"}) | {"get_torch_generator"}
    for name in tutils.__all__:
        assert getattr(tutils, name) is not None, name
    assert tutils.get_nonbounded(3, None, None) is None
    assert np.array_equal(tutils.get_nonbounded(3, [0], [2]),
                          jutils.get_nonbounded(3, [0], [2]))
    assert set(dyt.__all__) >= {"plotting", "results", "internal_samplers"}


def test_results_repr():
    s = _sampler()
    s.run_nested(maxiter=60, print_progress=False)
    text = repr(s.results)
    lines = text.splitlines()
    assert len(lines) >= len(s.results.keys())
    assert all(k in text for k in ("niter", "logz", "samples_u"))
    width = max(map(len, s.results.keys())) + 1
    assert lines[0].index(":") == width


# --------------------------------------------------------------------------
# host statistics, against the JAX package


def test_mean_and_cov_quantile_mle_cov_match_jax():
    rs = get_rstate()
    x = rs.normal(size=(500, 3)) * [1.0, 2.0, 0.5] + [0.3, -1.0, 2.0]
    w = rs.random(500)
    for a, b in zip(tmisc.mean_and_cov(x, w), jmisc.mean_and_cov(x, w)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    for q in ([0.5], [0.025, 0.5, 0.975]):
        np.testing.assert_allclose(tmisc.quantile(x[:, 0], q, weights=w),
                                   jmisc.quantile(x[:, 0], q, weights=w),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(tmisc.quantile(x[:, 1], q),
                                   jmisc.quantile(x[:, 1], q), rtol=1e-12)
    with pytest.raises(ValueError):
        tmisc.quantile(x[:, 0], [1.5])
    np.testing.assert_allclose(tgeom.mle_cov(x), jgeom.mle_cov(x),
                               rtol=1e-12, atol=0)
    # the weighted estimates come near the generating values
    mean, cov = tmisc.mean_and_cov(x, w)
    assert np.allclose(mean, [0.3, -1.0, 2.0], atol=0.2)
    assert np.allclose(np.sqrt(np.diag(cov)), [1.0, 2.0, 0.5], rtol=0.15)


# --------------------------------------------------------------------------
# printing (tests/test_interface.py)


def test_printing(monkeypatch):
    # the default printer without tqdm (whose bar shows its postfix only
    # at its own refresh interval): the stderr line, at a pinned width
    class _NoTqdm:
        def __init__(self):
            raise ImportError("forced")

    monkeypatch.setattr(tmisc, "_TqdmPrinter", _NoTqdm)
    monkeypatch.setattr(shutil, "get_terminal_size",
                        lambda fallback=None: os.terminal_size((200, 20)))
    s = _sampler()
    buf = io.StringIO()
    with redirect_stderr(buf):
        s.run_nested(print_progress=True, maxiter=100)
    text = buf.getvalue()
    assert "logz:" in text and "ncall:" in text and "iter:" in text


def test_custom_print_func():
    s = _sampler()
    calls = []

    def my_print(results, niter, ncall, **kwargs):
        calls.append((niter, ncall, kwargs.get("dlogz")))

    s.run_nested(print_progress=True, print_func=my_print, maxiter=100)
    # every record, and then every recycled live point
    assert len(calls) == s.results.niter + s.nlive
    assert all(c[2] is not None for c in calls)


def test_print_fn_tiers():
    it = tmisc.IteratorResultShort(
        worst=0, ustar=None, vstar=None, loglstar=-1.0, nc=3, worst_it=1,
        boundidx=0, bounditer=2, eff=12.5, delta_logz=4.0,
        proposal_stats=None)
    base = tmisc.get_print_fn_args(it, 10, 100, dlogz=0.1)
    assert base.niter == 10
    assert any(s.startswith("dlogz:") for s in base.long_str)
    assert len(" | ".join(base.long_str)) > len("|".join(base.short_str))
    batch = tmisc.get_print_fn_args(it, 10, 100, dlogz=0.1, stop_val=1.5,
                                    nbatch=2, logl_min=-3.0, logl_max=2.0)
    assert any(s.startswith("stop:") for s in batch.long_str)
    assert any(s.startswith("stop:") for s in batch.mid_str)
    assert any("<" in s for s in batch.short_str)
    # the same tiers as the JAX package's
    for kw in ({"dlogz": 0.1}, {"dlogz": 0.1, "stop_val": 1.5, "nbatch": 2,
                                "logl_min": -3.0, "logl_max": 2.0},
               {"add_live_it": 4, "dlogz": 0.5}):
        assert tuple(tmisc.get_print_fn_args(it, 10, 100, **kw)) == \
            tuple(jmisc.get_print_fn_args(it, 10, 100, **kw))


def test_print_fn_fallback_writes(monkeypatch):
    # the width pinned: which tier is printed depends on it
    monkeypatch.setattr(tmisc, "_terminal_width", lambda default=200: 200)
    it = tmisc.IteratorResultShort(
        worst=0, ustar=None, vstar=None, loglstar=-1.0, nc=3, worst_it=1,
        boundidx=0, bounditer=2, eff=12.5, delta_logz=4.0,
        proposal_stats=None)
    buf = io.StringIO()
    with redirect_stderr(buf):
        tmisc.print_fn_fallback(it, 42, 420, dlogz=0.1)
    err = buf.getvalue()
    assert err.startswith("\riter: 42 | ") and "eff(%)" in err
    monkeypatch.setattr(tmisc, "_terminal_width", lambda default=200: 90)
    buf = io.StringIO()
    with redirect_stderr(buf):
        tmisc.print_fn_fallback(it, 42, 420, dlogz=0.1)
    # too narrow for the long tier: the mid tier, without the iter field
    assert "iter:" not in buf.getvalue() and "dlogz:" in buf.getvalue()
