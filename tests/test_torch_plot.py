"""The port's plotting functions (the eleven tests of
``tests/test_plot.py``) under matplotlib's ``Agg`` backend, on small port
runs made once per module: every figure builds for static and dynamic
results, the bound figures from saved bounds through their host
``samples``, also with a prior transform that calls ``torch``.

The same port results also go through the JAX package's plotting module:
the bound draws (same bound, same ``rstate`` seed) and the data plotted by
``runplot``, ``traceplot`` and ``cornerplot`` (lines, histograms, filled
regions, contours) must be equal bit for bit, since both are the same
numpy code on the same host arrays."""

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import dynesty_tpu.plotting as jplot  # noqa: E402
import dynesty_tpu_torch as dyt  # noqa: E402
from dynesty_tpu_torch import plotting as dyplot  # noqa: E402

from utils import get_rstate  # noqa: E402

torch.set_num_threads(1)

NDIM = 2
LNORM = -0.5 * np.log(2 * np.pi) * NDIM


def loglike(x):
    return -0.5 * torch.sum(x * x) + LNORM


def ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def torch_ptform(u):
    # torch functions: a numpy row would not do here
    return torch.special.ndtri(torch.clamp(u, 1e-12, 1 - 1e-12)) + \
        torch.zeros_like(u)


@pytest.fixture(scope="module")
def static_results():
    s = dyt.NestedSampler(loglike, ptform, NDIM, nlive=100, bound="multi",
                          sample="unif", rstate=get_rstate(), queue_size=32,
                          device="cpu")
    s.run_nested(print_progress=False, save_bounds=True)
    return s.results


@pytest.fixture(scope="module")
def dynamic_results():
    d = dyt.DynamicNestedSampler(loglike, ptform, NDIM, bound="multi",
                                 sample="unif", rstate=get_rstate(),
                                 queue_size=32, device="cpu")
    d.run_nested(nlive_init=100, nlive_batch=60, maxbatch=1,
                 n_effective=500, print_progress=False)
    return d.results


def test_runplot(static_results):
    fig, axes = dyplot.runplot(static_results,
                               lnz_truth=NDIM * (-np.log(20.0)))
    plt.close(fig)


def test_runplot_dynamic(dynamic_results):
    fig, axes = dyplot.runplot(dynamic_results)
    plt.close(fig)


def test_traceplot(static_results):
    fig, axes = dyplot.traceplot(static_results, show_titles=True)
    plt.close(fig)


def test_cornerpoints(static_results):
    fig, axes = dyplot.cornerpoints(static_results)
    plt.close(fig)


def test_cornerplot(static_results):
    fig, axes = dyplot.cornerplot(static_results, show_titles=True,
                                  truths=np.zeros(NDIM))
    plt.close(fig)


def test_cornerplot_dynamic(dynamic_results):
    fig, axes = dyplot.cornerplot(dynamic_results)
    plt.close(fig)


def test_boundplot(static_results):
    fig, ax = dyplot.boundplot(static_results, dims=(0, 1), it=100,
                               ndraws=200, rstate=get_rstate())
    plt.close(fig)
    # by dead-point index, pushed through the prior transform
    fig, ax = dyplot.boundplot(static_results, dims=(0, 1),
                               idx=len(static_results.logl) // 2,
                               prior_transform=ptform, ndraws=200,
                               rstate=get_rstate())
    plt.close(fig)


def test_boundplot_torch_prior_transform(static_results):
    it = len(static_results.logl) // 2
    fig, ax = dyplot.boundplot(static_results, dims=(0, 1), it=it,
                               prior_transform=torch_ptform, ndraws=300,
                               rstate=get_rstate())
    plt.close(fig)
    # the points are the bound's host draws, each through the transform
    pts = dyplot._sample_bound(static_results, it=it,
                               prior_transform=torch_ptform, ndraws=300,
                               rstate=get_rstate())
    bound = static_results.bound[static_results.bound_iter[it]]
    raw = bound.samples(300, rstate=get_rstate())
    assert isinstance(pts, np.ndarray) and pts.shape == (300, NDIM)
    np.testing.assert_allclose(
        pts, torch_ptform(torch.as_tensor(raw)).numpy(), rtol=0, atol=0)


def test_cornerbound(static_results):
    fig, axes = dyplot.cornerbound(static_results, it=100, ndraws=200,
                                   rstate=get_rstate())
    plt.close(fig)


def test_hist2d(static_results):
    samples = np.asarray(static_results.samples)
    fig, ax = plt.subplots()
    dyplot._hist2d(samples[:, 0], samples[:, 1], ax=ax,
                   weights=static_results.importance_weights())
    plt.close(fig)


def test_runplot_kde(static_results):
    fig, axes = dyplot.runplot(static_results, kde=True, nkde=200)
    plt.close(fig)


def test_boundplot_periodic_reflective(static_results):
    # wrapped draws for periodic and reflective dimensions
    fig, ax = dyplot.boundplot(static_results, dims=(0, 1), it=100,
                               ndraws=100, periodic=[0], reflective=[1],
                               rstate=get_rstate())
    plt.close(fig)
    pts = dyplot._sample_bound(static_results, it=100, ndraws=100,
                               periodic=[0], reflective=[1],
                               rstate=get_rstate())
    assert np.all((pts >= 0) & (pts <= 1))


# --------------------------------------------------------------------------
# against the JAX package's plotting module, on the same port results


def _plotted(fig):
    """Every array a figure draws, axis by axis, in data coordinates:
    line data, patch outlines (histogram bars and steps) and collection
    paths, offsets and mapped values (filled bands, contours, scatter
    points, the density mesh)."""
    arrays = []
    for ax in fig.axes:
        arrays.extend(ln.get_xydata() for ln in ax.lines)
        arrays.extend(p.get_patch_transform().transform(
            p.get_path().vertices) for p in ax.patches)
        for c in ax.collections:
            arrays.extend(path.vertices for path in c.get_paths())
            arrays.append(np.asarray(c.get_offsets()))
            if c.get_array() is not None:
                arrays.append(np.ma.filled(c.get_array(), np.nan))
    return arrays


def _same_figures(port_fn, jax_fn, results, **kw):
    figs = [port_fn(results, **kw)[0], jax_fn(results, **kw)[0]]
    data = [_plotted(f) for f in figs]
    for f in figs:
        plt.close(f)
    assert len(data[0]) == len(data[1]) and len(data[0]) > 0
    for a, b in zip(*data):
        assert np.array_equal(a, b, equal_nan=True)
    return data[0]


@pytest.mark.parametrize("which", ["static", "dynamic"])
@pytest.mark.parametrize("name,kw", [
    ("runplot", {}),
    ("runplot", {"kde": True, "nkde": 200}),
    ("traceplot", {"show_titles": True}),
    ("cornerplot", {"show_titles": True}),
])
def test_plotted_data_matches_jax(static_results, dynamic_results, which,
                                  name, kw):
    results = static_results if which == "static" else dynamic_results
    data = _same_figures(getattr(dyplot, name), getattr(jplot, name),
                         results, **kw)
    # the figure holds the run: some array spans the run's samples
    assert max(len(a) for a in data) >= min(len(results.logl), 100)


@pytest.mark.parametrize("kw", [
    {"it": 100},
    {"idx": 150, "prior_transform": ptform},
    {"it": 100, "periodic": [0], "reflective": [1]},
])
def test_sample_bound_matches_jax(static_results, kw):
    """The bound plots' draws: the same saved bound and ``rstate`` seed
    give the same points in both packages, also through a numpy-safe prior
    transform and with wrapped dimensions."""
    pts = [mod._sample_bound(static_results, ndraws=300,
                             rstate=get_rstate(), **kw)
           for mod in (dyplot, jplot)]
    assert pts[0].shape == (300, NDIM)
    assert np.array_equal(pts[0], np.asarray(pts[1]))
