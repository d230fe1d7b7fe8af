"""Visualization of nested sampling results (counterpart of
``dynesty_tpu.plotting``, numpy and matplotlib only).

``runplot``, ``traceplot``, ``cornerpoints``, ``cornerplot``,
``boundplot``, ``cornerbound`` and ``_hist2d`` take a
:class:`~dynesty_tpu_torch.utils.results.Results` record (static or
dynamic).  The bound plots draw from a saved bound through its host
``samples``; a ``prior_transform`` given to them is a torch-mode function
(the sampler's), applied point by point to CPU tensors.  matplotlib is
imported by the first plot; without it each plot raises ``ImportError``.
"""

import numpy as np
import torch

from .utils.misc import quantile as _quantile
from .utils.runs import _get_nsamps_samples_n

__all__ = [
    "runplot", "traceplot", "cornerpoints", "cornerplot", "boundplot",
    "cornerbound", "_hist2d",
]

# matplotlib (and scipy's smoothing) are imported by the first plot, not
# with the package: they take seconds, and every process that imports
# the package (a pool's workers too) would pay them
pl = MaxNLocator = NullLocator = None
LinearSegmentedColormap = colorConverter = _gaussian_filter = None


def _check_mpl():
    """Import matplotlib for the plots; ImportError without it."""
    global pl, MaxNLocator, NullLocator, LinearSegmentedColormap, \
        colorConverter, _gaussian_filter
    if pl is not None:
        return
    try:
        import matplotlib.pyplot as pyplot
        from matplotlib.colors import (LinearSegmentedColormap as lsc,
                                       colorConverter as cc)
        from matplotlib.ticker import MaxNLocator as mnl, NullLocator as nl
    except ImportError as err:
        raise ImportError("matplotlib is required for plotting") from err
    try:
        from scipy.ndimage import gaussian_filter as _gaussian_filter
    except ImportError:
        _gaussian_filter = None
    MaxNLocator, NullLocator = mnl, nl
    LinearSegmentedColormap, colorConverter = lsc, cc
    pl = pyplot


def _smooth1d(y, sigma):
    if _gaussian_filter is not None:
        return _gaussian_filter(y, sigma)
    # simple fallback: moving average
    k = max(int(sigma * 3), 1)
    kernel = np.exp(-0.5 * ((np.arange(2 * k + 1) - k) / sigma) ** 2)
    kernel /= kernel.sum()
    return np.convolve(y, kernel, mode="same")


def _get_weights(results):
    logwt = np.asarray(results["logwt"])
    wt = np.exp(logwt - logwt.max())
    return wt / wt.sum()


def _make_subplots(fig, nx, ny, xsize, ysize):
    if fig is None:
        fig, axes = pl.subplots(nx, ny, figsize=(xsize, ysize))
        axes = np.atleast_1d(axes).reshape(nx, ny)
    else:
        fig, axes = fig
        axes = np.atleast_1d(np.asarray(axes)).reshape(nx, ny)
    return fig, axes


def _resolve_span(span, samples, weights, ndim):
    """Expand fractional spans into (lo, hi) bounds per dimension."""
    if span is None:
        span = [0.999999426697 for _ in range(ndim)]
    span = list(span)
    for i, sp in enumerate(span):
        if np.ndim(sp) == 0:
            q = [0.5 - 0.5 * sp, 0.5 + 0.5 * sp]
            span[i] = _quantile(samples[i], q, weights=weights)
    return span


def runplot(results, span=None, logplot=False, kde=False, nkde=1000,
            color="blue",
            plot_kwargs=None, label_kwargs=None, lnz_error=True,
            lnz_truth=None, truth_color="red", truth_kwargs=None,
            max_x_ticks=8, max_y_ticks=3, use_math_text=True,
            mark_final_live=True, fig=None):
    """Four-panel summary of the run: live points, log-likelihood,
    importance weight PDF, and cumulative evidence vs -ln(X).

    ``kde=True`` smooths the weight panel with a Gaussian kernel density
    estimate of weighted ``-ln X`` draws, evaluated on an ``nkde``-point
    grid."""
    _check_mpl()
    plot_kwargs = dict(plot_kwargs or {})
    label_kwargs = dict(label_kwargs or {})
    truth_kwargs = dict(truth_kwargs or {})
    plot_kwargs.setdefault("linewidth", 2)
    truth_kwargs.setdefault("linestyle", "dashed")

    nsamps, samples_n = _get_nsamps_samples_n(results)
    logvol = np.asarray(results["logvol"])
    logl = np.asarray(results["logl"])
    logl_norm = logl - logl.max()
    logwt = np.asarray(results["logwt"])
    wt_pdf = np.exp(logwt - logwt.max())
    logz = np.asarray(results["logz"])
    logzerr = np.asarray(results["logzerr"])
    x = -logvol
    x_wt = x

    if kde:
        # weighted Gaussian KDE of -lnX (Scott's rule bandwidth),
        # evaluated on a regular grid — smooths the sawtooth weight curve
        w = wt_pdf / wt_pdf.sum()
        mu = np.sum(w * x)
        sd = np.sqrt(max(np.sum(w * (x - mu) ** 2), 1e-300))
        neff = 1.0 / np.sum(w ** 2)
        bw = sd * neff ** (-1.0 / 5.0)
        x_wt = np.linspace(x.min(), x.max(), nkde)
        z = (x_wt[:, None] - x[None, :]) / bw
        dens = (np.exp(-0.5 * z ** 2) * w[None, :]).sum(axis=1)
        wt_pdf = dens / max(dens.max(), 1e-300)

    fig, axes = _make_subplots(fig, 4, 1, 16, 16)
    axes = axes.ravel()
    data = [samples_n, np.exp(logl_norm), wt_pdf, logz]
    labels = ["Live Points", "Likelihood\n(normalized)",
              "Importance\nWeight PDF", "log(Evidence)"]

    xdata = [x, x, x_wt, x]
    for i, (ax, d, lab) in enumerate(zip(axes, data, labels)):
        ax.plot(xdata[i], d, color=color, **plot_kwargs)
        ax.set_ylabel(lab, **label_kwargs)
        if max_x_ticks == 0:
            ax.xaxis.set_major_locator(NullLocator())
        else:
            ax.xaxis.set_major_locator(MaxNLocator(max_x_ticks))
        if max_y_ticks == 0:
            ax.yaxis.set_major_locator(NullLocator())
        else:
            ax.yaxis.set_major_locator(MaxNLocator(max_y_ticks))
        if logplot and i == 3:
            ax.set_yscale("symlog")
    axes[-1].set_xlabel(r"$-\ln X$", **label_kwargs)

    if lnz_error:
        for nsig in (1, 2, 3):
            axes[3].fill_between(x, logz - nsig * logzerr,
                                 logz + nsig * logzerr, color=color,
                                 alpha=0.2 / nsig)
    if lnz_truth is not None:
        axes[3].axhline(lnz_truth, color=truth_color, **truth_kwargs)

    if mark_final_live and "nlive" in results.keys():
        nlive = results["nlive"]
        niter = results["niter"]
        if nsamps == niter + nlive:
            boundary = x[niter]
            for ax in axes:
                ax.axvline(boundary, color=color, linestyle="dashed")
    return fig, axes


def traceplot(results, span=None, quantiles=(0.025, 0.5, 0.975),
              smooth=0.02, thin=1, dims=None, post_color="blue",
              post_kwargs=None, kde=False, nkde=1000, trace_cmap="plasma",
              trace_color=None, trace_kwargs=None, connect=False,
              connect_highlight=10, connect_color="red",
              connect_kwargs=None, max_n_ticks=5, use_math_text=False,
              labels=None, label_kwargs=None, show_titles=False,
              title_quantiles=(0.025, 0.5, 0.975), title_fmt=".2f",
              title_kwargs=None, truths=None, truth_color="red",
              truth_kwargs=None, verbose=False, fig=None):
    """Per-dimension traces (colored by importance weight) plus weighted
    1-D marginal posteriors."""
    _check_mpl()
    post_kwargs = dict(post_kwargs or {})
    trace_kwargs = dict(trace_kwargs or {})
    connect_kwargs = dict(connect_kwargs or {})
    label_kwargs = dict(label_kwargs or {})
    title_kwargs = dict(title_kwargs or {})
    truth_kwargs = dict(truth_kwargs or {})

    samples = np.asarray(results["samples"]).T
    weights = _get_weights(results)
    logvol = np.asarray(results["logvol"])
    if dims is not None:
        samples = samples[list(dims)]
    ndim = len(samples)
    span = _resolve_span(span, samples, weights, ndim)
    if labels is None:
        labels = [rf"$x_{{{i}}}$" for i in range(ndim)]

    fig, axes = _make_subplots(fig, ndim, 2, 12, 3 * ndim)
    for i in range(ndim):
        # trace
        ax = axes[i, 0]
        ax.scatter(-logvol[::thin], samples[i][::thin],
                   c=weights[::thin], s=2, cmap=trace_cmap
                   if trace_color is None else None,
                   color=trace_color, **trace_kwargs)
        ax.set_ylabel(labels[i], **label_kwargs)
        ax.set_ylim(span[i])
        if i == ndim - 1:
            ax.set_xlabel(r"$-\ln X$", **label_kwargs)
        if truths is not None and truths[i] is not None:
            ax.axhline(truths[i], color=truth_color, **truth_kwargs)
        # marginal
        ax = axes[i, 1]
        n, bins = np.histogram(samples[i], bins=100, weights=weights,
                               range=np.sort(span[i]))
        if smooth:
            n = _smooth1d(n, smooth * 100)
        centers = 0.5 * (bins[1:] + bins[:-1])
        ax.fill_between(centers, n, color=post_color, alpha=0.6,
                        **post_kwargs)
        ax.set_xlim(span[i])
        ax.set_yticks([])
        ax.set_xlabel(labels[i], **label_kwargs)
        if quantiles is not None:
            qs = _quantile(samples[i], list(quantiles), weights=weights)
            for q in qs:
                ax.axvline(q, color=post_color, linestyle="dashed",
                           alpha=0.8)
        if show_titles:
            ql, qm, qh = _quantile(samples[i], list(title_quantiles),
                                   weights=weights)
            fmt = "{{0:{0}}}".format(title_fmt).format
            title = rf"{labels[i]} = ${fmt(qm)}_{{-{fmt(qm - ql)}}}" \
                    rf"^{{+{fmt(qh - qm)}}}$"
            ax.set_title(title, **title_kwargs)
        if truths is not None and truths[i] is not None:
            ax.axvline(truths[i], color=truth_color, **truth_kwargs)
    fig.tight_layout()
    return fig, axes


def cornerpoints(results, dims=None, thin=1, span=None, cmap="plasma",
                 color=None, kde=False, nkde=1000, plot_kwargs=None,
                 labels=None, label_kwargs=None, truths=None,
                 truth_color="red", truth_kwargs=None, max_n_ticks=5,
                 use_math_text=False, fig=None):
    """Lower-triangle scatter matrix of the (weighted) samples."""
    _check_mpl()
    plot_kwargs = dict(plot_kwargs or {})
    label_kwargs = dict(label_kwargs or {})
    truth_kwargs = dict(truth_kwargs or {})
    plot_kwargs.setdefault("s", 2)

    samples = np.asarray(results["samples"]).T
    weights = _get_weights(results)
    if dims is not None:
        samples = samples[list(dims)]
    ndim = len(samples)
    span = _resolve_span(span, samples, weights, ndim)
    if labels is None:
        labels = [rf"$x_{{{i}}}$" for i in range(ndim)]

    fig, axes = _make_subplots(fig, ndim - 1, ndim - 1,
                               2.5 * (ndim - 1), 2.5 * (ndim - 1))
    for i in range(1, ndim):
        for j in range(ndim - 1):
            ax = axes[i - 1, j]
            if j >= i:
                ax.set_frame_on(False)
                ax.set_xticks([])
                ax.set_yticks([])
                continue
            ax.scatter(samples[j][::thin], samples[i][::thin],
                       c=weights[::thin] if color is None else None,
                       color=color, cmap=cmap if color is None else None,
                       **plot_kwargs)
            ax.set_xlim(span[j])
            ax.set_ylim(span[i])
            if i == ndim - 1:
                ax.set_xlabel(labels[j], **label_kwargs)
            else:
                ax.set_xticks([])
            if j == 0:
                ax.set_ylabel(labels[i], **label_kwargs)
            else:
                ax.set_yticks([])
            if truths is not None:
                if truths[j] is not None:
                    ax.axvline(truths[j], color=truth_color,
                               **truth_kwargs)
                if truths[i] is not None:
                    ax.axhline(truths[i], color=truth_color,
                               **truth_kwargs)
    return fig, axes


def cornerplot(results, dims=None, span=None, quantiles=(0.025, 0.5, 0.975),
               color="black", smooth=0.02, quantiles_2d=None, hist_kwargs=None,
               hist2d_kwargs=None, labels=None, label_kwargs=None,
               show_titles=False, title_quantiles=(0.025, 0.5, 0.975),
               title_fmt=".2f", title_kwargs=None, truths=None,
               truth_color="red", truth_kwargs=None, max_n_ticks=5,
               top_ticks=False, use_math_text=False, verbose=False,
               fig=None):
    """Full corner plot: 1-D weighted marginals on the diagonal, 2-D
    contour histograms below."""
    _check_mpl()
    hist_kwargs = dict(hist_kwargs or {})
    hist2d_kwargs = dict(hist2d_kwargs or {})
    label_kwargs = dict(label_kwargs or {})
    title_kwargs = dict(title_kwargs or {})
    truth_kwargs = dict(truth_kwargs or {})

    samples = np.asarray(results["samples"]).T
    weights = _get_weights(results)
    if dims is not None:
        samples = samples[list(dims)]
    ndim = len(samples)
    span = _resolve_span(span, samples, weights, ndim)
    if labels is None:
        labels = [rf"$x_{{{i}}}$" for i in range(ndim)]

    fig, axes = _make_subplots(fig, ndim, ndim, 2.5 * ndim, 2.5 * ndim)
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j > i:
                ax.set_frame_on(False)
                ax.set_xticks([])
                ax.set_yticks([])
                continue
            if j == i:
                n, bins = np.histogram(samples[i], bins=100,
                                       weights=weights,
                                       range=np.sort(span[i]))
                if smooth:
                    n = _smooth1d(n, smooth * 100)
                centers = 0.5 * (bins[1:] + bins[:-1])
                ax.plot(centers, n, color=color, **hist_kwargs)
                ax.set_xlim(span[i])
                ax.set_yticks([])
                if quantiles is not None:
                    for q in _quantile(samples[i], list(quantiles),
                                       weights=weights):
                        ax.axvline(q, color=color, linestyle="dashed",
                                   alpha=0.7)
                if show_titles:
                    ql, qm, qh = _quantile(samples[i],
                                           list(title_quantiles),
                                           weights=weights)
                    fmt = "{{0:{0}}}".format(title_fmt).format
                    ax.set_title(
                        rf"{labels[i]} = ${fmt(qm)}_{{-{fmt(qm - ql)}}}"
                        rf"^{{+{fmt(qh - qm)}}}$", **title_kwargs)
                if truths is not None and truths[i] is not None:
                    ax.axvline(truths[i], color=truth_color,
                               **truth_kwargs)
            else:
                _hist2d(samples[j], samples[i], ax=ax, weights=weights,
                        span=[span[j], span[i]], color=color,
                        smooth=smooth, **hist2d_kwargs)
                if truths is not None:
                    if truths[j] is not None:
                        ax.axvline(truths[j], color=truth_color,
                                   **truth_kwargs)
                    if truths[i] is not None:
                        ax.axhline(truths[i], color=truth_color,
                                   **truth_kwargs)
            if i == ndim - 1:
                ax.set_xlabel(labels[j], **label_kwargs)
            else:
                ax.set_xticks([])
            if j == 0 and i > 0:
                ax.set_ylabel(labels[i], **label_kwargs)
            elif j > 0:
                ax.set_yticks([])
    return fig, axes


def _sample_bound(results, it=None, idx=None, prior_transform=None,
                  ndraws=5000, rstate=None, periodic=None,
                  reflective=None):
    """Draw points from the bound active at iteration ``it`` (or the one
    that proposed dead point ``idx``).  ``periodic``/``reflective`` list
    dimensions whose draws are wrapped back into the unit cube before
    the prior transform, a torch-mode function applied to each point as a
    CPU tensor."""
    from .ops.geometry import apply_reflect
    from .utils.misc import get_random_generator

    if rstate is None:
        rstate = get_random_generator()
    if "bound" not in results.keys():
        raise ValueError("No bounds were saved in the results.")
    bounds = results["bound"]
    if it is not None:
        bidx = np.asarray(results["bound_iter"])[it]
    elif idx is not None:
        bidx = np.asarray(results["samples_bound"])[idx]
    else:
        raise ValueError("Specify either `it` or `idx`.")
    bound = bounds[bidx]
    if getattr(bound, "need_centers", False) and len(bound.ctrs) == 0:
        raise ValueError("This saved bound has no stored centers.")
    points = bound.samples(ndraws, rstate=rstate)
    if periodic is not None:
        points[:, periodic] = np.mod(points[:, periodic], 1.0)
    if reflective is not None:
        points[:, reflective] = apply_reflect(
            torch.as_tensor(points[:, reflective])).numpy()
    if prior_transform is not None:
        points = np.array([
            torch.as_tensor(prior_transform(p)).detach().cpu().numpy()
            for p in torch.as_tensor(points)])
    return points


def boundplot(results, dims, it=None, idx=None, prior_transform=None,
              periodic=None, reflective=None,
              ndraws=5000, color="gray", plot_kwargs=None, labels=None,
              label_kwargs=None, max_n_ticks=5, use_math_text=False,
              show_live=False, live_color="darkviolet", live_kwargs=None,
              span=None, fig=None, rstate=None):
    """Scatter of points drawn from a saved bound in two dimensions."""
    _check_mpl()
    plot_kwargs = dict(plot_kwargs or {})
    label_kwargs = dict(label_kwargs or {})
    plot_kwargs.setdefault("s", 1)
    points = _sample_bound(results, it=it, idx=idx,
                           prior_transform=prior_transform, ndraws=ndraws,
                           rstate=rstate, periodic=periodic,
                           reflective=reflective)
    dim1, dim2 = dims
    if fig is None:
        fig, ax = pl.subplots(figsize=(6, 6))
    else:
        fig, ax = fig
    ax.scatter(points[:, dim1], points[:, dim2], color=color,
               **plot_kwargs)
    if labels is not None:
        ax.set_xlabel(labels[0], **label_kwargs)
        ax.set_ylabel(labels[1], **label_kwargs)
    else:
        ax.set_xlabel(rf"$x_{{{dim1}}}$", **label_kwargs)
        ax.set_ylabel(rf"$x_{{{dim2}}}$", **label_kwargs)
    if span is not None:
        ax.set_xlim(span[0])
        ax.set_ylim(span[1])
    return fig, ax


def cornerbound(results, it=None, idx=None, dims=None,
                prior_transform=None, periodic=None, reflective=None,
                ndraws=5000, color="gray",
                plot_kwargs=None, labels=None, label_kwargs=None,
                max_n_ticks=5, use_math_text=False, show_live=False,
                live_color="darkviolet", live_kwargs=None, span=None,
                fig=None, rstate=None):
    """Lower-triangle matrix of bound draws across all dimension pairs."""
    _check_mpl()
    plot_kwargs = dict(plot_kwargs or {})
    label_kwargs = dict(label_kwargs or {})
    plot_kwargs.setdefault("s", 1)
    points = _sample_bound(results, it=it, idx=idx,
                           prior_transform=prior_transform, ndraws=ndraws,
                           rstate=rstate, periodic=periodic,
                           reflective=reflective)
    if dims is not None:
        points = points[:, list(dims)]
    ndim = points.shape[1]
    if labels is None:
        labels = [rf"$x_{{{i}}}$" for i in range(ndim)]
    fig, axes = _make_subplots(fig, ndim - 1, ndim - 1,
                               2.5 * (ndim - 1), 2.5 * (ndim - 1))
    for i in range(1, ndim):
        for j in range(ndim - 1):
            ax = axes[i - 1, j]
            if j >= i:
                ax.set_frame_on(False)
                ax.set_xticks([])
                ax.set_yticks([])
                continue
            ax.scatter(points[:, j], points[:, i], color=color,
                       **plot_kwargs)
            if i == ndim - 1:
                ax.set_xlabel(labels[j], **label_kwargs)
            if j == 0:
                ax.set_ylabel(labels[i], **label_kwargs)
    return fig, axes


def _hist2d(x, y, smooth=0.02, span=None, weights=None, levels=None,
            ax=None, color="gray", plot_datapoints=False, plot_density=True,
            plot_contours=True, no_fill_contours=False, fill_contours=True,
            contour_kwargs=None, contourf_kwargs=None, data_kwargs=None,
            **kwargs):
    """corner-style 2-D weighted histogram with smoothed sigma contours."""
    _check_mpl()
    if ax is None:
        ax = pl.gca()
    if levels is None:
        # 0.5, 1, 1.5, 2 sigma contours
        levels = 1.0 - np.exp(-0.5 * np.array([0.5, 1.0, 1.5, 2.0]) ** 2)
    if span is None:
        span = [[x.min(), x.max()], [y.min(), y.max()]]
    span = [np.sort(s) for s in span]

    nbin = 100
    H, xe, ye = np.histogram2d(x, y, bins=nbin,
                               range=[tuple(span[0]), tuple(span[1])],
                               weights=weights)
    if smooth:
        H = _gaussian_filter(H, smooth * nbin) \
            if _gaussian_filter is not None else H

    # convert levels to histogram values
    Hflat = np.sort(H.ravel())[::-1]
    csum = np.cumsum(Hflat)
    csum /= csum[-1]
    V = np.empty(len(levels))
    for i, lev in enumerate(levels):
        try:
            V[i] = Hflat[csum <= lev][-1]
        except IndexError:
            V[i] = Hflat[0]
    V.sort()
    m = np.diff(V) == 0
    while np.any(m):
        V[np.where(m)[0][0]] *= 1.0 - 1e-4
        m = np.diff(V) == 0
    V.sort()

    xc = 0.5 * (xe[1:] + xe[:-1])
    yc = 0.5 * (ye[1:] + ye[:-1])

    # color map fading toward white
    rgba_color = colorConverter.to_rgba(color)
    contour_cmap = [list(rgba_color) for _ in levels] + [list(rgba_color)]
    for i in range(len(levels) + 1):
        contour_cmap[i][-1] *= float(i) / (len(levels) + 1)

    if plot_datapoints:
        dkw = dict(data_kwargs or {})
        dkw.setdefault("s", 1)
        dkw.setdefault("alpha", 0.1)
        ax.scatter(x, y, color=color, **dkw)
    if plot_density:
        ax.pcolormesh(xc, yc, H.T ** 0.5,
                      cmap=LinearSegmentedColormap.from_list(
                          "density", [(1, 1, 1, 0), rgba_color]),
                      shading="auto")
    if plot_contours:
        ckw = dict(contour_kwargs or {})
        if fill_contours and not no_fill_contours:
            cfkw = dict(contourf_kwargs or {})
            ax.contourf(xc, yc, H.T,
                        np.concatenate([V, [H.max() * (1 + 1e-4)]]),
                        colors=contour_cmap, **cfkw)
        ax.contour(xc, yc, H.T, V, colors=color, **ckw)
    ax.set_xlim(span[0])
    ax.set_ylim(span[1])
    return ax
