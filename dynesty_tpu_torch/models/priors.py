"""Prior transforms in torch: map u in [0, 1) to parameter space
(counterpart of ``dynesty_tpu.models.priors``).

The reference's example family (TopHat, Normal, ClippedNormal, LogNormal,
LogUniform, Beta) as plain functions of tensors, built on
``torch.special.ndtri``, so that they run under ``torch.func.vmap`` inside
the proposal rounds on any device.  Compose per-dimension priors with
:class:`PriorTransform`.

``torch.special`` has no regularized incomplete beta function, so
:func:`_betainc` and :class:`Beta` go through ``ops.beta_prior``: on the
card one launch of a hand-written CUDA kernel (``csrc/beta_prior.cu``)
each, which runs under ``torch.func.vmap`` and inside a captured wave (a
:class:`PriorTransform`'s Beta dimensions all in one launch); on the CPU
the plain versions there (``betainc_plain``: the continued fraction of
Numerical Recipes' ``betacf``, modified Lentz, with a fixed iteration
count, so that it has no data-dependent control flow; ``beta_ppf_plain``:
the bisection).
"""

import math

import torch

from ..ops import beta_prior

__all__ = [
    "Prior", "TopHat", "Normal", "ClippedNormal", "LogNormal",
    "LogUniform", "Beta", "PriorTransform",
]


def _betainc(a, b, x):
    """Regularized incomplete beta function I_x(a, b), elementwise over
    ``x`` (a tensor; ``a``, ``b`` numbers or tensors broadcasting with
    it), in ``x``'s floating dtype (``ops.beta_prior.betainc``)."""
    return beta_prior.betainc(a, b, x)


class Prior:
    """Base class: a 1-D transform u -> x."""

    def __call__(self, u):
        raise NotImplementedError


class TopHat(Prior):
    """Uniform on [low, high]."""

    def __init__(self, low, high):
        self.low, self.high = low, high

    def __call__(self, u):
        return self.low + (self.high - self.low) * u


class Normal(Prior):
    """Gaussian with the given mean and standard deviation."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, u):
        return self.mean + self.std * torch.special.ndtri(u)


class ClippedNormal(Prior):
    """Gaussian truncated to [low, high]."""

    def __init__(self, mean=0.0, std=1.0, low=-math.inf, high=math.inf):
        self.mean, self.std = mean, std

        def cdf(z):
            return float(torch.special.ndtr(
                torch.tensor(z, dtype=torch.float64)))

        self.cdf_low = cdf((low - mean) / std)
        self.cdf_high = cdf((high - mean) / std)

    def __call__(self, u):
        scaled = self.cdf_low + (self.cdf_high - self.cdf_low) * u
        return self.mean + self.std * torch.special.ndtri(scaled)


class LogNormal(Prior):
    """exp of a Normal(mean, std) variate."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, u):
        return torch.exp(self.mean + self.std * torch.special.ndtri(u))


class LogUniform(Prior):
    """log-uniform (Jeffreys) on [low, high], low > 0."""

    def __init__(self, low, high):
        self.log_low = math.log(low)
        self.log_high = math.log(high)

    def __call__(self, u):
        return torch.exp(self.log_low +
                         (self.log_high - self.log_low) * u)


class Beta(Prior):
    """Beta(alpha, beta) by bisection of the regularized incomplete beta
    function (a fixed iteration count, as the JAX package's;
    ``ops.beta_prior.beta_ppf``)."""

    def __init__(self, alpha, beta, niter=50):
        self.alpha, self.beta = alpha, beta
        self.niter = niter

    def __call__(self, u):
        return beta_prior.beta_ppf(u, self.alpha, self.beta, self.niter)


class PriorTransform:
    """Stack per-dimension priors into a prior_transform callable.

    The dimensions whose prior is a :class:`Beta` (that class, not a
    subclass) of one ``niter`` run as one call
    (``ops.beta_prior.beta_ppf_columns``: on the card one launch for them
    all, each dimension's bits those of its own call); every other prior
    is called on its own dimension."""

    def __init__(self, priors):
        self.priors = list(priors)

    def __call__(self, u):
        out = [None] * len(self.priors)
        groups = {}
        for i, p in enumerate(self.priors):
            if type(p) is Beta:
                groups.setdefault(p.niter, []).append(i)
        for niter, dims in groups.items():
            # u's first axis holds the dimensions; the columns are read in
            # place (no index tensor, no copy from the host)
            x = beta_prior.beta_ppf_columns(
                u.movedim(0, -1), dims, [self.priors[i].alpha for i in dims],
                [self.priors[i].beta for i in dims], niter)
            for i, xi in zip(dims, x.unbind(-1)):
                out[i] = xi
        return torch.stack([p(u[i]) if x is None else x
                            for i, (p, x) in enumerate(zip(self.priors,
                                                           out))])
