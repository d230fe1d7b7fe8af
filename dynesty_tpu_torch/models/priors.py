"""Prior transforms in torch: map u in [0, 1) to parameter space
(counterpart of ``dynesty_tpu.models.priors``).

The reference's example family (TopHat, Normal, ClippedNormal, LogNormal,
LogUniform, Beta) as plain functions of tensors, built on
``torch.special.ndtri``, so that they run under ``torch.func.vmap`` inside
the proposal rounds on any device.  Compose per-dimension priors with
:class:`PriorTransform`.

``torch.special`` has no regularized incomplete beta function, so
:func:`_betainc` computes it here: the continued fraction of Numerical
Recipes (``betacf``, modified Lentz) with a fixed iteration count, so that
it has no data-dependent control flow.
"""

import math

import torch

__all__ = [
    "Prior", "TopHat", "Normal", "ClippedNormal", "LogNormal",
    "LogUniform", "Beta", "PriorTransform",
]

# continued-fraction terms: enough for a, b up to a few thousand (held to
# scipy.special.betainc in tests/test_torch_models.py)
_BETAINC_ITERS = 64
# Lentz's guard against a zero denominator
_TINY = 1e-300


def _guard(t):
    return torch.where(t.abs() < _TINY, _TINY, t)


def _betainc(a, b, x):
    """Regularized incomplete beta function I_x(a, b), elementwise over
    ``x`` (a tensor; ``a``, ``b`` numbers or tensors broadcasting with
    it), in ``x``'s floating dtype.

    The prefactor x^a (1-x)^b / (a B(a, b)) comes from ``lgamma``; the
    continued fraction converges fast for x < (a+1)/(a+b+2), and above
    that the symmetry I_x(a, b) = 1 - I_{1-x}(b, a) is used."""
    x = torch.as_tensor(x)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    swap = x > (a + 1.0) / (a + b + 2.0)
    p = torch.where(swap, b, a)
    q = torch.where(swap, a, b)
    y = torch.where(swap, 1.0 - x, x)
    log_front = (torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b) +
                 a * torch.log(x) + b * torch.log1p(-x))
    qab, qap, qam = p + q, p + 1.0, p - 1.0
    c = torch.ones_like(y)
    d = 1.0 / _guard(1.0 - qab * y / qap)
    h = d
    for m in range(1, _BETAINC_ITERS + 1):
        m2 = 2 * m
        for aa in (m * (q - m) * y / ((qam + m2) * (p + m2)),
                   -(p + m) * (qab + m) * y / ((p + m2) * (qap + m2))):
            d = 1.0 / _guard(1.0 + aa * d)
            c = _guard(1.0 + aa / c)
            h = h * d * c
    front = torch.exp(log_front) * h / p
    return torch.where(swap, 1.0 - front, front)


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
    function (a fixed iteration count, as the JAX package's)."""

    def __init__(self, alpha, beta, niter=50):
        self.alpha, self.beta = alpha, beta
        self.niter = niter

    def __call__(self, u):
        lo = torch.zeros_like(u)
        hi = torch.ones_like(u)
        for _ in range(self.niter):
            mid = 0.5 * (lo + hi)
            below = _betainc(self.alpha, self.beta, mid) < u
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        return 0.5 * (lo + hi)


class PriorTransform:
    """Stack per-dimension priors into a prior_transform callable."""

    def __init__(self, priors):
        self.priors = list(priors)

    def __call__(self, u):
        return torch.stack([p(u[i]) for i, p in enumerate(self.priors)])
