"""Analytic benchmark problems with known log-evidences (counterpart of
``dynesty_tpu.models.problems``).

Each problem exposes per-point torch ``loglike(x)`` / ``ptform(u)``
callables (batched by the sampler with ``torch.func.vmap``) plus ``ndim``
and, where known, ``logz_truth``, computed on the host with numpy/scipy as
in the JAX package.  A problem's constant tensors are made on the device
and in the dtype of the point it is given, and cached per (device, dtype),
so that one instance serves the CPU, the card and every device of a mesh.
Instances pickle (the cache is dropped), so that a checkpoint or a spawn
pool can carry them.
"""

import math

import numpy as np
import torch

__all__ = [
    "CorrelatedGaussian", "Eggbox", "GaussianShells", "Rosenbrock",
    "WeddingCake", "LogGamma",
]

_INT32_MIN, _INT32_MAX = float(-2 ** 31), float(2 ** 31 - 1)


class _Problem:
    ndim = None
    logz_truth = None

    def _const(self, name, x):
        """The numpy constant ``self.<name>`` as a tensor on ``x``'s device
        and in its dtype (made once per device and dtype)."""
        cache = self.__dict__.setdefault("_consts", {})
        key = (name, x.device, x.dtype)
        if key not in cache:
            cache[key] = torch.as_tensor(getattr(self, name)).to(
                device=x.device, dtype=x.dtype)
        return cache[key]

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_consts", None)
        return state

    def loglike(self, x):
        raise NotImplementedError

    def ptform(self, u):
        raise NotImplementedError


class CorrelatedGaussian(_Problem):
    """ndim-D Gaussian with uniform correlation ``corr`` on a
    [-prior_win, prior_win]^ndim top-hat prior.

    The precision matrix is rounded to ``dtype`` (float32 by default, as
    in the JAX package) and promoted to the point's dtype where it is
    used."""

    def __init__(self, ndim=3, corr=0.95, prior_win=10.0,
                 dtype=np.float32):
        self.ndim = ndim
        self.prior_win = prior_win
        cov = np.identity(ndim)
        cov[cov == 0] = corr
        self._cinv = np.linalg.inv(cov).astype(dtype)
        self._lnorm = float(-0.5 * (np.log(2 * np.pi) * ndim +
                                    np.log(np.linalg.det(cov))))
        self.logz_truth = -ndim * np.log(2 * prior_win)

    def loglike(self, x):
        return -0.5 * torch.dot(x, self._const("_cinv", x) @ x) + \
            self._lnorm

    def ptform(self, u):
        return self.prior_win * (2.0 * u - 1.0)


class Eggbox(_Problem):
    """2-D multimodal eggbox (logz ~ 235.856)."""

    ndim = 2
    logz_truth = 235.856

    def loglike(self, x):
        tmax = 5.0 * np.pi
        t = 2.0 * tmax * x - tmax
        return (2.0 + torch.cos(t[0] / 2.0) * torch.cos(t[1] / 2.0)) ** 5.0

    def ptform(self, u):
        return u


class GaussianShells(_Problem):
    """Two overlapping 2-D Gaussian shells (logz ~ -1.75)."""

    ndim = 2
    logz_truth = -1.75

    def __init__(self, c1=(-3.5, 0.0), c2=(3.5, 0.0), r=2.0, w=0.1,
                 prior_win=6.0):
        self.c1 = np.asarray(c1, dtype=np.float64)
        self.c2 = np.asarray(c2, dtype=np.float64)
        self.r, self.w = r, w
        self.prior_win = prior_win

    def _shell(self, x, c):
        d = torch.linalg.vector_norm(x - self._const(c, x))
        return (-((d - self.r) ** 2) / (2.0 * self.w ** 2) -
                math.log(math.sqrt(2.0 * math.pi) * self.w))

    def loglike(self, x):
        return torch.logaddexp(self._shell(x, "c1"), self._shell(x, "c2"))

    def ptform(self, u):
        return self.prior_win * (2.0 * u - 1.0)


class Rosenbrock(_Problem):
    """ndim-D Rosenbrock density on [-5, 5]^ndim."""

    def __init__(self, ndim=2, a=1.0, b=100.0, prior_win=5.0):
        self.ndim = ndim
        self.a, self.b = a, b
        self.prior_win = prior_win

    def loglike(self, x):
        val = torch.sum(self.b * (x[1:] - x[:-1] ** 2) ** 2 +
                        (self.a - x[:-1]) ** 2)
        return -val

    def ptform(self, u):
        return self.prior_win * (2.0 * u - 1.0)


class WeddingCake(_Problem):
    """Fowlie et al. (2020) wedding-cake likelihood: an infinite stack of
    plateaus.  Exact evidence via the geometric series.

    At the centre (r = 0) the plateau index is +inf; it is clamped to the
    int32 range before the cast, as XLA's saturating cast does, so that
    the centre reads -0.0 as in the JAX package (an unclamped cast would
    give int32's minimum and -inf)."""

    def __init__(self, ndim=2, sig=0.2, alpha=0.7):
        self.ndim = ndim
        self.sig = sig
        self.alpha = alpha
        # exact logz: geometric series over the plateau shells
        D, a, s = ndim, alpha, sig
        i = np.arange(100)
        from scipy.special import logsumexp

        self.logz_truth = float(logsumexp(
            -a ** (2 * i / D) / (8 * s ** 2) + i * np.log(a) +
            np.log(1 - a)))

    def loglike(self, x):
        D, a, s = self.ndim, self.alpha, self.sig
        r = torch.max(torch.abs(x - 0.5))
        level = torch.floor(D * torch.log(2 * r) / math.log(a))
        # in float64, where int32's maximum is exact
        i = level.double().clamp(_INT32_MIN, _INT32_MAX).to(torch.int32)
        return -(a ** (2.0 * i.to(x.dtype) / D)) / (8.0 * s ** 2)

    def ptform(self, u):
        return u


class LogGamma(_Problem):
    """ndim-D mixture of log-gamma and normal distributions (the classic
    multimodal "LogGamma" test of Beaujean & Caldwell 2013); logz = 0 on
    the unit prior by construction (normalized density)."""

    def __init__(self, ndim=2, prior_win=30.0):
        if ndim < 2:
            raise ValueError(f"LogGamma needs ndim >= 2, got {ndim}")
        self.ndim = ndim
        self.prior_win = prior_win
        self.logz_truth = -ndim * np.log(2 * prior_win)

    def _log_gamma_pdf(self, x, loc, scale):
        z = (x - loc) / scale
        return z - torch.exp(z) - math.log(scale)

    def _log_norm_pdf(self, x, loc, scale):
        return (-0.5 * ((x - loc) / scale) ** 2 -
                0.5 * math.log(2 * math.pi * scale ** 2))

    def loglike(self, x):
        ga = torch.logaddexp(self._log_gamma_pdf(x[0], -10.0, 1.0),
                             self._log_gamma_pdf(x[0], 10.0, 1.0)) - \
            math.log(2.0)
        nb = torch.logaddexp(self._log_norm_pdf(x[1], -10.0, 1.0),
                             self._log_norm_pdf(x[1], 10.0, 1.0)) - \
            math.log(2.0)
        rest = 0.0
        for i in range(2, self.ndim):
            if i <= (self.ndim + 2) // 2 - 1:
                rest = rest + self._log_gamma_pdf(x[i], 10.0, 1.0)
            else:
                rest = rest + self._log_norm_pdf(x[i], 10.0, 1.0)
        # density normalized over R^ndim: the evidence is just the
        # uniform-prior volume factor (up to truncation tails)
        return ga + nb + rest

    def ptform(self, u):
        return self.prior_win * (2.0 * u - 1.0)
