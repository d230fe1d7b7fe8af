"""Evidence integration: the quadratic (trapezoid) nested-sampling
estimator (same semantics as ``dynesty_tpu.ops.integrals``).

The host functions are float64 numpy; :func:`progress_integration_torch`
is the one-step update on float64 device scalars used inside the fused
consume loop."""

import math

import numpy as np
import torch

__all__ = [
    "LOWL_VAL", "compute_integrals", "progress_integration",
    "progress_integration_torch", "get_neff_from_logwt",
]

# large-but-finite "-inf" so exp(logl - norm) * logl evaluates to 0
LOWL_VAL = -1e300

_LN_HALF = math.log(0.5)


def compute_integrals(*, logl, logvol, reweight=None):
    """Log-weights, cumulative log-evidence, its variance and the
    information from dead-point ``logl`` and ``logvol`` arrays."""
    logl = np.asarray(logl, dtype=np.float64)
    logvol = np.asarray(logvol, dtype=np.float64)
    lpad = np.concatenate([[LOWL_VAL], logl])
    dlv = np.diff(logvol, prepend=0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_shell = (logvol - dlv) + np.log1p(-np.exp(dlv))
    log_shell = np.where(dlv == 0, -np.inf, log_shell)
    log_half_shell = log_shell + _LN_HALF

    logwt = np.logaddexp(lpad[1:], lpad[:-1]) + log_half_shell
    if reweight is not None:
        logwt = logwt + np.asarray(reweight, dtype=np.float64)
    logz = np.logaddexp.accumulate(logwt)
    logz_max = logz[-1]
    with np.errstate(invalid="ignore"):
        h_terms = (np.exp(lpad[1:] - logz_max + log_half_shell) * lpad[1:] +
                   np.exp(lpad[:-1] - logz_max + log_half_shell) * lpad[:-1])
    h_terms = np.nan_to_num(h_terms, nan=0.0)
    h = np.cumsum(h_terms) - logz_max * np.exp(logz - logz_max)
    dh = np.diff(h, prepend=0.0)
    logzvar = np.abs(np.cumsum(dh * (-dlv)))
    return logwt, logz, logzvar, h


def progress_integration(loglstar, loglstar_new, logz, logzvar, logvol,
                         dlogvol, h):
    """One streaming step of the trapezoid estimator (host floats).
    ``logvol`` is the already decremented log-volume and ``dlogvol > 0``
    this iteration's shrinkage.  Returns ``(logwt, logz, logzvar, h)``."""
    log_half_shell = (logvol + dlogvol + _LN_HALF +
                      math.log1p(-math.exp(-dlogvol)))
    logwt = np.logaddexp(loglstar_new, loglstar) + log_half_shell
    logz_new = np.logaddexp(logz, logwt)
    lzterm = (math.exp(loglstar - logz_new + log_half_shell) * loglstar +
              math.exp(loglstar_new - logz_new + log_half_shell) *
              loglstar_new)
    h_new = lzterm + math.exp(logz - logz_new) * (h + logz) - logz_new
    logzvar_new = logzvar + (h_new - h) * dlogvol
    return logwt, logz_new, logzvar_new, h_new


def progress_integration_torch(loglstar, loglstar_new, logz, logzvar,
                               logvol, dlogvol, h):
    """:func:`progress_integration` on float64 0-d tensors (the same
    operations in the same order as the JAX package's
    ``progress_integration_jax``)."""
    log_half_shell = (logvol + dlogvol + _LN_HALF +
                      torch.log1p(-torch.exp(-dlogvol)))
    logwt = torch.logaddexp(loglstar_new, loglstar) + log_half_shell
    logz_new = torch.logaddexp(logz, logwt)
    lzterm = (torch.exp(loglstar - logz_new + log_half_shell) * loglstar +
              torch.exp(loglstar_new - logz_new + log_half_shell) *
              loglstar_new)
    h_new = lzterm + torch.exp(logz - logz_new) * (h + logz) - logz_new
    logzvar_new = logzvar + (h_new - h) * dlogvol
    return logwt, logz_new, logzvar_new, h_new


def get_neff_from_logwt(logwt):
    """Kish effective sample size from unnormalized log-weights."""
    logwt = np.asarray(logwt, dtype=np.float64)
    w = np.exp(logwt - logwt.max())
    return w.sum() ** 2 / (w ** 2).sum()
