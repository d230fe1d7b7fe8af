"""Geometry primitives: unit-cube checks, sphere sampling, weighted
choice, covariance conditioning.

Host (numpy) versions serve the bound fits; the ``_batch`` versions run
on device tensors inside the proposal rounds.  Semantics follow
``dynesty_tpu.ops.geometry``."""

import math

import numpy as np
import torch

__all__ = [
    "unitcheck", "unitcheck_batch", "apply_reflect", "randsphere",
    "randsphere_batch",
    "logvol_prefactor", "rand_choice", "mle_cov", "improve_covar_mat",
]


def unitcheck(u, nonbounded=None):
    """Host check that point ``u`` lies in the unit cube; dimensions marked
    False in ``nonbounded`` may roam in (-0.5, 1.5)."""
    u = np.asarray(u)
    if nonbounded is None:
        return bool(u.min() > 0 and u.max() < 1)
    nonbounded = np.asarray(nonbounded, dtype=bool)
    strict, loose = u[nonbounded], u[~nonbounded]
    ok = True
    if strict.size:
        ok &= bool(strict.min() > 0 and strict.max() < 1)
    if loose.size:
        ok &= bool(loose.min() > -0.5 and loose.max() < 1.5)
    return ok


def unitcheck_batch(u, nonbounded=None):
    """Device check for a batch ``u`` of shape (..., ndim); returns a bool
    tensor of shape (...).  ``nonbounded`` is a bool vector (ndim,) or
    None."""
    if nonbounded is None:
        return ((u > 0) & (u < 1)).all(dim=-1)
    nb = torch.as_tensor(nonbounded, dtype=torch.bool, device=u.device)
    lo = torch.where(nb, 0.0, -0.5).to(u.dtype)
    hi = torch.where(nb, 1.0, 1.5).to(u.dtype)
    return ((u > lo) & (u < hi)).all(dim=-1)


def apply_reflect(u):
    """Device: map values to [0, 1] by repeated reflection at both edges
    (elementwise, any shape): 2n + x and 2n - x both map to x."""
    m2 = torch.remainder(u, 2.0)
    return torch.where(m2 < 1.0, m2, 2.0 - m2)


def randsphere(n, rstate):
    """Host: one point uniform in the n-ball (Gaussian direction times a
    U^{1/n} radius)."""
    z = rstate.standard_normal(size=n)
    r = rstate.random() ** (1.0 / n)
    return z * (r / np.linalg.norm(z))


def randsphere_batch(gen, shape_prefix, n, dtype, device):
    """Device: points uniform in the n-ball, shape ``shape_prefix + (n,)``,
    drawn from the ``torch.Generator`` ``gen``."""
    shape_prefix = tuple(shape_prefix)
    z = torch.randn(shape_prefix + (n,), generator=gen, dtype=dtype,
                    device=device)
    r = torch.rand(shape_prefix + (1,), generator=gen, dtype=dtype,
                   device=device) ** (1.0 / n)
    norm = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    return z * (r / norm.clamp_min(torch.finfo(dtype).tiny))


def logvol_prefactor(n, p=2.0):
    """ln(volume constant) of the n-dim unit L^p ball:
    n ln 2 + n lnGamma(1/p + 1) - lnGamma(n/p + 1)."""
    p = float(p)
    return (n * math.log(2.0) + n * math.lgamma(1.0 / p + 1.0) -
            math.lgamma(n / p + 1.0))


def rand_choice(probs, rstate):
    """Host: index drawn with probabilities ``probs`` (must sum to ~1)."""
    cum = np.cumsum(probs)
    return min(int(np.searchsorted(cum, rstate.random())), len(probs) - 1)


def mle_cov(points):
    """Host: maximum-likelihood (1/N) covariance of points (npoints,
    ndim)."""
    points = np.asarray(points, dtype=np.float64)
    delta = points - points.mean(axis=0)
    return delta.T @ delta / len(points)


def improve_covar_mat(covar0, ntries=100, max_condition_number=1e12):
    """Repair a covariance matrix that is singular, non-finite, or too
    ill-conditioned.

    Returns ``(good, covar, am, axes, (eigval, eigvec))``: ``good`` means
    no repair was needed, ``am`` is the precision matrix, ``axes`` the
    principal-axis transform, and the last tuple the eigendecomposition
    of the returned ``covar``."""
    ndim = covar0.shape[0]
    covar = np.array(covar0, dtype=np.float64)
    coeff_min = 1e-10
    eig_margin = 10.0
    eigval = eigvec = axes = None
    failed = 0
    for trial in range(ntries):
        failed = 0
        try:
            eigval, eigvec = np.linalg.eigh(covar)
            if np.isfinite(eigval).all():
                vmax, vmin = eigval.max(), eigval.min()
                if vmax <= 0:
                    failed = 2
                elif vmin < vmax / max_condition_number:
                    failed = 1
                else:
                    axes = eigvec * np.sqrt(eigval)
                    break
            else:
                failed = 2
        except np.linalg.LinAlgError:
            failed = 2
        if failed == 1:
            floor = eig_margin * eigval.max() / max_condition_number
            covar = (eigvec * np.maximum(eigval, floor)) @ eigvec.T
        elif failed == 2:
            coeff = coeff_min * (1.0 / coeff_min) ** (trial / (ntries - 1))
            covar = (1.0 - coeff) * covar + coeff * np.eye(ndim)
    if failed > 0:
        import warnings

        warnings.warn("Could not condition the ellipsoid covariance; "
                      "falling back to a unit sphere.")
        covar = np.eye(ndim)
        return (False, covar, covar.copy(), covar.copy(),
                (np.ones(ndim), np.eye(ndim)))
    am = (eigvec * (1.0 / eigval)) @ eigvec.T
    return trial == 0, covar, am, axes, (eigval, eigvec)
