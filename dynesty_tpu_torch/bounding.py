"""Bounding distributions: the unit cube, a single ellipsoid, and
friends-type unions of balls/cubes centred on the live points.

Host-side geometry in float64 numpy, as in ``dynesty_tpu.bounding``.  The
one device step is the leave-one-out nearest-neighbour distance that
sets the friends radius: at or above 2048 points it runs in float32 on
the sampler's device through :func:`..ops.hopper_kernels.pairwise_min_dist`
(the CUDA kernel on a card); below that it stays on the host in float64.
Multi-ellipsoid bounds and bootstrap expansion are not yet ported.
"""

import math

import numpy as np
import torch

from .ops.geometry import improve_covar_mat, logvol_prefactor, unitcheck
from .ops.hopper_kernels import pairwise_min_dist

__all__ = ["Bound", "UnitCube", "Ellipsoid", "RadFriends", "SupFriends",
           "bounding_ellipsoid", "get_bound", "FRIENDS_DEVICE_MIN_POINTS"]

# live sets at least this large take the device NN-distance path
FRIENDS_DEVICE_MIN_POINTS = 2048

_SQRTM_EPS = 1e-300


def _sym_eigh_funcs(mat):
    """Eigendecomposition-based pinv and sqrt of a symmetric PSD matrix."""
    vals, vecs = np.linalg.eigh(mat)
    safe = np.where(vals > _SQRTM_EPS, vals, np.inf)
    pinv = (vecs * (1.0 / safe)) @ vecs.T
    sqrt = (vecs * np.sqrt(np.maximum(vals, 0.0))) @ vecs.T
    return pinv, sqrt


def _slogdet_checked(mat):
    sign, logdet = np.linalg.slogdet(mat)
    if sign <= 0:
        raise np.linalg.LinAlgError(
            "The matrix is not positive definite; cannot take log-det.")
    return logdet


def _no_bootstrap(bootstrap):
    if bootstrap:
        raise NotImplementedError("bootstrap expansion of bounds is not "
                                  "yet ported; use bootstrap=0")


class Bound:
    """Common interface of all bounding distributions."""

    need_centers = False

    def __init__(self, ndim):
        self.ndim = ndim
        self.logvol = 0.0

    def contains(self, x):
        raise NotImplementedError

    def scale_to_logvol(self, logvol):
        raise NotImplementedError

    def update(self, points, rstate=None, bootstrap=0):
        raise NotImplementedError

    def device_spec(self):
        """(kind, arrays) export of the bound for the device rounds."""
        return None


class UnitCube(Bound):
    """The N-dimensional unit cube (logvol = 0)."""

    def contains(self, x):
        return unitcheck(x)

    def scale_to_logvol(self, logvol):
        pass

    def update(self, points, rstate=None, bootstrap=0):
        pass

    def device_spec(self):
        return ("cube", {})


class Ellipsoid(Bound):
    """An ellipsoid { x : (x-c)^T A (x-c) <= 1 }."""

    def __init__(self, ndim, ctr=None, cov=None, am=None, axes=None,
                 eig=None):
        super().__init__(ndim)
        if ctr is None:
            ctr = np.zeros(ndim)
            cov = np.identity(ndim) * ndim / 4.0
        self.ctr = np.asarray(ctr, dtype=np.float64)
        self.cov = np.asarray(cov, dtype=np.float64)
        vals, vecs = eig if eig is not None else np.linalg.eigh(self.cov)
        if not (np.all(vals > 0.0) and np.isfinite(vals).all()):
            raise ValueError(
                f"Singular covariance {self.cov} for ellipsoid (l={vals}).")
        self.axlens = np.sqrt(vals)
        self.logvol = logvol_prefactor(ndim) + 0.5 * np.log(vals).sum()
        self.axes = vecs * self.axlens if axes is None else axes
        self.am = (vecs * (1.0 / vals)) @ vecs.T if am is None else am

    def scale_to_logvol(self, logvol):
        """Inflate/deflate to a target volume, capping each axis at the
        cube half-diagonal (capped water-filling when anisotropic
        inflation is required)."""
        logf = logvol - self.logvol
        max_log_axlen = np.log(np.sqrt(self.ndim) / 2.0)
        log_axlen = np.log(self.axlens)
        if log_axlen.max() < max_log_axlen - logf / self.ndim:
            f = np.exp(logf / self.ndim)
            self.cov *= f ** 2
            self.am /= f ** 2
            self.axlens *= f
            self.axes *= f
        else:
            cap = np.maximum(max_log_axlen - log_axlen, 0.0)
            target = min(max(logf, 0.0), cap.sum())
            c = np.sort(cap)
            n = self.ndim
            csum = np.concatenate([[0.0], np.cumsum(c)])
            totals = csum[:-1] + (n - np.arange(n)) * c
            j = int(np.searchsorted(totals, target))
            theta = c[-1] if j >= n else (target - csum[j]) / (n - j)
            fax = np.exp(np.minimum(cap, theta))
            vecs = self.axes / self.axlens[None, :]
            scaled = (self.axlens * fax) ** 2
            self.cov = (vecs * scaled) @ vecs.T
            self.am = (vecs * (1.0 / scaled)) @ vecs.T
            self.axlens *= fax
            self.axes = self.axes * fax
        self.logvol = logvol

    def distance(self, x):
        d = x - self.ctr
        return np.sqrt(d @ self.am @ d)

    def contains(self, x):
        return self.distance(x) <= 1.0

    def update(self, points, rstate=None, bootstrap=0):
        """Refit to bound ``points``."""
        _no_bootstrap(bootstrap)
        ell = bounding_ellipsoid(points)
        for attr in ("ndim", "ctr", "cov", "am", "logvol", "axlens", "axes"):
            setattr(self, attr, getattr(ell, attr))
        self.last_expand = 1.0

    def device_spec(self):
        return ("ellipsoids", {
            "ctrs": self.ctr[None, :],
            "axes": self.axes[None, :, :],
            "ams": self.am[None, :, :],
            "logvols": np.array([self.logvol]),
        })


class _FriendsBase(Bound):
    """Shared machinery of RadFriends (p=2) / SupFriends (p=inf): a union
    of identical balls/cubes (shaped by a common covariance) centred on
    the live points.  ``device`` is where the leave-one-out distances of
    large live sets are computed."""

    ftype = None  # "balls" or "cubes"

    def __init__(self, ndim, cov=None, device=None):
        super().__init__(ndim)
        self.need_centers = True
        self.device = device
        if cov is None:
            cov = np.identity(ndim)
        self._set_cov(np.asarray(cov, dtype=np.float64))
        self.ctrs = []

    def _set_cov(self, cov):
        self.cov = cov
        pinv, sqrt = _sym_eigh_funcs(cov)
        self.am = pinv
        self.axes = sqrt
        self.axes_inv = _sym_eigh_funcs(sqrt)[0]
        self.logvol = self._kernel_logvol()

    def _kernel_logvol(self):
        p = 2.0 if self.ftype == "balls" else np.inf
        return logvol_prefactor(self.ndim, p=p) - \
            0.5 * _slogdet_checked(self.am)

    def _norm(self, dx_t, axis=None):
        raise NotImplementedError

    def scale_to_logvol(self, logvol):
        f = np.exp((logvol - self.logvol) / self.ndim)
        self.cov *= f ** 2
        self.am /= f ** 2
        self.axes *= f
        self.axes_inv /= f
        self.logvol = logvol

    def within(self, x):
        dt = (np.asarray(self.ctrs) - x) @ self.axes_inv
        return np.where(self._norm(dt, axis=1) <= 1.0)[0]

    def contains(self, x):
        return len(self.within(x)) > 0

    def update(self, points, rstate=None, bootstrap=0):
        """Refit the kernel covariance (from re-centred single-linkage
        clusters) and the common radius (leave-one-out NN distances)."""
        _no_bootstrap(bootstrap)
        self._set_cov(np.atleast_2d(self._covariance_from_clusters(points)))
        points_t = points @ self.axes_inv
        radii = _friends_leaveoneout_radius(points_t, self.ftype,
                                            self.device)
        rmax = max(np.max(radii), 1e-10)
        self.cov *= rmax ** 2
        self.am /= rmax ** 2
        self.axes *= rmax
        self.axes_inv /= rmax
        self.ctrs = np.array(points)
        self.logvol = self._kernel_logvol()

    def _covariance_from_clusters(self, points):
        """Covariance of points re-centred on their single-linkage
        clusters (cut at Mahalanobis distance 1)."""
        delta = points[:, None, :] - points[None, :, :]
        sq = np.einsum("abi,ij,abj->ab", delta, self.am, delta)
        labels = _connected_components(np.sqrt(np.maximum(sq, 0)) <= 1.0)
        if labels.max() == 0:
            return np.cov(points, rowvar=False)
        centered = np.empty_like(points)
        for lab in np.unique(labels):
            grp = points[labels == lab]
            centered[labels == lab] = grp - grp.mean(axis=0)
        return np.cov(centered, rowvar=False)

    def device_spec(self):
        return (self.ftype, {"axes": self.axes, "axes_inv": self.axes_inv})


class RadFriends(_FriendsBase):
    """Union of identical n-balls centred on the live points."""

    ftype = "balls"

    def _norm(self, dx_t, axis=None):
        return np.linalg.norm(dx_t, axis=axis)


class SupFriends(_FriendsBase):
    """Union of identical n-cubes centred on the live points."""

    ftype = "cubes"

    def _norm(self, dx_t, axis=None):
        return np.abs(dx_t).max(axis=axis)


def bounding_ellipsoid(points):
    """The ellipsoid bounding ``points``: MLE mean/cov scaled so the
    outermost point has Mahalanobis distance 1 - 1e-3."""
    points = np.asarray(points, dtype=np.float64)
    npoints, ndim = points.shape
    if npoints == 1:
        raise ValueError("Cannot bound a single point with an ellipsoid.")
    ctr = points.mean(axis=0)
    delta = points - ctr
    covar = np.atleast_2d(delta.T @ delta / npoints)
    one_minus = 1.0 - 1e-3
    for attempt in range(2):
        good_mat, covar, am, axes, (evals, evecs) = \
            improve_covar_mat(covar)
        fmax = np.einsum("ij,jk,ik->i", delta, am, delta).max()
        if attempt == 0 and fmax > one_minus:
            mult = fmax / one_minus
            covar = covar * mult
            am = am / mult
            axes = axes * np.sqrt(mult)
            evals = evals * mult
        if attempt == 1 and fmax >= 1:
            raise RuntimeError("Could not scale the ellipsoid to contain "
                               "all the points.")
        if good_mat:
            break
    return Ellipsoid(ndim, ctr=ctr, cov=covar, am=am, axes=axes,
                     eig=(evals, evecs))


def _pairwise_dist(a, b, ftype):
    """Brute-force pairwise distances (n_a, n_b); p=2 for balls, p=inf
    for cubes."""
    delta = a[:, None, :] - b[None, :, :]
    if ftype == "balls":
        return np.sqrt((delta ** 2).sum(axis=2))
    if ftype == "cubes":
        return np.abs(delta).max(axis=2)
    raise ValueError(f"Unknown friends type {ftype}")


def _friends_leaveoneout_radius(points, ftype, device):
    """Leave-one-out nearest-neighbour distance of each point.

    Sets of at least :data:`FRIENDS_DEVICE_MIN_POINTS` go to ``device`` in
    float32 (the CUDA kernel on a card); smaller ones stay on the host in
    float64, as in the JAX package."""
    if len(points) >= FRIENDS_DEVICE_MIN_POINTS:
        if device is None:
            raise ValueError("a friends bound over >= "
                             f"{FRIENDS_DEVICE_MIN_POINTS} points needs "
                             "a device")
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=device).contiguous()
        p = 2 if ftype == "balls" else math.inf
        return pairwise_min_dist(pts, p=p).cpu().numpy()
    d = _pairwise_dist(points, points, ftype)
    np.fill_diagonal(d, np.inf)
    return d.min(axis=1)


def _connected_components(adjacency):
    """Labels of connected components of a boolean adjacency matrix
    (single-linkage clustering cut at the same threshold)."""
    n = len(adjacency)
    labels = np.full(n, -1, dtype=int)
    current = 0
    for i in range(n):
        if labels[i] >= 0:
            continue
        stack = [i]
        labels[i] = current
        while stack:
            j = stack.pop()
            nbrs = np.nonzero(adjacency[j] & (labels < 0))[0]
            labels[nbrs] = current
            stack.extend(nbrs.tolist())
        current += 1
    return labels


def get_bound(bound, ndim, device=None):
    """Resolve a bound name to an instance ('multi' is not yet
    ported)."""
    if isinstance(bound, Bound):
        return bound
    if bound == "none":
        return UnitCube(ndim)
    if bound == "single":
        return Ellipsoid(ndim)
    if bound == "balls":
        return RadFriends(ndim, device=device)
    if bound == "cubes":
        return SupFriends(ndim, device=device)
    if bound == "multi":
        raise NotImplementedError("bound='multi' is not yet ported")
    raise ValueError(f"Unknown bound option '{bound}'")
