"""Bounding distributions: the unit cube, single and multiple ellipsoids,
and friends-type unions of balls/cubes centred on the live points.

Host-side geometry in float64 numpy, copied from ``dynesty_tpu.bounding``
so that the same points and bootstrap seeds give bit-identical bounds:
the recursive BIC-guided ellipsoid splitter (and its batched
breadth-first form, which fits the main decomposition and every
bootstrap realization as one forest), bootstrap expansion, and friends
radii from leave-one-out or bootstrap nearest neighbours.  The one
device step is the leave-one-out nearest-neighbour distance that sets
the friends radius without bootstrap: at or above 2048 points it runs in
float32 on the sampler's device through
:func:`..ops.hopper_kernels.pairwise_min_dist` (the CUDA kernel on a
card); below that it stays on the host in float64.  Bootstrap radii stay
on the host, as in the JAX package.

Every ``update`` takes a ``pool``: the bootstrap realisations then map over
its workers as numpy tasks (the multi-ellipsoid fit takes the recursive
splitter there, the batched forest without a pool), and the processes
that ran them are kept in ``last_bootstrap_pids``.  ``mc_integrate=True``
also estimates the bound's volume and its share inside the unit cube
(``funit``) by Monte Carlo.

Every bound also draws on the host from a caller's numpy ``rstate``
(``sample``, ``samples``, the Monte Carlo volumes), with the JAX package's
code, so that the same fitted bound and seed give the same bits; plots of
saved bounds and a user's own ``Bound`` subclass (a bound without a
``device_spec``, sampled through ``samples`` between device waves) rest on
them.
"""

import copy
import math
import os
import warnings

import numpy as np
import torch

from .ops.geometry import (improve_covar_mat, logvol_prefactor, rand_choice,
                           randsphere, unitcheck)
from .ops.hopper_kernels import pairwise_min_dist
from .utils.misc import get_random_generator, get_seed_sequence

__all__ = ["Bound", "UnitCube", "Ellipsoid", "MultiEllipsoid", "RadFriends",
           "SupFriends", "bounding_ellipsoid", "bounding_ellipsoids",
           "get_bound", "FRIENDS_DEVICE_MIN_POINTS"]

# live sets at least this large take the device NN-distance path
FRIENDS_DEVICE_MIN_POINTS = 2048

_SQRTM_EPS = 1e-300


def _logsumexp(x):
    x = np.asarray(x, dtype=np.float64)
    m = x.max()
    if not np.isfinite(m):
        return m
    return m + np.log(np.exp(x - m).sum())


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


class Bound:
    """Common interface of all bounding distributions.  A user's subclass
    implements ``contains``, ``samples`` (or ``sample``),
    ``get_random_axes``, ``scale_to_logvol`` and ``update``; without a
    ``device_spec`` the sampler calls it a 'custom' bound."""

    need_centers = False

    def __init__(self, ndim):
        self.ndim = ndim
        self.logvol = 0.0
        self.funit = 1.0

    def contains(self, x):
        raise NotImplementedError

    def sample(self, rstate=None):
        raise NotImplementedError

    def samples(self, nsamples, rstate=None):
        return np.array([self.sample(rstate=rstate)
                         for _ in range(nsamples)])

    def scale_to_logvol(self, logvol):
        raise NotImplementedError

    def update(self, points, rstate=None, bootstrap=0, pool=None):
        raise NotImplementedError

    def get_random_axes(self, rstate):
        """Axes of a proposal started inside the bound (host rounds)."""
        raise NotImplementedError

    def device_spec(self):
        """(kind, arrays) export of the bound for the device rounds; None
        for a bound that is sampled on the host (``samples``)."""
        return None


class UnitCube(Bound):
    """The N-dimensional unit cube (logvol = 0)."""

    def contains(self, x):
        return unitcheck(x)

    def sample(self, rstate=None):
        return rstate.random(size=self.ndim)

    def samples(self, nsamples, rstate=None):
        return rstate.random(size=(nsamples, self.ndim))

    def scale_to_logvol(self, logvol):
        pass

    def update(self, points, rstate=None, bootstrap=0, pool=None):
        pass

    def get_random_axes(self, rstate):
        return np.eye(self.ndim)

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

    def major_axis_endpoints(self):
        i = np.argmax(self.axlens)
        v = self.axes[:, i]
        return self.ctr - v, self.ctr + v

    def distance(self, x):
        d = x - self.ctr
        return np.sqrt(d @ self.am @ d)

    def distance_many(self, x):
        d = x - self.ctr[None, :]
        return np.sqrt(np.einsum("ij,jk,ik->i", d, self.am, d))

    def contains(self, x):
        return self.distance(x) <= 1.0

    def sample(self, rstate=None):
        return self.ctr + self.axes @ randsphere(self.ndim, rstate)

    def samples(self, nsamples, rstate=None):
        z = rstate.standard_normal(size=(nsamples, self.ndim))
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        r = rstate.random(size=(nsamples, 1)) ** (1.0 / self.ndim)
        return self.ctr + (z * r) @ self.axes.T

    def unitcube_overlap(self, ndraws=10000, rstate=None):
        """Monte Carlo share of the ellipsoid inside the unit cube."""
        xs = self.samples(ndraws, rstate=rstate)
        return np.sum(np.all((xs > 0) & (xs < 1), axis=1)) / ndraws

    def update(self, points, rstate=None, bootstrap=0, pool=None,
               mc_integrate=False):
        """Refit to bound ``points``, expanded by the worst bootstrap
        leave-out distance when ``bootstrap > 0`` (realisations over
        ``pool`` when given); ``mc_integrate`` sets ``funit``."""
        ell = bounding_ellipsoid(points)
        for attr in ("ndim", "ctr", "cov", "am", "logvol", "axlens", "axes"):
            setattr(self, attr, getattr(ell, attr))
        self.last_expand = 1.0
        if bootstrap > 0:
            expand = _mapped_bootstrap(
                self, pool, _ellipsoid_expand_task,
                [(False, points, s)
                 for s in get_seed_sequence(rstate, bootstrap)])
            if expand > 1.0:
                self.last_expand = expand
                self.scale_to_logvol(self.logvol +
                                     self.ndim * np.log(expand))
        if mc_integrate:
            self.funit = self.unitcube_overlap(rstate=rstate)

    def get_random_axes(self, rstate):
        return self.axes

    def device_spec(self):
        return ("ellipsoids", {
            "ctrs": self.ctr[None, :],
            "axes": self.axes[None, :, :],
            "ams": self.am[None, :, :],
            "logvols": np.array([self.logvol]),
        })


class MultiEllipsoid(Bound):
    """A union of ellipsoids stored both as objects and as stacked arrays
    (``ctrs (M,d)``, ``covs``/``ams (M,d,d)``) for batched membership."""

    def __init__(self, ndim, ells=None, ctrs=None, covs=None):
        super().__init__(ndim)
        if ells is None and ctrs is None:
            ells = [Ellipsoid(ndim)]
        if ells is not None:
            if ctrs is not None or covs is not None:
                raise ValueError("Give either `ells` or (`ctrs`, `covs`), "
                                 "not both.")
            self.ells = list(ells)
        else:
            if covs is None:
                raise ValueError("Need `covs` along with `ctrs`.")
            self.ells = [Ellipsoid(ndim, ctr=c, cov=v)
                         for c, v in zip(ctrs, covs)]
        self.nells = len(self.ells)
        self._sync_arrays()
        self.logvol = _logsumexp(self.logvol_ells)

    def _sync_arrays(self):
        self.ctrs = np.array([e.ctr for e in self.ells])
        self.covs = np.array([e.cov for e in self.ells])
        self.ams = np.array([e.am for e in self.ells])
        self.logvol_ells = np.array([e.logvol for e in self.ells])

    def scale_to_logvol(self, logvol):
        """Scale each ellipsoid to per-ellipsoid targets (iterable) or
        shift the whole union to a new total volume (scalar)."""
        if np.iterable(logvol):
            targets = np.asarray(logvol)
        else:
            targets = self.logvol_ells + (logvol - self.logvol)
        for ell, t in zip(self.ells, targets):
            ell.scale_to_logvol(t)
        self._sync_arrays()
        self.logvol = _logsumexp(self.logvol_ells)

    def major_axis_endpoints(self):
        return np.array([e.major_axis_endpoints() for e in self.ells])

    def _sq_distances(self, x):
        d = x[None, :] - self.ctrs
        return np.einsum("ai,aij,aj->a", d, self.ams, d)

    def within(self, x, j=None):
        """Indices of the ellipsoids holding ``x`` (leaving out ``j``)."""
        mask = self._sq_distances(x) < 1
        if j is not None:
            mask[j] = False
        return np.nonzero(mask)[0]

    def overlap(self, x, j=None):
        return len(self.within(x, j=j))

    def contains(self, x):
        return bool(np.any(self._sq_distances(x) < 1))

    def contains_many(self, xs):
        """Vectorized membership for (n, ndim) points."""
        d = xs[:, None, :] - self.ctrs[None, :, :]
        sq = np.einsum("nai,aij,naj->na", d, self.ams, d)
        return np.any(sq < 1, axis=1)

    def sample(self, rstate=None, return_q=False):
        """A point uniform in the union (a volume-weighted ellipsoid, a
        point in it, 1/q overlap rejection); returns ``(x, idx)``, or
        ``(x, idx, q)`` without the rejection when ``return_q``."""
        if self.nells == 1:
            x = self.ells[0].sample(rstate=rstate)
            return (x, 0, 1) if return_q else (x, 0)
        probs = np.exp(self.logvol_ells - self.logvol)
        while True:
            idx = rand_choice(probs, rstate)
            x = self.ells[idx].sample(rstate=rstate)
            sq = self._sq_distances(x)
            q = int((sq < 1).sum())
            if q == 0:
                # round-off rescue: accept boundary-grazing membership
                q = int((sq <= 1 + 1e-3).sum())
                if q == 0:
                    raise RuntimeError(
                        f"Ellipsoid membership check failed (min={sq.min()})")
                warnings.warn("Numerical inaccuracies in ellipsoidal "
                              "sampling; posteriors may be very elongated.")
            if return_q:
                return x, idx, q
            if q == 1 or rstate.random() < 1.0 / q:
                return x, idx

    def samples(self, nsamples, rstate=None):
        return np.array([self.sample(rstate=rstate)[0]
                         for _ in range(nsamples)])

    def monte_carlo_logvol(self, ndraws=10000, rstate=None,
                           return_overlap=True):
        """Monte Carlo log-volume of the union, and with
        ``return_overlap`` its share inside the unit cube."""
        draws = [self.sample(rstate=rstate, return_q=True)
                 for _ in range(ndraws)]
        qsum = sum(1.0 / q for (_, _, q) in draws)
        logvol = np.log(qsum / ndraws) + self.logvol
        if return_overlap:
            qin = sum(1.0 / q * unitcheck(x) for (x, _, q) in draws)
            return logvol, qin / qsum
        return logvol

    def update(self, points, rstate=None, bootstrap=0, pool=None,
               mc_integrate=False):
        """Refit by BIC-guided splitting, with the all-points-contained
        invariant and optional bootstrap expansion.  Without a pool the
        batched breadth-first splitter fits the main decomposition and
        every bootstrap realization as one forest; with one, the recursive
        splitter fits the main decomposition and each realization is a
        task for the workers.  Both give the same fit.  ``mc_integrate``
        replaces ``logvol`` by its Monte Carlo estimate and sets
        ``funit``."""
        npoints, ndim = points.shape
        if npoints == 1:
            raise RuntimeError("Cannot bound a single point.")
        seeds = get_seed_sequence(rstate, bootstrap) if bootstrap > 0 \
            else ()
        if pool is None:
            ells, expands = _fit_multi_batched(points, seeds)
            if bootstrap > 0:
                self.last_bootstrap_pids = [os.getpid()] * bootstrap
        else:
            ells = _bounding_ellipsoids(points, bounding_ellipsoid(points))
            expands = [_mapped_bootstrap(
                self, pool, _ellipsoid_expand_task,
                [(True, points, s) for s in seeds])] if bootstrap > 0 else []
        self.nells = len(ells)
        self.ells = ells
        self._sync_arrays()
        if not self.contains_many(points).all():
            raise RuntimeError("Rejecting invalid MultiEllipsoid region")
        self.logvol = _logsumexp(self.logvol_ells)
        self.last_expand = 1.0
        if bootstrap > 0:
            expand = max(expands)
            self.last_expand = max(expand, 1.0)
            if np.log10(expand) * ndim > 2:
                warnings.warn(
                    "Very large bootstrap enlargement of the ellipsoid "
                    "bounds; the posterior is probably hard to bound. "
                    "Consider more live points, rslice sampling, or "
                    "bootstrap=0.")
            if expand > 1.0:
                self.scale_to_logvol(self.logvol_ells +
                                     ndim * np.log(expand))
        if mc_integrate:
            self.logvol, self.funit = self.monte_carlo_logvol(
                rstate=rstate, return_overlap=True)

    def get_random_axes(self, rstate):
        probs = np.exp(self.logvol_ells - self.logvol)
        return self.ells[rand_choice(probs, rstate)].axes

    def device_spec(self):
        return ("ellipsoids", {
            "ctrs": self.ctrs,
            "axes": np.array([e.axes for e in self.ells]),
            "ams": self.ams,
            "logvols": self.logvol_ells,
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

    def _offset(self, rstate):
        """A point in the unit kernel (ball or cube)."""
        raise NotImplementedError

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

    def overlap(self, x):
        return len(self.within(x))

    def contains(self, x):
        return self.overlap(x) > 0

    def sample(self, rstate=None, return_q=False):
        """A point uniform in the union (a random centre, a kernel offset,
        1/q overlap rejection); ``(x, q)`` without the rejection when
        ``return_q``."""
        nctrs = len(self.ctrs)
        while True:
            dx = self._offset(rstate) @ self.axes
            if nctrs == 1:
                q = 1
                x = self.ctrs[0] + dx
            else:
                idx = rstate.integers(nctrs)
                x = self.ctrs[idx] + dx
                q = self.overlap(x)
            if q == 1 or return_q or rstate.random() < 1.0 / q:
                if return_q:
                    return x, q
                return x

    def samples(self, nsamples, rstate=None):
        return np.array([self.sample(rstate=rstate)
                         for _ in range(nsamples)])

    def monte_carlo_logvol(self, ndraws=10000, rstate=None,
                           return_overlap=True):
        """Monte Carlo log-volume of the union, and with
        ``return_overlap`` its share inside the unit cube."""
        draws = [self.sample(rstate=rstate, return_q=True)
                 for _ in range(ndraws)]
        qs = np.array([q for (_, q) in draws])
        qsum = np.sum(1.0 / qs)
        logvol = np.log(qsum / ndraws * len(self.ctrs)) + self.logvol
        if return_overlap:
            qin = sum(1.0 / q * unitcheck(x) for (x, q) in draws)
            return logvol, qin / qsum
        return logvol

    def update(self, points, rstate=None, bootstrap=0, pool=None,
               mc_integrate=False, use_clustering=True):
        """Refit the kernel covariance (from re-centred single-linkage
        clusters, or of the points as they are without
        ``use_clustering``) and the common radius (leave-one-out NN
        distances, or the worst of ``bootstrap`` bootstrap NN distances, on
        the host or over ``pool``); ``mc_integrate`` sets ``funit``."""
        cov = self._covariance_from_clusters(points) if use_clustering \
            else np.cov(points, rowvar=False)
        self._set_cov(np.atleast_2d(cov))
        points_t = points @ self.axes_inv
        if bootstrap == 0:
            radii = _friends_leaveoneout_radius(points_t, self.ftype,
                                                self.device)
        else:
            radii = _mapped_bootstrap(
                self, pool, _friends_radius_task,
                [(points_t, self.ftype, s)
                 for s in get_seed_sequence(rstate, bootstrap)])
        rmax = max(np.max(radii), 1e-10)
        self.cov *= rmax ** 2
        self.am /= rmax ** 2
        self.axes *= rmax
        self.axes_inv /= rmax
        self.ctrs = np.array(points)
        self.logvol = self._kernel_logvol()
        if mc_integrate:
            self.funit = self.monte_carlo_logvol(rstate=rstate,
                                                 return_overlap=True)[1]

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

    def get_random_axes(self, rstate):
        return self.axes

    def device_spec(self):
        return (self.ftype, {"axes": self.axes, "axes_inv": self.axes_inv})


class RadFriends(_FriendsBase):
    """Union of identical n-balls centred on the live points."""

    ftype = "balls"

    def _offset(self, rstate):
        return randsphere(self.ndim, rstate)

    def _norm(self, dx_t, axis=None):
        return np.linalg.norm(dx_t, axis=axis)


class SupFriends(_FriendsBase):
    """Union of identical n-cubes centred on the live points."""

    ftype = "cubes"

    def _offset(self, rstate):
        return rstate.random(self.ndim) * 2.0 - 1.0

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


def _kmeans2(points, start_ctrs, niter=10):
    """Plain Lloyd's k-means (k=2) from given start centres; empty
    clusters keep their previous centroid.  The halfspace form of
    :func:`_batched_kmeans2`, so both give bit-identical labels."""
    ctrs = np.array(start_ctrs, dtype=np.float64)
    k, ndim = ctrs.shape
    if k != 2:
        raise ValueError(f"_kmeans2 takes 2 start centres, got {k}")
    labels = None
    for _ in range(niter):
        dc = ctrs[0] - ctrs[1]
        thresh = 0.5 * ((ctrs[0] ** 2).sum() - (ctrs[1] ** 2).sum())
        new_labels = (points @ dc < thresh).astype(np.int64)
        if labels is not None and np.array_equal(new_labels, labels):
            break
        labels = new_labels
        counts = np.bincount(labels, minlength=k).astype(np.float64)
        sums = np.empty((k, ndim))
        for d in range(ndim):
            sums[:, d] = np.bincount(labels, weights=points[:, d],
                                     minlength=k)
        nonempty = counts > 0
        ctrs[nonempty] = sums[nonempty] / counts[nonempty, None]
    return ctrs, labels


def _bounding_ellipsoids(points, ell, scale=None):
    """Recursively split ``ell`` while the k=2 split (seeded at the
    major-axis endpoints) decreases the total volume by at least the
    BIC-motivated decrement ndim(ndim+3)/2 * ln(N)/N."""
    npoints, ndim = points.shape
    min_size = 2 * ndim
    if npoints < min_size * 2:
        return [ell]
    p1, p2 = ell.major_axis_endpoints()
    start_ctrs = np.vstack((p1, p2))
    if scale is None:
        scale = points.std(axis=0)[None, :]
        scale = np.where(scale > 0, scale, 1.0)
    _, labels = _kmeans2(points / scale, start_ctrs / scale, niter=10)
    points_k = [points[labels == k] for k in (0, 1)]
    if min(len(points_k[0]), len(points_k[1])) < min_size:
        return [ell]
    try:
        ells = [bounding_ellipsoid(pk) for pk in points_k]
    except (np.linalg.LinAlgError, RuntimeError):
        return [ell]
    nparam = (ndim * (ndim + 3)) // 2
    log_vol_dec = nparam * np.log(npoints) / npoints
    out_ells = (_bounding_ellipsoids(points_k[0], ells[0], scale=scale) +
                _bounding_ellipsoids(points_k[1], ells[1], scale=scale))
    if (np.logaddexp(ells[0].logvol, ells[1].logvol) -
            ell.logvol) < -log_vol_dec:
        return out_ells
    if (_logsumexp([e.logvol for e in out_ells]) - ell.logvol) < \
            -log_vol_dec * (len(out_ells) - 1):
        return out_ells
    return [ell]


def bounding_ellipsoids(points):
    """A MultiEllipsoid fitted to ``points`` by the recursive splitter."""
    ell = bounding_ellipsoid(points)
    return MultiEllipsoid(points.shape[1],
                          ells=_bounding_ellipsoids(points, ell))


def _bootstrap_points(points, rseed):
    """Bootstrap-resample points into (selected, left-out) subsets,
    padding degenerate draws so both are non-empty."""
    rstate = get_random_generator(rseed)
    npoints = points.shape[0]
    idxs = rstate.integers(npoints, size=npoints)
    sel = np.zeros(npoints, dtype=bool)
    sel[np.unique(idxs)] = True
    if sel.sum() < 2:
        sel[:2] = True
    if sel.sum() > npoints - 1:
        sel[0] = False
    return points[sel], points[~sel]


def _ellipsoid_bootstrap_expand(multi, points, rseed):
    """Expansion factor from one bootstrap realization: fit on the
    sampled subset (one ellipsoid, or the recursive split when
    ``multi``), then the worst normalized distance of the left-out
    points, at least 1."""
    points_in, points_out = _bootstrap_points(points, rseed)
    ell = bounding_ellipsoid(points_in)
    if not multi:
        dists = ell.distance_many(points_out)
    else:
        ells = _bounding_ellipsoids(points_in, ell)
        dists = np.min([e.distance_many(points_out) for e in ells], axis=0)
    return max(1.0, float(np.max(dists)))


# --------------------------------------------------------------------------
# batched (breadth-first) recursive splitter: the algorithm of
# `_bounding_ellipsoids` (identical k-means seeding and accept tests) with
# every fit and k-means of a tree level batched into vectorized numpy calls


def _batched_fit(points_list):
    """Batched ``bounding_ellipsoid`` over a list of point arrays.

    Returns per-set dicts (ctr, cov, am, axes, evals, evecs, logvol), None
    where the fit failed.  The fast path is the scalar routine's
    no-repair branch; sets that need covariance repair take the scalar
    routine."""
    one_minus = 1.0 - 1e-3
    B = len(points_list)
    d = points_list[0].shape[1]
    nmax = max(len(p) for p in points_list)
    P = np.zeros((B, nmax, d))
    M = np.zeros((B, nmax), dtype=bool)
    for b, p in enumerate(points_list):
        P[b, :len(p)] = p
        M[b, :len(p)] = True
    n = M.sum(axis=1).astype(np.float64)
    ctr = P.sum(axis=1) / n[:, None]
    delta = (P - ctr[:, None, :]) * M[:, :, None]
    cov = (delta.transpose(0, 2, 1) @ delta) / n[:, None, None]
    out = [None] * B
    evals = None
    try:
        evals, evecs = np.linalg.eigh(cov)
    except np.linalg.LinAlgError:
        pass
    fast = np.zeros(B, dtype=bool)
    if evals is not None:
        finite = np.isfinite(evals).all(axis=1)
        vmax = np.where(finite, evals[:, -1], 1.0)
        vmin = np.where(finite, evals[:, 0], 0.0)
        fast = finite & (vmax > 0) & (vmin >= vmax / 1e12)
    idx_fast = np.nonzero(fast)[0]
    if len(idx_fast):
        ev = evals[idx_fast]
        eV = evecs[idx_fast]
        am = np.einsum("bij,bj,bkj->bik", eV, 1.0 / ev, eV)
        dlt = delta[idx_fast]
        f = ((dlt @ am) * dlt).sum(axis=2)
        fmax = f.max(axis=1)
        mult = np.where(fmax > one_minus, fmax / one_minus, 1.0)
        cov_s = cov[idx_fast] * mult[:, None, None]
        am = am / mult[:, None, None]
        ev = ev * mult[:, None]
        axes = eV * np.sqrt(ev)[:, None, :]
        lv = logvol_prefactor(d) + 0.5 * np.log(ev).sum(axis=1)
        for k, b in enumerate(idx_fast):
            out[b] = dict(ctr=ctr[b], cov=cov_s[k], am=am[k],
                          axes=axes[k], evals=ev[k], evecs=eV[k],
                          logvol=float(lv[k]))
    for b in np.nonzero(~fast)[0]:
        try:
            e = bounding_ellipsoid(points_list[b])
        except (np.linalg.LinAlgError, RuntimeError, ValueError):
            continue
        out[b] = dict(ctr=e.ctr, cov=e.cov, am=e.am, axes=e.axes,
                      evals=e.axlens ** 2,
                      evecs=e.axes / e.axlens[None, :],
                      logvol=float(e.logvol))
    return out


def _batched_kmeans2(P, M, ctrs0, niter=10):
    """Batched Lloyd's k-means, k=2, over padded point sets (P (B,n,d),
    mask M (B,n), start centres ctrs0 (B,2,d)).  Converged sets are
    stationary under further iterations, so batching keeps the scalar
    routine's early-exit labels."""
    ctrs = np.array(ctrs0, dtype=np.float64)
    labels = None
    # a point belongs to cluster 1 iff P.(c0-c1) < (|c0|^2-|c1|^2)/2
    for _ in range(niter):
        dc = ctrs[:, 0, :] - ctrs[:, 1, :]
        thresh = 0.5 * ((ctrs[:, 0, :] ** 2).sum(axis=1) -
                        (ctrs[:, 1, :] ** 2).sum(axis=1))
        proj = np.einsum("bnd,bd->bn", P, dc)
        new_labels = (proj < thresh[:, None]).astype(np.int64)
        if labels is not None and np.array_equal(new_labels, labels):
            break
        labels = new_labels
        w1 = (labels & M).astype(np.float64)
        w0 = (~labels.astype(bool) & M).astype(np.float64)
        c0 = w0.sum(axis=1)
        c1 = w1.sum(axis=1)
        s0 = np.einsum("bn,bnd->bd", w0, P)
        s1 = np.einsum("bn,bnd->bd", w1, P)
        ne0 = c0 > 0
        ne1 = c1 > 0
        ctrs[ne0, 0] = s0[ne0] / c0[ne0, None]
        ctrs[ne1, 1] = s1[ne1] / c1[ne1, None]
    return labels


class _SplitNode:
    __slots__ = ("pts", "ell", "scale", "children", "out")

    def __init__(self, pts, ell, scale):
        self.pts = pts
        self.ell = ell
        self.scale = scale
        self.children = None
        self.out = None


def _split_forest(points_list, root_fits):
    """Breadth-first batched `_bounding_ellipsoids` over a forest, one
    tree per (points, fitted root) pair.  Returns one list of ellipsoid
    dicts per root: the accepted decomposition."""
    d = points_list[0].shape[1]
    min_size = 2 * d
    nodes = []
    level = []
    for pts, fit in zip(points_list, root_fits):
        scale = pts.std(axis=0)[None, :]
        scale = np.where(scale > 0, scale, 1.0)
        node = _SplitNode(pts, fit, scale)
        nodes.append(node)
        level.append(node)
    while level:
        cand = [nd for nd in level if len(nd.pts) >= 2 * min_size]
        next_level = []
        if not cand:
            break
        nmax = max(len(nd.pts) for nd in cand)
        B = len(cand)
        P = np.zeros((B, nmax, d))
        M = np.zeros((B, nmax), dtype=bool)
        C0 = np.zeros((B, 2, d))
        for b, nd in enumerate(cand):
            P[b, :len(nd.pts)] = nd.pts / nd.scale
            M[b, :len(nd.pts)] = True
            i = int(np.argmax(nd.ell["evals"]))
            v = nd.ell["axes"][:, i]
            C0[b, 0] = (nd.ell["ctr"] - v) / nd.scale[0]
            C0[b, 1] = (nd.ell["ctr"] + v) / nd.scale[0]
        labels = _batched_kmeans2(P, M, C0)
        child_pts = []
        child_owner = []
        for b, nd in enumerate(cand):
            lab = labels[b, :len(nd.pts)]
            p0 = nd.pts[lab == 0]
            p1 = nd.pts[lab == 1]
            if min(len(p0), len(p1)) < min_size:
                continue
            child_pts.extend([p0, p1])
            child_owner.append(nd)
        if not child_pts:
            break
        fits = _batched_fit(child_pts)
        for j, nd in enumerate(child_owner):
            f0, f1 = fits[2 * j], fits[2 * j + 1]
            if f0 is None or f1 is None:
                continue  # a failed fit rejects the split
            c0 = _SplitNode(child_pts[2 * j], f0, nd.scale)
            c1 = _SplitNode(child_pts[2 * j + 1], f1, nd.scale)
            nd.children = (c0, c1)
            nodes.extend([c0, c1])
            next_level.extend([c0, c1])
        level = next_level
    # bottom-up accept: children come after their parents in `nodes`
    nparam = (d * (d + 3)) // 2
    for nd in reversed(nodes):
        if nd.children is None:
            nd.out = [nd.ell]
            continue
        c0, c1 = nd.children
        npoints = len(nd.pts)
        log_vol_dec = nparam * np.log(npoints) / npoints
        out_ells = c0.out + c1.out
        if (np.logaddexp(c0.ell["logvol"], c1.ell["logvol"]) -
                nd.ell["logvol"]) < -log_vol_dec:
            nd.out = out_ells
        elif (_logsumexp([e["logvol"] for e in out_ells]) -
                nd.ell["logvol"]) < -log_vol_dec * (len(out_ells) - 1):
            nd.out = out_ells
        else:
            nd.out = [nd.ell]
    return [nodes[k].out for k in range(len(points_list))]


def _fit_multi_batched(points, seeds=()):
    """The main multi-ellipsoid decomposition plus one bootstrap
    expansion factor per seed, as ONE batched breadth-first forest.
    Returns ``(ells, expands)``: a list of :class:`Ellipsoid` and the
    per-realization factors (empty without seeds)."""
    d = points.shape[1]
    pts_list = [points]
    outs = [None]
    for s in seeds:
        pin, pout = _bootstrap_points(points, s)
        pts_list.append(pin)
        outs.append(pout)
    root_fits = _batched_fit(pts_list)
    if root_fits[0] is None:
        # raise as the scalar routine does on an unfittable root
        bounding_ellipsoid(points)
        raise RuntimeError("Could not fit the root bounding ellipsoid.")
    keep = [k for k in range(len(pts_list)) if root_fits[k] is not None]
    forest = _split_forest([pts_list[k] for k in keep],
                           [root_fits[k] for k in keep])
    by_root = dict(zip(keep, forest))
    ells = [Ellipsoid(d, ctr=e["ctr"], cov=e["cov"], am=e["am"],
                      axes=e["axes"], eig=(e["evals"], e["evecs"]))
            for e in by_root[0]]
    expands = []
    for k in range(1, len(pts_list)):
        if k not in by_root:
            # an unfittable realization carries no information
            expands.append(1.0)
            continue
        pout = outs[k]
        dmin = None
        for e in by_root[k]:
            dd = pout - e["ctr"][None, :]
            dist = np.sqrt(np.einsum("ij,jk,ik->i", dd, e["am"], dd))
            dmin = dist if dmin is None else np.minimum(dmin, dist)
        expands.append(max(1.0, float(np.max(dmin))))
    return ells, expands


def _pairwise_dist(a, b, ftype):
    """Brute-force pairwise distances (n_a, n_b); p=2 for balls, p=inf
    for cubes."""
    delta = a[:, None, :] - b[None, :, :]
    if ftype == "balls":
        return np.sqrt((delta ** 2).sum(axis=2))
    if ftype == "cubes":
        return np.abs(delta).max(axis=2)
    raise ValueError(f"Unknown friends type {ftype}")


def _friends_bootstrap_radius(points, ftype, rseed):
    """Kernel radius from one bootstrap: the largest distance from a
    left-out point to its nearest selected point (host, float64)."""
    points_in, points_out = _bootstrap_points(points, rseed)
    return float(_pairwise_dist(points_out, points_in, ftype)
                 .min(axis=1).max())


def _ellipsoid_expand_task(args):
    """:func:`_ellipsoid_bootstrap_expand` as a pool task: ``args`` is
    ``(multi, points, rseed)``; returns ``(expand, pid)``."""
    return _ellipsoid_bootstrap_expand(*args), os.getpid()


def _friends_radius_task(args):
    """:func:`_friends_bootstrap_radius` as a pool task (numpy only, on
    the host): ``args`` is ``(points, ftype, rseed)``; returns ``(radius,
    pid)``."""
    return _friends_bootstrap_radius(*args), os.getpid()


def _mapped_bootstrap(bound, pool, task, args):
    """Map ``task`` over ``args`` (over ``pool`` when given), record the
    processes that ran it on ``bound``, and return the largest result."""
    out = list(map(task, args) if pool is None else pool.map(task, args))
    bound.last_bootstrap_pids = [pid for _, pid in out]
    return max(r for r, _ in out)


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
    """Resolve a bound name or a Bound instance to the instance a sampler
    refits; ``device`` is where friends bounds take their NN distances.
    An instance is a template: each sampler gets its own deep copy of it,
    so that no sampler's refit moves another's bound (nor the caller's
    object)."""
    if isinstance(bound, Bound):
        bound = copy.deepcopy(bound)
        if isinstance(bound, _FriendsBase) and device is not None:
            bound.device = device
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
        return MultiEllipsoid(ndim)
    raise ValueError(f"Unknown bound option '{bound}'")
