"""A user's own ``Bound`` and the bounds' host methods, on the port against
the JAX package, on the CPU.

Tolerances.  The host methods (``sample``, ``samples``, ``within``,
``overlap``, the Monte Carlo volumes and ``funit``) are the same numpy code
on the same ``rstate`` in both packages: for the same fitted bound and
seed they give the same bits (``np.array_equal``, ``==``).  A run's device
rounds draw from torch Philox in the port and JAX threefry in the JAX
package, so whole runs are held to the analytic evidence (5 logzerr, as
the JAX package's ``test_custom_bound``) and to the JAX run of the same
configuration: niter within 10 %, logz within 3 combined errors, and for a
dynamic run the same number of batches.  Resume is exact: ``np.array_equal``
or ``==``.
"""

import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import kstest

import dynesty_tpu as dytpu
import dynesty_tpu.bounding as jb
import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.bounding as tb
from dynesty_tpu_torch.utils.convert import bound_from_arrays

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
SEED = 56432
LOGZ_TRUTH = NDIM * (-np.log(20.0))

# module-level (picklable) problem
_COV = np.identity(NDIM)
_COV[_COV == 0] = 0.95
_CINV_NP = np.linalg.inv(_COV)
_CINV = torch.as_tensor(_CINV_NP)
_LNORM = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(_COV)))


def gau_loglike(x):
    return -0.5 * (x @ _CINV @ x) + _LNORM


def gau_loglike_jax(x):
    return -0.5 * jnp.dot(x, jnp.asarray(_CINV_NP) @ x) + _LNORM


def gau_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


class _BoxMethods:
    """An axis-aligned box around the live points (the JAX package's test
    bound, ``tests/test_interface.py``), written once for both packages'
    ``Bound``."""

    def __init__(self, ndim):
        super().__init__(ndim)
        self.cen = np.zeros(ndim) + 0.5
        self.size = 0.5

    def contains(self, x):
        return bool((np.abs(x - self.cen) < self.size).all())

    def sample(self, rstate=None):
        return rstate.uniform(np.maximum(self.cen - self.size, 0),
                              np.minimum(self.cen + self.size, 1))

    def samples(self, nsamples, rstate=None):
        lo = np.maximum(self.cen - self.size, 0)
        hi = np.minimum(self.cen + self.size, 1)
        return rstate.uniform(lo, hi, size=(nsamples, self.ndim))

    def get_random_axes(self, rstate):
        return np.eye(self.ndim) * self.size

    def scale_to_logvol(self, logvol):
        self.size = np.exp(logvol / self.ndim)

    def update(self, points, rstate=None, bootstrap=0, pool=None):
        self.cen = points.mean(axis=0)
        self.size = np.abs(points - self.cen).max() * 2
        self.logvol = np.log(self.size) * self.ndim


class Box(_BoxMethods, tb.Bound):
    """The box on the port's ``Bound``."""


class JBox(_BoxMethods, jb.Bound):
    """The box on the JAX package's ``Bound``."""


class JitterBox(Box):
    """The box whose proposal axes take a draw from the host stream, so
    that a run's host draws sit inside its dispatches."""

    def get_random_axes(self, rstate):
        return np.eye(self.ndim) * self.size * rstate.uniform(0.8, 1.2)


class WideBox(Box):
    """The box whose ``samples`` return float64 points partly outside the
    unit cube, and over every one of its ``ndim`` dimensions where the
    sampler bounds fewer (``ncdim``)."""

    def samples(self, nsamples, rstate=None):
        lo, hi = self.cen - self.size, self.cen + self.size
        box = rstate.uniform(lo, hi, size=(nsamples, len(lo)))
        rest = rstate.random((nsamples, self.ndim - len(lo)))
        return np.concatenate([box, rest], axis=1)


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def _port(bound, sample, nlive=250, **kw):
    return dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=nlive,
                             bound=bound, sample=sample, queue_size=64,
                             rstate=get_rstate(SEED), device="cpu", **kw)


def _jax(bound, sample, nlive=250, **kw):
    return dytpu.NestedSampler(gau_loglike_jax, gau_ptform, NDIM,
                               nlive=nlive, bound=bound, sample=sample,
                               queue_size=64, rstate=get_rstate(SEED), **kw)


def _close(a, b, logzerr_a, logzerr_b, niter_a, niter_b):
    assert abs(niter_a - niter_b) <= 0.1 * niter_b, (niter_a, niter_b)
    sig = np.hypot(logzerr_a, logzerr_b)
    assert abs(a - b) < 3 * sig, (a, b, sig)


# --------------------------------------------------------------------------
# whole runs


@pytest.mark.parametrize("sample", ["unif", "rwalk", "rslice", "slice"])
def test_custom_bound(sample):
    s = _port(Box(NDIM), sample)
    _quiet(s.run_nested, print_progress=False)
    res = s.results
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 5 * res.logzerr[-1]
    # the run went through the custom kind and the user's draws
    assert s.device_bound_kind() == "custom"
    assert isinstance(s.bound, Box) and s.bound.size < 0.5
    assert int(np.sum(res.ncall)) == s.ncall
    j = _jax(JBox(NDIM), sample)
    _quiet(j.run_nested, print_progress=False)
    jres = j.results
    _close(res.logz[-1], jres.logz[-1], res.logzerr[-1], jres.logzerr[-1],
           res.niter, jres.niter)


def test_bound_instances():
    # pre-built bound instances work like the names
    for bound in (tb.UnitCube(NDIM), tb.Ellipsoid(NDIM),
                  tb.MultiEllipsoid(NDIM)):
        s = dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=150,
                              bound=bound, sample="rwalk", queue_size=32,
                              rstate=get_rstate(), device="cpu")
        _quiet(s.run_nested, print_progress=False, maxiter=300)
        assert np.isfinite(s.results.logz[-1])
        assert type(s.bound_next) is type(bound)
        assert s.bound_next is not bound


def test_custom_unif_takes_the_bounded_columns_of_any_draw():
    # draws over every dimension, partly outside the cube: the wave takes
    # the first ncdim columns as the sampler's tensors, and the cube check
    # drops the points outside
    s = _port(WideBox(NDIM), "unif", nlive=100, ncdim=2)
    _quiet(s.run_nested, print_progress=False, maxiter=600)
    res = s.results
    assert s.device_bound_kind() == "custom"
    u = res.samples_u
    assert u.dtype == np.float64 and np.all((u > 0) & (u < 1))
    assert np.all(np.isfinite(res.logz))


def test_dynamic_custom_bound_rwalk():
    kw = dict(nlive_init=100, nlive_batch=60, maxbatch=2,
              n_effective=1500, print_progress=False)
    d = dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM,
                                 bound=Box(NDIM), sample="rwalk",
                                 queue_size=32, rstate=get_rstate(SEED),
                                 device="cpu")
    _quiet(d.run_nested, **kw)
    j = dytpu.DynamicNestedSampler(gau_loglike_jax, gau_ptform, NDIM,
                                   bound=JBox(NDIM), sample="rwalk",
                                   queue_size=32, rstate=get_rstate(SEED))
    _quiet(j.run_nested, **kw)
    res, jres = d.results, j.results
    assert d.batch == j.batch >= 1
    assert len(res.batch_nlive) == len(jres.batch_nlive)
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 5 * res.logzerr[-1]
    _close(res.logz[-1], jres.logz[-1], res.logzerr[-1], jres.logzerr[-1],
           res.niter, jres.niter)


def test_dynamic_unif_custom_bound_refused_as_in_jax():
    # a batch is seeded through the non-fused round, which neither package
    # draws from a host-sampled bound: the first batch raises
    kw = dict(nlive_init=60, maxiter_init=500, nlive_batch=40, maxbatch=1,
              print_progress=False)
    d = dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM,
                                 bound=Box(NDIM), sample="unif",
                                 queue_size=32, rstate=get_rstate(SEED),
                                 device="cpu")
    with pytest.raises(RuntimeError, match="no device sampling spec"):
        _quiet(d.run_nested, **kw)
    j = dytpu.DynamicNestedSampler(gau_loglike_jax, gau_ptform, NDIM,
                                   bound=JBox(NDIM), sample="unif",
                                   queue_size=32, rstate=get_rstate(SEED))
    with pytest.raises(RuntimeError, match="no device sampling spec"):
        _quiet(j.run_nested, **kw)


def test_each_sampler_refits_its_own_copy_of_a_user_bound():
    """The decision on sharing: the JAX package hands the caller's object
    to the static sampler, the dynamic base run and every batch, so each
    refit moves one shared object; the port gives every sampler its own
    deep copy of it, as it gives each a fresh proposal kernel."""
    user = Box(NDIM)
    s = _port(user, "rwalk", nlive=100)
    _quiet(s.run_nested, print_progress=False, maxiter=400)
    assert s.bounding is user and s.bound is not user
    assert s.nbound > 1 and not np.array_equal(s.bound.cen, user.cen)
    assert user.size == 0.5 and np.all(user.cen == 0.5)
    d = dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM, bound=user,
                                 sample="rwalk", queue_size=32,
                                 rstate=get_rstate(SEED), device="cpu")
    _quiet(d.run_nested, nlive_init=100, maxbatch=0, print_progress=False)
    base = d.sampler.bound
    fitted = (base.cen.copy(), base.size)
    _quiet(d.add_batch, nlive=60, maxiter=100, print_progress=False)
    batch = d.batch_sampler.bound
    assert len({id(user), id(base), id(batch)}) == 3
    # the batch refitted its own copy; the base run's bound is as it was
    assert np.array_equal(base.cen, fitted[0]) and base.size == fitted[1]
    assert batch.size != base.size and user.size == 0.5


# --------------------------------------------------------------------------
# resume


@pytest.mark.parametrize("sample,bound", [("unif", Box), ("rslice",
                                                         JitterBox)])
def test_custom_bound_resume_is_exact(tmp_path, sample, bound):
    full = _port(bound(NDIM), sample, nlive=100)
    _quiet(full.run_nested, print_progress=False)
    part = _port(bound(NDIM), sample, nlive=100)
    _quiet(part.run_nested, print_progress=False, maxiter=full.results.niter
           // 2, add_live=False)
    assert part.interrupted_budget
    fname = str(tmp_path / "custom.pkl")
    part.save(fname)
    restored = dyt.NestedSampler.restore(fname, device="cpu")
    assert isinstance(restored.bound, bound)
    _quiet(restored.run_nested, resume=True, print_progress=False)
    a, b = full.results, restored.results
    for k in ("logl", "logz", "logzerr", "logvol", "logwt", "samples",
              "samples_u", "samples_it", "samples_id", "samples_n",
              "samples_birth", "ncall", "scale"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert a.niter == b.niter and full.ncall == restored.ncall
    assert restored.timings.get("n_replay", 0) >= 1
    boxes = [(x.cen, x.size) for x in a.bound[1:]]
    assert len(boxes) == len(b.bound) - 1
    for (c0, s0), x in zip(boxes, b.bound[1:]):
        assert np.array_equal(c0, x.cen) and s0 == x.size
    if sample == "rslice":
        # the stop fell inside a chained dispatch: its remaining rounds ran
        # with the axes the dispatch drew
        assert restored.timings.get("n_continuation", 0) >= 1


# --------------------------------------------------------------------------
# the host methods of the built-in bounds, bit for bit


def _pts(n=300):
    rs = get_rstate(7)
    a = 0.3 + 0.04 * rs.standard_normal((n // 2, NDIM))
    b = 0.65 + 0.05 * rs.standard_normal((n - n // 2, NDIM))
    return np.vstack([a, b])


def _pair(name):
    """The same bound fitted to the same points in both packages."""
    pts = _pts()
    if name == "friends_balls":
        j, t = jb.RadFriends(NDIM), tb.RadFriends(NDIM, device="cpu")
    elif name == "friends_cubes":
        j, t = jb.SupFriends(NDIM), tb.SupFriends(NDIM, device="cpu")
    elif name == "single":
        j, t = jb.Ellipsoid(NDIM), tb.Ellipsoid(NDIM)
    elif name == "multi":
        j, t = jb.MultiEllipsoid(NDIM), tb.MultiEllipsoid(NDIM)
    else:
        return jb.UnitCube(NDIM), tb.UnitCube(NDIM)
    j.update(pts, rstate=get_rstate(3), bootstrap=0)
    t.update(pts, rstate=get_rstate(3), bootstrap=0)
    return j, t


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)


@pytest.mark.parametrize("name", ["none", "single", "multi",
                                  "friends_balls", "friends_cubes"])
def test_host_methods_bit_identical_to_jax(name):
    j, t = _pair(name)
    _same(j.sample(rstate=get_rstate(11)), t.sample(rstate=get_rstate(11)))
    _same(j.samples(400, rstate=get_rstate(12)),
          t.samples(400, rstate=get_rstate(12)))
    x = _pts()[5]
    if name == "multi":
        assert j.nells == t.nells >= 2
        _same(j.within(x), t.within(x))
        _same(j.within(x, j=0), t.within(x, j=0))
        assert j.overlap(x) == t.overlap(x)
        _same(j.sample(rstate=get_rstate(13), return_q=True),
              t.sample(rstate=get_rstate(13), return_q=True))
        _same(j.major_axis_endpoints(), t.major_axis_endpoints())
    if name.startswith("friends"):
        _same(j.within(x), t.within(x))
        assert j.overlap(x) == t.overlap(x) >= 1
        _same(j.sample(rstate=get_rstate(13), return_q=True),
              t.sample(rstate=get_rstate(13), return_q=True))
        _same(j._offset(get_rstate(14)), t._offset(get_rstate(14)))
    if name in ("multi",) or name.startswith("friends"):
        _same(j.monte_carlo_logvol(2000, rstate=get_rstate(15)),
              t.monte_carlo_logvol(2000, rstate=get_rstate(15)))
        assert j.monte_carlo_logvol(500, rstate=get_rstate(16),
                                    return_overlap=False) == \
            t.monte_carlo_logvol(500, rstate=get_rstate(16),
                                 return_overlap=False)
    if name == "single":
        assert j.unitcube_overlap(3000, rstate=get_rstate(17)) == \
            t.unitcube_overlap(3000, rstate=get_rstate(17))
    if name != "none":
        # update(mc_integrate=True): the refit's funit (and the Monte Carlo
        # logvol of a multi-ellipsoid bound)
        j.update(_pts(), rstate=get_rstate(18), bootstrap=0,
                 mc_integrate=True)
        t.update(_pts(), rstate=get_rstate(18), bootstrap=0,
                 mc_integrate=True)
        assert j.funit == t.funit and 0 < t.funit <= 1 + 1e-12
        assert j.logvol == t.logvol


def test_friends_update_without_clustering_matches_jax():
    # a second refit, under the first fit's kernel, sees the two clusters:
    # with use_clustering=False it takes the plain covariance instead
    pts = _pts()
    for jcls, tcls in ((jb.RadFriends, tb.RadFriends),
                       (jb.SupFriends, tb.SupFriends)):
        j, t, c = jcls(NDIM), tcls(NDIM, device="cpu"), \
            tcls(NDIM, device="cpu")
        for b in (j, t, c):
            b.update(pts, rstate=get_rstate())
        j.update(pts, rstate=get_rstate(), use_clustering=False)
        t.update(pts, rstate=get_rstate(), use_clustering=False)
        c.update(pts, rstate=get_rstate())
        for k in ("cov", "am", "axes", "axes_inv", "ctrs"):
            assert np.array_equal(getattr(j, k), getattr(t, k)), k
        assert j.logvol == t.logvol
        assert not np.allclose(c.cov, t.cov)


# --------------------------------------------------------------------------
# tests/test_ellipsoid.py re-stated on the port


def test_ellipsoid_sampling_uniform():
    rstate = get_rstate()
    ndim = 3
    cov = np.array([[1.0, 0.6, 0.0], [0.6, 1.0, 0.0], [0.0, 0.0, 0.25]])
    ell = tb.Ellipsoid(ndim, ctr=np.zeros(ndim), cov=cov)
    xs = ell.samples(20000, rstate=rstate)
    d = ell.distance_many(xs)
    assert d.max() <= 1 + 1e-9
    # the radial CDF of the Mahalanobis distance^ndim is uniform
    assert kstest(d ** ndim, "uniform").pvalue > 1e-4
    assert abs(ell.logvol - (tb.logvol_prefactor(ndim) +
                             0.5 * np.linalg.slogdet(cov)[1])) < 1e-10


def test_multiellipsoid_overlap_and_volume():
    rstate = get_rstate()
    r, sep = 1.0, 1.0  # centres 1 apart, radius 1: a known union
    ells = [tb.Ellipsoid(2, ctr=np.array([0.0, 0.0]), cov=np.eye(2) * r),
            tb.Ellipsoid(2, ctr=np.array([sep, 0.0]), cov=np.eye(2) * r)]
    mell = tb.MultiEllipsoid(2, ells=ells)
    assert mell.overlap(np.array([0.5, 0.0])) == 2
    assert mell.overlap(np.array([-0.9, 0.0])) == 1
    assert not mell.contains(np.array([3.0, 3.0]))
    logvol_mc = mell.monte_carlo_logvol(ndraws=20000, rstate=rstate,
                                        return_overlap=False)
    lens = 2 * r * np.arccos(sep / (2 * np.sqrt(r))) - \
        sep / 2 * np.sqrt(4 * r - sep ** 2)
    assert abs(np.exp(logvol_mc) - (2 * np.pi * r - lens)) < 0.15


def test_multiellipsoid_sampling_uniform():
    rstate = get_rstate()
    ells = [tb.Ellipsoid(2, ctr=np.array([0.0, 0.0]), cov=np.eye(2)),
            tb.Ellipsoid(2, ctr=np.array([1.0, 0.0]), cov=np.eye(2))]
    xs = tb.MultiEllipsoid(2, ells=ells).samples(5000, rstate=rstate)
    # uniform over the union: the halves about the symmetry axis x = 0.5
    left, right = np.sum(xs[:, 0] < 0.5), np.sum(xs[:, 0] > 0.5)
    assert abs(left - right) < 5 * np.sqrt(len(xs))


def test_friends_bounds():
    rstate = get_rstate()
    pts = rstate.normal(size=(100, 2)) * 0.05 + 0.5
    for cls in (tb.RadFriends, tb.SupFriends):
        fb = cls(2, device="cpu")
        fb.update(pts, rstate=rstate)
        fb.ctrs = pts
        assert all(fb.contains(p) for p in pts)
        xs = fb.samples(500, rstate=rstate)
        assert xs.shape == (500, 2)
        assert np.abs(xs - 0.5).max() < 0.5


# --------------------------------------------------------------------------
# state carried between the packages


def test_convert_refuses_a_jax_custom_bound():
    j = dytpu.NestedSampler(gau_loglike_jax, gau_ptform, NDIM, nlive=50,
                            bound=JBox(NDIM), sample="rwalk",
                            rstate=get_rstate(SEED))
    j.unit_cube_sampling = False
    j.bound = j.bound_next
    kind = j.device_bound_kind()
    assert kind == "custom"
    with pytest.raises(ValueError, match="custom bound"):
        bound_from_arrays(kind, NDIM, {})
    # the port's own box pickles with a sampler and comes back as itself
    s = _port(Box(NDIM), "rwalk", nlive=50)
    back = pickle.loads(pickle.dumps(s))
    assert isinstance(back.bound_next, Box) and back.bound_next.size == 0.5
