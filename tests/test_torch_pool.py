"""The port's process pool (``dynesty_tpu_torch.pool``) and the ``use_pool``
flags, held to the JAX package's gates (``tests/test_use_pool.py``,
``tests/test_interface.py::test_pool_shim``) and to the port's own: the
pooled bootstrap fits equal the unpooled ones, a worker never initialises
CUDA, and a pooled run resumes bit for bit with the pool re-attached.

One spawn pool of two workers serves the whole file.  Its cached
functions are ``loglike_plain`` / ``ptform`` (``pool.loglike``,
``pool.prior_transform``); the runs that record the evaluating process
hand ``loglike_pid`` itself to the sampler, which maps it over the same
workers by reference.
"""

import os
import pickle
import time
import warnings

import numpy as np
import pytest
import torch

import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.bounding import MultiEllipsoid, RadFriends
from dynesty_tpu_torch.pool import Pool

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 2
LNORM = -0.5 * np.log(2 * np.pi) * NDIM


def loglike_pid(x):
    """Gaussian logl whose blob records the evaluating process."""
    return -0.5 * np.dot(x, x) + LNORM, np.float64(os.getpid())


def loglike_plain(x):
    return -0.5 * np.dot(x, x) + LNORM


def ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def torch_loglike(x):
    return -0.5 * (x @ x) + LNORM


def worker_state(_):
    """Whether this process has initialised CUDA, and its PID."""
    time.sleep(0.01)
    return torch.cuda.is_initialized(), os.getpid()


@pytest.fixture(scope="module")
def pool():
    with Pool(2, loglike_plain, ptform) as p:
        yield p


class CountingPool:
    """A pool that records the function of every map it is given."""

    def __init__(self, pool):
        self.pool, self.njobs, self.mapped = pool, pool.njobs, []

    def map(self, fn, items):
        # a wrapped user function by its site, any other by its name
        self.mapped.append(getattr(fn, "name", None) or fn.__name__)
        return self.pool.map(fn, items)


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


def _host(loglike, pool, **kw):
    kw = dict(dict(nlive=60, bound="single", sample="unif",
                   rstate=get_rstate(), likelihood_mode="host", pool=pool,
                   queue_size=16, device="cpu"), **kw)
    return dyt.NestedSampler(loglike, ptform, NDIM, **kw)


def test_pool_pid_distinct(pool):
    """Evaluations run in the two workers, none in the parent."""
    samp = _host(loglike_pid, pool, blob=True)
    _quiet(samp.run_nested, print_progress=False, maxiter=200,
           add_live=False)
    pids = np.unique(np.asarray(samp.results.blob, dtype=np.int64))
    assert len(pids) >= 2, pids
    assert os.getpid() not in pids
    assert os.getpid() not in samp.live_blobs.astype(np.int64)


def test_workers_never_initialise_cuda(pool):
    _quiet(_host(pool.loglike, pool).run_nested, print_progress=False,
           maxiter=50, add_live=False)
    state = pool.map(worker_state, range(16))
    assert not any(init for init, _ in state)
    assert os.getpid() not in {pid for _, pid in state}


def test_bootstrap_update_bound_in_pool(pool):
    """The bootstrap realisations of a refit run in the workers when
    ``use_pool['update_bound']`` (the default), in the parent when off."""
    first = {"min_ncall": 80, "min_eff": 100.0}  # force an early refit
    for flag, in_workers in ((True, True), (False, False)):
        samp = _host(pool.loglike, pool, bootstrap=3, first_update=first,
                     use_pool={"update_bound": flag})
        _quiet(samp.run_nested, print_progress=False, maxiter=150,
               add_live=False)
        pids = getattr(samp.bound, "last_bootstrap_pids", None)
        assert pids, "bootstrap expansion never ran"
        assert all((p != os.getpid()) == in_workers for p in pids), pids


@pytest.mark.parametrize("flag", ["prior_transform", "loglikelihood",
                                  "propose_point", "update_bound",
                                  "stop_function"])
def test_use_pool_flag_toggles(pool, flag):
    """Each flag, switched off alone, still runs end to end, and the site
    it names is no longer mapped over the pool (a static host-mode run has
    no site of its own for ``propose_point`` and ``stop_function``)."""
    counting = CountingPool(pool)
    samp = _host(pool.loglike, counting, use_pool={flag: False},
                 bootstrap=3, first_update={"min_ncall": 80,
                                            "min_eff": 100.0})
    _quiet(samp.run_nested, print_progress=False, maxiter=150,
           add_live=False)
    assert samp.it > 1 and samp.use_pool[flag] is False
    sites = {"prior_transform": "prior_transform",
             "loglikelihood": "loglikelihood",
             "update_bound": "_ellipsoid_expand_task"}
    for f, site in sites.items():
        assert (site in counting.mapped) == (f != flag), (site, flag)


def test_use_pool_unknown_key():
    with pytest.raises(ValueError, match="use_pool"):
        dyt.NestedSampler(loglike_plain, ptform, NDIM, nlive=60,
                          rstate=get_rstate(), likelihood_mode="host",
                          use_pool={"bogus_site": True}, device="cpu")


def test_use_pool_accepted_without_pool():
    samp = _host(loglike_plain, None, use_pool={"loglikelihood": True})
    _quiet(samp.run_nested, print_progress=False, maxiter=100,
           add_live=False)
    assert samp.it > 1


def test_n_mc_stopping_over_pool(pool):
    """The dynamic driver's Monte Carlo stopping realisations map over the
    pool when ``use_pool['stop_function']``."""
    counting = CountingPool(pool)
    dns = dyt.DynamicNestedSampler(torch_loglike, ptform, NDIM,
                                   bound="single", sample="unif",
                                   rstate=get_rstate(), pool=counting,
                                   queue_size=32, device="cpu")
    _quiet(dns.run_nested, nlive_init=80, nlive_batch=40, maxbatch=2,
           print_progress=False, use_stop=True, n_effective=2000,
           stop_kwargs={"n_mc": 10, "error": "jitter"})
    assert np.isfinite(dns.results.logz[-1])
    assert dns.batch >= 1
    assert "_kld_error" in counting.mapped


def test_pool_shim(pool):
    """``dynesty.pool.Pool``-style use: the pool's cached functions, host
    mode, the pool handed to the sampler."""
    sampler = dyt.NestedSampler(pool.loglike, pool.prior_transform, 2,
                                nlive=100, bound="single", sample="unif",
                                likelihood_mode="host", pool=pool,
                                rstate=get_rstate(), queue_size=16,
                                device="cpu")
    _quiet(sampler.run_nested, print_progress=False, maxiter=200)
    assert np.isfinite(sampler.results.logz[-1])


def test_host_width_rule(pool):
    """Host mode over a pool: a round is max(32, min(nlive, 8 * workers))
    wide; without a pool, or in torch mode, the default width."""
    class Eight:
        njobs = 8

        def map(self, fn, items):
            return list(map(fn, items))

    assert _host(pool.loglike, pool, nlive=500,
                 queue_size=None).queue_size == 32
    assert _host(loglike_plain, Eight(), nlive=500,
                 queue_size=None).queue_size == 64
    assert _host(loglike_plain, None, nlive=500, queue_size=None
                 ).queue_size == dyt.NestedSampler(
        torch_loglike, ptform, NDIM, nlive=500, device="cpu").queue_size


def _clouds(n=400):
    rng = np.random.Generator(np.random.PCG64(7))
    return np.concatenate([rng.normal(0.3, 0.03, (n // 2, NDIM)),
                           rng.normal(0.7, 0.03, (n // 2, NDIM))])


def test_pooled_multiellipsoid_fit_equals_batched(pool):
    """The pooled branch (recursive splitter, realisations in the
    workers) and the batched forest fit the same ellipsoids and the same
    expansion for the same points and seeds: the same split labels, so the
    same centres bit for bit; covariances and expansion summed in another
    order (1e-12 relative), as in the JAX package."""
    pts = _clouds()
    fits = []
    for p in (None, pool):
        m = MultiEllipsoid(ndim=NDIM)
        m.update(pts, rstate=get_rstate(), bootstrap=4, pool=p)
        fits.append(m)
    a, b = fits
    assert a.nells == b.nells >= 2
    assert np.array_equal(a.ctrs, b.ctrs)
    for k in ("covs", "logvol_ells", "last_expand", "logvol"):
        assert np.allclose(getattr(a, k), getattr(b, k), rtol=1e-12,
                           atol=0), k
    assert a.last_expand > 1.0
    assert set(a.last_bootstrap_pids) == {os.getpid()}
    assert os.getpid() not in b.last_bootstrap_pids


def test_friends_bootstrap_radius_in_the_workers(pool):
    pts = _clouds(200)
    fits = []
    for p in (None, pool):
        f = RadFriends(NDIM, device="cpu")
        f.update(pts, rstate=get_rstate(), bootstrap=3, pool=p)
        fits.append(f)
    assert np.array_equal(fits[0].cov, fits[1].cov)
    assert os.getpid() not in fits[1].last_bootstrap_pids


def test_pooled_dynamic_run_resumes_exactly(pool, tmp_path):
    """A host-mode dynamic run over the pool, stopped inside its first
    batch, saved, restored with ``pool=`` and resumed, equals the
    uninterrupted run bit for bit; the pool is re-attached everywhere."""
    kw = dict(bound="single", sample="rslice", likelihood_mode="host",
              pool=pool, queue_size=16, device="cpu")
    run_kw = dict(nlive_init=60, nlive_batch=40, maxbatch=1,
                  print_progress=False)

    def make():
        return dyt.DynamicNestedSampler(pool.loglike, pool.prior_transform,
                                        NDIM, rstate=get_rstate(), **kw)

    full = make()
    _quiet(full.run_nested, **run_kw)
    d = make()
    _quiet(d.run_nested, **dict(run_kw, maxbatch=0))
    _quiet(d.add_batch, nlive=40, maxiter=40 + 30, print_progress=False)
    assert d.batch_sampler is not None
    fname = str(tmp_path / "pooled.pkl")
    d.save(fname)
    state = pickle.load(open(fname, "rb"))["sampler"]
    assert state.pool is None and state.loglikelihood.pool is None
    d2 = dyt.DynamicNestedSampler.restore(fname, pool=pool)
    for obj in (d2, d2.sampler, d2.batch_sampler, d2.loglikelihood):
        assert obj.pool is pool
    assert d2.mapper == pool.map
    _quiet(d2.run_nested, resume=True, **run_kw)
    a, b = d2.results, full.results
    assert d2.ncall == full.ncall and d2.batch == full.batch == 1
    for k in ("logl", "logz", "samples", "samples_u", "samples_batch",
              "ncall", "batch_nlive"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    # restored without a pool, the same state runs in the parent
    d3 = dyt.DynamicNestedSampler.restore(fname)
    assert d3.pool is None and d3.loglikelihood.pool is None
    assert d3.mapper is map
