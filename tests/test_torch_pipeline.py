"""Planning ahead of the deferred refit (the JAX package's pipelined
pre-launch, ``dynesty_tpu/sampler.py``) in the port, on the CPU.

Over an ellipsoid bound with a torch likelihood, a dispatch that is over
plans the next one on its own bound (the seed drawn first), and only then
runs the refit trigger; the planned spec keeps a copy of that bound where
the refit moved it, and is launched at the loop top.  Held here: the
capability rule against the JAX package's, the records' ``bound_iter``
against the JAX package's rule, bit-exact resume with a planned spec in the
checkpoint (static and inside a dynamic batch, a stop by ``maxiter`` or by
``maxcall`` exactly at a boundary where a refit is due), repeatability, no
stranded work, and runs that do not plan ahead left as they were.

Tolerance: none.  Every comparison is ``np.array_equal`` or ``==``.
"""

import copy
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynesty_tpu as dytpu
import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.bounding import Bound
from dynesty_tpu_torch.sampler import Sampler

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
_COV = np.identity(NDIM)
_COV[_COV == 0] = 0.95
_CINV = np.linalg.inv(_COV)
_TCINV = torch.as_tensor(_CINV)
_LNORM = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(_COV)))


def loglike(x):
    return -0.5 * (x @ _TCINV @ x) + _LNORM


def np_loglike(x):
    return -0.5 * (x @ _CINV @ x) + _LNORM


def jax_loglike(x):
    return -0.5 * jnp.dot(x, jnp.asarray(_CINV) @ x) + _LNORM


def ptform(u):
    return 10.0 * (2.0 * u - 1.0)


class Box(Bound):
    """A user's bound without a device export: the unit cube."""

    def __init__(self, ndim):
        self.ndim = ndim
        self.logvol = 0.0

    def contains(self, x):
        return bool(np.all((x >= 0) & (x <= 1)))

    def samples(self, n, rstate):
        return rstate.uniform(size=(n, self.ndim))

    def get_random_axes(self, rstate):
        return np.eye(self.ndim)

    def scale_to_logvol(self, logvol):
        self.logvol = logvol

    def update(self, points, rstate=None, bootstrap=0, pool=None):
        pass


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def _sampler(bound="single", sample="unif", **kw):
    kw = dict(dict(nlive=100, queue_size=32, rstate=get_rstate()), **kw)
    return dyt.NestedSampler(kw.pop("loglike", loglike), ptform, NDIM,
                             bound=bound, sample=sample, device="cpu", **kw)


RUN_KEYS = ("logl", "logvol", "logwt", "logz", "samples", "samples_u",
            "samples_it", "samples_id", "samples_n", "samples_birth",
            "ncall", "bound_iter", "samples_bound", "scale")


def _assert_same(a, b):
    ra, rb = a.results, b.results
    assert ra.niter == rb.niter and a.ncall == b.ncall
    assert a.it == b.it and a.nbound == b.nbound
    for k in RUN_KEYS:
        assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])), k


class _Planned:
    """Records each plan made ahead of a refit: the records so far, the
    loop's calls so far and whether the spec kept a copy of its bound."""

    def __init__(self, monkeypatch):
        self.plans = []
        plan = Sampler._plan_ahead

        def spy(s, *a):
            plan(s, *a)
            self.plans.append(dict(it=s.it - 1, ncall=s.ncall,
                                   snap="bound_used" in s._next_spec))
        monkeypatch.setattr(Sampler, "_plan_ahead", spy)

    def refit_boundary(self, nth=1):
        """The ``nth`` boundary whose planned spec kept its bound."""
        return [p for p in self.plans if p["snap"]][nth]


# --------------------------------------------------------------------------
# the capability rule


@pytest.mark.parametrize("bound, sample, kw", [
    ("single", "unif", {}), ("multi", "rwalk", {}), ("multi", "rslice", {}),
    ("balls", "rslice", {}), ("cubes", "unif", {}), ("none", "rslice", {}),
    ("single", "unif", {"likelihood_mode": "host"})])
def test_capability_rule_is_the_jax_packages(bound, sample, kw):
    """Both packages' ``_pipeline_capable`` on the same configuration: no
    plan in the unit-cube phase; after it, ellipsoids with a traced
    likelihood only."""
    host = kw.get("likelihood_mode") == "host"
    t = _sampler(bound, sample, loglike=np_loglike if host else loglike,
                 **kw)
    j = dytpu.NestedSampler(np_loglike if host else jax_loglike, ptform,
                            NDIM, nlive=100, bound=bound, sample=sample,
                            queue_size=32, rstate=get_rstate(), **kw)
    for s in (t, j):
        assert not s._pipeline_capable()  # the unit-cube phase
        s.unit_cube_sampling = False
        s.bound = s.bound_next
        s.internal_sampler = s.internal_sampler_next
    assert t.device_bound_kind() == j.device_bound_kind()
    assert t._pipeline_capable() == j._pipeline_capable()
    assert t._pipeline_capable() == (
        bound in ("single", "multi") and not host)


def test_a_custom_bound_plans_nothing():
    s = _sampler(Box(NDIM), "rslice")
    s.unit_cube_sampling = False
    s.bound = s.bound_next
    assert s.device_bound_kind() == "custom"
    assert not s._pipeline_capable()


# --------------------------------------------------------------------------
# the records against the JAX package's rule


def _dispatch_blocks(s):
    for block in s.sample(dlogz=0.01, per_dispatch=True):
        if block.n:
            bi = np.asarray(s.saved_run["bounditer"][-block.n:])
            assert np.all(bi == bi[0])
            yield int(bi[0]), s.nbound - 1


@pytest.mark.parametrize("bound, sample", [("single", "unif"),
                                           ("multi", "rwalk")])
def test_records_carry_the_bound_they_were_planned_on(bound, sample):
    """With a refit due at every dispatch boundary (``update_interval=1``),
    each dispatch runs on the bound from the refit before last at its
    launch: the first dispatch on a bound (planned before the unit-cube
    phase ended) is one refit behind the sampler when it is yielded, every
    later one two (its own lagged refit and the one planned behind it),
    the terminal one one again.  The JAX package's run follows the same
    rule; the streams differ, so the rule is compared, not the values."""
    lags = {}
    for name, s in (
            ("port", _sampler(bound, sample, update_interval=1)),
            ("jax", dytpu.NestedSampler(
                jax_loglike, ptform, NDIM, nlive=100, bound=bound,
                sample=sample, update_interval=1, queue_size=32,
                rstate=get_rstate()))):
        blocks = _quiet(list, _dispatch_blocks(s))
        first = next(i for i, (bi, _) in enumerate(blocks) if bi > 0)
        assert all(bi == 0 == nb for bi, nb in blocks[:first])
        lags[name] = [nb - bi for bi, nb in blocks[first:]]
        assert s.timings["n_prelaunch"] >= 2
    for lag in lags.values():
        assert len(lag) >= 4
        assert lag[0] == 1 and lag[-1] == 1
        assert set(lag[1:-1]) == {2}
    # without planning ahead the refit would come first: a lag of 0


@pytest.mark.parametrize("bound, sample", [("single", "unif"),
                                           ("multi", "rwalk")])
def test_a_dispatch_runs_on_the_bound_its_records_name(bound, sample,
                                                       monkeypatch):
    """Every dispatch uploads the bound its records name in ``bound_iter``
    (``bound_list[bound_iter]``): one planned ahead of a refit runs on the
    copy its spec keeps, not on the refitted bound."""
    uploads = []
    upload = Sampler.device_bound_arrays

    def spy(s, spec=None):
        dev = upload(s, spec)
        uploads.append(dev.get("ctrs"))
        return dev
    monkeypatch.setattr(Sampler, "device_bound_arrays", spy)
    s = _sampler(bound, sample, update_interval=1)
    snapped = 0
    for block in _quiet(s.sample, dlogz=0.01, per_dispatch=True):
        if not block.n or uploads[-1] is None:
            continue
        bi = s.saved_run["bounditer"][-1]
        ctrs = np.atleast_2d(s.bound_list[bi].device_spec()[1]["ctrs"])
        assert np.array_equal(uploads[-1][:len(ctrs)].numpy(), ctrs)
        snapped += bi < s.nbound - 2
    assert snapped >= 2 and s.timings["n_prelaunch"] >= 2


# --------------------------------------------------------------------------
# bit-exact resume with a planned spec in the checkpoint

CONFIGS = [(b, s) for b in ("single", "multi")
           for s in ("unif", "rwalk", "rslice")]


def _static(bound, sample):
    # a refit is due every one or two dispatches
    return _sampler(bound, sample, update_interval=0.5)


def _static_stop(bound, sample, monkeypatch, by):
    """A static run stopped by ``by`` exactly at a boundary whose planned
    spec kept its bound, pickled and resumed: the uninterrupted run."""
    spy = _Planned(monkeypatch)
    full = _static(bound, sample)
    ncall0 = full.ncall
    _quiet(full.run_nested, dlogz=0.01, print_progress=False)
    monkeypatch.undo()
    stop = spy.refit_boundary()
    budget = {"maxiter": stop["it"], "maxcall": stop["ncall"] - ncall0}
    s = _static(bound, sample)
    _quiet(s.run_nested, add_live=False, print_progress=False,
           **{by: budget[by]})
    # stopped exactly at the boundary, the next dispatch planned ahead of
    # the refit that moved the bound
    assert s.it - 1 == stop["it"] and s.interrupted_budget
    assert s._leftover is None and s._continuation is None
    spec = s._next_spec
    assert spec["bound_version_used"] < s.bound_version
    assert spec["bounditer"] == s.nbound - 2
    s2 = pickle.loads(pickle.dumps(s))
    snap = s2._next_spec["bound_used"]
    assert type(snap) is type(s.bound) and snap is not s2.bound
    _quiet(s2.run_nested, resume=True, dlogz=0.01, print_progress=False)
    _assert_same(s2, full)
    assert s2.timings.get("n_replay", 0) == 0


@pytest.mark.parametrize("bound, sample", CONFIGS)
def test_static_resume_with_a_planned_spec_pickled(bound, sample,
                                                   monkeypatch):
    _static_stop(bound, sample, monkeypatch, "maxiter")


def _dns(bound, sample):
    return dyt.DynamicNestedSampler(
        loglike, ptform, NDIM, bound=bound, sample=sample, queue_size=32,
        update_interval=0.5, device="cpu", rstate=get_rstate())


# a batch over the whole prior (seeded from it) runs several dispatches
NB = 60
BATCH = dict(nlive=NB, mode="manual", logl_bounds=(-np.inf, np.inf),
             print_progress=False)


def _assert_same_dynamic(a, b):
    ra, rb = a.results, b.results
    assert ra.niter == rb.niter and a.ncall == b.ncall and a.it == b.it
    for k in RUN_KEYS + ("samples_batch",):
        assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])), k
    assert a.rstate.integers(2**62) == b.rstate.integers(2**62)


def _dynamic_stop(bound, sample, monkeypatch, by):
    """A dynamic run's batch stopped by ``by`` exactly at a boundary whose
    planned spec kept its bound, pickled and resumed: the uninterrupted
    batch."""
    base = _dns(bound, sample)
    _quiet(base.run_nested, nlive_init=100, maxbatch=0, print_progress=False)
    ncall0 = base.ncall
    full = copy.deepcopy(base)
    spy = _Planned(monkeypatch)
    _quiet(full.add_batch, **BATCH)
    monkeypatch.undo()
    # the batch's seeds count against its maxiter
    budget = {"maxiter": NB + spy.refit_boundary(0)["it"]}
    stopped = copy.deepcopy(base)
    _quiet(stopped.add_batch, **BATCH, **budget)
    if by == "maxcall":
        # the calls of that stop, the seeding's included
        budget = {"maxcall": stopped.ncall - ncall0}
        stopped = copy.deepcopy(base)
        _quiet(stopped.add_batch, **BATCH, **budget)
    bs = stopped.batch_sampler
    assert bs is not None and bs.interrupted_budget
    assert bs._leftover is None and bs._continuation is None
    assert bs._next_spec["bound_version_used"] < bs.bound_version
    d2 = pickle.loads(pickle.dumps(stopped))
    _quiet(d2.add_batch, resume=True, **BATCH)
    assert d2.batch_sampler is None and d2.batch == 1
    _assert_same_dynamic(d2, full)


@pytest.mark.parametrize("bound, sample", CONFIGS)
def test_dynamic_resume_with_a_planned_spec_pickled(bound, sample,
                                                    monkeypatch):
    _dynamic_stop(bound, sample, monkeypatch, "maxiter")


@pytest.mark.parametrize("where", ["static", "dynamic"])
@pytest.mark.parametrize("bound, sample", [("single", "unif"),
                                           ("multi", "rwalk")])
def test_stop_by_maxcall_at_a_refit_due_boundary(bound, sample, where,
                                                 monkeypatch):
    """The rule that plans ahead reads no budget: a stop by ``maxcall``
    at a boundary where a refit is due resumes to the uninterrupted run
    (the JAX package's pre-launch is gated on the budgets and does not,
    ROADMAP Queue 3)."""
    stop = _static_stop if where == "static" else _dynamic_stop
    stop(bound, sample, monkeypatch, "maxcall")


@pytest.mark.parametrize("bound, sample", [("single", "rslice"),
                                           ("multi", "unif")])
def test_stop_inside_a_dispatch_run_on_a_copy(bound, sample, monkeypatch):
    """A stop ten records into a dispatch that runs on the copy of its
    bound (the refit planned behind it has moved the sampler's): the
    replayed tail and the continuation run on that copy and name it in
    their records, as the uninterrupted run's dispatch did."""
    spy = _Planned(monkeypatch)
    full = _static(bound, sample)
    _quiet(full.run_nested, dlogz=0.01, print_progress=False)
    monkeypatch.undo()
    s = _static(bound, sample)
    _quiet(s.run_nested, maxiter=spy.refit_boundary()["it"] + 10,
           add_live=False, print_progress=False)
    lo = s._leftover
    assert lo is not None and lo["bounditer"] == s.nbound - 2
    if lo["cont"] is not None:
        assert lo["cont"]["bound_version_used"] < s.bound_version
    s2 = pickle.loads(pickle.dumps(s))
    _quiet(s2.run_nested, resume=True, dlogz=0.01, print_progress=False)
    assert s2.timings["n_replay"] >= 1
    _assert_same(s2, full)


# --------------------------------------------------------------------------
# repeatability, stranded work, runs that plan nothing


@pytest.mark.parametrize("bound, sample", [("multi", "unif"),
                                           ("single", "rwalk")])
def test_a_planned_run_is_its_own_twin(bound, sample):
    a, b = _static(bound, sample), _static(bound, sample)
    for s in (a, b):
        _quiet(s.run_nested, print_progress=False)
    assert a.timings["n_prelaunch"] >= 1
    _assert_same(a, b)
    assert a.rstate.integers(2**62) == b.rstate.integers(2**62)


def test_no_work_is_stranded():
    """A planned dispatch is launched only in its turn: a terminal stop
    strands none, and every evaluation is billed to a record."""
    s = _static("multi", "unif")
    _quiet(s.run_nested, print_progress=False)
    assert s.timings["n_prelaunch"] >= 1
    assert s.timings["nc_stranded_pipeline"] == 0
    assert s._next_spec is None
    assert int(np.sum(s.results.ncall)) == s.ncall
    d = _dns("multi", "unif")
    _quiet(d.run_nested, nlive_init=100, nlive_batch=NB, maxbatch=2,
           print_progress=False)
    t = d.timings
    assert t["n_prelaunch"] >= 1 and t["nc_stranded_pipeline"] == 0


def _unplanned(monkeypatch):
    monkeypatch.setattr(Sampler, "_pipeline_capable", lambda self: False)


@pytest.mark.parametrize("bound, sample, kw", [
    ("balls", "rslice", {}), ("cubes", "unif", {}),
    (Box(NDIM), "rslice", {}),
    ("single", "unif", {"likelihood_mode": "host",
                        "loglike": np_loglike})])
def test_runs_that_plan_nothing_are_unchanged(bound, sample, kw,
                                              monkeypatch):
    """Friends, a user's bound and host mode keep the order of a refit
    before its dispatch's plan: their runs equal the runs with planning
    ahead switched off."""
    a = _sampler(bound, sample, **kw)
    _quiet(a.run_nested, print_progress=False)
    assert "n_prelaunch" not in a.timings
    _unplanned(monkeypatch)
    b = _sampler(copy.deepcopy(bound), sample, **kw)
    _quiet(b.run_nested, print_progress=False)
    _assert_same(a, b)


def test_switching_planning_off_moves_a_capable_run(monkeypatch):
    """The counterpart of the test above: over ellipsoids the refit lags
    by one dispatch, so the run differs from the one without a plan."""
    a = _static("single", "unif")
    _quiet(a.run_nested, print_progress=False)
    _unplanned(monkeypatch)
    b = _static("single", "unif")
    _quiet(b.run_nested, print_progress=False)
    assert a.timings["n_prelaunch"] >= 1 and "n_prelaunch" not in b.timings
    assert not np.array_equal(a.results.bound_iter, b.results.bound_iter)


def test_the_phase_clocks_count_a_planned_refit_once():
    """The refit a dispatch plans ahead of runs inside the consume window;
    it is timed as ``refit`` alone, so the phases the loop times one after
    another sum to no more than the run's wall."""
    s = _static("multi", "unif")
    _quiet(s.run_nested, print_progress=False)
    t = s.timings
    assert t["n_prelaunch"] >= 1 and t["n_refit"] >= 2
    assert t["dispatch"] + t["consume"] + t["refit"] <= t["total"]
