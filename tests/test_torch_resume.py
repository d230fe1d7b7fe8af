"""Stop, save, restore, resume in the port: a run stopped by
``maxiter``/``maxcall``, pickled, restored and resumed must equal the
uninterrupted run bit for bit (the invariant of ``tests/test_resume.py``),
``ncall`` included: no evaluation is billed twice or dropped.

Tolerance: none.  Every comparison below is ``np.array_equal`` or ``==``.
"""

import copy
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.internal.samplers as tsam
from dynesty_tpu_torch.utils import checkpoint

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
SEED = 56432

# module-level (picklable) problems
_COV = np.identity(NDIM)
_COV[_COV == 0] = 0.95
_CINV = torch.as_tensor(np.linalg.inv(_COV))
_LNORM = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(_COV)))


def gau_loglike(x):
    return -0.5 * (x @ _CINV @ x) + _LNORM


def gau_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def egg_loglike(x):
    tmax = 5.0 * np.pi
    t = 2.0 * tmax * x - tmax
    return (2.0 + torch.cos(t[0] / 2.0) * torch.cos(t[1] / 2.0)) ** 5.0


def identity(u):
    return u


def _sampler(bound, sample, mode, **kw):
    if bound == "multi":  # the eggbox, so that the bound splits
        return dyt.NestedSampler(
            egg_loglike, identity, 2, nlive=150, bound=bound, sample=sample,
            queue_size=32, proposal_mode=mode, device="cpu",
            rstate=get_rstate(SEED), **kw)
    return dyt.NestedSampler(
        gau_loglike, gau_ptform, NDIM, nlive=120, bound=bound,
        sample=sample, queue_size=32, proposal_mode=mode, device="cpu",
        rstate=get_rstate(SEED), **kw)


def _run(s, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.run_nested(print_progress=False, **kw)
    return s


_FULL = {}


def _full(bound, sample, mode):
    """The uninterrupted run of a configuration (made once)."""
    key = (bound, sample, mode)
    if key not in _FULL:
        _FULL[key] = _run(_sampler(bound, sample, mode))
    return _FULL[key]


KEYS = ("logz", "logzerr", "logl", "logvol", "logwt", "samples",
        "samples_u", "samples_it", "samples_id", "samples_n",
        "samples_birth", "ncall", "scale")


def _assert_same(resumed, full):
    a, b = resumed.results, full.results
    assert a.niter == b.niter
    for k in KEYS:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    # no evaluation billed twice or dropped, in total and record by record
    assert resumed.ncall == full.ncall
    assert resumed.it == full.it and resumed.nbound == full.nbound


CONFIGS = [("single", "unif"), ("single", "rslice"), ("single", "rwalk"),
           ("single", "slice"), ("multi", "unif")]


@pytest.mark.parametrize("mode", ["batch", "queue"])
@pytest.mark.parametrize("bound, sample", CONFIGS)
def test_save_restore_resume_bit_identical(bound, sample, mode, tmp_path):
    fname = str(tmp_path / "save.pkl")
    s = _run(_sampler(bound, sample, mode), maxiter=333, add_live=False)
    assert s.interrupted_budget and not s.added_live
    s.save(fname)
    del s
    s2 = dyt.NestedSampler.restore(fname)
    assert s2.device == torch.device("cpu") and s2._live_dev is None
    _run(s2, resume=True)
    assert not s2.interrupted_budget
    # the stop fell inside a round: its tail was replayed
    assert s2.timings["n_replay"] >= 1
    _assert_same(s2, _full(bound, sample, mode))
    if bound == "multi":
        assert s2.bound.nells > 1


@pytest.mark.parametrize("mode", ["batch", "queue"])
def test_stop_inside_a_chained_dispatch(mode):
    """A stop in the first round of an 8-round dispatch leaves a leftover
    (the round's tail) and a continuation (the other rounds): both are
    pickled, both are consumed on resume, in that order."""
    full = _full("single", "rslice", mode)
    # find an iteration count that falls early inside a chained dispatch
    # after the unit-cube phase: 10 entries into the first rslice dispatch
    probe = _sampler("single", "rslice", mode)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in probe.sample(dlogz=0.01, per_dispatch=True):
            if not probe.unit_cube_sampling:
                break
    first = probe.it - 1 + 10
    s = _run(_sampler("single", "rslice", mode), maxiter=first,
             add_live=False)
    assert s._leftover is not None and s._continuation is None
    cont = s._leftover["cont"]
    assert cont is not None and cont["skip"] >= 1
    assert cont["rounds"] > cont["skip"]
    # the dispatch was planned ahead of the refit that followed it: the
    # continuation runs on the copy of the bound it was planned on
    assert set(cont) == {"key_seed", "skip", "rounds", "queue_size",
                         "refit_due_ncall", "bounditer", "bound_used",
                         "bound_version_used"}
    assert cont["bound_version_used"] < s.bound_version
    assert cont["bounditer"] == s.nbound - 2
    assert 0 < len(s._leftover["prop"]) < s.queue_size
    ncall_stop = s.ncall
    s2 = pickle.loads(pickle.dumps(s))
    assert np.array_equal(s2._leftover["prop"], s._leftover["prop"])
    _run(s2, resume=True)
    assert s2.timings["n_replay"] == 1 and s2.timings["n_continuation"] == 1
    assert s2._leftover is None and s2._continuation is None
    assert s2._next_spec is None and s2._nc_accum_carry == 0
    _assert_same(s2, full)
    # the kept evaluations were billed on replay, not at the stop
    assert ncall_stop < full.ncall


def test_stopped_twice_and_resumed_per_record():
    """Two stops (the second one during a resumed run), the last leg
    consumed record by record: still the uninterrupted run."""
    full = _full("single", "rwalk", "batch")
    s = _run(_sampler("single", "rwalk", "batch"), maxiter=150,
             add_live=False)
    s = pickle.loads(pickle.dumps(s))
    _run(s, maxiter=407, add_live=False, resume=True)
    assert s.interrupted_budget
    s = pickle.loads(pickle.dumps(s))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        n = sum(1 for _ in s.sample(dlogz=1e-3 * (s.nlive - 1) + 0.01,
                                    resume=True))
        for _ in s.add_live_points():
            pass
    assert n == full.results.niter - 150 - 407
    a, b = s.results, full.results
    for k in ("logl", "samples", "ncall", "logvol", "samples_it"):
        assert np.array_equal(a[k], b[k]), k
    assert s.ncall == full.ncall


def test_abandoned_drain_is_resumed():
    """Leaving the per-record generator between two yields keeps the
    staged records; a resumed run yields them first."""
    full = _full("single", "unif", "batch")
    s = _sampler("single", "unif", "batch")
    dlogz = 1e-3 * (s.nlive - 1) + 0.01
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, _ in enumerate(s.sample(dlogz=dlogz)):
            if i == 40:
                break
        assert len(s._pending_records) > 0
        s2 = pickle.loads(pickle.dumps(s))
        rest = list(s2.sample(dlogz=dlogz, resume=True))
        for _ in s2.add_live_points():
            pass
    assert 41 + len(rest) == full.results.niter
    assert rest[0].loglstar == full.results.logl[41]
    assert np.array_equal(s2.results.logl, full.results.logl)
    assert np.array_equal(s2.results.ncall, full.results.ncall)


@pytest.mark.parametrize("sample", ["unif", "rwalk"])
def test_stop_by_maxcall(sample):
    full = _full("single", sample, "batch")
    s = _run(_sampler("single", sample, "batch"),
             maxcall=full.ncall // 2, add_live=False)
    assert s.interrupted_budget and s.ncall < full.ncall
    s2 = pickle.loads(pickle.dumps(s))
    _run(s2, resume=True)
    _assert_same(s2, full)


def test_checkpoint_file_written_and_restores(tmp_path, monkeypatch):
    fname = str(tmp_path / "ckpt.pkl")
    s = _sampler("single", "unif", "batch")
    _run(s, checkpoint_file=fname, checkpoint_every=0.0)
    assert os.path.exists(fname) and not os.path.exists(fname + ".tmp")
    restored = dyt.NestedSampler.restore(fname)
    assert restored.it == s.it and restored.added_live
    assert np.array_equal(restored.results.logz, s.results.logz)
    _assert_same(restored, _full("single", "unif", "batch"))
    # a finished run does not resume
    with pytest.warns(RuntimeWarning, match="finished"):
        restored.run_nested(resume=True, print_progress=False)
    # a checkpoint taken mid-run by the timer goes on to the same end
    seen = []

    def save_once(sampler, name):
        if not seen:
            seen.append(pickle.dumps(sampler))

    monkeypatch.setattr(dyt.sampler.Sampler, "save", save_once)
    _run(_sampler("single", "unif", "batch"), checkpoint_file=fname,
         checkpoint_every=0.0)
    mid = pickle.loads(seen[0])
    assert 1 < mid.it < s.it
    _run(mid, resume=True)
    _assert_same(mid, s)


def test_pickle_roundtrip_and_state():
    s = _run(_sampler("single", "rslice", "batch"), maxiter=450,
             add_live=False)
    assert not s.unit_cube_sampling
    state = s.__getstate__()
    # no device tensor, no generator, no built round is pickled, and the
    # device goes by name
    assert state["device"] == "cpu"
    for k in ("_live_dev", "_bound_upload", "_mirror_stale"):
        assert k not in state
    assert s.internal_sampler.__getstate__()["_round_cache"] == {}

    def tensors(obj, depth=0):
        if isinstance(obj, (torch.Tensor, torch.Generator)):
            return True
        if depth > 3:
            return False
        if isinstance(obj, dict):
            return any(tensors(v, depth + 1) for v in obj.values())
        if isinstance(obj, (list, tuple)):
            return any(tensors(v, depth + 1) for v in obj[:50])
        return False

    assert not tensors({k: v for k, v in state.items()
                        if k != "loglikelihood"})
    s2 = pickle.loads(pickle.dumps(s))
    assert s2.internal_sampler is s2.internal_sampler_next
    assert s2.internal_sampler._round_cache == {}
    assert s2.loglikelihood.device == torch.device("cpu")
    _run(s2, resume=True, maxiter=250, add_live=False)
    assert s2.it >= s.it + 250
    _run(s2, resume=True)
    _assert_same(s2, _full("single", "rslice", "batch"))


def test_format_version_is_checked(tmp_path):
    fname = str(tmp_path / "old.pkl")
    s = _sampler("single", "unif", "batch")
    with open(fname, "wb") as fp:
        pickle.dump({"sampler": s, "version": dyt.__version__,
                     "format_version": checkpoint.FORMAT_VERSION + 1}, fp)
    with pytest.raises(ValueError, match="format version"):
        dyt.NestedSampler.restore(fname)
    # format 3 stays: a spec planned ahead of its refit is a pickled dict
    # that carries the copy of its bound, and loads with it
    assert checkpoint.FORMAT_VERSION == 3 and checkpoint._READABLE == (2, 3)
    s._next_spec = {"key_seed": 1, "queue_size": 32, "rounds_active": None,
                    "refit_due_ncall": 2.0 ** 30, "bounditer": 0,
                    "bound_used": copy.deepcopy(s.bound),
                    "bound_version_used": s.bound_version - 1}
    s.save(fname)
    with open(fname, "rb") as fp:
        assert pickle.load(fp)["format_version"] == 3
    snap = dyt.NestedSampler.restore(fname)._next_spec["bound_used"]
    assert type(snap) is type(s.bound) and snap is not s.bound
    # a failed write leaves neither the file nor its temporary behind
    bad = str(tmp_path / "bad.pkl")
    s.loglikelihood.loglikelihood = lambda x: x  # a lambda does not pickle
    with pytest.raises(Exception):
        s.save(bad)
    assert not os.path.exists(bad) and not os.path.exists(bad + ".tmp")


def test_dispatch_spec_carries_its_refit_due_ncall():
    """The spec is plain host data that pickles, and the launch uses the
    ctrl[21] the spec was planned with, not the sampler's state at
    launch."""
    s = _sampler("multi", "unif", "batch")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in s.sample(dlogz=0.01, per_dispatch=True):
            # stop between two dispatches, once the bound has split
            if getattr(s.bound, "nells", 1) > 1 and s.it > 400:
                break
    # over ellipsoids the next dispatch was planned before its refit,
    # with the refit-due ncall of that moment
    planned = s._next_spec
    assert s._leftover is None and planned is not None
    assert planned["refit_due_ncall"] <= s.ncall_at_last_update + \
        s.bound_update_interval
    # plan it again, as the loop top would without a planned spec
    s._next_spec = None
    loglstar = s._integ["loglstar"]
    spec = s._make_dispatch_spec(0.01, loglstar)
    assert set(spec) == {"key_seed", "queue_size", "rounds_active",
                         "refit_due_ncall"}
    assert isinstance(spec["key_seed"], int)
    assert spec["refit_due_ncall"] == s.internal_sampler._refit_due_ncall(s)
    assert spec["refit_due_ncall"] == \
        s.ncall_at_last_update + s.bound_update_interval
    assert pickle.loads(pickle.dumps(spec)) == spec
    # the counters move after planning (as a deferred refit would move
    # them): the launch must still run the gate it was planned with
    s._next_spec = spec
    s.ncall_at_last_update += 12345
    assert s.internal_sampler._refit_due_ncall(s) != spec["refit_due_ncall"]
    seen = []
    fused_fn, layout = s.internal_sampler.get_fused(s, "ellipsoids")

    def spy(seed, live, live_blob, axes_args, ctrl):
        seen.append((seed, float(ctrl[21])))
        return fused_fn(seed, live, live_blob, axes_args, ctrl)

    cfg = next(k for k in s.internal_sampler._round_cache
               if k[0] == "fused" and k[1] == "ellipsoids")
    s.internal_sampler._round_cache[cfg] = (spy, layout)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        next(s.sample(dlogz=0.01, resume=True, per_dispatch=True))
    assert seen == [(spec["key_seed"], spec["refit_due_ncall"])]
    # consumed: the spec waiting now is the next dispatch's own
    assert s._next_spec is not None and \
        s._next_spec["key_seed"] != spec["key_seed"]
    # the other kernels never arm the gate
    r = _sampler("single", "rwalk", "batch")
    assert r._make_dispatch_spec(0.01, -1e300)["refit_due_ncall"] == 2.0 ** 30


def test_terminal_stop_is_pickled():
    """A natural stop is state: a resumed finished run plans no dispatch
    and draws no seed."""
    s = _sampler("single", "unif", "batch")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in s.sample(dlogz=0.5, per_dispatch=True):
            pass
    assert s._terminal_done and not s.interrupted_budget
    assert s._leftover is None and s._continuation is None
    s2 = pickle.loads(pickle.dumps(s))
    state = s2.rstate.bit_generator.state
    assert list(s2.sample(dlogz=0.5, resume=True, per_dispatch=True)) == []
    assert s2.rstate.bit_generator.state == state
    # every evaluation launched by the last dispatch was billed
    assert int(np.sum(s2.results.ncall)) == s2.ncall - s2.nlive


def test_reset_starts_over():
    s = _run(_sampler("single", "rslice", "batch"), maxiter=300,
             add_live=False)
    assert s._leftover is not None or s._continuation is not None
    s.reset()
    assert s.it == 1 and s.unit_cube_sampling and s.nbound == 1
    assert len(s.saved_run["logl"]) == 0 and s._live_dev is None
    assert s._leftover is None and s._continuation is None
    assert s._pending_records == [] and s._integ is None
    assert isinstance(s.internal_sampler, tsam.UnitCubeSampler)
    _run(s)
    res = s.results
    assert abs(res.logz[-1] + 8.987) < 4 * res.logzerr[-1]
    assert int(np.sum(res.ncall)) == s.ncall


def test_set_device_drops_device_state():
    s = _run(_sampler("balls", "rslice", "batch"), maxiter=600,
             add_live=False)
    assert not s.unit_cube_sampling
    assert s._live_dev is not None and s.internal_sampler._round_cache
    s.set_device("cpu")
    assert s._live_dev is None and s._bound_upload is None
    assert s.internal_sampler._round_cache == {}
    assert s.bound.device == s.loglikelihood.device == torch.device("cpu")
    _run(s, resume=True)
    _assert_same(s, _run(_sampler("balls", "rslice", "batch")))


class TinyScaleRSlice(tsam.RSliceSampler):
    """rslice (one slice a proposal) that starts from so small a scale
    that its first round steps an interval out more than 1000 times: the
    dispatch that runs it switches the sampler to doubling."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.scale = 7e-4


def normal_loglike(x):
    return -0.5 * (x @ x)


def _switching(dynamic):
    kw = dict(nlive=60, bound="single", sample=TinyScaleRSlice(slices=1),
              queue_size=16, rounds_per_dispatch=4, device="cpu",
              rstate=get_rstate(SEED))
    if dynamic:
        return dyt.DynamicNestedSampler(normal_loglike, gau_ptform, 2, **kw)
    return dyt.NestedSampler(normal_loglike, gau_ptform, 2, **kw)


def _dispatch_start(scales):
    """Index of the first record of the first rslice dispatch: its scale
    is no longer the unit-cube phase's."""
    return int(np.nonzero(np.asarray(scales) != 1.0)[0][0])


def _assert_suspended_before_the_switch(s):
    assert s._leftover is not None and s._leftover["cont"]
    assert s.internal_sampler._doubling_due
    assert not s.internal_sampler.sampler_kwargs["slice_doubling"]


def _assert_switched_after_continuation(s):
    assert s.timings["n_continuation"] >= 1
    assert s.internal_sampler.sampler_kwargs["slice_doubling"]
    assert not s.internal_sampler._doubling_due


def test_switch_to_doubling_inside_an_interrupted_dispatch(tmp_path):
    """The dispatch that sets off the switch to doubling is stopped in its
    second round: its continuation must run the stepping-out kernel it
    started with, and the switch come after it, as in the uninterrupted
    run."""
    full = _switching(False)
    with pytest.warns(UserWarning, match="doubling"):
        full.run_nested(print_progress=False)
    assert full.internal_sampler.sampler_kwargs["slice_doubling"]
    i0 = _dispatch_start(full.saved_run["scale"])
    s = _run(_switching(False), maxiter=i0 + 16 + 5, add_live=False)
    _assert_suspended_before_the_switch(s)
    fname = str(tmp_path / "switch.pkl")
    s.save(fname)
    s2 = _run(dyt.NestedSampler.restore(fname), resume=True)
    _assert_switched_after_continuation(s2)
    _assert_same(s2, full)


def test_switch_to_doubling_inside_an_interrupted_batch(tmp_path):
    """The same inside a dynamic batch: a batch from the prior
    (``logl_bounds`` from -inf) gets a fresh kernel at the template's
    scale, and its first rslice dispatch sets off the switch; stopped
    there by ``maxiter``, saved, restored and resumed, the batch equals
    the uninterrupted one."""
    batch_kw = dict(nlive=60, mode="manual", logl_bounds=(-np.inf, np.inf),
                    print_progress=False)

    base = _switching(True)
    _quiet_run(base.run_nested, maxbatch=0, print_progress=False)
    full = pickle.loads(pickle.dumps(base))
    with pytest.warns(UserWarning, match="doubling"):
        full.add_batch(**batch_kw)
    batch = np.asarray(full.saved_run["batch"]) == 1
    k = _dispatch_start(np.asarray(full.saved_run["scale"])[batch])
    d = base
    _quiet_run(d.add_batch, maxiter=60 + k + 16 + 5, **batch_kw)
    assert d.batch_sampler is not None
    _assert_suspended_before_the_switch(d.batch_sampler)
    fname = str(tmp_path / "switch.pkl")
    d.save(fname)
    d2 = dyt.DynamicNestedSampler.restore(fname)
    _quiet_run(d2.add_batch, resume=True, **batch_kw)
    assert d2.batch_sampler is None and d2.batch == full.batch == 1
    assert d2.ncall == full.ncall
    ra, rb = d2.results, full.results
    for k in KEYS + ("samples_batch",):
        assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])), k


def _quiet_run(fn, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(**kw)
