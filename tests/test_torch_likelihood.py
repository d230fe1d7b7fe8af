"""The likelihood layer of the port: blobs, host-mode likelihoods, the
user's exceptions and the evaluation history, held to the JAX package's
gates (``tests/test_features.py``, ``tests/test_ncall.py``,
``tests/test_history.py``, ``tests/test_misc.py``) and to the port's own.

Tolerances: a blob is copied, never computed twice, so every blob check is
exact (``np.array_equal``); resumed runs are bit for bit; the evidence of
a host-mode run is held to the JAX package's within 4 combined errors.
"""

import copy
import pickle
import warnings

import numpy as np
import pytest
import torch

import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.internal.fused as tfused
from dynesty_tpu_torch.internal.likelihood import LogLikelihood
from dynesty_tpu_torch.utils import checkpoint

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 2
LNORM = -0.5 * np.log(2 * np.pi) * NDIM
# N(0, 0.5^2) in each coordinate over [-1, 1]^2
TRUTH = 0.5 * np.log(2 * np.pi * 0.25) * 2 - np.log(4.0)


# module-level (picklable) problems
def blob_loglike(x):
    logl = -0.5 * torch.sum((x / 0.5) ** 2)
    return logl, torch.stack([logl, x[0]])


def scalar_blob_loglike(x):
    logl = -0.5 * torch.sum((x / 0.5) ** 2)
    return logl, logl * 2.0


def dict_blob_loglike(x):
    logl = -0.5 * torch.sum((x / 0.5) ** 2)
    return logl, {"logl": logl, "v": x, "n": (x > 0).sum()}


def plain_loglike(x):
    return -0.5 * torch.sum((x / 0.5) ** 2)


def ptform(u):
    return 2.0 * u - 1.0


def np_loglike(x):
    return -0.5 * np.sum((x / 0.5) ** 2)


def np_blob_loglike(x):
    logl = -0.5 * np.sum((x / 0.5) ** 2)
    return logl, np.array([logl, x[0]])


def np_ptform(u):
    return 2.0 * u - 1.0


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


def _blobs(res):
    return np.array([b for b in res.blob], dtype=np.float64)


# --------------------------------------------------------------------------
# blobs (tests/test_features.py::test_blob, test_blob_rwalk)


def test_blob():
    sampler = dyt.NestedSampler(blob_loglike, ptform, 2, nlive=150,
                                bound="single", sample="unif", blob=True,
                                rstate=get_rstate(), queue_size=32,
                                device="cpu")
    sampler.run_nested(print_progress=False)
    res = sampler.results
    blobs = _blobs(res)
    assert blobs.shape == (len(res.logl), 2)
    # blob[0] is the stored logl of each sample
    assert np.array_equal(blobs[:, 0], res.logl)


def test_blob_rwalk():
    sampler = dyt.NestedSampler(scalar_blob_loglike, ptform, 2, nlive=150,
                                bound="single", sample="rwalk", blob=True,
                                rstate=get_rstate(), queue_size=32,
                                device="cpu")
    sampler.run_nested(print_progress=False)
    res = sampler.results
    blobs = _blobs(res)
    assert blobs.shape == (len(res.logl),)
    assert np.array_equal(blobs, 2 * np.asarray(res.logl))


BLOB_CONFIGS = [("single", "unif"), ("single", "rwalk"), ("multi", "slice"),
                ("balls", "rslice")]


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("bound,sample", BLOB_CONFIGS)
def test_blob_belongs_to_its_point(bound, sample, dynamic):
    """Every sample's blob is ``(logl, v[0])`` of that sample: the blob
    rides through the round, the consume loop's kill order, the live set,
    the leftover and the recycling, and, dynamic, the batch seeds."""
    kw = dict(bound=bound, sample=sample, blob=True, rstate=get_rstate(),
              queue_size=32, device="cpu",
              first_update={"min_eff": 100.0})
    if dynamic:
        s = dyt.DynamicNestedSampler(blob_loglike, ptform, 2, nlive=100,
                                     **kw)
        _quiet(s.run_nested, print_progress=False, maxbatch=1,
               n_effective=1500)
        assert s.batch == 1
    else:
        s = dyt.NestedSampler(blob_loglike, ptform, 2, nlive=100, **kw)
        _quiet(s.run_nested, print_progress=False)
    res = s.results
    blobs = _blobs(res)
    assert blobs.shape == (len(res.logl), 2)
    assert np.array_equal(blobs[:, 0], res.logl)
    assert np.array_equal(blobs[:, 1], res.samples[:, 0])
    assert abs(res.logz[-1] - TRUTH) < 4 * res.logzerr[-1]


def test_a_blob_changes_no_proposal():
    """The same run with and without a blob: the same records."""
    runs = []
    for loglike, blob in ((plain_loglike, False), (blob_loglike, True)):
        s = dyt.NestedSampler(loglike, ptform, 2, nlive=100, bound="balls",
                              sample="rslice", blob=blob,
                              rstate=get_rstate(), queue_size=32,
                              device="cpu")
        _quiet(s.run_nested, print_progress=False)
        runs.append(s)
    a, b = runs[0].results, runs[1].results
    for k in ("logl", "logz", "samples", "samples_u", "ncall"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert runs[0].ncall == runs[1].ncall


def test_blob_tree_of_tensors():
    """A dict blob of leaves of three shapes and two dtypes."""
    s = dyt.NestedSampler(dict_blob_loglike, ptform, 2, nlive=80,
                          bound="single", sample="rslice", blob=True,
                          rstate=get_rstate(), queue_size=16, device="cpu")
    sd = s.loglikelihood.blob_shape_dtype
    assert sd["logl"].shape == () and sd["v"].shape == (2,)
    assert sd["n"].dtype == torch.int64
    _quiet(s.run_nested, print_progress=False)
    res = s.results
    assert all(set(b) == {"logl", "v", "n"} for b in res.blob)
    assert np.array_equal([b["logl"] for b in res.blob], res.logl)
    assert np.array_equal(np.stack([b["v"] for b in res.blob]), res.samples)
    assert np.array_equal([b["n"] for b in res.blob],
                          (res.samples > 0).sum(axis=1))


def test_scalar_blob_batches_to_one_axis():
    like = LogLikelihood(scalar_blob_loglike, ptform, 2, device="cpu",
                         blob=True)
    rng = np.random.Generator(np.random.PCG64(3))
    v, logl, blob = like.eval_host(rng.random((5, 2)))
    assert blob.shape == (5,) and np.array_equal(blob, 2 * logl)
    u = torch.as_tensor(rng.random((7, 2)))
    v, logl, blob = like.batch_eval(u)
    assert blob.shape == (7,) and torch.equal(blob, 2 * logl)
    assert like.blob_zeros(4).shape == (4,)


def test_thin_and_general_consume_are_identical_with_blobs(monkeypatch):
    """Forcing every round through the general consume scan changes no
    record and no blob."""
    def run():
        s = dyt.NestedSampler(blob_loglike, ptform, 2, nlive=100,
                              bound="single", sample="rslice", blob=True,
                              rstate=get_rstate(), queue_size=16,
                              device="cpu")
        _quiet(s.run_nested, print_progress=False)
        return s

    thin = run()
    monkeypatch.setattr(tfused, "_FORCE_GENERAL_CONSUME", True)
    general = run()
    a, b = thin.results, general.results
    for k in ("logl", "logz", "samples", "samples_u", "ncall", "samples_it"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert np.array_equal(_blobs(a), _blobs(b))
    assert thin.ncall == general.ncall


# --------------------------------------------------------------------------
# host mode (tests/test_features.py::test_host_mode, test_host_mode_rwalk)


def test_host_mode():
    sampler = dyt.NestedSampler(np_loglike, np_ptform, 2, nlive=150,
                                bound="single", sample="unif",
                                likelihood_mode="host", rstate=get_rstate(),
                                queue_size=32, device="cpu")
    sampler.run_nested(print_progress=False)
    res = sampler.results
    # the same problem in torch mode
    sampler2 = dyt.NestedSampler(plain_loglike, ptform, 2, nlive=150,
                                 bound="single", sample="unif",
                                 rstate=get_rstate(), queue_size=32,
                                 device="cpu")
    sampler2.run_nested(print_progress=False)
    res2 = sampler2.results
    assert abs(res.logz[-1] - res2.logz[-1]) < \
        4 * np.hypot(res.logzerr[-1], res2.logzerr[-1])
    assert abs(res.logz[-1] - TRUTH) < 4 * res.logzerr[-1]


def test_host_mode_rwalk():
    sampler = dyt.NestedSampler(np_loglike, np_ptform, 2, nlive=100,
                                bound="single", sample="rwalk",
                                likelihood_mode="host", rstate=get_rstate(),
                                queue_size=16, device="cpu")
    _quiet(sampler.run_nested, print_progress=False, maxiter=300)
    assert np.isfinite(sampler.results.logz[-1])


def test_host_mode_logz_against_the_jax_package():
    """The same host-mode problem, seed and arguments in both packages:
    the evidences within 4 combined errors."""
    import dynesty_tpu as dytpu

    kw = dict(nlive=150, bound="single", sample="unif",
              likelihood_mode="host", queue_size=32)
    j = dytpu.NestedSampler(np_loglike, np_ptform, 2, rstate=get_rstate(),
                            **kw)
    j.run_nested(print_progress=False)
    t = dyt.NestedSampler(np_loglike, np_ptform, 2, rstate=get_rstate(),
                          device="cpu", **kw)
    t.run_nested(print_progress=False)
    jr, tr = j.results, t.results
    assert abs(jr.logz[-1] - tr.logz[-1]) < \
        4 * np.hypot(jr.logzerr[-1], tr.logzerr[-1])
    # the same algorithm: the iteration counts agree within 10 %
    assert abs(tr.niter - jr.niter) < 0.1 * jr.niter


def test_host_mode_evaluates_only_the_counted_lanes():
    calls = []

    def counted(x):
        calls.append(x.copy())
        return np_blob_loglike(x)

    like = LogLikelihood(counted, np_ptform, 2, device="cpu", mode="host",
                         blob=True)
    rng = np.random.Generator(np.random.PCG64(5))
    like.eval_host(rng.random((3, 2)))
    assert like.npdim == 2 and like.blob_shape_dtype.shape == (2,)
    calls.clear()
    launched = like.ncall_launched
    u = torch.as_tensor(rng.random((8, 2)))
    mask = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0], dtype=torch.bool)
    v, logl, blob = like.batch_eval(u, mask=mask)
    assert len(calls) == 4 and like.ncall_launched == launched + 4
    assert np.array_equal(np.stack(calls), 2.0 * u[mask].numpy() - 1.0)
    assert torch.all(logl[~mask] == -np.inf) and torch.all(v[~mask] == 0)
    assert torch.all(blob[~mask] == 0)
    assert torch.equal(blob[mask, 0], logl[mask])
    assert torch.equal(v[mask], 2.0 * u[mask] - 1.0)


def test_host_mode_rejects_an_invalid_value():
    like = LogLikelihood(lambda x: np.nan, np_ptform, 2, device="cpu",
                         mode="host")
    with pytest.raises(ValueError, match="invalid"):
        like.eval_host(np.full((2, 2), 0.5))


# --------------------------------------------------------------------------
# exact ncall (tests/test_ncall.py::test_ncall_exact)


class CountingLike:
    """Gaussian likelihood that counts its own invocations."""

    def __init__(self):
        self.ncall = 0

    def loglikelihood(self, x):
        self.ncall += 1
        return -0.5 * np.dot(x, x) + LNORM

    def prior_transform(self, u):
        return 10.0 * (2.0 * u - 1.0)


@pytest.mark.parametrize("dynamic", [False, True])
def test_ncall_exact(dynamic):
    like = CountingLike()
    kw = dict(nlive=50, bound="single", sample="unif", rstate=get_rstate(),
              likelihood_mode="host", queue_size=16, device="cpu")
    if dynamic:
        samp = dyt.DynamicNestedSampler(like.loglikelihood,
                                        like.prior_transform, NDIM, **kw)
        samp.run_nested(maxbatch=1, n_effective=500, print_progress=False)
    else:
        samp = dyt.NestedSampler(like.loglikelihood, like.prior_transform,
                                 NDIM, **kw)
        samp.run_nested(print_progress=False)
    assert samp.ncall == like.ncall, (samp.ncall, like.ncall)


# --------------------------------------------------------------------------
# the user's exceptions (tests/test_misc.py)


def test_exception_propagation():
    def bad_logl(x):
        raise RuntimeError("user kaboom")

    with pytest.raises(RuntimeError, match="user kaboom"):
        dyt.NestedSampler(bad_logl, lambda u: u, 2, nlive=50,
                          likelihood_mode="host", device="cpu")


@pytest.mark.parametrize("mode", ["torch", "host"])
def test_exception_context(capsys, mode):
    """The offending point is printed before the exception is re-raised;
    in torch mode, inside ``vmap``, the batch is printed."""
    def bad_loglike(x):
        raise RuntimeError("user function blew up")

    with pytest.raises(RuntimeError, match="user function blew up"):
        dyt.NestedSampler(bad_loglike, ptform, 2, nlive=20,
                          rstate=get_rstate(), likelihood_mode=mode,
                          device="cpu")
    err = capsys.readouterr().err
    assert "Exception while calling loglikelihood function" in err
    assert "params:" in err


def test_exception_in_a_round_names_the_prior_transform(capsys):
    """An exception raised in a device round, not at initialisation."""
    calls = {"n": 0}

    def flaky_ptform(u):
        calls["n"] += 1
        if calls["n"] > 400:
            raise ValueError("transform gave up")
        return 2.0 * u - 1.0

    s = dyt.NestedSampler(np_loglike, flaky_ptform, 2, nlive=50,
                          bound="single", sample="unif",
                          likelihood_mode="host", rstate=get_rstate(),
                          queue_size=16, device="cpu")
    with pytest.raises(ValueError, match="transform gave up"):
        _quiet(s.run_nested, print_progress=False)
    err = capsys.readouterr().err
    assert "Exception while calling prior_transform function" in err


# --------------------------------------------------------------------------
# evaluation history (tests/test_history.py)


@pytest.mark.parametrize("mode", ["torch", "host"])
def test_history_completeness(tmp_path, mode):
    h5py = pytest.importorskip("h5py")
    fname = str(tmp_path / "hist.h5")
    loglike = plain_loglike if mode == "torch" else np_loglike
    sampler = dyt.NestedSampler(loglike, ptform, NDIM, nlive=50,
                                bound="single", sample="unif",
                                rstate=get_rstate(), queue_size=16,
                                likelihood_mode=mode, device="cpu",
                                save_evaluation_history=True,
                                history_filename=fname)
    sampler.run_nested(dlogz=0.1, print_progress=False)
    with h5py.File(fname, "r") as fp:
        n_hist = len(fp["evaluation_logl"])
        assert n_hist == sampler.ncall, (n_hist, sampler.ncall)
        for k in ("evaluation_u", "evaluation_v"):
            assert fp[k].shape == (n_hist, NDIM)
            assert not np.any(np.isnan(fp[k][:]))
        u, v = fp["evaluation_u"][:], fp["evaluation_v"][:]
        logl = fp["evaluation_logl"][:]
    assert np.all(np.isfinite(logl))
    assert np.allclose(v, 2.0 * u - 1.0, rtol=0, atol=1e-15)
    assert np.allclose(logl, -0.5 * np.sum((v / 0.5) ** 2, axis=1),
                       rtol=1e-14, atol=0)


def test_history_needs_a_file_name():
    with pytest.raises(ValueError, match="history_filename"):
        dyt.NestedSampler(plain_loglike, ptform, NDIM, nlive=50,
                          device="cpu", save_evaluation_history=True)


def test_pickling_drops_the_pool_and_the_history(tmp_path):
    class Pool:
        njobs = 2

        def map(self, fn, items):
            return list(map(fn, items))

    like = LogLikelihood(np_loglike, np_ptform, 2, device="cpu",
                         mode="host", pool=Pool(),
                         save_evaluation_history=True,
                         history_filename=str(tmp_path / "h.h5"))
    like.eval_host(np.full((3, 2), 0.5))
    assert like._history_buffer
    like2 = pickle.loads(pickle.dumps(like))
    assert like2.pool is None and not like2.save_evaluation_history
    assert like2._history_buffer == [] and like2.npdim == 2
    assert like2.eval_host(np.full((1, 2), 0.5))[1][0] == 0.0


# --------------------------------------------------------------------------
# stop, save, restore, resume with blobs, host mode and history


def _blob_host_sampler(history=None):
    return dyt.NestedSampler(
        np_blob_loglike, np_ptform, 2, nlive=80, bound="single",
        sample="rslice", blob=True, likelihood_mode="host",
        rstate=get_rstate(), queue_size=16, device="cpu",
        save_evaluation_history=history is not None,
        history_filename=history)


def test_blob_host_mode_resume_is_exact(tmp_path):
    """A blob + host-mode run stopped inside a chained rslice dispatch,
    saved, restored and resumed equals the uninterrupted run bit for bit,
    blobs and ncall included.  The history file of the stopped run holds
    the uninterrupted run's first evaluations; pickling turns the history
    off, so the resumed run writes no more."""
    h5py = pytest.importorskip("h5py")
    full = _blob_host_sampler(str(tmp_path / "full.h5"))
    _quiet(full.run_nested, print_progress=False)
    s = _blob_host_sampler(str(tmp_path / "part.h5"))
    _quiet(s.run_nested, print_progress=False, maxiter=170,
           add_live=False)
    assert s._leftover is not None and s._leftover["blob"] is not None
    fname = str(tmp_path / "save.pkl")
    s.save(fname)
    with h5py.File(str(tmp_path / "part.h5"), "r") as fp:
        part = fp["evaluation_u"][:]
    del s
    s2 = dyt.NestedSampler.restore(fname)
    assert s2.blob and not s2.loglikelihood.save_evaluation_history
    _quiet(s2.run_nested, print_progress=False, resume=True)
    assert s2.timings["n_replay"] >= 1
    a, b = s2.results, full.results
    assert a.niter == b.niter and s2.ncall == full.ncall
    for k in ("logl", "logz", "logvol", "samples", "samples_u", "ncall",
              "samples_it"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert np.array_equal(_blobs(a), _blobs(b))
    assert np.array_equal(_blobs(a)[:, 0], a.logl)
    with h5py.File(str(tmp_path / "full.h5"), "r") as fp:
        assert len(fp["evaluation_logl"]) == full.ncall
        assert np.array_equal(fp["evaluation_u"][:len(part)], part)
    with h5py.File(str(tmp_path / "part.h5"), "r") as fp:
        assert len(fp["evaluation_u"]) == len(part)


def test_a_format_2_checkpoint_still_loads(tmp_path):
    """A checkpoint written before blobs and pools existed (format 2: no
    blob, pool or history state) restores with blobs off and resumes."""
    s = dyt.NestedSampler(plain_loglike, ptform, 2, nlive=60,
                          bound="single", sample="unif",
                          rstate=get_rstate(), queue_size=16, device="cpu")
    _quiet(s.run_nested, print_progress=False, maxiter=150, add_live=False)
    full = copy.deepcopy(s)
    old = pickle.loads(pickle.dumps(s))
    for k in ("blob", "live_blobs", "use_pool"):
        delattr(old, k)
    for k in ("blob", "use_pool_logl", "use_pool_ptform",
              "blob_shape_dtype", "ncall_launched",
              "save_evaluation_history", "history_filename", "save_every",
              "failed_save", "_history_buffer",
              "evaluation_history_counter"):
        delattr(old.loglikelihood, k)
    fname = str(tmp_path / "old.pkl")
    with open(fname, "wb") as fp:
        pickle.dump({"sampler": old, "version": dyt.__version__,
                     "format_version": 2}, fp)
    s2 = dyt.NestedSampler.restore(fname)
    assert checkpoint.FORMAT_VERSION == 3
    assert not s2.blob and s2.live_blobs is None and s2.pool is None
    assert not s2.loglikelihood.blob
    _quiet(s2.run_nested, print_progress=False, resume=True)
    _quiet(full.run_nested, print_progress=False, resume=True)
    assert np.array_equal(s2.results.logl, full.results.logl)
    assert s2.ncall == full.ncall
