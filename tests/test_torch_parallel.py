"""The port's device mesh on the CPU: the cases of ``tests/test_parallel.py``
re-stated on ``make_mesh(devices=["cpu"] * 8)``, the counterpart of the JAX
package's 8-device virtual CPU mesh.  A mesh splits each batched
likelihood call by lane over its devices and gathers the lanes back in
order; every other op of a round runs on the mesh's first device.

Tolerances are the JAX package's: a run under the mesh against the run
without it has equal ``ncall`` and record count, ``logl`` at 1e-10 and
``logz`` at 1e-8 relative (here they are in fact equal: each lane's
likelihood is the same arithmetic whichever chunk holds it), and a
restored run under a mesh is bit-identical to the uninterrupted one.
``__graft_entry__.py`` (the JAX package's driver entry, ``test_graft_entry``)
has no counterpart: ``chip_smoke.py`` takes its place.
"""

import warnings

import numpy as np
import pytest
import torch

import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.bounding import Bound
from dynesty_tpu_torch.parallel import (batch_sharding, make_mesh,
                                        scaling_report, shard_batch)
from dynesty_tpu_torch.parallel.mesh import Mesh, mesh_eval

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
LOGZ_TRUTH = NDIM * (-np.log(20.0))

_COV = np.identity(NDIM)
_COV[_COV == 0] = 0.95
_CINV = torch.as_tensor(np.linalg.inv(_COV))
_LNORM = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(_COV)))


def gau_loglike(x):
    return -0.5 * (x @ _CINV.to(x.device) @ x) + _LNORM


def gau_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def blob_loglike(x):
    logl = gau_loglike(x)
    return logl, 2.0 * logl


def _mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def test_mesh_helpers():
    mesh = _mesh()
    assert mesh.size == 8 and mesh.axis_names == ("q",)
    assert mesh == _mesh() and mesh != _mesh(4)
    x = np.arange(64, dtype=np.float64).reshape(16, 4)
    chunks, sh = shard_batch(mesh, x)
    assert sh == batch_sharding(mesh, 2) and sh != batch_sharding(mesh, 1)
    assert sh.shard_shape((16, 4)) == (2, 4)
    assert [c.shape for c in chunks] == [(2, 4)] * 8
    assert all(c.device == d for c, d in zip(chunks, mesh.devices))
    assert np.array_equal(torch.cat(chunks).numpy(), x)
    with pytest.raises(ValueError, match="divide"):
        shard_batch(mesh, np.zeros((12, 4)))
    # lane order through the split, blob trees and None leaves included
    u = torch.arange(40, dtype=torch.float64).reshape(20, 2)
    out = mesh_eval(mesh, lambda c: (2 * c, {"s": c.sum(1)}, None), u)
    assert torch.equal(out[0], 2 * u) and torch.equal(out[1]["s"],
                                                      u.sum(1))
    assert out[2] is None
    one = make_mesh(devices=["cpu"])
    assert mesh_eval(one, lambda c: c, u) is u
    assert Mesh(["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scaling_report(gau_loglike, NDIM, q=8)
    # the mesh's first device is the sampler's
    with pytest.raises(ValueError, match="first device"):
        dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=50,
                          device="cpu", mesh=make_mesh(devices=["meta"]))
    with pytest.raises(TypeError, match="Mesh"):
        dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=50,
                          device="cpu", mesh="a mesh")


def test_sharded_run():
    # a full static fit with the proposal batch split over 8 devices
    sampler = dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=150,
                                bound="single", sample="rwalk",
                                rstate=get_rstate(), queue_size=32,
                                mesh=_mesh(), device="cpu")
    sampler.run_nested(print_progress=False)
    res = sampler.results
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 5 * res.logzerr[-1]


@pytest.mark.parametrize("sample,bound,blob",
                         [("unif", "single", False),
                          ("rslice", "single", False),
                          ("rwalk", "single", False),
                          ("unif", "multi", False),
                          ("rslice", "single", True),
                          ("slice", "single", False),
                          ("unif", "balls", False),
                          ("unif", "cubes", False),
                          ("rwalk", "multi", False)])
def test_mesh_equivalence(sample, bound, blob):
    """An 8-device split run must reproduce the 1-device run: same RNG
    stream, same proposals, same records, across kernels, multi-ellipsoid
    bounds and blobs."""
    results = {}
    for m in (_mesh(), None):
        sampler = dyt.NestedSampler(
            blob_loglike if blob else gau_loglike, gau_ptform, NDIM,
            nlive=200, bound=bound, sample=sample, blob=blob,
            rstate=get_rstate(), queue_size=64, mesh=m, device="cpu")
        _quiet(sampler.run_nested, print_progress=False, maxiter=500,
               add_live=False)
        results["mesh" if m else "single"] = sampler.results
    rm, rs = results["mesh"], results["single"]
    assert int(np.sum(rm.ncall)) == int(np.sum(rs.ncall))
    assert len(rm.logl) == len(rs.logl)
    assert np.allclose(rm.logl, rs.logl, rtol=1e-10)
    assert np.allclose(rm.logz[-1], rs.logz[-1], rtol=1e-8)
    if blob:
        bm = np.asarray(rm.blob, dtype=np.float64)
        bs = np.asarray(rs.blob, dtype=np.float64)
        assert np.allclose(bm, bs, rtol=1e-10)


class BoxBound(Bound):
    """Host-only custom bound (no device_spec override)."""

    def __init__(self, ndim):
        super().__init__(ndim)

    def contains(self, x):
        return True

    def samples(self, n, rstate=None):
        return rstate.random((n, NDIM))

    def get_random_axes(self, rstate):
        return np.eye(NDIM)

    def update(self, points, **kwargs):
        pass


def test_mesh_rejects_host_mode():
    """A host-mode likelihood and unif over a host-sampled bound have no
    meaning on a split lane axis: both factories refuse them."""
    mesh = _mesh()

    def np_loglike(x):
        return -0.5 * float(np.dot(x, x))

    for factory in (dyt.NestedSampler, dyt.DynamicNestedSampler):
        with pytest.raises(ValueError, match="host"):
            factory(np_loglike, gau_ptform, NDIM, nlive=100,
                    bound="single", sample="unif", likelihood_mode="host",
                    rstate=get_rstate(), queue_size=16, mesh=mesh,
                    device="cpu")
        with pytest.raises(ValueError, match="custom"):
            factory(gau_loglike, gau_ptform, NDIM, nlive=100,
                    bound=BoxBound(NDIM), sample="unif",
                    rstate=get_rstate(), queue_size=16, mesh=mesh,
                    device="cpu")
    # a mesh of one device splits nothing and refuses nothing
    s = dyt.NestedSampler(np_loglike, gau_ptform, NDIM, nlive=100,
                          bound="single", sample="unif",
                          likelihood_mode="host", rstate=get_rstate(),
                          queue_size=16, mesh=_mesh(1), device="cpu")
    assert s.mesh.size == 1


def test_mesh_compute_is_partitioned():
    """The round's lanes are split over the mesh: each device evaluates
    q / n_devices lanes of every batch, and the sampler reports the split
    of the proposal block."""
    mesh = _mesh()
    sampler = dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=200,
                                bound="single", sample="rslice",
                                rstate=get_rstate(), queue_size=64,
                                mesh=mesh, device="cpu")
    _quiet(sampler.run_nested, print_progress=False, maxiter=200,
           add_live=False)
    sh = sampler.last_proposals_sharding
    assert sh == batch_sharding(mesh, 2) and sh.spec == ("q", None)
    q = sampler.queue_size * sampler.rounds_per_dispatch
    assert sh.shard_shape((q, 11))[0] == q // 8
    # the chunks the user's function saw (vectorized mode: whole chunks)
    seen = []

    def vec_loglike(x):
        seen.append(x.shape[0])
        return -0.5 * torch.einsum("ni,ij,nj->n", x, _CINV, x) + _LNORM

    def vec_ptform(u):
        return 10.0 * (2.0 * u - 1.0)

    vs = dyt.NestedSampler(vec_loglike, vec_ptform, NDIM, nlive=200,
                           bound="single", sample="rslice",
                           likelihood_mode="vectorized", rstate=get_rstate(),
                           queue_size=64, mesh=mesh, device="cpu")
    seen.clear()
    _quiet(vs.run_nested, print_progress=False, maxiter=200,
           add_live=False)
    calls = np.asarray(seen).reshape(-1, 8)  # eight chunks a batch
    assert len(calls) > 10 and np.all(calls == vs.queue_size // 8)


def test_mesh_queue_divisibility():
    # the queue width is rounded to a multiple of the mesh size
    sampler = dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=100,
                                bound="single", sample="rwalk",
                                rstate=get_rstate(), queue_size=35,
                                mesh=_mesh(), device="cpu")
    assert sampler.queue_size % 8 == 0
    assert sampler._q_narrow % 8 == 0


def test_scaling_report():
    # the telemetry must really split the batch at every mesh size and
    # produce finite throughput numbers (on one host: no scaling)
    rep = scaling_report(gau_loglike, NDIM, q=256, sizes=(1, 4, 8),
                         devices=["cpu"] * 8, reps=3, chain=2,
                         rstate=get_rstate())
    assert [r["n_devices"] for r in rep] == [1, 4, 8]
    for r in rep:
        assert r["partitioned"] and r["platform"] == "cpu"
        assert np.isfinite(r["evals_per_s"]) and r["evals_per_s"] > 0
    assert rep[0]["speedup"] == 1.0
    with pytest.raises(ValueError, match="divisible"):
        scaling_report(gau_loglike, NDIM, q=250, sizes=(8,),
                       devices=["cpu"] * 8, reps=1, chain=1)


def test_mesh_dynamic_equivalence():
    """The dynamic layer hands the mesh to the base run and every batch
    sampler; an 8-device dynamic run must reproduce the 1-device run."""
    results = {}
    for m in (_mesh(), None):
        sampler = dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM,
                                           bound="multi", sample="unif",
                                           rstate=get_rstate(),
                                           queue_size=64, mesh=m,
                                           device="cpu")
        # widths chosen so every queue clamp lands on a multiple of the
        # mesh size: the split run then consumes the identical RNG stream
        _quiet(sampler.run_nested, print_progress=False, nlive_init=160,
               nlive_batch=64, maxbatch=2, dlogz_init=1.0)
        results["mesh" if m else "single"] = sampler.results
        if m is not None:
            assert sampler.sampler.mesh is m
            assert sampler.loglikelihood.mesh is m
    rm, rs = results["mesh"], results["single"]
    assert len(rm.logl) == len(rs.logl)
    assert np.allclose(rm.logl, rs.logl, rtol=1e-10)
    assert np.allclose(rm.logz[-1], rs.logz[-1], rtol=1e-8)
    assert int(np.sum(rm.ncall)) == int(np.sum(rs.ncall))
    assert np.array_equal(rm.samples_batch, rs.samples_batch)


def test_mesh_restore(tmp_path):
    """Meshes are process-local and never pickled; restore(mesh=...) must
    re-attach one and finish bit-identically to an uninterrupted split
    run, and a non-divisible mesh must be rejected."""

    def _sampler(queue_size=64):
        return dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=200,
                                 bound="single", sample="unif",
                                 rstate=get_rstate(), queue_size=queue_size,
                                 mesh=_mesh(), device="cpu")

    full = _sampler()
    full.run_nested(print_progress=False)

    part = _sampler()
    _quiet(part.run_nested, maxiter=400, add_live=False,
           print_progress=False)
    fname = str(tmp_path / "mesh.save")
    part.save(fname)

    with pytest.raises(ValueError, match="divide"):
        dyt.NestedSampler.restore(fname, mesh=_mesh(3))

    # a mesh whose size divides queue_size but NOT the pickled endgame
    # width (_q_narrow) must be rejected too: a bracketed batch
    # dispatches the narrow width directly
    n48 = _sampler(queue_size=48)
    assert n48.queue_size % 3 == 0 and n48._q_narrow % 3 != 0
    fname48 = str(tmp_path / "mesh48.save")
    n48.save(fname48)
    with pytest.raises(ValueError, match="_q_narrow"):
        dyt.NestedSampler.restore(fname48, mesh=_mesh(3))

    plain = dyt.NestedSampler.restore(fname)
    assert plain.mesh is None and plain.loglikelihood.mesh is None
    resumed = dyt.NestedSampler.restore(fname, mesh=_mesh())
    assert resumed.mesh is not None
    assert resumed.loglikelihood.mesh is resumed.mesh
    resumed.run_nested(resume=True, print_progress=False)
    rf, rr = full.results, resumed.results
    assert np.array_equal(rf.logl, rr.logl)
    assert rf.logz[-1] == rr.logz[-1]
    assert int(np.sum(rf.ncall)) == int(np.sum(rr.ncall))
    assert np.array_equal(rf.samples, rr.samples)
    assert np.array_equal(rf.scale, rr.scale)
    # the dynamic sampler takes a mesh on restore too
    d = dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM,
                                 bound="single", sample="unif",
                                 rstate=get_rstate(), queue_size=64,
                                 mesh=_mesh(), device="cpu")
    _quiet(d.run_nested, nlive_init=80, maxbatch=0, print_progress=False)
    dname = str(tmp_path / "dyn.save")
    d.save(dname)
    back = dyt.DynamicNestedSampler.restore(dname, mesh=_mesh())
    assert back.mesh.size == 8 and back.sampler.mesh is back.mesh
    assert dyt.DynamicNestedSampler.restore(dname).mesh is None
