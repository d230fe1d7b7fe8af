"""Tests of the port that need an NVIDIA GPU; each skips itself without
one.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from dynesty_tpu_torch.bounding import Bound
from dynesty_tpu_torch.ops import build
from dynesty_tpu_torch.ops import hopper_kernels as hk

from utils import get_rstate


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_call_without_build_raises(cuda, monkeypatch):
    monkeypatch.setenv("DYNESTY_TPU_TORCH_NO_BUILD", "1")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(hk, "_ENTRY", {})
    launches = hk.pairwise_min_dist.launches
    pts = torch.randn(64, 3, device=cuda)
    with pytest.raises(RuntimeError, match="disabled"):
        hk.pairwise_min_dist(pts)
    assert hk.pairwise_min_dist.launches == launches


def _points(shape, cuda, shift=0.0):
    return torch.from_numpy(
        (get_rstate().normal(size=shape) + shift).astype(np.float32)).to(cuda)


def _counts():
    k = hk.pairwise_min_dist
    return k.launches, k.launches_exact, k.launches_tc


def _check(cuda, shape, p=2, path=None, shift=0.0):
    """One call against the plain version; returns the path's launches."""
    pts = _points(shape, cuda, shift)
    before = _counts()
    got = hk.pairwise_min_dist(pts, p=p, path=path)
    torch.cuda.synchronize()
    after = _counts()
    ref = hk.pairwise_min_dist_plain(pts, p=p)
    # the exact path takes float32 differences in another order; the
    # tensor-core path re-ranks its candidate by exact differences
    assert torch.allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert after[0] == before[0] + 1
    return after[1] - before[1], after[2] - before[2]


# (4096, 100) and (2048, 65): any d runs through a kernel
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 3), (1000, 8), (129, 64), (2, 1),
                                   (4096, 100), (2048, 65)])
def test_cuda_kernel_matches_plain(cuda, shape):
    exact, tc = _check(cuda, shape)
    assert (exact, tc) == ((0, 1) if hk.kernel_path(*shape) == "tc"
                           else (1, 0))


# ragged N for each path, and both sides of the tensor-core switch point
@pytest.mark.cuda
@pytest.mark.parametrize("path", ["exact", "tc"])
@pytest.mark.parametrize("shape", [
    (2, 64), (129, 64), (2049, 64), (2049, 5), (300, hk.TC_MAX_D),
    (2048, 47), (2048, 48)])
def test_cuda_paths_match_plain(cuda, path, shape):
    exact, tc = _check(cuda, shape, path=path)
    assert (exact, tc) == ((1, 0) if path == "exact" else (0, 1))


# a cloud whose mean sits far from the origin, as whitened late-run live
# points do: the tensor-core path centres before its expansion
@pytest.mark.cuda
@pytest.mark.parametrize("path, shape", [("exact", (2048, 3)),
                                         ("tc", (4096, 64)),
                                         ("tc", (2049, 17))])
def test_cuda_shifted_cloud(cuda, path, shape):
    _check(cuda, shape, path=path, shift=50.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (129, 5), (2049, 3), (1000, 70)])
def test_cuda_linf_matches_plain(cuda, shape):
    assert _check(cuda, shape, p=math.inf) == (1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("p, path", [(2, "exact"), (2, "tc"),
                                     (math.inf, "exact")])
def test_cuda_kernel_deterministic(cuda, p, path):
    # column splits meet in atomicMin, whose result is order-free
    pts = _points((4096, 32), cuda)
    a = hk.pairwise_min_dist(pts, p=p, path=path)
    b = hk.pairwise_min_dist(pts, p=p, path=path)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_default_device(cuda):
    import dynesty_tpu_torch as dyt

    s = dyt.NestedSampler(lambda x: -0.5 * (x @ x), lambda u: 2.0 * u - 1.0,
                          2, nlive=64, bound="none", sample="rslice",
                          rstate=get_rstate(56432))
    assert s.device.type == "cuda"
    s.run_nested(print_progress=False, maxiter=100)
    assert np.isfinite(s.results.logz[-1])


@pytest.mark.cuda
def test_cuda_run_reproducible(cuda):
    import dynesty_tpu_torch as dyt

    cinv = torch.linalg.inv(torch.full((3, 3), 0.95, dtype=torch.float64,
                                       device=cuda) +
                            0.05 * torch.eye(3, dtype=torch.float64,
                                             device=cuda))
    runs = []
    for _ in range(2):
        s = dyt.NestedSampler(lambda x: -0.5 * (x @ cinv @ x),
                              lambda u: 10.0 * (2.0 * u - 1.0), 3,
                              nlive=256, bound="single", sample="rslice",
                              device=cuda, rstate=get_rstate(56432))
        s.run_nested(print_progress=False)
        runs.append(s.results)
    for key in ("logl", "logz", "ncall", "samples", "samples_n"):
        assert np.array_equal(runs[0][key], runs[1][key]), key


def _refit_stack():
    """A 3-ellipsoid stack (padded to 4) with expand, and live points that
    leave slot 2 with fewer than d+1 members."""
    from dynesty_tpu_torch.bounding import MultiEllipsoid

    rs = get_rstate(11)
    ctrs = np.array([[0.3, 0.3, 0.3], [0.7, 0.7, 0.7], [0.3, 0.8, 0.5]])
    mb = MultiEllipsoid(3, ctrs=ctrs, covs=np.array([np.eye(3) * 0.01] * 3))
    arrays = dict(mb.device_spec()[1], expand=1.1)
    u = np.vstack([ctrs[0] + 0.05 * rs.normal(size=(600, 3)),
                   ctrs[1] + 0.05 * rs.normal(size=(600, 3)),
                   ctrs[2] + 0.01 * rs.normal(size=(2, 3))])
    return u, arrays


@pytest.mark.cuda
def test_cuda_ellipsoid_refit_matches_cpu(cuda):
    from dynesty_tpu_torch.internal.kernels import make_ellipsoid_refit
    from dynesty_tpu_torch.utils.convert import bound_arrays_to_torch

    u, arrays = _refit_stack()
    refit = make_ellipsoid_refit(3)
    outs = [refit(torch.from_numpy(u).to(dev),
                  bound_arrays_to_torch("ellipsoids", arrays, dev))
            for dev in ("cpu", cuda)]
    for k in ("ctrs", "axes", "ams", "logvols"):
        np.testing.assert_allclose(outs[1][k].cpu().numpy(),
                                   outs[0][k].numpy(), rtol=1e-10, atol=0,
                                   err_msg=k)
    # the degenerate slot kept its host fit on the card too
    assert torch.equal(outs[1]["ctrs"][2].cpu(), outs[0]["ctrs"][2])


@pytest.mark.cuda
def test_cuda_ellipsoid_union_sampling_uniform(cuda):
    from dynesty_tpu_torch.bounding import MultiEllipsoid
    from dynesty_tpu_torch.internal.kernels import _sample_ellipsoid_union
    from dynesty_tpu_torch.utils.convert import bound_arrays_to_torch
    from dynesty_tpu_torch.utils.misc import torch_generator

    ctrs = np.array([[0.0, 0.0], [1.0, 0.0]])
    mb = MultiEllipsoid(2, ctrs=ctrs, covs=np.array([np.eye(2)] * 2))
    arrays = bound_arrays_to_torch("ellipsoids", mb.device_spec()[1], cuda)
    from dynesty_tpu_torch.ops.proposals import ellipsoid_forms_plain
    x, ua = _sample_ellipsoid_union(torch_generator(56432, cuda), arrays,
                                    40000, 2, torch.float64)
    sq = ellipsoid_forms_plain(x, arrays["ctrs"], arrays["ams"])
    # the union's overlap test, as unif_valid applies it, without the cube
    # check (these circles leave the cube)
    mask = arrays["mask"][None, :]
    nin = torch.where(((sq < 1.0) & mask).any(1), ((sq < 1.0) & mask).sum(1),
                      ((sq <= 1.0 + 1e-3) & mask).sum(1))
    valid = (nin > 0) & (ua < 1.0 / nin.clamp_min(1).to(ua.dtype))
    xs = x[valid].cpu().numpy()
    n = len(xs)
    d2 = ((xs[:, None, :] - ctrs) ** 2).sum(-1)
    assert np.all(d2.min(axis=1) < 1.0)
    left, right = np.sum(xs[:, 0] < 0.5), np.sum(xs[:, 0] > 0.5)
    assert abs(left - right) < 5 * np.sqrt(n)
    lens = 2 * np.arccos(0.5) - 0.5 * np.sqrt(3.0)
    p = lens / (2 * np.pi - lens)
    share = np.mean(np.all(d2 < 1.0, axis=1))
    assert abs(share - p) < 4 * np.sqrt(p * (1 - p) / n)


@pytest.mark.cuda
def test_cuda_default_arguments_pass_the_gate(cuda):
    import dynesty_tpu_torch as dyt

    cinv = torch.linalg.inv(torch.full((3, 3), 0.95, dtype=torch.float64,
                                       device=cuda) +
                            0.05 * torch.eye(3, dtype=torch.float64,
                                             device=cuda))
    lnorm = -0.5 * (3 * math.log(2 * math.pi) +
                    math.log(np.linalg.det(cinv.inverse().cpu().numpy())))
    s = dyt.NestedSampler(lambda x: -0.5 * (x @ cinv @ x) + lnorm,
                          lambda u: 10.0 * (2.0 * u - 1.0), 3, nlive=500,
                          rstate=get_rstate(56432))
    assert s.device.type == "cuda"
    assert s.internal_sampler_next.name == "unif" and s.bound_bootstrap == 5
    s.run_nested(print_progress=False)
    res = s.results
    assert abs(res.logz[-1] + 8.987) < 4 * res.logzerr[-1]


# --------------------------------------------------------------------------
# the remaining proposal kernels and resume


def normal_loglike(x):  # module level: a sampler over it pickles
    return -0.5 * (x @ x)


def box_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rwalk", "slice", "rslice-doubling"])
def test_cuda_kernel_uniformity(cuda, kind):
    """The distributional gate of tests/test_sampling.py on the card:
    chains inside a diamond stay uniform."""
    from scipy.stats import kstest

    from dynesty_tpu_torch.internal.kernels import (make_rwalk_round,
                                                    make_slice_round)
    from dynesty_tpu_torch.internal.likelihood import LogLikelihood
    from dynesty_tpu_torch.utils.misc import Timings, torch_generator

    def loglike(x):
        inside = (x[0] - 0.5).abs() + (x[1] - 0.5).abs() < 0.5
        return torch.where(inside, 0.0, -torch.inf).to(x.dtype)

    q = 512
    like = LogLikelihood(loglike, lambda u: u, 2, device=cuda)
    like.eval_host(np.full((2, 2), 0.5))
    rstate = get_rstate()
    starts = []
    while len(starts) < q:
        pts = rstate.random((4 * q, 2))
        ok = np.abs(pts[:, 0] - 0.5) + np.abs(pts[:, 1] - 0.5) < 0.5
        starts.extend(pts[ok][:q - len(starts)])
    u = np.array(starts)
    v, logl = u.copy(), np.zeros(q)
    axes = np.tile(np.eye(2) * 0.5, (q, 1, 1))
    timings = Timings()
    if kind == "rwalk":
        fn = make_rwalk_round(like, ndim=2, ncdim=2, q=q, walks=20,
                              dtype=torch.float64, device=cuda)
    else:
        name, _, doubling = kind.partition("-")
        fn = make_slice_round(like, ndim=2, q=q, slices=3, kind=name,
                              doubling=bool(doubling), dtype=torch.float64,
                              device=cuda, timings=timings)
    for _ in range(3):
        packed_in = torch.from_numpy(np.concatenate(
            [u, v, logl[:, None], axes.reshape(q, -1)], axis=1)).to(cuda)
        gen = torch_generator(int(rstate.integers(2**63)), cuda)
        packed = fn(gen, packed_in, None, 1.0, -0.5)[0]
        assert packed.device.type == "cuda"
        packed = packed.cpu().numpy()
        u, v, logl = packed[:, :2], packed[:, 2:4], packed[:, 4]
    assert np.all(np.abs(u[:, 0] - 0.5) + np.abs(u[:, 1] - 0.5) < 0.5)
    a = (u[:, 0] - 0.5) + (u[:, 1] - 0.5)
    b = (u[:, 0] - 0.5) - (u[:, 1] - 0.5)
    for coord in (a, b):
        assert kstest(coord + 0.5, "uniform").pvalue > 1e-4
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.15
    assert ("sync_slice" in timings) == (kind != "rwalk")


@pytest.mark.cuda
@pytest.mark.parametrize("bound, sample", [("single", "rwalk"),
                                           ("balls", "slice"),
                                           ("multi", "unif")])
def test_cuda_resume_bit_identical(cuda, bound, sample, tmp_path):
    """A run stopped on the card, saved, restored and resumed equals its
    uninterrupted twin bit for bit."""
    import dynesty_tpu_torch as dyt

    def sampler():
        return dyt.NestedSampler(normal_loglike, box_ptform, 3, nlive=200,
                                 bound=bound, sample=sample, queue_size=64,
                                 rstate=get_rstate(56432))

    full = sampler()
    full.run_nested(print_progress=False)
    s = sampler()
    s.run_nested(print_progress=False, maxiter=700, add_live=False)
    fname = str(tmp_path / "cuda.pkl")
    s.save(fname)
    del s
    s2 = dyt.NestedSampler.restore(fname)
    assert s2.device.type == "cuda"
    s2.run_nested(print_progress=False, resume=True)
    assert s2.timings["n_replay"] >= 1
    a, b = s2.results, full.results
    assert a.niter == b.niter and s2.ncall == full.ncall
    for k in ("logl", "logz", "samples", "ncall", "samples_u", "scale"):
        assert np.array_equal(a[k], b[k]), k
    # the same checkpoint goes on on the CPU when asked to
    s3 = dyt.NestedSampler.restore(fname, device="cpu")
    assert s3.device.type == "cpu"
    s3.run_nested(print_progress=False, resume=True)
    assert abs(s3.results.logz[-1] - b.logz[-1]) < \
        4 * np.hypot(s3.results.logzerr[-1], b.logzerr[-1])


def test_restore_of_a_cuda_checkpoint_needs_cuda(tmp_path, monkeypatch):
    """Runs without a card: a checkpoint whose device is 'cuda' raises
    where CUDA is absent, and restores on the CPU only when asked to."""
    import dynesty_tpu_torch as dyt

    s = dyt.NestedSampler(normal_loglike, box_ptform, 3, nlive=100,
                          bound="single", sample="rslice", queue_size=32,
                          device="cpu", rstate=get_rstate(56432))
    s.run_nested(print_progress=False, maxiter=450, add_live=False)
    it = s.it
    # as a run on the card would have written it: the device by name
    s.set_device("cpu")
    s.device = s.loglikelihood.device = torch.device("cuda")
    fname = str(tmp_path / "cuda.pkl")
    s.save(fname)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dyt.NestedSampler.restore(fname)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dyt.NestedSampler.restore(fname, device="cuda:0")
    s2 = dyt.NestedSampler.restore(fname, device="cpu")
    assert s2.device == s2.loglikelihood.device == torch.device("cpu")
    assert s2.it == it
    s2.run_nested(print_progress=False, resume=True)
    res = s2.results
    assert np.isfinite(res.logz[-1]) and res.niter > it


def _dynamic(**kw):
    import dynesty_tpu_torch as dyt

    return dyt.DynamicNestedSampler(normal_loglike, box_ptform, 3,
                                    bound="multi", sample="unif",
                                    queue_size=64, rstate=get_rstate(56432),
                                    **kw)


_DYN_RUN = dict(nlive_init=200, nlive_batch=100, maxbatch=2,
                print_progress=False)
# the normal above is not normalised
_DYN_TRUTH = 1.5 * math.log(2.0 * math.pi) - 3 * math.log(20.0)


@pytest.mark.cuda
def test_cuda_dynamic_run_reproducible(cuda):
    """A small dynamic run on the card (the default device) passes the
    evidence gate, and the same seed gives the same run twice."""
    runs = []
    for _ in range(2):
        d = _dynamic()
        assert d.device.type == "cuda"
        d.run_nested(**_DYN_RUN)
        assert d.sampler.device.type == "cuda"
        runs.append(d)
    a, b = runs[0].results, runs[1].results
    assert a.isdynamic() and runs[0].batch == 2
    assert len(a.batch_nlive) == 3 and np.ptp(a.samples_n) > 0
    assert abs(a.logz[-1] - _DYN_TRUTH) < 5 * a.logzerr[-1]
    assert a.niter == b.niter and runs[0].ncall == runs[1].ncall
    for k in ("logl", "logz", "samples", "samples_batch", "ncall",
              "batch_logl_bounds"):
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.cuda
def test_cuda_dynamic_friends_batch_reaches_the_kernel(cuda):
    """A dynamic run over RadFriends with 2048 live points refits through
    the NN-distance kernel in the base run and in its batch."""
    import dynesty_tpu_torch as dyt

    d = dyt.DynamicNestedSampler(normal_loglike, box_ptform, 3, nlive=2048,
                                 bound="balls", sample="rslice",
                                 rstate=get_rstate(56432))
    d.run_nested(maxiter_init=4000, maxbatch=0, print_progress=False)
    before = hk.pairwise_min_dist.launches_exact
    assert before >= 1
    d.add_batch(nlive=2048, maxiter=2048 + 600, print_progress=False)
    assert hk.pairwise_min_dist.launches_exact > before


@pytest.mark.cuda
def test_cuda_dynamic_resume_bit_identical(cuda, tmp_path):
    """A dynamic run stopped inside a batch on the card, saved, restored
    (onto the card, and onto the CPU when asked) and resumed."""
    import dynesty_tpu_torch as dyt

    full = _dynamic()
    full.run_nested(**_DYN_RUN)
    d = _dynamic()
    d.run_nested(**dict(_DYN_RUN, maxbatch=0))
    d.add_batch(nlive=100, maxiter=100 + 40, print_progress=False)
    assert d.batch_sampler is not None and d.batch == 0
    fname = str(tmp_path / "dyn.pkl")
    d.save(fname)
    del d
    d2 = dyt.DynamicNestedSampler.restore(fname)
    assert {x.device.type for x in (d2, d2.sampler, d2.batch_sampler,
                                    d2.loglikelihood)} == {"cuda"}
    d2.run_nested(resume=True, **_DYN_RUN)
    a, b = d2.results, full.results
    assert a.niter == b.niter and d2.ncall == full.ncall and d2.batch == 2
    for k in ("logl", "logz", "samples", "samples_batch", "ncall",
              "batch_logl_bounds", "scale"):
        assert np.array_equal(a[k], b[k]), k
    d3 = dyt.DynamicNestedSampler.restore(fname, device="cpu")
    assert {x.device.type for x in (d3, d3.sampler, d3.batch_sampler,
                                    d3.loglikelihood)} == {"cpu"}
    d3.run_nested(resume=True, **_DYN_RUN)
    assert d3.batch == 2
    assert abs(d3.results.logz[-1] - _DYN_TRUTH) < \
        5 * d3.results.logzerr[-1]


def test_restore_of_a_cuda_dynamic_checkpoint_needs_cuda(tmp_path,
                                                         monkeypatch):
    """Runs without a card: a dynamic checkpoint whose device is 'cuda',
    with a batch suspended in it, raises where CUDA is absent, and
    restores on the CPU, base and batch sampler alike, when asked to."""
    import dynesty_tpu_torch as dyt

    d = _dynamic(device="cpu")
    d.run_nested(**dict(_DYN_RUN, maxbatch=0))
    d.add_batch(nlive=100, maxiter=100 + 40, print_progress=False)
    assert d.batch_sampler is not None
    # as a run on the card would have written it: the devices by name
    for x in (d, d.sampler, d.batch_sampler, d.loglikelihood):
        x.device = torch.device("cuda")
    fname = str(tmp_path / "dyn.pkl")
    d.save(fname)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dyt.DynamicNestedSampler.restore(fname)
    d2 = dyt.DynamicNestedSampler.restore(fname, device="cpu")
    assert {x.device.type for x in (d2, d2.sampler, d2.batch_sampler,
                                    d2.loglikelihood)} == {"cpu"}
    d2.run_nested(resume=True, **_DYN_RUN)
    assert d2.batch == 2 and d2.batch_sampler is None
    assert abs(d2.results.logz[-1] - _DYN_TRUTH) < \
        5 * d2.results.logzerr[-1]


def blob_normal_loglike(x):
    logl = normal_loglike(x)
    return logl, torch.stack([logl, x[0]])


def np_normal_loglike(x):
    return -0.5 * float(np.dot(x, x))


def np_box_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("sample", ["unif", "rwalk", "rslice"])
def test_cuda_blob_belongs_to_its_point(cuda, sample):
    """On the card every sample's blob is its own ``(logl, v[0])``, and a
    blob changes no proposal."""
    import dynesty_tpu_torch as dyt

    runs = []
    for loglike, blob in ((normal_loglike, False),
                          (blob_normal_loglike, True)):
        s = dyt.NestedSampler(loglike, box_ptform, 3, nlive=200,
                              bound="single", sample=sample, queue_size=64,
                              blob=blob, rstate=get_rstate(56432))
        s.run_nested(print_progress=False)
        runs.append(s)
    a, b = runs[0].results, runs[1].results
    blobs = np.array([np.asarray(x) for x in b.blob])
    assert np.array_equal(blobs[:, 0], b.logl)
    assert np.array_equal(blobs[:, 1], b.samples[:, 0])
    for k in ("logl", "samples", "ncall"):
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.cuda
def test_cuda_host_mode_evaluates_only_the_counted_lanes(cuda):
    from dynesty_tpu_torch.internal.likelihood import LogLikelihood

    calls = []

    def counted(x):
        calls.append(x)
        return np_normal_loglike(x), np.array([1.0, x[0]])

    like = LogLikelihood(counted, np_box_ptform, 3, device="cuda",
                         mode="host", blob=True)
    like.eval_host(np.full((2, 3), 0.5))
    calls.clear()
    u = torch.rand((64, 3), dtype=torch.float64, device=cuda)
    mask = torch.rand(64, device=cuda) < 0.5
    v, logl, blob = like.batch_eval(u, mask=mask)
    assert v.device.type == logl.device.type == blob.device.type == "cuda"
    assert len(calls) == int(mask.sum())
    assert torch.all(logl[~mask] == -math.inf)
    assert torch.equal(blob[mask, 1], v[mask, 0])


@pytest.mark.cuda
def test_cuda_blob_host_mode_resume_bit_identical(cuda, tmp_path):
    """A blob + host-mode run on the card stopped, saved, restored and
    resumed equals its uninterrupted twin, blobs included."""
    import dynesty_tpu_torch as dyt

    def sampler():
        return dyt.NestedSampler(_np_blob_loglike, np_box_ptform, 3,
                                 nlive=200, bound="balls", sample="rslice",
                                 queue_size=64, blob=True,
                                 likelihood_mode="host",
                                 rstate=get_rstate(56432))

    full = sampler()
    full.run_nested(print_progress=False)
    s = sampler()
    s.run_nested(print_progress=False, maxiter=700, add_live=False)
    fname = str(tmp_path / "cuda_host.pkl")
    s.save(fname)
    s2 = dyt.NestedSampler.restore(fname)
    assert s2.device.type == "cuda"
    s2.run_nested(print_progress=False, resume=True)
    a, b = s2.results, full.results
    assert a.niter == b.niter and s2.ncall == full.ncall
    for k in ("logl", "logz", "samples", "ncall", "scale"):
        assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(np.array(a.blob), np.array(b.blob))


def _np_blob_loglike(x):
    logl = np_normal_loglike(x)
    return logl, np.array([logl, x[0]])


# --------------------------------------------------------------------------
# a user's bound


class CardBox(Bound):
    """An axis-aligned box around the live points, sampled on the host
    (module level, so that a sampler over it pickles)."""

    def __init__(self, ndim):
        super().__init__(ndim)
        self.cen = np.zeros(ndim) + 0.5
        self.size = 0.5

    def contains(self, x):
        return bool((np.abs(x - self.cen) < self.size).all())

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


def _box_sampler(device=None):
    import dynesty_tpu_torch as dyt

    kw = {} if device is None else {"device": device}
    return dyt.NestedSampler(normal_loglike, box_ptform, 3, nlive=200,
                             bound=CardBox(3), sample="unif",
                             queue_size=64, rstate=get_rstate(56432), **kw)


@pytest.mark.cuda
def test_cuda_custom_bound_run_reproducible(cuda):
    runs = []
    for _ in range(2):
        s = _box_sampler()
        assert s.device.type == "cuda"
        s.run_nested(print_progress=False)
        assert s.device_bound_kind() == "custom"
        runs.append(s)
    a, b = runs[0].results, runs[1].results
    assert a.niter == b.niter and runs[0].ncall == runs[1].ncall
    for k in ("logl", "logz", "samples", "ncall"):
        assert np.array_equal(a[k], b[k]), k
    truth = 1.5 * math.log(2.0 * math.pi) - 3 * math.log(20.0)
    assert abs(a.logz[-1] - truth) < 4 * a.logzerr[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("device", [None, "cpu"])
def test_cuda_custom_bound_resume_bit_identical(cuda, device, tmp_path):
    """custom-unif stopped, saved, restored and resumed equals the
    uninterrupted run bit for bit: on the card, and on the CPU
    (``device='cpu'``) for a run made there."""
    import dynesty_tpu_torch as dyt

    full = _box_sampler(device)
    full.run_nested(print_progress=False)
    s = _box_sampler(device)
    s.run_nested(print_progress=False, maxiter=full.results.niter // 2,
                 add_live=False)
    assert s.interrupted_budget
    fname = str(tmp_path / "box.pkl")
    s.save(fname)
    del s
    s2 = dyt.NestedSampler.restore(fname, device=device)
    assert s2.device.type == (device or "cuda")
    s2.run_nested(print_progress=False, resume=True)
    a, b = s2.results, full.results
    assert a.niter == b.niter and s2.ncall == full.ncall
    for k in ("logl", "logz", "samples", "ncall", "samples_u", "scale"):
        assert np.array_equal(a[k], b[k]), k
    for x, y in zip(a.bound[1:], b.bound[1:]):
        assert np.array_equal(x.cen, y.cen) and x.size == y.size


# --------------------------------------------------------------------------
# models and the mesh on the card

_CARD_PROBLEMS = [("CorrelatedGaussian", {"ndim": 3}), ("Eggbox", {}),
                  ("GaussianShells", {}), ("Rosenbrock", {"ndim": 5}),
                  ("WeddingCake", {}), ("LogGamma", {"ndim": 5})]


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", _CARD_PROBLEMS,
                         ids=[n for n, _ in _CARD_PROBLEMS])
def test_cuda_models_match_cpu(cuda, name, kw):
    """Each problem on the card against the CPU at 1e-12 relative (the
    card's transcendental functions differ from the host's by ulps), its
    constants made on the card; the wedding cake's centre reads -0.0."""
    from dynesty_tpu_torch import models

    prob = getattr(models, name)(**kw)
    u = torch.as_tensor(get_rstate().random((1000, prob.ndim)))
    u[0] = 0.5
    f = torch.func.vmap(lambda x: prob.loglike(prob.ptform(x)))
    want = f(u)
    got = f(u.to(cuda))
    assert got.device.type == "cuda"
    assert torch.allclose(got.cpu(), want, rtol=1e-12, atol=0)
    # a problem with constants made them on the card too
    assert all(any(k[1].type == "cuda" for k in consts)
               for consts in [getattr(prob, "_consts", None)] if consts)
    if name == "WeddingCake":
        assert got[0].item() == 0.0 and torch.signbit(got[0]).item()


@pytest.mark.cuda
def test_cuda_priors_match_cpu(cuda):
    from dynesty_tpu_torch import models
    from dynesty_tpu_torch.models.priors import _betainc

    pt = models.PriorTransform([
        models.TopHat(-5.0, 5.0), models.Normal(1.0, 2.0),
        models.ClippedNormal(0.0, 1.0, -1.0, 2.0),
        models.LogNormal(0.0, 0.5), models.LogUniform(1e-3, 1e3),
        models.Beta(2.0, 5.0)])
    u = torch.as_tensor(get_rstate().random((4096, 6)))
    want = torch.func.vmap(pt)(u)
    got = torch.func.vmap(pt)(u.to(cuda)).cpu()
    assert torch.allclose(got[:, :5], want[:, :5], rtol=1e-12, atol=0)
    assert (got[:, 5] - want[:, 5]).abs().max().item() < 1e-8
    x = torch.linspace(1e-6, 1 - 1e-6, 1001, dtype=torch.float64)
    for a, b in [(0.5, 0.5), (2.0, 5.0), (30.0, 1.0)]:
        diff = _betainc(a, b, x.to(cuda)).cpu() - _betainc(a, b, x)
        assert diff.abs().max().item() < 1e-12


def _mesh_sampler(mesh):
    import dynesty_tpu_torch as dyt

    return dyt.NestedSampler(normal_loglike, box_ptform, 3, nlive=200,
                             bound="single", sample="rslice", queue_size=64,
                             rstate=get_rstate(56432), mesh=mesh)


@pytest.mark.cuda
def test_cuda_mesh_of_one_device_equals_no_mesh(cuda):
    """``mesh=make_mesh()`` on one card gives the run without a mesh bit
    for bit, every lane on the card; a mesh of more devices than the
    machine has raises."""
    from dynesty_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n + 1)
    mesh = make_mesh(1)
    runs = []
    for m in (mesh, None):
        s = _mesh_sampler(m)
        s.run_nested(print_progress=False)
        runs.append(s)
    a, b = runs[0].results, runs[1].results
    assert a.niter == b.niter and runs[0].ncall == runs[1].ncall
    for k in ("logl", "logz", "samples", "ncall", "scale"):
        assert np.array_equal(a[k], b[k]), k
    sh = runs[0].last_proposals_sharding
    q = runs[0].queue_size
    assert sh.shard_shape((q, 11)) == (q, 11)
    assert set(sh.device_of_lane((q, 11))) == {torch.device("cuda", 0)}


@pytest.mark.cuda
def test_cuda_scaling_report(cuda):
    from dynesty_tpu_torch.parallel import scaling_report

    rep = scaling_report(normal_loglike, 3, q=4096, sizes=(1,), reps=5,
                         chain=4, rstate=get_rstate())
    assert len(rep) == 1 and rep[0]["n_devices"] == 1
    assert rep[0]["platform"] == "gpu" and rep[0]["partitioned"]
    assert np.isfinite(rep[0]["evals_per_s"]) and rep[0]["evals_per_s"] > 0
