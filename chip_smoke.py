"""Smoke test of the PyTorch/CUDA port (``dynesty_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--out results.json] [--profile [balls|heavy]]

Phases, in order; any failure raises and exits non-zero:

1. Require CUDA; print the card's name and power limit, the torch/CUDA
   versions, and build the CUDA kernels from ``dynesty_tpu_torch/csrc``.
2. Compare each kernel path with its plain PyTorch version on the card at
   the shapes the main path gives it and beyond (a shifted cloud, as
   whitened late-run live points look, and p=inf among them), timing the
   kernel, the plain version and a library yardstick with CUDA events.
3. Drive the main path: ``NestedSampler(nlive=2048, bound='balls',
   sample='rslice')`` on the card's default device, on the 3-D correlated
   Gaussian (rho = 0.95, prior box +-10, seed 56432), with every kernel's
   launch count zeroed just before and read just after; check the
   evidence against the analytic -8.987 and that the exact L2 path ran.
4. The same drive with ``bound='cubes'``: the exact L-inf path must run.
5. A friends refit (``RadFriends.update``) of a live set at the
   tensor-core path's switch point: the tensor-core path must run.
6. A drive with ``bound='single'`` (nlive=500): no kernel may run.
7. The default path at the JAX package's heavy-bench width:
   ``NestedSampler(nlive=3000, bound='multi', sample='unif',
   queue_size=256, rounds_per_dispatch=12)`` on the 3-D correlated
   Gaussian plus a float32 tanh matvec chain (width 256, depth 384,
   weights from seed 1234), against the analytic -3 ln 20.  No kernel
   may run (multi-ellipsoid bounds never reach one).
8. ``NestedSampler(loglike, ptform, 3)`` with every other argument at
   its default (multi / unif / bootstrap 5) on the 3-D Gaussian.
9. The default in 10 to 20 dimensions: ``NestedSampler(loglike, ptform,
   15, nlive=1000)`` (multi / rwalk, walks 35, enlarge 1.25) on a 15-D
   standard normal under a uniform prior on +-10, truth -15 ln 20.  No
   kernel may run.
10. ``NestedSampler(nlive=2048, bound='balls', sample='slice')`` on the
    3-D Gaussian: the exact L2 path must run, and every refit must agree
    with the plain version.
11. The single/rslice nlive=500 drive with the sampler given as
    ``RSliceSampler(slice_doubling=True)``: the doubling barrier form.
12. Resume on the card: the balls/rslice drive of phase 3 stopped at half
    its iterations, saved, restored and resumed must equal phase 3's
    uninterrupted run bit for bit (niter, ncall, logl, logz, samples).
13. dynamic3, the JAX package's dynamic bench row:
    ``DynamicNestedSampler(loglike, ptform, 3, bound='multi',
    sample='unif', queue_size=256).run_nested()`` with every other
    argument at its default (nlive 500, n_effective 10,000, the stopping
    function on).  Gate: evidence within 5 sigma, n_effective >= 10,000,
    at least one batch.  No kernel may run.
14. dynamic-balls, the main drive under the dynamic layer:
    ``bound='balls', sample='rslice', nlive=2048`` with
    ``run_nested(nlive_init=2048, nlive_batch=2048, maxbatch=2)``.  The
    base run and both batches refit RadFriends at 2048 points: the exact
    L2 path must be launched from the base run and from a batch, and
    every refit must agree with the plain version.
15. dynamic-resume: dynamic3 with ``maxbatch=3``, once uninterrupted and
    once stopped inside its first batch by ``maxiter``, saved, restored
    onto the card and resumed; the two must be equal bit for bit.
16. blob-balls: the main drive with ``blob=True``, the blob ``(logl,
    v[0])``.  Gates: the evidence, every sample's blob its own, the same
    run as phase 3 (a blob changes no proposal), the exact L2 path
    launched and every refit held against the plain version.
17. host-balls: the main drive with the Gaussian as a numpy function in
    ``likelihood_mode='host'``.  Gates: the evidence, every call of the
    user's function counted by the wrapper (``ncall`` is the calls plus the
    out-of-cube probes rslice bills), the exact L2 path launched and held
    against the plain version; the cost of a host round trip.
18. host-pool: the default path (multi / unif / bootstrap 5, nlive 500) in
    host mode over a spawn ``Pool(2)``, each point's blob its evaluating
    PID.  Gates: the evidence, two worker PIDs and not the parent's,
    ``ncall`` equal to the points mapped through the log-likelihood, the
    bootstrap realisations in the workers, no worker that touched CUDA.
19. blob-resume: blob-balls stopped at half its iterations, saved,
    restored onto the card, resumed: equal to phase 16's run bit for bit,
    blobs included.
20. custom-unif: ``NestedSampler(..., nlive=500, bound=Box(3),
    sample='unif')`` with a user's bound (``Box`` below, sampled on the
    host between device waves), printing its progress through the stderr
    fallback printer at a pinned width.  Gates: the evidence, no NN-kernel
    launch, a last status line with the iteration count and logz.
21. custom-rslice: the main drive with ``Box(3)`` in place of RadFriends
    (nlive 2048, rslice, width 256): the box's axes go to the card once a
    dispatch.  Gates: the evidence, no NN-kernel launch.
22. custom-resume: custom-unif stopped at half its iterations, saved,
    restored onto the card, resumed: equal to phase 20's run bit for bit,
    the saved boxes included.
23. plots: from the results of phases 3 and 13, ``runplot``,
    ``traceplot``, ``cornerplot``, ``boundplot`` and ``cornerbound`` into
    a temporary directory under ``Agg``, the bound plots from a saved
    RadFriends bound of the card run through 5,000 host draws.  Where
    matplotlib is not installed the draws and their checks still run and
    the line says that no figure was drawn.
24. Device-only times (profiler kernel durations) of every comparison,
    and of one 256-lane evaluation of the heavy likelihood.

Each dynamic, blob, host, pool, custom and plot phase prints one JSON
line of its own.  The line before the last is a JSON object of the
kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dynesty_tpu_torch.bounding import Bound  # noqa: E402

NDIM = 3
SEED = 56432
LOGZ_TRUTH = -8.987
# kernel vs exact plain version: the exact path takes float32 differences
# in another summation order (relative ~d * eps32 on the squared distance);
# the tensor-core path re-ranks its candidate by exact differences
RTOL, ATOL = 1e-5, 1e-6
MAIN_SHAPE = (2048, 3)
TC_SHAPE = (16384, 64)
# a live set of 2048 points in 48 dimensions: the tensor-core path's corner
REFIT_SHAPE = (2048, 48)
# (N, d, p, mean of every coordinate, forced path or None)
COMPARES = [
    (2048, 3, 2, 0.0, None), (1000, 8, 2, 0.0, None),
    (2048, 48, 2, 0.0, None),
    (2048, 64, 2, 0.0, None), (16384, 64, 2, 0.0, None),
    (16384, 64, 2, 0.0, "exact"), (4096, 100, 2, 0.0, None),
    (2048, 65, 2, 0.0, None),
    (2048, 3, 2, 50.0, None), (16384, 64, 2, 50.0, None),
    (2048, 3, math.inf, 0.0, None), (16384, 64, math.inf, 0.0, None),
]
# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
TF32_FLOPS, FP32_FLOPS, HBM_BYTES = 495e12, 67e12, 3.35e12
SOURCE = "dynesty_tpu_torch/csrc/pairwise_min_dist.cu"
# the JAX package's heavy bench (bench.py): a 3-D correlated Gaussian plus
# a tanh matvec chain of this width and depth, at this live-point count
H_WIDTH, H_LAYERS, H_NLIVE, H_QUEUE, H_ROUNDS = 256, 384, 3000, 256, 12
H_TRUTH = -NDIM * math.log(20.0)  # the 1e-6 chain term is negligible
R_NDIM, R_NLIVE = 15, 1000
R_TRUTH = -R_NDIM * math.log(20.0)
REPLACES = {2: "dynesty_tpu/ops/pallas_kernels.py:31",
            math.inf: "dynesty_tpu/ops/pallas_kernels.py:80"}


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def _time_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=20):
    """Device time per call: the summed durations of the kernels that
    ``iters`` calls ran, from the profiler (no host gaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3


def _points(n, d, shift=0.0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    return torch.randn((n, d), generator=gen, device="cuda",
                       dtype=torch.float32) + shift


def library_min_dist(pts, p):
    """Yardstick only (the port never calls it): one library distance
    matrix (the matmul form for p=2, TF32 off), diagonal masked, row min."""
    dist = torch.cdist(pts, pts, p=p)
    dist.fill_diagonal_(math.inf)
    return dist.amin(1)


def bound_ms(n, d, p):
    """The least time the card could take: operations (2 N^2 d; TF32 tensor
    cores for p=2, fp32 for the sub and max of p=inf) or bytes (points in
    once, distances out once), whichever is larger."""
    ops = 2.0 * n * n * d / (TF32_FLOPS if p == 2 else FP32_FLOPS)
    by = 4.0 * n * (d + 1) / HBM_BYTES
    return 1e3 * max(ops, by), "operations" if ops >= by else "bytes"


def exact_ceiling_ms(n, d, p):
    """Fastest the exact form can be on fp32 CUDA cores (sub + FMA, or sub
    + max, per term)."""
    return 1e3 * (3.0 if p == 2 else 2.0) * n * n * d / FP32_FLOPS


def compare_kernel(hk, n, d, p, shift, path):
    """The kernel against its plain version; raises where they disagree."""
    pts = _points(n, d, shift)
    taken = path or hk.kernel_path(n, d, p)
    got = hk.pairwise_min_dist(pts, p=p, path=path)
    ref = hk.pairwise_min_dist_plain(pts, p=p)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"kernel output malformed at {(n, d, p)}")
    err = (got - ref).abs()
    bad = err > RTOL * ref.abs() + ATOL
    if bad.any():
        raise RuntimeError(f"{taken} kernel disagrees with plain version at "
                           f"{(n, d, p, shift)}: max abs err "
                           f"{err.max().item()}")
    bms, by = bound_ms(n, d, p)
    return {"shape": [n, d], "p": "inf" if p != 2 else 2, "shift": shift,
            "path": taken, "max_abs_err": err.max().item(), "bound_ms": bms,
            "bound_by": by, "exact_ceiling_ms": exact_ceiling_ms(n, d, p)}


def time_compare(hk, rec, n, d, p, shift, path):
    """Per-call times (CUDA events) of the kernel, the plain version and
    the library yardstick on the compared inputs."""
    pts = _points(n, d, shift)
    big = n > 4096
    rec["ms"] = _time_ms(lambda: hk.pairwise_min_dist(pts, p=p, path=path),
                         20 if big else 200)
    rec["plain_ms"] = _time_ms(lambda: hk.pairwise_min_dist_plain(pts, p=p),
                               3 if big else 50)
    rec["library_ms"] = _time_ms(lambda: library_min_dist(pts, p),
                                 20 if big else 200)


def _zero_counts(hk):
    k = hk.pairwise_min_dist
    k.launches = k.launches_exact = k.launches_tc = 0


def _counts(hk):
    k = hk.pairwise_min_dist
    return {"launches": k.launches, "exact": k.launches_exact,
            "tc": k.launches_tc}


# the 3-D correlated Gaussian at module level, so that a sampler over it
# pickles; its precision matrix goes to the card once CUDA is known to exist
_GAUSS = {}


def _gauss_setup():
    cov = np.identity(NDIM)
    cov[cov == 0] = 0.95
    _GAUSS["cinv"] = torch.as_tensor(np.linalg.inv(cov), device="cuda")
    _GAUSS["lnorm"] = -0.5 * (np.log(2 * np.pi) * NDIM +
                              np.log(np.linalg.det(cov)))


def gauss_loglike(x):
    return -0.5 * (x @ _GAUSS["cinv"] @ x) + _GAUSS["lnorm"]


def box_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def normal_loglike(x):
    """Standard normal in any dimension, normalised."""
    return -0.5 * (x @ x) - 0.5 * x.shape[-1] * math.log(2.0 * math.pi)


def _bound_name(bounding):
    """A bound's name, or a user's bound by its class."""
    return bounding if isinstance(bounding, str) else \
        type(bounding).__name__


def _summary(sampler, wall, truth, **config):
    res = sampler.results
    stats = [p for p in res.proposal_stats if p]
    return {
        "config": dict(config, nlive=sampler.nlive, ndim=sampler.ndim,
                       bound=_bound_name(sampler.bounding),
                       sample=sampler.internal_sampler.name, seed=SEED,
                       queue_size=sampler.queue_size),
        "wall_s": wall, "niter": int(res.niter),
        "ncall": int(sampler.ncall), "logz": float(res.logz[-1]),
        "logzerr": float(res.logzerr[-1]), "truth": truth,
        "nbound": int(sampler.nbound),
        "scale": float(sampler.internal_sampler.scale),
        "proposal_stats": {k: int(sum(p[k] for p in stats))
                           for k in (stats[0] if stats else {})},
        "timings": {k: v for k, v in sampler.timings.items()},
    }


def _gate(sampler, s, what):
    """The evidence gate of every drive; raises on a miss."""
    res = sampler.results
    ok = (np.isfinite(s["logz"]) and s["logzerr"] > 0 and
          abs(s["logz"] - s["truth"]) < 4 * s["logzerr"] and
          res.samples.shape == (res.niter + sampler.nlive, sampler.ndim) and
          np.all(np.isfinite(res.logwt)) and
          int(np.sum(res.ncall)) == sampler.ncall)
    if not ok:
        raise RuntimeError(f"{what} failed the evidence gate: {s}")


def drive(dyt, nlive, bound, sample="rslice", profile=None, maxiter=None,
          loglike=None, ptform=None, **kw):
    """One run on the 3-D Gaussian on the card's default device, through
    the evidence gate; with ``maxiter`` the run is stopped there without
    its live points and returned ungated.  ``loglike``/``ptform`` replace
    the Gaussian's (a blob or host-mode form of it), ``kw`` goes to the
    sampler.  Returns (summary, sampler)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # no device argument: the port runs on the card by default
    sampler = dyt.NestedSampler(
        loglike or gauss_loglike, ptform or box_ptform, NDIM, nlive=nlive,
        bound=bound, sample=sample,
        rstate=np.random.Generator(np.random.PCG64(SEED)), **kw)
    if sampler.device.type != "cuda":
        raise RuntimeError(f"the default device is {sampler.device}")
    with profile or contextlib.nullcontext():
        if maxiter is None:
            sampler.run_nested(print_progress=False)
        else:
            sampler.run_nested(print_progress=False, maxiter=maxiter,
                               add_live=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if maxiter is not None:
        return {"wall_s": wall, "niter": sampler.it - 1}, sampler
    summary = _summary(sampler, wall, LOGZ_TRUTH)
    _gate(sampler, summary, f"drive {_bound_name(bound)}/"
          f"{summary['config']['sample']} nlive={nlive}")
    return summary, sampler


def rwalk_drive(dyt):
    """The default in 10 to 20 dimensions: every argument but nlive at its
    default, on the 15-D standard normal."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = dyt.NestedSampler(
        normal_loglike, box_ptform, R_NDIM, nlive=R_NLIVE,
        rstate=np.random.Generator(np.random.PCG64(SEED)))
    inner = sampler.internal_sampler_next
    got = (sampler.device.type, sampler.bounding, inner.name, inner.walks,
           sampler.bound_enlarge, sampler.bound_bootstrap)
    if got != ("cuda", "multi", "rwalk", R_NDIM + 20, 1.25, 0):
        raise RuntimeError(f"the 15-D defaults resolved to {got}")
    sampler.run_nested(print_progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = _summary(sampler, wall, R_TRUTH, walks=inner.walks)
    _gate(sampler, summary, "rwalk drive")
    return summary


def rwalk_round_times(dyt):
    """Per-call times (CUDA events, host-paced) of the parts of one round
    of the rwalk drive at its widths (256 lanes, 35 steps, 15-D, nlive
    1000): the random-walk round alone, one batched likelihood call, and
    one propose-free consume round on the thin path."""
    from dynesty_tpu_torch.internal.fused import make_fused_round
    from dynesty_tpu_torch.internal.kernels import make_rwalk_round
    from dynesty_tpu_torch.internal.likelihood import LogLikelihood

    q, il, kw = 256, 2 * R_NDIM, dict(dtype=torch.float64, device="cuda")
    like = LogLikelihood(normal_loglike, box_ptform, R_NDIM, device="cuda")
    rng = np.random.Generator(np.random.PCG64(SEED))
    u = 0.5 + 0.02 * rng.standard_normal((R_NLIVE, R_NDIM))
    v, logl, _ = like.eval_host(u)
    walk = make_rwalk_round(like, ndim=R_NDIM, ncdim=R_NDIM, q=q,
                            walks=R_NDIM + 20, **kw)
    axes = np.tile(0.01 * np.eye(R_NDIM).ravel(), (q, 1))
    packed_in = torch.as_tensor(np.concatenate(
        [u[:q], v[:q], logl[:q, None], axes], axis=1), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    u_dev = packed_in[:, :R_NDIM].contiguous()
    # a fixed block of proposals above every live point: the thin path
    prop = torch.cat([packed_in[:, :il], packed_in[:, il:il + 1] + 100.0,
                      torch.full((q, 3), 35.0, **kw)], dim=1)

    def propose(gen_, live_, live_blob, axes_args, scale, loglstar):
        return (prop[:, :R_NDIM], prop[:, R_NDIM:il], prop[:, il], None,
                prop[:, il + 1].to(torch.int64), (prop[:, il + 2].sum(),),
                prop[:, il + 2:il + 4])

    consume, _ = make_fused_round(propose, nlive=R_NLIVE, ndim=R_NDIM,
                                  npdim=R_NDIM, q=q, **kw)
    live = torch.as_tensor(np.concatenate(
        [u, v, logl[:, None], np.zeros((R_NLIVE, 2)),
         np.full((R_NLIVE, 1), -1e30)], axis=1), device="cuda")
    ctrl = np.array([-1e30, 0.0, 0.0, 0.0, -1e30, 0.0, 0.0, 0.0, 1.0, -np.inf,
                     np.inf, 2.0 ** 30, 2.0 ** 30, 1.0, 0.0, 1.0, -1e30, 0.0,
                     0.0, 0.0, 0.0, 2.0 ** 30])
    return {
        "rwalk_round_ms": _time_ms(
            lambda: walk(gen, packed_in, None, 1.0, -1e30), 5),
        "likelihood_call_ms": _time_ms(lambda: like.batch_eval(u_dev), 50),
        "consume_round_ms": _time_ms(
            lambda: consume(SEED, live, None, {}, ctrl), 5)}


def resume_drive(dyt, full, maxiter, nlive=2048, bound="balls", **kw):
    """The balls/rslice drive (``nlive``, ``bound``, ``kw`` as for
    :func:`drive`) stopped at ``maxiter``, saved, restored and resumed,
    held bit for bit to ``full`` (the uninterrupted sampler), blobs and a
    user's saved bounds included."""
    first, sampler = drive(dyt, nlive, bound, maxiter=maxiter, **kw)
    if not sampler.interrupted_budget:
        raise RuntimeError("the stopped run did not report its stop")
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "balls.pkl")
        sampler.save(fname)
        size = os.path.getsize(fname)
        del sampler
        restored = dyt.NestedSampler.restore(fname)
    if restored.device.type != "cuda":
        raise RuntimeError(f"restored on {restored.device}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored.run_nested(resume=True, print_progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    a, b = full.results, restored.results
    same = {k: bool(np.array_equal(np.asarray(a[k]), np.asarray(b[k])))
            for k in ("logl", "logz", "samples", "ncall", "logvol",
                      "samples_u", "samples_it", "scale")}
    same["niter"] = a.niter == b.niter
    same["ncall_total"] = full.ncall == restored.ncall
    if full.blob:
        same["blob"] = bool(np.array_equal(_blobs(a), _blobs(b)))
    if isinstance(bound, Box):
        same["boxes"] = len(a.bound) == len(b.bound) and all(
            type(x) is type(y) and np.array_equal(x.cen, y.cen) and
            x.size == y.size for x, y in zip(a.bound[1:], b.bound[1:]))
    t = restored.timings
    out = {"maxiter": maxiter, "niter_first": first["niter"],
           "wall_first_s": first["wall_s"], "wall_resumed_s": wall,
           "checkpoint_bytes": size, "niter": int(b.niter),
           "ncall": int(restored.ncall), "same": same,
           "n_replay": t.get("n_replay", 0),
           "n_continuation": t.get("n_continuation", 0)}
    if not all(same.values()) or out["n_replay"] < 1:
        raise RuntimeError(f"the resumed run differs from the "
                           f"uninterrupted one: {out}")
    return out


# the 3-D Gaussian in numpy for the host-mode drives, at module level so
# that a pool's workers find it; a worker imports this script and never
# touches the card
_COV_NP = np.identity(NDIM)
_COV_NP[_COV_NP == 0] = 0.95
_CINV_NP = np.linalg.inv(_COV_NP)
_LNORM_NP = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(_COV_NP)))


def np_gauss_loglike(x):
    return -0.5 * (x @ _CINV_NP @ x) + _LNORM_NP


def np_box_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def np_pid_loglike(x):
    """The numpy Gaussian, with the evaluating process's PID as its blob."""
    return np_gauss_loglike(x), float(os.getpid())


def blob_loglike(x):
    """The Gaussian on the card, with the blob ``(logl, v[0])``."""
    logl = gauss_loglike(x)
    return logl, torch.stack([logl, x[0]])


def worker_state(_):
    """Whether this process has initialised CUDA, and its PID."""
    time.sleep(0.01)
    return torch.cuda.is_initialized(), os.getpid()


class HostCounter:
    """The numpy Gaussian, counting its own calls."""

    def __init__(self):
        self.n = 0

    def __call__(self, x):
        self.n += 1
        return np_gauss_loglike(x)


class CountingPool:
    """A pool that counts the points mapped through each site."""

    def __init__(self, pool):
        self.pool, self.njobs, self.points = pool, pool.njobs, {}

    def map(self, fn, items):
        items = list(items)
        # a wrapped user function by its site, any other by its name
        name = getattr(fn, "name", None) or fn.__name__
        self.points[name] = self.points.get(name, 0) + len(items)
        return self.pool.map(fn, items)


def _blobs(res):
    return np.array([np.asarray(b) for b in res.blob])


def blob_balls_drive(dyt, hk, main):
    """The balls drive with ``blob=True``: every sample's blob must be its
    own ``(logl, v[0])``, and a blob changes no proposal, so the run must
    equal the balls drive's.  Returns (summary, sampler)."""
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        s, sampler = drive(dyt, 2048, "balls", loglike=blob_loglike,
                           blob=True)
    s["launches"] = _counts(hk)
    s["refit_max_abs_err"] = check_refits(hk, calls, "blob-balls drive")
    res = sampler.results
    blobs = _blobs(res)
    s["blob_shape"] = list(blobs.shape)
    s["blob_is_logl_and_v0"] = bool(
        blobs.shape == (len(res.logl), 2) and
        np.array_equal(blobs[:, 0], res.logl) and
        np.array_equal(blobs[:, 1], res.samples[:, 0]))
    s["same_as_balls"] = {k: s[k] == main[k]
                          for k in ("niter", "ncall", "logz")}
    if not s["blob_is_logl_and_v0"] or s["launches"]["exact"] < 1 or \
            not all(s["same_as_balls"].values()):
        got = {k: s[k] for k in ("blob_is_logl_and_v0", "launches",
                                 "same_as_balls")}
        raise RuntimeError(f"the blob-balls drive failed its gate: {got}")
    return s, sampler


def host_balls_drive(dyt, hk):
    """The balls drive with the Gaussian as a numpy function in host mode:
    the rounds, the consume loop and the NN kernel stay on the card, each
    slice iteration takes its counted lanes to the host and back.  Every
    call of the user's function must be one the wrapper counted; rslice
    bills its out-of-cube probes too (as the reference does), so ``ncall``
    is the calls plus those probes."""
    counter = HostCounter()
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        s, sampler = drive(dyt, 2048, "balls", loglike=counter,
                           ptform=np_box_ptform, likelihood_mode="host")
    s["launches"] = _counts(hk)
    s["refit_max_abs_err"] = check_refits(hk, calls, "host-balls drive")
    s["user_calls"] = counter.n
    s["ncall_launched"] = sampler.loglikelihood.ncall_launched
    s["probes_outside_cube"] = sampler.ncall - counter.n
    if counter.n != s["ncall_launched"] or counter.n > sampler.ncall or \
            s["launches"]["exact"] < 1:
        raise RuntimeError(f"the host-balls drive failed its gate: "
                           f"calls {counter.n}, counted "
                           f"{s['ncall_launched']}, ncall {sampler.ncall}, "
                           f"launches {s['launches']}")
    return s


def host_round_trip(dyt):
    """Wall ms of one host-mode evaluation of 256 lanes on the card (copy
    the counted lanes to the host, map the numpy Gaussian, copy ``v`` and
    ``logl`` back): all lanes counted, and one lane counted (the copies
    and the scatter alone)."""
    from dynesty_tpu_torch.internal.likelihood import LogLikelihood

    like = LogLikelihood(np_gauss_loglike, np_box_ptform, NDIM,
                         device="cuda", mode="host")
    like.eval_host(np.full((2, NDIM), 0.5))
    u = torch.rand((256, NDIM), dtype=torch.float64, device="cuda")
    one = torch.zeros(256, dtype=torch.bool, device="cuda")
    one[0] = True
    every = torch.ones(256, dtype=torch.bool, device="cuda")
    return {"lanes": 256,
            "all_counted_ms": _time_ms(lambda: like.batch_eval(u, every),
                                       20),
            "one_counted_ms": _time_ms(lambda: like.batch_eval(u, one), 50)}


def host_pool_drive(dyt):
    """The default path (multi / unif / bootstrap 5, nlive 500) in host
    mode over a spawn pool of two workers, each point's blob the PID that
    evaluated it.  Gates: the evidence, at least two worker PIDs and none
    of the parent's, ``ncall`` equal to the points mapped through the
    log-likelihood, the bootstrap realisations in the workers, and no
    worker that initialised CUDA."""
    from dynesty_tpu_torch.pool import Pool

    t0 = time.perf_counter()
    with Pool(2, np_pid_loglike, np_box_ptform) as pool:
        # the workers start (import this script, cache the functions)
        # before the first task: timed apart from the run
        pool.map(worker_state, range(4))
        pool_start = time.perf_counter() - t0
        counting = CountingPool(pool)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler = dyt.NestedSampler(
            pool.loglike, pool.prior_transform, NDIM, nlive=500,
            likelihood_mode="host", pool=counting, blob=True,
            rstate=np.random.Generator(np.random.PCG64(SEED)))
        if sampler.device.type != "cuda":
            raise RuntimeError(f"the default device is {sampler.device}")
        sampler.run_nested(print_progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        state = pool.map(worker_state, range(16))
    s = _summary(sampler, wall, LOGZ_TRUTH, likelihood_mode="host",
                 pool_workers=2, bootstrap=sampler.bound_bootstrap)
    _gate(sampler, s, "host-pool drive")
    pids = np.unique(_blobs(sampler.results).astype(np.int64))
    boot = getattr(sampler.bound, "last_bootstrap_pids", [])
    s.update({"pool_start_s": pool_start, "worker_pids": len(pids),
              "parent_pid_in_blobs": bool(os.getpid() in pids),
              "mapped_points": counting.points,
              "bootstrap_in_workers": bool(boot) and
              os.getpid() not in boot,
              "workers_initialised_cuda": any(i for i, _ in state)})
    ok = (len(pids) >= 2 and not s["parent_pid_in_blobs"] and
          counting.points.get("loglikelihood") == sampler.ncall and
          s["bootstrap_in_workers"] and not s["workers_initialised_cuda"]
          and (sampler.bounding, sampler.internal_sampler.name) ==
          ("multi", "unif"))
    if not ok:
        got = {k: s[k] for k in ("worker_pids", "parent_pid_in_blobs",
                                 "mapped_points", "ncall",
                                 "bootstrap_in_workers",
                                 "workers_initialised_cuda")}
        raise RuntimeError(f"the host-pool drive failed its gate: {got}")
    return s


class Box(Bound):
    """A user's bound: an axis-aligned box around the live points (the
    JAX package's test bound, ``tests/test_interface.py``).  It has no
    device export, so the sampler calls it 'custom': ``unif`` draws its
    waves through ``samples`` on the host, the other kernels take the axes
    of ``get_random_axes`` once a dispatch."""

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


@contextlib.contextmanager
def counting_box_calls(name):
    """Count the calls of ``Box.<name>`` while open, and their host
    seconds: yields ``[calls, seconds]``."""
    orig = getattr(Box, name)
    tally = [0, 0.0]

    def counted(self, *a, **kw):
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        tally[0] += 1
        tally[1] += time.perf_counter() - t0
        return out

    setattr(Box, name, counted)
    try:
        yield tally
    finally:
        setattr(Box, name, orig)


def custom_unif_drive(dyt, hk, misc):
    """The 3-D Gaussian under ``Box(3)`` with ``unif`` (every other
    argument at its default: nlive 500, width 256, bootstrap 5, which a
    user's bound may ignore), its progress printed through the stderr
    fallback printer at a pinned width of 200 columns.  Returns (summary,
    sampler)."""
    _zero_counts(hk)
    err = io.StringIO()
    width = misc._terminal_width
    misc._terminal_width = lambda default=200: 200
    try:
        with counting_box_calls("samples") as tally, \
                contextlib.redirect_stderr(err):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sampler = dyt.NestedSampler(
                gauss_loglike, box_ptform, NDIM, nlive=500, bound=Box(NDIM),
                sample="unif",
                rstate=np.random.Generator(np.random.PCG64(SEED)))
            if sampler.device.type != "cuda":
                raise RuntimeError(f"the default device is {sampler.device}")
            sampler.run_nested(print_progress=True,
                               print_func=misc._FallbackPrinter())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        misc._terminal_width = width
    s = _summary(sampler, wall, LOGZ_TRUTH)
    _gate(sampler, s, "custom-unif drive")
    s["launches"] = _counts(hk)
    s["bound_kind"] = sampler.device_bound_kind()
    s["samples_calls"] = tally[0]
    s["host_ms_per_samples_call"] = 1e3 * tally[1] / max(tally[0], 1)
    lines = [ln.strip() for ln in err.getvalue().split("\r") if ln.strip()]
    s["last_status_line"] = lines[-1] if lines else ""
    # the last line is the last recycled live point's: iteration niter +
    # nlive, the final evidence
    last = s["last_status_line"]
    nlive = sampler.nlive
    printed_ok = (last.startswith(f"iter: {s['niter'] + nlive} | +{nlive} ")
                  and f"logz: {s['logz']:.3f}" in last)
    if s["launches"]["launches"] != 0 or s["bound_kind"] != "custom" or \
            not printed_ok or s["samples_calls"] < 1:
        got = {k: s[k] for k in ("launches", "bound_kind", "samples_calls",
                                 "last_status_line")}
        raise RuntimeError(f"the custom-unif drive failed its gate: {got}")
    return s, sampler


def custom_rslice_drive(dyt, hk):
    """The main drive (nlive 2048, rslice, width 256) with ``Box(3)`` in
    place of RadFriends: the rounds take the box's axes, uploaded once a
    dispatch, and no refit reaches the NN kernel."""
    _zero_counts(hk)
    with counting_box_calls("get_random_axes") as tally:
        s, sampler = drive(dyt, 2048, Box(NDIM))
    s["launches"] = _counts(hk)
    s["bound_kind"] = sampler.device_bound_kind()
    s["axes_uploads"] = tally[0]
    t = s["timings"]
    if s["launches"]["launches"] != 0 or s["bound_kind"] != "custom" or \
            tally[0] < 1 or tally[0] > t.get("n_dispatch", 0):
        got = {k: s[k] for k in ("launches", "bound_kind", "axes_uploads")}
        raise RuntimeError(f"the custom-rslice drive failed its gate: {got}")
    return s


def plots_phase(dyt, balls_res, dyn_res):
    """The five plots of the card's results: a static run (the balls
    drive, whose saved RadFriends bounds launched the kernel) and a
    dynamic one (dynamic3).  The bound plots draw 5,000 points from the
    last saved RadFriends bound through its host ``samples`` and the
    sampler's torch prior transform; every draw must lie in the bound.
    With matplotlib each figure goes to a file under ``Agg`` that must
    not be empty; without it no figure is drawn, and the line says so."""
    from dynesty_tpu_torch import plotting

    it = int(np.nonzero(np.asarray(balls_res.bound_iter) ==
                        max(balls_res.bound_iter))[0][0])
    bound = balls_res.bound[balls_res.bound_iter[it]]
    if type(bound).__name__ != "RadFriends" or len(bound.ctrs) != 2048:
        raise RuntimeError(f"saved bound at iteration {it}: {bound}")
    t0 = time.perf_counter()
    raw = plotting._sample_bound(balls_res, it=it, ndraws=5000,
                                 rstate=np.random.Generator(
                                     np.random.PCG64(SEED)))
    draw_s = time.perf_counter() - t0
    pts = plotting._sample_bound(balls_res, it=it, ndraws=5000,
                                 prior_transform=box_ptform,
                                 rstate=np.random.Generator(
                                     np.random.PCG64(SEED)))
    inside = sum(bound.contains(x) for x in raw)
    out = {"bound_iter": it, "bound": type(bound).__name__,
           "bound_centres": len(bound.ctrs), "draws": len(raw),
           "draws_in_bound": int(inside), "draw_s": draw_s,
           "transform_exact": bool(np.array_equal(pts, 10.0 * (2.0 * raw
                                                              - 1.0)))}
    if inside != len(raw) or pts.shape != (5000, NDIM) or \
            not out["transform_exact"]:
        raise RuntimeError(f"the bound draws failed their check: {out}")
    try:
        import matplotlib
    except ImportError:
        out["figures"] = "not drawn: matplotlib is not installed here"
        return out
    matplotlib.use("Agg")
    figures = {
        "runplot": lambda: plotting.runplot(balls_res, lnz_truth=LOGZ_TRUTH),
        "runplot_dynamic": lambda: plotting.runplot(dyn_res),
        "traceplot": lambda: plotting.traceplot(balls_res, show_titles=True),
        "cornerplot": lambda: plotting.cornerplot(balls_res),
        "cornerplot_dynamic": lambda: plotting.cornerplot(dyn_res),
        "boundplot": lambda: plotting.boundplot(
            balls_res, dims=(0, 1), it=it, ndraws=5000,
            prior_transform=box_ptform,
            rstate=np.random.Generator(np.random.PCG64(SEED))),
        "cornerbound": lambda: plotting.cornerbound(
            balls_res, it=it, ndraws=5000,
            rstate=np.random.Generator(np.random.PCG64(SEED))),
    }
    out["figures"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, make in figures.items():
            t0 = time.perf_counter()
            fig = make()[0]
            path = os.path.join(tmp, name + ".png")
            fig.savefig(path)
            plotting.pl.close(fig)
            size = os.path.getsize(path)
            out["figures"][name] = {"bytes": size,
                                    "seconds": time.perf_counter() - t0}
            if size == 0:
                raise RuntimeError(f"the {name} figure is empty")
    return out


def _print_phase(name, s, card):
    """One JSON line of a phase, the card beside it."""
    keys = ("config", "niter", "ncall", "logz", "logzerr", "truth", "wall_s",
            "launches", "refit_max_abs_err", "blob_shape",
            "blob_is_logl_and_v0", "same_as_balls", "user_calls",
            "ncall_launched", "probes_outside_cube", "round_trip",
            "host_ms_per_sync_slice", "pool_start_s", "worker_pids",
            "parent_pid_in_blobs",
            "mapped_points", "bootstrap_in_workers",
            "workers_initialised_cuda", "maxiter", "niter_first",
            "wall_first_s", "wall_resumed_s", "checkpoint_bytes", "same",
            "n_replay", "n_continuation", "bound_kind", "samples_calls",
            "host_ms_per_samples_call", "last_status_line", "axes_uploads",
            "timings")
    print(json.dumps(dict({"phase": name, "card": card},
                          **{k: s[k] for k in keys if k in s})))


# states of a dynamic sampler in which a refit belongs to the base run
_BASE_STATES = ("INIT", "LIVEPOINTSINIT", "INBASE", "INBASEADDLIVE")
DYN_NEFF = 10000


def _dyn_summary(dns, wall, **config):
    """Counts, evidence and the wall's split of one dynamic run."""
    res = dns.results
    t = dict(dns.timings)
    inner = sum(t.get(k, 0.0) for k in ("dispatch", "consume", "refit",
                                        "mirror", "dyn_seeding"))
    # what the record-by-record loops of the base run and the batches
    # cost outside the inner samplers' own work
    per_record = (t.get("dyn_base", 0.0) + t.get("dyn_batch", 0.0) -
                  inner) / max(int(res.niter), 1)
    return {
        "config": dict(config, ndim=dns.ndim, bound=dns.bounding,
                       sample=dns.sampling.name, seed=SEED,
                       queue_size=dns.queue_size),
        "wall_s": wall, "niter": int(res.niter), "ncall": int(dns.ncall),
        "batches": int(dns.batch),
        "batch_nlive": [int(n) for n in res.batch_nlive],
        "batch_logl_bounds": [[float(a), float(b)]
                              for a, b in res.batch_logl_bounds],
        "logz": float(res.logz[-1]), "logzerr": float(res.logzerr[-1]),
        "truth": LOGZ_TRUTH, "n_effective": float(dns.n_effective),
        "nc_waste": int(dns.nc_waste_total),
        "per_record_host_us": 1e6 * per_record, "timings": t,
    }


def _dyn_gate(dns, s, what, neff=None):
    """The gate of a dynamic drive: evidence within 5 sigma, a dynamic
    result of the right shape, at least one batch, and the effective
    sample size where the run was to reach one."""
    res = dns.results
    ok = (res.isdynamic() and np.isfinite(s["logz"]) and s["logzerr"] > 0
          and abs(s["logz"] - s["truth"]) < 5 * s["logzerr"]
          and s["batches"] >= 1
          and len(res.batch_nlive) == s["batches"] + 1
          and res.samples.shape == (res.niter, dns.ndim)
          and np.all(np.isfinite(res.logwt)) and np.ptp(res.samples_n) > 0
          and dns.batch_sampler is None
          and (neff is None or s["n_effective"] >= neff))
    if not ok:
        raise RuntimeError(f"{what} failed its gate: {s}")


def dynamic_drive(dyt, run_kw, **kw):
    """One ``DynamicNestedSampler(...).run_nested(**run_kw)`` on the 3-D
    Gaussian on the card's default device; returns (summary, sampler)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dns = dyt.DynamicNestedSampler(
        gauss_loglike, box_ptform, NDIM,
        rstate=np.random.Generator(np.random.PCG64(SEED)), **kw)
    if dns.device.type != "cuda":
        raise RuntimeError(f"the default device is {dns.device}")
    dns.run_nested(print_progress=False, **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return _dyn_summary(dns, wall, **dict(kw, **run_kw)), dns


def dynamic_balls_drive(dyt, hk):
    """The main drive under the dynamic layer, with every friends refit
    recorded, held against the plain version and attributed to the base
    run or to a batch (its seeding or its rounds)."""
    holder, tags = {}, []

    def tag():
        # the sampler exists before its first refit; a batch's seeding
        # refits before the batch sampler is handed over
        state = holder["dns"].internal_state.name
        return "base" if state in _BASE_STATES else "batch"

    class Factory:
        """``DynamicNestedSampler`` that keeps the sampler it made."""

        bounding = dyt.bounding

        @staticmethod
        def DynamicNestedSampler(*a, **kw):
            holder["dns"] = dyt.DynamicNestedSampler(*a, **kw)
            return holder["dns"]

    _zero_counts(hk)
    with recording_refits(dyt, hk, tags=tags, tag=tag) as calls:
        s, dns = dynamic_drive(
            Factory, dict(nlive_init=2048, nlive_batch=2048, maxbatch=2),
            nlive=2048, bound="balls", sample="rslice")
    s["launches"] = _counts(hk)
    s["launches_from"] = {k: tags.count(k) for k in ("base", "batch")}
    s["refit_max_abs_err"] = check_refits(hk, calls, "dynamic-balls drive")
    _dyn_gate(dns, s, "dynamic-balls drive")
    if s["launches"]["exact"] != len(tags) or \
            min(s["launches_from"].values()) < 1:
        raise RuntimeError(f"the dynamic-balls drive did not launch the "
                           f"exact path from the base run and from a "
                           f"batch: {s['launches']} {s['launches_from']}")
    return s


def dynamic_resume_drive(dyt):
    """dynamic3 with three batches, uninterrupted and stopped inside its
    first batch by ``maxiter``, saved, restored onto the card and resumed:
    equal bit for bit, or raises."""
    kw = dict(bound="multi", sample="unif", queue_size=256)
    full_s, full = dynamic_drive(dyt, dict(maxbatch=3), **kw)
    _dyn_gate(full, full_s, "dynamic-resume (uninterrupted)")
    batch_of = full.results.samples_batch
    n_base = int(np.sum(batch_of == 0))
    nlive = full.nlive0
    n_b1 = int(np.sum(batch_of == 1)) - nlive  # the first batch's rounds
    # a batch's seeds count against its budget but not against the run's,
    # so a run stopped inside a batch takes it up once more with what the
    # seeds left over: the first batch gets extra + nlive records in all
    extra = n_b1 // 8
    if extra < 1 or extra + nlive >= n_b1:
        raise RuntimeError(f"the first batch ({n_b1} records) is too short "
                           f"to stop inside")
    maxiter = n_base + nlive + extra
    first_s, dns = dynamic_drive(dyt, dict(maxbatch=3, maxiter=maxiter),
                                 **kw)
    if dns.batch_sampler is None or dns.batch != 0 or \
            dns.internal_state.name != "INBATCH":
        raise RuntimeError(f"maxiter={maxiter} did not suspend the first "
                           f"batch: batch {dns.batch}, state "
                           f"{dns.internal_state}")
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "dynamic.pkl")
        dns.save(fname)
        size = os.path.getsize(fname)
        del dns
        restored = dyt.DynamicNestedSampler.restore(fname)
    devices = {str(x.device) for x in (restored, restored.sampler,
                                       restored.batch_sampler,
                                       restored.loglikelihood)}
    if devices != {"cuda"}:
        raise RuntimeError(f"restored on {devices}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored.run_nested(resume=True, print_progress=False, maxbatch=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    a, b = full.results, restored.results
    same = {k: bool(np.array_equal(np.asarray(a[k]), np.asarray(b[k])))
            for k in ("logl", "logz", "logzerr", "logvol", "logwt",
                      "samples", "samples_u", "samples_batch", "samples_it",
                      "samples_n", "ncall", "batch_nlive",
                      "batch_logl_bounds", "scale")}
    same["niter"] = a.niter == b.niter
    same["ncall_total"] = full.ncall == restored.ncall
    same["batches"] = full.batch == restored.batch
    t = restored.timings
    out = {"phase": "dynamic-resume", "maxiter": maxiter,
           "niter_first": first_s["niter"], "niter": int(b.niter),
           "ncall": int(restored.ncall), "batches": int(restored.batch),
           "logz": float(b.logz[-1]), "logzerr": float(b.logzerr[-1]),
           "n_effective": float(restored.n_effective),
           "wall_full_s": full_s["wall_s"],
           "wall_first_s": first_s["wall_s"], "wall_resumed_s": wall,
           "checkpoint_bytes": size, "same": same,
           "n_replay": t.get("n_replay", 0),
           "n_continuation": t.get("n_continuation", 0),
           "timings_full": full_s["timings"]}
    if not all(same.values()) or out["n_replay"] < 1 or \
            restored.internal_state.name != "RUN_DONE":
        raise RuntimeError(f"the resumed dynamic run differs from the "
                           f"uninterrupted one: {out}")
    return out


def _print_dynamic(name, s, card):
    """One JSON line of a dynamic drive, the card beside it."""
    keys = ("niter", "ncall", "batches", "batch_nlive", "logz", "logzerr",
            "truth", "n_effective", "wall_s", "per_record_host_us",
            "nc_waste", "launches", "launches_from", "refit_max_abs_err",
            "timings")
    print(json.dumps(dict({"phase": name, "card": card},
                          **{k: s[k] for k in keys if k in s})))


def heavy_weights():
    """The heavy bench's chain weights (seed 1234): an orthogonal matrix
    scaled to spectral norm 0.9, an input map, and the Gaussian's
    precision and normalization."""
    rng = np.random.Generator(np.random.PCG64(1234))
    q, _ = np.linalg.qr(rng.standard_normal((H_WIDTH, H_WIDTH)))
    a = 0.9 * q
    w = rng.standard_normal((H_WIDTH, NDIM)) / np.sqrt(NDIM)
    cov = np.identity(NDIM)
    cov[cov == 0] = 0.95
    lnorm = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(cov)))
    return a, w, np.linalg.inv(cov), lnorm


def heavy_loglike():
    """The heavy likelihood on the card: the Gaussian in float64 plus
    1e-6 times the sum of a float32 tanh chain (TF32 off)."""
    a, w, cinv, lnorm = heavy_weights()
    a_t = torch.as_tensor(a, dtype=torch.float32, device="cuda")
    w_t = torch.as_tensor(w, dtype=torch.float32, device="cuda")
    cinv_t = torch.as_tensor(cinv, device="cuda")

    def loglike(x):
        h = torch.tanh(w_t @ x.to(torch.float32))
        for _ in range(H_LAYERS):
            h = torch.tanh(a_t @ h)
        return -0.5 * (x @ cinv_t @ x) + lnorm + 1e-6 * h.sum().to(x.dtype)

    return loglike


def heavy_loglike_plain():
    """The same likelihood in float64 numpy on the host, for a check."""
    a, w, cinv, lnorm = heavy_weights()

    def loglike(x):
        h = np.tanh(w @ x)
        for _ in range(H_LAYERS):
            h = np.tanh(a @ h)
        return -0.5 * x @ cinv @ x + lnorm + 1e-6 * h.sum()

    return loglike


def unif_drive(dyt, loglike, truth, profile=None, **kw):
    """One ``NestedSampler(loglike, ptform, 3, **kw)`` run on the card's
    default device through the evidence gate (under ``profile`` if
    given); returns its summary."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = dyt.NestedSampler(
        loglike, box_ptform, NDIM,
        rstate=np.random.Generator(np.random.PCG64(SEED)), **kw)
    if sampler.device.type != "cuda":
        raise RuntimeError(f"the default device is {sampler.device}")
    with profile or contextlib.nullcontext():
        sampler.run_nested(print_progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expands = [b.last_expand for b in sampler.bound_list
               if hasattr(b, "last_expand")]
    summary = _summary(sampler, wall, truth, **dict(
        kw, bootstrap=sampler.bound_bootstrap,
        rounds_per_dispatch=sampler.rounds_per_dispatch))
    summary["nells"] = int(getattr(sampler.bound, "nells", 1))
    summary["max_last_expand"] = max(expands) if expands else None
    _gate(sampler, summary, f"unif drive {kw}")
    return summary


def _print_unif_drive(name, s, card):
    t = s["timings"]
    print(f"{name}: wall {s['wall_s']:.2f} s  niter {s['niter']}  ncall "
          f"{s['ncall']}  logz {s['logz']:.3f} +/- {s['logzerr']:.3f} "
          f"(truth {s['truth']:.3f})  nells {s['nells']}  n_refit "
          f"{t.get('n_refit', 0)}  max last_expand "
          f"{s['max_last_expand']}  [{card}]")
    print(f"  split: dispatch {t.get('dispatch', 0.0):.3f} s  consume "
          f"{t.get('consume', 0.0):.3f} s  refit {t.get('refit', 0.0):.3f} s"
          f"  mirror {t.get('mirror', 0.0):.3f} s  total "
          f"{t.get('total', 0.0):.3f} s  n_dispatch {t.get('n_dispatch', 0)}"
          f"  sync_wave {t.get('sync_wave', 0)}  sync_round "
          f"{t.get('sync_round', 0)}  nc_launched {t.get('nc_launched', 0)}")


def new_profile(on):
    """A profiler of host ops and device kernels, or None when off."""
    if not on:
        return None
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def report_profile(prof, summary):
    """Print the profiled drive's ops by device time and its device-busy
    seconds, and keep both in ``summary``."""
    if prof is None:
        return
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    dev = "device" if hasattr(avgs[0], "self_device_time_total") else "cuda"
    table = avgs.table(sort_by=f"self_{dev}_time_total", row_limit=25)
    # one stream: kernels do not overlap, their durations add up
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    summary["profile_device_busy_s"] = busy / 1e6
    summary["profile_table"] = table
    print(table)
    print(f"device busy (sum of kernel self time): {busy / 1e6:.3f} s "
          f"of {summary['wall_s']:.3f} s wall (profiled run)")


def _print_drive(name, s, counts, card):
    t = s["timings"]
    print(f"{name}: wall {s['wall_s']:.2f} s  niter {s['niter']}  ncall "
          f"{s['ncall']}  logz {s['logz']:.3f} +/- {s['logzerr']:.3f} "
          f"(truth {s['truth']:.3f})  refits {t.get('n_refit', 0)}  "
          f"launches {counts}  [{card}]")
    print(f"  split: dispatch {t.get('dispatch', 0.0):.3f} s  consume "
          f"{t.get('consume', 0.0):.3f} s  refit {t.get('refit', 0.0):.3f} s"
          f"  total {t.get('total', 0.0):.3f} s  n_dispatch "
          f"{t.get('n_dispatch', 0)}  sync_slice {t.get('sync_slice', 0)}  "
          f"sync_wave {t.get('sync_wave', 0)}  sync_round "
          f"{t.get('sync_round', 0)}  final scale {s['scale']:.4f}  "
          f"proposal stats {s['proposal_stats']}")


@contextlib.contextmanager
def recording_refits(dyt, hk, tags=None, tag=None):
    """Keep every input and output of the friends refit's NN-distance call
    (``dynesty_tpu_torch.bounding.pairwise_min_dist``) while it is open;
    with ``tags`` and ``tag``, also what ``tag()`` says at each call."""
    calls = []

    def record(points, p=2, path=None):
        out = hk.pairwise_min_dist(points, p=p, path=path)
        calls.append((points.clone(), p, out.clone()))
        if tags is not None:
            tags.append(tag())
        return out

    dyt.bounding.pairwise_min_dist = record
    try:
        yield calls
    finally:
        dyt.bounding.pairwise_min_dist = hk.pairwise_min_dist


def check_refits(hk, calls, what):
    """Each recorded refit output against the plain version on its input;
    returns the largest absolute error."""
    if not calls:
        raise RuntimeError(f"{what}: no refit reached the device")
    worst = 0.0
    for pts, p, got in calls:
        ref = hk.pairwise_min_dist_plain(pts, p=p)
        err = (got - ref).abs()
        if not torch.isfinite(got).all() or \
                (err > RTOL * ref.abs() + ATOL).any():
            raise RuntimeError(f"{what}: a refit's distances disagree with "
                               f"the plain version (max abs err "
                               f"{err.max().item()})")
        worst = max(worst, err.max().item())
    return worst


def refit_drive(dyt, hk):
    """One RadFriends refit of a live set at the tensor-core switch point
    (unit-normal points shifted by 50, as a late run's live set sits)."""
    n, d = REFIT_SHAPE
    rng = np.random.Generator(np.random.PCG64(SEED))
    pts = rng.normal(size=(n, d)) + 50.0
    # the kernel covariance of an earlier fit, wider than the typical
    # pairwise distance sqrt(2 d): the single-linkage clustering joins the
    # set into one cluster
    bound = dyt.bounding.RadFriends(d, cov=4.0 * d * np.identity(d),
                                    device="cuda")
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        t0 = time.perf_counter()
        bound.update(pts)
        wall = time.perf_counter() - t0
    counts = _counts(hk)
    if counts["tc"] < 1:
        raise RuntimeError(f"the refit at {(n, d)} never launched the "
                           f"tensor-core path: {counts}")
    return {"shape": [n, d], "wall_s": wall, "launches": counts,
            "refit_max_abs_err": check_refits(hk, calls, "refit drive")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement here")
    ap.add_argument("--profile", nargs="?", const="balls",
                    choices=["balls", "heavy"],
                    help="profile one drive (device time by kernel): the "
                    "balls drive (the default) or the heavy one")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dynesty_tpu_torch as dyt
    from dynesty_tpu_torch.ops import build
    from dynesty_tpu_torch.ops import hopper_kernels as hk

    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    # the library yardstick's matmul form in full float32
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 1: build every kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    build.load_library("pairwise_min_dist")
    log = build.build_log["pairwise_min_dist"]
    print(f"build pairwise_min_dist: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {log['seconds']:.2f} s)")
    print(log["output"].strip())

    # phase 2: each kernel path against its plain version on the card, all
    # checked (and so warmed up) before any is timed
    compares = [compare_kernel(hk, *c) for c in COMPARES]
    for c, args_ in zip(compares, COMPARES):
        time_compare(hk, c, *args_)
    for c in compares:
        print(f"pairwise_min_dist {tuple(c['shape'])} p={c['p']} shift "
              f"{c['shift']:g} [{c['path']}]: max_abs_err "
              f"{c['max_abs_err']:.3e}  per call: kernel {c['ms']:.4f} ms  "
              f"plain {c['plain_ms']:.4f} ms  library "
              f"{c['library_ms']:.4f} ms  bound {c['bound_ms']:.5f} ms  "
              f"[{card}]")

    # phase 3: the main path, with launch counts zeroed just before
    _gauss_setup()
    prof = new_profile(args.profile == "balls")
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        main, main_sampler = drive(dyt, 2048, "balls", profile=prof)
    main["launches"] = _counts(hk)
    main["refit_max_abs_err"] = check_refits(hk, calls, "balls drive")
    if main["launches"]["exact"] < 1:
        raise RuntimeError("the balls drive never launched the exact path")
    _print_drive("main balls/rslice nlive=2048", main, main["launches"],
                 card)
    print(f"balls refits against the plain version: max abs err "
          f"{main['refit_max_abs_err']:.3e}")
    print(f"timings: {json.dumps(main['timings'])}")
    report_profile(prof, main)

    # phase 4: cubes, whose refit takes the exact L-inf path
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        cubes, _ = drive(dyt, 2048, "cubes")
    cubes["launches"] = _counts(hk)
    cubes["refit_max_abs_err"] = check_refits(hk, calls, "cubes drive")
    if cubes["launches"]["exact"] < 1:
        raise RuntimeError("the cubes drive never launched the L-inf path")
    _print_drive("cubes/rslice nlive=2048", cubes, cubes["launches"], card)
    print(f"cubes refits against the plain version: max abs err "
          f"{cubes['refit_max_abs_err']:.3e}")

    # phase 5: a refit large enough for the tensor-core path
    refit = refit_drive(dyt, hk)
    print(f"RadFriends refit {tuple(refit['shape'])}: wall "
          f"{refit['wall_s']:.2f} s  launches {refit['launches']}  max abs "
          f"err {refit['refit_max_abs_err']:.3e}  [{card}]")

    # phase 6: single ellipsoid (no kernel on its path)
    _zero_counts(hk)
    single, _ = drive(dyt, 500, "single")
    if hk.pairwise_min_dist.launches != 0:
        raise RuntimeError("the single-ellipsoid drive launched the "
                           "friends kernel")
    _print_drive("single/rslice nlive=500", single, _counts(hk), card)

    # phase 7: the default path at the heavy bench's width; the heavy
    # likelihood checked against a float64 host version first
    like = heavy_loglike()
    xs = np.random.Generator(np.random.PCG64(SEED)).uniform(
        -10.0, 10.0, (8, NDIM))
    got = torch.func.vmap(like)(torch.as_tensor(xs, device="cuda")).cpu()
    ref = np.array([heavy_loglike_plain()(x) for x in xs])
    if not np.allclose(got.numpy(), ref, rtol=1e-12, atol=1e-9):
        raise RuntimeError(f"heavy likelihood disagrees with its host "
                           f"version: {got.numpy()} vs {ref}")
    prof = new_profile(args.profile == "heavy")
    _zero_counts(hk)
    heavy = unif_drive(dyt, like, H_TRUTH, profile=prof, nlive=H_NLIVE,
                       bound="multi", sample="unif", queue_size=H_QUEUE,
                       rounds_per_dispatch=H_ROUNDS)
    heavy["launches"] = _counts(hk)
    if hk.pairwise_min_dist.launches != 0:
        raise RuntimeError("the multi/unif drive launched the friends "
                           "kernel")
    _print_unif_drive(f"heavy multi/unif nlive={H_NLIVE} (width {H_WIDTH}, "
                      f"depth {H_LAYERS})", heavy, card)
    report_profile(prof, heavy)

    # phase 8: the defaults (multi / unif / bootstrap 5 for ndim < 10)
    _zero_counts(hk)
    default = unif_drive(dyt, gauss_loglike, LOGZ_TRUTH)
    default["launches"] = _counts(hk)
    if (default["config"]["sample"], default["config"]["bootstrap"]) != \
            ("unif", 5) or hk.pairwise_min_dist.launches != 0:
        raise RuntimeError(f"the default drive ran {default['config']}")
    _print_unif_drive("default arguments (multi/unif, bootstrap 5, "
                      "nlive=500)", default, card)

    # phase 9: the default in 10 to 20 dimensions (multi / rwalk)
    _zero_counts(hk)
    rwalk = rwalk_drive(dyt)
    rwalk["launches"] = _counts(hk)
    if hk.pairwise_min_dist.launches != 0:
        raise RuntimeError("the rwalk drive launched the friends kernel")
    ps = rwalk["proposal_stats"]
    rwalk["accept_fraction"] = ps["n_accept"] / (ps["n_accept"] +
                                                 ps["n_reject"])
    _print_drive(f"default in {R_NDIM}-D (multi/rwalk nlive={R_NLIVE})",
                 rwalk, rwalk["launches"], card)
    print(f"  walks {rwalk['config']['walks']}  accept fraction "
          f"{rwalk['accept_fraction']:.4f}")
    # the parts of one of its rounds, timed before the profiler has run
    rwalk.update(rwalk_round_times(dyt))
    rounds = rwalk["niter"] / rwalk["config"]["queue_size"]
    print(f"rwalk drive, per round of {rwalk['config']['queue_size']} lanes "
          f"(events, host-paced): {rwalk['config']['walks']} walk steps "
          f"{rwalk['rwalk_round_ms']:.1f} ms (one likelihood call "
          f"{rwalk['likelihood_call_ms']:.3f} ms), thin consume "
          f"{rwalk['consume_round_ms']:.1f} ms; x {rounds:.0f} rounds = "
          f"{rounds * rwalk['rwalk_round_ms'] / 1e3:.2f} s + "
          f"{rounds * rwalk['consume_round_ms'] / 1e3:.2f} s of the drive's "
          f"{rwalk['timings']['dispatch']:.2f} s dispatch  [{card}]")

    # phase 10: slice over RadFriends: the slice drive's refits reach the
    # exact L2 path
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        sl, _ = drive(dyt, 2048, "balls", sample="slice")
    sl["launches"] = _counts(hk)
    sl["refit_max_abs_err"] = check_refits(hk, calls, "slice drive")
    if sl["launches"]["exact"] < 1:
        raise RuntimeError("the slice drive never launched the exact path")
    _print_drive("balls/slice nlive=2048", sl, sl["launches"], card)
    print(f"slice refits against the plain version: max abs err "
          f"{sl['refit_max_abs_err']:.3e}")

    # phase 11: the doubling barrier form
    _zero_counts(hk)
    doubling, dsampler = drive(
        dyt, 500, "single",
        sample=dyt.internal.samplers.RSliceSampler(slice_doubling=True))
    if not dsampler.internal_sampler.sampler_kwargs["slice_doubling"]:
        raise RuntimeError("the doubling drive ran in stepping-out mode")
    _print_drive("single/rslice doubling nlive=500", doubling, _counts(hk),
                 card)

    # phase 12: stop, save, restore, resume on the card, against phase 3
    _zero_counts(hk)
    resumed = resume_drive(dyt, main_sampler, main["niter"] // 2)
    resumed["launches"] = _counts(hk)
    print(f"resume balls/rslice nlive=2048: stopped at "
          f"{resumed['niter_first']} of {resumed['niter']} iterations "
          f"({resumed['wall_first_s']:.2f} s), checkpoint "
          f"{resumed['checkpoint_bytes']} bytes, resumed "
          f"{resumed['wall_resumed_s']:.2f} s, replays "
          f"{resumed['n_replay']}, continuations "
          f"{resumed['n_continuation']}, bit-identical: {resumed['same']}  "
          f"[{card}]")

    # phase 13: the dynamic bench row, nothing cut
    _zero_counts(hk)
    dyn3, dyn3_sampler = dynamic_drive(dyt, {}, bound="multi",
                                       sample="unif", queue_size=256)
    dyn3["launches"] = _counts(hk)
    _dyn_gate(dyn3_sampler, dyn3, "dynamic3 drive", neff=DYN_NEFF)
    if hk.pairwise_min_dist.launches != 0:
        raise RuntimeError("the dynamic3 drive launched the friends kernel")
    dyn3_results = dyn3_sampler.results
    del dyn3_sampler
    _print_dynamic("dynamic3", dyn3, card)

    # phase 14: the main drive under the dynamic layer
    dynballs = dynamic_balls_drive(dyt, hk)
    _print_dynamic("dynamic-balls", dynballs, card)

    # phase 15: a dynamic run stopped inside a batch, resumed on the card
    _zero_counts(hk)
    dynresume = dynamic_resume_drive(dyt)
    dynresume["launches"] = _counts(hk)
    print(json.dumps(dict(dynresume, card=card)))

    # phase 16: blob-balls, the main drive with a blob on every point
    blobballs, blob_sampler = blob_balls_drive(dyt, hk, main)
    _print_phase("blob-balls", blobballs, card)

    # phase 17: host-balls, the main drive with a host-mode likelihood
    hostballs = host_balls_drive(dyt, hk)
    hostballs["round_trip"] = host_round_trip(dyt)
    # what host mode adds to each slice iteration, against the balls drive
    # of this call (the same iterations would differ: host and card round
    # the Gaussian differently)
    hostballs["host_ms_per_sync_slice"] = 1e3 * (
        hostballs["timings"]["dispatch"] / hostballs["timings"]["sync_slice"]
        - main["timings"]["dispatch"] / main["timings"]["sync_slice"])
    _print_phase("host-balls", hostballs, card)

    # phase 18: host-pool, the default path over a pool of two workers
    _zero_counts(hk)
    hostpool = host_pool_drive(dyt)
    hostpool["launches"] = _counts(hk)
    if hk.pairwise_min_dist.launches != 0:
        raise RuntimeError("the host-pool drive launched the friends kernel")
    _print_phase("host-pool", hostpool, card)

    # phase 19: blob-resume, blob-balls stopped at half, saved, restored
    # onto the card and resumed, against phase 16's sampler
    _zero_counts(hk)
    blobresume = resume_drive(dyt, blob_sampler, blobballs["niter"] // 2,
                              loglike=blob_loglike, blob=True)
    blobresume["launches"] = _counts(hk)
    if blobresume["launches"]["exact"] < 1:
        raise RuntimeError("the blob-resume drive never launched the exact "
                           "path")
    del blob_sampler
    _print_phase("blob-resume", blobresume, card)

    # phase 20: custom-unif, a user's bound sampled on the host between
    # device waves, its progress printed
    from dynesty_tpu_torch.utils import misc
    customunif, cu_sampler = custom_unif_drive(dyt, hk, misc)
    _print_phase("custom-unif", customunif, card)

    # phase 21: custom-rslice, the main drive under the user's bound
    customrslice = custom_rslice_drive(dyt, hk)
    _print_phase("custom-rslice", customrslice, card)

    # phase 22: custom-resume, custom-unif stopped at half, saved, restored
    # onto the card and resumed, against phase 20's sampler
    _zero_counts(hk)
    customresume = resume_drive(dyt, cu_sampler, customunif["niter"] // 2,
                                nlive=500, bound=Box(NDIM), sample="unif")
    customresume["launches"] = _counts(hk)
    if customresume["launches"]["launches"] != 0:
        raise RuntimeError("the custom-resume drive launched the NN kernel")
    del cu_sampler
    _print_phase("custom-resume", customresume, card)

    # phase 23: the plots of the balls drive and of dynamic3
    plots = plots_phase(dyt, main_sampler.results, dyn3_results)
    print(json.dumps(dict({"phase": "plots", "card": card}, **plots)))

    # phase 24: device-only times, last: once a profiler has run, every
    # later launch in the process is slower
    for c, (n, d, p, shift, path) in zip(compares, COMPARES):
        pts = _points(n, d, shift)
        c["device_ms"] = _device_ms(
            lambda: hk.pairwise_min_dist(pts, p=p, path=path))
        c["plain_device_ms"] = _device_ms(
            lambda: hk.pairwise_min_dist_plain(pts, p=p),
            3 if n > 4096 else 20)
        c["library_device_ms"] = _device_ms(lambda: library_min_dist(pts, p))
        print(f"pairwise_min_dist {(n, d)} p={c['p']} shift {shift:g} "
              f"[{c['path']}] device only: kernel {c['device_ms']:.4f} ms  "
              f"plain {c['plain_device_ms']:.4f} ms  library "
              f"{c['library_device_ms']:.4f} ms  bound "
              f"{c['bound_ms']:.5f} ms  exact ceiling "
              f"{c['exact_ceiling_ms']:.5f} ms  [{card}]")
    batch = torch.rand((H_QUEUE, NDIM), dtype=torch.float64, device="cuda")
    heavy_eval = torch.func.vmap(like)
    heavy["eval_device_ms"] = _device_ms(lambda: heavy_eval(batch), 5)
    heavy["eval_ms"] = _time_ms(lambda: heavy_eval(batch), 5)
    waves_s = heavy["eval_device_ms"] * heavy["timings"]["sync_wave"] / 1e3
    print(f"heavy likelihood, {H_QUEUE} lanes per call: device only "
          f"{heavy['eval_device_ms']:.3f} ms, events {heavy['eval_ms']:.3f} "
          f"ms; x {heavy['timings']['sync_wave']} waves = {waves_s:.2f} s of "
          f"the drive's {heavy['wall_s']:.2f} s wall  [{card}]")

    def entry(name, shape, p, path, by_drive):
        """One kernel's line: ``launches`` sums the drives that reach it,
        each counted from zero just before the drive to just after."""
        c = next(c for c in compares if tuple(c["shape"]) == shape and
                 c["p"] == (2 if p == 2 else "inf") and c["shift"] == 0 and
                 c["path"] == path)
        return {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[p],
                "launches": sum(by_drive.values()),
                "launches_by_drive": by_drive,
                "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"]}

    kernels = {"kernels": [
        entry("pairwise_min_dist_l2_exact", MAIN_SHAPE, 2, "exact",
              {"balls": main["launches"]["exact"],
               "slice": sl["launches"]["exact"],
               "resume": resumed["launches"]["exact"],
               "dynamic-balls": dynballs["launches"]["exact"],
               "blob-balls": blobballs["launches"]["exact"],
               "host-balls": hostballs["launches"]["exact"],
               "blob-resume": blobresume["launches"]["exact"]}),
        entry("pairwise_min_dist_linf_exact", MAIN_SHAPE, math.inf, "exact",
              {"cubes": cubes["launches"]["exact"]}),
        entry("pairwise_min_dist_l2_tc", TC_SHAPE, 2, "tc",
              {"refit": refit["launches"]["tc"]}),
    ]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "compare": compares,
                       "main": main, "cubes": cubes, "refit": refit,
                       "single": single, "heavy": heavy,
                       "default": default, "rwalk": rwalk, "slice": sl,
                       "doubling": doubling, "resume": resumed,
                       "dynamic3": dyn3, "dynamic_balls": dynballs,
                       "dynamic_resume": dynresume,
                       "blob_balls": blobballs, "host_balls": hostballs,
                       "host_pool": hostpool, "blob_resume": blobresume,
                       "custom_unif": customunif,
                       "custom_rslice": customrslice,
                       "custom_resume": customresume, "plots": plots,
                       "build_seconds": log["seconds"]},
                      f, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
