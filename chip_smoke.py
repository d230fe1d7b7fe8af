"""Smoke test of the PyTorch/CUDA port (``dynesty_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--out results.json] [--profile]

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
7. Device-only times (profiler kernel durations) of every comparison.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

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
    (2048, 64, 2, 0.0, None), (16384, 64, 2, 0.0, None),
    (16384, 64, 2, 0.0, "exact"), (4096, 100, 2, 0.0, None),
    (2048, 65, 2, 0.0, None),
    (2048, 3, 2, 50.0, None), (16384, 64, 2, 50.0, None),
    (2048, 3, math.inf, 0.0, None), (16384, 64, math.inf, 0.0, None),
]
# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
TF32_FLOPS, FP32_FLOPS, HBM_BYTES = 495e12, 67e12, 3.35e12
SOURCE = "dynesty_tpu_torch/csrc/pairwise_min_dist.cu"
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


def drive(dyt, nlive, bound, profile=None):
    cov = np.identity(NDIM)
    cov[cov == 0] = 0.95
    cinv = torch.as_tensor(np.linalg.inv(cov), device="cuda")
    lnorm = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(cov)))

    def loglike(x):
        return -0.5 * (x @ cinv @ x) + lnorm

    def ptform(u):
        return 10.0 * (2.0 * u - 1.0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # no device argument: the port runs on the card by default
    sampler = dyt.NestedSampler(
        loglike, ptform, NDIM, nlive=nlive, bound=bound, sample="rslice",
        rstate=np.random.Generator(np.random.PCG64(SEED)))
    if sampler.device.type != "cuda":
        raise RuntimeError(f"the default device is {sampler.device}")
    if profile is not None:
        with profile:
            sampler.run_nested(print_progress=False)
    else:
        sampler.run_nested(print_progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = sampler.results
    logz, err = float(res.logz[-1]), float(res.logzerr[-1])
    summary = {
        "config": {"nlive": nlive, "bound": bound, "sample": "rslice",
                   "ndim": NDIM, "seed": SEED,
                   "queue_size": sampler.queue_size},
        "wall_s": wall, "niter": int(res.niter),
        "ncall": int(np.sum(res.ncall)), "logz": logz, "logzerr": err,
        "nbound": int(sampler.nbound),
        "timings": {k: v for k, v in sampler.timings.items()},
    }
    ok = (np.isfinite(logz) and err > 0 and
          abs(logz - LOGZ_TRUTH) < 4 * err and
          res.samples.shape == (res.niter + nlive, NDIM) and
          np.all(np.isfinite(res.logwt)))
    if not ok:
        raise RuntimeError(f"drive {bound}/rslice nlive={nlive} failed the "
                           f"evidence gate: {summary}")
    return summary


def _print_drive(name, s, counts, card):
    print(f"{name}: wall {s['wall_s']:.2f} s  niter {s['niter']}  ncall "
          f"{s['ncall']}  logz {s['logz']:.3f} +/- {s['logzerr']:.3f}  "
          f"refits {s['timings'].get('n_refit', 0)}  launches {counts}  "
          f"[{card}]")


@contextlib.contextmanager
def recording_refits(dyt, hk):
    """Keep every input and output of the friends refit's NN-distance call
    (``dynesty_tpu_torch.bounding.pairwise_min_dist``) while it is open."""
    calls = []

    def record(points, p=2, path=None):
        out = hk.pairwise_min_dist(points, p=p, path=path)
        calls.append((points.clone(), p, out.clone()))
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
    ap.add_argument("--profile", action="store_true",
                    help="profile the main drive (device time by kernel)")
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
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        main = drive(dyt, 2048, "balls", profile=prof)
    main["launches"] = _counts(hk)
    main["refit_max_abs_err"] = check_refits(hk, calls, "balls drive")
    if main["launches"]["exact"] < 1:
        raise RuntimeError("the balls drive never launched the exact path")
    _print_drive("main balls/rslice nlive=2048", main, main["launches"],
                 card)
    print(f"balls refits against the plain version: max abs err "
          f"{main['refit_max_abs_err']:.3e}")
    print(f"timings: {json.dumps(main['timings'])}")
    if prof is not None:
        from torch.autograd import DeviceType
        avgs = prof.key_averages()
        dev = "device" if hasattr(avgs[0], "self_device_time_total") \
            else "cuda"
        table = avgs.table(sort_by=f"self_{dev}_time_total", row_limit=25)
        # one stream: kernels do not overlap, their durations add up
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
        main["profile_device_busy_s"] = busy / 1e6
        main["profile_table"] = table
        print(table)
        print(f"device busy (sum of kernel self time): {busy / 1e6:.3f} s "
              f"of {main['wall_s']:.3f} s wall (profiled run)")

    # phase 4: cubes, whose refit takes the exact L-inf path
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        cubes = drive(dyt, 2048, "cubes")
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
    single = drive(dyt, 500, "single")
    if hk.pairwise_min_dist.launches != 0:
        raise RuntimeError("the single-ellipsoid drive launched the "
                           "friends kernel")
    _print_drive("single/rslice nlive=500", single, _counts(hk), card)

    # phase 7: device-only times, last: a profiler session slows the
    # launches of everything that runs after it in the process
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

    def entry(name, shape, p, path, launches):
        c = next(c for c in compares if tuple(c["shape"]) == shape and
                 c["p"] == (2 if p == 2 else "inf") and c["shift"] == 0 and
                 c["path"] == path)
        return {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[p], "launches": launches,
                "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"]}

    kernels = {"kernels": [
        entry("pairwise_min_dist_l2_exact", MAIN_SHAPE, 2, "exact",
              main["launches"]["exact"]),
        entry("pairwise_min_dist_linf_exact", MAIN_SHAPE, math.inf, "exact",
              cubes["launches"]["exact"]),
        entry("pairwise_min_dist_l2_tc", TC_SHAPE, 2, "tc",
              refit["launches"]["tc"]),
    ]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "compare": compares,
                       "main": main, "cubes": cubes, "refit": refit,
                       "single": single, "build_seconds": log["seconds"]},
                      f, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
