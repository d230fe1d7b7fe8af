"""Smoke test of the PyTorch/CUDA port (``dynesty_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, in order; any failure raises and exits non-zero:

1. Require CUDA; print the card's name and power limit, the torch/CUDA
   versions, and build the CUDA kernels from ``dynesty_tpu_torch/csrc``.
2. Compare each kernel with its plain PyTorch version on the card at the
   shapes the main path gives it and beyond, timing both with CUDA events.
3. Drive the main path: ``NestedSampler(nlive=2048, bound='balls',
   sample='rslice', device='cuda')`` on the 3-D correlated Gaussian
   (rho = 0.95, prior box +-10, seed 56432), with every kernel's launch
   count zeroed just before and read just after; check the evidence
   against the analytic -8.987 and that every kernel of the path ran.
4. A second drive with ``bound='single'`` (nlive=500), same gate.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

NDIM = 3
SEED = 56432
LOGZ_TRUTH = -8.987
# kernel vs plain version: both take exact float32 differences, only the
# summation order differs (relative ~d * eps32 on the squared distance)
RTOL, ATOL = 1e-5, 1e-6
COMPARE_SHAPES = [(2048, 3), (1000, 8), (16384, 64)]
MAIN_SHAPE = (2048, 3)


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


def _points(shape):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32)


def compare_kernel(hk, shape):
    pts = _points(shape)
    got = hk.pairwise_min_dist(pts)
    ref = hk.pairwise_min_dist_plain(pts)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"kernel output malformed at {shape}")
    err = (got - ref).abs()
    bad = err > RTOL * ref.abs() + ATOL
    if bad.any():
        raise RuntimeError(f"kernel disagrees with plain version at {shape}:"
                           f" max abs err {err.max().item()}")
    iters = 20 if shape[0] > 4096 else 200
    ms = _time_ms(lambda: hk.pairwise_min_dist(pts), iters)
    plain_ms = _time_ms(lambda: hk.pairwise_min_dist_plain(pts), iters)
    return {"shape": list(shape), "max_abs_err": err.max().item(),
            "ms": ms, "plain_ms": plain_ms}


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
    sampler = dyt.NestedSampler(
        loglike, ptform, NDIM, nlive=nlive, bound=bound, sample="rslice",
        device="cuda", rstate=np.random.Generator(np.random.PCG64(SEED)))
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

    # phase 1: build every kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    build.load_library("pairwise_min_dist")
    log = build.build_log["pairwise_min_dist"]
    print(f"build pairwise_min_dist: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {log['seconds']:.2f} s)")
    print(log["output"].strip())

    # phase 2: each kernel against its plain version on the card
    compares = [compare_kernel(hk, s) for s in COMPARE_SHAPES]
    for c in compares:
        print(f"pairwise_min_dist {tuple(c['shape'])}: max_abs_err "
              f"{c['max_abs_err']:.3e}  per call: kernel {c['ms']:.4f} ms"
              f"  plain {c['plain_ms']:.4f} ms  [{card}]")

    # phase 3: the main path, with launch counts zeroed just before
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    hk.pairwise_min_dist.launches = 0
    main = drive(dyt, 2048, "balls", profile=prof)
    launches = hk.pairwise_min_dist.launches
    if launches < 1:
        raise RuntimeError("the main path never launched pairwise_min_dist")
    main["launches"] = {"pairwise_min_dist": launches}
    print(f"main balls/rslice nlive=2048: wall {main['wall_s']:.2f} s  "
          f"niter {main['niter']}  ncall {main['ncall']}  logz "
          f"{main['logz']:.3f} +/- {main['logzerr']:.3f}  refits "
          f"{main['timings'].get('n_refit', 0)}  launches {launches}  "
          f"[{card}]")
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

    # phase 4: second drive, single ellipsoid (no kernel on its path)
    before = hk.pairwise_min_dist.launches
    single = drive(dyt, 500, "single")
    if hk.pairwise_min_dist.launches != before:
        raise RuntimeError("the single-ellipsoid drive launched the "
                           "friends kernel")
    print(f"single/rslice nlive=500: wall {single['wall_s']:.2f} s  niter "
          f"{single['niter']}  ncall {single['ncall']}  logz "
          f"{single['logz']:.3f} +/- {single['logzerr']:.3f}  refits "
          f"{single['timings'].get('n_refit', 0)}  [{card}]")

    # device-only kernel times, last: a profiler session slows the
    # launches of everything that runs after it in the process
    for c in compares:
        pts = _points(tuple(c["shape"]))
        c["device_ms"] = _device_ms(lambda: hk.pairwise_min_dist(pts))
        c["plain_device_ms"] = _device_ms(
            lambda: hk.pairwise_min_dist_plain(pts))
        print(f"pairwise_min_dist {tuple(c['shape'])} device only: kernel "
              f"{c['device_ms']:.4f} ms  plain {c['plain_device_ms']:.4f} "
              f"ms  [{card}]")

    at_main = next(c for c in compares if tuple(c["shape"]) == MAIN_SHAPE)
    kernels = {"kernels": [{
        "name": "pairwise_min_dist", "route": "cuda",
        "source": "dynesty_tpu_torch/csrc/pairwise_min_dist.cu",
        "replaces": "dynesty_tpu/ops/pallas_kernels.py:31",
        "launches": launches, "max_abs_err": at_main["max_abs_err"],
        "ms": at_main["ms"], "plain_ms": at_main["plain_ms"]}]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "compare": compares,
                       "main": main, "single": single,
                       "build_seconds": log["seconds"]}, f, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
