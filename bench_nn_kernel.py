"""Times the friends NN-distance kernel paths on one GPU, in turns, beside
an earlier version of the CUDA source when one is given.

    python3 bench_nn_kernel.py [--shapes 2048x3,16384x64] [--p 2|inf]
                               [--baseline OLD.cu] [--out FILE]

For each shape, every path of ``hopper_kernels.pairwise_min_dist`` that
takes the metric ('exact'; 'tc' for p=2), and the baseline (a source with
the earlier C entry ``dynesty_pairwise_min_dist_l2(pts, out, n, d,
stream)``, p=2 and d <= 64, built with the same flags under another name)
is checked against the exact plain version (rtol 1e-5, atol 1e-6: the
result says whether it held) and then timed device-only (profiler kernel
durations) in the order baseline, exact, tc, tc, exact, baseline; each
variant's time is the mean of its two turns.  The card's name and power
limit head the output.
"""

import argparse
import ctypes
import json
import math
import os
import sys

import torch

from chip_smoke import ATOL, RTOL, _card, _device_ms, _points, bound_ms, \
    exact_ceiling_ms


def _baseline(build, src):
    lib = build.load_library("pairwise_min_dist_baseline", src=src)
    fn = lib.dynesty_pairwise_min_dist_l2
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(pts):
        n, d = pts.shape
        out = torch.empty(n, dtype=torch.float32, device=pts.device)
        err = fn(pts.data_ptr(), out.data_ptr(), n, d,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline launch failed (cudaError {err})")
        return out

    return run


def _breakdown(fn, iters):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    dev = "device" if hasattr(avgs[0], "self_device_time_total") else "cuda"
    return avgs.table(sort_by=f"self_{dev}_time_total", row_limit=8)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="2048x3,1000x8,16384x64")
    ap.add_argument("--p", default="2", choices=["2", "inf"])
    ap.add_argument("--baseline", help="an earlier pairwise_min_dist.cu")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--breakdown", action="store_true",
                    help="print each variant's device time by kernel")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_nn_kernel: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynesty_tpu_torch.ops import build
    from dynesty_tpu_torch.ops import hopper_kernels as hk

    card = _card()
    print(card)
    p = 2 if args.p == "2" else math.inf
    build.load_library("pairwise_min_dist")
    print(build.build_log["pairwise_min_dist"]["output"].strip())
    base = _baseline(build, args.baseline) if args.baseline else None

    rows = []
    for spec in args.shapes.split(","):
        n, d = (int(v) for v in spec.split("x"))
        pts = _points(n, d)
        variants = {}
        if p == 2 and base is not None and d <= 64:
            variants["baseline"] = lambda: base(pts)
        variants["exact"] = lambda: hk.pairwise_min_dist(pts, p=p,
                                                         path="exact")
        if p == 2:
            variants["tc"] = lambda: hk.pairwise_min_dist(pts, p=p,
                                                          path="tc")
        ref = hk.pairwise_min_dist_plain(pts, p=p)
        row = {"shape": [n, d], "p": args.p, "auto_path":
               hk.kernel_path(n, d, p), "bound_ms": bound_ms(n, d, p)[0],
               "exact_ceiling_ms": exact_ceiling_ms(n, d, p)}
        for name, fn in variants.items():
            err = (fn() - ref).abs()
            row[f"{name}_max_abs_err"] = err.max().item()
            row[f"{name}_within_tol"] = bool(
                (err <= RTOL * ref.abs() + ATOL).all())
        order = list(variants)
        times = {v: [] for v in order}
        for v in order + order[::-1]:
            times[v].append(_device_ms(variants[v], args.iters))
        for v in order:
            row[f"{v}_device_ms"] = sum(times[v]) / len(times[v])
        rows.append(row)
        print(json.dumps(row) + f"  [{card}]")
        if args.breakdown:
            for v in order:
                print(f"{v} {(n, d)}:\n{_breakdown(variants[v], args.iters)}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
