"""Time the stepping-out slice rounds of a checkout on the card, end to
end: the balls drive (``nlive=2048, bound='balls', sample='rslice'``),
the same with ``sample='slice'``, and dynamic-balls (the balls drive under
``DynamicNestedSampler``, ``nlive_init=nlive_batch=2048, maxbatch=2``),
on the 3-D correlated Gaussian of ``chip_smoke.py`` (seed 56432).

    python3 bench_slice_graph.py [--root DIR] [--out FILE] [--no-profile]

For each drive: wall, ``Timings['dispatch']``, ``sync_slice`` and the
host ms an iteration (``dispatch / sync_slice``), niter, ncall and logz
(so that two checkouts can be held to the same run), and the capture
counters where the checkout has them.  Then the balls drive once more
under ``torch.profiler`` (device activity only): the device's busy time
(the union of its kernels' and copies' intervals) over the profiled
drive's wall, and so its idle share.  The profiler slows the host, so
the idle share it gives is an upper bound on the unprofiled drive's.

``--root`` imports ``dynesty_tpu_torch`` from another checkout (an
earlier commit unpacked with ``git archive`` into the git-ignored
``build/``), so that two versions run in turns in one call to the card.
Prints the card's name and power limit and one JSON line per drive, and
exits non-zero without CUDA.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 56432
NDIM = 3
_GAUSS = {}


def gauss_loglike(x):
    return -0.5 * (x @ _GAUSS["cinv"] @ x) + _GAUSS["lnorm"]


def box_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


def _summary(sampler, wall, t):
    res = sampler.results
    keys = ("dispatch", "refit", "consume", "total", "sync_slice",
            "n_slice_replay", "n_slice_graph", "n_uncaptured")
    out = {"wall_s": wall, "niter": int(res.niter),
           "ncall": int(sampler.ncall), "logz": float(res.logz[-1]),
           "timings": {k: t[k] for k in keys if k in t}}
    if t.get("sync_slice"):
        out["host_ms_per_iteration"] = 1e3 * t["dispatch"] / t["sync_slice"]
    return out


def static_drive(dyt, sample, profile=False):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = dyt.NestedSampler(
        gauss_loglike, box_ptform, NDIM, nlive=2048, bound="balls",
        sample=sample, rstate=np.random.Generator(np.random.PCG64(SEED)))
    if not profile:
        sampler.run_nested(print_progress=False)
        torch.cuda.synchronize()
        return _summary(sampler, time.perf_counter() - t0, sampler.timings)
    from torch.profiler import ProfilerActivity, profile as prof_
    with prof_(activities=[ProfilerActivity.CUDA]) as prof:
        sampler.run_nested(print_progress=False)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = _summary(sampler, wall, sampler.timings)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    out["device_busy_s"] = busy / 1e6
    out["device_idle_share"] = 1.0 - out["device_busy_s"] / wall
    out["device_events"] = len(spans)
    return out


def dynamic_drive(dyt):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dns = dyt.DynamicNestedSampler(
        gauss_loglike, box_ptform, NDIM, nlive=2048, bound="balls",
        sample="rslice", rstate=np.random.Generator(np.random.PCG64(SEED)))
    dns.run_nested(print_progress=False, nlive_init=2048, nlive_batch=2048,
                   maxbatch=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = dns.results
    t = dns.timings
    keys = ("dispatch", "refit", "total", "sync_slice", "n_slice_replay",
            "n_slice_graph", "n_uncaptured")
    out = {"wall_s": wall, "niter": int(res.niter), "ncall": int(dns.ncall),
           "logz": float(res.logz[-1]), "batch": int(dns.batch),
           "timings": {k: t[k] for k in keys if k in t}}
    if t.get("sync_slice"):
        out["host_ms_per_iteration"] = 1e3 * t["dispatch"] / t["sync_slice"]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose dynesty_tpu_torch is timed")
    ap.add_argument("--out", help="also write the records here")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the profiled balls drive")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_slice_graph: CUDA is not available")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import dynesty_tpu_torch as dyt
    if not dyt.__file__.startswith(root):
        raise SystemExit(f"imported {dyt.__file__}, not from {root}")
    card = _card()
    print(card)
    cov = np.identity(NDIM)
    cov[cov == 0] = 0.95
    _GAUSS["cinv"] = torch.as_tensor(np.linalg.inv(cov), device="cuda")
    _GAUSS["lnorm"] = -0.5 * (np.log(2 * np.pi) * NDIM +
                              np.log(np.linalg.det(cov)))
    recs = {"root": root, "card": card}
    # the kernels of the checkout built, and its path warmed up, before any
    # drive is timed
    from dynesty_tpu_torch.ops import build
    for lib in ("pairwise_min_dist", "consume_scan", "slice_step",
                "rwalk_step"):
        build.load_library(lib)
    dyt.NestedSampler(gauss_loglike, box_ptform, NDIM, nlive=512,
                      bound="balls", sample="rslice",
                      rstate=np.random.Generator(np.random.PCG64(SEED))
                      ).run_nested(print_progress=False, maxiter=1500)
    for name, fn in (("balls", lambda: static_drive(dyt, "rslice")),
                     ("slice", lambda: static_drive(dyt, "slice")),
                     ("dynamic-balls", lambda: dynamic_drive(dyt))):
        recs[name] = fn()
        print(json.dumps({"drive": name, "root": root, "card": card,
                          **recs[name]}))
    if not args.no_profile:
        recs["balls-profiled"] = static_drive(dyt, "rslice", profile=True)
        print(json.dumps({"drive": "balls-profiled", "root": root,
                          "card": card, **recs["balls-profiled"]}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
