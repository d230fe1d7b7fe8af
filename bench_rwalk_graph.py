"""Time the random-walk rounds of a checkout on the card, end to end: the
rwalk drive of ``chip_smoke.py`` (``NestedSampler(loglike, ptform, 15,
nlive=1000)``, every other argument at its default: multi / rwalk, walks
35, on the 15-D standard normal under a uniform prior on +-10, seed
56432).

    python3 bench_rwalk_graph.py [--root DIR] [--out FILE] [--no-profile]

For the drive: wall, ``Timings['dispatch']``, the walk rounds (counted
at ``internal.kernels.rwalk_loop``, the walk apart from its round's
start, or where a checkout lacks it at ``rwalk_walk``, which both the
eager and the captured walk go through) and the host ms a round spends
in that call, dispatch
per round, niter, ncall and logz (so that two checkouts can be held to
the same run), and the capture counters where the checkout has them.
Then the drive once more under ``torch.profiler`` (device activity
only): the device's busy time (the union of its kernels' and copies'
intervals), over the profiled drive's wall and over the unprofiled
one's, and so its idle share.  The profiler slows the host, so the share
over the profiled wall is an upper bound on the unprofiled drive's; the
share over the unprofiled wall takes the device's busy time as the
profiler saw it.

``--root`` imports ``dynesty_tpu_torch`` from another checkout (an
earlier commit unpacked with ``git archive`` into the git-ignored
``build/``), so that two versions run in turns in one call to the card.
Prints the card's name and power limit and one JSON line per drive, and
exits non-zero without CUDA.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 56432
NDIM, NLIVE = 15, 1000
_WALK = {"rounds": 0, "host_s": 0.0}


def normal_loglike(x):
    return -0.5 * (x @ x) - 0.5 * x.shape[-1] * math.log(2.0 * math.pi)


def box_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


def count_walks():
    """Count every walk round and the host time spent in its call."""
    from dynesty_tpu_torch.internal import kernels as tk
    # the walk apart from its round's start where the checkout has it so
    name = "rwalk_loop" if hasattr(tk, "rwalk_loop") else "rwalk_walk"
    walk = getattr(tk, name)

    def rwalk_walk(*a, **kw):
        t0 = time.perf_counter()
        out = walk(*a, **kw)
        _WALK["host_s"] += time.perf_counter() - t0
        _WALK["rounds"] += 1
        return out

    setattr(tk, name, rwalk_walk)


def rwalk_drive(dyt, profile=False):
    _WALK.update(rounds=0, host_s=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = dyt.NestedSampler(
        normal_loglike, box_ptform, NDIM, nlive=NLIVE,
        rstate=np.random.Generator(np.random.PCG64(SEED)))
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_
        prof = prof_(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    sampler.run_nested(print_progress=False)
    torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    res, t = sampler.results, sampler.timings
    keys = ("dispatch", "refit", "consume", "total", "n_round",
            "n_rwalk_replay", "n_rwalk_graph", "n_uncaptured")
    rounds = _WALK["rounds"]
    out = {"wall_s": wall, "niter": int(res.niter),
           "ncall": int(sampler.ncall), "logz": float(res.logz[-1]),
           "logzerr": float(res.logzerr[-1]), "walk_rounds": rounds,
           "walk_host_ms_per_round": 1e3 * _WALK["host_s"] / max(rounds, 1),
           "dispatch_ms_per_walk_round": 1e3 * t["dispatch"] / max(rounds, 1),
           "timings": {k: t[k] for k in keys if k in t}}
    if prof is not None:
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose dynesty_tpu_torch is timed")
    ap.add_argument("--out", help="also write the records here")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the profiled drive")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_rwalk_graph: CUDA is not available")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import dynesty_tpu_torch as dyt
    if not dyt.__file__.startswith(root):
        raise SystemExit(f"imported {dyt.__file__}, not from {root}")
    card = _card()
    print(card)
    recs = {"root": root, "card": card}
    # the kernels of the checkout built, and its path warmed up, before the
    # drive is timed
    from dynesty_tpu_torch.ops import build
    for lib in ("pairwise_min_dist", "consume_scan", "slice_step",
                "rwalk_step"):
        build.load_library(lib)
    dyt.NestedSampler(normal_loglike, box_ptform, NDIM, nlive=500,
                      rstate=np.random.Generator(np.random.PCG64(SEED))
                      ).run_nested(print_progress=False, maxiter=6000)
    count_walks()
    recs["rwalk"] = rwalk_drive(dyt)
    print(json.dumps({"drive": "rwalk", "root": root, "card": card,
                      **recs["rwalk"]}))
    if not args.no_profile:
        rec = rwalk_drive(dyt, profile=True)
        rec["device_idle_share_unprofiled_wall"] = \
            1.0 - rec["device_busy_s"] / recs["rwalk"]["wall_s"]
        recs["rwalk-profiled"] = rec
        print(json.dumps({"drive": "rwalk-profiled", "root": root,
                          "card": card, **rec}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
