"""Time the consume scan kernel (``csrc/consume_scan.cu``) of a checkout
on the card: device only (profiler kernel durations) and through its
wrapper (CUDA events), one round at the drives' widths, thin and general;
and, where the checkout has the chain probe, the device time of one step
of the round's evidence chain alone (one thread, dependent logaddexps).

    python3 bench_consume.py [--root DIR] [--out FILE] [--stages]

``--root`` imports ``dynesty_tpu_torch`` from another checkout (an
earlier commit unpacked with ``git archive`` into the git-ignored
``build/``), so that two versions run in turns in one call to the card:
the wrapper's call is the same in both.  Prints the card's name and power
limit, one JSON line per round, and exits non-zero without CUDA.
``--stages`` also reads the kernel's stage clocks of each round (where
the checkout has them, ``consume.STAGE_CLOCKS``): the SM clock at the
end of each stage of the first chunk, in cycles from the kernel's start.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

SEED = 56432
# (nlive, q, mode, thin allowed): the balls and heavy drives' batch
# rounds, queue mode at 1000 and 2048, and a live set whose logl the
# redesigned kernel keeps in global memory
ROUNDS = [(2048, 256, "batch", True), (2048, 256, "batch", False),
          (3000, 256, "batch", True), (3000, 256, "batch", False),
          (1000, 256, "queue", False), (2048, 256, "queue", False),
          (16384, 256, "queue", False)]
# passes of the chain probe over a round's chain
REPS = 64


def round_inputs(cs, nlive, q, mode, thin):
    """One round's arguments (the 'thin' state of ``chip_smoke.py``'s
    consume phase: every proposal above the q-th smallest live logl, no
    stop)."""
    rs = np.random.Generator(np.random.PCG64(SEED))
    logl = rs.normal(size=nlive) * 2.0
    thr = np.sort(logl)[q - 1]
    qlogl = thr + np.abs(rs.normal(size=q)) * 3.0 + 1e-3
    qnc = rs.integers(1, 30, q)
    dev = "cuda"
    live_logl = torch.as_tensor(logl, device=dev)
    f = torch.zeros((), dtype=torch.float64, device=dev)
    i = torch.zeros((), dtype=torch.int64, device=dev)
    b = torch.zeros((), dtype=torch.bool, device=dev)
    st = {k: (f - 1e30 if k in ("logz", "loglstar") else f)
          for k in cs.FLOAT_KEYS}
    st.update({k: (b if k in cs.BOOL_KEYS else i) for k in cs.INT_KEYS})
    limits = {"dlogz": -math.inf, "logl_max": math.inf,
              "max_accepts": 2 ** 30, "max_nc": 2 ** 30}
    sorted_logl, sort_idx = torch.sort(live_logl, stable=True)
    th = (sort_idx, sorted_logl, torch.ones((), dtype=torch.bool,
                                            device=dev)) if thin else None
    return (st, live_logl, torch.as_tensor(qlogl, device=dev),
            torch.as_tensor(qnc, device=dev), limits), \
        dict(batch=mode == "batch",
             dlv_default=float(np.log1p(1.0 / nlive)), thin=th)


def events_ms(fn, iters=50):
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


def device_ms(fn, iters=50):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)),
        help="the checkout whose dynesty_tpu_torch is timed")
    ap.add_argument("--out", help="also write the records here (JSON)")
    ap.add_argument("--stages", action="store_true",
                    help="also read each round's stage clocks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_consume: CUDA is not available")
    sys.path.insert(0, os.path.abspath(args.root))
    from dynesty_tpu_torch.ops import consume as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"dynesty_tpu_torch from {os.path.dirname(cs.__file__)}")
    recs = []
    for nlive, q, mode, thin in ROUNDS:
        a, kw = round_inputs(cs, nlive, q, mode, thin)

        def call():
            return cs.consume_round(*a, **kw)

        ev = events_ms(call)
        recs.append({"nlive": nlive, "q": q, "mode": mode,
                     "path": "thin" if thin else "general",
                     "events_ms": ev, "card": card})
    # device-only last: a profiler slows every later launch
    for rec, (nlive, q, mode, thin) in zip(recs, ROUNDS):
        a, kw = round_inputs(cs, nlive, q, mode, thin)
        rec["device_ms"] = device_ms(lambda: cs.consume_round(*a, **kw))
        if hasattr(cs, "chain_probe"):
            # the round's own evidence chain alone: q dependent logaddexps
            # on one thread, REPS passes; q steps of it are the round's
            # least time
            logwt = cs.consume_round(*a, **kw)[0][5].clone()
            t = device_ms(lambda: cs.chain_probe(logwt, a[0]["logz"], REPS),
                          5)
            rec["chain_bound_ms"] = t / REPS
        print(json.dumps(rec))
    if args.stages and hasattr(cs, "STAGE_CLOCKS"):
        for nlive, q, mode, thin in ROUNDS:
            a, kw = round_inputs(cs, nlive, q, mode, thin)
            cs.consume_round(*a, **kw)
            cs.STAGE_CLOCKS = torch.zeros(len(cs.STAGES), dtype=torch.int64,
                                          device="cuda")
            cs.consume_round(*a, **kw)
            clk = cs.STAGE_CLOCKS.tolist()
            cs.STAGE_CLOCKS = None
            rec = {"nlive": nlive, "q": q, "mode": mode,
                   "path": "thin" if thin else "general",
                   "stage_cycles": {k: v - clk[0] for k, v in zip(
                       cs.STAGES, clk) if v}, "card": card}
            recs.append(rec)
            print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
