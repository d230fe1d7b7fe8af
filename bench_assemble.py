"""Time the round's record and live assembly (``csrc/round_assemble.cu``,
wrapper ``ops/consume.round_assemble``) and the uniform wave's placement
(``csrc/unif_wave.cu`` ``unif_place``, wrapper ``ops/proposals.
unif_place``) of a checkout on the card, at ``chip_smoke.py``'s phase-2h
and phase-2f inputs: device only (the profiler's kernel durations; the
assembly's two kernels apart and together) and through the wrapper (CUDA
events, back to back).

    python3 bench_assemble.py [--root DIR] [--out FILE]

``--root`` imports ``dynesty_tpu_torch`` from another checkout (an
earlier commit unpacked with ``git archive`` into the git-ignored
``build/``), so that two versions run in turns in one call to the card:
the wrappers' calls are the same in both, and the inputs are made by this
checkout's ``chip_smoke.py``.  Each assembly call writes a round's rows
and refills its live matrix in place, so repeated calls on one round
repeat the same work; each placement call first restores the round's
state (that copy is timed alone and taken off the events time, and is
not a kernel of the placement's).  Prints the card's name and power
limit, one JSON line per case, and exits non-zero without CUDA.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ITERS = 50


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


def assemble_times(cm, torch, cs):
    """The assembly's device and events times at each phase-2h case."""
    recs = []
    for nlive, q, mode, path in cm.ASSEMBLE_CASES:
        outs, live, prop, qnc, it0, birth, thr = cm.assemble_inputs(
            nlive, q, mode, path)
        out = cs.assemble_buffers(cm.ASSEMBLE_ROUNDS, q, nlive, cm.C_NDIM,
                                  cm.C_NPDIM, torch.float64, "cuda")
        for t in out.values():
            t.zero_()
        lv = live.clone()
        ridx = torch.tensor(1, device="cuda")

        def call():
            cs.round_assemble(outs, lv, prop, qnc, prop[:, cm.C_IL + 2:],
                              it0, birth, thr, out, ridx, ndim=cm.C_NDIM)

        rec = {"kernel": "round_assemble", "nlive": nlive, "q": q,
               "mode": mode, "path": path, "dtype": "float64",
               "events_us": 1e3 * cm._time_ms(call, 200)}
        for part, only in (("both", "assemble"),
                           ("records", "assemble_records"),
                           ("refill", "assemble_refill")):
            rec[f"{part}_device_us"] = 1e3 * cm._device_ms(call, ITERS,
                                                            only=only)
        recs.append(rec)
    return recs


def place_times(cm, torch, pr):
    """``unif_place``'s device and events times at each phase-2f case in
    its overflow state, float64 and float32."""
    recs = []
    for kind, ndim, ncdim, q in cm.UNIF_CASES:
        for dtype in (torch.float64, torch.float32):
            rb, inp = cm.unif_wave_round(kind, q, ndim, ncdim, dtype,
                                         "overflow")
            pr.unif_valid(rb, inp["uc"], inp["sq"], inp["ua"],
                          inp["accept"])
            st0 = rb.state.clone()

            def call():
                rb.state.copy_(st0)
                pr.unif_place(rb, inp["u_prop"], inp["v"], inp["logl"])

            restore_us = 1e3 * cm._time_ms(lambda: rb.state.copy_(st0), 200)
            recs.append({
                "kernel": "unif_place", "kind": kind, "ndim": ndim,
                "ncdim": ncdim, "q": q, "dtype": str(dtype).split(".")[1],
                "events_us": 1e3 * cm._time_ms(call, 200) - restore_us,
                "device_us": 1e3 * cm._device_ms(call, ITERS,
                                                 only="unif_place")})
    return recs


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(prog="bench_assemble",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="the checkout whose dynesty_tpu_torch is timed")
    ap.add_argument("--out", help="also write the records here (JSON)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_assemble: no CUDA device")
    # the checkout's package first: chip_smoke's own imports then find it
    sys.path.insert(0, root)
    import dynesty_tpu_torch  # noqa: F401
    from dynesty_tpu_torch.ops import consume as cs
    from dynesty_tpu_torch.ops import proposals as pr
    # this checkout's chip_smoke.py (the root's may be older), by its path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cm)
    card = _card()
    print(card)
    print(json.dumps({"root": root, "package": os.path.dirname(
        dynesty_tpu_torch.__file__), "card": card}))
    recs = assemble_times(cm, torch, cs) + place_times(cm, torch, pr)
    for rec in recs:
        rec["root"] = root
        print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": root, "cases": recs}, f,
                      indent=1)


if __name__ == "__main__":
    main()
