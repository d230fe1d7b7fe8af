"""Time the uniform rejection waves and the doubling slice round of a
checkout on the card, end to end: drives of ``chip_smoke.py`` on the 3-D
correlated Gaussian (rho = 0.95, prior box +-10, seed 56432).  Three whose
waves are ``unif``:

* heavy: the JAX package's heavy bench, ``nlive=3000, bound='multi',
  sample='unif', queue_size=256, rounds_per_dispatch=12``, the Gaussian
  plus 1e-6 times a float32 tanh matvec chain of width 256 and depth 384
  (weights from seed 1234);
* default: ``NestedSampler(loglike, ptform, 3)`` with every other
  argument at its default (multi / unif / bootstrap 5, nlive 500);
* balls: ``nlive=2048, bound='balls', sample='rslice'``, whose unit-cube
  phase is its only ``unif`` work;
* balls-unif and cubes-unif: ``nlive=2048, bound='balls'|'cubes',
  sample='unif'``, every other argument at its default (bootstrap 5):
  every wave over the friends' union of the 2048 live points.

And two with the sampler given as ``RSliceSampler(slice_doubling=True)``
(``bench_doubling_graph.py`` runs these by default):

* doubling: ``nlive=500, bound='single'`` (the smoke's phase 11);
* doubling-balls: ``nlive=2048, bound='balls'`` (phase 11b, the main
  path's width).

And two more of the smoke's drives: rwalk (the default in 15 dimensions,
multi/rwalk at nlive 1000 on the 15-D standard normal, phase 9) and
eggbox (``dynesty_tpu_torch.models.Eggbox``, multi/unif at nlive 1000,
``queue_size=256``, to dlogz 0.01, phase 24).

    python3 bench_unif_graph.py [--root DIR] [--out FILE] [--no-profile]
                                [--drives heavy,default,balls] [--split]

For each drive: wall, ``Timings['dispatch']``, the waves (``sync_wave``:
one flag read a wave in both the eager and the captured round), the
uniform rounds and the host ms a wave spends in their calls (counted at
``make_unif_round``'s round function, which every version has), the
slice rounds' flag reads (``sync_slice``: one a loop turn in both the
eager and the captured round) and the dispatch ms a read, niter, ncall,
logz and logzerr, ``sync_round``, ``n_round``, ``n_refit`` and
``nc_launched`` (so that two checkouts can be held to the same run), and
the capture counters where the checkout has them.  Then the drive once
more under ``torch.profiler`` (device activity only): the device's busy
time (the union of its kernels' and copies' intervals), over the
profiled drive's wall and over the unprofiled one's, and so its idle
share.  The profiler slows the host, so the share over the profiled wall
is an upper bound on the unprofiled drive's.

With ``--split``, the drive once more with host timers around the parts
of a fused round (:func:`split_round`): the host ms of each part, summed
over the drive's dispatches, exclusive of the parts inside it; and, for
the prologue's and epilogue's replays and each wave's replay, the span
between two CUDA events around the call (the device's time from
reaching the call to the end of its work, the replay's launch latency
included), in all and a call (``split_device_spans``).

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

SEED, NDIM = 56432, 3
H_WIDTH, H_LAYERS = 256, 384
_ROUNDS = {"rounds": 0, "host_s": 0.0}
_GAUSS = {}


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


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


def heavy_loglike():
    """The heavy bench's likelihood: the Gaussian in float64 plus 1e-6
    times the sum of a float32 tanh chain (an orthogonal matrix scaled to
    spectral norm 0.9, an input map; TF32 off)."""
    rng = np.random.Generator(np.random.PCG64(1234))
    q, _ = np.linalg.qr(rng.standard_normal((H_WIDTH, H_WIDTH)))
    a = torch.as_tensor(0.9 * q, dtype=torch.float32, device="cuda")
    w = torch.as_tensor(rng.standard_normal((H_WIDTH, NDIM)) /
                        np.sqrt(NDIM), dtype=torch.float32, device="cuda")

    def loglike(x):
        h = torch.tanh(w @ x.to(torch.float32))
        for _ in range(H_LAYERS):
            h = torch.tanh(a @ h)
        return gauss_loglike(x) + 1e-6 * h.sum().to(x.dtype)

    return loglike


def count_rounds():
    """Count every uniform round and the host time spent in its call: its
    waves (``unif_loop``) where the checkout has them apart, else the
    round function ``make_unif_round`` returns."""
    from dynesty_tpu_torch.internal import kernels as tk
    from dynesty_tpu_torch.internal import samplers as ts

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _ROUNDS["host_s"] += time.perf_counter() - t0
            _ROUNDS["rounds"] += 1
            return out
        return call

    if hasattr(tk, "unif_loop"):
        tk.unif_loop = timed(tk.unif_loop)
        return
    make = tk.make_unif_round

    def make_unif_round(*a, **kw):
        return timed(make(*a, **kw))

    tk.make_unif_round = ts.make_unif_round = make_unif_round


# the parts of a fused round timed by split_round: (module, attribute,
# part); the proposal loops under either version's names
SPLIT_PARTS = (
    ("fused", "torch_generator", "generator"),
    ("samplers", "select_starts", "select_starts"),
    ("samplers", "make_ellipsoid_refit", None),
    ("samplers", "ellipsoid_refit", "refit_prologue"),
    ("kernels", "slice_state_machine", "loop"),
    ("kernels", "doubling_round", "loop"),
    ("kernels", "unif_waves", "loop"),
    ("kernels", "rwalk_walk", "loop"),
    ("kernels", "slice_loop", "loop"),
    ("kernels", "doubling_loop", "loop"),
    ("kernels", "unif_loop", "loop"),
    ("kernels", "rwalk_loop", "loop"),
    ("fused", "consume_round", "consume_round"),
)
_SPLIT = {"stack": [], "parts": {}, "calls": {}, "on": False, "events": []}


def _timer(fn, part):
    """``fn`` with its host time added to ``part``, exclusive of the
    timed parts it calls, and its calls counted."""
    def call(*a, **kw):
        if not _SPLIT["on"]:
            return fn(*a, **kw)
        _SPLIT["calls"][part] = _SPLIT["calls"].get(part, 0) + 1
        stack = _SPLIT["stack"]
        stack.append(0.0)
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            dt = time.perf_counter() - t0
            inner = stack.pop()
            parts = _SPLIT["parts"]
            parts[part] = parts.get(part, 0.0) + dt - inner
            if stack:
                stack[-1] += dt
    return call


def _span_timer(fn, part):
    """``fn`` between two CUDA events on the current stream (while the
    split pass is on): the span on the device from the stream reaching
    the call to the end of what it enqueued, summed by ``part`` after
    the drive."""
    def call(*a, **kw):
        if not _SPLIT["on"]:
            return fn(*a, **kw)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a, **kw)
        e1.record()
        _SPLIT["events"].append((part, e0, e1))
        return out
    return call


def split_spans():
    """The device spans of the split pass by part: ms in all, calls, and
    ms a call."""
    torch.cuda.synchronize()
    spans = {}
    for part, e0, e1 in _SPLIT["events"]:
        ms, n = spans.get(part, (0.0, 0))
        spans[part] = (ms + e0.elapsed_time(e1), n + 1)
    return {k: {"ms": ms, "calls": n, "ms_per_call": ms / n}
            for k, (ms, n) in sorted(spans.items())}


def split_round():
    """Host timers around the parts of a fused round, for both versions
    (a part the checkout lacks is skipped): the round's generator, the
    batch threshold (``torch.sort``), ``select_starts``, the proposal
    loop, the consume scan, the device tuning and chain-stop functions,
    the ellipsoid refit of a unif round (``ell_refit``: before the refit
    kernels, the eager refit between two rounds' prologues; since, none,
    and ``refit_prologue`` times the refit's calls inside an eager or a
    captured prologue, while a replayed prologue runs it inside
    ``prologue_replay``), the captured prologue's and
    epilogue's replays and their capture, host reads of a device flag
    outside the loops
    (``Tensor.__bool__``: the round gate), the flat result's download
    (``finish_fused``) and, as ``rest``, the fused call's own time (the
    parent's threshold and load code, record and live assembly, the dicts
    and the final cat; the change's per-dispatch loads and finish)."""
    from dynesty_tpu_torch.internal import fused as tf
    from dynesty_tpu_torch.internal import kernels as tk
    from dynesty_tpu_torch.internal import samplers as ts
    mods = {"fused": tf, "kernels": tk, "samplers": ts}
    for mod, attr, part in SPLIT_PARTS:
        if not hasattr(mods[mod], attr):
            continue
        fn = getattr(mods[mod], attr)
        if part is None:  # a factory: time what it makes
            setattr(mods[mod], attr, (lambda f: lambda *a, **kw: _timer(
                f(*a, **kw), "ell_refit"))(fn))
        else:
            setattr(mods[mod], attr, _timer(fn, part))
    torch.sort = _timer(torch.sort, "threshold_sort")
    torch.Tensor.__bool__ = _timer(torch.Tensor.__bool__, "gate_read")
    if hasattr(tf, "RoundGraphs"):
        g = tf.RoundGraphs
        g.replay_prologue = _timer(_span_timer(
            g.replay_prologue, "prologue_replay"), "prologue_replay")
        g.replay_epilogue = _timer(_span_timer(
            g.replay_epilogue, "epilogue_replay"), "epilogue_replay")
        g.capture = _timer(g.capture, "round_capture")
    if hasattr(tk, "UnifGraph"):
        # a wave's replay, its wait and its flag read (host: inside the
        # loop's part)
        tk.UnifGraph.replay = _span_timer(tk.UnifGraph.replay,
                                          "wave_replay")
    si = ts.InternalSampler
    si.finish_fused = _timer(si.finish_fused, "download")
    for cls in [si] + si.__subclasses__() + [
            c for s_ in si.__subclasses__() for c in s_.__subclasses__()]:
        for meth, part in (("device_tune_fn", "tune_chain"),
                           ("device_chain_stop_fn", "tune_chain")):
            if meth in cls.__dict__:
                setattr(cls, meth, (lambda m, p: lambda self: (
                    lambda f: None if f is None else _timer(f, p))(
                        m(self)))(cls.__dict__[meth], part))
    make = tf.make_fused_round

    def make_fused_round(*a, **kw):
        fn, layout = make(*a, **kw)
        return _timer(fn, "rest"), layout

    tf.make_fused_round = ts.make_fused_round = make_fused_round


def _refit_launches():
    """The refit kernels' launches so far (a replayed prologue's
    included), where the checkout has them."""
    try:
        from dynesty_tpu_torch.ops import ellipsoid_refit as rr
    except ImportError:
        return {}
    return {w.__name__: w.launches for w in rr.WRAPPERS}


def normal_loglike(x):
    """Standard normal in any dimension, normalised."""
    return -0.5 * (x @ x) - 0.5 * x.shape[-1] * np.log(2.0 * np.pi)


def _rwalk(dyt):
    return normal_loglike, dict(nlive=1000, _ndim=15)


def _eggbox(dyt):
    prob = dyt.models.Eggbox()
    return prob.loglike, dict(nlive=1000, bound="multi", sample="unif",
                              queue_size=256, _ndim=prob.ndim,
                              _ptform=prob.ptform, _run={"dlogz": 0.01})


def _doubling(nlive, bound):
    def drive(dyt):
        return gauss_loglike, dict(
            nlive=nlive, bound=bound,
            sample=dyt.internal.samplers.RSliceSampler(slice_doubling=True))
    return drive


DRIVES = {
    "heavy": lambda dyt: (heavy_loglike(), dict(
        nlive=3000, bound="multi", sample="unif", queue_size=256,
        rounds_per_dispatch=12)),
    "default": lambda dyt: (gauss_loglike, {}),
    "balls": lambda dyt: (gauss_loglike, dict(nlive=2048, bound="balls",
                                              sample="rslice")),
    "balls-unif": lambda dyt: (gauss_loglike, dict(
        nlive=2048, bound="balls", sample="unif")),
    "cubes-unif": lambda dyt: (gauss_loglike, dict(
        nlive=2048, bound="cubes", sample="unif")),
    "doubling": _doubling(500, "single"),
    "doubling-balls": _doubling(2048, "balls"),
    "rwalk": _rwalk,
    "eggbox": _eggbox,
}
KEYS = ("dispatch", "refit", "consume", "total", "n_round", "sync_round",
        "sync_wave", "sync_slice", "n_refit", "nc_launched", "n_unif_replay",
        "n_unif_graph", "n_uncaptured", "n_slice_replay",
        "n_doubling_replay", "n_doubling_graph", "n_rwalk_replay",
        "n_dispatch", "n_round_replay", "n_round_graph")


def run_drive(dyt, name, profile=False):
    _ROUNDS.update(rounds=0, host_s=0.0)
    loglike, kw = DRIVES[name](dyt)
    ptform, ndim = kw.pop("_ptform", box_ptform), kw.pop("_ndim", NDIM)
    run_kw = kw.pop("_run", {})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = dyt.NestedSampler(
        loglike, ptform, ndim,
        rstate=np.random.Generator(np.random.PCG64(SEED)), **kw)
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_
        prof = prof_(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    sampler.run_nested(print_progress=False, **run_kw)
    torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    res, t = sampler.results, sampler.timings
    waves, reads = t.get("sync_wave", 0), t.get("sync_slice", 0)
    out = {"wall_s": wall, "niter": int(res.niter),
           "ncall": int(sampler.ncall), "logz": float(res.logz[-1]),
           "logzerr": float(res.logzerr[-1]),
           "unif_rounds": _ROUNDS["rounds"], "waves": waves,
           "unif_host_ms_per_wave": 1e3 * _ROUNDS["host_s"] / max(waves, 1),
           "unif_host_s": _ROUNDS["host_s"],
           "dispatch_ms_per_read": 1e3 * t["dispatch"] / max(reads, 1),
           "timings": {k: t[k] for k in KEYS if k in t}}
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


def main(prog="bench_unif_graph", default_drives="heavy,default,balls"):
    ap = argparse.ArgumentParser(prog=prog,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose dynesty_tpu_torch is timed")
    ap.add_argument("--out", help="also write the records here")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the profiled drives")
    ap.add_argument("--drives", default=default_drives,
                    help="comma-separated drives among "
                    f"{', '.join(DRIVES)}")
    ap.add_argument("--split", action="store_true",
                    help="also run each drive with host timers around the "
                    "parts of a fused round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: CUDA is not available")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import dynesty_tpu_torch as dyt
    if not dyt.__file__.startswith(root):
        raise SystemExit(f"imported {dyt.__file__}, not from {root}")
    drives = args.drives.split(",")
    if not set(drives) <= set(DRIVES):
        raise SystemExit(f"unknown drives {drives}")
    card = _card()
    print(card)
    recs = {"root": root, "card": card}
    _gauss_setup()
    # the kernels of the checkout built, and its path warmed up, before
    # the drives are timed
    from dynesty_tpu_torch.ops import build
    for lib in sorted(p[:-3] for p in os.listdir(build.SRC_DIR)
                      if p.endswith(".cu")):
        build.load_library(lib)
    dyt.NestedSampler(gauss_loglike, box_ptform, NDIM, nlive=500,
                      rstate=np.random.Generator(np.random.PCG64(SEED))
                      ).run_nested(print_progress=False, maxiter=3000)
    if any(d.startswith("doubling") for d in drives):
        dyt.NestedSampler(
            gauss_loglike, box_ptform, NDIM, nlive=200, bound="single",
            sample=dyt.internal.samplers.RSliceSampler(slice_doubling=True),
            rstate=np.random.Generator(np.random.PCG64(SEED))
        ).run_nested(print_progress=False, maxiter=300)
    count_rounds()
    if args.split:
        split_round()
    for name in drives:
        recs[name] = run_drive(dyt, name)
        print(json.dumps({"drive": name, "root": root, "card": card,
                          **recs[name]}))
        if not args.no_profile:
            rec = run_drive(dyt, name, profile=True)
            rec["device_idle_share_unprofiled_wall"] = \
                1.0 - rec["device_busy_s"] / recs[name]["wall_s"]
            recs[f"{name}-profiled"] = rec
            print(json.dumps({"drive": f"{name}-profiled", "root": root,
                              "card": card, **rec}))
        if args.split:
            # the eager refit between rounds reads 0 where there is none
            _SPLIT.update(parts={"ell_refit": 0.0}, calls={"ell_refit": 0},
                          on=True, events=[])
            refit_launches = _refit_launches()
            rec = run_drive(dyt, name)
            _SPLIT["on"] = False
            rec["split_refit_kernel_launches"] = {
                k: v - refit_launches.get(k, 0)
                for k, v in _refit_launches().items()}
            rec["split_calls"] = dict(sorted(_SPLIT["calls"].items()))
            rec["split_device_spans"] = split_spans()
            rounds = rec["timings"]["n_round"]
            rec["split_ms_per_round"] = {
                k: 1e3 * v / rounds for k, v in sorted(
                    _SPLIT["parts"].items())}
            rec["split_s"] = dict(sorted(_SPLIT["parts"].items()))
            recs[f"{name}-split"] = rec
            print(json.dumps({"drive": f"{name}-split", "root": root,
                              "card": card, **rec}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
