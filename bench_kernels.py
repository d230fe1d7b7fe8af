"""Time the port's hand-written kernels of a checkout on the card, case
group by case group, at ``chip_smoke.py``'s inputs: device only (the
profiler's kernel durations) and through the wrapper or the replay (CUDA
events, back to back; the host clock with the wait and the flag read for
a replay).

    python3 bench_kernels.py [--root DIR] [--out FILE] [--groups a,b]
                             [--generic-rows]

``--root`` imports ``dynesty_tpu_torch`` from another checkout (an
earlier commit unpacked with ``git archive`` into the git-ignored
``build/``), so that two versions run in turns in one call to the card
(``chip_smoke.py --parent DIR`` runs this script so); the inputs are made
by this checkout's ``chip_smoke.py``, and a case a version lacks is
called through that version's own signature.  A redesign adds its
kernels' cases to ``GROUPS``.  The groups:

* ``assemble``: the round's record and live assembly
  (``round_assemble``, its two kernels apart and together) at each
  phase-2h case;
* ``place``: the wave's placement (``unif_place``) at each phase-2f case
  in its overflow state, float64 and float32 (each call first restores
  the round's state; that copy is timed alone and taken off);
* ``doubling``: each doubling kernel alone in each mode both versions
  have (``doubling_point``'s two end probes, ``doubling_expand``'s start
  and doubling, ``doubling_shrink``'s candidate and resolution,
  ``doubling_halve``), and each captured segment's device work outside
  its likelihood (``segment_span``: its draws and hand-written kernels,
  each version's own: since the doubling's and the candidate's probes
  were folded in, a doubling is the draw and ``doubling_expand``, a
  candidate ``doubling_shrink`` alone, a resolution the draw and
  ``doubling_shrink``, and the start draws twice; before, a doubling and
  a candidate drew and launched ``doubling_point`` first), at (256, 3)
  in float64;
* ``valid``: ``unif_valid`` over the cube and over unions of 1, 4 and 16
  ellipsoids at (256, 3) in float64, alone and ``span``, every launch
  between the draws and the likelihood (before the fold: the union's
  subtraction and einsum, the kernel and the clamp), with the sha256 of
  its outputs' bytes (``digest``); and over balls and cubes about 2048
  and 16384 centres in 3 dimensions and 2048 in 15 (phase 2f's friends
  cases) in float64 and float32, its friends mode from the draws (before
  it: the eager union, the centres' gather, the candidate's matrix
  product, the distances' einsum, norm or largest entry, count and test,
  then the kernel, as ``span``), with the same digest;
* ``replays``: the five captured doubling segments' replays (rslice at
  (256, 3)) and the captured waves' (cube, three ellipsoids, balls and
  cubes about 2048 centres);
* ``refit``: the ellipsoid refit of a chained unif round at every
  phase-2i stack (the eggbox's, the heavy drive's, 3000 points in three
  ellipsoids, 15 dimensions, 16384 points in 20 ellipsoids, and past
  ``refit_fit``'s shared-memory ceiling 16384 members of one slot and 40
  dimensions; float64) through ``make_ellipsoid_refit``, which every
  version has (before the refit kernels, the eager torch refit that ran
  between two rounds' prologues: its span; since, the two kernels into
  new tensors), device only, by events and by the host clock with the
  wait; and, where the checkout has the kernels, the two on buffers made
  once, as a round's prologue launches them (``kernels_*``), with the
  sha256 of their outputs' bytes (``digest``); then that digest alone at
  every phase-2i stack and edge stack in float64 and float32 on the
  inputs of ``REFIT_SEEDS`` (``ellipsoid_refit_bits``):
  ``chip_smoke.py --parent`` reports where two versions' bits differ;
* ``prior``: the beta-prior drive's prior (three Betas) vmapped over
  (256, 3), as a wave calls it: one call by events, its device time and
  kernel count from the profiler, whether a CUDA graph capture of it
  raises (before the Beta kernels: the eager bisection's ~4.7e5 launches
  and its copy from the host), a replay where it does not, and the
  sha256 of its output; then ``beta_ppf`` at (256,), (768,) and (2^20,)
  in float64 and float32 (device only and events, with a digest), the
  digests of phase 2j's 25-pair sweep at (256,), either side of the
  tree walk's level switch and (2^20,), the vmapped prior of a mixed
  three-Beta table at 256 rows and either side of the switch (device
  only, its ``beta_ppf`` kernels and digest), and of two Beta(2, 5)
  columns of 2^19 rows (the (2^20,) call's elements as a table).  It
  runs last, so that a capture that raises follows every other group.

``--generic-rows`` also times ``unif_valid`` built with its generic row
loop at every width (``-DUNIF_VALID_ROW_REGISTERS=0``) against the
build that holds a row of 2 or 3 dimensions in registers, in turns on
the ``valid`` group's inputs.

Prints the card's name and power limit, one JSON line per record, and
exits non-zero without CUDA.
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

ITERS = 50
# the seeds of the refit's inputs whose outputs' bits two versions compare
REFIT_SEEDS = (56432, 1, 2)
# the generic-row build's flag (csrc/unif_wave.cu)
GENERIC_ROWS = "#define UNIF_VALID_ROW_REGISTERS 0\n"


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


def _host_us(fn, n=200):
    for _ in range(5):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t0) / n


def assemble_times(cm, torch):
    """The assembly's device and events times at each phase-2h case."""
    cs = cm.cs
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


def place_times(cm, torch):
    """``unif_place``'s device and events times at each phase-2f case in
    its overflow state, float64 and float32."""
    pr = cm.pr
    recs = []
    for kind, ndim, ncdim, q in cm.UNIF_CASES:
        for dtype in (torch.float64, torch.float32):
            rb, inp = cm.unif_wave_round(kind, q, ndim, ncdim, dtype,
                                         "overflow")
            valid_calls(torch, pr, rb, inp, kind)[0]()
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


def folded(pr):
    """Whether the checkout has the halving's probe and the lane checks'
    forms folded into the kernels."""
    return hasattr(pr, "unif_input_plain")


def friends_folded(pr):
    """Whether the checkout's ``unif_valid`` forms the friends' candidates
    and overlap test from the draws."""
    return hasattr(pr, "friends_union_plain")


def eager_friends_union(torch, kind, rb, inp):
    """The friends' union as the wave ran it before ``unif_valid``'s
    friends mode, from the draws: the candidates and their acceptance."""
    a = rb.arrays
    ctrs, axes, axes_inv = (a[k].to(rb.dtype) for k in
                            ("ctrs", "axes", "axes_inv"))
    x = ctrs[inp["idx"]] + inp["uc"] @ axes
    dt = torch.einsum("qmi,ij->qmj", ctrs[None, :, :] - x[:, None, :],
                      axes_inv)
    if kind == "balls":
        dist = torch.linalg.vector_norm(dt, dim=-1)
    else:
        dist = dt.abs().amax(dim=-1)
    nin = (dist <= 1.0).sum(dim=1).clamp_min(1)
    return x, inp["ua"] < 1.0 / nin.to(rb.dtype)


def probes_folded(pr):
    """Whether the checkout's ``doubling_expand`` and resolution write the
    next probes (its ``doubling_point`` the step's end probes only)."""
    return "draw_x" in inspect.signature(pr.doubling_expand).parameters


def doubling_times(cm, torch):
    """The doubling kernels' device and events times on phase 2g's
    hand-made state at (256, 3) in float64, each kernel and mode on its
    own copy of the state, and each segment's draws and kernels."""
    pr = cm.pr
    q, ndim, dtype = cm.STEP_Q, cm.NDIM, torch.float64
    st, inp = cm.doubling_state(q, ndim, ndim, dtype)
    new = probes_folded(pr)
    recs = []

    def rec(kernel, call, only, **key):
        r = {"kernel": kernel, **key, "q": q, "ndim": ndim,
             "dtype": "float64",
             "events_us": 1e3 * cm._time_ms(call, 200),
             "device_us": 1e3 * cm._device_ms(call, ITERS, only=only)}
        recs.append(r)

    def fresh():
        return cm.doubling_round_on_card(cm._clone(st), inp, False)

    def expand(rb, mode):
        if new:
            pr.doubling_expand(rb, mode, inp["logl_x"], inp["logl_l"],
                               rb.draw_x)
        else:
            pr.doubling_expand(rb, mode, inp["logl_x"], inp["logl_l"])

    def shrink(rb, mode):
        pr.doubling_shrink(rb, mode, inp["v_x"], inp["logl_x"])

    for mode in (pr.P_START_L, pr.P_START_R):
        rb = fresh()
        rec("doubling_point", lambda rb=rb, m=mode: pr.doubling_point(rb, m),
            "doubling_point", mode=mode)
    for mode in (pr.X_INIT, pr.X_DOUBLE):
        rb = fresh()
        rec("doubling_expand", lambda rb=rb, m=mode: expand(rb, m),
            "doubling_expand", mode=mode)
    rb = fresh()
    rec("doubling_halve", lambda: pr.doubling_halve(rb, inp["logl_x"]),
        "doubling_halve")
    for mode in (pr.S_CANDIDATE, pr.S_RESOLVE):
        rb = fresh()
        rec("doubling_shrink", lambda rb=rb, m=mode: shrink(rb, m),
            "doubling_shrink", mode=mode)

    # each segment's launches but its likelihood's, in the version's order
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cm.SEED)
    rb = fresh()

    def draw():
        rb.draw.uniform_(generator=gen)

    def start():
        draw()
        pr.doubling_point(rb, pr.P_START_L)
        pr.doubling_point(rb, pr.P_START_R)
        if new:
            draw()
        expand(rb, pr.X_INIT)

    def double():
        draw()
        if not new:
            pr.doubling_point(rb, pr.P_DOUBLE)
        expand(rb, pr.X_DOUBLE)

    def candidate():
        if not new:
            draw()
            pr.doubling_point(rb, pr.P_SHRINK)
        shrink(rb, pr.S_CANDIDATE)

    def resolve():
        if new:
            draw()
        shrink(rb, pr.S_RESOLVE)

    for kind, fn in (("start", start), ("double", double),
                     ("candidate", candidate),
                     ("halve", lambda: pr.doubling_halve(rb, inp["logl_x"])),
                     ("resolve", resolve)):
        rec("segment_span", fn, None, kind=kind)
    return recs


def valid_calls(torch, pr, rb, inp, kind):
    """``unif_valid`` on a wave's inputs through the checkout's own
    signature, alone and with every launch a wave makes between its draws
    and its likelihood (before the fold: the union's subtraction and
    einsum, the kernel, the likelihood input's clamp; over balls and
    cubes before the friends' mode: the eager union and the kernel)."""
    if kind in ("balls", "cubes") and not friends_folded(pr):
        x, acc = eager_friends_union(torch, kind, rb, inp)

        def call():
            pr.unif_valid(rb, x, None, acc, inp["u_ex"])

        def span():
            xs, accs = eager_friends_union(torch, kind, rb, inp)
            pr.unif_valid(rb, xs, None, accs, inp["u_ex"])
        return call, span
    if folded(pr):
        def call():
            pr.unif_valid(rb, inp["uc"], inp["ua"], inp.get("idx"),
                          inp["u_ex"])
        return call, call

    def forms():
        d = inp["uc"][:, None, :] - rb.arrays["ctrs"].to(rb.dtype)[None]
        return torch.einsum("qmi,mij,qmj->qm", d,
                            rb.arrays["ams"].to(rb.dtype), d).contiguous()

    sq = forms() if rb.m else None

    def call():
        pr.unif_valid(rb, inp["uc"], sq, inp["ua"], None)

    def span():
        s = forms() if rb.m else None
        pr.unif_valid(rb, inp["uc"], s, inp["ua"], None)
        inp["uc"].clamp(0.0, 1.0)

    return call, span


def union_inputs(cm, torch, m):
    """A round over the union of ``m`` ellipsoids at (256, 3) in float64
    and one wave's draws, as ``chip_smoke.unif_union_cases`` makes them."""
    import numpy as np
    pr = cm.pr
    dtype, q = torch.float64, cm.STEP_Q
    rs = np.random.Generator(np.random.PCG64(cm.SEED + 7 * m))
    arrays = cm.union_arrays(m, dtype)
    layout = {k: (tuple(arrays[k].shape), arrays[k].stride(),
                  arrays[k].storage_offset(), arrays[k].dtype)
              for k in pr.UNIF_ARRAYS["ellipsoids"]}
    rb = pr.UnifRound(q, cm.NDIM, cm.NDIM, cm.NDIM, dtype, "cuda", None,
                      layout)
    rb.start(cm.STEP_LOGLSTAR, arrays, 1 << 30)
    uc = rs.uniform(0.0, 1.0, (q, cm.NDIM))
    ctrs = arrays["ctrs"].cpu().numpy()
    near = np.arange(q) % 2 == 0
    uc[near] = ctrs[np.arange(q)[near] % m] + \
        rs.normal(0.0, 0.05, (int(near.sum()), cm.NDIM))
    return rb, {"uc": cm._cuda_t(uc, dtype),
                "ua": cm._cuda_t(rs.random(q), dtype), "idx": None,
                "u_ex": None}


def valid_cases(cm, torch):
    """The ``valid`` group's rounds and draws: the cube (phase 2f's
    overflow state), the unions of 1, 4 and 16 ellipsoids and the
    friends' cases in float64 and float32."""
    cases = [("cube", None) + cm.unif_wave_round(
        "cube", cm.STEP_Q, cm.NDIM, cm.NDIM, torch.float64, "overflow")]
    for m in cm.UNION_SLOTS:
        cases.append(("ellipsoids", m) + union_inputs(cm, torch, m))
    for dtype in (torch.float64, torch.float32):
        for kind in cm.FRIENDS:
            for nctrs, n in cm.FRIENDS_CASES:
                cases.append((kind, (nctrs, n)) + cm.friends_case_round(
                    kind, nctrs, n, dtype))
    return cases


def valid_digest(torch, rb):
    """The sha256 of ``unif_valid``'s outputs' bytes: valid, the
    likelihood's input and its clamp."""
    h = hashlib.sha256()
    for t in (rb.valid, rb.u_prop, rb.uclamp):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def unif_times(cm, torch):
    """``unif_valid``'s device and events times over the cube, the unions
    and the friends, alone and with the launches around it, and the
    digest of its outputs, which two versions compare."""
    recs = []
    for kind, m, rb, inp in valid_cases(cm, torch):
        call, span = valid_calls(torch, cm.pr, rb, inp, kind)
        rec = {"kernel": "unif_valid", "kind": kind, "q": rb.q,
               "ndim": rb.ndim, "dtype": str(rb.dtype).split(".")[-1]}
        if kind in cm.FRIENDS:
            rec.update(nctrs=m[0], ncdim=m[1])
        else:
            rec["m"] = m
        span()
        torch.cuda.synchronize()
        rec["digest"] = valid_digest(torch, rb)
        rec.update({
            "events_us": 1e3 * cm._time_ms(call, 200),
            "device_us": 1e3 * cm._device_ms(call, ITERS, only="unif_valid"),
            "span_events_us": 1e3 * cm._time_ms(span, 200),
            "span_device_us": 1e3 * cm._device_ms(span, ITERS)})
        recs.append(rec)
    return recs


def generic_rows_times(cm, torch, root):
    """``unif_valid`` built as the checkout builds it (a row of 2 or 3
    dimensions in registers) and with the generic row loop at every width,
    in turns (registers, generic, generic, registers) on the ``valid``
    group's inputs; raises unless both builds write the same bits."""
    from dynesty_tpu_torch.ops import build
    pr = cm.pr
    with open(os.path.join(root, "dynesty_tpu_torch", "csrc",
                           "unif_wave.cu")) as f:
        text = f.read()
    if "UNIF_VALID_ROW_REGISTERS" not in text:
        raise SystemExit("bench_kernels: this checkout's unif_wave.cu has "
                         "no generic-row build")
    path = os.path.join(root, "build", "unif_wave_generic_rows.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(GENERIC_ROWS + text)
    ref = pr._entry("unif_wave", "unif_valid", "f64")
    gen = getattr(build.load_library("unif_wave_generic_rows", src=path),
                  "dynesty_unif_valid_f64")
    gen.argtypes, gen.restype = ref.argtypes, ref.restype
    recs = []
    for kind, m, rb, inp in valid_cases(cm, torch):
        if kind in cm.FRIENDS:
            continue
        draws = (inp["uc"], inp["ua"], inp.get("idx"), inp["u_ex"])
        outs = {}
        times = {"registers": [], "generic": []}
        for variant in ("registers", "generic", "generic", "registers"):
            rb._valid_fn = ref if variant == "registers" else gen
            pr.unif_valid(rb, *draws)
            torch.cuda.synchronize()
            outs[variant] = [t.clone() for t in (rb.valid, rb.u_prop,
                                                 rb.uclamp)]
            times[variant].append(
                (1e3 * cm._device_ms(lambda: pr.unif_valid(rb, *draws),
                                     ITERS, only="unif_valid"),
                 1e3 * cm._time_ms(lambda: pr.unif_valid(rb, *draws), 200)))
        rb._valid_fn = ref
        same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(outs["registers"], outs["generic"]))
        if not same:
            raise RuntimeError(f"the generic-row build of unif_valid "
                               f"differs at {kind} m {m}")
        for variant, ts in times.items():
            recs.append({"kernel": "unif_valid", "kind": kind, "m": m,
                         "variant": variant, "q": rb.q, "ndim": rb.ndim,
                         "dtype": "float64",
                         "device_us": [t[0] for t in ts],
                         "events_us": [t[1] for t in ts]})
    return recs


def replay_times(cm, torch):
    """The five captured doubling segments' replays (rslice doubling at
    (256, 3)) and the captured waves' (cube, three ellipsoids, balls and
    cubes about 2048 centres, (256, 3)): device only, back-to-back
    events, and the host clock around one replay with its wait and flag
    read."""
    from dynesty_tpu_torch.utils.misc import Timings
    cm._gauss_setup()
    dtype, q = torch.float64, cm.STEP_Q
    cache = {}
    cm._capture_rounds(cm._capture_like(False, dtype), "rslice",
                       cm.NDIM + 3, q, dtype, (cm.SEED, cm.SEED + 1), cache,
                       Timings(), doubling=True)
    entry = next(iter(cache.values()))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cm.SEED)
    recs = []
    for name in cm.DOUBLING_SEGMENTS:
        graph = entry.graphs[name]
        recs.append({
            "kernel": "doubling_segment", "kind": name, "q": q,
            "ndim": cm.NDIM, "dtype": "float64",
            "replay_device_us": 1e3 * cm._device_ms(graph.replay, ITERS),
            "replay_events_us": 1e3 * cm._time_ms(graph.replay, 200),
            "replay_host_us": _host_us(
                lambda name=name: entry.replay(name, gen))})
    for kind in ("cube", "ellipsoids") + tuple(cm.FRIENDS):
        cache = {}
        cm._capture_waves(cm._capture_like(False, dtype), kind, q, dtype,
                          (cm.SEED, cm.SEED + 1), cache, Timings())
        wave = next(iter(cache.values()))

        def host():
            wave.graph.replay()
            torch.cuda.current_stream().synchronize()
            return bool(wave.flag[1][0])

        recs.append({
            "kernel": "wave", "kind": kind, "q": q, "ndim": cm.NDIM,
            "dtype": "float64",
            "replay_device_us": 1e3 * cm._device_ms(wave.graph.replay,
                                                    ITERS),
            "replay_events_us": 1e3 * cm._time_ms(wave.graph.replay, 200),
            "replay_host_us": _host_us(host)})
    return recs


def refit_digest(torch, rr, rf, out):
    """The sha256 of the refit's outputs' bytes: each point's slot, the
    slots re-fitted and the wave's arrays."""
    h = hashlib.sha256()
    for t in (rf.idx, rf.keep) + tuple(out[k] for k in rr.REFIT_FIELDS):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def refit_times(cm, torch):
    """The ellipsoid refit at every phase-2i stack in float64:
    ``make_ellipsoid_refit``'s function (the span), and the two kernels
    on buffers made once where the checkout has them, with the digest of
    their outputs; then the digests alone at every phase-2i stack and
    edge stack, float64 and float32, on the inputs of ``REFIT_SEEDS``
    (``ellipsoid_refit_bits``), which two versions' runs compare."""
    import importlib.util as iu
    from dynesty_tpu_torch.internal.kernels import make_ellipsoid_refit
    has_kernels = iu.find_spec("dynesty_tpu_torch.ops.ellipsoid_refit")
    recs = []
    for name, n, k, m, d in cm.REFIT_CASES:
        live, arrays = cm.refit_inputs(n, k, m, d)
        u = live[:, :d]
        refit = make_ellipsoid_refit(d)

        def span():
            refit(u, arrays)

        def waited():
            span()
            torch.cuda.current_stream().synchronize()

        rec = {"kernel": "ellipsoid_refit", "kind": name, "nlive": n, "m": m,
               "ndim": d, "dtype": "float64",
               "span_device_us": 1e3 * cm._device_ms(span, ITERS),
               "span_events_us": 1e3 * cm._time_ms(span, 200),
               "span_host_us": _host_us(waited)}
        if has_kernels:
            from dynesty_tpu_torch.ops import ellipsoid_refit as rr
            rf = rr.EllipsoidRefit(n, m, d, torch.float64, "cuda")
            out = {key: torch.empty_like(arrays[key])
                   for key in rr.REFIT_FIELDS}

            def kernels():
                rr.ellipsoid_refit(rf, u, arrays, out)

            kernels()
            rec["digest"] = refit_digest(torch, rr, rf, out)
            rec.update({
                "kernels_device_us": 1e3 * cm._device_ms(kernels, ITERS),
                "kernels_events_us": 1e3 * cm._time_ms(kernels, 200)})
            for kernel in cm.REFIT_KERNELS:
                rec[f"{kernel}_device_us"] = 1e3 * cm._device_ms(
                    kernels, ITERS, only=kernel)
        recs.append(rec)
    if not has_kernels:
        return recs
    from dynesty_tpu_torch.ops import ellipsoid_refit as rr
    stacks = [(name, n, k, m, d, None) for name, n, k, m, d in
              cm.REFIT_CASES] + \
        [(case, 200, 3, 8 if case == "empty_pad" else 4, 3, case)
         for case in cm.REFIT_EDGES]
    for name, n, k, m, d, case in stacks:
        for dtype in (torch.float64, torch.float32):
            for seed in REFIT_SEEDS:
                live, arrays = cm.refit_inputs(n, k, m, d, dtype, case,
                                               seed)
                rf = rr.EllipsoidRefit(n, m, d, dtype, "cuda")
                out = {key: torch.empty_like(arrays[key])
                       for key in rr.REFIT_FIELDS}
                rr.ellipsoid_refit(rf, live[:, :d], arrays, out)
                recs.append({"kernel": "ellipsoid_refit_bits", "kind": name,
                             "nlive": n, "m": m, "ndim": d,
                             "dtype": str(dtype).split(".")[1],
                             "seed": seed,
                             "digest": refit_digest(torch, rr, rf, out)})
    return recs


def _digest(torch, *outs):
    h = hashlib.sha256()
    for out in outs:
        h.update(out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def prior_times(cm, torch):
    """The beta-prior drive's prior, three Betas, vmapped over a (256, 3)
    batch as a wave calls it, in float64: one call by events, its device
    time and kernel count from one profiled call, whether a
    ``torch.cuda.graph`` capture of it raises (and with what), a replay's
    events time where it does not, and the sha256 of its output's bytes.
    Before the Beta kernels this is the eager bisection: ~4.7e5 launches
    a call, whose copy of ``a`` from the host no capture takes.  Then,
    through calls every version with the kernels has: ``beta_ppf`` at
    Beta(2, 5) on phase 2j's inputs at (256,), the grouped drive call's
    768 elements and (2^20,), float64 and float32, device only (the
    profiler, ``beta_ppf_kernel``'s launches) and by events, with its
    output's digest; the digest of phase 2j's 25-pair sweep at (256,),
    either side of the tree walk's level switch and (2^20,); and the
    vmapped prior of ``BETA_TABLE``'s three Betas at 256 rows and either
    side of the switch (three launches before the grouped kernel, one
    since), device only, its kernels and digest; and of two Beta(2, 5)
    columns of 2^19 rows (two launches before, one since)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynesty_tpu_torch import models
    pt = models.PriorTransform([models.Beta(a, b)
                                for a, b in cm.BETA_DRIVE_AB])
    u = torch.as_tensor(cm.np.random.Generator(cm.np.random.PCG64(
        cm.SEED)).random((256, 3)), device="cuda")
    call = torch.func.vmap(pt)
    out = call(u)
    rec = {"kernel": "prior_transform", "ndim": 3, "q": 256,
           "dtype": "float64", "events_us": 1e3 * cm._once_ms(
               lambda: call(u))}
    rec["digest"] = _digest(torch, out)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call(u)
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    rec["kernels"], rec["device_us"] = len(spans), float(sum(spans))
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            call(u)
        rec["capture"] = "captured"
        rec["replay_us"] = 1e3 * cm._time_ms(graph.replay, 20)
    except Exception as err:  # noqa: BLE001 - the outcome is the record
        rec["capture"] = f"raises {type(err).__name__}: {err}"[:300]
    recs = [rec]
    if cm.bp is None:
        return recs
    bp = cm.bp
    switch = cm.beta_switch()
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[1]
        for n in (256, 768, cm.PRIOR_POINTS):
            x = cm.beta_inputs(n, dtype)
            ppf = lambda: bp.beta_ppf(x, 2.0, 5.0)  # noqa: E731
            iters = 20 if n <= 4096 else 5
            recs.append({
                "kernel": "beta_ppf", "kind": "Beta(2, 5)", "n": n,
                "dtype": tag, "digest": _digest(torch, ppf()),
                "device_us": 1e3 * cm._device_ms(ppf, iters,
                                                 only="beta_ppf_kernel"),
                "events_us": 1e3 * cm._time_ms(ppf, iters)})
        for n in (256, switch, switch + 1, cm.PRIOR_POINTS):
            x = cm.beta_inputs(n, dtype)
            recs.append({"kernel": "beta_ppf", "kind": "sweep", "n": n,
                         "dtype": tag, "digest": _digest(
                             torch, *(bp.beta_ppf(x, a, b)
                                      for a, b in cm.BETA_PAIRS))})
        cols = [c for c, _, _ in cm.BETA_TABLE]
        table = torch.func.vmap(models.PriorTransform(
            [models.Beta(a, b) for _, a, b in cm.BETA_TABLE]))
        for rows in (256, switch // 3, switch // 3 + 1):
            x = torch.as_tensor(cm.np.random.Generator(cm.np.random.PCG64(
                cm.SEED)).random((rows, 5)), dtype=dtype,
                device="cuda")[:, cols]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                table(x)
                torch.cuda.synchronize()
            kernels = sum(e.device_type == DeviceType.CUDA and
                          "beta_ppf_kernel" in e.name for e in prof.events())
            recs.append({
                "kernel": "prior_transform", "kind": "table", "rows": rows,
                "dtype": tag, "digest": _digest(torch, table(x)),
                "beta_ppf_kernels": kernels,
                "device_us": 1e3 * cm._device_ms(lambda: table(x), 10),
                "events_us": 1e3 * cm._time_ms(lambda: table(x), 10)})
        # two Beta(2, 5) columns of 2^19 rows: the (2^20,) call's
        # elements as a table (one thread an element for both)
        pair = torch.func.vmap(models.PriorTransform(
            [models.Beta(2.0, 5.0), models.Beta(2.0, 5.0)]))
        x = cm.beta_inputs(cm.PRIOR_POINTS, dtype).reshape(-1, 2)
        recs.append({
            "kernel": "prior_transform", "kind": "two columns",
            "rows": x.shape[0], "dtype": tag, "digest": _digest(
                torch, pair(x)),
            "device_us": 1e3 * cm._device_ms(lambda: pair(x), 5,
                                             only="beta_ppf_kernel"),
            "events_us": 1e3 * cm._time_ms(lambda: pair(x), 5)})
    return recs


# the case groups, in the order they run: each redesign adds its kernels'
GROUPS = (("assemble", assemble_times), ("place", place_times),
          ("doubling", doubling_times), ("valid", unif_times),
          ("replays", replay_times), ("refit", refit_times),
          ("prior", prior_times))


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(prog="bench_kernels",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="the checkout whose dynesty_tpu_torch is timed")
    ap.add_argument("--out", help="also write the records here (JSON)")
    ap.add_argument("--groups", default=",".join(g for g, _ in GROUPS),
                    help="comma-separated case groups to run (default: "
                         "all)")
    ap.add_argument("--generic-rows", action="store_true",
                    help="also time unif_valid's generic-row build against "
                         "the checkout's, in turns")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA device")
    # the checkout's package first: chip_smoke's own imports then find it
    sys.path.insert(0, root)
    import dynesty_tpu_torch  # noqa: F401
    # this checkout's chip_smoke.py (the root's may be older), by its path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cm)
    card = _card()
    print(card)
    print(json.dumps({"root": root, "package": os.path.dirname(
        dynesty_tpu_torch.__file__), "folded": folded(cm.pr), "card": card}))
    recs = []
    groups = args.groups.split(",")
    for name, group in GROUPS:
        if name not in groups:
            continue
        for rec in group(cm, torch):
            recs.append({"group": name, **rec})
    if args.generic_rows:
        recs += [{"group": "generic_rows", **rec}
                 for rec in generic_rows_times(cm, torch, root)]
    for rec in recs:
        rec["root"] = root
        print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": root, "folded": folded(cm.pr),
                       "cases": recs}, f, indent=1)


if __name__ == "__main__":
    main()
