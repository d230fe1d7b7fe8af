"""Smoke test of the PyTorch/CUDA port (``dynesty_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--out results.json] [--profile [balls|heavy]]

Phases, in order; any failure raises and exits non-zero:

1. Require CUDA; print the card's name and power limit, the torch/CUDA
   versions, and build the CUDA kernels from ``dynesty_tpu_torch/csrc``
   (one ``nvcc`` for each source, all started together).
2. Compare each kernel path with its plain PyTorch version on the card at
   the shapes the main path gives it and beyond (a shifted cloud, as
   whitened late-run live points look, and p=inf among them), timing the
   kernel, the plain version and a library yardstick with CUDA events.
   Then the consume scan (``consume_phase``): fused rounds over a fixed
   proposal block, each run through the ``consume_scan`` kernel and
   through the plain loop on the same CUDA tensors, at (nlive, q) = (64,
   16), (2048, 256), (3000, 256), (64, 1) and (700, 300) in batch mode
   and (64, 16), (1000, 256), (2048, 256), (64, 1), (700, 300) and
   (16384, 256: the live logl past the kernel's shared memory) in queue
   mode: thin, thin on a plateau, a proposal below the threshold, two
   rounds, one of two rounds active, a ``max_accepts`` stop, a ``dlogz``
   stop at the first and at the middle step, ``max_nc`` and ``logl_max``
   stops at the middle step, a plateau that first appears at the middle
   kill, a state that enters the round in plateau mode, a NaN in the live
   logl, a replay round (``kills0`` 5, ``birth0``) and a live set of
   -inf; the queue path at the largest live set resident in shared
   memory and at one point more; every batch round that does not stop
   also with the thin path forbidden (``_FORCE_GENERAL_CONSUME``), which
   must give the thin path's bits; five float32 rounds, thin and general.
   Every column, counter and the live matrix must be bit-identical (the
   integrator columns counted, and held to 1e-12 relative where a bit
   differs).  The kernel's integrator step against
   ``progress_integration_torch`` on 10^6 states, a quarter at the edges
   (-inf, -1e300), in float64 and float32: the bit-identical share.  The
   chain probe (one thread, dependent logaddexps) against its plain loop.
   The time of one consume round (events, warm), kernel and plain, at the
   full-width shapes, thin and general.  Then the proposal steps
   (``proposal_steps_phase``): the four per-step kernels of the proposal
   loops (``slice_propose``, ``slice_advance``, ``rwalk_propose``,
   ``rwalk_accept``) against their plain versions on hand-made states of
   256 lanes that visit every phase of the slice state machine, accepted
   and rejected steps, done lanes and +-inf likelihoods, at 3, 15 and 48
   dimensions (the walk's at 3, 15, 15 with 12 bounded and 48, each
   without masks and with periodic, reflective and loose dimensions), in
   float64 and float32: every output bit-identical (the walk's clamped
   point among them), the kernel's and the plain version's time per call
   (events, warm, on round buffers made once) and the bound (bytes at
   3.35 TB/s); and the launch floor, an empty kernel of
   ``rwalk_propose``'s grid launched the same way.  Then
   captured-slice (``captured_slice_phase``): slice rounds whose
   iteration is captured as a CUDA graph and replayed against the same
   rounds launched eagerly (a likelihood the capture rule keeps out),
   rslice and slice, float64 and float32, at the main width (256) and the
   narrow width (32), three rounds each on one round cache, with a blob
   and a strict mask with one loose dimension: every column, the blob and
   the generator's offset bit for bit, every iteration but one warm-up a
   replay; the host time of one replay with its wait and flag read
   against an eager iteration's, and events around back-to-back replays.
   Then captured-rwalk (``captured_rwalk_phase``): random-walk rounds
   whose whole walk is captured as one CUDA graph and replayed against
   the same rounds launched eagerly, float64 and float32, widths 256 and
   32, the rwalk drive's 15-D and 15-D with 12 bounded and periodic,
   reflective and loose dimensions, three rounds each on one round cache
   with a blob: every column, the blob and the generator's offset bit for
   bit, every round but the warm-up a replay; then one non-fused
   ``propose_round`` (batch seeding's round) of 32 lanes, three times, on
   a sampler run to 3,000 iterations against the same on a sampler whose
   likelihood the capture rule keeps out (the two runs bit for bit too).
   Then the uniform wave (``unif_kernels_phase``): ``unif_valid`` and
   ``unif_place`` against their plain versions on hand-made states (a
   wave with more successes than free slots, and one with none, whose
   evaluations are carried) over the cube, three ellipsoids padded to
   four slots, balls about 2048 centres (the friends' draws: offsets,
   centre indices, acceptance uniforms), at (256, 3), (32, 3 of 4
   dimensions, the fourth dimension's uniforms with NaN and values
   outside the cube) and 700 lanes (three chunks of ``unif_place``'s
   block), float64 and float32; ``unif_valid`` over unions of 1, 4 and
   16 ellipsoids at (256, 3); its friends mode over balls and cubes
   about 2048 and 16384 centres in 3 dimensions and 2048 in 15 (of 4
   and 16, one loose) at q 256, and on lanes whose distances lie
   exactly at 1 and at its neighbouring floats (a square root that
   rounds to 1): every output bit for bit (``unif_valid``'s valid lanes,
   the likelihood's input and its clamp), the kernels' and the plain
   versions' time per call (events) and the bound (bytes, or the
   quadratic forms' or the distances' operations).  Then captured-unif
   (``captured_unif_phase``): uniform rounds whose waves are captured as
   one CUDA graph each and replayed against the same rounds launched
   eagerly, over the cube, over ellipsoids (a ``torch.multinomial``
   inside the graph) and over balls and cubes about 2048 centres,
   float64 and float32, widths 256 and 32, three
   rounds each on one round cache with a blob: every column, the blob and
   the generator's offset bit for bit, every wave but the warm-up a
   replay; the host time of one replayed wave with its wait and flag read
   against an eager wave's.  Then the doubling round
   (``doubling_kernels_phase``): ``doubling_point`` (the step's two end
   probes), ``doubling_expand`` (both modes, with the next doubling's or
   the first candidate's probe it writes), ``doubling_halve`` and
   ``doubling_shrink`` (with the next halving's or, resolving, the next
   candidate's probe they write) against
   their plain versions on hand-made states of 256 lanes (lanes that
   double, shrink and halve and lanes that do not, ``grow`` at its clamp,
   -inf and threshold values, a candidate on its interval's end) at 3 and
   15 dimensions, without and with a strict mask, float64 and float32:
   every entry of the state bit for bit, the kernels' and the plain
   versions' time per call (events) and the byte bound.  Then
   captured-doubling (``captured_doubling_phase``): doubling rounds whose
   five segments (the step's start, a doubling, a shrink candidate, a
   halving, a shrink's resolution) are captured as CUDA graphs sharing
   one generator and replayed, against the same rounds launched eagerly,
   rslice and slice, float64 and float32, widths 256 and 32, three rounds
   each with a blob and a strict mask: every column, the blob and the
   generator's offset bit for bit, every segment but one warm-up of each
   kind a replay; each segment's host time replayed (with its wait and
   flag read) against eager.  Then the round's assembly
   (``round_assemble_phase``): the two kernels of ``round_assemble``
   against ``round_assemble_plain`` on the same CUDA tensors at the
   consume scan's four shapes, a replay round and a round whose records
   come partly from its proposals, every output bit for bit, with their
   times and byte bound.  Then the ellipsoid refit of a chained unif
   round (``refit_phase``, phase 2i): ``refit_assign`` and ``refit_fit``
   (``csrc/ellipsoid_refit.cu``) against the plain version on the same
   CUDA tensors at the eggbox drive's stack (1000 points, 18 ellipsoids
   in 32 slots, d 2), the heavy drive's (3000, one ellipsoid, d 3), 3000
   points in 3 ellipsoids in 4 slots, a 15-D stack, 16384 points, and two
   stacks past ``refit_fit``'s shared-memory ceiling (16384 members of
   one slot, d 3; 2000 points in 2 ellipsoids in 4 slots, d 40: their
   members summed in stages), and
   on a slot of too few members, a covariance that
   overflows, padding slots with no member and no ``expand``, float64
   and float32: each point's slot equal wherever the plain version's two
   smallest forms differ by more than 1e-12 relative, the fit within
   1e-10 (float64) or 1e-4 (float32) of the plain fit of the same slots,
   relative to each slot's largest entry, equal ``mask`` and re-fitted
   slots, two launches and a captured replay the same bits; the kernels'
   layout (members staged at a time), the maximum relative error, the
   kernels' and the plain version's time per call and the bound.  Then
   the Beta prior (``beta_phase``, phase 2j): ``beta_ppf`` and
   ``betainc`` (``csrc/beta_prior.cu``) against their plain versions on
   the same CUDA tensors over 25 (a, b) pairs (0.5, 1, 2, 5, 30 each), u
   and x with 0, 1, 1e-12, 1 - 1e-12 and NaN, at (256,) and (2^20,),
   and ``beta_ppf`` also either side of its level switch (the most
   elements it walks a warp an element, ``beta_switch()``, and one
   more), float64 and float32, bit for bit; ``beta_ppf``'s mixed
   three-column table (``BETA_TABLE``) at 256 rows and either side of
   the switch, directly and under vmap, one launch a call; its time at
   every level count of the walk (1 to 5) from 256 to 32 times the
   switch's elements, each count's output bit for bit the others' (the
   data behind the level rule); the beta-prior drive's prior (three Betas) under ``torch.func.vmap`` on
   (256, 3), one launch a call (its three Betas in one table); the same
   and both kernels called directly, captured in one CUDA graph and
   replayed 20 times, the same bits each time; each kernel's time at
   Beta(2, 5) (events) at a wave's 256 lanes, ``beta_ppf`` at the
   grouped drive call's 768 elements, and at 2^20, the plain version's,
   the chain (the kernel on one element), the operations bound (the
   plain version's elementwise ops an element at the type's rate) and
   the byte bound.
3. Drive the main path: ``NestedSampler(nlive=2048, bound='balls',
   sample='rslice')`` on the card's default device, on the 3-D correlated
   Gaussian (rho = 0.95, prior box +-10, seed 56432), with every kernel's
   launch count zeroed just before and read just after; check the
   evidence against the analytic -8.987 and that the exact L2 path ran.
   On every drive from here, each fused round is assembled by
   ``round_assemble`` and, on the card, replays its prologue and
   epilogue but the first round of each shape; the round gate is read at
   most once a dispatch (the walk once a round).  3b. captured-round:
   the same drive to 3,000 iterations with the rounds' prologue and
   epilogue eager, then captured: results, the rounds' generator offsets
   and the counts equal; the replays' device and host times.
4. The same drive with ``bound='cubes'``: the exact L-inf path must run.
   4b. balls-unif and cubes-unif: ``nlive=2048, bound='balls'|'cubes',
   sample='unif'``, every other argument at its default (bootstrap 5:
   the radius from the host, no NN launch), through the evidence gate,
   every wave through ``unif_valid``'s friends mode (its launches the
   waves' ``sync_wave`` and the gated rounds' waves of no lane); the
   host refit's share of the wall.
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
   NN kernel may run; every walk round but the first of its shape is one
   graph replay.  Then one of its rounds timed alone: eager (every step
   launched from Python) and replayed, by events and by the host clock
   with its wait.
10. ``NestedSampler(nlive=2048, bound='balls', sample='slice')`` on the
    3-D Gaussian: the exact L2 path must run, and every refit must agree
    with the plain version.
11. The single/rslice nlive=500 drive with the sampler given as
    ``RSliceSampler(slice_doubling=True)``: the doubling barrier form,
    every segment replayed but one warm-up of each kind.  11b.
    doubling-balls: the same sampler at the main path's width
    (``nlive=2048, bound='balls'``, q 256), its refits through the exact
    L2 path; the evidence gate.
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
24. eggbox: the JAX package's eggbox baseline row
    (``examples/baseline_suite.py``): ``Eggbox()`` from
    ``dynesty_tpu_torch.models``, nlive 1000, multi / unif, width 256,
    dlogz 0.01.  Gate: the evidence within 5 logzerr; no kernel launch.
25. shells: the Gaussian-shells row, ``GaussianShells()``, the same
    sampler with dlogz 0.05, the same gate.
26. eggbox-balls: ``Eggbox()`` under ``bound='balls', sample='rslice',
    nlive=2048``: every refit launches the exact L2 path and is held
    against the plain version; the evidence within 5 logzerr.
27. priors: a ``PriorTransform`` of the six priors (``Beta(2, 5)`` among
    them) on 2^20 seeded uniforms on the card, against scipy's quantiles
    (1e-8 absolute); ``_betainc`` on the card against its CPU value and
    ``scipy.special.betainc`` (1e-10 absolute); ms per million points;
    the Beta kernels' launches.  27b. beta-prior: ``NestedSampler(
    beta_loglike, PriorTransform([Beta(2, 5), Beta(0.5, 0.5), Beta(5,
    2)]), 3, nlive=2048)``, every other argument at its default (multi /
    unif, bootstrap 5, q 256), the likelihood a product of Gaussians of
    width 0.02 about (0.25, 0.5, 0.75): the evidence within 4 logzerr of
    ``scipy.integrate.quad``'s, no capture warning, every wave but one
    warm-up a shape replayed, ``beta_ppf`` launched once a prior call on
    the card (its three Betas in one table; replays included), and a
    captured wave holding one ``beta_ppf`` node.
28. mesh-balls: phase 3's drive with ``mesh=make_mesh()`` (the one card):
    equal to phase 3's run bit for bit (niter, ncall, logl, logz,
    samples, scale) with the same launches, every lane of the last
    dispatch on the card, and a mesh of more devices than the machine
    has refused.
29. mesh-dynamic3: phase 13's drive with the mesh: equal to it bit for
    bit (records, batches, ncall), no kernel launched.
30. scaling: ``scaling_report(..., q=4096, sizes=(1,))`` for the 3-D
    Gaussian and the heavy likelihood: evaluations/s of the one card.
31. pipeline-resume: the default path (multi / unif / bootstrap 5, nlive
    500) stopped by ``maxiter`` right after a deferred refit moved the
    bound (the dispatch planned ahead of it holds the bound it was planned
    on), saved, restored onto the card and resumed: equal to the
    uninterrupted run bit for bit (records, ``scale``, ``ncall``,
    ``bound_iter``).  The eggbox under ``multi`` runs instead where the
    default path has no refit after its first planned dispatch.
32. example-quickstart: ``examples/torch_quickstart.py`` on the card, its
    static run within 4 and its dynamic run within 5 logzerr of the truth.
    Its likelihood keeps its constant on the card: no capture may warn,
    and every wave but one warm-up a shape replays.  32b. uncapturable: a
    likelihood that copies a host constant to the card at every call,
    which no CUDA graph may hold: each wave shape's capture must raise and
    be warned once, and every wave run eagerly through both wave kernels
    (the rounds' prologue and epilogue, which call no likelihood, still
    replay); then a doubling drive whose second segment capture raises:
    warned once, no replay after it, bit for bit an eager run.
33. queue-balls: the balls drive with ``proposal_mode='queue'`` (q =
    256): every consume launch on the general path at nlive 2048, the
    evidence gate; then the same drive with every round's consume sent
    through the plain loop, whose records and state must be bit for bit
    the kernel run's.  Queue mode bills the evaluations of the proposals
    consumed after the last accepted one to no record, in the JAX package
    too (``tests/test_torch_queue_billing.py``), so the difference is
    printed, not gated.
34. Device-only times (profiler kernel durations) of every comparison,
    of the consume rounds with their chain bound (the device time of a
    step of a one-thread chain of dependent logaddexps, times q), of the
    four proposal-step kernels at the main drives' shapes and of the
    launch floor, of one replay of the captured slice iteration at (256,
    3) and of the captured walk at (256, 15), of the two wave kernels at
    (256, 3) (``unif_valid`` also over unions of 1, 4 and 16
    ellipsoids and at phase 2f's friends cases), of one replayed uniform
    wave over the cube at (256, 3) and over balls and cubes about 2048
    centres (their graphs' nodes holding ``unif_valid``'s friends mode
    once and none of the eager union's matrix products, gathers or
    reductions: as many as the cube wave's but the ball draws' norm)
    and of one of the heavy drive's ellipsoid waves, of the four doubling
    kernels at (256, 3) (each in each of its modes) and of
    each replayed doubling segment, of the two refit kernels at phase
    2i's seven stacks (each beside its byte or operation bound and the
    launch floor) and of one replay of a heavy round's captured
    prologue, of one 256-lane evaluation of the heavy likelihood, of
    each Beta kernel at phase 2j's timed cases and its chain, of the
    vmapped (256, 3) three-Beta prior, and of a replay of the beta-prior
    drive's wave (its ``beta_ppf`` node apart).
    The cube wave's, one heavy ellipsoid wave's, that prologue's and
    every doubling segment's kernels are read from the captured graph's
    own nodes, as the CUDA runtime prints them: each wrapper's kernel is
    in as many nodes as the capture counted launches (what each replay
    adds to the drives' counts), ``doubling_point`` is in the start
    segment's nodes twice and in no other segment's, the halving's
    segment holds ``doubling_halve`` once, the candidate's draws
    nothing (no node of torch's uniform kernel), and the prologue holds
    each refit kernel once.  With ``--parent DIR``,
    ``bench_kernels.py`` on the checkout at DIR and on this one in turns.

Every drive over ellipsoids prints its refits and the dispatches planned
ahead of them (``n_prelaunch``, ``prelaunch``, ``n_refit``, ``refit``),
and every drive whose chained unif rounds re-fit an ellipsoid stack its
rounds and the refit kernels' launches: each round's prologue (eager,
captured or replayed) launches ``refit_assign`` and ``refit_fit`` once,
so each kernel's launches equal the drive's chained ellipsoid rounds
(gated ones included), or the drive fails; one JSON line lists them by
drive, and phase 34 reads both kernels once in the nodes of a captured
prologue of the heavy drive.
Every drive counts the Beta kernels' launches: none but the beta-prior
drive may launch them, and every captured graph of a proposal loop holds
``beta_ppf`` in as many nodes as its capture counted.
Every drive counts the proposal-step kernels' launches, the state
machine's iterations (its flag reads less one a round) and the walk's
steps (each eager step, and a replay's walks): ``slice_propose`` ==
``slice_advance`` == the state machine's iterations (a replay launches
each once), and ``rwalk_propose`` == ``rwalk_accept`` == the walk's steps
== walks x rwalk rounds, or the drive fails.  Every slice drive with its
likelihood on the card must replay every iteration but one warm-up per
captured graph (``n_slice_replay + n_slice_graph`` == the iterations)
with ``n_uncaptured`` 0; the rwalk drive must replay every round but the
warm-up round of each shape (``n_rwalk_replay + n_uncaptured`` == the
rounds, ``n_uncaptured`` == the shapes); host-balls must run every round
eagerly, none replayed.  One JSON line lists them by drive.  Every
uniform wave launches ``unif_valid`` and ``unif_place`` once and reads
one flag (``sync_wave``): their launches equal the waves on every drive,
and every wave but the warm-up wave of each shape is a replay
(``n_unif_replay``), but on host-pool and host-balls (host mode: every
wave eager) and the waves over custom-unif's box, drawn on the host; a
wave run eagerly counts ``n_uncaptured``.  One JSON line lists them by
drive.  Every segment of the doubling round launches its kernels once
(``doubling_point`` twice at a step's start and in no other segment:
the kernel before every other probe writes it) and
every flag read but the shrink loop's first (always true, read from no
device) follows one segment: on every drive ``doubling_expand +
doubling_halve + doubling_shrink`` == the segments == ``sync_slice`` less
one a slice step, and each kernel's launches equal its segments'; on the
two doubling drives every segment replays but one warm-up of each kind a
round shape.  One JSON line lists them by drive.
Every drive counts the consume kernel's launches, split into thin and
general on the device, from zero just before it to just after: they must
equal the fused rounds its samplers consumed (their ``n_round``), and be
at least one; one JSON line lists them by drive.

Each dynamic, blob, host, pool, custom, plot, model, prior, mesh,
scaling, pipeline-resume and example phase prints one JSON line of its
own.  The line before the last
is a JSON object of the kernels; the last line is ``{"ok": true,
"device": {...}}``.
"""

import argparse
import contextlib
import io
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dynesty_tpu_torch.bounding import Bound  # noqa: E402
from dynesty_tpu_torch.ops import consume as cs  # noqa: E402
try:
    from dynesty_tpu_torch.ops import ellipsoid_refit as rr  # noqa: E402
except ImportError:
    # a checkout before the refit kernels (bench_kernels.py --root reads
    # this file's inputs over it)
    rr = None
try:
    from dynesty_tpu_torch.ops import beta_prior as bp  # noqa: E402
except ImportError:
    # a checkout before the Beta prior's kernels (bench_kernels.py --root)
    bp = None
from dynesty_tpu_torch.ops import proposals as pr  # noqa: E402
from dynesty_tpu_torch.ops.geometry import unitcheck_batch  # noqa: E402

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
# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W; FP64 on
# the CUDA cores, outside the tensor cores)
TF32_FLOPS, FP32_FLOPS, HBM_BYTES = 495e12, 67e12, 3.35e12
FP64_FLOPS = 34e12
SOURCE = "dynesty_tpu_torch/csrc/pairwise_min_dist.cu"
CONSUME_SOURCE = "dynesty_tpu_torch/csrc/consume_scan.cu"
SLICE_SOURCE = "dynesty_tpu_torch/csrc/slice_step.cu"
RWALK_SOURCE = "dynesty_tpu_torch/csrc/rwalk_step.cu"
UNIF_SOURCE = "dynesty_tpu_torch/csrc/unif_wave.cu"
ASSEMBLE_SOURCE = "dynesty_tpu_torch/csrc/round_assemble.cu"
REFIT_SOURCE = "dynesty_tpu_torch/csrc/ellipsoid_refit.cu"
REFIT_REPLACES = "dynesty_tpu/internal/kernels.py:206"
# the refit's kernels, each launched once a chained ellipsoid round
REFIT_KERNELS = ("refit_assign", "refit_fit")
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


# profiler passes _device_ms tries before it falls back on CUDA events
PROFILE_PASSES = 8


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


def _device_ms(fn, iters=20, only=None):
    """Device time per call: the durations of the kernels that ``iters``
    calls ran, from the profiler (no host gaps), summed over a call; with
    ``only``, of the kernels whose name holds it.  The profiler on the
    card's machine now and then drops a pass's kernel events or adds a
    stray one from outside it, so each kernel name counts its mean
    duration times its launches a call (its events over ``iters``,
    rounded); a pass where a name rounds to none is run again, up to
    ``PROFILE_PASSES`` times, and then the time by CUDA events (host gaps
    included) is returned with a printed warning."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_PASSES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and (only is None or
                                                      only in e.name):
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        per_call = {k: round(len(v) / iters) for k, v in by_name.items()}
        if by_name and all(per_call.values()):
            return sum(sum(v) / len(v) * per_call[k]
                       for k, v in by_name.items()) / 1e3
    ms = _time_ms(fn, iters)
    what = f" of {only}" if only else ""
    print(f"warning: the profiler dropped kernel events in "
          f"{PROFILE_PASSES} passes{what}; CUDA events time used: "
          f"{ms:.5f} ms a call")
    return ms


def _graph_nodes(graph):
    """The nodes of a captured graph as the CUDA runtime prints them
    (``graph.debug_dump``; the capture kept them, ``keep_nodes``), one
    text a node: a kernel node's text names its kernel.  Read once: the
    dump frees the nodes (the replays go on)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        if not os.path.exists(path):
            raise RuntimeError("the CUDA runtime printed no captured graph")
        with open(path) as f:
            text = f.read()
    nodes = re.split(r'\n\s*(?="?\w*node\w*"?\s*\[)', text)[1:]
    if not nodes:
        raise RuntimeError(f"no node in the printed graph: {text[:2000]}")
    return nodes


# what the eager friends' union launched in a wave and the kernel does
# not: the candidate's and the distances' matrix products, the gather of
# the chosen centres, the distances' and the counts' reductions
EAGER_UNION_OPS = ("gemm", "index", "reduce_kernel")


def _kernel_names(nodes):
    """The kernel names of a printed graph's kernel nodes."""
    names = []
    for node in nodes:
        m = re.search(r"\w*[Kk]ernel\w*", node)
        if m:
            names.append(m.group(0)[:80])
    return names


def friends_wave_kernels(entry, kind, cube_nodes):
    """A captured friends wave's kernels, read from its graph's own nodes:
    the hand-written ones as its capture counted (``unif_valid`` once: its
    friends mode), and of ``EAGER_UNION_OPS`` as many as the cube wave's
    graph holds (the same likelihood, blob copy and placement), but the
    ball draws' one norm; the eager union added two matrix products, a
    gather and two reductions.  Raises where that differs."""
    nodes = _graph_nodes(entry.graph)
    kernels = check_replay_kernels(entry.counted, entry.graph,
                                   f"the captured {kind} wave", nodes)

    def ops(ns):
        return {k: sum(k in n.lower() for n in ns) for k in EAGER_UNION_OPS}

    got, cube = ops(nodes), ops(cube_nodes)
    want = dict(cube, reduce_kernel=cube["reduce_kernel"] +
                (kind == "balls"))
    rec = {"kernels": kernels, "ops": got, "cube_ops": cube,
           "nodes": len(nodes), "cube_nodes": len(cube_nodes),
           "names": _kernel_names(nodes)}
    if kernels.get("unif_valid") != 1 or got != want or not any(
            "unif_valid_kernel_friends" in n for n in nodes):
        raise RuntimeError(f"the captured {kind} wave holds the eager "
                           f"union's launches or misses the friends "
                           f"kernel: {rec}")
    return rec


def check_replay_kernels(counted, graph, what, nodes=None):
    """One replay's kernels, read from the captured ``graph``'s own
    nodes (or from ``nodes``, the ones :func:`_graph_nodes` read), against
    what its capture counted (``counted``: the wrappers' launches, which
    every replay adds to the drives' counts); raises where a wrapper's
    kernel is in another number of nodes.  Returns the hand-written
    kernels' nodes by name."""
    if nodes is None:
        nodes = _graph_nodes(graph)
    got = {}
    for w, n in counted[1]:
        k = sum(f"{w.__name__}_kernel" in node for node in nodes)
        got[w.__name__] = k
        if k != n:
            raise RuntimeError(f"{what} launches {w.__name__} {k} times a "
                               f"replay, its capture counted {n} (graph of "
                               f"{len(nodes)} nodes)")
    return got


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


# fused rounds consumed since the counts were last zeroed, tallied from
# every sampler's Timings (its 'n_round' count) by count_rounds()
_ROUNDS = [0]


def count_rounds():
    """Tally into ``_ROUNDS`` every fused round any sampler consumes.

    ``one_round`` counts ``n_round`` on the line before it calls the
    consume wrapper, so ``launches == rounds`` in :func:`_counts` catches
    one fault only: a fused round that consumes through the plain loop on
    the card (a wrapper that gave way to it, or a call of the plain loop
    swapped in), which launches nothing."""
    from dynesty_tpu_torch.utils.misc import Timings
    count = Timings.count

    def counting(self, key, n=1):
        if key == "n_round":
            _ROUNDS[0] += n
        elif key in CAPTURE_COUNTS or key == "sync_wave":
            _LOOPS[key] += n
        count(self, key, n)

    Timings.count = counting


# the captured proposal loops: the slice state machine's replayed
# iterations and graphs (one warm-up iteration each, eager), the random
# walk's replayed rounds and graphs (one warm-up round each, eager), the
# uniform waves replayed and captured (one warm-up wave each, eager), and
# rounds and waves that replayed nothing, tallied from every sampler's
# Timings by count_rounds(), with the uniform waves' flag reads
# (sync_wave)
CAPTURE_COUNTS = ("n_slice_replay", "n_slice_graph", "n_rwalk_replay",
                  "n_rwalk_graph", "n_unif_replay", "n_unif_graph",
                  "n_doubling_replay", "n_doubling_graph", "n_uncaptured",
                  "n_round_replay", "n_round_graph", "sync_round")
# rounds of the slice state machine and its iterations (its flag reads,
# less the one that ends each round), the random walk's rounds, its round
# shapes (buffers made), its steps (run eagerly one by one, or a replay's
# walks) and the walk steps due (walks x rounds); the uniform waves' shapes
# that may be captured (buffers made for a bound drawn on the card and a
# likelihood the capture rule allows), their waves (run eagerly, or
# replayed), the waves run eagerly and the warm-up waves among them; and
# the capture counts; the doubling round's rounds, slice steps, flag reads,
# round shapes that may be captured, segments by kind, segments run
# eagerly and the warm-ups among them; since the counts were last zeroed,
# tallied by count_proposal_loops() and count_rounds()
_LOOPS = dict.fromkeys(("slice_rounds", "slice_iters", "rwalk_rounds",
                        "rwalk_shapes", "rwalk_steps", "rwalk_due",
                        "unif_shapes", "unif_waves", "unif_eager",
                        "unif_warmups", "unif_gated", "sync_wave",
                        "doubling_rounds", "doubling_steps",
                        "doubling_reads", "doubling_shapes",
                        "doubling_gated", "seg_start", "seg_double",
                        "seg_candidate", "seg_halve", "seg_resolve",
                        "doubling_eager", "doubling_warmups",
                        "slice_gated", "round_shapes", "round_warm",
                        "refit_rounds") +
                       CAPTURE_COUNTS, 0)
# the fused rounds' graphs (their prologue and epilogue, one pair a round
# shape) made since the counts were last zeroed (count_proposal_loops)
_ROUND_GRAPHS = []
# the per-step kernels' launch counts in a drive's counts
STEP_KERNELS = ("slice_propose", "slice_advance", "rwalk_propose",
                "rwalk_accept")
# the uniform wave's kernels
UNIF_KERNELS = ("unif_valid", "unif_place")
# the uniform wave shapes made since the counts were last zeroed, newest
# last (count_proposal_loops)
_UNIF_GRAPHS = []


def count_proposal_loops():
    """Tally into ``_LOOPS`` every round of the stepping-out state machine
    and its iterations (its ``sync_slice`` flag reads less the one that
    ends the round: a replay reads the flag as an eager iteration does),
    and every round of the random walk with its steps: each step run
    eagerly (``RWalkGraph.step`` outside a capture, which records without
    running) and a replay's ``walks``, so ``launches == steps`` in
    :func:`_counts` catches a step that went through a plain version on
    the card or skipped its kernel; and the walk's round shapes (its
    ``RWalkGraph`` buffers made), each of which warms up once."""
    from dynesty_tpu_torch.internal import fused as tf
    from dynesty_tpu_torch.internal import kernels as tk
    machine, walk = tk.slice_loop, tk.rwalk_loop
    graph = tk.RWalkGraph
    init, step, replay = graph.__init__, graph.step, graph.replay

    def slice_loop(entry, draw, *, timings, **kw):
        # a round behind the fused round's gate reads once (sync_round)
        # and iterates no step
        n0 = timings.get("sync_slice", 0)
        gated = machine(entry, draw, timings=timings, **kw)
        if gated:
            _LOOPS["slice_gated"] += 1
        else:
            _LOOPS["slice_rounds"] += 1
            _LOOPS["slice_iters"] += timings["sync_slice"] - n0 - 1
        return gated

    def rwalk_loop(entry, draw, **kw):
        _LOOPS["rwalk_rounds"] += 1
        _LOOPS["rwalk_due"] += entry.walks
        return walk(entry, draw, **kw)

    def graph_init(self, *a, **kw):
        _LOOPS["rwalk_shapes"] += 1
        init(self, *a, **kw)

    def counted_step(self, draw, i):
        if not torch.cuda.is_current_stream_capturing():
            _LOOPS["rwalk_steps"] += 1
        return step(self, draw, i)

    def counted_replay(self, gen):
        _LOOPS["rwalk_steps"] += self.walks
        return replay(self, gen)

    tk.slice_loop, tk.rwalk_loop = slice_loop, rwalk_loop
    graph.__init__, graph.step, graph.replay = (graph_init, counted_step,
                                                counted_replay)

    # the fused rounds' graphs, one a round shape
    r_init = tf.RoundGraphs.__init__

    def round_init(self, *a, **kw):
        r_init(self, *a, **kw)
        _ROUND_GRAPHS.append(self)

    tf.RoundGraphs.__init__ = round_init

    # the uniform waves: every wave is one call of UnifGraph.wave outside a
    # capture (which records without running) or one replay; a warm-up
    # wave runs on the side stream
    ug = tk.UnifGraph
    u_init, u_wave, u_replay = ug.__init__, ug.wave, ug.replay
    u_side = ug.on_side_stream

    def unif_init(self, like, rb, kind):
        u_init(self, like, rb, kind)
        if self.capturable and kind != "custom":
            _LOOPS["unif_shapes"] += 1
        _UNIF_GRAPHS.append(self)

    def unif_wave(self, draw, check=False):
        if not torch.cuda.is_current_stream_capturing():
            _LOOPS["unif_waves"] += 1
            _LOOPS["unif_eager"] += 1
        return u_wave(self, draw, check)

    def unif_replay(self):
        _LOOPS["unif_waves"] += 1
        return u_replay(self)

    def unif_side(self, fn):
        _LOOPS["unif_warmups"] += 1
        return u_side(self, fn)

    ug.__init__, ug.wave, ug.replay = unif_init, unif_wave, unif_replay
    ug.on_side_stream = unif_side
    u_loop = tk.unif_loop

    def unif_loop(*a, **kw):
        # a round behind the fused round's gate runs one wave of no lane,
        # whose read counts as sync_round; over a user's bound the gate is
        # read before the first wave, and such a round runs none
        gated = u_loop(*a, **kw)
        _LOOPS["unif_gated"] += gated and kw.get("host_sampler") is None
        return gated

    tk.unif_loop = unif_loop

    # the doubling round: its rounds, slice steps and flag reads; every
    # segment is one call of DoublingGraph.run, run eagerly (a warm-up on
    # the side stream among them) or replayed
    d_loop, dg = tk.doubling_loop, tk.DoublingGraph
    d_init, d_run, d_replay = dg.__init__, dg.run, dg.replay
    d_side = dg.on_side_stream

    def doubling_loop(entry, draw, *, timings=None, **kw):
        # a round behind the fused round's gate runs its first start
        # segment (no lane probed) and reads once (sync_round)
        n0 = timings.get("sync_slice", 0) if timings is not None else 0
        gated = d_loop(entry, draw, timings=timings, **kw)
        if gated:
            _LOOPS["doubling_gated"] += 1
            _LOOPS["doubling_reads"] += 1
            return gated
        _LOOPS["doubling_rounds"] += 1
        _LOOPS["doubling_steps"] += entry.rb.n_steps
        if timings is not None:
            _LOOPS["doubling_reads"] += timings["sync_slice"] - n0
        return gated

    def doubling_init(self, like, rb):
        d_init(self, like, rb)
        if self.capturable:
            _LOOPS["doubling_shapes"] += 1

    def doubling_run(self, name, *a, **kw):
        _LOOPS["seg_" + name] += 1
        _LOOPS["doubling_eager"] += 1
        return d_run(self, name, *a, **kw)

    def doubling_replay(self, name, gen):
        _LOOPS["doubling_eager"] -= 1
        return d_replay(self, name, gen)

    def doubling_side(self, fn):
        _LOOPS["doubling_warmups"] += 1
        return d_side(self, fn)

    tk.doubling_loop = doubling_loop
    dg.__init__, dg.run, dg.replay = doubling_init, doubling_run, \
        doubling_replay
    dg.on_side_stream = doubling_side

    # the fused uniform rounds over an ellipsoid stack: each prepares once
    # on the host, and its prologue (eager or replayed) re-fits the stack
    from dynesty_tpu_torch.internal import samplers as ts
    up = ts._UnifProposer
    u_prepare = up.prepare

    def unif_prepare(self, live, axes_args):
        if self.refit:
            _LOOPS["refit_rounds"] += 1
        return u_prepare(self, live, axes_args)

    up.prepare = unif_prepare


def _zero_counts(hk):
    k = hk.pairwise_min_dist
    k.launches = k.launches_exact = k.launches_tc = 0
    cs.zero_counts()
    pr.zero_counts()
    rr.zero_counts()
    if bp is not None:
        bp.zero_counts()
    _ROUNDS[0] = 0
    for key in _LOOPS:
        _LOOPS[key] = 0
    _UNIF_GRAPHS.clear()
    _ROUND_GRAPHS.clear()


def _counts(hk, eager=False, custom=False, raised=False):
    """Every kernel's launches since :func:`_zero_counts`; raises unless
    every fused round consumed since went through the consume kernel,
    every step of the proposal loops through its two kernels, every
    uniform wave through its two kernels with one flag read, and every
    slice and walk round and uniform wave as the capture rule says (a
    likelihood on the card): the slice rounds replayed, every iteration
    but one warm-up per graph; the walk's rounds replayed, every one but
    the warm-up round of each shape, each shape's next round captured;
    every uniform wave replayed but the warm-up wave of each shape, and,
    with ``custom``, the waves over a user's bound, drawn on the host; or,
    where ``eager`` (host mode), all eager with none replayed; or, where
    ``raised`` (a likelihood whose capture raises), every wave eager after
    its shape's warm-up, none captured."""
    k = hk.pairwise_min_dist
    paths = cs.path_counts()
    out = {"launches": k.launches, "exact": k.launches_exact,
           "tc": k.launches_tc, "consume": cs.consume_round.launches,
           "consume_thin": paths["thin"],
           "consume_general": paths["general"], "rounds": _ROUNDS[0]}
    out.update({w.__name__: w.launches for w in pr.WRAPPERS})
    out["round_assemble"] = cs.round_assemble.launches
    out.update({w.__name__: w.launches for w in rr.WRAPPERS})
    if bp is not None:
        out.update({w.__name__: w.launches for w in bp.WRAPPERS})
    _LOOPS["round_shapes"] = len(_ROUND_GRAPHS)
    _LOOPS["round_warm"] = sum(g.warm for g in _ROUND_GRAPHS)
    out.update(_LOOPS)
    if out["consume"] != out["rounds"] or \
            paths["thin"] + paths["general"] != out["consume"]:
        raise RuntimeError(f"fused rounds and consume kernel launches "
                           f"differ: {out}")
    # the fused rounds: each assembled by the kernel; on the card every
    # round's prologue and epilogue replayed but the first round of each
    # shape (the capture's warm-up), whatever the likelihood
    if not (out["round_assemble"] == out["rounds"] and
            out["n_round_replay"] + out["round_warm"] == out["rounds"] and
            out["n_round_graph"] <= out["round_warm"] <=
            out["round_shapes"]):
        raise RuntimeError(f"the fused rounds did not run as the capture "
                           f"rule says: {out}")
    # every chained ellipsoid round re-fits its stack in its prologue,
    # each refit kernel once (a replay counting what its capture did)
    if not (out["refit_assign"] == out["refit_fit"] == out["refit_rounds"]):
        raise RuntimeError(f"refit kernel launches and the ellipsoid rounds "
                           f"differ: {out}")
    if not (out["slice_propose"] == out["slice_advance"] ==
            out["slice_iters"]) or not (
                out["rwalk_propose"] == out["rwalk_accept"] ==
                out["rwalk_steps"] == out["rwalk_due"]):
        raise RuntimeError(f"proposal-step kernel launches and the loops' "
                           f"iterations differ: {out}")
    if not (out["unif_valid"] == out["unif_place"] == out["unif_waves"] ==
            out["sync_wave"] + out["unif_gated"]):
        raise RuntimeError(f"uniform wave kernel launches and the waves "
                           f"differ: {out}")
    # eager waves beside the warm-ups: host mode, or a user's bound
    by_rule = out["unif_eager"] - out["unif_warmups"]
    if eager:
        ok = out["n_unif_replay"] == out["n_unif_graph"] == \
            out["unif_warmups"] == 0 and by_rule == out["unif_waves"]
    elif raised:
        ok = out["n_unif_replay"] == out["n_unif_graph"] == 0 and \
            out["unif_warmups"] == out["unif_shapes"] and \
            out["unif_eager"] == out["unif_waves"]
    else:
        ok = out["unif_warmups"] == out["unif_shapes"] >= \
            out["n_unif_graph"] and (custom or by_rule == 0) and \
            out["n_unif_replay"] + out["unif_eager"] == out["unif_waves"]
    if not ok:
        mode = "eager" if eager else "captured"
        raise RuntimeError(f"the uniform waves did not run as the capture "
                           f"rule says ({mode}): {out}")
    # the doubling round: each segment launches its kernels once (a
    # replay counting its segment's launches; doubling_point twice at a
    # step's start and nowhere else), every slice step starts with one
    # start segment, and each flag read but the shrink loop's first
    # (always true, read from no device) follows one segment
    segs = sum(out["seg_" + n] for n in DOUBLING_SEGMENTS)
    if not (out["doubling_expand"] + out["doubling_halve"] +
            out["doubling_shrink"] == segs and
            out["doubling_point"] == 2 * out["seg_start"] and
            out["doubling_expand"] == out["seg_start"] + out["seg_double"] and
            out["doubling_halve"] == out["seg_halve"] and
            out["doubling_shrink"] == out["seg_candidate"] +
            out["seg_resolve"] and
            out["seg_start"] == out["doubling_steps"] +
            out["doubling_gated"] and
            out["doubling_reads"] == segs + out["doubling_steps"]):
        raise RuntimeError(f"doubling kernel launches and the round's "
                           f"segments and reads differ: {out}")
    if out["doubling_rounds"]:
        if eager:
            ok = out["n_doubling_replay"] == out["n_doubling_graph"] == \
                out["doubling_warmups"] == 0 and \
                out["doubling_eager"] == segs
        else:
            # every segment replayed but one warm-up of each kind a shape
            ok = out["n_doubling_replay"] > 0 and \
                out["doubling_eager"] == out["doubling_warmups"] <= \
                len(DOUBLING_SEGMENTS) * out["doubling_shapes"] and \
                out["n_doubling_graph"] <= out["doubling_warmups"] and \
                out["n_doubling_replay"] + out["doubling_eager"] == segs
        if not ok:
            mode = "eager" if eager else "captured"
            raise RuntimeError(f"the doubling rounds did not run as the "
                               f"capture rule says ({mode}): {out}")
    # the slice and walk rounds that replayed nothing
    rest = out["n_uncaptured"] - out["unif_eager"] - out["doubling_eager"]
    if out["slice_rounds"]:
        if eager:
            ok = out["n_slice_replay"] == out["n_slice_graph"] == 0 and \
                rest == out["slice_rounds"]
        else:
            ok = rest == 0 and out["n_slice_replay"] > 0 and \
                out["n_slice_replay"] + out["n_slice_graph"] == \
                out["slice_iters"]
        if not ok:
            mode = "eager" if eager else "captured"
            raise RuntimeError(f"the slice rounds did not run as the "
                               f"capture rule says ({mode}): {out}")
    if out["rwalk_rounds"]:
        if eager:
            ok = out["n_rwalk_replay"] == out["n_rwalk_graph"] == 0 and \
                rest == out["rwalk_rounds"]
        else:
            ok = out["n_rwalk_replay"] > 0 and \
                out["n_rwalk_replay"] + rest == out["rwalk_rounds"] and \
                rest == out["rwalk_shapes"] >= out["n_rwalk_graph"] >= 1
        if not ok:
            mode = "eager" if eager else "captured"
            raise RuntimeError(f"the walk's rounds did not run as the "
                               f"capture rule says ({mode}): {out}")
    return out


# the 3-D correlated Gaussian at module level, so that a sampler over it
# pickles; its precision matrix goes to the card once CUDA is known to exist
_GAUSS = {}


def _gauss_setup():
    cov = np.identity(NDIM)
    cov[cov == 0] = 0.95
    _GAUSS["cinv"] = torch.as_tensor(np.linalg.inv(cov), device="cuda")
    _GAUSS["cinv_host"] = _GAUSS["cinv"].cpu()
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
          loglike=None, ptform=None, gate=None, **kw):
    """One run on the 3-D Gaussian on the card's default device, through
    the evidence gate (``gate``, by default :func:`_gate`); with
    ``maxiter`` the run is stopped there without its live points and
    returned ungated.  ``loglike``/``ptform`` replace the Gaussian's (a
    blob or host-mode form of it), ``kw`` goes to the sampler.  Returns
    (summary, sampler)."""
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
    (gate or _gate)(sampler, summary, f"drive {_bound_name(bound)}/"
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
    """Per-call times of the parts of one round of the rwalk drive at its
    widths (256 lanes, 35 steps, 15-D, nlive 1000): the random-walk round
    alone, eager (a likelihood the capture rule keeps out, so every step
    is launched from Python) and replayed (one CUDA graph replay of the
    whole walk, after its warm-up round and its capture), each by CUDA
    events back to back and by the host clock with its wait; one batched
    likelihood call; and one propose-free consume round on the thin path.
    Returns the times and the replayed round's graph entry."""
    from dynesty_tpu_torch.internal.fused import make_fused_round
    from dynesty_tpu_torch.internal.kernels import make_rwalk_round
    from dynesty_tpu_torch.internal.samplers import _ReplayProposer
    from dynesty_tpu_torch.internal.likelihood import LogLikelihood

    q, il, kw = 256, 2 * R_NDIM, dict(dtype=torch.float64, device="cuda")
    like = LogLikelihood(normal_loglike, box_ptform, R_NDIM, device="cuda")
    eager = LogLikelihood(normal_loglike, box_ptform, R_NDIM, device="cuda")
    eager.capturable = lambda: False
    rng = np.random.Generator(np.random.PCG64(SEED))
    u = 0.5 + 0.02 * rng.standard_normal((R_NLIVE, R_NDIM))
    v, logl, _ = like.eval_host(u)
    eager.eval_host(u[:2])
    cache = {}
    walks = {name: make_rwalk_round(lk, ndim=R_NDIM, ncdim=R_NDIM, q=q,
                                    walks=R_NDIM + 20, rounds={} if
                                    name == "eager" else cache, **kw)
             for name, lk in (("eager", eager), ("replay", like))}
    axes = np.tile(0.01 * np.eye(R_NDIM).ravel(), (q, 1))
    packed_in = torch.as_tensor(np.concatenate(
        [u[:q], v[:q], logl[:q, None], axes], axis=1), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    u_dev = packed_in[:, :R_NDIM].contiguous()
    # a fixed block of proposals above every live point: the thin path
    prop = torch.cat([packed_in[:, :il], packed_in[:, il:il + 1] + 100.0,
                      torch.full((q, 3), 35.0, **kw)], dim=1)

    consume, _ = make_fused_round(_ReplayProposer(kw["dtype"], "cuda", il),
                                  nlive=R_NLIVE, ndim=R_NDIM, npdim=R_NDIM,
                                  q=q, capture=False, **kw)
    live = torch.as_tensor(np.concatenate(
        [u, v, logl[:, None], np.zeros((R_NLIVE, 2)),
         np.full((R_NLIVE, 1), -1e30)], axis=1), device="cuda")
    ctrl = np.array([-1e30, 0.0, 0.0, 0.0, -1e30, 0.0, 0.0, 0.0, 1.0, -np.inf,
                     np.inf, 2.0 ** 30, 2.0 ** 30, 1.0, 0.0, 1.0, -1e30, 0.0,
                     0.0, 0.0, 0.0, 2.0 ** 30])

    def host_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    out = {}
    for name, walk in walks.items():
        call = (lambda w: lambda: w(gen, packed_in, None, 1.0, -1e30))(walk)
        # _time_ms warms up with three rounds: the replayed form's warm-up
        # round and its capture come first
        out[f"{name}_round_ms"] = _time_ms(call, 5)
        out[f"{name}_round_host_ms"] = host_ms(call)
    entry = next(iter(cache.values()))
    if entry.graph is None:
        raise RuntimeError("the timed rwalk round was never captured")
    out["rwalk_round_ms"] = out.pop("eager_round_ms")
    out["replay_events_ms"] = _time_ms(lambda: entry.replay(gen), 20)
    out["likelihood_call_ms"] = _time_ms(lambda: like.batch_eval(u_dev), 50)
    out["consume_round_ms"] = _time_ms(
        lambda: consume(SEED, live, None, {"prop": prop}, ctrl), 5)
    return out, entry


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


def _queue_gate(sampler, s, what):
    """The queue drive's gate: |logz - truth| < 4 logzerr, every record's
    weight finite, one sample a record and live point.  A queue-mode run
    bills the evaluations of the proposals consumed after its last
    accepted one to no record, so its ``ncall`` column sums to less than
    the sampler's ``ncall``: the difference is recorded, not gated."""
    res = sampler.results
    s["ncall_unrecorded"] = int(sampler.ncall) - int(np.sum(res.ncall))
    ok = (np.isfinite(s["logz"]) and s["logzerr"] > 0 and
          abs(s["logz"] - s["truth"]) < 4 * s["logzerr"] and
          res.samples.shape == (res.niter + sampler.nlive, sampler.ndim) and
          np.all(np.isfinite(res.logwt)) and s["ncall_unrecorded"] >= 0)
    if not ok:
        raise RuntimeError(f"{what} failed the evidence gate: {s}")


def queue_balls_drive(dyt, hk):
    """The balls drive in queue mode (``proposal_mode='queue'``, q = 256):
    every consume launch takes the general path.  Then the same drive
    with every round's consume sent through the plain loop (the harness's
    monkeypatch, as :func:`run_fixed_round` with ``plain`` does), whose
    records and state must be the kernel run's bit for bit."""
    import dynesty_tpu_torch.internal.fused as fused_mod

    kernel = fused_mod.consume_round
    shapes = set()

    def spy(st, live_logl, qlogl, *a, **kw):
        shapes.add((live_logl.shape[0], qlogl.shape[0]))
        return kernel(st, live_logl, qlogl, *a, **kw)

    _zero_counts(hk)
    fused_mod.consume_round = spy
    try:
        with recording_refits(dyt, hk) as calls:
            s, sampler = drive(dyt, 2048, "balls", proposal_mode="queue",
                               gate=_queue_gate)
    finally:
        fused_mod.consume_round = kernel
    s["launches"] = c = _counts(hk)
    s["refit_max_abs_err"] = check_refits(hk, calls, "queue-balls drive")
    s["consume_shapes"] = sorted(shapes)
    if sampler.queue_size != 256 or c["consume"] < 1 or \
            c["consume_general"] != c["consume"] or c["exact"] < 1 or \
            any(n != 2048 for n, _ in shapes):
        raise RuntimeError(f"the queue-balls drive did not consume every "
                           f"round on the general path at nlive 2048: "
                           f"{s['launches']}, shapes {s['consume_shapes']}")
    launches = cs.consume_round.launches
    fused_mod.consume_round = cs.consume_round_plain
    # the plain loop reads the device: its rounds stay eager
    import dynesty_tpu_torch.internal.samplers as ts
    capture_rule = ts._capture_rounds
    ts._capture_rounds = lambda ns: False
    try:
        plain, psampler = drive(dyt, 2048, "balls", proposal_mode="queue",
                                gate=_queue_gate)
    finally:
        fused_mod.consume_round = kernel
        ts._capture_rounds = capture_rule
    if cs.consume_round.launches != launches:
        raise RuntimeError("the plain replay launched the consume kernel")
    a, b = sampler.results, psampler.results
    same = {k: bool(_same_bits(np.asarray(a[k], dtype=np.float64),
                               np.asarray(b[k], dtype=np.float64)).all())
            for k in ("logl", "logvol", "logwt", "logz", "logzerr",
                      "information", "samples", "samples_u", "samples_it",
                      "samples_id", "samples_n", "ncall", "scale")}
    same["niter"] = a.niter == b.niter
    same["ncall_total"] = sampler.ncall == psampler.ncall
    same["n_round"] = sampler.timings["n_round"] == \
        psampler.timings["n_round"]
    same["ncall_unrecorded"] = s["ncall_unrecorded"] == \
        plain["ncall_unrecorded"]
    s["plain_replay"] = {"wall_s": plain["wall_s"], "same": same,
                         "n_round": psampler.timings["n_round"]}
    if not all(same.values()):
        raise RuntimeError(f"the queue-balls drive through the plain loop "
                           f"differs from the kernel's: {same}")
    return s


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
    # host mode maps the user's function on the host: every round eager
    s["launches"] = _counts(hk, eager=True)
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
    # the box's waves are drawn on the host: eager, the unit cube's replayed
    s["launches"] = _counts(hk, custom=True)
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


# the JAX package's baseline rows (examples/baseline_suite.py): a problem
# from dynesty_tpu_torch.models, nlive 1000, multi / unif, width 256, at
# the row's dlogz, gated at 5 logzerr
MODEL_ROWS = (("eggbox", "Eggbox", 0.01), ("shells", "GaussianShells", 0.05))
# the priors phase: one prior of each kind, on this many seeded uniforms
PRIOR_POINTS = 2 ** 20
BETAINC_AB = (0.5, 1.0, 2.0, 5.0, 30.0)


def model_drive(dyt, models, hk, cls_name, dlogz):
    """One baseline row on the card's default device: its evidence within
    5 logzerr of the truth, no NN-kernel launch."""
    prob = getattr(models, cls_name)()
    _zero_counts(hk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = dyt.NestedSampler(
        prob.loglike, prob.ptform, prob.ndim, nlive=1000, bound="multi",
        sample="unif", queue_size=256,
        rstate=np.random.Generator(np.random.PCG64(SEED)))
    if sampler.device.type != "cuda":
        raise RuntimeError(f"the default device is {sampler.device}")
    sampler.run_nested(print_progress=False, dlogz=dlogz)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = _summary(sampler, wall, prob.logz_truth, dlogz=dlogz,
                 problem=cls_name)
    s["launches"] = _counts(hk)
    s["pull"] = (s["logz"] - s["truth"]) / s["logzerr"]
    res = sampler.results
    if not (np.isfinite(s["logz"]) and s["logzerr"] > 0 and
            abs(s["pull"]) < 5 and np.all(np.isfinite(res.logwt)) and
            int(np.sum(res.ncall)) == sampler.ncall and
            s["launches"]["launches"] == 0):
        raise RuntimeError(f"the {cls_name} row failed its gate: {s}")
    return s


def eggbox_balls_drive(dyt, models, hk):
    """The eggbox under RadFriends and rslice at nlive 2048: each refit
    launches the exact L2 path and is held against the plain version;
    the evidence within 5 logzerr (the eggbox rows' gate)."""
    prob = models.Eggbox()
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler = dyt.NestedSampler(
            prob.loglike, prob.ptform, prob.ndim, nlive=2048, bound="balls",
            sample="rslice",
            rstate=np.random.Generator(np.random.PCG64(SEED)))
        sampler.run_nested(print_progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    s = _summary(sampler, wall, prob.logz_truth, problem="Eggbox")
    s["launches"] = _counts(hk)
    s["refit_max_abs_err"] = check_refits(hk, calls, "eggbox-balls drive")
    s["pull"] = (s["logz"] - s["truth"]) / s["logzerr"]
    if not (np.isfinite(s["logz"]) and abs(s["pull"]) < 5 and
            s["launches"]["exact"] >= 1 and
            s["launches"]["exact"] == len(calls)):
        raise RuntimeError(f"the eggbox-balls drive failed its gate: {s}")
    return s


def _prior_transform(models):
    """One prior of each kind, and the same quantiles from scipy."""
    import scipy.stats as st

    pt = models.PriorTransform([
        models.TopHat(-5.0, 5.0), models.Normal(1.0, 2.0),
        models.ClippedNormal(0.0, 1.0, -1.0, 2.0),
        models.LogNormal(0.0, 0.5), models.LogUniform(1e-3, 1e3),
        models.Beta(2.0, 5.0)])

    def ppf(u):
        return np.stack([
            -5.0 + 10.0 * u[:, 0], st.norm.ppf(u[:, 1], 1.0, 2.0),
            st.truncnorm.ppf(u[:, 2], -1.0, 2.0),
            st.lognorm.ppf(u[:, 3], 0.5, scale=1.0),
            st.loguniform.ppf(u[:, 4], 1e-3, 1e3),
            st.beta.ppf(u[:, 5], 2.0, 5.0)], axis=1)

    return pt, ppf


def priors_phase(models):
    """The six priors on the card against scipy's quantiles (1e-8
    absolute), and ``_betainc`` on the card against its CPU value and
    ``scipy.special.betainc`` (1e-10 absolute); the transform's time per
    million points (CUDA events, one call after a warm-up)."""
    import scipy.special as sp
    from dynesty_tpu_torch.models.priors import _betainc

    pt, ppf = _prior_transform(models)
    u = np.random.Generator(np.random.PCG64(SEED)).random((PRIOR_POINTS, 6))
    u_dev = torch.as_tensor(u, device="cuda")
    batched = torch.func.vmap(pt)
    batched(u_dev[:1024])  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    got = batched(u_dev)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    err = np.abs(got.cpu().numpy() - ppf(u)).max(axis=0)
    x = np.concatenate([[1e-12, 1e-6, 1e-3], np.linspace(0.01, 0.99, 99),
                        [1 - 1e-3, 1 - 1e-6, 1 - 1e-12]])
    x_cpu = torch.as_tensor(x)
    bi_cpu = bi_scipy = 0.0
    for a in BETAINC_AB:
        for b in BETAINC_AB:
            card = _betainc(a, b, x_cpu.to("cuda")).cpu().numpy()
            bi_cpu = max(bi_cpu, float(np.abs(
                card - _betainc(a, b, x_cpu).numpy()).max()))
            bi_scipy = max(bi_scipy, float(np.abs(
                card - sp.betainc(a, b, x)).max()))
    out = {"points": PRIOR_POINTS, "ms": ms,
           "ms_per_million": ms / (PRIOR_POINTS / 1e6),
           "max_abs_err_by_prior": dict(zip(
               ("TopHat", "Normal", "ClippedNormal", "LogNormal",
                "LogUniform", "Beta"), err.tolist())),
           "betainc_max_abs_err_cpu": bi_cpu,
           "betainc_max_abs_err_scipy": bi_scipy}
    if not (np.all(err < 1e-8) and bi_cpu < 1e-10 and bi_scipy < 1e-10):
        raise RuntimeError(f"the priors disagree: {out}")
    return out


def _mesh_checks(dyt, sampler, mesh):
    """The lanes of the last dispatch all on the card, and a mesh larger
    than the machine refused."""
    sh = sampler.last_proposals_sharding
    q = sampler.queue_size
    lanes = set(sh.device_of_lane((q, 11)))
    n = torch.cuda.device_count()
    try:
        dyt.parallel.make_mesh(n + 1)
        refused = False
    except ValueError:
        refused = True
    out = {"mesh": [str(d) for d in mesh.devices],
           "shard_shape": list(sh.shard_shape((q, 11))),
           "lane_devices": sorted(str(d) for d in lanes),
           "larger_mesh_refused": refused}
    if out["shard_shape"] != [q, 11] or lanes != {mesh.devices[0]} or \
            not refused:
        raise RuntimeError(f"the mesh's lanes are not all on the card: "
                           f"{out}")
    return out


def mesh_balls_drive(dyt, hk, main, full):
    """The balls drive with ``mesh=make_mesh()`` (the one card): equal to
    phase 3's run bit for bit, with the same kernel launches."""
    mesh = dyt.parallel.make_mesh()
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        s, sampler = drive(dyt, 2048, "balls", mesh=mesh)
    s["launches"] = _counts(hk)
    s["refit_max_abs_err"] = check_refits(hk, calls, "mesh-balls drive")
    a, b = full.results, sampler.results
    same = {k: bool(np.array_equal(np.asarray(a[k]), np.asarray(b[k])))
            for k in ("logl", "logz", "samples", "ncall", "scale")}
    same["niter"] = a.niter == b.niter
    same["ncall_total"] = full.ncall == sampler.ncall
    same["launches"] = s["launches"] == main["launches"]
    s["same"] = same
    s.update(_mesh_checks(dyt, sampler, mesh))
    if not all(same.values()):
        raise RuntimeError(f"the mesh-balls drive differs from the balls "
                           f"drive: {same} {s['launches']} "
                           f"{main['launches']}")
    return s


def mesh_dynamic3_drive(dyt, hk, dyn3, dyn3_results):
    """dynamic3 with ``mesh=make_mesh()``: equal to phase 13's run bit
    for bit (records and batches), no kernel launched."""
    mesh = dyt.parallel.make_mesh()
    _zero_counts(hk)
    s, dns = dynamic_drive(dyt, {}, bound="multi", sample="unif",
                           queue_size=256, mesh=mesh)
    s["config"]["mesh"] = [str(d) for d in mesh.devices]
    s["launches"] = _counts(hk)
    _dyn_gate(dns, s, "mesh-dynamic3 drive", neff=DYN_NEFF)
    a, b = dyn3_results, dns.results
    same = {k: bool(np.array_equal(np.asarray(a[k]), np.asarray(b[k])))
            for k in ("logl", "logz", "logzerr", "samples", "samples_batch",
                      "samples_n", "ncall", "batch_nlive",
                      "batch_logl_bounds", "scale")}
    same["niter"] = a.niter == b.niter
    same["ncall_total"] = dyn3["ncall"] == s["ncall"]
    same["batches"] = dyn3["batches"] == s["batches"]
    same["launches"] = s["launches"] == dyn3["launches"]
    s["same"] = same
    s["batch_mesh"] = dns.sampler.mesh is mesh
    s.update(_mesh_checks(dyt, dns.sampler, mesh))
    if not all(same.values()) or not s["batch_mesh"]:
        raise RuntimeError(f"the mesh-dynamic3 drive differs from "
                           f"dynamic3: {same}")
    return s


def scaling_phase(dyt, heavy_like):
    """``scaling_report`` on the one card (``sizes=(1,)``) for the 3-D
    Gaussian and the heavy likelihood at q = 4096: evaluations/s of one
    device, no scaling."""
    out = {}
    for name, fn in (("gauss3", gauss_loglike), ("heavy", heavy_like)):
        rep = dyt.parallel.scaling_report(
            fn, NDIM, q=4096, sizes=(1,),
            rstate=np.random.Generator(np.random.PCG64(SEED)))[0]
        if not (rep["partitioned"] and rep["platform"] == "gpu" and
                np.isfinite(rep["evals_per_s"]) and rep["evals_per_s"] > 0):
            raise RuntimeError(f"scaling_report on {name}: {rep}")
        out[name] = rep
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
            "pull", "batches", "n_effective", "mesh", "batch_mesh",
            "shard_shape", "lane_devices", "larger_mesh_refused", "timings")
    print(json.dumps(dict({"phase": name, "card": card},
                          **{k: s[k] for k in keys if k in s})))
    _print_refits(s)


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


@contextlib.contextmanager
def recording_plans():
    """Record each dispatch the port plans ahead of its refit: the records
    so far, and whether the refit that followed moved the bound (the spec
    then keeps a copy of the bound it was planned on)."""
    from dynesty_tpu_torch.sampler import Sampler
    plan = Sampler._plan_ahead
    plans = []

    def spy(s, *a):
        plan(s, *a)
        plans.append((s.it - 1, "bound_used" in s._next_spec))
    Sampler._plan_ahead = spy
    try:
        yield plans
    finally:
        Sampler._plan_ahead = plan


PIPE_KEYS = ("logl", "logvol", "logwt", "logz", "samples", "samples_u",
             "samples_it", "samples_id", "samples_n", "samples_birth",
             "ncall", "bound_iter", "samples_bound", "scale")


def pipeline_resume_drive(dyt):
    """The default path (``NestedSampler(loglike, ptform, 3)``: multi /
    unif / bootstrap 5) stopped by ``maxiter`` right after a deferred refit
    moved the bound, its planned spec holding the bound it was planned on;
    saved, restored onto the card, resumed: equal to the uninterrupted run
    bit for bit, or raises.  Where the default path has no such refit
    after its first planned dispatch, the eggbox under ``multi`` runs."""
    from dynesty_tpu_torch.models import Eggbox

    egg = Eggbox()
    problems = {"default": (gauss_loglike, box_ptform, NDIM, {}),
                "eggbox": (egg.loglike, egg.ptform, egg.ndim,
                           {"bound": "multi"})}

    def make(name):
        loglike, ptform, ndim, kw = problems[name]
        return dyt.NestedSampler(
            loglike, ptform, ndim,
            rstate=np.random.Generator(np.random.PCG64(SEED)), **kw)

    for name in problems:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_plans() as plans:
            full = make(name)
            full.run_nested(print_progress=False)
        torch.cuda.synchronize()
        wall_full = time.perf_counter() - t0
        moved = [it for it, snap in plans if snap]
        if len(moved) >= 2:
            break
    else:
        raise RuntimeError("no refit moved the bound after the first "
                           "planned dispatch")
    maxiter = moved[1]
    # the dlogz of the uninterrupted run's default (with add_live)
    dlogz = 1e-3 * (full.nlive - 1) + 0.01
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = make(name)
    s.run_nested(print_progress=False, maxiter=maxiter, add_live=False,
                 dlogz=dlogz)
    wall_first = time.perf_counter() - t0
    spec = pickle.loads(pickle.dumps(s._next_spec))
    stop = {"at_boundary": s.it - 1 == maxiter and s._leftover is None and
            s._continuation is None,
            "spec_keeps_bound": type(spec.get("bound_used")) is
            type(s.bound) and spec["bound_version_used"] < s.bound_version
            and spec["bounditer"] == s.nbound - 2}
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "pipeline.pkl")
        s.save(fname)
        size = os.path.getsize(fname)
        del s
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
            for k in PIPE_KEYS}
    same["niter"] = a.niter == b.niter
    same["ncall_total"] = full.ncall == restored.ncall
    t = full.timings
    out = {"problem": name, "config": {
               "bound": full.bounding, "sample": full.internal_sampler.name,
               "nlive": full.nlive, "bootstrap": full.bound_bootstrap,
               "queue_size": full.queue_size, "seed": SEED},
           "maxiter": maxiter, "boundaries_moved": moved,
           "niter": int(b.niter), "ncall": int(restored.ncall),
           "logz": float(b.logz[-1]), "logzerr": float(b.logzerr[-1]),
           "n_prelaunch": t.get("n_prelaunch", 0),
           "prelaunch_s": t.get("prelaunch", 0.0),
           "n_refit": t.get("n_refit", 0), "refit_s": t.get("refit", 0.0),
           "wall_full_s": wall_full, "wall_first_s": wall_first,
           "wall_resumed_s": wall, "checkpoint_bytes": size, "stop": stop,
           "same": same}
    if not all(same.values()) or not all(stop.values()):
        raise RuntimeError(f"the pipeline-resume drive differs from the "
                           f"uninterrupted run: {out}")
    return out


def example_quickstart_phase():
    """``examples/torch_quickstart.py`` on the card, through its own
    ``main``: the static run within 4 and the dynamic run within 5 of their
    errors of the truth, and no capture warned (its likelihood keeps its
    constant on the card, so its waves replay; the caller holds the
    counts to that).  Its progress bars go to a buffer."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch_quickstart.py")
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stderr(io.StringIO()), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sampler, dns = mod.main(["--outdir", tmp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    captures = [str(w.message) for w in caught
                if "could not be captured" in str(w.message)]
    res, dres = sampler.results, dns.results
    pulls = [float((r.logz[-1] - mod.logz_truth) / r.logzerr[-1])
             for r in (res, dres)]
    out = {"wall_s": wall, "devices": [str(sampler.device),
                                       str(dns.device)],
           "niter": int(res.niter), "ncall": int(sampler.ncall),
           "pull": pulls[0], "dynamic_niter": int(dres.niter),
           "dynamic_ncall": int(dns.ncall), "dynamic_pull": pulls[1],
           "batches": int(dns.batch),
           "n_prelaunch": sampler.timings.get("n_prelaunch", 0),
           "capture_warnings": len(captures),
           "n_unif_replay": sampler.timings.get("n_unif_replay", 0) +
           dns.timings.get("n_unif_replay", 0)}
    if out["devices"] != ["cuda", "cuda"] or abs(pulls[0]) >= 4 or \
            abs(pulls[1]) >= 5 or captures or out["n_unif_replay"] < 1:
        raise RuntimeError(f"the quickstart example failed: {out}")
    return out


def _print_dynamic(name, s, card):
    """One JSON line of a dynamic drive, the card beside it."""
    keys = ("niter", "ncall", "batches", "batch_nlive", "logz", "logzerr",
            "truth", "n_effective", "wall_s", "per_record_host_us",
            "nc_waste", "launches", "launches_from", "refit_max_abs_err",
            "timings")
    print(json.dumps(dict({"phase": name, "card": card},
                          **{k: s[k] for k in keys if k in s})))
    _print_refits(s)


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


def unif_drive(dyt, loglike, truth, profile=None, keep=None, **kw):
    """One ``NestedSampler(loglike, ptform, 3, **kw)`` run on the card's
    default device through the evidence gate (under ``profile`` if
    given); returns its summary.  The sampler is appended to ``keep``
    where given: a graph of its waves that a later phase replays reads
    the sampler's arrays, which must outlive it."""
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
    if keep is not None:
        keep.append(sampler)
    return summary


def friends_drive(dyt, hk, bound, card):
    """``NestedSampler(nlive=2048, bound=bound, sample='unif')`` on the 3-D
    Gaussian, every other argument at its default (bootstrap 5, enlarge
    1, q 256), launch counts from zero: through the evidence gate, no
    NN-kernel launch (the bootstrap radius comes from the host), every
    wave through ``unif_valid`` (its launches the waves read, ``sync_wave``,
    and the gated rounds' waves of no lane), every friends wave shape
    about the 2048 live points.
    Returns its summary with the launches, the host refit's share of the
    wall and ``dispatch``'s."""
    _zero_counts(hk)
    s = unif_drive(dyt, gauss_loglike, LOGZ_TRUTH, nlive=FRIENDS_NLIVE,
                   bound=bound, sample="unif")
    n = s["launches"] = _counts(hk)
    t = s["timings"]
    shapes = [g for g in _UNIF_GRAPHS if g.kind == bound]
    s["friends_shapes"] = len(shapes)
    s["refit_share"] = t.get("refit", 0.0) / s["wall_s"]
    s["dispatch_share"] = t.get("dispatch", 0.0) / s["wall_s"]
    if (s["config"]["bootstrap"], s["config"]["sample"]) != (5, "unif") or \
            n["launches"] != 0 or \
            n["unif_valid"] != n["sync_wave"] + n["unif_gated"] or \
            not shapes or \
            any(g.rb.nctrs != FRIENDS_NLIVE for g in shapes):
        raise RuntimeError(f"the {bound}-unif drive ran {s['config']} with "
                           f"{len(shapes)} friends wave shapes: {n}")
    _print_unif_drive(f"{bound}-unif {bound}/unif nlive={FRIENDS_NLIVE} "
                      f"(bootstrap 5)", s, card)
    print(f"  {bound}-unif: unif_valid {n['unif_valid']} = sync_wave "
          f"{n['sync_wave']} + gated {n['unif_gated']}; replays "
          f"{n['n_unif_replay']}, warm-ups {n['unif_warmups']}; refit share "
          f"of the wall {s['refit_share']:.4f}, dispatch share "
          f"{s['dispatch_share']:.4f}  [{card}]")
    return s


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
    _print_refits(s)
    _print_planning(t)


def _print_refits(s):
    """A drive's ellipsoid rounds and its refit kernels' launches (each
    round's prologue re-fits its stack: two kernels)."""
    n = s.get("launches")
    if n and n.get("refit_rounds"):
        want = len(REFIT_KERNELS) * n["refit_rounds"]
        print(f"  ellipsoid refit: {n['refit_rounds']} chained ellipsoid "
              f"rounds, refit_assign {n['refit_assign']} + refit_fit "
              f"{n['refit_fit']} launches (= {len(REFIT_KERNELS)} x rounds: "
              f"{n['refit_assign'] + n['refit_fit'] == want})")


def _print_planning(t):
    """The refits and the dispatches planned ahead of them."""
    print(f"  planning: n_prelaunch {t.get('n_prelaunch', 0)}  prelaunch "
          f"{t.get('prelaunch', 0.0):.4f} s  n_refit {t.get('n_refit', 0)}"
          f"  refit {t.get('refit', 0.0):.3f} s  refit share of total "
          f"{t.get('refit', 0.0) / max(t.get('total', 0.0), 1e-9):.4f}")


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
          f"{t.get('n_dispatch', 0)}  sync_slice {t.get('sync_slice', 0)}"
          + (f" ({1e3 * t['dispatch'] / t['sync_slice']:.3f} ms dispatch "
             f"each)" if t.get("sync_slice") else "") + "  "
          f"sync_wave {t.get('sync_wave', 0)}  sync_round "
          f"{t.get('sync_round', 0)}  final scale {s['scale']:.4f}  "
          f"proposal stats {s['proposal_stats']}")
    _print_planning(t)


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


# --------------------------------------------------------------------------
# the consume scan: the kernel against its plain version, round by round

C_NDIM = C_NPDIM = 2
C_IL = C_NDIM + C_NPDIM
# (nlive, q, mode) of the comparisons: the port's test size, then the
# drives' widths (balls 2048 / 256, heavy 3000 / 256, queue mode at 1000
# and 2048), q = 1, q = 300 (not a multiple of 32: two chunks of the
# kernel, the second ragged) and a live set past the kernel's
# shared-memory limit in float64 (16384: its logl in global memory)
CONSUME_SHAPES = [(64, 16, "batch"), (2048, 256, "batch"),
                  (3000, 256, "batch"), (64, 1, "batch"),
                  (700, 300, "batch"), (64, 16, "queue"),
                  (1000, 256, "queue"), (2048, 256, "queue"),
                  (64, 1, "queue"), (700, 300, "queue"),
                  (16384, 256, "queue")]
# name: (state kwargs, rounds, ctrl kwargs); every batch case that does
# not stop also runs with the thin path forbidden
# (_FORCE_GENERAL_CONSUME), which must give the same bits
CONSUME_CASES = {
    "batch": {
        "thin": ({}, 1, {}),
        "thin_plateau": ({"plateau": True}, 1, {}),
        "below_threshold": ({"below": True}, 1, {}),
        "two_rounds": ({}, 2, {}),
        "one_of_two_rounds_active": ({}, 2, {"rounds_active": 1}),
        "max_accepts_stop": ({}, 1, {"max_accepts": 5}),
        "dlogz_stop": ({}, 1, {"dlogz": 1e3}),
        "dlogz_stop_mid_round": ({}, 1, {"dlogz": "mid"}),
        "replay": ({"below": True}, 1, {"kills0": 5}),
        "all_neg_inf": ({"neg_inf": True}, 1, {"dlogz": -np.inf}),
        "max_nc_stop_mid_round": ({}, 1, {"max_nc": "mid"}),
        "logl_max_stop_mid_round": ({}, 1, {"logl_max": "mid"}),
        "plateau_at_step": ({"tie_at": "mid"}, 1, {}),
        "enters_in_plateau": ({}, 1, {"plateau": 3}),
        "nan_live": ({"nan_at": 3}, 1, {}),
    },
    "queue": {
        "queue": ({"below": True}, 1, {}),
        "queue_replay": ({"below": True}, 1, {"replay": True}),
        "queue_dlogz_stop_mid_round": ({}, 1, {"dlogz": "mid"}),
        "queue_all_neg_inf": ({"neg_inf": True}, 1, {"dlogz": -np.inf}),
        "queue_max_nc_stop_mid_round": ({"below": True}, 1,
                                        {"max_nc": "mid"}),
        "queue_plateau_at_step": ({"tie_at": "mid"}, 1, {}),
        "queue_enters_in_plateau": ({}, 1, {"plateau": 3}),
        "queue_nan_live": ({"nan_at": 3}, 1, {}),
    },
}
# float32 rounds: (nlive, q, mode, case)
CONSUME_F32 = [(2048, 256, "batch", "thin"),
               (2048, 256, "batch", "below_threshold"),
               (2048, 256, "batch", "plateau_at_step"),
               (1000, 256, "queue", "queue"),
               (2048, 256, "queue", "queue_plateau_at_step")]
# the timed rounds (float64): (nlive, q, mode, thin allowed)
CONSUME_TIMED = [(2048, 256, "batch", True), (2048, 256, "batch", False),
                 (3000, 256, "batch", True), (3000, 256, "batch", False),
                 (1000, 256, "queue", False), (2048, 256, "queue", False),
                 (16384, 256, "queue", False)]
# passes of the chain probe over a round's q steps, whose device time per
# step sizes the chain bound
CHAIN_PROBE_REPS = 64
# the integrator columns of the records, compared bit for bit and, where a
# bit differs, to this relative tolerance
CONSUME_FLOAT_COLS = ("logvol", "logwt", "logz", "logzvar", "h")
CONSUME_RTOL = 1e-12
INTEGRATOR_SWEEP = 10 ** 6


def consume_state(nlive, q, plateau=False, below=False, neg_inf=False,
                  tie_at=None, nan_at=None):
    """A live matrix (u | v | logl | it | bound | birth) and a proposal
    block (u | v | logl | nc | 2 lane stats) above the round's threshold,
    from the seed with numpy (``tests/test_torch_fused.py``'s state).
    ``tie_at``: three points tied at that rank of the sorted logl ('mid':
    q // 2), a plateau that first appears at that kill; ``nan_at``: a NaN
    logl at that row."""
    rs = np.random.Generator(np.random.PCG64(SEED))
    logl = rs.normal(size=nlive) * 2.0
    if plateau:
        logl = np.round(logl)  # ties everywhere, into the kill set
    if neg_inf:
        logl[:] = -np.inf
    if tie_at is not None:
        rank = q // 2 if tie_at == "mid" else tie_at
        order = np.argsort(logl)
        logl[order[rank:rank + 3]] = logl[order[rank]]
    u = rs.random((nlive, C_NDIM))
    live = np.concatenate([
        u, 10.0 * u, logl[:, None],
        rs.integers(0, 50, nlive)[:, None].astype(float),
        np.zeros((nlive, 1)), np.full((nlive, 1), -1e30)], axis=1)
    srt = np.sort(logl)
    if neg_inf:
        thr = -1e30
    elif srt[q - 1] < srt[-1]:
        thr = srt[q - 1]
    else:
        thr = srt[srt < srt[-1]][-1]
    qlogl = thr + np.abs(rs.normal(size=q)) * 3.0 + 1e-3
    if below:
        qlogl[q // 3] = thr - 1.0  # one proposal under the threshold
    if nan_at is not None:
        live[nan_at, C_IL] = np.nan
    qu = rs.random((q, C_NDIM))
    prop = np.concatenate([qu, 10.0 * qu, qlogl[:, None],
                           rs.integers(1, 30, q)[:, None].astype(float),
                           rs.integers(0, 9, (q, 2)).astype(float)], axis=1)
    return live, prop


def consume_ctrl(rounds_active=1, dlogz=0.01, max_accepts=2 ** 30, kills0=0,
                 birth0=-1e30, max_nc=2 ** 30, logl_max=np.inf,
                 plateau=None):
    """The control vector of ``launch_fused`` (fresh integrator, or one
    that enters in plateau mode: ``plateau`` = (counter, logdvol))."""
    pmode, pc, pld = (0.0, 0.0, 0.0) if plateau is None else \
        (1.0, float(plateau[0]), float(plateau[1]))
    return np.array([-1e30, 0.0, 0.0, 0.0, -1e30, pmode, pc, pld, 1.0,
                     dlogz, logl_max, float(max_accepts), float(max_nc),
                     1.0, float(kills0), float(rounds_active), birth0, 0.0,
                     0.0, 0.0, 0.0, 2.0 ** 30])


def run_fixed_round(live, prop, rounds, mode, ctrl, kind="fixed",
                    dtype=torch.float64, plain=False, force_general=False):
    """One fused dispatch on the card over a fixed proposal block (the
    pattern of the replay round): the consume and assembly kernels, or
    with ``plain`` their plain versions on the same CUDA tensors.
    Returns (flat, live out) on the host and the layout."""
    import dynesty_tpu_torch.internal.fused as fused_mod
    from dynesty_tpu_torch.internal.samplers import _ReplayProposer
    from dynesty_tpu_torch.ops import consume as cs

    q, nlive = prop.shape[0], live.shape[0]
    prop_t = torch.as_tensor(prop, dtype=dtype, device="cuda")
    # the replay round's proposer over the block, every round eager
    fn, layout = fused_mod.make_fused_round(
        _ReplayProposer(dtype, "cuda", C_IL), nlive=nlive, ndim=C_NDIM,
        npdim=C_NPDIM, q=q, dtype=dtype, device="cuda", kind=kind,
        rounds=rounds, mode=mode, capture=False)
    saved = (fused_mod.consume_round, fused_mod.round_assemble,
             fused_mod._FORCE_GENERAL_CONSUME)
    if plain:
        fused_mod.consume_round = cs.consume_round_plain
        fused_mod.round_assemble = cs.round_assemble_plain_into
    fused_mod._FORCE_GENERAL_CONSUME = force_general
    try:
        flat, _, live_out, _, _, _ = fn(
            0, torch.as_tensor(live, dtype=dtype, device="cuda"), None,
            {"prop": prop_t}, ctrl)
        torch.cuda.synchronize()
    finally:
        (fused_mod.consume_round, fused_mod.round_assemble,
         fused_mod._FORCE_GENERAL_CONSUME) = saved
    return flat.cpu().numpy(), live_out.cpu().numpy(), layout


def _same_bits(a, b):
    """Elementwise: the same bits, or both NaN."""
    ints = np.int64 if a.dtype == np.float64 else np.int32
    return (a.view(ints) == b.view(ints)) | (np.isnan(a) & np.isnan(b))


def compare_flat(got, ref, layout):
    """Kernel against plain: every integer and copied column, the counters
    and the live matrix bit for bit; the integrator columns counted bit
    for bit and held to :data:`CONSUME_RTOL` where a bit differs.
    ``got``/``ref`` are (flat, live).  Raises on a miss."""
    from dynesty_tpu_torch.internal.fused import record_columns, unpack_flat

    g, r = unpack_flat(got[0], layout), unpack_flat(ref[0], layout)
    cols = record_columns(C_NDIM, C_NPDIM)
    fcols = [i for i, c in enumerate(cols) if c in CONSUME_FLOAT_COLS]
    ecols = [i for i in range(len(cols)) if i not in fcols]
    exact = {
        "records": bool(_same_bits(g["records"][:, ecols],
                                   r["records"][:, ecols]).all()),
        "live": bool(_same_bits(got[1], ref[1]).all()),
        "accepts": bool(np.array_equal(g["accepts"], r["accepts"])),
        "counters": all(g[k] == r[k] for k in (
            "n_accepted", "nc_used", "done", "n_consumed", "done_reason",
            "scale_final", "nc_launched")),
        "integ_counts": all(g["integ"][k] == r["integ"][k] for k in (
            "plateau_mode", "plateau_counter", "it")),
    }
    fg = np.concatenate([g["records"][:, fcols].ravel(), g["delta_logz"],
                         [g["integ"][k] for k in ("logz", "logzvar", "h",
                                                  "logvol", "loglstar",
                                                  "plateau_logdvol")]])
    fr = np.concatenate([r["records"][:, fcols].ravel(), r["delta_logz"],
                         [r["integ"][k] for k in ("logz", "logzvar", "h",
                                                  "logvol", "loglstar",
                                                  "plateau_logdvol")]])
    fg, fr = fg.astype(got[0].dtype), fr.astype(got[0].dtype)
    same = _same_bits(fg, fr)
    with np.errstate(invalid="ignore", divide="ignore"):
        diff = np.abs(fg.astype(np.float64) - fr)
        rel = np.where(same, 0.0, diff / np.abs(fr.astype(np.float64)))
    rel = np.nan_to_num(rel, nan=np.inf)
    out = {"exact": exact, "float_identical": int(same.sum()),
           "float_total": int(same.size),
           "max_rel_err": float(rel.max()),
           "max_abs_err": float(np.where(same, 0.0, diff).max()),
           "done_reason": int(g["done_reason"]),
           "n_accepted": int(g["n_accepted"])}
    if not all(exact.values()) or out["max_rel_err"] > CONSUME_RTOL:
        raise RuntimeError(f"the consume kernel disagrees with its plain "
                           f"version: {out}")
    return out


def consume_case(nlive, q, mode, name, dtype=torch.float64):
    """One case at one shape: the kernel against the plain version, and in
    batch mode (but replay) the kernel's general path against its thin
    path.  Returns the comparison record."""
    kw, rounds, ckw = CONSUME_CASES[mode][name]
    ckw = dict(ckw)
    live, prop = consume_state(nlive, q, **kw)
    kind = "replay" if "kills0" in ckw or ckw.pop("replay", False) \
        else "fixed"
    srt = np.sort(live[:, C_IL])
    if kind == "replay":
        ckw["birth0"] = float(srt[q - 1] if mode == "batch" else srt[0])
    if ckw.get("max_nc") == "mid":
        # the evaluations of the first half: the stop falls mid-round
        ckw["max_nc"] = int(prop[:q // 2, C_IL + 1].sum())
    if ckw.get("logl_max") == "mid":
        # loglstar passes the middle victim's logl after the middle kill
        ckw["logl_max"] = float(srt[q // 2])
    if "plateau" in ckw:
        # a state in plateau mode: its counter, and a shrinkage the
        # round's own would not give
        ckw["plateau"] = (ckw["plateau"], -np.log(nlive + 1.0) - 0.5)
    if ckw.get("dlogz") == "mid":
        # stop where the round's delta_logz first falls below its value at
        # the middle step: lands one step elsewhere on any bit of drift
        ckw["dlogz"] = -np.inf
        flat, _, layout = run_fixed_round(live, prop, rounds, mode,
                                          consume_ctrl(**ckw), kind, dtype,
                                          plain=True)
        from dynesty_tpu_torch.internal.fused import unpack_flat
        ckw["dlogz"] = float(np.nextafter(
            unpack_flat(flat, layout)["delta_logz"][q // 2], np.inf))
    ctrl = consume_ctrl(**ckw)
    ref = run_fixed_round(live, prop, rounds, mode, ctrl, kind, dtype,
                          plain=True)
    got = run_fixed_round(live, prop, rounds, mode, ctrl, kind, dtype)
    out = {"nlive": nlive, "q": q, "mode": mode, "case": name,
           "dtype": str(dtype).split(".")[-1]}
    out.update(compare_flat(got[:2], ref[:2], got[2]))
    if mode == "batch" and kind != "replay" and "stop" not in name:
        # past a stop the two paths fill the unaccepted rows differently
        gen = run_fixed_round(live, prop, rounds, mode, ctrl, kind, dtype,
                              force_general=True)
        ref_gen = run_fixed_round(live, prop, rounds, mode, ctrl, kind,
                                  dtype, plain=True, force_general=True)
        compare_flat(gen[:2], ref_gen[:2], gen[2])
        out["general_equals_thin"] = bool(
            _same_bits(gen[0], got[0]).all() and
            _same_bits(gen[1], got[1]).all())
        if not out["general_equals_thin"]:
            raise RuntimeError(f"the consume kernel's general path differs "
                               f"from its thin path: {out}")
    return out


def integrator_sweep(dtype=torch.float64, n=INTEGRATOR_SWEEP):
    """``n`` random integrator states, a share of them at the edges (-inf
    logl, -inf logz, equal infinities, a first step from -1e300), through
    the kernel's device integrator step and through
    ``progress_integration_torch`` on the card: the bit-identical share."""
    from dynesty_tpu_torch.ops import consume as cs
    from dynesty_tpu_torch.ops.integrals import progress_integration_torch

    rs = np.random.Generator(np.random.PCG64(SEED))
    loglstar = rs.normal(size=n) * 30.0
    loglstar_new = loglstar + np.abs(rs.normal(size=n)) * 3.0
    logvol = -np.abs(rs.normal(size=n)) * 20.0
    dlogvol = 10.0 ** rs.uniform(-7.0, 0.5, size=n)
    logz = loglstar + rs.normal(size=n) * 5.0
    logzvar = np.abs(rs.normal(size=n)) * 0.1
    h = np.abs(rs.normal(size=n)) * 5.0
    edge = rs.integers(0, 20, size=n)  # a quarter at the edges
    loglstar[edge == 1] = -np.inf
    loglstar_new[edge == 2] = -np.inf
    loglstar[edge == 2] = -np.inf
    logz[edge == 3] = -1e300
    logz[edge == 4] = -np.inf
    loglstar[edge == 5] = -1e300
    args = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in (
        loglstar, loglstar_new, logz, logzvar, logvol, dlogvol, h)]
    got = cs.integrator_step(*args)
    ref = progress_integration_torch(*args)
    torch.cuda.synchronize()
    same = [_same_bits(g.cpu().numpy(), r.cpu().numpy())
            for g, r in zip(got, ref)]
    out = {"states": n, "dtype": str(dtype).split(".")[-1],
           "identical_share": {k: float(s.mean()) for k, s in zip(
               ("logwt", "logz", "logzvar", "h"), same)},
           "edge_states": int(((edge > 0) & (edge < 6)).sum())}
    return out


def consume_times(nlive, q, mode, thin, iters=20):
    """Per-call times (CUDA events, warm) of one consume round through the
    kernel's wrapper and through the plain version, on the state of the
    'thin' case (``thin``: the round may take the thin path).  Returns the
    record and the kernel's call, for its device-only time."""
    from dynesty_tpu_torch.ops import consume as cs

    live, prop = consume_state(nlive, q)
    live_logl = torch.as_tensor(live[:, C_IL], device="cuda")
    qlogl = torch.as_tensor(prop[:, C_IL], device="cuda")
    qnc = torch.as_tensor(prop[:, C_IL + 1], device="cuda").to(torch.int64)
    f = torch.zeros((), dtype=torch.float64, device="cuda")
    i = torch.zeros((), dtype=torch.int64, device="cuda")
    b = torch.zeros((), dtype=torch.bool, device="cuda")
    st = {k: (f - 1e30 if k in ("logz", "loglstar") else f)
          for k in cs.FLOAT_KEYS}
    st.update({k: (b if k in cs.BOOL_KEYS else i) for k in cs.INT_KEYS})
    limits = {"dlogz": -math.inf, "logl_max": math.inf,
              "max_accepts": 2 ** 30, "max_nc": 2 ** 30}
    sorted_logl, sort_idx = torch.sort(live_logl, stable=True)
    th = (sort_idx, sorted_logl, torch.ones((), dtype=torch.bool,
                                            device="cuda")) if thin else None
    kw = dict(batch=mode == "batch",
              dlv_default=float(np.log1p(1.0 / nlive)), thin=th)

    def call():
        return cs.consume_round(st, live_logl, qlogl, qnc, limits, **kw)

    ms = _time_ms(call, iters)
    plain_ms = _time_ms(lambda: cs.consume_round_plain(
        st, live_logl, qlogl, qnc, limits, **kw), 2)
    # the round's own evidence chain, for its bound: its logwt column and
    # the logz it starts from
    chain_in = (call()[0][5].clone(), st["logz"])
    return {"nlive": nlive, "q": q, "mode": mode,
            "path": "thin" if thin else "general",
            "resident": cs.smem_layout(nlive, torch.float64)["resident"],
            "ms": ms, "plain_ms": plain_ms,
            "byte_bound_ms": consume_bound_ms(nlive, q, thin)}, \
        (call, chain_in)


def consume_bound_ms(nlive, q, thin, fsize=8):
    """The bytes one launch must move on its path, at the card's memory
    rate: in, the proposals' logl and nc and the carried state, and on the
    thin path the first q sorted logl and indices, the largest live logl
    and the thin flag (the tie counts are found in the kernel), on the
    general path the whole live logl; out, the 11 per-step columns, the
    accepts and the state (``fsize`` the float type's bytes).  The
    operations (a few dozen a step, and on the general path a segment's
    compares a step) are far below; the chain of q dependent steps is
    :func:`chain_step_ms`'s bound."""
    state = 6 * fsize + 9 * 8 + 8          # floats, ints, path count
    by = q * (fsize + 8) + state
    by += q * (fsize + 8) + fsize + 1 if thin else nlive * fsize
    by += q * (8 * fsize + 3 * 8 + 1) + state + 2
    return 1e3 * by / HBM_BYTES


def chain_probe_check(chain_in):
    """The chain probe against its plain loop on a round's own chain
    inputs, bit for bit, in float64 and float32."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        logwt, logz0 = (t.to(dtype) for t in chain_in)
        got = cs.chain_probe(logwt, logz0)
        ref = cs.chain_probe_plain(logwt, logz0)
        torch.cuda.synchronize()
        out[str(dtype).split(".")[-1]] = bool(torch.equal(got, ref))
    if not all(out.values()):
        raise RuntimeError(f"the chain probe differs from its plain loop: "
                           f"{out}")
    return out


def chain_step_ms(chain_in, reps=CHAIN_PROBE_REPS):
    """Device time (profiler) of one step of a round's evidence chain
    alone, ``reps`` passes over its q dependent logaddexps on one thread:
    the least a step of the consume scan can take on this card; q of them
    are the round's chain bound."""
    logwt, logz0 = chain_in
    return _device_ms(lambda: cs.chain_probe(logwt, logz0, reps), 5) / (
        logwt.shape[0] * reps)


def consume_phase(card):
    """Every case at every shape (float64), the layout boundary, the
    float32 rounds, the integrator sweep, the chain probe and the times;
    prints one line each and returns the records and the timed calls."""
    cases = []

    def show(rec, what):
        print(f"consume {what} ({rec['nlive']}, {rec['q']}) {rec['case']}: "
              f"float columns bit-identical {rec['float_identical']}/"
              f"{rec['float_total']}  max rel err "
              f"{rec['max_rel_err']:.3e}  reason {rec['done_reason']}"
              f"  accepted {rec['n_accepted']}"
              + (f"  general == thin {rec['general_equals_thin']}"
                 if "general_equals_thin" in rec else "")
              + (f"  resident {rec['resident']}" if "resident" in rec
                 else "") + f"  [{card}]")

    for nlive, q, mode in CONSUME_SHAPES:
        for name in CONSUME_CASES[mode]:
            rec = consume_case(nlive, q, mode, name)
            cases.append(rec)
            show(rec, mode)
    # the general path's layouts at their boundary: the largest live set
    # resident in shared memory, and one point more
    limit = cs.resident_limit(torch.float64)
    for nlive in (limit, limit + 1):
        rec = consume_case(nlive, 64, "queue", "queue")
        rec["resident"] = cs.smem_layout(nlive, torch.float64)["resident"]
        if rec["resident"] != (nlive == limit):
            raise RuntimeError(f"the layout at nlive={nlive}: {rec}")
        cases.append(rec)
        show(rec, "queue, layout boundary")
    for nlive, q, mode, name in CONSUME_F32:
        rec = consume_case(nlive, q, mode, name, dtype=torch.float32)
        cases.append(rec)
        show(rec, f"float32 {mode}")
    sweep = [integrator_sweep(dt) for dt in (torch.float64, torch.float32)]
    for s in sweep:
        print(f"integrator step, {s['states']} states ({s['edge_states']} "
              f"at the edges), {s['dtype']}: bit-identical share "
              f"{s['identical_share']}  [{card}]")
    timed = [consume_times(*t) for t in CONSUME_TIMED]
    times = [t for t, _ in timed]
    probe = chain_probe_check(timed[0][1][1])
    print(f"chain probe against its plain loop on the (2048, 256) thin "
          f"round's chain: bit-identical {probe}  [{card}]")
    for t in times:
        print(f"consume round {t['mode']} ({t['nlive']}, {t['q']}) "
              f"{t['path']}: kernel {t['ms']:.4f} ms (events, through the "
              f"wrapper)  plain {t['plain_ms']:.1f} ms  byte bound "
              f"{t['byte_bound_ms']:.3e} ms  [{card}]")
    ident = sum(c["float_identical"] for c in cases)
    total = sum(c["float_total"] for c in cases)
    print(f"consume: {len(cases)} rounds, float columns bit-identical "
          f"{ident}/{total}  [{card}]")
    return {"cases": cases, "integrator_sweep": sweep, "times": times,
            "chain_probe": probe, "float_identical": ident,
            "float_total": total,
            "max_abs_err": max(c["max_abs_err"] for c in cases)}, \
        [c for _, c in timed]


def consume_device_times(consume, calls, card):
    """Phase 34's part: each timed round's device-only time (profiler),
    the chain bound (the round's own q dependent logaddexps on one thread,
    timed here), the byte bound, the larger of the two and the share of it
    the kernel reaches."""
    for t, (call, chain_in) in zip(consume["times"], calls):
        t["device_ms"] = _device_ms(call)
        t["chain_step_ms"] = chain_step_ms(chain_in)
        t["chain_bound_ms"] = t["q"] * t["chain_step_ms"]
        t["bound_ms"] = max(t["chain_bound_ms"], t["byte_bound_ms"])
        t["bound_by"] = "operations" if t["chain_bound_ms"] >= \
            t["byte_bound_ms"] else "bytes"
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
        print(f"consume round {t['mode']} ({t['nlive']}, {t['q']}) "
              f"{t['path']} device only: kernel {t['device_ms']:.4f} ms  "
              f"events {t['ms']:.4f} ms  chain bound "
              f"{t['chain_bound_ms']:.4f} ms ({1e6 * t['chain_step_ms']:.1f} "
              f"ns a step)  byte bound "
              f"{t['byte_bound_ms']:.3e} ms  share "
              f"{100 * t['bound_share']:.1f} %  [{card}]")


# --------------------------------------------------------------------------
# the proposal loops' per-step kernels against their plain versions


STEP_Q = 256
# (loop, ndim, ncdim, masks): the slice kernels at the main drive's 3-D,
# the rwalk drive's 15-D and 48-D; the walk's at 3-D, 15-D (all dimensions
# bounded or 12 of them) and 48-D, each without masks (as the rwalk drive
# runs) and with periodic, reflective and loose dimensions
STEP_CASES = [("slice", 3, None, None), ("slice", 15, None, None),
              ("slice", 48, None, None)] + [
    ("rwalk", ndim, ncdim, masks)
    for ndim, ncdim in ((3, 3), (15, 15), (15, 12), (48, 48))
    for masks in (False, True)]
# slice updates per lane (rslice's default)
STEP_NSTEPS = 5
STEP_LOGLSTAR = 0.25

# --------------------------------------------------------------------------
# the round's assembly and the captured round

# (nlive, q, mode, path) of the assembly's cases: the consume scan's four
# main shapes, a replay round (five kills before it, its refills born at
# birth0) and a general round whose proposals straddle the threshold
# (some rejected, some accepted and killed later in the round: records
# taken from the proposals); then the queue shape at 16384 live points,
# one lane, and the thin round with its accepts taken away ('none') or
# every entry accepted into one slot ('one_slot')
ASSEMBLE_CASES = ((2048, 256, "batch", "thin"), (2048, 256, "batch",
                                                  "general"),
                  (3000, 256, "batch", "thin"), (1000, 256, "queue",
                                                 "general"),
                  (2048, 256, "batch", "replay"),
                  (2048, 256, "batch", "mixed"),
                  (16384, 256, "queue", "general"),
                  (64, 1, "batch", "thin"),
                  (2048, 256, "batch", "none"),
                  (2048, 256, "batch", "one_slot"))
ASSEMBLE_ROUNDS = 3
# the paths of three rounds on one set of buffers
ASSEMBLE_SEQUENCE = ("thin", "none", "one_slot")


def assemble_inputs(nlive, q, mode, path):
    """``consume_state``'s live matrix and proposals on the card, the
    consume kernel's columns for them, and the round's it0, birth and
    threshold."""
    live, prop = consume_state(nlive, q)
    if path == "mixed":
        rs = np.random.Generator(np.random.PCG64(SEED + 1))
        prop[:, C_IL] = np.sort(live[:, C_IL])[q - 1] + rs.normal(size=q)
    live_t = torch.as_tensor(live, device="cuda")
    prop_t = torch.as_tensor(prop, device="cuda")
    f = torch.zeros((), dtype=torch.float64, device="cuda")
    i = torch.zeros((), dtype=torch.int64, device="cuda")
    b = torch.zeros((), dtype=torch.bool, device="cuda")
    st = {k: (f - 1e30 if k in ("logz", "loglstar") else f)
          for k in cs.FLOAT_KEYS}
    st.update({k: (b if k in cs.BOOL_KEYS else i) for k in cs.INT_KEYS})
    if path == "replay":
        st["racc"] = i + 5
    live_logl = live_t[:, C_IL].contiguous()
    qnc = prop_t[:, C_IL + 1].to(torch.int64)
    sorted_logl, sort_idx = torch.sort(live_logl, stable=True)
    thin = (sort_idx, sorted_logl, torch.ones((), dtype=torch.bool,
                                              device="cuda")) \
        if path in ("thin", "none", "one_slot") else None
    limits = {"dlogz": -math.inf, "logl_max": math.inf,
              "max_accepts": 2 ** 30, "max_nc": 2 ** 30}
    outs, _ = cs.consume_round(st, live_logl, prop_t[:, C_IL].contiguous(),
                               qnc, limits, batch=mode == "batch",
                               dlv_default=float(np.log1p(1.0 / nlive)),
                               thin=thin)
    outs = list(outs)
    if path == "none":
        outs[2] = torch.zeros_like(outs[2])
    elif path == "one_slot":
        outs[0] = torch.full_like(outs[0], nlive // 3)
        outs[2] = torch.ones_like(outs[2])
    thr = sorted_logl[q - 1] if mode == "batch" else live_logl.min()
    birth = thr if path != "replay" else torch.tensor(
        -3.5, dtype=torch.float64, device="cuda")
    it0 = torch.tensor(987654, device="cuda")
    return outs, live_t, prop_t, qnc, it0, birth, thr


def assemble_bytes(outs, last, nlive, q, il, fsize=8):
    """The bytes one assembly must move on these inputs: in, the scan's
    columns, every proposal's ``u | v | logl``, nc and lane stats, what
    the record reads of a dead original's live row (``u | v``, it, bound
    and birth: its logl comes from the scan) and the round's scalars
    (it0, the round's index, the birth and the threshold); out, the
    record, proposal, accept, delta_logz and lane-stat rows, the
    threshold, ``last`` and the refilled live rows."""
    lw = il + 4
    n_orig = int((outs[1] < 0).sum())
    n_repl = int((last >= 0).sum())
    by = q * (2 * 8 + 1 + 8 * fsize + 8)          # the scan's columns
    by += q * ((il + 1) * fsize + 8 + 2 * fsize)  # the proposals
    by += n_orig * (il + 3) * fsize + 2 * 8 + 2 * fsize
    by += q * ((il + 12) + (il + 4) + 4) * fsize + fsize
    by += nlive * 8 + n_repl * lw * fsize
    return by


def assemble_case(nlive, q, mode, path):
    """The kernels against ``round_assemble_plain`` on the same CUDA
    tensors (the plain version writing the same buffers), every output
    bit for bit, and both timed; the byte bound from this case's data."""
    outs, live, prop, qnc, it0, birth, thr = assemble_inputs(nlive, q, mode,
                                                             path)
    ridx = torch.tensor(1, device="cuda")
    lane = prop[:, C_IL + 2:]
    res = {}
    for name, fn in (("kernel", cs.round_assemble),
                     ("plain", cs.round_assemble_plain_into)):
        out = cs.assemble_buffers(ASSEMBLE_ROUNDS, q, nlive, C_NDIM, C_NPDIM,
                                  torch.float64, "cuda")
        for t in out.values():
            t.zero_()
        lv = live.clone()
        fn(outs, lv, prop, qnc, lane, it0, birth, thr, out, ridx,
           ndim=C_NDIM)
        torch.cuda.synchronize()
        out.pop("entry_it")
        res[name] = dict(out, live=lv)
    same, err = {}, 0.0
    for k, a in res["kernel"].items():
        a, b = a.cpu().numpy(), res["plain"][k].cpu().numpy()
        same[k] = bool(_same_bits(a, b).all()) if a.dtype.kind == "f" \
            else bool(np.array_equal(a, b))
        if a.dtype.kind == "f":
            with np.errstate(invalid="ignore"):
                d = np.abs(a - b)
            err = max(err, float(np.nanmax(d)) if d.size else 0.0)
    rec = {"nlive": nlive, "q": q, "mode": mode, "path": path,
           "same": same, "max_abs_err": err,
           "accepted": int(outs[2].sum()),
           "from_originals": int((outs[1] < 0).sum()),
           "refilled": int((res["kernel"]["last"] >= 0).sum())}
    if not all(same.values()):
        raise RuntimeError(f"round_assemble differs from its plain version: "
                           f"{rec}")
    out = cs.assemble_buffers(ASSEMBLE_ROUNDS, q, nlive, C_NDIM, C_NPDIM,
                              torch.float64, "cuda")
    lv = live.clone()

    def call(fn):
        return lambda: fn(outs, lv, prop, qnc, lane, it0, birth, thr, out,
                          ridx, ndim=C_NDIM)

    n0 = cs.round_assemble.launches
    rec["ms"] = _time_ms(call(cs.round_assemble), 50)
    rec["device_ms"] = _device_ms(call(cs.round_assemble), 20,
                                  only="assemble")
    for part in ("records", "refill"):
        rec[f"{part}_device_ms"] = _device_ms(call(cs.round_assemble), 20,
                                              only=f"assemble_{part}")
    rec["plain_ms"] = _time_ms(call(cs.round_assemble_plain_into), 5)
    cs.round_assemble.launches = n0
    rec["bytes"] = assemble_bytes(outs, res["kernel"]["last"], nlive, q,
                                  C_IL)
    rec["bound_ms"] = 1e3 * rec["bytes"] / HBM_BYTES
    rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
    return rec


def assemble_sequence():
    """The rounds of ``ASSEMBLE_SEQUENCE`` at (2048, 256) on one set of
    buffers (round r at rows r * q, the kernels' mark carried from round
    to round), launched eagerly and then replayed from one graph captured
    on fixed inputs, against the plain version on its own buffers: every
    output of every round bit for bit.  Returns (identical, total)."""
    nlive, q = 2048, 256
    rounds = [assemble_inputs(nlive, q, "batch", path)
              for path in ASSEMBLE_SEQUENCE]
    live = rounds[0][1]
    n = len(rounds)

    def fresh():
        out = cs.assemble_buffers(n, q, nlive, C_NDIM, C_NPDIM,
                                  torch.float64, "cuda")
        for t in out.values():
            t.zero_()
        return out, live.clone(), torch.zeros((), dtype=torch.int64,
                                              device="cuda")

    def snap(out, lv):
        return dict({k: t.clone() for k, t in out.items()
                     if k != "entry_it"}, live=lv.clone())

    def run(fn):
        out, lv, ridx = fresh()
        snaps = []
        for outs, _, prop, qnc, it0, birth, thr in rounds:
            fn(outs, lv, prop, qnc, prop[:, C_IL + 2:], it0, birth, thr,
               out, ridx, ndim=C_NDIM)
            torch.cuda.synchronize()
            snaps.append(snap(out, lv))
            ridx.add_(1)
        return snaps

    ref = run(cs.round_assemble_plain_into)
    eager = run(cs.round_assemble)
    # one graph of the call on fixed inputs, each round copied in
    fixed = [[t.clone() for t in rounds[0][0]]] + \
        [t.clone() for t in rounds[0][1:]]
    out, lv, ridx = fresh()
    outs, _, prop, qnc, it0, birth, thr = fixed
    g = torch.cuda.CUDAGraph()
    n0 = cs.round_assemble.launches
    with torch.cuda.graph(g):
        cs.round_assemble(outs, lv, prop, qnc, prop[:, C_IL + 2:], it0,
                          birth, thr, out, ridx, ndim=C_NDIM)
    cs.round_assemble.launches = n0
    replayed = []
    for r in range(n):
        for d, t in zip(fixed[0], rounds[r][0]):
            d.copy_(t)
        for d, t in zip(fixed[1:], rounds[r][1:]):
            d.copy_(t)
        g.replay()
        torch.cuda.synchronize()
        replayed.append(snap(out, lv))
        ridx.add_(1)
    same = [torch.equal(a[k], b[k]) for got in (eager, replayed)
            for a, b in zip(got, ref) for k in b]
    return sum(same), len(same)


def _bench_case(c):
    """A ``bench_kernels.py`` record's case, for the side-by-side line."""
    what = c["kernel"]
    for k in ("kind", "mode", "path", "m", "nctrs", "nlive", "q", "ndim",
              "ncdim", "n", "rows", "dtype", "seed"):
        if c.get(k) is not None:
            what += f" {k} {c[k]}"
    return what


def parent_times(root, card):
    """``bench_kernels.py`` on the checkout at ``root`` and on this one, in
    turns (parent, change, change, parent), a process each; prints each
    case's times, all four runs side by side, and returns the first run's
    records of each by ``parent`` / ``change``."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent"):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "bench.json")
            subprocess.run([sys.executable,
                            os.path.join(here, "bench_kernels.py"),
                            "--root", root if name == "parent" else here,
                            "--out", path], check=True, timeout=600,
                           stdout=subprocess.DEVNULL)
            with open(path) as f:
                runs[name].append(json.load(f)["cases"])
    for cases in zip(*runs["parent"], *runs["change"]):
        p1, p2, c1, c2 = cases
        keys = [k for k in p1 if k.endswith("_us")]
        if not keys:
            continue
        cols = "  ".join(
            f"{k[:-3]} {c1[k]:.3f}, {c2[k]:.3f} / {p1[k]:.3f}, {p2[k]:.3f}"
            for k in keys)
        print(f"{_bench_case(p1)}: us, change / parent (runs in turns): "
              f"{cols}  [{card}]")
    # the outputs' bits, case by case (each version's two runs too)
    bits = {"compared": 0, "equal": 0, "differ": [], "runs_differ": []}
    for p1, p2, c1, c2 in zip(*runs["parent"], *runs["change"]):
        if "digest" not in p1 or "digest" not in c1:
            continue
        bits["compared"] += 1
        if p1["digest"] == c1["digest"]:
            bits["equal"] += 1
        else:
            bits["differ"].append(_bench_case(p1))
        if p1["digest"] != p2["digest"] or c1["digest"] != c2["digest"]:
            bits["runs_differ"].append(_bench_case(p1))
    print(f"output bits equal to the parent's: {bits['equal']}/"
          f"{bits['compared']} cases; differ: {bits['differ']}; a version's "
          f"two runs differ: {bits['runs_differ']}  [{card}]")
    return {"bits": bits, **{k: v[0] for k, v in runs.items()}}


def round_assemble_phase(card):
    """The assembly's kernels against their plain version at the consume
    scan's main shapes, on a replay round and the edge cases, then three
    rounds on one set of buffers eagerly and replayed; one line each."""
    cases = []
    for nlive, q, mode, path in ASSEMBLE_CASES:
        rec = assemble_case(nlive, q, mode, path)
        cases.append(rec)
        print(f"round_assemble ({nlive}, {q}) {mode} {path}: bit-identical "
              f"{sum(rec['same'].values())}/{len(rec['same'])} outputs "
              f"({rec['accepted']} accepted, {rec['from_originals']} dead "
              f"originals, {rec['refilled']} slots refilled)  max_abs_err "
              f"{rec['max_abs_err']:.3e}  per call: kernels (two launches) "
              f"{rec['ms']:.4f} ms events, {rec['device_ms']:.5f} ms device "
              f"only (records {rec['records_device_ms']:.5f}, refill "
              f"{rec['refill_device_ms']:.5f}); plain {rec['plain_ms']:.4f} "
              f"ms  bound {rec['bound_ms']:.6f} ms ({rec['bytes']} bytes, "
              f"{100 * rec['bound_share']:.1f} % of device)  [{card}]")
    same, total = assemble_sequence()
    print(f"round_assemble (2048, 256) rounds {', '.join(ASSEMBLE_SEQUENCE)} "
          f"on one set of buffers, eager and replayed from one graph: "
          f"bit-identical {same}/{total} outputs  [{card}]")
    if same != total:
        raise RuntimeError(f"round_assemble's rounds on one set of buffers "
                           f"differ from the plain version: {same}/{total}")
    return cases


# --------------------------------------------------------------------------
# the ellipsoid refit of a chained unif round (phase 2i)

# the refit's cases: (name, live points, ellipsoids, padded slots,
# dimensions): the eggbox drive's stack (18 modes in 32 slots), the heavy
# drive's (3000 points, one ellipsoid), 3000 points in three ellipsoids, a
# 15-D stack, the widest live set the tests reach, and two stacks past
# refit_fit's shared-memory ceiling in float64 (16384 members of one
# slot; about 1000 members a slot in 40 dimensions)
REFIT_CASES = (("eggbox", 1000, 18, 32, 2), ("heavy", 3000, 1, 1, 3),
               ("multi", 3000, 3, 4, 3), ("d15", 1000, 5, 8, 15),
               ("wide", 16384, 20, 32, 3), ("ceiling", 16384, 1, 1, 3),
               ("d40", 2000, 2, 4, 40))
# the edge stacks at (200 points, 3 ellipsoids, 4 slots, 3 dimensions): a
# slot of two members, a member whose covariance overflows, five padding
# slots with no member (8 slots), and no expand
REFIT_EDGES = ("degenerate", "overflow", "empty_pad", "no_expand")
# the largest difference allowed, per slot and array, relative to the
# slot's largest entry of the plain version's array: float64 (the card's
# eager refit was held to the CPU's at 1e-10 too), float32
REFIT_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# a point's slot must agree where the plain version's two smallest forms
# differ by more than this, relative
REFIT_TIE = 1e-12
REFIT_ARRAYS = ("ctrs", "axes", "ams", "logvols")


def refit_inputs(n, k, m, d, dtype=torch.float64, case=None, seed=SEED):
    """Live points from ``k`` Gaussian clusters in the cube and the
    dispatch's fit of them padded to ``m`` slots (each cluster's sample
    covariance enlarged by 1.2, or its true one below d + 1 points), as a
    fused round holds them: the points in the first ``d`` columns of a
    live matrix of ``d + 6`` columns (the row stride the kernels read), the
    arrays on the card in ``dtype``, ``expand`` 1.1.  ``case``: one of
    ``REFIT_EDGES``."""
    from dynesty_tpu_torch.internal.kernels import pad_ellipsoids
    # the unit d-ball's log-volume (written out: bench_kernels.py makes
    # these inputs for checkouts before the refit kernels too)
    pref = (d / 2.0) * math.log(math.pi) - math.lgamma(d / 2.0 + 1.0)
    rng = np.random.Generator(np.random.PCG64(seed))
    ctrs = rng.uniform(0.25, 0.75, (k, d))
    covs = np.empty((k, d, d))
    for j in range(k):
        a = rng.normal(size=(d, d))
        covs[j] = 1e-3 * (a @ a.T / d + 0.5 * np.eye(d))
    which = rng.integers(0, k, n)
    if case == "degenerate":
        which[which == k - 1] = 0
        which[:2] = k - 1
    z = rng.normal(size=(n, d))
    u = ctrs[which] + np.einsum("nij,nj->ni", np.linalg.cholesky(covs)[which],
                                z)
    fit = {"ctrs": [], "axes": [], "ams": [], "logvols": []}
    for j in range(k):
        pts = u[which == j]
        c = covs[j] if len(pts) <= d else np.cov(pts.T, bias=True) * 1.2
        ax = np.linalg.cholesky(c)
        fit["ctrs"].append(pts.mean(0) if len(pts) else ctrs[j])
        fit["axes"].append(ax)
        fit["ams"].append(np.linalg.inv(c))
        fit["logvols"].append(np.log(np.diag(ax)).sum() + pref)
    padded = pad_ellipsoids(*(np.asarray(fit[key]) for key in
                              ("ctrs", "axes", "ams", "logvols")),
                            min_pad=m)
    if case == "overflow":
        u[-1] = ctrs[k - 1] + 1e200
    live = np.zeros((n, d + 6))
    live[:, :d] = u
    live[:, d:] = rng.uniform(size=(n, 6))
    arrays = {key: torch.as_tensor(v, dtype=torch.bool if key == "mask"
                                   else dtype, device="cuda")
              for key, v in padded.items()}
    if case != "no_expand":
        arrays["expand"] = torch.tensor(1.1, dtype=dtype, device="cuda")
    return torch.as_tensor(live, dtype=dtype, device="cuda"), arrays


def refit_rel_err(a, b):
    """The largest difference of ``a`` from ``b`` (both (m, ...)) in any
    slot, over that slot's largest finite ``|b|`` (the difference itself
    where there is none); 0 where both are equal (infinities too) or NaN,
    inf where one is NaN or infinite and the other is not."""
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    same = (torch.isnan(a) & torch.isnan(b)) | (a == b)
    diff = torch.where(same, 0.0, (a - b).abs())
    diff = torch.where(torch.isnan(diff), math.inf, diff)
    scale = torch.where(torch.isfinite(b), b.abs(), 0.0).amax(dim=1)
    return float((diff.amax(dim=1) / torch.where(scale > 0, scale, 1.0))
                 .max())


def refit_bound(n, m, k, d, fsize, kernel):
    """The least time of a refit kernel on these inputs, ms, and what
    bounds it: the bytes it must move (each input read once, each output
    written once) at 3.35 TB/s against the operations its ``k`` ellipsoids
    and ``n`` points need at the card's float64 (or float32) rate."""
    e = d * (d + 1) // 2
    slot_bytes = m * ((d + 2 * d * d + 1) * fsize + 1)
    if kernel == "refit_assign":
        nbytes = n * d * fsize + m * (d + d * d) * fsize + m + n * 8
        ops = n * k * (2 * d * d + 3 * d)
    else:
        # in: the points, their slots, the fit and expand; out: the fit
        nbytes = n * d * fsize + n * 8 + 2 * slot_bytes + fsize + m
        ops = n * (d + 3 * e + 2 * d * d + 3 * d) + k * (2 * d ** 3 +
                                                         3 * d * d)
    rate = FP64_FLOPS if fsize == 8 else FP32_FLOPS
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES, 1e3 * ops / rate
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else
                                   "operations")


def refit_case(name, n, k, m, d, dtype, case=None):
    """The two refit kernels against the plain version on the same CUDA
    tensors: each point's slot (equal wherever the plain version's two
    smallest forms differ by more than ``REFIT_TIE``), then the fit
    against the plain fit of the kernel's slots (within ``REFIT_RTOL`` on
    every array, equal ``mask`` and slots re-fitted) and against the
    whole plain refit; two launches and a captured replay equal bit for
    bit."""
    from dynesty_tpu_torch.ops import ellipsoid_refit as rr
    live, arrays = refit_inputs(n, k, m, d, dtype, case)
    u = live[:, :d]
    rf = rr.EllipsoidRefit(n, m, d, dtype, "cuda")

    def empty():
        return {key: torch.empty_like(arrays[key])
                for key in rr.REFIT_FIELDS}

    out = empty()
    rr.refit_assign(rf, u, arrays)
    d2, idx_p = rr.refit_assign_plain(u, arrays["ctrs"], arrays["ams"],
                                      arrays["mask"])
    idx = rf.idx.clone()
    srt = d2.sort(dim=1).values
    decided = (srt[:, 1] - srt[:, 0] > REFIT_TIE * srt[:, 0].abs()) \
        if m > 1 else torch.ones_like(idx, dtype=torch.bool)
    rr.refit_fit(rf, u, arrays, out)
    keep = rf.keep.clone()
    ref, keep_p = rr.refit_fit_plain(u, idx, arrays, d, dtype,
                                     with_keep=True)
    whole = rr.ellipsoid_refit_plain(u, arrays, d, dtype)
    # again, and captured then replayed: the same bits
    again = empty()
    rr.ellipsoid_refit(rf, u, arrays, again)
    replayed = empty()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    n0 = [w.launches for w in rr.WRAPPERS]
    with torch.cuda.stream(side):
        graph.capture_begin()
        rr.ellipsoid_refit(rf, u, arrays, replayed)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    for w, c in zip(rr.WRAPPERS, n0):
        w.launches = c
    same_bits = all(bool(_same_bits(x[key].cpu().numpy(),
                                    out[key].cpu().numpy()).all())
                    for x in (again, replayed) for key in REFIT_ARRAYS) and \
        all(torch.equal(x["mask"], out["mask"]) for x in (again, replayed))
    rec = {"name": name, "case": case, "n": n, "k": k, "m": m, "d": d,
           "dtype": str(dtype).split(".")[-1],
           "idx_equal": int((idx == idx_p).sum()),
           "near_ties": int((~decided).sum()),
           "idx_differ_decided": int(((idx != idx_p) & decided).sum()),
           "idx_max_abs_err": int(((idx - idx_p).abs() * decided).max()),
           "mask_equal": torch.equal(out["mask"], ref["mask"]),
           "keep_equal": torch.equal(keep, keep_p),
           "kept": int(keep.sum()),
           "rel_err": {key: refit_rel_err(out[key], ref[key])
                       for key in REFIT_ARRAYS},
           "whole_rel_err": {key: refit_rel_err(out[key], whole[key])
                             for key in REFIT_ARRAYS},
           "max_abs_err": max(float(torch.nan_to_num(
               (out[key] - ref[key]).abs(), nan=0.0).max())
               for key in REFIT_ARRAYS),
           "deterministic": same_bits,
           "fit_layout": rf.fit_layout}
    rtol = REFIT_RTOL[dtype]
    if rec["idx_differ_decided"] or not (
            rec["mask_equal"] and rec["keep_equal"] and same_bits and
            max(rec["rel_err"].values()) <= rtol and (
                rec["idx_equal"] < n or
                max(rec["whole_rel_err"].values()) <= rtol)):
        raise RuntimeError(f"the refit kernels differ from the plain "
                           f"version: {rec}")
    if dtype == torch.float64 and case is None:
        fs = 8
        for kernel, fn, plain in (
                ("refit_assign", lambda: rr.refit_assign(rf, u, arrays),
                 lambda: rr.refit_assign_plain(u, arrays["ctrs"],
                                               arrays["ams"],
                                               arrays["mask"])),
                ("refit_fit", lambda: rr.refit_fit(rf, u, arrays, out),
                 lambda: rr.refit_fit_plain(u, idx, arrays, d, dtype))):
            n0 = [w.launches for w in rr.WRAPPERS]
            rec[f"{kernel}_ms"] = _time_ms(fn, 50)
            rec[f"{kernel}_plain_ms"] = _time_ms(plain, 10)
            for w, c in zip(rr.WRAPPERS, n0):
                w.launches = c
            rec[f"{kernel}_bound_ms"], rec[f"{kernel}_bound_by"] = \
                refit_bound(n, m, k, d, fs, kernel)
        n0 = [w.launches for w in rr.WRAPPERS]
        rec["ms"] = _time_ms(lambda: rr.ellipsoid_refit(rf, u, arrays, out),
                             50)
        rec["plain_ms"] = _time_ms(
            lambda: rr.ellipsoid_refit_plain(u, arrays, d, dtype), 10)
        for w, c in zip(rr.WRAPPERS, n0):
            w.launches = c
        rec["call"] = lambda: rr.ellipsoid_refit(rf, u, arrays, out)
    return rec


def refit_phase(card):
    """Phase 2i: the refit kernels against the plain version at the
    drives' stacks and the edge stacks, float64 and float32; one line
    each.  Returns the records (the float64 drive cases keep a ``call``
    for phase 34's device times)."""
    cases = []
    for dtype in (torch.float64, torch.float32):
        for name, n, k, m, d in REFIT_CASES:
            cases.append(refit_case(name, n, k, m, d, dtype))
        for case in REFIT_EDGES:
            cases.append(refit_case(case, 200, 3, 8 if case == "empty_pad"
                                    else 4, 3, dtype, case))
    for rec in cases:
        times = ""
        if "ms" in rec:
            times = (f"  per call: both kernels {rec['ms']:.4f} ms events, "
                     f"plain {rec['plain_ms']:.4f} ms; refit_assign "
                     f"{rec['refit_assign_ms']:.4f} ms (plain "
                     f"{rec['refit_assign_plain_ms']:.4f}, bound "
                     f"{rec['refit_assign_bound_ms']:.6f} ms "
                     f"{rec['refit_assign_bound_by']}), refit_fit "
                     f"{rec['refit_fit_ms']:.4f} ms (plain "
                     f"{rec['refit_fit_plain_ms']:.4f}, bound "
                     f"{rec['refit_fit_bound_ms']:.6f} ms "
                     f"{rec['refit_fit_bound_by']})")
        lay = rec["fit_layout"]
        staging = (f", members staged {lay['cap']} at a time "
                   f"({'all' if lay['staged'] else 'past the ceiling'})")
        print(f"ellipsoid refit {rec['name']} ({rec['n']} points, "
              f"{rec['k']} ellipsoids in {rec['m']} slots, d {rec['d']}) "
              f"{rec['dtype']}{staging}: slots equal "
              f"{rec['idx_equal']}/{rec['n']} "
              f"(near ties {rec['near_ties']}, decided and different "
              f"{rec['idx_differ_decided']}), mask equal "
              f"{rec['mask_equal']}, re-fitted slots equal "
              f"{rec['keep_equal']} ({rec['kept']} kept), max relative "
              f"error {max(rec['rel_err'].values()):.3e} "
              f"{json.dumps(rec['rel_err'])} (whole plain refit "
              f"{max(rec['whole_rel_err'].values()):.3e}), max_abs_err "
              f"{rec['max_abs_err']:.3e}, two launches and a replay the "
              f"same bits {rec['deterministic']}{times}  [{card}]")
    return cases


def captured_round_phase(dyt, card):
    """The balls drive's path (nlive 2048, balls/rslice, to 3,000
    iterations) run with every fused round's prologue and epilogue eager,
    then captured: every result bit for bit, every round's generator at
    the same offset, the same counts but the replays; then the captured
    prologue's and epilogue's replay, device only and by the host clock
    with its wait."""
    import dynesty_tpu_torch.internal.fused as tf
    import dynesty_tpu_torch.internal.samplers as ts
    make, capture_rule = tf.torch_generator, ts._capture_rounds
    runs = {}
    for name in ("eager", "captured"):
        gens = []

        def recorded(seed, device):
            g = make(seed, device)
            gens.append(g)
            return g

        tf.torch_generator = recorded
        if name == "eager":
            ts._capture_rounds = lambda ns: False
        try:
            s, sampler = drive(dyt, 2048, "balls", maxiter=3000)
        finally:
            tf.torch_generator, ts._capture_rounds = make, capture_rule
        runs[name] = (sampler, [g.get_offset() for g in gens])
    (se, oe), (sc, oc) = runs["eager"], runs["captured"]
    a, b = se.results, sc.results
    same = {k: bool(_same_bits(np.asarray(a[k], dtype=np.float64),
                               np.asarray(b[k], dtype=np.float64)).all())
            for k in ("logl", "logvol", "logwt", "logz", "logzerr",
                      "samples", "samples_u", "samples_it", "samples_n",
                      "samples_birth", "ncall")}
    same["generator_offsets"] = oe == oc
    te, tc = se.timings, sc.timings
    for k in ("n_round", "sync_slice", "sync_wave", "n_dispatch",
              "nc_launched"):
        same[k] = te.get(k, 0) == tc.get(k, 0)
    out = {"same": same, "rounds": tc["n_round"],
           "n_round_replay": tc.get("n_round_replay", 0),
           "n_round_graph": tc.get("n_round_graph", 0),
           "sync_round": {"eager": te.get("sync_round", 0),
                          "captured": tc.get("sync_round", 0)},
           "dispatch_s": {"eager": te["dispatch"],
                          "captured": tc["dispatch"]}}
    if not all(same.values()) or "n_round_replay" in te or \
            out["n_round_replay"] < 1:
        raise RuntimeError(f"the captured round differs from the eager "
                           f"round: {out}")
    st, g = [(st, g) for k, st in sc.internal_sampler._slice_rounds.items()
             if k[0] == "round" for g in st.graphs.values()
             if g.prologue is not None][-1]

    def epilogue():
        # the epilogue advances the round index: each replay writes the
        # dispatch's first round
        st.ridx.zero_()
        g.epilogue.replay()

    def host_ms(fn, n=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for part, fn in (("prologue", lambda: g.replay_prologue(gen)),
                     ("epilogue", epilogue)):
        out[f"{part}_device_ms"] = _device_ms(fn, 20)
        out[f"{part}_host_ms"] = host_ms(fn)
    print(f"captured-round balls/rslice nlive=2048 q=256: {out['rounds']} "
          f"rounds bit-identical eager and captured (generators, counts), "
          f"{out['n_round_replay']} replayed, {out['n_round_graph']} "
          f"captured; sync_round eager {out['sync_round']['eager']} "
          f"captured {out['sync_round']['captured']}; prologue replay "
          f"{out['prologue_device_ms']:.4f} ms device, "
          f"{out['prologue_host_ms']:.4f} ms host with its wait; epilogue "
          f"replay {out['epilogue_device_ms']:.4f} ms device, "
          f"{out['epilogue_host_ms']:.4f} ms host (each with the round "
          f"index's reset)  [{card}]")
    return out



def _cuda_t(a, dtype):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")


def step_slice_state(q, ndim, npdim, dtype, seed=SEED):
    """A hand-made state machine state and one iteration's inputs on the
    card: every phase, lanes done, intervals on both sides of 0, exp
    counts at the warning's 1000, likelihood values above, below and at
    the threshold, +-inf among them."""
    rs = np.random.Generator(np.random.PCG64(seed))
    lane = np.arange(q)
    i64 = torch.int64
    choice = [-math.inf, -1.0, STEP_LOGLSTAR, 1.0]
    st = {
        "s": _cuda_t(np.where(lane % 7 == 6, STEP_NSTEPS,
                              (lane // 5) % STEP_NSTEPS), i64),
        "phase": _cuda_t(lane % 5, i64),
        "left": _cuda_t(-rs.random(q) * 2.0, dtype),
        "right": _cuda_t(rs.random(q) * 2.0, dtype),
        "fl": _cuda_t(rs.choice(choice, size=q), dtype),
        "fr": _cuda_t(rs.choice(choice, size=q), dtype),
        "u": _cuda_t(rs.random((q, ndim)), dtype),
        "v": _cuda_t(rs.random((q, npdim)), dtype),
        "logl": _cuda_t(rs.normal(size=q), dtype),
        "u0": _cuda_t(rs.random((q, ndim)), dtype),
        "nc": _cuda_t(rs.integers(0, 50, q), i64),
        "n_exp": _cuda_t(rs.integers(0, 50, q), i64),
        "n_con": _cuda_t(rs.integers(0, 50, q), i64),
        "exp_step": _cuda_t(np.where(lane % 3 == 0, 1000,
                                     rs.integers(0, 999, q)), i64),
        "warn": _cuda_t(False, torch.bool),
        "any_active": _cuda_t(True, torch.bool)}
    inp = {
        "u_sh": _cuda_t(rs.random(q), dtype),
        "u_r0": _cuda_t(rs.random(q), dtype),
        "directions": _cuda_t(rs.normal(size=(q, STEP_NSTEPS, ndim)) * 0.3,
                              dtype),
        "logl_x": _cuda_t(rs.choice([-math.inf, -2.0, STEP_LOGLSTAR, 0.5,
                                     3.0, math.inf], size=q), dtype),
        "v_x": _cuda_t(rs.random((q, npdim)), dtype),
        "loglstar": _cuda_t(STEP_LOGLSTAR, dtype),
        "strict": _cuda_t(rs.random(ndim) < 0.7, torch.bool)}
    return st, inp


def step_rwalk_state(q, ndim, ncdim, npdim, dtype, masks, seed=SEED):
    """A hand-made walk state and one step's inputs on the card: step
    lengths from well inside the cube to well beyond it, likelihood
    values above, below and at the threshold, +-inf among them; with
    ``masks`` the first dimension wrapped, the second reflected, past 3-D
    the last both, every third loose."""
    rs = np.random.Generator(np.random.PCG64(seed))
    st = {"u": _cuda_t(rs.random((q, ndim)), dtype),
          "v": _cuda_t(rs.random((q, npdim)), dtype),
          "logl": _cuda_t(rs.normal(size=q), dtype),
          "n_acc": _cuda_t(rs.integers(0, 9, q), torch.int64),
          "n_rej": _cuda_t(rs.integers(0, 9, q), torch.int64)}

    def mask(idx):
        m = np.zeros(ndim, dtype=bool)
        m[idx] = True
        return _cuda_t(m, torch.bool)

    inp = {
        "du": _cuda_t(rs.normal(size=(q, ncdim)) *
                      np.geomspace(1e-3, 2.0, q)[:, None], dtype),
        "scale": _cuda_t(0.7, dtype),
        "u_ex": _cuda_t(rs.random((q, ndim - ncdim)), dtype)
        if ncdim < ndim else None,
        "masks": [mask([0] + [ndim - 1] * (ndim > 3)),
                  mask([1] + [ndim - 1] * (ndim > 3)),
                  _cuda_t(np.arange(ndim) % 3 != 2, torch.bool)]
        if masks else [None, None, None],
        "logl_prop": _cuda_t(rs.choice([-math.inf, -1.0, STEP_LOGLSTAR, 2.0,
                                        math.inf], size=q), dtype),
        "v_prop": _cuda_t(rs.random((q, npdim)), dtype),
        "loglstar": _cuda_t(STEP_LOGLSTAR, dtype)}
    return st, inp


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


def _bit_record(name, shape, dtype, pairs):
    """Bit-identical elements of each (output, kernel, plain) pair, and
    the largest absolute difference (0 where bit-identical)."""
    outputs, err = {}, 0.0
    for out, got, ref in pairs:
        if got.dtype.is_floating_point:
            same = (got == ref) | (got.isnan() & ref.isnan())
            diff = torch.where(same, 0.0, (got.double() - ref.double()).abs())
        else:
            same = got == ref
            diff = (got.long() - ref.long()).abs().double()
        outputs[out] = [int(same.sum()), same.numel()]
        if diff.numel():
            err = max(err, float(diff.max()))
    return {"kernel": name, "shape": list(shape),
            "dtype": str(dtype).replace("torch.", ""), "outputs": outputs,
            "identical": sum(o[0] for o in outputs.values()),
            "total": sum(o[1] for o in outputs.values()),
            "max_abs_err": err}


def _step_time(rec, kernel, plain, bound_bytes, bound_ops=0,
               op_rate=FP64_FLOPS):
    """Per-call µs (events, warm, through the wrapper) of the kernel and
    the plain version on the compared inputs, and the bound: the larger
    of the bytes over the memory rate and the operations (``bound_ops``,
    at ``op_rate`` a second) over the card's peak for their type."""
    rec["us"] = 1e3 * _time_ms(kernel, 200)
    rec["plain_us"] = 1e3 * _time_ms(plain, 50)
    by_us = 1e6 * bound_bytes / HBM_BYTES
    op_us = 1e6 * bound_ops / op_rate
    rec["bound_bytes"], rec["bound_ops"] = bound_bytes, bound_ops
    rec["bound_us"] = max(by_us, op_us)
    rec["bound_by"] = "operations" if op_us > by_us else "bytes"


def step_slice_round(st, inp):
    """A ``SliceRound`` on the card holding the hand-made state and one
    iteration's inputs."""
    q, n_steps, ndim = inp["directions"].shape
    rb = pr.SliceRound(q, n_steps, ndim, st["v"].shape[1],
                       inp["directions"].dtype, "cuda", inp["strict"])
    for k, t in st.items():
        rb.st[k].copy_(t)
    rb.directions.copy_(inp["directions"])
    rb.draws[0].copy_(inp["u_sh"])
    rb.draws[1].copy_(inp["u_r0"])
    rb.loglstar.copy_(inp["loglstar"])
    return rb


def slice_step_cases(ndim, dtype):
    """``slice_propose`` and ``slice_advance`` against their plain
    versions on one hand-made state; returns their records and the
    kernels' calls at these inputs."""
    q, npdim, n = STEP_Q, ndim, STEP_NSTEPS
    st, inp = step_slice_state(q, ndim, npdim, dtype)
    tb = torch.finfo(dtype).bits // 8
    args = (inp["u_sh"], inp["directions"], inp["strict"])
    rb_p = step_slice_round(st, inp)
    pr.slice_propose(rb_p)
    ref = pr.slice_propose_plain(_clone(st), *args)
    torch.cuda.synchronize()
    prop = _bit_record("slice_propose", (q, ndim), dtype,
                       zip(("x", "upos", "uclamp", "incube"),
                           (rb_p.x, rb_p.upos, rb_p.uclamp, rb_p.incube),
                           ref))
    if bool(rb_p.st["any_active"]):
        raise RuntimeError("slice_propose left any_active set")
    if torch.equal(ref[1], ref[2]):
        raise RuntimeError(f"the hand-made slice state clamps no point at "
                           f"ndim {ndim}")
    _step_time(prop, lambda: pr.slice_propose(rb_p),
               lambda: pr.slice_propose_plain(st, *args),
               q * (16 + 4 * tb + 4 * ndim * tb + 1) + ndim + 1)

    # slice_advance on the plain proposal and the raw likelihood values,
    # from the flag slice_propose leaves
    x, upos, _, incube = ref
    adv_args = (x, upos, incube, inp["v_x"], inp["logl_x"], inp["u_r0"],
                inp["loglstar"], n)

    def advance_round():
        r = step_slice_round(st, inp)
        r.x.copy_(x)
        r.upos.copy_(upos)
        r.incube.copy_(incube)
        r.st["any_active"].zero_()
        return r

    rb = advance_round()
    pr.slice_advance(rb, inp["v_x"], inp["logl_x"])
    st_p = _clone(st)
    acc_p = pr.slice_advance_plain(st_p, *adv_args)
    torch.cuda.synchronize()
    adv = _bit_record("slice_advance", (q, ndim), dtype,
                      [("acc", rb.acc, acc_p)] +
                      [(k, rb.st[k], st_p[k]) for k in sorted(st)])
    active = st["s"] < n
    shrink = active & (st["phase"] == 4)
    covered = (set(st["phase"][active].tolist()) == set(range(5)) and
               bool((~active).any()) and bool(acc_p.any()) and
               bool((shrink & ~acc_p).any()) and bool(st_p["warn"]) and
               bool((active & ~incube & torch.isfinite(inp["logl_x"]))
                    .any()))
    if not covered:
        raise RuntimeError(f"the hand-made slice state misses a phase or "
                           f"an outcome at ndim {ndim}")
    n_acc = int(acc_p.sum())
    rb_t = advance_round()
    _step_time(adv, lambda: pr.slice_advance(rb_t, inp["v_x"],
                                             inp["logl_x"]),
               lambda: pr.slice_advance_plain(dict(st), *adv_args),
               q * (96 + 11 * tb + 2) + tb + 2 +
               n_acc * (3 * ndim + 2 * npdim + 1) * tb)
    calls = {"slice_propose": lambda: pr.slice_propose(rb_p),
             "slice_advance": lambda: pr.slice_advance(rb_t, inp["v_x"],
                                                       inp["logl_x"])}
    return [prop, adv], calls


def step_rwalk_round(st, inp):
    """An ``RWalkRound`` on the card holding the hand-made state and one
    step's scale, threshold and masks."""
    q, ndim = st["u"].shape
    rb = pr.RWalkRound(q, ndim, inp["du"].shape[1], st["v"].shape[1],
                       inp["du"].dtype, "cuda", *inp["masks"])
    for k, t in st.items():
        rb.st[k].copy_(t)
    rb.scale.copy_(inp["scale"])
    rb.loglstar.copy_(inp["loglstar"])
    return rb


def rwalk_step_cases(ndim, ncdim, dtype, masks):
    """``rwalk_propose`` and ``rwalk_accept`` against their plain
    versions on one hand-made state; returns their records and the
    kernels' calls at these inputs."""
    q, npdim = STEP_Q, ndim
    st, inp = step_rwalk_state(q, ndim, ncdim, npdim, dtype, masks)
    tb = torch.finfo(dtype).bits // 8
    args = (inp["du"], inp["scale"], inp["u_ex"], *inp["masks"])
    draws = (inp["du"], inp["u_ex"])
    rb_p = step_rwalk_round(st, inp)
    pr.rwalk_propose(rb_p, *draws)
    ref = pr.rwalk_propose_plain(_clone(st), *args)
    torch.cuda.synchronize()
    prop = _bit_record("rwalk_propose", (q, ndim), dtype,
                       zip(("u_prop", "uclamp", "ok"),
                           (rb_p.u_prop, rb_p.uclamp, rb_p.ok), ref))
    prop["ncdim"], prop["masks"] = ncdim, masks
    if torch.equal(ref[0], ref[1]) and not (masks and ndim == 3):
        raise RuntimeError(f"the hand-made walk state clamps no point at "
                           f"ndim {ndim}")
    n_masks = sum(m is not None for m in inp["masks"])
    _step_time(prop, lambda: pr.rwalk_propose(rb_p, *draws),
               lambda: pr.rwalk_propose_plain(st, *args),
               q * ((ncdim + 3 * ndim) * tb + 1) + tb + n_masks * ndim)

    # rwalk_accept on the plain proposal and the raw likelihood values
    u_prop, _, ok = ref
    lk = (inp["v_prop"], inp["logl_prop"])

    def accept_round():
        r = step_rwalk_round(st, inp)
        r.u_prop.copy_(u_prop)
        r.ok.copy_(ok)
        return r

    rb = accept_round()
    pr.rwalk_accept(rb, *lk)
    st_p = _clone(st)
    acc_p = pr.rwalk_accept_plain(st_p, u_prop, ok, *lk, inp["loglstar"])
    torch.cuda.synchronize()
    accr = _bit_record("rwalk_accept", (q, ndim), dtype,
                       [("accept", rb.accept, acc_p)] +
                       [(k, rb.st[k], st_p[k]) for k in sorted(st)])
    accr["ncdim"], accr["masks"] = ncdim, masks
    if not (bool(ok.any()) and bool((~ok).any()) and bool(acc_p.any()) and
            bool((ok & ~acc_p).any()) and
            bool((~ok & torch.isfinite(inp["logl_prop"])).any())):
        raise RuntimeError(f"the hand-made walk state misses an outcome at "
                           f"ndim {ndim}")
    n_acc = int(acc_p.sum())
    rb_t = accept_round()
    _step_time(accr, lambda: pr.rwalk_accept(rb_t, *lk),
               lambda: pr.rwalk_accept_plain(dict(st), u_prop, ok, *lk,
                                             inp["loglstar"]),
               q * (tb + 34) + tb + n_acc * (2 * ndim + 2 * npdim + 1) * tb)
    calls = {"rwalk_propose": lambda: pr.rwalk_propose(rb_p, *draws),
             "rwalk_accept": lambda: pr.rwalk_accept(rb_t, *lk)}
    return [prop, accr], calls


def launch_floor():
    """The empty kernel of ``csrc/rwalk_step.cu`` at ``rwalk_propose``'s
    grid at the rwalk drive's shape (256 lanes of 16 threads at 15-D: 32
    blocks of 128), launched through the same ctypes entry and launch
    path: the floor a launch of these kernels costs on this card.
    Returns its call and its record, the per-call µs by events (its
    device-only time comes in the last phase)."""
    fn = pr._entry("rwalk_step", "rwalk_empty", "f64")
    table = pr._pointer_table((None,))
    dev = torch.device("cuda", torch.cuda.current_device())
    blocks = STEP_Q * 16 // 128

    def call():
        pr._run(fn, table, (blocks, 0, 0, 0), dev, "rwalk_empty")

    return call, {"blocks": blocks, "us": 1e3 * _time_ms(call, 200)}


def main_step(steps, name):
    """The record of kernel ``name`` at its main drive's shape in float64:
    the slice kernels at 3-D (balls), the walk's at 15-D without masks
    (rwalk)."""
    shape = (STEP_Q, NDIM) if name.startswith("slice") else (STEP_Q, R_NDIM)
    return next(c for c in steps if c["kernel"] == name and
                c["dtype"] == "float64" and tuple(c["shape"]) == shape and
                c.get("ncdim", R_NDIM) == R_NDIM and not c.get("masks"))


def proposal_steps_phase(card):
    """Every case in float64 and float32; prints one line each, raises
    unless every output is bit-identical, and returns the records and the
    kernels' calls at the main drives' shapes (float64: the slice kernels
    at 3-D, the walk's at 15-D)."""
    cases, main_calls = [], {}
    for loop, ndim, ncdim, masks in STEP_CASES:
        for dtype in (torch.float64, torch.float32):
            if loop == "slice":
                recs, calls = slice_step_cases(ndim, dtype)
            else:
                recs, calls = rwalk_step_cases(ndim, ncdim, dtype, masks)
            cases += recs
            if dtype == torch.float64 and (loop, ndim, ncdim, masks) in (
                    ("slice", NDIM, None, None),
                    ("rwalk", R_NDIM, R_NDIM, False)):
                main_calls.update(calls)
    for c in cases:
        shares = "  ".join(f"{k} {i}/{n}" for k, (i, n) in
                           c["outputs"].items())
        print(f"proposal step {c['kernel']} {tuple(c['shape'])}"
              + (f" ncdim {c['ncdim']}" if "ncdim" in c else "") +
              (" masks" if c.get("masks") else "") +
              f" {c['dtype']}: bit-identical {c['identical']}/"
              f"{c['total']} ({shares})  kernel {c['us']:.2f} us  plain "
              f"{c['plain_us']:.2f} us  bound {c['bound_us']:.5f} us "
              f"(bytes)  [{card}]")
    bad = [c for c in cases if c["identical"] != c["total"]]
    if bad:
        raise RuntimeError(f"proposal-step kernels differ from their plain "
                           f"versions: {bad}")
    print(f"proposal steps: {len(cases)} cases, outputs bit-identical "
          f"{sum(c['identical'] for c in cases)}/"
          f"{sum(c['total'] for c in cases)}  [{card}]")
    return cases, main_calls


def capture_loglike(x):
    """The balls drive's Gaussian with the blob ``(logl, v[0])``, in the
    points' dtype."""
    logl = -0.5 * (x @ _GAUSS["cinv"].to(x.dtype) @ x) + _GAUSS["lnorm"]
    return logl, torch.stack([logl, x[0]])


def _capture_like(eager, dtype):
    """The likelihood of the captured-slice phase; ``eager``: one that the
    capture rule keeps out of a graph, so that its rounds launch every
    iteration eagerly through the same two kernels (the reference a
    captured round is held against)."""
    from dynesty_tpu_torch.internal.likelihood import LogLikelihood
    like = LogLikelihood(capture_loglike, box_ptform, NDIM, device="cuda",
                         blob=True, dtype=dtype)
    if eager:
        like.capturable = lambda: False
    like.eval_host(np.full((2, NDIM), 0.5))
    return like


def _capture_rounds(like, kind, slices, q, dtype, seeds, cache, timings,
                    doubling=False):
    """``len(seeds)`` slice rounds of ``q`` lanes on one round cache (in
    the doubling form where ``doubling``): the balls drive's Gaussian with
    a blob, a ``nonperiodic`` (strict) mask with one loose dimension,
    starts around the peak above the round's threshold.  Returns each
    round's packed columns, blob and generator offset."""
    from dynesty_tpu_torch.internal import kernels as tk
    fn = tk.make_slice_round(like, ndim=NDIM, q=q, slices=slices, kind=kind,
                             dtype=dtype, device="cuda",
                             nonperiodic=[True, False, True],
                             doubling=doubling, timings=timings,
                             rounds=cache)
    outs = []
    for seed in seeds:
        rs = np.random.Generator(np.random.PCG64(seed))
        u = 0.5 + 0.02 * rs.standard_normal((q, NDIM))
        v, logl, blob = like.eval_host(u)
        axes = 0.04 * (np.eye(NDIM) + 0.2 * rs.standard_normal(
            (q, NDIM, NDIM)))
        packed = torch.as_tensor(np.concatenate(
            [u, v, logl[:, None], axes.reshape(q, -1)], axis=1),
            dtype=dtype, device="cuda")
        start_blob = torch.as_tensor(np.asarray(blob), device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        out, out_blob = fn(gen, packed, start_blob, 1.0,
                           float(logl.min() - 1.0))
        torch.cuda.synchronize()
        outs.append((out, out_blob, gen.get_offset()))
    return outs


def captured_slice_phase(card):
    """Captured rounds against eager-launched rounds on the same inputs:
    rslice and slice at their default slices, float64 and float32, the
    main width (256) and the narrow width (32), three rounds each on one
    round cache (the first warms up and captures, the others replay from
    their start), with a blob and a strict mask: every column, the blob
    and the generator's offset bit for bit.  Then, at the balls drive's
    shape (rslice, (256, 3), float64), the host time of one replay and its
    flag read against one eager iteration's, and CUDA events around
    back-to-back replays; the replay's device-only time comes in the last
    phase.  Returns the records and the timed graph."""
    from dynesty_tpu_torch.utils.misc import Timings
    _gauss_setup()
    cases, timed = [], None
    for kind, slices in (("rslice", NDIM + 3), ("slice", 3)):
        for dtype in (torch.float64, torch.float32):
            for q in (STEP_Q, 32):
                seeds = (SEED, SEED + 1, SEED + 2)
                tg, te, cache = Timings(), Timings(), {}
                got = _capture_rounds(_capture_like(False, dtype), kind,
                                      slices, q, dtype, seeds, cache, tg)
                ref = _capture_rounds(_capture_like(True, dtype), kind,
                                      slices, q, dtype, seeds, {}, te)
                same = {"packed": 0, "blob": 0, "offset": 0}
                for (p, b, off), (pe, be, offe) in zip(got, ref):
                    same["packed"] += int(_same_bits(
                        p.cpu().numpy(), pe.cpu().numpy()).all())
                    same["blob"] += int(_same_bits(
                        b.cpu().numpy(), be.cpu().numpy()).all())
                    same["offset"] += int(off == offe)
                iters = te["sync_slice"] - len(seeds)
                rec = {"kind": kind, "q": q, "ndim": NDIM,
                       "dtype": str(dtype).replace("torch.", ""),
                       "rounds": len(seeds), "same": same,
                       "iterations": iters,
                       "n_slice_replay": tg.get("n_slice_replay", 0),
                       "n_slice_graph": tg.get("n_slice_graph", 0),
                       "n_uncaptured": tg.get("n_uncaptured", 0),
                       "eager_uncaptured": te.get("n_uncaptured", 0)}
                cases.append(rec)
                ok = (all(v == len(seeds) for v in same.values()) and
                      rec["n_slice_graph"] == 1 and
                      rec["n_uncaptured"] == 0 and
                      rec["n_slice_replay"] + 1 == iters and
                      rec["eager_uncaptured"] == len(seeds) and
                      tg["sync_slice"] == te["sync_slice"])
                if not ok:
                    raise RuntimeError(f"a captured slice round differs from "
                                       f"the eager-launched one: {rec}")
                if (kind, dtype, q) == ("rslice", torch.float64, STEP_Q):
                    timed = next(iter(cache.values()))
                print(f"captured-slice {kind} q {q} {rec['dtype']}: "
                      f"{len(seeds)} rounds bit-identical (columns, blob, "
                      f"generator offset), iterations {iters} = replays "
                      f"{rec['n_slice_replay']} + warm-up 1  [{card}]")
    # the host's cost of an iteration, replayed and eager, at the balls
    # drive's shape: each call waits for the device and reads the flag
    eager, cache = _capture_like(True, torch.float64), {}
    _capture_rounds(eager, "rslice", NDIM + 3, STEP_Q, torch.float64,
                    (SEED,), cache, Timings())
    eager_entry = next(iter(cache.values()))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def eager_iteration():
        eager_entry.iterate(
            lambda: eager_entry.rb.draws.uniform_(generator=gen))
        return bool(eager_entry.rb.st["any_active"])

    def host_us(fn, n=200):
        for _ in range(5):
            fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e6 * (time.perf_counter() - t0) / n

    timing = {"shape": [STEP_Q, NDIM], "kind": "rslice", "dtype": "float64",
              "replay_host_us": host_us(timed.replay),
              "eager_iteration_host_us": host_us(eager_iteration),
              "replay_events_us": 1e3 * _time_ms(timed.graph.replay, 200),
              "eager_iteration_events_us": 1e3 * _time_ms(
                  lambda: eager_entry.iterate(
                      lambda: eager_entry.rb.draws.uniform_(generator=gen)),
                  200)}
    print(f"captured-slice (256, 3) float64: one iteration, host time with "
          f"its wait and flag read: replay {timing['replay_host_us']:.2f} "
          f"us, eager {timing['eager_iteration_host_us']:.2f} us; events "
          f"(back to back): replay {timing['replay_events_us']:.2f} us, "
          f"eager {timing['eager_iteration_events_us']:.2f} us  [{card}]")
    print(json.dumps({"phase": "captured-slice", "card": card,
                      "cases": cases, "timing": timing}))
    return {"cases": cases, "timing": timing}, timed


# (ndim, ncdim, masks) of the captured-rwalk phase: the rwalk drive's
# shape, and 12 of its 15 dimensions bounded with periodic, reflective and
# loose dimensions among them
RWALK_CAPTURE_CASES = [(R_NDIM, R_NDIM, False), (R_NDIM, 12, True)]


def rwalk_capture_loglike(x):
    """The rwalk drive's 15-D standard normal with the blob ``(logl,
    v[0])``."""
    logl = normal_loglike(x)
    return logl, torch.stack([logl, x[0]])


def _rwalk_capture_like(eager, dtype):
    """The likelihood of the captured-rwalk phase; ``eager``: one that the
    capture rule keeps out of a graph, so that its rounds launch every
    step eagerly through the same two kernels."""
    from dynesty_tpu_torch.internal.likelihood import LogLikelihood
    like = LogLikelihood(rwalk_capture_loglike, box_ptform, R_NDIM,
                         device="cuda", blob=True, dtype=dtype)
    if eager:
        like.capturable = lambda: False
    like.eval_host(np.full((2, R_NDIM), 0.5))
    return like


def _rwalk_mask_kw(ndim, masks):
    if not masks:
        return {}
    return {"periodic": [0, ndim - 1], "reflective": [1, ndim - 1],
            "nonbounded": list(np.arange(ndim) % 3 != 2)}


def _capture_walks(like, q, ncdim, masks, dtype, seeds, cache, timings):
    """``len(seeds)`` walk rounds of ``q`` lanes on one round cache: starts
    across the cube (steps leave it), a threshold at the starts' 30 %
    quantile.  Returns each round's packed columns, blob and generator
    offset."""
    from dynesty_tpu_torch.internal import kernels as tk
    fn = tk.make_rwalk_round(like, ndim=R_NDIM, ncdim=ncdim, q=q,
                             walks=R_NDIM + 20, dtype=dtype, device="cuda",
                             timings=timings, rounds=cache,
                             **_rwalk_mask_kw(R_NDIM, masks))
    outs = []
    for seed in seeds:
        rs = np.random.Generator(np.random.PCG64(seed))
        u = rs.uniform(0.02, 0.98, (q, R_NDIM))
        v, logl, blob = like.eval_host(u)
        axes = 0.05 * (np.eye(ncdim) + 0.2 * rs.standard_normal(
            (q, ncdim, ncdim)))
        packed = torch.as_tensor(np.concatenate(
            [u, v, logl[:, None], axes.reshape(q, -1)], axis=1),
            dtype=dtype, device="cuda")
        start_blob = torch.as_tensor(np.asarray(blob), device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        out, out_blob = fn(gen, packed, start_blob, 1.0,
                           float(np.quantile(logl, 0.3)))
        torch.cuda.synchronize()
        outs.append((out, out_blob, gen.get_offset()))
    return outs


def _propose_round_pair(dyt):
    """One non-fused ``propose_round`` (the round of batch seeding) on the
    card, captured against eager: two samplers over the 15-D normal, one
    whose likelihood the capture rule keeps out, run alike to 3,000
    iterations (their records bit for bit), then three rounds of 32 lanes
    each from the same threshold and generator seeds."""
    out = {}
    samplers = []
    for eager in (False, True):
        s = dyt.NestedSampler(normal_loglike, box_ptform, R_NDIM, nlive=500,
                              queue_size=64,
                              rstate=np.random.Generator(np.random.PCG64(SEED)))
        if eager:
            s.loglikelihood.capturable = lambda: False
        s.run_nested(print_progress=False, maxiter=3000, add_live=False)
        if s.internal_sampler.name != "rwalk":
            raise RuntimeError(f"the propose_round sampler runs "
                               f"{s.internal_sampler.name}, not rwalk")
        samplers.append(s)
    res = [s.results for s in samplers]
    out["runs_same"] = all(
        _same_bits(np.asarray(getattr(res[0], k)),
                   np.asarray(getattr(res[1], k))).all()
        for k in ("logl", "samples_u", "samples"))
    loglstar = float(np.quantile(samplers[0].live_logl, 0.2))
    rows = []
    for s in samplers:
        t0 = {k: s.timings.get(k, 0) for k in CAPTURE_COUNTS}
        got = []
        for seed in (SEED, SEED + 1, SEED + 2):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            r, tuning = s.internal_sampler.propose_round(s, loglstar, 32, gen)
            got.append((np.array([[*x["u"], *x["v"], x["logl"], x["nc"],
                                   x["proposal_stats"]["n_accept"]]
                                  for x in r]), tuning, gen.get_offset()))
        rows.append(got)
        out["eager" if s is samplers[1] else "captured"] = {
            k: s.timings.get(k, 0) - t0[k] for k in CAPTURE_COUNTS}
    out["rounds_same"] = sum(
        int(_same_bits(a[0], b[0]).all() and a[1] == b[1] and a[2] == b[2])
        for a, b in zip(*rows))
    return out


def captured_rwalk_phase(card, dyt):
    """Captured random-walk rounds against eager-launched rounds on the
    same inputs: float64 and float32, the main width (256) and the narrow
    width (32), the rwalk drive's shape and 12 of 15 dimensions bounded
    with masks, three rounds each on one round cache (the first warms up,
    the second captures and replays, the third replays), with a blob:
    every column, the blob and the generator's offset bit for bit.  Then
    the non-fused ``propose_round`` (:func:`_propose_round_pair`).
    Returns the records."""
    from dynesty_tpu_torch.utils.misc import Timings
    cases = []
    seeds = (SEED, SEED + 1, SEED + 2)
    for dtype in (torch.float64, torch.float32):
        for q in (STEP_Q, 32):
            for ndim, ncdim, masks in RWALK_CAPTURE_CASES:
                tg, te = Timings(), Timings()
                got = _capture_walks(_rwalk_capture_like(False, dtype), q,
                                     ncdim, masks, dtype, seeds, {}, tg)
                ref = _capture_walks(_rwalk_capture_like(True, dtype), q,
                                     ncdim, masks, dtype, seeds, {}, te)
                same = {"packed": 0, "blob": 0, "offset": 0}
                moved = 0
                for (p, b, off), (pe, be, offe) in zip(got, ref):
                    same["packed"] += int(_same_bits(
                        p.cpu().numpy(), pe.cpu().numpy()).all())
                    same["blob"] += int(_same_bits(
                        b.cpu().numpy(), be.cpu().numpy()).all())
                    same["offset"] += int(off == offe)
                    n_acc = int(pe[:, 2 * ndim + 1].sum())
                    moved += int(0 < n_acc < q * (R_NDIM + 20))
                rec = {"q": q, "ndim": ndim, "ncdim": ncdim, "masks": masks,
                       "dtype": str(dtype).replace("torch.", ""),
                       "rounds": len(seeds), "same": same,
                       "moved_and_rejected": moved,
                       "n_rwalk_replay": tg.get("n_rwalk_replay", 0),
                       "n_rwalk_graph": tg.get("n_rwalk_graph", 0),
                       "n_uncaptured": tg.get("n_uncaptured", 0),
                       "eager_uncaptured": te.get("n_uncaptured", 0)}
                cases.append(rec)
                ok = (all(v == len(seeds) for v in same.values()) and
                      moved == len(seeds) and rec["n_rwalk_graph"] == 1 and
                      rec["n_uncaptured"] == 1 and
                      rec["n_rwalk_replay"] == len(seeds) - 1 and
                      rec["eager_uncaptured"] == len(seeds))
                if not ok:
                    raise RuntimeError(f"a captured walk round differs from "
                                       f"the eager-launched one: {rec}")
                print(f"captured-rwalk q {q} ({ndim}, {ncdim})"
                      f"{' masks' if masks else ''} {rec['dtype']}: "
                      f"{len(seeds)} rounds bit-identical (columns, blob, "
                      f"generator offset), replays {rec['n_rwalk_replay']} + "
                      f"warm-up 1  [{card}]")
    pair = _propose_round_pair(dyt)
    ok = (pair["runs_same"] and pair["rounds_same"] == 3 and
          pair["captured"]["n_rwalk_replay"] == 2 and
          pair["captured"]["n_rwalk_graph"] == 1 and
          pair["captured"]["n_uncaptured"] == 1 and
          pair["eager"]["n_uncaptured"] == 3)
    if not ok:
        raise RuntimeError(f"the non-fused rwalk round differs from its eager "
                           f"form: {pair}")
    print(f"captured-rwalk propose_round q 32: 3 rounds bit-identical to the "
          f"eager sampler's (rows, tuning, generator offset), the two runs "
          f"before them bit-identical, replays "
          f"{pair['captured']['n_rwalk_replay']} + warm-up 1  [{card}]")
    print(json.dumps({"phase": "captured-rwalk", "card": card,
                      "cases": cases, "propose_round": pair}))
    return {"cases": cases, "propose_round": pair}


# --------------------------------------------------------------------------
# the uniform wave's kernels against their plain versions, and the captured
# wave


# (kind, ndim, ncdim, q) of the wave kernels' cases: the cube's wave of
# every drive's unit-cube phase and the heavy drive's ellipsoid wave at
# (256, 3), a friends' wave, the narrow width (32) over ellipsoids in 3 of
# 4 dimensions, and 700 lanes (three chunks of unif_place's block)
# the friends' bounds, and the balls-unif and cubes-unif drives' live
# points (the friends' centres)
FRIENDS = ("balls", "cubes")
FRIENDS_NLIVE = 2048
# the friends' cases of phase 2f: (centres, ncdim) at q 256
FRIENDS_CASES = ((FRIENDS_NLIVE, 3), (16384, 3), (FRIENDS_NLIVE, 15))
UNIF_CASES = [("cube", 3, 3, STEP_Q), ("ellipsoids", 3, 3, STEP_Q),
              ("balls", 3, 3, STEP_Q), ("ellipsoids", 4, 3, 32),
              ("cube", 3, 3, 700)]


def unif_arrays(kind, ncdim, dtype, seed=SEED, nctrs=FRIENDS_NLIVE):
    """A bound's device arrays for the wave cases: three ellipsoids around
    the 3-D Gaussian's mass in the cube (padded to four slots, one
    reaching past the cube), or ``nctrs`` live points in [0.2, 0.8]^n as
    friends' centres (balls or cubes), their axes symmetric (a sqrtm, as
    the friends' fit gives) and sized so that a candidate lies in ~2.5 of
    them on average."""
    from dynesty_tpu_torch.bounding import MultiEllipsoid
    from dynesty_tpu_torch.utils.convert import bound_arrays_to_torch
    rs = np.random.Generator(np.random.PCG64(seed))
    if kind == "ellipsoids":
        ctrs = np.array([[0.45, 0.45, 0.5], [0.55, 0.55, 0.5],
                         [0.9, 0.5, 0.5]])[:, :ncdim]
        covs = np.array([np.diag(rs.uniform(0.002, 0.01, ncdim))
                         for _ in ctrs])
        return bound_arrays_to_torch(kind, MultiEllipsoid(
            ncdim, ctrs=ctrs, covs=covs).device_spec()[1], "cuda", dtype)
    if kind in FRIENDS:
        a = rs.normal(size=(ncdim, ncdim))
        w, vec = np.linalg.eigh(np.eye(ncdim) + 0.1 * (a + a.T))
        unit = math.pi ** (ncdim / 2) / math.gamma(ncdim / 2 + 1)
        if kind == "cubes":
            unit = 2.0 ** ncdim
        r = 0.6 * (2.5 / (nctrs * unit)) ** (1.0 / ncdim)
        axes = (vec * np.sqrt(np.abs(w))) @ vec.T * r
        return {k: torch.as_tensor(v, dtype=dtype, device="cuda")
                for k, v in (("ctrs", rs.uniform(0.2, 0.8, (nctrs, ncdim))),
                             ("axes", axes),
                             ("axes_inv", np.linalg.inv(axes)))}
    return {}


def _unif_round(kind, q, ndim, ncdim, dtype, strict, arrays):
    """A ``UnifRound`` on the card over ``arrays`` (a checkout before the
    friends' kernel takes no friends kind: ``bench_kernels.py --root``)."""
    layout = {k: (tuple(arrays[k].shape), arrays[k].stride(),
                  arrays[k].storage_offset(), arrays[k].dtype)
              for k in pr.UNIF_ARRAYS[kind]}
    friends = (kind,) if kind in FRIENDS and hasattr(pr, "UNIF_FRIENDS") \
        else ()
    return pr.UnifRound(q, ndim, ncdim, ndim, dtype, "cuda", strict, layout,
                        *friends)


def friends_draws(rb, seed):
    """A friends wave's draws on the round ``rb``: offsets in and about
    the unit ball or cube, each lane's centre and its acceptance
    uniform."""
    rs = np.random.Generator(np.random.PCG64(seed))
    q, nctrs = rb.q, rb.arrays["ctrs"].shape[0]
    return {"uc": _cuda_t(rs.uniform(-1.1, 1.1, (q, rb.ncdim)), rb.dtype),
            "ua": _cuda_t(rs.random(q), rb.dtype),
            "idx": _cuda_t(rs.integers(0, nctrs, q), torch.int64)}


def unif_wave_round(kind, q, ndim, ncdim, dtype, situation):
    """A ``UnifRound`` on the card in a hand-made state and one wave's
    inputs: candidates in and out of the cube (one loose dimension; over
    ellipsoids half of them about the centres), the other dimensions'
    uniforms (NaN and values outside the cube among them), the acceptance
    draws, and a likelihood that leaves more successes than free slots
    (``situation`` 'overflow') or none ('none', the wave's evaluations
    carried)."""
    rs = np.random.Generator(np.random.PCG64(SEED + q + ndim))
    arrays = unif_arrays(kind, ncdim, dtype)
    strict = torch.tensor([True, False, True][:ncdim])
    rb = _unif_round(kind, q, ndim, ncdim, dtype, strict, arrays)
    rb.start(STEP_LOGLSTAR, arrays, 1 << 30)
    filled = q - 2 if situation == "overflow" else q // 3
    rb.state.copy_(torch.tensor([filled, 3, 40, 3 * q, 7, q - 9, 1 << 30]))
    m = rb.m
    above = situation == "overflow"
    uc = rs.uniform(-0.1, 1.1, (q, ncdim))
    if m:
        near = np.arange(q) % 2 == 0
        ctrs = arrays["ctrs"].cpu().numpy()
        uc[near] = ctrs[np.arange(q)[near] % 3] + \
            rs.normal(0.0, 0.06, (int(near.sum()), ncdim))
    inp = {"uc": _cuda_t(uc, dtype),
           "ua": _cuda_t(rs.random(q), dtype) if m else None, "idx": None,
           "u_ex": _cuda_t(rs.choice([math.nan, -0.2, 0.0, 0.4, 1.0, 1.3],
                                     size=(q, ndim - ncdim)), dtype)
           if ndim > ncdim else None,
           "u_prop": _cuda_t(rs.random((q, ndim)), dtype),
           "v": _cuda_t(rs.random((q, ndim)), dtype),
           "logl": _cuda_t(rs.choice([-math.inf, -1.0, 0.5, 2.0], size=q)
                           if above else rs.uniform(-3.0, 0.2, q), dtype)}
    if kind in FRIENDS:
        inp.update(friends_draws(rb, SEED + 3 * q + ndim))
    return rb, inp


def unif_valid_bound(rb, inp, kind):
    """The bytes ``unif_valid`` must move (each input read once -- the
    candidates or the friends' offsets, the other dimensions, ua and the
    friends' centre indices, the union's centres, matrices and mask or
    the friends' centres and two axes matrices, the cube check's mask,
    the width -- and its outputs written once: valid, the likelihood's
    input and its clamp) and the floating-point operations of the
    quadratic forms in the valid slots (2 n^2 + 2 n - 1 a form) or of the
    friends' distances of the lanes that need them (:func:`friends_lanes`;
    2 n^2 + 2 n a lane and centre: the n differences, the map's n^2
    products and n (n - 1) sums, and over balls the squares, their sums
    and the root (which the kernel replaces by a threshold on the
    square), over cubes the n magnitudes and their n - 1 maxima; the
    candidate's own 2 n^2 a lane left out)."""
    q, ndim, n, m = rb.q, rb.ndim, rb.ncdim, rb.m
    tb = torch.finfo(rb.dtype).bits // 8
    m_valid = int(rb.arrays["mask"].sum()) if m else 0
    nctrs = rb.arrays["ctrs"].shape[0] if kind in FRIENDS else 0
    by = q * ndim * tb + (q * tb if m else 0) + \
        m * (n + n * n) * tb + m + n + 8 + q + 2 * q * ndim * tb
    ops = q * m_valid * (2 * n * n + 2 * n - 1)
    if nctrs:
        by += q * tb + q * 8 + nctrs * n * tb + 2 * n * n * tb
        ops = friends_lanes(rb, inp) * nctrs * (2 * n * n + 2 * n)
    return by, ops, FP64_FLOPS if rb.dtype == torch.float64 else FP32_FLOPS


def friends_lanes(rb, inp):
    """The lanes of a friends wave whose distances its outputs need: those
    below the width whose candidate (:func:`pr.friends_union_plain`'s) is
    in the cube; any other lane's flag is false whatever its count, and
    the kernel counts nothing for it."""
    x, _ = pr.friends_union_plain(rb.friends, inp["idx"], inp["uc"],
                                  inp["ua"], *(rb.arrays[k]
                                               for k in pr.UNIF_FRIENDS))
    lanes = torch.arange(rb.q, device=x.device) < rb.state[pr.U_WIDTH]
    return int((lanes & unitcheck_batch(x, rb.strict)).sum())


def unif_valid_refs(rb, inp):
    """``unif_valid``'s plain outputs on the round's inputs: valid, the
    likelihood's input and its clamp."""
    return pr.unif_valid_round_plain(rb, inp["uc"], inp["ua"], inp["idx"],
                                     inp["u_ex"])


def unif_draws(inp):
    """A wave's draws as ``unif_valid`` takes them."""
    return (inp["uc"], inp["ua"], inp["idx"], inp["u_ex"])


def unif_wave_cases(ncase, dtype):
    """``unif_valid`` and ``unif_place`` against their plain versions on
    the case's two hand-made states; returns their records and the
    kernels' calls at the overflow state."""
    kind, ndim, ncdim, q = ncase
    tb = torch.finfo(dtype).bits // 8
    recs, calls = [], {}
    for situation in ("overflow", "none"):
        rb, inp = unif_wave_round(kind, q, ndim, ncdim, dtype, situation)
        draws = unif_draws(inp)
        ref, ref_u, ref_c = unif_valid_refs(rb, inp)
        pr.unif_valid(rb, *draws)
        torch.cuda.synchronize()
        valid = _bit_record("unif_valid", (q, ncdim), dtype,
                            [("valid", rb.valid, ref),
                             ("u_prop", rb.u_prop, ref_u),
                             ("uclamp", rb.uclamp, ref_c)])
        valid["m"] = rb.m
        n_valid = int(ref.sum())
        if rb.m and not 0 < n_valid < q:
            raise RuntimeError(f"the ellipsoid wave case missed its "
                               f"outcome at {ncase}: {n_valid} valid")
        st0, slots = rb.state.clone(), _clone(rb.slots)
        st, dest, done = pr.unif_place_plain(st0, slots, rb.valid,
                                             inp["u_prop"], inp["v"],
                                             inp["logl"], rb.loglstar)
        pr.unif_place(rb, inp["u_prop"], inp["v"], inp["logl"])
        torch.cuda.synchronize()
        place = _bit_record("unif_place", (q, ndim), dtype, [
            ("state", rb.state, st), ("dest", rb.dest, dest),
            ("done", rb.done, done)] + [
            (k, rb.slots[k][:q], slots[k][:q]) for k in slots])
        n_new = int(st[pr.U_FILLED] - st0[pr.U_FILLED])
        if situation == "overflow" and not (
                n_new == 2 and bool(done) and int((dest < q).sum()) == 2 and
                int(((dest == q) & rb.valid & (inp["logl"] > STEP_LOGLSTAR))
                    .sum()) > 0 and 0 < n_valid < q):
            raise RuntimeError(f"the overflow wave case missed its outcome "
                               f"at {ncase}: {n_new} placed")
        if situation == "none" and not (
                n_new == 0 and int(st[pr.U_PENDING]) == 7 + n_valid):
            raise RuntimeError(f"the no-success wave case missed its "
                               f"outcome at {ncase}")
        for rec in (valid, place):
            rec.update(kind=kind, ncdim=ncdim, situation=situation)
        # the bounds of this data: each input read once, each output
        # written once (unif_valid: and the forms' operations;
        # unif_place: the valid lanes' logl, the placed rows, dest and the
        # state)
        _step_time(valid, lambda: pr.unif_valid(rb, *draws),
                   lambda: unif_valid_refs(rb, inp),
                   *unif_valid_bound(rb, inp, kind))
        if situation == "overflow":
            # each timed call from the compared state: the state's restore
            # is timed alone and taken off
            def place_call():
                rb.state.copy_(st0)
                pr.unif_place(rb, inp["u_prop"], inp["v"], inp["logl"])

            restore_us = 1e3 * _time_ms(lambda: rb.state.copy_(st0), 200)
            _step_time(place, place_call,
                       lambda: pr.unif_place_plain(
                           st0, slots, rb.valid, inp["u_prop"], inp["v"],
                           inp["logl"], rb.loglstar),
                       q + n_valid * tb + tb + 2 * 7 * 8 + 1 + q * 8 +
                       n_new * ((2 * ndim + 2 * ndim + 1) * tb + 8))
            place["us"] = max(place["us"] - restore_us, 0.0)
            place["restore_us"] = restore_us
            calls = {"unif_valid": lambda: pr.unif_valid(rb, *draws),
                     "unif_place": place_call}
        recs += [valid, place]
    return recs, calls


# the padded slot counts of the unions whose lane checks are timed at
# (256, 3)
UNION_SLOTS = (1, 4, 16)
# unif_valid's calls on those unions in float64, timed device-only in
# phase 34 (unif_union_cases)
_UNION_CALLS = {}


def union_arrays(m, dtype, seed=SEED):
    """``m`` ellipsoids (a power of two: no padded slot) about the 3-D
    Gaussian's mass in the cube, overlapping."""
    from dynesty_tpu_torch.bounding import MultiEllipsoid
    from dynesty_tpu_torch.utils.convert import bound_arrays_to_torch
    rs = np.random.Generator(np.random.PCG64(seed + m))
    ctrs = 0.5 + rs.uniform(-0.12, 0.12, (m, NDIM))
    covs = np.array([np.diag(rs.uniform(0.002, 0.01, NDIM))
                     for _ in range(m)])
    return bound_arrays_to_torch("ellipsoids", MultiEllipsoid(
        NDIM, ctrs=ctrs, covs=covs).device_spec()[1], "cuda", dtype)


def unif_union_cases(dtype):
    """``unif_valid`` against its plain version over unions of 1, 4 and 16
    ellipsoids at (256, 3), half the candidates about the centres; returns
    the records (with times and bound) and fills ``_UNION_CALLS`` in
    float64."""
    recs = []
    for m in UNION_SLOTS:
        rs = np.random.Generator(np.random.PCG64(SEED + 7 * m))
        arrays = union_arrays(m, dtype)
        layout = {k: (tuple(arrays[k].shape), arrays[k].stride(),
                      arrays[k].storage_offset(), arrays[k].dtype)
                  for k in pr.UNIF_ARRAYS["ellipsoids"]}
        q = STEP_Q
        rb = pr.UnifRound(q, NDIM, NDIM, NDIM, dtype, "cuda", None, layout)
        rb.start(STEP_LOGLSTAR, arrays, 1 << 30)
        if rb.m != m:
            raise RuntimeError(f"a union of {m} ellipsoids took {rb.m} "
                               f"slots")
        uc = rs.uniform(0.0, 1.0, (q, NDIM))
        ctrs = arrays["ctrs"].cpu().numpy()
        near = np.arange(q) % 2 == 0
        uc[near] = ctrs[np.arange(q)[near] % m] + \
            rs.normal(0.0, 0.05, (int(near.sum()), NDIM))
        inp = {"uc": _cuda_t(uc, dtype), "ua": _cuda_t(rs.random(q), dtype),
               "idx": None, "u_ex": None}
        draws = (inp["uc"], inp["ua"], None, None)
        ref, ref_u, ref_c = unif_valid_refs(rb, inp)
        pr.unif_valid(rb, *draws)
        torch.cuda.synchronize()
        rec = _bit_record("unif_valid", (q, NDIM), dtype,
                          [("valid", rb.valid, ref),
                           ("u_prop", rb.u_prop, ref_u),
                           ("uclamp", rb.uclamp, ref_c)])
        rec.update(kind="ellipsoids", ncdim=NDIM, m=m, situation="union")
        if not 0 < int(ref.sum()) < q:
            raise RuntimeError(f"the union of {m} ellipsoids missed its "
                               f"outcome: {int(ref.sum())} valid")

        def call(rb=rb, draws=draws):
            pr.unif_valid(rb, *draws)

        _step_time(rec, call, lambda: unif_valid_refs(rb, inp),
                   *unif_valid_bound(rb, inp, "ellipsoids"))
        if dtype == torch.float64:
            _UNION_CALLS[m] = call
        recs.append(rec)
    return recs


# unif_valid's calls on the friends' cases by (kind, centres, ncdim,
# dtype), timed device-only in phase 34 (unif_friends_cases)
_FRIENDS_CALLS = {}
# the widths phase 2f narrows a friends wave of q 256 to, and the launches
# and replays of its repeat case
FRIENDS_WIDTHS = (0, 1, 37, STEP_Q - 1)
FRIENDS_REPEATS = 20


def friends_case_round(kind, nctrs, n, dtype):
    """A round over ``kind`` about ``nctrs`` centres in ``n`` of ``n + 1``
    dimensions at q 256 (a loose dimension, one outside the bound) and
    one wave's draws, as phase 2f's friends cases and ``bench_kernels.py``
    make them."""
    arrays = unif_arrays(kind, n, dtype, SEED + n, nctrs)
    strict = torch.ones(n, dtype=torch.bool)
    strict[1] = False
    rb = _unif_round(kind, STEP_Q, n + 1, n, dtype, strict, arrays)
    rb.start(STEP_LOGLSTAR, arrays, 1 << 30)
    inp = friends_draws(rb, SEED + nctrs + n)
    inp["u_ex"] = _cuda_t(np.random.Generator(np.random.PCG64(
        SEED + n)).uniform(-0.2, 1.2, (STEP_Q, 1)), dtype)
    return rb, inp


def _friends_record(rb, refs, dtype, **what):
    """The bit record of ``unif_valid``'s friends outputs on ``rb``
    against ``refs``, with its counts held to zero."""
    ref, ref_u, ref_c = refs
    rec = _bit_record("unif_valid", (rb.q, rb.ncdim), dtype, [
        ("valid", rb.valid, ref), ("u_prop", rb.u_prop, ref_u),
        ("uclamp", rb.uclamp, ref_c),
        ("counts", rb.counts, torch.zeros_like(rb.counts))])
    rec.update(kind=rb.friends, ncdim=rb.ncdim, nctrs=rb.nctrs,
               chunks=rb.geometry.chunks, per=rb.geometry.per, **what)
    return rec


def unif_friends_cases(dtype):
    """``unif_valid``'s friends mode against its plain version at q 256 over
    balls and cubes about ``FRIENDS_CASES``' centres, with a loose
    dimension and one dimension outside the bound; returns the records
    (with times, the lanes whose distances the outputs need, the bound
    and the fp64 or fp32 issue bound: twice the operations' time, as no
    FMA is allowed) and fills ``_FRIENDS_CALLS``."""
    recs = []
    for kind in FRIENDS:
        for nctrs, n in FRIENDS_CASES:
            rb, inp = friends_case_round(kind, nctrs, n, dtype)
            draws = unif_draws(inp)
            ref = unif_valid_refs(rb, inp)
            pr.unif_valid(rb, *draws)
            torch.cuda.synchronize()
            rec = _friends_record(rb, ref, dtype, situation="friends")
            if not 0 < int(ref[0].sum()) < STEP_Q:
                raise RuntimeError(f"the friends case {kind} {nctrs} {n} "
                                   f"missed its outcome: "
                                   f"{int(ref[0].sum())} valid")

            def call(rb=rb, draws=draws):
                pr.unif_valid(rb, *draws)

            bound = unif_valid_bound(rb, inp, kind)
            _step_time(rec, call, lambda: unif_valid_refs(rb, inp), *bound)
            rec["lanes"] = friends_lanes(rb, inp)
            rec["issue_bound_us"] = 2e6 * bound[1] / bound[2]
            _FRIENDS_CALLS[(kind, nctrs, n, rec["dtype"])] = call
            recs.append(rec)
    return recs


def friends_width_cases(dtype):
    """``unif_valid``'s friends mode at the drives' shape (q 256, 2048
    centres in 3-D) narrowed to each of ``FRIENDS_WIDTHS``: bit for bit
    with the plain version, the lanes past the width invalid; returns the
    records."""
    recs = []
    for kind in FRIENDS:
        for width in FRIENDS_WIDTHS:
            rb, inp = friends_case_round(kind, FRIENDS_NLIVE, NDIM, dtype)
            rb.state[pr.U_WIDTH] = width
            ref = unif_valid_refs(rb, inp)
            rb.valid.fill_(True)
            pr.unif_valid(rb, *unif_draws(inp))
            torch.cuda.synchronize()
            recs.append(_friends_record(rb, ref, dtype,
                                        situation=f"width {width}"))
            if bool(rb.valid[width:].any()) or \
                    width > 1 and not bool(rb.valid.any()):
                raise RuntimeError(f"the friends wave narrowed to {width} "
                                   f"lanes missed its outcome over {kind}")
    return recs


def friends_repeat_case(kind, dtype):
    """``FRIENDS_REPEATS`` launches of ``unif_valid``'s friends mode back
    to back, then as many replays of a captured launch, at the drives'
    shape: each (its outputs poisoned before it) bit for bit with the
    plain version, its counts zero after it.  Returns one
    record over all of them."""
    rb, inp = friends_case_round(kind, FRIENDS_NLIVE, NDIM, dtype)
    draws = unif_draws(inp)
    ref = unif_valid_refs(rb, inp)

    def checked(run):
        rb.valid.fill_(True)
        rb.u_prop.fill_(-7.0)
        rb.uclamp.fill_(-7.0)
        run()
        torch.cuda.synchronize()
        return _friends_record(rb, ref, dtype, situation="repeats")

    recs = [checked(lambda: pr.unif_valid(rb, *draws))
            for _ in range(FRIENDS_REPEATS)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pr.unif_valid(rb, *draws)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        pr.unif_valid(rb, *draws)
    recs += [checked(graph.replay) for _ in range(FRIENDS_REPEATS)]
    rec = recs[0]
    for out in rec["outputs"]:
        rec["outputs"][out] = [sum(r["outputs"][out][i] for r in recs)
                               for i in (0, 1)]
    rec["identical"] = sum(r["identical"] for r in recs)
    rec["total"] = sum(r["total"] for r in recs)
    rec["max_abs_err"] = max(r["max_abs_err"] for r in recs)
    rec["situation"] = f"{FRIENDS_REPEATS} launches, {FRIENDS_REPEATS} " \
        f"replays"
    return rec


def friends_threshold_case(kind, dtype):
    """``unif_valid``'s friends mode against its plain version on draws
    whose distances lie exactly at the thresholds: eight lane kinds, each
    candidate at its own centre (offset 0) with a second centre ``d``
    away in the bound's units (the inverse axes 16 I; the kinds 1.75
    apart there; every coordinate and difference exact in either dtype):
    ``d`` along the first axis the largest float below 1, 1, the smallest
    above 1 (over cubes also with other axes at +-0.5 and 0.25), and (1,
    h), (1, 2 h) with h the square root of half an ulp of 1, whose
    squared length rounds to 1 + 1 ulp (its root to 1: within) and to 1
    + 4 ulp (not); ua 0.6, so that a lane accepts exactly where its second
    centre lies past 1.  Raises unless the lanes come out so.  Returns
    the record."""
    one = torch.tensor(1.0, dtype=dtype)
    below, above = torch.nextafter(one, -one), torch.nextafter(one, 2 * one)
    h = 2.0 ** -26 if dtype == torch.float64 else 2.0 ** -12
    kinds = [(below, 0.0), (one, 0.0), (above, 0.0), (one, h),
             (one, 2 * h), (below, 0.5), (one, -0.5), (above, 0.25)]
    nk = len(kinds)
    ctrs = np.zeros((2 * nk, NDIM))
    expect = []
    for r, (t0, t1) in enumerate(kinds):
        x = np.array([1.0 / 16, (1.0 + 1.75 * r) / 16, 0.5])
        ctrs[2 * r] = x
        ctrs[2 * r + 1] = [(1.0 - float(t0)) / 16, x[1] - t1 / 16, x[2]]
        t1 = torch.tensor(t1, dtype=dtype)
        dist = torch.sqrt(t0 * t0 + t1 * t1) if kind == "balls" else \
            torch.maximum(t0, t1.abs())
        expect.append(not bool(dist <= 1.0))
    arrays = {"ctrs": _cuda_t(ctrs, dtype),
              "axes": _cuda_t(np.eye(NDIM) / 16, dtype),
              "axes_inv": _cuda_t(16 * np.eye(NDIM), dtype)}
    q = STEP_Q
    rb = _unif_round(kind, q, NDIM, NDIM, dtype, None, arrays)
    rb.start(STEP_LOGLSTAR, arrays, 1 << 30)
    lanes = np.arange(q)
    inp = {"uc": _cuda_t(np.zeros((q, NDIM)), dtype),
           "ua": _cuda_t(np.full(q, 0.6), dtype),
           "idx": _cuda_t(2 * (lanes % nk), torch.int64), "u_ex": None}
    ref, ref_u, ref_c = unif_valid_refs(rb, inp)
    pr.unif_valid(rb, *unif_draws(inp))
    torch.cuda.synchronize()
    rec = _bit_record("unif_valid", (q, NDIM), dtype,
                      [("valid", rb.valid, ref), ("u_prop", rb.u_prop, ref_u),
                       ("uclamp", rb.uclamp, ref_c)])
    rec.update(kind=kind, ncdim=NDIM, nctrs=2 * nk, situation="thresholds")
    want = np.array(expect)[lanes % nk]
    if not (np.array_equal(ref.cpu().numpy(), want) and 0 < want.sum() < q):
        raise RuntimeError(f"the friends threshold case missed its outcome "
                           f"over {kind}, {dtype}")
    return rec


def unif_threshold_case(dtype, q=STEP_Q, device="cuda"):
    """``unif_valid`` against its plain version on a union of six
    ellipsoids (padded to eight slots, the two masked ones holding every
    lane) whose forms lie exactly at the thresholds: lane k (k % 8 < 6)
    has in slot k % 8 the form the largest float below 1, 1, the smallest
    above 1, or the same about 1 + 1e-3 (the round-off rescue's bound),
    forms above 4 in the other valid slots, and ua 0; the other lanes are
    random.  Raises unless the target lanes come out as the thresholds
    say and some lane is valid only through the rescue (no form < 1, one
    <= 1 + 1e-3).  Returns the record."""
    rs = np.random.Generator(np.random.PCG64(SEED + 11 + q))

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    one = torch.tensor(1.0, dtype=dtype)
    loose = torch.tensor(1.0 + 1e-3, dtype=dtype)
    targets = torch.stack([torch.nextafter(one, -one), one,
                           torch.nextafter(one, 2 * one),
                           torch.nextafter(loose, -one), loose,
                           torch.nextafter(loose, 2 * one)])
    m, n = 8, NDIM
    ctrs = np.full((m, n), 0.5)
    ctrs[:6, 0] = 0.25
    ctrs[:6, 1] = 0.1 + 0.1 * np.arange(6)
    ams = np.zeros((m, n, n))
    ams[:6] = np.diag([0.0, 400.0, 400.0])
    # d = (0.5, 0, 0) below: the form is 0.25 * (4 * target), exactly
    ams[:6, 0, 0] = 4.0 * targets.double().numpy()
    ams[6:] = 1e-6 * np.eye(n)
    arrays = {"ctrs": t(ctrs), "ams": t(ams), "axes": t(ams),
              "logvols": t(np.zeros(m)),
              "mask": t(np.arange(m) < 6, torch.bool)}
    layout = {k: (tuple(arrays[k].shape), arrays[k].stride(),
                  arrays[k].storage_offset(), arrays[k].dtype)
              for k in pr.UNIF_ARRAYS["ellipsoids"]}
    rb = pr.UnifRound(q, n, n, n, dtype, device, None, layout)
    rb.start(STEP_LOGLSTAR, arrays, 1 << 30)
    lane = np.arange(q)
    at = lane % 8 < 6
    uc = rs.uniform(0.05, 0.95, (q, n))
    uc[at, 0] = 0.75
    uc[at, 1] = ctrs[lane[at] % 8, 1]
    uc[at, 2] = 0.5
    ua = rs.random(q)
    ua[at] = 0.0
    inp = {"uc": t(uc), "ua": t(ua), "idx": None, "u_ex": None}
    ref, ref_u, ref_c = unif_valid_refs(rb, inp)
    pr.unif_valid(rb, inp["uc"], inp["ua"], None, None)
    if device == "cuda":
        torch.cuda.synchronize()
    rec = _bit_record("unif_valid", (q, n), dtype,
                      [("valid", rb.valid, ref), ("u_prop", rb.u_prop, ref_u),
                       ("uclamp", rb.uclamp, ref_c)])
    rec.update(kind="ellipsoids", ncdim=n, m=m, situation="thresholds")
    # the thresholds' outcomes: valid where a form is < 1, or (none being)
    # at most 1 + 1e-3 (the rescue: the targets 1 to 1 + 1e-3)
    expect = [True, True, True, True, True, False]
    got = ref.cpu().numpy()
    sq = pr.ellipsoid_forms_plain(inp["uc"], arrays["ctrs"], arrays["ams"])
    sq = sq[:, :6]
    rescued = ((sq >= 1.0).all(dim=1) & (sq <= float(loose)).any(dim=1) &
               ref).cpu().numpy()
    rec["rescued"] = int(rescued.sum())
    if not (all(bool(got[k]) == expect[k % 8] for k in lane[at]) and
            rescued[at].sum() == int(((lane % 8 >= 1) &
                                      (lane % 8 <= 4)).sum())):
        raise RuntimeError(f"the threshold case missed its outcome at q "
                           f"{q}, {dtype}: {rec['rescued']} rescued")
    return rec


def unif_kernels_phase(card):
    """Every case in float64 and float32, and the unions of 1, 4 and 16
    ellipsoids; prints one line each, raises unless every output is
    bit-identical, and returns the records and the kernels' calls at the
    main shape (the cube's wave, (256, 3), float64)."""
    cases, main_calls = [], {}
    for ncase in UNIF_CASES:
        for dtype in (torch.float64, torch.float32):
            recs, calls = unif_wave_cases(ncase, dtype)
            cases += recs
            if ncase == UNIF_CASES[0] and dtype == torch.float64:
                main_calls = calls
    for dtype in (torch.float64, torch.float32):
        cases += unif_union_cases(dtype)
        cases.append(unif_threshold_case(dtype))
        cases += unif_friends_cases(dtype)
        cases += [friends_threshold_case(kind, dtype) for kind in FRIENDS]
        cases += friends_width_cases(dtype)
        cases += [friends_repeat_case(kind, dtype) for kind in FRIENDS]
    for c in cases:
        shares = "  ".join(f"{k} {i}/{n}" for k, (i, n) in
                           c["outputs"].items())
        timed = f"  kernel {c['us']:.2f} us  plain {c['plain_us']:.2f} us" \
            f"  bound {c['bound_us']:.5f} us ({c['bound_by']})" \
            if "us" in c else ""
        slots = f" m {c['m']}" if c.get("m") else \
            f" N {c['nctrs']}" if c.get("nctrs") else ""
        print(f"unif wave {c['kernel']} {c['kind']} {tuple(c['shape'])} "
              f"ncdim {c['ncdim']}{slots} {c['situation']} {c['dtype']}: "
              f"bit-identical {c['identical']}/{c['total']} ({shares})"
              f"{timed}  [{card}]")
    bad = [c for c in cases if c["identical"] != c["total"]]
    if bad:
        raise RuntimeError(f"uniform wave kernels differ from their plain "
                           f"versions: {bad}")
    print(f"unif wave kernels: {len(cases)} cases, outputs bit-identical "
          f"{sum(c['identical'] for c in cases)}/"
          f"{sum(c['total'] for c in cases)}  [{card}]")
    return cases, main_calls


def main_unif(cases, name):
    """The record of wave kernel ``name`` at the main shape: the cube's
    wave at (256, 3) in float64, the overflow state."""
    return next(c for c in cases if c["kernel"] == name and
                c["kind"] == "cube" and c["dtype"] == "float64" and
                c["shape"][0] == STEP_Q and c["situation"] == "overflow")


def friends_unif(cases, kind, nctrs, n, dtype="float64"):
    """The record of ``unif_valid``'s friends mode over ``kind`` about
    ``nctrs`` centres in ``n`` dimensions at q 256 in ``dtype``."""
    return next(c for c in cases if c["situation"] == "friends" and
                (c["kind"], c["nctrs"], c["ncdim"], c["dtype"]) ==
                (kind, nctrs, n, dtype))


def union_unif(cases, m):
    """The record of ``unif_valid`` over the union of ``m`` ellipsoids at
    (256, 3) in float64."""
    return next(c for c in cases if c["situation"] == "union" and
                c["m"] == m and c["dtype"] == "float64")


def friends_registers(output):
    """Each friends kernel's registers and spill bytes from ``nvcc -Xptxas
    -v``'s output: ``{"float64 balls": {width: [registers, spill stores,
    spill loads]}, ...}`` (width 0: the generic loop).  Raises where a
    kernel of the widths the drives and phase 2f run (2, 3 and 15)
    spills."""
    regs, name = {}, None
    pat = re.compile(r"unif_valid_kernel_friendsI([df])Li(\d+)ELb([01])E")
    for line in output.splitlines():
        m = pat.search(line)
        if m:
            name = ("float64" if m.group(1) == "d" else "float32") + \
                (" cubes" if m.group(3) == "1" else " balls"), int(m.group(2))
            regs.setdefault(name[0], {}).setdefault(name[1], [0, 0, 0])
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            regs[name[0]][name[1]][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs[name[0]][name[1]][0] = int(m.group(1))
            name = None
    spills = [(k, nx) for k, by_nx in regs.items() for nx, r in by_nx.items()
              if nx in (2, 3, 15) and (r[1] or r[2])]
    if spills:
        raise RuntimeError(f"friends kernels spill at {spills}: {regs}")
    return regs


def beta_registers(output):
    """Each Beta kernel's registers and spill bytes from ``nvcc -Xptxas
    -v``'s output: ``{"float64 beta_ppf levels 5": [registers, spill
    stores, spill loads], ...}``.  Raises where one spills, or where a
    ``beta_ppf`` of some level count is missing."""
    regs, name = {}, None
    pat = re.compile(
        r"(beta_ppf|betainc)_kernelI([df])(?:Li(\d)ELb([01])E)?E")
    for line in output.splitlines():
        m = pat.search(line)
        if m:
            name = ("float64 " if m.group(2) == "d" else "float32 ") + \
                m.group(1) + (f" levels {m.group(3)}" if m.group(3) else "") \
                + (" one entry" if m.group(4) == "1" else "")
            regs.setdefault(name, [0, 0, 0])
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            regs[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs[name][0] = int(m.group(1))
            name = None
    want = {f"{t} beta_ppf levels {lv}" for t in ("float64", "float32")
            for lv in range(1, 6)} | \
        {f"{t} beta_ppf levels 1 one entry" for t in ("float64", "float32")}
    spills = [k for k, r in regs.items() if r[1] or r[2]]
    if spills or not want <= set(regs):
        raise RuntimeError(f"Beta kernels spill at {spills} or are missing "
                           f"({sorted(want - set(regs))}): {regs}")
    return regs


def _capture_waves(like, kind, q, dtype, seeds, cache, timings):
    """``len(seeds)`` uniform rounds of ``q`` lanes on one round cache:
    the balls drive's Gaussian with a blob, over the cube, three
    ellipsoids around its mass, or balls or cubes about 2048 centres, at a
    threshold that 4 % (over the cube and the friends) or 0.5 % (over the
    ellipsoids) of the cube's points beat, so that a round takes several
    waves.  Returns each round's packed columns, blob and generator
    offset."""
    from dynesty_tpu_torch.internal import kernels as tk
    arrays = unif_arrays(kind, NDIM, dtype)
    fn = tk.make_unif_round(like, ndim=NDIM, q=q, bound_kind=kind,
                            dtype=dtype, device="cuda", timings=timings,
                            rounds=cache)
    u = np.random.Generator(np.random.PCG64(SEED)).random((4000, NDIM))
    loglstar = float(np.quantile(like.eval_host(u)[1],
                                 0.995 if kind == "ellipsoids" else 0.96))
    outs = []
    for seed in seeds:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        out, out_blob = fn(gen, loglstar, arrays)
        torch.cuda.synchronize()
        outs.append((out, out_blob, gen.get_offset()))
    return outs


def captured_unif_phase(card):
    """Captured uniform waves against eager-launched ones on the same
    inputs: the cube's waves, the ellipsoids' (their choice a
    ``torch.multinomial`` inside the graph) and the friends' over balls
    and cubes about 2048 centres (the draws and ``unif_valid``'s friends
    mode), float64 and float32, the main width (256) and the narrow width
    (32), three rounds each on one round cache (the first wave warms up,
    the second captures, every later one replays), with a blob: every
    column, the blob and the generator's offset bit for bit.  Then, for
    the cube's wave at (256, 3) in float64, the host time of one replayed
    wave with its wait and flag read against one eager wave's, and CUDA
    events around back-to-back replays; the replay's device-only time
    comes in the last phase.  Returns the records, the timed graph and the
    friends' float64 graphs at width 256 by kind."""
    from dynesty_tpu_torch.utils.misc import Timings
    _gauss_setup()
    cases, timed, friends_timed = [], None, {}
    seeds = (SEED, SEED + 1, SEED + 2)
    for kind in ("cube", "ellipsoids") + FRIENDS:
        for dtype in (torch.float64, torch.float32):
            for q in (STEP_Q, 32):
                tg, te, cache = Timings(), Timings(), {}
                got = _capture_waves(_capture_like(False, dtype), kind, q,
                                     dtype, seeds, cache, tg)
                ref = _capture_waves(_capture_like(True, dtype), kind, q,
                                     dtype, seeds, {}, te)
                same = {"packed": 0, "blob": 0, "offset": 0}
                for (p, b, off), (pe, be, offe) in zip(got, ref):
                    same["packed"] += int(_same_bits(
                        p.cpu().numpy(), pe.cpu().numpy()).all())
                    same["blob"] += int(_same_bits(
                        b.cpu().numpy(), be.cpu().numpy()).all())
                    same["offset"] += int(off == offe)
                waves = te["sync_wave"]
                rec = {"kind": kind, "q": q, "ndim": NDIM,
                       "dtype": str(dtype).replace("torch.", ""),
                       "rounds": len(seeds), "same": same, "waves": waves,
                       "n_unif_replay": tg.get("n_unif_replay", 0),
                       "n_unif_graph": tg.get("n_unif_graph", 0),
                       "n_uncaptured": tg.get("n_uncaptured", 0),
                       "eager_uncaptured": te.get("n_uncaptured", 0)}
                cases.append(rec)
                ok = (all(v == len(seeds) for v in same.values()) and
                      waves > len(seeds) and rec["n_unif_graph"] == 1 and
                      rec["n_uncaptured"] == 1 and
                      rec["n_unif_replay"] + 1 == waves and
                      rec["eager_uncaptured"] == waves and
                      tg["sync_wave"] == waves)
                if not ok:
                    raise RuntimeError(f"a captured uniform wave differs from "
                                       f"the eager-launched one: {rec}")
                if (kind, dtype, q) == ("cube", torch.float64, STEP_Q):
                    timed = next(iter(cache.values()))
                if kind in FRIENDS and (dtype, q) == (torch.float64, STEP_Q):
                    friends_timed[kind] = next(iter(cache.values()))
                print(f"captured-unif {kind} q {q} {rec['dtype']}: "
                      f"{len(seeds)} rounds bit-identical (columns, blob, "
                      f"generator offset), waves {waves} = replays "
                      f"{rec['n_unif_replay']} + warm-up 1  [{card}]")
    # the host's cost of a wave, replayed and eager, at the cube's shape:
    # each call waits for the device and reads the flag
    eager, cache = _capture_like(True, torch.float64), {}
    _capture_waves(eager, "cube", STEP_Q, torch.float64, (SEED,), cache,
                   Timings())
    eager_entry = next(iter(cache.values()))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    draw = eager_entry.draws(gen)

    def eager_wave():
        eager_entry.wave(draw)
        return bool(eager_entry.rb.done)

    def host_us(fn, n=200):
        for _ in range(5):
            fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e6 * (time.perf_counter() - t0) / n

    timing = {"shape": [STEP_Q, NDIM], "kind": "cube", "dtype": "float64",
              "replay_host_us": host_us(timed.replay),
              "eager_wave_host_us": host_us(eager_wave),
              "replay_events_us": 1e3 * _time_ms(timed.graph.replay, 200),
              "eager_wave_events_us": 1e3 * _time_ms(
                  lambda: eager_entry.wave(draw), 200)}
    print(f"captured-unif (256, 3) float64: one wave, host time with its "
          f"wait and flag read: replay {timing['replay_host_us']:.2f} us, "
          f"eager {timing['eager_wave_host_us']:.2f} us; events (back to "
          f"back): replay {timing['replay_events_us']:.2f} us, eager "
          f"{timing['eager_wave_events_us']:.2f} us  [{card}]")
    print(json.dumps({"phase": "captured-unif", "card": card,
                      "cases": cases, "timing": timing}))
    return {"cases": cases, "timing": timing}, timed, friends_timed


# --------------------------------------------------------------------------
# the doubling slice round's kernels against their plain versions, and the
# captured round


DOUBLING_SOURCE = "dynesty_tpu_torch/csrc/slice_doubling.cu"
DOUBLING_KERNELS = ("doubling_point", "doubling_expand", "doubling_halve",
                    "doubling_shrink")
# the JAX code each replaces (dynesty_tpu/internal/kernels.py)
DOUBLING_REPLACES = {
    "doubling_point": ("dynesty_tpu/internal/kernels.py:555",
                       [":594-607"]),
    "doubling_expand": ("dynesty_tpu/internal/kernels.py:640",
                        [":594-607", ":640-655", ":646-649", ":673"]),
    "doubling_halve": ("dynesty_tpu/internal/kernels.py:569",
                       [":569-585"]),
    "doubling_shrink": ("dynesty_tpu/internal/kernels.py:670",
                        [":670-693", ":678-682", ":574", ":673"])}
# (ndim, strict mask) of the kernels' cases: the doubling drives' 3-D and
# 15-D, each without a mask and with every third dimension loose
DOUBLING_CASES = [(3, False), (3, True), (15, False), (15, True)]
# each kernel's calls: (mode, the flag that is false as it starts: a
# candidate's ``any``, which the loop before it ended on; a resolution's
# ``any_shrink``, which the candidate cleared); doubling_expand starts
# from the hand-made state's stale ``any`` and clears it itself
DOUBLING_CALLS = {
    "doubling_point": [(0, None), (1, None)],
    "doubling_expand": [(0, None), (1, None)],
    "doubling_halve": [(None, "any")],
    "doubling_shrink": [(0, "any"), (1, "any_shrink")]}
# the mode each kernel is timed in: the right end probe, a doubling with
# its next probe, a halving, a shrink candidate's outcome (every mode's
# device time in phase 34)
DOUBLING_TIMED = {"doubling_point": 1, "doubling_expand": 1,
                  "doubling_halve": None, "doubling_shrink": 0}
DOUBLING_NSTEPS = 6
DOUBLING_SEGMENTS = ("start", "double", "candidate", "halve", "resolve")
# each kernel's calls in each of its modes at the drives' (256, 3) in
# float64, by (kernel, mode), timed device-only in phase 34
# (doubling_kernel_cases)
_MODE_CALLS = {}


def doubling_state(q, ndim, npdim, dtype, seed=SEED):
    """A hand-made doubling round state and a segment's inputs on the
    card: lanes that double, shrink and halve and lanes that do not,
    intervals on both sides of 0 wide enough for the points to leave the
    cube, ``grow`` at and next to its clamp, end values of -inf and at the
    threshold, a draw of 0 (a candidate on its interval's left end) and
    draws of exactly 0.5 (the doubling's side)."""
    rs = np.random.Generator(np.random.PCG64(seed))
    lane = np.arange(q)
    i64, ls = torch.int64, STEP_LOGLSTAR
    vals = [-math.inf, -1.0, ls, 1.0, 3.0]
    left, right = -rs.random(q) * 3.0, rs.random(q) * 3.0
    st = pr._doubling_state(q, ndim, npdim, dtype, "cuda")

    def t(a, dt=dtype):
        return _cuda_t(a, dt)

    def mask(p):
        return t(rs.random(q) < p, torch.bool)

    st.update({
        "u": t(rs.random((q, ndim))), "v": t(rs.random((q, npdim))),
        "logl": t(rs.normal(size=q)), "u0": t(rs.random((q, ndim))),
        "dir": t(rs.normal(size=(q, ndim)) * 0.3),
        "u_c": t(rs.random((q, ndim))), "v_c": t(rs.random((q, npdim))),
        "logl_c": t(rs.choice(vals, q)),
        "left": t(left), "right": t(right),
        "fl": t(rs.choice(vals, q)), "fr": t(rs.choice(vals, q)),
        "sl": t(left * rs.random(q)), "sr": t(right * rs.random(q)),
        "lhat": t(left * rs.random(q)), "rhat": t(right * rs.random(q)),
        "f_lhat": t(rs.choice(vals, q)), "f_rhat": t(rs.choice(vals, q)),
        "x1": t(rs.uniform(-3.0, 3.0, q)), "uclamp": t(np.zeros((q, ndim))),
        "nc": t(rs.integers(0, 50, q), i64),
        "n_exp": t(rs.integers(0, 50, q), i64),
        "n_con": t(rs.integers(0, 50, q), i64),
        "grow": t(rs.choice([1, 2, 1 << 29, 1 << 30], q), i64),
        "d_nc": t(rs.integers(0, 5, q), i64),
        "active": mask(0.7), "s_active": mask(0.7), "h_active": mask(0.6),
        "good": mask(0.5), "dflag": mask(0.3), "reject": mask(0.2),
        "newly": mask(0.5), "incube": mask(0.8), "incube_l": mask(0.8),
        "step": t([DOUBLING_NSTEPS - 2], i64)})
    st["any"].fill_(True)
    st["any_shrink"].fill_(True)
    draw = rs.random(q)
    draw[lane % 9 == 0] = 0.5
    draw[lane % 11 == 1] = 0.0
    inp = {"directions": t(rs.normal(size=(q, DOUBLING_NSTEPS, ndim)) * 0.4),
           "draw": t(draw), "loglstar": t(ls),
           "strict": t(np.arange(ndim) % 3 != 2, torch.bool),
           "logl_x": t(rs.choice(vals + [0.5, 2.0, math.inf], q)),
           "logl_l": t(rs.choice(vals + [0.5, 2.0], q)),
           "v_x": t(rs.random((q, npdim)))}
    # the side each lane's doubling kept, a candidate's cube check and the
    # first candidate's draw (some 0), where the checkout's round has them
    if "go_left" in st:
        st["go_left"] = t(draw < 0.5, torch.bool)
        st["incube_s"] = mask(0.8)
    draw_x = rs.random(q)
    draw_x[lane % 5 == 2] = 0.0
    inp["draw_x"] = t(draw_x)
    return st, inp


def doubling_round_on_card(st, inp, strict):
    """A ``DoublingRound`` on the card holding the hand-made state and a
    segment's inputs."""
    q, n_steps, ndim = inp["directions"].shape
    rb = pr.DoublingRound(q, n_steps, ndim, st["v"].shape[1],
                          inp["directions"].dtype, "cuda",
                          inp["strict"] if strict else None)
    for k, t in st.items():
        rb.st[k].copy_(t)
    rb.directions.copy_(inp["directions"])
    rb.draw.copy_(inp["draw"])
    if hasattr(rb, "draw_x"):
        rb.draw_x.copy_(inp["draw_x"])
    rb.loglstar.copy_(inp["loglstar"])
    rb.gate.fill_(False)
    return rb


def _doubling_call(rb, name, mode, inp):
    """Kernel ``name`` in ``mode`` through its wrapper on ``rb``."""
    if name == "doubling_point":
        return lambda: pr.doubling_point(rb, mode)
    if name == "doubling_expand":
        return lambda: pr.doubling_expand(rb, mode, inp["logl_x"],
                                          inp["logl_l"], rb.draw_x)
    if name == "doubling_halve":
        return lambda: pr.doubling_halve(rb, inp["logl_x"])
    return lambda: pr.doubling_shrink(rb, mode, inp["v_x"], inp["logl_x"])


def _doubling_plain(st, rb, name, mode, inp):
    """Kernel ``name``'s plain version in ``mode`` on the state ``st``,
    with ``rb``'s inputs."""
    if name == "doubling_point":
        pr.doubling_point_plain(st, mode, rb.draw, rb.directions, rb.strict,
                                rb.gate)
    elif name == "doubling_expand":
        pr.doubling_expand_plain(st, mode, inp["logl_x"], inp["logl_l"],
                                 rb.draw, rb.draw_x, rb.loglstar, rb.strict)
    elif name == "doubling_halve":
        pr.doubling_halve_plain(st, inp["logl_x"], rb.loglstar, rb.strict)
    else:
        pr.doubling_shrink_plain(st, mode, inp["v_x"], inp["logl_x"],
                                 rb.loglstar, rb.strict, rb.draw)


def doubling_bytes(name, mode, st, inp, q, ndim, npdim, tb):
    """The bytes kernel ``name`` must move in ``mode`` on the hand-made
    state: each input read once, each output written once, a lane's
    per-lane counters and the values of one kind of lane only where the
    plain version changes them (the per-lane counts from its outcome).
    The next probe's start and direction rows and the cube check's mask
    in, its clamped row (and a shrink candidate's point and position) and
    its cube checks out, where the kernel writes a probe."""
    probe = 2 * q * ndim * tb + ndim + q * ndim * tb
    if name == "doubling_point":
        if mode == 0:
            # r0 and the start and direction rows in; the step's rows, the
            # clamped row, the cube check and the interval out; the gate,
            # the mask and the step index
            return q * tb + 2 * q * ndim * tb + ndim + 9 + \
                3 * q * ndim * tb + q + 2 * q * tb
        # the right end, the step's rows in; the clamped row and the cube
        # check out; the gate and the mask
        return q * tb + probe + q + 1
    if name == "doubling_expand":
        ref = _clone(st)
        pr.doubling_expand_plain(ref, mode, inp["logl_x"], inp["logl_l"],
                                 inp["draw"], inp["draw_x"], inp["loglstar"])
        n_on = int(ref["active"].sum())
        n_stop = q - n_on
        # a stopped lane's candidate: its position and point out, both
        # cube checks and the side of a lane that doubles on out
        nxt = n_stop * (tb + ndim * tb) + 2 * q + n_on + probe + 1
        if mode == 0:
            # both probes' cube checks and logl, the interval, both draws
            # and nc in; the end values, the shrink's interval, the mask,
            # nc, grow, s_active out; the step index in and out
            return q * (2 + 6 * tb + 8) + tb + 16 + \
                q * (4 * tb + 1 + 16 + 1) + nxt
        n0 = int(st["active"].sum())
        # the cube check, logl, the interval, both draws, the end values,
        # the mask, the side and s_active in; nc, n_exp and grow in and
        # out and one end out where the lane doubled; the end values, the
        # shrink's interval and the mask out
        return q * (1 + 6 * tb + 3) + tb + 24 * n0 + \
            q * (4 * tb + 1) + n0 * (24 + tb) + nxt
    if name == "doubling_halve":
        rej = _clone(st)
        rej["reject"].zero_()
        pr.doubling_halve_plain(rej, inp["logl_x"], inp["loglstar"])
        n_rej = int(rej["reject"].sum())
        # the candidate's position, the test's ends and end values, logl,
        # the cube check, dflag, the mask and d_nc in; the ends, end
        # values, dflag, the mask and d_nc out, reject where it rejects;
        # the next mid's clamped row and cube check
        return q * (6 * tb + 11) + tb + q * (4 * tb + 10) + n_rej + 1 + \
            probe + q
    if mode == 0:
        # a candidate: cube check, v, logl, mask, the doubling's interval
        # and end values, nc, n_con in; v, logl, nc, n_con, good, the
        # test's start (its mask, ends, end values, dflag, reject, d_nc)
        # out; the two flags; the first mid's clamped row and cube check
        return q * (npdim * tb + 5 * tb + 18) + tb + \
            q * (npdim * tb + 5 * tb + 28) + 2 + probe + q
    ref = _clone(st)
    pr.doubling_shrink_plain(ref, 1, None, None, inp["loglstar"], None,
                             inp["draw"])
    n_new = int(ref["newly"].sum())
    n_bad = int(ref["s_active"].sum())
    n_ag = int((st["s_active"] & st["good"]).sum())
    # a resolution: the masks, the candidate's position, the interval and
    # the draw in; d_nc and nc in and nc out where a good lane is billed;
    # the candidate's rows and logl in and the lane's out where it
    # accepts; one end out where it shrinks on; the masks out; the next
    # candidate's position, point and clamped row and its cube check; the
    # flag
    return q * (3 + 4 * tb) + 24 * n_ag + \
        2 * n_new * (ndim + npdim + 1) * tb + n_bad * tb + 2 * q + \
        q * tb + q * ndim * tb + probe + q + 1


def doubling_kernel_cases(ndim, strict, dtype):
    """Each of the four kernels, in each of its modes, against its plain
    version from the hand-made state (the flag that is false as it
    starts cleared): every entry of the state.  Returns the records (each
    with every mode's byte bound) and the kernels' calls in their timed
    modes."""
    q, npdim = STEP_Q, ndim
    st, inp = doubling_state(q, ndim, npdim, dtype)
    tb = torch.finfo(dtype).bits // 8
    recs, calls = [], {}
    covered = []
    for name, modes in DOUBLING_CALLS.items():
        pairs = []
        for mode, flag in modes:
            s0 = _clone(st)
            if flag is not None:
                s0[flag].zero_()
            rb = doubling_round_on_card(s0, inp, strict)
            _doubling_call(rb, name, mode, inp)()
            ref = _clone(s0)
            _doubling_plain(ref, rb, name, mode, inp)
            torch.cuda.synchronize()
            pairs += [(f"{k}[{mode}]", rb.st[k], ref[k]) for k in sorted(ref)]
            if name == "doubling_expand":
                # its count word is zero after every launch
                pairs.append((f"vote[{mode}]", rb.vote,
                              torch.zeros_like(rb.vote)))
                # lanes that double on and lanes that stop, a next probe
                # out of the cube and one clamped
                covered.append(bool(ref["active"].any()) and
                               bool((~ref["active"]).any()))
                covered.append(bool((ref["active"] &
                                     ~ref["incube"]).any()))
                covered.append(bool(((ref["uclamp"] == 0.0) |
                                     (ref["uclamp"] == 1.0)).any()))
            if (name, mode) == ("doubling_expand", 1):
                covered.append(bool((st["active"] &
                                     (st["grow"] == 1 << 30)).any()))
            if name == "doubling_halve":
                covered.append(bool((ref["reject"] & ~st["reject"]).any()))
            if (name, mode) == ("doubling_shrink", 1):
                covered.append(bool(ref["newly"].any()) and
                               bool(ref["s_active"].any()))
        rec = _bit_record(name, (q, ndim), dtype, pairs)
        rec["strict"] = strict
        rec["mode_bound_us"] = {
            m: 1e6 * doubling_bytes(name, m, st, inp, q, ndim, npdim, tb) /
            HBM_BYTES for m, _ in modes}
        mode = DOUBLING_TIMED[name]
        rb_t = doubling_round_on_card(_clone(st), inp, strict)
        call = _doubling_call(rb_t, name, mode, inp)
        _step_time(rec, call,
                   lambda: _doubling_plain(dict(st), rb_t, name, mode, inp),
                   doubling_bytes(name, mode, st, inp, q, ndim, npdim, tb))
        recs.append(rec)
        calls[name] = call
        if (ndim, strict, dtype) == (NDIM, False, torch.float64):
            for m, _ in modes:
                _MODE_CALLS[(name, m)] = _doubling_call(
                    doubling_round_on_card(_clone(st), inp, strict), name,
                    m, inp)
    if not all(covered):
        raise RuntimeError(f"the hand-made doubling state misses an outcome "
                           f"at ndim {ndim}: {covered}")
    return recs, calls


def main_doubling(cases, name):
    """The record of kernel ``name`` at the doubling drives' (256, 3) in
    float64, without a mask."""
    return next(c for c in cases if c["kernel"] == name and
                c["dtype"] == "float64" and
                tuple(c["shape"]) == (STEP_Q, NDIM) and not c["strict"])


def doubling_kernels_phase(card):
    """Every case in float64 and float32; prints one line each, raises
    unless every output is bit-identical, and returns the records and the
    kernels' calls at (256, 3) float64 without a mask."""
    cases, main_calls = [], {}
    for ndim, strict in DOUBLING_CASES:
        for dtype in (torch.float64, torch.float32):
            recs, calls = doubling_kernel_cases(ndim, strict, dtype)
            cases += recs
            if (ndim, strict, dtype) == (NDIM, False, torch.float64):
                main_calls = calls
    for c in cases:
        print(f"doubling {c['kernel']} {tuple(c['shape'])}"
              + (" strict mask" if c["strict"] else "") +
              f" {c['dtype']}: bit-identical {c['identical']}/"
              f"{c['total']}  kernel {c['us']:.2f} us  plain "
              f"{c['plain_us']:.2f} us  bound {c['bound_us']:.5f} us "
              f"(bytes)  [{card}]")
    bad = [c for c in cases if c["identical"] != c["total"]]
    if bad:
        raise RuntimeError(f"doubling kernels differ from their plain "
                           f"versions: {bad}")
    print(f"doubling kernels: {len(cases)} cases, outputs bit-identical "
          f"{sum(c['identical'] for c in cases)}/"
          f"{sum(c['total'] for c in cases)}  [{card}]")
    return cases, main_calls


def captured_doubling_phase(card):
    """Captured doubling rounds against eager-launched rounds on the same
    inputs: rslice and slice at their default slices, float64 and
    float32, the main width (256) and the narrow width (32), three rounds
    each on one round cache (the first warms up each of the five segments
    once and captures the segments it runs again; every later segment
    replays), with a blob and a strict mask: every column, the blob and
    the generator's offset bit for bit.  Then, at the doubling drives'
    shape (rslice, (256, 3), float64), each segment's host time (with its
    wait and flag read) replayed and run eagerly, and CUDA events around
    back-to-back calls; the replays' device-only times come in the last
    phase.  Returns the records and the timed round shape."""
    from dynesty_tpu_torch.utils.misc import Timings
    _gauss_setup()
    cases, timed = [], None
    for kind, slices in (("rslice", NDIM + 3), ("slice", 3)):
        for dtype in (torch.float64, torch.float32):
            for q in (STEP_Q, 32):
                seeds = (SEED, SEED + 1, SEED + 2)
                tg, te, cache = Timings(), Timings(), {}
                got = _capture_rounds(_capture_like(False, dtype), kind,
                                      slices, q, dtype, seeds, cache, tg,
                                      doubling=True)
                ref = _capture_rounds(_capture_like(True, dtype), kind,
                                      slices, q, dtype, seeds, {}, te,
                                      doubling=True)
                same = {"packed": 0, "blob": 0, "offset": 0}
                for (p, b, off), (pe, be, offe) in zip(got, ref):
                    same["packed"] += int(_same_bits(
                        p.cpu().numpy(), pe.cpu().numpy()).all())
                    same["blob"] += int(_same_bits(
                        b.cpu().numpy(), be.cpu().numpy()).all())
                    same["offset"] += int(off == offe)
                rec = {"kind": kind, "q": q, "ndim": NDIM,
                       "dtype": str(dtype).replace("torch.", ""),
                       "rounds": len(seeds), "same": same,
                       "segments": te.get("n_uncaptured", 0),
                       "sync_slice": te["sync_slice"],
                       "n_doubling_replay": tg.get("n_doubling_replay", 0),
                       "n_doubling_graph": tg.get("n_doubling_graph", 0),
                       "n_uncaptured": tg.get("n_uncaptured", 0)}
                cases.append(rec)
                ok = (all(v == len(seeds) for v in same.values()) and
                      rec["n_doubling_graph"] == rec["n_uncaptured"] ==
                      len(DOUBLING_SEGMENTS) and
                      rec["n_doubling_replay"] + rec["n_uncaptured"] ==
                      rec["segments"] and
                      tg["sync_slice"] == te["sync_slice"])
                if not ok:
                    raise RuntimeError(f"a captured doubling round differs "
                                       f"from the eager-launched one: {rec}")
                if (kind, dtype, q) == ("rslice", torch.float64, STEP_Q):
                    timed = next(iter(cache.values()))
                print(f"captured-doubling {kind} q {q} {rec['dtype']}: "
                      f"{len(seeds)} rounds bit-identical (columns, blob, "
                      f"generator offset), segments {rec['segments']} = "
                      f"replays {rec['n_doubling_replay']} + warm-ups "
                      f"{rec['n_uncaptured']}  [{card}]")
    # each segment's cost on the host, replayed and eager, at the drives'
    # shape: each call waits for the device and reads the flag
    eager, cache = _capture_like(True, torch.float64), {}
    _capture_rounds(eager, "rslice", NDIM + 3, STEP_Q, torch.float64,
                    (SEED,), cache, Timings(), doubling=True)
    eager_entry = next(iter(cache.values()))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def fill_of(entry, name):
        if name not in entry.DRAWS:
            return None
        return entry._filler(gen, False)

    def eager_segment(name, read=True):
        def call():
            eager_entry.segment(name, fill_of(eager_entry, name))
            if read:
                bool(eager_entry._flag_of(name))
        return call

    def host_us(fn, n=200):
        for _ in range(5):
            fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e6 * (time.perf_counter() - t0) / n

    timing = {"shape": [STEP_Q, NDIM], "kind": "rslice", "dtype": "float64",
              "segments": {}}
    for name in DOUBLING_SEGMENTS:
        graph = timed.graphs[name]
        timing["segments"][name] = {
            "replay_host_us": host_us(lambda: timed.replay(name, gen)),
            "eager_host_us": host_us(eager_segment(name)),
            "replay_events_us": 1e3 * _time_ms(graph.replay, 200),
            "eager_events_us": 1e3 * _time_ms(eager_segment(name, False),
                                              200)}
        t = timing["segments"][name]
        print(f"captured-doubling (256, 3) float64 segment {name}: host "
              f"time with its wait and flag read: replay "
              f"{t['replay_host_us']:.2f} us, eager "
              f"{t['eager_host_us']:.2f} us; events (back to back): replay "
              f"{t['replay_events_us']:.2f} us, eager "
              f"{t['eager_events_us']:.2f} us  [{card}]")
    print(json.dumps({"phase": "captured-doubling", "card": card,
                      "cases": cases, "timing": timing}))
    return {"cases": cases, "timing": timing}, timed


def doubling_drive(dyt, nlive, bound):
    """The doubling form of rslice on the 3-D Gaussian: the sampler given
    as ``RSliceSampler(slice_doubling=True)``."""
    s, sampler = drive(
        dyt, nlive, bound,
        sample=dyt.internal.samplers.RSliceSampler(slice_doubling=True))
    if not sampler.internal_sampler.sampler_kwargs["slice_doubling"]:
        raise RuntimeError("the doubling drive ran in stepping-out mode")
    return s, sampler


def uncapturable_loglike(x):
    """The Gaussian with its precision matrix copied from the host at
    every call, which no CUDA graph may hold."""
    return -0.5 * (x @ _GAUSS["cinv_host"].to(x.device) @ x) + \
        _GAUSS["lnorm"]


def uncapturable_phase(dyt):
    """A likelihood that copies a host constant to the card at every call:
    each wave shape's capture raises and is warned once, and every wave
    runs eagerly through both wave kernels (counted by the caller)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sampler = dyt.NestedSampler(
            uncapturable_loglike, box_ptform, NDIM, nlive=250,
            bound="single", sample="unif", queue_size=128,
            rstate=np.random.Generator(np.random.PCG64(SEED)))
        sampler.run_nested(print_progress=False, dlogz=0.5)
    torch.cuda.synchronize()
    captures = [str(w.message) for w in caught
                if "could not be captured" in str(w.message)]
    out = {"wall_s": time.perf_counter() - t0,
           "niter": int(sampler.results.niter), "ncall": int(sampler.ncall),
           "capture_warnings": len(captures),
           "capture_error": captures[0] if captures else None,
           "timings": dict(sampler.timings)}
    if not captures or len(set(captures)) != len(captures):
        raise RuntimeError(f"the uncapturable likelihood was not warned "
                           f"once a shape: {out}")
    return out


def partial_capture_phase(dyt):
    """A doubling drive (single, nlive 250) whose second segment capture
    raises after its first was captured and replayed: warned once, no
    replay after the raise (the shape wholly eager from there), and the
    run bit for bit a run whose likelihood no graph may hold."""
    import dynesty_tpu_torch.internal.kernels as tk
    from dynesty_tpu_torch.internal.samplers import RSliceSampler
    segment, replay = tk.DoublingGraph.segment, tk.DoublingGraph.replay
    capture = tk.DoublingGraph.capture
    late, attempts = [], []

    def counted(self, name):
        attempts.append(name)
        return capture(self, name)

    def failing(self, name, fill=None):
        # the shape's second capture raises
        if len(attempts) == 2 and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the second segment cannot be captured")
        return segment(self, name, fill)

    def checked(self, name, gen):
        if not self.capturable:
            late.append(name)
        return replay(self, name, gen)

    runs = {}
    for name in ("raised", "eager"):
        tk.DoublingGraph.segment = failing if name == "raised" else segment
        tk.DoublingGraph.replay = checked
        tk.DoublingGraph.capture = counted
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                sampler = dyt.NestedSampler(
                    gauss_loglike, box_ptform, NDIM, nlive=250,
                    bound="single",
                    sample=RSliceSampler(slice_doubling=True),
                    queue_size=64,
                    rstate=np.random.Generator(np.random.PCG64(SEED)))
                if name == "eager":
                    sampler.loglikelihood.capturable = lambda: False
                sampler.run_nested(print_progress=False, dlogz=0.5)
        finally:
            tk.DoublingGraph.segment, tk.DoublingGraph.replay = \
                segment, replay
            tk.DoublingGraph.capture = capture
        runs[name] = (sampler, [str(w.message) for w in caught
                                if "could not be captured" in
                                str(w.message)])
    (sr, wr), (se, _) = runs["raised"], runs["eager"]
    a, b = sr.results, se.results
    same = all(bool(_same_bits(np.asarray(a[k], dtype=np.float64),
                               np.asarray(b[k], dtype=np.float64)).all())
               for k in ("logl", "logwt", "logz", "samples", "ncall"))
    t = sr.timings
    out = {"same": same, "warnings": wr, "replays_after_raise": late,
           "captures_tried": attempts[:2],
           "n_doubling_graph": t.get("n_doubling_graph", 0),
           "n_doubling_replay": t.get("n_doubling_replay", 0)}
    if not same or len(wr) != 1 or attempts[1] not in wr[0] or late or \
            out["n_doubling_graph"] != 1 or out["n_doubling_replay"] < 1:
        raise RuntimeError(f"a doubling segment's capture that raised did "
                           f"not leave its shape wholly eager: {out}")
    return out


# --------------------------------------------------------------------------
# the Beta prior's kernels (phase 2j) and the beta-prior drive (phase 27b)

BETA_SOURCE = "dynesty_tpu_torch/csrc/beta_prior.cu"
BETA_REPLACES = "dynesty_tpu/models/priors.py:83"
# jax.scipy.special.betainc, whose 50 calls the JAX Beta's bisection makes
BETA_REPLACES_ALSO = ["dynesty_tpu/models/priors.py:11"]
BETA_KERNELS = ("beta_ppf", "betainc")
# the sweep's (a, b): every pair of these values
# (tests/test_torch_models.py's betainc grid)
BETA_VALUES = (0.5, 1.0, 2.0, 5.0, 30.0)
BETA_PAIRS = [(a, b) for a in BETA_VALUES for b in BETA_VALUES]
# u and x at their ends, and a NaN (a NaN comparison is false: hi moves)
BETA_EDGES = (0.0, 1.0, 1e-12, 1 - 1e-12, math.nan)
# a wave's lanes, and the priors phase's points (betainc's sweep;
# beta_ppf's adds the shapes either side of its level switch,
# beta_shapes())
BETA_SHAPES = (256, PRIOR_POINTS)
# beta_ppf's mixed table: (column of a five-column u, a, b)
BETA_TABLE = ((4, 2.0, 5.0), (1, 0.5, 0.5), (3, 30.0, 1.0))
# the drive's three Betas in one table: one beta_ppf launch a prior call
BETA_DRIVE_LAUNCHES = 1
# the timed shapes of each kernel: a wave's lanes, beta_ppf's grouped
# drive call (256 rows of three Betas), the priors phase's points
BETA_TIMED = {"beta_ppf": (256, 768, PRIOR_POINTS),
              "betainc": (256, PRIOR_POINTS)}
# the beta-prior drive: Beta(2, 5), Beta(0.5, 0.5), Beta(5, 2) under a
# product of Gaussians of these means and this width, nlive 2048, every
# other argument at its default (multi / unif, bootstrap 5, q 256)
BETA_DRIVE_AB = ((2.0, 5.0), (0.5, 0.5), (5.0, 2.0))
BETA_MU, BETA_SIGMA, BETA_NLIVE = (0.25, 0.5, 0.75), 0.02, 2048
# the card's peak rate for each type's operations
_RATE = {torch.float64: FP64_FLOPS, torch.float32: FP32_FLOPS}


def beta_lanes():
    """The threads the card keeps busy with ``beta_ppf_kernel``: 16 warps
    an SM (its level rule's budget)."""
    return 512 * torch.cuda.get_device_properties(0).multi_processor_count


def beta_switch():
    """The most elements a ``beta_ppf`` launch walks a warp an element
    (five levels a round): a warp for each must fit the budget."""
    return beta_lanes() // 32


def beta_levels(n):
    """The levels a round of a ``beta_ppf`` launch of ``n`` elements (the
    package's rule; 1 for a checkout before the tree walk)."""
    levels = getattr(bp, "beta_levels", None)
    return levels(n, beta_lanes()) if levels else 1


def beta_shapes(name):
    """The sweep's shapes of a Beta kernel: a wave's lanes and the
    priors phase's points; for ``beta_ppf`` also the switch's two sides
    (the most elements walked a warp an element, and one more)."""
    if name != "beta_ppf":
        return BETA_SHAPES
    return (256, beta_switch(), beta_switch() + 1, PRIOR_POINTS)


def beta_inputs(n, dtype, seed=SEED):
    """Seeded uniforms on the card, the edges first, each repeated once a
    pair (``i = k mod 25`` is pair k's at (2^20,))."""
    k = len(BETA_PAIRS)
    u = np.random.Generator(np.random.PCG64(seed)).random(n)
    u[:len(BETA_EDGES) * k] = np.repeat(BETA_EDGES, k)
    return torch.as_tensor(u, dtype=dtype, device="cuda")


def _same_or_nan(a, b):
    """Equal bits where both are numbers and NaN at the same places; and
    the largest difference."""
    na, nb = torch.isnan(a), torch.isnan(b)
    same = bool(a.shape == b.shape and torch.equal(na, nb) and
                torch.equal(a[~na], b[~nb]))
    both = ~(na | nb)
    diff = (a[both] - b[both]).abs()
    return same, float(diff.max()) if diff.numel() else 0.0


def _once_ms(fn):
    """CUDA-event ms of one call (the plain versions: ~1.5 s a call)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def plain_ops_per_element(fn, n):
    """The elementwise operations one element costs the plain version:
    the dispatched ops' outputs of ``n`` elements, counted while ``fn``
    runs, over ``n`` (the 0-d ops on the numbers a, b are per call)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor) and o.numel() == n:
                    Count.ops += n
            return out

    with Count():
        fn()
    return Count.ops / n


def beta_bounds(ops, n, dtype, tensors=2):
    """The least time of ``n`` elements: the operations at the type's
    rate, or ``tensors`` arrays of n read or written once at 3.35 TB/s;
    (bound_ms, bound_by, ops_ms, bytes_ms)."""
    ops_ms = 1e3 * ops * n / _RATE[dtype]
    bytes_ms = 1e3 * tensors * n * torch.finfo(dtype).bits / 8 / HBM_BYTES
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, ops_ms, bytes_ms


def beta_sweep(name, n, dtype):
    """One kernel over the 25 pairs at (n,): numbers a, b against the
    plain version with a and b per element, all in one plain call (at
    (256,) a (25, 256) batch, each pair over all of u; at (2^20,) the
    pairs cycling over u's elements, pair k held at i = k mod 25), which
    on the card gives the plain version's bits with numbers; Beta(2, 5)
    also against the plain version with numbers.  ``betainc`` also with
    its a and b as per-element tensors in one call."""
    k = len(BETA_PAIRS)
    u = beta_inputs(n, dtype)
    pa = torch.tensor([p[0] for p in BETA_PAIRS], dtype=dtype, device="cuda")
    pb = torch.tensor([p[1] for p in BETA_PAIRS], dtype=dtype, device="cuda")
    kern = bp.beta_ppf if name == "beta_ppf" else \
        (lambda x, a, b: bp.betainc(a, b, x))
    plain = bp.beta_ppf_plain if name == "beta_ppf" else \
        (lambda x, a, b: bp.betainc_plain(a, b, x))
    batch = n <= 4096
    if batch:
        a, b, x = pa[:, None], pb[:, None], u.expand(k, n)
    else:
        reps = -(-n // k)
        a, b, x = pa.repeat(reps)[:n], pb.repeat(reps)[:n], u
    want = plain(x, a, b)
    same, err, compared = True, 0.0, 0
    for i, (va, vb) in enumerate(BETA_PAIRS):
        got, ref = kern(u, va, vb), want[i] if batch else want[i::k]
        s, e = _same_or_nan(got if batch else got[i::k], ref)
        same, err, compared = same and s, max(err, e), compared + ref.numel()
    numbers, e = _same_or_nan(kern(u, 2.0, 5.0), plain(u, 2.0, 5.0))
    same, err = same and numbers, max(err, e)
    rec = {"kernel": name, "n": n, "dtype": str(dtype).split(".")[1],
           "pairs": k, "compared": compared, "numbers_case_equal": numbers,
           "equal": same, "max_abs_err": err,
           "levels": beta_levels(n) if name == "beta_ppf" else None}
    if name == "betainc":
        s, e = _same_or_nan(bp.betainc(a, b, x), want)
        rec["tensor_ab_equal"] = s
        rec["equal"], rec["max_abs_err"] = same and s, max(err, e)
    return rec


def beta_table_case(rows, dtype):
    """``beta_ppf`` over the mixed three-column table (``BETA_TABLE``) of
    a seeded (rows, 5) u, the edges in each column read, called directly
    and under ``torch.func.vmap`` (rows batched): against the plain
    version with a and b per element over the three columns in one call
    (on the card the numbers' bits), one launch a call."""
    cols, a, b = (list(c) for c in zip(*BETA_TABLE))
    u = torch.as_tensor(np.random.Generator(np.random.PCG64(SEED)).random(
        (rows, 5)), dtype=dtype, device="cuda")
    for c in cols:
        u[:len(BETA_EDGES), c] = torch.tensor(BETA_EDGES, dtype=dtype)
    want = bp.beta_ppf_plain(
        u[:, cols], torch.tensor(a, dtype=dtype, device="cuda"),
        torch.tensor(b, dtype=dtype, device="cuda"))
    n0 = bp.beta_ppf.launches
    direct = _same_or_nan(bp.beta_ppf_columns(u, cols, a, b), want)
    vmapped = _same_or_nan(torch.func.vmap(
        lambda r: bp.beta_ppf_columns(r, cols, a, b))(u), want)
    return {"kernel": "beta_ppf", "case": "table", "rows": rows,
            "n": rows * len(cols), "dtype": str(dtype).split(".")[1],
            "levels": beta_levels(rows * len(cols)),
            "launches": bp.beta_ppf.launches - n0,
            "equal": direct[0] and vmapped[0], "direct_equal": direct[0],
            "vmap_equal": vmapped[0], "max_abs_err": max(direct[1],
                                                         vmapped[1])}


def beta_level_sweep(card):
    """``beta_ppf``'s time (CUDA events, back to back) at Beta(2, 5), 50
    steps, for every level count of the walk (1 to 5) at element counts
    from a wave's 256 to 32 times the switch, float64 and float32,
    through the ctypes entry (timing launches: no wrapper counts them);
    every level count's output must have the same bits.  The data behind
    the level rule: prints each count's times, the rule's choice and the
    fastest."""
    import ctypes
    switch = beta_switch()
    shapes = (256, 768, 2048, switch, switch + 1, 4096, 4 * switch,
              4 * switch + 1, 8 * switch, 16 * switch, 32 * switch)
    table = ((ctypes.c_longlong * 1)(0), (ctypes.c_double * 1)(2.0),
             (ctypes.c_double * 1)(5.0))
    stream = torch.cuda.current_stream().cuda_stream
    recs = []
    for dtype in (torch.float64, torch.float32):
        f = bp._entry("beta_ppf", dtype)
        for n in shapes:
            u = beta_inputs(n, dtype)
            outs, ms = [], {}
            for levels in range(1, 6):
                out = torch.empty_like(u)

                def call():
                    if f(u.data_ptr(), 1, 0, out.data_ptr(), 1, n, 1,
                         *table, 50, levels, stream):
                        raise RuntimeError("beta_ppf launch refused")

                ms[levels] = _time_ms(call, 10 if n <= 4096 else 3)
                outs.append(out)
            same = all(_same_or_nan(o, outs[0])[0] for o in outs[1:])
            rec = {"n": n, "dtype": str(dtype).split(".")[1], "ms": ms,
                   "rule": beta_levels(n), "fastest": min(ms, key=ms.get),
                   "levels_equal": same}
            recs.append(rec)
            print(f"beta_ppf levels sweep ({n},) {rec['dtype']} Beta(2, 5)"
                  f": ms by levels " + ", ".join(
                      f"{lv}: {t:.4f}" for lv, t in ms.items()) +
                  f" (events); the rule takes {rec['rule']}, fastest "
                  f"{rec['fastest']}; outputs bit-identical across levels "
                  f"{same}  [{card}]")
    if not all(r["levels_equal"] for r in recs):
        raise RuntimeError(f"beta_ppf's level counts disagree: {recs}")
    return recs


# the plain version's elementwise operations an element, by kernel and
# dtype (counted once)
_BETA_OPS = {}


def beta_timed(name, n, dtype, floor_us):
    """The drive's Beta(2, 5) at (n,): the kernel's events ms (back to
    back), the plain version's (one call; ``betainc``'s three), the
    plain version's operations an element, the bounds; and the calls that
    phase 34 times device only (the kernel, and its one-thread chain: the
    kernel on one element)."""
    u = beta_inputs(n, dtype)
    one = u[-1:].clone()  # a seeded uniform, not an edge
    if name == "beta_ppf":
        call = lambda: bp.beta_ppf(u, 2.0, 5.0)  # noqa: E731
        chain = lambda: bp.beta_ppf(one, 2.0, 5.0)  # noqa: E731
        plain = lambda: bp.beta_ppf_plain(u, 2.0, 5.0)  # noqa: E731
        plain_ms = _once_ms(plain)
    else:
        call = lambda: bp.betainc(2.0, 5.0, u)  # noqa: E731
        chain = lambda: bp.betainc(2.0, 5.0, one)  # noqa: E731
        plain = lambda: bp.betainc_plain(2.0, 5.0, u)  # noqa: E731
        plain_ms = _time_ms(plain, 3)
    ms = _time_ms(call, 20 if n <= 4096 else 5)
    small = u[:256]
    if (name, dtype) not in _BETA_OPS:
        _BETA_OPS[name, dtype] = plain_ops_per_element(
            (lambda: bp.beta_ppf_plain(small, 2.0, 5.0))
            if name == "beta_ppf"
            else (lambda: bp.betainc_plain(2.0, 5.0, small)), 256)
    ops = _BETA_OPS[name, dtype]
    bound, by, ops_ms, bytes_ms = beta_bounds(ops, n, dtype)
    return {"kernel": name, "n": n, "dtype": str(dtype).split(".")[1],
            "levels": beta_levels(n) if name == "beta_ppf" else None,
            "a": 2.0, "b": 5.0, "ms": ms, "plain_ms": plain_ms,
            "chain_ms": _time_ms(chain, 10), "ops_per_element": ops,
            "bound_ms": bound, "bound_by": by, "ops_bound_ms": ops_ms,
            "bytes_bound_ms": bytes_ms, "launch_floor_us": floor_us,
            "call": call, "chain_call": chain}


def beta_vmap_replay(dtype):
    """The beta-prior drive's prior (three Betas) on a (256, 3) batch
    under ``torch.func.vmap``, and ``beta_ppf`` and ``betainc`` called
    directly: against the plain versions, then captured once in a CUDA
    graph (the wrappers count the capture's launches: the vmapped prior 1,
    its three Betas in one table, the direct calls 1 each) and replayed 20
    times, each replay's outputs zeroed before and the same bits after;
    and the vmapped prior's call for phase 34's device time."""
    from dynesty_tpu_torch import models
    pt = models.PriorTransform([models.Beta(a, b) for a, b in BETA_DRIVE_AB])
    u = torch.as_tensor(np.random.Generator(np.random.PCG64(SEED)).random(
        (256, 3)), dtype=dtype, device="cuda")
    u[0] = 0.0
    u[1] = 1.0
    want = torch.stack([bp.beta_ppf_plain(u[:, i].contiguous(), a, b)
                        for i, (a, b) in enumerate(BETA_DRIVE_AB)], 1)
    x = u[:, 0].contiguous()
    want_d = (bp.beta_ppf_plain(x, 2.0, 5.0), bp.betainc_plain(2.0, 5.0, x))
    n0 = bp.beta_ppf.launches
    vm_same, vm_err = _same_or_nan(torch.func.vmap(pt)(u), want)
    vm_launches = bp.beta_ppf.launches - n0
    counts0 = (bp.beta_ppf.launches, bp.betainc.launches)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        outs = (torch.func.vmap(pt)(u), bp.beta_ppf(x, 2.0, 5.0),
                bp.betainc(2.0, 5.0, x))
    captured = (bp.beta_ppf.launches - counts0[0],
                bp.betainc.launches - counts0[1])
    replays_same = 0
    for _ in range(20):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays_same += all(_same_or_nan(o, w)[0] for o, w in
                            zip(outs, (want,) + want_d))
    return {"dtype": str(dtype).split(".")[1], "vmap_equal": vm_same,
            "vmap_max_abs_err": vm_err, "vmap_launches": vm_launches,
            "captured_launches": list(captured), "replays": 20,
            "replays_equal": replays_same,
            "vmap_ms": _time_ms(lambda: torch.func.vmap(pt)(u), 10),
            "replay_ms": _time_ms(graph.replay, 20), "graph": graph,
            "vmap_call": lambda: torch.func.vmap(pt)(u)}


def beta_phase(card, floor_us):
    """Phase 2j: ``beta_ppf`` and ``betainc`` against their plain versions
    over the sweep at (256,) and (2^20,) (``beta_ppf`` also either side of
    its level switch, and its mixed three-column table at 256 rows and
    either side of the switch), float64 and float32, under vmap and
    replayed; then each kernel's time at the drive's Beta(2, 5) beside
    the plain version's and the bounds.  Raises where a bit differs or a
    call launched other than once."""
    lanes, switch = beta_lanes(), beta_switch()
    rule = [bp.beta_levels(n, lanes) for n in (switch, switch + 1)]
    print(f"beta_ppf level rule: {lanes} busy threads, a warp an "
          f"element up to {switch} elements (levels {rule[0]}), "
          f"{switch + 1}: levels {rule[1]}  [{card}]")
    sweep = [beta_sweep(name, n, dtype) for dtype in (torch.float64,
                                                      torch.float32)
             for name in BETA_KERNELS for n in beta_shapes(name)]
    for r in sweep:
        print(f"beta {r['kernel']} ({r['n']},) {r['dtype']}"
              + (f" levels {r['levels']}" if r["levels"] else "") +
              f": {r['pairs']} (a, b) pairs, {r['compared']} elements: "
              f"bit-identical {r['equal']} (Beta(2, 5) against the plain "
              f"version with numbers {r['numbers_case_equal']}"
              + (f", a and b per element {r['tensor_ab_equal']}"
                 if "tensor_ab_equal" in r else "") +
              f"), max_abs_err {r['max_abs_err']:.3e}  [{card}]")
    tables = [beta_table_case(rows, dtype)
              for dtype in (torch.float64, torch.float32)
              for rows in (256, switch // 3, switch // 3 + 1)]
    for r in tables:
        print(f"beta beta_ppf table {BETA_TABLE} ({r['rows']}, 5) "
              f"{r['dtype']}, {r['n']} elements, levels {r['levels']}: "
              f"bit-identical directly {r['direct_equal']}, under vmap "
              f"{r['vmap_equal']}, {r['launches']} launches in the two "
              f"calls, max_abs_err {r['max_abs_err']:.3e}  [{card}]")
    levels = beta_level_sweep(card)
    vr = [beta_vmap_replay(dt) for dt in (torch.float64, torch.float32)]
    for r in vr:
        print(f"beta under vmap (256, 3) {r['dtype']} (the beta-prior "
              f"drive's prior): bit-identical {r['vmap_equal']}, "
              f"{r['vmap_launches']} launches a call, {r['vmap_ms']:.4f} ms "
              f"(events); captured with the direct calls (beta_ppf, "
              f"betainc launches counted at the capture "
              f"{r['captured_launches']}), {r['replays_equal']}/"
              f"{r['replays']} replays bit-identical, a replay "
              f"{r['replay_ms']:.4f} ms  [{card}]")
    timed = [beta_timed(name, n, dtype, floor_us)
             for dtype in (torch.float64, torch.float32)
             for name in BETA_KERNELS for n in BETA_TIMED[name]]
    for r in timed:
        print(f"beta {r['kernel']} ({r['n']},) {r['dtype']} Beta(2, 5)"
              + (f" levels {r['levels']}" if r["levels"] else "") +
              f": kernel {1e3 * r['ms']:.2f} us (events), plain "
              f"{1e3 * r['plain_ms']:.1f} us, one-thread chain "
              f"{1e3 * r['chain_ms']:.2f} us (events), operations bound "
              f"{1e3 * r['ops_bound_ms']:.3f} us ({r['ops_per_element']:.0f}"
              f" plain ops an element), bytes bound "
              f"{1e3 * r['bytes_bound_ms']:.5f} us, launch floor "
              f"{r['launch_floor_us']:.2f} us (events)  [{card}]")
    bad = [r for r in sweep + tables if not r["equal"]] + \
        [r for r in tables if r["launches"] != 2] + \
        [r for r in vr if not (r["vmap_equal"] and
                               r["vmap_launches"] == BETA_DRIVE_LAUNCHES
                               and r["captured_launches"] ==
                               [BETA_DRIVE_LAUNCHES + 1, 1] and
                               r["replays_equal"] == r["replays"])]
    if rule != [5, 4]:
        bad.append({"level_rule": rule, "switch": switch})
    if bad:
        raise RuntimeError(f"the Beta kernels differ from their plain "
                           f"versions: {bad}")
    return {"sweep": sweep, "tables": tables, "vmap_replay": vr,
            "timed": timed, "lanes": lanes, "switch": switch,
            "level_sweep": levels}


class CountingPrior:
    """The user's prior transform, counting its calls on the card (eager,
    or recorded by a capture: a replay runs it without Python)."""

    def __init__(self, pt):
        self.pt, self.calls = pt, 0

    def __call__(self, u):
        self.calls += getattr(getattr(u, "device", None), "type",
                              None) == "cuda"
        return self.pt(u)


# the beta-prior drive's means on the card and its normalisation
_BETA = {}


def beta_loglike(x):
    return -0.5 * (((x - _BETA["mu"]) / BETA_SIGMA) ** 2).sum() + \
        _BETA["lnorm"]


def beta_truth():
    """log Z: the product of each dimension's Beta density and Gaussian,
    integrated by ``scipy.integrate.quad`` over [0, 1]."""
    import scipy.integrate as si
    import scipy.stats as st

    out = 0.0
    for (a, b), mu in zip(BETA_DRIVE_AB, BETA_MU):
        v, _ = si.quad(lambda x: st.beta.pdf(x, a, b) *
                       st.norm.pdf(x, mu, BETA_SIGMA), 0.0, 1.0,
                       points=[mu], limit=200)
        out += math.log(v)
    return out


def beta_prior_drive(dyt, hk, card, keep):
    """Phase 27b: ``NestedSampler(beta_loglike, PriorTransform([Beta(2,
    5), Beta(0.5, 0.5), Beta(5, 2)]), 3, nlive=2048)``, every other
    argument at its default, on the card, counts from zero: the evidence
    within 4 logzerr of the quadrature's, no capture warning, every wave
    but one warm-up a shape replayed, ``beta_ppf`` launched once a prior
    call on the card (the three Betas in one table; the eager calls and
    every replay), no ``betainc``, and each captured wave holding
    ``beta_ppf`` in one of its kernel nodes.  Returns the summary and the
    last captured wave; the sampler goes to ``keep`` (phase 34 replays
    that wave)."""
    from dynesty_tpu_torch import models
    _BETA["mu"] = torch.tensor(BETA_MU, dtype=torch.float64, device="cuda")
    _BETA["lnorm"] = -len(BETA_MU) * math.log(BETA_SIGMA *
                                              math.sqrt(2 * math.pi))
    truth = beta_truth()
    prior = CountingPrior(models.PriorTransform(
        [models.Beta(a, b) for a, b in BETA_DRIVE_AB]))
    _zero_counts(hk)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler = dyt.NestedSampler(
            beta_loglike, prior, len(BETA_MU), nlive=BETA_NLIVE,
            rstate=np.random.Generator(np.random.PCG64(SEED)))
        if sampler.device.type != "cuda":
            raise RuntimeError(f"the default device is {sampler.device}")
        sampler.run_nested(print_progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    s = _summary(sampler, wall, truth, bootstrap=sampler.bound_bootstrap)
    s["nells"] = int(getattr(sampler.bound, "nells", 1))
    s["max_last_expand"] = None
    _gate(sampler, s, "the beta-prior drive")
    keep.append(sampler)
    n = s["launches"] = _counts(hk)
    warned = [str(w.message) for w in caught
              if "could not be captured" in str(w.message)]
    runs = prior.calls - n["n_unif_graph"] + n["n_unif_replay"]
    s["prior_calls"] = {"python": prior.calls, "on_card": runs}
    waves = [g for g in _UNIF_GRAPHS if g.graph is not None]
    nodes = _graph_nodes(waves[-1].graph) if waves else []
    s["wave_kernels"] = check_replay_kernels(
        waves[-1].counted, waves[-1].graph, "the beta-prior drive's "
        "captured wave", nodes) if waves else {}
    s["wave_nodes"] = len(nodes)
    s["capture_warnings"] = warned
    cfg = s["config"]
    if warned or (cfg["bound"], cfg["sample"]) != ("multi", "unif") or \
            n["n_uncaptured"] != n["unif_warmups"] or \
            n["n_slice_graph"] + n["n_rwalk_graph"] + \
            n["n_doubling_graph"] != 0 or \
            n["beta_ppf"] != BETA_DRIVE_LAUNCHES * runs or \
            n["betainc"] != 0 or n["n_unif_replay"] < 1 or \
            s["wave_kernels"].get("beta_ppf") != BETA_DRIVE_LAUNCHES:
        raise RuntimeError(f"the beta-prior drive did not run its waves "
                           f"through the Beta kernel as captured: {s}")
    _print_unif_drive(f"beta-prior multi/unif nlive={BETA_NLIVE} (Beta(2, "
                      f"5), Beta(0.5, 0.5), Beta(5, 2))", s, card)
    print(f"  beta-prior: beta_ppf {n['beta_ppf']} = {BETA_DRIVE_LAUNCHES} x "
          f"{runs} prior calls "
          f"on the card ({prior.calls} from Python - {n['n_unif_graph']} "
          f"captures + {n['n_unif_replay']} replays); waves "
          f"{n['unif_waves']} (replays {n['n_unif_replay']}, warm-ups "
          f"{n['unif_warmups']}, n_uncaptured {n['n_uncaptured']}, "
          f"n_unif_graph {n['n_unif_graph']}); capture warnings "
          f"{len(warned)}; one captured wave: {s['wave_nodes']} kernel "
          f"nodes, hand-written {s['wave_kernels']}; Timings "
          f"{json.dumps(s['timings'])}  [{card}]")
    return s, waves[-1]


STAY = ("niter", "ncall", "logz", "logzerr")


def record_drives(rec):
    """A ``--out`` record's drives: ``{name: entry}`` for every entry with
    a ``niter``."""
    return {k: v for k, v in rec.items()
            if isinstance(v, dict) and "niter" in v}


def compare_records(parent, change, moving):
    """Two ``--out`` records (a parent's and a change's, from the same
    card type) drive by drive: for every drive of the parent, ``niter``,
    ``ncall``, ``logz`` and ``logzerr`` (exactly: the runs are
    deterministic on one kind of card) and every integer count in its
    ``timings`` and ``launches``.  Counts named in ``moving`` may
    differ.
    Returns (fields compared, {drive: {field: (parent, change)}} of the
    fields that must stay, the same of the moving ones)."""
    n, bad, moved = 0, {}, {}
    for name, p in record_drives(parent).items():
        c = record_drives(change).get(name)
        if c is None:
            bad[name] = {"drive": ("present", "absent")}
            continue
        pairs = [(k, p[k], c.get(k)) for k in STAY if k in p]
        for group in ("timings", "launches"):
            for k, v in p.get(group, {}).items():
                if isinstance(v, int) and not isinstance(v, bool):
                    pairs.append((f"{group}.{k}", v,
                                  c.get(group, {}).get(k)))
        for k, a, b in pairs:
            n += 1
            if a != b:
                out = moved if k.split(".")[-1] in moving else bad
                out.setdefault(name, {})[k] = (a, b)
    return n, bad, moved


def report_compare(parent, change, moving):
    """:func:`compare_records`, printed: one line a drive that differs
    and one JSON line of the totals.  Returns whether a field that must
    stay differs."""
    n, bad, moved = compare_records(parent, change, set(moving.split(",")))
    for what, diffs in (("differs", bad), ("moved", moved)):
        for name, fields in diffs.items():
            print(f"compare: {name} {what}: {json.dumps(fields)}")
    # a doubling drive's doubling_point against its segments: the start's
    # two end probes are the change's only ones
    for name, fields in moved.items():
        if "launches.doubling_point" in fields:
            a, b = fields["launches.doubling_point"]
            seg = record_drives(change)[name]["launches"]
            print(f"compare: {name} doubling_point {a} -> {b} (fell by "
                  f"{a - b}; seg_double + seg_candidate "
                  f"{seg['seg_double'] + seg['seg_candidate']}, 2 x "
                  f"seg_start {2 * seg['seg_start']})")
    print(json.dumps({"compare": {
        "drives": len(record_drives(parent)), "fields": n,
        "differ": sum(len(v) for v in bad.values()),
        "moved": sum(len(v) for v in moved.values())}}))
    return bool(bad)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement here")
    ap.add_argument("--compare", nargs="+", metavar="RECORD",
                    help="PARENT.json: hold this run's drives against a "
                    "parent's --out record and fail where a field that "
                    "must stay differs; PARENT.json CHANGE.json: compare "
                    "two records only, with no card (compare_records)")
    ap.add_argument("--moving", default="sync_round",
                    help="with --compare: comma-separated counts that may "
                    "differ (listed with both values)")
    ap.add_argument("--parent", metavar="DIR",
                    help="also time the hand-written kernels and captured "
                         "segments of the checkout at DIR and of this one "
                         "in turns (bench_kernels.py in a process each), "
                         "printed in phase 34 beside this run's times")
    ap.add_argument("--profile", nargs="?", const="balls",
                    choices=["balls", "heavy"],
                    help="profile one drive (device time by kernel): the "
                    "balls drive (the default) or the heavy one")
    args = ap.parse_args()
    if args.compare and len(args.compare) > 1:
        records = []
        for path in args.compare[:2]:
            with open(path) as f:
                records.append(json.load(f))
        sys.exit(1 if report_compare(*records, args.moving) else 0)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dynesty_tpu_torch as dyt
    from dynesty_tpu_torch.ops import build
    from dynesty_tpu_torch.internal import kernels as tk
    from dynesty_tpu_torch.ops import hopper_kernels as hk

    # every captured graph keeps its nodes: phase 34 reads a replay's
    # kernels from them (check_replay_kernels)
    tk._RoundGraph.keep_nodes = True
    from dynesty_tpu_torch.internal import fused as tf
    tf.RoundGraphs.keep_nodes = True
    card = _card()
    device_kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    # the library yardstick's matmul form in full float32
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 1: build every kernel of the path from the checkout's sources,
    # one nvcc for each, all started together
    t0 = time.perf_counter()
    libs = ("pairwise_min_dist", "consume_scan", "slice_step", "rwalk_step",
            "unif_wave", "slice_doubling", "round_assemble",
            "ellipsoid_refit", "beta_prior")
    with ThreadPoolExecutor(len(libs)) as ex:
        for fut in [ex.submit(build.load_library, name) for name in libs]:
            fut.result()
    for name in libs:
        log = build.build_log[name]
        print(f"build {name}: nvcc {log['seconds']:.2f} s")
        print(log["output"].strip())
    print(f"build: {time.perf_counter() - t0:.2f} s")
    friends_regs = friends_registers(build.build_log["unif_wave"]["output"])
    if not friends_regs:
        raise RuntimeError("no friends kernel in unif_wave's build report")
    for key, by_nx in friends_regs.items():
        print(f"unif_valid friends {key} registers/spill bytes (stores, "
              f"loads) by candidate width (0: the generic loop): " +
              ", ".join(f"{nx}: {r}/{st},{ld}" for nx, (r, st, ld) in
                        sorted(by_nx.items())) + f"  [{card}]")
    beta_regs = beta_registers(build.build_log["beta_prior"]["output"])
    print("beta_prior registers/spill bytes (stores, loads): " +
          ", ".join(f"{k}: {r[0]}/{r[1]},{r[2]}"
                    for k, r in sorted(beta_regs.items())) + f"  [{card}]")
    count_rounds()
    count_proposal_loops()

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

    # phase 2b: the consume scan against its plain version, round by
    # round, on the same inputs
    consume, consume_calls = consume_phase(card)

    # phase 2c: the proposal loops' per-step kernels against their plain
    # versions, output by output, and the floor of a launch
    steps, step_calls = proposal_steps_phase(card)
    floor_call, floor = launch_floor()
    print(f"launch floor: an empty kernel of one block through the step "
          f"kernels' entry path {floor['us']:.2f} us per call (events, back "
          f"to back)  [{card}]")

    # phase 2d: captured slice rounds against eager-launched rounds
    captured, captured_graph = captured_slice_phase(card)

    # phase 2e: captured walk rounds against eager-launched rounds
    captured_rwalk = captured_rwalk_phase(card, dyt)

    # phase 2f: the uniform wave's kernels against their plain versions,
    # and captured uniform waves against eager-launched ones
    unif_cases, unif_calls = unif_kernels_phase(card)
    captured_unif, unif_timed, friends_timed = captured_unif_phase(card)

    # phase 2g: the doubling round's kernels against their plain versions,
    # and captured doubling rounds against eager-launched ones
    doubling_cases, doubling_calls = doubling_kernels_phase(card)
    captured_doubling, doubling_timed = captured_doubling_phase(card)

    # phase 2h: the round's record and live assembly against its plain
    # version
    assemble_cases = round_assemble_phase(card)

    # phase 2i: the ellipsoid refit of a chained unif round against its
    # plain version
    refit_cases = refit_phase(card)

    # phase 2j: the Beta prior's kernels against their plain versions,
    # under vmap and replayed
    beta = beta_phase(card, floor["us"])
    beta["registers"] = beta_regs

    # phase 3: the main path, with launch counts zeroed just before
    _gauss_setup()
    prof = new_profile(args.profile == "balls")
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        main, main_sampler = drive(dyt, 2048, "balls", profile=prof)
    main["launches"] = _counts(hk)
    main["refit_max_abs_err"] = check_refits(hk, calls, "balls drive")
    if main["launches"]["exact"] < 1 or main["launches"]["consume"] < 1:
        raise RuntimeError(f"the balls drive did not launch every kernel "
                           f"of its path: {main['launches']}")
    _print_drive("main balls/rslice nlive=2048", main, main["launches"],
                 card)
    print(f"balls refits against the plain version: max abs err "
          f"{main['refit_max_abs_err']:.3e}")
    print(f"timings: {json.dumps(main['timings'])}")
    report_profile(prof, main)

    # phase 3b: the main path's fused rounds with their prologue and
    # epilogue eager, then captured
    captured_round = captured_round_phase(dyt, card)

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

    # phase 4b: balls-unif and cubes-unif, the main drive's problem and
    # width sampled uniformly in its friends bound (bootstrap 5: the radius
    # on the host), every wave through unif_valid's friends mode
    friends_drives = {bound: friends_drive(dyt, hk, bound, card)
                      for bound in FRIENDS}

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
    single["launches"] = _counts(hk)
    _print_drive("single/rslice nlive=500", single, single["launches"], card)

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
    # the samplers whose captured graphs phase 34 replays, kept alive to
    # it (a replay reads their arrays)
    kept_samplers = []
    heavy = unif_drive(dyt, like, H_TRUTH, profile=prof, keep=kept_samplers,
                       nlive=H_NLIVE, bound="multi", sample="unif",
                       queue_size=H_QUEUE, rounds_per_dispatch=H_ROUNDS)
    heavy["launches"] = _counts(hk)
    if hk.pairwise_min_dist.launches != 0:
        raise RuntimeError("the multi/unif drive launched the friends "
                           "kernel")
    # its ellipsoid wave, captured, for the last phase's device time
    heavy_wave = next((g for g in reversed(_UNIF_GRAPHS) if
                       g.kind == "ellipsoids" and g.graph is not None), None)
    if heavy_wave is None:
        raise RuntimeError("the heavy drive captured no ellipsoid wave")
    # and a captured prologue of one of its ellipsoid rounds (the refit)
    heavy_round = next((g for g in reversed(_ROUND_GRAPHS) if
                        g.prologue is not None and
                        getattr(g.entry, "kind", None) == "ellipsoids"),
                       None)
    if heavy_round is None:
        raise RuntimeError("the heavy drive captured no ellipsoid round")
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
    times, rwalk_entry = rwalk_round_times(dyt)
    rwalk.update(times)
    rounds = rwalk["launches"]["rwalk_rounds"]
    print(f"rwalk drive, per round of {rwalk['config']['queue_size']} lanes "
          f"(events, back to back): {rwalk['config']['walks']} walk steps "
          f"eager {rwalk['rwalk_round_ms']:.2f} ms, replayed "
          f"{rwalk['replay_round_ms']:.2f} ms (the replay alone "
          f"{rwalk['replay_events_ms']:.3f} ms; one likelihood call "
          f"{rwalk['likelihood_call_ms']:.3f} ms); host clock with its "
          f"wait: eager {rwalk['eager_round_host_ms']:.2f} ms, replayed "
          f"{rwalk['replay_round_host_ms']:.2f} ms; thin consume "
          f"{rwalk['consume_round_ms']:.2f} ms; x {rounds} walk rounds = "
          f"{rounds * rwalk['replay_round_ms'] / 1e3:.3f} s replayed "
          f"(eager {rounds * rwalk['rwalk_round_ms'] / 1e3:.3f} s) of the "
          f"drive's {rwalk['timings']['dispatch']:.3f} s dispatch  [{card}]")

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
    doubling, _ = doubling_drive(dyt, 500, "single")
    doubling["launches"] = _counts(hk)
    _print_drive("single/rslice doubling nlive=500", doubling,
                 doubling["launches"], card)

    # phase 11b: the doubling form at the main path's width, over
    # RadFriends: its refits reach the exact L2 path
    _zero_counts(hk)
    with recording_refits(dyt, hk) as calls:
        dballs, _ = doubling_drive(dyt, 2048, "balls")
    dballs["launches"] = _counts(hk)
    dballs["refit_max_abs_err"] = check_refits(hk, calls,
                                               "doubling-balls drive")
    if dballs["launches"]["exact"] < 1:
        raise RuntimeError("the doubling-balls drive never launched the "
                           "exact path")
    _print_drive("doubling-balls balls/rslice doubling nlive=2048", dballs,
                 dballs["launches"], card)
    for name, d in (("doubling", doubling), ("doubling-balls", dballs)):
        n = d["launches"]
        print(f"{name}: segments {n['doubling_reads'] - n['doubling_steps']}"
              f" (start {n['seg_start']}, double {n['seg_double']}, "
              f"candidate {n['seg_candidate']}, halve {n['seg_halve']}, "
              f"resolve {n['seg_resolve']}) = replays "
              f"{n['n_doubling_replay']} + warm-ups {n['doubling_eager']}; "
              f"dispatch {d['timings']['dispatch']:.3f} s over "
              f"{d['timings']['sync_slice']} sync_slice  [{card}]")

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
    # host mode: every wave eager
    hostpool["launches"] = _counts(hk, eager=True)
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
    customresume["launches"] = _counts(hk, custom=True)
    if customresume["launches"]["launches"] != 0:
        raise RuntimeError("the custom-resume drive launched the NN kernel")
    del cu_sampler
    _print_phase("custom-resume", customresume, card)

    # phase 23: the plots of the balls drive and of dynamic3
    plots = plots_phase(dyt, main_sampler.results, dyn3_results)
    print(json.dumps(dict({"phase": "plots", "card": card}, **plots)))

    # phases 24 and 25: the JAX package's eggbox and shells rows, problems
    # from dynesty_tpu_torch.models
    rows = {}
    for name, cls_name, dlogz in MODEL_ROWS:
        rows[name] = model_drive(dyt, dyt.models, hk, cls_name, dlogz)
        _print_phase(name, rows[name], card)

    # phase 26: eggbox-balls, the eggbox through the friends refit's kernel
    eggballs = eggbox_balls_drive(dyt, dyt.models, hk)
    _print_phase("eggbox-balls", eggballs, card)

    # phase 27: the six priors on the card against scipy, betainc; the
    # Beta kernels' launches counted from zero
    _zero_counts(hk)
    priors = priors_phase(dyt.models)
    priors["launches"] = {w.__name__: w.launches for w in bp.WRAPPERS}
    print(json.dumps(dict({"phase": "priors", "card": card}, **priors)))

    # phase 27b: beta-prior, a sampler whose prior is three Betas: every
    # wave's prior through the Beta kernel, replayed
    beta_drive, beta_wave = beta_prior_drive(dyt, hk, card, kept_samplers)

    # phases 28 and 29: the balls drive and dynamic3 under mesh=make_mesh()
    meshballs = mesh_balls_drive(dyt, hk, main, main_sampler)
    _print_phase("mesh-balls", meshballs, card)
    meshdyn3 = mesh_dynamic3_drive(dyt, hk, dyn3, dyn3_results)
    _print_phase("mesh-dynamic3", meshdyn3, card)

    # phase 30: the split likelihood's throughput on the one card
    scaling = scaling_phase(dyt, like)
    print(json.dumps({"phase": "scaling", "card": card, **scaling}))

    # phase 31: pipeline-resume, the default path stopped right after a
    # deferred refit moved the bound, resumed on the card
    _zero_counts(hk)
    piperesume = pipeline_resume_drive(dyt)
    piperesume["launches"] = _counts(hk)
    if hk.pairwise_min_dist.launches != 0:
        raise RuntimeError("the pipeline-resume drive launched the NN "
                           "kernel")
    print(json.dumps(dict({"phase": "pipeline-resume", "card": card},
                          **piperesume)))

    # phase 32: the quickstart example on the card, its waves replayed
    _zero_counts(hk)
    example = example_quickstart_phase()
    example["launches"] = _counts(hk)
    print(json.dumps(dict({"phase": "example-quickstart", "card": card},
                          **example)))

    # phase 32b: a likelihood that copies a host constant at every call:
    # warned once a wave shape, every wave eager
    _zero_counts(hk)
    uncapturable = uncapturable_phase(dyt)
    uncapturable["launches"] = _counts(hk, raised=True)
    # and a doubling segment whose capture raises after another's was
    # captured (outside the counted window: its shape mixes by design
    # until the raise)
    uncapturable["partial_capture"] = partial_capture_phase(dyt)
    print(json.dumps(dict({"phase": "uncapturable", "card": card},
                          **uncapturable)))

    # phase 33: queue-balls, the balls drive in queue mode: the consume
    # kernel's general path on a drive, held against the plain loop
    queueballs = queue_balls_drive(dyt, hk)
    _print_drive("queue-balls balls/rslice queue nlive=2048", queueballs,
                 queueballs["launches"], card)
    print(json.dumps({"phase": "queue-balls", "card": card,
                      "consume_shapes": queueballs["consume_shapes"],
                      "ncall_unrecorded": queueballs["ncall_unrecorded"],
                      "plain_replay": queueballs["plain_replay"]}))

    # phase 34: device-only times, last: once a profiler has run, every
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
    for name, fn in step_calls.items():
        rec = main_step(steps, name)
        rec["device_us"] = 1e3 * _device_ms(fn)
        print(f"proposal step {name} {tuple(rec['shape'])} float64 device "
              f"only: kernel {rec['device_us']:.3f} us  events (through "
              f"the wrapper) {rec['us']:.2f} us  bound "
              f"{rec['bound_us']:.5f} us  [{card}]")
    floor["device_us"] = 1e3 * _device_ms(floor_call)
    print(f"launch floor ({floor['blocks']} empty blocks) device only: "
          f"{floor['device_us']:.3f} us  events {floor['us']:.2f} us  "
          f"[{card}]")
    rwalk["replay_device_ms"] = _device_ms(rwalk_entry.graph.replay, 5)
    print(f"captured-rwalk replay (256, 15) float64 device only: "
          f"{rwalk['replay_device_ms']:.3f} ms (every kernel of "
          f"{rwalk['config']['walks']} steps, the likelihood's included); "
          f"the whole round by events {rwalk['replay_round_ms']:.3f} ms, "
          f"host with its wait {rwalk['replay_round_host_ms']:.3f} ms, "
          f"eager {rwalk['eager_round_host_ms']:.3f} ms  [{card}]")
    ct = captured["timing"]
    ct["replay_device_us"] = 1e3 * _device_ms(captured_graph.graph.replay)
    ev = {k: main_step(steps, k)["us"] for k in ("slice_propose",
                                                  "slice_advance")}
    print(f"captured-slice replay (256, 3) float64 device only: "
          f"{ct['replay_device_us']:.3f} us (every kernel of one "
          f"iteration, the likelihood's included); host with its wait and "
          f"flag read {ct['replay_host_us']:.2f} us, eager iteration "
          f"{ct['eager_iteration_host_us']:.2f} us; per launch through the "
          f"wrapper (events): slice_propose {ev['slice_propose']:.2f} us, "
          f"slice_advance {ev['slice_advance']:.2f} us  [{card}]")
    for name, fn in unif_calls.items():
        rec = main_unif(unif_cases, name)
        rec["device_us"] = 1e3 * _device_ms(fn, only=name)
        print(f"unif wave {name} cube (256, 3) float64 device only: kernel "
              f"{rec['device_us']:.3f} us  events (through the wrapper) "
              f"{rec['us']:.2f} us  bound {rec['bound_us']:.5f} us  launch "
              f"floor {floor['device_us']:.3f} us  [{card}]")
    for m, fn in _UNION_CALLS.items():
        rec = union_unif(unif_cases, m)
        rec["device_us"] = 1e3 * _device_ms(fn, only="unif_valid")
        print(f"unif wave unif_valid ellipsoids m {m} (256, 3) float64 "
              f"device only: kernel {rec['device_us']:.3f} us  events "
              f"(through the wrapper) {rec['us']:.2f} us  bound "
              f"{rec['bound_us']:.5f} us ({rec['bound_by']})  launch floor "
              f"{floor['device_us']:.3f} us  [{card}]")
    main_asm = assemble_cases[0]
    print(f"round_assemble (2048, 256) thin float64 device only: both "
          f"launches {1e3 * main_asm['device_ms']:.3f} us (records "
          f"{1e3 * main_asm['records_device_ms']:.3f}, refill "
          f"{1e3 * main_asm['refill_device_ms']:.3f})  events "
          f"{1e3 * main_asm['ms']:.2f} us  bound "
          f"{1e3 * main_asm['bound_ms']:.5f} us  launch floor "
          f"{floor['device_us']:.3f} us  [{card}]")
    for rec in refit_cases:
        call = rec.pop("call", None)
        if call is None:
            continue
        rec["device_ms"] = _device_ms(call, only="refit_")
        for kernel in REFIT_KERNELS:
            rec[f"{kernel}_device_ms"] = _device_ms(call, only=kernel)
        each = "  ".join(
            f"{kernel} {1e3 * rec[f'{kernel}_device_ms']:.3f} us (bound "
            f"{1e3 * rec[f'{kernel}_bound_ms']:.5f} us, "
            f"{rec[f'{kernel}_bound_by']})" for kernel in REFIT_KERNELS)
        print(f"ellipsoid refit {rec['name']} ({rec['n']}, {rec['m']} slots, "
              f"d {rec['d']}) float64 device only: both kernels "
              f"{1e3 * rec['device_ms']:.3f} us: {each}  events "
              f"{1e3 * rec['ms']:.2f} us  plain {1e3 * rec['plain_ms']:.1f} "
              f"us  launch floor {floor['device_us']:.3f} us a kernel  "
              f"[{card}]")
    # the refit inside heavy's captured round prologue: each kernel in as
    # many of the prologue's nodes as its capture counted, once
    pro_nodes = _graph_nodes(heavy_round.prologue)
    heavy["prologue_kernels"] = check_replay_kernels(
        (None, [(w, n) for w, k, n in heavy_round.counted["prologue"]
                if k == "launches"]),
        heavy_round.prologue, "heavy's captured round prologue", pro_nodes)
    if heavy["prologue_kernels"] != dict.fromkeys(REFIT_KERNELS, 1):
        raise RuntimeError(f"heavy's captured round prologue launches "
                           f"{heavy['prologue_kernels']} of the refit")
    heavy["prologue_replay_device_ms"] = _device_ms(
        heavy_round.prologue.replay, 5)
    print(f"heavy's captured round prologue "
          f"{tuple(heavy_round.entry.rb.arrays['ctrs'].shape)} float64 "
          f"device only: {1e3 * heavy['prologue_replay_device_ms']:.3f} us "
          f"(the round gate, the threshold's sort, the refit, the wave's "
          f"start); hand-written kernels a replay (graph nodes) "
          f"{heavy['prologue_kernels']}  [{card}]")
    parent = parent_times(args.parent, card) if args.parent else None
    cu = captured_unif["timing"]
    cu["replay_device_us"] = 1e3 * _device_ms(unif_timed.graph.replay)
    heavy["wave_replay_device_ms"] = _device_ms(heavy_wave.graph.replay, 5)
    cube_nodes = _graph_nodes(unif_timed.graph)
    cu["replay_kernels"] = check_replay_kernels(
        unif_timed.counted, unif_timed.graph,
        "the captured cube wave", cube_nodes)
    # the friends' waves: unif_valid's friends mode once a replay, and
    # none of the eager union's launches left in the graph
    cu["friends"] = {}
    for fkind, wave in friends_timed.items():
        rec = friends_wave_kernels(wave, fkind, cube_nodes)
        rec["replay_device_us"] = 1e3 * _device_ms(wave.graph.replay)
        cu["friends"][fkind] = rec
        print(f"captured-unif {fkind} wave (256, 2048 centres, 3) float64 "
              f"replay device only: {rec['replay_device_us']:.3f} us; "
              f"hand-written kernels a replay (graph nodes) "
              f"{rec['kernels']}; {rec['nodes']} kernel nodes (the cube "
              f"wave's {rec['cube_nodes']}), matrix products, gathers, "
              f"reductions {rec['ops']} (the cube wave's "
              f"{rec['cube_ops']})  [{card}]")
        print(f"  kernels: {rec['names']}")
    for fcase, fn in _FRIENDS_CALLS.items():
        rec = friends_unif(unif_cases, *fcase)
        rec["device_us"] = 1e3 * _device_ms(fn, only="unif_valid")
        print(f"unif wave unif_valid {fcase[0]} N {fcase[1]} (256, "
              f"{fcase[2]}) {fcase[3]} device only: kernel "
              f"{rec['device_us']:.3f} us  "
              f"events (through the wrapper) {rec['us']:.2f} us  plain "
              f"{rec['plain_us']:.1f} us  bound {rec['bound_us']:.5f} us "
              f"({rec['bound_by']}), issue bound "
              f"{rec['issue_bound_us']:.5f} us  ({rec['lanes']} of 256 "
              f"lanes in the cube)  grid {rec['chunks']} chunks "
              f"of {rec['per']}  launch floor {floor['device_us']:.3f} "
              f"us  [{card}]")
    heavy["wave_replay_kernels"] = check_replay_kernels(
        heavy_wave.counted, heavy_wave.graph,
        "heavy's captured ellipsoid wave")
    print(f"captured-unif replay (256, 3) float64 device only: "
          f"{cu['replay_device_us']:.3f} us (every kernel of one wave, the "
          f"likelihood's included); host with its wait and flag read "
          f"{cu['replay_host_us']:.2f} us, eager wave "
          f"{cu['eager_wave_host_us']:.2f} us; heavy's ellipsoid wave "
          f"{tuple(heavy_wave.rb.arrays['ctrs'].shape)} replayed, device "
          f"only {heavy['wave_replay_device_ms']:.3f} ms; hand-written "
          f"kernels a replay (graph nodes) {cu['replay_kernels']}, heavy's "
          f"{heavy['wave_replay_kernels']}  [{card}]")
    for name, fn in doubling_calls.items():
        rec = main_doubling(doubling_cases, name)
        rec["device_us"] = 1e3 * _device_ms(fn, only=name)
        print(f"doubling {name} (256, 3) float64 device only: kernel "
              f"{rec['device_us']:.3f} us  events (through the wrapper) "
              f"{rec['us']:.2f} us  bound {rec['bound_us']:.5f} us  launch "
              f"floor {floor['device_us']:.3f} us  [{card}]")
    for (name, mode), fn in _MODE_CALLS.items():
        rec = main_doubling(doubling_cases, name)
        rec.setdefault("mode_device_us", {})[mode] = 1e3 * _device_ms(
            fn, only=name)
        print(f"doubling {name} mode {mode} (256, 3) float64 device only: "
              f"kernel {rec['mode_device_us'][mode]:.3f} us  bound "
              f"{rec['mode_bound_us'][mode]:.5f} us (bytes)  launch floor "
              f"{floor['device_us']:.3f} us  [{card}]")
    cd = captured_doubling["timing"]["segments"]
    for name in DOUBLING_SEGMENTS:
        graph = doubling_timed.graphs[name]
        cd[name]["replay_device_us"] = 1e3 * _device_ms(graph.replay)
        # the graph's own kernels: the drives' replay counts are what the
        # capture counted; doubling_point only at the step's start (its
        # two end probes), the halving's doubling_halve once, and no draw
        # in a candidate's segment
        nodes = _graph_nodes(graph)
        cd[name]["replay_kernels"] = check_replay_kernels(
            doubling_timed.counts[name], graph,
            f"the captured doubling segment {name}", nodes)
        # torch's uniform_ (distribution_elementwise_grid_stride_kernel)
        cd[name]["replay_draws"] = sum(
            "distribution_elementwise" in node for node in nodes)
        k = cd[name]["replay_kernels"]
        if k["doubling_point"] != (2 if name == "start" else 0) or (
                name == "halve" and k["doubling_halve"] != 1) or (
                cd[name]["replay_draws"] != {"start": 2, "double": 1,
                                             "resolve": 1}.get(name, 0)):
            raise RuntimeError(f"the captured doubling segment {name} "
                               f"launched {k}, "
                               f"{cd[name]['replay_draws']} draws")
        print(f"captured-doubling replay of segment {name} (256, 3) float64 "
              f"device only: {cd[name]['replay_device_us']:.3f} us (every "
              f"kernel of the segment, the likelihood's included); host "
              f"with its wait and flag read {cd[name]['replay_host_us']:.2f}"
              f" us, eager {cd[name]['eager_host_us']:.2f} us; "
              f"hand-written kernels a replay (graph nodes) "
              f"{cd[name]['replay_kernels']}, draws "
              f"{cd[name]['replay_draws']}  [{card}]")
    consume_device_times(consume, consume_calls, card)
    for r in beta["timed"]:
        name = r["kernel"]
        r["device_ms"] = _device_ms(r.pop("call"), 20 if r["n"] <= 4096
                                    else 5, only=f"{name}_kernel")
        r["chain_device_ms"] = _device_ms(r.pop("chain_call"), 10,
                                          only=f"{name}_kernel")
        r["launch_floor_device_us"] = floor["device_us"]
        r["bound_share"] = r["bound_ms"] / r["device_ms"]
        print(f"beta {name} ({r['n']},) {r['dtype']} Beta(2, 5) device "
              f"only: kernel {1e3 * r['device_ms']:.2f} us  events "
              f"{1e3 * r['ms']:.2f} us  plain {1e3 * r['plain_ms']:.1f} us  "
              f"one-thread chain {1e3 * r['chain_device_ms']:.2f} us  "
              f"operations bound {1e3 * r['ops_bound_ms']:.3f} us  bytes "
              f"bound {1e3 * r['bytes_bound_ms']:.5f} us  bound share "
              f"{r['bound_share']:.4f}  launch floor "
              f"{floor['device_us']:.3f} us  [{card}]")
    for r in beta["vmap_replay"]:
        graph = r.pop("graph")
        r["replay_device_ms"] = _device_ms(graph.replay, 10)
        call = r.pop("vmap_call")
        r["vmap_device_ms"] = _device_ms(call, 10)
        r["vmap_beta_device_ms"] = _device_ms(call, 10,
                                              only="beta_ppf_kernel")
        print(f"beta captured (256, 3) prior and direct calls {r['dtype']} "
              f"replay device only: {1e3 * r['replay_device_ms']:.2f} us; "
              f"the vmapped prior alone {1e3 * r['vmap_device_ms']:.2f} us, "
              f"its beta_ppf {1e3 * r['vmap_beta_device_ms']:.2f} us  "
              f"[{card}]")
    beta_drive["wave_replay_device_ms"] = _device_ms(beta_wave.graph.replay,
                                                     5)
    beta_drive["wave_beta_device_ms"] = _device_ms(
        beta_wave.graph.replay, 5, only="beta_ppf_kernel")
    print(f"beta-prior's captured wave {tuple(beta_wave.rb.u_prop.shape)} "
          f"replay device only: {beta_drive['wave_replay_device_ms']:.3f} ms"
          f", of which its {beta_drive['wave_kernels']['beta_ppf']} "
          f"beta_ppf nodes {beta_drive['wave_beta_device_ms']:.3f} ms; "
          f"{beta_drive['wave_nodes']} kernel nodes  [{card}]")
    if parent:
        for who in ("parent", "change"):
            for c in parent[who]:
                if c["kernel"] == "prior_transform" and "kind" not in c:
                    print(f"prior_transform (256, 3) three Betas, {who}: "
                          f"events {c['events_us'] / 1e3:.3f} ms a call, "
                          f"device {c['device_us'] / 1e3:.3f} ms over "
                          f"{c['kernels']} kernels (profiler), capture: "
                          f"{c['capture']}"
                          + (f", replay {c['replay_us'] / 1e3:.3f} ms"
                             if c.get("replay_us") is not None else "") +
                          f"  [{card}]")
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

    # every drive consumed each of its fused rounds through the kernel
    drives = {"balls": main, "cubes": cubes,
              "balls-unif": friends_drives["balls"],
              "cubes-unif": friends_drives["cubes"], "single": single,
              "heavy": heavy, "default": default, "rwalk": rwalk,
              "slice": sl, "doubling": doubling, "doubling-balls": dballs,
              "resume": resumed, "dynamic3": dyn3, "dynamic-balls": dynballs,
              "dynamic-resume": dynresume, "blob-balls": blobballs,
              "host-balls": hostballs, "host-pool": hostpool,
              "blob-resume": blobresume, "custom-unif": customunif,
              "custom-rslice": customrslice, "custom-resume": customresume,
              "eggbox": rows["eggbox"], "shells": rows["shells"],
              "eggbox-balls": eggballs, "mesh-balls": meshballs,
              "mesh-dynamic3": meshdyn3, "pipeline-resume": piperesume,
              "example-quickstart": example, "uncapturable": uncapturable,
              "queue-balls": queueballs, "beta-prior": beta_drive}
    # the Beta kernels only where a Beta prior is
    stray = [k for k, d in drives.items() if k != "beta-prior" and any(
        d["launches"].get(name) for name in BETA_KERNELS)]
    if stray:
        raise RuntimeError(f"drives without a Beta prior launched its "
                           f"kernels: {stray}")
    consume_by_drive = {name: {
        "launches": d["launches"]["consume"],
        "thin": d["launches"]["consume_thin"],
        "general": d["launches"]["consume_general"],
        "rounds": d["launches"]["rounds"]} for name, d in drives.items()}
    print(json.dumps({"consume_launches_by_drive": consume_by_drive,
                      "card": card}))
    idle = [k for k, c in consume_by_drive.items() if c["launches"] < 1]
    if idle:
        raise RuntimeError(f"drives that never launched the consume "
                           f"kernel: {idle}")
    steps_by_drive = {name: {k: d["launches"][k] for k in STEP_KERNELS +
                             tuple(_LOOPS)} for name, d in drives.items()}
    print(json.dumps({"proposal_step_launches_by_drive": steps_by_drive,
                      "card": card}))
    idle = [k for k, c in steps_by_drive.items() if
            (c["slice_rounds"] and c["slice_propose"] < 1) or
            (c["rwalk_rounds"] and c["rwalk_propose"] < 1)]
    if idle:
        raise RuntimeError(f"drives whose proposal loops never launched "
                           f"their kernels: {idle}")
    if not any(c["slice_propose"] for c in steps_by_drive.values()) or \
            not any(c["rwalk_propose"] for c in steps_by_drive.values()):
        raise RuntimeError("no drive ran the stepping-out state machine or "
                           "the random walk through their kernels")

    unif_by_drive = {name: {k: d["launches"][k] for k in UNIF_KERNELS + (
        "sync_wave", "unif_waves", "unif_eager", "unif_warmups",
        "unif_shapes", "n_unif_replay", "n_unif_graph")}
        for name, d in drives.items()}
    print(json.dumps({"unif_wave_launches_by_drive": unif_by_drive,
                      "card": card}))
    if not any(c["n_unif_replay"] for c in unif_by_drive.values()):
        raise RuntimeError("no drive replayed a uniform wave")

    doubling_by_drive = {name: {k: d["launches"][k] for k in
                                DOUBLING_KERNELS + tuple(
                                    k for k in _LOOPS if
                                    k.startswith(("doubling", "seg_"))) +
                                ("n_doubling_replay", "n_doubling_graph")}
                         for name, d in drives.items()
                         if d["launches"]["doubling_rounds"]}
    print(json.dumps({"doubling_launches_by_drive": doubling_by_drive,
                      "card": card}))
    if set(doubling_by_drive) != {"doubling", "doubling-balls"}:
        raise RuntimeError(f"the doubling round ran on other drives than "
                           f"the doubling drives: {list(doubling_by_drive)}")

    refit_by_drive = {name: {k: d["launches"][k] for k in REFIT_KERNELS +
                             ("refit_rounds",)}
                      for name, d in drives.items()
                      if d["launches"]["refit_rounds"]}
    print(json.dumps({"refit_launches_by_drive": refit_by_drive,
                      "card": card}))
    absent = [k for k in ("heavy", "eggbox") if k not in refit_by_drive]
    if absent:
        raise RuntimeError(f"drives that re-fit no ellipsoid stack: {absent}")

    def refit_entry(name):
        """A refit kernel's line: the heavy drive's stack (3000 points,
        one slot, d 3) in float64, the largest difference over every
        float64 case."""
        rec = next(c for c in refit_cases if c["name"] == "heavy" and
                   c["dtype"] == "float64")
        f64 = [c for c in refit_cases if c["dtype"] == "float64"]
        by_drive = {k: c[name] for k, c in refit_by_drive.items()}
        return {"name": name, "route": "cuda", "source": REFIT_SOURCE,
                "replaces": REFIT_REPLACES,
                "replaces_also": ["dynesty_tpu/internal/samplers.py:495"],
                "launches": sum(by_drive.values()),
                "launches_by_drive": by_drive,
                "launches_note": "one launch a chained ellipsoid round, in "
                                 "its prologue (a replay counts what its "
                                 "capture did)",
                "max_abs_err": max(c["idx_max_abs_err"] for c in f64)
                if name == "refit_assign" else
                max(c["max_abs_err"] for c in f64),
                "max_rel_err": None if name == "refit_assign" else
                max(max(c["rel_err"].values()) for c in f64),
                "tolerance": "equal slots where the two smallest forms "
                             f"differ by more than {REFIT_TIE:g} relative"
                             if name == "refit_assign" else
                             f"{REFIT_RTOL[torch.float64]:g} relative to "
                             f"the slot's largest entry (float64), "
                             f"{REFIT_RTOL[torch.float32]:g} (float32); "
                             "equal mask and re-fitted slots",
                "ms": rec[f"{name}_ms"], "plain_ms": rec[f"{name}_plain_ms"],
                "bound_ms": rec[f"{name}_bound_ms"],
                "bound_by": rec[f"{name}_bound_by"], "library_ms": None,
                "library_note": "no one PyTorch call computes this step",
                "shape": [rec["n"], rec["m"], rec["d"]], "dtype": "float64",
                "device_ms": rec[f"{name}_device_ms"],
                "launch_floor_ms": floor["device_us"] / 1e3,
                "cases": [{k: c.get(k) for k in (
                    "name", "case", "n", "k", "m", "d", "dtype", "rel_err",
                    "near_ties", "idx_differ_decided", "kept",
                    f"{name}_ms", f"{name}_plain_ms", f"{name}_device_ms",
                    f"{name}_bound_ms", f"{name}_bound_by")}
                    for c in refit_cases],
                **({"parent_bench": parent_of("ellipsoid_refit"),
                    "parent_bits": parent["bits"]} if parent else {})}

    def doubling_entry(name):
        """A doubling kernel's line: (256, 3) in float64 without a mask,
        the largest difference over every case."""
        rec = main_doubling(doubling_cases, name)
        by_drive = {k: c[name] for k, c in doubling_by_drive.items()}
        return {"name": name, "route": "cuda", "source": DOUBLING_SOURCE,
                "replaces": DOUBLING_REPLACES[name][0],
                "replaces_also": DOUBLING_REPLACES[name][1],
                "launches": sum(by_drive.values()),
                "launches_by_drive": by_drive,
                "max_abs_err": max(c["max_abs_err"] for c in doubling_cases
                                   if c["kernel"] == name),
                "ms": rec["us"] / 1e3, "plain_ms": rec["plain_us"] / 1e3,
                "bound_ms": rec["bound_us"] / 1e3, "bound_by": rec["bound_by"],
                "library_ms": None,
                "library_note": "no one PyTorch call computes this step",
                "shape": rec["shape"], "dtype": "float64",
                "device_ms": rec["device_us"] / 1e3,
                "launch_floor_ms": floor["device_us"] / 1e3,
                "mode_device_ms": {m: us / 1e3 for m, us in
                                   rec["mode_device_us"].items()},
                "mode_bound_ms": {m: us / 1e3 for m, us in
                                  rec["mode_bound_us"].items()},
                "captured_segments": captured_doubling["timing"],
                **({"parent_bench": parent_of(name)} if parent else {}),
                **({"parent_bench_segments": {
                    "replays": parent_of("doubling_segment"),
                    "spans": parent_of("segment_span")}}
                   if parent and name == "doubling_expand" else {})}

    def parent_of(kernel, **key):
        """The parent's and this checkout's bench records of a kernel's
        cases (with ``--parent``), else None."""
        if parent is None:
            return None
        return {k: [c for c in parent[k] if c["kernel"] == kernel and
                    all(c.get(f) == v for f, v in key.items())]
                for k in ("parent", "change")}

    def unif_entry(name):
        """A wave kernel's line: the cube's wave at (256, 3) in float64,
        the largest difference over every case."""
        rec = main_unif(unif_cases, name)
        by_drive = {k: c[name] for k, c in unif_by_drive.items() if c[name]}
        return {"name": name, "route": "cuda", "source": UNIF_SOURCE,
                "replaces": "dynesty_tpu/internal/kernels.py:148"
                if name == "unif_valid" else
                "dynesty_tpu/internal/kernels.py:366",
                **({"replaces_also": ["dynesty_tpu/internal/kernels.py:366",
                                      "dynesty_tpu/internal/kernels.py:178"]}
                   if name == "unif_valid" else {}),
                "launches": sum(by_drive.values()),
                "launches_by_drive": by_drive,
                "max_abs_err": max(c["max_abs_err"] for c in unif_cases
                                   if c["kernel"] == name),
                "ms": rec["us"] / 1e3, "plain_ms": rec["plain_us"] / 1e3,
                "bound_ms": rec["bound_us"] / 1e3, "bound_by": rec["bound_by"],
                "library_ms": None,
                "library_note": "no one PyTorch call computes this step",
                "shape": rec["shape"], "dtype": "float64",
                "device_ms": rec["device_us"] / 1e3,
                "launch_floor_ms": floor["device_us"] / 1e3,
                "captured_wave": captured_unif["timing"],
                "heavy_wave_replay_device_ms":
                    heavy["wave_replay_device_ms"],
                **({"ellipsoid_unions": [
                    {k: union_unif(unif_cases, m)[k] for k in (
                        "m", "us", "plain_us", "device_us", "bound_us",
                        "bound_by")} for m in UNION_SLOTS],
                    "friends": [
                        {k: friends_unif(unif_cases, *key)[k] for k in (
                            "kind", "nctrs", "ncdim", "dtype", "chunks",
                            "per", "lanes", "us", "plain_us", "device_us",
                            "bound_us", "bound_by", "issue_bound_us")}
                        for key in _FRIENDS_CALLS],
                    "friends_registers": friends_regs,
                    "captured_friends": {
                        fkind: {k: v for k, v in frec.items()
                                if k != "names"}
                        for fkind, frec in cu["friends"].items()},
                    **({"parent_bench": parent_of(name)} if parent else {})}
                   if name == "unif_valid" else {})}

    def step_entry(name):
        """A proposal-step kernel's line: its main drive's shape in
        float64 (the slice kernels at 3-D, the walk's at 15-D), the
        largest difference over every case."""
        rec = main_step(steps, name)
        by_drive = {k: c[name] for k, c in steps_by_drive.items() if c[name]}
        slice_ = name.startswith("slice")
        return {"name": name, "route": "cuda",
                "source": SLICE_SOURCE if slice_ else RWALK_SOURCE,
                "replaces": "dynesty_tpu/internal/kernels.py:801" if slice_
                else "dynesty_tpu/internal/kernels.py:486",
                "launches": sum(by_drive.values()),
                "launches_by_drive": by_drive,
                "max_abs_err": max(c["max_abs_err"] for c in steps
                                   if c["kernel"] == name),
                "ms": rec["us"] / 1e3, "plain_ms": rec["plain_us"] / 1e3,
                "bound_ms": rec["bound_us"] / 1e3, "bound_by": rec["bound_by"],
                "library_ms": None,
                "library_note": "no one PyTorch call computes this step",
                "shape": rec["shape"], "dtype": "float64",
                "device_ms": rec["device_us"] / 1e3,
                "launch_floor_ms": floor["device_us"] / 1e3,
                **({"captured_iteration": captured["timing"]} if slice_
                   else {"captured_walk": {k: rwalk[k] for k in (
                       "rwalk_round_ms", "replay_round_ms",
                       "eager_round_host_ms", "replay_round_host_ms",
                       "replay_events_ms", "replay_device_ms")}})}

    def round_at(nlive, mode, path):
        return next(t for t in consume["times"] if (
            t["nlive"], t["mode"], t["path"]) == (nlive, mode, path))

    # every drive assembled each fused round through the kernel, and on
    # the card replayed every round's prologue and epilogue but the first
    # of each shape (checked by _counts); the round gate read at most once
    # a dispatch where the loop reads a flag (the walk reads it a round)
    round_by_drive = {name: dict({k: d["launches"][k] for k in (
        "rounds", "round_assemble", "n_round_replay", "n_round_graph",
        "round_shapes", "round_warm", "sync_round")},
        n_dispatch=d.get("timings", {}).get("n_dispatch"))
        for name, d in drives.items()}
    print(json.dumps({"round_launches_by_drive": round_by_drive,
                      "card": card}))
    many = [k for k, c in round_by_drive.items() if k != "rwalk" and
            c["n_dispatch"] is not None and c["sync_round"] > c["n_dispatch"]]
    if many:
        raise RuntimeError(f"drives that read the round gate more than once "
                           f"a dispatch: {many}")
    assemble_entry = {
        "name": "round_assemble", "route": "cuda", "source": ASSEMBLE_SOURCE,
        "replaces": "dynesty_tpu/internal/fused.py:146",
        "launches": sum(c["round_assemble"] for c in round_by_drive.values()),
        "launches_by_drive": {k: c["round_assemble"]
                              for k, c in round_by_drive.items()},
        "launches_note": "one call, two kernels (records, refill)",
        "max_abs_err": max(c["max_abs_err"] for c in assemble_cases),
        "ms": main_asm["ms"], "plain_ms": main_asm["plain_ms"],
        "bound_ms": main_asm["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no one PyTorch call computes this step",
        "device_ms": main_asm["device_ms"],
        "records_device_ms": main_asm["records_device_ms"],
        "refill_device_ms": main_asm["refill_device_ms"],
        "launch_floor_ms": floor["device_us"] / 1e3,
        "bound_share": main_asm["bound_share"], "shape": [2048, 256],
        "path": "thin",
        "parent_bench": parent_of("round_assemble", nlive=2048, q=256,
                                  path="thin"),
        "cases": [{k: c[k] for k in ("nlive", "q", "mode", "path", "ms",
                                     "device_ms", "records_device_ms",
                                     "refill_device_ms", "plain_ms",
                                     "bound_ms", "bound_share",
                                     "max_abs_err")}
                  for c in assemble_cases],
        "captured_round": captured_round}

    def beta_entry(name):
        """A Beta kernel's line: a wave's 256 lanes in float64 at the
        drive's Beta(2, 5), the largest difference over the sweep."""
        rec = next(r for r in beta["timed"] if r["kernel"] == name and
                   r["n"] == 256 and r["dtype"] == "float64")
        by_drive = {"beta-prior": beta_drive["launches"][name],
                    "priors": priors["launches"][name]}
        return {"name": name, "route": "cuda", "source": BETA_SOURCE,
                "replaces": BETA_REPLACES,
                "replaces_also": BETA_REPLACES_ALSO,
                "launches": sum(by_drive.values()),
                "launches_by_drive": by_drive,
                "launches_note": "one launch a prior call on the card "
                                 "for all its Beta dimensions of one "
                                 "niter (a replayed wave counts what its "
                                 "capture did); priors: phase 27's "
                                 "calls",
                "max_abs_err": max(r["max_abs_err"] for r in
                                   beta["sweep"] + beta["tables"]
                                   if r["kernel"] == name),
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "bound_share": rec["bound_share"],
                "chain_bound_ms": rec["chain_device_ms"],
                "bound_note": "operations: the plain version's elementwise "
                              "ops an element at the type's rate; the "
                              "chain (the kernel on one element: for "
                              "beta_ppf a warp's ten rounds of five "
                              "levels) bounds a wave's 256 lanes by "
                              "latency",
                "library_ms": None,
                "library_note": "no one PyTorch call computes the "
                                "regularized incomplete beta function "
                                "(torch.special has none)",
                "shape": [256], "dtype": "float64",
                "device_ms": rec["device_ms"],
                "launch_floor_ms": floor["device_us"] / 1e3,
                "cases": [{k: r[k] for k in (
                    "n", "dtype", "levels", "ms", "device_ms", "plain_ms",
                    "chain_ms",
                    "chain_device_ms", "ops_per_element", "ops_bound_ms",
                    "bytes_bound_ms", "bound_ms", "bound_by",
                    "bound_share")} for r in beta["timed"]
                    if r["kernel"] == name],
                **({"parent_bench": parent_of("prior_transform")}
                   if parent and name == "beta_ppf" else {})}

    main_round = round_at(2048, "batch", "thin")
    kernels = {"kernels": [
        entry("pairwise_min_dist_l2_exact", MAIN_SHAPE, 2, "exact",
              {"balls": main["launches"]["exact"],
               "slice": sl["launches"]["exact"],
               "doubling-balls": dballs["launches"]["exact"],
               "resume": resumed["launches"]["exact"],
               "dynamic-balls": dynballs["launches"]["exact"],
               "blob-balls": blobballs["launches"]["exact"],
               "host-balls": hostballs["launches"]["exact"],
               "blob-resume": blobresume["launches"]["exact"],
               "eggbox-balls": eggballs["launches"]["exact"],
               "mesh-balls": meshballs["launches"]["exact"],
               "queue-balls": queueballs["launches"]["exact"]}),
        entry("pairwise_min_dist_linf_exact", MAIN_SHAPE, math.inf, "exact",
              {"cubes": cubes["launches"]["exact"]}),
        entry("pairwise_min_dist_l2_tc", TC_SHAPE, 2, "tc",
              {"refit": refit["launches"]["tc"]}),
        {"name": "consume_scan", "route": "cuda", "source": CONSUME_SOURCE,
         "replaces": "dynesty_tpu/internal/fused.py:212",
         "replaces_also": ["dynesty_tpu/internal/fused.py:333",
                           "dynesty_tpu/internal/fused.py:423"],
         "launches": sum(c["launches"] for c in consume_by_drive.values()),
         "launches_by_drive": {k: c["launches"]
                               for k, c in consume_by_drive.items()},
         "max_abs_err": consume["max_abs_err"], "ms": main_round["ms"],
         "plain_ms": main_round["plain_ms"],
         "bound_ms": main_round["bound_ms"],
         "bound_by": main_round["bound_by"],
         "bound_note": "the larger of the byte bound and the chain bound, "
                       "the round's own q dependent logaddexps timed on "
                       "one thread of this card (an operations bound of "
                       "latency, not of rate)",
         "device_ms": main_round["device_ms"],
         "byte_bound_ms": main_round["byte_bound_ms"],
         "chain_bound_ms": main_round["chain_bound_ms"],
         "bound_share": main_round["bound_share"],
         "general": {k: round_at(2048, "batch", "general")[k] for k in (
             "ms", "device_ms", "plain_ms", "byte_bound_ms",
             "chain_bound_ms", "bound_ms", "bound_by", "bound_share")},
         "library_ms": None, "shape": [2048, 256], "path": "thin"},
    ] + [step_entry(name) for name in STEP_KERNELS] +
        [unif_entry(name) for name in UNIF_KERNELS] +
        [doubling_entry(name) for name in DOUBLING_KERNELS] +
        [assemble_entry] + [refit_entry(name) for name in REFIT_KERNELS] +
        [beta_entry(name) for name in BETA_KERNELS]}
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "compare": compares,
              "main": main, "cubes": cubes, "refit": refit,
              "balls_unif": friends_drives["balls"],
              "cubes_unif": friends_drives["cubes"],
              "single": single, "heavy": heavy,
              "default": default, "rwalk": rwalk, "slice": sl,
              "doubling": doubling, "doubling_balls": dballs,
              "resume": resumed,
              "dynamic3": dyn3, "dynamic_balls": dynballs,
              "dynamic_resume": dynresume,
              "blob_balls": blobballs, "host_balls": hostballs,
              "host_pool": hostpool, "blob_resume": blobresume,
              "custom_unif": customunif,
              "custom_rslice": customrslice,
              "custom_resume": customresume, "plots": plots,
              "eggbox": rows["eggbox"], "shells": rows["shells"],
              "eggbox_balls": eggballs, "priors": priors,
              "beta_prior": beta_drive, "beta_kernels": beta,
              "mesh_balls": meshballs,
              "mesh_dynamic3": meshdyn3, "scaling": scaling,
              "pipeline_resume": piperesume,
              "example_quickstart": example,
              "uncapturable": uncapturable,
              "queue_balls": queueballs,
              "consume": consume,
              "consume_by_drive": consume_by_drive,
              "proposal_steps": steps,
              "captured_slice": captured,
              "captured_rwalk": captured_rwalk,
              "unif_waves": unif_cases,
              "captured_unif": captured_unif,
              "unif_by_drive": unif_by_drive,
              "doubling_kernels": doubling_cases,
              "captured_doubling": captured_doubling,
              "doubling_by_drive": doubling_by_drive,
              "launch_floor": floor,
              "round_assemble": assemble_cases,
              "captured_round": captured_round,
              "round_by_drive": round_by_drive,
              "ellipsoid_refit": refit_cases,
              "refit_by_drive": refit_by_drive,
              "proposal_steps_by_drive": steps_by_drive,
              "build_seconds": {k: build.build_log[k]["seconds"]
                                for k in libs}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    if args.compare:
        with open(args.compare[0]) as f:
            if report_compare(json.load(f), record, args.moving):
                raise SystemExit("chip_smoke: a drive's fields differ from "
                                 "the parent's record")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
