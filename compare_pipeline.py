"""Dispatches planned ahead of their refit, in the JAX package and in the
port, on the CPU.

    JAX_PLATFORMS=cpu python3 compare_pipeline.py [--only jax|torch] [--pulls]

Two checks per package, each printed as one JSON line:

* ``boundary``: the 3-D correlated Gaussian (rho = 0.95, prior +-10, nlive
  100, width 32, seed 56432) under single/unif and multi/rwalk, run once
  to the end; then stopped by ``maxiter`` and, apart, by ``maxcall``
  exactly at the first dispatch boundary whose next dispatch was planned
  ahead, pickled and resumed.  ``resume_exact`` says whether the resumed
  run equals the uninterrupted one (records, ``ncall``, ``bound_iter``).
  With ``update_interval=1`` a refit is due at that boundary; the control
  (``update_interval=1e6``) has none due there.
* ``eggbox``: ``Eggbox()`` under multi/unif at nlive 500, every other
  argument at its default, run to dlogz 0.509: dispatches, those that
  produced no record, refits and dispatches planned ahead.

With ``--pulls``, the port alone: the dynamic run of
``examples/torch_quickstart.py`` (nlive 500, batches of 100, 5 batches)
over seeds 1 to 12, with planning ahead and with it switched off: the
pulls (logz - truth) / logzerr and their root mean square.

Each package's part takes under a minute on one CPU thread, the pulls
about three minutes.
"""

import argparse
import json
import math
import pickle
import sys
import warnings

import numpy as np

NDIM, SEED = 3, 56432
_COV = np.identity(NDIM)
_COV[_COV == 0] = 0.95
_CINV = np.linalg.inv(_COV)
_LNORM = -0.5 * (NDIM * math.log(2 * math.pi) +
                 math.log(np.linalg.det(_COV)))
KEYS = ("logl", "samples", "ncall", "bound_iter")


# module-level functions, so that a sampler pickles
def jax_loglike(x):
    import jax.numpy as jnp
    return -0.5 * jnp.dot(x, jnp.asarray(_CINV) @ x) + _LNORM


def torch_loglike(x):
    import torch
    return -0.5 * (x @ torch.as_tensor(_CINV) @ x) + _LNORM


def ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def _rstate():
    return np.random.Generator(np.random.PCG64(SEED))


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def _boundaries(s):
    """Run ``s`` to dlogz 0.01 dispatch by dispatch; after each dispatch,
    (records, calls counted by the loop, dispatches planned ahead)."""
    out, nc = [], 0
    for block in s.sample(dlogz=0.01, per_dispatch=True):
        nc += block.nc
        out.append((s.it - 1, nc, s.timings.get("n_prelaunch", 0)))
    for _ in s.add_live_points():
        pass
    return out


def boundary(pkg, make):
    for bound, sample in (("single", "unif"), ("multi", "rwalk")):
        for interval in (1, 1000000):
            full = make(bound, sample, interval)
            marks = _quiet(_boundaries, full)
            # the first boundary after which the next dispatch was planned
            it, nc, _ = next(m for m, n in zip(marks, marks[1:])
                             if n[2] > m[2] >= 1)
            for how, budget in (("maxiter", {"maxiter": it}),
                                ("maxcall", {"maxcall": nc})):
                s = make(bound, sample, interval)
                _quiet(s.run_nested, print_progress=False, add_live=False,
                       **budget)
                s2 = pickle.loads(pickle.dumps(s))
                _quiet(s2.run_nested, print_progress=False, resume=True,
                       dlogz=0.01)
                a, b = s2.results, full.results
                exact = bool(a.niter == b.niter and all(
                    np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                    for k in KEYS))
                print(json.dumps({
                    "package": pkg, "check": "boundary", "bound": bound,
                    "sample": sample, "update_interval": interval,
                    "stop": how, "budget": budget[how],
                    "stopped_at": s.it - 1, "resume_exact": exact,
                    "niter_resumed": int(a.niter),
                    "niter_full": int(b.niter),
                    "ncall_resumed": int(s2.ncall),
                    "ncall_full": int(full.ncall)}), flush=True)


def eggbox(pkg, sampler):
    ns = [block.n for block in _quiet(
        list, sampler.sample(dlogz=0.509, per_dispatch=True))]
    t = sampler.timings
    print(json.dumps({
        "package": pkg, "check": "eggbox", "niter": int(sampler.it - 1),
        "ncall": int(sampler.ncall), "dispatches": len(ns),
        "dispatches_without_records": ns.count(0),
        "n_refit": t.get("n_refit", 0),
        "n_prelaunch": t.get("n_prelaunch", 0)}), flush=True)


def pulls():
    import torch

    import dynesty_tpu_torch
    from dynesty_tpu_torch.sampler import Sampler

    torch.set_num_threads(1)
    truth = -NDIM * math.log(20.0)
    capable = Sampler._pipeline_capable
    for planned in (True, False):
        Sampler._pipeline_capable = capable if planned else \
            (lambda self: False)
        out = []
        for seed in range(1, 13):
            d = dynesty_tpu_torch.DynamicNestedSampler(
                torch_loglike, ptform, NDIM, device="cpu",
                rstate=np.random.default_rng(seed))
            _quiet(d.run_nested, nlive_init=500, nlive_batch=100,
                   maxbatch=5, print_progress=False)
            r = d.results
            out.append(float((r.logz[-1] - truth) / r.logzerr[-1]))
        print(json.dumps({
            "package": "torch", "check": "dynamic_pulls",
            "planning_ahead": planned, "pulls": out,
            "rms": float(np.sqrt(np.mean(np.square(out))))}), flush=True)
    Sampler._pipeline_capable = capable


def run_jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import dynesty_tpu
    from dynesty_tpu.models import Eggbox

    def make(bound, sample, interval):
        return dynesty_tpu.NestedSampler(
            jax_loglike, ptform, NDIM, nlive=100,
            bound=bound, sample=sample, update_interval=interval,
            queue_size=32, rstate=_rstate())

    boundary("jax", make)
    p = Eggbox()
    eggbox("jax", dynesty_tpu.NestedSampler(
        p.loglike, p.ptform, 2, bound="multi", rstate=_rstate()))


def run_torch():
    import torch

    import dynesty_tpu_torch
    from dynesty_tpu_torch.models import Eggbox

    torch.set_num_threads(1)

    def make(bound, sample, interval):
        return dynesty_tpu_torch.NestedSampler(
            torch_loglike, ptform, NDIM, nlive=100,
            bound=bound, sample=sample, update_interval=interval,
            queue_size=32, device="cpu", rstate=_rstate())

    boundary("torch", make)
    p = Eggbox()
    eggbox("torch", dynesty_tpu_torch.NestedSampler(
        p.loglike, p.ptform, 2, bound="multi", device="cpu",
        rstate=_rstate()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["jax", "torch"])
    ap.add_argument("--pulls", action="store_true",
                    help="also the pulls of the quickstart's dynamic run")
    args = ap.parse_args()
    if args.only != "torch":
        run_jax()
    if args.only != "jax":
        run_torch()
        if args.pulls:
            pulls()
    return 0


if __name__ == "__main__":
    sys.exit(main())
