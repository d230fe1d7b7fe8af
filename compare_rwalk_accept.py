"""Accept fraction of the rwalk kernel in the JAX package and in the port,
on the same configuration, on the CPU.

    JAX_PLATFORMS=cpu python3 compare_rwalk_accept.py [--nlive 1000]

The configuration is the 15-D default drive of ``chip_smoke.py``: a 15-D
standard normal under a uniform prior on +-10, every argument but
``nlive`` at its default (multi / rwalk, walks 35), seed 56432, run to
the default stop.  Prints one JSON line per package: niter, ncall, logz
and its error, and the accept fraction n_accept / (n_accept + n_reject)
over the whole run and over the second half of its records.  The analytic
logz is -15 ln 20.  Each package's run takes seconds on one CPU thread.
"""

import argparse
import json
import math
import time

import numpy as np

NDIM, SEED = 15, 56432


def _accept(stats):
    stats = [p for p in stats if p]

    def frac(ps):
        a = sum(p["n_accept"] for p in ps)
        return a / max(a + sum(p["n_reject"] for p in ps), 1)

    return frac(stats), frac(stats[len(stats) // 2:])


def _report(name, sampler, wall):
    res = sampler.results
    whole, late = _accept(res.proposal_stats)
    print(json.dumps({
        "package": name, "niter": int(res.niter),
        "ncall": int(sampler.ncall), "logz": float(res.logz[-1]),
        "logzerr": float(res.logzerr[-1]),
        "truth": -NDIM * math.log(20.0), "accept_fraction": whole,
        "accept_fraction_second_half": late, "wall_s": wall}), flush=True)


def run_jax(nlive):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import dynesty_tpu

    def loglike(x):
        return -0.5 * jnp.dot(x, x) - 0.5 * NDIM * math.log(2 * math.pi)

    t0 = time.perf_counter()
    s = dynesty_tpu.NestedSampler(
        loglike, lambda u: 10.0 * (2.0 * u - 1.0), NDIM, nlive=nlive,
        rstate=np.random.Generator(np.random.PCG64(SEED)))
    s.run_nested(print_progress=False)
    _report("jax", s, time.perf_counter() - t0)


def run_torch(nlive):
    import torch

    import dynesty_tpu_torch

    torch.set_num_threads(1)

    def loglike(x):
        return -0.5 * (x @ x) - 0.5 * NDIM * math.log(2 * math.pi)

    t0 = time.perf_counter()
    s = dynesty_tpu_torch.NestedSampler(
        loglike, lambda u: 10.0 * (2.0 * u - 1.0), NDIM, nlive=nlive,
        device="cpu", rstate=np.random.Generator(np.random.PCG64(SEED)))
    s.run_nested(print_progress=False)
    _report("torch", s, time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nlive", type=int, default=1000)
    ap.add_argument("--only", choices=["jax", "torch"])
    args = ap.parse_args()
    if args.only != "torch":
        run_jax(args.nlive)
    if args.only != "jax":
        run_torch(args.nlive)


if __name__ == "__main__":
    main()
