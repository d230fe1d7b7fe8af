"""200-D iid normal with bound='none' and random slice sampling on the
PyTorch/CUDA port (the reference's ``demos/Examples -- 200-D Multivariate
Normal.ipynb``), the counterpart of ``highdim_200.py``.

This is the high-dimensional stress configuration: no bounding geometry,
slice chains along random directions, wide proposal batches.  Expect a
long run; pass --quick for a truncated sanity run (2,000 iterations) or
--maxiter for any other stop.  Runs on the GPU by default; ``--device
cpu`` runs it on the CPU.

Run: python examples/torch_highdim_200.py [--quick] [--device cpu]
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import dynesty_tpu_torch as dyt

NDIM = 200
SIGMA = 1.0
PRIOR_WIN = 10.0


def loglike(x):
    return (-0.5 * ((x / SIGMA) ** 2).sum() -
            0.5 * NDIM * math.log(2 * math.pi * SIGMA ** 2))


def ptform(u):
    return PRIOR_WIN * (2.0 * u - 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after 2,000 iterations")
    ap.add_argument("--maxiter", type=int, default=None,
                    help="stop the run after this many iterations")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=56432)
    args = ap.parse_args(argv)
    maxiter = args.maxiter or (2000 if args.quick else None)

    truth = -NDIM * np.log(2 * PRIOR_WIN)
    sampler = dyt.NestedSampler(loglike, ptform, NDIM, nlive=500,
                                bound="none", sample="rslice", slices=40,
                                queue_size=256, rounds_per_dispatch=2,
                                device=args.device,
                                rstate=np.random.default_rng(args.seed))
    sampler.run_nested(maxiter=maxiter)
    res = sampler.results
    res.summary()
    if maxiter is None:
        print(f"truth: {truth:.1f} "
              f"(pull {(res.logz[-1] - truth) / res.logzerr[-1]:.2f})")
        eq = res.samples_equal()
        print("posterior std of first dims:",
              eq[:, :5].std(axis=0).round(3), "(truth 1.0)")
    return sampler


if __name__ == "__main__":
    main()
