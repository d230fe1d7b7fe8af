"""Quick start for the PyTorch/CUDA port: static and dynamic fits of a 3-D
correlated Gaussian (the reference's quickstart problem,
``docs/source/quickstart.rst``), the counterpart of ``quickstart.py``.

Runs on the GPU by default; ``--device cpu`` runs it on the CPU.  The
plots are drawn where matplotlib is installed.  ``--pulls FIRST-LAST``
runs only the dynamic fit, once for each seed of the range, and prints
each run's pull ``(logz - truth) / logzerr`` and then one JSON line with
the pulls' mean, standard deviation (ddof 1) and largest magnitude: a
scatter near 1 says the run's ``logzerr`` is the evidence's spread.

Run: python examples/torch_quickstart.py [--device cpu] [--maxiter N]
                                         [--pulls FIRST-LAST]
"""

import argparse
import importlib.util
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import dynesty_tpu_torch as dyt

ndim = 3
cov = np.identity(ndim)
cov[cov == 0] = 0.95
cinv = torch.as_tensor(np.linalg.inv(cov))
lnorm = -0.5 * (np.log(2 * np.pi) * ndim + np.log(np.linalg.det(cov)))
logz_truth = -ndim * np.log(20.0)


def loglike(x):
    # x is one point: the sampler batches the call with torch.func.vmap.
    # cinv lies on the run's device (main moves it there once), so a call
    # launches device work only and the sampler can capture it
    return -0.5 * (x @ cinv @ x) + lnorm


def ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def dynamic_run(device, seed, maxiter=None, print_progress=True):
    """The dynamic fit, with posterior-weighted batches."""
    dns = dyt.DynamicNestedSampler(loglike, ptform, ndim, device=device,
                                   rstate=np.random.default_rng(seed))
    dns.run_nested(nlive_init=500, nlive_batch=100, maxbatch=5,
                   maxiter=maxiter, print_progress=print_progress)
    return dns


def pulls(device, first, last, maxiter=None):
    """The dynamic fit's pull for each seed of ``first..last`` (each
    printed as a JSON line) and their summary."""
    runs = []
    for seed in range(first, last + 1):
        res = dynamic_run(device, seed, maxiter, False).results
        runs.append({"seed": seed,
                     "pull": float((res.logz[-1] - logz_truth) /
                                   res.logzerr[-1]),
                     "logz": float(res.logz[-1]),
                     "logzerr": float(res.logzerr[-1]),
                     "niter": int(res.niter)})
        print(json.dumps(runs[-1]))
    p = np.asarray([r["pull"] for r in runs])
    summary = {"device": device, "seeds": [first, last], "n": len(p),
               "mean": float(p.mean()),
               "std": float(p.std(ddof=1)) if len(p) > 1 else None,
               "max_abs": float(np.abs(p).max())}
    print(json.dumps(summary))
    return summary, runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--maxiter", type=int, default=None,
                    help="stop each run after this many iterations")
    ap.add_argument("--seed", type=int, default=56432)
    ap.add_argument("--outdir", default=".", help="where the plots go")
    ap.add_argument("--pulls", metavar="FIRST-LAST",
                    help="only the dynamic fit, once for each seed, and "
                    "the pulls' scatter")
    args = ap.parse_args(argv)
    global cinv
    cinv = cinv.to(args.device)
    if args.pulls:
        first, last = (int(s) for s in args.pulls.split("-"))
        return pulls(args.device, first, last, args.maxiter)

    # static run
    sampler = dyt.NestedSampler(
        loglike, ptform, ndim, nlive=500, bound="multi", sample="unif",
        queue_size=256, device=args.device,
        rstate=np.random.default_rng(args.seed))
    sampler.run_nested(maxiter=args.maxiter)
    res = sampler.results
    res.summary()
    print(f"truth: {logz_truth:.3f} "
          f"(pull {(res.logz[-1] - logz_truth) / res.logzerr[-1]:.2f} sigma)")
    t = sampler.timings
    print(f"dispatches {t.get('n_dispatch', 0)}, refits "
          f"{t.get('n_refit', 0)} ({t.get('refit', 0.0):.3f} s), planned "
          f"ahead of their refit {t.get('n_prelaunch', 0)}, total "
          f"{t.get('total', 0.0):.2f} s")

    # dynamic run with posterior-weighted batches
    dns = dynamic_run(args.device, args.seed + 1, args.maxiter)
    dres = dns.results
    dres.summary()

    # plots, where matplotlib is installed
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no plots")
        return sampler, dns
    import matplotlib
    matplotlib.use("Agg")
    from dynesty_tpu_torch import plotting
    os.makedirs(args.outdir, exist_ok=True)
    names = [os.path.join(args.outdir, f)
             for f in ("quickstart_runplot.png", "quickstart_corner.png")]
    fig, _ = plotting.runplot(res, lnz_truth=logz_truth)
    fig.savefig(names[0])
    fig, _ = plotting.cornerplot(dres, show_titles=True,
                                 truths=[0.0] * ndim)
    fig.savefig(names[1])
    print("wrote " + ", ".join(names))
    return sampler, dns


if __name__ == "__main__":
    main()
