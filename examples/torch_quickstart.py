"""Quick start for the PyTorch/CUDA port: static and dynamic fits of a 3-D
correlated Gaussian (the reference's quickstart problem,
``docs/source/quickstart.rst``), the counterpart of ``quickstart.py``.

Runs on the GPU by default; ``--device cpu`` runs it on the CPU.  The
plots are drawn where matplotlib is installed.

Run: python examples/torch_quickstart.py [--device cpu] [--maxiter N]
"""

import argparse
import importlib.util
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
    # x is one point: the sampler batches the call with torch.func.vmap;
    # a constant goes to the device the points are on
    return -0.5 * (x @ cinv.to(x.device) @ x) + lnorm


def ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--maxiter", type=int, default=None,
                    help="stop each run after this many iterations")
    ap.add_argument("--seed", type=int, default=56432)
    ap.add_argument("--outdir", default=".", help="where the plots go")
    args = ap.parse_args(argv)

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
    dns = dyt.DynamicNestedSampler(
        loglike, ptform, ndim, device=args.device,
        rstate=np.random.default_rng(args.seed + 1))
    dns.run_nested(nlive_init=500, nlive_batch=100, maxbatch=5,
                   maxiter=args.maxiter)
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
