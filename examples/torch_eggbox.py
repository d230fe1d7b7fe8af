"""Multimodal 2-D eggbox with multi-ellipsoid bounds on the PyTorch/CUDA
port (the reference's ``demos/Examples -- Eggbox.ipynb``; analytic logz =
235.856), the counterpart of ``eggbox.py``.

Runs on the GPU by default; ``--device cpu`` runs it on the CPU.  The
plot is drawn where matplotlib is installed.

Run: python examples/torch_eggbox.py [--device cpu] [--maxiter N]
"""

import argparse
import importlib.util
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.models import Eggbox


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--maxiter", type=int, default=None,
                    help="stop the run after this many iterations")
    ap.add_argument("--seed", type=int, default=56432)
    ap.add_argument("--outdir", default=".", help="where the plot goes")
    args = ap.parse_args(argv)

    prob = Eggbox()
    sampler = dyt.NestedSampler(prob.loglike, prob.ptform, 2, nlive=1000,
                                bound="multi", sample="unif",
                                queue_size=256, device=args.device,
                                rstate=np.random.default_rng(args.seed))
    sampler.run_nested(dlogz=0.01, maxiter=args.maxiter)
    res = sampler.results
    res.summary()
    print(f"truth: {prob.logz_truth:.3f}, "
          f"ellipsoids at the end: {getattr(sampler.bound, 'nells', 1)}")

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no plot")
        return sampler
    import matplotlib
    matplotlib.use("Agg")
    from dynesty_tpu_torch import plotting
    os.makedirs(args.outdir, exist_ok=True)
    name = os.path.join(args.outdir, "eggbox_points.png")
    fig, _ = plotting.cornerpoints(res)
    fig.savefig(name)
    print(f"wrote {name}")
    return sampler


if __name__ == "__main__":
    main()
