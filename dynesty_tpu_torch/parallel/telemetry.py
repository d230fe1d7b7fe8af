"""Mesh scaling telemetry: measured throughput of the split batched
likelihood across mesh sizes (counterpart of
``dynesty_tpu.parallel.telemetry``).

``scaling_report`` splits a batch of points over a 1-D mesh of each size
(:func:`~.mesh.shard_batch`), evaluates ``chain`` batched likelihood calls
in a row on every device (each on its own stream, each call's output fed
back into its input so that none can be skipped), and reports
evaluations/s and the speedup over the first size.  On the card the time
is taken with CUDA events, on the CPU with the host clock.  A mesh of
repeated CPU devices (``devices=['cpu'] * 8``) checks the split's
arithmetic and placement, not a scaling: its chunks run one after another
on one host.
"""

import time

import numpy as np
import torch

from .mesh import make_mesh, map_chunks, shard_batch

__all__ = ["scaling_report"]


def scaling_report(loglike, ndim, q=4096, sizes=None, devices=None,
                   reps=20, chain=8, rstate=None):
    """Measure split batched-likelihood throughput per mesh size.

    Parameters
    ----------
    loglike : callable
        Per-point torch log-likelihood ``f(x: (ndim,)) -> scalar``,
        batched with ``torch.func.vmap``.
    ndim : int
        Input dimensionality.
    q : int
        Batch width (must divide by every mesh size).
    sizes : sequence of int, optional
        Mesh sizes to measure; default = divisors of the device count.
    devices : sequence, optional
        Devices to build meshes from (default: every CUDA device; raises
        without CUDA).
    reps : int
        Timed repetitions per size (one untimed warm-up first).
    chain : int
        Batched evaluations chained per repetition, each fed back into
        the next one's input.
    rstate : numpy Generator, optional
        Source for the input batch.

    Returns
    -------
    list of dict
        One entry per mesh size: ``n_devices``, ``evals_per_s``,
        ``speedup`` (vs the first size), ``partitioned`` (whether chunk
        ``i`` lives on device ``i``), ``platform`` (``'gpu'`` or
        ``'cpu'``).
    """
    devices = list(make_mesh().devices if devices is None else
                   (torch.device(d) for d in devices))
    if sizes is None:
        sizes = [n for n in (1, 2, 4, 8, 16, 32) if len(devices) % n == 0
                 and n <= len(devices)]
    rstate = rstate or np.random.Generator(np.random.PCG64(0))
    x_host = torch.as_tensor(rstate.random((q, ndim)))
    platform = "gpu" if devices[0].type == "cuda" else "cpu"
    batched = torch.func.vmap(loglike)

    def step(x):
        logl = batched(x)
        # fold the output back in so the chain cannot be elided
        return x + 1e-12 * logl[:, None], logl.sum()

    report = []
    base = None
    for n in sizes:
        if q % n != 0:
            raise ValueError(f"q={q} not divisible by mesh size {n}")
        mesh = make_mesh(n_devices=n, devices=devices[:n])
        chunks, _ = shard_batch(mesh, x_host.to(devices[0]))

        def run():
            xs, total = chunks, 0.0
            for _ in range(chain):
                outs = map_chunks(mesh, step, xs)
                xs = [o[0] for o in outs]
                total = total + sum(o[1].to(devices[0]) for o in outs)
            return total

        run()  # warm-up
        if platform == "gpu":
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                out = run()
            stop.record()
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)
            dt = start.elapsed_time(stop) / 1e3 / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                out = run()
            dt = (time.perf_counter() - t0) / reps
        if not np.isfinite(float(out)):
            raise RuntimeError(f"the chained likelihood gave {float(out)}")
        evals_per_s = chain * q / dt
        if base is None:
            base = evals_per_s
        report.append({
            "n_devices": n,
            "evals_per_s": round(evals_per_s, 1),
            "speedup": round(evals_per_s / base, 3),
            "partitioned": all(c.device == d for c, d in
                               zip(chunks, mesh.devices)),
            "platform": platform,
        })
    return report
