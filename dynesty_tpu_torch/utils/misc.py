"""RNG discipline, run timings and the plain progress printer.

Host-side decisions use ``numpy.random.Generator`` instances; device
work draws from explicit ``torch.Generator`` objects seeded from the same
host stream (:func:`get_torch_generator`), so a seed reproduces a run.
"""

import sys
from collections import namedtuple

import numpy as np
import torch

__all__ = [
    "get_random_generator", "get_torch_generator", "torch_generator",
    "resample_equal", "IteratorResult", "IteratorBlock", "Timings",
    "get_print_func", "print_fn_fallback",
]


class Timings(dict):
    """Wall-clock attribution and counters for one sampler run.

    Seconds (float): ``dispatch`` (blocked in fused device calls,
    device execution and the flat-result download included),
    ``consume`` (host record bookkeeping), ``refit`` (host bound refits),
    ``mirror`` (device->host live-state downloads), ``add_live``,
    ``integrals``, ``total``.

    Counts (int): ``n_dispatch``, ``n_refit``, ``nc_launched`` and the
    host synchronisations forced by data-dependent loops:
    ``sync_wave`` (one per unit-cube rejection wave), ``sync_slice``
    (one per rslice state-machine iteration), ``sync_round`` (per-round
    thin-path and skip gates) and ``sync_flat`` (one result download per
    dispatch).
    """

    def add(self, key, dt):
        self[key] = self.get(key, 0.0) + dt

    def count(self, key, n=1):
        self[key] = self.get(key, 0) + n


IteratorResult = namedtuple("IteratorResult", [
    "worst", "ustar", "vstar", "loglstar", "logvol", "logwt", "logz",
    "logzvar", "h", "nc", "blob", "worst_it", "boundidx", "bounditer",
    "eff", "delta_logz", "proposal_stats", "n", "birth"
], defaults=[None, None])

# coarse-grained yield of Sampler.sample(per_dispatch=True): one fused
# dispatch worth of iterations (n accepted records, nc likelihood calls)
IteratorBlock = namedtuple("IteratorBlock", ["n", "nc"])


def get_random_generator(seed=None):
    """A PCG64 numpy Generator from a seed / SeedSequence / Generator."""
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.Generator(np.random.PCG64(seed))


def get_torch_generator(rstate, device):
    """A ``torch.Generator`` on ``device`` seeded with 63 bits drawn from
    the numpy Generator ``rstate`` (consecutive calls give independent,
    reproducible streams)."""
    seed = int(rstate.integers(0, 2**63 - 1))
    return torch_generator(seed, device)


def torch_generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def resample_equal(samples, weights, rstate=None):
    """Systematic resampling to equal-weight samples, returned shuffled."""
    if rstate is None:
        rstate = get_random_generator()
    samples = np.asarray(samples)
    weights = np.asarray(weights, dtype=np.float64)
    if abs(np.sum(weights) - 1.0) > 1e-9:
        weights = weights / weights.sum()
    nsamples = len(weights)
    positions = (rstate.random() + np.arange(nsamples)) / nsamples
    cumulative = np.cumsum(weights)
    cumulative[-1] = 1.0
    idx = np.searchsorted(cumulative, positions)
    resampled = samples[idx]
    rstate.shuffle(resampled)
    return resampled


def print_fn_fallback(results, niter, ncall, add_live_it=None, dlogz=None):
    """Carriage-return stderr status line."""
    logzerr = np.sqrt(max(results.logzvar, 0.0))
    bits = [f"iter: {niter:d}"]
    if add_live_it is not None:
        bits.append(f"+{add_live_it:d}")
    bits += [f"nc: {results.nc:d}", f"ncall: {ncall:d}",
             f"eff(%): {results.eff:6.3f}",
             f"loglstar: {results.loglstar:.3f}",
             f"logz: {results.logz:.3f} +/- {logzerr:.3f}"]
    if dlogz is not None:
        bits.append(f"dlogz: {min(results.delta_logz, 1e10):.3f} > "
                    f"{dlogz:.3f}")
    sys.stderr.write("\r" + " | ".join(bits))
    sys.stderr.flush()


def get_print_func(print_func, print_progress):
    """The progress printer: a no-op without progress, the user's
    ``print_func`` if given, else :func:`print_fn_fallback`."""
    if not print_progress:
        return lambda *a, **kw: None
    return print_func if print_func is not None else print_fn_fallback
