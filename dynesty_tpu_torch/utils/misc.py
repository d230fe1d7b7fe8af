"""RNG discipline, run timings and the plain progress printer.

Host-side decisions use ``numpy.random.Generator`` instances; device
work draws from explicit ``torch.Generator`` objects seeded from the same
host stream (:func:`get_torch_generator`), so a seed reproduces a run.
"""

import shutil
import sys
import time
from collections import namedtuple

import numpy as np
import torch

__all__ = [
    "get_random_generator", "get_seed_sequence", "get_torch_generator",
    "torch_generator", "resample_equal", "IteratorResult",
    "IteratorResultShort", "IteratorBlock",
    "Timings", "DelayTimer", "get_print_func", "print_fn_fallback",
    "tree_map", "blob_row", "blob_where", "stack_blob_rows",
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
    ``sync_wave`` (one per rejection wave of the uniform kernels),
    ``sync_slice`` (one per slice state-machine iteration; in doubling
    mode one per expansion, per shrink and per halving of the acceptance
    test), ``sync_round`` (per-round thin-path and skip gates) and
    ``sync_flat`` (one result download per dispatch).  The random-walk
    kernel adds none.  ``n_replay`` and ``n_continuation`` count the
    consume-only replays and the continuation dispatches of a resumed
    run.
    """

    def add(self, key, dt):
        self[key] = self.get(key, 0.0) + dt

    def count(self, key, n=1):
        self[key] = self.get(key, 0) + n

    def merge(self, other):
        """Add another run's timings to these (the dynamic sampler sums
        its base run and every batch into one view)."""
        for k, v in (other or {}).items():
            self[k] = self.get(k, type(v)(0)) + v
        return self


class DelayTimer:
    """Tells whether ``delay`` seconds have elapsed since the last
    affirmative check; paces checkpoint writes."""

    def __init__(self, delay):
        self.delay = delay
        self.last_time = time.time()

    def is_time(self):
        if time.time() - self.last_time > self.delay:
            self.last_time = time.time()
            return True
        return False


IteratorResult = namedtuple("IteratorResult", [
    "worst", "ustar", "vstar", "loglstar", "logvol", "logwt", "logz",
    "logzvar", "h", "nc", "blob", "worst_it", "boundidx", "bounditer",
    "eff", "delta_logz", "proposal_stats", "n", "birth"
], defaults=[None, None])

# reduced record of dynamic batch sampling, where the global evidence
# fields are not updated per iteration; the logz/logzvar defaults let the
# printer take either record type
IteratorResultShort = namedtuple("IteratorResultShort", [
    "worst", "ustar", "vstar", "loglstar", "nc", "worst_it", "boundidx",
    "bounditer", "eff", "delta_logz", "proposal_stats", "logz", "logzvar"
], defaults=[-np.inf, 0.0])

# coarse-grained yield of Sampler.sample(per_dispatch=True): one fused
# dispatch worth of iterations (n accepted records, nc likelihood calls)
IteratorBlock = namedtuple("IteratorBlock", ["n", "nc"])


def get_random_generator(seed=None):
    """A PCG64 numpy Generator from a seed / SeedSequence / Generator."""
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.Generator(np.random.PCG64(seed))


def get_seed_sequence(rstate, nitems):
    """Spawn ``nitems`` independent child seeds from a Generator's
    underlying SeedSequence (no draw from ``rstate`` itself)."""
    return rstate.bit_generator.seed_seq.spawn(nitems)


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


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf over a blob: a tensor or array, or a
    tuple, list or dict of them (nested), with ``rest`` of the same
    structure; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def blob_row(blobs, i):
    """Row ``i`` of a stacked blob (leading axis over points)."""
    return tree_map(lambda b: b[i], blobs)


def blob_where(cond, new, old):
    """Lane-wise select between two blobs of one structure (``cond`` is
    per lane, the blobs' leading axis)."""
    return tree_map(lambda a, b: torch.where(
        cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b), new, old)


def stack_blob_rows(rows):
    """Per-point blobs stacked along a new leading axis (numpy)."""
    rows = list(rows)
    return tree_map(lambda *bs: np.stack([np.asarray(b) for b in bs]),
                    *rows)


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


def _terminal_width(default=200):
    """Display width of the status line."""
    try:
        return max(shutil.get_terminal_size((default, 20)).columns, 40)
    except (ValueError, OSError):
        return default


def print_fn_fallback(results, niter, ncall, add_live_it=None, dlogz=None,
                      stop_val=None, nbatch=None, logl_min=-np.inf,
                      logl_max=np.inf):
    """Carriage-return stderr status line, cut to the terminal's width.
    Dynamic runs add the batch index, the batch's logl bracket and the
    stopping value."""
    logzerr = np.sqrt(max(results.logzvar, 0.0))
    bits = [f"iter: {niter:d}"]
    if add_live_it is not None:
        bits.append(f"+{add_live_it:d}")
    if nbatch is not None:
        bits.append(f"batch: {nbatch:d}")
    bits += [f"nc: {results.nc:d}", f"ncall: {ncall:d}",
             f"eff(%): {results.eff:6.3f}"]
    if logl_min > -np.inf or logl_max < np.inf:
        bits.append(f"loglstar: {logl_min:.3f} < {results.loglstar:.3f} "
                    f"< {logl_max:.3f}")
    else:
        bits.append(f"loglstar: {results.loglstar:.3f}")
    bits.append(f"logz: {results.logz:.3f} +/- {logzerr:.3f}")
    if dlogz is not None:
        bits.append(f"dlogz: {min(results.delta_logz, 1e10):.3f} > "
                    f"{dlogz:.3f}")
    if stop_val is not None:
        bits.append(f"stop: {stop_val:.3f}")
    sys.stderr.write("\r" + " | ".join(bits)[:_terminal_width() - 1])
    sys.stderr.flush()


def get_print_func(print_func, print_progress):
    """The progress printer: a no-op without progress, the user's
    ``print_func`` if given, else :func:`print_fn_fallback`."""
    if not print_progress:
        return lambda *a, **kw: None
    return print_func if print_func is not None else print_fn_fallback
