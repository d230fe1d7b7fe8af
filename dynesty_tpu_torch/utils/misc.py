"""RNG discipline, weighted statistics, run timings and progress
printing.

Host-side decisions use ``numpy.random.Generator`` instances; device
work draws from explicit ``torch.Generator`` objects seeded from the same
host stream (:func:`get_torch_generator`), so a seed reproduces a run.
The printers are the JAX package's: a tqdm bar where tqdm is installed,
else a carriage-return stderr line with an ETA, and the stateless
``print_fn`` with its three width tiers.
"""

import shutil
import sys
import time
from collections import namedtuple

import numpy as np
import torch

__all__ = [
    "get_random_generator", "get_seed_sequence", "get_torch_generator",
    "torch_generator", "mean_and_cov", "quantile", "resample_equal",
    "IteratorResult", "IteratorResultShort", "IteratorBlock",
    "SamplerHistoryItem", "SQRTEPS", "Timings", "DelayTimer",
    "EtaEstimator", "PrintFnArgs", "get_print_fn_args", "print_fn",
    "print_fn_fallback", "print_fn_tqdm", "get_print_func",
    "tree_map", "blob_row", "blob_where", "stack_blob_rows",
]


class Timings(dict):
    """Wall-clock attribution and counters for one sampler run.

    Seconds (float): ``dispatch`` (blocked in fused device calls,
    device execution and the flat-result download included),
    ``consume`` (host record bookkeeping), ``refit`` (host bound refits),
    ``prelaunch`` (planning a dispatch ahead of its refit and keeping a
    copy of its bound), ``mirror`` (device->host live-state downloads),
    ``add_live``, ``integrals``, ``total``.

    Counts (int): ``n_dispatch``, ``n_round`` (fused rounds consumed: on
    the card, one consume-kernel launch each), ``n_refit``, ``n_prelaunch``
    (dispatches planned ahead of their refit), ``nc_stranded_pipeline``
    (evaluations of a planned dispatch stranded by a terminal stop: always
    0, since a planned dispatch is launched only in its turn),
    ``nc_launched`` and the host synchronisations forced by data-dependent
    loops:
    ``sync_wave`` (one per rejection wave of the uniform kernels),
    ``sync_slice`` (one per slice state-machine iteration; in doubling
    mode one per expansion, per shrink and per halving of the acceptance
    test), ``sync_round`` (the round gate: the read that finds it set,
    at most one a dispatch, or for the random walk and a plain propose
    function one read a round; and on the CPU the thin-path choice) and
    ``sync_flat`` (one result download per dispatch).  The random-walk
    kernel adds none.  ``n_replay`` and ``n_continuation`` count the
    consume-only replays and the continuation dispatches of a resumed
    run.  The slice state machine on the card: ``n_slice_replay``
    (iterations run as one CUDA graph replay), ``n_slice_graph`` (graphs
    captured, one a round shape, each after one warm-up iteration run
    eagerly); the random walk on the card: ``n_rwalk_replay`` (rounds run
    as one replay of the whole walk), ``n_rwalk_graph`` (walks captured,
    one a round shape, each after one warm-up round run eagerly); the
    uniform waves on the card: ``n_unif_replay`` (waves run as one replay
    of the whole wave), ``n_unif_graph`` (waves captured, one a wave
    shape, each after one warm-up wave run eagerly); the fused rounds'
    prologue and epilogue on the card: ``n_round_replay`` (rounds run as
    one replay of each), ``n_round_graph`` (pairs captured, one a round
    shape, each after one round run eagerly); and ``n_uncaptured``
    (slice and walk rounds, and uniform waves, that replayed nothing: a
    random walk's warm-up round, a uniform warm-up wave, a wave over a
    user's bound drawn on the host, host mode, the evaluation history, a
    mesh of several devices, or a capture that raised).  Event lists
    (:meth:`mark`) hold one entry per event.
    """

    def add(self, key, dt):
        self[key] = self.get(key, 0.0) + dt

    def count(self, key, n=1):
        self[key] = self.get(key, 0) + n

    def mark(self, key, entry):
        """Append one event to the run's list ``key``."""
        self.setdefault(key, []).append(entry)

    def merge(self, other):
        """Add another run's timings to these (the dynamic sampler sums
        its base run and every batch into one view); event lists
        concatenate."""
        for k, v in (other or {}).items():
            if isinstance(v, list):
                self[k] = self.get(k, []) + v
            else:
                self[k] = self.get(k, type(v)(0)) + v
        return self


# machine-precision tolerance of the weight normalisation checks
SQRTEPS = float(np.sqrt(np.finfo(np.float64).eps))

# one recorded likelihood evaluation (the history file stores columns; the
# record is part of the public surface for custom history consumers)
SamplerHistoryItem = namedtuple("SamplerHistoryItem", ["u", "v", "logl"])


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


def release_default_generator(device):
    """Give the default CUDA generator of ``device`` a fresh state with
    its seed and offset.  Every CUDA graph capture registers that
    generator, and a capture whose end raised (its stream invalidated,
    for example by a host read inside it) leaves it in capture mode, so
    that its next draw outside a capture raises."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    default = torch.cuda.default_generators[index]
    default.graphsafe_set_state(default.clone_state())


def mean_and_cov(samples, weights):
    """Weighted mean and (frequency-weight corrected) covariance of
    ``samples`` (n, ndim) under ``weights`` (n,)."""
    samples = np.asarray(samples, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    wsum = weights.sum()
    mean = np.einsum("i,ij->j", weights, samples) / wsum
    dx = samples - mean
    wt = weights / wsum
    cov = np.einsum("i,ij,ik->jk", wt, dx, dx)
    # correct for the effective-sample-size bias of weighted estimates
    cov /= 1.0 - (wt ** 2).sum()
    return mean, cov


def quantile(x, q, weights=None):
    """Weighted quantiles of 1-D data ``x`` at quantiles ``q`` in [0, 1]."""
    x = np.atleast_1d(x)
    q = np.atleast_1d(q)
    if np.any(q < 0.0) or np.any(q > 1.0):
        raise ValueError("Quantiles must be between 0. and 1.")
    if weights is None:
        return np.percentile(x, 100.0 * q)
    weights = np.atleast_1d(weights)
    if len(x) != len(weights):
        raise ValueError("Dimension mismatch: len(weights) != len(x).")
    idx = np.argsort(x)
    sw = weights[idx]
    cdf = np.cumsum(sw)[:-1]
    cdf /= cdf[-1]
    cdf = np.append(0, cdf)
    return np.interp(q, cdf, x[idx]).tolist()


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


# --------------------------------------------------------------------------
# progress printing


def _format_status(results, niter, ncall, add_live_it=None, dlogz=None,
                   stop_val=None, nbatch=None, logl_min=-np.inf,
                   logl_max=np.inf):
    """The status line of the per-run printers (every field)."""
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
        # readable early in a run
        bits.append(f"dlogz: {min(results.delta_logz, 1e10):.3f} > "
                    f"{dlogz:.3f}")
    if stop_val is not None:
        bits.append(f"stop: {stop_val:.3f}")
    return " | ".join(bits)


class EtaEstimator:
    """Remaining iterations and seconds for the progress display.

    A static run fits a slope to the recent ``ln(delta_logz)`` (the
    remaining evidence decays geometrically, so the trend is about
    linear) and extrapolates it to the ``dlogz`` target; a dynamic batch
    with a finite log-likelihood bracket uses the share of the bracket
    crossed."""

    def __init__(self, max_points=10):
        self.history = []  # (niter, ln delta_logz)
        self.times = []  # (time, niter)
        self.max_points = max_points
        self.batch = None
        self.batch_start = None

    def _push(self, store, point):
        if len(store) == 0 or point[0] > store[-1][0]:
            store.append(point)
            if len(store) > self.max_points:
                store.pop(0)

    def remaining_iters(self, niter, delta_logz, dlogz, nbatch=None,
                        loglstar=None, logl_min=-np.inf, logl_max=np.inf):
        """Estimated iterations left, or None when there is no estimate."""
        if (nbatch is not None and loglstar is not None
                and np.isfinite(logl_min) and np.isfinite(logl_max)
                and np.isfinite(loglstar) and logl_max > logl_min):
            if self.batch != nbatch:
                self.batch = nbatch
                self.batch_start = niter
            prog = float(np.clip(
                (loglstar - logl_min) / (logl_max - logl_min), 0.0, 0.999))
            if prog <= 1e-3:
                return None
            done = max(niter - self.batch_start, 1)
            rem = done * (1.0 - prog) / prog
            return int(np.ceil(rem)) if np.isfinite(rem) else None
        if dlogz is None or not np.isfinite(dlogz) or dlogz <= 0:
            return None
        if delta_logz is None or not (np.isfinite(delta_logz)
                                      and delta_logz > dlogz):
            return 0
        self._push(self.history, (niter, np.log(delta_logz)))
        if len(self.history) < 3:
            return None
        pts = np.asarray(self.history, dtype=float)
        if np.allclose(pts[:, 0], pts[0, 0]):
            return None
        slope = np.polyfit(pts[:, 0], pts[:, 1], 1)[0]
        if slope >= 0:
            return None
        rem = (np.log(delta_logz) - np.log(dlogz)) / (-slope)
        return int(np.ceil(rem)) if np.isfinite(rem) else None

    def eta_seconds(self, niter, rem_iters):
        """Wall-clock estimate from the recent iteration rate."""
        self._push(self.times, (time.time(), niter))
        if rem_iters is None or len(self.times) < 2:
            return None
        (t0, n0), (t1, n1) = self.times[0], self.times[-1]
        if n1 <= n0:
            return None
        return rem_iters * (t1 - t0) / (n1 - n0)


def _terminal_width(default=200):
    """Display width of the status line."""
    try:
        return max(shutil.get_terminal_size((default, 20)).columns, 40)
    except (ValueError, OSError):
        return default


class _FallbackPrinter:
    """Carriage-return stderr status line with an ETA; one per
    ``run_nested`` call (made by :func:`get_print_func`), so that two runs
    never share an estimator."""

    def __init__(self):
        self.eta = EtaEstimator()

    def __call__(self, results, niter, ncall, add_live_it=None, dlogz=None,
                 stop_val=None, nbatch=None, logl_min=-np.inf,
                 logl_max=np.inf):
        line = _format_status(results, niter, ncall,
                              add_live_it=add_live_it, dlogz=dlogz,
                              stop_val=stop_val, nbatch=nbatch,
                              logl_min=logl_min, logl_max=logl_max)
        rem = self.eta.remaining_iters(niter, results.delta_logz, dlogz,
                                       nbatch=nbatch,
                                       loglstar=results.loglstar,
                                       logl_min=logl_min,
                                       logl_max=logl_max)
        eta = self.eta.eta_seconds(niter, rem)
        if eta is not None and eta > 0:
            m, s = divmod(int(eta), 60)
            h, m = divmod(m, 60)
            line += f" | eta: {h:d}:{m:02d}:{s:02d}" if h else \
                f" | eta: {m:d}:{s:02d}"
        width = _terminal_width() - 1
        sys.stderr.write("\r" + line[:width].ljust(min(width, 120)))
        sys.stderr.flush()

    def close(self):
        pass


# the three status tiers of the width-adaptive printer: long has every
# field, short compresses the numbers, mid is short plus the stopping tail
PrintFnArgs = namedtuple("PrintFnArgs",
                         ["niter", "short_str", "mid_str", "long_str"])


def get_print_fn_args(itresult, niter, ncall, add_live_it=None, dlogz=None,
                      stop_val=None, nbatch=None, logl_min=-np.inf,
                      logl_max=np.inf):
    """The status tiers of one iterator record (:class:`IteratorResult` or
    :class:`IteratorResultShort`)."""
    loglstar = itresult.loglstar if itresult.loglstar > -1e6 else -np.inf
    logz = itresult.logz if itresult.logz > -1e6 else -np.inf
    # above 1e6 the margin is unconverged: printed as inf
    delta_logz = itresult.delta_logz if itresult.delta_logz <= 1e6 \
        else np.inf
    logzvar = itresult.logzvar
    logzerr = np.sqrt(logzvar) if 0.0 <= logzvar <= 1e6 else np.nan

    prefix = [] if add_live_it is None else [f"+{add_live_it:d}"]
    long_str = list(prefix)
    short_str = list(prefix)
    if nbatch is not None:
        long_str.append(f"batch: {nbatch:d}")
    long_str += [f"bound: {itresult.bounditer:d}", f"nc: {itresult.nc:d}",
                 f"ncall: {ncall:d}"]
    eff = f"eff(%): {itresult.eff:6.3f}"
    long_str.append(eff)
    short_str.append(eff)

    if np.isfinite(logl_min) or np.isfinite(logl_max):
        lo = f"{logl_min:6.3f} < " if np.isfinite(logl_min) else ""
        hi = f" < {logl_max:6.3f}" if np.isfinite(logl_max) else ""
        long_str.append(f"loglstar: {lo}{loglstar:6.3f}{hi}")
        lo = f"{logl_min:6.1f}<" if np.isfinite(logl_min) else ""
        hi = f"<{logl_max:6.1f}" if np.isfinite(logl_max) else ""
        short_str.append(f"logl*: {lo}{loglstar:6.1f}{hi}")
    else:
        long_str.append(f"loglstar: {loglstar:6.3f}")
        short_str.append(f"logl*: {loglstar:6.1f}")

    err_l = "" if np.isnan(logzerr) else f" +/- {logzerr:6.3f}"
    err_s = "" if np.isnan(logzerr) else f"+/-{logzerr:.1f}"
    long_str.append(f"logz: {logz:6.3f}{err_l}")
    short_str.append(f"logz: {logz:6.1f}{err_s}")

    # a dynamic batch (nbatch > 0 with a stop value) reports the stopping
    # value instead of the base run's dlogz margin
    if dlogz is not None and (nbatch in (None, 0) or stop_val is None):
        long_str.append(f"dlogz: {delta_logz:6.3f} > {dlogz:6.3f}")
        mid_str = short_str + [f"dlogz: {delta_logz:6.1f}>{dlogz:6.1f}"]
    elif stop_val is not None:
        tail = f"stop: {stop_val:6.3f}"
        long_str.append(tail)
        mid_str = short_str + [tail]
    else:
        # neither a margin nor a stopping value to show
        mid_str = list(short_str)

    return PrintFnArgs(niter=niter, short_str=short_str, mid_str=mid_str,
                       long_str=long_str)


def print_fn_fallback(itresult, niter, ncall, add_live_it=None, dlogz=None,
                      stop_val=None, nbatch=None, logl_min=-np.inf,
                      logl_max=np.inf):
    """Carriage-return stderr status line, in the mid or short tier when
    the terminal is too narrow for the long one."""
    args = get_print_fn_args(itresult, niter, ncall,
                             add_live_it=add_live_it, dlogz=dlogz,
                             stop_val=stop_val, nbatch=nbatch,
                             logl_min=logl_min, logl_max=logl_max)
    # only the long tier carries the iteration prefix
    tiers = [" | ".join([f"iter: {args.niter:d}"] + args.long_str),
             " | ".join(args.mid_str),
             "|".join(args.short_str)]
    width = _terminal_width() - 1
    line = next((t for t in tiers if len(t) <= width), tiers[-1][:width])
    sys.stderr.write("\r" + line.ljust(min(width, 120)))
    sys.stderr.flush()


def print_fn_tqdm(pbar, itresult, niter, ncall, add_live_it=None,
                  dlogz=None, stop_val=None, nbatch=None, logl_min=-np.inf,
                  logl_max=np.inf):
    """The status through a tqdm progress bar."""
    args = get_print_fn_args(itresult, niter, ncall,
                             add_live_it=add_live_it, dlogz=dlogz,
                             stop_val=stop_val, nbatch=nbatch,
                             logl_min=logl_min, logl_max=logl_max)
    pbar.set_postfix_str(" | ".join(args.long_str), refresh=False)
    pbar.update(args.niter - pbar.n)


def print_fn(results, niter, ncall, add_live_it=None, dlogz=None,
             stop_val=None, nbatch=None, logl_min=-np.inf,
             logl_max=np.inf, pbar=None):
    """Stateless printer for a caller's ``print_func=``: through ``pbar``
    (tqdm) when given, else the width-adaptive stderr line.  ``pbar`` comes
    last, so a positional fourth argument is ``add_live_it``."""
    kwargs = dict(add_live_it=add_live_it, dlogz=dlogz, stop_val=stop_val,
                  nbatch=nbatch, logl_min=logl_min, logl_max=logl_max)
    if pbar is not None:
        print_fn_tqdm(pbar, results, niter, ncall, **kwargs)
    else:
        print_fn_fallback(results, niter, ncall, **kwargs)


class _TqdmPrinter:
    """The status through a tqdm bar (an iteration counter and the status
    as postfix), whose ``total`` is re-estimated at every call so that
    tqdm shows its own ETA."""

    def __init__(self):
        from tqdm import tqdm

        self.pbar = tqdm(total=None, unit="it", leave=True)
        self.eta = EtaEstimator()

    def __call__(self, results, niter, ncall, **kwargs):
        line = _format_status(results, niter, ncall, **kwargs)
        # tqdm shows its own counter: the iter field goes
        self.pbar.set_postfix_str(line.split("| ", 1)[-1], refresh=False)
        rem = self.eta.remaining_iters(
            niter, results.delta_logz, kwargs.get("dlogz"),
            nbatch=kwargs.get("nbatch"), loglstar=results.loglstar,
            logl_min=kwargs.get("logl_min", -np.inf),
            logl_max=kwargs.get("logl_max", np.inf))
        if rem is not None and rem > 0:
            self.pbar.total = max(niter + rem, self.pbar.n + 1)
        else:
            self.pbar.total = None
        self.pbar.update(niter - self.pbar.n)

    def close(self):
        self.pbar.close()


def get_print_func(print_func, print_progress):
    """The progress printer of one run, as ``(pbar, print_func)``: a no-op
    without progress, the caller's ``print_func`` if given, else a tqdm
    bar where tqdm is installed (``pbar`` is then the printer, to be
    closed), else a :class:`_FallbackPrinter`."""
    if not print_progress:
        return None, (lambda *a, **kw: None)
    if print_func is not None:
        return None, print_func
    try:
        printer = _TqdmPrinter()
        return printer, printer
    except ImportError:
        return None, _FallbackPrinter()
