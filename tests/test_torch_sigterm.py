"""SIGTERM fault injection on the port, on the CPU (the cases of
``tests/test_resume.py``'s ``test_sigterm_resume_*``): a child process
runs a fit that checkpoints on a timer, is killed at a fraction of the
fit's measured runtime, and the run restored from its last checkpoint and
finished must give the uninterrupted run's logz, logzerr and niter bit
for bit.

The child's entry points live in this module (spawn children import it by
name); it imports neither JAX nor the JAX package.  The runtime is
measured from the moment the child's first checkpoint appears to the end
of its fit, and the kill comes that fraction of it after the first
checkpoint appears: the interpreter's start, the imports and the first
dispatch do not count, so no fraction kills a child that has nothing
saved yet (the JAX package's test skips then).  A child that finishes
before the kill leaves its final checkpoint, whose resume must give the
same result too.  Tolerance: none, every comparison is ``==``.
"""

import multiprocessing as mp
import os
import tempfile
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NDIM = 2
SEED = 56432
_TIMEOUT = 300


def loglike(x):
    return -0.5 * torch.sum(x * x) - NDIM * 0.5 * np.log(2 * np.pi)


def ptform(u):
    return 10.0 * (2.0 * u - 1.0)


_DYN_RUN = dict(nlive_init=100, nlive_batch=60, maxbatch=3,
                n_effective=1000)


def run_fit(dynamic, checkpoint_file):
    """One full (checkpointing) fit; returns (logz, logzerr, niter)."""
    import dynesty_tpu_torch as dyt

    rstate = np.random.Generator(np.random.PCG64(SEED))
    if dynamic:
        s = dyt.DynamicNestedSampler(loglike, ptform, NDIM, bound="single",
                                     sample="unif", rstate=rstate,
                                     queue_size=32, device="cpu")
        s.run_nested(print_progress=False, checkpoint_file=checkpoint_file,
                     checkpoint_every=0.01, **_DYN_RUN)
    else:
        s = dyt.NestedSampler(loglike, ptform, NDIM, nlive=100,
                              bound="single", sample="unif", rstate=rstate,
                              queue_size=32, device="cpu")
        s.run_nested(print_progress=False, checkpoint_file=checkpoint_file,
                     checkpoint_every=0.01)
    r = s.results
    return float(r.logz[-1]), float(r.logzerr[-1]), int(r.niter)


def child_main(dynamic, checkpoint_file, result_queue):
    """Run the fit to completion; the parent may SIGTERM us mid-flight."""
    torch.set_num_threads(1)
    result_queue.put(run_fit(dynamic, checkpoint_file))


def resume_fit(dynamic, checkpoint_file):
    """Restore from the checkpoint and run to completion."""
    import dynesty_tpu_torch as dyt

    if dynamic:
        s = dyt.DynamicNestedSampler.restore(checkpoint_file)
        s.run_nested(print_progress=False, resume=True,
                     checkpoint_file=checkpoint_file, checkpoint_every=0.01,
                     **_DYN_RUN)
    else:
        s = dyt.NestedSampler.restore(checkpoint_file)
        s.run_nested(print_progress=False, resume=True,
                     checkpoint_file=checkpoint_file, checkpoint_every=0.01)
    r = s.results
    return float(r.logz[-1]), float(r.logzerr[-1]), int(r.niter)


def _start(dynamic, fname):
    """A spawn child running the fit, and the time its first checkpoint
    appeared (a save is a write and a rename: the file appears whole)."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    p = ctx.Process(target=child_main, args=(dynamic, fname, queue))
    p.start()
    deadline = time.perf_counter() + _TIMEOUT
    while not os.path.exists(fname):
        if time.perf_counter() > deadline or p.exitcode is not None:
            p.kill()
            raise RuntimeError("the child wrote no checkpoint")
        time.sleep(0.002)
    return p, queue, time.perf_counter()


def _measure_runtime(dynamic, tmp):
    """Wall-clock of one full (uninterrupted) fit in a child process."""
    p, queue, t0 = _start(dynamic, os.path.join(tmp, "full.pkl"))
    full = queue.get(timeout=_TIMEOUT)
    runtime = time.perf_counter() - t0
    p.join(timeout=_TIMEOUT)
    assert not p.is_alive() and p.exitcode == 0
    return runtime, full


_FULL_RUN_CACHE = {}


def _sigterm_resume_case(dynamic, frac):
    """Kill a checkpointing child at ``frac`` of its measured runtime,
    restore, finish, and require the final result to be bit-identical to
    the uninterrupted run."""
    with tempfile.TemporaryDirectory() as tmp:
        if dynamic not in _FULL_RUN_CACHE:
            _FULL_RUN_CACHE[dynamic] = _measure_runtime(dynamic, tmp)
        runtime, full = _FULL_RUN_CACHE[dynamic]
        fname = os.path.join(tmp, "interrupted.pkl")
        p, queue, _ = _start(dynamic, fname)
        time.sleep(frac * runtime)
        p.terminate()
        p.join(timeout=_TIMEOUT)
        assert not p.is_alive()
        resumed = resume_fit(dynamic, fname)
    assert resumed[0] == full[0], (resumed, full)  # logz bit-identical
    assert resumed[1] == full[1], (resumed, full)  # logzerr bit-identical
    assert resumed[2] == full[2], (resumed, full)  # niter identical


@pytest.mark.parametrize("frac", [0.5, 0.9])
def test_sigterm_resume_static(frac):
    _sigterm_resume_case(False, frac)


@pytest.mark.parametrize("frac", [0.5, 0.9])
def test_sigterm_resume_dynamic(frac):
    _sigterm_resume_case(True, frac)


@pytest.mark.slow
@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("frac", [0.2, 0.75])
def test_sigterm_resume_more_fractions(dynamic, frac):
    _sigterm_resume_case(dynamic, frac)
