"""The port's progress printers (the seven tests of
``tests/test_printing.py``), on the CPU with the terminal width pinned:
the tqdm bar and the stderr fallback must both print a run, and the ETA
estimator must extrapolate the dlogz trend.  The status line, the
fallback printer's output and the ETA estimates are also held against the
JAX package's printers, fed the same records of a port run (static and
dynamic): equal text and equal numbers, since both are the same host
code."""

import io
import os
import shutil
import time
from contextlib import redirect_stderr
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dynesty_tpu.utils.misc as jmisc
import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.utils.misc as tmisc
from dynesty_tpu_torch.utils.misc import (EtaEstimator, get_print_fn_args,
                                          get_print_func, print_fn)

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 2
LNORM = -0.5 * np.log(2 * np.pi) * NDIM


def loglike(x):
    return -0.5 * (x @ x) + LNORM


def ptform(u):
    return 10.0 * (2.0 * u - 1.0)


@pytest.fixture(autouse=True)
def _pinned_width(monkeypatch):
    # which tier the fallback prints depends on the terminal's width
    monkeypatch.setattr(shutil, "get_terminal_size",
                        lambda fallback=None: os.terminal_size((200, 20)))


def _run(print_func=None):
    s = dyt.NestedSampler(loglike, ptform, NDIM, nlive=60, bound="single",
                          sample="unif", rstate=get_rstate(),
                          queue_size=16, device="cpu")
    s.run_nested(print_progress=True, print_func=print_func, maxiter=300)
    return s


def test_printing_tqdm(capsys):
    _run()
    err = capsys.readouterr().err
    assert "logz" in err or "it" in err


def test_printing_fallback(capsys):
    _run(print_func=print_fn)
    err = capsys.readouterr().err
    assert "logz:" in err and "eff(%)" in err


def test_get_print_func_silent():
    pbar, fn = get_print_func(None, False)
    assert pbar is None
    fn(None, 0, 0)  # the no-op swallows anything


def test_eta_estimator_static():
    eta = EtaEstimator()
    # geometric decay: delta_logz halves every 50 iterations
    for i, n in enumerate(range(0, 500, 50)):
        rem = eta.remaining_iters(n, 100.0 * 0.5 ** i, 0.01)
    # at 100 * 0.5^9 ~ 0.2, ~4.3 halvings to 0.01: ~215 iterations
    assert rem is not None and 100 < rem < 400
    assert eta.remaining_iters(500, 0.005, 0.01) == 0


def test_fallback_eta_per_run(monkeypatch, capsys):
    """Two runs through the fallback printer share no ETA history."""
    class _NoTqdm:
        def __init__(self):
            raise ImportError("forced")

    monkeypatch.setattr(tmisc, "_TqdmPrinter", _NoTqdm)
    pbar1, fn1 = tmisc.get_print_func(None, True)
    pbar2, fn2 = tmisc.get_print_func(None, True)
    assert pbar1 is None and pbar2 is None
    assert fn1 is not fn2 and fn1.eta is not fn2.eta
    for i, n in enumerate(range(0, 300, 50)):
        fn1.eta.remaining_iters(n, 100.0 * 0.5 ** i, 0.01)
    assert len(fn1.eta.history) > 0 and fn2.eta.history == []
    # the fallback printer still renders a whole status line
    _run(print_func=fn2)
    assert "logz:" in capsys.readouterr().err


def test_print_fn_signature_parity(capsys):
    """A positional fourth argument is add_live_it (not pbar), and an
    unconverged margin (> 1e6) prints as inf."""
    res = SimpleNamespace(loglstar=-1.0, logz=-5.0, logzvar=0.01,
                          delta_logz=3e7, bounditer=1, nc=2, eff=25.0)
    print_fn(res, 10, 100, 3, 0.01)
    assert "+3" in capsys.readouterr().err
    args = get_print_fn_args(res, 10, 100, dlogz=0.01)
    assert any("inf" in s for s in args.long_str)
    # only the long tier carries the iteration prefix
    assert not any(s.startswith("iter:") for s in args.mid_str)


def test_eta_estimator_batch():
    eta = EtaEstimator()
    # bracket [0, 10], 25 % crossed after 100 iterations
    assert eta.remaining_iters(100, None, None, nbatch=1, loglstar=0.0,
                               logl_min=0.0, logl_max=10.0) is None
    rem = eta.remaining_iters(200, None, None, nbatch=1, loglstar=2.5,
                              logl_min=0.0, logl_max=10.0)
    assert rem is not None and 250 < rem < 350


# --------------------------------------------------------------------------
# against the JAX package's printers, on the same records


def _records(dynamic):
    """The ``(results, niter, ncall, kwargs)`` a port run hands its
    print function, in order."""
    seen = []

    def record(results, niter, ncall, **kw):
        seen.append((results, niter, ncall, kw))

    if dynamic:
        d = dyt.DynamicNestedSampler(loglike, ptform, NDIM, bound="single",
                                     sample="unif", rstate=get_rstate(),
                                     queue_size=16, device="cpu")
        d.run_nested(nlive_init=60, nlive_batch=40, maxbatch=1,
                     print_func=record)
    else:
        s = dyt.NestedSampler(loglike, ptform, NDIM, nlive=60,
                              bound="single", sample="unif",
                              rstate=get_rstate(), queue_size=16,
                              device="cpu")
        s.run_nested(print_func=record, dlogz=0.05)
    return seen


@pytest.fixture(scope="module")
def records():
    return {dyn: _records(dyn) for dyn in (False, True)}


@pytest.mark.parametrize("dynamic", [False, True])
def test_status_line_matches_jax(records, dynamic):
    seen = records[dynamic]
    assert len(seen) > 100
    if dynamic:
        assert {kw.get("nbatch") for _, _, _, kw in seen} == {0, 1}
    for results, niter, ncall, kw in seen:
        assert tmisc._format_status(results, niter, ncall, **kw) == \
            jmisc._format_status(results, niter, ncall, **kw)


@pytest.mark.parametrize("dynamic", [False, True])
def test_fallback_printer_matches_jax(records, dynamic, monkeypatch):
    """The whole stderr output, ETA included: the clock is a counter, so
    both printers see the same times."""
    outputs = []
    for printer in (tmisc._FallbackPrinter, jmisc._FallbackPrinter):
        ticks = iter(range(10**6))
        monkeypatch.setattr(time, "time", lambda: 0.01 * next(ticks))
        fn, buf = printer(), io.StringIO()
        with redirect_stderr(buf):
            for results, niter, ncall, kw in records[dynamic]:
                fn(results, niter, ncall, **kw)
        outputs.append(buf.getvalue())
    assert "logz:" in outputs[0] and "eta:" in outputs[0]
    assert outputs[0] == outputs[1]


@pytest.mark.parametrize("dynamic", [False, True])
def test_eta_estimates_match_jax(records, dynamic):
    ests = [tmisc.EtaEstimator(), jmisc.EtaEstimator()]
    got = [[], []]
    for results, niter, _, kw in records[dynamic]:
        for e, g in zip(ests, got):
            g.append(e.remaining_iters(
                niter, results.delta_logz, kw.get("dlogz"),
                nbatch=kw.get("nbatch"), loglstar=results.loglstar,
                logl_min=kw.get("logl_min", -np.inf),
                logl_max=kw.get("logl_max", np.inf)))
    assert got[0] == got[1]
    assert any(r is not None and r > 0 for r in got[0])
