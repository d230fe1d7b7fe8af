"""The port's examples (``examples/torch_*.py``) run on the CPU at a small
``maxiter``, through their own ``main`` and command line; each must give
a finite evidence of the expected shape (no tolerance: the runs are cut
short, so their evidence is not held to the truth here)."""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finite(res, ndim):
    assert np.all(np.isfinite(res.logz)) and res.logzerr[-1] > 0
    assert res.samples.shape[1] == ndim


@pytest.mark.filterwarnings("ignore")
def test_torch_quickstart(tmp_path):
    mod = _example("torch_quickstart")
    sampler, dns = mod.main(["--device", "cpu", "--maxiter", "300",
                             "--outdir", str(tmp_path)])
    assert sampler.device == torch.device("cpu")
    assert sampler.results.niter == 300
    _finite(sampler.results, 3)
    _finite(dns.results, 3)
    if importlib.util.find_spec("matplotlib") is not None:
        assert os.path.exists(tmp_path / "quickstart_corner.png")


@pytest.mark.filterwarnings("ignore")
def test_torch_quickstart_pulls(capsys):
    mod = _example("torch_quickstart")
    summary, runs = mod.main(["--device", "cpu", "--maxiter", "200",
                              "--pulls", "3-4"])
    assert [r["seed"] for r in runs] == [3, 4] and summary["n"] == 2
    assert all(r["niter"] > 0 and np.isfinite(r["pull"]) for r in runs)
    assert summary["std"] == pytest.approx(
        np.std([r["pull"] for r in runs], ddof=1), rel=1e-12)
    # one JSON line a run, then the summary's
    lines = capsys.readouterr().out.strip().splitlines()[-3:]
    assert [json.loads(x) for x in lines] == runs + [summary]


@pytest.mark.filterwarnings("ignore")
def test_torch_eggbox(tmp_path):
    mod = _example("torch_eggbox")
    sampler = mod.main(["--device", "cpu", "--maxiter", "1500",
                        "--outdir", str(tmp_path)])
    assert sampler.nlive == 1000 and sampler.bounding == "multi"
    _finite(sampler.results, 2)


@pytest.mark.filterwarnings("ignore")
def test_torch_highdim_200():
    mod = _example("torch_highdim_200")
    sampler = mod.main(["--device", "cpu", "--maxiter", "600"])
    assert sampler.ndim == 200 and sampler.results.niter == 600
    _finite(sampler.results, 200)


def test_examples_run_on_the_card_by_default():
    for name in ("torch_quickstart", "torch_eggbox", "torch_highdim_200"):
        src = open(os.path.join(EXAMPLES, name + ".py")).read()
        assert 'default="cuda"' in src
        # the port's examples import neither JAX nor the JAX package
        assert not re.search(r"^\s*(import|from)\s+(jax|dynesty_tpu)\b(?!_)",
                             src, re.M)
