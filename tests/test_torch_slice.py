"""End to end on the CPU: the port's first slice (RadFriends bounds,
rslice proposals, nlive = 2048, the canonical 3-D correlated Gaussian)
against the analytic evidence and against a JAX run of the same
configuration."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynesty_tpu as dytpu
import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.ops import hopper_kernels as hk

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
SEED = 56432
LOGZ_TRUTH = -8.987  # analytic: -ndim * ln(20), the prior box is +-10


def _problem():
    cov = np.identity(NDIM)
    cov[cov == 0] = 0.95
    cinv = np.linalg.inv(cov)
    lnorm = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(cov)))
    return cinv, lnorm


def _torch_sampler(nlive, bound, **kw):
    cinv, lnorm = _problem()
    cinv_t = torch.as_tensor(cinv)

    def loglike(x):
        return -0.5 * (x @ cinv_t @ x) + lnorm

    def ptform(u):
        return 10.0 * (2.0 * u - 1.0)

    return dyt.NestedSampler(loglike, ptform, NDIM, nlive=nlive,
                             bound=bound, sample="rslice", device="cpu",
                             rstate=get_rstate(SEED), **kw)


def _jax_results(nlive, bound):
    cinv, lnorm = _problem()

    def loglike(x):
        return -0.5 * jnp.dot(x, jnp.asarray(cinv) @ x) + lnorm

    def ptform(u):
        return 10.0 * (2.0 * u - 1.0)

    s = dytpu.NestedSampler(loglike, ptform, NDIM, nlive=nlive,
                            bound=bound, sample="rslice",
                            rstate=get_rstate(SEED))
    s.run_nested(print_progress=False)
    return s.results


def test_slice_balls_rslice_2048_against_truth_and_jax():
    calls = hk.pairwise_min_dist.calls
    s = _torch_sampler(2048, "balls")
    s.run_nested(print_progress=False)
    res = s.results
    logz, err = res.logz[-1], res.logzerr[-1]
    assert abs(logz - LOGZ_TRUTH) < 4 * err
    # the friends radius went through the kernel-path dispatch (on the
    # CPU that is its plain version) at the refits with >= 2048 points
    assert hk.pairwise_min_dist.calls - calls >= 1
    assert s.nbound > 2 and s.timings["n_refit"] == s.nbound - 1
    # every record has finite float64 integrals and the right shapes
    assert res.samples.shape == (res.niter + 2048, NDIM)
    assert np.all(np.isfinite(res.logwt)) and np.all(np.diff(res.logvol) < 0)

    jres = _jax_results(2048, "balls")
    jlogz, jerr = jres.logz[-1], jres.logzerr[-1]
    assert abs(logz - jlogz) < 3 * np.hypot(err, jerr)
    assert abs(res.niter - jres.niter) < 0.1 * jres.niter


def test_single_rslice_reproducible():
    runs = []
    for _ in range(2):
        s = _torch_sampler(256, "single")
        s.run_nested(print_progress=False)
        runs.append(s.results)
    a, b = runs
    assert abs(a.logz[-1] - LOGZ_TRUTH) < 4 * a.logzerr[-1]
    for key in ("logl", "logvol", "logwt", "logz", "logzerr", "ncall",
                "samples", "samples_u", "samples_it", "samples_id",
                "samples_n", "samples_birth", "scale"):
        assert np.array_equal(a[key], b[key]), key
    assert a.niter == b.niter


def test_progress_printing_path(capsys):
    # the default printer is a tqdm bar where tqdm is installed (its
    # counter in place of the iter field), else the stderr line
    try:
        import tqdm  # noqa: F401
        counter = "it/s"
    except ImportError:
        counter = "iter:"
    s = _torch_sampler(64, "single", queue_size=16)
    s.run_nested(print_progress=True, maxiter=200)
    err = capsys.readouterr().err
    assert counter in err and "logz:" in err
    assert s.results.niter >= 200


def test_unported_entry_points_raise():
    with pytest.raises(ValueError, match="device"):
        dyt.NestedSampler(lambda x: x.sum(), lambda u: u, 2, device=None)
    # a custom bound is taken by both factories; a device mesh is the one
    # argument still refused
    user = dyt.bounding.Bound(2)
    s = dyt.NestedSampler(lambda x: -x @ x, lambda u: u, 2, nlive=20,
                          bound=user, sample="unif", device="cpu")
    assert s.bounding is user and s.bound_next is not user
    d = dyt.DynamicNestedSampler(lambda x: -x @ x, lambda u: u, 2, nlive=20,
                                 bound=user, sample="unif", device="cpu")
    assert d.bounding is user
    for factory in (dyt.NestedSampler, dyt.DynamicNestedSampler):
        with pytest.raises(NotImplementedError, match="mesh"):
            factory(lambda x: -x @ x, lambda u: u, 2, nlive=20,
                    mesh=object(), device="cpu")
    # blobs, host mode, a pool and the history arguments are taken by both
    # factories; a host-mode round over a pool of two is 32 wide
    class TwoJobs:
        njobs = 2

        def map(self, fn, items):
            return list(map(fn, items))

    kw = dict(blob=True, likelihood_mode="host", pool=TwoJobs(),
              use_pool={"update_bound": False},
              save_evaluation_history=False, history_filename=None)
    s = dyt.NestedSampler(lambda x: (-x @ x, x[0]), lambda u: u, 2,
                          nlive=500, device="cpu", **kw)
    assert s.blob and s.loglikelihood.mode == "host"
    assert s.live_blobs.shape == (500,) and s.queue_size == 32
    assert s.pool is s.loglikelihood.pool is kw["pool"]
    d = dyt.DynamicNestedSampler(lambda x: -x @ x, lambda u: u, 2,
                                 nlive=500, device="cpu", **kw)
    assert d.blob and d.use_pool["update_bound"] is False
    assert d.queue_size == 32 and d.mapper == kw["pool"].map
    # every sampler name is ported; an unknown one is a ValueError, and so
    # is ncdim with the slice samplers
    with pytest.raises(ValueError, match="Unknown sample"):
        dyt.NestedSampler(lambda x: -x @ x, lambda u: u, 2, nlive=20,
                          sample="hslice", device="cpu")
    with pytest.raises(ValueError, match="ncdim"):
        dyt.NestedSampler(lambda x: -x @ x, lambda u: u, 3, nlive=20,
                          sample="rslice", ncdim=2, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    # without CUDA the default device raises; it never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dyt.NestedSampler(lambda x: -x @ x, lambda u: u, 2, nlive=20,
                          bound="none", sample="rslice")


def test_import_leaves_jax_out():
    # every module of the port, imported in a fresh interpreter
    code = ("import sys, pkgutil, importlib, dynesty_tpu_torch as p; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            "assert 'dynesty_tpu_torch.utils.checkpoint' in sys.modules; "
            "assert 'dynesty_tpu_torch.pool' in sys.modules; "
            "assert {'dynesty_tpu_torch.plotting', "
            "'dynesty_tpu_torch.results', "
            "'dynesty_tpu_torch.internal_samplers', "
            "'dynesty_tpu_torch.utils'} <= set(sys.modules); "
            "assert 'jax' not in sys.modules; "
            "assert 'dynesty_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_sources_name_no_jax_import():
    """No file of the port, nor the GPU smoke test, imports ``jax`` or the
    JAX package (comments and docstrings may name them)."""
    import ast
    import pathlib

    root = pathlib.Path(dyt.__file__).resolve().parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py",
                                          root.parent / "bench_nn_kernel.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "dynesty_tpu"), \
                    (str(path), name)


@pytest.mark.parametrize("bound", ["none", "cubes", "balls"])
def test_small_runs_pass_the_gate(bound):
    s = _torch_sampler(128, bound, queue_size=32)
    s.run_nested(print_progress=False)
    res = s.results
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 4 * res.logzerr[-1]
    assert s.nbound > 1


def test_start_point_outside_the_bound_forces_a_refit():
    s = _torch_sampler(128, "single", queue_size=32)
    s.run_nested(print_progress=False, maxiter=600)
    nbound = s.nbound
    far = int(np.argmax([s.bound.distance(u) for u in s.live_u]))
    s.bound.scale_to_logvol(s.bound.logvol - 3.0)  # shrink: points escape
    assert not s.bound.contains(s.live_u[far])
    s.ensure_startpoints_bounded([far])
    assert s.nbound == nbound + 1 and s.bound.contains(s.live_u[far])
