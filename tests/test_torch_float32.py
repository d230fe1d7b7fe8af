"""The port at the JAX package's own precision: ``dtype=torch.float32``.

The JAX package runs in float32 unless x64 is on, and its ``bench.py``
never turns it on, so its bench numbers are float32 runs.  Here, on the
CPU at small sizes, the port's float32 runs are held against the JAX
package's float32 runs of the same configurations and seed (niter within
10 %, both evidences within 4 logzerr of the analytic value), repeated
bit for bit, and stopped, saved, restored and resumed bit for bit with
the uninterrupted run; a float32 run holds no float64 tensor.

The JAX side runs in a subprocess with x64 off: ``tests/conftest.py``
turns x64 on for this process, which would widen the JAX package's
constants.

Tolerance: niter 10 % and 4 logzerr against the JAX package (two
samplers with different random streams); none elsewhere: every other
comparison is ``np.array_equal`` or ``==``.
"""

import json
import math
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import dynesty_tpu_torch as dyt

from utils import get_rstate

torch.set_num_threads(1)

SEED = 56432
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a 5-D form of bench.py's headline (bench.py:320-362): the correlated
# Gaussian with rho 0.4, prior +-10, single/rslice, as many slices as
# dimensions, queue_size 256 (the samplers take nlive // 2) and 24 rounds
# a dispatch, at nlive 100
H5_NDIM, H5_RHO, H5_NLIVE = 5, 0.4, 100
H5_KW = dict(nlive=H5_NLIVE, bound="single", sample="rslice",
             slices=H5_NDIM, queue_size=256, rounds_per_dispatch=24)
H5_TRUTH = -H5_NDIM * math.log(20.0)
# bench.py's heavy row (bench.py:62-130) cut to a chain of width 16 and
# depth 4 at nlive 200: the 3-D correlated Gaussian (rho 0.95) plus 1e-6
# times the chain's sum, multi/unif, queue_size 256, 12 rounds a dispatch
HV_NDIM, HV_WIDTH, HV_LAYERS, HV_NLIVE = 3, 16, 4, 200
HV_KW = dict(nlive=HV_NLIVE, bound="multi", sample="unif", queue_size=256,
             rounds_per_dispatch=12)
HV_TRUTH = -HV_NDIM * math.log(20.0)


def _gauss(ndim, rho):
    cov = np.identity(ndim)
    cov[cov == 0] = rho
    lnorm = -0.5 * (np.log(2 * np.pi) * ndim + np.log(np.linalg.det(cov)))
    return np.linalg.inv(cov), float(lnorm)


def _heavy_weights():
    """bench.py's ``_heavy_weights`` at this width (seed 1234)."""
    rng = np.random.Generator(np.random.PCG64(1234))
    q, _ = np.linalg.qr(rng.standard_normal((HV_WIDTH, HV_WIDTH)))
    w = rng.standard_normal((HV_WIDTH, HV_NDIM)) / np.sqrt(HV_NDIM)
    return 0.9 * q, w


# module level (picklable), every constant float32 as bench.py's under
# JAX without x64
_H5_CINV, _H5_LNORM = _gauss(H5_NDIM, H5_RHO)
_H5_C32 = torch.as_tensor(_H5_CINV, dtype=torch.float32)
_HV_CINV, _HV_LNORM = _gauss(HV_NDIM, 0.95)
_HV_C32 = torch.as_tensor(_HV_CINV, dtype=torch.float32)
_HV_A32, _HV_W32 = (torch.as_tensor(m, dtype=torch.float32)
                    for m in _heavy_weights())


def headline_loglike32(x):
    return -0.5 * (x @ (_H5_C32 @ x)) + _H5_LNORM


def heavy_loglike32(x):
    h = torch.tanh(_HV_W32 @ x)
    for _ in range(HV_LAYERS):
        h = torch.tanh(_HV_A32 @ h)
    return -0.5 * (x @ _HV_C32 @ x) + _HV_LNORM + 1e-6 * h.sum()


def box_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


CONFIGS = {
    "headline5": (headline_loglike32, H5_NDIM, H5_KW, H5_TRUTH),
    "heavy": (heavy_loglike32, HV_NDIM, HV_KW, HV_TRUTH),
}

# the JAX package's runs of the same configurations, float32 (x64 off)
JAX_SCRIPT = r"""
import json, math, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
import jax.numpy as jnp
sys.path.insert(0, sys.argv[1])
import dynesty_tpu as dytpu
cfg = json.loads(sys.argv[2])

def gauss(ndim, rho):
    cov = np.identity(ndim)
    cov[cov == 0] = rho
    lnorm = -0.5 * (np.log(2 * np.pi) * ndim + np.log(np.linalg.det(cov)))
    return jnp.asarray(np.linalg.inv(cov).astype(np.float32)), float(lnorm)

h5c, h5n = gauss(cfg["h5_ndim"], cfg["h5_rho"])
hvc, hvn = gauss(cfg["hv_ndim"], 0.95)
rng = np.random.Generator(np.random.PCG64(1234))
q, _ = np.linalg.qr(rng.standard_normal((cfg["hv_width"], cfg["hv_width"])))
a = jnp.asarray(0.9 * q, jnp.float32)
w = jnp.asarray(rng.standard_normal((cfg["hv_width"], cfg["hv_ndim"])) /
                np.sqrt(cfg["hv_ndim"]), jnp.float32)

def headline(x):
    return -0.5 * jnp.dot(x, h5c @ x) + h5n

def heavy(x):
    h = jnp.tanh(w @ x.astype(jnp.float32))
    for _ in range(cfg["hv_layers"]):
        h = jnp.tanh(a @ h)
    return -0.5 * x @ hvc @ x + hvn + 1e-6 * h.sum().astype(x.dtype)

def ptform(u):
    return 10.0 * (2.0 * u - 1.0)

out = {}
for name, fn, ndim, kw in (("headline5", headline, cfg["h5_ndim"],
                            cfg["h5_kw"]),
                           ("heavy", heavy, cfg["hv_ndim"], cfg["hv_kw"])):
    s = dytpu.NestedSampler(fn, ptform, ndim, dtype=jnp.float32,
                            rstate=np.random.Generator(
                                np.random.PCG64(cfg["seed"])), **kw)
    s.run_nested(print_progress=False)
    r = s.results
    out[name] = {"niter": int(r.niter), "ncall": int(s.ncall),
                 "logz": float(r.logz[-1]), "logzerr": float(r.logzerr[-1]),
                 "dtype": str(jnp.dtype(s.dtype)),
                 "logl_dtype": str(jnp.asarray(s.live_logl).dtype)}
print("JAXRUNS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_runs():
    """Both configurations in the JAX package, float32, one subprocess."""
    cfg = {"seed": SEED, "h5_ndim": H5_NDIM, "h5_rho": H5_RHO,
           "h5_kw": H5_KW, "hv_ndim": HV_NDIM, "hv_width": HV_WIDTH,
           "hv_layers": HV_LAYERS, "hv_kw": HV_KW}
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="0",
               OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", JAX_SCRIPT, ROOT,
                           json.dumps(cfg)], env=env, capture_output=True,
                          text=True, timeout=600)
    line = [ln for ln in done.stdout.splitlines()
            if ln.startswith("JAXRUNS ")]
    assert done.returncode == 0 and line, done.stderr[-3000:]
    return json.loads(line[-1][len("JAXRUNS "):])


def _run(s, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.run_nested(print_progress=False, **kw)
    return s


def _sampler(name, dtype=torch.float32, **extra):
    loglike, ndim, kw, _ = CONFIGS[name]
    return dyt.NestedSampler(loglike, box_ptform, ndim, dtype=dtype,
                             device="cpu", rstate=get_rstate(SEED),
                             **dict(kw, **extra))


_FULL = {}


def _full(name):
    """The uninterrupted float32 run of a configuration (made once)."""
    if name not in _FULL:
        _FULL[name] = _run(_sampler(name))
    return _FULL[name]


def float64_tensors(sampler):
    """The float64 tensors a sampler and its inner sampler hold (their
    round caches and buffers, four levels deep)."""
    found = []

    def walk(obj, path, depth):
        if isinstance(obj, torch.Tensor):
            if obj.dtype == torch.float64:
                found.append(path)
        elif depth < 4 and isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}[{k!r}]", depth + 1)
        elif depth < 4 and isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}[{i}]", depth + 1)
        elif depth < 4 and type(obj).__module__.startswith(
                "dynesty_tpu_torch") and hasattr(obj, "__dict__"):
            for k, v in vars(obj).items():
                walk(v, f"{path}.{k}", depth + 1)

    walk(sampler, "sampler", 0)
    walk(sampler.internal_sampler, "inner", 0)
    return found


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float32_run_matches_the_jax_packages(name, jax_runs):
    """The port's float32 run against the JAX package's float32 run of
    the same configuration and seed: niter within 10 %, both evidences
    within 4 logzerr of the analytic value."""
    s = _full(name)
    truth = CONFIGS[name][3]
    res, ref = s.results, jax_runs[name]
    assert ref["dtype"] == ref["logl_dtype"] == "float32"
    assert s.dtype == torch.float32 and not float64_tensors(s)
    assert abs(res.niter - ref["niter"]) <= 0.1 * ref["niter"], \
        (res.niter, ref)
    assert abs(res.logz[-1] - truth) < 4 * res.logzerr[-1]
    assert abs(ref["logz"] - truth) < 4 * ref["logzerr"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float32_run_repeats_bit_for_bit(name):
    a, b = _full(name), _run(_sampler(name))
    assert a.results.niter == b.results.niter and a.ncall == b.ncall
    for k in ("logl", "logz", "logzerr", "logvol", "samples", "samples_u",
              "ncall", "scale"):
        assert np.array_equal(np.asarray(a.results[k]),
                              np.asarray(b.results[k])), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float32_resume_equals_the_uninterrupted_run(name, tmp_path):
    full = _full(name)
    fname = str(tmp_path / "f32.pkl")
    s = _run(_sampler(name), maxiter=full.results.niter // 2,
             add_live=False)
    assert s.interrupted_budget
    s.save(fname)
    del s
    s2 = dyt.NestedSampler.restore(fname)
    assert s2.dtype == torch.float32
    _run(s2, resume=True)
    a, b = s2.results, full.results
    assert a.niter == b.niter and s2.ncall == full.ncall
    for k in ("logz", "logzerr", "logl", "logvol", "logwt", "samples",
              "samples_u", "samples_it", "samples_id", "ncall", "scale"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert not float64_tensors(s2)
