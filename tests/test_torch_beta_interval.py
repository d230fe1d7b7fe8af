"""The beta-interval likelihood (``chip_smoke.py`` phase 27c) in both
packages on the CPU, and the JAX module's names ``ndtri`` and ``betainc``
in the port's ``models.priors``.

The likelihood is the probability that a Beta(a_d, b_d) variable falls
within ``W`` of theta_d, multiplied over three dimensions of the unit
cube: log(I_{min(theta + W, 1)}(a, b) - I_{max(theta - W, 0)}(a, b) +
1e-300) summed, the six CDF values of a point from one ``betainc`` call
(``dynesty_tpu.models.priors.betainc``, ``jax.scipy.special.betainc``,
in the JAX package; ``dynesty_tpu_torch.models.priors.betainc`` in the
port, its plain version on the CPU).  The 1e-300 keeps logL finite where
both CDFs round to 1 in a Beta's far upper tail.

Tolerances.  Each ``betainc`` value at 1e-10 absolute (the two continued
fractions agree with ``scipy.special.betainc`` so,
``tests/test_torch_models.py``); logL at 1e-6 relative where it is above
-50 (below, the log of a difference of two CDFs within a few ulp of each
other magnifies an ulp).  The runs draw from torch's generator in the
port and JAX's in the JAX package: niter within 10 %, logz within 3
combined errors of each other and each within 4 logzerr of the
quadrature (``scipy.integrate.quad`` of ``scipy.special.betainc``).
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate as si
import scipy.special as sp
import torch

import dynesty_tpu as dytpu
import dynesty_tpu.models.priors as jp
import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.models.priors as tp
from dynesty_tpu_torch.ops import beta_prior as bp

from utils import get_rstate

torch.set_num_threads(1)

AB = ((20.0, 30.0), (5.0, 5.0), (30.0, 20.0))
W, FLOOR = 0.01, 1e-300
_A = [a for a, _ in AB] * 2
_B = [b for _, b in AB] * 2
_TA = torch.tensor(_A, dtype=torch.float64)
_TB = torch.tensor(_B, dtype=torch.float64)


def _cdf_points_jax(theta):
    return jnp.concatenate([jnp.minimum(theta + W, 1.0),
                            jnp.maximum(theta - W, 0.0)])


def _cdf_points_torch(theta):
    return torch.cat([torch.clamp(theta + W, max=1.0),
                      torch.clamp(theta - W, min=0.0)])


def jax_like(theta):
    cdf = jp.betainc(jnp.asarray(_A), jnp.asarray(_B),
                     _cdf_points_jax(theta))
    return jnp.sum(jnp.log(cdf[:3] - cdf[3:] + FLOOR))


def torch_like(theta):
    cdf = tp.betainc(_TA, _TB, _cdf_points_torch(theta))
    return torch.log(cdf[:3] - cdf[3:] + FLOOR).sum()


def unit_cube(u):
    return u


def truth():
    out = 0.0
    for a, b in AB:
        v, _ = si.quad(lambda t: sp.betainc(a, b, min(t + W, 1.0)) -
                       sp.betainc(a, b, max(t - W, 0.0)) + FLOOR, 0.0, 1.0,
                       points=[a / (a + b)], limit=200)
        out += math.log(v)
    return out


def _points(n, seed=7):
    """Seeded points of the unit cube, the first rows at the clamps' ends
    and in the Betas' far tails."""
    th = get_rstate(seed).random((n, 3))
    th[:6] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.004, 0.5, 0.996],
              [0.996, 0.004, 0.5], [0.95, 0.99, 0.05], [0.4, 0.5, 0.6]]
    return th


def test_the_port_binds_the_jax_module_names():
    """``ndtri`` and ``betainc`` in the port's ``models.priors`` as in the
    JAX module's (``_betainc`` an alias), held to the JAX module's at
    seeded points at 1e-10 absolute."""
    assert tp.betainc is bp.betainc and tp._betainc is tp.betainc
    assert tp.ndtri is torch.special.ndtri
    rng = get_rstate(3)
    u = rng.uniform(1e-9, 1 - 1e-9, 500)
    np.testing.assert_allclose(tp.ndtri(torch.as_tensor(u)).numpy(),
                               np.asarray(jp.ndtri(jnp.asarray(u))),
                               rtol=0, atol=1e-10)
    grid = [0.5, 1.0, 2.0, 5.0, 20.0, 30.0]
    a = rng.choice(grid, 2000)
    b = rng.choice(grid, 2000)
    x = rng.random(2000)
    got = tp.betainc(torch.as_tensor(a), torch.as_tensor(b),
                     torch.as_tensor(x)).numpy()
    want = np.asarray(jp.betainc(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    # numbers a, b as in the JAX module's calls
    np.testing.assert_allclose(
        tp.betainc(2.0, 5.0, torch.as_tensor(x)).numpy(),
        np.asarray(jp.betainc(2.0, 5.0, jnp.asarray(x))), rtol=0,
        atol=1e-10)


def test_the_interval_likelihood_matches_jax():
    """On 300 seeded points, batched as a wave calls it (``vmap`` in each
    package): the six ``betainc`` values of each point at 1e-10
    absolute, and logL at 1e-6 relative where it is above -50 and -inf
    nowhere."""
    th = _points(300)
    cdf_j = np.asarray(jax.vmap(lambda t: jp.betainc(
        jnp.asarray(_A), jnp.asarray(_B), _cdf_points_jax(t)))(
            jnp.asarray(th)))
    cdf_t = torch.func.vmap(lambda t: tp.betainc(
        _TA, _TB, _cdf_points_torch(t)))(torch.as_tensor(th)).numpy()
    np.testing.assert_allclose(cdf_t, cdf_j, rtol=0, atol=1e-10)
    lj = np.asarray(jax.vmap(jax_like)(jnp.asarray(th)))
    lt = torch.func.vmap(torch_like)(torch.as_tensor(th)).numpy()
    assert np.all(np.isfinite(lt)) and np.all(np.isfinite(lj))
    live = lj > -50
    assert live.sum() > 100
    np.testing.assert_allclose(lt[live], lj[live], rtol=1e-6, atol=0)


def _run_pair(nlive, q):
    common = dict(nlive=nlive, queue_size=q)
    js = dytpu.NestedSampler(jax_like, unit_cube, 3, rstate=get_rstate(),
                             **common)
    ts = dyt.NestedSampler(torch_like, unit_cube, 3, rstate=get_rstate(),
                           device="cpu", **common)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js.run_nested(print_progress=False)
        ts.run_nested(print_progress=False)
    return js.results, ts.results


def _check_pair(jr, tr, want):
    assert abs(tr.niter - jr.niter) <= 0.1 * jr.niter, (tr.niter, jr.niter)
    err = np.hypot(tr.logzerr[-1], jr.logzerr[-1])
    assert abs(tr.logz[-1] - jr.logz[-1]) < 3 * err, \
        (tr.logz[-1], jr.logz[-1], err)
    for r in (tr, jr):
        assert abs(r.logz[-1] - want) < 4 * r.logzerr[-1], \
            (r.logz[-1], want, r.logzerr[-1])
        assert np.all((r.samples >= 0) & (r.samples <= 1))


def test_a_short_beta_interval_run_matches_jax():
    """nlive 80, q 32, every other argument at its default (multi /
    unif), in both packages on the CPU."""
    jr, tr = _run_pair(nlive=80, q=32)
    _check_pair(jr, tr, truth())


def test_the_truth_is_near_three_log_two_w():
    """The quadrature's log Z is near 3 ln(2 W) (each interval holds ~2W
    of its Beta's mass on average over theta)."""
    assert abs(truth() - 3 * math.log(2 * W)) < 0.05
