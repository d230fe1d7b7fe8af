"""The remaining proposal kernels of the port (rwalk, slice, the doubling
form of the slice kernels) and the replay round, against the JAX package on
the CPU.

Tolerances.  Deterministic parts get the same numpy inputs in both
packages: boundary wrapping and every integer or copied column must be
bit-identical; scale tuning agrees to 1e-12 relative (``exp`` differs by an
ulp between XLA and torch); the replay round's integrator columns to 1e-12
relative, as in ``test_torch_fused.py``.  The random kernels draw from
torch Philox and JAX threefry, which never give the same stream, so they
are held to the distributional gate of ``tests/test_sampling.py`` and whole
runs to the analytic evidence and to the JAX run's niter within 10 %.
"""

import math
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import kstest, norm

import dynesty_tpu as dytpu
import dynesty_tpu.internal.fused as jfused
import dynesty_tpu.internal.kernels as jk
import dynesty_tpu.internal.likelihood as jlike
import dynesty_tpu.internal.samplers as jsam
import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.internal.fused as tfused
import dynesty_tpu_torch.internal.kernels as tk
import dynesty_tpu_torch.internal.samplers as tsam
import dynesty_tpu_torch.ops.geometry as tgeo
from dynesty_tpu_torch.internal.likelihood import LogLikelihood
from dynesty_tpu_torch.utils.convert import live_to_torch
from dynesty_tpu_torch.utils.misc import Timings, torch_generator

from test_torch_fused import _state
from utils import get_rstate

torch.set_num_threads(1)

SEED = 56432


# --------------------------------------------------------------------------
# deterministic parts against the JAX functions


def test_wrap_boundaries_bit_identical():
    rs = get_rstate(3)
    u = rs.uniform(-2.5, 3.5, size=(200, 4))
    u[0] = [0.0, 1.0, 2.0, -1.0]  # the edges themselves
    periodic, reflective = [0], [1, 3]
    for per, ref in ((None, None), (periodic, None), (None, reflective),
                     (periodic, reflective)):
        j = jk._wrap_boundaries(jnp.asarray(u),
                                jk._mask_from_indices(per, 4),
                                jk._mask_from_indices(ref, 4))
        t = tk._wrap_boundaries(torch.from_numpy(u),
                                tk._mask_from_indices(per, 4),
                                tk._mask_from_indices(ref, 4))
        assert np.array_equal(np.asarray(j), t.numpy())
    wrapped = t.numpy()
    assert np.all((wrapped[:, [0, 1, 3]] >= 0) &
                  (wrapped[:, [0, 1, 3]] <= 1))
    assert np.array_equal(wrapped[:, 2], u[:, 2])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_slice_directions_are_permuted_scaled_axes(dtype):
    """kind='slice': in every (lane, pass) the directions are the columns
    of the lane's axes times the scale, each exactly once."""
    q, ndim, slices, scale = 64, 4, 3, 0.7
    rs = get_rstate(5)
    axes = torch.as_tensor(rs.normal(size=(q, ndim, ndim)), dtype=dtype)
    dirs = tk.slice_directions(torch_generator(SEED, "cpu"), axes, scale,
                               "slice", slices)
    assert dirs.shape == (q, slices * ndim, ndim) and dirs.dtype == dtype
    cols = (axes.transpose(1, 2) * scale).numpy()  # (q, axis, ndim)
    d = dirs.numpy().reshape(q, slices, ndim, ndim)
    orders = set()
    for lane in range(q):
        for s in range(slices):
            # match every direction to the axis it copies, bit for bit
            match = (d[lane, s][:, None, :] == cols[lane][None]).all(-1)
            assert np.array_equal(match.sum(0), np.ones(ndim))
            assert np.array_equal(match.sum(1), np.ones(ndim))
            orders.add(tuple(match.argmax(1)))
    assert len(orders) > 10  # the shuffles differ between lanes and passes
    # rslice: unit directions through the axes, times the scale
    r = tk.slice_directions(torch_generator(SEED, "cpu"), axes, scale,
                            "rslice", slices)
    back = torch.linalg.solve(axes[:, None], r[..., None])[..., 0] / scale
    np.testing.assert_allclose(back.norm(dim=-1).numpy(), 1.0, rtol=2e-3)


def _closure_fn(fn, name, seen=None):
    """The function called ``name`` among the closures under ``fn``."""
    seen = seen if seen is not None else set()
    fn = getattr(fn, "__wrapped__", fn)
    if id(fn) in seen or not hasattr(fn, "__closure__"):
        return None
    seen.add(id(fn))
    if getattr(fn, "__name__", None) == name:
        return fn
    for cell in fn.__closure__ or ():
        try:
            val = cell.cell_contents
        except ValueError:
            continue
        if callable(val):
            found = _closure_fn(val, name, seen)
            if found is not None:
                return found
    return None


def test_doubling_accept_matches_jax():
    """One batched Neal (2003) acceptance test on given intervals: the
    accept mask and the evaluation counts equal the JAX package's."""
    q, ndim, sigma = 96, 2, 0.08
    rs = get_rstate(9)
    u0 = rs.uniform(0.35, 0.65, size=(q, ndim))
    direction = rs.normal(size=(q, ndim)) * 0.02
    width = 2.0 ** rs.integers(0, 5, size=q)  # 1 .. 16 unit steps
    left = -rs.random(q) * width
    right = left + width
    x1 = left + rs.random(q) * width

    def np_logl(x):
        u = u0 + x[:, None] * direction
        logl = -0.5 * ((u - 0.5) ** 2).sum(1) / sigma ** 2
        return np.where(((u > 0) & (u < 1)).all(1), logl, -np.inf)

    f_left, f_right = np_logl(left), np_logl(right)
    # a threshold that cuts through the sampled intervals
    loglstar = float(np.median(np_logl(x1)))

    jl = jlike.LogLikelihood(
        lambda v: -0.5 * jnp.sum((v - 0.5) ** 2) / sigma ** 2,
        lambda u: u, ndim)
    jl.eval_host(u0[:2])
    jfn = jk.make_slice_round(jl, ndim=ndim, q=q, slices=2, kind="rslice",
                              doubling=True, dtype=jnp.float64)
    j_accept = _closure_fn(jfn, "doubling_accept")
    assert j_accept is not None
    jacc, jnc = j_accept(*[jnp.asarray(a) for a in (x1, u0, direction)],
                         loglstar, *[jnp.asarray(a) for a in
                                     (left, right, f_left, f_right)])

    tl = LogLikelihood(
        lambda v: -0.5 * ((v - 0.5) ** 2).sum() / sigma ** 2, lambda u: u,
        ndim, device="cpu")
    tl.eval_host(u0[:2])
    u0_t, dir_t = torch.from_numpy(u0), torch.from_numpy(direction)

    def feval(x, mask):
        u = u0_t + x[:, None] * dir_t
        return tk._masked_eval(tl, u, tgeo.unitcheck_batch(u) & mask)[1]

    timings = Timings()
    tacc, tnc = tk.doubling_accept(
        feval, *[torch.from_numpy(a) for a in (x1,)], loglstar,
        *[torch.from_numpy(a) for a in (left, right, f_left, f_right)],
        timings=timings)
    assert np.array_equal(np.asarray(jacc), tacc.numpy())
    assert np.array_equal(np.asarray(jnc), tnc.numpy())
    # both outcomes occur, intervals of one step are accepted untested, and
    # every halving cost one host read
    assert 0 < tacc.sum() < q
    assert np.all(tnc.numpy()[width <= 1] == 0) and tnc.max() >= 3
    assert timings["sync_slice"] == tnc.max() + 1


def test_rwalk_tuning_matches_jax():
    kw = dict(ndim=6, ncdim=4, walks=30, facc=0.4)
    js, ts = jsam.RWalkSampler(**kw), tsam.RWalkSampler(**kw)
    assert (ts.walks, ts.facc, ts.ncdim) == (js.walks, js.facc, js.ncdim)
    assert ts.update_bound_interval_ratio == js.update_bound_interval_ratio
    assert ts._fused_cfg_key() == js._fused_cfg_key()
    # facc is clipped to [1 / walks, 1]
    for facc in (1e-4, 3.0):
        assert tsam.RWalkSampler(ndim=3, walks=10, facc=facc).facc == \
            jsam.RWalkSampler(ndim=3, walks=10, facc=facc).facc
    assert tsam.RWalkSampler(ndim=3, walks=1).walks == 2
    jt, tt = js.device_tune_fn(), ts.device_tune_fn()
    for acc, rej, scale in ((120.0, 680.0, 1.0), (0.0, 0.0, 0.3),
                            (799.0, 1.0, 2.5)):
        j = float(jt(jnp.asarray(scale), jnp.asarray([acc, rej, 0.0, 0.0])))
        t = float(tt(torch.tensor(scale, dtype=torch.float64),
                     torch.tensor([acc, rej, 0.0, 0.0],
                                  dtype=torch.float64)))
        assert t == pytest.approx(j, rel=1e-12)
        # the host form of the same update
        for s in (js, ts):
            s.scale = scale
            s.tune(s.consume_tuning(np.array([acc, rej, 0.0, 0.0])),
                   update=True)
        assert ts.scale == pytest.approx(js.scale, rel=1e-12)
        assert ts.scale == pytest.approx(t, rel=1e-12)
    assert ts.rwalk_history == js.rwalk_history == \
        {"n_accept": 0, "n_reject": 0}
    assert ts.row_stats(3.0, 27.0) == js.row_stats(3.0, 27.0)


@pytest.mark.parametrize("cls", ["SliceSampler", "RSliceSampler"])
def test_slice_tuning_matches_jax(cls):
    js, ts = getattr(jsam, cls)(ndim=4, slices=3), \
        getattr(tsam, cls)(ndim=4, slices=3)
    assert ts.update_bound_interval_ratio == \
        js.update_bound_interval_ratio == (12 if cls == "SliceSampler"
                                           else 3)
    assert ts._fused_cfg_key() == js._fused_cfg_key()
    jt, tt = js.device_tune_fn(), ts.device_tune_fn()
    for nexp, ncon, scale in ((40.0, 90.0, 1.0), (0.0, 50.0, 0.5),
                              (500.0, 3.0, 2.0), (7.0, 7.0, 1.3)):
        stats = [nexp, ncon, 0.0, 0.0]
        j = float(jt(jnp.asarray(scale), jnp.asarray(stats)))
        t = float(tt(torch.tensor(scale, dtype=torch.float64),
                     torch.tensor(stats, dtype=torch.float64)))
        assert t == pytest.approx(j, rel=1e-12)
        for s in (js, ts):
            s.scale = scale
            s.tune(s.consume_tuning(np.array(stats)), update=True)
        assert ts.scale == pytest.approx(js.scale, rel=1e-12)
        assert ts.scale == pytest.approx(t, rel=1e-12)
    assert ts.slice_history == js.slice_history
    # an expansion warning in the stats switches both to doubling
    for s in (js, ts):
        s.tune(s.consume_tuning(np.array([5.0, 5.0, 1.0, 0.0])))
        assert s.sampler_kwargs["slice_doubling"] is True
    assert ts._fused_cfg_key() == js._fused_cfg_key()


def test_get_internal_sampler_matches_jax():
    for name, ndim in (("auto", 3), ("auto", 12), ("auto", 25),
                       ("rwalk", 4), ("slice", 4), ("rslice", 4),
                       ("unif", 4)):
        j = jsam.get_internal_sampler(name, ndim, ncdim=ndim)
        t = tsam.get_internal_sampler(name, ndim, ncdim=ndim)
        assert type(t).__name__ == type(j).__name__
        for attr in ("walks", "slices", "facc", "ncdim"):
            assert getattr(t, attr, None) == getattr(j, attr, None), attr
    t = tsam.get_internal_sampler("auto", 12)
    assert isinstance(t, tsam.RWalkSampler) and t.walks == 32
    # an instance is a template: a fresh object with the factory's masks,
    # so two samplers never share tuning state
    proto = tsam.RSliceSampler(slices=7, slice_doubling=True)
    a = tsam.get_internal_sampler(proto, 4, nonbounded=[True] * 4)
    b = tsam.get_internal_sampler(proto, 4)
    assert a is not proto and a is not b and a.slices == b.slices == 7
    assert a.ndim == 4 and a.sampler_kwargs["slice_doubling"]
    assert a.sampler_kwargs["nonbounded"] == [True] * 4
    a.scale = 0.1
    assert b.scale == proto.scale == 1.0
    with pytest.raises(ValueError, match="Unknown sample"):
        tsam.get_internal_sampler("hslice", 4)


# --------------------------------------------------------------------------
# the replay round


NDIM, NPDIM, NLIVE, Q = 2, 2, 64, 16


def _replay_ns(mode, lib):
    return types.SimpleNamespace(
        queue_size=Q, nlive=NLIVE, proposal_mode=mode, blob=False,
        loglikelihood=types.SimpleNamespace(npdim=NPDIM),
        dtype=jnp.float64 if lib == "jax" else torch.float64,
        device=torch.device("cpu"), timings=Timings())


@pytest.mark.parametrize("mode", ["batch", "queue"])
@pytest.mark.parametrize("case", ["tail", "padded", "stop"])
def test_replay_round_matches_jax(mode, case):
    """``run_replay`` on the same live set, proposals, kills0 and birth0:
    integer and copied columns bit-identical, integrator columns 1e-12
    relative.  'padded' ends in rows that must lose every comparison;
    'stop' ends the replay early on max_accepts."""
    live, prop = _state(below=(mode == "queue"))
    kills0, birth0 = (5, float(np.sort(live[:, 4])[Q - 1])) \
        if mode == "batch" else (0, float(live[:, 4].min()))
    if case == "padded":
        prop[Q - 6:] = 0.0
        prop[Q - 6:, 4] = -1e30
    integ = np.array([-3.0, 0.01, 0.5, -0.4, float(live[:, 4].min()) - 0.1,
                      0.0, 0.0, 0.0, 41.0])
    limits = np.array([0.01, np.inf, 4.0 if case == "stop" else 2.0 ** 30,
                       2.0 ** 30])
    js, ts = jsam.InternalSampler(ndim=NDIM), tsam.InternalSampler(ndim=NDIM)
    js.scale = ts.scale = 0.8
    jout, jlive, _, _ = js.run_replay(
        _replay_ns(mode, "jax"), jax.random.key(0), jnp.asarray(live), None,
        jnp.asarray(prop), None, integ, limits, kills0=kills0,
        birth0=birth0)
    tns = _replay_ns(mode, "torch")
    tout, tlive, _ = ts.run_replay(tns, live_to_torch(live, "cpu"), None,
                                   torch.from_numpy(prop), None, integ,
                                   limits, kills0=kills0, birth0=birth0)
    jlayout, tlayout = js.get_replay(_replay_ns(mode, "jax"))[1], \
        ts.get_replay(tns)[1]
    assert jlayout == tlayout
    assert tout["stats"] is None and jout["stats"] is None
    cols = jfused.record_columns(NDIM, NPDIM)
    close = [i for i, c in enumerate(cols)
             if c in ("logvol", "logwt", "logz", "logzvar", "h")]
    exact = [i for i in range(len(cols)) if i not in close]
    jrec = np.asarray(jout["records"])
    assert np.array_equal(jrec[:, exact], tout["records"][:, exact])
    np.testing.assert_allclose(tout["records"][:, close], jrec[:, close],
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(tout["delta_logz"], jout["delta_logz"],
                               rtol=1e-12, atol=0)
    for k in ("accepts", "lane_stats", "round_thresholds"):
        assert np.array_equal(np.asarray(jout[k]), tout[k]), k
    for k in ("n_accepted", "nc_used", "done", "n_consumed", "done_reason",
              "scale_final", "nc_launched"):
        assert jout[k] == tout[k], k
    for k, v in jout["integ"].items():
        if isinstance(v, (bool, int)):
            assert tout["integ"][k] == v, k
        else:
            np.testing.assert_allclose(tout["integ"][k], v, rtol=1e-12,
                                       atol=0, err_msg=k)
    assert np.array_equal(np.asarray(jlive), tlive.numpy())
    acc = tout["accepts"]
    assert tout["scale_final"] == 0.8
    # refills made by the replay are born at birth0, not at the partly
    # refilled live set's own threshold
    il = NDIM + NPDIM
    new = tlive.numpy()[:, il + 2] == -1.0
    assert new.sum() > 0 and np.all(tlive.numpy()[new, il + 3] == birth0)
    if mode == "batch":
        # the live count of the first replayed death continues the
        # interrupted round's: nlive - kills0
        assert tout["records"][np.argmax(acc), 1 + il + 9] == NLIVE - kills0
    if case == "padded":
        assert not acc[Q - 6:].any()
        assert np.array_equal(tout["proposals_dev"].numpy(), prop)
    if case == "stop":
        assert tout["n_accepted"] == 4 and tout["done_reason"] & 8
        assert tout["n_consumed"] < Q


def test_replay_round_never_takes_the_thin_path():
    live, prop = _state()
    timings = Timings()

    def propose(gen, live_, live_blob, axes_args, scale, loglstar):
        p = axes_args["prop"]
        return (p[:, :NDIM], p[:, NDIM:4], p[:, 4], None,
                p[:, 5].to(torch.int64), (p[:, 6].sum(),), p[:, 6:8])

    ctrl = np.array([-1e30, 0.0, 0.0, 0.0, -1e30, 0.0, 0.0, 0.0, 1.0, 0.01,
                     np.inf, 2.0 ** 30, 2.0 ** 30, 1.0, 0.0, 1.0, -1e30, 0.0,
                     0.0, 0.0, 0.0])
    # one read of the done flag per round, and one more to choose the thin
    # path where a round may take it
    for kind, reads in (("replay", 1), ("fixed", 2)):
        timings.clear()
        fn, _ = tfused.make_fused_round(
            propose, kind=kind, nlive=NLIVE, ndim=NDIM, npdim=NPDIM, q=Q,
            dtype=torch.float64, device="cpu", timings=timings)
        fn(0, live_to_torch(live, "cpu"), None,
           {"prop": torch.from_numpy(prop)}, ctrl)
        assert timings.get("sync_round", 0) == reads


def test_round_seeds_do_not_depend_on_skipped_rounds():
    """A round's generator is a function of the dispatch seed and the
    round's index alone, so a continuation that skips rounds gives the
    later ones the streams they had."""
    seeds = [tfused.round_seed(123, r) for r in range(6)]
    assert len(set(seeds)) == 6 and all(0 <= s < 2 ** 63 for s in seeds)
    assert seeds == [tfused.round_seed(123, r) for r in range(6)]
    assert tfused.round_seed(124, 0) != seeds[0]
    draws = []

    def propose(gen, live_, live_blob, axes_args, scale, loglstar):
        draws.append(float(torch.rand((), generator=gen,
                                      dtype=torch.float64)))
        p = axes_args["prop"]
        return (p[:, :NDIM], p[:, NDIM:4], p[:, 4], None,
                p[:, 5].to(torch.int64), (p[:, 6].sum(),), p[:, 6:8])

    live, prop = _state()
    fn, _ = tfused.make_fused_round(
        propose, nlive=NLIVE, ndim=NDIM, npdim=NPDIM, q=Q,
        dtype=torch.float64, device="cpu", rounds=4)
    args = (live_to_torch(live, "cpu"), None,
            {"prop": torch.from_numpy(prop)})
    ctrl = np.array([-1e30, 0.0, 0.0, 0.0, -1e30, 0.0, 0.0, 0.0, 1.0,
                     -np.inf, np.inf, 2.0 ** 30, 2.0 ** 30, 1.0, 0.0, 4.0,
                     -1e30, 0.0, 0.0, 0.0, 0.0, 2.0 ** 30])
    fn(77, *args, ctrl)
    full, draws[:] = list(draws), []
    ctrl[17] = 2.0  # skip the first two rounds
    fn(77, *args, ctrl)
    assert len(full) == 4 and draws == full[2:]


# --------------------------------------------------------------------------
# the distributional gate of tests/test_sampling.py on the port's kernels

QK = 512


def _diamond_like():
    # uniform inside |x-0.5| + |y-0.5| < 0.5, -inf outside
    def loglike(x):
        inside = (x[0] - 0.5).abs() + (x[1] - 0.5).abs() < 0.5
        return torch.where(inside, 0.0, -torch.inf).to(x.dtype)

    like = LogLikelihood(loglike, lambda u: u, 2, device="cpu")
    like.eval_host(np.full((2, 2), 0.5))
    return like


def _run_kernel(kind, timings, nsteps=3):
    like = _diamond_like()
    rstate = get_rstate()
    starts = []
    while len(starts) < QK:
        pts = rstate.random((4 * QK, 2))
        ok = np.abs(pts[:, 0] - 0.5) + np.abs(pts[:, 1] - 0.5) < 0.5
        starts.extend(pts[ok][:QK - len(starts)])
    u = np.array(starts)
    v, logl = u.copy(), np.zeros(QK)
    axes = np.tile(np.eye(2) * 0.5, (QK, 1, 1))
    kw = dict(dtype=torch.float64, device="cpu")
    if kind == "rwalk":
        fn = tk.make_rwalk_round(like, ndim=2, ncdim=2, q=QK, walks=20, **kw)
    else:
        name, _, doubling = kind.partition("-")
        fn = tk.make_slice_round(like, ndim=2, q=QK, slices=3, kind=name,
                                 doubling=bool(doubling), timings=timings,
                                 **kw)
    for _ in range(nsteps):
        packed_in = torch.from_numpy(np.concatenate(
            [u, v, logl[:, None], axes.reshape(QK, -1)], axis=1))
        gen = torch_generator(int(rstate.integers(2**63)), "cpu")
        packed = fn(gen, packed_in, None, 1.0, -0.5)[0].numpy()
        u, v, logl = packed[:, :2], packed[:, 2:4], packed[:, 4]
    return u, packed


@pytest.mark.parametrize("kind", ["rwalk", "slice", "rslice-doubling",
                                  "slice-doubling"])
def test_kernel_uniformity(kind):
    timings = Timings()
    u, packed = _run_kernel(kind, timings)
    assert np.all(np.abs(u[:, 0] - 0.5) + np.abs(u[:, 1] - 0.5) < 0.5)
    a = (u[:, 0] - 0.5) + (u[:, 1] - 0.5)
    b = (u[:, 0] - 0.5) - (u[:, 1] - 0.5)
    for coord in (a, b):
        stat = kstest(coord + 0.5, "uniform")
        assert stat.pvalue > 1e-4, (kind, stat)
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.15
    if kind == "rwalk":
        # exactly `walks` proposals per lane, and no host read
        assert np.array_equal(packed[:, 5] + packed[:, 6], np.full(QK, 20))
        assert not timings
    else:
        nc, n_exp, n_con = packed[:, 5], packed[:, 6], packed[:, 7]
        n_steps = 6 if kind.startswith("slice") else 3
        assert np.all(n_con >= n_steps) and timings["sync_slice"] > 0
        if kind.endswith("doubling"):
            # 2 initial probes per update, one evaluation per doubling
            # (n_expand counts unit steps, so it bounds them from above)
            # and per shrink, plus the acceptance tests' halvings
            assert np.all(nc >= 2 * n_steps + n_con)
            assert np.all(packed[:, 8] == 0)
        else:
            assert np.array_equal(nc, 2 * n_steps + n_exp + n_con)


def test_doubling_counts_on_a_one_dimensional_slice():
    """On a slice that one doubling covers, nc counts as the JAX package
    counts it: 2 probes, 1 per active lane per doubling, 1 per shrink, and
    the acceptance test's halvings only where the candidate was inside."""
    sigma = 0.2

    def loglike(x):
        return -0.5 * ((x - 0.5) ** 2).sum() / sigma ** 2

    like = LogLikelihood(loglike, lambda u: u, 1, device="cpu")
    like.eval_host(np.full((1, 1), 0.5))
    q = 256
    fn = tk.make_slice_round(like, ndim=1, q=q, slices=1, kind="rslice",
                             doubling=True, dtype=torch.float64,
                             device="cpu")
    u = np.full((q, 1), 0.5)
    packed_in = torch.from_numpy(np.concatenate(
        [u, u, np.zeros((q, 1)), np.full((q, 1), 0.05)], axis=1))
    loglstar = -0.5 * (0.3 / sigma) ** 2  # the slice is (0.2, 0.8)
    out = fn(torch_generator(SEED, "cpu"), packed_in, None, 1.0,
             loglstar)[0].numpy()
    x, nc, n_exp, n_con = out[:, 0], out[:, 3], out[:, 4], out[:, 5]
    assert np.all((x > 0.2) & (x < 0.8))
    assert kstest((x - 0.2) / 0.6, "uniform").pvalue > 1e-4
    # the unit interval is 0.05 wide and the slice 0.6: at least 4
    # doublings (a random side each, until both ends are outside), which
    # grow the interval by 1 + 2 + 4 + ... units
    doublings = np.log2(n_exp + 1)
    assert np.array_equal(doublings, np.round(doublings))
    assert doublings.min() >= 4
    assert np.all(nc >= 2 + doublings + n_con)
    assert nc.max() > (2 + doublings + n_con).max()  # the halvings


# --------------------------------------------------------------------------
# end to end on the CPU, against the analytic evidence and the JAX run


def _gauss(lib, ndim):
    cov = np.identity(ndim)
    cov[cov == 0] = 0.95
    cinv = np.linalg.inv(cov)
    lnorm = -0.5 * (np.log(2 * np.pi) * ndim + np.log(np.linalg.det(cov)))
    if lib == "jax":
        return lambda x: -0.5 * jnp.dot(x, jnp.asarray(cinv) @ x) + lnorm
    cinv_t = torch.as_tensor(cinv)
    return lambda x: -0.5 * (x @ cinv_t @ x) + lnorm


def _ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def _edge_problem(lib):
    """A Gaussian in the unit cube (identity prior transform) whose first
    coordinate is periodic and peaks at the edge 0 == 1, whose second is
    reflective and peaks at 0.03, and whose third is plain.  Returns
    (loglike, analytic ln Z)."""
    sigma, mu1 = 0.05, 0.03
    np_, frac = (jnp, lambda a: a - jnp.floor(a)) if lib == "jax" else \
        (torch, lambda a: a - torch.floor(a))

    def loglike(x):
        d0 = frac(x[0] + 0.5) - 0.5  # wrapped distance to the edge
        d2 = d0 ** 2 + (x[1] - mu1) ** 2 + (x[2] - 0.5) ** 2
        return -0.5 * d2 / sigma ** 2

    mass1 = norm.cdf((1 - mu1) / sigma) - norm.cdf(-mu1 / sigma)
    truth = 3 * math.log(sigma * math.sqrt(2 * math.pi)) + math.log(mass1)
    return loglike, truth


E2E = {
    # name: (ndim, truth or None for the edge problem, sampler kwargs)
    "single_rwalk": (3, -8.987, dict(bound="single", sample="rwalk")),
    "multi_slice": (3, -8.987, dict(bound="multi", sample="slice")),
    "single_rslice_doubling": (3, -8.987, dict(bound="single",
                                               sample="rslice-doubling")),
    "rwalk_periodic_reflective": (3, None, dict(
        bound="single", sample="rwalk", periodic=[0], reflective=[1])),
    "rwalk_ncdim": (3, -8.987, dict(bound="single", sample="rwalk",
                                    ncdim=2)),
}


@pytest.mark.parametrize("case", sorted(E2E))
def test_end_to_end_against_truth_and_jax(case):
    ndim, truth, kw = E2E[case]
    runs = {}
    for lib, pkg, sam in (("torch", dyt, tsam), ("jax", dytpu, jsam)):
        kw_ = dict(kw)
        if kw_["sample"] == "rslice-doubling":
            kw_["sample"] = sam.RSliceSampler(slices=4, slice_doubling=True)
        if truth is None:
            loglike, want = _edge_problem(lib)
            ptform = lambda u: u  # noqa: E731
        else:
            loglike, want, ptform = _gauss(lib, ndim), truth, _ptform
        if lib == "torch":
            kw_["device"] = "cpu"
        s = pkg.NestedSampler(loglike, ptform, ndim, nlive=200,
                              queue_size=64, rstate=get_rstate(SEED), **kw_)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.run_nested(print_progress=False)
        runs[lib] = (s, s.results)
    s, res = runs["torch"]
    jres = runs["jax"][1]
    logz, err = res.logz[-1], res.logzerr[-1]
    assert abs(logz - want) < 4 * err, (logz, err, want)
    assert abs(logz - jres.logz[-1]) < 4 * np.hypot(err, jres.logzerr[-1])
    assert abs(res.niter - jres.niter) < 0.1 * jres.niter
    assert int(np.sum(res.ncall)) == s.ncall
    inner = s.internal_sampler
    assert inner is not s.internal_sampler_next or s.nbound > 1
    if case == "single_rslice_doubling":
        assert inner.sampler_kwargs["slice_doubling"] and inner.slices == 4
    if "rwalk" in case:
        # every proposal after the unit-cube phase cost exactly `walks`
        assert inner.walks == ndim + 20 and "sync_slice" not in s.timings
        stats = [p for p in res.proposal_stats if p]
        assert all(p["n_accept"] + p["n_reject"] == inner.walks
                   for p in stats)
        assert 0.5 * inner.scale < 2.0  # the scale was tuned, not blown up
    if case == "rwalk_periodic_reflective":
        # the posterior straddles the periodic edge and piles up at the
        # reflective one
        u = res.samples_u[-400:]
        assert (u[:, 0] < 0.2).any() and (u[:, 0] > 0.8).any()
        assert np.all((u > 0) & (u < 1))
        assert list(inner.sampler_kwargs["nonbounded"]) == \
            [False, False, True]
    if case == "rwalk_ncdim":
        assert s.bound.ndim == 2 and inner.ncdim == 2


def test_auto_in_twelve_dimensions_runs_rwalk():
    s = dyt.NestedSampler(lambda x: -0.5 * (x @ x), _ptform, 12, nlive=60,
                          device="cpu", rstate=get_rstate(SEED))
    assert isinstance(s.internal_sampler_next, tsam.RWalkSampler)
    assert s.internal_sampler_next.walks == 32
    assert (s.bounding, s.bound_enlarge, s.bound_bootstrap) == \
        ("multi", 1.25, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.run_nested(print_progress=False, maxiter=400)
    assert s.internal_sampler is s.internal_sampler_next
    assert s.results.niter >= 400 and s.internal_sampler.scale != 1.0


def test_automatic_switch_to_doubling_continues_the_run():
    """An expansion warning in a dispatch's stats flips the sampler to
    doubling once that dispatch is over; the next dispatch builds the
    doubling kernel and the run goes on to the gate."""
    s = dyt.NestedSampler(_gauss("torch", 3), _ptform, 3, nlive=100,
                          bound="single", sample="rslice", queue_size=32,
                          device="cpu", rstate=get_rstate(SEED))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.run_nested(print_progress=False, maxiter=500, add_live=False)
    inner = s.internal_sampler
    assert inner.name == "rslice"
    assert not inner.sampler_kwargs["slice_doubling"]
    inner._post_fused_stats(np.array([10.0, 10.0, 1.0, 0.0]))
    assert inner._doubling_due
    assert not inner.sampler_kwargs["slice_doubling"]
    with pytest.warns(UserWarning, match="doubling"):
        inner.end_dispatch()
    assert inner.sampler_kwargs["slice_doubling"]
    assert not inner._doubling_due
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.run_nested(print_progress=False, resume=True)
    res = s.results
    assert abs(res.logz[-1] + 8.987) < 4 * res.logzerr[-1]
    assert any(k[-1] == (inner.slices, True) for k in inner._round_cache
               if k[0] == "fused")


def test_unif_round_honours_ncdim_and_nonbounded():
    """The bound spans the first ncdim dimensions (checked against the
    cube there, loosely where nonbounded is False); the others are drawn
    uniformly."""
    class Like:
        npdim = 3

        def batch_eval(self, u, mask=None):
            return u, torch.zeros(u.shape[0], dtype=u.dtype), None

    # one ball of radius 0.3 around (0.05, 0.5): it sticks out of the cube
    # in the first dimension
    arrays = {"ctrs": torch.tensor([[0.05, 0.5]], dtype=torch.float64),
              "axes": 0.3 * torch.eye(2, dtype=torch.float64),
              "axes_inv": torch.eye(2, dtype=torch.float64) / 0.3}
    out = {}
    for name, nb in (("strict", None), ("loose", [False, True, True])):
        fn = tk.make_unif_round(Like(), ndim=3, ncdim=2, q=256,
                                bound_kind="balls", nonbounded=nb,
                                dtype=torch.float64, device="cpu")
        out[name] = fn(torch_generator(SEED, "cpu"), -1.0,
                       arrays)[0].numpy()
        u = out[name][:, :3]
        assert np.all(np.hypot(u[:, 0] - 0.05, u[:, 1] - 0.5) <= 0.3)
        assert kstest(u[:, 2], "uniform").pvalue > 1e-4
    assert out["strict"][:, 0].min() > 0
    assert out["loose"][:, 0].min() < 0  # roams below 0 where allowed
