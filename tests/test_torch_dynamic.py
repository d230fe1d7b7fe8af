"""The dynamic layer of the port against the JAX package, on the CPU.

Tolerances.  The host side of a dynamic run (``utils/runs.py``, the weight
and stopping functions, ``combine_runs``, the host part of the batch
configurator) is float64 numpy in both packages: on the same inputs the
integer and copied columns are bit-identical and the integrator columns
(``logvol``, ``logwt``, ``logz``, ``logzerr``, ``information``) agree to
1e-12 relative.  The device rounds draw from torch Philox and JAX
threefry, which never give the same stream, so whole runs are held to the
analytic evidence and to the JAX run (same number of batches, niter within
15 %, logz within 3 combined errors), and the non-fused proposal round to
distributional gates.  Resume is exact: ``np.array_equal`` or ``==``.
"""

import copy
import io
import os
import pickle
import shutil
import types
import warnings
from contextlib import redirect_stderr

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import kstest

import dynesty_tpu as dytpu
import dynesty_tpu.dynamicsampler as jdyn
import dynesty_tpu.sampler as jsampler
import dynesty_tpu.utils.results as jres
import dynesty_tpu.utils.runs as jruns
import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.dynamicsampler as tdyn
import dynesty_tpu_torch.sampler as tsampler
import dynesty_tpu_torch.utils.misc as tmisc
import dynesty_tpu_torch.utils.results as tres
import dynesty_tpu_torch.utils.runs as truns
from dynesty_tpu_torch.dynamicsampler import DynamicSamplerStatesEnum
from dynesty_tpu_torch.utils.misc import torch_generator

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
SEED = 56432
LOGZ_TRUTH = NDIM * (-np.log(20.0))
RTOL = 1e-12

# module-level (picklable) problems
_COV = np.identity(NDIM)
_COV[_COV == 0] = 0.95
_CINV_NP = np.linalg.inv(_COV)
_CINV = torch.as_tensor(_CINV_NP)
_LNORM = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(_COV)))
_TMAX = 5.0 * np.pi


def gau_loglike(x):
    return -0.5 * (x @ _CINV @ x) + _LNORM


def gau_ptform(u):
    return 10.0 * (2.0 * u - 1.0)


def gau_loglike_jax(x):
    return -0.5 * jnp.dot(x, jnp.asarray(_CINV_NP) @ x) + _LNORM


def egg_loglike(x):
    t = 2.0 * _TMAX * x - _TMAX
    return (2.0 + torch.cos(t[0] / 2.0) * torch.cos(t[1] / 2.0)) ** 5.0


def identity(u):
    return u


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def _dns(bound="multi", sample="unif", seed=SEED, **kw):
    kw.setdefault("queue_size", 64)
    return dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM,
                                    bound=bound, sample=sample,
                                    device="cpu", rstate=get_rstate(seed),
                                    **kw)


def _jdns(bound="multi", sample="unif", seed=SEED, **kw):
    kw.setdefault("queue_size", 64)
    return dytpu.DynamicNestedSampler(gau_loglike_jax, gau_ptform, NDIM,
                                      bound=bound, sample=sample,
                                      rstate=get_rstate(seed), **kw)


# --------------------------------------------------------------------------
# shared inputs: one static and one dynamic run of the port, as plain data


@pytest.fixture(scope="module")
def runs_data():
    s = dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=100,
                          bound="single", sample="unif", queue_size=32,
                          device="cpu", rstate=get_rstate(SEED))
    _quiet(s.run_nested, print_progress=False)
    static = s.results.asdict()
    d = _dns(bound="single")
    _quiet(d.run_nested, nlive_init=100, nlive_batch=60, maxbatch=2,
           print_progress=False)
    dynamic = d.results.asdict()
    for r in (static, dynamic):
        r.pop("bound", None)
    return {"static": static, "dynamic": dynamic}


def _both(data):
    return jres.Results(copy.deepcopy(data)), \
        tres.Results(copy.deepcopy(data))


_INTEGRATOR = ("logvol", "logwt", "logz", "logzerr", "information")


def _assert_results_match(ja, to):
    assert list(ja.keys()) == list(to.keys())
    for k in ja.keys():
        a, b = ja[k], to[k]
        if k in _INTEGRATOR:
            np.testing.assert_allclose(np.asarray(b, float),
                                       np.asarray(a, float), rtol=RTOL,
                                       atol=0, err_msg=k)
        elif k in ("proposal_stats", "blob"):
            assert len(np.atleast_1d(a)) == len(np.atleast_1d(b)), k
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


# --------------------------------------------------------------------------
# utils/runs.py


@pytest.mark.parametrize("kind", ["static", "dynamic"])
@pytest.mark.parametrize("fn", ["jitter_run", "jitter_run_approx",
                                "resample_run", "reweight_run"])
def test_run_algebra_matches_jax(runs_data, fn, kind):
    ja, to = _both(runs_data[kind])
    if fn.startswith("jitter"):
        kw = {"approx": fn.endswith("approx")}
        out_j = jruns.jitter_run(ja, rstate=get_rstate(5), **kw)
        out_t = truns.jitter_run(to, rstate=get_rstate(5), **kw)
    elif fn == "resample_run":
        out_j, idx_j = jruns.resample_run(ja, rstate=get_rstate(5),
                                          return_idx=True)
        out_t, idx_t = truns.resample_run(to, rstate=get_rstate(5),
                                          return_idx=True)
        assert np.array_equal(idx_j, idx_t)
    else:
        logp = 1.3 * np.asarray(runs_data[kind]["logl"]) - 0.2
        out_j = jruns.reweight_run(ja, logp)
        out_t = truns.reweight_run(to, logp)
    _assert_results_match(out_j, out_t)


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_unravel_and_merge_match_jax(runs_data, kind):
    ja, to = _both(runs_data[kind])
    strands_j = jruns.unravel_run(ja, print_progress=False)
    strands_t = truns.unravel_run(to, print_progress=False)
    assert len(strands_j) == len(strands_t) > 1
    for sj, st in zip(strands_j[:5], strands_t[:5]):
        _assert_results_match(sj, st)
    merged_j = jruns.merge_runs(strands_j, print_progress=False)
    merged_t = truns.merge_runs(strands_t, print_progress=False)
    _assert_results_match(merged_j, merged_t)
    # the merged strands are the run again
    np.testing.assert_allclose(merged_t["logz"][-1],
                               runs_data[kind]["logz"][-1], atol=1e-8)


def test_merge_runs_with_a_plateau_matches_jax(runs_data):
    """Two runs with tied log-likelihoods, within and across the runs, take
    the plateau branch of the volume assignment."""
    outs = []
    for lib_res, lib_runs in ((jres, jruns), (tres, truns)):
        pair = []
        for shift in (0, 7):
            d = copy.deepcopy(runs_data["static"])
            logl = np.array(d["logl"])
            logl[40 + shift:44 + shift] = logl[40 + shift]
            logl[200:203] = logl[200]
            d["logl"] = logl
            pair.append(lib_res.Results(d))
        outs.append(lib_runs.merge_runs(pair, print_progress=False))
    _assert_results_match(*outs)
    assert np.any(np.diff(outs[1]["logl"]) == 0)


def test_kld_error_and_static_check_match_jax(runs_data):
    ja, to = _both(runs_data["dynamic"])
    for error in ("jitter", "resample"):
        kj = jruns.kld_error(ja, error=error, rstate=get_rstate(3))
        kt = truns.kld_error(to, error=error, rstate=get_rstate(3))
        np.testing.assert_allclose(kt, kj, rtol=1e-10, atol=1e-13)
    for kind in ("static", "dynamic"):
        ja, to = _both(runs_data[kind])
        cj, ct = jruns.check_result_static(ja), \
            truns.check_result_static(to)
        _assert_results_match(cj, ct)
        assert cj.isdynamic() == ct.isdynamic() == (kind == "dynamic")


# --------------------------------------------------------------------------
# weights, the batch bracket, the stopping value


@pytest.mark.parametrize("kind", ["static", "dynamic"])
@pytest.mark.parametrize("pfrac", [0.0, 0.8, 1.0])
def test_weight_function_matches_jax(runs_data, pfrac, kind):
    ja, to = _both(runs_data[kind])
    if kind == "static":
        # a static Results has no samples_n column: the dynamic sampler
        # never passes one, give both the same
        d = dict(runs_data[kind], samples_n=np.minimum(
            np.arange(len(runs_data[kind]["logl"]), 0, -1), 100))
        d.pop("nlive")
        ja, to = _both(d)
    for a, b in zip(jdyn.compute_weights(ja), tdyn.compute_weights(to)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)
    args = {"pfrac": pfrac, "maxfrac": 0.8, "pad": 1}
    bj, wj = jdyn.weight_function(ja, args, return_weights=True)
    bt, wt = tdyn.weight_function(to, args, return_weights=True)
    assert bj == bt and bt[0] < bt[1]
    for a, b in zip(wj, wt):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", ["pfrac0", "pfrac0.8", "pfrac1", "n_mc25",
                                  "n_mc25-resample"])
def test_stopping_function_matches_jax(runs_data, case):
    ja, to = _both(runs_data["dynamic"])
    args = {"target_n_effective": 1500, "evid_thresh": 0.1}
    if case.startswith("pfrac"):
        args["pfrac"] = float(case[5:])
    else:
        args.update(pfrac=0.5, n_mc=25,
                    error="resample" if case.endswith("resample")
                    else "jitter")
    sj, vj = jdyn.stopping_function(ja, args, rstate=get_rstate(9),
                                    return_vals=True)
    st, vt = tdyn.stopping_function(to, args, rstate=get_rstate(9),
                                    return_vals=True)
    assert sj == st
    np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=0)
    assert tdyn.stopping_function(to, {"target_n_effective": 10})
    assert not tdyn.stopping_function(to, {"target_n_effective": 10**8})


def test_weight_and_stopping_functions_check_their_arguments(runs_data):
    _, to = _both(runs_data["dynamic"])
    for bad in ({"pfrac": 1.5}, {"maxfrac": -0.1}, {"pad": -1}):
        with pytest.raises(ValueError):
            tdyn.weight_function(to, bad)
    for bad in ({"pfrac": -1}, {"n_mc": -1}, {"error": "x"},
                {"pfrac": 0.5, "evid_thresh": -1.0}):
        with pytest.raises(ValueError):
            tdyn.stopping_function(to, bad)


# --------------------------------------------------------------------------
# combine_runs on injected runs


def _pending_batch():
    """A port sampler whose batch has run but is not merged yet."""
    d = _dns(bound="single")
    _quiet(d.run_nested, nlive_init=100, maxbatch=0, print_progress=False)
    bounds = tdyn.weight_function(d.results)
    for _ in _quiet(lambda: list(d.sample_batch(nlive_new=60,
                                                logl_bounds=bounds))):
        pass
    return d


def _inject(lib, src, plateau):
    """A DynamicSampler of ``lib`` holding copies of ``src``'s runs."""
    if lib is tdyn:
        out = tdyn.DynamicSampler(None, NDIM, None, "single", device="cpu")
        out.saved_run = tres.RunRecord(dynamic=True)
        out.new_run = tres.RunRecord(dynamic=True)
    else:
        out = jdyn.DynamicSampler(None, NDIM, None, "single")
        out.saved_run = jres.RunRecord(dynamic=True)
        out.new_run = jres.RunRecord(dynamic=True)
    for name in ("saved_run", "new_run"):
        for k in getattr(src, name).keys():
            getattr(out, name)[k] = copy.deepcopy(list(getattr(src,
                                                               name)[k]))
    if plateau:
        # ties inside the saved run and between the two runs
        sl = out.saved_run["logl"]
        for i in (50, 51, 52):
            sl[i] = sl[50]
        tie = out.new_run["logl"][5]
        sl[int(np.searchsorted(sl, tie))] = tie
        assert sorted(sl) == list(sl)
    out.new_logl_min, out.new_logl_max = src.new_logl_min, src.new_logl_max
    out.batch = src.batch
    out.sampler = types.SimpleNamespace(logvol_init=0.0, save_bounds=False)
    return out


@pytest.mark.parametrize("plateau", [False, True])
def test_combine_runs_matches_jax(plateau):
    src = _pending_batch()
    assert len(src.new_run["id"]) > 60
    ja, to = _inject(jdyn, src, plateau), _inject(tdyn, src, plateau)
    ja.combine_runs()
    to.combine_runs()
    assert ja.batch == to.batch == 1 and to.new_run is None
    for k in to.saved_run.keys():
        a, b = ja.saved_run[k], to.saved_run[k]
        assert len(a) == len(b), k
        if k in ("logvol", "logwt", "logz", "logzvar", "h"):
            np.testing.assert_allclose(np.asarray(b, float),
                                       np.asarray(a, float), rtol=RTOL,
                                       atol=1e-300, err_msg=k)
        elif k in ("proposal_stats", "blob"):
            continue
        elif k == "batch_logl_bounds":
            assert a == b
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k
    logl = np.asarray(to.saved_run["logl"])
    assert np.all(np.diff(logl) >= 0)
    assert bool(np.any(np.diff(logl) == 0)) == plateau
    assert np.all(np.diff(to.saved_run["logvol"]) < 0)


# --------------------------------------------------------------------------
# the batch configurator's host side


def _base_run_data():
    d = _dns(bound="single", bootstrap=0)
    _quiet(d.run_nested, nlive_init=100, maxbatch=0, print_progress=False)
    return d


@pytest.mark.parametrize("case", ["default", "weight", "lowered"])
def test_configure_batch_sampler_host_side_matches_jax(case, monkeypatch):
    """From the same saved run and the same ``rstate``: the bracket (the
    default one, the weight function's, and one lowered because fewer than
    ``nlive_new`` samples lie above it), the seeds drawn, the truncation
    of the saved run and the expected batch length equal the JAX
    package's."""
    base = _base_run_data()
    nlive_new = 50
    logl = np.asarray(base.saved_run["logl"])
    bounds = {"default": None,
              "weight": tdyn.weight_function(base.results),
              "lowered": (logl[-20], np.inf)}[case]

    seen = {}
    for lib, name in ((tsampler, "torch"), (jsampler, "jax")):
        orig = lib.Sampler.update_bound_if_needed

        def spy(self, loglstar, ncall=None, force=False, _o=orig, _n=name):
            seen.setdefault(_n, (np.array(self.live_u),
                                 np.array(self.live_logl), loglstar))
            return _o(self, loglstar, ncall=ncall, force=force)

        monkeypatch.setattr(lib.Sampler, "update_bound_if_needed", spy)

    # the port
    to = pickle.loads(pickle.dumps(base))
    to.rstate = get_rstate(77)
    out_t = _quiet(tdyn._configure_batch_sampler, to, nlive_new,
                   update_interval=60, logl_bounds=bounds)

    # the JAX package on the same saved run
    ja = _jdns(bound="single", bootstrap=0)
    ja.rstate = get_rstate(77)
    ja.saved_run = jres.RunRecord(dynamic=True)
    for k in base.saved_run.keys():
        ja.saved_run[k] = copy.deepcopy(list(base.saved_run[k]))
    ja.live_init = [np.array(a) for a in base.live_init] + [None]
    ja.it, ja.eff = base.it, base.eff
    ja.loglikelihood.npdim = NDIM
    ja.sampler = types.SimpleNamespace(
        logl_first_update=base.sampler.logl_first_update)
    out_j = _quiet(jdyn._configure_batch_sampler, ja, nlive_new,
                   update_interval=60, logl_bounds=bounds)

    bs_t, ncall_t, niter_t, lmin_t, lmax_t = out_t
    bs_j, ncall_j, niter_j, lmin_j, lmax_j = out_j
    assert (lmin_t, lmax_t) == (lmin_j, lmax_j)
    assert niter_t == niter_j == nlive_new
    for a, b in zip(seen["torch"], seen["jax"]):
        assert np.array_equal(a, b)
    assert len(bs_t.saved_run["logl"]) == len(bs_j.saved_run["logl"])
    assert bs_t._bracket_est_total == getattr(bs_j, "_bracket_est_total",
                                              None)
    assert bs_t.nlive == bs_j.nlive == nlive_new
    assert bs_t.queue_size == bs_j.queue_size
    # a unif batch kills narrow and chains deep
    assert (bs_t.queue_size_req, bs_t.unif_chain_cap,
            bs_t.rounds_per_dispatch) == (16, 16, 16)
    assert bs_t.internal_sampler_next._max_rounds(bs_t, "ellipsoids") == \
        bs_j.internal_sampler_next._max_rounds(bs_j, "ellipsoids") == 16
    assert len(bs_t.first_points) == nlive_new and not bs_t.queue
    assert np.all(bs_t.live_logl > lmin_t)
    if case == "default":
        assert lmin_t == -np.inf and np.isfinite(lmax_t)
        # the fresh prior draw comes from the host stream: the same points
        assert np.array_equal(bs_t.live_u, bs_j.live_u)
        assert ncall_t == ncall_j == nlive_new
    else:
        assert ncall_t >= nlive_new
        assert np.array_equal(bs_t.live_birth, np.full(nlive_new, lmin_t))
    if case == "lowered":
        assert lmin_t < bounds[0]
        assert lmin_t == logl[len(logl) - nlive_new - 1]
    if case == "weight":
        assert (lmin_t, lmax_t) == bounds
        assert bs_t._bracket_est_total > 0
    # both host streams stand at the same place afterwards
    assert to.rstate.integers(2**62) == ja.rstate.integers(2**62)


# --------------------------------------------------------------------------
# the non-fused proposal round


class _Counting:
    """Counts the points that ``batch_eval`` is asked for: the lanes its
    mask marks, or all of them without a mask."""

    def __init__(self, like):
        self.like, self.n, self.n_lanes = like, 0, 0

    def __getattr__(self, name):
        return getattr(self.like, name)

    def batch_eval(self, u, mask=None):
        self.n += u.shape[0] if mask is None else int(mask.sum())
        self.n_lanes += u.shape[0]
        return self.like.batch_eval(u, mask=mask)

    def eval_host(self, u):
        self.n += len(u)
        self.n_lanes += len(u)
        return self.like.eval_host(u)


def _diamond(x):
    inside = (x[0] - 0.5).abs() + (x[1] - 0.5).abs() < 0.5
    return torch.where(inside, 0.0, -torch.inf).to(x.dtype)


@pytest.mark.parametrize("kind", ["unitcube", "unif", "rwalk", "slice",
                                  "rslice"])
def test_propose_round(kind):
    """One non-fused round of each internal sampler on the diamond
    ``|x-0.5| + |y-0.5| < 0.5``: every row beats ``loglstar``, ``nc`` sums
    to the evaluated points where the kernel counts them (the uniform
    kernels; an MCMC round evaluates every lane at every step and bills
    the lane's own steps), and the draws pass the distributional gate of
    the fused kernels' test."""
    q = 512
    sample = "unif" if kind == "unitcube" else kind
    s = dyt.NestedSampler(_diamond, identity, 2, nlive=q, bound="single",
                          sample=sample, device="cpu", walks=20, slices=3,
                          rstate=get_rstate(SEED),
                          live_points=_diamond_live(q))
    if kind != "unitcube":
        s.update_bound_if_needed(-0.5, force=True)
        assert s.internal_sampler.name == kind
    counting = _Counting(s.loglikelihood)
    s.loglikelihood = counting
    gen = torch_generator(11, "cpu")
    u = None
    for _ in range(1 if kind in ("unitcube", "unif") else 3):
        rows, tinfo = s.internal_sampler.propose_round(s, -0.5, q, gen)
        u = np.array([r["u"] for r in rows])
        s.set_live_points(u, u.copy(), np.zeros(q))
    assert len(rows) == q
    assert set(rows[0]) == {"u", "v", "logl", "nc", "blob",
                            "proposal_stats"}
    assert all(r["logl"] > -0.5 and r["blob"] is None for r in rows)
    assert np.all(np.abs(u[:, 0] - 0.5) + np.abs(u[:, 1] - 0.5) < 0.5)
    nc = np.array([r["nc"] for r in rows])
    if kind in ("unitcube", "unif"):
        assert tinfo is None
        assert nc.sum() == counting.n
        assert rows[0]["proposal_stats"]["n_proposals"] >= 1
        # about half of the unit square lies inside the diamond
        frac = q / nc.sum()
        assert 0.35 < frac < (0.65 if kind == "unitcube" else 1.0)
    elif kind == "rwalk":
        assert np.all(nc == 20) and counting.n_lanes == 3 * 20 * q
        assert tinfo["accept"] + tinfo["reject"] == 20 * q
        st = rows[0]["proposal_stats"]
        assert st["n_accept"] + st["n_reject"] == 20
    else:
        n_steps = 6 if kind == "slice" else 3
        st = [r["proposal_stats"] for r in rows]
        assert all(r["nc"] == 2 * n_steps + t["n_expand"] + t["n_contract"]
                   for r, t in zip(rows, st))
        assert tinfo["n_contract"] == sum(t["n_contract"] for t in st)
        assert counting.n >= nc.sum() // 3
    a = (u[:, 0] - 0.5) + (u[:, 1] - 0.5)
    b = (u[:, 0] - 0.5) - (u[:, 1] - 0.5)
    for coord in (a, b):
        stat = kstest(coord + 0.5, "uniform")
        assert stat.pvalue > 1e-4, (kind, stat)
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.15


def _diamond_live(q):
    rstate = get_rstate(3)
    pts = rstate.random((8 * q, 2))
    u = pts[np.abs(pts[:, 0] - 0.5) + np.abs(pts[:, 1] - 0.5) < 0.5][:q]
    return u, u.copy(), np.zeros(q)


def test_new_point_bills_every_popped_row_and_tunes_when_drained():
    s = dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=60,
                          bound="single", sample="rwalk", walks=10,
                          queue_size=8, device="cpu",
                          rstate=get_rstate(SEED))
    s.update_bound_if_needed(-np.inf, force=True)
    kern = s.internal_sampler
    loglstar = float(np.sort(s.live_logl)[20])
    scale0, got, nc = kern.scale, [], 0
    for _ in range(8):
        u, v, logl, nci, blob, stats = s._new_point(loglstar)
        got.append(logl)
        nc += nci
    # rwalk rows always beat loglstar: one fill of 8 rows, 10 steps each,
    # and the scale is tuned once the queue has drained
    assert min(got) > loglstar and nc == 80
    assert not s.queue and s._pending_tuning is None
    assert kern.scale != scale0


# --------------------------------------------------------------------------
# the faults repaired on the way


def test_set_live_points_drops_the_cached_live_set():
    """A sampler that has run keeps its live points on the device; a live
    set given from outside must replace them, or the next dispatch runs on
    the old points."""
    s = dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=120,
                          bound="single", sample="unif", queue_size=32,
                          device="cpu", rstate=get_rstate(SEED))
    _quiet(lambda: next(s.sample(per_dispatch=True)))
    assert s._live_dev is not None and s._mirror_stale
    assert (s.queue_size, s._q_narrow) == (32, 16)
    # 40 points high up: every one beats the whole old live set
    s._ensure_live_mirror()
    old_max = s.live_logl.max()
    rs = get_rstate(1)
    u = 0.5 + 0.002 * rs.standard_normal((40, NDIM))
    v, logl, _ = s.loglikelihood.eval_host(u)
    assert logl.min() > old_max
    s.set_live_points(u, v, logl)
    assert s._live_dev is None and not s._mirror_stale
    assert s.nlive == 40 and np.array_equal(s.live_logl, logl)
    # the width follows the new live count
    assert (s.queue_size, s._q_full, s._q_narrow) == (20, 20, 16)
    # the next bound is fitted to the new points
    s.update_bound_if_needed(-np.inf, force=True)
    assert s.bound.logvol < -10
    n0 = len(s.saved_run["logl"])
    _quiet(lambda: next(s.sample(per_dispatch=True, resume=True)))
    assert min(s.saved_run["logl"][n0:]) >= logl.min()
    # the dispatch ran on the new points: the live set is still the
    # tight cluster, not the old points
    assert s.live_logl.shape == (40,) and s.live_logl.min() >= logl.min()
    assert np.abs(s.live_u - 0.5).max() < 0.02


def test_queue_clamp_follows_nlive_and_mode():
    s = dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=300,
                          queue_size=256, device="cpu",
                          rstate=get_rstate(SEED))
    assert (s.queue_size_req, s.queue_size, s._q_narrow) == (256, 150, 18)
    s.nlive = 1000
    s._apply_queue_clamp()
    assert (s.queue_size, s._q_full, s._q_narrow) == (256, 256, 32)
    s.proposal_mode = "queue"
    s.nlive = 40
    s._apply_queue_clamp()
    assert s.queue_size == 256


def test_estimate_remaining_in_a_bracket():
    s = dyt.NestedSampler(gau_loglike, gau_ptform, NDIM, nlive=100,
                          device="cpu", rstate=get_rstate(SEED))
    assert s._estimate_remaining(0.01, -5.0) is None
    # the first call marks where the bracket starts
    assert s._estimate_remaining(0.01, -5.0, logl_max=-1.0) is None
    assert (s._bracket_start, s._bracket_it0) == (-5.0, 1)
    s.it = 101
    est = s._estimate_remaining(0.01, -3.0, logl_max=-1.0)
    assert est == pytest.approx(1.2 * 100 * 0.5 / 0.5)
    s._bracket_est_total = 130.0
    assert s._estimate_remaining(0.01, -3.0, logl_max=-1.0) == \
        pytest.approx(1.2 * 30)
    # less than three quarters of a round left: the narrow width
    spec = _quiet(s._make_dispatch_spec, 0.01, -3.0, -1.0)
    assert spec["queue_size"] == s._q_narrow < s._q_full
    assert _quiet(s._make_dispatch_spec, 0.01, -3.0)["queue_size"] == \
        s._q_full


def test_dynamic_progress_line(monkeypatch):
    """The width-adaptive printer with the dynamic arguments, at a pinned
    terminal width: the long tier, a batch's stopping value in place of
    the dlogz margin."""
    monkeypatch.setattr(shutil, "get_terminal_size",
                        lambda fallback=None: os.terminal_size((200, 20)))
    res = tmisc.IteratorResult(
        worst=1, ustar=None, vstar=None, loglstar=-2.5, logvol=-3.0,
        logwt=-4.0, logz=-9.0, logzvar=0.04, h=1.0, nc=3, worst_it=7,
        boundidx=0, bounditer=0, eff=12.5, delta_logz=0.5, blob=None,
        proposal_stats=None)
    buf = io.StringIO()
    with redirect_stderr(buf):
        tmisc.print_fn_fallback(res, 10, 80, nbatch=2, dlogz=0.01,
                                stop_val=1.234, logl_min=-3.0, logl_max=-1.0)
    line = buf.getvalue()
    assert line == ("\riter: 10 | batch: 2 | bound: 0 | nc: 3 | ncall: 80 "
                    "| eff(%): 12.500 | loglstar: -3.000 < -2.500 < -1.000 "
                    "| logz: -9.000 +/-  0.200 | stop:  1.234")
    monkeypatch.setattr(shutil, "get_terminal_size",
                        lambda fallback=None: os.terminal_size((50, 20)))
    buf = io.StringIO()
    with redirect_stderr(buf):
        tmisc.print_fn_fallback(res, 10, 80, nbatch=2)
    assert len(buf.getvalue()) == 1 + 49
    short = tmisc.IteratorResultShort(
        worst=1, ustar=None, vstar=None, loglstar=-2.5, nc=3, worst_it=7,
        boundidx=0, bounditer=0, eff=12.5, delta_logz=0.5,
        proposal_stats=None)
    assert (short.logz, short.logzvar) == (-np.inf, 0.0)


def test_bench_25d_configuration_capped():
    """The JAX package's headline bench configuration (25-D correlated
    normal, single/rslice, slices 25, nlive 500, width 256, 24 rounds a
    dispatch), capped with ``maxiter``: the unit-cube phase, the first
    bound and the first slice rounds run at the full dimension."""
    ndim = 25
    cov = np.identity(ndim)
    cov[cov == 0] = 0.4
    cinv = torch.as_tensor(np.linalg.inv(cov))
    lnorm = -0.5 * (np.log(2 * np.pi) * ndim + np.log(np.linalg.det(cov)))
    s = dyt.NestedSampler(lambda x: -0.5 * (x @ cinv @ x) + lnorm,
                          lambda u: 10.0 * (2.0 * u - 1.0), ndim, nlive=500,
                          bound="single", sample="rslice", slices=25,
                          queue_size=256, rounds_per_dispatch=24,
                          device="cpu", rstate=get_rstate(SEED))
    assert s.queue_size == 250
    _quiet(s.run_nested, maxiter=1500, print_progress=False, add_live=False)
    res = s.results
    assert res.niter >= 1500 and s.interrupted_budget
    assert not s.unit_cube_sampling and s.internal_sampler.name == "rslice"
    assert s.internal_sampler.slices == 25
    assert np.all(np.diff(res.logl) >= 0) and np.all(np.isfinite(res.logz))
    stats = [p for p in res.proposal_stats if p and "n_contract" in p]
    assert stats and all(p["n_contract"] >= 25 for p in stats)
    assert int(np.sum(res.ncall)) + 500 == s.ncall


# --------------------------------------------------------------------------
# the factory


def test_dynamic_factory_refuses_what_is_not_ported(monkeypatch):
    # every argument is ported: a device mesh is taken (the lane split,
    # tests/test_torch_parallel.py), what is not a Mesh refused, and a
    # mesh that does not start on the sampler's device refused; a custom
    # bound is taken (dynamic 'unif' over one is refused at the first
    # batch's seeding, as in the JAX package: test_torch_custom_bound.py)
    with pytest.raises(TypeError, match="Mesh"):
        dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM,
                                 mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="first device"):
        dyt.DynamicNestedSampler(
            gau_loglike, gau_ptform, NDIM, device="cpu",
            mesh=dyt.parallel.make_mesh(devices=["meta", "cpu"]))
    mesh = dyt.parallel.make_mesh(devices=["cpu"] * 4)
    d = dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM, mesh=mesh,
                                 device="cpu")
    assert d.mesh is mesh and d.loglikelihood.mesh is mesh
    d = dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM,
                                 bound=dyt.bounding.Bound(NDIM),
                                 device="cpu")
    assert isinstance(d.bounding, dyt.bounding.Bound)
    with pytest.raises(ValueError, match="device"):
        dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM, device=None)
    # the card is the default; without CUDA it raises and never falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dyt.DynamicNestedSampler(gau_loglike, gau_ptform, NDIM)
    d = _dns()
    assert d.device == torch.device("cpu") and d.mapper is map
    assert d.internal_state == DynamicSamplerStatesEnum.INIT
    assert dyt.DynamicNestedSampler.restore is not None


def test_inner_samplers_get_fresh_kernels():
    """``sampling`` is a template: no tuning state passes from the base
    run to a batch or from one batch to the next."""
    d = _dns(bound="single", sample="rwalk", walks=10)
    _quiet(d.run_nested, nlive_init=80, maxbatch=0, print_progress=False)
    base_kernel = d.sampler.internal_sampler
    assert base_kernel is not d.sampling and base_kernel.scale != 1.0
    assert d.sampling.scale == 1.0
    _quiet(d.add_batch, nlive=50, maxiter=70, print_progress=False)
    bk = d.batch_sampler.internal_sampler_next
    assert bk is not base_kernel and bk is not d.sampling
    assert bk.walks == 10


# --------------------------------------------------------------------------
# the slice as a whole


def _check_dynamic(dns, nbatch=None):
    res = dns.results
    assert res.isdynamic()
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 5 * res.logzerr[-1], \
        (res.logz[-1], res.logzerr[-1])
    assert dns.batch >= 1 and len(res.batch_nlive) == dns.batch + 1
    assert len(res.batch_logl_bounds) == dns.batch + 1
    assert np.ptp(res.samples_n) > 0
    assert res.samples_batch.max() == dns.batch
    assert np.all(np.diff(res.logl) >= 0)
    assert res.niter == len(res.logl) == dns.it - 1
    if nbatch is not None:
        assert dns.batch == nbatch
    return res


@pytest.mark.parametrize("bound,sample", [("multi", "unif"),
                                          ("single", "rslice")])
def test_dynamic_gaussian_against_truth_and_jax(bound, sample):
    kw = dict(nlive_init=200, nlive_batch=100, maxbatch=4,
              print_progress=False)
    to = _dns(bound, sample)
    _quiet(to.run_nested, **kw)
    rt = _check_dynamic(to, nbatch=4)
    assert to.internal_state == DynamicSamplerStatesEnum.RUN_DONE
    assert to.batch_sampler is None
    ja = _jdns(bound, sample)
    _quiet(ja.run_nested, **kw)
    rj = ja.results
    assert ja.batch == to.batch
    assert list(rj.batch_nlive) == list(rt.batch_nlive)
    assert abs(rt.niter - rj.niter) < 0.15 * rj.niter, (rt.niter, rj.niter)
    err = np.hypot(rt.logzerr[-1], rj.logzerr[-1])
    assert abs(rt.logz[-1] - rj.logz[-1]) < 3 * err
    tim = to.timings
    for k in ("dyn_base", "dyn_batch", "dyn_seeding", "dyn_combine",
              "dyn_weight", "total", "dispatch"):
        assert tim[k] > 0, k
    assert tim["n_seeds"] == 400


def test_dynamic_default_stop_on_n_effective():
    d = _dns(bound="single")
    _quiet(d.run_nested, nlive_init=150, nlive_batch=100, n_effective=500,
           print_progress=False)
    assert d.n_effective >= 500
    res = d.results
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 5 * res.logzerr[-1]
    assert d.timings["dyn_stop"] > 0
    # a finished run is not resumed
    with pytest.warns(RuntimeWarning, match="finished"):
        d.run_nested(resume=True, print_progress=False)


@pytest.mark.parametrize("mode", ["weight", "full", "manual", "auto"])
def test_add_batch_modes(mode):
    d = _dns(bound="single")
    _quiet(d.run_nested, nlive_init=150, maxbatch=0, print_progress=False)
    n0 = d.results.niter
    kwargs = {"mode": mode}
    if mode == "manual":
        kwargs["logl_bounds"] = (-10.0, np.inf)
    if mode == "full":
        kwargs = {"mode": "manual", "logl_bounds": (-np.inf, np.inf)}
    _quiet(d.add_batch, nlive=100, print_progress=False, **kwargs)
    res = d.results
    assert d.batch == 1 and res.niter > n0
    assert d.internal_state == DynamicSamplerStatesEnum.BATCH_DONE
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 5 * res.logzerr[-1]
    lo, hi = res.batch_logl_bounds[1]
    if mode == "full":
        assert (lo, hi) == (-np.inf, np.inf)
        # the batch starts from the prior
        assert np.isneginf(res.samples_birth[res.samples_batch == 1][0])
    elif mode == "manual":
        assert hi == np.inf and lo <= -10.0
    with pytest.raises(RuntimeError):
        d.add_batch(mode="weight", logl_bounds=(0, 1), print_progress=False)
    with pytest.raises(RuntimeError):
        d.add_batch(mode="manual", print_progress=False)


def test_dynamic_eggbox_multi():
    d = dyt.DynamicNestedSampler(egg_loglike, identity, 2, bound="multi",
                                 sample="unif", queue_size=128,
                                 device="cpu", rstate=get_rstate(SEED))
    _quiet(d.run_nested, nlive_init=300, nlive_batch=200, maxbatch=1,
           print_progress=False, dlogz_init=0.01)
    res = d.results
    assert d.batch == 1
    assert abs(res.logz[-1] - 235.856) < 5 * res.logzerr[-1], \
        (res.logz[-1], res.logzerr[-1])


def test_reset_and_user_functions():
    d = _dns(bound="single")
    calls = []

    def stop(res, args, rstate=None, mapper=None, return_vals=False):
        calls.append(("stop", len(res["logl"])))
        return len(calls) > 4, (0.0, 0.0, float(len(calls)))

    def weight(res, args):
        calls.append(("weight", args["tag"]))
        return (-4.0, -1.5)

    _quiet(d.run_nested, nlive_init=100, nlive_batch=50,
           stop_function=stop, wt_function=weight, wt_kwargs={"tag": 7},
           print_progress=False)
    assert [c[0] for c in calls] == ["stop", "weight", "stop", "weight",
                                     "stop"]
    assert d.batch == 2
    assert [tuple(b) for b in d.results.batch_logl_bounds[1:]] == \
        [(-4.0, -1.5)] * 2
    d.reset()
    assert d.batch == 0 and d.it == 1 and d.sampler is None
    assert len(d.saved_run["logl"]) == 0
    _quiet(d.run_nested, nlive_init=100, maxbatch=0, print_progress=False)
    assert abs(d.results.logz[-1] - LOGZ_TRUTH) < 5 * d.results.logzerr[-1]


# --------------------------------------------------------------------------
# accounting


@pytest.mark.parametrize("bound,sample", [("multi", "unif"),
                                          ("single", "unif"),
                                          ("balls", "unif"),
                                          ("single", "rwalk")])
def test_dynamic_ncall_is_exact(bound, sample):
    """``ncall`` equals the points the likelihood wrapper was asked for:
    the initial points, the batch seeds, the queue rows that were dropped
    and every stranded proposal included."""
    d = _dns(bound, sample, queue_size=32, walks=10)
    counting = _Counting(d.loglikelihood)
    d.loglikelihood = counting
    _quiet(d.run_nested, nlive_init=80, nlive_batch=50, maxbatch=2,
           print_progress=False)
    assert d.batch == 2
    if sample == "rwalk":
        # a random walk bills each lane its `walks` steps, also the steps
        # that left the unit cube and were not asked for
        assert counting.n < d.ncall < counting.n_lanes
    else:
        assert d.ncall == counting.n
    res = d.results
    # per record: each recycled live point counts one call in its record
    # and the seeds' calls are no record's
    assert int(np.sum(res.ncall)) <= d.ncall + 80 + 2 * 50
    assert d.nc_waste_total >= 0


# --------------------------------------------------------------------------
# exactness


_EXACT_KEYS = ("logl", "logz", "logzerr", "logwt", "logvol", "samples",
               "samples_u", "samples_batch", "samples_n", "samples_it",
               "samples_id", "samples_birth", "ncall", "batch_nlive",
               "batch_logl_bounds", "information", "scale")


def _assert_same_run(a, b):
    ra, rb = a.results, b.results
    assert ra.niter == rb.niter and a.ncall == b.ncall
    assert a.batch == b.batch and a.it == b.it
    for k in _EXACT_KEYS:
        assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k])), k
    assert a.rstate.integers(2**62) == b.rstate.integers(2**62)


_RUN_KW = dict(nlive_init=120, nlive_batch=80, maxbatch=2,
               print_progress=False)


def _full_run(bound, sample):
    d = _dns(bound, sample, queue_size=32)
    _quiet(d.run_nested, **_RUN_KW)
    return d


@pytest.fixture(scope="module")
def full_runs():
    return {cfg: _full_run(*cfg) for cfg in (("single", "unif"),
                                             ("multi", "unif"),
                                             ("balls", "rslice"))}


def test_same_seed_same_dynamic_run(full_runs):
    again = _full_run("single", "unif")
    _assert_same_run(copy.deepcopy(full_runs[("single", "unif")]), again)
    other = _dns("single", "unif", seed=SEED + 1, queue_size=32)
    _quiet(other.run_nested, **_RUN_KW)
    assert other.results.niter != again.results.niter or \
        not np.array_equal(other.results.logl, again.results.logl)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("where", ["base", "between", "midbatch",
                                   "midbatch2"])
@pytest.mark.parametrize("bound,sample", [("single", "unif"),
                                          ("multi", "unif"),
                                          ("balls", "rslice")])
def test_dynamic_resume_is_exact(full_runs, tmp_path, bound, sample, where):
    """Stopped in the base run (a checkpoint written between two records,
    then the process lost), between two batches, or inside the first or
    the second batch (``maxiter``); saved, restored on the CPU and
    resumed: the run equals the uninterrupted one bit for bit."""
    full = copy.deepcopy(full_runs[(bound, sample)])
    n_base = int(np.sum(full.results.samples_batch == 0))
    d = _dns(bound, sample, queue_size=32)
    fname = str(tmp_path / "dyn.pkl")
    # the seeds of a batch count against its maxiter: 25 records of it run
    mid = dict(nlive=80, maxiter=80 + 25, print_progress=False)
    if where == "base":
        def save_and_stop(results, niter, ncall, **kw):
            if niter == (n_base - 120) // 2:
                d.save(fname)
                raise _Stop

        with pytest.raises(_Stop):
            _quiet(d.run_nested, **dict(_RUN_KW, print_progress=True,
                                        print_func=save_and_stop))
        assert d.internal_state == DynamicSamplerStatesEnum.INBASE
    elif where == "between":
        _quiet(d.run_nested, **dict(_RUN_KW, maxbatch=1))
        assert d.batch == 1 and d.batch_sampler is None
        d.save(fname)
    else:
        nb = 0 if where == "midbatch" else 1
        _quiet(d.run_nested, **dict(_RUN_KW, maxbatch=nb))
        _quiet(d.add_batch, **mid)
        assert d.batch == nb and d.batch_sampler is not None
        assert d.internal_state == DynamicSamplerStatesEnum.INBATCH
        assert not d.batch_sampler.first_points
        assert len(d.new_run["logl"]) == 25
        # the suspended batch shows in the results, and stays suspended
        assert d.results.niter == d.it - 1
        assert len(d.results.logl) == len(d.saved_run["logl"]) + 25
        assert d.batch_sampler is not None and d.batch == nb
        d.save(fname)
    del d
    d2 = dyt.DynamicNestedSampler.restore(fname, device="cpu")
    if where == "between":
        _quiet(d2.add_batch, nlive=80, print_progress=False)
    elif where == "midbatch":
        # finish the suspended batch by hand, then add the second one
        _quiet(d2.add_batch, nlive=80, resume=True, print_progress=False)
        assert d2.batch == 1 and d2.batch_sampler is None
        _quiet(d2.add_batch, nlive=80, print_progress=False)
    else:
        _quiet(d2.run_nested, resume=True, **_RUN_KW)
        assert d2.internal_state == DynamicSamplerStatesEnum.RUN_DONE
    _assert_same_run(full, d2)


def test_run_nested_stopped_inside_a_batch_resumes_exactly(full_runs):
    """``run_nested(maxiter=...)`` that ends inside the first batch: the
    seeds count against the batch's budget and not against the run's, so
    the same call takes the suspended batch up once more with what the
    seeds left over, and leaves it suspended again.  ``run_nested(resume=
    True)`` then finishes the run as the uninterrupted one."""
    full = copy.deepcopy(full_runs[("multi", "unif")])
    n_base = int(np.sum(full.results.samples_batch == 0))
    n_b1 = int(np.sum(full.results.samples_batch == 1)) - 80
    extra = n_b1 // 8
    assert 0 < extra and extra + 80 < n_b1
    d = _dns("multi", "unif", queue_size=32)
    _quiet(d.run_nested, maxiter=n_base + 80 + extra, **_RUN_KW)
    assert d.batch == 0 and d.batch_sampler is not None
    assert d.internal_state == DynamicSamplerStatesEnum.INBATCH
    assert len(d.new_run["logl"]) == extra + 80
    assert d.batch_sampler.timings["n_replay"] >= 1
    d2 = pickle.loads(pickle.dumps(d))
    _quiet(d2.run_nested, resume=True, **_RUN_KW)
    assert d2.internal_state == DynamicSamplerStatesEnum.RUN_DONE
    _assert_same_run(full, d2)


def test_checkpoint_file_of_a_dynamic_run(tmp_path):
    fname = str(tmp_path / "ckpt.pkl")
    d = _dns("single", "unif", queue_size=32)
    _quiet(d.run_nested, checkpoint_file=fname, checkpoint_every=0.5,
           **_RUN_KW)
    d2 = dyt.DynamicNestedSampler.restore(fname, device="cpu")
    assert isinstance(d2, tdyn.DynamicSampler)
    assert d2.internal_state == DynamicSamplerStatesEnum.RUN_DONE
    assert d2.device == torch.device("cpu")
    assert d2.sampler.device == d2.loglikelihood.device == d2.device
    assert np.array_equal(d2.results.logz, d.results.logz)
    # a cuda checkpoint raises where CUDA is absent, unless the CPU is
    # asked for
    d2.device = d2.sampler.device = torch.device("cuda")
    d2.save(fname)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dyt.DynamicNestedSampler.restore(fname)
    d3 = dyt.DynamicNestedSampler.restore(fname, device="cpu")
    assert d3.sampler.device == d3.loglikelihood.device == \
        torch.device("cpu")
