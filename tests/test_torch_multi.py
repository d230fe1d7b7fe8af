"""The default path (bound='multi', sample='unif', bootstrap expansion)
of the port against the JAX package, on the CPU.

Tolerances: the host fits are the same float64 numpy code on the same
points and seeds, so ellipsoids, radii and expansion factors are
bit-identical.  The device refit agrees to 1e-10 relative (LAPACK's and
XLA's Cholesky and triangular solves order their sums differently).  The
random kernels draw from torch Philox and JAX threefry, which never give
the same stream, so they are held to distributional gates, and whole runs
to the analytic evidence and to the JAX run's evidence and niter.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynesty_tpu as dytpu
import dynesty_tpu.bounding as jb
import dynesty_tpu.internal.fused as jfused
import dynesty_tpu.internal.kernels as jk
import dynesty_tpu.internal.samplers as jsam
import dynesty_tpu.ops.geometry as jgeo
import dynesty_tpu.utils.misc as jmisc
import dynesty_tpu_torch as dyt
import dynesty_tpu_torch.bounding as tb
import dynesty_tpu_torch.internal.fused as tfused
import dynesty_tpu_torch.internal.kernels as tk
import dynesty_tpu_torch.internal.samplers as tsam
import dynesty_tpu_torch.ops.geometry as tgeo
import dynesty_tpu_torch.utils.misc as tmisc
from dynesty_tpu_torch.utils.convert import (bound_arrays_to_torch,
                                             bound_from_arrays, to_numpy)

from test_torch_fused import _compare, _state
from torch_rounds import WholeRound
from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
SEED = 56432
LOGZ_TRUTH = -8.987  # analytic: -ndim * ln(20), the prior box is +-10


# --------------------------------------------------------------------------
# host fits: bit-identical to the JAX package


def _cloud(kind, n=400):
    rs = get_rstate(7)
    if kind == "gaussian":
        cov = np.full((NDIM, NDIM), 0.6) + 0.4 * np.eye(NDIM)
        return 0.5 + 0.08 * rs.multivariate_normal(np.zeros(NDIM), cov, n)
    if kind == "blobs":
        a = 0.25 + 0.03 * rs.normal(size=(n // 2, NDIM))
        return np.vstack([a, a[::-1] + 0.5])
    # a thin spherical shell: radius 0.3, width 0.01
    z = rs.normal(size=(n, NDIM))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return 0.5 + z * (0.3 + 0.01 * rs.random((n, 1)))


@pytest.mark.parametrize("bootstrap", [0, 5])
@pytest.mark.parametrize("cloud", ["gaussian", "blobs", "shell"])
def test_multiellipsoid_update_matches_jax(cloud, bootstrap):
    pts = _cloud(cloud)
    jbound, tbound = jb.MultiEllipsoid(NDIM), tb.MultiEllipsoid(NDIM)
    jbound.update(pts, rstate=get_rstate(), bootstrap=bootstrap)
    tbound.update(pts, rstate=get_rstate(), bootstrap=bootstrap)
    assert tbound.nells == jbound.nells
    if cloud == "blobs":
        assert tbound.nells > 1
    for k in ("ctrs", "covs", "ams", "logvol_ells"):
        assert np.array_equal(getattr(tbound, k), getattr(jbound, k)), k
    assert tbound.logvol == jbound.logvol
    assert tbound.last_expand == jbound.last_expand
    assert (tbound.last_expand > 1.0) == (bootstrap > 0)
    jkind, jarr = jbound.device_spec()
    tkind, tarr = tbound.device_spec()
    assert jkind == tkind == "ellipsoids"
    for k, v in jarr.items():
        assert np.array_equal(tarr[k], v), k
    assert tbound.contains_many(pts).all()
    assert np.array_equal(tbound.get_random_axes(get_rstate()),
                          jbound.get_random_axes(get_rstate()))


def test_recursive_splitter_matches_jax_and_the_batched_one():
    pts = _cloud("blobs")
    jm, tm = jb.bounding_ellipsoids(pts), tb.bounding_ellipsoids(pts)
    assert tm.nells == jm.nells > 1
    assert np.array_equal(tm.ctrs, jm.ctrs)
    assert np.array_equal(tm.covs, jm.covs)
    # the breadth-first batched splitter takes the same splits
    batched = tb.MultiEllipsoid(NDIM)
    batched.update(pts)
    assert batched.nells == tm.nells
    np.testing.assert_allclose(batched.ctrs, tm.ctrs, rtol=1e-12)
    for multi in (False, True):
        seed = tmisc.get_seed_sequence(get_rstate(), 1)[0]
        jseed = jmisc.get_seed_sequence(get_rstate(), 1)[0]
        j = jb._ellipsoid_bootstrap_expand((multi, pts, jseed))[0]
        assert tb._ellipsoid_bootstrap_expand(multi, pts, seed) == j


@pytest.mark.parametrize("cls", ["Ellipsoid", "RadFriends", "SupFriends"])
def test_bootstrap_update_matches_jax(cls):
    pts = _cloud("gaussian", 300)
    jbound = getattr(jb, cls)(NDIM)
    tbound = getattr(tb, cls)(NDIM) if cls == "Ellipsoid" else \
        getattr(tb, cls)(NDIM, device="cpu")
    jbound.update(pts, rstate=get_rstate(), bootstrap=5)
    tbound.update(pts, rstate=get_rstate(), bootstrap=5)
    for k in ("cov", "am", "axes"):
        assert np.array_equal(getattr(tbound, k), getattr(jbound, k)), k
    assert tbound.logvol == jbound.logvol
    if cls == "Ellipsoid":
        assert tbound.last_expand == jbound.last_expand > 1.0
    else:
        assert np.array_equal(tbound.axes_inv, jbound.axes_inv)


def test_host_helpers_match_jax():
    assert [s.entropy for s in tmisc.get_seed_sequence(get_rstate(), 3)] == \
        [s.entropy for s in jmisc.get_seed_sequence(get_rstate(), 3)]
    a, b = get_rstate(), get_rstate()
    assert [s.spawn_key for s in tmisc.get_seed_sequence(a, 3)] == \
        [s.spawn_key for s in jmisc.get_seed_sequence(b, 3)]
    assert np.array_equal(tgeo.randsphere(NDIM, a), jgeo.randsphere(NDIM, b))
    probs = np.array([0.2, 0.5, 0.3])
    assert [tgeo.rand_choice(probs, a) for _ in range(20)] == \
        [jgeo.rand_choice(probs, b) for _ in range(20)]


def test_multi_state_carried_across():
    jbound = jb.MultiEllipsoid(NDIM)
    jbound.update(_cloud("blobs"), rstate=get_rstate(), bootstrap=5)
    arrays = {"ctrs": jbound.ctrs, "covs": jbound.covs}
    tbound = bound_from_arrays("multi", NDIM, arrays)
    jrebuilt = jb.MultiEllipsoid(NDIM, ctrs=jbound.ctrs, covs=jbound.covs)
    assert tbound.nells == jbound.nells
    assert tbound.logvol == jrebuilt.logvol
    _, tarr = tbound.device_spec()
    dev = bound_arrays_to_torch("ellipsoids", dict(tarr, expand=1.5), "cpu")
    _, jarr = jrebuilt.device_spec()
    padded = jk.pad_ellipsoids(jarr["ctrs"], jarr["axes"], jarr["ams"],
                               jarr["logvols"])
    for k, v in padded.items():
        assert np.array_equal(dev[k].numpy(), v), k
    assert dev["expand"].dim() == 0 and float(dev["expand"]) == 1.5


# --------------------------------------------------------------------------
# device refit: 1e-10 relative, degenerate slots keep their previous fit


def _refit_inputs(case):
    """A padded stack of 3 ellipsoids (4 slots) and live points: slot 2
    gets fewer than d+1 members ('degenerate'), or one member far out
    whose covariance overflows ('overflow')."""
    rs = get_rstate(11)
    ctrs = np.array([[0.3, 0.3, 0.3], [0.7, 0.7, 0.7], [0.3, 0.8, 0.5]])
    covs = np.array([np.eye(NDIM) * 0.01] * 3)
    mb = jb.MultiEllipsoid(NDIM, ctrs=ctrs, covs=covs)
    _, arr = mb.device_spec()
    padded = jk.pad_ellipsoids(arr["ctrs"], arr["axes"], arr["ams"],
                               arr["logvols"])
    padded["expand"] = np.float64(1.1)
    u = np.vstack([ctrs[0] + 0.05 * rs.normal(size=(60, NDIM)),
                   ctrs[1] + 0.05 * rs.normal(size=(60, NDIM)),
                   ctrs[2] + 0.01 * rs.normal(size=(2, NDIM))])
    if case == "overflow":
        u[-1] = ctrs[2] + 1e200
    return u, padded


@pytest.mark.parametrize("case", ["degenerate", "overflow"])
def test_ellipsoid_refit_matches_jax(case):
    u, padded = _refit_inputs(case)
    jout = jk.make_ellipsoid_refit(NDIM, dtype=jnp.float64)(
        jnp.asarray(u), {k: jnp.asarray(v) for k, v in padded.items()})
    dev = bound_arrays_to_torch("ellipsoids", {
        "ctrs": padded["ctrs"][:3], "axes": padded["axes"][:3],
        "ams": padded["ams"][:3], "logvols": padded["logvols"][:3],
        "expand": padded["expand"]}, "cpu")
    tout = tk.make_ellipsoid_refit(NDIM)(torch.from_numpy(u), dev)
    assert np.array_equal(tout["mask"].numpy(), np.asarray(jout["mask"]))
    for k in ("ctrs", "axes", "ams", "logvols"):
        j, t = np.asarray(jout[k]), tout[k].numpy()
        np.testing.assert_allclose(t, j, rtol=1e-10, atol=0, err_msg=k)
    # slots 0 and 1 were refitted; the degenerate (or overflowing) slot
    # and the padding slot kept the host fit
    kept = [2, 3] if case == "degenerate" else [0, 2, 3]
    for k in ("ctrs", "axes", "ams", "logvols"):
        for i in range(4):
            same = np.array_equal(tout[k][i].numpy(), padded[k][i])
            assert same == (i in kept), (k, i)
    # every refitted slot contains all its members, inside the expansion
    near = u[np.abs(u).max(axis=1) < 2.0]
    for i in {0, 1} - set(kept):
        mem = near[np.argmin([[(x - c) @ a @ (x - c) for c, a in zip(
            padded["ctrs"][:3], padded["ams"][:3])] for x in near],
            axis=1) == i]
        dd = mem - tout["ctrs"][i].numpy()
        d2 = np.einsum("ni,ij,nj->n", dd, tout["ams"][i].numpy(), dd)
        assert d2.max() <= (1.0 / 1.1) ** 2


# --------------------------------------------------------------------------
# union samplers: distributional gates


def _two_circles():
    mb = tb.MultiEllipsoid(2, ctrs=np.array([[0.0, 0.0], [1.0, 0.0]]),
                           covs=np.array([np.eye(2), np.eye(2)]))
    return bound_arrays_to_torch("ellipsoids", mb.device_spec()[1], "cpu")


def _union_valid(sq, mask, ua):
    """The union's overlap test on the draws of ``_sample_ellipsoid_union``
    (as ``unif_valid`` applies it, without the cube check: these circles
    leave the cube): in ``nin`` > 0 slots, and ``ua < 1 / nin``."""
    inside = (sq < 1.0) & mask[None, :]
    nin = torch.where(inside.any(1), inside.sum(1),
                      ((sq <= 1.0 + 1e-3) & mask[None, :]).sum(1))
    return (nin > 0) & (ua < 1.0 / nin.clamp_min(1).to(ua.dtype))


def test_ellipsoid_union_sampling_uniform():
    arrays = _two_circles()
    gen = tmisc.torch_generator(SEED, "cpu")
    x, sq, ua = tk._sample_ellipsoid_union(gen, arrays, 40000, 2,
                                           torch.float64)
    valid = _union_valid(sq, arrays["mask"], ua)
    xs = x[valid].numpy()
    n = len(xs)
    d2 = ((xs[:, None, :] - np.array([[0.0, 0.0], [1.0, 0.0]])) ** 2).sum(-1)
    # every accepted draw lies inside the union
    assert np.all(d2.min(axis=1) < 1.0)
    # left/right symmetry about x = 0.5 (tests/test_ellipsoid.py)
    left, right = np.sum(xs[:, 0] < 0.5), np.sum(xs[:, 0] > 0.5)
    assert abs(left - right) < 5 * np.sqrt(n)
    # the share in the overlap lens matches its share of the union area
    lens = 2 * np.arccos(0.5) - 0.5 * np.sqrt(3.0)
    p = lens / (2 * np.pi - lens)
    share = np.mean(np.all(d2 < 1.0, axis=1))
    assert abs(share - p) < 4 * np.sqrt(p * (1 - p) / n)
    # the 1/q rejection keeps about union / summed volume of the draws
    assert abs(n / 40000 - (2 * np.pi - lens) / (2 * np.pi)) < 0.02


@pytest.mark.parametrize("ftype", ["balls", "cubes"])
def test_friends_union_sampling_uniform(ftype):
    ctrs = np.array([[0.0, 0.0], [1.0, 0.0]])
    arrays = {"ctrs": torch.from_numpy(ctrs),
              "axes": torch.eye(2, dtype=torch.float64),
              "axes_inv": torch.eye(2, dtype=torch.float64)}
    gen = tmisc.torch_generator(SEED, "cpu")
    x, acc = tk._sample_friends_union(gen, arrays, 40000, 2, torch.float64,
                                      ftype)
    xs = x[acc].numpy()
    dist = np.abs(xs[:, None, :] - ctrs)
    dist = np.sqrt((dist ** 2).sum(-1)) if ftype == "balls" \
        else dist.max(-1)
    assert np.all(dist.min(axis=1) <= 1.0)
    left, right = np.sum(xs[:, 0] < 0.5), np.sum(xs[:, 0] > 0.5)
    assert abs(left - right) < 5 * np.sqrt(len(xs))
    if ftype == "cubes":
        # two unit-half-width squares overlapping on a 1 x 2 strip
        share = np.mean(np.all(dist <= 1.0, axis=1))
        n = len(xs)
        assert abs(share - 2.0 / 6.0) < 4 * np.sqrt(2 / 9 / n)


# --------------------------------------------------------------------------
# the uniform round over an ellipsoid stack


class _StubLike:
    """A traceable-free Gaussian likelihood for driving kernels
    directly."""

    npdim = 2

    def batch_eval(self, u, mask=None):
        v = 10.0 * (2.0 * u - 1.0)
        return v, -0.5 * (v * v).sum(dim=1), None


def test_unif_round_over_ellipsoids_per_slot_nc():
    q, il = 32, 4
    mb = tb.MultiEllipsoid(2, ctrs=np.array([[0.45, 0.5], [0.55, 0.5]]),
                           covs=np.array([np.eye(2) * 0.01] * 2))
    arrays = bound_arrays_to_torch("ellipsoids", mb.device_spec()[1], "cpu")
    fn = tk.make_unif_round(_StubLike(), ndim=2, q=q,
                            bound_kind="ellipsoids", dtype=torch.float64,
                            device="cpu")
    loglstar = -2.0
    packed = fn(tmisc.torch_generator(SEED, "cpu"), loglstar,
                arrays)[0].numpy()
    slot_nc = packed[:, il + 1].astype(np.int64)
    nc_total, n_filled = int(packed[0, il + 2]), int(packed[0, il + 4])
    assert n_filled == q
    assert np.all(slot_nc >= 1) and slot_nc.sum() == nc_total > q
    assert np.all(packed[:, il] > loglstar)
    d = packed[:, None, :2] - mb.ctrs
    assert np.all(np.einsum("qmi,mij,qmj->qm", d, mb.ams, d).min(1) < 1)

    # a forced partial fill (one wave at a threshold few draws beat)
    fn1 = tk.make_unif_round(_StubLike(), ndim=2, q=q,
                             bound_kind="ellipsoids", dtype=torch.float64,
                             device="cpu", max_waves=1)
    packed = fn1(tmisc.torch_generator(SEED, "cpu"), -0.3,
                 arrays)[0].numpy()
    n_filled = int(packed[0, il + 4])
    assert 0 < n_filled < q
    assert np.all(packed[n_filled:, il] == -np.inf)
    assert np.all(packed[:n_filled, il] > -0.3)
    assert packed[:, il + 1].sum() == packed[0, il + 2]


def test_unif_inefficiency_warning():
    # the dispatch's summed stats (nc_total, n_proposals, n_filled, -)
    s = tsam.UniformBoundSampler(ndim=2)
    with pytest.warns(RuntimeWarning, match="extremely inefficient"):
        s.apply_fused_tuning({"stats": np.array([0.0, 10000 * 16, 16, 0])})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s.apply_fused_tuning({"stats": np.array([0.0, 100 * 16, 16, 0])})


# --------------------------------------------------------------------------
# the refit-due gate (ctrl[21])


@pytest.mark.parametrize("cube, nells, last, interval", [
    (True, 3, 1000, 500), (False, 1, 1000, 500), (False, 3, 1000, 500),
    (False, 2, 2 ** 30 - 10, 500)])
def test_refit_due_ncall_matches_jax(cube, nells, last, interval):
    ns = types.SimpleNamespace(unit_cube_sampling=cube,
                               bound=types.SimpleNamespace(nells=nells),
                               ncall_at_last_update=last,
                               bound_update_interval=interval)
    t = tsam.UniformBoundSampler(ndim=2)._refit_due_ncall(ns)
    assert t == jsam.UniformBoundSampler(ndim=2)._refit_due_ncall(ns)
    armed = not cube and nells > 1
    assert t == (min(last + interval, 2.0 ** 30) if armed else 2.0 ** 30)
    # the other kernels never arm it
    assert tsam.RSliceSampler(ndim=2)._refit_due_ncall(ns) == 2.0 ** 30


@pytest.mark.parametrize("due_rounds", [0.5, 1.0, 2.5, 9.0])
def test_chain_stops_at_first_boundary_past_refit_due(due_rounds):
    """Both packages' fused chains with the unif gate: with every round
    billing S calls, the chain stops at the first round boundary whose
    cumulative ncall is >= ctrl[21]."""
    nlive, ndim, npdim, q, rounds = 64, 2, 2, 16, 4
    il = ndim + npdim
    live, prop = _state()
    s_round = int(prop[:, il + 1].sum())
    ncall0 = 5000.0
    ctrl = np.array([-1e30, 0.0, 0.0, 0.0, -1e30, 0.0, 0.0, 0.0, 1.0,
                     -np.inf, np.inf, 2.0 ** 30, 2.0 ** 30, 1.0, 0.0,
                     float(rounds), -1e30, 0.0, ncall0, 0.0, 0.0,
                     ncall0 + due_rounds * s_round])

    def jprop(k_sel, k_prop, live_, live_blob, axes_args, scale, loglstar):
        p = axes_args["prop"]
        return (p[:, :ndim], p[:, ndim:il], p[:, il], None,
                p[:, il + 1].astype(jnp.int32), (p[:, il + 2].sum(),),
                p[:, il + 2:il + 4])

    def tprop(gen, live_, live_blob, axes_args, scale, loglstar):
        p = axes_args["prop"]
        return (p[:, :ndim], p[:, ndim:il], p[:, il], None,
                p[:, il + 1].to(torch.int64), (p[:, il + 2].sum(),),
                p[:, il + 2:il + 4])

    jfn, layout = jfused.make_fused_round(
        jprop, kind="fixed", nlive=nlive, ndim=ndim, npdim=npdim, q=q,
        dtype=jnp.float64, rounds=rounds,
        chain_stop_fn=jsam.UniformBoundSampler(
            ndim=ndim).device_chain_stop_fn(), gate_on_done=True)
    jflat, _, jlive, _, _, _ = jfn(jax.random.key(0), jnp.asarray(live),
                                   None, {"prop": jnp.asarray(prop)},
                                   jnp.asarray(ctrl))
    tfn, tlayout = tfused.make_fused_round(
        WholeRound(tprop), nlive=nlive, ndim=ndim, npdim=npdim, q=q,
        dtype=torch.float64, device="cpu", rounds=rounds,
        chain_stop_fn=tsam.UniformBoundSampler(
            ndim=ndim).device_chain_stop_fn())
    tflat, _, tlive, _, _, _ = tfn(0, torch.from_numpy(live), None,
                                   {"prop": torch.from_numpy(prop)}, ctrl)
    assert layout == tlayout
    out = _compare(np.asarray(jflat), to_numpy(tflat), np.asarray(jlive),
                   to_numpy(tlive), layout)
    ran = min(int(np.ceil(due_rounds)), rounds)
    assert out["n_consumed"] == ran * q
    assert out["nc_used"] == ran * s_round
    assert bool(out["done_reason"] & 32) == (ran < rounds)


# --------------------------------------------------------------------------
# end to end


def _gauss_torch(nlive, **kw):
    cov = np.identity(NDIM)
    cov[cov == 0] = 0.95
    cinv = torch.as_tensor(np.linalg.inv(cov))
    lnorm = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(cov)))
    return dyt.NestedSampler(lambda x: -0.5 * (x @ cinv @ x) + lnorm,
                             lambda u: 10.0 * (2.0 * u - 1.0), NDIM,
                             nlive=nlive, device="cpu",
                             rstate=get_rstate(SEED), **kw)


def test_default_arguments_against_truth_and_jax():
    s = _gauss_torch(500)
    assert isinstance(s.bound_next, tb.MultiEllipsoid)
    assert s.internal_sampler_next.name == "unif"
    assert (s.bound_bootstrap, s.bound_enlarge) == (5, 1)
    s.run_nested(print_progress=False)
    res = s.results
    logz, err = res.logz[-1], res.logzerr[-1]
    assert abs(logz - LOGZ_TRUTH) < 4 * err
    assert s.timings["n_refit"] >= 1 and s.bound.last_expand > 1.0
    assert s.timings["sync_wave"] > 0
    # every evaluation is billed to a record (the add_live records bill
    # one each, as the prior draw of the live points did)
    assert int(np.sum(res.ncall)) == s.ncall

    cov = np.identity(NDIM)
    cov[cov == 0] = 0.95
    cinv = np.linalg.inv(cov)
    lnorm = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(cov)))
    j = dytpu.NestedSampler(
        lambda x: -0.5 * jnp.dot(x, jnp.asarray(cinv) @ x) + lnorm,
        lambda u: 10.0 * (2.0 * u - 1.0), NDIM, nlive=500,
        rstate=get_rstate(SEED))
    j.run_nested(print_progress=False)
    jres = j.results
    assert abs(logz - jres.logz[-1]) < 3 * np.hypot(err, jres.logzerr[-1])
    assert abs(res.niter - jres.niter) < 0.1 * jres.niter


def _eggbox(lib):
    tmax = 5.0 * np.pi

    def loglike(x):
        t = 2.0 * tmax * x - tmax
        return (2.0 + lib.cos(t[0] / 2.0) * lib.cos(t[1] / 2.0)) ** 5.0

    return loglike


def test_eggbox_multi_unif_against_jax():
    s = dyt.NestedSampler(_eggbox(torch), lambda u: u, 2, nlive=300,
                          bound="multi", sample="unif", queue_size=128,
                          device="cpu", rstate=get_rstate(SEED))
    s.run_nested(print_progress=False)
    res = s.results
    assert s.bound.nells > 1
    j = dytpu.NestedSampler(_eggbox(jnp), lambda u: u, 2, nlive=300,
                            bound="multi", sample="unif", queue_size=128,
                            rstate=get_rstate(SEED))
    j.run_nested(print_progress=False)
    jres = j.results
    assert abs(res.logz[-1] - jres.logz[-1]) < \
        4 * np.hypot(res.logzerr[-1], jres.logzerr[-1])


@pytest.mark.parametrize("bound, sample", [
    ("multi", "rslice"), ("balls", "unif"), ("cubes", "unif"),
    ("single", "unif")])
def test_small_runs_pass_the_gate(bound, sample):
    s = _gauss_torch(160, bound=bound, sample=sample, queue_size=32)
    s.run_nested(print_progress=False)
    res = s.results
    assert abs(res.logz[-1] - LOGZ_TRUTH) < 4 * res.logzerr[-1]
    assert s.nbound > 1
    assert s.bound_bootstrap == (5 if sample == "unif" else 0)
