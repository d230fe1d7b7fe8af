"""Consume parity: the port's fused round against the JAX package's on the
same live matrix and the same fixed proposal block.

Both packages get a propose function that returns a fixed block (the
pattern of the JAX package's replay round), so the comparison isolates
the consume loop, the record/live assembly and the flat packing.

Tolerance: every integer-valued output (worst index, accepts, per-record
nc, iteration and bound columns, live counts, counters, the stop reason)
and every logl/u/v copy must be bit-identical; the integrator columns
(logvol, logwt, logz, logzvar, h, delta_logz) agree within 1e-12
relative, because XLA's and torch's exp/log1p/logaddexp differ by an ulp
at some inputs and log1p(-exp(-dlv)) magnifies that by 1/dlv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynesty_tpu.internal.fused as jfused
import dynesty_tpu_torch.internal.fused as tfused
from dynesty_tpu_torch.utils.convert import live_to_torch, to_numpy

from torch_rounds import WholeRound
from utils import get_rstate

torch.set_num_threads(1)

NDIM, NPDIM, NLIVE, Q = 2, 2, 64, 16
IL = NDIM + NPDIM


def _state(plateau=False, below=False, seed=None):
    """Live matrix (u | v | logl | it | bound | birth) and a proposal block
    (u | v | logl | nc | 2 lane stats) above the round threshold."""
    rs = get_rstate(seed)
    logl = rs.normal(size=NLIVE) * 2.0
    if plateau:
        # ties everywhere, including across the kill set
        logl = np.round(logl)
    u = rs.random((NLIVE, NDIM))
    live = np.concatenate([
        u, 10.0 * u, logl[:, None],
        rs.integers(0, 50, NLIVE)[:, None].astype(float),
        np.zeros((NLIVE, 1)), np.full((NLIVE, 1), -1e30)], axis=1)
    srt = np.sort(logl)
    thr = srt[Q - 1] if srt[Q - 1] < srt[-1] else srt[srt < srt[-1]][-1]
    qlogl = thr + np.abs(rs.normal(size=Q)) * 3.0 + 1e-3
    if below:
        qlogl[5] = thr - 1.0  # one proposal under the threshold
    qu = rs.random((Q, NDIM))
    prop = np.concatenate([qu, 10.0 * qu, qlogl[:, None],
                           rs.integers(1, 30, Q)[:, None].astype(float),
                           rs.integers(0, 9, (Q, 2)).astype(float)], axis=1)
    return live, prop


def _ctrl(rounds_active, dlogz=0.01, max_accepts=2**30):
    return np.array([-1e30, 0.0, 0.0, 0.0, -1e30, 0.0, 0.0, 0.0, 1.0,
                     dlogz, np.inf, float(max_accepts), 2.0**30, 1.0, 0.0,
                     float(rounds_active), -1e30, 0.0, 0.0, 0.0, 0.0,
                     2.0**30])


def _jax_run(live, prop, rounds, mode, ctrl):
    def propose(k_sel, k_prop, live_, live_blob, axes_args, scale,
                loglstar):
        p = axes_args["prop"]
        return (p[:, :NDIM], p[:, NDIM:IL], p[:, IL], None,
                p[:, IL + 1].astype(jnp.int32), (p[:, IL + 2].sum(),),
                p[:, IL + 2:IL + 4])

    fn, layout = jfused.make_fused_round(
        propose, kind="fixed", nlive=NLIVE, ndim=NDIM, npdim=NPDIM, q=Q,
        dtype=jnp.float64, rounds=rounds, mode=mode)
    flat, _, live_out, _, _, _ = fn(jax.random.key(0), jnp.asarray(live),
                                    None, {"prop": jnp.asarray(prop)},
                                    jnp.asarray(ctrl))
    return np.asarray(flat), np.asarray(live_out), layout


def _torch_run(live, prop, rounds, mode, ctrl):
    def propose(gen, live_, live_blob, axes_args, scale, loglstar):
        p = axes_args["prop"]
        return (p[:, :NDIM], p[:, NDIM:IL], p[:, IL], None,
                p[:, IL + 1].to(torch.int64), (p[:, IL + 2].sum(),),
                p[:, IL + 2:IL + 4])

    fn, layout = tfused.make_fused_round(
        WholeRound(propose), nlive=NLIVE, ndim=NDIM, npdim=NPDIM, q=Q,
        dtype=torch.float64, device="cpu", rounds=rounds, mode=mode)
    flat, _, live_out, _, _, _ = fn(0, live_to_torch(live, "cpu"), None,
                                    {"prop": torch.from_numpy(prop)}, ctrl)
    return to_numpy(flat), to_numpy(live_out), layout


def _compare(jflat, tflat, jlive, tlive, layout):
    assert jflat.shape == tflat.shape
    j = jfused.unpack_flat(jflat, layout)
    t = tfused.unpack_flat(tflat, layout)
    cols = jfused.record_columns(NDIM, NPDIM)
    exact = [i for i, c in enumerate(cols)
             if c not in ("logvol", "logwt", "logz", "logzvar", "h")]
    close = [i for i in range(len(cols)) if i not in exact]
    assert np.array_equal(j["records"][:, exact], t["records"][:, exact])
    np.testing.assert_allclose(t["records"][:, close],
                               j["records"][:, close], rtol=1e-12, atol=0)
    for k in ("n_accepted", "nc_used", "done", "n_consumed", "done_reason",
              "scale_final", "nc_launched"):
        assert j[k] == t[k], k
    for k in ("accepts", "lane_stats", "round_thresholds", "stats"):
        assert np.array_equal(j[k], t[k]), k
    np.testing.assert_allclose(t["delta_logz"], j["delta_logz"],
                               rtol=1e-12, atol=0)
    for k, v in j["integ"].items():
        if isinstance(v, (bool, int)):
            assert t["integ"][k] == v, k
        else:
            np.testing.assert_allclose(t["integ"][k], v, rtol=1e-12,
                                       atol=0, err_msg=k)
    assert np.array_equal(jlive, tlive)
    return t


@pytest.fixture
def force_general(monkeypatch):
    monkeypatch.setattr(jfused, "_FORCE_GENERAL_CONSUME", True)
    monkeypatch.setattr(tfused, "_FORCE_GENERAL_CONSUME", True)


CASES = {
    # name: (state kwargs, rounds, mode, ctrl kwargs)
    "thin": ({}, 1, "batch", {}),
    "thin_plateau": ({"plateau": True}, 1, "batch", {}),
    "below_threshold": ({"below": True}, 1, "batch", {}),
    "two_rounds": ({}, 2, "batch", {}),
    "one_of_two_rounds_active": ({}, 2, "batch", {}),
    "max_accepts_stop": ({}, 1, "batch", {"max_accepts": 5}),
    "dlogz_stop": ({}, 1, "batch", {"dlogz": 1e3}),
    "queue": ({}, 1, "queue", {}),
}


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_consume_parity(case, general, request):
    if general:
        request.getfixturevalue("force_general")
    kw, rounds, mode, ckw = CASES[case]
    live, prop = _state(**kw)
    active = 1 if case == "one_of_two_rounds_active" else rounds
    ctrl = _ctrl(active, **ckw)
    jflat, jlive, layout = _jax_run(live, prop, rounds, mode, ctrl)
    tflat, tlive, tlayout = _torch_run(live, prop, rounds, mode, ctrl)
    assert layout == tlayout
    t = _compare(jflat, tflat, jlive, tlive, layout)
    if case == "max_accepts_stop":
        assert t["n_accepted"] == 5 and t["done_reason"] & 8
    if case == "dlogz_stop":
        assert t["done_reason"] & 1
    if case == "thin_plateau":
        # the kill set holds ties, so plateau entry and exit ran
        dead_logl = t["records"][t["accepts"], 1 + IL]
        assert len(np.unique(dead_logl)) < len(dead_logl)


def test_thin_and_general_agree_bitwise(monkeypatch):
    """Within the port, the thin scalar scan is an exact collapse of the
    general scan."""
    live, prop = _state(plateau=True)
    thin = _torch_run(live, prop, 2, "batch", _ctrl(2))
    monkeypatch.setattr(tfused, "_FORCE_GENERAL_CONSUME", True)
    gen = _torch_run(live, prop, 2, "batch", _ctrl(2))
    assert np.array_equal(thin[0], gen[0])
    assert np.array_equal(thin[1], gen[1])


def _gauss_run(**kw):
    import dynesty_tpu_torch as dyt

    cinv = torch.linalg.inv(torch.full((3, 3), 0.95, dtype=torch.float64) +
                            0.05 * torch.eye(3, dtype=torch.float64))
    s = dyt.NestedSampler(lambda x: -0.5 * (x @ cinv @ x),
                          lambda u: 10.0 * (2.0 * u - 1.0), 3, nlive=60,
                          bound="single", sample="rslice", queue_size=16,
                          device="cpu", rstate=get_rstate(56), **kw)
    s.run_nested(dlogz=1.0, print_progress=False)
    return s.results


def test_thin_general_bit_identical_end_to_end(monkeypatch):
    """A whole run is bit-identical with the thin path compiled out (the
    pattern of tests/test_fused_paths.py)."""
    res_thin = _gauss_run()
    monkeypatch.setattr(tfused, "_FORCE_GENERAL_CONSUME", True)
    res_gen = _gauss_run()
    for key in ("logz", "logzerr", "logl", "logvol", "logwt", "ncall",
                "samples", "samples_it", "samples_id", "samples_u",
                "samples_n", "samples_birth"):
        assert np.array_equal(res_thin[key], res_gen[key]), key
    assert res_thin.niter == res_gen.niter


def test_queue_mode_end_to_end():
    res = _gauss_run(proposal_mode="queue")
    # constant live count in queue mode, the full ramp at the end
    n = res.samples_n
    assert np.all(n[:res.niter] == 60)
    assert np.array_equal(n[res.niter:], np.arange(60, 0, -1))
    assert abs(res.logz[-1] + 8.987) < 4 * res.logzerr[-1]
