"""The consume scan (``dynesty_tpu_torch/ops/consume.py``): its wrapper on
CPU tensors against the JAX package's fused round, the plain version
against a recorded run, the wrapper's checks, and on a card the
``consume_scan`` kernel against the plain version.

CPU tolerances, as in ``test_torch_fused.py``: every integer and copied
column, the counters, the stop reason and the live matrix bit-identical;
logvol, logwt, logz, logzvar, h and delta_logz within 1e-12 relative,
because XLA's and torch's exp/log1p/logaddexp differ by an ulp at some
inputs.  On the card the kernel and the plain version run the same
operations with the same rounding: everything bit for bit.

The JAX package is imported by a fixture, and its comparisons run only
under ``tests/conftest.py`` (JAX on the CPU in float64), so that the card
tests of this file run on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_consume.py
"""

import hashlib

import numpy as np
import pytest
import torch

import dynesty_tpu_torch.internal.fused as tfused
from dynesty_tpu_torch.ops import build
from dynesty_tpu_torch.ops import consume as cs
from dynesty_tpu_torch.utils.convert import live_to_torch, to_numpy

from utils import get_rstate

torch.set_num_threads(1)

NDIM, NPDIM, NLIVE, Q = 2, 2, 64, 16
IL = NDIM + NPDIM
FLOAT_COLS = ("logvol", "logwt", "logz", "logzvar", "h")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's fused module and jax itself."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("the JAX comparisons run under tests/conftest.py "
                    "(JAX on the CPU in float64)")
    import dynesty_tpu.internal.fused as jfused
    return jax, jfused


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(plateau=False, below=False, neg_inf=False, seed=None):
    """Live matrix (u | v | logl | it | bound | birth) and a proposal block
    (u | v | logl | nc | 2 lane stats) above the round threshold."""
    rs = get_rstate(seed)
    logl = rs.normal(size=NLIVE) * 2.0
    if plateau:
        logl = np.round(logl)  # ties everywhere, into the kill set
    if neg_inf:
        logl[:] = -np.inf
    u = rs.random((NLIVE, NDIM))
    live = np.concatenate([
        u, 10.0 * u, logl[:, None],
        rs.integers(0, 50, NLIVE)[:, None].astype(float),
        np.zeros((NLIVE, 1)), np.full((NLIVE, 1), -1e30)], axis=1)
    srt = np.sort(logl)
    if neg_inf:
        thr = -1e30
    elif srt[Q - 1] < srt[-1]:
        thr = srt[Q - 1]
    else:
        thr = srt[srt < srt[-1]][-1]
    qlogl = thr + np.abs(rs.normal(size=Q)) * 3.0 + 1e-3
    if below:
        qlogl[5] = thr - 1.0  # one proposal under the threshold
    qu = rs.random((Q, NDIM))
    prop = np.concatenate([qu, 10.0 * qu, qlogl[:, None],
                           rs.integers(1, 30, Q)[:, None].astype(float),
                           rs.integers(0, 9, (Q, 2)).astype(float)], axis=1)
    return live, prop


def _ctrl(rounds_active=1, dlogz=0.01, max_accepts=2 ** 30, kills0=0,
          birth0=-1e30):
    return np.array([-1e30, 0.0, 0.0, 0.0, -1e30, 0.0, 0.0, 0.0, 1.0,
                     dlogz, np.inf, float(max_accepts), 2.0 ** 30, 1.0,
                     float(kills0), float(rounds_active), birth0, 0.0, 0.0,
                     0.0, 0.0, 2.0 ** 30])


# name: (state kwargs, rounds, mode, kind, ctrl kwargs)
CASES = {
    "thin": ({}, 1, "batch", "fixed", {}),
    "thin_plateau": ({"plateau": True}, 1, "batch", "fixed", {}),
    "below_threshold": ({"below": True}, 1, "batch", "fixed", {}),
    "two_rounds": ({}, 2, "batch", "fixed", {}),
    "one_of_two_rounds_active": ({}, 2, "batch", "fixed",
                                 {"rounds_active": 1}),
    "max_accepts_stop": ({}, 1, "batch", "fixed", {"max_accepts": 5}),
    "dlogz_stop": ({}, 1, "batch", "fixed", {"dlogz": 1e3}),
    "queue": ({"below": True}, 1, "queue", "fixed", {}),
    "replay": ({"below": True}, 1, "batch", "replay", {"kills0": 5}),
    "queue_replay": ({"below": True}, 1, "queue", "replay", {}),
    "all_neg_inf": ({"neg_inf": True}, 1, "batch", "fixed",
                    {"dlogz": -np.inf}),
    "queue_all_neg_inf": ({"neg_inf": True}, 1, "queue", "fixed",
                          {"dlogz": -np.inf}),
}


def _case(name):
    """(live, prop, rounds, mode, kind, ctrl) of a case; a replay's refills
    are born at the interrupted round's threshold."""
    kw, rounds, mode, kind, ckw = CASES[name]
    live, prop = _state(**kw)
    if kind == "replay":
        srt = np.sort(live[:, IL])
        ckw = dict(ckw, birth0=float(srt[Q - 1] if mode == "batch"
                                     else srt[0]))
    return live, prop, rounds, mode, kind, _ctrl(**ckw)


def _torch_run(live, prop, rounds, mode, kind, ctrl, device="cpu",
               dtype=torch.float64):
    def propose(gen, live_, live_blob, axes_args, scale, loglstar):
        p = axes_args["prop"]
        return (p[:, :NDIM], p[:, NDIM:IL], p[:, IL], None,
                p[:, IL + 1].to(torch.int64), (p[:, IL + 2].sum(),),
                p[:, IL + 2:IL + 4])

    fn, layout = tfused.make_fused_round(
        propose, nlive=NLIVE, ndim=NDIM, npdim=NPDIM, q=Q, dtype=dtype,
        device=device, kind=kind, rounds=rounds, mode=mode)
    flat, _, live_out, _, _, _ = fn(
        0, live_to_torch(live, device, dtype), None,
        {"prop": torch.as_tensor(prop, dtype=dtype, device=device)}, ctrl)
    return to_numpy(flat), to_numpy(live_out), layout


def _jax_run(jx, live, prop, rounds, mode, kind, ctrl):
    jax, jfused = jx
    jnp = jax.numpy

    def propose(k_sel, k_prop, live_, live_blob, axes_args, scale,
                loglstar):
        p = axes_args["prop"]
        return (p[:, :NDIM], p[:, NDIM:IL], p[:, IL], None,
                p[:, IL + 1].astype(jnp.int32), (p[:, IL + 2].sum(),),
                p[:, IL + 2:IL + 4])

    fn, layout = jfused.make_fused_round(
        propose, kind=kind, nlive=NLIVE, ndim=NDIM, npdim=NPDIM, q=Q,
        dtype=jnp.float64, rounds=rounds, mode=mode)
    flat, _, live_out, _, _, _ = fn(jax.random.key(0), jnp.asarray(live),
                                    None, {"prop": jnp.asarray(prop)},
                                    jnp.asarray(ctrl))
    return np.asarray(flat), np.asarray(live_out), layout


def _split(flat, layout):
    """The unpacked dict, and the record columns split into those compared
    exactly and the integrator's."""
    out = tfused.unpack_flat(flat, layout)
    cols = tfused.record_columns(NDIM, NPDIM)
    close = [i for i, c in enumerate(cols) if c in FLOAT_COLS]
    exact = [i for i in range(len(cols)) if i not in close]
    return out, exact, close


def _assert_same(a, b, rtol):
    """``a`` and ``b`` (flat, live, layout) agree: integer and copied parts
    bit for bit, the integrator's within ``rtol`` (0: bit for bit)."""
    (ta, exact, close), (tb, _, _) = _split(a[0], a[2]), _split(b[0], b[2])
    assert a[0].shape == b[0].shape
    np.testing.assert_array_equal(ta["records"][:, exact],
                                  tb["records"][:, exact])
    for k in ("n_accepted", "nc_used", "done", "n_consumed", "done_reason",
              "scale_final", "nc_launched"):
        assert ta[k] == tb[k], k
    for k in ("accepts", "lane_stats", "round_thresholds", "stats"):
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    np.testing.assert_array_equal(a[1], b[1])
    floats = [(ta["records"][:, close], tb["records"][:, close]),
              (ta["delta_logz"], tb["delta_logz"])]
    for k, v in ta["integ"].items():
        if isinstance(v, (bool, int)):
            assert tb["integ"][k] == v, k
        else:
            floats.append((np.asarray(v), np.asarray(tb["integ"][k])))
    for x, y in floats:
        if rtol:
            np.testing.assert_allclose(x, y, rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(x, y)
    return ta


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_consume_round_matches_jax(case, general, jx, monkeypatch):
    """Every case through ``consume_round`` on CPU tensors (one call a
    round) against the JAX package's fused round, the thin path allowed
    and forbidden."""
    if general:
        monkeypatch.setattr(jx[1], "_FORCE_GENERAL_CONSUME", True)
        monkeypatch.setattr(tfused, "_FORCE_GENERAL_CONSUME", True)
    live, prop, rounds, mode, kind, ctrl = _case(case)
    calls = cs.consume_round.calls
    t = _torch_run(live, prop, rounds, mode, kind, ctrl)
    assert cs.consume_round.calls - calls == int(ctrl[15])
    j = _jax_run(jx, live, prop, rounds, mode, kind, ctrl)
    assert t[2] == j[2]
    out = _assert_same(t, j, rtol=1e-12)
    if case.startswith(("replay", "queue_replay")):
        # the refills of a replay are born at birth0
        new = t[1][:, IL + 2] == -1.0
        assert new.any() and np.all(t[1][new, IL + 3] == ctrl[16])
    if case.endswith("all_neg_inf"):
        # a live set of -inf: max - min is NaN, never a plateau stop
        assert not out["done_reason"] & 4 and out["n_accepted"] == Q


def test_thin_and_general_agree_bitwise_on_every_unstopped_case(monkeypatch):
    """In the port, the thin scan is an exact collapse of the general one
    wherever the round does not stop."""
    for case in ("thin", "thin_plateau", "two_rounds",
                 "one_of_two_rounds_active"):
        args = _case(case)
        thin = _torch_run(*args)
        monkeypatch.setattr(tfused, "_FORCE_GENERAL_CONSUME", True)
        gen = _torch_run(*args)
        monkeypatch.setattr(tfused, "_FORCE_GENERAL_CONSUME", False)
        assert np.array_equal(thin[0], gen[0]), case
        assert np.array_equal(thin[1], gen[1]), case


# the canonical 3-D drive (every argument at its default, nlive 500) in
# both proposal modes, recorded with the consume loop inline in
# internal/fused.py before it moved to ops/consume.py: sha256 of each
# result array (float64 bytes), first 16 hex digits
CANON_KEYS = ("logl", "logvol", "logwt", "logz", "logzerr", "information",
              "samples", "samples_u", "samples_it", "samples_id", "samples_n")
CANON_RECORDED = {
    "batch": {"logl": "fd004e78c5aa04b9", "logvol": "0ce2fd3d5509a6ba",
              "logwt": "fd905b24d47ae423", "logz": "46a38797dd294a46",
              "logzerr": "d5fddd2d0730912d",
              "information": "ed272c4b655c52ad",
              "samples": "4e5bc01e6fe192c1",
              "samples_u": "2f0a6e8cbb6628ce",
              "samples_it": "69aaa3e422fe3c27",
              "samples_id": "025df07ffcae6624",
              "samples_n": "83c3e7fd9f28aedb",
              "niter": 3442, "ncall": 22075},
    "queue": {"logl": "e2e3aa8d6c9a5563", "logvol": "76388886adc6b55c",
              "logwt": "dbde17119cb951b2", "logz": "5abb03b76c108503",
              "logzerr": "b8856f4b4a9a33fb",
              "information": "67945aff6ba7b147",
              "samples": "4ce076c82cb34184",
              "samples_u": "e5ba1634faaa175d",
              "samples_it": "67eab5d577bebbf4",
              "samples_id": "48152282c4e28acf",
              "samples_n": "0bad97a68e4c5d67",
              "niter": 4675, "ncall": 24812},
}


def _canonical_digests(mode):
    import dynesty_tpu_torch as dyt

    ndim = 3
    cov = np.identity(ndim)
    cov[cov == 0] = 0.95
    cinv = torch.as_tensor(np.linalg.inv(cov))
    lnorm = -0.5 * (np.log(2 * np.pi) * ndim + np.log(np.linalg.det(cov)))
    s = dyt.NestedSampler(lambda x: -0.5 * (x @ cinv @ x) + lnorm,
                          lambda u: 10.0 * (2.0 * u - 1.0), ndim,
                          proposal_mode=mode, device="cpu",
                          rstate=get_rstate(56432))
    s.run_nested(print_progress=False)
    res = s.results
    out = {k: hashlib.sha256(np.ascontiguousarray(
        np.asarray(res[k], dtype=np.float64)).tobytes()).hexdigest()[:16]
        for k in CANON_KEYS}
    out["niter"], out["ncall"] = int(res.niter), int(s.ncall)
    return out, s


@pytest.mark.parametrize("mode", ["batch", "queue"])
def test_plain_version_equals_the_recorded_inline_loop(mode):
    """The canonical drive gives the bits it gave with the consume loop
    inline, and consumes every fused round through the wrapper."""
    calls = cs.consume_round.calls
    got, s = _canonical_digests(mode)
    assert got == CANON_RECORDED[mode]
    assert cs.consume_round.calls - calls == s.timings["n_round"] > 0
    # the CPU reads the thin-path choice once a round in batch mode
    assert s.timings["sync_round"] >= s.timings["n_round"] * (
        mode == "batch")


def _args(dtype=torch.float64, device="cpu", nlive=NLIVE, q=Q):
    z = torch.zeros((), dtype=dtype, device=device)
    i = torch.zeros((), dtype=torch.int64, device=device)
    b = torch.zeros((), dtype=torch.bool, device=device)
    st = {k: z for k in cs.FLOAT_KEYS}
    st.update({k: (b if k in cs.BOOL_KEYS else i) for k in cs.INT_KEYS})
    live = torch.arange(nlive, dtype=dtype, device=device)
    qlogl = torch.full((q,), 1e3, dtype=dtype, device=device)
    qnc = torch.ones(q, dtype=torch.int64, device=device)
    return st, live, qlogl, qnc


LIMITS = {"dlogz": 0.01, "logl_max": np.inf, "max_accepts": 2 ** 30,
          "max_nc": 2 ** 30}


def _call(st, live, qlogl, qnc, batch=True, thin=None):
    return cs.consume_round(st, live, qlogl, qnc, LIMITS, batch=batch,
                            dlv_default=0.01, thin=thin)


def test_wrapper_checks_raise():
    st, live, qlogl, qnc = _args()
    with pytest.raises(TypeError, match="float64 or float32"):
        _call(st, live.half(), qlogl, qnc)
    with pytest.raises(TypeError, match="qlogl must be torch.float64"):
        _call(st, live, qlogl.float(), qnc)
    with pytest.raises(TypeError, match="qnc must be torch.int64"):
        _call(st, live, qlogl, qnc.int())
    with pytest.raises(ValueError, match="nlive=16, q=16"):
        _call(st, live[:Q], qlogl, qnc)
    with pytest.raises(ValueError, match="q=0"):
        _call(st, live, qlogl[:0], qnc[:0])
    with pytest.raises(ValueError, match="contiguous"):
        _call(st, torch.stack([live, live], 1)[:, 0], qlogl, qnc)
    with pytest.raises(ValueError, match="qnc must have shape"):
        _call(st, live, qlogl, qnc[:-1])
    with pytest.raises(TypeError, match="n_acc must be torch.int64"):
        _call(dict(st, n_acc=st["n_acc"].double()), live, qlogl, qnc)
    with pytest.raises(TypeError, match="done must be torch.bool"):
        _call(dict(st, done=st["reason"]), live, qlogl, qnc)
    with pytest.raises(ValueError, match="sorted_logl must have shape"):
        _call(st, live, qlogl, qnc,
              thin=(torch.arange(NLIVE), live[:-1], True))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        _call(*_args(device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cs.integrator_step(*[live] * 7)
    # the CPU takes the plain version and leaves the caller's state alone
    before = {k: v.clone() for k, v in st.items()}
    outs, new = _call(st, live, qlogl, qnc)
    assert [c.shape for c in outs] == [(Q,)] * 12
    assert new is not st and all(torch.equal(st[k], before[k]) for k in st)


def test_source_names_the_jax_code_it_replaces():
    src = (build.SRC_DIR / "consume_scan.cu").read_text()
    for ref in ("dynesty_tpu/internal/fused.py:212", ":333", ":423",
                "lax.scan", "sm_90a", "latency", "shared memory"):
        assert ref in src, ref
    # every product and sum rounds on its own, as torch's eager ops do
    assert "__dmul_rn" in src and "__dadd_rn" in src and "FMA" in src
    assert "consume_scan" in cs.__doc__


# --------------------------------------------------------------------------
# on the card: the kernel against the plain version on the same tensors


def _card_run(case, plain, force_general=False, dtype=torch.float64):
    args = _case(case)
    saved = tfused.consume_round, tfused._FORCE_GENERAL_CONSUME
    if plain:
        tfused.consume_round = cs.consume_round_plain
    tfused._FORCE_GENERAL_CONSUME = force_general
    try:
        out = _torch_run(*args, device="cuda", dtype=dtype)
    finally:
        tfused.consume_round, tfused._FORCE_GENERAL_CONSUME = saved
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_the_card(case, cuda):
    launches = cs.consume_round.launches
    got = _card_run(case, plain=False)
    rounds = int(_case(case)[5][15])
    assert cs.consume_round.launches - launches == rounds
    _assert_same(got, _card_run(case, plain=True), rtol=0)
    gen = _card_run(case, plain=False, force_general=True)
    _assert_same(gen, _card_run(case, plain=True, force_general=True),
                 rtol=0)
    if "stop" not in case:
        # thin and general agree bit for bit on the card as on the CPU
        assert np.array_equal(gen[0], got[0], equal_nan=True) and \
            np.array_equal(gen[1], got[1], equal_nan=True)


@pytest.mark.cuda
def test_kernel_float32_matches_plain_on_the_card(cuda):
    for case in ("thin", "below_threshold", "queue"):
        _assert_same(_card_run(case, False, dtype=torch.float32),
                     _card_run(case, True, dtype=torch.float32), rtol=0)


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    for case in ("thin_plateau", "below_threshold", "queue"):
        a, b = _card_run(case, False), _card_run(case, False)
        assert np.array_equal(a[0], b[0], equal_nan=True) and \
            np.array_equal(a[1], b[1], equal_nan=True)


@pytest.mark.cuda
def test_cuda_consume_without_build_raises(cuda, monkeypatch):
    monkeypatch.setenv("DYNESTY_TPU_TORCH_NO_BUILD", "1")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(cs, "_ENTRY", {})
    launches = cs.consume_round.launches
    with pytest.raises(RuntimeError, match="disabled"):
        _call(*_args(device=cuda))
    assert cs.consume_round.launches == launches


@pytest.mark.cuda
def test_a_card_run_never_takes_the_plain_loop(cuda, monkeypatch):
    """A whole run on the card consumes every round through the kernel:
    the plain version never sees a CUDA tensor, and the launches, split
    by path on the device, equal the rounds."""
    import dynesty_tpu_torch as dyt

    plain = cs.consume_round_plain

    def guarded(st, live_logl, *a, **kw):
        assert live_logl.device.type == "cpu", "plain loop on the card"
        return plain(st, live_logl, *a, **kw)

    monkeypatch.setattr(cs, "consume_round_plain", guarded)
    cs.zero_counts()
    s = dyt.NestedSampler(lambda x: -0.5 * (x @ x),
                          lambda u: 10.0 * (2.0 * u - 1.0), 3, nlive=200,
                          bound="single", sample="rslice", queue_size=32,
                          rstate=get_rstate())
    s.run_nested(print_progress=False, dlogz=0.5)
    paths = cs.path_counts()
    assert cs.consume_round.launches == s.timings["n_round"] > 0
    assert paths["thin"] + paths["general"] == s.timings["n_round"]
