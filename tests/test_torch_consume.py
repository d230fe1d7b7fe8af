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

The cases include the seams of the kernel's stages: stops by ``max_nc``
and ``logl_max`` mid-round, a plateau that first appears mid-round, a
state that enters the round in plateau mode, a NaN live logl, q = 1 and
a round of two chunks (q = 300); on the card also float32 at the main
width, a live set past the kernel's shared memory and the layout's
boundary, and the kernel's chain probe.  The wrapper's shared-memory
layout is a pure function, tested on the CPU.

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

from torch_rounds import WholeRound
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


def _state(plateau=False, below=False, neg_inf=False, seed=None,
           nlive=NLIVE, q=Q, tie_at=None, nan_at=None):
    """Live matrix (u | v | logl | it | bound | birth) and a proposal block
    (u | v | logl | nc | 2 lane stats) above the round threshold.
    ``tie_at``: three live points tied at the ``tie_at``-th smallest logl
    (a plateau that first appears at that kill); ``nan_at``: a NaN logl at
    that row."""
    rs = get_rstate(seed)
    logl = rs.normal(size=nlive) * 2.0
    if plateau:
        logl = np.round(logl)  # ties everywhere, into the kill set
    if neg_inf:
        logl[:] = -np.inf
    if tie_at is not None:
        order = np.argsort(logl)
        logl[order[tie_at:tie_at + 3]] = logl[order[tie_at]]
    u = rs.random((nlive, NDIM))
    live = np.concatenate([
        u, 10.0 * u, logl[:, None],
        rs.integers(0, 50, nlive)[:, None].astype(float),
        np.zeros((nlive, 1)), np.full((nlive, 1), -1e30)], axis=1)
    srt = np.sort(logl)
    if neg_inf:
        thr = -1e30
    elif srt[q - 1] < srt[-1]:
        thr = srt[q - 1]
    else:
        thr = srt[srt < srt[-1]][-1]
    qlogl = thr + np.abs(rs.normal(size=q)) * 3.0 + 1e-3
    if below:
        qlogl[5 % q] = thr - 1.0  # one proposal under the threshold
    if nan_at is not None:
        live[nan_at, IL] = np.nan
    qu = rs.random((q, NDIM))
    prop = np.concatenate([qu, 10.0 * qu, qlogl[:, None],
                           rs.integers(1, 30, q)[:, None].astype(float),
                           rs.integers(0, 9, (q, 2)).astype(float)], axis=1)
    return live, prop


def _ctrl(rounds_active=1, dlogz=0.01, max_accepts=2 ** 30, kills0=0,
          birth0=-1e30, max_nc=2 ** 30, logl_max=np.inf, plateau=None):
    """The control vector; ``plateau``: (counter, logdvol) of a state that
    enters the round in plateau mode."""
    pmode, pc, pld = (0.0, 0.0, 0.0) if plateau is None else \
        (1.0, float(plateau[0]), float(plateau[1]))
    return np.array([-1e30, 0.0, 0.0, 0.0, -1e30, pmode, pc, pld, 1.0,
                     dlogz, logl_max, float(max_accepts), float(max_nc),
                     1.0, float(kills0), float(rounds_active), birth0, 0.0,
                     0.0, 0.0, 0.0, 2.0 ** 30])


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
    # the seams of the kernel's stages: stops the selection finds
    # mid-round, plateaus met by the chain, NaN, and ragged widths
    "max_nc_stop": ({}, 1, "batch", "fixed", {"max_nc": 100}),
    "logl_max_stop": ({}, 1, "batch", "fixed", {"logl_max": "mid"}),
    "queue_max_nc_stop": ({"below": True}, 1, "queue", "fixed",
                          {"max_nc": 100}),
    "plateau_at_step": ({"tie_at": Q // 2}, 1, "batch", "fixed", {}),
    "queue_plateau_at_step": ({"tie_at": Q // 2}, 1, "queue", "fixed", {}),
    "enters_in_plateau": ({}, 1, "batch", "fixed",
                          {"plateau": (3, -np.log(NLIVE + 1.0) - 0.5)}),
    "queue_enters_in_plateau": ({}, 1, "queue", "fixed",
                                {"plateau": (3, -np.log(NLIVE + 1.0) - 0.5)}),
    "nan_live": ({"nan_at": 3}, 1, "batch", "fixed", {}),
    "queue_nan_live": ({"nan_at": 3}, 1, "queue", "fixed", {}),
    "q1": ({"q": 1}, 1, "batch", "fixed", {}),
    "queue_q1": ({"q": 1, "below": True}, 1, "queue", "fixed", {}),
    "q37": ({"nlive": 100, "q": 37, "below": True}, 1, "batch", "fixed",
            {}),
    "two_chunks": ({"nlive": 700, "q": 300}, 1, "batch", "fixed", {}),
    "queue_two_chunks_stop": ({"nlive": 700, "q": 300, "below": True}, 1,
                              "queue", "fixed", {"max_nc": 4000}),
}


def _case(name):
    """(live, prop, rounds, mode, kind, ctrl) of a case; a replay's refills
    are born at the interrupted round's threshold."""
    kw, rounds, mode, kind, ckw = CASES[name]
    live, prop = _state(**kw)
    q = prop.shape[0]
    srt = np.sort(live[:, IL])
    if kind == "replay":
        ckw = dict(ckw, birth0=float(srt[q - 1] if mode == "batch"
                                     else srt[0]))
    if ckw.get("logl_max") == "mid":
        # loglstar passes the middle victim's logl after the middle kill
        ckw = dict(ckw, logl_max=float(srt[q // 2]))
    return live, prop, rounds, mode, kind, _ctrl(**ckw)


def _torch_run(live, prop, rounds, mode, kind, ctrl, device="cpu",
               dtype=torch.float64):
    def propose(gen, live_, live_blob, axes_args, scale, loglstar):
        p = axes_args["prop"]
        return (p[:, :NDIM], p[:, NDIM:IL], p[:, IL], None,
                p[:, IL + 1].to(torch.int64), (p[:, IL + 2].sum(),),
                p[:, IL + 2:IL + 4])

    fn, layout = tfused.make_fused_round(
        WholeRound(propose), nlive=live.shape[0], ndim=NDIM, npdim=NPDIM,
        q=prop.shape[0], dtype=dtype, device=device, kind=kind,
        rounds=rounds, mode=mode)
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
        propose, kind=kind, nlive=live.shape[0], ndim=NDIM, npdim=NPDIM,
        q=prop.shape[0], dtype=jnp.float64, rounds=rounds, mode=mode)
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


def test_shared_memory_layout_is_a_pure_function_of_the_shape():
    """The wrapper's byte count of the kernel's dynamic shared memory:
    the chunk, the segments' partials and, where they fit, the live logl
    and occupant; the kernel carves the same layout."""
    src = (build.SRC_DIR / "consume_scan.cu").read_text()
    assert f"CHUNK = {cs.BLOCK};" in src
    assert "(CHUNK + 1) * (2 * 8 + 18 * sizeof(T) + 3 * 4 + 2)" in src
    for dtype, fsize in ((torch.float64, 8), (torch.float32, 4)):
        step = 2 * 8 + 18 * fsize + 3 * 4 + 2
        chunk = -(-(cs.BLOCK + 1) * step // 16) * 16
        for nlive in (1, 2, 64, 1000, 2048, 3000, 16384, 10 ** 6, 2 ** 31 - 1):
            lay = cs.smem_layout(nlive, dtype)
            assert lay == cs.smem_layout(nlive, dtype)
            seg, nseg = lay["seg"], lay["nseg"]
            assert seg % 32 == 0 and nseg == -(-nlive // seg) <= 32
            # the shortest such segment: one 32 shorter needs more than 32
            assert seg == 32 or (seg - 32) * 32 < nlive
            base = chunk + nseg * 16
            live = nlive * (fsize + 4)
            assert lay["resident"] == (base + live <= cs.SMEM_MAX)
            assert lay["bytes"] == base + live * lay["resident"] <= \
                cs.SMEM_MAX
        limit = cs.resident_limit(dtype)
        assert cs.smem_layout(limit, dtype)["resident"]
        assert not cs.smem_layout(limit + 1, dtype)["resident"]
    assert cs.smem_layout(2048, torch.float64) == {
        "bytes": 69808, "resident": True, "seg": 64, "nseg": 32}
    assert cs.resident_limit(torch.float64) < 16384 < \
        cs.resident_limit(torch.float32)


def test_chain_probe_plain_and_checks():
    gen = np.random.Generator(np.random.PCG64(1))
    logwt = torch.as_tensor(gen.normal(size=256) * 3.0 - 8.0)
    logz0 = torch.tensor(-1e30, dtype=torch.float64)
    ref = -1e30
    for w in logwt.tolist():
        ref = np.logaddexp(ref, w)
    got = cs.chain_probe_plain(logwt, logz0)
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(got.item(), ref, rtol=1e-14)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cs.chain_probe(logwt, logz0)


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
    """A case (a name of :data:`CASES`, or its ``_case`` tuple) through the
    kernel, or with ``plain`` through the plain loop, on the card."""
    args = _case(case) if isinstance(case, str) else case
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


def _wide(nlive, q, mode, **kw):
    """A fixed round of ``q`` proposals over ``nlive`` live points."""
    live, prop = _state(nlive=nlive, q=q, **kw)
    return live, prop, 1, mode, "fixed", _ctrl()


@pytest.mark.cuda
@pytest.mark.parametrize("general", [False, True])
def test_kernel_float32_at_the_main_width(general, cuda):
    """float32 at (2048, 256): the thin path, and the general path with
    the thin path forbidden."""
    args = _wide(2048, 256, "batch")
    _assert_same(_card_run(args, False, general, torch.float32),
                 _card_run(args, True, general, torch.float32), rtol=0)


@pytest.mark.cuda
def test_kernel_general_past_the_shared_memory_limit(cuda):
    """(16384, 256) float64 in queue mode: the live logl stays in global
    memory, bit for bit all the same."""
    assert not cs.smem_layout(16384, torch.float64)["resident"]
    args = _wide(16384, 256, "queue", below=True)
    _assert_same(_card_run(args, False), _card_run(args, True), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("past", [False, True])
def test_kernel_layout_switch_at_its_boundary(past, cuda):
    """The general path at the largest resident live set and one point
    past it: shared and global memory, both the plain loop's bits."""
    nlive = cs.resident_limit(torch.float64) + past
    assert cs.smem_layout(nlive, torch.float64)["resident"] is not past
    args = _wide(nlive, 64, "queue", below=True)
    _assert_same(_card_run(args, False), _card_run(args, True), rtol=0)


@pytest.mark.cuda
def test_chain_probe_matches_its_plain_loop(cuda):
    gen = np.random.Generator(np.random.PCG64(1))
    for dtype in (torch.float64, torch.float32):
        logwt = torch.as_tensor(gen.normal(size=256) * 3.0 - 8.0,
                                dtype=dtype, device=cuda)
        logz0 = torch.tensor(-1e30, dtype=dtype, device=cuda)
        for q, reps in ((1, 1), (256, 1), (256, 3)):
            got = cs.chain_probe(logwt[:q], logz0, reps)
            assert torch.equal(got, cs.chain_probe_plain(logwt[:q], logz0))


@pytest.mark.cuda
@pytest.mark.parametrize("general", [False, True])
def test_stage_clocks_trace_a_round_and_change_nothing(general, cuda,
                                                       monkeypatch):
    """With ``STAGE_CLOCKS`` set, a launch stamps each stage of its first
    chunk in order, and its results are those of a launch without."""
    args = _wide(2048, 256, "batch")
    ref = _card_run(args, False, general)
    clocks = torch.zeros(len(cs.STAGES), dtype=torch.int64, device=cuda)
    monkeypatch.setattr(cs, "STAGE_CLOCKS", clocks)
    got = _card_run(args, False, general)
    _assert_same(got, ref, rtol=0)
    stamp = clocks.tolist()
    assert all(a < b for a, b in zip(stamp, stamp[1:])), \
        dict(zip(cs.STAGES, stamp))


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
