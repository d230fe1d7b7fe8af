"""The fused round outside its proposal loop (``dynesty_tpu_torch/
internal/fused.py``: the prologue, the epilogue and the round gate on the
device; ``dynesty_tpu_torch/ops/consume.py``: ``round_assemble`` and its
plain version).

On the CPU: the record and live assembly against the JAX package's
``one_round`` on the same live matrix and fixed proposal block (batch
thin, batch general, queue and replay rounds, and a queue round whose
every entry is accepted into one slot, with and without blobs); the
kernels' scratch mark from ``assemble_buffers``, the wrapper's checks on
it and the plain version leaving it alone;
a round that the device gate turns off; and whole dispatches of the
rslice (stepping-out and doubling), unif and rwalk samplers with the
gate on the device against the same dispatches with the gate read on
the host before every round (the round as it ran before).  On a card
(``cuda``-marked, skipped here): the kernels against
``round_assemble_plain`` bit for bit, also over three rounds on one set
of buffers (one with no accept, one with every accept into one slot,
at (2048, 256), (16384, 256) and q = 1) eagerly and replayed from a
captured graph, and a captured round against the eager round, the
generator's offset included.

Tolerances: copied and integer columns bit for bit; the integrator
columns (logvol, logwt, logz, logzvar, h, delta_logz) against the JAX
package within 1e-12 relative (XLA's and torch's exp, log1p and
logaddexp differ by an ulp at some inputs, as in
``tests/test_torch_fused.py``).  Within the port everything is bit for
bit.

The JAX package is imported by a fixture, and its comparison runs only
under ``tests/conftest.py`` (JAX on the CPU in float64); on the card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_round_graph.py
"""

import numpy as np
import pytest
import torch

import dynesty_tpu_torch.internal.fused as tfused
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
    """jax.numpy and the JAX package's fused module."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("the JAX comparisons run under tests/conftest.py "
                    "(JAX on the CPU in float64)")
    import jax.numpy as jnp

    import dynesty_tpu.internal.fused as jfused
    return jax, jnp, jfused


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(seed=5, nlive=NLIVE, q=Q, below=False):
    """A live matrix (u | v | logl | it | bound | birth) with its blob,
    and a proposal block (u | v | logl | nc | 2 lane stats) above the
    round's threshold with its blob, made with numpy from ``seed``."""
    rs = get_rstate(seed)
    logl = rs.normal(size=nlive) * 2.0
    u = rs.random((nlive, NDIM))
    live = np.concatenate([
        u, 10.0 * u, logl[:, None],
        rs.integers(0, 50, nlive)[:, None].astype(float),
        rs.integers(-1, 3, nlive)[:, None].astype(float),
        rs.normal(size=(nlive, 1)) - 5.0], axis=1)
    srt = np.sort(logl)
    qlogl = srt[q - 1] + np.abs(rs.normal(size=q)) * 3.0 + 1e-3
    if below == "chain":
        # each proposal just above the one before, all below the second
        # lowest live point: in queue mode every entry kills the slot that
        # the entry before it refilled
        qlogl = srt[0] + (srt[1] - srt[0]) * np.arange(1, q + 1) / (q + 1)
    elif below:
        qlogl[q // 3] = srt[q - 1] - 1.0
    qu = rs.random((q, NDIM))
    prop = np.concatenate([qu, 10.0 * qu, qlogl[:, None],
                           rs.integers(1, 30, q)[:, None].astype(float),
                           rs.integers(0, 9, (q, 2)).astype(float)], axis=1)
    live_blob = rs.normal(size=(nlive, 2))
    prop_blob = rs.normal(size=(q, 2))
    return live, prop, live_blob, prop_blob


def _ctrl(rounds_active=1, max_accepts=2 ** 30, kills0=0, birth0=-1e30):
    return np.array([-1e30, 0.0, 0.0, 0.0, -1e30, 0.0, 0.0, 0.0, 1.0,
                     0.01, np.inf, float(max_accepts), 2.0 ** 30, 1.0,
                     float(kills0), float(rounds_active), birth0, 0.0,
                     0.0, 0.0, 0.0, 2.0 ** 30])


# the cases: (kind, mode, forced general, proposals below the threshold,
# ctrl kwargs)
CASES = {
    "batch_thin": ("fixed", "batch", False, False, {}),
    "batch_general": ("fixed", "batch", True, True, {}),
    "queue": ("fixed", "queue", False, False, {}),
    "replay": ("replay", "batch", False, False,
               {"kills0": 3, "birth0": -2.5}),
    # every accepted entry into one slot, each record from the proposal
    # the entry before it placed there
    "queue_chain": ("fixed", "queue", False, "chain", {}),
}


def _torch_run(live, prop, live_blob, prop_blob, kind, mode, ctrl):
    def propose(gen, live_, blob_, axes_args, scale, loglstar):
        p = axes_args["prop"]
        return (p[:, :NDIM], p[:, NDIM:IL], p[:, IL],
                axes_args.get("prop_blob"), p[:, IL + 1].to(torch.int64),
                (p[:, IL + 2].sum(),), p[:, IL + 2:IL + 4])

    fn, layout = tfused.make_fused_round(
        WholeRound(propose), kind=kind, nlive=NLIVE, ndim=NDIM,
        npdim=NPDIM, q=Q, dtype=torch.float64, device="cpu", mode=mode)
    axes = {"prop": torch.from_numpy(prop)}
    if prop_blob is not None:
        axes["prop_blob"] = torch.from_numpy(prop_blob)
    out = fn(0, live_to_torch(live, "cpu"),
             None if live_blob is None else torch.from_numpy(live_blob),
             axes, ctrl)
    return [to_numpy(x) for x in out], layout


def _jax_run(jx, live, prop, live_blob, prop_blob, kind, mode, ctrl):
    jax, jnp, jfused = jx

    def propose(k_sel, k_prop, live_, blob_, axes_args, scale, loglstar):
        p = axes_args["prop"]
        return (p[:, :NDIM], p[:, NDIM:IL], p[:, IL],
                axes_args.get("prop_blob"), p[:, IL + 1].astype(jnp.int32),
                (p[:, IL + 2].sum(),), p[:, IL + 2:IL + 4])

    fn, layout = jfused.make_fused_round(
        propose, kind=kind, nlive=NLIVE, ndim=NDIM, npdim=NPDIM, q=Q,
        dtype=jnp.float64, mode=mode, blob=live_blob is not None)
    axes = {"prop": jnp.asarray(prop)}
    if prop_blob is not None:
        axes["prop_blob"] = jnp.asarray(prop_blob)
    out = fn(jax.random.key(0), jnp.asarray(live),
             None if live_blob is None else jnp.asarray(live_blob), axes,
             jnp.asarray(ctrl))
    return [None if x is None else np.asarray(x) for x in out], layout


@pytest.mark.parametrize("blob", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_assembly_matches_the_jax_one_round(jx, case, blob, monkeypatch):
    """The port's round (the consume scan's plain loop, then
    ``round_assemble`` on the CPU: ``round_assemble_plain``) against the
    JAX package's ``one_round`` on the same live matrix, proposal block
    and blobs."""
    kind, mode, general, below, ckw = CASES[case]
    if general:
        monkeypatch.setattr(tfused, "_FORCE_GENERAL_CONSUME", True)
        monkeypatch.setattr(jx[2], "_FORCE_GENERAL_CONSUME", True)
    live, prop, live_blob, prop_blob = _state(below=below)
    if not blob:
        live_blob = prop_blob = None
    ctrl = _ctrl(**ckw)
    t, layout = _torch_run(live, prop, live_blob, prop_blob, kind, mode,
                           ctrl)
    j, jlayout = _jax_run(jx, live, prop, live_blob, prop_blob, kind, mode,
                          ctrl)
    assert layout == jlayout
    tf, jf = tfused.unpack_flat(t[0], layout), \
        jx[2].unpack_flat(j[0], layout)
    cols = tfused.record_columns(NDIM, NPDIM)
    exact = [i for i, c in enumerate(cols) if c not in FLOAT_COLS]
    close = [i for i in range(len(cols)) if i not in exact]
    assert np.array_equal(tf["records"][:, exact], jf["records"][:, exact])
    np.testing.assert_allclose(tf["records"][:, close],
                               jf["records"][:, close], rtol=1e-12, atol=0)
    for k in ("accepts", "lane_stats", "round_thresholds", "stats"):
        assert np.array_equal(tf[k], jf[k]), k
    for k in ("n_accepted", "nc_used", "done", "n_consumed", "done_reason",
              "nc_launched"):
        assert tf[k] == jf[k], k
    # the proposals block and the refilled live matrix are copies
    assert np.array_equal(t[1], j[1])
    assert np.array_equal(t[2], j[2])
    if blob:
        for a, b in zip(t[3:], j[3:]):
            assert np.array_equal(a, b)
    if case == "replay":
        # refills born at birth0, kills counted from kills0
        refilled = t[2][:, IL + 3] == -2.5
        assert refilled.any()
    assert tf["n_accepted"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_assembly_is_the_records_of_the_round(case, monkeypatch):
    """``round_assemble_plain`` on the consume scan's columns gives the
    round's records, proposals block and live matrix bit for bit, and
    ``last`` names each slot's refill."""
    kind, mode, general, below, ckw = CASES[case]
    monkeypatch.setattr(tfused, "_FORCE_GENERAL_CONSUME", general)
    live, prop, _, _ = _state(below=below)
    ctrl = _ctrl(**ckw)
    t, layout = _torch_run(live, prop, None, None, kind, mode, ctrl)
    live_t = live_to_torch(live, "cpu")
    prop_t = torch.from_numpy(prop)
    st = {k: torch.zeros((), dtype=torch.float64) for k in cs.FLOAT_KEYS}
    st.update({k: torch.zeros((), dtype=torch.bool if k in cs.BOOL_KEYS
                              else torch.int64) for k in cs.INT_KEYS})
    st["logz"] = st["loglstar"] = torch.tensor(-1e30, dtype=torch.float64)
    st["racc"] = torch.tensor(ckw.get("kills0", 0))
    logl0 = live_t[:, IL].contiguous()
    sorted_logl, sort_idx = torch.sort(logl0, stable=True)
    thin = None
    if mode == "batch" and kind != "replay" and not general:
        thin = (sort_idx, sorted_logl, bool(
            (sorted_logl[Q - 1] < sorted_logl[-1]) &
            (prop_t[:, IL].min() > sorted_logl[Q - 1])))
    limits = {"dlogz": 0.01, "logl_max": np.inf, "max_accepts": 2 ** 30,
              "max_nc": 2 ** 30}
    outs, _ = cs.consume_round_plain(
        st, logl0, prop_t[:, IL].contiguous(),
        prop_t[:, IL + 1].to(torch.int64), limits, batch=mode == "batch",
        dlv_default=float(np.log1p(1.0 / NLIVE)), thin=thin)
    birth = torch.tensor(ckw.get("birth0", 0.0), dtype=torch.float64) \
        if kind == "replay" else sorted_logl[Q - 1] if mode == "batch" \
        else logl0.min()
    recs, props, live_out, last = cs.round_assemble_plain(
        outs, live_t, prop_t[:, :NDIM], prop_t[:, NDIM:IL], prop_t[:, IL],
        prop_t[:, IL + 1].to(torch.int64), prop_t[:, IL + 2:],
        torch.tensor(int(ctrl[8])), birth)
    f = tfused.unpack_flat(t[0], layout)
    assert np.array_equal(recs.numpy(), f["records"])
    assert np.array_equal(props.numpy(), t[1])
    assert np.array_equal(live_out.numpy(), t[2])
    acc = outs[2].numpy()
    for s in range(NLIVE):
        hit = np.nonzero(acc & (outs[0].numpy() == s))[0]
        assert last[s] == (hit[-1] if len(hit) else -1)
    if below == "chain":
        # several accepts into one slot, records taken from the proposals
        assert np.bincount(outs[0].numpy()[acc]).max() > 1
        assert (outs[1] >= 0).sum() > 1


def test_assembly_refuses_what_no_kernel_takes():
    live, prop, _, _ = _state()
    live_t = live_to_torch(live, "cpu")
    prop_t = torch.from_numpy(prop)
    outs = [torch.zeros(Q, dtype=torch.int64)] * 2 + \
        [torch.zeros(Q, dtype=torch.bool)] + \
        [torch.zeros(Q, dtype=torch.float64)] * 6 + \
        [torch.zeros(Q, dtype=torch.int64)] + \
        [torch.zeros(Q, dtype=torch.float64)] * 2
    out = cs.assemble_buffers(1, Q, NLIVE, NDIM, NPDIM, torch.float64, "cpu")
    args = (live_t, prop_t, prop_t[:, IL + 1].to(torch.int64),
            prop_t[:, IL + 2:], torch.tensor(0),
            torch.tensor(0.0, dtype=torch.float64),
            torch.tensor(0.0, dtype=torch.float64), out)
    cs.round_assemble(outs, *args, ndim=NDIM)
    with pytest.raises(ValueError, match="unit column stride"):
        cs.round_assemble(outs, live_t, prop_t.t().contiguous().t(),
                          *args[2:], ndim=NDIM)
    with pytest.raises(TypeError, match="int64"):
        cs.round_assemble(outs[:1] + [outs[2]] + outs[2:], *args,
                          ndim=NDIM)
    bad = dict(out, recs=out["recs"][:, :-1])
    with pytest.raises(ValueError, match="recs"):
        cs.round_assemble(outs, *args[:-1], bad, ndim=NDIM)


def test_assembly_buffers_hold_the_kernels_zeroed_mark():
    """``assemble_buffers`` makes the kernels' scratch mark, an int32 a
    live slot, zeroed; zeroing every output once a dispatch keeps it."""
    out = cs.assemble_buffers(2, Q, NLIVE, NDIM, NPDIM, torch.float64,
                              "cpu")
    mark = out["mark"]
    assert mark.dtype == torch.int32 and tuple(mark.shape) == (NLIVE,)
    assert mark.is_contiguous() and not mark.any()


@pytest.mark.parametrize("bad,err", [("missing", TypeError),
                                     ("short", ValueError),
                                     ("int64", TypeError),
                                     ("strided", ValueError)])
def test_assembly_refuses_a_mark_the_kernels_cannot_use(bad, err):
    outs, live, qrows = _card_state("cpu", NLIVE, Q, torch.float64)
    out = cs.assemble_buffers(1, Q, NLIVE, NDIM, NPDIM, torch.float64,
                              "cpu")
    if bad == "missing":
        del out["mark"]
    else:
        out["mark"] = {
            "short": torch.zeros(NLIVE - 1, dtype=torch.int32),
            "int64": torch.zeros(NLIVE, dtype=torch.int64),
            "strided": torch.zeros(2 * NLIVE, dtype=torch.int32)[::2]}[bad]
    with pytest.raises(err, match="mark"):
        cs.round_assemble(outs, live, qrows,
                          qrows[:, IL + 1].to(torch.int64), qrows[:, IL + 2:],
                          torch.tensor(0), torch.tensor(0.0,
                                                        dtype=torch.float64),
                          torch.tensor(0.0, dtype=torch.float64), out,
                          ndim=NDIM)


def test_the_plain_assembly_leaves_the_mark_as_it_found_it():
    """On the CPU ``round_assemble`` runs the plain version, which never
    reads or writes the kernels' mark, whatever it holds."""
    outs, live, qrows = _card_state("cpu", NLIVE, Q, torch.float64)
    out = cs.assemble_buffers(1, Q, NLIVE, NDIM, NPDIM, torch.float64,
                              "cpu")
    pattern = torch.arange(NLIVE, dtype=torch.int32) * 7 - 100
    out["mark"].copy_(pattern)
    lv = live.clone()
    cs.round_assemble(outs, lv, qrows, qrows[:, IL + 1].to(torch.int64),
                      qrows[:, IL + 2:], torch.tensor(5),
                      torch.tensor(-1.0, dtype=torch.float64),
                      torch.tensor(0.5, dtype=torch.float64), out,
                      ndim=NDIM)
    assert torch.equal(out["mark"], pattern)
    assert (out["last"] >= 0).any() and not torch.equal(lv, live)


def test_source_names_the_jax_code_it_replaces():
    from pathlib import Path
    src = (Path(cs.__file__).parent.parent / "csrc" /
           "round_assemble.cu").read_text()
    assert "dynesty_tpu/internal/fused.py:146" in src
    assert "cudaGetLastError" in src and "sm_90a" in src


# --------------------------------------------------------------------------
# whole dispatches: the gate on the device against the gate on the host


def _sampler(sample, bound, blob=False, walks=None):
    """A small run on the CPU whose live set and bound a dispatch takes
    on."""
    import dynesty_tpu_torch as dyt

    def ll(x):
        logl = -0.5 * (x @ x)
        return (logl, torch.stack([logl, x[0]])) if blob else logl

    kw = {"walks": walks} if walks else {}
    if sample == "doubling":
        sample = dyt.internal.samplers.RSliceSampler(slice_doubling=True)
    s = dyt.NestedSampler(ll, lambda u: 10.0 * (2.0 * u - 1.0), 3,
                          nlive=96, bound=bound, sample=sample,
                          queue_size=24, device="cpu", blob=blob,
                          rstate=get_rstate(7), **kw)
    s.run_nested(print_progress=False, maxiter=600, add_live=False)
    return s


def _dispatch(s, rounds, ctrl, plain):
    """One dispatch of ``rounds`` rounds of the sampler's next kernel:
    its proposer with the gate on the device, or (``plain``) the same
    proposer run whole with the gate read on the host before each
    round.  Returns the outputs, the layout and what the dispatch counted
    in the sampler's ``Timings``."""
    sampler = s.internal_sampler
    kind = s.device_bound_kind()
    prop = sampler._build_propose_fn(s, kind)
    il = sampler.ndim + s.loglikelihood.npdim
    if plain:
        inner = prop

        def whole(gen, live, live_blob, axes_args, scale, loglstar):
            inner.prepare(live, axes_args)
            inner.begin(gen, live, live_blob, axes_args, scale, loglstar,
                        None)
            assert not inner.loop(gen)
            packed, qblob, qnc, stats, lane = inner.finish(axes_args)
            return (packed[:, :sampler.ndim], packed[:, sampler.ndim:il],
                    packed[:, il], qblob, qnc, stats, lane)

        prop = WholeRound(whole)
    fn, layout = tfused.make_fused_round(
        prop, nlive=s.nlive, ndim=sampler.ndim,
        npdim=s.loglikelihood.npdim, q=s.queue_size, dtype=s.dtype,
        device="cpu", kind=sampler.name, rounds=rounds,
        tune_fn=sampler.device_tune_fn(), mode=s.proposal_mode,
        chain_stop_fn=sampler.device_chain_stop_fn(), timings=s.timings)
    live = live_to_torch(s._live_packed(), "cpu", s.dtype,
                         ndim=sampler.ndim, npdim=s.loglikelihood.npdim)
    blob = None if s.live_blobs is None else torch.as_tensor(
        np.asarray(s.live_blobs))
    before = dict(s.timings)
    out = fn(99, live, blob, s.device_bound_arrays(), ctrl)
    counted = {k: v - before.get(k, 0) for k, v in s.timings.items()
               if isinstance(v, int)}
    return [None if x is None else to_numpy(x) for x in out], layout, \
        counted


@pytest.mark.parametrize("sample,bound,blob", [
    ("rslice", "balls", True), ("rslice", "single", False),
    ("doubling", "single", True), ("unif", "multi", False),
    ("unif", "single", True), ("rwalk", "single", False)])
def test_a_dispatch_with_the_device_gate_equals_the_host_gate(sample, bound,
                                                              blob):
    """Four rounds, the run stopped by ``max_accepts`` in the second: the
    third round starts behind the gate and the fourth is skipped.  The
    records, the live set, the blobs and the info equal the dispatch whose
    host read the gate before every round; the gate on the device costs
    one read (``sync_round``), the walk's gate its read a round."""
    s = _sampler(sample, bound, blob=blob, walks=6)
    ctrl = _ctrl(rounds_active=4, max_accepts=s.queue_size + 7)
    ctrl[18] = float(s.ncall)
    got, layout, t_dev = _dispatch(s, 4, ctrl, False)
    ref, _, t_host = _dispatch(s, 4, ctrl, True)
    for a, b in zip(got, ref):
        assert (a is None and b is None) or np.array_equal(a, b)
    f = tfused.unpack_flat(got[0], layout)
    assert f["done"] and f["n_accepted"] == s.queue_size + 7
    q = s.queue_size
    # the rounds behind the gate: zeros, no evaluation billed
    assert not f["records"][2 * q:].any() and not got[1][2 * q:].any()
    assert not f["round_thresholds"][2:].any()
    il = 3 + s.loglikelihood.npdim
    assert f["nc_launched"] == got[1][:2 * q, il + 1].sum()
    assert t_dev["n_round"] == t_host["n_round"] == 2
    # on the CPU each batch round also reads its thin-path choice
    thin = 2 * (s.proposal_mode == "batch")
    host_reads = t_host["sync_round"] - t_dev["sync_round"]
    if sample == "rwalk":
        assert host_reads == 0
    else:
        # the host read the gate at every round it ran, and once more to
        # find it set; the device's loop reported it in its first read
        assert t_dev["sync_round"] - thin == 1 and host_reads == 2
    for k in ("sync_slice", "sync_wave"):
        assert t_dev.get(k, 0) == t_host.get(k, 0), k


def test_a_round_behind_the_gate_launches_no_lane_in_host_mode():
    """The unif round behind the gate runs its first wave with width 0:
    a host-mode likelihood sees no lane."""
    import dynesty_tpu_torch as dyt
    calls = []

    def np_ll(x):
        calls.append(1)
        return -0.5 * float(x @ x)

    s = dyt.NestedSampler(np_ll, lambda u: 10.0 * (2.0 * u - 1.0), 3,
                          nlive=80, bound="single", sample="unif",
                          queue_size=16, device="cpu",
                          likelihood_mode="host", rstate=get_rstate(3))
    s.run_nested(print_progress=False, maxiter=300, add_live=False)
    ctrl = _ctrl(rounds_active=3, max_accepts=s.queue_size + 1)
    ctrl[18] = float(s.ncall)
    calls.clear()
    got, layout, t = _dispatch(s, 3, ctrl, False)
    f = tfused.unpack_flat(got[0], layout)
    # every call the user's function took was billed to a record slot of
    # the two rounds that ran (and the thin-path choices read on the CPU)
    assert len(calls) > 0 and t["n_round"] == 2 and t["sync_round"] == 3
    n = len(calls)
    calls.clear()
    ref, _, _ = _dispatch(s, 3, ctrl, True)
    assert len(calls) == n and np.array_equal(got[0], ref[0])
    assert f["nc_launched"] == got[1][:, 3 + s.loglikelihood.npdim + 1].sum()


def _both_widths(sample, rounds, logl_max, monkeypatch, device):
    """A bracketed run (a finite ``logl_max``) takes the narrow width for
    its last dispatches: a second fused function of the sampler, with
    other widths, on the same round cache.  Its dispatches run on a state
    of their own shape, and the run's records equal those of a run whose
    fused functions share no cache."""
    import dynesty_tpu_torch as dyt

    def run(shared):
        s = dyt.NestedSampler(lambda x: -0.5 * (x @ x),
                              lambda u: 10.0 * (2.0 * u - 1.0), 3,
                              nlive=96, bound="single", sample=sample,
                              queue_size=32, rounds_per_dispatch=rounds,
                              walks=6, device=device, rstate=get_rstate(7))
        if not shared:
            monkeypatch.setattr(s.internal_sampler, "_slice_cache", dict)
        s.run_nested(print_progress=False, logl_max=logl_max, dlogz=1e-9,
                     add_live=False)
        monkeypatch.undo()
        return s

    s, ref = run(True), run(False)
    fused = [k for k in s.internal_sampler._round_cache if k[0] == "fused"]
    assert {k[2] for k in fused} == {s._q_full, s._q_narrow}
    states = [k for k in s.internal_sampler._slice_cache()
              if k[0] == "round"]
    assert len(states) >= 2
    assert s.results.niter == ref.results.niter
    assert len(s.saved_run) > 0
    for k in ref.saved_run.keys():
        assert np.array_equal(np.asarray(s.saved_run[k]),
                              np.asarray(ref.saved_run[k])), k
    return s


@pytest.mark.parametrize("sample,rounds,logl_max", [
    ("rslice", 1, -0.3), ("rslice", 2, -1.0), ("rwalk", 1, -0.3)])
def test_one_sampler_runs_both_widths_on_its_round_cache(
        sample, rounds, logl_max, monkeypatch):
    _both_widths(sample, rounds, logl_max, monkeypatch, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("sample", ["rslice", "unif"])
def test_one_sampler_replays_both_widths_on_the_card(cuda, sample,
                                                     monkeypatch):
    """The same on the card, where each width's rounds replay graphs of
    its own fused function."""
    s = _both_widths(sample, 1, -0.3, monkeypatch, "cuda")
    assert s.timings["n_round_replay"] > 0


@pytest.mark.parametrize("gated", [False, True])
def test_a_custom_round_reads_its_gate_before_drawing_on_the_host(gated):
    """Waves over a user's bound draw from the sampler's host stream: a
    round behind the gate reads it (one ``sync_round``) before any draw
    and draws nothing, as the round read its gate before."""
    from dynesty_tpu_torch.internal import kernels as tk
    from dynesty_tpu_torch.internal.likelihood import LogLikelihood
    from dynesty_tpu_torch.utils.misc import Timings

    q, calls = 16, []
    rs = get_rstate(4)

    def host_sampler():
        calls.append(1)
        return rs.uniform(0.3, 0.7, (q, 3))

    like = LogLikelihood(lambda x: -0.5 * (x @ x),
                         lambda u: 10.0 * (2.0 * u - 1.0), 3, device="cpu")
    like.eval_host(np.full((1, 3), 0.5))
    timings = Timings()
    fn = tk.make_unif_round(like, ndim=3, q=q, bound_kind="custom",
                            dtype=torch.float64, device="cpu",
                            timings=timings, host_sampler=host_sampler)
    fn.prepare({})
    fn.begin(-1e30, torch.tensor(gated))
    assert fn.loop(torch.Generator(), gate_read=True) == gated
    assert timings["sync_round"] == 1
    assert len(calls) == (0 if gated else 1)
    if not gated:
        packed, _ = fn.finish()
        assert np.isfinite(to_numpy(packed[:, 6])).all()


# --------------------------------------------------------------------------
# on the card


def _card_state(cuda, nlive, q, dtype, seed=11, mode="random"):
    """A round's consume columns, live matrix and proposal rows on
    ``cuda`` (any device): with ``mode`` 'none' no entry accepted, with
    'one_slot' every entry accepted into one slot."""
    rs = get_rstate(seed)
    live = torch.as_tensor(np.concatenate([
        rs.random((nlive, IL)), rs.normal(size=(nlive, 1)),
        rs.integers(0, 50, (nlive, 1)), rs.integers(-1, 3, (nlive, 1)),
        rs.normal(size=(nlive, 1))], axis=1), dtype=dtype, device=cuda)
    qrows = torch.as_tensor(np.concatenate(
        [rs.random((q, IL)), rs.normal(size=(q, 1)) + 3.0,
         rs.integers(1, 30, (q, 1)), rs.integers(0, 9, (q, 2))], axis=1),
        dtype=dtype, device=cuda)
    worsts = torch.as_tensor(rs.integers(0, nlive, q), device=cuda)
    srcs = torch.as_tensor(np.where(rs.random(q) < 0.5, -1,
                                    rs.integers(0, q, q)), device=cuda)
    srcs = torch.minimum(srcs, torch.arange(q, device=cuda) - 1)
    accepts = torch.as_tensor(rs.random(q) < 0.8, device=cuda)
    if mode == "none":
        accepts.zero_()
    elif mode == "one_slot":
        worsts.fill_(nlive // 3)
        accepts.fill_(True)
    cols = [torch.as_tensor(rs.normal(size=q), dtype=dtype, device=cuda)
            for _ in range(6)]
    outs = [worsts, srcs, accepts, *cols,
            torch.as_tensor(rs.integers(0, 40, q), device=cuda),
            torch.as_tensor(rs.normal(size=q), dtype=dtype, device=cuda),
            torch.as_tensor(rs.normal(size=q), dtype=dtype, device=cuda)]
    return outs, live, qrows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nlive,q", [(64, 16), (2048, 256), (1000, 300)])
def test_kernels_match_plain_on_the_card(cuda, dtype, nlive, q):
    outs, live, qrows = _card_state(cuda, nlive, q, dtype)
    rounds, ridx = 3, torch.tensor(1, device=cuda)
    it0 = torch.tensor(123456789, device=cuda)
    birth = torch.tensor(-1.25, dtype=dtype, device=cuda)
    thr = torch.tensor(0.5, dtype=dtype, device=cuda)
    qnc = qrows[:, IL + 1].to(torch.int64)
    lane = qrows[:, IL + 2:]
    res = []
    for fn in (cs.round_assemble, cs.round_assemble_plain_into):
        out = cs.assemble_buffers(rounds, q, nlive, NDIM, NPDIM, dtype,
                                  cuda)
        for t in out.values():
            t.zero_()
        lv = live.clone()
        n0 = cs.round_assemble.launches
        fn(outs, lv, qrows, qnc, lane, it0, birth, thr, out, ridx,
           ndim=NDIM)
        torch.cuda.synchronize()
        assert cs.round_assemble.launches - n0 == (
            fn is cs.round_assemble)
        out.pop("entry_it")
        res.append((lv, out))
    (lv_k, out_k), (lv_p, out_p) = res
    assert torch.equal(lv_k, lv_p)
    for k in out_k:
        assert torch.equal(out_k[k], out_p[k]), k


# three rounds on one set of buffers: the mark left zeroed after each
ROUND_MODES = ("random", "none", "one_slot")


def _assemble_rounds(cuda, nlive, q, dtype):
    """Each round of ``ROUND_MODES``' arguments after ``outs`` (round index
    ``r``), made once."""
    rounds = []
    for r, mode in enumerate(ROUND_MODES):
        outs, _, qrows = _card_state(cuda, nlive, q, dtype, seed=20 + r,
                                     mode=mode)
        rounds.append((outs, qrows, qrows[:, IL + 1].to(torch.int64),
                       qrows[:, IL + 2:], torch.tensor(1000 + 7 * r,
                                                       device=cuda),
                       torch.tensor(-1.25 - r, dtype=dtype, device=cuda),
                       torch.tensor(0.5 + r, dtype=dtype, device=cuda)))
    return rounds


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nlive,q", [(2048, 256), (16384, 256), (100, 1)])
def test_kernels_match_plain_round_after_round_on_the_card(cuda, dtype,
                                                           nlive, q):
    """Three rounds on one set of buffers (one with no accept, one whose
    every accepted entry kills one slot), eagerly and then replayed from
    a graph captured once, against the plain assembly on its own
    buffers, bit for bit after every round; the mark zero after each."""
    _, live, _ = _card_state(cuda, nlive, q, dtype)
    rounds = _assemble_rounds(cuda, nlive, q, dtype)
    n = len(ROUND_MODES)
    ref = cs.assemble_buffers(n, q, nlive, NDIM, NPDIM, dtype, cuda)
    for t in ref.values():
        t.zero_()
    lv_ref = live.clone()
    expect = []
    for r, args in enumerate(rounds):
        cs.round_assemble_plain_into(args[0], lv_ref, *args[1:], ref,
                                     torch.tensor(r, device=cuda),
                                     ndim=NDIM)
        expect.append((lv_ref.clone(), {k: t.clone() for k, t in
                                        ref.items() if k != "entry_it"}))

    def check(lv, out, r):
        lv_e, out_e = expect[r]
        assert torch.equal(lv, lv_e), r
        for k, t in out_e.items():
            assert torch.equal(out[k], t), (r, k)

    out = cs.assemble_buffers(n, q, nlive, NDIM, NPDIM, dtype, cuda)
    for t in out.values():
        t.zero_()
    lv = live.clone()
    ridx = torch.zeros((), dtype=torch.int64, device=cuda)
    for r, args in enumerate(rounds):
        n0 = cs.round_assemble.launches
        cs.round_assemble(args[0], lv, *args[1:], out, ridx, ndim=NDIM)
        torch.cuda.synchronize()
        assert cs.round_assemble.launches - n0 == 1
        check(lv, out, r)
        ridx.add_(1)

    # the same rounds from one captured call on fixed buffers
    outs_s = [t.clone() for t in rounds[0][0]]
    rest_s = [t.clone() for t in rounds[0][1:]]
    qrows_s = rest_s[0]

    def call():
        cs.round_assemble(outs_s, lv, qrows_s, rest_s[1], qrows_s[:, IL + 2:],
                          *rest_s[3:], out, ridx, ndim=NDIM)

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        call()
    for t in out.values():
        t.zero_()
    lv.copy_(live)
    ridx.zero_()
    for r, args in enumerate(rounds):
        for d, t in zip(outs_s, args[0]):
            d.copy_(t)
        for d, t in zip(rest_s, args[1:]):
            d.copy_(t)
        g.replay()
        torch.cuda.synchronize()
        check(lv, out, r)
        ridx.add_(1)


def _card_dispatch(cuda, capture, seed, gens):
    """A balls/rslice drive on the card (nlive 512), its rounds'
    generators recorded in ``gens``; with ``capture`` False the fused
    rounds run their prologue and epilogue eagerly."""
    import dynesty_tpu_torch as dyt
    from dynesty_tpu_torch.internal import samplers as ts
    make = tfused.torch_generator

    def recorded(s_, device):
        g = make(s_, device)
        gens.append(g)
        return g

    saved = tfused.torch_generator, ts._capture_rounds
    tfused.torch_generator = recorded
    if not capture:
        ts._capture_rounds = lambda ns: False
    try:
        s = dyt.NestedSampler(lambda x: -0.5 * (x @ x),
                              lambda u: 10.0 * (2.0 * u - 1.0), 3,
                              nlive=512, bound="balls", sample="rslice",
                              queue_size=64, rstate=get_rstate(seed))
        s.run_nested(print_progress=False, maxiter=1500)
    finally:
        tfused.torch_generator, ts._capture_rounds = saved
    return s


@pytest.mark.cuda
def test_captured_round_equals_the_eager_round_on_the_card(cuda):
    g_cap, g_eager = [], []
    s = _card_dispatch(cuda, True, 5, g_cap)
    e = _card_dispatch(cuda, False, 5, g_eager)
    for k in ("samples", "logl", "logwt", "logz", "logzerr", "samples_it",
              "samples_n", "samples_birth", "ncall"):
        assert np.array_equal(np.asarray(s.results[k]),
                              np.asarray(e.results[k])), k
    assert [g.get_offset() for g in g_cap] == \
        [g.get_offset() for g in g_eager]
    t, te = s.timings, e.timings
    assert t["n_round_graph"] >= 1 and "n_round_replay" not in te
    # every round replayed but the first of each shape
    assert 0 < t["n_round"] - t["n_round_replay"] <= 2
    for k in ("sync_slice", "sync_wave", "n_round"):
        assert t.get(k, 0) == te.get(k, 0), k
    assert t.get("sync_round", 0) <= t["n_dispatch"]
