"""The ellipsoid refit of a chained unif round (``ops/ellipsoid_refit.py``,
``csrc/ellipsoid_refit.cu``).

On the CPU: the plain version against the JAX package's
``make_ellipsoid_refit`` (float64, 1e-10 relative) over 2, 3 and 15
dimensions, 1, 4 and 32 slots, the degenerate, overflow and empty-padding
stacks, with and without ``expand``; the stage wrappers against the whole
plain refit, bit for bit; a run whose rounds re-fit in their prologue
against the same run re-fitting before it (the parent's place), records
bit for bit; the kernels' argument tables against their structs in the
CUDA source, with and without the global matrices' scratch; and the
kernels' layouts (staged, and past the shared-memory ceiling) against
the source's constants.  The JAX package is imported inside its one test, so
that the card's tests run where JAX is not installed.

Marked ``cuda`` (skipped without a card): the kernels against the plain
version at the heavy drive's, the eggbox's and a 15-D stack, at 16384
points, and past the shared-memory ceiling (16384 members of one slot;
40 dimensions); two launches and a captured replay the same bits at each
of those; a round's captured prologue against the eager one; a run
stopped, saved, restored and resumed against the uninterrupted run.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import dynesty_tpu_torch as dyt
from dynesty_tpu_torch.internal import fused as tf
from dynesty_tpu_torch.internal import kernels as tk
from dynesty_tpu_torch.internal import samplers as ts
from dynesty_tpu_torch.ops import ellipsoid_refit as rr

torch.set_num_threads(1)

SRC = Path(rr.__file__).resolve().parent.parent / "csrc" / \
    "ellipsoid_refit.cu"
ARRAYS = ("ctrs", "axes", "ams", "logvols")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def stack(n, k, m, d, case=None, expand=True, seed=7):
    """Live points from ``k`` Gaussian clusters in the cube and the
    dispatch's fit of them padded to ``m`` slots (each cluster's sample
    covariance enlarged by 1.2, or its true one below d + 1 points), as
    numpy: ``(u (n, d), padded arrays)``.  ``case``: 'degenerate' (the
    last cluster two points), 'overflow' (a point 1e200 out)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    ctrs = rng.uniform(0.25, 0.75, (k, d))
    covs = np.empty((k, d, d))
    for j in range(k):
        a = rng.normal(size=(d, d))
        covs[j] = 1e-3 * (a @ a.T / d + 0.5 * np.eye(d))
    which = rng.integers(0, k, n)
    if case == "degenerate":
        which[which == k - 1] = 0
        which[:2] = k - 1
    u = ctrs[which] + np.einsum("nij,nj->ni",
                                np.linalg.cholesky(covs)[which],
                                rng.normal(size=(n, d)))
    fit = {key: [] for key in ARRAYS}
    for j in range(k):
        pts = u[which == j]
        c = covs[j] if len(pts) <= d else np.cov(pts.T, bias=True) * 1.2
        ax = np.linalg.cholesky(c)
        fit["ctrs"].append(pts.mean(0) if len(pts) else ctrs[j])
        fit["axes"].append(ax)
        fit["ams"].append(np.linalg.inv(c))
        fit["logvols"].append(np.log(np.diag(ax)).sum() +
                              rr.logvol_prefactor(d))
    padded = tk.pad_ellipsoids(*(np.asarray(fit[key]) for key in ARRAYS),
                               min_pad=m)
    if expand:
        padded["expand"] = np.float64(1.1)
    if case == "overflow":
        u[-1] = ctrs[k - 1] + 1e200
    return u, padded


def to_torch(u, padded, device="cpu", dtype=torch.float64, cols=None):
    """``u`` as the first columns of a live matrix of ``cols`` columns
    (its row stride), and the arrays, as tensors on ``device``."""
    n, d = u.shape
    live = np.zeros((n, cols or d))
    live[:, :d] = u
    arrays = {k: torch.as_tensor(v, dtype=torch.bool if k == "mask"
                                 else dtype, device=device)
              for k, v in padded.items()}
    return torch.as_tensor(live, dtype=dtype, device=device)[:, :d], arrays


def rel_err(a, b):
    """The largest difference in any slot over that slot's largest finite
    ``|b|``; equal values (infinities too) and NaN pairs count 0."""
    a = a.double().reshape(a.shape[0], -1).cpu()
    b = b.double().reshape(b.shape[0], -1).cpu()
    same = (torch.isnan(a) & torch.isnan(b)) | (a == b)
    diff = torch.where(same, 0.0, (a - b).abs())
    diff = torch.where(torch.isnan(diff), math.inf, diff)
    scale = torch.where(torch.isfinite(b), b.abs(), 0.0).amax(dim=1)
    return float((diff.amax(dim=1) / torch.where(scale > 0, scale, 1.0))
                 .max())


# --------------------------------------------------------------------------
# the plain version against the JAX package


JAX_CASES = [(d, k, m, None) for d in (2, 3, 15)
             for k, m in ((1, 1), (3, 4), (18, 32))] + \
    [(3, 3, 4, "degenerate"), (3, 3, 4, "overflow"), (3, 3, 8, "empty_pad")]


@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("d,k,m,case", JAX_CASES)
def test_plain_refit_matches_jax(d, k, m, case, expand):
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from dynesty_tpu.internal import kernels as jk

    n = 40 * k + 40 if d < 15 else 30 * k + 60
    u, padded = stack(n, k, m, d, case, expand)
    jrefit = jax.jit(jk.make_ellipsoid_refit(d, dtype=jnp.float64))
    jout = jrefit(jnp.asarray(u), {key: jnp.asarray(v)
                                   for key, v in padded.items()})
    tu, arrays = to_torch(u, padded, cols=d + 5)
    tout = rr.ellipsoid_refit_plain(tu, arrays, d)
    assert np.array_equal(tout["mask"].numpy(), np.asarray(jout["mask"]))
    for key in ARRAYS:
        j, t = np.asarray(jout[key]), tout[key].numpy()
        np.testing.assert_allclose(t, j, rtol=1e-10, atol=0, err_msg=key)
    # padding slots keep the host fit: identity matrices, -inf volumes
    pad = ~padded["mask"]
    assert np.array_equal(tout["ams"].numpy()[pad], padded["ams"][pad])
    assert np.all(tout["logvols"].numpy()[pad] == -np.inf)


# --------------------------------------------------------------------------
# the stages and the wrappers on the CPU


@pytest.mark.parametrize("d,k,m,case", [(2, 18, 32, None), (3, 3, 4, None),
                                        (15, 3, 4, None),
                                        (3, 3, 4, "overflow"),
                                        (3, 3, 8, "degenerate")])
def test_the_stages_compose_the_plain_refit(d, k, m, case):
    """refit_assign then refit_fit on an EllipsoidRefit (the prologue's
    form, into given buffers) and make_ellipsoid_refit give the whole
    plain refit bit for bit on the CPU; the slots re-fitted are the
    plain version's."""
    u, padded = stack(40 * k + 40, k, m, d, case)
    tu, arrays = to_torch(u, padded, cols=d + 5)
    whole = rr.ellipsoid_refit_plain(tu, arrays, d)
    rf = rr.EllipsoidRefit(tu.shape[0], m, d, torch.float64, "cpu")
    out = {key: torch.full_like(arrays[key], 7) for key in rr.REFIT_FIELDS}
    rr.ellipsoid_refit(rf, tu, arrays, out)
    _, idx = rr.refit_assign_plain(tu, arrays["ctrs"], arrays["ams"],
                                   arrays["mask"])
    _, keep = rr.refit_fit_plain(tu, idx, arrays, d, with_keep=True)
    assert torch.equal(rf.idx, idx) and torch.equal(rf.keep, keep)
    made = tk.make_ellipsoid_refit(d)(tu, arrays)
    for key in rr.REFIT_FIELDS:
        assert torch.equal(out[key], whole[key]), key
        assert torch.equal(made[key], whole[key]), key
    assert rf._assign_args is None and rf._fit_args is None
    assert rr.refit_assign.launches == rr.refit_fit.launches == 0


def test_refit_buffers_are_kept_by_shape():
    cache = {}
    a = rr.refit_buffers(cache, 100, 4, 3, torch.float64, "cpu")
    assert rr.refit_buffers(cache, 100, 4, 3, torch.float64, "cpu") is a
    b = rr.refit_buffers(cache, 200, 4, 3, torch.float64, "cpu")
    assert b is not a and len(cache) == 2
    # four slots: four lanes a point, 64 points a refit_assign block
    assert a.nonfinite.shape == (2,) and b.idx.shape == (200,)
    # the matrices of 3 dimensions fit in shared memory, of 60 do not
    assert a.work is None
    c = rr.refit_buffers(cache, 100, 4, 60, torch.float64, "cpu")
    assert c.work.shape == (4, 3 * 3600 + 60)


# (nlive, slots, ncdim, dtype): refit_fit's cap, whether every slot is
# staged, and refit_assign's lanes a point, blocks and slots a tile
LAYOUTS = [
    # heavy's stack: every member of its one slot in shared memory
    ((3000, 1, 3, torch.float64), 3000, True, 1, 12, 0),
    # past the ceiling: 16384 members of one slot, staged 9461 at a time
    ((16384, 1, 3, torch.float64), 9461, False, 1, 64, 0),
    # the same points in float32 fit
    ((16384, 1, 3, torch.float32), 16384, True, 1, 64, 0),
    # the eggbox's stack: 32 lanes a point
    ((1000, 32, 2, torch.float64), 1000, True, 32, 125, 32),
    # 40 dimensions: 589 members at a time, the matrices beside them
    ((2000, 4, 40, torch.float64), 589, False, 4, 32, 4),
    # 60 dimensions: the matrices in global memory, 7 slots a tile
    ((500, 64, 60, torch.float64), 473, False, 32, 63, 7),
]


@pytest.mark.parametrize("shape,cap,staged,group,blocks,tile", LAYOUTS)
def test_the_layouts_stage_or_chunk_past_the_ceiling(shape, cap, staged,
                                                     group, blocks, tile):
    """``EllipsoidRefit`` sizes the kernels' shared memory and scratch
    for its shape: ``refit_fit`` stages every member where the budget
    holds them and ``cap`` at a time past it (one member more would not
    fit), its matrices in shared memory up to ``MATS_MAX`` (else a
    ``work`` row a slot); ``refit_assign`` a flag a block.  The budgets
    are the CUDA source's."""
    n, m, d, dtype = shape
    rf = rr.EllipsoidRefit(n, m, d, dtype, "cpu")
    fs = 8 if dtype == torch.float64 else 4
    fit, asg = rf.fit_layout, rf.assign_layout
    assert (fit["cap"], fit["staged"]) == (cap, staged)
    mats = (3 * d * d + d) * fs
    assert fit["shared_mats"] == (mats <= rr.MATS_MAX) == (rf.work is None)
    # each coordinate's row an odd pitch apart
    assert fit["pitch"] in (cap, cap + 1) and fit["pitch"] % 2 == 1
    assert fit["bytes"] == 256 * fs + mats * fit["shared_mats"] + \
        fit["pitch"] * d * fs <= rr.SMEM_BUDGET
    if not staged:
        assert fit["bytes"] + 2 * d * fs > rr.SMEM_BUDGET
    else:
        assert cap == n
    if rf.work is not None:
        assert rf.work.shape == (m, 3 * d * d + d)
    assert (asg["group"], asg["blocks"], asg["tile"]) == (group, blocks, tile)
    assert asg["points"] * asg["group"] == 256
    assert rf.nonfinite.shape == (blocks,) and rf.rows.shape == (n, d)
    assert asg["staged"] and asg["bytes"] <= rr.SMEM_BUDGET
    src = SRC.read_text()
    for name in ("SMEM_BUDGET", "MATS_MAX", "POINTS_MAX"):
        kb = re.search(r"const i64 %s = (\d+) \* 1024;" % name, src)
        assert int(kb.group(1)) * 1024 == getattr(rr, name), name
    assert re.search(r"const int BLOCK = (\d+);", src).group(1) == "256"


def test_the_wrapper_checks_its_inputs():
    u, padded = stack(100, 3, 4, 3)
    tu, arrays = to_torch(u, padded, cols=8)
    rf = rr.EllipsoidRefit(100, 4, 3, torch.float64, "cpu")
    rf.check(tu, arrays)
    with pytest.raises(ValueError, match="rows"):
        rf.check(tu[:50], arrays)
    with pytest.raises(ValueError, match="rows"):
        rf.check(tu.to(torch.float32), arrays)
    with pytest.raises(ValueError, match="must have shape"):
        rf.check(tu, dict(arrays, ams=arrays["ams"][:2]))
    with pytest.raises(TypeError, match="must be torch.bool"):
        rf.check(tu, dict(arrays, mask=arrays["mask"].double()))
    with pytest.raises(ValueError, match="must have shape"):
        rf.check(tu, dict(arrays, expand=arrays["expand"][None]))
    with pytest.raises(TypeError, match="float64 or float32"):
        rr.EllipsoidRefit(100, 4, 3, torch.float16, "cpu")
    with pytest.raises(ValueError, match="bad shape"):
        rr.EllipsoidRefit(100, 0, 3, torch.float64, "cpu")


def test_source_names_the_jax_code_it_replaces():
    src = SRC.read_text()
    for ref in ("dynesty_tpu/internal/kernels.py:206",
                "dynesty_tpu/internal/samplers.py:495-505"):
        assert ref in src
    assert "cudaGetLastError" in src and "sm_90a" in src
    assert "atomic" not in src.split("#include")[1]


def _struct_fields(src, name):
    """The pointer fields of the argument struct ``name`` in the CUDA
    source, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        m = re.match(r"\s*(?:const\s+)?[\w\s]+?\*\s*(\w+);",
                     line.split("//")[0])
        if m:
            fields.append(m.group(1))
    return fields


@pytest.mark.parametrize("d", [3, 60])
def test_the_argument_tables_follow_the_kernels_structs(monkeypatch, d):
    """Each kernel's pointer table, as ``EllipsoidRefit`` binds it and
    each wrapper fills it at a launch, names the tensors in the order of
    the kernel's argument struct in ``csrc/ellipsoid_refit.cu``; only
    ``expand`` may be absent, and ``work`` where the slot's matrices fit
    in shared memory (3 dimensions; not 60)."""
    monkeypatch.setattr(rr, "_entry", lambda *a: None)
    tables = []
    monkeypatch.setattr(rr, "_run", lambda f, ptrs, ints, device, fn:
                        tables.append((fn, list(ptrs), ints)))
    u, padded = stack(300, 3, 4, d)
    tu, arrays = to_torch(u, padded, cols=d + 6)
    rf = rr.EllipsoidRefit(300, 4, d, torch.float64, "cpu")
    assert (rf.work is None) == (d == 3)
    rf._bind()
    # the kernel's branch of each wrapper, its checks left out
    rf.device = torch.device("cuda", 0)
    monkeypatch.setattr(rf, "check", lambda *a: None)
    out = {key: torch.empty_like(arrays[key]) for key in rr.REFIT_FIELDS}
    rr.ellipsoid_refit(rf, tu, arrays, out)
    names = {tu.data_ptr(): "u"}
    for key, t in arrays.items():
        names[t.data_ptr()] = {"mask": "mask", "expand": "expand"}.get(
            key, key + "0")
    for key, t in out.items():
        names[t.data_ptr()] = "mask_out" if key == "mask" else key
    for key in ("idx", "keep", "work", "pref", "nonfinite", "rows"):
        if getattr(rf, key) is not None:
            names[getattr(rf, key).data_ptr()] = key
    # an absent work row is a null entry in its place
    names[None] = "work"
    src = SRC.read_text()
    assert [t[0] for t in tables] == ["refit_assign", "refit_fit"]
    for (fn, table, ints), struct in zip(tables, ("AssignArgs", "FitArgs")):
        assert [names[p] for p in table] == _struct_fields(src, struct), fn
        # n, m, d and the points' row stride
        assert ints == (300, 4, d, d + 6)
    rr.zero_counts()
    # without expand, its entry is null
    tables.clear()
    arrays.pop("expand")
    rr.refit_fit(rf, tu, arrays, out)
    assert tables[0][1][_struct_fields(src, "FitArgs").index("expand")] \
        is None
    rr.zero_counts()


# --------------------------------------------------------------------------
# a sampler's run: the refit in the prologue against the refit before it


def _parent_prepare(self, live, axes_args):
    """``_UnifProposer.prepare`` as it was: the refit eager, before the
    prologue, its result copied into the wave's buffers."""
    if self.refit:
        axes_args = dict(axes_args, **rr.ellipsoid_refit_plain(
            live[:, :self.ncdim], axes_args, self.ncdim, self.inner.dtype))
    return self.inner.prepare(axes_args)


def _parent_begin(self, gen, live, live_blob, axes_args, scale, loglstar,
                  gate):
    self.inner.begin(loglstar, gate)


def _eggbox_run(device="cpu", dtype=torch.float64, sampler=None, **kw):
    """The eggbox under multi/unif (several ellipsoids a dispatch, chained
    rounds) to dlogz 0.5, or ``sampler`` run on with ``kw``."""
    if sampler is None:
        p = dyt.models.Eggbox()
        sampler = dyt.NestedSampler(
            p.loglike, p.ptform, p.ndim, nlive=300, queue_size=64,
            device=device, dtype=dtype,
            rstate=np.random.Generator(np.random.PCG64(3)))
    sampler.run_nested(dlogz=0.5, print_progress=False, **kw)
    return sampler


def _records(s):
    r = s.results
    return {"logl": r.logl, "samples": r.samples, "logz": r.logz,
            "ncall": np.asarray(r.ncall), "niter": r.niter,
            "total": s.ncall}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_refit_in_the_prologue_gives_the_parents_run(monkeypatch,
                                                          dtype):
    """A multi/unif run over the eggbox (several ellipsoids a dispatch,
    chained rounds) whose rounds re-fit in their prologue, against the
    same run re-fitting before the prologue as the port did before the
    refit kernels: records bit for bit on the CPU."""
    calls = []
    fit = rr.refit_fit
    monkeypatch.setattr(rr, "refit_fit", lambda *a: (calls.append(1),
                                                     fit(*a))[1])
    new = _records(_eggbox_run(dtype=dtype))
    assert len(calls) > 20
    monkeypatch.setattr(ts._UnifProposer, "prepare", _parent_prepare)
    monkeypatch.setattr(ts._UnifProposer, "begin", _parent_begin)
    old = _records(_eggbox_run(dtype=dtype))
    for key, v in old.items():
        assert np.array_equal(new[key], v), key


# --------------------------------------------------------------------------
# on the card


# (name, points, ellipsoids, slots, dimensions); the last two cross
# refit_fit's shared-memory ceiling (float64): 16384 members of one slot,
# and about 1000 members a slot in 40 dimensions
CUDA_CASES = [("eggbox", 1000, 18, 32, 2), ("heavy", 3000, 1, 1, 3),
              ("multi", 3000, 3, 4, 3), ("d15", 1000, 5, 8, 15),
              ("wide", 16384, 20, 32, 3), ("ceiling", 16384, 1, 1, 3),
              ("d40", 2000, 2, 4, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,n,k,m,d", CUDA_CASES)
def test_cuda_kernels_match_the_plain_version(cuda, name, n, k, m, d,
                                              dtype):
    """Each point's slot equal where the plain version's two smallest
    forms differ by more than 1e-12 relative; the fit within 1e-10
    (float64) or 1e-4 (float32) of the plain fit of the same slots,
    relative to each slot's largest entry; equal mask and re-fitted
    slots; two launches the same bits."""
    u, padded = stack(n, k, m, d, seed=11)
    tu, arrays = to_torch(u, padded, cuda, dtype, cols=d + 6)
    rf = rr.EllipsoidRefit(n, m, d, dtype, cuda)
    out = {key: torch.empty_like(arrays[key]) for key in rr.REFIT_FIELDS}
    rr.refit_assign(rf, tu, arrays)
    d2, idx_p = rr.refit_assign_plain(tu, arrays["ctrs"], arrays["ams"],
                                      arrays["mask"])
    srt = d2.sort(dim=1).values
    decided = srt[:, 1] - srt[:, 0] > 1e-12 * srt[:, 0].abs() if m > 1 \
        else torch.ones(n, dtype=torch.bool, device=cuda)
    assert not ((rf.idx != idx_p) & decided).any()
    rr.refit_fit(rf, tu, arrays, out)
    ref, keep = rr.refit_fit_plain(tu, rf.idx, arrays, d, dtype,
                                   with_keep=True)
    rtol = 1e-10 if dtype == torch.float64 else 1e-4
    for key in ARRAYS:
        assert rel_err(out[key], ref[key]) <= rtol, key
    assert torch.equal(out["mask"], ref["mask"])
    assert torch.equal(rf.keep, keep) and int(keep.sum()) == k
    again = {key: torch.empty_like(v) for key, v in out.items()}
    idx = rf.idx.clone()
    rr.ellipsoid_refit(rf, tu, arrays, again)
    assert torch.equal(rf.idx, idx)
    for key in rr.REFIT_FIELDS:
        assert torch.equal(again[key], out[key]), key
    rr.zero_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,n,k,m,d", CUDA_CASES)
def test_cuda_kernels_are_deterministic(cuda, name, n, k, m, d, dtype):
    """Two launches of both kernels and a captured replay of them on the
    same inputs give the same bits: the slots, the re-fitted slots and
    every output (the sums' orders do not depend on the grid, the
    staging or the launch)."""
    u, padded = stack(n, k, m, d, seed=13)
    tu, arrays = to_torch(u, padded, cuda, dtype, cols=d + 6)
    rf = rr.EllipsoidRefit(n, m, d, dtype, cuda)

    def fresh():
        return {key: torch.full_like(arrays[key], 7)
                for key in rr.REFIT_FIELDS}

    runs = []
    for _ in range(2):
        out = fresh()
        rr.ellipsoid_refit(rf, tu, arrays, out)
        runs.append((out, rf.idx.clone(), rf.keep.clone()))
    out = fresh()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        rr.ellipsoid_refit(rf, tu, arrays, out)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    rf.idx.zero_()
    graph.replay()
    torch.cuda.synchronize()
    runs.append((out, rf.idx.clone(), rf.keep.clone()))
    first = runs[0]
    assert int(first[2].sum()) == k
    for other in runs[1:]:
        assert torch.equal(other[1], first[1])
        assert torch.equal(other[2], first[2])
        for key in rr.REFIT_FIELDS:
            a, b = other[0][key], first[0][key]
            if key != "mask":
                a, b = a.view(torch.int64 if dtype == torch.float64
                              else torch.int32), \
                    b.view(torch.int64 if dtype == torch.float64
                           else torch.int32)
            assert torch.equal(a, b), key
    rr.zero_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["degenerate", "overflow", "empty_pad"])
def test_cuda_edge_stacks(cuda, case):
    """The slots the plain version keeps are the kernels' too: too few
    members, a covariance that overflows, padding slots with no member."""
    u, padded = stack(200, 3, 8 if case == "empty_pad" else 4, 3, case)
    tu, arrays = to_torch(u, padded, cuda, cols=9)
    rf = rr.EllipsoidRefit(200, len(padded["mask"]), 3, torch.float64, cuda)
    out = {key: torch.empty_like(arrays[key]) for key in rr.REFIT_FIELDS}
    rr.ellipsoid_refit(rf, tu, arrays, out)
    ref, keep = rr.refit_fit_plain(tu, rf.idx, arrays, 3, with_keep=True)
    assert torch.equal(rf.keep, keep)
    assert int(keep.sum()) == {"degenerate": 2, "overflow": 2,
                               "empty_pad": 3}[case]
    for key in ARRAYS:
        assert rel_err(out[key], ref[key]) <= 1e-10, key
    rr.zero_counts()


def _cuda_run(monkeypatch=None, eager=False, **kw):
    if eager:
        monkeypatch.setattr(tf.RoundGraphs, "capture",
                            lambda self, *a: False)
    return _eggbox_run(device="cuda", **kw)


@pytest.mark.cuda
def test_cuda_captured_prologue_matches_eager(cuda, monkeypatch):
    """The eggbox run with every round's prologue and epilogue replayed
    against the same run with them launched eagerly: the same kernels,
    so the records bit for bit, and the refit launched once a chained
    ellipsoid round either way."""
    rr.zero_counts()
    s = _cuda_run()
    launches = rr.refit_fit.launches
    assert s.timings["n_round_replay"] > 0
    assert launches == rr.refit_assign.launches > 0
    rr.zero_counts()
    e = _cuda_run(monkeypatch, eager=True)
    assert e.timings.get("n_round_replay", 0) == 0
    assert rr.refit_fit.launches == launches
    for key, v in _records(s).items():
        assert np.array_equal(_records(e)[key], v), key
    rr.zero_counts()


@pytest.mark.cuda
def test_cuda_resume_is_bit_for_bit(cuda, tmp_path):
    """The eggbox run stopped at a third of its iterations, saved,
    restored onto the card and resumed, against the uninterrupted run."""
    full = _records(_cuda_run())
    s = _cuda_run(maxiter=full["niter"] // 3, add_live=False)
    path = str(tmp_path / "refit.pkl")
    s.save(path)
    resumed = _eggbox_run(sampler=dyt.NestedSampler.restore(path),
                          resume=True)
    for key, v in _records(resumed).items():
        assert np.array_equal(v, full[key]), key
    rr.zero_counts()
