"""The per-round re-fit of an ellipsoid stack before a chained uniform
round: two hand-written CUDA kernels and their plain PyTorch version.

The JAX package re-fits the padded stack of the dispatch's ellipsoids to
the current live points before every chained ``unif`` round, inside the
jitted round (``dynesty_tpu/internal/kernels.py:206``
``make_ellipsoid_refit``, called at
``dynesty_tpu/internal/samplers.py:495-505``): each live point joins its
nearest ellipsoid (Mahalanobis under the dispatch's fit); each slot takes
its members' mean and MLE covariance, inflated so that the worst member
sits at distance ``1 - 1e-3``, then scaled by ``arrays['expand']`` (the
host's bootstrap x enlarge linear factor).  A slot with fewer than
``ncdim + 1`` members, or whose Cholesky factorization fails, keeps its
fit.

On the card the refit is ``csrc/ellipsoid_refit.cu``:
:func:`refit_assign` (a thread per (point, slot): the forms, the slot
arrays staged in shared memory, a point's lanes meeting by shuffles) and
:func:`refit_fit` (a block a slot: its members listed and their
coordinates gathered into shared memory in one trip, then the moments,
the factor on one warp (one thread at 2 and 3 dimensions), its inverse,
the containment and the slot's outputs, written straight into the wave's
buffers), which a fused round's
prologue launches and its capture records (``internal/samplers.py``,
``_UnifProposer.begin``).  Their sums run in fixed orders, whatever the
grid or the staging (:func:`fit_layout`, :func:`assign_layout`), so they
reproduce themselves bit for bit, and agree with the plain version
(:func:`ellipsoid_refit_plain`, whose orders are cuBLAS's and cuSOLVER's
on the card) to rounding.  On a CPU tensor each wrapper runs its stage of
the plain version, the CPU path; on a CUDA tensor it launches its kernel
or raises.
"""

import math

import torch

from .proposals import _DTYPES, _check, _entry, _pointer_table, _run

__all__ = ["EllipsoidRefit", "REFIT_FIELDS", "refit_buffers",
           "refit_assign", "refit_assign_plain", "refit_fit",
           "refit_fit_plain", "ellipsoid_refit", "ellipsoid_refit_plain",
           "logvol_prefactor", "assign_layout", "fit_layout",
           "zero_counts", "WRAPPERS"]

# the refit's outputs: the padded stack's arrays a wave reads
REFIT_FIELDS = ("ctrs", "axes", "ams", "logvols", "mask")
# the worst member's distance below 1 after the inflation
EPS_CONTAIN = 1e-3
# the kernels' block, the dynamic shared memory a block takes at most and
# the parts staged there only up to a size (csrc/ellipsoid_refit.cu)
BLOCK = 256
SMEM_BUDGET = 224 * 1024
MATS_MAX = 64 * 1024
POINTS_MAX = 64 * 1024
_FSIZE = {torch.float64: 8, torch.float32: 4}


def logvol_prefactor(d):
    """The log-volume of the unit d-ball: device log-volumes on the host
    fit's scale (the two mix where a slot keeps its previous fit)."""
    return (d / 2.0) * math.log(math.pi) - math.lgamma(d / 2.0 + 1.0)


# --------------------------------------------------------------------------
# the plain version


def refit_assign_plain(u, ctrs0, ams0, mask):
    """Each point of ``u`` (n, d)'s slot: its quadratic form under every
    slot's ``ctrs0`` (m, d) and ``ams0`` (m, d, d), inf off ``mask``, and
    the first smallest.  Returns ``(d2 (n, m), idx (n,))``."""
    diff = u[:, None, :] - ctrs0[None, :, :]
    d2 = torch.einsum("nmi,mij,nmj->nm", diff, ams0, diff)
    d2 = torch.where(mask[None, :], d2, math.inf)
    return d2, torch.argmin(d2, dim=1)


def refit_fit_plain(u, idx, arrays, ncdim, dtype=torch.float64,
                    with_keep=False):
    """Each slot re-fitted to the points of ``u`` (n, ncdim) that
    ``idx`` (n,) assigns it, from the dispatch's ``arrays`` (the padded
    schema, with an optional 0-d ``expand``).  Returns the arrays
    (:data:`REFIT_FIELDS`), with ``with_keep`` and the slots re-fitted
    (``mask & ok``, (m,) bool)."""
    d = ncdim
    ctrs0 = arrays["ctrs"].to(dtype)
    axes0 = arrays["axes"].to(dtype)
    ams0 = arrays["ams"].to(dtype)
    logvols0 = arrays["logvols"].to(dtype)
    mask = arrays["mask"]
    expand = arrays.get("expand")
    expand = 1.0 if expand is None else expand.to(dtype)
    m = ctrs0.shape[0]
    u = u.to(dtype)

    onehot = torch.nn.functional.one_hot(idx, m).to(dtype)
    counts = onehot.sum(dim=0)
    safe = counts.clamp_min(1.0)
    ctr = (onehot.T @ u) / safe[:, None]
    cent = u[:, None, :] - ctr[None, :, :]
    cov = torch.einsum("nm,nmi,nmj->mij", onehot, cent,
                       cent) / safe[:, None, None]
    # conditioning floor keeps degenerate clusters factorizable
    tr = torch.diagonal(cov, dim1=1, dim2=2).sum(dim=1) / d
    eye = torch.eye(d, dtype=dtype, device=u.device)
    cov = cov + (1e-10 * tr.clamp_min(1e-30))[:, None, None] * eye
    # cholesky_ex reports a failed factorization in `info` instead of
    # raising (jnp.linalg.cholesky returns NaN there)
    chol, info = torch.linalg.cholesky_ex(cov)
    ok = (info == 0) & torch.isfinite(chol.reshape(m, -1)).all(dim=1) \
        & (counts >= d + 1)
    chol_safe = torch.where(ok[:, None, None], chol, eye[None])
    linv = torch.linalg.solve_triangular(
        chol_safe, eye.expand(m, d, d), upper=False)
    am = torch.einsum("mki,mkj->mij", linv, linv)  # cov^-1

    # inflate to contain every member, then the host's calibration
    dd = u - ctr[idx]
    d2o = torch.einsum("ni,nij,nj->n", dd, am[idx], dd)
    fmax = torch.zeros((m,), dtype=dtype, device=u.device).scatter_reduce(
        0, idx, d2o, reduce="amax", include_self=True)
    f = torch.sqrt(fmax.clamp_min(1e-30) / (1.0 - EPS_CONTAIN)) * expand
    axes = chol_safe * f[:, None, None]
    am = am / (f ** 2)[:, None, None]
    logvol = torch.log(torch.diagonal(chol_safe, dim1=1, dim2=2)
                       .abs()).sum(dim=1) + d * torch.log(f) + \
        logvol_prefactor(d)

    keep = mask & ok
    k1, k3 = keep[:, None], keep[:, None, None]
    out = {
        "ctrs": torch.where(k1, ctr, ctrs0),
        "axes": torch.where(k3, axes, axes0),
        "ams": torch.where(k3, am, ams0),
        "logvols": torch.where(keep, logvol, logvols0),
        "mask": mask,
    }
    return (out, keep) if with_keep else out


def ellipsoid_refit_plain(u, arrays, ncdim, dtype=torch.float64):
    """The whole refit of the dispatch's ``arrays`` to the live points
    ``u`` (n, ncdim) in ``dtype``: :func:`refit_assign_plain`, then
    :func:`refit_fit_plain`.  Returns the arrays (:data:`REFIT_FIELDS`)."""
    _, idx = refit_assign_plain(u.to(dtype), arrays["ctrs"].to(dtype),
                                arrays["ams"].to(dtype), arrays["mask"])
    return refit_fit_plain(u, idx, arrays, ncdim, dtype)


# --------------------------------------------------------------------------
# the kernels


def assign_layout(nlive, m, ncdim, dtype):
    """``refit_assign``'s grid and shared memory for a shape, as
    ``csrc/ellipsoid_refit.cu`` carves them: ``group`` lanes a point (the
    power of 2 >= ``m``, at most 32; lane g takes the slots g, g + group,
    ...), ``points`` a block, ``blocks`` (one ``nonfinite`` flag each),
    ``tile`` slots' ``ams`` and ``ctrs`` staged in shared memory at a
    time, whether the block's points and a tile fit (``staged``: else
    all is read in place) and the dynamic shared memory's ``bytes``.
    One slot needs no form (``tile`` 0): its points are staged only to be
    checked and packed (``rows``)."""
    fsize, d = _FSIZE[dtype], ncdim
    group = 1
    while group < m and group < 32:
        group *= 2
    points = BLOCK // group
    pts, slot = points * d * fsize, (d * d + d) * fsize
    tile = (SMEM_BUDGET - pts) // slot
    out = {"group": group, "points": points,
           "blocks": -(-nlive // points), "tile": 0, "staged": False,
           "bytes": 0}
    if pts <= POINTS_MAX and (m == 1 or tile >= 1):
        tile = min(tile, m) if m > 1 else 0
        out.update(tile=tile, staged=True, bytes=pts + tile * slot)
    return out


def fit_layout(nlive, ncdim, dtype):
    """``refit_fit``'s shared memory for a shape, as
    ``csrc/ellipsoid_refit.cu`` carves it: ``BLOCK`` partials, the slot's
    matrices and mean where they fit in ``MATS_MAX`` (``shared_mats``;
    else the global ``work`` row), then ``cap`` members' coordinates, each
    coordinate's row ``pitch`` (odd: ``cap`` or ``cap + 1``) apart.  A
    slot of at most ``cap`` members is staged once (``staged``: every slot
    is, ``cap`` == ``nlive``); past that ceiling its sums run in stages of
    ``cap`` members.  Returns ``{"cap", "pitch", "shared_mats", "staged",
    "bytes"}``."""
    fsize, d = _FSIZE[dtype], ncdim
    mats = (3 * d * d + d) * fsize
    shared = mats <= MATS_MAX
    fixed = BLOCK * fsize + (mats if shared else 0)
    member, room = d * fsize, SMEM_BUDGET - fixed
    cap = min(nlive, room // member)
    if (cap | 1) * member > room:
        cap -= 1  # an even cap at the budget
    return {"cap": cap, "pitch": cap | 1, "shared_mats": shared,
            "staged": cap == nlive, "bytes": fixed + (cap | 1) * member}


class EllipsoidRefit:
    """The refit's buffers for one shape (``nlive`` points, ``m`` slots,
    ``ncdim`` dimensions, ``dtype``) on one device: each point's slot
    ``idx`` (int64 (nlive,)) and the slots re-fitted ``keep`` (bool
    (m,)), which both versions write; the kernels' layouts
    (:func:`assign_layout`, :func:`fit_layout`) and scratch: a flag a
    ``refit_assign`` block ``nonfinite``, the points' ``ncdim``
    coordinates packed by ``refit_assign`` for ``refit_fit`` (``rows``,
    (nlive, ncdim)), each slot's matrices and mean
    ``work`` ((m, 3 ncdim^2 + ncdim)) where they do not fit in shared
    memory (else None), and the d-ball's log-volume prefactor ``pref``
    (0-d); and on the card the two kernels' argument tables, whose inputs
    and outputs each launch fills in.  Made once (:func:`refit_buffers`),
    before any capture: a captured prologue keeps the addresses."""

    def __init__(self, nlive, m, ncdim, dtype, device):
        fn = "EllipsoidRefit"
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"{fn}: no kernel for device {device}")
        if dtype not in _DTYPES:
            raise TypeError(f"{fn} takes float64 or float32, got {dtype}")
        if min(nlive, m, ncdim) < 1:
            raise ValueError(f"{fn}: bad shape {(nlive, m, ncdim)}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.nlive, self.m, self.ncdim = nlive, m, ncdim
        self.dtype, self.device = dtype, device
        d = ncdim
        self.assign_layout = assign_layout(nlive, m, d, dtype)
        self.fit_layout = fit_layout(nlive, d, dtype)
        if self.fit_layout["cap"] < 1:
            raise ValueError(f"{fn}: {d} dimensions leave no shared memory "
                             f"for a member")

        def e(shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        self.idx, self.keep = e((nlive,), torch.int64), e((m,), torch.bool)
        # a refit_assign block's points hold a coordinate that is not
        # finite (every slot then keeps its fit, as in the plain version,
        # whose one-hot product makes every mean NaN)
        self.nonfinite = e((self.assign_layout["blocks"],), torch.int32)
        self.rows = e((nlive, d))
        self.work = None if self.fit_layout["shared_mats"] else \
            e((m, 3 * d * d + d))
        self.pref = torch.tensor(logvol_prefactor(d), dtype=dtype,
                                 device=device)
        self._assign_args = self._fit_args = None
        if device.type == "cuda":
            self._bind()

    def _bind(self):
        """Both kernels' argument tables, with the scratch in place; a
        launch writes its inputs and outputs into them."""
        self._assign_args = _pointer_table(
            (None, None, None, None, self.idx, self.nonfinite, self.rows))
        self._fit_args = _pointer_table(
            (self.rows, self.idx) + (None,) * 6 + (self.pref, self.work) +
            (None,) * 5 + (self.keep, self.nonfinite))
        tag = _DTYPES[self.dtype]
        self._assign_fn = _entry("ellipsoid_refit", "refit_assign", tag)
        self._fit_fn = _entry("ellipsoid_refit", "refit_fit", tag)

    def check(self, u, arrays, out=None):
        """Raise unless ``u`` is (nlive, ncdim) rows of the refit's dtype
        on its device with contiguous columns (a column slice of the live
        matrix), ``arrays`` the dispatch's padded stack (contiguous, the
        refit's dtype, ``expand`` 0-d or absent) and ``out`` the same
        schema without ``expand``."""
        n, m, d, dt, dev = (self.nlive, self.m, self.ncdim, self.dtype,
                            self.device)
        fn = "ellipsoid_refit"
        if not isinstance(u, torch.Tensor):
            raise TypeError(f"{fn}: u must be a torch.Tensor")
        if tuple(u.shape) != (n, d) or u.dtype != dt or u.device != dev \
                or (u.stride(1) != 1 and d > 1) or u.stride(0) < d:
            raise ValueError(f"{fn}: u must be ({n}, {d}) rows of {dt} on "
                             f"{dev} with contiguous columns, got "
                             f"{tuple(u.shape)} {u.dtype} on {u.device} "
                             f"with strides {u.stride()}")
        shapes = {"ctrs": (m, d), "axes": (m, d, d), "ams": (m, d, d),
                  "logvols": (m,), "mask": (m,)}
        for what, tree in (("arrays", arrays), ("out", out)):
            if tree is None:
                continue
            for k, shape in shapes.items():
                _check(fn, f"{what}['{k}']", tree.get(k), shape,
                       torch.bool if k == "mask" else dt, dev)
        if arrays.get("expand") is not None:
            _check(fn, "arrays['expand']", arrays["expand"], (), dt, dev)


def refit_buffers(cache, nlive, m, ncdim, dtype, device):
    """The :class:`EllipsoidRefit` of this shape from ``cache`` (a dict
    the round's proposer keeps), made there at first use."""
    key = ("refit", nlive, m, ncdim, dtype, str(device))
    rf = cache.get(key)
    if rf is None:
        rf = cache[key] = EllipsoidRefit(nlive, m, ncdim, dtype, device)
    return rf


def refit_assign(rf, u, arrays):
    """Each live point's slot into ``rf.idx``, from the points ``u``
    (nlive, ncdim) and the dispatch's ``arrays``:
    :func:`refit_assign_plain` on the CPU, on the card the
    ``refit_assign`` kernel of ``csrc/ellipsoid_refit.cu``."""
    if rf.device.type == "cpu":
        dt = rf.dtype
        _, idx = refit_assign_plain(u.to(dt), arrays["ctrs"].to(dt),
                                    arrays["ams"].to(dt), arrays["mask"])
        rf.idx.copy_(idx)
        return
    rf.check(u, arrays)
    table = rf._assign_args
    table[0], table[1], table[2], table[3] = (
        u.data_ptr(), arrays["ctrs"].data_ptr(), arrays["ams"].data_ptr(),
        arrays["mask"].data_ptr())
    _run(rf._assign_fn, table, (rf.nlive, rf.m, rf.ncdim, u.stride(0)),
         rf.device, "refit_assign")
    refit_assign.launches += 1


def refit_fit(rf, u, arrays, out):
    """Each slot re-fitted to the points ``rf.idx`` gives it, written into
    ``out`` (the wave's buffers, :data:`REFIT_FIELDS`), and the slots
    re-fitted into ``rf.keep``: :func:`refit_fit_plain` on the CPU (copied
    into ``out``), on the card the ``refit_fit`` kernel of
    ``csrc/ellipsoid_refit.cu``, which reads the points as
    :func:`refit_assign` packed them (``rf.rows``): it follows that
    launch."""
    if rf.device.type == "cpu":
        res, keep = refit_fit_plain(u, rf.idx, arrays, rf.ncdim, rf.dtype,
                                    with_keep=True)
        for k in REFIT_FIELDS:
            out[k].copy_(res[k])
        rf.keep.copy_(keep)
        return
    rf.check(u, arrays, out)
    table = rf._fit_args
    expand = arrays.get("expand")
    for i, k in enumerate(("ctrs", "axes", "ams", "logvols", "mask")):
        table[2 + i] = arrays[k].data_ptr()
        table[10 + i] = out[k].data_ptr()
    table[7] = None if expand is None else expand.data_ptr()
    _run(rf._fit_fn, table, (rf.nlive, rf.m, rf.ncdim, u.stride(0)),
         rf.device, "refit_fit")
    refit_fit.launches += 1


def ellipsoid_refit(rf, u, arrays, out):
    """The refit of the dispatch's ``arrays`` to the live points ``u``
    (nlive, ncdim; on the card a column slice of the live matrix) into
    ``out``: :func:`refit_assign`, then :func:`refit_fit`.  Device work
    only, no host read: a fused round's prologue captures it."""
    refit_assign(rf, u, arrays)
    refit_fit(rf, u, arrays, out)


WRAPPERS = (refit_assign, refit_fit)


def zero_counts():
    """Zero each wrapper's ``launches``."""
    for w in WRAPPERS:
        w.launches = 0


zero_counts()
