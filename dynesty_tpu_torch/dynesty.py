"""User-facing factories: argument resolution for the static and the
dynamic nested sampler (counterpart of ``dynesty_tpu.dynesty``).

``device`` defaults to ``'cuda'``: the sampler runs on the card unless the
caller asks for the CPU, and raises where CUDA is absent rather than fall
back.
``likelihood_mode`` is ``'torch'`` (per-point torch functions batched
with ``torch.func.vmap``), ``'vectorized'``, or ``'host'`` (any Python
callables on numpy rows, mapped on the host, over ``pool`` when one is
given: a :class:`dynesty_tpu_torch.pool.Pool`).  ``use_pool`` switches the
pool off per site (``prior_transform``, ``loglikelihood``,
``propose_point``, ``update_bound``, ``stop_function``).  ``blob=True``:
the log-likelihood returns ``(logl, blob)`` and every sample keeps its
blob (``results.blob``).  ``save_evaluation_history`` writes every
counted evaluation to the HDF5 file ``history_filename``.  ``queue_size``
is the proposal batch width.

Ported: bounds ``none``, ``single``, ``multi`` (the default), ``balls``
and ``cubes``, with bootstrap expansion; samplers ``unif``, ``rwalk``,
``slice`` and ``rslice`` (``auto``: ``unif`` for ndim < 10, ``rwalk`` up to
20, ``rslice`` above) or an ``InternalSampler`` instance, with
``periodic`` and ``reflective`` dimensions, ``walks``, ``facc``,
``slices`` and ``ncdim`` (the bound spans the first ``ncdim`` dimensions;
not with the slice samplers).  A run stopped by ``maxiter``/``maxcall``
goes on with ``run_nested(resume=True)``; ``save``/``restore`` and
``run_nested(checkpoint_file=...)`` keep it across processes, bit for bit.
A checkpoint restores on the device it was written on and raises where
that is absent, unless ``restore(fname, device='cpu')`` asks otherwise.
``DynamicNestedSampler`` takes the same arguments and allocates its live
points batch by batch (:mod:`.dynamicsampler`).  ``bound`` may also be a
user's :class:`~.bounding.Bound` subclass: without a device export it is
sampled through its ``samples`` on the host ('unif', static runs only, as
in the JAX package) or gives the proposals its ``get_random_axes``; each
sampler refits its own deep copy of it.

Both factories take the JAX package's arguments in its positional order.
The differences: ``likelihood_mode`` defaults to ``'torch'`` and ``dtype``
to ``torch.float64``, and ``device`` (keyword only) comes last.  ``mesh``
(:func:`dynesty_tpu_torch.parallel.make_mesh`) splits each batched
likelihood call by lane over its devices, the rest of a round staying on
the mesh's first device, which must be ``device``; the run's records are
those of the run without the mesh.  ``citations`` lists the references of
the chosen configuration.
"""

import torch

import numpy as np

from .internal.likelihood import LogLikelihood
from .internal.samplers import get_internal_sampler
from .parallel.mesh import check_mesh_device
from .sampler import Sampler, initialize_live_points
from .utils.misc import get_random_generator

__all__ = ["NestedSampler", "DynamicNestedSampler"]

_CORE_REFS = [
    ("Speagle (2020)", "ui.adsabs.harvard.edu/abs/2020MNRAS.493.3132S"),
    ("Koposov et al. (2024)", "doi.org/10.5281/zenodo.3348367"),
]
_NESTED_REFS = [
    ("Skilling (2004)", "ui.adsabs.harvard.edu/abs/2004AIPC..735..395S"),
    ("Skilling (2006)", "projecteuclid.org/euclid.ba/1340370944"),
]
_DYNAMIC_REFS = [
    ("Higson et al. (2019)", "doi.org/10.1007/s11222-018-9844-0"),
]
_BOUND_REFS = {
    "none": [],
    "single": [("Mukherjee, Parkinson & Liddle (2006)",
                "ui.adsabs.harvard.edu/abs/2006ApJ...638L..51M")],
    "multi": [("Feroz, Hobson & Bridges (2009)",
               "ui.adsabs.harvard.edu/abs/2009MNRAS.398.1601F")],
    "balls": [("Buchner (2016)",
               "ui.adsabs.harvard.edu/abs/2014arXiv1407.5459B"),
              ("Buchner (2017)",
               "ui.adsabs.harvard.edu/abs/2017arXiv170704476B")],
    "cubes": [("Buchner (2016)",
               "ui.adsabs.harvard.edu/abs/2014arXiv1407.5459B"),
              ("Buchner (2017)",
               "ui.adsabs.harvard.edu/abs/2017arXiv170704476B")],
}


def _get_citations(nested_type, bound, internal_sampler):
    """Printable references of a configuration: the code, nested
    sampling, dynamic sampling for ``nested_type='dynamic'``, the named
    bound's and the proposal kernel's."""
    def fmt(refs):
        return "\n".join(f"{name}: {url}" for name, url in refs)

    blocks = [("Code and Methods", _CORE_REFS),
              ("Nested Sampling", _NESTED_REFS)]
    if nested_type == "dynamic":
        blocks.append(("Dynamic Nested Sampling", _DYNAMIC_REFS))
    bound_refs = _BOUND_REFS.get(bound if isinstance(bound, str) else "",
                                 [])
    if bound_refs:
        blocks.append(("Bounding Method", bound_refs))
    sampler_refs = list(getattr(internal_sampler, "citations", []) or [])
    if sampler_refs:
        blocks.append(("Sampling Method", sampler_refs))
    return "\n\n".join(f"{title}:\n{fmt(refs)}" for title, refs in blocks)


_DEFAULT_ENLARGE = 1.25
_DEFAULT_UNIF_BOOTSTRAP = 5


def _get_enlarge_bootstrap(sample, enlarge, bootstrap):
    """Auto rules of the reference for the bound expansion."""
    if enlarge is not None and enlarge < 1:
        raise ValueError(f"enlarge must be >= 1, got {enlarge}")
    if bootstrap is not None and bootstrap != 0 and bootstrap <= 1:
        raise ValueError(f"bootstrap must be 0 or > 1, got {bootstrap}")
    if enlarge is not None and bootstrap is None:
        return enlarge, 0
    if enlarge is None and bootstrap is not None:
        return 1, bootstrap
    if enlarge is None and bootstrap is None:
        if getattr(sample, "name", None) == "unif":
            return 1, _DEFAULT_UNIF_BOOTSTRAP
        return _DEFAULT_ENLARGE, 0
    if bootstrap == 0 or enlarge == 1:
        return enlarge, bootstrap
    raise ValueError("enlarge and bootstrap together only make sense with "
                     "bootstrap=0 or enlarge=1")


def _get_nonbounded(ndim, periodic, reflective):
    """Mask that is True for dimensions with hard unit-cube boundaries;
    None when no dimension is periodic or reflective."""
    if periodic is not None and reflective is not None:
        if np.intersect1d(periodic, reflective).size > 0:
            raise ValueError("A parameter cannot be both periodic and "
                             "reflective.")
    if periodic is None and reflective is None:
        return None
    nonbounded = np.ones(ndim, dtype=bool)
    for idx in (periodic, reflective):
        if idx is not None:
            if np.max(idx) >= ndim:
                raise ValueError("periodic/reflective index >= ndim")
            nonbounded[np.asarray(idx)] = False
    return nonbounded


def _resolve_update_interval(update_interval, internal_sampler, nlive):
    if update_interval is None:
        ratio = internal_sampler.update_bound_interval_ratio
    elif isinstance(update_interval, float):
        ratio = update_interval
    elif isinstance(update_interval, int):
        ratio = update_interval / nlive
    else:
        raise ValueError(f"Invalid update_interval {update_interval}")
    return max(1, int(round(ratio * nlive)))


_USE_POOL_KEYS = ("prior_transform", "loglikelihood", "propose_point",
                  "update_bound", "stop_function")


def _parse_use_pool(use_pool):
    """Check and default the per-site pool flags.  ``propose_point`` is
    accepted for the reference's interface and has no meaning of its own:
    a round's proposals are one batch, whose host-mode likelihood calls
    follow the ``loglikelihood`` flag."""
    use_pool = dict(use_pool or {})
    for k in use_pool:
        if k not in _USE_POOL_KEYS:
            raise ValueError(
                f"Unknown use_pool key '{k}' (valid: {_USE_POOL_KEYS})")
    return {k: bool(use_pool.get(k, True)) for k in _USE_POOL_KEYS}


def _resolve_device(device):
    if device is None:
        raise ValueError("a sampler needs a device: 'cuda' (the default) "
                         "or 'cpu'")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def _common_init(loglikelihood, prior_transform, ndim, nlive, bound,
                 sample, device, periodic, reflective, walks, facc, slices,
                 ncdim, blob, likelihood_mode, pool, queue_size, rstate,
                 logl_args, logl_kwargs, ptform_args, ptform_kwargs, enlarge,
                 bootstrap, update_interval, first_update, dtype, mesh,
                 use_pool=None, save_evaluation_history=False,
                 history_filename=None):
    """Argument resolution shared by the static and the dynamic factory:
    the device, the internal sampler, the bound expansion, the wrapped
    likelihood, the pool flags, the round width, the refit cadence and
    the citations (``cite(kind)``)."""
    device = _resolve_device(device)
    if mesh is not None:
        check_mesh_device(mesh, device)
    ncdim = ncdim or ndim
    if ncdim != ndim and sample in ("slice", "rslice"):
        raise ValueError("ncdim unsupported for slice sampling")
    nonbounded = _get_nonbounded(ndim, periodic, reflective)
    internal_sampler = get_internal_sampler(
        sample, ndim, ncdim=ncdim, nonbounded=nonbounded,
        periodic=periodic, reflective=reflective, walks=walks,
        facc=facc, slices=slices)
    enlarge, bootstrap = _get_enlarge_bootstrap(internal_sampler,
                                               enlarge, bootstrap)
    first_update = dict(first_update or {})
    for k in first_update:
        if k not in ("min_ncall", "min_eff"):
            raise ValueError(f"Unrecognized first_update key {k}")
    use_pool = _parse_use_pool(use_pool)
    like = LogLikelihood(loglikelihood, prior_transform, ndim,
                         device=device, mode=likelihood_mode, blob=blob,
                         pool=pool, use_pool_logl=use_pool["loglikelihood"],
                         use_pool_ptform=use_pool["prior_transform"],
                         logl_args=logl_args, logl_kwargs=logl_kwargs,
                         ptform_args=ptform_args,
                         ptform_kwargs=ptform_kwargs, dtype=dtype,
                         save_evaluation_history=save_evaluation_history,
                         history_filename=history_filename)
    if queue_size is None:
        pool_size = getattr(pool, "njobs", None) or \
            getattr(pool, "_processes", None)
        if likelihood_mode == "host" and pool_size:
            # host mode: a round is as wide as a few tasks per worker
            queue_size = max(32, min(nlive, 8 * pool_size))
        else:
            queue_size = max(32, min(nlive, 256))
    return dict(like=like, device=device, use_pool=use_pool,
                internal_sampler=internal_sampler, enlarge=enlarge,
                bootstrap=bootstrap, first_update=first_update,
                rstate=get_random_generator(rstate), queue_size=queue_size,
                ncdim=ncdim,
                bound_update_interval=_resolve_update_interval(
                    update_interval, internal_sampler, nlive),
                cite=lambda kind: _get_citations(kind, bound,
                                                 internal_sampler))


class NestedSampler(Sampler):
    """Static nested sampler factory."""

    def __init__(self, loglikelihood, prior_transform, ndim, nlive=500,
                 bound="multi", sample="auto", periodic=None,
                 reflective=None, update_interval=None, first_update=None,
                 rstate=None, queue_size=None, pool=None, use_pool=None,
                 live_points=None, logl_args=None, logl_kwargs=None,
                 ptform_args=None, ptform_kwargs=None, enlarge=None,
                 bootstrap=None, walks=None, facc=0.5, slices=None,
                 ncdim=None, blob=False, likelihood_mode="torch",
                 mesh=None, rounds_per_dispatch=None,
                 proposal_mode="batch", dtype=torch.float64,
                 save_evaluation_history=False, history_filename=None, *,
                 device="cuda"):
        cfg = _common_init(loglikelihood, prior_transform, ndim, nlive,
                           bound, sample, device, periodic, reflective,
                           walks, facc, slices, ncdim, blob, likelihood_mode,
                           pool, queue_size, rstate, logl_args, logl_kwargs,
                           ptform_args, ptform_kwargs, enlarge, bootstrap,
                           update_interval, first_update, dtype, mesh,
                           use_pool=use_pool,
                           save_evaluation_history=save_evaluation_history,
                           history_filename=history_filename)
        live_points, logvol_init, init_ncalls = initialize_live_points(
            live_points, cfg["like"], nlive, ndim, cfg["rstate"], blob=blob)
        super().__init__(
            loglikelihood=cfg["like"], ndim=ndim, live_points=live_points,
            sampling=cfg["internal_sampler"], bounding=bound,
            device=cfg["device"], ncdim=cfg["ncdim"], rstate=cfg["rstate"],
            queue_size=cfg["queue_size"],
            bound_update_interval=cfg["bound_update_interval"],
            first_bound_update=cfg["first_update"],
            bound_bootstrap=cfg["bootstrap"], bound_enlarge=cfg["enlarge"],
            logvol_init=logvol_init,
            rounds_per_dispatch=rounds_per_dispatch or 8,
            rounds_explicit=rounds_per_dispatch is not None,
            proposal_mode=proposal_mode, dtype=dtype, blob=blob,
            cite=cfg["cite"]("static"), mesh=mesh)
        self.ncall = init_ncalls
        self.pool = pool
        self.use_pool = cfg["use_pool"]


def DynamicNestedSampler(loglikelihood, prior_transform, ndim, nlive=500,
                         bound="multi", sample="auto", periodic=None,
                         reflective=None, update_interval=None,
                         first_update=None, rstate=None, queue_size=None,
                         pool=None, use_pool=None, logl_args=None,
                         logl_kwargs=None, ptform_args=None,
                         ptform_kwargs=None, enlarge=None, bootstrap=None,
                         walks=None, facc=0.5, slices=None, ncdim=None,
                         blob=False, likelihood_mode="torch",
                         rounds_per_dispatch=None, proposal_mode="batch",
                         dtype=torch.float64, mesh=None,
                         save_evaluation_history=False,
                         history_filename=None, *, device="cuda"):
    """Dynamic nested sampler factory; the arguments are those of
    :class:`NestedSampler` less ``live_points`` (``run_nested`` takes
    them).  The implementation lives in
    :mod:`dynesty_tpu_torch.dynamicsampler`, imported here to avoid a
    cycle."""
    from .dynamicsampler import DynamicSampler
    return DynamicSampler.create(
        loglikelihood, prior_transform, ndim, nlive=nlive, bound=bound,
        sample=sample, periodic=periodic, reflective=reflective,
        update_interval=update_interval, first_update=first_update,
        rstate=rstate, queue_size=queue_size, pool=pool,
        use_pool=use_pool, logl_args=logl_args, logl_kwargs=logl_kwargs,
        ptform_args=ptform_args, ptform_kwargs=ptform_kwargs,
        enlarge=enlarge, bootstrap=bootstrap, walks=walks, facc=facc,
        slices=slices, ncdim=ncdim, blob=blob,
        likelihood_mode=likelihood_mode,
        rounds_per_dispatch=rounds_per_dispatch,
        proposal_mode=proposal_mode, dtype=dtype, mesh=mesh,
        save_evaluation_history=save_evaluation_history,
        history_filename=history_filename, device=device)


def _dynamic_restore(fname, device=None, pool=None, mesh=None):
    """The dynamic sampler saved in ``fname`` (see
    :meth:`DynamicSampler.restore`)."""
    from .dynamicsampler import DynamicSampler
    return DynamicSampler.restore(fname, device=device, pool=pool,
                                  mesh=mesh)


DynamicNestedSampler.restore = _dynamic_restore
