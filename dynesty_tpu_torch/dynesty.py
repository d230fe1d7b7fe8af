"""User-facing factory: argument resolution for the static nested sampler
(counterpart of ``dynesty_tpu.dynesty``).

``device`` defaults to ``'cuda'``: the sampler runs on the card unless the
caller asks for the CPU, and raises where CUDA is absent rather than fall
back.
``likelihood_mode`` is ``'torch'`` (per-point torch functions batched
with ``torch.func.vmap``) or ``'vectorized'``.  ``queue_size`` is the
proposal batch width.

Ported: bounds ``none``, ``single``, ``multi`` (the default), ``balls``
and ``cubes``, with bootstrap expansion; samplers ``unif`` and
``rslice``, and ``auto`` where it resolves to one of them (``unif`` for
ndim < 10, ``rslice`` above 20).  So the defaults run: for ndim < 10,
``bound='multi', sample='unif'`` with ``bootstrap=5``.  ``rwalk``,
``slice``, custom bounds, blobs, pools, host-mode likelihoods and the
dynamic sampler are not yet ported and raise ``NotImplementedError``.
"""

import torch

from .internal.likelihood import LogLikelihood
from .internal.samplers import get_internal_sampler
from .sampler import Sampler, initialize_live_points
from .utils.misc import get_random_generator

__all__ = ["NestedSampler"]

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


def _resolve_device(device):
    if device is None:
        raise ValueError("NestedSampler needs a device: 'cuda' (the "
                         "default) or 'cpu'")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


class NestedSampler(Sampler):
    """Static nested sampler factory."""

    def __init__(self, loglikelihood, prior_transform, ndim, nlive=500,
                 bound="multi", sample="auto", *, device="cuda",
                 update_interval=None, first_update=None, rstate=None,
                 queue_size=None, live_points=None, logl_args=None,
                 logl_kwargs=None, ptform_args=None, ptform_kwargs=None,
                 enlarge=None, bootstrap=None, slices=None, ncdim=None,
                 blob=False, likelihood_mode="torch",
                 rounds_per_dispatch=None, proposal_mode="batch",
                 dtype=torch.float64, pool=None):
        if pool is not None:
            raise NotImplementedError("pools are not yet ported")
        device = _resolve_device(device)
        ncdim = ncdim or ndim
        if ncdim != ndim:
            raise NotImplementedError("ncdim != ndim is not yet ported")
        internal_sampler = get_internal_sampler(sample, ndim, slices=slices)
        enlarge, bootstrap = _get_enlarge_bootstrap(internal_sampler,
                                                   enlarge, bootstrap)
        first_update = dict(first_update or {})
        for k in first_update:
            if k not in ("min_ncall", "min_eff"):
                raise ValueError(f"Unrecognized first_update key {k}")
        rstate = get_random_generator(rstate)
        like = LogLikelihood(loglikelihood, prior_transform, ndim,
                             device=device, mode=likelihood_mode, blob=blob,
                             logl_args=logl_args, logl_kwargs=logl_kwargs,
                             ptform_args=ptform_args,
                             ptform_kwargs=ptform_kwargs, dtype=dtype)
        if queue_size is None:
            queue_size = max(32, min(nlive, 256))
        live_points, logvol_init, init_ncalls = initialize_live_points(
            live_points, like, nlive, ndim, rstate)
        super().__init__(
            loglikelihood=like, ndim=ndim, live_points=live_points,
            sampling=internal_sampler, bounding=bound, device=device,
            ncdim=ncdim, rstate=rstate, queue_size=queue_size,
            bound_update_interval=_resolve_update_interval(
                update_interval, internal_sampler, nlive),
            first_bound_update=first_update, bound_bootstrap=bootstrap,
            bound_enlarge=enlarge, logvol_init=logvol_init,
            rounds_per_dispatch=rounds_per_dispatch or 8,
            rounds_explicit=rounds_per_dispatch is not None,
            proposal_mode=proposal_mode, dtype=dtype)
        self.ncall = init_ncalls

