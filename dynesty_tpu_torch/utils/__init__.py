"""Host utilities: results containers, run algebra, RNG, checkpointing,
progress printing and state conversion.

The names are the JAX package's ``dynesty_tpu.utils`` (the reference's
``dynesty.utils`` namespace), with one exception: ``get_jax_key`` has no
meaning here, and :func:`get_torch_generator` (a ``torch.Generator`` on a
device, seeded from a numpy ``rstate``) stands in its place.
"""

from .results import Results, RunRecord, results_substitute
from .misc import (
    get_random_generator,
    get_seed_sequence,
    get_torch_generator,
    mean_and_cov,
    quantile,
    resample_equal,
    DelayTimer,
    IteratorResult,
    IteratorResultShort,
    print_fn,
    print_fn_fallback,
    print_fn_tqdm,
    get_print_fn_args,
    PrintFnArgs,
    get_print_func,
    SQRTEPS,
    SamplerHistoryItem,
)
from .runs import (
    jitter_run,
    resample_run,
    reweight_run,
    unravel_run,
    merge_runs,
    kld_error,
    check_result_static,
)
from .checkpoint import save_sampler, restore_sampler
from ..ops.integrals import (compute_integrals, progress_integration,
                             get_neff_from_logwt, LOWL_VAL)
from ..ops.geometry import unitcheck, apply_reflect, randsphere
from ..internal.likelihood import LogLikelihood, LoglOutput


def get_nonbounded(ndim, periodic, reflective):
    """Boolean mask, True for ordinary dimensions and False for periodic
    or reflective ones; None when neither is given."""
    from ..dynesty import _get_nonbounded
    return _get_nonbounded(ndim, periodic, reflective)


__all__ = [
    "Results",
    "RunRecord",
    "results_substitute",
    "get_random_generator",
    "get_seed_sequence",
    "get_torch_generator",
    "mean_and_cov",
    "quantile",
    "resample_equal",
    "DelayTimer",
    "IteratorResult",
    "print_fn",
    "get_print_func",
    "jitter_run",
    "resample_run",
    "reweight_run",
    "unravel_run",
    "merge_runs",
    "kld_error",
    "check_result_static",
    "save_sampler",
    "restore_sampler",
    "compute_integrals",
    "progress_integration",
    "get_neff_from_logwt",
    "LOWL_VAL",
    "unitcheck",
    "apply_reflect",
    "randsphere",
    "LogLikelihood",
    "LoglOutput",
    "get_nonbounded",
]
