"""Top-level ``results`` module, as in the JAX package (and the
reference's ``dynesty.results``): the :class:`Results` container and the
default progress printer."""

from .utils.results import Results, RunRecord, results_substitute
from .utils.misc import print_fn

__all__ = ["Results", "RunRecord", "results_substitute", "print_fn"]
