"""Built-in prior transforms and analytic benchmark problems (counterpart
of ``dynesty_tpu.models``).

``priors`` holds the reference's example prior classes as torch
transforms (with a torch ``betainc`` for ``Beta``); ``problems`` packages
the analytic likelihoods used across the reference's docs and tests
(correlated Gaussian, eggbox, Gaussian shells, Rosenbrock, wedding cake,
log-gamma) with their known log-evidences.
"""

from .priors import (Prior, TopHat, Normal, ClippedNormal, LogNormal,
                     LogUniform, Beta, PriorTransform)
from .problems import (CorrelatedGaussian, Eggbox, GaussianShells,
                       Rosenbrock, WeddingCake, LogGamma)

__all__ = [
    "Prior", "TopHat", "Normal", "ClippedNormal", "LogNormal",
    "LogUniform", "Beta", "PriorTransform",
    "CorrelatedGaussian", "Eggbox", "GaussianShells", "Rosenbrock",
    "WeddingCake", "LogGamma",
]
