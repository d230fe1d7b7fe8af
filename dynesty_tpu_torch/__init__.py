"""
dynesty_tpu_torch — the PyTorch/CUDA port of ``dynesty_tpu``.

Static nested sampling on a torch device: the unit-cube phase, RadFriends,
SupFriends or single-ellipsoid bounds, and rslice proposals, with the
leave-one-out nearest-neighbour distance of the friends bounds as a
hand-written CUDA kernel for Hopper (``csrc/pairwise_min_dist.cu``).
Imports neither ``jax`` nor ``dynesty_tpu``.  Entry point:
``NestedSampler(..., device=...)``.
"""

from .dynesty import NestedSampler
from . import bounding, internal, ops, utils

__version__ = "0.1.0"

__all__ = ["NestedSampler", "bounding", "internal", "ops", "utils",
           "__version__"]
