"""
dynesty_tpu_torch — the PyTorch/CUDA port of ``dynesty_tpu``.

Static nested sampling on a torch device: the unit-cube phase, single-
and multi-ellipsoid, RadFriends and SupFriends bounds with bootstrap
expansion, uniform ('unif'), random-walk ('rwalk'), slice and rslice
proposals, and bit-exact save/restore/resume, with the leave-one-out nearest-neighbour distance of the friends bounds as
hand-written CUDA kernels for Hopper (``csrc/pairwise_min_dist.cu``).
Imports neither ``jax`` nor ``dynesty_tpu``.  Entry point:
``NestedSampler(...)``, on the card unless ``device='cpu'`` is given.
"""

from ._version import __version__
from .dynesty import NestedSampler
from . import bounding, internal, ops, utils

__all__ = ["NestedSampler", "bounding", "internal", "ops", "utils",
           "__version__"]
