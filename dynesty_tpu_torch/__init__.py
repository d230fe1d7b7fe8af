"""
dynesty_tpu_torch — the PyTorch/CUDA port of ``dynesty_tpu``.

Static and dynamic nested sampling on a torch device: the unit-cube
phase, single- and multi-ellipsoid, RadFriends and SupFriends bounds with
bootstrap expansion, uniform ('unif'), random-walk ('rwalk'), slice and
rslice proposals, batch allocation by weight function with a stopping
function, run merging (``utils.runs``), and bit-exact save/restore/resume,
with the leave-one-out nearest-neighbour distance of the friends bounds
as hand-written CUDA kernels for Hopper (``csrc/pairwise_min_dist.cu``).
The likelihood may return blobs, may be any Python callable evaluated on
the host (``likelihood_mode='host'``, over a :class:`pool.Pool`), and may
record its evaluation history.  A user's own ``bounding.Bound`` subclass
runs under every proposal kernel.  ``plotting`` draws a run's results and
its saved bounds with matplotlib.  ``models`` holds the analytic test
problems and the prior transforms; ``parallel`` the device mesh that
splits the batched likelihood by lane (``mesh=``).
Imports neither ``jax`` nor ``dynesty_tpu``.  Entry points:
``NestedSampler(...)`` and ``DynamicNestedSampler(...)``, on the card
unless ``device='cpu'`` is given.
"""

from ._version import __version__
# utils first: its namespace takes names from internal.likelihood, which
# takes its helpers from utils.misc
from . import utils
from .dynesty import DynamicNestedSampler, NestedSampler
from .internal.likelihood import LoglOutput
from . import (bounding, dynamicsampler, internal, internal_samplers,
               models, ops, parallel, plotting, pool, results)
from .utils import runs

__all__ = ["NestedSampler", "DynamicNestedSampler", "LoglOutput",
           "bounding", "dynamicsampler", "internal", "internal_samplers",
           "models", "ops", "parallel", "plotting", "pool", "results",
           "utils", "__version__"]
