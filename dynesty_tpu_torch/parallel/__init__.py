"""Multi-device split of the proposal batch (counterpart of
``dynesty_tpu.parallel``).

The reference's only parallelism axis is its proposal queue mapped over a
process pool (``pool.py``, SURVEY §2.2); here the same axis is the lanes of
each proposal round, whose batched user likelihood is split over a mesh
of devices (:func:`~.mesh.mesh_eval`) while the host orchestration and
every other op of a round stay on the mesh's first device.
"""

from .mesh import make_mesh, shard_batch, batch_sharding
from .telemetry import scaling_report

__all__ = ["make_mesh", "shard_batch", "batch_sharding", "scaling_report"]
