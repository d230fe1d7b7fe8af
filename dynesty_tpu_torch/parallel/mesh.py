"""A device mesh for the batched likelihood: the lanes of a proposal
round split over several devices (counterpart of
``dynesty_tpu.parallel.mesh``).

The JAX package's mesh is a sharding hint: XLA's SPMD partitioner splits
every lane-indexed operation of a round over the chips.  Eager torch has
no partitioner, and splitting every small elementwise op of a round over
devices would multiply the launches that already bound each round.  The
costly per-lane work is the user's batched likelihood, so that is what
the port splits: :func:`mesh_eval` cuts a batch by lane, evaluates each
chunk on its own device (each device on a stream of its own, fed by
non-blocking copies), and gathers the results to the mesh's first device
in lane order.  Every other op of a round stays on that first device, so
a run under a mesh gives the records of the run without one.

A :class:`Mesh` is a 1-D tuple of devices; a device may repeat (the CPU
tests use ``make_mesh(devices=["cpu"] * 8)``, as the JAX package's use an
8-device virtual CPU mesh).  It is never pickled with a sampler:
``restore(..., mesh=)`` attaches one.
"""

import torch

from ..utils.misc import tree_map

__all__ = ["make_mesh", "batch_sharding", "shard_batch", "lane_constrainer",
           "replicate", "mesh_eval", "map_chunks", "check_mesh_device",
           "Mesh", "BatchSharding", "BATCH_AXIS"]

BATCH_AXIS = "q"


class Mesh:
    """A 1-D mesh: a tuple of ``torch.device`` along the axis ``'q'``."""

    axis_names = (BATCH_AXIS,)

    def __init__(self, devices):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices

    @property
    def size(self):
        return len(self.devices)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"

    def __getstate__(self):
        return {"devices": [str(d) for d in self.devices]}

    def __setstate__(self, state):
        self.__init__(state["devices"])


def _device_key(device):
    """A device with its index made explicit (the current CUDA device for
    a bare ``'cuda'``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        index = torch.cuda.current_device() \
            if torch.cuda.is_available() else 0
        return torch.device("cuda", index)
    return device


def check_mesh_device(mesh, device):
    """Raise unless ``mesh`` is a :class:`Mesh` whose first device is
    ``device``: the sampler's device holds every op but the split
    likelihood, and the mesh's first device gathers its lanes."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a dynesty_tpu_torch.parallel Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    if _device_key(mesh.devices[0]) != _device_key(device):
        raise ValueError(f"the mesh's first device {mesh.devices[0]} is not "
                         f"the sampler's device {device}; pass device="
                         f"{str(mesh.devices[0])!r} or a mesh that starts "
                         "there")


def make_mesh(n_devices=None, devices=None):
    """A 1-D mesh over ``devices`` (default: every CUDA device, or the
    first ``n_devices`` of them).  Without CUDA and without ``devices`` it
    raises: a mesh never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "devices= (e.g. ['cpu'] * 8) for a mesh of "
                               "other devices")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} devices asked for, {count} "
                             "CUDA devices present")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(devices)


class BatchSharding:
    """How an array of ``ndim`` dimensions is split over ``mesh``: by its
    leading (lane) axis, in equal chunks, chunk ``i`` on
    ``mesh.devices[i]``.  Equal for equal meshes and ranks."""

    def __init__(self, mesh, ndim=2):
        self.mesh = mesh
        self.ndim = ndim
        self.spec = (BATCH_AXIS,) + (None,) * (ndim - 1)

    def __eq__(self, other):
        return isinstance(other, BatchSharding) and \
            (self.mesh, self.ndim) == (other.mesh, other.ndim)

    def __hash__(self):
        return hash((self.mesh, self.ndim))

    def __repr__(self):
        return f"BatchSharding({self.mesh!r}, spec={self.spec})"

    def shard_shape(self, shape):
        """The shape of one device's chunk of an array of ``shape``."""
        shape = tuple(shape)
        n = self.mesh.size
        if shape[0] % n:
            raise ValueError(f"leading size {shape[0]} does not divide by "
                             f"the mesh size {n}")
        return (shape[0] // n,) + shape[1:]

    def device_of_lane(self, shape):
        """The device that holds each lane of an array of ``shape``."""
        rows = self.shard_shape(shape)[0]
        return [self.mesh.devices[i // rows] for i in range(shape[0])]


def batch_sharding(mesh, ndim=2):
    """The sharding that splits the leading (batch) axis over ``mesh``."""
    return BatchSharding(mesh, ndim)


def shard_batch(mesh, *arrays):
    """Split each array along its leading axis over ``mesh``: a list of
    per-device chunks (chunk ``i`` on ``mesh.devices[i]``) and the
    sharding, as ``(chunks, sharding)``; a tuple of such pairs for several
    arrays, and None for None.  The leading size must divide by the mesh
    size."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        a = torch.as_tensor(a)
        sharding = batch_sharding(mesh, a.dim())
        rows = sharding.shard_shape(a.shape)[0]
        chunks = [a[i * rows:(i + 1) * rows].to(
            dev, non_blocking=dev.type == "cuda")
            for i, dev in enumerate(mesh.devices)]
        out.append((chunks, sharding))
    return out[0] if len(out) == 1 else tuple(out)


def lane_constrainer(mesh):
    """The JAX package pins per-lane state to the mesh with this; the port
    splits only the likelihood (:func:`mesh_eval`), so per-lane state stays
    where it is made.  Returns None for no mesh, else the identity."""
    if mesh is None:
        return None

    def constrain(x):
        return x

    return constrain


def replicate(mesh, x):
    """The live state, replicated in the JAX package; the port keeps it on
    the mesh's first device, where every op but the likelihood runs, so
    ``x`` (any tree) is returned as it is."""
    return x


def map_chunks(mesh, fn, parts):
    """``fn`` of each part on its device: part ``i`` goes to
    ``mesh.devices[i]`` by a non-blocking copy, and ``fn`` runs on it
    there.  A CUDA device does both on a side stream of its own, which
    first waits for the caller's stream on the part's device; the caller's
    stream on each device then waits for the side stream, so the outputs
    (trees, each on its part's device) are ready for it."""
    outs, streams = [], []
    for part, dev in zip(parts, mesh.devices):
        if dev.type != "cuda":
            streams.append(None)
            outs.append(fn(part.to(dev)))
            continue
        stream = torch.cuda.Stream(device=dev)
        streams.append(stream)
        stream.wait_stream(torch.cuda.current_stream(dev))
        if part.is_cuda and part.device != dev:
            stream.wait_stream(torch.cuda.current_stream(part.device))
        with torch.cuda.stream(stream):
            outs.append(fn(part.to(dev, non_blocking=True)))
    for out, dev, stream in zip(outs, mesh.devices, streams):
        if stream is None:
            continue
        current = torch.cuda.current_stream(dev)
        current.wait_stream(stream)
        # the outputs were allocated on the side stream: the caller's
        # stream uses them next
        tree_map(lambda t: t.record_stream(current)
                 if isinstance(t, torch.Tensor) and t.is_cuda else None, out)
    return outs


def mesh_eval(mesh, fn, u):
    """``fn(u)`` with the lanes of ``u`` split over ``mesh``: chunk ``i``
    of the leading axis goes to ``mesh.devices[i]``, ``fn`` runs on each
    chunk there (:func:`map_chunks`), and the outputs (a tensor or a
    tuple, list or dict of them, None leaves kept) are concatenated on
    ``u``'s device in lane order.  Chunks are as equal as the batch allows
    (``torch.tensor_split``).  For no mesh or a mesh of one device it is
    ``fn(u)``, with no copy."""
    if mesh is None or mesh.size == 1:
        return fn(u)
    outs = map_chunks(mesh, fn, torch.tensor_split(u, mesh.size))
    return _gather(outs, u.device)


def _gather(outs, home):
    """Concatenate per-chunk output trees on ``home`` in chunk order."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(_gather([o[i] for o in outs], home)
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _gather([o[k] for o in outs], home) for k in first}
    # a copy to the host must complete before the host reads it
    return torch.cat([torch.as_tensor(o).to(
        home, non_blocking=home.type == "cuda") for o in outs])
