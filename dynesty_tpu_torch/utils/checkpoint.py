"""Whole-sampler checkpointing: a pickle with a format version, written
atomically (tmp + rename).  Counterpart of ``dynesty_tpu.utils.checkpoint``
without its mesh part.  Serves the static ``Sampler`` and the
``DynamicSampler`` alike: either is one object graph that shares one
``LogLikelihood`` and one ``rstate``, and moves as a whole with its
``set_device``.

The sampler's state is host data (numpy arrays, Python scalars, the run
record, integer seeds of the device generators), so pickling is exact and
a resumed run is bit-identical to the uninterrupted one.  A user's bound
is pickled with it, live and in ``bound_list``, by reference to its class,
which must be importable where the checkpoint is restored.  Device tensors
are never written: the sampler mirrors its live points to the host first
and stores its device by name.  A pool is never written (its workers
belong to one process): ``restore_sampler(..., pool=)`` attaches one to
the sampler, its inner samplers and their likelihood.  An evaluation
history is flushed to its file before the write and is off in the
restored sampler.
"""

import os
import pickle
import shutil
import sys

import torch

from .._version import __version__

__all__ = ["save_sampler", "restore_sampler", "FORMAT_VERSION"]

# 1: static sampler with leftover/continuation records and a dispatch spec
#    that carries its refit-due ncall
# 2: the static sampler carries its bracket progress, its non-fused queue
#    and a batch's first points; a dynamic sampler holds its base sampler
#    and, while a batch is suspended, that batch's sampler
# 3: blobs (the live points', a leftover's, the records'), the pool flags
#    and the likelihood's mode, pool flags and history state; format 2
#    checkpoints load with blobs off and no pool
FORMAT_VERSION = 3
_READABLE = (2, 3)


def save_sampler(sampler, fname):
    """Atomically pickle ``sampler`` (and metadata) to ``fname``."""
    like = getattr(sampler, "loglikelihood", None)
    if like is not None:
        like.history_save()
    payload = {"sampler": sampler, "version": __version__,
               "format_version": FORMAT_VERSION}
    tmp_fname = fname + ".tmp"
    try:
        with open(tmp_fname, "wb") as fp:
            pickle.dump(payload, fp)
        try:
            os.rename(tmp_fname, fname)
        except FileExistsError:
            # rename onto an existing file fails on some platforms
            shutil.move(tmp_fname, fname)
    except BaseException:
        # leave no partial file behind, whatever stopped the write
        try:
            os.unlink(tmp_fname)
        except OSError:
            pass
        raise


def restore_sampler(fname, device=None, pool=None):
    """Unpickle a sampler saved by :func:`save_sampler`.

    The sampler comes back on the device it was saved from, by name.  A
    checkpoint written on ``cuda`` raises where CUDA is absent; pass
    ``device='cpu'`` (or any other device) to move the run there.
    ``pool`` is attached to the sampler, to its inner and batch samplers
    and to their likelihood."""
    with open(fname, "rb") as fp:
        payload = pickle.load(fp)
    format_version = payload.get("format_version")
    if format_version not in _READABLE:
        raise ValueError(
            f"Incorrect checkpoint format version {format_version} "
            f"(expected one of {_READABLE})")
    save_ver = payload.get("version")
    if save_ver != __version__:
        print(f"Warning: checkpoint written by dynesty_tpu_torch {save_ver}, "
              f"restoring with {__version__}", file=sys.stderr)
    sampler = payload["sampler"]
    target = torch.device(device if device is not None else sampler.device)
    if target.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the checkpoint's device is {target} but CUDA is not "
            "available; pass device='cpu' to restore it on the CPU")
    sampler.set_device(target)
    for obj in _samplers_to_rebind(sampler):
        obj.pool = pool
        if hasattr(obj, "mapper"):
            obj.mapper = map if pool is None else pool.map
        obj.loglikelihood.pool = pool
    return sampler


def _samplers_to_rebind(sampler):
    """The sampler and the inner samplers it holds (a dynamic sampler's
    base run and suspended batch)."""
    out = [sampler]
    for attr in ("sampler", "batch_sampler"):
        inner = getattr(sampler, attr, None)
        if inner is not None:
            out.append(inner)
    return out
