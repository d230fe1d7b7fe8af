"""Whole-sampler checkpointing: a pickle with a format version, written
atomically (tmp + rename).  Counterpart of ``dynesty_tpu.utils.checkpoint``
without its pool and mesh parts.  Serves the static ``Sampler`` and the
``DynamicSampler`` alike: either is one object graph that shares one
``LogLikelihood`` and one ``rstate``, and moves as a whole with its
``set_device``.

The sampler's state is host data (numpy arrays, Python scalars, the run
record, integer seeds of the device generators), so pickling is exact and
a resumed run is bit-identical to the uninterrupted one.  Device tensors
are never written: the sampler mirrors its live points to the host first
and stores its device by name.
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
FORMAT_VERSION = 2


def save_sampler(sampler, fname):
    """Atomically pickle ``sampler`` (and metadata) to ``fname``."""
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


def restore_sampler(fname, device=None):
    """Unpickle a sampler saved by :func:`save_sampler`.

    The sampler comes back on the device it was saved from, by name.  A
    checkpoint written on ``cuda`` raises where CUDA is absent; pass
    ``device='cpu'`` (or any other device) to move the run there."""
    with open(fname, "rb") as fp:
        payload = pickle.load(fp)
    format_version = payload.get("format_version")
    if format_version != FORMAT_VERSION:
        raise ValueError(
            f"Incorrect checkpoint format version {format_version} "
            f"(expected {FORMAT_VERSION})")
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
    return sampler
