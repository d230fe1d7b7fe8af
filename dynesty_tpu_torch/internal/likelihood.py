"""Batched evaluation of the user's prior transform and log-likelihood
(counterpart of ``dynesty_tpu.internal.likelihood``).

Three modes:

* ``mode='torch'`` (default): the user functions take one point (a 1-D
  tensor) and are written with torch operations; they are batched with
  ``torch.func.vmap`` on the sampler's device.
* ``mode='vectorized'``: the user functions already take ``(N, ndim)``
  batches of device tensors.
* ``mode='host'``: any Python callables (dynesty's "any callable"
  contract).  A round hands :meth:`LogLikelihood.batch_eval` its device
  batch and the mask of the lanes it counts; only those lanes go to the
  host, as numpy rows, and are mapped point by point (over a
  :class:`~dynesty_tpu_torch.pool.Pool` when one is given), and ``v``,
  ``logl`` and the blob go back to the device.  Masked-out lanes never
  reach the user's functions and read ``logl = -inf``.

In the first two modes the functions must create any constant tensors
they use on the sampler's device.

Blobs: with ``blob=True`` the log-likelihood returns ``(logl, blob)``,
``blob`` a tensor (or array) of fixed shape, or a tuple, list or dict of
them; its shapes and dtypes are learned at the first :meth:`eval_host`.
Exceptions raised by the user's functions are re-raised after the
offending input is printed to stderr.  With ``save_evaluation_history``
every counted evaluation is appended to an HDF5 file.
"""

import sys
import traceback
import warnings

import numpy as np
import torch

from ..utils.misc import stack_blob_rows, tree_map

__all__ = ["LogLikelihood", "LoglOutput", "ShapeDtype"]


class LoglOutput:
    """Float-comparable carrier of a (logl value, blob) pair, as the
    reference's ``LoglOutput``."""

    def __init__(self, v, blob_flag):
        if blob_flag:
            self.val = float(v[0])
            self.blob = v[1]
        else:
            self.val = float(v)
            self.blob = None

    def __lt__(self, other):
        return self.val < float(other)

    def __gt__(self, other):
        return self.val > float(other)

    def __le__(self, other):
        return self.val <= float(other)

    def __ge__(self, other):
        return self.val >= float(other)

    def __float__(self):
        return self.val


class _ContextWrapper:
    """Print the offending input before a user function's exception is
    re-raised.  A class, not a closure, so that pool workers can unpickle
    it: the wrapped function travels by reference when it is defined at
    module level.  Inside ``torch.func.vmap`` the input prints as the
    whole batch (a ``BatchedTensor``)."""

    __slots__ = ("fn", "name", "args", "kwargs")

    def __init__(self, fn, name, args=(), kwargs=None):
        self.fn = fn
        self.name = name
        self.args = tuple(args or ())
        self.kwargs = dict(kwargs or {})

    def __call__(self, x):
        try:
            return self.fn(x, *self.args, **self.kwargs)
        except Exception:
            print(f"Exception while calling {self.name} function:",
                  file=sys.stderr)
            print(f"  params: {x}", file=sys.stderr)
            if self.args:
                print(f"  args: {self.args}", file=sys.stderr)
            if self.kwargs:
                print(f"  kwargs: {self.kwargs}", file=sys.stderr)
            print("  exception:", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)
            raise

    def __getstate__(self):
        return (self.fn, self.name, self.args, self.kwargs)

    def __setstate__(self, state):
        self.fn, self.name, self.args, self.kwargs = state


class ShapeDtype:
    """Shape (of one point's value) and torch dtype of one blob leaf."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return f"ShapeDtype({self.shape}, {self.dtype})"


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def _check_finite(u, v, logl):
    """Raise on a nan or +inf log-likelihood (-inf is allowed)."""
    bad = ~(np.isfinite(logl) | np.isneginf(logl))
    if bad.any():
        i = np.nonzero(bad)[0][0]
        raise ValueError(f"The log-likelihood ({logl[i]}) at u={u[i]} "
                         f"v={v[i]} is invalid (nan or +inf).")


class LogLikelihood:
    """Wraps the user's ``loglikelihood``/``prior_transform`` into batched
    evaluation for the device rounds, with blobs, host mode over an
    optional pool, exception context and evaluation history."""

    def __init__(self, loglikelihood, prior_transform, ndim, *, device,
                 mode="torch", blob=False, pool=None, logl_args=None,
                 logl_kwargs=None, ptform_args=None, ptform_kwargs=None,
                 dtype=torch.float64, save_evaluation_history=False,
                 history_filename=None, use_pool_logl=True,
                 use_pool_ptform=True):
        if mode not in ("torch", "vectorized", "host"):
            raise ValueError(f"Unknown likelihood mode '{mode}' (choose "
                             "from 'torch', 'vectorized', 'host')")
        self.mode = mode
        self.blob = bool(blob)
        self.ndim = ndim
        self.device = torch.device(device)
        self.dtype = dtype
        self.pool = pool
        # the per-site pool flags of host mode (use_pool)
        self.use_pool_logl = use_pool_logl
        self.use_pool_ptform = use_pool_ptform
        # the user's functions and their extra arguments are kept as they
        # came, so the wrapper pickles whenever they do
        self.loglikelihood = loglikelihood
        self.prior_transform = prior_transform
        self.logl_args = tuple(logl_args or ())
        self.logl_kwargs = dict(logl_kwargs or {})
        self.ptform_args = tuple(ptform_args or ())
        self.ptform_kwargs = dict(ptform_kwargs or {})
        # learned at the first (host-driven) evaluation
        self.npdim = None
        self.blob_shape_dtype = None
        # points handed to the user's functions: in host mode the
        # invocations (the counted lanes only), otherwise every lane of
        # every batch
        self.ncall_launched = 0
        # evaluation history: exactly the counted lanes are recorded
        self.save_evaluation_history = save_evaluation_history
        self.history_filename = history_filename
        self.save_every = 10000
        self.failed_save = False
        self._history_buffer = []
        self.evaluation_history_counter = 0
        if save_evaluation_history:
            if history_filename is None:
                raise ValueError("history_filename is required when "
                                 "save_evaluation_history=True")
            self.history_init()
        self._wrap_callables()

    def _wrap_callables(self):
        self._logl = _ContextWrapper(self.loglikelihood, "loglikelihood",
                                     self.logl_args, self.logl_kwargs)
        self._ptform = _ContextWrapper(self.prior_transform,
                                       "prior_transform", self.ptform_args,
                                       self.ptform_kwargs)

    # -- pickling: the pool and the history switch are dropped; the pool
    # is re-attached by ``restore(..., pool=)``

    def __getstate__(self):
        state = self.__dict__.copy()
        state["device"] = str(self.device)  # stored by name
        state["pool"] = None
        state["save_evaluation_history"] = False
        state["_history_buffer"] = []
        for k in ("_logl", "_ptform"):
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        # checkpoints written before blobs, host mode and history existed
        for k, v in (("blob", False), ("pool", None), ("use_pool_logl", True),
                     ("use_pool_ptform", True), ("blob_shape_dtype", None),
                     ("ncall_launched", 0), ("save_evaluation_history", False),
                     ("history_filename", None), ("save_every", 10000),
                     ("failed_save", False), ("_history_buffer", []),
                     ("evaluation_history_counter", 0)):
            state.setdefault(k, v)
        self.__dict__ = state
        self.device = torch.device(state["device"])
        self._wrap_callables()

    # -- device modes

    def _eval_device(self, u):
        """``(v, logl, blob)`` of an (N, ndim) device batch, every lane
        evaluated."""
        ptform, logl_fn, blob_flag = self._ptform, self._logl, self.blob
        if self.mode == "vectorized":
            v = ptform(u)
            out = logl_fn(v)
        else:
            def one_point(x):
                v = ptform(x)
                return (v,) + tuple(logl_fn(v)) if blob_flag \
                    else (v, logl_fn(v))

            v, *out = torch.func.vmap(one_point)(u)
            out = tuple(out) if blob_flag else out[0]
        lv, blob = out if blob_flag else (out, None)
        n = u.shape[0]
        v = torch.as_tensor(v).to(self.dtype).reshape(n, -1)
        lv = torch.as_tensor(lv).to(self.dtype).reshape(n)
        return v, lv, blob

    # -- host mode

    def _host_eval_np(self, u):
        """Map the user's functions over the numpy rows of ``u`` on the
        host (over the pool where its per-site flags say so); returns numpy
        ``(v, logl, blob or None)``."""
        pool = self.pool
        pt_map = pool.map if pool is not None and self.use_pool_ptform \
            else map
        ll_map = pool.map if pool is not None and self.use_pool_logl \
            else map
        v = np.array(list(pt_map(self._ptform, u)),
                     dtype=np.float64).reshape(len(u), -1)
        raw = list(ll_map(self._logl, v))
        self.ncall_launched += len(u)
        if self.blob:
            logl = np.array([float(r[0]) for r in raw])
            blob = stack_blob_rows(r[1] for r in raw)
        else:
            logl = np.array([float(r) for r in raw])
            blob = None
        _check_finite(u, v, logl)
        return v, logl, blob

    def blob_zeros(self, n, device=None):
        """A zero blob for ``n`` points on ``device`` (default: the
        sampler's), or None without blobs."""
        if not self.blob:
            return None
        if self.blob_shape_dtype is None:
            raise RuntimeError("the blob's shape is learned at the first "
                               "eval_host; none has run yet")
        device = self.device if device is None else device
        return tree_map(lambda sd: torch.zeros((n,) + sd.shape,
                                               dtype=sd.dtype, device=device),
                        self.blob_shape_dtype)

    def _eval_host_mode(self, u, mask):
        """Host mode for a device batch: only the lanes of ``mask`` are
        copied to the host and evaluated; ``v``, ``logl`` and the blob go
        back to ``u``'s device, the other lanes at 0 / -inf / 0."""
        if self.npdim is None:
            raise RuntimeError("a host-mode likelihood must be probed with "
                               "eval_host before a device round")
        n, dev = u.shape[0], u.device
        v = torch.zeros((n, self.npdim), dtype=self.dtype, device=dev)
        logl = torch.full((n,), -np.inf, dtype=self.dtype, device=dev)
        blob = self.blob_zeros(n, dev)
        um = (u if mask is None else u[mask]).cpu().numpy()
        if len(um):
            vm, loglm, blobm = self._host_eval_np(um)
            sel = slice(None) if mask is None else mask
            v[sel] = torch.as_tensor(vm, dtype=self.dtype, device=dev)
            logl[sel] = torch.as_tensor(loglm, dtype=self.dtype, device=dev)
            tree_map(lambda b, bm: b.__setitem__(
                sel, torch.as_tensor(bm, dtype=b.dtype, device=dev)),
                blob, blobm)
            if self.save_evaluation_history:
                self.append_evaluation_history(um, vm, loglm)
        return v, logl, blob

    # -- public API

    def batch_eval(self, u, mask=None):
        """Evaluate an (N, ndim) device batch (already inside the prior
        transform's support).  Returns ``(v (N, npdim), logl (N,), blob
        (N, ...) or None)`` on ``u``'s device.

        ``mask`` marks the lanes whose evaluation the round counts.  In
        host mode only those reach the user's functions (the others read
        ``logl = -inf``); the device modes evaluate every lane, the lanes
        are free there.  The history records exactly the masked lanes."""
        if self.mode == "host":
            return self._eval_host_mode(u, mask)
        v, logl, blob = self._eval_device(u)
        self.ncall_launched += u.shape[0]
        if self.save_evaluation_history:
            sel = slice(None) if mask is None else mask
            self.append_evaluation_history(*(
                x[sel].cpu().numpy() for x in (u, v, logl)))
        return v, logl, blob

    def eval_host(self, u):
        """Evaluate a numpy batch (live-point initialisation) and return
        numpy ``(v, logl, blob or None)``; learns ``npdim`` and the blob's
        shapes and dtypes, and rejects nan/+inf."""
        u = np.asarray(u, dtype=np.float64)
        if self.mode == "host":
            v, logl, blob = self._host_eval_np(u)
        else:
            ut = torch.as_tensor(u, dtype=self.dtype, device=self.device)
            v, logl, blob = self._eval_device(ut)
            self.ncall_launched += len(u)
            v = v.cpu().numpy().astype(np.float64)
            logl = logl.cpu().numpy().astype(np.float64)
            blob = tree_map(lambda b: torch.as_tensor(b).cpu().numpy(),
                            blob)
            _check_finite(u, v, logl)
        if self.npdim is None:
            self.npdim = v.shape[1]
        if self.blob and self.blob_shape_dtype is None:
            self.blob_shape_dtype = tree_map(
                lambda b: ShapeDtype(b.shape[1:], _torch_dtype(b.dtype)),
                blob)
        if self.save_evaluation_history:
            self.append_evaluation_history(u, v, logl)
        return v, logl, blob

    # -- evaluation history (HDF5)

    def history_init(self):
        """Create (truncate) the HDF5 file; its datasets are made at the
        first flush, once the shapes are known."""
        import h5py

        self.evaluation_history_counter = 0
        with h5py.File(self.history_filename, mode="w"):
            pass

    def append_evaluation_history(self, u, v, logl):
        """Buffer a batch of evaluations; flush when the buffer is
        large."""
        if not self.save_evaluation_history or not len(logl):
            return
        self._history_buffer.append(
            (np.atleast_2d(u), np.atleast_2d(v), np.atleast_1d(logl)))
        if sum(len(b[2]) for b in self._history_buffer) > self.save_every:
            self.history_save()

    def history_save(self):
        """Flush the buffered evaluations to the HDF5 file."""
        if self.failed_save or not self.save_evaluation_history or \
                not self._history_buffer:
            return
        import h5py

        try:
            parts = [np.concatenate([b[j] for b in self._history_buffer])
                     for j in range(3)]
            n = len(parts[2])
            with h5py.File(self.history_filename, mode="a") as fp:
                for name, arr in zip(("evaluation_u", "evaluation_v",
                                      "evaluation_logl"), parts):
                    if name not in fp:
                        # in the evaluations' own dtype: h5py's default
                        # (float32) would round them
                        fp.create_dataset(name, (0,) + arr.shape[1:],
                                          maxshape=(None,) + arr.shape[1:],
                                          dtype=arr.dtype)
                    ds = fp[name]
                    ds.resize(self.evaluation_history_counter + n, axis=0)
                    ds[-n:] = arr
            self._history_buffer = []
            self.evaluation_history_counter += n
        except OSError:
            warnings.warn("Failed to save the evaluation history; will "
                          "not try again.")
            self.failed_save = True

    def finalize_history(self):
        self.history_save()
