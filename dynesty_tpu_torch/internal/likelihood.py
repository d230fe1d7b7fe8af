"""Batched evaluation of the user's prior transform and log-likelihood on
the sampler's device.

Two modes, as ``dynesty_tpu.internal.likelihood`` has for JAX:

* ``mode='torch'`` (default): the user functions take one point (a 1-D
  tensor) and are written with torch operations; they are batched with
  ``torch.func.vmap``.
* ``mode='vectorized'``: the user functions already take ``(N, ndim)``
  batches.

The functions must create any constant tensors they use on the sampler's
device.  Host-mode likelihoods, blobs and evaluation history are not yet
ported.
"""

import numpy as np
import torch

__all__ = ["LogLikelihood"]


class LogLikelihood:
    """Wraps user ``loglikelihood``/``prior_transform`` into batched device
    evaluation."""

    def __init__(self, loglikelihood, prior_transform, ndim, *, device,
                 mode="torch", blob=False, logl_args=None, logl_kwargs=None,
                 ptform_args=None, ptform_kwargs=None,
                 dtype=torch.float64):
        if mode not in ("torch", "vectorized"):
            raise NotImplementedError(
                f"likelihood mode '{mode}' is not yet ported")
        if blob:
            raise NotImplementedError("blobs are not yet ported")
        self.mode = mode
        self.ndim = ndim
        self.device = torch.device(device)
        self.dtype = dtype
        la, lk = tuple(logl_args or ()), dict(logl_kwargs or {})
        pa, pk = tuple(ptform_args or ()), dict(ptform_kwargs or {})
        self._logl = lambda x: loglikelihood(x, *la, **lk)
        self._ptform = lambda u: prior_transform(u, *pa, **pk)
        self.npdim = None  # learned at the first (host-driven) evaluation

    def _batch(self, u):
        if self.mode == "vectorized":
            v = self._ptform(u)
            return v, self._logl(v)

        def one_point(x):
            v = self._ptform(x)
            return v, self._logl(v)

        return torch.func.vmap(one_point)(u)

    def batch_eval(self, u, mask=None):
        """Evaluate an (N, ndim) device batch (already inside the prior
        transform's support).  Returns ``(v (N, npdim), logl (N,),
        None)``; every lane is evaluated, ``mask`` is accepted for the
        kernels' calling convention."""
        v, logl = self._batch(u)
        v = torch.as_tensor(v).to(self.dtype).reshape(u.shape[0], -1)
        logl = torch.as_tensor(logl).to(self.dtype).reshape(u.shape[0])
        return v, logl, None

    def eval_host(self, u):
        """Evaluate a numpy batch on the device and return numpy
        ``(v, logl, None)``; learns ``npdim`` and rejects nan/+inf."""
        ut = torch.as_tensor(np.asarray(u, dtype=np.float64),
                             dtype=self.dtype, device=self.device)
        v, logl, _ = self.batch_eval(ut)
        v = v.cpu().numpy().astype(np.float64)
        logl = logl.cpu().numpy().astype(np.float64)
        bad = ~(np.isfinite(logl) | np.isneginf(logl))
        if bad.any():
            i = np.nonzero(bad)[0][0]
            raise ValueError(f"The log-likelihood ({logl[i]}) at u={u[i]} "
                             f"v={v[i]} is invalid (nan or +inf).")
        if self.npdim is None:
            self.npdim = v.shape[1]
        return v, logl, None
