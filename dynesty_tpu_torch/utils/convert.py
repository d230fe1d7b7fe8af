"""State carried across between the JAX package and the port.

The system has no weights: its state is the packed live-point matrix
(``u | v | logl | it | bound | birth``), the bound, and the integrator
carry.  These functions take numpy arrays exactly as
``dynesty_tpu`` holds or produces them and build the port's device
tensors and bound objects; :func:`to_numpy` goes back.  The sampler uses
them for its own uploads, and the parity tests use them so both packages
start from identical state.
"""

import numpy as np
import torch

from ..bounding import Ellipsoid, RadFriends, SupFriends
from ..internal.kernels import pad_ellipsoids

__all__ = ["live_to_torch", "bound_arrays_to_torch", "bound_from_arrays",
           "integ_from_vector", "to_numpy"]

# f32-safe stand-in for the -1e300 "-inf" sentinel in the live matrix
_CLAMP = -1e30


def live_to_torch(live_packed, device, dtype=torch.float64, ndim=None,
                  npdim=None):
    """The packed (nlive, ndim + npdim + 4) live matrix as a device
    tensor.  With ``ndim``/``npdim`` given, the logl and birth columns
    are clamped at -1e30 as the samplers do before an upload."""
    arr = np.array(live_packed, dtype=np.float64)
    if ndim is not None:
        il = ndim + npdim
        arr[:, il] = np.maximum(arr[:, il], _CLAMP)
        arr[:, il + 3] = np.maximum(arr[:, il + 3], _CLAMP)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def bound_arrays_to_torch(kind, arrays, device, dtype=torch.float64):
    """A bound's ``device_spec()`` arrays as the device dict the fused
    rounds take (ellipsoid stacks are padded to a power of two with a
    validity mask)."""
    if kind == "cube":
        return {}
    if kind == "ellipsoids":
        arrays = pad_ellipsoids(arrays["ctrs"], arrays["axes"],
                                arrays["ams"], arrays["logvols"])
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        out[k] = torch.as_tensor(
            v, dtype=torch.bool if v.dtype == bool else dtype,
            device=device)
    return out


def bound_from_arrays(kind, ndim, arrays, device=None):
    """The port's bound object from numpy arrays of a fitted bound.

    ``kind='ellipsoids'`` takes ``ctr``, ``cov``, ``am``, ``axes``;
    ``'balls'``/``'cubes'`` take ``cov``, ``am``, ``axes``, ``axes_inv``,
    ``ctrs`` (the attributes of the JAX package's bounds).  An optional
    ``logvol`` is carried as is; otherwise it is recomputed."""
    if kind == "ellipsoids":
        bound = Ellipsoid(ndim, ctr=arrays["ctr"], cov=arrays["cov"],
                          am=arrays["am"], axes=arrays["axes"])
    else:
        cls = {"balls": RadFriends, "cubes": SupFriends}[kind]
        bound = cls(ndim, device=device)
        for k in ("cov", "am", "axes", "axes_inv", "ctrs"):
            setattr(bound, k, np.array(arrays[k], dtype=np.float64))
        bound.logvol = bound._kernel_logvol()
    if "logvol" in arrays:
        bound.logvol = float(arrays["logvol"])
    return bound


def integ_from_vector(ctrl, device, dtype=torch.float64):
    """The integrator carry of a control vector (``ctrl[0:9]`` =
    logz, logzvar, h, logvol, loglstar, plateau_mode, plateau_counter,
    plateau_logdvol, it) as device scalars."""
    c = torch.as_tensor(np.asarray(ctrl[:9], dtype=np.float64),
                        dtype=dtype, device=device)
    return {"logz": c[0], "logzvar": c[1], "h": c[2], "logvol": c[3],
            "loglstar": c[4], "plateau_mode": c[5] > 0.5,
            "plateau_counter": c[6].to(torch.int64),
            "plateau_logdvol": c[7], "it": c[8].to(torch.int64)}


def to_numpy(x):
    """Tensors (or nested tuples/lists/dicts of them) as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x
