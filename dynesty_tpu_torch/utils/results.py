"""Run records and the immutable Results object (same schema as the JAX
package's ``dynesty_tpu.utils.results``)."""

import copy

import numpy as np

from .misc import get_random_generator, resample_equal

__all__ = ["RunRecord", "Results", "results_substitute"]

_STATIC_KEYS = [
    "id", "u", "v", "logl", "logvol", "logwt", "logz", "logzvar", "h",
    "nc", "boundidx", "it", "n", "birth", "bounditer", "scale", "blob",
    "proposal_stats",
]

# extra columns of a dynamic run: the batch index of each sample, and per
# batch its live-point count and its logl bounds
_DYNAMIC_KEYS = ["batch", "batch_nlive", "batch_logl_bounds"]

_RESULTS_KEYS = [
    "logl", "samples_it", "samples_id", "samples_n", "samples_birth",
    "samples_u", "samples_v", "samples", "niter", "ncall", "logz",
    "logzerr", "logwt", "eff", "nlive", "logvol", "information", "bound",
    "bound_iter", "samples_bound", "samples_batch", "batch_logl_bounds",
    "batch_nlive", "scale", "blob", "proposal_stats",
]


class RunRecord:
    """Append-only accumulator of per-iteration nested sampling output."""

    def __init__(self, dynamic=False):
        keys = _STATIC_KEYS + (_DYNAMIC_KEYS if dynamic else [])
        self.D = {k: [] for k in keys}

    def append(self, row):
        for k, val in row.items():
            self.D[k].append(val)

    def __getitem__(self, k):
        return self.D[k]

    def __setitem__(self, k, v):
        self.D[k] = v

    def keys(self):
        return self.D.keys()

    def __len__(self):
        return len(self.D["logl"])


class Results:
    """Immutable record of a (static or dynamic) nested sampling run."""

    _ALLOWED = set(_RESULTS_KEYS)

    def __init__(self, key_values):
        self._keys = []
        self._initialized = False
        items = key_values.items() if isinstance(key_values, dict) \
            else key_values
        for k, v in items:
            assert k not in self._keys, f"duplicate key {k}"
            assert k in Results._ALLOWED, k
            self._keys.append(k)
            setattr(self, k, copy.copy(v))
        if "proposal_stats" not in self._keys:
            self._keys.append("proposal_stats")
            setattr(self, "proposal_stats", None)
        for k in ["samples_u", "samples_id", "logl", "samples"]:
            if k not in self._keys:
                raise ValueError(f"Key {k} must be provided")
        if "nlive" in self._keys:
            self._dynamic = False
        elif "samples_n" in self._keys:
            self._dynamic = True
        else:
            raise ValueError("Results needs either nlive (static) or "
                             "samples_n (dynamic)")
        self._initialized = True

    def __setattr__(self, name, value):
        if not name.startswith("_") and self.__dict__.get("_initialized"):
            raise RuntimeError("Results is immutable")
        super().__setattr__(name, value)

    def __copy__(self):
        return Results(self.asdict().items())

    def copy(self):
        return self.__copy__()

    def __getitem__(self, name):
        if name in self._keys:
            return getattr(self, name)
        raise KeyError(name)

    def __contains__(self, key):
        return key in self._keys

    def __repr__(self):
        width = max(map(len, self._keys)) + 1
        return "\n".join(k.rjust(width) + ": " + repr(getattr(self, k))
                         for k in self._keys)

    def keys(self):
        return self._keys

    def items(self):
        return ((k, getattr(self, k)) for k in self._keys)

    def asdict(self):
        return {k: copy.copy(getattr(self, k)) for k in self._keys}

    def isdynamic(self):
        return self._dynamic

    def importance_weights(self):
        """Normalized posterior weights of each sample."""
        wt = np.exp(self["logwt"] - self["logz"][-1])
        return wt / wt.sum()

    def samples_equal(self, rstate=None):
        """Equal-weight posterior samples in random order."""
        if rstate is None:
            rstate = get_random_generator()
        return resample_equal(self["samples"], self.importance_weights(),
                              rstate=rstate)

    def summary(self):
        """Print a quick textual summary of the run."""
        lines = []
        if not self._dynamic:
            lines.append(f"nlive: {self['nlive']:d}")
        lines += [
            f"niter: {self['niter']:d}",
            f"ncall: {int(np.sum(self['ncall'])):d}",
            f"eff(%): {self['eff']:6.3f}",
            f"logz: {self['logz'][-1]:6.3f} +/- {self['logzerr'][-1]:6.3f}",
        ]
        print("Summary\n=======\n" + "\n".join(lines))


def results_substitute(results, substitutions):
    """A copy of ``results`` with existing keys overridden; substitutions
    for keys absent from ``results`` are ignored."""
    return Results({k: substitutions.get(k, v) for k, v in results.items()})
