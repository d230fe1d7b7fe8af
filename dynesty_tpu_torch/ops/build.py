"""Lazy build of the hand-written CUDA kernels in ``dynesty_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C entry point; ``nvcc`` compiles it
for Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at
the root of the checkout, loaded with ``ctypes``.  The library name
carries a hash of the source and the flags, so an edited source is
rebuilt.  Nothing is compiled at import time: the first CUDA call builds.

Set ``DYNESTY_TPU_TORCH_NO_BUILD=1`` to forbid building (a kernel call on
a CUDA tensor then raises).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_log"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS = {}
# per-library record of the last build: seconds and the compiler's output
build_log = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the Hopper kernels")
    return found


def load_library(name, src=None):
    """The loaded ``ctypes`` library built from ``src`` (by default
    ``csrc/<name>.cu``)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if os.environ.get("DYNESTY_TPU_TORCH_NO_BUILD"):
        raise RuntimeError(f"building kernel '{name}' is disabled "
                           "(DYNESTY_TPU_TORCH_NO_BUILD is set)")
    src = Path(src) if src is not None else SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        # the compiler's report (-Xptxas -v) beside the library, for a
        # later process that finds the library built
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "output": proc.stdout + proc.stderr}
    else:
        log = out.with_suffix(".log")
        build_log[name] = {"seconds": 0.0, "output": "(cached)\n" + (
            log.read_text() if log.exists() else "")}
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
