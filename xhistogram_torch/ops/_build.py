"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every ``csrc/*.cu`` is compiled by one ``nvcc`` call for Hopper
(``sm_90a``) into one shared library with a plain C interface, at first
use, into ``_build/`` beside the package sources, keyed by a hash of every
file under ``csrc/`` (sources and headers) and the flags, and loaded with
``ctypes``. Nothing here runs at import time: machines
without ``nvcc`` (and the CPU tests) never call ``load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load", "BUILD_LOG"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
# No --use_fast_math / -ftz=true: subnormals must compare exactly.
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
#: nvcc's output of the build this process ran (register and shared-memory
#: use per kernel, from -Xptxas -v); empty when the library was cached.
BUILD_LOG = ""


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "xhistogram_torch are built from source at first use"
    )


#: suffix of each kernel symbol, by the data type it takes
DTYPE_SUFFIXES = ("f32", "f64", "i32", "i64")


def _declare(lib):
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix in DTYPE_SUFFIXES:
        fn = getattr(lib, f"xh_joint2_{suffix}")
        fn.argtypes = [p, p, i64, p, i32, p, i32, p, p]
        fn.restype = i32
        fn = getattr(lib, f"xh_one_input_{suffix}")
        fn.argtypes = [p, i64, i64, i64, i64, p, i32, i32, p, p]
        fn.restype = i32
    return lib


def load():
    """The loaded kernel library, built first if this source hash is new."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):  # *.cu and *.cuh
        h.update(path.name.encode())
        h.update(path.read_bytes())
    so = _BUILD_DIR / f"xh_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent or cut-off
        # build never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(
                [_nvcc(), *_FLAGS, "-o", tmp, *map(str, sources)],
                capture_output=True,
                text=True,
            )
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}"
                )
            BUILD_LOG = res.stdout + res.stderr
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    _LIB = _declare(ctypes.CDLL(str(so)))
    return _LIB
