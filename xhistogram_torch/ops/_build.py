"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, at first use, into
``_build/`` beside the package sources, keyed by a hash of every file
under ``csrc/`` (sources and headers) and the flags, and loaded with
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
#: the flat-slot routes of csrc/slot.cuh, each its own C symbol
#: ``xh_<route>_<suffix>`` (csrc/factored.cu, csrc/direct.cu)
SLOT_ROUTES = ("factored_full", "factored_per_row", "factored_packed", "direct")
#: the weighted kernels' accumulator classes (csrc/weights.cuh): each
#: kernel's weighted C symbol is ``xh_<kernel>_<suffix>_<class>``
WEIGHT_CLASSES = ("wf64", "wu32", "wu64")


def _declare(lib):
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # each kernel's arguments, and the weights' (pointer, strides, type code)
    # that its weighted entries take before the output
    kernels = {
        "joint2": ([p, p, i64, p, i32, p, i32], [p, i32]),
        "one_input": ([p, i64, i64, i64, i64, p, i32, i32], [p, i64, i64, i32]),
        **{route: ([i32, p, p, p, p, i64, i64, i64], [p, i64, i64, i32])
           for route in SLOT_ROUTES},
    }
    for suffix in DTYPE_SUFFIXES:
        for kernel, (args, weight_args) in kernels.items():
            fn = getattr(lib, f"xh_{kernel}_{suffix}")
            fn.argtypes = [*args, p, p]
            fn.restype = i32
            for cls in WEIGHT_CLASSES:
                fn = getattr(lib, f"xh_{kernel}_{suffix}_{cls}")
                fn.argtypes = [*args, *weight_args, p, p]
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
        # build in a temporary directory, then rename: a concurrent or
        # cut-off build never leaves a half-written library under the final
        # name
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, f"{src.stem}.o") for src in sources]
            procs = [
                subprocess.Popen(
                    [_nvcc(), *_FLAGS, "-c", "-o", obj, str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for src, obj in zip(sources, objs)
            ]
            logs = [proc.communicate()[0] for proc in procs]
            failed = [(src.name, proc.returncode, log)
                      for src, proc, log in zip(sources, procs, logs)
                      if proc.returncode != 0]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(
                    f"{name} ({rc}):\n{log}" for name, rc, log in failed))
            lib = os.path.join(tmp, so.name)
            res = subprocess.run(
                [_nvcc(), "-shared", "-o", lib, *objs],
                capture_output=True, text=True,
            )
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({res.returncode}):\n{res.stdout}{res.stderr}"
                )
            BUILD_LOG = "".join(logs) + res.stdout + res.stderr
            os.replace(lib, so)
    _LIB = _declare(ctypes.CDLL(str(so)))
    return _LIB
