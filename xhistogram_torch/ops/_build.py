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
import time
from pathlib import Path

__all__ = ["load", "BUILD_LOG", "BUILD_SECONDS"]

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
#: the wall seconds of each source's nvcc in the build this process ran
#: (all started together), by file name; empty when the library was cached
BUILD_SECONDS = {}


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
#: the narrow load types of one_input (csrc/one_input_narrow.cu) and of
#: joint2's pairs of one type (csrc/joint2_narrow.cu), read at their own
#: width: float16, bfloat16 and 16-bit integers compared in float32, 8-bit
#: integers (bool as uint8) through a table of their 256 values' bins
NARROW_SUFFIXES = ("f16", "bf16", "i16", "u16", "i8", "u8")
#: the unsigned load types of one_input (csrc/one_input_unsigned.cu), read
#: at their own width and compared in int64 (uint64 flipped, x ^ 2^63); the
#: other kernels read them through their mixed entries
UNSIGNED_SUFFIXES = ("u32", "u64")
#: joint2's pairs of two load types with instantiations of their own, each
#: input read in place and compared in its own type, symbols
#: ``xh_joint2_<a>_<b>``: int64 beside a float (csrc/joint2_mixed.cu), and
#: the pairs users pass together (csrc/joint2_pairs.cu,
#: csrc/joint2_pairs_swapped.cu): each narrow type and int32 beside
#: float32, float32 beside float64 and int32 beside int64, in both orders.
#: Every other pair of two types takes ``xh_joint2_mixed``
JOINT2_PAIRS = (
    "i64_f32", "f32_i64", "i64_f64", "f64_i64",
    *(f"{s}_f32" for s in (*NARROW_SUFFIXES, "i32")),
    *(f"f32_{s}" for s in (*NARROW_SUFFIXES, "i32")),
    "f32_f64", "f64_f32", "i32_i64", "i64_i32",
)
#: the flat-slot kernel of csrc/slot.cuh, behind plan()'s factored routes
#: and direct outside the direct-row kernel's envelope, is ``xh_slot_<suffix>``
#: (csrc/slot.cu) and, for inputs with run-time stored types,
#: ``xh_slot_narrow`` (float32 and narrow data, csrc/slot_narrow.cu) and
#: ``xh_slot_mixed`` (every other mix of types, csrc/slot_mixed.cu); the
#: direct route's own kernel (csrc/direct.cuh) is ``xh_direct_rows_<suffix>``,
#: ``xh_direct_rows_narrow`` (csrc/direct_rows_narrow.cu) and
#: ``xh_direct_rows_mixed`` (csrc/direct_rows_mixed.cu)
#: the weighted kernels' accumulator classes (csrc/weights.cuh): each
#: kernel's weighted C symbol is ``xh_<kernel>_<suffix>_<class>``
WEIGHT_CLASSES = ("wf64", "wu32", "wu64")
#: the direct-row kernel's further class (csrc/direct.cuh): float weights
#: summed in float64, rows stored as float32
ROUNDED_CLASS = "wf32"


def symbols():
    """(name, argtypes) of every C entry the library defines: each kernel's
    unweighted entry and one per weight class, per suffix."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # input count, data pointers, strides (m1, m0, c1, c0 of each input),
    # thresholds, bin counts, dims (m1, m0, c1, c0), then the flat-slot
    # kernel's reduce_all and its shared-slot and cluster caps
    slot_args = [i32, p, p, p, p, p, i32, i64, i32]
    # the weights' pointer, their view's four strides, their type code
    weight_view = [p, p, i32]
    # the flat-slot kernel's: then 16 bytes of scratch for exact float sums
    slot_weights = [*weight_view, p]
    # each kernel's arguments before and after the weights' that its
    # weighted entries take, its suffixes and its weight classes
    kernels = {
        # runs: (g, n, the outer strides of a, b and the weights)
        "joint2": ([p, p, p, p, i32, p, i32, i32], [p, i32], [p],
                   DTYPE_SUFFIXES + NARROW_SUFFIXES + JOINT2_PAIRS, WEIGHT_CLASSES),
        # the coded entries take each input's stored type first
        "joint2_mixed": ([p, p, p, p, p, i32, p, i32, i32], [p, i32], [p], ("",),
                         WEIGHT_CLASSES),
        # data, dims, strides, thresholds, bins, reduce_all
        "one_input": ([p, p, p, p, i32, i32], weight_view, [p, p],
                      DTYPE_SUFFIXES + NARROW_SUFFIXES + UNSIGNED_SUFFIXES,
                      WEIGHT_CLASSES),
        "slot": (slot_args, slot_weights, [p], DTYPE_SUFFIXES, WEIGHT_CLASSES),
        # the coded entries take each input's stored type after the count
        **{f"slot_{kind}": ([i32, p, *slot_args[1:]], slot_weights, [p], ("",),
                            WEIGHT_CLASSES)
           for kind in ("mixed", "narrow")},
        "direct_rows": (slot_args[:6], weight_view, [p], DTYPE_SUFFIXES,
                        (*WEIGHT_CLASSES, ROUNDED_CLASS)),
        **{f"direct_rows_{kind}": ([i32, p, *slot_args[1:6]], weight_view, [p], ("",),
                                   (*WEIGHT_CLASSES, ROUNDED_CLASS))
           for kind in ("narrow", "mixed")},
    }
    out = []
    for kernel, (args, weight_args, tail, suffixes, classes) in kernels.items():
        for suffix in suffixes:
            name = f"xh_{kernel}_{suffix}" if suffix else f"xh_{kernel}"
            out.append((name, [*args, *tail, p]))
            out += [(f"{name}_{cls}", [*args, *weight_args, *tail, p])
                    for cls in classes]
    return out


def _declare(lib):
    for name, argtypes in symbols():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.xh_last_launch.argtypes = [ctypes.c_void_p]
    lib.xh_last_launch.restype = None
    return lib


def load():
    """The loaded kernel library, built first if this source hash is new."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
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
            log_paths = [os.path.join(tmp, f"{src.stem}.log") for src in sources]
            t0 = time.perf_counter()
            procs = []
            for src, obj, log_path in zip(sources, objs, log_paths):
                with open(log_path, "w") as log_file:
                    procs.append(subprocess.Popen(
                        [_nvcc(), *_FLAGS, "-c", "-o", obj, str(src)],
                        stdout=log_file, stderr=subprocess.STDOUT,
                    ))
            seconds = {}
            while len(seconds) < len(procs):
                for src, proc in zip(sources, procs):
                    if src.name not in seconds and proc.poll() is not None:
                        seconds[src.name] = time.perf_counter() - t0
                time.sleep(0.05)
            logs = [Path(log_path).read_text() for log_path in log_paths]
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
            BUILD_SECONDS = seconds
            os.replace(lib, so)
    _LIB = _declare(ctypes.CDLL(str(so)))
    return _LIB
