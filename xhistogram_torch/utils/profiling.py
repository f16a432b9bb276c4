"""Profiling helpers: named ranges and a timer.

Counterpart of ``xhistogram_tpu.utils.profiling``. The pipeline labels its
stages with ``scope`` under the JAX package's names (``xhistogram.canonicalize``,
``.digitize``, ``.bincount``, and ``.cuda_kernel`` for the fused kernel in
place of ``.pallas_kernel``); they show up in ``torch.profiler`` traces.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["scope", "measure"]


def scope(stage):
    """A ``torch.profiler`` range named ``xhistogram.<stage>``."""
    return torch.profiler.record_function(f"xhistogram.{stage}")


def measure(fn, *args, reps=5, warmup=1):
    """Wall-clock ``fn(*args)`` to completion on its device (synchronising
    CUDA before and after each call). Returns (median_seconds, seconds)."""

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times
