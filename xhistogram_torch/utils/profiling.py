"""Profiling helpers: named ranges, a trace and a timer.

Counterpart of ``xhistogram_tpu.utils.profiling``. The pipeline labels its
stages with ``scope`` under the JAX package's names (``xhistogram.canonicalize``,
``.digitize``, ``.bincount``, and ``.cuda_kernel`` for the fused kernel in
place of ``.pallas_kernel``); they show up in ``torch.profiler`` traces, such
as the one ``trace`` writes.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["scope", "trace", "measure"]

#: the file ``trace`` writes in its log directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/trace.json`` (made if missing; an earlier trace there is
    replaced): host activity, and the card's kernels where a CUDA card is
    present. Open it in ui.perfetto.dev or chrome://tracing; the pipeline's
    ``xhistogram.*`` ranges label its stages. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(os.fspath(log_dir), TRACE_FILE))


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
