"""Where the time of the port's one-input path goes, on one CUDA card.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/one_input_probe.py [--root DIR] [--year-only]

``--root`` imports ``xhistogram_torch`` from another checkout (for example
a parent commit unpacked with ``git archive``), so two versions can be
measured in turns within one run on one card; ``--year-only`` measures the
per-cell year alone.

It prints, each line beside the card's name and power limit, and as one
JSON line at the end, for each one_input cell: BASELINE config 1 (10^8
float32, 50 bins, every axis reduced), config 2 with U(0,1) float32 weights
((1000, 100000), 50 bins, kept rows), 2^30 N(0,1) values in 64 bins as
float32, bfloat16, int16 (8000 N(0,1) rounded, 64 bins over
[-32768, 32768)) and int8 (30 N(0,1) rounded, in 64 bins over
[-128, 128)), and config 4 ((365, 180, 360) float32, ``axis=0``, 80 bins,
strided kept rows), and the per-cell year ((365, 720, 1440) float32, 29% of
the cells NaN land, ``axis=0``, 80 bins on [-2, 38]: 1,036,800 kept rows,
unweighted and with float32 weights):

- the kernel's launch: its counter layout, copies, cells K and widest
  window L (``cuda_hist.last_launch()``);
- the breakdown of its device time (CUDA events): the read alone (a
  ``sum()`` over the same data, and weights), the read and the search with
  nothing counted (the data above every edge), the whole kernel (the
  counts added, then flushed), and a launch at 2^19 elements of the same
  data, which is little more than the prologue (thresholds, cell table)
  and the flush of every block;
- the bytes' bound at 3.35 TB/s;
- for the narrow rows, what the path cost before the kernel read them in
  place: a widening copy to float32 or int32, then the kernel on it.

Then, for config 1, config 4 and the year, the public call's host time
from the call to its return with the card idle, and over back-to-back
calls their wall time against the device time of the kernel's own
launches in the same calls (the device's idle share); for the year also
the public call (CUDA events) against the plain scatter path
(``method="scatter"``), unweighted and weighted, and the op's whole device
time a call (``cuda_hist.one_input``: its output's allocation, any zero
fill or memset of it, and the kernel; CUDA events over back-to-back calls),
split by device op under ``torch.profiler``. It imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG1 = (1000, 100_000)
SST = (365, 180, 360)
YEAR = (365, 720, 1440)
N_ROW = 1 << 30
N_SMALL = 1 << 19
BACK_TO_BACK = 50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def event_ms(fn, reps=10):
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sst_year(dev, gen):
    """A year of daily 0.25-degree SST with land (29% of the cells, smooth
    blobs) NaN every day, as the benchmark's ``sst_025deg_year`` lays it."""
    lat = torch.deg2rad(torch.linspace(-89.875, 89.875, YEAR[1], device=dev))[:, None]
    lon = torch.deg2rad(torch.linspace(0.125, 359.875, YEAR[2], device=dev))[None, :]
    field = torch.sin(3 * lat) * torch.cos(2 * lon) + 0.5 * torch.sin(5 * lon + 1) * torch.cos(lat)
    land = field > torch.quantile(field.reshape(-1), 0.71)
    x = torch.randn(YEAR, device=dev, generator=gen)
    x.mul_(0.6).add_(28 - 30 * torch.sin(lat) ** 2).clamp_min_(-1.8)
    return x.masked_fill_(land, float("nan"))


def op_split(run, reps):
    """Device milliseconds a call of ``run()`` by device op (kernels, fills
    and memsets), from ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return {e.key[:100]: e.device_time_total / reps / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("one_input_probe.py needs a CUDA card")
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=None)
    p.add_argument("--year-only", action="store_true")
    args = p.parse_args()
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    import xhistogram_torch
    if not os.path.dirname(xhistogram_torch.__file__).startswith(root):
        raise SystemExit(f"imported {xhistogram_torch.__file__}, not from {root}")
    from xhistogram_torch import core
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.ops import _build, cuda_hist
    from xhistogram_torch.utils.axes import canonicalize_2d

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"# root {root} | card: {card} | torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    _build.load()
    result = {"root": root, "card": card, "cells": {}}

    def thresholds(edges, x):
        return torch.from_numpy(compare_form(edges, core._compare_dtype(x)).edges).to(dev)

    def breakdown(label, x2d, edges, above_edges, reduce_all, weights=None,
                  widen=None):
        """The kernel's time, broken down, at one cell."""
        nb = len(edges) - 1
        thr, thr_above = thresholds(edges, x2d), thresholds(above_edges, x2d)
        run = lambda t: cuda_hist.one_input(x2d, t, nb, reduce_all, weights=weights)  # noqa: E731
        run(thr)
        torch.cuda.synchronize()
        launch = cuda_hist.last_launch()
        in_bytes = x2d.numel() * x2d.element_size()
        if weights is not None:
            in_bytes += weights.numel() * weights.element_size()
        out_bytes = 8 * (1 if reduce_all else x2d.shape[0]) * (nb + 1)
        if reduce_all:
            small = x2d.reshape(-1)[:N_SMALL].reshape(1, -1)
        else:
            small = x2d[:, : max(1, N_SMALL // x2d.shape[0])]
        w_small = None if weights is None else weights[:, : small.shape[1]]
        row = {
            "layout": launch["layout"], "copies": launch["copies"],
            "K": launch["cells"][0], "L": launch["widest"],
            "read_ms": event_ms(lambda: (x2d.sum(), None if weights is None
                                         else weights.sum())),
            "search_ms": event_ms(lambda: run(thr_above)),
            "kernel_ms": event_ms(lambda: run(thr)),
            "prologue_flush_ms": event_ms(lambda: cuda_hist.one_input(
                small, thr, nb, reduce_all, weights=w_small)),
            "bound_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
        }
        if widen is not None:
            thr_wide = thr.to(widen)
            row["widened_copy_and_kernel_ms"] = event_ms(
                lambda: cuda_hist.one_input(x2d.to(widen), thr_wide, nb, reduce_all))
        result["cells"][label] = row
        print(f"# {label}: {launch['layout']} ({launch['copies']} copies), K="
              f"{row['K']} L={row['L']}; read alone {row['read_ms']:.4f} ms, read and "
              f"searched (above every edge) {row['search_ms']:.4f}, kernel "
              f"{row['kernel_ms']:.4f}, 2^19 elements (prologue and flush) "
              f"{row['prologue_flush_ms']:.4f}, bound {row['bound_ms']:.4f} ms "
              f"({in_bytes / 1e9:.3f} GB read)"
              + (f"; widening copy then kernel {row['widened_copy_and_kernel_ms']:.4f} ms"
                 if widen is not None else "") + f" [{card}]")

    def year_cells(gen):
        year = sst_year(dev, gen)
        e_year = np.linspace(-2, 38, 81).astype(np.float32)
        layout = canonicalize_2d(year, (0,))
        label = f"year, {tuple(layout.shape)} strides {layout.stride()} float32, 80 bins"
        breakdown(label, layout, e_year, e_year - 100, False)
        thr = thresholds(e_year, layout)
        run = lambda: cuda_hist.one_input(layout, thr, 80, False)  # noqa: E731
        op_ms = event_ms(run, reps=BACK_TO_BACK)
        split = op_split(run, BACK_TO_BACK)
        result["year_op"] = {"op_ms": op_ms, "by_device_op_ms": split}
        print(f"# year op, the whole call on the card (output allocation, any zero "
              f"fill or memset, kernel), {BACK_TO_BACK} back-to-back calls: "
              f"{op_ms:.4f} ms a call; by device op (profiler): "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" [{card}]")
        return year, e_year, layout

    gen = torch.Generator(device=dev).manual_seed(0)
    if args.year_only:
        year_cells(gen)
        print(json.dumps(result))
        return

    e50, e64 = np.linspace(-4, 4, 51), np.linspace(-4, 4, 65)
    x = torch.randn(CONFIG1, device=dev, generator=gen)
    w = torch.rand(CONFIG1, device=dev, generator=gen)
    breakdown("config 1, (1, 10^8) float32, 50 bins, full", x.reshape(1, -1), e50,
              e50 - 100, True)
    breakdown("config 2, (1000, 100000) float32, U(0,1) float32 weights, 50 bins, "
              "kept rows", x, e50, e50 - 100, False, weights=w)
    breakdown("config 2 unweighted", x, e50, e50 - 100, False)
    del w

    xr = torch.randn(1, N_ROW, device=dev, generator=gen)
    breakdown("2^30 float32, 64 bins, full", xr, e64, e64 - 100, True)
    xb = xr.bfloat16()
    del xr
    breakdown("2^30 bfloat16, 64 bins, full", xb, e64, e64 - 100, True,
              widen=torch.float32)
    xs = (xb.float() * 8000).round().clamp(-32768, 32767).to(torch.int16)
    e_i16 = np.linspace(-32768, 32768, 65)
    breakdown("2^30 int16, 64 bins, full", xs, e_i16, e_i16 - 100_000, True,
              widen=torch.int32)
    del xs
    xi = (xb.float() * 30).round().clamp(-128, 127).to(torch.int8)
    del xb
    e_i8 = np.linspace(-128, 128, 65)
    breakdown("2^30 int8, 64 bins, full", xi, e_i8, e_i8 - 1000, True,
              widen=torch.int32)
    del xi
    torch.cuda.empty_cache()

    sst = 20.0 + 5.0 * torch.randn(SST, device=dev, generator=gen)
    layout = canonicalize_2d(sst, (0,))
    e80 = np.linspace(0, 40, 81)
    breakdown(f"config 4, {tuple(layout.shape)} strides {layout.stride()} float32, "
              "80 bins, kept rows", layout, e80, e80 - 100, False)

    def idle_share(label, call):
        """Host time to return, then back-to-back wall against the kernel's
        own device time inside the same calls."""
        call()
        torch.cuda.synchronize()
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        spans = []
        launch = core.one_input

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch(*args, **kwargs)
            stop.record()
            spans.append((start, stop))
            return out

        core.one_input = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BACK_TO_BACK):
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            core.one_input = launch
        kernel_ms = sum(s.elapsed_time(e) for s, e in spans)
        result.setdefault("public", {})[label] = {
            "host_ms": host, "wall_ms": wall_ms / BACK_TO_BACK,
            "kernel_ms": kernel_ms / BACK_TO_BACK, "idle_share": 1 - kernel_ms / wall_ms}
        print(f"# {label}: host ms from call to return, card idle: "
              f"{[round(v, 3) for v in host]}; {BACK_TO_BACK} back-to-back calls: "
              f"{wall_ms / BACK_TO_BACK:.4f} ms per call on the wall, kernel (any "
              f"zeroing of the output included) {kernel_ms / BACK_TO_BACK:.4f} ms per "
              f"call, "
              f"device idle share {1 - kernel_ms / wall_ms:.4f} [{card}]")

    idle_share("config 1 public call", lambda: xhistogram_torch.histogram(x, bins=[e50]))
    idle_share("config 4 public call",
               lambda: xhistogram_torch.histogram(sst, bins=[e80], axis=0))
    del x, sst
    torch.cuda.empty_cache()

    year, e_year, layout = year_cells(gen)
    w_year = torch.rand(YEAR, device=dev, generator=gen)
    breakdown(f"year, {tuple(layout.shape)} float32, 80 bins, U(0,1) float32 weights",
              layout, e_year, e_year - 100, False,
              weights=canonicalize_2d(w_year, (0,)))
    for weights in (None, w_year):
        kind = "unweighted" if weights is None else "float32 weights"
        public = {m: event_ms(lambda: xhistogram_torch.histogram(
            year, bins=[e_year], axis=0, weights=weights, method=m), reps=5)
            for m in ("auto", "scatter")}
        result.setdefault("year_public_ms", {})[kind] = public
        print(f"# year public call, {kind}: one_input {public['auto']:.4f} ms, plain "
              f"scatter path {public['scatter']:.4f} ms (CUDA events, host work "
              f"included) [{card}]")
    idle_share("year public call",
               lambda: xhistogram_torch.histogram(year, bins=[e_year], axis=0))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
