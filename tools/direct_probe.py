"""Where the direct route's time goes, on one CUDA card.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/direct_probe.py [--reps N]

It builds the port's kernels, holds the direct-row kernel
(``csrc/direct.cuh``) bit for bit against the plain version (float32 rows
within two float32 ulps) at the shapes it times, then times it in turns
with the flat-slot template per kept row (``csrc/slot.cuh``'s
``xh_slot_*`` entries: template, row kernel, row kernel, template), each
beside its bound, at:

- (64800, 64) x 2 float32 in 40x40 bins (``doc/perf_model.md:57`` at
  config 4's grid): counts, int32 weights, float32 weights (the row
  kernel's float32 rows against the template's float64 sums and their
  rounding pass);
- (1000, 64) x 2 in 40x40 bins: counts;
- (16384, 64) x 2 in 64x64 and 128x64 bins (4096 and 8192 slots: fewer
  warps a block) and (64800, 255) in 40x40 bins (the widest row).

Beside each, its breakdown: the inputs read alone (``sum()`` of each), the
output written alone (``fill_`` of a tensor of its size), the kernel on data
above every edge (read, searched and stored, nothing counted), the kernel
on one row a warp of its grid (the block's prologue, one row and the drain
of its stores), and the kernel's device time from ``torch.profiler`` (which
excludes the host's launch work that CUDA events over back-to-back calls
include when the kernel is shorter than it). Each line carries the card's
name and power limit; the last line is one JSON object. It imports nothing
of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def event_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, after one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, name, reps):
    """Mean device milliseconds of the kernels whose name holds ``name``
    over ``reps`` calls of ``fn()``, from torch.profiler; None where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            total += ev.self_device_time_total
            count += ev.count
    return total / count / 1e3 if count else None


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("direct_probe.py needs a CUDA card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.ops import _build, cuda_hist

    dev = torch.device("cuda", 0)
    card = card_line()
    _build.load()
    entry = ""
    for line in _build.BUILD_LOG.splitlines():  # the row kernels' registers and spills
        if "Compiling entry" in line:
            entry = line
        elif "direct_rows_kernel" in entry and ("Used" in line or "spill" in line):
            print(f"#   ptxas: {entry.split()[-3][:90]}: {line.strip()}")

    def thresholds(nb):
        return torch.from_numpy(compare_form(np.linspace(-4.0, 4.0, nb + 1),
                                             np.float32).edges).to(dev)

    # both kernels below their wrappers' checks and the op's dispatch, so
    # that events over back-to-back calls see as little host work as can be
    def row_kernel(layouts, thr, nbins, w, finish):
        rounds = finish and w is not None and w.dtype == torch.float32
        return cuda_hist._direct_rows_cuda(layouts, thr, nbins, w, rounds)[0]

    def template(layouts, thr, nbins, w, finish):
        out, _ = cuda_hist._slot_hist_cuda("direct", layouts, thr, nbins, False, w)
        return out.to(torch.float32) if finish and w is not None and \
            w.dtype == torch.float32 else out

    cases = [
        ("(64800, 64) 40x40 counts", (64800, 64), (40, 40), None),
        ("(64800, 64) 40x40 int32 weights", (64800, 64), (40, 40), torch.int32),
        ("(64800, 64) 40x40 float32 weights, float32 rows", (64800, 64), (40, 40),
         torch.float32),
        ("(1000, 64) 40x40 counts", (1000, 64), (40, 40), None),
        ("(16384, 64) 64x64 counts (4096 slots)", (16384, 64), (64, 64), None),
        ("(16384, 64) 128x64 counts (8192 slots)", (16384, 64), (128, 64), None),
        ("(16384, 64) 128x64 float32 weights (8192 slots)", (16384, 64), (128, 64),
         torch.float32),
        ("(64800, 255) 40x40 counts", (64800, 255), (40, 40), None),
    ]
    results = {}
    for label, shape, nbins, wdtype in cases:
        gen = torch.Generator(device=dev).manual_seed(shape[0] + shape[1])
        layouts = [torch.randn(shape, device=dev, generator=gen) for _ in nbins]
        w = None
        if wdtype == torch.int32:
            w = torch.randint(-(2**30), 2**30, shape, device=dev, generator=gen,
                              dtype=torch.int32)
        elif wdtype is not None:
            w = torch.rand(shape, device=dev, generator=gen)
        thr = [thresholds(nb) for nb in nbins]
        nb = list(nbins)
        got = cuda_hist.direct(layouts, thr, nb, weights=w)
        torch.cuda.synchronize()
        rec = cuda_hist.last_launch()
        if rec["kernel"] != "direct_rows":
            raise AssertionError(f"{label}: ran {rec['kernel']}")
        want = cuda_hist.direct_reference(layouts, thr, nb, weights=w)
        if got.dtype != want.dtype:
            raise AssertionError(f"{label}: {got.dtype} against {want.dtype}")
        if got.is_floating_point():
            ok = torch.allclose(got, want, rtol=2.4e-7, atol=0, equal_nan=True)
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(f"{label}: row kernel != plain")
        del want
        reps = opts.reps
        args = (layouts, thr, nb, w, True)
        t_a = event_ms(lambda: template(*args), reps)
        r_a = event_ms(lambda: row_kernel(*args), reps)
        r_b = event_ms(lambda: row_kernel(*args), reps)
        t_b = event_ms(lambda: template(*args), reps)
        rows_ms, tmpl_ms = (r_a + r_b) / 2, (t_a + t_b) / 2
        prof_ms = device_ms(lambda: row_kernel(*args), "direct_rows_kernel", reps)
        tmpl_prof_ms = device_ms(lambda: template(*args), "slot_hist_kernel", reps)
        n = shape[0] * shape[1]
        in_bytes = 4 * n * len(nbins) + (4 * n if w is not None else 0)
        out_bytes = got.element_size() * got.numel()
        bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        read_ms = event_ms(lambda: [x.sum() for x in layouts + ([w] if w is not None
                                                                 else [])], reps)
        sink = torch.empty_like(got)
        write_ms = event_ms(lambda: sink.fill_(0), reps)
        above = [torch.full_like(x, 10.0) for x in layouts]  # past every edge
        none_ms = device_ms(lambda: row_kernel(above, thr, nb, w, True),
                            "direct_rows_kernel", reps)
        first = rec["blocks"] * rec["warps_per_block"]  # one row a warp
        one_row = [x[:first] for x in layouts]
        w_one = None if w is None else w[:first]
        fixed_ms = device_ms(lambda: row_kernel(one_row, thr, nb, w_one, True),
                             "direct_rows_kernel", reps)
        results[label] = {
            "row_kernel_ms": rows_ms, "template_ms": tmpl_ms,
            "row_kernel_device_ms": prof_ms, "template_device_ms": tmpl_prof_ms,
            "bound_ms": bound_ms,
            "read_alone_ms": read_ms, "write_alone_ms": write_ms,
            "nothing_counted_device_ms": none_ms,
            "one_row_a_warp_device_ms": fixed_ms,
            "warps_per_block": rec["warps_per_block"], "blocks": rec["blocks"],
            "rows_per_warp": rec["rows_per_warp"], "cells": rec["cells"],
        }
        print(f"# {label}: == plain; row kernel {rows_ms:.4f} ms (profiler "
              f"{prof_ms}), template {tmpl_ms:.4f} ms (profiler {tmpl_prof_ms}), "
              f"bound {bound_ms:.4f} ms "
              f"({in_bytes / 1e6:.1f} MB read, {out_bytes / 1e6:.1f} MB written); read "
              f"alone {read_ms:.4f}, write alone {write_ms:.4f}, nothing counted "
              f"{none_ms}, one row a warp "
              f"{fixed_ms}; {rec['warps_per_block']} warps a block, "
              f"{rec['blocks']} blocks, {rec['rows_per_warp']} rows a warp [{card}]")
        del layouts, w, got, sink, above
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "direct": results}))


if __name__ == "__main__":
    main()
