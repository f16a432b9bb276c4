"""Where the time of the port's factored and direct paths goes, on one CUDA
card.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/factored_probe.py

It prints, each line beside the card's name and power limit:

- for each path of the factored and direct kernels (the README's per-depth
  T–S diagram, (73, 50, 64800) x 2 with ``axis=(0, 2)``; 5e7 pairs in
  1000x1000 bins; (1000, 100000) x 2 in 150x90 bins per row; (16384, 64) x 2
  in 120x90 per row; (64800, 64) and (1000, 64) x 2 in 40x40 per row): the
  kernel's device time, the public call's host time from the call to its
  return with the card idle, and over back-to-back calls their wall time
  against the device time of the kernel's own launches in the same calls
  (the share of the wall outside the kernel: the device's idle share,
  plus the README call's layout copy);
- the README call's ``canonicalize_2d`` copy of both inputs, timed alone;
- the kernel as it runs by default (histograms in one block's shared
  memory, or spread over a cluster's), capped at one block a cluster
  (``MAX_CLUSTER_CTAS = 1``: one block's shared memory where the histogram
  fits, device memory past that) and adding straight into the output in
  device memory (``MAX_SHARED_SLOTS = 0``), each with the cluster size it
  took: at 13,500, 57,121 and 57,600 slots, full and per row, the README
  call's 95,201 slots a row, three inputs in 60^3 bins, and for the
  README call and 60^3 also with float32, int32 and int64 weights (the
  float64, uint32 and uint64 accumulator classes);
- at the packed and direct shapes, the kernel that stores every slot of
  whole rows against the one that adds into a zeroed output, and the
  zeroing alone;
- the searches without atomics (data above every edge) at the per-row and
  full shapes, and the factored kernel against joint2 at 280x340.

It imports nothing of JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

README_TS = (73, 50, 64800)
BACK_TO_BACK = 20


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("factored_probe.py needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import xhistogram_torch
    from xhistogram_torch import core
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.ops import _build, cuda_hist
    from xhistogram_torch.utils.axes import canonicalize_2d

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"# card: {card} | torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.load()

    def edges(nb):
        return np.linspace(-4.0, 4.0, nb + 1)

    def operands(all_edges):
        return ([torch.from_numpy(compare_form(e, np.float32).edges).to(dev)
                 for e in all_edges], [len(e) - 1 for e in all_edges])

    def kernel(route, layouts, ops):
        thr, nbins = ops
        if route == "direct":
            return lambda: cuda_hist.direct(layouts, thr, nbins)
        return lambda: cuda_hist.factored(layouts, thr, nbins, route)

    def idle_share(label, call, wrapper):
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
        launch = getattr(core, wrapper)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch(*args, **kwargs)
            stop.record()
            spans.append((start, stop))
            return out

        setattr(core, wrapper, timed)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BACK_TO_BACK):
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            setattr(core, wrapper, launch)
        kernel_ms = sum(s.elapsed_time(e) for s, e in spans)
        print(f"# {label}: host ms from call to return, card idle: "
              f"{[round(x, 3) for x in host]}; {BACK_TO_BACK} back-to-back calls: "
              f"{wall_ms / BACK_TO_BACK:.4f} ms per call on the wall, kernel "
              f"{kernel_ms / BACK_TO_BACK:.4f} ms per call, outside the kernel "
              f"{1 - kernel_ms / wall_ms:.4f} of the wall [{card}]")

    def modes(label, route, layouts, ops, weights=None):
        """The kernel as it runs by default, capped at one block a cluster,
        and forced to add in device memory, in turns."""
        times = {}
        slots, most = cuda_hist.MAX_SHARED_SLOTS, cuda_hist.MAX_CLUSTER_CTAS
        thr, nbins = ops
        if route == "direct":
            run = lambda: cuda_hist.direct(layouts, thr, nbins, weights=weights)  # noqa: E731
        else:
            run = lambda: cuda_hist.factored(layouts, thr, nbins, route,  # noqa: E731
                                             weights=weights)
        try:
            for name, limit, cap in (("default", slots, most), ("one block", slots, 1),
                                     ("device memory", 0, most),
                                     ("device memory", 0, most), ("one block", slots, 1),
                                     ("default", slots, most)):
                cuda_hist.MAX_SHARED_SLOTS, cuda_hist.MAX_CLUSTER_CTAS = limit, cap
                ms = event_ms(run)
                launch = cuda_hist.last_launch()
                where = (f"cluster {launch['cluster']}" if launch["shared"]
                         else "device memory")
                times.setdefault(f"{name} ({where})", []).append(ms)
        finally:
            cuda_hist.MAX_SHARED_SLOTS, cuda_hist.MAX_CLUSTER_CTAS = slots, most
        print(f"# {label}: " + ", ".join(f"{k} {sum(v) / len(v):.4f} ms"
                                         for k, v in times.items()) + f" [{card}]")

    def weighted_modes(label, route, layouts, ops):
        gen = torch.Generator(device=dev).manual_seed(7)
        shape = layouts[0].shape
        for kind, w in (
            ("float32 [f64]", torch.rand(shape, device=dev, generator=gen)),
            ("int32 [u32]", torch.randint(-(2**30), 2**30, shape, device=dev,
                                          generator=gen, dtype=torch.int32)),
            ("int64 [u64]", torch.randint(-(2**40), 2**40, shape, device=dev,
                                          generator=gen)),
        ):
            modes(f"{label}, {kind} weights", route, layouts, ops, weights=w)
            del w

    # --- the paths: kernel, public call, idle share -----------------------------
    gen = torch.Generator(device=dev).manual_seed(13)
    T = 14.0 + 8.0 * torch.randn(README_TS, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(README_TS, device=dev, generator=gen)
    ts_edges = [np.linspace(-2.0, 30.0, 281).astype(np.float32),
                np.linspace(30.0, 40.0, 341).astype(np.float32)]
    ms = event_ms(lambda: (canonicalize_2d(T, (0, 2)), canonicalize_2d(S, (0, 2))))
    print(f"# README call: canonicalize_2d's copy of both (73, 50, 64800) float32 "
          f"inputs {ms:.4f} ms ({4 * 4 * T.numel() / ms / 1e6:.1f} GB/s read + "
          f"written) [{card}]")
    layouts = [canonicalize_2d(x, (0, 2)) for x in (T, S)]
    ops = operands(ts_edges)
    ms = event_ms(kernel("per_row", layouts, ops), reps=5)
    print(f"# README per-level T-S, layout {tuple(layouts[0].shape)}, 95,201 slots a "
          f"row: kernel {ms:.4f} ms [{card}]")
    above = [layouts[0] + 100.0, layouts[1]]  # T above every edge: never counted
    ms = event_ms(kernel("per_row", above, ops), reps=5)
    print(f"# README layout, T above every edge (searches, no atomics): kernel "
          f"{ms:.4f} ms [{card}]")
    del above
    modes("README per-level T-S, 95,201 slots a row", "per_row", layouts, ops)
    weighted_modes("README per-level T-S", "per_row", layouts, ops)
    idle_share("README per-level T-S public call",
               lambda: xhistogram_torch.histogram(T, S, bins=ts_edges, axis=(0, 2)),
               "factored")
    del T, S, layouts
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(54)
    a, b = (torch.randn(50_000_000, device=dev, generator=gen) for _ in range(2))
    full = [a.reshape(1, -1), b.reshape(1, -1)]
    ops = operands([edges(1000)] * 2)
    ms = event_ms(kernel("full", full, ops))
    print(f"# 5e7 pairs, 1000x1000 bins, full: kernel {ms:.4f} ms [{card}]")
    ms = event_ms(kernel("full", [full[0] + 10.0, full[1]], ops))
    print(f"# 5e7 pairs, 1000x1000 bins, a above every edge (searches, no atomics): "
          f"kernel {ms:.4f} ms [{card}]")
    idle_share("1000x1000 full public call",
               lambda: xhistogram_torch.histogram(a, b, bins=[edges(1000)] * 2),
               "factored")
    for nbins in ((150, 90), (239, 239), (240, 240)):  # one block; two; two
        modes(f"5e7 pairs, {nbins[0]}x{nbins[1]} bins, full", "full", full,
              operands([edges(nb) for nb in nbins]))
    three = [full[0], full[1], torch.randn(1, 50_000_000, device=dev, generator=gen)]
    ops3 = operands([edges(60)] * 3)
    modes("3 x 5e7 inputs, 60x60x60 bins, full", "full", three, ops3)
    weighted_modes("3 x 5e7 inputs, 60x60x60 bins, full", "full", three, ops3)
    del three
    ops = operands(ts_edges)
    ts = [14.0 + 8.0 * a[: 1 << 26].reshape(1, -1), 35.0 + 1.5 * b[: 1 << 26].reshape(1, -1)]
    ms_f = event_ms(kernel("full", ts, ops))
    ms_j = event_ms(lambda: cuda_hist.joint2(ts[0], ts[1], *ops[0], *ops[1]))
    print(f"# 2^26 T-S pairs, 280x340 bins, full: factored {ms_f:.4f} ms, joint2 "
          f"{ms_j:.4f} ms [{card}]")
    del a, b, full, ts
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(1000)
    rows = [torch.randn(1000, 100_000, device=dev, generator=gen) for _ in range(2)]
    ops = operands([edges(150), edges(90)])
    ms = event_ms(kernel("per_row", rows, ops))
    print(f"# (1000, 100000) x 2, 150x90 bins per row: kernel {ms:.4f} ms [{card}]")
    ms = event_ms(kernel("per_row", [rows[0] + 10.0, rows[1]], ops))
    print(f"# (1000, 100000) x 2, 150x90, a above every edge (searches, no atomics): "
          f"kernel {ms:.4f} ms [{card}]")
    ms = event_ms(lambda: rows[0].sum() + rows[1].sum())
    print(f"# (1000, 100000) x 2: a.sum() + b.sum() {ms:.4f} ms [{card}]")
    idle_share("150x90 per-row public call",
               lambda: xhistogram_torch.histogram(*rows, bins=[edges(150), edges(90)],
                                                  axis=1),
               "factored")
    for nbins in ((150, 90), (239, 239), (240, 240)):
        modes(f"(1000, 100000) x 2, {nbins[0]}x{nbins[1]} bins per row", "per_row",
              rows, operands([edges(nb) for nb in nbins]))
    del rows
    torch.cuda.empty_cache()

    for label, shape, nbins, route in (
        ("(16384, 64) x 2, 120x90 bins per row (packed)", (16384, 64), (120, 90),
         "packed"),
        ("(64800, 64) x 2, 40x40 bins per row (direct)", (64800, 64), (40, 40), "direct"),
        ("(1000, 64) x 2, 40x40 bins per row (direct)", (1000, 64), (40, 40), "direct"),
    ):
        gen = torch.Generator(device=dev).manual_seed(shape[0])
        narrow = [torch.randn(shape, device=dev, generator=gen) for _ in range(2)]
        ops = operands([edges(nb) for nb in nbins])
        modes(f"{label}: whole rows stored (default) against added into a zeroed "
              "output (device memory)", route, narrow, ops)
        n_slots = int(np.prod(nbins)) + 1
        ms = event_ms(lambda: torch.zeros(shape[0], n_slots, dtype=torch.int64,
                                          device=dev))
        print(f"# {label}: zeroing the ({shape[0]}, {n_slots}) int64 output alone "
              f"{ms:.4f} ms [{card}]")
        idle_share(f"{label} public call",
                   lambda: xhistogram_torch.histogram(
                       *narrow, bins=[edges(nb) for nb in nbins], axis=1),
                   "direct" if route == "direct" else "factored")
        del narrow
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
