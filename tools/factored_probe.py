"""Where the time of the port's factored and direct paths goes, on one CUDA
card.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/factored_probe.py

It prints, each line beside the card's name and power limit:

- at ECCO v4r4's own shape, the benchmark's ``ts_ecco_levels_vol`` call
  ((312, 50, 259,200) x 2 float32 T and S by ``portbench``'s ``ts_depth``
  recipe, NaN land and rock, weighted by the (50, 259,200) cell volume
  broadcast over time, ``axis=(0, 2)`` on the strided view): the factored
  per-row kernel's device time (a) reading and searching with nothing
  summed (T above every edge), (b) counting, unweighted, (c) summing the
  volume in float64 in device memory (``MAX_SHARED_SLOTS = 0``: the
  placement float sums took before they were kept exact), (d) summing it as
  exact integers in a cluster (the default), with the share of counted
  elements whose weight fell back to a float add and each kernel's device
  time in (d) from the profiler; then the same call with full-size float32
  weights (not broadcast: the prologue reads all of them), exact against
  device memory in turns; and (b)-(d) for the README call by a (50, 64800)
  cell volume;
- at GLORYS12V1's shape, the benchmark's ``ts_glorys12_levels_int16`` call
  ((24, 50, 8,817,120) x 2 CF-packed int16 T and S by the
  ``ts_depth_packed`` recipe, the fill value on land and rock, edges in
  packed units, weighted by the (50, 8,817,120) cell volume): (a)-(d) as
  for ECCO, the fallback share, each kernel's device time in (d) and the
  kernel against the call's bytes bound (``--glorys-only``: these alone);
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

It imports nothing of JAX. ``--ecco-only`` stops after the ECCO lines.
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


def census(label, T, S, vol, edges, card):
    """A (time, depth, cell) T-S census by cell volume, ``axis=(0, 2)`` on
    the strided view the public call hands the factored per-row kernel (the
    volume's time level a stride of 0): kernel ms (b) unweighted, (c) float64
    in device memory, (d) exact, in turns, and the share of counted
    elements whose weight fell back to a float add. Returns ``run``."""
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.core import _compare_dtype
    from xhistogram_torch.ops import cuda_hist

    times, levels, cells = T.shape
    view = (1, levels, times, cells)
    views = [x.as_strided(view, (0, cells, levels * cells, 1)) for x in (T, S)]
    wv = vol.as_strided(view, (0, cells, 0, 1))
    thr = [torch.from_numpy(compare_form(e, _compare_dtype(x)).edges).to(T.device)
           for e, x in zip(edges, (T, S))]
    nbins = [len(e) - 1 for e in edges]
    slots = cuda_hist.MAX_SHARED_SLOTS

    def run(weights=wv, device_memory=False, views=views):
        cuda_hist.MAX_SHARED_SLOTS = 0 if device_memory else slots
        try:
            return cuda_hist.factored(views, thr, nbins, False, weights=weights,
                                      finish=False)
        finally:
            cuda_hist.MAX_SHARED_SLOTS = slots

    def where():
        rec = cuda_hist.last_launch()
        return (("exact" if rec["exact"] else "shared") + f" cluster {rec['cluster']}"
                if rec["shared"] else "device memory")

    counted = int(run(None).sum())
    b = [event_ms(lambda: run(None), reps=5)]
    where_b = where()
    c = [event_ms(lambda: run(device_memory=True), reps=5)]
    d = [event_ms(run, reps=5)]
    fell = cuda_hist.last_launch()["fell_back"]
    where_d = where()
    c.append(event_ms(lambda: run(device_memory=True), reps=5))
    b.append(event_ms(lambda: run(None), reps=5))
    d.append(event_ms(run, reps=5))
    exact = run()
    err = ((exact - run(device_memory=True)).abs().max() / exact.abs().max()).item()
    print(f"# {label}: {counted} of {T.numel()} pairs counted; kernel ms "
          f"(b) unweighted {b} ({where_b}), (c) float64 in device memory {c}, "
          f"(d) exact {d} ({where_d}); {fell} counted elements fell back to a float "
          f"add ({100 * fell / counted:.4f}%); largest gap of (d) from (c) over the "
          f"largest sum {err:.3e} [{card}]")
    return run


def device_ops(label, run, card):
    """Each device op's milliseconds a call of ``run()``, by the profiler."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_time_total > 0:
                print(f"# {label}, device ms a call: {ev.key[:90]} "
                      f"{ev.device_time_total / 3e3:.4f} [{card}]")
    except Exception as exc:  # the profiler is a diagnostic: report and go on
        print(f"# {label}: no profiler breakdown ({exc!r}) [{card}]")


def glorys(dev, card):
    """The GLORYS12V1 cell's call, kernel by kernel: (a)-(d) on its packed
    int16 data, and the kernel against the call's bytes bound."""
    from portbench import registry

    cell = registry.Cell("ts_glorys12_levels_int16")
    data = cell.recipe.make(cell.config, 2200000001, dev, ["T", "S", "volume"])
    T, S, vol = data["T"], data["S"], data["volume"]
    edges = [data["T_edges"], data["S_edges"]]
    run = census(f"GLORYS12V1 {tuple(T.shape)} x 2 CF-packed int16, 280x340 bins per "
                 f"level in packed units, by the {tuple(vol.shape)} volume", T, S, vol,
                 edges, card)
    device_ops("GLORYS12V1 (d)", run, card)
    out_bytes = 4 * T.shape[1] * (len(edges[0]) - 1) * (len(edges[1]) - 1)
    bound = (2 * T.numel() * T.element_size() + vol.numel() * 4 + out_bytes) / 3.35e12
    d = event_ms(run, reps=5)
    print(f"# GLORYS12V1 (d) kernel {d:.4f} ms against a bytes bound of "
          f"{bound * 1e3:.4f} ms (the inputs read once and a float32 answer written "
          f"once at 3.35 TB/s): {100 * bound * 1e3 / d:.2f}% [{card}]")
    T.fill_(32767)  # above every edge: read and searched, nothing summed
    a = event_ms(lambda: run(None), reps=5)
    print(f"# GLORYS12V1 (a) T above every edge (reads and searches, nothing "
          f"summed): kernel {a:.4f} ms [{card}]")
    del data, T, S, vol, run
    torch.cuda.empty_cache()


def ecco(dev, card):
    """The ECCO cell's call, kernel by kernel: (a)-(d), the full-size
    weights' guard and the README call by cell volume (module docstring)."""
    from portbench import registry

    cell = registry.Cell("ts_ecco_levels_vol")
    data = cell.recipe.make(cell.config, 1900000001, dev, ["T", "S", "volume"])
    T, S, vol = data["T"], data["S"], data["volume"]
    times, levels, cells = T.shape
    edges = [data["T_edges"], data["S_edges"]]
    run = census("ECCO (312, 50, 259200) x 2 float32, 280x340 bins per level, by the "
                 "(50, 259200) volume", T, S, vol, edges, card)
    device_ops("ECCO (d)", run, card)
    full = vol.unsqueeze(0).expand(times, levels, cells).contiguous()
    fv = full.as_strided((1, levels, times, cells), (0, cells, levels * cells, 1))
    turns = {}
    for name, dm in (("exact", False), ("device memory", True), ("device memory", True),
                     ("exact", False)):
        turns.setdefault(name, []).append(event_ms(lambda: run(fv, dm), reps=3))
    print(f"# ECCO by full-size float32 weights (16.2 GB more read by the "
          f"prologue): kernel ms " + ", ".join(f"{k} {v}" for k, v in turns.items())
          + f" [{card}]")
    del full, fv
    T.add_(100.0)  # above every edge: read and searched, nothing summed
    a = event_ms(lambda: run(None), reps=5)
    print(f"# ECCO (a) T above every edge (reads and searches, nothing "
          f"summed): kernel {a:.4f} ms [{card}]")
    del data, T, S, vol, run
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(13)
    T = 14.0 + 8.0 * torch.randn(README_TS, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(README_TS, device=dev, generator=gen)
    vol = 1e9 * (0.5 + torch.rand(README_TS[1:], device=dev, generator=gen))
    census("README (73, 50, 64800) x 2 float32, 280x340 bins per level, by a "
           "(50, 64800) cell volume", T, S, vol,
           [np.linspace(-2.0, 30.0, 281).astype(np.float32),
            np.linspace(30.0, 40.0, 341).astype(np.float32)], card)
    del T, S, vol
    torch.cuda.empty_cache()


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
    if "--glorys-only" in sys.argv[1:]:
        glorys(dev, card)
        return
    ecco(dev, card)
    if "--ecco-only" in sys.argv[1:]:
        return
    glorys(dev, card)

    def edges(nb):
        return np.linspace(-4.0, 4.0, nb + 1)

    def operands(all_edges):
        return ([torch.from_numpy(compare_form(e, np.float32).edges).to(dev)
                 for e in all_edges], [len(e) - 1 for e in all_edges])

    def kernel(route, layouts, ops):
        thr, nbins = ops
        if route == "direct":
            return lambda: cuda_hist.direct(layouts, thr, nbins)
        return lambda: cuda_hist.factored(layouts, thr, nbins, route == "full")

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
            run = lambda: cuda_hist.factored(layouts, thr, nbins,  # noqa: E731
                                             route == "full", weights=weights)
        try:
            for name, limit, cap in (("default", slots, most), ("one block", slots, 1),
                                     ("device memory", 0, most),
                                     ("device memory", 0, most), ("one block", slots, 1),
                                     ("default", slots, most)):
                cuda_hist.MAX_SHARED_SLOTS, cuda_hist.MAX_CLUSTER_CTAS = limit, cap
                ms = event_ms(run)
                launch = cuda_hist.last_launch()
                where = (("exact " if launch["exact"] else "")
                         + f"cluster {launch['cluster']}" if launch["shared"]
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
