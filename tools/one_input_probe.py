"""Where the time of the port's one-input path goes, on one CUDA card.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/one_input_probe.py

It prints, each line beside the card's name and power limit:

- the one_input kernel's device time at BASELINE config 1's size (10^8
  float32, every axis reduced) for data and bin counts that separate its
  costs: N(0,1) and uniform data in 1, 50, 64 and 1024 bins (how many
  atomics land on the same counter), and data that lies above every edge
  (the binary search without any atomic); beside them a plain read of the
  same bytes (``x.sum()``);
- the kernel at 2^30 float32 in 64 bins;
- for config 1 and config 4 ((365, 180, 360) float32, ``axis=0``): the
  public call's host time from the call to its return with the card idle,
  and over back-to-back calls their wall time against the device time of
  the kernel's own launches in the same calls (the device's idle share);
- for config 4, the device time of zeroing the int64 output, and of the
  kernel on a contiguous copy of the strided layout (copy included).

It imports nothing of JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG1 = (1000, 100_000)
SST = (365, 180, 360)
N_ROW = 1 << 30
BACK_TO_BACK = 50


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
        raise SystemExit("one_input_probe.py needs a CUDA card")
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

    def thresholds(edges):
        return torch.from_numpy(compare_form(edges, np.float32).edges).to(dev)

    # --- the kernel alone at config 1's size ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    normal = torch.randn(CONFIG1, device=dev, generator=gen).reshape(1, -1)
    uniform = (8 * torch.rand(CONFIG1, device=dev, generator=gen) - 4).reshape(1, -1)
    above = normal.abs() + 5  # above the top edge 4: searched, never counted
    n_bytes = 4 * normal.numel()
    for label, x, nb in (
        ("N(0,1)", normal, 50), ("uniform", uniform, 50),
        ("N(0,1)", normal, 1), ("uniform", uniform, 1),
        ("N(0,1)", normal, 64), ("N(0,1)", normal, 1024),
        ("uniform", uniform, 1024), ("above every edge", above, 50),
        ("above every edge", above, 1024),
    ):
        thr = thresholds(np.linspace(-4, 4, nb + 1))
        ms = event_ms(lambda: cuda_hist.one_input(x, thr, nb, True))
        print(f"# config 1 size, {label}, {nb} bins, full: kernel {ms:.4f} ms, "
              f"{n_bytes / ms / 1e6:.1f} GB/s [{card}]")
    ms = event_ms(lambda: normal.sum())
    print(f"# config 1 size: x.sum() {ms:.4f} ms, {n_bytes / ms / 1e6:.1f} GB/s [{card}]")
    thr = thresholds(np.linspace(-4, 4, 51))
    rows = normal.reshape(CONFIG1)
    ms = event_ms(lambda: cuda_hist.one_input(rows, thr, 50, False))
    print(f"# config 2 layout (1000, 100000), 50 bins, kept rows: kernel {ms:.4f} ms, "
          f"{n_bytes / ms / 1e6:.1f} GB/s [{card}]")
    del uniform, above

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

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch(*args)
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
        print(f"# {label}: host ms from call to return, card idle: "
              f"{[round(x, 3) for x in host]}; {BACK_TO_BACK} back-to-back calls: "
              f"{wall_ms / BACK_TO_BACK:.4f} ms per call on the wall, kernel "
              f"(output zeroing included) {kernel_ms / BACK_TO_BACK:.4f} ms per call, "
              f"device idle share {1 - kernel_ms / wall_ms:.4f} [{card}]")

    edges1 = np.linspace(-4, 4, 51)
    idle_share("config 1 public call",
               lambda: xhistogram_torch.histogram(rows, bins=[edges1]))
    del normal, rows

    # --- config 4: strided kept rows ------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(4)
    sst = 20.0 + 5.0 * torch.randn(SST, device=dev, generator=gen)
    layout = canonicalize_2d(sst, (0,))
    m = layout.shape[0]
    edges4 = np.linspace(0, 40, 81)
    thr4 = thresholds(edges4)
    ms = event_ms(lambda: cuda_hist.one_input(layout, thr4, 80, False))
    print(f"# config 4 layout {tuple(layout.shape)} strides {layout.stride()}, 80 bins: "
          f"kernel (output zeroing included) {ms:.4f} ms, "
          f"{4 * sst.numel() / ms / 1e6:.1f} GB/s of input [{card}]")
    ms = event_ms(lambda: cuda_hist.one_input(layout.contiguous(), thr4, 80, False))
    print(f"# config 4 as a contiguous copy: copy + kernel {ms:.4f} ms [{card}]")
    ms = event_ms(lambda: torch.zeros(m, 81, dtype=torch.int64, device=dev))
    print(f"# config 4: zeroing the ({m}, 81) int64 output {ms:.4f} ms [{card}]")
    idle_share("config 4 public call",
               lambda: xhistogram_torch.histogram(sst, bins=[edges4], axis=0))
    del sst, layout

    # --- the 2^30 row ----------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    xr = torch.randn(1, N_ROW, device=dev, generator=gen)
    thr = thresholds(np.linspace(-4, 4, 65))
    ms = event_ms(lambda: cuda_hist.one_input(xr, thr, 64, True), reps=5)
    print(f"# 2^30 float32, 64 bins, full: kernel {ms:.4f} ms, "
          f"{4 * N_ROW / ms / 1e6:.1f} GB/s [{card}]")
    ms = event_ms(lambda: xr.sum(), reps=5)
    print(f"# 2^30 float32: x.sum() {ms:.4f} ms, {4 * N_ROW / ms / 1e6:.1f} GB/s [{card}]")


if __name__ == "__main__":
    main()
