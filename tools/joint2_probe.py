"""Where the time of the port's main path goes, on one CUDA card.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/joint2_probe.py

It prints, each line beside the card's name and power limit:

- the joint2 kernel's device time per call at 2^26 T–S pairs for grids from
  one block's shared memory to past a cluster of eight (each with the
  cluster size and passes it took), and a plain read of the same bytes
  (``a.sum() + b.sum()``);
- at 280x340, the time broken down: the searches alone (T above every
  edge: read and digitized, never counted), the atomics all local (280x170,
  which fits one block, one pass), one pass in clusters of two (half the
  atomics remote, in distributed shared memory) and two passes of one
  block (all local), with the weighted kernel for each accumulator class
  (float64, uint32, uint64) at clusters of at most 1, 2 and 4 blocks;
- for the main path (2^30 pairs, 280x340 bins, the public ``histogram``):
  the host time from the call to its return with the card idle, and, over
  back-to-back calls, their wall time against the device time of the
  kernel's own launches in the same calls, which gives the device's idle
  share;
- the SM clock and power draw that ``nvidia-smi`` samples during those
  back-to-back calls.

It imports nothing of JAX.
"""

import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN = (1024, 1 << 20)  # bench.py's 2^30 pairs
N_CMP = 1 << 26
GRIDS = ((144, 340), (280, 170), (280, 340), (8, 9), (1, 1), (560, 680), (1000, 500))
BACK_TO_BACK = 100


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def event_ms(fn, reps=10):
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
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
        raise SystemExit("joint2_probe.py needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import xhistogram_torch
    from xhistogram_torch import core
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.ops import _build, cuda_hist

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"# card: {card} | torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.load()

    def thresholds(edges):
        return torch.from_numpy(compare_form(edges, np.float32).edges).to(dev)

    # --- the kernel alone at 2^26 pairs, by number of slot chunks ------------
    gen = torch.Generator(device=dev).manual_seed(0)
    a = 14.0 + 8.0 * torch.randn(N_CMP, device=dev, generator=gen)
    b = 35.0 + 1.5 * torch.randn(N_CMP, device=dev, generator=gen)
    for nba, nbb in GRIDS:
        ta = thresholds(np.linspace(-2, 30, nba + 1).astype(np.float32))
        tb = thresholds(np.linspace(30, 40, nbb + 1).astype(np.float32))
        run = lambda: cuda_hist.joint2(a, b, ta, tb, nba, nbb)  # noqa: E731
        run()
        launch = cuda_hist.last_launch()
        ms = event_ms(run)
        print(f"# 2^26 pairs {nba}x{nbb} (cluster {launch['cluster']}, "
              f"{launch['passes']} passes): kernel {ms:.4f} ms, "
              f"{8 * N_CMP / ms / 1e6:.1f} GB/s [{card}]")
    read = lambda: (a.sum(), b.sum())  # noqa: E731
    read()
    ms = event_ms(read)
    print(f"# 2^26 pairs: a.sum() + b.sum() {ms:.4f} ms, "
          f"{8 * N_CMP / ms / 1e6:.1f} GB/s [{card}]")

    # --- 280x340: searches, local and remote atomics, passes -----------------
    ta = thresholds(np.linspace(-2, 30, 281).astype(np.float32))
    tb = thresholds(np.linspace(30, 40, 341).astype(np.float32))
    tb_half = thresholds(np.linspace(30, 40, 171).astype(np.float32))
    above = a + 100.0  # above every T edge: searched, never counted
    default = cuda_hist.MAX_CLUSTER_CTAS
    parts = {}
    try:
        for label, most, run in (
            ("searches alone (T above every edge)", default,
             lambda: cuda_hist.joint2(above, b, ta, tb, 280, 340)),
            ("280x170, one block, one pass (atomics all local)", default,
             lambda: cuda_hist.joint2(a, b, ta, tb_half, 280, 170)),
            ("280x340, clusters of two, one pass (half the atomics remote)", default,
             lambda: cuda_hist.joint2(a, b, ta, tb, 280, 340)),
            ("280x340, one block, two passes (atomics all local)", 1,
             lambda: cuda_hist.joint2(a, b, ta, tb, 280, 340)),
        ):
            cuda_hist.MAX_CLUSTER_CTAS = most
            run()
            launch = cuda_hist.last_launch()
            parts[label] = event_ms(run)
            print(f"# 2^26 T-S pairs, {label}: cluster {launch['cluster']}, "
                  f"{launch['passes']} passes, kernel {parts[label]:.4f} ms [{card}]")
        gen = torch.Generator(device=dev).manual_seed(1)
        weights = {
            "float32 [f64]": torch.rand(N_CMP, device=dev, generator=gen),
            "int32 [u32]": torch.randint(-(2**30), 2**30, (N_CMP,), device=dev,
                                         generator=gen, dtype=torch.int32),
            "int64 [u64]": torch.randint(-(2**40), 2**40, (N_CMP,), device=dev,
                                         generator=gen),
        }
        for kind, w in weights.items():
            line = []
            for most in (1, 2, 4, 1):  # in turns: 1, 2, 4, then 1 again
                cuda_hist.MAX_CLUSTER_CTAS = most
                run = lambda: cuda_hist.joint2(a, b, ta, tb, 280, 340, weights=w)  # noqa: E731
                run()
                launch = cuda_hist.last_launch()
                line.append(f"cluster {launch['cluster']} x {launch['passes']} passes "
                            f"{event_ms(run):.4f} ms")
            print(f"# 2^26 T-S pairs, 280x340, {kind} weights: {'; '.join(line)} [{card}]")
    finally:
        cuda_hist.MAX_CLUSTER_CTAS = default
    del a, b, above

    # --- the main path -------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    T = 14.0 + 8.0 * torch.randn(N_MAIN, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(N_MAIN, device=dev, generator=gen)
    t_edges = np.linspace(-2.0, 30.0, 281).astype(np.float32)
    s_edges = np.linspace(30.0, 40.0, 341).astype(np.float32)
    call = lambda: xhistogram_torch.histogram(T, S, bins=[t_edges, s_edges])  # noqa: E731
    call()
    torch.cuda.synchronize()

    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    print(f"# main path: host ms from call to return, card idle: "
          f"{[round(x, 3) for x in host]} [{card}]")

    # the kernel's device time inside the same back-to-back calls: events
    # around each launch of the wrapper (its output's zeroing included)
    spans = []
    launch = core.joint2

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        stop.record()
        spans.append((start, stop))
        return out

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        time.sleep(1.0)  # let the sampler start before the load does
        core.joint2 = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BACK_TO_BACK):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        core.joint2 = launch
        smi.terminate()
        samples, _ = smi.communicate(timeout=30)
    kernel_ms = sum(s.elapsed_time(e) for s, e in spans)
    print(f"# main path, {BACK_TO_BACK} back-to-back calls: wall {wall_ms:.3f} ms "
          f"({wall_ms / BACK_TO_BACK:.3f} ms per call, "
          f"{8 * T.numel() * BACK_TO_BACK / wall_ms / 1e6:.1f} GB/s); kernel "
          f"{kernel_ms:.3f} ms ({kernel_ms / BACK_TO_BACK:.3f} ms per call); "
          f"device idle share {1 - kernel_ms / wall_ms:.4f} [{card}]")
    rows = [r.split(",") for r in samples.strip().splitlines()]
    clocks = [float(r[0]) for r in rows if len(r) == 2]
    watts = [float(r[1]) for r in rows if len(r) == 2]
    if watts:
        print(f"# nvidia-smi during the calls ({len(watts)} samples, the first "
              f"~1 s idle): SM clock median {statistics.median(clocks):.0f} MHz, "
              f"power median {statistics.median(watts):.2f} W, max "
              f"{max(watts):.2f} W [{card}]")


if __name__ == "__main__":
    main()
