"""Where the time of the public API above core goes, on one CUDA card.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/api_probe.py [--root DIR] [--public-only]

``--root`` imports ``xhistogram_torch`` from another checkout (for example
an unpacked parent commit), and ``--public-only`` times only the public
calls every version has, so two versions can be timed in turns within one
call. It prints, each line beside the card's name and power limit, and as
one JSON line at the end:

- public calls on data on the card: the main path (2^30 T–S pairs in
  280x340 bins), BASELINE config 1 and config 4, each the median of 5
  calls and, over 20 calls back to back, the wall per call against the
  kernel's own device time in the same calls (the card's idle share);
- the exact float64 tier (``precision='f64'``) on the T–S diagram at 2^26
  pairs with float64 U(0,1) weights: the public call, the decomposition of
  the weights alone (``core._f64_sums`` with passes that count nothing),
  the int64-weighted joint2 passes alone, and the device time of each
  operator under ``torch.profiler`` (the ten largest);
- StreamingHistogram over 2^28 T–S pairs in host memory (16 chunks of 2^24
  pairs): the wall time, the host copy into pinned memory alone, the
  pinned host-to-device copy alone and the joint2 kernels alone.

It imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

T_EDGES = np.linspace(-2.0, 30.0, 281).astype(np.float32)
S_EDGES = np.linspace(30.0, 40.0, 341).astype(np.float32)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def wall_ms(fn, reps=3):
    """Median wall milliseconds of ``fn()`` to completion on the card."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def public_calls(xhistogram_torch, core, dev, card):
    """Median ms of 5 public calls, and 20 back to back against the
    kernel's device time inside them, on the main path and configs 1, 4."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    T = 14.0 + 8.0 * torch.randn((1024, 1 << 20), device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn((1024, 1 << 20), device=dev, generator=gen)
    x1 = torch.randn((1000, 100_000), device=dev, generator=gen)
    sst = 20.0 + 5.0 * torch.randn((365, 180, 360), device=dev, generator=gen)
    e50, e80 = np.linspace(-4, 4, 51), np.linspace(0, 40, 81)
    for label, wrapper, call in (
        ("main path 2^30", "joint2", lambda: xhistogram_torch.histogram(
            T, S, bins=[T_EDGES, S_EDGES])),
        ("config 1", "one_input", lambda: xhistogram_torch.histogram(x1, bins=[e50])),
        ("config 4", "one_input", lambda: xhistogram_torch.histogram(
            sst, bins=[e80], axis=0)),
    ):
        median = wall_ms(call, reps=5)
        launch, spans = getattr(core, wrapper), []

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            res = launch(*args, **kwargs)
            stop.record()
            spans.append((start, stop))
            return res

        setattr(core, wrapper, timed)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            b2b = (time.perf_counter() - t0) * 1e3 / 20
        finally:
            setattr(core, wrapper, launch)
        kernel = sum(a.elapsed_time(b) for a, b in spans) / 20
        out[label] = {"median_ms": median, "back_to_back_ms": b2b, "kernel_ms": kernel,
                      "idle_share": 1 - kernel / b2b}
        print(f"# public call, {label}: median {median:.4f} ms; 20 back to back "
              f"{b2b:.4f} ms a call, kernel {kernel:.4f} ms, card idle "
              f"{1 - kernel / b2b:.4f} [{card}]")
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None,
                        help="import xhistogram_torch from this checkout")
    parser.add_argument("--public-only", action="store_true")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("api_probe.py needs a CUDA card")
    root = opts.root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.abspath(root))
    import xhistogram_torch
    from xhistogram_torch import core

    dev = torch.device("cuda", 0)
    card = card_line()
    out = {"card": card, "root": os.path.abspath(root)}
    print(f"# xhistogram_torch from {os.path.dirname(xhistogram_torch.__file__)}")
    out["public"] = public_calls(xhistogram_torch, core, dev, card)
    torch.cuda.empty_cache()
    if opts.public_only:
        print(json.dumps(out))
        return
    gen = torch.Generator(device=dev).manual_seed(26)
    n = 1 << 26
    t = 14.0 + 8.0 * torch.randn(n, device=dev, generator=gen)
    s = 35.0 + 1.5 * torch.randn(n, device=dev, generator=gen)
    w = torch.rand(n, device=dev, generator=gen, dtype=torch.float64)
    bins = [T_EDGES, S_EDGES]

    public = wall_ms(lambda: xhistogram_torch.histogram(t, s, bins=bins, weights=w,
                                                        precision="f64"))
    shape = (1, 280 * 340 + 1)
    zeros = torch.zeros(shape, dtype=torch.int64, device=dev)
    decompose = wall_ms(lambda: core._f64_sums(
        w, lambda x: x.reshape(1, -1), n, shape, lambda x: zeros,
        lambda x: zeros.double()))
    limb = torch.randint(-(2**31), 2**31, (n,), device=dev)
    passes = wall_ms(lambda: [xhistogram_torch.histogram(t, s, bins=bins, weights=limb)
                              for _ in range(6)])
    highest = wall_ms(lambda: xhistogram_torch.histogram(t, s, bins=bins, weights=w,
                                                         precision="highest"))
    out["f64"] = {"public_ms": public, "decompose_ms": decompose,
                  "six_int64_passes_ms": passes, "highest_ms": highest}
    print(f"# f64 T-S 2^26 pairs, float64 U(0,1) weights: public call {public:.3f} ms; "
          f"the decomposition alone {decompose:.3f} ms; six int64-weighted joint2 public "
          f"calls {passes:.3f} ms; 'highest' {highest:.3f} ms [{card}]")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        xhistogram_torch.histogram(t, s, bins=bins, weights=w, precision="f64")
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:10]
    out["f64_profile"] = [(e.key, e.count, e.device_time_total / 1e3) for e in rows]
    for key, count, ms in out["f64_profile"]:
        print(f"#   {ms:8.3f} ms  x{count:3d}  {key[:90]}")
    del t, s, w, limb
    torch.cuda.empty_cache()

    # --- streaming from host memory -------------------------------------------
    shape = (256, 1 << 20)
    T = (14.0 + 8.0 * torch.randn(shape, device=dev, generator=gen)).cpu()
    S = (35.0 + 1.5 * torch.randn(shape, device=dev, generator=gen)).cpu()
    rows = shape[0] // 16

    def stream():
        acc = xhistogram_torch.StreamingHistogram(bins=bins)
        for k in range(16):
            acc.update(T[k * rows:(k + 1) * rows], S[k * rows:(k + 1) * rows])
        return acc.result()[0]

    streamed = wall_ms(stream)
    pinned = torch.empty((rows, shape[1]), pin_memory=True)
    host_copy = wall_ms(lambda: [pinned.copy_(x[k * rows:(k + 1) * rows])
                                 for k in range(16) for x in (T, S)])
    on_card = torch.empty((rows, shape[1]), device=dev)
    h2d = wall_ms(lambda: [on_card.copy_(pinned, non_blocking=True) for _ in range(32)])
    td, sd = T.to(dev), S.to(dev)
    kernels = wall_ms(lambda: [xhistogram_torch.histogram(td[k * rows:(k + 1) * rows],
                                                          sd[k * rows:(k + 1) * rows],
                                                          bins=bins) for k in range(16)])
    gb = 8 * T.numel() / 1e9
    out["streaming_2^28"] = {"wall_ms": streamed, "host_to_pinned_ms": host_copy,
                             "pinned_h2d_ms": h2d, "kernels_ms": kernels, "gb": gb}
    print(f"# streamed T-S 2^28 pairs ({gb:.2f} GB) from host memory, 16 chunks: wall "
          f"{streamed:.1f} ms ({gb / streamed * 1e3:.2f} GB/s); host copy into pinned "
          f"memory alone {host_copy:.1f} ms; pinned host-to-device copy alone {h2d:.1f} ms; "
          f"16 device-resident calls {kernels:.2f} ms [{card}]")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
