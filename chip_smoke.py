"""Smoke run of the PyTorch port (``xhistogram_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in this checkout, holds it
bit-exact against its plain PyTorch version on the card, drives the main
path — the 280x340 watermass T–S histogram of bench.py over 2^30 float32
pairs — through the public ``xhistogram_torch.histogram``, checks the counts
against the reference numpy path, and times it. Any mismatch raises. The
last line of standard output is one JSON object, ``{"ok": true, ...}``.
Without a CUDA card it fails before printing a result. It imports nothing of
JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN = (1024, 1 << 20)  # bench.py's 2^30 pairs
N_CMP = 1 << 26  # kernel vs plain comparison and timing
SLICE_COLS = 16384  # bench.py's parity slice


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
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    from bench import reference_numpy_ts
    from ts_cases import (
        EDGE_SETS, S_EDGES, T_EDGES, edge_case_data, numpy_hist2d, ts_data,
    )
    import xhistogram_torch
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.ops import _build, cuda_hist
    from xhistogram_torch.utils.profiling import measure

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"# card: {card} | torch.cuda: {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # --- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"# build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"#   ptxas: {line.strip()}")

    # --- phase 3: kernel vs plain on the card, bit-exact ---------------------
    t_edges, s_edges = T_EDGES, S_EDGES  # bench.py's float32 edges

    def thresholds(edges):
        ce = compare_form(edges, np.float32)
        if ce.n_hi_clip:
            raise ValueError("joint2 takes thresholds with n_hi_clip == 0")
        return torch.from_numpy(ce.edges).to(dev)

    max_abs_err = 0

    def compare(label, t, s, te, se, expected=None):
        nonlocal max_abs_err
        ta, tb = thresholds(te), thresholds(se)
        nba, nbb = len(te) - 1, len(se) - 1
        got = cuda_hist.joint2(t, s, ta, tb, nba, nbb)
        want = cuda_hist.joint2_reference(t, s, ta, tb, nba, nbb)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        max_abs_err = max(max_abs_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: kernel != plain (max abs err {err})")
        if expected is not None:
            np.testing.assert_array_equal(
                got[0, :-1].reshape(nba, nbb).cpu().numpy(), expected,
                err_msg=f"{label}: kernel != numpy",
            )
        print(f"# kernel == plain: {label} ({t.numel()} pairs, {nba}x{nbb} bins)")

    for label, (te, se) in EDGE_SETS.items():
        t, s = edge_case_data(te, se, n_random=100_000)
        compare(f"edges ±1 ulp, NaN, ±inf, ±0, subnormals, {label}",
                torch.from_numpy(t).to(dev), torch.from_numpy(s).to(dev), te, se,
                expected=numpy_hist2d(t, s, te, se))
    z = np.array([0.0, 1.0])
    t = np.array([-1e-45, 1e-45, -0.0, 0.0], np.float32)
    s = np.full(4, 0.5, np.float32)
    compare("-1e-45 vs a 0.0 edge is below the range", torch.from_numpy(t).to(dev),
            torch.from_numpy(s).to(dev), z, z, expected=np.array([[3]]))
    for n in (0, 1, 7, 4097, (1 << 20) + 3):
        t, s = ts_data((n,), seed=n)
        tt, ss = torch.from_numpy(t).to(dev), torch.from_numpy(s).to(dev)
        expected = numpy_hist2d(t, s, t_edges, s_edges)
        compare(f"ragged 1-D n={n}", tt, ss, t_edges, s_edges, expected)
        compare(f"ragged (1, n) n={n}", tt.reshape(1, n), ss.reshape(1, n),
                t_edges, s_edges, expected)

    gen = torch.Generator(device=dev).manual_seed(0)
    t_cmp = 14.0 + 8.0 * torch.randn(N_CMP, device=dev, generator=gen)
    s_cmp = 35.0 + 1.5 * torch.randn(N_CMP, device=dev, generator=gen)
    compare("random T-S 2^26", t_cmp, s_cmp, t_edges, s_edges)
    compare("random 8x9 2^26", t_cmp, s_cmp, np.linspace(-2, 30, 9), np.linspace(30, 40, 10))

    ta, tb = thresholds(t_edges), thresholds(s_edges)
    kernel = lambda: cuda_hist.joint2(t_cmp, s_cmp, ta, tb, 280, 340)  # noqa: E731
    plain = lambda: cuda_hist.joint2_reference(t_cmp, s_cmp, ta, tb, 280, 340)  # noqa: E731
    kernel(), plain()  # warm-up
    plain_a, kernel_a, kernel_b, plain_b = (event_ms(f) for f in (plain, kernel, kernel, plain))
    kernel_ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2
    print(f"# 2^26 pairs, 280x340 bins: kernel {kernel_ms:.4f} ms "
          f"({8 * N_CMP / kernel_ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms "
          f"({8 * N_CMP / plain_ms / 1e6:.1f} GB/s) [{card}]")
    del t_cmp, s_cmp

    # --- phase 4: the main path through the public API ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    T = 14.0 + 8.0 * torch.randn(N_MAIN, device=dev, generator=gen)  # bench.py:163
    S = 35.0 + 1.5 * torch.randn(N_MAIN, device=dev, generator=gen)
    torch.cuda.synchronize()

    cuda_hist.JOINT2_LAUNCHES = 0
    counts, _ = xhistogram_torch.histogram(T, S, bins=[t_edges, s_edges])
    torch.cuda.synchronize()
    launches = cuda_hist.JOINT2_LAUNCHES
    if launches < 1:
        raise AssertionError("the main path did not launch the joint2 kernel")
    if counts.dtype != torch.int64 or tuple(counts.shape) != (280, 340):
        raise AssertionError(f"main path gave {counts.dtype} {tuple(counts.shape)}")
    in_range = int(
        ((T >= float(t_edges[0])) & (T <= float(t_edges[-1]))
         & (S >= float(s_edges[0])) & (S <= float(s_edges[-1]))).sum()
    )
    total = int(counts.sum())
    if total != in_range:
        raise AssertionError(f"main path counted {total} pairs, {in_range} are in range")
    print(f"# main path: JOINT2_LAUNCHES={launches}, int64 (280, 340), "
          f"{total} of {T.numel()} pairs in range")

    # every bin of the main path's result against the plain version, run over
    # row blocks of 2^26 pairs so its int64 index tensors stay ~2 GiB
    ta, tb = thresholds(t_edges), thresholds(s_edges)
    plain_counts = sum(
        cuda_hist.joint2_reference(tb_, sb_, ta, tb, 280, 340)
        for tb_, sb_ in zip(T.split(64), S.split(64))
    )
    plain_counts = plain_counts[0, :-1].reshape(280, 340)
    err = int((counts - plain_counts).abs().max())
    max_abs_err = max(max_abs_err, err)
    if not torch.equal(counts, plain_counts):
        raise AssertionError(f"main path != plain version over 2^30 pairs (max abs err {err})")
    print("# main path == plain version bin by bin over all 2^30 pairs "
          "(16 row blocks of 64 x 2^20)")

    t_np = T[:, :SLICE_COLS].cpu().numpy()
    s_np = S[:, :SLICE_COLS].cpu().numpy()
    expected = reference_numpy_ts(t_np, s_np, t_edges, s_edges)
    got, _ = xhistogram_torch.histogram(
        T[:, :SLICE_COLS], S[:, :SLICE_COLS], bins=[t_edges, s_edges]
    )
    np.testing.assert_array_equal(got.cpu().numpy(), expected)
    print(f"# main path == reference_numpy_ts on the {N_MAIN[0]}x{SLICE_COLS} slice")

    med, times = measure(
        lambda: xhistogram_torch.histogram(T, S, bins=[t_edges, s_edges]), reps=5
    )
    print(f"# main path 2^30 pairs: median {med * 1e3:.3f} ms of "
          f"{[round(x * 1e3, 3) for x in times]}, {8 * T.numel() / med / 1e9:.1f} GB/s "
          f"[{card}]")

    print(json.dumps({"kernels": [{
        "name": "joint2",
        "route": "cuda",
        "source": "xhistogram_torch/csrc/joint2.cu",
        "replaces": "xhistogram_tpu/ops/pallas_hist.py:1506",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
