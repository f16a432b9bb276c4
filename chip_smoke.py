"""Smoke run of the PyTorch port (``xhistogram_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels (``csrc/joint2.cu``, ``csrc/one_input.cu``,
``csrc/factored.cu``, ``csrc/direct.cu``) from the sources in this checkout,
holds each bit-exact against its plain PyTorch version on the card, and
drives the ported paths through the public ``xhistogram_torch.histogram``,
with the kernels' launch counts set to 0 just before each path and read
just after:

- joint2: the 280x340 watermass T–S histogram of bench.py over 2^30 float32
  pairs;
- one_input: BASELINE config 1 ((1000, 100000) float32, 50 bins, every axis
  reduced), config 2 unweighted (the same array with ``axis=1``, with and
  without ``density``), 2^30 float32 in 64 bins, and config 4 at one year
  of daily 1° SST ((365, 180, 360) float32, ``axis=0``);
- factored: the README's joint T–S diagram per depth level ((73, 50, 64800)
  float32 x 2, 280x340 bins, ``axis=(0, 2)``, per row), 5e7 pairs in
  1000x1000 bins (full), (1000, 100000) x 2 in 150x90 bins (per row) and
  (16384, 64) x 2 in 120x90 bins (packed);
- direct: (64800, 64) and (1000, 64) x 2 in 40x40 bins per row;
- forced ``method="cuda"`` beyond ``plan()``'s caps: a full reduction over
  2^21 slots (factored) and kept rows over 8192 slots (direct).

Before the paths, factored and direct are held against their plain versions
on edge cases, ragged sizes, three inputs, one input in 5000 bins, slot
counts either side of the shared-memory limit, data types, strided and
broadcast views. It checks the counts against the plain versions and the
port's numpy references (``tests/ts_cases.py``), and times kernels, plain
versions, one PyTorch library call where one computes the same function,
and the public calls with CUDA events or the wall clock. Any mismatch
raises. The line before the last is the card's name and power limit; the
last line of standard output is one JSON object, ``{"ok": true, ...}``.
Without a CUDA card it fails before printing a result. It imports nothing
of JAX.
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
CONFIG1 = (1000, 100_000)  # benchmarks/run_baselines.py configs 1 and 2
EDGES1 = np.linspace(-4, 4, 51)
N_ROW = 1 << 30  # the 10^9-element one-input row (doc/perf_model.md:46)
EDGES_ROW = np.linspace(-4, 4, 65)
SST = (365, 180, 360)  # config 4 at one year of daily 1-degree data
EDGES_SST = np.linspace(0, 40, 81)
N_DTYPE = 1 << 24  # kernel vs plain per data type

# the factored and direct paths, all with N(0,1) data except the T-S one
README_TS = (73, 50, 64800)  # README.md:13-19: (time, depth, cell), axis=(0, 2)
N_FULL = 50_000_000  # doc/perf_model.md:54, 1000x1000 bins on [-4, 4], full
PER_ROW = (1000, 100_000)  # perf_model.md:55, axis=1, 150x90 bins
PACKED = (16384, 64)  # perf_model.md:56, axis=1, 120x90 bins
DIRECT = ((64800, 64), (1000, 64))  # perf_model.md:57 at config 4's grid and its own
SLOT_ROUTES = ("full", "per_row", "packed", "direct")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, outside the tensor cores


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


def in_turns(plain, kernel, reps=10):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain after a
    warm-up of each."""
    kernel(), plain()
    plain_a, kernel_a, kernel_b, plain_b = (
        event_ms(f, reps) for f in (plain, kernel, kernel, plain)
    )
    return (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2


def bound(n_bytes, n_ops):
    """(least ms, what bounds it): the bytes moved at the card's memory rate
    against the comparisons at its float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def search_steps(nb):
    """Comparisons of one binary search over nb + 1 thresholds."""
    return int(np.ceil(np.log2(nb + 2)))


def linspace_edges(nb):
    return np.linspace(-4.0, 4.0, nb + 1)


def factored_and_direct(dev, card, thresholds, reset_counts, counts_now,
                        max_abs_err):
    """The factored and direct kernels: each held bit-exact against its plain
    version on edge cases, sizes, slot counts, dtypes and views, then the
    five paths driven through the public API with the launch counts read.
    Returns the two kernels' entries of the ``kernels`` line."""
    from ts_cases import EDGE_SETS, S_EDGES, T_EDGES, edge_case_data, numpy_hist2d
    import xhistogram_torch
    from xhistogram_torch.ops import cuda_hist
    from xhistogram_torch.utils.axes import canonicalize_2d, normalize_axis
    from xhistogram_torch.utils.profiling import measure

    max_abs_err.update(factored=0, direct=0)

    def operands(layouts, edges):
        """Each input's thresholds on the card, and the bin counts."""
        np_dtypes = [torch.empty(0, dtype=x.dtype).numpy().dtype for x in layouts]
        return ([thresholds(e, d) for e, d in zip(edges, np_dtypes)],
                [len(e) - 1 for e in edges])

    def call(layouts, edges, route, plain=False, ops=None):
        thr, nbins = ops or operands(layouts, edges)
        if route == "direct":
            fn = cuda_hist.direct_reference if plain else cuda_hist.direct
            return fn(layouts, thr, nbins)
        fn = cuda_hist.factored_reference if plain else cuda_hist.factored
        return fn(layouts, thr, nbins, route)

    def check(label, got, want, route):
        key = "direct" if route == "direct" else "factored"
        err = int((got - want).abs().max()) if got.numel() else 0
        max_abs_err[key] = max(max_abs_err[key], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: {key} ({route}) != plain (max abs err {err})")

    def compare(label, layouts, edges, routes=SLOT_ROUTES, expected=None):
        for route in routes:
            got = call(layouts, edges, route)
            want = call(layouts, edges, route, plain=True)
            torch.cuda.synchronize()
            check(label, got, want, route)
            if expected is not None and route == "full":
                np.testing.assert_array_equal(
                    got[0, :-1].cpu().numpy().reshape(expected.shape), expected,
                    err_msg=f"{label}: factored (full) != numpy")
        strides = " ".join("x".join(map(str, x.stride())) for x in layouts)
        dtypes = "/".join(str(x.dtype).replace("torch.", "") for x in layouts)
        bins = "x".join(str(len(e) - 1) for e in edges)
        print(f"# factored/direct == plain: {label} ({len(layouts)} x "
              f"{tuple(layouts[0].shape)}, strides {strides}, {dtypes}, {bins} bins; "
              f"{', '.join(routes)})")

    # === kernel vs plain on the card, bit-exact ==============================
    for name, (te, se) in EDGE_SETS.items():
        t, s = (x[: len(x) // 2 * 2] for x in edge_case_data(te, se, n_random=100_000))
        third = np.full_like(t, 0.5)  # in the second of its two bins
        h2 = numpy_hist2d(t, s, te, se)
        compare(f"edges ±1 ulp, NaN, ±inf, ±0, subnormals, {name}",
                [torch.from_numpy(x).to(dev).reshape(2, -1) for x in (t, s, third)],
                [te, se, [0.0, 0.25, 1.0]], expected=np.stack([0 * h2, h2], -1))
    x = torch.tensor([[-1e-45, 1e-45, -0.0, 0.0]], device=dev)
    compare("-1e-45 vs a 0.0 edge is below the range", [x, torch.full_like(x, 0.5)],
            [[0.0, 1.0]] * 2, expected=np.array([[3]]))
    gen = torch.Generator(device=dev).manual_seed(2)
    for m, c in ((0, 5), (5, 0), (1, 1), (7, 1), (3, 4097), (1, (1 << 20) + 3), (4099, 3)):
        compare(f"ragged m={m} c={c}",
                [torch.randn(m, c, device=dev, generator=gen) for _ in range(2)],
                [linspace_edges(50), linspace_edges(30)])
    x3 = [torch.randn(1 << 24, device=dev, generator=gen) for _ in range(3)]
    e3 = [linspace_edges(100), linspace_edges(100), linspace_edges(50)]
    compare("three inputs (500,000 slots)", [x.reshape(1, -1) for x in x3], e3,
            routes=("full",))
    compare("three inputs (500,000 slots), kept rows", [x.reshape(256, -1) for x in x3],
            e3, routes=("per_row", "direct"))
    compare("three inputs, narrow rows", [x.reshape(-1, 64)[:2048] for x in x3],
            [linspace_edges(20), linspace_edges(25), linspace_edges(20)])
    compare("one input, 5000 bins", [x3[0].reshape(1, -1)], [linspace_edges(5000)],
            routes=("full",))
    compare("one input, 5000 bins, kept rows", [x3[0].reshape(-1, 4096)[:512]],
            [linspace_edges(5000)], routes=("per_row", "packed", "direct"))
    compare("one input, 5000 bins, narrow rows", [x3[0].reshape(-1, 64)[:4096]],
            [linspace_edges(5000)], routes=("packed", "direct"))
    for nb in (239, 240):  # 57,121 slots in shared memory; 57,600 in device memory
        compare(f"{nb}x{nb}, either side of the shared-memory limit",
                [x.reshape(1, -1) for x in x3[:2]], [linspace_edges(nb)] * 2,
                routes=("full",))
        compare(f"{nb}x{nb}, either side of the shared-memory limit, kept rows",
                [x.reshape(64, -1) for x in x3[:2]], [linspace_edges(nb)] * 2,
                routes=("per_row", "packed", "direct"))
    x64 = x3[0].reshape(4096, -1).double()
    for dtypes in ((torch.float64,) * 2, (torch.int32,) * 2, (torch.int64,) * 2,
                   (torch.float16,) * 2, (torch.float32, torch.float64),
                   (torch.int32, torch.float32), (torch.int32, torch.int64)):
        layouts, edges = [], []
        for i, dtype in enumerate(dtypes):
            x = x64.roll(i, 1)
            if dtype.is_floating_point:
                layouts.append(x.to(dtype))
                edges.append(linspace_edges(40))
            elif dtype == torch.int32:
                layouts.append((x * 2000).to(dtype))
                edges.append(np.linspace(-3000.5, 3000.5, 41))
            else:
                layouts.append((x * 2.0**43).to(dtype))
                edges.append(np.linspace(-(2.0**44), 2.0**44, 41))
        compare("dtypes", layouts, edges)
    compare("30,001 float64 thresholds, searched in device memory",
            [x64[:256]], [np.sort(np.random.default_rng(5).normal(0, 1.5, 30_001))])
    a = x3[0].reshape(2048, -1)[:2000, :5000]
    row = x3[1][:5000].reshape(1, -1).expand(2000, 5000)
    col = x3[2][:2000].reshape(-1, 1).double().expand(2000, 5000)
    e_views = [linspace_edges(20), linspace_edges(30), linspace_edges(10)]
    for label, layouts in (("strided", [a, a.t().contiguous().t()]),
                           ("broadcast row", [a, row]),
                           ("broadcast column of another dtype", [a, col]),
                           ("every other column", [a[:, ::2], row[:, ::2]]),
                           ("three views", [row, col, a])):
        compare(label, layouts, e_views[: len(layouts)])
    del x3, x64, a, row, col, layouts

    # forced method="cuda" beyond plan()'s caps, through the public API
    gen = torch.Generator(device=dev).manual_seed(3)
    pair = [torch.randn(1 << 24, device=dev, generator=gen) for _ in range(2)]
    narrow = torch.randn(4096, 100, device=dev, generator=gen)
    for label, args, bins, axis, route in (
        ("full reduction, 1500x1500 = 2,250,000 slots", pair, [linspace_edges(1500)] * 2,
         None, "full"),
        ("kept rows, 33,000 bins", [narrow], [linspace_edges(33_000)], (1,), "direct"),
    ):
        layouts = [canonicalize_2d(x, normalize_axis(axis, x.ndim)) for x in args]
        m, c = layouts[0].shape
        nbins = tuple(len(e) - 1 for e in bins)
        kernel = cuda_hist.plan(len(args), nbins, 1 if axis is None else m,
                                None if axis is None else c)
        if kernel is not None:
            raise AssertionError(f"forced {label}: plan() names {kernel}")
        reset_counts()
        h, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, method="cuda")
        torch.cuda.synchronize()
        launched = counts_now()
        key = "direct" if route == "direct" else f"factored {route}"
        if launched[key] != 1 or sum(launched.values()) != 1:
            raise AssertionError(f"forced {label}: launches {launched}")
        check(f"forced {label}", h.reshape(h.shape[0] if axis else 1, -1),
              call(layouts, bins, route, plain=True)[:, :-1], route)
        print(f"# forced method='cuda', {label}: plan() names no kernel, ran {key} "
              f"once, == plain")
    del pair, narrow, h

    # === the paths through the public API =====================================
    def path(label, args, bins, axis, kernel, route, numpy_check, plain_reps=10):
        """Drives one path with fresh counts, checks it against the plain
        version and numpy, times kernel, plain version and public call."""
        axis_t = normalize_axis(axis, args[0].ndim)
        layouts = [canonicalize_2d(x, axis_t) for x in args]
        m, c = layouts[0].shape
        nbins = tuple(len(e) - 1 for e in bins)
        planned = cuda_hist.plan(len(args), nbins, 1 if axis is None else m,
                                 None if axis is None else c)
        if planned != kernel:
            raise AssertionError(f"{label}: plan() names {planned}, not {kernel}")
        reset_counts()
        h, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis)
        torch.cuda.synchronize()
        launched = counts_now()
        key = "direct" if route == "direct" else f"factored {route}"
        if launched[key] < 1 or sum(launched.values()) != launched[key]:
            raise AssertionError(f"{label}: launches {launched}")
        rows = 1 if route == "full" else m
        plain = call(layouts, bins, route, plain=True)
        check(label, h.reshape(rows, -1), plain[:, :-1], route)
        del plain
        numpy_check(h)
        ops = operands(layouts, bins)  # uploaded once, outside the timing
        kernel_ms, plain_ms = in_turns(
            lambda: call(layouts, bins, route, plain=True, ops=ops),
            lambda: call(layouts, bins, route, ops=ops), reps=plain_reps)
        med, times = measure(
            lambda: xhistogram_torch.histogram(*args, bins=bins, axis=axis), reps=5)
        n_elems = layouts[0].numel()
        in_bytes = sum(x.element_size() for x in layouts) * n_elems
        out_bytes = 8 * rows * (int(np.prod(nbins)) + 1)
        bound_ms, bound_by = bound(in_bytes + out_bytes,
                                   n_elems * sum(search_steps(nb) for nb in nbins))
        print(f"# path {label}: plan {kernel}, launches {launched[key]} ({key}), "
              f"int64 {tuple(h.shape)} == plain and numpy; kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({in_bytes / 1e6:.1f} MB read, {out_bytes / 1e6:.1f} MB written), "
              f"public call median {med * 1e3:.3f} ms of "
              f"{[round(t * 1e3, 3) for t in times]} [{card}]")
        return {"launches": launched[key], "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}

    def per_row_numpy(label, a, b, bins, rows):
        def run(h):
            for r in rows:
                want = numpy_hist2d(a[r].cpu().numpy(), b[r].cpu().numpy(), *bins)
                np.testing.assert_array_equal(h[r].cpu().numpy(), want,
                                              err_msg=f"{label}, row {r}")
        return run

    paths = {}
    # README.md:13-19: the joint T-S diagram per depth level
    gen = torch.Generator(device=dev).manual_seed(13)
    T = 14.0 + 8.0 * torch.randn(README_TS, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(README_TS, device=dev, generator=gen)

    def readme_numpy(h):
        for level in (0, README_TS[1] - 1):
            want = numpy_hist2d(T[:, level].cpu().numpy(), S[:, level].cpu().numpy(),
                                T_EDGES, S_EDGES)
            np.testing.assert_array_equal(h[level].cpu().numpy(), want,
                                          err_msg=f"README path, level {level}")

    paths["README per-level T-S"] = path(
        "README per-level T-S, (73, 50, 64800) float32 x 2, 280x340 bins, axis=(0, 2)",
        [T, S], [T_EDGES, S_EDGES], (0, 2), "factored_per_row", "per_row",
        readme_numpy, plain_reps=3)
    del T, S
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(54)
    a, b = (torch.randn(N_FULL, device=dev, generator=gen) for _ in range(2))
    e1000 = [linspace_edges(1000)] * 2
    n_np = 1 << 22

    def full_numpy(h):
        got, _ = xhistogram_torch.histogram(a[:n_np], b[:n_np], bins=e1000)
        want = numpy_hist2d(a[:n_np].cpu().numpy(), b[:n_np].cpu().numpy(), *e1000)
        np.testing.assert_array_equal(got.cpu().numpy(), want,
                                      err_msg="1000x1000 path, first 2^22 pairs")

    paths["1000x1000 full"] = path(
        "perf_model.md:54, 5e7 float32 pairs, 1000x1000 bins, full", [a, b], e1000,
        None, "factored", "full", full_numpy)
    del a, b

    for key, label, shape, nbins, kernel, route in (
        ("150x90 per row", "perf_model.md:55, (1000, 100000) float32 x 2, 150x90 bins, "
         "axis=1", PER_ROW, (150, 90), "factored_per_row", "per_row"),
        ("120x90 packed", "perf_model.md:56, (16384, 64) float32 x 2, 120x90 bins, "
         "axis=1", PACKED, (120, 90), "factored_packed", "packed"),
        ("40x40 direct", "perf_model.md:57 at config 4's grid, (64800, 64) float32 x 2, "
         "40x40 bins, axis=1", DIRECT[0], (40, 40), "direct", "direct"),
        ("40x40 direct m=1000", "perf_model.md:57, (1000, 64) float32 x 2, 40x40 bins, "
         "axis=1", DIRECT[1], (40, 40), "direct", "direct"),
    ):
        gen = torch.Generator(device=dev).manual_seed(shape[0])
        a, b = (torch.randn(shape, device=dev, generator=gen) for _ in range(2))
        bins = [linspace_edges(nb) for nb in nbins]
        paths[key] = path(label, [a, b], bins, (1,), kernel, route,
                          per_row_numpy(label, a, b, bins, (0, 1, shape[0] - 1)))
        del a, b
        torch.cuda.empty_cache()

    print("# factored and direct yardstick: none; torch.histogramdd raises on CUDA "
          "tensors (the joint2 yardstick line above), and no other single PyTorch "
          "call bins N inputs per kept row")
    factored_paths = [v for k, v in paths.items() if "direct" not in k]
    direct_paths = [v for k, v in paths.items() if "direct" in k]
    readme, direct_main = paths["README per-level T-S"], paths["40x40 direct"]
    return [
        {
            "name": "factored",
            "route": "cuda",
            "source": "xhistogram_torch/csrc/factored.cu",
            "replaces": "xhistogram_tpu/ops/pallas_hist.py:1757",
            "launches": sum(p["launches"] for p in factored_paths),
            "max_abs_err": max_abs_err["factored"],
            "ms": readme["ms"],
            "plain_ms": readme["plain_ms"],
            "bound_ms": readme["bound_ms"],
            "bound_by": readme["bound_by"],
            "library_ms": None,
        },
        {
            "name": "direct",
            "route": "cuda",
            "source": "xhistogram_torch/csrc/direct.cu",
            "replaces": "xhistogram_tpu/ops/pallas_hist.py:2149",
            "launches": sum(p["launches"] for p in direct_paths),
            "max_abs_err": max_abs_err["direct"],
            "ms": direct_main["ms"],
            "plain_ms": direct_main["plain_ms"],
            "bound_ms": direct_main["bound_ms"],
            "bound_by": direct_main["bound_by"],
            "library_ms": None,
        },
    ]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    from ts_cases import (
        EDGE_SETS, S_EDGES, T_EDGES, edge_case_data, edge_case_values,
        numpy_hist2d, reference_numpy, reference_numpy_ts, ts_data,
    )
    import xhistogram_torch
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.ops import _build, cuda_hist
    from xhistogram_torch.utils.axes import canonicalize_2d
    from xhistogram_torch.utils.profiling import measure

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"# card: {card} | torch.cuda: {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    def reset_counts():
        cuda_hist.JOINT2_LAUNCHES = 0
        cuda_hist.ONE_INPUT_LAUNCHES = 0
        cuda_hist.FACTORED_LAUNCHES.update(dict.fromkeys(cuda_hist.FACTORED_LAUNCHES, 0))
        cuda_hist.DIRECT_LAUNCHES = 0

    def counts_now():
        return {"joint2": cuda_hist.JOINT2_LAUNCHES,
                "one_input": cuda_hist.ONE_INPUT_LAUNCHES,
                **{f"factored {v}": n for v, n in cuda_hist.FACTORED_LAUNCHES.items()},
                "direct": cuda_hist.DIRECT_LAUNCHES}

    def thresholds(edges, dtype=np.float32):
        ce = compare_form(edges, dtype)
        if ce.n_hi_clip:
            raise ValueError("the kernels take thresholds with n_hi_clip == 0")
        return torch.from_numpy(ce.edges).to(dev)

    # --- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"# build: {time.perf_counter() - t0:.2f} s (one nvcc per source, in "
          "parallel, sm_90a)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"#   ptxas: {line.strip()}")

    # === joint2 ===============================================================
    # --- kernel vs plain on the card, bit-exact --------------------------------
    t_edges, s_edges = T_EDGES, S_EDGES  # bench.py's float32 edges
    max_abs_err = {"joint2": 0, "one_input": 0}

    def compare(label, t, s, te, se, expected=None):
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        ta, tb = thresholds(te, np_dtype), thresholds(se, np_dtype)
        nba, nbb = len(te) - 1, len(se) - 1
        got = cuda_hist.joint2(t, s, ta, tb, nba, nbb)
        want = cuda_hist.joint2_reference(t, s, ta, tb, nba, nbb)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        max_abs_err["joint2"] = max(max_abs_err["joint2"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: kernel != plain (max abs err {err})")
        if expected is not None:
            np.testing.assert_array_equal(
                got[0, :-1].reshape(nba, nbb).cpu().numpy(), expected,
                err_msg=f"{label}: kernel != numpy",
            )
        print(f"# joint2 == plain: {label} ({t.numel()} pairs, {nba}x{nbb} bins)")

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
    t24, s24 = t_cmp[:N_DTYPE], s_cmp[:N_DTYPE]
    compare("float64 data 2^24", t24.double(), s24.double(), t_edges, s_edges)
    compare("int32 data 2^24", (t24 * 64).int(), (s24 * 64).int(),
            t_edges * 64 + 0.5, s_edges * 64)
    compare("int64 data 2^24", (t24 * 64).long() << 34, (s24 * 64).long() << 34,
            t_edges.astype(np.float64) * 2.0**40 + 0.5, s_edges.astype(np.float64) * 2.0**40)
    compare("float16 data 2^24", t24.half(), s24.half(), t_edges, s_edges)

    ta, tb = thresholds(t_edges), thresholds(s_edges)
    j2_kernel_ms, j2_plain_ms = in_turns(
        lambda: cuda_hist.joint2_reference(t_cmp, s_cmp, ta, tb, 280, 340),
        lambda: cuda_hist.joint2(t_cmp, s_cmp, ta, tb, 280, 340),
    )
    print(f"# joint2 2^26 pairs, 280x340 bins: kernel {j2_kernel_ms:.4f} ms "
          f"({8 * N_CMP / j2_kernel_ms / 1e6:.1f} GB/s), plain {j2_plain_ms:.4f} ms "
          f"({8 * N_CMP / j2_plain_ms / 1e6:.1f} GB/s) [{card}]")
    # the library's joint histogram, as a yardstick the port never calls
    j2_library_ms = None
    try:
        pairs = torch.stack([t_cmp, s_cmp], dim=1)
        edge_ts = [torch.from_numpy(e.astype(np.float32)).to(dev) for e in (t_edges, s_edges)]
        torch.histogramdd(pairs, bins=edge_ts)
        j2_library_ms = event_ms(lambda: torch.histogramdd(pairs, bins=edge_ts))
        print(f"# joint2 yardstick torch.histogramdd at 2^26 pairs: {j2_library_ms:.4f} ms [{card}]")
    except (RuntimeError, NotImplementedError) as ex:
        print(f"# joint2 yardstick torch.histogramdd on CUDA tensors: "
              f"{type(ex).__name__}: {str(ex).splitlines()[0]}")
    pairs = None
    j2_bound_ms, j2_bound_by = bound(
        8 * N_CMP + 8 * (280 * 340 + 1), N_CMP * (search_steps(280) + search_steps(340))
    )
    del t_cmp, s_cmp, t24, s24

    # --- the joint2 path through the public API ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    T = 14.0 + 8.0 * torch.randn(N_MAIN, device=dev, generator=gen)  # bench.py:163
    S = 35.0 + 1.5 * torch.randn(N_MAIN, device=dev, generator=gen)
    torch.cuda.synchronize()

    reset_counts()
    counts, _ = xhistogram_torch.histogram(T, S, bins=[t_edges, s_edges])
    torch.cuda.synchronize()
    j2_launches = cuda_hist.JOINT2_LAUNCHES
    if j2_launches < 1:
        raise AssertionError("the joint2 path did not launch the joint2 kernel")
    if counts.dtype != torch.int64 or tuple(counts.shape) != (280, 340):
        raise AssertionError(f"joint2 path gave {counts.dtype} {tuple(counts.shape)}")
    in_range = int(
        ((T >= float(t_edges[0])) & (T <= float(t_edges[-1]))
         & (S >= float(s_edges[0])) & (S <= float(s_edges[-1]))).sum()
    )
    total = int(counts.sum())
    if total != in_range:
        raise AssertionError(f"joint2 path counted {total} pairs, {in_range} are in range")
    print(f"# joint2 path: JOINT2_LAUNCHES={j2_launches}, int64 (280, 340), "
          f"{total} of {T.numel()} pairs in range")

    # every bin against the plain version, run over row blocks of 2^26 pairs
    # so its int64 index tensors stay ~2 GiB
    plain_counts = sum(
        cuda_hist.joint2_reference(tb_, sb_, ta, tb, 280, 340)
        for tb_, sb_ in zip(T.split(64), S.split(64))
    )
    plain_counts = plain_counts[0, :-1].reshape(280, 340)
    err = int((counts - plain_counts).abs().max())
    max_abs_err["joint2"] = max(max_abs_err["joint2"], err)
    if not torch.equal(counts, plain_counts):
        raise AssertionError(f"joint2 path != plain version over 2^30 pairs (max abs err {err})")
    print("# joint2 path == plain version bin by bin over all 2^30 pairs "
          "(16 row blocks of 64 x 2^20)")

    t_np = T[:, :SLICE_COLS].cpu().numpy()
    s_np = S[:, :SLICE_COLS].cpu().numpy()
    expected = reference_numpy_ts(t_np, s_np, t_edges, s_edges)
    got, _ = xhistogram_torch.histogram(
        T[:, :SLICE_COLS], S[:, :SLICE_COLS], bins=[t_edges, s_edges]
    )
    np.testing.assert_array_equal(got.cpu().numpy(), expected)
    print(f"# joint2 path == reference_numpy_ts on the {N_MAIN[0]}x{SLICE_COLS} slice")

    med, times = measure(
        lambda: xhistogram_torch.histogram(T, S, bins=[t_edges, s_edges]), reps=5
    )
    print(f"# public call, joint2 path 2^30 pairs: median {med * 1e3:.3f} ms of "
          f"{[round(x * 1e3, 3) for x in times]}, {8 * T.numel() / med / 1e9:.1f} GB/s "
          f"[{card}]")
    del T, S, counts, plain_counts, got
    torch.cuda.empty_cache()  # the joint2 path's 8 GiB go back before one_input

    # === one_input ============================================================
    # --- kernel vs plain on the card, bit-exact --------------------------------
    def compare_one(label, x2d, edges, reduce_all, expected=None):
        np_dtype = torch.empty(0, dtype=x2d.dtype).numpy().dtype
        thr = thresholds(edges, np_dtype)
        nb = len(edges) - 1
        got = cuda_hist.one_input(x2d, thr, nb, reduce_all)
        want = cuda_hist.one_input_reference(x2d, thr, nb, reduce_all)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        max_abs_err["one_input"] = max(max_abs_err["one_input"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: one_input kernel != plain (max abs err {err})")
        if expected is not None:
            np.testing.assert_array_equal(
                got[:, :-1].cpu().numpy().reshape(expected.shape), expected,
                err_msg=f"{label}: one_input kernel != numpy",
            )
        stride = "x".join(map(str, x2d.stride()))
        print(f"# one_input == plain: {label} ({tuple(x2d.shape)}, strides {stride}, "
              f"{x2d.dtype}, {nb} bins, {'full' if reduce_all else 'kept rows'})")

    for name, pair in EDGE_SETS.items():
        for which, edges in zip(("first", "second"), pair):
            edges = np.asarray(edges)
            x_np = edge_case_values(edges, n_random=100_000, seed=len(edges))
            x = torch.from_numpy(x_np).to(dev)
            label = f"edges ±1 ulp, NaN, ±inf, ±0, subnormals, {name} {which}"
            compare_one(label, x.reshape(1, -1), edges, True,
                        expected=reference_numpy(x_np, edges))
            rows = torch.stack([x, x.flip(0)])
            compare_one(label, rows, edges, False)
            compare_one(label, rows.t().contiguous().t(), edges, False)
    x = torch.tensor([[-1e-45, 1e-45, -0.0, 0.0]], device=dev)
    compare_one("-1e-45 vs a 0.0 edge is below the range", x, z, True,
                expected=np.array([3]))

    for n in (0, 1, 7, 4097, (1 << 20) + 3):
        x_np = ts_data((n,), seed=n)[0] / 4 - 3.5
        x = torch.from_numpy(x_np).to(dev)
        compare_one(f"ragged n={n}", x.reshape(1, n), EDGES1, True,
                    expected=reference_numpy(x_np, EDGES1))
        compare_one(f"ragged n={n}", x.reshape(1, n), EDGES1, False)
        if n > 1:
            compare_one(f"ragged n={n}, every other element", x[::2].reshape(1, -1),
                        EDGES1, True)

    gen = torch.Generator(device=dev).manual_seed(1)
    for c in (1, 7, 365, 100_000):
        m = min(1 << 16, (1 << 24) // c)
        x = torch.randn(m, c, device=dev, generator=gen)
        x[::7, ::3] = float("nan")
        compare_one(f"kept rows c={c}", x, EDGES1, False)
        compare_one(f"kept rows c={c}, strided", x.t().contiguous().t(), EDGES1, False)
        compare_one(f"all rows c={c}", x, EDGES1, True)
    x = torch.randn(N_DTYPE, device=dev, generator=gen, dtype=torch.float64)
    for nb in (1, 50, 64, 1024):
        edges = np.linspace(-4, 4, nb + 1)
        xf = x.float()
        compare_one(f"nb={nb}", xf.reshape(1, -1), edges, True)
        compare_one(f"nb={nb}", xf.reshape(4096, -1), edges, False)
        compare_one(f"nb={nb}", xf.reshape(-1, 4096).t(), edges, False)
    for dtype, data, edges in (
        (torch.float64, x, EDGES1),
        (torch.int32, (x * 2000).int(), np.linspace(-3000.5, 3000.5, 51)),
        (torch.int64, (x * 2.0**43).long(), np.linspace(-(2.0**44), 2.0**44, 51)),
        (torch.float16, x.half(), EDGES1),
    ):
        for layout, reduce_all in ((data.reshape(1, -1), True),
                                   (data.reshape(4096, -1), False),
                                   (data.reshape(-1, 4096).t(), False)):
            compare_one(f"{dtype} data 2^24", layout, edges, reduce_all)
    del x, xf, data, layout

    # --- config 1: (1000, 100000) float32, full reduction ----------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    x1 = torch.randn(CONFIG1, device=dev, generator=gen)
    x1_np = x1.cpu().numpy()
    thr1 = thresholds(EDGES1)
    reset_counts()
    h1, _ = xhistogram_torch.histogram(x1, bins=[EDGES1])
    torch.cuda.synchronize()
    launches = {"config 1": cuda_hist.ONE_INPUT_LAUNCHES}
    plain1 = cuda_hist.one_input_reference(x1.reshape(1, -1), thr1, 50, True)[0, :-1]
    max_abs_err["one_input"] = max(max_abs_err["one_input"], int((h1 - plain1).abs().max()))
    if not torch.equal(h1, plain1):
        raise AssertionError("config 1: public call != plain version")
    np.testing.assert_array_equal(h1.cpu().numpy(), reference_numpy(x1_np, EDGES1),
                                  err_msg="config 1: public call != numpy")
    print(f"# config 1 (1000, 100000) float32, 50 bins, full: ONE_INPUT_LAUNCHES="
          f"{launches['config 1']}, == plain and numpy, {int(h1.sum())} in range")

    # --- config 2 unweighted: the same array, axis=1, with and without density -
    reset_counts()
    h2, _ = xhistogram_torch.histogram(x1, bins=[EDGES1], axis=1)
    d2, _ = xhistogram_torch.histogram(x1, bins=[EDGES1], axis=1, density=True)
    torch.cuda.synchronize()
    launches["config 2"] = cuda_hist.ONE_INPUT_LAUNCHES
    plain2 = cuda_hist.one_input_reference(x1, thr1, 50, False)[:, :-1]
    max_abs_err["one_input"] = max(max_abs_err["one_input"], int((h2 - plain2).abs().max()))
    if not torch.equal(h2, plain2):
        raise AssertionError("config 2: public call != plain version")
    np.testing.assert_array_equal(h2.cpu().numpy(), reference_numpy(x1_np, EDGES1, (1,)),
                                  err_msg="config 2: public call != numpy")
    d2_plain, _ = xhistogram_torch.histogram(x1, bins=[EDGES1], axis=1, density=True,
                                             method="scatter")
    torch.testing.assert_close(d2, d2_plain, rtol=1e-6, atol=0)
    print(f"# config 2 unweighted, axis=1 (1000 rows x 50 bins), counts and density: "
          f"ONE_INPUT_LAUNCHES={launches['config 2']}, counts == plain and numpy, "
          f"density within rtol 1e-6 of the plain path "
          f"(max abs diff {float((d2 - d2_plain).abs().max()):.3g})")
    del plain2, h2, d2, d2_plain, x1_np

    # kernel, plain and library at config 1, in turns
    x1_row = x1.reshape(1, -1)
    oi_kernel_ms, oi_plain_ms = in_turns(
        lambda: cuda_hist.one_input_reference(x1_row, thr1, 50, True),
        lambda: cuda_hist.one_input(x1_row, thr1, 50, True),
    )
    histc = torch.histc(x1, bins=50, min=-4, max=4)
    oi_library_ms = event_ms(lambda: torch.histc(x1, bins=50, min=-4, max=4))
    histc_equal = torch.equal(histc.long(), h1)
    oi_bound_ms, oi_bound_by = bound(4 * x1.numel() + 8 * 51, x1.numel() * search_steps(50))
    print(f"# one_input at config 1: kernel {oi_kernel_ms:.4f} ms "
          f"({4 * x1.numel() / oi_kernel_ms / 1e6:.1f} GB/s), plain {oi_plain_ms:.4f} ms, "
          f"torch.histc {oi_library_ms:.4f} ms (counts equal the kernel's: {histc_equal}; "
          f"max abs diff {int((histc.long() - h1).abs().max())}), bound "
          f"{oi_bound_ms:.4f} ms by {oi_bound_by} [{card}]")
    public_ms = {}
    med, times = measure(lambda: xhistogram_torch.histogram(x1, bins=[EDGES1]), reps=5)
    public_ms["config 1"] = (med, times)
    med, times = measure(lambda: xhistogram_torch.histogram(x1, bins=[EDGES1], axis=1),
                         reps=5)
    public_ms["config 2"] = (med, times)
    del x1, x1_row, h1, plain1, histc

    # --- 2^30 float32 in 64 bins, full reduction --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    xr = torch.randn(N_ROW, device=dev, generator=gen)
    thr_row = thresholds(EDGES_ROW)
    reset_counts()
    hr, _ = xhistogram_torch.histogram(xr, bins=[EDGES_ROW])
    torch.cuda.synchronize()
    launches["2^30 row"] = cuda_hist.ONE_INPUT_LAUNCHES
    plain_r = sum(
        cuda_hist.one_input_reference(block.reshape(1, -1), thr_row, 64, True)
        for block in xr.split(N_CMP)
    )[0, :-1]
    max_abs_err["one_input"] = max(max_abs_err["one_input"], int((hr - plain_r).abs().max()))
    if not torch.equal(hr, plain_r):
        raise AssertionError("2^30 row: public call != plain version")
    in_range = int(((xr >= -4) & (xr <= 4)).sum())
    if int(hr.sum()) != in_range:
        raise AssertionError(f"2^30 row counted {int(hr.sum())}, {in_range} are in range")
    print(f"# 2^30 float32, 64 bins, full: ONE_INPUT_LAUNCHES={launches['2^30 row']}, "
          f"== plain version bin by bin (16 blocks of 2^26), {in_range} in range")
    med, times = measure(lambda: xhistogram_torch.histogram(xr, bins=[EDGES_ROW]), reps=5)
    public_ms["2^30 row"] = (med, times)
    del xr, hr, plain_r

    # --- config 4: one year of daily 1-degree SST, axis=0 -----------------------
    gen = torch.Generator(device=dev).manual_seed(4)
    sst = 20.0 + 5.0 * torch.randn(SST, device=dev, generator=gen)
    layout = canonicalize_2d(sst, (0,))
    m, c = layout.shape
    kernel = cuda_hist.plan(1, (80,), m, c)
    if kernel != "one_input" or layout.stride() != (1, m):
        raise AssertionError(f"config 4: plan {kernel}, layout strides {layout.stride()}")
    reset_counts()
    h4, _ = xhistogram_torch.histogram(sst, bins=[EDGES_SST], axis=0)
    torch.cuda.synchronize()
    launches["config 4"] = cuda_hist.ONE_INPUT_LAUNCHES
    if h4.dtype != torch.int64 or tuple(h4.shape) != (180, 360, 80):
        raise AssertionError(f"config 4 gave {h4.dtype} {tuple(h4.shape)}")
    plain4 = cuda_hist.one_input_reference(layout, thresholds(EDGES_SST), 80, False)
    plain4 = plain4[:, :-1].reshape(180, 360, 80)
    max_abs_err["one_input"] = max(max_abs_err["one_input"], int((h4 - plain4).abs().max()))
    if not torch.equal(h4, plain4):
        raise AssertionError("config 4: public call != plain version")
    np.testing.assert_array_equal(
        h4.cpu().numpy(), reference_numpy(sst.cpu().numpy(), EDGES_SST, (0,)),
        err_msg="config 4: public call != numpy",
    )
    print(f"# config 4 (365, 180, 360) float32, axis=0, 80 bins: plan {kernel}, layout "
          f"({m}, {c}) strides {layout.stride()} read in place, ONE_INPUT_LAUNCHES="
          f"{launches['config 4']}, int64 (180, 360, 80) == plain and numpy")
    med, times = measure(
        lambda: xhistogram_torch.histogram(sst, bins=[EDGES_SST], axis=0), reps=5
    )
    public_ms["config 4"] = (med, times)
    sst_bound_ms, _ = bound(4 * sst.numel() + 8 * m * 81, sst.numel() * search_steps(80))
    del sst, layout, h4, plain4

    for name, n_bytes in (("config 1", 4e8), ("config 2", 4e8), ("2^30 row", 4 * N_ROW),
                          ("config 4", 4 * np.prod(SST))):
        med, times = public_ms[name]
        print(f"# public call, {name}: median {med * 1e3:.3f} ms of "
              f"{[round(x * 1e3, 3) for x in times]}, {n_bytes / med / 1e9:.1f} GB/s "
              f"of input [{card}]")
    print(f"# config 4 bound (94.6 MB read + {8 * 64800 * 81 / 1e6:.1f} MB of int64 "
          f"written): {sst_bound_ms:.4f} ms")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the one_input path ({name}) did not launch one_input")

    slot = factored_and_direct(dev, card, thresholds, reset_counts, counts_now,
                               max_abs_err)

    print(json.dumps({"kernels": [
        {
            "name": "joint2",
            "route": "cuda",
            "source": "xhistogram_torch/csrc/joint2.cu",
            "replaces": "xhistogram_tpu/ops/pallas_hist.py:1506",
            "launches": j2_launches,
            "max_abs_err": max_abs_err["joint2"],
            "ms": j2_kernel_ms,
            "plain_ms": j2_plain_ms,
            "bound_ms": j2_bound_ms,
            "bound_by": j2_bound_by,
            "library_ms": j2_library_ms,
        },
        {
            "name": "one_input",
            "route": "cuda",
            "source": "xhistogram_torch/csrc/one_input.cu",
            "replaces": "xhistogram_tpu/ops/pallas_hist.py:1268",
            "launches": sum(launches.values()),
            "max_abs_err": max_abs_err["one_input"],
            "ms": oi_kernel_ms,
            "plain_ms": oi_plain_ms,
            "bound_ms": oi_bound_ms,
            "bound_by": oi_bound_by,
            "library_ms": oi_library_ms,
        },
        *slot,
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
