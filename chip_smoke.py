"""Smoke run of the PyTorch port (``xhistogram_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels (``csrc/joint2.cu`` with
``csrc/joint2_mixed.cu``, ``csrc/joint2_narrow.cu``, ``csrc/joint2_pairs.cu``
and ``csrc/joint2_pairs_swapped.cu``, ``csrc/one_input.cu``
with ``csrc/one_input_narrow.cu`` and ``csrc/one_input_unsigned.cu``, the
direct route's kernel ``csrc/direct.cuh`` with its entries
``csrc/direct_rows*.cu``, and the flat-slot kernel of the factored routes
and of direct outside that envelope, ``csrc/slot.cu`` with the weighted
entries ``csrc/slot_w*.cu``, the mixed ones ``csrc/slot_mixed.cu`` and the
narrow ones ``csrc/slot_narrow.cu``) from the sources in this checkout, printing
each source's nvcc seconds, holds each
bit-exact against its plain PyTorch version on the card (weighted float
sums within a stated tolerance), and
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
  2^21 slots (factored) and kept rows over 8192 slots (direct);
- one_input on narrow data read in place: 2^30 values in 64 bins as
  bfloat16 and as int8, each beside a widening copy and the kernel on it;
- joint2, factored and direct on narrow data read in place, each call with
  the dtypes its kernel read (``last_launch()["loads"]``), its peak memory
  (below one widened copy of the inputs) and its kernel timed in turns
  with a widening copy and the kernel on it, beside its bound: the T–S
  diagram over 2^30 pairs stored as bfloat16 and as CF-packed int16 (T as
  round(100 T), S as round(1000 (S - 35)), edges in the same units;
  joint2), 2^30 int8 pairs of 30 N(0,1) rounded in 64x64 bins (joint2's
  8-bit tables), the README's per-depth call as packed int16, unweighted
  and by a (50, 64800) float32 cell volume (factored per row), and 40x40
  direct at (64800, 64) with bfloat16 members, counts and int32 weights
  (the direct-row kernel);
- int64 beside float data, each input compared in its own type:
  ``histogram(x.long(), x)`` over ``linspace(0, 2, 1000)`` (joint2), T in
  int64 millidegrees beside float32 S at 2^26 pairs (joint2), 5e7 pairs in
  1000x1000 bins (factored), the README's per-level layout cut to 8 times
  (factored per row), 40x40 at (64800, 64) (direct); and 10^8 uint64
  values in 50 bins, flipped onto int64 (one_input);
- inputs of two dtypes, each read in place and compared in its own type,
  each call with the dtypes its kernel read, its peak memory and its
  kernel timed in turns with what earlier releases ran (a widening copy
  and the kernel on it, or the template's mixed entry), beside its bound:
  the T–S diagram over 2^30 pairs with T packed as int16, stored as
  bfloat16 or held as int32 millidegrees beside float32 S (joint2's pair
  entries), bfloat16 T beside float16 S (joint2's mixed entry, also timed
  on factored full), float32 T beside float64 S at 2^26 pairs (joint2),
  the README's per-depth call with float32 T beside float64 S (factored
  per row's mixed entry), 5e7 pairs in 1000x1000 bins with int32 beside
  float32 (factored full), and 40x40 direct at (64800, 64) with int16
  members beside int64 and int32 beside float32 (the direct-row kernel's
  mixed entry);
- views and unsigned data read in place (``view_paths``), each call with
  the view its kernel read (``last_launch()["view"] == "in place"``), its
  peak memory (the output and 1 MB: no copy of the inputs or of a
  broadcast weight) and its kernel on the view timed in turns with what
  earlier releases ran (the copy, then the kernel on it) and with the
  kernel alone on those copies: the README call's (time, depth, cell) view
  with ``axis=(0, 2)`` as float32 and as CF-packed int16, unweighted and by
  the (50, 64800) cell volume broadcast over time (factored per row); the
  same data with ``axis=1`` on one_input ((4, 50, 64800)) and direct ((2,
  50, 64800), 40x40 bins); the T–S diagram over 2^28 pairs halo-trimmed
  (``[:, 1:-1]``, joint2's runs); config 1's array as uint32 and as uint64
  (one_input's own entries);
- weighted (``weights=``): BASELINE config 2 with U(0,1) float32 weights and
  ``density`` (one_input); the T–S diagram over 2^28 pairs with float32
  weights and with int32 weights of one, two and four base-256 digits
  (joint2); the README call weighted by a (50, 64800) cell volume broadcast
  over time (factored per row); three inputs of 5e7 in 60x60x60 bins
  (factored, full); 40x40 direct with float32 weights at (1000, 64) and
  int32 weights at (64800, 64), and with float32 weights at (64800, 64),
  where the JAX package runs its scatter strategy and the port, by its own
  limits, the direct kernel, which stores float32 rows;
- the API above core: ``precision='f64'`` (exact float64 sums by int64
  limb passes through the int64-weighted kernels) on the T–S diagram at
  2^26 pairs with float64 U(0,1) weights (joint2; bit-identical over two
  runs, bit-equal to its plain decomposition, <= 1 ulp of a per-slot
  math.fsum on the first 2^20 pairs), the README call weighted by a
  float64 (50, 64800) cell volume (factored per row), config 2 (one_input)
  and 40x40 at (64800, 64) (direct) with float64 weights;
  ``StreamingHistogram`` over the main path's 2^30 pairs from host memory
  in 16 chunks (joint2) and over config 4 in kept-offset tiles (one_input),
  both bit-equal to one call, and the 'f64' cross-chunk case; the README
  call through the labeled API (factored per row); public calls at configs
  1 and 4 with the threshold cache cold and warm; ``compat.histogram2d``
  on 2^22 pairs against numpy (joint2);
- the sharded path (``parallel.histogram_sharded``) on the one card: one
  rank over NCCL (the T–S diagram at 2^26 pairs: joint2 and a real NCCL
  all-reduce), then two ranks spawned on the card over gloo, each case
  bit-equal to one unsharded call (float32 sums within two ulps): the T–S
  diagram at 2^26 pairs sharded on a reduced axis (joint2), config 4
  sharded on latitude, a kept axis (one_input; the output stays sharded),
  the README call at 8 times by cell volume sharded on cells (factored per
  row), 40x40 direct at (64800, 64) sharded on rows, and ``precision='f64'``
  on the T–S diagram at 2^24 pairs and on rows of 2^23 + 2^21 elements
  (past the JAX package's per-digit guard), with each rank's launches, the
  all-reduces and the sharded call's wall time beside the one-card call's.

First, joint2, factored (full, per row, packed) and direct are held bit for
bit against their plain versions on the adversarial threshold sets of the
bucketed digitize (``tests/ts_cases.BUCKET_EDGE_SETS``), at the default
cluster cap and at one block; one_input on the same sets (up to 1024 bins)
in each of its counter layouts (lane-private, warp replicas, aggregated;
all three must run) for counts and each accumulator class, with the widest
window L of each launch against the mirror's table, and on bfloat16,
float16, int16, int8, uint8 and bool data read in place. int64 beside
float32, float64 and float16 data is held against the plain versions on
every kernel, in both input orders, with and without weights. Each path prints the cluster size, passes and
histogram place of its launch, and the cell count K and widest window L of
each input's table (``ops.digitize.bucket_table``); the T–S path must run
one pass in clusters of two, and the README call keep its histogram in a
cluster. joint2 with float64 and uint64 sums is timed at its default
cluster against chunk passes of one block. joint2, factored (full, per
row, packed) and direct are held on bool, int8, uint8, int16, uint16,
float16 and bfloat16 data read in place against their plain versions on a
widened copy: every accumulator class, beside float32 and int32 data,
views at odd offsets and strides, every value of the 8-bit types through
their tables, and the bucketed search's adversarial edge sets as
bfloat16 and int16 data (``ts_cases.BUCKET_EDGE_SETS``). joint2,
factored and direct are held on every ordered pair of two of the eleven
data dtypes read in place against their plain versions on widened copies:
every accumulator class, the direct-row kernel's float64 rows, odd offsets
and ragged sizes, and the 8-bit tables at every value beside each wide
type.

The direct-row kernel (``csrc/direct.cuh``) is held against its plain
version at the shapes of the card-only tests (every data dtype and weight
class, finished float32 and raw rows, rows of 1 to 255 elements, strided
and stride-0 inputs and weights, slot counts either side of where a block's
warps drop, NaN and infinite weights, empty rows, 1, 3 and 12 inputs), each
case run twice bit-identical, then timed in turns with the flat-slot
template's direct entry at (64800, 64) (counts, int32 and float32 weights)
and (1000, 64), each with its bound, its device time from torch.profiler
and its launch shape (warps a row and a block, blocks, rows a warp).

Before the paths, factored and direct are held against their plain versions
on edge cases, ragged sizes, three inputs, one input in 5000 bins, slot
counts either side of the shared-memory limit, data types, strided and
broadcast views; each weighted kernel against its plain version for every
kind of weight (integer-valued, float32, float64, wrapping int32, int64,
NaN and infinities, stride-0 and strided) and against float64 and
math.fsum oracles. It checks the counts against the plain versions and the
port's numpy references (``tests/ts_cases.py``), and times kernels, plain
versions, one PyTorch library call where one computes the same function,
and the public calls with CUDA events or the wall clock; each weighted
kernel also beside its unweighted form at the same shape. Any mismatch
raises. The line before the last is the card's name and power limit; the
last line of standard output is one JSON object, ``{"ok": true, ...}``.
Without a CUDA card it fails before printing a result. It imports nothing
of JAX.
"""

import json
import math
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
SLOT_ROUTES = ("full", "per_row", "direct")  # factored over every row or per row; direct

# the weighted paths
N_TS_W = (256, 1 << 20)  # 2^28 pairs: the weighted T-S rows of doc/perf_model.md:49-53
# int32 weights spanning one, two and four signed base-256 digits (the int1,
# int2 and int4 rows there)
INT_WEIGHT_SPANS = {"int1": (0, 100), "int2": (-(2**14), 2**14),
                    "int4": (-(2**30), 2**30)}
N_3IN = 50_000_000  # three inputs in 60x60x60 bins, full

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


def launch_note(thresholds):
    """(record, text) of the last joint2 or flat-slot launch: its cluster,
    passes and histogram place, and for the first two inputs (``thresholds``,
    CPU tensors in the compare type) the cells K and the widest window L of
    the table the kernel built (``ops.digitize.bucket_table``)."""
    from xhistogram_torch.ops import cuda_hist
    from xhistogram_torch.ops.digitize import bucket_table
    rec = cuda_hist.last_launch()
    tables = []
    for thr, cells in zip(thresholds, rec["cells"]):
        if cells == 0:
            tables.append("thresholds searched in device memory")
            continue
        _, widest, (_, _, k) = bucket_table(thr, cells)
        tables.append(f"K={k} L={widest}")
    place = "shared" if rec["shared"] else "device"
    return rec, (f"cluster {rec['cluster']}, passes {rec['passes']}, histogram in "
                 f"{place} memory, {', '.join(tables)}")


def bucket_phase(dev, max_abs_err):
    """joint2, factored (full, per row, packed) and direct held bit for bit
    against their plain versions on the adversarial threshold sets of the
    bucketed digitize (``ts_cases.BUCKET_EDGE_SETS``: the T-S edges,
    linspace(-4, 4, 91), log-spaced, repeated, +-0 and subnormal, one and
    16384 bins, int32 and int64 around 2^53, float64 offset by 1e9), each
    beside a partner input whose bins make the joint histogram need a
    cluster, at the default cluster cap and at one block."""
    from ts_cases import BUCKET_EDGE_SETS, bucket_case_values
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.ops import cuda_hist

    routes = ("joint2", "full", "per_row", "packed", "direct")
    for name, (edges, dtype) in BUCKET_EDGE_SETS.items():
        x = bucket_case_values(compare_form(edges, dtype).edges, dtype,
                               n_random=400_000, seed=len(name))
        x = x[: x.size // 64 * 64]
        nba = int(np.clip(160_000 // (len(edges) - 1), 8, 3000))
        rng = np.random.default_rng(nba)
        if np.issubdtype(dtype, np.floating):
            pe, partner = np.linspace(-4, 4, nba + 1), rng.normal(0, 2, x.size)
        else:
            pe = np.linspace(-3000.5, 3000.5, nba + 1)
            partner = rng.integers(-3500, 3500, x.size)
        all_edges = [edges, pe]
        thr = [torch.from_numpy(compare_form(e, dtype).edges) for e in all_edges]
        notes = []
        for route in routes:
            rows = {"joint2": 1, "full": 1, "per_row": 4, "packed": 16, "direct": 8}[route]
            layouts = [torch.from_numpy(v.astype(dtype)).to(dev).reshape(rows, -1)
                       for v in (x, partner)]
            th = [t.to(dev) for t in thr]
            nbins = [len(e) - 1 for e in all_edges]
            for most in (cuda_hist.MAX_CLUSTER_CTAS, 1):
                default = cuda_hist.MAX_CLUSTER_CTAS
                cuda_hist.MAX_CLUSTER_CTAS = most
                try:
                    if route == "joint2":
                        got = cuda_hist.joint2(*layouts, *th, *nbins)
                        want = cuda_hist.joint2_reference(*layouts, *th, *nbins)
                    elif route == "direct":
                        got = cuda_hist.direct(layouts, th, nbins)
                        want = cuda_hist.direct_reference(layouts, th, nbins)
                    else:
                        full = route == "full"
                        got = cuda_hist.factored(layouts, th, nbins, full)
                        want = cuda_hist.factored_reference(layouts, th, nbins, full)
                    torch.cuda.synchronize()
                    _, note = launch_note(thr)
                finally:
                    cuda_hist.MAX_CLUSTER_CTAS = default
                key = {"joint2": "joint2", "direct": "direct"}.get(route, "factored")
                err = int((got - want).abs().max())
                max_abs_err[key] = max(max_abs_err[key], err)
                if not torch.equal(got, want):
                    raise AssertionError(f"bucket set {name}: {route} at <= {most} blocks "
                                         f"!= plain (max abs err {err}; {note})")
                if most != 1:
                    notes.append(f"{route}: {note}")
        print(f"# bucketed digitize == plain: {name} ({dtype.__name__}, "
              f"{len(edges) - 1} x {nba} bins, {x.size} values; default cluster cap "
              f"and one block) | " + " | ".join(notes))


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
        return fn(layouts, thr, nbins, route == "full")

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
            [linspace_edges(5000)], routes=("per_row", "direct"))
    compare("one input, 5000 bins, narrow rows", [x3[0].reshape(-1, 64)[:4096]],
            [linspace_edges(5000)], routes=("per_row", "direct"))
    for nb in (239, 240):  # either side of one block's limit before the cell tables
        compare(f"{nb}x{nb}, either side of the shared-memory limit",
                [x.reshape(1, -1) for x in x3[:2]], [linspace_edges(nb)] * 2,
                routes=("full",))
        compare(f"{nb}x{nb}, either side of the shared-memory limit, kept rows",
                [x.reshape(64, -1) for x in x3[:2]], [linspace_edges(nb)] * 2,
                routes=("per_row", "direct"))
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
        ops = operands(layouts, bins)  # uploaded once, outside the timing
        launch, note = launch_note([t.cpu() for t in ops[0]])
        key = "direct" if route == "direct" else f"factored {route}"
        if launched[key] < 1 or sum(launched.values()) != launched[key]:
            raise AssertionError(f"{label}: launches {launched}")
        rows = 1 if route == "full" else m
        plain = call(layouts, bins, route, plain=True)
        check(label, h.reshape(rows, -1), plain[:, :-1], route)
        del plain
        numpy_check(h)
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
              f"{note}, "
              f"int64 {tuple(h.shape)} == plain and numpy; kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({in_bytes / 1e6:.1f} MB read, {out_bytes / 1e6:.1f} MB written), "
              f"public call median {med * 1e3:.3f} ms of "
              f"{[round(t * 1e3, 3) for t in times]} [{card}]")
        return {"launches": launched[key], "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "launch": launch}

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
    readme_launch = paths["README per-level T-S"].pop("launch")
    if not readme_launch["shared"] or readme_launch["cluster"] != 2:
        raise AssertionError(f"README path: histogram not in a cluster of two "
                             f"({readme_launch})")
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
    for p in paths.values():
        p.pop("launch", None)
    factored_paths = [v for k, v in paths.items() if "direct" not in k]
    direct_paths = [v for k, v in paths.items() if "direct" in k]
    readme, direct_main = paths["README per-level T-S"], paths["40x40 direct"]
    return [
        {
            "name": "factored",
            "route": "cuda",
            "source": "xhistogram_torch/csrc/slot.cu",
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
            "source": "xhistogram_torch/csrc/direct.cuh",
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



def one_input_phase(dev, card, reset_counts, counts_now, max_abs_err):
    """The one_input kernel's bucketed search, counter layouts and narrow
    loads (csrc/one_input.cuh): held against its plain version on the
    adversarial threshold sets (``ts_cases.BUCKET_EDGE_SETS`` up to 1024
    bins) in each counter layout (lane-private, warp replicas, aggregated)
    and for counts and each accumulator class, the launch's K and L against
    the mirror's table; then bfloat16, float16, int16, int8, uint8 and bool
    data read in place, against the plain version on a widened copy, and
    the 2^30 row in 64 bins as bfloat16 and int8 through the public API
    with the launch counts read, timed against a widening copy and the
    kernel on it. Returns (launches of the paths, their times)."""
    from ts_cases import BUCKET_EDGE_SETS, bucket_case_values
    import xhistogram_torch
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.core import _compare_dtype
    from xhistogram_torch.ops import cuda_hist
    from xhistogram_torch.ops.bincount import weighted_dtype
    from xhistogram_torch.ops.digitize import bucket_table

    def thr_of(edges, x):
        ce = compare_form(np.asarray(edges), _compare_dtype(x))
        if ce.n_hi_clip:
            raise ValueError("the kernels take thresholds with n_hi_clip == 0")
        return torch.from_numpy(ce.edges).to(dev)

    def weights_of(shape, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        if dtype is None:
            return None
        if dtype.is_floating_point:
            return torch.rand(shape, device=dev, generator=g).to(dtype)
        return torch.randint(-(2**30), 2**30, shape, device=dev, generator=g).to(dtype)

    def check(label, x2d, edges, reduce_all, w=None):
        thr = thr_of(edges, x2d)
        nb = len(edges) - 1
        got = cuda_hist.one_input(x2d, thr, nb, reduce_all, weights=w)
        want = cuda_hist.one_input_reference(x2d, thr, nb, reduce_all, weights=w)
        torch.cuda.synchronize()
        launch = cuda_hist.last_launch()
        if w is not None and got.dtype != weighted_dtype(w.dtype):
            raise AssertionError(f"{label}: one_input gave {got.dtype}")
        if w is None or not got.is_floating_point():
            err = int((got - want).abs().max()) if got.numel() else 0
            ok = torch.equal(got, want)
        else:  # float64 adds in another order, rounded once
            err = float((got.double() - want.double()).abs().max())
            ok = bool(((got.double() - want.double()).abs()
                       <= 2.4e-7 * want.double().abs() + 1e-6).all())
        if w is None:
            max_abs_err["one_input"] = max(max_abs_err["one_input"], err)
        if not ok:
            raise AssertionError(f"{label}: one_input kernel != plain (max abs err {err}; "
                                 f"{launch})")
        return launch, thr

    # --- adversarial threshold sets, every layout and accumulator class --------
    layouts_seen = set()
    for name, (edges, dtype) in BUCKET_EDGE_SETS.items():
        if len(edges) - 1 > 1024:
            continue
        thr_np = compare_form(edges, dtype).edges
        x = bucket_case_values(thr_np, dtype, n_random=400_000, seed=len(name))
        x = torch.from_numpy(x[: x.size // 64 * 64]).to(dev)
        _, widest, _ = bucket_table(torch.from_numpy(thr_np), 2 * (len(edges) - 1))
        notes = set()
        for wdtype in (None, torch.float32, torch.int32, torch.int64):
            for x2d, reduce_all in ((x.reshape(1, -1), True),
                                    (x.reshape(-1, 4).t(), False),
                                    (x.reshape(16, -1), False)):
                w = weights_of(tuple(x2d.shape), wdtype, seed=len(name))
                launch, _ = check(f"bucket set {name}, {wdtype}", x2d, edges,
                                  reduce_all, w)
                if launch["widest"] != widest:
                    raise AssertionError(f"bucket set {name}: L {launch['widest']} != "
                                         f"the mirror's {widest}")
                layouts_seen.add(launch["layout"])
                notes.add(f"{launch['layout']}")
        print(f"# one_input == plain, bucket set {name} ({dtype.__name__}, "
              f"{len(edges) - 1} bins, {x.numel()} values; counts, float64, uint32 and "
              f"uint64 sums; full, strided and kept rows): K={2 * (len(edges) - 1)} "
              f"L={widest}, layouts {sorted(notes)}")
    if layouts_seen != set(cuda_hist.ONE_INPUT_LAYOUTS.values()):
        raise AssertionError(f"one_input layouts run: {layouts_seen}")

    # --- narrow data read in place ---------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(16)
    base = torch.randn(N_DTYPE, device=dev, generator=gen)
    narrow = {
        torch.bfloat16: (base.bfloat16(), EDGES_ROW),
        torch.float16: (base.half(), EDGES_ROW),
        torch.int16: ((base * 8000).round().clamp(-32768, 32767).to(torch.int16),
                      np.linspace(-32768.5, 32770, 65)),
        torch.int8: ((base * 30).round().clamp(-128, 127).to(torch.int8),
                     np.linspace(-128, 128, 65)),
        torch.uint8: ((base * 30 + 128).round().clamp(0, 255).to(torch.uint8),
                      np.linspace(0, 256, 65)),
        torch.bool: (base > 0.3, np.array([0.0, 0.5, 1.0])),
    }
    for dtype, (x, edges) in narrow.items():
        for x2d, reduce_all in ((x.reshape(1, -1), True), (x.reshape(4096, -1), False),
                                (x.reshape(-1, 4096).t(), False)):
            for wdtype in (None, torch.float32):
                launch, _ = check(f"{dtype} data", x2d, edges, reduce_all,
                                  weights_of(tuple(x2d.shape), wdtype, seed=3))
                if launch["load"] != dtype:
                    raise AssertionError(f"{dtype}: one_input read {launch['load']}")
        # the plain version on a widened copy gives the same counts
        wide = x.to(torch.float32 if dtype.is_floating_point else torch.int32)
        thr = thr_of(edges, x)
        a = cuda_hist.one_input(x.reshape(1, -1), thr, len(edges) - 1, True)
        b = cuda_hist.one_input_reference(wide.reshape(1, -1), thr.to(wide.dtype),
                                          len(edges) - 1, True)
        if not torch.equal(a, b):
            raise AssertionError(f"{dtype}: kernel != plain on a widened copy")
        print(f"# one_input == plain: {dtype} data read in place ({N_DTYPE} values; "
              "full, kept and strided rows; counts and float32 weights), == the plain "
              "version on a widened copy")
    del base, narrow, x, wide

    # --- the 2^30 row as bfloat16 and int8 through the public API ------------------
    launches, times = {}, {}
    gen = torch.Generator(device=dev).manual_seed(0)
    xr = torch.randn(N_ROW, device=dev, generator=gen)
    for dtype, edges in ((torch.bfloat16, EDGES_ROW), (torch.int8, np.linspace(-128, 128, 65))):
        x = xr.bfloat16() if dtype == torch.bfloat16 else \
            (xr * 30).round().clamp(-128, 127).to(torch.int8)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        h, _ = xhistogram_torch.histogram(x, bins=[edges])
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base_mem
        launched = counts_now()
        if launched["one_input"] != 1 or sum(launched.values()) != 1:
            raise AssertionError(f"2^30 {dtype} row: launches {launched}")
        if extra > x.numel() * x.element_size() // 4:
            raise AssertionError(f"2^30 {dtype} row: {extra} bytes allocated beside the data")
        launch = cuda_hist.last_launch()
        thr = thr_of(edges, x)
        plain = sum(cuda_hist.one_input_reference(block.reshape(1, -1), thr, 64, True)
                    for block in x.split(N_CMP))[0, :-1]
        if not torch.equal(h, plain):
            raise AssertionError(f"2^30 {dtype} row: public call != plain version")
        label = f"2^30 {str(dtype).replace('torch.', '')} row"
        launches[label] = launched["one_input"]
        wide_dtype = torch.float32 if dtype == torch.bfloat16 else torch.int32
        thr_wide = thr.to(wide_dtype)
        x2d = x.reshape(1, -1)
        kernel_ms = event_ms(lambda: cuda_hist.one_input(x2d, thr, 64, True), reps=5)
        widened_ms = event_ms(lambda: cuda_hist.one_input(x2d.to(wide_dtype), thr_wide,
                                                          64, True), reps=5)
        bound_ms, _ = bound(x.numel() * x.element_size() + 8 * 65, 0)
        times[label] = (kernel_ms, widened_ms, bound_ms)
        print(f"# {label}, 64 bins, full: ONE_INPUT_LAUNCHES=1, {launch['layout']}, "
              f"K={launch['cells'][0]} L={launch['widest']}, read as {launch['load']}, "
              f"{extra} bytes allocated beside the data, == plain (16 blocks of 2^26); "
              f"kernel {kernel_ms:.4f} ms ({x.numel() * x.element_size() / kernel_ms / 1e6:.1f}"
              f" GB/s), widening copy then kernel {widened_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms [{card}]")
        del x, h, plain, x2d
        torch.cuda.empty_cache()
    del xr
    torch.cuda.empty_cache()
    return launches, times


NARROW_DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int16, torch.uint16,
                 torch.float16, torch.bfloat16)
N_NARROW_CMP = (64, 4096)  # kernel vs plain per narrow dtype and route


def narrow_data(dtype, shape, dev, seed):
    """(values of ``dtype`` on the card, edges): for the integers, uniform
    over the type with its extremes and both sides of every edge first
    (edges at fractions, at info.min and at info.max); for the floats,
    N(0, 1.5) with NaN and infinities first; for bool, 30% True."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, device=dev, generator=gen) < 0.3, np.array([0.0, 0.5, 1.0])
    if dtype.is_floating_point:
        x = (1.5 * torch.randn(shape, device=dev, generator=gen)).to(dtype)
        x.view(-1)[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
        return x, np.linspace(-4.0, 4.0, 41)
    info = torch.iinfo(dtype)
    edges = np.linspace(info.min - 0.5, info.max + 3.0, 41)
    edges[1], edges[-2] = info.min, info.max
    x = torch.randint(info.min, info.max + 1, shape, device=dev, generator=gen,
                      dtype=torch.int32)
    specials = np.concatenate([np.floor(edges), np.ceil(edges), np.floor(edges) - 1])
    specials = torch.from_numpy(specials.clip(info.min, info.max).astype(np.int32))
    x.view(-1)[:specials.numel()] = specials.to(dev)
    return x.to(dtype), edges


def kernel_holder(dev, max_abs_err):
    """(hold, held): ``hold(label, route, layouts, edges, w=None,
    finish=True)`` runs joint2, factored (``route`` "full", "per_row" or
    "packed") or direct on the card, checks that the launch read each input
    as its own dtype (``last_launch()["loads"]``) and that direct ran the
    row kernel, and holds the result bit for bit against the plain version
    on copies widened to float32 or int32 (float sums within two float32
    ulps), raising on a mismatch; ``held()`` is the count of cases held."""
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.core import _compare_dtype
    from xhistogram_torch.ops import cuda_hist

    def thr_of(edges, x):
        ce = compare_form(np.asarray(edges), _compare_dtype(x))
        if ce.n_hi_clip:
            raise ValueError("the kernels take thresholds with n_hi_clip == 0")
        return torch.from_numpy(ce.edges).to(dev)

    def wide(x):
        if x.dtype in (torch.float32, torch.float64, torch.int32, torch.int64):
            return x
        return x.to(torch.float32 if x.dtype.is_floating_point else torch.int32)

    def run(route, layouts, thr, nbins, w, plain=False, finish=True):
        if route == "joint2":
            fn = cuda_hist.joint2_reference if plain else cuda_hist.joint2
            return fn(*layouts, *thr, *nbins, weights=w)
        if route == "direct":
            fn = cuda_hist.direct_reference if plain else cuda_hist.direct
            return fn(layouts, thr, nbins, weights=w, finish=finish)
        fn = cuda_hist.factored_reference if plain else cuda_hist.factored
        return fn(layouts, thr, nbins, route == "full", weights=w)

    cases = [0]

    def hold(label, route, layouts, edges, w=None, finish=True):
        thr = [thr_of(e, x) for e, x in zip(edges, layouts)]
        nbins = [len(e) - 1 for e in edges]
        got = run(route, layouts, thr, nbins, w, finish=finish)
        torch.cuda.synchronize()
        rec = cuda_hist.last_launch()
        dtypes = tuple(x.dtype for x in layouts)
        if rec["loads"] != dtypes:
            raise AssertionError(f"{label}, {route}: read {rec['loads']}, not {dtypes}")
        if route == "direct" and rec["kernel"] != "direct_rows":
            raise AssertionError(f"{label}: direct ran {rec['kernel']}")
        widened = [wide(x) for x in layouts]
        want = run(route, widened, [t.to(x.dtype) for t, x in zip(thr, widened)], nbins, w,
                   plain=True, finish=finish)
        if w is None or not got.is_floating_point():
            err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
            ok = torch.equal(got, want)
        else:  # float64 adds in another order, rounded once
            diff = (got.double() - want.double()).abs()
            err = float(diff.max())
            ok = bool((diff <= 2.4e-7 * want.double().abs() + 1e-6).all())
        if w is None:
            key = {"joint2": "joint2", "direct": "direct"}.get(route, "factored")
            max_abs_err[key] = max(max_abs_err[key], err)
        if not ok:
            raise AssertionError(f"{label}, {route}: kernel != plain on a widened copy "
                                 f"(max abs err {err}; {rec})")
        cases[0] += 1

    return hold, lambda: cases[0]


def narrow_kernels(dev, max_abs_err, shape=N_NARROW_CMP):
    """joint2, factored (full, per row, packed) and direct on bool, int8,
    uint8, int16, uint16, float16 and bfloat16 data read in place: each
    launch's ``loads`` name the narrow dtype, and each result is bit-equal to
    the plain version on a widened copy (float sums within two float32
    ulps), for counts and float32, int32 and int64 weights; then narrow
    beside float32 and int32 data (the factored and direct routes' narrow
    and mixed entries, joint2's pair entries), views at odd offsets (joint2
    reads 4 elements a load where both inputs allow it) and the 8-bit table
    at every value of int8, uint8 and bool. Returns the cases held."""
    hold, held = kernel_holder(dev, max_abs_err)

    def weights_of(shape, dtype, seed):
        if dtype is None:
            return None
        g = torch.Generator(device=dev).manual_seed(seed)
        if dtype.is_floating_point:
            return torch.rand(shape, device=dev, generator=g).to(dtype)
        return torch.randint(-(2**30), 2**30, shape, device=dev, generator=g).to(dtype)

    routes = ("joint2", "full", "per_row", "packed", "direct")
    for dtype in NARROW_DTYPES:
        x, ex = narrow_data(dtype, shape, dev, seed=1)
        y, ey = narrow_data(dtype, shape, dev, seed=2)
        f = 1.5 * torch.randn(shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(3))
        i32 = (f * 1000).int()
        name = str(dtype).replace("torch.", "")
        for route in routes:
            # direct and packed: rows of 64 elements; per row: 4096
            lay = (lambda t: t.reshape(-1)) if route == "joint2" else \
                (lambda t: t.reshape(-1, 64)) if route in ("direct", "packed") else \
                (lambda t: t)
            for wdtype in (None, torch.float32, torch.int32, torch.int64):
                w = weights_of(tuple(lay(x).shape), wdtype, seed=4)
                hold(f"{name} pair, weights {wdtype}", route, [lay(x), lay(y)], [ex, ey], w)
            hold(f"{name} beside float32", route, [lay(x), lay(f)], [ex, np.linspace(-4, 4, 31)])
            hold(f"{name} beside int32", route, [lay(i32), lay(x)],
                 [np.linspace(-3000.5, 3000.5, 31), ex])
        # views at odd element offsets: joint2's grouped loads fall back
        xf, yf = x.reshape(-1), y.reshape(-1)
        for a, b in ((xf[1:], yf[1:]), (xf[4:], yf[1:-3]), (xf[2:-1], yf[2:-1])):
            hold(f"{name} pair at offsets", "joint2", [a, b], [ex, ey])
        hold(f"{name} strided view", "per_row", [x[:, 1:], y[:, :-1]], [ex, ey])
        hold(f"{name} strided rows", "direct", [x.t()[:255], y.t()[1:256]], [ex, ey])
        if dtype in (torch.int8, torch.uint8, torch.bool):
            # every value of the type, against edges between and on them
            if dtype == torch.bool:
                v = torch.tensor([False, True], device=dev).repeat(64 * 128)
                e = np.array([0.0, 0.5, 1.0])
            else:
                lo = -128 if dtype == torch.int8 else 0
                v = torch.arange(lo, lo + 256, device=dev).to(dtype).repeat(64)
                e = np.concatenate([[lo - 0.5], np.linspace(lo, lo + 255, 23)[1:-1] + 0.5,
                                    np.arange(lo + 2, lo + 256, 17), [lo + 255.0]])
                e = np.unique(e)
            w = v.flip(0)
            for route in routes:
                lay = (lambda t: t.reshape(-1)) if route == "joint2" else \
                    (lambda t: t.reshape(-1, 64))
                hold(f"{name} every value", route, [lay(v), lay(w)], [e, e])
        print(f"# narrow kernels == plain on a widened copy: {name} read in place "
              f"({shape}; joint2, factored full, per row, packed, direct; counts and "
              f"float32, int32, int64 weights; beside float32 and int32; odd offsets, "
              f"strided views{'; every value through the table' if dtype.itemsize == 1 else ''})")
    return held()


def narrow_bucket_sets(dev, max_abs_err):
    """joint2, factored (full, per row, packed) and direct on bfloat16 and
    int16 data read in place, held bit for bit against their plain
    versions on a widened copy on the adversarial threshold sets of the
    bucketed digitize (``ts_cases.BUCKET_EDGE_SETS``): bfloat16 data near
    every float set's float32 thresholds (and one bfloat16 step either
    side of each), int16 data near every set's thresholds scaled to the
    int16 range (the int32 sets as they are: thresholds past 2^24, which
    round in float32), each beside a partner of the same dtype. Returns the
    cases held."""
    from ts_cases import BUCKET_EDGE_SETS, bucket_case_values
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.ops import cuda_hist

    cases = 0
    rng = np.random.default_rng(10)
    for name, (edges, dtype) in BUCKET_EDGE_SETS.items():
        for nd in (torch.bfloat16, torch.int16):
            if nd == torch.bfloat16:
                if not np.issubdtype(dtype, np.floating):
                    continue
                e = edges
                thr = compare_form(e, np.float32).edges
                near = torch.from_numpy(bucket_case_values(thr, np.float32, 100_000,
                                                           seed=len(name)))
                tb = torch.from_numpy(thr).bfloat16().view(torch.int16)
                steps = torch.cat([tb - 1, tb + 1]).view(torch.bfloat16)
                x = torch.cat([near.bfloat16(), steps, torch.from_numpy(thr).bfloat16()])
                cmp_dtype = np.float32
            else:
                if np.issubdtype(dtype, np.floating):
                    finite = float(np.abs(edges[np.isfinite(edges)]).max())
                    e = np.asarray(edges, np.float64) * (30000.0 / finite)
                else:
                    e = np.asarray(edges, np.float64)
                thr = compare_form(e, np.int32).edges.astype(np.int64)
                near = np.concatenate([thr, thr - 1, thr + 1, [-32768, 32767, 0],
                                       rng.integers(-32768, 32768, 100_000)])
                x = torch.from_numpy(near.clip(-32768, 32767).astype(np.int16))
                cmp_dtype = np.int32
            x = x[: x.numel() // 64 * 64].to(dev)
            nb = len(e) - 1
            nba = int(np.clip(160_000 // nb, 8, 3000))
            if nd == torch.bfloat16:
                pe = np.linspace(-4, 4, nba + 1)
                partner = (2 * torch.randn(x.numel(), device=dev,
                                           generator=torch.Generator(device=dev).manual_seed(nba)
                                           )).bfloat16()
            else:
                pe = np.linspace(-3000.5, 3000.5, nba + 1)
                partner = torch.randint(-3500, 3500, (x.numel(),), device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(nba)
                                        ).to(torch.int16)
            all_edges = [e, pe]
            thr_t = [torch.from_numpy(compare_form(v, cmp_dtype).edges).to(dev)
                     for v in all_edges]
            nbins = [nb, nba]
            wide = torch.float32 if nd == torch.bfloat16 else torch.int32
            for route in ("joint2", "full", "per_row", "packed", "direct"):
                rows = {"joint2": 1, "full": 1, "per_row": 4, "packed": 16,
                        "direct": x.numel() // 64}[route]
                layouts = [v.reshape(rows, -1) for v in (x, partner)]
                wl = [v.to(wide) for v in layouts]
                wt = [t.to(wide) for t in thr_t]
                if route == "joint2":
                    got = cuda_hist.joint2(*layouts, *thr_t, *nbins)
                    want = cuda_hist.joint2_reference(*wl, *wt, *nbins)
                elif route == "direct":
                    got = cuda_hist.direct(layouts, thr_t, nbins)
                    want = cuda_hist.direct_reference(wl, wt, nbins)
                else:
                    got = cuda_hist.factored(layouts, thr_t, nbins, route == "full")
                    want = cuda_hist.factored_reference(wl, wt, nbins, route == "full")
                torch.cuda.synchronize()
                rec = cuda_hist.last_launch()
                if rec["loads"] != (nd, nd):
                    raise AssertionError(f"bucket set {name} as {nd}: {route} read "
                                         f"{rec['loads']}")
                key = {"joint2": "joint2", "direct": "direct"}.get(route, "factored")
                err = int((got - want).abs().max())
                max_abs_err[key] = max(max_abs_err[key], err)
                if not torch.equal(got, want):
                    raise AssertionError(f"bucket set {name} as {nd}: {route} != plain on a "
                                         f"widened copy (max abs err {err}; {rec})")
                cases += 1
        print(f"# bucket set {name} on bfloat16 and int16 data read in place: joint2, "
              "factored full, per row, packed, direct == plain on a widened copy")
    return cases


def public_paths(dev, card, reset_counts, counts_now, max_abs_err, tag):
    """(path, launches, records): ``path(label, args, bins, axis, key,
    kernel, today=None, weights=None, plain_blocks=1, numpy_check=None,
    others=(), reps=5)`` drives one cell through the public ``histogram``
    and records, under ``label``: its launch count (``key`` of
    ``counts_now()``, once and nothing else), that its kernel (``kernel``:
    "joint2", factored's "full" or "per_row", or "direct") read each input
    as its own dtype (and direct the row kernel), the peak memory the call allocated
    beside its inputs (less than one widened copy of the narrowest input at
    4 bytes an element, beside the output and the layout copies of data and
    weights that a kept middle axis or a broadcast weight takes), its result
    against the plain version on copies widened to float32 or int32 (in
    ``plain_blocks`` blocks of rows) and the public call against its
    kernel, ``numpy_check(h)``, and its kernel timed in turns (kernel,
    today, others, then back) with what earlier releases ran, beside its
    bound. ``today``: None for a copy of each narrow input widened to
    float32 or int32, a tuple of the dtypes to widen each input to, or the
    name of the one of ``others`` (name, fn of (layouts, thresholds)) that
    ran instead."""
    import xhistogram_torch
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.core import _compare_dtype
    from xhistogram_torch.ops import cuda_hist
    from xhistogram_torch.utils.axes import canonicalize_2d, normalize_axis

    def thr_of(edges, dtype):
        x = torch.empty(0, dtype=dtype)
        return torch.from_numpy(compare_form(np.asarray(edges), _compare_dtype(x)).edges
                                ).to(dev)

    def wide_dtype(dtype):
        if dtype.itemsize >= 4:
            return dtype
        return torch.float32 if dtype.is_floating_point else torch.int32

    def name_of(dtype):
        return str(dtype).replace("torch.", "")

    launches, records = {}, {}

    def call(kernel, ls, ts, nbins, w, plain=False):
        if kernel == "joint2":
            fn = cuda_hist.joint2_reference if plain else cuda_hist.joint2
            return fn(*ls, *ts, *nbins, weights=w)
        if kernel == "direct":
            fn = cuda_hist.direct_reference if plain else cuda_hist.direct
            return fn(ls, ts, nbins, weights=w)
        fn = cuda_hist.factored_reference if plain else cuda_hist.factored
        return fn(ls, ts, nbins, kernel == "full", weights=w)

    def path(label, args, bins, axis, key, kernel, today=None, weights=None,
             plain_blocks=1, numpy_check=None, others=(), reps=5):
        axis_t = normalize_axis(axis, args[0].ndim)
        shape = torch.broadcast_shapes(*(a.shape for a in args))
        # the kernel's operands, as the public call hands them on
        layouts = [canonicalize_2d(a.expand(shape), axis_t) for a in args]
        w2d = None if weights is None else canonicalize_2d(weights.expand(shape), axis_t)
        if axis is None:
            layouts = [v.reshape(1, -1) for v in layouts]
            w2d = None if w2d is None else w2d.reshape(1, -1)
        dtypes = tuple(a.dtype for a in args)
        thr = [thr_of(e, d) for e, d in zip(bins, dtypes)]
        nbins = [len(e) - 1 for e in bins]
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        h, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=weights)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base_mem
        launched = counts_now()
        if launched[key] != 1 or sum(launched.values()) != 1:
            raise AssertionError(f"{label}: launches {launched}")
        rec = cuda_hist.last_launch()
        if rec["loads"] != dtypes:
            raise AssertionError(f"{label}: the kernel read {rec['loads']}, not {dtypes}")
        if kernel == "direct" and rec["kernel"] != "direct_rows":
            raise AssertionError(f"{label}: direct ran {rec['kernel']}")
        # beside the output (the kernel's, trash slot included, and the
        # trimmed result, at most 8 bytes a slot each) and the layout copies
        # of data and weights
        n = math.prod(shape)
        copy_bytes = max(4, 2 * min(a.element_size() for a in args)) * n
        out_bytes = 2 * 8 * layouts[0].shape[0] * (math.prod(nbins) + 1)
        layout_bytes = sum(v.numel() * v.element_size() for v, a in
                           zip([*layouts, w2d], [*args, weights]) if v is not None and
                           v.untyped_storage().data_ptr() != a.untyped_storage().data_ptr())
        if extra - out_bytes - layout_bytes >= copy_bytes:
            raise AssertionError(f"{label}: {extra} bytes allocated ({layout_bytes} of them "
                                 f"layout copies, at most {out_bytes} the output); a "
                                 f"widened copy takes {copy_bytes}")
        wide = [v.to(wide_dtype(v.dtype)) for v in layouts]
        wthr = [t.to(v.dtype) for t, v in zip(thr, wide)]
        if plain_blocks > 1:
            plain = sum(call(kernel, [v.reshape(plain_blocks, -1)[k:k + 1] for v in wide],
                             wthr, nbins, None if w2d is None else
                             w2d.reshape(plain_blocks, -1)[k:k + 1], plain=True)
                        for k in range(plain_blocks))
        else:
            plain = call(kernel, wide, wthr, nbins, w2d, plain=True)
        del wide
        kernel_out = call(kernel, layouts, thr, nbins, w2d)
        family = key.split()[0]
        if w2d is None or not kernel_out.is_floating_point():
            ok = torch.equal(kernel_out, plain)
            err = int((kernel_out.long() - plain.long()).abs().max())
            max_abs_err[family] = max(max_abs_err[family], err)
        else:
            diff = (kernel_out.double() - plain.double()).abs()
            err = float(diff.max())
            ok = bool((diff <= 2.4e-7 * plain.double().abs() + 1e-6).all())
        if not ok:
            raise AssertionError(f"{label}: kernel != plain on widened copies (max abs "
                                 f"err {err})")
        if not torch.equal(h.reshape(kernel_out.shape[0], -1), kernel_out[:, :-1]):
            raise AssertionError(f"{label}: public call != its kernel")
        del plain, kernel_out
        if numpy_check is not None:
            numpy_check(h)
        if today is None:
            today = tuple(wide_dtype(d) for d in dtypes)
        fns = {"kernel": lambda: call(kernel, layouts, thr, nbins, w2d)}
        if not isinstance(today, str):
            today_thr = [thr_of(e, d) for e, d in zip(bins, today)]
            fns["today"] = lambda: call(kernel, [v.to(d) for v, d in zip(layouts, today)],
                                        today_thr, nbins, w2d)
        fns.update({name: (lambda f=f: f(layouts, thr)) for name, f in others})
        torch.cuda.empty_cache()
        for fn in fns.values():
            fn()
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            times[name].append(event_ms(fns[name], reps))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        n_bytes = sum(a.numel() * a.element_size() for a in args) + \
            (0 if weights is None else weights.numel() * weights.element_size()) + \
            h.numel() * h.element_size()
        bound_ms, bound_by = bound(n_bytes, 0)
        med, pub = measure(lambda: xhistogram_torch.histogram(*args, bins=bins, axis=axis,
                                                              weights=weights), reps=3)
        launches[label] = launched[key]
        records[label] = {
            "kernel": kernel, "loads": [name_of(d) for d in dtypes], "ms": ms.pop("kernel"),
            "today_ms": ms[today] if isinstance(today, str) else ms.pop("today"),
            "today": today if isinstance(today, str) else [name_of(d) for d in today],
            **{f"{name}_ms": t for name, t in ms.items()},
            "bound_ms": bound_ms, "bound_by": bound_by, "public_ms": med * 1e3,
            "peak_extra_bytes": int(extra), "layout_copy_bytes": int(layout_bytes),
            "widened_copy_bytes": int(copy_bytes),
            **{k: rec[k] for k in ("cluster", "warps_per_block", "blocks", "rows_per_warp")
               if k in rec}}
        r = records[label]
        print(f"# {tag} {label}: {key} launched once, read as {r['loads']}, {extra} bytes "
              f"allocated beside the inputs ({layout_bytes} layout copies, at most "
              f"{out_bytes} the output), == plain on widened copies; kernel {r['ms']:.4f} "
              f"ms, earlier releases ({r['today']}) {r['today_ms']:.4f} ms"
              + "".join(f", {name} {r[f'{name}_ms']:.4f} ms" for name, _ in others)
              + f", bound {bound_ms:.4f} ms; public call median {med * 1e3:.3f} ms of "
              f"{[round(x * 1e3, 3) for x in pub]} [{card}]")
        return h

    return path, launches, records


def narrow_paths(dev, card, reset_counts, counts_now, max_abs_err):
    """The narrow cells through the public ``histogram`` (``public_paths``:
    launches, loads, peak memory below a widened copy, the plain version on
    a widened copy, the kernel in turns with a widening copy and the kernel
    on it, beside its bound), each also against numpy: the T-S diagram over
    2^30 pairs stored as bfloat16 and as CF-packed int16 (T as round(100 T),
    S as round(1000 (S - 35)), edges in the same units), 2^30 int8 pairs (30
    N(0,1) rounded, 64x64 bins over the type), the README per-level call as
    packed int16 (unweighted, and weighted by a (50, 64800) float32 cell
    volume), and 40x40 direct at (64800, 64) with bfloat16 members (counts
    and int32 weights). Returns ({label: launches}, {label: record})."""
    from ts_cases import S_EDGES, T_EDGES, reference_numpy_joint, reference_numpy_ts
    import xhistogram_torch
    from xhistogram_torch.ops import cuda_hist

    path, launches, records = public_paths(dev, card, reset_counts, counts_now,
                                           max_abs_err, "narrow path")

    # --- the T-S diagram over 2^30 pairs as bfloat16 ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    T = (14.0 + 8.0 * torch.randn(N_MAIN, device=dev, generator=gen)).bfloat16()
    S = (35.0 + 1.5 * torch.randn(N_MAIN, device=dev, generator=gen)).bfloat16()

    def ts_numpy(h, te=T_EDGES, se=S_EDGES, tt=None, ss=None):
        tt = T if tt is None else tt
        ss = S if ss is None else ss
        t_np = tt[:, :SLICE_COLS].float().cpu().numpy()
        s_np = ss[:, :SLICE_COLS].float().cpu().numpy()
        got, _ = xhistogram_torch.histogram(tt[:, :SLICE_COLS], ss[:, :SLICE_COLS],
                                            bins=[te, se])
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      reference_numpy_ts(t_np, s_np, te, se))

    path("T-S 2^30 pairs bfloat16", [T, S], [T_EDGES, S_EDGES], None, "joint2", "joint2",
         plain_blocks=16, numpy_check=ts_numpy)
    if cuda_hist.last_launch()["cluster"] != 2:
        raise AssertionError("bfloat16 T-S: not in clusters of two")
    # --- the same diagram packed as int16, CF style ----------------------------
    T16 = (T.float() * 100).round().to(torch.int16)
    S16 = ((S.float() - 35.0) * 1000).round().to(torch.int16)
    del T, S
    te16 = T_EDGES.astype(np.float64) * 100
    se16 = (S_EDGES.astype(np.float64) - 35.0) * 1000
    path("T-S 2^30 pairs int16 packed", [T16, S16], [te16, se16], None, "joint2", "joint2",
         plain_blocks=16,
         numpy_check=lambda h: ts_numpy(h, te16, se16, T16, S16))
    del T16, S16
    torch.cuda.empty_cache()
    # --- 2^30 int8 pairs in 64x64 bins -----------------------------------------
    a8 = (30 * torch.randn(N_MAIN, device=dev, generator=gen)).round().clamp(-128, 127) \
        .to(torch.int8)
    b8 = (30 * torch.randn(N_MAIN, device=dev, generator=gen)).round().clamp(-128, 127) \
        .to(torch.int8)
    e8 = np.linspace(-128, 128, 65)
    path("int8 pairs 2^30, 64x64 bins", [a8, b8], [e8, e8], None, "joint2", "joint2",
         plain_blocks=16,
         numpy_check=lambda h: ts_numpy(h, e8, e8, a8, b8))
    del a8, b8
    torch.cuda.empty_cache()
    # --- the README per-level call as packed int16 -----------------------------
    gen = torch.Generator(device=dev).manual_seed(73)
    T16 = (100 * (14.0 + 8.0 * torch.randn(README_TS, device=dev, generator=gen))).round() \
        .to(torch.int16)
    S16 = (1000 * (1.5 * torch.randn(README_TS, device=dev, generator=gen))).round() \
        .to(torch.int16)
    vol = 1e9 * (0.5 + torch.rand(README_TS[1:], device=dev, generator=gen))

    def readme_numpy(h):
        for level in (0, README_TS[1] - 1):
            want = reference_numpy_joint([T16[:, level].cpu().numpy(),
                                          S16[:, level].cpu().numpy()], [te16, se16], None)
            np.testing.assert_array_equal(h[level].cpu().numpy(), want,
                                          err_msg=f"README int16, level {level}")

    path("README per-level T-S int16 packed", [T16, S16], [te16, se16], (0, 2),
         "factored per_row", "per_row", numpy_check=readme_numpy, reps=3)
    path("README per-level T-S int16 packed, float32 cell volume", [T16, S16],
         [te16, se16], (0, 2), "factored per_row", "per_row", weights=vol, reps=3)
    del T16, S16, vol
    torch.cuda.empty_cache()
    # --- 40x40 direct at (64800, 64) with bfloat16 members ----------------------
    gen = torch.Generator(device=dev).manual_seed(57)
    a = torch.randn(DIRECT[0], device=dev, generator=gen).bfloat16()
    b = torch.randn(DIRECT[0], device=dev, generator=gen).bfloat16()
    w = torch.randint(-(2**30), 2**30, DIRECT[0], device=dev, generator=gen,
                      dtype=torch.int32)
    e40 = linspace_edges(40)
    path("40x40 direct (64800, 64) bfloat16", [a, b], [e40, e40], (1,), "direct", "direct",
         numpy_check=lambda h: np.testing.assert_array_equal(
             h[:64].cpu().numpy(), reference_numpy_joint(
                 [a[:64].float().cpu().numpy(), b[:64].float().cpu().numpy()],
                 [e40, e40], (1,))))
    if cuda_hist.last_launch()["kernel"] != "direct_rows":
        raise AssertionError("bfloat16 direct: not the direct-row kernel")
    path("40x40 direct (64800, 64) bfloat16, int32 weights", [a, b], [e40, e40], (1,),
         "direct", "direct", weights=w)
    del a, b, w
    torch.cuda.empty_cache()
    return launches, records


def profiled_ms(fn, name, reps=20):
    """Mean device milliseconds of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn()``, from torch.profiler (the kernel alone, where
    CUDA events over back-to-back calls also see the host's launch work);
    None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [ev for ev in prof.key_averages() if name in ev.key]
    count = sum(ev.count for ev in hits)
    return sum(ev.self_device_time_total for ev in hits) / count / 1e3 if count else None


def direct_rows_phase(dev, card, reset_counts, counts_now, max_abs_err):
    """The direct-row kernel (csrc/direct.cuh): held against its plain version
    (``direct_reference``) at the shapes of the card-only tests, counts and
    integer sums bit for bit, float32 rows within two float32 ulps (float64
    rows within 1e-12), NaN and infinities in the same bins; its finished
    float32 rows bit-equal to its float64 rows rounded once, and every rerun
    bit-identical. Then, in turns with the flat-slot template's direct entry
    (template, row kernel, row kernel, template) below the wrappers, the four
    shapes of PERF.md §6, each beside its bound and with the kernels' device
    time from torch.profiler, and float-weighted 40x40 at 64,800 rows
    through the public API, which now launches the kernel. Returns the
    timings by shape."""
    from xhistogram_torch import bins as tbins
    import xhistogram_torch
    from xhistogram_torch.core import _compare_dtype
    from xhistogram_torch.ops import cuda_hist
    from xhistogram_torch.ops.bincount import finish_sums

    def operands(layouts, edges):
        thr = [torch.from_numpy(tbins.compare_form(np.asarray(e), _compare_dtype(x)).edges)
               .to(dev) for x, e in zip(layouts, edges)]
        return thr, [len(e) - 1 for e in edges]

    def same(label, got, want):
        """got against want: bit for bit for integers, else within two float32
        ulps (1e-12 for float64), with NaN and infinities in the same bins."""
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} against "
                                 f"{want.dtype} {tuple(want.shape)}")
        if not got.is_floating_point():
            a, b = (x.view(torch.int64) if x.dtype == torch.uint64 else x
                    for x in (got, want))
            err = float((a - b).abs().max()) if a.numel() else 0.0
            ok = torch.equal(a, b)
        else:
            for cls in (torch.isnan, torch.isposinf, torch.isneginf):
                if not torch.equal(cls(got), cls(want)):
                    raise AssertionError(f"{label}: NaN/inf bins differ from plain")
            fin = torch.isfinite(want)
            diff = (got.double() - want.double()).abs()[fin]
            err = float(diff.max()) if diff.numel() else 0.0
            rtol = 1e-12 if got.dtype == torch.float64 else 2.4e-7
            ok = bool((diff <= rtol * want.double().abs()[fin]).all())
        max_abs_err["direct"] = max(max_abs_err["direct"], err)
        if not ok:
            raise AssertionError(f"{label}: direct-row kernel != plain (max abs err {err})")

    checked = [0]

    def check(label, layouts, edges, weights=None, finish=True, rows=True):
        thr, nb = operands(layouts, edges)
        got = cuda_hist.direct(layouts, thr, nb, weights=weights, finish=finish)
        torch.cuda.synchronize()
        if layouts[0].numel():
            ran = cuda_hist.last_launch()["kernel"]
            if (ran == "direct_rows") != rows:
                raise AssertionError(f"{label}: ran {ran}")
        same(label, got, cuda_hist.direct_reference(layouts, thr, nb, weights=weights,
                                                    finish=finish))
        again = cuda_hist.direct(layouts, thr, nb, weights=weights, finish=finish)
        if not torch.equal(got.view(torch.uint8), again.view(torch.uint8)):
            raise AssertionError(f"{label}: a rerun gave other bits")
        checked[0] += 1
        return got

    def data(dtype, shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        if dtype == torch.bool:
            return torch.rand(shape, device=dev, generator=g) < 0.3, np.array([0, 0.5, 1])
        if dtype.is_floating_point:
            x = (1.5 * torch.randn(shape, device=dev, generator=g)).to(dtype)
            x.view(-1)[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
            return x, np.linspace(-3.0, 3.0, 41)
        if dtype in (torch.int32, torch.int64):
            scale = 2.0**40 if dtype == torch.int64 else 1000.0
            x = (1.5 * scale * torch.randn(shape, device=dev, generator=g)).to(dtype)
            return x, np.linspace(-3 * scale - 0.5, 3 * scale + 0.5, 41)
        info = torch.iinfo(dtype)
        x = torch.randint(info.min, info.max + 1, shape, device=dev, generator=g,
                          dtype=torch.int32).to(dtype)
        return x, np.linspace(info.min - 0.5, info.max + 0.5, 41)

    def weights(dtype, shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        if dtype.is_floating_point:
            return (torch.rand(shape, device=dev, generator=g) * 4 - 1).to(dtype)
        if dtype == torch.bool:
            return torch.rand(shape, device=dev, generator=g) < 0.5
        if dtype in (torch.int64, torch.uint64):
            return torch.randint(-(2**62), 2**62, shape, device=dev,
                                 generator=g).view(dtype)
        lo, hi = {torch.int32: (-(2**30), 2**30), torch.uint32: (0, 2**32),
                  torch.int16: (-(2**15), 2**15), torch.uint16: (0, 2**16),
                  torch.int8: (-128, 128), torch.uint8: (0, 256)}[dtype]
        return torch.randint(lo, hi, shape, device=dev, generator=g).to(dtype)

    def pair(m, c, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [1.5 * torch.randn(m, c, device=dev, generator=g) for _ in range(2)]

    e40 = [np.linspace(-3.0, 3.0, 41)] * 2
    # === the row kernel against its plain version ===============================
    for dtype in (torch.float32, torch.float64, torch.int32, torch.int64, torch.bool,
                  torch.int8, torch.uint8, torch.int16, torch.uint16, torch.float16,
                  torch.bfloat16):
        (x, e), (y, f) = data(dtype, (300, 64), 1), data(dtype, (300, 64), 2)
        check(f"{dtype} data", [x, y], [e, f])
        check(f"{dtype} data, one input", [x], [e])
    layouts = pair(500, 64, 3)
    layouts[0][::5, ::7] = float("nan")
    for dtype in (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int32,
                  torch.uint32, torch.int16, torch.uint16, torch.int8, torch.uint8,
                  torch.bool, torch.int64, torch.uint64):
        w = weights(dtype, (500, 64), 4)
        got = check(f"{dtype} weights", layouts, e40, w)
        raw = check(f"{dtype} weights, raw", layouts, e40, w, finish=False)
        if not torch.equal(got, finish_sums(raw, dtype)):
            raise AssertionError(f"{dtype} weights: finished rows != raw rows rounded")
    for c in (1, 2, 31, 32, 33, 63, 64, 65, 96, 127, 128, 200, 255):
        layouts = pair(257, c, c)
        check(f"rows of {c}", layouts, e40)
        for dtype in (torch.float32, torch.int32, torch.int64):
            check(f"rows of {c}, {dtype} weights", layouts, e40, weights(dtype, (257, c), c))
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn(300, 200, device=dev, generator=g)
    row = torch.randn(1, 100, device=dev, generator=g).expand(300, 100)
    col = torch.randn(300, 1, device=dev, generator=g).double().expand(300, 100)
    w = weights(torch.float32, (300, 100), 6)
    w_row = weights(torch.int32, (1, 100), 7).expand(300, 100)
    e_views = [np.linspace(-3.0, 3.0, nb + 1) for nb in (20, 30, 10)]
    for label, views in (("every other column, stride-0 row", [a[:, ::2], row]),
                         ("column-major, stride-0 column", [a[:, :100].t().contiguous().t(),
                                                            col]),
                         ("three views", [row, col, a[:, 100:]]),
                         ("every third row", [a[::3, 1::2][:, :100], row[:100]])):
        m = min(x.shape[0] for x in views)
        views = [x[:m] for x in views]
        check(label, views, e_views[: len(views)])
        for wv in (w[:m], w[:m].t().contiguous().t(), w_row[:m], w[:m, :1].expand(m, 100)):
            check(f"{label}, weights strides {wv.stride()}", views, e_views[: len(views)], wv)
    layouts = pair(700, 64, 8)
    warps = {}
    for nbins in ((1,), (40, 40), (75, 80), (80, 80), (64, 64), (90, 91), (128, 64),
                  (4, 8, 16, 16), (129, 64)):
        views = [layouts[0].roll(i, 1) for i in range(len(nbins))]
        edges = [np.linspace(-3.0, 3.0, nb + 1) for nb in nbins]
        rows = int(np.prod(nbins)) <= 8192
        check(f"{nbins} bins", views, edges, rows=rows)
        if rows:
            warps[nbins] = cuda_hist.last_launch()["warps_per_block"]
        for dtype in (torch.float32, torch.float64, torch.int32, torch.uint64):
            for finish in (True, False):
                check(f"{nbins} bins, {dtype} weights", views, edges,
                      weights(dtype, (700, 64), 9), finish=finish, rows=rows)
    layouts = pair(64, 64, 13)
    layouts[0][:, ::11] = float("nan")
    w = weights(torch.float32, (64, 64), 14)
    w[:, ::11] = float("nan")
    layouts[0][0, 1:6] = torch.tensor([-2.625, -1.875, -1.125, -0.375, -0.375])
    layouts[1][0, 1:6] = 0.25
    w[0, 1:6] = torch.tensor([float("nan"), float("inf"), -float("inf"), float("inf"),
                              -float("inf")])
    e86 = [np.linspace(-3.0, 3.0, 9), np.linspace(-3.0, 3.0, 7)]
    for wv in (w, w.double()):
        for finish in (True, False):
            got = check("NaN, +inf, -inf weights", layouts, e86, wv, finish=finish)
            if not (got.isnan().any() and got.isposinf().any() and got.isneginf().any()):
                raise AssertionError("NaN, +inf, -inf weights: no such bins")
    for m, c in ((0, 64), (64, 0)):
        got = check(f"empty ({m}, {c})", pair(m, c, 15), e40, weights(torch.float32, (m, c), 16))
        if got.any():
            raise AssertionError("empty rows: nonzero sums")
    layouts = pair(40, 64, 17)
    layouts[0][::2] = float("nan")
    layouts[1][1::2] = 100.0
    for wv in (None, weights(torch.float32, (40, 64), 18)):
        if check("rows with nothing in range", layouts, e40, wv).any():
            raise AssertionError("rows with nothing in range: nonzero sums")
    x = pair(333, 100, 19)[0]
    for nbins in ((2000,), (10, 12, 8), (2,) * 12):
        views = [x.roll(i, 1) for i in range(len(nbins))]
        edges = [np.linspace(-3.0, 3.0, nb + 1) for nb in nbins]
        for wv in (None, weights(torch.float32, (333, 100), 20)):
            check(f"{len(nbins)} inputs", views, edges, wv)
    big = pair(50, 256, 21)
    check("rows of 256: the template", big, e40, rows=False)
    check("rows of 256, float32 weights: the template", big, e40,
          weights(torch.float32, (50, 256), 22), rows=False)
    check("int64 beside float32: the row kernel's mixed entry",
          [(big[0][:, :64] * 2.0**40).long(), big[1][:, :64]],
          [np.linspace(-(2.0**42), 2.0**42, 41), e40[1]])
    print(f"# direct-row kernel == plain: {checked[0]} cases, each run twice bit-identical "
          f"(11 data dtypes; 13 weight dtypes, finished and raw, finished == raw rounded; "
          f"rows of 1 to 255; strided and stride-0 inputs and weights; {len(warps)} slot "
          f"counts, warps a block {sorted(set(warps.values()))}, 8256 slots on the "
          f"template; NaN/inf weights; empty rows; 1, 3 and 12 inputs)")

    # === in turns with the template, at PERF.md §6's four shapes ================
    def row_kernel(layouts, thr, nb, w, rounds):
        return cuda_hist._direct_rows_cuda(layouts, thr, nb, w, rounds)[0]

    def template(layouts, thr, nb, w, rounds):
        out, _ = cuda_hist._slot_hist_cuda("direct", layouts, thr, nb, False, w)
        return out.to(torch.float32) if rounds else out

    timings = {}
    for label, shape, wdtype in (("(64800, 64) counts", DIRECT[0], None),
                                 ("(64800, 64) int32 weights", DIRECT[0], torch.int32),
                                 ("(64800, 64) float32 weights", DIRECT[0], torch.float32),
                                 ("(1000, 64) counts", DIRECT[1], None)):
        layouts = pair(*shape, seed=shape[0] + 7)
        if wdtype == torch.int32:
            w = torch.randint(-(2**30), 2**30, shape, device=dev, dtype=torch.int32)
        else:
            w = None if wdtype is None else torch.rand(shape, device=dev)
        thr, nb = operands(layouts, e40)
        rounds = wdtype == torch.float32
        args = (layouts, thr, nb, w, rounds)
        got = row_kernel(*args)
        launch = cuda_hist.last_launch()
        same(f"timed {label}", got, cuda_hist.direct_reference(layouts, thr, nb, weights=w))
        template(*args), row_kernel(*args)
        t_a, r_a, r_b, t_b = (event_ms(lambda f=f: f(*args), 20)
                              for f in (template, row_kernel, row_kernel, template))
        rows_dev = profiled_ms(lambda: row_kernel(*args), "direct_rows_kernel")
        tmpl_dev = profiled_ms(lambda: template(*args), "slot_hist_kernel")
        n = shape[0] * shape[1]
        in_bytes = 8 * n + (4 * n if w is not None else 0)
        out_bytes = got.element_size() * got.numel()
        bound_ms, bound_by = bound(in_bytes + out_bytes, 2 * n * search_steps(40))
        timings[label] = {
            "ms": (r_a + r_b) / 2, "template_ms": (t_a + t_b) / 2, "device_ms": rows_dev,
            "template_device_ms": tmpl_dev, "bound_ms": bound_ms, "bound_by": bound_by,
            "warps_per_row": launch["warps_per_row"],
            "warps_per_block": launch["warps_per_block"], "blocks": launch["blocks"],
            "rows_per_warp": launch["rows_per_warp"]}
        print(f"# direct {label}, 40x40 bins: row kernel {(r_a + r_b) / 2:.4f} ms (device "
              f"{rows_dev}), template {(t_a + t_b) / 2:.4f} ms (device {tmpl_dev}"
              f"{', its float64 rows and their rounding pass' if rounds else ''}), bound "
              f"{bound_ms:.4f} ms by {bound_by} ({in_bytes / 1e6:.1f} MB read, "
              f"{out_bytes / 1e6:.1f} MB written); warps a row "
              f"{launch['warps_per_row']}, {launch['warps_per_block']} warps a block, "
              f"{launch['blocks']} blocks, {launch['rows_per_warp']} rows a warp [{card}]")
        del layouts, w, got
        torch.cuda.empty_cache()

    # === float-weighted 40x40 at 64,800 rows: the public call's auto route =======
    a, b = pair(*DIRECT[0], seed=64801)
    w = torch.rand(DIRECT[0], device=dev)
    if cuda_hist.plan(2, (40, 40), DIRECT[0][0], DIRECT[0][1]) != "direct":
        raise AssertionError("float-weighted 40x40 at 64,800 rows: plan() is not direct")
    reset_counts()
    h, _ = xhistogram_torch.histogram(a, b, bins=e40, axis=1, weights=w)
    torch.cuda.synchronize()
    launched = counts_now()
    launch = cuda_hist.last_launch()
    if launched["direct"] != 1 or sum(launched.values()) != 1 or \
            launch["kernel"] != "direct_rows":
        raise AssertionError(f"float-weighted 40x40 at 64,800 rows: launches {launched}, "
                             f"{launch['kernel']}")
    thr, nb = operands([a, b], e40)
    same("float-weighted 40x40 public", h.reshape(DIRECT[0][0], -1),
         cuda_hist.direct_reference([a, b], thr, nb, weights=w)[:, :-1])
    public = measure(lambda: xhistogram_torch.histogram(a, b, bins=e40, axis=1, weights=w),
                     reps=5)[0]
    scatter = measure(lambda: xhistogram_torch.histogram(a, b, bins=e40, axis=1, weights=w,
                                                         method="scatter"), reps=5)[0]
    timings["public float-weighted 40x40 (64800, 64)"] = {
        "direct_launches": launched["direct"], "public_ms": public * 1e3,
        "scatter_public_ms": scatter * 1e3}
    print(f"# float-weighted 40x40 at (64800, 64) through the public API: DIRECT_LAUNCHES "
          f"{launched['direct']} (scatter before, as in the JAX package), float32 == plain, "
          f"public call median {public * 1e3:.3f} ms, the scatter strategy "
          f"{scatter * 1e3:.3f} ms [{card}]")
    return timings, checked[0]


def mixed_and_uint64_phase(dev, card, reset_counts, counts_now, max_abs_err):
    """int64 data beside float data, compared each in its own type (joint2's
    mixed pairs, the template's mixed entries), and uint64 data flipped onto
    int64: each kernel held bit for bit against its plain version in both
    input orders, unweighted and with float32 and int32 weights, then the
    paths through the public API with the launch counts read
    (``histogram(x.long(), x)`` over ``linspace(0, 2, 1000)``, a T–S diagram
    with T in int64 millidegrees at 2^26 pairs, 5e7 pairs in 1000x1000 bins, the
    README's per-level layout cut to 8 times, 40x40 direct at (64800, 64), and
    10^8 uint64 values in 50 bins). Returns each kernel family's launches."""
    from ts_cases import S_EDGES, T_EDGES
    import xhistogram_torch
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.core import _compare_dtype
    from xhistogram_torch.ops import cuda_hist

    def thr_of(edges, x):
        return torch.from_numpy(compare_form(np.asarray(edges),
                                             _compare_dtype(x)).edges).to(dev)

    gen = torch.Generator(device=dev).manual_seed(64)
    big = torch.randint(-(2**45), 2**45, (64, 1 << 16), device=dev, generator=gen)
    big[0, :3] = torch.tensor([2**45 - 1, -(2**45), 0])
    e_int = np.linspace(-(2.0**45), 2.0**45, 91) + 0.5
    for float_dtype in (torch.float32, torch.float64, torch.float16):
        f = (1.5 * torch.randn(big.shape, device=dev, generator=gen)).to(float_dtype)
        f[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
        for layouts, edges in (([big, f], [e_int, linspace_edges(40)]),
                               ([f, big], [linspace_edges(40), e_int])):
            thr = [thr_of(e, x) for e, x in zip(edges, layouts)]
            nbins = [len(e) - 1 for e in edges]
            for wdtype in (None, torch.float32, torch.int32):
                w = None if wdtype is None else (
                    torch.rand(big.shape, device=dev, generator=gen) if wdtype.is_floating_point
                    else torch.randint(-(2**30), 2**30, big.shape, device=dev,
                                       generator=gen, dtype=torch.int32))
                for route in ("joint2", "full", "per_row", "packed", "direct"):
                    if route == "joint2":
                        got = cuda_hist.joint2(*layouts, *thr, *nbins, weights=w)
                        want = cuda_hist.joint2_reference(*layouts, *thr, *nbins, weights=w)
                        key = "joint2"
                    elif route == "direct":
                        got = cuda_hist.direct(layouts, thr, nbins, weights=w)
                        want = cuda_hist.direct_reference(layouts, thr, nbins, weights=w)
                        key = "direct"
                    else:
                        full = route == "full"
                        got = cuda_hist.factored(layouts, thr, nbins, full, weights=w)
                        want = cuda_hist.factored_reference(layouts, thr, nbins, full,
                                                            weights=w)
                        key = "factored"
                    torch.cuda.synchronize()
                    if w is None or not got.is_floating_point():
                        err = int((got - want).abs().max())
                        ok = torch.equal(got, want)
                    else:
                        diff = (got.double() - want.double()).abs()
                        err = float(diff.max())
                        ok = bool((diff <= 2.4e-7 * want.double().abs() + 1e-6).all())
                    if w is None:
                        max_abs_err[key] = max(max_abs_err[key], err)
                    if not ok:
                        raise AssertionError(
                            f"int64 beside {float_dtype}: {route} != plain "
                            f"(max abs err {err}, weights {wdtype})")
        print(f"# int64 beside {float_dtype} (both orders; counts, float32 and int32 "
              "weights): joint2, factored full, per row, packed and direct == plain")
    del big, f, layouts, w, got, want

    launches = {"joint2": 0, "factored": 0, "direct": 0, "one_input": 0}

    def path(label, args, bins, axis, key, expected=None):
        reset_counts()
        h, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis)
        torch.cuda.synchronize()
        launched = counts_now()
        if launched[key] != 1 or sum(launched.values()) != 1:
            raise AssertionError(f"{label}: launches {launched}")
        h_plain, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis,
                                                method="scatter")
        if not torch.equal(h, h_plain):
            raise AssertionError(f"{label}: kernel path != scatter path")
        if expected is not None and h.cpu().tolist() != expected:
            raise AssertionError(f"{label}: {h.cpu().tolist()} != {expected}")
        launches[key.split()[0]] += 1
        print(f"# mixed path {label}: {key} launched once, int64 {tuple(h.shape)} == the "
              f"scatter path{'' if expected is None else f' == {expected}'}")

    x = torch.linspace(0, 2, 1000, device=dev)
    e = np.array([0.0, 1.0, 2.0])
    path("histogram(x.long(), x), x = linspace(0, 2, 1000) float32, edges [0, 1, 2]",
         [x.long(), x], [e, e], None, "joint2", [[500, 0], [0, 500]])
    gen = torch.Generator(device=dev).manual_seed(26)
    T = (1000 * (14.0 + 8.0 * torch.randn(N_CMP, device=dev, generator=gen))).long()
    S = 35.0 + 1.5 * torch.randn(N_CMP, device=dev, generator=gen)
    path("T-S 2^26 pairs, T int64 millidegrees, S float32, 280x340 bins", [T, S],
         [T_EDGES.astype(np.float64) * 1000, S_EDGES], None, "joint2")
    ta, tb = thr_of(T_EDGES.astype(np.float64) * 1000, T), thr_of(S_EDGES, S)
    mixed_ms = event_ms(lambda: cuda_hist.joint2(T, S, ta, tb, 280, 340))
    del T, S
    a = torch.randint(-(2**40), 2**40, (N_FULL,), device=dev, generator=gen)
    b = torch.randn(N_FULL, device=dev, generator=gen)
    path("5e7 pairs, int64 beside float32, 1000x1000 bins, full", [a, b],
         [np.linspace(-(2.0**40), 2.0**40, 1001), linspace_edges(1000)], None,
         "factored full")
    del a, b
    T = (1000 * (14.0 + 8.0 * torch.randn((8,) + README_TS[1:], device=dev,
                                          generator=gen))).long()
    S = 35.0 + 1.5 * torch.randn(T.shape, device=dev, generator=gen)
    path("README per-level layout (8, 50, 64800), T int64 millidegrees, 280x340 bins, "
         "axis=(0, 2)", [T, S], [T_EDGES.astype(np.float64) * 1000, S_EDGES], (0, 2),
         "factored per_row")
    del T, S
    a = torch.randint(-(2**40), 2**40, DIRECT[0], device=dev, generator=gen)
    b = torch.randn(DIRECT[0], device=dev, generator=gen)
    path("40x40 direct, (64800, 64) int64 beside float32, axis=1", [a, b],
         [np.linspace(-(2.0**40), 2.0**40, 41), linspace_edges(40)], (1,), "direct")
    del a, b
    u = torch.randint(-(2**63), 2**63 - 1, CONFIG1, device=dev, generator=gen)
    u = u.view(torch.uint64)
    u_edges = np.linspace(0.0, 2.0**64 - 4096, 51)
    path("10^8 uint64 values (1000, 100000), 50 bins on [0, 2^64 - 4096], full",
         [u], [u_edges], None, "one_input")
    got, _ = xhistogram_torch.histogram(u[:2, :1000], bins=[u_edges])
    want, _ = np.histogram(u[:2, :1000].cpu().numpy().astype(np.float64).ravel(),
                           bins=u_edges)
    if got.cpu().tolist() != want.tolist():
        raise AssertionError("uint64: 2000 values != numpy")
    print("# uint64 path: == numpy on the first 2000 values; the call "
          "[0, 1, 2^63, 2^64 - 1] in [0, 2^63, 2^64] (an edge past the top value: "
          "scatter, as in the JAX package) == [2, 2]")
    u4 = torch.tensor([0, 1, 2**63, 2**64 - 1], dtype=torch.uint64, device=dev)
    h, _ = xhistogram_torch.histogram(u4, bins=[np.array([0.0, 2.0**63, 2.0**64])])
    if h.cpu().tolist() != [2, 2]:
        raise AssertionError(f"uint64 [0, 1, 2^63, 2^64 - 1] gave {h.cpu().tolist()}")
    print(f"# joint2 with T int64 beside S float32 at 2^26 pairs: kernel {mixed_ms:.4f} "
          f"ms [{card}]")
    del u
    torch.cuda.empty_cache()
    return launches


DATA_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64, *NARROW_DTYPES)
N_PAIR_CMP = (16, 4096)  # kernel vs plain per ordered pair of dtypes and route


def pair_data(dtype, shape, dev, seed):
    """(values of ``dtype`` on the card, edges): ``narrow_data`` for the
    narrow types and float32 and float64 (N(0, 1.5) with NaN and
    infinities); int32 as 1000 N(0, 1.5) and int64 as 2^40 N(0, 1.5), with
    edges over +-3 of those units."""
    if dtype.is_floating_point or dtype in NARROW_DTYPES:
        return narrow_data(dtype, shape, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = 2.0**40 if dtype == torch.int64 else 1000.0
    x = (1.5 * scale * torch.randn(shape, device=dev, generator=gen)).to(dtype)
    return x, np.linspace(-3 * scale - 0.5, 3 * scale + 0.5, 41)


def mixed_pair_kernels(dev, max_abs_err, shape=N_PAIR_CMP):
    """joint2, factored (full, per row, packed) and direct on every ordered
    pair of two of the eleven data dtypes, each input read in place (the
    launch's ``loads`` are the pair): joint2's pair entries and its mixed
    entry, the template's narrow and mixed entries and the row kernel's
    narrow and mixed ones, each bit-equal to the plain version on copies
    widened to float32 or int32 (float sums within two float32 ulps), for
    counts and float32, int32 and int64 weights, and the rounded float32
    rows of the row kernel; then joint2 at odd offsets and ragged sizes (its
    grouped loads where an input is narrow) and the 8-bit tables at every
    value beside the wide types. Returns the cases held."""
    hold, held = kernel_holder(dev, max_abs_err)
    gen = torch.Generator(device=dev).manual_seed(5)
    weights = {wd: (torch.rand(shape, device=dev, generator=gen) if wd == torch.float32
                    else torch.randint(-(2**30), 2**30, shape, device=dev, generator=gen,
                                       dtype=torch.int64).to(wd))
               for wd in (torch.float32, torch.int32, torch.int64)}
    routes = ("joint2", "full", "per_row", "packed", "direct")
    data = {d: pair_data(d, shape, dev, seed=11 + k) for k, d in enumerate(DATA_DTYPES)}
    for da in DATA_DTYPES:
        for db in DATA_DTYPES:
            if da == db:
                continue
            (x, ex), (y, ey) = data[da], data[db]
            label = f"{da} beside {db}".replace("torch.", "")
            for route in routes:
                lay = (lambda t: t.reshape(-1)) if route == "joint2" else \
                    (lambda t: t.reshape(-1, 64)) if route in ("direct", "packed") else \
                    (lambda t: t)
                for wd in (None, torch.float32, torch.int32, torch.int64):
                    w = None if wd is None else lay(weights[wd])
                    hold(f"{label}, weights {wd}", route, [lay(x), lay(y)], [ex, ey], w)
            # the row kernel's float64 sums, stored unrounded
            hold(f"{label}, float64 rows", "direct", [x.reshape(-1, 64), y.reshape(-1, 64)],
                 [ex, ey], weights[torch.float32].reshape(-1, 64), finish=False)
            xf, yf = x.reshape(-1), y.reshape(-1)
            for a, b in ((xf[1:], yf[1:]), (xf[4:], yf[1:-3]), (xf[3:4100], yf[3:4100]),
                         (xf[:7], yf[:7])):
                hold(f"{label} at offsets", "joint2", [a, b], [ex, ey])
    for dtype in (torch.int8, torch.uint8, torch.bool):
        if dtype == torch.bool:
            v = torch.tensor([False, True], device=dev).repeat(64 * 128)
            e = np.array([0.0, 0.5, 1.0])
        else:
            lo = -128 if dtype == torch.int8 else 0
            v = torch.arange(lo, lo + 256, device=dev).to(dtype).repeat(64)
            e = np.unique(np.concatenate([[lo - 0.5], np.arange(lo + 2, lo + 256, 17),
                                          np.linspace(lo, lo + 255, 23)[1:-1] + 0.5,
                                          [lo + 255.0]]))
        for other in (torch.float32, torch.float64, torch.int32, torch.int64):
            f, ef = pair_data(other, (v.numel(),), dev, seed=7)
            for route in routes:
                lay = (lambda t: t.reshape(-1)) if route == "joint2" else \
                    (lambda t: t.reshape(-1, 64))
                hold(f"{dtype} every value beside {other}", route, [lay(v), lay(f)], [e, ef])
                hold(f"{other} beside {dtype} every value", route, [lay(f), lay(v)], [ef, e])
    print(f"# mixed pairs == plain on widened copies: every ordered pair of two of "
          f"{len(DATA_DTYPES)} dtypes read in place ({shape}; joint2, factored full, per "
          f"row, packed, direct; counts and float32, int32, int64 weights; the row "
          f"kernel's float64 rows; odd offsets and ragged sizes; the 8-bit tables at "
          f"every value beside each wide type): {held()} cases")
    return held()


def mixed_pair_paths(dev, card, reset_counts, counts_now, max_abs_err):
    """Inputs of two dtypes at the paths' sizes through the public
    ``histogram`` (``public_paths``: launches, loads, peak memory, the plain
    version on widened copies, in blocks of rows at 2^30 pairs), each kernel
    timed in turns with what earlier releases ran: a copy of each input
    widened to their common compare type and the kernel on it, or the
    template's mixed entry. The T-S diagram over 2^30 pairs with T packed as
    int16 (round(100 T)), stored as bfloat16 or held as int32 millidegrees
    beside float32 S; bfloat16 T beside float16 S at 2^30 pairs, also on
    factored full (the choice of joint2's mixed entry); float32 T beside
    float64 S at 2^26 pairs; the README per-level call with float32 T beside
    float64 S; 5e7 pairs in 1000x1000 bins, int32 beside float32; and 40x40
    direct at (64800, 64) with int16 members beside int64 ones (which the
    earlier releases ran on the template's mixed entry) and int32 beside
    float32, each also against the template's mixed entry. Returns ({label:
    launches}, {label: record})."""
    from ts_cases import S_EDGES, T_EDGES
    from xhistogram_torch.ops import cuda_hist

    path, launches, records = public_paths(dev, card, reset_counts, counts_now,
                                           max_abs_err, "mixed pair path")

    f32, f64, i32, i64 = torch.float32, torch.float64, torch.int32, torch.int64
    gen = torch.Generator(device=dev).manual_seed(0)
    T = 14.0 + 8.0 * torch.randn(N_MAIN, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(N_MAIN, device=dev, generator=gen)
    Ti = torch.round(100 * T).to(torch.int16)
    path("T-S 2^30 pairs, T int16 round(100 T) beside S float32, 280x340 bins", [Ti, S],
         [T_EDGES.astype(np.float64) * 100, S_EDGES], None, "joint2", "joint2",
         (f64, f64), plain_blocks=16)
    del Ti
    Tb = T.to(torch.bfloat16)
    path("T-S 2^30 pairs, T bfloat16 beside S float32, 280x340 bins", [Tb, S],
         [T_EDGES, S_EDGES], None, "joint2", "joint2", (f32, f32), plain_blocks=16)
    Ti = torch.round(1000 * T).to(i32)
    path("T-S 2^30 pairs, T int32 millidegrees beside S float32, 280x340 bins", [Ti, S],
         [T_EDGES.astype(np.float64) * 1000, S_EDGES], None, "joint2", "joint2",
         (f64, f64), plain_blocks=16)
    del Ti, T
    Sh = S.to(torch.float16)
    del S

    def factored_full(layouts, thr):
        return cuda_hist.factored(layouts, thr, [280, 340], True)
    path("T-S 2^30 pairs, T bfloat16 beside S float16, 280x340 bins", [Tb, Sh],
         [T_EDGES, S_EDGES], None, "joint2", "joint2", (f32, f32), plain_blocks=16,
         others=(("factored_full", factored_full),))
    del Tb, Sh
    torch.cuda.empty_cache()
    T = (14.0 + 8.0 * torch.randn(N_CMP, device=dev, generator=gen))
    S = (35.0 + 1.5 * torch.randn(N_CMP, device=dev, generator=gen)).double()
    path("T-S 2^26 pairs, T float32 beside S float64, 280x340 bins", [T, S],
         [T_EDGES, S_EDGES], None, "joint2", "joint2", (f64, f64))
    del T, S
    T = 14.0 + 8.0 * torch.randn(README_TS, device=dev, generator=gen)
    S = (35.0 + 1.5 * torch.randn(README_TS, device=dev, generator=gen)).double()
    path("README per-level (73, 50, 64800), T float32 beside S float64, axis=(0, 2)",
         [T, S], [T_EDGES, S_EDGES], (0, 2), "factored per_row", "per_row", (f64, f64))
    del T, S
    torch.cuda.empty_cache()
    a = torch.round(1000 * torch.randn(N_FULL, device=dev, generator=gen)).to(i32)
    b = torch.randn(N_FULL, device=dev, generator=gen)
    path("5e7 pairs, int32 (1000 N(0,1)) beside float32, 1000x1000 bins, full", [a, b],
         [np.linspace(-4000.0, 4000.0, 1001), linspace_edges(1000)], None,
         "factored full", "full", (f64, f64))
    del a, b

    def template(layouts, thr):
        out, _ = cuda_hist._slot_hist_cuda("direct", layouts, thr, [40, 40], False, None)
        return out
    a = torch.round(1000 * torch.randn(DIRECT[0], device=dev, generator=gen)).to(torch.int16)
    b = torch.round(2.0**40 * torch.randn(DIRECT[0], device=dev, generator=gen)).to(i64)
    path("40x40 direct (64800, 64), int16 members beside int64, axis=1", [a, b],
         [np.linspace(-4000.0, 4000.0, 41), np.linspace(-(2.0**42), 2.0**42, 41)], (1,),
         "direct", "direct", "template_mixed", others=(("template_mixed", template),))
    a = torch.round(1000 * torch.randn(DIRECT[0], device=dev, generator=gen)).to(i32)
    b = torch.randn(DIRECT[0], device=dev, generator=gen)
    path("40x40 direct (64800, 64), int32 members beside float32, axis=1", [a, b],
         [np.linspace(-4000.0, 4000.0, 41), linspace_edges(40)], (1,), "direct", "direct",
         (f64, f64), others=(("template_mixed", template),))
    del a, b
    torch.cuda.empty_cache()
    return launches, records


# the views and unsigned data read in place
README_AXIS1_ONE = (4, 50, 64800)  # axis=1 on one_input: 259,200 kept rows, plan()'s cap
README_AXIS1_DIRECT = (2, 50, 64800)  # axis=1 on direct: 129,600 kept rows
N_HALO = (1024, (1 << 18) + 2)  # 2^28 T-S pairs once trimmed to [:, 1:-1]


def view_paths(dev, card, reset_counts, counts_now, max_abs_err):
    """Views and uint32/uint64 data read in place, through the public
    ``histogram``: the README call ((73, 50, 64800), ``axis=(0, 2)``) as
    float32 and as CF-packed int16, unweighted and by a (50, 64800) cell
    volume broadcast over time (factored per row); the same data with
    ``axis=1`` on one_input ((4, 50, 64800), 50 bins) and direct ((2, 50,
    64800), 40x40 bins); the T-S diagram over 2^28 pairs halo-trimmed
    ([:, 1:-1] of (1024, 2^18 + 2); joint2's runs); and config 1's (1000,
    100000) array as uint32 and as uint64 (one_input's own entries). Each
    call: its launch (once, and nothing else), the view it read
    (``last_launch()["view"] == "in place"``), the peak memory it allocated
    beside its inputs (the output and the trimmed result, and at most 1 MB
    more: no copy of the inputs or of the broadcast weights), its kernel on
    the views against the plain version on ``canonicalize_2d``'s copies, and
    its kernel timed in turns with what earlier releases ran (the copy, then
    the kernel on it: ``canonicalize_2d``, ``.contiguous()``, uint32
    widened to int64, uint64 flipped onto int64) and the kernel alone on
    those copies, beside its bound. Returns ({family: launches}, {label:
    record})."""
    from ts_cases import S_EDGES, T_EDGES
    import xhistogram_torch
    from xhistogram_torch.bins import compare_form, flip_uint64
    from xhistogram_torch.core import _compare_dtype
    from xhistogram_torch.ops import cuda_hist
    from xhistogram_torch.utils.axes import canonicalize_2d, normalize_axis, strided_layout

    def thr_of(edges, x):
        t = compare_form(np.asarray(edges), _compare_dtype(x)).edges
        return torch.from_numpy(flip_uint64(t) if t.dtype == np.uint64 else t).to(dev)

    def call(kernel, layouts, thr, nbins, w, plain=False):
        if kernel == "joint2":
            fn = cuda_hist.joint2_reference if plain else cuda_hist.joint2
            return fn(*layouts, *thr, *nbins, weights=w)
        if kernel in ("one_input", "one_input_full"):
            fn = cuda_hist.one_input_reference if plain else cuda_hist.one_input
            return fn(layouts[0], thr[0], nbins[0], kernel == "one_input_full", weights=w)
        if kernel == "direct":
            fn = cuda_hist.direct_reference if plain else cuda_hist.direct
            return fn(layouts, thr, nbins, weights=w)
        fn = cuda_hist.factored_reference if plain else cuda_hist.factored
        return fn(layouts, thr, nbins, kernel == "full", weights=w)

    launches = {"joint2": 0, "one_input": 0, "factored": 0, "direct": 0}
    records = {}

    def path(label, args, bins, axis, key, kernel, weights=None, earlier=None):
        shape = torch.broadcast_shapes(*(a.shape for a in args))
        axis_t = normalize_axis(axis, len(shape))
        operands = [a.expand(shape) for a in args]
        if weights is not None:
            operands.append(weights.expand(shape))
        layout = strided_layout(operands, axis_t)  # what the public call hands on
        if layout.copied:
            raise AssertionError(f"{label}: the layout copies")
        views = layout.views[:len(args)]
        w_view = layout.views[-1] if weights is not None else None
        thr = [thr_of(e, a) for e, a in zip(bins, args)]
        nbins = [len(e) - 1 for e in bins]
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        h, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=weights)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base_mem
        launched = counts_now()
        if launched[key] != 1 or sum(launched.values()) != 1:
            raise AssertionError(f"{label}: launches {launched}")
        rec = cuda_hist.last_launch()
        if rec["view"] != "in place" or rec["loads"] != tuple(a.dtype for a in args):
            raise AssertionError(f"{label}: the kernel read {rec['loads']}, "
                                 f"{rec['view']}")
        # the kernel's output, the sums finished and the trimmed result
        out_bytes = 3 * 8 * (h.numel() + h.numel() // math.prod(nbins) + 1)
        if extra > out_bytes + (1 << 20):
            raise AssertionError(f"{label}: {extra} bytes allocated beside the inputs, "
                                 f"more than the output's {out_bytes} and 1 MB")
        # earlier releases: canonicalize_2d's copies (and uint32 widened,
        # uint64 flipped), then the kernel
        if earlier is None:
            def earlier(ls):
                return [canonicalize_2d(v, axis_t) for v in ls]
        copies = earlier(operands)  # each searched against the same thresholds
        w_copy = copies[-1] if weights is not None else None
        copies = copies[:len(args)]
        got = call(kernel, views, thr, nbins, w_view)
        want = call(kernel, copies, thr, nbins, w_copy, plain=True)
        family = key.split()[0]
        if w_view is None or not got.is_floating_point():
            ok = torch.equal(got, want)
            err = int((got.long() - want.long()).abs().max())
            max_abs_err[family] = max(max_abs_err[family], err)
        else:
            diff = (got.double() - want.double()).abs()
            err = float(diff.max())
            ok = bool((diff <= 2.4e-7 * want.double().abs() + 1e-6).all())
        if not ok:
            raise AssertionError(f"{label}: kernel on the views != plain on copies "
                                 f"(max abs err {err})")
        if not torch.equal(h.reshape(got.shape[0], -1), got[:, :-1]):
            raise AssertionError(f"{label}: public call != its kernel")
        del got, want
        def copy_and_kernel():
            c = earlier(operands)
            return call(kernel, c[:len(args)], thr, nbins, c[-1] if weights is not None
                        else None)
        fns = {
            "kernel": lambda: call(kernel, views, thr, nbins, w_view),
            "earlier": copy_and_kernel,
            "kernel_on_copies": lambda: call(kernel, copies, thr, nbins, w_copy),
        }
        for fn in fns.values():
            fn()
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            times[name].append(event_ms(fns[name], 5))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        n_bytes = sum(a.numel() * a.element_size() for a in args) + \
            (0 if weights is None else weights.numel() * weights.element_size()) + \
            8 * h.numel()
        bound_ms, bound_by = bound(n_bytes, 0)
        med, pub = measure(lambda: xhistogram_torch.histogram(*args, bins=bins, axis=axis,
                                                              weights=weights), reps=3)
        launches[family] += 1
        records[label] = {
            "kernel": kernel, "loads": [str(a.dtype).replace("torch.", "") for a in args],
            "view": [list(v.shape) + list(v.stride()) for v in layout.views],
            "ms": ms["kernel"], "copy_and_kernel_ms": ms["earlier"],
            "kernel_on_copies_ms": ms["kernel_on_copies"], "bound_ms": bound_ms,
            "bound_by": bound_by, "public_ms": med * 1e3, "peak_extra_bytes": int(extra),
            "copy_bytes": int(sum(c.numel() * c.element_size() for c in earlier(operands))),
        }
        r = records[label]
        print(f"# view path {label}: {key} launched once on the view "
              f"{tuple(layout.shape)} (strides {[v.stride() for v in layout.views]}), "
              f"read as {r['loads']}, {extra} bytes allocated beside the inputs (the "
              f"output {out_bytes}; earlier releases' copies {r['copy_bytes']}), == plain "
              f"on the copies; kernel {r['ms']:.4f} ms, copy and kernel (earlier "
              f"releases) {r['copy_and_kernel_ms']:.4f} ms, kernel on the copies "
              f"{r['kernel_on_copies_ms']:.4f} ms, bound {bound_ms:.4f} ms; public call "
              f"median {med * 1e3:.3f} ms of {[round(x * 1e3, 3) for x in pub]} [{card}]")
        del copies, w_copy
        torch.cuda.empty_cache()
        return h

    gen = torch.Generator(device=dev).manual_seed(12)
    T = 14.0 + 8.0 * torch.randn(README_TS, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(README_TS, device=dev, generator=gen)
    volume = 1e9 * (0.5 + torch.rand(README_TS[1:], device=dev, generator=gen))
    path("README (73, 50, 64800) float32, axis=(0, 2)", [T, S], [T_EDGES, S_EDGES],
         (0, 2), "factored per_row", "per_row")
    path("README (73, 50, 64800) float32, axis=(0, 2), by a (50, 64800) volume",
         [T, S], [T_EDGES, S_EDGES], (0, 2), "factored per_row", "per_row",
         weights=volume)
    Ti, Si = (torch.round(100 * T).to(torch.int16),
              torch.round(1000 * (S - 35)).to(torch.int16))
    ie = [np.round(100 * T_EDGES.astype(np.float64)),
          np.round(1000 * (S_EDGES.astype(np.float64) - 35))]
    path("README (73, 50, 64800) packed int16, axis=(0, 2)", [Ti, Si], ie, (0, 2),
         "factored per_row", "per_row")
    path("README (73, 50, 64800) packed int16, axis=(0, 2), by a (50, 64800) volume",
         [Ti, Si], ie, (0, 2), "factored per_row", "per_row", weights=volume)
    del Ti, Si, volume
    n1 = README_AXIS1_ONE[0]
    path(f"README layout ({n1}, 50, 64800) T, axis=1, 50 bins", [T[:n1]],
         [linspace_edges(50) * 8 + 14], (1,), "one_input", "one_input")
    n2 = README_AXIS1_DIRECT[0]
    path(f"README layout ({n2}, 50, 64800) T-S, axis=1, 40x40 bins", [T[:n2], S[:n2]],
         [np.linspace(-10, 38, 41), np.linspace(31, 39, 41)], (1,), "direct", "direct")
    del T, S
    torch.cuda.empty_cache()
    T = 14.0 + 8.0 * torch.randn(N_HALO, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(N_HALO, device=dev, generator=gen)

    def contiguous(ls):
        return [v.contiguous() for v in ls]
    path("T-S 2^28 pairs halo-trimmed ([:, 1:-1] of (1024, 2^18 + 2)), 280x340 bins",
         [T[:, 1:-1], S[:, 1:-1]], [T_EDGES, S_EDGES], None, "joint2", "joint2",
         earlier=contiguous)
    del T, S
    torch.cuda.empty_cache()
    x = torch.randn(CONFIG1, device=dev, generator=gen)
    u32 = (2.0**31 + 2.0**28 * x).round().to(torch.int64).to(torch.uint32)
    path("config 1 (1000, 100000) uint32, 50 bins over 2^31 +- 2^30, full", [u32],
         [np.linspace(2.0**31 - 2.0**30, 2.0**31 + 2.0**30, 51)], None, "one_input",
         "one_input_full", earlier=lambda ls: [v.reshape(1, -1).to(torch.int64)
                                                for v in ls])
    del u32
    u64 = ((x.double() * 2.0**61).round().to(torch.int64) ^ -(1 << 63)).view(torch.uint64)
    path("config 1 (1000, 100000) uint64, 50 bins over 2^63 +- 2^62, full", [u64],
         [np.linspace(2.0**63 - 2.0**62, 2.0**63 + 2.0**62, 51)], None, "one_input",
         "one_input_full", earlier=lambda ls: [flip_uint64(v.reshape(1, -1)) for v in ls])
    del u64, x
    torch.cuda.empty_cache()
    return launches, records


def weighted_turns(plain, weighted, unweighted, reps=10):
    """(weighted kernel ms, plain ms, unweighted kernel ms), timed plain,
    weighted, unweighted, unweighted, weighted, plain after a warm-up of
    each."""
    weighted(), unweighted(), plain()
    t = [event_ms(f, reps) for f in (plain, weighted, unweighted, unweighted,
                                     weighted, plain)]
    return (t[1] + t[4]) / 2, (t[0] + t[5]) / 2, (t[2] + t[3]) / 2


def weighted_phase(dev, card, thresholds, reset_counts, counts_now):
    """The weighted forms of the four kernels (csrc/weights.cuh): each held
    against its plain version on the card, integer sums and sums of
    integer-valued floats bit for bit, float sums within two float32 ulps
    (float32 results; rtol 1e-10 for float64 ones, whose float64 adds run
    in another order) with NaN and infinities in the same bins, and float
    sums against a float64 numpy oracle and math.fsum within the JAX
    package's 'highest' bound (rtol 3e-7, atol 1e-6). Then the weighted
    paths through the public API, each with the launch counts set to 0
    just before it and read just after. Returns each kernel's weighted
    entries of the ``kernels`` line."""
    import math

    from ts_cases import S_EDGES, T_EDGES, reference_numpy_weighted
    import xhistogram_torch
    from xhistogram_torch.ops import cuda_hist
    from xhistogram_torch.ops.bincount import weighted_dtype
    from xhistogram_torch.utils.axes import canonicalize_2d, normalize_axis

    family = {"joint2": "joint2", "one_input_full": "one_input",
              "one_input_rows": "one_input", "full": "factored",
              "per_row": "factored", "packed": "factored", "direct": "direct"}
    errs = dict.fromkeys(("joint2", "one_input", "factored", "direct"), 0.0)
    launches = dict.fromkeys(errs, 0)

    def operands(layouts, edges):
        np_dtypes = [torch.empty(0, dtype=x.dtype).numpy().dtype for x in layouts]
        return ([thresholds(e, d) for e, d in zip(edges, np_dtypes)],
                [len(e) - 1 for e in edges])

    def run(kernel, layouts, edges, weights, plain=False, ops=None):
        thr, nbins = ops or operands(layouts, edges)
        if kernel == "joint2":
            fn = cuda_hist.joint2_reference if plain else cuda_hist.joint2
            return fn(*layouts, *thr, *nbins, weights=weights)
        if kernel.startswith("one_input"):
            fn = cuda_hist.one_input_reference if plain else cuda_hist.one_input
            return fn(layouts[0], thr[0], nbins[0], kernel == "one_input_full",
                      weights=weights)
        if kernel == "direct":
            fn = cuda_hist.direct_reference if plain else cuda_hist.direct
            return fn(layouts, thr, nbins, weights=weights)
        fn = cuda_hist.factored_reference if plain else cuda_hist.factored
        return fn(layouts, thr, nbins, kernel == "full", weights=weights)

    def check(label, kernel, got, want, exact=False, rtol=None, atol=0.0):
        """got against want: bit for bit when ``exact`` or integer, else
        within rtol (two float32 ulps, or 1e-10 for float64) and atol, with
        NaN, +inf and -inf in the same bins."""
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{label}: {kernel} gave {got.dtype} {tuple(got.shape)}, "
                                 f"want {want.dtype} {tuple(want.shape)}")
        if got.dtype == torch.uint64:
            got, want = got.view(torch.int64), want.view(torch.int64)
        if not got.is_floating_point():
            err = float((got - want).abs().max()) if got.numel() else 0.0
            ok = torch.equal(got, want)
        else:
            for cls in (torch.isnan, torch.isposinf, torch.isneginf):
                if not torch.equal(cls(got), cls(want)):
                    raise AssertionError(f"{label}: {kernel} NaN/inf bins differ from plain")
            fin = torch.isfinite(want)
            diff = (got.double() - want.double()).abs()[fin]
            err = float(diff.max()) if diff.numel() else 0.0
            if exact:
                ok = torch.equal(got[fin], want[fin])
            else:
                if rtol is None:
                    rtol = 1e-10 if got.dtype == torch.float64 else 2.4e-7
                ok = bool((diff <= rtol * want.double().abs()[fin] + atol).all())
        errs[family[kernel]] = max(errs[family[kernel]], err)
        if not ok:
            raise AssertionError(f"{label}: {kernel} != plain (max abs err {err})")

    # === kernel vs plain on the card ==========================================
    gen = torch.Generator(device=dev).manual_seed(21)
    x2 = torch.randn(2, 4096, 4096, device=dev, generator=gen)
    cases = {
        "joint2": ([14.0 + 8.0 * x2[0], 35.0 + 1.5 * x2[1]], [T_EDGES, S_EDGES]),
        "one_input_full": ([x2[0]], [EDGES1]),
        "one_input_rows": ([x2[0]], [EDGES1]),
        "full": ([x2[0], x2[1]], [linspace_edges(150), linspace_edges(90)]),
        "per_row": ([x2[0].reshape(256, -1), x2[1].reshape(256, -1)],
                    [linspace_edges(150), linspace_edges(90)]),
        "packed": ([x2[0].reshape(-1, 64)[:16384], x2[1].reshape(-1, 64)[:16384]],
                   [linspace_edges(120), linspace_edges(90)]),
        "direct": ([x2[0].reshape(-1, 64)[:16384], x2[1].reshape(-1, 64)[:16384]],
                   [linspace_edges(40)] * 2),
    }

    def weight_cases(shape):
        """(label, weights, bit-exact) of every weight kind at ``shape``."""
        g = torch.Generator(device=dev).manual_seed(shape[0])
        u = torch.rand(shape, device=dev, generator=g)
        nonfinite = u.clone()
        flat = nonfinite.view(-1)
        for value in (float("nan"), float("inf"), -float("inf")):
            flat[torch.randint(0, flat.numel(), (64,), device=dev, generator=g)] = value
        # +inf beside -inf in the bins of a run of elements: NaN there
        flat[:32:2], flat[1:32:2] = float("inf"), -float("inf")
        return [
            ("integer-valued float32", torch.randint(-100, 100, shape, device=dev,
                                                     generator=g).float(), True),
            ("U(0,1) float32", u, False),
            ("U(0,1) float64", torch.rand(shape, device=dev, generator=g,
                                          dtype=torch.float64), False),
            ("int32 in ±2^30 (wraps)", torch.randint(-(2**30), 2**30, shape, device=dev,
                                                    generator=g, dtype=torch.int32), True),
            ("int64 in ±2^40", torch.randint(-(2**40), 2**40, shape, device=dev,
                                             generator=g), True),
            ("NaN, +inf, -inf", nonfinite, False),
            ("broadcast row (stride 0)", u[:1].expand(shape), False),
            ("strided view", u.t().contiguous().t(), False),
        ]

    for kernel, (layouts, edges) in cases.items():
        for label, w, exact in weight_cases(tuple(layouts[0].shape)):
            got = run(kernel, layouts, edges, w)
            want = run(kernel, layouts, edges, w, plain=True)
            torch.cuda.synchronize()
            if got.dtype != weighted_dtype(w.dtype):
                raise AssertionError(f"{kernel}, {label}: gave {got.dtype}")
            check(label, kernel, got, want, exact)
        print(f"# weighted {kernel} == plain ({tuple(layouts[0].shape)} x {len(layouts)}, "
              f"{'x'.join(str(len(e) - 1) for e in edges)} bins): integer-valued "
              f"float32, U(0,1) float32 and float64, int32 wrapping, int64, NaN/+inf/"
              f"-inf, stride-0 and strided weights")

    # float sums against a float64 oracle (np.bincount) and math.fsum
    for kernel in ("joint2", "one_input_rows", "full", "direct"):
        layouts, edges = cases[kernel]
        sub = [x[:64].contiguous() if kernel != "direct" else x[:1024] for x in layouts]
        g = torch.Generator(device=dev).manual_seed(5)
        for w in (torch.rand(sub[0].shape, device=dev, generator=g),
                  torch.rand(sub[0].shape, device=dev, generator=g, dtype=torch.float64)):
            got = run(kernel, sub, edges, w)[..., :-1]
            axis = None if kernel in ("joint2", "full") else (1,)
            oracle = reference_numpy_weighted([x.cpu().numpy() for x in sub], edges,
                                              w.cpu().numpy(), axis)
            np.testing.assert_allclose(got.cpu().numpy().reshape(oracle.shape), oracle,
                                       rtol=3e-7 if w.dtype == torch.float32 else 1e-12,
                                       atol=1e-6, err_msg=f"{kernel} != float64 oracle")
    te, se = np.linspace(-2, 30, 9), np.linspace(30, 40, 10)
    t, s = cases["joint2"][0][0][:1].reshape(-1), cases["joint2"][0][1][:1].reshape(-1)
    w = torch.rand(t.shape, device=dev, generator=gen)
    got = run("joint2", [t, s], [te, se], w)[0, :-1].cpu().numpy()
    t_np, s_np = (x.cpu().numpy().astype(np.float64) for x in (t, s))
    it = np.searchsorted(te, t_np, side="right") - 1 - (t_np == te[-1])
    is_ = np.searchsorted(se, s_np, side="right") - 1 - (s_np == se[-1])
    keep = (it >= 0) & (it < 8) & (is_ >= 0) & (is_ < 9)
    slot, w_np = (it * 9 + is_)[keep], w.cpu().numpy().astype(np.float64)[keep]
    fsum = np.array([math.fsum(w_np[slot == k]) for k in range(72)], np.float32)
    np.testing.assert_allclose(got, fsum, rtol=1.2e-7, atol=0,
                               err_msg="joint2 != math.fsum, rounded to float32")
    print("# weighted float sums within rtol 3e-7 of a float64 numpy oracle (joint2, "
          "one_input, factored, direct; float32 and float64 weights), and joint2 within "
          "one float32 ulp of math.fsum (4096 pairs, 8x9 bins)")
    del x2, cases, layouts, sub
    torch.cuda.empty_cache()

    # === the weighted paths through the public API =============================
    def drive(label, args, bins, axis, weights, kernel, density=False):
        """One public call with fresh counts; checks plan() and that the
        kernel's counter, and only it, moved. Returns (h, layouts, w2d)."""
        axis_t = normalize_axis(axis, args[0].ndim)
        shape = torch.broadcast_shapes(*(a.shape for a in args), weights.shape)
        layouts = [canonicalize_2d(x.expand(shape), axis_t) for x in args]
        w2d = canonicalize_2d(weights.expand(shape), axis_t)
        m, c = layouts[0].shape
        nbins = tuple(len(e) - 1 for e in bins)
        planned = cuda_hist.plan(len(args), nbins, 1 if axis is None else m,
                                 None if axis is None else c)
        if planned != kernel:
            raise AssertionError(f"{label}: plan() names {planned}, not {kernel}")
        key = {"factored": "factored full", "factored_per_row": "factored per_row",
               "factored_packed": "factored packed"}.get(kernel, kernel)
        reset_counts()
        h, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=weights,
                                          density=density)
        torch.cuda.synchronize()
        launched = counts_now()
        if launched[key] < 1 or sum(launched.values()) != launched[key]:
            raise AssertionError(f"{label}: launches {launched}")
        launches[key.split()[0]] += launched[key]
        if kernel != "one_input":
            note = launch_note([t.cpu() for t in operands(layouts, bins)[0]])[1] + ", "
        else:
            rec = cuda_hist.last_launch()
            note = (f"{rec['layout']} ({rec['copies']} copies), K={rec['cells'][0]} "
                    f"L={rec['widest']}, ")
        print(f"# weighted path {label}: plan {kernel}, launches {launched[key]} ({key}), "
              f"{note}{h.dtype} {tuple(h.shape)}")
        return h, layouts, w2d

    out = {}

    # --- BASELINE config 2: weighted + density, kept rows ---------------------
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(CONFIG1, device=dev, generator=gen)
    w = torch.rand(CONFIG1, device=dev, generator=gen)
    d2, layouts, w2d = drive("BASELINE config 2, (1000, 100000) float32, U(0,1) float32 "
                             "weights, 50 bins, axis=1, density", [x], [EDGES1], (1,), w,
                             "one_input", density=True)
    h2, _ = xhistogram_torch.histogram(x, bins=[EDGES1], axis=1, weights=w)
    plain = run("one_input_rows", layouts, [EDGES1], w2d, plain=True)[:, :-1]
    check("config 2", "one_input_rows", h2, plain)
    x_np, w_np = x.cpu().numpy(), w.cpu().numpy()
    want = reference_numpy_weighted([x_np], [EDGES1], w_np, (1,))
    want = want / np.diff(EDGES1) / want.sum(axis=-1, keepdims=True)
    np.testing.assert_allclose(d2.cpu().numpy(), want, rtol=2e-4, atol=1e-9,
                               err_msg="config 2 density != numpy")
    print("# config 2 weighted: sums == plain (2 ulps), density within rtol 2e-4 of "
          "numpy (run_baselines.py:144)")
    ops = operands(layouts, [EDGES1])
    ms, plain_ms, unw_ms = weighted_turns(
        lambda: run("one_input_rows", layouts, [EDGES1], w2d, plain=True, ops=ops),
        lambda: run("one_input_rows", layouts, [EDGES1], w2d, ops=ops),
        lambda: run("one_input_rows", layouts, [EDGES1], None, ops=ops))
    bound_ms, _ = bound(8 * x.numel() + 4 * 1000 * 51, x.numel() * search_steps(50))
    med, times = measure(lambda: xhistogram_torch.histogram(
        x, bins=[EDGES1], axis=1, weights=w, density=True), reps=5)
    print(f"# one_input weighted at config 2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"unweighted kernel {unw_ms:.4f} ms, bound {bound_ms:.4f} ms (800 MB read); "
          f"public call with density median {med * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in times]} [{card}]")
    out["one_input"] = (ms, plain_ms, bound_ms, unw_ms)
    del x, w, layouts, w2d, plain, x_np, w_np, d2, h2
    torch.cuda.empty_cache()

    # --- the T-S diagram at 2^28 pairs: float32 weights, int1/int2/int4 ------
    gen = torch.Generator(device=dev).manual_seed(28)
    T = 14.0 + 8.0 * torch.randn(N_TS_W, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(N_TS_W, device=dev, generator=gen)
    ta, tb = thresholds(T_EDGES), thresholds(S_EDGES)
    kernel_ms = {"unweighted": event_ms(
        lambda: cuda_hist.joint2(T, S, ta, tb, 280, 340), reps=3)}
    for kind, spec in (("float32 U(0,1)", None), *INT_WEIGHT_SPANS.items()):
        if spec is None:
            w = torch.rand(N_TS_W, device=dev, generator=gen)
        else:
            w = torch.randint(spec[0], spec[1] + 1, N_TS_W, device=dev, generator=gen,
                              dtype=torch.int32)
        h, _, _ = drive(f"T-S 2^28 pairs, 280x340 bins, {kind} weights", [T, S],
                        [T_EDGES, S_EDGES], None, w, "joint2")
        # the plain version over blocks of 2^26 pairs, summed in float64 or
        # int64 and then given the sums' dtype
        acc = w.double() if w.is_floating_point() else w.long()
        plain = sum(cuda_hist.joint2_reference(t_, s_, ta, tb, 280, 340, weights=w_)
                    for t_, s_, w_ in zip(T.split(64), S.split(64), acc.split(64)))
        plain = plain[0, :-1].reshape(280, 340).to(h.dtype)
        check(f"T-S 2^28, {kind}", "joint2", h, plain)
        kernel_ms[kind] = event_ms(
            lambda: cuda_hist.joint2(T, S, ta, tb, 280, 340, weights=w), reps=3)
        med, times = measure(lambda: xhistogram_torch.histogram(
            T, S, bins=[T_EDGES, S_EDGES], weights=w), reps=3)
        print(f"# T-S 2^28 {kind}: == plain over 4 blocks of 2^26; kernel "
              f"{kernel_ms[kind]:.4f} ms, public call median {med * 1e3:.3f} ms of "
              f"{[round(t * 1e3, 3) for t in times]} [{card}]")
        del plain, acc, h
    print(f"# joint2 kernel at 2^28 pairs by weights: "
          f"{ {k: round(v, 4) for k, v in kernel_ms.items()} } ms [{card}]")
    t26, s26 = T[:64], S[:64]  # 2^26 pairs, the unweighted entry's size
    w26 = torch.rand(t26.shape, device=dev, generator=gen)
    ms, plain_ms, unw_ms = weighted_turns(
        lambda: cuda_hist.joint2_reference(t26, s26, ta, tb, 280, 340, weights=w26),
        lambda: cuda_hist.joint2(t26, s26, ta, tb, 280, 340, weights=w26),
        lambda: cuda_hist.joint2(t26, s26, ta, tb, 280, 340))
    bound_ms, _ = bound(12 * t26.numel() + 4 * 95201,
                        t26.numel() * (search_steps(280) + search_steps(340)))
    print(f"# joint2 weighted at 2^26 pairs, float32 weights: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, unweighted kernel {unw_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"[{card}]")
    # 8-byte accumulators: one pass in clusters of four against four chunk
    # passes of one block, in turns
    l26 = torch.randint(-(2**40), 2**40, t26.shape, device=dev, generator=gen)
    default = cuda_hist.MAX_CLUSTER_CTAS
    for kind, w_ in (("float32 [f64]", w26), ("int64 [u64]", l26)):
        times = {}
        notes = {}
        try:
            for most in (default, 1, 1, default):
                cuda_hist.MAX_CLUSTER_CTAS = most
                fn = lambda: cuda_hist.joint2(t26, s26, ta, tb, 280, 340, weights=w_)  # noqa: E731
                fn()
                torch.cuda.synchronize()
                _, notes[most] = launch_note([ta.cpu(), tb.cpu()])
                times.setdefault(most, []).append(event_ms(fn))
        finally:
            cuda_hist.MAX_CLUSTER_CTAS = default
        print(f"# joint2 at 2^26 pairs, {kind} weights: "
              + "; ".join(f"{notes[k]}: {sum(v) / len(v):.4f} ms" for k, v in times.items())
              + f" [{card}]")
    del l26
    out["joint2"] = (ms, plain_ms, bound_ms, unw_ms)
    del T, S, w, t26, s26, w26
    torch.cuda.empty_cache()

    # --- README per-level T-S, weighted by cell volume, broadcast over time ----
    gen = torch.Generator(device=dev).manual_seed(73)
    T = 14.0 + 8.0 * torch.randn(README_TS, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(README_TS, device=dev, generator=gen)
    vol = 1e9 * (0.5 + torch.rand(README_TS[1:], device=dev, generator=gen))
    h, layouts, w2d = drive("README per-level T-S, (73, 50, 64800) float32 x 2, "
                            "(50, 64800) cell-volume weights, axis=(0, 2)", [T, S],
                            [T_EDGES, S_EDGES], (0, 2), vol, "factored_per_row")
    edges = [T_EDGES, S_EDGES]
    plain = run("per_row", layouts, edges, w2d, plain=True)[:, :-1]
    check("README weighted", "per_row", h.reshape(50, -1), plain)
    for level in (0, README_TS[1] - 1):
        want = reference_numpy_weighted(
            [T[:, level].cpu().numpy(), S[:, level].cpu().numpy()], edges,
            vol[level].cpu().numpy(), None)
        np.testing.assert_allclose(h[level].cpu().numpy(), want, rtol=3e-7, atol=1e-6,
                                   err_msg=f"README weighted, level {level}")
    del plain
    ops = operands(layouts, edges)
    ms, plain_ms, unw_ms = weighted_turns(
        lambda: run("per_row", layouts, edges, w2d, plain=True, ops=ops),
        lambda: run("per_row", layouts, edges, w2d, ops=ops),
        lambda: run("per_row", layouts, edges, None, ops=ops), reps=3)
    n = layouts[0].numel()
    # the weights' own bytes: the (50, 64800) volume, not the copy of its
    # broadcast that canonicalize_2d makes
    bound_ms, _ = bound(8 * n + 4 * vol.numel() + 4 * 50 * 95201,
                        n * (search_steps(280) + search_steps(340)))
    med, times = measure(lambda: xhistogram_torch.histogram(
        T, S, bins=edges, axis=(0, 2), weights=vol), reps=3)
    print(f"# README weighted: == plain and numpy (levels 0, 49); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, unweighted kernel {unw_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms; public call median {med * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in times]} [{card}]")
    out["factored"] = (ms, plain_ms, bound_ms, unw_ms)
    del T, S, vol, h, layouts, w2d
    torch.cuda.empty_cache()

    # --- three inputs in 60x60x60 bins, full --------------------------------------
    gen = torch.Generator(device=dev).manual_seed(60)
    xs = [torch.randn(N_3IN, device=dev, generator=gen) for _ in range(3)]
    w = torch.rand(N_3IN, device=dev, generator=gen)
    e60 = [linspace_edges(60)] * 3
    h, layouts, w2d = drive("3 x 5e7 float32, 60x60x60 bins, U(0,1) float32 weights, "
                            "full", xs, e60, None, w, "factored")
    check("3 inputs", "full", h.reshape(1, -1),
          run("full", layouts, e60, w2d, plain=True)[:, :-1])
    n_np = 1 << 22
    got, _ = xhistogram_torch.histogram(*(x[:n_np] for x in xs), bins=e60,
                                        weights=w[:n_np])
    want = reference_numpy_weighted([x[:n_np].cpu().numpy() for x in xs], e60,
                                    w[:n_np].cpu().numpy())
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=3e-7, atol=1e-6,
                               err_msg="3 inputs, first 2^22 elements")
    ms3 = event_ms(lambda: run("full", layouts, e60, w2d), reps=5)
    print(f"# 3 inputs weighted: == plain, and numpy on the first 2^22; kernel "
          f"{ms3:.4f} ms (216,000 float64 slots in device memory) [{card}]")
    del xs, w, h, layouts, w2d, got
    torch.cuda.empty_cache()

    # --- 40x40 direct: float32 at m = 1000, int32 at m = 64800 -----------------
    for shape, dtype in ((DIRECT[1], torch.float32), (DIRECT[0], torch.int32)):
        gen = torch.Generator(device=dev).manual_seed(shape[0] + 1)
        a, b = (torch.randn(shape, device=dev, generator=gen) for _ in range(2))
        if dtype == torch.int32:
            w = torch.randint(-(2**30), 2**30, shape, device=dev, generator=gen,
                              dtype=torch.int32)
        else:
            w = torch.rand(shape, device=dev, generator=gen)
        e40 = [linspace_edges(40)] * 2
        h, layouts, w2d = drive(f"40x40 direct, {shape} float32 x 2, {dtype} weights, "
                                "axis=1", [a, b], e40, (1,), w, "direct")
        check(f"direct {shape}", "direct", h.reshape(shape[0], -1),
              run("direct", layouts, e40, w2d, plain=True)[:, :-1])
        exact = dtype == torch.int32
        for r in (0, 1, shape[0] - 1):
            want = reference_numpy_weighted([a[r].cpu().numpy(), b[r].cpu().numpy()], e40,
                                            w[r].cpu().numpy(), None, exact=exact)
            if exact:
                want = (want % 2**32).astype(np.int64)
                want = np.where(want >= 2**31, want - 2**32, want)
                np.testing.assert_array_equal(h[r].cpu().numpy(), want)
            else:
                np.testing.assert_allclose(h[r].cpu().numpy(), want, rtol=3e-7, atol=1e-6)
        if dtype == torch.int32:  # the entry's shape: the unweighted kernel's
            ops = operands(layouts, e40)
            ms, plain_ms, unw_ms = weighted_turns(
                lambda: run("direct", layouts, e40, w2d, plain=True, ops=ops),
                lambda: run("direct", layouts, e40, w2d, ops=ops),
                lambda: run("direct", layouts, e40, None, ops=ops))
            bound_ms, _ = bound(12 * a.numel() + 4 * shape[0] * 1601,
                                a.numel() * 2 * search_steps(40))
            print(f"# direct weighted at {shape}, int32 weights: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, unweighted kernel {unw_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms [{card}]")
            out["direct"] = (ms, plain_ms, bound_ms, unw_ms)
        del a, b, w, h, layouts, w2d
        torch.cuda.empty_cache()

    return {
        name: {"weighted_ms": ms, "weighted_plain_ms": plain_ms,
               "weighted_bound_ms": bound_ms, "unweighted_same_shape_ms": unw_ms,
               "weighted_launches": launches[name], "weighted_max_abs_err": errs[name]}
        for name, (ms, plain_ms, bound_ms, unw_ms) in out.items()
    }



def kernel_spans(core, name):
    """A context that wraps ``core.<name>`` (the kernel wrapper the public
    call reaches) with CUDA events; yields the list of (start, stop)."""
    import contextlib

    @contextlib.contextmanager
    def wrapped():
        launch = getattr(core, name)
        spans = []

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch(*args, **kwargs)
            stop.record()
            spans.append((start, stop))
            return out

        setattr(core, name, timed)
        try:
            yield spans
        finally:
            setattr(core, name, launch)

    return wrapped()


def api_phase(dev, card, reset_counts, counts_now):
    """The public API above core on the card, each path driven with the
    launch counts set to 0 just before it and read just after, and held
    against a plain version or an oracle: the exact float64 tier
    (``precision='f64'``: the T–S diagram at 2^26 pairs with float64 U(0,1)
    weights, bit-equal to its plain decomposition, bit-identical over two
    runs, <= 1 ulp of a per-slot math.fsum on the first 2^20 pairs; the
    README call weighted by a float64 cell volume; config 2 and 40x40 at
    (64800, 64) with float64 weights), StreamingHistogram (the main path's
    2^30 pairs from host memory in 16 chunks; config 4 in kept-offset tiles;
    the 'f64' cross-chunk case), the labeled README call and the public-call
    times at configs 1 and 4 with the threshold cache cold and warm, and
    compat.histogram2d against numpy. Returns (launches by kernel, the f64
    tier's numbers for the kernels line)."""
    import math

    from ts_cases import S_EDGES, T_EDGES, reference_numpy
    import xhistogram_torch
    from xhistogram_torch import compat, core
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.labeled import NamedArray
    from xhistogram_torch.labeled import histogram as labeled_histogram
    from xhistogram_torch.ops.digitize import digitize_edges, joint_bin_index

    launches = dict.fromkeys(("joint2", "one_input", "factored", "direct"), 0)
    ts_bins = [T_EDGES, S_EDGES]
    hist = xhistogram_torch.histogram

    def drive(label, fn, kernel):
        """fn() between a reset and a read of the launch counts; the
        kernel must have launched. Returns (fn's result, its launches)."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        now = counts_now()
        n = sum(v for k, v in now.items() if k.split()[0] == kernel)
        if n < 1:
            raise AssertionError(f"{label}: the {kernel} kernel did not launch: {now}")
        for k, v in now.items():
            launches[k.split()[0]] += v
        return out, n

    def bits_equal(label, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} against "
                                 f"{want.dtype} {tuple(want.shape)}")
        if not torch.equal(got, want):
            err = float((got.double() - want.double()).abs().max())
            raise AssertionError(f"{label}: not bit-equal (max abs err {err:.3g})")

    def ms_of(fn, reps=3):
        med, _ = measure(fn, reps=reps)
        return med * 1e3

    f64 = {}
    # === the exact float64 tier ===============================================
    gen = torch.Generator(device=dev).manual_seed(26)
    t = 14.0 + 8.0 * torch.randn(N_CMP, device=dev, generator=gen)
    s = 35.0 + 1.5 * torch.randn(N_CMP, device=dev, generator=gen)
    w = torch.rand(N_CMP, device=dev, generator=gen, dtype=torch.float64)

    def ts_call(**kw):
        return lambda: hist(t, s, bins=ts_bins, weights=w, **kw)[0]

    h1, passes = drive("f64 T-S 2^26", ts_call(precision="f64"), "joint2")
    h2 = ts_call(precision="f64")()
    plain = ts_call(precision="f64", method="scatter")()
    bits_equal("f64 T-S 2^26, two runs", h1, h2)
    bits_equal("f64 T-S 2^26 against its plain decomposition", h1, plain)
    # <= 1 ulp of a correctly rounded per-slot math.fsum on the first 2^20 pairs
    n_or = 1 << 20
    part = hist(t[:n_or], s[:n_or], bins=ts_bins, weights=w[:n_or],
                precision="f64")[0].reshape(-1).cpu().numpy()
    thr = [torch.from_numpy(compare_form(e, np.float32).edges) for e in ts_bins]
    idx = [digitize_edges(x[:n_or].cpu().reshape(1, -1), th) for x, th in zip((t, s), thr)]
    g, n_slots = joint_bin_index(idx, (280, 340))
    g = g.reshape(-1).numpy()
    order = np.argsort(g, kind="stable")
    ws = w[:n_or].cpu().numpy()[order]
    cuts = np.searchsorted(g[order], np.arange(n_slots))
    want = np.array([math.fsum(ws[cuts[i]:cuts[i + 1]]) for i in range(n_slots - 1)])
    ulps = np.where(part == want, 0.0, np.abs(part - want) / np.spacing(np.abs(want)))
    if ulps.max() > 1.0:
        raise AssertionError(f"f64 T-S 2^20: {ulps.max()} ulps from math.fsum")
    f64_ms = ms_of(ts_call(precision="f64"))
    highest_ms = ms_of(ts_call(precision="highest"))
    f64["T-S 2^26"] = {"passes": passes, "groups": passes // 2, "limbs": 2,
                       "ms": f64_ms, "highest_ms": highest_ms,
                       "fsum_max_ulps": float(ulps.max())}
    print(f"# f64 T-S 2^26 pairs, float64 U(0,1) weights: JOINT2_LAUNCHES={passes} "
          f"({passes // 2} groups x 2 limbs, int64 class), bit-identical over two runs "
          f"and bit-equal to the plain decomposition, first 2^20 pairs within "
          f"{ulps.max():.0f} ulp of math.fsum; public call {f64_ms:.3f} ms, 'highest' "
          f"(float64 atomics) {highest_ms:.3f} ms [{card}]")
    del t, s, w, h1, h2, plain
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(73)
    T = 14.0 + 8.0 * torch.randn(README_TS, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(README_TS, device=dev, generator=gen)
    vol = 1e9 * (0.5 + torch.rand(README_TS[1:], device=dev, generator=gen,
                                  dtype=torch.float64))

    def readme_call(**kw):
        return lambda: hist(T, S, bins=ts_bins, axis=(0, 2), weights=vol, **kw)[0]

    h, passes = drive("f64 README by cell volume", readme_call(precision="f64"),
                      "factored")
    plain = readme_call(precision="f64", method="scatter")()
    for level in (0, README_TS[1] - 1):
        bits_equal(f"f64 README level {level}", h[level], plain[level])
    bits_equal("f64 README, every level", h, plain)
    del plain
    ms = ms_of(readme_call(precision="f64"))
    f64["README by cell volume"] = {"passes": passes, "ms": ms}
    print(f"# f64 README per-level T-S by a float64 (50, 64800) cell volume: "
          f"FACTORED_LAUNCHES={passes} (per row, int64 class), levels 0 and 49 and "
          f"every other bit-equal to the plain decomposition; public call {ms:.3f} ms "
          f"[{card}]")
    labeled_T = NamedArray(T, ("time", "depth", "cell"), name="T",
                           coords={"depth": np.arange(README_TS[1]) * 100.0 + 50},
                           attrs={"units": "degC"})
    labeled_S = NamedArray(S, ("time", "depth", "cell"), name="S")
    del h
    torch.cuda.empty_cache()

    # === labeled: the README call as NamedArrays ================================
    out, n = drive("labeled README", lambda: labeled_histogram(
        labeled_T, labeled_S, bins=ts_bins, dim=("time", "cell")), "factored")
    want = hist(T, S, bins=ts_bins, axis=(0, 2))[0]
    if out.dims != ("depth", "T_bin", "S_bin") or out.name != "histogram_T_S":
        raise AssertionError(f"labeled README: dims {out.dims}, name {out.name}")
    bits_equal("labeled README against core.histogram", out.data, want)
    if out.coords["T_bin"].attrs != {"units": "degC"} or "depth" not in out.coords:
        raise AssertionError("labeled README: coordinates or attrs lost")
    def labeled_call():
        return labeled_histogram(labeled_T, labeled_S, bins=ts_bins, dim=("time", "cell"))

    def core_call():
        return hist(T, S, bins=ts_bins, axis=(0, 2))

    # in turns: labeled, core, core, labeled
    turns = [ms_of(f, reps=5) for f in (labeled_call, core_call, core_call, labeled_call)]
    labeled_ms, core_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"# labeled README call, dims (time, depth, cell), dim=(time, cell): "
          f"FACTORED_LAUNCHES={n}, dims {out.dims} == core.histogram bit for bit; "
          f"labeled {labeled_ms:.3f} ms, core {core_ms:.3f} ms a call [{card}]")
    del T, S, vol, out, want, labeled_T, labeled_S
    torch.cuda.empty_cache()

    # === f64 at config 2 and at 40x40 direct ===================================
    gen = torch.Generator(device=dev).manual_seed(2)
    x1 = torch.randn(CONFIG1, device=dev, generator=gen)
    w1 = torch.rand(CONFIG1, device=dev, generator=gen, dtype=torch.float64)
    h, passes = drive("f64 config 2", lambda: hist(x1, bins=[EDGES1], axis=1, weights=w1,
                                                  precision="f64")[0], "one_input")
    bits_equal("f64 config 2", h, hist(x1, bins=[EDGES1], axis=1, weights=w1,
                                       precision="f64", method="scatter")[0])
    ms = ms_of(lambda: hist(x1, bins=[EDGES1], axis=1, weights=w1, precision="f64"))
    f64["config 2"] = {"passes": passes, "ms": ms}
    print(f"# f64 config 2, float64 U(0,1) weights: ONE_INPUT_LAUNCHES={passes}, "
          f"bit-equal to the plain decomposition; public call {ms:.3f} ms [{card}]")
    del x1, w1, h
    a, b = (torch.randn(DIRECT[0], device=dev, generator=gen) for _ in range(2))
    wd = torch.rand(DIRECT[0], device=dev, generator=gen, dtype=torch.float64)
    e40 = [linspace_edges(40)] * 2
    h, passes = drive("f64 40x40 direct", lambda: hist(a, b, bins=e40, axis=1, weights=wd,
                                                      precision="f64")[0], "direct")
    bits_equal("f64 40x40 direct", h, hist(a, b, bins=e40, axis=1, weights=wd,
                                           precision="f64", method="scatter")[0])
    ms = ms_of(lambda: hist(a, b, bins=e40, axis=1, weights=wd, precision="f64"))
    f64["40x40 direct (64800, 64)"] = {"passes": passes, "ms": ms}
    print(f"# f64 40x40 at (64800, 64), float64 U(0,1) weights: DIRECT_LAUNCHES="
          f"{passes}, bit-equal to the plain decomposition; public call {ms:.3f} ms "
          f"[{card}]")
    del a, b, wd, h
    torch.cuda.empty_cache()

    # === streaming ==============================================================
    gen = torch.Generator(device=dev).manual_seed(0)
    T = 14.0 + 8.0 * torch.randn(N_MAIN, device=dev, generator=gen)  # the main path's
    S = 35.0 + 1.5 * torch.randn(N_MAIN, device=dev, generator=gen)
    one_shot = hist(T, S, bins=ts_bins)[0]
    T_host, S_host = T.cpu(), S.cpu()  # 8.59 GB in host memory, copied back once
    del T, S
    torch.cuda.empty_cache()
    rows = N_MAIN[0] // 16  # 16 chunks of 2^26 pairs

    def stream():
        acc = xhistogram_torch.StreamingHistogram(bins=ts_bins)
        for k in range(16):
            acc.update(T_host[k * rows:(k + 1) * rows], S_host[k * rows:(k + 1) * rows])
        return acc.result()[0]

    stream()  # a first stream allocates the pinned staging buffers, kept for reuse
    with kernel_spans(core, "joint2") as spans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (h, n) = drive("streamed T-S 2^30", stream, "joint2")
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = sum(a.elapsed_time(b) for a, b in spans)
    bits_equal("streamed T-S 2^30 against the one-shot device call", h, one_shot)
    pinned = [torch.empty((rows,) + N_MAIN[1:], pin_memory=True) for _ in range(2)]
    on_card = torch.empty((rows,) + N_MAIN[1:], device=dev)

    def copies():
        for _ in range(16):
            for buf in pinned:
                on_card.copy_(buf, non_blocking=True)

    copy_ms = event_ms(copies, reps=1)
    copy_ms = event_ms(copies, reps=2)
    n_bytes = 8 * T_host.numel()
    stream_report = {"wall_ms": wall_ms, "gb_s": n_bytes / wall_ms / 1e6,
                     "pinned_copy_ms": copy_ms, "kernel_ms": kernel_ms,
                     "idle_share": 1 - kernel_ms / wall_ms}
    print(f"# streamed T-S, the main path's 2^30 pairs from host memory in 16 chunks of "
          f"2^26: JOINT2_LAUNCHES={n}, counts bit-equal to the one-shot device call; "
          f"wall {wall_ms:.1f} ms ({stream_report['gb_s']:.2f} GB/s), the pinned "
          f"host-to-device copy of the same {n_bytes / 1e9:.2f} GB alone {copy_ms:.1f} ms "
          f"({n_bytes / copy_ms / 1e6:.2f} GB/s), joint2 kernels {kernel_ms:.2f} ms, card "
          f"idle {stream_report['idle_share']:.4f} of the wall [{card}]")
    del T_host, S_host, pinned, on_card, one_shot, h

    gen = torch.Generator(device=dev).manual_seed(4)
    sst = 20.0 + 5.0 * torch.randn(SST, device=dev, generator=gen)
    want = hist(sst, bins=[EDGES_SST], axis=0)[0]
    sst_host = sst.cpu().numpy()
    del sst

    def stream_sst():
        acc = xhistogram_torch.StreamingHistogram(bins=[EDGES_SST], axis=0)
        for lat0 in range(0, SST[1], 30):  # kept-offset tiles of 30 latitudes
            for t0_ in range(0, SST[0], 73):  # chunks of 73 days
                acc.update(sst_host[t0_:t0_ + 73, lat0:lat0 + 30], kept_offset=(lat0, 0))
        return acc.result()[0]

    t0 = time.perf_counter()
    h, n = drive("streamed config 4", stream_sst, "one_input")
    sst_wall = (time.perf_counter() - t0) * 1e3
    bits_equal("streamed config 4 against one call", h, want)
    print(f"# streamed config 4, (365, 180, 360) numpy in 6 kept-offset tiles of 30 "
          f"latitudes x 5 chunks of 73 days: ONE_INPUT_LAUNCHES={n}, bit-equal to one "
          f"call; wall {sst_wall:.1f} ms [{card}]")
    acc = xhistogram_torch.StreamingHistogram(bins=[np.linspace(0, 1, 3)], precision="f64")
    for v in (1e16, -1e16, 1.0):
        acc.update(np.array([0.25], np.float32), weights=np.array([v]))
    h = acc.result()[0]
    if h.tolist() != [1.0, 0.0] or h.device != dev:
        raise AssertionError(f"streamed f64 1e16, -1e16, 1.0 gave {h.tolist()}")
    print("# streamed f64: 1e16, -1e16 and 1.0 in three chunks give exactly 1.0")
    del want, sst_host, h, acc

    # === public-call ms at configs 1 and 4, threshold cache cold and warm ======
    gen = torch.Generator(device=dev).manual_seed(0)
    x1 = torch.randn(CONFIG1, device=dev, generator=gen)
    sst = 20.0 + 5.0 * torch.randn(SST, device=dev, generator=gen)
    public = {}
    for name, call in (("config 1", lambda: hist(x1, bins=[EDGES1])),
                       ("config 4", lambda: hist(sst, bins=[EDGES_SST], axis=0))):
        core._THRESHOLD_CACHE.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        med, times = measure(call, reps=5)
        with kernel_spans(core, "one_input") as spans:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            b2b_ms = (time.perf_counter() - t0) * 1e3 / 20
        k_ms = sum(a.elapsed_time(b) for a, b in spans) / 20
        public[name] = {"first_ms": first_ms, "cached_ms": med * 1e3,
                        "back_to_back_ms": b2b_ms, "idle_share": 1 - k_ms / b2b_ms}
        print(f"# public call, {name}: first (cache cold) {first_ms:.3f} ms, repeated "
              f"(cache warm) median {med * 1e3:.3f} ms of {[round(v * 1e3, 3) for v in times]}; "
              f"20 back to back {b2b_ms:.4f} ms a call, kernel {k_ms:.4f} ms, card idle "
              f"{1 - k_ms / b2b_ms:.4f} [{card}]")
    del x1, sst

    # === compat ==================================================================
    gen = torch.Generator(device=dev).manual_seed(22)
    x = (14.0 + 8.0 * torch.randn(1 << 22, device=dev, generator=gen)).cpu().numpy()
    y = (35.0 + 1.5 * torch.randn(1 << 22, device=dev, generator=gen)).cpu().numpy()
    (h, ex, ey), n = drive("compat.histogram2d", lambda: compat.histogram2d(
        x, y, bins=ts_bins), "joint2")
    he, exe, eye = np.histogram2d(x, y, bins=ts_bins)
    if h.dtype != he.dtype or not np.array_equal(h, he):
        raise AssertionError(f"compat.histogram2d != numpy ({h.dtype}, {he.dtype})")
    np.testing.assert_array_equal(ex, exe)
    np.testing.assert_array_equal(ey, eye)
    print(f"# compat.histogram2d, 2^22 numpy pairs on the card: JOINT2_LAUNCHES={n}, "
          f"== numpy.histogram2d in value and dtype ({h.dtype})")
    return launches, {"f64": f64, "streaming": stream_report, "public": public}


def sharded_cases(full=True):
    """The sharded phase's cases: (name, kernel, in_spec, input shapes, bins,
    histogram keywords, weights shape and dtype or None, exact). ``full``
    gives the card's sizes; else tiny ones, for a rehearsal on the CPU."""
    from ts_cases import S_EDGES, T_EDGES

    ts, ts_f64, sst, readme, direct, row = (
        ((64, 1 << 20), (16, 1 << 20), SST, (8,) + README_TS[1:], DIRECT[0],
         (2, (1 << 23) + (1 << 21))) if full else
        ((4, 64), (4, 32), (6, 4, 5), (2, 3, 16), (8, 16), (2, 96)))
    return [
        ("T-S 2^26", "joint2", ("x", None), [ts, ts], [T_EDGES, S_EDGES], {}, None, True),
        ("config 4, sharded on latitude", "one_input", (None, "x", None), [sst],
         [EDGES_SST], {"axis": 0}, None, True),
        ("README per-level T-S, 8 times, by cell volume", "factored", (None, None, "x"),
         [readme, readme], [T_EDGES, S_EDGES], {"axis": (0, 2)},
         (readme[1:], torch.float32), False),
        ("40x40 direct on rows", "direct", ("x", None), [direct, direct],
         [linspace_edges(40), linspace_edges(40)], {"axis": 1}, None, True),
        ("f64 T-S 2^24, float64 weights", "joint2", ("x", None), [ts_f64, ts_f64],
         [T_EDGES, S_EDGES], {"precision": "f64"}, (ts_f64, torch.float64), True),
        ("f64 rows of 2^23 + 2^21", "one_input", (None, "x"), [row], [EDGES_ROW],
         {"axis": 1, "precision": "f64"}, (row, torch.float64), True),
    ]


def _sharded_inputs(shapes, weights, bins, device, seed):
    """The case's inputs, made alike on every rank from ``seed``: T-S-like
    data for T-S edges, N(0,1) otherwise (config 4: its SST field); weights
    0.5 + U(0,1) (a cell volume)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape, edges in zip(shapes, bins):
        x = torch.randn(shape, device=device, generator=gen)
        if len(edges) == 281:
            x = 14.0 + 8.0 * x
        elif len(edges) == 341:
            x = 35.0 + 1.5 * x
        elif len(edges) == 81:
            x = 20.0 + 5.0 * x
        out.append(x)
    w = None
    if weights is not None:
        shape, dtype = weights
        w = 0.5 + torch.rand(shape, device=device, generator=gen, dtype=dtype)
    return out, w


def _sharded_rank(rank, world, init, out_dir, device_type, full):
    """One rank of the sharded phase (``torch.multiprocessing.spawn``): a
    gloo group of ``world`` ranks on one device, each case's sharded call
    held against one unsharded call on the same inputs, its launches, its
    all-reduces and its wall time beside the one-card call's, written to
    ``out_dir/rank<r>.json``. Any exception fails the rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import xhistogram_torch
    from xhistogram_torch.ops import cuda_hist
    from xhistogram_torch.parallel import histogram_sharded, sharded

    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh(device_type, (world,), mesh_dim_names=("x",))
        device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
        results = {}
        for i, (name, kernel, spec, shapes, bins, kw, weights, exact) in enumerate(
                sharded_cases(full)):
            args, w = _sharded_inputs(shapes, weights, bins, device, seed=100 + i)
            want, _ = xhistogram_torch.histogram(*args, bins=bins, weights=w, **kw)
            cuda_hist.JOINT2_LAUNCHES = cuda_hist.ONE_INPUT_LAUNCHES = 0
            cuda_hist.DIRECT_LAUNCHES = cuda_hist.FACTORED_LAUNCHES = 0
            before = sharded.ALL_REDUCES
            h, _ = histogram_sharded(*args, mesh=mesh, in_spec=spec, bins=bins, weights=w,
                                     **kw)
            if device_type == "cuda":
                torch.cuda.synchronize()
            launches = {"joint2": cuda_hist.JOINT2_LAUNCHES,
                        "one_input": cuda_hist.ONE_INPUT_LAUNCHES,
                        "factored": cuda_hist.FACTORED_LAUNCHES,
                        "direct": cuda_hist.DIRECT_LAUNCHES}
            all_reduces = sharded.ALL_REDUCES - before
            got = h.to_local()
            placements = [str(p) for p in h.placements]
            if placements == ["S(0)"]:
                n = got.shape[0]
                want = want.narrow(0, rank * n, n)
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against "
                                     f"{want.dtype} {tuple(want.shape)}")
            if exact:
                if not torch.equal(got, want):
                    raise AssertionError(f"{name}: rank {rank} != one call")
                err = 0.0
            else:  # float32 sums: within two float32 ulps of one call
                ulp = (torch.nextafter(want, torch.full_like(want, math.inf)) - want).abs()
                err = float(((got - want).abs() / ulp).max())
                if err > 2:
                    raise AssertionError(f"{name}: rank {rank} {err} ulps from one call")
            if device_type == "cuda" and launches[kernel] < 1:
                raise AssertionError(f"{name}: rank {rank} launched no {kernel}: {launches}")

            def timed(fn):
                def run():
                    dist.barrier()
                    fn()
                return measure(run, reps=3)[0] * 1e3

            results[name] = {
                "kernel": kernel, "launches": launches, "all_reduces": all_reduces,
                "placements": placements, "max_ulps": err,
                "sharded_ms": timed(lambda: histogram_sharded(
                    *args, mesh=mesh, in_spec=spec, bins=bins, weights=w, **kw)),
                "one_card_ms": timed(lambda: xhistogram_torch.histogram(
                    *args, bins=bins, weights=w, **kw)),
            }
            del args, w, want, h, got
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_sharded_ranks(world, device_type, full, timeout):
    """``world`` ranks of ``_sharded_rank`` spawned on this machine; each
    rank's results. A rank that raises or outlasts ``timeout`` seconds fails
    the run, and every rank is stopped before this returns."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _sharded_rank, args=(world, os.path.join(tmp, "rendezvous"), tmp, device_type,
                                 full),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise AssertionError(f"the sharded ranks did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def sharded_phase(dev, card, reset_counts, counts_now):
    """``parallel.histogram_sharded`` on the one card: (a) one rank over
    NCCL (a one-rank DeviceMesh on cuda: the kernel and a real NCCL
    all-reduce), then (b) two ranks spawned on the same card over gloo (NCCL
    takes one rank a device), each case held against one unsharded call on
    the same inputs. Prints each case's launches per rank, all-reduces and
    the sharded call's wall ms beside the one-card call's. Returns the
    launches by kernel, as rank 0 saw them with (a)'s."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ts_cases import S_EDGES, T_EDGES
    import xhistogram_torch
    from xhistogram_torch.parallel import histogram_sharded, sharded

    launches = dict.fromkeys(("joint2", "one_input", "factored", "direct"), 0)
    # --- (a) one rank over NCCL -----------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("x",))
            args, _ = _sharded_inputs([(64, 1 << 20)] * 2, None, [T_EDGES, S_EDGES], dev, 7)
            want, _ = xhistogram_torch.histogram(*args, bins=[T_EDGES, S_EDGES])
            reset_counts()
            before = sharded.ALL_REDUCES
            h, _ = histogram_sharded(*args, mesh=mesh, in_spec=("x", None),
                                     bins=[T_EDGES, S_EDGES])
            torch.cuda.synchronize()
            now, n_reduce = counts_now(), sharded.ALL_REDUCES - before
            if now["joint2"] != 1 or n_reduce != 1 or not torch.equal(h.to_local(), want):
                raise AssertionError(f"one NCCL rank, T-S 2^26: launches {now}, "
                                     f"all-reduces {n_reduce}, equal to one call: "
                                     f"{torch.equal(h.to_local(), want)}")
            launches["joint2"] += now["joint2"]
            nccl_ms = measure(lambda: histogram_sharded(
                *args, mesh=mesh, in_spec=("x", None), bins=[T_EDGES, S_EDGES]), reps=3)[0]
            one_ms = measure(lambda: xhistogram_torch.histogram(
                *args, bins=[T_EDGES, S_EDGES]), reps=3)[0]
            print(f"# sharded, one NCCL rank, T-S 2^26 pairs: JOINT2_LAUNCHES=1, "
                  f"all-reduces {n_reduce} (NCCL), bit-equal to one call; sharded "
                  f"{nccl_ms * 1e3:.3f} ms, one-card call {one_ms * 1e3:.3f} ms [{card}]")
            del args, want, h
        finally:
            dist.destroy_process_group()
    # --- (b) two ranks on the one card over gloo -------------------------------
    ranks = run_sharded_ranks(2, "cuda", True, timeout=300)
    for name, r0 in ranks[0].items():
        r1 = ranks[1][name]
        for k in launches:
            launches[k] += r0["launches"][k]
        per_rank = "; ".join(
            f"rank {i}: {r['launches'][r['kernel']]} {r['kernel']} launch(es), "
            f"{r['all_reduces']} all-reduce(s), sharded {r['sharded_ms']:.3f} ms, "
            f"one-card {r['one_card_ms']:.3f} ms" for i, r in enumerate((r0, r1)))
        match = ("bit-equal to one call" if r0["max_ulps"] == 0 and r1["max_ulps"] == 0
                 else f"within {max(r0['max_ulps'], r1['max_ulps']):.2f} float32 ulps "
                      "of one call")
        print(f"# sharded, two gloo ranks on one card, {name}: output {r0['placements']}, "
              f"{match}; {per_rank} [{card}]")
    print(f"# sharded phase: {time.perf_counter() - t0:.1f} s with the spawns [{card}]")
    return launches, {"nccl_one_rank_ms": nccl_ms * 1e3, "one_card_ms": one_ms * 1e3,
                      "two_gloo_ranks": ranks[0]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    try:
        from ts_cases import (
            EDGE_SETS, S_EDGES, T_EDGES, edge_case_data, edge_case_values,
            numpy_hist2d, reference_numpy, reference_numpy_ts, ts_data,
        )
        import xhistogram_torch
        from xhistogram_torch.bins import compare_form
        from xhistogram_torch.ops import _build, cuda_hist
        from xhistogram_torch.utils.axes import canonicalize_2d
        from xhistogram_torch.utils import profiling
    except ImportError as ex:
        # run alone, outside a checkout: nothing to build or drive
        raise SystemExit(f"chip_smoke.py runs from the root of a checkout of the "
                         f"repository, beside xhistogram_torch/ and tests/: {ex}") from None

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"# card: {card} | torch.cuda: {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # the key of the factored kernel's launches under each of plan()'s
    # factored routes
    factored_keys = {"factored": "factored full", "factored_per_row": "factored per_row",
                     "factored_packed": "factored packed"}
    routes_at_reset = {}

    def reset_counts():
        cuda_hist.JOINT2_LAUNCHES = 0
        cuda_hist.ONE_INPUT_LAUNCHES = 0
        cuda_hist.FACTORED_LAUNCHES = 0
        cuda_hist.DIRECT_LAUNCHES = 0
        routes_at_reset.update(profiling.ROUTES)

    def counts_now():
        """Each kernel's launches since ``reset_counts()``; the factored
        kernel's under the factored route ``profiling.ROUTES`` counted since
        (under "factored" where it counted none, or more than one)."""
        took = [r for r in factored_keys if profiling.ROUTES[r] > routes_at_reset[r]]
        factored = dict.fromkeys(factored_keys.values(), 0)
        if cuda_hist.FACTORED_LAUNCHES:
            key = factored_keys[took[0]] if len(took) == 1 else "factored"
            factored[key] = cuda_hist.FACTORED_LAUNCHES
        return {"joint2": cuda_hist.JOINT2_LAUNCHES,
                "one_input": cuda_hist.ONE_INPUT_LAUNCHES, **factored,
                "direct": cuda_hist.DIRECT_LAUNCHES}

    def one_input_note():
        """The last one_input launch's layout, copies, K and L, printed."""
        rec = cuda_hist.last_launch()
        note = (f"{rec['layout']} ({rec['copies']} copies), K={rec['cells'][0]} "
                f"L={rec['widest']}, read as {rec['load']}")
        print(f"#   one_input launch: {note}")
        return note

    def thresholds(edges, dtype=np.float32):
        ce = compare_form(edges, dtype)
        if ce.n_hi_clip:
            raise ValueError("the kernels take thresholds with n_hi_clip == 0")
        return torch.from_numpy(ce.edges).to(dev)

    # --- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"# build: {time.perf_counter() - t0:.2f} s (one nvcc per source, in "
          "parallel, sm_90a); each source's nvcc: "
          + ", ".join(f"{name} {sec:.1f} s" for name, sec in
                      sorted(_build.BUILD_SECONDS.items(), key=lambda kv: kv[1])))
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"#   ptxas: {line.strip()}")

    # === joint2 ===============================================================
    # --- kernel vs plain on the card, bit-exact --------------------------------
    t_edges, s_edges = T_EDGES, S_EDGES  # bench.py's float32 edges
    max_abs_err = {"joint2": 0, "one_input": 0, "factored": 0, "direct": 0}
    bucket_phase(dev, max_abs_err)

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
    launch, note = launch_note([ta.cpu(), tb.cpu()])
    if (launch["cluster"], launch["passes"]) != (2, 1):
        raise AssertionError(f"joint2 path: {note}, not one pass in clusters of two")
    print(f"# joint2 path: JOINT2_LAUNCHES={j2_launches}, int64 (280, 340), "
          f"{total} of {T.numel()} pairs in range; {note}")
    ts_kernel_ms = event_ms(lambda: cuda_hist.joint2(T, S, ta, tb, 280, 340), reps=3)
    ts_bound_ms, _ = bound(8 * T.numel() + 8 * 95201, 0)
    print(f"# joint2 kernel at the path's 2^30 pairs: {ts_kernel_ms:.4f} ms "
          f"({8 * T.numel() / ts_kernel_ms / 1e6:.1f} GB/s), bound {ts_bound_ms:.4f} ms "
          f"by bytes [{card}]")

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
    oi_layouts = {"config 1": one_input_note()}
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
    oi_layouts["config 2"] = one_input_note()
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
    oi_layouts["2^30 row"] = one_input_note()
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
    oi_layouts["config 4"] = one_input_note()
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
    oi_launches, oi_narrow = one_input_phase(dev, card, reset_counts, counts_now,
                                             max_abs_err)
    launches.update(oi_launches)
    # --- joint2, factored and direct on narrow data read in place --------------
    t_narrow = time.perf_counter()
    narrow_cases = narrow_kernels(dev, max_abs_err)
    narrow_cases += narrow_bucket_sets(dev, max_abs_err)
    narrow_launches, narrow_rows = narrow_paths(dev, card, reset_counts, counts_now,
                                                max_abs_err)
    print(f"# narrow phase: {narrow_cases} kernel cases == plain on a widened copy, "
          f"{len(narrow_rows)} public paths, {time.perf_counter() - t_narrow:.1f} s")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the one_input path ({name}) did not launch one_input")

    slot = factored_and_direct(dev, card, thresholds, reset_counts, counts_now,
                               max_abs_err)
    rows, rows_cases = direct_rows_phase(dev, card, reset_counts, counts_now, max_abs_err)
    direct = slot[1]
    direct["launches"] += rows["public float-weighted 40x40 (64800, 64)"]["direct_launches"]
    direct["template_ms"] = rows["(64800, 64) counts"]["template_ms"]
    direct["device_ms"] = rows["(64800, 64) counts"]["device_ms"]
    direct["rows_kernel"] = {"cases_held_to_plain": rows_cases, **rows}
    mixed = mixed_and_uint64_phase(dev, card, reset_counts, counts_now, max_abs_err)
    t_pairs = time.perf_counter()
    pair_cases = mixed_pair_kernels(dev, max_abs_err)
    pair_launches, pair_rows = mixed_pair_paths(dev, card, reset_counts, counts_now,
                                                max_abs_err)
    print(f"# mixed pair phase: {pair_cases} kernel cases == plain on widened copies, "
          f"{len(pair_rows)} public paths, {time.perf_counter() - t_pairs:.1f} s")
    t_views = time.perf_counter()
    view_launches, view_rows = view_paths(dev, card, reset_counts, counts_now, max_abs_err)
    print(f"# views and unsigned read in place: {len(view_rows)} public paths, "
          f"{time.perf_counter() - t_views:.1f} s")
    weighted = weighted_phase(dev, card, thresholds, reset_counts, counts_now)
    api_launches, api = api_phase(dev, card, reset_counts, counts_now)
    sharded_launches, sharded = sharded_phase(dev, card, reset_counts, counts_now)

    kernels = [
        {
            "name": "joint2",
            "route": "cuda",
            "source": "xhistogram_torch/csrc/joint2.cuh",
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
            "source": "xhistogram_torch/csrc/one_input.cuh",
            "replaces": "xhistogram_tpu/ops/pallas_hist.py:1268",
            "launches": sum(launches.values()),
            "max_abs_err": max_abs_err["one_input"],
            "ms": oi_kernel_ms,
            "plain_ms": oi_plain_ms,
            "bound_ms": oi_bound_ms,
            "bound_by": oi_bound_by,
            "library_ms": oi_library_ms,
            "layouts": oi_layouts,
            "narrow_rows": {label: {"ms": ms, "widened_copy_and_kernel_ms": wide_ms,
                                    "bound_ms": b_ms}
                            for label, (ms, wide_ms, b_ms) in oi_narrow.items()},
        },
        *slot,
    ]
    family = {"joint2": "joint2", "per_row": "factored", "direct": "direct"}
    for entry in kernels:  # the narrow paths: launches, loads, times in turns
        rows = {label: rec for label, rec in narrow_rows.items()
                if family[rec["kernel"]] == entry["name"]}
        if rows:
            entry["launches"] += sum(narrow_launches[label] for label in rows)
            entry["narrow_rows"] = rows
        entry["loads"] = sorted({d for rec in rows.values() for d in rec["loads"]}
                                | ({"float32"} if entry["name"] != "one_input" else
                                   {"float32", "bfloat16", "int8"}))
    kernels[0]["narrow_kernel_cases"] = narrow_cases
    family = {"joint2": "joint2", "per_row": "factored", "full": "factored",
              "direct": "direct"}
    for entry in kernels:  # the mixed pair paths: launches, loads, times in turns
        rows = {label: rec for label, rec in pair_rows.items()
                if family[rec["kernel"]] == entry["name"]}
        if rows:
            entry["launches"] += sum(pair_launches[label] for label in rows)
            entry["mixed_pair_rows"] = rows
            entry["loads"] = sorted(set(entry["loads"]) |
                                    {d for rec in rows.values() for d in rec["loads"]})
    kernels[0]["mixed_pair_kernel_cases"] = pair_cases
    family = {"joint2": "joint2", "per_row": "factored", "one_input": "one_input",
              "one_input_full": "one_input", "direct": "direct"}
    for entry in kernels:  # the view and unsigned paths: launches, times in turns
        rows = {label: rec for label, rec in view_rows.items()
                if family[rec["kernel"]] == entry["name"]}
        entry["launches"] += view_launches[entry["name"]]
        if rows:
            entry["view_rows"] = rows
    for entry in kernels:  # the weighted, mixed and API paths' launches join the counts
        entry.update(weighted[entry["name"]])
        entry["api_launches"] = api_launches[entry["name"]]
        entry["sharded_launches"] = sharded_launches[entry["name"]]
        entry["launches"] += (entry["weighted_launches"] + mixed[entry["name"]]
                              + entry["api_launches"] + entry["sharded_launches"])
    kernels[0]["f64"] = api["f64"]["T-S 2^26"]
    kernels[0]["streamed_2^30"] = api["streaming"]
    kernels[1]["public_cache"] = api["public"]
    kernels[0]["sharded"] = sharded
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
