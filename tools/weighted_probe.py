"""What weights cost the port's four kernels, on one CUDA card.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/weighted_probe.py [--root DIR] [--unweighted-only]

``--root`` imports ``xhistogram_torch`` from another checkout (for example
an unpacked parent commit), so two versions can be timed in turns within
one call; ``--unweighted-only`` times only what every version has. It
prints, each line beside the card's name and power limit, and as one JSON
line at the end:

- each unweighted kernel at the shape of its PERF.md §6 row (joint2 at 2^26
  T–S pairs in 280x340 bins, and at the main path's 2^30; one_input at
  BASELINE config 1, config 2's kept rows, unweighted and with float32
  weights, config 4's strided rows and the 2^30 row in 64 bins; factored
  per row at the README's per-depth T–S layout; direct at (64800, 64) x 2
  in 40x40 bins), in CUDA-event milliseconds, in turns (each shape's calls
  twice, in reverse order the second time);
- each weighted kernel at config 2 (one_input, kept rows), config 1 (full),
  the T–S shape (joint2), (1000, 100000) x 2 in 150x90 bins per row
  (factored, shared memory) and the direct shape, with weights of every
  accumulator class: none, uint8 and int32 (32-bit integer adds), int64
  (64-bit integer adds), float32 and float64 (float64 adds). uint8 against
  none shows the cost of reading the weights, float32 against int64 that
  of float64 atomics against integer ones of the same width;
- the atomic instructions each kernel compiles to (from ``cuobjdump
  -sass`` of the built library), which show whether an accumulator's
  atomic is one instruction or a compare-and-swap loop; one_input's
  kernels by counter layout (lane-private, or copies: warp replicas and
  aggregated).

It imports nothing of JAX.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

T_EDGES = np.linspace(-2.0, 30.0, 281).astype(np.float32)
S_EDGES = np.linspace(30.0, 40.0, 341).astype(np.float32)
EDGES1 = np.linspace(-4, 4, 51)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def event_ms(fn, reps=10):
    """Mean device milliseconds of ``fn()`` over ``reps`` launches, after one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def linspace_edges(nb):
    return np.linspace(-4.0, 4.0, nb + 1)


def sass_atomics(lib_path):
    """{kernel kind: sorted atomic opcodes} of the built library, where a
    kind is the kernel's name and its weight policy (Count, or Sum of the
    accumulator type)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                         timeout=600)
    kinds = {}
    name = None
    policies = {"xh5Count": "Count", "SumIjE": "Sum<uint32>", "SumIyE": "Sum<uint64>",
                "SumIdE": "Sum<double>"}
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            mangled = m.group(1)
            kernel = next((k for k in ("joint2_kernel", "one_input_kernel",
                                       "slot_hist_kernel") if k in mangled), None)
            policy = next((v for k, v in policies.items() if k in mangled), None)
            name = f"{kernel} {policy}" if kernel and policy else None
            if name and kernel == "one_input_kernel":
                name += " private" if "ELb1E" in mangled else " copies"
            if name:
                kinds.setdefault(name, set())
            continue
        if name:
            for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Z0-9._]+)", line):
                kinds[name].add(op)
    return {k: sorted(v) for k, v in sorted(kinds.items())}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=None)
    p.add_argument("--unweighted-only", action="store_true")
    args = p.parse_args()
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        raise SystemExit("weighted_probe.py needs a CUDA card")
    import xhistogram_torch
    from xhistogram_torch.bins import compare_form
    from xhistogram_torch.ops import _build, cuda_hist
    from xhistogram_torch.utils.axes import canonicalize_2d

    if not os.path.dirname(xhistogram_torch.__file__).startswith(root):
        raise SystemExit(f"imported {xhistogram_torch.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    card = card_line()
    lib_path = _build.load()._name
    print(f"# root {root} | {card}")

    def thr(edges):
        return torch.from_numpy(compare_form(edges, np.float32).edges).to(dev)

    result = {"root": root, "card": card, "unweighted": {}, "weighted": {}}
    gen = torch.Generator(device=dev).manual_seed(0)

    # --- the unweighted kernels at their §6 shapes -----------------------------
    t = 14.0 + 8.0 * torch.randn(1 << 26, device=dev, generator=gen)
    s = 35.0 + 1.5 * torch.randn(1 << 26, device=dev, generator=gen)
    ta, tb = thr(T_EDGES), thr(S_EDGES)
    x = torch.randn(1000, 100_000, device=dev, generator=gen)
    x_row, t1 = x.reshape(1, -1), thr(EDGES1)
    T = 14.0 + 8.0 * torch.randn(73, 50, 64800, device=dev, generator=gen)
    S = 35.0 + 1.5 * torch.randn(73, 50, 64800, device=dev, generator=gen)
    readme = [canonicalize_2d(T, (0, 2)), canonicalize_2d(S, (0, 2))]
    del T, S
    a, b = (torch.randn(64800, 64, device=dev, generator=gen) for _ in range(2))
    t40 = [thr(linspace_edges(40))] * 2
    w2 = torch.rand(x.shape, device=dev, generator=gen)
    sst = canonicalize_2d(20.0 + 5.0 * torch.randn(365, 180, 360, device=dev,
                                                   generator=gen), (0,))
    t80 = thr(np.linspace(0, 40, 81))
    xr = torch.randn(1, 1 << 30, device=dev, generator=gen)
    t64 = thr(linspace_edges(64))
    T30 = 14.0 + 8.0 * torch.randn(1024, 1 << 20, device=dev, generator=gen)
    S30 = 35.0 + 1.5 * torch.randn(1024, 1 << 20, device=dev, generator=gen)
    calls = {
        "joint2": lambda: cuda_hist.joint2(t, s, ta, tb, 280, 340),
        "joint2 2^30": lambda: cuda_hist.joint2(T30, S30, ta, tb, 280, 340),
        "one_input": lambda: cuda_hist.one_input(x_row, t1, 50, True),
        "one_input config 2": lambda: cuda_hist.one_input(x, t1, 50, False),
        "one_input config 2 float32 weights": lambda: cuda_hist.one_input(
            x, t1, 50, False, weights=w2),
        "one_input config 4": lambda: cuda_hist.one_input(sst, t80, 80, False),
        "one_input 2^30 row": lambda: cuda_hist.one_input(xr, t64, 64, True),
        "factored": lambda: cuda_hist.factored(readme, [ta, tb], [280, 340], False),
        "direct": lambda: cuda_hist.direct([a, b], t40, [40, 40]),
    }
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:  # in turns
        big = name in ("factored", "joint2 2^30", "one_input 2^30 row")
        times[name].append(event_ms(calls[name], reps=5 if big else 20))
    result["unweighted"] = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"# kernels at their PERF.md §6 shapes (ms): "
          f"{ {k: round(v, 4) for k, v in result['unweighted'].items()} } [{card}]")
    del readme, w2, sst, xr, T30, S30
    torch.cuda.empty_cache()

    if not args.unweighted_only:
        # --- each weighted kernel by accumulator class ---------------------------
        def weights(shape, dtype):
            g = torch.Generator(device=dev).manual_seed(1)
            if dtype.is_floating_point:
                return torch.rand(shape, device=dev, generator=g, dtype=dtype)
            hi = {torch.uint8: 256, torch.int32: 2**30, torch.int64: 2**40}[dtype]
            return torch.randint(0, hi, shape, device=dev, generator=g).to(dtype)

        pair = [torch.randn(1000, 100_000, device=dev, generator=gen) for _ in range(2)]
        t150, t90 = thr(linspace_edges(150)), thr(linspace_edges(90))
        shapes = {
            "one_input config 2 (kept rows)": (
                x.shape, lambda w: cuda_hist.one_input(x, t1, 50, False, weights=w)),
            "one_input config 1 (full)": (
                x_row.shape, lambda w: cuda_hist.one_input(x_row, t1, 50, True, weights=w)),
            "joint2 2^26 T-S": (
                t.shape, lambda w: cuda_hist.joint2(t, s, ta, tb, 280, 340, weights=w)),
            "factored per row 150x90 (shared)": (
                pair[0].shape, lambda w: cuda_hist.factored(pair, [t150, t90], [150, 90],
                                                            False, weights=w)),
            "direct (64800, 64) 40x40": (
                a.shape, lambda w: cuda_hist.direct([a, b], t40, [40, 40], weights=w)),
        }
        dtypes = {"none": None, "uint8": torch.uint8, "int32": torch.int32,
                  "int64": torch.int64, "float32": torch.float32,
                  "float64": torch.float64}
        for label, (shape, fn) in shapes.items():
            ws = {k: None if d is None else weights(shape, d) for k, d in dtypes.items()}
            order = list(ws) + list(ws)[::-1]  # in turns, each twice
            times = {k: [] for k in ws}
            for k in order:
                times[k].append(event_ms(lambda: fn(ws[k])))
            row = {k: sum(v) / len(v) for k, v in times.items()}
            result["weighted"][label] = row
            print(f"# {label}, ms by weights: { {k: round(v, 4) for k, v in row.items()} } "
                  f"[{card}]")
            del ws
        atomics = sass_atomics(lib_path)
        result["sass_atomics"] = atomics
        for kind, ops in atomics.items():
            print(f"# SASS atomics of {kind}: {' '.join(ops)}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
