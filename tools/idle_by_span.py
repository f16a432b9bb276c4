"""Where the card waits for the host in a benchmark cell's call, by the
program's span that was open on the host.

Run from the repository root on a machine with a CUDA card:

    python3 tools/idle_by_span.py --workload NAME [--seconds 2] [--seed N]
                                  [--out DIR]

It makes the cell's data and call at the cell's own size through
``portbench`` (its registry, recipes and call kinds, which it only
imports), warms the call up and then, each call ended by a synchronise of
the card as in the benchmark's window:

1. runs the call for ``--seconds`` with no profiler: each call's wall and
   host time, and the host time of each span's stage per call
   (``utils/profiling.SELF_NS``), with the host syncs per call;
2. runs it as long again under ``utils/profiling.trace``, whose Chrome
   trace puts the ``xhistogram.*`` ranges and the card's kernels, copies
   and memsets on one clock. The card is idle where no kernel, copy or
   memset runs on any stream; each idle gap goes to the innermost
   ``xhistogram.*`` range open on the host at the gap's midpoint, or to
   "outside the program" (the synchronise and the loop between calls),
   and, cut where a range opens or closes, piece by piece to the range
   open in each piece;
3. runs one call under ``torch.cuda.set_sync_debug_mode("warn")`` and
   names each line of Python that blocked the host on the card;
4. times a bare span with no profiler, in ns, and counts the spans of a
   tiny call on the card.

It prints the card's name and power limit, the idle seconds per span, the
call's time with and without the profiler (their difference is what the
tracing costs while on), and one JSON line, also written to
``DIR/idle_by_span_<workload>.json`` (``DIR`` by default
``idle_by_span_out/`` in the checkout). It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time
import warnings
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

OUTSIDE = "outside the program"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(ranges, starts, t):
    """The name of the innermost range open at ``t`` (opened last, and of
    two opened together the shorter), or ``OUTSIDE``."""
    open_ = [r for r in ranges[:bisect.bisect_right(starts, t)] if r[1] > t]
    return max(open_, key=lambda r: (r[0], -r[1]))[2] if open_ else OUTSIDE


def idle_by_span(events):
    """``(idle seconds by span, the same split at span edges, busy seconds,
    window seconds)`` of a ``profiling.trace`` file's events; the window
    runs from the first public call's range to the last one's end. The
    first puts each idle gap whole under the span open at its midpoint; the
    second cuts each gap where a span opens or closes and puts each piece
    under the span open in it."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                    and e.get("name", "").startswith("xhistogram."))
    roots = [r for r in ranges if r[2] in ("xhistogram.call", "xhistogram.labeled")]
    if not roots:
        raise SystemExit("the trace holds no xhistogram.call or xhistogram.labeled range")
    start, end = roots[0][0], max(r[1] for r in roots)
    busy = union([(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS])
    busy = [[max(s, start), min(e, end)] for s, e in busy if e > start and s < end]
    starts = [r[0] for r in ranges]
    bounds = sorted({x for r in ranges for x in r[:2]})
    whole, split = defaultdict(float), defaultdict(float)
    edges = [start, *(x for iv in busy for x in iv), end]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        whole[_innermost(ranges, starts, (a + b) / 2)] += (b - a) * 1e-6
        cuts = [a, *bounds[bisect.bisect_right(bounds, a):bisect.bisect_left(bounds, b)], b]
        for x, y in zip(cuts, cuts[1:]):
            split[_innermost(ranges, starts, (x + y) / 2)] += (y - x) * 1e-6

    def ordered(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    return (ordered(whole), ordered(split), sum(e - s for s, e in busy) * 1e-6,
            (end - start) * 1e-6)


def timed_calls(program, item, seconds):
    """Each call's (wall, host) seconds over ``seconds`` of calls, each
    ended by a synchronise of the card."""
    walls, hosts = [], []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        program(item)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        walls.append(t2 - t0)
        hosts.append(t1 - t0)
        if t2 - t_start >= seconds:
            return np.asarray(walls), np.asarray(hosts)


def _short(filename):
    path = Path(filename)
    return str(path.relative_to(ROOT)) if ROOT in path.parents else filename


def sync_sites(program, item):
    """{"file:line": syncs} that one call's sync debug mode reported, and the
    change of ``HOST_SYNCS`` in the call."""
    from xhistogram_torch.utils import profiling

    torch.cuda.synchronize()
    before = profiling.HOST_SYNCS
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            program(item)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = Counter(f"{_short(w.filename)}:{w.lineno}" for w in caught
                    if "called a synchronizing CUDA operation" in str(w.message))
    return dict(sites), profiling.HOST_SYNCS - before


def span_cost_ns(n=200_000):
    """ns of one bare span with no profiler running (best of three runs)."""
    from xhistogram_torch.utils.profiling import scope

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with scope("span_cost"):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def tiny_call(device, out_dir):
    """(host us of a tiny call on the card, its spans) : 4096 float32 values
    in 16 bins, the median of 200 calls, and the ranges of one traced call."""
    import xhistogram_torch
    from xhistogram_torch.utils import profiling

    x = torch.rand(4096, device=device)
    edges = [np.linspace(0, 1, 17)]
    for _ in range(20):
        xhistogram_torch.histogram(x, bins=edges)
    torch.cuda.synchronize()
    hosts = []
    for _ in range(200):
        t0 = time.perf_counter()
        xhistogram_torch.histogram(x, bins=edges)
        hosts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    with profiling.trace(out_dir / "tiny"):
        xhistogram_torch.histogram(x, bins=edges)
        torch.cuda.synchronize()
    path = out_dir / "tiny" / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    spans = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                and e.get("name", "").startswith("xhistogram."))
    return float(np.median(hosts)) * 1e6, spans


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seed", type=int, default=2**31 + 11)
    p.add_argument("--out", default=str(ROOT / "idle_by_span_out"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("idle_by_span needs a CUDA card", file=sys.stderr)
        return 2

    from portbench.registry import Cell
    from xhistogram_torch.utils import profiling

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = card_line()
    device = torch.device("cuda", 0)
    cell = Cell(args.workload)
    fields = list(cell.traffic["inputs"])
    if cell.traffic.get("weights"):
        fields.append(cell.traffic["weights"])
    data = cell.recipe.make(cell.config, args.seed, device, fields)
    calls = cell.kind.build(data, cell.traffic, device)
    program, item = calls.program, calls.items[0]
    for _ in range(3):
        program(item)
    torch.cuda.synchronize()

    spans0, syncs0, n0 = dict(profiling.SELF_NS), profiling.HOST_SYNCS, profiling.CALLS
    walls_off, hosts_off = timed_calls(program, item, args.seconds)
    n = len(walls_off)
    split = {k: (v - spans0.get(k, 0)) / n / 1e3 for k, v in profiling.SELF_NS.items()
             if v != spans0.get(k, 0)}
    syncs = (profiling.HOST_SYNCS - syncs0) / n
    public_calls = (profiling.CALLS - n0) / n

    trace_dir = out_dir / f"trace_{args.workload}"
    with profiling.trace(trace_dir):
        walls_on, hosts_on = timed_calls(program, item, args.seconds)
    events = json.loads((trace_dir / profiling.TRACE_FILE).read_text())["traceEvents"]
    idle, idle_split, busy_s, window_s = idle_by_span(events)
    (trace_dir / profiling.TRACE_FILE).unlink()  # large; the figures are below

    sites, counted = sync_sites(program, item)
    cost_ns = span_cost_ns()
    tiny_us, tiny_spans = tiny_call(device, out_dir)

    result = {
        "workload": args.workload, "card": card, "seed": args.seed,
        "calls_off": n, "public_calls_per_call": public_calls,
        "call_ms_off": float(walls_off.mean() * 1e3), "host_us_off": float(hosts_off.mean() * 1e6),
        "calls_on": len(walls_on), "call_ms_on": float(walls_on.mean() * 1e3),
        "host_us_on": float(hosts_on.mean() * 1e6),
        "tracing_cost_us_per_call": float((walls_on.mean() - walls_off.mean()) * 1e6),
        "self_us_per_call": split, "spans_sum_us": float(sum(split.values())),
        "host_syncs_per_call": syncs,
        "idle_s_by_span": idle, "idle_s_by_span_split": idle_split,
        "busy_s": busy_s, "window_s": window_s,
        "sync_sites": sites, "host_syncs_counted_in_that_call": counted,
        "span_cost_ns_off": cost_ns, "tiny_call_host_us": tiny_us, "tiny_call_spans": tiny_spans,
    }
    print(f"card {card}; cell {args.workload}, seed {args.seed}")
    print(f"no profiler: {n} calls, {result['call_ms_off']:.3f} ms a call, host part "
          f"{result['host_us_off']:.1f} us; spans' self time a call (us): "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
          + f"; sum {result['spans_sum_us']:.1f}; host syncs a call {syncs:g}")
    print(f"profiled: {len(walls_on)} calls, {result['call_ms_on']:.3f} ms a call, host part "
          f"{result['host_us_on']:.1f} us; tracing costs "
          f"{result['tracing_cost_us_per_call']:.1f} us a call while on")
    print(f"card idle {window_s - busy_s:.6f} s of {window_s:.6f} s, by span "
          "(each gap whole at its midpoint; cut at span edges):")
    for name in sorted(set(idle) | set(idle_split), key=lambda k: -idle_split.get(k, 0)):
        a, b = idle.get(name, 0.0), idle_split.get(name, 0.0)
        print(f"  {name:32s} {a:.6f} s {100 * a / window_s:6.3f}%   {b:.6f} s "
              f"{100 * b / window_s:6.3f}%")
    print(f"syncs in one call: {sites or 'none'} (HOST_SYNCS counted {counted})")
    print(f"a bare span with no profiler: {cost_ns:.1f} ns; a tiny call on the card: "
          f"{tiny_us:.1f} us of host time, {tiny_spans} spans")
    (out_dir / f"idle_by_span_{args.workload}.json").write_text(json.dumps(result))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
