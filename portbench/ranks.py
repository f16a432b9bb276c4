"""A cell on several cards: one process a card, rank r on ``cuda:r`` (or
the CPU, for rehearsals), each running the cell's call in a closed loop.

Rank 0 is the process of ``run.py`` (or of ``harness.run_cell``); it starts
the others (``procs.Children``) and alone prints the line. The ranks meet at
a localhost port: the program's default group is NCCL's (gloo's on the
CPU), and the harness has a gloo group of its own for what it agrees and
gathers. Per seed:

1. each rank makes its slab of the data (the recipe gets ``rank`` and
   ``world``), builds the calls (the call kind gets this ``Context``), and
   makes every call once and then ``STEADY_CALLS`` more, timed;
2. the ranks agree the window's number of calls: ``--seconds`` at the
   slowest rank's pace, a rank's pace the median of those calls;
3. after a barrier each rank makes that many calls, each timed from entry
   to ``torch.cuda.synchronize()``; nothing but the program's own
   collectives passes between the ranks;
4. after the window each rank checks its answer against the reference,
   whose parts the harness's group adds, and rank 0 gathers every rank's
   reading and merges them (``merge``).

In a checkout's first run rank 0 builds the program's kernel library while
the others wait at a barrier, so four builds never race on one directory.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import math
import os
import sys
import time
import traceback
from collections import defaultdict
from datetime import timedelta
from pathlib import Path

if __name__ == "__main__":
    T_PROCESS = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from portbench import devtrace, harness, peaks, procs, reference, registry  # noqa: E402

#: the process groups' timeout: a collective that waits longer raises
GROUP_TIMEOUT_S = 300
#: timed warm-up calls whose median is a rank's pace (two gave one window
#: of 6.4 s in thirteen, from one slow call)
STEADY_CALLS = 5


class Context:
    """This rank's place in the cell: ``rank``, ``world``, ``device``, and
    the harness's own gloo group for what the ranks agree and gather."""

    def __init__(self, rank, world, port, device):
        self.rank, self.world, self.device = rank, world, device
        for name in ("NCCL_SOCKET_IFNAME", "GLOO_SOCKET_IFNAME"):
            os.environ.setdefault(name, "lo")  # the ranks meet on this host only
        if device.type == "cuda":
            torch.cuda.set_device(device)
        timeout = timedelta(seconds=GROUP_TIMEOUT_S)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=timeout)
        self.group = dist.new_group(backend="gloo", timeout=timeout)

    def barrier(self):
        dist.barrier(group=self.group)

    def most(self, x):
        """The largest of the ranks' numbers ``x``."""
        t = torch.tensor([float(x)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t)

    def sum(self, t):
        """The ranks' tensors ``t`` added, on ``t``'s device: the harness's
        sum of the reference's parts, never the program's all-reduce."""
        out = t.cpu()
        dist.all_reduce(out, group=self.group)
        return out.to(t.device)

    def gather(self, obj):
        """Every rank's ``obj`` in rank order on rank 0, None on the others."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def close(self):
        dist.destroy_process_group()


def _seed(cell, ctx, seed, seconds, trace, t_process, setup_marks=()):
    """Set-up, window and check of one seed on this rank: its reading."""
    device = ctx.device
    cuda = device.type == "cuda"
    if cuda:
        torch.zeros((), device=device)  # the card's context
        torch.cuda.reset_peak_memory_stats(device)
    t_data = time.perf_counter()
    fields = list(cell.traffic["inputs"])
    if cell.traffic.get("weights"):
        fields.append(cell.traffic["weights"])
    data = cell.recipe.make(cell.config, seed, device, fields, rank=ctx.rank, world=ctx.world)
    harness._sync(device)
    t_warm = time.perf_counter()
    calls = cell.kind.build(data, cell.traffic, device, ctx)
    items = calls.items
    for item in items:  # every shape
        calls.program(item)
    harness._sync(device)
    steady = []
    for _ in range(STEADY_CALLS):
        t0 = time.perf_counter()
        calls.program(items[0])
        harness._sync(device)
        steady.append(time.perf_counter() - t0)
    pace = ctx.most(float(np.median(steady)))
    n_calls = max(1, math.ceil(seconds / pace))

    readers = [cell.reader(m["name"]) for m in cell.metrics(trace)]
    counters = harness._counter_reader(readers)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    judged = set(calls.judged)
    latest = {}
    c0 = counters()
    gc.collect()
    gc.freeze()
    prof = devtrace.start(device) if trace else None
    n_items = len(items)
    marks, walls = [], []
    ctx.barrier()
    t_start, wall_start = time.perf_counter(), time.time_ns()
    for i in range(n_calls):
        k = i % n_items
        t0, w0 = time.perf_counter(), time.time_ns()
        out = calls.program(items[k])
        t1, w1 = time.perf_counter(), time.time_ns()
        harness._sync(device)
        t2, w2 = time.perf_counter(), time.time_ns()
        marks.append((t0, t1, t2))
        walls.append((w0, w1, w2))
        if k in judged:
            latest[k] = out
    del out
    t_end, wall_end = marks[-1][2], walls[-1][2]
    events = devtrace.stop(prof)
    gc.unfreeze()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    c1 = counters()
    forbidden = harness.forbidden_modules()

    marks = np.asarray(marks)
    per_call = [(calls.in_bytes[j % n_items], calls.out_bytes[j % n_items])
                for j in range(n_calls)]
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak_bw = peaks.hbm_bytes_per_s(kind) if cuda else None

    # the check, after the window and its memory reading; the reference's
    # sum over the ranks is a collective, so every rank takes every item
    t_check = time.perf_counter()
    limits = cell.traffic["limits"]
    checks, failed = {}, 0
    for k in sorted(judged):
        want = calls.expected(items[k])
        if k not in latest:
            checks["missing_answer"] = math.inf
            failed += 1
            continue
        found = reference.compare(calls.answer(latest.pop(k)), want)
        failed += any(v > limits.get(n, 0) for n, v in found.items())
        for n, v in found.items():
            checks[n] = max(checks.get(n, 0.0), v)
    reading = {
        "kind": kind,
        "setup_s": t_start - t_process,
        "pace_s": pace,
        "n_calls": n_calls,
        "t_start": t_start,
        "t_end": t_end,
        "call_s": marks[:, 2] - marks[:, 0],
        "host_s": marks[:, 1] - marks[:, 0],
        "bytes_in": float(sum(r for r, _ in per_call)),
        "bound_s": None if peak_bw is None else sum(r + w for r, w in per_call) / peak_bw,
        "mem_window_bytes": int(window_peak),
        "memory_peak_bytes": max(int(setup_peak), int(window_peak)),
        "counters": {k: c1[k] - c0[k] for k in c0},
        "events": events,
        "walls": walls,
        "window_ns": (wall_start, wall_end),
        "checks": checks,
        "failed": failed,
        "check_s": time.perf_counter() - t_check,
        "phases": harness._phases(t_process, [*setup_marks, ("the card's context", t_data),
                                              ("data from the seed", t_warm),
                                              ("library load and warm-up calls", t_start)]),
        "forbidden": forbidden,
    }
    del data, calls, latest
    return reading


def clip(events, window_ns):
    """The device intervals ``events`` cut to the window ``(start, end)``:
    what ran before the window or after it is not the window's."""
    a, b = window_ns
    return [(n, max(s, a), min(e, b)) for n, s, e in events if min(e, b) > max(s, a)]


def _mean(values):
    values = list(values)
    return sum(values) / len(values)


def _mean_rows(lists, n, keep=10):
    """[name, seconds] rows of several ranks as the ranks' mean by name, the
    ``keep`` largest."""
    total = defaultdict(float)
    for rows in lists:
        for name, t in rows:
            total[name] += t
    return [[name, t / n] for name, t in sorted(total.items(), key=lambda kv: -kv[1])[:keep]]


def merge(readings, traced):
    """The ``harness.Run``, the extra figures and the notes of a seed from
    every rank's reading (rank order):

    - the window runs from the first rank's start to the last rank's end;
      the bytes are every rank's; a call's time is its slowest rank's (a
      collective call is done when every rank has it); the host part,
      set-up and phases are rank 0's;
    - memory is the fullest card's; program counters are the ranks' mean;
    - traced: each rank's device intervals are cut to its own window and
      reduced alone (``devtrace.reduce``: a union, never a sum), each has to
      read 0 < busy <= window, and busy, window, work, kernels, the top
      operations and the idle gaps are the ranks' means; the bytes bound is
      the ranks' mean, so a roofline is it over the ranks' mean work;
    - a check's number is its largest over the ranks."""
    r0, n = readings[0], len(readings)
    problems = []
    counts = [r["n_calls"] for r in readings]
    if len(set(counts)) > 1:
        problems.append(f"the ranks made {counts} calls, not one count")
    kinds = sorted({r["kind"] for r in readings})
    if len(kinds) > 1:
        problems.append(f"the ranks ran on different devices: {kinds}")
    m = min(counts)
    trace = None
    if traced:
        per = []
        for i, r in enumerate(readings):
            events = clip(r["events"], r["window_ns"])
            red = devtrace.reduce(events, r["walls"], r["window_ns"])
            red["window_s"] = (r["window_ns"][1] - r["window_ns"][0]) / 1e9
            red["events"] = events
            if not 0 < red["busy_s"] <= red["window_s"]:
                problems.append(f"rank {i}: busy_s {red['busy_s']!r} is not above 0 and at "
                                f"most its window_s {red['window_s']!r}")
            per.append(red)
        trace = {k: _mean(t[k] for t in per) for k in ("busy_s", "work_s", "kernels",
                                                       "window_s")}
        trace["ops"] = _mean_rows([t["ops"] for t in per], n)
        trace["gaps"] = _mean_rows([t["gaps"] for t in per], n)
        trace["rank_events"] = [t["events"] for t in per]
        trace["ranks"] = [{k: t[k] for k in ("busy_s", "window_s")} for t in per]
    bounds = [r["bound_s"] for r in readings]
    run = harness.Run(
        setup_s=r0["setup_s"],
        n_calls=m,
        window_s=max(r["t_end"] for r in readings) - min(r["t_start"] for r in readings),
        call_s=np.max([np.asarray(r["call_s"][:m]) for r in readings], axis=0),
        host_s=np.asarray(r0["host_s"][:m]),
        bytes_in=sum(r["bytes_in"] for r in readings),
        bound_s=None if None in bounds else _mean(bounds),
        mem_window_bytes=max(r["mem_window_bytes"] for r in readings),
        counters={k: _mean(r["counters"][k] for r in readings) for k in r0["counters"]},
        trace=trace,
    )
    checks = {}
    for r in readings:
        for name, v in r["checks"].items():
            checks[name] = max(checks.get(name, 0.0), v)
    extra = {
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in readings),
        "checks": checks,
        "failed": max(r["failed"] for r in readings),
        "check_s": max(r["check_s"] for r in readings),
        "phases": r0["phases"],
        "problems": problems,
    }
    notes = [f"{n} ranks, {m} calls each: --seconds at the slowest rank's warm-up pace, "
             f"{r0['pace_s'] * 1e3:.3f} ms a call; each rank's window "
             + ", ".join(f"{(r['t_end'] - r['t_start']):.3f}" for r in readings) + " s"]
    # where the tail comes from: which rank was slowest in the calls at or
    # past the p95, and each rank's host part
    tail = run.call_s >= np.percentile(run.call_s, 95)
    slowest = np.argmax([r["call_s"][:m] for r in readings], axis=0)[tail]
    notes.append(f"a call (its slowest rank's) median {np.median(run.call_s) * 1e3:.3f} ms, "
                 f"p95 {np.percentile(run.call_s, 95) * 1e3:.3f} ms; the calls at or past the "
                 f"p95 by slowest rank {np.bincount(slowest, minlength=n).tolist()}; each "
                 "rank's host part p95 " + ", ".join(
                     f"{np.percentile(r['host_s'][:m], 95) * 1e3:.3f}" for r in readings) + " ms")
    if trace is not None:
        notes.append("each rank's device busy / window: " + ", ".join(
            f"{t['busy_s']:.4f} / {t['window_s']:.4f} s" for t in trace["ranks"]))
    return run, extra, notes


def _result(cell, readings, trace, device):
    """Rank 0's (line, notes) of a seed from every rank's reading."""
    found = sorted({m for r in readings for m in r["forbidden"]})
    if found:
        raise procs.RankFailure(f"modules loaded that no run may load, on a rank: {found}")
    run, extra, rank_notes = merge(readings, trace)
    line, notes = harness._line(cell, run, extra, trace, device)
    return line, rank_notes + notes


def _run(cell, rank, world, port, seeds, seconds, trace, device_type, t_process, hook,
         marks, watchdog):
    """Every seed on this rank; rank 0 returns [(line, notes)] of each."""
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    watchdog.arm(procs.RENDEZVOUS_S, "the ranks' rendezvous")
    ctx = Context(rank, world, port, device)
    marks = [*marks, ("the ranks' rendezvous", time.perf_counter())]
    undo = None
    try:
        if device.type == "cuda":
            watchdog.arm(procs.BUILD_S, "rank 0's load or build of the kernel library")
            if rank == 0:
                importlib.import_module("xhistogram_torch.ops._build").load()
            ctx.barrier()
            marks.append(("rank 0's load or build of the kernel library", time.perf_counter()))
        if hook:
            module, fn = hook.split(":")
            undo = getattr(importlib.import_module(module), fn)(cell)
        results = []
        for seed in seeds:
            watchdog.arm(procs.SEED_S + seconds, f"seed {seed}'s run")
            readings = ctx.gather(_seed(cell, ctx, seed, seconds, trace, t_process, marks))
            if rank == 0:
                results.append(_result(cell, readings, trace, device))
            t_process, marks = time.perf_counter(), ()  # a further seed's set-up starts here
        return results
    finally:
        if undo is not None:
            undo()
        ctx.close()


def run_rank0(cell, seeds, seconds, trace, device_type, t_process, hook, here, marks,
              children=None):
    """Run ``cell`` on its ranks with this process as rank 0, starting the
    others unless ``children`` (``procs.Children``) already holds them;
    [(line, notes)] of each seed. Raises ``procs.RankFailure`` where a rank failed."""
    world = cell.chips
    if children is None:
        children = procs.Children(cell.name, world, seeds, seconds, trace, device_type, hook,
                                  here)
    watchdog = procs.Watchdog(0, children)
    try:
        results = _run(cell, 0, world, children.port, seeds, seconds, trace, device_type,
                       t_process, hook, marks, watchdog)
        watchdog.close()
        bad = children.join()
        if bad:
            raise procs.RankFailure(f"ranks that did not exit with 0 (rank, code): {bad}")
        return results
    finally:
        watchdog.close()
        children.stop()


def main(argv=None):
    """A rank other than 0, started by ``procs.Children``."""
    p = argparse.ArgumentParser(description="one rank of a cell on several cards")
    p.add_argument("--cell", required=True)
    p.add_argument("--here", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, required=True)
    p.add_argument("--device-type", required=True)
    p.add_argument("--hook", default="")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    watchdog = procs.Watchdog(args.rank)
    watchdog.arm(procs.RENDEZVOUS_S, "the rank's imports and the cell's files")
    code = 0
    try:
        cell = registry.Cell(args.cell, here=Path(args.here))
        _run(cell, args.rank, args.world, args.port, args.seeds, args.seconds,
             bool(args.trace), args.device_type, T_PROCESS, args.hook or None, (), watchdog)
        found = harness.forbidden_modules()
        if found:
            print(f"rank {args.rank}: modules loaded that no run may load: {found}",
                  file=sys.stderr)
            code = 3
    except BaseException:  # a failed rank exits non-zero; rank 0 sees it
        traceback.print_exc()
        code = 1
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    main()
