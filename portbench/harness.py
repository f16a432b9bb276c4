"""One run of a cell: set-up, the measured window, the traced reading, the
check against the reference, and the result line.

Every call of the window is one public call of ``xhistogram_torch``, ended
by a synchronise of the card: a closed loop with one caller, as an analysis
script loops over its data. A traffic mix that names ``in_flight`` keeps that
many calls on the card ahead of the one it waits for, as a script does that
reads no answer before it sends the next call: the card is then never left
waiting on the host. Its window closes when its time is up: nothing more is
sent, every call sent is waited for, and the clock is read after that wait.
"""

from __future__ import annotations

import collections
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench import devtrace, peaks, reference, registry
from portbench.check_line import check as check_line

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "xhistogram_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``)."""

    setup_s: float
    n_calls: int
    window_s: float  # host clock
    call_s: np.ndarray  # each call's wall time, entry to synchronised (in flight: to
    # the wait for the call ``in_flight`` before it)
    host_s: np.ndarray  # each call's entry to return, before the synchronise
    bytes_in: float  # input bytes of all calls
    bound_s: float | None  # the calls' bytes bound at the card's bandwidth
    mem_window_bytes: int  # allocated peak in the window
    counters: dict  # program counters' change over the window
    trace: dict | None  # devtrace.reduce


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(device):
    """An event on the device's stream after what was sent so far, or None."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _counter_reader(readers):
    spec = {}
    for r in readers:
        spec.update(getattr(r, "COUNTERS", {}))

    def snap():
        out = {}
        for key, where in spec.items():
            module, attr = where.split(":")
            v = getattr(importlib.import_module(module), attr)
            out[key] = sum(v.values()) if isinstance(v, dict) else v
        return out

    return snap


def _one_seed(cell, device, seed, seconds, trace, t_process, setup_marks=()):
    """Set-up, window and check of one seed: the ``Run`` and what the line
    needs besides. ``setup_marks`` are (what ended, host clock) of the process's
    set-up before the harness, after ``t_process``."""
    cuda = device.type == "cuda"
    if cuda:
        torch.zeros((), device=device)  # the card's context
        torch.cuda.reset_peak_memory_stats(device)
    t_data = time.perf_counter()
    fields = list(cell.traffic["inputs"])
    if cell.traffic.get("weights"):
        fields.append(cell.traffic["weights"])
    data = cell.recipe.make(cell.config, seed, device, fields)
    _sync(device)
    t_warm = time.perf_counter()
    calls = cell.kind.build(data, cell.traffic, device)
    items = calls.items
    for item in [*items, items[0], items[0]]:  # every shape, then steady
        calls.program(item)
    _sync(device)

    readers = [cell.reader(m["name"]) for m in cell.metrics(trace)]
    counters = _counter_reader(readers)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    judged = set(calls.judged)
    latest = {}
    c0 = counters()
    gc.collect()
    gc.freeze()
    prof = devtrace.start(device) if trace else None
    marks, walls = [], []
    n_items, i = len(items), 0
    in_flight = int(cell.traffic.get("in_flight", 0))
    sent = collections.deque()
    t_start, wall_start = time.perf_counter(), time.time_ns()
    while True:
        k = i % n_items
        t0, w0 = time.perf_counter(), time.time_ns()
        out = calls.program(items[k])
        t1, w1 = time.perf_counter(), time.time_ns()
        if in_flight:
            sent.append(_mark(device))
            if len(sent) > in_flight and (event := sent.popleft()) is not None:
                event.synchronize()
        else:
            _sync(device)
        t2, w2 = time.perf_counter(), time.time_ns()
        marks.append((t0, t1, t2))
        walls.append((w0, w1, w2))
        if k in judged:
            latest[k] = out
        i += 1
        if t2 - t_start >= seconds:
            break
    del out
    if in_flight:  # every call sent counts, over the time to its end
        _sync(device)
        t_end, wall_end = time.perf_counter(), time.time_ns()
    else:
        t_end, wall_end = marks[-1][2], walls[-1][2]
    events = devtrace.stop(prof)
    gc.unfreeze()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    c1 = counters()

    marks = np.asarray(marks)
    per_call = [(calls.in_bytes[j % n_items], calls.out_bytes[j % n_items]) for j in range(i)]
    peak_bw = peaks.hbm_bytes_per_s(torch.cuda.get_device_name(device)) if cuda else None
    run = Run(
        setup_s=t_start - t_process,
        n_calls=i,
        window_s=t_end - t_start,
        call_s=marks[:, 2] - marks[:, 0],
        host_s=marks[:, 1] - marks[:, 0],
        bytes_in=float(sum(r for r, _ in per_call)),
        bound_s=None if peak_bw is None else sum(r + w for r, w in per_call) / peak_bw,
        mem_window_bytes=int(window_peak),
        counters={k: c1[k] - c0[k] for k in c0},
        trace=devtrace.reduce(events, walls, (wall_start, wall_end)) if trace else None,
    )
    if trace:
        run.trace["window_s"] = run.window_s

    # the check, after the window and its memory reading, in blocks
    t_check = time.perf_counter()
    limits = cell.traffic["limits"]
    checks, failed = {}, 0
    for k in sorted(judged):
        if k not in latest:
            checks["missing_answer"] = math.inf
            failed += 1
            continue
        found = reference.compare(calls.answer(latest.pop(k)), calls.expected(items[k]))
        failed += any(v > limits.get(n, 0) for n, v in found.items())
        for n, v in found.items():
            checks[n] = max(checks.get(n, 0.0), v)
    extra = {
        "memory_peak_bytes": max(int(setup_peak), int(window_peak)),
        "checks": checks,
        "failed": failed,
        "check_s": time.perf_counter() - t_check,
        "phases": _phases(t_process, [*setup_marks, ("the card's context", t_data),
                                      ("data from the seed", t_warm),
                                      ("library load and warm-up calls", t_start)]),
    }
    del data, calls, latest
    return run, extra


def _phases(t_process, marks):
    """{what: seconds} of set-up, from each mark's time to the last's."""
    out, last = {}, t_process
    for what, t in marks:
        out[what] = t - last
        last = t
    return out


def _printable(v):
    return 1e300 if v == math.inf else v


def _power_limit(index):
    """The card's power limit as nvidia-smi reads it, or "not read"."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip() or "not read"


def _line(cell, run, extra, trace, device):
    """The result line and the lines for standard error, checked."""
    wait = run.call_s - run.host_s
    ahead = cell.traffic.get("in_flight", 0)
    notes = [f"window {run.window_s:.3f} s, {run.n_calls} calls"
             + (f", {ahead} in flight ahead of the one waited for" if ahead else "")
             + f"; a call's host part "
             f"{run.host_s.mean() * 1e6:.1f} us (median {np.median(run.host_s) * 1e6:.1f}), "
             f"its wait for the card {wait.mean() * 1e6:.1f} us (median "
             f"{np.median(wait) * 1e6:.1f}); the check against the reference "
             f"{extra['check_s']:.2f} s",
             f"set-up {run.setup_s:.3f} s: " + ", ".join(
                 f"{k} {v:.3f} s" for k, v in extra["phases"].items())]
    metrics = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    cuda = device.type == "cuda"
    if cuda:
        notes.append(f"card {torch.cuda.get_device_name(device)}, power limit "
                     f"{_power_limit(device.index)}; rooflines against peaks.py's bandwidth")
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(extra["memory_peak_bytes"]),
    }
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
    limits = cell.traffic["limits"]
    checks = {n: {"value": _printable(extra["checks"].get(n, math.inf)), "limit": lim}
              for n, lim in limits.items()}
    for n, v in extra["checks"].items():
        if n not in limits:
            checks[n] = {"value": _printable(v), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": run.n_calls, "failed": extra["failed"],
            "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace["ops"], "idle_gaps": run.trace["gaps"]}
    line["checks"] = checks
    problems = check_line(line, [m["name"] for m in cell.metrics(trace)], trace,
                          platform=dev["platform"], count=cell.chips)
    problems += extra.get("problems", [])  # a cell on several cards: each rank's own
    if problems:
        line["correct"] = False
        notes += [f"result line unsound: {p}" for p in problems]
        if trace and not (0 < dev.get("busy_s", 0) <= dev.get("window_s", 0)):
            # keep the line well formed; correct is false and the reason above
            dev["busy_s"] = dev.get("window_s") or 1e-9
            dev["window_s"] = dev["busy_s"]
    notes += [f"check {n} {c['value']!r} limit {c['limit']!r}" for n, c in checks.items()]
    return line, notes


def run_cell(cell_name, seeds, seconds, trace, device_type="cuda", t_process=None,
             hook=None, here=registry.HERE, marks=(), children=None):
    """Run a cell on ``seeds`` in turn, in this process; [(line, notes)] of
    each. ``hook`` ("module:function") is called with the cell before the
    runs, and what it returns after them: the control (``control.py``) and
    the tests' planted faults take the program's place with it. ``here`` is
    the benchmark's folder (tests give a copy with tiny configurations),
    beside its ``BENCHMARK.json``; ``marks`` time the process's set-up
    before it (``_one_seed``).

    A cell on several cards runs one process a card, this one rank 0
    (``ranks.run_rank0``; ``children``, ``procs.Children``, where run.py
    started the others already), and every rank takes the hook."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell = registry.Cell(cell_name, here=here)
    if cell.chips > 1 or getattr(cell.kind, "RANKS", False):
        from portbench import ranks

        return ranks.run_rank0(cell, seeds, seconds, trace, device_type, t_process, hook,
                               here, marks, children)
    device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    undo = None
    results = []
    try:
        if hook:
            module, fn = hook.split(":")
            undo = getattr(importlib.import_module(module), fn)(cell)
        for seed in seeds:
            run, extra = _one_seed(cell, device, seed, seconds, trace, t_process, marks)
            results.append(_line(cell, run, extra, trace, device))
            t_process, marks = time.perf_counter(), ()  # a further seed's set-up starts here
    finally:
        if undo is not None:
            undo()
    return results


def emit(line, notes):
    """Print the notes as the last lines of standard error, then the line as
    the last line of standard output."""
    for note in notes:
        print(note, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
