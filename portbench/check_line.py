"""Check a result line of ``run.py`` before it is printed, or a saved one.

    python portbench/check_line.py --workload NAME --trace 0|1 [FILE]

reads the last line of FILE (default: standard input), checks it against
the cell's metrics in ``BENCHMARK.json`` and prints each problem found;
exits 1 if there is one.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _number(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool) and math.isfinite(x)


def check(line, metric_names, traced, platform="gpu", count=None):
    """The problems of result ``line`` (a dict): the keys, each expected
    metric with a finite value and a unit, the device, and in a traced run
    0 < ``busy_s`` <= ``window_s``. An empty list means the line is sound."""
    problems = [f"key {k!r} is missing" for k in KEYS if k not in line]
    if problems:
        return problems
    if not isinstance(line["correct"], bool):
        problems.append("correct is not true or false")
    for k in ("attempted", "failed"):
        if not (isinstance(line[k], int) and not isinstance(line[k], bool) and line[k] >= 0):
            problems.append(f"{k} is not a count")
    metrics = line["metrics"]
    if not isinstance(metrics, dict):
        return problems + ["metrics is not an object"]
    for name in metric_names:
        m = metrics.get(name)
        if not isinstance(m, dict):
            problems.append(f"metric {name} is missing")
        elif not _number(m.get("value")):
            problems.append(f"metric {name} has no finite value")
        elif not (isinstance(m.get("unit"), str) and m["unit"]):
            problems.append(f"metric {name} has no unit")
        elif name.endswith("_roofline") and m["value"] > 105:
            problems.append(f"metric {name} reads {m['value']}% of its roofline, over 105%")
    extra = set(metrics) - set(metric_names)
    if extra:
        problems.append(f"metrics not of this cell and run: {sorted(extra)}")
    device = line["device"]
    if not isinstance(device, dict):
        return problems + ["device is not an object"]
    if device.get("platform") != platform:
        problems.append(f"device.platform is {device.get('platform')!r}, not {platform!r}")
    if not (isinstance(device.get("kind"), str) and device["kind"]):
        problems.append("device.kind is not a name")
    if not (isinstance(device.get("count"), int) and device["count"] >= 1
            and (count is None or device["count"] == count)):
        problems.append(f"device.count is {device.get('count')!r}, not {count}")
    if not (isinstance(device.get("memory_peak_bytes"), int) and device["memory_peak_bytes"] > 0):
        problems.append("device.memory_peak_bytes is not a count above 0")
    if traced:
        busy, window = device.get("busy_s"), device.get("window_s")
        if not (_number(busy) and _number(window) and 0 < busy <= window):
            problems.append(f"device.busy_s {busy!r} is not above 0 and at most "
                            f"device.window_s {window!r}")
        for part, rows in (line.get("breakdown") or {}).items():
            if not (isinstance(rows, list) and len(rows) <= 10 and all(
                    isinstance(r, list) and len(r) == 2 and isinstance(r[0], str)
                    and _number(r[1]) for r in rows)):
                problems.append(f"breakdown.{part} is not at most 10 [name, seconds] pairs")
    for name, c in (line.get("checks") or {}).items():
        if not (isinstance(c, dict) and _number(c.get("value")) and _number(c.get("limit"))):
            problems.append(f"check {name} has no number and limit")
    return problems


def main(argv=None):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.registry import Cell

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    p.add_argument("file", nargs="?")
    args = p.parse_args(argv)
    text = Path(args.file).read_text() if args.file else sys.stdin.read()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        print("no line to check")
        return 1
    try:
        line = json.loads(lines[-1])
    except json.JSONDecodeError as e:
        print(f"the last line is not JSON: {e}")
        return 1
    cell = Cell(args.workload)
    names = [m["name"] for m in cell.metrics(bool(args.trace))]
    problems = check(line, names, bool(args.trace), count=cell.chips)
    for problem in problems:
        print(problem)
    print("line sound" if not problems else f"{len(problems)} problems")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
