"""The reader of the weighted flat-slot placement counter,
``exact_sum_pct``, on a program with the counter and on one without."""

import importlib
import math
import sys
import types

import numpy as np

from portbench import harness, registry

CELL = "ts_ecco_levels_vol"


def _run(counters, n_calls=4):
    return harness.Run(setup_s=1.0, n_calls=n_calls, window_s=1.0,
                       call_s=np.full(n_calls, 0.25), host_s=np.full(n_calls, 0.01),
                       bytes_in=1e9, bound_s=None, mem_window_bytes=0,
                       counters=counters, trace=None)


def test_the_share_reads_the_placement_counter():
    reader = registry.Cell(CELL).reader("exact_sum_pct")
    assert set(reader.COUNTERS) == {"EXACT", "WEIGHTED"}
    assert reader.read(_run({"EXACT": 4, "WEIGHTED": 4})) == 100.0
    assert reader.read(_run({"EXACT": 1, "WEIGHTED": 4})) == 25.0
    assert reader.read(_run({"EXACT": 0, "WEIGHTED": 0})) == 0.0


def test_the_counter_moves_with_the_program_s_launches():
    from xhistogram_torch.utils import profiling

    reader = registry.Cell(CELL).reader("exact_sum_pct")
    snap = harness._counter_reader([reader])
    before = snap()
    for where in ("exact", "exact", "exact", "device", "shared"):
        profiling.note_weighted_slot(where)
    moved = {k: v - before[k] for k, v in snap().items()}
    assert moved == {"EXACT": 3, "WEIGHTED": 5}
    assert reader.read(_run(moved)) == 60.0


def test_a_program_without_the_counter_reads_zero(monkeypatch):
    """A checkout older than ``WEIGHTED_SLOTS``: its profiling module counts
    calls and no placement."""
    older = types.ModuleType("older_profiling")
    older.CALLS = 10
    monkeypatch.setitem(sys.modules, "older_profiling", older)
    module = importlib.import_module("portbench.metrics.exact_sum_pct")
    monkeypatch.setattr(module, "_PROFILING", "older_profiling")
    reader = registry.Cell(CELL).reader("exact_sum_pct")
    snap = harness._counter_reader([reader])
    before = snap()
    older.CALLS += 3
    moved = {k: v - before[k] for k, v in snap().items()}
    assert moved == {"EXACT": 0, "WEIGHTED": 0}
    got = reader.read(_run(moved, n_calls=3))
    assert math.isfinite(got) and got == 0.0


def test_only_the_ecco_cell_reports_the_share():
    for w in registry.benchmark()["workloads"]:
        cell = registry.Cell(w["name"])
        names = {m["name"] for m in cell.metrics(True)}
        assert ("exact_sum_pct" in names) == (w["name"] == CELL), w["name"]
        assert "exact_sum_pct" not in {m["name"] for m in cell.metrics(False)}
