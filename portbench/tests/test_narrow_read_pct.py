"""The reader of the narrow-read counter, ``narrow_read_pct``: on the
counter as an int16 call moves it, on a program without the counter, and,
on a card, in the packed cell's traced line."""

import importlib
import math
import sys
import types

import numpy as np
import pytest

from portbench import harness, registry
from portbench.tests.tiny import tree

CELL = "ts_glorys12_levels_int16"


def _run(counters, n_calls=4):
    return harness.Run(setup_s=1.0, n_calls=n_calls, window_s=1.0,
                       call_s=np.full(n_calls, 0.25), host_s=np.full(n_calls, 0.01),
                       bytes_in=1e9, bound_s=None, mem_window_bytes=0,
                       counters=counters, trace=None)


def test_the_share_reads_the_counter():
    reader = registry.Cell(CELL).reader("narrow_read_pct")
    assert set(reader.COUNTERS) == {"IN_PLACE", "NARROW"}
    assert reader.read(_run({"IN_PLACE": 8, "NARROW": 8})) == 100.0
    assert reader.read(_run({"IN_PLACE": 2, "NARROW": 8})) == 25.0
    assert reader.read(_run({"IN_PLACE": 0, "NARROW": 0})) == 0.0


def test_an_int16_launch_reads_100_and_a_widened_read_less():
    """Each launch of the packed call notes its two int16 inputs in place
    (``ops.cuda_hist._note_in_place``, as after every launch on a card);
    a plain digitize that widens one first notes it widened."""
    import torch

    from xhistogram_torch.ops import cuda_hist
    from xhistogram_torch.utils import profiling

    reader = registry.Cell(CELL).reader("narrow_read_pct")
    snap = harness._counter_reader([reader])
    t = torch.zeros((2, 3, 4), dtype=torch.int16)
    before = snap()
    for _ in range(3):
        cuda_hist._note_in_place([t, t])
    moved = {k: v - before[k] for k, v in snap().items()}
    assert moved == {"IN_PLACE": 6, "NARROW": 6}
    assert reader.read(_run(moved, n_calls=3)) == 100.0
    profiling.note_narrow_read("widened", 2)
    moved = {k: v - before[k] for k, v in snap().items()}
    assert reader.read(_run(moved, n_calls=4)) == 75.0


def test_a_program_without_the_counter_reads_zero(monkeypatch):
    """A checkout older than ``NARROW_READS``: its profiling module counts
    calls and no narrow read."""
    older = types.ModuleType("older_profiling")
    older.CALLS = 10
    monkeypatch.setitem(sys.modules, "older_profiling", older)
    module = importlib.import_module("portbench.metrics.narrow_read_pct")
    monkeypatch.setattr(module, "_PROFILING", "older_profiling")
    reader = registry.Cell(CELL).reader("narrow_read_pct")
    snap = harness._counter_reader([reader])
    before = snap()
    older.CALLS += 3
    moved = {k: v - before[k] for k, v in snap().items()}
    assert moved == {"IN_PLACE": 0, "NARROW": 0}
    got = reader.read(_run(moved, n_calls=3))
    assert math.isfinite(got) and got == 0.0


def test_only_the_packed_cell_reports_the_share():
    for w in registry.benchmark()["workloads"]:
        cell = registry.Cell(w["name"])
        names = {m["name"] for m in cell.metrics(True)}
        assert ("narrow_read_pct" in names) == (w["name"] == CELL), w["name"]
        assert "narrow_read_pct" not in {m["name"] for m in cell.metrics(False)}


def test_the_cpu_rehearsal_reads_no_card_read(tmp_path):
    """On the CPU the program launches no kernel and digitizes on no card:
    the traced line reads 0, a finite number."""
    [(line, _)] = harness.run_cell(CELL, [2**31 + 21], 0.2, True, "cpu", here=tree(tmp_path))
    assert line["metrics"]["narrow_read_pct"]["value"] == 0.0


@pytest.mark.gpu
def test_the_packed_cell_reads_its_inputs_in_place_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    [(line, notes)] = harness.run_cell(CELL, [2**31 + 23], 0.5, True, "cuda",
                                       here=tree(tmp_path))
    assert line["correct"] is True, notes
    assert line["metrics"]["narrow_read_pct"]["value"] == 100.0
    assert line["metrics"]["layout_copies_per_call"]["value"] == 0.0
    assert line["metrics"]["host_syncs_per_call"]["value"] == 0.0
