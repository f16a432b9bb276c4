"""``utils/profiling``: the trace of the pipeline's steps on the CPU.

Counterpart of the JAX package's ``utils.profiling.trace``, which captures a
JAX profiler trace: here ``torch.profiler`` writes a Chrome/Perfetto trace
that holds the ``xhistogram.*`` ranges of the call it wraps, a labeled
call's around the core call it makes.
"""

import json

import numpy as np
import pytest
import torch

import xhistogram_torch
from xhistogram_torch import labeled
from xhistogram_torch.utils import profiling


@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "weighted"])
def test_trace_holds_the_stage_ranges(tmp_path, weighted):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 100)).astype(np.float32)
    w = rng.random((4, 100)).astype(np.float32) if weighted else None
    log_dir = tmp_path / "log"
    with profiling.trace(log_dir):
        h, _ = xhistogram_torch.histogram(x, bins=[np.linspace(-3, 3, 11)], axis=1,
                                          weights=w, device="cpu")
    assert h.shape == (4, 10)
    path = log_dir / profiling.TRACE_FILE
    assert path.exists()
    names = {ev.get("name") for ev in json.loads(path.read_text())["traceEvents"]}
    assert {"xhistogram.call", "xhistogram.edges", "xhistogram.canonicalize",
            "xhistogram.plan", "xhistogram.digitize", "xhistogram.bincount",
            "xhistogram.finish"} <= names


def test_trace_holds_the_labeled_call_around_the_core_call(tmp_path):
    data = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32))
    named = labeled.NamedArray(data, ("time", "cell"), name="sst")
    with profiling.trace(tmp_path):
        labeled.histogram(named, bins=[np.linspace(-3, 3, 7)], dim=("time",), device="cpu")
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    spans = {ev["name"]: ev for ev in events if ev.get("ph") == "X"
             and ev.get("name") in ("xhistogram.labeled", "xhistogram.call")}
    outer, inner = spans["xhistogram.labeled"], spans["xhistogram.call"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["args"]["call"] == inner["args"]["call"] == profiling.CALLS  # one call


def test_trace_replaces_an_earlier_trace(tmp_path):
    x = np.arange(10.0, dtype=np.float32)
    with profiling.trace(tmp_path):
        xhistogram_torch.histogram(x, bins=[np.linspace(0, 10, 3)], device="cpu")
    first = (tmp_path / profiling.TRACE_FILE).read_text()
    with profiling.trace(tmp_path):
        pass
    second = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    assert first != json.dumps(second)
    assert "xhistogram.digitize" not in {ev.get("name") for ev in second["traceEvents"]}


@pytest.mark.parametrize("counter,note", [
    ("WEIGHTED_SLOTS", "note_weighted_slot"),
    ("ONE_INPUT_OUTPUTS", "note_one_input_output"),
    ("SLOT_LOADS", "note_slot_loads"),
    ("NARROW_READS", "note_narrow_read"),
])
def test_each_launch_counter_is_exported_with_its_note(counter, note):
    assert counter in profiling.__all__ and note in profiling.__all__
    assert isinstance(getattr(profiling, counter), dict) and callable(getattr(profiling, note))
    assert all(isinstance(n, int) and n >= 0 for n in getattr(profiling, counter).values())


@pytest.mark.parametrize("how", ["vector", "scalar"])
def test_the_slot_load_counter_counts_one_launch_once(how):
    # "vector": a flat-slot launch's run pieces read groups of four
    # neighbours by one load; "scalar": element by element
    assert set(profiling.SLOT_LOADS) == {"vector", "scalar"}
    before = dict(profiling.SLOT_LOADS)
    profiling.note_slot_loads(how)
    after = profiling.SLOT_LOADS
    assert {k: after[k] - before[k] for k in after} == {k: int(k == how) for k in before}
    with pytest.raises(KeyError):
        profiling.note_slot_loads("packed")
    assert profiling.SLOT_LOADS == after


@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "weighted"])
def test_a_cpu_census_by_level_notes_no_slot_launch(weighted):
    # the README call on CPU tensors runs the plain path: no flat-slot launch
    rng = np.random.default_rng(2)
    t, s = (torch.from_numpy(rng.normal(size=(3, 4, 40)).astype(np.float32))
            for _ in range(2))
    w = torch.from_numpy(rng.random((4, 40)).astype(np.float32)) if weighted else None
    before = dict(profiling.SLOT_LOADS)
    h, _ = xhistogram_torch.histogram(t, s, bins=[np.linspace(-3, 3, 9)] * 2, axis=(0, 2),
                                      weights=w)
    assert h.shape == (4, 8, 8)
    assert profiling.SLOT_LOADS == before
