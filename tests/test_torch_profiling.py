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
