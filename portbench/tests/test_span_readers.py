"""The readers of the program's spans and host counters: each reads its
counters' change over the window per call, reads a finite number where the
program has no such span or counter, and applies to the cells it should."""

import math

import numpy as np
import pytest

from portbench import harness, registry
from portbench.metrics import _program

CELL = registry.Cell("sst_025deg_year")


def _run(counters, n_calls=4):
    return harness.Run(setup_s=1.0, n_calls=n_calls, window_s=1.0,
                       call_s=np.full(n_calls, 0.25), host_s=np.full(n_calls, 0.01),
                       bytes_in=1e9, bound_s=None, mem_window_bytes=0,
                       counters=counters, trace=None)


SPANS = {"call": 400_000, "edges": 80_000, "labeled": 120_000, "canonicalize": 40_000,
         "plan": 4_000, "autograd": 16_000, "cuda_kernel": 0, "digitize": 2_000_000,
         "bincount": 6_000_000, "finish": 100_000}
COUNTS = {"HOST_SYNCS": 8, "THRESHOLD_HITS": 4, "THRESHOLD_LOOKUPS": 4}
COUNTERS = {**{f"span_{k}": v for k, v in SPANS.items()}, **COUNTS}
EXPECTED = {  # with 4 calls
    "call_self_us": 100.0, "edges_host_us": 20.0, "labeled_host_us": 30.0,
    "layout_host_us": 10.0, "dispatch_host_us": (4 + 16 + 0 + 2000 + 6000 + 100) / 4,
    "host_syncs_per_call": 2.0, "threshold_cache_hit_pct": 100.0,
}


@pytest.mark.parametrize("name", list(EXPECTED))
def test_each_reader_reads_its_counters_per_call(name):
    reader = CELL.reader(name)
    assert set(reader.COUNTERS) <= set(COUNTERS)
    got = reader.read(_run({k: COUNTERS[k] for k in reader.COUNTERS}))
    assert got == pytest.approx(EXPECTED[name])


def test_the_hit_share_is_a_share_and_finite_without_lookups():
    reader = CELL.reader("threshold_cache_hit_pct")
    assert reader.read(_run({"THRESHOLD_HITS": 3, "THRESHOLD_LOOKUPS": 4})) == 75.0
    assert reader.read(_run({"THRESHOLD_HITS": 0, "THRESHOLD_LOOKUPS": 0})) == 100.0


@pytest.mark.parametrize("name", list(EXPECTED))
def test_a_program_without_the_counters_reads_a_finite_number(name, monkeypatch):
    from xhistogram_torch import core
    from xhistogram_torch.utils import profiling

    monkeypatch.delattr(profiling, "SELF_NS")
    for module, attr in ((profiling, "HOST_SYNCS"), (core, "THRESHOLD_LOOKUPS"),
                         (core, "THRESHOLD_HITS")):
        monkeypatch.delattr(module, attr)
    reader = CELL.reader(name)
    snap = harness._counter_reader([reader])
    got = reader.read(_run({k: snap()[k] - v for k, v in snap().items()}))
    assert math.isfinite(got)
    assert got == (100.0 if name == "threshold_cache_hit_pct" else 0.0)


def test_the_counters_read_the_program_or_zero_without_it(monkeypatch):
    from xhistogram_torch import core
    from xhistogram_torch.utils import profiling

    monkeypatch.setitem(profiling.SELF_NS, "edges", 1234)
    monkeypatch.delitem(profiling.SELF_NS, "t_never_run", raising=False)
    assert _program.span_edges == 1234
    assert _program.span_t_never_run == 0
    assert _program.THRESHOLD_HITS == core.THRESHOLD_HITS
    assert _program.HOST_SYNCS == profiling.HOST_SYNCS
    monkeypatch.delattr(profiling, "SELF_NS")
    monkeypatch.delattr(core, "THRESHOLD_HITS")
    assert _program.span_edges == 0
    assert _program.THRESHOLD_HITS == 0
    with pytest.raises(AttributeError):
        _program.no_such_counter


def test_the_harness_snapshot_reads_every_new_counter():
    readers = [CELL.reader(name) for name in EXPECTED]
    snap = harness._counter_reader(readers)()
    assert set(snap) == {k for r in readers for k in r.COUNTERS}
    assert all(isinstance(v, int) for v in snap.values())


def test_only_the_labeled_cell_reports_the_labeled_layer():
    names = {m["name"] for m in registry.Cell("ts_ecco_levels_vol").metrics(True)}
    assert "labeled_host_us" not in names
    assert set(EXPECTED) - {"labeled_host_us"} <= names
    assert set(EXPECTED) <= {m["name"] for m in CELL.metrics(True)}
    assert not set(EXPECTED) & {m["name"] for m in CELL.metrics(False)}


@pytest.mark.parametrize("cell", ["ts_ecco_levels_vol", "sst_025deg_year"])
def test_a_traced_line_is_whole_on_a_program_without_spans(cell, monkeypatch, tmp_path):
    from portbench.tests.test_rehearsal import DEVICE_ONLY
    from portbench.tests.tiny import tree

    monkeypatch.setattr(_program, "_PROFILING", "math")
    monkeypatch.setattr(_program, "_COUNTS", dict.fromkeys(_program._COUNTS, "math"))
    [(line, notes)] = harness.run_cell(cell, [3_000_000_007], 0.2, True, "cpu",
                                       here=tree(tmp_path))
    unsound = [n for n in notes if n.startswith("result line unsound")]
    assert [n for n in unsound if not any(d in n for d in DEVICE_ONLY)] == []
    names = set(EXPECTED) & {m["name"] for m in registry.Cell(cell).metrics(True)}
    assert {n: line["metrics"][n]["value"] for n in names} == {
        n: 100.0 if n == "threshold_cache_hit_pct" else 0.0 for n in names}
