"""Cells, configurations, traffic, call kinds and metrics are found by
name from files, and a new one is new files only."""

import json
import shutil
from pathlib import Path

import pytest

from portbench import registry
from portbench.tests.tiny import tree

BENCH = registry.benchmark()


def test_every_cell_finds_its_parts():
    for w in BENCH["workloads"]:
        cell = registry.Cell(w["name"])
        assert cell.chips == w["chips"]
        assert cell.config["name"] == w["config"]
        assert callable(cell.kind.build) and callable(cell.recipe.make)
        for traced in (False, True):
            for m in cell.metrics(traced):
                assert callable(cell.reader(m["name"]).read)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "throughput_GBps"}


def test_every_file_named_in_the_benchmark_exists():
    root = registry.ROOT
    for c in BENCH["configs"]:
        config = json.loads((root / c["file"]).read_text())
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert (registry.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (registry.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_an_unknown_name_is_refused():
    with pytest.raises(LookupError):
        registry.Cell("no_such_cell")


def test_a_new_cell_kind_config_and_metric_are_new_files_only(tmp_path):
    """A later change adds a configuration, a traffic mix with its own call
    kind, a metric reader and their entries in BENCHMARK.json, and edits
    no existing file of the benchmark."""
    here = tmp_path / "portbench"
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    config = json.loads((here / "configs" / "ts_ecco_v4r4_05deg.json").read_text())
    config["name"] = "ts_ecco_new"
    (here / "configs" / "ts_ecco_new.json").write_text(json.dumps(config))
    (here / "traffic" / "levels_new.json").write_text(json.dumps(
        {"call": "new_kind", "inputs": ["T"], "bins": ["T_edges"], "limits": {}}))
    (here / "calls" / "new_kind.py").write_text(
        "def build(data, traffic, device):\n    return 'built'\n")
    (here / "metrics" / "new_metric.py").write_text("def read(run):\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "new_cell", "config": "ts_ecco_new",
                               "traffic": "levels_new", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "device",
                               "moves": "throughput_GBps", "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.Cell("new_cell", here=here)
    assert cell.kind.build(None, cell.traffic, None) == "built"
    assert cell.config["name"] == "ts_ecco_new"
    assert "new_metric" in [m["name"] for m in cell.per_layer]
    assert cell.reader("new_metric").read(None) == 1.0
    assert {p: p.read_bytes() for p in before} == before  # nothing edited
    assert "new_metric" not in [m["name"] for m in registry.Cell("ts_ecco_levels_vol",
                                                                 here=here).per_layer]


def test_the_tiny_tree_mirrors_the_benchmark(tmp_path):
    here = tree(tmp_path)
    for w in BENCH["workloads"]:
        cell = registry.Cell(w["name"], here=here)
        assert set(cell.config) >= set(registry.Cell(w["name"]).config) - {"assumed"}
    assert Path(here / "configs").resolve() == (registry.HERE / "tests" / "configs")
