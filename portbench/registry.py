"""Find a cell's parts by name.

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of the
checkout. It names a configuration (``configs/<config>.json``, whose
``recipe`` names the data generator ``recipes/<recipe>.py``) and a traffic
mix (``traffic/<traffic>.json``, whose ``call`` names the call kind
``calls/<call>.py``). Each metric of ``BENCHMARK.json`` is read by
``metrics/<name>.py``. A new cell, configuration, traffic mix, call kind or
metric is therefore new files and a new entry in ``BENCHMARK.json``; no
existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind, name, here=HERE):
    with open(Path(here) / kind / f"{name}.json") as f:
        return json.load(f)


def _module(kind, name, here=HERE):
    path = Path(here) / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_applies(metric, cell, e2e_names):
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list
    names, else every cell that reports the end-to-end metric it moves (an
    end-to-end metric without ``workloads``: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    call kind, data recipe and metric readers."""

    def __init__(self, name, here=HERE):
        bench = benchmark(Path(here).parent)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise LookupError(f"no workload named {name!r} in BENCHMARK.json")
        entry = entries[name]
        self.name = name
        self.chips = int(entry["chips"])
        self.config = _json("configs", entry["config"], here)
        self.traffic = _json("traffic", entry["traffic"], here)
        self.recipe = _module("recipes", self.config["recipe"], here)
        self.kind = _module("calls", self.traffic["call"], here)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if metric_applies(m, name, ())]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if metric_applies(m, name, e2e)]
        self._here = here

    def metrics(self, traced):
        return self.per_layer if traced else self.end_to_end

    def reader(self, metric_name):
        return _module("metrics", metric_name, self._here)
