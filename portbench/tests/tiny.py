"""A copy of the benchmark's folder for rehearsals: the real call kinds,
metric readers, recipes, traffic and BENCHMARK.json, with the tiny
configurations of ``tests/configs``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def cells():
    """The names of BENCHMARK.json's cells."""
    return [w["name"] for w in json.loads((HERE.parent / "BENCHMARK.json").read_text())
            ["workloads"]]


def tree(tmp_path):
    """Build the copy under ``tmp_path``; returns its benchmark folder."""
    here = Path(tmp_path) / "portbench"
    here.mkdir(parents=True)
    for d in ("calls", "metrics", "recipes", "traffic"):
        (here / d).symlink_to(HERE / d)
    (here / "configs").symlink_to(HERE / "tests" / "configs")
    shutil.copy(HERE.parent / "BENCHMARK.json", Path(tmp_path) / "BENCHMARK.json")
    return here
