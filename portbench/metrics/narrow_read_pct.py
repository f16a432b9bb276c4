"""Inputs of a 1- or 2-byte stored type that the card read at their own
width, in %: 100 x the window's change of the program's
``utils.profiling.NARROW_READS["in_place"]`` over the change of both its
entries (each such input of every kernel launch and plain digitize, read in
place or widened in device memory first). A program without the counter, a
checkout older than it, reads 0, as ``exact_sum_pct`` does: it counts no
read, and the traced line keeps a finite number."""

from __future__ import annotations

import importlib

_PROFILING = "xhistogram_torch.utils.profiling"

COUNTERS = {"IN_PLACE": f"{__name__}:IN_PLACE", "NARROW": f"{__name__}:NARROW"}


def __getattr__(name):
    if name in ("IN_PLACE", "NARROW"):
        reads = getattr(importlib.import_module(_PROFILING), "NARROW_READS", {})
        return reads.get("in_place", 0) if name == "IN_PLACE" else sum(reads.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def read(run):
    narrow = run.counters["NARROW"]
    return 100.0 * run.counters["IN_PLACE"] / narrow if narrow else 0.0
