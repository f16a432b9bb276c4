"""Weighted flat-slot launches that kept their float sums as exact integers
in shared memory, in %: 100 x the window's change of the program's
``utils.profiling.WEIGHTED_SLOTS["exact"]`` over the change of all its
entries (every weighted launch of ``csrc/slot.cuh``, wherever its sums
went). A program without the counter, a checkout older than it, reads 0, as
``kernel_route_pct`` does: it keeps no exact sums, and the traced line keeps
a finite number."""

from __future__ import annotations

import importlib

_PROFILING = "xhistogram_torch.utils.profiling"

COUNTERS = {"EXACT": f"{__name__}:EXACT", "WEIGHTED": f"{__name__}:WEIGHTED"}


def __getattr__(name):
    if name in ("EXACT", "WEIGHTED"):
        slots = getattr(importlib.import_module(_PROFILING), "WEIGHTED_SLOTS", {})
        return slots.get("exact", 0) if name == "EXACT" else sum(slots.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def read(run):
    weighted = run.counters["WEIGHTED"]
    return 100.0 * run.counters["EXACT"] / weighted if weighted else 0.0
