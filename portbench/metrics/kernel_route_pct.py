"""Calls that ran a kernel, in %: 100 x the window's change of the
program's ``utils.profiling.ROUTES`` entries other than ``"scatter"`` (the
plain path) over the change of ``profiling.CALLS`` (public calls). A
program without the counter, a checkout older than it, reads 0, as
``_program.py``'s readers do: it counts no route, and the traced line keeps
a finite number."""

from __future__ import annotations

import importlib

_PROFILING = "xhistogram_torch.utils.profiling"

COUNTERS = {"ROUTED": f"{__name__}:ROUTED", "CALLS": f"{__name__}:CALLS"}


def __getattr__(name):
    if name == "ROUTED":
        routes = getattr(importlib.import_module(_PROFILING), "ROUTES", {})
        return sum(n for route, n in routes.items() if route != "scatter")
    if name == "CALLS":
        return getattr(importlib.import_module(_PROFILING), "CALLS", 0)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def read(run):
    calls = run.counters["CALLS"]
    return 100.0 * run.counters["ROUTED"] / calls if calls else 0.0
