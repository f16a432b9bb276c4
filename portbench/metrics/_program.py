"""The program's span totals and host counters under the names that the
metric readers' ``COUNTERS`` give them (``"portbench.metrics._program:<name>"``):

- ``span_<stage>``: nanoseconds of self time of the program's
  ``xhistogram.<stage>`` spans in this process
  (``xhistogram_torch.utils.profiling.SELF_NS``), 0 for a stage that has
  not run;
- ``HOST_SYNCS`` (``utils.profiling``), ``THRESHOLD_LOOKUPS`` and
  ``THRESHOLD_HITS`` (``xhistogram_torch.core``).

A program without them, a checkout older than its spans, reads 0: it keeps
no such total or count, so nothing is put under a span and nothing counted.
The readers then give a finite number, as the harness's check of a traced
line asks of every metric of the cell, and the run goes on."""

from __future__ import annotations

import importlib

_PROFILING = "xhistogram_torch.utils.profiling"
_COUNTS = {"HOST_SYNCS": _PROFILING, "THRESHOLD_LOOKUPS": "xhistogram_torch.core",
           "THRESHOLD_HITS": "xhistogram_torch.core"}


def __getattr__(name):
    if name.startswith("span_"):
        totals = getattr(importlib.import_module(_PROFILING), "SELF_NS", {})
        return totals.get(name[len("span_"):], 0)
    if name in _COUNTS:
        return getattr(importlib.import_module(_COUNTS[name]), name, 0)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def counters(*names):
    """A reader's ``COUNTERS`` of ``names`` (``span_<stage>`` or a counter)."""
    return {n: f"{__name__}:{n}" for n in names}


def per_call(run, names, scale=1.0):
    """The sum of the counters ``names``' changes over the window, times
    ``scale``, per call."""
    return sum(run.counters[k] for k in names) * scale / run.n_calls
