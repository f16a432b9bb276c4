"""Host time of the labeled layer itself (validation, the layout plan and
the relabel): the self time of the program's ``xhistogram.labeled`` spans
over the window, per call, in us."""

from portbench.metrics._program import counters, per_call

COUNTERS = counters("span_labeled")


def read(run):
    return per_call(run, COUNTERS, 1e-3)
