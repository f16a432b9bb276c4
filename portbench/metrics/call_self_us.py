"""Host time inside the public call that no step's span covers: the self
time of the program's ``xhistogram.call`` spans (``core.histogram``) over
the window, per call, in us."""

from portbench.metrics._program import counters, per_call

COUNTERS = counters("span_call")


def read(run):
    return per_call(run, COUNTERS, 1e-3)
