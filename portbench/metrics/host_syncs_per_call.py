"""Times a call blocked the host on the card, per call: the change of the
program's ``utils.profiling.HOST_SYNCS`` over the window."""

from portbench.metrics._program import counters, per_call

COUNTERS = counters("HOST_SYNCS")


def read(run):
    return per_call(run, COUNTERS)
