"""Host time resolving the bin edges and their thresholds on the card
(the threshold cache's key and lookup included): the self time of the
program's ``xhistogram.edges`` spans over the window, per call, in us."""

from portbench.metrics._program import counters, per_call

COUNTERS = counters("span_edges")


def read(run):
    return per_call(run, COUNTERS, 1e-3)
