"""Host time making the inputs tensors on one device, broadcasting them and
laying them out as the kernels read them (``utils.axes.strided_layout``):
the self time of the program's ``xhistogram.canonicalize`` spans over the
window, per call, in us."""

from portbench.metrics._program import counters, per_call

COUNTERS = counters("span_canonicalize")


def read(run):
    return per_call(run, COUNTERS, 1e-3)
