"""Host time that enqueues a call's device work, any wait inside a torch
call that synchronises included: the self times of the program's
``xhistogram.plan``, ``.autograd`` (the autograd Function around weighted
sums), ``.cuda_kernel``, ``.digitize``, ``.bincount`` and ``.finish``
spans over the window, per call, in us."""

from portbench.metrics._program import counters, per_call

COUNTERS = counters("span_plan", "span_autograd", "span_cuda_kernel", "span_digitize",
                    "span_bincount", "span_finish")


def read(run):
    return per_call(run, COUNTERS, 1e-3)
