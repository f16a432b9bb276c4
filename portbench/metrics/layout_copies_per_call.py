"""Operands copied into a contiguous layout before a kernel, per call
(the change of ``cuda_hist.LAYOUT_COPIES`` over the window)."""

COUNTERS = {"LAYOUT_COPIES": "xhistogram_torch.ops.cuda_hist:LAYOUT_COPIES"}


def read(run):
    return run.counters["LAYOUT_COPIES"] / run.n_calls
