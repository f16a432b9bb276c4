"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, on the fullest card, in GB."""


def read(run):
    return run.mem_window_bytes / 1e9 if run.mem_window_bytes else None
