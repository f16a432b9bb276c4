"""Seconds from the start of run.py to the first timed call: imports, the
CUDA context, the kernel library's load (its build in a checkout's first
run), the data made from the seed, and the warm-up calls."""


def read(run):
    return run.setup_s
