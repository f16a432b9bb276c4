"""The bytes bound of the window's calls over the device time of their
work, in %: each call's inputs read once and output written once at the
card's published HBM bandwidth (``peaks.py``), against the union of every
non-NCCL kernel, copy and memset interval on the card (means over the
cards). A kernel of a new name still counts, and the bound does not move."""


def read(run):
    if run.trace is None or not run.trace["work_s"] or run.bound_s is None:
        return None
    return 100.0 * run.bound_s / run.trace["work_s"]
