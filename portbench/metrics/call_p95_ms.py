"""95th percentile of the wall times of all the window's calls, each from
the public call's entry to the synchronise after it (a sharded call: its
slowest rank's), in ms."""

import numpy as np


def read(run):
    return float(np.percentile(run.call_s, 95)) * 1e3
