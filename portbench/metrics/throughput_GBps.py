"""Input bytes of every call completed in the window, every card's, over
the whole window (host clock), in GB/s."""


def read(run):
    return run.bytes_in / run.window_s / 1e9
