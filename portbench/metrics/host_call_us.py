"""Mean host time of a call, from the public call's entry to its return,
before the synchronise (host clock; rank 0 of a sharded cell), in us."""


def read(run):
    return float(run.host_s.mean()) * 1e6
