"""Device time of the collectives a call, in ms: on each rank's card the
length of the union of the NCCL kernels' intervals over the traced window
(NCCL's stream overlaps the program's, so never a sum), per call, as the
ranks' mean. A run with no NCCL kernel, such as one on one card, has
nothing to read."""

from portbench import devtrace


def read(run):
    if run.trace is None or "rank_events" not in run.trace:
        return None
    per_rank = [devtrace.length(devtrace.union([(s, e) for n, s, e in events
                                                 if devtrace.is_nccl(n)]))
                for events in run.trace["rank_events"]]
    if not any(per_rank):
        return None
    return sum(per_rank) / len(per_rank) / run.n_calls / 1e6
