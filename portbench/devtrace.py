"""The device's activity in the traced window, from ``torch.profiler``.

Only device activity is profiled (``ProfilerActivity.CUDA``): kernels,
copies and memsets on every stream of the run's card. The profiler starts
after the warm-up's synchronise and stops after the window's last, so what
it records is the window's work. Busy time is the length of the union of
those intervals, never a sum of durations: kernels on two streams (NCCL
runs on its own) overlap. Device timestamps are on the host's wall clock
(``time.time_ns``), which places each idle gap against what the host was
doing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

NAME_CHARS = 160


def start(device):
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof):
    """The recorded device intervals: (name, start_ns, end_ns)."""
    if prof is None:
        return []
    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()
            and e.end_ns() > e.start_ns()]


def union(intervals):
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def length(merged):
    return sum(e - s for s, e in merged)


def is_nccl(name):
    return name.lower().startswith("nccl")


def is_kernel(name):
    return not name.startswith(("Memcpy", "Memset"))


#: what the host was doing in an idle gap of the device, by where the
#: gap's middle falls in the window's calls
PHASES = ("in the public call (host prep and launches)", "in synchronize after the call",
          "between calls (the loop)", "before the first call", "after the last call")


def reduce(events, calls_ns, window_ns):
    """The window's device figures, in seconds: ``busy_s`` (every interval),
    ``work_s`` and ``kernels`` (all but NCCL's), the ten ``ops`` that took
    most time, and ``gaps``: the
    idle time by what the host was doing. ``calls_ns`` holds each call's
    (entry, return, synchronised) host wall times, ``window_ns`` the window's
    (start, end)."""
    work = [(s, e) for n, s, e in events if not is_nccl(n)]
    busy = union([(s, e) for _, s, e in events])
    by_name = defaultdict(int)
    for n, s, e in events:
        by_name[n[:NAME_CHARS]] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = defaultdict(int)
    entries = [c[0] for c in calls_ns]
    edges = [window_ns[0], *(x for iv in busy for x in iv), window_ns[1]]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        j = bisect.bisect_right(entries, mid) - 1
        if j < 0:
            phase = PHASES[3]
        elif mid < calls_ns[j][1]:
            phase = PHASES[0]
        elif mid < calls_ns[j][2]:
            phase = PHASES[1]
        elif j == len(calls_ns) - 1:
            phase = PHASES[4]
        else:
            phase = PHASES[2]
        gaps[phase] += b - a
    return {
        "busy_s": length(busy) / 1e9,
        "work_s": length(union(work)) / 1e9,
        "kernels": sum(is_kernel(n) and not is_nccl(n) for n, _, _ in events),
        "ops": [[n, t / 1e9] for n, t in ops],
        "gaps": [[p, t / 1e9] for p, t in sorted(gaps.items(), key=lambda kv: -kv[1])],
    }
