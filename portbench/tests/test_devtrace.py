"""Device busy time: a union of intervals over every stream, never a sum,
and never above the window."""

import pytest

from portbench import devtrace


def test_union_merges_overlaps_across_streams():
    # a kernel on the compute stream overlapped by an NCCL kernel on its own
    merged = devtrace.union([(10, 50), (40, 70), (80, 90), (85, 88), (90, 95)])
    assert merged == [[10, 70], [80, 95]]
    assert devtrace.length(merged) == 75


def _events():
    return [("joint2_kernel", 1_000, 5_000), ("ncclDevKernel_AllReduce", 4_000, 6_000),
            ("Memset (Device)", 7_000, 7_500), ("joint2_kernel", 9_000, 9_400)]


def test_reduce_busy_work_and_nccl():
    calls = [(0, 800, 6_800), (6_900, 7_000, 9_600)]
    r = devtrace.reduce(_events(), calls, (0, 10_000))
    assert r["busy_s"] == pytest.approx(5_900e-9)  # 1000-6000, 7000-7500, 9000-9400
    assert r["busy_s"] < sum(e - s for _, s, e in _events()) * 1e-9  # not the sum
    assert r["work_s"] == pytest.approx((4_000 + 500 + 400) * 1e-9)  # NCCL's left out
    assert r["kernels"] == 2
    assert r["busy_s"] <= 10_000e-9
    gaps = dict(r["gaps"])
    assert sum(gaps.values()) == pytest.approx(10_000e-9 - r["busy_s"])
    assert gaps[devtrace.PHASES[0]] == pytest.approx(1_000e-9)  # 0-1000: call 0 in host prep
    assert gaps[devtrace.PHASES[1]] == pytest.approx(2_500e-9)  # 6000-7000, 7500-9000: waits
    assert gaps[devtrace.PHASES[4]] == pytest.approx(600e-9)  # 9400-10000: after the last call


def test_intervals_past_the_window_edges_count_once():
    # an interval that began before the window or ends after it is still one
    # interval of the union; the union never exceeds the span of the events
    events = [("k", -500, 300), ("k", 200, 900), ("k", 950, 1_200)]
    r = devtrace.reduce(events, [(0, 100, 1_000)], (0, 1_000))
    assert r["busy_s"] == pytest.approx(1_650e-9)
    assert r["busy_s"] <= (1_200 - -500) * 1e-9
