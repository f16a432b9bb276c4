"""A cell on several cards: how the ranks' readings merge into one line,
and what happens when a rank fails or hangs (four gloo ranks on the CPU).
The rehearsal of the four-card cell itself, its control and its faults,
are in ``test_rehearsal.py``."""

import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import procs, ranks, registry

CELL = "ts_01deg_global_4card"
MS = 1_000_000  # ns


def _reading(rank, events, window=(0, 10 * MS), calls=4, start=0.0):
    """One rank's reading of four calls in a window of 10 ms."""
    walls = [(window[0] + i * 2 * MS, window[0] + i * 2 * MS + 100_000,
              window[0] + (i + 1) * 2 * MS) for i in range(calls)]
    return {
        "kind": "NVIDIA H100 80GB HBM3", "setup_s": 20.0 + rank, "pace_s": 0.0025,
        "n_calls": calls, "t_start": start, "t_end": start + 0.010 + 0.001 * rank,
        "call_s": np.full(calls, 0.002 + 0.001 * rank), "host_s": np.full(calls, 1e-4 * (rank + 1)),
        "bytes_in": 1e9, "bound_s": 0.004, "mem_window_bytes": 100 + rank,
        "memory_peak_bytes": 200 + rank, "counters": {"LAYOUT_COPIES": rank},
        "events": events, "walls": walls, "window_ns": window,
        "checks": {"count_gap": float(rank == 2)}, "failed": int(rank == 2), "check_s": 0.5,
        "phases": {"rank": float(rank)}, "forbidden": [],
    }


def _kernel(s, e):
    return ("joint2_kernel", s * MS, e * MS)


def _nccl(s, e):
    return ("ncclDevKernel_AllReduce_Sum_i64_RING_LL", s * MS, e * MS)


def test_busy_is_each_ranks_union_in_its_window_and_the_ranks_mean():
    readings = [
        _reading(0, [_kernel(1, 3), _kernel(5, 7)]),  # 4 ms
        # two streams that overlap: the all-reduce inside the kernel's time
        _reading(1, [_kernel(1, 5), _nccl(4, 6), _kernel(8, 9)]),  # 1-6, 8-9: 6 ms
        # a trace that crosses the window's edges: cut to 0-10 ms
        _reading(2, [_kernel(-5, 2), _nccl(9, 14)]),  # 0-2, 9-10: 3 ms
        # a window of its own, 1-11 ms, and a kernel past its end
        _reading(3, [_kernel(0, 4), _kernel(10, 12)], window=(1 * MS, 11 * MS)),  # 1-4, 10-11
    ]
    run, extra, notes = ranks.merge(readings, traced=True)
    busy = [4e-3, 6e-3, 3e-3, 4e-3]
    assert [t["busy_s"] for t in run.trace["ranks"]] == pytest.approx(busy)
    assert all(t["busy_s"] <= t["window_s"] for t in run.trace["ranks"])
    assert run.trace["busy_s"] == pytest.approx(sum(busy) / 4)  # a mean, never a sum
    assert run.trace["window_s"] == pytest.approx(0.010)
    assert 0 < run.trace["busy_s"] <= run.trace["window_s"]
    assert extra["problems"] == []
    # NCCL's work is busy time but not the program's work
    assert run.trace["work_s"] == pytest.approx((4 + 5 + 2 + 4) * 1e-3 / 4)
    assert run.trace["kernels"] == pytest.approx((2 + 2 + 1 + 2) / 4)
    ops = dict(run.trace["ops"])
    assert ops["joint2_kernel"] == pytest.approx((4 + 5 + 2 + 4) * 1e-3 / 4)
    assert ops["ncclDevKernel_AllReduce_Sum_i64_RING_LL"] == pytest.approx((2 + 1) * 1e-3 / 4)
    assert sum(t for _, t in run.trace["gaps"]) == pytest.approx(
        run.trace["window_s"] - run.trace["busy_s"])
    reader = registry.Cell(CELL).reader("allreduce_ms")
    assert reader.read(run) == pytest.approx((0 + 2 + 1 + 0) / 4 / 4)  # ms a call


def test_a_rank_busy_past_its_window_makes_the_line_unsound():
    readings = [_reading(r, [_kernel(1, 3)]) for r in range(4)]
    readings[1]["events"] = []
    _, extra, _ = ranks.merge(readings, traced=True)
    assert any(p.startswith("rank 1: busy_s 0") for p in extra["problems"])


def test_the_line_sums_bytes_and_takes_the_slowest_rank_and_fullest_card():
    readings = [_reading(r, []) for r in range(4)]
    readings[3]["t_start"] = -0.002  # the first rank to start
    run, extra, _ = ranks.merge(readings, traced=False)
    assert run.trace is None
    assert run.window_s == pytest.approx(0.013 + 0.002)  # first start to last end
    assert run.bytes_in == 4e9
    assert np.allclose(run.call_s, 0.005)  # each call's slowest rank
    assert np.allclose(run.host_s, 1e-4)  # rank 0's
    assert run.setup_s == 20.0 and extra["phases"] == {"rank": 0.0}
    assert run.mem_window_bytes == 103 and extra["memory_peak_bytes"] == 203
    assert run.counters == {"LAYOUT_COPIES": 1.5}
    assert run.bound_s == 0.004
    assert extra["checks"] == {"count_gap": 1.0} and extra["failed"] == 1
    assert extra["problems"] == []


def test_ranks_that_disagree_make_the_line_unsound():
    readings = [_reading(r, []) for r in range(4)]
    readings[2] = _reading(2, [], calls=5)
    readings[3]["kind"] = "NVIDIA H100 PCIe"
    _, extra, _ = ranks.merge(readings, traced=False)
    assert len(extra["problems"]) == 2


SCRIPT = """
import sys
sys.path.insert(0, {root!r})
from portbench import harness, procs
from portbench.tests.tiny import tree
if __name__ == "__main__":
    procs.SEED_S = 5.0  # this rank's deadline for a seed
    here = tree({tmp!r})
    harness.run_cell({cell!r}, [7], 0.2, False, "cpu", here=here,
                     hook="portbench.tests.faults:{fault}")
    print("a line")
"""


@pytest.mark.parametrize("fault", ["a_rank_fails", "a_rank_hangs"])
def test_a_rank_that_fails_or_hangs_ends_every_rank_with_no_line(tmp_path, fault):
    code = SCRIPT.format(root=str(registry.ROOT), tmp=str(tmp_path), cell=CELL, fault=fault)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240)
    assert out.returncode != 0, out.stderr[-2000:]
    assert "a line" not in out.stdout
    if fault == "a_rank_hangs":  # the deadline ended it
        assert f"every rank exits with code {procs.EXIT_RANK}" in out.stderr
    assert time.monotonic() - t0 < 120
    # no rank is left behind
    left = subprocess.run(["pgrep", "-f", f"--here {tmp_path}"], capture_output=True,
                          text=True).stdout.split()
    assert left == []


def test_the_four_card_cell_asks_for_four_cards_and_one_card_cells_spawn_nothing():
    bench = registry.benchmark()
    assert {w["name"]: w["chips"] for w in bench["workloads"]}[CELL] == 4
    assert sum(w["chips"] > 1 for w in bench["workloads"]) == 1
    for w in bench["workloads"]:
        cell = registry.Cell(w["name"])
        assert getattr(cell.kind, "RANKS", False) == (w["chips"] > 1)


def test_a_rank_reads_the_same_land_and_its_own_data(tmp_path):
    import torch

    from portbench.tests.tiny import tree

    cell = registry.Cell(CELL, here=tree(tmp_path))
    made = [cell.recipe.make(cell.config, 2**31 + 5, torch.device("cpu"), ["T", "S"],
                             rank=r, world=4) for r in range(4)]
    assert made[0]["T"].shape[0] == cell.config["times"] // 4
    wet = [~torch.isnan(d["T"]) for d in made]
    assert all(w.equal(wet[0]) for w in wet)
    assert not made[0]["T"].nan_to_num().equal(made[1]["T"].nan_to_num())
    again = cell.recipe.make(cell.config, 2**31 + 5, torch.device("cpu"), ["T"], rank=1, world=4)
    assert again["T"].nan_to_num().equal(made[1]["T"].nan_to_num())
    with pytest.raises(ValueError):
        cell.recipe.make(cell.config, 1, torch.device("cpu"), ["T"], rank=0, world=3)
