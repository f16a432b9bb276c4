"""The result line's check: what run.py holds its own line to before it
prints it, and what check_line.py holds a saved line to."""

import copy
import json

import pytest

from portbench import check_line, registry

NAMES = ["kernel_roofline", "device_idle_pct"]
LINE = {
    "correct": True, "attempted": 10, "failed": 0,
    "metrics": {"kernel_roofline": {"value": 40.0, "unit": "%"},
                "device_idle_pct": {"value": 12.5, "unit": "%"}},
    "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
               "memory_peak_bytes": 123, "busy_s": 0.5, "window_s": 0.6},
    "breakdown": {"device_ops": [["joint2", 0.4]], "idle_gaps": [["host", 0.1]]},
    "checks": {"count_gap": {"value": 0.0, "limit": 0}},
}


def _problems(change=None, traced=True):
    line = copy.deepcopy(LINE)
    if change:
        change(line)
    return check_line.check(line, NAMES, traced, count=4)


def test_a_sound_line_passes():
    assert _problems() == []


def test_busy_above_window_or_zero_fails():
    assert _problems(lambda l: l["device"].update(busy_s=0.7))
    assert _problems(lambda l: l["device"].update(busy_s=0.0))
    assert _problems(lambda l: l["device"].pop("busy_s"))


def test_busy_is_not_needed_untraced():
    def untraced(line):
        del line["device"]["busy_s"], line["device"]["window_s"]
    assert _problems(untraced, traced=False) == []


def test_missing_or_foreign_metric_fails():
    assert _problems(lambda l: l["metrics"].pop("device_idle_pct"))
    assert _problems(lambda l: l["metrics"].update(other={"value": 1.0, "unit": "s"}))
    assert _problems(lambda l: l["metrics"]["kernel_roofline"].update(value=float("nan")))


def test_roofline_above_105_percent_fails():
    assert _problems(lambda l: l["metrics"]["kernel_roofline"].update(value=106.0))


def test_device_and_keys():
    assert _problems(lambda l: l["device"].update(count=1))
    assert _problems(lambda l: l["device"].update(platform="cpu"))
    assert _problems(lambda l: l.pop("failed"))
    assert _problems(lambda l: l["breakdown"].update(device_ops=[["k", 1.0]] * 11))


@pytest.mark.parametrize("workload", [w["name"] for w in registry.benchmark()["workloads"]])
def test_the_command_reads_a_saved_line(workload, tmp_path, capsys):
    cell = registry.Cell(workload)
    line = copy.deepcopy(LINE)
    line["device"]["count"] = cell.chips
    line["metrics"] = {m["name"]: {"value": 1.0, "unit": m["unit"]}
                       for m in cell.metrics(True)}
    f = tmp_path / "run.out"
    f.write_text("warm-up notes\n" + json.dumps(line) + "\n")
    assert check_line.main(["--workload", workload, "--trace", "1", str(f)]) == 0
    line["device"]["count"] = 1 if cell.chips > 1 else 4
    f.write_text(json.dumps(line) + "\n")
    assert check_line.main(["--workload", workload, "--trace", "1", str(f)]) == 1
    line["device"]["count"] = cell.chips
    line["device"]["busy_s"] = 0.0
    f.write_text(json.dumps(line) + "\n")
    assert check_line.main(["--workload", workload, "--trace", "1", str(f)]) == 1
    out = capsys.readouterr().out
    assert "device.count" in out and "busy_s" in out


def test_a_saved_line_of_the_four_card_cell_has_its_collectives():
    names = [m["name"] for m in registry.Cell("ts_01deg_global_4card").metrics(True)]
    assert "allreduce_ms" in names
    assert "allreduce_ms" not in [m["name"] for m in
                                  registry.Cell("ts_ecco_levels_vol").metrics(True)]
