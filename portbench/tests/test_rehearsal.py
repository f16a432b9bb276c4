"""A tiny CPU rehearsal of every cell: the harness's run without its look
for a card, on the program's CPU path, at the tiny sizes of
``tests/configs``. Each run is correct; the control (the reference in
bfloat16 in the program's place) and every fault planted under the timed
path are not."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness, registry
from portbench.control import HOOK as control_hook
from portbench.tests.tiny import cells, tree

CELLS = cells()
#: what only a card can give: its memory, its profiler's trace
DEVICE_ONLY = ("mem_peak_GB", "kernels_per_call", "kernel_roofline", "device_idle_pct",
               "allreduce_ms", "memory_peak_bytes", "busy_s")


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tree(tmp_path_factory.mktemp("tiny"))


def _run(here, cell, trace=False, hook=None, seeds=(3_000_000_007,)):
    return harness.run_cell(cell, list(seeds), 0.2, trace, "cpu", here=here, hook=hook)


def _sound_but_for_the_card(notes):
    problems = [n for n in notes if n.startswith("result line unsound")]
    return [p for p in problems if not any(d in p for d in DEVICE_ONLY)]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_correct_and_its_control_is_not(here, cell):
    [(line, notes)] = _run(here, cell)
    checks = line["checks"]
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert _sound_but_for_the_card(notes) == []
    assert notes[-len(checks):] == [f"check {n} {c['value']!r} limit {c['limit']!r}"
                                    for n, c in checks.items()]
    assert list(line)[-1] == "checks"
    assert line["device"]["count"] == registry.Cell(cell).chips
    [(control, _)] = _run(here, cell, hook=control_hook)
    assert control["correct"] is False, control["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_host_metrics(here, cell):
    [(line, notes)] = _run(here, cell, trace=True)
    assert "host_call_us" in line["metrics"] and "layout_copies_per_call" in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert _sound_but_for_the_card(notes) == []


#: faults of a cell on several cards: one rank's part left out of the exchange
RANK_FAULTS = ("dropped_part",)
FAULTS = [(cell, fault) for cell in CELLS for fault in ("altered_answer", "half_the_data")] + [
    (cell, fault) for cell in CELLS if registry.Cell(cell).chips > 1 for fault in RANK_FAULTS]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(here, cell, fault):
    [(line, notes)] = _run(here, cell, hook=f"portbench.tests.faults:{fault}")
    assert line["correct"] is False, line["checks"]


def test_a_window_with_calls_in_flight_waits_for_every_call_it_sent(tmp_path, monkeypatch):
    """The year's traffic keeps calls in flight: after each call the harness
    waits for the one ``in_flight`` before it, and the window closes only
    after a wait for every call sent. The tiny run makes few calls on the
    CPU, so it keeps 2 in flight where the cell keeps more."""
    cell = "sst_025deg_year"
    assert registry.Cell(cell).traffic["in_flight"] > 1
    here = tree(tmp_path)
    (here / "traffic").unlink()
    shutil.copytree(registry.HERE / "traffic", here / "traffic")
    year = here / "traffic" / "year_per_cell.json"
    year.write_text(json.dumps({**json.loads(year.read_text()), "in_flight": 2}))
    ahead = registry.Cell(cell, here=here).traffic["in_flight"]
    log = []

    class Event:
        def __init__(self):
            self.n = sum(e[0] == "sent" for e in log)
            log.append(("sent", self.n))

        def synchronize(self):
            log.append(("waited", self.n))

    monkeypatch.setattr(harness, "_mark", lambda device: Event())
    monkeypatch.setattr(harness, "_sync", lambda device: log.append(("all",)))
    [(line, _)] = harness.run_cell(cell, [3_000_000_011], 0.5, False, "cpu", here=here)
    sent = [e[1] for e in log if e[0] == "sent"]
    assert sent == list(range(line["attempted"])) and line["correct"] is not None
    waited = [e[1] for e in log if e[0] == "waited"]
    assert line["attempted"] > ahead and waited == list(range(line["attempted"] - ahead))
    last_sent = max(i for i, e in enumerate(log) if e[0] == "sent")
    assert ("all",) in log[last_sent:]
    for i, e in enumerate(log):  # each wait comes after the call ``ahead`` later was sent
        if e[0] == "waited":
            assert ("sent", e[1] + ahead) in log[:i]
    assert all(c["value"] <= c["limit"] for c in line["checks"].values()), line["checks"]


def test_seeds_give_the_same_data(here):
    cell = registry.Cell("sst_025deg_year", here=here)
    import torch
    a = cell.recipe.make(cell.config, 2**31 + 5, torch.device("cpu"), ["sst"])
    b = cell.recipe.make(cell.config, 2**31 + 5, torch.device("cpu"), ["sst"])
    c = cell.recipe.make(cell.config, 2**31 + 6, torch.device("cpu"), ["sst"])
    assert torch.equal(a["sst"].nan_to_num(), b["sst"].nan_to_num())
    assert not torch.equal(a["sst"].nan_to_num(), c["sst"].nan_to_num())
    nan = torch.isnan(a["sst"][0]).float().mean().item()
    assert abs(nan - cell.config["land_fraction"]) < 0.02
    assert torch.isnan(a["sst"]).all(0).equal(torch.isnan(a["sst"]).any(0))  # land every day


def test_every_seed_has_the_same_wet_cells(here):
    import torch
    cell = registry.Cell("ts_ecco_levels_vol", here=here)
    made = [cell.recipe.make(cell.config, seed, torch.device("cpu"), ["T", "S", "volume"])
            for seed in (2**31 + 5, 2**33 + 1)]
    wet = [~torch.isnan(d["T"]) for d in made]
    for d, w in zip(made, wet):
        assert w.equal(~torch.isnan(d["S"])) and w.equal((d["volume"] > 0).expand_as(w))
    assert wet[0].equal(wet[1]) and not made[0]["T"].nan_to_num().equal(made[1]["T"].nan_to_num())
    counts = wet[0][0].sum(1)
    assert counts.tolist() == list(cell.recipe.wet_counts(cell.config))
    assert (counts[:-1] >= counts[1:]).all()


SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests.tiny import cells, tree
if __name__ == "__main__":
    here = tree({tmp!r})
    for cell in {cells!r}:
        harness.run_cell(cell, [7], 0.1, False, "cpu", here=here)
    print(json.dumps(sorted(sys.modules)))
"""


def test_no_run_loads_jax_or_the_jax_package(tmp_path):
    code = SCRIPT.format(root=str(registry.ROOT), tmp=str(tmp_path), cells=CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout
    tops = {m.split(".")[0] for m in json.loads(out.splitlines()[-1])}
    assert "xhistogram_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "xhistogram_tpu"}
