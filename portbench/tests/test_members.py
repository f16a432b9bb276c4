"""The ensemble cell ``pdf_40x40_members``: its recipe's land and members,
the route its call takes, and the reader of the routes' counter."""

import math

import numpy as np
import pytest
import torch

from portbench import harness, registry
from portbench.tests.tiny import tree

CELL = "pdf_40x40_members"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return registry.Cell(CELL, here=tree(tmp_path_factory.mktemp("members")))


def _run(counters, n_calls=4):
    return harness.Run(setup_s=1.0, n_calls=n_calls, window_s=1.0,
                       call_s=np.full(n_calls, 0.25), host_s=np.full(n_calls, 0.01),
                       bytes_in=1e9, bound_s=None, mem_window_bytes=0,
                       counters=counters, trace=None)


def test_seeds_give_the_same_land_and_every_member_shares_it(tiny):
    config, cpu = tiny.config, torch.device("cpu")
    made = [tiny.recipe.make(config, seed, cpu, ["T", "S"]) for seed in (2**31 + 5, 2**33 + 1)]
    again = tiny.recipe.make(config, 2**31 + 5, cpu, ["T", "S"])
    shape = (config["members"], config["months"], config["nlat"], config["nlon"])
    cells = config["nlat"] * config["nlon"]
    land = torch.isnan(made[0]["T"][0, 0])
    assert int(land.sum()) == round(config["land_share"] * cells)
    for data in made:
        for name in ("T", "S"):
            x = data[name]
            assert x.shape == shape and x.dtype == torch.float32
            nan = torch.isnan(x)
            assert nan.equal(land.expand(shape))  # land in every member and month
        assert np.array_equal(data["T_edges"], np.linspace(-2, 38, 41).astype(np.float32))
        assert np.array_equal(data["S_edges"], np.linspace(30, 40, 41).astype(np.float32))
    for name in ("T", "S"):
        assert made[0][name].nan_to_num().equal(again[name].nan_to_num())
        assert not made[0][name].nan_to_num().equal(made[1][name].nan_to_num())


def test_members_share_a_cell_s_mean_state(tiny):
    config = dict(tiny.config, members=400, months=1)
    data = tiny.recipe.make(config, 2**32 + 9, torch.device("cpu"), ["T", "S"])
    sea = ~torch.isnan(data["T"][0, 0])
    for name, sd in config["anomaly_sd"].items():
        x = data[name][:, 0][:, sea]  # (member, ocean cell)
        spread = x.std(0)
        assert ((spread > 0.8 * sd) & (spread < 1.2 * sd)).all(), name
    lat = torch.tensor(np.deg2rad(np.repeat(
        -90 + 180 / config["nlat"] * (np.arange(config["nlat"]) + 0.5), config["nlon"])),
        dtype=torch.float32).reshape(config["nlat"], config["nlon"])[sea]
    profile = (28 - 30 * lat.sin() ** 2).clamp_min(-1.8)
    assert (data["T"][:, 0][:, sea].mean(0) - profile).abs().max() < 0.2


def test_the_cell_s_call_takes_the_direct_route():
    from xhistogram_torch.ops import cuda_hist

    cell = registry.Cell(CELL)
    config = cell.config
    assert cell.traffic["axis"] == [0] and cell.traffic["inputs"] == ["T", "S"]
    rows = config["months"] * config["nlat"] * config["nlon"]
    nbins = (config["T_edges"]["n"] - 1, config["S_edges"]["n"] - 1)
    assert (rows, nbins) == (737_280, (40, 40))
    assert cuda_hist.plan(2, nbins, rows, config["members"]) == "direct"


def test_the_route_share_reads_the_routes_counter():
    reader = registry.Cell(CELL).reader("kernel_route_pct")
    assert set(reader.COUNTERS) == {"ROUTED", "CALLS"}
    assert reader.read(_run({"ROUTED": 4, "CALLS": 4})) == 100.0
    assert reader.read(_run({"ROUTED": 1, "CALLS": 4})) == 25.0
    assert reader.read(_run({"ROUTED": 0, "CALLS": 0})) == 0.0


def test_the_routes_counter_leaves_the_plain_path_out():
    from xhistogram_torch.utils import profiling

    reader = registry.Cell(CELL).reader("kernel_route_pct")
    snap = harness._counter_reader([reader])
    before = snap()
    x = torch.randn(5, 30)
    profiling_calls = profiling.CALLS
    import xhistogram_torch

    for method in ("cuda", "auto"):  # the direct route's plain version; scatter
        xhistogram_torch.histogram(x, x, bins=[np.linspace(-3, 3, 9)] * 2, axis=0,
                                   method=method)
    moved = {k: v - before[k] for k, v in snap().items()}
    assert moved == {"ROUTED": 1, "CALLS": 2} and profiling.CALLS == profiling_calls + 2
    assert reader.read(_run(moved, n_calls=2)) == 50.0


def test_a_program_without_the_routes_counter_reads_zero(monkeypatch):
    """A checkout older than ``ROUTES``: its profiling module counts calls
    and no route."""
    import importlib
    import sys
    import types

    older = types.ModuleType("older_profiling")
    older.CALLS = 10
    monkeypatch.setitem(sys.modules, "older_profiling", older)
    module = importlib.import_module("portbench.metrics.kernel_route_pct")
    monkeypatch.setattr(module, "_PROFILING", "older_profiling")
    reader = registry.Cell(CELL).reader("kernel_route_pct")
    snap = harness._counter_reader([reader])
    before = snap()
    older.CALLS += 3
    moved = {k: v - before[k] for k, v in snap().items()}
    assert moved == {"ROUTED": 0, "CALLS": 3}
    got = reader.read(_run(moved, n_calls=3))
    assert math.isfinite(got) and got == 0.0


def test_only_the_ensemble_cell_reports_the_route_share():
    for w in registry.benchmark()["workloads"]:
        names = {m["name"] for m in registry.Cell(w["name"]).metrics(True)}
        assert ("kernel_route_pct" in names) == (w["name"] == CELL), w["name"]
        assert "kernel_route_pct" not in {m["name"] for m in
                                          registry.Cell(w["name"]).metrics(False)}
