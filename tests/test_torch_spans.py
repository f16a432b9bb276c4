"""``utils/profiling``'s spans and the host counters of the public call.

Every step of a call runs in a span (``scope``) that adds its self time to
``profiling.SELF_NS``; the root span of a public call counts it in
``CALLS``; the threshold cache counts its lookups and hits; ``HOST_SYNCS``
counts the host's waits on the card. The tests marked ``gpu`` need a CUDA
card and skip without one. This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_spans.py
"""

import json
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

import xhistogram_torch
from xhistogram_torch import core, labeled
from xhistogram_torch.utils import profiling


class _FakeClock:
    """A clock that moves on by 1, 2, 3, ... ns at each read, and keeps
    what it returned."""

    def __init__(self):
        self.reads = [1000]

    def __call__(self):
        self.reads.append(self.reads[-1] + len(self.reads))
        return self.reads[-1]


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in profiling.SELF_NS.items()
            if v != before.get(k, 0)}


def test_self_times_add_up_to_the_root_span(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(profiling, "_clock", clock)
    before = dict(profiling.SELF_NS)
    with profiling.scope("t_root", call=True):
        with profiling.scope("t_a"):
            with profiling.scope("t_b"):
                pass
            with profiling.scope("t_b"):
                pass
        with profiling.scope("t_c"):
            pass
    r = clock.reads[1:]  # enter root, a, b, exit b, enter b, exit b, exit a, c, c, root
    assert len(r) == 10
    got = _delta(before)
    b = (r[3] - r[2]) + (r[5] - r[4])
    a = (r[6] - r[1]) - b
    c = r[8] - r[7]
    assert got == {"t_b": b, "t_a": a, "t_c": c,
                   "t_root": (r[9] - r[0]) - (r[6] - r[1]) - c}
    assert sum(got.values()) == r[9] - r[0]  # the root's duration, exactly
    assert profiling._OPEN.spans == []


def test_a_call_s_span_totals_stay_within_its_wall_time():
    x = np.random.default_rng(1).normal(size=(6, 300)).astype(np.float32)
    edges = np.linspace(-3, 3, 13)
    before = dict(profiling.SELF_NS)
    t0 = profiling._clock()
    xhistogram_torch.histogram(x, bins=[edges], axis=1, device="cpu")
    wall = profiling._clock() - t0
    got = _delta(before)
    assert {"call", "edges", "canonicalize", "plan", "digitize", "bincount",
            "finish"} <= set(got)
    assert all(v >= 0 for v in got.values())
    assert 0 < sum(got.values()) <= wall


def test_a_span_closes_when_its_step_raises():
    before = profiling.CALLS
    with pytest.raises(ValueError):
        xhistogram_torch.histogram(np.arange(4.0), bins=[np.array([0.0])], device="cpu")
    assert profiling._OPEN.spans == []
    assert profiling.CALLS == before + 1
    xhistogram_torch.histogram(np.arange(4.0), bins=[np.array([0.0, 4.0])], device="cpu")
    assert profiling.CALLS == before + 2


def _labeled_input(rng):
    data = torch.from_numpy(rng.normal(size=(5, 7, 11)).astype(np.float32))
    return labeled.NamedArray(data, ("time", "lat", "lon"),
                              coords={"lat": np.arange(7.0)}, name="sst")


@pytest.mark.parametrize("api", ["core", "labeled"])
def test_each_public_call_counts_one_call(api):
    rng = np.random.default_rng(2)
    edges = np.linspace(-3, 3, 9)
    before = profiling.CALLS
    if api == "core":
        x = rng.normal(size=(4, 50)).astype(np.float32)
        xhistogram_torch.histogram(x, x, bins=[edges, edges], axis=1, device="cpu")
    else:
        labeled.histogram(_labeled_input(rng), bins=[edges], dim=("time",), device="cpu")
    assert profiling.CALLS == before + 1


#: a tiny call on the CPU that takes each route: (inputs' shape, bins of
#: each input, axis, method); method="cuda" runs the route's plain version
ROUTE_CALLS = {
    "one_input": ((4, 50), (8,), 1, "cuda"),
    "joint2": ((4, 50), (8, 8), None, "cuda"),
    "factored": ((4, 50), (5, 6, 7), None, "cuda"),
    "factored_per_row": ((3, 300), (8, 8), 1, "cuda"),
    "factored_packed": ((4, 60), (100, 100), 1, "cuda"),
    "direct": ((4, 60), (8, 8), 1, "cuda"),
    "scatter": ((4, 60), (8, 8), 1, "auto"),
}


@pytest.mark.parametrize("route", list(ROUTE_CALLS))
def test_each_call_counts_its_route_once(route):
    shape, nbins, axis, method = ROUTE_CALLS[route]
    assert set(profiling.ROUTES) == set(ROUTE_CALLS)
    rng = np.random.default_rng(len(route))
    args = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in nbins]
    bins = [np.linspace(-3, 3, nb + 1) for nb in nbins]
    before, calls = dict(profiling.ROUTES), profiling.CALLS
    for _ in range(2):
        xhistogram_torch.histogram(*args, bins=bins, axis=axis, method=method)
    moved = {k: v - before[k] for k, v in profiling.ROUTES.items() if v != before[k]}
    assert moved == {route: 2} and profiling.CALLS == calls + 2


def test_a_labeled_call_counts_one_route():
    before = dict(profiling.ROUTES)
    labeled.histogram(_labeled_input(np.random.default_rng(9)),
                      bins=[np.linspace(-3, 3, 9)], dim=("time",), device="cpu")
    moved = {k: v - before[k] for k, v in profiling.ROUTES.items() if v != before[k]}
    assert moved == {"scatter": 1}


def test_repeated_edges_miss_once_then_hit_and_edited_edges_miss():
    edges = np.sort(np.random.default_rng().normal(size=17))
    x = np.random.default_rng(3).normal(size=(3, 40)).astype(np.float32)

    def counts():
        return core.THRESHOLD_LOOKUPS, core.THRESHOLD_HITS

    def call(e):
        xhistogram_torch.histogram(x, bins=[e], axis=1, device="cpu")

    lookups, hits = counts()
    call(edges)
    assert counts() == (lookups + 1, hits)
    call(edges)
    call(edges.copy())
    assert counts() == (lookups + 3, hits + 2)
    edited = edges.copy()
    edited[5] = (edited[4] + edited[5]) / 2
    call(edited)
    assert counts() == (lookups + 4, hits + 2)
    xhistogram_torch.histogram(x, bins=10, axis=1, device="cpu")  # resolved, not cached
    assert counts() == (lookups + 4, hits + 2)


class _Ranges:
    """Stands in for the profiler's range (``profiling._range``): records
    each range entered as (name, its arguments)."""

    def __init__(self):
        self.entered = []

    def __call__(self, name, inputs, args):
        assert isinstance(name, str) and inputs == () and isinstance(args, dict)
        self.entered.append((name, args))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _call_both(rng):
    x = rng.normal(size=(4, 60)).astype(np.float32)
    xhistogram_torch.histogram(x, bins=[np.linspace(-3, 3, 7)], axis=1, device="cpu")
    labeled.histogram(_labeled_input(rng), bins=[np.linspace(-3, 3, 7)], dim=("time",),
                      device="cpu")


def test_no_range_is_entered_while_no_profiler_runs(monkeypatch):
    ranges = _Ranges()
    monkeypatch.setattr(profiling, "_range", ranges)
    assert not torch.autograd.profiler._is_profiler_enabled
    _call_both(np.random.default_rng(4))
    assert ranges.entered == []


def test_ranges_carry_the_steps_and_the_call_id_while_a_profiler_runs(monkeypatch):
    ranges = _Ranges()
    monkeypatch.setattr(profiling, "_range", ranges)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    first = profiling.CALLS + 1
    _call_both(np.random.default_rng(5))
    names = [n for n, _ in ranges.entered]
    assert names[0] == "xhistogram.call" and "xhistogram.labeled" in names
    assert {"xhistogram.edges", "xhistogram.canonicalize", "xhistogram.plan",
            "xhistogram.digitize", "xhistogram.bincount", "xhistogram.finish"} <= set(names)
    # core's call nests under the labeled call and carries its id
    calls = [a for n, a in ranges.entered if n in ("xhistogram.call", "xhistogram.labeled")]
    assert calls == [{"call": first}, {"call": first + 1}, {"call": first + 1}]
    assert all(a == {} for n, a in ranges.entered
               if n not in ("xhistogram.call", "xhistogram.labeled"))


def test_host_syncs_count_card_reads_only():
    before = profiling.HOST_SYNCS
    profiling.note_syncs(torch.device("cpu"), 3)
    assert profiling.HOST_SYNCS == before
    profiling.note_syncs(torch.device("cuda", 0), 2)
    profiling.note_syncs(torch.device("cuda", 0))
    assert profiling.HOST_SYNCS == before + 3
    x = np.random.default_rng(6).normal(size=(4, 60)).astype(np.float32)
    xhistogram_torch.histogram(x, bins=[np.linspace(-3, 3, 7)], axis=1, device="cpu",
                               method="scatter")
    assert profiling.HOST_SYNCS == before + 3


def test_threads_lose_no_call_and_keep_their_own_spans():
    n_threads, per_thread = 16, 300
    before_calls = profiling.CALLS
    before = dict(profiling.SELF_NS)
    errors = []

    def work():
        try:
            for _ in range(per_thread):
                with profiling.scope("t_thread_root", call=True):
                    with profiling.scope("t_thread_step"):
                        pass
            assert profiling._OPEN.spans == []
        except AssertionError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert profiling.CALLS == before_calls + n_threads * per_thread
    got = _delta(before)
    assert set(got) == {"t_thread_root", "t_thread_step"}
    assert all(v > 0 for v in got.values())


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_the_kernel_span_holds_its_launch_on_the_trace_s_clock(cuda, tmp_path):
    """The ``xhistogram.cuda_kernel`` range of a traced call contains the
    launch of the kernel it ran, and the kernel runs after it: the spans and
    the card's work lie on one clock."""
    rng = np.random.default_rng(7)
    t = torch.from_numpy(rng.normal(size=1 << 20).astype(np.float32)).to(cuda)
    s = torch.from_numpy(rng.normal(size=1 << 20).astype(np.float32)).to(cuda)
    edges = [np.linspace(-3, 3, 41), np.linspace(-3, 3, 31)]
    xhistogram_torch.histogram(t, s, bins=edges)  # build and warm
    torch.cuda.synchronize()
    with profiling.trace(tmp_path):
        xhistogram_torch.histogram(t, s, bins=edges)
        torch.cuda.synchronize()
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    [span] = [e for e in events if e.get("name") == "xhistogram.cuda_kernel"
              and e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in kernels]
    inside = [e for e in launches
              if span["ts"] <= e["ts"] and e["ts"] + e["dur"] <= span["ts"] + span["dur"]]
    assert inside, (span, launches)
    names = [kernels[e["args"]["correlation"]]["name"] for e in inside]
    assert any("joint2" in n for n in names), names
    for e in inside:
        assert kernels[e["args"]["correlation"]]["ts"] >= e["ts"]


def _syncs_reported(fn):
    """(what ``fn`` returned, the syncs ``torch.cuda.set_sync_debug_mode``
    reported while it ran, the change of ``HOST_SYNCS``)."""
    torch.cuda.synchronize()
    before = profiling.HOST_SYNCS
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    reported = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    return out, reported, profiling.HOST_SYNCS - before


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["levels_vol", "year_per_cell", "year_per_cell_scatter",
                                  "f64"])
def test_host_syncs_equal_what_the_sync_debug_mode_reports(cuda, case):
    """Small versions of the benchmark's calls: the README call per level
    by cell volume on the strided (time, depth, cell) view (the factored
    kernel: no sync), the labeled PDF per cell over time with more kept
    rows than the JAX package's ``plan()`` takes (the one_input kernel: no
    sync), the same call on the plain scatter path (``torch.bincount``
    reads its indices), and the exact float64 tier's reads."""
    g = torch.Generator(device=cuda).manual_seed(8)
    if case == "levels_vol":
        t = torch.randn((3, 4, 5000), device=cuda, generator=g) * 3 + 10
        s = torch.randn((3, 4, 5000), device=cuda, generator=g) * 0.5 + 35
        vol = torch.rand((4, 5000), device=cuda, generator=g)
        edges = [np.linspace(0, 20, 41).astype(np.float32),
                 np.linspace(33, 37, 31).astype(np.float32)]

        def fn():
            return xhistogram_torch.histogram(t, s, bins=edges, axis=(0, 2), weights=vol)
    elif case.startswith("year_per_cell"):
        sst = torch.randn((3, 512, 520), device=cuda, generator=g) * 8 + 15
        named = labeled.NamedArray(sst, ("time", "lat", "lon"), name="sst")
        edges = [np.linspace(-2, 38, 81).astype(np.float32)]
        method = "scatter" if case.endswith("scatter") else "auto"

        def fn():
            return labeled.histogram(named, bins=edges, dim=("time",), method=method)
    else:
        x = torch.randn((4, 3000), device=cuda, generator=g)
        w = torch.rand((4, 3000), device=cuda, generator=g, dtype=torch.float64)
        w[0, :5] = torch.tensor([1e-300, 1e300, 3.0, 2.0**-60, 7.0])

        def fn():
            return xhistogram_torch.histogram(x, bins=[np.linspace(-3, 3, 9)], axis=1,
                                              weights=w, precision="f64")
    fn()  # thresholds cached, kernels built
    _, reported, counted = _syncs_reported(fn)
    assert counted == reported
    assert (reported == 0) == (case in ("levels_vol", "year_per_cell"))


def _idle_tool():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "idle_by_span.py"
    spec = importlib.util.spec_from_file_location("idle_by_span", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_idle_gaps_go_to_the_innermost_open_span():
    """``tools/idle_by_span.py`` on a hand-made trace: two calls; the card
    idles under edges, under the kernel's launch, between the calls and
    after a kernel that outlasts the host's call (all in us)."""
    def rng(name, ts, dur):
        return {"ph": "X", "cat": "cpu_op", "name": f"xhistogram.{name}", "ts": ts,
                "dur": dur}

    def dev(cat, ts, dur):
        return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur}

    events = [
        rng("call", 0, 100), rng("edges", 5, 20), rng("cuda_kernel", 30, 60),
        dev("kernel", 0, 10), dev("kernel", 60, 70),  # idle 10-60: edges, cuda_kernel
        rng("call", 150, 40), rng("finish", 170, 10),
        dev("gpu_memset", 145, 20), dev("gpu_memcpy", 180, 5),
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 0, "dur": 300},
        {"ph": "X", "cat": "cpu_op", "name": "xhistogram::joint2", "ts": 35, "dur": 10},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "xhistogram.call", "ts": 0,
         "dur": 300},
    ]
    idle, split, busy, window = _idle_tool().idle_by_span(events)
    assert window == pytest.approx(190e-6)  # the first call's start to the last's end
    assert busy == pytest.approx((10 + 70 + 20 + 5) * 1e-6)
    # gaps: 10-60 (mid 35: cuda_kernel), 130-145 (mid 137.5: between calls),
    # 165-180 (mid 172.5: finish), 185-190 (mid 187.5: the second call)
    assert idle == pytest.approx({"xhistogram.cuda_kernel": 50e-6, "outside the program": 15e-6,
                                  "xhistogram.finish": 15e-6, "xhistogram.call": 5e-6})
    # cut at span edges: 10-25 edges, 25-30 call, 30-60 cuda_kernel; 130-145 outside;
    # 165-170 call, 170-180 finish; 185-190 call
    assert split == pytest.approx({"xhistogram.edges": 15e-6, "xhistogram.call": 15e-6,
                                   "xhistogram.cuda_kernel": 30e-6,
                                   "outside the program": 15e-6, "xhistogram.finish": 10e-6})
    assert sum(idle.values()) == pytest.approx(window - busy)
    assert sum(split.values()) == pytest.approx(window - busy)
