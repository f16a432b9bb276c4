"""The CUDA kernels (joint2, one_input, factored, direct) against their
plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import xhistogram_torch
from xhistogram_torch import bins as tbins
from xhistogram_torch.core import _compare_dtype
from xhistogram_torch.ops import cuda_hist
from xhistogram_torch.ops.bincount import weighted_dtype
from ts_cases import (
    BUCKET_EDGE_SETS, EDGE_SETS, S_EDGES, T_EDGES, bucket_case_values, edge_case_data,
    edge_case_values, numpy_hist2d, reference_numpy, ts_data,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _thresholds(edges, device):
    ce = tbins.compare_form(edges, np.float32)
    assert ce.n_hi_clip == 0
    return torch.from_numpy(ce.edges).to(device)


def _kernel_and_plain(t, s, te, se, device):
    """(kernel counts, plain counts) on the card for the same inputs."""
    ta, tb = _thresholds(te, device), _thresholds(se, device)
    nba, nbb = len(te) - 1, len(se) - 1
    before = cuda_hist.JOINT2_LAUNCHES
    got = cuda_hist.joint2(t, s, ta, tb, nba, nbb)
    torch.cuda.synchronize()
    assert cuda_hist.JOINT2_LAUNCHES == before + (1 if t.numel() else 0)
    want = cuda_hist.joint2_reference(t, s, ta, tb, nba, nbb)
    assert got.device == t.device and got.dtype == torch.int64
    return got.cpu(), want.cpu()


@pytest.mark.parametrize("name", list(EDGE_SETS))
def test_edge_cases(cuda, name):
    te, se = EDGE_SETS[name]
    t, s = edge_case_data(te, se, n_random=10_000)
    got, want = _kernel_and_plain(
        torch.from_numpy(t).to(cuda), torch.from_numpy(s).to(cuda), te, se, cuda
    )
    assert torch.equal(got, want)
    nba, nbb = len(te) - 1, len(se) - 1
    np.testing.assert_array_equal(
        got[0, :-1].reshape(nba, nbb).numpy(), numpy_hist2d(t, s, te, se)
    )


def test_negative_subnormal_is_below_a_zero_edge(cuda):
    te = np.array([0.0, 1.0])
    t = torch.tensor([-1e-45, 1e-45, -0.0, 0.0], device=cuda)
    s = torch.full((4,), 0.5, device=cuda)
    got, _ = _kernel_and_plain(t, s, te, te, cuda)
    assert got.tolist() == [[3, 0]]


@pytest.mark.parametrize("n", [0, 1, 7, 4097, (1 << 20) + 3, 1 << 24])
def test_ragged_sizes_and_views(cuda, n):
    t_np, s_np = ts_data((n,), seed=n)
    t, s = torch.from_numpy(t_np).to(cuda), torch.from_numpy(s_np).to(cuda)
    for view in (lambda x: x, lambda x: x.reshape(1, n)):
        got, want = _kernel_and_plain(view(t), view(s), T_EDGES, S_EDGES, cuda)
        assert torch.equal(got, want)
    if n:  # a strided view is copied first, with the same counts
        got, want = _kernel_and_plain(t[::2], s[::2], T_EDGES, S_EDGES, cuda)
        assert torch.equal(got, want)


def test_alternating_grid_sizes(cuda):
    # each grid needs its own shared-memory size; the launcher's cached
    # launch shape must follow every switch
    t_np, s_np = ts_data((1 << 16,), seed=5)
    t, s = torch.from_numpy(t_np).to(cuda), torch.from_numpy(s_np).to(cuda)
    small = (np.linspace(-2, 30, 9), np.linspace(30, 40, 10))
    for te, se in (small, (T_EDGES, S_EDGES), small, (T_EDGES, S_EDGES)):
        got, want = _kernel_and_plain(t, s, te, se, cuda)
        assert torch.equal(got, want)


def test_auto_on_a_strided_full_reduction(cuda):
    t_np, s_np = ts_data((64, 4096), seed=4)
    t, s = torch.from_numpy(t_np).to(cuda), torch.from_numpy(s_np).to(cuda)
    before = cuda_hist.JOINT2_LAUNCHES
    h, _ = xhistogram_torch.histogram(
        t[:, :1000], s[:, :1000], bins=[T_EDGES, S_EDGES]
    )
    assert cuda_hist.JOINT2_LAUNCHES == before + 1
    np.testing.assert_array_equal(
        h.cpu().numpy(),
        numpy_hist2d(t_np[:, :1000], s_np[:, :1000], T_EDGES, S_EDGES),
    )


def test_auto_runs_the_kernel_on_the_main_path(cuda):
    t_np, s_np = ts_data((64, 4096), seed=3)
    before = cuda_hist.JOINT2_LAUNCHES
    h, _ = xhistogram_torch.histogram(
        torch.from_numpy(t_np).to(cuda), torch.from_numpy(s_np).to(cuda),
        bins=[T_EDGES, S_EDGES],
    )
    assert cuda_hist.JOINT2_LAUNCHES == before + 1
    assert h.device.type == "cuda" and h.dtype == torch.int64
    np.testing.assert_array_equal(
        h.cpu().numpy(), numpy_hist2d(t_np, s_np, T_EDGES, S_EDGES)
    )


def test_auto_routing_outside_the_kernel(cuda):
    x = torch.linspace(0, 2, 1000, device=cuda)
    e = np.array([0.0, 1.0, 2.0])
    # one input and float64 pairs now run their kernels
    before = cuda_hist.ONE_INPUT_LAUNCHES, cuda_hist.JOINT2_LAUNCHES
    h, _ = xhistogram_torch.histogram(x, bins=[e])
    assert h.cpu().tolist() == [500, 500]
    h, _ = xhistogram_torch.histogram(x.double(), x.double(), bins=[e, e])
    assert h.cpu().tolist() == [[500, 0], [0, 500]]
    assert (cuda_hist.ONE_INPUT_LAUNCHES, cuda_hist.JOINT2_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    # int64 beside a float: each compared in its own type, through joint2
    before = cuda_hist.JOINT2_LAUNCHES
    h, _ = xhistogram_torch.histogram(x.long(), x, bins=[e, e])
    assert h.cpu().tolist() == [[500, 0], [0, 500]]
    assert cuda_hist.JOINT2_LAUNCHES == before + 1
    # uint64 runs flipped onto int64: an edge at 2^64 is past the top value,
    # so the JAX package's auto gate runs scatter, and so here; below it
    # one_input runs
    u = torch.tensor([0, 1, 2**63, 2**64 - 1], dtype=torch.uint64, device=cuda)
    before = cuda_hist.ONE_INPUT_LAUNCHES
    h, _ = xhistogram_torch.histogram(u, bins=[np.array([0.0, 2.0**63, 2.0**64])])
    assert h.cpu().tolist() == [2, 2] and cuda_hist.ONE_INPUT_LAUNCHES == before
    u = torch.tensor([0, 1, 2**63, 2**64 - 5000], dtype=torch.uint64, device=cuda)
    h, _ = xhistogram_torch.histogram(u, bins=[np.array([0.0, 2.0**63, 2.0**64 - 4096])])
    assert h.cpu().tolist() == [2, 2] and cuda_hist.ONE_INPUT_LAUNCHES == before + 1
    # a +inf top edge: the JAX package's auto gate runs scatter, and so here
    before = cuda_hist.ONE_INPUT_LAUNCHES, cuda_hist.JOINT2_LAUNCHES
    h, _ = xhistogram_torch.histogram(x, x, bins=[np.array([0.0, np.inf]), e])
    assert h.device.type == "cuda" and h.cpu().tolist() == [[500, 500]]
    h, _ = xhistogram_torch.histogram(x, bins=[np.array([0.0, np.inf])])
    assert h.cpu().tolist() == [1000]
    assert (cuda_hist.ONE_INPUT_LAUNCHES, cuda_hist.JOINT2_LAUNCHES) == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.int64, torch.float16],
                         ids=str)
def test_joint2_other_dtypes(cuda, dtype):
    t_np, s_np = ts_data((1 << 20,), seed=6)
    if dtype.is_floating_point:
        t, s = (torch.from_numpy(x).to(cuda, dtype) for x in (t_np, s_np))
        te, se = T_EDGES, S_EDGES
    else:
        scale = 2**40 if dtype == torch.int64 else 64
        t, s = (torch.from_numpy(x * 64).to(cuda).to(dtype) * (scale // 64)
                for x in (t_np, s_np))
        te, se = T_EDGES * scale + 0.5, S_EDGES * scale
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    ta, tb = (torch.from_numpy(tbins.compare_form(e, np_dtype).edges).to(cuda)
              for e in (te, se))
    before = cuda_hist.JOINT2_LAUNCHES
    got = cuda_hist.joint2(t, s, ta, tb, 280, 340)
    want = cuda_hist.joint2_reference(t, s, ta, tb, 280, 340)
    assert cuda_hist.JOINT2_LAUNCHES == before + 1
    assert torch.equal(got, want)


# --- one_input ----------------------------------------------------------------


def _one_input_pair(x2d, edges, reduce_all):
    """(kernel counts, plain counts) on the card for one (m, c) layout."""
    nb = len(edges) - 1
    ce = tbins.compare_form(edges, _compare_dtype(x2d))
    assert ce.n_hi_clip == 0
    thr = torch.from_numpy(ce.edges).to(x2d.device)
    before = cuda_hist.ONE_INPUT_LAUNCHES
    got = cuda_hist.one_input(x2d, thr, nb, reduce_all)
    torch.cuda.synchronize()
    assert cuda_hist.ONE_INPUT_LAUNCHES == before + (1 if x2d.numel() else 0)
    want = cuda_hist.one_input_reference(x2d, thr, nb, reduce_all)
    assert got.device == x2d.device and got.dtype == torch.int64
    assert got.shape == (1 if reduce_all else x2d.shape[0], nb + 1)
    return got.cpu(), want.cpu()


def _edges(nb):
    return np.linspace(-3.0, 3.0, nb + 1)


@pytest.mark.parametrize("which", [0, 1], ids=["first", "second"])
@pytest.mark.parametrize("name", list(EDGE_SETS))
def test_one_input_edge_cases(cuda, name, which):
    edges = np.asarray(EDGE_SETS[name][which])
    x_np = edge_case_values(edges, n_random=10_000, seed=which)
    x = torch.from_numpy(x_np).to(cuda)
    got, want = _one_input_pair(x.reshape(1, -1), edges, True)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got[0, :-1].numpy(), reference_numpy(x_np, edges))
    rows = torch.stack([x, x.flip(0)])
    for layout in (rows, rows.t().contiguous().t()):  # contiguous and strided
        got, want = _one_input_pair(layout, edges, False)
        assert torch.equal(got, want)


def test_one_input_negative_subnormal_is_below_a_zero_edge(cuda):
    x = torch.tensor([[-1e-45, 1e-45, -0.0, 0.0]], device=cuda)
    got, _ = _one_input_pair(x, np.array([0.0, 1.0]), True)
    assert got.tolist() == [[3, 0]]


@pytest.mark.parametrize("n", [0, 1, 7, 4097, (1 << 20) + 3, 1 << 24])
def test_one_input_ragged_sizes(cuda, n):
    x = torch.from_numpy(ts_data((n,), seed=n)[0] - 14.0).to(cuda) / 8
    for layout, reduce_all in ((x.reshape(1, n), True), (x.reshape(1, n), False)):
        got, want = _one_input_pair(layout, _edges(50), reduce_all)
        assert torch.equal(got, want)
    if n > 1:  # a strided full reduction is read in place
        got, want = _one_input_pair(x[::2].reshape(1, -1), _edges(50), True)
        assert torch.equal(got, want)


@pytest.mark.parametrize("nb", [1, 50, 64, 1024])
@pytest.mark.parametrize("c", [1, 7, 365, 100_000])
def test_one_input_kept_rows(cuda, c, nb):
    m = max(1, min(4096, (1 << 22) // c))
    gen = torch.Generator(device=cuda).manual_seed(c + nb)
    x = 1.5 * torch.randn(m, c, device=cuda, generator=gen)
    x[::7, ::3] = float("nan")
    strided = torch.randn(c, m, device=cuda, generator=gen).t()  # strides (1, m)
    for layout in (x, strided):
        for reduce_all in (False, True):
            got, want = _one_input_pair(layout, _edges(nb), reduce_all)
            assert torch.equal(got, want), (layout.stride(), reduce_all)


@pytest.mark.parametrize(
    "dtype", [torch.float32, torch.float64, torch.int32, torch.int64, torch.float16],
    ids=str,
)
def test_one_input_dtypes(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(1 << 24, device=cuda, generator=gen, dtype=torch.float64)
    if dtype.is_floating_point:
        x, edges = x.to(dtype), _edges(50)
    elif dtype == torch.int32:
        x, edges = (x * 2000).to(dtype), np.linspace(-3000.5, 3000.5, 51)
    else:
        x, edges = (x * 2.0**43).to(dtype), np.linspace(-(2.0**44), 2.0**44, 51)
    for layout, reduce_all in ((x.reshape(1, -1), True), (x.reshape(4096, -1), False),
                               (x.reshape(-1, 4096).t(), False)):
        got, want = _one_input_pair(layout, edges, reduce_all)
        assert torch.equal(got, want), (dtype, layout.stride())


def test_one_input_alternating_shapes(cuda):
    # each kernel instantiation keeps its own launch shape; switching the
    # type, the bin count, the layout and full/kept must never reuse another's
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(512, 700, device=cuda, generator=gen)
    cases = [
        (x, 50, True), (x.double(), 1024, False), (x.t(), 64, False),
        ((x * 1000).int(), 1, True), ((x * 1000).long(), 50, False),
        (x, 1024, True), (x.t(), 50, True), (x.half(), 64, False),
    ]
    for layout, nb, reduce_all in cases + cases[::-1]:
        edges = _edges(nb) * (1000 if not layout.is_floating_point() else 1)
        got, want = _one_input_pair(layout, edges, reduce_all)
        assert torch.equal(got, want), (layout.dtype, nb, reduce_all)


def test_auto_runs_the_one_input_kernel(cuda):
    rng = np.random.default_rng(12)
    x_np = rng.normal(20.0, 5.0, (36, 18, 24)).astype(np.float32)
    edges = np.linspace(0, 40, 81)
    for axis in (None, (1, 2), (0,)):  # full, rows, config 4's strided rows
        before = cuda_hist.ONE_INPUT_LAUNCHES
        h, _ = xhistogram_torch.histogram(torch.from_numpy(x_np).to(cuda),
                                          bins=[edges], axis=axis)
        assert cuda_hist.ONE_INPUT_LAUNCHES == before + 1
        assert h.device.type == "cuda" and h.dtype == torch.int64
        np.testing.assert_array_equal(h.cpu().numpy(), reference_numpy(x_np, edges, axis))
    # numpy inputs run on the card by default
    before = cuda_hist.ONE_INPUT_LAUNCHES
    h, _ = xhistogram_torch.histogram(x_np, bins=[edges])
    assert h.device.type == "cuda" and cuda_hist.ONE_INPUT_LAUNCHES == before + 1
    h_cpu, _ = xhistogram_torch.histogram(x_np, bins=[edges], device="cpu")
    assert h_cpu.device.type == "cpu" and torch.equal(h.cpu(), h_cpu)
    with pytest.raises(ValueError, match="conflicts with an input tensor"):
        xhistogram_torch.histogram(torch.from_numpy(x_np), bins=[edges], device="cuda")


# --- factored and direct (csrc/slot.cuh) ---------------------------------------

ROUTES = ("full", "per_row", "packed", "direct")


def _launches():
    return (*cuda_hist.FACTORED_LAUNCHES.values(), cuda_hist.DIRECT_LAUNCHES)


def _slot_pair(layouts, edges, route):
    """(kernel counts, plain counts) on the card for N (m, c) layouts, one
    route (a variant of factored, or direct)."""
    thr, nbins = [], []
    for x, e in zip(layouts, edges):
        ce = tbins.compare_form(np.asarray(e), _compare_dtype(x))
        assert ce.n_hi_clip == 0
        thr.append(torch.from_numpy(ce.edges).to(x.device))
        nbins.append(len(e) - 1)
    before = _launches()
    if route == "direct":
        got = cuda_hist.direct(layouts, thr, nbins)
        want = cuda_hist.direct_reference(layouts, thr, nbins)
    else:
        got = cuda_hist.factored(layouts, thr, nbins, route)
        want = cuda_hist.factored_reference(layouts, thr, nbins, route)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_launches(), before)]
    assert launched == [int(r == route and layouts[0].numel() > 0) for r in ROUTES]
    assert got.dtype == torch.int64 and got.device == layouts[0].device
    rows = 1 if route == "full" else layouts[0].shape[0]
    assert got.shape == (rows, int(np.prod(nbins)) + 1)
    return got.cpu(), want.cpu()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(EDGE_SETS))
def test_slot_edge_cases(cuda, name, route):
    te, se = EDGE_SETS[name]
    t, s = (x[: len(x) // 2 * 2] for x in edge_case_data(te, se, n_random=10_000))
    third = np.full_like(t, 0.5)
    layouts = [torch.from_numpy(x).to(cuda).reshape(2, -1) for x in (t, s, third)]
    got, want = _slot_pair(layouts, [te, se, [0.0, 0.25, 1.0]], route)
    assert torch.equal(got, want)
    if route == "full":
        expected = numpy_hist2d(t, s, te, se)
        np.testing.assert_array_equal(
            got[0, :-1].reshape(len(te) - 1, len(se) - 1, 2).sum(-1).numpy(), expected
        )


@pytest.mark.parametrize("route", ROUTES)
def test_slot_negative_subnormal_is_below_a_zero_edge(cuda, route):
    t = torch.tensor([[-1e-45, 1e-45, -0.0, 0.0]], device=cuda)
    got, _ = _slot_pair([t, torch.full_like(t, 0.5)], [[0.0, 1.0]] * 2, route)
    assert got.tolist() == [[3, 0]]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("m,c", [(0, 5), (5, 0), (1, 1), (7, 1), (3, 4097),
                                 (1, (1 << 20) + 3), (4099, 3)])
def test_slot_ragged_sizes(cuda, route, m, c):
    gen = torch.Generator(device=cuda).manual_seed(m + c)
    layouts = [torch.randn(m, c, device=cuda, generator=gen) for _ in range(2)]
    got, want = _slot_pair(layouts, [_edges(50), _edges(30)], route)
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("nbins", [(239, 239), (240, 240), (4, 5, 6), (1500, 1500)],
                         ids=str)
def test_slot_counts_around_the_shared_memory_limit(cuda, route, nbins):
    # 57,121 and 57,600 slots, either side of what one block held beside
    # the thresholds alone: beside their cell tables both now take a
    # cluster of two; 2.25M slots go past eight blocks, to device memory,
    # and beyond the full-reduction cap of plan()
    m, c = (3, 1 << 18) if route != "packed" else (40, 64)
    gen = torch.Generator(device=cuda).manual_seed(sum(nbins))
    layouts = [torch.randn(m, c, device=cuda, generator=gen) for _ in nbins]
    got, want = _slot_pair(layouts, [_edges(nb) for nb in nbins], route)
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ROUTES)
def test_slot_global_histogram_equals_shared(cuda, route, monkeypatch):
    gen = torch.Generator(device=cuda).manual_seed(9)
    layouts = [torch.randn(64, 3000, device=cuda, generator=gen) for _ in range(2)]
    edges = [_edges(150), _edges(90)]
    shared, _ = _slot_pair(layouts, edges, route)
    monkeypatch.setattr(cuda_hist, "MAX_SHARED_SLOTS", 0)
    in_global, want = _slot_pair(layouts, edges, route)
    assert torch.equal(shared, want) and torch.equal(in_global, want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize(
    "dtypes",
    [(torch.float64,) * 2, (torch.int32,) * 2, (torch.int64,) * 2,
     (torch.float16,) * 2, (torch.float32, torch.float64),
     (torch.int32, torch.float32), (torch.int32, torch.int64)],
    ids=str,
)
def test_slot_dtypes(cuda, route, dtypes):
    gen = torch.Generator(device=cuda).manual_seed(7)
    layouts, edges = [], []
    for dtype in dtypes:
        x = torch.randn(128, 4096, device=cuda, generator=gen, dtype=torch.float64)
        if dtype.is_floating_point:
            layouts.append(x.to(dtype))
            edges.append(_edges(40))
        elif dtype == torch.int32:
            layouts.append((x * 2000).to(dtype))
            edges.append(np.linspace(-3000.5, 3000.5, 41))
        else:
            layouts.append((x * 2.0**43).to(dtype))
            edges.append(np.linspace(-(2.0**44), 2.0**44, 41))
    got, want = _slot_pair(layouts, edges, route)
    assert torch.equal(got, want)


MIXED_KERNELS = ("joint2", "joint2-reversed", *ROUTES)


@pytest.mark.parametrize("wdtype", [None, torch.float32, torch.int32], ids=str)
@pytest.mark.parametrize("float_dtype", [torch.float32, torch.float64, torch.float16],
                         ids=str)
@pytest.mark.parametrize("kernel", MIXED_KERNELS)
def test_int64_beside_a_float_equals_plain(cuda, kernel, float_dtype, wdtype):
    # no common compare type: each input compares in its own, through the
    # kernels' mixed entries, bit for bit (weighted float sums within one
    # float32 rounding) against the plain versions; the kernel's counter rises
    rows = {"joint2": 1, "joint2-reversed": 1, "full": 1, "per_row": 8,
            "packed": 64, "direct": 64}[kernel]
    gen = torch.Generator(device=cuda).manual_seed(len(kernel))
    big = torch.randint(-(2**45), 2**45, (rows, (1 << 18) // rows), device=cuda,
                        generator=gen)
    big[0, :3] = torch.tensor([2**45 - 1, -(2**45), 0])
    f = (1.5 * torch.randn(big.shape, device=cuda, generator=gen)).to(float_dtype)
    f[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    e_int = np.linspace(-(2.0**45), 2.0**45, 91) + 0.5
    e_float = _edges(40)
    layouts, edges = [big, f], [e_int, e_float]
    if kernel == "joint2-reversed":
        layouts, edges, kernel = layouts[::-1], edges[::-1], "joint2"
    w = None if wdtype is None else _weights(big.shape, wdtype, cuda, seed=2)
    before = _launch_counts()
    got = _run(kernel, layouts, edges, w, plain=False)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_launch_counts(), before)]
    assert launched == [int(i == (0 if kernel == "joint2" else 2 + ROUTES.index(kernel)))
                        for i in range(len(launched))]
    want = _run(kernel, layouts, edges, w, plain=True)
    if w is None:
        assert got.dtype == torch.int64 and torch.equal(got, want)
    else:
        _assert_sums_equal(got, want)


@pytest.mark.parametrize("route", ROUTES)
def test_slot_strided_and_broadcast_views(cuda, route):
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn(300, 500, device=cuda, generator=gen)
    row = torch.randn(1, 500, device=cuda, generator=gen).expand(300, 500)
    col = torch.randn(300, 1, device=cuda, generator=gen, dtype=torch.float64)
    col = col.expand(300, 500)  # a broadcast of another dtype: widened in place
    for layouts in ([a, row], [a.t().contiguous().t(), col], [a[:, ::2], row[:, ::2]],
                    [row, col, a]):
        got, want = _slot_pair(layouts, [_edges(20), _edges(30), _edges(10)][:len(layouts)],
                               route)
        assert torch.equal(got, want), [x.stride() for x in layouts]


@pytest.mark.parametrize("route", ROUTES)
def test_slot_thresholds_beyond_shared_memory(cuda, route):
    # 30,001 float64 thresholds (240 KB) are searched in device memory
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(8, 1 << 16, device=cuda, generator=gen, dtype=torch.float64)
    edges = np.sort(np.random.default_rng(5).normal(0, 1.5, 30_001))
    got, want = _slot_pair([x], [edges], route)
    assert torch.equal(got, want)


def test_slot_many_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    layouts = [torch.randn(16, 777, device=cuda, generator=gen) for _ in range(6)]
    for route in ROUTES:
        got, want = _slot_pair(layouts, [_edges(4)] * 6, route)
        assert torch.equal(got, want)


def test_slot_alternating_shapes(cuda):
    # the launch-shape cache must follow switches of type, slots and mode
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(64, 4096, device=cuda, generator=gen)
    cases = [([x, x], (150, 90), "per_row"), ([x.double(), x.double()], (300, 300), "full"),
             ([x[:, :60], x[:, :60]], (40, 40), "direct"), ([x, x, x], (20, 25, 20), "packed"),
             ([(x * 100).int()], (3000,), "full")]
    for layouts, nbins, route in cases + cases[::-1]:
        scale = 100 if not layouts[0].is_floating_point() else 1
        got, want = _slot_pair(layouts, [_edges(nb) * scale for nb in nbins], route)
        assert torch.equal(got, want), (nbins, route)


@pytest.mark.parametrize(
    "shape,nbins,axis,kernel",
    [((4, 3000), (150, 90), (1,), "factored_per_row"),
     ((6, 4, 500), (280, 340), (0, 2), "factored_per_row"),
     ((64, 64), (120, 90), (1,), "factored_packed"),
     ((256, 64), (40, 40), (1,), "direct"),
     ((1 << 16,), (1000, 1000), None, "factored"),
     ((1 << 16,), (100, 100, 50), None, "factored"),
     ((1 << 16,), (5000,), None, "factored")],
    ids=str,
)
def test_auto_runs_factored_and_direct(cuda, shape, nbins, axis, kernel):
    rng = np.random.default_rng(len(nbins) + shape[0])
    args = [rng.normal(0, 1.5, shape).astype(np.float32) for _ in nbins]
    bins = [_edges(nb) for nb in nbins]
    variant = {"factored": "full", "factored_per_row": "per_row",
               "factored_packed": "packed"}.get(kernel)
    before = _launches()
    h, _ = xhistogram_torch.histogram(*(torch.from_numpy(a).to(cuda) for a in args),
                                      bins=bins, axis=axis)
    launched = [a - b for a, b in zip(_launches(), before)]
    assert launched == [int(r == (variant or "direct")) for r in ROUTES]
    h_cpu, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, device="cpu")
    assert h.device.type == "cuda" and torch.equal(h.cpu(), h_cpu)


def test_forced_beyond_the_caps(cuda):
    # a full reduction over 2^21 slots, and kept rows over 8192 slots with
    # more thresholds than plan() takes: plan() names no kernel, the forced
    # route runs factored and direct
    rng = np.random.default_rng(4)
    args = [rng.normal(0, 1.5, 1 << 18).astype(np.float32) for _ in range(3)]
    bins = [_edges(130)] * 3
    assert cuda_hist.plan(3, (130,) * 3, 1) is None
    x = rng.normal(0, 1.5, (16, 100)).astype(np.float32)
    edges = np.linspace(-4, 4, 33_001)
    assert cuda_hist.plan(1, (33_000,), 16, 100) is None
    for call, route in (
        (lambda dev: xhistogram_torch.histogram(*args, bins=bins, device=dev,
                                                method="cuda"), "full"),
        (lambda dev: xhistogram_torch.histogram(x, bins=[edges], axis=1, device=dev,
                                                method="cuda"), "direct"),
    ):
        before = _launches()
        h, _ = call(cuda)
        launched = [a - b for a, b in zip(_launches(), before)]
        assert launched == [int(r == route) for r in ROUTES]
        h_cpu, _ = call("cpu")
        assert torch.equal(h.cpu(), h_cpu)


# --- weighted (csrc/weights.cuh), every kernel -----------------------------------

WEIGHT_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
                 torch.int32, torch.uint32, torch.int16, torch.uint16, torch.int8,
                 torch.uint8, torch.bool, torch.int64, torch.uint64]
KERNELS = ("joint2", "one_input_full", "one_input_rows", *ROUTES)


def _launch_counts():
    return (cuda_hist.JOINT2_LAUNCHES, cuda_hist.ONE_INPUT_LAUNCHES, *_launches())


def _weights(shape, dtype, device, seed):
    """Random weights of ``dtype``: floats in [-1, 3), int32 spanning ±2^30
    (the sums wrap), 64-bit integers beyond 2^32, the rest over their whole
    range."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.rand(shape, device=device, generator=gen) * 4 - 1).to(dtype)
    if dtype == torch.bool:
        return torch.rand(shape, device=device, generator=gen) < 0.5
    if dtype in (torch.int64, torch.uint64):
        w = torch.randint(-(2**62), 2**62, shape, device=device, generator=gen)
        return w.view(dtype)
    lo, hi = {torch.int32: (-(2**30), 2**30), torch.uint32: (0, 2**32),
              torch.int16: (-(2**15), 2**15), torch.uint16: (0, 2**16),
              torch.int8: (-128, 128), torch.uint8: (0, 256)}[dtype]
    return torch.randint(lo, hi, shape, device=device, generator=gen).to(dtype)


def _run(kernel, layouts, edges, weights, plain):
    """One kernel (or its plain version) on the card with weights."""
    thr = []
    for x, e in zip(layouts, edges):
        ce = tbins.compare_form(np.asarray(e), _compare_dtype(x))
        assert ce.n_hi_clip == 0
        thr.append(torch.from_numpy(ce.edges).to(x.device))
    nbins = [len(e) - 1 for e in edges]
    if kernel == "joint2":
        fn = cuda_hist.joint2_reference if plain else cuda_hist.joint2
        return fn(*layouts, *thr, *nbins, weights=weights)
    if kernel.startswith("one_input"):
        fn = cuda_hist.one_input_reference if plain else cuda_hist.one_input
        return fn(layouts[0], thr[0], nbins[0], kernel == "one_input_full",
                  weights=weights)
    if kernel == "direct":
        fn = cuda_hist.direct_reference if plain else cuda_hist.direct
        return fn(layouts, thr, nbins, weights=weights)
    fn = cuda_hist.factored_reference if plain else cuda_hist.factored
    return fn(layouts, thr, nbins, kernel, weights=weights)


def _assert_sums_equal(got, want, exact=False):
    """Integer sums bit for bit; float sums (float64 adds in atomic order,
    rounded once) within one float32 rounding of each other, with NaN and
    infinities in the same bins."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.uint64:
        got, want = got.view(torch.int64), want.view(torch.int64)
    if exact or not got.dtype.is_floating_point:
        assert torch.equal(got.cpu(), want.cpu())
    elif got.dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-9, equal_nan=True)
    else:
        torch.testing.assert_close(got, want, rtol=3e-7, atol=1e-5, equal_nan=True)


def _weighted_pair(kernel, layouts, edges, weights, exact=False):
    """Runs kernel and plain version on the card, checks the launch count
    and the sums."""
    before = _launch_counts()
    got = _run(kernel, layouts, edges, weights, plain=False)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_launch_counts(), before)]
    slot = {"joint2": 0, "one_input_full": 1, "one_input_rows": 1}.get(
        kernel, 2 + ROUTES.index(kernel) if kernel in ROUTES else None)
    nonempty = int(layouts[0].numel() > 0)
    assert launched == [nonempty * (i == slot) for i in range(len(launched))]
    want = _run(kernel, layouts, edges, weights, plain=True)
    assert got.dtype == weighted_dtype(weights.dtype)
    _assert_sums_equal(got, want, exact)
    return got


def _layouts(kernel, m, c, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    n = 1 if kernel.startswith("one_input") else 2
    return [1.5 * torch.randn(m, c, device=device, generator=gen) for _ in range(n)]


@pytest.mark.parametrize("dtype", WEIGHT_DTYPES, ids=str)
@pytest.mark.parametrize("kernel", KERNELS)
def test_weighted_kernel_equals_plain(cuda, kernel, dtype):
    m, c = (16, 1 << 14) if kernel != "packed" else (256, 64)
    layouts = _layouts(kernel, m, c, cuda, seed=len(kernel))
    layouts[0][::5, ::7] = float("nan")
    edges = [_edges(50), _edges(40)][: len(layouts)]
    if kernel == "joint2":  # the T-S grid in four float64 chunks
        layouts = [14.0 + 8.0 * layouts[0], 35.0 + 1.5 * layouts[1]]
        edges = [T_EDGES, S_EDGES]
    _weighted_pair(kernel, layouts, edges, _weights((m, c), dtype, cuda, seed=3))


@pytest.mark.parametrize("kernel", KERNELS)
def test_weighted_integer_valued_floats_bit_equal(cuda, kernel):
    m, c = 32, 1 << 13
    layouts = _layouts(kernel, m, c, cuda, seed=5)
    w = torch.randint(-100, 100, (m, c), device=cuda).float()
    _weighted_pair(kernel, layouts, [_edges(30), _edges(20)][: len(layouts)], w,
                   exact=True)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("m,c", [(0, 5), (5, 0), (1, 1), (7, 1), (3, 4097),
                                 (1, (1 << 20) + 3), (4099, 3)])
def test_weighted_ragged_sizes(cuda, kernel, m, c):
    layouts = _layouts(kernel, m, c, cuda, seed=m + c)
    for dtype in (torch.float32, torch.int32, torch.int64):
        _weighted_pair(kernel, layouts, [_edges(50), _edges(30)][: len(layouts)],
                       _weights((m, c), dtype, cuda, seed=m * c))


@pytest.mark.parametrize("kernel", KERNELS)
def test_weighted_strided_and_broadcast_weights(cuda, kernel):
    m, c = 300, 500
    layouts = _layouts(kernel, m, c, cuda, seed=7)
    edges = [_edges(20), _edges(30)][: len(layouts)]
    w = _weights((m, c), torch.float32, cuda, seed=8)
    row = _weights((1, c), torch.float32, cuda, seed=9).expand(m, c)  # stride 0
    col = _weights((m, 1), torch.int32, cuda, seed=10).expand(m, c)
    for weights in (w.t().contiguous().t(), row, col, w[:, ::2]):
        views = [x[:, ::2] for x in layouts] if weights.shape[1] != c else layouts
        _assert_sums_equal(_weighted_pair(kernel, views, edges, weights),
                           _weighted_pair(kernel, views, edges, weights.contiguous()))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("nb", [169, 170, 239, 240])
def test_weighted_slot_counts_around_the_shared_memory_limit(cuda, route, nb):
    # either side of what one block held of 8-byte sums (169^2 = 28,561)
    # and of 32-bit ones (239^2) beside the thresholds alone: beside their
    # cell tables uint64 and uint32 sums take clusters of two or four,
    # float64 sums add in device memory
    m, c = (3, 1 << 17) if route != "packed" else (40, 64)
    layouts = _layouts(route, m, c, cuda, seed=nb)
    for dtype in (torch.float32, torch.int32, torch.int64):
        _weighted_pair(route, layouts, [_edges(nb)] * 2,
                       _weights((m, c), dtype, cuda, seed=nb))


@pytest.mark.parametrize("route", ROUTES)
def test_weighted_global_histogram_equals_shared(cuda, route, monkeypatch):
    layouts = _layouts(route, 64, 3000, cuda, seed=11)
    edges = [_edges(150), _edges(90)]
    for dtype in (torch.float32, torch.int32, torch.uint64):
        w = _weights((64, 3000), dtype, cuda, seed=12)
        shared = _weighted_pair(route, layouts, edges, w)
        monkeypatch.setattr(cuda_hist, "MAX_SHARED_SLOTS", 0)
        in_global = _weighted_pair(route, layouts, edges, w)
        monkeypatch.undo()
        _assert_sums_equal(shared, in_global)


@pytest.mark.parametrize("kernel", KERNELS)
def test_weighted_nonfinite(cuda, kernel):
    """NaN makes its own bin NaN, +inf and -inf together make it NaN, one
    infinity makes it that infinity; NaN data drop their weight."""
    m, c = 8, 4096
    layouts = _layouts(kernel, m, c, cuda, seed=13)
    layouts[0][:, ::11] = float("nan")
    w = _weights((m, c), torch.float32, cuda, seed=14)
    w[:, ::11] = float("nan")  # on NaN data: never added
    # row 0, columns 1-5: bins 0-3 of the first input (the others' bin 3)
    # take NaN, +inf, -inf, and +inf with -inf
    layouts[0][0, 1:6] = torch.tensor([-2.625, -1.875, -1.125, -0.375, -0.375])
    for x in layouts[1:]:
        x[0, 1:6] = 0.25
    inf = float("inf")
    w[0, 1:6] = torch.tensor([float("nan"), inf, -inf, inf, -inf])
    got = _weighted_pair(kernel, layouts, [_edges(8), _edges(6)][: len(layouts)], w)
    assert got.isnan().any() and got.isposinf().any() and got.isneginf().any()


@pytest.mark.parametrize(
    "shape,nbins,axis,wdtype,kernel",
    [((4, 3000), (50,), (1,), torch.float32, "one_input"),
     ((1 << 16,), (280, 340), None, torch.float32, "joint2"),
     ((1 << 16,), (280, 340), None, torch.int16, "joint2"),
     ((6, 4, 500), (280, 340), (0, 2), torch.float32, "factored_per_row"),
     ((1 << 16,), (60, 60, 60), None, torch.float32, "factored"),
     ((1000, 64), (40, 40), (1,), torch.float32, "direct"),
     ((2000, 64), (40, 40), (1,), torch.int32, "direct"),
     ((64, 64), (120, 90), (1,), torch.int32, "factored_packed")],
    ids=str,
)
def test_auto_runs_the_weighted_kernels(cuda, shape, nbins, axis, wdtype, kernel):
    rng = np.random.default_rng(len(nbins) + shape[0])
    args = [rng.normal(0, 1.5, shape).astype(np.float32) for _ in nbins]
    w = _weights(shape, wdtype, "cpu", seed=16)
    bins = [_edges(nb) for nb in nbins]
    counters = {"joint2": 0, "one_input": 1, "factored": 2, "factored_per_row": 3,
                "factored_packed": 4, "direct": 5}
    before = _launch_counts()
    h, _ = xhistogram_torch.histogram(*(torch.from_numpy(a).to(cuda) for a in args),
                                      bins=bins, axis=axis, weights=w.to(cuda))
    launched = [a - b for a, b in zip(_launch_counts(), before)]
    assert launched == [int(i == counters[kernel]) for i in range(len(launched))]
    h_cpu, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=w,
                                          device="cpu")
    _assert_sums_equal(h.cpu(), h_cpu)
    # where the JAX package runs scatter (float weights, 64,800 rows of
    # 40x40), the port does too
    if kernel == "direct" and wdtype == torch.int32:
        big = [rng.normal(0, 1.5, (64800, 8)).astype(np.float32) for _ in range(2)]
        before = _launch_counts()
        xhistogram_torch.histogram(*(torch.from_numpy(a).to(cuda) for a in big),
                                   bins=bins, axis=(1,),
                                   weights=torch.ones(64800, 8, device=cuda))
        assert _launch_counts() == before


def test_weighted_autograd_on_the_card(cuda):
    t_np, s_np = ts_data((64, 4096), seed=17)
    w = torch.rand(4096, device=cuda, requires_grad=True)  # broadcast over rows
    h, _ = xhistogram_torch.histogram(torch.from_numpy(t_np).to(cuda),
                                      torch.from_numpy(s_np).to(cuda),
                                      bins=[T_EDGES, S_EDGES], weights=w)
    coef = torch.randn(h.shape, device=cuda)
    (h * coef).sum().backward()
    w_cpu = w.detach().cpu().requires_grad_()
    h_cpu, _ = xhistogram_torch.histogram(torch.from_numpy(t_np), torch.from_numpy(s_np),
                                          bins=[T_EDGES, S_EDGES], weights=w_cpu)
    (h_cpu * coef.cpu()).sum().backward()
    torch.testing.assert_close(w.grad.cpu(), w_cpu.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", WEIGHT_DTYPES, ids=str)
def test_public_histogram_launches_for_every_weight_dtype(cuda, dtype):
    """Through the public histogram, weights of every dtype launch the
    route's kernel (one_input per row, joint2 full), with the sums of the
    CPU path in their weighted_dtype; density too."""
    rng = np.random.default_rng(23)
    x, y = (rng.normal(0, 1.5, (64, 2048)).astype(np.float32) for _ in range(2))
    w = _weights((64, 2048), dtype, "cpu", seed=24)
    for args, bins, axis, counter in (([x], [_edges(50)], (1,), 1),
                                      ([x, y], [_edges(50), _edges(40)], None, 0)):
        before = _launch_counts()
        h, _ = xhistogram_torch.histogram(*(torch.from_numpy(a).to(cuda) for a in args),
                                          bins=bins, axis=axis, weights=w.to(cuda))
        launched = [a - b for a, b in zip(_launch_counts(), before)]
        assert launched == [int(i == counter) for i in range(len(launched))]
        assert h.dtype == weighted_dtype(dtype) and h.device.type == "cuda"
        h_cpu, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=w,
                                              device="cpu")
        _assert_sums_equal(h.cpu(), h_cpu)
        d, _ = xhistogram_torch.histogram(*(torch.from_numpy(a).to(cuda) for a in args),
                                          bins=bins, axis=axis, weights=w.to(cuda),
                                          density=True)
        d_cpu, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=w,
                                              density=True, device="cpu")
        torch.testing.assert_close(d.cpu(), d_cpu, rtol=1e-5, atol=1e-7, equal_nan=True)


# --- the bucketed digitize and the cluster histograms ------------------------------

CLUSTER_KERNELS = ("joint2", *ROUTES)
# counts, then one weight dtype of each accumulator class: float64, uint32,
# uint64
ACCUMULATORS = (None, torch.float32, torch.int32, torch.int64)


def _bucket_case(name, kernel, device):
    """(layouts, edges): the set's adversarial values (thresholds and their
    neighbours, NaN, ±inf, ±0, subnormals, integer extremes), then a
    partner input over enough bins that the joint histogram needs a
    cluster (up to ~160,000 slots), both of the set's dtype, in the
    kernel's (m, c) shape."""
    edges, dtype = BUCKET_EDGE_SETS[name]
    x = bucket_case_values(tbins.compare_form(edges, dtype).edges, dtype,
                           n_random=20_000, seed=len(name))
    x = x[: x.size // 64 * 64]  # the specials lead; random values are cut
    nba = int(np.clip(160_000 // (len(edges) - 1), 8, 3000))
    rng = np.random.default_rng(nba)
    if np.issubdtype(dtype, np.floating):
        partner_edges = np.linspace(-4, 4, nba + 1)
        partner = rng.normal(0, 2, x.size).astype(dtype)
    else:
        partner_edges = np.linspace(-3000.5, 3000.5, nba + 1)
        partner = rng.integers(-3500, 3500, x.size).astype(dtype)
    rows = {"joint2": 1, "full": 1, "per_row": 4, "packed": 16, "direct": 8}[kernel]
    layouts = [torch.from_numpy(v).to(device).reshape(rows, -1) for v in (x, partner)]
    return layouts, [edges, partner_edges]


@pytest.mark.parametrize("kernel", CLUSTER_KERNELS)
@pytest.mark.parametrize("name", list(BUCKET_EDGE_SETS))
def test_bucket_edge_sets_at_every_cluster_size(cuda, name, kernel, monkeypatch):
    # bit for bit against the plain version (weighted float sums within one
    # float32 rounding), with the clusters capped at 1, 2, 4 and 8 blocks,
    # for counts and each accumulator class
    layouts, edges = _bucket_case(name, kernel, cuda)
    n_slots = (len(edges[0]) - 1) * (len(edges[1]) - 1)
    for wdtype in ACCUMULATORS:
        w = None if wdtype is None else _weights(layouts[0].shape, wdtype, cuda, seed=1)
        want = _run(kernel, layouts, edges, w, plain=True)
        acc_bytes = 4 if wdtype in (None, torch.int32) else 8
        for most in (1, 2, 4, 8):
            monkeypatch.setattr(cuda_hist, "MAX_CLUSTER_CTAS", most)
            got = _run(kernel, layouts, edges, w, plain=False)
            torch.cuda.synchronize()
            launch = cuda_hist.last_launch()
            assert launch["cluster"] <= most, (most, launch)
            if most > 1 and n_slots * acc_bytes > 232448:  # more than a block
                assert launch["cluster"] > 1 or not launch["shared"], (most, launch)
            if w is None:
                assert torch.equal(got, want), (most, launch)
            else:
                _assert_sums_equal(got, want)


def test_readme_call_runs_in_a_cluster(cuda):
    # the README's per-depth T-S call: 95,201 slots a row, two blocks of
    # int32 counters, four of uint64 sums; float64 sums add in device
    # memory, which beats a cluster for them
    t_np, s_np = ts_data((6, 4, 500), seed=11)
    vol = np.random.default_rng(12).uniform(0.5, 1.5, (4, 500)).astype(np.float32)
    for weights, cluster, shared in ((None, 2, True), ((vol * 1000).astype(np.int64), 4, True),
                                     (vol, 1, False)):
        before = cuda_hist.FACTORED_LAUNCHES["per_row"]
        args = [torch.from_numpy(x).to(cuda) for x in (t_np, s_np)]
        w = None if weights is None else torch.from_numpy(weights).to(cuda)
        h, _ = xhistogram_torch.histogram(*args, bins=[T_EDGES, S_EDGES], axis=(0, 2),
                                          weights=w)
        torch.cuda.synchronize()
        launch = cuda_hist.last_launch()
        assert cuda_hist.FACTORED_LAUNCHES["per_row"] == before + 1
        assert (launch["cluster"], launch["passes"], launch["shared"]) == (cluster, 1, shared)
        h_cpu, _ = xhistogram_torch.histogram(t_np, s_np, bins=[T_EDGES, S_EDGES],
                                              axis=(0, 2), weights=weights, device="cpu")
        if weights is None or weights.dtype == np.int64:
            assert torch.equal(h.cpu(), h_cpu)
        else:
            torch.testing.assert_close(h.cpu(), h_cpu, rtol=3e-7, atol=1e-5)


def test_grids_past_eight_blocks_take_chunk_passes(cuda):
    # joint2's 1000x500 int32 grid (2 MB) needs more than eight blocks: the
    # T rows go in chunks, each a pass; factored's 1000x1000 grid adds in
    # device memory
    t_np, s_np = ts_data((1 << 20,), seed=13)
    t, s = torch.from_numpy(t_np).to(cuda), torch.from_numpy(s_np).to(cuda)
    te, se = np.linspace(-2, 30, 1001), np.linspace(30, 40, 501)
    got, want = _kernel_and_plain(t, s, te, se, cuda)
    launch = cuda_hist.last_launch()
    assert torch.equal(got, want)
    assert launch["cluster"] == 8 and launch["passes"] >= 2, launch
    layouts = [x.reshape(1, -1) for x in (t - 14, s - 35)]
    got, want = _slot_pair(layouts, [_edges(1000)] * 2, "full")
    assert torch.equal(got, want) and not cuda_hist.last_launch()["shared"]


# --- one_input: counter layouts, the bucketed search, narrow loads ----------------

from xhistogram_torch.ops.digitize import bucket_table  # noqa: E402


def _one_input_run(x2d, edges, reduce_all, weights=None):
    """(kernel result, plain result, launch record) of one_input on the
    card, with the launch counted once and the record read after it."""
    thr = torch.from_numpy(tbins.compare_form(np.asarray(edges), _compare_dtype(x2d)).edges)
    thr = thr.to(x2d.device)
    nb = len(edges) - 1
    before = cuda_hist.ONE_INPUT_LAUNCHES
    got = cuda_hist.one_input(x2d, thr, nb, reduce_all, weights=weights)
    torch.cuda.synchronize()
    assert cuda_hist.ONE_INPUT_LAUNCHES == before + 1
    launch = cuda_hist.last_launch()
    assert launch["kernel"] == "one_input" and launch["load"] == x2d.dtype
    want = cuda_hist.one_input_reference(x2d, thr, nb, reduce_all, weights=weights)
    if weights is None:
        assert got.dtype == torch.int64 and torch.equal(got, want), launch
    else:
        _assert_sums_equal(got, want)
    return got, launch


# (shape, strided (1, m) view, bins, full reduction, weight dtype, layout):
# lane-private counters for a full reduction or long rows while
# nb * 256 accumulators fit 110 KB (110 bins of 32-bit, 55 of 64-bit);
# 32-bit warp replicas and 64-bit aggregated copies past that and for short
# or strided rows
LAYOUT_CASES = [
    ((4, 1 << 18), False, 50, True, None, "lane-private"),
    ((4, 1 << 18), False, 110, True, None, "lane-private"),
    ((4, 1 << 18), False, 111, True, None, "warp replicas"),
    ((4, 1 << 18), False, 1024, True, None, "warp replicas"),
    ((4, 1 << 18), False, 55, True, torch.float32, "lane-private"),
    ((4, 1 << 18), False, 56, True, torch.float32, "aggregated"),
    ((4, 1 << 18), False, 1024, True, torch.int64, "aggregated"),
    ((4, 1 << 18), False, 50, True, torch.int32, "lane-private"),
    ((16, 1 << 17), False, 50, False, None, "lane-private"),
    ((16, 1 << 17), False, 50, False, torch.float32, "lane-private"),
    ((16, 1 << 17), False, 50, False, torch.int64, "lane-private"),
    ((16, 1 << 17), False, 200, False, None, "warp replicas"),
    ((4096, 64), False, 50, False, None, "warp replicas"),
    ((4096, 64), False, 50, False, torch.float32, "aggregated"),
    ((365, 4096), True, 80, False, None, "warp replicas"),
    ((365, 4096), True, 80, False, torch.float64, "aggregated"),
    ((365, 4096), True, 80, False, torch.int32, "warp replicas"),
    ((365, 4096), True, 80, False, torch.uint64, "aggregated"),
    ((365, 4096), True, 80, True, None, "lane-private"),
]


@pytest.mark.parametrize("shape,strided,nb,reduce_all,wdtype,layout", LAYOUT_CASES,
                         ids=[f"{c[0][0]}x{c[0][1]}-{'strided-' if c[1] else ''}"
                              f"{c[2]}-{'full' if c[3] else 'rows'}-{c[4]}"
                              for c in LAYOUT_CASES])
def test_one_input_counter_layouts(cuda, shape, strided, nb, reduce_all, wdtype, layout):
    gen = torch.Generator(device=cuda).manual_seed(nb)
    if strided:  # config 4's view: (cells, time) with strides (1, cells)
        x = 1.5 * torch.randn(shape[1], shape[0], device=cuda, generator=gen).t()
    else:
        x = 1.5 * torch.randn(shape, device=cuda, generator=gen)
    x[::7, ::3] = float("nan")
    w = None if wdtype is None else _weights(tuple(x.shape), wdtype, cuda, seed=nb)
    if w is not None and strided:
        w = w.t().contiguous().t()  # weights of the data's layout, read in place
    edges = _edges(nb) if nb <= 64 else np.sort(
        np.random.default_rng(nb).normal(0, 1.5, nb + 1))
    _, launch = _one_input_run(x, edges, reduce_all, weights=w)
    assert launch["layout"] == layout, launch
    assert launch["cells"][0] == 2 * nb


ONE_INPUT_BUCKET_SETS = [name for name, (e, _) in BUCKET_EDGE_SETS.items()
                         if len(e) - 1 <= 1024]


@pytest.mark.parametrize("wdtype", [None, torch.float32, torch.int32, torch.int64],
                         ids=str)
@pytest.mark.parametrize("name", ONE_INPUT_BUCKET_SETS)
def test_one_input_bucket_edge_sets(cuda, name, wdtype):
    # bit for bit against the plain version on the adversarial threshold sets
    # (float sums within one float32 rounding), full and kept rows, in each
    # accumulator class; the table's widest window is the mirror's
    edges, dtype = BUCKET_EDGE_SETS[name]
    thr = tbins.compare_form(edges, dtype).edges
    x = bucket_case_values(thr, dtype, n_random=40_000, seed=len(name))
    x = torch.from_numpy(x[: x.size // 64 * 64]).to(cuda)
    for layout, reduce_all in ((x.reshape(1, -1), True), (x.reshape(4, -1), False),
                               (x.reshape(-1, 4).t(), False), (x.reshape(64, -1), True)):
        w = None if wdtype is None else _weights(tuple(layout.shape), wdtype, cuda,
                                                 seed=3)
        _, launch = _one_input_run(layout, edges, reduce_all, weights=w)
        _, widest, (_, _, k) = bucket_table(torch.from_numpy(thr), 2 * (len(edges) - 1))
        assert launch["cells"][0] == 2 * (len(edges) - 1)
        assert launch["widest"] == widest, (launch, widest, k)


NARROW_DTYPES = [torch.bool, torch.int8, torch.uint8, torch.int16, torch.uint16,
                 torch.float16, torch.bfloat16]


def _narrow_data(dtype, shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, device=device, generator=gen) < 0.3, np.array([0, 0.5, 1])
    if dtype.is_floating_point:
        x = (1.5 * torch.randn(shape, device=device, generator=gen)).to(dtype)
        x.view(-1)[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
        return x, _edges(50)
    info = torch.iinfo(dtype)
    x = torch.randint(info.min, info.max + 1, shape, device=device, generator=gen,
                      dtype=torch.int32).to(dtype)
    edges = np.linspace(info.min - 0.5, info.max + 3.0, 51)
    edges[1], edges[-2] = info.min, info.max
    return x, edges


@pytest.mark.parametrize("dtype", NARROW_DTYPES, ids=str)
def test_one_input_reads_narrow_data_in_place(cuda, dtype):
    # the kernel reads the narrow data itself (its load type in the launch
    # record), bit-equal to the plain version on a widened copy and to the
    # public call on the CPU; the public call on the card allocates no
    # widened copy of it
    x, edges = _narrow_data(dtype, (64, 1 << 16), cuda, seed=9)
    for layout, reduce_all in ((x.reshape(1, -1), True), (x, False),
                               (x.reshape(-1, 64).t(), False)):
        for wdtype in (None, torch.float32, torch.int32, torch.int64):
            w = None if wdtype is None else _weights(tuple(layout.shape), wdtype,
                                                     cuda, seed=4)
            _one_input_run(layout, edges, reduce_all, weights=w)
    for axis in (None, (1,), (0,)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = cuda_hist.ONE_INPUT_LAUNCHES
        h, _ = xhistogram_torch.histogram(x, bins=[edges], axis=axis)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        assert cuda_hist.ONE_INPUT_LAUNCHES == before + 1
        assert cuda_hist.last_launch()["load"] == dtype
        # a widened copy would take 4 bytes an element; beside the int64
        # output (trash slot included) the thresholds take a few hundred bytes
        nb = len(edges) - 1
        out_bytes = 8 * (h.numel() // nb) * (nb + 1)
        assert extra < out_bytes + x.numel() * x.element_size() / 2, (axis, extra)
        h_cpu, _ = xhistogram_torch.histogram(x.cpu(), bins=[edges], axis=axis)
        assert torch.equal(h.cpu(), h_cpu)


# --- the public API above core: the f64 tier, streaming, labeled, compat ------

_ROUTE_COUNTER = {"joint2": 0, "one_input": 1, "factored": 2, "factored_per_row": 3,
                  "factored_packed": 4, "direct": 5}


def _f64_weights(shape, device, seed, spread=12):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(shape, device=device, generator=gen, dtype=torch.float64)
    return w * 10.0 ** (spread * (2 * torch.rand(shape, device=device, generator=gen,
                                                 dtype=torch.float64) - 1))


@pytest.mark.parametrize(
    "shape,nbins,axis,kernel",
    [((1 << 18,), (50,), None, "one_input"),
     ((8, 5000), (50,), (1,), "one_input"),
     ((1 << 18,), (280, 340), None, "joint2"),
     ((6, 4, 500), (280, 340), (0, 2), "factored_per_row"),
     ((1 << 16,), (60, 60, 60), None, "factored"),
     ((2000, 64), (40, 40), (1,), "direct")],
    ids=str,
)
def test_f64_runs_the_int64_kernels_bit_identically(cuda, shape, nbins, axis, kernel):
    """precision='f64' on the card: every limb pass launches the route's
    int64-weighted kernel, two runs give the same bits, and so does the
    plain decomposition (index_add_ on the card) and the CPU."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    args = [torch.randn(shape, device=cuda, generator=gen) * 1.5 for _ in nbins]
    w = _f64_weights(shape, cuda, seed=32)
    bins = [_edges(nb) for nb in nbins]
    before = _launch_counts()
    h1, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=w,
                                       precision="f64")
    launched = [a - b for a, b in zip(_launch_counts(), before)]
    assert launched[_ROUTE_COUNTER[kernel]] >= 2  # groups x limbs passes
    assert sum(launched) == launched[_ROUTE_COUNTER[kernel]]
    h2, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=w,
                                       precision="f64")
    plain, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=w,
                                          precision="f64", method="scatter")
    assert h1.dtype == torch.float64
    assert torch.equal(h1, h2) and torch.equal(h1, plain)
    h_cpu, _ = xhistogram_torch.histogram(*(a.cpu() for a in args), bins=bins, axis=axis,
                                          weights=w.cpu(), precision="f64")
    assert torch.equal(h1.cpu(), h_cpu)


def test_f64_nonfinite_and_broadcast_weights_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(33)
    t = torch.randn(8, 50, 600, device=cuda, generator=gen)
    s = torch.randn(8, 50, 600, device=cuda, generator=gen)
    vol = _f64_weights((50, 600), cuda, seed=34)
    vol[3, :5] = float("inf")
    vol[7, 9] = float("nan")
    bins = [_edges(28), _edges(34)]
    h, _ = xhistogram_torch.histogram(t, s, bins=bins, axis=(0, 2), weights=vol,
                                      precision="f64")
    plain, _ = xhistogram_torch.histogram(t, s, bins=bins, axis=(0, 2), weights=vol,
                                          precision="f64", method="scatter")
    assert h.isposinf().any() and h.isnan().any()
    assert torch.equal(h.isnan(), plain.isnan())
    fin = ~plain.isnan()
    assert torch.equal(h[fin], plain[fin])


def _no_sync(fn):
    """Run ``fn`` with synchronising CUDA calls turned into errors."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("kind", ["device", "numpy", "cpu-tensor"])
@pytest.mark.parametrize("wdtype", [None, torch.float32, torch.int64, torch.uint64],
                         ids=str)
def test_streaming_updates_do_not_synchronise(cuda, kind, wdtype):
    """No update() waits for the card: device chunks pass through, host
    chunks are staged through pinned memory on a side stream; the sum over
    chunks equals the one-shot call bit for bit (float32 sums: each chunk's
    rounding, within two float32 ulps)."""
    t_np, s_np = ts_data((8, 1 << 16), seed=35)
    rng = np.random.default_rng(36)
    w_np = None
    if wdtype is not None:
        w_np = {torch.float32: rng.random((8, 1 << 16)).astype(np.float32),
                torch.int64: rng.integers(-(2**40), 2**40, (8, 1 << 16)),
                torch.uint64: rng.integers(0, 2**62, (8, 1 << 16)).astype(np.uint64)
                }[wdtype]

    def chunk(x, k):
        part = np.ascontiguousarray(x[:, k * 8192:(k + 1) * 8192])
        if kind == "numpy":
            return part
        t = torch.from_numpy(part)
        return t if kind == "cpu-tensor" else t.to(cuda)

    acc = xhistogram_torch.StreamingHistogram(bins=[T_EDGES, S_EDGES])
    chunks = [(chunk(t_np, k), chunk(s_np, k), None if w_np is None else chunk(w_np, k))
              for k in range(8)]
    acc.update(*chunks[0][:2], weights=chunks[0][2])  # thresholds cached, buffers warm
    for a, b, w in chunks[1:]:
        _no_sync(lambda: acc.update(a, b, weights=w))
    h, _ = acc.result()
    assert h.device.type == "cuda"
    want, _ = xhistogram_torch.histogram(t_np, s_np, bins=[T_EDGES, S_EDGES],
                                         weights=w_np, device=cuda)
    if wdtype == torch.float32:
        assert h.dtype == torch.float64
        torch.testing.assert_close(h, want.double(), rtol=2.4e-7, atol=1e-6)
    else:
        assert h.dtype == want.dtype
        assert torch.equal(h, want)


def test_streaming_kept_offset_tiles_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(37)
    sst = (20 + 5 * torch.randn(40, 18, 36, device=cuda, generator=gen)).cpu().numpy()
    edges = np.linspace(0, 40, 81)
    acc = xhistogram_torch.StreamingHistogram(bins=[edges], axis=0)
    for lat0 in range(0, 18, 6):
        for t0 in range(0, 40, 10):
            acc.update(sst[t0:t0 + 10, lat0:lat0 + 6], kept_offset=(lat0, 0))
    h, _ = acc.result()
    want, _ = xhistogram_torch.histogram(sst, bins=[edges], axis=0, device=cuda)
    assert torch.equal(h, want)
    blocks = acc.blocks
    assert set(blocks) == {(0, 0), (6, 0), (12, 0)}
    assert all(b.device.type == "cuda" for b in blocks.values())


def test_streaming_f64_across_chunks_on_the_card(cuda):
    acc = xhistogram_torch.StreamingHistogram(bins=[np.linspace(0, 1, 3)],
                                              precision="f64")
    for v in (1e16, -1e16, 1.0):
        acc.update(np.array([0.25], np.float32), weights=np.array([v]))
    h, _ = acc.result()
    assert h.device.type == "cuda" and h.tolist() == [1.0, 0.0]


def test_threshold_cache_per_device_and_no_copy_on_a_hit(cuda):
    from xhistogram_torch import core

    core._THRESHOLD_CACHE.clear()
    x = torch.randn(1 << 16, device=cuda)
    edges = np.linspace(-4, 4, 51)
    h, _ = xhistogram_torch.histogram(x, bins=[edges])
    h_cpu, _ = xhistogram_torch.histogram(x.cpu(), bins=[edges])
    assert torch.equal(h.cpu(), h_cpu)
    devices = sorted(str(k[4]) for k in core._THRESHOLD_CACHE)
    assert devices == ["cpu", str(x.device)]
    again = _no_sync(lambda: xhistogram_torch.histogram(x, bins=[edges.copy()])[0])
    assert torch.equal(again, h) and len(core._THRESHOLD_CACHE) == 2


@pytest.mark.parametrize("method", ["onehot", "sort"])
def test_strategies_run_no_kernel_on_the_card(cuda, method):
    t_np, s_np = ts_data((4, 4096), seed=38)
    t, s = torch.from_numpy(t_np).to(cuda), torch.from_numpy(s_np).to(cuda)
    w = torch.randint(-1000, 1000, t.shape, device=cuda, dtype=torch.int32)
    bins = [T_EDGES, S_EDGES]
    for axis in (None, 1):
        for weights in (None, w):
            before = _launch_counts()
            h, _ = xhistogram_torch.histogram(t, s, bins=bins, axis=axis, weights=weights,
                                              method=method)
            assert _launch_counts() == before
            want, _ = xhistogram_torch.histogram(t, s, bins=bins, axis=axis,
                                                 weights=weights, method="scatter")
            assert torch.equal(h, want)


def test_labeled_and_compat_on_the_card(cuda):
    from xhistogram_torch import compat
    from xhistogram_torch.labeled import NamedArray
    from xhistogram_torch.labeled import histogram as lhist

    t_np, s_np = ts_data((6, 5, 900), seed=39)
    T = NamedArray(torch.from_numpy(t_np).to(cuda), ("time", "depth", "cell"), name="T",
                   attrs={"units": "degC"})
    S = NamedArray(s_np, ("time", "depth", "cell"), name="S",
                   coords={"depth": np.arange(5.0)})
    out = lhist(T, S, bins=[T_EDGES, S_EDGES], dim=("time", "cell"))
    want, _ = xhistogram_torch.histogram(T.data, torch.from_numpy(s_np).to(cuda),
                                         bins=[T_EDGES, S_EDGES], axis=(0, 2))
    assert out.dims == ("depth", "T_bin", "S_bin") and out.data.device.type == "cuda"
    assert torch.equal(out.data, want)
    assert out.coords["T_bin"].attrs == {"units": "degC"}
    h, _, _ = compat.histogram2d(t_np.ravel(), s_np.ravel(), bins=[T_EDGES, S_EDGES])
    he, _, _ = np.histogram2d(t_np.ravel(), s_np.ravel(), bins=[T_EDGES, S_EDGES])
    assert h.dtype == he.dtype
    np.testing.assert_array_equal(h, he)
