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
from xhistogram_torch.ops.bincount import finish_sums, weighted_dtype
from xhistogram_torch.utils import profiling
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


def _searched(thr):
    """Compare-form thresholds as the kernels search them: uint64 ones
    flipped onto int64 (``bins.flip_uint64``), as the data are in
    registers."""
    return tbins.flip_uint64(thr) if thr.dtype == np.uint64 else thr


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


# --- one_input past the JAX package's kept-row cap ------------------------------

def _sst_year(cuda):
    """A year of daily 0.25-degree SST, (365, 720, 1440) float32 on the card
    (28 - 30 sin^2(lat) deg C and N(0, 0.6^2) noise, clamped at -1.8), with
    land, 29% of the cells in smooth blobs, NaN every day; and 80 bins of
    0.5 deg C on [-2, 38]."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    lat = torch.deg2rad(torch.linspace(-89.875, 89.875, 720, device=cuda))[:, None]
    lon = torch.deg2rad(torch.linspace(0.125, 359.875, 1440, device=cuda))[None, :]
    field = torch.sin(3 * lat) * torch.cos(2 * lon) + 0.5 * torch.sin(5 * lon + 1) * torch.cos(lat)
    land = field > torch.quantile(field.reshape(-1), 0.71)
    x = torch.randn((365, 720, 1440), device=cuda, generator=gen)
    x.mul_(0.6).add_(28 - 30 * torch.sin(lat) ** 2).clamp_min_(-1.8)
    return x.masked_fill_(land, float("nan")), np.linspace(-2, 38, 81).astype(np.float32)


def test_one_input_runs_the_per_cell_year(cuda):
    """1,036,800 kept rows of 80 bins, past the JAX package's kept-row cap:
    one launch a call and no host sync, counts bit-equal to the plain
    scatter path and to numpy."""
    from xhistogram_torch.utils import profiling

    x, edges = _sst_year(cuda)
    assert cuda_hist.plan(1, (80,), 720 * 1440, 365) == "one_input"
    before = cuda_hist.ONE_INPUT_LAUNCHES, profiling.HOST_SYNCS
    for _ in range(2):
        h, _ = xhistogram_torch.histogram(x, bins=[edges], axis=0)
    assert (cuda_hist.ONE_INPUT_LAUNCHES, profiling.HOST_SYNCS) == (before[0] + 2, before[1])
    torch.cuda.synchronize()
    assert h.shape == (720, 1440, 80) and h.dtype == torch.int64
    plain, _ = xhistogram_torch.histogram(x, bins=[edges], axis=0, method="scatter")
    assert torch.equal(h, plain)
    sample = x[:, ::7, ::11].cpu().numpy()
    np.testing.assert_array_equal(h[::7, ::11].cpu().numpy(),
                                  reference_numpy(sample, edges, (0,)))


def test_one_input_weighted_per_cell_year(cuda):
    """The year weighted by float32 weights: float32 sums within one float32
    rounding of the plain path's, one launch a call."""
    x, edges = _sst_year(cuda)
    gen = torch.Generator(device=cuda).manual_seed(17)
    w = torch.rand(x.shape, device=cuda, generator=gen) * 4 - 1
    before = cuda_hist.ONE_INPUT_LAUNCHES
    h, _ = xhistogram_torch.histogram(x, bins=[edges], axis=0, weights=w)
    assert cuda_hist.ONE_INPUT_LAUNCHES == before + 1
    plain, _ = xhistogram_torch.histogram(x, bins=[edges], axis=0, weights=w,
                                          method="scatter")
    assert h.dtype == plain.dtype == torch.float32
    _assert_sums_equal(h, plain)


def test_one_input_chunks_within_its_32_bit_counters(cuda):
    """Kept rows of several runs of columns: each block walks a contiguous
    chunk of tiles, ceil(tiles / resident blocks), into 32-bit shared
    counters, and the launcher refuses a chunk of more than 2^32 - 1
    elements. Past that edge, chunk_tiles cuts the chunks to fit and
    launches more blocks. Two rows of sms x 65,536 + 1 int8 values, each
    broadcast (stride 0) over 65,536 columns, in 100 bins: lane-private
    counters of 100 KB a block, at most two blocks an SM, and tiles of one
    run of 65,536 columns, so a chunk of ceil(tiles / (2 sms)) tiles is past
    the edge. 1.1e12 elements read from 17 MB."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tile = 1 << 16
    width = sms * tile + 1
    gen = torch.Generator(device=cuda).manual_seed(5)
    base = torch.randint(-128, 128, (2, width), device=cuda, generator=gen,
                         dtype=torch.int8)
    x = base.expand(tile, 2, width)
    edges = np.linspace(-128, 128, 101)
    tiles = 2 * width
    assert -(-tiles // (2 * sms)) * tile > 0xFFFFFFFF
    before = cuda_hist.ONE_INPUT_LAUNCHES
    h, _ = xhistogram_torch.histogram(x, bins=[edges], axis=(0, 2))
    assert cuda_hist.ONE_INPUT_LAUNCHES == before + 1
    launch = cuda_hist.last_launch()
    assert launch["layout"] == "lane-private" and launch["view"] == "in place"
    assert launch["blocks"] == -(-tiles // (0xFFFFFFFF // tile))
    want = tile * reference_numpy(base.cpu().numpy(), edges, (1,))
    np.testing.assert_array_equal(h.cpu().numpy(), want)


# --- one_input into an uninitialised output -------------------------------------

#: a non-zero pattern for each dtype of one_input's output
_POISON = {torch.int64: -1, torch.int32: -1, torch.float64: float("nan")}


def _dirty_one_input(monkeypatch, x, edges, reduce_all, weights=None, want=None):
    """one_input's raw output (``finish=False``) on the card, its output
    allocated dirty: the ``torch.empty`` of the call hands back memory
    filled with a non-zero pattern (-1 in integers, NaN in float64), as a
    block the caching allocator reuses may hold. Every slot must equal the
    plain version's (or ``want``), the trash slot a zero. Returns the launch
    record and the change of ``profiling.ONE_INPUT_OUTPUTS``."""
    real_empty = torch.empty
    handed = []

    def dirty_empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        if t.is_cuda and t.dtype in _POISON:
            handed.append(t.fill_(_POISON[t.dtype]).data_ptr())
        return t

    nb = len(edges) - 1
    ce = tbins.compare_form(np.asarray(edges), _compare_dtype(x))
    thr = torch.from_numpy(ce.edges).to(x.device)
    before = dict(profiling.ONE_INPUT_OUTPUTS)
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", dirty_empty)
        got = cuda_hist.one_input(x, thr, nb, reduce_all, weights=weights, finish=False)
    torch.cuda.synchronize()
    assert handed == [got.data_ptr()]  # the output is the dirty block
    launch = cuda_hist.last_launch()
    counted = {k: profiling.ONE_INPUT_OUTPUTS[k] - before[k] for k in before}
    assert (got[:, -1] == 0).all()
    if want is None:
        want = cuda_hist._slot_sums_reference([x], [thr], [nb], reduce_all, weights)
    _assert_sums_equal(got, want.reshape(got.shape).to(got.device))
    return launch, counted


# (shape, bins, full reduction, weight dtype, counter layout, zeroed): whole
# kept rows a block in each layout (the kernel stores every slot), rows split
# across column tiles and full reductions (the launcher zeroes the output)
DIRTY_CASES = [
    ((4096, 8192), 8, False, None, "lane-private", False),
    ((4096, 8192), 8, False, torch.float64, "lane-private", False),
    ((4096, 64), 50, False, None, "warp replicas", False),
    ((4096, 64), 50, False, torch.int32, "warp replicas", False),
    ((4096, 64), 50, False, torch.int64, "aggregated", False),
    ((16, 1 << 17), 50, False, torch.float32, "lane-private", True),
    ((16, 1 << 17), 200, False, None, "warp replicas", True),
    ((4, 1 << 18), 50, True, None, "lane-private", True),
    ((4, 1 << 18), 1024, True, torch.int64, "aggregated", True),
]


@pytest.mark.parametrize("shape,nb,reduce_all,wdtype,layout,zeroed", DIRTY_CASES,
                         ids=[f"{c[0][0]}x{c[0][1]}-{c[1]}-{'full' if c[2] else 'rows'}"
                              f"-{c[3]}" for c in DIRTY_CASES])
def test_one_input_writes_every_slot_of_a_dirty_output(cuda, monkeypatch, shape, nb,
                                                       reduce_all, wdtype, layout, zeroed):
    gen = torch.Generator(device=cuda).manual_seed(nb + shape[1])
    x = 1.5 * torch.randn(shape, device=cuda, generator=gen)
    x[::7, ::3] = float("nan")
    w = None if wdtype is None else _weights(shape, wdtype, cuda, seed=nb)
    edges = _edges(nb) if nb <= 64 else np.sort(
        np.random.default_rng(nb).normal(0, 1.5, nb + 1))
    launch, counted = _dirty_one_input(monkeypatch, x, edges, reduce_all, weights=w)
    assert (launch["layout"], launch["zeroed"]) == (layout, zeroed), launch
    assert counted == {"stored": int(not zeroed), "zeroed": int(zeroed)}


@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "float32-weights"])
def test_one_input_stores_every_slot_of_the_year(cuda, monkeypatch, weighted):
    """The per-cell year's 1,036,800 kept rows of 80 bins, as the public
    call lays them out ((cells, days), strides (1, cells)): blocks own whole
    rows, so the launcher zeroes nothing and the kernel stores all 81 slots
    of every row into the dirty output."""
    x, edges = _sst_year(cuda)
    layout = x.reshape(365, -1).t()
    w = None
    if weighted:
        gen = torch.Generator(device=cuda).manual_seed(17)
        w = (torch.rand(x.shape, device=cuda, generator=gen) * 4 - 1).reshape(365, -1).t()
    launch, counted = _dirty_one_input(monkeypatch, layout, edges, False, weights=w)
    assert launch["layout"] == ("aggregated" if weighted else "warp replicas"), launch
    assert not launch["zeroed"] and counted == {"stored": 1, "zeroed": 0}


def test_one_input_zeroes_rows_split_into_chunks(cuda, monkeypatch):
    """The chunk test's view, (1, 2, 65,536, sms x 65,536 + 1) int8 with the
    65,536 a broadcast: each kept row spans column tiles of several runs, so
    blocks add into it and the launcher zeroes the dirty output first."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tile = 1 << 16
    width = sms * tile + 1
    gen = torch.Generator(device=cuda).manual_seed(5)
    base = torch.randint(-128, 128, (2, width), device=cuda, generator=gen,
                         dtype=torch.int8)
    view = base.expand(tile, 2, width).permute(1, 0, 2).unsqueeze(0)
    edges = np.linspace(-128, 128, 101)
    counts = tile * reference_numpy(base.cpu().numpy(), edges, (1,))
    want = torch.from_numpy(np.pad(counts, ((0, 0), (0, 1))))
    launch, counted = _dirty_one_input(monkeypatch, view, edges, False, want=want)
    assert launch["layout"] == "lane-private" and launch["zeroed"], launch
    assert counted == {"stored": 0, "zeroed": 1}


# --- factored and direct (csrc/slot.cuh) ---------------------------------------

# factored over every element, per kept row (rows of 256 or more elements,
# and narrow rows), and direct
ROUTES = ("full", "per_row", "packed", "direct")
#: the index in ``_launches()`` of each route's counter
_COUNTER = {"full": 0, "per_row": 0, "packed": 0, "direct": 1}


def _launches():
    return (cuda_hist.FACTORED_LAUNCHES, cuda_hist.DIRECT_LAUNCHES)


def _slot_pair(layouts, edges, route):
    """(kernel counts, plain counts) on the card for N (m, c) layouts, one
    route (factored over every element or per kept row, or direct)."""
    thr, nbins = [], []
    for x, e in zip(layouts, edges):
        ce = tbins.compare_form(np.asarray(e), _compare_dtype(x))
        assert ce.n_hi_clip == 0
        thr.append(torch.from_numpy(_searched(ce.edges)).to(x.device))
        nbins.append(len(e) - 1)
    before = _launches()
    if route == "direct":
        got = cuda_hist.direct(layouts, thr, nbins)
        want = cuda_hist.direct_reference(layouts, thr, nbins)
    else:
        got = cuda_hist.factored(layouts, thr, nbins, route == "full")
        want = cuda_hist.factored_reference(layouts, thr, nbins, route == "full")
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_launches(), before)]
    assert launched == [int(i == _COUNTER[route] and layouts[0].numel() > 0)
                        for i in range(2)]
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
    assert launched == [int(i == (0 if kernel == "joint2" else 2 + _COUNTER[kernel]))
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
    before, routes = _launches(), dict(profiling.ROUTES)
    h, _ = xhistogram_torch.histogram(*(torch.from_numpy(a).to(cuda) for a in args),
                                      bins=bins, axis=axis)
    launched = [a - b for a, b in zip(_launches(), before)]
    assert launched == [int(kernel != "direct"), int(kernel == "direct")]
    assert {r: n - routes[r] for r, n in profiling.ROUTES.items()
            if n != routes[r]} == {kernel: 1}
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
        before, routes = _launches(), dict(profiling.ROUTES)
        h, _ = call(cuda)
        launched = [a - b for a, b in zip(_launches(), before)]
        assert launched == [int(i == _COUNTER[route]) for i in range(2)]
        took = "factored" if route == "full" else "direct"
        assert profiling.ROUTES[took] == routes[took] + 1
        h_cpu, _ = call("cpu")
        assert torch.equal(h.cpu(), h_cpu)


# --- weighted (csrc/weights.cuh), every kernel -----------------------------------

WEIGHT_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
                 torch.int32, torch.uint32, torch.int16, torch.uint16, torch.int8,
                 torch.uint8, torch.bool, torch.int64, torch.uint64]
KERNELS = ("joint2", "one_input_full", "one_input_rows", *ROUTES)


def _launch_counts():
    return (cuda_hist.JOINT2_LAUNCHES, cuda_hist.ONE_INPUT_LAUNCHES, *_launches())


#: the index in ``_launch_counts()`` of each route of ``plan()``: the three
#: factored routes run one kernel
_ROUTE_COUNTER = {"joint2": 0, "one_input": 1, "factored": 2, "factored_per_row": 2,
                  "factored_packed": 2, "direct": 3}


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
        thr.append(torch.from_numpy(_searched(ce.edges)).to(x.device))
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
    return fn(layouts, thr, nbins, kernel == "full", weights=weights)


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
        kernel, 2 + _COUNTER[kernel] if kernel in ROUTES else None)
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
    # cell tables uint64 and uint32 sums take clusters of two or four, and
    # float sums of kept rows too, as exact integers (a full reduction's add
    # in device memory)
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
    before, routes = _launch_counts(), dict(profiling.ROUTES)
    h, _ = xhistogram_torch.histogram(*(torch.from_numpy(a).to(cuda) for a in args),
                                      bins=bins, axis=axis, weights=w.to(cuda))
    launched = [a - b for a, b in zip(_launch_counts(), before)]
    assert launched == [int(i == _ROUTE_COUNTER[kernel]) for i in range(len(launched))]
    assert {r: n - routes[r] for r, n in profiling.ROUTES.items()
            if n != routes[r]} == {kernel: 1}
    h_cpu, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=w,
                                          device="cpu")
    _assert_sums_equal(h.cpu(), h_cpu)
    # where the JAX package runs scatter (float weights, 64,800 rows of
    # 40x40), the port runs the direct kernel, by its own limits
    if kernel == "direct" and wdtype == torch.int32:
        big = [rng.normal(0, 1.5, (64800, 8)).astype(np.float32) for _ in range(2)]
        w_big = torch.rand(64800, 8, device=cuda)
        before = _launch_counts()
        h_big, _ = xhistogram_torch.histogram(
            *(torch.from_numpy(a).to(cuda) for a in big), bins=bins, axis=(1,),
            weights=w_big)
        launched = [a - b for a, b in zip(_launch_counts(), before)]
        assert launched == [int(i == _ROUTE_COUNTER["direct"])
                            for i in range(len(launched))]
        assert cuda_hist.last_launch()["kernel"] == "direct_rows"
        h_cpu, _ = xhistogram_torch.histogram(*big, bins=bins, axis=(1,),
                                              weights=w_big.cpu(), device="cpu")
        assert h_big.dtype == torch.float32
        _assert_sums_equal(h_big.cpu(), h_cpu)


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
        # (float sums of kept rows: exact integers in 32-bit words)
        acc_bytes = 4 if wdtype in (None, torch.int32) or (
            wdtype == torch.float32 and kernel in ("per_row", "packed", "direct")) else 8
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
    # int32 counters, four of uint64 sums, and two of float sums kept as
    # exact integers in 32-bit words (a float64 shared atomic loses to device
    # memory)
    t_np, s_np = ts_data((6, 4, 500), seed=11)
    vol = np.random.default_rng(12).uniform(0.5, 1.5, (4, 500)).astype(np.float32)
    for weights, cluster, shared in ((None, 2, True), ((vol * 1000).astype(np.int64), 4, True),
                                     (vol, 2, True)):
        before = cuda_hist.FACTORED_LAUNCHES, profiling.ROUTES["factored_per_row"]
        args = [torch.from_numpy(x).to(cuda) for x in (t_np, s_np)]
        w = None if weights is None else torch.from_numpy(weights).to(cuda)
        h, _ = xhistogram_torch.histogram(*args, bins=[T_EDGES, S_EDGES], axis=(0, 2),
                                          weights=w)
        torch.cuda.synchronize()
        launch = cuda_hist.last_launch()
        assert (cuda_hist.FACTORED_LAUNCHES, profiling.ROUTES["factored_per_row"]) == (
            before[0] + 1, before[1] + 1)
        assert (launch["cluster"], launch["passes"], launch["shared"]) == (cluster, 1, shared)
        assert launch["exact"] == (weights is not None and weights.dtype == np.float32)
        h_cpu, _ = xhistogram_torch.histogram(t_np, s_np, bins=[T_EDGES, S_EDGES],
                                              axis=(0, 2), weights=weights, device="cpu")
        if weights is None or weights.dtype == np.int64:
            assert torch.equal(h.cpu(), h_cpu)
        else:
            torch.testing.assert_close(h.cpu(), h_cpu, rtol=3e-7, atol=1e-5)


# --- float sums kept as exact integers in a cluster (csrc/weights.cuh) -------

def _exact_launch():
    torch.cuda.synchronize()
    return cuda_hist.last_launch()


def _raw(route, layouts, edges, weights, plain):
    """A flat-slot route's float64 sums (not rounded to float32), kernel or
    plain version."""
    thr = [torch.from_numpy(tbins.compare_form(np.asarray(e), np.float32).edges)
           .to(layouts[0].device) for e in edges]
    nbins = [len(e) - 1 for e in edges]
    if plain:
        out = cuda_hist._slot_sums_reference(layouts, thr, nbins, route == "full", weights)
        return out.reshape(-1, out.shape[-1])
    if route == "direct":
        return cuda_hist.direct(layouts, thr, nbins, weights=weights, finish=False)
    return cuda_hist.factored(layouts, thr, nbins, route == "full", weights=weights,
                              finish=False)


def _fell_back(layouts, edges, weights):
    """The counted elements whose weight the exact sums add as a float (the
    plain mirror's rule, ``cuda_hist.exact_integer``)."""
    w = weights.double().cpu().flatten()
    finite = w[torch.isfinite(w)]
    u = cuda_hist.exact_unit(float(finite.abs().max()) if finite.numel() else 0.0)
    counted = torch.ones_like(w, dtype=torch.bool)
    for x, e in zip(layouts, edges):
        x = x.double().cpu().flatten()
        counted &= (x >= float(e[0])) & (x <= float(e[-1]))
    return sum(cuda_hist.exact_integer(float(v), u) is None for v in w[counted])


def _ecco_like(cuda, shape, seed):
    """(T, S, volume) of an ECCO-like census: (time, depth, cell) T and S with
    NaN land and rock, the cells' volume (depth, cell) thickening with depth
    and 0 where dry."""
    times, levels, cells = shape
    rng = np.random.default_rng(seed)
    t, s = ts_data(shape, seed)
    floor = rng.integers(0, levels + 1, cells)  # 0: land
    wet = np.arange(levels)[:, None] < floor[None, :]
    area = np.cos(np.deg2rad(rng.uniform(-89.75, 89.75, cells))) * 3.09e9
    dz = np.geomspace(10.0, 456.5, levels)
    vol = np.where(wet, dz[:, None] * area[None, :], 0.0).astype(np.float32)
    t[:, ~wet] = np.nan
    s[:, ~wet] = np.nan
    return [torch.from_numpy(x).to(cuda) for x in (t, s, vol)]


def _numpy_levels(t, s, vol, te, se):
    """float64 numpy sums per level (axis=(0, 2)), volume broadcast over time."""
    t, s = t.cpu().numpy(), s.cpu().numpy()
    w = np.broadcast_to(vol.cpu().numpy().astype(np.float64), t.shape)
    return np.stack([np.histogram2d(t[:, k].ravel(), s[:, k].ravel(), bins=[te, se],
                                    weights=w[:, k].ravel())[0]
                     for k in range(t.shape[1])])


def test_exact_sums_at_an_ecco_like_shape(cuda):
    # the README call by cell volume on NaN land and rock, zero volume where
    # dry: two blocks of exact integers; volumes whose bits reach below the
    # unit (more than 2^8 below the largest, low bits set) fall back
    t, s, vol = _ecco_like(cuda, (12, 8, 20_000), seed=19)
    before = dict(profiling.WEIGHTED_SLOTS)
    h, _ = xhistogram_torch.histogram(t, s, bins=[T_EDGES, S_EDGES], axis=(0, 2),
                                      weights=vol)
    launch = _exact_launch()
    assert (launch["exact"], launch["cluster"], launch["shared"]) == (True, 2, True)
    wide = vol.unsqueeze(0).expand_as(t)
    assert launch["fell_back"] == _fell_back([t, s], [T_EDGES, S_EDGES], wide)
    assert profiling.WEIGHTED_SLOTS["exact"] == before["exact"] + 1
    want = _numpy_levels(t, s, vol, T_EDGES, S_EDGES)
    assert h.dtype == torch.float32
    np.testing.assert_allclose(h.cpu().numpy(), want.astype(np.float32), rtol=2.4e-7,
                               atol=0)


def test_exact_sums_with_weights_past_2_to_the_8_of_the_largest(cuda):
    # weights over 2^20 of their largest: those whose bits reach below the
    # unit add as floats, and the tally counts them
    t, s, _ = _ecco_like(cuda, (6, 4, 30_000), seed=20)
    layouts = [x.permute(1, 0, 2).reshape(4, -1) for x in (t, s)]
    gen = torch.Generator(device=cuda).manual_seed(21)
    w = torch.rand(layouts[0].shape, device=cuda, generator=gen)
    w = w * torch.exp2(-torch.randint(0, 21, w.shape, device=cuda, generator=gen).float())
    got = _raw("per_row", layouts, [T_EDGES, S_EDGES], w, plain=False)
    launch = _exact_launch()
    assert launch["exact"] and launch["cluster"] == 2
    fell = _fell_back(layouts, [T_EDGES, S_EDGES], w)
    assert 0 < launch["fell_back"] == fell
    want = _raw("per_row", layouts, [T_EDGES, S_EDGES], w, plain=True)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16,
                                   torch.bfloat16], ids=str)
def test_exact_sums_signed_and_nonfinite(cuda, dtype):
    # mixed signs add in two's complement; NaN, +inf, -inf and +inf with
    # -inf reach their bins as a float64 atomic would put them there
    m, c = 5, 40_000
    layouts = _layouts("per_row", m, c, cuda, seed=22)
    edges = [_edges(300), _edges(300)]  # 90,001 slots: two blocks
    w = _weights((m, c), torch.float32, cuda, seed=23).to(dtype)
    w[0, 1:6] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                              float("inf"), -float("inf")], dtype=dtype)
    layouts[0][0, 1:6] = torch.tensor([-2.5, -1.5, -0.5, 0.01, 0.01])
    layouts[1][0, 1:6] = 0.01  # +inf and -inf in one bin: NaN
    got = _raw("per_row", layouts, edges, w, plain=False)
    launch = _exact_launch()
    assert launch["exact"] and launch["fell_back"] >= 5
    want = _raw("per_row", layouts, edges, w, plain=True)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12, equal_nan=True)
    assert torch.isnan(got).sum() == torch.isnan(want).sum() >= 2
    assert torch.isinf(got).sum() == torch.isinf(want).sum() >= 1


def test_exact_sums_wrap_in_one_slot(cuda):
    # more than 2^26 adds of the largest weight into one slot of a row: its
    # integer (2^32 - 256 a weight) wraps the slot's word at nearly every
    # add, each wrap into the output, and the sum is exact; a row of
    # alternating signs sums to its few odd ones out
    c = (1 << 26) + 3
    t = torch.full((2, c), 10.0, device=cuda)
    s = torch.full((2, c), 35.0, device=cuda)
    big = float(np.nextafter(np.float32(2.0), np.float32(0.0)))  # 2 - 2^-23
    w = torch.full((2, c), big, device=cuda)
    w[1, ::2] = -big
    w[1, :6] = 0.5
    got = _raw("per_row", [t, s], [T_EDGES, S_EDGES], w, plain=False)
    launch = _exact_launch()
    assert launch["exact"] and launch["fell_back"] == 0
    slot = int(torch.nonzero(got[0]).flatten()[0])
    assert got[0, slot].item() == c * big
    # odd columns +big, even ones -big, the first six 0.5
    assert got[1, slot].item() == 6 * 0.5 + ((c - 1) // 2 - 3) * big - ((c + 1) // 2 - 3) * big
    want = _raw("per_row", [t, s], [T_EDGES, S_EDGES], w, plain=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("most", [1, 2, 4, 8])
@pytest.mark.parametrize("nbins,fewest", [((200, 200), 1), ((280, 340), 2),
                                          ((400, 400), 4), ((600, 600), 8)], ids=str)
def test_exact_sums_at_every_cluster_size(cuda, nbins, fewest, most, monkeypatch):
    # 40,000 slots (past one block's room for float64 ones), 95,200, 160,000
    # and 360,000 in 32-bit words: the fewest blocks that hold them, within
    # MAX_CLUSTER_CTAS; where those are more, the launcher refuses the
    # cluster and the sums add in device memory
    m, c = 3, 50_000
    layouts = _layouts("per_row", m, c, cuda, seed=sum(nbins))
    edges = [_edges(nbins[0]), _edges(nbins[1])]
    w = _weights((m, c), torch.float32, cuda, seed=24)
    monkeypatch.setattr(cuda_hist, "MAX_CLUSTER_CTAS", most)
    before = dict(profiling.WEIGHTED_SLOTS)
    got = _raw("per_row", layouts, edges, w, plain=False)
    launch = _exact_launch()
    exact = fewest <= most
    assert launch["exact"] == exact and launch["shared"] == exact
    assert launch["cluster"] == (fewest if exact else 1)
    where = "exact" if exact else "device"
    assert profiling.WEIGHTED_SLOTS[where] == before[where] + 1
    want = _raw("per_row", layouts, edges, w, plain=True)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("route", ROUTES)
def test_exact_sums_on_every_route(cuda, route, monkeypatch):
    # kept rows of every route past one block keep exact sums; a full
    # reduction, and MAX_SHARED_SLOTS = 0, add in device memory
    m, c = (3, 40_000) if route != "packed" else (600, 200)
    layouts = _layouts(route, m, c, cuda, seed=25)
    edges = [_edges(250), _edges(250)]
    w = _weights((m, c), torch.float32, cuda, seed=26)
    for slots in (cuda_hist.MAX_SHARED_SLOTS, 0):
        monkeypatch.setattr(cuda_hist, "MAX_SHARED_SLOTS", slots)
        got = _raw(route, layouts, edges, w, plain=False)
        launch = _exact_launch()
        assert launch["exact"] == (route != "full" and slots > 0), (route, slots)
        torch.testing.assert_close(got, _raw(route, layouts, edges, w, plain=True),
                                   rtol=1e-12, atol=1e-12)


def test_exact_sums_with_full_size_weights(cuda):
    # weights as large as the data (not broadcast): the prologue reads all of
    # them, and the sums are those of the broadcast volume's copy
    t, s, vol = _ecco_like(cuda, (8, 6, 20_000), seed=27)
    full = vol.unsqueeze(0).expand_as(t).contiguous()
    h_full, _ = xhistogram_torch.histogram(t, s, bins=[T_EDGES, S_EDGES], axis=(0, 2),
                                           weights=full)
    assert _exact_launch()["exact"]
    h, _ = xhistogram_torch.histogram(t, s, bins=[T_EDGES, S_EDGES], axis=(0, 2),
                                      weights=vol)
    assert _exact_launch()["exact"]
    np.testing.assert_allclose(h_full.cpu().numpy(), h.cpu().numpy(), rtol=2.4e-7, atol=0)


def test_integer_weights_count_as_shared(cuda):
    t, s, vol = _ecco_like(cuda, (4, 4, 5_000), seed=28)
    before = dict(profiling.WEIGHTED_SLOTS)
    xhistogram_torch.histogram(t, s, bins=[T_EDGES, S_EDGES], axis=(0, 2),
                               weights=(vol / 1e6).to(torch.int64))
    launch = _exact_launch()
    assert not launch["exact"] and launch["shared"]
    assert profiling.WEIGHTED_SLOTS["shared"] == before["shared"] + 1


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


NARROW_ROUTES = ("joint2", "full", "per_row", "packed", "direct")


def _narrow_route_run(route, layouts, edges, weights=None):
    """(kernel result, launch record) of a joint2, factored or direct call on
    the card, held bit for bit against the plain version on a copy widened
    to float32 or int32 (float sums within two float32 ulps)."""
    thr = [torch.from_numpy(tbins.compare_form(np.asarray(e), _compare_dtype(x)).edges)
           .to(x.device) for e, x in zip(edges, layouts)]
    nbins = [len(e) - 1 for e in edges]
    wide = [x if not (x.dtype.itemsize < 4 or x.dtype == torch.bool) else
            x.to(torch.float32 if x.dtype.is_floating_point else torch.int32)
            for x in layouts]
    wthr = [t.to(x.dtype) for t, x in zip(thr, wide)]

    def run(ls, ts, plain):
        if route == "joint2":
            fn = cuda_hist.joint2_reference if plain else cuda_hist.joint2
            return fn(*ls, *ts, *nbins, weights=weights)
        if route == "direct":
            fn = cuda_hist.direct_reference if plain else cuda_hist.direct
            return fn(ls, ts, nbins, weights=weights)
        fn = cuda_hist.factored_reference if plain else cuda_hist.factored
        return fn(ls, ts, nbins, route == "full", weights=weights)

    got = run(layouts, thr, False)
    torch.cuda.synchronize()
    launch = cuda_hist.last_launch()
    want = run(wide, wthr, True)
    if weights is None or not got.is_floating_point():
        assert torch.equal(got, want), launch
    else:
        _assert_sums_equal(got, want)
    return got, launch


@pytest.mark.parametrize("route", NARROW_ROUTES)
@pytest.mark.parametrize("dtype", NARROW_DTYPES, ids=str)
def test_narrow_kernels_read_in_place(cuda, dtype, route):
    # joint2, factored and direct read two narrow inputs at their own width
    # (the launch record's loads), bit-equal to the plain version on a
    # widened copy, for counts and every accumulator class, contiguous and
    # at odd offsets and strides
    x, edges = _narrow_data(dtype, (64, 4096), cuda, seed=11)
    y, _ = _narrow_data(dtype, (64, 4096), cuda, seed=12)
    lay = (lambda t: t.reshape(-1)) if route == "joint2" else \
        (lambda t: t.reshape(-1, 64)) if route in ("packed", "direct") else (lambda t: t)
    for wdtype in (None, torch.float32, torch.int32, torch.int64):
        w = None if wdtype is None else _weights(tuple(lay(x).shape), wdtype, cuda, seed=5)
        _, launch = _narrow_route_run(route, [lay(x), lay(y)], [edges, edges], w)
        assert launch["loads"] == (dtype, dtype)
    if route == "joint2":
        xf, yf = x.reshape(-1), y.reshape(-1)
        for a, b in ((xf[1:], yf[1:]), (xf[4:], yf[1:-3]), (xf[3:-2], yf[3:-2])):
            _, launch = _narrow_route_run(route, [a, b], [edges, edges])
            assert launch["loads"] == (dtype, dtype)
    else:
        _, launch = _narrow_route_run(route, [lay(x.t()[1:].t()), lay(y[:, :-1])],
                                      [edges, edges])
        assert launch["loads"] == (dtype, dtype)
    if route == "direct":
        assert launch["kernel"] == "direct_rows"


@pytest.mark.parametrize("route", NARROW_ROUTES)
@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.bool], ids=str)
def test_narrow_table_at_every_value(cuda, dtype, route):
    # the 8-bit table holds every value's bin: each value of the type, against
    # edges on values and between them, in every route, beside a float32
    # input (factored, direct) and beside itself
    if dtype == torch.bool:
        v = torch.tensor([False, True], device=cuda).repeat(64 * 64)
        edge_sets = [np.array([0.0, 0.5, 1.0]), np.array([-1.0, 1.0]), np.array([0.0, 1.0])]
    else:
        lo = -128 if dtype == torch.int8 else 0
        v = torch.arange(lo, lo + 256, device=cuda).to(dtype).repeat(32)
        edge_sets = [np.arange(lo, lo + 257, 7.0), np.arange(lo - 0.5, lo + 256, 3.0),
                     np.array([lo + 0.0, lo + 255.0]), np.array([lo - 3.0, lo + 300.0])]
    lay = (lambda t: t.reshape(-1)) if route == "joint2" else (lambda t: t.reshape(-1, 64))
    f = torch.linspace(-1, 1, v.numel(), device=cuda)
    for edges in edge_sets:
        _, launch = _narrow_route_run(route, [lay(v), lay(v.flip(0))], [edges, edges])
        assert launch["loads"] == (dtype, dtype)
        if route != "joint2":
            _, launch = _narrow_route_run(route, [lay(v), lay(f)], [edges, _edges(10)])
            assert launch["loads"] == (dtype, torch.float32)


@pytest.mark.parametrize("dtype", NARROW_DTYPES, ids=str)
def test_narrow_public_calls_allocate_no_widened_copy(cuda, dtype):
    # the public call hands joint2, factored and direct the data as it lies:
    # its peak allocation stays below one widened copy of the inputs (beside
    # the output), and it equals the call on the CPU
    x, edges = _narrow_data(dtype, (64, 1 << 16), cuda, seed=21)
    y, _ = _narrow_data(dtype, (64, 1 << 16), cuda, seed=22)
    for args, axis, counter in (((x, y), None, "joint2"),
                                ((x, y), (1,), "factored"),
                                ((x.reshape(-1, 64), y.reshape(-1, 64)), (1,), "direct")):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = _launch_counts()
        h, _ = xhistogram_torch.histogram(*args, bins=[edges, edges], axis=axis)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        launched = [a - b for a, b in zip(_launch_counts(), before)]
        assert sum(launched) == 1, launched
        assert cuda_hist.last_launch()["loads"] == (dtype, dtype)
        out_bytes = 8 * h.numel() * 2  # the kernel's output and the trimmed result
        assert extra < out_bytes + 4 * x.numel(), (counter, extra)
        h_cpu, _ = xhistogram_torch.histogram(*(a.cpu() for a in args), bins=[edges, edges],
                                              axis=axis)
        assert torch.equal(h.cpu(), h_cpu)


# --- the public API above core: the f64 tier, streaming, labeled, compat ------

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
    before, routes = _launch_counts(), dict(profiling.ROUTES)
    h1, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, weights=w,
                                       precision="f64")
    launched = [a - b for a, b in zip(_launch_counts(), before)]
    assert launched[_ROUTE_COUNTER[kernel]] >= 2  # groups x limbs passes
    assert sum(launched) == launched[_ROUTE_COUNTER[kernel]]
    assert {r: n - routes[r] for r, n in profiling.ROUTES.items()
            if n != routes[r]} == {kernel: 1}
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


def _op_cases(device, weights):
    """(op, arguments) of each kernel op on the card."""
    ops = torch.ops.xhistogram
    gen = torch.Generator(device=device).manual_seed(40)
    a, b = (torch.rand(64, 4096, device=device, generator=gen) for _ in range(2))
    w = None if weights is None else (torch.rand(64, 4096, device=device, generator=gen)
                                      * 100).to(weights)
    thr = torch.linspace(0.0, 1.0, 41, device=device)
    w_rows = None if w is None else w[:, :64]
    return [
        (ops.one_input, (a, thr, w, 40, False)), (ops.one_input, (a, thr, w, 40, True)),
        (ops.joint2, (a, b, thr, thr, w, 40, 40)),
        *((ops.factored, ([a, b], [thr, thr], w, [40, 40], reduce_all))
          for reduce_all in (True, False)),
        (ops.direct, ([a, b], [thr, thr], w, [40, 40])),
        # rows of 64: the direct-row kernel (csrc/direct.cuh), raw and finished
        (ops.direct, ([a[:, :64], b[:, :64]], [thr, thr], w_rows, [40, 40])),
        (ops.direct, ([a[:, :64], b[:, :64]], [thr, thr], w_rows, [40, 40], True)),
    ]


@pytest.mark.parametrize("weights", [None, torch.float32, torch.int32, torch.int64], ids=str)
def test_opcheck_on_cuda(cuda, weights):
    """Each kernel op passes torch.library.opcheck on CUDA tensors (its
    fake implementation against the kernel's output), launches its kernel,
    and equals the op on the same data on the CPU (the plain version)."""
    before = _launch_counts()
    for op, args in _op_cases(cuda, weights):
        torch.library.opcheck(op, args)
        got = op(*args)
        want = op(*torch.utils._pytree.tree_map_only(torch.Tensor, lambda t: t.cpu(), args))
        assert got.device.type == "cuda" and got.dtype == want.dtype
        if got.is_floating_point():
            torch.testing.assert_close(got.cpu(), want, rtol=1e-12, atol=0)
        else:
            assert torch.equal(got.cpu(), want)
    assert _launch_counts() != before


# --- the direct-row kernel (csrc/direct.cuh) --------------------------------------

ALL_DATA_DTYPES = [torch.float32, torch.float64, torch.int32, torch.int64, *NARROW_DTYPES]


def _row_data(dtype, shape, device, seed):
    """(data, edges) of ``dtype`` for the direct-row kernel: N(0, 1.5) floats
    with NaN and infinities, integers over a span that straddles the edges."""
    if dtype in NARROW_DTYPES:
        return _narrow_data(dtype, shape, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtype.is_floating_point:
        x = (1.5 * torch.randn(shape, device=device, generator=gen)).to(dtype)
        x.view(-1)[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
        return x, _edges(40)
    scale = 2.0**40 if dtype == torch.int64 else 1000.0
    x = (1.5 * scale * torch.randn(shape, device=device, generator=gen)).to(dtype)
    return x, np.linspace(-3 * scale - 0.5, 3 * scale + 0.5, 41)


def _row_pair(layouts, edges, weights=None, finish=True, rows_kernel=True):
    """(kernel, plain) on the card for the direct route: checks one launch,
    and which kernel ran (the direct-row kernel, or the template outside
    its envelope)."""
    thr = []
    for x, e in zip(layouts, edges):
        ce = tbins.compare_form(np.asarray(e), _compare_dtype(x))
        assert ce.n_hi_clip == 0
        thr.append(torch.from_numpy(_searched(ce.edges)).to(x.device))
    nbins = [len(e) - 1 for e in edges]
    before = cuda_hist.DIRECT_LAUNCHES
    got = cuda_hist.direct(layouts, thr, nbins, weights=weights, finish=finish)
    torch.cuda.synchronize()
    nonempty = layouts[0].numel() > 0
    assert cuda_hist.DIRECT_LAUNCHES == before + nonempty
    if nonempty:
        ran = cuda_hist.last_launch()["kernel"]
        assert ran == ("direct_rows" if rows_kernel else "joint2/slot"), ran
    want = cuda_hist.direct_reference(layouts, thr, nbins, weights=weights,
                                      finish=finish)
    assert got.shape == (layouts[0].shape[0], int(np.prod(nbins)) + 1)
    return got, want


@pytest.mark.parametrize("dtype", ALL_DATA_DTYPES, ids=str)
def test_direct_rows_data_dtypes(cuda, dtype):
    x, e = _row_data(dtype, (300, 64), cuda, seed=1)
    y, f = _row_data(dtype, (300, 64), cuda, seed=2)
    for layouts, edges in (([x, y], [e, f]), ([x], [e])):
        got, want = _row_pair(layouts, edges)
        assert got.dtype == torch.int64 and torch.equal(got, want), dtype


@pytest.mark.parametrize("finish", [True, False], ids=["finished", "raw"])
@pytest.mark.parametrize("dtype", WEIGHT_DTYPES, ids=str)
def test_direct_rows_weight_classes(cuda, dtype, finish):
    """Every weight dtype, its rows stored in their finished dtype (float32
    for float weights narrower than float64) or in their accumulator class;
    the finished rows are the raw rows rounded once, bit for bit (the
    kernel adds in lane order, the same in both)."""
    layouts = _layouts("direct", 500, 64, cuda, seed=3)
    layouts[0][::5, ::7] = float("nan")
    w = _weights((500, 64), dtype, cuda, seed=4)
    got, want = _row_pair(layouts, [_edges(40), _edges(30)], w, finish=finish)
    assert got.dtype == want.dtype
    _assert_sums_equal(got, want)
    if finish:
        raw, _ = _row_pair(layouts, [_edges(40), _edges(30)], w, finish=False)
        assert torch.equal(got, finish_sums(raw, dtype))


@pytest.mark.parametrize("c", [1, 2, 31, 32, 33, 63, 64, 65, 96, 127, 128, 200, 255])
def test_direct_rows_row_lengths(cuda, c):
    layouts = _layouts("direct", 257, c, cuda, seed=c)
    edges = [_edges(40), _edges(40)]
    got, want = _row_pair(layouts, edges)
    assert torch.equal(got, want)
    for dtype in (torch.float32, torch.int32, torch.int64):
        got, want = _row_pair(layouts, edges, _weights((257, c), dtype, cuda, seed=c))
        _assert_sums_equal(got, want)


def test_direct_rows_strided_and_broadcast_views(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(300, 200, device=cuda, generator=gen)
    row = torch.randn(1, 100, device=cuda, generator=gen).expand(300, 100)  # stride 0
    col = torch.randn(300, 1, device=cuda, generator=gen).double().expand(300, 100)
    w = _weights((300, 100), torch.float32, cuda, seed=6)
    w_row = _weights((1, 100), torch.int32, cuda, seed=7).expand(300, 100)
    edges = [_edges(20), _edges(30), _edges(10)]
    for layouts in ([a[:, ::2], row], [a[:, :100].t().contiguous().t(), col],
                    [row, col, a[:, 100:]], [a[::3, 1::2][:, :100], row]):
        m = min(x.shape[0] for x in layouts)
        layouts = [x[:m] for x in layouts]
        got, want = _row_pair(layouts, edges[: len(layouts)])
        assert torch.equal(got, want)
        for weights in (w[:m], w[:m].t().contiguous().t(), w_row[:m], w[:m, :1].expand(m, 100)):
            got, want = _row_pair(layouts, edges[: len(layouts)], weights)
            _assert_sums_equal(got, want)


@pytest.mark.parametrize(
    "nbins",
    # 16 warps a block at 1600 int64 slots, fewer from 6,000 on, one at 8,192
    # float64 sums; past 8,192 slots the template runs
    [(1,), (40, 40), (75, 80), (80, 80), (64, 64), (90, 91), (128, 64), (4, 8, 16, 16),
     (129, 64)],
    ids=str,
)
def test_direct_rows_slots_either_side_of_the_warp_limits(cuda, nbins):
    layouts = _layouts("direct", 700, 64, cuda, seed=len(nbins))[:1] * len(nbins)
    layouts = [x.roll(i, 1) for i, x in enumerate(layouts)]
    edges = [_edges(nb) for nb in nbins]
    rows_kernel = int(np.prod(nbins)) <= 8192
    got, want = _row_pair(layouts, edges, rows_kernel=rows_kernel)
    assert torch.equal(got, want)
    if rows_kernel:
        warps = cuda_hist.last_launch()["warps_per_block"]
        assert 1 <= warps <= 16
    for dtype in (torch.float32, torch.float64, torch.int32, torch.uint64):
        for finish in (True, False):
            got, want = _row_pair(layouts, edges, _weights((700, 64), dtype, cuda, seed=9),
                                  finish=finish, rows_kernel=rows_kernel)
            _assert_sums_equal(got, want)


def test_direct_rows_nonfinite_weights(cuda):
    """NaN makes its own bin NaN, +inf and -inf together make it NaN, one
    infinity makes it that infinity, in float32 and float64 rows."""
    layouts = _layouts("direct", 64, 64, cuda, seed=13)
    layouts[0][:, ::11] = float("nan")
    w = _weights((64, 64), torch.float32, cuda, seed=14)
    w[:, ::11] = float("nan")  # on NaN data: never added
    layouts[0][0, 1:6] = torch.tensor([-2.625, -1.875, -1.125, -0.375, -0.375])
    layouts[1][0, 1:6] = 0.25
    inf = float("inf")
    w[0, 1:6] = torch.tensor([float("nan"), inf, -inf, inf, -inf])
    for weights in (w, w.double()):
        for finish in (True, False):
            got, want = _row_pair(layouts, [_edges(8), _edges(6)], weights, finish=finish)
            assert got.isnan().any() and got.isposinf().any() and got.isneginf().any()
            _assert_sums_equal(got, want)


def test_direct_rows_empty_rows(cuda):
    """No rows or no columns launch nothing; rows whose every element is NaN
    or out of range come back zero, the trash slot too."""
    for m, c in ((0, 64), (64, 0)):
        layouts = _layouts("direct", m, c, cuda, seed=15)
        got, want = _row_pair(layouts, [_edges(40), _edges(40)],
                              _weights((m, c), torch.float32, cuda, seed=16))
        assert got.dtype == torch.float32 and torch.equal(got, want) and not got.any()
    layouts = _layouts("direct", 40, 64, cuda, seed=17)
    layouts[0][::2] = float("nan")
    layouts[1][1::2] = 100.0
    for weights in (None, _weights((40, 64), torch.float32, cuda, seed=18)):
        got, want = _row_pair(layouts, [_edges(40), _edges(40)], weights)
        assert not got.any() and torch.equal(got, want)


def test_direct_rows_many_inputs_and_reruns(cuda):
    """One input, three (the run-time input count) and twelve of two bins;
    each kernel run twice gives the same bits (no atomics: lane order)."""
    x = _layouts("direct", 333, 100, cuda, seed=19)[0]
    w = _weights((333, 100), torch.float32, cuda, seed=20)
    for nbins in ((2000,), (10, 12, 8), (2,) * 12):
        layouts = [x.roll(i, 1) for i in range(len(nbins))]
        edges = [_edges(nb) for nb in nbins]
        for weights in (None, w):
            got, want = _row_pair(layouts, edges, weights)
            _assert_sums_equal(got, want, exact=weights is None)
            again, _ = _row_pair(layouts, edges, weights)
            assert torch.equal(got, again)


def test_direct_outside_the_rows_envelope_runs_the_template(cuda):
    """Rows of 256 elements or more run the flat-slot template's direct
    entries, with the same results; int64 beside a float, within the
    envelope, runs the row kernel's mixed entry."""
    layouts = _layouts("direct", 50, 256, cuda, seed=21)
    got, want = _row_pair(layouts, [_edges(40)] * 2, rows_kernel=False)
    assert torch.equal(got, want)
    w = _weights((50, 256), torch.float32, cuda, seed=22)
    got, want = _row_pair(layouts, [_edges(40)] * 2, w, rows_kernel=False)
    assert got.dtype == torch.float32
    _assert_sums_equal(got, want)
    big = (layouts[0][:, :64] * 2.0**40).long()
    got, want = _row_pair([big, layouts[1][:, :64]],
                          [np.linspace(-(2.0**42), 2.0**42, 41), _edges(40)])
    assert torch.equal(got, want)
    assert cuda_hist.last_launch()["loads"] == (torch.int64, torch.float32)


# --- the direct-row kernel past the JAX package's kept-row cap ------------------

def _ensemble(cuda, months, seed):
    """Monthly surface T and S of 100 ensemble members on a 320 x 384 grid,
    (member, month, lat, lon) float32, the member axis outermost: each
    cell's mean state (T 28 - 30 sin^2(lat) deg C clamped at -1.8, S drawn
    from N(35.29, 1.48^2) psu) and each member's anomaly, N(0, 0.6^2) and
    N(0, 0.15^2); land, 29% of the cells in smooth blobs, NaN in every
    member. And 40 edges of 1 deg C on [-2, 38], 40 of 0.25 psu on [30,
    40]."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    lat = torch.deg2rad(torch.linspace(-89.765625, 89.765625, 384, device=cuda))[:, None]
    lon = torch.deg2rad(torch.linspace(0.5625, 359.4375, 320, device=cuda))[None, :]
    field = torch.sin(3 * lat) * torch.cos(2 * lon) + 0.5 * torch.sin(5 * lon + 1) * torch.cos(lat)
    land = field > torch.quantile(field.reshape(-1), 0.708)
    shape = (100, months, 384, 320)
    t = torch.randn(shape, device=cuda, generator=gen).mul_(0.6)
    t.add_((28 - 30 * torch.sin(lat) ** 2).clamp_min(-1.8))
    s_mean = torch.randn((384, 320), device=cuda, generator=gen).mul_(1.48).add_(35.29)
    s = torch.randn(shape, device=cuda, generator=gen).mul_(0.15).add_(s_mean)
    edges = [np.linspace(-2, 38, 41).astype(np.float32),
             np.linspace(30, 40, 41).astype(np.float32)]
    return t.masked_fill_(land, float("nan")), s.masked_fill_(land, float("nan")), edges


def test_direct_rows_an_ensemble_call_reads_its_view_in_place(cuda):
    """The joint T-S of each cell and month over 100 members, six months:
    737,280 kept rows in 40 x 40 bins, past the JAX package's kept-row cap.
    plan() names direct, the direct-row kernel reads the member-strided view
    in place (no layout copy) with no host sync, once a call, and its counts
    equal the plain scatter path's."""
    from xhistogram_torch.utils import profiling

    t, s, edges = _ensemble(cuda, 6, seed=18)
    assert cuda_hist.plan(2, (40, 40), 737_280, 100) == "direct"
    before = (cuda_hist.DIRECT_LAUNCHES, cuda_hist.LAYOUT_COPIES, profiling.HOST_SYNCS,
              profiling.ROUTES["direct"])
    for _ in range(2):
        h, _ = xhistogram_torch.histogram(t, s, bins=edges, axis=0)
        launch = cuda_hist.last_launch()
        assert launch["kernel"] == "direct_rows" and launch["view"] == "in place", launch
    assert (cuda_hist.DIRECT_LAUNCHES, cuda_hist.LAYOUT_COPIES, profiling.HOST_SYNCS,
            profiling.ROUTES["direct"]) == (before[0] + 2, before[1], before[2], before[3] + 2)
    assert h.shape == (6, 384, 320, 40, 40) and h.dtype == torch.int64
    plain, _ = xhistogram_torch.histogram(t, s, bins=edges, axis=0, method="scatter")
    assert torch.equal(h, plain)


def test_direct_rows_past_two_to_the_31_output_elements(cuda):
    """The full year of the same ensemble: 1,474,560 kept rows of 100
    members, an output of 1,474,560 x 1,601 = 2.36e9 int64 slots, more
    than 2^31. The direct-row kernel runs once and every row equals the
    plain version, walked in blocks of rows."""
    t, s, edges = _ensemble(cuda, 12, seed=19)
    m = 12 * 384 * 320
    assert m * 1601 > 2**31 and cuda_hist.plan(2, (40, 40), m, 100) == "direct"
    before = cuda_hist.DIRECT_LAUNCHES
    h, _ = xhistogram_torch.histogram(t, s, bins=edges, axis=0)
    assert cuda_hist.DIRECT_LAUNCHES == before + 1
    assert cuda_hist.last_launch()["kernel"] == "direct_rows"
    rows = h.reshape(m, 1600)
    thr = [_thresholds(e, cuda) for e in edges]
    t2, s2 = t.reshape(100, m).t(), s.reshape(100, m).t()  # (row, member) views
    block = 1 << 17
    for r0 in range(0, m, block):
        want = cuda_hist.direct_reference([t2[r0:r0 + block], s2[r0:r0 + block]], thr,
                                          [40, 40])
        assert not want[:, -1].any()
        assert torch.equal(rows[r0:r0 + block], want[:, :-1]), r0


# --- inputs of two dtypes, each read in place ----------------------------------

PAIRS = [(a, b) for a in ALL_DATA_DTYPES for b in ALL_DATA_DTYPES if a != b]


def _pair_layouts(route, x, y):
    """Two inputs of one shape, laid out as ``route`` takes them: flat for
    joint2, rows of 64 for packed and direct, 64 rows for the others."""
    lay = (lambda t: t.reshape(-1)) if route == "joint2" else \
        (lambda t: t.reshape(-1, 64)) if route in ("packed", "direct") else \
        (lambda t: t.reshape(64, -1))
    return lay(x), lay(y)


@pytest.mark.parametrize("da,db", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_pairs_of_two_dtypes_read_in_place(cuda, da, db):
    # every ordered pair of two data dtypes, on every route: each input read
    # at its own width (the launch record's loads), bit-equal to the plain
    # version on copies widened to float32 or int32, for counts and every
    # accumulator class; joint2 also over ragged sizes and at odd offsets
    # (its vector loads where an input is narrow)
    x, ex = _row_data(da, (64, 4096), cuda, seed=31)
    y, ey = _row_data(db, (64, 4096), cuda, seed=32)
    for route in NARROW_ROUTES:
        a, b = _pair_layouts(route, x, y)
        for wdtype in (None, torch.float32, torch.int32, torch.int64):
            w = None if wdtype is None else _weights(tuple(a.shape), wdtype, cuda, seed=6)
            _, launch = _narrow_route_run(route, [a, b], [ex, ey], w)
            assert launch["loads"] == (da, db), (route, launch)
        if route == "direct":
            assert launch["kernel"] == "direct_rows"
    a, b = x.reshape(-1), y.reshape(-1)
    for va, vb in ((a[1:], b[1:]), (a[4:], b[1:-3]), (a[3:-2], b[3:-2]), (a[:4097], b[:4097]),
                   (a[:7], b[:7])):
        _, launch = _narrow_route_run("joint2", [va, vb], [ex, ey])
        assert launch["loads"] == (da, db)
    _, launch = _narrow_route_run("per_row", [x.t()[1:].t(), y[:, :-1]], [ex, ey])
    assert launch["loads"] == (da, db)


@pytest.mark.parametrize("other", [torch.float32, torch.float64, torch.int32, torch.int64],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.bool], ids=str)
def test_pair_table_at_every_value(cuda, dtype, other):
    # an 8-bit input's table holds every value's bin beside a wide input of
    # another type: joint2's pairs with float32 and its mixed entry beside
    # the rest, the template's and the row kernel's narrow and mixed entries
    if dtype == torch.bool:
        v = torch.tensor([False, True], device=cuda).repeat(64 * 64)
        edge_sets = [np.array([0.0, 0.5, 1.0]), np.array([-1.0, 1.0])]
    else:
        lo = -128 if dtype == torch.int8 else 0
        v = torch.arange(lo, lo + 256, device=cuda).to(dtype).repeat(32)
        edge_sets = [np.arange(lo, lo + 257, 7.0), np.arange(lo - 0.5, lo + 256, 3.0)]
    f, ef = _row_data(other, (v.numel(),), cuda, seed=33)
    for route in NARROW_ROUTES:
        a, b = _pair_layouts(route, v, f)
        for edges in edge_sets:
            _, launch = _narrow_route_run(route, [a, b], [edges, ef])
            assert launch["loads"] == (dtype, other)
            _, launch = _narrow_route_run(route, [b, a], [ef, edges])
            assert launch["loads"] == (other, dtype)


MIXED_PUBLIC_PAIRS = [(torch.int16, torch.float32), (torch.bfloat16, torch.float32),
                      (torch.int32, torch.float32), (torch.float32, torch.float64),
                      (torch.int32, torch.int64), (torch.bfloat16, torch.float16),
                      (torch.int16, torch.int64)]


@pytest.mark.parametrize("da,db", MIXED_PUBLIC_PAIRS,
                         ids=[f"{a}-{b}" for a, b in MIXED_PUBLIC_PAIRS])
def test_mixed_public_calls_allocate_no_widened_copy(cuda, da, db):
    # the public call hands joint2, factored and direct a pair of two dtypes
    # as it lies: its peak allocation stays below a copy of the narrower
    # input at 2 bytes an element (beside the output), and it equals the
    # call on the CPU
    x, ex = _row_data(da, (64, 1 << 16), cuda, seed=41)
    y, ey = _row_data(db, (64, 1 << 16), cuda, seed=42)
    for args, axis, counter in (((x, y), None, "joint2"),
                                ((x, y), (1,), "factored"),
                                ((x.reshape(-1, 64), y.reshape(-1, 64)), (1,), "direct")):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = _launch_counts()
        h, _ = xhistogram_torch.histogram(*args, bins=[ex, ey], axis=axis)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        launched = [a - b for a, b in zip(_launch_counts(), before)]
        assert sum(launched) == 1, launched
        assert cuda_hist.last_launch()["loads"] == (da, db)
        out_bytes = 8 * h.numel() * 2  # the kernel's output and the trimmed result
        assert extra < out_bytes + 2 * x.numel(), (counter, extra)
        h_cpu, _ = xhistogram_torch.histogram(*(a.cpu() for a in args), bins=[ex, ey],
                                              axis=axis)
        assert torch.equal(h.cpu(), h_cpu)


# --- strided views read in place; uint32 and uint64 at their own width -------

def _view_operands(kind, device, dtype=torch.float32, wdtype=None, seed=0):
    """``(views, weights view or None, edges, reduce_all)``: two inputs of
    ``dtype`` (and weights of ``wdtype``) of one view kind, as
    ``utils.axes.strided_layout`` hands them to the kernels."""
    from xhistogram_torch.utils.axes import strided_layout

    gen = torch.Generator(device=device).manual_seed(seed)
    shape, axis, weights_shape = {
        "readme-axis02": ((6, 5, 3000), (0, 2), (5, 3000)),  # time, depth, cell
        "readme-axis1": ((6, 5, 3000), (1,), (6, 1, 3000)),
        "halo-trimmed": ((64, 1030), None, (64, 1030)),
        "broadcast-over-time": ((6, 5, 3000), None, (5, 3000)),
        "transposed": ((300, 40), (0,), (300, 40)),
        "mixed-strides": ((20, 30, 40), (0, 2), (30, 1)),
        "direct-two-column-levels": ((5, 300, 40), (0, 2), (300, 1)),
        "direct-two-row-levels": ((40, 7, 50), (1,), (40, 7, 50)),
    }[kind]
    x = (1.5 * torch.randn((2, *shape), device=device, generator=gen))
    x.view(-1)[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    a, b = x.to(dtype).unbind(0) if dtype.is_floating_point else (
        (1000 * x).nan_to_num(0.0, 0.0, 0.0).to(dtype).unbind(0))
    if kind == "halo-trimmed":
        a, b = a[:, 1:-1], b[:, 1:-1]
        weights_shape = a.shape
    if kind == "transposed":
        a, b = a.t().contiguous().t(), b.t()
    if kind == "mixed-strides":
        b = b.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    operands = [a, b]
    if wdtype is not None:
        operands.append(_weights(weights_shape, wdtype, device, seed + 1).expand(a.shape))
    layout = strided_layout(operands, axis)
    assert not layout.copied, kind
    for v, o in zip(layout.views, operands):
        assert v.data_ptr() == o.data_ptr()
    edges = _edges(40) if dtype.is_floating_point else np.linspace(-3000.5, 3000.5, 41)
    weights = layout.views[2] if wdtype is not None else None
    return layout.views[:2], weights, edges, axis is None


VIEW_KINDS = ["readme-axis02", "readme-axis1", "halo-trimmed", "broadcast-over-time",
              "transposed", "mixed-strides", "direct-two-column-levels",
              "direct-two-row-levels"]


def _view_kernels(kind, reduce_all):
    if reduce_all:
        return ["joint2", "one_input_full", "full"]
    kernels = ["one_input_kept", "per_row", "packed", "direct"]
    return kernels


@pytest.mark.parametrize("wdtype", [None, torch.int32, torch.float32], ids=str)
@pytest.mark.parametrize("kind", VIEW_KINDS)
def test_kernels_read_views_in_place(cuda, kind, wdtype):
    # each kernel on each view kind, bit-equal (float sums within a float32
    # rounding) to its plain version on contiguous copies, with no copy
    views, weights, edges, reduce_all = _view_operands(kind, cuda, wdtype=wdtype)
    for kernel in _view_kernels(kind, reduce_all):
        layouts = views[:1] if kernel.startswith("one_input") else views
        edge_list = [edges] * len(layouts)
        got = _run(kernel, layouts, edge_list, weights, plain=False)
        torch.cuda.synchronize()
        rec = cuda_hist.last_launch()
        assert rec["view"] == "in place", (kind, kernel, rec)
        if kernel == "direct" and kind.startswith("direct"):
            assert rec["kernel"] == "direct_rows", (kind, rec)
        copies = [v.contiguous() for v in layouts]
        want = _run(kernel, copies, edge_list,
                    None if weights is None else weights.contiguous(), plain=True)
        _assert_sums_equal(got, want)


def test_a_side_of_three_levels_is_copied_and_reported(cuda):
    x = torch.randn(6, 8, 10, device=cuda)[::2, ::2, ::2]
    before = cuda_hist.LAYOUT_COPIES
    h, _ = xhistogram_torch.histogram(x, bins=[_edges(40)])
    assert cuda_hist.last_launch()["view"] == "copied"
    assert cuda_hist.LAYOUT_COPIES == before + 1
    h2, _ = xhistogram_torch.histogram(x.contiguous(), bins=[_edges(40)])
    assert torch.equal(h, h2)
    assert cuda_hist.last_launch()["view"] == "in place"


@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "by-volume"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16], ids=str)
def test_readme_call_allocates_no_copy_of_its_view(cuda, dtype, weighted):
    # the README call, axis=(0, 2) on (time, depth, cell), runs factored per
    # row on the caller's memory: its peak allocation beside the inputs is
    # the output (and the trimmed result) and ~1 MB, not a copy of the data
    # (2 x 104 MB here) or of the broadcast volume
    gen = torch.Generator(device=cuda).manual_seed(7)
    t = 14 + 8 * torch.randn(8, 50, 64800, device=cuda, generator=gen)
    s = 35 + 1.5 * torch.randn(8, 50, 64800, device=cuda, generator=gen)
    te, se = T_EDGES, S_EDGES
    if dtype == torch.int16:  # CF-packed: T in centidegrees, S - 35 in milli-units
        t, s = (100 * t).round().to(dtype), (1000 * (s - 35)).round().to(dtype)
        te, se = np.round(100 * T_EDGES), np.round(1000 * (S_EDGES - 35))
    volume = (0.5 + torch.rand(50, 64800, device=cuda, generator=gen)) if weighted else None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = cuda_hist.FACTORED_LAUNCHES, profiling.ROUTES["factored_per_row"]
    h, _ = xhistogram_torch.histogram(t, s, bins=[te, se], axis=(0, 2), weights=volume)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert (cuda_hist.FACTORED_LAUNCHES, profiling.ROUTES["factored_per_row"]) == (
        before[0] + 1, before[1] + 1)
    assert cuda_hist.last_launch()["view"] == "in place"
    out_bytes = 8 * 50 * (len(te) - 1) * (len(se) - 1)
    assert extra < 2 * out_bytes + (1 << 20), extra
    # the same call on copies in canonicalize_2d's layout
    from xhistogram_torch.utils.axes import canonicalize_2d

    layouts = [canonicalize_2d(x, (0, 2)) for x in (t, s)]
    w2d = None if volume is None else canonicalize_2d(volume.expand(t.shape), (0, 2))
    thr = [torch.from_numpy(tbins.compare_form(e, _compare_dtype(x)).edges).to(cuda)
           for e, x in zip((te, se), (t, s))]
    want = cuda_hist.factored(layouts, thr, [len(te) - 1, len(se) - 1], False,
                              weights=w2d)
    want = want[:, :-1].reshape(h.shape)
    _assert_sums_equal(h, want)


def test_packed_int16_census_by_level_reads_in_place_with_exact_sums(cuda):
    # GLORYS12V1's census by level (the benchmark's ts_glorys12v1_int16) on
    # 4 months of a 0.5-degree grid: CF-packed int16 T and S with the fill
    # value on land and rock, edges in packed units (no edge an integer),
    # the product's 50 levels, whose thin top layers' volumes are not all
    # whole multiples of the unit the largest sets. The public call runs
    # factored per row on the narrow flat-slot entry, both inputs read as
    # int16 where they lie, the volume summed as exact integers in a
    # cluster but for the weights that fall back; counts equal the plain
    # path's, sums the benchmark's reference within the cell's limit
    import json

    from portbench import reference, registry
    from portbench.recipes import ts_depth_packed

    config = {**json.loads((registry.HERE / "configs" / "ts_glorys12v1_int16.json")
                           .read_text()), "months": 4, "nlat": 360, "nlon": 720}
    limit = json.loads((registry.HERE / "traffic" / "levels_vol_packed.json")
                       .read_text())["limits"]["sum_rel_gap"]
    d = ts_depth_packed.make(config, 2**33 + 29, cuda, ["T", "S", "volume"])
    t, s, vol = d["T"], d["S"], d["volume"]
    assert t.shape == (4, 50, 259200) and t.dtype == torch.int16
    edges = [d["T_edges"], d["S_edges"]]
    before = (cuda_hist.FACTORED_LAUNCHES, profiling.ROUTES["factored_per_row"],
              dict(profiling.NARROW_READS))
    h, _ = xhistogram_torch.histogram(t, s, bins=edges, axis=(0, 2), weights=vol)
    torch.cuda.synchronize()
    rec = cuda_hist.last_launch()
    assert (cuda_hist.FACTORED_LAUNCHES, profiling.ROUTES["factored_per_row"]) == (
        before[0] + 1, before[1] + 1)
    assert rec["exact"] and rec["fell_back"] > 0 and rec["cluster"] > 1
    assert rec["view"] == "in place" and rec["loads"] == (torch.int16, torch.int16)
    assert {k: profiling.NARROW_READS[k] - before[2][k] for k in before[2]} == {
        "in_place": 2, "widened": 0}
    want = reference.histogram([t, s], edges, (0, 2), vol)
    found = reference.compare({"hist": h, "edges": edges}, {"hist": want, "edges": edges})
    assert found["sum_rel_gap"] <= limit, found
    counts, _ = xhistogram_torch.histogram(t, s, bins=edges, axis=(0, 2))
    assert cuda_hist.last_launch()["view"] == "in place"
    plain, _ = xhistogram_torch.histogram(t, s, bins=edges, axis=(0, 2), method="scatter")
    assert counts.dtype == torch.int64 and int(counts.sum()) > 0
    assert torch.equal(counts, plain)
    assert torch.equal(counts.cpu(), reference.histogram([t, s], edges, (0, 2)).cpu())


U32_EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1],
                     np.uint64)
# the kernels take no edge at the top value (its closed bin needs the plain
# path's n_hi_clip): 2^64 - 1 lies above the last edge
U64_EDGES = np.array([0, 1, 2**31, 2**32 - 1, 2**63 - 1, 2**63, 2**63 + 1,
                      2**64 - 3, 2**64 - 2], np.uint64)


def _unsigned_data(dtype, shape, device, seed):
    """Random values of ``dtype`` with every boundary of its edges, and the
    edges (both sides of 0, 2^31, 2^32 - 1, 2^63 and 2^64 - 1)."""
    edges = U32_EDGES if dtype == torch.uint32 else U64_EDGES
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    np_dtype = np.uint32 if dtype == torch.uint32 else np.uint64
    top = np.iinfo(np_dtype).max
    x = rng.integers(0, top, n, dtype=np_dtype, endpoint=True)
    special = np.concatenate([edges, np.clip(edges.astype(object) - 1, 0, None).astype(np.uint64),
                              np.minimum(edges.astype(object) + 1, top).astype(np.uint64)])
    special = special[special <= top].astype(np_dtype)
    x[:special.size] = special
    rng.shuffle(x)
    return torch.from_numpy(x.reshape(shape)).to(device), edges.astype(np_dtype)


@pytest.mark.parametrize("wdtype", [None, torch.int32, torch.float32], ids=str)
@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64], ids=str)
def test_unsigned_through_every_kernel(cuda, dtype, wdtype):
    # uint32 and uint64 read at their own width by one_input's entries and
    # the mixed entries of joint2, factored and direct, bit-equal to the
    # plain version (which widens or flips a copy)
    x, ex = _unsigned_data(dtype, (64, 2048), cuda, seed=3)
    y, ey = _row_data(torch.float32, (64, 2048), cuda, seed=4)
    w = None if wdtype is None else _weights((64, 2048), wdtype, cuda, seed=5)
    for kernel, layouts, edges in (
            ("one_input_full", [x], [ex]), ("one_input_kept", [x], [ex]),
            ("joint2", [x, y], [ex, ey]), ("joint2", [x, x.flip(0)], [ex, ex]),
            ("full", [x, y], [ex, ey]), ("per_row", [y, x], [ey, ex]),
            ("packed", [x, y], [ex, ey])):
        got = _run(kernel, layouts, edges, w, plain=False)
        torch.cuda.synchronize()
        assert cuda_hist.last_launch()["loads"][:len(layouts)] == tuple(
            a.dtype for a in layouts)
        _assert_sums_equal(got, _run(kernel, layouts, edges, w, plain=True))
    rows = [x.reshape(-1, 64), y.reshape(-1, 64)]
    got, want = _row_pair(rows, [ex, ey],
                          None if w is None else w.reshape(-1, 64))
    _assert_sums_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64], ids=str)
def test_unsigned_public_calls_allocate_no_widened_copy(cuda, dtype):
    x, ex = _unsigned_data(dtype, (64, 1 << 16), cuda, seed=9)
    for axis in (None, (1,)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        h, _ = xhistogram_torch.histogram(x, bins=[ex], axis=axis)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        assert cuda_hist.last_launch()["loads"] == (dtype,)
        assert extra < 8 * h.numel() * 2 + (1 << 20), (axis, extra)
        h_cpu, _ = xhistogram_torch.histogram(x.cpu(), bins=[ex], axis=axis)
        assert torch.equal(h.cpu(), h_cpu)
