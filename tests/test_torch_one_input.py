"""one_input — the one-input path's kernel — against the JAX package.

On the CPU the wrapper runs ``one_input_reference``, the plain PyTorch
version the CUDA kernel is held to on the card (tests/test_torch_gpu.py,
chip_smoke.py). Here it, the public ``histogram`` (``method="auto"``, which
runs the scatter strategy on the CPU, and ``method="cuda"``, which runs the
kernel's wrapper), the JAX package's ``_one_input_kernel`` under the Pallas
interpreter (``method="pallas"``) and numpy must give the same counts, bit
for bit.
"""

import numpy as np
import pytest
import torch

import xhistogram_tpu
from xhistogram_tpu.ops import pallas_hist
import xhistogram_torch
from xhistogram_torch import bins as tbins
from xhistogram_torch.ops import cuda_hist
from xhistogram_torch.utils import profiling
from xhistogram_torch.utils.axes import canonicalize_2d, normalize_axis
from ts_cases import EDGE_SETS, edge_case_values, reference_numpy


def _edges(nb):
    if nb <= 64:
        return np.linspace(-3.0, 3.0, nb + 1)
    # not evenly spaced: the JAX plan() sends evenly spaced edges beyond 64
    # bins to its factored kernel, and this test wants its one_input kernel
    return np.sort(np.random.default_rng(nb).normal(0.0, 1.5, nb + 1))


def _reference(x, edges, axis):
    """one_input_reference on ``x``'s canonical layout, as the public call
    builds it, shaped like the histogram."""
    t = torch.from_numpy(x)
    axis_t = normalize_axis(axis, t.ndim)
    a2d = canonicalize_2d(t, axis_t)
    reduce_all = axis_t is None or a2d.shape[0] == 1
    nb = len(edges) - 1
    ce = tbins.compare_form(edges, x.dtype)
    assert ce.n_hi_clip == 0
    before = cuda_hist.ONE_INPUT_LAUNCHES
    out = cuda_hist.one_input_reference(a2d, torch.from_numpy(ce.edges), nb, reduce_all)
    assert cuda_hist.ONE_INPUT_LAUNCHES == before
    assert out.dtype == torch.int64
    assert out.shape == (1 if reduce_all else a2d.shape[0], nb + 1)
    assert (out[:, -1] == 0).all()  # the trash slot stays empty, as in JAX
    kept = tuple(s for i, s in enumerate(x.shape) if axis_t is not None and i not in axis_t)
    return out[:, :-1].reshape(kept + (nb,)).numpy()


def _all_agree(x, edges, axis=None, jax_kernel=True):
    """Numpy, the plain version, the public port (auto and cuda) and the JAX
    kernel give the same counts."""
    expected = reference_numpy(x, edges, axis)
    np.testing.assert_array_equal(_reference(x, edges, axis), expected)
    for method in ("auto", "cuda"):
        h, got_edges = xhistogram_torch.histogram(
            torch.from_numpy(x), bins=[edges], axis=axis, method=method
        )
        assert h.dtype == torch.int64 and h.device.type == "cpu"
        np.testing.assert_array_equal(h.numpy(), expected, err_msg=method)
        np.testing.assert_array_equal(got_edges[0], edges)
    if jax_kernel:
        jh, _ = xhistogram_tpu.histogram(x, bins=[edges], axis=axis, method="pallas")
        np.testing.assert_array_equal(np.asarray(jh), expected)


LAYOUTS = [
    ((16, 512), None),  # full reduction
    ((16, 512), (1,)),  # kept rows, contiguous (config 2's layout)
    ((12, 6, 9), (0,)),  # kept rows, (1, m)-strided view (config 4's layout)
    ((12, 6, 9), (1, 2)),
    ((1, 300), (1,)),  # one kept row: a full reduction for the kernel
    ((40, 1), (1,)),  # c = 1
    ((7, 365), (0,)),  # c = 7, strided
]


@pytest.mark.parametrize("nb", [1, 50, 64, 1024])
@pytest.mark.parametrize("shape,axis", LAYOUTS, ids=str)
def test_layouts_and_bin_counts(shape, axis, nb):
    x = np.random.default_rng(nb + len(shape)).normal(0.0, 1.5, shape).astype(np.float32)
    x.flat[::13] = np.nan
    _all_agree(x, _edges(nb), axis)


def _data(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int64:
        return rng.integers(-(2**45), 2**45, shape)  # beyond float32 and int32
    if np.dtype(dtype).kind == "i":
        return rng.integers(-4000, 4000, shape).astype(dtype)
    return rng.normal(0.0, 1.5, shape).astype(dtype)


def _dtype_edges(dtype):
    if dtype == np.int64:
        return np.linspace(-(2.0**44), 2.0**44, 51)
    if np.dtype(dtype).kind == "i":
        return np.linspace(-3000.5, 3000.5, 51)  # fractional edges
    return np.linspace(-3.0, 3.0, 51)


@pytest.mark.parametrize("axis", [None, (0,)], ids=["full", "kept-strided"])
@pytest.mark.parametrize(
    "dtype", [np.float32, np.float64, np.int32, np.int64, np.float16],
    ids=lambda d: np.dtype(d).name,
)
def test_dtypes(dtype, axis):
    x = _data(dtype, (12, 6, 9), seed=np.dtype(dtype).itemsize)
    _all_agree(x, _dtype_edges(dtype), axis)


def test_float16_widens_exactly():
    x = _data(np.float16, (8, 64), seed=3)
    ce16 = tbins.compare_form(_dtype_edges(np.float16), np.float16)
    t16 = torch.from_numpy(ce16.edges)
    got = cuda_hist.one_input_reference(torch.from_numpy(x), t16, 50, False)
    wide = cuda_hist.one_input_reference(
        torch.from_numpy(x).float(), t16.float(), 50, False
    )
    assert torch.equal(got, wide)


@pytest.mark.parametrize("which", [0, 1], ids=["first", "second"])
@pytest.mark.parametrize("name", list(EDGE_SETS))
def test_edge_cases(name, which):
    edges = EDGE_SETS[name][which]
    x = edge_case_values(edges, n_random=200, seed=which)
    _all_agree(x, np.asarray(edges))
    _all_agree(np.stack([x, x[::-1]]), np.asarray(edges), axis=(1,))


def test_negative_subnormal_is_below_a_zero_edge():
    x = np.array([-1e-45, 1e-45, -0.0, 0.0], np.float32)
    assert _reference(x, np.array([0.0, 1.0]), None).tolist() == [3]
    _all_agree(x, np.array([0.0, 1.0]))


@pytest.mark.parametrize("n", [0, 1, 7, 4097, (1 << 20) + 3])
def test_ragged_sizes(n):
    x = np.random.default_rng(n).normal(0.0, 1.5, n).astype(np.float32)
    # the JAX kernel takes no empty input, and its interpreter takes seconds
    # at 2^20; numpy holds those two
    _all_agree(x, _edges(50), jax_kernel=0 < n <= 4097)
    _all_agree(x.reshape(1, n), _edges(50), axis=(1,), jax_kernel=False)


@pytest.mark.parametrize("axis", [(1,), (0,)], ids=["rows", "strided-rows"])
def test_density_with_kept_rows(axis):
    x = np.random.default_rng(4).normal(0.0, 1.5, (8, 300)).astype(np.float32)
    edges = np.array([-3.0, -1.0, -0.25, 0.0, 0.5, 2.0, 4.0])
    jh, _ = xhistogram_tpu.histogram(x, bins=[edges], axis=axis, density=True,
                                     method="pallas")
    got = {}
    for method in ("auto", "cuda"):
        h, _ = xhistogram_torch.histogram(torch.from_numpy(x), bins=[edges],
                                          axis=axis, density=True, method=method)
        assert h.dtype == torch.float32
        got[method] = h
        # float32 counts / area / row totals, as in JAX, whose compiled
        # division may round the last bit differently
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6, atol=0,
                                   err_msg=method)
    # both port routes run the same ops in the same order on equal counts
    assert torch.equal(got["auto"], got["cuda"])


def test_wrapper_contract_on_cpu():
    x = torch.from_numpy(_data(np.float32, (6, 40), seed=1))
    thr = torch.from_numpy(tbins.compare_form(_edges(50), np.float32).edges)
    before = cuda_hist.ONE_INPUT_LAUNCHES
    # a strided view gives the same counts as its copy
    for reduce_all in (False, True):
        got = cuda_hist.one_input(x.t(), thr, 50, reduce_all)
        want = cuda_hist.one_input(x.t().contiguous(), thr, 50, reduce_all)
        assert torch.equal(got, want)
        assert got.shape == (1 if reduce_all else 40, 51)
    assert cuda_hist.ONE_INPUT_LAUNCHES == before  # the CPU path launches nothing
    # bfloat16 data compares against float32 thresholds, uint32 against
    # int64 ones; a dtype no kernel reads is refused
    with pytest.raises(TypeError, match="data must be in its compare dtype torch.float32"):
        cuda_hist.one_input(x.bfloat16(), thr.bfloat16(), 50, False)
    with pytest.raises(TypeError, match="data must be in its compare dtype torch.int64"):
        cuda_hist.one_input(x.to(torch.uint32), thr.to(torch.uint32), 50, False)
    with pytest.raises(TypeError, match="data, got torch.complex64"):
        cuda_hist.one_input(x.to(torch.complex64), thr, 50, False)
    with pytest.raises(TypeError, match="thresholds must be in the data's dtype"):
        cuda_hist.one_input(x.double(), thr, 50, False)
    with pytest.raises(ValueError, match="needs 51 thresholds"):
        cuda_hist.one_input(x, thr[:-1], 50, False)
    big = torch.linspace(-3, 3, 1026)
    with pytest.raises(ValueError, match="1 to 1024 bins"):
        cuda_hist.one_input(x, big, 1025, False)
    with pytest.raises(ValueError, match="1 to 1024 bins"):
        cuda_hist.one_input(x, thr[:1], 0, False)
    with pytest.raises(ValueError, match="2-D layout"):
        cuda_hist.one_input(x.reshape(-1), thr, 50, True)
    with pytest.raises(ValueError, match="share a device"):
        cuda_hist.one_input(x, thr.to("meta"), 50, False)


def test_the_output_counter_has_one_key_a_way():
    # "stored": the kernel wrote every slot; "zeroed": the launcher zeroed
    # the output first
    assert set(profiling.ONE_INPUT_OUTPUTS) == {"stored", "zeroed"}
    assert all(isinstance(n, int) and n >= 0
               for n in profiling.ONE_INPUT_OUTPUTS.values())


@pytest.mark.parametrize("how", ["stored", "zeroed"])
def test_the_output_counter_counts_one_launch_once(how):
    before = dict(profiling.ONE_INPUT_OUTPUTS)
    profiling.note_one_input_output(how)
    after = profiling.ONE_INPUT_OUTPUTS
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == how) for k in before}
    with pytest.raises(KeyError):
        profiling.note_one_input_output("filled")
    assert profiling.ONE_INPUT_OUTPUTS == after


@pytest.mark.parametrize("weights", [None, torch.float32, torch.int64], ids=str)
@pytest.mark.parametrize("reduce_all", [False, True], ids=["rows", "full"])
def test_a_cpu_call_notes_no_output(reduce_all, weights):
    """The CPU path launches nothing, so it counts no launch's output; its
    answer's trash slot is zero, as the kernel's is."""
    x = torch.from_numpy(_data(np.float32, (6, 40), seed=4))
    thr = torch.from_numpy(tbins.compare_form(_edges(50), np.float32).edges)
    w = None if weights is None else torch.arange(240).reshape(6, 40).to(weights)
    before = dict(profiling.ONE_INPUT_OUTPUTS), cuda_hist.ONE_INPUT_LAUNCHES
    out = cuda_hist.one_input(x, thr, 50, reduce_all, weights=w, finish=False)
    assert (profiling.ONE_INPUT_OUTPUTS, cuda_hist.ONE_INPUT_LAUNCHES) == before
    assert out.shape == (1 if reduce_all else 6, 51)
    assert (out[:, -1] == 0).all()


@pytest.mark.parametrize(
    "nb,m,c",
    [(50, 1, None), (64, 1, None), (50, 1000, 100000), (80, 64800, 365),
     (1024, 64, 100000), (1024, 1, None), (1025, 1, None)],
    ids=["config1", "1e9-row", "config2", "config4", "1024-kept", "1024-full",
         "1025-full"],
)
def test_plan_sends_the_slice_to_one_input(nb, m, c):
    kernel = cuda_hist.plan(1, (nb,), m, c)
    assert kernel == pallas_hist.plan(1, (nb,), m, c=c, weighted=False, uniform=None)
    assert (kernel == "one_input") == (nb <= 1024)


# The JAX package's kept-row cap: rows times its padded slot layout (1024
# slots up to 1023 bins, 2048 at 1024 bins) above 2^28 runs its scatter
# strategy. Its first row count past the cap, by bin count.
PAST_THE_JAX_CAP = {1: 262_145, 80: 262_145, 1023: 262_145, 1024: 131_073}


def test_plan_sends_the_per_cell_year_to_one_input():
    # a year of daily 0.25-degree fields per grid cell: 720 x 1440 kept rows
    # of 365 days in 80 bins, 1.06e9 padded slots
    assert cuda_hist.plan(1, (80,), 1_036_800, 365) == "one_input"
    assert pallas_hist.plan(1, (80,), 1_036_800, c=365, weighted=False,
                            uniform=None) is None


@pytest.mark.parametrize("nb", list(PAST_THE_JAX_CAP))
@pytest.mark.parametrize("c", [1, 2, 365, 100_000])
def test_plan_keeps_one_input_past_the_jax_cap(nb, c):
    """At the JAX package's kept-row cap: one row below it both plan()s
    name one_input; past it the JAX package runs scatter and the port
    still runs one_input, up to any row count."""
    edge = PAST_THE_JAX_CAP[nb]
    jax = lambda m: pallas_hist.plan(1, (nb,), m, c=c, weighted=False, uniform=None)  # noqa: E731
    assert jax(edge - 1) == cuda_hist.plan(1, (nb,), edge - 1, c) == "one_input"
    assert jax(edge) is None
    for m in (edge, 2 * edge, 1 << 40):
        assert cuda_hist.plan(1, (nb,), m, c) == "one_input"


@pytest.mark.parametrize("nbins,m,c", [
    ((1025,), 131_073, 365), ((1025,), 131_072, 365), ((1025,), 1_036_800, 365),
    ((40, 40), 131_072, 64), ((80, 80), 1_036_800, 365),
    ((40, 40), 131_073, 256), ((64, 128), 131_073, 64),
], ids=str)
def test_plan_past_the_jax_cap_elsewhere_is_the_jax_plan(nbins, m, c):
    """Past the cap, one input in more than 1024 bins, and kept rows outside
    the direct-row kernel's envelope (rows of 256 elements or more, over
    8192 slots), keep the JAX package's route (None: scatter)."""
    ours = cuda_hist.plan(len(nbins), nbins, m, c)
    assert ours == pallas_hist.plan(len(nbins), nbins, m, c=c, weighted=False,
                                    uniform=None)
    if m > 131_072:
        assert ours is None


@pytest.mark.parametrize("nbins,m,c", [
    ((40, 40), 131_073, 64),
    # the CESM2 Large Ensemble's joint SST-SSS of each cell and month over its
    # 100 members: six months of the 320 x 384 POP grid a call
    ((40, 40), 737_280, 100),
    ((40, 40), 1_474_560, 100), ((40, 40), 1 << 40, 255), ((40, 40), 3 << 41, 1),
    ((3, 4), 262_145, 5), ((90, 91), 1 << 20, 64), ((4, 8, 16, 15), 1 << 33, 200),
], ids=str)
def test_plan_sends_the_direct_band_past_the_jax_cap_to_direct(nbins, m, c):
    """Kept rows of fewer than 256 elements over at most 8192 slots, past
    the JAX package's cap (which runs scatter there), run direct at any row
    count: the direct-row kernel writes only its output, whose rows it
    indexes in 64 bits."""
    assert pallas_hist.plan(len(nbins), nbins, m, c=c, weighted=False, uniform=None) is None
    assert cuda_hist.plan(len(nbins), nbins, m, c) == "direct"


@pytest.mark.parametrize("axis", [(0,), (1,)], ids=["strided-rows", "rows"])
def test_kept_rows_past_the_jax_cap_equal_its_scatter_answer(monkeypatch, axis):
    """The first row count past the cap, 80 bins, NaN included: the port's
    one_input route (its plain version on the CPU) gives the JAX package's
    answer, which its scatter strategy gives there, and numpy's."""
    from xhistogram_torch import core

    m = PAST_THE_JAX_CAP[80]
    rng = np.random.default_rng(16)
    x = rng.normal(18.0, 9.0, (3, m) if axis == (0,) else (m, 3)).astype(np.float32)
    x[..., ::5] = np.nan
    edges = np.linspace(-2, 38, 81).astype(np.float32)
    ran = []

    def spy(*args, **kwargs):
        ran.append("one_input")
        return cuda_hist.one_input(*args, **kwargs)

    monkeypatch.setattr(core, "one_input", spy)
    expected = reference_numpy(x, edges, axis)
    jh, _ = xhistogram_tpu.histogram(x, bins=[edges], axis=axis)
    np.testing.assert_array_equal(np.asarray(jh), expected)
    for method in ("cuda", "auto"):  # the kernel's route, and scatter on the CPU
        h, _ = xhistogram_torch.histogram(torch.from_numpy(x), bins=[edges], axis=axis,
                                          method=method)
        assert h.shape == (m, 80) and h.dtype == torch.int64
        np.testing.assert_array_equal(h.numpy(), expected, err_msg=method)
    assert ran == ["one_input"]


def _load(path):
    import importlib.util
    import pathlib

    full = pathlib.Path(__file__).resolve().parent.parent / path
    spec = importlib.util.spec_from_file_location(full.stem, full)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_numpy_references_equal_the_repo_benches():
    """The port's own numpy references (tests/ts_cases.py, which
    chip_smoke.py uses) equal the JAX package's bench references."""
    from ts_cases import reference_numpy_ts, ts_data, T_EDGES, S_EDGES

    bench = _load("bench.py")
    baselines = _load("benchmarks/run_baselines.py")
    t, s = ts_data((64, 1024), seed=2)
    t.flat[::11] = np.nan
    np.testing.assert_array_equal(
        reference_numpy_ts(t, s, T_EDGES, S_EDGES),
        bench.reference_numpy_ts(t, s, T_EDGES, S_EDGES),
    )
    x = np.random.default_rng(3).normal(20.0, 5.0, (10, 6, 9)).astype(np.float32)
    edges = np.linspace(0, 40, 81)
    for axis in (None, (0,), (1, 2)):
        np.testing.assert_array_equal(
            reference_numpy(x, edges, axis),
            baselines.reference_numpy([x], [edges], axis=axis),
        )
