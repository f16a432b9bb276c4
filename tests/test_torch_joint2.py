"""joint2 — the main path's one kernel — against the JAX package.

On the CPU the wrapper runs ``joint2_reference``, the plain PyTorch version
the CUDA kernel is held to on the card (tests/test_torch_gpu.py,
chip_smoke.py). Here both it and the public ``histogram`` are held
bit-exact against the JAX package's ``_joint2_kernel`` under the Pallas
interpreter (``method="pallas"``), its scatter strategy and numpy.
"""

import numpy as np
import pytest
import torch

import xhistogram_tpu
from xhistogram_tpu.ops import pallas_hist
import xhistogram_torch
from xhistogram_torch import bins as tbins
from xhistogram_torch.ops import cuda_hist
from ts_cases import (
    EDGE_SETS, S_EDGES, T_EDGES, edge_case_data, numpy_hist2d, ts_data,
)


def _thresholds(edges):
    ce = tbins.compare_form(edges, np.float32)
    assert ce.n_hi_clip == 0
    return torch.from_numpy(ce.edges)


def _reference(t, s, te, se):
    nba, nbb = len(te) - 1, len(se) - 1
    out = cuda_hist.joint2_reference(
        torch.from_numpy(t), torch.from_numpy(s), _thresholds(te),
        _thresholds(se), nba, nbb,
    )
    assert out.shape == (1, nba * nbb + 1) and out.dtype == torch.int64
    assert int(out[0, -1]) == 0  # the trash slot stays empty, as in JAX
    return out[0, :-1].reshape(nba, nbb).numpy()


@pytest.mark.parametrize("shape", [(8, 512), (16, 4096)])
def test_main_path_bit_equal_to_jax_kernel(shape):
    t, s = ts_data(shape, seed=shape[1])
    bins = [T_EDGES, S_EDGES]
    jax_kernel = np.asarray(xhistogram_tpu.histogram(t, s, bins=bins, method="pallas")[0])
    jax_scatter = np.asarray(xhistogram_tpu.histogram(t, s, bins=bins, method="scatter")[0])
    expected = numpy_hist2d(t, s, T_EDGES, S_EDGES)
    np.testing.assert_array_equal(jax_kernel, expected)
    np.testing.assert_array_equal(jax_scatter, expected)

    np.testing.assert_array_equal(_reference(t, s, T_EDGES, S_EDGES), expected)
    for method in ("auto", "cuda", "pallas", "scatter"):
        h, edges = xhistogram_torch.histogram(
            torch.from_numpy(t), torch.from_numpy(s), bins=bins, method=method
        )
        assert h.dtype == torch.int64 and h.device.type == "cpu"
        np.testing.assert_array_equal(h.numpy(), expected, err_msg=method)
        for e, want in zip(edges, bins):
            np.testing.assert_array_equal(e, want)


@pytest.mark.parametrize("te,se", list(EDGE_SETS.values()), ids=list(EDGE_SETS))
def test_edge_cases_bit_equal(te, se):
    t, s = edge_case_data(te, se)
    expected = numpy_hist2d(t, s, te, se)
    np.testing.assert_array_equal(_reference(t, s, te, se), expected)
    jax_kernel = np.asarray(
        xhistogram_tpu.histogram(t, s, bins=[te, se], method="pallas")[0]
    )
    np.testing.assert_array_equal(jax_kernel, expected)


def test_negative_subnormal_is_below_a_zero_edge():
    te = np.array([0.0, 1.0])
    t = np.array([-1e-45, 1e-45, -0.0, 0.0], np.float32)
    s = np.full(4, 0.5, np.float32)
    h = _reference(t, s, te, te)
    assert h.tolist() == [[3]]  # -1e-45 lands below the range


@pytest.mark.parametrize("n", [0, 1, 7, 4097, (1 << 20) + 3])
def test_ragged_sizes(n):
    t, s = ts_data((n,), seed=n)
    expected = numpy_hist2d(t, s, T_EDGES, S_EDGES)
    np.testing.assert_array_equal(_reference(t, s, T_EDGES, S_EDGES), expected)
    for view in (lambda x: x, lambda x: x.reshape(1, n)):
        h, _ = xhistogram_torch.histogram(
            view(torch.from_numpy(t)), view(torch.from_numpy(s)),
            bins=[T_EDGES, S_EDGES], method="cuda",
        )
        np.testing.assert_array_equal(h.numpy(), expected)


def test_wrapper_contract_on_cpu():
    t, s = (torch.from_numpy(x) for x in ts_data((4, 64), seed=1))
    ta, tb = _thresholds(T_EDGES), _thresholds(S_EDGES)
    before = cuda_hist.JOINT2_LAUNCHES
    # a non-contiguous view gives the same counts as its copy
    got = cuda_hist.joint2(t.t(), s.t(), ta, tb, 280, 340)
    want = cuda_hist.joint2(t.t().contiguous(), s.t().contiguous(), ta, tb, 280, 340)
    assert torch.equal(got, want)
    assert cuda_hist.JOINT2_LAUNCHES == before  # the CPU path launches nothing
    with pytest.raises(TypeError, match="thresholds must be in the data's dtype"):
        cuda_hist.joint2(t.double(), s.double(), ta, tb, 280, 340)
    with pytest.raises(TypeError, match="data, got torch.bfloat16"):
        cuda_hist.joint2(t.bfloat16(), s, ta.bfloat16(), tb, 280, 340)
    with pytest.raises(ValueError, match="equally many"):
        cuda_hist.joint2(t, s[:2], ta, tb, 280, 340)
    with pytest.raises(ValueError, match="thresholds"):
        cuda_hist.joint2(t, s, ta, tb, 280, 339)


NBINS_GRID = [
    (1,), (64,), (1024,), (1025,), (20000,),
    (280, 340), (764, 764), (760, 777), (1000, 1000), (1529, 7),
    (50, 60), (2000, 2000), (16000, 16000),
    (10, 10, 10), (150, 90, 3), (128, 128, 128),
]


# weighted plan() inputs: (torch dtype, JAX dtype, modes); integer weights
# ride the JAX package's "intN" digit modes
WEIGHT_KINDS = [
    (torch.float32, "float32", [None, "split", "highest", "i8", "i8x3"]),
    (torch.int32, "int32", [None, "int1", "int2", "int3", "int4"]),
]


@pytest.mark.parametrize("nbins", NBINS_GRID, ids=str)
def test_plan_matches_jax(nbins):
    import jax.numpy as jnp

    for m, c in [(1, None), (2, 64), (7, 1000), (8, 256), (1000, 100000),
                 (16384, 64), (3, 255), (0, 10), (5, 0), (64800, 64),
                 (50, 73 * 64800)]:
        assert cuda_hist.plan(len(nbins), nbins, m, c) == pallas_hist.plan(
            len(nbins), nbins, m, c=c, weighted=False, uniform=None
        ), (m, c)
        # weighted, by weight dtype and mode: the 2^18-2^20 full caps, the
        # per-slot outputs of the kept-row gate, the 2^24 kept cap
        for dtype, jdtype, modes in WEIGHT_KINDS:
            for mode in modes:
                assert cuda_hist.plan(
                    len(nbins), nbins, m, c, weights_dtype=dtype, wmode=mode
                ) == pallas_hist.planned_kernel(
                    len(nbins), nbins, m, c, weighted=True,
                    weights_dtype=getattr(jnp, jdtype), wmode=mode,
                ), (m, c, jdtype, mode)


def _dtype_case(dtype, seed):
    """T–S-like data and edges in ``dtype``; integer edges fall between
    integers and, for int64, beyond float64's exact integers."""
    t, s = ts_data((8, 512), seed=seed)
    if dtype == "int64":
        scale = 2**40
        return ((t * 64).astype(np.int64) * scale + 3, (s * 64).astype(np.int64) * scale,
                T_EDGES.astype(np.float64) * 64 * scale + 0.5,
                S_EDGES.astype(np.float64) * 64 * scale)
    if dtype == "int32":
        return ((t * 64).astype(np.int32), (s * 64).astype(np.int32),
                T_EDGES * 64 + 0.5, S_EDGES * 64)
    return t.astype(dtype), s.astype(dtype), T_EDGES, S_EDGES


@pytest.mark.parametrize("dtype", ["float64", "int32", "int64", "float16"])
def test_other_dtypes_bit_equal_to_jax_kernel(dtype):
    t, s, te, se = _dtype_case(dtype, seed=len(dtype))
    jax_kernel = np.asarray(xhistogram_tpu.histogram(t, s, bins=[te, se], method="pallas")[0])
    if dtype != "int64":  # numpy's histogram2d compares int64 data in float64
        np.testing.assert_array_equal(jax_kernel, numpy_hist2d(t, s, te, se))
    for method in ("auto", "cuda"):
        h, _ = xhistogram_torch.histogram(
            torch.from_numpy(t), torch.from_numpy(s), bins=[te, se], method=method
        )
        np.testing.assert_array_equal(h.numpy(), jax_kernel, err_msg=method)


def test_mixed_dtypes_bit_equal_to_jax_kernel():
    t, s = ts_data((8, 512), seed=9)
    s = s.astype(np.float64) + 1e-9  # not a float32 value
    jax_kernel = np.asarray(
        xhistogram_tpu.histogram(t, s, bins=[T_EDGES, S_EDGES], method="pallas")[0]
    )
    np.testing.assert_array_equal(jax_kernel, numpy_hist2d(t, s, T_EDGES, S_EDGES))
    h, _ = xhistogram_torch.histogram(
        torch.from_numpy(t), torch.from_numpy(s), bins=[T_EDGES, S_EDGES], method="cuda"
    )
    np.testing.assert_array_equal(h.numpy(), jax_kernel)


@pytest.mark.parametrize(
    "dtypes,want",
    [
        ((torch.float16, torch.float16), torch.float32),
        ((torch.float32, torch.float32), torch.float32),
        ((torch.float32, torch.float64), torch.float64),
        ((torch.int32, torch.float32), torch.float64),
        ((torch.int32, torch.int64), torch.int64),
        ((torch.int64, torch.int64), torch.int64),
        ((torch.int64, torch.float64), None),
        ((torch.int64, torch.float32), None),
    ],
    ids=str,
)
def test_compare_dtype_widens_exactly(dtypes, want):
    # the card's joint2 compares both inputs in this one type
    assert cuda_hist._compare_dtype(dtypes) == want
