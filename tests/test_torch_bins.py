"""The port's host-side edge handling is identical to the JAX package's.

``compare_form`` is the state that crosses from one package to the other:
both must digitize against the same thresholds, dtype and ``n_hi_clip``
included.
"""

import numpy as np
import pytest
import torch

from xhistogram_tpu import bins as jbins
from xhistogram_torch import bins as tbins

I32 = np.iinfo(np.int32)
I64 = np.iinfo(np.int64)

# (edges, data dtype): the f32, f64, int, datetime and edge-exactness inputs
COMPARE_CASES = [
    (np.linspace(-2.0, 30.0, 281), np.float32),  # not f32-exact
    (np.linspace(-2.0, 30.0, 281).astype(np.float32), np.float32),
    (np.linspace(30.0, 40.0, 341), np.float32),
    (np.linspace(-2.0, 30.0, 281), np.float64),
    (np.array([0.0, 0.1, 0.30000000000000004]), np.float32),
    (np.sort(np.random.RandomState(1).uniform(-5, 5, 33)), np.float32),
    (np.array([0.0, 1.0, np.inf]), np.float32),  # n_hi_clip = 1
    (np.array([0.0, 1.0, np.inf]), np.float64),
    (np.array([-np.inf, 0.0, 1.0]), np.float32),
    (np.array([-1.0, -1e-39, 0.0, 1.0]), np.float32),  # subnormal threshold
    (np.array([0.0, 3.4e38, 3.4028234663852886e38]), np.float32),  # f32 max
    (np.array([0.0, 1e39]), np.float32),  # beyond the f32 range
    (np.array([0, 5, 10], dtype=np.int32), np.int32),
    (np.array([0, 5, 10], dtype=np.int64), np.float32),
    (np.array([-3.5, 0.5, 2.0, 7.25]), np.int32),
    (np.array([0.0, 2.0**31 - 1]), np.int32),
    (np.array([0, I32.max], dtype=np.int64), np.int32),  # n_hi_clip = 1
    (np.array([I32.min, 0, I32.max], dtype=np.int32), np.int32),
    (np.array([0, 2**53 + 1, 2**62], dtype=np.int64), np.int64),
    (np.array([0.0, 2.0**53 + 2, 2.0**62]), np.int64),  # lossy f64 cast
    (np.array([0, 2**63 + 5], dtype=np.uint64), np.int64),  # mixed sign: f64
    (np.array([I64.min, I64.max], dtype=np.int64), np.int64),
    (np.array(["2020-01-01", "2020-06-01", "2021-01-01"],
              dtype="datetime64[ns]").view("i8"), np.int64),
    (np.array([0, 0, 1, 1, 2]), np.float32),  # zero-width bins
]


@pytest.mark.parametrize("edges,dtype", COMPARE_CASES)
def test_compare_form_identical(edges, dtype):
    got = tbins.compare_form(edges, dtype)
    want = jbins.compare_form(edges, dtype)
    assert got.edges.dtype == want.edges.dtype
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.n_hi_clip == want.n_hi_clip
    assert type(got.n_hi_clip) is type(want.n_hi_clip)


@pytest.mark.parametrize("edges,dtype", COMPARE_CASES[:8])
def test_int_thresholds_identical(edges, dtype):
    for data_dtype in (np.int32, np.int64):
        assert tbins.int_thresholds(edges, data_dtype) == jbins.int_thresholds(
            edges, data_dtype
        )


@pytest.mark.parametrize("bins", [10, "auto", "fd", np.linspace(-3, 3, 11)])
@pytest.mark.parametrize("range_in", [None, (-2.0, 2.0)])
def test_resolve_bin_edges_identical(bins, range_in):
    rng = np.random.RandomState(0)
    data = [rng.randn(200), rng.randn(4, 200).astype(np.float32)]
    want = jbins.resolve_bin_edges(data, bins, range_in)
    for inputs in (data, [torch.from_numpy(d) for d in data]):
        got = tbins.resolve_bin_edges(inputs, bins, range_in)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_resolve_datetime_edges_identical():
    t = np.arange("2020-01-01", "2020-03-01", dtype="datetime64[D]")
    edges = np.array(["2020-01-01", "2020-02-01", "2020-03-01"],
                     dtype="datetime64[D]")
    for bins in (edges, 4):
        (got,) = tbins.resolve_bin_edges([t.view("i8")], bins)
        (want,) = jbins.resolve_bin_edges([t.view("i8")], bins)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_torch_edges_become_numpy():
    e = torch.linspace(0, 1, 5, dtype=torch.float64)
    (got,) = tbins.resolve_bin_edges([np.zeros(3)], [e])
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, e.numpy())


def _raised(fn):
    try:
        fn()
    except Exception as ex:  # noqa: BLE001 — the type and message are compared
        return type(ex), str(ex)
    return None


@pytest.mark.parametrize(
    "edges",
    [
        np.array([1.0]),
        np.array([2.0, 1.0]),
        np.array([0.0, np.nan, 2.0]),
        np.array([0j, 1j]),
        np.ones((2, 2)),
        np.array([0.0, 1.0, 0.5]),
    ],
    ids=["single", "descending", "nan", "complex", "2d", "unsorted"],
)
def test_validate_edges_errors_identical(edges):
    got = _raised(lambda: tbins.validate_edges(edges))
    want = _raised(lambda: jbins.validate_edges(edges))
    assert want is not None
    assert got == want


@pytest.mark.parametrize(
    "call",
    [
        lambda m: m.normalize_bins(None, 1),
        lambda m: m.normalize_bins([np.arange(3.0)], 2),
        lambda m: m.normalize_range([(0, 1)], 2),
        lambda m: m.normalize_range([(0, 1), (0,)], 2),
        lambda m: m.resolve_bin_edges([np.zeros(3)], [-3]),
        lambda m: m.resolve_bin_edges([np.zeros(3)], ["bogus"]),
    ],
    ids=["no_bins", "bins_len", "range_len", "range_pair", "neg_int", "estimator"],
)
def test_spec_errors_identical(call):
    got = _raised(lambda: call(tbins))
    want = _raised(lambda: call(jbins))
    assert want is not None
    assert got == want


def test_bin_geometry_identical():
    e1 = np.array([0.0, 1.0, 3.0])
    e2 = np.array([0.0, 2.0, 2.5, 4.0])
    np.testing.assert_array_equal(tbins.bin_centers(e1), jbins.bin_centers(e1))
    np.testing.assert_array_equal(tbins.bin_widths(e2), jbins.bin_widths(e2))
    np.testing.assert_array_equal(
        tbins.bin_areas([e1, e2]), jbins.bin_areas([e1, e2])
    )
