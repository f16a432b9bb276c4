"""The port's numpy-signature wrappers against numpy and the JAX package.

The cases of tests/test_compat.py, run on the CPU (``device="cpu"``): the
results are numpy arrays in numpy's own dtypes, counts bit-equal to numpy
and to the JAX package, weighted sums and densities within the tolerance
that file states, and the same errors.
"""

import functools

import numpy as np
import pytest
import torch

from xhistogram_tpu import compat as jcompat
from xhistogram_torch import compat as tcompat

histogram = functools.partial(tcompat.histogram, device="cpu")
histogram2d = functools.partial(tcompat.histogram2d, device="cpu")
histogramdd = functools.partial(tcompat.histogramdd, device="cpu")


def _numpy_kwargs(kw):
    return {k: (v.astype("f8") if hasattr(v, "dtype") else v) for k, v in kw.items()}


HIST_CASES = {
    "bins=10": dict(bins=10),
    "range": dict(bins=10, range=(-2, 2)),
    "edges": dict(bins=np.linspace(-3, 3, 8)),
    "weights": dict(bins=12, weights="f4"),
    "density": dict(bins=10, density=True),
    "f64-weights": dict(bins=12, weights="f8"),
    "i4-weights": dict(bins=12, weights="i4"),
}


@pytest.mark.parametrize("case", list(HIST_CASES))
def test_histogram_compat(case):
    rng = np.random.RandomState(0)
    a = rng.randn(1000).astype("f4")
    kw = dict(HIST_CASES[case])
    if "weights" in kw:
        kw["weights"] = (rng.rand(1000) * 100).astype(kw["weights"])
    h, e = histogram(a, **kw)
    he, ee = np.histogram(a.astype("f8"), **_numpy_kwargs(kw))
    jh, je = jcompat.histogram(a, **kw)
    assert isinstance(h, np.ndarray) and h.dtype == np.histogram(a, **kw)[0].dtype
    np.testing.assert_allclose(e, ee, rtol=1e-5)
    np.testing.assert_array_equal(e, je)
    if "weights" in kw and kw["weights"].dtype.kind == "f" or kw.get("density"):
        np.testing.assert_allclose(h, he, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(h, jh, rtol=3e-7, atol=1e-6)
    else:
        np.testing.assert_array_equal(h, he)
        np.testing.assert_array_equal(h, jh)


@pytest.mark.parametrize("bins", [7, [5, 9], "edges", "flat-list", "shared",
                                  "ndarray-pair"])
def test_histogram2d_compat(bins):
    rng = np.random.RandomState(1)
    x = rng.randn(2000).astype("f4")
    y = rng.randn(2000).astype("f4")
    named = {"edges": [np.linspace(-3, 3, 6), np.linspace(-3, 3, 11)],
             "flat-list": [-1.0, 0.0, 1.0],  # numpy: a shared edge array
             "shared": np.linspace(-3, 3, 7),
             "ndarray-pair": np.array([5, 9])}
    if isinstance(bins, str):
        bins = named[bins]
    h, ex, ey = histogram2d(x, y, bins=bins)
    he, exe, eye = np.histogram2d(x.astype("f8"), y.astype("f8"), bins=bins)
    jh, _, _ = jcompat.histogram2d(x, y, bins=bins)
    assert isinstance(h, np.ndarray) and h.dtype == he.dtype == np.float64
    np.testing.assert_allclose(ex, exe, rtol=1e-5)
    np.testing.assert_allclose(ey, eye, rtol=1e-5)
    np.testing.assert_array_equal(h, he)
    np.testing.assert_array_equal(h, jh)


def test_histogram2d_bad_bins_raise_as_jax():
    x = np.zeros(4, "f4")
    with pytest.raises(ValueError) as ours:
        histogram2d(x, x, bins=np.zeros((3, 3)))
    with pytest.raises(ValueError) as theirs:
        jcompat.histogram2d(x, x, bins=np.zeros((3, 3)))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("bins", [4, [3, 4, 5], "ndarray"])
def test_histogramdd_compat(bins):
    rng = np.random.RandomState(2)
    sample = rng.randn(1500, 3).astype("f4")
    bins = np.array([3, 4, 5]) if bins == "ndarray" else bins
    h, edges = histogramdd(sample, bins=bins)
    he, ee = np.histogramdd(sample.astype("f8"), bins=bins)
    jh, _ = jcompat.histogramdd(sample, bins=bins)
    for e1, e2 in zip(edges, ee):
        np.testing.assert_allclose(e1, e2, rtol=1e-5)
    assert h.dtype == he.dtype == np.float64
    np.testing.assert_array_equal(h, he)
    np.testing.assert_array_equal(h, jh)


def test_histogramdd_forms_and_errors():
    rng = np.random.RandomState(2)
    sample = rng.randn(1500, 3).astype("f4")
    cols = [sample[:, d] for d in range(3)]  # sequence-of-arrays form
    h, _ = histogramdd(cols, bins=3)
    he, _ = np.histogramdd(sample.astype("f8"), bins=3)
    np.testing.assert_array_equal(h, he)
    for bad in ([3, 4], None):
        fn = (lambda m: m(sample, bins=[3, 4])) if bad else (
            lambda m: m(np.zeros((2, 2, 2)), bins=3))
        with pytest.raises(ValueError) as ours:
            fn(histogramdd)
        with pytest.raises(ValueError) as theirs:
            fn(jcompat.histogramdd)
        assert str(ours.value) == str(theirs.value)
    w = rng.rand(1500).astype("f4")  # weighted + density
    h, _ = histogramdd(sample, bins=4, weights=w, density=True)
    he, _ = np.histogramdd(sample.astype("f8"), bins=4, weights=w.astype("f8"),
                           density=True)
    np.testing.assert_allclose(h, he, rtol=1e-4, atol=1e-7)


def test_histogramdd_1d_sample():
    flat = np.random.RandomState(4).randn(600).astype("f4")  # numpy: (N, 1)
    h, edges = histogramdd(flat, bins=5)
    he, ee = np.histogramdd(flat.astype("f8"), bins=5)
    np.testing.assert_array_equal(h, he)
    np.testing.assert_allclose(edges[0], ee[0], rtol=1e-5)


def test_histogram_flat_list_edges():
    a = np.array([0.1, 0.6, 0.7], "f4")
    h, e = histogram(a, bins=[0.0, 0.5, 1.0])
    np.testing.assert_array_equal(h, [1, 2])
    assert h.dtype == np.intp
    np.testing.assert_allclose(e, [0.0, 0.5, 1.0])


def test_tensor_inputs_and_weights():
    """A CPU tensor runs where it lies; the weights' dtype is numpy's."""
    rng = np.random.RandomState(5)
    a = rng.randn(300).astype("f4")
    w = rng.rand(300).astype("f4")
    h, _ = tcompat.histogram(torch.from_numpy(a), bins=8, weights=torch.from_numpy(w))
    he, _ = np.histogram(a, bins=8, weights=w)
    assert h.dtype == he.dtype == np.float32
    np.testing.assert_allclose(h, he, rtol=1e-6)


def test_numpy_inputs_need_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tcompat.histogram2d(np.zeros(3), np.zeros(3), bins=4)
