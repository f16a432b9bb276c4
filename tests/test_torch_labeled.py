"""The port's labeled API against the JAX package's, on the CPU.

The cases of tests/test_labeled.py, tests/test_labeled_cache.py (held
against the port's device cache of resolved thresholds, which takes the
place of the JAX package's compiled-pipeline cache) and
tests/test_xarray_compat.py (the independent DataArray double of
tests/xarray_double.py, and xarray when installed). Each call runs the same
numpy inputs through both packages: counts bit-equal, the same dims,
coordinates, names and attrs; weighted sums within the JAX package's
'highest' bound; errors of the same type.
"""

import functools
from itertools import combinations

import numpy as np
import pytest
import torch

import xhistogram_tpu.labeled as jlab
import xhistogram_torch.labeled as tlab
from xhistogram_torch import core
from xhistogram_torch.labeled import NamedArray
from xhistogram_torch.labeled.array import full_like

from xarray_double import DuckDataArray

histogram = functools.partial(tlab.histogram, device="cpu")

DIMS = {"time": 5, "depth": 10, "lat": 45, "lon": 90}
COORDS = {
    "time": np.arange(DIMS["time"]) * 86400.0,
    "depth": np.arange(DIMS["depth"]) * 100.0 + 50,
    "lat": np.arange(DIMS["lat"]) * 180 / DIMS["lat"] - 90 + 90 / DIMS["lat"],
    "lon": np.arange(DIMS["lon"]) * 360 / DIMS["lon"] + 180 / DIMS["lon"],
}
RTOL, ATOL = 3e-7, 1e-6


def _to_jax(a):
    """The JAX package's NamedArray with the same data, dims, coords, name
    and attrs as a port NamedArray (or a duck array)."""
    if a is None or not isinstance(a, NamedArray):
        return a
    coords = {k: (c.dims, c.values, dict(c.attrs)) for k, c in a.coords.items()}
    return jlab.NamedArray(a.values, a.dims, coords=coords, name=a.name,
                           attrs=a.attrs)


def _assert_labeled_equal(out, jout, exact=True):
    assert out.dims == tuple(jout.dims)
    assert out.name == jout.name
    assert out.attrs == dict(jout.attrs)
    assert isinstance(out.data, torch.Tensor)
    if exact:
        np.testing.assert_array_equal(out.values, np.asarray(jout.values))
    else:
        np.testing.assert_allclose(out.values, np.asarray(jout.values), rtol=RTOL,
                                   atol=ATOL)
    assert set(out.coords) == set(jout.coords)
    for k, c in out.coords.items():
        jc = jout.coords[k]
        assert c.dims == tuple(jc.dims), k
        assert c.attrs == dict(jc.attrs), k
        assert isinstance(c.data, np.ndarray), k  # labels stay numpy
        np.testing.assert_array_equal(c.values, np.asarray(jc.values), err_msg=k)


def _both(*args, exact=True, **kwargs):
    """The port's labeled histogram on the CPU, held against the JAX
    package's on the same inputs."""
    out = histogram(*args, **kwargs)
    jkw = dict(kwargs)
    if "weights" in jkw:
        jkw["weights"] = _to_jax(jkw["weights"])
    jout = jlab.histogram(*(_to_jax(a) for a in args), **jkw)
    _assert_labeled_equal(out, jout, exact)
    return out


def _raised(fn):
    try:
        fn()
    except Exception as ex:  # noqa: BLE001 — the type is compared
        return type(ex)
    return None


DIM_SETS = [("lon",), ("lat", "lon"), ("depth", "lat", "lon"),
            ("time", "depth", "lat", "lon")]


def _ones(dims):
    shape = [DIMS[d] for d in dims]
    coords = {k: v for k, v in COORDS.items() if k in dims}
    return NamedArray(np.ones(shape, dtype="f4"), dims, coords=coords, name="ones")


def _cases(max_ndims):
    """(dims, ndims) for every dim set and reduction rank it allows."""
    return [pytest.param(dims, n, id=f"{len(dims)}D-{n}") for dims in DIM_SETS
            for n in range(1, min(len(dims), max_ndims) + 1)]


@pytest.mark.parametrize("dims,ndims", _cases(4))
def test_histogram_ones(dims, ndims):
    ones = _ones(dims)
    bins = np.array([0, 0.9, 1.1, 2])
    bins_c = 0.5 * (bins[1:] + bins[:-1])
    for d in combinations(dims, ndims):
        h = _both(ones, bins=[bins], dim=d)
        other_dims = [dim for dim in ones.dims if dim not in d]
        if other_dims:
            assert set(other_dims) <= set(h.dims)
        h_sum = h.sum(other_dims)
        assert h_sum.dims == ("ones_bin",)
        np.testing.assert_array_equal(h_sum.values, [0, ones.size, 0])
        np.testing.assert_allclose(h_sum.coords["ones_bin"].values, bins_c)
        assert h.name == "histogram_ones"


@pytest.mark.parametrize("dims,ndims", _cases(4))
def test_histogram_ones_density(dims, ndims):
    ones = _ones(dims)
    bins = np.array([0, 0.9, 1.1, 2])
    for d in combinations(dims, ndims):
        h_density = _both(ones, bins=[bins], dim=d, density=True, exact=False)
        integrals = (h_density.values * 0.2).sum(axis=h_density.dims.index("ones_bin"))
        np.testing.assert_allclose(integrals, 1.0, rtol=1e-6)


@pytest.mark.parametrize("dims,ndims", _cases(2))
def test_weights(dims, ndims):
    """Weights over every dim-subset broadcast (reference
    test_xarray.py:100-135), against the exact totals."""
    ones = _ones(dims)
    bins = np.array([0, 0.9, 1.1, 2])
    weight_value = 0.5
    for n_comb in range(ones.ndim):
        for weight_dims in combinations(dims, n_comb):
            weights = full_like(ones.isel(**{dim: 0 for dim in weight_dims}),
                                weight_value)
            for nc in range(ndims):
                for d in combinations(dims, nc + 1):
                    h = histogram(ones, weights=weights, bins=[bins], dim=d)
                    h_sum = h.sum([dim for dim in ones.dims if dim not in d])
                    np.testing.assert_allclose(
                        h_sum.values, [0, weight_value * ones.size, 0], rtol=1e-6
                    )


def test_weights_against_jax():
    rng = np.random.RandomState(5)
    da = NamedArray(rng.randn(5, 10, 45).astype("f4"), ("time", "depth", "lat"),
                    coords={"depth": COORDS["depth"]}, name="T")
    w = NamedArray(rng.rand(10, 45).astype("f4"), ("depth", "lat"))
    _both(da, weights=w, bins=[np.linspace(-3, 3, 13)], dim=("time", "lat"),
          exact=False)
    wi = NamedArray(rng.randint(-1000, 1000, (45,)).astype("i4"), ("lat",))
    _both(da, weights=wi, bins=[np.linspace(-3, 3, 13)], dim=("lat",))


def test_dims_and_coords():
    """Output dim order and coordinate identity (reference
    test_xarray.py:139-173, issue #5)."""
    shape = (4, 10, 30, 30)
    dims = ["time", "depth", "X", "Y"]
    coords = {"time": np.arange(4), "depth": np.arange(10), "X": np.arange(30),
              "Y": np.arange(30)}
    rng = np.random.RandomState(0)
    array1 = NamedArray(rng.randint(0, 100, shape).astype("f4"), dims, coords=coords,
                        name="one")
    array2 = NamedArray(rng.randint(0, 50, shape).astype("f4"), dims, coords=coords,
                        name="two")
    bins1 = np.linspace(0, 100, 50)
    bins2 = np.linspace(0, 50, 25)
    result = _both(array1, array2, dim=["X", "Y"], bins=[bins1, bins2])
    assert result.dims == ("time", "depth", "one_bin", "two_bin")
    np.testing.assert_array_equal(result.coords["time"].values, coords["time"])
    np.testing.assert_array_equal(result.coords["depth"].values, coords["depth"])
    expected = np.stack([
        np.stack([
            np.histogram2d(array1.values[t, d].ravel(), array2.values[t, d].ravel(),
                           bins=[bins1, bins2])[0]
            for d in range(10)
        ])
        for t in range(4)
    ])
    np.testing.assert_array_equal(result.values, expected)


@pytest.mark.parametrize("number_of_inputs", [1, 2])
@pytest.mark.parametrize("keep_coords", [True, False])
@pytest.mark.parametrize("include_weights", [True, False])
def test_carry_coords(keep_coords, number_of_inputs, include_weights):
    """Non-dim coords carried iff keep_coords (reference
    test_xarray.py:176-211)."""
    shape = (40, 10, 10)
    dims = ["time", "X", "Y"]
    coords = {d: np.arange(s) for d, s in zip(dims, shape)}
    rng = np.random.RandomState(1)
    da = NamedArray(rng.randint(0, 100, shape).astype("f4"), dims, coords=coords,
                    name="one")
    lon = np.add.outer(coords["X"] ** 2, coords["Y"] ** 2).astype("f8")
    da.coords["lon"] = NamedArray(lon, ("X", "Y"), name="lon")
    weights = full_like(da, 0.5) if include_weights else None
    bins = np.linspace(0, 100, 10)
    result = _both(*[da] * number_of_inputs, bins=[bins] * number_of_inputs,
                   dim=["time"], weights=weights, keep_coords=keep_coords)
    if keep_coords:
        assert "lon" in result.coords
        np.testing.assert_array_equal(result.coords["lon"].values, lon)
    else:
        assert "lon" not in result.coords


def test_bin_attrs_and_suffix():
    da = NamedArray(np.linspace(0, 1, 16).reshape(4, 4), ("x", "y"), name="T",
                    attrs={"units": "degC"})
    h = _both(da, bins=[np.linspace(0, 1, 5)], bin_dim_suffix="_edges")
    assert h.dims == ("T_edges",)
    assert h.coords["T_edges"].attrs == {"units": "degC"}


@pytest.mark.parametrize("case", ["not-labeled", "unnamed", "align"])
def test_errors_match_jax(case):
    def run(hist, cls):
        if case == "not-labeled":
            hist(np.arange(100), bins=10)
        elif case == "unnamed":
            hist(cls(np.arange(4.0), ("x",)), bins=np.linspace(0, 4, 3))
        else:
            a = cls(np.ones((3, 4)), ("x", "y"), name="a")
            b = cls(np.ones((5, 4)), ("x", "y"), name="b")
            hist(a, b, bins=[np.linspace(0, 2, 3)] * 2)

    got = _raised(lambda: run(histogram, NamedArray))
    want = _raised(lambda: run(jlab.histogram, jlab.NamedArray))
    assert got is want is {"not-labeled": TypeError, "unnamed": ValueError,
                           "align": ValueError}[case]


def test_align_exact_message():
    a = NamedArray(np.ones((3, 4)), ("x", "y"), name="a")
    b = NamedArray(np.ones((5, 4)), ("x", "y"), name="b")
    with pytest.raises(ValueError, match="align"):
        histogram(a, b, bins=[np.linspace(0, 2, 3)] * 2)


def test_labeled_above_cap_scatter_route():
    rng = np.random.RandomState(50)
    a = NamedArray(rng.randn(6, 500).astype("f4"), ("t", "x"), name="a")
    b = NamedArray(rng.randn(6, 500).astype("f4"), ("t", "x"), name="b")
    ea = np.linspace(-4, 4, 1025)
    eb = np.linspace(-4, 4, 521)
    w = NamedArray(rng.rand(6, 500).astype("f4"), ("t", "x"))
    h = _both(a, b, bins=[ea, eb], weights=w, exact=False)
    exp = np.histogram2d(a.values.ravel().astype("f8"), b.values.ravel().astype("f8"),
                         bins=[ea, eb], weights=w.values.ravel().astype("f8"))[0]
    np.testing.assert_allclose(h.values, exp, rtol=1e-4)
    assert h.dims == ("a_bin", "b_bin")


def test_named_array_surface():
    rng = np.random.RandomState(6)
    x = rng.randn(3, 4).astype("f4")
    a = NamedArray(x, ("t", "x"), coords={"x": np.arange(4.0)}, name="v",
                   attrs={"units": "m"})
    ja = _to_jax(a)
    assert isinstance(a.data, torch.Tensor) and isinstance(a.coords["x"].data, np.ndarray)
    assert a.shape == (3, 4) and a.sizes == {"t": 3, "x": 4} and a.size == 12
    assert a.get_axis_num("x") == 1 and a["x"].dims == ("x",)
    for ours, theirs in (
        (a.expand_dims({"e": 1}), ja.expand_dims({"e": 1})),
        (a.transpose("x", "t"), ja.transpose("x", "t")),
        (a.isel(t=1), ja.isel(t=1)),
        (a.isel(x=slice(1, 3)), ja.isel(x=slice(1, 3))),
        (a.sum("t"), ja.sum("t")),
        (full_like(a, 2.5), jlab.array.full_like(ja, 2.5)),
    ):
        assert ours.dims == tuple(theirs.dims)
        np.testing.assert_allclose(ours.values, np.asarray(theirs.values), rtol=1e-6)
        assert set(ours.coords) == set(theirs.coords)
        assert ours.equals(ours) and ours.identical(ours.rename(ours.name))
    wide = a.expand_dims({"e": 2})  # a view: the data broadcast along e
    assert wide.dims == ("e", "t", "x") and wide.data.stride()[0] == 0
    np.testing.assert_array_equal(wide.values, np.broadcast_to(x, (2, 3, 4)))
    assert not a.identical(a.rename("w"))
    assert a.equals(a.rename("w"))
    with pytest.raises(ValueError):
        a.transpose("t")
    with pytest.raises(ValueError):
        NamedArray(x, ("t",))


# --- the device cache of resolved thresholds ---------------------------------


def _mk(seed=0, shape=(4, 32)):
    rng = np.random.RandomState(seed)
    return NamedArray(rng.randn(*shape).astype("f4"), ("time", "x"), name="T",
                      attrs={"units": "degC"})


def test_cache_hit_same_config():
    core._THRESHOLD_CACHE.clear()
    a = _mk()
    edges = np.linspace(-3, 3, 9)
    h1 = histogram(a, bins=edges, dim=["x"])
    n_entries = len(core._THRESHOLD_CACHE)
    assert n_entries == 1
    h2 = histogram(a, bins=edges.copy(), dim=["x"])  # same content, new array
    assert len(core._THRESHOLD_CACHE) == n_entries  # content-keyed: reused
    np.testing.assert_array_equal(h1.values, h2.values)
    expected = np.stack([np.histogram(r, bins=edges)[0] for r in a.values.astype("f8")])
    np.testing.assert_array_equal(h2.values, expected)


def test_cache_miss_on_bin_value_change():
    core._THRESHOLD_CACHE.clear()
    a = _mk(1)
    e1 = np.linspace(-3, 3, 9)
    e2 = np.linspace(-2, 2, 9)  # same shape/dtype, different values
    h1 = histogram(a, bins=e1, dim=["x"])
    h2 = histogram(a, bins=e2, dim=["x"])
    assert len(core._THRESHOLD_CACHE) == 2
    for h, e in ((h1, e1), (h2, e2)):
        expected = np.stack([np.histogram(r, bins=e)[0] for r in a.values.astype("f8")])
        np.testing.assert_array_equal(h.values, expected)
        np.testing.assert_allclose(h.coords["T_bin"].values, 0.5 * (e[:-1] + e[1:]))
    edited = e1.copy()
    histogram(a, bins=edited, dim=["x"])
    edited[3] += 0.1  # an edited edge array misses, never reads stale thresholds
    h3 = histogram(a, bins=edited, dim=["x"])
    expected = np.stack([np.histogram(r, bins=edited)[0] for r in a.values.astype("f8")])
    np.testing.assert_array_equal(h3.values, expected)


def test_uncacheable_specs_still_work():
    core._THRESHOLD_CACHE.clear()
    a = _mk(2)
    h = _both(a, bins=5)  # int spec: data-dependent, uncached
    assert len(core._THRESHOLD_CACHE) == 0
    np.testing.assert_array_equal(h.values, np.histogram(a.values.astype("f8"), bins=5)[0])
    h = _both(a, bins=5, range=(-2, 2))
    assert len(core._THRESHOLD_CACHE) == 0
    np.testing.assert_array_equal(
        h.values, np.histogram(a.values.astype("f8"), bins=5, range=(-2, 2))[0])


def test_wide_integer_data_exact():
    """int64 data past 2**53 is compared exactly (the JAX package remaps
    it on the host and skips its cache; the port compares int64 natively
    and caches its thresholds like any others)."""
    core._THRESHOLD_CACHE.clear()
    vals = np.array([0, 1, 2, 2**40], dtype=np.int64)
    a = NamedArray(vals, ("x",), name="n")
    edges = np.array([0.5, 1.5, 2.5, 2.0**41])
    h = _both(a, bins=edges)
    np.testing.assert_array_equal(h.values, np.histogram(vals, bins=edges)[0])


def test_cache_eviction_cap(monkeypatch):
    core._THRESHOLD_CACHE.clear()
    monkeypatch.setattr(core, "_THRESHOLD_CACHE_CAP", 3)
    rng = np.random.RandomState(3)
    a = NamedArray(rng.randn(8).astype("f4"), ("x",), name="T")
    first = np.linspace(-3, 3, 4)
    for k in range(5):
        histogram(a, bins=np.linspace(-3, 3, 4 + k))
        assert len(core._THRESHOLD_CACHE) <= 3
    keys = [k[0] for k in core._THRESHOLD_CACHE]
    assert first.tobytes() not in keys  # the oldest went first
    h = histogram(a, bins=first)  # evicted configs still recompute correctly
    np.testing.assert_array_equal(h.values, np.histogram(a.values.astype("f8"),
                                                          bins=first)[0])


def test_subnormal_edges():
    """Edges with subnormal thresholds: the JAX package's cache had to skip
    them (FTZ); the port's kernels and plain path keep subnormals, so the
    cached thresholds give numpy's answer."""
    core._THRESHOLD_CACHE.clear()
    data = np.array([-0.5, 0.0, -0.0, 0.5], dtype=np.float32)
    edges = np.array([-1.0, 1e-42, 1.0])
    a = NamedArray(data, ("x",), name="v")
    for _ in range(2):
        h = _both(a, bins=edges)
        np.testing.assert_array_equal(h.values, np.histogram(data, bins=edges)[0])
    assert len(core._THRESHOLD_CACHE) == 1


def test_cache_float64_preserved():
    core._THRESHOLD_CACHE.clear()
    rng = np.random.RandomState(5)
    vals = rng.randn(4, 32)  # float64 that does NOT round-trip float32
    w = rng.rand(4, 32) + 1e-9
    edges = np.linspace(-3, 3, 9)
    a = NamedArray(vals, ("time", "x"), name="T")
    wa = NamedArray(w, ("time", "x"))
    h = histogram(a, bins=edges, dim=["x"], weights=wa)
    assert len(core._THRESHOLD_CACHE) == 1
    assert h.data.dtype == torch.float64
    expected = np.stack([np.histogram(r, bins=edges, weights=ww)[0]
                         for r, ww in zip(vals, w)])
    np.testing.assert_allclose(h.values, expected, rtol=1e-12)


def test_precision_does_not_fork_the_cache():
    """The thresholds do not depend on precision=: every mode reads the
    same entry, and each mode's sums meet the 'highest' bound."""
    core._THRESHOLD_CACHE.clear()
    edges = np.linspace(-4, 4, 1025)
    centers = (0.5 * (edges[:-1] + edges[1:])).astype("f4")
    w = np.random.RandomState(3).uniform(0.5, 2.0, size=centers.shape).astype("f4")
    a = NamedArray(centers, ("x",), name="T")
    wa = NamedArray(w, ("x",))
    for precision in ("highest", "split", "f64"):
        h = histogram(a, bins=edges, weights=wa, method="cuda", precision=precision)
        np.testing.assert_array_equal(h.values, w.astype(h.values.dtype))
    assert len(core._THRESHOLD_CACHE) == 1


def test_cache_int_weights():
    core._THRESHOLD_CACHE.clear()
    a = _mk(3)
    rng = np.random.RandomState(4)
    w = NamedArray(rng.randint(-1000, 1000, (4, 32)).astype(np.int32), ("time", "x"))
    edges = np.linspace(-3, 3, 9)
    h1 = _both(a, bins=edges, dim=["x"], weights=w)
    n_entries = len(core._THRESHOLD_CACHE)
    h2 = histogram(a, bins=edges.copy(), dim=["x"], weights=w)
    assert len(core._THRESHOLD_CACHE) == n_entries
    expected = np.stack([np.histogram(r, bins=edges, weights=ww)[0]
                         for r, ww in zip(a.values.astype("f8"), w.values)])
    assert h1.data.dtype == torch.int32
    np.testing.assert_array_equal(h1.values, expected)
    np.testing.assert_array_equal(h2.values, expected)


def test_cache_keyed_by_device_and_compare_dtype():
    core._THRESHOLD_CACHE.clear()
    edges = np.linspace(-3, 3, 9)
    for x in (np.zeros(3, "f4"), np.zeros(3, "f8"), np.zeros(3, "i4")):
        core.histogram(x, bins=edges, device="cpu")
    assert len(core._THRESHOLD_CACHE) == 3
    assert {k[3] for k in core._THRESHOLD_CACHE} == {np.dtype(d).str for d in
                                                      ("f4", "f8", "i4")}
    assert {k[4] for k in core._THRESHOLD_CACHE} == {torch.device("cpu")}


# --- the duck surface: the DataArray double (and xarray when installed) ------

_IMPLS = [("double", DuckDataArray)]
try:
    import xarray as xr

    _IMPLS.append(("xarray", xr.DataArray))
except ImportError:
    pass


@pytest.fixture(params=_IMPLS, ids=[n for n, _ in _IMPLS])
def DataArray(request):
    return request.param[1]


def _duck_both(*args, **kwargs):
    out = histogram(*args, **kwargs)
    jout = jlab.histogram(*args, **kwargs)
    _assert_labeled_equal(out, jout, exact="weights" not in kwargs)
    return out


def test_duck_basic_parity_and_labels(DataArray):
    da = DataArray(np.random.RandomState(0).randn(4, 6).astype("f4"), dims=("time", "x"),
                   coords={"x": np.arange(6.0)}, name="v", attrs={"units": "m"})
    bins = np.linspace(-4, 4, 9)
    h = _duck_both(da, bins=[bins], dim=["time"])
    assert h.dims == ("x", "v_bin")
    assert h.name == "histogram_v"
    assert h.coords["v_bin"].attrs == {"units": "m"}
    np.testing.assert_array_equal(h.coords["x"].values, np.arange(6.0))
    expected = np.stack([np.histogram(np.asarray(da.data)[:, i], bins=bins)[0]
                         for i in range(6)])
    np.testing.assert_array_equal(h.values, expected)


def test_duck_errors(DataArray):
    a = DataArray(np.zeros((3, 4), "f4"), dims=("t", "x"), name="a")
    b = DataArray(np.zeros((3, 5), "f4"), dims=("t", "x"), name="b")
    with pytest.raises(ValueError):
        histogram(a, b, bins=[np.linspace(0, 1, 3)] * 2)
    with pytest.raises(ValueError):
        histogram(DataArray(np.zeros(4, "f4"), dims=("x",)), bins=np.linspace(0, 1, 3))


def test_duck_weights_labeled_broadcast(DataArray):
    rng = np.random.RandomState(1)
    da = DataArray(rng.randn(5, 8).astype("f4"), dims=("t", "x"), name="v")
    w = DataArray(rng.rand(8).astype("f4"), dims=("x",))
    bins = np.linspace(-3, 3, 7)
    h = _duck_both(da, bins=bins, weights=w)
    wb = np.broadcast_to(np.asarray(w.data), (5, 8))
    expected = np.histogram(np.asarray(da.data, "f8").ravel(), bins=bins,
                            weights=wb.ravel())[0]
    np.testing.assert_allclose(h.values, expected, rtol=1e-5)


def test_duck_keep_coords(DataArray):
    rng = np.random.RandomState(2)
    lat = rng.rand(6)
    da = DataArray(rng.randn(4, 6).astype("f4"), dims=("time", "x"),
                   coords={"x": np.arange(6.0), "lat": (("x",), lat, {"axis": "Y"}),
                           "cell2d": (("time", "x"), rng.rand(4, 6))},
                   name="v")
    bins = np.linspace(-4, 4, 5)
    h = _duck_both(da, bins=bins, dim=["time"], keep_coords=True)
    np.testing.assert_array_equal(h.coords["lat"].values, lat)
    assert h.coords["lat"].attrs == {"axis": "Y"}
    assert "cell2d" not in h.coords  # 'time' is reduced away
    assert "lat" not in _duck_both(da, bins=bins, dim=["time"]).coords


def test_duck_joint_two_doubles(DataArray):
    rng = np.random.RandomState(4)
    a = DataArray(rng.randn(200).astype("f4"), dims=("p",), name="T")
    b = DataArray(rng.randn(200).astype("f4"), dims=("p",), name="S")
    ea, eb = np.linspace(-3, 3, 7), np.linspace(-3, 3, 5)
    h = _duck_both(a, b, bins=[ea, eb])
    assert h.name == "histogram_T_S" and h.dims == ("T_bin", "S_bin")
    expected, _, _ = np.histogram2d(np.asarray(a.data, "f8"), np.asarray(b.data, "f8"),
                                    bins=[ea, eb])
    np.testing.assert_array_equal(h.values, expected)


def test_needs_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tlab.histogram(_mk(), bins=np.linspace(-3, 3, 9))
