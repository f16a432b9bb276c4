"""Weighted histograms of the port against the JAX package and numpy.

Every route of the weighted ``plan()`` runs here on the CPU: the kernel
route (``method="cuda"``) takes each wrapper's plain version, held against
the JAX package's Pallas kernels under the interpreter (``method="pallas"``)
and its scatter strategy, and against ``ts_cases.reference_numpy_weighted``.
Float sums are held to the tightest bound the JAX package documents,
``precision='highest'`` (rtol 3e-7, atol 1e-6, tests/test_precision.py),
for every public ``precision=``; integer sums bit for bit. The port's
recorded divergences (float64 and int64 sums, float16 weights) are held to
exact oracles.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import xhistogram_tpu
from xhistogram_tpu.ops import pallas_hist
import xhistogram_torch
from xhistogram_torch.ops import cuda_hist
from ts_cases import reference_numpy_weighted

histogram_cpu = functools.partial(xhistogram_torch.histogram, device="cpu")

RTOL, ATOL = 3e-7, 1e-6  # the JAX package's 'highest' bound
PRECISIONS = [None, "split", "highest", "i8", "i8x3"]


def _edges(nb, lo=-3.0, hi=3.0):
    return np.linspace(lo, hi, nb + 1)


def _data(shape, n_inputs, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_inputs):
        x = rng.normal(0.1 * i, 1.0, shape).astype(np.float32)
        x.flat[::23] = np.nan
        out.append(x)
    return out


# (label, data shape, axis, nbins, the route of the weighted plan())
ROUTES = [
    ("one_input-full", (4, 300), None, (10,), "one_input"),
    ("one_input-rows", (6, 300), (1,), (13,), "one_input"),
    ("joint2", (4, 300), None, (30, 40), "joint2"),
    ("factored-full", (4, 300), None, (20, 20, 10), "factored"),
    ("per_row", (4, 300), (1,), (30, 40), "factored_per_row"),
    ("packed", (16, 64), (1,), (100, 100), "factored_packed"),
    ("direct", (16, 64), (1,), (20, 20), "direct"),
]


def _case(route_id, seed=0):
    label, shape, axis, nbins, route = next(r for r in ROUTES if r[0] == route_id)
    args = _data(shape, len(nbins), seed)
    bins = [_edges(nb) for nb in nbins]
    return args, bins, axis, route


def _route_of(args, bins, axis, weights_dtype, wmode=None):
    """The port's route for this call (its own limits: weighted calls take
    the unweighted caps) and the JAX package's weighted route."""
    shape = args[0].shape
    if axis is None:
        m, c = 1, None
    else:
        m = int(np.prod([n for i, n in enumerate(shape) if i not in axis]))
        c = int(np.prod([shape[i] for i in axis]))
    nbins = tuple(len(e) - 1 for e in bins)
    ours = cuda_hist.plan(len(args), nbins, m, c)
    jdt = jnp.float32 if weights_dtype.is_floating_point else jnp.int32
    theirs = pallas_hist.planned_kernel(len(args), nbins, m, c, weighted=True,
                                        weights_dtype=jdt, wmode=wmode)
    return ours, theirs


@pytest.mark.parametrize("precision", PRECISIONS, ids=str)
@pytest.mark.parametrize("route_id", [r[0] for r in ROUTES])
def test_float_weights_on_every_route(route_id, precision):
    args, bins, axis, route = _case(route_id)
    rng = np.random.default_rng(1)
    w = rng.random(args[0].shape).astype(np.float32)
    assert _route_of(args, bins, axis, torch.float32, precision) == (route, route)
    want = reference_numpy_weighted(args, bins, w, axis)
    for method in ("cuda", "auto", "scatter"):
        h, _ = histogram_cpu(*args, bins=bins, axis=axis, weights=w,
                             precision=precision, method=method)
        assert h.dtype == torch.float32 and h.shape == want.shape
        np.testing.assert_allclose(h.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=method)
    if precision == "highest":  # the JAX kernel and scatter, on the same inputs
        for method in ("pallas", "scatter"):
            jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis,
                                             weights=w, precision=precision,
                                             method=method)
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2 * RTOL,
                                       atol=2 * ATOL, err_msg=method)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int16, np.uint8, np.bool_],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("route_id", [r[0] for r in ROUTES])
def test_narrow_int_weights_wrap_bit_equal(route_id, dtype):
    """int32 sums mod 2^32 on every route, bit-equal to the JAX kernel and
    scatter; int32 weights spanning ±2^30 overflow and wrap."""
    args, bins, axis, route = _case(route_id, seed=2)
    rng = np.random.default_rng(3)
    if dtype == np.bool_:
        w = rng.random(args[0].shape) < 0.5
    else:
        info = np.iinfo(dtype)
        lo, hi = (-(2**30), 2**30) if dtype == np.int32 else (info.min, info.max)
        w = rng.integers(lo, hi, args[0].shape, endpoint=True).astype(dtype)
    if dtype == np.uint32:
        w[0, :5] = 2**32 - 1
    exact = reference_numpy_weighted(args, bins, w, axis, exact=True)
    wrapped = (exact.astype(object) % 2**32).astype(np.int64)
    wrapped = np.where(wrapped >= 2**31, wrapped - 2**32, wrapped).astype(np.int32)
    jax_kernel, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, weights=w,
                                             method="pallas")
    np.testing.assert_array_equal(np.asarray(jax_kernel).astype(np.int32), wrapped)
    for method in ("cuda", "auto"):
        h, _ = histogram_cpu(*args, bins=bins, axis=axis, weights=w, method=method)
        assert h.dtype == torch.int32
        np.testing.assert_array_equal(h.numpy(), wrapped, err_msg=method)


@pytest.mark.parametrize("route_id", [r[0] for r in ROUTES])
def test_int64_weights_beyond_int32_bit_equal(route_id):
    """int64 weights beyond int32 take the JAX package's exact host digit
    path, which returns int64; the port's int64 sums equal it."""
    args, bins, axis, route = _case(route_id, seed=4)
    rng = np.random.default_rng(5)
    w = rng.integers(-(2**40), 2**40, args[0].shape, dtype=np.int64)
    w[0, 0] = 2**62
    jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, weights=w)
    assert np.asarray(jh).dtype == np.int64
    for method in ("cuda", "auto"):
        h, _ = histogram_cpu(*args, bins=bins, axis=axis, weights=w, method=method)
        assert h.dtype == torch.int64
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh), err_msg=method)


@pytest.mark.parametrize("route_id", ["one_input-rows", "joint2", "direct"])
def test_in_range_int64_weights_are_exact(route_id):
    """The recorded divergence: int64 weights whose values each fit int32
    sum to exact int64 here, where the JAX package wraps them to int32."""
    args, bins, axis, route = _case(route_id, seed=6)
    w = np.full(args[0].shape, 2**30, np.int64)
    w[::2] = -(2**31)
    exact = reference_numpy_weighted(args, bins, w, axis, exact=True)
    jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, weights=w)
    assert np.asarray(jh).dtype == np.int32  # wrapped
    for method in ("cuda", "auto"):
        h, _ = histogram_cpu(*args, bins=bins, axis=axis, weights=w, method=method)
        assert h.dtype == torch.int64
        assert h.numpy().astype(object).tolist() == exact.tolist()
    wraps = (exact.astype(object) % 2**32).astype(np.int64)
    np.testing.assert_array_equal(
        np.where(wraps >= 2**31, wraps - 2**32, wraps), np.asarray(jh)
    )


@pytest.mark.parametrize("route_id", ["one_input-full", "joint2", "per_row", "direct"])
def test_uint64_weights_bit_equal(route_id):
    args, bins, axis, route = _case(route_id, seed=7)
    rng = np.random.default_rng(8)
    w = rng.integers(0, 2**63, args[0].shape, dtype=np.uint64) * np.uint64(2)
    jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, weights=w)
    assert np.asarray(jh).dtype == np.uint64
    exact = reference_numpy_weighted(args, bins, w, axis, exact=True)
    for method in ("cuda", "auto"):
        h, _ = histogram_cpu(*args, bins=bins, axis=axis, weights=w, method=method)
        assert h.dtype == torch.uint64
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh), err_msg=method)
        assert h.numpy().astype(object).tolist() == (exact % 2**64).tolist()


@pytest.mark.parametrize("route_id", [r[0] for r in ROUTES])
def test_nonfinite_weights(route_id):
    """A NaN weight makes its own bin NaN, +inf and -inf in one bin make it
    NaN, one infinity makes it that infinity: np.bincount's semantics, as
    the JAX package's faithful channels give; NaN data drop their weight."""
    args, bins, axis, route = _case(route_id, seed=9)
    rng = np.random.default_rng(10)
    w = rng.random(args[0].shape).astype(np.float32)
    flat = w.reshape(-1)
    flat[rng.choice(flat.size, 12, replace=False)] = np.nan
    flat[rng.choice(flat.size, 12, replace=False)] = np.inf
    flat[rng.choice(flat.size, 12, replace=False)] = -np.inf
    flat[::23] = np.nan  # on the NaN data: never added
    want = reference_numpy_weighted(args, bins, w, axis)
    jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, weights=w,
                                     method="pallas", precision="highest")
    for method in ("cuda", "auto"):
        h, _ = histogram_cpu(*args, bins=bins, axis=axis, weights=w, method=method)
        for ref in (want, np.asarray(jh)):
            np.testing.assert_array_equal(np.isnan(h.numpy()), np.isnan(ref))
            np.testing.assert_array_equal(np.isinf(h.numpy()) * np.sign(h.numpy()),
                                          np.isinf(ref) * np.sign(ref))
            finite = np.isfinite(ref)
            np.testing.assert_allclose(h.numpy()[finite], ref[finite], rtol=2 * RTOL,
                                       atol=2 * ATOL, err_msg=method)


@pytest.mark.parametrize(
    "dtype,want",
    [(np.float16, torch.float32), (np.float32, torch.float32),
     (np.float64, torch.float64)],
    ids=["f16", "f32", "f64"],
)
@pytest.mark.parametrize("route_id", ["one_input-full", "joint2", "factored-full",
                                      "packed", "direct"])
def test_float_dtypes(route_id, dtype, want):
    """float16 weights give float32 on every route (the JAX package gives
    float16 on its scatter route), and float64 weights give float64, held
    to a float64 oracle (the JAX package gives float32)."""
    args, bins, axis, route = _case(route_id, seed=11)
    rng = np.random.default_rng(12)
    w = (rng.random(args[0].shape) * 4).astype(dtype)
    oracle = reference_numpy_weighted(args, bins, w, axis)
    rtol = 3e-7 if want == torch.float32 else 1e-13
    for method in ("cuda", "auto"):
        h, _ = histogram_cpu(*args, bins=bins, axis=axis, weights=w, method=method)
        assert h.dtype == want
        np.testing.assert_allclose(h.numpy(), oracle, rtol=rtol, atol=ATOL)
    wt = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    h, _ = histogram_cpu(*(torch.from_numpy(a) for a in args), bins=bins, axis=axis,
                         weights=wt, method="cuda")
    assert h.dtype == torch.float32
    np.testing.assert_allclose(
        h.numpy(), reference_numpy_weighted(args, bins, wt.float().numpy(), axis),
        rtol=RTOL, atol=ATOL)


def test_integer_valued_float_weights_bit_equal():
    """Sums of integer-valued float32 weights are exact below 2^24, so every
    route equals the JAX kernel bit for bit."""
    for route_id in [r[0] for r in ROUTES]:
        args, bins, axis, route = _case(route_id, seed=13)
        w = np.random.default_rng(14).integers(-50, 50, args[0].shape).astype(np.float32)
        jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, weights=w,
                                         method="pallas")
        h, _ = histogram_cpu(*args, bins=bins, axis=axis, weights=w, method="cuda")
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh), err_msg=route_id)


@pytest.mark.parametrize("axis", [None, (1,), (0, 2), (2,)], ids=str)
def test_weights_with_more_dims_than_the_data(axis):
    """The weights broadcast with the data and may add dimensions; int bins
    are resolved on the broadcast data, as in the JAX package."""
    rng = np.random.default_rng(15)
    a = rng.normal(size=(6, 50)).astype(np.float32)
    b = rng.normal(size=(50,)).astype(np.float32)
    w = rng.random((3, 6, 50)).astype(np.float32)
    for args, bins in (((a,), [_edges(8)]), ((a, b), [7, _edges(5)])):
        h, edges = histogram_cpu(*args, bins=bins, axis=axis, weights=w)
        jh, jedges = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, weights=w,
                                              precision="highest")
        for e, je in zip(edges, jedges):
            np.testing.assert_array_equal(e, je)
        assert tuple(h.shape) == np.asarray(jh).shape
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2 * RTOL, atol=2 * ATOL)


@pytest.mark.parametrize("route_id", [r[0] for r in ROUTES])
def test_weighted_density(route_id):
    args, bins, axis, route = _case(route_id, seed=16)
    w = np.random.default_rng(17).random(args[0].shape).astype(np.float32)
    jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, weights=w,
                                     density=True, method="pallas", precision="highest")
    for method in ("cuda", "auto"):
        h, _ = histogram_cpu(*args, bins=bins, axis=axis, weights=w, density=True,
                             method=method)
        assert h.dtype == torch.float32
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-7)
    wi = (w * 100).astype(np.int32)
    h, _ = histogram_cpu(*args, bins=bins, axis=axis, weights=wi, density=True)
    jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, weights=wi, density=True)
    assert h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6, atol=0)


def _raised(fn):
    try:
        fn()
    except Exception as ex:  # noqa: BLE001 — the type and message are compared
        return type(ex), str(ex)
    return None


@pytest.mark.parametrize("precision", ["bogus", "", "int2", "dig3", "exact", 3],
                         ids=str)
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_precision_errors_match_jax(precision, weighted):
    x = np.linspace(0, 1.9, 16).astype(np.float32)
    kwargs = {"bins": [np.array([0.0, 1.0, 2.0])], "precision": precision}
    if weighted:
        kwargs["weights"] = np.ones(16, np.float32)
    got = _raised(lambda: histogram_cpu(x, **kwargs))
    want = _raised(lambda: xhistogram_tpu.histogram(x, **kwargs))
    assert want is not None and got == want


def test_precision_f64_not_ported_for_float_weights():
    """precision='f64' with float weights gives the JAX package's exact
    float64 sums (within 1 ulp; tests/test_torch_f64.py holds the tier to
    exact oracles), no longer a refusal."""
    x = np.linspace(0, 1.9, 16)
    e = [np.array([0.0, 1.0, 2.0])]
    w = np.random.default_rng(22).normal(size=16) * 10.0 ** np.arange(-8, 8)
    for wf in (w, w.astype(np.float32)):
        h, _ = histogram_cpu(x, bins=e, weights=wf, precision="f64")
        jh, _ = xhistogram_tpu.histogram(x, bins=e, weights=wf, precision="f64")
        assert h.dtype == torch.float64 and np.asarray(jh).dtype == np.float64
        np.testing.assert_array_max_ulp(h.numpy(), np.asarray(jh), maxulp=1)
    # exact in every mode already: the request normalizes away, as in JAX
    for w in (None, np.arange(16, dtype=np.int32), np.arange(16, dtype=np.int64)):
        h, _ = histogram_cpu(x, bins=e, weights=w, precision="f64")
        jh, _ = xhistogram_tpu.histogram(x, bins=e, weights=w, precision="f64")
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


@pytest.mark.parametrize("route_id", [r[0] for r in ROUTES])
def test_autograd_with_a_broadcast_weight(route_id):
    """w.grad equals jax.grad of a weighted sum of the histogram, for a
    weight broadcast over the data's first axis."""
    args, bins, axis, route = _case(route_id, seed=18)
    rng = np.random.default_rng(19)
    w = rng.random(args[0].shape[1:]).astype(np.float32)  # broadcast over rows
    h_shape = histogram_cpu(*args, bins=bins, axis=axis, weights=w)[0].shape
    coef = rng.normal(size=tuple(h_shape)).astype(np.float32)

    def jax_loss(wj):
        h, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, weights=wj,
                                        method="scatter")
        return jnp.sum(h * coef)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(w)))
    for method in ("cuda", "auto"):
        wt = torch.from_numpy(w).requires_grad_()
        h, _ = histogram_cpu(*(torch.from_numpy(a) for a in args), bins=bins,
                             axis=axis, weights=wt, method=method)
        (h * torch.from_numpy(coef)).sum().backward()
        assert wt.grad.shape == wt.shape and wt.grad.dtype == torch.float32
        np.testing.assert_allclose(wt.grad.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=method)


def test_autograd_gives_no_gradient_outside_the_bins():
    x = torch.tensor([0.5, 1.5, 5.0, float("nan")])
    w = torch.ones(4, dtype=torch.float64, requires_grad=True)
    h, _ = xhistogram_torch.histogram(x, bins=[np.array([0.0, 1.0, 2.0])], weights=w)
    assert h.dtype == torch.float64
    (h * torch.tensor([2.0, 3.0], dtype=torch.float64)).sum().backward()
    assert w.grad.tolist() == [2.0, 3.0, 0.0, 0.0]


def test_weights_bad_shape_raises_like_jax():
    x = np.ones(3)
    e = [np.array([0.0, 1.0, 2.0])]
    got = _raised(lambda: histogram_cpu(x, bins=e, weights=np.ones(4)))
    want = _raised(lambda: xhistogram_tpu.histogram(x, bins=e, weights=np.ones(4)))
    assert got[0] is want[0] is ValueError
    assert got[1] == want[1]


@pytest.mark.parametrize(
    "n_inputs,nbins,m,c,route,jax_routes",
    [
        # BASELINE config 2: one input, 50 bins, 1000 kept rows
        (1, (50,), 1000, 100_000, "one_input", {"f": "one_input", "i": "one_input"}),
        # the T–S diagram, full
        (2, (280, 340), 1, None, "joint2", {"f": "joint2", "i": "joint2"}),
        # the README per-level T–S call
        (2, (280, 340), 50, 73 * 64800, "factored_per_row",
         {"f": "factored_per_row", "i": "factored_per_row"}),
        # three inputs in 60^3 bins, full
        (3, (60, 60, 60), 1, None, "factored", {"f": "factored", "i": "factored"}),
        # 40x40 per row at m = 1000 and at config 4's grid
        (2, (40, 40), 1000, 64, "direct", {"f": "direct", "i": "direct"}),
        (2, (40, 40), 64800, 64, "direct", {"f": None, "i": "direct"}),
        # past the JAX package's weighted full-reduction caps
        (2, (1000, 1000), 1, None, "factored", {"f": None, "i": None}),
        # 120x90 per row over 64 members
        (2, (120, 90), 16384, 64, "factored_packed", {"f": None, "i": "factored_packed"}),
    ],
    ids=["config2", "ts", "readme", "3in-60", "direct-1000", "direct-64800",
         "1000x1000", "packed"],
)
def test_weighted_plan_of_the_path_shapes(n_inputs, nbins, m, c, route, jax_routes):
    """The port routes weighted calls by its own limits, the unweighted caps,
    where the JAX package's weighted gates (its TPU kernels' channel and
    Kahan outputs, per-mode caps and integer digit modes) send float
    weights to scatter at three of these shapes."""
    assert cuda_hist.plan(n_inputs, nbins, m, c) == route
    assert pallas_hist.plan(n_inputs, nbins, m, c=c, weighted=False, uniform=None) == route
    for kind, want in jax_routes.items():
        theirs = pallas_hist.planned_kernel(
            n_inputs, nbins, m, c, weighted=True,
            weights_dtype=jnp.float32 if kind == "f" else jnp.int32)
        assert theirs == want, kind


def test_float_weighted_scatter_where_jax_runs_scatter():
    """40x40 bins at 64,800 rows: the JAX package runs float weights through
    its scatter strategy (its kernels' four per-slot outputs pass its 2^28
    gate); the port runs the direct route, whose sums agree with the JAX
    scatter's within the 'highest' bound, and with numpy's."""
    args = _data((640, 8), 2, seed=20)
    bins = [_edges(40)] * 2
    w = np.random.default_rng(21).random((640, 8)).astype(np.float32)
    assert cuda_hist.plan(2, (40, 40), 64800, 64) == "direct"
    assert pallas_hist.planned_kernel(2, (40, 40), 64800, 64, weighted=True,
                                      weights_dtype=jnp.float32) is None
    jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=1, weights=w,
                                     precision="highest", method="scatter")
    want = reference_numpy_weighted(args, bins, w, (1,))
    for method in ("auto", "cuda"):
        h, _ = histogram_cpu(*args, bins=bins, axis=1, weights=w, method=method)
        assert h.dtype == torch.float32
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(h.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wdtype", [np.float32, np.float64, np.int32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("c", [1, 63, 255])
@pytest.mark.parametrize("nbins", [(40, 40), (8191,)], ids=["40x40", "8191"])
def test_direct_finished_rows_equal_finish_sums(nbins, c, wdtype):
    """The direct route's finished rows (float32 for float32 weights, as its
    kernel stores them) are ``finish_sums`` of its float64 rows bit for bit,
    the op gives them with ``finish=True``, and they match the JAX
    package's ``_direct_kernel`` under the interpreter within the 'highest'
    bound (integer sums bit for bit)."""
    from xhistogram_torch import bins as tbins
    from xhistogram_torch.ops.bincount import finish_sums, weighted_dtype

    m = 6
    args = _data((m, c), len(nbins), seed=c)
    bins = [_edges(nb) for nb in nbins]
    rng = np.random.default_rng(c + len(nbins))
    if wdtype == np.int32:
        w = rng.integers(-(2**30), 2**30, (m, c)).astype(np.int32)
    else:
        w = (rng.random((m, c)) * 4 - 1).astype(wdtype)
    layouts = [torch.from_numpy(a) for a in args]
    thr = [torch.from_numpy(tbins.compare_form(e, np.float32).edges) for e in bins]
    wt = torch.from_numpy(w)
    raw = cuda_hist.direct_reference(layouts, thr, list(nbins), weights=wt, finish=False)
    fin = cuda_hist.direct_reference(layouts, thr, list(nbins), weights=wt)
    assert raw.dtype == (torch.float64 if w.dtype.kind == "f" else torch.int32)
    assert fin.dtype == weighted_dtype(wt.dtype)
    assert torch.equal(fin, finish_sums(raw, wt.dtype))
    op = torch.ops.xhistogram.direct(layouts, thr, wt, list(nbins), True)
    assert op.dtype == fin.dtype and torch.equal(op, fin)
    assert torch.equal(torch.ops.xhistogram.direct(layouts, thr, wt, list(nbins)), raw)
    assert pallas_hist.plan(len(nbins), nbins, m, c=c, weighted=False,
                            uniform=None) == "direct"
    jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=1, weights=w,
                                     precision="highest", method="pallas")
    got = fin[:, :-1].reshape(m, *nbins).numpy()
    if wdtype == np.int32:
        np.testing.assert_array_equal(got, np.asarray(jh))
    else:
        np.testing.assert_allclose(got, np.asarray(jh), rtol=RTOL, atol=ATOL)
