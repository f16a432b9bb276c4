"""factored — the N-input kernel of the factored routes — against the JAX
package.

On the CPU the wrapper runs ``factored_reference``, the plain version the
CUDA kernel (``csrc/factored.cu``) is held to on the card
(tests/test_torch_gpu.py, chip_smoke.py). Here the port's
``method="cuda"`` (which runs the kernel's wrapper) and ``method="auto"``
(the scatter strategy on the CPU), the JAX package's ``_factored_kernel``
under the Pallas interpreter (``method="pallas"``; a spy on
``_run_factored`` shows which variant ran) and numpy must give the same
counts, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import xhistogram_tpu
from xhistogram_tpu.ops import pallas_hist
import xhistogram_torch
from xhistogram_torch import bins as tbins
from xhistogram_torch import core
from xhistogram_torch.ops import cuda_hist
from ts_cases import (
    EDGE_SETS, S_EDGES, T_EDGES, edge_case_data, reference_numpy_joint, ts_data,
)

ROUTE = {"full": "factored", "per_row": "factored_per_row",
         "packed": "factored_packed"}


def edges(nb, spacing="even", lo=-3.0, hi=3.0, seed=0):
    """nb + 1 edges over [lo, hi]: evenly spaced, or not (then the JAX
    package digitizes through its compare chain, with no uniform-spacing
    certificate)."""
    if spacing == "even":
        return np.linspace(lo, hi, nb + 1)
    inner = np.random.default_rng(nb + seed).uniform(lo, hi, 4 * nb)
    return np.concatenate([[lo], np.sort(np.unique(inner))[: nb - 1], [hi]])


def data(shape, n_inputs, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_inputs):
        x = rng.normal(0.1 * i, 1.2, shape).astype(dtype)
        if x.dtype.kind == "f":
            x.flat[:: 17] = np.nan
        out.append(x)
    return out


def _layout(args, axis):
    """(m, c) of the canonical layout, m == 1 for a full reduction, as the
    public call hands plan()."""
    shape = np.broadcast_shapes(*(np.shape(a) for a in args))
    if axis is None:
        return 1, None
    m = int(np.prod([n for i, n in enumerate(shape) if i not in axis], dtype=np.int64))
    if m == 1:
        return 1, None
    return m, int(np.prod(shape, dtype=np.int64)) // m


def _spy(monkeypatch):
    """Records the kernel routes each package's dispatch runs."""
    ran = {"jax": [], "port": []}
    run_factored, run_direct = pallas_hist._run_factored, pallas_hist._run_direct

    def jax_factored(*args, per_row=False, packed=False, **kwargs):
        ran["jax"].append(ROUTE["packed" if packed else "per_row" if per_row else "full"])
        return run_factored(*args, per_row=per_row, packed=packed, **kwargs)

    def jax_direct(*args, **kwargs):
        ran["jax"].append("direct")
        return run_direct(*args, **kwargs)

    def port_factored(arrays_2d, thresholds, nbins, variant, weights=None):
        ran["port"].append(ROUTE[variant])
        return cuda_hist.factored(arrays_2d, thresholds, nbins, variant, weights)

    def port_direct(arrays_2d, thresholds, nbins, weights=None):
        ran["port"].append("direct")
        return cuda_hist.direct(arrays_2d, thresholds, nbins, weights)

    monkeypatch.setattr(pallas_hist, "_run_factored", jax_factored)
    monkeypatch.setattr(pallas_hist, "_run_direct", jax_direct)
    monkeypatch.setattr(core, "factored", port_factored)
    monkeypatch.setattr(core, "direct", port_direct)
    jax.clear_caches()  # a cached trace would skip the JAX dispatch
    return ran


def all_agree(monkeypatch, args, bins, axis=None, kernel=None, numpy=True,
              jax_kernel=True, density=False):
    """numpy, the port (cuda and auto, CPU tensors) and the JAX kernel give
    the same counts; plan() names ``kernel`` in both packages (None: no
    kernel, so method="cuda" takes the forced route) and both dispatchers
    run that route."""
    nbins = tuple(len(e) - 1 for e in bins)
    m, c = _layout(args, axis)
    planned = cuda_hist.plan(len(args), nbins, m, c)
    assert planned == kernel
    assert pallas_hist.plan(len(args), nbins, m, c=c, weighted=False, uniform=None) == kernel
    route = kernel or ("factored" if m == 1 else "direct")
    ran = _spy(monkeypatch)
    got = {}
    for method in ("cuda", "auto"):
        h, got_edges = xhistogram_torch.histogram(
            *(torch.from_numpy(np.asarray(a)) for a in args), bins=bins, axis=axis,
            method=method, density=density,
        )
        assert h.device.type == "cpu"
        assert h.dtype == (torch.float32 if density else torch.int64)
        for e, want in zip(got_edges, bins):
            np.testing.assert_array_equal(e, want)
        got[method] = h.numpy()
    assert ran["port"] == [route]  # cuda ran the kernel's wrapper, auto scatter
    np.testing.assert_array_equal(got["cuda"], got["auto"])
    if numpy and not density:
        np.testing.assert_array_equal(got["cuda"], reference_numpy_joint(args, bins, axis))
    if jax_kernel:
        jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis, method="pallas",
                                         density=density)
        assert ran["jax"] == [route]
        if density:  # JAX's compiled division may round the last bit differently
            np.testing.assert_allclose(got["cuda"], np.asarray(jh), rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got["cuda"], np.asarray(jh))
    return got["cuda"]


CASES = {
    # full reductions: two inputs past joint2's gate, three inputs, one
    # input over 1024 bins
    "full-2in-800x800": ((2, 500), 2, (800, 800), None, "factored"),
    "full-3in": ((2, 50), 3, (5, 6, 7), None, "factored"),
    "full-1in-2000": ((3000,), 1, (2000,), None, "factored"),
    # kept rows with wide reduce axes
    "per_row-150x90": ((5, 400), 2, (150, 90), (1,), "factored_per_row"),
    "per_row-1in-9000": ((3, 600), 1, (9000,), (1,), "factored_per_row"),
    "per_row-odd-c": ((4, 333), 2, (100, 120), (1,), "factored_per_row"),
    "per_row-3in-axis02": ((4, 3, 90), 3, (20, 30, 4), (0, 2), "factored_per_row"),
    # narrow rows over 8192 slots: m < 8, odd c, three inputs
    "packed-120x90": ((16, 64), 2, (120, 90), (1,), "factored_packed"),
    "packed-m3-c45": ((3, 45), 1, (9000,), (1,), "factored_packed"),
    "packed-odd-c": ((9, 37), 2, (100, 101), (1,), "factored_packed"),
    "packed-3in": ((12, 80), 3, (20, 25, 20), (1,), "factored_packed"),
    # forced method="cuda" beyond plan()'s full-reduction cap of 2^21 slots
    "forced-full-2.2M": ((64,), 3, (130, 130, 130), None, None),
}


@pytest.mark.parametrize("spacing", ["even", "uneven"])
@pytest.mark.parametrize("case", list(CASES))
def test_routes_bit_equal(monkeypatch, case, spacing):
    shape, n_inputs, nbins, axis, kernel = CASES[case]
    args = data(shape, n_inputs, seed=len(case))
    bins = [edges(nb, spacing, seed=i) for i, nb in enumerate(nbins)]
    all_agree(monkeypatch, args, bins, axis, kernel)


def test_readme_per_level_call(monkeypatch):
    """The README's joint T–S diagram per depth level, at a small size:
    (time, depth, cell) with axis=(0, 2), 280x340 bins."""
    t, s = ts_data((6, 3, 50), seed=7)
    t.flat[::29] = np.nan
    h = all_agree(monkeypatch, [t, s], [T_EDGES, S_EDGES], (0, 2), "factored_per_row")
    assert h.shape == (3, 280, 340)


def test_broadcast_inputs(monkeypatch):
    """A broadcast input (a zero-stride view in the kept-row layout) on the
    per-row route, and on a full reduction."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(4, 300)).astype(np.float32)
    b = rng.normal(size=(300,)).astype(np.float32)
    bins = [edges(150), edges(90, "uneven")]
    all_agree(monkeypatch, [a, b], bins, (1,), "factored_per_row")
    all_agree(monkeypatch, [a, b], [edges(800)] * 2, None, "factored")


def test_density(monkeypatch):
    args = data((5, 400), 2, seed=3)
    all_agree(monkeypatch, args, [edges(150), edges(90, "uneven")], (1,),
              "factored_per_row", density=True)


def _dtype_case(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int64":
        return rng.integers(-(2**45), 2**45, shape), edges(150, lo=-(2.0**44), hi=2.0**44)
    if dtype == "int32":
        return rng.integers(-4000, 4000, shape).astype(np.int32), edges(150, lo=-3000.5,
                                                                       hi=3000.5)
    return rng.normal(0.0, 1.5, shape).astype(dtype), edges(150)


@pytest.mark.parametrize(
    "dtypes",
    [("float64", "float64"), ("int32", "int32"), ("int64", "int64"),
     ("float16", "float16"), ("float32", "float64"), ("int32", "float32"),
     ("int32", "int64")],
    ids=str,
)
@pytest.mark.parametrize("axis,kernel", [(None, "factored"), ((1,), "factored_per_row")],
                         ids=["full", "per_row"])
def test_dtypes(monkeypatch, dtypes, axis, kernel):
    shape = (4, 300)
    args, bins = zip(*(_dtype_case(d, shape, seed=i) for i, d in enumerate(dtypes)))
    if axis is None:
        bins = [np.linspace(e[0], e[-1], 1001) for e in bins]  # past joint2's gate
    # numpy compares int64 data in float64, which is not exact here
    all_agree(monkeypatch, list(args), list(bins), axis, kernel,
              numpy="int64" not in dtypes)


@pytest.mark.parametrize("name", list(EDGE_SETS))
def test_edge_cases(monkeypatch, name):
    """Each edge, one ulp either side, NaN, ±inf, ±0 and subnormals, with a
    third input, over all elements and per row."""
    te, se = EDGE_SETS[name]
    t, s = (x[: len(x) // 2 * 2] for x in edge_case_data(te, se, n_random=300))
    third = np.full_like(t, 0.5)
    bins = [np.asarray(te), np.asarray(se), np.array([0.0, 0.25, 1.0])]
    all_agree(monkeypatch, [t, s, third], bins, None, "factored")
    rows = [x.reshape(2, -1) for x in (t, s, third)]
    kernel = cuda_hist.plan(3, tuple(len(e) - 1 for e in bins), 2, rows[0].shape[1])
    assert kernel in ("factored_per_row", "direct", "factored_packed")
    all_agree(monkeypatch, rows, bins, (1,), kernel)


def test_negative_subnormal_is_below_a_zero_edge():
    x = np.array([-1e-45, 1e-45, -0.0, 0.0], np.float32)
    z = np.array([0.0, 1.0])
    for args in ([x, x, x], [x.reshape(1, -1)] * 3):
        h, _ = xhistogram_torch.histogram(*map(torch.from_numpy, args), bins=[z] * 3,
                                          method="cuda")
        assert int(h.sum()) == 3  # -1e-45 lands below the range


@pytest.mark.parametrize("variant", list(ROUTE))
@pytest.mark.parametrize("m,c", [(0, 5), (5, 0), (1, 1), (7, 1), (3, 4097)])
def test_empty_and_ragged(variant, m, c):
    args = [torch.from_numpy(x) for x in data((m, c), 2, seed=m + c)]
    bins = [edges(50), edges(30)]
    thr = [torch.from_numpy(tbins.compare_form(e, np.float32).edges) for e in bins]
    out = cuda_hist.factored(args, thr, [50, 30], variant)
    rows = 1 if variant == "full" else m
    assert out.shape == (rows, 50 * 30 + 1) and out.dtype == torch.int64
    assert (out[:, -1] == 0).all()  # the trash slot stays empty, as in JAX
    axis = None if variant == "full" else (1,)
    np.testing.assert_array_equal(
        out[:, :-1].reshape((rows,) + (50, 30)).numpy(),
        reference_numpy_joint([a.numpy() for a in args], bins, axis).reshape(rows, 50, 30),
    )


def test_wrapper_contract_on_cpu():
    a, b = (torch.from_numpy(x) for x in data((6, 40), 2, seed=1))
    thr = [torch.from_numpy(tbins.compare_form(e, np.float32).edges)
           for e in (edges(50), edges(30))]
    before = dict(cuda_hist.FACTORED_LAUNCHES)
    # a strided view gives the same counts as its copy
    for variant in ROUTE:
        got = cuda_hist.factored([a.t(), b.t()], thr, [50, 30], variant)
        want = cuda_hist.factored([a.t().contiguous(), b.t().contiguous()], thr,
                                  [50, 30], variant)
        assert torch.equal(got, want)
        assert torch.equal(got, cuda_hist.factored_reference([a.t(), b.t()], thr,
                                                             [50, 30], variant))
    assert cuda_hist.FACTORED_LAUNCHES == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="variant must be one of"):
        cuda_hist.factored([a, b], thr, [50, 30], "chunked")
    with pytest.raises(ValueError, match="one threshold tensor and one bin count"):
        cuda_hist.factored([a, b], thr[:1], [50], "full")
    with pytest.raises(ValueError, match="2-D layouts of one shape"):
        cuda_hist.factored([a, b[:3]], thr, [50, 30], "full")
    with pytest.raises(ValueError, match="at least one bin"):
        cuda_hist.factored([a, b], thr, [50, 0], "full")
    with pytest.raises(TypeError, match="thresholds must be in the data's dtype"):
        cuda_hist.factored([a.double(), b], thr, [50, 30], "full")
    with pytest.raises(ValueError, match="needs 31 thresholds"):
        cuda_hist.factored([a, b], [thr[0], thr[1][:-1]], [50, 30], "full")
    with pytest.raises(ValueError, match="share a device"):
        cuda_hist.factored([a, b], [thr[0], thr[1].to("meta")], [50, 30], "full")


def test_widen_keeps_broadcasts():
    """The kernels' dtype widening converts only the distinct elements: a
    broadcast stays a zero-stride view."""
    row = torch.arange(5, dtype=torch.int32).reshape(1, 5).expand(4, 5)
    col = torch.arange(4, dtype=torch.float32).reshape(4, 1).expand(4, 5)
    for x in (row, col, row.t()):
        w = cuda_hist._widen(x, torch.float64)
        assert w.dtype == torch.float64 and torch.equal(w, x.double())
        assert [s == 0 for s in w.stride()] == [s == 0 for s in x.stride()]
    assert cuda_hist._widen(row, torch.int32) is row


PATHS = {
    # the README's per-level T-S call over one year of 5-day means
    "readme-per-level": (2, (280, 340), 50, 73 * 64800, "factored_per_row"),
    "perf_model-54-full": (2, (1000, 1000), 1, None, "factored"),
    "perf_model-55-per_row": (2, (150, 90), 1000, 100_000, "factored_per_row"),
    "perf_model-56-packed": (2, (120, 90), 16384, 64, "factored_packed"),
    "three-inputs-full": (3, (100, 100, 50), 1, None, "factored"),
    "one-input-5000-full": (1, (5000,), 1, None, "factored"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_plan_sends_the_paths_to_factored(path):
    n_inputs, nbins, m, c, kernel = PATHS[path]
    assert cuda_hist.plan(n_inputs, nbins, m, c) == kernel
    assert pallas_hist.plan(n_inputs, nbins, m, c=c, weighted=False, uniform=None) == kernel
