"""joint2, factored and direct on narrow data (bool, 8- and 16-bit
integers, float16, bfloat16) against the JAX package.

The JAX kernels read such data at its own width and widen each tile in
registers (``pallas_hist._widen``; float16 is cast before the call), and the
port's kernels read it in place too (``csrc/narrow.cuh``): two inputs of
one narrow dtype in joint2's narrow entries, float32 and narrow inputs in
any mix in factored's and direct's narrow entries, narrow beside other wide
inputs in their mixed entries. ``cuda_hist.operand_plan``, a pure host
function, picks the entry and what each input is read as; here it is held
to widen no input (tests/test_torch_pairs.py holds the pairs of two
dtypes).
On the CPU each wrapper runs its plain version, the one the kernels are
held to on the card (tests/test_torch_gpu.py, chip_smoke.py). The public
``histogram`` (``method="auto"`` and ``"cuda"``) and each plain version
must give the JAX package's ``_joint2_kernel``, ``_factored_kernel`` (full,
per row, packed) and ``_direct_kernel`` results under the Pallas
interpreter: counts and integer sums bit for bit, float sums within the
JAX package's ``'highest'`` bound (rtol 3e-7, atol 1e-6).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xhistogram_tpu
from xhistogram_tpu.ops import pallas_hist
import xhistogram_torch
from xhistogram_torch import core
from xhistogram_torch.bins import compare_form
from xhistogram_torch.ops import cuda_hist
from xhistogram_torch.utils.axes import canonicalize_2d, normalize_axis

NARROW = {
    "bool": (torch.bool, np.bool_),
    "int8": (torch.int8, np.int8),
    "uint8": (torch.uint8, np.uint8),
    "int16": (torch.int16, np.int16),
    "uint16": (torch.uint16, np.uint16),
    "float16": (torch.float16, np.float16),
    "bfloat16": (torch.bfloat16, jnp.bfloat16),
}
WIDE = (torch.float32, torch.float64, torch.int32, torch.int64)
# the JAX package's 'highest' bound on float sums
RTOL, ATOL = 3e-7, 1e-6

# route: (shape, inputs, bins a input, axis); each plans the route in both
# packages
ROUTES = {
    "joint2": ((2, 300), 2, 12, None),
    "factored": ((2, 300), 3, 6, None),
    "factored_per_row": ((3, 300), 2, 12, (1,)),
    "factored_packed": ((4, 64), 2, 100, (1,)),
    "direct": ((6, 40), 2, 12, (1,)),
}
# the route each JAX dispatch names
_JAX_ROUTE = {(False, False): "factored", (True, False): "factored_per_row",
              (False, True): "factored_packed"}
WEIGHT_DTYPES = (np.float32, np.int32, np.int64)


def _edges(name, nb, seed=0):
    """nb + 1 edges over the type's values: fractional ones and ones on
    values for the integers (the extremes included), evenly spaced for the
    floats, over [-0.5, 1.5] for bool."""
    tdtype, ndtype = NARROW[name]
    if name == "bool":
        return np.linspace(-0.5, 1.5, nb + 1)
    if tdtype.is_floating_point:
        return np.linspace(-3.0, 3.0, nb + 1) + 0.01 * seed
    info = np.iinfo(ndtype)
    edges = np.linspace(float(info.min) - 0.5, float(info.max) + 3.0, nb + 1)
    edges[1:-1] = np.round(edges[1:-1]) + (np.arange(1, nb) % 2) * 0.5
    edges[1], edges[-2] = float(info.min), float(info.max)
    return edges


def _data(name, shape, edges, seed):
    """(torch data, numpy data for the JAX package): values either side of
    every edge and the type's extremes first, then random values over the
    type (floats: N(0, 2) with NaN and infinities)."""
    tdtype, ndtype = NARROW[name]
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if name == "bool":
        x = rng.integers(0, 2, n).astype(np.bool_)
    elif tdtype.is_floating_point:
        x = rng.normal(0.0, 2.0, n).astype(np.float32)
        x[:5] = [np.nan, np.inf, -np.inf, 3.0, -3.0]
        if name == "float16":
            x = x.astype(np.float16)
    else:
        info = np.iinfo(ndtype)
        specials = np.concatenate([np.floor(edges), np.ceil(edges),
                                   np.floor(edges) - 1]).clip(info.min, info.max)
        x = rng.integers(info.min, info.max, n, endpoint=True)
        k = min(n // 2, specials.size)
        x[:k] = specials[:k]
        x = rng.permutation(x).astype(ndtype)
    x = x.reshape(shape)
    if name == "bfloat16":
        return torch.from_numpy(x).to(torch.bfloat16), x.astype(jnp.bfloat16)
    return torch.from_numpy(x), x


def _weights(wdtype, shape, seed):
    rng = np.random.default_rng(seed)
    if wdtype is np.float32:
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)
    if wdtype is np.int32:
        return rng.integers(-(2**30), 2**30, shape, dtype=np.int32)
    return rng.integers(-(2**40), 2**40, shape, dtype=np.int64)


def _case(name, route, seed=0):
    shape, n_inputs, nb, axis = ROUTES[route]
    bins = [_edges(name, nb + 3 * k, seed=k) for k in range(n_inputs)]
    if route == "factored_packed":  # over 8192 slots: 100 x 90
        bins[1] = _edges(name, 90, seed=1)
    pairs = [_data(name, shape, e, seed + 7 * k) for k, e in enumerate(bins)]
    return [t for t, _ in pairs], [x for _, x in pairs], bins, axis


def _spy(monkeypatch):
    """Records the route each package's dispatch runs."""
    ran = {"jax": [], "port": []}
    run_joint2 = pallas_hist._run_joint2
    run_factored, run_direct = pallas_hist._run_factored, pallas_hist._run_direct

    def jax_joint2(*args, **kwargs):
        ran["jax"].append("joint2")
        return run_joint2(*args, **kwargs)

    def jax_factored(*args, per_row=False, packed=False, **kwargs):
        ran["jax"].append(_JAX_ROUTE[(per_row, packed)])
        return run_factored(*args, per_row=per_row, packed=packed, **kwargs)

    def jax_direct(*args, **kwargs):
        ran["jax"].append("direct")
        return run_direct(*args, **kwargs)

    def port(route, fn):
        def spy(*args, **kwargs):
            ran["port"].append(route)
            return fn(*args, **kwargs)
        return spy

    monkeypatch.setattr(pallas_hist, "_run_joint2", jax_joint2)
    monkeypatch.setattr(pallas_hist, "_run_factored", jax_factored)
    monkeypatch.setattr(pallas_hist, "_run_direct", jax_direct)
    monkeypatch.setattr(core, "joint2", port("joint2", cuda_hist.joint2))
    monkeypatch.setattr(core, "factored", port("factored", cuda_hist.factored))
    monkeypatch.setattr(core, "direct", port("direct", cuda_hist.direct))
    jax.clear_caches()  # a cached trace would skip the JAX dispatch
    return ran


def _assert_close(got, want, float_sums, err_msg):
    if float_sums:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=err_msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=err_msg)


def _weight_plan():
    """(name, route, weight dtype) cases: every route with counts for each
    dtype, and with each weight class over the dtypes in turn."""
    cases = []
    for i, name in enumerate(NARROW):
        for j, route in enumerate(ROUTES):
            cases.append((name, route, None))
            cases.append((name, route, WEIGHT_DTYPES[(i + j) % 3]))
    return cases


@pytest.mark.parametrize("name,route,wdtype", _weight_plan(),
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_narrow_routes_match_the_jax_kernels(monkeypatch, name, route, wdtype):
    args, args_jax, bins, axis = _case(name, route, seed=len(name) + len(route))
    shape = ROUTES[route][0]
    w = None if wdtype is None else _weights(wdtype, shape, seed=3)
    float_sums = wdtype is np.float32
    kwargs = {} if w is None else {"precision": "highest"}
    nbins = tuple(len(e) - 1 for e in bins)
    m = 1 if axis is None else int(np.prod([n for i, n in enumerate(shape)
                                            if i not in axis]))
    c = None if axis is None else int(np.prod(shape)) // m
    assert cuda_hist.plan(len(args), nbins, m, c) == route
    ran = _spy(monkeypatch)
    jh, _ = xhistogram_tpu.histogram(*args_jax, bins=bins, axis=axis, weights=w,
                                     method="pallas", **kwargs)
    jh = np.asarray(jh)
    # int64 weights: one pass of the kernel per weight digit
    assert ran["jax"] and set(ran["jax"]) == {route}
    for method in ("cuda", "auto"):
        h, _ = xhistogram_torch.histogram(
            *args, bins=bins, axis=axis, method=method,
            weights=None if w is None else torch.from_numpy(w))
        if w is None:
            assert h.dtype == torch.int64
        _assert_close(h.numpy(), jh, float_sums, f"{method} against the JAX kernel")
    # the cuda call ran the route's wrapper, auto the scatter strategy
    assert ran["port"] == [route.split("_")[0]]

    # each plain version, on the operands the public call hands the kernel
    axis_t = normalize_axis(axis, len(shape))
    layouts = [canonicalize_2d(a, axis_t) for a in args]
    w2d = None if w is None else canonicalize_2d(torch.from_numpy(w), axis_t)
    thr = [torch.from_numpy(compare_form(e, core._compare_dtype(a)).edges)
           for e, a in zip(bins, args)]
    if route == "joint2":
        plain = cuda_hist.joint2_reference(*layouts, *thr, *nbins, weights=w2d)
    elif route == "direct":
        plain = cuda_hist.direct_reference(layouts, thr, nbins, weights=w2d)
    else:
        plain = cuda_hist.factored_reference(layouts, thr, nbins, route == "factored",
                                             weights=w2d)
    _assert_close(plain[:, :-1].numpy().reshape(jh.shape), jh, float_sums,
                  "plain version against the JAX kernel")


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("partner", ["float32", "int32", "bfloat16"])
def test_narrow_beside_another_dtype_matches_jax(monkeypatch, route, partner):
    """int16 data beside float32 (factored and direct: their narrow entry),
    int32 (their mixed entry) or bfloat16 data, on each route: the public
    call and the JAX package agree bit for bit, the JAX kernel ran."""
    shape, n_inputs, nb, axis = ROUTES[route]
    rng = np.random.default_rng(len(route) + len(partner))
    x = rng.integers(-32768, 32767, shape, endpoint=True).astype(np.int16)
    e_x = _edges("int16", nb)
    if partner == "float32":
        y = rng.normal(0.0, 2.0, shape).astype(np.float32)
        y.flat[:3] = [np.nan, np.inf, -np.inf]
        e_y = np.linspace(-3.0, 3.0, nb + 4)
    elif partner == "int32":
        y = rng.integers(-4000, 4000, shape).astype(np.int32)
        e_y = np.linspace(-3000.5, 3000.5, nb + 4)
    else:
        y = rng.normal(0.0, 2.0, shape).astype(jnp.bfloat16)
        e_y = np.linspace(-3.0, 3.0, nb + 4)
    args_jax, bins = [x, y], [e_x, e_y]
    if n_inputs == 3:
        args_jax.append(rng.integers(-128, 128, shape).astype(np.int8))
        bins.append(_edges("int8", nb))
    if route == "factored_packed":
        bins[1] = np.linspace(-3000.5, 3000.5, 91) if partner == "int32" else \
            np.linspace(-3.0, 3.0, 91)
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
            if a.dtype == jnp.bfloat16 else torch.from_numpy(a) for a in args_jax]
    ran = _spy(monkeypatch)
    jh, _ = xhistogram_tpu.histogram(*args_jax, bins=bins, axis=axis, method="pallas")
    assert ran["jax"] == [route]
    h, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, method="cuda")
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert ran["port"] == [route.split("_")[0]]


# --- the host's choice of entry and load types ---------------------------------

ALL = (*(t for t, _ in NARROW.values()), *WIDE)


@pytest.mark.parametrize("kernel", ["joint2", "slot"])
def test_operand_plan_reads_narrow_data_in_place(kernel):
    """For every pair (and a triple) of data dtypes: no input is widened,
    joint2's pairs of two different dtypes with a narrow one included (they
    once widened both to a common compare type); joint2 compares each input
    in its own type, and the thresholds' dtype holds every value of the data
    read."""
    narrow = {t for t, _ in NARROW.values()}
    for dtypes in [*itertools.product(ALL, repeat=2),
                   *((a, b, torch.float32) for a in ALL for b in narrow)]:
        if kernel == "joint2" and len(dtypes) != 2:
            continue
        op = cuda_hist.operand_plan(kernel, dtypes)
        assert len(op.loads) == len(op.compare) == len(dtypes)
        assert op.loads == dtypes, (kernel, dtypes, op)
        if kernel == "joint2" and dtypes[0] in narrow and dtypes[0] == dtypes[1]:
            assert op.entry == cuda_hist._NARROW_SUFFIX[dtypes[0]]
            assert op.codes is None
        if kernel == "joint2" and op.entry != "mixed":
            assert op.compare == tuple(cuda_hist._JOINT2_COMPARE[d] for d in dtypes)
        if kernel == "slot" and set(dtypes) & narrow:
            assert op.entry in ("narrow", "mixed")
            assert op.codes == tuple(cuda_hist._LOAD_CODE[d] for d in dtypes)
            if op.entry == "narrow":
                assert set(op.compare) == {torch.float32}
                assert set(dtypes) <= {torch.float32, *narrow}
            else:
                assert set(dtypes) & {torch.float64, torch.int32, torch.int64}
        for d, load, cmp in zip(dtypes, op.loads, op.compare):
            # every value of the type read converts exactly to the compare type
            if load in narrow or load == torch.float32:
                assert cmp in (torch.float32, torch.float64, torch.int32, torch.int64)
            if load in (torch.int64,):
                assert cmp == torch.int64
            if cmp == torch.int32:
                assert load in (torch.bool, torch.int8, torch.uint8, torch.int32)


def test_operand_plan_keeps_the_wide_entries():
    """Wide inputs keep their entries: one type read as itself, int32 beside
    int32 in int32 (not float64), int64 beside a float in joint2's own pair
    entries and the template's mixed entry. Wide pairs of two dtypes are
    read in place now (they once widened a float64 copy of both): joint2's
    pair entries compare each in its own type, the template's mixed entry
    int32 and float32 in float64 and int64 in int64."""
    f32, f64, i32, i64 = WIDE
    for d in WIDE:
        for kernel in ("joint2", "slot"):
            op = cuda_hist.operand_plan(kernel, (d, d))
            assert op.entry == {f32: "f32", f64: "f64", i32: "i32", i64: "i64"}[d]
            assert op.loads == op.compare == (d, d) and op.codes is None
    op = cuda_hist.operand_plan("slot", (i32, f32))
    assert op.entry == "mixed" and op.loads == (i32, f32) and op.compare == (f64, f64)
    op = cuda_hist.operand_plan("joint2", (i32, f32))
    assert op.entry == "i32_f32" and op.loads == op.compare == (i32, f32)
    assert cuda_hist.operand_plan("joint2", (f64, f32)).entry == "f64_f32"
    assert cuda_hist.operand_plan("joint2", (i64, i32)).entry == "i64_i32"
    assert cuda_hist.operand_plan("joint2", (i64, f32)).entry == "i64_f32"
    op = cuda_hist.operand_plan("slot", (i64, f32))
    assert op.entry == "mixed" and op.loads == (i64, f32) and op.codes == (3, 0)
    assert op.compare == (i64, f64)


@pytest.mark.parametrize("name", list(NARROW))
def test_wrappers_hand_the_kernels_narrow_data(name, monkeypatch):
    """On a CUDA tensor the wrappers would launch with the narrow data as it
    is: the operands ``_slot_operands`` gives factored and direct, and the
    thresholds in the plan's compare dtype, checked here on CPU tensors."""
    tdtype = NARROW[name][0]
    x, _ = _data(name, (4, 64), _edges(name, 8), seed=1)
    y, _ = _data(name, (4, 64), _edges(name, 8), seed=2)
    thr = [torch.from_numpy(compare_form(_edges(name, 8), core._compare_dtype(v)).edges)
           for v in (x, y)]
    op, arrays, t = cuda_hist._slot_operands("factored", [x, y], thr)
    assert op.entry == "narrow" and op.loads == (tdtype, tdtype)
    assert arrays[0] is x and arrays[1] is y
    assert all(v.dtype == torch.float32 for v in t)
    # float32 thresholds keep every comparison: exact up to 2^24, and past
    # every 8- and 16-bit value beyond
    for a, b in zip(thr, t):
        a64, b64 = a.to(torch.float64), b.to(torch.float64)
        exact = a64.abs() <= 2**24
        assert torch.equal(a64[exact], b64[exact])
        assert (b64[~exact].abs() > 2**16).all()
    f = torch.zeros(4, 64, dtype=torch.float64)
    op, arrays, t = cuda_hist._slot_operands(
        "direct", [x, f], [thr[0], torch.tensor([-1.0, 1.0], dtype=torch.float64)])
    assert op.entry == "mixed" and arrays[0] is x and arrays[1] is f
    assert t[0].dtype == torch.float64
