"""The port's public ``histogram`` end to end, against the JAX package.

Kept rows, density, dtypes, device placement and the error contract, on the
CPU path.
"""

import functools

import numpy as np
import pytest
import torch

import xhistogram_tpu
import xhistogram_torch
from xhistogram_torch.ops import cuda_hist

# numpy inputs run on the card unless the caller names another device
histogram_cpu = functools.partial(xhistogram_torch.histogram, device="cpu")


def _both(*args, **kwargs):
    """(port result as numpy, JAX result as numpy) for the same call."""
    h, edges = histogram_cpu(*args, **kwargs)
    jh, jedges = xhistogram_tpu.histogram(*args, **kwargs)
    for e, je in zip(edges, jedges):
        np.testing.assert_array_equal(e, je)
    return h, np.asarray(jh)


def _data(shape, n_inputs, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_inputs):
        x = rng.normal(i, 1.0 + i, shape).astype(np.float32)
        x.flat[:: 17] = np.nan
        out.append(x)
    return out


KEPT = [
    ((4, 6, 50), 2),
    ((4, 6, 50), (1, 2)),
    ((4, 6, 50), 0),
    ((4, 6, 50), (0, 2)),
    ((4, 6, 50), -1),
    ((1, 300), 1),
    ((4, 6, 50), None),
]


@pytest.mark.parametrize("n_inputs", [1, 2, 3])
@pytest.mark.parametrize("shape,axis", KEPT, ids=str)
def test_kept_rows_bit_equal(shape, axis, n_inputs):
    args = _data(shape, n_inputs, seed=len(shape) + n_inputs)
    bins = [np.linspace(-3 + i, 3 + i, 7 + 4 * i) for i in range(n_inputs)]
    h, jh = _both(*args, bins=bins, axis=axis)
    assert h.dtype == torch.int64
    assert tuple(h.shape) == jh.shape
    np.testing.assert_array_equal(h.numpy(), jh)


def test_broadcast_inputs_bit_equal():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 40)).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    bins = [np.linspace(-2, 2, 9), np.linspace(-2, 2, 5)]
    for axis in (None, 1):
        h, jh = _both(a, b, bins=bins, axis=axis)
        np.testing.assert_array_equal(h.numpy(), jh)


@pytest.mark.parametrize("shape,axis", KEPT[:4], ids=str)
def test_density_matches(shape, axis):
    args = _data(shape, 2, seed=9)
    bins = [np.linspace(-3, 3, 7), np.array([-2.0, -1.0, 0.5, 1.0, 4.0])]
    h, jh = _both(*args, bins=bins, axis=axis, density=True)
    assert h.dtype == torch.float32
    # both divide float32 counts by float32 areas, then by the row totals,
    # in the same order
    np.testing.assert_allclose(h.numpy(), jh, rtol=1e-6, atol=0)


@pytest.mark.parametrize(
    "data,edges",
    [
        (np.random.default_rng(0).normal(size=500), np.linspace(-2.0, 2.0, 11)),
        (np.array([0.1, 0.30000000000000004, 0.3, 0.2]),
         np.array([0.0, 0.1, 0.30000000000000004])),
        (np.arange(-20, 20, dtype=np.int32), np.array([-3.5, 0.5, 2.0, 7.25])),
        (np.arange(-20, 20, dtype=np.int64) * (2**40), np.array([-2.0**44, 0.0, 2.0**44])),
        (np.arange(-5, 5, dtype=np.int8), np.array([-3, 0, 4], dtype=np.int8)),
        (np.arange(0, 300, dtype=np.uint16), np.array([0, 100, 299])),
        (np.arange(0, 300, dtype=np.uint32), np.array([0, 100, 299])),
        (np.array([True, False, True]), np.array([0, 1])),
        (np.arange("2020-01-01", "2020-03-01", dtype="datetime64[D]"),
         np.array(["2020-01-01", "2020-02-01", "2020-03-01"], dtype="datetime64[D]")),
        (np.array([0.5, 1.5, np.inf]), np.array([0.0, 1.0, np.inf])),
        (np.array([0.5, 1.5, np.inf, -np.inf], np.float32), np.array([-np.inf, 0.0, 1.0])),
        (np.float64(0.5), np.array([0.0, 1.0, 2.0])),
    ],
    ids=["f64", "f64-last", "i32-frac", "i64-wide", "i8", "u16", "u32", "bool",
         "datetime", "inf-last", "inf-first", "0d"],
)
def test_dtypes_bit_equal(data, edges):
    h, jh = _both(data, bins=[edges])
    np.testing.assert_array_equal(h.numpy(), jh)


def test_int_and_str_bins_bit_equal():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(2, 300))
    for bins, range_ in ((10, None), ([5, "auto"], None), (4, (-1, 1))):
        h, jh = _both(a, b, bins=bins, range=range_)
        np.testing.assert_array_equal(h.numpy(), jh)


@pytest.mark.parametrize(
    "dtype",
    [torch.bfloat16, torch.float16, torch.int8, torch.uint8, torch.int16,
     torch.uint16, torch.uint32, torch.bool],
    ids=str,
)
def test_torch_dtypes_bit_equal(dtype):
    """Torch-only inputs: narrow ints are promoted, bfloat16 widens exactly;
    JAX gets the same values as numpy (bfloat16 through jax.numpy)."""
    import jax.numpy as jnp

    x = torch.arange(-40, 60).to(dtype)
    edges = np.array([-3.5, 0.0, 1.0, 7.25, 50.0])
    h, _ = xhistogram_torch.histogram(x, bins=[edges])
    if dtype == torch.bfloat16:
        ref = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    else:
        ref = x.numpy()
    jh, _ = xhistogram_tpu.histogram(ref, bins=[edges])
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


def test_inputs_on_two_devices_raise():
    with pytest.raises(ValueError, match="one device"):
        xhistogram_torch.histogram(
            torch.ones(3), torch.ones(3, device="meta"), bins=[E, E]
        )


def test_tensor_inputs_stay_on_their_device():
    t = torch.linspace(-1, 1, 50)
    h, _ = xhistogram_torch.histogram(t, t, bins=[np.linspace(-1, 1, 5)] * 2)
    assert h.device == t.device and h.dtype == torch.int64
    assert int(h.sum()) == 50


def _raised(fn):
    try:
        fn()
    except Exception as ex:  # noqa: BLE001 — the type and message are compared
        return type(ex), str(ex)
    return None


E = np.array([0.0, 1.0, 2.0])
MISUSE = {
    "bins_len": lambda h: h(np.array([0.5]), np.array([0.5]), bins=[E]),
    "no_bins": lambda h: h(np.array([0.5]), bins=None),
    "no_args": lambda h: h(bins=[E]),
    "bad_method": lambda h: h(np.array([0.5]), bins=[E], method="bogus"),
    "axis_oob": lambda h: h(np.ones((2, 3)), bins=[E], axis=5),
    "axis_rep": lambda h: h(np.ones((2, 3)), bins=[E], axis=(1, 1)),
    "range_len": lambda h: h(np.array([0.5]), bins=[4], range=[(0, 1), (0, 1)]),
    "range_pair": lambda h: h(np.array([0.5]), np.array([0.5]), bins=[4, 4],
                              range=[(0, 1), (0,)]),
    "single_edge": lambda h: h(np.array([0.5]), bins=[np.array([1.0])]),
    "descending": lambda h: h(np.array([0.5]), bins=[np.array([2.0, 1.0])]),
    "nan_edge": lambda h: h(np.array([0.5]), bins=[np.array([0.0, np.nan, 2.0])]),
    "complex": lambda h: h(np.array([0.5 + 1j]), bins=[E]),
    "complex_edges": lambda h: h(np.array([0.5]), bins=[np.array([0j, 1j])]),
    "2d_edges": lambda h: h(np.array([0.5]), bins=[np.ones((2, 2))]),
    "neg_int_bins": lambda h: h(np.array([0.5]), bins=[-3]),
    "bad_estimator": lambda h: h(np.array([0.5]), bins=["bogus"]),
    "broadcast": lambda h: h(np.ones(3), np.ones(4), bins=[E, E]),
}


@pytest.mark.parametrize("probe", list(MISUSE), ids=list(MISUSE))
def test_error_contract_matches_jax(probe):
    got = _raised(lambda: MISUSE[probe](histogram_cpu))
    want = _raised(lambda: MISUSE[probe](xhistogram_tpu.histogram))
    assert want is not None
    assert got == want


def test_complex_tensor_raises_like_jax():
    got = _raised(lambda: xhistogram_torch.histogram(
        torch.ones(3, dtype=torch.complex64), bins=[E]))
    want = _raised(lambda: xhistogram_tpu.histogram(
        np.ones(3, np.complex64), bins=[E]))
    assert got == want


def test_top_edge_clip_raises_on_the_kernel_route():
    a = np.array([0.5, 1.0], np.float32)
    bins = [np.array([0.0, np.inf]), E]
    got = _raised(lambda: histogram_cpu(a, a, bins=bins, method="cuda"))
    want = _raised(lambda: xhistogram_tpu.histogram(a, a, bins=bins, method="pallas"))
    assert got[0] is want[0] is NotImplementedError
    assert got[1].split(";")[0] == want[1].split(";")[0].replace("'pallas'", "'cuda'")
    h, jh = _both(a, a, bins=bins)  # auto takes the scatter strategy, as in JAX
    np.testing.assert_array_equal(h.numpy(), jh)


def test_uint64_not_ported():
    with pytest.raises(NotImplementedError, match="uint64"):
        histogram_cpu(np.arange(4, dtype=np.uint64), bins=[E])


def test_numpy_inputs_need_a_card_or_device_cpu(monkeypatch):
    # numpy inputs run on the card by default; without one the call names
    # the way to the CPU instead of quietly running there
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.linspace(0, 2, 10)
    for call in (
        lambda: xhistogram_torch.histogram(x, bins=[E]),
        lambda: xhistogram_torch.histogram(x, bins=[E], device="cuda"),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    h, _ = xhistogram_torch.histogram(x, bins=[E], device="cpu")
    assert h.device.type == "cpu" and h.tolist() == [5, 5]
    # a tensor runs where it lies, with or without a matching device=
    t = torch.from_numpy(x)
    for kwargs in ({}, {"device": "cpu"}, {"device": torch.device("cpu")}):
        h, _ = xhistogram_torch.histogram(t, bins=[E], **kwargs)
        assert h.device.type == "cpu" and h.tolist() == [5, 5]
    # numpy inputs beside a tensor follow the tensor's device
    h, _ = xhistogram_torch.histogram(x, t, bins=[E, E])
    assert h.device.type == "cpu" and int(h.sum()) == 10


def test_conflicting_device_raises():
    t = torch.linspace(0, 2, 10)
    with pytest.raises(ValueError, match="conflicts with an input tensor"):
        xhistogram_torch.histogram(t, bins=[E], device="meta")
    with pytest.raises(ValueError, match="conflicts with an input tensor"):
        xhistogram_torch.histogram(np.ones(3), t, bins=[E, E], device="meta")


@pytest.mark.parametrize(
    "args,kwargs,kernel",
    [
        ((np.ones(64, np.float32),), {}, "one_input"),
        ((np.ones((4, 300), np.float32),) * 2, {"axis": 1}, "factored_per_row"),
        ((np.ones((4, 30), np.float32),) * 2, {"axis": 1}, "direct"),
        ((np.ones(64, np.float32),) * 3, {}, "factored"),
    ],
    ids=["one_input", "per_row", "direct", "factored"],
)
def test_unported_kernels_raise_on_the_kernel_route(args, kwargs, kernel):
    """Every kernel plan() names is ported: the kernel route runs its
    wrapper, with the counts of the JAX kernel (no kernel raises any more)."""
    bins = [np.linspace(0, 2, 9)] * len(args)
    m = 1 if not kwargs else args[0].shape[0]
    c = None if not kwargs else args[0].shape[1]
    assert cuda_hist.plan(len(args), (8,) * len(args), m, c) == kernel
    got, _ = histogram_cpu(*args, bins=bins, method="cuda", **kwargs)
    jax_kernel, _ = xhistogram_tpu.histogram(*args, bins=bins, method="pallas", **kwargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_kernel))
    # on the CPU, auto runs the plain path for the same call
    h, jh = _both(*args, bins=bins, **kwargs)
    np.testing.assert_array_equal(h.numpy(), jh)


def test_joint2_other_dtypes_raise_on_the_kernel_route():
    """float64, int32, int64 and float16 data take the joint2 route (the
    wrapper widens float16), bit-equal to the JAX kernel; no raise is left."""
    rng = np.random.default_rng(11)
    a = rng.normal(0.5, 0.5, 64)
    e = np.linspace(-0.5, 1.5, 9)
    for x in (a, a.astype(np.float16), (a * 8).astype(np.int32),
              (a * 8).astype(np.int64) << 33):
        bins = [e * (2**33 if x.dtype == np.int64 else 8 if x.dtype.kind == "i" else 1)] * 2
        got, _ = histogram_cpu(x, x[::-1].copy(), bins=bins, method="cuda")
        jax_kernel, _ = xhistogram_tpu.histogram(
            x, x[::-1].copy(), bins=bins, method="pallas"
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_kernel))


def test_profiler_ranges_carry_the_stage_names():
    a = torch.linspace(0, 2, 100)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        xhistogram_torch.histogram(a, a, bins=[E, E])
        xhistogram_torch.histogram(a, a, bins=[E, E], method="cuda")
    names = {evt.key for evt in prof.key_averages()}
    for stage in ("canonicalize", "digitize", "bincount", "cuda_kernel"):
        assert f"xhistogram.{stage}" in names
