"""int64 data beside float data, against the JAX package.

No compare type holds int64 and a float exactly, so the kernels compare
each input in its own type (joint2's mixed pairs, the flat-slot template's
mixed entries; csrc/joint2_mixed.cu, csrc/slot_mixed.cu). On the CPU the
wrappers run their plain versions; here every route plan() names for such
a call (joint2 in both input orders, factored full, per row and packed,
direct), forced onto the wrappers with ``method="cuda"`` and through
``method="auto"``, gives the JAX package's counts bit for bit, and its
weighted sums within its 'highest' bound (integer sums bit for bit). The
card runs the same calls against the plain versions
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import functools

import numpy as np
import pytest
import torch

import xhistogram_tpu
import xhistogram_torch
from xhistogram_torch.ops import cuda_hist

histogram_cpu = functools.partial(xhistogram_torch.histogram, device="cpu")

# (shape, axis, bins of the two inputs, the route plan() names)
ROUTES = {
    "joint2": ((4, 500), None, (8, 9), "joint2"),
    "factored": ((4, 500), None, (1000, 600), "factored"),
    "per_row": ((4, 300), (1,), (150, 90), "factored_per_row"),
    "packed": ((16, 64), (1,), (120, 90), "factored_packed"),
    "direct": ((16, 64), (1,), (40, 40), "direct"),
}


def _pair(shape, float_dtype, seed):
    """An int64 input past float32's and int32's exact range, with edges
    between its values, and a float input with NaN and infinities."""
    rng = np.random.default_rng(seed)
    big = rng.integers(-(2**45), 2**45, shape)
    big.flat[:3] = [2**45 - 1, -(2**45), 0]
    f = rng.normal(0.0, 1.5, shape).astype(float_dtype)
    f.flat[:3] = [np.nan, np.inf, -np.inf]
    return big, f


# every route, float type, input order and weight class
CASES = [
    (route, float_dtype, order, weights)
    for route in ROUTES
    for float_dtype in (np.float32, np.float64, np.float16)
    for order in ("int64-first", "float-first")
    for weights in (None, "float32", "int32")
]


@pytest.mark.parametrize(
    "route,float_dtype,order,weights", CASES,
    ids=[f"{r}-{np.dtype(d).name}-{o}-{w}" for r, d, o, w in CASES])
def test_int64_beside_a_float_bit_equal(route, float_dtype, order, weights):
    shape, axis, (nb_int, nb_float), kernel = ROUTES[route]
    big, f = _pair(shape, float_dtype, seed=nb_int + nb_float)
    e_int = np.linspace(-(2.0**45), 2.0**45, nb_int + 1) + 0.5
    e_float = np.linspace(-3.0, 3.0, nb_float + 1)
    args, bins = [big, f], [e_int, e_float]
    if order == "float-first":
        args, bins = args[::-1], bins[::-1]
    m = 1 if axis is None else shape[0]
    c = None if axis is None else shape[1]
    assert cuda_hist.plan(2, tuple(len(e) - 1 for e in bins), m, c) == kernel
    rng = np.random.default_rng(7)
    w = {None: None,
         "float32": rng.uniform(0, 1, shape).astype(np.float32),
         "int32": rng.integers(-(2**30), 2**30, shape, dtype=np.int32)}[weights]
    kwargs = {} if w is None else {"weights": w}
    jh, _ = xhistogram_tpu.histogram(*args, bins=bins, axis=axis,
                                     precision="highest" if w is not None else None,
                                     **kwargs)
    jh = np.asarray(jh)
    for method in ("auto", "cuda"):
        h, _ = histogram_cpu(*args, bins=bins, axis=axis, method=method, **kwargs)
        if weights == "float32":
            np.testing.assert_allclose(h.numpy(), jh, rtol=3e-7, atol=1e-6,
                                       err_msg=method)
        else:
            np.testing.assert_array_equal(h.numpy(), jh, err_msg=method)


def test_int64_beside_its_float32_source_on_the_cpu():
    x = torch.linspace(0, 2, 1000)
    e = np.array([0.0, 1.0, 2.0])
    for method in ("auto", "cuda"):
        h, _ = xhistogram_torch.histogram(x.long(), x, bins=[e, e], method=method)
        assert h.tolist() == [[500, 0], [0, 500]]
    jh, _ = xhistogram_tpu.histogram(x.long().numpy(), x.numpy(), bins=[e, e])
    assert np.asarray(jh).tolist() == [[500, 0], [0, 500]]
