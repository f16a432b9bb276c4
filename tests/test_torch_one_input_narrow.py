"""one_input on narrow data (bool, 8- and 16-bit integers, float16,
bfloat16) against the JAX package.

The port keeps narrow data narrow up to the one_input kernel, which reads it
at its own width and compares it in its compare type (int32 for the
integers, float32 for the floats) against ``bins.compare_form``'s
thresholds of that type. The JAX package's kernel reads bfloat16 and the 8-
and 16-bit integers narrow too and widens each tile in registers
(``pallas_hist._widen``); only float16 is cast first, on the device. On
the CPU the wrapper runs ``one_input_reference``, the plain version the
kernel is held to on the card (tests/test_torch_gpu.py). Here the public
``histogram`` (``method="auto"`` and ``method="cuda"``, the kernel's
wrapper) and the plain version must give the JAX package's
``_one_input_kernel`` counts under the Pallas interpreter bit for bit, and
its weighted sums within its 'highest' bound (integer sums bit for bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xhistogram_tpu
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
LAYOUTS = {
    "full": ((12, 40), None),
    "rows": ((12, 40), (1,)),
    "strided-rows": ((10, 3, 8), (0,)),  # config 4's (1, m)-strided view
}


def _case(name, shape, seed):
    """(torch data, numpy data for the JAX package, edges): the type's
    extremes and values either side of every edge, then random values."""
    tdtype, ndtype = NARROW[name]
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if name == "bool":
        x = rng.integers(0, 2, n).astype(np.bool_)
        edges = np.array([0.0, 0.5, 1.0])
    elif np.dtype(ndtype).kind in "iu":
        info = np.iinfo(ndtype)
        edges = np.linspace(float(info.min) - 0.5, float(info.max) + 3.0, 11)
        # fractional edges, and ones at the extremes
        edges[1] = float(info.min)
        edges[-2] = float(info.max)
        specials = np.concatenate([np.floor(edges), np.ceil(edges)]).clip(info.min, info.max)
        x = rng.integers(info.min, info.max, n, endpoint=True)
        x[: specials.size] = specials[:n]
        x = x.astype(ndtype)
    else:
        edges = np.linspace(-3.0, 3.0, 13)
        x = rng.normal(0.0, 2.0, n).astype(np.float32)
        x[:4] = [np.nan, np.inf, -np.inf, 3.0]
        if name == "float16":
            x = x.astype(np.float16)
    x = x.reshape(shape)
    if name == "bfloat16":
        return torch.from_numpy(x).to(torch.bfloat16), x.astype(jnp.bfloat16), edges
    return torch.from_numpy(x), x, edges


def _weights(name, shape, seed):
    """float32 weights for the float data, int32 for the integers (the
    accumulator classes float64 and uint32)."""
    rng = np.random.default_rng(seed)
    if NARROW[name][0].is_floating_point:
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return rng.integers(-(2**30), 2**30, shape, dtype=np.int32)


@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "weighted"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(NARROW))
def test_narrow_data_bit_equal_to_jax(name, layout, weighted):
    shape, axis = LAYOUTS[layout]
    x, x_jax, edges = _case(name, shape, seed=len(name) + len(layout))
    w = _weights(name, shape, seed=3) if weighted else None
    kwargs = {} if w is None else {"precision": "highest"}
    jh, _ = xhistogram_tpu.histogram(x_jax, bins=[edges], axis=axis, weights=w,
                                     method="pallas", **kwargs)
    jh = np.asarray(jh)
    for method in ("auto", "cuda"):
        h, _ = xhistogram_torch.histogram(
            x, bins=[edges], axis=axis, method=method,
            weights=None if w is None else torch.from_numpy(w))
        if w is None or not np.issubdtype(w.dtype, np.floating):
            assert h.dtype == (torch.int64 if w is None else torch.int32)
            np.testing.assert_array_equal(h.numpy(), jh, err_msg=method)
        else:
            np.testing.assert_allclose(h.numpy(), jh, rtol=3e-7, atol=1e-6,
                                       err_msg=method)


@pytest.mark.parametrize("name", list(NARROW))
def test_one_input_takes_narrow_data_unwidened(name, monkeypatch):
    """The public call hands one_input the data in its own dtype, with
    thresholds in its compare dtype; the wrapper's plain version widens a
    copy and equals the plain version on data widened first."""
    x, _, edges = _case(name, (8, 64), seed=5)
    seen = []
    real = cuda_hist.one_input

    def spy(a2d, thr, nb, reduce_all, weights=None, **kwargs):
        seen.append((a2d.dtype, thr.dtype))
        return real(a2d, thr, nb, reduce_all, weights=weights, **kwargs)

    monkeypatch.setattr(core, "one_input", spy)
    for axis in (None, (1,)):
        xhistogram_torch.histogram(x, bins=[edges], axis=axis, method="cuda")
    wide = {torch.float16: torch.float16, torch.bfloat16: torch.float32}.get(
        x.dtype, torch.int32)
    assert seen == [(x.dtype, wide)] * 2
    thr = torch.from_numpy(compare_form(edges, core._compare_dtype(x)).edges)
    assert thr.dtype == wide
    for axis in (None, (1,)):
        a2d = canonicalize_2d(x, normalize_axis(axis, x.ndim))
        reduce_all = axis is None
        got = cuda_hist.one_input(a2d, thr, len(edges) - 1, reduce_all)
        widened = a2d.to(torch.float32 if x.dtype.is_floating_point else torch.int32)
        want = cuda_hist.one_input_reference(widened, thr.to(widened.dtype),
                                             len(edges) - 1, reduce_all)
        assert torch.equal(got, want)
