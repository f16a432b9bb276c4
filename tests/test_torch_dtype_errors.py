"""Object, string and bytes arrays raise one early TypeError in the port.

The JAX package raises a TypeError for such data and weights too, but from
deep inside numpy or JAX (``ufunc 'nextafter' not supported``, ``ufunc
'minimum' did not contain a loop``, ``Dtype object is not a valid JAX array
type``). The port raises before any work, with a message that names the
dtype (``bins.non_numeric_message``), for data and weights in
``core._coerce_host`` / ``_coerce_weights`` and for explicit edges in
``bins.validate_edges``. Each case checks that the JAX package raises an
exception of the same type on the same call. String edges that decrease in
numpy's order of their characters raise its ValueError, as there.
"""

import functools

import numpy as np
import pytest

import xhistogram_tpu
import xhistogram_torch
from xhistogram_torch import labeled
from xhistogram_torch.bins import non_numeric_message

histogram_cpu = functools.partial(xhistogram_torch.histogram, device="cpu")

_X = np.random.default_rng(0).standard_normal((3, 40)).astype(np.float32)
_EDGES = np.linspace(-3.0, 3.0, 6)
# edges that increase in numpy's order of their characters too
_STR_EDGES = np.array(["0.5", "1.5", "2.5"])
_KINDS = {"object": object, "str": str, "bytes": bytes}


def _call(module, kwargs, **call):
    fn = histogram_cpu if module is xhistogram_torch else module.histogram
    return fn(*call.pop("args"), **call, **kwargs)


# (what is non-numeric, the call's arguments by the dtype it is cast to)
CASES = {
    "data-int-bins": lambda k: dict(args=(_X.astype(k),), bins=5),
    "data-edges": lambda k: dict(args=(_X.astype(k),), bins=[_EDGES]),
    "data-second-input": lambda k: dict(args=(_X, _X.astype(k)), bins=[_EDGES, _EDGES]),
    "weights": lambda k: dict(args=(_X,), bins=5, weights=_X.astype(k)),
}


@pytest.mark.parametrize("kind", list(_KINDS))
@pytest.mark.parametrize("case", list(CASES))
def test_non_numeric_arrays_raise_a_type_error_naming_the_dtype(case, kind):
    call = CASES[case](_KINDS[kind])
    with pytest.raises(Exception) as jax_error:
        _call(xhistogram_tpu, {}, **dict(call))
    with pytest.raises(TypeError) as port_error:
        _call(xhistogram_torch, {}, **dict(call))
    # the JAX package's is a TypeError or numpy's UFuncTypeError, one
    assert isinstance(jax_error.value, TypeError)
    assert type(port_error.value) is TypeError
    what = "weights" if case == "weights" else "data"
    dtype = (call["weights"] if what == "weights" else call["args"][-1]).dtype
    assert str(port_error.value) == non_numeric_message(what, dtype)
    assert str(dtype) in str(port_error.value)


@pytest.mark.parametrize("kind", ["str", "bytes"])
def test_string_edges_raise_a_type_error_naming_the_dtype(kind):
    edges = _STR_EDGES.astype(_KINDS[kind])
    with pytest.raises(TypeError):
        xhistogram_tpu.histogram(_X, bins=[edges])
    with pytest.raises(TypeError, match=str(edges.dtype)) as err:
        histogram_cpu(_X, bins=[edges])
    assert str(err.value) == non_numeric_message("bin edges", edges.dtype)


def test_object_edges_of_strings_raise_a_type_error_naming_the_dtype():
    edges = _STR_EDGES.astype(object)
    with pytest.raises(TypeError):
        xhistogram_tpu.histogram(_X, bins=[edges])
    with pytest.raises(TypeError, match="object"):
        histogram_cpu(_X, bins=[edges])


def test_decreasing_string_edges_raise_the_jax_value_error():
    edges = _EDGES.astype(str)  # "-0.6" sorts after "-1.8" and before "0.6"
    with pytest.raises(ValueError, match="monotonically"):
        xhistogram_tpu.histogram(_X, bins=[edges])
    with pytest.raises(ValueError, match="monotonically"):
        histogram_cpu(_X, bins=[edges])


def test_labeled_and_streaming_raise_the_same_error():
    with pytest.raises(TypeError, match="object"):
        labeled.NamedArray(_X.astype(object), ("y", "x"))
    acc = xhistogram_torch.StreamingHistogram(bins=[_EDGES], device="cpu")
    with pytest.raises(TypeError, match="<U"):
        acc.update(_X.astype(str))
