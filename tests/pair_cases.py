"""Seeded inputs of every data dtype, and the comparison of the port's public
call with the JAX package's kernel on them, for the tests of inputs of two
dtypes (test_torch_pairs.py, test_torch_pairs_routes.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import xhistogram_tpu
from xhistogram_tpu.ops import pallas_hist
import xhistogram_torch
from xhistogram_torch import core
from xhistogram_torch.ops import cuda_hist

# name: (torch dtype, numpy dtype the JAX package takes)
DTYPES = {
    "float32": (torch.float32, np.float32),
    "float64": (torch.float64, np.float64),
    "int32": (torch.int32, np.int32),
    "int64": (torch.int64, np.int64),
    "float16": (torch.float16, np.float16),
    "bfloat16": (torch.bfloat16, jnp.bfloat16),
    "int16": (torch.int16, np.int16),
    "uint16": (torch.uint16, np.uint16),
    "int8": (torch.int8, np.int8),
    "uint8": (torch.uint8, np.uint8),
    "bool": (torch.bool, np.bool_),
}
TORCH = {name: t for name, (t, _) in DTYPES.items()}
# the JAX package's 'highest' bound on float sums
RTOL, ATOL = 3e-7, 1e-6
WEIGHT_DTYPES = (None, np.float32, np.int32, np.int64)

# the pairs with joint2 entries of their own, in both orders
_USERS = [("float16", "float32"), ("bfloat16", "float32"), ("int16", "float32"),
          ("uint16", "float32"), ("int8", "float32"), ("uint8", "float32"),
          ("int32", "float32"), ("float32", "float64"), ("int32", "int64")]
COMPILED_PAIRS = [*_USERS, *((b, a) for a, b in _USERS)]
# a sample of the pairs that take joint2's mixed entry
MIXED_PAIRS = [("bfloat16", "float16"), ("int16", "int64"), ("int8", "float64"),
               ("uint16", "int32"), ("bool", "int64"), ("float16", "int8"),
               ("int32", "float64"), ("uint8", "bfloat16")]
PUBLIC_PAIRS = COMPILED_PAIRS + MIXED_PAIRS


def edges_of(name, nb, seed=0):
    """nb + 1 edges over the dtype's values: evenly spaced over N(0, 2) for
    the floats, over [-0.5, 1.5] for bool, and for the integers over their
    range (int32: +-4000, int64: +-2^40), fractional and on values."""
    if name == "bool":
        return np.linspace(-0.5, 1.5, nb + 1)
    if TORCH[name].is_floating_point:
        return np.linspace(-3.0, 3.0, nb + 1) + 0.01 * seed
    lo, hi = {"int32": (-4000, 4000), "int64": (-(2**40), 2**40)}.get(
        name, (np.iinfo(DTYPES[name][1]).min, np.iinfo(DTYPES[name][1]).max))
    edges = np.linspace(float(lo) - 0.5, float(hi) + 3.0, nb + 1)
    edges[1:-1] = np.round(edges[1:-1]) + (np.arange(1, nb) % 2) * 0.5
    edges[1], edges[-2] = float(lo), float(hi)
    return edges


def data_of(name, shape, edges, seed):
    """(torch data, numpy data for the JAX package): floats N(0, 2) with NaN
    and infinities; integers over the edges' span with values either side
    of every edge first; bool at random."""
    tdtype, ndtype = DTYPES[name]
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if name == "bool":
        x = rng.integers(0, 2, n).astype(np.bool_)
    elif tdtype.is_floating_point:
        x = rng.normal(0.0, 2.0, n)
        x[:5] = [np.nan, np.inf, -np.inf, 3.0, -3.0]
        x = x.astype(np.float32 if name == "bfloat16" else ndtype)
    else:
        lo, hi = int(np.ceil(edges[0])) - 3, int(np.floor(edges[-1])) + 3
        if name not in ("int32", "int64"):
            info = np.iinfo(ndtype)
            lo, hi = int(info.min), int(info.max)
        specials = np.concatenate([np.floor(edges), np.ceil(edges),
                                   np.floor(edges) - 1]).clip(lo, hi)
        x = rng.integers(lo, hi, n, endpoint=True)
        k = min(n // 2, specials.size)
        x[:k] = specials[:k]
        x = rng.permutation(x).astype(ndtype)
    x = x.reshape(shape)
    if name == "bfloat16":
        return torch.from_numpy(x).to(torch.bfloat16), x.astype(jnp.bfloat16)
    return torch.from_numpy(x), x


def weights_of(wdtype, shape, seed):
    rng = np.random.default_rng(seed)
    if wdtype is np.float32:
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)
    if wdtype is np.int32:
        return rng.integers(-(2**30), 2**30, shape, dtype=np.int32)
    return rng.integers(-(2**40), 2**40, shape, dtype=np.int64)


def spy(monkeypatch):
    """Records the route each package's dispatch runs."""
    ran = {"jax": [], "port": []}
    run_joint2 = pallas_hist._run_joint2
    run_factored, run_direct = pallas_hist._run_factored, pallas_hist._run_direct
    jax_route = {(False, False): "factored", (True, False): "factored_per_row",
                 (False, True): "factored_packed"}

    def jax_joint2(*args, **kwargs):
        ran["jax"].append("joint2")
        return run_joint2(*args, **kwargs)

    def jax_factored(*args, per_row=False, packed=False, **kwargs):
        ran["jax"].append(jax_route[(per_row, packed)])
        return run_factored(*args, per_row=per_row, packed=packed, **kwargs)

    def jax_direct(*args, **kwargs):
        ran["jax"].append("direct")
        return run_direct(*args, **kwargs)

    def port(route, fn):
        def record(*args, **kwargs):
            ran["port"].append(route)
            return fn(*args, **kwargs)
        return record

    monkeypatch.setattr(pallas_hist, "_run_joint2", jax_joint2)
    monkeypatch.setattr(pallas_hist, "_run_factored", jax_factored)
    monkeypatch.setattr(pallas_hist, "_run_direct", jax_direct)
    monkeypatch.setattr(core, "joint2", port("joint2", cuda_hist.joint2))
    monkeypatch.setattr(core, "factored", port("factored", cuda_hist.factored))
    monkeypatch.setattr(core, "direct", port("direct", cuda_hist.direct))
    jax.clear_caches()  # a cached trace would skip the JAX dispatch
    return ran


def assert_matches_jax(monkeypatch, pair, route, shape, axis, nbins, wdtype, seed):
    """The public call (``method="cuda"``: the route's wrapper, its plain
    version on the CPU) against the JAX package's kernel under the Pallas
    interpreter, on the same seeded inputs: counts and integer sums bit for
    bit, float sums within the 'highest' bound. Both packages run
    ``route``."""
    bins = [edges_of(name, nb, seed=k) for k, (name, nb) in enumerate(zip(pair, nbins))]
    inputs = [data_of(name, shape, e, seed + 7 * k)
              for k, (name, e) in enumerate(zip(pair, bins))]
    args, args_jax = [t for t, _ in inputs], [x for _, x in inputs]
    w = None if wdtype is None else weights_of(wdtype, shape, seed=seed + 3)
    m = 1 if axis is None else int(np.prod([n for i, n in enumerate(shape) if i not in axis]))
    c = None if axis is None else int(np.prod(shape)) // m
    assert cuda_hist.plan(2, tuple(nbins), m, c) == route
    ran = spy(monkeypatch)
    jh, _ = xhistogram_tpu.histogram(*args_jax, bins=bins, axis=axis, weights=w,
                                     method="pallas",
                                     **({} if w is None else {"precision": "highest"}))
    jh = np.asarray(jh)
    assert ran["jax"] and set(ran["jax"]) == {route}
    h, _ = xhistogram_torch.histogram(*args, bins=bins, axis=axis, method="cuda",
                                      weights=None if w is None else torch.from_numpy(w))
    assert ran["port"] == [route.split("_")[0]]
    if w is None:
        assert h.dtype == torch.int64
    if wdtype is np.float32:
        np.testing.assert_allclose(h.numpy(), jh, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(h.numpy(), jh)


