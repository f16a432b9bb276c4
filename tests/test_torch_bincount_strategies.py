"""The port's bincount strategies (scatter, onehot, sort) on the CPU.

The cases of tests/test_bincount_strategies.py that concern the strategies
(the sort strategy's split rows and the scatter strategy's 2-D indices
were TPU memory and int32-index workarounds; torch sorts any row and
indexes in int64): each strategy against np.bincount and the JAX
package's, and onehot and sort bit-equal to scatter, counts and integer
sums everywhere, float sums where float64 addition is exact; through
``histogram(method=...)`` no kernel runs.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xhistogram_tpu
import xhistogram_torch
from xhistogram_tpu.ops import bincount as jbc
from xhistogram_torch.ops import bincount as bc
from xhistogram_torch.ops import cuda_hist

histogram_cpu = functools.partial(xhistogram_torch.histogram, device="cpu")
STRATEGIES = ["onehot", "sort"]


def _case(m=5, n_slots=37, c=301, seed=4):
    rng = np.random.RandomState(seed)
    g = rng.randint(0, n_slots, (m, c)).astype(np.int64)
    return g, rng


def _weights(rng, shape, kind):
    if kind == "f32":
        return rng.rand(*shape).astype(np.float32)
    if kind == "dyadic":  # multiples of 2**-10: float64 sums exact in any order
        return (rng.randint(0, 1 << 10, shape) / 1024.0).astype(np.float64)
    if kind == "i32":
        return rng.randint(-(2**31), 2**31 - 1, shape).astype(np.int32)
    if kind == "i64":
        return rng.randint(-(2**62), 2**62, shape, dtype=np.int64)
    if kind == "u64":
        return rng.randint(0, 2**63, shape, dtype=np.int64).astype(np.uint64) * np.uint64(2)
    raise ValueError(kind)


@pytest.mark.parametrize("method", STRATEGIES)
@pytest.mark.parametrize("shape", [(5, 301, 37), (1, 5000, 3), (3, 1, 8), (4, 0, 6),
                                   (0, 5, 6)], ids=str)
def test_counts_bit_equal_to_scatter_and_numpy(method, shape):
    m, c, n_slots = shape
    g, _ = _case(m, n_slots, c)
    gt = torch.from_numpy(g)
    got = bc.bincount2d(gt, n_slots, method=method, block_size=7)
    assert got.dtype == torch.int64 and tuple(got.shape) == (m, n_slots)
    assert torch.equal(got, bc.bincount2d_scatter(gt, n_slots))
    exp = np.stack([np.bincount(r, minlength=n_slots) for r in g]) if m else \
        np.zeros((0, n_slots), np.int64)
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("method", STRATEGIES)
@pytest.mark.parametrize("kind", ["dyadic", "f32", "i32", "i64", "u64"])
def test_weighted_bit_equal_to_scatter(method, kind):
    g, rng = _case()
    w = torch.from_numpy(_weights(rng, g.shape, kind))
    got = bc.bincount2d(torch.from_numpy(g), 37, method=method, weights=w)
    want = bc.bincount2d_scatter(torch.from_numpy(g), 37, weights=w)
    assert got.dtype == want.dtype == bc.weighted_dtype(w.dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("method", STRATEGIES)
def test_float64_weights_close_to_scatter(method):
    """float64 sums added in another order: within float64 rounding."""
    g, rng = _case(seed=9)
    w = torch.from_numpy(rng.randn(*g.shape))
    got = bc.bincount2d(torch.from_numpy(g), 37, method=method, weights=w)
    want = bc.bincount2d_scatter(torch.from_numpy(g), 37, weights=w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("block_size", [1, 7, 64, 301, 10_000, "auto"])
def test_onehot_block_sizes(block_size):
    g, rng = _case()
    w = torch.from_numpy(_weights(rng, g.shape, "dyadic"))
    gt = torch.from_numpy(g)
    assert torch.equal(bc.bincount2d_onehot(gt, 37, block_size=block_size),
                       bc.bincount2d_scatter(gt, 37))
    assert torch.equal(bc.bincount2d_onehot(gt, 37, w, block_size=block_size),
                       bc.bincount2d_scatter(gt, 37, w))


def test_onehot_auto_block_bounds_the_temporary():
    assert bc._auto_block(1000, 100_000, 51, "auto") == bc._ONEHOT_BUDGET // (1000 * 51)
    assert bc._auto_block(2, 10, 3, "auto") == 10
    assert bc._auto_block(2, 10, 3, 4) == 4 and bc._auto_block(2, 10, 3, 0) == 1


@pytest.mark.parametrize("method", ["scatter", *STRATEGIES])
def test_nonfinite_weights_stay_in_their_slot(method):
    """NaN/inf weights keep np.bincount's semantics in every strategy: no
    0 * inf in the one-hot, no poisoned prefix sum in the sort."""
    g = torch.tensor([[0, 1, 2, 1, 0, 3, 3]])
    w = torch.tensor([[1.0, np.nan, np.inf, 2.0, 3.0, np.inf, -np.inf]], dtype=torch.float32)
    out = bc.bincount2d(g, 5, method=method, weights=w)[0].numpy()
    assert out[0] == 4.0 and np.isnan(out[1]) and np.isposinf(out[2])
    assert np.isnan(out[3]) and out[4] == 0.0


@pytest.mark.parametrize("method", ["scatter", *STRATEGIES])
def test_matches_the_jax_strategies(method):
    g, rng = _case(m=3, n_slots=20, c=500, seed=5)
    w = rng.rand(*g.shape).astype(np.float32)
    jg = jnp.asarray(g.astype(np.int32))
    jfn = {"scatter": jbc.bincount2d_scatter, "onehot": jbc.bincount2d_onehot,
           "sort": jbc.bincount2d_sort}[method]
    got = bc.bincount2d(torch.from_numpy(g), 20, method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(jg, None, 20)))
    gotw = bc.bincount2d(torch.from_numpy(g), 20, method=method,
                         weights=torch.from_numpy(w))
    # the JAX strategies add float32 weights in float32: test_bincount_
    # strategies.py's tolerance
    np.testing.assert_allclose(gotw.numpy(), np.asarray(jfn(jg, jnp.asarray(w), 20)),
                               rtol=1e-4)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown bincount method"):
        bc.bincount2d(torch.zeros(1, 3, dtype=torch.int64), 4, method="bogus")


@pytest.mark.parametrize("method", STRATEGIES)
@pytest.mark.parametrize("axis", [None, 1], ids=["full", "rows"])
@pytest.mark.parametrize("weights", [None, "f4", "i4"])
def test_histogram_methods_match_jax(method, axis, weights):
    """histogram(method='onehot'|'sort'): the JAX package's answer, and no
    kernel's plain version runs in their place."""
    rng = np.random.default_rng(6)
    a, b = rng.normal(size=(2, 4, 300)).astype(np.float32)
    a.flat[::17] = np.nan
    bins = [np.linspace(-3, 3, 11), np.linspace(-3, 3, 8)]
    w = None
    if weights == "f4":
        w = rng.random((4, 300)).astype(np.float32)
    elif weights == "i4":
        w = rng.integers(-1000, 1000, (4, 300)).astype(np.int32)
    before = (cuda_hist.JOINT2_LAUNCHES, cuda_hist.DIRECT_LAUNCHES)
    h, _ = histogram_cpu(a, b, bins=bins, axis=axis, weights=w, method=method,
                         block_size=64)
    jh, _ = xhistogram_tpu.histogram(a, b, bins=bins, axis=axis, weights=w,
                                     method=method, block_size=64)
    ref, _ = histogram_cpu(a, b, bins=bins, axis=axis, weights=w, method="scatter")
    assert (cuda_hist.JOINT2_LAUNCHES, cuda_hist.DIRECT_LAUNCHES) == before
    if weights == "f4":
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4)
    else:
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert torch.equal(h, ref)


def test_histogram_onehot_on_arange():
    """The JAX package's answer for method='onehot' on np.arange(4) with
    edges [0, 1, 2]: [1, 2] (the closed last bin)."""
    h, _ = histogram_cpu(np.arange(4), bins=[np.array([0, 1, 2])], method="onehot")
    np.testing.assert_array_equal(h.numpy(), [1, 2])
