"""The port's digitize and joint index are bit-equal to the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhistogram_tpu import bins as jbins
from xhistogram_tpu.ops import digitize as jdig
from xhistogram_torch import bins as tbins
from xhistogram_torch.ops import digitize as tdig


def _borderline(edges, dtype, n_random, seed):
    """Every edge, its neighbours one ulp either side, NaN, ±inf, ±0,
    subnormals and random values, all in ``dtype``."""
    e = np.asarray(edges).astype(dtype)
    rng = np.random.default_rng(seed)
    finite = np.asarray(edges)[np.isfinite(edges)]
    lo, hi = float(finite.min()), float(finite.max())
    span = hi - lo
    vals = np.concatenate(
        [
            e,
            np.nextafter(e, np.asarray(-np.inf, dtype)),
            np.nextafter(e, np.asarray(np.inf, dtype)),
            np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], dtype),
            np.array([np.nextafter(0, -1, dtype=dtype),
                      np.nextafter(0, 1, dtype=dtype)], dtype),
            rng.uniform(lo - 0.1 * span, hi + 0.1 * span, n_random).astype(dtype),
        ]
    )
    return rng.permutation(vals)


# float32 only: without 64-bit mode the JAX package narrows float64 arrays
# (its histogram remaps them on the host; test_torch_core compares that)
FLOAT_CASES = [
    (np.linspace(-2.0, 30.0, 281), np.float32),
    (np.linspace(30.0, 40.0, 341).astype(np.float32), np.float32),
    (np.array([-1.0, 0.0, 1.0]), np.float32),
    (np.array([0.0, 0.1, 0.30000000000000004]), np.float32),
    (np.array([0.0, 1.0, np.inf]), np.float32),  # n_hi_clip = 1
]


@pytest.mark.parametrize("edges,dtype", FLOAT_CASES)
def test_digitize_float_bit_equal(edges, dtype):
    a = _borderline(edges, dtype, 4000, seed=len(edges)).reshape(-1, 1)
    a = np.broadcast_to(a, (a.shape[0], 3)).copy()
    ce = tbins.compare_form(edges, dtype)
    got = tdig.digitize_edges(
        torch.from_numpy(a), torch.from_numpy(ce.edges), n_hi_clip=ce.n_hi_clip
    )
    jce = jbins.compare_form(edges, dtype)
    want = jdig.digitize_edges(
        jnp.asarray(a), jnp.asarray(jce.edges), n_hi_clip=jce.n_hi_clip
    )
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "edges,dtype",
    [
        (np.array([0, 5, 10], dtype=np.int32), np.int32),
        (np.array([-3.5, 0.5, 2.0, 7.25]), np.int32),
        (np.array([0, np.iinfo(np.int32).max], dtype=np.int64), np.int32),
    ],
)
def test_digitize_int_bit_equal(edges, dtype):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(3)
    a = np.concatenate(
        [
            rng.integers(-20, 20, 500, dtype=dtype),
            np.array([info.min, info.max, info.max - 1, 0, 5, 10], dtype),
        ]
    )
    ce = tbins.compare_form(edges, dtype)
    got = tdig.digitize_edges(
        torch.from_numpy(a), torch.from_numpy(ce.edges), n_hi_clip=ce.n_hi_clip
    )
    want = jdig.digitize_edges(
        jnp.asarray(a), jnp.asarray(ce.edges), n_hi_clip=ce.n_hi_clip
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nbins", [[280, 340], [7], [3, 4, 5]])
def test_joint_bin_index_bit_equal(nbins):
    rng = np.random.default_rng(sum(nbins))
    # raw digitize output: 0 (below), 1..nb (bins), nb + 1 (above / NaN)
    idx = [rng.integers(0, nb + 2, (5, 300)) for nb in nbins]
    g, n_slots = tdig.joint_bin_index([torch.from_numpy(i) for i in idx], nbins)
    jg, jn = jdig.joint_bin_index([jnp.asarray(i, jnp.int32) for i in idx], nbins)
    assert n_slots == jn
    assert g.dtype == torch.int64
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
