"""The kernels' bucketed digitize (csrc/digitize.cuh), through its plain
mirror ``ops.digitize.digitize_bucketed``, is bit-equal to the port's
``digitize_edges`` and to the JAX package's on adversarial threshold sets.

Every set is also held to numpy's ``searchsorted(side="right")``. The JAX
package without 64-bit mode narrows float64 and int64 arrays, and its raw
digitize under XLA:CPU flushes subnormals (its ``histogram`` sends such
edges to a host fallback), so the JAX digitize is the oracle of the float32
and int32 sets without subnormal thresholds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xhistogram_tpu.ops import digitize as jdig
from xhistogram_torch import bins as tbins
from xhistogram_torch.ops import digitize as tdig
from ts_cases import BUCKET_EDGE_SETS, bucket_case_values

LINSPACE_SETS = ("bench-T", "bench-S", "linspace-4-4-91", "linspace-4-4-91-f64",
                 "16384-bins", "int32-linspace")


def _thresholds(name):
    edges, dtype = BUCKET_EDGE_SETS[name]
    ce = tbins.compare_form(edges, dtype)
    assert ce.n_hi_clip == 0
    return torch.from_numpy(np.ascontiguousarray(ce.edges)), dtype


def _data(thr, dtype, seed):
    return torch.from_numpy(bucket_case_values(thr.numpy(), dtype, seed=seed))


@pytest.mark.parametrize("name", list(BUCKET_EDGE_SETS))
def test_bucketed_equals_searchsorted(name):
    thr, dtype = _thresholds(name)
    a = _data(thr, dtype, seed=len(name))
    got = tdig.digitize_bucketed(a, thr)
    want = tdig.digitize_edges(a, thr)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # numpy sorts NaN last, past every threshold
    np.testing.assert_array_equal(
        got.numpy(), np.searchsorted(thr.numpy(), a.numpy(), side="right"))


@pytest.mark.parametrize(
    "name", [n for n, (_, d) in BUCKET_EDGE_SETS.items()
             if d in (np.float32, np.int32) and "subnormal" not in n])
def test_bucketed_equals_jax(name):
    thr, dtype = _thresholds(name)
    a = _data(thr, dtype, seed=len(name) + 1)
    want = jdig.digitize_edges(jnp.asarray(a.numpy()), jnp.asarray(thr.numpy()))
    np.testing.assert_array_equal(tdig.digitize_bucketed(a, thr).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("cells", [1, 2, 3, 7, 64, 4096])
@pytest.mark.parametrize("name", ["bench-S", "repeated", "logspace-f64", "int64-2^53"])
def test_bucketed_at_any_cell_count(name, cells):
    # the table is exact at any cell count, one cell (the plain binary
    # search) included
    thr, dtype = _thresholds(name)
    a = _data(thr, dtype, seed=cells)
    np.testing.assert_array_equal(tdig.digitize_bucketed(a, thr, cells).numpy(),
                                  tdig.digitize_edges(a, thr).numpy())


@pytest.mark.parametrize("name", LINSPACE_SETS)
def test_linspace_windows_are_narrow(name):
    thr, _ = _thresholds(name)
    nb = thr.shape[0] - 1
    first, widest, (_, _, k) = tdig.bucket_table(thr)
    assert k == min(2 * nb, tdig.MAX_CELLS)
    assert first[0] == 0 and first[-1] == nb + 1
    if k == 2 * nb:
        assert 1 <= widest <= 2
    else:  # 16384 bins in 4096 cells: four bins a cell
        assert widest <= 2 * -(-(nb + 1) // k)


@pytest.mark.parametrize("name", ["subnormal-span", "huge-span"])
def test_degenerate_spans_take_one_cell(name):
    # k / span overflows, or the span itself does: one cell, whose window
    # is every threshold
    thr, _ = _thresholds(name)
    first, widest, (lo, inv, k) = tdig.bucket_table(thr)
    assert (k, float(lo), float(inv)) == (1, 0.0, 0.0)
    assert first.tolist() == [0, thr.shape[0]] and widest == thr.shape[0]
