"""The plain reference against numpy.histogramdd at tiny sizes of each
call kind, walked in blocks; and what it imports."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import reference


def _numpy(inputs, edges, axis, weights=None):
    """numpy.histogramdd of each kept row."""
    x = [np.asarray(a, np.float64) for a in inputs]
    ndim = x[0].ndim
    reduced = tuple(range(ndim)) if axis is None else axis
    kept = [a for a in range(ndim) if a not in reduced]
    w = None if weights is None else np.broadcast_to(np.asarray(weights, np.float64), x[0].shape)
    order = kept + list(reduced)
    x = [np.transpose(a, order).reshape(int(np.prod([a.shape[k] for k in kept])), -1) for a in x]
    if w is not None:
        w = np.transpose(w, order).reshape(x[0].shape)
    rows = []
    for r in range(x[0].shape[0]):
        h, _ = np.histogramdd(np.stack([a[r] for a in x], -1),
                              bins=[np.asarray(e, np.float64) for e in edges],
                              weights=None if w is None else w[r])
        rows.append(h)
    shape = [inputs[0].shape[k] for k in kept] + [len(e) - 1 for e in edges]
    return np.stack(rows).reshape(shape)


@pytest.fixture(params=[1 << 26, 7], ids=["one-block", "blocks-of-7"])
def block(request, monkeypatch):
    monkeypatch.setattr(reference, "BLOCK", request.param)


def test_joint_weighted_per_level(block):
    g = torch.Generator().manual_seed(0)
    t = 10 * torch.randn(5, 4, 6, generator=g)
    s = 35 + torch.randn(5, 4, 6, generator=g)
    v = torch.rand(4, 6, generator=g)
    te, se = np.linspace(-10, 10, 9).astype(np.float32), np.linspace(34, 36, 5).astype(np.float32)
    got = reference.histogram([t, s], [te, se], (0, 2), v)
    want = _numpy([t.numpy(), s.numpy()], [te, se], (0, 2), v.numpy())
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_counts_per_cell_with_nan_and_edge_values(block):
    g = torch.Generator().manual_seed(1)
    x = 4 * torch.randn(6, 3, 4, generator=g)
    x[:, 0, 0] = float("nan")
    x[0, 1, 1] = 3.0  # the last edge: in the last bin
    x[1, 1, 1] = -3.0  # the first edge
    x[2, 1, 1] = 3.5  # outside
    e = np.linspace(-3, 3, 7).astype(np.float32)
    got = reference.histogram([x], [e], (0,))
    want = _numpy([x.numpy()], [e], (0,))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_reduction_of_a_strided_view(block):
    g = torch.Generator().manual_seed(2)
    t = torch.randn(4, 3, 10, generator=g)[:, :, 1:-1]
    s = torch.randn(4, 3, 10, generator=g)[:, :, 1:-1]
    edges = [np.linspace(-2, 2, 6), np.linspace(-1, 1, 4)]
    got = reference.histogram([t, s], edges, None)
    np.testing.assert_array_equal(got.numpy(), _numpy([t.numpy(), s.numpy()], edges, None))


def test_control_precision_moves_counts():
    x = torch.linspace(0, 1, 10001)
    e = np.linspace(0, 1, 101)
    exact = reference.histogram([x], [e], None)
    low = reference.histogram([x], [e], None, lowp=torch.bfloat16)
    assert reference.compare({"hist": low}, {"hist": exact})["count_gap"] > 0
    assert reference.compare({"hist": exact}, {"hist": exact})["count_gap"] == 0


def test_relative_gap_of_sums():
    want = torch.tensor([4.0, 0.0, 1.0, 2.0], dtype=torch.float64)
    got = want.to(torch.float32).clone()
    assert reference.compare({"hist": got}, {"hist": want})["sum_rel_gap"] == 0
    got[1] = 1.0  # a sum where the reference has none: against the median sum
    assert reference.compare({"hist": got}, {"hist": want})["sum_rel_gap"] == pytest.approx(0.5)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for name in ("reference.py", "seeding.py", "recipes/ts_depth.py", "recipes/sst_daily.py",
                 "recipes/ts_depth_sharded.py"):
        tree = ast.parse((Path(reference.__file__).parent / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("xhistogram_torch", "xhistogram_tpu", "jax"), (name, m)
