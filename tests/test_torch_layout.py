"""Strided views read in place, and uint32 and uint64 at their own width.

``utils.axes.strided_layout`` hands the kernels every operand as an
``(m1, m0, c1, c0)`` view of the caller's memory: kept rows and reduced
columns as two (count, stride) levels each, a broadcast kept as a stride
of 0, a copy only where a side needs three levels. These tests hold the
views to ``canonicalize_2d``'s copy element for element, the public call on
such views to the JAX package (counts bit-equal, float sums within its
'highest' bound, rtol 3e-7 and atol 1e-6), the weights' gradient through a
broadcast to ``jax.grad``, the ops and their DTensor rules on 4-D views,
and uint32 and uint64 data, read at their own width, to the JAX package
and numpy. On the CPU every kernel runs its plain version on the views;
``tests/test_torch_gpu.py`` holds the kernels on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xhistogram_tpu
import xhistogram_torch
from xhistogram_torch import core
from xhistogram_torch.ops import cuda_hist, partitioning
from xhistogram_torch.utils.axes import canonicalize_2d, normalize_axis, strided_layout

histogram_cpu = functools.partial(xhistogram_torch.histogram, device="cpu")
RTOL, ATOL = 3e-7, 1e-6  # the JAX package's 'highest' bound on float sums


def _field(shape, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(offset, 1.5, shape).astype(np.float32)
    x.flat[::29] = np.nan
    return x


def _case(name):
    """``(inputs, weights or None, axis)`` of one view kind, as torch
    tensors that are views of larger or differently laid out storage."""
    t = torch.from_numpy(_field((6, 5, 40), 1))
    s = torch.from_numpy(_field((6, 5, 40), 2, 0.5))
    volume = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 1.5, (5, 40))
                              .astype(np.float32))
    wide = torch.from_numpy(_field((12, 34), 4))
    return {
        # the README layout: (time, depth, cell), depth kept
        "readme-axis02": ([t, s], None, (0, 2)),
        "readme-axis02-volume": ([t, s], volume, (0, 2)),
        "readme-axis1": ([t, s], None, 1),
        "readme-axis1-volume": ([t, s], volume, 1),
        "transposed": ([t[0].t(), s[0].t()], None, 0),
        "sliced": ([t[:, ::2, 3:30], s[:, ::2, 3:30]], None, (1, 2)),
        "halo-trimmed": ([wide[:, 1:-1], wide.flip(0)[:, 1:-1]], None, None),
        "halo-trimmed-weighted": ([wide[:, 1:-1]], wide.abs()[:, 1:-1], None),
        "broadcast-over-time": ([t, s], volume, None),
        "mixed-strides": ([t, s.permute(2, 0, 1).contiguous().permute(1, 2, 0)],
                          None, (0, 2)),
        # three levels on a side: copied
        "three-levels": ([t[::2, ::2, ::2], s[::2, ::2, ::2]], None, None),
    }[name]


VIEW_CASES = ["readme-axis02", "readme-axis02-volume", "readme-axis1",
              "readme-axis1-volume", "transposed", "sliced", "halo-trimmed",
              "halo-trimmed-weighted", "broadcast-over-time", "mixed-strides"]


@pytest.mark.parametrize("name", VIEW_CASES + ["three-levels"])
def test_views_share_storage_and_hold_canonicalize_2d_elements(name):
    """Each view shares its operand's storage (none is copied where each
    side merges into two levels), and position by position it holds the
    operand's element at the same broadcast index for every operand, each
    row the elements of ``canonicalize_2d``'s row."""
    inputs, weights, axis = _case(name)
    operands = list(inputs) + ([] if weights is None else [weights])
    shape = torch.broadcast_shapes(*(o.shape for o in operands))
    operands = [o.expand(shape) for o in operands]
    axis_t = normalize_axis(axis, len(shape))
    layout = strided_layout(operands, axis_t)
    assert layout.copied == (name == "three-levels")
    assert len(layout.shape) == 4
    m1, m0, c1, c0 = layout.shape
    ids = torch.arange(int(np.prod(shape))).reshape(shape)
    at = layout.apply(ids).reshape(m1 * m0, c1 * c0)
    want_ids = canonicalize_2d(ids, axis_t)
    assert torch.equal(at.sort(1).values, want_ids.sort(1).values)
    for view, op in zip(layout.views, operands):
        if not layout.copied:
            assert view.untyped_storage().data_ptr() == op.untyped_storage().data_ptr()
        flat = view.reshape(m1 * m0, c1 * c0)
        index = np.unravel_index(at.numpy(), tuple(shape))
        torch.testing.assert_close(flat, op[index], equal_nan=True, rtol=0, atol=0)


def test_layout_of_the_readme_call():
    """The examples of ``strided_layout``: (73, 50, 64800) with axis=(0, 2)
    keeps depth at stride 64800 and reduces (time, cell) at (3240000, 1);
    axis=1 keeps (time, cell) and reduces depth; a (50, 64800) volume has
    stride 0 over time; a halo-trimmed full reduction is runs of c - 2 at
    stride c. Checked on meta tensors (no memory)."""
    x = torch.empty(73, 50, 64800, device="meta")
    vol = torch.empty(50, 64800, device="meta")
    lay = strided_layout([x, vol.expand(73, 50, 64800)], (0, 2))
    assert lay.shape == (1, 50, 73, 64800)
    assert lay.views[0].stride()[1:] == (64800, 3240000, 1)
    assert lay.views[1].stride()[1:] == (64800, 0, 1)
    lay = strided_layout([x], (1,))
    assert lay.shape == (73, 64800, 1, 50)
    assert lay.views[0].stride() == (3240000, 1, 3240000, 64800)
    field = torch.empty(1024, 4096, device="meta")
    lay = strided_layout([field[:, 1:-1]], None)
    assert lay.shape == (1, 1, 1024, 4094) and lay.views[0].stride()[2:] == (4096, 1)


@pytest.mark.parametrize("method", ["auto", "cuda"])
@pytest.mark.parametrize("name", VIEW_CASES + ["three-levels"])
def test_public_call_on_views_matches_jax(name, method):
    """The public call on each view kind, unweighted and weighted (by the
    case's weights, or by a strided float32 weight), against the JAX
    package on the same values: counts bit-equal, sums within 'highest'."""
    inputs, weights, axis = _case(name)
    nbins = [np.linspace(-3 + i, 3 + i, 11 + 6 * i) for i in range(len(inputs))]
    h, _ = histogram_cpu(*inputs, bins=nbins, axis=axis, method=method)
    jh, _ = xhistogram_tpu.histogram(*(x.numpy() for x in inputs), bins=nbins, axis=axis)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    if weights is None:
        weights = inputs[0].abs().nan_to_num(1.0)
    h, _ = histogram_cpu(*inputs, bins=nbins, axis=axis, weights=weights, method=method)
    jh, _ = xhistogram_tpu.histogram(*(x.numpy() for x in inputs), bins=nbins, axis=axis,
                                     weights=weights.numpy())
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
    iw = (weights * 100).nan_to_num(0.0).to(torch.int32)
    h, _ = histogram_cpu(*inputs, bins=nbins, axis=axis, weights=iw, method=method)
    jh, _ = xhistogram_tpu.histogram(*(x.numpy() for x in inputs), bins=nbins, axis=axis,
                                     weights=iw.numpy())
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


def test_public_call_runs_the_layout_on_the_caller_memory(monkeypatch):
    """The public call lays its operands out with ``strided_layout`` and
    hands the kernel route views of the caller's tensors: spied on the CPU,
    where the op runs its plain version on them."""
    seen = []
    real = core.strided_layout

    def spy(operands, axis):
        layout = real(operands, axis)
        seen.append((layout, [o.untyped_storage().data_ptr() for o in operands]))
        return layout

    monkeypatch.setattr(core, "strided_layout", spy)
    inputs, volume, axis = _case("readme-axis02-volume")
    storages = {x.untyped_storage().data_ptr() for x in (*inputs, volume)}
    histogram_cpu(*inputs, bins=[np.linspace(-3, 3, 9)] * 2, axis=axis, weights=volume,
                  method="cuda")
    (layout, ptrs), = seen
    assert not layout.copied and set(ptrs) == storages
    assert layout.views[2].stride()[2] == 0  # the volume, broadcast over time


@pytest.mark.parametrize("name", ["readme-axis02-volume", "readme-axis1-volume",
                                  "broadcast-over-time", "halo-trimmed-weighted"])
def test_weight_gradient_through_a_broadcast_matches_jax(name):
    """The gradient of a weighted histogram's loss with respect to a
    broadcast (or sliced) weight, through the view chain, against jax.grad
    of the same loss."""
    inputs, weights, axis = _case(name)
    nbins = [np.linspace(-3, 3, 9)] * len(inputs)
    probe = np.random.default_rng(11).normal(size=(1 << 15,)).astype(np.float32)
    base = weights.detach().contiguous()
    w = base.clone().requires_grad_(True)
    view = w[...] if name != "halo-trimmed-weighted" else w
    h, _ = histogram_cpu(*inputs, bins=nbins, axis=axis, weights=view, method="cuda")
    loss = (h.reshape(-1) * torch.from_numpy(probe[:h.numel()])).sum()
    loss.backward()

    xs = [x.numpy() for x in inputs]

    def f(wj):
        hj, _ = xhistogram_tpu.histogram(*xs, bins=nbins, axis=axis, weights=wj)
        return (hj.reshape(-1) * jnp.asarray(probe[:hj.size])).sum()

    want = jax.grad(f)(jnp.asarray(base.numpy()))
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# --- the ops on 4-D views ----------------------------------------------------

def _view4(x):
    """(4, 4, 8, 12): kept (m1, m0), reduced (c1, c0), as strided views."""
    return torch.from_numpy(x).reshape(4, 4, 8, 12)


@pytest.mark.parametrize("kind", ["full", "rows", "rows-weighted"])
def test_ops_take_4d_views_with_fake_shapes(kind):
    """The factored op over every element and per kept row, unweighted and
    by a float32 view (float64 sums, in the fake output too)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.RandomState(0)
    a, b, w = (_view4(rng.rand(16, 96).astype("f4")).transpose(2, 3) for _ in range(3))
    w = w if kind == "rows-weighted" else None
    reduce_all = kind == "full"
    thr = torch.linspace(0, 1, 8)
    out = torch.ops.xhistogram.factored([a, b], [thr, thr], w, [7, 7], reduce_all)
    rows = (1,) if reduce_all else (4, 4)
    assert tuple(out.shape) == (*rows, 50)
    with FakeTensorMode() as mode:
        fa, fb, ft = (mode.from_tensor(x) for x in (a, b, thr))
        fw = None if w is None else mode.from_tensor(w)
        fake = torch.ops.xhistogram.factored([fa, fb], [ft, ft], fw, [7, 7], reduce_all)
    assert fake.shape == out.shape
    assert fake.dtype == out.dtype == (torch.int64 if w is None else torch.float64)
    want = cuda_hist.factored_reference(
        [a.reshape(16, 96), b.reshape(16, 96)], [thr, thr], [7, 7], reduce_all,
        weights=None if w is None else w.reshape(16, 96))
    assert torch.equal(cuda_hist.factored([a, b], [thr, thr], [7, 7], reduce_all,
                                          weights=w), want)
    torch.library.opcheck(torch.ops.xhistogram.factored, ([a, b], [thr, thr], w,
                                                          [7, 7], reduce_all))


def test_sharding_rules_of_4d_views():
    """A 4-D view keeps its first two dims (each a dim of the output's kept
    rows) and reduces the last two; a full reduction reduces all four."""
    pytest.importorskip("torch.distributed.tensor")
    kept = partitioning._rules(1, False, False, 4, kept_dims=2)
    placements = [str(out[0]) for out, _ in kept]
    assert placements == ["R", "S(0)", "S(1)", "P(sum)", "P(sum)"]
    full = partitioning._rules(2, True, True, 4, kept_dims=2)
    assert [str(out[0]) for out, _ in full] == ["R"] + ["P(sum)"] * 4


def test_joint2_runs_of_views():
    """joint2's operands as runs: a halo-trimmed field is runs of c - 2 at
    stride c, a weight broadcast over the runs has outer stride 0, a
    contiguous field is one run, and a view with no contiguous run is
    copied."""
    field = torch.zeros(64, 130)
    ops, (g, n), outer, copied = cuda_hist._joint2_runs([field[:, 1:-1]] * 2)
    assert (g, n) == (64, 128) and outer[:2] == [130, 130] and copied == 0
    w = torch.zeros(128).expand(64, 128)
    ops, (g, n), outer, copied = cuda_hist._joint2_runs([field[:, 1:-1], field[:, 1:-1], w])
    assert (g, n) == (64, 128) and outer == [130, 130, 0] and copied == 0
    ops, (g, n), outer, copied = cuda_hist._joint2_runs([field, field])
    assert (g, n) == (1, 64 * 130) and copied == 0
    ops, (g, n), outer, copied = cuda_hist._joint2_runs([field[:, ::2], field[:, ::2]])
    assert copied == 2 and (g, n) == (1, 64 * 65) and all(o.is_contiguous() for o in ops)


# --- uint32 and uint64 at their own width -------------------------------------

U32_TOP, U64_TOP = 2**32 - 1, 2**64 - 1
UNSIGNED_CASES = {
    # values at 0, 2^31, 2^32 - 1 (2^63, 2^64 - 1) with edges on both sides
    "uint32": (np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, U32_TOP - 1, U32_TOP],
                        np.uint32),
               [np.array([0, 2**31, U32_TOP], np.uint32),
                np.array([1, 2**31 - 1, 2**31 + 1, U32_TOP - 1], np.uint32),
                np.array([-1.0, 2.0**31, 2.0**32 + 5]),
                np.array([0.5, 2.0**31 + 0.5, 4294967294.5])]),
    "uint64": (np.array([0, 1, 2**31, U32_TOP, 2**63 - 1, 2**63, 2**63 + 1,
                         U64_TOP - 1, U64_TOP], np.uint64),
               [np.array([0, 2**63, U64_TOP], np.uint64),
                np.array([1, 2**32 - 1, 2**63 + 1, U64_TOP - 1], np.uint64),
                np.array([-5.0, 2.0**31, 2.0**63, 2.0**64]),
                np.array([0.0, 2.0**63, 2.0**65])]),
}


@pytest.mark.parametrize("edges", range(4))
@pytest.mark.parametrize("dtype", list(UNSIGNED_CASES))
def test_unsigned_boundaries_bit_equal_to_jax_and_numpy(dtype, edges):
    values, edge_sets = UNSIGNED_CASES[dtype]
    e = edge_sets[edges]
    rng = np.random.default_rng(edges)
    x = np.concatenate([values, rng.permutation(np.repeat(values, 7))])
    for data in (x, torch.from_numpy(x)):
        h, _ = histogram_cpu(data, bins=[e])
        jh, _ = xhistogram_tpu.histogram(x, bins=[e])
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(h.numpy(), np.histogram(x, bins=e)[0])
    # beside a float32 input, per kept row, and weighted
    y = rng.normal(0, 1, x.size).astype(np.float32)
    ey = np.linspace(-2, 2, 5)
    h, _ = histogram_cpu(x.reshape(8, -1), y.reshape(8, -1), bins=[e, ey], axis=1,
                         weights=np.abs(y).reshape(8, -1))
    jh, _ = xhistogram_tpu.histogram(x.reshape(8, -1), y.reshape(8, -1), bins=[e, ey],
                                     axis=1, weights=np.abs(y).reshape(8, -1))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64], ids=str)
def test_unsigned_data_is_not_widened_on_the_host(dtype):
    """numpy uint32 reaches the device as uint32 (half the bytes of the
    int64 copy earlier releases made); uint64 stays uint64 until the
    kernel flips each value in registers."""
    x = np.arange(10, dtype=torch.empty(0, dtype=dtype).numpy().dtype)
    assert core._coerce_host(x).dtype == x.dtype
    assert core._coerce_host(torch.from_numpy(x)).dtype == dtype
    assert core._compare_dtype(torch.from_numpy(x)) == np.dtype(
        np.int64 if dtype == torch.uint32 else np.uint64)


def test_operand_plan_reads_unsigned_at_its_own_width():
    """Every kernel's plan loads uint32 and uint64 as themselves (load codes
    kU32 = 10 and kU64 = 11) and compares them in int64: one_input by its
    own entries, the others by their mixed entries."""
    assert cuda_hist._LOAD_CODE[torch.uint32] == 10
    assert cuda_hist._LOAD_CODE[torch.uint64] == 11
    for dtypes in [(torch.uint32, torch.float32), (torch.uint64, torch.uint64),
                   (torch.int16, torch.uint32), (torch.uint64, torch.int64)]:
        for kernel in ("joint2", "slot"):
            op = cuda_hist.operand_plan(kernel, dtypes)
            assert op.entry == "mixed" and op.loads == dtypes
            assert op.codes == tuple(cuda_hist._LOAD_CODE[d] for d in dtypes)
            for d, c in zip(dtypes, op.compare):
                if d in (torch.uint32, torch.uint64, torch.int64):
                    assert c == torch.int64
    assert cuda_hist._ONE_INPUT_SUFFIX[torch.uint32] == "u32"
    assert cuda_hist._ONE_INPUT_SUFFIX[torch.uint64] == "u64"
