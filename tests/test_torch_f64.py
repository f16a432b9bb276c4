"""precision='f64' in the port: exact float64-weighted sums, rounded once.

The cases of tests/test_f64_weights.py (not the sharded ones), each run
with the same numpy inputs through the JAX package and the port on the CPU.
Sums are held to <= 1 ulp of an exact rational oracle (fractions.Fraction)
and of the JAX package's result, on every bincount strategy and on the
kernel route's plain version (``method='cuda'``); the int64 limb passes
are held bit-equal to the plain decomposition (``index_add_``).
"""

import functools
from fractions import Fraction

import numpy as np
import pytest
import torch

import xhistogram_tpu
import xhistogram_torch
from xhistogram_torch import core

histogram_cpu = functools.partial(xhistogram_torch.histogram, device="cpu")
StreamingCPU = functools.partial(xhistogram_torch.StreamingHistogram, device="cpu")

METHODS = ["auto", "scatter", "onehot", "sort", "cuda"]


def _exact_slot_sums(data, edges, weights):
    """Per-slot EXACT rational sums (data strictly inside the bins)."""
    idx = np.searchsorted(edges, data, side="right") - 1
    sums = [Fraction(0)] * (len(edges) - 1)
    for i, w in zip(idx.ravel(), np.asarray(weights, np.float64).ravel()):
        if 0 <= i < len(sums):
            sums[i] += Fraction(w)
    return sums


def _ulps(got, want):
    """|got - want| in ulps of want, elementwise (0 where both agree)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        return np.where(same, 0.0, np.abs(got - want) / np.spacing(np.abs(want)))


def _assert_correctly_rounded(h, exact_sums):
    assert h.dtype == torch.float64
    want = np.array([float(s) for s in exact_sums])
    assert _ulps(h.numpy().ravel(), want).max() <= 1.0


def _both(*args, method="auto", **kwargs):
    """(port result, JAX result) for one call, the port's on the CPU."""
    h, edges = histogram_cpu(*args, method=method, precision="f64", **kwargs)
    jh, jedges = xhistogram_tpu.histogram(*args, precision="f64", **kwargs)
    for e, je in zip(edges, jedges):
        np.testing.assert_array_equal(e, je)
    assert h.dtype == torch.float64
    assert tuple(h.shape) == np.asarray(jh).shape
    if kwargs.get("density"):
        # the sums within 1 ulp, divided by totals added in another order
        np.testing.assert_allclose(h.numpy(), jh, rtol=1e-14)
    else:
        assert _ulps(h.numpy(), jh).max() <= 1.0
    return h, np.asarray(jh)


@pytest.mark.parametrize("method", METHODS)
def test_correctly_rounded_vs_rational_oracle(method):
    rng = np.random.RandomState(0)
    data = rng.rand(400).astype("f4") * 0.98 + 0.01
    edges = np.linspace(0.0, 1.0, 9)
    # exponents spanning ~130 binades
    w = rng.randn(400) * 10.0 ** rng.uniform(-20, 20, 400)
    h, _ = _both(data, bins=edges, weights=w, method=method)
    _assert_correctly_rounded(h, _exact_slot_sums(data, edges, w))


@pytest.mark.parametrize("method", METHODS)
def test_exact_on_catastrophic_cancellation(method):
    k = 50
    w = np.tile([1e16, 1.0, -1e16, 1.0], k)
    data = np.full(w.shape, 0.5, "f4")
    edges = np.linspace(0.0, 1.0, 3)
    h, jh = _both(data, bins=edges, weights=w, method=method)
    np.testing.assert_array_equal(h.numpy(), [0.0, float(2 * k)])
    np.testing.assert_array_equal(h.numpy(), jh)


def test_matches_highest_within_f32_error():
    rng = np.random.RandomState(1)
    data = rng.rand(1000).astype("f4")
    edges = np.linspace(0.0, 1.0, 7)
    w = rng.rand(1000)  # plain [0,1) float64
    h64, _ = _both(data, bins=edges, weights=w)
    hhi, _ = histogram_cpu(data, bins=edges, weights=w.astype("f4"),
                           precision="highest")
    np.testing.assert_allclose(h64.numpy(), hhi.numpy().astype(np.float64), rtol=2e-6)


@pytest.mark.parametrize("method", METHODS)
def test_subnormal_and_zero_weights(method):
    data = np.array([0.25, 0.25, 0.75, 0.75, 0.25, 0.75], "f4")
    edges = np.linspace(0.0, 1.0, 3)
    w = np.array([5e-324, 2.2250738585072014e-308, 1.0, -0.0, 0.0, 4e-310])
    h, _ = _both(data, bins=edges, weights=w, method=method)
    _assert_correctly_rounded(h, _exact_slot_sums(data, edges, w))


def test_only_zero_and_subnormal_weights():
    """No nonzero weight at all, and a single subnormal: zero groups, then
    one group at the bottom of the exponent range."""
    data = np.array([0.25, 0.75], "f4")
    edges = np.linspace(0.0, 1.0, 3)
    for w in (np.array([0.0, -0.0]), np.array([0.0, -5e-324])):
        h, jh = _both(data, bins=edges, weights=w)
        np.testing.assert_array_equal(h.numpy(), jh)


@pytest.mark.parametrize("method", METHODS)
def test_nonfinite_weights_scatter_semantics(method):
    data = np.array([0.1, 0.1, 0.5, 0.5, 0.9, 0.9], "f4")
    edges = np.linspace(0.0, 1.0, 4)
    w = np.array([np.nan, 1.0, np.inf, -np.inf, np.inf, 3.0])
    h, jh = _both(data, bins=edges, weights=w, method=method)
    h = h.numpy()
    assert np.isnan(h[0])          # nan + 1.0
    assert np.isnan(h[1])          # inf + -inf
    assert h[2] == np.inf          # inf + 3.0
    np.testing.assert_array_equal(h, jh)


def test_too_many_exponent_groups_raises_as_jax():
    data = np.full(40, 0.5, "f4")
    edges = np.linspace(0.0, 1.0, 3)
    w = 10.0 ** np.linspace(-290, 290, 40)
    with pytest.raises(ValueError, match="exponent groups") as ours:
        histogram_cpu(data, bins=edges, weights=w, precision="f64")
    with pytest.raises(ValueError) as theirs:
        xhistogram_tpu.histogram(data, bins=edges, weights=w, precision="f64")
    assert str(ours.value) == str(theirs.value)


def test_requires_grad_raises():
    """The port's counterpart of the JAX package's refusal under tracing:
    the decomposition carries no gradient."""
    data = np.linspace(0.1, 0.9, 16).astype("f4")
    edges = np.linspace(0.0, 1.0, 5)
    w = torch.ones(16, dtype=torch.float32, requires_grad=True)
    with pytest.raises(ValueError, match="precision='highest'"):
        histogram_cpu(data, bins=edges, weights=w, precision="f64")
    h, _ = histogram_cpu(data, bins=edges, weights=w.detach(), precision="f64")
    np.testing.assert_array_equal(h.numpy(), np.histogram(data, bins=edges)[0])


def test_integer_weights_normalize_to_exact_int_path():
    data = np.array([0.2, 0.4, 0.6], "f4")
    edges = np.linspace(0.0, 1.0, 3)
    w = np.array([2**40, 3, 5], np.int64)
    h64, _ = histogram_cpu(data, bins=edges, weights=w, precision="f64")
    hint, _ = histogram_cpu(data, bins=edges, weights=w)
    jh, _ = xhistogram_tpu.histogram(data, bins=edges, weights=w, precision="f64")
    assert torch.equal(h64, hint) and h64.dtype == torch.int64
    np.testing.assert_array_equal(h64.numpy(), jh)


def test_unweighted_request_is_mode_independent():
    data = np.linspace(0.1, 0.9, 32).astype("f4")
    edges = np.linspace(0.0, 1.0, 5)
    h, _ = histogram_cpu(data, bins=edges, precision="f64")
    np.testing.assert_array_equal(h.numpy(), np.histogram(data, bins=edges)[0])


@pytest.mark.parametrize("method", METHODS)
def test_kept_axes_and_joint_and_density(method):
    rng = np.random.RandomState(2)
    a = rng.rand(3, 200).astype("f4")
    b = rng.rand(3, 200).astype("f4")
    ea = np.linspace(0.0, 1.0, 5)
    eb = np.linspace(0.0, 1.0, 4)
    w = rng.randn(3, 200) * 10.0 ** rng.uniform(-12, 12, (3, 200))
    h, _ = _both(a, b, bins=[ea, eb], axis=1, weights=w, method=method)
    assert tuple(h.shape) == (3, 4, 3)
    for r in range(3):
        ia = np.searchsorted(ea, a[r], side="right") - 1
        ib = np.searchsorted(eb, b[r], side="right") - 1
        ex = {}
        for i, j, wv in zip(ia, ib, w[r].astype(np.float64)):
            ex[(i, j)] = ex.get((i, j), Fraction(0)) + Fraction(wv)
        for (i, j), s in ex.items():
            assert _ulps(float(h[r, i, j]), float(s)) <= 1.0
    hd, jhd = _both(a, b, bins=[ea, eb], axis=1, weights=w, density=True,
                    method=method)
    widths = np.outer(np.diff(ea), np.diff(eb))
    integral = (hd.numpy() * widths).sum(axis=(-2, -1))
    np.testing.assert_allclose(integral, 1.0, rtol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_broadcast_weights(method):
    rng = np.random.RandomState(3)
    data = rng.rand(4, 64).astype("f4")
    edges = np.linspace(0.0, 1.0, 6)
    w = rng.randn(64) * 10.0 ** rng.uniform(-15, 15, 64)  # broadcast rows
    h, _ = _both(data, bins=edges, axis=1, weights=w, method=method)
    for r in range(4):
        _assert_correctly_rounded(h[r], _exact_slot_sums(data[r], edges, w))


@pytest.mark.parametrize("wdtype", ["f2", "f4"])
def test_narrow_float_weights_give_float64(wdtype):
    rng = np.random.RandomState(6)
    data = rng.rand(300).astype("f4")
    edges = np.linspace(0.0, 1.0, 5)
    w = (rng.randn(300) * 100).astype(wdtype)
    h, _ = _both(data, bins=edges, weights=w)
    _assert_correctly_rounded(h, _exact_slot_sums(data, edges, w))


def test_overflowing_slot_is_inf():
    data = np.array([0.25, 0.25, 0.75], "f4")
    edges = np.linspace(0.0, 1.0, 3)
    w = np.array([1.7e308, 1.7e308, -1.0])
    h, jh = _both(data, bins=edges, weights=w)
    np.testing.assert_array_equal(h.numpy(), [np.inf, -1.0])
    np.testing.assert_array_equal(h.numpy(), jh)


def test_limb_passes_bit_equal_to_the_plain_decomposition():
    """The kernel route's plain versions (method='cuda') and every strategy
    give the same bits as the scatter decomposition: integer limb sums do
    not depend on the order of the adds."""
    rng = np.random.RandomState(7)
    a, b = rng.rand(2, 6, 500).astype("f4")
    w = rng.randn(6, 500) * 10.0 ** rng.uniform(-30, 30, (6, 500))
    bins = [np.linspace(0, 1, 30), np.linspace(0, 1, 40)]
    for axis in (None, 1):
        want, _ = histogram_cpu(a, b, bins=bins, axis=axis, weights=w,
                                precision="f64", method="scatter")
        for method in ("auto", "onehot", "sort", "cuda"):
            got, _ = histogram_cpu(a, b, bins=bins, axis=axis, weights=w,
                                   precision="f64", method=method)
            assert torch.equal(got, want), (axis, method)


@pytest.mark.parametrize("n_cols,limbs", [(1, (31, 2)), (1 << 32, (31, 2)),
                                          ((1 << 32) + 1, (21, 3)), (1 << 42, (21, 3))])
def test_limb_widths_keep_slot_sums_below_2_63(n_cols, limbs):
    width, n_limbs = core._f64_limbs(n_cols)
    assert (width, n_limbs) == limbs
    assert width * n_limbs >= 62  # the limbs cover |K| < 2**62
    top = 62 - width * (n_limbs - 1)  # bits of the top limb
    assert max(width, top) <= 31
    assert ((1 << max(width, top)) - 1) * n_cols < 1 << 63


def test_limbs_add_back_to_k():
    """The decomposition is exact: the limbs of every group, scaled, add
    back to the weights (checked through the sums of single elements)."""
    rng = np.random.RandomState(8)
    w = np.concatenate([rng.randn(200) * 10.0 ** rng.uniform(-300, 300, 200),
                        [5e-324, -5e-324, 2.0**-1022, 1.7976931348623157e308,
                         -1.0, 2.0**52 + 1, 3.0 * 2**-1074]])
    w = w[:400]
    data = np.arange(w.size, dtype=np.float32) + 0.5
    edges = np.arange(w.size + 1, dtype=np.float64)
    # in groups of 30 weights, so no call spans more than 32 exponent groups
    for lo in range(0, w.size, 30):
        h, _ = histogram_cpu(data[lo:lo + 30], bins=edges, weights=w[lo:lo + 30],
                             precision="f64")
        np.testing.assert_array_equal(h.numpy()[lo:lo + 30], w[lo:lo + 30])


def test_streaming_f64_within_chunk_exact():
    edges = np.linspace(0.0, 1.0, 3)
    acc = StreamingCPU(bins=[edges], precision="f64")
    acc.update(np.array([0.25, 0.25, 0.25], "f4"),
               weights=np.array([1e16, 1.0, -1e16]))
    acc.update(np.array([0.25], "f4"), weights=np.array([1.0]))
    h, _ = acc.result()
    np.testing.assert_array_equal(h.numpy(), [2.0, 0.0])


def test_streaming_f64_dd_across_chunks():
    edges = np.linspace(0.0, 1.0, 3)
    acc = StreamingCPU(bins=[edges], precision="f64")
    jacc = xhistogram_tpu.StreamingHistogram(bins=[edges], precision="f64")
    for v in (1e16, 1.0, -1e16):
        acc.update(np.array([0.25], "f4"), weights=np.array([v]))
        jacc.update(np.array([0.25], "f4"), weights=np.array([v]))
    h, _ = acc.result()
    np.testing.assert_array_equal(h.numpy(), [1.0, 0.0])
    np.testing.assert_array_equal(h.numpy(), jacc.result()[0])
    assert float(acc.counts[0]) == 1.0
    assert float(acc.blocks[()][0]) == 1.0


def test_streaming_f64_overflow_returns_inf():
    edges = np.linspace(0.0, 1.0, 3)
    acc = StreamingCPU(bins=[edges], precision="f64")
    acc.update(np.array([0.25], "f4"), weights=np.array([1.7e308]))
    acc.update(np.array([0.25], "f4"), weights=np.array([1.7e308]))
    h, _ = acc.result()
    assert float(h[0]) == np.inf and float(h[1]) == 0.0


def test_labeled_f64():
    from xhistogram_tpu.labeled import NamedArray as JNamedArray
    from xhistogram_tpu.labeled import histogram as jlhist
    from xhistogram_torch.labeled import NamedArray
    from xhistogram_torch.labeled import histogram as lhist

    rng = np.random.RandomState(4)
    d = rng.rand(5, 40).astype("f4")
    wv = rng.randn(5, 40) * 10.0 ** rng.uniform(-10, 10, (5, 40))
    edges = np.linspace(0.0, 1.0, 5)
    out = lhist(NamedArray(d, dims=("y", "x"), name="v"), bins=[edges], dim=["x"],
                weights=NamedArray(wv, dims=("y", "x")), precision="f64",
                device="cpu")
    jout = jlhist(JNamedArray(d, dims=("y", "x"), name="v"), bins=[edges], dim=["x"],
                  weights=JNamedArray(wv, dims=("y", "x")), precision="f64")
    ref, _ = histogram_cpu(d, bins=edges, axis=1, weights=wv, precision="f64")
    assert torch.equal(out.data, ref)
    assert _ulps(out.values, jout.values).max() <= 1.0
    assert out.dims == jout.dims and out.name == jout.name


@pytest.mark.parametrize(
    "kind,n_groups",
    [("uniform", 1), ("cell-volume", 1), ("log-uniform-30", None),
     ("log-uniform-90", None), ("tiny-beside-huge", None), ("subnormal", 1)],
)
def test_groups_decompose_exactly(kind, n_groups):
    """``sum(K_g * 2**s_g)`` is each weight exactly (checked in rationals);
    weights within 62 binades of each other's lowest bits take one group,
    wider ones the JAX package's stride-10 groups."""
    rng = np.random.RandomState(9)
    w = {
        "uniform": rng.rand(300),
        "cell-volume": 1e9 * (0.5 + rng.rand(300)),
        "log-uniform-30": rng.randn(300) * 10.0 ** rng.uniform(-15, 15, 300),
        "log-uniform-90": rng.randn(300) * 10.0 ** rng.uniform(-45, 45, 300),
        "tiny-beside-huge": np.array([2.0**900, 2.0**-1000, -3.0 * 2**-1000, 0.0]),
        "subnormal": np.array([5e-324, -4e-310, 0.0, 2.2250738585072014e-308]),
    }[kind]
    groups = core._f64_groups(torch.from_numpy(w), float(np.abs(w).max()))
    if n_groups is not None:
        assert len(groups) == n_groups
    else:
        assert len(groups) > 1
    total = [Fraction(0)] * w.size
    for s, k in groups:
        assert int(k.abs().max()) < 1 << 62
        for i, ki in enumerate(k.tolist()):
            total[i] += Fraction(ki) * Fraction(2) ** s
    assert total == [Fraction(float(x)) for x in w]


def test_split_limbs_add_back_and_stay_in_range():
    k = torch.tensor([0, 1, -1, (1 << 62) - 1, -(1 << 62) + 1, 1 << 61, -(1 << 31),
                      123456789012345678, -987654321098765432])
    for width, n_limbs in ((31, 2), (21, 3)):
        limbs = core._split_limbs(k, width, n_limbs)
        back = sum(limb << (width * j) for j, limb in enumerate(limbs))
        assert torch.equal(back, k)
        assert all(int(x.abs().max()) < 1 << width for x in limbs)
        for limb in limbs:  # each carries its weight's sign
            assert bool(((limb == 0) | ((limb < 0) == (k < 0))).all())


def test_tiny_weight_beside_a_huge_one_is_kept():
    """A weight far below the largest one's window must not vanish in its
    scaling (the one-group test guards the underflow)."""
    data = np.array([0.25, 0.75, 0.75], "f4")
    edges = np.linspace(0.0, 1.0, 3)
    w = np.array([2.0**900, 2.0**-1000, 2.0**-1001])
    h, jh = _both(data, bins=edges, weights=w)
    np.testing.assert_array_equal(h.numpy(), [2.0**900, 3.0 * 2**-1001])
