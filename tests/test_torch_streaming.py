"""StreamingHistogram of the port against the JAX package's, on the CPU.

The cases of tests/test_streaming.py: each stream of chunks, made from a
seed with numpy, goes through both packages' accumulators, and chunked
accumulation must equal the one-shot result. Counts and integer sums are
bit-equal; float sums are held as tests/test_torch_weighted.py holds them
(the JAX package's 'highest' bound, rtol 3e-7, atol 1e-6); errors keep the
JAX package's types and messages. (The JAX package's int32 overflow guard
of ``core.histogram`` has no counterpart: the port counts in int64.)
"""

import functools

import numpy as np
import pytest
import torch

import xhistogram_tpu
import xhistogram_torch

StreamingCPU = functools.partial(xhistogram_torch.StreamingHistogram, device="cpu")
histogram_cpu = functools.partial(xhistogram_torch.histogram, device="cpu")

bins9 = np.linspace(-4, 4, 10)
RTOL, ATOL = 3e-7, 1e-6


def chunks(a, n, axis):
    return np.array_split(a, n, axis=axis)


def _pair(**kwargs):
    """(port accumulator on the CPU, JAX accumulator), built alike."""
    return StreamingCPU(**kwargs), xhistogram_tpu.StreamingHistogram(**kwargs)


def _update(accs, *args, **kwargs):
    for acc in accs:
        acc.update(*args, **kwargs)


def _assert_same(h, jh, exact=True):
    jh = np.asarray(jh)
    assert tuple(h.shape) == jh.shape
    if exact:
        np.testing.assert_array_equal(h.numpy(), jh)
    else:
        np.testing.assert_allclose(h.numpy(), jh, rtol=RTOL, atol=ATOL)


def _raised(fn):
    try:
        fn()
    except Exception as ex:  # noqa: BLE001 — the type and message are compared
        return type(ex), str(ex)
    return None


@pytest.mark.parametrize("n_chunks", [1, 3, 7])
def test_streaming_1d_reduce_all(n_chunks):
    rng = np.random.RandomState(0)
    data = rng.randn(1000).astype("f4")
    accs = _pair(bins=bins9)
    for ch in chunks(data, n_chunks, 0):
        _update(accs, ch)
    h, edges = accs[0].result()
    jh, jedges = accs[1].result()
    assert h.dtype == torch.int64
    _assert_same(h, jh)
    np.testing.assert_array_equal(edges[0], jedges[0])
    np.testing.assert_array_equal(h.numpy(), np.histogram(data, bins9)[0])
    h_ref, _ = histogram_cpu(data, bins=bins9)
    assert torch.equal(h, h_ref)


@pytest.mark.parametrize("n_chunks", [2, 5])
def test_streaming_kept_axis_weighted_density(n_chunks):
    rng = np.random.RandomState(1)
    data = rng.randn(4, 300).astype("f4")
    w = rng.rand(4, 300).astype("f4")
    accs = _pair(bins=bins9, axis=1)
    for dc, wc in zip(chunks(data, n_chunks, 1), chunks(w, n_chunks, 1)):
        _update(accs, dc, weights=wc)
    h, _ = accs[0].result(density=True)
    assert h.dtype == torch.float64
    _assert_same(h, accs[1].result(density=True)[0], exact=False)
    h_ref, _ = histogram_cpu(data, bins=bins9, axis=1, weights=w, density=True)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), rtol=1e-6)
    sums, _ = accs[0].result()
    _assert_same(sums, accs[1].result()[0], exact=False)


def test_streaming_joint_2input():
    rng = np.random.RandomState(2)
    a = rng.randn(6, 200).astype("f4")
    b = rng.randn(6, 200).astype("f4")
    ba = np.linspace(-4, 4, 9)
    bb = np.linspace(-4, 4, 12)
    accs = _pair(bins=[ba, bb], axis=1)
    for ac, bc in zip(chunks(a, 4, 1), chunks(b, 4, 1)):
        _update(accs, ac, bc)
    h, _ = accs[0].result()
    _assert_same(h, accs[1].result()[0])
    h_ref, _ = histogram_cpu(a, b, bins=[ba, bb], axis=1)
    assert torch.equal(h, h_ref)


@pytest.mark.parametrize("wdtype", ["i4", "i8", "u8"])
def test_streaming_integer_weights_bit_equal(wdtype):
    rng = np.random.RandomState(3)
    data = rng.randn(3, 90).astype("f4")
    w = rng.randint(0, 2**31 - 1, (3, 90)).astype(wdtype)
    if wdtype != "i4":
        w = w * (1 << 22)  # sums past 2**53, below 2**63
    accs = _pair(bins=bins9, axis=1)
    for dc, wc in zip(chunks(data, 3, 1), chunks(w, 3, 1)):
        _update(accs, dc, weights=wc)
    h, _ = accs[0].result()
    jh = np.asarray(accs[1].result()[0])
    assert h.dtype == {"i4": torch.int64, "i8": torch.int64, "u8": torch.uint64}[wdtype]
    np.testing.assert_array_equal(h.numpy().astype(jh.dtype), jh)
    hd, _ = accs[0].result(density=True)
    np.testing.assert_allclose(hd.numpy(), accs[1].result(density=True)[0], rtol=1e-12)


def test_streaming_torch_chunks():
    """CPU tensors stream like numpy arrays (on the card, both are staged)."""
    rng = np.random.RandomState(4)
    data = rng.randn(2, 500).astype("f4")
    acc = StreamingCPU(bins=bins9, axis=1)
    for ch in chunks(data, 3, 1):
        acc.update(torch.from_numpy(np.ascontiguousarray(ch)))
    h_ref, _ = histogram_cpu(data, bins=bins9, axis=1)
    assert torch.equal(acc.result()[0], h_ref)


@pytest.mark.parametrize(
    "case",
    ["int-bins", "str-bins", "range", "ambiguous-int-list", "bad-precision",
     "too-few-arrays", "result-before-update", "kept-axis-changed", "mixed",
     "offset-length"],
)
def test_streaming_error_contracts(case):
    """Each error of the JAX package's accumulator, with its type and
    message."""
    def run(cls):
        if case == "int-bins":
            cls(bins=10)
        elif case == "str-bins":
            cls(bins="auto")
        elif case == "range":
            cls(bins=bins9, range=(0, 1))
        elif case == "ambiguous-int-list":
            cls(bins=[10, 20])
        elif case == "bad-precision":
            cls(bins=bins9, precision="int2")
        elif case == "too-few-arrays":
            cls(bins=[bins9, bins9]).update(np.zeros(4, "f4"))
        elif case == "result-before-update":
            cls(bins=bins9).result()
        elif case == "kept-axis-changed":
            acc = cls(bins=bins9, axis=1)
            acc.update(np.zeros((3, 8), "f4"))
            acc.update(np.zeros((4, 8), "f4"))
        elif case == "mixed":
            acc = cls(bins=np.array([0.0, 1.0]))
            acc.update(np.array([0.5], "f4"), weights=np.array([2.0], "f4"))
            acc.update(np.array([0.5], "f4"))
        elif case == "offset-length":
            acc = cls(bins=bins9, axis=1)
            acc.update(np.random.RandomState(11).randn(2, 10).astype("f4"),
                       kept_offset=(0, 0))

    got = _raised(lambda: run(StreamingCPU))
    want = _raised(lambda: run(xhistogram_tpu.StreamingHistogram))
    assert want is not None and got == want


def test_streaming_counts_property_and_chaining():
    acc = StreamingCPU(bins=bins9)
    assert acc.counts is None
    out = acc.update(np.array([0.5, 0.6], "f4")).update(np.array([0.7], "f4"))
    assert out is acc
    assert int(acc.counts.sum()) == 3


def test_streaming_int64_accumulation():
    """Counts accumulate in int64 — the reference's dtype contract
    (core.py:363), with no int32 cap across chunks."""
    acc = StreamingCPU(bins=np.array([0.0, 1.0]))
    acc.update(np.full(100, 0.5, "f4"))
    assert acc.counts.dtype == torch.int64
    acc._blocks[()][0] = 2**31  # simulate a huge accumulated total
    acc.update(np.full(3, 0.5, "f4"))
    h, _ = acc.result()
    assert int(h[0]) == 2**31 + 3  # would wrap in int32


def test_streaming_list_edges_accepted():
    accs = _pair(bins=[0.0, 0.5, 1.0])
    _update(accs, np.array([0.25, 0.75, 0.75], "f4"))
    np.testing.assert_array_equal(accs[0].counts.numpy(), [1, 2])
    _assert_same(accs[0].counts, accs[1].counts)
    accs = _pair(bins=[[0.0, 0.5, 1.0], [0.0, 1.0]])
    _update(accs, np.array([0.25], "f4"), np.array([0.5], "f4"))
    assert tuple(accs[0].counts.shape) == (2, 1)
    _assert_same(accs[0].counts, accs[1].counts)


def test_streaming_failed_first_update_does_not_pin_mode():
    for cls in (StreamingCPU, xhistogram_tpu.StreamingHistogram):
        acc = cls(bins=np.array([0.0, 1.0]))
        with pytest.raises(ValueError):
            acc.update(np.zeros(4, "f4"), weights=np.zeros((3, 7), "f4"))
        acc.update(np.array([0.5], "f4"))  # a valid unweighted chunk
        assert int(acc.counts[0]) == 1


# chunked KEPT dims: the reference's blockwise path tiles bystander axes
# natively (reference core.py:418,429-437); kept_offset does the same


def test_streaming_kept_offset_blocks_1d():
    rng = np.random.RandomState(7)
    data = rng.randn(6, 8).astype("f4")
    edges = np.linspace(-2.5, 2.5, 6)
    accs = _pair(bins=edges, axis=1)
    for r0 in (0, 3):
        for c0 in (0, 4):
            _update(accs, data[r0:r0 + 3, c0:c0 + 4], kept_offset=(r0,))
    h, _ = accs[0].result()
    expected = np.stack([np.histogram(r, bins=edges)[0] for r in data])
    np.testing.assert_array_equal(h.numpy(), expected)
    _assert_same(h, accs[1].result()[0])


def test_streaming_kept_offset_uneven_blocks():
    rng = np.random.RandomState(8)
    data = rng.randn(7, 30).astype("f4")
    accs = _pair(bins=bins9, axis=1)
    for r0, r1 in ((0, 2), (2, 7)):
        for ch in chunks(data[r0:r1], 3, 1):
            _update(accs, ch, kept_offset=(r0,))
    h, _ = accs[0].result()
    h_ref, _ = histogram_cpu(data, bins=bins9, axis=1)
    assert torch.equal(h, h_ref)
    _assert_same(h, accs[1].result()[0])


def test_streaming_kept_offset_2d_weighted_density():
    rng = np.random.RandomState(9)
    data = rng.randn(4, 6, 50).astype("f4")
    w = rng.rand(4, 6, 50).astype("f4")
    accs = _pair(bins=bins9, axis=2)
    for r0 in (0, 2):
        for s0 in (0, 3):
            for k in range(2):
                sl = (slice(r0, r0 + 2), slice(s0, s0 + 3),
                      slice(k * 25, (k + 1) * 25))
                _update(accs, data[sl], weights=w[sl], kept_offset=(r0, s0))
    h, _ = accs[0].result(density=True)
    h_ref, _ = histogram_cpu(data, bins=bins9, axis=2, weights=w, density=True)
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), rtol=1e-6)
    _assert_same(h, accs[1].result(density=True)[0], exact=False)


@pytest.mark.parametrize("case", ["gap", "single-nonzero", "single-nonzero-counts"])
def test_streaming_kept_offset_not_tiling_rejected(case):
    rng = np.random.RandomState(10)
    x = [rng.randn(2, 10).astype("f4"), rng.randn(2, 10).astype("f4"),
         rng.randn(3, 10).astype("f4")]

    def run(cls):
        acc = cls(bins=bins9, axis=1)
        if case == "gap":
            acc.update(x[0], kept_offset=(0,))
            acc.update(x[1], kept_offset=(3,))  # gap at 2
            acc.result()
        else:
            # one block at a nonzero kept_offset does not tile the output
            acc.update(x[2], kept_offset=(5,))
            acc.result() if case == "single-nonzero" else acc.counts  # noqa: B018

    got = _raised(lambda: run(StreamingCPU))
    want = _raised(lambda: run(xhistogram_tpu.StreamingHistogram))
    assert got == want and got[0] is ValueError and "tile" in got[1]


def test_streaming_blocks_property_mid_stream():
    """`blocks` exposes per-offset state while the streamed blocks do not
    yet tile (counts raises there); it returns copies, so editing one
    leaves the accumulator as it was."""
    rng = np.random.RandomState(13)
    acc = StreamingCPU(bins=bins9, axis=1)
    assert acc.blocks is None
    x0 = rng.randn(2, 10).astype("f4")
    acc.update(x0, kept_offset=(3,))  # out-of-order arrival
    with pytest.raises(ValueError, match="tile"):
        acc.counts  # noqa: B018
    blocks = acc.blocks
    assert set(blocks) == {(3,)}
    exp0 = np.stack([np.histogram(r.astype("f8"), bins=bins9)[0] for r in x0])
    np.testing.assert_array_equal(blocks[(3,)].numpy(), exp0)
    blocks[(3,)][0, 0] = 99  # a copy: the accumulator is untouched
    np.testing.assert_array_equal(acc.blocks[(3,)].numpy(), exp0)
    acc.update(rng.randn(3, 10).astype("f4"), kept_offset=(0,))
    assert tuple(acc.counts.shape) == (5, len(bins9) - 1)
    counts = acc.counts
    counts[0, 0] = -5  # counts is a copy too
    assert int(acc.counts[0, 0]) != -5


def test_streaming_result_lies_on_the_accumulator_device():
    acc = StreamingCPU(bins=bins9)
    acc.update(np.zeros(3, "f4"))
    h, _ = acc.result()
    assert h.device.type == "cpu"
    assert acc._device == torch.device("cpu")


def test_streaming_needs_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        xhistogram_torch.StreamingHistogram(bins=bins9)
