"""Exact float sums of the flat-slot kernel (``csrc/weights.cuh``'s
``Exact``), through their plain mirror in ``ops/cuda_hist.py``.

Past one block's room for float64 slots the kernel keeps kept rows' float
sums in shared memory as integers of a unit 2^u: the unit from the largest
finite |weight|, each weight that is a whole multiple of it added as an
integer to its slot's 32-bit word, whose wraps go to the float64 output, the
rest added as float64s. The card tests hold the
kernel to the plain version (tests/test_torch_gpu.py); here the rules are
held to Python integers and to the plain version's sums, on the CPU.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from xhistogram_torch import bins as tbins
from xhistogram_torch.ops import cuda_hist
from xhistogram_torch.ops.digitize import digitize_edges, joint_bin_index
from xhistogram_torch.utils import profiling

WORD = 1 << 32
BITS = cuda_hist.EXACT_BITS  # an exact weight's integer lies below 2^BITS
# a float32's 24 bits lie above the unit 2^u within 2^SPAN of the largest
SPAN = BITS - 24
# ECCO v4r4's largest cell volume: the equator's 0.5-degree cell area times
# its deepest layer, 456.5 m, as float32
ECCO_AMAX = float(np.float32(3.0912e9 * 456.5))
# largest weights as float32 holds them (the subnormal 2^-149 among them)
AMAXES = [float(np.float32(x)) for x in (1.0, 0.75, 3.0, 2.0**31, 2.0**-149,
                                         np.finfo(np.float32).max, ECCO_AMAX, 1e-30,
                                         6.02e23)]


@pytest.mark.parametrize("amax", AMAXES, ids=repr)
def test_the_unit_bounds_every_weight_to_its_bits(amax):
    u = cuda_hist.exact_unit(amax)
    assert BITS <= 32
    assert 2.0 ** (u + BITS - 1) <= amax < 2.0 ** (u + BITS)
    # a float32's 24 bits lie above 2^u: its integer is its top BITS bits
    w = cuda_hist.exact_integer(amax, u)
    assert w is not None and 1 << (BITS - 1) <= w < 1 << BITS
    assert Fraction(w) * Fraction(2) ** u == Fraction(amax)
    assert cuda_hist.exact_integer(-amax, u) == -w


def test_the_unit_of_no_weight():
    assert cuda_hist.exact_unit(0.0) == 0
    assert cuda_hist.exact_integer(0.0, 0) == 0
    assert cuda_hist.exact_integer(-0.0, 0) == 0
    assert cuda_hist.exact_integer(1.0, 0) == 1


def test_ecco_s_unit():
    # 1.41e12 m^3 lies in [2^40, 2^41): u = 41 - BITS, and volumes of
    # 2^(u + 23) m^3 up are exact whatever their low bits
    u = cuda_hist.exact_unit(ECCO_AMAX)
    assert u == 41 - BITS
    rng = np.random.default_rng(19)
    big = rng.uniform(2.0 ** (u + 23), ECCO_AMAX, 10_000).astype(np.float32)
    assert all(cuda_hist.exact_integer(float(v), u) is not None for v in big)


@pytest.mark.parametrize("spread", [0, SPAN // 2, SPAN], ids=lambda s: f"2^-{s}")
@pytest.mark.parametrize("amax", [1.0, 3.5, ECCO_AMAX], ids=repr)
def test_float32_weights_within_2_to_the_span_of_the_largest_are_exact(amax, spread):
    u = cuda_hist.exact_unit(amax)
    rng = np.random.default_rng(spread)
    low = np.float32(amax * 2.0**-spread)
    lo_exp = math.frexp(float(low))[1]
    w = rng.uniform(2.0 ** (lo_exp - 1), amax, 5_000).astype(np.float32)
    w = w[w >= 2.0 ** (math.frexp(amax)[1] - 1 - SPAN)]
    for v in map(float, w):
        got = cuda_hist.exact_integer(v, u)
        assert got is not None and Fraction(got) * Fraction(2) ** u == Fraction(v)


@pytest.mark.parametrize("kind", ["float32", "float64 multiples of 2^-36"])
def test_weights_past_the_span_below_the_largest_may_fall_back(kind):
    amax = 1.0
    u = cuda_hist.exact_unit(amax)
    rng = np.random.default_rng(3)
    if kind == "float32":
        w = rng.uniform(0, 2.0**-12, 10_000).astype(np.float32)
    else:  # some whole multiples of the unit 2^(1 - BITS)
        w = rng.integers(1, 1 << 20, 10_000) * 2.0**-36
    got = [cuda_hist.exact_integer(float(v), u) for v in w]
    fell = sum(g is None for g in got)
    assert 0 < fell < len(w)
    for v, g in zip(map(float, w), got):
        # exact where it is a whole multiple of 2^u, and only there
        multiple = Fraction(v) / Fraction(2) ** u
        assert (g is not None) == (multiple.denominator == 1)


@pytest.mark.parametrize("w", [math.nan, math.inf, -math.inf, 2.0**-40, -(2.0**-40),
                               2.0 ** (1 - BITS) * 1.5, 5e-324])
def test_what_falls_back(w):
    assert cuda_hist.exact_integer(w, cuda_hist.exact_unit(1.0)) is None


def test_negative_weights_are_negative_integers():
    u = cuda_hist.exact_unit(2.0)
    assert cuda_hist.exact_integer(-2.0, u) == -(1 << (BITS - 1))
    assert cuda_hist.exact_integer(-0.25, u) == -(1 << (BITS - 4))
    # past the unit's range (a weight above the largest): not exact
    assert cuda_hist.exact_integer(4.0, u) is None


def _run_words(adds, word=0):
    """The word after ``adds``, and the sum of their wraps and their count."""
    wraps = touched = 0
    for n in adds:
        new, wrap = cuda_hist.exact_add(word, n)
        assert wrap in (-1, 0, 1) and 0 <= new < WORD
        wraps += wrap
        touched += wrap != 0
        word = new
    return word, wraps, touched


@pytest.mark.parametrize("signs", ["positive", "negative", "mixed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_word_and_its_wraps_add_as_integers(signs, seed):
    rng = np.random.default_rng(seed)
    n = [int(x) for x in rng.integers(1, WORD, 3_000)]
    if signs == "negative":
        n = [-x for x in n]
    elif signs == "mixed":
        n = [x if rng.random() < 0.5 else -x for x in n]
    word, wraps, touched = _run_words(n)
    assert word + WORD * wraps == sum(n)
    # a wrap is a carry up or a borrow: some adds of these sizes, never one
    # of small adds of one sign
    assert 0 < touched < len(n)
    assert _run_words([5] * 1000)[2] == 0
    assert _run_words([-5] * 1000, word=10_000)[2] == 0


def test_the_word_carries_and_borrows_across_zero():
    assert cuda_hist.exact_add(WORD - 1, 1) == (0, 1)
    assert cuda_hist.exact_add(0, -1) == (WORD - 1, -1)
    assert cuda_hist.exact_add(WORD - 1, -(WORD - 1)) == (0, 0)
    assert cuda_hist.exact_add(5, -5) == (0, 0)
    assert cuda_hist.exact_add(4, -5) == (WORD - 1, -1)
    assert cuda_hist.exact_add(WORD - 2, WORD - 1) == (WORD - 3, 1)


def test_a_slot_takes_any_number_of_adds():
    # one slot taking the largest integer again and again wraps its word at
    # almost every add, and word and wraps stay exact: no bound on the adds
    # between flushes
    word, wraps, touched = _run_words([WORD - 1] * 50_000)
    assert word + WORD * wraps == 50_000 * (WORD - 1) and touched == 49_999
    word, wraps, _ = _run_words([-(WORD - 1), 1] * 20_000)
    assert word + WORD * wraps == -20_000 * (WORD - 2)
    # ECCO's largest volume 4096 times over, through the kernel's rule
    u = cuda_hist.exact_unit(ECCO_AMAX)
    n = cuda_hist.exact_integer(ECCO_AMAX, u)
    word, wraps = 0, 0
    for _ in range(1 << 12):
        word, wrap = cuda_hist.exact_add(word, n)
        wraps += wrap
    assert math.ldexp(word + WORD * wraps, u) == 4096 * ECCO_AMAX
    assert cuda_hist.exact_value(word, wraps, u) == 4096 * ECCO_AMAX


def test_the_output_rounds_only_past_2_to_the_53_units():
    u = -20
    word, wraps, _ = _run_words([3, (1 << 31) + 1, -7])
    assert cuda_hist.exact_value(word, wraps, u) == math.ldexp((1 << 31) - 3, u)
    word, wraps, _ = _run_words([-3, -(WORD - 1), 2])
    assert cuda_hist.exact_value(word, wraps, u) == math.ldexp(-WORD, u)
    # past 2^53 units a float64 sum rounds, as a float64 atomic's does
    big = (1 << 62) + 5
    word, wraps = big & (WORD - 1), big >> 32
    assert cuda_hist.exact_value(word, wraps, 0) == float(big)


def _mirror_sums(g, weights, n_slots):
    """The kernel's sums by its rules, per (row, slot): every counted
    element's weight as an integer of the unit on a 32-bit word whose wraps
    go to the output, or, where it falls back, added as a float64; each
    slot's word flushed once."""
    w = weights.to(torch.float64)
    finite = w[torch.isfinite(w)]
    u = cuda_hist.exact_unit(float(finite.abs().max()) if finite.numel() else 0.0)
    words, wraps, floats = {}, {}, {}
    fell = 0
    for (r, j), v in np.ndenumerate(g.numpy()):
        if v == n_slots - 1:  # the trash slot: NaN or out of range
            continue
        wv = float(w[r, j])
        n = cuda_hist.exact_integer(wv, u)
        if n is None:
            floats[r, v] = floats.get((r, v), 0.0) + wv
            fell += 1
        elif n != 0:
            words[r, v], wrap = cuda_hist.exact_add(words.get((r, v), 0), n)
            wraps[r, v] = wraps.get((r, v), 0) + wrap
    out = torch.zeros(g.shape[0], n_slots, dtype=torch.float64)
    for (r, v), word in words.items():
        out[r, v] += cuda_hist.exact_value(word, wraps[r, v], u)
    for (r, v), x in floats.items():
        out[r, v] += x
    return out, fell


@pytest.mark.parametrize("signs", ["positive", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16,
                                   torch.bfloat16], ids=str)
def test_the_mirror_matches_the_plain_reference(dtype, signs):
    rng = np.random.default_rng(7)
    m, c = 6, 400
    layouts = [torch.from_numpy(rng.normal(0, 1.2, (m, c)).astype(np.float32))
               for _ in range(2)]
    layouts[0][:, ::13] = math.nan  # land: never counted
    edges = [np.linspace(-3, 3, 9), np.linspace(-3, 3, 7)]
    thr = [torch.from_numpy(tbins.compare_form(e, np.float32).edges) for e in edges]
    nbins = [len(e) - 1 for e in edges]
    # weights over 2^16 of their largest, so some fall back; NaN and inf
    w = rng.uniform(0, 1, (m, c)) * 2.0 ** rng.integers(-16, 1, (m, c))
    if signs == "mixed":
        w *= rng.choice([-1.0, 1.0], (m, c))
    weights = torch.from_numpy(w).to(dtype)
    weights[0, 1], weights[1, 2], weights[2, 3], weights[2, 4] = (
        math.nan, math.inf, math.inf, -math.inf)
    g, n_slots = joint_bin_index([digitize_edges(a, t) for a, t in zip(layouts, thr)],
                                 nbins)
    got, fell = _mirror_sums(g, weights, n_slots)
    got[:, -1] = 0
    want = cuda_hist._slot_sums_reference(layouts, thr, nbins, False, weights)
    assert want.dtype == torch.float64
    assert fell > 0
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-300, equal_nan=True)
    assert torch.isnan(got).sum() >= 1 and torch.isinf(got).sum() >= 1


def test_the_placement_counter():
    before = dict(profiling.WEIGHTED_SLOTS)
    profiling.note_weighted_slot("exact")
    profiling.note_weighted_slot("device")
    after = profiling.WEIGHTED_SLOTS
    assert {k: after[k] - before[k] for k in after} == {"exact": 1, "shared": 0,
                                                        "device": 1}
    with pytest.raises(KeyError):
        profiling.note_weighted_slot("elsewhere")
