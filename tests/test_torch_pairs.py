"""Inputs of two dtypes, each read in place, against the JAX package.

The JAX kernels read each input of a pair at its own width and widen its
tile in registers, one input at a time (``pallas_hist._joint2_kernel``,
``_widen``), so a pair of two dtypes costs no copy there. The port's kernels
do the same for every mix of the eleven data dtypes: joint2 compares each
input in its own type, with entries of its own for the pairs users pass
together (each narrow dtype and int32 beside float32, float32 beside
float64, int32 beside int64; ``csrc/joint2_pairs.cu``,
``joint2_pairs_swapped.cu``) and a mixed entry, whose inputs carry a
run-time load code, for the rest (``csrc/joint2_mixed.cu``); factored and
direct read every mix through their narrow and mixed entries.
``cuda_hist.operand_plan``, a pure host function, is that choice: here it is
held, for every ordered pair of the eleven dtypes and for triples, to read
every input in place, to compare each in a type that holds its every value
exactly, and to name an entry the sources define. On the CPU each wrapper
runs its plain version, the one the kernels are held to on the card
(tests/test_torch_gpu.py, chip_smoke.py); the public call on joint2's route
must give the JAX package's ``_joint2_kernel`` result under the Pallas
interpreter, counts and integer sums bit for bit, float sums within the JAX
package's ``'highest'`` bound (rtol 3e-7, atol 1e-6), for the compile-time
pairs and a sample of the rest, each unweighted and with a weight of each
accumulator class. tests/test_torch_pairs_routes.py does the same on the
flat-slot routes.
"""

import itertools
import re
from pathlib import Path

import pytest
import torch

import xhistogram_torch
from xhistogram_torch.ops import _build, cuda_hist
from pair_cases import (
    COMPILED_PAIRS, DTYPES, PUBLIC_PAIRS, TORCH, WEIGHT_DTYPES, assert_matches_jax,
    data_of, edges_of,
)

# --- the host's choice of entry, load and compare types ----------------------

def _source_symbols():
    """The C entries the sources under csrc/ define by name (count entries,
    and joint2's pairs written as XH_JOINT2_PAIR)."""
    names = set()
    for path in (Path(cuda_hist.__file__).parent.parent / "csrc").glob("*.cu"):
        text = path.read_text()
        names |= set(re.findall(r"\b(xh_[a-z0-9_]*[a-z0-9])\b", text))
        for sa, sb in re.findall(r"XH_JOINT2_PAIR\((\w+),[^,]+,[^,]+,\s*(\w+),", text):
            names.add(f"xh_joint2_{sa}_{sb}")
    return names


_SOURCES = _source_symbols()
_DECLARED = {name for name, _ in _build.symbols()}


def _every_value(dtype):
    """Every value of an 8- or 16-bit dtype (every bit pattern of float16
    and bfloat16), else its extremes and a spread of values between."""
    if dtype == torch.bool:
        return torch.tensor([False, True])
    if dtype in (torch.float16, torch.bfloat16):
        return torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16).view(dtype)
    if dtype.itemsize <= 2:
        info = torch.iinfo(dtype)
        return torch.arange(info.min, info.max + 1, dtype=torch.int32).to(dtype)
    gen = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        info = torch.finfo(dtype)
        spread = torch.randn(4096, generator=gen, dtype=torch.float64) * 1e3
        special = torch.tensor([info.min, info.max, info.tiny, info.tiny / 4, -0.0,
                                float("inf"), -float("inf"), float("nan")],
                               dtype=torch.float64)
        return torch.cat([spread, special]).to(dtype)
    info = torch.iinfo(dtype)
    spread = torch.randint(info.min, info.max, (4096,), generator=gen, dtype=torch.int64)
    return torch.cat([spread, torch.tensor([info.min, info.max, -1, 0, 1])]).to(dtype)


def _holds_exactly(dtype, cmp):
    v = _every_value(dtype)
    back = v.to(cmp).to(dtype)
    if dtype.is_floating_point:
        nan = torch.isnan(v)
        return torch.equal(torch.isnan(back), nan) and torch.equal(back[~nan], v[~nan])
    return torch.equal(back, v)


_EXACT = {(d, c): _holds_exactly(d, c) for d in TORCH.values()
          for c in (torch.float32, torch.float64, torch.int32, torch.int64)}


def _check_plan(kernel, dtypes):
    op = cuda_hist.operand_plan(kernel, dtypes)
    assert op.loads == dtypes, (kernel, dtypes, op)
    assert len(op.compare) == len(dtypes)
    for d, cmp in zip(dtypes, op.compare):
        assert _EXACT[d, cmp], (kernel, dtypes, d, cmp)
    if op.entry in ("narrow", "mixed"):
        assert op.codes == tuple(cuda_hist._LOAD_CODE[d] for d in dtypes)
    else:
        assert op.codes is None
    if kernel == "joint2":
        names = [f"xh_joint2_{op.entry}"]
    else:
        names = [f"xh_{kernel}_{op.entry}" for kernel in ("slot", "direct_rows")]
    for name in names:
        assert name in _DECLARED and name in _SOURCES, (kernel, dtypes, name)
    return op


@pytest.mark.parametrize("kernel", ["joint2", "slot"])
@pytest.mark.parametrize("first", list(DTYPES))
def test_operand_plan_reads_every_pair_in_place(kernel, first):
    """Every ordered pair with ``first`` (and, for the flat-slot kernels,
    triples): each input read as its own dtype, compared in a type that
    holds its every value, by an entry the sources define and the library
    declares."""
    for second in DTYPES:
        _check_plan(kernel, (TORCH[first], TORCH[second]))
        if kernel == "slot":
            for third in ("float32", "int64", "int8", "bfloat16"):
                _check_plan(kernel, (TORCH[first], TORCH[second], TORCH[third]))
    if kernel == "joint2":
        # one load type (bool beside uint8 too), the pairs with entries of
        # their own, each input in its own compare type, and the mixed entry
        for second in DTYPES:
            pair = (TORCH[first], TORCH[second])
            op = cuda_hist.operand_plan("joint2", pair)
            loads = tuple(cuda_hist._LOAD_SUFFIX[d] for d in pair)
            if loads[0] == loads[1]:
                assert op.entry == loads[0]
            elif "_".join(loads) in _build.JOINT2_PAIRS:
                assert op.entry == "_".join(loads)
            else:
                assert op.entry == "mixed", pair
                assert op.compare == tuple(torch.int64 if d == torch.int64 else torch.float64
                                           for d in pair)
            if op.entry != "mixed":
                assert op.compare == tuple(cuda_hist._JOINT2_COMPARE[d] for d in pair)


def test_every_pair_entry_is_built():
    """Each of joint2's pairs with an entry of its own has its count entry
    and one per accumulator class, declared and in the sources, and the
    compile-time pairs are exactly the users' pairs and int64 beside a
    float."""
    suffix = cuda_hist._LOAD_SUFFIX
    want = {"_".join(suffix[TORCH[d]] for d in pair) for pair in COMPILED_PAIRS}
    want |= {"i64_f32", "f32_i64", "i64_f64", "f64_i64"}
    assert set(_build.JOINT2_PAIRS) == want
    for pair in _build.JOINT2_PAIRS:
        for cls in ("", *(f"_{c}" for c in _build.WEIGHT_CLASSES)):
            assert f"xh_joint2_{pair}{cls}" in _DECLARED
        assert f"xh_joint2_{pair}" in _SOURCES
    for cls in ("", *(f"_{c}" for c in _build.WEIGHT_CLASSES)):
        assert f"xh_joint2_mixed{cls}" in _DECLARED
        assert f"xh_direct_rows_mixed{cls}" in _DECLARED
    assert f"xh_direct_rows_mixed_{_build.ROUNDED_CLASS}" in _DECLARED


@pytest.mark.parametrize("wdtype", WEIGHT_DTYPES,
                         ids=lambda v: getattr(v, "__name__", str(v)))
@pytest.mark.parametrize("pair", PUBLIC_PAIRS, ids="-".join)
def test_joint2_pairs_match_the_jax_kernel(monkeypatch, pair, wdtype):
    """joint2's route: each compile-time pair and a sample of the mixed
    ones, unweighted and with a weight of each accumulator class, equals
    the JAX package's ``_joint2_kernel``."""
    assert_matches_jax(monkeypatch, pair, "joint2", (2, 300), None, (12, 15), wdtype,
                       seed=PUBLIC_PAIRS.index(pair))


@pytest.mark.parametrize("pair", list(itertools.permutations(DTYPES, 2))[::7],
                         ids="-".join)
def test_plain_joint2_of_a_pair_equals_the_widened_pair(pair):
    """The plain version the card is held to gives a pair of two dtypes the
    counts of the same pair widened first to float64 (int64 as itself), a
    spread of every pair's order."""
    shape, nbins = (3, 257), (9, 11)
    bins = [edges_of(name, nb, seed=k) for k, (name, nb) in enumerate(zip(pair, nbins))]
    args = [data_of(name, shape, e, 5 + k)[0] for k, (name, e) in enumerate(zip(pair, bins))]
    wide = [a if a.dtype == torch.int64 else a.to(torch.float64) for a in args]
    h, _ = xhistogram_torch.histogram(*args, bins=bins, method="cuda", device="cpu")
    h_wide, _ = xhistogram_torch.histogram(*wide, bins=bins, method="cuda", device="cpu")
    assert torch.equal(h, h_wide)
