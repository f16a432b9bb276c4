"""Fused histogram kernels for the GPU, and the routing table between them.

Counterpart of ``xhistogram_tpu.ops.pallas_hist``. ``plan`` is that
module's unweighted routing table copied as host code (no uniform-spacing
certificates: the kernels' bucketed digitize is exact for any thresholds
and needs none), so both packages name the same kernel for the same
unweighted problem, but in the two bands of kept rows past the TPU's cap
that ``plan`` names; weighted calls take the same caps, the port's own
limits, where the JAX package's weighted gates count its TPU kernels'
extra outputs. Every kernel family it names is ported, each a
hand-written CUDA kernel with its plain PyTorch version beside it:
``one_input`` (``csrc/one_input.cuh``), ``joint2`` (``csrc/joint2.cuh``),
``factored`` (``csrc/slot.cuh``: the flat-slot histogram, over every
element or one a kept row, as ``reduce_all`` says) and ``direct``
(``csrc/direct.cuh``: a warp per kept row; outside its envelope the same
flat-slot kernel per kept row). Each ``*_reference`` is the plain
version: digitize, flat slot, bincount.

Every wrapper takes its data as ``(m, c)`` layouts or as the ``(m1, m0,
c1, c0)`` views of ``utils.axes.strided_layout``: kept rows ``r = i1 * m0 +
i0`` and reduced columns ``j = j1 * c0 + j0``, each level at its own stride
(0 for a broadcast), which every kernel reads in place; joint2 reads runs of
contiguous elements at one outer stride an operand and copies only an
operand that has none (``last_launch()["view"]``). Every wrapper takes
``weights=``, a view shaped like the data, and then returns the weighted
sums in ``bincount.weighted_dtype`` of the weights' dtype instead of int64
counts. The weighted kernels
(``csrc/weights.cuh``) add each weight with an atomic in float64 (float
weights) or in 32- or 64-bit integers, in place of the TPU kernels' weight
limbs, Kahan outputs and NaN/inf channels, so every public ``precision=``
runs the same kernel; the flat-slot kernel keeps kept rows' float sums that
pass one block's room for float64 slots as exact integers of a unit 2^u in
shared memory (``exact_integer``). ``validate_public_precision`` keeps the
JAX package's contract for that argument. The direct kernel can also store float sums
finished, as float32 rounded once from float64 (``finish=True``).

The kernels compare float32, float64, int32 and int64 data in its own
type, and uint32 and uint64 data in int64: uint32 widened in registers,
uint64 flipped there (``x ^ 2^63``, the order of ``bins.flip_uint64``)
against int64 thresholds flipped alike, read in place by one_input's own
entries and by the other kernels' mixed entries. bool, 8- and 16-bit
integers, float16 and bfloat16 come with
thresholds in int32, float32 or float16 (``bins.compare_form`` of their
compare type), and every kernel reads them in place at their own width and
widens each value in registers to float32 or int32, exactly, keeping every
comparison (``csrc/narrow.cuh``; the JAX kernels' ``_widen`` does the same
after the load). ``operand_plan`` is the choice, for each kernel and mix
of data dtypes, of the C entry and the thresholds' dtype; every input of
every mix of dtypes is read in place, none is copied: joint2 compares each
input of a pair in its own type (entries for one load type and for the
pairs users pass together, the mixed entry for the rest); factored and
direct read float32 and narrow inputs in any mix through their narrow
entries and every other mix of dtypes through their mixed ones (int64
compared in int64, the rest in float64). Every launch records the dtypes
it read (``last_launch()["loads"]``). A wrapper takes the plain version
only for CPU tensors; for a CUDA tensor it launches the kernel or raises.

Each kernel is a registered torch op, ``torch.ops.xhistogram.one_input``,
``.joint2``, ``.factored`` and ``.direct``
(``torch.library.custom_op``): the op runs the kernel on CUDA tensors and
the plain version on CPU tensors, counts the kernel's launches, and returns
the output in the weights' accumulator class (int64 counts; float64, int32
or int64 sums), which its fake implementation gives for ``torch.compile``.
The wrappers check their operands, call the op, and give the sums their
``weighted_dtype`` (``finish=False`` keeps the accumulators, which a
sharded call adds up across ranks before that one rounding; the direct
op rounds in its kernel when asked). The op
carries no autograd rule: ``core._WeightedSums`` is the gradient, and
``ops/partitioning.py`` gives each op its DTensor sharding rule.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build
from .bincount import bincount2d_scatter, finish_sums, weight_sums
from ..utils.axes import merged_levels
from ..utils.profiling import note_narrow_read, note_one_input_output, note_weighted_slot
from .digitize import digitize_edges, joint_bin_index

__all__ = [
    "plan",
    "operand_plan",
    "OperandPlan",
    "validate_public_precision",
    "WEIGHTED_MODES",
    "one_input",
    "one_input_reference",
    "joint2",
    "joint2_reference",
    "factored",
    "factored_reference",
    "direct",
    "direct_reference",
    "ONE_INPUT_LAUNCHES",
    "JOINT2_LAUNCHES",
    "FACTORED_LAUNCHES",
    "DIRECT_LAUNCHES",
    "MAX_SHARED_SLOTS",
    "MAX_CLUSTER_CTAS",
    "LAYOUT_COPIES",
    "last_launch",
    "note_layout_copy",
    "EXACT_BITS",
    "exact_unit",
    "exact_integer",
    "exact_add",
    "exact_value",
]

_SUB = 8  # the JAX package's sublane rounding, kept so plan() agrees with it
_MAX_EDGES = 32768

#: launches of each CUDA kernel in this process (the CPU path of a wrapper
#: does not count)
ONE_INPUT_LAUNCHES = 0
JOINT2_LAUNCHES = 0
FACTORED_LAUNCHES = 0
DIRECT_LAUNCHES = 0

#: the most slots of a row's histogram that factored and direct keep in
#: shared memory; by default every histogram that fits the 227 KB of the
#: blocks of one cluster (at most eight) beside the thresholds. Beyond, each
#: element adds straight into the int64 output in device memory
#: (csrc/slot.cuh); tools/factored_probe.py and the card-only tests set 0 to
#: time and check that path at any size
MAX_SHARED_SLOTS = 8 * 232448 // 4
#: the most blocks of a cluster whose shared memory joint2, factored and
#: direct spread one histogram over (1, 2, 4 or 8); each launch takes the
#: fewest that hold it (float64 sums, as measured faster: at most two in
#: joint2; in factored and direct only kept rows past one block's room for
#: float64 slots, as exact integers, ``exact_integer``). tools and the
#: card-only tests set 1, 2 and 4 to time and check each cluster size
MAX_CLUSTER_CTAS = 8
_MAX_SLOT_INPUTS = 32  # csrc/slot.cuh and csrc/direct.cuh kMaxInputs
#: the direct-row kernel's envelope (csrc/direct.cuh): rows of at most 255
#: elements, at most 8192 slots, inputs of any dtypes. The direct route runs
#: the flat-slot kernel (csrc/slot.cuh) outside it
_DIRECT_ROWS_MAX_COLS = 255
_DIRECT_ROWS_MAX_SLOTS = 8192
#: the weight dtypes whose finished sums are float32, rounded once from
#: their float64 sums (``bincount.weighted_dtype``)
_ROUNDED = (torch.float16, torch.bfloat16, torch.float32)

_MAX_ONE_INPUT_BINS = 1024  # plan()'s one_input gate, and the kernel's limit

#: the kernels' compare types, by the suffix of their C symbols
_SUFFIX = dict(zip(
    (torch.float32, torch.float64, torch.int32, torch.int64),
    _build.DTYPE_SUFFIXES,
))
#: the thresholds' dtype of each narrow data dtype (``bins.compare_form``),
#: into which every value converts exactly
_NARROW = {
    torch.bool: torch.int32, torch.int8: torch.int32, torch.uint8: torch.int32,
    torch.int16: torch.int32, torch.uint16: torch.int32,
    torch.bfloat16: torch.float32,
}
#: the unsigned types compared in int64, each read at its own width
_UNSIGNED = {torch.uint32: torch.int64, torch.uint64: torch.int64}
#: each data dtype's thresholds' dtype, where it is not the data's own
_THRESHOLDS = {**_NARROW, **_UNSIGNED}
_DATA_DTYPES = (*_NARROW, torch.float16, *_SUFFIX, *_UNSIGNED)
#: the narrow dtypes' load types in the kernels of one narrow type
#: (one_input, joint2; the suffix of their C symbols; bool as its bytes)
_NARROW_SUFFIX = {
    torch.float16: "f16", torch.bfloat16: "bf16", torch.int16: "i16",
    torch.uint16: "u16", torch.int8: "i8", torch.uint8: "u8", torch.bool: "u8",
}
#: the type a narrow dtype read in place is widened to in registers and
#: compared as, in one_input and joint2: float32 for the 16-bit types (int32
#: thresholds round only past 2^24, beyond every 16-bit value, so every
#: comparison is kept), int32 for the 8-bit ones, digitized through a table
#: of their 256 values' bins
_NARROW_COMPARE = {
    torch.float16: torch.float32, torch.bfloat16: torch.float32,
    torch.int16: torch.float32, torch.uint16: torch.float32,
    torch.int8: torch.int32, torch.uint8: torch.int32, torch.bool: torch.int32,
}
#: each data dtype's code in the entries whose inputs carry a run-time
#: stored type (csrc/narrow.cuh's LoadCode)
_LOAD_CODE = {
    torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3,
    torch.float16: 4, torch.bfloat16: 5, torch.int16: 6, torch.uint16: 7,
    torch.int8: 8, torch.uint8: 9, torch.bool: 9, torch.uint32: 10,
    torch.uint64: 11,
}
#: the dtypes the mixed entries compare in int64 (the rest in float64)
_INT64_HELD = (torch.int64, *_UNSIGNED)
#: one_input's load type of each data dtype (the suffix of its C symbols)
#: and the type it compares it in, where not its own
_ONE_INPUT_SUFFIX = {**_NARROW_SUFFIX, **_SUFFIX, torch.uint32: "u32",
                     torch.uint64: "u64"}
_ONE_INPUT_COMPARE = {**_NARROW_COMPARE, **_UNSIGNED}
#: the dtypes the narrow entries of factored and direct read, in any mix,
#: each compared in float32
_FLOAT32_READS = (torch.float32, *_NARROW_SUFFIX)
#: the suffix of each data dtype's load type in joint2's entries (bool as
#: its bytes, uint8)
_LOAD_SUFFIX = {**_NARROW_SUFFIX, **_SUFFIX}
#: the type joint2 compares each data dtype in, whatever the other input's:
#: its own for the wide types, float32 for the 16-bit ones, int32 (through
#: a table of the 256 values' bins) for the 8-bit ones
_JOINT2_COMPARE = {**_NARROW_COMPARE, **{t: t for t in _SUFFIX}}


def _round_up(x, m):
    return -(-x // m) * m


def _pick_factorization(n_slots):
    """The (n1, log2 n2) slot factorization the JAX factored kernels pick
    (pallas_hist._pick_factorization); plan() sizes kept-row outputs by it."""
    best = None
    for log2_n2 in range(3, max(4, n_slots.bit_length() + 1)):
        n2 = 1 << log2_n2
        n1 = _round_up(-(-n_slots // n2), _SUB)
        key = 0.00508 * (n1 * n2) + 0.65 * (n1 + n2)
        if best is None or key < best[0]:
            best = (key, n1, log2_n2)
    return best[1], best[2]


def _fold_factor(m, c):
    if m >= _SUB or m == 0 or c == 0:
        return 1
    return _SUB // m


#: the public ``precision=`` modes (the JAX package's weighted-sum modes);
#: every one runs the same float64-accumulating kernels here
WEIGHTED_MODES = ("split", "highest", "i8", "i8x3")


def _digit_mode(wmode, prefix):
    """N of an internal mode ``"<prefix>N"`` ("int1".."int4" for integer
    weights, "digN" for the JAX package's exact tier), or None."""
    if isinstance(wmode, str) and wmode.startswith(prefix) and wmode[3:].isdigit():
        return int(wmode[3:])
    return None


def validate_public_precision(precision):
    """Raise as ``pallas_hist.validate_public_precision`` does, with its
    messages, for a ``precision=`` that is not a public mode: the internal
    integer modes ("intN", "digN") and anything else outside
    ``WEIGHTED_MODES``. ('f64' is handled before this by the caller.)"""
    if _digit_mode(precision, "int") is not None or _digit_mode(precision, "dig") is not None:
        raise ValueError(
            f"weighted precision mode {precision!r} is internal (derived "
            f"from integer weights); valid values are {WEIGHTED_MODES} "
            "and 'f64'"
        )
    if precision is not None and precision not in WEIGHTED_MODES:
        raise ValueError(
            f"weighted precision mode {precision!r}: valid values are "
            f"{WEIGHTED_MODES}"
        )


def plan(n_inputs, nbins, m, c=None):
    """The kernel for this problem, or ``None`` where the scatter strategy
    runs instead.

    ``m == 1`` means a full reduction. Mirrors the JAX package's unweighted
    ``pallas_hist.planned_kernel`` with no uniform-spacing certificates and
    faithful NaN/inf handling (its default), in every band but two, where
    the JAX package sends kept rows past 2^28 padded slots (rows times its
    factored slot layout) to scatter. That cap sizes its TPU kernels'
    padded slot layout, which the port's kernels do not have:

    - kept rows of one input in 1 to 1024 bins go to one_input at any row
      count, as a full reduction does; one_input writes only its ``(m, nb
      + 1)`` output and reads the view in place;
    - kept rows of fewer than 256 elements over at most 8192 slots (the
      direct-row kernel's envelope, ``csrc/direct.cuh``) go to direct at
      any row count; it writes every slot of its ``(m, S + 1)`` output
      once, reads the view in place and indexes rows in 64 bits.

    ``factored_per_row`` and ``factored_packed`` keep the cap. Weighted
    problems take the same caps: the port's kernels write one output
    whatever the weights, where the JAX package's weighted gates count its
    TPU kernels' NaN/inf channels, Kahan output and integer digit modes
    (removed in the port).
    """
    full_cap, kept_cap = 1 << 21, 1 << 25
    n_slots = math.prod(int(b) for b in nbins) + 1
    edges_ok = sum(nb + 1 for nb in nbins) <= _MAX_EDGES
    if n_inputs == 1 and nbins[0] <= _MAX_ONE_INPUT_BINS:
        return "one_input"  # full or kept rows, at any row count
    if m > 1 and c is not None and c <= _DIRECT_ROWS_MAX_COLS and n_slots <= 8192:
        return "direct"  # the direct-row kernel, at any row count
    if m == 1:
        if not edges_ok:
            return None
        if (
            n_inputs == 2
            and _round_up(nbins[0], _SUB) + _round_up(nbins[1], _SUB) <= 1536
        ):
            return "joint2"
        if n_slots > full_cap:
            return None
        return "factored"

    n1, log2_n2 = _pick_factorization(n_slots)
    padded_slots = max(n1 << log2_n2, _round_up(n_slots, 1024))
    if m * padded_slots > (1 << 28):
        return None
    if n_slots <= kept_cap // 2 and edges_ok and (c is None or c >= 256) and m > 1:
        return "factored_per_row"
    if n_slots <= 8192:
        return "direct"
    rpt = _SUB // _fold_factor(m, c if c is not None else 1)
    if rpt * n_slots <= kept_cap and edges_ok and m > 1:
        return "factored_packed"
    return None


class OperandPlan(NamedTuple):
    """How a kernel takes its inputs (``operand_plan``)."""

    #: the suffix of the C entry: a data type ("f32", "bf16"), joint2's
    #: pair of two ("i16_f32"), or the coded entries "narrow" and "mixed"
    entry: str
    #: the dtype each input is read as: its own, in place, always
    loads: tuple
    #: the dtype each input's thresholds are handed to the kernel in
    compare: tuple
    #: each input's load code (``_LOAD_CODE``) for the coded entries, else
    #: None
    codes: tuple = None


def _mixed_plan(dtypes):
    """The mixed entries' plan: every input read by its load code, int64,
    uint32 and uint64 compared in int64 (uint64 flipped) and every other
    dtype in float64, which holds each of its values exactly."""
    compare = tuple(torch.int64 if d in _INT64_HELD else torch.float64 for d in dtypes)
    return OperandPlan("mixed", dtypes, compare, tuple(_LOAD_CODE[d] for d in dtypes))


def operand_plan(kernel, dtypes):
    """The ``OperandPlan`` of ``kernel`` ("joint2", or "slot" for factored
    and direct) for inputs of ``dtypes``, a pure function of them.

    Every input is read in place at its own width (``loads`` are the
    dtypes), as the JAX kernels read each input's tile and widen it in
    registers; nothing is copied on the card. joint2 compares each input in
    its own type against its own thresholds (``_JOINT2_COMPARE``): one load
    type for both inputs (bool beside uint8 too) and the pairs of
    ``_build.JOINT2_PAIRS`` (each narrow dtype and int32 beside float32,
    float32 beside float64, int32 beside int64, int64 beside a float, in
    both orders) have entries of their own; every other pair takes the
    mixed entry, as does every pair with uint32 or uint64. For "slot" (the
    flat-slot template and the direct-row kernel), inputs of one wide dtype
    take its entry, float32 and narrow inputs in any mix the narrow entries
    (each compared in float32, thresholds in float32), and every other mix,
    uint32 and uint64 included, the mixed ones (int64, uint32 and uint64
    compared in int64, the rest in float64)."""
    dtypes = tuple(dtypes)
    n = len(dtypes)
    if kernel == "joint2" and any(d in _UNSIGNED for d in dtypes):
        return _mixed_plan(dtypes)
    if kernel == "joint2":
        suffixes = tuple(_LOAD_SUFFIX[d] for d in dtypes)
        pair = "_".join(suffixes)
        if suffixes[0] == suffixes[1]:
            pair = suffixes[0]
        elif pair not in _build.JOINT2_PAIRS:
            return _mixed_plan(dtypes)
        return OperandPlan(pair, dtypes, tuple(_JOINT2_COMPARE[d] for d in dtypes))
    if dtypes[0] in _SUFFIX and len(set(dtypes)) == 1:
        return OperandPlan(_SUFFIX[dtypes[0]], dtypes, dtypes)
    if all(d in _FLOAT32_READS for d in dtypes):
        return OperandPlan("narrow", dtypes, (torch.float32,) * n,
                           tuple(_LOAD_CODE[d] for d in dtypes))
    return _mixed_plan(dtypes)


def _check_operands(name, data, thresholds, nbins):
    for x in (*data, *thresholds):
        if x.device != data[0].device:
            raise ValueError(
                f"{name} operands must share a device, got {data[0].device} "
                f"and {x.device}"
            )
    for x, thr, nb in zip(data, thresholds, nbins):
        if x.dtype not in _DATA_DTYPES:
            raise TypeError(
                f"{name} takes {[str(d) for d in _DATA_DTYPES]} data, got {x.dtype}"
            )
        want = _THRESHOLDS.get(x.dtype, x.dtype)
        if thr.dtype != want:
            if want == x.dtype:
                raise TypeError(
                    f"{name} thresholds must be in the data's dtype {x.dtype}, "
                    f"got {thr.dtype}"
                )
            raise TypeError(
                f"{name} thresholds of {x.dtype} data must be in its compare "
                f"dtype {want}, got {thr.dtype}"
            )
        if thr.shape != (nb + 1,):
            raise ValueError(
                f"{name} needs {nb + 1} thresholds, got {tuple(thr.shape)}"
            )
    device = data[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


#: one_input's counter layouts, by their code in the launch record
#: (csrc/one_input.cuh): per-lane private counters, warp replicas added with
#: 32-bit shared atomics, warp-owned copies added by __match_any_sync leaders
ONE_INPUT_LAYOUTS = {1: "lane-private", 2: "warp replicas", 3: "aggregated"}
#: (the dtypes the last launch read, its device, whether an operand was
#: copied for its layout)
_LAST_LOADS = [None]
#: copies of operands made for a kernel's layout in this process: by
#: ``core`` where a side of the call needs three or more levels
#: (``note_layout_copy``), and by joint2 for an operand with no contiguous
#: runs
LAYOUT_COPIES = 0
_COPY_PENDING = [False]  # core copied the operands of the next launch


def note_layout_copy(n_operands):
    """Record that the caller copied ``n_operands`` operands into a
    contiguous layout for the next launch (``LAYOUT_COPIES``, and
    ``last_launch()["view"]`` of that launch)."""
    global LAYOUT_COPIES
    LAYOUT_COPIES += n_operands
    _COPY_PENDING[0] = True


def _record(loads, device, copied=False):
    """The launch record's loads, device and layout, for ``last_launch``."""
    _LAST_LOADS[0] = (loads, device, copied or _COPY_PENDING[0])
    _COPY_PENDING[0] = False


def _note_in_place(inputs):
    """Count the inputs of a 1- or 2-byte stored type that a launch just
    read at their own width (``profiling.NARROW_READS["in_place"]``)."""
    n = sum(x.element_size() <= 2 for x in inputs)
    if n:
        note_narrow_read("in_place", n)


_WIDEST = {}  # per device: one int32 the one_input kernel writes L into
#: the 16 bytes of scratch of the last flat-slot launch whose float sums were
#: exact (``csrc/slot.cuh``: the largest |weight|, then the elements whose
#: weight added as a float)
_EXACT_SCRATCH = [None]


def _launch_record():
    """``xh_last_launch``'s thirteen ints (``csrc/launch.cuh``), read on the
    host."""
    out = (ctypes.c_int * 13)()
    _build.load().xh_last_launch(out)
    return out


def last_launch():
    """What the last launch of this process chose (``xh_last_launch``).

    Every kernel: ``loads``, the dtype it read each input as (the input's
    own dtype, read in place: ``operand_plan``). joint2,
    factored and direct: ``cluster`` (blocks whose shared memory
    held the histogram, 1 to 8), ``passes`` over the data (joint2's chunks
    of T rows), ``shared`` (False: the histogram was in device memory) and
    ``cells`` (the cell-table sizes asked for the first two inputs;
    ``ops.digitize.bucket_table`` gives the table the kernel built).
    ``view`` is "in place" where the kernel read every operand where the
    caller's tensor lies, and "copied" where an operand was copied first
    (``LAYOUT_COPIES``). ``kernel`` names which: "direct_rows"
    (``csrc/direct.cuh``) adds
    ``warps_per_row`` (1: a warp owns its row), ``warps_per_block``,
    ``blocks`` and ``rows_per_warp`` (the most rows a warp walked).
    one_input adds its counter ``layout`` (one of ``ONE_INPUT_LAYOUTS``'
    names), ``copies`` (the histogram's copies in shared memory: one per
    lane, per warp, or replicas), ``blocks`` (its grid), ``load`` (the
    dtype it read), ``zeroed`` (whether its launcher zeroed the output
    before the kernel, for a full reduction or rows split across column
    tiles; else the kernel stored every slot) and ``widest``, the widest
    window L of the cell table its first block built (K is ``cells[0]``);
    reading ``widest`` synchronises with the card. ``exact`` says whether a
    flat-slot launch kept its float sums as exact integers in shared memory
    (``exact_integer``), and then ``fell_back`` counts the elements whose
    weight added as a float instead; reading it synchronises with the card."""
    out = _launch_record()
    kernel = "one_input" if out[5] else "direct_rows" if out[8] else "joint2/slot"
    loads, device, copied = _LAST_LOADS[0]
    rec = {"kernel": kernel, "cluster": out[0], "passes": out[1],
           "shared": bool(out[2]), "cells": (out[3], out[4]), "loads": loads,
           "view": "copied" if copied else "in place", "exact": bool(out[11])}
    if out[11]:
        rec["fell_back"] = int(_EXACT_SCRATCH[0][1].item())
    if out[8]:
        rec.update(warps_per_row=1, warps_per_block=out[8], blocks=out[9],
                   rows_per_warp=out[10])
    if out[5]:
        rec.update(layout=ONE_INPUT_LAYOUTS[out[6]], copies=out[7], blocks=out[9],
                   load=loads[0], zeroed=bool(out[12]),
                   widest=int(_WIDEST[device].item()))
    return rec


#: each weight dtype's accumulator class (csrc/weights.cuh), and the code of
#: its stored type within the class
_WEIGHT_CLASS = {
    torch.float32: ("wf64", 0), torch.float64: ("wf64", 1),
    torch.float16: ("wf64", 2), torch.bfloat16: ("wf64", 3),
    torch.int32: ("wu32", 0), torch.uint32: ("wu32", 0),
    torch.int16: ("wu32", 1), torch.uint16: ("wu32", 2),
    torch.int8: ("wu32", 3), torch.uint8: ("wu32", 4), torch.bool: ("wu32", 4),
    torch.int64: ("wu64", 0), torch.uint64: ("wu64", 0),
}
# the dtype of each class's output buffer (double, 32- and 64-bit words)
_CLASS_OUT = {"wf64": torch.float64, "wu32": torch.int32, "wu64": torch.int64}


def _check_weights(name, weights, data):
    if weights.shape != data.shape:
        raise ValueError(
            f"{name} weights must be shaped like the data {tuple(data.shape)}, "
            f"got {tuple(weights.shape)}"
        )
    if weights.dtype not in _WEIGHT_CLASS:
        raise TypeError(
            f"{name} takes {[str(d) for d in _WEIGHT_CLASS]} weights, got "
            f"{weights.dtype}"
        )
    if weights.device != data.device:
        raise ValueError(
            f"{name} weights must lie on the data's device {data.device}, got "
            f"{weights.device}"
        )


# --- exact float sums (csrc/weights.cuh's Exact), as plain Python -------------
# The flat-slot kernel keeps kept rows' float sums past one block's room for
# float64 slots as integers of a unit 2^u in 32-bit words in shared memory,
# each word's wraps added into the float64 output as they happen: these
# mirror its rules on Python numbers, for the tests.

_WORD = (1 << 32) - 1
#: the bits of an exact weight's integer (csrc/weights.cuh kExactBits)
EXACT_BITS = 32


def exact_unit(amax):
    """u of the unit 2^u for weights whose largest finite magnitude is
    ``amax``: every ``|w| <= amax`` is below 2^(u + EXACT_BITS), and
    ``amax`` itself at least 2^(u + EXACT_BITS - 1); 0 when ``amax`` is 0."""
    return math.frexp(amax)[1] - EXACT_BITS if amax > 0 else 0


def exact_integer(w, u):
    """``w / 2^u`` as an int where the weight ``w`` adds exactly under the
    unit 2^u (a finite whole multiple of it below 2^(u + EXACT_BITS) in
    magnitude), else None: NaN, infinities and weights with set bits below
    2^u add as float64s."""
    if not math.isfinite(w):
        return None
    q = math.ldexp(w, -u)
    if abs(q) >= 1 << EXACT_BITS or q != math.trunc(q) or (q == 0 and w != 0):
        return None
    return int(q)


def exact_add(word, n):
    """``(word, wrap)`` after adding the integer ``n`` (``|n| < 2^32``) to a
    32-bit word as the kernel does: ``n`` modulo 2^32 onto the word, and
    ``wrap`` the multiple of 2^32 that left it (+1 a carry past 2^32 - 1, -1
    a negative add's borrow below 0, else 0), which the kernel adds, times
    2^(u + 32), into the output. ``word + 2^32 * (sum of wraps)`` is the sum
    of the adds."""
    add = n & _WORD
    carry = word + add > _WORD
    wrap = 0 if carry == (n < 0) else -1 if n < 0 else 1
    return (word + add) & _WORD, wrap


def exact_value(word, wraps, u):
    """What a slot's adds put into the output: its word at the flush, times
    2^u, and its wraps, each 2^(u + 32), added in float64 (exact while the
    sum stays below 2^(u + 53) in magnitude)."""
    return math.ldexp(float(word), u) + math.ldexp(float(wraps), u + 32)


def _out_dtype(weights):
    """The dtype of a kernel's output: int64 counts, or the weights' class's
    accumulators."""
    if weights is None:
        return torch.int64
    return _CLASS_OUT[_WEIGHT_CLASS[weights.dtype][0]]


def _weight_args(weights, strides=None):
    """(suffix of the kernel's weighted C entry, the weights' arguments:
    pointer, the four strides ``strides`` of its view as a C array where
    the entry reads one, type code), or ("", []) unweighted."""
    if weights is None:
        return "", []
    cls, code = _WEIGHT_CLASS[weights.dtype]
    view = [] if strides is None else [(ctypes.c_int64 * 4)(*strides)]
    return f"_{cls}", [weights.data_ptr(), *view, code]


def _dims(x):
    """``((m1, m0, c1, c0), strides)`` of a kernel operand: a 4-D view as
    it is, an ``(m, c)`` layout as ``(1, m, 1, c)``."""
    if x.ndim == 2:
        (m, c), (sm, sc) = x.shape, x.stride()
        return (1, m, 1, c), (0, sm, 0, sc)
    return tuple(x.shape), tuple(x.stride())


def _geometry(x, reduce_all):
    """``_dims`` as a kernel walks them: the one row of a full reduction
    with two column levels as ``c1`` rows of ``c0`` columns (every row is
    summed), so its tiles may span the runs."""
    dims, st = _dims(x)
    if reduce_all and dims[0] * dims[1] == 1:
        return (1, dims[2], 1, dims[3]), (0, st[2], 0, st[3])
    return dims, st


def _rows(x, reduce_all):
    """The leading dims of a kernel's output: one row for a full
    reduction, else the kept rows, ``(m,)`` of a layout, ``(m1, m0)`` of a
    view."""
    if reduce_all:
        return (1,)
    return tuple(x.shape[:-2]) if x.ndim == 4 else (x.shape[0],)


def _flat(x):
    """An operand as the plain version reads it: an ``(m, c)`` layout
    (a view's elements in its order, copied where they do not merge)."""
    if x.ndim == 2:
        return x
    m1, m0, c1, c0 = x.shape
    return x.reshape(m1 * m0, c1 * c0)


def _check_layout(name, x):
    if x.ndim not in (2, 4):
        raise ValueError(
            f"{name} takes a 2-D layout, or an (m1, m0, c1, c0) view, got shape "
            f"{tuple(x.shape)}"
        )


def _finish(out, weights):
    """The kernel's output as the wrapper returns it: counts, or sums in
    their ``weighted_dtype``."""
    return out if weights is None else finish_sums(out, weights.dtype)


def _slot_sums_reference(arrays_2d, thresholds, nbins, reduce_all, weights=None):
    """The plain version of every kernel: digitize each input, flat slot,
    bincount. ``(1 if reduce_all else m, prod(nbins) + 1)`` int64 counts,
    or sums of ``weights`` (shaped like the data) in their accumulator
    class's dtype (``_out_dtype``), as a kernel writes them; the trailing
    trash slot is zero, as the JAX kernels return. ``(m1, m0, c1, c0)``
    views give ``(m1, m0, prod(nbins) + 1)`` per kept row, as the ops do."""
    rows = _rows(arrays_2d[0], reduce_all)
    indices = [digitize_edges(_flat(a), t) for a, t in zip(arrays_2d, thresholds)]
    g, n_slots = joint_bin_index(indices, nbins)
    if reduce_all:
        g = g.reshape(1, -1)
    if weights is None:
        counts = bincount2d_scatter(g, n_slots)
        counts[:, -1] = 0
        return counts.reshape(*rows, n_slots)
    sums = weight_sums(g, n_slots, _flat(weights).reshape(g.shape))
    sums[:, -1] = 0
    return sums.to(_out_dtype(weights)).reshape(*rows, n_slots)


def _slot_counts_reference(arrays_2d, thresholds, nbins, reduce_all,
                           weights=None):
    """``_slot_sums_reference`` with the sums in their ``weighted_dtype``,
    one row a kept row: ``(1 if reduce_all else m, prod(nbins) + 1)``."""
    sums = _slot_sums_reference(arrays_2d, thresholds, nbins, reduce_all, weights)
    return _finish(sums.reshape(-1, sums.shape[-1]), weights)


def one_input_reference(a2d, thr, nb, reduce_all, weights=None):
    """Plain PyTorch one_input, with ``one_input``'s contract
    (``pallas_hist._run_one_input``'s counts)."""
    return _slot_counts_reference([a2d], [thr], [nb], reduce_all, weights)


def one_input(a2d, thr, nb, reduce_all, weights=None, finish=True):
    """Histogram of one input's ``(m, c)`` layout or ``(m1, m0, c1, c0)``
    view, per kept row or over all rows.

    ``thr`` is the compare-form thresholds
    (``bins.compare_form(edges, dtype).edges`` with ``n_hi_clip == 0``)
    as a tensor on ``a2d``'s device, in ``a2d``'s dtype, or in its compare
    dtype for narrow data (int32 for bool and 8- and 16-bit integers,
    float32 for bfloat16); ``nb`` (at most 1024) is the bin count, one
    fewer than the thresholds. ``a2d`` may have any strides: the kernel
    reads the view in place, narrow data and uint32 and uint64 at their own
    width. Returns
    ``(1 if reduce_all else m, nb + 1)`` int64 counts with a zero trailing
    trash slot; with ``weights`` (shaped like ``a2d``, any strides, read in
    place), the sums of the weights in their ``weighted_dtype`` instead
    (``finish=False``: in their accumulator class, as the op
    ``xhistogram::one_input`` returns them).

    A CUDA tensor launches the CUDA kernel, and any failure raises (a
    narrow input never widens and retries). A CPU tensor runs
    ``one_input_reference``.
    """
    _check_layout("one_input", a2d)
    if not 1 <= nb <= _MAX_ONE_INPUT_BINS:
        raise ValueError(
            f"one_input takes 1 to {_MAX_ONE_INPUT_BINS} bins, got {nb}"
        )
    _check_operands("one_input", [a2d], [thr], [nb])
    if weights is not None:
        _check_weights("one_input", weights, a2d)
    out = torch.ops.xhistogram.one_input(a2d, thr, weights, nb, bool(reduce_all))
    out = out.reshape(-1, nb + 1)
    return _finish(out, weights) if finish else out


@torch.library.custom_op(
    "xhistogram::one_input", mutates_args=(),
    schema="(Tensor a2d, Tensor thr, Tensor? weights, int nb, bool reduce_all) -> Tensor",
)
def _one_input_op(a2d, thr, weights, nb, reduce_all):
    """The one_input kernel (its plain version on CPU tensors), with its
    output in the weights' accumulator class."""
    global ONE_INPUT_LAUNCHES
    if a2d.device.type == "cpu":
        return _slot_sums_reference([a2d], [thr], [nb], reduce_all, weights)
    thr = thr.to(_ONE_INPUT_COMPARE.get(a2d.dtype, thr.dtype)).contiguous()
    shape = (*_rows(a2d, reduce_all), nb + 1)
    if a2d.numel() == 0:
        return torch.zeros(shape, dtype=_out_dtype(weights), device=a2d.device)
    # every slot of the output is stored by the kernel or zeroed by its
    # launcher
    out = torch.empty(shape, dtype=_out_dtype(weights), device=a2d.device)
    dims, strides = _geometry(a2d, reduce_all)
    suffix, w_args = _weight_args(
        weights, None if weights is None else _geometry(weights, reduce_all)[1])
    widest = _WIDEST.get(a2d.device)
    if widest is None:
        widest = _WIDEST[a2d.device] = torch.zeros(1, dtype=torch.int32,
                                                   device=a2d.device)
    fn = getattr(_build.load(), f"xh_one_input_{_ONE_INPUT_SUFFIX[a2d.dtype]}{suffix}")
    _record((a2d.dtype,), a2d.device)
    with torch.cuda.device(a2d.device):
        rc = fn(
            a2d.data_ptr(), (ctypes.c_int64 * 4)(*dims), (ctypes.c_int64 * 4)(*strides),
            thr.data_ptr(), nb, int(reduce_all), *w_args, out.data_ptr(),
            widest.data_ptr(), _stream(a2d.device),
        )
    if rc != 0:
        raise RuntimeError(f"one_input CUDA kernel failed to launch: cudaError {rc}")
    ONE_INPUT_LAUNCHES += 1
    _note_in_place([a2d])
    note_one_input_output("zeroed" if _launch_record()[12] else "stored")
    return out


@_one_input_op.register_fake
def _(a2d, thr, weights, nb, reduce_all):
    return a2d.new_empty((*_rows(a2d, reduce_all), nb + 1), dtype=_out_dtype(weights))


def joint2_reference(a, b, thr_a, thr_b, nba, nbb, weights=None):
    """Plain PyTorch joint2, with ``joint2``'s contract
    (``pallas_hist._run_joint2``'s counts)."""
    return _slot_counts_reference(
        [a.reshape(1, -1), b.reshape(1, -1)], [thr_a, thr_b], [nba, nbb], True,
        None if weights is None else weights.reshape(1, -1),
    )


def joint2(a, b, thr_a, thr_b, nba, nbb, weights=None, finish=True):
    """Joint histogram of the pairs ``(a[e], b[e])`` over all elements.

    ``thr_a``/``thr_b`` are the compare-form thresholds
    (``bins.compare_form(edges, x.dtype).edges`` with ``n_hi_clip == 0``)
    as tensors in their input's dtype on the data's device; ``nba``/``nbb``
    are the bin counts (one fewer than the thresholds). ``a``, ``b`` and
    ``weights`` may be views of any one shape: the kernel reads runs of
    contiguous elements at one outer stride an operand (``_joint2_runs``:
    a full reduction of a contiguous, halo-trimmed or broadcast-weighted
    field), and copies only an operand that has none. Returns
    ``(1, nba * nbb + 1)`` int64 counts with a zero trailing trash slot;
    with ``weights`` (shaped like ``a``), the sums of the weights in their
    ``weighted_dtype`` instead (``finish=False``: in their accumulator
    class, as the op ``xhistogram::joint2`` returns them).

    ``a`` and ``b`` may hold narrow data (bool, 8- and 16-bit integers,
    float16, bfloat16) with thresholds in its compare dtype (int32 for the
    integers, float32 for bfloat16, float16 for float16), each its own. A
    CUDA tensor launches the CUDA kernel, and any failure raises (no input
    widens and retries): each input is read in place at its own width and
    compared in its own type, by the entry of its pair of dtypes
    (``csrc/joint2_narrow.cu``, ``joint2_pairs.cu``,
    ``joint2_pairs_swapped.cu``) or by the mixed entry
    (``csrc/joint2_mixed.cu``; ``operand_plan``). A CPU tensor runs
    ``joint2_reference``.
    """
    if a.numel() != b.numel():
        raise ValueError(
            f"joint2 needs equally many elements, got {a.numel()} and {b.numel()}"
        )
    _check_operands("joint2", [a, b], [thr_a, thr_b], [nba, nbb])
    if weights is not None:
        _check_weights("joint2", weights, a)
    out = torch.ops.xhistogram.joint2(a, b, thr_a, thr_b, weights, nba, nbb)
    return _finish(out, weights) if finish else out


@torch.library.custom_op(
    "xhistogram::joint2", mutates_args=(),
    schema="(Tensor a, Tensor b, Tensor thr_a, Tensor thr_b, Tensor? weights, "
           "int nba, int nbb) -> Tensor",
)
def _joint2_op(a, b, thr_a, thr_b, weights, nba, nbb):
    """The joint2 kernel (its plain version on CPU tensors), with its output
    in the weights' accumulator class."""
    global JOINT2_LAUNCHES
    if a.device.type == "cpu":
        return _slot_sums_reference(
            [a.reshape(1, -1), b.reshape(1, -1)], [thr_a, thr_b], [nba, nbb], True,
            None if weights is None else weights.reshape(1, -1),
        )
    op = operand_plan("joint2", (a.dtype, b.dtype))
    thr_a, thr_b = (x.to(t).contiguous() for x, t in zip((thr_a, thr_b), op.compare))
    out = torch.zeros(1, nba * nbb + 1, dtype=_out_dtype(weights), device=a.device)
    if a.numel() == 0:
        return out
    global LAYOUT_COPIES
    operands = [a, b] if weights is None else [a, b, weights]
    operands, (g, n), outer, copied = _joint2_runs(operands)
    LAYOUT_COPIES += copied
    a, b = operands[:2]
    weights = operands[2] if weights is not None else None
    runs = (ctypes.c_int64 * 5)(g, n, *outer)
    suffix, w_args = _weight_args(weights)
    fn = getattr(_build.load(), f"xh_joint2_{op.entry}{suffix}")
    _record(op.loads, a.device, copied > 0)
    with torch.cuda.device(a.device):
        rc = fn(
            *_codes_arg(op), a.data_ptr(), b.data_ptr(), runs,
            thr_a.data_ptr(), nba, thr_b.data_ptr(), nbb, MAX_CLUSTER_CTAS,
            *w_args, out.data_ptr(), _stream(a.device),
        )
    if rc != 0:
        raise RuntimeError(f"joint2 CUDA kernel failed to launch: cudaError {rc}")
    JOINT2_LAUNCHES += 1
    _note_in_place([a, b])
    return out


@_joint2_op.register_fake
def _(a, b, thr_a, thr_b, weights, nba, nbb):
    return a.new_empty((1, nba * nbb + 1), dtype=_out_dtype(weights))


def _check_slot_operands(name, arrays_2d, thresholds, nbins, weights):
    if not 1 <= len(arrays_2d) == len(thresholds) == len(nbins):
        raise ValueError(
            f"{name} needs one threshold tensor and one bin count per input, "
            f"got {len(arrays_2d)} inputs, {len(thresholds)} threshold "
            f"tensors and {len(nbins)} bin counts"
        )
    shape = arrays_2d[0].shape
    if len(shape) not in (2, 4) or any(a.shape != shape for a in arrays_2d):
        raise ValueError(
            f"{name} takes 2-D layouts of one shape, or (m1, m0, c1, c0) views, "
            f"got {[tuple(a.shape) for a in arrays_2d]}"
        )
    if any(nb < 1 for nb in nbins):
        raise ValueError(f"{name} needs at least one bin per input, got {nbins}")
    _check_operands(name, arrays_2d, thresholds, nbins)
    if weights is not None:
        _check_weights(name, weights, arrays_2d[0])


def _slot_operands(name, arrays_2d, thresholds):
    """(plan, arrays, thresholds) as a flat-slot or direct-row kernel reads
    them: ``operand_plan("slot", ...)``, the inputs as they are (each read
    in place with its own strides, a broadcast staying one) and the
    thresholds in the plan's compare dtypes."""
    if len(arrays_2d) > _MAX_SLOT_INPUTS:
        raise NotImplementedError(
            f"the {name} CUDA kernel takes at most {_MAX_SLOT_INPUTS} inputs, "
            f"got {len(arrays_2d)}"
        )
    op = operand_plan("slot", [a.dtype for a in arrays_2d])
    thr = [t.to(c).contiguous() for t, c in zip(thresholds, op.compare)]
    return op, list(arrays_2d), thr


def _codes_arg(op):
    """The coded entries' argument of each input's load code, as a C
    array, or none."""
    return [] if op.codes is None else [(ctypes.c_int * len(op.codes))(*op.codes)]


def _joint2_runs(operands):
    """``(operands, (g, n), outer strides, copied)``: joint2's operands (of
    one shape) as ``g`` runs of ``n`` contiguous elements, run ``k`` of
    operand ``i`` at ``k * outer[i]``; size-1 axes dropped and adjacent axes
    merged where every operand's strides allow, as ``utils.axes`` merges
    them. An operand that leaves more than two levels, or whose inner level
    is not contiguous (a broadcast or a step along it), is copied
    (``.contiguous()``; ``copied`` counts them); the rest are read in place.
    """
    shape = operands[0].shape
    keep = [d for d, size in enumerate(shape) if size != 1]
    copied = 0
    while True:
        levels = merged_levels(keep, shape, [o.stride() for o in operands])
        inner = levels[-1][-1] if levels else None
        bad = [len(levels) > 2 or (inner is not None and o.stride(inner) != 1)
               for o in operands]
        if not any(bad):
            break
        operands = [o.contiguous() if b else o for o, b in zip(operands, bad)]
        copied += sum(bad)
    sizes = [math.prod(shape[d] for d in level) for level in levels]
    if len(sizes) < 2:
        return operands, (1, max(sizes, default=1)), [0] * 3, copied
    outer = [o.stride(levels[0][-1]) for o in operands] + [0] * (3 - len(operands))
    return operands, tuple(sizes), outer, copied


def _launch_slot_entry(name, fn, lead, arrays, thr, nbins, reduce_all, tail, out):
    """Calls a flat-slot C entry: ``lead`` arguments, the inputs' pointers,
    strides (four each), thresholds and bin counts, (m1, m0, c1, c0), then
    ``tail`` and the output and stream. Raises on a failed launch; counts
    the narrow inputs it read in place."""
    n = len(arrays)
    views = [_geometry(a, reduce_all) for a in arrays]
    with torch.cuda.device(out.device):
        rc = fn(
            *lead,
            (ctypes.c_void_p * n)(*(a.data_ptr() for a in arrays)),
            (ctypes.c_int64 * (4 * n))(*(s for _, st in views for s in st)),
            (ctypes.c_void_p * n)(*(t.data_ptr() for t in thr)),
            (ctypes.c_int * n)(*nbins),
            (ctypes.c_int64 * 4)(*views[0][0]), *tail, out.data_ptr(),
            _stream(out.device),
        )
    if rc != 0:
        raise RuntimeError(f"{name} CUDA kernel failed to launch: cudaError {rc}")
    _note_in_place(arrays)


def _slot_hist_cuda(name, arrays_2d, thresholds, nbins, reduce_all, weights):
    """(counts or weighted sums in their accumulator class, launches) of the
    flat-slot kernel (``csrc/slot.cuh``, the ``xh_slot_*`` entries) on CUDA
    tensors, with the operands of ``_slot_operands``; any failure raises."""
    op, arrays, thr = _slot_operands(name, arrays_2d, thresholds)
    n = len(arrays)
    shape = (*_rows(arrays[0], reduce_all), math.prod(nbins) + 1)
    if arrays[0].numel() == 0:
        return torch.zeros(shape, dtype=_out_dtype(weights), device=arrays[0].device), 0
    # every slot of the output is written by the kernel or zeroed by its
    # launcher
    out = torch.empty(shape, dtype=_out_dtype(weights), device=arrays[0].device)
    suffix, w_args = _weight_args(
        weights, None if weights is None else _geometry(weights, reduce_all)[1])
    scratch = None
    if weights is not None and _WEIGHT_CLASS[weights.dtype][0] == "wf64" and not reduce_all:
        # where the kernel keeps float sums exact (its launcher zeroes it)
        scratch = torch.empty(2, dtype=torch.int64, device=out.device)
    _record(op.loads, out.device)
    _launch_slot_entry(name, getattr(_build.load(), f"xh_slot_{op.entry}{suffix}"),
                       [n, *_codes_arg(op)], arrays, thr, nbins, reduce_all,
                       [int(reduce_all), MAX_SHARED_SLOTS, MAX_CLUSTER_CTAS, *w_args,
                        *([] if weights is None else
                          [None if scratch is None else scratch.data_ptr()])], out)
    if weights is not None:
        rec = _launch_record()
        if rec[11]:
            _EXACT_SCRATCH[0] = scratch
        note_weighted_slot("exact" if rec[11] else "shared" if rec[2] else "device")
    return out, 1


def factored_reference(arrays_2d, thresholds, nbins, reduce_all, weights=None):
    """Plain PyTorch factored, with ``factored``'s contract
    (``pallas_hist._run_factored``'s counts)."""
    return _slot_counts_reference(arrays_2d, thresholds, nbins, reduce_all, weights)


def factored(arrays_2d, thresholds, nbins, reduce_all, weights=None, finish=True):
    """Joint histogram of N inputs over all elements (``reduce_all``) or per
    kept row: the routes ``factored`` (``reduce_all``), ``factored_per_row``
    and ``factored_packed`` of ``plan``, which run the same kernel.

    ``arrays_2d`` are N ``(m, c)`` layouts or ``(m1, m0, c1, c0)`` views of
    one shape, with any strides (broadcast inputs keep their zero strides;
    the kernel reads every view in place); ``thresholds[k]`` is input k's compare-form thresholds
    (``bins.compare_form(edges, dtype).edges`` with ``n_hi_clip == 0``) in
    its dtype on its device, ``nbins[k]`` its bin count. Returns
    ``(1 if reduce_all else m, prod(nbins) + 1)`` int64 counts with
    a zero trailing trash slot; with ``weights`` (an ``(m, c)`` view with
    any strides, read in place like the data), the sums of the weights in
    their ``weighted_dtype`` instead (``finish=False``: in their
    accumulator class, as the op ``xhistogram::factored`` returns them).

    A CUDA tensor launches the CUDA kernel (``csrc/slot.cu``), and any
    failure raises. Every input is read in place at its own width: inputs
    of one wide dtype by its entry; float32 and narrow inputs (bool, 8- and
    16-bit integers, float16, bfloat16; thresholds in their compare dtype)
    in any mix by the narrow entry (``csrc/slot_narrow.cu``, each compared
    in float32); every other mix by the mixed entry
    (``csrc/slot_mixed.cu``: int64 compared in int64, the rest in float64)
    (``operand_plan``). A CPU tensor runs ``factored_reference``.
    """
    _check_slot_operands("factored", arrays_2d, thresholds, nbins, weights)
    out = torch.ops.xhistogram.factored(list(arrays_2d), list(thresholds), weights,
                                        [int(nb) for nb in nbins], bool(reduce_all))
    out = out.reshape(-1, out.shape[-1])
    return _finish(out, weights) if finish else out


@torch.library.custom_op(
    "xhistogram::factored", mutates_args=(),
    schema="(Tensor[] arrays, Tensor[] thresholds, Tensor? weights, int[] nbins, "
           "bool reduce_all) -> Tensor",
)
def _factored_op(arrays, thresholds, weights, nbins, reduce_all):
    """The factored kernel (its plain version on CPU tensors), with its
    output in the weights' accumulator class."""
    global FACTORED_LAUNCHES
    if arrays[0].device.type == "cpu":
        return _slot_sums_reference(arrays, thresholds, nbins, reduce_all, weights)
    out, launched = _slot_hist_cuda("factored", arrays, thresholds, nbins, reduce_all,
                                    weights)
    FACTORED_LAUNCHES += launched
    return out


@_factored_op.register_fake
def _(arrays, thresholds, weights, nbins, reduce_all):
    return arrays[0].new_empty((*_rows(arrays[0], reduce_all), math.prod(nbins) + 1),
                               dtype=_out_dtype(weights))


def _rounds(weights, finish):
    """Whether the direct op stores finished sums of ``weights`` as float32
    rounded from float64 (float weights narrower than float64)."""
    return finish and weights is not None and weights.dtype in _ROUNDED


def direct_reference(arrays_2d, thresholds, nbins, weights=None, finish=True):
    """Plain PyTorch direct, with ``direct``'s contract
    (``pallas_hist._run_direct``'s counts): float64 sums of float weights,
    then, with ``finish``, ``finish_sums`` (float32 rounded once)."""
    sums = _slot_sums_reference(arrays_2d, thresholds, nbins, False, weights)
    sums = sums.reshape(-1, sums.shape[-1])
    return _finish(sums, weights) if finish else sums


def direct(arrays_2d, thresholds, nbins, weights=None, finish=True):
    """Joint histogram of N inputs per kept row: the route ``direct`` of
    ``plan`` (narrow rows, few slots) and every kept-row call forced onto
    the kernels outside ``plan``'s envelopes.

    Arguments as for ``factored``. Returns ``(m, prod(nbins) + 1)`` int64
    counts (or weighted sums) with a zero trailing trash slot. A CUDA
    tensor launches a CUDA kernel, and any failure raises: rows of at most
    255 elements over at most 8192 slots run ``csrc/direct.cuh`` (a warp
    per row; float sums are rounded to float32 as each row is stored,
    unless ``finish=False``), with the entries of ``operand_plan("slot",
    ...)`` (``direct_rows_narrow.cu``, ``direct_rows_mixed.cu`` for inputs
    of several types, each read in place); the rest the flat-slot kernel
    per kept row, as ``factored`` runs it. A CPU tensor runs
    ``direct_reference``.
    """
    _check_slot_operands("direct", arrays_2d, thresholds, nbins, weights)
    out = torch.ops.xhistogram.direct(list(arrays_2d), list(thresholds), weights,
                                      [int(nb) for nb in nbins], bool(finish))
    out = out.reshape(-1, out.shape[-1])
    return _finish(out, weights) if finish else out


def _direct_rows_cuda(arrays_2d, thresholds, nbins, weights, rounds):
    """(counts or weighted sums, launches) of the direct-row kernel
    (``csrc/direct.cuh``) on CUDA tensors, in the weights' accumulator
    class or, where ``rounds``, float32; any failure raises."""
    op, arrays, thr = _slot_operands("direct", arrays_2d, thresholds)
    dtype = torch.float32 if rounds else _out_dtype(weights)
    shape = (*_rows(arrays[0], False), math.prod(nbins) + 1)
    if arrays[0].numel() == 0:
        return torch.zeros(shape, dtype=dtype, device=arrays[0].device), 0
    out = torch.empty(shape, dtype=dtype, device=arrays[0].device)  # every slot written
    suffix, w_args = _weight_args(weights, None if weights is None else _dims(weights)[1])
    if rounds:
        suffix = f"_{_build.ROUNDED_CLASS}"
    _record(op.loads, out.device)
    _launch_slot_entry("direct",
                       getattr(_build.load(), f"xh_direct_rows_{op.entry}{suffix}"),
                       [len(arrays), *_codes_arg(op)], arrays, thr, nbins, False,
                       w_args, out)
    return out, 1


@torch.library.custom_op(
    "xhistogram::direct", mutates_args=(),
    schema="(Tensor[] arrays, Tensor[] thresholds, Tensor? weights, int[] nbins, "
           "bool finish=False) -> Tensor",
)
def _direct_op(arrays, thresholds, weights, nbins, finish=False):
    """The direct kernel (its plain version on CPU tensors), with its output
    in the weights' accumulator class, or, with ``finish``, the float32
    sums of float weights narrower than float64."""
    global DIRECT_LAUNCHES
    rounds = _rounds(weights, finish)
    if arrays[0].device.type == "cpu":
        out = _slot_sums_reference(arrays, thresholds, nbins, False, weights)
        return out.to(torch.float32) if rounds else out
    cols = math.prod(_dims(arrays[0])[0][2:])
    if cols <= _DIRECT_ROWS_MAX_COLS and math.prod(nbins) <= _DIRECT_ROWS_MAX_SLOTS:
        out, launched = _direct_rows_cuda(arrays, thresholds, nbins, weights, rounds)
    else:
        out, launched = _slot_hist_cuda("direct", arrays, thresholds, nbins, False,
                                        weights)
        if rounds:
            out = out.to(torch.float32)
    DIRECT_LAUNCHES += launched
    return out


@_direct_op.register_fake
def _(arrays, thresholds, weights, nbins, finish=False):
    dtype = torch.float32 if _rounds(weights, finish) else _out_dtype(weights)
    return arrays[0].new_empty((*_rows(arrays[0], False), math.prod(nbins) + 1),
                               dtype=dtype)
