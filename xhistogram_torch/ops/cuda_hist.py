"""Fused histogram kernels for the GPU, and the routing table between them.

Counterpart of ``xhistogram_tpu.ops.pallas_hist``. ``plan`` is that
module's routing table copied as host code (unweighted and weighted, no
uniform-spacing certificates yet), so both packages name the same kernel
for the same problem. Every kernel family it names is ported, each a
hand-written CUDA kernel with its plain PyTorch version beside it:
``one_input`` (``csrc/one_input.cu``), ``joint2`` (``csrc/joint2.cu``),
``factored`` in its three variants (``csrc/factored.cu``) and ``direct``
(``csrc/direct.cu``); the last two share the flat-slot histogram of
``csrc/slot.cuh``. Each ``*_reference`` is the plain version: digitize,
flat slot, bincount.

Every wrapper takes ``weights=``, an ``(m, c)`` view shaped like the data,
and then returns the weighted sums in ``bincount.weighted_dtype`` of the
weights' dtype instead of int64 counts. The weighted kernels
(``csrc/weights.cuh``) add each weight with an atomic in float64 (float
weights) or in 32- or 64-bit integers, in place of the TPU kernels' weight
limbs, Kahan outputs and NaN/inf channels, so every public ``precision=``
runs the same kernel. ``validate_public_precision`` keeps the JAX package's
contract for that argument.

The kernels compare in the data's own type: float32, float64, int32 or
int64. float16 data and its thresholds widen to float32 first, which is
exact and keeps every comparison (the JAX package's ``_dispatch`` does the
same); inputs of several dtypes all widen to the narrowest type that holds
each exactly. A wrapper takes the plain version only for CPU tensors; for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .bincount import bincount2d_scatter, finish_sums, weight_sums
from .digitize import digitize_edges, joint_bin_index

__all__ = [
    "plan",
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
]

_SUB = 8  # the JAX package's sublane rounding, kept so plan() agrees with it
_MAX_EDGES = 32768

#: launches of each CUDA kernel in this process (the CPU path of a wrapper
#: does not count)
ONE_INPUT_LAUNCHES = 0
JOINT2_LAUNCHES = 0
#: by variant: "full", "per_row", "packed"
FACTORED_LAUNCHES = {"full": 0, "per_row": 0, "packed": 0}
DIRECT_LAUNCHES = 0

#: the most slots of a row's histogram that factored and direct keep in
#: shared memory; by default every histogram that fits a block's 227 KB
#: beside the thresholds. Beyond, each element adds straight into the int64
#: output in device memory (csrc/slot.cuh); tools/factored_probe.py and the
#: card-only tests set 0 to time and check that path at any size
MAX_SHARED_SLOTS = 232448 // 4
_MAX_SLOT_INPUTS = 32  # csrc/slot.cuh kMaxInputs

_MAX_ONE_INPUT_BINS = 1024  # plan()'s one_input gate, and the kernel's limit

#: the kernels' compare types, by the suffix of their C symbols
_SUFFIX = dict(zip(
    (torch.float32, torch.float64, torch.int32, torch.int64),
    _build.DTYPE_SUFFIXES,
))
_DATA_DTYPES = (torch.float16, *_SUFFIX)

# the dtypes each data dtype converts to exactly, comparisons unchanged
_EXACT_WIDENINGS = {
    torch.float16: (torch.float32, torch.float64),
    torch.float32: (torch.float32, torch.float64),
    torch.float64: (torch.float64,),
    torch.int32: (torch.int32, torch.int64, torch.float64),
    torch.int64: (torch.int64,),
}


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
# the JAX package's weighted full-reduction slot caps by mode
# (pallas_hist._weighted_full_cap), kept so plan() agrees with it
_WEIGHTED_FULL_CAP = {"split": 1 << 18, "highest": 1 << 18, "i8": 1 << 19,
                      "i8x3": 1 << 19}


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


def _weighted_gates(weights_dtype, wmode):
    """(full-reduction slot cap, per-slot outputs) that the JAX package's
    weighted kernels have for these weights: float weights carry three
    NaN/inf channel outputs and, in 'highest', a Kahan one
    (``_weighted_extra_outputs``), and their cap is per mode; integer
    weights ride the "intN" digit modes, N (1-4) set by their span
    (``intweights.device_digits``, 4 when unknown), with one output."""
    if weights_dtype.is_floating_point:
        mode = "split" if wmode is None else wmode
        return _WEIGHTED_FULL_CAP[mode], 1 + (mode == "highest") + 3
    n = _digit_mode(wmode, "int") or 4
    return 1 << max(18, min(20, 21 - n)), 1


def plan(n_inputs, nbins, m, c=None, weights_dtype=None, wmode=None):
    """The kernel the JAX package runs for this problem, or ``None`` where
    it runs its scatter strategy instead.

    ``m == 1`` means a full reduction. ``weights_dtype`` (a torch dtype)
    makes it a weighted problem, with ``wmode`` the public ``precision=``
    for float weights (None: 'split') or "int1".."int4" for integer
    weights. Mirrors ``pallas_hist.planned_kernel`` with no uniform-spacing
    certificates and faithful NaN/inf handling (the JAX package's default).
    """
    weighted = weights_dtype is not None
    full_cap, n_outs = (
        _weighted_gates(weights_dtype, wmode) if weighted else (1 << 21, 1)
    )
    kept_cap = (1 << 24) if weighted else (1 << 25)
    n_slots = math.prod(int(b) for b in nbins) + 1
    edges_ok = sum(nb + 1 for nb in nbins) <= _MAX_EDGES
    if m == 1:
        if n_inputs == 1 and nbins[0] <= 1024:
            return "one_input"
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
    if m * padded_slots * n_outs > (1 << 28):
        return None
    if n_inputs == 1 and nbins[0] <= 1024:
        return "one_input"
    if n_slots <= kept_cap // 2 and edges_ok and (c is None or c >= 256) and m > 1:
        return "factored_per_row"
    if n_slots <= 8192:
        return "direct"
    rpt = _SUB // _fold_factor(m, c if c is not None else 1)
    if rpt * n_slots <= kept_cap and edges_ok and m > 1:
        return "factored_packed"
    return None


def _compare_dtype(dtypes):
    """The narrowest kernel compare type every one of ``dtypes`` converts
    to exactly, or None."""
    for t in _SUFFIX:
        if all(t in _EXACT_WIDENINGS[d] for d in dtypes):
            return t
    return None


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
        if thr.dtype != x.dtype:
            raise TypeError(
                f"{name} thresholds must be in the data's dtype {x.dtype}, got "
                f"{thr.dtype}"
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


def _out_dtype(weights):
    """The dtype of a kernel's output: int64 counts, or the weights' class's
    accumulators."""
    if weights is None:
        return torch.int64
    return _CLASS_OUT[_WEIGHT_CLASS[weights.dtype][0]]


def _weight_args(weights, strides=True):
    """(suffix of the kernel's weighted C entry, the weights' arguments:
    pointer, strides if the entry reads a view, type code), or ("", [])
    unweighted."""
    if weights is None:
        return "", []
    cls, code = _WEIGHT_CLASS[weights.dtype]
    return f"_{cls}", [weights.data_ptr(), *(weights.stride() if strides else ()), code]


def _finish(out, weights):
    """The kernel's output as the wrapper returns it: counts, or sums in
    their ``weighted_dtype``."""
    return out if weights is None else finish_sums(out, weights.dtype)


def _slot_counts_reference(arrays_2d, thresholds, nbins, reduce_all,
                           weights=None):
    """The plain version of every kernel: digitize each input, flat slot,
    bincount. ``(1 if reduce_all else m, prod(nbins) + 1)`` int64 counts,
    or sums of ``weights`` (shaped like the data) in their
    ``weighted_dtype``, whose trailing trash slot is zero, as the JAX
    kernels return."""
    indices = [digitize_edges(a, t) for a, t in zip(arrays_2d, thresholds)]
    g, n_slots = joint_bin_index(indices, nbins)
    if reduce_all:
        g = g.reshape(1, -1)
    if weights is None:
        counts = bincount2d_scatter(g, n_slots)
        counts[:, -1] = 0
        return counts
    sums = weight_sums(g, n_slots, weights.reshape(g.shape))
    sums[:, -1] = 0
    return finish_sums(sums, weights.dtype)


def one_input_reference(a2d, thr, nb, reduce_all, weights=None):
    """Plain PyTorch one_input, with ``one_input``'s contract
    (``pallas_hist._run_one_input``'s counts)."""
    return _slot_counts_reference([a2d], [thr], [nb], reduce_all, weights)


def one_input(a2d, thr, nb, reduce_all, weights=None):
    """Histogram of one input's ``(m, c)`` layout, per row or over all rows.

    ``thr`` is the compare-form thresholds
    (``bins.compare_form(edges, a2d.dtype).edges`` with ``n_hi_clip == 0``)
    as a tensor in ``a2d``'s dtype on its device; ``nb`` (at most 1024) is
    the bin count, one fewer than the thresholds. ``a2d`` may have any
    strides: the kernel reads the view in place. Returns
    ``(1 if reduce_all else m, nb + 1)`` int64 counts with a zero trailing
    trash slot; with ``weights`` (shaped like ``a2d``, any strides, read in
    place), the sums of the weights in their ``weighted_dtype`` instead.

    A CUDA tensor launches the CUDA kernel, and any failure raises. A CPU
    tensor runs ``one_input_reference``.
    """
    global ONE_INPUT_LAUNCHES
    if a2d.ndim != 2:
        raise ValueError(f"one_input takes a 2-D layout, got shape {tuple(a2d.shape)}")
    if not 1 <= nb <= _MAX_ONE_INPUT_BINS:
        raise ValueError(
            f"one_input takes 1 to {_MAX_ONE_INPUT_BINS} bins, got {nb}"
        )
    _check_operands("one_input", [a2d], [thr], [nb])
    if weights is not None:
        _check_weights("one_input", weights, a2d)
    if a2d.device.type == "cpu":
        return one_input_reference(a2d, thr, nb, reduce_all, weights)

    dtype = _compare_dtype((a2d.dtype,))  # float16 widens to float32
    a2d, thr = a2d.to(dtype), thr.to(dtype).contiguous()
    m, c = a2d.shape
    out = torch.zeros(1 if reduce_all else m, nb + 1, dtype=_out_dtype(weights),
                      device=a2d.device)
    if a2d.numel() == 0:
        return _finish(out, weights)
    suffix, w_args = _weight_args(weights)
    fn = getattr(_build.load(), f"xh_one_input_{_SUFFIX[dtype]}{suffix}")
    with torch.cuda.device(a2d.device):
        rc = fn(
            a2d.data_ptr(), m, c, a2d.stride(0), a2d.stride(1),
            thr.data_ptr(), nb, int(bool(reduce_all)), *w_args, out.data_ptr(),
            _stream(a2d.device),
        )
    if rc != 0:
        raise RuntimeError(f"one_input CUDA kernel failed to launch: cudaError {rc}")
    ONE_INPUT_LAUNCHES += 1
    return _finish(out, weights)


def joint2_reference(a, b, thr_a, thr_b, nba, nbb, weights=None):
    """Plain PyTorch joint2, with ``joint2``'s contract
    (``pallas_hist._run_joint2``'s counts)."""
    return _slot_counts_reference(
        [a.reshape(1, -1), b.reshape(1, -1)], [thr_a, thr_b], [nba, nbb], True,
        None if weights is None else weights.reshape(1, -1),
    )


def joint2(a, b, thr_a, thr_b, nba, nbb, weights=None):
    """Joint histogram of the pairs ``(a[e], b[e])`` over all elements.

    ``thr_a``/``thr_b`` are the compare-form thresholds
    (``bins.compare_form(edges, x.dtype).edges`` with ``n_hi_clip == 0``)
    as tensors in their input's dtype on the data's device; ``nba``/``nbb``
    are the bin counts (one fewer than the thresholds). Returns
    ``(1, nba * nbb + 1)`` int64 counts with a zero trailing trash slot;
    with ``weights`` (shaped like ``a``; read contiguously, so a strided or
    broadcast weight is copied first), the sums of the weights in their
    ``weighted_dtype`` instead.

    A CUDA tensor launches the CUDA kernel, and any failure raises. Inputs
    of two dtypes both widen to the narrowest compare type that holds each
    exactly (float32 with int32 compares in float64); a pair with no such
    type (int64 with a float) raises ``NotImplementedError``. A CPU tensor
    runs ``joint2_reference``.
    """
    global JOINT2_LAUNCHES
    if a.numel() != b.numel():
        raise ValueError(
            f"joint2 needs equally many elements, got {a.numel()} and {b.numel()}"
        )
    _check_operands("joint2", [a, b], [thr_a, thr_b], [nba, nbb])
    if weights is not None:
        _check_weights("joint2", weights, a)
    if a.device.type == "cpu":
        return joint2_reference(a, b, thr_a, thr_b, nba, nbb, weights)

    dtype = _compare_dtype((a.dtype, b.dtype))
    if dtype is None:
        raise NotImplementedError(
            f"joint2 has no exact common compare type for {a.dtype} and "
            f"{b.dtype} data (ROADMAP queue 2, item 1)"
        )
    # .contiguous() copies only a non-contiguous input, at the cost of a full
    # pass over it; the main path's views are contiguous and pass through
    a, b, thr_a, thr_b = (
        x.to(dtype).contiguous() for x in (a, b, thr_a, thr_b)
    )
    out = torch.zeros(1, nba * nbb + 1, dtype=_out_dtype(weights), device=a.device)
    n = a.numel()
    if n == 0:
        return _finish(out, weights)
    if weights is not None:
        weights = weights.contiguous()
    suffix, w_args = _weight_args(weights, strides=False)
    fn = getattr(_build.load(), f"xh_joint2_{_SUFFIX[dtype]}{suffix}")
    with torch.cuda.device(a.device):
        rc = fn(
            a.data_ptr(), b.data_ptr(), n,
            thr_a.data_ptr(), nba, thr_b.data_ptr(), nbb,
            *w_args, out.data_ptr(), _stream(a.device),
        )
    if rc != 0:
        raise RuntimeError(f"joint2 CUDA kernel failed to launch: cudaError {rc}")
    JOINT2_LAUNCHES += 1
    return _finish(out, weights)


_FACTORED_VARIANTS = tuple(FACTORED_LAUNCHES)


def _widen(x, dtype):
    """``x`` in ``dtype``. Only the distinct elements are converted: a
    broadcast (zero-stride) dimension stays a broadcast."""
    if x.dtype == dtype:
        return x
    distinct = x[tuple(
        slice(0, 1) if stride == 0 else slice(None) for stride in x.stride()
    )]
    return distinct.to(dtype).expand(x.shape)


def _check_slot_operands(name, arrays_2d, thresholds, nbins, weights):
    if not 1 <= len(arrays_2d) == len(thresholds) == len(nbins):
        raise ValueError(
            f"{name} needs one threshold tensor and one bin count per input, "
            f"got {len(arrays_2d)} inputs, {len(thresholds)} threshold "
            f"tensors and {len(nbins)} bin counts"
        )
    shape = arrays_2d[0].shape
    if len(shape) != 2 or any(a.shape != shape for a in arrays_2d):
        raise ValueError(
            f"{name} takes 2-D layouts of one shape, got "
            f"{[tuple(a.shape) for a in arrays_2d]}"
        )
    if any(nb < 1 for nb in nbins):
        raise ValueError(f"{name} needs at least one bin per input, got {nbins}")
    _check_operands(name, arrays_2d, thresholds, nbins)
    if weights is not None:
        _check_weights(name, weights, arrays_2d[0])


def _slot_hist_cuda(name, route, arrays_2d, thresholds, nbins, reduce_all,
                    weights):
    """(counts or weighted sums, launches) of the flat-slot kernel of
    ``route`` (``csrc/slot.cuh``) on CUDA tensors; any failure raises."""
    dtype = _compare_dtype([a.dtype for a in arrays_2d])
    if dtype is None:
        raise NotImplementedError(
            f"{name} has no exact common compare type for "
            f"{[str(a.dtype) for a in arrays_2d]} data (int64 with a float)"
        )
    if len(arrays_2d) > _MAX_SLOT_INPUTS:
        raise NotImplementedError(
            f"the {name} CUDA kernel takes at most {_MAX_SLOT_INPUTS} inputs, "
            f"got {len(arrays_2d)}"
        )
    arrays = [_widen(a, dtype) for a in arrays_2d]
    thr = [t.to(dtype).contiguous() for t in thresholds]
    device = arrays[0].device
    m, c = arrays[0].shape
    shape = (1 if reduce_all else m, math.prod(nbins) + 1)
    if m == 0 or c == 0:
        out = torch.zeros(shape, dtype=_out_dtype(weights), device=device)
        return _finish(out, weights), 0
    # every slot of the output is written by the kernel or zeroed by its
    # launcher
    out = torch.empty(shape, dtype=_out_dtype(weights), device=device)
    n = len(arrays)
    suffix, w_args = _weight_args(weights)
    fn = getattr(_build.load(), f"xh_{route}_{_SUFFIX[dtype]}{suffix}")
    with torch.cuda.device(device):
        rc = fn(
            n,
            (ctypes.c_void_p * n)(*(a.data_ptr() for a in arrays)),
            (ctypes.c_int64 * (2 * n))(*(s for a in arrays for s in a.stride())),
            (ctypes.c_void_p * n)(*(t.data_ptr() for t in thr)),
            (ctypes.c_int * n)(*nbins),
            m, c, MAX_SHARED_SLOTS, *w_args, out.data_ptr(), _stream(device),
        )
    if rc != 0:
        raise RuntimeError(f"{name} CUDA kernel failed to launch: cudaError {rc}")
    return _finish(out, weights), 1


def factored_reference(arrays_2d, thresholds, nbins, variant, weights=None):
    """Plain PyTorch factored, with ``factored``'s contract
    (``pallas_hist._run_factored``'s counts)."""
    return _slot_counts_reference(arrays_2d, thresholds, nbins, variant == "full",
                                  weights)


def factored(arrays_2d, thresholds, nbins, variant, weights=None):
    """Joint histogram of N inputs over all elements or per kept row: the
    routes ``factored`` (``variant="full"``), ``factored_per_row``
    (``"per_row"``) and ``factored_packed`` (``"packed"``) of ``plan``.

    ``arrays_2d`` are N ``(m, c)`` layouts of one shape, with any strides
    (broadcast inputs keep their zero strides; the kernel reads every view
    in place); ``thresholds[k]`` is input k's compare-form thresholds
    (``bins.compare_form(edges, dtype).edges`` with ``n_hi_clip == 0``) in
    its dtype on its device, ``nbins[k]`` its bin count. Returns
    ``(1 if variant == "full" else m, prod(nbins) + 1)`` int64 counts with
    a zero trailing trash slot; with ``weights`` (an ``(m, c)`` view with
    any strides, read in place like the data), the sums of the weights in
    their ``weighted_dtype`` instead.

    A CUDA tensor launches the CUDA kernel (``csrc/factored.cu``), and any
    failure raises; inputs of several dtypes widen to the narrowest compare
    type that holds each exactly, and int64 with a float raises
    ``NotImplementedError``. A CPU tensor runs ``factored_reference``.
    """
    if variant not in _FACTORED_VARIANTS:
        raise ValueError(
            f"factored variant must be one of {_FACTORED_VARIANTS}, got {variant!r}"
        )
    _check_slot_operands("factored", arrays_2d, thresholds, nbins, weights)
    if arrays_2d[0].device.type == "cpu":
        return factored_reference(arrays_2d, thresholds, nbins, variant, weights)
    out, launched = _slot_hist_cuda("factored", f"factored_{variant}", arrays_2d,
                                    thresholds, nbins, variant == "full", weights)
    FACTORED_LAUNCHES[variant] += launched
    return out


def direct_reference(arrays_2d, thresholds, nbins, weights=None):
    """Plain PyTorch direct, with ``direct``'s contract
    (``pallas_hist._run_direct``'s counts)."""
    return _slot_counts_reference(arrays_2d, thresholds, nbins, False, weights)


def direct(arrays_2d, thresholds, nbins, weights=None):
    """Joint histogram of N inputs per kept row: the route ``direct`` of
    ``plan`` (narrow rows, few slots) and every kept-row call forced onto
    the kernels outside ``plan``'s envelopes.

    Arguments as for ``factored``. Returns ``(m, prod(nbins) + 1)`` int64
    counts (or weighted sums) with a zero trailing trash slot. A CUDA
    tensor launches the CUDA kernel (``csrc/direct.cu``), and any failure
    raises. A CPU tensor runs ``direct_reference``.
    """
    global DIRECT_LAUNCHES
    _check_slot_operands("direct", arrays_2d, thresholds, nbins, weights)
    if arrays_2d[0].device.type == "cpu":
        return direct_reference(arrays_2d, thresholds, nbins, weights)
    out, launched = _slot_hist_cuda("direct", "direct", arrays_2d, thresholds,
                                    nbins, False, weights)
    DIRECT_LAUNCHES += launched
    return out
