"""Fused histogram kernels for the GPU, and the routing table between them.

Counterpart of ``xhistogram_tpu.ops.pallas_hist``. ``plan`` is that
module's routing table copied as host code (unweighted, no uniform-spacing
certificates yet), so both packages name the same kernel for the same
problem. Of the four kernel families it names, two are ported, each a
hand-written CUDA kernel with its plain PyTorch version beside it:
``one_input`` (``csrc/one_input.cu``, ``one_input_reference``) and
``joint2`` (``csrc/joint2.cu``, ``joint2_reference``). The others are not
ported yet and the caller raises for them (ROADMAP queue 2).

The kernels compare in the data's own type: float32, float64, int32 or
int64. float16 data and its thresholds widen to float32 first, which is
exact and keeps every comparison (the JAX package's ``_dispatch`` does the
same). A wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .bincount import bincount2d_scatter
from .digitize import digitize_edges, joint_bin_index

__all__ = [
    "plan",
    "one_input",
    "one_input_reference",
    "joint2",
    "joint2_reference",
    "ONE_INPUT_LAUNCHES",
    "JOINT2_LAUNCHES",
]

_SUB = 8  # the JAX package's sublane rounding, kept so plan() agrees with it
_MAX_EDGES = 32768

#: launches of each CUDA kernel in this process (the CPU path of a wrapper
#: does not count)
ONE_INPUT_LAUNCHES = 0
JOINT2_LAUNCHES = 0

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


def plan(n_inputs, nbins, m, c=None):
    """The kernel the JAX package runs for this unweighted problem, or
    ``None`` where it runs its scatter strategy instead.

    ``m == 1`` means a full reduction. Mirrors ``pallas_hist.plan`` with
    ``weighted=False`` and no uniform-spacing certificates.
    """
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
        if n_slots > (1 << 21):
            return None
        return "factored"

    n1, log2_n2 = _pick_factorization(n_slots)
    padded_slots = max(n1 << log2_n2, _round_up(n_slots, 1024))
    if m * padded_slots > (1 << 28):
        return None
    if n_inputs == 1 and nbins[0] <= 1024:
        return "one_input"
    if n_slots <= (1 << 24) and edges_ok and (c is None or c >= 256) and m > 1:
        return "factored_per_row"
    if n_slots <= 8192:
        return "direct"
    rpt = _SUB // _fold_factor(m, c if c is not None else 1)
    if rpt * n_slots <= (1 << 25) and edges_ok and m > 1:
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


def one_input_reference(a2d, thr, nb, reduce_all):
    """Plain PyTorch one_input: digitize, bin index, bincount.

    Same contract as ``one_input``: ``(1 if reduce_all else m, nb + 1)``
    int64 counts whose trailing trash slot is zero, as
    ``pallas_hist._run_one_input`` returns.
    """
    g, n_slots = joint_bin_index([digitize_edges(a2d, thr)], [nb])
    if reduce_all:
        g = g.reshape(1, -1)
    counts = bincount2d_scatter(g, n_slots)
    counts[:, -1] = 0
    return counts


def one_input(a2d, thr, nb, reduce_all):
    """Histogram of one input's ``(m, c)`` layout, per row or over all rows.

    ``thr`` is the compare-form thresholds
    (``bins.compare_form(edges, a2d.dtype).edges`` with ``n_hi_clip == 0``)
    as a tensor in ``a2d``'s dtype on its device; ``nb`` (at most 1024) is
    the bin count, one fewer than the thresholds. ``a2d`` may have any
    strides: the kernel reads the view in place. Returns
    ``(1 if reduce_all else m, nb + 1)`` int64 counts with a zero trailing
    trash slot.

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
    if a2d.device.type == "cpu":
        return one_input_reference(a2d, thr, nb, reduce_all)

    dtype = _compare_dtype((a2d.dtype,))  # float16 widens to float32
    a2d, thr = a2d.to(dtype), thr.to(dtype).contiguous()
    m, c = a2d.shape
    out = torch.zeros(1 if reduce_all else m, nb + 1, dtype=torch.int64,
                      device=a2d.device)
    if a2d.numel() == 0:
        return out
    fn = getattr(_build.load(), f"xh_one_input_{_SUFFIX[dtype]}")
    with torch.cuda.device(a2d.device):
        rc = fn(
            a2d.data_ptr(), m, c, a2d.stride(0), a2d.stride(1),
            thr.data_ptr(), nb, int(bool(reduce_all)), out.data_ptr(),
            _stream(a2d.device),
        )
    if rc != 0:
        raise RuntimeError(f"one_input CUDA kernel failed to launch: cudaError {rc}")
    ONE_INPUT_LAUNCHES += 1
    return out


def joint2_reference(a, b, thr_a, thr_b, nba, nbb):
    """Plain PyTorch joint2: digitize, joint index, bincount.

    Same contract as ``joint2``: ``(1, nba * nbb + 1)`` int64 counts whose
    trailing trash slot is zero, as ``pallas_hist._run_joint2`` returns.
    """
    ia = digitize_edges(a.reshape(1, -1), thr_a)
    ib = digitize_edges(b.reshape(1, -1), thr_b)
    g, n_slots = joint_bin_index([ia, ib], [nba, nbb])
    counts = bincount2d_scatter(g, n_slots)
    counts[:, -1] = 0
    return counts


def joint2(a, b, thr_a, thr_b, nba, nbb):
    """Joint histogram of the pairs ``(a[e], b[e])`` over all elements.

    ``thr_a``/``thr_b`` are the compare-form thresholds
    (``bins.compare_form(edges, x.dtype).edges`` with ``n_hi_clip == 0``)
    as tensors in their input's dtype on the data's device; ``nba``/``nbb``
    are the bin counts (one fewer than the thresholds). Returns
    ``(1, nba * nbb + 1)`` int64 counts with a zero trailing trash slot.

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
    if a.device.type == "cpu":
        return joint2_reference(a, b, thr_a, thr_b, nba, nbb)

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
    out = torch.zeros(nba * nbb + 1, dtype=torch.int64, device=a.device)
    n = a.numel()
    if n == 0:
        return out.reshape(1, -1)
    fn = getattr(_build.load(), f"xh_joint2_{_SUFFIX[dtype]}")
    with torch.cuda.device(a.device):
        rc = fn(
            a.data_ptr(), b.data_ptr(), n,
            thr_a.data_ptr(), nba, thr_b.data_ptr(), nbb,
            out.data_ptr(), _stream(a.device),
        )
    if rc != 0:
        raise RuntimeError(f"joint2 CUDA kernel failed to launch: cudaError {rc}")
    JOINT2_LAUNCHES += 1
    return out.reshape(1, -1)
