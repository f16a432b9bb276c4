"""Fused histogram kernels for the GPU, and the routing table between them.

Counterpart of ``xhistogram_tpu.ops.pallas_hist``. ``plan`` is that
module's routing table copied as host code (unweighted, no uniform-spacing
certificates yet), so both packages name the same kernel for the same
problem. Of the four kernel families it names, ``joint2`` is ported: a
hand-written CUDA kernel (``csrc/joint2.cu``) with its plain PyTorch version
``joint2_reference`` beside it. The others are not ported yet and the
caller raises for them (ROADMAP queue 2).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .bincount import bincount2d_scatter
from .digitize import digitize_edges, joint_bin_index

__all__ = ["plan", "joint2", "joint2_reference", "JOINT2_LAUNCHES"]

_SUB = 8  # the JAX package's sublane rounding, kept so plan() agrees with it
_MAX_EDGES = 32768

#: launches of the CUDA joint2 kernel in this process (the CPU path of the
#: wrapper does not count)
JOINT2_LAUNCHES = 0


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
    """Joint histogram of float32 pairs ``(a[e], b[e])`` over all elements.

    ``thr_a``/``thr_b`` are the compare-form thresholds
    (``bins.compare_form(edges, float32).edges`` with ``n_hi_clip == 0``)
    as float32 tensors on the data's device; ``nba``/``nbb`` are the bin
    counts (one fewer than the thresholds). Returns ``(1, nba * nbb + 1)``
    int64 counts with a zero trailing trash slot.

    A CUDA tensor launches the CUDA kernel, and any failure raises. A CPU
    tensor runs ``joint2_reference``.
    """
    global JOINT2_LAUNCHES
    if a.numel() != b.numel():
        raise ValueError(
            f"joint2 needs equally many elements, got {a.numel()} and {b.numel()}"
        )
    for x in (a, b, thr_a, thr_b):
        if x.dtype != torch.float32:
            raise TypeError(f"joint2 takes float32 tensors, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(
                f"joint2 operands must share a device, got {a.device} and {x.device}"
            )
    if thr_a.shape != (nba + 1,) or thr_b.shape != (nbb + 1,):
        raise ValueError(
            f"joint2 needs {nba + 1} and {nbb + 1} thresholds, got "
            f"{tuple(thr_a.shape)} and {tuple(thr_b.shape)}"
        )
    if a.device.type == "cpu":
        return joint2_reference(a, b, thr_a, thr_b, nba, nbb)
    if a.device.type != "cuda":
        raise ValueError(f"joint2 runs on CPU or CUDA tensors, got {a.device}")

    # .contiguous() copies only a non-contiguous input, at the cost of a full
    # pass over it; the main path's views are contiguous and pass through
    a, b, thr_a, thr_b = (x.contiguous() for x in (a, b, thr_a, thr_b))
    out = torch.zeros(nba * nbb + 1, dtype=torch.int64, device=a.device)
    n = a.numel()
    if n == 0:
        return out.reshape(1, -1)
    lib = _build.load()
    with torch.cuda.device(a.device):
        rc = lib.xh_joint2_f32(
            a.data_ptr(), b.data_ptr(), n,
            thr_a.data_ptr(), nba, thr_b.data_ptr(), nbb,
            out.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"joint2 CUDA kernel failed to launch: cudaError {rc}")
    JOINT2_LAUNCHES += 1
    return out.reshape(1, -1)
