"""Digitize + joint-bin indexing (plain PyTorch).

Counterpart of ``xhistogram_tpu.ops.digitize``; the semantics are those of
reference core.py:157-192.

  ``digitize_edges(a, edges)`` returns, per element, an index in
  ``[0, len(edges)]`` with numpy-``searchsorted(side="right")`` semantics
  against the half-open comparison edges of ``bins.compare_form``:

    - 0              → a <  edges[0]            (below range)
    - i              → edges[i-1] <= a < edges[i]
    - len(edges)     → a >= edges[-1] or NaN    (above range)

  ``joint_bin_index`` fuses the reference's out-of-range trim into the index:
  a single trailing *trash slot* receives every element that is out of range
  (or NaN) on any input, and the caller drops it after counting.

  ``cell_map``, ``bucket_table`` and ``digitize_bucketed`` repeat, step for
  step in the same arithmetic, the bucketed search of the CUDA kernels
  (``csrc/digitize.cuh``), so the CPU tests can hold it to
  ``digitize_edges``; the plain path itself keeps ``torch.searchsorted``.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import note_narrow_read

__all__ = [
    "digitize_edges",
    "joint_bin_index",
    "cell_map",
    "bucket_table",
    "digitize_bucketed",
]


def digitize_edges(a, edges, n_hi_clip=0):
    """searchsorted-right of ``a`` against sorted half-open comparison edges.

    ``edges`` is a 1-D tensor on ``a``'s device, in ``a``'s dtype or, for
    narrow data, the dtype it is compared in (int32 for bool and 8- and
    16-bit integers, float32 for bfloat16 or float16, int64 for uint32), to
    which a copy of ``a`` is widened first; uint64 data meets int64
    thresholds flipped by ``bins.flip_uint64``, and a flipped copy of it.
    Returns int64 indices in ``[0, len(edges)]``,
    shaped like ``a``. A CUDA input of a 1- or 2-byte stored type counts in
    ``profiling.NARROW_READS``: "widened" where it is widened first, else
    "in_place".

    ``n_hi_clip`` (from ``bins.compare_form``): number of thresholds whose
    true value lies above the dtype's top value (int max / +inf) and were
    clamped to it; elements equal to the top value subtract the count.
    """
    n_edges = edges.shape[0]
    if a.is_cuda and a.element_size() <= 2:
        note_narrow_read("widened" if a.dtype != edges.dtype else "in_place")
    if a.dtype == torch.uint64:  # int64 thresholds flipped alike (bins.flip_uint64)
        a = a.view(torch.int64) ^ -(1 << 63)
    if a.dtype != edges.dtype:
        a = a.to(edges.dtype)
    idx = torch.searchsorted(edges, a.contiguous(), right=True)
    if n_hi_clip:
        if a.is_floating_point():
            top = math.inf
        else:
            top = torch.iinfo(a.dtype).max
        idx = idx - n_hi_clip * (a == top).to(idx.dtype)
    if a.is_floating_point():
        # NaN goes to the overflow slot explicitly: searchsorted's placement
        # of NaN is an implementation detail, numpy's is "after +inf"
        idx = torch.where(torch.isnan(a), n_edges, idx)
    return idx


def joint_bin_index(indices, nbins):
    """Combine per-input digitize indices into a flat *trimmed* joint index.

    Parameters
    ----------
    indices : list of equally-shaped integer tensors in ``[0, len(edges_i)]``
        (raw digitize output, per input).
    nbins : list of int — number of *real* bins per input.

    Returns
    -------
    g : int64 flat joint index in ``[0, n_slots)``; the last slot
        (``n_slots - 1``) is the trash slot for out-of-range/NaN elements.
    n_slots : ``prod(nbins) + 1``.
    """
    if len(indices) != len(nbins) or not indices:
        raise ValueError("one index tensor per input is required")
    g = None
    valid = None
    for idx, nb in zip(indices, nbins):
        t = idx - 1  # slot 1..nb maps to bin 0..nb-1
        ok = (t >= 0) & (t <= nb - 1)
        valid = ok if valid is None else (valid & ok)
        t = t.clamp(0, nb - 1)
        g = t if g is None else g * nb + t
    n_real = math.prod(int(nb) for nb in nbins)
    return torch.where(valid, g, n_real), n_real + 1


#: csrc/digitize.cuh kMaxCells
MAX_CELLS = 4096


def _cell_real(dtype):
    """The map's arithmetic type: float32 for float32 data, else float64."""
    return torch.float32 if dtype == torch.float32 else torch.float64


def cell_map(thr, cells):
    """``(lo, inv, k)`` of ``digitize.cuh``'s ``cell_map``: the map of the
    sorted thresholds ``thr`` (float32, float64, int32 or int64) onto at
    most ``cells`` cells, ``cell(x) = clamp(floor((x - lo) * inv), 0, k -
    1)``, in float32 for float32 thresholds and float64 otherwise; ``k`` is
    1 (``lo = inv = 0``) where the span or ``cells / span`` is not finite
    and positive. ``lo`` and ``inv`` are 0-d tensors of the map's type."""
    real = _cell_real(thr.dtype)
    t = thr.to(real)  # int64 rounds to nearest, as __ll2double_rn
    lo = t[0]
    span = t[-1] - lo
    inv = torch.tensor(float(cells), dtype=real) / span
    if (cells > 1 and bool(span > 0) and bool(torch.isfinite(span))
            and bool(inv > 0) and bool(torch.isfinite(inv))):
        return lo, inv, cells
    zero = torch.zeros((), dtype=real)
    return zero, zero, 1


def _cell_of(x, lo, inv, k):
    v = torch.floor((x.to(lo.dtype) - lo) * inv)  # two roundings, no fusion
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v).clamp(0, k - 1)
    return v.to(torch.int64)


def bucket_table(thr, cells=None):
    """``(first, widest, (lo, inv, k))``: the cell table a kernel block builds
    for ``thr`` (``first[c]``, the thresholds in cells below ``c``, for ``c``
    in ``0..k``), its widest window ``L`` and the map. ``cells`` defaults to
    what the kernels ask: ``min(2 * nb, MAX_CELLS)``."""
    nb = thr.shape[0] - 1
    if cells is None:
        cells = min(2 * nb, MAX_CELLS)
    lo, inv, k = cell_map(thr, cells)
    ct = _cell_of(thr, lo, inv, k)  # non-decreasing in the threshold index
    first = torch.searchsorted(ct, torch.arange(k + 1, dtype=torch.int64))
    widest = int((first[1:] - first[:-1]).max())
    return first, widest, (lo, inv, k)


def digitize_bucketed(a, thr, cells=None):
    """``digitize_edges(a, thr)`` (``n_hi_clip == 0``) by the kernels'
    bucketed search: the cell of each element, its window of thresholds from
    the table, and a search of ``L`` steps' trip count in which a probe past
    the window reads a valid threshold and is not taken."""
    nb = thr.shape[0] - 1
    first, widest, (lo, inv, k) = bucket_table(thr, cells)
    c = _cell_of(a, lo, inv, k)
    base = first[c]
    width = first[c + 1] - base
    pos = torch.zeros_like(base)
    step = 1 << (widest.bit_length() - 1) if widest else 0
    while step:
        j = pos + step - 1
        take = (j < width) & (thr[(base + j).clamp(max=nb)] <= a)
        pos = pos + step * take.to(pos.dtype)
        step >>= 1
    idx = base + pos
    if a.is_floating_point():
        idx = torch.where(torch.isnan(a), nb + 1, idx)
    return idx
