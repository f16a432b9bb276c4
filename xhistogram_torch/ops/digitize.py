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
"""

from __future__ import annotations

import math

import torch

__all__ = ["digitize_edges", "joint_bin_index"]


def digitize_edges(a, edges, n_hi_clip=0):
    """searchsorted-right of ``a`` against sorted half-open comparison edges.

    ``edges`` is a 1-D tensor in ``a``'s dtype and on its device. Returns
    int64 indices in ``[0, len(edges)]``, shaped like ``a``.

    ``n_hi_clip`` (from ``bins.compare_form``): number of thresholds whose
    true value lies above the dtype's top value (int max / +inf) and were
    clamped to it; elements equal to the top value subtract the count.
    """
    n_edges = edges.shape[0]
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
