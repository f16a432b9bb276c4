"""The plain reference: histograms by ``torch.searchsorted`` and
``torch.bincount``, and the comparison that decides ``correct``.

numpy.histogramdd's semantics: bins are right-open but the last, which is
closed; values outside the edges and NaN fall in no bin. Every comparison
is made in float64, which holds float32 data and edges exactly. The data
are walked in blocks along their leading reduced axes, so the reference
fits beside the data on the card. This module imports neither the program
nor JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: elements of one block of the walk (its float64 copies and indices take
#: ~32 bytes an element)
BLOCK = 1 << 26


def digitize(x, edges):
    """The bin of each element of ``x`` under ``edges`` (ascending), -1
    outside every bin."""
    e = torch.as_tensor(np.asarray(edges, np.float64), device=x.device)
    xd = x.reshape(-1).to(torch.float64)
    nb = e.numel() - 1
    idx = torch.searchsorted(e, xd, right=True) - 1
    idx = torch.where(xd == e[-1], nb - 1, idx)
    inside = (idx >= 0) & (idx < nb) & ~torch.isnan(xd)
    return torch.where(inside, idx, -1)


def _blocks(shape):
    """Index tuples (slices) over the leading axes of ``shape``, each a block
    of at most ``BLOCK`` elements (one element of an axis at least)."""
    k = 0  # the first axis taken whole
    while k < len(shape) - 1 and math.prod(shape[k:]) > BLOCK:
        k += 1
    if not k:
        yield ()
        return
    run = max(1, BLOCK // math.prod(shape[k:]))  # elements of axis k - 1 a block
    for prefix in np.ndindex(*shape[:k - 1]):
        for start in range(0, shape[k - 1], run):
            yield (*(slice(i, i + 1) for i in prefix),
                   slice(start, min(start + run, shape[k - 1])))


def histogram(inputs, edges, axis=None, weights=None, lowp=None):
    """The joint histogram of ``inputs`` (tensors of one shape) over
    ``edges`` (one ascending array each), reducing ``axis`` (None: every
    axis), with optional ``weights`` broadcast against the inputs.

    Returns the kept shape then the bins: int64 counts, or float64 sums of
    the weights. ``lowp`` (a dtype) first rounds data and weights to it: the
    control, the reference in a lower precision than the configuration's.
    """
    shape = tuple(inputs[0].shape)
    ndim = len(shape)
    reduced = tuple(range(ndim)) if axis is None else tuple(a % ndim for a in axis)
    kept = [a for a in range(ndim) if a not in reduced]
    nbins = [len(e) - 1 for e in edges]
    nslots = math.prod(nbins)
    nrows = math.prod(shape[a] for a in kept)
    device = inputs[0].device
    out = None
    for index in _blocks(shape):
        parts = [x[index] for x in inputs]
        bshape = parts[0].shape
        slot = torch.zeros(bshape, dtype=torch.int64, device=device).reshape(-1)
        inside = torch.ones_like(slot, dtype=torch.bool)
        for x, e, nb in zip(parts, edges, nbins):
            if lowp is not None:
                x = x.to(lowp)
            idx = digitize(x, e)
            inside &= idx >= 0
            slot = slot * nb + idx.clamp_min(0)
        rows = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        for a in reversed(kept):
            start = index[a].start if a < len(index) else 0
            view = [1] * ndim
            view[a] = bshape[a]
            coord = torch.arange(start, start + bshape[a], device=device)
            rows = rows + coord.reshape(view) * stride
            stride *= shape[a]
        flat = (rows.expand(bshape).reshape(-1) * nslots + slot)[inside]
        w = None
        if weights is not None:
            w = weights.expand(shape)[index]
            if lowp is not None:
                w = w.to(lowp)
            w = w.reshape(-1).to(torch.float64)[inside]
        part = torch.bincount(flat, weights=w, minlength=nrows * nslots)
        out = part if out is None else out.add_(part)
    return out.reshape([shape[a] for a in kept] + nbins)


def compare(got, want):
    """The numbers that decide ``correct``, by name: the largest gap of an
    integer count (``count_gap``) or the largest gap of a float sum relative
    to the reference's sum in that bin or, where that is smaller, to the
    median of its non-empty bins (``sum_rel_gap``); ``edge_gap``, the largest
    gap between the edges returned and those given; ``label_gap``, the labels
    that differ."""
    out = {}
    g, w = got["hist"], want["hist"]
    if tuple(g.shape) != tuple(w.shape):
        return {"shape_gap": float("inf")}
    if w.dtype.is_floating_point:
        g = g.to(torch.float64)
        nonzero = w.abs()[w != 0]
        floor = float(nonzero.median()) if nonzero.numel() else 1.0
        out["sum_rel_gap"] = float(((g - w).abs() / w.abs().clamp_min(floor)).max()) \
            if w.numel() else 0.0
    else:
        out["count_gap"] = float((g.to(torch.int64) - w).abs().max()) if w.numel() else 0.0
    if "edges" in want:
        out["edge_gap"] = max(
            (float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
             if len(a) == len(b) else math.inf)
            for a, b in zip(got["edges"], want["edges"]))
    if "labels" in want:
        out["label_gap"] = float(sum(
            not _same(got["labels"].get(k), v) for k, v in want["labels"].items()))
    return out


def _same(a, b):
    if a is None:
        return False
    if isinstance(b, tuple):
        return tuple(a) == b
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(a, b))
