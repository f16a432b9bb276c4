"""Row-vectorized bincount strategies (plain PyTorch).

Counterpart of ``xhistogram_tpu.ops.bincount``: given a canonical 2-D layout
of flat joint-bin indices ``g`` with shape ``(M rows, C cols)``, produce
per-row int64 counts ``(M, n_slots)`` — the reference's offset-bincount
trick (reference core.py:73-83). The three strategies of the JAX package:

  - ``scatter``: one flat bincount (``index_add_`` for weights) over
    row-offset indices; the default, and the CPU path;
  - ``onehot``: a one-hot compare summed over column blocks, so the
    ``(M, block, n_slots)`` one-hot stays small (``block_size``, the analog
    of the reference's memory-bounding block loop, core.py:86-134);
  - ``sort``: a stable per-row sort, bucket boundaries by
    ``torch.searchsorted``, and per-bucket sums of the sorted weights.

They are strategies, not kernel routes: ``core.histogram`` runs no CUDA
kernel under ``method='onehot'`` or ``'sort'``, as the JAX package runs no
Pallas kernel there. Counts and integer sums are bit-equal across the
three; float sums are added in float64 in each strategy's own order, so
they are bit-equal wherever float64 addition is exact and otherwise differ
in float64's last bits (after the rounding to float32 of float32 weights,
almost never). NaN and infinite weights keep ``np.bincount``'s semantics
in all three: the one-hot sum selects with ``where`` (no ``0 * inf``) and
the sort sums each bucket on its own (no prefix sum to poison).

Weighted: each element adds its weight at its slot, float weights in
float64 and integer weights in int64 (uint64 as its int64 bits: two's
complement addition mod 2^64 is the same bits), then one conversion to the
sums' dtype (``weighted_dtype``). Not ``torch.bincount(weights=)``, which
turns integer weights into float64 and loses int64 exactness past 2^53.
This is the CPU path, the oracle of the CUDA kernels' weighted forms, and
the CUDA route where the JAX package runs its scatter strategy too.
"""

from __future__ import annotations

import torch

__all__ = [
    "bincount2d",
    "bincount2d_scatter",
    "bincount2d_onehot",
    "bincount2d_sort",
    "weight_sums",
    "finish_sums",
    "weighted_dtype",
    "METHODS",
]

METHODS = ("scatter", "onehot", "sort")

#: soft cap on the (M, block, n_slots) one-hot temporary, in elements (the
#: JAX package's ``_ONEHOT_BUDGET``)
_ONEHOT_BUDGET = 4_000_000


def weighted_dtype(w_dtype):
    """The dtype of weighted sums of ``w_dtype`` weights.

    float64 weights sum to float64 and the other floats to float32, each
    rounded once from a float64 sum; int64 and uint64 weights sum exactly
    mod 2^64 in their own dtype; bool and 8-, 16- and 32-bit integers sum
    mod 2^32 to int32, as an int32 accumulator wraps.
    """
    if w_dtype == torch.float64:
        return torch.float64
    if w_dtype.is_floating_point:
        return torch.float32
    if w_dtype in (torch.int64, torch.uint64):
        return w_dtype
    return torch.int32


def _accumulable(weights):
    """The weights in their accumulator's dtype: float64 for float weights,
    int64 for integers (uint64 as its bits; the rest sign- or zero-extended,
    which gives the same sums mod 2^32)."""
    if weights.is_floating_point():
        return weights.to(torch.float64)
    if weights.dtype == torch.uint64:
        return weights.view(torch.int64)
    return weights.to(torch.int64)


def _row_offset(g, n_slots):
    m = g.shape[0]
    return g + n_slots * torch.arange(m, dtype=g.dtype, device=g.device)[:, None]


def weight_sums(g, n_slots, weights):
    """Per-row sums ``(M, n_slots)`` of ``weights`` (shaped like ``g``) at
    their slots, in float64 for float weights and int64 for integer ones;
    ``finish_sums`` gives them their dtype."""
    w = _accumulable(weights)
    sums = torch.zeros(g.shape[0] * n_slots, dtype=w.dtype, device=g.device)
    sums.index_add_(0, _row_offset(g, n_slots).reshape(-1), w.reshape(-1))
    return sums.reshape(g.shape[0], n_slots)


def finish_sums(sums, w_dtype):
    """Sums accumulated in float64 or in 32- or 64-bit integers, in the
    dtype ``weighted_dtype(w_dtype)``: float64 rounds once to float32, int64
    wraps to int32 mod 2^32, and uint64 sums are their int64 bits."""
    out = weighted_dtype(w_dtype)
    if out == torch.uint64:
        return sums.view(torch.uint64)
    return sums.to(out)


def bincount2d_scatter(g, n_slots, weights=None):
    """Per-row counts through one flat bincount over row-offset indices, or
    per-row sums of ``weights`` (shaped like ``g``) in their
    ``weighted_dtype``."""
    if weights is not None:
        return finish_sums(weight_sums(g, n_slots, weights), weights.dtype)
    m = g.shape[0]
    return torch.bincount(_row_offset(g, n_slots).reshape(-1),
                          minlength=m * n_slots).reshape(m, n_slots)


def _auto_block(m, c, n_slots, block_size):
    """Columns per one-hot block: ``block_size`` when an int, else as many
    as keep the one-hot under ``_ONEHOT_BUDGET`` elements."""
    if isinstance(block_size, int):
        return max(1, min(block_size, c))
    return max(1, min(c, _ONEHOT_BUDGET // max(1, m * n_slots)))


def bincount2d_onehot(g, n_slots, weights=None, block_size="auto"):
    """One-hot strategy: for each block of columns, ``(g[m, b] == n)``
    summed over b (weighted: the weights it selects), added into the
    ``(M, n_slots)`` totals. Returns int64 counts, or sums in the weights'
    ``weighted_dtype``."""
    m, c = g.shape
    block = _auto_block(m, c, n_slots, block_size)
    slots = torch.arange(n_slots, dtype=g.dtype, device=g.device)
    w = None if weights is None else _accumulable(weights)
    acc = torch.zeros(m, n_slots, dtype=torch.int64 if w is None else w.dtype,
                      device=g.device)
    for start in range(0, c, block):
        hot = g[:, start:start + block, None] == slots
        if w is None:
            acc += hot.sum(dim=1)
        else:
            acc += torch.where(hot, w[:, start:start + block, None], 0).sum(dim=1)
    return acc if weights is None else finish_sums(acc, weights.dtype)


def bincount2d_sort(g, n_slots, weights=None):
    """Sort strategy: a stable sort of each row, the slot boundaries by
    ``searchsorted`` (counts are their differences), and the sums of the
    sorted weights over each slot's run: ``segment_reduce`` for float
    weights (each run on its own, so a NaN or infinity stays in its slot),
    prefix-sum differences for integer weights (exact mod 2^64). Returns
    int64 counts, or sums in the weights' ``weighted_dtype``."""
    m, c = g.shape
    gs, order = torch.sort(g, dim=1, stable=True)
    slots = torch.arange(n_slots + 1, dtype=g.dtype, device=g.device)
    pos = torch.searchsorted(gs, slots.expand(m, -1).contiguous())
    lengths = pos.diff(dim=1)
    if weights is None:
        return lengths
    ws = _accumulable(weights).gather(1, order)
    if ws.is_floating_point():
        sums = torch.segment_reduce(ws.reshape(-1), "sum",
                                    lengths=lengths.reshape(-1)).reshape(m, n_slots)
    else:
        prefix = torch.cat([torch.zeros(m, 1, dtype=ws.dtype, device=ws.device),
                            ws.cumsum(dim=1)], dim=1)
        sums = prefix.gather(1, pos).diff(dim=1)
    return finish_sums(sums, weights.dtype)


def bincount2d(g, n_slots, method="scatter", weights=None, block_size="auto"):
    """Dispatch over bincount strategies (same names as the JAX package);
    ``block_size`` is read by ``onehot`` only."""
    if method == "scatter":
        return bincount2d_scatter(g, n_slots, weights)
    if method == "onehot":
        return bincount2d_onehot(g, n_slots, weights, block_size)
    if method == "sort":
        return bincount2d_sort(g, n_slots, weights)
    raise ValueError(f"unknown bincount method {method!r}; valid: {METHODS}")
