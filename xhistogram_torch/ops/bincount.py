"""Row-vectorized bincount (plain PyTorch).

Counterpart of ``xhistogram_tpu.ops.bincount``: given a canonical 2-D layout
of flat joint-bin indices ``g`` with shape ``(M rows, C cols)``, produce
per-row int64 counts ``(M, n_slots)`` — the reference's offset-bincount
trick (reference core.py:73-83). Only the scatter strategy is ported; the
``onehot`` and ``sort`` strategies were TPU workarounds for a slow scatter
and wait (ROADMAP queue 1, item 5).

Weighted: each element adds its weight at its slot with ``index_add_``,
float weights in float64 and integer weights in int64 (uint64 as its int64
bits: two's-complement addition mod 2^64 is the same bits), then one
conversion to the sums' dtype (``weighted_dtype``). Not
``torch.bincount(weights=)``, which turns integer weights into float64 and
loses int64 exactness past 2^53. This is the CPU path, the oracle of the
CUDA kernels' weighted forms, and the CUDA route where the JAX package runs
its scatter strategy too.
"""

from __future__ import annotations

import torch

__all__ = [
    "bincount2d",
    "bincount2d_scatter",
    "weight_sums",
    "finish_sums",
    "weighted_dtype",
    "METHODS",
]

METHODS = ("scatter", "onehot", "sort")


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


def weight_sums(g, n_slots, weights):
    """Per-row sums ``(M, n_slots)`` of ``weights`` (shaped like ``g``) at
    their slots, in float64 for float weights and int64 for integer ones;
    ``finish_sums`` gives them their dtype."""
    m = g.shape[0]
    offset = g + n_slots * torch.arange(m, dtype=g.dtype, device=g.device)[:, None]
    if weights.is_floating_point():
        w = weights.to(torch.float64)
    elif weights.dtype == torch.uint64:
        w = weights.view(torch.int64)
    else:  # sign- or zero-extended: the same sums mod 2^32
        w = weights.to(torch.int64)
    sums = torch.zeros(m * n_slots, dtype=w.dtype, device=g.device)
    sums.index_add_(0, offset.reshape(-1), w.reshape(-1))
    return sums.reshape(m, n_slots)


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
    offset = g + n_slots * torch.arange(m, dtype=g.dtype, device=g.device)[:, None]
    return torch.bincount(offset.reshape(-1), minlength=m * n_slots).reshape(
        m, n_slots
    )


def bincount2d(g, n_slots, method="scatter", weights=None):
    """Dispatch over bincount strategies (same names as the JAX package)."""
    if method == "scatter":
        return bincount2d_scatter(g, n_slots, weights)
    if method in METHODS:
        raise NotImplementedError(
            f"bincount method {method!r} is not ported yet (ROADMAP queue 1, "
            "item 5: onehot and sort)"
        )
    raise ValueError(f"unknown bincount method {method!r}; valid: {METHODS}")
