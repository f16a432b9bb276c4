"""Row-vectorized bincount (plain PyTorch).

Counterpart of ``xhistogram_tpu.ops.bincount``: given a canonical 2-D layout
of flat joint-bin indices ``g`` with shape ``(M rows, C cols)``, produce
per-row int64 counts ``(M, n_slots)`` — the reference's offset-bincount
trick (reference core.py:73-83). Only the scatter strategy is ported; the
``onehot`` and ``sort`` strategies were TPU workarounds for a slow scatter
and wait (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

import torch

__all__ = ["bincount2d", "bincount2d_scatter", "METHODS"]

METHODS = ("scatter", "onehot", "sort")


def bincount2d_scatter(g, n_slots):
    """Per-row counts through one flat bincount over row-offset indices."""
    m = g.shape[0]
    offset = g + n_slots * torch.arange(m, dtype=g.dtype, device=g.device)[:, None]
    return torch.bincount(offset.reshape(-1), minlength=m * n_slots).reshape(
        m, n_slots
    )


def bincount2d(g, n_slots, method="scatter"):
    """Dispatch over bincount strategies (same names as the JAX package)."""
    if method == "scatter":
        return bincount2d_scatter(g, n_slots)
    if method in METHODS:
        raise NotImplementedError(
            f"bincount method {method!r} is not ported yet (ROADMAP queue 1, "
            "item 5: onehot and sort)"
        )
    raise ValueError(f"unknown bincount method {method!r}; valid: {METHODS}")
