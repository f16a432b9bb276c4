"""Axis bookkeeping: the canonical 2-D layout ``(kept_rows, reduce_cols)``.

Reduced axes are moved to the end and flattened, kept (bystander) axes are
flattened in front — the layout of the reference's ``reshape_input``
(reference core.py:211-229). Counterpart of ``xhistogram_tpu.utils.axes``,
with the same error messages. The JAX package's ``flatten_keep_minor``
keeps a full reduction's minor dimension to fill TPU tiles; the CUDA kernel
reads the ``(1, N)`` layout of ``canonicalize_2d`` instead, so it has no
counterpart here.
"""

from __future__ import annotations

import math

import torch

__all__ = ["normalize_axis", "canonicalize_2d", "kept_shape"]


def normalize_axis(axis, ndim):
    """Normalize ``axis`` to a sorted tuple of unique non-negative ints.

    ``None`` (reduce everything) stays ``None``.
    """
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    out = []
    for ax in axis:
        ax = int(ax)
        ax_pos = ax if ax >= 0 else ndim + ax
        if not (0 <= ax_pos < ndim):
            raise ValueError(
                f"axis {ax} is out of bounds for array of dimension {ndim}"
            )
        out.append(ax_pos)
    if len(set(out)) != len(out):
        raise ValueError(f"repeated axis in {axis}")
    return tuple(sorted(out))


def kept_shape(shape, axis):
    """Shape of the preserved (bystander) axes, in original order."""
    if axis is None:
        return ()
    return tuple(s for i, s in enumerate(shape) if i not in axis)


def canonicalize_2d(a, axis):
    """Reshape ``a`` to ``(n_kept_rows, n_reduce_cols)``.

    ``axis=None`` reduces everything → ``(1, a.numel())``. Otherwise the
    reduced axes are moved (in the given order) to the trailing positions and
    both groups are flattened.
    """
    if axis is None or set(axis) == set(range(a.ndim)):
        return a.reshape(1, a.numel())
    c = torch.movedim(a, axis, tuple(range(-len(axis), 0)))
    split = c.ndim - len(axis)
    m = math.prod(c.shape[:split])
    n = math.prod(c.shape[split:])
    return c.reshape(m, n)
