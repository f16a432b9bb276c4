"""Axis bookkeeping: the canonical 2-D layout ``(kept_rows, reduce_cols)``,
and the strided 4-D views the CUDA kernels read in place.

``canonicalize_2d`` moves the reduced axes to the end and flattens both
groups, the layout of the reference's ``reshape_input`` (reference
core.py:211-229), which copies wherever the axes do not merge: a middle
axis reduced, a sliced or broadcast operand. Counterpart of
``xhistogram_tpu.utils.axes``, with the same error messages. The JAX
package's ``flatten_keep_minor`` keeps a full reduction's minor dimension
to fill TPU tiles; the CUDA kernels need no such fold, so it has no
counterpart here.

``strided_layout`` is what the kernels read instead: every operand as a
``(m1, m0, c1, c0)`` view of the caller's storage, kept rows as two
(count, stride) levels and reduced columns likewise, copying only where a
side needs three or more levels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["normalize_axis", "canonicalize_2d", "kept_shape", "StridedLayout",
           "strided_layout", "merged_levels"]


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


class StridedLayout(NamedTuple):
    """The operands of one call as the kernels read them
    (``strided_layout``)."""

    #: each operand as a ``(m1, m0, c1, c0)`` tensor: kept rows
    #: ``r = i1 * m0 + i0`` in the kept axes' row-major order, then reduced
    #: columns ``j = j1 * c0 + j0`` in an order that gives the same histogram
    views: list
    #: the permutation of the broadcast axes and the 4-D shape that
    #: ``apply`` gives any other tensor of the broadcast shape
    perm: tuple
    shape: tuple
    #: False: every view shares the storage of its operand; True: a side
    #: needed three or more levels, and every view is a contiguous copy
    #: (``canonicalize_2d``'s)
    copied: bool

    def apply(self, t):
        """``t``, of the call's broadcast shape, in this layout: a view
        where its strides allow, else a copy."""
        return t.permute(self.perm).reshape(self.shape)


def merged_levels(dims, sizes, strides):
    """``dims`` (outer to inner) merged into levels wherever every
    operand's ``strides`` allow: ``[[dim, ...], ...]``, one list a level."""
    levels = []
    for d in dims:
        if levels and all(st[levels[-1][-1]] == st[d] * sizes[d] for st in strides):
            levels[-1].append(d)
        else:
            levels.append([d])
    return levels


def strided_layout(operands, axis):
    """``StridedLayout`` of ``operands`` (tensors of one broadcast shape,
    after ``expand``) for a histogram over ``axis`` (normalized, or None).

    Kept axes keep their order and come first; reduced axes come last,
    reordered by the strides of the first operand that is not broadcast
    along them, outermost first (a histogram does not depend on the order
    of a row's elements), and, for a full reduction, every axis so. Size-1
    axes are dropped. Adjacent axes merge wherever every operand's strides
    allow (a stride of 0, a broadcast, stays one). Where each side then has
    at most two levels, every view shares its operand's storage, e.g. for
    ``(73, 50, 64800)`` with ``axis=(0, 2)`` kept ``(50,)`` at stride 64800
    and reduced ``(73, 64800)`` at strides ``(3240000, 1)``; else every
    operand is copied to ``canonicalize_2d``'s ``(1, m, 1, c)`` layout."""
    shape = tuple(operands[0].shape)
    ndim = len(shape)
    reduced = range(ndim) if axis is None else axis
    kept = [d for d in range(ndim) if d not in reduced and shape[d] != 1]
    strides = [t.stride() for t in operands]

    def order(d):
        return next((st[d] for st in strides if st[d] != 0), 0)

    cols = sorted((d for d in reduced if shape[d] != 1), key=order, reverse=True)
    row_levels = merged_levels(kept, shape, strides)
    col_levels = merged_levels(cols, shape, strides)
    def sizes(levels):
        out = [math.prod(shape[d] for d in level) for level in levels]
        return [1] * (2 - len(out)) + out

    ones = [d for d in range(ndim) if shape[d] == 1]
    if 0 in shape or len(row_levels) > 2 or len(col_levels) > 2:
        # canonicalize_2d's order: kept axes, then the reduced ones as given
        perm = tuple(d for d in range(ndim) if d not in reduced) + tuple(reduced)
        m = math.prod(shape[d] for d in range(ndim) if d not in reduced)
        shape4 = (1, m, 1, math.prod(shape[d] for d in reduced))
        copied = 0 not in shape
    else:
        perm = tuple(ones + kept + cols)
        shape4 = (*sizes(row_levels), *sizes(col_levels))
        copied = False
    views = [t.permute(perm).reshape(shape4) for t in operands]
    return StridedLayout(views, perm, shape4, copied)
