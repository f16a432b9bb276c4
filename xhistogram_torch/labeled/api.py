"""Labeled histogram API (the reference's xarray layer, rebuilt).

Counterpart of ``xhistogram_tpu.labeled.api``. ``histogram`` provides the
full labeled contract of ``xhistogram.xarray.histogram`` (reference
xarray.py:13-201): reduce over named ``dim``s, preserve the remaining
dims, emit bin-center coordinates (named ``<input name> +
bin_dim_suffix``) carrying each input's attrs, carry kept-dim coordinates
(plus compatible extra coords under ``keep_coords``), and name the output
``histogram_<name1>_<name2>...``.

Structure (own decomposition, not the reference's):

  validate → union-dim layout plan → positional dispatch → relabel

It never touches binning math: labels become positional axes, data goes to
``xhistogram_torch.core.histogram``, labels are rebuilt. Every call goes
through ``core.histogram``; the JAX package's compiled-pipeline cache
becomes core's device cache of resolved thresholds (``core.
_THRESHOLD_CACHE``), so repeated calls with the same explicit edges — the
per-timestep diagnostics pattern — make no host-to-device copy of them.
The layout plan is views (a reshape and a permute); the data are copied
only where ``core`` has to.

Inputs may be ``labeled.NamedArray`` or any duck-compatible labeled type
(e.g. ``xarray.DataArray``): the function only uses ``dims / coords / attrs
/ name / data / reset_coords``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bins as _bins_mod
from ..core import _resolve_device, histogram as _positional_histogram
from ..ops.cuda_hist import validate_public_precision
from ..utils.profiling import scope
from .array import NamedArray

__all__ = ["histogram"]

_LABEL_SURFACE = ("dims", "coords", "data", "name")

_NO_CARD_MSG = (
    "no CUDA card is available: the labeled histogram() runs on the card "
    "unless asked otherwise; pass device=\"cpu\" to run on the CPU"
)


def _require_labeled(operands, named=True):
    for a in operands:
        if not all(hasattr(a, attr) for attr in _LABEL_SURFACE):
            raise TypeError(
                "labeled histogram accepts only labeled arrays (NamedArray /"
                f" xarray.DataArray) but a {type(a).__name__} was provided"
            )
        if named and a.name is None:
            raise ValueError("all labeled arrays must have a name")


def _union_sizes(operands):
    """Ordered {dim: size} union over operands with an exact-join size check
    — the reference's xr.align(join="exact") contract
    (reference xarray.py:126,133-138), on dim sizes as in the JAX package."""
    sizes = {}
    for a in operands:
        for d, s in zip(a.dims, a.data.shape):
            if sizes.setdefault(d, s) != s:
                raise ValueError(
                    f"cannot align: dim {d!r} has conflicting sizes"
                    f" {sizes[d]} and {s}"
                )
    return sizes


def _layout_plan(operand_dims, union):
    """(n_new_leading, permutation) placing an operand's data on the union
    dim order: missing dims become leading length-1 axes, then a transpose
    lines everything up. The permutation is None when already in order."""
    have = list(operand_dims)
    missing = [d for d in union if d not in have]
    expanded = missing + have
    perm = tuple(expanded.index(d) for d in union)
    if perm == tuple(range(len(union))):
        perm = None
    return len(missing), perm


def _apply_plan(data, plan):
    n_new, perm = plan
    if n_new:
        data = data.reshape((1,) * n_new + tuple(data.shape))
    if perm is not None:
        data = data.permute(perm) if isinstance(data, torch.Tensor) else data.transpose(perm)
    return data


def _reduction_axes(union, dim):
    """dim names → (positional axis tuple | None, kept dim names)."""
    if dim is None:
        return None, []
    dim = [dim] if isinstance(dim, str) else list(dim)
    for d in dim:
        if d not in union:
            raise ValueError(f"dimension {d!r} not found in inputs")
    kept = [d for d in union if d not in dim]
    return tuple(union.index(d) for d in dim), kept


def histogram(
    *args,
    bins=None,
    range=None,
    dim=None,
    weights=None,
    density=False,
    block_size="auto",
    method="auto",
    keep_coords=False,
    bin_dim_suffix="_bin",
    precision=None,
    device=None,
):
    """Histogram of labeled arrays over named dimensions.

    Parameters mirror the reference (xarray.py:13-23); ``dim`` is a sequence
    of dimension names to reduce (default: all). ``precision`` selects the
    weighted-sum precision mode (see ``core.histogram``). ``device`` is
    where the call runs: by default the card any tensor input lies on, else
    the CUDA card; host data (numpy, CPU tensors) is copied there, so on a
    machine without a card pass ``device="cpu"``. Returns a ``NamedArray``
    (counts/weighted sums/density on that device) with bin-center
    coordinates.
    """
    with scope("labeled", call=True):
        if precision is not None and precision != "f64":
            validate_public_precision(precision)  # eager; rejects internal
            # modes ('f64' is not a kernel mode: core intercepts it first)
        if weights is None:
            precision = None  # unweighted counts are exact in every mode
        inputs = list(args)
        _require_labeled(inputs)
        if weights is not None:
            # weights need labels for alignment but no name (reference requires
            # names only of the histogrammed inputs, xarray.py:116-117)
            _require_labeled([weights], named=False)

        # Drop non-dim coords to simplify alignment unless asked to keep them
        # (reference xarray.py:120-123).
        if not keep_coords:
            inputs = [a.reset_coords(drop=True) for a in inputs]
            if weights is not None:
                weights = weights.reset_coords(drop=True)
        operands = inputs + ([weights] if weights is not None else [])

        union = list(_union_sizes(operands))
        plans = [_layout_plan(a.dims, union) for a in operands]
        axis, kept_dims = _reduction_axes(union, dim)

        raw = [a.data for a in operands]
        # by default the card a tensor input lies on, else the CUDA card
        on_card = [d for d in raw if isinstance(d, torch.Tensor) and d.device.type != "cpu"]
        device = _resolve_device(device, on_card, no_card_msg=_NO_CARD_MSG)
        raw = [d.to(device) if isinstance(d, torch.Tensor) and d.device.type == "cpu"
               else d for d in raw]
        laid_out = [_apply_plan(d, p) for d, p in zip(raw, plans)]
        w_data = laid_out.pop() if weights is not None else None
        h_data, edges = _positional_histogram(
            *laid_out,
            bins=bins,
            range=range,
            axis=axis,
            weights=w_data,
            density=density,
            block_size=block_size,
            method=method,
            precision=precision,
            device=device,
        )
        return _relabel(h_data, edges, inputs, kept_dims, keep_coords, bin_dim_suffix)


def _relabel(h_data, edges, inputs, kept_dims, keep_coords, bin_dim_suffix):
    """Output labels (reference xarray.py:174-199): kept dims first, one
    ``<name><suffix>`` bin dim per input with bin-center coords carrying the
    input's attrs; kept-dim coords (and, under ``keep_coords``, any other
    first-input coord whose dims survive) come along."""
    bin_dims = [str(a.name) + bin_dim_suffix for a in inputs]
    out_dims = list(kept_dims) + bin_dims

    coords = {}
    first = inputs[0]
    for d in kept_dims:
        if d in first.coords:
            coords[d] = first.coords[d]
    for bdim, e, a in zip(bin_dims, edges, inputs):
        coords[bdim] = ((bdim,), _bins_mod.bin_centers(e),
                        dict(getattr(a, "attrs", {}) or {}))
    if keep_coords:
        for cname, cval in first.coords.items():
            if cname not in coords and set(cval.dims).issubset(out_dims):
                coords[cname] = cval

    name = "_".join(["histogram"] + [str(a.name) for a in inputs])
    return NamedArray(h_data, out_dims, coords=coords, name=name)
