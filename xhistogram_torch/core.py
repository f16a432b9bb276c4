"""Array API: axis-selective, density-normalizable joint histograms.

Counterpart of ``xhistogram_tpu.core.histogram`` (the contract of the
reference's ``xhistogram.core.histogram``, reference core.py:250-466) for
torch tensors. Where it runs: a torch tensor runs on the device it lies on,
since putting it there was the caller's choice, and nothing moves it. numpy
and Python inputs are copied to ``device=``, which defaults to the CUDA
card; without a card they need ``device="cpu"``. The counts come back on
the inputs' device. On a CUDA tensor each call runs the hand-written
kernel that the JAX package's ``plan()`` names (one_input, joint2,
factored or direct; ``ops/cuda_hist``), or the plain scatter strategy where
the JAX package runs its scatter strategy too.

dtype rules: unweighted counts are int64, the reference's dtype (the JAX
package's int32 is a TPU word-size artifact). Density results are float32,
computed in the same order as the JAX package. Weights and ``precision=``
are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bins as _bins
from .ops.bincount import bincount2d
from .ops.cuda_hist import direct, factored, joint2, one_input, plan
from .ops.digitize import digitize_edges, joint_bin_index
from .utils.axes import canonicalize_2d, kept_shape, normalize_axis
from .utils.profiling import scope

__all__ = ["histogram"]

# the variant of the factored kernel each factored route of plan() runs
_FACTORED_VARIANT = {
    "factored": "full",
    "factored_per_row": "per_row",
    "factored_packed": "packed",
}

# `range` is a histogram keyword (reference API name)
_builtin_range = range

_NARROW_INTS = (torch.bool, torch.int8, torch.uint8, torch.int16, torch.uint16)

_COMPLEX_MSG = (
    "complex input is not supported: complex numbers define no histogram "
    "ordering; histogram the .real/.imag/abs() parts explicitly"
)
_UINT64_MSG = (
    "uint64 data is not ported yet (ROADMAP queue 1, item 6): torch has no "
    "search over uint64"
)


def _coerce_host(x):
    """Input coercion to a tensor or numpy array the digitize can compare
    exactly.

    numpy and Python inputs become numpy arrays (datetime64 viewed as int64,
    since binning only needs order); ``_place`` copies them to the device.
    Sub-32-bit integers are promoted to int32 so the edge-comparison
    transform never saturates at the dtype boundary; uint32 goes to int64.
    bfloat16 widens to float32, which is exact and keeps every comparison
    (numpy has no bfloat16 for the host edge transform). Complex input
    raises.
    """
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            raise TypeError(_COMPLEX_MSG)
        if x.dtype in _NARROW_INTS:
            return x.to(torch.int32)
        if x.dtype == torch.uint32:
            return x.to(torch.int64)
        if x.dtype == torch.bfloat16:
            return x.to(torch.float32)
        if x.dtype == torch.uint64:
            raise NotImplementedError(_UINT64_MSG)
        return x
    x = np.asarray(x)
    if x.dtype.kind == "c":
        raise TypeError(_COMPLEX_MSG)
    if x.dtype.kind in "Mm":
        x = x.view("i8")
    elif x.dtype.kind in "iub" and x.dtype.itemsize < 4:
        x = x.astype(np.int32)
    elif x.dtype == np.uint32:
        x = x.astype(np.int64)
    elif x.dtype == np.uint64:
        raise NotImplementedError(_UINT64_MSG)
    if any(s < 0 for s in x.strides):
        x = x.copy()  # torch views no negative strides
    return x


_NO_CARD_MSG = (
    "no CUDA card is available for the numpy/Python inputs: histogram() "
    "runs them on the card unless asked otherwise; pass device=\"cpu\" to "
    "run on the CPU"
)


def _place(args, device):
    """The inputs as tensors on one device.

    Tensors stay where they lie. numpy inputs go to ``device``, else to the
    tensor inputs' device, else to the CUDA card (raising without one).
    An explicit ``device`` that differs from a tensor input's raises.
    """
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(_NO_CARD_MSG)
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        for t in tensors:
            if t.device != device:
                raise ValueError(
                    f"device={str(device)!r} conflicts with an input tensor on "
                    f"{t.device}; histogram() moves no tensor, so move it "
                    "first or drop device="
                )
    elif tensors:
        device = tensors[0].device
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        raise RuntimeError(_NO_CARD_MSG)
    return [
        a if isinstance(a, torch.Tensor) else torch.from_numpy(a).to(device)
        for a in args
    ]


def _numpy_dtype(t):
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _count_fused(method, kernel, arrays_2d, thresholds, nbins, n_hi_clip,
                 reduce_all):
    """Counts ``(rows, prod(nbins) + 1)`` from ``kernel``, the kernel the
    JAX package would run here (``pallas_hist._dispatch``)."""
    if any(n_hi_clip):
        raise NotImplementedError(
            f"method={method!r} cannot represent bin edges at/beyond the data "
            "dtype's top value (int max / +inf); use method='auto' or "
            "method='scatter' for this edge configuration"
        )
    with scope("cuda_kernel"):
        if kernel == "one_input":
            return one_input(arrays_2d[0], thresholds[0], nbins[0], reduce_all)
        if kernel == "joint2":
            a, b = arrays_2d  # joint2 runs only for a full reduction
            return joint2(a, b, thresholds[0], thresholds[1], nbins[0], nbins[1])
        if kernel == "direct":
            return direct(arrays_2d, thresholds, nbins)
        return factored(arrays_2d, thresholds, nbins, _FACTORED_VARIANT[kernel])


def histogram(
    *args,
    bins=None,
    range=None,
    axis=None,
    weights=None,
    density=False,
    block_size="auto",
    method="auto",
    precision=None,
    device=None,
):
    """Histogram applied along specified axis / axes.

    Parameters
    ----------
    args : torch tensors, numpy arrays or array-likes
        N inputs → N-dimensional joint histogram. They are broadcast against
        each other and must lie on one device. A tensor runs where it lies;
        numpy and Python inputs are copied to ``device``.
    bins : int, str, 1-D array, or per-input list thereof
        int/str specs are resolved on the host with
        ``np.histogram_bin_edges``. With edge arrays, all but the last bin
        are right-open; the last is closed.
    range : (lo, hi) or per-input list thereof, optional
    axis : None | int | tuple of int
        Axes reduced by the histogram; the rest are preserved per element.
        ``None`` reduces everything.
    weights : not ported yet; must be None.
    density : bool — normalize to a PDF per preserved row (integral == 1).
    block_size : accepted for signature parity with the JAX package; only
        its ``onehot`` strategy reads it, and that is not ported yet.
    method : 'auto' | 'scatter' | 'cuda' (alias 'pallas')
        'auto' runs the CUDA kernel that the JAX package's ``plan()`` names
        for a CUDA tensor, and the scatter strategy on the CPU or where the
        JAX package runs its scatter strategy too. 'cuda' forces the fused
        kernel route at any shape, with the JAX package's fallback outside
        ``plan()``'s envelopes (factored for a full reduction, direct for
        kept rows); on a CPU tensor it runs the kernel's plain version.
    precision : not ported yet; must be None.
    device : torch.device or str, optional
        Where numpy and Python inputs run. ``None`` means the tensor inputs'
        device, or the CUDA card when every input is numpy/Python; with no
        card that raises ``RuntimeError`` (pass ``device="cpu"``). A
        ``device`` that differs from a tensor input's raises ``ValueError``.

    Returns
    -------
    hist : torch.Tensor on the inputs' device — int64 counts, or float32
        density.
    bin_edges : list of np.ndarray.
    """
    if not args:
        raise ValueError("histogram() requires at least one input array")
    if weights is not None:
        raise NotImplementedError(
            "weights= is not ported yet (ROADMAP queue 1, item 8: core.py "
            "weighted)"
        )
    if precision is not None:
        raise NotImplementedError(
            "precision= is not ported yet (ROADMAP queue 1, item 8: core.py "
            "weighted)"
        )
    n_inputs = len(args)
    args = _place([_coerce_host(a) for a in args], device)
    device = args[0].device
    if any(a.device != device for a in args):
        raise ValueError(
            f"histogram inputs must lie on one device, got {[str(a.device) for a in args]}"
        )

    edges_np = _bins.resolve_bin_edges(args, bins, range)
    nbins = tuple(int(e.shape[0]) - 1 for e in edges_np)
    for nb in nbins:
        if nb < 1:
            raise ValueError("each bins spec must define at least one bin")
    forms = [_bins.compare_form(e, _numpy_dtype(a)) for a, e in zip(args, edges_np)]
    thresholds = [torch.from_numpy(f.edges).to(device) for f in forms]
    n_hi_clip = [int(f.n_hi_clip) for f in forms]

    try:
        shape = torch.broadcast_shapes(*(a.shape for a in args))
    except RuntimeError:
        raise ValueError(
            "Incompatible shapes for broadcasting: shapes="
            f"{[tuple(a.shape) for a in args]}"
        ) from None
    arrays = [a.expand(shape) for a in args]
    axis_t = normalize_axis(axis, len(shape))
    kshape = kept_shape(shape, axis_t)
    full_reduce = kshape == ()

    with scope("canonicalize"):
        arrays_2d = [canonicalize_2d(a, axis_t) for a in arrays]

    # pallas_hist._dispatch's view: a layout with one row is a full reduction
    m, c = arrays_2d[0].shape
    reduce_all = full_reduce or m == 1
    kernel = plan(n_inputs, nbins, 1 if reduce_all else m,
                  None if reduce_all else c)
    if method in ("cuda", "pallas"):
        # forced outside the efficient envelopes: the general kernel
        kernel = kernel or ("factored" if reduce_all else "direct")
        counts = _count_fused(method, kernel, arrays_2d, thresholds, nbins,
                              n_hi_clip, reduce_all)
    elif (
        method == "auto"
        and device.type == "cuda"
        and kernel is not None
        and not any(n_hi_clip)  # the JAX package's auto gate
    ):
        counts = _count_fused(method, kernel, arrays_2d, thresholds, nbins,
                              n_hi_clip, reduce_all)
    else:
        with scope("digitize"):
            indices = [
                digitize_edges(a, t, n_hi_clip=nh)
                for a, t, nh in zip(arrays_2d, thresholds, n_hi_clip)
            ]
            g, n_slots = joint_bin_index(indices, nbins)
        with scope("bincount"):
            counts = bincount2d(
                g, n_slots, method="scatter" if method == "auto" else method
            )
    counts = counts[..., :-1]  # drop the trash slot (== reference's [1:-1])
    h = counts.reshape(kshape + nbins)

    if density:
        # per-kept-row totals, areas from the original edges, in the JAX
        # package's order: counts / area / totals, in float32
        bin_area = torch.as_tensor(
            _bins.bin_areas(edges_np), dtype=torch.float32, device=device
        )
        totals = h.sum(dim=tuple(_builtin_range(-n_inputs, 0)), keepdim=True)
        h = h / bin_area / totals
    return h, edges_np

