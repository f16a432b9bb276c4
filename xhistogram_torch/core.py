"""Array API: axis-selective, weighted, density-normalizable joint histograms.

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
package's int32 is a TPU word-size artifact). Weighted sums take a dtype
from the weights' (``ops.bincount.weighted_dtype``), on every route, the
CPU's included:

  - float16, bfloat16 and float32 weights sum in float64 and round once to
    float32 (the JAX package gives float16 for float16 weights on its
    scatter route and float32 on its kernels);
  - float64 weights give float64, numpy's dtype, where the JAX package
    gives float32;
  - bool and 8-, 16- and 32-bit integer weights, signed or not, give int32
    wrapped mod 2^32, bit-equal to the JAX package;
  - int64 and uint64 weights give int64 and uint64, exact mod 2^64. The JAX
    package gives the same for values beyond int32, but int32, wrapped, for
    values that each fit int32.

Float sums are added with atomics in an order that varies between runs on
the card, in float64, so they are reproducible in practice but not
guaranteed bit for bit; integer sums are exact. A NaN weight makes its own
bin NaN, and +inf with -inf in one bin make it NaN (``np.bincount``'s
semantics); the weight of an element whose data is NaN or out of range is
never added. Density results are float32 (float64 for float64 weights),
computed in the same order as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bins as _bins
from .ops.bincount import bincount2d
from .ops.cuda_hist import (
    direct, factored, joint2, one_input, plan, validate_public_precision,
)
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

_COMPLEX_MSG = (
    "complex input is not supported: complex numbers define no histogram "
    "ordering; histogram the .real/.imag/abs() parts explicitly"
)

#: the dtype each data dtype is compared in, where it is not its own: the
#: dtype of its compare-form thresholds (``bins.compare_form``). The data
#: itself stays narrow: the one_input kernel reads it at its own width and
#: widens it in registers; the plain path and the other kernels widen a
#: copy (``ops.digitize.digitize_edges``, ``ops.cuda_hist``). int32
#: thresholds never saturate at a narrow type's bounds, and every bfloat16
#: value is exact in float32
_COMPARE_AS = {
    torch.bool: np.int32, torch.int8: np.int32, torch.uint8: np.int32,
    torch.int16: np.int32, torch.uint16: np.int32, torch.bfloat16: np.float32,
}


def _coerce_host(x):
    """Input coercion to a tensor or numpy array the digitize can compare
    exactly.

    numpy and Python inputs become numpy arrays (datetime64 viewed as int64,
    since binning only needs order); ``_place`` copies them to the device.
    uint32 goes to int64. Narrow inputs (bool, 8- and 16-bit integers,
    float16, bfloat16) and uint64 keep their dtype: ``_compare_dtype``
    names the thresholds' dtype, and uint64 is flipped onto int64 after
    placement (``bins.flip_uint64``). Complex input raises.
    """
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            raise TypeError(_COMPLEX_MSG)
        if x.dtype == torch.uint32:
            return x.to(torch.int64)
        return x
    x = np.asarray(x)
    if x.dtype.kind == "c":
        raise TypeError(_COMPLEX_MSG)
    if x.dtype.kind in "Mm":
        x = x.view("i8")
    elif x.dtype == np.uint32:
        x = x.astype(np.int64)
    if any(s < 0 for s in x.strides):
        x = x.copy()  # torch views no negative strides
    return x


def _compare_dtype(t):
    """The numpy dtype of a placed input's compare-form thresholds: its own,
    int32 for bool and sub-32-bit integers, float32 for bfloat16 (uint64
    thresholds are then flipped onto int64 with the data)."""
    if t.dtype in _COMPARE_AS:
        return np.dtype(_COMPARE_AS[t.dtype])
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _coerce_weights(w):
    """Weights as a tensor or numpy array in their own dtype, which picks
    the sums' dtype, so nothing widens here. Complex weights raise as
    complex data does; datetime64 is viewed as int64."""
    if isinstance(w, torch.Tensor):
        if w.is_complex():
            raise TypeError(_COMPLEX_MSG)
        return w
    w = np.asarray(w)
    if w.dtype.kind == "c":
        raise TypeError(_COMPLEX_MSG)
    if w.dtype.kind in "Mm":
        w = w.view("i8")
    if any(s < 0 for s in w.strides):
        w = w.copy()  # torch views no negative strides
    return w


def _int_weight_mode(w):
    """The JAX package's internal mode for integer weights, "int1".."int4":
    the fewest signed base-256 digits that span the values of numpy
    weights, and 4 for tensors (``intweights.device_digits``). Only
    ``plan()``'s full-reduction cap reads it."""
    if isinstance(w, np.ndarray) and w.size:
        lo, hi = int(w.min()), int(w.max())
        for n in (1, 2, 3):
            span = (256**n - 1) // 255
            if -128 * span <= lo and hi <= 127 * span:
                return f"int{n}"
    return "int4"


class _WeightedSums(torch.autograd.Function):
    """Weighted sums with their gradient with respect to the weights: the
    counterpart of the JAX package's custom VJP around its weighted kernels
    (``pallas_hist._weighted_call``). The sums are linear in the weights,
    so the gradient of element e's weight is the incoming gradient at e's
    slot: a gather, in plain PyTorch, as the JAX backward is plain jnp.
    Elements in the trash slot get the trash column's gradient, which is 0
    once the caller drops that column; the data get no gradient."""

    @staticmethod
    def forward(ctx, w2d, sums, arrays_2d, thresholds, nbins, n_hi_clip):
        ctx.slots = (arrays_2d, thresholds, nbins, n_hi_clip)
        ctx.w_dtype = w2d.dtype
        return sums(w2d)

    @staticmethod
    def backward(ctx, grad):
        arrays_2d, thresholds, nbins, n_hi_clip = ctx.slots
        indices = [
            digitize_edges(a, t, n_hi_clip=nh)
            for a, t, nh in zip(arrays_2d, thresholds, n_hi_clip)
        ]
        g, _ = joint_bin_index(indices, nbins)
        dw = grad.expand(g.shape[0], -1).gather(1, g)
        return dw.to(ctx.w_dtype), None, None, None, None, None


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


def _count_fused(method, kernel, arrays_2d, thresholds, nbins, n_hi_clip,
                 reduce_all, w2d=None):
    """Counts (or sums of the weights ``w2d``) ``(rows, prod(nbins) + 1)``
    from ``kernel``, the kernel the JAX package would run here
    (``pallas_hist._dispatch``)."""
    if any(n_hi_clip):
        raise NotImplementedError(
            f"method={method!r} cannot represent bin edges at/beyond the data "
            "dtype's top value (int max / +inf); use method='auto' or "
            "method='scatter' for this edge configuration"
        )
    with scope("cuda_kernel"):
        if kernel == "one_input":
            return one_input(arrays_2d[0], thresholds[0], nbins[0], reduce_all,
                             weights=w2d)
        if kernel == "joint2":
            a, b = arrays_2d  # joint2 runs only for a full reduction
            return joint2(a, b, thresholds[0], thresholds[1], nbins[0], nbins[1],
                          weights=w2d)
        if kernel == "direct":
            return direct(arrays_2d, thresholds, nbins, weights=w2d)
        return factored(arrays_2d, thresholds, nbins, _FACTORED_VARIANT[kernel],
                        weights=w2d)


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
    weights : tensor or array_like, optional
        Broadcast against the inputs (it may have more dimensions than
        any of them) and placed like them. The result is then the sums of
        the weights in each bin, in the dtype the module docstring gives
        for the weights' dtype (float32; float64 for float64 weights; int32
        mod 2^32; int64 or uint64). The sums are differentiable with
        respect to float weights (``torch.autograd``): the gradient of
        each weight is the incoming gradient at its bin, 0 outside every
        bin; the data get none.
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
    precision : None | 'split' | 'highest' | 'i8' | 'i8x3' | 'f64'
        The JAX package's weighted-sum precision modes, validated with its
        messages. Every mode runs the same float64 accumulation here,
        which meets the tightest of their bounds ('highest'), so they
        differ only in the JAX ``plan()``'s routing gates, which the port
        keeps. 'f64' (correctly rounded float64 sums) is not ported yet
        and raises ``NotImplementedError`` for float weights; unweighted
        and integer-weighted calls ignore it, as in the JAX package.
    device : torch.device or str, optional
        Where numpy and Python inputs run. ``None`` means the tensor inputs'
        device, or the CUDA card when every input is numpy/Python; with no
        card that raises ``RuntimeError`` (pass ``device="cpu"``). A
        ``device`` that differs from a tensor input's raises ``ValueError``.

    Returns
    -------
    hist : torch.Tensor on the inputs' device — int64 counts, weighted
        sums, or float32 density (float64 for float64 weights).
    bin_edges : list of np.ndarray.
    """
    if not args:
        raise ValueError("histogram() requires at least one input array")
    n_inputs = len(args)
    args = [_coerce_host(a) for a in args]
    host_weights = None  # numpy weights' values set the integer weight mode
    if weights is not None:
        weights = host_weights = _coerce_weights(weights)
        args.append(weights)
    args = _place(args, device)
    device = args[0].device
    if any(a.device != device for a in args):
        raise ValueError(
            f"histogram inputs must lie on one device, got {[str(a.device) for a in args]}"
        )
    if weights is not None:
        *args, weights = args

    edges_np = _bins.resolve_bin_edges(args, bins, range, weights)
    nbins = tuple(int(e.shape[0]) - 1 for e in edges_np)
    for nb in nbins:
        if nb < 1:
            raise ValueError("each bins spec must define at least one bin")
    if precision == "f64":
        # unweighted counts and integer sums are exact in every mode
        if weights is not None and weights.is_floating_point():
            raise NotImplementedError(
                "precision='f64' (correctly rounded float64 weighted sums) is "
                "not ported yet (ROADMAP queue 1, item 3: exact tiers)"
            )
        precision = None
    forms = [_bins.compare_form(e, _compare_dtype(a)) for a, e in zip(args, edges_np)]
    thr_np = [f.edges for f in forms]
    for i, a in enumerate(args):
        if a.dtype == torch.uint64:  # searched as int64, in the same order
            args[i], thr_np[i] = _bins.flip_uint64(a), _bins.flip_uint64(thr_np[i])
    thresholds = [torch.from_numpy(t).to(device) for t in thr_np]
    n_hi_clip = [int(f.n_hi_clip) for f in forms]

    operands = args if weights is None else [*args, weights]
    try:
        shape = torch.broadcast_shapes(*(a.shape for a in operands))
    except RuntimeError:
        raise ValueError(
            "Incompatible shapes for broadcasting: shapes="
            f"{[tuple(a.shape) for a in operands]}"
        ) from None
    arrays = [a.expand(shape) for a in args]
    axis_t = normalize_axis(axis, len(shape))
    kshape = kept_shape(shape, axis_t)
    full_reduce = kshape == ()
    if precision is not None:
        validate_public_precision(precision)
    wmode = precision  # every mode runs the same kernels; plan() reads it
    if weights is not None and not weights.is_floating_point():
        wmode = _int_weight_mode(host_weights)

    with scope("canonicalize"):
        arrays_2d = [canonicalize_2d(a, axis_t) for a in arrays]
        w2d = None if weights is None else canonicalize_2d(weights.expand(shape), axis_t)

    # pallas_hist._dispatch's view: a layout with one row is a full reduction
    m, c = arrays_2d[0].shape
    reduce_all = full_reduce or m == 1
    kernel = plan(n_inputs, nbins, 1 if reduce_all else m,
                  None if reduce_all else c,
                  weights_dtype=None if weights is None else weights.dtype,
                  wmode=wmode)
    if method in ("cuda", "pallas"):
        # forced outside the efficient envelopes: the general kernel
        kernel = kernel or ("factored" if reduce_all else "direct")
    elif not (
        method == "auto"
        and device.type == "cuda"
        and kernel is not None
        and not any(n_hi_clip)  # the JAX package's auto gate
    ):
        kernel = None

    def count(w2d):
        """Counts, or sums of ``w2d``, ``(rows, prod(nbins) + 1)``."""
        if kernel is not None:
            return _count_fused(method, kernel, arrays_2d, thresholds, nbins,
                                n_hi_clip, reduce_all, w2d)
        with scope("digitize"):
            indices = [
                digitize_edges(a, t, n_hi_clip=nh)
                for a, t, nh in zip(arrays_2d, thresholds, n_hi_clip)
            ]
            g, n_slots = joint_bin_index(indices, nbins)
        with scope("bincount"):
            return bincount2d(
                g, n_slots, method="scatter" if method == "auto" else method,
                weights=w2d,
            )

    if w2d is None:
        counts = count(None)
    else:
        counts = _WeightedSums.apply(w2d, count, arrays_2d, thresholds, nbins,
                                     n_hi_clip)
    counts = counts[..., :-1]  # drop the trash slot (== reference's [1:-1])
    h = counts.reshape(kshape + nbins)

    if density:
        # per-kept-row totals, areas from the original edges, in the JAX
        # package's order: counts / area / totals, in float32 (float64 for
        # float64 sums)
        if h.dtype == torch.uint64:
            h = h.to(torch.float32)  # torch sums and divides no uint64
        area_dtype = torch.float64 if h.dtype == torch.float64 else torch.float32
        bin_area = torch.as_tensor(
            _bins.bin_areas(edges_np), dtype=area_dtype, device=device
        )
        totals = h.sum(dim=tuple(_builtin_range(-n_inputs, 0)), keepdim=True)
        h = h / bin_area / totals
    return h, edges_np
