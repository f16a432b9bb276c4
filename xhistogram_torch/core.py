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
guaranteed bit for bit; integer sums are exact. ``precision='f64'`` gives
float weights float64 sums that are exact until one final rounding, and
bit-identical from run to run: the weights become int64 limbs on their
device and run through the int64-weighted kernels (``_f64_sums``). A NaN weight makes its own
bin NaN, and +inf with -inf in one bin make it NaN (``np.bincount``'s
semantics); the weight of an element whose data is NaN or out of range is
never added. Density results are float32 (float64 for float64 weights),
computed in the same order as the JAX package.
"""

from __future__ import annotations

import math

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


def _resolve_device(device, tensors=(), no_card_msg=_NO_CARD_MSG):
    """Where a call runs: ``device`` (a CUDA one with its index), else the
    first of ``tensors``' devices, else the CUDA card. Raises
    ``RuntimeError(no_card_msg)`` where a card is named or needed and there
    is none."""
    if device is None and tensors:
        return tensors[0].device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(no_card_msg)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _place(args, device):
    """The inputs as tensors on one device.

    Tensors stay where they lie. numpy inputs go to ``device``, else to the
    tensor inputs' device, else to the CUDA card (raising without one).
    An explicit ``device`` that differs from a tensor input's raises.
    """
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    given = device is not None
    device = _resolve_device(device, tensors)
    for t in tensors if given else ():
        if t.device != device:
            raise ValueError(
                f"device={str(device)!r} conflicts with an input tensor on "
                f"{t.device}; histogram() moves no tensor, so move it "
                "first or drop device="
            )
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




#: explicit edge arrays' compare-form thresholds, already on their device:
#: the counterpart of the JAX package's compiled-pipeline cache
#: (labeled/api.py:112-171), used by ``histogram`` and so by every entry
#: point above it. Keyed by the edge values' bytes (with their dtype and
#: shape), the compare dtype (which fixes the ``n_hi_clip`` form and the
#: uint64 flip) and the device, so an edited edge array misses and never
#: reads stale thresholds, and no device is handed another's tensors. The
#: oldest entry goes first past the cap, as in the JAX package.
_THRESHOLD_CACHE = {}
_THRESHOLD_CACHE_CAP = 128


def _device_thresholds(edges, compare_dtype, device, cache=True):
    """``(thresholds, n_hi_clip)``: ``bins.compare_form(edges,
    compare_dtype)`` as a tensor on ``device`` (uint64 thresholds flipped
    onto int64, as the data are) and its count of thresholds clamped at the
    top value. With ``cache``, served from ``_THRESHOLD_CACHE``, so a
    repeated call makes no host-to-device copy."""
    key = None
    if cache:
        key = (edges.tobytes(), edges.dtype.str, edges.shape,
               np.dtype(compare_dtype).str, device)
        hit = _THRESHOLD_CACHE.get(key)
        if hit is not None:
            thr, n_hi_clip, copied = hit
            if copied is not None:  # a caller on another stream waits too
                torch.cuda.current_stream(device).wait_event(copied)
            return thr, n_hi_clip
    form = _bins.compare_form(edges, compare_dtype)
    thr = form.edges
    if thr.dtype == np.uint64:  # searched as int64, in the same order
        thr = _bins.flip_uint64(thr)
    thr, copied = torch.from_numpy(thr), None
    if device.type == "cuda":  # from pinned memory: the host does not wait
        thr = thr.pin_memory().to(device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(device))
    else:
        thr = thr.to(device)
    if key is not None:
        if len(_THRESHOLD_CACHE) >= _THRESHOLD_CACHE_CAP:
            _THRESHOLD_CACHE.pop(next(iter(_THRESHOLD_CACHE)))
        _THRESHOLD_CACHE[key] = (thr, int(form.n_hi_clip), copied)
    return thr, int(form.n_hi_clip)


#: binades per exponent group of the exact float64 tier (the JAX package's
#: value): a group's members have the lowest set bit of their mantissa
#: within a window of this many binades, so value = integer * 2**s with the
#: integer below 2**62
_F64_GROUP_STRIDE = 10
#: the most nonempty exponent groups (each costs its limb passes), as in
#: the JAX package
_F64_MAX_GROUPS = 32
# lowest-bit exponents of finite float64 values lie in [-1074, 1023]
_F64_GROUP_IDS = (1023 + 1074) // _F64_GROUP_STRIDE + 1
_F64_NO_GROUP = 1 << 20  # above every lowest-bit exponent


def _f64_limbs(n_cols):
    """(bits a limb, limbs) for the exact float64 tier's integers K
    (|K| < 2**62) over rows of ``n_cols`` elements: ``_split_limbs`` keeps
    each limb below 2**31 (2**21) in magnitude, so each per-slot limb sum
    stays below 2**63 and the int64-weighted kernels, which add mod 2**64,
    add it exactly. Two 31-bit limbs up to 2**32 elements a row, three
    21-bit limbs up to 2**42, past any card's memory."""
    return (31, 2) if n_cols <= 1 << 32 else (21, 3)


def _split_limbs(k, width, n_limbs):
    """Limbs of the int64 tensor ``k`` (|k| < 2**62) that carry its sign:
    ``k == sum(limb_j << (width * j))`` exactly, each limb ``width`` bits
    of |k| (the top one the rest) with k's sign, by truncating division and
    remainder, so no limb's part of a weight exceeds the weight in
    magnitude."""
    limbs = []
    for j in range(n_limbs - 1, 0, -1):
        unit = 1 << (width * j)
        limbs.append(torch.div(k, unit, rounding_mode="trunc"))
        k = torch.fmod(k, unit)
    return [k, *limbs[::-1]]


def _dd_add(hi, lo, x):
    """One double-double accumulation step: ``(hi, lo) += x`` via Knuth's
    branch-free TwoSum (an error-free transform in IEEE binary64), as the
    JAX package's ``_dd_add``."""
    s = hi + x
    v = s - hi
    e = (hi - (s - v)) + (x - v)
    return s, lo + e


def _scaled(t, x):
    """``t * 2**x`` for a float64 tensor and an int ``x`` with
    ``-1074 <= x <= 2098``: one multiplication by a power of two (two past
    the float64 range, each in range), exact wherever the product is
    representable (subnormal results included), ±inf past the top."""
    if x <= 1023:
        return t * math.ldexp(1.0, x)
    x1 = x // 2
    return t * math.ldexp(1.0, x1) * math.ldexp(1.0, x - x1)


def _f64_groups(wf, amax):
    """``[(s, K)]``: finite float64 weights ``wf`` (zeros where the weights
    are not finite) as int64 integers ``K`` (|K| < 2**62) with
    ``sum ldexp(K, s) == wf`` exactly, elementwise.

    Where every weight is a multiple of ``2**s`` for ``s`` 61 binades below
    the largest one's top bit — weights within 62 binades of each other's
    lowest bits, such as uniform or log-uniform doubles over a few decades —
    one group holds them all, ``K = wf * 2**-s`` (one scaling, exact). Else
    the JAX package's grouping (``_f64_weight_groups``): each weight
    ``±M * 2**u`` (M and u read exactly from its bits; subnormals and zeros
    need no special case) goes to the group of its lowest set bit
    (``M & -M``), ``_F64_GROUP_STRIDE`` binades a group, where it is
    ``K = ±M * 2**(u - s)``. Over ``_F64_MAX_GROUPS`` groups raises the JAX
    package's ``ValueError``. The host reads a few scalars (the largest
    weight, whether one group holds all, and otherwise which groups are
    present), which choose the passes. ``amax`` is the largest |weight|."""
    if amax == 0.0:
        return []
    s = max(math.frexp(amax)[1] - 62, -1074)  # the top bit of amax is s + 61
    y = _scaled(wf, -s)  # exact, but where a weight far below 2**s underflows
    one_group = torch.stack([(y == torch.trunc(y)).all(),
                             torch.count_nonzero(y) == torch.count_nonzero(wf)])
    if bool(one_group.all()):
        return [(s, y.to(torch.int64))]

    bits = wf.view(torch.int64)
    biased = (bits >> 52) & 0x7FF
    mant = bits & ((1 << 52) - 1)
    mant = torch.where(biased > 0, mant | (1 << 52), mant)  # M, below 2**53
    unit = biased.clamp(min=1) - 1075  # u: the exponent of M's unit bit
    nonzero = mant != 0
    low = mant & -mant  # M's lowest set bit: a power of two
    low_exp = (low.to(torch.float64).view(torch.int64) >> 52) - 1023  # exact
    lowest = torch.where(nonzero, unit + low_exp, _F64_NO_GROUP)
    lmin = lowest.amin()
    gid = torch.where(nonzero, (lowest - lmin) // _F64_GROUP_STRIDE, _F64_GROUP_IDS)
    # members per group: bincount's shared-memory histogram (an index_add_
    # serialises on the one or two groups that hold nearly every weight)
    per_group = torch.bincount(gid.reshape(-1), minlength=_F64_GROUP_IDS + 1)
    stats = torch.cat([lmin.reshape(1), per_group[:_F64_GROUP_IDS]]).cpu()
    lmin = int(stats[0])
    present = torch.nonzero(stats[1:]).reshape(-1).tolist()
    if len(present) > _F64_MAX_GROUPS:
        raise ValueError(
            f"precision='f64': weights span {len(present)} exponent groups "
            f"(> {_F64_MAX_GROUPS}); each group costs a full pass of the "
            "exact integer engine. Split the weights by magnitude and sum "
            "the histograms, or use precision='highest'."
        )
    negative = bits < 0
    groups = []
    for g in present:
        s = lmin + g * _F64_GROUP_STRIDE
        shift = unit - s  # in (-53, 10) for the group's members
        mag = torch.where(shift >= 0, mant << shift.clamp(0, 62),
                          mant >> (-shift).clamp(0, 63))
        mag = torch.where(gid == g, mag, 0)  # |K|, below 2**62
        groups.append((s, torch.where(negative, -mag, mag)))
    return groups


def _f64_sums(weights, to_2d, n_cols, out_shape, count_int, count_float):
    """Correctly rounded float64 sums of float weights (``precision='f64'``;
    the JAX package's ``_f64_weight_histogram``), ``out_shape`` ``(rows,
    slots)`` on the weights' device, trash slot included.

    The finite weights become exponent groups of int64 integers K on the
    weights' own shape (``_f64_groups``); ``to_2d`` broadcasts each limb
    into the canonical layout only as it is counted. Each K splits into the
    signed limbs of ``_f64_limbs``/``_split_limbs``, which add back to K
    exactly and whose per-slot sums ``count_int`` adds exactly in int64
    (the int64-weighted kernels, or ``index_add_``): groups x limbs passes,
    two for weights in one group. Each int64 sum enters a double-double
    accumulator exactly, as two doubles (the sum rounded and the int64
    rest, scaled by their power of two), so the one rounding is the final
    ``hi + lo``: correctly rounded to <= 1 ulp, ±inf
    where the exact sum overflows (the TwoSum term is NaN there and is
    masked, as in the JAX package). Nonfinite weights take one float64 pass of their own
    (``count_float``, zeros elsewhere), whose per-slot result adds at the
    end with ``np.bincount``'s semantics. Integer sums do not depend on the
    order of the adds, so the result is bit-identical from run to run.
    """
    w64 = weights.to(torch.float64)
    amax = float(w64.abs().amax()) if w64.numel() else 0.0
    nonfinite = not math.isfinite(amax)
    wf = w64
    if nonfinite:
        finite = torch.isfinite(w64)
        wf = torch.where(finite, w64, 0.0)
        amax = float(wf.abs().amax())
    width, n_limbs = _f64_limbs(n_cols)
    hi = lo = None
    for s, k in _f64_groups(wf, amax):
        for j, limb in enumerate(_split_limbs(k, width, n_limbs)):
            sums = count_int(to_2d(limb))  # |sums| < 2**63 - 2**32
            # the sum as two doubles, exactly: itself rounded, and the rest
            top = sums.to(torch.float64)
            rest = (sums - top.to(torch.int64)).to(torch.float64)
            top, rest = _scaled(top, s + width * j), _scaled(rest, s + width * j)
            if hi is None:  # (top, rest) is a double-double already
                hi, lo = top, rest
                continue
            hi, lo = _dd_add(hi, lo, top)
            hi, lo = _dd_add(hi, lo, rest)
    if hi is None:
        h = torch.zeros(out_shape, dtype=torch.float64, device=weights.device)
    else:
        h = torch.where(torch.isinf(hi), hi, hi + lo)
    if nonfinite:
        h = h + count_float(to_2d(torch.where(finite, 0.0, w64)))
    return h


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
        are right-open; the last is closed. Explicit edge arrays' device
        thresholds are cached (``_THRESHOLD_CACHE``), keyed by their values.
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
    block_size : int | 'auto' — columns per block of the ``onehot``
        strategy, which alone reads it.
    method : 'auto' | 'scatter' | 'onehot' | 'sort' | 'cuda' (alias 'pallas')
        'auto' runs the CUDA kernel that the JAX package's ``plan()`` names
        for a CUDA tensor, and the scatter strategy on the CPU or where the
        JAX package runs its scatter strategy too. 'cuda' forces the fused
        kernel route at any shape, with the JAX package's fallback outside
        ``plan()``'s envelopes (factored for a full reduction, direct for
        kept rows); on a CPU tensor it runs the kernel's plain version.
        'scatter', 'onehot' and 'sort' run that bincount strategy
        (``ops.bincount``) and no kernel, as in the JAX package.
    precision : None | 'split' | 'highest' | 'i8' | 'i8x3' | 'f64'
        The JAX package's weighted-sum precision modes, validated with its
        messages. 'split' to 'i8x3' run the same float64 accumulation here,
        which meets the tightest of their bounds ('highest'), so they
        differ only in the JAX ``plan()``'s routing gates, which the port
        keeps. 'f64' gives float weights float64 sums that are exact, then
        rounded once (<= 1 ulp, bit-identical from run to run; see
        ``_f64_sums``): the weights decompose into int64 limbs on their
        device, each pass runs the int64-weighted kernel ``plan()`` names,
        and the one host read of the passes to run synchronises. Exact for
        rows of up to 2**42 elements. Weights that require grad raise
        ``ValueError`` (the decomposition has no gradient). Unweighted and
        integer-weighted calls ignore 'f64', as in the JAX package.
    device : torch.device or str, optional
        Where numpy and Python inputs run. ``None`` means the tensor inputs'
        device, or the CUDA card when every input is numpy/Python; with no
        card that raises ``RuntimeError`` (pass ``device="cpu"``). A
        ``device`` that differs from a tensor input's raises ``ValueError``.

    Returns
    -------
    hist : torch.Tensor on the inputs' device — int64 counts, weighted
        sums, or float32 density (float64 for float64 and 'f64' sums).
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
    exact_f64 = False
    if precision == "f64":
        # unweighted counts and integer sums are exact in every mode
        exact_f64 = weights is not None and weights.is_floating_point()
        if exact_f64 and weights.requires_grad:
            raise ValueError(
                "precision='f64' runs an exact integer decomposition of the "
                "weights, which carries no gradient. Detach the weights, or "
                "use precision='highest' for gradients."
            )
        precision = None
    explicit = [isinstance(b, np.ndarray) for b in _bins.normalize_bins(bins, n_inputs)]
    thresholds, n_hi_clip = [], []
    for i, (a, e, cache) in enumerate(zip(args, edges_np, explicit)):
        thr, nh = _device_thresholds(e, _compare_dtype(a), device, cache=cache)
        thresholds.append(thr)
        n_hi_clip.append(nh)
        if a.dtype == torch.uint64:  # searched as int64, in the same order
            args[i] = _bins.flip_uint64(a)

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

    def to_2d(w):
        return canonicalize_2d(w.expand(shape), axis_t)

    with scope("canonicalize"):
        arrays_2d = [canonicalize_2d(a, axis_t) for a in arrays]
        w2d = None if weights is None or exact_f64 else to_2d(weights)

    # pallas_hist._dispatch's view: a layout with one row is a full reduction
    m, c = arrays_2d[0].shape
    reduce_all = full_reduce or m == 1
    n_slots = math.prod(nbins) + 1

    def route(weights_dtype, wmode):
        """The kernel that runs for these weights, or None for a strategy."""
        kernel = plan(n_inputs, nbins, 1 if reduce_all else m,
                      None if reduce_all else c, weights_dtype=weights_dtype,
                      wmode=wmode)
        if method in ("cuda", "pallas"):
            # forced outside the efficient envelopes: the general kernel
            return kernel or ("factored" if reduce_all else "direct")
        if (method == "auto" and device.type == "cuda" and kernel is not None
                and not any(n_hi_clip)):  # the JAX package's auto gate
            return kernel
        return None

    def count(w2d, kernel):
        """Counts, or sums of ``w2d``, ``(rows, prod(nbins) + 1)``."""
        if kernel is not None:
            return _count_fused(method, kernel, arrays_2d, thresholds, nbins,
                                n_hi_clip, reduce_all, w2d)
        with scope("digitize"):
            indices = [
                digitize_edges(a, t, n_hi_clip=nh)
                for a, t, nh in zip(arrays_2d, thresholds, n_hi_clip)
            ]
            g, _ = joint_bin_index(indices, nbins)
        with scope("bincount"):
            return bincount2d(
                g, n_slots, method="scatter" if method == "auto" else method,
                weights=w2d, block_size=block_size,
            )

    if exact_f64:
        int_kernel = route(torch.int64, None)
        float_kernel = route(torch.float64, None)
        counts = _f64_sums(
            weights, to_2d, c, (1 if reduce_all else m, n_slots),
            lambda w: count(w, int_kernel), lambda w: count(w, float_kernel),
        )
    elif w2d is None:
        counts = count(None, route(None, precision))
    else:
        wmode = precision  # every mode runs the same kernels; plan() reads it
        if not weights.is_floating_point():
            wmode = _int_weight_mode(host_weights)
        kernel = route(weights.dtype, wmode)
        counts = _WeightedSums.apply(w2d, lambda w: count(w, kernel), arrays_2d,
                                     thresholds, nbins, n_hi_clip)
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
