"""Array API: axis-selective, weighted, density-normalizable joint histograms.

Counterpart of ``xhistogram_tpu.core.histogram`` (the contract of the
reference's ``xhistogram.core.histogram``, reference core.py:250-466) for
torch tensors. Where it runs: a torch tensor runs on the device it lies on,
since putting it there was the caller's choice, and nothing moves it. numpy
and Python inputs are copied to ``device=``, which defaults to the CUDA
card; without a card they need ``device="cpu"``. The counts come back on
the inputs' device. On a CUDA tensor each call runs the hand-written
kernel that ``plan()`` names (one_input, joint2, factored or direct;
``ops/cuda_hist``), the JAX package's unweighted routing table, for
weighted calls too, or the plain scatter strategy outside it. The table
departs from the JAX package's in two bands of kept rows past 2^28 padded
slots, where the JAX package runs scatter: one input in at most 1024 bins
runs one_input here, and rows of fewer than 256 elements over at most 8192
slots run direct.

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

Float sums are added in float64 in an order that varies between runs on
the card, so they are reproducible in practice but not guaranteed bit for
bit; integer sums are exact. The direct kernel rounds its rows' float sums
to float32 as it stores them, the same single rounding.
``precision='f64'`` gives
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
import sys
import threading

import numpy as np
import torch

from . import bins as _bins
from .ops.bincount import finish_sums, slot_sums
from .ops.cuda_hist import (
    direct, factored, joint2, note_layout_copy, one_input, plan,
    validate_public_precision,
)
from .ops.digitize import digitize_edges, joint_bin_index
from .utils.axes import kept_shape, normalize_axis, strided_layout
from .utils.profiling import note_route, note_syncs, scope

__all__ = ["histogram"]

# `range` is a histogram keyword (reference API name)
_builtin_range = range

_COMPLEX_MSG = (
    "complex input is not supported: complex numbers define no histogram "
    "ordering; histogram the .real/.imag/abs() parts explicitly"
)

#: the dtype each data dtype is compared in, where it is not its own: the
#: dtype of its compare-form thresholds (``bins.compare_form``). The data
#: itself stays narrow: every kernel reads it at its own width and widens
#: it in registers, beside inputs of any other dtype
#: (``ops.cuda_hist.operand_plan``); the plain path widens a copy
#: (``ops.digitize.digitize_edges``). int32 thresholds never saturate at a
#: narrow type's bounds, and every bfloat16 value is exact in float32;
#: uint32 compares in int64, which holds each of its values
_COMPARE_AS = {
    torch.bool: np.int32, torch.int8: np.int32, torch.uint8: np.int32,
    torch.int16: np.int32, torch.uint16: np.int32, torch.bfloat16: np.float32,
    torch.uint32: np.int64,
}


def _coerce_host(x):
    """Input coercion to a tensor or numpy array the digitize can compare
    exactly.

    numpy and Python inputs become numpy arrays (datetime64 viewed as int64,
    since binning only needs order); ``_place`` copies them to the device.
    Every dtype is kept, narrow inputs (bool, 8- and 16-bit integers,
    float16, bfloat16), uint32 and uint64 included: the kernels read each
    at its own width and ``_compare_dtype`` names its thresholds' dtype.
    Complex input raises, and so do object, string and bytes arrays
    (``bins.non_numeric_message``).
    """
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            raise TypeError(_COMPLEX_MSG)
        return x
    x = np.asarray(x)
    if x.dtype.kind == "c":
        raise TypeError(_COMPLEX_MSG)
    _bins.check_numeric(x, "data")
    if x.dtype.kind in "Mm":
        x = x.view("i8")
    if any(s < 0 for s in x.strides):
        x = x.copy()  # torch views no negative strides
    return x


def _compare_dtype(t):
    """The numpy dtype of a placed input's compare-form thresholds: its own,
    int32 for bool and sub-32-bit integers, float32 for bfloat16, int64 for
    uint32; uint64's, computed in uint64, are then flipped onto int64
    (``_device_thresholds``), as the kernels flip each value they read.
    So both unsigned types search int64 thresholds."""
    if t.dtype in _COMPARE_AS:
        return np.dtype(_COMPARE_AS[t.dtype])
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _coerce_weights(w):
    """Weights as a tensor or numpy array in their own dtype, which picks
    the sums' dtype, so nothing widens here. Complex, object, string and
    bytes weights raise as such data does; datetime64 is viewed as int64."""
    if isinstance(w, torch.Tensor):
        if w.is_complex():
            raise TypeError(_COMPLEX_MSG)
        return w
    w = np.asarray(w)
    if w.dtype.kind == "c":
        raise TypeError(_COMPLEX_MSG)
    _bins.check_numeric(w, "weights")
    if w.dtype.kind in "Mm":
        w = w.view("i8")
    if any(s < 0 for s in w.strides):
        w = w.copy()  # torch views no negative strides
    return w


class _WeightedSums(torch.autograd.Function):
    """Weighted sums with their gradient with respect to the weights: the
    counterpart of the JAX package's custom VJP around its weighted kernels
    (``pallas_hist._weighted_call``). The sums are linear in the weights,
    so the gradient of element e's weight is the incoming gradient at e's
    slot: a gather, in plain PyTorch, as the JAX backward is plain jnp.
    Elements in the trash slot get the trash column's gradient, which is 0
    once the caller drops that column; the data get no gradient.

    ``w2d`` and the data are the kernels' ``(m1, m0, c1, c0)`` views (or the
    plain path's ``(m, c)`` layouts); the gradient comes back in ``w2d``'s
    shape, and autograd carries it back through the view's permute and
    expand, which sums a broadcast weight's gradient over the axes it was
    broadcast along."""

    @staticmethod
    def forward(ctx, w2d, sums, arrays_2d, thresholds, nbins, n_hi_clip):
        ctx.slots = (arrays_2d, thresholds, nbins, n_hi_clip)
        ctx.w_dtype = w2d.dtype
        ctx.w_shape = w2d.shape
        return sums(w2d)

    @staticmethod
    def backward(ctx, grad):
        arrays_2d, thresholds, nbins, n_hi_clip = ctx.slots
        indices = [
            digitize_edges(a, t, n_hi_clip=nh)
            for a, t, nh in zip(arrays_2d, thresholds, n_hi_clip)
        ]
        g, _ = joint_bin_index(indices, nbins)
        shape = ctx.w_shape
        rows = math.prod(shape[:-2]) if len(shape) == 4 else shape[0]
        g = g.reshape(rows, -1)
        dw = grad.expand(rows, -1).gather(1, g).reshape(shape)
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
                 reduce_all, w2d=None, finish=False):
    """Counts (or sums of the weights ``w2d``, in their accumulator class,
    or with ``finish`` in their ``weighted_dtype``) ``(rows, prod(nbins) +
    1)`` from ``kernel``, the kernel the JAX package would run here
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
                             weights=w2d, finish=finish)
        if kernel == "joint2":
            a, b = arrays_2d  # joint2 runs only for a full reduction
            return joint2(a, b, thresholds[0], thresholds[1], nbins[0], nbins[1],
                          weights=w2d, finish=finish)
        if kernel == "direct":
            return direct(arrays_2d, thresholds, nbins, weights=w2d, finish=finish)
        # factored, factored_per_row and factored_packed: one kernel
        return factored(arrays_2d, thresholds, nbins, reduce_all, weights=w2d,
                        finish=finish)


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
#: lookups of ``_THRESHOLD_CACHE`` in this process, and those it served
THRESHOLD_LOOKUPS = 0
THRESHOLD_HITS = 0
_COUNT_LOCK = threading.Lock()  # guards the two counts


@torch.compiler.disable  # host work on numpy edges: run it, do not trace it
def _device_thresholds(edges, compare_dtype, device, cache=True):
    """``(thresholds, n_hi_clip)``: ``bins.compare_form(edges,
    compare_dtype)`` as a tensor on ``device`` (uint64 thresholds flipped
    onto int64, as the data are) and its count of thresholds clamped at the
    top value. With ``cache``, served from ``_THRESHOLD_CACHE``, so a
    repeated call makes no host-to-device copy (``THRESHOLD_LOOKUPS``,
    ``THRESHOLD_HITS``)."""
    global THRESHOLD_LOOKUPS, THRESHOLD_HITS
    key = None
    if cache:
        key = (edges.tobytes(), edges.dtype.str, edges.shape,
               np.dtype(compare_dtype).str, device)
        hit = _THRESHOLD_CACHE.get(key)
        with _COUNT_LOCK:
            THRESHOLD_LOOKUPS += 1
            THRESHOLD_HITS += hit is not None
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


def _same(t, op):
    """The one-card ``agree``: a value every rank holds already."""
    return t


def _f64_groups(wf, amax, agree=_same):
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
    present), which choose the passes. ``amax`` is the largest |weight|.

    ``agree(t, op)`` makes each of those scalars global when ``wf`` is one
    rank's block of sharded weights (an all-reduce "min", "max" or "sum"
    over the mesh), so every rank runs the same passes."""
    if amax == 0.0:
        return []
    s = max(math.frexp(amax)[1] - 62, -1074)  # the top bit of amax is s + 61
    y = _scaled(wf, -s)  # exact, but where a weight far below 2**s underflows
    one_group = torch.stack([(y == torch.trunc(y)).all(),
                             torch.count_nonzero(y) == torch.count_nonzero(wf)])
    note_syncs(wf.device)
    if bool(agree(one_group.to(torch.int32), "min").all()):
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
    lmin = agree(lowest.amin(), "min")
    gid = torch.where(nonzero, (lowest - lmin) // _F64_GROUP_STRIDE, _F64_GROUP_IDS)
    # members per group: bincount's shared-memory histogram (an index_add_
    # serialises on the one or two groups that hold nearly every weight)
    note_syncs(gid.device, 2)  # torch.bincount reads the ids' min and max
    per_group = torch.bincount(gid.reshape(-1), minlength=_F64_GROUP_IDS + 1)
    per_group = agree(per_group[:_F64_GROUP_IDS], "sum")
    note_syncs(wf.device)
    stats = torch.cat([lmin.reshape(1), per_group]).cpu()
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


def _f64_sums(weights, to_2d, n_cols, out_shape, count, agree=_same):
    """Correctly rounded float64 sums of float weights (``precision='f64'``;
    the JAX package's ``_f64_weight_histogram``), ``out_shape`` ``(rows,
    slots)`` on the weights' device, trash slot included.

    The finite weights become exponent groups of int64 integers K on the
    weights' own shape (``_f64_groups``); ``to_2d`` broadcasts each limb
    into the canonical layout only as it is counted. Each K splits into the
    signed limbs of ``_f64_limbs``/``_split_limbs``, which add back to K
    exactly and whose per-slot sums ``count`` adds exactly in int64
    (the int64-weighted kernels, or ``index_add_``): groups x limbs passes,
    two for weights in one group. Each int64 sum enters a double-double
    accumulator exactly, as two doubles (the sum rounded and the int64
    rest, scaled by their power of two), so the one rounding is the final
    ``hi + lo``: correctly rounded to <= 1 ulp, ±inf
    where the exact sum overflows (the TwoSum term is NaN there and is
    masked, as in the JAX package). Nonfinite weights take one float64 pass of their own
    (``count`` again, zeros elsewhere), whose per-slot result adds at the
    end with ``np.bincount``'s semantics. Integer sums do not depend on the
    order of the adds, so the result is bit-identical from run to run.

    Sharded (``parallel.histogram_sharded``), ``weights`` is one rank's
    block, ``count`` all-reduces each pass's sums
    before the combine, ``n_cols`` is the global row length (each limb's
    sum over every rank stays below 2**63), and ``agree`` makes each
    choice of passes global (``_f64_groups``).
    """
    w64 = weights.to(torch.float64)
    # (any weight not finite, the largest |weight| where all are finite)
    top = w64.abs().amax() if w64.numel() else w64.new_zeros(())
    note_syncs(w64.device)
    nonfinite, amax = agree(torch.stack([(~torch.isfinite(top)).to(torch.float64),
                                         torch.where(torch.isfinite(top), top, 0.0)]),
                            "max").tolist()
    wf = w64
    if nonfinite:
        finite = torch.isfinite(w64)
        wf = torch.where(finite, w64, 0.0)
        note_syncs(w64.device)
        amax = float(agree(wf.abs().amax(), "max"))
    width, n_limbs = _f64_limbs(n_cols)
    hi = lo = None
    for s, k in _f64_groups(wf, amax, agree):
        for j, limb in enumerate(_split_limbs(k, width, n_limbs)):
            sums = count(to_2d(limb))  # |sums| < 2**63 - 2**32
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
        h = h + count(to_2d(torch.where(finite, 0.0, w64)))
    return h


def _dtensor_type():
    """``DTensor``, or None while ``torch.distributed.tensor`` is not
    imported (then no operand can be one, and nothing is imported here)."""
    module = sys.modules.get("torch.distributed.tensor")
    return None if module is None else module.DTensor


def _mesh_layout(operands):
    """``(mesh, in_spec)`` when a call should run sharded: some operand of
    the highest rank is a ``DTensor`` over a mesh of more than one rank,
    with no ``Partial`` placement, that is not fully replicated (the
    counterpart of the JAX package's ``_infer_mesh_sharding``). ``in_spec``
    names, for each data axis, the mesh dims (by name, else by index, in
    mesh order) that shard it. Lower-rank sharded operands do not qualify:
    their layout does not describe the broadcast shape."""
    dtensor = _dtensor_type()
    if dtensor is None:
        return None
    ndim_max = max(np.ndim(a) for a in operands)
    for a in operands:
        if not isinstance(a, dtensor) or a.ndim != ndim_max:
            continue
        mesh, placements = a.device_mesh, a.placements
        if (mesh.size() > 1 and not any(p.is_partial() for p in placements)
                and not all(p.is_replicate() for p in placements)):
            names = mesh.mesh_dim_names or tuple(_builtin_range(mesh.ndim))
            spec = []
            for i in _builtin_range(a.ndim):
                on = tuple(n for n, p in zip(names, placements) if p.is_shard(i))
                spec.append(on[0] if len(on) == 1 else (on or None))
            return mesh, tuple(spec)
    return None


def _local_value(x):
    """A ``DTensor`` that does not run sharded as the full tensor it holds
    (its local tensor where it is replicated or on one rank; a ``Partial``
    one reduced), anything else as it is."""
    dtensor = _dtensor_type()
    return x.full_tensor() if dtensor is not None and isinstance(x, dtensor) else x


#: ``bins.resolve_bin_edges``, which ``torch.compile`` runs and does not
#: trace: host work on numpy edges (and on the data for int/str bins)
_resolve_bin_edges = torch.compiler.disable(_bins.resolve_bin_edges)


def _histogram_impl(args, weights, edges_np, bins, axis, *, method, block_size,
                    precision, mesh=None):
    """The raw slot sums of one device's inputs: the counterpart of the JAX
    package's ``_histogram_impl``, before the sums take their dtype.

    ``args`` and ``weights`` are tensors on one device (``_place``),
    ``edges_np`` the edges resolved from ``bins`` (explicit edge arrays'
    thresholds are cached). Returns ``(sums, kept,
    w_dtype)``: ``(rows, prod(nbins) + 1)`` int64 counts or weighted sums in
    their accumulator (float64 for float weights, int32 or int64 for
    integers; 'f64' sums in float64), trash slot included, or, on one
    device, the kernels' sums in their dtype already (the direct kernel
    rounds float sums as it stores them); the kept shape; and the weights'
    dtype where ``bincount.finish_sums`` still gives the sums their dtype,
    else None.

    ``mesh`` (``parallel.sharded``) makes the inputs one rank's block of a
    sharded call: ``mesh.sum(t)`` adds each pass's sums over the ranks
    (inside ``_WeightedSums``, whose backward then gathers the replicated
    gradient at this rank's elements), ``mesh.agree(t, op)`` makes the
    exact tier's choices global, and ``mesh.n_cols`` is the global row
    length.
    """
    n_inputs = len(args)
    device = args[0].device
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
    with scope("edges"):
        nbins = tuple(int(e.shape[0]) - 1 for e in edges_np)
        if min(nbins) < 1:
            raise ValueError("each bins spec must define at least one bin")
        cache = [isinstance(b, np.ndarray) for b in _bins.normalize_bins(bins, n_inputs)]
        thresholds, n_hi_clip = [], []
        for a, e, cached in zip(args, edges_np, cache):
            thr, nh = _device_thresholds(e, _compare_dtype(a), device, cache=cached)
            thresholds.append(thr)
            n_hi_clip.append(nh)

    with scope("canonicalize"):
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
        # the kernels read these views of the caller's memory in place
        operands = arrays if weights is None else [*arrays, weights.expand(shape)]
        layout = strided_layout(operands, axis_t)
    m1, m0, c1, c0 = layout.shape
    m, c = m1 * m0, c1 * c0

    # pallas_hist._dispatch's view: a layout with one row is a full reduction
    reduce_all = full_reduce or m == 1
    n_slots = math.prod(nbins) + 1

    with scope("plan"):
        kernel = plan(n_inputs, nbins, 1 if reduce_all else m, None if reduce_all else c)
        if method in ("cuda", "pallas"):
            # forced outside the efficient envelopes: the general kernel
            kernel = kernel or ("factored" if reduce_all else "direct")
        elif method != "auto" or device.type != "cuda" or any(n_hi_clip):
            kernel = None  # a strategy (the JAX package's auto gate)
        note_route(kernel)

    def to_2d(w):
        """``w`` (of a shape that broadcasts to the call's) as the kernel or
        the plain path reads it."""
        w = layout.apply(w.expand(shape))
        return w if kernel is not None else w.reshape(m, c)

    views = layout.views
    if kernel is None:  # the plain path reads (m, c) layouts, copies or not
        views = [v.reshape(m, c) for v in views]
    elif layout.copied:
        note_layout_copy(len(views))
    arrays_2d = views[:n_inputs]
    w2d = None if weights is None or exact_f64 else views[n_inputs]

    def count(w2d, finish=False):
        """Counts, or sums of ``w2d``, ``(rows, prod(nbins) + 1)``, over
        every rank of a sharded call; with ``finish``, a kernel's sums in
        their ``weighted_dtype``."""
        if kernel is not None:
            sums = _count_fused(method, kernel, arrays_2d, thresholds, nbins,
                                n_hi_clip, reduce_all, w2d, finish)
        else:
            with scope("digitize"):
                indices = [
                    digitize_edges(a, t, n_hi_clip=nh)
                    for a, t, nh in zip(arrays_2d, thresholds, n_hi_clip)
                ]
                g, _ = joint_bin_index(indices, nbins)
            with scope("bincount"):
                sums = slot_sums(
                    g, n_slots, method="scatter" if method == "auto" else method,
                    weights=w2d, block_size=block_size,
                )
        return sums if mesh is None else mesh.sum(sums)

    if exact_f64:
        sums = _f64_sums(
            weights, to_2d, c if mesh is None else mesh.n_cols,
            (1 if reduce_all else m, n_slots), count,
            _same if mesh is None else mesh.agree,
        )
        return sums, kshape, None
    if w2d is None:
        return count(None), kshape, None
    # one device's sums are final: the kernels may round them (a sharded
    # call's partials round once, after the all-reduce)
    with scope("autograd"):  # the autograd Function around the sums
        sums = _WeightedSums.apply(w2d, lambda w: count(w, finish=mesh is None),
                                   arrays_2d, thresholds, nbins, n_hi_clip)
    return sums, kshape, weights.dtype


def _finish_histogram(sums, w_dtype, kshape, edges_np, density):
    """The histogram from ``_histogram_impl``'s sums (over every rank, for a
    sharded call): the sums in their dtype, the trash slot dropped, the
    kept shape and bin axes, and density."""
    with scope("finish"):
        if w_dtype is not None:
            sums = finish_sums(sums, w_dtype)  # sums already in it pass as they are
        nbins = tuple(int(e.shape[0]) - 1 for e in edges_np)
        h = sums[..., :-1].reshape(kshape + nbins)  # drop the trash slot
        if density:
            # per-kept-row totals, areas from the original edges, in the JAX
            # package's order: counts / area / totals, in float32 (float64 for
            # float64 sums)
            if h.dtype == torch.uint64:
                h = h.to(torch.float32)  # torch sums and divides no uint64
            area_dtype = torch.float64 if h.dtype == torch.float64 else torch.float32
            bin_area = torch.as_tensor(
                _bins.bin_areas(edges_np), dtype=area_dtype, device=h.device
            )
            totals = h.sum(dim=tuple(_builtin_range(-len(nbins), 0)), keepdim=True)
            h = h / bin_area / totals
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
        JAX package runs its scatter strategy too, with two exceptions
        past the JAX package's kept-row cap of 2^28 padded slots: one input
        in at most 1024 bins runs the one_input kernel, and rows of fewer
        than 256 elements over at most 8192 slots the direct kernel, which
        need no such cap (``ops.cuda_hist.plan``). 'cuda' forces the fused
        kernel route at any shape, with the JAX package's fallback outside
        ``plan()``'s envelopes (factored for a full reduction, direct for
        kept rows); on a CPU tensor it runs the kernel's plain version.
        'scatter', 'onehot' and 'sort' run that bincount strategy
        (``ops.bincount``) and no kernel, as in the JAX package.
    precision : None | 'split' | 'highest' | 'i8' | 'i8x3' | 'f64'
        The JAX package's weighted-sum precision modes, validated with its
        messages. 'split' to 'i8x3' run the same float64 accumulation and
        the same kernels here, which meets the tightest of their bounds
        ('highest'). 'f64' gives float weights float64 sums that are exact, then
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
    with scope("call", call=True):
        if not args:
            raise ValueError("histogram() requires at least one input array")
        with scope("plan"):  # the route: sharded or not
            sharded = _mesh_layout([*args, *([] if weights is None else [weights])])
        if sharded is not None:
            from .parallel import histogram_sharded

            mesh, in_spec = sharded
            if device is not None and torch.device(device).type != mesh.device_type:
                raise ValueError(
                    f"device={str(device)!r} conflicts with a DTensor input on a "
                    f"{mesh.device_type!r} mesh; histogram() moves no tensor"
                )
            return histogram_sharded(
                *args, mesh=mesh, in_spec=in_spec, bins=bins, range=range, axis=axis,
                weights=weights, density=density, block_size=block_size,
                method=method, precision=precision,
            )
        with scope("canonicalize"):  # the inputs as tensors on one device
            args = [_coerce_host(_local_value(a)) for a in args]
            if weights is not None:
                weights = _coerce_weights(_local_value(weights))
                args.append(weights)
            args = _place(args, device)
            device = args[0].device
            if any(a.device != device for a in args):
                raise ValueError(
                    "histogram inputs must lie on one device, got "
                    f"{[str(a.device) for a in args]}"
                )
            if weights is not None:
                *args, weights = args

        with scope("edges"):
            edges_np = _resolve_bin_edges(args, bins, range, weights)
        sums, kshape, w_dtype = _histogram_impl(
            args, weights, edges_np, bins, axis, method=method, block_size=block_size,
            precision=precision,
        )
        return _finish_histogram(sums, w_dtype, kshape, edges_np, density), edges_np
