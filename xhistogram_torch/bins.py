"""Bin-edge specification handling (host side, numpy).

Counterpart of ``xhistogram_tpu.bins`` lines 40-391, copied logic for logic
so that both packages digitize against identical thresholds. Bin edges are
host metadata: int/str specs are resolved with ``np.histogram_bin_edges`` on
a host copy of the data, exactly as the reference does (reference
core.py:382-388). Torch tensors given as edges or as data for an int/str
spec are copied to the host.

Semantics contracts replicated from the reference:
  - ``normalize_bins``  ~ ``_ensure_correctly_formatted_bins`` (core.py:37-48)
  - ``normalize_range`` ~ ``_ensure_correctly_formatted_range`` (core.py:51-70)

The uniform-spacing certificates (``uniform_form`` and the ``_ds_*``
helpers) are not here: only the factored and direct kernels consume them,
and those are not ported yet.
"""

from __future__ import annotations

import math
from collections.abc import Iterable
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "concrete_edges",
    "normalize_bins",
    "normalize_range",
    "resolve_bin_edges",
    "validate_edges",
    "is_traced",
    "int_thresholds",
    "bin_centers",
    "bin_widths",
    "bin_areas",
    "CompareEdges",
    "compare_form",
]


def is_traced(x) -> bool:
    """Always False: PyTorch runs eagerly, so every value is concrete."""
    return False


def _host(x):
    """numpy view of a torch tensor (copied to the host; bfloat16, which
    numpy lacks, as float32); others unchanged."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return x


def concrete_edges(b):
    """Host view of an explicit edge array: torch tensors become numpy
    (edge values feed the host-side exactness transforms, which need float64
    host arithmetic). Other values pass through untouched (int/str specs,
    numpy arrays, lists)."""
    return _host(b)


def normalize_bins(bins, n_expected):
    """Normalize a bins spec to a per-input list of length ``n_expected``.

    Accepts an int, str, or 1-D array (applied to every input), or a list with
    one entry per input. Raises ``ValueError`` on missing bins or a length
    mismatch — the same contract as the reference (core.py:37-48).
    """
    if bins is None:
        raise ValueError("bins must be provided")
    bins = concrete_edges(bins)
    if isinstance(bins, (int, str, np.ndarray)):
        bins = n_expected * [bins]
    if len(bins) == n_expected:
        return [concrete_edges(b) for b in bins]
    raise ValueError("The number of bin definitions doesn't match the number of args")


def normalize_range(range_, n_expected):
    """Normalize a range spec to a per-input list of ``(lo, hi)`` or ``None``.

    Same contract as the reference (core.py:51-70): a single ``(lo, hi)`` pair
    is replicated per input; a list must have one pair per input.
    """

    def _iterable_nested(x):
        return all(isinstance(i, Iterable) for i in x)

    if range_ is None:
        return n_expected * [None]
    if (len(range_) == 2) and (not _iterable_nested(range_)):
        return n_expected * [range_]
    if len(range_) == n_expected:
        if all(len(x) == 2 for x in range_):
            return list(range_)
        raise ValueError(
            "range should be provided as (lower_range, upper_range). In the "
            "case of multiple args, range should be a list of such tuples"
        )
    raise ValueError("The number of ranges doesn't match the number of args")


def _view_datetime_as_int(x):
    """View datetime64/timedelta64 numpy data as int64 (order-preserving)."""
    if isinstance(x, np.ndarray) and x.dtype.kind in "Mm":
        return x.view("i8")
    return x


def validate_edges(e):
    """Validate one explicit bin-edge array; returns it (datetime viewed
    as int64).

    Raises
    ------
    TypeError
        complex edges (complex numbers define no binning order).
    ValueError
        non-1-D arrays; fewer than two edges; NaN edges; any decreasing
        adjacent pair (numpy's exact message). Equal adjacent edges
        (zero-width bins) remain allowed, as in numpy.
    """
    e = _view_datetime_as_int(np.asarray(e))
    if e.dtype.kind == "c":
        raise TypeError("complex bin edges are not supported")
    if e.ndim != 1:
        raise ValueError("bin edge arrays must be 1-D")
    if e.shape[0] < 2:
        raise ValueError("each bins spec must define at least one bin")
    if e.dtype.kind == "f" and np.isnan(e).any():
        raise ValueError("bin edges must not contain NaN")
    if np.any(e[:-1] > e[1:]):
        raise ValueError("bins must increase monotonically")
    return e


def resolve_bin_edges(arrays, bins, range_=None, weights=None):
    """Resolve per-input bin specs to concrete 1-D numpy edge arrays.

    ``arrays`` are the (broadcast-compatible) inputs, numpy or torch.
    Explicit edge arrays pass through ``validate_edges``; int/str specs are
    resolved with ``np.histogram_bin_edges`` on host copies of the fully
    broadcast data and weights (the reference's broadcast-before-resolve
    order, reference core.py:366-388: the weights may have more dimensions
    than any input).
    """
    n = len(arrays)
    bins = normalize_bins(bins, n)
    ranges = normalize_range(range_, n)

    edges = []
    arrs_np = None
    w_np = None
    for i, (b, r) in enumerate(zip(bins, ranges)):
        if isinstance(b, np.ndarray):
            edges.append(validate_edges(b))
            continue
        if arrs_np is None:
            arrs_np = [_view_datetime_as_int(np.asarray(_host(a))) for a in arrays]
            if weights is not None:
                bc = np.broadcast_arrays(*arrs_np, np.asarray(_host(weights)))
                arrs_np, w_np = list(bc[:-1]), bc[-1]
            elif len(arrs_np) > 1:
                arrs_np = list(np.broadcast_arrays(*arrs_np))
        edges.append(np.histogram_bin_edges(arrs_np[i], bins=b, range=r, weights=w_np))
    return edges


def _min_int_cast_ge(e):
    """Smallest integer v with ``np.float64(v) >= e`` (e: finite float64).

    numpy histograms integer data against float edges by casting the data to
    float64 first (lossy above 2**53), so the exact integer threshold is the
    cast-rounding cutover, not ``ceil(e)``. The cutover lies within one ulp
    of the midpoint between ``e`` and its predecessor; a ≤3-step scan with
    ``float(v)`` (exact round-to-nearest-even) pins it, tie rule included.
    """
    from fractions import Fraction

    prev = float(np.nextafter(e, -np.inf))
    if math.isinf(prev):  # e is the most-negative finite float
        v = math.floor(float(e)) - 2
    else:
        m = (Fraction(prev) + Fraction(float(e))) / 2
        v = math.floor(m) - 1
    while float(v) < e:
        v += 1
    return v


def int_thresholds(edges, data_dtype=None):
    """Exact integer compare-form thresholds for integer data.

    Returns a list ``[t_0 .. t_{E-1}]`` of python ints (or ``±math.inf``)
    such that for any integer value v: bin k ⟺ ``t_k <= v < t_{k+1}``,
    below-range ⟺ ``v < t_0``, above-range ⟺ ``v >= t_{E-1}``. Float edges
    replicate numpy's semantics bit-exactly: numpy casts integer data to
    float64 before comparing, so the thresholds are the cast-rounding
    cutovers (``_min_int_cast_ge``).

    Integer edges follow numpy's promotion rule against ``data_dtype``:
    same-signedness pairs compare exactly in integers, but mixed
    int64/uint64 promotes to float64 in numpy, so BOTH sides go through the
    lossy cast.
    """
    e = np.asarray(edges)
    n = e.shape[0]
    if np.issubdtype(e.dtype, np.integer):
        lossy = (
            data_dtype is not None
            and np.issubdtype(
                np.result_type(e.dtype, np.dtype(data_dtype)), np.floating
            )
        )
        if not lossy:
            return [int(v) for v in e[:-1]] + [int(e[-1]) + 1]
        e = e.astype(np.float64)  # numpy compares through this lossy cast
    ts = []
    for j in range(n):
        v = float(e[j])
        if math.isnan(v):
            raise ValueError("bin edges must not contain NaN")
        if j < n - 1:
            if math.isinf(v):
                ts.append(v)  # ±inf: beyond every representable integer
            else:
                ts.append(_min_int_cast_ge(v))
        else:
            # closed last bin: in-range ⟺ float64(v) <= e_last, so the
            # exclusive bound is the smallest int casting strictly above it
            if v == math.inf:
                ts.append(math.inf)
            elif v == -math.inf:
                ts.append(-math.inf)
            else:
                nxt = float(np.nextafter(v, np.inf))
                ts.append(
                    math.inf if math.isinf(nxt) else _min_int_cast_ge(nxt)
                )
    return ts


class CompareEdges(NamedTuple):
    """Device comparison form of a bin-edge array (see ``compare_form``)."""

    edges: np.ndarray  # half-open thresholds in the data dtype
    n_hi_clip: int  # thresholds clamped at the dtype's top value: a
    # digitize of ``v == top`` must subtract this count
    # (those thresholds are really above every value)


def compare_form(edges, dtype) -> CompareEdges:
    """Exact device-comparison form of a bin-edge array: half-open intervals
    in the data's dtype.

    Histogram semantics are defined by comparisons of data values against the
    (possibly wider-precision) edges: ``[e_k, e_{k+1})`` per bin, last bin
    closed (reference core.py:163-174). For data of dtype D, those
    wider-precision comparisons are *exactly* equivalent to D-native
    comparisons against transformed edges:

      - ``a >= e``  ⟺  ``a >= ceil_D(e)``  (smallest D value ≥ e)
      - ``a < e``   ⟺  ``a < ceil_D(e)``
      - ``a <= e_last`` (closed last bin)  ⟺  ``a < nextafter(floor_D(e_last))``

    so the returned array encodes every bin as half-open over dtype-D edges,
    with the closed last bin folded into an open upper bound.

    Thresholds that land *above* the dtype's top value (int dtype max, or
    float +inf from a last edge exactly at +inf) cannot be represented as an
    exclusive bound; they are clamped to the top value and counted in
    ``n_hi_clip``: the digitize subtracts that count for elements equal to
    the top value (``ops.digitize`` honors this).
    """
    e = np.asarray(edges)
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        ts = int_thresholds(e, data_dtype=dtype)
        clamped = [min(max(t, info.min), info.max) for t in ts]
        n_hi = sum(1 for t in ts if t > info.max)
        return CompareEdges(np.array(clamped, dtype=dtype), n_hi)

    # float data dtype: numpy promotes the comparison to float64, so integer
    # edge arrays FIRST go through the (lossy above 2**53) f64 cast
    if np.issubdtype(e.dtype, np.integer):
        e = e.astype(np.float64)
    cast = e.astype(dtype)
    wide = cast.astype(e.dtype) if e.dtype.itemsize > dtype.itemsize else cast
    # ceil-cast: bump edges that rounded down by one ulp
    bump = wide < e
    ceil_cast = np.where(
        bump, np.nextafter(cast, np.asarray(np.inf, dtype)), cast
    ).astype(dtype)
    # closed last bin → open upper bound at nextafter(floor_cast(e_last))
    last_cast = e[-1:].astype(dtype)
    last_wide = last_cast.astype(e.dtype)
    floor_cast = np.where(
        last_wide > e[-1:],
        np.nextafter(last_cast, np.asarray(-np.inf, dtype)),
        last_cast,
    ).astype(dtype)
    upper = np.nextafter(floor_cast, np.asarray(np.inf, dtype))
    # a last edge exactly at +inf means the closed last bin contains +inf
    # itself; there is no float strictly above +inf, so the exclusive bound
    # clamps at +inf and the digitize subtracts 1 for ``a == +inf``.
    n_hi = int(np.isinf(e[-1]) and e[-1] > 0)
    return CompareEdges(
        np.concatenate([ceil_cast[:-1], upper]).astype(dtype), n_hi
    )


def bin_centers(edges):
    """Midpoints of a 1-D edge array (reference xarray.py:179)."""
    edges = np.asarray(edges)
    return 0.5 * (edges[:-1] + edges[1:])


def bin_widths(edges):
    return np.diff(np.asarray(edges))


def bin_areas(edges_list):
    """N-dimensional bin areas as the outer product of per-input bin widths
    (the density geometry of reference core.py:447-454)."""
    widths = [bin_widths(e).astype(np.float64) for e in edges_list]
    area = widths[0]
    for w in widths[1:]:
        area = area[..., None] * w
    return area
