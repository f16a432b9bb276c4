"""numpy-signature convenience wrappers: drop-in ``histogram`` /
``histogram2d`` / ``histogramdd`` running on the port's pipeline.

Counterpart of ``xhistogram_tpu.compat``. The reference's users often mix
``xhistogram.core.histogram`` with plain ``np.histogram*`` calls for full
reductions; these wrappers let that code move wholesale. Semantics follow
numpy (density, range, weights, the closed last bin, the bins-argument
conventions of each function) and so do the results: numpy arrays in
numpy's output dtypes. Inputs run on the card unless ``device=`` says
otherwise (tensors where they lie), as in ``core.histogram``, to which
every other keyword passes.

numpy signature sources: ``np.histogram(a, bins=10, range=None, ...)``,
``np.histogram2d(x, y, bins=10, ...)`` (bins: int | 1-D edge array |
length-2 sequence of per-dim specs), ``np.histogramdd(sample, bins=10,
...)`` (sample: (N, D), (N,) treated as (N, 1), or a length-D sequence of
length-N arrays; bins: int | length-D sequence of per-dim specs).
"""

from __future__ import annotations

import numpy as np
import torch

from .bins import _host
from .core import histogram as _histogram

__all__ = ["histogram", "histogram2d", "histogramdd"]

# `range` is a histogram keyword below (numpy's API does the same dance)
_builtin_range = range


def _np_result(h, dtype):
    """numpy-faithful output dtype (probed against numpy): ``np.histogram``
    returns intp (int64) counts, the WEIGHTS' dtype for weighted sums,
    float64 for density; ``np.histogram2d`` / ``np.histogramdd`` return
    float64 ALWAYS (their accumulator is created as float). Integer weights
    of 32 bits or fewer sum mod 2**32 (the main API's wrap contract), where
    numpy's int64 accumulator wraps only at 2**64."""
    return _host(h).astype(dtype, copy=False)


def _histogram1d_dtype(weights, density):
    if density:
        return np.float64
    if weights is None:
        return np.intp
    if isinstance(weights, torch.Tensor):
        return _host(weights[:0]).dtype
    return np.asarray(weights).dtype


def histogram(a, bins=10, range=None, weights=None, density=False,
              **kwargs):
    """np.histogram-compatible: full reduction of one input."""
    if isinstance(bins, (list, tuple)):
        # numpy treats a flat sequence as ONE edge array; core.histogram
        # would read a list as per-input specs
        bins = np.asarray(bins)
    h, edges = _histogram(
        a, bins=bins, range=range, weights=weights, density=density,
        **kwargs,
    )
    return _np_result(h, _histogram1d_dtype(weights, density)), edges[0]


def _split_2d_bins(bins):
    """np.histogram2d's bins convention → per-input list: any length-2
    sequence (list/tuple/ndarray) is per-dim specs; a longer 1-D array is
    shared edges; a scalar int/str applies to both dims (numpy's exact
    N==1/N==2 logic)."""
    try:
        n = len(bins)
    except TypeError:
        return [bins, bins]
    if n == 2:
        return [bins[0], bins[1]]
    if isinstance(bins, (list, tuple)):
        bins = np.asarray(bins)
    if getattr(bins, "ndim", None) == 1:
        return [bins, bins]  # shared edge array
    raise ValueError(
        "histogram2d bins must be an int, a 1-D edge array, or a "
        "length-2 sequence of per-dim specs"
    )


def histogram2d(x, y, bins=10, range=None, weights=None, density=False,
                **kwargs):
    """np.histogram2d-compatible: joint histogram of two 1-D inputs."""
    h, edges = _histogram(
        x, y,
        bins=_split_2d_bins(bins),
        range=range,
        weights=weights,
        density=density,
        **kwargs,
    )
    return _np_result(h, np.float64), edges[0], edges[1]


def histogramdd(sample, bins=10, range=None, weights=None, density=False,
                **kwargs):
    """np.histogramdd-compatible: sample is (N, D) — or (N,), treated as
    (N, 1) like numpy — or a length-D sequence of length-N arrays."""
    if isinstance(sample, (list, tuple)):
        arrays = list(sample)
    else:
        arr = sample
        if not hasattr(arr, "ndim"):
            arr = np.asarray(arr)
        if arr.ndim == 1:
            arrays = [arr]
        elif arr.ndim == 2:
            arrays = [arr[:, d] for d in _builtin_range(arr.shape[1])]
        else:
            raise ValueError(
                "histogramdd sample must be (N, D), (N,), or a sequence "
                "of D 1-D arrays"
            )
    d = len(arrays)
    # numpy: any length-D sequence (incl. ndarray) of specs is per-dim;
    # a scalar replicates
    try:
        m = len(bins)
    except TypeError:
        m = None
    if m is not None:
        if m != d:
            raise ValueError(
                f"bins sequence length {m} != sample dimension {d}"
            )
        bins_list = [bins[i] for i in _builtin_range(d)]
    else:
        bins_list = [bins] * d
    h, edges = _histogram(
        *arrays, bins=bins_list, range=range, weights=weights,
        density=density, **kwargs,
    )
    return _np_result(h, np.float64), edges
