"""Shared inputs and numpy references of the port's tests and of
``chip_smoke.py`` (numpy only: no JAX, nothing of the JAX package)."""

import numpy as np

T_EDGES = np.linspace(-2.0, 30.0, 281).astype(np.float32)
S_EDGES = np.linspace(30.0, 40.0, 341).astype(np.float32)

EDGE_SETS = {
    "ts": (T_EDGES, S_EDGES),
    "8x9": (np.linspace(-1.0, 1.0, 9), np.linspace(-1.0, 1.0, 10)),  # 0.0 edge
    "f64-last": (np.array([0.0, 0.1, 0.30000000000000004]), np.array([0.0, 1.0])),
}


def ts_data(shape, seed):
    """T–S data as bench.py draws it: T = 14 + 8 N(0,1), S = 35 + 1.5 N(0,1)."""
    rng = np.random.default_rng(seed)
    t = (14.0 + 8.0 * rng.standard_normal(shape)).astype(np.float32)
    s = (35.0 + 1.5 * rng.standard_normal(shape)).astype(np.float32)
    return t, s


def edge_case_data(te, se, n_random=64, seed=0):
    """Each edge, one ulp either side, NaN, ±inf, ±0 and the smallest
    subnormals in both coordinates, crossed with in-range partners."""
    specials = []
    for e in (te, se):
        e = np.asarray(e, np.float32)
        specials.append(np.concatenate([
            e,
            np.nextafter(e, np.float32(-np.inf)),
            np.nextafter(e, np.float32(np.inf)),
            np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, -1e-45, 1e-45],
                     np.float32),
        ]))
    rng = np.random.default_rng(seed)
    mid_t = np.float32(np.median(te))
    mid_s = np.float32(np.median(se))
    t = np.concatenate([specials[0], np.full(len(specials[1]), mid_t, np.float32),
                        rng.choice(specials[0], n_random)])
    s = np.concatenate([np.full(len(specials[0]), mid_s, np.float32), specials[1],
                        rng.choice(specials[1], n_random)])
    return t, s


def numpy_hist2d(t, s, te, se):
    """numpy's joint histogram in float64, as int64 counts."""
    h, _, _ = np.histogram2d(
        np.ravel(t).astype(np.float64), np.ravel(s).astype(np.float64),
        bins=[np.asarray(te, np.float64), np.asarray(se, np.float64)],
    )
    return h.astype(np.int64)


def edge_case_values(edges, n_random=64, seed=0):
    """One input's edge cases: each edge, one ulp either side, NaN, ±inf,
    ±0 and the smallest subnormals, then random picks among them."""
    e = np.asarray(edges, np.float32)
    specials = np.concatenate([
        e,
        np.nextafter(e, np.float32(-np.inf)),
        np.nextafter(e, np.float32(np.inf)),
        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, -1e-45, 1e-45], np.float32),
    ])
    rng = np.random.default_rng(seed)
    return np.concatenate([specials, rng.choice(specials, n_random)])


def _searchsorted_inclusive(a, edges):
    """The reference's digitize: searchsorted-right, with values on the last
    edge moved into the last bin (reference core.py:163-174)."""
    idx = np.searchsorted(edges, a, side="right")
    idx[a == edges[-1]] -= 1
    return idx


def reference_numpy_ts(t, s, t_edges, s_edges):
    """The reference's exact numpy hot path for the T–S diagram: the port's
    own copy of ``bench.py::reference_numpy_ts`` (reference core.py:73-83,
    163-186): searchsorted-right with inclusive last edge, ravel to joint
    bins, one flat bincount, trim the out-of-range slots."""
    hist_shapes = [len(t_edges) + 1, len(s_edges) + 1]
    it = _searchsorted_inclusive(t.ravel(), t_edges)
    is_ = _searchsorted_inclusive(s.ravel(), s_edges)
    flat = np.ravel_multi_index([it, is_], hist_shapes)
    bc = np.bincount(flat, minlength=hist_shapes[0] * hist_shapes[1])
    return bc.reshape(hist_shapes)[1:-1, 1:-1]


def reference_numpy(a, edges, axis=None):
    """One input's reference histogram, in the style of
    ``benchmarks/run_baselines.py::reference_numpy``: ``axis`` (a tuple, or
    None for every axis) is reduced, the other axes are kept as rows, and
    each row gets one offset bincount. int64 counts shaped
    ``kept + (nb,)``."""
    if axis is None:
        a2, kept = a.reshape(1, -1), ()
    else:
        kept_axes = [i for i in range(a.ndim) if i not in axis]
        kept = tuple(a.shape[i] for i in kept_axes)
        moved = np.moveaxis(a, axis, tuple(range(-len(axis), 0)))
        a2 = moved.reshape(int(np.prod(kept, dtype=np.int64)), -1)
    n = len(edges) + 1
    idx = _searchsorted_inclusive(a2, edges)
    m = idx.shape[0]
    off = (idx + n * np.arange(m)[:, None]).ravel()
    counts = np.bincount(off, minlength=n * m).reshape(m, n)
    return counts[:, 1:-1].reshape(kept + (n - 2,)).astype(np.int64)


def reference_numpy_joint(arrays, edges, axis=None):
    """N inputs' joint histogram with numpy's ``histogramdd``, in float64:
    the inputs broadcast against each other, ``axis`` (a tuple, or None for
    every axis) is reduced and the other axes are kept as rows. int64
    counts shaped ``kept + nbins``."""
    arrays = np.broadcast_arrays(*(np.asarray(a) for a in arrays))
    edges = [np.asarray(e, np.float64) for e in edges]
    nbins = tuple(len(e) - 1 for e in edges)
    if axis is None:
        kept, flat = (), [a.reshape(1, -1) for a in arrays]
    else:
        kept = tuple(n for i, n in enumerate(arrays[0].shape) if i not in axis)
        m = int(np.prod(kept, dtype=np.int64))
        c = int(np.prod([arrays[0].shape[i] for i in axis], dtype=np.int64))
        flat = [np.moveaxis(a, axis, tuple(range(-len(axis), 0))).reshape(m, c)
                for a in arrays]
    out = np.zeros((flat[0].shape[0],) + nbins, np.int64)
    for r in range(flat[0].shape[0]):
        sample = np.stack([x[r].astype(np.float64) for x in flat], -1)
        out[r] = np.histogramdd(sample, bins=edges)[0]
    return out.reshape(kept + nbins)


def reference_numpy_weighted(arrays, edges, weights, axis=None, exact=False):
    """numpy's weighted joint histogram: the inputs and the weights
    broadcast against each other, ``axis`` (a tuple, or None for every
    axis) is reduced and the other axes are kept as rows; each input is
    compared in float64 with an inclusive last edge, as numpy does. float64
    sums in ``np.bincount``'s order, or (``exact=True``, integer weights)
    exact Python-int sums in an object array. Shaped ``kept + nbins``."""
    *arrays, w = np.broadcast_arrays(*(np.asarray(a) for a in arrays),
                                     np.asarray(weights))
    nbins = tuple(len(e) - 1 for e in edges)
    shape = arrays[0].shape
    if axis is None:
        kept, rows = (), (lambda a: a.reshape(1, -1))
    else:
        kept = tuple(n for i, n in enumerate(shape) if i not in axis)
        m = int(np.prod(kept, dtype=np.int64))
        rows = (lambda a: np.moveaxis(a, axis, tuple(range(-len(axis), 0)))
                .reshape(m, -1))
    flat, valid = 0, True
    for a, e, nb in zip(arrays, edges, nbins):
        idx = _searchsorted_inclusive(rows(a).astype(np.float64),
                                      np.asarray(e, np.float64)) - 1
        valid = valid & (idx >= 0) & (idx < nb)
        flat = flat * nb + np.clip(idx, 0, nb - 1)
    n = int(np.prod(nbins))
    m = flat.shape[0]
    off = (flat + n * np.arange(m)[:, None])[valid]
    w = rows(w)[valid]
    if exact:
        out = np.zeros(m * n, object)
        np.add.at(out, off, w.astype(object))
    else:
        out = np.bincount(off, weights=w.astype(np.float64), minlength=m * n)
    return out.reshape(kept + nbins)
