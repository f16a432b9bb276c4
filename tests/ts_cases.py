"""Shared inputs of the port's joint2 tests (numpy only, no JAX)."""

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
