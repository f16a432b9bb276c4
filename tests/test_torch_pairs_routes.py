"""Inputs of two dtypes on the flat-slot routes, against the JAX package.

factored (full, per row, packed) and direct read every mix of the eleven
data dtypes in place: float32 and narrow inputs through their narrow
entries, every other mix through their mixed entries (``csrc/slot_narrow.cu``,
``slot_mixed.cu``, ``direct_rows_narrow.cu``, ``direct_rows_mixed.cu``), where
wide pairs of two dtypes once widened a float64 copy of both. On the CPU
each wrapper runs its plain version, the one the kernels are held to on the
card; the public call on each route must give the JAX package's
``_factored_kernel`` or ``_direct_kernel`` result under the Pallas
interpreter, counts and integer sums bit for bit, float sums within the
'highest' bound, for joint2's compile-time pairs and a sample of the rest.
Each pair runs unweighted on one route and with a weight of each
accumulator class on the other three, in turn.
"""

import numpy as np
import pytest

from pair_cases import PUBLIC_PAIRS, WEIGHT_DTYPES, assert_matches_jax

_BYTES = ("int8", "uint8", "bool")


def _route_case(route, pair):
    """(shape, axis, bins a input) of a route: the full reduction past
    joint2's gate (the 8-bit and bool input takes 16 bins, the other 1530),
    per row at rows of 300, packed at 100 x 90 slots, direct at 12 x 15."""
    if route == "factored":
        if pair[0] in _BYTES:
            return (2, 300), None, (16, 1530)
        if pair[1] in _BYTES:
            return (2, 300), None, (1530, 16)
        return (2, 300), None, (800, 800)
    return {"factored_per_row": ((3, 300), (1,), (150, 90)),
            "factored_packed": ((4, 64), (1,), (100, 90)),
            "direct": ((6, 40), (1,), (12, 15))}[route]


ROUTES = ("factored", "factored_per_row", "factored_packed", "direct")
CASES = [(pair, route, WEIGHT_DTYPES[(i + j) % len(WEIGHT_DTYPES)])
         for i, pair in enumerate(PUBLIC_PAIRS) for j, route in enumerate(ROUTES)]


@pytest.mark.parametrize(
    "pair,route,wdtype", CASES,
    ids=[f"{'-'.join(p)}-{r}-{getattr(w, '__name__', w)}" for p, r, w in CASES])
def test_slot_pairs_match_the_jax_kernels(monkeypatch, pair, route, wdtype):
    shape, axis, nbins = _route_case(route, pair)
    assert_matches_jax(monkeypatch, pair, route, shape, axis, nbins, wdtype,
                       seed=PUBLIC_PAIRS.index(pair) + 100)
