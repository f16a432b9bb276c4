"""``xhistogram_torch.histogram(*inputs, bins=edges, axis=axis,
weights=weights)`` over the whole data, the same call every time."""

from __future__ import annotations

import xhistogram_torch

from portbench import reference
from portbench.calls import Calls, edges_of, nbytes


def build(data, traffic, device):
    inputs = [data[name] for name in traffic["inputs"]]
    edges = edges_of(data, traffic)
    weights = data[traffic["weights"]] if traffic.get("weights") else None
    axis = traffic.get("axis")
    axis = None if axis is None else tuple(axis)

    def program(item):
        return xhistogram_torch.histogram(*inputs, bins=edges, axis=axis, weights=weights)

    def answer(out):
        h, got_edges = out
        return {"hist": h, "edges": got_edges}

    def expected(item, lowp=None):
        return {"hist": reference.histogram(inputs, edges, axis, weights, lowp),
                "edges": edges}

    read = sum(nbytes(x) for x in inputs) + (nbytes(weights) if weights is not None else 0)
    out = program(None)[0]  # one call to size the output
    return Calls([None], program, answer, expected, [read], [nbytes(out)], [0])
