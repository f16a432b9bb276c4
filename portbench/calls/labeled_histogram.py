"""``xhistogram_torch.labeled.histogram(*named, bins=edges, dim=dim)`` on
``NamedArray``s carrying the data's dims and coordinates, the same call
every time. The answer is the counts with the output's dims and kept
coordinates and its bin centres."""

from __future__ import annotations

import xhistogram_torch.labeled as labeled

from portbench import reference
from portbench.calls import Calls, edges_of, nbytes


def build(data, traffic, device):
    dims = tuple(traffic["dims"])
    coords = {c: data[c] for c in traffic.get("coords", ())}
    named = [labeled.NamedArray(data[name], dims, coords=coords, name=name)
             for name in traffic["inputs"]]
    edges = edges_of(data, traffic)
    dim = tuple(traffic["dim"])
    kept = tuple(d for d in dims if d not in dim)
    bin_dims = tuple(f"{name}_bin" for name in traffic["inputs"])

    def program(item):
        return labeled.histogram(*named, bins=edges, dim=dim, device=device)

    def answer(out):
        labels = {"dims": tuple(out.dims)}
        for c in (*kept, *bin_dims):
            labels[c] = out.coords[c].data if c in out.coords else None
        return {"hist": out.data, "labels": labels}

    def expected(item, lowp=None):
        axis = tuple(dims.index(d) for d in dim)
        labels = {"dims": (*kept, *bin_dims)}
        labels.update({c: coords[c] for c in kept if c in coords})
        labels.update({b: 0.5 * (e[:-1] + e[1:])  # xhistogram's bin centres
                       for b, e in zip(bin_dims, edges)})
        hist = reference.histogram([n.data for n in named], edges, axis, None, lowp)
        return {"hist": hist, "labels": labels}

    read = sum(nbytes(n.data) for n in named)
    out = program(None).data
    return Calls([None], program, answer, expected, [read], [nbytes(out)], [0])
