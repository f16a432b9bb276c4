"""``xhistogram_torch.parallel.histogram_sharded(*inputs, mesh=mesh,
in_spec=in_spec, bins=edges, axis=axis)`` on DTensors that hold each
rank's slab, the same call every time, on every rank of the cell.

The mesh is one dim over all ranks (``mesh_dims``); data axis ``i`` is
``Shard(i)`` on the mesh dim that ``in_spec[i]`` names. The answer judged
is this rank's local histogram, which the program's all-reduce makes the
whole record's on every rank. The reference histograms this rank's slab
alone and adds the ranks' parts with the harness's own group
(``ranks.sum``), never with the program's all-reduce.
"""

from __future__ import annotations

import math

from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

import xhistogram_torch.parallel as parallel

from portbench import reference
from portbench.calls import Calls, edges_of, nbytes

#: the call runs on every rank of a process group: the harness starts one
#: process a card (``portbench/ranks.py``) and passes ``ranks``
RANKS = True


def build(data, traffic, device, ranks):
    names = tuple(traffic["mesh_dims"])
    mesh = init_device_mesh(device.type, (ranks.world,), mesh_dim_names=names)
    in_spec = tuple(traffic["in_spec"])
    local = [data[name] for name in traffic["inputs"]]
    placements = [Replicate()] * mesh.ndim
    shape = list(local[0].shape)
    for i, name in enumerate(in_spec):
        if name is not None:
            placements[names.index(name)] = Shard(i)
            shape[i] *= mesh.size(names.index(name))
    stride = tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))
    inputs = [DTensor.from_local(x, mesh, placements, run_check=False, shape=tuple(shape),
                                 stride=stride) for x in local]
    edges = edges_of(data, traffic)
    axis = traffic.get("axis")
    axis = None if axis is None else tuple(axis)

    def program(item):
        return parallel.histogram_sharded(*inputs, mesh=mesh, in_spec=in_spec, bins=edges,
                                          axis=axis)

    def answer(out):
        h, got_edges = out
        return {"hist": h.to_local(), "edges": got_edges}

    def expected(item, lowp=None):
        part = reference.histogram(local, edges, axis, None, lowp)
        return {"hist": ranks.sum(part), "edges": edges}

    read = sum(nbytes(x) for x in local)
    out = answer(program(None))["hist"]  # one call to size the output
    return Calls([None], program, answer, expected, [read], [nbytes(out)], [0])
