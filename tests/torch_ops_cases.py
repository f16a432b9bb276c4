"""The DTensor cases of ``tests/test_torch_ops.py``, run on gloo ranks.

Each case hands DTensors straight to a kernel op (``torch.ops.xhistogram``)
on a (2, 2) mesh of four CPU ranks, with the data sharded over ("r", "c")
(the layout of ``tests/test_custom_partitioning.py``), records the
collectives that ran inside the op (``CommDebugMode``), the output's
placements, and the full result, which the test holds against the op on
the full tensors; ``view_cases`` do the same for (m1, m0, c1, c0) views. ``run`` is a rank's side (``tests/torch_dist.py``).
"""

import numpy as np

EDGES = np.linspace(0.0, 1.0, 8)  # 7 bins


def cases():
    """name -> (op name, its arguments but the mesh: numpy data, weights
    or None, and the op's other arguments)."""
    rng = np.random.RandomState(0)
    a, b = rng.rand(16, 96).astype("f4"), rng.rand(16, 96).astype("f4")
    w = rng.rand(16, 96).astype("f4")
    wi = rng.randint(-(2**31), 2**31, (16, 96)).astype(np.int32)
    return {
        "one_input-kept": ("one_input", [a], None, (7, False)),
        "one_input-kept-weighted": ("one_input", [a], w, (7, False)),
        "one_input-full": ("one_input", [a], None, (7, True)),
        "one_input-full-int32-weights": ("one_input", [a], wi, (7, True)),
        "joint2": ("joint2", [a, b], None, (7, 7)),
        "joint2-weighted": ("joint2", [a, b], w, (7, 7)),
        "factored-full": ("factored", [a, b], None, ([7, 7], True)),
        "factored-rows-weighted": ("factored", [a, b], w, ([7, 7], False)),
        "factored-rows": ("factored", [a, b], None, ([7, 7], False)),
        "direct": ("direct", [a, b], None, ([7, 7],)),
        "direct-weighted": ("direct", [a, b], w, ([7, 7],)),
    }


def view_cases():
    """name -> (op name, numpy data, weights or None, the op's other
    arguments, the dims sharded over ("r", "c")): the ops on (m1, m0, c1,
    c0) views, sharded on both kept dims or on both reduced ones."""
    rng = np.random.RandomState(1)
    a, b, w = (rng.rand(4, 4, 8, 12).astype("f4") for _ in range(3))
    return {
        "view-one_input-kept": ("one_input", [a], w, (7, False), (0, 1)),
        "view-one_input-full": ("one_input", [a], None, (7, True), (2, 3)),
        "view-factored-rows": ("factored", [a, b], w, ([7, 7], False), (0, 1)),
        "view-factored-columns": ("factored", [a, b], None, ([7, 7], False), (2, 3)),
        "view-factored-full": ("factored", [a, b], w, ([7, 7], True), (0, 1)),
        "view-direct": ("direct", [a, b], None, ([7, 7],), (0, 1)),
        "view-direct-columns": ("direct", [a, b], w, ([7, 7],), (2, 3)),
    }


def call(op, data, thresholds, weights, rest):
    """The op on these operands (tensors or DTensors)."""
    import torch

    ops = torch.ops.xhistogram
    if op == "one_input":
        return ops.one_input(data[0], thresholds[0], weights, *rest)
    if op == "joint2":
        return ops.joint2(*data, *thresholds, weights, *rest)
    return getattr(ops, op)(data, thresholds, weights, *rest)


def run(rank, world):
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    import xhistogram_torch  # noqa: F401 - registers the ops' sharding rules

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("r", "c"))
    sharded, replicated = [Shard(0), Shard(1)], [Replicate(), Replicate()]
    thr = torch.from_numpy(EDGES.astype("f4"))
    results = {}
    for name, (op, data, weights, rest) in cases().items():
        data = [distribute_tensor(torch.from_numpy(x), mesh, sharded) for x in data]
        thresholds = [distribute_tensor(thr, mesh, replicated) for _ in data]
        if weights is not None:
            weights = distribute_tensor(torch.from_numpy(weights), mesh, sharded)
        with CommDebugMode() as in_op:
            out = call(op, data, thresholds, weights, rest)
        with CommDebugMode() as to_full:
            full = out.full_tensor()
        results[name] = {
            "placements": [str(p) for p in out.placements],
            "in_op": {str(k): v for k, v in in_op.get_comm_counts().items()},
            "to_full": {str(k): v for k, v in to_full.get_comm_counts().items()},
            "full": full,
        }
    for name, (op, data, weights, rest, dims) in view_cases().items():
        placements = [Shard(d) for d in dims]
        data = [distribute_tensor(torch.from_numpy(x), mesh, placements) for x in data]
        thresholds = [distribute_tensor(thr, mesh, replicated) for _ in data]
        if weights is not None:
            weights = distribute_tensor(torch.from_numpy(weights), mesh, placements)
        with CommDebugMode() as in_op:
            out = call(op, data, thresholds, weights, rest)
        results[name] = {
            "placements": [str(p) for p in out.placements],
            "in_op": {str(k): v for k, v in in_op.get_comm_counts().items()},
            "full": out.full_tensor(),
        }
    return results
