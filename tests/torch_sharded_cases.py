"""The cases of ``tests/test_torch_sharded.py``, run on gloo ranks.

Each case is a call of the port's sharded path on a (2, 2) mesh named
("x", "y") of four CPU ranks, with inputs made from a seed by numpy. The
test holds each rank's result against the JAX package's
``parallel.histogram_sharded`` on the same inputs and layout and against
numpy. ``run`` is a rank's side (``tests/torch_dist.py``); it imports torch
and the port only.
"""

import numpy as np

MESH_SHAPE, MESH_NAMES = (2, 2), ("x", "y")
EDGES10 = np.linspace(-4, 4, 10)


def _randn(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype("f4")


def _case(args, in_spec=("x", "y"), kind="sharded", **kwargs):
    return {"args": args, "in_spec": in_spec, "kind": kind, "kwargs": kwargs}


def cases():
    """name -> {"args": numpy inputs, "in_spec", "kind", "kwargs"}. Kinds:
    "sharded" calls ``histogram_sharded`` with numpy inputs; "dtensor"
    calls ``core.histogram`` on inputs made DTensors laid out as
    ``in_spec`` (delegation); "replicated" on replicated DTensors (no
    delegation), "one-rank" on a DTensor sharded over a mesh of this rank
    alone (no delegation); "labeled" the labeled API on a NamedArray over a DTensor;
    "grad" the gradient of sum(h^2) with respect to DTensor weights (or,
    with ``full_tensor_weights``, to a full tensor every rank holds, through
    ``histogram_sharded``)."""
    out = {}
    for axis in (None, (1,), (0,), (0, 1)):
        out[f"one_input-axis{axis}"] = _case([_randn(0, (8, 16))], bins=EDGES10, axis=axis)
    rng = np.random.RandomState(1)
    a, b, w = rng.randn(8, 16).astype("f4"), rng.randn(8, 16).astype("f4"), rng.rand(8, 16).astype("f4")
    edges_ab = [np.linspace(-4, 4, 9), np.linspace(-4, 4, 11)]
    out["joint-unweighted"] = _case([a, b], bins=edges_ab)
    out["joint-weighted"] = _case([a, b], bins=edges_ab, weights=w)
    out["density"] = _case([_randn(2, (8, 16))], bins=EDGES10, density=True)
    out["density-kept"] = _case([_randn(2, (8, 16))], bins=EDGES10, density=True, axis=1)
    for spec in (("x", None), (None, "y"), (("x", "y"), None), (("y", "x"), None),
                 (None, ("x", "y")), ("y", "x")):
        out[f"layout-{spec}"] = _case([_randn(5, (8, 16))], in_spec=spec,
                                      bins=np.linspace(-4, 4, 9))
    out["layout-1d-xy"] = _case([_randn(0, (16,))], in_spec=(("x", "y"),), bins=EDGES10)
    out["layout-3d"] = _case([_randn(12, (4, 6, 8))], in_spec=("y", None, "x"),
                             bins=EDGES10, axis=(0, 2))
    rng = np.random.RandomState(6)
    t, s = rng.randn(8, 512).astype("f4"), rng.randn(8, 512).astype("f4")
    for method in ("scatter", "cuda"):
        out[f"method-{method}"] = _case([t, s], bins=[np.linspace(-4, 4, 29),
                                                     np.linspace(-4, 4, 37)], method=method)
    rng = np.random.RandomState(7)
    a, b = rng.randn(8, 1024).astype("f4"), rng.randn(8, 1024).astype("f4")
    out["kept-per-row-9600-slots"] = _case(
        [a, b], bins=[np.linspace(-4, 4, 121), np.linspace(-4, 4, 81)], axis=1, method="cuda")
    rng = np.random.RandomState(8)
    data = rng.uniform(-3.5, 3.5, (8, 64)).astype("f4")
    w = rng.rand(8, 64).astype("f4")
    data[3, 2], w[3, 2] = 0.1, np.nan
    out["nan-weight-kept"] = _case([data], bins=EDGES10, axis=1, weights=w)
    # broadcasting (tests/test_sharding.py:494-548)
    rng = np.random.RandomState(41)
    out["broadcast-lower-rank-input"] = _case(
        [rng.randn(8, 16).astype("f4"), rng.randn(16).astype("f4")],
        bins=[np.linspace(-4, 4, 9), np.linspace(-4, 4, 7)])
    rng = np.random.RandomState(42)
    out["broadcast-length1-weights"] = _case(
        [rng.randn(8, 16).astype("f4")], bins=EDGES10, axis=(1,),
        weights=rng.rand(8, 1).astype("f4"))
    out["broadcast-lower-rank-weights"] = _case(
        [_randn(43, (8, 16))], bins=EDGES10, axis=(1,), weights=np.full((16,), 2.0, "f4"))
    # weights by dtype class
    x = _randn(30, (8, 16))
    out["int32-wrap"] = _case([x], bins=EDGES10,
                              weights=np.full((8, 16), 2**31 - 1, np.int32))
    rng = np.random.RandomState(31)
    out["int64-weights"] = _case([x], bins=EDGES10, axis=1,
                                 weights=rng.randint(-2**62, 2**62, (8, 16), dtype=np.int64))
    out["uint64-weights"] = _case([x], bins=EDGES10,
                                  weights=rng.randint(0, 2**63, (8, 16), dtype=np.uint64) * 2 + 1)
    out["float64-weights"] = _case([x], bins=EDGES10, weights=rng.rand(8, 16))
    wf = rng.rand(8, 16) * 10.0 ** rng.randint(-30, 30, (8, 16))
    wf[0, :3] = [1e300, -1e300, 1e-300]
    out["f64"] = _case([x], bins=EDGES10, weights=wf, precision="f64")
    out["f64-kept"] = _case([x], bins=EDGES10, axis=1, weights=wf, precision="f64")
    wn = rng.rand(8, 16)
    wn[2, 5], wn[6, 1] = np.inf, np.nan
    out["f64-nonfinite"] = _case([x], bins=EDGES10, weights=wn, precision="f64")
    out["f64-float32-weights"] = _case([x], bins=EDGES10, precision="f64",
                                       weights=rng.rand(8, 16).astype("f4"))
    # a row of 4096 elements, past the JAX guard lowered to 2**10
    out["f64-long-row"] = _case([_randn(32, (4, 4096))], bins=EDGES10, axis=1,
                                weights=np.random.RandomState(33).rand(4, 4096),
                                precision="f64")
    # bins resolved from the data
    out["int-bins"] = _case([_randn(34, (8, 16)) * 3 + 1], bins=10)
    out["int-bins-joint"] = _case([_randn(35, (8, 16)), _randn(36, (8, 16)) * 2],
                                  bins=[7, 5])
    out["int-bins-range"] = _case([_randn(35, (8, 16))], bins=7, range=(-2.0, 2.5))
    out["int-bins-int32"] = _case([np.random.RandomState(37).randint(-50, 70, (8, 16))
                                   .astype(np.int32)], bins=12)
    out["str-bins"] = _case([_randn(38, (8, 16))], bins="auto")
    nan = _randn(39, (8, 16))
    nan[5, 13] = np.nan
    out["nan-int-bins-raises"] = _case([nan], bins=10)
    out["not-divisible-raises"] = _case([_randn(40, (6, 16))], in_spec=(("x", "y"), None),
                                        bins=EDGES10)
    # DTensor inputs through core.histogram, and the labeled API
    out["delegate-full"] = _case([_randn(50, (8, 16))], kind="dtensor", bins=EDGES10)
    out["delegate-kept"] = _case([_randn(51, (8, 16))], kind="dtensor", bins=EDGES10,
                                 axis=(1,))
    out["delegate-weights-only"] = _case([_randn(52, (8, 16)), _randn(53, (8, 16))],
                                         kind="dtensor", bins=EDGES10)
    out["replicated-no-delegation"] = _case([_randn(54, (8, 16))], kind="replicated",
                                            bins=EDGES10)
    out["one-rank-mesh-no-delegation"] = _case([_randn(55, (8, 16))], kind="one-rank",
                                               bins=EDGES10, axis=1)
    out["labeled"] = _case([_randn(11, (8, 64))], kind="labeled", bins=EDGES10,
                           device="cpu")
    rng = np.random.RandomState(60)
    out["grad"] = _case([rng.rand(16, 96).astype("f4")], kind="grad",
                        bins=np.linspace(0.0, 1.0, 8), axis=1,
                        weights=rng.rand(16, 96).astype("f4"))
    out["grad-full-reduction"] = _case([rng.rand(16, 96).astype("f4")], kind="grad",
                                       bins=np.linspace(0.0, 1.0, 8),
                                       weights=rng.rand(16, 96).astype("f4"))
    out["grad-full-tensor-weights"] = _case([rng.rand(16, 96).astype("f4")], kind="grad",
                                            bins=np.linspace(0.0, 1.0, 8), axis=1,
                                            weights=rng.rand(16, 96).astype("f4"),
                                            full_tensor_weights=True)
    return out


def _placements(spec, ndim):
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(MESH_NAMES)
    for i, entry in enumerate(list(spec) + [None] * (ndim - len(spec))):
        for name in () if entry is None else entry if isinstance(entry, tuple) else (entry,):
            out[MESH_NAMES.index(name)] = Shard(i)
    return out


def _run_case(mesh, one_rank_mesh, case):
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    import xhistogram_torch
    from xhistogram_torch.labeled import NamedArray, histogram as labeled_histogram
    from xhistogram_torch.parallel import histogram_sharded

    kwargs = dict(case["kwargs"])
    args, spec, kind = case["args"], case["in_spec"], case["kind"]

    def dtensor(x, placements=None):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return distribute_tensor(t, mesh, placements or _placements(spec, t.ndim))

    if kind == "sharded":
        h, edges = histogram_sharded(*args, mesh=mesh, in_spec=spec, **kwargs)
    elif kind == "dtensor":
        if len(args) > 1:  # only the second input is a DTensor: it sets the layout
            args = [args[0], dtensor(args[1])]
        else:
            args = [dtensor(a) for a in args]
        h, edges = xhistogram_torch.histogram(*args, **kwargs)
    elif kind == "replicated":
        h, edges = xhistogram_torch.histogram(
            *(dtensor(a, [Replicate(), Replicate()]) for a in args), **kwargs)
    elif kind == "one-rank":
        h, edges = xhistogram_torch.histogram(
            *(distribute_tensor(torch.from_numpy(a), one_rank_mesh, [Shard(0)])
              for a in args), **kwargs)
    elif kind == "labeled":
        na = NamedArray(dtensor(args[0]), dims=("depth", "cell"), name="T",
                        coords={"depth": np.arange(float(args[0].shape[0]))})
        out = labeled_histogram(na, dim=["cell"], **kwargs)
        return {"h": out.data.full_tensor(), "dims": out.dims, "type": type(out.data).__name__,
                "placements": [str(p) for p in out.data.placements]}
    elif kwargs.pop("full_tensor_weights", False):  # grad
        w = torch.from_numpy(kwargs.pop("weights")).requires_grad_()
        h, edges = histogram_sharded(*args, mesh=mesh, in_spec=spec, weights=w, **kwargs)
        (h.full_tensor() ** 2).sum().backward()
        return {"h": h.full_tensor().detach(), "grad": w.grad, "grad_placements": None}
    else:  # grad
        w = dtensor(kwargs.pop("weights")).requires_grad_()
        h, edges = xhistogram_torch.histogram(dtensor(args[0]), weights=w, **kwargs)
        (h.full_tensor() ** 2).sum().backward()
        return {"h": h.full_tensor().detach(), "grad": w.grad.full_tensor(),
                "grad_placements": [str(p) for p in w.grad.placements]}
    result = {"edges": edges, "type": type(h).__name__}
    if isinstance(h, DTensor):
        result.update(h=h.full_tensor(), placements=[str(p) for p in h.placements],
                      local_shape=tuple(h.to_local().shape))
    else:
        result["h"] = h
    return result


def run(rank, world):
    """Every case on this rank: its result, or the error it raised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from xhistogram_torch.parallel import sharded
    from xhistogram_torch.utils import profiling

    mesh = init_device_mesh("cpu", MESH_SHAPE, mesh_dim_names=MESH_NAMES)
    # every rank creates every one-rank group, in the same order
    alone = [dist.new_group([r]) for r in range(world)][rank]
    one_rank_mesh = DeviceMesh.from_group(alone, "cpu", mesh_dim_names=("x",))
    results = {}
    for name, case in cases().items():
        before = sharded.ALL_REDUCES
        calls, spent = profiling.CALLS, profiling.SELF_NS.get("all_reduce", 0)
        try:
            results[name] = _run_case(mesh, one_rank_mesh, case)
        except Exception as ex:  # recorded: the test holds every rank to it
            results[name] = {"error": (type(ex).__name__, str(ex))}
        results[name]["all_reduces"] = sharded.ALL_REDUCES - before
        results[name]["calls"] = profiling.CALLS - calls
        results[name]["all_reduce_span"] = profiling.SELF_NS.get("all_reduce", 0) > spent
    return results
