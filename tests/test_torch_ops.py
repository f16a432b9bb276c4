"""The kernel ops (``torch.ops.xhistogram``): schema and fake checks,
``torch.compile``, and their DTensor sharding rules.

On CPU tensors each op runs its kernel's plain version; the same checks on
CUDA tensors are in ``tests/test_torch_gpu.py``. ``torch.compile`` with the
``aot_eager`` backend over ``histogram`` with explicit edges is the
counterpart of ``tests/test_transforms.py::test_methods_under_outer_jit``:
bit-equal to the eager call, with the kernel op in the traced graph. The
DTensor cases are the counterpart of ``tests/test_custom_partitioning.py``:
one spawn of four gloo ranks (``tests/torch_ops_cases.py``) hands sharded
DTensors straight to each op, which runs on each rank's block with no
collective; the result equals the op on the full tensors.
"""

import numpy as np
import pytest
import torch

import xhistogram_torch
from torch_dist import run_ranks
from torch_ops_cases import EDGES, call, cases, view_cases

OPS = torch.ops.xhistogram
DTENSOR_CASES = cases()
VIEW_CASES = view_cases()


def _operands(weights):
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.rand(16, 96).astype("f4")) for _ in range(2))
    w = None if weights is None else torch.from_numpy(rng.rand(16, 96) * 100).to(weights)
    thr = torch.from_numpy(EDGES.astype("f4"))
    return a, b, w, thr


def _op_args(name, weights):
    """(op, arguments) of each op on CPU tensors."""
    a, b, w, thr = _operands(weights)
    return {
        "one_input-kept": (OPS.one_input, (a, thr, w, 7, False)),
        "one_input-full": (OPS.one_input, (a, thr, w, 7, True)),
        "joint2": (OPS.joint2, (a, b, thr, thr, w, 7, 7)),
        "factored-full": (OPS.factored, ([a, b], [thr, thr], w, [7, 7], True)),
        "factored-rows": (OPS.factored, ([a, b], [thr, thr], w, [7, 7], False)),
        "factored-rows-3in": (OPS.factored, ([a, b, a], [thr] * 3, w, [7] * 3, False)),
        "direct": (OPS.direct, ([a, b], [thr, thr], w, [7, 7])),
    }[name]


OP_NAMES = ["one_input-kept", "one_input-full", "joint2", "factored-full",
            "factored-rows", "factored-rows-3in", "direct"]
WEIGHTS = [None, torch.float32, torch.float64, torch.int32, torch.int8, torch.int64,
           torch.uint64]
#: each weight dtype's accumulator class: the dtype every op returns
CLASS = {None: torch.int64, torch.float32: torch.float64, torch.float64: torch.float64,
         torch.int32: torch.int32, torch.int8: torch.int32, torch.int64: torch.int64,
         torch.uint64: torch.int64}


@pytest.mark.parametrize("weights", [None, torch.float32, torch.int32, torch.int64],
                         ids=str)
@pytest.mark.parametrize("name", OP_NAMES)
def test_opcheck(name, weights):
    op, args = _op_args(name, weights)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("weights", WEIGHTS, ids=str)
@pytest.mark.parametrize("name", OP_NAMES)
def test_fake_shapes_and_dtypes(name, weights):
    """Under FakeTensorMode each op gives the shape and accumulator dtype
    the real op returns."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = _op_args(name, weights)
    real = op(*args)
    assert real.dtype == CLASS[weights]
    rows = 1 if name in ("one_input-full", "joint2", "factored-full") else 16
    n_slots = 8 if name.startswith("one_input") else 7**3 + 1 if name.endswith("3in") else 50
    assert tuple(real.shape) == (rows, n_slots)
    with FakeTensorMode() as mode:
        fake_args = torch.utils._pytree.tree_map_only(torch.Tensor, mode.from_tensor, args)
        fake = op(*fake_args)
    assert fake.shape == real.shape and fake.dtype == real.dtype


@pytest.mark.parametrize("name", OP_NAMES)
def test_wrappers_give_the_op_its_dtype(name):
    """A wrapper's sums are the op's accumulators in their weighted_dtype
    (float32 for float32 weights), or the accumulators with finish=False."""
    from xhistogram_torch.ops import cuda_hist

    op, args = _op_args(name, torch.float32)
    raw = op(*args)
    if name.startswith("one_input"):
        a, thr, w, nb, reduce_all = args
        got = cuda_hist.one_input(a, thr, nb, reduce_all, weights=w)
        kept = cuda_hist.one_input(a, thr, nb, reduce_all, weights=w, finish=False)
    elif name == "joint2":
        a, b, ta, tb, w, nba, nbb = args
        got = cuda_hist.joint2(a, b, ta, tb, nba, nbb, weights=w)
        kept = cuda_hist.joint2(a, b, ta, tb, nba, nbb, weights=w, finish=False)
    elif name == "direct":
        arrays, thr, w, nbins = args
        got = cuda_hist.direct(arrays, thr, nbins, weights=w)
        kept = cuda_hist.direct(arrays, thr, nbins, weights=w, finish=False)
    else:
        arrays, thr, w, nbins, reduce_all = args
        got = cuda_hist.factored(arrays, thr, nbins, reduce_all, weights=w)
        kept = cuda_hist.factored(arrays, thr, nbins, reduce_all, weights=w, finish=False)
    assert torch.equal(kept, raw)
    assert got.dtype == torch.float32 and torch.equal(got, raw.to(torch.float32))


@pytest.mark.parametrize("weights", WEIGHTS + [torch.float16, torch.bfloat16], ids=str)
def test_direct_finished_fake_and_opcheck(weights):
    """With ``finish=True`` the direct op gives float weights narrower than
    float64 float32 sums (its kernel rounds each row as it stores it), and
    the accumulator class otherwise; its fake implementation gives the same
    dtype, and opcheck passes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from xhistogram_torch.ops.bincount import finish_sums

    op, args = _op_args("direct", weights)
    args = (*args, True)
    real = op(*args)
    rounded = weights in (torch.float16, torch.bfloat16, torch.float32)
    want = torch.float32 if rounded else CLASS.get(weights, torch.float64)
    assert real.dtype == want
    raw = op(*args[:-1])
    assert torch.equal(real, finish_sums(raw, weights) if rounded else raw)
    with FakeTensorMode() as mode:
        fake_args = torch.utils._pytree.tree_map_only(torch.Tensor, mode.from_tensor, args)
        fake = op(*fake_args)
    assert fake.shape == real.shape and fake.dtype == real.dtype
    if weights in (None, torch.float32, torch.int32, torch.int64):
        torch.library.opcheck(op, args)


class _Graphs:
    """A torch.compile backend that records each graph, then runs it under
    aot_eager."""

    def __init__(self):
        self.graphs = []

    def __call__(self, gm, example_inputs):
        from torch._dynamo.backends.debugging import aot_eager

        self.graphs.append(str(gm.graph))
        return aot_eager(gm, example_inputs)


@pytest.mark.parametrize("kwargs", [
    {"method": "scatter"}, {"method": "onehot"}, {"method": "sort"}, {"method": "cuda"},
    {"method": "cuda", "axis": 1, "density": True}, {"method": "cuda", "weighted": True},
    {"method": "cuda", "joint": True},
], ids=["scatter", "onehot", "sort", "cuda", "cuda-kept-density", "cuda-weighted",
        "cuda-joint2"])
def test_compile_aot_eager_equals_eager(kwargs):
    """The counterpart of test_methods_under_outer_jit: histogram with
    explicit edges under torch.compile(backend="aot_eager") is bit-equal to
    the eager call, and a kernel route puts the kernel op in the graph (the
    host work on the edges runs outside it, ``torch.compiler.disable``)."""
    kwargs = dict(kwargs)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(8, 128).astype("f4"))
    y = torch.from_numpy(rng.randn(8, 128).astype("f4"))
    edges = np.linspace(-4, 4, 11)
    inputs = (x, y) if kwargs.pop("joint", False) else (x,)
    if kwargs.pop("weighted", False):
        kwargs["weights"] = torch.from_numpy(rng.rand(8, 128).astype("f4"))

    def f(*args):
        return xhistogram_torch.histogram(*args, bins=edges, **kwargs)[0]

    torch._dynamo.reset()
    backend = _Graphs()
    got = torch.compile(f, backend=backend)(*inputs)
    want = f(*inputs)
    assert got.dtype == want.dtype and torch.equal(got, want)
    in_graph = any("xhistogram" in g for g in backend.graphs)
    assert in_graph == (kwargs["method"] == "cuda")
    if len(inputs) == 2:
        assert any("xhistogram.joint2" in g for g in backend.graphs)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("torch_ops_cases", tmp_path_factory.mktemp("ops"), world=4,
                     timeout=240)


@pytest.mark.parametrize("name", list(DTENSOR_CASES))
def test_dtensor_op_runs_per_rank_without_gathering(ranks, name):
    """A DTensor sharded over ("r", "c") runs the op on each rank's block:
    no collective inside the op (no all-gather of the operands), the kept
    rows stay Shard(0) where the op keeps rows, every reduced dim is a
    Partial sum, and the reduced result equals the op on the full tensors."""
    op, data, weights, rest = DTENSOR_CASES[name]
    thr = torch.from_numpy(EDGES.astype("f4"))
    want = call(op, [torch.from_numpy(x) for x in data], [thr] * len(data),
                None if weights is None else torch.from_numpy(weights), rest)
    keeps_rows = name in ("one_input-kept", "one_input-kept-weighted",
                          "factored-rows-weighted", "factored-rows", "direct",
                          "direct-weighted")
    for rank in ranks:
        got = rank[name]
        assert got["in_op"] == {}
        assert got["placements"] == ["S(0)" if keeps_rows else "P(sum)", "P(sum)"]
        assert got["full"].dtype == want.dtype
        assert torch.equal(got["full"], want) if not want.is_floating_point() else \
            torch.allclose(got["full"], want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("name", list(VIEW_CASES))
def test_dtensor_views_run_per_rank_without_gathering(ranks, name):
    """(m1, m0, c1, c0) views sharded on both kept dims stay sharded on the
    same dims of the output's kept rows, sharded on both reduced dims (or
    reduced whole) they are Partial sums; no collective runs inside the op,
    and the result equals the op on the full views."""
    op, data, weights, rest, dims = VIEW_CASES[name]
    thr = torch.from_numpy(EDGES.astype("f4"))
    want = call(op, [torch.from_numpy(x) for x in data], [thr] * len(data),
                None if weights is None else torch.from_numpy(weights), rest)
    reduce_all = rest[-1] is True or rest[-1] == "full"
    kept = dims == (0, 1) and not reduce_all
    for rank in ranks:
        got = rank[name]
        assert got["in_op"] == {}
        assert got["placements"] == (["S(0)", "S(1)"] if kept else ["P(sum)", "P(sum)"])
        assert got["full"].dtype == want.dtype
        assert torch.equal(got["full"], want) if not want.is_floating_point() else \
            torch.allclose(got["full"], want, rtol=1e-15, atol=0)


def run(rank, world):
    """One rank of test_direct_finished_rows_under_dtensor: the direct op on
    DTensors sharded on rows and on columns, raw and finished, against the
    op on the full tensors, with the output's placements."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    import xhistogram_torch.parallel  # noqa: F401  (registers the rules)

    mesh = init_device_mesh("cpu", (world,))
    a, b, w, thr = _operands(torch.float32)
    out = {}
    for dim in (0, 1):
        da, db, dw = (distribute_tensor(x, mesh, [Shard(dim)]) for x in (a, b, w))
        dt = distribute_tensor(thr, mesh, [Replicate()])
        for finish in (False, True):
            got = OPS.direct([da, db], [dt, dt], dw, [7, 7], finish)
            want = OPS.direct([a, b], [thr, thr], w, [7, 7], finish)
            out[(dim, finish)] = (type(got.placements[0]).__name__, got.dtype,
                                  torch.equal(got.full_tensor(), want))
    return out


def test_direct_finished_rows_under_dtensor(tmp_path):
    """Rows the direct op rounds to float32 (finish=True) do not add up as
    partial sums, so columns sharded there are gathered first (the result
    replicated), while raw float64 sums stay a Partial; rows sharded on
    the kept dim stay Shard(0) either way; every result equals the op on
    the full tensors."""
    for result in run_ranks("test_torch_ops", tmp_path, world=2, timeout=180):
        assert result == {
            (0, False): ("Shard", torch.float64, True),
            (0, True): ("Shard", torch.float32, True),
            (1, False): ("Partial", torch.float64, True),
            (1, True): ("Replicate", torch.float32, True),
        }
