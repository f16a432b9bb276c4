"""The port's sharded path (``xhistogram_torch.parallel``) on four gloo
ranks, against the JAX package's ``parallel.histogram_sharded``.

The counterpart of ``tests/test_sharding.py`` and
``tests/test_sharding_hypotheses.py``. One spawn of four CPU ranks on a
(2, 2) mesh named ("x", "y") runs every case of
``tests/torch_sharded_cases.py`` (a module-scoped fixture); each test then
asserts one case, so every case counts without a spawn of its own. The JAX
side runs on the conftest's virtual CPU devices, as a (2, 2) mesh of four.
Counts and integer sums are bit-equal to JAX; float32 sums within two
float32 ulps of the port's one-card call and within twice the JAX
'highest' bound (rtol 3e-7, atol 1e-6) of JAX; 'f64' sums bit-equal to
both. JAX is imported inside the tests, so the ranks never load it.
"""

import functools

import numpy as np
import pytest
import torch

import xhistogram_torch
from torch_dist import run_ranks
from torch_sharded_cases import MESH_NAMES, MESH_SHAPE, cases

CASES = cases()
RAISES = {"nan-int-bins-raises", "not-divisible-raises"}
RTOL, ATOL = 2 * 3e-7, 2 * 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("torch_sharded_cases", tmp_path_factory.mktemp("sharded"), world=4,
                     timeout=240)


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]).reshape(MESH_SHAPE), MESH_NAMES)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """(hist, edges) of the JAX package on the case's inputs and layout, or
    the exception it raised."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from xhistogram_tpu.core import histogram
    from xhistogram_tpu.labeled import NamedArray, histogram as labeled_histogram
    from xhistogram_tpu.parallel import histogram_sharded

    case = CASES[name]
    kwargs = dict(case["kwargs"])
    kwargs.pop("device", None)
    if kwargs.get("method") == "cuda":
        kwargs["method"] = "pallas"
    mesh, spec = _jax_mesh(), P(*case["in_spec"])
    args = case["args"]

    def put(x):
        return jax.device_put(x, NamedSharding(mesh, spec))

    try:
        if case["kind"] == "sharded":
            h, edges = histogram_sharded(*args, mesh=mesh, in_spec=spec, **kwargs)
        elif case["kind"] == "dtensor":
            args = [args[0], put(args[1])] if len(args) > 1 else [put(a) for a in args]
            h, edges = histogram(*args, **kwargs)
        elif case["kind"] == "replicated":
            h, edges = histogram(*(jax.device_put(a, NamedSharding(mesh, P()))
                                   for a in args), **kwargs)
        elif case["kind"] == "one-rank":
            h, edges = histogram(*(jax.device_put(a, jax.devices()[0]) for a in args),
                                 **kwargs)
        elif case["kind"] == "labeled":
            na = NamedArray(put(args[0]), dims=("depth", "cell"), name="T",
                            coords={"depth": np.arange(float(args[0].shape[0]))})
            out = labeled_histogram(na, dim=["cell"], **kwargs)
            return np.asarray(out.data), out.dims
        else:
            raise AssertionError(name)
    except Exception as ex:  # noqa: BLE001 - compared with the port's
        return ex
    return np.asarray(h), edges


def _one_card(name, **extra):
    """The port's one-card call on the case's full inputs, on the CPU."""
    case = CASES[name]
    kwargs = {**case["kwargs"], **extra, "device": "cpu"}
    return xhistogram_torch.histogram(*case["args"], **kwargs)


def _assert_matches(got, want_jax, want_port, name):
    """``got`` (the sharded result) against JAX and the one-card port."""
    got = got.numpy()
    want_port = want_port.detach().numpy()
    assert got.dtype == want_port.dtype, name
    assert got.shape == want_port.shape == np.shape(want_jax), name
    precision = CASES[name]["kwargs"].get("precision")
    if got.dtype.kind in "iub" or precision == "f64":
        np.testing.assert_array_equal(got, want_port, err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(want_jax).astype(got.dtype), err_msg=name)
        return
    finite = np.isfinite(want_port)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want_port), err_msg=name)
    np.testing.assert_array_max_ulp(got[finite].astype(np.float32),
                                    want_port[finite].astype(np.float32), maxulp=2)
    np.testing.assert_allclose(got[finite], np.asarray(want_jax)[finite], rtol=RTOL,
                               atol=ATOL, err_msg=name)


RESULT_CASES = [n for n, c in CASES.items() if c["kind"] != "grad" and n not in RAISES]


@pytest.mark.parametrize("name", RESULT_CASES)
def test_case_matches_jax_and_one_card(ranks, name):
    got = ranks[0][name]
    assert "error" not in got, got
    want = _jax(name)
    assert not isinstance(want, Exception), want
    if CASES[name]["kind"] == "labeled":
        want_h, want_dims = want
        assert got["dims"] == want_dims == ("depth", "T_bin")
        assert got["type"] == "DTensor" and got["placements"] == ["S(0)", "R"]
        np.testing.assert_array_equal(got["h"].numpy(), want_h)
        return
    h, edges = _one_card(name)
    _assert_matches(got["h"], want[0], h, name)
    for e, e_jax, e_port in zip(got["edges"], want[1], edges):
        np.testing.assert_array_equal(e, e_jax)  # bit for bit, also for int/str bins
        assert e.dtype == np.asarray(e_jax).dtype == e_port.dtype


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_the_same_result(ranks, name):
    """Every rank returns the full result (or raises the same error): what
    one rank computes from its own block reaches every rank."""
    first = ranks[0][name]
    for other in ranks[1:]:
        res = other[name]
        assert res.keys() == first.keys()
        for key, value in first.items():
            if isinstance(value, torch.Tensor):
                torch.testing.assert_close(res[key], value, rtol=0, atol=0, equal_nan=True)
            elif key == "edges":
                for a, b in zip(res[key], value):
                    np.testing.assert_array_equal(a, b)
            else:
                assert res[key] == value, (name, key)


@pytest.mark.parametrize("name", [n for n in RESULT_CASES
                                  if CASES[n]["kind"] not in ("replicated", "one-rank")])
def test_kept_axes_stay_sharded(ranks, name):
    """The output is Shard on the mesh dims of kept axes, Replicate on the
    rest (``reduce_spec``), and each rank holds its block of it."""
    from xhistogram_tpu.parallel import reduce_spec as jax_reduce_spec
    from jax.sharding import PartitionSpec as P

    case, got = CASES[name], ranks[0][name]
    shape = np.broadcast_shapes(*(np.shape(a) for a in case["args"]))
    axis = case["kwargs"].get("axis")
    if case["kind"] == "labeled":  # dim=["cell"]
        axis = (1,)
    out_spec, _ = jax_reduce_spec(P(*case["in_spec"]), axis, len(shape))
    want = ["R"] * len(MESH_NAMES)
    for j, entry in enumerate(out_spec):
        for nm in () if entry is None else entry if isinstance(entry, tuple) else (entry,):
            want[MESH_NAMES.index(nm)] = f"S({j})"
    assert got["placements"] == want
    if "local_shape" in got:
        local = list(got["h"].shape)
        for j, entry in enumerate(out_spec):
            for nm in () if entry is None else entry if isinstance(entry, tuple) else (entry,):
                local[j] //= MESH_SHAPE[MESH_NAMES.index(nm)]
        assert got["local_shape"] == tuple(local)


@pytest.mark.parametrize("spec,axis,ndim", [
    (("x", "y"), (1,), 2), (("x", "y"), None, 2), ((None, "y"), (0,), 3),
    ((("x", "y"), None), (1,), 2), (("y", None, "x"), (0, 2), 3), ((), None, 1),
])
def test_reduce_spec_matches_jax(spec, axis, ndim):
    from jax.sharding import PartitionSpec as P

    from xhistogram_torch.parallel import reduce_spec
    from xhistogram_tpu.parallel import reduce_spec as jax_reduce_spec

    out, reduced = reduce_spec(spec, axis, ndim)
    jout, jreduced = jax_reduce_spec(P(*spec), axis, ndim)
    assert tuple(out) == tuple(jout) and reduced == jreduced


ALL_REDUCE_COUNTS = [
    ("one_input-axisNone", 2), ("one_input-axis(1,)", 1), ("one_input-axis(0,)", 1),
    ("layout-('x', None)", 1), ("layout-(None, 'y')", 1), ("layout-(('x', 'y'), None)", 2),
    ("kept-per-row-9600-slots", 1), ("delegate-full", 2), ("delegate-kept", 1),
    ("replicated-no-delegation", 0), ("one-rank-mesh-no-delegation", 0),
    ("f64-float32-weights", 4), ("f64-long-row", 2),
]


@pytest.mark.parametrize("name,count", ALL_REDUCE_COUNTS)
def test_one_all_reduce_per_reduced_mesh_dim(ranks, name, count):
    """One all-reduce of the partial sums per mesh dim that shards a
    reduced axis (a 'f64' call: per limb pass; two passes for weights in
    one exponent group), as the JAX path runs one psum over those axes."""
    for rank in ranks:
        assert rank[name]["all_reduces"] == count


@pytest.mark.parametrize("name,count", ALL_REDUCE_COUNTS)
def test_each_sharded_call_is_one_call_with_its_all_reduces_in_their_span(ranks, name, count):
    """A sharded call counts one public call on each rank, a DTensor call
    that core.histogram delegates too (its sharded call nests under core's
    span), and its all-reduces of partial sums run inside the
    ``xhistogram.all_reduce`` span."""
    for rank in ranks:
        assert rank[name]["calls"] == 1
        assert rank[name]["all_reduce_span"] == (count > 0)


@pytest.mark.parametrize("name", sorted(RAISES))
def test_errors_raise_on_every_rank_as_in_jax(ranks, name):
    want = _jax(name)
    assert isinstance(want, ValueError)
    for rank in ranks:
        kind, msg = rank[name]["error"]
        assert kind == type(want).__name__ and rank[name]["all_reduces"] == 0
    if name == "nan-int-bins-raises":
        assert msg == str(want) == "autodetected range of [nan, nan] is not finite"


@pytest.mark.parametrize("name", ["delegate-full", "delegate-kept", "delegate-weights-only",
                                  "labeled"])
def test_dtensor_inputs_delegate(ranks, name):
    """core.histogram on a sharded DTensor runs the sharded path (the JAX
    package's eager delegation) and returns a DTensor."""
    assert ranks[0][name]["type"] == "DTensor"


@pytest.mark.parametrize("name", ["replicated-no-delegation", "one-rank-mesh-no-delegation"])
def test_replicated_or_one_rank_dtensor_does_not_delegate(ranks, name):
    """The counterpart of test_replicated_and_single_device_arrays_do_not_
    delegate: a replicated DTensor, or one on a mesh of one rank, runs its
    local tensor through the one-card path and returns a plain tensor."""
    want, _ = _one_card(name)
    for rank in ranks:
        got = rank[name]
        assert got["type"] == "Tensor" and got["all_reduces"] == 0
        assert torch.equal(got["h"], want)


@pytest.mark.parametrize("name", ["grad", "grad-full-reduction", "grad-full-tensor-weights"])
def test_gradient_equals_the_one_card_gradient(ranks, name):
    """d sum(h^2) / dw through DTensor weights (or a full tensor every rank
    holds): the replicated cotangent gathered at each rank's elements, as on
    one card (2 h[slot(e)], 0 outside the bins), the whole gradient on every
    rank."""
    case = CASES[name]
    kwargs = dict(case["kwargs"])
    full_tensor = kwargs.pop("full_tensor_weights", False)
    w = torch.from_numpy(kwargs.pop("weights")).requires_grad_()
    h, _ = xhistogram_torch.histogram(*case["args"], weights=w, device="cpu", **kwargs)
    (h ** 2).sum().backward()
    got = ranks[0][name]
    assert got["grad_placements"] == (None if full_tensor else ["S(0)", "S(1)"])
    np.testing.assert_array_max_ulp(got["h"].numpy(), h.detach().numpy(), maxulp=2)
    torch.testing.assert_close(got["grad"], w.grad, rtol=1e-6, atol=0)
    edges = case["kwargs"]["bins"]
    a = case["args"][0].astype("f8")
    idx = np.clip(np.searchsorted(edges, a, side="right") - 1, 0, len(edges) - 2)
    hn = h.detach().numpy().astype("f8")
    inside = (a >= edges[0]) & (a <= edges[-1])
    slot_h = np.take_along_axis(hn, idx, axis=1) if hn.ndim == 2 else hn[idx]
    np.testing.assert_allclose(got["grad"].numpy(), np.where(inside, 2 * slot_h, 0.0),
                               rtol=1e-6)


def test_f64_row_past_the_jax_guard(ranks, monkeypatch):
    """The JAX package's sharded 'f64' refuses rows past ``_INTW_CHUNK``
    elements (per-digit int32 psums); the port all-reduces int64 limb sums
    and has no such guard. At a guard lowered to 2**10, a row of 4096: JAX
    refuses, the port gives the one-card sums bit for bit, and JAX's
    unsharded exact tier agrees."""
    import xhistogram_tpu.core as jax_core
    from jax.sharding import PartitionSpec as P
    from xhistogram_tpu.parallel import histogram_sharded

    monkeypatch.setattr(jax_core, "_INTW_CHUNK", 1 << 10)
    case = CASES["f64-long-row"]
    with pytest.raises(ValueError, match="per-digit int32 psums would overflow"):
        histogram_sharded(*case["args"], mesh=_jax_mesh(), in_spec=P(*case["in_spec"]),
                          **case["kwargs"])
    want, _ = jax_core.histogram(*case["args"], **case["kwargs"])
    got = ranks[0]["f64-long-row"]["h"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, _one_card("f64-long-row")[0])
