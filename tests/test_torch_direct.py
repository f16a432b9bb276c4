"""direct — the kept-row kernel of narrow rows and forced calls — against
the JAX package.

On the CPU the wrapper runs ``direct_reference``, the plain version the
CUDA kernels (``csrc/direct.cuh``, and ``csrc/slot.cu`` outside its
envelope) are held to on the card
(tests/test_torch_gpu.py, chip_smoke.py). Here the port's ``method="cuda"``
and ``method="auto"``, the JAX package's ``_direct_kernel`` under the
Pallas interpreter (``method="pallas"``) and numpy must give the same
counts, bit for bit.
"""

import numpy as np
import pytest
import torch

import xhistogram_tpu
from xhistogram_tpu.ops import pallas_hist
import xhistogram_torch
from xhistogram_torch import bins as tbins
from xhistogram_torch.ops import cuda_hist
from xhistogram_torch.utils.axes import canonicalize_2d
from test_torch_factored import all_agree, data, edges
from ts_cases import EDGE_SETS, edge_case_data, reference_numpy_joint

CASES = {
    "2in-39x49": ((3, 60), 2, (39, 49), (1,)),
    "3in": ((4, 50), 3, (10, 12, 8), (1,)),
    "1in-2000": ((5, 100), 1, (2000,), (1,)),  # one input over 1024 bins
    "c1": ((9, 1), 2, (20, 30), (1,)),
    "3-D-kept-pair": ((5, 4, 30), 2, (16, 16), (2,)),
    "strided-rows": ((30, 5, 4), 2, (16, 16), (0,)),  # a (1, m)-strided layout
}


@pytest.mark.parametrize("spacing", ["even", "uneven"])
@pytest.mark.parametrize("case", list(CASES))
def test_routes_bit_equal(monkeypatch, case, spacing):
    shape, n_inputs, nbins, axis = CASES[case]
    args = data(shape, n_inputs, seed=len(case))
    bins = [edges(nb, spacing, seed=i) for i, nb in enumerate(nbins)]
    all_agree(monkeypatch, args, bins, axis, "direct")


def test_broadcast_inputs(monkeypatch):
    """Broadcast inputs: zero-stride views in the kept-row layout."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 40)).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    c = rng.normal(size=(6, 1)).astype(np.float32)
    layout = canonicalize_2d(torch.from_numpy(c).expand(6, 40), (1,))
    assert layout.stride() == (1, 0)
    all_agree(monkeypatch, [a, b, c], [edges(20), edges(12, "uneven"), edges(6)], (1,),
              "direct")


@pytest.mark.parametrize(
    "dtypes",
    [("float64", "float64"), ("int32", "int32"), ("int64", "int64"),
     ("float16", "float16"), ("float32", "float64"), ("int32", "float32"),
     ("int32", "int64")],
    ids=str,
)
def test_dtypes(monkeypatch, dtypes):
    rng = np.random.default_rng(len(dtypes[0]))
    args, bins = [], []
    for d in dtypes:
        if d == "int64":
            args.append(rng.integers(-(2**45), 2**45, (4, 60)))
            bins.append(edges(40, lo=-(2.0**44), hi=2.0**44))
        elif d == "int32":
            args.append(rng.integers(-4000, 4000, (4, 60)).astype(np.int32))
            bins.append(edges(40, lo=-3000.5, hi=3000.5))
        else:
            args.append(rng.normal(0.0, 1.5, (4, 60)).astype(d))
            bins.append(edges(40))
    # numpy compares int64 data in float64, which is not exact here
    all_agree(monkeypatch, args, bins, (1,), "direct", numpy="int64" not in dtypes)


@pytest.mark.parametrize("name", list(EDGE_SETS))
def test_edge_cases(monkeypatch, name):
    """Each edge, one ulp either side, NaN, ±inf, ±0 and subnormals, per
    row of narrow rows."""
    te, se = EDGE_SETS[name]
    t, s = edge_case_data(te, se, n_random=100)
    n = len(t) // 8 * 8
    rows = [x[:n].reshape(8, -1) for x in (t, s)]
    bins = [np.asarray(te), np.asarray(se)]
    kernel = cuda_hist.plan(2, tuple(len(e) - 1 for e in bins), 8, rows[0].shape[1])
    if kernel != "direct":  # the 280x340 grid is past direct's 8192 slots
        assert kernel == "factored_packed"
        rows = [x[:, :64] for x in rows]
        bins = [np.asarray(te)[:40], np.asarray(se)[:40]]
    all_agree(monkeypatch, rows, bins, (1,), "direct")


def test_forced_beyond_the_caps():
    """Kept rows over 8192 slots with more thresholds than plan() takes:
    plan() names no kernel, and method="cuda" runs direct. The JAX package
    runs its direct kernel for the same call too, but its interpreter takes
    ~20 s over 33,001 thresholds, so its scatter strategy and numpy hold
    the port here; test_jax_direct_kernel_past_8192_slots holds the JAX
    kernel itself past 8192 slots."""
    x = data((2, 40), 1, seed=3)[0]
    bins = [edges(33_000, "uneven")]
    assert cuda_hist.plan(1, (33_000,), 2, 40) is None
    assert pallas_hist.plan(1, (33_000,), 2, c=40, weighted=False, uniform=None) is None
    before = cuda_hist.DIRECT_LAUNCHES
    h, _ = xhistogram_torch.histogram(torch.from_numpy(x), bins=bins, axis=1,
                                      method="cuda")
    assert cuda_hist.DIRECT_LAUNCHES == before  # CPU tensors: the plain version
    expected = reference_numpy_joint([x], bins, (1,))
    np.testing.assert_array_equal(h.numpy(), expected)
    jh, _ = xhistogram_tpu.histogram(x, bins=bins, axis=1, method="scatter")
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


def test_jax_direct_kernel_past_8192_slots(monkeypatch):
    """The JAX direct kernel, forced past 8192 slots (its routing knob), and
    the port's direct on the same layouts."""
    x, y = data((3, 40), 2, seed=4)
    bins = [edges(100, "uneven"), edges(95)]  # 9,500 slots
    monkeypatch.setenv("XHIST_FORCE_KERNEL", "direct")
    jh, _ = xhistogram_tpu.histogram(x, y, bins=bins, axis=1, method="pallas")
    thr = [torch.from_numpy(tbins.compare_form(e, np.float32).edges) for e in bins]
    out = cuda_hist.direct([torch.from_numpy(x), torch.from_numpy(y)], thr, [100, 95])
    assert out.shape == (3, 9501) and (out[:, -1] == 0).all()
    np.testing.assert_array_equal(out[:, :-1].reshape(3, 100, 95).numpy(), np.asarray(jh))
    np.testing.assert_array_equal(np.asarray(jh), reference_numpy_joint([x, y], bins, (1,)))


@pytest.mark.parametrize("m,c", [(0, 5), (5, 0), (1, 1), (7, 1), (4099, 3)])
def test_empty_and_ragged(m, c):
    args = [torch.from_numpy(x) for x in data((m, c), 2, seed=m + c)]
    bins = [edges(50), edges(30)]
    thr = [torch.from_numpy(tbins.compare_form(e, np.float32).edges) for e in bins]
    out = cuda_hist.direct(args, thr, [50, 30])
    assert out.shape == (m, 50 * 30 + 1) and out.dtype == torch.int64
    assert (out[:, -1] == 0).all()
    np.testing.assert_array_equal(
        out[:, :-1].reshape(m, 50, 30).numpy(),
        reference_numpy_joint([a.numpy() for a in args], bins, (1,)),
    )


def test_wrapper_contract_on_cpu():
    a, b = (torch.from_numpy(x) for x in data((6, 40), 2, seed=1))
    thr = [torch.from_numpy(tbins.compare_form(e, np.float32).edges)
           for e in (edges(50), edges(30))]
    before = cuda_hist.DIRECT_LAUNCHES
    got = cuda_hist.direct([a.t(), b.t()], thr, [50, 30])
    want = cuda_hist.direct([a.t().contiguous(), b.t().contiguous()], thr, [50, 30])
    assert torch.equal(got, want) and got.shape == (40, 50 * 30 + 1)
    assert torch.equal(got, cuda_hist.direct_reference([a.t(), b.t()], thr, [50, 30]))
    assert cuda_hist.DIRECT_LAUNCHES == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="2-D layouts of one shape"):
        cuda_hist.direct([a.reshape(-1), b.reshape(-1)], thr, [50, 30])
    # bfloat16 data compares against float32 thresholds, uint32 against
    # int64 ones; a dtype no kernel reads is refused
    with pytest.raises(TypeError, match="data must be in its compare dtype torch.float32"):
        cuda_hist.direct([a.bfloat16(), b], [thr[0].bfloat16(), thr[1]], [50, 30])
    with pytest.raises(TypeError, match="data must be in its compare dtype torch.int64"):
        cuda_hist.direct([a.to(torch.uint32), b], [thr[0].to(torch.uint32), thr[1]],
                         [50, 30])
    with pytest.raises(TypeError, match="data, got torch.complex64"):
        cuda_hist.direct([a.to(torch.complex64), b], thr, [50, 30])
    with pytest.raises(ValueError, match="needs 51 thresholds"):
        cuda_hist.direct([a, b], [thr[0][:-1], thr[1]], [50, 30])


PATHS = {
    # a joint PDF per cell of config 4's 1-degree grid over 64 members
    "perf_model-57-config4-grid": (2, (40, 40), 64800, 64),
    "perf_model-57": (2, (40, 40), 1000, 64),
    "three-inputs-narrow": (3, (20, 20, 20), 4096, 100),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_plan_sends_the_paths_to_direct(path):
    n_inputs, nbins, m, c = PATHS[path]
    assert cuda_hist.plan(n_inputs, nbins, m, c) == "direct"
    assert pallas_hist.plan(n_inputs, nbins, m, c=c, weighted=False, uniform=None) == "direct"


def _numpy_rows(arrays, edges):
    """numpy's joint histogram of each column of ``arrays`` (member axis
    first), all at once: searchsorted-right with the last edge closed, one
    offset bincount. int64 counts ``(columns,) + nbins``."""
    nbins = [len(e) - 1 for e in edges]
    m = arrays[0].shape[1]
    slot = np.zeros(arrays[0].shape, np.int64)
    inside = np.ones(arrays[0].shape, bool)
    for x, e, nb in zip(arrays, edges, nbins):
        x = x.astype(np.float64)
        e = np.asarray(e, np.float64)
        idx = np.searchsorted(e, x, side="right") - 1
        idx[x == e[-1]] = nb - 1
        inside &= (idx >= 0) & (idx < nb)
        slot = slot * nb + np.clip(idx, 0, nb - 1)
    n = int(np.prod(nbins))
    flat = (np.arange(m)[None, :] * n + slot)[inside]
    return np.bincount(flat, minlength=m * n).reshape(m, *nbins)


def test_an_ensemble_past_the_jax_cap_runs_direct(monkeypatch):
    """The first row count past the JAX package's kept-row cap at 3 x 4
    bins: 262,145 kept rows of 5 members, the member axis outermost (a
    (1, m)-strided layout), every seventh row NaN in every member. The port
    runs the direct route (its plain version on the CPU), where the JAX
    package runs scatter, and both, numpy and the benchmark's plain
    reference give the same counts."""
    from portbench import reference
    from xhistogram_torch import core
    from xhistogram_torch.utils import profiling

    m, members = 262_145, 5
    assert pallas_hist.plan(2, (3, 4), m, c=members, weighted=False, uniform=None) is None
    assert pallas_hist.plan(2, (3, 4), m - 1, c=members, weighted=False,
                            uniform=None) == "direct"
    assert cuda_hist.plan(2, (3, 4), m, members) == "direct"
    rng = np.random.default_rng(18)
    t = rng.normal(15.0, 8.0, (members, m)).astype(np.float32)
    s = rng.normal(34.7, 0.8, (members, m)).astype(np.float32)
    t[:, ::7] = np.nan
    s[:, ::7] = np.nan
    te = np.array([-2.0, 10.0, 20.0, 38.0], np.float32)
    se = np.array([33.0, 34.0, 34.5, 35.0, 36.0], np.float32)
    ran = []

    def spy(*args, **kwargs):
        ran.append("direct")
        return cuda_hist.direct(*args, **kwargs)

    monkeypatch.setattr(core, "direct", spy)
    expected = _numpy_rows([t, s], [te, se])
    assert expected[::7].sum() == 0 and expected.sum() > 0
    jh, _ = xhistogram_tpu.histogram(t, s, bins=[te, se], axis=(0,), method="scatter")
    np.testing.assert_array_equal(np.asarray(jh), expected)
    tt, st = torch.from_numpy(t), torch.from_numpy(s)
    want = reference.histogram([tt, st], [te, se], (0,))
    np.testing.assert_array_equal(want.numpy(), expected)
    for method, route in (("cuda", "direct"), ("auto", "scatter")):
        before = dict(profiling.ROUTES)
        h, _ = xhistogram_torch.histogram(tt, st, bins=[te, se], axis=0, method=method)
        assert profiling.ROUTES[route] == before[route] + 1, method
        assert h.shape == (m, 3, 4) and h.dtype == torch.int64
        np.testing.assert_array_equal(h.numpy(), expected, err_msg=method)
    assert ran == ["direct"]  # cuda ran the direct wrapper, auto the scatter path
