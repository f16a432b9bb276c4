"""The census by level of CF-packed int16 T and S, as GLORYS12V1's files
store them (the benchmark's ``ts_glorys12v1_int16``), on the CPU.

The data keep their stored int16 and the T-S edges are given in packed
units, ``(e - add_offset) / scale_factor``, as float64: no edge is an
integer, so the integer thresholds are the edges' ceilings
(``bins.compare_form``). Dry cells hold the fill value -32767, below every
edge; the rest are clamped to [-32766, 32767]. The volume of the product's
thin top layers lies far below the deepest layer's, so on the card its
float sums' exact placement (``csrc/slot.cuh``'s ``xh::Exact``) adds part
of them as float64s. The port's public call is held to the benchmark's
plain reference (``portbench/reference.py``) and to the JAX package, counts
bit for bit, sums within one float32 rounding and the JAX package's
'highest' bound. On the card the same call runs factored per row on the
narrow flat-slot entry, reading both inputs in place
(tests/test_torch_gpu.py).
"""

import json
import math

import numpy as np
import pytest
import torch

import xhistogram_tpu
import xhistogram_torch
from xhistogram_torch import bins as tbins
from xhistogram_torch.ops import _build, cuda_hist
from xhistogram_torch.ops.digitize import digitize_edges
from xhistogram_torch.utils import profiling
from xhistogram_torch.utils.axes import normalize_axis, strided_layout

from portbench import reference
from portbench.recipes import ts_depth_packed
from portbench.registry import HERE as BENCH

CONFIG = json.loads((BENCH / "configs" / "ts_glorys12v1_int16.json").read_text())
PK = CONFIG["packing"]
FILL = PK["fill_value"]
LO, HI = PK["valid_range"]
# the product's eight thinnest layers on top, then a few thick ones: the
# volume spans 2^13 of its largest
SMALL = {**CONFIG, "months": 2, "nlat": 9, "nlon": 12,
         "depth_m": [*CONFIG["depth_m"][:8], 155.8507, 1062.44, 5727.917]}
AXIS = (0, 2)
# the JAX package's 'highest' bound on float sums
RTOL, ATOL = 3e-7, 1e-6
# a float32 rounding of a float64 sum, over the reference's sum or, where
# that is smaller, its bins' median (reference.compare)
ROUNDING = 2.0 ** -24


def _case(seed=2**33 + 5):
    """(T, S, volume, edges) from the benchmark's recipe at a small size,
    with the extremes planted in wet cells: the clamped ends of the valid
    range, each side of a few edges' ceilings, and the fill value beside a
    valid partner."""
    d = ts_depth_packed.make(SMALL, seed, torch.device("cpu"), ["T", "S", "volume"])
    t, s, vol = d["T"], d["S"], d["volume"]
    edges = [d["T_edges"], d["S_edges"]]
    wet = (t[0] != FILL).nonzero()
    planted = []
    for e in edges:
        c = np.ceil(e[[1, 2, len(e) // 2, -2, -1]]).astype(np.int64)
        planted.append([LO, HI, FILL, *c, *(c - 1), *(c + 1)])
    n = len(planted[0])
    for k, (lev, cell) in enumerate(wet[:n].tolist()):
        t[k % t.shape[0], lev, cell] = planted[0][k]
        s[k % s.shape[0], lev, cell] = planted[1][(k + 3) % n]
    return t, s, vol, edges


def test_the_packed_edges_are_never_integers_and_threshold_at_their_ceilings():
    for name, (lo, hi) in (("T_edges", (-31401.71, 12287.63)), ("S_edges", (19661.2, 26214.6))):
        e = ts_depth_packed.packed_edges(CONFIG[name], PK[name[0]])
        assert e.dtype == np.float64 and len(e) == CONFIG[name]["n"]
        assert (e != np.round(e)).all()
        assert abs(e[0] - lo) < 0.01 and abs(e[-1] - hi) < 0.01
        assert FILL < e[0] and LO < e[0] and e[-1] < HI  # the fill and the clamps lie outside
        form = tbins.compare_form(e, np.int32)
        assert form.n_hi_clip == 0
        np.testing.assert_array_equal(form.edges[:-1], np.ceil(e[:-1]))
        assert form.edges[-1] == math.floor(e[-1]) + 1  # the closed last bin


def test_the_layers_are_the_midpoints_between_the_product_s_depths():
    dz = ts_depth_packed.thicknesses(CONFIG["depth_m"])
    assert len(dz) == 50
    assert dz.min() == pytest.approx(1.0177) and dz.max() == pytest.approx(453.133)
    assert (dz < dz.max() / 256).sum() == 8  # the thin top layers
    bottom = np.cumsum(dz)
    np.testing.assert_allclose(bottom[:-1], np.convolve(CONFIG["depth_m"], [0.5, 0.5], "valid"))
    assert bottom[-1] - CONFIG["depth_m"][-1] == pytest.approx(dz[-1] / 2)
    area = ts_depth_packed.areas(CONFIG["lat_deg"], CONFIG["nlat"], CONFIG["nlon"])
    assert area.argmax() == np.argmin(np.abs(np.linspace(-80, 90, 2041)))  # the equator
    assert area[-1] < area[-2] / 1.5  # the half cell at the pole
    cells = CONFIG["nlat"] * CONFIG["nlon"]
    assert 50 * cells * 2 * 2 * CONFIG["months"] == 42_322_176_000  # T and S, int16


def test_the_recipe_packs_as_the_product_stores():
    t, s, vol = (ts_depth_packed.make(SMALL, 2**31 + 9, torch.device("cpu"),
                                      ["T", "S", "volume"])[k] for k in ("T", "S", "volume"))
    assert t.dtype == s.dtype == torch.int16 and vol.dtype == torch.float32
    dry = t == FILL
    assert dry.equal(s == FILL) and dry.equal((vol == 0).expand_as(dry))
    assert dry.any() and not dry.all()
    for x in (t, s):
        wet = x[~dry]
        assert wet.min() >= LO and wet.max() <= HI
    assert (t[~dry] == HI).any()  # the warm surface's tail, clamped
    counts = (~dry[0]).sum(1)
    assert (counts[:-1] >= counts[1:]).all() and counts[0] > counts[-1]
    again = ts_depth_packed.make(SMALL, 2**31 + 9, torch.device("cpu"), ["T"])["T"]
    other = ts_depth_packed.make(SMALL, 2**31 + 10, torch.device("cpu"), ["T"])["T"]
    assert again.equal(t) and not other.equal(t) and (other == FILL).equal(dry)


@pytest.mark.parametrize("method", ["auto", "cuda"])
@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "volume"])
def test_the_census_equals_the_plain_reference(weighted, method):
    t, s, vol, edges = _case()
    w = vol if weighted else None
    h, got_edges = xhistogram_torch.histogram(t, s, bins=edges, axis=AXIS, weights=w,
                                              method=method)
    assert h.shape == (t.shape[1], len(edges[0]) - 1, len(edges[1]) - 1)
    assert h.dtype == (torch.float32 if weighted else torch.int64)
    want = reference.histogram([t, s], edges, AXIS, w)
    found = reference.compare({"hist": h, "edges": got_edges}, {"hist": want, "edges": edges})
    assert found["edge_gap"] == 0
    # the fill value and the clamped ends lie outside the edges: only the
    # elements with both values within them count
    inside = torch.ones_like(t, dtype=torch.bool)
    for x, e in zip((t, s), edges):
        inside &= (x.double() >= e[0]) & (x.double() <= e[-1])
    assert (t[~inside] == FILL).any() and (t[~inside] == HI).any()
    if weighted:
        assert 0 < found["sum_rel_gap"] <= ROUNDING
    else:
        assert found["count_gap"] == 0 and int(h.sum()) == int(inside.sum())


@pytest.mark.parametrize("jax_method", ["auto", "pallas"])
@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "volume"])
def test_the_census_equals_the_jax_package(weighted, jax_method):
    """The JAX package's public call, and its kernels under the Pallas
    interpreter, on the same int16 data and packed edges."""
    t, s, vol, edges = _case(seed=2**32 + 77)
    jw = None if not weighted else vol.numpy()
    kwargs = {"precision": "highest"} if weighted else {}
    jh, jedges = xhistogram_tpu.histogram(t.numpy(), s.numpy(), bins=edges, axis=AXIS,
                                          weights=jw, method=jax_method, **kwargs)
    jh = np.asarray(jh)
    h, _ = xhistogram_torch.histogram(t, s, bins=edges, axis=AXIS,
                                      weights=None if jw is None else vol)
    assert h.shape == jh.shape
    for a, b in zip(jedges, edges):
        np.testing.assert_array_equal(np.asarray(a), b)
    if weighted:
        np.testing.assert_allclose(h.numpy(), jh, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(h.numpy(), jh)


def test_thin_layers_fall_back_from_the_exact_sums():
    """By the kernel's rule (``cuda_hist.exact_integer``), the volumes of the
    thin top layers are not all whole multiples of the unit that the
    largest volume sets, and the thick layers' are: the card adds part of
    this call's weights as float64s. The sums by that rule, integers of the
    unit and the rest as floats, equal the reference's."""
    t, s, vol, edges = _case()
    u = cuda_hist.exact_unit(float(vol.max()))
    exact = vol.double().apply_(lambda v: cuda_hist.exact_integer(v, u) is not None)
    counted = torch.ones_like(t, dtype=torch.bool)
    for x, e in zip((t, s), edges):
        counted &= reference.digitize(x, e).reshape(x.shape) >= 0
    per_level = (counted & (exact == 0)).sum((0, 2)) / counted.sum((0, 2)).clamp_min(1)
    assert 0 < per_level[:8].mean() and per_level[-1] == 0
    fell = int((counted & (exact == 0)).sum())
    assert 0 < fell < int(counted.sum())
    # the exact part as integers of 2^u, the rest added in float64
    idx = [reference.digitize(x, e).reshape(x.shape) for x, e in zip((t, s), edges)]
    slot = idx[0] * (len(edges[1]) - 1) + idx[1]
    wb = vol.double().expand_as(t)
    level = torch.arange(t.shape[1])[None, :, None].expand_as(t)
    flat = (level * slot.new_tensor(len(edges[0]) - 1) * (len(edges[1]) - 1) + slot)[counted]
    n_slots = t.shape[1] * (len(edges[0]) - 1) * (len(edges[1]) - 1)
    ints = torch.bincount(flat, (wb * 2.0 ** -u * exact)[counted], minlength=n_slots)
    floats = torch.bincount(flat, (wb * (exact == 0))[counted], minlength=n_slots)
    mirror = ints * 2.0 ** u + floats
    want = reference.histogram([t, s], edges, AXIS, vol).reshape(-1)
    torch.testing.assert_close(mirror, want, rtol=1e-12, atol=0)


def test_the_cell_s_call_plans_the_narrow_flat_slot_entry_in_place():
    """At the cell's own shape, (24, 50, 8,817,120) int16 T and S with the
    broadcast (50, 8,817,120) float32 volume (meta tensors: no memory):
    factored per row, both inputs read as int16 through the narrow entry's
    float32 compare, the float-weighted class of ``xh_slot_narrow_wf64``,
    and a strided layout that copies nothing."""
    months, levels, cells = CONFIG["months"], 50, CONFIG["nlat"] * CONFIG["nlon"]
    nbins = (CONFIG["T_edges"]["n"] - 1, CONFIG["S_edges"]["n"] - 1)
    assert cuda_hist.plan(2, nbins, levels, months * cells) == "factored_per_row"
    op = cuda_hist.operand_plan("slot", (torch.int16, torch.int16))
    assert op.entry == "narrow" and op.loads == (torch.int16, torch.int16)
    assert op.compare == (torch.float32, torch.float32)
    assert cuda_hist._WEIGHT_CLASS[torch.float32][0] == "wf64"
    assert "xh_slot_narrow_wf64" in {name for name, _ in _build.symbols()}
    t = torch.empty((months, levels, cells), dtype=torch.int16, device="meta")
    vol = torch.empty((levels, cells), dtype=torch.float32, device="meta").expand(t.shape)
    layout = strided_layout([t, t, vol], normalize_axis(AXIS, 3))
    assert not layout.copied and layout.shape == (1, levels, months, cells)
    assert [v.dtype for v in layout.views] == [torch.int16, torch.int16, torch.float32]
    assert layout.views[2].stride()[2] == 0  # the volume broadcast over the months


def test_narrow_reads_count_only_on_the_card():
    before = dict(profiling.NARROW_READS)
    t, s, vol, edges = _case()
    xhistogram_torch.histogram(t, s, bins=edges, axis=AXIS, weights=vol, method="cuda")
    xhistogram_torch.histogram(t, s, bins=edges, axis=AXIS)
    digitize_edges(t, torch.from_numpy(np.ceil(edges[0][:-1])).to(torch.int32))
    assert profiling.NARROW_READS == before


def test_a_launch_counts_its_narrow_inputs_in_place():
    before = dict(profiling.NARROW_READS)
    cuda_hist._note_in_place([torch.zeros(2, dtype=d) for d in (
        torch.int16, torch.float32, torch.bool, torch.bfloat16, torch.int64, torch.uint8)])
    profiling.note_narrow_read("widened", 2)
    after = profiling.NARROW_READS
    assert {k: after[k] - before[k] for k in after} == {"in_place": 4, "widened": 2}
    with pytest.raises(KeyError):
        profiling.note_narrow_read("elsewhere")
