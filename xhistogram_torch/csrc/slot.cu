// Flat-slot histograms of N inputs of one wide type (float32, float64,
// int32, int64), over every element or one a kept row: int64 counts.
//
// One entry a data type, xh_slot_<data>, serves four routes of plan(), told
// apart only by the run-time reduce_all: factored (every element into one
// histogram: two inputs past joint2's gate, three or more inputs, one
// input over 1024 bins), factored_per_row and factored_packed (a histogram
// a kept row), and direct outside direct.cuh's envelope (kept rows forced
// onto the kernels past plan()'s envelopes). It replaces the TPU kernels
// xhistogram_tpu/ops/pallas_hist.py::_factored_kernel (with
// _pick_factorization and _packed_tm) and _direct_kernel (with
// _pick_tiles_direct). Those compute each element's flat joint slot and
// count it by multiplying one-hots on the TPU's matrix unit, because the
// TPU has no fast scatter: their work grows with the slot count, so they
// chunk and fold the slot space into (8, 128) tiles, which is what tells
// their routes apart. Hopper has fast atomics, so here each element is
// digitized once per input and counted with one atomic, in shared memory
// where the slots fit and straight into the int64 output where they do not
// (slot.cuh); nothing depends on how the slot count factors, and the routes
// share the kernel. Weighted entries xh_slot_<data>_<class>, one per
// accumulator class of weights.cuh, are in slot_wf64.cu, slot_wu32.cu and
// slot_wu64.cu; inputs of several types in slot_narrow.cu and
// slot_mixed.cu.
//
// What bounds it on an H100: each element reads sizeof(T) bytes per input
// and each output row writes 8 (S + 1) bytes. A full reduction or wide
// rows are bound by the per-element searches and atomics (PERF.md §5);
// narrow rows by the output writes (8 B a slot against 2 sizeof(T) B an
// element read). Weighted: one more read of the weight an element, and
// 8-byte sums, which keep half the slots in shared memory: float sums of
// kept rows past one block as exact integers in a cluster (slot.cuh).

#include "slot.cuh"

XH_SLOT_ENTRY(xh_slot_f32, float)
XH_SLOT_ENTRY(xh_slot_f64, double)
XH_SLOT_ENTRY(xh_slot_i32, int)
XH_SLOT_ENTRY(xh_slot_i64, long long)
