// Factored-route histograms: N inputs, int64 counts or weighted sums, in
// three variants.
//
// Replaces the TPU kernel xhistogram_tpu/ops/pallas_hist.py::_factored_kernel
// (driven by _run_factored, with _pick_factorization and _packed_tm). That
// kernel computes each element's flat joint slot g, splits it into
// (g >> log2 n2, g & (n2 - 1)) and counts by multiplying the two equality
// one-hots on the TPU's matrix unit, because the TPU has no fast scatter:
// its work grows with the slot count, so it chunks n1 through HBM for big
// grids, folds rows to fill (8, 128) tiles, and stacks 8 rows' slot spaces
// in one tile for narrow rows (packed). Hopper has fast atomics, so every
// variant here is the flat-slot histogram of slot.cuh: each element is
// digitized once per input and counted with one atomic, in shared memory
// where the slots fit and straight into the int64 output where they do not.
// Nothing here depends on the slot count's factorization.
//
// The three entries per data type are the three routes of plan():
// - xh_factored_full_*: every element into one histogram (route factored;
//   2-input grids past joint2's gate, 3+ inputs, one input over 1024 bins);
// - xh_factored_per_row_*: one histogram per kept row, rows of 256 or more
//   elements (route factored_per_row, e.g. the per-depth T-S diagram);
// - xh_factored_packed_*: the same for rows narrower than 256 elements and
//   over 8192 slots (route factored_packed), where each tile holds whole
//   rows and the output writes dominate.
// They share the kernel and differ in their launch counts and timings.
// Each has weighted entries, xh_factored_<variant>_<data>_<class>, one per
// accumulator class of weights.cuh, in slot_wf64.cu, slot_wu32.cu and
// slot_wu64.cu, in place of the TPU kernel's weight limbs, Kahan outputs
// and NaN/inf channels.
//
// What bounds it on an H100: each element reads sizeof(T) bytes per input
// and each output row writes 8 (S + 1) bytes. A full reduction or wide
// rows are bound by the per-element searches and atomics (PERF.md §5);
// packed rows by the output writes (8 B a slot against 2 sizeof(T) B an
// element read). Weighted: one more read of the weight an element, and
// float64 or 64-bit shared atomics, which keep half the slots in shared
// memory.

#include "slot.cuh"

XH_SLOT_ENTRY(xh_factored_full_f32, float, 1)
XH_SLOT_ENTRY(xh_factored_full_f64, double, 1)
XH_SLOT_ENTRY(xh_factored_full_i32, int, 1)
XH_SLOT_ENTRY(xh_factored_full_i64, long long, 1)
XH_SLOT_ENTRY(xh_factored_per_row_f32, float, 0)
XH_SLOT_ENTRY(xh_factored_per_row_f64, double, 0)
XH_SLOT_ENTRY(xh_factored_per_row_i32, int, 0)
XH_SLOT_ENTRY(xh_factored_per_row_i64, long long, 0)
XH_SLOT_ENTRY(xh_factored_packed_f32, float, 0)
XH_SLOT_ENTRY(xh_factored_packed_f64, double, 0)
XH_SLOT_ENTRY(xh_factored_packed_i32, int, 0)
XH_SLOT_ENTRY(xh_factored_packed_i64, long long, 0)
