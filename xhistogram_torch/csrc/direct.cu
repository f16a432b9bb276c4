// Direct-route histograms outside direct.cuh's envelope: N inputs, kept
// rows, int64 counts or weighted sums, on the flat-slot template.
//
// Replaces the TPU kernel xhistogram_tpu/ops/pallas_hist.py::_direct_kernel
// (driven by _run_direct, with _pick_tiles_direct) where direct.cuh does not
// take the call. That kernel builds a one-hot of each element's flat slot
// over a chunk of slots and multiplies it with a row one-hot on the TPU's
// matrix unit, chunk by chunk, because the TPU has no fast scatter. Here it
// is the flat-slot histogram of slot.cuh: each element is digitized once per
// input and counted with one atomic into its row's histogram.
//
// plan() sends the direct route kept rows narrower than 256 elements with at
// most 8192 slots (e.g. a joint PDF of two variables at each of 64,800 grid
// cells over 64 members), which direct.cuh's warp-per-row kernel takes
// (direct_rows*.cu). These entries take the rest: every kept-row call forced
// with method="cuda" outside plan()'s envelopes, at any slot count or row
// length (inputs of several types through slot_mixed.cu and
// slot_narrow.cu). A tile holds several
// whole rows, each with its histogram in shared memory, and stores every
// slot of them, so the output needs no zeroing pass.
//
// What bounds it on an H100: the output. Each row writes 8 (S + 1) bytes
// against 2 sizeof(T) c bytes read.
//
// Weighted entries xh_direct_<data>_<class> (slot_wf64.cu, slot_wu32.cu,
// slot_wu64.cu) add each element's weight (weights.cuh) in place of the
// TPU kernel's weight limbs and channels; the output rows are then
// sizeof(A) bytes a slot.

#include "slot.cuh"

XH_SLOT_ENTRY(xh_direct_f32, float, 0)
XH_SLOT_ENTRY(xh_direct_f64, double, 0)
XH_SLOT_ENTRY(xh_direct_i32, int, 0)
XH_SLOT_ENTRY(xh_direct_i64, long long, 0)
