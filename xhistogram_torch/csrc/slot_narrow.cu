// Flat-slot histograms of float32 data and narrow data, each input read in
// place at its own width (bool, int8, uint8, int16, uint16, float16,
// bfloat16, float32, in any mix) and widened in registers to float32
// (slot.cuh's narrow instantiation, T = Narrow; narrow.cuh's loads), against
// float32 thresholds; 8-bit data through a table of its 256 values' bins.
// Every value and every comparison is kept (narrow.cuh), so the counts equal
// the plain path's on a widened copy bit for bit.
//
// The entries of the routes factored (full, per_row, packed; factored.cu,
// which replaces xhistogram_tpu/ops/pallas_hist.py::_factored_kernel) and
// direct (direct.cu, which replaces _direct_kernel) for such inputs,
// unweighted and per accumulator class, in a source of their own that
// compiles beside the others, with the two-input kernel of the one-type
// instantiations.

#include "slot.cuh"

XH_SLOT_NARROW_ENTRY(xh_factored_full_narrow, 1)
XH_SLOT_NARROW_ENTRY(xh_factored_per_row_narrow, 0)
XH_SLOT_NARROW_ENTRY(xh_factored_packed_narrow, 0)
XH_SLOT_NARROW_ENTRY(xh_direct_narrow, 0)

XH_SLOT_NARROW_WEIGHTED_CLASS(wf64, double)
XH_SLOT_NARROW_WEIGHTED_CLASS(wu32, unsigned int)
XH_SLOT_NARROW_WEIGHTED_CLASS(wu64, unsigned long long)
