// Flat-slot histograms of float32 data and narrow data, each input read in
// place at its own width (bool, int8, uint8, int16, uint16, float16,
// bfloat16, float32, in any mix) and widened in registers to float32
// (slot.cuh's narrow instantiation, T = Narrow; narrow.cuh's loads), against
// float32 thresholds; 8-bit data through a table of its 256 values' bins.
// Every value and every comparison is kept (narrow.cuh), so the counts equal
// the plain path's on a widened copy bit for bit.
//
// The xh_slot_* entries (slot.cu) for such inputs, unweighted and per
// accumulator class, in a source of their own that compiles beside the
// others, with the two-input kernel of the one-type instantiations.

#include "slot.cuh"

XH_SLOT_CODED_ENTRY(xh_slot_narrow, slot::Narrow)
XH_SLOT_CODED_WEIGHTED_ENTRY(xh_slot_narrow_wf64, slot::Narrow, double)
XH_SLOT_CODED_WEIGHTED_ENTRY(xh_slot_narrow_wu32, slot::Narrow, unsigned int)
XH_SLOT_CODED_WEIGHTED_ENTRY(xh_slot_narrow_wu64, slot::Narrow, unsigned long long)
