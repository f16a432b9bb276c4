// Flat-slot histograms of inputs of several types that are not all float32
// or narrow: int32, int64 or float64 beside inputs of another type (int32
// beside float32, float32 beside float64, int32 beside int64, int64 beside
// a float, bool, 8- and 16-bit integers, float16 or bfloat16 beside int32,
// int64 or float64; slot.cuh's mixed instantiation, T = Mixed). Each input
// is read in place as its own type and compares against its own
// thresholds, int64 in int64 and every other type in double, to which it
// converts exactly (8-bit data through a table of its 256 values' bins), so
// the counts equal the plain path's bit for bit and no input is widened in
// device memory.
//
// The xh_slot_* entries (slot.cu) for such inputs, unweighted and per
// accumulator class, in a source of their own that compiles beside the
// others. It runs the general N-input kernel, with no two-input
// specialisation.

#include "slot.cuh"

XH_SLOT_CODED_ENTRY(xh_slot_mixed, slot::Mixed)
XH_SLOT_CODED_WEIGHTED_ENTRY(xh_slot_mixed_wf64, slot::Mixed, double)
XH_SLOT_CODED_WEIGHTED_ENTRY(xh_slot_mixed_wu32, slot::Mixed, unsigned int)
XH_SLOT_CODED_WEIGHTED_ENTRY(xh_slot_mixed_wu64, slot::Mixed, unsigned long long)
