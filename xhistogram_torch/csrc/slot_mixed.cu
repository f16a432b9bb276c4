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
// The entries of the routes factored (full, per_row, packed; factored.cu,
// which replaces xhistogram_tpu/ops/pallas_hist.py::_factored_kernel) and
// direct (direct.cu, which replaces _direct_kernel) for such inputs,
// unweighted and per accumulator class, in a source of their own that
// compiles beside the others. It runs the general N-input kernel, with no
// two-input specialisation.

#include "slot.cuh"

XH_SLOT_MIXED_ENTRY(xh_factored_full_mixed, 1)
XH_SLOT_MIXED_ENTRY(xh_factored_per_row_mixed, 0)
XH_SLOT_MIXED_ENTRY(xh_factored_packed_mixed, 0)
XH_SLOT_MIXED_ENTRY(xh_direct_mixed, 0)

XH_SLOT_MIXED_WEIGHTED_CLASS(wf64, double)
XH_SLOT_MIXED_WEIGHTED_CLASS(wu32, unsigned int)
XH_SLOT_MIXED_WEIGHTED_CLASS(wu64, unsigned long long)
