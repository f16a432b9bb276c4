// Weighted flat-slot histograms, accumulator class wf64: float16,
// bfloat16, float32 and float64 weights, summed in float64
// (csrc/weights.cuh).
//
// The weighted entries of the routes factored (full, per_row, packed; see
// factored.cu, which replaces _factored_kernel) and direct (direct.cu,
// which replaces _direct_kernel) for this class, in a source of their own:
// the routes share one template instantiation per data type here, and the
// three classes compile side by side, each in its own nvcc.

#include "slot.cuh"

XH_SLOT_WEIGHTED_CLASS(wf64, double)
