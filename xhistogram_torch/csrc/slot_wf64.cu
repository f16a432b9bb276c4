// Weighted flat-slot histograms, accumulator class wf64: float16,
// bfloat16, float32 and float64 weights, summed in float64
// (csrc/weights.cuh).
//
// The weighted xh_slot_<data>_wf64 entries of the four wide data
// types (slot.cu) for this class, in a source of their own: the three
// classes compile side by side, each in its own nvcc.

#include "slot.cuh"

XH_SLOT_WEIGHTED_CLASS(wf64, double)
