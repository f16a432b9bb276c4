// Weighted flat-slot histograms, accumulator class wu64: int64 and uint64
// weights, summed mod 2^64 (csrc/weights.cuh).
//
// The weighted xh_slot_<data>_wu64 entries of the four wide data
// types (slot.cu) for this class, in a source of their own: the three
// classes compile side by side, each in its own nvcc.

#include "slot.cuh"

XH_SLOT_WEIGHTED_CLASS(wu64, unsigned long long)
