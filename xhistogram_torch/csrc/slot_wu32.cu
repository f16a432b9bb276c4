// Weighted flat-slot histograms, accumulator class wu32: bool and 8-,
// 16- and 32-bit integer weights, summed mod 2^32 (csrc/weights.cuh).
//
// The weighted entries of the routes factored (full, per_row, packed; see
// factored.cu, which replaces _factored_kernel) and direct (direct.cu,
// which replaces _direct_kernel) for this class, in a source of their own:
// the routes share one template instantiation per data type here, and the
// three classes compile side by side, each in its own nvcc.

#include "slot.cuh"

XH_SLOT_WEIGHTED_CLASS(wu32, unsigned int)
