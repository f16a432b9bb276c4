// Weighted flat-slot histograms, accumulator class wu32: bool and 8-,
// 16- and 32-bit integer weights, summed mod 2^32 (csrc/weights.cuh).
//
// The weighted xh_slot_<data>_wu32 entries of the four wide data
// types (slot.cu) for this class, in a source of their own: the three
// classes compile side by side, each in its own nvcc.

#include "slot.cuh"

XH_SLOT_WEIGHTED_CLASS(wu32, unsigned int)
