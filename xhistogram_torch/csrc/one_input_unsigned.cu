// One-input histogram entries for uint32 and uint64 data, read in place at
// their own width (one_input.cuh has the kernel, which replaces
// xhistogram_tpu/ops/pallas_hist.py::_one_input_kernel): uint32 widened in
// registers to int64, uint64 flipped onto int64 there (x ^ 2^63, which keeps
// its order; narrow.cuh), each compared in int64 against thresholds that
// bins.compare_form makes in int64 for uint32 and in uint64, flipped alike,
// for uint64. The JAX package widens uint32 on the host; here neither type
// is copied: a uint32 element costs 4 bytes of reads, not a widening pass
// and 8.

#include "one_input.cuh"

XH_ONE_INPUT(xh_one_input_u32, unsigned int, long long)
XH_ONE_INPUT(xh_one_input_u64, unsigned long long, long long)

// The weighted entries xh_one_input_<data>_<cls> of the accumulator class
// cls (accumulator type A), for the two unsigned types.
#define XH_ONE_INPUT_UNSIGNED_WEIGHTED_CLASS(cls, A)                          \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_u32_##cls, unsigned int, long long, A)   \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_u64_##cls, unsigned long long, long long, A)

XH_ONE_INPUT_UNSIGNED_WEIGHTED_CLASS(wf64, double)
XH_ONE_INPUT_UNSIGNED_WEIGHTED_CLASS(wu32, unsigned int)
XH_ONE_INPUT_UNSIGNED_WEIGHTED_CLASS(wu64, unsigned long long)
