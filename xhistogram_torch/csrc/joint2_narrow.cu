// Joint two-input histogram of two inputs of one narrow type, each read in
// place at its own width and widened in registers (joint2.cuh has the
// kernel, which replaces xhistogram_tpu/ops/pallas_hist.py::_joint2_kernel;
// narrow.cuh the loads): float16, bfloat16, int16 and uint16 compared in
// float32, against float32 thresholds (int32 ones converted for the 16-bit
// integers: a threshold past 2^24 rounds, but stays past every 16-bit
// value); int8 and uint8 (bool too, as bytes 0 and 1) through a table of
// their 256 values' bins, found in each block's prologue by the search in
// int32. On a card bound by device memory, reading 2 or 1 bytes an element
// in place of a widened copy's 4 (and of the copy's own pass) is the gain.
// Pairs of two different types have entries of their own
// (joint2_pairs.cu, joint2_pairs_swapped.cu, joint2_mixed.cu).

#include "joint2.cuh"

XH_JOINT2_LOADS(xh_joint2_f16, __half, float, __half, float)
XH_JOINT2_LOADS(xh_joint2_bf16, __nv_bfloat16, float, __nv_bfloat16, float)
XH_JOINT2_LOADS(xh_joint2_i16, short, float, short, float)
XH_JOINT2_LOADS(xh_joint2_u16, unsigned short, float, unsigned short, float)
XH_JOINT2_LOADS(xh_joint2_i8, signed char, int, signed char, int)
XH_JOINT2_LOADS(xh_joint2_u8, unsigned char, int, unsigned char, int)

// The weighted entries xh_joint2_<data>_<cls> of the accumulator class cls
// (accumulator type A), for the six narrow types.
#define XH_JOINT2_NARROW_WEIGHTED_CLASS(cls, A)                                   \
  XH_JOINT2_LOADS_WEIGHTED(xh_joint2_f16_##cls, __half, float, __half, float, A)  \
  XH_JOINT2_LOADS_WEIGHTED(xh_joint2_bf16_##cls, __nv_bfloat16, float,            \
                           __nv_bfloat16, float, A)                               \
  XH_JOINT2_LOADS_WEIGHTED(xh_joint2_i16_##cls, short, float, short, float, A)    \
  XH_JOINT2_LOADS_WEIGHTED(xh_joint2_u16_##cls, unsigned short, float,            \
                           unsigned short, float, A)                              \
  XH_JOINT2_LOADS_WEIGHTED(xh_joint2_i8_##cls, signed char, int, signed char,     \
                           int, A)                                                \
  XH_JOINT2_LOADS_WEIGHTED(xh_joint2_u8_##cls, unsigned char, int, unsigned char, \
                           int, A)

XH_JOINT2_NARROW_WEIGHTED_CLASS(wf64, double)
XH_JOINT2_NARROW_WEIGHTED_CLASS(wu32, unsigned int)
XH_JOINT2_NARROW_WEIGHTED_CLASS(wu64, unsigned long long)
