// One-input histogram entries for narrow data, read in place at its own
// width and widened in registers (one_input.cuh has the kernel, which
// replaces xhistogram_tpu/ops/pallas_hist.py::_one_input_kernel): float16,
// bfloat16, int16 and uint16 compared in float32 (exact for every 16-bit
// value, and with a float32 cell map), int8 and uint8 (bool too, as bytes
// 0 and 1) in int32 through a table of their 256 values' bins, against
// thresholds of that compare type, which bins.compare_form makes without
// saturating at the narrow type's bounds (int32 ones converted to float32
// for 16-bit integers: a threshold past 2^24 rounds, but stays past every
// 16-bit value). On a card bound by device memory, reading 1 or 2 bytes an
// element in place of a widened copy's 4 (and of the copy's own pass) is
// the gain.

#include "one_input.cuh"

XH_ONE_INPUT(xh_one_input_f16, __half, float)
XH_ONE_INPUT(xh_one_input_bf16, __nv_bfloat16, float)
XH_ONE_INPUT(xh_one_input_i16, short, float)
XH_ONE_INPUT(xh_one_input_u16, unsigned short, float)
XH_ONE_INPUT(xh_one_input_i8, signed char, int)
XH_ONE_INPUT(xh_one_input_u8, unsigned char, int)

// The weighted entries xh_one_input_<data>_<cls> of the accumulator
// class cls (accumulator type A), for the six narrow types.
#define XH_ONE_INPUT_NARROW_WEIGHTED_CLASS(cls, A)                            \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_f16_##cls, __half, float, A)             \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_bf16_##cls, __nv_bfloat16, float, A)     \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_i16_##cls, short, float, A)              \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_u16_##cls, unsigned short, float, A)     \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_i8_##cls, signed char, int, A)           \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_u8_##cls, unsigned char, int, A)

XH_ONE_INPUT_NARROW_WEIGHTED_CLASS(wf64, double)
XH_ONE_INPUT_NARROW_WEIGHTED_CLASS(wu32, unsigned int)
XH_ONE_INPUT_NARROW_WEIGHTED_CLASS(wu64, unsigned long long)
