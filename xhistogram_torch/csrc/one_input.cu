// One-input histogram entries for float32, float64, int32 and int64 data,
// each read and compared in its own type (one_input.cuh has the kernel,
// which replaces xhistogram_tpu/ops/pallas_hist.py::_one_input_kernel, and
// its design).

#include "one_input.cuh"

XH_ONE_INPUT(xh_one_input_f32, float, float)
XH_ONE_INPUT(xh_one_input_f64, double, double)
XH_ONE_INPUT(xh_one_input_i32, int, int)
XH_ONE_INPUT(xh_one_input_i64, long long, long long)

// The weighted entries xh_one_input_<data>_<cls> of the accumulator
// class cls (accumulator type A), for the four data types.
#define XH_ONE_INPUT_WEIGHTED_CLASS(cls, A)                                   \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_f32_##cls, float, float, A)              \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_f64_##cls, double, double, A)            \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_i32_##cls, int, int, A)                  \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_i64_##cls, long long, long long, A)

XH_ONE_INPUT_WEIGHTED_CLASS(wf64, double)
XH_ONE_INPUT_WEIGHTED_CLASS(wu32, unsigned int)
XH_ONE_INPUT_WEIGHTED_CLASS(wu64, unsigned long long)
