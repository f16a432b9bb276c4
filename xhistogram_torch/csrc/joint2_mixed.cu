// Joint two-input histogram of an int64 input beside a float one (joint2.cuh
// has the kernel, which replaces
// xhistogram_tpu/ops/pallas_hist.py::_joint2_kernel). Each input meets only
// its own thresholds, so each is compared exactly in its own type: int64
// against int64 thresholds, float32 or float64 against thresholds of its
// type (float16 data arrive widened to float32). No common type would hold
// both exactly. The pair's types are template parameters, as for one type,
// so a mixed call runs as fast as the same-type kernel of its wider input;
// these entries compile in their own nvcc, beside joint2.cu's.

#include "joint2.cuh"

XH_JOINT2(xh_joint2_i64_f32, long long, float)
XH_JOINT2(xh_joint2_f32_i64, float, long long)
XH_JOINT2(xh_joint2_i64_f64, long long, double)
XH_JOINT2(xh_joint2_f64_i64, double, long long)

// The weighted entries xh_joint2_<a>_<b>_<cls> of the accumulator
// class cls (accumulator type A), for the four mixed pairs.
#define XH_JOINT2_MIXED_WEIGHTED_CLASS(cls, A)                                \
  XH_JOINT2_WEIGHTED(xh_joint2_i64_f32_##cls, long long, float, A)            \
  XH_JOINT2_WEIGHTED(xh_joint2_f32_i64_##cls, float, long long, A)            \
  XH_JOINT2_WEIGHTED(xh_joint2_i64_f64_##cls, long long, double, A)           \
  XH_JOINT2_WEIGHTED(xh_joint2_f64_i64_##cls, double, long long, A)

XH_JOINT2_MIXED_WEIGHTED_CLASS(wf64, double)
XH_JOINT2_MIXED_WEIGHTED_CLASS(wu32, unsigned int)
XH_JOINT2_MIXED_WEIGHTED_CLASS(wu64, unsigned long long)
