// Joint two-input histogram of an int64 input beside a float one, and of
// every pair of two types without an instantiation of its own (joint2.cuh
// has the kernel, which replaces
// xhistogram_tpu/ops/pallas_hist.py::_joint2_kernel). Each input meets only
// its own thresholds, so each is compared exactly in its own type: int64
// against int64 thresholds, float32 or float64 against thresholds of its
// type. No common type would hold both exactly. For int64 beside float32
// or float64 the pair's types are template parameters, as for one type, so
// such a call runs as fast as the same-type kernel of its wider input.
//
// The mixed entries xh_joint2_mixed take the rest, in place: two different
// narrow types, narrow data beside int32, int64 or float64, int32 beside
// float64. Each input is read by its run-time load code (narrow.cuh; the
// same in every lane, one switch per input and group of elements) and held
// in 8 bytes, int64 compared in int64 and every other type in double, to
// which it converts exactly; 8-bit data through a table of its 256 values'
// bins. These entries compile in their own nvcc, beside joint2.cu's.

#include "joint2.cuh"

XH_JOINT2_PAIR(i64, long long, long long, f32, float, float)
XH_JOINT2_PAIR(f32, float, float, i64, long long, long long)
XH_JOINT2_PAIR(i64, long long, long long, f64, double, double)
XH_JOINT2_PAIR(f64, double, double, i64, long long, long long)

XH_JOINT2_MIXED(xh_joint2_mixed)
XH_JOINT2_MIXED_WEIGHTED(xh_joint2_mixed_wf64, double)
XH_JOINT2_MIXED_WEIGHTED(xh_joint2_mixed_wu32, unsigned int)
XH_JOINT2_MIXED_WEIGHTED(xh_joint2_mixed_wu64, unsigned long long)
