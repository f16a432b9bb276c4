// The pairs of joint2_pairs.cu in the other order: float32 before float16,
// bfloat16, int16, uint16, int8, uint8 (bool as bytes) or int32, float64
// before float32 and int64 before int32, each input read in place and
// compared in its own type (joint2.cuh has the kernel, which replaces
// xhistogram_tpu/ops/pallas_hist.py::_joint2_kernel), in a source of their
// own that compiles beside joint2_pairs.cu.

#include "joint2.cuh"

XH_JOINT2_PAIR(f32, float, float, f16, __half, float)
XH_JOINT2_PAIR(f32, float, float, bf16, __nv_bfloat16, float)
XH_JOINT2_PAIR(f32, float, float, i16, short, float)
XH_JOINT2_PAIR(f32, float, float, u16, unsigned short, float)
XH_JOINT2_PAIR(f32, float, float, i8, signed char, int)
XH_JOINT2_PAIR(f32, float, float, u8, unsigned char, int)
XH_JOINT2_PAIR(f32, float, float, i32, int, int)
XH_JOINT2_PAIR(f64, double, double, f32, float, float)
XH_JOINT2_PAIR(i64, long long, long long, i32, int, int)
