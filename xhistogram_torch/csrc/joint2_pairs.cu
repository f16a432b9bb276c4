// Joint two-input histogram of two inputs of different types that users
// pass together, each read in place at its own width and compared in its
// own type against its own thresholds (joint2.cuh has the kernel, which
// replaces xhistogram_tpu/ops/pallas_hist.py::_joint2_kernel, as that
// kernel widens each input's tile on its own; narrow.cuh the loads):
// float16, bfloat16, int16 and uint16 compared as float32, int8 and uint8
// (bool as bytes) through a table of their 256 values' bins, beside float32
// (a temperature packed as CF-style int16 or stored as bfloat16 beside a
// float32 salinity); int32 as itself beside float32 (an index or time
// coordinate beside a field) and beside int64; float32 beside float64 (a
// field beside a model's double output). Each input meets only its own
// thresholds, so no type common to both is needed and nothing is widened
// in device memory. The pair's types are template parameters, with no
// run-time switch, so a pair runs as the kernel of its wider input does.
//
// These are the pairs with the narrow or the narrower input first; their
// swapped orders are in joint2_pairs_swapped.cu, which compiles beside this
// source. Every other pair of two types takes the mixed entries
// (joint2_mixed.cu).

#include "joint2.cuh"

XH_JOINT2_PAIR(f16, __half, float, f32, float, float)
XH_JOINT2_PAIR(bf16, __nv_bfloat16, float, f32, float, float)
XH_JOINT2_PAIR(i16, short, float, f32, float, float)
XH_JOINT2_PAIR(u16, unsigned short, float, f32, float, float)
XH_JOINT2_PAIR(i8, signed char, int, f32, float, float)
XH_JOINT2_PAIR(u8, unsigned char, int, f32, float, float)
XH_JOINT2_PAIR(i32, int, int, f32, float, float)
XH_JOINT2_PAIR(f32, float, float, f64, double, double)
XH_JOINT2_PAIR(i32, int, int, i64, long long, long long)
