// Per-element weights of the weighted histogram kernels, shared by all four.
//
// A kernel takes one of these policies as a template parameter:
// - Count, unweighted: each counted element adds one to a 32-bit counter
//   in shared memory, flushed into the int64 output (the kernels' first
//   form, unchanged).
// - Sum<A>, weighted: each counted element adds its weight, converted at
//   load into the accumulator type A, in shared memory where the histogram
//   fits and straight into the output (also of type A) otherwise:
//     double              float16, bfloat16, float32, float64 weights,
//                         summed in float64 (the caller rounds the sums
//                         once, to float32, unless the weights are float64);
//     unsigned int        bool and 8-, 16-, 32-bit integers, summed mod 2^32
//                         (the int32 result wraps as an int32 accumulator);
//     unsigned long long  int64 and uint64, summed mod 2^64.
// So three accumulator types, and not every weight dtype, multiply the
// instantiations; within a class the stored type is a run-time code, the
// same for every thread, so its switch never diverges.
//
// The weighted kernels add with atomics, which take IEEE semantics slot by
// slot (np.bincount's): a NaN weight makes its own slot NaN, +inf and -inf
// in one slot make it NaN. Integer atomics commute, so integer sums are
// exact and deterministic; float64 sums depend on the order of the adds,
// which varies from run to run, by about n 2^-53 relatively for n weights
// in a slot, far below the float32 rounding that follows.
//
// Weights are an (m, c) view with their own non-negative strides (a
// broadcast weight has stride 0), read in place like the data.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace xh {

struct Weights {
  const void* data;  // element (r, j) at data[r * sm + j * sc]
  long long sm;
  long long sc;
  int code;  // the stored type within the class; see load_weight
};

struct Count {
  static constexpr bool kWeighted = false;
  using Shared = unsigned int;
  using Out = unsigned long long;
};

template <typename A>
struct Sum {
  static constexpr bool kWeighted = true;
  using Shared = A;
  using Out = A;
};

// Weight i of p, stored as the type `code` names: 0 float32, 1 float64,
// 2 float16, 3 bfloat16.
__device__ __forceinline__ void load_weight(const void* p, long long i,
                                            int code, double& w) {
  switch (code) {
    case 0:
      w = static_cast<const float*>(p)[i];
      break;
    case 1:
      w = static_cast<const double*>(p)[i];
      break;
    case 2:
      w = __half2float(static_cast<const __half*>(p)[i]);
      break;
    default:
      w = __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
}

// 0 int32 or uint32, 1 int16, 2 uint16, 3 int8, 4 uint8 or bool; signed
// types sign-extend, so the sums are right mod 2^32.
__device__ __forceinline__ void load_weight(const void* p, long long i,
                                            int code, unsigned int& w) {
  switch (code) {
    case 0:
      w = static_cast<const unsigned int*>(p)[i];
      break;
    case 1:
      w = (unsigned int)(int)static_cast<const short*>(p)[i];
      break;
    case 2:
      w = static_cast<const unsigned short*>(p)[i];
      break;
    case 3:
      w = (unsigned int)(int)static_cast<const signed char*>(p)[i];
      break;
    default:
      w = static_cast<const unsigned char*>(p)[i];
  }
}

// int64 or uint64 (the same bits).
__device__ __forceinline__ void load_weight(const void* p, long long i,
                                            int, unsigned long long& w) {
  w = static_cast<const unsigned long long*>(p)[i];
}

}  // namespace xh
