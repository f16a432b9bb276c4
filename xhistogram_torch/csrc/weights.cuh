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
// - Exact, the float class's placement past one block's shared memory
//   (slot.cuh): each weight that is a whole multiple of the call's unit 2^u
//   adds the integer w / 2^u (below 2^kExactBits in magnitude) to its
//   slot's 32-bit word with one native atomic, and where that word wraps
//   (a carry, or a borrow for a negative weight) adds the wrap,
//   +-2^(u + 32), into the float64 output; any other weight adds as
//   Sum<double> does, straight into the output. A flush adds each word
//   times 2^u into the output. Every add into the output is a whole
//   multiple of 2^u, so the sums are exact while they stay below
//   2^(u + 53) in magnitude, and round far less often than a float64
//   atomic for every element does.
//
// The weighted kernels add with atomics, which take IEEE semantics slot by
// slot (np.bincount's): a NaN weight makes its own slot NaN, +inf and -inf
// in one slot make it NaN. Integer atomics commute, so integer sums are
// exact and deterministic; float64 sums depend on the order of the adds,
// which varies from run to run, by about n 2^-53 relatively for n weights
// in a slot, far below the float32 rounding that follows.
//
// Weights are an (m1, m0, c1, c0) view with their own non-negative strides
// (a broadcast weight has stride 0), read in place like the data.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "narrow.cuh"

namespace xh {

struct Weights {
  // element (r, j), r = i1 * m0 + i0 and j = j1 * c0 + j0, at
  // data[i1 * sm1 + i0 * sm + j1 * sc1 + j0 * sc]
  const void* data;
  long long sm;
  long long sc;
  int code;  // the stored type within the class; see load_weight
  long long sm1;
  long long sc1;
};

// The weights of a C entry: w, the four strides (sm1, sm, sc1, sc) of its
// view (none unweighted) and the type code.
inline Weights weights_of(const void* w, const long long* st, int code) {
  return st == nullptr ? Weights{} : Weights{w, st[1], st[3], code, st[0], st[2]};
}

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

// float16, bfloat16, float32 and float64 weights (load_weight's double)
// summed as integers of the unit 2^u: a slot's 32-bit word, its wraps and
// the flush into a float64 output.
struct Exact {
  static constexpr bool kWeighted = true;
  using Shared = unsigned int;
  using Out = double;
};

// The bits of an exact weight's integer |w| / 2^u: a word wraps on about
// |w| / 2^(u + 32) of its adds, and a weight falls back to a float add where
// it has set bits below 2^u, so fewer bits trade wraps for fallbacks
constexpr int kExactBits = 32;

// u of the unit 2^u for weights whose largest finite magnitude is amax: every
// |w| <= amax is below 2^(u + kExactBits), so w / 2^u fits a 32-bit word and
// a sign (u = 0 when amax is 0: every finite weight is then 0).
__device__ __forceinline__ int exact_unit(double amax) {
  return amax > 0.0 ? ilogb(amax) - (kExactBits - 1) : 0;
}

// Whether w adds exactly under the unit 2^u, given inv = 2^-u, and then
// |w| / 2^u in m and its sign in neg: a finite whole multiple of 2^u below
// 2^(u + kExactBits) in magnitude. NaN, infinities and weights with set bits
// below 2^u (a scaled w that is not whole, or that underflowed to 0) add as
// floats instead, as every weight does where 2^-u overflows (weights below
// 2^-992).
__device__ __forceinline__ bool exact_integer(double w, double inv, unsigned& m, bool& neg) {
  const double q = w * inv;  // exact: a power of two, q whole or below 1
  if (!(fabs(q) < (double)(1ull << kExactBits)) || q != trunc(q) || (q == 0.0 && w != 0.0))
    return false;
  m = (unsigned)fabs(q);
  neg = q < 0.0;
  return true;
}

// The word's add for (neg ? -m : m), 0 < m < 2^32: m, or -m modulo 2^32.
__device__ __forceinline__ unsigned exact_low(unsigned m, bool neg) {
  return neg ? 0u - m : m;
}

// Once `old = atomicAdd(word, lo)` added lo = exact_low(m, neg): the
// multiple of 2^32 the add moved out of the word, +1 where it carried past
// 2^32 - 1, -1 where a negative add borrowed below 0, else 0 (most adds). A
// word plus its wraps times 2^32 is the exact sum of its adds, whatever the
// order of other threads' adds.
__device__ __forceinline__ int exact_wrap(unsigned old, unsigned lo, bool neg) {
  const bool carry = old + lo < old;
  return carry == neg ? 0 : neg ? -1 : 1;
}

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

// The bytes of one weight stored as the type `code` names, for the load
// type A of its class (load_weight's double, unsigned int or unsigned long
// long).
template <typename A>
__host__ __device__ constexpr int weight_bytes(int code) {
  if constexpr (std::is_same<A, double>::value)
    return code == 1 ? 8 : code == 0 ? 4 : 2;
  else if constexpr (std::is_same<A, unsigned int>::value)
    return code == 0 ? 4 : code <= 2 ? 2 : 1;
  else
    return 8;
}

// w: weight u of four loaded by load_four (narrow.cuh), stored as the float
// type `code` names (load_weight's codes; float64 is never loaded so).
__device__ __forceinline__ void weight_of_four(const uint4& r, int u, int code, double& w) {
  switch (code) {
    case 0:
      w = __uint_as_float(bits_of(r, u, 4));
      break;
    case 2:
      w = __half2float(__ushort_as_half((unsigned short)bits_of(r, u, 2)));
      break;
    default:
      w = __uint_as_float(bits_of(r, u, 2) << 16);
  }
}

// ... stored as the integer type `code` names, modulo 2^32 (signed types
// sign-extend).
__device__ __forceinline__ void weight_of_four(const uint4& r, int u, int code,
                                               unsigned int& w) {
  switch (code) {
    case 0:
      w = bits_of(r, u, 4);
      break;
    case 1:
      w = (unsigned int)(int)(short)bits_of(r, u, 2);
      break;
    case 2:
      w = bits_of(r, u, 2);
      break;
    case 3:
      w = (unsigned int)(int)(signed char)bits_of(r, u, 1);
      break;
    default:
      w = bits_of(r, u, 1);
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

__device__ __forceinline__ float stored_value(__half x) { return __half2float(x); }
__device__ __forceinline__ float stored_value(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename S>
__device__ __forceinline__ S stored_value(S x) {
  return x;
}

// w[u] = weight i[u] of p stored as S, converted to the accumulator A (0
// where ok[u] is false); all K loads issued together.
template <typename S, typename A, int K>
__device__ __forceinline__ void load_as(const void* p, const long long (&i)[K],
                                        const bool (&ok)[K], A (&w)[K]) {
  const S* q = static_cast<const S*>(p);
#pragma unroll
  for (int u = 0; u < K; ++u) w[u] = ok[u] ? A(stored_value(q[i[u]])) : A(0);
}

// load_weight for K weights at once, with one switch on the stored type for
// all of them (the codes as load_weight's); signed integers convert to
// unsigned int modulo 2^32, as sign extension does.
template <int K>
__device__ __forceinline__ void load_weights(const void* p, const long long (&i)[K],
                                             const bool (&ok)[K], int code,
                                             double (&w)[K]) {
  switch (code) {
    case 0: load_as<float>(p, i, ok, w); break;
    case 1: load_as<double>(p, i, ok, w); break;
    case 2: load_as<__half>(p, i, ok, w); break;
    default: load_as<__nv_bfloat16>(p, i, ok, w);
  }
}
template <int K>
__device__ __forceinline__ void load_weights(const void* p, const long long (&i)[K],
                                             const bool (&ok)[K], int code,
                                             unsigned int (&w)[K]) {
  switch (code) {
    case 0: load_as<unsigned int>(p, i, ok, w); break;
    case 1: load_as<short>(p, i, ok, w); break;
    case 2: load_as<unsigned short>(p, i, ok, w); break;
    case 3: load_as<signed char>(p, i, ok, w); break;
    default: load_as<unsigned char>(p, i, ok, w);
  }
}
template <int K>
__device__ __forceinline__ void load_weights(const void* p, const long long (&i)[K],
                                             const bool (&ok)[K], int,
                                             unsigned long long (&w)[K]) {
  load_as<unsigned long long>(p, i, ok, w);
}

}  // namespace xh
