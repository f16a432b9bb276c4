// Data read at its own width and widened in registers, shared by the
// histogram kernels.
//
// The TPU kernels widen bfloat16 and 8- and 16-bit integer tiles after the
// load (xhistogram_tpu/ops/pallas_hist.py::_widen), so device memory keeps
// the narrow width; float16 is cast before the call. Here every kernel reads
// bool, int8, uint8, int16, uint16, float16 and bfloat16 data in place and
// widens each value in registers to its compare type, exactly: float32 for
// the 16-bit types (float16, bfloat16, int16, uint16) and, in the kernels
// whose inputs carry a run-time stored type, for float32 data and the 8-bit
// types too; double beside int64 (slot.cuh's mixed instantiation). Integer
// thresholds (bins.compare_form in int32) converted to float32 round only
// past 2^24, beyond every 8- and 16-bit value, so every comparison is kept.
// The mixed entries read any stored type by its load code and hold it in 8
// bytes, int64, uint32 and uint64 as int64 (uint64 flipped, x ^ 2^63) and
// the rest widened to double (gather_mixed).
// 8-bit data (int8, uint8, bool as the bytes 0 and 1) has 256 values: a
// block finds their bins once, by the same search, and each element then
// costs one shared-memory load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "digitize.cuh"

namespace xh {

// An input's stored type, as cuda_hist._LOAD_CODE names it on the host.
enum LoadCode : int {
  kF32 = 0,
  kF64 = 1,
  kI32 = 2,
  kI64 = 3,
  kF16 = 4,
  kBF16 = 5,
  kI16 = 6,
  kU16 = 7,
  kI8 = 8,
  kU8 = 9,  // and bool
  kU32 = 10,
  kU64 = 11,
};
constexpr int kLoadCodes = 12;

// 8-bit data, digitized through a table of its 256 values' bins.
__host__ __device__ constexpr bool is_byte(int code) { return code == kI8 || code == kU8; }

// The stored types the mixed entries hold and compare as int64: int64
// itself, uint32 widened, and uint64 flipped onto int64 (x ^ 2^63, which
// keeps its order) against thresholds flipped alike on the host
// (bins.flip_uint64); every other type as a double.
__host__ __device__ constexpr bool held_int64(int code) {
  return code == kI64 || code == kU32 || code == kU64;
}

// The stored types of the narrow entries: float32 and the narrow types.
__host__ __device__ constexpr bool narrow_code(int code) {
  return code >= 0 && code < kLoadCodes && code != kF64 && code != kI32 &&
         !held_int64(code);
}

// x converted to the compare type C, exactly.
template <typename C, typename L>
__device__ __forceinline__ C widen(L x) {
  return C(x);
}
template <>
__device__ __forceinline__ float widen<float, __half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ double widen<double, __half>(__half x) {
  return (double)__half2float(x);
}
template <>
__device__ __forceinline__ double widen<double, __nv_bfloat16>(__nv_bfloat16 x) {
  return (double)__bfloat162float(x);
}
// uint64 onto int64 in the same order: x ^ 2^63 (bins.flip_uint64), which
// sends 0 to the int64 minimum and 2^64 - 1 to its maximum
template <>
__device__ __forceinline__ long long widen<long long, unsigned long long>(unsigned long long x) {
  return (long long)(x ^ 0x8000000000000000ull);
}

// K neighbouring elements of type L, read by one load of K sizeof(L) bytes
// from an address aligned to that many.
template <typename L, int K>
struct alignas(sizeof(L) * K) Pack {
  L v[K];
};

// The bytes of one element of the stored type `code` names.
__host__ __device__ constexpr int code_bytes(int code) {
  return code == kF64 || code == kI64 || code == kU64   ? 8
         : code == kF32 || code == kI32 || code == kU32 ? 4
         : is_byte(code)                                ? 1
                                                        : 2;
}

// Four neighbouring elements of b bytes each (1, 2 or 4) at p, aligned to
// 4 b bytes, by one load of 4 b bytes: their bits in the low 4 b bytes of
// the result. Nothing here waits for the load: the bits are first read
// where an element is unpacked (four_of, or the weights' weights.cuh), so
// loads issued one after another are in flight together.
__device__ __forceinline__ uint4 load_four(const void* p, int b) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (b == 4) {
    r = *static_cast<const uint4*>(p);
  } else if (b == 2) {
    const uint2 h = *static_cast<const uint2*>(p);
    r.x = h.x;
    r.y = h.y;
  } else {
    r.x = *static_cast<const unsigned*>(p);
  }
  return r;
}

// The bits of element u of four loaded by load_four, of b bytes each.
__device__ __forceinline__ unsigned bits_of(const uint4& r, int u, int b) {
  const unsigned w4 = u == 0 ? r.x : u == 1 ? r.y : u == 2 ? r.z : r.w;
  return b == 4 ? w4
         : b == 2 ? ((u < 2 ? r.x : r.y) >> (16 * (u & 1))) & 0xffffu
                  : (r.x >> (8 * u)) & 0xffu;
}

// v[u]: element u of four loaded by load_four, of the stored type `code`
// (float32 or a narrow type), widened to float exactly, with one switch
// for all four.
__device__ __forceinline__ void four_of(const uint4& r, int code, float (&v)[4]) {
  switch (code) {
    case kF16:
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = __half2float(__ushort_as_half((unsigned short)bits_of(r, u, 2)));
      break;
    case kBF16:  // a bfloat16 is the high half of the float of its value
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __uint_as_float(bits_of(r, u, 2) << 16);
      break;
    case kI16:
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = (float)(short)bits_of(r, u, 2);
      break;
    case kU16:
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = (float)bits_of(r, u, 2);
      break;
    case kI8:
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = (float)(signed char)bits_of(r, u, 1);
      break;
    case kU8:
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = (float)bits_of(r, u, 1);
      break;
    default:
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __uint_as_float(bits_of(r, u, 4));
  }
}

// v[q] for q in [Q0, Q1): element at[q] of p, stored as L, widened to C;
// C(0) where !ok[q]. All the loads are issued before any conversion.
template <typename L, typename C, int K, int Q0, int Q1>
__device__ __forceinline__ void gather(const void* p, const long long (&at)[K],
                                       const bool (&ok)[K], C (&v)[K]) {
  const L* q = static_cast<const L*>(p);
  L raw[K];
#pragma unroll
  for (int u = Q0; u < Q1; ++u) raw[u] = q[ok[u] ? at[u] : 0];
#pragma unroll
  for (int u = Q0; u < Q1; ++u) v[u] = ok[u] ? widen<C>(raw[u]) : C(0);
}

// gather for the stored type `code` names, with one switch for all the
// elements: the code is the same in every lane, so it never diverges. C is
// float (float32 and the narrow types) or double (every type but int64,
// which compares as itself).
template <typename C, int K, int Q0 = 0, int Q1 = K>
__device__ __forceinline__ void gather_coded(const void* p, const long long (&at)[K],
                                             const bool (&ok)[K], int code,
                                             C (&v)[K]) {
  constexpr bool kDouble = std::is_same<C, double>::value;
  switch (code) {
    case kF16: gather<__half, C, K, Q0, Q1>(p, at, ok, v); break;
    case kBF16: gather<__nv_bfloat16, C, K, Q0, Q1>(p, at, ok, v); break;
    case kI16: gather<short, C, K, Q0, Q1>(p, at, ok, v); break;
    case kU16: gather<unsigned short, C, K, Q0, Q1>(p, at, ok, v); break;
    case kI8: gather<signed char, C, K, Q0, Q1>(p, at, ok, v); break;
    case kU8: gather<unsigned char, C, K, Q0, Q1>(p, at, ok, v); break;
    case kF64:
      if constexpr (kDouble) gather<double, C, K, Q0, Q1>(p, at, ok, v);
      break;
    case kI32:
      if constexpr (kDouble) gather<int, C, K, Q0, Q1>(p, at, ok, v);
      break;
    default: gather<float, C, K, Q0, Q1>(p, at, ok, v);
  }
}

// --- the mixed entries: any stored type, held in 8 bytes ---------------------
//
// An input of the mixed entries (joint2's, the flat-slot template's and the
// direct-row kernel's) is read by its run-time load code and held in 8
// bytes: int64 as itself, uint32 widened and uint64 flipped onto int64
// (held_int64), every other type as the bits of its value widened to
// double, exactly. Its thresholds are staged in 8-byte slots the same way
// (int64, or the bits of doubles), so such an input compares in int64 and
// any other in double, each against its own thresholds. Its cell map is
// kept as CellMap<long long>, whose layout CellMap<double> shares.

// v[q] for q in [Q0, Q1): element at[q] of p, of the stored type `code`,
// held in 8 bytes; 0 where !ok[q].
template <int K, int Q0 = 0, int Q1 = K>
__device__ __forceinline__ void gather_mixed(const void* p, const long long (&at)[K],
                                             const bool (&ok)[K], int code,
                                             long long (&v)[K]) {
  if (held_int64(code)) {
    if (code == kU32)
      gather<unsigned int, long long, K, Q0, Q1>(p, at, ok, v);
    else if (code == kU64)
      gather<unsigned long long, long long, K, Q0, Q1>(p, at, ok, v);
    else
      gather<long long, long long, K, Q0, Q1>(p, at, ok, v);
    return;
  }
  double d[K];
  gather_coded<double, K, Q0, Q1>(p, at, ok, code, d);
#pragma unroll
  for (int q = Q0; q < Q1; ++q) v[q] = __double_as_longlong(d[q]);
}

__device__ __forceinline__ CellMap<double> as_double_map(const CellMap<long long>& m) {
  return {m.lo, m.inv, m.k};
}

// The cell map of the nb + 1 thresholds t (skewed, staged) of an input of
// the stored type `code`.
__device__ __forceinline__ CellMap<long long> mixed_cell_map(const long long* t, int nb,
                                                             int k, int code) {
  if (held_int64(code)) return cell_map(t, nb, k);
  const CellMap<double> m = cell_map(reinterpret_cast<const double*>(t), nb, k);
  return {m.lo, m.inv, m.k};
}

// build_cells for an input of the stored type `code`.
__device__ __forceinline__ void mixed_build_cells(const long long* t, int nb,
                                                  const CellMap<long long>& m, int code,
                                                  int2* win, int* widest) {
  if (held_int64(code))
    build_cells(t, nb, m, win, widest);
  else
    build_cells(reinterpret_cast<const double*>(t), nb, as_double_map(m), win, widest);
}

// bin[u]: the bin of x[u], held in 8 bytes, of an input of the stored type
// `code` (not 8-bit: those go through their table), by the bucketed search.
template <int U>
__device__ __forceinline__ void mixed_bins(const long long* t, int nb,
                                           const CellMap<long long>& m, const int2* win,
                                           int step0, int code, const long long (&x)[U],
                                           int (&bin)[U]) {
  if (held_int64(code)) {
    bins_bucketed<long long, U>(t, nb, m, win, step0, x, bin);
    return;
  }
  double d[U];
#pragma unroll
  for (int u = 0; u < U; ++u) d[u] = __longlong_as_double(x[u]);
  bins_bucketed<double, U>(reinterpret_cast<const double*>(t), nb, as_double_map(m), win,
                           step0, d, bin);
}

// The byte of 8-bit data widened to C: its index in the table.
template <typename C>
__device__ __forceinline__ unsigned byte_of(C v) {
  return (unsigned)(int)v & 255u;
}
// ... and of 8-bit data held in 8 bytes (the bits of its double)
__device__ __forceinline__ unsigned held_byte(long long v) {
  return byte_of(__longlong_as_double(v));
}

// lut[b]: the bin (-1 out of range) of the 8-bit value of type L whose
// byte is b, by the bucketed search of the thresholds t (skewed, staged),
// with the threads of the block; the caller synchronises before a read.
template <typename C, typename L>
__device__ void build_byte_table(const C* t, int nb, const CellMap<C>& m,
                                 const int2* win, int step0, int* lut) {
  static_assert(sizeof(L) == 1, "a table of 256 values");
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    const C x[1] = {widen<C>(static_cast<L>(b))};
    int bin[1];
    bins_bucketed<C, 1>(t, nb, m, win, step0, x, bin);
    lut[b] = bin[0];
  }
}

// The same for the 8-bit type `code` names (int8, else uint8 or bool).
template <typename C>
__device__ void build_byte_table(const C* t, int nb, const CellMap<C>& m,
                                 const int2* win, int step0, int code, int* lut) {
  if (code == kI8)
    build_byte_table<C, signed char>(t, nb, m, win, step0, lut);
  else
    build_byte_table<C, unsigned char>(t, nb, m, win, step0, lut);
}

// The table of an 8-bit input of the mixed entries (its thresholds staged
// as the bits of doubles).
__device__ __forceinline__ void mixed_byte_table(const long long* t, int nb,
                                                 const CellMap<long long>& m,
                                                 const int2* win, int step0, int code,
                                                 int* lut) {
  build_byte_table<double>(reinterpret_cast<const double*>(t), nb, as_double_map(m), win,
                           step0, code, lut);
}

// The load type of a joint2 input of the mixed entries: its element held in
// 8 bytes (gather_mixed), of the stored type the input's run-time code names.
struct Held {
  long long bits;
};

// bin[u]: the bin of raw[u], read as L and compared as C against the
// staged thresholds t with cell map m and table win: through the 8-bit
// table lut for 8-bit L, else by the bucketed search of the value widened.
template <typename C, typename L, int U>
__device__ __forceinline__ void bins_loaded(const C* t, int nb, const CellMap<C>& m,
                                            const int2* win, int step0,
                                            const int* lut, const L (&raw)[U],
                                            int (&bin)[U]) {
  if constexpr (sizeof(L) == 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) bin[u] = lut[(unsigned char)raw[u]];
  } else if constexpr (std::is_same<C, L>::value) {
    bins_bucketed<C, U>(t, nb, m, win, step0, raw, bin);
  } else {
    C v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = widen<C>(raw[u]);
    bins_bucketed<C, U>(t, nb, m, win, step0, v, bin);
  }
}

}  // namespace xh
