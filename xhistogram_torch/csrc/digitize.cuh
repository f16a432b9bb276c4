// Digitize against compare-form thresholds, shared by the histogram kernels.
//
// The thresholds are xhistogram_torch.bins.compare_form(edges, T).edges:
// nb + 1 non-decreasing values in the data's own type T, half-open bins with
// the closed last bin already folded in. A value x lands in bin i - 1, where
//   i = #{t in thr : t <= x}   (std::upper_bound),
// and counts iff it is not NaN and 1 <= i <= nb. That is numpy's
// searchsorted(side="right") of the plain path (ops/digitize.py) with its
// out-of-range trim. T is float, double, int or long long; the comparisons
// are exact in T, so the kernels must be built without fast-math (subnormal
// data compares exactly against a 0.0 threshold, no flush to zero).
//
// The search is branch-free with a trip count that depends on nb only, so
// the lanes of a warp never diverge and one thread runs the searches of K
// elements side by side. Its probes step by halves of the threshold count;
// at a power-of-two count (1024 bins) a warp's probes at one step would all
// fall in one or two shared-memory banks, so the thresholds are stored
// skewed, one padding slot after every 32 (skew()). A kernel whose
// thresholds do not fit in shared memory searches them in place in device
// memory, unskewed (kSkewed = false).
//
// Where the thresholds are staged, joint2 and the flat-slot template search
// by buckets instead (bins_bucketed): a monotone arithmetic map sends x to
// one of k cells, a table built in the block's prologue gives the window of
// thresholds that can lie in that cell, and a branch-free search of at most
// L (the widest window) thresholds finishes the count. It is exact for any
// non-decreasing thresholds; see cell_map.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace xh {

// Shared-memory slot of threshold k.
__host__ __device__ constexpr int skew(int k) { return k + (k >> 5); }

// Slots that n skewed thresholds take.
__host__ __device__ constexpr int skewed_len(int n) { return skew(n - 1) + 1; }

// Copies the n thresholds of src into dst at their skewed slots, with the
// threads of the block; the caller synchronises before the first search.
template <typename T>
__device__ __forceinline__ void stage_thresholds(T* dst, const T* src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[skew(k)] = src[k];
}

// bin[k]: the 0-based bin of x[k] against the nb + 1 thresholds t (skewed
// unless kSkewed is false), or -1 when x[k] is NaN or outside
// [t[0], t[nb]).
template <typename T, int K, bool kSkewed = true>
__device__ __forceinline__ void bins_of(const T* t, int nb, const T (&x)[K],
                                        int (&bin)[K]) {
  auto at = [t](int i) { return t[kSkewed ? skew(i) : i]; };
  // lo[k] <= #{t <= x[k]} <= lo[k] + len, narrowed to len == 1
  int lo[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lo[k] = 0;
  for (int len = nb + 1; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < K; ++k)
      lo[k] = at(lo[k] + half) <= x[k] ? lo[k] + half : lo[k];
    len -= half;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lo[k] + (at(lo[k]) <= x[k] ? 1 : 0) - 1;
    bool nan = false;
    if constexpr (std::is_floating_point<T>::value) nan = isnan(x[k]);
    bin[k] = (!nan && i >= 0 && i < nb) ? i : -1;
  }
}

// --- the bucketed search ----------------------------------------------------

// Cells of a table at most (about two a bin): 32 KB of int2 windows.
constexpr int kMaxCells = 4096;

// The cell map's arithmetic type: float for float data, double for double,
// int32 and int64 data (ops/digitize.py's cell_map mirrors all of it).
template <typename T>
using CellReal =
    typename std::conditional<std::is_same<T, float>::value, float, double>::type;

__device__ __forceinline__ float real_of(float x) { return x; }
__device__ __forceinline__ double real_of(double x) { return x; }
__device__ __forceinline__ double real_of(int x) { return __int2double_rn(x); }
__device__ __forceinline__ double real_of(long long x) {
  return __ll2double_rn(x);
}
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float floor_of(float a) { return floorf(a); }
__device__ __forceinline__ double floor_of(double a) { return floor(a); }
__device__ __forceinline__ float clamp_of(float a, float hi) {
  return fminf(fmaxf(a, 0.0f), hi);  // fmaxf(NaN, 0) is 0
}
__device__ __forceinline__ double clamp_of(double a, double hi) {
  return fmin(fmax(a, 0.0), hi);
}

// cell(x) = clamp(floor((x - lo) * inv), 0, k - 1), every step rounded to
// nearest and never contracted, so each step, and the map, is monotone
// non-decreasing in x. Hence t <= x implies cell(t) <= cell(x), and
//   #{t_i <= x} = first[cell(x)] + #{i in cell(x)'s window : t_i <= x},
//   first[c] = #{i : cell(t_i) < c},
// for any non-decreasing thresholds (uneven, repeated, +-0, subnormal, far
// from zero). Where t_nb - t_0 or k / (t_nb - t_0) is not finite and
// positive, k is 1 (lo = inv = 0): one window, the plain binary search.
template <typename T>
struct CellMap {
  CellReal<T> lo;
  CellReal<T> inv;
  int k;
};

// The map of the nb + 1 thresholds t (skewed) onto at most k_max cells.
template <typename T>
__device__ __forceinline__ CellMap<T> cell_map(const T* t, int nb, int k_max) {
  using R = CellReal<T>;
  const R lo = real_of(t[skew(0)]);
  const R span = sub_rn(real_of(t[skew(nb)]), lo);
  const R inv = div_rn(R(k_max), span);
  if (k_max > 1 && span > R(0) && isfinite(span) && inv > R(0) && isfinite(inv))
    return {lo, inv, k_max};
  return {R(0), R(0), 1};
}

template <typename T>
__device__ __forceinline__ int cell_of(const CellMap<T>& m, T x) {
  using R = CellReal<T>;
  return (int)clamp_of(floor_of(mul_rn(sub_rn(real_of(x), m.lo), m.inv)),
                       R(m.k - 1));
}

// Builds win[c] = (first[c], first[c + 1]) for the m.k cells of the nb + 1
// thresholds t (skewed, staged and synchronised), and sets *widest to the
// widest window, L, with the whole block; ends synchronised.
template <typename T>
__device__ void build_cells(const T* t, int nb, const CellMap<T>& m, int2* win,
                            int* widest) {
  if (threadIdx.x == 0) *widest = 0;
  for (int c = threadIdx.x; c <= m.k; c += blockDim.x) {
    // first[c]: the least i with cell(t_i) >= c (cells rise with i)
    int lo = 0;
    for (int len = nb + 1; len > 0;) {
      const int half = len >> 1;
      if (cell_of(m, t[skew(lo + half)]) < c) {
        lo += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    if (c < m.k) win[c].x = lo;
    if (c > 0) win[c - 1].y = lo;
  }
  __syncthreads();
  int w = 0;
  for (int c = threadIdx.x; c < m.k; c += blockDim.x)
    w = max(w, win[c].y - win[c].x);
  for (int o = 16; o > 0; o >>= 1) w = max(w, __shfl_xor_sync(0xffffffffu, w, o));
  if ((threadIdx.x & 31) == 0) atomicMax(widest, w);
  __syncthreads();
}

// The highest power of two <= L: the first step of the window search.
__device__ __forceinline__ int first_step(int widest) {
  return widest > 0 ? 1 << (31 - __clz(widest)) : 0;
}

// bin[u]: as bins_of, by the cell table: one table load and
// log2(step) + 1 threshold compares, a trip count the same in every lane.
template <typename T, int U>
__device__ __forceinline__ void bins_bucketed(const T* t, int nb,
                                              const CellMap<T>& m,
                                              const int2* win, int step0,
                                              const T (&x)[U], int (&bin)[U]) {
  int lo[U];
  int w[U];
  int pos[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int2 e = win[cell_of(m, x[u])];
    lo[u] = e.x;
    w[u] = e.y - e.x;
    pos[u] = 0;
  }
  // pos[u]: the thresholds of the window known to be <= x[u]; a probe past
  // the window reads a valid slot and is not taken
  for (int step = step0; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = pos[u] + step - 1;
      const bool take = (j < w[u]) & (t[skew(min(lo[u] + j, nb))] <= x[u]);
      pos[u] += take ? step : 0;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = lo[u] + pos[u] - 1;
    bool nan = false;
    if constexpr (std::is_floating_point<T>::value) nan = isnan(x[u]);
    bin[u] = (!nan && i >= 0 && i < nb) ? i : -1;
  }
}

// The bytes of a table of k cells.
__host__ __device__ constexpr size_t cells_bytes(int k) {
  return sizeof(int2) * (size_t)k;
}

}  // namespace xh
