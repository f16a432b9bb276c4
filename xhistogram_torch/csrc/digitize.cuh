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

}  // namespace xh
