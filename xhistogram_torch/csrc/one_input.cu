// One-input histogram, full reduction or kept rows, int64 counts or
// weighted sums.
//
// Replaces the TPU kernel xhistogram_tpu/ops/pallas_hist.py::_one_input_kernel
// (driven by _run_one_input). That kernel compares every element with every
// edge and sums the compare rows against a row one-hot on the TPU's matrix
// unit, because the TPU has no fast scatter. Hopper has fast shared-memory
// atomics, so this kernel, like joint2.cu, digitizes each element once by a
// binary search (digitize.cuh) and adds one to a privatised shared-memory
// histogram.
//
// Input: an (m, c) layout of data type T (float, double, int32 or int64)
// with any non-negative strides (sm, sc), read in place; thresholds
// (nb + 1,) of T with nb <= 1024. Output: int64 (1 or m, nb + 1), zeroed by
// the caller; bin b of row r goes to out[r * (nb + 1) + b], and the trailing
// trash slot stays zero.
//
// Weighted (policy xh::Sum<A>, weights.cuh): the TPU kernel multiplies its
// membership rows by weight limbs, with Kahan and NaN/inf channel outputs
// for the precision it promises. Here each counted element adds its weight,
// an (m, c) view with its own strides, read in place, converted at load to
// the accumulator A (float64 for float weights, 32- or 64-bit integers),
// into the same shared histograms, which then hold sizeof(A) bytes a bin;
// the output is of type A.
//
// Work is cut into tiles of R rows by C columns (tile.cuh), walked by each
// block in a grid-stride loop in memory order.
// - Full reduction: one histogram per block, flushed once at the end with
//   64-bit global atomics into out[0].
// - Kept rows: a tile holds R * nb counters, one histogram per row, and is
//   flushed when the block leaves it: plain stores when the tile holds
//   whole rows, atomics when a row is split across column tiles.
// Hot bins (normal data in few bins; a single bin) put every lane's atomic
// on a few counters, so where shared memory allows, each warp adds into its
// own replica of the histogram, and the flush sums the replicas.
//
// What bounds it on an H100: each element reads sizeof(T) bytes, each kept
// row writes 8 (nb + 1) bytes; the per-element work is one binary search of
// about log2(nb + 1) + 1 shared-memory loads plus one shared atomic, and
// that work, not device memory, sets the pace (PERF.md §5). Each thread
// digitizes kUnroll elements side by side (digitize.cuh).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math (digitize.cuh).

#include <cuda_runtime.h>

#include "digitize.cuh"
#include "launch.cuh"
#include "tile.cuh"
#include "weights.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxBins = 1024;
constexpr int kHistBytes = 40 * 1024;  // a block's shared histograms
constexpr long long kMinTile = (long long)kThreads * kUnroll;

using xh::Tiling;

__host__ __device__ constexpr size_t thr_bytes(int nb, size_t elem) {
  return ((size_t)xh::skewed_len(nb + 1) * elem + 15) / 16 * 16;
}

// counters: how many accumulators fit the block's kHistBytes
Tiling make_tiling(long long m, long long c, long long sm, long long sc, int nb,
                   bool reduce_all, long long resident, int counters) {
  const bool row_fast = m > 1 && (c == 1 || sm < sc);
  Tiling tl = xh::make_tiling(m, c, row_fast,
                              reduce_all ? xh::kMaxTile : counters / nb,
                              kMinTile, resident);
  const long long one_copy = (reduce_all ? 1 : tl.rows) * nb;
  const long long copies = counters / one_copy;
  tl.copies = copies < 1 ? 1 : copies > kWarps ? kWarps : (int)copies;
  return tl;
}

// W: xh::Count (adds one) or xh::Sum<A> (adds the weight in w).
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
one_input_kernel(const T* __restrict__ a, long long m, long long c,
                 long long sm, long long sc, const T* __restrict__ thr, int nb,
                 Tiling tl, int reduce_all, const xh::Weights w,
                 typename W::Out* __restrict__ out) {
  using Shared = typename W::Shared;
  using Out = typename W::Out;
  extern __shared__ __align__(16) unsigned char smem[];
  T* t = reinterpret_cast<T*>(smem);
  Shared* hist = reinterpret_cast<Shared*>(smem + thr_bytes(nb, sizeof(T)));
  const int one_copy = (reduce_all ? 1 : (int)tl.rows) * nb;

  xh::stage_thresholds(t, thr, nb + 1);
  for (int s = threadIdx.x; s < one_copy * tl.copies; s += blockDim.x)
    hist[s] = Shared(0);
  __syncthreads();
  Shared* mine = hist + (threadIdx.x / 32) % tl.copies * one_copy;

  const long long n_tiles = tl.row_tiles * tl.col_tiles;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile / tl.col_tiles * tl.rows;
    const long long c0 = tile % tl.col_tiles * tl.cols;
    const unsigned rr = (unsigned)min(tl.rows, m - r0);
    const unsigned cc = (unsigned)min(tl.cols, c - c0);
    const unsigned total = rr * cc;
    // (f, s): a thread's position along the fast and the slow dimension of
    // the tile, advanced by blockDim.x elements a step without a division
    const unsigned fast_n = tl.row_fast ? rr : cc;
    const long long fast_stride = tl.row_fast ? sm : sc;
    const long long slow_stride = tl.row_fast ? sc : sm;
    const unsigned df = blockDim.x % fast_n;
    const unsigned ds = blockDim.x / fast_n;
    unsigned f = threadIdx.x % fast_n;
    unsigned s = threadIdx.x / fast_n;
    const T* base = a + r0 * sm + c0 * sc;
    const long long w_fast = tl.row_fast ? w.sm : w.sc;
    const long long w_slow = tl.row_fast ? w.sc : w.sm;
    const long long w_base = r0 * w.sm + c0 * w.sc;

    for (unsigned k = threadIdx.x; k < total; k += kUnroll * blockDim.x) {
      T v[kUnroll];
      unsigned row[kUnroll];
      bool ok[kUnroll];
      Shared wt[kUnroll];  // each element's weight
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ok[u] = k + u * blockDim.x < total;
        v[u] = ok[u] ? base[f * fast_stride + s * slow_stride] : T(0);
        if constexpr (W::kWeighted) {
          wt[u] = Shared(0);
          if (ok[u])
            xh::load_weight(w.data, w_base + f * w_fast + s * w_slow, w.code,
                            wt[u]);
        }
        row[u] = tl.row_fast ? f : s;
        f += df;
        s += ds;
        if (f >= fast_n) {
          f -= fast_n;
          ++s;
        }
      }
      int bin[kUnroll];  // -1: NaN or out of range
      xh::bins_of(t, nb, v, bin);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u] && bin[u] >= 0) {
          Shared* slot = &mine[(reduce_all ? 0u : row[u]) * nb + bin[u]];
          if constexpr (W::kWeighted)
            atomicAdd(slot, wt[u]);
          else
            atomicAdd(slot, 1u);
        }
      }
    }

    if (!reduce_all) {
      __syncthreads();
      for (unsigned sl = threadIdx.x; sl < rr * nb; sl += blockDim.x) {
        Out v = 0;
        for (int cp = 0; cp < tl.copies; ++cp) {
          v += hist[cp * one_copy + sl];
          hist[cp * one_copy + sl] = Shared(0);
        }
        const unsigned r = sl / nb;
        Out* dst = out + (r0 + r) * (nb + 1) + (sl - r * nb);
        if (tl.col_tiles == 1)
          *dst = v;  // the block owns these whole rows
        else if (v != Out(0))  // NaN != 0: a NaN sum is added
          atomicAdd(dst, v);
      }
      __syncthreads();
    }
  }

  if (reduce_all) {
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      Out v = 0;
      for (int cp = 0; cp < tl.copies; ++cp) v += hist[cp * one_copy + b];
      if (v != Out(0)) atomicAdd(&out[b], v);
    }
  }
}

template <typename T, typename W>
int launch_one_input(const void* a, long long m, long long c, long long sm,
                     long long sc, const void* thr, int nb, int reduce_all,
                     const xh::Weights& w, void* out, void* stream) {
  if (m <= 0 || c <= 0 || sm < 0 || sc < 0 || nb < 1 || nb > kMaxBins ||
      w.sm < 0 || w.sc < 0)
    return (int)cudaErrorInvalidValue;
  const int counters = kHistBytes / (int)sizeof(typename W::Shared);

  // occupancy at the most shared memory any call of this type asks for, so
  // the cached launch shape serves every bin count
  const size_t smem_most = thr_bytes(kMaxBins, sizeof(T)) + kHistBytes;
  static xh::LaunchShape shape;
  int sms = 0;
  int per_sm = 0;
  const cudaError_t err = shape.get((const void*)one_input_kernel<T, W>,
                                    kThreads, smem_most, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * per_sm;

  const Tiling tl =
      make_tiling(m, c, sm, sc, nb, reduce_all != 0, resident, counters);
  const long long n_tiles = tl.row_tiles * tl.col_tiles;
  const long long grid = n_tiles < resident ? n_tiles : resident;
  // a block's shared counters are 32-bit: bound the elements one block
  // visits before it flushes (a full reduction flushes only at the end);
  // weighted sums wrap or round by their own type's rules instead
  const long long visits = reduce_all ? xh::ceil_div(n_tiles, grid) : 1;
  if (!W::kWeighted && visits * tl.rows * tl.cols > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;

  const size_t smem = thr_bytes(nb, sizeof(T)) +
                      sizeof(typename W::Shared) * (size_t)tl.copies *
                          (reduce_all ? 1 : tl.rows) * nb;
  one_input_kernel<T, W><<<(unsigned int)grid, kThreads, smem,
                           (cudaStream_t)stream>>>(
      static_cast<const T*>(a), m, c, sm, sc, static_cast<const T*>(thr), nb,
      tl, reduce_all, w, static_cast<typename W::Out*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Adds the counts of the (m, c) layout a (strides sm, sc in elements) into
// out, which the caller zeroes: (1, nb + 1) when reduce_all, else
// (m, nb + 1). Data and thresholds are of the type the suffix names.
// Launches on `stream` and returns cudaGetLastError() (or the first failing
// CUDA call's error); never synchronises.
#define XH_ONE_INPUT(name, T)                                                 \
  extern "C" int name(const void* a, long long m, long long c, long long sm, \
                      long long sc, const void* thr, int nb, int reduce_all, \
                      void* out, void* stream) {                             \
    return launch_one_input<T, xh::Count>(a, m, c, sm, sc, thr, nb,          \
                                          reduce_all, xh::Weights{}, out,    \
                                          stream);                           \
  }

// Weighted: adds the sums of the weights w (an (m, c) view with strides
// wsm, wsc, of the type `wcode` names within accumulator class A;
// weights.cuh) into out, of type A, which the caller zeroes.
#define XH_ONE_INPUT_WEIGHTED(name, T, A)                                     \
  extern "C" int name(const void* a, long long m, long long c, long long sm, \
                      long long sc, const void* thr, int nb, int reduce_all, \
                      const void* w, long long wsm, long long wsc,           \
                      int wcode, void* out, void* stream) {                  \
    return launch_one_input<T, xh::Sum<A>>(                                  \
        a, m, c, sm, sc, thr, nb, reduce_all,                                \
        xh::Weights{w, wsm, wsc, wcode}, out, stream);                       \
  }

XH_ONE_INPUT(xh_one_input_f32, float)
XH_ONE_INPUT(xh_one_input_f64, double)
XH_ONE_INPUT(xh_one_input_i32, int)
XH_ONE_INPUT(xh_one_input_i64, long long)

// The weighted entries xh_one_input_<data>_<cls> of the accumulator
// class cls (accumulator type A), for the four data types.
#define XH_ONE_INPUT_WEIGHTED_CLASS(cls, A)                                   \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_f32_##cls, float, A)                     \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_f64_##cls, double, A)                    \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_i32_##cls, int, A)                       \
  XH_ONE_INPUT_WEIGHTED(xh_one_input_i64_##cls, long long, A)

XH_ONE_INPUT_WEIGHTED_CLASS(wf64, double)
XH_ONE_INPUT_WEIGHTED_CLASS(wu32, unsigned int)
XH_ONE_INPUT_WEIGHTED_CLASS(wu64, unsigned long long)
