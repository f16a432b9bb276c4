// N-input flat-slot histogram, full reduction or kept rows: int64 counts,
// or weighted sums (weights.cuh).
//
// The one template behind factored.cu (routes factored, factored_per_row,
// factored_packed) and direct.cu (route direct). Each input k is an (m, c)
// view of data type T with its own non-negative strides, read in place
// (a broadcast input has stride 0), and its own nb_k + 1 compare-form
// thresholds (digitize.cuh). An element counts iff no input's value is NaN
// or out of range, and then adds one to its flat slot
//   g = ((t_0 * nb_1 + t_1) * nb_2 + ...) + t_{n-1},  t_k its bin on input k,
// computed in 64 bits (a forced call may have 2^31 slots or more). Output:
// int64 (1 or m, S + 1) with S = prod(nb_k); slot S is the trash slot and
// stays zero. A weighted instantiation (policy xh::Sum<A>) adds the
// element's weight, an (m, c) view with its own strides, in place of one,
// into accumulators and an output of type A (weights.cuh); its shared
// histograms take sizeof(A) bytes a slot, so float64 and 64-bit integer
// sums keep half as many slots in shared memory as the 32-bit counters.
//
// Each element is digitized once per input by the binary search of
// digitize.cuh and counted with an atomic. Where the slots go:
// - shared histograms (S <= max_shared_slots and they fit beside the
//   thresholds): one histogram per row of the tile (tile.cuh), or, for a
//   full reduction, one per block in up to 16 warp-private replicas
//   against hot bins; 32-bit counters, flushed into the int64 output. A
//   tile of whole kept rows stores every slot of its rows, zeros and the
//   trash slot included, so the output needs no zeroing pass; a row split
//   over column tiles, and a full reduction, add with 64-bit atomics into
//   an output the launcher zeroes first.
// - global histogram (more slots than that): every element adds one with a
//   64-bit atomic straight into the zeroed int64 output, which stays in
//   the card's 50 MB L2 cache up to about six million slots.
// The thresholds of all inputs are staged in shared memory when they fit
// (227 KB a block); otherwise each search reads them in device memory.
// The input count is read at run time, except for two inputs, the common
// case, which get kernels of their own with both inputs' loads and
// searches unrolled.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, without
// --use_fast_math (digitize.cuh).

#pragma once

#include <cuda_runtime.h>

#include "digitize.cuh"
#include "launch.cuh"
#include "tile.cuh"
#include "weights.cuh"

// Each including file gets its own copy of the kernels and launch caches.
namespace {
namespace slot {

constexpr int kMaxInputs = 32;
constexpr int kThreads = 512;
// two resident blocks an SM at the least: caps registers at 64 a thread
constexpr int kMinBlocks = 2;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr long long kMinTile = (long long)kThreads * kUnroll;
// shared histogram bytes a block aims for (48 KB): several kept rows a
// tile, or warp replicas of a full reduction
constexpr long long kHistBytes = 48 * 1024;

template <typename T>
struct Input {
  const T* data;  // element (r, j) at data[r * sm + j * sc]
  const T* thr;   // nb + 1 thresholds in device memory
  long long sm;
  long long sc;
  int nb;
  int soff;  // slot of its first threshold in shared memory (skewed)
};

template <typename T>
struct Inputs {
  Input<T> in[kMaxInputs];
  int n;
};

// 227 KB a block, less the kernel's static copy of the input table
template <typename T>
constexpr size_t kSmemMax = 232448 - sizeof(Input<T>) * kMaxInputs;

struct Mode {
  size_t thr_bytes;  // staged thresholds' shared bytes; 0: searched in place
  int reduce_all;
  int whole_rows;  // each tile holds whole rows and stores all their slots
};

// g[u]: the flat slot of element u, at offset f[u] along the fast and s[u]
// along the slow dimension from the tile's corner (r0, c0), or -1 where
// ok[u] is false or any input's value is NaN or out of range. t: every
// input's thresholds staged (skewed) in shared memory when `staged`, else
// each input's are searched in device memory. kN: the input count n when
// it is known at compile time (0: read n at run time).
template <typename T, int K, int kN>
__device__ __forceinline__ void flat_slots(const Input<T>* in, int n,
                                           const T* t, bool staged, long long r0,
                                           long long c0, bool row_fast,
                                           const unsigned (&f)[K],
                                           const unsigned (&s)[K],
                                           const bool (&ok)[K],
                                           long long (&g)[K]) {
  bool valid[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    g[u] = 0;
    valid[u] = ok[u];
  }
#pragma unroll
  for (int i = 0; i < (kN ? kN : n); ++i) {
    const Input<T> d = in[i];
    const long long fast = row_fast ? d.sm : d.sc;
    const long long slow = row_fast ? d.sc : d.sm;
    const T* base = d.data + r0 * d.sm + c0 * d.sc;
    T v[K];
#pragma unroll
    for (int u = 0; u < K; ++u)
      v[u] = ok[u] ? base[f[u] * fast + s[u] * slow] : T(0);
    int bin[K];
    if (staged)
      xh::bins_of<T, K, true>(t + d.soff, d.nb, v, bin);
    else
      xh::bins_of<T, K, false>(d.thr, d.nb, v, bin);
#pragma unroll
    for (int u = 0; u < K; ++u) {
      valid[u] = valid[u] && bin[u] >= 0;
      g[u] = g[u] * d.nb + (bin[u] > 0 ? bin[u] : 0);
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u)
    if (!valid[u]) g[u] = -1;
}

// W: xh::Count (adds one) or xh::Sum<A> (adds the weight in w).
template <typename T, typename W, bool kShared, int kN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
slot_hist_kernel(const Inputs<T> p, const xh::Weights w, long long m,
                 long long c, long long S, xh::Tiling tl, Mode md,
                 typename W::Out* __restrict__ out) {
  using Shared = typename W::Shared;
  using Out = typename W::Out;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Input<T> in[kMaxInputs];
  const int n = p.n;
#pragma unroll
  for (int k = 0; k < kMaxInputs; ++k)  // static indices: no local copy of p
    if (threadIdx.x == k && k < n) in[k] = p.in[k];
  __syncthreads();

  // t always points into shared memory, so the searches load from it with
  // shared-memory instructions rather than generic ones
  T* t = reinterpret_cast<T*>(smem);
  const bool staged = md.thr_bytes != 0;
  if (staged)
    for (int i = 0; i < n; ++i)
      xh::stage_thresholds(t + in[i].soff, in[i].thr, in[i].nb + 1);
  Shared* hist = reinterpret_cast<Shared*>(smem + md.thr_bytes);
  const long long one_copy = (md.reduce_all ? 1 : tl.rows) * S;
  if (kShared)
    for (long long k = threadIdx.x; k < one_copy * tl.copies; k += blockDim.x)
      hist[k] = Shared(0);
  __syncthreads();
  Shared* mine = hist + (threadIdx.x / 32) % tl.copies * one_copy;
  const long long out_row = S + 1;

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
    const unsigned df = blockDim.x % fast_n;
    const unsigned ds = blockDim.x / fast_n;
    unsigned f = threadIdx.x % fast_n;
    unsigned s = threadIdx.x / fast_n;

    for (unsigned k = threadIdx.x; k < total; k += kUnroll * blockDim.x) {
      unsigned fs[kUnroll];
      unsigned ss[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ok[u] = k + u * blockDim.x < total;
        fs[u] = f;
        ss[u] = s;
        f += df;
        s += ds;
        if (f >= fast_n) {
          f -= fast_n;
          ++s;
        }
      }
      long long g[kUnroll];
      flat_slots<T, kUnroll, kN>(in, n, t, staged, r0, c0, tl.row_fast, fs, ss,
                                 ok, g);
      Shared wt[kUnroll];  // each counted element's weight
      if constexpr (W::kWeighted) {
        const long long fast = tl.row_fast ? w.sm : w.sc;
        const long long slow = tl.row_fast ? w.sc : w.sm;
        const long long base = r0 * w.sm + c0 * w.sc;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          wt[u] = Shared(0);
          if (g[u] >= 0)
            xh::load_weight(w.data, base + fs[u] * fast + ss[u] * slow, w.code,
                            wt[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (g[u] < 0) continue;
        const long long row = md.reduce_all ? 0 : (tl.row_fast ? fs[u] : ss[u]);
        if constexpr (W::kWeighted) {
          if (kShared)
            atomicAdd(&mine[row * S + g[u]], wt[u]);
          else
            atomicAdd(&out[(md.reduce_all ? 0 : r0 + row) * out_row + g[u]],
                      wt[u]);
        } else {
          if (kShared)
            atomicAdd(&mine[row * S + g[u]], 1u);
          else
            atomicAdd(&out[(md.reduce_all ? 0 : r0 + row) * out_row + g[u]],
                      1ull);
        }
      }
    }

    if (kShared && !md.reduce_all) {
      __syncthreads();
      for (unsigned r = 0; r < rr; ++r) {
        Out* dst = out + (r0 + r) * out_row;
        for (long long sl = threadIdx.x; sl <= S; sl += blockDim.x) {
          Out v = 0;  // sl == S: the trash slot, zero
          if (sl < S)
            for (int cp = 0; cp < tl.copies; ++cp) {
              Shared* h = hist + cp * one_copy + r * S + sl;
              v += *h;
              *h = Shared(0);
            }
          if (md.whole_rows)
            dst[sl] = v;
          else if (v != Out(0))  // NaN != 0: a NaN sum is added
            atomicAdd(&dst[sl], v);
        }
      }
      __syncthreads();
    }
  }

  if (kShared && md.reduce_all) {
    __syncthreads();
    for (long long sl = threadIdx.x; sl < S; sl += blockDim.x) {
      Out v = 0;
      for (int cp = 0; cp < tl.copies; ++cp) v += hist[cp * one_copy + sl];
      if (v != Out(0)) atomicAdd(&out[sl], v);
    }
  }
}

template <typename T, typename W, bool kShared, int kN>
int launch_kernel(const Inputs<T>& p, const xh::Weights& w, long long m,
                  long long c, long long S, long long most_counters,
                  bool row_fast, Mode md, void* out, cudaStream_t stream) {
  using Shared = typename W::Shared;
  using Out = typename W::Out;
  static xh::LaunchShape shape;
  const size_t smem_most =
      md.thr_bytes + sizeof(Shared) * (size_t)most_counters;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err =
      shape.get((const void*)slot_hist_kernel<T, W, kShared, kN>, kThreads,
                smem_most, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * per_sm;

  const long long max_rows =
      kShared && !md.reduce_all ? most_counters / S : xh::kMaxTile;
  xh::Tiling tl = xh::make_tiling(m, c, row_fast, max_rows > 0 ? max_rows : 1,
                                  kMinTile, resident);
  size_t smem = md.thr_bytes;
  if (kShared) {
    const long long one_copy = (md.reduce_all ? 1 : tl.rows) * S;
    const long long copies = most_counters / one_copy;
    tl.copies = copies < 1 ? 1 : copies > kWarps ? kWarps : (int)copies;
    smem += sizeof(Shared) * (size_t)(tl.copies * one_copy);
  }
  const long long n_tiles = tl.row_tiles * tl.col_tiles;
  const long long grid = n_tiles < resident ? n_tiles : resident;
  // a block's shared counters are 32-bit: bound the elements one block
  // counts before it flushes (a full reduction flushes only at the end);
  // weighted sums wrap or round by their own type's rules instead
  const long long visits = md.reduce_all ? xh::ceil_div(n_tiles, grid) : 1;
  if (!W::kWeighted && kShared && visits * tl.rows * tl.cols > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;

  md.whole_rows = kShared && !md.reduce_all && tl.col_tiles == 1;
  if (!md.whole_rows) {
    const long long rows_out = md.reduce_all ? 1 : m;
    err = cudaMemsetAsync(out, 0, sizeof(Out) * rows_out * (S + 1), stream);
    if (err != cudaSuccess) return (int)err;
  }
  slot_hist_kernel<T, W, kShared, kN><<<(unsigned int)grid, kThreads, smem,
                                        stream>>>(p, w, m, c, S, tl, md,
                                                  static_cast<Out*>(out));
  return (int)cudaGetLastError();
}

// The C entries' common body: counts (W = xh::Count) or weighted sums
// (W = xh::Sum<A>, weights w) of the n inputs' (m, c) layouts into out,
// (1 if reduce_all else m, S + 1) of W::Out, which needs no zeroing.
// data[k], thr[k]: device pointers of type T; strides[2k], strides[2k + 1]:
// input k's (sm, sc) in elements; nb[k] its bin count. Histograms of at
// most max_shared_slots slots a row are kept in shared memory where they
// fit. Launches on `stream` and returns cudaGetLastError() (or the first
// failing CUDA call's error); never synchronises.
template <typename T, typename W>
int launch_slot_hist(int n, const void* const* data, const long long* strides,
                     const void* const* thr, const int* nb, long long m,
                     long long c, int reduce_all, long long max_shared_slots,
                     const xh::Weights& w, void* out, void* stream) {
  if (n < 1 || n > kMaxInputs || m <= 0 || c <= 0 || w.sm < 0 || w.sc < 0)
    return (int)cudaErrorInvalidValue;
  Inputs<T> p = {};
  p.n = n;
  long long S = 1;
  size_t thr_slots = 0;
  int row_cost = 0;  // inputs a rows-first walk reads with a stride > 1
  int col_cost = 0;
  for (int k = 0; k < n; ++k) {
    Input<T>& d = p.in[k];
    d.data = static_cast<const T*>(data[k]);
    d.thr = static_cast<const T*>(thr[k]);
    d.sm = strides[2 * k];
    d.sc = strides[2 * k + 1];
    d.nb = nb[k];
    if (d.nb < 1 || d.sm < 0 || d.sc < 0 || S > (1LL << 62) / d.nb)
      return (int)cudaErrorInvalidValue;
    S *= d.nb;
    // read only when the thresholds are staged, and then below 2^16
    d.soff = thr_slots < (1u << 30) ? (int)thr_slots : 0;
    thr_slots += xh::skewed_len(d.nb + 1);
    row_cost += d.sm > 1;
    col_cost += d.sc > 1;
  }
  row_cost += w.sm > 1;  // the weights' view (all zero when unweighted)
  col_cost += w.sc > 1;
  const bool row_fast = m > 1 && (c == 1 || row_cost < col_cost);

  Mode md = {};
  md.reduce_all = reduce_all != 0;
  const size_t thr_bytes = (thr_slots * sizeof(T) + 15) / 16 * 16;
  const size_t budget = kSmemMax<T>;
  md.thr_bytes = thr_bytes <= budget ? thr_bytes : 0;
  const size_t room = (budget - md.thr_bytes) / sizeof(typename W::Shared);
  const long long target = kHistBytes / (long long)sizeof(typename W::Shared);
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= max_shared_slots && (size_t)S <= room) {
    long long most = S > target ? S : target;
    if ((size_t)most > room) most = (long long)room;
    if (n == 2)
      return launch_kernel<T, W, true, 2>(p, w, m, c, S, most, row_fast, md,
                                          out, st);
    return launch_kernel<T, W, true, 0>(p, w, m, c, S, most, row_fast, md,
                                        out, st);
  }
  if (n == 2)
    return launch_kernel<T, W, false, 2>(p, w, m, c, S, 0, row_fast, md, out,
                                         st);
  return launch_kernel<T, W, false, 0>(p, w, m, c, S, 0, row_fast, md, out,
                                       st);
}

}  // namespace slot
}  // namespace

// The C entry of one route: counts into out; see launch_slot_hist.
#define XH_SLOT_ENTRY(name, T, reduce_all)                                    \
  extern "C" int name(int n, const void* const* data,                        \
                      const long long* strides, const void* const* thr,      \
                      const int* nb, long long m, long long c,               \
                      long long max_shared_slots, void* out, void* stream) { \
    return slot::launch_slot_hist<T, xh::Count>(                             \
        n, data, strides, thr, nb, m, c, reduce_all, max_shared_slots,       \
        xh::Weights{}, out, stream);                                         \
  }

// The weighted C entry of one route: sums of the weights w (an (m, c) view
// with strides wsm, wsc, of the type `wcode` names within accumulator
// class A; weights.cuh) into out, of type A; see launch_slot_hist.
#define XH_SLOT_WEIGHTED_ENTRY(name, T, A, reduce_all)                        \
  extern "C" int name(int n, const void* const* data,                        \
                      const long long* strides, const void* const* thr,      \
                      const int* nb, long long m, long long c,               \
                      long long max_shared_slots, const void* w,             \
                      long long wsm, long long wsc, int wcode, void* out,    \
                      void* stream) {                                        \
    return slot::launch_slot_hist<T, xh::Sum<A>>(                            \
        n, data, strides, thr, nb, m, c, reduce_all, max_shared_slots,       \
        xh::Weights{w, wsm, wsc, wcode}, out, stream);                       \
  }

// Every route's weighted entries xh_<route>_<data>_<cls> of the
// accumulator class cls (accumulator type A), for the four data types.
#define XH_SLOT_WEIGHTED_CLASS(cls, A)                                        \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_full_f32_##cls, float, A, 1)             \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_full_f64_##cls, double, A, 1)            \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_full_i32_##cls, int, A, 1)               \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_full_i64_##cls, long long, A, 1)         \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_per_row_f32_##cls, float, A, 0)          \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_per_row_f64_##cls, double, A, 0)         \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_per_row_i32_##cls, int, A, 0)            \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_per_row_i64_##cls, long long, A, 0)      \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_packed_f32_##cls, float, A, 0)           \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_packed_f64_##cls, double, A, 0)          \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_packed_i32_##cls, int, A, 0)             \
  XH_SLOT_WEIGHTED_ENTRY(xh_factored_packed_i64_##cls, long long, A, 0)       \
  XH_SLOT_WEIGHTED_ENTRY(xh_direct_f32_##cls, float, A, 0)                    \
  XH_SLOT_WEIGHTED_ENTRY(xh_direct_f64_##cls, double, A, 0)                   \
  XH_SLOT_WEIGHTED_ENTRY(xh_direct_i32_##cls, int, A, 0)                      \
  XH_SLOT_WEIGHTED_ENTRY(xh_direct_i64_##cls, long long, A, 0)
