// One-input histogram, full reduction or kept rows, int64 counts or
// weighted sums.
//
// Replaces the TPU kernel xhistogram_tpu/ops/pallas_hist.py::_one_input_kernel
// (driven by _run_one_input). That kernel compares every element with every
// edge and sums the compare rows against a row one-hot on the TPU's matrix
// unit, because the TPU has no fast scatter; narrow tiles are widened in
// registers after the load, since Mosaic compares nothing below 32 bits
// (float16 is cast before the call). Here each element is
// digitized once and counted once, in shared memory.
//
// Input: an (m1, m0, c1, c0) view of load type L (kept rows r = i1 * m0 +
// i0, columns j = j1 * c0 + j0; tile.cuh) with any non-negative strides
// (sm1, sm, sc1, sc), read in place at its own width (bool and 8- and
// 16-bit integers, float16, bfloat16, uint32 and uint64 included) and
// widened in registers to the compare type C: int32 for 8-bit integers and
// bool, float32 for 16-bit integers, float16 and bfloat16, int64 for uint32
// and for uint64 flipped onto it (x ^ 2^63, narrow.cuh), else L itself
// (float, double, int32, int64). Thresholds (nb + 1,) of C with nb <= 1024
// (xhistogram_torch.bins.compare_form in C, or its int32 thresholds
// converted to float32 for 16-bit integers, which keeps every comparison
// of a 16-bit value). Output:
// int64 (1 or m1 m0, nb + 1); bin b of row r goes to out[r * (nb + 1) + b],
// and the trailing trash slot is zero. A block that owns whole kept rows
// stores every slot of them, zeros and the trash slot included, so the
// output needs no zeroing pass; the launcher zeroes it first only where
// blocks add into it instead (a full reduction, rows split across column
// tiles).
//
// Weighted (policy xh::Sum<A>, weights.cuh): each counted element adds its
// weight, a view with its own strides, read in place and converted
// at load to the accumulator A (float64 for float weights, 32- or 64-bit
// integers), in place of one; the output is of type A.
//
// What bounds it on an H100: each element reads sizeof(L) bytes (and its
// weight's), each kept row writes 8 (nb + 1) bytes, so device memory at
// 3.35 TB/s; the per-element work is what keeps a kernel from that bound.
// What the design does about it:
// - Digitize: the bucketed search of digitize.cuh (a monotone cell map, a
//   cell table of 2 nb cells built in each block's prologue, then a
//   branch-free search of the widest window L): for 50 or 64 evenly spaced
//   bins L = 1, one table load and one threshold compare with no search
//   loop (bins_window1; for float data the prologue writes the threshold
//   into the table, bins_float_window1), where a binary search made six or
//   seven dependent shared-memory loads. 8-bit data (int8, uint8, bool)
//   has 256 values: each block finds their bins once, by the same search,
//   and each element then costs one shared-memory load.
// - Counters that do not contend. A full reduction, or kept rows walked
//   along long rows one row a tile, keep lane-private counters: counter b
//   of thread x at [b][x], so each lane owns one bank and adds with a plain
//   load, add and store, no atomic, for counts and every accumulator type
//   (float64 sums add with DADD, not a compare-and-swap loop). They take
//   nb * 256 * sizeof(A) bytes, at most kPrivateBytes: 50 bins of counts
//   51 KB, of float64 sums 102 KB. Otherwise (more bins, or many short
//   rows a tile, as config 4's (1, m)-strided view walked along the rows)
//   one histogram per row of the tile, in copies: 32-bit counters and sums
//   add with shared atomics into up to eight warp replicas; 64-bit sums
//   into one copy per warp, where __match_any_sync finds the lanes of a
//   warp that share a slot and the lowest of them adds their sum, in lane
//   order, with a plain add.
// - The flush sums lanes (a warp reduction), then copies, into the output:
//   plain stores of every slot, trash slot included, for whole rows (one
//   dense run of stores a tile); 64-bit atomics of the non-zero sums where
//   a row is split across column tiles and for a full reduction, once a
//   block, into an output the launcher zeroed.
// - Reads: a tile that is contiguous in memory (a full reduction of a
//   contiguous array, or one row of a row-major layout) and starts on a
//   16-byte boundary is read 16 bytes a lane (4 float32, 8 bfloat16, 16
//   int8 values a load), two loads a lane in flight; its ragged end, 8-byte
//   data, and other tiles element by element, along whichever dimension
//   has the smaller stride (tile.cuh).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math (digitize.cuh). The entries
// live in one_input.cu (the four wide types), one_input_narrow.cu and
// one_input_unsigned.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "digitize.cuh"
#include "launch.cuh"
#include "narrow.cuh"
#include "tile.cuh"
#include "weights.cuh"

namespace {
namespace oi {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kVecUnroll = 2;  // 16-byte loads a lane in flight, flat tiles
constexpr int kMaxBins = 1024;
constexpr long long kMinTile = (long long)kThreads * kUnroll;
// lane-private counters of a block at most: two blocks an SM
constexpr size_t kPrivateBytes = 110 * 1024;
// a kept row takes lane-private counters when it is at least this many
// times longer than its counters, so the flush of a row's tile (nb * 256
// counters) stays small beside the row's elements
constexpr long long kPrivateRowRatio = 4;
// 32-bit warp replicas of a block, and 64-bit copies one per warp
constexpr size_t kReplicaBytes = 40 * 1024;
constexpr size_t kCopyBytes = 64 * 1024;

// The counter layouts, as xh::LaunchRecord::layout reports them.
enum Layout : int { kLanePrivate = 1, kReplicas = 2, kAggregated = 3 };

using xh::Tiling;

using xh::widen;

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

__host__ __device__ constexpr size_t thr_bytes(int nb, size_t elem) {
  return align16((size_t)xh::skewed_len(nb + 1) * elem);
}

// Dynamic shared memory: the thresholds (skewed), the cell table, then the
// counters (and, for 64-bit copies, a word per thread to aggregate).
__host__ __device__ constexpr size_t hist_offset(int nb, size_t elem, int cells) {
  return thr_bytes(nb, elem) + align16(xh::cells_bytes(cells));
}

// The sum of v over the lanes of a warp, in every lane.
template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// bin[u]: as xh::bins_bucketed where the widest window L is at most 1 (so
// the first step is 1): one table load and one threshold compare, with no
// search loop. Evenly spaced edges give L = 1.
template <typename C, int U>
__device__ __forceinline__ void bins_window1(const C* t, int nb,
                                             const xh::CellMap<C>& mp,
                                             const int2* win, const C (&x)[U],
                                             int (&bin)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int2 e = win[xh::cell_of(mp, x[u])];
    // a threshold in an empty window's place is read and not taken
    const bool take = (e.y > e.x) & (t[xh::skew(min(e.x, nb))] <= x[u]);
    const int i = e.x + (take ? 1 : 0) - 1;
    bool nan = false;
    if constexpr (std::is_floating_point<C>::value) nan = isnan(x[u]);
    bin[u] = (!nan && i >= 0 && i < nb) ? i : -1;
  }
}

// bin[u]: as bins_window1 for float data, on a cell table whose entries
// were rewritten (one_input_kernel's prologue) to (first[c] - 1, the bits
// of the window's one threshold, or of NaN for an empty window): one table
// load and one compare. NaN data maps to cell 0, whose first is 0, and
// compares false: bin -1, as for data out of range.
template <int U>
__device__ __forceinline__ void bins_float_window1(int nb,
                                                   const xh::CellMap<float>& mp,
                                                   const int2* win,
                                                   const float (&x)[U],
                                                   int (&bin)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int2 e = win[xh::cell_of(mp, x[u])];
    const int i = e.x + (x[u] >= __int_as_float(e.y) ? 1 : 0);
    bin[u] = (unsigned)i < (unsigned)nb ? i : -1;
  }
}

// Adds v into the output slot dst: a plain store where the block owns the
// whole row, else an atomic add of a non-zero v (NaN != 0: a NaN sum is
// added).
template <typename Out>
__device__ __forceinline__ void flush_to(Out* dst, Out v, bool owned) {
  if (owned)
    *dst = v;
  else if (v != Out(0))
    atomicAdd(dst, v);
}

// W: xh::Count (adds one) or xh::Sum<A> (adds the weight in w). kPrivate:
// lane-private counters; else copies of the tile's row histograms, 32-bit
// replicas added atomically or 64-bit copies one per warp (aggregated).
template <typename L, typename C, typename W, bool kPrivate>
__global__ void __launch_bounds__(kThreads)
one_input_kernel(const L* __restrict__ a, xh::Dims dims, long long sm1,
                 long long sm, long long sc1, long long sc,
                 const C* __restrict__ thr, int nb, int cells, Tiling tl,
                 int reduce_all, const xh::Weights w,
                 typename W::Out* __restrict__ out, int* __restrict__ widest_out) {
  using Shared = typename W::Shared;
  using Out = typename W::Out;
  constexpr bool kAggregated = !kPrivate && sizeof(Shared) == 8;
  constexpr unsigned kVec = 16 / sizeof(L);  // elements a 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int widest;
  // 8-bit data: the bin of each of the 256 byte values, found once
  __shared__ short lut[sizeof(L) == 1 ? 256 : 1];
  C* t = reinterpret_cast<C*>(smem);
  int2* win = reinterpret_cast<int2*>(smem + thr_bytes(nb, sizeof(C)));
  Shared* hist = reinterpret_cast<Shared*>(smem + hist_offset(nb, sizeof(C), cells));
  // kPrivate: [bin][thread]; else [copy][row of the tile][bin]
  const int one_copy = kPrivate ? nb * kThreads : (reduce_all ? 1 : (int)tl.rows) * nb;
  const int copies = kPrivate ? 1 : tl.copies;
  Shared* scratch = hist + one_copy * copies;  // kAggregated: one per thread

  xh::stage_thresholds(t, thr, nb + 1);
  for (int s = threadIdx.x; s < one_copy * copies; s += blockDim.x) hist[s] = Shared(0);
  __syncthreads();
  const xh::CellMap<C> mp = xh::cell_map(t, nb, cells);
  xh::build_cells(t, nb, mp, win, &widest);
  const int step0 = xh::first_step(widest);
  if (blockIdx.x == 0 && threadIdx.x == 0) *widest_out = widest;
  if constexpr (sizeof(L) == 1) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) {
      const C x[1] = {widen<C>(static_cast<L>(b))};
      int bin[1];
      xh::bins_bucketed(t, nb, mp, win, step0, x, bin);
      lut[b] = (short)bin[0];
    }
    __syncthreads();
  }
  constexpr bool kFloatCells = std::is_same<C, float>::value;
  if constexpr (kFloatCells) {
    if (step0 <= 1) {  // each thread rewrites only the cells it reads
      for (int c = threadIdx.x; c < mp.k; c += blockDim.x) {
        const int2 e = win[c];
        win[c] = make_int2(e.x - 1, e.y > e.x ? __float_as_int(t[xh::skew(e.x)])
                                              : 0x7fc00000);  // NaN
      }
      __syncthreads();
    }
  }

  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = threadIdx.x >> 5;
  Shared* mine = kPrivate ? hist + threadIdx.x : hist + warp % copies * one_copy;

  xh::PieceLoop pl = xh::piece_loop(tl, dims, blockIdx.x, gridDim.x);
  xh::Corner tc;
  bool flush;
  while (xh::next_piece(pl, tl, dims, tc, flush)) {
    const long long r0 = tc.r0;
    const unsigned rr = tc.rr;
    const unsigned cc = tc.cc;
    const unsigned total = rr * cc;
    // flat: the tile's elements (and weights) lie at base + k, k < total,
    // and every one is in row 0 of the tile (one row) or the row does not
    // matter (a full reduction)
    const bool flat = sc == 1 && (!W::kWeighted || w.sc == 1) &&
                      (rr == 1 || (reduce_all && sm == (long long)cc &&
                                   (!W::kWeighted || w.sm == (long long)cc)));
    // else (f, s): a thread's position along the fast and the slow dimension
    // of the tile, advanced by blockDim.x elements a step without a division
    const unsigned fast_n = tl.row_fast ? rr : cc;
    const long long fast_stride = tl.row_fast ? sm : sc;
    const long long slow_stride = tl.row_fast ? sc : sm;
    const unsigned df = blockDim.x % fast_n;
    const unsigned ds = blockDim.x / fast_n;
    unsigned f = threadIdx.x % fast_n;
    unsigned s = threadIdx.x / fast_n;
    const L* base = a + xh::corner_offset(tc, sm1, sm, sc1, sc);
    const long long w_fast = tl.row_fast ? w.sm : w.sc;
    const long long w_slow = tl.row_fast ? w.sc : w.sm;
    const long long w_base = xh::corner_offset(tc, w.sm1, w.sm, w.sc1, w.sc);

    // digitizes and counts kUnroll elements of each lane: raw values, valid
    // where ok, in rows row of the tile, with weights at w_at
    auto count = [&](const L (&raw)[kUnroll], const bool (&ok)[kUnroll],
                     const unsigned (&row)[kUnroll], const long long (&w_at)[kUnroll]) {
      Shared wt[kUnroll];  // each element's weight
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) wt[u] = Shared(1);
      if constexpr (W::kWeighted) xh::load_weights(w.data, w_at, ok, w.code, wt);
      int bin[kUnroll];  // -1: NaN or out of range
      if constexpr (sizeof(L) == 1) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) bin[u] = lut[(unsigned char)raw[u]];
      } else {
        C v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) v[u] = widen<C>(raw[u]);
        if (step0 <= 1) {
          if constexpr (kFloatCells)
            bins_float_window1(nb, mp, win, v, bin);
          else
            bins_window1(t, nb, mp, win, v, bin);
        } else {
          xh::bins_bucketed(t, nb, mp, win, step0, v, bin);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool take = ok[u] && bin[u] >= 0;
        if constexpr (kPrivate) {
          if (take) mine[bin[u] * kThreads] += wt[u];
        } else if constexpr (!kAggregated) {
          if (take) atomicAdd(&mine[row[u] * nb + bin[u]], wt[u]);
        } else {
          // the lanes that share a slot: the lowest adds their weights
          const int slot = take ? (int)(row[u] * nb + bin[u]) : -1;
          const unsigned peers = __match_any_sync(0xffffffffu, slot);
          scratch[threadIdx.x] = wt[u];
          __syncwarp();
          if (slot >= 0 && lane == (unsigned)(__ffs(peers) - 1)) {
            Shared sum = Shared(0);
            for (unsigned p = peers; p; p &= p - 1)
              sum += scratch[(threadIdx.x & ~31u) + __ffs(p) - 1];
            mine[slot] += sum;
          }
          __syncwarp();  // scratch and the slots read before the next element
        }
      }
    };

    // a flat tile at a 16-byte boundary, of data of at most 4 bytes: 16
    // bytes a load, kVecUnroll loads a lane in flight, each vector's
    // elements counted kUnroll at a time; the elements past the last whole
    // vector follow one by one
    unsigned done = 0;
    if ((int)kVec >= kUnroll && flat &&
        reinterpret_cast<unsigned long long>(base) % 16 == 0) {
      const unsigned n_vec = total / kVec;
      for (unsigned qb = threadIdx.x & ~31u; qb < n_vec;
           qb += kVecUnroll * blockDim.x) {
        uint4 pk[kVecUnroll];
        bool ok_v[kVecUnroll];
#pragma unroll
        for (int u = 0; u < kVecUnroll; ++u) {
          const unsigned q = qb + lane + u * blockDim.x;
          ok_v[u] = q < n_vec;
          pk[u] = reinterpret_cast<const uint4*>(base)[ok_v[u] ? q : 0];
        }
#pragma unroll
        for (int u = 0; u < kVecUnroll; ++u) {
          const L* elems = reinterpret_cast<const L*>(&pk[u]);
          const long long first = w_base + (long long)(qb + lane + u * blockDim.x) * kVec;
#pragma unroll
          for (int g = 0; g + kUnroll <= (int)kVec; g += kUnroll) {
            L raw[kUnroll];
            bool ok[kUnroll];
            unsigned row[kUnroll];
            long long w_at[kUnroll];
#pragma unroll
            for (int j = 0; j < kUnroll; ++j) {
              raw[j] = elems[g + j];
              ok[j] = ok_v[u];
              row[j] = 0;
              w_at[j] = first + g + j;
            }
            count(raw, ok, row, w_at);
          }
        }
      }
      done = n_vec * kVec;
    }

    // warp by warp, so that the lanes of a warp leave the loop together
    for (unsigned kb = done + (threadIdx.x & ~31u); kb < total;
         kb += kUnroll * blockDim.x) {
      const unsigned k = kb + lane;
      L raw[kUnroll];
      unsigned row[kUnroll];
      bool ok[kUnroll];
      long long w_at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned e = k + u * blockDim.x;
        ok[u] = e < total;
        long long at = e;
        w_at[u] = w_base + e;
        row[u] = 0;
        if (!flat) {
          at = f * fast_stride + s * slow_stride;
          w_at[u] = w_base + f * w_fast + s * w_slow;
          row[u] = reduce_all ? 0u : tl.row_fast ? f : s;
          f += df;
          s += ds;
          if (f >= fast_n) {
            f -= fast_n;
            ++s;
          }
        }
        raw[u] = base[ok[u] ? at : 0];  // a lane past the tile reads its first
      }
      count(raw, ok, row, w_at);
    }

    if (!reduce_all) {
      // a chunk's next tile of the same rows adds into their counters first
      if (!flush) continue;
      __syncthreads();
      // the block owns these whole rows: it stores each of their slots,
      // the trash slot (b == nb) a zero; else it adds the non-zero sums
      const bool owned = tl.col_tiles == 1;
      Out* row_out = out + r0 * (nb + 1);
      if constexpr (kPrivate) {  // one row: lanes, then the warp
        for (int b = warp; b <= nb; b += kWarps) {
          Out v = 0;
          if (b < nb) {
            for (int j = lane; j < kThreads; j += 32) {
              v += hist[b * kThreads + j];
              hist[b * kThreads + j] = Shared(0);
            }
            v = warp_sum(v);
          }
          if (lane == 0) flush_to(row_out + b, v, owned);
        }
      } else {  // the tile's rows' slots as one run
        for (unsigned sl = threadIdx.x; sl < rr * (nb + 1); sl += blockDim.x) {
          const unsigned r = sl / (nb + 1);
          const unsigned b = sl - r * (nb + 1);
          Out v = 0;
          if (b < (unsigned)nb) {
            for (int cp = 0; cp < copies; ++cp) {
              v += hist[cp * one_copy + r * nb + b];
              hist[cp * one_copy + r * nb + b] = Shared(0);
            }
          }
          flush_to(row_out + sl, v, owned);
        }
      }
      __syncthreads();
    }
  }

  if (reduce_all) {
    __syncthreads();
    if constexpr (kPrivate) {
      for (int b = warp; b < nb; b += kWarps) {
        Out v = 0;
        for (int j = lane; j < kThreads; j += 32) v += hist[b * kThreads + j];
        v = warp_sum(v);
        if (lane == 0) flush_to(&out[b], v, false);
      }
    } else {
      for (int b = threadIdx.x; b < nb; b += blockDim.x) {
        Out v = 0;
        for (int cp = 0; cp < copies; ++cp) v += hist[cp * one_copy + b];
        flush_to(&out[b], v, false);
      }
    }
  }
}

template <typename L, typename C, typename W, bool kPrivate>
int launch(const void* a, const xh::Dims& dims, const long long* st, const void* thr,
           int nb, int cells, int reduce_all, bool row_fast, const xh::Weights& w,
           void* out, void* widest, cudaStream_t stream) {
  using Shared = typename W::Shared;
  constexpr bool kAggregated = !kPrivate && sizeof(Shared) == 8;
  const size_t stage = hist_offset(nb, sizeof(C), cells);
  // the counters: the lane-private ones, else the most the copies may take
  // (the occupancy query asks for that much, so its answer serves every
  // tiling of this bin count)
  const size_t counter_bytes =
      kPrivate ? sizeof(Shared) * (size_t)nb * kThreads
               : (kAggregated ? kCopyBytes : kReplicaBytes);
  const size_t smem_most =
      stage + counter_bytes + (kAggregated ? sizeof(Shared) * kThreads : 0);
  static xh::LaunchShape shape;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = shape.get((const void*)one_input_kernel<L, C, W, kPrivate>,
                              kThreads, smem_most, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * per_sm;

  // rows a tile: one for lane-private kept rows; as many as the copies hold
  // otherwise (one copy a warp for 64-bit sums)
  const long long counters = (long long)(counter_bytes / sizeof(Shared));
  const long long max_rows = reduce_all ? xh::kMaxTile
                             : kPrivate ? 1
                             : kAggregated ? counters / ((long long)nb * kWarps)
                                           : counters / nb;
  Tiling tl = xh::make_tiling(dims, row_fast, max_rows < 1 ? 1 : max_rows,
                              kMinTile, resident);
  if (tl.rows == 1 && tl.col_run > 1) {
    // column tiles of whole 16-element runs, so each tile of a row that
    // starts on a 16-byte boundary starts on one too (the vector reads)
    tl.cols = (tl.cols + 15) / 16 * 16;
    xh::count_tiles(tl, dims);
  }
  const long long one_copy = (reduce_all ? 1 : tl.rows) * nb;
  if (kPrivate) {
    tl.copies = kThreads;
  } else if (kAggregated) {
    tl.copies = kWarps;
  } else {
    const long long copies = counters / one_copy;
    tl.copies = copies < 1 ? 1 : copies > kWarps ? kWarps : (int)copies;
  }
  const long long n_tiles = tl.row_tiles * tl.col_tiles;
  // kept rows of several runs of columns: contiguous chunks, one a block
  const long long grid = reduce_all ? (n_tiles < resident ? n_tiles : resident)
                                    : xh::chunk_tiles(tl, dims, resident);
  // a block's shared counters are 32-bit: bound the elements one block
  // visits before it flushes (a full reduction flushes only at the end, a
  // chunk at most once a tile, and chunk_tiles keeps a chunk within the
  // bound); weighted sums wrap or round by their own type's rules instead
  const long long visits = reduce_all ? xh::ceil_div(n_tiles, grid)
                           : tl.chunk ? tl.chunk : 1;
  if (!W::kWeighted && visits * tl.rows * tl.cols > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;

  const size_t smem =
      kPrivate ? smem_most
               : stage + sizeof(Shared) * (size_t)(tl.copies * one_copy) +
                     (kAggregated ? sizeof(Shared) * kThreads : 0);
  // blocks that own whole kept rows store every slot of the output; a full
  // reduction and rows split across column tiles add into it, so it starts
  // at zero
  const bool zero = reduce_all || tl.col_tiles > 1;
  if (zero) {
    const size_t rows = reduce_all ? 1 : (size_t)(dims.m1 * dims.m0);
    const cudaError_t err = cudaMemsetAsync(
        out, 0, rows * (nb + 1) * sizeof(typename W::Out), stream);
    if (err != cudaSuccess) return (int)err;
  }
  xh::last_launch = {1, 1, 1, {cells, 0}, 1,
                     kPrivate ? kLanePrivate : kAggregated ? oi::kAggregated : kReplicas,
                     tl.copies, 0, (int)grid};
  xh::last_launch.zeroed = zero ? 1 : 0;
  one_input_kernel<L, C, W, kPrivate><<<(unsigned int)grid, kThreads, smem, stream>>>(
      static_cast<const L*>(a), dims, st[0], st[1], st[2], st[3],
      static_cast<const C*>(thr), nb, cells, tl, reduce_all, w,
      static_cast<typename W::Out*>(out), static_cast<int*>(widest));
  return (int)cudaGetLastError();
}

// Writes the counts (or weighted sums) of the (m1, m0, c1, c0) view a (dims
// dim[0..3], strides st[0..3] = (sm1, sm, sc1, sc) in elements, of load type
// L) against nb + 1 thresholds of compare type C into out, every slot of it
// (the trash slot zero), whatever out held: the kernel stores whole rows,
// and the launcher zeroes out on the stream first where the kernel adds
// (xh::last_launch.zeroed); the first block writes the widest window of its
// cell table into *widest. A full reduction's one row of two column levels
// comes as (1, c1, 1, c0), its rows summed (cuda_hist._geometry). Launches on `stream` and
// returns cudaGetLastError() (or the first failing CUDA call's error);
// never synchronises.
template <typename L, typename C, typename W>
int launch_one_input(const void* a, const long long* dim, const long long* st,
                     const void* thr, int nb, int reduce_all, const xh::Weights& w,
                     void* out, void* widest, void* stream) {
  const xh::Dims dims = {dim[0], dim[1], dim[2], dim[3]};
  if (dims.m1 <= 0 || dims.m0 <= 0 || dims.c1 <= 0 || dims.c0 <= 0 || st[0] < 0 ||
      st[1] < 0 || st[2] < 0 || st[3] < 0 || nb < 1 || nb > kMaxBins || w.sm < 0 ||
      w.sc < 0 || w.sm1 < 0 || w.sc1 < 0 || widest == nullptr)
    return (int)cudaErrorInvalidValue;
  using Shared = typename W::Shared;
  const int cells = 2 * nb;  // <= xh::kMaxCells for nb <= kMaxBins
  // a tile lies in one run of rows and one of columns: the inner levels
  const bool row_fast = dims.m0 > 1 && (dims.c0 == 1 || st[1] < st[3]);
  // lane-private counters where they fit and each tile is one histogram
  // row: a full reduction, or long rows walked along their columns
  const bool fits = sizeof(Shared) * (size_t)nb * kThreads <= kPrivateBytes;
  const bool one_row = reduce_all || (!row_fast && dims.c1 * dims.c0 >=
                                                       kPrivateRowRatio * nb * kThreads);
  const cudaStream_t stream_ = (cudaStream_t)stream;
  if (fits && one_row)
    return launch<L, C, W, true>(a, dims, st, thr, nb, cells, reduce_all, row_fast, w,
                                 out, widest, stream_);
  return launch<L, C, W, false>(a, dims, st, thr, nb, cells, reduce_all, row_fast, w,
                                out, widest, stream_);
}

}  // namespace oi
}  // namespace

// The entry of load type L compared as C: counts into out; see
// oi::launch_one_input.
#define XH_ONE_INPUT(name, L, C)                                              \
  extern "C" int name(const void* a, const long long* dims,                  \
                      const long long* strides, const void* thr, int nb,     \
                      int reduce_all, void* out, void* widest, void* stream) { \
    return oi::launch_one_input<L, C, xh::Count>(                            \
        a, dims, strides, thr, nb, reduce_all, xh::Weights{}, out, widest,   \
        stream);                                                             \
  }

// Weighted: writes the sums of the weights w (a view with the four strides
// wst, of the type `wcode` names within accumulator class A; weights.cuh)
// into out, of type A, as the counts are written.
#define XH_ONE_INPUT_WEIGHTED(name, L, C, A)                                  \
  extern "C" int name(const void* a, const long long* dims,                  \
                      const long long* strides, const void* thr, int nb,     \
                      int reduce_all, const void* w, const long long* wst,   \
                      int wcode, void* out, void* widest, void* stream) {    \
    return oi::launch_one_input<L, C, xh::Sum<A>>(                           \
        a, dims, strides, thr, nb, reduce_all,                               \
        xh::weights_of(w, wst, wcode), out, widest, stream);                 \
  }
