// Direct-route histograms for Hopper: N inputs, kept rows narrower than 256
// elements, at most 8192 slots a row; int64 counts or weighted sums, each
// row stored in its final dtype.
//
// Replaces the TPU kernel xhistogram_tpu/ops/pallas_hist.py::_direct_kernel
// (driven by _run_direct into pl.pallas_call). That kernel builds a one-hot
// of each element's flat slot over a chunk of slots and multiplies it with
// a row one-hot on the TPU's matrix unit, because the TPU has no fast
// scatter. Here each element is digitized once per input (the bucketed
// search of digitize.cuh, exact for any sorted thresholds) and added to its
// row's flat slot
//   g = ((t_0 * nb_1 + t_1) * nb_2 + ...) + t_{n-1},  t_k its bin on input k;
// slot S = prod(nb_k) is the trash slot and stays zero.
//
// What bounds it on an H100: the output. A row writes (S + 1) sizeof(Out)
// bytes against c sizeof(T) bytes an input read: at 40x40 bins and 64
// members, 12.8 KB of int64 against 512 B of float32 pairs, so 830 MB
// written against 33 MB read at (64800, 64). The design keeps the stores
// streaming and every other step off their path (on an H100 the kernel
// takes as long with nothing to count: PERF.md §5):
// - One warp owns one kept row at a time (rows dealt round the warps of a
//   persistent grid). Its lanes read the row's elements with each input's
//   own strides (a broadcast input has stride 0), at most 8 a lane, and
//   digitize them. Rows and columns each come as two levels (an (m1, m0,
//   c1, c0) view, tile.cuh): a row r = i1 * m0 + i0 is split once a row,
//   and a lane's column j = j1 * c0 + j0 by a multiply and a shift (j and
//   c0 below 256). A lane loads its first two elements of the next row (of
//   each input where the input count is a template argument, and their
//   weights) before it digitizes this row, and the rest of a row before its
//   first two, so the loads' latency hides behind a row's work; with a
//   run-time input count each input's loads go just before its search.
// - Its counters are its own, in shared memory: no other warp touches them,
//   so no atomics. Within the warp, __match_any_sync finds the lanes whose
//   elements share a slot, and the lowest of them adds the group's count,
//   or its weights in lane order, with a plain add; 64-bit sums (int64
//   counts, float64, uint64) take no compare-and-swap loop.
// - The row goes out by 16-byte streaming stores (st.global.cs) from the
//   lanes, which read each 16 bytes of the buffer and zero them in the same
//   pass; the stores need no wait, so the warp counts its next row at once
//   in the same buffer while they drain. A row of (S + 1) 8-byte slots
//   starts 8 bytes off a 16-byte boundary every other row, so the buffer
//   holds the row at the same offset mod 16 as its place in the output;
//   the elements before the first and after the last 16-byte boundary are
//   plain stores. Every slot of every row is written, so the output needs
//   no zeroing. (A TMA bulk copy of each row, from two buffers a warp each
//   reused once its copy had read it, measured slower: PERF.md §6.)
// - The row leaves in its final dtype: int64 counts; sums in the weights'
//   accumulator class (float64, int32 mod 2^32, 64-bit); or, for float
//   weights narrower than float64 where the caller asks for finished sums,
//   float32, each slot rounded once from its float64 sum (__double2float_rn,
//   as bincount.finish_sums rounds), which halves the bytes written and
//   leaves no rounding pass. Such rows add in float64 in the buffer, and
//   are rounded in place (each float lands on float64 sums already read)
//   before the row is stored.
// - Each block stages every input's thresholds and builds its cell tables
//   once, in its prologue, then walks its rows; a block holds as many warps
//   (at most 16) as their buffers fit beside the tables in 227 KB: 16 at
//   40x40 bins, 3 at S = 8192 with 8-byte sums. Where the tables do not fit
//   beside one warp, each input searches one cell (the plain binary
//   search).
//
// - Narrow data (T = Narrow, direct_rows_narrow.cu): float32 and the
//   narrow types (bool, int8, uint8, int16, uint16, float16, bfloat16), in
//   any mix, each input read in place at its own width by its run-time
//   load code (narrow.cuh, the same in every lane) and widened in registers
//   to float32, against float32 thresholds (int32 ones converted for the
//   integers, exact for every 8- and 16-bit value); 8-bit data through a
//   table of its 256 values' bins built in the prologue. The row stores,
//   which set the pace, are the same.
// - Every other mix of types (T = Mixed, direct_rows_mixed.cu): int32,
//   int64 or float64 beside other types, each input read in place by its
//   load code and held in 8 bytes, int64 compared in int64 and every other
//   type in double, to which it converts exactly, against its own
//   thresholds (narrow.cuh's mixed entries); 8-bit data through its table.
//
// Outside this envelope (rows of 256 elements or more, over 8192 slots) the
// direct route runs the flat-slot template's xh_slot_* entries (slot.cuh)
// per kept row.
//
// Entries: xh_direct_rows_<data> (counts; direct_rows.cu) and
// xh_direct_rows_<data>_<class>, per accumulator class of weights.cuh
// (direct_rows_wf64.cu, direct_rows_wu32.cu, direct_rows_wu64.cu), and the
// class wf32 (direct_rows_wf32.cu): float weights summed in float64, rows
// stored as float32; xh_direct_rows_narrow and xh_direct_rows_mixed and
// their classes (direct_rows_narrow.cu, direct_rows_mixed.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, without
// --use_fast_math (digitize.cuh).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "digitize.cuh"
#include "launch.cuh"
#include "narrow.cuh"
#include "tile.cuh"
#include "weights.cuh"

// Each including file gets its own copy of the kernels and launch caches.
namespace {
namespace drow {

constexpr int kMaxInputs = 32;
constexpr int kMaxWarps = 16;
constexpr long long kMaxCols = 255;    // rows narrower than 256 elements
constexpr long long kMaxSlots = 8192;  // S, the trash slot aside
constexpr int kPer = 8;                // elements a lane holds: c < 256
constexpr int kUnroll = 2;             // elements a lane digitizes at a time
constexpr int kRoundUnroll = 4;        // slots a lane rounds at a time

struct Input {
  // element (r, j), r = i1 * m0 + i0 and j = j1 * c0 + j0, at
  // data[i1 * sm1 + i0 * sm + j1 * sc1 + j0 * sc]
  const void* data;
  const void* thr;  // nb + 1 thresholds in device memory
  long long sm;
  long long sc;
  long long sm1;
  long long sc1;
  int nb;
  int soff;   // slot of its first threshold in shared memory (skewed)
  int toff;   // its first cell in the staged cell tables
  int cells;  // cells of its table
};

// The instantiations of inputs with run-time stored types: see the header.
struct Narrow {};
struct Mixed {};
template <typename T>
constexpr bool kNarrow = std::is_same<T, Narrow>::value;
template <typename T>
constexpr bool kMixed = std::is_same<T, Mixed>::value;
template <typename T>
constexpr bool kCoded = kNarrow<T> || kMixed<T>;
// The compare type (and that of the thresholds): T, float for Narrow; for
// Mixed, 8 bytes that hold int64 as itself and every other type as the bits
// of its double (narrow.cuh's mixed entries).
template <typename T>
using Cmp = typename std::conditional<
    kNarrow<T>, float, typename std::conditional<kMixed<T>, long long, T>::type>::type;

// Narrow and Mixed: the stored type (narrow.cuh's load codes), and, for
// 8-bit data, the first int of its table of 256 bins in shared memory (else
// -1).
struct Coded : Input {
  int code;
  int lut;
};
template <typename T>
using InputOf = typename std::conditional<kCoded<T>, Coded, Input>::type;

template <typename T>
struct Inputs {
  InputOf<T> in[kMaxInputs];
  int n;
};

// 227 KB a block, less the kernel's static shared memory (the input table,
// the cell maps and the windows' widths)
template <typename T>
constexpr size_t kSmemMax = 232448 - (sizeof(InputOf<T>) + sizeof(xh::CellMap<Cmp<T>>) +
                                      sizeof(int)) * kMaxInputs - 64;

// Bytes of the dynamic shared memory: the staged thresholds and cell tables,
// then each warp's share: its row buffer, (S + 1) accumulators and 16 bytes,
// and its lanes' weights (weighted only).
struct Layout {
  unsigned thr_bytes;
  unsigned stage_bytes;
  unsigned buf_bytes;
  unsigned warp_bytes;
};

// What a warp adds into: 64-bit counters for counts (the output's int64),
// the weights' accumulator otherwise.
template <typename W>
struct AccOf {
  using type = typename W::Shared;
};
template <>
struct AccOf<xh::Count> {
  using type = unsigned long long;
};

// Where a row lies: r = i1 * m0 + i0.
struct RowAt {
  long long i1;
  long long i0;
};

__device__ __forceinline__ RowAt row_at(long long r, long long m0, bool two_levels) {
  if (!two_levels) return {0, r};
  const long long i1 = r / m0;
  return {i1, r - i1 * m0};
}

// The two levels of a row's columns: j = j1 * c0 + j0 with j1 = (j * mul)
// >> 16, exact for j and c0 below 256 (mul = ceil(2^16 / c0)); j1 = 0 where
// the row is one run (c0 = c).
struct Cols {
  int c0;
  int mul;
};

// The offset of column j in a view of strides (sm1, sm, sc1, sc), row at.
__device__ __forceinline__ long long offset_of(const RowAt& at, int j, const Cols& cs,
                                               long long sm1, long long sm,
                                               long long sc1, long long sc) {
  const int j1 = (j * cs.mul) >> 16;
  return at.i1 * sm1 + at.i0 * sm + j1 * sc1 + (long long)(j - j1 * cs.c0) * sc;
}

// v[q] for q in [Q0, Q1): input d's elements of row `at` at columns
// lane + 32 q, widened to its compare type (Narrow: by its load code; Mixed:
// by its load code, held in 8 bytes); zeros where !ok[q].
template <int Q0, int Q1, int K, typename T, typename In>
__device__ __forceinline__ void load_input(const In& d, const RowAt& row, const Cols& cs,
                                           int lane, const bool (&ok)[K],
                                           Cmp<T> (&v)[K]) {
  long long at[K];
#pragma unroll
  for (int q = Q0; q < Q1; ++q)
    at[q] = offset_of(row, lane + 32 * q, cs, d.sm1, d.sm, d.sc1, d.sc);
  if constexpr (kMixed<T>) {
    xh::gather_mixed<K, Q0, Q1>(d.data, at, ok, d.code, v);
  } else if constexpr (kNarrow<T>) {
    xh::gather_coded<float, K, Q0, Q1>(d.data, at, ok, d.code, v);
  } else {
    const T* base = static_cast<const T*>(d.data);
#pragma unroll
    for (int q = Q0; q < Q1; ++q) v[q] = ok[q] ? base[at[q]] : T(0);
  }
}

// v[i][q] and wv[q] for q in [Q0, Q1): a lane's elements of row `at`
// (columns lane + 32 q) of the first kH inputs (none when !kLoad), and their
// weights (zeros unweighted); zeros past the row's c columns, or where
// !live.
template <int Q0, int Q1, bool kLoad, int kH, typename T, typename W, typename Acc>
__device__ __forceinline__ void load_columns(const InputOf<T>* in, const xh::Weights& w,
                                             const RowAt& at, const Cols& cs, bool live,
                                             int c, int lane, Cmp<T> (&v)[kH][kPer],
                                             Acc (&wv)[kPer]) {
  bool ok[kPer];
#pragma unroll
  for (int q = Q0; q < Q1; ++q) ok[q] = live && lane + 32 * q < c;
  if constexpr (kLoad) {
#pragma unroll
    for (int i = 0; i < kH; ++i) load_input<Q0, Q1, kPer, T>(in[i], at, cs, lane, ok, v[i]);
  }
#pragma unroll
  for (int q = Q0; q < Q1; ++q) {
    wv[q] = Acc(0);
    if constexpr (W::kWeighted)
      if (ok[q])
        xh::load_weight(w.data, offset_of(at, lane + 32 * q, cs, w.sm1, w.sm, w.sc1, w.sc),
                        w.code, wv[q]);
  }
}

// W: xh::Count (adds one) or xh::Sum<A> (adds the weight in w). Out: the
// output's type (W's accumulator, or float for rounded float sums). kN: the
// input count when it is known at compile time (0: read p.n).
template <typename T, typename W, typename Out, int kN>
__global__ void __launch_bounds__(kMaxWarps * 32)
direct_rows_kernel(const Inputs<T> p, const xh::Weights w, long long m, long long m0,
                   int c, Cols cs, int S, Layout ly, Out* __restrict__ out) {
  using Acc = typename AccOf<W>::type;
  using C = Cmp<T>;
  constexpr bool kRound = !std::is_same<Acc, Out>::value;  // float64 -> float32
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ InputOf<T> in[kMaxInputs];
  __shared__ xh::CellMap<C> maps[kMaxInputs];
  __shared__ int widest[kMaxInputs];
  const int n = kN ? kN : p.n;
#pragma unroll
  for (int k = 0; k < kMaxInputs; ++k)  // static indices: no local copy of p
    if (threadIdx.x == k && k < n) in[k] = p.in[k];
  __syncthreads();

  // the prologue: every input's thresholds and cell table, once a block
  C* t = reinterpret_cast<C*>(smem);
  int2* win = reinterpret_cast<int2*>(smem + ly.thr_bytes);
  for (int i = 0; i < n; ++i)
    xh::stage_thresholds(t + in[i].soff, static_cast<const C*>(in[i].thr),
                         in[i].nb + 1);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if constexpr (kMixed<T>) {  // int64 in int64, the rest in double
      const xh::CellMap<C> mp =
          xh::mixed_cell_map(t + in[i].soff, in[i].nb, in[i].cells, in[i].code);
      if (threadIdx.x == 0) maps[i] = mp;
      xh::mixed_build_cells(t + in[i].soff, in[i].nb, mp, in[i].code, win + in[i].toff,
                            &widest[i]);
      if (in[i].lut >= 0)  // 8-bit data: its 256 values' bins
        xh::mixed_byte_table(t + in[i].soff, in[i].nb, mp, win + in[i].toff,
                             xh::first_step(widest[i]), in[i].code,
                             reinterpret_cast<int*>(smem) + in[i].lut);
    } else {
      const xh::CellMap<C> mp = xh::cell_map(t + in[i].soff, in[i].nb, in[i].cells);
      if (threadIdx.x == 0) maps[i] = mp;
      xh::build_cells(t + in[i].soff, in[i].nb, mp, win + in[i].toff, &widest[i]);
      if constexpr (kNarrow<T>) {  // 8-bit data: its 256 values' bins
        if (in[i].lut >= 0)
          xh::build_byte_table(t + in[i].soff, in[i].nb, mp, win + in[i].toff,
                               xh::first_step(widest[i]), in[i].code,
                               reinterpret_cast<int*>(smem) + in[i].lut);
      }
    }
  }
  if constexpr (kCoded<T>) __syncthreads();  // the tables, before a read

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* buf = smem + ly.stage_bytes + (size_t)warp * ly.warp_bytes;
  Acc* scratch = reinterpret_cast<Acc*>(buf + ly.buf_bytes);
  uint4* chunks = reinterpret_cast<uint4*>(buf);
  const unsigned n_chunks = ly.buf_bytes / 16;
  for (unsigned k = lane; k < n_chunks; k += 32) chunks[k] = make_uint4(0, 0, 0, 0);
  __syncwarp();

  const long long row_len = (long long)S + 1;
  const long long n_warps = (long long)gridDim.x * (blockDim.x >> 5);
  const int per = (c + 31) / 32;  // elements a lane holds, at most kPer

  // a lane's elements of its row, each input's where kN is known: the first
  // kUnroll of each (and of their weights) loaded a row ahead
  constexpr int kHeld = kN > 0 ? kN : 1;
  const bool two_levels = m0 < m;  // rows in runs of m0
  long long r = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  RowAt at = row_at(r, m0, two_levels);
  C v[kHeld][kPer];
  Acc wv[kPer];
  load_columns<0, kUnroll, (kN > 0), kHeld, T, W>(in, w, at, cs, r < m, c, lane, v, wv);
  for (; r < m; r += n_warps) {
    if (per > kUnroll)
      load_columns<kUnroll, kPer, (kN > 0), kHeld, T, W>(in, w, at, cs, true, c, lane, v,
                                                         wv);
    C v_next[kHeld][kPer];
    Acc wv_next[kPer];
    const RowAt at_next = row_at(r + n_warps, m0, two_levels);
    load_columns<0, kUnroll, (kN > 0), kHeld, T, W>(in, w, at_next, cs, r + n_warps < m,
                                                    c, lane, v_next, wv_next);
    Out* dst = out + r * row_len;
    // the row sits in the buffer at its output address's offset mod 16
    const unsigned shift = (unsigned)(reinterpret_cast<unsigned long long>(dst) & 15);
    Out* row = reinterpret_cast<Out*>(buf + shift);
    // float64 sums to round sit at the buffer's start, the rest in the row
    Acc* sums = reinterpret_cast<Acc*>(kRound ? buf : buf + shift);

#pragma unroll
    for (int q0 = 0; q0 < kPer; q0 += kUnroll) {
      if (q0 >= per) break;  // the same in every lane
      bool valid[kUnroll];
      int slot[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        valid[u] = lane + 32 * (q0 + u) < c;
        slot[u] = 0;
      }
#pragma unroll
      for (int i = 0; i < (kN ? kN : n); ++i) {
        const InputOf<T> d = in[i];
        C x[kUnroll];
        if constexpr (kN > 0) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) x[u] = v[i][q0 + u];
        } else {
          load_input<0, kUnroll, kUnroll, T>(d, at, cs, lane + 32 * q0, valid, x);
        }
        int bin[kUnroll];
        int lut = -1;  // 8-bit data: its table's first int
        if constexpr (kCoded<T>) lut = d.lut;
        if (lut >= 0) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            unsigned byte;
            if constexpr (kMixed<T>)
              byte = xh::held_byte(x[u]);
            else
              byte = xh::byte_of(x[u]);
            bin[u] = reinterpret_cast<const int*>(smem)[lut + byte];
          }
        } else if constexpr (kMixed<T>) {
          xh::mixed_bins<kUnroll>(t + d.soff, d.nb, maps[i], win + d.toff,
                                  xh::first_step(widest[i]), d.code, x, bin);
        } else {
          xh::bins_bucketed<C, kUnroll>(t + d.soff, d.nb, maps[i], win + d.toff,
                                        xh::first_step(widest[i]), x, bin);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          valid[u] = valid[u] && bin[u] >= 0;
          slot[u] = slot[u] * d.nb + (bin[u] > 0 ? bin[u] : 0);
        }
      }
      // the lanes that share a slot: the lowest adds their count, or their
      // weights in lane order
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!valid[u]) slot[u] = -1;
        const unsigned peers = __match_any_sync(0xffffffffu, slot[u]);
        const bool leader = slot[u] >= 0 && lane == __ffs(peers) - 1;
        if constexpr (W::kWeighted) {
          scratch[lane] = wv[q0 + u];
          __syncwarp();
          if (leader) {
            Acc sum = Acc(0);
            for (unsigned q = peers; q; q &= q - 1) sum += scratch[__ffs(q) - 1];
            sums[slot[u]] += sum;
          }
        } else if (leader) {
          sums[slot[u]] += (Acc)__popc(peers);
        }
        __syncwarp();  // the sums and scratch, before the next element
      }
    }

    if constexpr (kRound) {
      // in place: float l lands on the bytes of float64 sums at most
      // (l + 3) / 2, all read before it is written (every lane reads a
      // step's sums before any lane writes its floats)
      for (int l0 = 0; l0 < row_len; l0 += 32 * kRoundUnroll) {
        double x[kRoundUnroll];
#pragma unroll
        for (int u = 0; u < kRoundUnroll; ++u) {
          const int l = l0 + lane + 32 * u;
          x[u] = l < row_len ? sums[l] : 0.0;
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < kRoundUnroll; ++u) {
          const int l = l0 + lane + 32 * u;
          if (l < row_len) row[l] = __double2float_rn(x[u]);
        }
      }
      __syncwarp();
    }
    // plain stores before the first and after the last 16-byte boundary of
    // the row; then 16-byte streaming stores between, each chunk of the
    // buffer zeroed as it is read
    int head = (int)(((16u - shift) & 15u) / sizeof(Out));
    if (head > row_len) head = (int)row_len;
    const unsigned body = (unsigned)(((row_len - head) * sizeof(Out)) / 16);
    const int tail = head + (int)(body * 16 / sizeof(Out));
    for (int l = lane; l < head; l += 32) dst[l] = row[l];
    for (int l = tail + lane; l < row_len; l += 32) dst[l] = row[l];
    __syncwarp();
    const unsigned first = (shift + head * (unsigned)sizeof(Out)) / 16;
    uint4* to = reinterpret_cast<uint4*>(dst + head);
#pragma unroll 4
    for (unsigned k = lane; k < n_chunks; k += 32) {
      const uint4 x = chunks[k];
      chunks[k] = make_uint4(0, 0, 0, 0);
      if (k - first < body) __stcs(to + (k - first), x);  // k < first wraps past body
    }
    __syncwarp();  // zeroed before the next row's adds
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      wv[q] = wv_next[q];
#pragma unroll
      for (int i = 0; i < kHeld; ++i) v[i][q] = v_next[i][q];
    }
    at = at_next;
  }
}

template <typename T, typename W, typename Out, int kN>
int launch_kernel(const Inputs<T>& p, const xh::Weights& w, long long m, long long m0,
                  long long c, Cols cs, long long S, const Layout& ly, int warps,
                  void* out, cudaStream_t stream) {
  static xh::LaunchShape shape;
  const size_t smem = ly.stage_bytes + (size_t)warps * ly.warp_bytes;
  int sms = 0;
  int per_sm = 0;
  const cudaError_t err =
      shape.get((const void*)direct_rows_kernel<T, W, Out, kN>,
                        warps * 32, smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long most = (long long)sms * per_sm;
  const long long wanted = xh::ceil_div(m, warps);
  const long long blocks = wanted < most ? wanted : most;
  xh::LaunchRecord rec = {};
  rec.cluster = 1;
  rec.passes = 1;
  rec.shared = 1;
  rec.cells[0] = p.in[0].cells;
  rec.cells[1] = p.n > 1 ? p.in[1].cells : 0;
  rec.warps = warps;
  rec.blocks = (int)blocks;
  rec.rows_per_warp = (int)xh::ceil_div(m, blocks * warps);
  xh::last_launch = rec;
  direct_rows_kernel<T, W, Out, kN><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      p, w, m, m0, (int)c, cs, (int)S, ly, static_cast<Out*>(out));
  return (int)cudaGetLastError();
}

// The C entries' common body: counts (W = xh::Count, Out = int64's bits) or
// weighted sums (W = xh::Sum<A>, weights w; Out = A, or float for rounded
// float sums) of the n inputs' views into out, (m1 m0, S + 1) of Out,
// which needs no zeroing. data[k], thr[k]: device pointers of type T
// (Narrow: data of the type codes[k] names, narrow.cuh, and float
// thresholds; Mixed: data of that type, and int64 thresholds for int64
// data, float64 for the rest); strides[4k .. 4k + 3]: input k's (sm1, sm, sc1,
// sc) in elements over the (m1, m0, c1, c0) view dims[0..3]; nb[k] its bin
// count. Takes 1 <= c1 c0 <= 255 and S <= 8192 (the caller sends the rest
// to slot.cuh); launches on `stream` and returns cudaGetLastError() or the
// first failing CUDA call's error; never synchronises.
template <typename T, typename W, typename Out>
int launch_direct_rows(int n, const int* codes, const void* const* data,
                       const long long* strides, const void* const* thr,
                       const int* nb, const long long* dims, const xh::Weights& w,
                       void* out, void* stream) {
  using Acc = typename AccOf<W>::type;
  const long long m0 = dims[1];
  const long long c0 = dims[3];
  const long long m = dims[0] * m0;
  const long long c = dims[2] * c0;
  if (n < 1 || n > kMaxInputs || dims[0] <= 0 || m0 <= 0 || dims[2] <= 0 || c0 <= 0 ||
      c > kMaxCols || w.sm < 0 || w.sc < 0 || w.sm1 < 0 || w.sc1 < 0)
    return (int)cudaErrorInvalidValue;
  const Cols cs = {(int)c0, (int)((65536 + c0 - 1) / c0)};
  Inputs<T> p = {};
  p.n = n;
  long long S = 1;
  size_t thr_slots = 0;
  size_t cells = 0;
  int tables = 0;  // 8-bit inputs (Narrow, Mixed)
  for (int k = 0; k < n; ++k) {
    InputOf<T>& d = p.in[k];
    if constexpr (kCoded<T>) {
      // Narrow reads float32 and the narrow types; Mixed every type
      const int code = codes[k];
      if (code < 0 || code >= xh::kLoadCodes || (kNarrow<T> && !xh::narrow_code(code)))
        return (int)cudaErrorInvalidValue;
      d.code = code;
      d.lut = -1;
      tables += xh::is_byte(code);
    }
    d.data = data[k];
    d.thr = thr[k];
    d.sm1 = strides[4 * k];
    d.sm = strides[4 * k + 1];
    d.sc1 = strides[4 * k + 2];
    d.sc = strides[4 * k + 3];
    d.nb = nb[k];
    if (d.nb < 1 || d.sm < 0 || d.sc < 0 || d.sm1 < 0 || d.sc1 < 0 ||
        S * d.nb > kMaxSlots)
      return (int)cudaErrorInvalidValue;
    S *= d.nb;
    d.soff = (int)thr_slots;
    thr_slots += xh::skewed_len(d.nb + 1);
    d.cells = d.nb < xh::kMaxCells / 2 ? 2 * d.nb : xh::kMaxCells;
    cells += d.cells;
  }
  const auto round16 = [](size_t b) { return (b + 15) / 16 * 16; };
  const size_t row_len = (size_t)S + 1;
  Layout ly = {};
  ly.thr_bytes = (unsigned)round16(thr_slots * sizeof(Cmp<T>));
  ly.buf_bytes = (unsigned)round16(row_len * sizeof(Acc)) + 16;
  ly.warp_bytes = ly.buf_bytes + (W::kWeighted ? (unsigned)round16(32 * sizeof(Acc)) : 0);
  const size_t budget = kSmemMax<T>;
  const size_t lut_bytes = sizeof(int) * 256 * (size_t)tables;
  // one cell a table (the plain binary search) where the tables do not fit
  // beside one warp's share
  if (ly.thr_bytes + xh::cells_bytes((int)cells) + lut_bytes + ly.warp_bytes > budget) {
    cells = 0;
    for (int k = 0; k < n; ++k) cells += (p.in[k].cells = 1);
  }
  for (int k = 0, toff = 0; k < n; toff += p.in[k++].cells) p.in[k].toff = toff;
  const size_t lut_at = ly.thr_bytes + xh::cells_bytes((int)cells);
  if constexpr (kCoded<T>) {
    int lut = (int)(lut_at / sizeof(int));
    for (int k = 0; k < n; ++k)
      if (xh::is_byte(p.in[k].code)) {
        p.in[k].lut = lut;
        lut += 256;
      }
  }
  ly.stage_bytes = (unsigned)round16(lut_at + lut_bytes);
  if (ly.stage_bytes + ly.warp_bytes > budget) return (int)cudaErrorInvalidValue;
  long long warps = (long long)((budget - ly.stage_bytes) / ly.warp_bytes);
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps > m) warps = m;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n == 2)
    return launch_kernel<T, W, Out, 2>(p, w, m, m0, c, cs, S, ly, (int)warps, out, st);
  return launch_kernel<T, W, Out, 0>(p, w, m, m0, c, cs, S, ly, (int)warps, out, st);
}

}  // namespace drow
}  // namespace

// The C entry of counts, for data (and thresholds) of type T; see
// launch_direct_rows.
#define XH_DIRECT_ROWS_ENTRY(name, T)                                         \
  extern "C" int name(int n, const void* const* data,                        \
                      const long long* strides, const void* const* thr,      \
                      const int* nb, const long long* dims, void* out,       \
                      void* stream) {                                        \
    return drow::launch_direct_rows<T, xh::Count, unsigned long long>(       \
        n, nullptr, data, strides, thr, nb, dims, xh::Weights{}, out, stream); \
  }

// The weighted C entry: sums of the weights w (a view with the four strides
// wst, of the type `wcode` names within accumulator class A; weights.cuh),
// added in A and stored as Out.
#define XH_DIRECT_ROWS_WEIGHTED_ENTRY(name, T, A, Out)                        \
  extern "C" int name(int n, const void* const* data,                        \
                      const long long* strides, const void* const* thr,      \
                      const int* nb, const long long* dims, const void* w,   \
                      const long long* wst, int wcode, void* out,            \
                      void* stream) {                                        \
    return drow::launch_direct_rows<T, xh::Sum<A>, Out>(                     \
        n, nullptr, data, strides, thr, nb, dims,                            \
        xh::weights_of(w, wst, wcode), out, stream);                         \
  }

// The weighted entries xh_direct_rows_<data>_<cls> of accumulator class cls
// (accumulator and output type A), for the four data types.
#define XH_DIRECT_ROWS_CLASS(cls, A)                                          \
  XH_DIRECT_ROWS_WEIGHTED_ENTRY(xh_direct_rows_f32_##cls, float, A, A)        \
  XH_DIRECT_ROWS_WEIGHTED_ENTRY(xh_direct_rows_f64_##cls, double, A, A)       \
  XH_DIRECT_ROWS_WEIGHTED_ENTRY(xh_direct_rows_i32_##cls, int, A, A)          \
  XH_DIRECT_ROWS_WEIGHTED_ENTRY(xh_direct_rows_i64_##cls, long long, A, A)

// The same for float weights summed in float64 and stored as A (float).
#define XH_DIRECT_ROWS_ROUNDED_CLASS(cls, A)                                  \
  XH_DIRECT_ROWS_WEIGHTED_ENTRY(xh_direct_rows_f32_##cls, float, double, A)   \
  XH_DIRECT_ROWS_WEIGHTED_ENTRY(xh_direct_rows_f64_##cls, double, double, A)  \
  XH_DIRECT_ROWS_WEIGHTED_ENTRY(xh_direct_rows_i32_##cls, int, double, A)     \
  XH_DIRECT_ROWS_WEIGHTED_ENTRY(xh_direct_rows_i64_##cls, long long, double, A)

// The entry of counts of inputs with run-time stored types (T =
// drow::Narrow, direct_rows_narrow.cu; drow::Mixed, direct_rows_mixed.cu):
// as XH_DIRECT_ROWS_ENTRY, with codes[k] naming input k's stored type
// (narrow.cuh's load codes; Narrow: float32 and the narrow types, with
// float32 thresholds; Mixed: any, with int64 thresholds for int64 data and
// float64 for the rest).
#define XH_DIRECT_ROWS_CODED_ENTRY(name, T)                                   \
  extern "C" int name(int n, const int* codes, const void* const* data,      \
                      const long long* strides, const void* const* thr,      \
                      const int* nb, const long long* dims, void* out,       \
                      void* stream) {                                        \
    return drow::launch_direct_rows<T, xh::Count, unsigned long long>(       \
        n, codes, data, strides, thr, nb, dims, xh::Weights{}, out, stream); \
  }

// The weighted coded entry, added in A and stored as Out.
#define XH_DIRECT_ROWS_CODED_WEIGHTED_ENTRY(name, T, A, Out)                  \
  extern "C" int name(int n, const int* codes, const void* const* data,      \
                      const long long* strides, const void* const* thr,      \
                      const int* nb, const long long* dims, const void* w,   \
                      const long long* wst, int wcode, void* out,            \
                      void* stream) {                                        \
    return drow::launch_direct_rows<T, xh::Sum<A>, Out>(                     \
        n, codes, data, strides, thr, nb, dims,                              \
        xh::weights_of(w, wst, wcode), out, stream);                         \
  }

// The coded entry xh_direct_rows_<kind>_<cls> (kind narrow or mixed, T its
// instantiation) of accumulator class cls (accumulator and output type A),
// and of float weights summed in float64 and stored as float (the rounded
// class).
#define XH_DIRECT_ROWS_CODED_CLASS(kind, T, cls, A) \
  XH_DIRECT_ROWS_CODED_WEIGHTED_ENTRY(xh_direct_rows_##kind##_##cls, T, A, A)
#define XH_DIRECT_ROWS_CODED_ROUNDED_CLASS(kind, T, cls, A) \
  XH_DIRECT_ROWS_CODED_WEIGHTED_ENTRY(xh_direct_rows_##kind##_##cls, T, double, A)
