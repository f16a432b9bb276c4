// N-input flat-slot histogram, full reduction or kept rows: int64 counts,
// or weighted sums (weights.cuh).
//
// The one template behind the xh_slot_* entries (slot.cu, slot_narrow.cu,
// slot_mixed.cu, slot_w*.cu), which run plan()'s routes factored,
// factored_per_row and factored_packed, and direct outside direct.cuh's
// envelope: a run-time reduce_all is all that tells them apart. Each input k is an (m1,
// m0, c1, c0) view of data type T (kept rows r = i1 * m0 + i0, columns j =
// j1 * c0 + j0; tile.cuh) with its own non-negative strides on each level,
// read in place (a broadcast input has stride 0 on a level, a halo-trimmed
// or transposed one its own strides), and its own nb_k + 1 compare-form
// thresholds (digitize.cuh). An element counts iff no input's value is NaN
// or out of range, and then adds one to its flat slot
//   g = ((t_0 * nb_1 + t_1) * nb_2 + ...) + t_{n-1},  t_k its bin on input k,
// computed in 64 bits (a forced call may have 2^31 slots or more). Output:
// int64 (1 or m, S + 1) with S = prod(nb_k); slot S is the trash slot and
// stays zero. A weighted instantiation (policy xh::Sum<A>) adds the
// element's weight, a view with its own strides, in place of one,
// into accumulators and an output of type A (weights.cuh); its shared
// histograms take sizeof(A) bytes a slot, so float64 and 64-bit integer
// sums keep half as many slots in a block as the 32-bit counters.
//
// Each element is digitized once per input and counted with one atomic.
// The thresholds of all inputs, and a cell table for each, are staged in
// shared memory when they fit (227 KB a block), and the search is the
// bucketed one of digitize.cuh; otherwise each search is a binary search of
// the thresholds in device memory. Where the slots go:
// - one block's shared memory (S <= max_shared_slots and S fits beside the
//   thresholds): one histogram per row of the tile (tile.cuh), or, for a
//   full reduction, one per block in up to 16 warp-private replicas
//   against hot bins; 32-bit counters, flushed into the int64 output.
// - a cluster's shared memory (S fits C = 2, 4 or 8 blocks, C <=
//   max_cluster): the histogram of one row (or of the full reduction) is
//   spread over the cluster in runs of 32 slots, run g / 32 in block
//   (g / 32) % C, and every element adds with one atomic in its owner's
//   shared memory (distributed shared memory for another block's). The
//   cluster walks its tiles together: one row a tile, each row cut into
//   the column tiles that balance the tiles over the resident clusters
//   against a flush per tile. Float weights (Sum<double>) past one block's
//   room for float64 slots take it for kept rows only, as exact integers
//   (weights.cuh's Exact) in 32-bit words, so in as few blocks as counts
//   (one, where 4 bytes a slot fit one block): a float64 shared atomic is
//   a compare-and-swap loop, slower than device memory's native float64
//   add, while a word takes one native 32-bit atomic, and only where it
//   wraps (an add of w does so with odds of about |w| / 2^(u + 32)) a
//   float64 add of the wrap into the output. A prologue kernel first finds the largest finite
//   |weight| of the weights' own storage (a broadcast level read once),
//   from which every block takes the call's unit 2^u; a weight that is not
//   a whole multiple of it, or not finite, adds into the output in device
//   memory as it would without the cluster, and counts in a tally of such
//   elements.
// - device memory (more slots than that, or max_shared_slots == 0): every
//   element adds one with a 64-bit atomic straight into the zeroed int64
//   output, which stays in the card's 50 MB L2 cache up to about six
//   million slots.
// A tile of whole kept rows stores every slot of its rows, zeros and the
// trash slot included, so the output needs no zeroing pass; a row split over
// column tiles, a full reduction, and exact sums (whose weights that fall
// back add into the output), add with 64-bit atomics into an output the
// launcher zeroes first.
// The input count is read at run time, except for two inputs, the common
// case, which get kernels of their own with both inputs' loads and
// searches unrolled.
// A kept row of several runs of columns (the README call's (time, depth,
// cell) view with axis=(0, 2)) is walked in run pieces (tile.cuh's
// run_tiling). Where both inputs, and the weights, are read at stride 1
// along the columns, at most 4 bytes an element, and every run starts on a
// boundary of kUnroll elements (the launcher's vector_reads), a two-input
// kernel walks each run of a piece in turn, a group of kUnroll neighbouring
// columns a thread: one load of each input (8 bytes of int16, 16 of
// float32) and one of the group's weights, all issued before the first
// search, so the three round trips overlap. A run's first addresses are
// computed once a run, each input's cell map and first step held for the
// piece, and its other constants read from the kernel's parameters, which
// take no registers (H100, GLORYS12V1's call: 71.1 ms where the same loads
// with the addresses computed at every step took 91.7, spilling more;
// PERF.md §6). The columns past a run's last whole group are then walked
// element by element. Every element's weight is read, counted or not. Every
// other piece is walked element by element, each element at its (fast,
// slow) position, its weight read once its slot is known.
//
// Inputs of one wide type T (float, double, int32, int64) share an
// instantiation. Two instantiations read each input's
// stored type as a run-time code (narrow.cuh's load codes, the same in
// every lane) and widen it in registers, so narrow data is read in place
// at its own width:
// - T = Narrow (slot_narrow.cu): float32 data and the narrow types (bool,
//   int8, uint8, int16, uint16, float16, bfloat16), in any mix, all
//   compared in float32 against float32 thresholds (int32 ones converted
//   for the integers: a threshold past 2^24 rounds, but stays past every 8-
//   and 16-bit value). It has the two-input kernel too.
// - T = Mixed (slot_mixed.cu): every other mix of types (int32, int64 or
//   float64 beside inputs of another type: int32 beside float32, float32
//   beside float64, int32 beside int64, int64 beside a float, narrow data
//   beside the wide types; uint32 and uint64 beside anything): an int64,
//   uint32 or uint64 input compares in int64 (uint64 flipped, narrow.cuh)
//   and any other in double, to
//   which all the rest convert exactly, each against its own thresholds in
//   that type; its cell map runs in double, as for int64 data. It is rare,
//   so it has no two-input kernel of its own.
// In both, 8-bit data (int8, uint8, bool as bytes) whose thresholds are
// staged is digitized through a table of its 256 values' bins, built in
// each block's prologue by the same search: one shared-memory load an
// element and input.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, without
// --use_fast_math (digitize.cuh).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "digitize.cuh"
#include "launch.cuh"
#include "narrow.cuh"
#include "tile.cuh"
#include "weights.cuh"

// Each including file gets its own copy of the kernels and launch caches.
namespace {
namespace slot {

namespace cg = cooperative_groups;

constexpr int kMaxInputs = 32;
constexpr int kThreads = 512;
// a cluster's blocks each fill an SM's shared memory alone, so they take
// twice the threads; either way registers are capped at 64 a thread
constexpr int kClusterThreads = 1024;
constexpr int kWarps = kThreads / 32;
// a cluster's blocks own a row's slots in runs of 32, so a warp's flush
// stores 32 neighbouring slots
constexpr int kRunBits = 5;
constexpr int kUnroll = 4;
constexpr int kMaxCluster = 8;
constexpr long long kMinTile = (long long)kThreads * kUnroll;
// shared histogram bytes a block aims for (48 KB): several kept rows a
// tile, or warp replicas of a full reduction
constexpr long long kHistBytes = 48 * 1024;

// The instantiations of inputs with run-time stored types: see the header.
struct Mixed {};
struct Narrow {};
template <typename T>
constexpr bool kMixed = std::is_same<T, Mixed>::value;
template <typename T>
constexpr bool kNarrow = std::is_same<T, Narrow>::value;
template <typename T>
constexpr bool kCoded = kMixed<T> || kNarrow<T>;
template <typename W>
constexpr bool kExact = std::is_same<W, xh::Exact>::value;
// The compare type: T, double when mixed (int64 inputs aside), float for
// Narrow.
template <typename T>
using Cmp = typename std::conditional<
    kMixed<T>, double, typename std::conditional<kNarrow<T>, float, T>::type>::type;
// Each staged threshold slot: the compare type, or 8 bytes (int64 or
// double) when mixed.
template <typename T>
using Stored = typename std::conditional<kMixed<T>, long long, Cmp<T>>::type;
// Each input's cell map: CellMap<double> when mixed, which has the layout
// of CellMap<long long>.
template <typename T>
using Map = xh::CellMap<Cmp<T>>;

struct InputBase {
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
  int cells;  // cells asked for its table
};

// Mixed and Narrow: the stored type (narrow.cuh's load codes; when mixed,
// int64 compares in int64, the rest in double), and, for 8-bit data whose
// thresholds are staged, the first int of its table of 256 bins in shared
// memory (else -1).
struct Coded : InputBase {
  int code;
  int lut;
};

template <typename T>
struct Input : InputBase {};
template <>
struct Input<Mixed> : Coded {};
template <>
struct Input<Narrow> : Coded {};

template <typename T>
struct Inputs {
  Input<T> in[kMaxInputs];
  int n;
};

// 227 KB a block, less the kernel's static shared memory (the input table,
// the cell maps, the windows' widths and the tiles' corners)
template <typename T>
constexpr size_t kSmemMax = 232448 - (sizeof(Input<T>) + sizeof(Map<T>) +
                                      sizeof(int) + 2 * sizeof(long long)) * kMaxInputs - 64;

struct Mode {
  size_t thr_bytes;    // staged thresholds' shared bytes; 0: searched in place
  size_t stage_bytes;  // thresholds and cell tables: the histogram's offset
  long long s_local;   // slots of a row each block of a cluster holds
  int log2c;           // log2 of the blocks a cluster
  int reduce_all;
  int whole_rows;  // each tile holds whole rows and stores all their slots
  int vec;         // run pieces read kUnroll neighbours a thread (vector_reads)
  // exact sums: the largest finite |weight|, as its bits, then the tally of
  // elements whose weight added as a float (the caller's 16 bytes)
  unsigned long long* exact;
};

// Where a piece of a view lies: the offset of its corner, and the strides
// of its fast and slow dimensions (rows and columns of a tile, or a run
// piece's columns and runs).
struct Walk {
  long long origin;
  long long fast;
  long long slow;
};

// The Walk of a view of strides (sm1, sm, sc1, sc) over the piece k.
template <typename V>
__device__ __forceinline__ Walk walk_of(const V& d, const xh::Corner& k,
                                        const xh::Tiling& tl) {
  Walk v;
  v.origin = xh::corner_offset(k, d.sm1, d.sm, d.sc1, d.sc);
  v.fast = tl.row_fast ? d.sm : d.sc;
  v.slow = tl.runs ? d.sc1 : tl.row_fast ? d.sc : d.sm;
  return v;
}

// at[u]: the offset of the element at f[u] along the fast and s[u] along
// the slow dimension of the piece that v maps.
template <int K>
__device__ __forceinline__ void offsets(const Walk& v, const unsigned (&f)[K],
                                        const unsigned (&s)[K], long long (&at)[K]) {
#pragma unroll
  for (int u = 0; u < K; ++u) at[u] = v.origin + f[u] * v.fast + s[u] * v.slow;
}

// bin[u]: the bin of input d's value at f[u] along the fast and s[u] along
// the slow dimension of the piece that v maps, read and compared as C, or
// -1; against its thresholds staged (skewed) at t with cell map mp, cell
// table win and widest window widest when `staged`, else searched in
// device memory.
template <typename C, int K>
__device__ __forceinline__ void input_bins(
    const InputBase& d, const C* t, const xh::CellMap<C>& mp, const int2* win,
    int widest, bool staged, const Walk& v, const unsigned (&f)[K],
    const unsigned (&s)[K], const bool (&ok)[K], int (&bin)[K]) {
  const C* base = static_cast<const C*>(d.data) + v.origin;
  C x[K];
#pragma unroll
  for (int u = 0; u < K; ++u)
    x[u] = ok[u] ? C(base[f[u] * v.fast + s[u] * v.slow]) : C(0);
  if (staged)
    xh::bins_bucketed<C, K>(t, d.nb, mp, win, xh::first_step(widest), x, bin);
  else
    xh::bins_of<C, K, false>(static_cast<const C*>(d.thr), d.nb, x, bin);
}

// bin[u]: as input_bins, for a Mixed input held as int64 (int64, uint32,
// uint64 flipped; narrow.cuh's held_int64), compared in int64.
template <int K>
__device__ __forceinline__ void held_bins(
    const Coded& d, const long long* t, const xh::CellMap<long long>& mp,
    const int2* win, int widest, bool staged, const Walk& v, const unsigned (&f)[K],
    const unsigned (&s)[K], const bool (&ok)[K], int (&bin)[K]) {
  long long at[K];
  offsets<K>(v, f, s, at);
  long long x[K];
  xh::gather_mixed<K>(d.data, at, ok, d.code, x);
  if (staged)
    xh::bins_bucketed<long long, K>(t, d.nb, mp, win, xh::first_step(widest), x, bin);
  else
    xh::bins_of<long long, K, false>(static_cast<const long long*>(d.thr), d.nb, x, bin);
}

// bin[u]: as input_bins, for an input whose stored type is its run-time
// code, widened to C: through its 8-bit table in luts where it has one.
template <typename C, int K>
__device__ __forceinline__ void coded_bins(
    const Coded& d, const C* t, const xh::CellMap<C>& mp, const int2* win,
    int widest, bool staged, const int* luts, const Walk& v, const unsigned (&f)[K],
    const unsigned (&s)[K], const bool (&ok)[K], int (&bin)[K]) {
  long long at[K];
  offsets<K>(v, f, s, at);
  C x[K];
  xh::gather_coded<C, K>(d.data, at, ok, d.code, x);
  if (d.lut >= 0) {
    const int* lut = luts + d.lut;
#pragma unroll
    for (int u = 0; u < K; ++u) bin[u] = lut[xh::byte_of(x[u])];
  } else if (staged) {
    xh::bins_bucketed<C, K>(t, d.nb, mp, win, xh::first_step(widest), x, bin);
  } else {
    xh::bins_of<C, K, false>(static_cast<const C*>(d.thr), d.nb, x, bin);
  }
}

// g[u]: the flat slot of element u, at f[u] along the fast and s[u] along
// the slow dimension of the piece (org[i] maps it in input i), or -1 where
// ok[u] is false or any input's value is NaN or out of range. t: every
// input's thresholds staged (skewed) in shared memory, with its cell map
// maps[i], cell table at win + toff and widest window widest[i], when
// `staged`; else each input's are searched in device memory. kN: the input
// count n when it is known at compile time (0: read n at run time).
template <typename T, int K, int kN>
__device__ __forceinline__ void flat_slots(
    const Input<T>* in, int n, const Stored<T>* t, const Map<T>* maps,
    const int2* win, const int* widest, bool staged, const int* luts,
    const Walk* org, const unsigned (&f)[K], const unsigned (&s)[K],
    const bool (&ok)[K], long long (&g)[K]) {
  bool valid[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    g[u] = 0;
    valid[u] = ok[u];
  }
#pragma unroll
  for (int i = 0; i < (kN ? kN : n); ++i) {
    const Input<T> d = in[i];
    int bin[K];
    if constexpr (kCoded<T>) {
      const Map<T> mp = maps[i];
      const int2* w = win + d.toff;
      if (kMixed<T> && xh::held_int64(d.code))
        held_bins<K>(d, reinterpret_cast<const long long*>(t + d.soff),
                     xh::CellMap<long long>{mp.lo, mp.inv, mp.k}, w, widest[i], staged,
                     org[i], f, s, ok, bin);
      else
        coded_bins<Cmp<T>, K>(d, reinterpret_cast<const Cmp<T>*>(t + d.soff), mp, w,
                              widest[i], staged, luts, org[i], f, s, ok, bin);
    } else {
      input_bins<T, K>(d, t + d.soff, maps[i], win + d.toff, widest[i],
                          staged, org[i], f, s, ok, bin);
    }
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

// The two-input kernels of inputs of at most 4 bytes (float32, int32 and
// Narrow) whose kept rows' histograms are in shared memory read their run
// pieces by groups of kUnroll neighbouring columns where the launcher finds
// every run of every input, and of the weights (of at most 4 bytes), on a
// boundary of such a group (vector_reads): one load an input and one of the
// weights a group, all issued before the group's first search.
template <typename T, typename W, bool kShared, int kN>
constexpr bool kVector = kN == 2 && kShared && !kMixed<T> && sizeof(Stored<T>) == 4 &&
                         !std::is_same<typename W::Shared, unsigned long long>::value;

// The bytes of one element of input d as stored.
template <typename T>
__host__ __device__ __forceinline__ int bytes_of(const Input<T>& d) {
  if constexpr (kNarrow<T>)
    return xh::code_bytes(d.code);
  else
    return (int)sizeof(T);
}

// bin[u]: the bin of element u of a group of kUnroll neighbours of input d
// loaded by load_four, or -1: through its 8-bit table where it has one, else
// by the bucketed search of its thresholds staged at t with cell map mp,
// cell tables win and first step step0.
template <typename T>
__device__ __forceinline__ void group_bins(const Input<T>& d, const uint4& r,
                                           const Stored<T>* t, const Map<T>& mp,
                                           const int2* win, int step0, const int* luts,
                                           int (&bin)[kUnroll]) {
  Cmp<T> x[kUnroll];
  if constexpr (kNarrow<T>) {
    if (d.lut >= 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) bin[u] = luts[d.lut + xh::bits_of(r, u, 1)];
      return;
    }
    xh::four_of(r, d.code, x);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __uint_as_float(xh::bits_of(r, u, 4));
  } else {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = (T)xh::bits_of(r, u, 4);
  }
  xh::bins_bucketed<Cmp<T>, kUnroll>(reinterpret_cast<const Cmp<T>*>(t + d.soff), d.nb, mp,
                                     win + d.toff, step0, x, bin);
}

// Whether every run piece of a view (data, of `bytes` bytes an element,
// strides (sm1, sm, sc1, sc) over dims) starts each run on a boundary of
// kUnroll elements, with the columns at stride 1: the piece's corner, i1 sm1
// + i0 sm + j1 sc1 (j0 is 0), is then a multiple of kUnroll, and so is each
// run's start.
inline bool grouped(const void* data, long long sm1, long long sm, long long sc1,
                    long long sc, int bytes, const xh::Dims& dims) {
  return sc == 1 && bytes <= 4 &&
         reinterpret_cast<unsigned long long>(data) % (unsigned)(kUnroll * bytes) == 0 &&
         (dims.m1 == 1 || sm1 % kUnroll == 0) && (dims.m0 == 1 || sm % kUnroll == 0) &&
         (dims.c1 == 1 || sc1 % kUnroll == 0);
}

// Whether a launch's run pieces take the vector walk (kVector): both
// inputs' views and the weights' are grouped.
template <typename T, typename W>
bool vector_reads(const Inputs<T>& p, const xh::Weights& w, const xh::Dims& dims) {
  for (int k = 0; k < 2; ++k) {
    const Input<T>& d = p.in[k];
    if (!grouped(d.data, d.sm1, d.sm, d.sc1, d.sc, bytes_of(d), dims)) return false;
  }
  if constexpr (W::kWeighted) {
    using Wt = typename std::conditional<kExact<W>, double, typename W::Shared>::type;
    return grouped(w.data, w.sm1, w.sm, w.sc1, w.sc, xh::weight_bytes<Wt>(w.code), dims);
  }
  return true;
}

// The slot of a row held at local index l by block `rank` of a cluster of
// 1 << log2c blocks (runs of 32 slots dealt round the cluster).
__device__ __forceinline__ long long slot_of(long long l, int log2c, int rank) {
  return log2c == 0 ? l
                    : ((((l >> kRunBits) << log2c) + rank) << kRunBits) + (l & 31);
}

// A weights' view walked once per stored element: four levels of n[k]
// elements at stride st[k], a broadcast level (stride 0) as one element,
// the last level the one of least stride.
struct Levels {
  long long n[4];
  long long st[4];
};

inline Levels levels_of(const xh::Weights& w, const xh::Dims& d) {
  Levels lv = {{d.m1, d.m0, d.c1, d.c0}, {w.sm1, w.sm, w.sc1, w.sc}};
  for (int k = 0; k < 4; ++k)
    if (lv.st[k] == 0) lv.n[k] = 1;
  int inner = 3;
  for (int k = 0; k < 3; ++k)
    if (lv.n[k] > 1 && (lv.n[inner] == 1 || lv.st[k] < lv.st[inner])) inner = k;
  std::swap(lv.n[inner], lv.n[3]);
  std::swap(lv.st[inner], lv.st[3]);
  return lv;
}

constexpr int kAmaxThreads = 256;
constexpr long long kAmaxChunk = 16 * kAmaxThreads;  // elements a block takes at once

// Exact sums' prologue: the largest finite |weight| over the weights'
// stored elements (lv), as the bits of a non-negative double (whose order
// is theirs as unsigned integers), into *amax, which the launcher zeroes.
__global__ void __launch_bounds__(kAmaxThreads)
weight_amax_kernel(const void* w, int code, Levels lv, unsigned long long* amax) {
  const long long cpl = (lv.n[3] + kAmaxChunk - 1) / kAmaxChunk;  // chunks a line
  const long long items = lv.n[0] * lv.n[1] * lv.n[2] * cpl;
  double m = 0.0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    long long line = it / cpl;
    const long long j0 = (it - line * cpl) * kAmaxChunk;
    const long long i2 = line % lv.n[2];
    line /= lv.n[2];
    const long long i1 = line % lv.n[1];
    const long long i0 = line / lv.n[1];
    const long long base = i0 * lv.st[0] + i1 * lv.st[1] + i2 * lv.st[2];
    const long long end = j0 + kAmaxChunk < lv.n[3] ? j0 + kAmaxChunk : lv.n[3];
    for (long long j = j0 + threadIdx.x; j < end; j += kAmaxThreads) {
      double v;
      xh::load_weight(w, base + j * lv.st[3], code, v);
      if (isfinite(v)) m = fmax(m, fabs(v));
    }
  }
  __shared__ double part[kAmaxThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmax(m, __shfl_down_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kAmaxThreads / 32; ++k) m = fmax(m, part[k]);
    if (m > 0.0) atomicMax(amax, (unsigned long long)__double_as_longlong(m));
  }
}

// A slot's sum as the output takes it: Exact's integer times the unit 2^u
// (rounded once), the others' as they are.
template <typename W>
__device__ __forceinline__ typename W::Out flushed(typename W::Shared s, int u) {
  if constexpr (kExact<W>)
    return scalbn((double)s, u);
  else
    return typename W::Out(s);
}

// W: xh::Count (adds one), xh::Sum<A> (adds the weight in w) or xh::Exact
// (adds the float weight in w as an integer of the unit; kShared only).
template <typename T, typename W, bool kShared, int kN>
__global__ void __launch_bounds__(kClusterThreads, 1)
slot_hist_kernel(const Inputs<T> p, const xh::Weights w, xh::Dims dims,
                 long long S, xh::Tiling tl, Mode md,
                 typename W::Out* __restrict__ out) {
  using Shared = typename W::Shared;
  using Out = typename W::Out;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Input<T> in[kMaxInputs];
  __shared__ Map<T> maps[kMaxInputs];
  __shared__ int widest[kMaxInputs];
  // each input's offset of the piece's corner and its fast and slow
  // strides, mapped once a piece, in two buffers by the piece's parity (one
  // barrier a piece)
  __shared__ Walk walk[2][kMaxInputs];
  const int n = p.n;
#pragma unroll
  for (int k = 0; k < kMaxInputs; ++k)  // static indices: no local copy of p
    if (threadIdx.x == k && k < n) in[k] = p.in[k];
  __syncthreads();

  // t always points into shared memory, so the searches load from it with
  // shared-memory instructions rather than generic ones
  Stored<T>* t = reinterpret_cast<Stored<T>*>(smem);
  int2* win = reinterpret_cast<int2*>(smem + md.thr_bytes);
  const bool staged = md.thr_bytes != 0;
  if (staged) {
    for (int i = 0; i < n; ++i)
      xh::stage_thresholds(t + in[i].soff,
                           static_cast<const Stored<T>*>(in[i].thr), in[i].nb + 1);
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if constexpr (kMixed<T>) {
        if (xh::held_int64(in[i].code)) {
          const xh::CellMap<long long> mp =
              xh::cell_map(t + in[i].soff, in[i].nb, in[i].cells);
          if (threadIdx.x == 0) maps[i] = {mp.lo, mp.inv, mp.k};
          xh::build_cells(t + in[i].soff, in[i].nb, mp, win + in[i].toff,
                          &widest[i]);
        } else {
          const double* dt = reinterpret_cast<const double*>(t + in[i].soff);
          const xh::CellMap<double> mp = xh::cell_map(dt, in[i].nb, in[i].cells);
          if (threadIdx.x == 0) maps[i] = mp;
          xh::build_cells(dt, in[i].nb, mp, win + in[i].toff, &widest[i]);
        }
      } else {
        const Map<T> mp = xh::cell_map(t + in[i].soff, in[i].nb, in[i].cells);
        if (threadIdx.x == 0) maps[i] = mp;
        xh::build_cells(t + in[i].soff, in[i].nb, mp, win + in[i].toff,
                        &widest[i]);
      }
      if constexpr (kCoded<T>) {
        // 8-bit data: its 256 values' bins, by the search just built (maps[i]
        // and widest[i] were written before build_cells' last barrier)
        if (in[i].lut >= 0)
          xh::build_byte_table(reinterpret_cast<const Cmp<T>*>(t + in[i].soff),
                               in[i].nb, maps[i], win + in[i].toff,
                               xh::first_step(widest[i]), in[i].code,
                               reinterpret_cast<int*>(smem) + in[i].lut);
      }
    }
  }

  cg::cluster_group cluster = cg::this_cluster();
  const int log2c = md.log2c;
  const int cl = 1 << log2c;  // blocks a cluster
  const int rank = cl > 1 ? (int)cluster.block_rank() : 0;
  const long long s_local = md.s_local;
  Shared* hist = reinterpret_cast<Shared*>(smem + md.stage_bytes);
  const long long one_copy = (md.reduce_all ? 1 : tl.rows) * s_local;
  if (kShared)
    for (long long k = threadIdx.x; k < one_copy * tl.copies; k += blockDim.x)
      hist[k] = Shared(0);
  __syncthreads();
  if (kShared && cl > 1) cluster.sync();  // zeroed before another's add
  Shared* mine = hist + (threadIdx.x / 32) % tl.copies * one_copy;
  const long long out_row = S + 1;
  // Exact: the call's unit 2^u, and this thread's elements whose weight
  // added as a float
  int unit = 0;
  double inv = 0.0;  // 2^-u
  unsigned long long fell = 0;
  if constexpr (kExact<W>) {
    unit = xh::exact_unit(__longlong_as_double((long long)*md.exact));
    inv = scalbn(1.0, -unit);
  }

  const int* luts = reinterpret_cast<const int*>(smem);  // the 8-bit tables
  // the blocks of a cluster walk each of its tiles together, as one
  // block of lanes threads would
  const unsigned lanes = blockDim.x << log2c;
  const unsigned tid = rank * blockDim.x + threadIdx.x;
  xh::PieceLoop pl = xh::piece_loop(tl, dims, blockIdx.x >> log2c, gridDim.x >> log2c);
  xh::Corner tc;
  bool flush;
  int parity = 0;
  while (xh::next_piece(pl, tl, dims, tc, flush)) {
    parity ^= 1;
    if (threadIdx.x < n) walk[parity][threadIdx.x] = walk_of(in[threadIdx.x], tc, tl);
    __syncthreads();
    const Walk* org = walk[parity];
    const long long r0 = tc.r0;
    const unsigned rr = tc.rr;
    const unsigned cc = tc.cc;
    const Walk ww = walk_of(w, tc, tl);  // the weights' (all zero unweighted)
    // each counted element's weight (Exact: the float weight, as loaded)
    using Wt = typename std::conditional<kExact<W>, double, Shared>::type;

    // adds each element u with g[u] >= 0 (g: int or long long): its weight,
    // weight(u), into slot g[u] of row row[u] of the piece
    auto add = [&](const auto& g, const auto& weight, const unsigned (&row)[kUnroll]) {
      if constexpr (kExact<W>) {
        // every element's word add first, then the few wraps: the returning
        // atomics' round trips overlap
        bool added[kUnroll];
        unsigned lo[kUnroll];
        unsigned old[kUnroll];
        bool neg[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          added[u] = false;
          if (g[u] < 0) continue;
          const Wt wu = weight(u);
          unsigned m;
          if (!xh::exact_integer(wu, inv, m, neg[u])) {
            atomicAdd(&out[(md.reduce_all ? 0 : r0 + row[u]) * out_row + g[u]], wu);
            ++fell;
            continue;
          }
          if (m == 0) continue;
          const long long run = g[u] >> kRunBits;
          Shared* h = cl == 1 ? &mine[row[u] * s_local + g[u]]
                              : cluster.map_shared_rank(hist, (int)(run & (cl - 1))) +
                                    row[u] * s_local + ((run >> log2c) << kRunBits) +
                                    (g[u] & 31);
          added[u] = true;
          lo[u] = xh::exact_low(m, neg[u]);
          old[u] = atomicAdd(h, lo[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (added[u]) {
            const int wrap = xh::exact_wrap(old[u], lo[u], neg[u]);
            if (wrap != 0)
              atomicAdd(&out[(md.reduce_all ? 0 : r0 + row[u]) * out_row + g[u]],
                        scalbn((double)wrap, unit + 32));
          }
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (g[u] < 0) continue;
          if (kShared && cl == 1) {
            atomicAdd(&mine[row[u] * s_local + g[u]], weight(u));
          } else if (kShared) {
            const long long run = g[u] >> kRunBits;
            const long long slot = row[u] * s_local +
                                   ((run >> log2c) << kRunBits) + (g[u] & 31);
            atomicAdd(cluster.map_shared_rank(hist, (int)(run & (cl - 1))) + slot,
                      weight(u));
          } else {
            atomicAdd(&out[(md.reduce_all ? 0 : r0 + row[u]) * out_row + g[u]],
                      (Out)weight(u));
          }
        }
      }
    };

    // the columns [first, first + fast_n) of each run of the piece (a
    // tile's rows and columns: first = 0, its whole width), kUnroll elements
    // a thread a step, each on its own; (f, s): a thread's position along
    // the fast and the slow dimension, advanced by `lanes` elements a step
    // without a division
    auto walk_elements = [&](unsigned first, unsigned fast_n, unsigned total) {
      const unsigned df = lanes % fast_n;
      const unsigned ds = lanes / fast_n;
      unsigned f = tid % fast_n;
      unsigned s = tid / fast_n;
      for (unsigned k = tid; k < total; k += kUnroll * lanes) {
        unsigned fs[kUnroll];
        unsigned ss[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          ok[u] = k + u * lanes < total;
          fs[u] = first + f;
          ss[u] = s;
          f += df;
          s += ds;
          if (f >= fast_n) {
            f -= fast_n;
            ++s;
          }
        }
        long long g[kUnroll];
        flat_slots<T, kUnroll, kN>(in, n, t, maps, win, widest, staged, luts, org, fs,
                                   ss, ok, g);
        Wt wt[kUnroll];
        if constexpr (W::kWeighted) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            wt[u] = Wt(0);
            if (g[u] >= 0)
              xh::load_weight(w.data, ww.origin + fs[u] * ww.fast + ss[u] * ww.slow,
                              w.code, wt[u]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) wt[u] = Wt(1);
        }
        // (a piece of one row: its row 0, whatever the slow dimension)
        unsigned row[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          row[u] = md.reduce_all || rr == 1 ? 0 : (tl.row_fast ? fs[u] : ss[u]);
        add(g, [&](int u) { return wt[u]; }, row);
      }
    };

    // a run piece's vector walk takes each run's whole groups of kUnroll
    // columns; the element walk then takes the columns past them
    unsigned f0 = 0;
    if constexpr (kVector<T, W, kShared, kN>) {
      if (md.vec) {  // one row, whole runs of cc columns (run_tiling)
        const unsigned groups = cc / kUnroll;
        f0 = groups * kUnroll;
        if (groups > 0) {
          // each input's constants are read from the kernel's parameters,
          // its cell map and first step held for the piece
          const Input<T>& d0 = p.in[0];
          const Input<T>& d1 = p.in[1];
          const Map<T> mp0 = maps[0];
          const Map<T> mp1 = maps[1];
          const int step0 = xh::first_step(widest[0]);
          const int step1 = xh::first_step(widest[1]);
          const int bw = W::kWeighted ? xh::weight_bytes<Wt>(w.code) : 0;
          // run by run, each run's groups dealt over the piece's lanes: a
          // run's first element of each input and of the weights is
          // addressed once a run
          for (unsigned s = 0; s < tc.cj; ++s) {
            const char* a0 = static_cast<const char*>(d0.data) +
                             (org[0].origin + (long long)s * org[0].slow) * bytes_of(d0);
            const char* a1 = static_cast<const char*>(d1.data) +
                             (org[1].origin + (long long)s * org[1].slow) * bytes_of(d1);
            const char* aw = static_cast<const char*>(w.data) +
                             (ww.origin + (long long)s * ww.slow) * bw;
            for (unsigned q = tid; q < groups; q += lanes) {
              // every load of the group is issued before the first search:
              // the weights' round trip overlaps the data's
              const uint4 v0 =
                  xh::load_four(a0 + (size_t)q * (kUnroll * bytes_of(d0)), bytes_of(d0));
              const uint4 v1 =
                  xh::load_four(a1 + (size_t)q * (kUnroll * bytes_of(d1)), bytes_of(d1));
              uint4 vw;
              if constexpr (W::kWeighted) vw = xh::load_four(aw + (size_t)q * (kUnroll * bw), bw);
              int i0[kUnroll];
              int i1[kUnroll];
              group_bins(d0, v0, t, mp0, win, step0, luts, i0);
              group_bins(d1, v1, t, mp1, win, step1, luts, i1);
              // (a slot of a histogram in shared memory: below 2^31)
              int g[kUnroll];
#pragma unroll
              for (int u = 0; u < kUnroll; ++u)
                g[u] = i0[u] >= 0 && i1[u] >= 0 ? i0[u] * d1.nb + i1[u] : -1;
              const unsigned row[kUnroll] = {};  // the piece's one row
              // each weight unpacked where it is added
              add(g, [&](int u) {
                Wt x = Wt(1);
                if constexpr (W::kWeighted) xh::weight_of_four(vw, u, w.code, x);
                return x;
              }, row);
            }
          }
        }
      }
    }
    if (f0 == 0)
      walk_elements(0, tl.row_fast ? rr : cc, rr * cc * tc.cj);
    else if (f0 < cc)
      walk_elements(f0, cc - f0, (cc - f0) * tc.cj);

    if (kShared && !md.reduce_all) {
      // a chunk's next tile of the same rows adds into their histograms
      // first (the same decision in every block of the cluster)
      if (!flush) continue;
      if (cl > 1)
        cluster.sync();  // every add of the tile landed
      else
        __syncthreads();
      // this block's slots of each row, and the trash slot S by its owner
      // (one block: l = S)
      for (unsigned r = 0; r < rr; ++r) {
        Out* dst = out + (r0 + r) * out_row;
        for (long long l = threadIdx.x; l < s_local + (cl == 1); l += blockDim.x) {
          const long long sl = slot_of(l, log2c, rank);
          if (sl > S) break;  // l rises, and with it sl
          Out v = 0;  // sl == S: the trash slot, zero
          if (sl < S)
            for (int cp = 0; cp < tl.copies; ++cp) {
              Shared* h = hist + cp * one_copy + r * s_local + l;
              v += flushed<W>(*h, unit);
              *h = Shared(0);
            }
          if (md.whole_rows)
            dst[sl] = v;
          else if (v != Out(0))  // NaN != 0: a NaN sum is added
            atomicAdd(&dst[sl], v);
        }
      }
      if (cl > 1)
        cluster.sync();  // zeroed again before the next tile's adds
      else
        __syncthreads();
    }
  }

  if (kShared && md.reduce_all) {
    if (cl > 1)
      cluster.sync();
    else
      __syncthreads();
    for (long long l = threadIdx.x; l < s_local; l += blockDim.x) {
      const long long sl = slot_of(l, log2c, rank);
      if (sl >= S) break;
      Out v = 0;
      for (int cp = 0; cp < tl.copies; ++cp) v += flushed<W>(hist[cp * one_copy + l], unit);
      if (v != Out(0)) atomicAdd(&out[sl], v);
    }
  }

  if constexpr (kExact<W>) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) fell += __shfl_down_sync(0xffffffffu, fell, o);
    if (threadIdx.x % 32 == 0 && fell != 0) atomicAdd(md.exact + 1, fell);
  }
}

// Kept rows over a cluster, the columns one run: one row a tile, each row
// cut into ct column tiles, ct minimising the rounds of tiles over the
// resident clusters times a round's work (a tile's elements and the S slots
// it flushes). Rows of several runs take run_tiling instead.
inline xh::Tiling cluster_row_tiling(const xh::Dims& d, bool row_fast, long long S,
                                     long long resident) {
  const long long m = d.m1 * d.m0;
  long long best_ct = 1;
  double best = -1.0;
  for (long long ct = 1; ct <= d.c0 && ct <= 4096; ++ct) {
    const double cost = (double)xh::ceil_div(m * ct, resident) *
                        (double)(xh::ceil_div(d.c0, ct) + S);
    if (best < 0 || cost < best) {
      best = cost;
      best_ct = ct;
    }
  }
  xh::Tiling tl = {};
  tl.row_fast = row_fast;
  tl.copies = 1;
  tl.rows = 1;
  tl.cols = xh::ceil_div(d.c0, best_ct);
  xh::count_tiles(tl, d);
  return tl;
}

template <typename T, typename W, bool kShared, int kN>
int launch_kernel(const Inputs<T>& p, const xh::Weights& w, const xh::Dims& dims,
                  long long S, long long most_counters, bool row_fast, Mode md,
                  void* out, cudaStream_t stream) {
  using Shared = typename W::Shared;
  using Out = typename W::Out;
  static xh::ClusterShape shape;
  const int cl = 1 << md.log2c;
  // (exact sums past one block's float64 room fill an SM's shared memory
  // even in one block)
  const int threads = cl > 1 || kExact<W> ? kClusterThreads : kThreads;
  const size_t smem_most =
      md.stage_bytes + sizeof(Shared) * (size_t)most_counters;
  long long resident = 0;  // clusters
  cudaError_t err =
      shape.get((const void*)slot_hist_kernel<T, W, kShared, kN>, threads,
                smem_most, cl, &resident);
  if (err != cudaSuccess) return (int)err;

  xh::Tiling tl;
  size_t smem = md.stage_bytes;
  // a kept row of several runs of columns, one row a tile: pieces of whole
  // runs, each cluster a contiguous range of (row, run) pairs
  const bool by_runs = kShared && !md.reduce_all && dims.c1 > 1 && dims.c0 < (1LL << 31);
  if (kShared && cl > 1) {
    tl = md.reduce_all ? xh::make_tiling(dims, row_fast, xh::kMaxTile, kMinTile, resident)
         : by_runs     ? xh::run_tiling(dims, resident)
                       : cluster_row_tiling(dims, row_fast, S, resident);
    smem = smem_most;  // one histogram share, no replicas
  } else {
    const long long max_rows =
        kShared && !md.reduce_all ? most_counters / S : xh::kMaxTile;
    tl = xh::make_tiling(dims, row_fast, max_rows > 0 ? max_rows : 1, kMinTile,
                         resident);
    if (by_runs && tl.rows == 1) tl = xh::run_tiling(dims, resident);
    if (kShared) {
      const long long one_copy = (md.reduce_all ? 1 : tl.rows) * S;
      const long long copies = most_counters / one_copy;
      tl.copies = copies < 1 ? 1 : copies > kWarps ? kWarps : (int)copies;
      smem += sizeof(Shared) * (size_t)(tl.copies * one_copy);
    }
  }
  const long long n_tiles = tl.row_tiles * tl.col_tiles;
  // run pieces, or kept rows of several runs in contiguous chunks of tiles,
  // one range a cluster
  const long long clusters =
      tl.runs ? xh::ceil_div(dims.m1 * dims.m0 * dims.c1, tl.runs)
      : by_runs ? xh::chunk_tiles(tl, dims, resident)
                : (n_tiles < resident ? n_tiles : resident);
  // each block's shared counters are 32-bit and every block of a cluster
  // adds into them: bound the elements one cluster counts before it
  // flushes (a full reduction flushes only at the end, a chunk at most once
  // a tile, a range of runs once a row); weighted sums wrap or round by
  // their own type's rules instead, and exact sums move each word's wraps
  // into the output as they happen
  const long long visits = md.reduce_all ? xh::ceil_div(n_tiles, clusters)
                           : tl.runs ? tl.runs : tl.chunk ? tl.chunk : 1;
  if (!W::kWeighted && kShared && visits * tl.rows * tl.cols > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;

  md.whole_rows = kShared && !md.reduce_all && tl.col_tiles == 1 && !kExact<W>;
  if (!md.whole_rows) {
    const long long rows_out = md.reduce_all ? 1 : dims.m1 * dims.m0;
    err = cudaMemsetAsync(out, 0, sizeof(Out) * rows_out * (S + 1), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (kExact<W>) {
    // the unit's prologue: the largest |weight| and the tally start at 0
    err = cudaMemsetAsync(md.exact, 0, 2 * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return (int)err;
    const Levels lv = levels_of(w, dims);
    const long long items =
        lv.n[0] * lv.n[1] * lv.n[2] * xh::ceil_div(lv.n[3], kAmaxChunk);
    weight_amax_kernel<<<(unsigned)(items < 1024 ? items : 1024), kAmaxThreads, 0,
                         stream>>>(w.data, w.code, lv, md.exact);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (kVector<T, W, kShared, kN>)
    md.vec = tl.runs > 0 && md.thr_bytes != 0 && vector_reads<T, W>(p, w, dims);
  xh::last_launch = {cl, 1, kShared ? 1 : 0,
                     {p.in[0].cells, p.n > 1 ? p.in[1].cells : 0}};
  xh::last_launch.exact = kExact<W> ? 1 : 0;
  xh::last_launch.vector = md.vec;
  return (int)xh::launch_clustered(slot_hist_kernel<T, W, kShared, kN>,
                                   dim3((unsigned int)(clusters * cl)), threads,
                                   smem, cl, stream, p, w, dims, S, tl, md,
                                   static_cast<Out*>(out));
}

// The slots of a row each block of a cluster of 1 << log2c blocks holds:
// all S for one block, else its runs of 32 of slots 0..S.
inline long long share(long long S, int log2c) {
  if (log2c == 0) return S;
  const long long runs = ((S + 1) >> kRunBits) + ((S + 1) & 31 ? 1 : 0);
  return xh::ceil_div(runs, 1LL << log2c) << kRunBits;
}

// The C entries' common body: counts (W = xh::Count) or weighted sums
// (W = xh::Sum<A>, weights w) of the n inputs' (m1, m0, c1, c0) views
// (dims[0..3]) into out, (1 if reduce_all else m1 m0, S + 1) of W::Out,
// which needs no zeroing. data[k], thr[k]: device pointers of type T;
// strides[4k .. 4k + 3]: input k's (sm1, sm, sc1, sc) in elements; nb[k]
// its bin count. A full reduction's one row of two column levels comes as
// (1, c1, 1, c0), its rows summed (cuda_hist._geometry). Histograms of at
// most max_shared_slots slots a row are kept in the shared memory of one
// block, or of a cluster of at most max_cluster blocks (1, 2, 4 or 8),
// where they fit. Launches on `stream` and returns cudaGetLastError() (or
// the first failing CUDA call's error); never synchronises.
// codes[k]: input k's stored type (Input<Mixed>), read only when T is
// Mixed. scratch: 16 bytes of device memory, or null, with which float
// sums of kept rows past one block's room for float64 slots (W =
// xh::Sum<double>) are kept exactly in shared memory (the largest |weight|
// and the tally of weights that added as floats; Mode::exact).
template <typename T, typename W>
int launch_slot_hist(int n, const int* codes, const void* const* data,
                     const long long* strides, const void* const* thr,
                     const int* nb, const long long* dim, int reduce_all,
                     long long max_shared_slots, int max_cluster,
                     const xh::Weights& w, void* scratch, void* out, void* stream) {
  const xh::Dims dims = {dim[0], dim[1], dim[2], dim[3]};
  if (n < 1 || n > kMaxInputs || dims.m1 <= 0 || dims.m0 <= 0 || dims.c1 <= 0 ||
      dims.c0 <= 0 || w.sm < 0 || w.sc < 0 || w.sm1 < 0 || w.sc1 < 0 ||
      max_cluster < 1)
    return (int)cudaErrorInvalidValue;
  using Shared = typename W::Shared;
  Inputs<T> p = {};
  p.n = n;
  long long S = 1;
  size_t thr_slots = 0;
  size_t cells = 0;
  int tables = 0;    // 8-bit inputs of a coded instantiation
  int row_cost = 0;  // inputs a rows-first walk reads with a stride > 1
  int col_cost = 0;
  for (int k = 0; k < n; ++k) {
    Input<T>& d = p.in[k];
    d.data = data[k];
    d.thr = thr[k];
    if constexpr (kCoded<T>) {
      // Narrow reads float32 and the narrow types; Mixed every type
      const int code = codes[k];
      if (code < 0 || code >= xh::kLoadCodes || (kNarrow<T> && !xh::narrow_code(code)))
        return (int)cudaErrorInvalidValue;
      d.code = code;
      d.lut = -1;
      tables += xh::is_byte(code);
    }
    d.sm1 = strides[4 * k];
    d.sm = strides[4 * k + 1];
    d.sc1 = strides[4 * k + 2];
    d.sc = strides[4 * k + 3];
    d.nb = nb[k];
    if (d.nb < 1 || d.sm < 0 || d.sc < 0 || d.sm1 < 0 || d.sc1 < 0 ||
        S > (1LL << 62) / d.nb)
      return (int)cudaErrorInvalidValue;
    S *= d.nb;
    // read only when the thresholds are staged, and then below 2^16
    d.soff = thr_slots < (1u << 30) ? (int)thr_slots : 0;
    thr_slots += xh::skewed_len(d.nb + 1);
    d.cells = d.nb < xh::kMaxCells / 2 ? 2 * d.nb : xh::kMaxCells;
    cells += d.cells;
    row_cost += d.sm > 1;
    col_cost += d.sc > 1;
  }
  row_cost += w.sm > 1;  // the weights' view (all zero when unweighted)
  col_cost += w.sc > 1;
  // a tile lies in one run of rows and one of columns: the inner levels
  const bool row_fast = dims.m0 > 1 && (dims.c0 == 1 || row_cost < col_cost);

  // thresholds and their cell tables (and the 8-bit tables) where they
  // fit; one cell a table (the plain binary search) where only the
  // thresholds do
  const size_t budget = kSmemMax<T>;
  const size_t thr_bytes = (thr_slots * sizeof(Stored<T>) + 15) / 16 * 16;
  const size_t lut_bytes = sizeof(int) * 256 * (size_t)tables;
  if (thr_bytes + xh::cells_bytes((int)cells) + lut_bytes > budget) {
    cells = 0;
    for (int k = 0; k < n; ++k) cells += (p.in[k].cells = 1);
  }
  Mode md = {};
  md.reduce_all = reduce_all != 0;
  if (thr_bytes + xh::cells_bytes((int)cells) + lut_bytes <= budget) {
    md.thr_bytes = thr_bytes;
    const size_t lut_at = thr_bytes + xh::cells_bytes((int)cells);
    md.stage_bytes = (lut_at + lut_bytes + 15) / 16 * 16;
    for (int k = 0, toff = 0; k < n; toff += p.in[k++].cells) p.in[k].toff = toff;
    if constexpr (kCoded<T>) {
      int lut = (int)(lut_at / sizeof(int));
      for (int k = 0; k < n; ++k)
        if (xh::is_byte(p.in[k].code)) {
          p.in[k].lut = lut;
          lut += 256;
        }
    }
  } else {
    for (int k = 0; k < n; ++k) p.in[k].cells = 0;
  }
  const long long room = (long long)((budget - md.stage_bytes) / sizeof(Shared));
  const long long target = kHistBytes / (long long)sizeof(Shared);
  const cudaStream_t st = (cudaStream_t)stream;

  // the fewest blocks whose shared memory holds a row's histogram (and,
  // past one block, its trash slot: runs of 32 cover slots 0..S). Float64
  // sums add by compare-and-swap loops, slower still into another block,
  // and lose to device memory's native float64 adds wherever a cluster
  // would hold them (README call 5.26 against 3.29 ms, 60^3 1.43 against
  // 1.02; tools/factored_probe.py, PERF.md §6): one block, or, past it, kept
  // rows' float sums as exact integers in 32-bit words (xh::Exact) in the
  // fewest blocks that hold them, or device memory. Each block of a cluster
  // costs (H100, ECCO's call: exact sums in 8-byte slots 37.4 ms over four
  // blocks and 56 over eight, counts 21.6 over two blocks and 30.4 over
  // four; PERF.md §6), so a slot's word is 4 bytes and its wraps go to the
  // output
  constexpr bool kFloat = std::is_same<Shared, double>::value;
  const int cap = max_cluster < kMaxCluster ? max_cluster : kMaxCluster;
  const int most = kFloat ? 1 : cap;
  int log2c = -1;
  if (S <= max_shared_slots)
    for (int l = 0; (1 << l) <= most; ++l)
      if (share(S, l) <= room) {
        log2c = l;
        break;
      }
  if constexpr (kFloat) {
    const long long words = (long long)((budget - md.stage_bytes) / sizeof(unsigned));
    if (log2c < 0 && scratch != nullptr && !md.reduce_all && S <= max_shared_slots)
      for (int l = 0; (1 << l) <= cap; ++l)
        if (share(S, l) <= words) {
          md.log2c = l;
          md.s_local = share(S, l);
          md.exact = static_cast<unsigned long long*>(scratch);
          if (n == 2 && !kMixed<T>)
            return launch_kernel<T, xh::Exact, true, (kMixed<T> ? 0 : 2)>(
                p, w, dims, S, md.s_local, row_fast, md, out, st);
          return launch_kernel<T, xh::Exact, true, 0>(p, w, dims, S, md.s_local,
                                                      row_fast, md, out, st);
        }
  }
  if (log2c == 0) {
    long long most = S > target ? S : target;
    if (most > room) most = room;
    md.s_local = S;
    if (n == 2 && !kMixed<T>)
      return launch_kernel<T, W, true, (kMixed<T> ? 0 : 2)>(p, w, dims, S, most,
                                                          row_fast, md, out, st);
    return launch_kernel<T, W, true, 0>(p, w, dims, S, most, row_fast, md, out, st);
  }
  if (log2c > 0) {
    md.log2c = log2c;
    md.s_local = share(S, log2c);
    if (n == 2 && !kMixed<T>)
      return launch_kernel<T, W, true, (kMixed<T> ? 0 : 2)>(
          p, w, dims, S, md.s_local, row_fast, md, out, st);
    return launch_kernel<T, W, true, 0>(p, w, dims, S, md.s_local, row_fast, md,
                                        out, st);
  }
  md.s_local = S;
  if (n == 2 && !kMixed<T>)
    return launch_kernel<T, W, false, (kMixed<T> ? 0 : 2)>(p, w, dims, S, 0,
                                                         row_fast, md, out, st);
  return launch_kernel<T, W, false, 0>(p, w, dims, S, 0, row_fast, md, out, st);
}

}  // namespace slot
}  // namespace

// The C entry: counts into out, over every row (reduce_all) or one
// histogram a kept row; see launch_slot_hist.
#define XH_SLOT_ENTRY(name, T)                                                \
  extern "C" int name(int n, const void* const* data,                        \
                      const long long* strides, const void* const* thr,      \
                      const int* nb, const long long* dims, int reduce_all,  \
                      long long max_shared_slots, int max_cluster, void* out, \
                      void* stream) {                                        \
    return slot::launch_slot_hist<T, xh::Count>(                             \
        n, nullptr, data, strides, thr, nb, dims, reduce_all,                \
        max_shared_slots, max_cluster, xh::Weights{}, nullptr, out, stream); \
  }

// The weighted C entry: sums of the weights w (a view with the four
// strides wst, of the type `wcode` names within accumulator class A;
// weights.cuh) into out, of type A, with 16 bytes of device scratch for
// exact float sums (or null); see launch_slot_hist.
#define XH_SLOT_WEIGHTED_ENTRY(name, T, A)                                    \
  extern "C" int name(int n, const void* const* data,                        \
                      const long long* strides, const void* const* thr,      \
                      const int* nb, const long long* dims, int reduce_all,  \
                      long long max_shared_slots, int max_cluster,           \
                      const void* w, const long long* wst, int wcode,        \
                      void* scratch, void* out, void* stream) {              \
    return slot::launch_slot_hist<T, xh::Sum<A>>(                            \
        n, nullptr, data, strides, thr, nb, dims, reduce_all,                \
        max_shared_slots, max_cluster, xh::weights_of(w, wst, wcode),        \
        scratch, out, stream);                                               \
  }

// The weighted entries xh_slot_<data>_<cls> of the accumulator class cls
// (accumulator type A), for the four data types.
#define XH_SLOT_WEIGHTED_CLASS(cls, A)                                        \
  XH_SLOT_WEIGHTED_ENTRY(xh_slot_f32_##cls, float, A)                         \
  XH_SLOT_WEIGHTED_ENTRY(xh_slot_f64_##cls, double, A)                        \
  XH_SLOT_WEIGHTED_ENTRY(xh_slot_i32_##cls, int, A)                           \
  XH_SLOT_WEIGHTED_ENTRY(xh_slot_i64_##cls, long long, A)

// The entry for inputs with run-time stored types (T = slot::Mixed or
// slot::Narrow): as XH_SLOT_ENTRY, with codes[k] naming input k's stored
// type (narrow.cuh's load codes) and its thresholds in the
// instantiation's compare type (when mixed: int64 for int64 data, float64
// for the others; Narrow: float32).
#define XH_SLOT_CODED_ENTRY(name, T)                                          \
  extern "C" int name(int n, const int* codes, const void* const* data,      \
                      const long long* strides, const void* const* thr,      \
                      const int* nb, const long long* dims, int reduce_all,  \
                      long long max_shared_slots, int max_cluster, void* out, \
                      void* stream) {                                        \
    return slot::launch_slot_hist<T, xh::Count>(                             \
        n, codes, data, strides, thr, nb, dims, reduce_all,                  \
        max_shared_slots, max_cluster, xh::Weights{}, nullptr, out, stream); \
  }

// The weighted coded entry, for accumulator type A.
#define XH_SLOT_CODED_WEIGHTED_ENTRY(name, T, A)                              \
  extern "C" int name(int n, const int* codes, const void* const* data,      \
                      const long long* strides, const void* const* thr,      \
                      const int* nb, const long long* dims, int reduce_all,  \
                      long long max_shared_slots, int max_cluster,           \
                      const void* w, const long long* wst, int wcode,        \
                      void* scratch, void* out, void* stream) {              \
    return slot::launch_slot_hist<T, xh::Sum<A>>(                            \
        n, codes, data, strides, thr, nb, dims, reduce_all,                  \
        max_shared_slots, max_cluster, xh::weights_of(w, wst, wcode),        \
        scratch, out, stream);                                               \
  }
