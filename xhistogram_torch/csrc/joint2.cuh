// Joint two-input histogram, full reduction, int64 counts or weighted sums.
//
// Replaces the TPU kernel xhistogram_tpu/ops/pallas_hist.py::_joint2_kernel
// (driven by _run_joint2). That kernel builds cumulative compare rows for
// each input and multiplies them on the TPU's matrix unit, because the TPU
// has no fast scatter. Hopper has fast shared-memory atomics and thread
// block clusters, so this kernel is a shared-memory histogram spread over
// the blocks of a cluster instead.
//
// What it computes, per element pair (a_e, b_e) read as La and Lb and
// compared as Ta and Tb, each input in its own type, as the TPU kernel
// widens each input's tile on its own: float, double, int32 or int64 read
// as themselves; narrow types read in place at their own width and widened
// in registers (narrow.cuh): float16, bfloat16, int16 and uint16 compared
// as float32, int8 and uint8 (bool as bytes) as int32 through a table; or,
// in the mixed entries, any type by its run-time load code, compared in
// int64 (int64, uint32, uint64 flipped) or double (xh::Held). Against the compare-form thresholds of
// xhistogram_torch.bins.compare_form in Ta and Tb (digitize.cuh):
//   i = #{t in thr_a : t <= a_e},  j = #{t in thr_b : t <= b_e}
//   the pair counts iff neither value is NaN, 1 <= i <= nba, 1 <= j <= nbb,
//   and then adds one to slot (i-1)*nbb + (j-1) of the int64 output.
//
// What bounds it on an H100: each pair reads sizeof(La) + sizeof(Lb) bytes
// from device memory. What its design does about the rest:
// - The digitize is the bucketed search of digitize.cuh: one cell-table
//   load and one or two threshold compares for the T-S edges, where a binary
//   search over 281 or 341 thresholds made about nine dependent
//   shared-memory loads and set the kernel's pace. 8-bit data has 256
//   values: each block finds their bins once, by the same search, so a
//   pair costs two shared-memory loads and no search.
// - A pair with a narrow input reads kUnroll neighbouring elements of each
//   input by one load (8 bytes of 16-bit data, 4 of 8-bit, 16 of float32)
//   where both inputs start on such a boundary, the few past the last whole
//   group one by one; else, for wide pairs and the mixed entries, each
//   element by itself, neighbouring threads on neighbouring elements.
// - The full 280x340 grid (381 KB of int32) does not fit one block's 227 KB
//   of shared memory, so it is spread over a cluster of C blocks (the
//   smallest of 1, 2, 4 and 8 that holds it; C = 2 for counts, C = 4 for
//   64-bit integer sums): block r of the cluster owns the T rows i with
//   i % C == r, which spreads the hot central rows of a T-S diagram over
//   the SMs. Each pair is read and digitized once and added with one
//   atomic in its owner's shared memory (distributed shared memory when
//   that is another block). Grids past eight blocks cut the T rows into
//   chunks over gridDim.y, each a pass over every pair.
// Integer atomics commute, so the result is deterministic and exact.
//
// Weighted (policy xh::Sum<A>, weights.cuh; the TPU kernel's weighted form
// multiplies weight limbs into its compare rows, with Kahan and NaN/inf
// channel outputs): each pair in the chunk's rows adds its weight, read
// beside the pair and converted at load to the accumulator A, in place of
// one. 8-byte accumulators take twice the blocks; float64 sums at most two
// blocks a cluster, in passes past that.
//
// Views: the inputs and weights are g runs of n contiguous elements, run k
// of each at k times its own outer stride (cuda_hist._joint2_runs: a full
// reduction of a halo-trimmed field, T[:, 1:-1], is runs of c - 2 at stride
// c; a weight broadcast over time has outer stride 0). One run (g = 1) is
// the contiguous case, read as before, with the vector loads of narrow
// pairs; more runs are walked in pieces of one block's step (kThreads
// kUnroll elements) inside a run, dealt round the grid, so no piece reads
// past its run and the index arithmetic stays one carry a piece.
//
// The kernel and its launcher, included by joint2.cu (one type for both
// inputs), joint2_narrow.cu (one narrow type for both), joint2_pairs.cu and
// joint2_pairs_swapped.cu (pairs of two types that users pass together)
// and joint2_mixed.cu (int64 beside a float, and the mixed entries for
// every other pair), which compile side by side.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math: subnormal data must compare
// exactly against a 0.0 threshold (no flush to zero).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "digitize.cuh"
#include "launch.cuh"
#include "narrow.cuh"
#include "weights.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kMaxCluster = 8;
// An input read by its run-time load code (the mixed entries).
template <typename L>
constexpr bool kHeld = std::is_same<L, xh::Held>::value;
// An input that may be digitized through a table of its 256 values' bins:
// 8-bit data, and a mixed input (8-bit or not, by its code).
template <typename L>
constexpr int kTableOf = (sizeof(L) == 1 || kHeld<L>) ? 1 : 0;
// 227 KB a block, less the kernel's static shared memory (and a table of 256
// bins for each input that may have one)
template <typename La, typename Lb>
constexpr size_t kSmemMax =
    232448 - 64 - (kTableOf<La> + kTableOf<Lb>) * 256 * sizeof(int);

// The prologue of one input: its cell map, then its cell table; a mixed
// input's by the type its code names (narrow.cuh).
template <typename L, typename T>
__device__ __forceinline__ xh::CellMap<T> map_of(const T* t, int nb, int k, int code) {
  if constexpr (kHeld<L>)
    return xh::mixed_cell_map(t, nb, k, code);
  else
    return xh::cell_map(t, nb, k);
}

template <typename L, typename T>
__device__ __forceinline__ void cells_of(const T* t, int nb, const xh::CellMap<T>& m,
                                         int code, int2* win, int* widest) {
  if constexpr (kHeld<L>)
    xh::mixed_build_cells(t, nb, m, code, win, widest);
  else
    xh::build_cells(t, nb, m, win, widest);
}

// The table of an input that may have one (kTableOf), where it has one.
template <typename L, typename T>
__device__ __forceinline__ void table_of(const T* t, int nb, const xh::CellMap<T>& m,
                                         const int2* win, int step0, int code,
                                         int* lut) {
  if constexpr (kHeld<L>) {
    if (xh::is_byte(code)) xh::mixed_byte_table(t, nb, m, win, step0, code, lut);
  } else {
    xh::build_byte_table<T, L>(t, nb, m, win, step0, lut);
  }
}

// bin[u]: the bin of raw[u] (narrow.cuh's bins_loaded; a mixed input's by
// its code: through its table for 8-bit data, else in int64 or double).
template <typename L, typename T, int U>
__device__ __forceinline__ void bins_of_input(const T* t, int nb, const xh::CellMap<T>& m,
                                              const int2* win, int step0, const int* lut,
                                              int code, const L (&raw)[U],
                                              int (&bin)[U]) {
  if constexpr (kHeld<L>) {
    long long x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = raw[u].bits;
    if (xh::is_byte(code)) {
#pragma unroll
      for (int u = 0; u < U; ++u) bin[u] = lut[xh::held_byte(x[u])];
    } else {
      xh::mixed_bins<U>(t, nb, m, win, step0, code, x, bin);
    }
  } else {
    xh::bins_loaded(t, nb, m, win, step0, lut, raw, bin);
  }
}

// v[u]: element e0 + u * de of a mixed input p (the stored type `code`
// names), held in 8 bytes; zero where !ok[u].
template <int K>
__device__ __forceinline__ void load_held(const void* p, int code, long long e0,
                                          long long de, const bool (&ok)[K],
                                          xh::Held (&v)[K]) {
  long long at[K];
  long long x[K];
#pragma unroll
  for (int u = 0; u < K; ++u) at[u] = e0 + u * de;
  xh::gather_mixed<K>(p, at, ok, code, x);
#pragma unroll
  for (int u = 0; u < K; ++u) v[u].bits = x[u];
}

__host__ __device__ inline size_t align8(size_t x) { return (x + 7) / 8 * 8; }

// Dynamic shared memory: both threshold sets (skewed), the second aligned
// to its type, then the two cell tables of ka and kb cells, then the
// histogram. One type for both inputs keeps the arithmetic of a single
// threshold array (the compiled kernel is the one-type kernel's, unchanged).
template <typename Ta, typename Tb>
__host__ __device__ inline size_t tb_offset(int nba) {
  return (sizeof(Ta) * (size_t)xh::skewed_len(nba + 1) + sizeof(Tb) - 1) /
         sizeof(Tb) * sizeof(Tb);
}

template <typename Ta, typename Tb>
__host__ __device__ inline size_t tables_offset(int nba, int nbb) {
  if constexpr (std::is_same<Ta, Tb>::value)
    return align8(sizeof(Ta) *
                  (size_t)(xh::skewed_len(nba + 1) + xh::skewed_len(nbb + 1)));
  return align8(tb_offset<Ta, Tb>(nba) + sizeof(Tb) * (size_t)xh::skewed_len(nbb + 1));
}

template <typename Ta, typename Tb>
__host__ __device__ inline size_t hist_offset(int nba, int nbb, int ka, int kb) {
  return tables_offset<Ta, Tb>(nba, nbb) + xh::cells_bytes(ka) + xh::cells_bytes(kb);
}

// W: xh::Count (adds one) or xh::Sum<A> (adds the weight w[e]). kRuns: g
// runs at their outer strides, walked in pieces, else one contiguous run
// (g == 1: the kernel of one run, its registers untouched). La, Lb: the
// types the inputs are read as; Ta, Tb: their compare types, each input's
// own. xh::Held reads an input by its load code, codes & 255 for a and
// codes >> 8 for b, compared in long long (int64) or in double held in
// long long's 8 bytes (narrow.cuh's mixed entries).
template <typename La, typename Lb, typename Ta, typename Tb, typename W, bool kRuns>
__global__ void __launch_bounds__(kThreads)
joint2_kernel(const La* __restrict__ a, const Lb* __restrict__ b, long long g,
              long long n, long long sa, long long sb, long long sw,
              const Ta* __restrict__ thr_a, int nba,
              const Tb* __restrict__ thr_b, int nbb, int ka, int kb,
              int rows_per_chunk, int log2c, const void* __restrict__ w,
              int wcode, typename W::Out* __restrict__ out, int codes) {
  using Shared = typename W::Shared;
  // each input's bins by table (8-bit data; a mixed input, by its code)
  constexpr int kTabA = kTableOf<La>;
  constexpr int kTabB = kTableOf<Lb>;
  // a narrow input: kUnroll elements of each input a load
  constexpr bool kVec = sizeof(La) < 4 || sizeof(Lb) < 4;
  const int code_a = codes & 255;
  const int code_b = codes >> 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int widest[2];
  __shared__ int lut[kTabA + kTabB > 0 ? kTabA + kTabB : 1][kTabA + kTabB > 0 ? 256 : 1];
  Ta* ta = reinterpret_cast<Ta*>(smem);
  Tb* tb;
  if constexpr (std::is_same<Ta, Tb>::value)
    tb = ta + xh::skewed_len(nba + 1);
  else
    tb = reinterpret_cast<Tb*>(smem + tb_offset<Ta, Tb>(nba));
  int2* win_a = reinterpret_cast<int2*>(smem + tables_offset<Ta, Tb>(nba, nbb));
  int2* win_b = win_a + ka;
  Shared* hist =
      reinterpret_cast<Shared*>(smem + hist_offset<Ta, Tb>(nba, nbb, ka, kb));

  cg::cluster_group cluster = cg::this_cluster();
  const int cl = 1 << log2c;  // blocks a cluster
  const int rank = cl > 1 ? (int)cluster.block_rank() : 0;
  const int row0 = blockIdx.y * rows_per_chunk;  // first T bin of the chunk
  const int rows = min(rows_per_chunk, nba - row0);
  // this block's rows of the chunk: row0 + rank, row0 + rank + cl, ...
  const int my_slots = (rows > rank ? (rows - rank + cl - 1) >> log2c : 0) * nbb;

  xh::stage_thresholds(ta, thr_a, nba + 1);
  xh::stage_thresholds(tb, thr_b, nbb + 1);
  for (int s = threadIdx.x; s < my_slots; s += blockDim.x) hist[s] = Shared(0);
  __syncthreads();
  const xh::CellMap<Ta> ma = map_of<La>(ta, nba, ka, code_a);
  const xh::CellMap<Tb> mb = map_of<Lb>(tb, nbb, kb, code_b);
  cells_of<La>(ta, nba, ma, code_a, win_a, &widest[0]);
  cells_of<Lb>(tb, nbb, mb, code_b, win_b, &widest[1]);
  const int step_a = xh::first_step(widest[0]);
  const int step_b = xh::first_step(widest[1]);
  if constexpr (kTabA + kTabB > 0) {
    if constexpr (kTabA) table_of<La>(ta, nba, ma, win_a, step_a, code_a, lut[0]);
    if constexpr (kTabB) table_of<Lb>(tb, nbb, mb, win_b, step_b, code_b, lut[kTabA]);
    __syncthreads();
  }
  if (cl > 1) cluster.sync();  // every block's histogram zeroed before an add

  // counts the pairs (av[u], bv[u]), valid where ok[u], at elements
  // e0 + u * de
  auto count = [&](const La (&av)[kUnroll], const Lb (&bv)[kUnroll],
                   const bool (&ok)[kUnroll], long long e0, long long de) {
    int i[kUnroll];  // -1: NaN or out of range
    int j[kUnroll];
    bins_of_input(ta, nba, ma, win_a, step_a, lut[0], code_a, av, i);
    bins_of_input(tb, nbb, mb, win_b, step_b, lut[kTabA], code_b, bv, j);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // in this chunk's rows; r: the row within the chunk
      const int r = i[u] - row0;
      if (!(ok[u] && r >= 0 && r < rows && j[u] >= 0)) continue;
      Shared v = Shared(1);
      if constexpr (W::kWeighted) xh::load_weight(w, e0 + u * de, wcode, v);
      const int slot = (r >> log2c) * nbb + j[u];
      if (cl == 1)
        atomicAdd(&hist[slot], v);
      else
        atomicAdd(cluster.map_shared_rank(hist, r & (cl - 1)) + slot, v);
    }
  };

  const long long step = (long long)blockDim.x * kUnroll;
  if constexpr (!kRuns) {  // one run: g == 1
    long long done = 0;  // the elements the group loads below counted
    if constexpr (kVec) {
      // kUnroll neighbours of each input a load, where both inputs start on
      // a boundary of that many bytes (a view at another offset is read
      // element by element below)
      using PackA = xh::Pack<La, kUnroll>;
      using PackB = xh::Pack<Lb, kUnroll>;
      const bool aligned =
          reinterpret_cast<unsigned long long>(a) % sizeof(PackA) == 0 &&
          reinterpret_cast<unsigned long long>(b) % sizeof(PackB) == 0;
      const long long groups = aligned ? n / kUnroll : 0;
      const bool ok[kUnroll] = {true, true, true, true};
      for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < groups;
           q += (long long)blockDim.x * gridDim.x) {
        const PackA pa = reinterpret_cast<const PackA*>(a)[q];
        const PackB pb = reinterpret_cast<const PackB*>(b)[q];
        count(pa.v, pb.v, ok, q * kUnroll, 1);
      }
      done = groups * kUnroll;
    }

    const long long stride = step * gridDim.x;
    for (long long base = done + (long long)blockIdx.x * step + threadIdx.x; base < n;
         base += stride) {
      La av[kUnroll];
      Lb bv[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long e = base + (long long)u * blockDim.x;
        ok[u] = e < n;
        if constexpr (!kHeld<La>) av[u] = ok[u] ? a[e] : La{};
        if constexpr (!kHeld<Lb>) bv[u] = ok[u] ? b[e] : Lb{};
      }
      if constexpr (kHeld<La>) load_held(a, code_a, base, blockDim.x, ok, av);
      if constexpr (kHeld<Lb>) load_held(b, code_b, base, blockDim.x, ok, bv);
      count(av, bv, ok, base, blockDim.x);
    }
  } else {
    // pieces of one step inside a run: piece p of run k covers elements
    // [p step, (p + 1) step) of the run; the grid deals them out in order,
    // each block advancing by gridDim.x pieces with one carry
    // (32-bit state, to keep within the 64 registers a thread has at 1024
    // threads; the launcher bounds the pieces below 2^31)
    const int per_run = (int)((n + step - 1) / step);
    const int dk = (int)gridDim.x / per_run;
    const int dp = (int)gridDim.x - dk * per_run;
    int k = (int)blockIdx.x / per_run;
    int p = (int)blockIdx.x - k * per_run;
    while (k < g) {
      const long long pos = (long long)p * step + threadIdx.x;
      const long long ea = k * sa;
      const long long eb = k * sb;
      La av[kUnroll];
      Lb bv[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long e = pos + (long long)u * blockDim.x;
        ok[u] = e < n;
        if constexpr (!kHeld<La>) av[u] = ok[u] ? a[ea + e] : La{};
        if constexpr (!kHeld<Lb>) bv[u] = ok[u] ? b[eb + e] : Lb{};
      }
      if constexpr (kHeld<La>) load_held(a, code_a, ea + pos, blockDim.x, ok, av);
      if constexpr (kHeld<Lb>) load_held(b, code_b, eb + pos, blockDim.x, ok, bv);
      count(av, bv, ok, k * sw + pos, blockDim.x);
      p += dp;
      k += dk;
      if (p >= per_run) {
        p -= per_run;
        ++k;
      }
    }
  }
  if (cl > 1)
    cluster.sync();  // every add of the cluster landed
  else
    __syncthreads();

  for (int s = threadIdx.x; s < my_slots; s += blockDim.x) {
    const Shared v = hist[s];
    if (v != Shared(0)) {  // NaN != 0: a NaN sum is added
      const int row = row0 + ((s / nbb) << log2c) + rank;
      atomicAdd(&out[(long long)row * nbb + s % nbb], (typename W::Out)v);
    }
  }
}

// The launch of one variant of the kernel (kRuns: g runs), each with its own
// launch-shape cache (and shared-memory attribute).
template <typename La, typename Lb, typename Ta, typename Tb, typename W, bool kRuns>
int launch_pass(const void* a, const void* b, long long g, long long n,
                const long long* strides, const void* thr_a, int nba, const void* thr_b,
                int nbb, int ka, int kb, int rows_per_chunk, int n_chunks, int log2c,
                size_t smem, const void* w, int wcode, void* out, cudaStream_t stream,
                int codes) {
  // one resident wave of clusters: every chunk gets the same share of the
  // card, and no more blocks than there are element groups to give them
  const int cl = 1 << log2c;
  static xh::ClusterShape shape;
  long long resident = 0;  // clusters
  cudaError_t err = shape.get((const void*)joint2_kernel<La, Lb, Ta, Tb, W, kRuns>,
                              kThreads, smem, cl, &resident);
  if (err != cudaSuccess) return (int)err;
  // element groups of one block's step (g runs: the pieces of every run)
  const long long groups = g * ((n + (long long)kThreads * kUnroll - 1) /
                                ((long long)kThreads * kUnroll));
  if (g > 1 && groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long clusters_x = resident / n_chunks;
  if (clusters_x > (groups + cl - 1) / cl) clusters_x = (groups + cl - 1) / cl;
  if (clusters_x < 1) clusters_x = 1;
  const long long grid_x = clusters_x * cl;
  // each block's shared counters are 32-bit and every block of a cluster
  // adds into them: bound the pairs one cluster visits (weighted sums wrap
  // or round by their own type's rules instead)
  if (!W::kWeighted &&
      (groups + grid_x - 1) / grid_x * kThreads * kUnroll * cl > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;

  err = xh::launch_clustered(
      joint2_kernel<La, Lb, Ta, Tb, W, kRuns>,
      dim3((unsigned int)grid_x, (unsigned int)n_chunks), kThreads, smem, cl, stream,
      static_cast<const La*>(a), static_cast<const Lb*>(b), g, n, strides[0],
      strides[1], strides[2], static_cast<const Ta*>(thr_a), nba,
      static_cast<const Tb*>(thr_b), nbb, ka, kb, rows_per_chunk, log2c, w, wcode,
      static_cast<typename W::Out*>(out), codes);
  xh::last_launch = {cl, n_chunks, 1, {ka, kb}};
  return (int)err;
}

template <typename La, typename Lb, typename Ta, typename Tb, typename W>
int launch_joint2(const void* a, const void* b, const long long* runs,
                  const void* thr_a, int nba, const void* thr_b, int nbb,
                  int max_cluster, const void* w, int wcode, void* out, void* stream,
                  int codes = 0) {
  using Shared = typename W::Shared;
  const long long g = runs[0];
  const long long n = runs[1];
  if (g <= 0 || n <= 0 || runs[2] < 0 || runs[3] < 0 || runs[4] < 0 || nba < 1 ||
      nbb < 1 || max_cluster < 1)
    return (int)cudaErrorInvalidValue;
  const int ka = nba < xh::kMaxCells / 2 ? 2 * nba : xh::kMaxCells;
  const int kb = nbb < xh::kMaxCells / 2 ? 2 * nbb : xh::kMaxCells;
  const size_t hoff = hist_offset<Ta, Tb>(nba, nbb, ka, kb);
  const long long rows_fit =
      hoff < kSmemMax<La, Lb> ? (long long)((kSmemMax<La, Lb> - hoff) / sizeof(Shared)) / nbb : 0;
  if (rows_fit < 1) return (int)cudaErrorInvalidValue;

  // the smallest cluster that holds every T row, else the largest allowed,
  // in passes of chunks of rows. Float64 sums add by compare-and-swap loops,
  // slower still into another block: at 2^26 T-S pairs two passes of
  // clusters of two beat one pass of four and four passes of one block
  // (1.26 against 1.49 and 1.61 ms; tools/joint2_probe.py, PERF.md §5)
  const int kind_most = std::is_same<Shared, double>::value ? 2 : kMaxCluster;
  const int most = max_cluster < kind_most ? max_cluster : kind_most;
  int log2c = 0;
  while ((2 << log2c) <= most && (1LL << log2c) * rows_fit < nba) ++log2c;
  const int cl = 1 << log2c;
  const long long chunk_most = cl * rows_fit;
  const int n_chunks = (int)((nba + chunk_most - 1) / chunk_most);
  const int rows_per_chunk = (nba + n_chunks - 1) / n_chunks;  // balanced
  const int rows_per_block = (rows_per_chunk + cl - 1) / cl;
  const size_t smem = hoff + sizeof(Shared) * (size_t)rows_per_block * nbb;

  const long long* strides = runs + 2;
  const cudaStream_t st = (cudaStream_t)stream;
  if (g > 1)
    return launch_pass<La, Lb, Ta, Tb, W, true>(
        a, b, g, n, strides, thr_a, nba, thr_b, nbb, ka, kb, rows_per_chunk, n_chunks,
        log2c, smem, w, wcode, out, st, codes);
  return launch_pass<La, Lb, Ta, Tb, W, false>(
      a, b, g, n, strides, thr_a, nba, thr_b, nbb, ka, kb, rows_per_chunk, n_chunks,
      log2c, smem, w, wcode, out, st, codes);
}

}  // namespace

// Adds the joint counts of the pairs (a[e], b[e]) into out[nba * nbb], which
// the caller zeroes, in clusters of at most max_cluster blocks (1, 2, 4 or
// 8): runs[0] runs of runs[1] contiguous elements, run k of a at k runs[2]
// and of b at k runs[3] (of the weights at k runs[4]; joint2_kernel's
// views), input a read as La and compared as Ta against thresholds of type Ta,
// b read as Lb and compared as Tb: one wide type for both (joint2.cu), two
// inputs of one narrow type (joint2_narrow.cu) and the pairs of two types
// with instantiations of their own (joint2_pairs.cu,
// joint2_pairs_swapped.cu, joint2_mixed.cu). Launches on `stream` and
// returns cudaGetLastError() (or the first failing CUDA call's error);
// never synchronises.
#define XH_JOINT2_LOADS(name, La, Ta, Lb, Tb)                                  \
  extern "C" int name(const void* a, const void* b, const long long* runs,    \
                      const void* thr_a, int nba, const void* thr_b, int nbb,   \
                      int max_cluster, void* out, void* stream) {             \
    return launch_joint2<La, Lb, Ta, Tb, xh::Count>(                          \
        a, b, runs, thr_a, nba, thr_b, nbb, max_cluster, nullptr, 0, out,     \
        stream);                                                              \
  }

// Weighted: adds the sums of the weights w (runs like the data's, of the
// type `wcode` names within accumulator class A; weights.cuh) into
// out[nba * nbb], of type A, which the caller zeroes.
#define XH_JOINT2_LOADS_WEIGHTED(name, La, Ta, Lb, Tb, A)                      \
  extern "C" int name(const void* a, const void* b, const long long* runs,    \
                      const void* thr_a, int nba, const void* thr_b, int nbb,   \
                      int max_cluster, const void* w, int wcode, void* out,    \
                      void* stream) {                                         \
    return launch_joint2<La, Lb, Ta, Tb, xh::Sum<A>>(                         \
        a, b, runs, thr_a, nba, thr_b, nbb, max_cluster, w, wcode, out,       \
        stream);                                                              \
  }

// The same for inputs read as their compare types Ta and Tb.
#define XH_JOINT2(name, Ta, Tb) XH_JOINT2_LOADS(name, Ta, Ta, Tb, Tb)
#define XH_JOINT2_WEIGHTED(name, Ta, Tb, A) \
  XH_JOINT2_LOADS_WEIGHTED(name, Ta, Ta, Tb, Tb, A)

// The count entry xh_joint2_<sa>_<sb> of a pair and its weighted entries
// xh_joint2_<sa>_<sb>_<cls>, one per accumulator class.
#define XH_JOINT2_PAIR(sa, La, Ta, sb, Lb, Tb)                                 \
  XH_JOINT2_LOADS(xh_joint2_##sa##_##sb, La, Ta, Lb, Tb)                       \
  XH_JOINT2_LOADS_WEIGHTED(xh_joint2_##sa##_##sb##_wf64, La, Ta, Lb, Tb, double) \
  XH_JOINT2_LOADS_WEIGHTED(xh_joint2_##sa##_##sb##_wu32, La, Ta, Lb, Tb,       \
                           unsigned int)                                      \
  XH_JOINT2_LOADS_WEIGHTED(xh_joint2_##sa##_##sb##_wu64, La, Ta, Lb, Tb,       \
                           unsigned long long)

// The mixed entries (joint2_mixed.cu): each input read by its load code,
// codes[0] for a and codes[1] for b (narrow.cuh; any of the eleven data
// types), against thresholds in int64 for int64 data and in float64 for
// the rest. The pairs with no instantiation of their own take them.
#define XH_JOINT2_MIXED_CODES_OK(codes)                                       \
  (codes[0] >= 0 && codes[0] < xh::kLoadCodes && codes[1] >= 0 &&              \
   codes[1] < xh::kLoadCodes)
#define XH_JOINT2_MIXED(name)                                                  \
  extern "C" int name(const int* codes, const void* a, const void* b,         \
                      const long long* runs, const void* thr_a, int nba,       \
                      const void* thr_b, int nbb, int max_cluster, void* out,  \
                      void* stream) {                                         \
    if (!XH_JOINT2_MIXED_CODES_OK(codes)) return (int)cudaErrorInvalidValue;   \
    return launch_joint2<xh::Held, xh::Held, long long, long long, xh::Count>( \
        a, b, runs, thr_a, nba, thr_b, nbb, max_cluster, nullptr, 0, out,      \
        stream, codes[0] | codes[1] << 8);                                    \
  }

// The weighted mixed entry, for accumulator type A.
#define XH_JOINT2_MIXED_WEIGHTED(name, A)                                      \
  extern "C" int name(const int* codes, const void* a, const void* b,         \
                      const long long* runs, const void* thr_a, int nba,       \
                      const void* thr_b, int nbb, int max_cluster,             \
                      const void* w, int wcode, void* out, void* stream) {     \
    if (!XH_JOINT2_MIXED_CODES_OK(codes)) return (int)cudaErrorInvalidValue;   \
    return launch_joint2<xh::Held, xh::Held, long long, long long, xh::Sum<A>>( \
        a, b, runs, thr_a, nba, thr_b, nbb, max_cluster, w, wcode, out,        \
        stream, codes[0] | codes[1] << 8);                                    \
  }
