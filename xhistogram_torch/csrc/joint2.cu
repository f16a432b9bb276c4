// Joint two-input histogram, full reduction, int64 counts or weighted sums.
//
// Replaces the TPU kernel xhistogram_tpu/ops/pallas_hist.py::_joint2_kernel
// (driven by _run_joint2). That kernel builds cumulative compare rows for
// each input and multiplies them on the TPU's matrix unit, because the TPU
// has no fast scatter. Hopper has fast shared-memory atomics, so this kernel
// is a privatised shared-memory histogram instead.
//
// What it computes, per element pair (a_e, b_e) of data type T (float,
// double, int32 or int64), against the compare-form thresholds of
// xhistogram_torch.bins.compare_form in T (digitize.cuh):
//   i = #{t in thr_a : t <= a_e},  j = #{t in thr_b : t <= b_e}
//   the pair counts iff neither value is NaN, 1 <= i <= nba, 1 <= j <= nbb,
//   and then adds one to slot (i-1)*nbb + (j-1) of the int64 output.
//
// What bounds it on an H100: each pair reads 2 sizeof(T) bytes from device
// memory, and the counts are shared-memory atomics, which contend on the hot
// central bins of a T-S diagram. The full 280x340 grid (381 KB of int32)
// does not fit one block's 227 KB of shared memory, so the T bins are cut
// into row chunks over gridDim.y, each at most kMaxChunkSlots slots, and
// every chunk's blocks visit all pairs. Blocks of the same blockIdx.x in
// the different chunks stream the same addresses at about the same time,
// so the repeated read can hit L2. Each thread digitizes kUnroll pairs side
// by side with the branch-free search of digitize.cuh; a warp searches S
// even for pairs outside its rows, since some lane nearly always needs it.
// Measured on an H100 80GB HBM3 at 700 W (tools/joint2_probe.py, PERF.md
// §5), the pass per chunk is what costs: the binary searches in shared
// memory, not device memory, set the pace, so each extra chunk adds about
// one pass.
// Integer atomics commute, so the result is deterministic and exact.
//
// Weighted (policy xh::Sum<A>, weights.cuh; the TPU kernel's weighted form
// multiplies weight limbs into its compare rows, with Kahan and NaN/inf
// channel outputs): each pair in the chunk's rows adds its weight, read
// contiguously beside the pair and converted at load to the accumulator A,
// in place of one. A chunk holds kMaxChunkBytes of accumulators, so float64
// and 64-bit sums cut the T bins into twice as many chunks, each a pass.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math: subnormal data must compare
// exactly against a 0.0 threshold (no flush to zero).

#include <cuda_runtime.h>

#include "digitize.cuh"
#include "launch.cuh"
#include "weights.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kMaxChunkBytes = 192 * 1024;  // a chunk's shared histogram

// The byte offset of the histogram past both threshold sets of `elem`
// bytes each, aligned for its accumulators of `acc` bytes.
__host__ __device__ constexpr size_t hist_offset(int nba, int nbb, size_t elem,
                                                 size_t acc) {
  return (elem * (size_t)(xh::skewed_len(nba + 1) + xh::skewed_len(nbb + 1)) +
          acc - 1) / acc * acc;
}

// W: xh::Count (adds one) or xh::Sum<A> (adds the weight w[e]).
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
joint2_kernel(const T* __restrict__ a, const T* __restrict__ b, long long n,
              const T* __restrict__ thr_a, int nba,
              const T* __restrict__ thr_b, int nbb, int rows_per_chunk,
              const void* __restrict__ w, int wcode,
              typename W::Out* __restrict__ out) {
  using Shared = typename W::Shared;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ta = reinterpret_cast<T*>(smem);
  T* tb = ta + xh::skewed_len(nba + 1);
  Shared* hist;
  if constexpr (W::kWeighted)
    hist = reinterpret_cast<Shared*>(
        smem + hist_offset(nba, nbb, sizeof(T), sizeof(Shared)));
  else  // the same offset, computed as the unweighted kernel always has
    hist = reinterpret_cast<Shared*>(tb + xh::skewed_len(nbb + 1));

  const int row0 = blockIdx.y * rows_per_chunk;  // first T bin of the chunk
  const int rows = min(rows_per_chunk, nba - row0);
  const int chunk_slots = rows * nbb;

  xh::stage_thresholds(ta, thr_a, nba + 1);
  xh::stage_thresholds(tb, thr_b, nbb + 1);
  for (int s = threadIdx.x; s < chunk_slots; s += blockDim.x)
    hist[s] = Shared(0);
  __syncthreads();

  const long long step = (long long)blockDim.x * kUnroll;
  const long long stride = step * gridDim.x;
  for (long long base = (long long)blockIdx.x * step + threadIdx.x; base < n;
       base += stride) {
    T av[kUnroll];
    T bv[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + (long long)u * blockDim.x;
      ok[u] = e < n;
      av[u] = ok[u] ? a[e] : T(0);
      bv[u] = ok[u] ? b[e] : T(0);
    }
    int i[kUnroll];  // -1: NaN or out of range
    int j[kUnroll];
    xh::bins_of(ta, nba, av, i);
    xh::bins_of(tb, nbb, bv, j);
    if constexpr (W::kWeighted) {
      bool take[kUnroll];  // in this chunk's rows
      Shared wt[kUnroll];  // loaded only for the pairs this chunk adds
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        take[u] = ok[u] && i[u] >= row0 && i[u] < row0 + rows && j[u] >= 0;
        wt[u] = Shared(0);
        if (take[u])
          xh::load_weight(w, base + (long long)u * blockDim.x, wcode, wt[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (take[u]) atomicAdd(&hist[(i[u] - row0) * nbb + j[u]], wt[u]);
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u] && i[u] >= row0 && i[u] < row0 + rows && j[u] >= 0)
          atomicAdd(&hist[(i[u] - row0) * nbb + j[u]], 1u);
      }
    }
  }
  __syncthreads();

  typename W::Out* dst = out + (long long)row0 * nbb;
  for (int s = threadIdx.x; s < chunk_slots; s += blockDim.x) {
    const Shared v = hist[s];
    if (v != Shared(0))  // NaN != 0: a NaN sum is added
      atomicAdd(&dst[s], (typename W::Out)v);
  }
}

template <typename T, typename W>
int launch_joint2(const void* a, const void* b, long long n, const void* thr_a,
                  int nba, const void* thr_b, int nbb, const void* w,
                  int wcode, void* out, void* stream) {
  if (n <= 0 || nba < 1 || nbb < 1) return (int)cudaErrorInvalidValue;
  const int chunk_slots = kMaxChunkBytes / (int)sizeof(typename W::Shared);
  const int rows_per_chunk = chunk_slots / nbb < nba ? chunk_slots / nbb : nba;
  if (rows_per_chunk < 1) return (int)cudaErrorInvalidValue;
  const int n_chunks = (nba + rows_per_chunk - 1) / rows_per_chunk;
  const size_t smem =
      hist_offset(nba, nbb, sizeof(T), sizeof(typename W::Shared)) +
      sizeof(typename W::Shared) * (size_t)rows_per_chunk * nbb;

  static xh::LaunchShape shape;
  int sms = 0;
  int per_sm = 0;
  const cudaError_t err = shape.get((const void*)joint2_kernel<T, W>, kThreads,
                                    smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;

  // One resident wave: every chunk gets the same share of the card, and no
  // more blocks than there are element groups to give them.
  const long long groups = (n + (long long)kThreads * kUnroll - 1) /
                           ((long long)kThreads * kUnroll);
  long long grid_x = (long long)sms * per_sm / n_chunks;
  if (grid_x < 1) grid_x = 1;
  if (grid_x > groups) grid_x = groups;
  // a block's shared counters are 32-bit: bound the pairs one block visits
  // (weighted sums wrap or round by their own type's rules instead)
  if (!W::kWeighted &&
      (groups + grid_x - 1) / grid_x * kThreads * kUnroll > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;

  dim3 grid((unsigned int)grid_x, (unsigned int)n_chunks);
  joint2_kernel<T, W><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), n,
      static_cast<const T*>(thr_a), nba, static_cast<const T*>(thr_b), nbb,
      rows_per_chunk, w, wcode, static_cast<typename W::Out*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Adds the joint counts of n pairs (a[e], b[e]) into out[nba * nbb], which
// the caller zeroes. Both inputs and their thresholds are of the type the
// suffix names. Launches on `stream` and returns cudaGetLastError() (or the
// first failing CUDA call's error); never synchronises.
#define XH_JOINT2(name, T)                                                   \
  extern "C" int name(const void* a, const void* b, long long n,            \
                      const void* thr_a, int nba, const void* thr_b, int nbb, \
                      void* out, void* stream) {                            \
    return launch_joint2<T, xh::Count>(a, b, n, thr_a, nba, thr_b, nbb,     \
                                       nullptr, 0, out, stream);            \
  }

// Weighted: adds the sums of the n contiguous weights w (of the type
// `wcode` names within accumulator class A; weights.cuh) into
// out[nba * nbb], of type A, which the caller zeroes.
#define XH_JOINT2_WEIGHTED(name, T, A)                                       \
  extern "C" int name(const void* a, const void* b, long long n,            \
                      const void* thr_a, int nba, const void* thr_b, int nbb, \
                      const void* w, int wcode, void* out, void* stream) {  \
    return launch_joint2<T, xh::Sum<A>>(a, b, n, thr_a, nba, thr_b, nbb, w, \
                                        wcode, out, stream);                \
  }

XH_JOINT2(xh_joint2_f32, float)
XH_JOINT2(xh_joint2_f64, double)
XH_JOINT2(xh_joint2_i32, int)
XH_JOINT2(xh_joint2_i64, long long)

// The weighted entries xh_joint2_<data>_<cls> of the accumulator
// class cls (accumulator type A), for the four data types.
#define XH_JOINT2_WEIGHTED_CLASS(cls, A)                                      \
  XH_JOINT2_WEIGHTED(xh_joint2_f32_##cls, float, A)                           \
  XH_JOINT2_WEIGHTED(xh_joint2_f64_##cls, double, A)                          \
  XH_JOINT2_WEIGHTED(xh_joint2_i32_##cls, int, A)                             \
  XH_JOINT2_WEIGHTED(xh_joint2_i64_##cls, long long, A)

XH_JOINT2_WEIGHTED_CLASS(wf64, double)
XH_JOINT2_WEIGHTED_CLASS(wu32, unsigned int)
XH_JOINT2_WEIGHTED_CLASS(wu64, unsigned long long)
