// Joint two-input histogram, full reduction, int64 counts.
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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math: subnormal data must compare
// exactly against a 0.0 threshold (no flush to zero).

#include <cuda_runtime.h>

#include "digitize.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kMaxChunkSlots = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
joint2_kernel(const T* __restrict__ a, const T* __restrict__ b, long long n,
              const T* __restrict__ thr_a, int nba,
              const T* __restrict__ thr_b, int nbb, int rows_per_chunk,
              unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ta = reinterpret_cast<T*>(smem);
  T* tb = ta + xh::skewed_len(nba + 1);
  unsigned int* hist =
      reinterpret_cast<unsigned int*>(tb + xh::skewed_len(nbb + 1));

  const int row0 = blockIdx.y * rows_per_chunk;  // first T bin of the chunk
  const int rows = min(rows_per_chunk, nba - row0);
  const int chunk_slots = rows * nbb;

  xh::stage_thresholds(ta, thr_a, nba + 1);
  xh::stage_thresholds(tb, thr_b, nbb + 1);
  for (int s = threadIdx.x; s < chunk_slots; s += blockDim.x) hist[s] = 0u;
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
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ok[u] && i[u] >= row0 && i[u] < row0 + rows && j[u] >= 0)
        atomicAdd(&hist[(i[u] - row0) * nbb + j[u]], 1u);
    }
  }
  __syncthreads();

  unsigned long long* dst = out + (long long)row0 * nbb;
  for (int s = threadIdx.x; s < chunk_slots; s += blockDim.x) {
    const unsigned int v = hist[s];
    if (v) atomicAdd(&dst[s], (unsigned long long)v);
  }
}

template <typename T>
int launch_joint2(const void* a, const void* b, long long n, const void* thr_a,
                  int nba, const void* thr_b, int nbb, void* out,
                  void* stream) {
  if (n <= 0 || nba < 1 || nbb < 1) return (int)cudaErrorInvalidValue;
  const int rows_per_chunk =
      kMaxChunkSlots / nbb < nba ? kMaxChunkSlots / nbb : nba;
  if (rows_per_chunk < 1) return (int)cudaErrorInvalidValue;
  const int n_chunks = (nba + rows_per_chunk - 1) / rows_per_chunk;
  const size_t smem =
      sizeof(T) * (size_t)(xh::skewed_len(nba + 1) + xh::skewed_len(nbb + 1)) +
      sizeof(unsigned int) * (size_t)rows_per_chunk * nbb;

  static xh::LaunchShape shape;
  int sms = 0;
  int per_sm = 0;
  const cudaError_t err =
      shape.get((const void*)joint2_kernel<T>, kThreads, smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;

  // One resident wave: every chunk gets the same share of the card, and no
  // more blocks than there are element groups to give them.
  const long long groups = (n + (long long)kThreads * kUnroll - 1) /
                           ((long long)kThreads * kUnroll);
  long long grid_x = (long long)sms * per_sm / n_chunks;
  if (grid_x < 1) grid_x = 1;
  if (grid_x > groups) grid_x = groups;
  // a block's shared counters are 32-bit: bound the pairs one block visits
  if ((groups + grid_x - 1) / grid_x * kThreads * kUnroll > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;

  dim3 grid((unsigned int)grid_x, (unsigned int)n_chunks);
  joint2_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), n,
      static_cast<const T*>(thr_a), nba, static_cast<const T*>(thr_b), nbb,
      rows_per_chunk, static_cast<unsigned long long*>(out));
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
    return launch_joint2<T>(a, b, n, thr_a, nba, thr_b, nbb, out, stream);  \
  }

XH_JOINT2(xh_joint2_f32, float)
XH_JOINT2(xh_joint2_f64, double)
XH_JOINT2(xh_joint2_i32, int)
XH_JOINT2(xh_joint2_i64, long long)
