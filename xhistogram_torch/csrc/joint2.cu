// Joint two-input histogram of float32 data, full reduction, int64 counts.
//
// Replaces the TPU kernel xhistogram_tpu/ops/pallas_hist.py::_joint2_kernel
// (driven by _run_joint2). That kernel builds cumulative compare rows for
// each input and multiplies them on the TPU's matrix unit, because the TPU
// has no fast scatter. Hopper has fast shared-memory atomics, so this kernel
// is a privatised shared-memory histogram instead.
//
// What it computes, per element pair (a_e, b_e), against the compare-form
// thresholds of xhistogram_torch.bins.compare_form (half-open bins with the
// closed last bin already folded in):
//   i = #{t in thr_a : t <= a_e},  j = #{t in thr_b : t <= b_e}
//   the pair counts iff neither value is NaN, 1 <= i <= nba, 1 <= j <= nbb,
//   and then adds one to slot (i-1)*nbb + (j-1) of the int64 output.
//
// What bounds it on an H100: each pair reads 8 bytes from device memory,
// and the counts are shared-memory atomics, which contend on the hot
// central bins of a T-S diagram. The full 280x340 grid (381 KB of int32)
// does not fit one block's 227 KB of shared memory, so the T bins are cut
// into row chunks over gridDim.y, each at most kMaxChunkSlots slots, and
// every chunk's blocks visit all pairs. Blocks of the same blockIdx.x in
// the different chunks stream the same addresses at about the same time,
// so the repeated read can hit L2; a block digitizes T first and skips the
// S search for pairs outside its rows. Measured on an H100 80GB HBM3 at
// 700 W (tools/joint2_probe.py), the pass per chunk is what costs: each
// visit's two binary searches in shared memory, not device memory, set the
// pace (about 830 GB/s of input per chunk pass against ~2.8 TB/s for a
// plain read), so 280x340 in two chunks runs at about 410 GB/s. Integer
// atomics commute, so the result is deterministic and exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math: subnormal data must compare
// exactly against a 0.0 threshold (no flush to zero).

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kMaxChunkSlots = 48 * 1024;

// Number of thresholds t[k] with t[k] <= x (std::upper_bound), for x not
// NaN. t is non-decreasing and lives in shared memory.
__device__ __forceinline__ int upper_bound(const float* t, int n, float x) {
  int first = 0;
  int len = n;
  while (len > 0) {
    const int half = len >> 1;
    const bool right = t[first + half] <= x;
    first = right ? first + half + 1 : first;
    len = right ? len - half - 1 : half;
  }
  return first;
}

__global__ void __launch_bounds__(kThreads)
joint2_kernel(const float* __restrict__ a, const float* __restrict__ b,
              long long n, const float* __restrict__ thr_a, int nba,
              const float* __restrict__ thr_b, int nbb, int rows_per_chunk,
              unsigned long long* __restrict__ out) {
  extern __shared__ unsigned int smem[];
  float* ta = reinterpret_cast<float*>(smem);
  float* tb = ta + (nba + 1);
  unsigned int* hist = reinterpret_cast<unsigned int*>(tb + (nbb + 1));

  const int row0 = blockIdx.y * rows_per_chunk;  // first T bin of the chunk
  const int rows = min(rows_per_chunk, nba - row0);
  const int chunk_slots = rows * nbb;

  for (int k = threadIdx.x; k <= nba; k += blockDim.x) ta[k] = thr_a[k];
  for (int k = threadIdx.x; k <= nbb; k += blockDim.x) tb[k] = thr_b[k];
  for (int s = threadIdx.x; s < chunk_slots; s += blockDim.x) hist[s] = 0u;
  __syncthreads();

  const long long step = (long long)blockDim.x * kUnroll;
  const long long stride = step * gridDim.x;
  for (long long base = (long long)blockIdx.x * step + threadIdx.x; base < n;
       base += stride) {
    float av[kUnroll];
    float bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + (long long)u * blockDim.x;
      av[u] = e < n ? a[e] : __int_as_float(0x7fc00000);  // NaN: no count
      bv[u] = e < n ? b[e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (isnan(av[u]) || isnan(bv[u])) continue;
      const int i = upper_bound(ta, nba + 1, av[u]) - 1 - row0;
      if (i < 0 || i >= rows) continue;
      const int j = upper_bound(tb, nbb + 1, bv[u]) - 1;
      if (j < 0 || j >= nbb) continue;
      atomicAdd(&hist[i * nbb + j], 1u);
    }
  }
  __syncthreads();

  unsigned long long* dst = out + (long long)row0 * nbb;
  for (int s = threadIdx.x; s < chunk_slots; s += blockDim.x) {
    const unsigned int v = hist[s];
    if (v) atomicAdd(&dst[s], (unsigned long long)v);
  }
}

// The SM count and resident blocks per SM for `smem` bytes of dynamic
// shared memory on the current device, after raising the kernel's shared
// memory limit to `smem`. Cached per device for the last `smem` asked for,
// so repeated calls of one problem shape make no attribute or occupancy
// queries.
cudaError_t launch_shape(size_t smem, int* sms, int* per_sm) {
  struct Shape {
    size_t smem;
    int sms;
    int per_sm;
  };
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static Shape cache[kMaxDevices] = {};

  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Shape& c = cache[device];
  if (c.smem != smem) {
    Shape fresh = {smem, 0, 0};
    if ((err = cudaFuncSetAttribute(joint2_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&fresh.sms,
                                      cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &fresh.per_sm, joint2_kernel, kThreads, smem)) != cudaSuccess)
      return err;
    if (fresh.per_sm < 1) return cudaErrorInvalidConfiguration;
    c = fresh;
  }
  *sms = c.sms;
  *per_sm = c.per_sm;
  return cudaSuccess;
}

}  // namespace

// Adds the joint counts of n pairs (a[e], b[e]) into out[nba * nbb], which
// the caller zeroes. Launches on `stream` and returns cudaGetLastError()
// (or the first failing CUDA call's error); never synchronises.
extern "C" int xh_joint2_f32(const void* a, const void* b, long long n,
                             const void* thr_a, int nba, const void* thr_b,
                             int nbb, void* out, void* stream) {
  if (n <= 0 || nba < 1 || nbb < 1) return (int)cudaErrorInvalidValue;
  const int rows_per_chunk =
      kMaxChunkSlots / nbb < nba ? kMaxChunkSlots / nbb : nba;
  if (rows_per_chunk < 1) return (int)cudaErrorInvalidValue;
  const int n_chunks = (nba + rows_per_chunk - 1) / rows_per_chunk;
  const size_t smem = sizeof(float) * (size_t)(nba + 1 + nbb + 1) +
                      sizeof(unsigned int) * (size_t)rows_per_chunk * nbb;

  int sms = 0;
  int per_sm = 0;
  const cudaError_t err = launch_shape(smem, &sms, &per_sm);
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
  joint2_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), n,
      static_cast<const float*>(thr_a), nba, static_cast<const float*>(thr_b),
      nbb, rows_per_chunk, static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
