// Launch-shape caches, the clustered launch and the launch record shared by
// the histogram kernels' launchers.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <utility>

namespace xh {

// What the last launch chose, for tools and tests (xh_last_launch in
// joint2.cu): blocks a cluster, passes over the data, histogram in shared
// memory (1) or device memory (0), and the cell-table sizes asked for the
// first two inputs; a one_input launch sets one_input and its counter
// layout (one_input.cuh) and copies of the histogram; a direct-row launch
// (direct.cuh) its warps a block (one row each at a time), blocks and the
// most rows a warp walks; a flat-slot launch whose float sums were kept as
// exact integers in shared memory (slot.cuh) sets exact; a one_input launch
// whose launcher zeroed the output before the kernel (a full reduction, rows
// split across column tiles; else the kernel stores every slot) sets zeroed;
// a flat-slot launch whose run pieces read each input a vector of
// neighbouring elements a thread (slot.cuh) sets vector.
struct LaunchRecord {
  int cluster;
  int passes;
  int shared;
  int cells[2];
  int one_input;
  int layout;
  int copies;
  int warps;
  int blocks;
  int rows_per_warp;
  int exact;
  int zeroed;
  int vector;
};
inline LaunchRecord last_launch = {};

// The SM count and resident blocks per SM of one kernel at `threads` threads
// and `smem` bytes of dynamic shared memory, after raising that kernel's
// shared-memory limit to `smem`. Each kernel instantiation keeps its own
// LaunchShape (a static in its launcher), which remembers per device the
// answer for the last (`threads`, `smem`) asked, so repeated calls of one
// problem shape make no attribute or occupancy query.
class LaunchShape {
 public:
  cudaError_t get(const void* kernel, int threads, size_t smem, int* sms,
                  int* per_sm) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    Entry& c = cache_[device];
    if (c.sms == 0 || c.smem != smem || c.threads != threads) {
      Entry fresh = {smem, threads, 0, 0};
      if ((err = cudaFuncSetAttribute(
               kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
               (int)smem)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(
               &fresh.sms, cudaDevAttrMultiProcessorCount, device)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &fresh.per_sm, kernel, threads, smem)) != cudaSuccess)
        return err;
      if (fresh.sms < 1 || fresh.per_sm < 1)
        return cudaErrorInvalidConfiguration;
      c = fresh;
    }
    *sms = c.sms;
    *per_sm = c.per_sm;
    return cudaSuccess;
  }

 private:
  struct Entry {
    size_t smem;
    int threads;
    int sms;
    int per_sm;
  };
  static constexpr int kMaxDevices = 64;
  std::mutex mu_;
  Entry cache_[kMaxDevices] = {};
};

inline cudaLaunchAttribute cluster_attribute(int cluster) {
  cudaLaunchAttribute a = {};
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = cluster;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

// The clusters of `cluster` blocks (1, 2, 4 or 8 along x) of one kernel at
// `threads` threads and `smem` bytes of dynamic shared memory that the card
// holds at once, after raising that kernel's shared-memory limit to `smem`;
// for one block a cluster, the SMs times the resident blocks an SM. Each
// kernel instantiation keeps one ClusterShape (a static in its launcher),
// which remembers per device the answer for the last (smem, cluster) asked.
// None resident (a cluster the card cannot place) is an error, never a
// smaller cluster.
class ClusterShape {
 public:
  cudaError_t get(const void* kernel, int threads, size_t smem, int cluster,
                  long long* resident) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    Entry& c = cache_[device];
    if (c.resident == 0 || c.smem != smem || c.cluster != cluster) {
      Entry fresh = {smem, cluster, 0};
      if ((err = cudaFuncSetAttribute(
               kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
               (int)smem)) != cudaSuccess)
        return err;
      if (cluster == 1) {
        int sms = 0;
        int per_sm = 0;
        if ((err = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, kernel, threads, smem)) != cudaSuccess)
          return err;
        fresh.resident = (long long)sms * per_sm;
      } else {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(cluster);
        cfg.blockDim = dim3(threads);
        cfg.dynamicSmemBytes = smem;
        cudaLaunchAttribute attr = cluster_attribute(cluster);
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) !=
            cudaSuccess)
          return err;
        fresh.resident = clusters;
      }
      if (fresh.resident < 1) return cudaErrorInvalidConfiguration;
      c = fresh;
    }
    *resident = c.resident;
    return cudaSuccess;
  }

 private:
  struct Entry {
    size_t smem;
    int cluster;
    long long resident;
  };
  static constexpr int kMaxDevices = 64;
  std::mutex mu_;
  Entry cache_[kMaxDevices] = {};
};

// kernel<<<grid, threads, smem, stream>>>(args...) in clusters of `cluster`
// blocks along x (gridDim.x a multiple of it), through cudaLaunchKernelEx;
// returns the launch's error, then cudaGetLastError().
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid, int threads,
                             size_t smem, int cluster, cudaStream_t stream,
                             Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr = cluster_attribute(cluster);
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace xh
