// Launch-shape cache shared by the histogram kernels' launchers.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace xh {

// The SM count and resident blocks per SM of one kernel at `threads` threads
// and `smem` bytes of dynamic shared memory, after raising that kernel's
// shared-memory limit to `smem`. Each kernel instantiation keeps its own
// LaunchShape (a static in its launcher), which remembers per device the
// answer for the last `smem` asked, so repeated calls of one problem shape
// make no attribute or occupancy query.
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
    if (c.sms == 0 || c.smem != smem) {
      Entry fresh = {smem, 0, 0};
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
    int sms;
    int per_sm;
  };
  static constexpr int kMaxDevices = 64;
  std::mutex mu_;
  Entry cache_[kMaxDevices] = {};
};

}  // namespace xh
