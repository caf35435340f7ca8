// Launch geometry shared by the grid-stride kernels.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Streaming multiprocessors of the current card (read once per process).
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

// Blocks for a grid-stride loop over n >= 1 elements: one element per
// thread, at most `blocks_per_sm` resident blocks on every SM.
inline int grid_stride_blocks(long long n, int threads, int blocks_per_sm) {
  const long long want = (n + threads - 1) / threads;
  const long long cap = static_cast<long long>(sm_count()) * blocks_per_sm;
  return static_cast<int>(want < cap ? want : cap);
}

// Blocks of `threads` for a one-wave grid over `work` items, one item a
// thread: at most as many blocks of `kernel` as are resident on the card
// at once with `smem_bytes` of dynamic shared memory each, and at least 1.
inline int wave_blocks(const void* kernel, int threads, size_t smem_bytes,
                       long long work) {
  int resident = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads,
                                                smem_bytes);
  const long long cap =
      static_cast<long long>(sm_count()) * (resident > 0 ? resident : 1);
  const long long want = (work + threads - 1) / threads;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

// Shared memory above the default 48 KB a block, the kernel's static shared
// memory included, needs the kernel's opt-in to `smem_bytes` of dynamic
// shared memory first.
inline cudaError_t allow_shared(const void* kernel, size_t smem_bytes) {
  if (smem_bytes == 0) return cudaSuccess;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.sharedSizeBytes + smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

}  // namespace repro
