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

}  // namespace repro
