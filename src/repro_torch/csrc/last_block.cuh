// The finish of the one-launch reductions (partition_hist, bloom_build).
//
// Blocks of a grid cannot wait for each other, so such a kernel adds (or
// ORs) its blocks' results into an accumulator in device memory that is
// zero between calls, and the last block to finish moves it out. The
// accumulator and its ticket are the per-stream workspace of
// kernels/launch.py: calls on one stream run in order, and every call
// leaves both zero, so kernels of either kind can share it.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Every block calls this once, after its last update of acc: the block that
// takes the last ticket moves acc[0, count) into out and leaves acc and the
// ticket zero for the next call on the stream.
__device__ __forceinline__ void finish_last_block(int* __restrict__ acc,
                                                  unsigned* __restrict__ ticket,
                                                  int count,
                                                  int* __restrict__ out) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    out[k] = atomicExch(&acc[k], 0);
  }
  if (threadIdx.x == 0) atomicExch(ticket, 0u);
}

}  // namespace repro
