// The finish of the one-launch reductions (partition_hist, bloom_build,
// key_range).
//
// Blocks of a grid cannot wait for each other, so such a kernel adds (ORs,
// or folds by atomicMax) its blocks' results into an accumulator in device
// memory that is zero between calls, and the last block to finish moves it
// out. The accumulator and its ticket are the per-stream workspace of
// kernels/launch.py: calls on one stream run in order, and every call
// leaves both zero, so kernels of any of these kinds can share it. A
// reduction whose identity is not zero keeps an encoding whose identity is
// (key_range), and passes its decode.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// The accumulator's words as they are.
struct KeepWord {
  __device__ int operator()(int /*k*/, int word) const { return word; }
};

// Every block calls this once, after its last update of acc: the block that
// takes the last ticket moves decode(k, acc[k]) for k in [0, count) into
// out[k] and leaves acc and the ticket zero for the next call on the stream.
template <class Decode = KeepWord>
__device__ __forceinline__ void finish_last_block(int* __restrict__ acc,
                                                  unsigned* __restrict__ ticket,
                                                  int count,
                                                  int* __restrict__ out,
                                                  Decode decode = Decode()) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    out[k] = decode(k, atomicExch(&acc[k], 0));
  }
  if (threadIdx.x == 0) atomicExch(ticket, 0u);
}

}  // namespace repro
