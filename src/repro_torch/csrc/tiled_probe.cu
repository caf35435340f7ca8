// tiled_probe — batched first-match probe of the radix hash join on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/tiled_probe.py
// (tiled_probe / _probe_kernel): for each batch row r and probe slot i,
//   out[r, i] = min{ j < nb : b[r, j] == a[r, i] }, else -1.
// Build pads (and anything past nb) never match, which is the reference's
// rule that a hit in the padded tail (j >= nb) becomes -1.
//
// One launch covers every (partition, radix bucket) pair of a hash_join call:
// the batch axis replaces the reference's two nested vmaps.
//
// Bound on this card: operations. Each probe key is compared with build keys
// until its first hit (all nb of them on a miss, and most bucket slots are
// probe padding that misses), against 4 bytes read per key. Design:
//  * one block per (batch row, tile of 256 probe slots); each thread owns one
//    probe key in a register;
//  * the block stages the build row in shared memory, 4096 keys (16 KB) at a
//    time, with coalesced loads; every thread then reads the same shared
//    word at the same step, a broadcast with no bank conflicts;
//  * each thread scans ascending j and stops at its first hit, which keeps
//    first-match semantics on duplicate build keys without a hash table;
//  * the block stops staging chunks once every thread has its hit.

#include <cuda_runtime.h>

namespace {

constexpr int kProbeThreads = 256;
constexpr int kBuildChunk = 4096;

__global__ void tiled_probe_kernel(const int* __restrict__ a,
                                   const int* __restrict__ b, int na, int nb,
                                   int* __restrict__ out) {
  __shared__ int build[kBuildChunk];
  const long long row = blockIdx.x;
  const int i = blockIdx.y * kProbeThreads + threadIdx.x;
  const bool live = i < na;
  const int key = live ? a[row * na + i] : 0;
  const int* brow = b + row * nb;
  int hit = -1;
  bool done = !live;
  for (int base = 0; base < nb; base += kBuildChunk) {
    // Also the barrier that protects `build` before it is refilled.
    if (__syncthreads_and(done)) break;
    const int len = min(kBuildChunk, nb - base);
    for (int j = threadIdx.x; j < len; j += kProbeThreads) {
      build[j] = brow[base + j];
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < len; ++j) {
        if (build[j] == key) {
          hit = base + j;
          done = true;
          break;
        }
      }
    }
  }
  if (live) out[row * na + i] = hit;
}

}  // namespace

// a: (batch, na), b: (batch, nb), out: (batch, na), all int32 row-major.
// batch >= 1, na >= 1, ceil(na / 256) <= 65535.
extern "C" int repro_tiled_probe(const void* a, const void* b, int batch,
                                 int na, int nb, void* out, void* stream) {
  const dim3 grid(batch, (na + kProbeThreads - 1) / kProbeThreads);
  tiled_probe_kernel<<<grid, kProbeThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b), na, nb,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
