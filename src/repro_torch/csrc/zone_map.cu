// key_range — the zone map's [min, max] reduce on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/zone_map.py (key_range /
// _minmax_kernel): out = [min, max] of the valid int32 keys, the empty
// interval [INT32_MAX, INT32_MIN] when no key is valid. Invalid keys take
// the identities, so they never move either end.
//
// Bound on this card: bytes (5 bytes read a key, one compare each way), but
// the main path's input is a dimension of a few hundred rows, so launch
// latency bounds it in practice. The TPU version carried the interval in
// its output block from one sequential grid step to the next; blocks here
// run in parallel, so:
//  * a grid-stride loop keeps each thread's own min and max in registers;
//  * __reduce_min_sync / __reduce_max_sync fold each warp, shared memory
//    the warps of a block;
//  * one atomicMin and one atomicMax per block fold the blocks into the
//    output, which a one-thread kernel sets to the empty interval first.
//    min and max are order-free, so the result is exact.

#include <climits>

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;

__global__ void empty_range_kernel(int* out) {
  out[0] = INT_MAX;
  out[1] = INT_MIN;
}

__global__ void key_range_kernel(const int* __restrict__ keys,
                                 const unsigned char* __restrict__ valid,
                                 long long n, int* __restrict__ out) {
  __shared__ int block_lo[kWarps];
  __shared__ int block_hi[kWarps];
  int lo = INT_MAX;
  int hi = INT_MIN;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (valid[i]) {
      const int key = keys[i];
      lo = min(lo, key);
      hi = max(hi, key);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    block_lo[warp] = lo;
    block_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kWarps ? block_lo[lane] : INT_MAX;
    hi = lane < kWarps ? block_hi[lane] : INT_MIN;
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      atomicMin(&out[0], lo);
      atomicMax(&out[1], hi);
    }
  }
}

}  // namespace

// keys, valid: (n,) int32 and bool, n >= 1; out: (2,) int32, set here.
extern "C" int repro_key_range(const void* keys, const void* valid,
                               long long n, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  empty_range_kernel<<<1, 1, 0, s>>>(o);
  const int blocks = repro::grid_stride_blocks(n, kThreads, kBlocksPerSm);
  key_range_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int*>(keys), static_cast<const unsigned char*>(valid),
      n, o);
  return static_cast<int>(cudaGetLastError());
}
