// key_range — the zone map's [min, max] reduce on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/zone_map.py (key_range /
// _minmax_kernel): out = [min, max] of the valid int32 keys, the empty
// interval [INT32_MAX, INT32_MIN] when no key is valid (n = 0 included).
// Invalid keys take the identities, so they never move either end.
//
// Bound on this card: bytes (5 bytes read a key, one compare each way), but
// the filter path's input is a dimension of a few hundred keys (8 x 45 at
// scale 30), 0.0000005 ms of bytes; what a call costs there is its launch
// and the chain of dependent steps inside it. The kernel this replaces was
// two device activities a call: a one-thread kernel that set the output to
// the empty interval, then a grid whose blocks folded into it with a global
// atomicMin and atomicMax each; on empty input its wrapper wrote the
// output with two host fills instead. Here a call is one launch with no
// fill, in one of two branches that the wrapper chooses from n
// (kernels/zone_map.py, range_branch) and passes as a code:
//  * block (n <= the wrapper's ONE_BLOCK_KEYS; the filter path's case):
//    one block of kBlockThreads threads. Each thread folds its keys into a
//    min and a max in registers, __reduce_min_sync / __reduce_max_sync
//    fold each warp and shared memory the warps; thread 0 writes both words
//    of the output. No global atomic, no workspace. The rule for the limit:
//    the largest n at which one block measured no slower than the grid on
//    an H100 (PERF.md, the sweep of tools/time_sort_bloom.py);
//  * blocks (more keys): a grid-stride loop over a one-wave grid of
//    kThreads-thread blocks, each folded as above, then into the
//    accumulator of the per-stream workspace (kernels/launch.py, shared
//    with partition_hist and bloom_build), which is zero between calls.
//    Zero is the identity of neither min nor max, so the accumulator holds
//    encodings whose identity is zero and that order as the values do:
//    INT32_MAX - lo and hi ^ 0x80000000, both as unsigned words, both
//    folded with atomicMax (a block with no valid key adds nothing). The
//    last block to finish decodes them into the output with atomicExch,
//    leaving the accumulator zero (last_block.cuh).
// Each thread keeps the loads of four keys and their mask bytes in flight.
// min and max are order-free, so the result is exact in either branch.

#include <climits>

#include <cuda_runtime.h>

#include "grid.cuh"
#include "last_block.cuh"

namespace {

constexpr int kBlockThreads = 1024;
constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;
constexpr int kLoads = 4;  // keys a thread has in flight

// Branch codes, in the order of the wrapper's RANGE_BRANCHES.
constexpr int kBlock = 0, kBlocks = 1;

// The accumulator's encodings: zero at the identity (lo = INT_MAX,
// hi = INT_MIN), and larger for a smaller lo or a larger hi.
__device__ __forceinline__ unsigned encode_lo(int lo) {
  return static_cast<unsigned>(INT_MAX) - static_cast<unsigned>(lo);
}
__device__ __forceinline__ unsigned encode_hi(int hi) {
  return static_cast<unsigned>(hi) ^ 0x80000000u;
}

struct DecodeRange {
  __device__ int operator()(int k, int word) const {
    const unsigned w = static_cast<unsigned>(word);
    return static_cast<int>(k == 0 ? static_cast<unsigned>(INT_MAX) - w
                                   : w ^ 0x80000000u);
  }
};

// The block's [min, max] of the valid keys of its share of a grid-stride
// loop over the n keys, in thread 0 (the identities where none is valid).
template <int THREADS>
__device__ __forceinline__ void block_range(
    const int* __restrict__ keys, const unsigned char* __restrict__ valid,
    long long n, int& lo, int& hi) {
  constexpr int kWarps = THREADS / 32;
  __shared__ int warp_lo[kWarps];
  __shared__ int warp_hi[kWarps];
  lo = INT_MAX;
  hi = INT_MIN;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += kLoads * stride) {
    int key[kLoads];
    bool live[kLoads];
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const long long j = i + e * stride;
      key[e] = j < n ? keys[j] : 0;
      live[e] = j < n && valid[j];
    }
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      if (live[e]) {
        lo = min(lo, key[e]);
        hi = max(hi, key[e]);
      }
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    warp_lo[warp] = lo;
    warp_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kWarps ? warp_lo[lane] : INT_MAX;
    hi = lane < kWarps ? warp_hi[lane] : INT_MIN;
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
  }
}

__global__ void __launch_bounds__(kBlockThreads)
    key_range_block(const int* __restrict__ keys,
                    const unsigned char* __restrict__ valid, long long n,
                    int* __restrict__ out) {
  int lo, hi;
  block_range<kBlockThreads>(keys, valid, n, lo, hi);
  if (threadIdx.x == 0) {
    out[0] = lo;
    out[1] = hi;
  }
}

__global__ void __launch_bounds__(kThreads)
    key_range_blocks(const int* __restrict__ keys,
                     const unsigned char* __restrict__ valid, long long n,
                     unsigned* __restrict__ ticket, int* __restrict__ acc,
                     int* __restrict__ out) {
  int lo, hi;
  block_range<kThreads>(keys, valid, n, lo, hi);
  if (threadIdx.x == 0 && lo <= hi) {
    auto* words = reinterpret_cast<unsigned*>(acc);
    atomicMax(&words[0], encode_lo(lo));
    atomicMax(&words[1], encode_hi(hi));
  }
  repro::finish_last_block(acc, ticket, 2, out, DecodeRange());
}

}  // namespace

// keys, valid: (n,) int32 and bool, n >= 0 (null for n = 0); branch: kBlock
// or kBlocks (n >= 1); workspace: (3,) int32 at least, zero (the ticket,
// then the accumulator), used by no call in flight on another stream, left
// zero; kBlock does not touch it (null is allowed). out: (2,) int32, both
// words written.
extern "C" int repro_key_range(const void* keys, const void* valid,
                               long long n, int branch, void* workspace,
                               void* out, void* stream) {
  const auto* k = static_cast<const int*>(keys);
  const auto* v = static_cast<const unsigned char*>(valid);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (branch) {
    case kBlock:
      key_range_block<<<1, kBlockThreads, 0, s>>>(k, v, n, o);
      return static_cast<int>(cudaGetLastError());
    case kBlocks: {
      if (n < 1) break;
      const int blocks = repro::grid_stride_blocks(
          (n + kLoads - 1) / kLoads, kThreads, kBlocksPerSm);
      key_range_blocks<<<blocks, kThreads, 0, s>>>(
          k, v, n, static_cast<unsigned*>(workspace),
          static_cast<int*>(workspace) + 1, o);
      return static_cast<int>(cudaGetLastError());
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
