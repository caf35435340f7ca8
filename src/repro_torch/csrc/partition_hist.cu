// partition_hist — histogram of shuffle destinations on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/partition_hist.py
// (partition_hist / _hist_kernel): counts[k] = #{i : dest[i] == k}, rows with
// dest < 0 (invalid) or dest >= nd ignored.
//
// Bound on this card: bytes. It reads 4n bytes and writes 4nd, with one
// compare per element, so the memory rate bounds it. The TPU version built a
// (tile, nd) one-hot matrix and summed its columns because the TPU lacks a
// scatter; Hopper has fast shared-memory atomics, so this kernel scatters
// directly instead of doing nd compares per row:
//  * a grid-stride loop keeps a few blocks per SM streaming coalesced loads;
//    the loop bound is the same for every lane of a warp, so the warp stays
//    converged for the vote below;
//  * each block counts into private shared-memory bins (nd <= 12288 ints fit
//    in 48 KB) and merges them into the output with one atomicAdd per bin;
//  * within a warp, lanes with the same destination are merged first
//    (__match_any_sync), so a small nd (the main path's nd = p = 8) does
//    not serialise 32 lanes on a handful of shared addresses;
//  * above 12288 bins the atomics go straight to global memory.

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBins = 12288;  // 48 KB of int bins
constexpr int kBlocksPerSm = 8;

// Every lane of the warp calls this; key < 0 marks a lane with nothing to add.
__device__ __forceinline__ void add_warp_aggregated(int* bins, int key) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int leader = __ffs(peers) - 1;
  if (key >= 0 && static_cast<int>(threadIdx.x & 31) == leader) {
    atomicAdd(&bins[key], __popc(peers));
  }
}

// Destination of element i, or -1 past the end or outside [0, nd).
__device__ __forceinline__ int load_key(const int* __restrict__ dest,
                                        long long i, long long n, int nd) {
  if (i >= n) return -1;
  const int d = dest[i];
  return (d >= 0 && d < nd) ? d : -1;
}

__global__ void hist_shared_bins(const int* __restrict__ dest, long long n,
                                 int nd, int* __restrict__ out) {
  extern __shared__ int bins[];
  for (int k = threadIdx.x; k < nd; k += blockDim.x) bins[k] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < n; base += stride) {
    add_warp_aggregated(bins, load_key(dest, base + threadIdx.x, n, nd));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nd; k += blockDim.x) {
    const int c = bins[k];
    if (c != 0) atomicAdd(&out[k], c);
  }
}

__global__ void hist_global_bins(const int* __restrict__ dest, long long n,
                                 int nd, int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < n; base += stride) {
    add_warp_aggregated(out, load_key(dest, base + threadIdx.x, n, nd));
  }
}

}  // namespace

// dest: (n,) int32; out: (nd,) int32, zeroed by the caller; n >= 1, nd >= 1.
extern "C" int repro_partition_hist(const void* dest, long long n, int nd,
                                    void* out, void* stream) {
  const int blocks = repro::grid_stride_blocks(n, kThreads, kBlocksPerSm);
  auto s = static_cast<cudaStream_t>(stream);
  const int* d = static_cast<const int*>(dest);
  int* o = static_cast<int*>(out);
  if (nd <= kMaxSharedBins) {
    hist_shared_bins<<<blocks, kThreads, nd * sizeof(int), s>>>(d, n, nd, o);
  } else {
    hist_global_bins<<<blocks, kThreads, 0, s>>>(d, n, nd, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
