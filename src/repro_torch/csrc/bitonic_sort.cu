// bitonic_sort — batched in-shared-memory tile sort of the sort join on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bitonic_sort.py
// (bitonic_sort_tile / _bitonic_kernel): sorts each row of n int32
// (key, value) pairs ascending by key, n a power of two <= 4096. The network
// is the reference's exactly (pair (i, i | j) for i with bit j clear,
// ascending iff (i & k) == 0), so ties come out in the same order as there;
// the sort is not stable.
//
// Bound on this card: operations at the main path's sizes. A tile of n keys
// takes log2 n (log2 n + 1) / 2 compare-exchange stages of n/2 pairs, while
// it reads and writes only 16 n bytes. Design:
//  * one block per row; the whole tile (keys and values, 32 KB at n = 4096)
//    sits in shared memory, so every stage runs out of device memory;
//  * a block has at most 1024 threads and a 4096 tile has 2048 pairs per
//    stage, so each thread handles n/2 / blockDim.x pairs of a stage;
//  * __syncthreads() separates the stages.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTile = 4096;
constexpr int kMaxThreads = 1024;

__global__ void bitonic_sort_kernel(const int* __restrict__ keys,
                                    const int* __restrict__ vals, int n,
                                    int* __restrict__ keys_out,
                                    int* __restrict__ vals_out) {
  extern __shared__ int tile[];
  int* sk = tile;
  int* sv = tile + n;
  const long long off = static_cast<long long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sk[i] = keys[off + i];
    sv[i] = vals[off + i];
  }
  __syncthreads();
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int lo = 2 * t - (t & (j - 1));  // index with bit j clear
        const int hi = lo + j;
        const bool ascending = (lo & k) == 0;
        const int kl = sk[lo];
        const int kh = sk[hi];
        if (ascending ? (kl > kh) : (kl < kh)) {
          sk[lo] = kh;
          sk[hi] = kl;
          const int v = sv[lo];
          sv[lo] = sv[hi];
          sv[hi] = v;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    keys_out[off + i] = sk[i];
    vals_out[off + i] = sv[i];
  }
}

}  // namespace

// keys, vals, keys_out, vals_out: (batch, n) int32 row-major;
// batch >= 1, n a power of two in [1, 4096].
extern "C" int repro_bitonic_sort(const void* keys, const void* vals,
                                  int batch, int n, void* keys_out,
                                  void* vals_out, void* stream) {
  if (n < 1 || n > kMaxTile || (n & (n - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int threads = n / 2;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 1) threads = 1;
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(int);
  bitonic_sort_kernel<<<batch, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(vals), n,
      static_cast<int*>(keys_out), static_cast<int*>(vals_out));
  return static_cast<int>(cudaGetLastError());
}
