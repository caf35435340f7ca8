// bloom_build / bloom_probe — the bloom runtime filter on Hopper.
//
// Replaces the TPU kernels src/repro/kernels/bloom.py (bloom_build /
// _build_kernel and bloom_probe / _probe_kernel). A key's k bit positions
// come from double hashing over the shuffle's murmur-style hash32:
//   h1 = hash32(key, seed1), h2 = hash32(key, seed2) | 1,
//   pos_i = (h1 + i * h2) & (m_bits - 1),  i < k,
// all in uint32 arithmetic, which wraps as the reference's does; the key's
// int32 bits are read as uint32, as numpy's astype(np.uint32) reads them.
// The filter is m_bits / 32 uint32 words, bit b of word w = position 32w + b.
//
// Bound on this card: bytes. The build reads 5 bytes a key (key, valid) and
// sets k bits; the probe reads 4 bytes a key and writes 1, with k word loads
// from a filter of at most 8 KB on the main path, which stays in L1/L2.
// The TPU version built and read the filter through one-hot matmuls, a
// workaround for having no scatter or gather. Here:
//  * build: one thread per key over a grid-stride loop, one atomicOr per bit
//    into the words, zeroed on the stream first; OR is order-free, so the
//    filter is bit-identical to the plain version whatever the schedule;
//  * probe: one thread per key, k word loads through the read-only cache
//    (__ldg), stopping at the first clear bit; invalid rows are probed too
//    (the caller ANDs the mask with its validity), one byte per key out.

#include <cstdint>

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint32_t hash32(uint32_t key, uint32_t seed) {
  uint32_t h = key * seed;
  h ^= h >> 15;
  h *= 0xC2B2AE35u;
  h ^= h >> 13;
  return h;
}

__global__ void bloom_build_kernel(const int* __restrict__ keys,
                                   const unsigned char* __restrict__ valid,
                                   long long n, uint32_t mask, int k,
                                   uint32_t seed1, uint32_t seed2,
                                   unsigned int* __restrict__ words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (!valid[i]) continue;
    const uint32_t key = static_cast<uint32_t>(keys[i]);
    const uint32_t h1 = hash32(key, seed1);
    const uint32_t h2 = hash32(key, seed2) | 1u;
    for (int j = 0; j < k; ++j) {
      const uint32_t pos = (h1 + static_cast<uint32_t>(j) * h2) & mask;
      atomicOr(&words[pos >> 5], 1u << (pos & 31u));
    }
  }
}

__global__ void bloom_probe_kernel(const int* __restrict__ keys, long long n,
                                   const unsigned int* __restrict__ words,
                                   uint32_t mask, int k, uint32_t seed1,
                                   uint32_t seed2,
                                   unsigned char* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t key = static_cast<uint32_t>(keys[i]);
    const uint32_t h1 = hash32(key, seed1);
    const uint32_t h2 = hash32(key, seed2) | 1u;
    bool keep = true;
    for (int j = 0; j < k && keep; ++j) {
      const uint32_t pos = (h1 + static_cast<uint32_t>(j) * h2) & mask;
      keep = (__ldg(&words[pos >> 5]) >> (pos & 31u)) & 1u;
    }
    out[i] = keep ? 1 : 0;
  }
}

}  // namespace

// keys, valid: (n,) int32 and bool; words: (m_bits / 32,) uint32, zeroed
// here. m_bits a power of two >= 32; n >= 1, k >= 1.
extern "C" int repro_bloom_build(const void* keys, const void* valid,
                                 long long n, int m_bits, int k,
                                 unsigned int seed1, unsigned int seed2,
                                 void* words, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(
      words, 0, static_cast<size_t>(m_bits / 32) * sizeof(unsigned int), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const int blocks = repro::grid_stride_blocks(n, kThreads, kBlocksPerSm);
  bloom_build_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int*>(keys), static_cast<const unsigned char*>(valid),
      n, static_cast<uint32_t>(m_bits - 1), k, seed1, seed2,
      static_cast<unsigned int*>(words));
  return static_cast<int>(cudaGetLastError());
}

// keys: (n,) int32, n >= 1; words: (m_bits / 32,) uint32; out: (n,) bool.
extern "C" int repro_bloom_probe(const void* keys, long long n,
                                 const void* words, int m_bits, int k,
                                 unsigned int seed1, unsigned int seed2,
                                 void* out, void* stream) {
  const int blocks = repro::grid_stride_blocks(n, kThreads, kBlocksPerSm);
  bloom_probe_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), n,
      static_cast<const unsigned int*>(words),
      static_cast<uint32_t>(m_bits - 1), k, seed1, seed2,
      static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
