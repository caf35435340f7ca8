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
// The TPU version built and read the filter through one-hot matmuls, a
// workaround for having no scatter or gather.
//
// Build. Bound on this card: neither bytes nor operations. At the filter
// path's largest call (12,000 keys, 3,444 valid, m_bits 65,536, k = 8) it
// moves 68 KB and makes 250k operations, 0.00002 ms of work; what a call
// costs is its launch and the chain of dependent steps inside it. The
// kernel this replaces was two device activities a call, a memset of the
// words and then one global atomicOr a bit (27,552 at that input, queued
// on a few thousand L2 lines). Here a call is one launch with no memset,
// in one of three branches that the wrapper chooses from (n, m_bits)
// (kernels/bloom.py, build_branch) and passes as a code:
//  * cluster (n <= the wrapper's ONE_CLUSTER_KEYS, the filter in shared
//    memory; the filter path's case): one cluster of 8 blocks of 512
//    threads on 8 SMs. Each block zeroes a whole filter in its shared
//    memory (m_bits / 8 bytes, 8 KB at 65,536 bits) and ORs its share of
//    the keys' bits into it with shared atomics; after a cluster barrier,
//    block r ORs word slice r of the 8 filters, read through distributed
//    shared memory, and writes it out, zeros included. No global atomic,
//    no workspace. One block alone would hash every key on one SM:
//    0.0116-0.0137 ms at 12,000 keys, where the cluster takes 0.008 ms,
//    about 0.007 ms of it the fixed cost of a cluster launch (PERF.md);
//  * blocks (more keys, the filter in shared memory): each block builds the
//    filter of its keys in shared memory, then ORs its nonzero words into
//    the accumulator of the per-stream workspace (kernels/launch.py), which
//    is zero between calls; the last block to finish moves it into the
//    output with atomicExch, leaving it zero (last_block.cuh, partition_hist's
//    scheme). The merge makes up to blocks * m_words global atomics, so the
//    grid is cut to blocks * m_words <= n * k / 16 (at least one block,
//    at most one wave): the merge then makes at most a sixteenth as many
//    atomics as the keys would straight into device memory;
//  * device (filters larger than shared memory, m_bits > 2^20): every block
//    ORs straight into the accumulator, with the same finish.
// Each thread keeps the loads of four keys and their mask bytes in flight.
// OR is order-free, so the words are bit-identical to the plain version
// whatever the schedule.
//
// Probe. Bound on this card: integer operations. It reads 4 bytes a key and
// writes 1, but a key costs two hash chains (13 operations) and each bit it
// tests about 7 more, and that outweighs the bytes. Design:
//  * the filter is staged in shared memory once per block of a one-wave
//    grid (m_bits / 8 bytes: 8 KB at the main path's 65,536 bits), where
//    the wrapper finds it fits (227 KB, m_bits <= 2^20); larger filters are
//    read from device memory through the read-only cache (__ldg);
//  * each thread takes four keys at a time with one 16-byte load (a scalar
//    head and tail for views off a 16-byte boundary) and stores their four
//    bytes with one 32-bit store where the output allows it;
//  * the four keys' bit tests interleave, so their shared-memory loads are
//    in flight together; a bit costs an add, two operations for its word's
//    byte offset, the load, a funnel shift and an AND. Every key tests all
//    k bits, with no branch: the early exit of the one-key-a-thread kernel
//    this replaces saved nothing at the warp level (a warp of 32 keys at
//    the main path's 28.7% kept nearly always holds a kept key), and
//    variants that skipped a rejected key's later loads measured no
//    faster (PERF.md). Random word reads conflict on shared-memory banks:
//    of a warp's 32 reads of a 2,048-word filter, the busiest of the 32
//    banks is expected to take 3 or 4, and those wavefronts set the pace
//    together with the operations. Invalid rows are probed too (the
//    caller ANDs the mask with its validity).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "grid.cuh"
#include "last_block.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBuildThreads = 512;

__device__ __forceinline__ uint32_t hash32(uint32_t key, uint32_t seed) {
  uint32_t h = key * seed;
  h ^= h >> 15;
  h *= 0xC2B2AE35u;
  h ^= h >> 13;
  return h;
}

// Branch codes, in the order of the wrapper's BUILD_BRANCHES.
constexpr int kCluster = 0, kBlocks = 1, kDevice = 2;
constexpr int kClusterBlocks = 8;

// ORs the k bits of every valid key of this thread's share of a grid-stride
// loop over the n keys into `bits`, with the loads of four keys (and their
// mask bytes) in flight at a time.
__device__ __forceinline__ void or_keys(int* bits,
                                        const int* __restrict__ keys,
                                        const unsigned char* __restrict__ valid,
                                        long long n, uint32_t mask, int k,
                                        uint32_t seed1, uint32_t seed2) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += 4 * stride) {
    uint32_t key[4];
    bool live[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long j = i + e * stride;
      key[e] = j < n ? static_cast<uint32_t>(keys[j]) : 0u;
      live[e] = j < n && valid[j];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!live[e]) continue;
      uint32_t pos = hash32(key[e], seed1);
      const uint32_t step = hash32(key[e], seed2) | 1u;
      for (int j = 0; j < k; ++j, pos += step) {
        atomicOr(&bits[(pos & mask) >> 5],
                 static_cast<int>(1u << (pos & 31u)));
      }
    }
  }
}

// One cluster of kClusterBlocks blocks on as many SMs: each block zeroes a
// whole filter in its shared memory and ORs its share of the keys into it;
// then block r ORs word slice r of the cluster's filters, read through
// distributed shared memory, and writes it out.
__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kBuildThreads)
        bloom_build_cluster(const int* __restrict__ keys,
                            const unsigned char* __restrict__ valid,
                            long long n, int m_words, int k, uint32_t seed1,
                            uint32_t seed2, int* __restrict__ out) {
  extern __shared__ int filter[];
  for (int w = threadIdx.x; w < m_words; w += blockDim.x) filter[w] = 0;
  __syncthreads();
  or_keys(filter, keys, valid, n, 32u * m_words - 1u, k, seed1, seed2);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int slice = (m_words + kClusterBlocks - 1) / kClusterBlocks;
  const int begin = static_cast<int>(cluster.block_rank()) * slice;
  const int end = min(m_words, begin + slice);
  for (int w = begin + threadIdx.x; w < end; w += blockDim.x) {
    int word = 0;
#pragma unroll
    for (int b = 0; b < kClusterBlocks; ++b) {
      word |= cluster.map_shared_rank(filter, b)[w];
    }
    out[w] = word;
  }
  cluster.sync();  // no block leaves while another reads its filter
}

// SHARED: each block ORs into its own filter in shared memory and merges
// the nonzero words into acc; else every block ORs into acc directly.
template <bool SHARED>
__global__ void __launch_bounds__(kBuildThreads)
    bloom_build_kernel(const int* __restrict__ keys,
                       const unsigned char* __restrict__ valid, long long n,
                       int m_words, int k, uint32_t seed1, uint32_t seed2,
                       int* __restrict__ acc, unsigned* __restrict__ ticket,
                       int* __restrict__ out) {
  extern __shared__ int filter[];
  if (SHARED) {
    for (int w = threadIdx.x; w < m_words; w += blockDim.x) filter[w] = 0;
    __syncthreads();
  }
  or_keys(SHARED ? filter : acc, keys, valid, n, 32u * m_words - 1u, k,
          seed1, seed2);
  if (SHARED) {
    __syncthreads();
    for (int w = threadIdx.x; w < m_words; w += blockDim.x) {
      const int word = filter[w];
      if (word != 0) atomicOr(&acc[w], word);
    }
  }
  repro::finish_last_block(acc, ticket, m_words, out);
}

int launch_cluster(const int* keys, const unsigned char* valid, long long n,
                   int m_bits, int k, uint32_t seed1, uint32_t seed2,
                   int* out, cudaStream_t s) {
  const void* kernel = reinterpret_cast<const void*>(bloom_build_cluster);
  const size_t smem = static_cast<size_t>(m_bits) / 8;
  const cudaError_t err = repro::allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bloom_build_cluster<<<kClusterBlocks, kBuildThreads, smem, s>>>(
      keys, valid, n, m_bits / 32, k, seed1, seed2, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool SHARED>
int launch_blocks(const int* keys, const unsigned char* valid, long long n,
                  int m_bits, int k, uint32_t seed1, uint32_t seed2, int* acc,
                  unsigned* ticket, int* out, cudaStream_t s) {
  const void* kernel =
      reinterpret_cast<const void*>(bloom_build_kernel<SHARED>);
  const int m_words = m_bits / 32;
  const size_t smem = SHARED ? static_cast<size_t>(m_bits) / 8 : 0;
  const cudaError_t err = repro::allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = repro::wave_blocks(kernel, kBuildThreads, smem, n);
  if (SHARED) {
    // blocks * m_words <= n * k / 16: see the note at the top.
    const long long cap = n * k / (16LL * m_words);
    if (cap < blocks) blocks = cap > 1 ? static_cast<int>(cap) : 1;
  }
  bloom_build_kernel<SHARED><<<blocks, kBuildThreads, smem, s>>>(
      keys, valid, n, m_words, k, seed1, seed2, acc, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kProbeThreads = 512;

// The filter word at byte offset `off`: staged in shared memory, or in
// device memory.
template <bool SHARED>
__device__ __forceinline__ unsigned filter_word(const unsigned* words,
                                                uint32_t off) {
  const auto* w = reinterpret_cast<const unsigned*>(
      reinterpret_cast<const char*>(words) + off);
  if (SHARED) return *w;
  return __ldg(w);
}

// Keep bits (bit 8e for key e) of NK keys against the filter. A position
// p = pos & (m_bits - 1) lies in the word at byte offset (pos >> 3) &
// word_bytes (the filter's bytes less one, word-aligned), at bit pos & 31,
// which the funnel shift takes from pos itself: two operations for the
// word, one to bring the bit to bit 0.
template <bool SHARED, int NK>
__device__ __forceinline__ unsigned probe_keys(const unsigned* words,
                                               const uint32_t (&key)[NK],
                                               uint32_t word_bytes, int k,
                                               uint32_t seed1,
                                               uint32_t seed2) {
  uint32_t pos[NK], step[NK], keep[NK];
#pragma unroll
  for (int e = 0; e < NK; ++e) {
    pos[e] = hash32(key[e], seed1);
    step[e] = hash32(key[e], seed2) | 1u;
    keep[e] = 1u;
  }
  for (int j = 0; j < k; ++j) {
#pragma unroll
    for (int e = 0; e < NK; ++e) {
      const unsigned w =
          filter_word<SHARED>(words, (pos[e] >> 3) & word_bytes);
      keep[e] &= __funnelshift_r(w, w, pos[e]);
      pos[e] += step[e];
    }
  }
  unsigned out = 0;
#pragma unroll
  for (int e = 0; e < NK; ++e) out |= (keep[e] & 1u) << (8 * e);
  return out;
}

// WORD_STORE: the four output bytes of a vector start on a 4-byte
// boundary, so one 32-bit store writes them.
template <bool SHARED, bool WORD_STORE>
__global__ void __launch_bounds__(kProbeThreads)
    bloom_probe_kernel(const int* __restrict__ keys, long long n,
                       const unsigned* __restrict__ words, int nwords,
                       int k, uint32_t seed1, uint32_t seed2,
                       unsigned char* __restrict__ out) {
  extern __shared__ unsigned staged[];
  const unsigned* filter = words;
  if (SHARED) {
    if ((nwords & 3) == 0 && (reinterpret_cast<uintptr_t>(words) & 15) == 0) {
      const int4* src = reinterpret_cast<const int4*>(words);
      int4* dst = reinterpret_cast<int4*>(staged);
      for (int i = threadIdx.x; i < nwords / 4; i += blockDim.x) {
        dst[i] = __ldg(src + i);
      }
    } else {
      for (int i = threadIdx.x; i < nwords; i += blockDim.x) {
        staged[i] = __ldg(words + i);
      }
    }
    __syncthreads();
    filter = staged;
  }
  const uint32_t word_bytes = 4u * (nwords - 1);
  const long long off = (reinterpret_cast<uintptr_t>(keys) & 15) >> 2;
  long long head = off ? 4 - off : 0;
  if (head > n) head = n;
  const long long nvec = (n - head) >> 2;
  const long long tail_start = head + 4 * nvec;
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  // The head (keys before the first 16-byte boundary) and the tail, one
  // key a thread on the grid's first threads.
  if (gid < head + (n - tail_start)) {
    const long long i = gid < head ? gid : tail_start + (gid - head);
    const uint32_t key[1] = {static_cast<uint32_t>(keys[i])};
    out[i] = static_cast<unsigned char>(probe_keys<SHARED, 1>(
        filter, key, word_bytes, k, seed1, seed2));
  }
  for (long long j = gid; j < nvec; j += stride) {
    const long long i = head + 4 * j;
    const int4 x = __ldg(reinterpret_cast<const int4*>(keys + i));
    const uint32_t key[4] = {static_cast<uint32_t>(x.x),
                             static_cast<uint32_t>(x.y),
                             static_cast<uint32_t>(x.z),
                             static_cast<uint32_t>(x.w)};
    const unsigned bytes = probe_keys<SHARED, 4>(
        filter, key, word_bytes, k, seed1, seed2);
    if (WORD_STORE) {
      *reinterpret_cast<unsigned*>(out + i) = bytes;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[i + e] = static_cast<unsigned char>(bytes >> (8 * e));
      }
    }
  }
}

template <bool SHARED, bool WORD_STORE>
int launch_probe(const int* keys, long long n, const unsigned* words,
                 int m_bits, int k, uint32_t seed1, uint32_t seed2,
                 unsigned char* out, cudaStream_t s) {
  const void* kernel = reinterpret_cast<const void*>(
      bloom_probe_kernel<SHARED, WORD_STORE>);
  const size_t smem = SHARED ? static_cast<size_t>(m_bits) / 8 : 0;
  cudaError_t err = repro::allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = repro::wave_blocks(kernel, kProbeThreads, smem, n / 4);
  bloom_probe_kernel<SHARED, WORD_STORE>
      <<<blocks, kProbeThreads, smem, s>>>(
          keys, n, words, m_bits / 32, k, seed1, seed2, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool SHARED>
int dispatch_probe(const int* keys, long long n, const unsigned* words,
                   int m_bits, int k, uint32_t seed1, uint32_t seed2,
                   unsigned char* out, cudaStream_t s) {
  const uintptr_t head = ((16 - (reinterpret_cast<uintptr_t>(keys) & 15)) &
                          15) / 4;
  const bool word_store = ((reinterpret_cast<uintptr_t>(out) + head) & 3) == 0;
  return word_store ? launch_probe<SHARED, true>(keys, n, words, m_bits, k,
                                                 seed1, seed2, out, s)
                    : launch_probe<SHARED, false>(keys, n, words, m_bits, k,
                                                  seed1, seed2, out, s);
}

}  // namespace

// keys, valid: (n,) int32 and bool, n >= 1; m_bits a power of two >= 32,
// whose m_bits / 8 bytes fit in shared memory for kCluster and kBlocks;
// k >= 1; branch: kCluster, kBlocks or kDevice; workspace: (m_bits / 32 +
// 1,) int32, zero (the ticket, then the accumulator), used by no call in
// flight on another stream, left zero; kCluster does not touch it (null
// is allowed). words: (m_bits / 32,) uint32, every word written.
extern "C" int repro_bloom_build(const void* keys, const void* valid,
                                 long long n, int m_bits, int k,
                                 unsigned int seed1, unsigned int seed2,
                                 int branch, void* workspace, void* words,
                                 void* stream) {
  const auto* kp = static_cast<const int*>(keys);
  const auto* v = static_cast<const unsigned char*>(valid);
  auto* ticket = static_cast<unsigned*>(workspace);
  int* acc = static_cast<int*>(workspace) + 1;
  auto* out = static_cast<int*>(words);
  auto s = static_cast<cudaStream_t>(stream);
  switch (branch) {
    case kCluster:
      return launch_cluster(kp, v, n, m_bits, k, seed1, seed2, out, s);
    case kBlocks:
      return launch_blocks<true>(kp, v, n, m_bits, k, seed1, seed2, acc,
                                 ticket, out, s);
    case kDevice:
      return launch_blocks<false>(kp, v, n, m_bits, k, seed1, seed2, acc,
                                  ticket, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// keys: (n,) int32, n >= 1; words: (m_bits / 32,) uint32; out: (n,) bool.
// shared: stage the filter in shared memory (m_bits / 8 bytes must fit).
extern "C" int repro_bloom_probe(const void* keys, long long n,
                                 const void* words, int m_bits, int k,
                                 unsigned int seed1, unsigned int seed2,
                                 int shared, void* out, void* stream) {
  const auto* kp = static_cast<const int*>(keys);
  const auto* w = static_cast<const unsigned*>(words);
  auto* o = static_cast<unsigned char*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return shared ? dispatch_probe<true>(kp, n, w, m_bits, k, seed1, seed2, o, s)
                : dispatch_probe<false>(kp, n, w, m_bits, k, seed1, seed2, o,
                                        s);
}
