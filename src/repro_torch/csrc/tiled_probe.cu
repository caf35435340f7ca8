// tiled_probe — batched first-match probe of the radix hash join on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/tiled_probe.py
// (tiled_probe / _probe_kernel): for each batch row r and probe slot i,
//   out[r, i] = min{ j < nb : b[r, j] == a[r, i] }, else -1.
// Anything past nb never matches, which is the reference's rule that a hit
// in the padded tail (j >= nb) becomes -1.
//
// One launch covers every (partition, radix bucket) pair of a hash_join call:
// the batch axis replaces the reference's two nested vmaps.
//
// Bound on this card: bytes. The TPU kernel matches a probe tile against
// every build key (a dense equality matrix); here each build row becomes a
// first-match table (first_match.cuh), so a probe key costs one hash and
// about one lookup, and what is left is reading every key once and writing
// every output once. Most probe slots are padding (the hash join's tiles
// have 4x slack); they cost a lookup like any other key. Design:
//  * a row's table fits in shared memory (the wrapper decides, by size):
//    one block per (row, share of the row's slots), one wave over the card;
//    each block builds its row's table in shared memory once, then walks
//    its share of the row's probe slots, 1024 threads with four loads in
//    flight each;
//  * otherwise the tables live in device memory (scratch from the wrapper):
//    one launch sets them empty, one inserts every row's build, and the
//    probe launch reads them through the read-only cache, where they stay
//    resident in L2 if they fit.

#include <algorithm>

#include <cuda_runtime.h>

#include "first_match.cuh"

namespace {

using repro::kProbeThreads;
using repro::kProbeUnroll;

// Probe of one row's share of slots against its table (shared or global).
template <bool kGlobal>
__device__ __forceinline__ void probe_row(const unsigned long long* table,
                                          int log2cap,
                                          const int* __restrict__ a,
                                          int na, int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long i0 = static_cast<long long>(blockIdx.y) * blockDim.x +
                      threadIdx.x;
       i0 < na; i0 += kProbeUnroll * stride) {
    int key[kProbeUnroll];
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) {
      const long long i = i0 + u * stride;
      key[u] = i < na ? __ldcs(a + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < na) __stcs(out + i, repro::table_find<kGlobal>(table, log2cap,
                                                             key[u]));
    }
  }
}

__global__ void __launch_bounds__(kProbeThreads)
    probe_shared_table(const int* __restrict__ a, const int* __restrict__ b,
                       int na, int nb, int log2cap, int* __restrict__ out) {
  extern __shared__ unsigned long long table[];
  const long long row = blockIdx.x;
  repro::fill_empty(table, 1LL << log2cap, threadIdx.x, blockDim.x);
  __syncthreads();
  repro::insert_row(table, log2cap, b + row * nb, nb, threadIdx.x,
                    blockDim.x);
  __syncthreads();
  probe_row<false>(table, log2cap, a + row * na, na, out + row * na);
}

__global__ void fill_tables(unsigned long long* __restrict__ tables,
                            long long n) {
  repro::fill_empty(tables,
                    n, static_cast<long long>(blockIdx.x) * blockDim.x +
                           threadIdx.x,
                    static_cast<long long>(gridDim.x) * blockDim.x);
}

__global__ void __launch_bounds__(kProbeThreads)
    build_tables(const int* __restrict__ b, int nb, int log2cap,
                 unsigned long long* __restrict__ tables) {
  const long long row = blockIdx.x;
  repro::insert_row(tables + (row << log2cap), log2cap, b + row * nb, nb,
                    static_cast<long long>(blockIdx.y) * blockDim.x +
                        threadIdx.x,
                    static_cast<long long>(gridDim.y) * blockDim.x);
}

__global__ void __launch_bounds__(kProbeThreads)
    probe_global_table(const int* __restrict__ a, int na, int log2cap,
                       const unsigned long long* __restrict__ tables,
                       int* __restrict__ out) {
  const long long row = blockIdx.x;
  probe_row<true>(tables + (row << log2cap), log2cap, a + row * na, na,
                  out + row * na);
}

}  // namespace

// a: (batch, na), b: (batch, nb), out: (batch, na), all int32 row-major;
// batch >= 1, na >= 1, nb >= 1; each row's table has 2^log2cap slots
// (>= 1.5 nb). tables: nullptr for tables in shared memory (8 << log2cap
// bytes a block), else (batch << log2cap) uint64 words of scratch.
extern "C" int repro_tiled_probe(const void* a, const void* b, int batch,
                                 int na, int nb, int log2cap, void* tables,
                                 void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int* ak = static_cast<const int*>(a);
  const int* bk = static_cast<const int*>(b);
  int* o = static_cast<int*>(out);
  cudaError_t err;
  if (tables == nullptr) {
    const size_t smem = sizeof(unsigned long long) << log2cap;
    const void* kernel = reinterpret_cast<const void*>(probe_shared_table);
    if ((err = repro::allow_shared(kernel, smem)) != cudaSuccess) return err;
    const int per_row = repro::probe_blocks_per_row(kernel, smem, batch, na,
                                                    &err);
    if (err != cudaSuccess) return err;
    probe_shared_table<<<dim3(batch, per_row), kProbeThreads, smem, s>>>(
        ak, bk, na, nb, log2cap, o);
    return static_cast<int>(cudaGetLastError());
  }
  auto* t = static_cast<unsigned long long*>(tables);
  const long long words = static_cast<long long>(batch) << log2cap;
  fill_tables<<<repro::grid_stride_blocks(words, 256, 8), 256, 0, s>>>(
      t, words);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int build_per_row = static_cast<int>(
      std::min<long long>(65535, (nb + kProbeThreads - 1) / kProbeThreads));
  build_tables<<<dim3(batch, build_per_row), kProbeThreads, 0, s>>>(
      bk, nb, log2cap, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const void* kernel = reinterpret_cast<const void*>(probe_global_table);
  const int per_row = repro::probe_blocks_per_row(kernel, 0, batch, na, &err);
  if (err != cudaSuccess) return err;
  probe_global_table<<<dim3(batch, per_row), kProbeThreads, 0, s>>>(
      ak, na, log2cap, t, o);
  return static_cast<int>(cudaGetLastError());
}
