// tiled_probe3 — fused two-build first-match probe of the hypercube
// multi-way join on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/tiled_probe.py
// (tiled_probe3 / _probe3_kernel): for each batch row r and probe slot i,
//   out1[r, i] = min{ j < nb : b[r, j] == a1[r, i] }, else -1,
//   out2[r, i] = min{ k < nc : c[r, k] == a2[r, i] }, else -1.
// The two builds keep their own lengths; the reference pads both to one
// length with -2 and turns any hit at or past a build's own length into -1,
// which is what tables of only j < nb and k < nc give. Keys are compared as
// they are, so a probe key of -1 meets a valid build key of -1 on either
// side, as in the reference. An empty build (nb or nc 0) has an empty
// one-slot table, so its side is all -1.
//
// One launch covers every partition of the cube (the batch axis replaces
// the reference's vmap over partitions).
//
// Bound on this card: bytes. The TPU kernel matches every probe slot with
// every build key of its partition (the join is dense: no radix buckets),
// and most slots are padding or misses that would scan both builds whole.
// Here each build row becomes a first-match table (first_match.cuh), so a
// slot costs one hash and about one lookup per side, and what is left is
// reading the two probe columns and writing the two outputs. Design, as
// tiled_probe.cu:
//  * both rows' tables fit in shared memory together (the wrapper decides,
//    by size; up to 227 KB after the opt-in): one block per (row, share of
//    the row's slots), one wave over the card; each block builds the two
//    tables side by side in shared memory once, then walks its share of the
//    row's probe slots, four slots (eight keys) loaded ahead per thread;
//  * otherwise the tables live in device memory (scratch from the wrapper):
//    one launch sets them empty, one inserts both builds of every row, and
//    the probe launch reads them through the read-only cache.

#include <algorithm>

#include <cuda_runtime.h>

#include "first_match.cuh"

namespace {

using repro::kProbeThreads;
using repro::kProbeUnroll;

template <bool kGlobal>
__device__ __forceinline__ void probe_row(
    const unsigned long long* table_b, int log2cap_b,
    const unsigned long long* table_c, int log2cap_c,
    const int* __restrict__ a1, const int* __restrict__ a2, int na,
    int* __restrict__ out1, int* __restrict__ out2) {
  const long long stride = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long i0 = static_cast<long long>(blockIdx.y) * blockDim.x +
                      threadIdx.x;
       i0 < na; i0 += kProbeUnroll * stride) {
    int key1[kProbeUnroll];
    int key2[kProbeUnroll];
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) {
      const long long i = i0 + u * stride;
      key1[u] = i < na ? __ldcs(a1 + i) : 0;
      key2[u] = i < na ? __ldcs(a2 + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < na) {
        __stcs(out1 + i,
               repro::table_find<kGlobal>(table_b, log2cap_b, key1[u]));
        __stcs(out2 + i,
               repro::table_find<kGlobal>(table_c, log2cap_c, key2[u]));
      }
    }
  }
}

__global__ void __launch_bounds__(kProbeThreads)
    probe3_shared_tables(const int* __restrict__ a1,
                         const int* __restrict__ a2,
                         const int* __restrict__ b,
                         const int* __restrict__ c, int na, int nb, int nc,
                         int log2cap_b, int log2cap_c,
                         int* __restrict__ out1, int* __restrict__ out2) {
  extern __shared__ unsigned long long tables[];
  const long long row = blockIdx.x;
  const long long cap_b = 1LL << log2cap_b;
  unsigned long long* table_b = tables;
  unsigned long long* table_c = tables + cap_b;
  repro::fill_empty(tables, cap_b + (1LL << log2cap_c), threadIdx.x,
                    blockDim.x);
  __syncthreads();
  repro::insert_row(table_b, log2cap_b, b + row * nb, nb, threadIdx.x,
                    blockDim.x);
  repro::insert_row(table_c, log2cap_c, c + row * nc, nc, threadIdx.x,
                    blockDim.x);
  __syncthreads();
  probe_row<false>(table_b, log2cap_b, table_c, log2cap_c, a1 + row * na,
                   a2 + row * na, na, out1 + row * na, out2 + row * na);
}

__global__ void fill_tables(unsigned long long* __restrict__ tables,
                            long long n) {
  repro::fill_empty(tables,
                    n, static_cast<long long>(blockIdx.x) * blockDim.x +
                           threadIdx.x,
                    static_cast<long long>(gridDim.x) * blockDim.x);
}

// blockIdx.z picks the side: 0 inserts b into the first batch tables of
// 2^log2cap_b slots, 1 inserts c into the batch tables after them.
__global__ void __launch_bounds__(kProbeThreads)
    build_tables(const int* __restrict__ b, const int* __restrict__ c,
                 int batch, int nb, int nc, int log2cap_b, int log2cap_c,
                 unsigned long long* __restrict__ tables) {
  const long long row = blockIdx.x;
  const bool side_c = blockIdx.z == 1;
  const int n = side_c ? nc : nb;
  const int log2cap = side_c ? log2cap_c : log2cap_b;
  unsigned long long* table =
      tables + (side_c ? static_cast<long long>(batch) << log2cap_b : 0) +
      (row << log2cap);
  repro::insert_row(table, log2cap, (side_c ? c : b) + row * n, n,
                    static_cast<long long>(blockIdx.y) * blockDim.x +
                        threadIdx.x,
                    static_cast<long long>(gridDim.y) * blockDim.x);
}

__global__ void __launch_bounds__(kProbeThreads)
    probe3_global_tables(const int* __restrict__ a1,
                         const int* __restrict__ a2, int batch, int na,
                         int log2cap_b, int log2cap_c,
                         const unsigned long long* __restrict__ tables,
                         int* __restrict__ out1, int* __restrict__ out2) {
  const long long row = blockIdx.x;
  const unsigned long long* table_b = tables + (row << log2cap_b);
  const unsigned long long* table_c =
      tables + (static_cast<long long>(batch) << log2cap_b) +
      (row << log2cap_c);
  probe_row<true>(table_b, log2cap_b, table_c, log2cap_c, a1 + row * na,
                  a2 + row * na, na, out1 + row * na, out2 + row * na);
}

}  // namespace

// a1, a2: (batch, na); b: (batch, nb); c: (batch, nc); out1, out2:
// (batch, na); all int32 row-major. batch >= 1, na >= 1, nb + nc >= 1; the
// rows' tables have 2^log2cap_b and 2^log2cap_c slots (>= 1.5 nb, 1.5 nc).
// tables: nullptr for tables in shared memory (8 << log2cap_b plus
// 8 << log2cap_c bytes a block), else batch * (2^log2cap_b + 2^log2cap_c)
// uint64 words of scratch.
extern "C" int repro_tiled_probe3(const void* a1, const void* a2,
                                  const void* b, const void* c, int batch,
                                  int na, int nb, int nc, int log2cap_b,
                                  int log2cap_c, void* tables, void* out1,
                                  void* out2, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int* a1k = static_cast<const int*>(a1);
  const int* a2k = static_cast<const int*>(a2);
  const int* bk = static_cast<const int*>(b);
  const int* ck = static_cast<const int*>(c);
  int* o1 = static_cast<int*>(out1);
  int* o2 = static_cast<int*>(out2);
  cudaError_t err;
  if (tables == nullptr) {
    const size_t smem = sizeof(unsigned long long) *
                        ((1ULL << log2cap_b) + (1ULL << log2cap_c));
    const void* kernel = reinterpret_cast<const void*>(probe3_shared_tables);
    if ((err = repro::allow_shared(kernel, smem)) != cudaSuccess) return err;
    const int per_row = repro::probe_blocks_per_row(kernel, smem, batch, na,
                                                    &err);
    if (err != cudaSuccess) return err;
    probe3_shared_tables<<<dim3(batch, per_row), kProbeThreads, smem, s>>>(
        a1k, a2k, bk, ck, na, nb, nc, log2cap_b, log2cap_c, o1, o2);
    return static_cast<int>(cudaGetLastError());
  }
  auto* t = static_cast<unsigned long long*>(tables);
  const long long words = (static_cast<long long>(batch) << log2cap_b) +
                          (static_cast<long long>(batch) << log2cap_c);
  fill_tables<<<repro::grid_stride_blocks(words, 256, 8), 256, 0, s>>>(
      t, words);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int build_per_row = static_cast<int>(std::min<long long>(
      65535, (std::max(nb, nc) + kProbeThreads - 1) / kProbeThreads));
  build_tables<<<dim3(batch, build_per_row, 2), kProbeThreads, 0, s>>>(
      bk, ck, batch, nb, nc, log2cap_b, log2cap_c, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const void* kernel = reinterpret_cast<const void*>(probe3_global_tables);
  const int per_row = repro::probe_blocks_per_row(kernel, 0, batch, na, &err);
  if (err != cudaSuccess) return err;
  probe3_global_tables<<<dim3(batch, per_row), kProbeThreads, 0, s>>>(
      a1k, a2k, batch, na, log2cap_b, log2cap_c, t, o1, o2);
  return static_cast<int>(cudaGetLastError());
}
