// move_rows — every column of a table gathered through one index map, in one
// launch per element width.
//
// Replaces no TPU kernel. The JAX package moves rows with one jnp.take per
// column (src/repro/joins/slots.py, gather_rows) and the exchange's
// all-to-all with an axis transpose, both left to XLA. The port made one
// torch.gather per column and, in the exchange, one transpose copy per
// column: at TPC-DS SF1 some 230 column moves a query, each its own
// launches, while the card waited for the host between them. This kernel
// moves every column of one call (kernels/move_rows.py: the exchange's
// all-to-all, compact_partitions and the join's payload merge).
//
// Semantics (the plain version: kernels/ref.py, move_rows_ref). The index
// is (S, D, pc) with rows idx_row elements apart (D = 1 for a gather
// through an (S, M) index, pc = M). Slot (s, d, j) lands at
// d * S * pc + s * pc + j of every output, so D > 1 writes the all-to-all's
// received layout (D, S * pc) directly, with no transpose copy:
//   out_k[slot] = zero_fill && idx < 0 ? 0 : col_k[s * stride_k + max(idx, 0)]
//   valid[slot] = idx >= 0
// stride_k is column k's row stride in elements, 0 for a replica column
// that every s reads (the payload merge after a broadcast).
//
// Bound on this card: bytes. Per slot the index is read once (4 or 8 B),
// then each column is read and written once (4 B for int32 and float32).
// Design: a block loads a tile of kThreads * kSlots indices into
// registers, with each slot's source row and output position worked out
// once, then loops over the columns with kSlots loads in flight a thread.
// Consecutive threads take consecutive slots, so the index reads and every
// column's writes are coalesced; the reads follow the index, which the
// exchange's stable grouping keeps ascending within a run. The column
// pointers travel by value in a parameter struct, kMaxCols a launch (the C
// entry point chunks), so a call of one element width is one launch. A
// grid of fewer than two blocks an SM splits the columns over blockIdx.y,
// so that small inputs still fill the 132 SMs.

#include <cstdint>

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 8;  // slots a thread holds
constexpr long long kTile = static_cast<long long>(kThreads) * kSlots;
// Columns a launch carries; kernels/move_rows.py's MAX_COLS.
constexpr int kMaxCols = 64;

template <typename T>
struct Columns {
  const T* src[kMaxCols];
  T* dst[kMaxCols];
  long long stride[kMaxCols];  // source row stride in elements; 0: replica
  int n;
};

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    move_rows_kernel(const I* __restrict__ idx, long long idx_row,
                     unsigned S, unsigned D, unsigned pc, unsigned total,
                     const Columns<T> cols, int zero_fill,
                     unsigned char* __restrict__ valid) {
  const unsigned per_src = D * pc;
  const unsigned recv_row = S * pc;
  unsigned row[kSlots];  // source row s of the slot
  long long at[kSlots];  // max(idx, 0)
  unsigned to[kSlots];   // output position
  bool in[kSlots], live[kSlots];
  const unsigned base =
      static_cast<unsigned>(blockIdx.x * kTile) + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kSlots; ++e) {
    const unsigned t = base + e * kThreads;
    in[e] = t < total;
    const unsigned s = in[e] ? t / per_src : 0;
    const unsigned r = t - s * per_src;
    const unsigned d = r / pc;
    const long long i =
        in[e] ? static_cast<long long>(idx[s * idx_row + r]) : -1;
    live[e] = i >= 0;
    row[e] = s;
    at[e] = i > 0 ? i : 0;
    to[e] = d * recv_row + s * pc + (r - d * pc);
  }
  if (valid != nullptr && blockIdx.y == 0) {
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      if (in[e]) valid[to[e]] = live[e];
    }
  }
  for (int k = blockIdx.y; k < cols.n; k += gridDim.y) {
    const T* __restrict__ src = cols.src[k];
    T* __restrict__ dst = cols.dst[k];
    const long long stride = cols.stride[k];
    T v[kSlots];
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      v[e] = in[e] && (live[e] || !zero_fill) ? src[row[e] * stride + at[e]]
                                              : T(0);
    }
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      if (in[e]) dst[to[e]] = v[e];
    }
  }
}

template <typename T, typename I>
cudaError_t launch(const I* idx, long long idx_row, unsigned S, unsigned D,
                   unsigned pc, int ncols, void* const* src,
                   const long long* stride, void* const* dst, int zero_fill,
                   unsigned char* valid, cudaStream_t stream) {
  const unsigned total = S * D * pc;
  const long long blocks = (total + kTile - 1) / kTile;
  const long long fill = 2LL * repro::sm_count();
  int k0 = 0;
  do {
    Columns<T> c;
    c.n = ncols - k0 < kMaxCols ? ncols - k0 : kMaxCols;
    for (int k = 0; k < c.n; ++k) {
      c.src[k] = static_cast<const T*>(src[k0 + k]);
      c.dst[k] = static_cast<T*>(dst[k0 + k]);
      c.stride[k] = stride[k0 + k];
    }
    long long split = 1;
    if (blocks < fill && c.n > 1) {
      split = (fill + blocks - 1) / blocks;
      if (split > c.n) split = c.n;
    }
    const dim3 grid(static_cast<unsigned>(blocks),
                    static_cast<unsigned>(split));
    move_rows_kernel<T, I><<<grid, kThreads, 0, stream>>>(
        idx, idx_row, S, D, pc, total, c, zero_fill,
        k0 == 0 ? valid : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    k0 += c.n;
  } while (k0 < ncols);
  return cudaSuccess;
}

template <typename I>
cudaError_t by_width(int elem_bytes, const I* idx, long long idx_row,
                     unsigned S, unsigned D, unsigned pc, int ncols,
                     void* const* src, const long long* stride,
                     void* const* dst, int zero_fill, unsigned char* valid,
                     cudaStream_t s) {
  switch (elem_bytes) {
    case 1:
      return launch<uint8_t, I>(idx, idx_row, S, D, pc, ncols, src, stride,
                                dst, zero_fill, valid, s);
    case 4:
      return launch<uint32_t, I>(idx, idx_row, S, D, pc, ncols, src, stride,
                                 dst, zero_fill, valid, s);
    case 8:
      return launch<uint64_t, I>(idx, idx_row, S, D, pc, ncols, src, stride,
                                 dst, zero_fill, valid, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// idx: int32 (idx_bytes 4) or int64 (8), (S, D, pc) with rows idx_row
// elements apart and each row's D * pc entries contiguous; S * D * pc in
// [1, 2^31). src, stride, dst: host arrays of ncols >= 0 column pointers
// (each elem_bytes wide: 1, 4 or 8), source row strides in elements and
// output pointers; every output holds S * D * pc elements. Each source
// index is below its column's row length. zero_fill: write 0 where idx < 0.
// valid: (S * D * pc,) bool, or null to leave it. Launches
// max(1, ceil(ncols / kMaxCols)) kernels on stream, in order.
extern "C" int repro_move_rows(const void* idx, int idx_bytes,
                               long long idx_row, int S, int D, int pc,
                               int elem_bytes, int ncols, const void* src,
                               const void* stride, const void* dst,
                               int zero_fill, void* valid, void* stream) {
  const long long total = static_cast<long long>(S) * D * pc;
  if (S < 1 || D < 1 || pc < 1 || total >= (1LL << 31) || ncols < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* const* s = static_cast<void* const*>(src);
  auto* st = static_cast<const long long*>(stride);
  auto* const* d = static_cast<void* const*>(dst);
  auto* v = static_cast<unsigned char*>(valid);
  auto cs = static_cast<cudaStream_t>(stream);
  switch (idx_bytes) {
    case 4:
      return static_cast<int>(by_width(
          elem_bytes, static_cast<const int32_t*>(idx), idx_row, S, D, pc,
          ncols, s, st, d, zero_fill, v, cs));
    case 8:
      return static_cast<int>(by_width(
          elem_bytes, static_cast<const int64_t*>(idx), idx_row, S, D, pc,
          ncols, s, st, d, zero_fill, v, cs));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
