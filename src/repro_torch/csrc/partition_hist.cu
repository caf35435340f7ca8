// partition_hist — histogram of shuffle destinations on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/partition_hist.py
// (partition_hist / _hist_kernel): counts[k] = #{i : dest[i] == k}, rows with
// dest < 0 (invalid) or dest >= nd ignored, and, where a validity mask is
// given, rows whose mask byte is 0 ignored too (the reference's
// where(valid, dest, -1) fused into the read).
//
// Bound on this card: bytes. It reads 4n bytes of destinations (5n with the
// mask) and writes 4nd, with a few integer operations per element, so the
// memory rate bounds it. The TPU version built a (tile, nd) one-hot matrix
// and summed its columns because the TPU lacks a scatter. Here every branch
// streams the destinations with 16-byte loads (int4; the mask as one 32-bit
// word or four bytes) over a one-wave grid, with a scalar head and tail for
// views that start off a 16-byte boundary or end mid-vector:
//  * registers (nd <= 8, the main path's nd = p): each thread counts in
//    packed 8-bit lanes, four to a 32-bit word, two words (an element costs
//    a compare, a shift and an add; words are indexed only by constants, so
//    nothing goes to local memory), and widens them to 32-bit totals every
//    kFlushIters pairs of vectors, before a lane can pass 255. Totals are
//    reduced across the warp (__reduce_add_sync per bin) and the block
//    (shared memory);
//  * shared: per-block bins in shared memory; lanes of a warp with the same
//    destination are merged first (__match_any_sync), so a hot destination
//    does not serialise 32 lanes on one address;
//  * global: the same warp-merged atomics straight into the accumulator in
//    device memory.
// The caller chooses the branch and passes its code (kernels/
// partition_hist.py, hist_branch); this file launches exactly that one.
// One launch per call, with no fill: every block adds its counts into an
// accumulator that is zero between calls, then takes a ticket; the block
// that takes the last ticket moves the accumulator into `out`, zeroing it
// and the ticket as it goes (last_block.cuh). The accumulator is the
// per-stream workspace of kernels/launch.py, which bloom_build shares, so
// calls in flight on two streams never share one.

#include <cstdint>

#include <cuda_runtime.h>

#include "grid.cuh"
#include "last_block.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWords = 2;  // packed words of four 8-bit lanes
constexpr int kRegisterBins = 4 * kWords;
// Pairs of vectors a thread counts between flushes: each pair adds at most
// 8 to a lane, and 31 * 8 = 248 <= 255.
constexpr int kFlushIters = 31;

// Mask layouts: none; one aligned 32-bit word per vector; four bytes.
constexpr int kNoMask = 0, kMaskWord = 1, kMaskBytes = 2;

// Branch codes, in the order of the wrapper's HIST_BRANCHES.
constexpr int kRegisters = 0, kShared = 1, kGlobal = 2;

// Elements before the first 16-byte boundary of dest, and the split of the
// rest into whole vectors and a tail.
struct Split {
  long long head, nvec, tail_start;
};

__device__ __forceinline__ Split split(const int* dest, long long n) {
  const long long off = (reinterpret_cast<uintptr_t>(dest) & 15) >> 2;
  Split s;
  s.head = off ? 4 - off : 0;
  if (s.head > n) s.head = n;
  s.nvec = (n - s.head) >> 2;
  s.tail_start = s.head + 4 * s.nvec;
  return s;
}

// Destination of element i as unsigned, ~0u where the mask clears it.
template <int MASK>
__device__ __forceinline__ unsigned scalar_dest(
    const int* __restrict__ dest, const unsigned char* __restrict__ valid,
    long long i) {
  const unsigned d = static_cast<unsigned>(dest[i]);
  if (MASK != kNoMask && !valid[i]) return ~0u;
  return d;
}

// The four destinations of vector j (elements head + 4j ..), masked.
template <int MASK>
__device__ __forceinline__ void vector_dest(
    const int* __restrict__ dest, const unsigned char* __restrict__ valid,
    const Split& s, long long j, unsigned (&u)[4]) {
  const long long i = s.head + 4 * j;
  const int4 x = __ldg(reinterpret_cast<const int4*>(dest + i));
  u[0] = static_cast<unsigned>(x.x);
  u[1] = static_cast<unsigned>(x.y);
  u[2] = static_cast<unsigned>(x.z);
  u[3] = static_cast<unsigned>(x.w);
  if (MASK == kMaskWord) {
    const unsigned m = __ldg(reinterpret_cast<const unsigned*>(valid + i));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!((m >> (8 * e)) & 0xFFu)) u[e] = ~0u;
    }
  } else if (MASK == kMaskBytes) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!__ldg(valid + i + e)) u[e] = ~0u;
    }
  }
}

// Adds one element to the packed 8-bit lanes: bin u goes to lane u & 3 of
// word u >> 2; u >= nd (negative destinations included, as unsigned) adds
// nothing and shifts nothing.
__device__ __forceinline__ void count_packed(unsigned (&c)[kWords],
                                             unsigned u, unsigned nd) {
  const unsigned inc = u < nd ? 1u << ((u & 3u) << 3) : 0u;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    if ((u >> 2) == static_cast<unsigned>(w)) c[w] += inc;
  }
}

__device__ __forceinline__ void flush_packed(unsigned (&c)[kWords],
                                             unsigned (&tot)[kRegisterBins]) {
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
#pragma unroll
    for (int l = 0; l < 4; ++l) tot[4 * w + l] += (c[w] >> (8 * l)) & 0xFFu;
    c[w] = 0;
  }
}

template <int MASK>
__global__ void __launch_bounds__(kThreads)
    hist_registers(const int* __restrict__ dest,
                   const unsigned char* __restrict__ valid, long long n,
                   int nd, int* __restrict__ acc,
                   unsigned* __restrict__ ticket, int* __restrict__ out) {
  __shared__ unsigned warp_tot[kThreads / 32][kRegisterBins];
  const Split s = split(dest, n);
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const unsigned und = static_cast<unsigned>(nd);

  unsigned c[kWords], tot[kRegisterBins];
#pragma unroll
  for (int w = 0; w < kWords; ++w) c[w] = 0;
#pragma unroll
  for (int b = 0; b < kRegisterBins; ++b) tot[b] = 0;

  // The head (elements before the first 16-byte boundary) and the tail.
  if (gid < s.head) {
    count_packed(c, scalar_dest<MASK>(dest, valid, gid), und);
  }
  if (gid < n - s.tail_start) {
    count_packed(c, scalar_dest<MASK>(dest, valid, s.tail_start + gid), und);
  }
  // Two vectors in flight per thread: j and j + stride.
  for (long long j = gid; j < s.nvec;) {
#pragma unroll 1
    for (int it = 0; it < kFlushIters && j < s.nvec; ++it, j += 2 * stride) {
      unsigned u[4], w[4] = {~0u, ~0u, ~0u, ~0u};
      vector_dest<MASK>(dest, valid, s, j, u);
      if (j + stride < s.nvec) {
        vector_dest<MASK>(dest, valid, s, j + stride, w);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        count_packed(c, u[e], und);
        count_packed(c, w[e], und);
      }
    }
    flush_packed(c, tot);
  }
  flush_packed(c, tot);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < kRegisterBins; ++b) {
    const unsigned sum = __reduce_add_sync(0xffffffffu, tot[b]);
    if (lane == 0) warp_tot[warp][b] = sum;
  }
  __syncthreads();
  if (threadIdx.x < nd) {
    unsigned sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_tot[w][threadIdx.x];
    if (sum) atomicAdd(&acc[threadIdx.x], static_cast<int>(sum));
  }
  repro::finish_last_block(acc, ticket, nd, out);
}

// Every lane of the warp calls this; key ~0u (or >= nd) adds nothing.
__device__ __forceinline__ void add_warp_aggregated(int* bins, unsigned key,
                                                    unsigned nd) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int leader = __ffs(peers) - 1;
  if (key < nd && static_cast<int>(threadIdx.x & 31) == leader) {
    atomicAdd(&bins[key], __popc(peers));
  }
}

// SHARED: per-block bins in shared memory, merged into acc; else the adds
// go to acc directly. The vector loop's bound is the same for every lane
// of a block, so each warp stays converged for the vote.
template <bool SHARED, int MASK>
__global__ void __launch_bounds__(kThreads)
    hist_bins(const int* __restrict__ dest,
              const unsigned char* __restrict__ valid, long long n, int nd,
              int* __restrict__ acc, unsigned* __restrict__ ticket,
              int* __restrict__ out) {
  extern __shared__ int shared_bins[];
  int* bins = SHARED ? shared_bins : acc;
  if (SHARED) {
    for (int k = threadIdx.x; k < nd; k += blockDim.x) bins[k] = 0;
    __syncthreads();
  }
  const Split s = split(dest, n);
  const unsigned und = static_cast<unsigned>(nd);
  if (blockIdx.x == 0 && threadIdx.x < 32) {  // head in lanes 0-3, tail 4-7
    const long long lane = threadIdx.x;
    unsigned key = ~0u;
    if (lane < s.head) key = scalar_dest<MASK>(dest, valid, lane);
    if (lane >= 4 && lane - 4 < n - s.tail_start) {
      key = scalar_dest<MASK>(dest, valid, s.tail_start + lane - 4);
    }
    add_warp_aggregated(bins, key, und);
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < s.nvec; base += stride) {
    const long long j = base + threadIdx.x;
    unsigned u[4] = {~0u, ~0u, ~0u, ~0u};
    if (j < s.nvec) vector_dest<MASK>(dest, valid, s, j, u);
#pragma unroll
    for (int e = 0; e < 4; ++e) add_warp_aggregated(bins, u[e], und);
  }
  if (SHARED) {
    __syncthreads();
    for (int k = threadIdx.x; k < nd; k += blockDim.x) {
      const int c = bins[k];
      if (c != 0) atomicAdd(&acc[k], c);
    }
  }
  repro::finish_last_block(acc, ticket, nd, out);
}

// Launches a one-wave grid of Kernel over the n / 4 vectors.
template <auto Kernel>
int launch(size_t smem, const int* d, const unsigned char* v, long long n,
           int nd, int* acc, unsigned* ticket, int* out, cudaStream_t s) {
  const void* kernel = reinterpret_cast<const void*>(Kernel);
  const cudaError_t err = repro::allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = repro::wave_blocks(kernel, kThreads, smem, n / 4);
  Kernel<<<blocks, kThreads, smem, s>>>(d, v, n, nd, acc, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

template <int MASK>
int dispatch(int branch, const int* d, const unsigned char* v, long long n,
             int nd, int* acc, unsigned* ticket, int* out, cudaStream_t s) {
  switch (branch) {
    case kRegisters:
      if (nd > kRegisterBins) return static_cast<int>(cudaErrorInvalidValue);
      return launch<hist_registers<MASK>>(0, d, v, n, nd, acc, ticket, out,
                                          s);
    case kShared:
      return launch<hist_bins<true, MASK>>(nd * sizeof(int), d, v, n, nd, acc,
                                           ticket, out, s);
    case kGlobal:
      return launch<hist_bins<false, MASK>>(0, d, v, n, nd, acc, ticket, out,
                                            s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dest: (n,) int32, n >= 1; valid: (n,) bool or null; nd >= 1; branch:
// kRegisters (nd <= 8), kShared or kGlobal; workspace: (nd + 1,) int32,
// zero, used by no call in flight on another stream (ticket first, then the
// accumulator), left zero; out: (nd,) int32.
extern "C" int repro_partition_hist(const void* dest, const void* valid,
                                    long long n, int nd, int branch,
                                    void* workspace, void* out,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int* d = static_cast<const int*>(dest);
  const auto* v = static_cast<const unsigned char*>(valid);
  auto* ticket = static_cast<unsigned*>(workspace);
  int* acc = static_cast<int*>(workspace) + 1;
  int* o = static_cast<int*>(out);
  if (v == nullptr) {
    return dispatch<kNoMask>(branch, d, v, n, nd, acc, ticket, o, s);
  }
  // The mask's bytes of the first whole vector start on a 4-byte boundary
  // exactly when the two pointers share their phase.
  const uintptr_t head_bytes =
      (16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15;
  const bool word_aligned =
      ((reinterpret_cast<uintptr_t>(v) + head_bytes / 4) & 3) == 0;
  return word_aligned
             ? dispatch<kMaskWord>(branch, d, v, n, nd, acc, ticket, o, s)
             : dispatch<kMaskBytes>(branch, d, v, n, nd, acc, ticket, o, s);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
