// bitonic_sort — batched tile sort of the sort join on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bitonic_sort.py
// (bitonic_sort_tile / _bitonic_kernel): sorts each row of n int32
// (key, value) pairs ascending by key, n a power of two <= 4096. The network
// is the reference's exactly: for k = 2, 4, .., n and j = k/2, .., 1, every
// pair (i, i | j) with bit j of i clear is put in order, ascending iff
// (i & k) == 0, and swapped (keys and values) only when it is strictly out
// of order. So keys and values come out as the reference's network leaves
// them, ties included; the sort is not stable.
//
// Bound on this card: operations. A tile runs log2 n (log2 n + 1) / 2
// stages of n/2 compare-exchanges, and each is a compare and four selects
// (the lower and upper key and value): 5 operations, against 16 bytes an
// element moved (keys and values read once and written once). At the main
// path's B = 8, n = 2048 that is 2.70M operations (0.00016 ms at the
// integer rate) against 0.26 MB (0.00008 ms). Neither is near what a call
// costs: one block per row runs 66 dependent stages, and what sets the time
// is how each stage reaches its partners. The kernel this replaces kept the
// tile in shared memory and ended every stage in a block barrier (66 at
// n = 2048). Here the tile stays in registers:
//  * layout A: thread t of the row's block (T = n / E threads) holds the E
//    consecutive elements tE .. tE + E - 1. Strides j < E pair registers of
//    one thread; strides E <= j < 32E pair the same register of two lanes
//    of a warp, exchanged with __shfl_xor_sync. Neither needs a barrier;
//  * layout B: thread t holds the elements t + rT, r < E. With T <= 32E,
//    the strides j >= 32E are register bits there. A merge that has such
//    strides moves the tile through shared memory into layout B, runs them
//    in registers, and moves it back: one barrier a move (two buffers
//    alternate, so a move never overwrites words another thread has still
//    to read), two a merge;
//  * the stage plan of merge k: strides k/2 .. 32E in layout B, then
//    min(k/2, 16E) .. E across lanes, then min(k/2, E/2) .. 1 in a thread;
//  * E = n for n < 8 (one thread), 8 up to n = 2048 (T = n / 8), 16 at
//    n = 4096 (T = 256). Tiles of n <= 256 sort in one warp with no
//    barrier; n = 512, 1024, 2048 and 4096 cross 2, 4, 6 and 6 barriers
//    (the merges k > 32E: k = 512 .. 2048 at n = 2048, k = 1024 .. 4096 at
//    n = 4096);
//  * shared memory (only for n > 32E) has one padding word every 32, so
//    layout A's E-strided accesses fall on 32 different banks; layout B's
//    are consecutive;
//  * rows and values are loaded and stored in layout A, with 16-byte
//    accesses where all four pointers allow them.
// What holds it now (PERF.md): at B = 8, n = 2048 it takes 0.015 ms, of
// which about 0.005 ms is the fixed cost of a call and 0.0045 ms the
// shuffle stages' exchanges (two shuffles an element a stage, 35 stages,
// eight warps on each row's SM).

#include <cstdint>

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kMaxTile = 4096;
constexpr int kMaxThreads = 256;

__host__ __device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Puts the pair in order: ascending or descending, swapped only when it is
// strictly out of order.
__device__ __forceinline__ void compare_exchange(int& kl, int& kh, int& vl,
                                                 int& vh, bool ascending) {
  if (ascending ? kl > kh : kl < kh) {
    const int k = kl;
    kl = kh;
    kh = k;
    const int v = vl;
    vl = vh;
    vh = v;
  }
}

// The stages of merge k whose strides j (compile-time 2^s, s < LOGE) are
// register bits: pairs (r, r | 2^s) of the registers of element index
// first + r * step.
template <int E, int LOGE>
__device__ __forceinline__ void register_stages(int (&key)[E], int (&val)[E],
                                                int first, int step, int k,
                                                int min_stride) {
#pragma unroll
  for (int s = LOGE - 1; s >= 0; --s) {
    const int j = step << s;
    if (j >= min_stride && j < k) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if (r & (1 << s)) continue;
        compare_exchange(key[r], key[r | (1 << s)], val[r], val[r | (1 << s)],
                         ((first + r * step) & k) == 0);
      }
    }
  }
}

// Moves the tile between layouts through shared memory: thread t writes
// element `from(t, r)` of register r and reads element `to(t, r)` into it.
template <int E>
__device__ __forceinline__ void move_tile(int (&key)[E], int (&val)[E],
                                          int* sk, int* sv, int from_first,
                                          int from_step, int to_first,
                                          int to_step) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    sk[padded(from_first + r * from_step)] = key[r];
    sv[padded(from_first + r * from_step)] = val[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < E; ++r) {
    key[r] = sk[padded(to_first + r * to_step)];
    val[r] = sv[padded(to_first + r * to_step)];
  }
}

template <int E, bool VEC>
__device__ __forceinline__ void load_row(const int* __restrict__ src,
                                         int (&dst)[E]) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(src) + q);
      dst[4 * q] = x.x;
      dst[4 * q + 1] = x.y;
      dst[4 * q + 2] = x.z;
      dst[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) dst[r] = __ldg(src + r);
  }
}

template <int E, bool VEC>
__device__ __forceinline__ void store_row(const int (&src)[E],
                                          int* __restrict__ dst) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      reinterpret_cast<int4*>(dst)[q] =
          make_int4(src[4 * q], src[4 * q + 1], src[4 * q + 2],
                    src[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) dst[r] = src[r];
  }
}

// One block of n / E threads per row. VEC: E % 4 == 0 and every row of the
// four arrays starts on a 16-byte boundary.
template <int E, int LOGE, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    bitonic_sort_kernel(const int* __restrict__ keys,
                        const int* __restrict__ vals, int n,
                        int* __restrict__ keys_out,
                        int* __restrict__ vals_out) {
  extern __shared__ int tile[];
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int first = t * E;  // layout A: elements first .. first + E - 1
  const long long row = static_cast<long long>(blockIdx.x) * n + first;
  int key[E], val[E];
  load_row<E, VEC>(keys + row, key);
  load_row<E, VEC>(vals + row, val);

  const unsigned lanes =
      threads >= 32 ? 0xffffffffu : (1u << threads) - 1u;
  const int buffer = 2 * padded(n);  // words of one buffer's keys and values
  int flip = 0;
  for (int k = 2; k <= n; k <<= 1) {
    if (k > 32 * E) {  // strides >= 32E: cross warps, run in layout B
      int* sk = tile + flip * buffer;
      move_tile<E>(key, val, sk, sk + padded(n), first, 1, t, threads);
      register_stages<E, LOGE>(key, val, t, threads, k, 32 * E);
      flip ^= 1;
      sk = tile + flip * buffer;
      move_tile<E>(key, val, sk, sk + padded(n), t, threads, first, 1);
      flip ^= 1;
    }
    // Strides E .. 16E: lane bit m = j / E. The thread keeps the smaller
    // key of its pair where it is the pair's lower element of an ascending
    // pair or the upper of a descending one, and takes its partner's
    // element where the pair is strictly out of order.
    const bool ascending = (first & k) == 0;
    for (int j = min(k >> 1, 16 * E); j >= E; j >>= 1) {
      const int m = j / E;
      const bool keep_min = ((lane & m) == 0) == ascending;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int other_key = __shfl_xor_sync(lanes, key[r], m);
        const int other_val = __shfl_xor_sync(lanes, val[r], m);
        if (keep_min ? key[r] > other_key : key[r] < other_key) {
          key[r] = other_key;
          val[r] = other_val;
        }
      }
    }
    register_stages<E, LOGE>(key, val, first, 1, k, 1);
  }
  store_row<E, VEC>(key, keys_out + row);
  store_row<E, VEC>(val, vals_out + row);
}

template <int E, int LOGE, bool VEC>
int launch(const int* keys, const int* vals, int batch, int n, int* keys_out,
           int* vals_out, cudaStream_t s) {
  const void* kernel =
      reinterpret_cast<const void*>(bitonic_sort_kernel<E, LOGE, VEC>);
  // Two buffers of padded keys and values, where a merge crosses warps.
  const size_t smem =
      n > 32 * E ? 4 * static_cast<size_t>(padded(n)) * sizeof(int) : 0;
  const cudaError_t err = repro::allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bitonic_sort_kernel<E, LOGE, VEC><<<batch, n / E, smem, s>>>(
      keys, vals, n, keys_out, vals_out);
  return static_cast<int>(cudaGetLastError());
}

template <int E, int LOGE>
int dispatch(const int* keys, const int* vals, int batch, int n,
             int* keys_out, int* vals_out, cudaStream_t s) {
  if constexpr (E % 4 == 0) {
    const auto bits = reinterpret_cast<uintptr_t>(keys) |
                      reinterpret_cast<uintptr_t>(vals) |
                      reinterpret_cast<uintptr_t>(keys_out) |
                      reinterpret_cast<uintptr_t>(vals_out);
    if ((bits & 15) == 0) {  // n is a multiple of 4: every row aligned too
      return launch<E, LOGE, true>(keys, vals, batch, n, keys_out, vals_out,
                                   s);
    }
  }
  return launch<E, LOGE, false>(keys, vals, batch, n, keys_out, vals_out, s);
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
  const auto* k = static_cast<const int*>(keys);
  const auto* v = static_cast<const int*>(vals);
  auto* ko = static_cast<int*>(keys_out);
  auto* vo = static_cast<int*>(vals_out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1:
      return dispatch<1, 0>(k, v, batch, n, ko, vo, s);
    case 2:
      return dispatch<2, 1>(k, v, batch, n, ko, vo, s);
    case 4:
      return dispatch<4, 2>(k, v, batch, n, ko, vo, s);
    case 4096:
      return dispatch<16, 4>(k, v, batch, n, ko, vo, s);
    default:  // 8 .. 2048
      return dispatch<8, 3>(k, v, batch, n, ko, vo, s);
  }
}
