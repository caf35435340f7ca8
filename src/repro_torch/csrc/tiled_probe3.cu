// tiled_probe3 — fused two-build first-match probe of the hypercube
// multi-way join on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/tiled_probe.py
// (tiled_probe3 / _probe3_kernel): for each batch row r and probe slot i,
//   out1[r, i] = min{ j < nb : b[r, j] == a1[r, i] }, else -1,
//   out2[r, i] = min{ k < nc : c[r, k] == a2[r, i] }, else -1.
// The two builds keep their own lengths; the reference pads both to one
// length with -2 and turns any hit at or past a build's own length into -1,
// which is what scanning only j < nb and k < nc gives. Keys are compared as
// they are, so a probe key of -1 meets a valid build key of -1 on either
// side, as in the reference.
//
// One launch covers every partition of the cube (the batch axis replaces
// the reference's vmap over partitions).
//
// Bound on this card: operations. The join is dense within a partition: no
// radix buckets, so every probe slot is compared with a build's keys until
// its first hit, and with all of them on a miss. Most misses are probe
// padding (invalid slots sanitized to -1). Design, as tiled_probe.cu:
//  * one block per (batch row, tile of 256 probe slots); each thread owns
//    one slot and holds its two probe keys in registers;
//  * the block stages both builds side by side in shared memory, 2048 keys
//    of each (16 KB in all) per step, with coalesced loads; every thread
//    reads the same shared word at the same step, a broadcast;
//  * each thread scans ascending j (and k) and stops at its first hit,
//    which keeps first-match semantics on duplicate build keys;
//  * a side is done once it has its hit or its build is used up, and the
//    block stops staging once every thread is done on both sides.

#include <cuda_runtime.h>

namespace {

constexpr int kProbeThreads = 256;
constexpr int kBuildChunk = 2048;

// Scans one staged chunk of `len` keys for `key`; on a hit records its
// build index and marks the side done.
__device__ __forceinline__ void scan_chunk(const int* staged, int len,
                                           int base, int key, int& hit,
                                           bool& done) {
  for (int j = 0; j < len; ++j) {
    if (staged[j] == key) {
      hit = base + j;
      done = true;
      return;
    }
  }
}

__global__ void tiled_probe3_kernel(const int* __restrict__ a1,
                                    const int* __restrict__ a2,
                                    const int* __restrict__ b,
                                    const int* __restrict__ c, int na, int nb,
                                    int nc, int* __restrict__ out1,
                                    int* __restrict__ out2) {
  __shared__ int build_b[kBuildChunk];
  __shared__ int build_c[kBuildChunk];
  const long long row = blockIdx.x;
  const int i = blockIdx.y * kProbeThreads + threadIdx.x;
  const bool live = i < na;
  const int key1 = live ? a1[row * na + i] : 0;
  const int key2 = live ? a2[row * na + i] : 0;
  const int* brow = b + row * nb;
  const int* crow = c + row * nc;
  int hit1 = -1;
  int hit2 = -1;
  bool done1 = !live || nb == 0;
  bool done2 = !live || nc == 0;
  const int n_build = max(nb, nc);
  for (int base = 0; base < n_build; base += kBuildChunk) {
    // Also the barrier that protects the staged chunks before a refill.
    if (__syncthreads_and(done1 && done2)) break;
    const int len_b = max(0, min(kBuildChunk, nb - base));
    const int len_c = max(0, min(kBuildChunk, nc - base));
    for (int j = threadIdx.x; j < len_b; j += kProbeThreads) {
      build_b[j] = brow[base + j];
    }
    for (int j = threadIdx.x; j < len_c; j += kProbeThreads) {
      build_c[j] = crow[base + j];
    }
    __syncthreads();
    if (!done1) {
      scan_chunk(build_b, len_b, base, key1, hit1, done1);
      done1 = done1 || base + len_b >= nb;
    }
    if (!done2) {
      scan_chunk(build_c, len_c, base, key2, hit2, done2);
      done2 = done2 || base + len_c >= nc;
    }
  }
  if (live) {
    out1[row * na + i] = hit1;
    out2[row * na + i] = hit2;
  }
}

}  // namespace

// a1, a2: (batch, na); b: (batch, nb); c: (batch, nc); out1, out2:
// (batch, na); all int32 row-major. batch >= 1, na >= 1,
// ceil(na / 256) <= 65535.
extern "C" int repro_tiled_probe3(const void* a1, const void* a2,
                                  const void* b, const void* c, int batch,
                                  int na, int nb, int nc, void* out1,
                                  void* out2, void* stream) {
  const dim3 grid(batch, (na + kProbeThreads - 1) / kProbeThreads);
  tiled_probe3_kernel<<<grid, kProbeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a1), static_cast<const int*>(a2),
      static_cast<const int*>(b), static_cast<const int*>(c), na, nb, nc,
      static_cast<int*>(out1), static_cast<int*>(out2));
  return static_cast<int>(cudaGetLastError());
}
