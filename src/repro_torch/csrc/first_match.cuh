// First-match tables: the device code the two probe kernels share
// (tiled_probe.cu, tiled_probe3.cu).
//
// A build row of n keys becomes an open-addressing table that maps each key
// to the LEAST index j < n holding it, which is the probes' first-match
// rule on duplicate keys. An entry is one 64-bit word, the key's 32 bits
// high and the index low; the empty entry is all ones, whose index
// 0xFFFFFFFF no build index can take, so no key value is reserved (a build
// key of -1, INT32_MIN or INT32_MAX is stored like any other).
//
//  * Capacity: a power of two >= 1.5 n (the wrappers compute it), so at
//    most 2/3 of the slots are taken and every walk meets an empty slot.
//  * Hash: multiplicative, the high bits of the key times an odd 64-bit
//    constant. The callers' rows are cut by the murmur-style hash32 (the
//    hash join's radix buckets, the cube's partitions), so within one row
//    the low bits of hash32 are constant; this hash shares nothing with it.
//  * Insert: atomicCAS claims an empty slot; a slot that already holds the
//    key takes atomicMin of the two words, whose high halves are equal, so
//    the index only falls. Lanes of one warp that carry the same key insert
//    once, from the lowest lane (the least index), and an insert that reads
//    its key already there with a lower index takes no atomic: the long
//    runs of one padding key collapse into one entry with little contention.
//  * Find: linear probing until the key or an empty slot.

#pragma once

#include <cuda_runtime.h>

#include "grid.cuh"

namespace repro {

constexpr unsigned long long kEmptyEntry = ~0ull;
constexpr unsigned long long kTableMultiplier = 0xD1342543DE82EF95ull;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned table_slot(int key, int log2cap) {
  const unsigned long long h =
      static_cast<unsigned long long>(static_cast<unsigned>(key)) *
      kTableMultiplier;
  return log2cap == 0 ? 0u : static_cast<unsigned>(h >> (64 - log2cap));
}

__device__ __forceinline__ bool holds_key(unsigned long long entry, int key) {
  return static_cast<unsigned>(entry >> 32) == static_cast<unsigned>(key);
}

// Records (key, j) in a table of 2^log2cap slots, keeping the least j.
__device__ __forceinline__ void table_insert(unsigned long long* table,
                                             int log2cap, int key, int j) {
  const unsigned mask = (1u << log2cap) - 1u;
  const unsigned long long mine =
      (static_cast<unsigned long long>(static_cast<unsigned>(key)) << 32) |
      static_cast<unsigned>(j);
  for (unsigned s = table_slot(key, log2cap);; s = (s + 1) & mask) {
    // A plain read first: a slot that already holds the key with a lower
    // index (the padding key's, after its first insert) takes no atomic.
    // The read may be stale only towards empty or a higher index, which
    // the atomics below settle.
    unsigned long long cur = *reinterpret_cast<volatile unsigned long long*>(
        table + s);
    if (cur == kEmptyEntry) {
      cur = atomicCAS(table + s, kEmptyEntry, mine);
      if (cur == kEmptyEntry) return;
    }
    if (holds_key(cur, key)) {
      if (cur > mine) atomicMin(table + s, mine);
      return;
    }
  }
}

// The least build index of `key`, or -1. kGlobal: the table lies in device
// memory, written by an earlier launch, and is read through the read-only
// cache; otherwise it lies in shared memory.
template <bool kGlobal>
__device__ __forceinline__ int table_find(const unsigned long long* table,
                                          int log2cap, int key) {
  const unsigned mask = (1u << log2cap) - 1u;
  for (unsigned s = table_slot(key, log2cap);; s = (s + 1) & mask) {
    unsigned long long e;
    if constexpr (kGlobal) {
      e = __ldg(table + s);
    } else {
      e = table[s];
    }
    if (e == kEmptyEntry) return -1;
    if (holds_key(e, key)) return static_cast<int>(e & 0xFFFFFFFFull);
  }
}

// Sets every slot of a table of `cap` slots empty; the threads of the
// block (first, step) or of the grid stride over it.
__device__ __forceinline__ void fill_empty(unsigned long long* table,
                                           long long cap, long long first,
                                           long long step) {
  for (long long s = first; s < cap; s += step) table[s] = kEmptyEntry;
}

// Inserts keys[0..n) of one build row. Thread t of the caller's range takes
// j = first + t, first + t + step, ... where `first` is the index of the
// caller's first thread, so each warp walks 32 consecutive keys at a time
// (blockDim.x must be a multiple of 32, and every lane must call).
__device__ __forceinline__ void insert_row(unsigned long long* table,
                                           int log2cap,
                                           const int* __restrict__ keys,
                                           int n, long long first,
                                           long long step) {
  const int lane = threadIdx.x & 31;
  for (long long base = first - lane; base < n; base += step) {
    const long long j = base + lane;
    const bool live = j < n;
    const int key = live ? keys[j] : 0;
    const unsigned peers =
        __match_any_sync(kFullWarp, key) & __ballot_sync(kFullWarp, live);
    if (live && lane == __ffs(peers) - 1) {
      table_insert(table, log2cap, key, static_cast<int>(j));
    }
  }
}

// Probe slots each thread loads before it looks any of them up, so that
// several loads of the streamed probe keys are in flight at once; and a
// full block of threads, since a block with a large shared table may be
// the only one on its SM, so its threads carry all of the SM's loads.
constexpr int kProbeUnroll = 4;
constexpr int kProbeThreads = 1024;

// Blocks per batch row for a probe kernel whose blocks each take a share of
// one row's na slots: one wave of resident blocks over the whole card,
// never more blocks than a row has slots for, and at most 65535 (the
// grid's y limit). A shared-memory table is built once per block, so one
// wave is also the fewest builds that fill the card.
inline int probe_blocks_per_row(const void* kernel, size_t smem_bytes,
                                int batch, int na, cudaError_t* err) {
  int resident = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, kernel, kProbeThreads, smem_bytes);
  if (*err != cudaSuccess) return 0;
  const long long wave = static_cast<long long>(sm_count()) *
                         (resident > 0 ? resident : 1);
  const long long per_slots =
      (static_cast<long long>(na) + kProbeThreads * kProbeUnroll - 1) /
      (kProbeThreads * kProbeUnroll);
  long long per_row = wave / batch;
  if (per_row > per_slots) per_row = per_slots;
  if (per_row > 65535) per_row = 65535;
  return per_row < 1 ? 1 : static_cast<int>(per_row);
}

}  // namespace repro
