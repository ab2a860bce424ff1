// Decoupled look-back over per-tile status words, shared by the one-pass
// selections (K9 solid_compact, K18 hier_contract, K10 chain_finish), K8
// run_scans and K11 spell_unitigs' scan of the unitig lengths; K23
// link_pairs uses its block_exclusive alone.
//
// Each block takes its tile from an atomic ticket, so every tile it waits
// on is already running.  A tile publishes its own count (kAggregate),
// then, once it knows its carry, its inclusive prefix (kPrefix), in one
// 64-bit word, value << 2 | flag; 0 means nothing published yet (the
// words start zeroed).  Relaxed gpu-scope loads and stores: a word is
// written whole, and a reader only needs the value it carries.
#pragma once

#include "common.cuh"

namespace {

constexpr unsigned long long kAggregate = 1, kPrefix = 2;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             long long value,
                                             unsigned long long flag) {
  unsigned long long v = (static_cast<unsigned long long>(value) << 2) | flag;
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// Tile t's status word once it has published one; before tile 0, an
// empty prefix.
__device__ __forceinline__ unsigned long long wait_status(
    const unsigned long long* status, long long t) {
  unsigned long long s = kPrefix;
  if (t >= 0) {
    do {
      s = load_status(status + t);
    } while ((s & 3u) == 0);
  }
  return s;
}

// Called by the 32 lanes of one warp: the sum of the counts of the
// tiles before `tile`, read from their status words 32 at a time, nearest
// first, up to and including the nearest one that holds its inclusive
// prefix (tile 0 always does).
__device__ long long look_back(const unsigned long long* status,
                               long long tile, int lane) {
  long long prefix = 0;
  for (long long t = tile - 1 - lane;; t -= 32) {
    const unsigned long long s = wait_status(status, t);
    const unsigned int found = __ballot_sync(0xFFFFFFFFu, (s & 3u) == kPrefix);
    const int stop = found ? __ffs(found) - 1 : 31;
    long long v = lane <= stop ? static_cast<long long>(s >> 2) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    prefix += v;
    if (found) return prefix;
  }
}

// The two-value form (K8 run_scans): a tile's head count and its last
// head + 1 (0: none), 31 bits each, in one status word, (count << 31 |
// last + 1) << 2 | flag; the caller keeps both below 2^31.  Called by the
// 32 lanes of one warp: the carry of the tiles before `tile`, their
// summed counts and the largest last head + 1, read as look_back does.
__device__ __forceinline__ long long pack_pair(long long count, long long last1) {
  return (count << 31) | last1;
}

__device__ void look_back_pair(const unsigned long long* status, long long tile,
                               int lane, long long& count, long long& last1) {
  count = 0;
  last1 = 0;
  for (long long t = tile - 1 - lane;; t -= 32) {
    const unsigned long long s = wait_status(status, t);
    const unsigned int found = __ballot_sync(0xFFFFFFFFu, (s & 3u) == kPrefix);
    const int stop = found ? __ffs(found) - 1 : 31;
    const unsigned long long v = lane <= stop ? s >> 2 : 0;
    long long c = static_cast<long long>(v >> 31);
    long long l = static_cast<long long>(v & 0x7FFFFFFFull);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      c += __shfl_xor_sync(0xFFFFFFFFu, c, d);
      const long long o = __shfl_xor_sync(0xFFFFFFFFu, l, d);
      l = o > l ? o : l;
    }
    count += c;
    last1 = l > last1 ? l : last1;
    if (found) return;
  }
}

// Exclusive sum of v over the threads of the block, in thread order;
// returns this thread's exclusive value and sets total.  sh holds one slot
// per warp; every thread of the block must call it.
__device__ long long block_exclusive(long long v, long long* sh,
                                     long long& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int nw = bt::kThreads / 32;
  long long inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sh[w] = inc;
  __syncthreads();
  if (w == 0) {
    long long s = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int d = 1; d < nw; d <<= 1) {
      const long long y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < nw) sh[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  total = sh[nw - 1];
  return (w > 0 ? sh[w - 1] : 0) + inc - v;
}

// Called by every thread of the block: the next tile from the ticket.
__device__ __forceinline__ long long take_tile(unsigned long long* next_tile) {
  __shared__ long long s_tile;
  if (threadIdx.x == 0) s_tile = static_cast<long long>(atomicAdd(next_tile, 1ULL));
  __syncthreads();
  return s_tile;
}

// Called by every thread of the block with the keep flags of its kItems
// items (item q of thread t: the tile's entry q * kThreads + t, so every
// load is one contiguous run per warp): dest[q] = the item's rank among
// the kept items of all tiles, in entry order (the carry from the tiles
// before, then its rank in the tile), -1 where not kept; returns the kept
// count of the tiles up to and including this one.  The flags are ranked
// with __ballot_sync and __popc per warp and one pass of warp 0 over the
// kItems x 8 warp counts; the tile publishes its count, looks back (warp
// 0) and publishes its inclusive prefix.  The order comes from the
// prefix, never from atomics, so a selection built on it is stable.
template <int kItems>
__device__ long long select_ranks(const bool (&keep)[kItems], long long tile,
                                  unsigned long long* status,
                                  long long (&dest)[kItems]) {
  constexpr int kWarps = bt::kThreads / 32;
  constexpr int kPer = kItems * kWarps / 32;  // warp counts per lane of warp 0
  static_assert(kItems * kWarps % 32 == 0, "warp 0 scans whole lanes");
  __shared__ long long s_carry, s_total;
  __shared__ int s_off[kItems * kWarps];  // (q, warp) -> rank of its first
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned int ballot[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    ballot[q] = __ballot_sync(0xFFFFFFFFu, keep[q]);
    if (lane == 0) s_off[q * kWarps + w] = __popc(ballot[q]);
  }
  __syncthreads();
  if (w == 0) {
    int v[kPer], sum = 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      v[r] = s_off[lane * kPer + r];
      sum += v[r];
    }
    int inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (lane >= d) inc += y;
    }
    int run = inc - sum;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      s_off[lane * kPer + r] = run;
      run += v[r];
    }
    const long long count = __shfl_sync(0xFFFFFFFFu, inc, 31);
    long long carry = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, count, kPrefix);
    } else {
      if (lane == 0) store_status(status + tile, count, kAggregate);
      carry = look_back(status, tile, lane);
      if (lane == 0) store_status(status + tile, carry + count, kPrefix);
    }
    if (lane == 0) {
      s_carry = carry;
      s_total = carry + count;
    }
  }
  __syncthreads();
  const unsigned int below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    dest[q] = (ballot[q] >> lane) & 1u
                  ? s_carry + s_off[q * kWarps + w] + __popc(ballot[q] & below)
                  : -1;
  }
  return s_total;
}

}  // namespace
