// K15 route_buckets: stable placement of entries into per-rank buckets.
//
// Replaces bcalm_tpu/parallel/pipeline.py:_route_to_buckets (:59), which
// every exchange of the -devices N build runs: entry i of a channel-major
// (C, N) stack with valid[i] and owner[i] in [0, n_dev) goes to bucket
// owner[i] at slot `within` = the number of valid entries j < i with the
// same owner (the JAX version's stable argsort by owner gives exactly this
// order); an entry whose slot is >= cap is dropped and counted, and so is
// a valid entry whose owner is out of range.  Outputs: buckets (C,
// n_dev*cap) and their validity (zero where empty), the dropped count,
// and optionally each entry's flat slot (owner*cap + within, or n_dev*cap
// when dropped or invalid).
//
// Hash mode (no owner array): the owner of entry i is hash_lanes of its C
// channels (csrc/hash.cuh, lane 0 first) mod n_dev.  This is
// bcalm_tpu/parallel/pipeline.py:_local_shard_count's `hash_lanes(lanes)
// % n_dev` (:111), so the per-k-mer mesh count routes its k-mers without
// an owner pass of its own.
//
// Bound on this card: memory (each entry's owner or channels, and its
// validity, read once; each routed entry's C channels written once; the
// buckets' empty tails zeroed once), and at the -devices rounds' size
// (~1.6e5 entries) the launch path.  So one pass does the placement: a
// stable multi-split with decoupled look-back, the shape of the Onesweep
// radix-sort pass with owners as digits.  Each block takes the next tile
// of 1024 entries from an atomic counter (every tile it waits on is then
// already running); item q of thread t is entry tile*1024 + q*256 + t, so
// each 32-entry group is one warp's item.  Inside a group, ceil(log2
// n_dev) ballots over the owner's bits give each entry its peers (none at
// n_dev = 1) and its rank among them; per-group, per-owner counts in
// shared memory are scanned per owner.  The tile publishes its per-owner
// counts (one 64-bit word per tile and owner: value << 2 | flag, as K9's
// look-back in csrc/compact.cu) and then reads its carry per owner from
// its predecessors' words, a warp per owner, 32 tiles at a time.  The
// tile's entries are staged in shared memory in (owner, within) order,
// and each channel is stored owner run by owner run, neighbouring threads
// on neighbouring slots.  The hash is computed once per entry; dropped
// entries cost one atomic per block.  Placement is decided by entry order
// alone, never by atomics, so it is deterministic.  The grid also holds
// a few tail blocks, which take their tickets after every tile: they wait
// for the last tile's inclusive prefixes (the final counts) and zero
// slots [count_o, cap) of each bucket and of its validity, so nothing is
// zero-filled beforehand.  With the memset of the scratch words, two
// device operations per call.
#include "common.cuh"
#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                        // entries per thread
constexpr int kWarps = kThreads / 32;            // 8
constexpr int kGroups = kItems * kWarps;         // 32 groups of 32 entries
constexpr long long kTile = kThreads * kItems;   // 1024 entries
constexpr int kMaxDev = 256;                     // one scan thread per owner
constexpr unsigned long long kAggregate = 1, kPrefix = 2;
static_assert(kMaxDev <= kThreads, "a thread per owner");

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

// Called by the 32 lanes of one warp: the sum of one owner's counts in the
// tiles before `tile` (status[t * stride] is tile t's word for the owner),
// read 32 tiles at a time, nearest first, up to and including the nearest
// one that holds its inclusive prefix (tile 0 always does).
__device__ long long look_back(const unsigned long long* status,
                               long long stride, long long tile, int lane) {
  long long prefix = 0;
  for (long long t = tile - 1 - lane;; t -= 32) {
    unsigned long long s = kPrefix;  // before tile 0: an empty prefix
    if (t >= 0) {
      do {
        s = load_status(status + t * stride);
      } while ((s & 3u) == 0);
    }
    const unsigned int found = __ballot_sync(0xFFFFFFFFu, (s & 3u) == kPrefix);
    const int stop = found ? __ffs(found) - 1 : 31;
    long long v = lane <= stop ? static_cast<long long>(s >> 2) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    prefix += v;
    if (found) return prefix;
  }
}

// -1: not routed (past N or invalid); -2: valid, owner out of range
// (dropped); else the owner.  owner == nullptr: hash mode.
__device__ __forceinline__ int owner_of(const int64_t* owner,
                                        const int64_t* stacked,
                                        long long sstride, int C,
                                        const uint8_t* valid, long long i,
                                        long long N, int n_dev) {
  if (i >= N || !valid[i]) return -1;
  if (owner == nullptr) {
    uint32_t h = bt::kHashSeed;
    for (int c = 0; c < C; ++c) {
      h = bt::hash_step(h, static_cast<uint32_t>(stacked[c * sstride + i]));
    }
    return static_cast<int>(h % static_cast<uint32_t>(n_dev));
  }
  const long long o = owner[i];
  return (o < 0 || o >= n_dev) ? -2 : static_cast<int>(o);
}

__global__ void __launch_bounds__(kThreads)
route_kernel(const int64_t* __restrict__ stacked, long long sstride, int C,
             const int64_t* __restrict__ owner,
             const uint8_t* __restrict__ valid, long long N, int n_dev,
             int bits, long long cap, long long tiles, int n_tail,
             unsigned long long* __restrict__ next_tile,
             unsigned long long* __restrict__ status,
             unsigned long long* __restrict__ dropped,
             int64_t* __restrict__ buckets, uint8_t* __restrict__ bvalid,
             int64_t* __restrict__ slots) {
  // dynamic: s_cnt[kGroups][n_dev] (a group's count of each owner, then its
  // exclusive prefix inside the tile), then s_base[n_dev] (the owner's
  // first staged position), s_tot and s_carry[n_dev]
  extern __shared__ long long s_dyn[];
  __shared__ long long s_val[kTile];   // one channel of the tile
  __shared__ long long s_dst[kTile];   // staged: bucket slot, -1 dropped
  __shared__ short s_src[kTile];       // staged: entry's index in the tile
  __shared__ long long s_tile;
  __shared__ int s_wsum[kWarps], s_routed, s_drop;
  long long* s_carry = s_dyn;
  int* s_tot = reinterpret_cast<int*>(s_carry + n_dev);
  int* s_base = s_tot + n_dev;
  unsigned short* s_cnt = reinterpret_cast<unsigned short*>(s_base + n_dev);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = static_cast<long long>(atomicAdd(next_tile, 1ULL));
    s_drop = 0;
  }
  for (int j = threadIdx.x; j < kGroups * n_dev; j += kThreads) s_cnt[j] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long width = static_cast<long long>(n_dev) * cap;
  if (tile >= tiles) {
    // a tail block: every tile has started, so the last one will publish
    // its inclusive prefix per owner, the final counts
    long long* s_from = s_carry;
    if (threadIdx.x < n_dev) {
      long long from = 0;
      if (tiles) {
        const unsigned long long* p = status + (tiles - 1) * n_dev + threadIdx.x;
        unsigned long long v;
        while (((v = load_status(p)) & 3u) != kPrefix) __nanosleep(256);
        from = static_cast<long long>(v >> 2);
      }
      s_from[threadIdx.x] = from < cap ? from : cap;
    }
    __syncthreads();
    const long long step = static_cast<long long>(n_tail) * kThreads;
    for (int d = 0; d < n_dev; ++d) {
      for (long long x = s_from[d] + (tile - tiles) * kThreads + threadIdx.x;
           x < cap; x += step) {
        const long long slot = d * cap + x;
        for (int c = 0; c < C; ++c) buckets[c * width + slot] = 0;
        bvalid[slot] = 0;
      }
    }
    return;
  }
  const long long first = tile * kTile;
  const unsigned int below = (1u << lane) - 1u;
  // channel 0 of this thread's entries, loaded ahead of the ranking
  long long v[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * kThreads + threadIdx.x;
    v[q] = i < N ? stacked[i] : 0;
  }
  int o[kItems], rank[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * kThreads + threadIdx.x;
    o[q] = owner_of(owner, stacked, sstride, C, valid, i, N, n_dev);
    unsigned int peers = __ballot_sync(0xFFFFFFFFu, o[q] >= 0);
    for (int b = 0; b < bits; ++b) {
      const bool set = (o[q] >> b) & 1;
      const unsigned int m = __ballot_sync(0xFFFFFFFFu, set);
      peers &= set ? m : ~m;
    }
    rank[q] = __popc(peers & below);
    if (o[q] >= 0 && rank[q] == 0) {
      s_cnt[(q * kWarps + w) * n_dev + o[q]] =
          static_cast<unsigned short>(__popc(peers));
    }
  }
  __syncthreads();
  // per owner: exclusive prefix over the tile's groups, and the tile total
  int total = 0;
  if (threadIdx.x < n_dev) {
    for (int g = 0; g < kGroups; ++g) {
      unsigned short* c = s_cnt + g * n_dev + threadIdx.x;
      const int v = *c;
      *c = static_cast<unsigned short>(total);
      total += v;
    }
    s_tot[threadIdx.x] = total;
    store_status(status + tile * n_dev + threadIdx.x, total,
                 tile == 0 ? kPrefix : kAggregate);
  }
  // exclusive scan of the totals over the owners: each owner's first
  // staged position (warp scans, then the 8 warp sums)
  int inc = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_wsum[w] = inc;
  __syncthreads();
  int warp_off = 0, routed = 0;
  for (int v = 0; v < kWarps; ++v) {
    const int x = s_wsum[v];
    if (v < w) warp_off += x;
    routed += x;
  }
  if (threadIdx.x < n_dev) s_base[threadIdx.x] = warp_off + inc - total;
  if (threadIdx.x == 0) s_routed = routed;
  // carries: a warp per owner
  for (int d = w; d < n_dev; d += kWarps) {
    long long carry = 0;
    if (tile > 0) {
      carry = look_back(status + d, n_dev, tile, lane);
      if (lane == 0) store_status(status + tile * n_dev + d, carry + s_tot[d],
                                  kPrefix);
    }
    if (lane == 0) s_carry[d] = carry;
  }
  __syncthreads();
  // each entry's slot; stage it in (owner, within) order
  int drop = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * kThreads + threadIdx.x;
    long long slot = width;  // none: dropped or not routed
    if (o[q] >= 0) {
      const int in_tile = s_cnt[(q * kWarps + w) * n_dev + o[q]] + rank[q];
      const long long within = s_carry[o[q]] + in_tile;
      const int pos = s_base[o[q]] + in_tile;
      s_src[pos] = static_cast<short>(q * kThreads + threadIdx.x);
      if (within < cap) {
        slot = o[q] * cap + within;
        s_dst[pos] = slot;
      } else {
        s_dst[pos] = -1;
        ++drop;
      }
    } else if (o[q] == -2) {
      ++drop;
    }
    if (slots && i < N) slots[i] = slot;
  }
  drop = __reduce_add_sync(0xFFFFFFFFu, drop);
  if (lane == 0 && drop) atomicAdd(&s_drop, drop);
  __syncthreads();
  const int n_routed = s_routed;
  if (threadIdx.x == 0 && s_drop) {
    atomicAdd(dropped, static_cast<unsigned long long>(s_drop));
  }
  for (int j = threadIdx.x; j < n_routed; j += kThreads) {
    if (s_dst[j] >= 0) bvalid[s_dst[j]] = 1;
  }
  // channel by channel: stage it, load the next one, store the owner runs
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int q = 0; q < kItems; ++q) s_val[q * kThreads + threadIdx.x] = v[q];
    __syncthreads();
    if (c + 1 < C) {
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const long long i = first + q * kThreads + threadIdx.x;
        v[q] = i < N ? stacked[(c + 1) * sstride + i] : 0;
      }
    }
    int64_t* dst = buckets + c * width;
    for (int j = threadIdx.x; j < n_routed; j += kThreads) {
      const long long d = s_dst[j];
      if (d >= 0) dst[d] = s_val[s_src[j]];
    }
    __syncthreads();
  }
}

constexpr long long kTailBlocks = 528;  // 4 per SM

}  // namespace

// scratch: 2 + ceil(N / 1024) * n_dev words, zeroed here (the dropped
// count, the tile counter, then one status word per tile and owner);
// dropped is its first word.  owner == nullptr: hash mode.
extern "C" int bt_route_buckets(const int64_t* stacked, long long sstride,
                                int C, const int64_t* owner,
                                const uint8_t* valid, long long N, int n_dev,
                                long long cap, long long* scratch,
                                int64_t* buckets, uint8_t* bvalid,
                                int64_t* slots, void* stream) {
  if (n_dev < 1 || n_dev > kMaxDev || N < 0 || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* words = reinterpret_cast<unsigned long long*>(scratch);
  const long long tiles = (N + kTile - 1) / kTile;
  long long n_tail = (static_cast<long long>(n_dev) * cap + 4 * kThreads - 1) /
                     (4 * kThreads);
  if (n_tail > kTailBlocks) n_tail = kTailBlocks;
  if (tiles + n_tail == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(long long) * (2 + tiles * n_dev), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bits = n_dev == 1 ? 0 : 32 - __builtin_clz(n_dev - 1);
  const size_t smem = n_dev * (sizeof(long long) + 2 * sizeof(int)) +
                      kGroups * n_dev * sizeof(unsigned short);
  route_kernel<<<static_cast<unsigned int>(tiles + n_tail), kThreads, smem,
                 s>>>(
      stacked, sstride, C, owner, valid, N, n_dev, bits, cap, tiles,
      static_cast<int>(n_tail), words + 1, words + 2, words, buckets, bvalid,
      slots);
  return static_cast<int>(cudaGetLastError());
}
