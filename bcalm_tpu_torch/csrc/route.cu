// K15 route_buckets: stable placement of entries into the exchange's send
// buffer.
//
// Replaces bcalm_tpu/parallel/pipeline.py:_route_to_buckets (:59), which
// every exchange of the -devices N build runs: entry i of a channel-major
// (C, N) stack with valid[i] and owner[i] in [0, n_dev) goes to bucket
// owner[i] at slot `within` = the number of valid entries j < i with the
// same owner (the JAX version's stable argsort by owner gives exactly this
// order); an entry whose slot is >= cap is dropped and counted, and so is
// a valid entry whose owner is out of range.  The output is the buffer
// that all_to_all_single sends, rank-major (n_dev, C+V, cap): bucket d's
// C channels, then, with V = 1, its validity as channel C (1 where an
// entry was placed, 0 where empty), every empty slot of channels 0..C-1
// holding the caller's fill word (V = 0 where the fill word alone marks
// an empty slot, as the per-k-mer count's sentinel does).  Also the
// dropped count and optionally each entry's flat slot (owner*cap +
// within, or n_dev*cap when dropped or invalid).
//
// Hash mode (no owner array): the owner of entry i is hash_lanes of its C
// channels (csrc/hash.cuh, lane 0 first) mod n_dev.  This is
// bcalm_tpu/parallel/pipeline.py:_local_shard_count's `hash_lanes(lanes)
// % n_dev` (:111), so the per-k-mer mesh count routes its k-mers without
// an owner pass of its own.  At n_dev = 1 every valid entry's owner is 0
// and no hash is computed.
//
// Bound on this card: memory (each entry's owner or channels, and its
// validity, read once; the whole send buffer written once), and at the
// -devices rounds' size (~1.6e5 entries) the launch path.  So one pass
// does the placement: a stable multi-split with decoupled look-back, the
// shape of the Onesweep radix-sort pass with owners as digits.  Each block
// takes the next tile of 2048 entries from an atomic counter (every tile
// it waits on is then already running); item q of thread t is entry
// tile*2048 + q*256 + t, so each 32-entry group is one warp's item.  A
// thread loads every channel of its 8 items at once, ahead of the ranking,
// and keeps them in registers up to kRegChannels channels (C <= 4: k <= 63
// in the hash mode); it hashes from those registers and stores from them.
// A wider stack keeps channel 0 in registers and loads the others where
// it stores them.  Inside a group, ceil(log2 n_dev) ballots over the
// owner's bits give each entry its peers (none at n_dev = 1) and its rank
// among them; per-group, per-owner counts in shared memory are scanned per
// owner (a warp per owner up to 32 owners, else a thread).  The tile
// publishes its per-owner counts (one 64-bit word per tile and owner:
// value << 2 | flag, as K9's look-back in csrc/compact.cu) and then reads
// its carry per owner from its predecessors' words, a warp per owner, 32
// tiles at a time.  Each entry is then stored where it lands, from its
// thread: a group's entries of one owner take consecutive slots, so a
// warp's store of a channel is one run of slots per owner among its 32
// entries (one run at n_dev = 1), with no staging in shared memory and four
// barriers a tile.  Placement is decided by entry order alone, never by
// atomics, so it is deterministic; dropped entries cost one atomic per
// warp.
//
// The empty slots are filled by the tiles themselves, as they go, so no
// store waits for the last tile.  With E = the entries at or after tile t,
// an owner whose prefix before tile t is carry can end with at most
// carry + E entries: every slot from min(cap, carry + E) on is empty.
// That bound only falls from tile to tile, so tile t fills [min(cap,
// prefix + E'), min(cap, carry + E)) of each bucket, with prefix its
// inclusive prefix and E' the entries after it: the ranges of all tiles
// tile [count, min(cap, N)) exactly, and the last tile's ends at the
// final count.  Slots at or past N are empty in every bucket from the
// start; they are cut into one share per block, which each block fills
// before its look-back, while its predecessors finish.
//
// A grid of fewer tiles than the card has SMs (the -devices rounds' 80
// tiles) would leave the bound's fall, and so most of each bucket's tail,
// to its last few tiles, a block each.  There as many pool blocks follow
// the tiles: they take the items past the last tile from the same counter
// and run the tiles' code on no entries, so each one's look-back, over
// every tile (each of them claimed, and so running, before it), gives
// each bucket's final count.  The runs [min(cap, count), min(cap, N)) of
// every bucket and channel, laid end to end, are then cut into H equal
// shares, pool block h filling share h, and the tiles fill none of them.
// A grid of at least as many tiles as SMs has no pool block.  With
// the memset of the scratch words, two device operations per call.
#include "common.cuh"
#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                        // entries per thread
constexpr int kWarps = kThreads / 32;            // 8
constexpr int kGroups = kItems * kWarps;         // 64 groups of 32 entries
constexpr long long kTile = kThreads * kItems;   // 2048 entries
constexpr int kMaxDev = 256;                     // one scan thread per owner
constexpr int kRegChannels = 4;                  // channels kept in registers
constexpr long long kPoolTiles = 1024;           // pool blocks below it
constexpr unsigned long long kAggregate = 1, kPrefix = 2;
static_assert(kMaxDev <= kThreads, "a thread per owner");
static_assert(kGroups % 32 == 0, "whole lanes of groups per owner");

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

// Called by the whole block: n words from p on set to `word`, 16 bytes a
// store (a word first where p is off 16-byte alignment, and the odd last
// word).
__device__ __forceinline__ void fill_run(int64_t* p, long long n,
                                         long long word) {
  if (n <= 0) return;
  const long long head = (reinterpret_cast<unsigned long long>(p) & 15) ? 1 : 0;
  const long long pairs = (n - head) >> 1;
  longlong2* v = reinterpret_cast<longlong2*>(p + head);
  const longlong2 two = make_longlong2(word, word);
  for (long long x = threadIdx.x; x < pairs; x += kThreads) v[x] = two;
  if (threadIdx.x == 0) {
    if (head) p[0] = word;
    if ((n - head) & 1) p[n - 1] = word;
  }
}

// Called by the whole block: slots [lo, hi) of bucket d emptied, channels
// 0..C-1 to the fill word and a validity channel (W = C + 1) to 0.
__device__ __forceinline__ void fill_slots(int64_t* send, int C, int W,
                                           long long cap, long long fill, int d,
                                           long long lo, long long hi) {
  int64_t* bucket = send + static_cast<long long>(d) * W * cap + lo;
  for (int c = 0; c < W; ++c) fill_run(bucket + c * cap, hi - lo, c < C ? fill : 0);
}

// Called by the whole block: block b's share of the slots at or past N,
// empty in every bucket whatever the placement.
__device__ __forceinline__ void fill_past_n(int64_t* send, int C, int W,
                                            long long cap, long long fill,
                                            int n_dev, long long N,
                                            long long blocks, long long b) {
  const long long n0 = cap < N ? cap : N;
  const long long row = cap - n0;
  if (row <= 0) return;
  const long long all = row * n_dev, share = (all + blocks - 1) / blocks;
  long long a = b * share;
  const long long end = a + share < all ? a + share : all;
  while (a < end) {
    const int d = static_cast<int>(a / row);
    const long long x = a - d * row;
    const long long len = row - x < end - a ? row - x : end - a;
    fill_slots(send, C, W, cap, fill, d, n0 + x, n0 + x + len);
    a += len;
  }
}

// RC > 0: C == RC channels, all in registers; RC == 0: any C, channel 0
// in registers and the others loaded where they are stored.  kOwned:
// owners given; else the hash mode.  W = C + V channels a bucket.  Items
// [0, tiles) are tiles; items [tiles, blocks), if any, the pool blocks.
template <int RC, bool kOwned>
__global__ void __launch_bounds__(kThreads)
route_kernel(const int64_t* __restrict__ stacked, long long sstride, int C,
             int W, const int64_t* __restrict__ owner,
             const uint8_t* __restrict__ valid, long long N, int n_dev,
             int bits, long long cap, long long fill, long long tiles,
             long long blocks, unsigned long long* __restrict__ next_tile,
             unsigned long long* __restrict__ status,
             unsigned long long* __restrict__ dropped,
             int64_t* __restrict__ send, int64_t* __restrict__ slots) {
  // dynamic: s_carry[n_dev] (the owner's count before this tile), s_tot
  // [n_dev] (the tile's count), then s_cnt[kGroups][n_dev] (a group's
  // count of each owner, then its exclusive prefix inside the tile)
  extern __shared__ long long s_dyn[];
  __shared__ long long s_tile;
  long long* s_carry = s_dyn;
  int* s_tot = reinterpret_cast<int*>(s_carry + n_dev);
  unsigned short* s_cnt = reinterpret_cast<unsigned short*>(s_tot + n_dev);
  constexpr int kRegs = RC > 0 ? RC : 1;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = static_cast<long long>(atomicAdd(next_tile, 1ULL));
  }
  for (int j = threadIdx.x; j < kGroups * n_dev; j += kThreads) s_cnt[j] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long first = tile * kTile;
  const unsigned int below = (1u << lane) - 1u;
  // every load of this thread's entries at once: validity, owner, and the
  // channels held in registers
  long long v[kItems][kRegs], own[kOwned ? kItems : 1];
  bool ok[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * kThreads + threadIdx.x;
    const bool in = i < N;
    ok[q] = in && valid[i];
    if constexpr (kOwned) own[q] = in ? owner[i] : 0;
#pragma unroll
    for (int c = 0; c < kRegs; ++c) v[q][c] = in ? stacked[c * sstride + i] : 0;
  }
  // -1: not routed (past N or invalid); -2: valid, owner out of range
  // (dropped); else the owner
  int o[kItems], rank[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (!ok[q]) {
      o[q] = -1;
    } else if constexpr (kOwned) {
      o[q] = (own[q] < 0 || own[q] >= n_dev) ? -2 : static_cast<int>(own[q]);
    } else if (n_dev == 1) {
      o[q] = 0;
    } else {
      uint32_t h = bt::kHashSeed;
      if constexpr (RC > 0) {
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          h = bt::hash_step(h, static_cast<uint32_t>(v[q][c]));
        }
      } else {
        const long long i = first + q * kThreads + threadIdx.x;
        h = bt::hash_step(h, static_cast<uint32_t>(v[q][0]));
        for (int c = 1; c < C; ++c) {
          h = bt::hash_step(h, static_cast<uint32_t>(stacked[c * sstride + i]));
        }
      }
      o[q] = static_cast<int>(h % static_cast<uint32_t>(n_dev));
    }
  }
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
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
  // per owner: exclusive prefix over the tile's groups and the tile total,
  // published
  if (n_dev <= 32) {
    // a warp per owner, a lane per kGroups / 32 groups
    constexpr int kPer = kGroups / 32;
    for (int d = w; d < n_dev; d += kWarps) {
      unsigned short* c = s_cnt + lane * kPer * n_dev + d;
      int x[kPer], sum = 0;
#pragma unroll
      for (int g = 0; g < kPer; ++g) {
        x[g] = c[g * n_dev];
        sum += x[g];
      }
      int inc = sum;
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, inc, k);
        if (lane >= k) inc += y;
      }
      int run = inc - sum;
#pragma unroll
      for (int g = 0; g < kPer; ++g) {
        c[g * n_dev] = static_cast<unsigned short>(run);
        run += x[g];
      }
      if (lane == 31) {
        s_tot[d] = inc;
        store_status(status + tile * n_dev + d, inc,
                     tile == 0 ? kPrefix : kAggregate);
      }
    }
  } else if (threadIdx.x < n_dev) {
    // a thread per owner
    int total = 0;
    for (int g = 0; g < kGroups; ++g) {
      unsigned short* c = s_cnt + g * n_dev + threadIdx.x;
      const int x = *c;
      *c = static_cast<unsigned short>(total);
      total += x;
    }
    s_tot[threadIdx.x] = total;
    store_status(status + tile * n_dev + threadIdx.x, total,
                 tile == 0 ? kPrefix : kAggregate);
  }
  __syncthreads();
  // this tile's share of the slots at or past N: filled while the
  // predecessors finish
  fill_past_n(send, C, W, cap, fill, n_dev, N, blocks, tile);
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
  // each entry stored where it lands: a warp's entries of one owner take
  // consecutive slots, so its stores of a channel are one run per owner
  const long long width = static_cast<long long>(n_dev) * cap;
  int drop = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * kThreads + threadIdx.x;
    long long slot = width;  // none: dropped or not routed
    if (o[q] >= 0) {
      const long long within = s_carry[o[q]] + rank[q] +
                               s_cnt[(q * kWarps + w) * n_dev + o[q]];
      if (within < cap) {
        slot = o[q] * cap + within;
        int64_t* p = send + o[q] * W * cap + within;
        if constexpr (RC > 0) {
#pragma unroll
          for (int c = 0; c < RC; ++c) p[c * cap] = v[q][c];
        } else {
          p[0] = v[q][0];
          for (int c = 1; c < C; ++c) p[c * cap] = stacked[c * sstride + i];
        }
        if (W > C) p[C * cap] = 1;
      } else {
        ++drop;
      }
    } else if (o[q] == -2) {
      ++drop;
    }
    if (slots && i < N) slots[i] = slot;
  }
  drop = __reduce_add_sync(0xFFFFFFFFu, drop);
  if (lane == 0 && drop) {
    atomicAdd(dropped, static_cast<unsigned long long>(drop));
  }
  // the empty slots below min(cap, N)
  const long long H = blocks - tiles, end = cap < N ? cap : N;
  if (H == 0) {
    // no pool: what this tile proves empty, [min(cap, carry + count + E'),
    // min(cap, carry + E)) of each bucket, E' the entries after it
    const long long size = N - first < kTile ? N - first : kTile;
    const long long after = N - first - size;
    for (int d = 0; d < n_dev; ++d) {
      const long long carry = s_carry[d];
      const long long lo = carry + s_tot[d] + after, hi = carry + after + size;
      fill_slots(send, C, W, cap, fill, d, lo < cap ? lo : cap,
                 hi < cap ? hi : cap);
    }
  } else if (tile >= tiles) {
    // pool block h, whose carry is each bucket's final count: its 1/H of
    // the words of every bucket's [min(cap, count), min(cap, N)), those
    // runs laid end to end bucket by bucket, channel by channel
    long long total = 0;
    for (int d = 0; d < n_dev; ++d) {
      total += (end - (s_carry[d] < end ? s_carry[d] : end)) * W;
    }
    const long long h = tile - tiles;
    const long long a = total * h / H, b = total * (h + 1) / H;
    long long base = 0;
    for (int d = 0; d < n_dev && base < b; ++d) {
      const long long c0 = s_carry[d] < end ? s_carry[d] : end, len = end - c0;
      long long from = (a > base ? a : base) - base;
      const long long to = (b < base + len * W ? b : base + len * W) - base;
      while (from < to) {
        const int c = static_cast<int>(from / len);
        const long long x = from - c * len;
        const long long n = len - x < to - from ? len - x : to - from;
        fill_run(send + (static_cast<long long>(d) * W + c) * cap + c0 + x, n,
                 c < C ? fill : 0);
        from += n;
      }
      base += len * W;
    }
  }
}

template <int RC>
cudaError_t launch_route(unsigned int grid, size_t smem, cudaStream_t s,
                         const int64_t* stacked, long long sstride, int C,
                         int W, const int64_t* owner, const uint8_t* valid,
                         long long N, int n_dev, int bits, long long cap,
                         long long fill, long long tiles,
                         unsigned long long* words, int64_t* send,
                         int64_t* slots) {
  if (owner != nullptr) {
    route_kernel<RC, true><<<grid, kThreads, smem, s>>>(
        stacked, sstride, C, W, owner, valid, N, n_dev, bits, cap, fill,
        tiles, grid, words + 1, words + 2, words, send, slots);
  } else {
    route_kernel<RC, false><<<grid, kThreads, smem, s>>>(
        stacked, sstride, C, W, owner, valid, N, n_dev, bits, cap, fill,
        tiles, grid, words + 1, words + 2, words, send, slots);
  }
  return cudaGetLastError();
}

}  // namespace

// scratch: 2 + blocks * n_dev words, blocks = tiles (ceil(N / 2048), at
// least 1), twice that under kPoolTiles tiles, zeroed here (the dropped
// count, the tile counter, then one status word per block and owner);
// dropped is its first word.  owner == nullptr: hash mode.  send: (n_dev,
// C + with_valid, cap), every element written.
extern "C" int bt_route_buckets(const int64_t* stacked, long long sstride,
                                int C, const int64_t* owner,
                                const uint8_t* valid, long long N, int n_dev,
                                long long cap, long long fill, int with_valid,
                                long long* scratch, int64_t* send,
                                int64_t* slots, void* stream) {
  if (n_dev < 1 || n_dev > kMaxDev || N < 0 || cap < 0 || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* words = reinterpret_cast<unsigned long long*>(scratch);
  // an empty stack still runs one tile, which fills the buffer
  const long long tiles = N > 0 ? (N + kTile - 1) / kTile : 1;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // a grid of fewer tiles than SMs: as many pool blocks
  const long long blocks = tiles < sms && tiles < kPoolTiles ? 2 * tiles : tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0, sizeof(long long) * (2 + blocks * n_dev),
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int W = C + (with_valid ? 1 : 0);
  const int bits = n_dev == 1 ? 0 : 32 - __builtin_clz(n_dev - 1);
  const size_t smem = n_dev * (sizeof(long long) + sizeof(int)) +
                      kGroups * n_dev * sizeof(unsigned short);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  switch (C) {
    case 1:
      err = launch_route<1>(grid, smem, s, stacked, sstride, C, W, owner,
                            valid, N, n_dev, bits, cap, fill, tiles,
                            words, send, slots);
      break;
    case 2:
      err = launch_route<2>(grid, smem, s, stacked, sstride, C, W, owner,
                            valid, N, n_dev, bits, cap, fill, tiles,
                            words, send, slots);
      break;
    case 3:
      err = launch_route<3>(grid, smem, s, stacked, sstride, C, W, owner,
                            valid, N, n_dev, bits, cap, fill, tiles,
                            words, send, slots);
      break;
    case kRegChannels:
      err = launch_route<kRegChannels>(grid, smem, s, stacked, sstride, C, W,
                                       owner, valid, N, n_dev, bits, cap, fill,
                                       tiles, words, send, slots);
      break;
    default:
      err = launch_route<0>(grid, smem, s, stacked, sstride, C, W, owner,
                            valid, N, n_dev, bits, cap, fill, tiles,
                            words, send, slots);
  }
  return static_cast<int>(err);
}
