// K2 count_sorted: run heads, per-group weight sum and min pos, and
// compaction of a k-mer column set, read on the sort's own output.
//
// Replaces the body of bcalm_tpu/ops/count.py:count_canonical after its
// first sort (the TPU version sorts again by group id to compact, because
// TPU scatters are slow).  The sort (torch.sort over the packed keys,
// models.lanes.pack_rows, least significant word first) returns the top
// packed word in sorted order and the permutation; this kernel reads
// those, and, through perm, each column's lower packed words (more than
// 2 lanes), weight and pos in entry order: no sorted copy of the lanes,
// weights or pos exists.  Every run of equal columns is contiguous in the
// sorted order and reduces with a segmented scan: one launch, one pass.
//
// Equal packed words mean equal lanes (the packing is a bijection on u32
// pairs), and the all-ones sentinel column packs to one word per word
// position (0x7FFF...F for a pair of lanes, 0xFFFFFFFF for an odd last
// lane alone), which sorts after every other column.  Column i is valid
// when some word differs from its sentinel word, a head when it is valid
// and differs from column i-1, and the last of its run when it is valid
// and differs from column i+1 (adjacent words compared; the neighbours
// come by shuffle, a warp's edge columns from memory, a lower word's
// edge through perm).  At 1 or 2 lanes the top word decides validity, so
// a sentinel column reads no perm, weight or pos.  The scan carries
// (heads, weight sum since the last head, min pos since the last head);
// an invalid column adds nothing.  Every column writes once:
// - a head writes its lanes to unique[:, g], g = heads before it,
//   unpacked from its words (hi = (word >> 32) ^ 2^31, lo = the low half;
//   an odd last lane is its word);
// - the last column of a run writes counts[g] and minpos[g], with plain
//   stores: the sums are exact int64 and no order of tiles shows;
// - the r-th column that is not a head (sentinel columns included) writes
//   the tail slot N-1-r: zero lanes, count 0, the sentinel in minpos.
//   r = i - heads up to i, so [n_unique, N) is filled with no fill pass.
// n_unique (the heads) goes to a device word; nothing syncs the host.
//
// Bound on this card: memory.  Per column: the top word (8 bytes); where
// a column needs its entry, perm (8) and a random 32-byte sector for
// each of its weight, pos and lower words (pos and weights of a large
// call exceed the 50 MB L2); writes unique (8 a lane), counts and
// minpos.  Each block takes the next tile of 2048 columns from a ticket
// (every tile it waits on is running), item q of thread t being column
// tile * 2048 + q * 256 + t, so each load and store of a row is one
// contiguous run per warp; all of a thread's loads go out before it uses
// one, perm's before the random ones.  A warp scans its 32 columns with
// ballots (heads, and the counts of an unweighted call) and shuffles
// (weight sums, min pos); warp 0 scans the tile's 64 warp summaries and
// publishes the tile's aggregate.  Its carry then comes from the tiles
// before it, 32 status words a round, nearest first (decoupled
// look-back): the heads from the status words alone (a tile's heads, or
// once it knows them its inclusive count, in the word with its state), up
// to the nearest inclusive count, one trip to memory a round; the weight
// sum and min pos since the last head from the tiles' summaries (stored,
// fenced, then the status word set; read past L1), up to the nearest
// tile with a head.  A run may span many tiles: its sum reaches its last
// column through the summaries.
//
// The ticket, status words and summaries live in one workspace per card
// that is never cleared between launches: a launch passes its epoch
// (1, 2, ... below 2^30), which its status words carry beside the state
// and the heads, and the tiles taken before it (the ticket counts on
// across launches), so a word of an earlier launch reads as not yet
// published and no fill runs before the kernel.  Launches that share a
// workspace must be ordered (one stream), as every launch of the port is.
#include "common.cuh"

namespace {

constexpr int kItems = 8;                           // columns per thread
constexpr int kWarps = bt::kThreads / 32;           // 8
constexpr int kChunks = kItems * kWarps;            // 64 warp chunks
constexpr int kPerLane = kChunks / 32;              // scanned by warp 0
constexpr long long kTile = bt::kThreads * kItems;  // 2048 columns
constexpr unsigned long long kAggregate = 1, kPrefix = 2;
// status word: state (2 bits), heads (32 bits), the launch's epoch (30)
constexpr int kEpochShift = 34;
constexpr long long kSentPair = 0x7FFFFFFFFFFFFFFFLL;  // two sentinel lanes
constexpr long long kSentLone = 0xFFFFFFFFLL;          // an odd last lane
static_assert(kChunks % 32 == 0, "warp 0 scans whole chunks a lane");

// A span's summary: its heads, and the weight sum and min pos of its
// columns after its last head (all of them when it has none).
struct Run {
  long long h;
  unsigned long long w;
  unsigned int p;
};

__device__ __forceinline__ Run identity() { return {0, 0ull, bt::kSentinel}; }

// a, then b
__device__ __forceinline__ Run combine(const Run& a, const Run& b) {
  return {a.h + b.h, b.h ? b.w : a.w + b.w, b.h ? b.p : min(a.p, b.p)};
}

__device__ __forceinline__ Run shfl_up(const Run& x, int d) {
  return {__shfl_up_sync(0xFFFFFFFFu, x.h, d),
          __shfl_up_sync(0xFFFFFFFFu, x.w, d),
          __shfl_up_sync(0xFFFFFFFFu, x.p, d)};
}

__device__ __forceinline__ Run shfl_down(const Run& x, int d) {
  return {__shfl_down_sync(0xFFFFFFFFu, x.h, d),
          __shfl_down_sync(0xFFFFFFFFu, x.w, d),
          __shfl_down_sync(0xFFFFFFFFu, x.p, d)};
}

// The lanes from `start` (the segment's head; -1: none in the warp, so
// from lane 0) up to this one, of the lanes `upto` covers.
__device__ __forceinline__ unsigned int segment(unsigned int upto, int start) {
  return start > 0 ? upto & ~((1u << start) - 1u) : upto;
}

__device__ __forceinline__ unsigned long long load_gpu(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_gpu(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status(unsigned long long epoch,
                                                     long long heads,
                                                     unsigned long long state) {
  return (epoch << kEpochShift) |
         (static_cast<unsigned long long>(heads) << 2) | state;
}

// The sentinel packing of word j of an L-lane key.
__device__ __forceinline__ long long sent_word(int j, int L) {
  return 2 * j + 1 < L ? kSentPair : kSentLone;
}

// Word j of a key to its lanes 2j (and 2j+1) of column col.
__device__ __forceinline__ void store_word(int64_t* unique, long long ustride,
                                           long long col, int j, int L,
                                           long long v) {
  const auto u = static_cast<unsigned long long>(v);
  if (2 * j + 1 < L) {
    unique[2 * j * ustride + col] = static_cast<uint32_t>(u >> 32) ^ 0x80000000u;
    unique[(2 * j + 1) * ustride + col] = static_cast<uint32_t>(u);
  } else {
    unique[2 * j * ustride + col] = static_cast<uint32_t>(u);
  }
}

// Called by one thread.  The tile's aggregate: its summary to vals, then
// (fenced) its status word.
__device__ void publish_aggregate(unsigned long long* flags,
                                  unsigned long long* vals, long long tile,
                                  unsigned long long epoch, const Run& r) {
  store_gpu(vals + 2 * tile, r.w);
  store_gpu(vals + 2 * tile + 1,
            (static_cast<unsigned long long>(r.h) << 32) | r.p);
  __threadfence();
  store_gpu(flags + tile, status(epoch, r.h, kAggregate));
}

// Called by the 32 lanes of one warp: the carry into `tile`, {heads in
// the tiles before it, weight sum and min pos since the last head before
// it}.  Lane l reads tile - 1 - l, 32 tiles a round, older rounds after;
// a status word of another epoch is not yet published.  The heads come
// from the status words alone, up to the nearest tile holding its
// inclusive count (tile 0 always does), so a round costs one trip to
// memory.  The sum and min come from the tiles' own summaries, up to the
// nearest tile that holds a head: they wait for no inclusive count, only
// for the tiles' aggregates.
__device__ Run look_back(const unsigned long long* flags,
                         const unsigned long long* vals, long long tile,
                         unsigned long long epoch, int lane) {
  constexpr unsigned long long kHeads = (1ull << 32) - 1ull;
  long long heads = 0;
  Run since = identity();  // .w, .p: since the last head
  bool heads_done = false, since_done = false;
  for (long long t = tile - 1 - lane;; t -= 32) {
    unsigned long long f = status(epoch, 0, kPrefix);  // before tile 0
    if (t >= 0) {
      do {
        f = load_gpu(flags + t);
      } while ((f & 3u) == 0 || (f >> kEpochShift) != epoch);
    }
    if (!heads_done) {
      const unsigned int found = __ballot_sync(0xFFFFFFFFu, (f & 3u) == kPrefix);
      const int stop = found ? __ffs(found) - 1 : 31;
      long long v = lane <= stop ? static_cast<long long>((f >> 2) & kHeads) : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
      heads += v;
      heads_done = found != 0;
    }
    if (!since_done) {
      __threadfence();
      Run x = {1, 0ull, bt::kSentinel};  // before tile 0: a head
      if (t >= 0) {
        const unsigned long long hp = load_gpu(vals + 2 * t + 1);
        x = {static_cast<long long>(hp >> 32), load_gpu(vals + 2 * t),
             static_cast<unsigned int>(hp)};
      }
      const unsigned int found = __ballot_sync(0xFFFFFFFFu, x.h > 0);
      const int stop = found ? __ffs(found) - 1 : 31;
      if (lane > stop) x = identity();
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Run y = shfl_down(x, d);  // lane + d: older
        if (lane + d < 32) x = combine(y, x);
      }
      x = {__shfl_sync(0xFFFFFFFFu, x.h, 0), __shfl_sync(0xFFFFFFFFu, x.w, 0),
           __shfl_sync(0xFFFFFFFFu, x.p, 0)};
      since = combine(x, since);
      since_done = found != 0;
    }
    if (heads_done && since_done) return {heads, since.w, since.p};
  }
}

// Each column's word j compared with its neighbours' (bit q of dprev,
// dnext: item q differs from column i-1, i+1) and with its sentinel word
// (bit q of sent cleared where it differs).  a: the items' words; edge:
// lane 0's left and lane 31's right neighbour's word.
__device__ __forceinline__ void compare_word(const long long (&a)[kItems],
                                             const long long (&edge)[kItems],
                                             long long sj, int lane,
                                             unsigned int& sent,
                                             unsigned int& dprev,
                                             unsigned int& dnext) {
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    long long prev = __shfl_up_sync(0xFFFFFFFFu, a[q], 1);
    long long next = __shfl_down_sync(0xFFFFFFFFu, a[q], 1);
    if (lane == 0) prev = edge[q];
    if (lane == 31) next = edge[q];
    if (a[q] != sj) sent &= ~(1u << q);
    if (a[q] != prev) dprev |= 1u << q;
    if (a[q] != next) dnext |= 1u << q;
  }
}

// kLower: more than 2 lanes, the W - 1 lower packed words read through
// perm (a head reads its own again for its stores); else the top word is
// the key.  kWeighted: the sums are of the weights, scanned with
// shuffles; else they count the valid columns, a popcount of the warp's
// validity ballot.
template <bool kLower, bool kWeighted>
__global__ void __launch_bounds__(bt::kThreads)
count_sorted_kernel(const int64_t* __restrict__ top,
                    const int64_t* __restrict__ perm,
                    const int64_t* __restrict__ lower, long long lstride,
                    int W, int L, long long N,
                    const int64_t* __restrict__ weights,
                    const int64_t* __restrict__ pos,
                    unsigned long long* __restrict__ ticket,
                    unsigned long long tile_base, unsigned long long epoch,
                    unsigned long long* __restrict__ flags,
                    unsigned long long* __restrict__ vals,
                    int64_t* __restrict__ unique, long long ustride,
                    int64_t* __restrict__ counts, int64_t* __restrict__ minpos,
                    int64_t* __restrict__ n_unique) {
  __shared__ long long s_tile;
  __shared__ long long s_h[kChunks];
  __shared__ unsigned long long s_w[kChunks];
  __shared__ unsigned int s_p[kChunks];
  static_assert(kItems <= 32, "per-item flags are bits of a word");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned int upto = (2u << lane) - 1u;  // lanes <= this one
  if (threadIdx.x == 0) {
    s_tile = static_cast<long long>(atomicAdd(ticket, 1ULL) - tile_base);
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long first = tile * kTile + threadIdx.x;
  const long long sent0 = sent_word(0, L);

  // 1. the sorted top words; perm where a column needs its entry (every
  // column at more than 2 lanes; else a valid one, when there are weights
  // or pos); then the random loads through it, all before any is used
  long long t[kItems], p[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * bt::kThreads;
    t[q] = i < N ? top[i] : sent0;
  }
  const bool need = kLower || kWeighted || pos != nullptr;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * bt::kThreads;
    p[q] = need && i < N && (kLower || t[q] != sent0) ? perm[i] : -1;
  }
  unsigned long long xw[kWeighted ? kItems : 1];  // weight sum since the head
  unsigned int xp[kItems];                        // min pos since the head
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if constexpr (kWeighted)
      xw[q] = p[q] >= 0 ? static_cast<unsigned long long>(weights[p[q]]) : 0ull;
    xp[q] = bt::kSentinel;
    if (pos && p[q] >= 0) {
      const unsigned long long v = static_cast<unsigned long long>(pos[p[q]]);
      xp[q] = v < bt::kSentinel ? static_cast<unsigned int>(v) : bt::kSentinel;
    }
  }
  unsigned int sent = ~0u, dprev = 0, dnext = 0;  // bit q: item q
  {
    long long edge[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = first + q * bt::kThreads;
      const long long e = lane == 0 ? i - 1 : i + 1;
      edge[q] = (lane == 0 || lane == 31) && e >= 0 && e < N ? top[e] : 0;
    }
    compare_word(t, edge, sent0, lane, sent, dprev, dnext);
  }
  if constexpr (kLower) {
    long long pe[kItems];  // lane 0: perm of column i-1; lane 31: of i+1
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = first + q * bt::kThreads;
      const long long e = lane == 0 ? i - 1 : i + 1;
      pe[q] = (lane == 0 || lane == 31) && e >= 0 && e < N ? perm[e] : -1;
    }
    for (int j = 1; j < W; ++j) {
      const int64_t* row = lower + (j - 1) * lstride;
      const long long sj = sent_word(j, L);
      long long a[kItems], edge[kItems];
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        a[q] = p[q] >= 0 ? row[p[q]] : sj;
        edge[q] = pe[q] >= 0 ? row[pe[q]] : 0;
      }
      compare_word(a, edge, sj, lane, sent, dprev, dnext);
    }
  }
  unsigned int heads[kItems];                    // ballot of the warp's heads
  unsigned int valid_b[kWeighted ? 1 : kItems];  // ballot of valid columns
  unsigned int is_last = 0;                      // bit q: item q ends its run
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * bt::kThreads;
    const bool valid = i < N && !((sent >> q) & 1u);
    const bool head = valid && (i == 0 || ((dprev >> q) & 1u));
    if (valid && (i + 1 == N || ((dnext >> q) & 1u))) is_last |= 1u << q;
    const unsigned int hb = __ballot_sync(0xFFFFFFFFu, head);
    // the lane of the segment's head (-1: before the warp's first head)
    const int start = 31 - __clz(hb & upto);
    unsigned long long wv;
    if constexpr (kWeighted) {
      wv = valid ? xw[q] : 0ull;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xFFFFFFFFu, wv, d);
        if (lane >= d && lane - d >= start) wv += y;
      }
      xw[q] = wv;
    } else {
      valid_b[q] = __ballot_sync(0xFFFFFFFFu, valid);
      wv = __popc(valid_b[q] & segment(upto, start));
    }
    unsigned int pv = valid ? xp[q] : bt::kSentinel;
    if (pos) {
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned int y = __shfl_up_sync(0xFFFFFFFFu, pv, d);
        if (lane >= d && lane - d >= start) pv = min(pv, y);
      }
    }
    heads[q] = hb;
    xp[q] = pv;
    if (lane == 31) {
      const int c = q * kWarps + w;
      s_h[c] = __popc(hb);
      s_w[c] = wv;
      s_p[c] = pv;
    }
  }
  __syncthreads();

  // 2. warp 0: the chunks' exclusive prefixes within the tile, the tile's
  // carry from its predecessors, and each chunk's prefix with the carry
  if (w == 0) {
    Run v[kPerLane];
    Run inc = identity();
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int c = lane * kPerLane + r;
      v[r] = {s_h[c], s_w[c], s_p[c]};
      inc = combine(inc, v[r]);
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Run y = shfl_up(inc, d);
      if (lane >= d) inc = combine(y, inc);
    }
    Run excl = shfl_up(inc, 1);
    if (lane == 0) excl = identity();
    const Run agg = {__shfl_sync(0xFFFFFFFFu, inc.h, 31),
                     __shfl_sync(0xFFFFFFFFu, inc.w, 31),
                     __shfl_sync(0xFFFFFFFFu, inc.p, 31)};
    Run carry = identity();
    if (lane == 0) publish_aggregate(flags, vals, tile, epoch, agg);
    if (tile > 0) carry = look_back(flags, vals, tile, epoch, lane);
    // the tile's inclusive count (no fence: the word is the value)
    if (lane == 0) store_gpu(flags + tile, status(epoch, carry.h + agg.h, kPrefix));
    if (lane == 0 && tile == (N - 1) / kTile) n_unique[0] = carry.h + agg.h;
    Run run = combine(carry, excl);
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int c = lane * kPerLane + r;
      s_h[c] = run.h;
      s_w[c] = run.w;
      s_p[c] = run.p;
      run = combine(run, v[r]);
    }
  }
  __syncthreads();

  // 3. the stores: heads' lanes, runs' sums at their last column, and the
  // tail slot of every column that is not a head
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * bt::kThreads;
    if (i >= N) break;
    const int c = q * kWarps + w;
    const unsigned int hb = heads[q];
    const long long h = s_h[c] + __popc(hb & upto);  // heads up to i
    if ((hb >> lane) & 1u) {
      store_word(unique, ustride, h - 1, 0, L, t[q]);
      if constexpr (kLower) {
        for (int j = 1; j < W; ++j) {
          store_word(unique, ustride, h - 1, j, L,
                     lower[(j - 1) * lstride + p[q]]);
        }
      }
    } else {
      const long long slot = N - 1 - (i - h);
      for (int j = 0; j < L; ++j) unique[j * ustride + slot] = 0;
      counts[slot] = 0;
      if (minpos) minpos[slot] = bt::kSentinel;
    }
    if ((is_last >> q) & 1u) {
      const bool own = hb & upto;  // the run's head is in this warp chunk
      unsigned long long wv;
      if constexpr (kWeighted) wv = xw[q];
      else wv = __popc(valid_b[q] & segment(upto, 31 - __clz(hb & upto)));
      counts[h - 1] = static_cast<int64_t>(own ? wv : s_w[c] + wv);
      if (minpos) minpos[h - 1] = own ? xp[q] : min(s_p[c], xp[q]);
    }
  }
}

}  // namespace

// top, perm: N sorted top words and the permutation; lower: the W - 1 =
// ceil(L/2) - 1 lower packed words in entry order (row stride lstride;
// null at 1 or 2 lanes); weights, pos: entry order, or null.  work: the
// card's workspace of 1 + 3 * cap words ([0] the ticket, then cap status
// words, then 2 summary words a tile), zeroed once when made; tile_base:
// the tiles taken from it before this launch; epoch: this launch's, in
// [1, 2^30), above every earlier launch's on this workspace.  n_unique:
// one word, written here.  0 < N < 2^32.
extern "C" int bt_count_sorted(const int64_t* top, const int64_t* perm,
                               const int64_t* lower, long long lstride, int L,
                               long long N, const int64_t* weights,
                               const int64_t* pos, long long* work,
                               long long cap, unsigned long long tile_base,
                               unsigned long long epoch, int64_t* unique,
                               long long ustride, int64_t* counts,
                               int64_t* minpos, int64_t* n_unique,
                               void* stream) {
  const long long tiles = (N + kTile - 1) / kTile;
  const int W = (L + 1) / 2;
  if (L < 1 || L > bt::kMaxLanes || N < 1 || N >= (1LL << 32) || tiles > cap ||
      epoch < 1 || epoch >= (1ull << 30) || (W > 1) != (lower != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* words = reinterpret_cast<unsigned long long*>(work);
  auto run = [&](auto kernel) {
    kernel<<<static_cast<unsigned int>(tiles), bt::kThreads, 0, s>>>(
        top, perm, lower, lstride, W, L, N, weights, pos, words, tile_base,
        epoch, words + 1, words + 1 + cap, unique, ustride, counts, minpos,
        n_unique);
  };
  const bool w = weights != nullptr;
  if (W > 1) w ? run(count_sorted_kernel<true, true>) : run(count_sorted_kernel<true, false>);
  else w ? run(count_sorted_kernel<false, true>) : run(count_sorted_kernel<false, false>);
  return static_cast<int>(cudaGetLastError());
}
