// K2 count_runs: run heads, per-group weight sum and min pos, and
// compaction of a lexicographically sorted k-mer column set.
//
// Replaces the body of bcalm_tpu/ops/count.py:count_canonical after its
// first sort (the TPU version sorts again by group id to compact, because
// TPU scatters are slow).  The input is sorted, so every run of equal
// columns is contiguous and reduces with a segmented scan: one launch,
// one pass.
//
// Column i is valid when it is not the all-ones sentinel, a head when it
// is valid and differs from column i-1, and the last of its run when it
// is valid and differs from column i+1 (adjacent-lane compares; the
// neighbours come by shuffle, a warp's edge columns from memory).  The
// scan carries (heads, weight sum since the last head, min pos since the
// last head); an invalid column adds nothing.  Every column writes once:
// - a head writes its lanes to unique[:, g], g = heads before it;
// - the last column of a run writes counts[g] and minpos[g], with plain
//   stores: the sums are exact int64 and no order of tiles shows;
// - the r-th column that is not a head (sentinel columns included) writes
//   the tail slot N-1-r: zero lanes, count 0, the sentinel in minpos.
//   r = i - heads up to i, so [n_unique, N) is filled with no fill pass.
// n_unique (the heads) goes to a device word; nothing syncs the host.
//
// Bound on this card: memory, the lanes (+ weights, pos) read once and
// unique, counts and minpos written once.  Each block takes the next tile
// of 2048 columns from a ticket (every tile it waits on is running), item
// q of thread t being column tile * 2048 + q * 256 + t, so each load and
// store of a row is one contiguous run per warp; all of a thread's loads
// go out before it uses one.  A warp scans its 32 columns with ballots
// (heads, and the counts of an unweighted call) and shuffles (weight
// sums, min pos); warp 0 scans the tile's 64 warp summaries and publishes
// the tile's aggregate.  Its carry then comes from the tiles before it,
// 32 status words a round, nearest first (decoupled look-back): the heads
// from the status words alone (a tile's heads, or once it knows them its
// inclusive count, in the word with its state), up to the nearest
// inclusive count, one trip to memory a round; the weight sum and min pos
// since the last head from the tiles' summaries (stored, fenced, then the
// status word set; read past L1), up to the nearest tile with a head.  So
// a tile's inclusive count waits on no summary read, and the chain of
// inclusive counts across the grid, which sets the pace, moves a round
// trip per 32 tiles.  A run may span many tiles: its sum reaches its last
// column through the summaries.  Below 3 lanes the lanes stay in
// registers for the head stores; above, a head reloads its lanes (L1/L2).
#include "common.cuh"

namespace {

constexpr int kItems = 8;                           // columns per thread
constexpr int kWarps = bt::kThreads / 32;           // 8
constexpr int kChunks = kItems * kWarps;            // 64 warp chunks
constexpr int kPerLane = kChunks / 32;              // scanned by warp 0
constexpr long long kTile = bt::kThreads * kItems;  // 2048 columns
constexpr unsigned long long kAggregate = 1, kPrefix = 2;
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

// Called by one thread.  The tile's aggregate: its summary to vals, then
// (fenced) its status word, heads << 2 | kAggregate.
__device__ void publish_aggregate(unsigned long long* flags,
                                  unsigned long long* vals, long long tile,
                                  const Run& r) {
  store_gpu(vals + 2 * tile, r.w);
  store_gpu(vals + 2 * tile + 1,
            (static_cast<unsigned long long>(r.h) << 32) | r.p);
  __threadfence();
  store_gpu(flags + tile, (static_cast<unsigned long long>(r.h) << 2) | kAggregate);
}

// Called by one thread: the heads of tiles 0..tile, in the status word
// itself (no fence: the word is the value).
__device__ void publish_prefix(unsigned long long* flags, long long tile,
                               long long heads) {
  store_gpu(flags + tile, (static_cast<unsigned long long>(heads) << 2) | kPrefix);
}

// Called by the 32 lanes of one warp: the carry into `tile`, {heads in
// the tiles before it, weight sum and min pos since the last head before
// it}.  Lane l reads tile - 1 - l, 32 tiles a round, older rounds after.
// The heads come from the status words alone, up to the nearest tile
// holding its inclusive count (tile 0 always does), so a round costs one
// trip to memory.  The sum and min come from the tiles' own summaries,
// up to the nearest tile that holds a head: they wait for no inclusive
// count, only for the tiles' aggregates.
__device__ Run look_back(const unsigned long long* flags,
                         const unsigned long long* vals, long long tile,
                         int lane) {
  long long heads = 0;
  Run since = identity();  // .w, .p: since the last head
  bool heads_done = false, since_done = false;
  for (long long t = tile - 1 - lane;; t -= 32) {
    unsigned long long f = kPrefix;  // before tile 0: no heads, a head
    if (t >= 0) {
      do {
        f = load_gpu(flags + t);
      } while ((f & 3u) == 0);
    }
    if (!heads_done) {
      const unsigned int found = __ballot_sync(0xFFFFFFFFu, (f & 3u) == kPrefix);
      const int stop = found ? __ffs(found) - 1 : 31;
      long long v = lane <= stop ? static_cast<long long>(f >> 2) : 0;
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

// A > 0: L == A lanes, held in registers from the load to the head
// stores; A == 0: any L, a head reloads its lanes.  kWeighted: the sums
// are of the weights, scanned with shuffles; else they count the valid
// columns, a popcount of the warp's validity ballot.
template <int A, bool kWeighted>
__global__ void __launch_bounds__(bt::kThreads)
count_runs_kernel(const int64_t* __restrict__ lanes, long long stride,
                  long long N, int L, const int64_t* __restrict__ weights,
                  const int64_t* __restrict__ pos,
                  unsigned long long* __restrict__ ticket,
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
  if (threadIdx.x == 0) s_tile = static_cast<long long>(atomicAdd(ticket, 1ULL));
  __syncthreads();
  const long long tile = s_tile;
  const long long first = tile * kTile + threadIdx.x;
  const int nl = A > 0 ? A : L;

  // 1. flags and the warp-level segmented scan of each item.  The loads
  // of all items go out before any of their values is used: the weights
  // and pos, then a row at a time.
  unsigned long long xw[kWeighted ? kItems : 1];  // weight sum since the head
  unsigned int xp[kItems];                        // min pos since the head
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * bt::kThreads;
    if constexpr (kWeighted)
      xw[q] = i < N ? static_cast<unsigned long long>(weights[i]) : 0ull;
    xp[q] = bt::kSentinel;
    if (pos && i < N) {
      const unsigned long long v = static_cast<unsigned long long>(pos[i]);
      xp[q] = v < bt::kSentinel ? static_cast<unsigned int>(v) : bt::kSentinel;
    }
  }
  uint32_t held[kItems][A > 0 ? A : 1];
  unsigned int sent = ~0u, dprev = 0, dnext = 0;  // bit q: item q
#pragma unroll
  for (int j = 0; j < nl; ++j) {
    const int64_t* row = lanes + j * stride;
    uint32_t a[kItems], edge[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = first + q * bt::kThreads;
      a[q] = i < N ? static_cast<uint32_t>(row[i]) : bt::kSentinel;
      // a warp's edge columns: lane 0's left and lane 31's right neighbour
      const long long e = lane == 0 ? i - 1 : i + 1;
      edge[q] = (lane == 0 || lane == 31) && e >= 0 && e < N
                    ? static_cast<uint32_t>(row[e]) : 0u;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      uint32_t prev = __shfl_up_sync(0xFFFFFFFFu, a[q], 1);
      uint32_t next = __shfl_down_sync(0xFFFFFFFFu, a[q], 1);
      if (lane == 0) prev = edge[q];
      if (lane == 31) next = edge[q];
      if (a[q] != bt::kSentinel) sent &= ~(1u << q);
      if (a[q] != prev) dprev |= 1u << q;
      if (a[q] != next) dnext |= 1u << q;
      if constexpr (A > 0) held[q][j] = a[q];
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
    if (lane == 0) publish_aggregate(flags, vals, tile, agg);
    if (tile > 0) carry = look_back(flags, vals, tile, lane);
    if (lane == 0) publish_prefix(flags, tile, carry.h + agg.h);
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
#pragma unroll
      for (int j = 0; j < nl; ++j) {
        uint32_t a;
        if constexpr (A > 0) a = held[q][j];
        else a = static_cast<uint32_t>(lanes[j * stride + i]);
        unique[j * ustride + h - 1] = a;
      }
    } else {
      const long long slot = N - 1 - (i - h);
      for (int j = 0; j < nl; ++j) unique[j * ustride + slot] = 0;
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

// scratch: 2 + 3 * ceil(N / 2048) words, the first 2 + ceil(N / 2048)
// zeroed: [0] n_unique (written here), [1] the tile ticket, then a status
// word per tile, then 2 summary words per tile.  N must be > 0.
extern "C" int bt_count_runs(const int64_t* lanes, long long stride,
                             long long N, int L, const int64_t* weights,
                             const int64_t* pos, long long* scratch,
                             int64_t* unique, long long ustride,
                             int64_t* counts, int64_t* minpos, void* stream) {
  if (L < 1 || L > bt::kMaxLanes || N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (N + kTile - 1) / kTile;
  auto* words = reinterpret_cast<unsigned long long*>(scratch);
  auto run = [&](auto kernel) {
    kernel<<<static_cast<unsigned int>(tiles), bt::kThreads, 0, s>>>(
        lanes, stride, N, L, weights, pos, words + 1, words + 2,
        words + 2 + tiles, unique, ustride, counts, minpos,
        reinterpret_cast<int64_t*>(scratch));
  };
  const bool w = weights != nullptr;
  if (L == 1) w ? run(count_runs_kernel<1, true>) : run(count_runs_kernel<1, false>);
  else if (L == 2) w ? run(count_runs_kernel<2, true>) : run(count_runs_kernel<2, false>);
  else w ? run(count_runs_kernel<0, true>) : run(count_runs_kernel<0, false>);
  return static_cast<int>(cudaGetLastError());
}
