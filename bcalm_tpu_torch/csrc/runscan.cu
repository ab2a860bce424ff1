// K8 run_scans: the consecutive-run structure of a locality-ordered solid
// table, from its successor array.
//
// Replaces the scans of bcalm_tpu/ops/runchains.py:junction_runs (with
// _cummax :89 and _cummin_rev :104, log-doubling shifts on the TPU).  For
// i in [0, C), with nxt(i) = i < n_solid && succ[i] == g+i+1 && i+1 < C
// (g: the global id of entry 0, nonzero on a rank of the sharded glue,
// bcalm_tpu/parallel/distcompact.py:218):
//   is_head[i]  = i < n_solid && !nxt(i-1)
//   is_tail[i]  = i < n_solid && !nxt(i)
//   rid[i]      = (heads at or before i) - 1
//   head_pos[i] = last head at or before i, or -1
//   end_pos[i]  = first tail at or after i, or C
//   R           = number of heads.
//
// One pass over tiles of 2048 entries, taken by ticket, with decoupled
// look-back (lookback.cuh), after a memset of the ticket and status words.
// Thread t of a block holds, for q < 4, the two entries 512 q + 2t and
// +1: succ is read once, as 16-byte vectors, and rid, head_pos and
// end_pos go out as 16-byte streaming vector stores (__stcs: they are
// not read again by this kernel), 512 contiguous bytes per warp
// instruction.  A warp's 64 entries of one q form a group; ballots over
// the link, head and tail flags give each entry its place in the group
// (__popc, __clz, __ffs), and warp 0 scans the 32 groups' head counts,
// last heads and first run ends.  The flags go out from the ballots,
// 4 entries a lane in one 32-bit store: lanes 0-15 write is_head, 16-31
// is_tail, 64 bytes each per group.
//
// The carry has two values, the head count and the last head.  They are
// packed as two 31-bit fields into lookback.cuh's one 64-bit status word
// (look_back_pair) rather than widening the word to two: one relaxed
// 64-bit load still reads a whole, consistent status, and the wrapper
// asserts C < 2^31, so both fields fit.
//
// end_pos is a suffix min, which a forward look-back cannot give.  Inside
// [0, n_solid) heads and tails alternate, so every entry's end is the
// first "run end" at or after it in its run: a tail, or n_solid-1 itself
// when it links on (end C: the last run has no tail).  A tile writes
// end_pos for its entries that have a run end after them in the tile (and
// C for entries >= n_solid); the tile holding a run's end also writes the
// run's members in earlier tiles, [its head, the tile's start), the head
// being the carry's last head.  Every entry is written once, in one pass.
// A run over many tiles is written by one block (a repeat-free genome's
// single unitig); the runs of a read set are tens of entries long.
// Bound: memory, 8 bytes read per solid entry and 26 written per entry.
#include "lookback.cuh"

namespace {

constexpr int kPairs = 4;                     // entry pairs per thread
constexpr int kWarps = bt::kThreads / 32;
constexpr int kGroups = kPairs * kWarps;      // 64-entry groups per tile
constexpr int kSlice = 2 * bt::kThreads;      // entries per q
constexpr int kTile = kPairs * kSlice;        // 2048
constexpr int kNone = kTile;                  // no run end in the group
static_assert(kGroups == 32, "warp 0 scans one group per lane");

__device__ __forceinline__ bool links(long long s, long long i, long long C,
                                      long long n, long long g) {
  return i < n && i + 1 < C && s == g + i + 1;
}

// Tile-local position of the last head in a group's ballots (entry 2l of
// lane l in h0, 2l+1 in h1) among the lanes in `mask`, or -1.
__device__ __forceinline__ int last_in(unsigned int h0, unsigned int h1,
                                       unsigned int mask, int group) {
  const unsigned int any = (h0 | h1) & mask;
  if (!any) return -1;
  const int l = 31 - __clz(any);
  return group * 64 + 2 * l + ((h1 >> l) & 1u);
}

// Tile-local position of the first run end in a group's ballots among
// the lanes in `mask`, or kNone.
__device__ __forceinline__ int first_in(unsigned int m0, unsigned int m1,
                                        unsigned int mask, int group) {
  const unsigned int any = (m0 | m1) & mask;
  if (!any) return kNone;
  const int l = __ffs(any) - 1;
  return group * 64 + 2 * l + (((m0 >> l) & 1u) ? 0 : 1);
}

// Bytes 0/1 of entries 4j..4j+3 of a group (lanes 2j, 2j+1).
__device__ __forceinline__ uint32_t flag_word(unsigned int b0, unsigned int b1,
                                              int j) {
  const unsigned int a = b0 >> (2 * j), b = b1 >> (2 * j);
  return (a & 1u) | ((b & 1u) << 8) | (((a >> 1) & 1u) << 16) |
         (((b >> 1) & 1u) << 24);
}

__global__ void __launch_bounds__(bt::kThreads) run_scan_kernel(
    const int64_t* __restrict__ succ, long long C, long long n, long long g,
    unsigned long long* __restrict__ ticket,
    unsigned long long* __restrict__ status, uint8_t* __restrict__ is_head,
    uint8_t* __restrict__ is_tail, int64_t* __restrict__ rid,
    int64_t* __restrict__ head_pos, int64_t* __restrict__ end_pos,
    int64_t* __restrict__ R) {
  __shared__ unsigned int s_link[kGroups];  // the group's last entry links on
  __shared__ int s_cnt[kGroups], s_last[kGroups], s_first[kGroups];
  __shared__ long long s_carry_cnt, s_carry_last;
  __shared__ int s_tile_first;
  __shared__ bool s_link_before, s_cross, s_end_links;
  const long long tile = take_tile(ticket);
  const long long base = tile * kTile;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(succ) & 15) == 0;
  const unsigned int lt = (1u << lane) - 1u, le = lt | (1u << lane);

  bool nx[kPairs][2];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const long long i = base + q * kSlice + 2 * threadIdx.x;
    long long s0 = -1, s1 = -1;
    if (vec && i + 1 < n) {
      const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(succ + i));
      s0 = v.x;
      s1 = v.y;
    } else {
      if (i < n) s0 = succ[i];
      if (i + 1 < n) s1 = succ[i + 1];
    }
    nx[q][0] = links(s0, i, C, n, g);
    nx[q][1] = links(s1, i + 1, C, n, g);
    const unsigned int b1 = __ballot_sync(0xFFFFFFFFu, nx[q][1]);
    if (lane == 0) s_link[q * kWarps + w] = b1 >> 31;
    if (i == n - 1) s_end_links = nx[q][0];
    if (i + 1 == n - 1) s_end_links = nx[q][1];
  }
  if (threadIdx.x == 0) {
    s_link_before = base > 0 && links(base - 1 < n ? succ[base - 1] : -1,
                                      base - 1, C, n, g);
  }
  __syncthreads();

  unsigned int bh0[kPairs], bh1[kPairs], bt0[kPairs], bt1[kPairs],
      bm0[kPairs], bm1[kPairs];
  bool head_first = false;  // thread 0: the tile's first entry is a head
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int grp = q * kWarps + w;
    const long long i = base + q * kSlice + 2 * threadIdx.x;
    const unsigned int l1 = __ballot_sync(0xFFFFFFFFu, nx[q][1]);
    const bool prev = lane ? ((l1 >> (lane - 1)) & 1u)
                           : (grp ? s_link[grp - 1] != 0 : s_link_before);
    const bool live0 = i < n, live1 = i + 1 < n;
    const bool h0 = live0 && !prev, h1 = live1 && !nx[q][0];
    const bool t0 = live0 && !nx[q][0], t1 = live1 && !nx[q][1];
    if (q == 0 && threadIdx.x == 0) head_first = h0;
    bh0[q] = __ballot_sync(0xFFFFFFFFu, h0);
    bh1[q] = __ballot_sync(0xFFFFFFFFu, h1);
    bt0[q] = __ballot_sync(0xFFFFFFFFu, t0);
    bt1[q] = __ballot_sync(0xFFFFFFFFu, t1);
    bm0[q] = __ballot_sync(0xFFFFFFFFu, t0 || i == n - 1);
    bm1[q] = __ballot_sync(0xFFFFFFFFu, t1 || i + 1 == n - 1);
    if (lane == 0) {
      s_cnt[grp] = __popc(bh0[q]) + __popc(bh1[q]);
      s_last[grp] = last_in(bh0[q], bh1[q], 0xFFFFFFFFu, grp);
      s_first[grp] = first_in(bm0[q], bm1[q], 0xFFFFFFFFu, grp);
    }
  }
  __syncthreads();

  if (w == 0) {
    // lane = group: exclusive head counts and last heads before it, the
    // first run end after it
    const int c = s_cnt[lane];
    int cin = c, lin = s_last[lane], fin = s_first[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int yc = __shfl_up_sync(0xFFFFFFFFu, cin, d);
      const int yl = __shfl_up_sync(0xFFFFFFFFu, lin, d);
      const int yf = __shfl_down_sync(0xFFFFFFFFu, fin, d);
      if (lane >= d) {
        cin += yc;
        lin = yl > lin ? yl : lin;
      }
      if (lane + d < 32) fin = yf < fin ? yf : fin;
    }
    const int lex = __shfl_up_sync(0xFFFFFFFFu, lin, 1);
    const int fex = __shfl_down_sync(0xFFFFFFFFu, fin, 1);
    const long long count = __shfl_sync(0xFFFFFFFFu, cin, 31);
    const int tile_last = __shfl_sync(0xFFFFFFFFu, lin, 31);
    const long long last1 = tile_last >= 0 ? base + tile_last + 1 : 0;
    long long carry_cnt = 0, carry_last1 = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, pack_pair(count, last1), kPrefix);
    } else {
      if (lane == 0) store_status(status + tile, pack_pair(count, last1), kAggregate);
      look_back_pair(status, tile, lane, carry_cnt, carry_last1);
      if (lane == 0) {
        store_status(status + tile,
                     pack_pair(carry_cnt + count,
                               last1 > carry_last1 ? last1 : carry_last1),
                     kPrefix);
      }
    }
    if (tile == gridDim.x - 1 && lane == 0) R[0] = carry_cnt + count;
    s_cnt[lane] = cin - c;
    s_last[lane] = lane ? lex : -1;
    s_first[lane] = lane < 31 ? fex : kNone;
    if (lane == 0) {
      s_carry_cnt = carry_cnt;
      s_carry_last = carry_last1 - 1;
      s_tile_first = fin;
      s_cross = base < n && !head_first && fin < kNone;
    }
  }
  __syncthreads();

  const long long carry_last = s_carry_last;
  auto end_value = [&](long long m) {
    return m == n - 1 && s_end_links ? C : m;
  };
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int grp = q * kWarps + w;
    const long long gbase = base + grp * 64;
    const long long i = base + q * kSlice + 2 * threadIdx.x;
    const bool h1 = (bh1[q] >> lane) & 1u;
    const long long c0 = s_carry_cnt + s_cnt[grp] + __popc(bh0[q] & le) +
                         __popc(bh1[q] & lt);
    const long long c1 = c0 + h1;
    const int lb = last_in(bh0[q], bh1[q], lt, grp);
    const long long before = lb >= 0 ? base + lb
                             : s_last[grp] >= 0 ? base + s_last[grp] : carry_last;
    const long long hp0 = (bh0[q] >> lane) & 1u ? i : before;
    const long long hp1 = h1 ? i + 1 : hp0;
    const int fa = first_in(bm0[q], bm1[q], ~le, grp);
    const long long after = fa < kNone ? base + fa
                            : s_first[grp] < kNone ? base + s_first[grp] : -1;
    const long long m1 = (bm1[q] >> lane) & 1u ? i + 1 : after;
    const long long m0 = (bm0[q] >> lane) & 1u ? i : m1;
    // an entry with no run end after it in the tile is written by a later
    // tile, unless it lies past the solid entries
    const bool k0 = i >= n || m0 >= 0, k1 = i + 1 >= n || m1 >= 0;
    const long long e0 = i >= n ? C : end_value(m0);
    const long long e1 = i + 1 >= n ? C : end_value(m1);
    if (i + 1 < C) {
      __stcs(reinterpret_cast<longlong2*>(rid + i), make_longlong2(c0 - 1, c1 - 1));
      __stcs(reinterpret_cast<longlong2*>(head_pos + i), make_longlong2(hp0, hp1));
      if (k0 && k1) {
        __stcs(reinterpret_cast<longlong2*>(end_pos + i), make_longlong2(e0, e1));
      } else {
        if (k0) end_pos[i] = e0;
        if (k1) end_pos[i + 1] = e1;
      }
    } else if (i < C) {
      rid[i] = c0 - 1;
      head_pos[i] = hp0;
      if (k0) end_pos[i] = e0;
    }
    const int j = lane & 15;
    const uint32_t word = lane < 16 ? flag_word(bh0[q], bh1[q], j)
                                    : flag_word(bt0[q], bt1[q], j);
    uint8_t* flags = (lane < 16 ? is_head : is_tail) + gbase + 4 * j;
    const long long p = gbase + 4 * j;
    if (p + 3 < C) {
      *reinterpret_cast<uint32_t*>(flags) = word;
    } else {
      for (int b = 0; b < 4 && p + b < C; ++b) flags[b] = (word >> (8 * b)) & 0xFFu;
    }
  }

  // the members in earlier tiles of the run that ends first in this tile
  if (s_cross) {
    const long long e = end_value(base + s_tile_first);
    for (long long i = carry_last + threadIdx.x; i < base; i += bt::kThreads) {
      end_pos[i] = e;
    }
  }
}

}  // namespace

extern "C" int bt_run_scans(const int64_t* succ, long long C, long long n,
                            long long g,
                            long long* scratch, uint8_t* is_head,
                            uint8_t* is_tail, int64_t* rid, int64_t* head_pos,
                            int64_t* end_pos, int64_t* R, void* stream) {
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (C + kTile - 1) / kTile;
  // scratch: [0] the ticket, [1, nb] one status word per tile
  cudaError_t err = cudaMemsetAsync(scratch, 0, (nb + 1) * sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* words = reinterpret_cast<unsigned long long*>(scratch);
  run_scan_kernel<<<static_cast<unsigned int>(nb), bt::kThreads, 0, s>>>(
      succ, C, n, g, words, words + 1, is_head, is_tail, rid, head_pos,
      end_pos, R);
  return static_cast<int>(cudaGetLastError());
}
