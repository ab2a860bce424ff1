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
// A three-launch block scan over tiles of 1024 entries (256 threads, 4
// entries each): reduce each tile to (heads, last head, first tail); one
// block scans those carries (prefix sum, prefix max, suffix min); each
// tile then scans itself again from its carries and writes.  Bound:
// memory, about 16 bytes read (succ twice) and 26 written per entry.
#include "scan.cuh"

namespace {

constexpr int kItems = kScanItems;
constexpr int kTile = kScanTile;

__device__ __forceinline__ bool nxt_at(const int64_t* succ, long long C,
                                       long long n, long long g,
                                       long long j) {
  return j >= 0 && j < n && j + 1 < C && succ[j] == g + j + 1;
}

// Head and tail flags of this thread's entries [base, base + kItems).
__device__ __forceinline__ void entry_flags(const int64_t* succ, long long C,
                                            long long n, long long g,
                                            long long base,
                                            bool (&head)[kItems],
                                            bool (&tail)[kItems]) {
  bool prev = nxt_at(succ, C, n, g, base - 1);
  for (int q = 0; q < kItems; ++q) {
    long long i = base + q;
    bool live = i < n;
    bool nx = nxt_at(succ, C, n, g, i);
    head[q] = live && !prev;
    tail[q] = live && !nx;
    prev = nx;
  }
}

__global__ void run_scan_reduce(const int64_t* __restrict__ succ, long long C,
                                long long n, long long g,
                                long long* __restrict__ agg_cnt,
                                long long* __restrict__ agg_last,
                                long long* __restrict__ agg_first) {
  __shared__ long long sh[32];
  long long base = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  bool head[kItems], tail[kItems];
  entry_flags(succ, C, n, g, base, head, tail);
  long long cnt = 0, last = -1, first = C;
  for (int q = 0; q < kItems; ++q) {
    long long i = base + q;
    if (head[q]) { ++cnt; last = i; }
    if (tail[q] && first == C) first = i;
  }
  long long tc, tl, tf;
  block_exclusive<true>(cnt, Sum(), 0, sh, tc);
  block_exclusive<true>(last, Max(), -1, sh, tl);
  block_exclusive<false>(first, Min(), C, sh, tf);
  if (threadIdx.x == 0) {
    agg_cnt[blockIdx.x] = tc;
    agg_last[blockIdx.x] = tl;
    agg_first[blockIdx.x] = tf;
  }
}

// One block: the tile aggregates become exclusive carries, in place, and
// R receives the number of heads.
__global__ void run_scan_carry(long long nb, long long C,
                               long long* __restrict__ agg_cnt,
                               long long* __restrict__ agg_last,
                               long long* __restrict__ agg_first,
                               int64_t* __restrict__ R) {
  __shared__ long long sh[32];
  long long run_cnt = 0, run_last = -1, run_first = C, tot;
  for (long long t0 = 0; t0 < nb; t0 += blockDim.x) {
    long long b = t0 + threadIdx.x;
    long long c = b < nb ? agg_cnt[b] : 0;
    long long l = b < nb ? agg_last[b] : -1;
    long long tc, tl;
    long long ec = block_exclusive<true>(c, Sum(), 0, sh, tc);
    long long el = block_exclusive<true>(l, Max(), -1, sh, tl);
    if (b < nb) {
      agg_cnt[b] = run_cnt + ec;
      agg_last[b] = Max()(run_last, el);
    }
    run_cnt += tc;
    run_last = Max()(run_last, tl);
  }
  long long rounds = (nb + blockDim.x - 1) / blockDim.x;
  for (long long r = rounds - 1; r >= 0; --r) {
    long long b = r * blockDim.x + threadIdx.x;
    long long f = b < nb ? agg_first[b] : C;
    long long ef = block_exclusive<false>(f, Min(), C, sh, tot);
    if (b < nb) agg_first[b] = Min()(run_first, ef);
    run_first = Min()(run_first, tot);
  }
  if (threadIdx.x == 0) R[0] = run_cnt;
}

__global__ void run_scan_apply(const int64_t* __restrict__ succ, long long C,
                               long long n, long long g,
                               const long long* __restrict__ carry_cnt,
                               const long long* __restrict__ carry_last,
                               const long long* __restrict__ carry_first,
                               uint8_t* __restrict__ is_head,
                               uint8_t* __restrict__ is_tail,
                               int64_t* __restrict__ rid,
                               int64_t* __restrict__ head_pos,
                               int64_t* __restrict__ end_pos) {
  __shared__ long long sh[32];
  long long base = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  bool head[kItems], tail[kItems];
  entry_flags(succ, C, n, g, base, head, tail);
  long long cnt = 0, last = -1, first = C;
  for (int q = 0; q < kItems; ++q) {
    long long i = base + q;
    if (head[q]) { ++cnt; last = i; }
    if (tail[q] && first == C) first = i;
  }
  long long tot;
  long long run_cnt = carry_cnt[blockIdx.x] + block_exclusive<true>(cnt, Sum(), 0, sh, tot);
  long long run_last = Max()(carry_last[blockIdx.x],
                             block_exclusive<true>(last, Max(), -1, sh, tot));
  long long run_first = Min()(carry_first[blockIdx.x],
                              block_exclusive<false>(first, Min(), C, sh, tot));
  for (int q = 0; q < kItems; ++q) {
    long long i = base + q;
    if (i >= C) break;
    if (head[q]) { ++run_cnt; run_last = i; }
    is_head[i] = head[q];
    is_tail[i] = tail[q];
    rid[i] = run_cnt - 1;
    head_pos[i] = run_last;
  }
  for (int q = kItems - 1; q >= 0; --q) {
    long long i = base + q;
    if (i >= C) continue;
    if (tail[q]) run_first = i;
    end_pos[i] = run_first;
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
  long long nb = (C + kTile - 1) / kTile;
  long long* agg_cnt = scratch;
  long long* agg_last = scratch + nb;
  long long* agg_first = scratch + 2 * nb;
  run_scan_reduce<<<static_cast<unsigned int>(nb), bt::kThreads, 0, s>>>(
      succ, C, n, g, agg_cnt, agg_last, agg_first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  run_scan_carry<<<1, kCarryThreads, 0, s>>>(nb, C, agg_cnt, agg_last,
                                             agg_first, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  run_scan_apply<<<static_cast<unsigned int>(nb), bt::kThreads, 0, s>>>(
      succ, C, n, g, agg_cnt, agg_last, agg_first, is_head, is_tail, rid,
      head_pos, end_pos);
  return static_cast<int>(cudaGetLastError());
}
