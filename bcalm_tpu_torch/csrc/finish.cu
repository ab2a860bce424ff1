// K10 chain_finish: chain starts, ranks, cycle breaks, mirror dedup and the
// per-unitig arrays from a converged pointer-doubling state.
//
// Replaces bcalm_tpu/ops/chains.py:finish_fast (and the has-predecessor
// test of :107 build_pred, read here as pred[i] >= 0).  Per oriented node
// i of M = 2N, from the packed state row (ptr, dist|flags, mn, dmn):
//   in_cycle = valid && !rooted,   break = in_cycle && mn == i,
//   start = in_cycle ? mn : ptr,   rank = in_cycle ? dmn : dist,
//   is_start = valid && (pred < 0 || break),
//   is_end = valid && (succ < 0 || (in_cycle && succ == mn)).
// Four device operations into one workspace (end_of, len_at_start and ks,
// M each, then the selection's ticket and tile status words):
// 1. a memset of end_of to -1 (len_at_start is read only where end_of is
//    set, so it needs none);
// 2. ends: each end writes end_of[start] = i and len_at_start[start] =
//    rank + w(i) (w = wlen[i], or 1); a chain has one end, so the
//    destinations are unique.  It also zeroes the selection's ticket and
//    status words;
// 3. one selection pass with decoupled look-back (lookback.cuh, as K9, K18
//    and K8): keep = is_start && end_of[i] >= 0 && i < mirror start, each
//    node's row read once; a kept start's rank among the kept ones is its
//    unitig id, in index order (the exclusive prefix of keep); the pass
//    writes ks[i] (the id, or -1) and, at each id, start_oid, length and
//    circular; the last tile writes n_unitigs;
// 4. ids: uid[i] = ks[start] where valid, rank[i] = rank where uid >= 0;
//    and the zero tails of start_oid, length and circular past n_unitigs.
// Bound: memory.  Each node's 32-byte row is read by the three passes
// (two 16-byte loads each, and only for valid nodes), pred and end_of
// once by the selection, and ks gathered at its start; at 2^19 nodes
// the passes are short enough that their latency, not bytes, sets them.
#include "lookback.cuh"

namespace {

constexpr long long kRooted = 1LL << 30;
constexpr long long kDmask = (1LL << 28) - 1;
constexpr long long kLenMask = (1LL << 30) - 1;

// Nodes per selection tile: kItems per thread, their loads all issued
// before the first is used (the flags first, then the valid nodes' rows).
constexpr int kItems = 4;
constexpr long long kTile = bt::kThreads * kItems;  // 1024

struct Row {
  long long ptr, dsf, mn, dmn;
  __device__ bool in_cycle() const { return !(dsf & kRooted); }  // of a valid node
  __device__ long long start() const { return in_cycle() ? mn : ptr; }
  __device__ long long rank() const { return in_cycle() ? dmn : (dsf & kDmask); }
};

__device__ __forceinline__ Row load_row(const longlong2* __restrict__ state,
                                        long long i) {
  const longlong2 a = __ldg(state + 2 * i), b = __ldg(state + 2 * i + 1);
  return Row{a.x, a.y, b.x, b.y};
}

// zero: the selection's ticket and status words (n_zero of them).
__global__ void finish_ends(const int64_t* __restrict__ succ,
                            const uint8_t* __restrict__ valid,
                            const longlong2* __restrict__ state,
                            const int64_t* __restrict__ wlen, long long M,
                            int64_t* __restrict__ end_of,
                            int64_t* __restrict__ len_at_start,
                            unsigned long long* __restrict__ zero,
                            long long n_zero) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_zero) zero[i] = 0;
  if (i >= M || !valid[i]) return;
  const Row r = load_row(state, i);
  const long long s = succ[i];
  if (!(s < 0 || (r.in_cycle() && s == r.mn))) return;
  const long long start = r.start();
  if (start < 0 || start >= M) return;
  end_of[start] = i;
  len_at_start[start] = r.rank() + (wlen != nullptr ? wlen[i] : 1);
}

__global__ void __launch_bounds__(bt::kThreads)
finish_select(const int64_t* __restrict__ pred, const uint8_t* __restrict__ valid,
              const longlong2* __restrict__ state,
              const int64_t* __restrict__ end_of,
              const int64_t* __restrict__ len_at_start, long long M,
              unsigned long long* __restrict__ next_tile,
              unsigned long long* __restrict__ status, int64_t* __restrict__ ks,
              int64_t* __restrict__ start_oid, int64_t* __restrict__ length,
              uint8_t* __restrict__ circular, int64_t* __restrict__ n_unitigs) {
  const long long tile = take_tile(next_tile);
  const long long first = tile * kTile + threadIdx.x;
  const long long N = M / 2;
  bool keep[kItems];
  long long pk[kItems], e[kItems], p[kItems];
  Row r[kItems];
  // the flags, then every valid node's row, pred and end_of, all in flight
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * bt::kThreads;
    keep[q] = i < M && valid[i];
  }
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * bt::kThreads;
    if (keep[q]) {
      r[q] = load_row(state, i);
      p[q] = pred[i];
      e[q] = end_of[i];
    }
  }
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * bt::kThreads;
    pk[q] = 0;
    if (!keep[q]) continue;
    const bool brk = r[q].in_cycle() && r[q].mn == i;
    keep[q] = (p[q] < 0 || brk) && e[q] >= 0;
    if (!keep[q]) continue;
    long long mirror_start;
    if (brk) {
      mirror_start = __ldg(state + 2 * ((i + N) % M) + 1).x;  // roll(mn, N)[i]
    } else {
      mirror_start = e[q] >= N ? e[q] - N : e[q] + N;
    }
    keep[q] = i < mirror_start;
    if (keep[q]) pk[q] = len_at_start[i] | (brk ? (1LL << 30) : 0LL);
  }
  long long dest[kItems];
  const long long total = select_ranks<kItems>(keep, tile, status, dest);
  if (threadIdx.x == 0 && tile == (M - 1) / kTile) n_unitigs[0] = total;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * bt::kThreads;
    if (i >= M) break;
    ks[i] = dest[q];
    if (dest[q] >= 0) {
      start_oid[dest[q]] = i;
      length[dest[q]] = pk[q] & kLenMask;
      circular[dest[q]] = ((pk[q] >> 30) & 1) != 0;
    }
  }
}

__global__ void finish_ids(const uint8_t* __restrict__ valid,
                           const longlong2* __restrict__ state,
                           const int64_t* __restrict__ ks,
                           const int64_t* __restrict__ n_unitigs, long long M,
                           int64_t* __restrict__ uid, int64_t* __restrict__ rank,
                           int64_t* __restrict__ start_oid,
                           int64_t* __restrict__ length,
                           uint8_t* __restrict__ circular) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= M) return;
  if (i >= __ldg(reinterpret_cast<const long long*>(n_unitigs))) {
    start_oid[i] = 0;
    length[i] = 0;
    circular[i] = 0;
  }
  long long u = -1, rk = 0;
  if (valid[i]) {
    const Row r = load_row(state, i);
    const long long s = r.start();
    const long long val = ks[s < 0 ? 0 : (s >= M ? M - 1 : s)];
    if (val >= 0) {
      u = val;
      rk = r.rank();
    }
  }
  uid[i] = u;
  rank[i] = rk;
}

}  // namespace

// work: 3M + 1 + ceil(M / 1024) int64 words, needing no fill: end_of
// (set to -1 here), len_at_start, ks, then the selection's ticket and
// tile status words (zeroed by the ends pass).
extern "C" int bt_chain_finish(const int64_t* succ, const int64_t* pred,
                               const uint8_t* valid, const int64_t* state,
                               const int64_t* wlen, long long M,
                               int64_t* work, int64_t* uid, int64_t* rank,
                               int64_t* start_oid, int64_t* length,
                               uint8_t* circular, int64_t* n_unitigs,
                               void* stream) {
  if (M == 0) return 0;
  if (M % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (M + kTile - 1) / kTile;
  int64_t* end_of = work;
  int64_t* len_at_start = work + M;
  int64_t* ks = work + 2 * M;
  auto* words = reinterpret_cast<unsigned long long*>(work + 3 * M);
  const auto* st = reinterpret_cast<const longlong2*>(state);
  cudaError_t err = cudaMemsetAsync(end_of, 0xFF, 8 * M, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_ends<<<bt::blocks_for(M > tiles + 1 ? M : tiles + 1), bt::kThreads, 0,
                s>>>(succ, valid, st, wlen, M, end_of, len_at_start, words, 1 + tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_select<<<static_cast<unsigned int>(tiles), bt::kThreads, 0, s>>>(
      pred, valid, st, end_of, len_at_start, M, words, words + 1, ks, start_oid, length,
      circular, n_unitigs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_ids<<<bt::blocks_for(M), bt::kThreads, 0, s>>>(
      valid, st, ks, n_unitigs, M, uid, rank, start_oid, length, circular);
  return static_cast<int>(cudaGetLastError());
}
