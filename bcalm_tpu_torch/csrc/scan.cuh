// Block and tile scans shared by the kernels (K8-K12).
//
// block_exclusive: an exclusive scan over the threads of one block, forward
// or backward, with any associative operator (warp shuffles, then one warp
// over the per-warp totals).
//
// exclusive_sum: the three-launch tile scan of an int64 value per index
// over [0, n) (tiles of 1024 entries, 256 threads with 4 entries each):
// reduce each tile to its sum; one block turns the tile sums into
// exclusive carries and writes the grand total; each tile then scans
// itself again from its carry and calls apply(i, exclusive prefix, value)
// for every index, in no particular order across tiles.  value and apply
// are device functors passed by value.  The order of the outputs is fixed
// by the prefix, never by atomics, so every compaction built on it is
// stable.
#pragma once

#include "common.cuh"

namespace {

constexpr int kScanItems = 4;
constexpr int kScanTile = bt::kThreads * kScanItems;
constexpr int kCarryThreads = 1024;

struct Sum {
  __device__ long long operator()(long long a, long long b) const { return a + b; }
};
struct Max {
  __device__ long long operator()(long long a, long long b) const { return a > b ? a : b; }
};
struct Min {
  __device__ long long operator()(long long a, long long b) const { return a < b ? a : b; }
};

// Exclusive scan of v over the threads of the block, in thread order
// (forward) or in reverse thread order; returns this thread's exclusive
// value and sets total.  sh holds one slot per warp; every thread of the
// block must call it.
template <bool kForward, class Op>
__device__ long long block_exclusive(long long v, Op op, long long ident,
                                     long long* sh, long long& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    long long y = kForward ? __shfl_up_sync(0xFFFFFFFFu, inc, d)
                           : __shfl_down_sync(0xFFFFFFFFu, inc, d);
    if (kForward ? lane >= d : lane + d < 32) inc = op(inc, y);
  }
  long long exc = kForward ? __shfl_up_sync(0xFFFFFFFFu, inc, 1)
                           : __shfl_down_sync(0xFFFFFFFFu, inc, 1);
  if (kForward ? lane == 0 : lane == 31) exc = ident;
  if (kForward ? lane == 31 : lane == 0) sh[w] = inc;
  __syncthreads();
  if (w == 0) {
    long long s = lane < nw ? sh[lane] : ident;
    for (int d = 1; d < 32; d <<= 1) {
      long long y = kForward ? __shfl_up_sync(0xFFFFFFFFu, s, d)
                             : __shfl_down_sync(0xFFFFFFFFu, s, d);
      if (kForward ? lane >= d : lane + d < 32) s = op(s, y);
    }
    if (lane < nw) sh[lane] = s;  // inclusive over warps, in scan order
  }
  __syncthreads();
  long long before = ident;
  if (kForward && w > 0) before = sh[w - 1];
  if (!kForward && w < nw - 1) before = sh[w + 1];
  total = kForward ? sh[nw - 1] : sh[0];
  __syncthreads();  // sh is reused by the next call
  return op(before, exc);
}

inline long long scan_tiles(long long n) { return (n + kScanTile - 1) / kScanTile; }

template <class Value>
__global__ void tile_sum_reduce(Value value, long long n,
                                long long* __restrict__ agg) {
  __shared__ long long sh[32];
  long long base = static_cast<long long>(blockIdx.x) * kScanTile + threadIdx.x * kScanItems;
  long long s = 0;
  for (int q = 0; q < kScanItems; ++q) {
    if (base + q < n) s += value(base + q);
  }
  long long tot;
  block_exclusive<true>(s, Sum(), 0, sh, tot);
  if (threadIdx.x == 0) agg[blockIdx.x] = tot;
}

// One block: the tile sums become exclusive carries, in place.
__global__ void tile_sum_carry(long long nb, long long* __restrict__ agg,
                               int64_t* __restrict__ total) {
  __shared__ long long sh[32];
  long long run = 0;
  for (long long t0 = 0; t0 < nb; t0 += blockDim.x) {
    long long b = t0 + threadIdx.x;
    long long c = b < nb ? agg[b] : 0;
    long long tc;
    long long ec = block_exclusive<true>(c, Sum(), 0, sh, tc);
    if (b < nb) agg[b] = run + ec;
    run += tc;
  }
  if (threadIdx.x == 0 && total != nullptr) total[0] = run;
}

template <class Value, class Apply>
__global__ void tile_sum_apply(Value value, Apply apply, long long n,
                               const long long* __restrict__ carry) {
  __shared__ long long sh[32];
  long long base = static_cast<long long>(blockIdx.x) * kScanTile + threadIdx.x * kScanItems;
  long long v[kScanItems];
  long long s = 0;
  for (int q = 0; q < kScanItems; ++q) {
    v[q] = base + q < n ? value(base + q) : 0;
    s += v[q];
  }
  long long tot;
  long long run = carry[blockIdx.x] + block_exclusive<true>(s, Sum(), 0, sh, tot);
  for (int q = 0; q < kScanItems; ++q) {
    if (base + q >= n) break;
    apply(base + q, run, v[q]);
    run += v[q];
  }
}

// The three launches; scratch holds scan_tiles(n) int64, total (may be
// null) receives the sum.  n == 0 launches nothing.
template <class Value, class Apply>
int exclusive_sum(Value value, Apply apply, long long n, long long* scratch,
                  int64_t* total, cudaStream_t s) {
  if (n == 0) return 0;
  long long nb = scan_tiles(n);
  unsigned int grid = static_cast<unsigned int>(nb);
  tile_sum_reduce<<<grid, bt::kThreads, 0, s>>>(value, n, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_sum_carry<<<1, kCarryThreads, 0, s>>>(nb, scratch, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_sum_apply<<<grid, bt::kThreads, 0, s>>>(value, apply, n, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
