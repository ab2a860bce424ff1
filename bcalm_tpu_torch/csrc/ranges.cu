// K5 range_fold and K6 lower_bound: the key-range primitives of the
// multi-pass (out-of-core) counter.
//
// K5 replaces the fold of bcalm_tpu/engine.py:_count_chunk_ranged: every
// column of an (L+1, N) chunk body (L key lanes + the first-occurrence
// row) whose key lies outside [lo, hi) becomes the all-ones sentinel in
// all L+1 rows, in place, and the in-range columns are counted (the
// rarefaction estimator's occurrence count).  The sentinel compares above
// every hi, so already-invalid columns stay folded and are not counted.
// Since K1 folds in range mode as it writes, the multi-pass count runs K5
// only on a chunk that still holds columns written under a wider range
// (a split narrowed it after they were written), and the -devices build's
// ranged trim runs it on each counted round (parallel/pipeline.py
// stack_trim).
// Bound: memory, the lanes the comparisons read (lane 0 of every column;
// lane j only where lanes 0..j-1 equal lo's or hi's) and the L+1 rows of
// each column that folds.  A warp of a grid-stride loop takes 128
// consecutive columns a step, a lane every 32nd, so each load and store of
// a row is 256 contiguous bytes, as with a thread per column, with 4
// columns a thread in flight.  On the H100 a 32-byte sector written in
// part (HBM3 with ECC) ran slower than one written whole (PERF.md §6), so
// where a column folds, the lanes whose columns share its sector of the
// row (a ballot of the folds, masked by the row's alignment) write theirs
// too: a kept column its own value, re-read (lane 0 is in registers
// already).  The stores are unrolled over the instantiation's compile-time
// lane count.  The count is reduced per warp, then per block, one atomic
// per block into a scratch pair (sum, ticket) that the caller keeps
// zeroed; the block that takes the last ticket writes the total and
// zeroes the pair again, so a call is one device operation (no fill).
//
// K6 replaces bcalm_tpu/engine.py:_count_lt and :_settle_n: for each of P
// bounds, the number of columns of a sorted (L, n) run whose key is below
// the bound.  The JAX programs compare every column against the bound and
// mask a zero tail past n; here n bounds a search.  Bound on this card:
// latency, the dependent round trips to memory of one search (the bytes
// are a few hundred).  A binary search in one thread makes ~log2(n)
// dependent probes, each up to L dependent loads (lane j is read only
// once lanes 0..j-1 compared equal).  So one warp searches one bound,
// 32-ary: each round its 32 lanes probe 32 evenly spaced pivots of the
// open interval, each loading all L lanes of its pivot at once, and the
// ballot of "pivot < bound" (a prefix of ones, the run being sorted)
// picks the next interval, 33 times narrower; the last round probes the
// at most 32 columns left.  At n = 2^22: 5 round trips, not ~22-44.
// Bounds are spread over blocks of 8 warps, so 256 bounds use 32 SMs.
#include <cstring>

#include "common.cuh"

namespace {

struct Key {
  uint32_t v[bt::kMaxLanes];
};

constexpr int kFoldGroups = 4;     // K5: columns per thread per step
constexpr int kFoldBlocksPerSM = 8;

// Lexicographic col < b over L lanes, lane 0 most significant, lane 0's
// value given; lane j is read only where lanes 0..j-1 equal b's.  The loop
// is unrolled over the instantiation's A lanes so that every index into b
// is a constant: b stays in the kernel's parameters, where an index known
// only at run time would copy the whole 32-lane key to local memory per
// thread.
template <int A>
__device__ __forceinline__ bool col_less(uint32_t x0, const int64_t* col,
                                         long long stride, int L,
                                         const Key& b) {
  if (x0 != b.v[0]) return x0 < b.v[0];
#pragma unroll
  for (int j = 1; j < A; ++j) {
    if (j == L) break;
    const uint32_t x = static_cast<uint32_t>(col[j * stride]);
    if (x != b.v[j]) return x < b.v[j];
  }
  return false;
}

// A warp takes 32 * kFoldGroups consecutive columns a step, lane t the
// columns base + 32c + t, so every load and store of a row is 256
// contiguous bytes.  A column that folds makes the lanes that share its
// 32-byte sector of a row write their columns too (a kept column its own
// value, re-read), so each sector a row's fold touches is written whole
// by one instruction; where a row is not 32-byte aligned, the sector that
// spans two groups is written in two parts.
template <int A>
__global__ void __launch_bounds__(bt::kThreads)
range_fold_kernel(int64_t* __restrict__ body, long long stride, long long N,
                  int lanes, Key lo, Key hi,
                  unsigned long long* __restrict__ scratch,
                  int64_t* __restrict__ occ) {
  constexpr int G = kFoldGroups;
  constexpr long long kSpan = 32 * G;
  const int L = bt::live_lanes<A>(lanes);
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  unsigned int kept = 0;
  for (long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) >> 5;
       w * kSpan < N; w += warps) {
    const long long base = w * kSpan + lane;
    long long row0[G];  // lane 0 of the columns, as stored
#pragma unroll
    for (int c = 0; c < G; ++c) {
      row0[c] = base + 32 * c < N ? body[base + 32 * c] : 0;
    }
    bool fold[G];
    unsigned int folds[G];
    bool any = false;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const long long i = base + 32 * c;
      fold[c] = false;
      if (i < N) {
        const uint32_t x = static_cast<uint32_t>(row0[c]);
        const bool keep = !col_less<A>(x, body + i, stride, L, lo) &&
                          col_less<A>(x, body + i, stride, L, hi);
        fold[c] = !keep;
        kept += keep;
      }
      folds[c] = __ballot_sync(0xFFFFFFFFu, fold[c]);
      any |= folds[c] != 0;
    }
    if (!any) continue;  // the same for the whole warp
#pragma unroll
    for (int j = 0; j <= A; ++j) {
      if (j > L) break;
      int64_t* row = body + j * stride;
      // the lanes whose columns share this lane's sector: column base - lane
      // sits at slot `off` of its sector (base - lane is a multiple of 128)
      const int off = static_cast<int>(
          (reinterpret_cast<uintptr_t>(row + (base - lane)) >> 3) & 3u);
      const int first = lane - ((lane + off) & 3);
      const unsigned int mates =
          first >= 0 ? 0xFu << first : 0xFu >> -first;
      long long v[G];
      bool put[G];
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const long long i = base + 32 * c;
        put[c] = i < N && (folds[c] & mates) != 0;
        v[c] = bt::kSentinel;
        if (put[c] && !fold[c]) v[c] = j == 0 ? row0[c] : row[i];
      }
#pragma unroll
      for (int c = 0; c < G; ++c) {
        if (put[c]) row[base + 32 * c] = v[c];
      }
    }
  }
  // the count: per warp, per block, one atomic per block; the last block
  // to take a ticket publishes the sum and leaves the scratch zeroed
  __shared__ unsigned int warp_kept[bt::kThreads / 32];
  kept = __reduce_add_sync(0xFFFFFFFFu, kept);
  if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < bt::kThreads / 32; ++w) total += warp_kept[w];
    if (total) atomicAdd(&scratch[0], total);
    __threadfence();
    if (atomicAdd(&scratch[1], 1ull) == gridDim.x - 1) {
      occ[0] = static_cast<int64_t>(atomicExch(&scratch[0], 0ull));
      atomicExch(&scratch[1], 0ull);
    }
  }
}

template <int A>
void launch_range_fold(int64_t* body, long long stride, long long N, int L,
                       const Key& lo, const Key& hi,
                       unsigned long long* scratch, int64_t* occ,
                       cudaStream_t s) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long per_block = (bt::kThreads / 32) * 32LL * kFoldGroups;
  const long long want = (N + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kFoldBlocksPerSM;
  range_fold_kernel<A><<<static_cast<unsigned int>(want < cap ? want : cap),
                         bt::kThreads, 0, s>>>(body, stride, N, L, lo, hi,
                                               scratch, occ);
}

// The key of A lanes (the first L live, the rest 0) of column i.
template <int A>
__device__ __forceinline__ void load_key(const int64_t* __restrict__ src,
                                         long long stride, long long i, int L,
                                         uint32_t (&x)[A]) {
#pragma unroll
  for (int j = 0; j < A; ++j) {
    x[j] = j < L ? static_cast<uint32_t>(src[j * stride + i]) : 0u;
  }
}

template <int A>
__global__ void lower_bound_kernel(const int64_t* __restrict__ run,
                                   long long stride, long long n, int lanes,
                                   const int64_t* __restrict__ bounds,
                                   long long bstride, long long P,
                                   int64_t* __restrict__ out) {
  const long long p =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (p >= P) return;  // whole warps: P is counted in warps
  const int lane = threadIdx.x & 31;
  const int L = bt::live_lanes<A>(lanes);
  uint32_t b[A], x[A];
  load_key<A>(bounds, bstride, p, L, b);
  // the answer lies in [lo, hi]: columns below lo are below b, columns
  // from hi on are not
  long long lo = 0, hi = n;
  while (hi - lo > 32) {
    const long long len = hi - lo;
    // pivot i (i = 0..31) at lo + (i + 1) * len / 33, strictly rising
    load_key<A>(run, stride, lo + (lane + 1) * len / 33, L, x);
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, bt::less<A>(x, b)));
    const long long new_lo = c == 0 ? lo : lo + c * len / 33 + 1;
    if (c < 32) hi = lo + (c + 1) * len / 33;
    lo = new_lo;
  }
  bool lt = false;
  if (lo + lane < hi) {
    load_key<A>(run, stride, lo + lane, L, x);
    lt = bt::less<A>(x, b);
  }
  const int c = __popc(__ballot_sync(0xFFFFFFFFu, lt));
  if (lane == 0) out[p] = lo + c;
}

template <int A>
void launch_lower_bound(const int64_t* run, long long stride, long long n,
                        int L, const int64_t* bounds, long long bstride,
                        long long P, int64_t* out, cudaStream_t s) {
  const long long warps_per_block = bt::kThreads / 32;
  lower_bound_kernel<A><<<static_cast<unsigned int>(
                              (P + warps_per_block - 1) / warps_per_block),
                          bt::kThreads, 0, s>>>(run, stride, n, L, bounds,
                                                bstride, P, out);
}

}  // namespace

// scratch: two u64 words, zero before the call and zero after it.
extern "C" int bt_range_fold(int64_t* body, long long stride, long long N,
                             int L, const uint32_t* lo, const uint32_t* hi,
                             int64_t* scratch, int64_t* occ, void* stream) {
  if (L < 1 || L > bt::kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  Key klo{}, khi{};
  std::memcpy(klo.v, lo, L * sizeof(uint32_t));
  std::memcpy(khi.v, hi, L * sizeof(uint32_t));
  BT_DISPATCH_LANES(L, launch_range_fold, body, stride, N, L, klo, khi,
                    reinterpret_cast<unsigned long long*>(scratch), occ,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_lower_bound(const int64_t* run, long long stride,
                              long long n, int L, const int64_t* bounds,
                              long long bstride, int P, int64_t* out,
                              void* stream) {
  if (P == 0) return 0;
  BT_DISPATCH_LANES(L, launch_lower_bound, run, stride, n, L, bounds, bstride,
                    P, out, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
