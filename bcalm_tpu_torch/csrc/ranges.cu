// K5 range_fold and K6 lower_bound: the key-range primitives of the
// multi-pass (out-of-core) counter.
//
// K5 replaces the fold of bcalm_tpu/engine.py:_count_chunk_ranged: every
// column of an (L+1, N) chunk body (L key lanes + the first-occurrence
// row) whose key lies outside [lo, hi) becomes the all-ones sentinel in
// all L+1 rows, in place, and the in-range columns are counted (the
// rarefaction estimator's occurrence count).  The sentinel compares above
// every hi, so already-invalid columns stay folded and are not counted.
// One thread per column; the count is a __syncthreads_count per block and
// one atomic.  Bound: memory, L*8 bytes read per column and (L+1)*8
// written only for columns that fold; the counting that follows (sort +
// K2) costs far more.
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

// Lexicographic col < b over L lanes, lane 0 most significant.  The loop
// is unrolled over kMaxLanes so that every index into b is a constant: b
// stays in registers or the kernel's parameters, where an index known only
// at run time would copy the whole 32-lane key to local memory per thread.
__device__ __forceinline__ bool col_less(const int64_t* col, long long stride,
                                         int L, const Key& b) {
#pragma unroll
  for (int j = 0; j < bt::kMaxLanes; ++j) {
    if (j == L) break;
    uint32_t x = static_cast<uint32_t>(col[j * stride]);
    if (x != b.v[j]) return x < b.v[j];
  }
  return false;
}

__global__ void range_fold_kernel(int64_t* __restrict__ body, long long stride,
                                  long long N, int L, Key lo, Key hi,
                                  unsigned long long* __restrict__ occ) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool keep = false;
  if (i < N) {
    keep = !col_less(body + i, stride, L, lo) &&
           col_less(body + i, stride, L, hi);
    if (!keep) {
      for (int j = 0; j <= L; ++j) body[j * stride + i] = bt::kSentinel;
    }
  }
  int c = __syncthreads_count(keep);
  if (threadIdx.x == 0 && c) atomicAdd(occ, static_cast<unsigned long long>(c));
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

extern "C" int bt_range_fold(int64_t* body, long long stride, long long N,
                             int L, const uint32_t* lo, const uint32_t* hi,
                             int64_t* occ, void* stream) {
  if (L < 1 || L > bt::kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  Key klo{}, khi{};
  std::memcpy(klo.v, lo, L * sizeof(uint32_t));
  std::memcpy(khi.v, hi, L * sizeof(uint32_t));
  range_fold_kernel<<<bt::blocks_for(N), bt::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      body, stride, N, L, klo, khi, reinterpret_cast<unsigned long long*>(occ));
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
