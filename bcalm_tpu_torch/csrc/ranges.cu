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
// mask a zero tail past n; here n bounds a binary search, one thread per
// bound.  Bound: latency, log2(n) dependent loads per bound.
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

__global__ void lower_bound_kernel(const int64_t* __restrict__ run,
                                   long long stride, long long n, int L,
                                   const int64_t* __restrict__ bounds,
                                   long long bstride, int P,
                                   int64_t* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  Key b;
#pragma unroll
  for (int j = 0; j < bt::kMaxLanes; ++j) {
    b.v[j] = j < L ? static_cast<uint32_t>(bounds[j * bstride + p]) : 0u;
  }
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = lo + (hi - lo) / 2;
    if (col_less(run + mid, stride, L, b)) lo = mid + 1;
    else hi = mid;
  }
  out[p] = lo;
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
  if (L < 1 || L > bt::kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  lower_bound_kernel<<<bt::blocks_for(P), bt::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      run, stride, n, L, bounds, bstride, P, out);
  return static_cast<int>(cudaGetLastError());
}
