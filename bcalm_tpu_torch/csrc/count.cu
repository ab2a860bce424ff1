// K2 count_runs: run heads, per-group count/weight sum and min pos, and
// compaction of a lexicographically sorted k-mer column set.
//
// Replaces the body of bcalm_tpu/ops/count.py:count_canonical after its
// first sort (the TPU version re-sorts by group id to compact, because
// TPU scatters are slow; here the compaction is a direct scatter).
// Two launches around a torch.cumsum:
//   count_flags:   flag[i] = column i is valid (not all-sentinel) and
//                  differs from column i-1 (an adjacent-lane compare);
//   (host)         gid = cumsum(flag) - 1;
//   count_scatter: each valid column adds its weight (1 when unweighted)
//                  to counts[gid] and min-reduces its pos into
//                  minpos[gid] with 64-bit atomics; a head also writes its
//                  lanes to unique[:, gid].
// The min is a real segmented min: merged runs interleave their pos
// values, so no ordering of the sort is relied on.  Sums are int64.
//
// Bound: memory.  count_flags reads 2*L*8 bytes per column (its own and
// its left neighbour's lanes, the latter mostly from L1) and writes 8;
// count_scatter reads (L+3)*8 and makes one or two atomics per column.
// Atomics on one group serialize, which costs time only for k-mers with
// very high multiplicity in one chunk.
#include "common.cuh"

namespace {

__device__ __forceinline__ bool column_valid(const int64_t* lanes,
                                             long long stride, int L,
                                             long long i) {
  for (int j = 0; j < L; ++j) {
    if (static_cast<uint32_t>(lanes[j * stride + i]) != bt::kSentinel) return true;
  }
  return false;
}

__global__ void count_flags_kernel(const int64_t* __restrict__ lanes,
                                   long long stride, long long N, int L,
                                   int64_t* __restrict__ flags) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  bool head = column_valid(lanes, stride, L, i);
  if (head && i > 0) {
    bool diff = false;
    for (int j = 0; j < L; ++j) {
      diff |= lanes[j * stride + i] != lanes[j * stride + i - 1];
    }
    head = diff;
  }
  flags[i] = head ? 1 : 0;
}

__global__ void count_scatter_kernel(const int64_t* __restrict__ lanes,
                                     long long stride, long long N, int L,
                                     const int64_t* __restrict__ flags,
                                     const int64_t* __restrict__ gid,
                                     const int64_t* __restrict__ weights,
                                     const int64_t* __restrict__ pos,
                                     int64_t* __restrict__ unique,
                                     long long ustride,
                                     int64_t* __restrict__ counts,
                                     int64_t* __restrict__ minpos) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N || !column_valid(lanes, stride, L, i)) return;
  long long g = gid[i];
  if (flags[i]) {
    for (int j = 0; j < L; ++j) unique[j * ustride + g] = lanes[j * stride + i];
  }
  unsigned long long w = weights ? static_cast<unsigned long long>(weights[i]) : 1ull;
  atomicAdd(reinterpret_cast<unsigned long long*>(counts + g), w);
  if (pos) {
    atomicMin(reinterpret_cast<unsigned long long*>(minpos + g),
              static_cast<unsigned long long>(pos[i]));
  }
}

}  // namespace

extern "C" int bt_count_flags(const int64_t* lanes, long long stride,
                              long long N, int L, int64_t* flags,
                              void* stream) {
  if (N == 0) return 0;
  count_flags_kernel<<<bt::blocks_for(N), bt::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(lanes, stride, N,
                                                            L, flags);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_count_scatter(const int64_t* lanes, long long stride,
                                long long N, int L, const int64_t* flags,
                                const int64_t* gid, const int64_t* weights,
                                const int64_t* pos, int64_t* unique,
                                long long ustride, int64_t* counts,
                                int64_t* minpos, void* stream) {
  if (N == 0) return 0;
  count_scatter_kernel<<<bt::blocks_for(N), bt::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lanes, stride, N, L, flags, gid, weights, pos, unique, ustride, counts,
      minpos);
  return static_cast<int>(cudaGetLastError());
}
