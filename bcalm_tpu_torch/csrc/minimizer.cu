// K20 kmer_minimizers: the per-k-mer minimizer, partition id or m-mer
// histogram of a canonical k-mer set.
//
// Replaces bcalm_tpu/models/minimizer.py:minimizers (:59), partition_of
// (:119) and mmer_histogram (:72), which unroll the k-m+1 m-mers of each
// k-mer (extract_mmers :40: m-mer j covers bases [j, j+m), m <= 16) into a
// (k-m+1, N) array.  One thread per k-mer column of the (L, N) lanes rolls
// the window over the k-mer's bases instead (mm_{j+1} = (mm_j << 2 | base)
// masked to 2m bits), so no m-mer array is written:
//   mode 0: the minimizer, the m-mer of least value, or with a frequency
//     rank the m-mer of least rank[mm], the first one winning ties as
//     jnp.argmin does; with a table, table[minimizer] (partition_of);
//   mode 1: every m-mer of a valid column adds one to its bin of the (4^m,)
//     histogram (atomicAdd; the sum does not depend on the order).
// Lanes are most-significant first, base p of a k-mer at bits
// 2*(k-1-p) of the whole field (bcalm_tpu models/lanes.py).
//
// Bound: memory.  Each column's L lanes are read once (coalesced across
// threads); the rank and table lookups are random 8-byte reads, one per
// m-mer for the rank; the histogram's atomics land on 4^m bins.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t base_at(const uint32_t* x, int L, int k,
                                            int p) {
  int e = k - 1 - p;
  return (x[L - 1 - e / 16] >> (2 * (e % 16))) & 3u;
}

__global__ void kmer_minimizers_kernel(const int64_t* __restrict__ lanes,
                                       long long stride, int L, long long N,
                                       int k, int m,
                                       const int64_t* __restrict__ rank,
                                       const int64_t* __restrict__ table,
                                       int mode,
                                       const uint8_t* __restrict__ valid,
                                       int64_t* __restrict__ out) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  if (mode == 1 && valid != nullptr && !valid[i]) return;
  uint32_t x[bt::kMaxLanes];
  for (int j = 0; j < L; ++j) x[j] = static_cast<uint32_t>(lanes[j * stride + i]);
  const uint32_t mask = m == 16 ? 0xFFFFFFFFu : ((1u << (2 * m)) - 1u);
  uint32_t mm = 0;
  for (int p = 0; p < m - 1; ++p) mm = (mm << 2) | base_at(x, L, k, p);
  uint32_t best = 0;
  long long best_key = 0;
  for (int j = 0; j + m <= k; ++j) {
    mm = ((mm << 2) | base_at(x, L, k, j + m - 1)) & mask;
    if (mode == 1) {
      atomicAdd(reinterpret_cast<unsigned long long*>(out) + mm, 1ull);
      continue;
    }
    long long key = rank != nullptr ? rank[mm] : static_cast<long long>(mm);
    if (j == 0 || key < best_key) {  // strict: the first minimum wins
      best_key = key;
      best = mm;
    }
  }
  if (mode == 0) out[i] = table != nullptr ? table[best] : static_cast<long long>(best);
}

}  // namespace

extern "C" int bt_kmer_minimizers(const int64_t* lanes, long long stride, int L,
                                  long long N, int k, int m, const int64_t* rank,
                                  const int64_t* table, int mode,
                                  const uint8_t* valid, int64_t* out,
                                  void* stream) {
  if (L < 1 || L > bt::kMaxLanes || m < 1 || m > 16 || m > k ||
      (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  kmer_minimizers_kernel<<<bt::blocks_for(N), bt::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      lanes, stride, L, N, k, m, rank, table, mode, valid, out);
  return static_cast<int>(cudaGetLastError());
}
