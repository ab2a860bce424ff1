// K20 kmer_minimizers: the per-k-mer minimizer, partition id or m-mer
// histogram of a canonical k-mer set.
//
// Replaces bcalm_tpu/models/minimizer.py:minimizers (:59), partition_of
// (:119) and mmer_histogram (:72), which unroll the k-m+1 m-mers of each
// k-mer (extract_mmers :40: m-mer j covers bases [j, j+m), m <= 16) into a
// (k-m+1, N) array.  A thread takes a k-mer column of the (L, N) lanes and
// writes no m-mer array:
//   minimizer mode: the m-mer of least value, or with a frequency rank the
//     m-mer of least rank[mm], the first one winning ties as jnp.argmin
//     does (strict <); with a table, table[minimizer] (partition_of);
//   histogram mode: every m-mer of a valid column adds one to its bin of
//     the (4^m,) histogram (integer atomics: the sum does not depend on
//     the order).
// Lanes are most-significant first, base p of a k-mer at bits 2*(k-1-p)
// of the whole field (bcalm_tpu models/lanes.py), so the field read as a
// string of 16L bases holds the k-mer in its last k: m-mer j starts at
// base q = 16L - k + j, in word q / 16, and is the top 2m bits of one
// __funnelshift_l of words q / 16 and q / 16 + 1 by 2 (q % 16) (m <= 16,
// so it spans at most two words).  The thread walks its column's words
// once, in order, each read once (coalesced across the warp) into two
// registers, the load of the word after next issued before the current
// word's m-mers; the 16 offsets of a word are unrolled, so every shift is
// a constant.  No per-base loop, and no lane array indexed at run time
// (which had lived in local memory).
//
// Bound: the bytes (8L a column read, 8 written) set the pace only of the
// lexicographic mode.  The ranked modes read rank[mm] once per m-mer,
// N(k-m+1) random 8-byte reads of a table (8 MiB at m = 10) that stays in
// L2: the L2's rate of random sectors.  The histogram makes N(k-m+1)
// random updates of the L2: its rate of them (~97 G/s on the H100), which
// neither 32-bit atomics (on a dense table or on the int64 bins' low
// halves) nor privatized bins in a 16-block cluster's distributed shared
// memory (its remote atomics ran at ~66 G/s) beat; so 64-bit atomics into
// the output, which the call zeroes with a memset first.
#include "common.cuh"

namespace {

// Calls f(mm, first) for each m-mer of the column at col (L words, stride
// apart), in order of position; first is true for m-mer 0 only.
template <typename F>
__device__ __forceinline__ void for_each_mmer(const int64_t* __restrict__ col,
                                              long long stride, int L, int k,
                                              int m, F&& f) {
  const int first = 16 * L - k;  // the field's base where the k-mer starts
  const int last = 16 * L - m;   // where its last m-mer starts
  const int down = 32 - 2 * m;   // an m-mer: the top 2m bits of a 16-base pack
  uint32_t cur = static_cast<uint32_t>(__ldg(col));
  uint32_t nxt = L > 1 ? static_cast<uint32_t>(__ldg(col + stride)) : 0u;
  for (int w = 0; w < L; ++w) {
    // the word after next, loaded before this word's m-mers are taken
    const uint32_t after =
        w + 2 < L ? static_cast<uint32_t>(__ldg(col + (w + 2) * stride)) : 0u;
    const int lo = w == 0 ? first : 0;
    const int hi = last - 16 * w;  // this word's last m-mer start
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r >= lo && r <= hi)
        f(__funnelshift_l(nxt, cur, 2 * r) >> down, w == 0 && r == lo);
    }
    cur = nxt;
    nxt = after;
  }
}

enum Mode { kLeast = 0, kRanked = 1, kHisto = 2 };

template <int MODE>
__global__ void __launch_bounds__(bt::kThreads)
kmer_minimizers_kernel(const int64_t* __restrict__ lanes, long long stride,
                       int L, long long N, int k, int m,
                       const int64_t* __restrict__ rank,
                       const int64_t* __restrict__ table,
                       const uint8_t* __restrict__ valid,
                       int64_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  if (MODE == kHisto) {
    if (valid != nullptr && !valid[i]) return;
    unsigned long long* bins = reinterpret_cast<unsigned long long*>(out);
    for_each_mmer(lanes + i, stride, L, k, m,
                  [&](uint32_t mm, bool) { atomicAdd(bins + mm, 1ull); });
    return;
  }
  uint32_t best = 0xFFFFFFFFu;
  long long best_key = 0;
  for_each_mmer(lanes + i, stride, L, k, m, [&](uint32_t mm, bool first) {
    if (MODE == kRanked) {
      const long long key = __ldg(rank + mm);
      if (first || key < best_key) {  // strict: the first minimum wins
        best_key = key;
        best = mm;
      }
    } else {
      best = min(best, mm);  // equal keys are equal m-mers
    }
  });
  out[i] = table != nullptr ? __ldg(table + best) : static_cast<long long>(best);
}

template <int MODE>
void launch(const int64_t* lanes, long long stride, int L, long long N, int k,
            int m, const int64_t* rank, const int64_t* table,
            const uint8_t* valid, int64_t* out, cudaStream_t stream) {
  kmer_minimizers_kernel<MODE><<<bt::blocks_for(N), bt::kThreads, 0, stream>>>(
      lanes, stride, L, N, k, m, rank, table, valid, out);
}

}  // namespace

// mode 0: out (N,) minimizers or table ids; mode 1: out (4^m,) the
// histogram, zeroed here first.
extern "C" int bt_kmer_minimizers(const int64_t* lanes, long long stride, int L,
                                  long long N, int k, int m, const int64_t* rank,
                                  const int64_t* table, int mode,
                                  const uint8_t* valid, int64_t* out,
                                  void* stream) {
  if (L < 1 || L > bt::kMaxLanes || m < 1 || m > 16 || m > k || k > 16 * L ||
      k <= 16 * (L - 1) || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, sizeof(int64_t) << (2 * m), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N == 0) return 0;
  if (mode == 1)
    launch<kHisto>(lanes, stride, L, N, k, m, rank, table, valid, out, s);
  else if (rank != nullptr)
    launch<kRanked>(lanes, stride, L, N, k, m, rank, table, valid, out, s);
  else
    launch<kLeast>(lanes, stride, L, N, k, m, rank, table, valid, out, s);
  return static_cast<int>(cudaGetLastError());
}
