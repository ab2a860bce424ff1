// K1 extract_insert: canonical k-mer extraction + sentinel fold + chunk insert.
//
// Replaces bcalm_tpu/engine.py:_extract_insert (with
// bcalm_tpu/ops/extract.py:extract_canonical) and, in range mode, the fold
// of bcalm_tpu/engine.py:_count_chunk_ranged.  One thread per (read,
// position) of a (B, W) packed block writes L canonical lanes plus the
// first-occurrence key ((slot << 1) | rc, clamped below the sentinel; the
// slot is slot_base + b*P_eff + p, or with a per-row base (the received
// superkmers of the -devices N build, bcalm_tpu/parallel/pipeline.py:348)
// (row_base[b] + p) & 0x3FFFFFFF) into column `offset + slot` of the
// (L+1, cap) int64 chunk buffer.  Invalid positions (p > len - k) write the
// all-ones sentinel in every row; in range mode so does every column whose
// canonical key lies outside [lo, hi), the comparison made on the lanes
// the thread already holds (the multi-pass count then needs no K5 pass).
//
// Windows are built a word at a time, not a base at a time.  A row is a
// big-endian string of 2-bit bases (base q at bits 2*(15-(q&15)) of word
// q>>4), so the window at p is bits [2p, 2p+2k) of it:
// - forward lane t from the bottom is the 32 bits ending 32t bits before
//   the window's end: one funnel shift of two neighbouring words;
// - reverse-complement lane t from the bottom is the 32 bits starting 32t
//   bits after the window's start, its 16 bases reversed (__brev, then the
//   two bits of each base swapped back) and complemented (code ^ 2);
// - the top lane of each is masked to the k-mer's 2r live bits.
// A slot costs O(L) word operations and 2(L+1) word loads (read through
// the read-only path: a warp's threads take consecutive positions, so
// their loads fall in the same few words).
//
// Bound: memory, the (L+1)*8 bytes stored per slot (24 at L = 2); the
// stores of a warp are consecutive columns of each row, so coalesced.
// Above 8 lanes (k > 128) the value sits right-aligned in a 16- or
// 32-lane array (common.cuh); every loop runs over the array's compile-
// time width with the live-lane count as a predicate, so the arrays stay
// in registers.
#include "common.cuh"

namespace {

// A range bound of an A-lane instantiation: the L live lanes right-
// aligned, zeros above, as the canonical lanes are held.
template <int A>
struct Bound {
  uint32_t v[A];
};

// Word i of a row of W words, 0 outside the row.
__device__ __forceinline__ uint32_t row_word(const long long* row, int i,
                                             int W) {
  return (i >= 0 && i < W) ? static_cast<uint32_t>(__ldg(row + i)) : 0u;
}

template <int A, bool kRange>
__global__ void __launch_bounds__(bt::kThreads)
extract_insert_kernel(int64_t* __restrict__ buf, long long stride,
                      const int64_t* __restrict__ words,
                      const int64_t* __restrict__ lengths, unsigned int n,
                      int W, int P_eff, int k, uint32_t slot_base,
                      const int64_t* __restrict__ row_base, long long offset,
                      int lanes, Bound<A> lo, Bound<A> hi) {
  const unsigned int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  const int nl = bt::live_lanes<A>(lanes);
  const int pad = A - nl;  // zero lanes above the k-mer's own
  const int b = static_cast<int>(f / static_cast<unsigned int>(P_eff));
  const int p = static_cast<int>(f) - b * P_eff;
  const long long col = offset + f;
  bool keep = p <= static_cast<int>(__ldg(reinterpret_cast<const long long*>(
                       lengths) + b)) - k;
  uint32_t canon[A];
#pragma unroll
  for (int j = 0; j < A; ++j) canon[j] = 0u;
  bool use_rc = false;
  if (keep) {
    const long long* row =
        reinterpret_cast<const long long*>(words) + static_cast<long long>(b) * W;
    const uint32_t tm = bt::top_mask(k);
    // forward: lane t from the bottom = bits [e - 32(t+1), e - 32t) of the
    // row, e = 2(p+k) the window's end: words we-t-1 and we-t, shifted se
    const int e = 2 * (p + k), we = e >> 5, se = e & 31;
    uint32_t fwd[A], rc[A];
    uint32_t lower = row_word(row, we, W);
#pragma unroll
    for (int t = 0; t < A; ++t) {
      uint32_t v = 0u;
      if (t < nl) {
        const uint32_t upper = row_word(row, we - t - 1, W);
        v = __funnelshift_l(lower, upper, se);
        if (t == nl - 1) v &= tm;
        lower = upper;
      }
      fwd[A - 1 - t] = v;
    }
    // reverse complement: lane t from the bottom = bases 16t..16t+15 of
    // the window, reversed: bits [2p + 32t, 2p + 32t + 32) of the row
    const int ws = p >> 4, ss = (2 * p) & 31;
    uint32_t upper = row_word(row, ws, W);
#pragma unroll
    for (int t = 0; t < A; ++t) {
      uint32_t v = 0u;
      if (t < nl) {
        const uint32_t next = row_word(row, ws + t + 1, W);
        v = bt::revcomp_word(__funnelshift_l(next, upper, ss));
        if (t == nl - 1) v &= tm;
        upper = next;
      }
      rc[A - 1 - t] = v;
    }
    use_rc = bt::less<A>(rc, fwd);
#pragma unroll
    for (int j = 0; j < A; ++j) canon[j] = use_rc ? rc[j] : fwd[j];
    if (kRange) keep = !bt::less<A>(canon, lo.v) && bt::less<A>(canon, hi.v);
  }
  // one store path for kept and folded columns: a warp whose columns
  // differ does not run two
#pragma unroll
  for (int j = 0; j < A; ++j) {
    if (j >= pad)
      buf[(j - pad) * stride + col] = keep ? canon[j] : bt::kSentinel;
  }
  const uint32_t slot = row_base
      ? ((static_cast<uint32_t>(row_base[b]) + static_cast<uint32_t>(p)) & 0x3FFFFFFFu)
      : slot_base + f;
  const uint32_t pos = (slot << 1) | (use_rc ? 1u : 0u);
  buf[nl * stride + col] =
      keep ? (pos < 0xFFFFFFFEu ? pos : 0xFFFFFFFEu) : bt::kSentinel;
}

template <int A>
void launch(int64_t* buf, long long stride, const int64_t* words,
            const int64_t* lengths, unsigned int n, int W, int P_eff, int k,
            uint32_t slot_base, const int64_t* row_base, long long offset,
            int L, const uint32_t* lo, const uint32_t* hi, cudaStream_t s) {
  Bound<A> blo{}, bhi{};
  if (lo) {
    for (int i = 0; i < L; ++i) {
      blo.v[A - L + i] = lo[i];
      bhi.v[A - L + i] = hi[i];
    }
  }
  const unsigned int blocks = (n + bt::kThreads - 1) / bt::kThreads;
  if (lo) {
    extract_insert_kernel<A, true><<<blocks, bt::kThreads, 0, s>>>(
        buf, stride, words, lengths, n, W, P_eff, k, slot_base, row_base,
        offset, L, blo, bhi);
  } else {
    extract_insert_kernel<A, false><<<blocks, bt::kThreads, 0, s>>>(
        buf, stride, words, lengths, n, W, P_eff, k, slot_base, row_base,
        offset, L, blo, bhi);
  }
}

}  // namespace

// lo, hi: L u32 lanes each (range mode), or both null.
extern "C" int bt_extract_insert(int64_t* buf, long long stride,
                                 const int64_t* words, const int64_t* lengths,
                                 int B, int W, int P_eff, int k, int L,
                                 unsigned int slot_base,
                                 const int64_t* row_base, long long offset,
                                 const uint32_t* lo, const uint32_t* hi,
                                 void* stream) {
  const long long n = static_cast<long long>(B) * P_eff;
  if (n == 0) return 0;
  if (n > 0x7FFFFFFFll || (lo == nullptr) != (hi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BT_DISPATCH_LANES(L, launch, buf, stride, words, lengths,
                    static_cast<unsigned int>(n), W, P_eff, k, slot_base,
                    row_base, offset, L, lo, hi, s);
  return static_cast<int>(cudaGetLastError());
}
