// K1 extract_insert: canonical k-mer extraction + sentinel fold + chunk insert.
//
// Replaces bcalm_tpu/engine.py:_extract_insert (with
// bcalm_tpu/ops/extract.py:extract_canonical).  One thread per (read,
// position) of a (B, W) packed block: it reads the k bases of its window,
// builds the forward and reverse-complement lanes directly (no window-pack
// doubling: that form exists for the TPU's vector unit), picks the
// lexicographically smaller, and writes L canonical lanes plus the
// first-occurrence key ((slot << 1) | rc, clamped below the sentinel; the
// slot is slot_base + b*P_eff + p, or with a per-row base (the received
// superkmers of the -devices N build, bcalm_tpu/parallel/pipeline.py:348)
// (row_base[b] + p) & 0x3FFFFFFF) into
// column `offset + slot` of the (L+1, cap) int64 chunk buffer.  Invalid
// positions (p > len - k) write the all-ones sentinel in every row.
//
// Bound: memory.  Per slot it writes (L+1)*8 bytes and reads k/16 words
// that neighbouring threads share through L1; at L=2 that is 24 bytes out
// per slot.  Above 8 lanes (k > 128) the value sits right-aligned in a 16-
// or 32-lane array (common.cuh); the k shifts of that array, ~2k*A funnel
// shifts per slot, then weigh about as much as the stores.  Threads of a
// warp write consecutive columns of each row, so every store is coalesced;
// the words of one read stay in L1 for the read's ~P threads.
#include "common.cuh"

namespace {

template <int L>
__global__ void extract_insert_kernel(int64_t* __restrict__ buf,
                                      long long stride,
                                      const int64_t* __restrict__ words,
                                      const int64_t* __restrict__ lengths,
                                      int B, int W, int P_eff, int k,
                                      uint32_t slot_base,
                                      const int64_t* __restrict__ row_base,
                                      long long offset, int lanes) {
  long long f = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (f >= static_cast<long long>(B) * P_eff) return;
  const int nl = bt::live_lanes<L>(lanes);
  const int pad = L - nl;  // zero lanes above the k-mer's own
  int b = static_cast<int>(f / P_eff);
  int p = static_cast<int>(f % P_eff);
  long long col = offset + f;
  if (p > static_cast<int>(lengths[b]) - k) {
#pragma unroll
    for (int j = 0; j <= L; ++j) {
      if (j <= nl) buf[j * stride + col] = bt::kSentinel;
    }
    return;
  }
  const int64_t* row = words + static_cast<long long>(b) * W;
  int r = k % 16 == 0 ? 16 : k % 16;
  uint32_t fwd[L], rc[L];
#pragma unroll
  for (int j = 0; j < L; ++j) fwd[j] = rc[j] = 0u;
  for (int i = 0; i < k; ++i) {
    int q = p + i;
    uint32_t w = static_cast<uint32_t>(row[q >> 4]);
    uint32_t base = (w >> (2 * (15 - (q & 15)))) & 3u;
    bt::shl2<L>(fwd);
    fwd[L - 1] |= base;
    // rc = sum_i comp(b_i) * 4^i: insert at the top exponent, shift down
    bt::shr2<L>(rc);
    const uint32_t top = (base ^ 2u) << (2 * (r - 1));
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (j == pad) rc[j] |= top;  // a constant index: rc stays in registers
    }
  }
  fwd[0] &= bt::top_mask(k);
  bool use_rc = bt::less<L>(rc, fwd);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (j >= pad) buf[(j - pad) * stride + col] = use_rc ? rc[j] : fwd[j];
  }
  uint32_t slot = row_base
      ? ((static_cast<uint32_t>(row_base[b]) + static_cast<uint32_t>(p)) & 0x3FFFFFFFu)
      : slot_base + static_cast<uint32_t>(f);
  uint32_t pos = (slot << 1) | (use_rc ? 1u : 0u);
  buf[nl * stride + col] = pos < 0xFFFFFFFEu ? pos : 0xFFFFFFFEu;
}

template <int L>
void launch(int64_t* buf, long long stride, const int64_t* words,
            const int64_t* lengths, int B, int W, int P_eff, int k,
            uint32_t slot_base, const int64_t* row_base, long long offset,
            int lanes, cudaStream_t s) {
  long long n = static_cast<long long>(B) * P_eff;
  extract_insert_kernel<L><<<bt::blocks_for(n), bt::kThreads, 0, s>>>(
      buf, stride, words, lengths, B, W, P_eff, k, slot_base, row_base, offset,
      lanes);
}

}  // namespace

extern "C" int bt_extract_insert(int64_t* buf, long long stride,
                                 const int64_t* words, const int64_t* lengths,
                                 int B, int W, int P_eff, int k, int L,
                                 unsigned int slot_base,
                                 const int64_t* row_base, long long offset,
                                 void* stream) {
  if (static_cast<long long>(B) * P_eff == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BT_DISPATCH_LANES(L, launch, buf, stride, words, lengths, B, W, P_eff, k,
                    slot_base, row_base, offset, L, s);
  return static_cast<int>(cudaGetLastError());
}
