// Shared helpers of the bcalm_tpu_torch kernels.
//
// Every tensor the kernels touch is int64 (a u32 lane value, a count, an
// oriented id); arithmetic on lane values is done in uint32_t.  Lane
// arrays are most-significant lane first, as in bcalm_tpu/models/lanes.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bt {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kMaxLanes = 32;  // k <= 512 (models/spans.py MAX_K)
// Lane counts up to kRegLanes (k <= 128) get a kernel of their own, with
// every lane in a register; 9-16 and 17-32 lanes run the 16- and 32-lane
// kernels on the value right-aligned in the wider array (lanes above it
// zero), which shifts, compares and reverse-complements the same way.
constexpr int kRegLanes = 8;

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// Whole-field shift of an L-lane value right by one base (2 bits).
template <int L>
__device__ __forceinline__ void shr2(uint32_t (&x)[L]) {
#pragma unroll
  for (int j = L - 1; j > 0; --j) x[j] = (x[j] >> 2) | (x[j - 1] << 30);
  x[0] >>= 2;
}

// Mask of the 2r live bits of the top lane of an m-mer.
__device__ __forceinline__ uint32_t top_mask(int m) {
  int r = m % 16 == 0 ? 16 : m % 16;
  return r == 16 ? 0xFFFFFFFFu : ((1u << (2 * r)) - 1u);
}

// The 16 bases of a word in reverse order (base i of a left-aligned
// window moves to exponent i), each complemented (code ^ 2).
__device__ __forceinline__ uint32_t revcomp_word(uint32_t x) {
  uint32_t y = __brev(x);
  y = ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
  return y ^ 0xAAAAAAAAu;
}

// Whole-field shift of an L-lane value right by B words, when `on`.
template <int B, int L>
__device__ __forceinline__ void shr_words(uint32_t (&x)[L], bool on) {
  if constexpr (B < L) {
    if (on) {
#pragma unroll
      for (int j = L - 1; j >= B; --j) x[j] = x[j - B];
#pragma unroll
      for (int j = 0; j < B; ++j) x[j] = 0u;
    }
  }
}

// Reverse complement of a right-aligned m-mer held in L lanes, lanes and
// bits above its 2m bits zero (they stay zero).  The whole field, read as
// a string of 16L bases (m-mer last), is reversed word by word
// (revcomp_word of lane t into lane L-1-t): the m-mer's reverse
// complement is then its first m bases, followed by 16L - m complemented
// zero bases.  A right shift by 2(16L - m) bits drops those and brings
// zeros in above: whole words by a barrel of five conditional moves of
// 16, 8, 4, 2 and 1 words (every index compile-time, so the arrays stay
// in registers), then the rest by funnel shifts.  O(L) word operations,
// where a base at a time was O(m * L).
template <int L>
__device__ __forceinline__ void revcomp_field(const uint32_t (&x)[L], int m,
                                              uint32_t (&rc)[L]) {
#pragma unroll
  for (int t = 0; t < L; ++t) rc[L - 1 - t] = revcomp_word(x[t]);
  const int shift = 2 * (16 * L - m);
  const int words = shift >> 5, bits = shift & 31;
  shr_words<16>(rc, words & 16);
  shr_words<8>(rc, words & 8);
  shr_words<4>(rc, words & 4);
  shr_words<2>(rc, words & 2);
  shr_words<1>(rc, words & 1);
#pragma unroll
  for (int j = L - 1; j > 0; --j) rc[j] = __funnelshift_r(rc[j], rc[j - 1], bits);
  rc[0] >>= bits;
}

// Live lanes of a kernel instantiated for an A-lane array: A itself when it
// has a kernel of its own (a compile-time count), else the call's count.
template <int A>
__device__ __forceinline__ int live_lanes(int lanes) {
  return A <= kRegLanes ? A : lanes;
}

// Lexicographic a < b, lane 0 most significant.
template <int L>
__device__ __forceinline__ bool less(const uint32_t (&a)[L],
                                     const uint32_t (&b)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (a[j] != b[j]) return a[j] < b[j];
  }
  return false;
}

}  // namespace bt

// Instantiate `fn<A>` for the lane count L of the call (1..kMaxLanes): A = L
// up to kRegLanes, else the array width 16 or 32 that holds L lanes.
#define BT_DISPATCH_LANES(L, fn, ...)                                  \
  switch (L) {                                                         \
    case 1: fn<1>(__VA_ARGS__); break;                                 \
    case 2: fn<2>(__VA_ARGS__); break;                                 \
    case 3: fn<3>(__VA_ARGS__); break;                                 \
    case 4: fn<4>(__VA_ARGS__); break;                                 \
    case 5: fn<5>(__VA_ARGS__); break;                                 \
    case 6: fn<6>(__VA_ARGS__); break;                                 \
    case 7: fn<7>(__VA_ARGS__); break;                                 \
    case 8: fn<8>(__VA_ARGS__); break;                                 \
    default:                                                           \
      if ((L) > bt::kRegLanes && (L) <= 16) fn<16>(__VA_ARGS__);       \
      else if ((L) > 16 && (L) <= bt::kMaxLanes) fn<32>(__VA_ARGS__);  \
      else return static_cast<int>(cudaErrorInvalidValue);             \
  }
