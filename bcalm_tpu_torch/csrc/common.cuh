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

// Whole-field shifts of an L-lane value by one base (2 bits).
template <int L>
__device__ __forceinline__ void shl2(uint32_t (&x)[L]) {
#pragma unroll
  for (int j = 0; j < L - 1; ++j) x[j] = (x[j] << 2) | (x[j + 1] >> 30);
  x[L - 1] <<= 2;
}

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

// Reverse complement of a right-aligned m-mer held in L lanes (lanes above
// the m-mer's own are zero and stay zero).
template <int L>
__device__ __forceinline__ void revcomp(const uint32_t (&x)[L], int m,
                                        uint32_t (&rc)[L]) {
  uint32_t t[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    t[j] = x[j];
    rc[j] = 0u;
  }
  for (int s = 0; s < m; ++s) {
    uint32_t b = t[L - 1] & 3u;
    shr2<L>(t);
    shl2<L>(rc);
    rc[L - 1] |= b ^ 2u;
  }
  // clear whatever shl2 pushed above the m-mer's 2m bits
  int live = (m + 15) / 16;
  uint32_t tm = top_mask(m);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (j < L - live) rc[j] = 0u;
    else if (j == L - live) rc[j] &= tm;
  }
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
