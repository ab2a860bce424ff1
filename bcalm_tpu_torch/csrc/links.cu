// K22 link_ends + K23 link_pairs: the (k-1)-overlap links between the
// unitigs' ends, from K11's base codes on the device.
//
// Replaces bcalm_tpu/engine.py:link_join (numpy on the host strings: the
// ends packed into key columns, np.unique over them, a grouped cross
// product and a lexsort); the sorts between the two kernels and after
// K23 are torch.sort.
//
// K22 link_ends, a warp per unitig u: its bases start at pre(u) =
// run_start(u) + (k-1) u (K11's layout), its last k-1 at suf(u) = pre(u) +
// length(u).  It writes the exact packed keys of its four ends, m = k-1
// bases 2 bits each (code order A C T G), most significant first, W =
// max(1, ceil(m / 32)) int64 words, the last one zero past the m-th base:
//   out-ends:  (u,+) = suffix at entry u,   (u,-) = rc(prefix) at U + u;
//   in-ends:   (u,+) = prefix at 2U + u,    (u,-) = rc(suffix) at 3U + u,
// word w of entry e at keys[w * 4U + e].  An entry's index is its tag:
// the sort's permutation names the end.  Lane l takes base 32w + l of
// each end (a prefix and a suffix load of 32 consecutive bytes, forward
// and reversed: whole sectors), and the warp packs each key word with two
// OR reductions, the high and the low 16 bases.
//
// K23 link_pairs, over the sort's own output: the top key word in sorted
// order (the values torch.sort returns), the permutation, and the lower
// words in entry order.  The sort is stable, so a group of equal keys
// holds its out-ends (indices below 2U) first, then its in-ends.  Every
// out-end of a group is linked to every in-end of it, to each as one word
//   ((2 src + s) << 32) | (2 dst + d),   sign s, d: + = 0, - = 1,
// unique, so the caller's sort of the words alone gives the (src, sign,
// dst, sign) order of the links.  A block takes 1024 sorted entries, four
// a thread: an out-end at p finds s, the first entry past p that is not
// an out-end of its key, and g1, its group's end, each by a galloping
// search then a bisection (O(log) of the group's size, whatever the
// size), and emits g1 - s pairs; the block scans its counts and takes its
// base with one atomicAdd on the pair counter, so the blocks' runs of
// pairs land in any order.  Pairs past the caller's capacity are counted
// and not written; the caller reads the count and launches again with
// room for it when it was short.
// Bound: memory.  K22 reads 2 (k-1) bytes a unitig (as four sector runs)
// and writes 4 W words; K23 reads the top word and permutation of every
// entry and, past one word, the lower words of the entries it compares
// through the permutation, and writes 8 bytes a pair.
#include "lookback.cuh"

namespace {

constexpr int kPairItems = 4;  // sorted entries per thread of K23
constexpr long long kTileE = bt::kThreads * kPairItems;  // 1024 a tile

// The 64-bit key word of the warp's 32 bases, lane l's base (code < 4, 0
// past the end) at bits 2 (31 - l): lanes 0-15 the high half.
__device__ __forceinline__ long long pack_bases(uint32_t code, int lane) {
  const uint32_t v = code << (2 * (15 - (lane & 15)));
  const uint32_t hi = __reduce_or_sync(0xFFFFFFFFu, lane < 16 ? v : 0u);
  const uint32_t lo = __reduce_or_sync(0xFFFFFFFFu, lane < 16 ? 0u : v);
  return static_cast<long long>((static_cast<unsigned long long>(hi) << 32) | lo);
}

__global__ void __launch_bounds__(bt::kThreads)
link_ends_kernel(const uint8_t* __restrict__ codes,
                 const int64_t* __restrict__ ends, long long U, int m, int W,
                 int64_t* __restrict__ keys) {
  const int lane = threadIdx.x & 31;
  const long long u = static_cast<long long>(blockIdx.x) * (bt::kThreads / 32) +
                      (threadIdx.x >> 5);
  if (u >= U) return;
  const long long pre = (u ? __ldg(ends + u - 1) : 0) + static_cast<long long>(m) * u;
  const long long suf = __ldg(ends + u) + static_cast<long long>(m) * u;
  const long long N = 4 * U;
  for (int w = 0; w < W; ++w) {
    const int j = 32 * w + lane;
    uint32_t a = 0, b = 0, c = 0, d = 0;  // prefix, suffix, their rc
    if (j < m) {
      a = __ldg(codes + pre + j);
      b = __ldg(codes + suf + j);
      c = __ldg(codes + pre + m - 1 - j) ^ 2u;
      d = __ldg(codes + suf + m - 1 - j) ^ 2u;
    }
    const long long out_p = pack_bases(b, lane), out_m = pack_bases(c, lane);
    const long long in_p = pack_bases(a, lane), in_m = pack_bases(d, lane);
    int64_t* row = keys + static_cast<long long>(w) * N;
    if (lane == 0) row[u] = out_p;
    if (lane == 1) row[U + u] = out_m;
    if (lane == 2) row[2 * U + u] = in_p;
    if (lane == 3) row[3 * U + u] = in_m;
  }
}

struct SortedKeys {
  const int64_t* top;    // (N,) sorted
  const int64_t* perm;   // (N,)
  const int64_t* lower;  // (nl, N) in entry order
  int nl;
  long long N;
};

// Whether sorted entry q has the key of sorted entry p (entry e).
__device__ __forceinline__ bool same_key(const SortedKeys& s, long long p,
                                         long long e, long long q) {
  if (__ldg(s.top + q) != __ldg(s.top + p)) return false;
  if (s.nl) {
    const long long f = __ldg(s.perm + q);
    for (int j = 0; j < s.nl; ++j) {
      if (__ldg(s.lower + j * s.N + f) != __ldg(s.lower + j * s.N + e)) return false;
    }
  }
  return true;
}

// The first q in (lo, N] where pred fails (N: nowhere), pred holding at lo
// and, past lo, holding on a prefix: galloping steps of 1, 2, 4, ..., then
// a bisection of the last step.
template <class Pred>
__device__ long long first_fail(long long lo, long long N, Pred pred) {
  long long step = 1, hi;
  for (;;) {
    hi = lo + step;
    if (hi >= N) {
      hi = N;
      break;
    }
    if (!pred(hi)) break;
    lo = hi;
    step <<= 1;
  }
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (pred(mid)) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return hi;
}

__global__ void __launch_bounds__(bt::kThreads)
link_pairs_kernel(SortedKeys s, long long U,
                  unsigned long long* __restrict__ count, long long cap,
                  int64_t* __restrict__ words) {
  __shared__ long long s_sum[bt::kThreads / 32];
  __shared__ long long s_base;
  const int t = threadIdx.x;
  const long long N = s.N, p0 = blockIdx.x * kTileE + t * kPairItems;
  long long e[kPairItems], first[kPairItems], cnt[kPairItems], sum = 0;
#pragma unroll
  for (int q = 0; q < kPairItems; ++q) {
    const long long p = p0 + q;
    cnt[q] = 0;
    first[q] = 0;
    e[q] = p < N ? __ldg(s.perm + p) : 2 * U;
    if (e[q] < 2 * U) {
      const long long ep = e[q];
      const long long f = first_fail(p, N, [&](long long r) {
        return __ldg(s.perm + r) < 2 * U && same_key(s, p, ep, r);
      });
      const long long g1 = f < N && same_key(s, p, ep, f)
                               ? first_fail(f, N, [&](long long r) {
                                   return same_key(s, p, ep, r);
                                 })
                               : f;
      first[q] = f;
      cnt[q] = g1 - f;
    }
    sum += cnt[q];
  }
  long long tile_sum;
  const long long excl = block_exclusive(sum, s_sum, tile_sum);
  if (t == 0) {
    s_base = tile_sum ? static_cast<long long>(atomicAdd(
                            count, static_cast<unsigned long long>(tile_sum)))
                      : 0;
  }
  __syncthreads();
  long long o = s_base + excl;
#pragma unroll
  for (int q = 0; q < kPairItems; ++q) {
    if (!cnt[q]) continue;
    const long long src = e[q] < U ? 2 * e[q] : 2 * (e[q] - U) + 1;
    for (long long i = 0; i < cnt[q] && o + i < cap; ++i) {
      const long long f = __ldg(s.perm + first[q] + i) - 2 * U;
      const long long dst = f < U ? 2 * f : 2 * (f - U) + 1;
      words[o + i] = (src << 32) | dst;
    }
    o += cnt[q];
  }
}

}  // namespace

extern "C" int bt_link_ends(const uint8_t* codes, const int64_t* ends,
                            long long U, int k, int W, int64_t* keys,
                            void* stream) {
  const int m = k - 1;
  if (U <= 0 || m < 0 || W != (m > 32 ? (m + 31) / 32 : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (U + bt::kThreads / 32 - 1) / (bt::kThreads / 32);
  link_ends_kernel<<<static_cast<unsigned int>(blocks), bt::kThreads, 0, st>>>(
      codes, ends, U, m, W, keys);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_link_pairs(const int64_t* top, const int64_t* perm,
                             const int64_t* lower, int nl, long long U,
                             long long* count, long long cap, int64_t* words,
                             void* stream) {
  if (U <= 0 || nl < 0 || nl > 15 || (nl && !lower) || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = 4 * U;
  const long long blocks = (N + kTileE - 1) / kTileE;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  link_pairs_kernel<<<static_cast<unsigned int>(blocks), bt::kThreads, 0, st>>>(
      SortedKeys{top, perm, lower, nl, N}, U,
      reinterpret_cast<unsigned long long*>(count), cap, words);
  return static_cast<int>(cudaGetLastError());
}
