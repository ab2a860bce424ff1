// K3 junction_keys + junction_pairs: the (k-1)-overlap successor array.
//
// Replaces bcalm_tpu/ops/junctions.py:successor_arrays (its key build and
// its pair detection / scatter; the sort between them is torch.sort).
//
// junction_keys, one thread per solid k-mer i < C: the suffix and prefix
// (k-1)-mers, their canonical forms, strands and palindrome flags; writes
// the strand-0 representative entry of each side (suffix at i, prefix at
// C+i): the key rows (exact canonical lanes, or the three _hash96 words
// when k-1 > 48), sentinel-folded where invalid or palindromic, and the
// payload oid | role << 30.
//
// junction_pairs, one thread per sorted entry: a group of exactly two
// entries (one OUT, one IN, on distinct vertices) sets succ[src] = dst
// and the mirror edge succ[mirror(dst)] = mirror(src).  Every oriented
// node has one out-end, so no two threads write one slot.
//
// The sharded glue of the -devices N build (global mode) replaces
// bcalm_tpu/parallel/distcompact.py:_local_succ_shard (:53) around its
// exchange.  junction_entries, one thread per local k-mer i < slot_cap:
// all four entries of its two sides (suffix at i and N+i, prefix at 2N+i
// and 3N+i, N = slot_cap), keyed by the exact canonical (k-1)-mer lanes
// with the strand folded into the spare bits of the top lane (or carried
// as an extra first row when k-1 is a multiple of 16; palindromic sides
// take strand 0 on both entries), oriented ids global (+ = gbase + i,
// - = gbase + i + tot), and each entry's owner rank = hash_lanes(key rows)
// % n_dev (hash.cuh).  junction_edges, one thread per sorted received
// entry: the pair rule of junction_pairs, emitting (ok, src, dst) per entry
// instead of scattering, since src and dst belong to other ranks.
//
// Bound: memory.  junction_keys reads L*8 bytes per k-mer and writes
// 2*(K+1)*8 (K key rows); the per-base reverse complement loop is
// register-only.  junction_pairs reads 3 neighbouring key columns (L1
// reuse) and does at most two random 8-byte stores per pair.
#include "common.cuh"
#include "hash.cuh"

namespace {

constexpr uint32_t kRoleShift = 30;
constexpr uint32_t kOidMask = (1u << 30) - 1u;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

template <int L>
__global__ void junction_keys_kernel(const int64_t* __restrict__ solid,
                                     long long stride, long long C,
                                     long long n_solid, int k, int hashed,
                                     int64_t* __restrict__ keys,
                                     long long kstride,
                                     int64_t* __restrict__ payload) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int m = k - 1;
  const int off = L - (m + 15) / 16;  // lanes above the (k-1)-mer
  uint32_t suf[L], pre[L], suf_rc[L], pre_rc[L];
#pragma unroll
  for (int j = 0; j < L; ++j) suf[j] = pre[j] = static_cast<uint32_t>(solid[j * stride + i]);
  bt::shr2<L>(pre);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (j < off) suf[j] = pre[j] = 0u;
    else if (j == off) suf[j] &= bt::top_mask(m);
  }
  bt::revcomp<L>(suf, m, suf_rc);
  bt::revcomp<L>(pre, m, pre_rc);
  bool sig = bt::less<L>(suf_rc, suf);
  bool tau = bt::less<L>(pre_rc, pre);
  bool suf_pal = (m % 2 == 0), pre_pal = (m % 2 == 0);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    suf_pal &= suf[j] == suf_rc[j];
    pre_pal &= pre[j] == pre_rc[j];
  }
  bool valid = i < n_solid;
  bool vs = valid && !suf_pal, vp = valid && !pre_pal;
  long long oid_s = sig ? i + C : i, oid_p = tau ? i + C : i;
  payload[i] = oid_s | (static_cast<long long>(sig ? 1 : 0) << kRoleShift);
  payload[C + i] = oid_p | (static_cast<long long>(tau ? 0 : 1) << kRoleShift);
  if (!hashed) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (j < off) continue;
      uint32_t sc = sig ? suf_rc[j] : suf[j];
      uint32_t pc = tau ? pre_rc[j] : pre[j];
      keys[(j - off) * kstride + i] = vs ? sc : bt::kSentinel;
      keys[(j - off) * kstride + C + i] = vp ? pc : bt::kSentinel;
    }
    return;
  }
  uint32_t hs[3] = {0x9E3779B1u, 0x61C88647u, 0x2545F491u};
  uint32_t hp[3] = {0x9E3779B1u, 0x61C88647u, 0x2545F491u};
  const uint32_t mul[3] = {0x85EBCA6Bu, 0xC2B2AE35u, 0x27D4EB2Fu};
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (j < off) continue;
    uint32_t jj = static_cast<uint32_t>(j - off);
    uint32_t sc = sig ? suf_rc[j] : suf[j];
    uint32_t pc = tau ? pre_rc[j] : pre[j];
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      uint32_t add = static_cast<uint32_t>(w + 1) * jj + 1u;
      hs[w] = (hs[w] ^ sc) * mul[w] + add;
      hp[w] = (hp[w] ^ pc) * mul[w] + add;
    }
  }
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    keys[w * kstride + i] = vs ? mix32(hs[w]) : bt::kSentinel;
    keys[w * kstride + C + i] = vp ? mix32(hp[w]) : bt::kSentinel;
  }
}

template <int L>
void launch_keys(const int64_t* solid, long long stride, long long C,
                 long long n_solid, int k, int hashed, int64_t* keys,
                 long long kstride, int64_t* payload, cudaStream_t s) {
  junction_keys_kernel<L><<<bt::blocks_for(C), bt::kThreads, 0, s>>>(
      solid, stride, C, n_solid, k, hashed, keys, kstride, payload);
}

__device__ __forceinline__ bool same_key(const int64_t* keys, long long kstride,
                                         int K, long long a, long long b) {
  for (int r = 0; r < K; ++r) {
    if (keys[r * kstride + a] != keys[r * kstride + b]) return false;
  }
  return true;
}

__global__ void junction_pairs_kernel(const int64_t* __restrict__ keys,
                                      long long kstride, int K,
                                      const int64_t* __restrict__ pay,
                                      long long E, long long C, int hashed,
                                      int64_t* __restrict__ succ) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i + 1 >= E) return;  // a pair head has a partner at i+1
  bool valid;
  if (hashed) {
    valid = false;
    for (int r = 0; r < K; ++r) {
      valid |= static_cast<uint32_t>(keys[r * kstride + i]) != bt::kSentinel;
    }
  } else {
    valid = static_cast<uint32_t>(keys[i]) != bt::kSentinel;
  }
  if (!valid || !same_key(keys, kstride, K, i, i + 1)) return;
  if (i > 0 && same_key(keys, kstride, K, i, i - 1)) return;
  if (i + 2 < E && same_key(keys, kstride, K, i + 1, i + 2)) return;
  long long pa = pay[i], pb = pay[i + 1];
  long long role_a = pa >> kRoleShift, role_b = pb >> kRoleShift;
  long long oid_a = pa & kOidMask, oid_b = pb & kOidMask;
  long long vert_a = oid_a >= C ? oid_a - C : oid_a;
  long long vert_b = oid_b >= C ? oid_b - C : oid_b;
  if (role_a == role_b || vert_a == vert_b) return;
  long long src = role_a == 0 ? oid_a : oid_b;
  long long dst = role_a == 0 ? oid_b : oid_a;
  succ[src] = dst;
  succ[dst >= C ? dst - C : dst + C] = src >= C ? src - C : src + C;
}

template <int L>
__global__ void junction_entries_kernel(
    const int64_t* __restrict__ solid, long long stride, long long N,
    long long n_local, int k, long long gbase, long long tot, int n_dev,
    int64_t* __restrict__ keys, long long kstride, int64_t* __restrict__ payload,
    int64_t* __restrict__ owner) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int m = k - 1;
  const int off = L - (m + 15) / 16;
  const int r = m % 16 == 0 ? 16 : m % 16;
  const bool folded = r < 16;
  uint32_t suf[L], pre[L], suf_rc[L], pre_rc[L];
#pragma unroll
  for (int j = 0; j < L; ++j) suf[j] = pre[j] = static_cast<uint32_t>(solid[j * stride + i]);
  bt::shr2<L>(pre);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (j < off) suf[j] = pre[j] = 0u;
    else if (j == off) suf[j] &= bt::top_mask(m);
  }
  bt::revcomp<L>(suf, m, suf_rc);
  bt::revcomp<L>(pre, m, pre_rc);
  bool sig = bt::less<L>(suf_rc, suf);
  bool tau = bt::less<L>(pre_rc, pre);
  bool suf_pal = (m % 2 == 0), pre_pal = (m % 2 == 0);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    suf_pal &= suf[j] == suf_rc[j];
    pre_pal &= pre[j] == pre_rc[j];
  }
  const bool valid = i < n_local;
  const long long g = gbase + i;
  // (side, strand, oid, role) of the four entries, as _local_succ_shard
  const uint32_t strand[4] = {suf_pal ? 0u : (sig ? 1u : 0u),
                              suf_pal ? 0u : (sig ? 0u : 1u),
                              pre_pal ? 0u : (tau ? 1u : 0u),
                              pre_pal ? 0u : (tau ? 0u : 1u)};
  const long long oid[4] = {g, g + tot, g, g + tot};
  const long long role[4] = {0, 1, 1, 0};
  for (int e = 0; e < 4; ++e) {
    const bool is_suf = e < 2;
    long long col = e * N + i;
    uint32_t h = bt::kHashSeed;
    int row = 0;
    if (!folded) {
      uint32_t v = valid ? strand[e] : bt::kSentinel;
      keys[col] = v;
      h = bt::hash_step(h, v);
      row = 1;
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (j < off) continue;
      uint32_t c = is_suf ? (sig ? suf_rc[j] : suf[j]) : (tau ? pre_rc[j] : pre[j]);
      if (folded && j == off) c |= strand[e] << (2 * r);
      uint32_t v = valid ? c : bt::kSentinel;
      keys[row * kstride + col] = v;
      h = bt::hash_step(h, v);
      ++row;
    }
    payload[col] = oid[e] | (role[e] << kRoleShift);
    owner[col] = h % static_cast<uint32_t>(n_dev);
  }
}

template <int L>
void launch_entries(const int64_t* solid, long long stride, long long N,
                    long long n_local, int k, long long gbase, long long tot,
                    int n_dev, int64_t* keys, long long kstride,
                    int64_t* payload, int64_t* owner, cudaStream_t s) {
  junction_entries_kernel<L><<<bt::blocks_for(N), bt::kThreads, 0, s>>>(
      solid, stride, N, n_local, k, gbase, tot, n_dev, keys, kstride, payload,
      owner);
}

__global__ void junction_edges_kernel(const int64_t* __restrict__ keys,
                                      long long kstride, int K,
                                      const int64_t* __restrict__ pay,
                                      long long E, long long tot,
                                      uint8_t* __restrict__ ok,
                                      int64_t* __restrict__ src,
                                      int64_t* __restrict__ dst) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= E) return;
  long long pa = pay[i], pb = i + 1 < E ? pay[i + 1] : 0;
  long long role_a = pa >> kRoleShift, role_b = pb >> kRoleShift;
  long long oid_a = pa & kOidMask, oid_b = pb & kOidMask;
  src[i] = role_a == 0 ? oid_a : oid_b;
  dst[i] = role_a == 0 ? oid_b : oid_a;
  bool head = i + 1 < E && static_cast<uint32_t>(keys[i]) != bt::kSentinel &&
              same_key(keys, kstride, K, i, i + 1) &&
              !(i > 0 && same_key(keys, kstride, K, i, i - 1)) &&
              !(i + 2 < E && same_key(keys, kstride, K, i + 1, i + 2));
  long long vert_a = oid_a >= tot ? oid_a - tot : oid_a;
  long long vert_b = oid_b >= tot ? oid_b - tot : oid_b;
  ok[i] = head && role_a != role_b && vert_a != vert_b;
}

}  // namespace

extern "C" int bt_junction_keys(const int64_t* solid, long long stride,
                                long long C, long long n_solid, int L, int k,
                                int hashed, int64_t* keys, long long kstride,
                                int64_t* payload, void* stream) {
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BT_DISPATCH_LANES(L, launch_keys, solid, stride, C, n_solid, k, hashed,
                    keys, kstride, payload, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_junction_pairs(const int64_t* keys, long long kstride,
                                 int K, const int64_t* pay, long long E,
                                 long long C, int hashed, int64_t* succ,
                                 void* stream) {
  if (E < 2) return 0;
  junction_pairs_kernel<<<bt::blocks_for(E), bt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      keys, kstride, K, pay, E, C, hashed, succ);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_junction_entries(const int64_t* solid, long long stride,
                                   long long N, long long n_local, int L, int k,
                                   long long gbase, long long tot, int n_dev,
                                   int64_t* keys, long long kstride,
                                   int64_t* payload, int64_t* owner,
                                   void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BT_DISPATCH_LANES(L, launch_entries, solid, stride, N, n_local, k, gbase,
                    tot, n_dev, keys, kstride, payload, owner, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_junction_edges(const int64_t* keys, long long kstride, int K,
                                 const int64_t* pay, long long E,
                                 long long tot, uint8_t* ok, int64_t* src,
                                 int64_t* dst, void* stream) {
  if (E == 0) return 0;
  junction_edges_kernel<<<bt::blocks_for(E), bt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      keys, kstride, K, pay, E, tot, ok, src, dst);
  return static_cast<int>(cudaGetLastError());
}
