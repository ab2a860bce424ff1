// K12 run_contract + run_broadcast: the consecutive-run contraction of a
// locality-ordered successor graph, and the broadcast of the contracted
// chains back over the run members.
//
// Replaces bcalm_tpu/ops/runchains.py:run_decompose's contraction (:204-223,
// a sort of the head flags selects the representatives), its start
// translation (:230-234) and its broadcast (:236-260, two scatters and
// the log-doubling fills of _ffill :143).  Both kernels read K8's run
// structure (is_head, rid, head_pos, end_pos) instead:
//
// run_contract, work per run: a head t is run r with hpos[r] = t, epos[r]
// = end_pos[t], rlen = epos - t + 1; its contracted successors are the
// translated successors of the run's + tail (succ[epos]) and - tail
// (succ[t + C]); a slot r >= R is padding (hpos = C-1 as JAX's sort pads,
// epos = end_pos[C-1], no successor, not valid, length 0).  is_head, rid
// and end_pos are K8's outputs for one successor array.  Each warp reads
// a span of is_head with 16-byte loads and lists the span's heads in
// shared memory (__popc of each lane's set bytes, a warp scan of the
// counts); its lanes then take the listed heads, 32 (or 32 kIlp) at a
// time, so many heads' load chains run at once.  A head's run id is the
// span's carry (rid and is_head at its first entry) plus its place in the
// list; its run ends just before the next listed head (heads and tails
// alternate over the solid entries), the span's last run where the run
// at the span's last entry ends (both loaded with is_head), so a head's
// chain is two dependent loads: succ at its run's two ends, then rid at
// the two successors.  A sparse call (phase 3: 148,391 runs over 2^23
// entries) takes spans of 1024 entries, so the grid fits in one wave of
// the card's resident warps; a dense one spans of 128 entries and four
// heads a lane at once.  The padding slots [R, R_cap) take blocks of
// their own after the head blocks, one thread per slot.
//
// run_broadcast, one thread per entry t of [0, C) (and per contracted
// unitig slot of [0, 2 R_cap)): a member t < n_solid of run r = rid[t]
// takes uid cuid[r] and rank crank[r] + t - head_pos[t] on the + strand,
// cuid[R_cap + r] and crank[R_cap + r] + end_pos[t] - t on the - strand;
// a unitig's contracted start becomes an original oriented id (hpos of
// its run, or C + epos on the - strand).  No host sync: R and R_cap come
// from the caller, which read R to size R_cap.  Bound: memory, a few
// gathers per entry.
#include "common.cuh"

namespace {

constexpr int kWarps = bt::kThreads / 32;
// Above this many heads in 1024 entries (on average) a call takes the
// dense instantiation: short spans and several heads a lane at once.
constexpr long long kDenseHeads = 64;

// kLaneBytes: is_head bytes a lane reads (4, 16 or 32); kIlp: heads a
// lane takes at once, each level of loads issued for all of them before
// the next level, which depends on it.
template <int kLaneBytes, int kIlp>
__global__ void __launch_bounds__(bt::kThreads) run_contract_kernel(
    const int64_t* __restrict__ succ, long long C, const uint8_t* __restrict__ is_head,
    const int64_t* __restrict__ rid, const int64_t* __restrict__ end_pos,
    long long R, long long R_cap, long long head_blocks, int64_t* __restrict__ hpos,
    int64_t* __restrict__ epos, int64_t* __restrict__ csucc,
    uint8_t* __restrict__ cvalid, int64_t* __restrict__ wlen2) {
  constexpr int kSpan = 32 * kLaneBytes;  // is_head bytes a warp scans
  constexpr int kWords = kLaneBytes / 4;
  static_assert(kLaneBytes == 4 || kLaneBytes % 16 == 0, "whole 16-byte loads");
  __shared__ short s_list[kWarps][kSpan];
  if (blockIdx.x >= head_blocks) {
    const long long r = R + (blockIdx.x - head_blocks) * bt::kThreads + threadIdx.x;
    if (r < R_cap) {
      hpos[r] = C - 1;
      epos[r] = end_pos[C - 1];
      for (int side = 0; side < 2; ++side) {
        csucc[r + side * R_cap] = -1;
        cvalid[r + side * R_cap] = 0;
        wlen2[r + side * R_cap] = 0;
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long s0 = (static_cast<long long>(blockIdx.x) * kWarps + w) * kSpan;
  if (s0 >= C) return;  // the whole warp
  const long long s_end = (s0 + kSpan < C ? s0 + kSpan : C) - 1;
  // lane 0: the heads before the span (rid and is_head of its first
  // entry); lane 1: the end of the run at the span's last entry
  long long pre = 0;
  if (lane == 0) pre = rid[s0] + 1 - (is_head[s0] != 0);
  if (lane == 1) pre = end_pos[s_end];
  const long long p = s0 + kLaneBytes * lane;
  uint32_t word[kWords] = {};
  if ((reinterpret_cast<uintptr_t>(is_head) & 15) == 0 && p + kLaneBytes <= C) {
    if constexpr (kWords == 1) {
      word[0] = *reinterpret_cast<const uint32_t*>(is_head + p);
    } else {
#pragma unroll
      for (int x = 0; x < kWords; x += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(is_head + p + 4 * x);
        word[x] = v.x;
        word[x + 1] = v.y;
        word[x + 2] = v.z;
        word[x + 3] = v.w;
      }
    }
  } else {
    for (int b = 0; b < kLaneBytes && p + b < C; ++b) {
      word[b >> 2] |= static_cast<uint32_t>(is_head[p + b] != 0) << (8 * (b & 3));
    }
  }
  int cnt = 0;
#pragma unroll
  for (int x = 0; x < kWords; ++x) {
    word[x] &= 0x01010101u;
    cnt += __popc(word[x]);
  }
  int inc = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += y;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, inc, 31);
  const long long r0 = __shfl_sync(0xFFFFFFFFu, pre, 0);
  const long long last_end = __shfl_sync(0xFFFFFFFFu, pre, 1);
  int at = inc - cnt;
#pragma unroll
  for (int x = 0; x < kWords; ++x) {
    for (uint32_t m = word[x]; m; m &= m - 1) {
      s_list[w][at++] = static_cast<short>(kLaneBytes * lane + 4 * x + (__ffs(m) - 1) / 8);
    }
  }
  __syncwarp();
  for (int j0 = 0; j0 < total; j0 += 32 * kIlp) {
    long long t[kIlp], r[kIlp], e[kIlp], xm[kIlp], xp[kIlp];
    bool ok[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int j = j0 + 32 * u + lane;
      ok[u] = j < total;
      t[u] = s0 + s_list[w][ok[u] ? j : 0];
      r[u] = r0 + j;
      ok[u] = ok[u] && r[u] >= 0 && r[u] < R && r[u] < R_cap;
      // a run ends just before the next head; the span's last run ends
      // where the run at the span's last entry does, unless that is C
      // (past the solid entries, or a last run with no tail): then its
      // own end is read
      e[u] = j + 1 < total ? s0 + s_list[w][j + 1] - 1 : last_end;
      xm[u] = xp[u] = -1;
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      if (ok[u] && e[u] == C) e[u] = end_pos[t[u]];
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      if (ok[u]) {
        xm[u] = succ[t[u] + C];
        xp[u] = succ[e[u] < 0 ? 0 : (e[u] >= C ? C - 1 : e[u])];
      }
    }
    long long rt[kIlp][2];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const long long x[2] = {xp[u], xm[u]};
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const long long xv = x[side] >= C ? x[side] - C : x[side];
        rt[u][side] = ok[u] && x[side] >= 0 ? rid[xv >= C ? C - 1 : xv] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      if (!ok[u]) continue;
      hpos[r[u]] = t[u];
      epos[r[u]] = e[u];
      const long long x[2] = {xp[u], xm[u]};
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        csucc[r[u] + side * R_cap] =
            x[side] >= 0 ? (x[side] >= C ? rt[u][side] + R_cap : rt[u][side]) : -1;
        cvalid[r[u] + side * R_cap] = 1;
        wlen2[r[u] + side * R_cap] = e[u] - t[u] + 1;
      }
    }
  }
}

template <int kLaneBytes, int kIlp>
int launch_contract(const int64_t* succ, long long C, const uint8_t* is_head,
                    const int64_t* rid, const int64_t* end_pos, long long R,
                    long long R_cap, int64_t* hpos, int64_t* epos,
                    int64_t* csucc, uint8_t* cvalid, int64_t* wlen2,
                    cudaStream_t stream) {
  constexpr long long kBlockSpan = 32LL * kLaneBytes * kWarps;
  const long long head_blocks = (C + kBlockSpan - 1) / kBlockSpan;
  const long long grid = head_blocks + bt::blocks_for(R_cap - R);
  run_contract_kernel<kLaneBytes, kIlp>
      <<<static_cast<unsigned int>(grid), bt::kThreads, 0, stream>>>(
          succ, C, is_head, rid, end_pos, R, R_cap, head_blocks, hpos, epos,
          csucc, cvalid, wlen2);
  return static_cast<int>(cudaGetLastError());
}

__global__ void run_broadcast_kernel(
    const int64_t* __restrict__ cuid, const int64_t* __restrict__ crank,
    const int64_t* __restrict__ cstart, const int64_t* __restrict__ rid,
    const int64_t* __restrict__ head_pos, const int64_t* __restrict__ end_pos,
    const int64_t* __restrict__ hpos, const int64_t* __restrict__ epos,
    long long n_solid, long long C, long long R_cap, long long n_threads,
    int64_t* __restrict__ uid, int64_t* __restrict__ rank,
    int64_t* __restrict__ start_oid) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  if (t < C) {
    long long up = -1, um = -1, rp = 0, rm = 0;
    if (t < n_solid) {
      long long r = rid[t];
      up = cuid[r];
      um = cuid[R_cap + r];
      rp = crank[r] + t - head_pos[t];
      rm = crank[R_cap + r] + end_pos[t] - t;
    }
    uid[t] = up;
    rank[t] = up >= 0 ? rp : 0;
    uid[C + t] = um;
    rank[C + t] = um >= 0 ? rm : 0;
  }
  if (t < 2 * R_cap) {
    long long cs = cstart[t];
    long long csv = cs >= R_cap ? cs - R_cap : cs;
    csv = csv < 0 ? 0 : (csv >= R_cap ? R_cap - 1 : csv);
    start_oid[t] = cs >= R_cap ? C + epos[csv] : hpos[csv];
  }
}

}  // namespace

extern "C" int bt_run_contract(const int64_t* succ, long long C,
                               const uint8_t* is_head, const int64_t* rid,
                               const int64_t* end_pos, long long R,
                               long long R_cap, int64_t* hpos, int64_t* epos,
                               int64_t* csucc, uint8_t* cvalid, int64_t* wlen2,
                               void* stream) {
  if (C == 0 || R_cap == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R * 1024 > kDenseHeads * C) {
    return launch_contract<4, 4>(succ, C, is_head, rid, end_pos, R, R_cap,
                                 hpos, epos, csucc, cvalid, wlen2, s);
  }
  return launch_contract<32, 1>(succ, C, is_head, rid, end_pos, R, R_cap,
                                hpos, epos, csucc, cvalid, wlen2, s);
}

extern "C" int bt_run_broadcast(const int64_t* cuid, const int64_t* crank,
                                const int64_t* cstart, const int64_t* rid,
                                const int64_t* head_pos,
                                const int64_t* end_pos, const int64_t* hpos,
                                const int64_t* epos, long long n_solid,
                                long long C, long long R_cap, int64_t* uid,
                                int64_t* rank, int64_t* start_oid,
                                void* stream) {
  if (C == 0 || R_cap == 0) return 0;
  long long n = C > 2 * R_cap ? C : 2 * R_cap;
  run_broadcast_kernel<<<bt::blocks_for(n), bt::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      cuid, crank, cstart, rid, head_pos, end_pos, hpos, epos, n_solid, C,
      R_cap, n, uid, rank, start_oid);
  return static_cast<int>(cudaGetLastError());
}
