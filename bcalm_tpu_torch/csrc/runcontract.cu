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
// run_contract, one thread per entry t of [0, C) (and per slot of
// [R, R_cap)): a head t is run r = rid[t] with hpos[r] = t, epos[r] =
// end_pos[t], rlen = epos - t + 1; its contracted successors are the
// translated successors of the run's + tail (succ[epos]) and - tail
// (succ[t + C]); a slot r >= R is padding (hpos = C-1 as JAX's sort pads,
// epos = end_pos[C-1], no successor, not valid, length 0).
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

__global__ void run_contract_kernel(
    const int64_t* __restrict__ succ, long long C, const uint8_t* __restrict__ is_head,
    const int64_t* __restrict__ rid, const int64_t* __restrict__ end_pos,
    long long R, long long R_cap, long long n_threads, int64_t* __restrict__ hpos,
    int64_t* __restrict__ epos, int64_t* __restrict__ csucc,
    uint8_t* __restrict__ cvalid, int64_t* __restrict__ wlen2) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  const long long M = 2 * C;
  if (t < C && is_head[t]) {
    long long r = rid[t];
    if (r >= 0 && r < R && r < R_cap) {
      long long e = end_pos[t];
      hpos[r] = t;
      epos[r] = e;
      long long w[2] = {succ[e < 0 ? 0 : (e >= C ? C - 1 : e)],
                        succ[t + C < M ? t + C : M - 1]};
      for (int side = 0; side < 2; ++side) {
        long long x = w[side];
        long long xv = x >= C ? x - C : x;
        long long rt = rid[xv < 0 ? 0 : (xv >= C ? C - 1 : xv)];
        csucc[r + side * R_cap] = x >= 0 ? (x >= C ? rt + R_cap : rt) : -1;
        cvalid[r + side * R_cap] = 1;
        wlen2[r + side * R_cap] = e - t + 1;
      }
    }
  }
  if (t >= R && t < R_cap) {
    hpos[t] = C - 1;
    epos[t] = end_pos[C - 1];
    for (int side = 0; side < 2; ++side) {
      csucc[t + side * R_cap] = -1;
      cvalid[t + side * R_cap] = 0;
      wlen2[t + side * R_cap] = 0;
    }
  }
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
  long long n = C > R_cap ? C : R_cap;
  run_contract_kernel<<<bt::blocks_for(n), bt::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      succ, C, is_head, rid, end_pos, R, R_cap, n, hpos, epos, csucc, cvalid,
      wlen2);
  return static_cast<int>(cudaGetLastError());
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
