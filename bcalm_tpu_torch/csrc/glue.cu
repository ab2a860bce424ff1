// K16 glue_compose: one round of the sharded weighted doubling, in place.
//
// Replaces the compose step of bcalm_tpu/parallel/distcompact.py:_glue_shard
// (:303-324, with bcalm_tpu/ops/chains.py:_composeF :258).  In the sharded
// loop a rank's ancestor rows arrive from their owners through the
// request/response exchange; the kernel reads them where the exchange
// left them, as the (4, W) response `back`, row v's at column slots[v]
// (clamped to W - 1, as JAX clips; a dropped query is counted by the
// router and makes the caller grow W).  Each thread reads only its own
// row and its own response, so the state is updated in place: a row that
// needs no step (need[v] 0: not valid, or ROOTED, which absorbs) is
// neither read nor written; a row that needs one is composed with its
// ancestor (compose.cuh, K4's code) and written back when it moved.  The
// same thread writes the next round's routing for its row: need (valid
// and not ROOTED), ptr, and the owner of ptr (n_dev where no step is
// needed), so no pass over the whole state runs between two rounds.  The
// rows that need no step keep the values they have (they never need one
// again).  `changed` gets one store a block, after a vote, when a row of
// the block moved (its sum over the ranks decides the next round).
//
// Bound: memory.  need is read for every row (1 byte); a row that needs a
// step reads its slot (8 bytes), its row (32) and its four response words
// (32; in slot order, so neighbouring rows read neighbouring columns
// where their queries went to one owner), and writes need, ptr and owner
// (17) and, when it moved, its row (32).
//
// K21 glue_answer: the owners' answer to one request/response exchange.
//
// Replaces the answers computed inside
// bcalm_tpu/parallel/distcompact.py:_glue_shard: a doubling round's rows
// (:313-318, jnp.take(Q, clip(gq_local(v)))), the contracted successors'
// run lookup (:258-264) and the chain starts' uid lookup (:378-381).  The
// received values (8 bytes a slot, as K15 and the exchange leave them:
// zero where the slot is empty) and their validity give, for every slot
// of the exchange, the answer in the layout the response sends: (C, S)
// channel-major and contiguous, S = n_dev * qcap, so no transpose or copy
// runs before the all_to_all.  A thread a slot; a warp reads its 32
// values (and validity) as coalesced words and writes each channel as 32
// consecutive words.  Modes:
//   rows (C = 4): Q's row clip(gq_local(v), 0, T-1) at every slot, the
//     empty ones included, as JAX's take does (an empty slot holds 0, so
//     it answers row gq_local(0); a dropped query reads the last column).
//     Every empty slot asking the same row, a block loads that row once
//     into shared memory and such a slot stores it from there; any other
//     slot reads its row as two 16-byte loads (one 32-byte sector).
//   run (C = 2): where valid, (rid_base + rid[lv], end[lv] - head[lv] + 1),
//     lv = clip(v - base, 0, T-1); (-1, 0) elsewhere, with no read.
//   uid (C = 1): where valid, uid[clip(gq_local(v), 0, T-1)]; -1 elsewhere.
//
// Bound: memory.  Each slot's value (8 bytes; run and uid also its
// validity byte) read and its C words written; each valid query's table
// sectors (rows: one 32-byte row; run: three 8-byte words in three
// tables; uid: one word).  At a -devices round of world size 1 only ~1%
// of the 2^24 slots are valid, so the writes set the pace.
#include "common.cuh"
#include "compose.cuh"

namespace {

__global__ void __launch_bounds__(bt::kThreads)
glue_compose_kernel(longlong2* __restrict__ Q, const int64_t* __restrict__ back,
                    long long W, const int64_t* __restrict__ slots,
                    uint8_t* __restrict__ need, long long M,
                    int* __restrict__ changed, int64_t* __restrict__ ptr,
                    int64_t* __restrict__ owner, long long run_cap,
                    long long n_dev) {
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool moved = false;
  if (v < M && need[v]) {
    // the own row with plain loads (it is written in this launch), the
    // slot and then the four response words, issued together
    const longlong2 a = Q[2 * v], b = Q[2 * v + 1];
    long long s = __ldg(reinterpret_cast<const long long*>(slots) + v);
    s = s < 0 ? 0 : (s >= W ? W - 1 : s);
    const int64_t anc[4] = {__ldg(back + s), __ldg(back + W + s),
                            __ldg(back + 2 * W + s), __ldg(back + 3 * W + s)};
    const int64_t q[4] = {a.x, a.y, b.x, b.y};
    int64_t out[4];
    moved = bt::compose_row(q, anc, out);
    if (moved) {
      __stcs(Q + 2 * v, make_longlong2(out[0], out[1]));
      __stcs(Q + 2 * v + 1, make_longlong2(out[2], out[3]));
    }
    // the next round's routing (ptrs of rows that need a step are >= 0)
    const long long c_tot = n_dev * run_cap;
    const bool next = !(out[1] & bt::kRooted);
    const long long p = out[0];
    need[v] = next;
    ptr[v] = p;
    owner[v] = next ? (p >= c_tot ? p - c_tot : p) / run_cap : n_dev;
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0) *changed = 1;
}

}  // namespace

// route: (2, M), the ptr column, then each row's owner.
extern "C" int bt_glue_compose(int64_t* Q, const int64_t* back, long long W,
                               const int64_t* slots, uint8_t* need, long long M,
                               int* changed, int64_t* route, long long run_cap,
                               long long n_dev, void* stream) {
  if (M == 0) return 0;
  glue_compose_kernel<<<bt::blocks_for(M), bt::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<longlong2*>(Q), back, W, slots, need, M, changed, route,
      route + M, run_cap, n_dev);
  return static_cast<int>(cudaGetLastError());
}

namespace {

enum GlueMode : int { kAnswerRows = 0, kAnswerRun = 1, kAnswerUid = 2 };

// gq_local: node g's row at its owner (the plus strand's run_cap rows,
// then the minus strand's), clipped to [0, T); the remainder floors, as
// torch's and JAX's do.
__device__ __forceinline__ long long gq_row(long long g, long long run_cap,
                                            long long c_tot, long long T) {
  const bool minus = g >= c_tot;
  long long r = (minus ? g - c_tot : g) % run_cap;
  if (r < 0) r += run_cap;
  r += minus ? run_cap : 0;
  return r < 0 ? 0 : (r >= T ? T - 1 : r);
}

template <int kMode>
__global__ void __launch_bounds__(bt::kThreads)
glue_answer_kernel(const int64_t* __restrict__ vals,
                   const uint8_t* __restrict__ valid, long long S,
                   const int64_t* __restrict__ t0,
                   const int64_t* __restrict__ t1,
                   const int64_t* __restrict__ t2, long long T,
                   long long run_cap, long long c_tot, long long base,
                   long long rid_base, long long* __restrict__ out) {
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (kMode == kAnswerRows) {
    __shared__ longlong2 row0[2];
    const long long loc0 = gq_row(0, run_cap, c_tot, T);
    const longlong2* Q = reinterpret_cast<const longlong2*>(t0);
    if (threadIdx.x < 2) row0[threadIdx.x] = __ldg(Q + 2 * loc0 + threadIdx.x);
    __syncthreads();
    if (s >= S) return;
    const long long loc = gq_row(__ldg(vals + s), run_cap, c_tot, T);
    longlong2 a, b;
    if (loc == loc0) {
      a = row0[0];
      b = row0[1];
    } else {
      a = __ldg(Q + 2 * loc);
      b = __ldg(Q + 2 * loc + 1);
    }
    __stcs(out + s, a.x);
    __stcs(out + S + s, a.y);
    __stcs(out + 2 * S + s, b.x);
    __stcs(out + 3 * S + s, b.y);
  } else {
    if (s >= S) return;
    const bool ok = valid[s] != 0;
    if constexpr (kMode == kAnswerRun) {
      long long rid = -1, w = 0;
      if (ok) {
        long long lv = __ldg(vals + s) - base;
        lv = lv < 0 ? 0 : (lv >= T ? T - 1 : lv);
        const long long r = __ldg(t0 + lv), h = __ldg(t1 + lv), e = __ldg(t2 + lv);
        rid = rid_base + r;
        w = e - h + 1;
      }
      __stcs(out + s, rid);
      __stcs(out + S + s, w);
    } else {
      long long u = -1;
      if (ok) u = __ldg(t0 + gq_row(__ldg(vals + s), run_cap, c_tot, T));
      __stcs(out + s, u);
    }
  }
}

}  // namespace

// mode 0 rows (t0: the (T, 4) state, 16-byte aligned), 1 run (t0, t1, t2:
// rid, head and end of the T local slots), 2 uid (t0: T uids); out (C, S).
extern "C" int bt_glue_answer(int mode, const int64_t* vals,
                              const uint8_t* valid, long long S,
                              const int64_t* t0, const int64_t* t1,
                              const int64_t* t2, long long T,
                              long long run_cap, long long c_tot,
                              long long base, long long rid_base,
                              int64_t* out, void* stream) {
  if (S == 0) return 0;
  if (T < 1 || run_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int grid = bt::blocks_for(S);
  long long* o = reinterpret_cast<long long*>(out);
  switch (mode) {
    case kAnswerRows:
      glue_answer_kernel<kAnswerRows><<<grid, bt::kThreads, 0, st>>>(
          vals, valid, S, t0, t1, t2, T, run_cap, c_tot, base, rid_base, o);
      break;
    case kAnswerRun:
      glue_answer_kernel<kAnswerRun><<<grid, bt::kThreads, 0, st>>>(
          vals, valid, S, t0, t1, t2, T, run_cap, c_tot, base, rid_base, o);
      break;
    case kAnswerUid:
      glue_answer_kernel<kAnswerUid><<<grid, bt::kThreads, 0, st>>>(
          vals, valid, S, t0, t1, t2, T, run_cap, c_tot, base, rid_base, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
