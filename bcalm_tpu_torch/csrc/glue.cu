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
