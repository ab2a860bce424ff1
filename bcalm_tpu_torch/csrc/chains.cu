// K4 jump_round: one pointer-doubling round over the packed chain state.
//
// Replaces one step of bcalm_tpu/ops/chains.py:_phase with no fixpoints
// (the plain doubling, chains.py:310-316) and its _composeF.  State rows
// are (ptr, dist|flags, mn, dmn), int64 here; flags sit in bits 28-30 of
// the dist column exactly as in the JAX package (SETTLED, FIX, ROOTED)
// and dist saturates at _DMASK.  One thread per node reads its row and
// its ancestor's row, composes the two spans, writes the new row to a
// second buffer and raises `changed` when the row moved.  The host runs
// rounds until `changed` stays 0 or the _max_rounds(M)+1 cap, which
// bounds cycles (their ptr never settles).
//
// Bound: memory latency.  Each round reads 32 bytes of the node's own row
// (coalesced) and 32 bytes of a random ancestor row, and writes 32; rooted
// rows are copied without the random read.
#include "common.cuh"

namespace {

constexpr long long kSettled = 1ll << 28;
constexpr long long kFix = 1ll << 29;
constexpr long long kRooted = 1ll << 30;
constexpr long long kDmask = (1ll << 28) - 1;

__global__ void jump_round_kernel(const int64_t* __restrict__ Q,
                                  int64_t* __restrict__ Qn, long long M,
                                  int* __restrict__ changed) {
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= M) return;
  const int64_t* q = Q + 4 * v;
  int64_t* out = Qn + 4 * v;
  long long qd = q[1];
  if (qd & kRooted) {  // rooted rows absorb
    out[0] = q[0]; out[1] = qd; out[2] = q[2]; out[3] = q[3];
    return;
  }
  long long p = q[0] < 0 ? 0 : (q[0] >= M ? M - 1 : q[0]);
  const int64_t* a = Q + 4 * p;
  long long ad = a[1];
  long long dq = qd & kDmask;
  long long dist = dq + (ad & kDmask);
  if (dist > kDmask) dist = kDmask;
  long long flg = ((qd | ad) & kRooted) | ((ad & (kFix | kRooted)) ? kSettled : 0);
  bool better = a[2] < q[2];
  long long n0 = a[0], n1 = dist | flg;
  long long n2 = better ? a[2] : q[2];
  long long n3 = better ? dq + a[3] : q[3];
  out[0] = n0; out[1] = n1; out[2] = n2; out[3] = n3;
  if (n0 != q[0] || n1 != qd || n2 != q[2] || n3 != q[3]) *changed = 1;
}

}  // namespace

extern "C" int bt_jump_round(const int64_t* Q, int64_t* Qn, long long M,
                             int* changed, void* stream) {
  if (M == 0) return 0;
  jump_round_kernel<<<bt::blocks_for(M), bt::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(Q, Qn, M, changed);
  return static_cast<int>(cudaGetLastError());
}
