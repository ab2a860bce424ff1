// K4 jump_round: one pointer-doubling round over the packed chain state.
//
// Replaces one step of bcalm_tpu/ops/chains.py:_phase with no fixpoints
// (the plain doubling, chains.py:310-316) and its _composeF.  State rows
// are (ptr, dist|flags, mn, dmn), int64 here; flags sit in bits 28-30 of
// the dist column exactly as in the JAX package (SETTLED, FIX, ROOTED)
// and dist saturates at _DMASK.  One thread per node reads its row and
// its ancestor's row, composes the two spans (compose.cuh, shared with
// K16), writes the new row to a
// second buffer and raises `changed` when the row moved.  The host runs
// rounds until `changed` stays 0 or the _max_rounds(M)+1 cap, which
// bounds cycles (their ptr never settles).
//
// Bound: memory latency.  Each round reads 32 bytes of the node's own row
// (coalesced) and 32 bytes of a random ancestor row, and writes 32; rooted
// rows are copied without the random read.
#include "common.cuh"
#include "compose.cuh"

namespace {

__global__ void jump_round_kernel(const int64_t* __restrict__ Q,
                                  int64_t* __restrict__ Qn, long long M,
                                  int* __restrict__ changed) {
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= M) return;
  const int64_t* q = Q + 4 * v;
  long long p = q[0] < 0 ? 0 : (q[0] >= M ? M - 1 : q[0]);
  if (bt::compose_row(q, Q + 4 * p, Qn + 4 * v)) *changed = 1;
}

}  // namespace

extern "C" int bt_jump_round(const int64_t* Q, int64_t* Qn, long long M,
                             int* changed, void* stream) {
  if (M == 0) return 0;
  jump_round_kernel<<<bt::blocks_for(M), bt::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(Q, Qn, M, changed);
  return static_cast<int>(cudaGetLastError());
}
