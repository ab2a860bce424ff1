// K16 glue_compose: one round of the sharded weighted doubling.
//
// Replaces the compose step of bcalm_tpu/parallel/distcompact.py:_glue_shard
// (:303-324, with bcalm_tpu/ops/chains.py:_composeF :258).  In the sharded
// loop a rank's ancestor rows arrive from their owners through the
// request/response exchange, so they come as a second (M, 4) array instead
// of a gather from the state itself (K4).  One thread per row: a row that
// needs a step (valid and not ROOTED) is composed with its fetched
// ancestor row (compose.cuh, K4's code), any other row is copied; `changed`
// goes to 1 when a row moved (its sum over the ranks decides the next
// round).
//
// Bound: memory.  32 bytes of the row and 32 of the ancestor are read
// (both coalesced: the response is already in row order), 32 written.
#include "common.cuh"
#include "compose.cuh"

namespace {

__global__ void glue_compose_kernel(const int64_t* __restrict__ Q,
                                    const int64_t* __restrict__ anc,
                                    const uint8_t* __restrict__ need,
                                    long long M, int64_t* __restrict__ Qn,
                                    int* __restrict__ changed) {
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= M) return;
  const int64_t* q = Q + 4 * v;
  int64_t* out = Qn + 4 * v;
  if (!need[v]) {
    out[0] = q[0]; out[1] = q[1]; out[2] = q[2]; out[3] = q[3];
    return;
  }
  if (bt::compose_row(q, anc + 4 * v, out)) *changed = 1;
}

}  // namespace

extern "C" int bt_glue_compose(const int64_t* Q, const int64_t* anc,
                               const uint8_t* need, long long M, int64_t* Qn,
                               int* changed, void* stream) {
  if (M == 0) return 0;
  glue_compose_kernel<<<bt::blocks_for(M), bt::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      Q, anc, need, M, Qn, changed);
  return static_cast<int>(cudaGetLastError());
}
