// K11 spell_unitigs: unitig base codes and member-ordered counts on the
// device.
//
// Replaces bcalm_tpu/engine.py:_assemble_dev (a cumsum, two scatters and
// a sort of the 2C oriented nodes by (uid, rank) on the TPU).  With
// run_start(u) = the exclusive prefix of the unitig lengths (scan.cuh),
// unitig u's bases start at offset(u) = run_start(u) + (k-1) u:
//   members: every oriented node o with uid u >= 0 writes the last base of
//     its oriented k-mer at offset(u) + k-1 + rank(o), and its count at
//     run_start(u) + rank(o);
//   starts:  each unitig's start k-mer (start_oid, reverse-complemented on
//     the - strand) writes its k bases at offset(u) .. offset(u) + k-1,
//     after the members (the two agree where they meet).
// A unitig's ranks are 0 .. length-1, each once, so the member writes of
// the counts are the (uid, rank) order that JAX sorts for, without the
// sort.  Writes past the outputs are dropped, as JAX's mode="drop" does.
// Bound: memory; per member two gathers of the solid table and two
// scattered writes.
#include "scan.cuh"

namespace {

struct Length {
  const int64_t* length;
  __device__ long long operator()(long long u) const { return length[u]; }
};

struct RunStart {
  int64_t* run_start;
  __device__ void operator()(long long u, long long excl, long long) const {
    run_start[u] = excl;
  }
};

__device__ __forceinline__ int base_at(const int64_t* solid, long long stride,
                                       long long v, int j, int r) {
  int lane, shift;
  if (j < r) {
    lane = 0;
    shift = 2 * (r - 1 - j);
  } else {
    int t = j - r;
    lane = 1 + t / 16;
    shift = 2 * (15 - t % 16);
  }
  return static_cast<int>((static_cast<uint32_t>(solid[lane * stride + v]) >> shift) & 3u);
}

__global__ void spell_members(const int64_t* __restrict__ solid, long long stride,
                              int L, long long C, const int64_t* __restrict__ counts,
                              const int64_t* __restrict__ uid,
                              const int64_t* __restrict__ rank, long long U,
                              const int64_t* __restrict__ run_start, int k,
                              uint8_t* __restrict__ codes, long long total,
                              int64_t* __restrict__ mcounts, long long n_members) {
  long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= 2 * C) return;
  long long u = uid[o];
  if (u < 0 || u >= U) return;
  bool minus = o >= C;
  long long v = minus ? o - C : o;
  int r = k % 16 == 0 ? 16 : k % 16;
  int b = minus ? base_at(solid, stride, v, 0, r) ^ 2
                : static_cast<int>(static_cast<uint32_t>(solid[(L - 1) * stride + v]) & 3u);
  long long m = run_start[u] + rank[o];
  long long d = m + static_cast<long long>(k - 1) * u + (k - 1);
  if (d >= 0 && d < total) codes[d] = static_cast<uint8_t>(b);
  if (m >= 0 && m < n_members) mcounts[m] = counts[v];
}

__global__ void spell_starts(const int64_t* __restrict__ solid, long long stride,
                             long long C, const int64_t* __restrict__ start_oid,
                             long long U, const int64_t* __restrict__ run_start,
                             int k, uint8_t* __restrict__ codes, long long total) {
  long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= U) return;
  long long so = start_oid[u];
  bool minus = so >= C;
  long long v = minus ? so - C : so;
  v = v < 0 ? 0 : (v >= C ? C - 1 : v);
  int r = k % 16 == 0 ? 16 : k % 16;
  long long base = run_start[u] + static_cast<long long>(k - 1) * u;
  for (int j = 0; j < k; ++j) {
    int b = minus ? base_at(solid, stride, v, k - 1 - j, r) ^ 2
                  : base_at(solid, stride, v, j, r);
    long long d = base + j;
    if (d >= 0 && d < total) codes[d] = static_cast<uint8_t>(b);
  }
}

}  // namespace

extern "C" int bt_spell_unitigs(const int64_t* solid, long long stride, int L,
                                long long C, const int64_t* counts,
                                const int64_t* uid, const int64_t* rank,
                                const int64_t* length,
                                const int64_t* start_oid, long long U, int k,
                                long long* scratch, int64_t* run_start,
                                uint8_t* codes, long long total,
                                int64_t* mcounts, long long n_members,
                                void* stream) {
  if (L < 1 || L > bt::kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  if (U == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = exclusive_sum(Length{length}, RunStart{run_start}, U, scratch,
                         nullptr, s);
  if (rc != 0) return rc;
  spell_members<<<bt::blocks_for(2 * C), bt::kThreads, 0, s>>>(
      solid, stride, L, C, counts, uid, rank, U, run_start, k, codes, total,
      mcounts, n_members);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spell_starts<<<bt::blocks_for(U), bt::kThreads, 0, s>>>(
      solid, stride, C, start_oid, U, run_start, k, codes, total);
  return static_cast<int>(cudaGetLastError());
}
