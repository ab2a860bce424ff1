// K10 chain_finish: chain starts, ranks, cycle breaks, mirror dedup and the
// per-unitig arrays from a converged pointer-doubling state.
//
// Replaces bcalm_tpu/ops/chains.py:finish_fast (and the has-predecessor
// test of :107 build_pred, read here as pred[i] >= 0).  Per oriented node
// i of M = 2N, from the packed state row (ptr, dist|flags, mn, dmn):
//   in_cycle = valid && !rooted,   break = in_cycle && mn == i,
//   start = in_cycle ? mn : ptr,   rank = in_cycle ? dmn : dist,
//   is_start = valid && (pred < 0 || break),
//   is_end = valid && (succ < 0 || (in_cycle && succ == mn)).
// Launch 1 (ends): each end writes end_of[start] = i and
// len_at_start[start] = rank + w(i) (w = wlen[i], or 1); a chain has one
// end, so the destinations are unique.  Launches 2-4 (scan.cuh): keep =
// is_start && end_of[i] >= 0 && i < mirror start; the exclusive prefix of
// keep is the unitig id, in index order of the kept starts, and the apply
// step writes ks[i] (the id, or -1) and, for a kept start, start_oid,
// length and circular at its id.  Launch 5 (ids): uid[i] = ks[start]
// where valid, rank[i] = rank where uid >= 0.
// Bound: memory; each node reads its 32-byte state row three times and
// gathers end_of/ks at its start.
#include "scan.cuh"

namespace {

constexpr long long kRooted = 1LL << 30;
constexpr long long kDmask = (1LL << 28) - 1;
constexpr long long kLenMask = (1LL << 30) - 1;

struct Node {
  bool valid, in_cycle, brk, is_start, is_end;
  long long start, rank, mn;
};

struct Graph {
  const int64_t* succ;
  const int64_t* pred;
  const uint8_t* valid;
  const int64_t* state;
  long long M;

  __device__ Node node(long long i) const {
    Node n;
    n.valid = valid[i] != 0;
    long long s = n.valid ? succ[i] : -1;
    const int64_t* q = state + 4 * i;
    long long ptr = q[0], dsf = q[1], mn = q[2], dmn = q[3];
    bool rooted = (dsf & kRooted) != 0;
    n.mn = mn;
    n.in_cycle = n.valid && !rooted;
    n.brk = n.in_cycle && mn == i;
    n.start = n.in_cycle ? mn : ptr;
    n.rank = n.in_cycle ? dmn : (dsf & kDmask);
    n.is_start = n.valid && (pred[i] < 0 || n.brk);
    n.is_end = n.valid && (s < 0 || (n.in_cycle && s == mn));
    return n;
  }
};

__global__ void finish_ends(Graph g, const int64_t* __restrict__ wlen,
                            int64_t* __restrict__ end_of,
                            int64_t* __restrict__ len_at_start) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= g.M) return;
  Node n = g.node(i);
  if (!n.is_end || n.start < 0 || n.start >= g.M) return;
  end_of[n.start] = i;
  len_at_start[n.start] = n.rank + (wlen != nullptr ? wlen[i] : 1);
}

struct Keep {
  Graph g;
  const int64_t* end_of;
  __device__ long long operator()(long long i) const {
    Node n = g.node(i);
    long long N = g.M / 2;
    long long e = end_of[i];
    long long mirror_start;
    if (n.brk) {
      mirror_start = g.state[4 * ((i + N) % g.M) + 2];  // roll(mn, N)[i]
    } else {
      long long x = e >= 0 ? e : i;
      mirror_start = x >= N ? x - N : x + N;
    }
    return (n.is_start && e >= 0 && i < mirror_start) ? 1 : 0;
  }
};

struct WriteUnitig {
  Graph g;
  const int64_t* len_at_start;
  int64_t* ks;
  int64_t* start_oid;
  int64_t* length;
  uint8_t* circular;
  __device__ void operator()(long long i, long long uid, long long keep) const {
    ks[i] = keep ? uid : -1;
    if (!keep) return;
    Node n = g.node(i);
    long long pk = len_at_start[i] | (n.brk ? (1LL << 30) : 0LL);
    start_oid[uid] = i;
    length[uid] = pk & kLenMask;
    circular[uid] = ((pk >> 30) & 1) != 0;
  }
};

__global__ void finish_ids(Graph g, const int64_t* __restrict__ ks,
                           int64_t* __restrict__ uid,
                           int64_t* __restrict__ rank) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= g.M) return;
  Node n = g.node(i);
  long long s = n.start < 0 ? 0 : (n.start >= g.M ? g.M - 1 : n.start);
  long long val = ks[s];
  long long u = (n.valid && val >= 0) ? val : -1;
  uid[i] = u;
  rank[i] = u >= 0 ? n.rank : 0;
}

}  // namespace

extern "C" int bt_chain_finish(const int64_t* succ, const int64_t* pred,
                               const uint8_t* valid, const int64_t* state,
                               const int64_t* wlen, long long M,
                               int64_t* end_of, int64_t* len_at_start,
                               int64_t* ks, long long* scratch, int64_t* uid,
                               int64_t* rank, int64_t* start_oid,
                               int64_t* length, uint8_t* circular,
                               int64_t* n_unitigs, void* stream) {
  if (M == 0) return 0;
  if (M % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Graph g{succ, pred, valid, state, M};
  unsigned int grid = bt::blocks_for(M);
  finish_ends<<<grid, bt::kThreads, 0, s>>>(g, wlen, end_of, len_at_start);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = exclusive_sum(Keep{g, end_of},
                         WriteUnitig{g, len_at_start, ks, start_oid, length,
                                     circular},
                         M, scratch, n_unitigs, s);
  if (rc != 0) return rc;
  finish_ids<<<grid, bt::kThreads, 0, s>>>(g, ks, uid, rank);
  return static_cast<int>(cudaGetLastError());
}
