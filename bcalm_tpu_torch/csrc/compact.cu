// K9 solid_compact: stable front-compaction of the solid columns of a
// counted distinct table, for the store checkpoint.
//
// Replaces bcalm_tpu/ops/count.py:filter_abundance_pos (with compact :56:
// a cumsum of the mask and L+2 scatters on the TPU).  Column i of the
// (L, N) table is solid when i < n_unique and amin <= count <= amax; the
// solid columns' lanes, counts and minpos move, in their order, to the
// front of one stacked (L+2, W) output (rows 0..L-1 lanes, L counts, L+1
// minpos) and n_solid receives their number.  Without a minpos row (null;
// the (L+1, W) output of bcalm_tpu/ops/count.py:filter_abundance, :158)
// only the lanes and counts move.  The output has W >= n_solid columns
// (N for JAX's shape; n_solid, known from K7, for the store's copy);
// columns [n_solid, W) get 0, and the sentinel in the minpos row, as
// JAX's compact and its SENTINEL past n_solid give.
//
// Bound on this card: memory, the counts read once and (L+2)*8 bytes read
// and written per solid column.  One pass does it: a single-pass select
// with decoupled look-back.  Each block takes the next tile of 4096
// columns from an atomic counter (so every tile it waits on is already
// running), item q of thread t being column tile * 4096 + q * 256 + t, so
// every load of the counts and of each row is one contiguous run per
// warp.  The 0/1 flags are ranked with __ballot_sync and __popc per warp
// and one pass of warp 0 over the 16 x 8 warp counts; the tile publishes
// its count, then its inclusive prefix, in a status word (value << 2 |
// flag), and warp 0 reads its carry from its predecessors' words, 32 at
// a time.  Each solid column is written once, to carry + rank: the order
// comes from the prefix, never from atomics on the output, so the
// compaction is stable.  A second, grid-stride launch fills [n_solid, W),
// reading n_solid on the device; at W = n_solid it writes nothing.
#include "lookback.cuh"

namespace {

constexpr int kItems = 16;                        // columns per thread
constexpr long long kTile = bt::kThreads * kItems;  // 4096 columns

__global__ void __launch_bounds__(bt::kThreads)
solid_compact_kernel(const int64_t* __restrict__ unique, long long ustride,
                     const int64_t* __restrict__ counts,
                     const int64_t* __restrict__ minpos, long long N,
                     long long n_unique, int L, long long amin, long long amax,
                     unsigned long long* __restrict__ next_tile,
                     unsigned long long* __restrict__ status,
                     int64_t* __restrict__ out, long long ostride, long long W,
                     int64_t* __restrict__ n_solid) {
  const long long tile = take_tile(next_tile);
  const long long first = tile * kTile + threadIdx.x;
  bool keep[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const long long i = first + q * bt::kThreads;
    keep[q] = false;
    if (i < N) {
      const long long c = counts[i];
      keep[q] = i < n_unique && c >= amin && c <= amax;
    }
  }
  // destination of each of this thread's columns, -1 where not solid
  long long dest[kItems];
  const long long total = select_ranks<kItems>(keep, tile, status, dest);
  if (threadIdx.x == 0 && tile == (N - 1) / kTile) n_solid[0] = total;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (dest[q] >= W) dest[q] = -1;
  }
  const int rows = L + 1 + (minpos != nullptr);
  for (int j = 0; j < rows; ++j) {
    const int64_t* src = j < L ? unique + j * ustride : j == L ? counts : minpos;
    int64_t* dst = out + j * ostride;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (dest[q] >= 0) dst[dest[q]] = src[first + q * bt::kThreads];
    }
  }
}

// Columns [n_solid, W) of the output: 0, and the sentinel in the minpos row.
__global__ void solid_tail_kernel(int64_t* __restrict__ out, long long ostride,
                                  int L, bool minpos_row, long long W,
                                  const int64_t* __restrict__ n_solid) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = n_solid[0] + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < W; i += step) {
    for (int j = 0; j <= L; ++j) out[j * ostride + i] = 0;
    if (minpos_row) out[(L + 1) * ostride + i] = bt::kSentinel;
  }
}

constexpr unsigned int kTailBlocks = 528;  // 4 per SM

}  // namespace

// scratch: 1 + ceil(N / 4096) zeroed words (the tile counter, then one
// status word per tile).  N must be > 0.
extern "C" int bt_solid_compact(const int64_t* unique, long long ustride,
                                const int64_t* counts, const int64_t* minpos,
                                long long N, long long n_unique, int L,
                                long long amin, long long amax,
                                long long* scratch, int64_t* out,
                                long long ostride, long long W,
                                int64_t* n_solid, void* stream) {
  if (L < 1 || L > bt::kMaxLanes || N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* words = reinterpret_cast<unsigned long long*>(scratch);
  const long long tiles = (N + kTile - 1) / kTile;
  solid_compact_kernel<<<static_cast<unsigned int>(tiles), bt::kThreads, 0, s>>>(
      unique, ustride, counts, minpos, N, n_unique, L, amin, amax, words,
      words + 1, out, ostride, W, n_solid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || W == 0) return static_cast<int>(err);
  const long long need = (W + bt::kThreads - 1) / bt::kThreads;
  solid_tail_kernel<<<need < kTailBlocks ? static_cast<unsigned int>(need)
                                         : kTailBlocks,
                      bt::kThreads, 0, s>>>(out, ostride, L, minpos != nullptr,
                                            W, n_solid);
  return static_cast<int>(cudaGetLastError());
}
