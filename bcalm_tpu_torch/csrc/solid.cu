// K7 solid_fold_histogram: the solidity filter and the abundance histogram
// of a counted distinct table in one pass.
//
// Replaces bcalm_tpu/ops/count.py:filter_abundance_fold and
// :abundance_histogram (two XLA programs).  Column i of the (L, N) table
// is solid when i < n_unique and abundance_min <= count <= abundance_max;
// a non-solid column folds to the sentinel (lanes and pos) with count 0.
// Every column below n_unique adds one to bin clamp(count, 0, histo_max).
//
// A grid-stride loop over a bounded grid, so that each block's
// shared-memory histogram (histo_max+1 u32 bins, 40 KB at the default
// 10000) is zeroed and flushed once for many columns; the flush adds only
// the bins the block touched.  When the bins do not fit in 48 KB the
// columns add straight into the global histogram.  n_solid is a warp
// reduction and one atomic per warp.  Bound: memory, (L+2)*8 bytes read
// and (L+2)*8 written per column.
#include "common.cuh"

namespace {

constexpr int kMaxSharedBins = 48 * 1024 / 4;
constexpr unsigned int kMaxBlocks = 1024;

__global__ void solid_fold_kernel(
    const int64_t* __restrict__ unique, long long ustride,
    const int64_t* __restrict__ counts, const int64_t* __restrict__ minpos,
    long long N, long long n_unique, int L, long long amin, long long amax,
    int histo_max, int shared_bins, int64_t* __restrict__ solid,
    long long sstride, int64_t* __restrict__ scounts,
    int64_t* __restrict__ spos, unsigned long long* __restrict__ n_solid,
    unsigned long long* __restrict__ histo) {
  extern __shared__ unsigned int bins[];
  const int nb = histo_max + 1;
  if (shared_bins) {
    for (int b = threadIdx.x; b < nb; b += blockDim.x) bins[b] = 0u;
    __syncthreads();
  }
  unsigned int kept = 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < N; i += step) {
    long long c = counts[i];
    bool live = i < n_unique;
    bool keep = live && c >= amin && c <= amax;
    for (int j = 0; j < L; ++j) {
      solid[j * sstride + i] = keep ? unique[j * ustride + i] : bt::kSentinel;
    }
    scounts[i] = keep ? c : 0;
    spos[i] = keep ? minpos[i] : bt::kSentinel;
    kept += keep;
    if (live) {
      int b = c <= 0 ? 0 : (c >= histo_max ? histo_max : static_cast<int>(c));
      if (shared_bins) atomicAdd(bins + b, 1u);
      else atomicAdd(histo + b, 1ull);
    }
  }
  for (int d = 16; d > 0; d >>= 1) kept += __shfl_down_sync(0xFFFFFFFFu, kept, d);
  if ((threadIdx.x & 31) == 0 && kept) {
    atomicAdd(n_solid, static_cast<unsigned long long>(kept));
  }
  if (shared_bins) {
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      if (bins[b]) atomicAdd(histo + b, static_cast<unsigned long long>(bins[b]));
    }
  }
}

}  // namespace

extern "C" int bt_solid_fold(const int64_t* unique, long long ustride,
                             const int64_t* counts, const int64_t* minpos,
                             long long N, long long n_unique, int L,
                             long long amin, long long amax, int histo_max,
                             int64_t* solid, long long sstride,
                             int64_t* scounts, int64_t* spos, int64_t* n_solid,
                             int64_t* histo, void* stream) {
  if (L < 1 || L > bt::kMaxLanes || histo_max < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  int shared_bins = histo_max + 1 <= kMaxSharedBins;
  size_t smem = shared_bins ? (histo_max + 1) * sizeof(unsigned int) : 0;
  unsigned int grid = bt::blocks_for(N);
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  solid_fold_kernel<<<grid, bt::kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      unique, ustride, counts, minpos, N, n_unique, L, amin, amax, histo_max,
      shared_bins, solid, sstride, scounts, spos,
      reinterpret_cast<unsigned long long*>(n_solid),
      reinterpret_cast<unsigned long long*>(histo));
  return static_cast<int>(cudaGetLastError());
}
