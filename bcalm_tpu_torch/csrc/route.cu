// K15 route_buckets: stable placement of entries into per-rank buckets.
//
// Replaces bcalm_tpu/parallel/pipeline.py:_route_to_buckets (:59), which
// every exchange of the -devices N build runs: entry i of a channel-major
// (C, N) stack with valid[i] and owner[i] in [0, n_dev) goes to bucket
// owner[i] at slot `within` = the number of valid entries j < i with the
// same owner (the JAX version's stable argsort by owner gives exactly this
// order); an entry whose slot is >= cap is dropped and counted.  Outputs:
// buckets (C, n_dev*cap) and their validity (zero where empty), the
// dropped count, and optionally each entry's flat slot (owner*cap +
// within, or n_dev*cap when dropped or invalid).
//
// A counting placement instead of a sort, in two launches over tiles of
// 1024 entries (one per thread): (1) each tile counts its entries per
// owner in shared memory; the wrapper turns the (tiles, n_dev) counts into
// exclusive per-owner tile offsets (torch.cumsum over a few thousand
// values); (2) each tile ranks its entries again: inside a warp, lanes with
// the same owner find each other with __match_any_sync and take their rank
// from the lanes below; per-warp totals in shared memory give the warp's
// offset inside the tile.  Every rank is fixed by entry order, never by
// atomics, so the placement is deterministic.
//
// Bound: memory.  Each entry's owner and validity are read twice (9 bytes
// each time), its C channels once (8C bytes) and written once; the
// (C, n_dev*cap) buckets are zeroed by the wrapper (8C * n_dev*cap bytes).
#include "common.cuh"

namespace {

constexpr int kTileEntries = 1024;
constexpr int kMaxDev = 256;

__device__ __forceinline__ int owner_of(const int64_t* owner,
                                        const uint8_t* valid, long long i,
                                        long long N, int n_dev) {
  if (i >= N || !valid[i]) return -1;        // not routed
  long long o = owner[i];
  return (o < 0 || o >= n_dev) ? -2 : static_cast<int>(o);  // -2: dropped
}

__global__ void route_count_kernel(const int64_t* __restrict__ owner,
                                   const uint8_t* __restrict__ valid,
                                   long long N, int n_dev,
                                   int64_t* __restrict__ tile_counts) {
  extern __shared__ int s_cnt[];
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x) s_cnt[d] = 0;
  __syncthreads();
  long long i = static_cast<long long>(blockIdx.x) * kTileEntries + threadIdx.x;
  int o = owner_of(owner, valid, i, N, n_dev);
  if (o >= 0) atomicAdd(&s_cnt[o], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < n_dev; d += blockDim.x) {
    tile_counts[static_cast<long long>(blockIdx.x) * n_dev + d] = s_cnt[d];
  }
}

__global__ void route_place_kernel(const int64_t* __restrict__ stacked,
                                   long long sstride, int C,
                                   const int64_t* __restrict__ owner,
                                   const uint8_t* __restrict__ valid,
                                   long long N, int n_dev, long long cap,
                                   const int64_t* __restrict__ tile_off,
                                   int64_t* __restrict__ buckets,
                                   uint8_t* __restrict__ bvalid,
                                   unsigned long long* __restrict__ dropped,
                                   int64_t* __restrict__ slots) {
  extern __shared__ int s_warp[];  // [32 warps][n_dev]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < 32 * n_dev; t += blockDim.x) s_warp[t] = 0;
  __syncthreads();
  long long i = static_cast<long long>(blockIdx.x) * kTileEntries + threadIdx.x;
  int o = owner_of(owner, valid, i, N, n_dev);
  unsigned same = __match_any_sync(0xFFFFFFFFu, o);
  int in_warp = __popc(same & ((1u << lane) - 1u));
  if (o >= 0 && in_warp == 0) s_warp[w * n_dev + o] = __popc(same);
  __syncthreads();
  if (i >= N) return;
  long long slot = static_cast<long long>(n_dev) * cap;
  if (o >= 0) {
    long long within = tile_off[static_cast<long long>(blockIdx.x) * n_dev + o] + in_warp;
    for (int v = 0; v < w; ++v) within += s_warp[v * n_dev + o];
    if (within < cap) {
      slot = o * cap + within;
      long long width = static_cast<long long>(n_dev) * cap;
      for (int c = 0; c < C; ++c) buckets[c * width + slot] = stacked[c * sstride + i];
      bvalid[slot] = 1;
    }
  }
  if (o != -1 && slot == static_cast<long long>(n_dev) * cap) atomicAdd(dropped, 1ull);
  if (slots) slots[i] = slot;
}

}  // namespace

extern "C" int bt_route_count(const int64_t* owner, const uint8_t* valid,
                              long long N, int n_dev, int64_t* tile_counts,
                              void* stream) {
  if (N == 0) return 0;
  if (n_dev < 1 || n_dev > kMaxDev) return static_cast<int>(cudaErrorInvalidValue);
  long long tiles = (N + kTileEntries - 1) / kTileEntries;
  route_count_kernel<<<static_cast<unsigned int>(tiles), kTileEntries,
                       n_dev * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      owner, valid, N, n_dev, tile_counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_route_place(const int64_t* stacked, long long sstride, int C,
                              const int64_t* owner, const uint8_t* valid,
                              long long N, int n_dev, long long cap,
                              const int64_t* tile_off, int64_t* buckets,
                              uint8_t* bvalid, int64_t* dropped, int64_t* slots,
                              void* stream) {
  if (N == 0) return 0;
  if (n_dev < 1 || n_dev > kMaxDev) return static_cast<int>(cudaErrorInvalidValue);
  long long tiles = (N + kTileEntries - 1) / kTileEntries;
  route_place_kernel<<<static_cast<unsigned int>(tiles), kTileEntries,
                       32 * n_dev * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      stacked, sstride, C, owner, valid, N, n_dev, cap, tile_off, buckets,
      bvalid, reinterpret_cast<unsigned long long*>(dropped), slots);
  return static_cast<int>(cudaGetLastError());
}
