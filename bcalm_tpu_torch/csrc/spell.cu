// K11 spell_unitigs: unitig base codes and member-ordered counts on the
// device.
//
// Replaces bcalm_tpu/engine.py:_assemble_dev (a cumsum, two scatters and
// a sort of the 2C oriented nodes by (uid, rank) on the TPU).  With
// run_start(u) = the exclusive prefix of the unitig lengths, unitig u's
// bases start at offset(u) = run_start(u) + (k-1) u:
//   starts:  each unitig's start k-mer (start_oid, reverse-complemented on
//     the - strand) writes its k bases at offset(u) .. offset(u) + k-1;
//   members: every oriented node o with uid u >= 0 writes the last base of
//     its oriented k-mer at offset(u) + k-1 + rank(o), and its count at
//     run_start(u) + rank(o).
// JAX writes the members, then the starts, so where the two meet the
// start's base stands.  Here both run in one launch with no order between
// them, and the bytes are the same because no member's base lands on a
// start's: a unitig's members have the ranks 0 .. length-1, each once
// (chain_finish gives them so); a member of rank 0, whose base is the
// start's last, writes no base; a member of rank 1 .. length-1 writes at
// offset(u) + k .. offset(u) + k-1 + length-1, past its start's k bases
// and below offset(u+1), where the next unitig's start begins.  Writes
// past the outputs are dropped, as JAX's mode="drop" does.
//
// Three device operations, no fill of the outputs:
// 1. a memset of the scan's ticket and tile status words;
// 2. the scan: one pass over tiles of 1024 unitig lengths with decoupled
//    look-back (lookback.cuh) that writes run_start; its last tile zeroes
//    the outputs past the unitigs (codes from offset(U), the counts from
//    run_start(U));
// 3. one kernel whose first blocks spell the starts, a warp per unitig:
//    the L words of its start k-mer loaded at once (lane j, word j), the k
//    bases written as coalesced bytes; and whose last blocks do the
//    members, one thread per k-mer v reading the uid of both its
//    orientations (v and C + v).
// With those ranks the starts and members together write every byte of
// codes and every count below the unitigs' end: the outputs need no fill.
// Bound: memory.  The uid of every oriented id (2C x 8 bytes, the largest
// read), and per member its rank, one lane word, its count, the member's
// base and count (scattered, but neighbouring members of a run land on
// neighbouring positions); per unitig its length, start id and the L
// words of its start k-mer (random sectors).  The starts' threads were
// one a unitig, k serial byte stores each: a warp a unitig spreads them
// over the card.
#include "lookback.cuh"

namespace {

constexpr int kScanItems = 4;  // unitigs per thread of the scan
constexpr long long kTileU = bt::kThreads * kScanItems;  // 1024 a tile

// run_start(u) for every unitig, by tiles of kTileU with decoupled
// look-back; the last tile zeroes the outputs past the unitigs (the counts
// from run_start(U), codes from offset(U)): nothing else writes there.
__global__ void __launch_bounds__(bt::kThreads)
spell_scan(const int64_t* __restrict__ length, long long U, int k,
           unsigned long long* __restrict__ next_tile,
           unsigned long long* __restrict__ status,
           int64_t* __restrict__ run_start, uint8_t* __restrict__ codes,
           long long total, int64_t* __restrict__ mcounts,
           long long n_members) {
  __shared__ long long s_sum[bt::kThreads / 32];
  __shared__ long long s_carry, s_end;
  const long long tile = take_tile(next_tile);
  const int t = threadIdx.x;
  const long long u0 = tile * kTileU + t * kScanItems;
  long long len[kScanItems], sum = 0;
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    len[q] = u0 + q < U ? __ldg(length + u0 + q) : 0;
    sum += len[q];
  }
  long long tile_sum;
  const long long excl = block_exclusive(sum, s_sum, tile_sum);
  if (t < 32) {
    long long carry = 0;
    if (tile == 0) {
      if (t == 0) store_status(status, tile_sum, kPrefix);
    } else {
      if (t == 0) store_status(status + tile, tile_sum, kAggregate);
      carry = look_back(status, tile, t);
      if (t == 0) store_status(status + tile, carry + tile_sum, kPrefix);
    }
    if (t == 0) s_carry = carry;
  }
  __syncthreads();
  long long rs = s_carry + excl;
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    if (u0 + q < U) run_start[u0 + q] = rs;
    rs += len[q];
    if (u0 + q == U - 1) s_end = rs;
  }
  if (tile != (U - 1) / kTileU) return;
  __syncthreads();
  const long long end_m = s_end < 0 ? 0 : s_end;
  for (long long m = end_m + t; m < n_members; m += bt::kThreads) mcounts[m] = 0;
  long long end_c = s_end + static_cast<long long>(k - 1) * U;
  end_c = end_c < 0 ? 0 : end_c;
  for (long long d = end_c + t; d < total; d += bt::kThreads) codes[d] = 0;
}

// The starts' blocks come first (their chains of dependent loads overlap
// the members' streaming): a warp per unitig loads the L words of its
// start k-mer (lane j word j, all in one go) and writes the k bases as
// coalesced bytes, each lane taking its base's word from the lane that
// holds it.  Then the members' blocks: one thread per k-mer v reads the
// uid of both its orientations (v and C + v) and does the member work of
// the one that is a member (both, if both are).
__global__ void __launch_bounds__(bt::kThreads)
spell_kernel(const int64_t* __restrict__ solid, long long stride, int L,
             long long C, const int64_t* __restrict__ counts,
             const int64_t* __restrict__ uid, const int64_t* __restrict__ rank,
             const int64_t* __restrict__ start_oid, long long U,
             const int64_t* __restrict__ run_start, int k,
             long long start_blocks, uint8_t* __restrict__ codes,
             long long total, int64_t* __restrict__ mcounts,
             long long n_members) {
  const int r = k % 16 == 0 ? 16 : k % 16;
  if (blockIdx.x < start_blocks) {
    const int lane = threadIdx.x & 31;
    const long long u = static_cast<long long>(blockIdx.x) * (bt::kThreads / 32) +
                        (threadIdx.x >> 5);
    if (u >= U) return;
    const long long so = __ldg(start_oid + u);
    const bool minus = so >= C;
    long long v = minus ? so - C : so;
    v = v < 0 ? 0 : (v >= C ? C - 1 : v);
    const uint32_t word =
        lane < L ? static_cast<uint32_t>(__ldg(solid + lane * stride + v)) : 0u;
    const long long off = __ldg(run_start + u) + static_cast<long long>(k - 1) * u;
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      // base p of the + strand: in lane 0's top r bases, or 16 a lane
      const int p = minus ? k - 1 - j : j;
      const int wi = p < r ? 0 : 1 + (p - r) / 16;
      const int shift = p < r ? 2 * (r - 1 - p) : 2 * (15 - (p - r) % 16);
      const uint32_t w = __shfl_sync(0xFFFFFFFFu, word, j < k ? wi : 0);
      const long long d = off + j;
      if (j < k && d >= 0 && d < total) {
        const uint32_t b = (w >> shift) & 3u;
        codes[d] = static_cast<uint8_t>(minus ? b ^ 2u : b);
      }
    }
    return;
  }
  const long long v =
      static_cast<long long>(blockIdx.x - start_blocks) * blockDim.x + threadIdx.x;
  if (v >= C) return;
  const long long up = __ldg(uid + v), um = __ldg(uid + C + v);
  const bool plus = up >= 0 && up < U, minus = um >= 0 && um < U;
  if (!plus && !minus) return;
  const long long cnt = __ldg(counts + v);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!(s ? minus : plus)) continue;
    const long long o = s ? C + v : v;
    const long long u = s ? um : up;
    const long long rk = __ldg(rank + o);
    // the oriented k-mer's last base: the + strand's last, or the
    // complement of the + strand's first
    const int b = s ? static_cast<int>(((static_cast<uint32_t>(__ldg(solid + v)) >>
                                         (2 * (r - 1))) & 3u) ^ 2u)
                    : static_cast<int>(static_cast<uint32_t>(
                          __ldg(solid + (L - 1) * stride + v)) & 3u);
    const long long m = __ldg(run_start + u) + rk;
    const long long d = m + static_cast<long long>(k - 1) * u + (k - 1);
    if (rk != 0 && d >= 0 && d < total) codes[d] = static_cast<uint8_t>(b);
    if (m >= 0 && m < n_members) mcounts[m] = cnt;
  }
}

}  // namespace

// work: 1 + ceil(U / 1024) int64 words (the scan's ticket and tile status
// words), zeroed here.
extern "C" int bt_spell_unitigs(const int64_t* solid, long long stride, int L,
                                long long C, const int64_t* counts,
                                const int64_t* uid, const int64_t* rank,
                                const int64_t* length,
                                const int64_t* start_oid, long long U, int k,
                                long long* work, int64_t* run_start,
                                uint8_t* codes, long long total,
                                int64_t* mcounts, long long n_members,
                                void* stream) {
  if (L < 1 || L > bt::kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  if (U == 0 || C == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (U + kTileU - 1) / kTileU;
  auto* words = reinterpret_cast<unsigned long long*>(work);
  cudaError_t err = cudaMemsetAsync(words, 0, (1 + tiles) * sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  spell_scan<<<static_cast<unsigned int>(tiles), bt::kThreads, 0, s>>>(
      length, U, k, words, words + 1, run_start, codes, total, mcounts,
      n_members);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long member_blocks = bt::blocks_for(C);
  const long long start_blocks = (U + bt::kThreads / 32 - 1) / (bt::kThreads / 32);
  spell_kernel<<<static_cast<unsigned int>(member_blocks + start_blocks),
                 bt::kThreads, 0, s>>>(solid, stride, L, C, counts, uid, rank,
                                       start_oid, U, run_start, k,
                                       start_blocks, codes, total, mcounts,
                                       n_members);
  return static_cast<int>(cudaGetLastError());
}
