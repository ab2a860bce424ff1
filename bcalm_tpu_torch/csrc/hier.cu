// K4 and K17-K19: the pointer jump over the packed chain state.
//
// Replace bcalm_tpu/ops/chains.py:hier_jump (:381) and the pieces it runs
// per level: _phase with fixpoints (:298), _sampled (:336), the level
// build (:402-441) and the upward composition (:448-463); and the plain
// doubling, _phase with no fixpoints (:298, :467 plain_jumpF), with its
// _composeF (:258).  Rows are
// (ptr, dist|flags, mn, dmn), int64, flags in bits 28-30 of the dist
// column as in compose.cuh.  A level of S rows contracts to S1 = S/4 rows:
//
// K17 hier_round: one doubling round of phase A.  A row whose target p is
//   a sampled fixpoint of the level (valid, murmur-sampled gid, salt per
//   level) and not ROOTED is served as the identity row (p, FIX, gid[p], 0)
//   instead of its own row, so a query stops there (SETTLED).  JAX builds
//   the table T of served rows; here it is decided per query on the fly,
//   T is never written.  JAX's identity row carries ROOTED when the row
//   was ROOTED when the phase began, but a row that was ROOTED then is
//   ROOTED now (ROOTED absorbs) and is then served as itself: the flag of a
//   served identity row is always FIX alone.  The level's fixpoints are a
//   bitmap, one bit per row (valid && sampled), built once per level in
//   one coalesced pass (bt_fixpoint_bits; 2 MiB at 2^24 rows: it stays in
//   L2 across the level's rounds); a query reads its target's bit and its
//   target's row, and gid[p] only when the target is served (at level 0,
//   gid is the identity: no gid array is passed).  hier_jump
//   runs _R_A rounds with no changed flag (null) and no sync.
// K4 jump_round: K17's round with no fixpoints (one template, round_kernel),
//   the plain doubling of plain_jumpF and of the deepest level.  A
//   converging phase (_phase's converge=True, JAX's while_loop) gives each
//   round a flag word, zeroed once: round r sets word r when a row moved
//   (one store a block) and returns at once when word r - 1 is 0, so the
//   host launches rounds in batches and syncs once a batch.
// K18 hier_contract: the level build, four device operations: a memset
//   of tmask; a mark pass that flags the targets of the unresolved rows
//   (valid, neither SETTLED nor ROOTED) and zeroes the selection's ticket
//   and tile status words; one selection pass with decoupled look-back
//   (lookback.cuh) that reads valid, tmask and gid once per row and gives
//   the selected rows (sampled or flagged, and valid) dense ids `did` in
//   index order (JAX sorts the selected indices; the stable ranks give the
//   same order), S1 for the others, lands each selected index at
//   `parent[did]` and has its last tile write the selected count n_c; and
//   a gather pass that builds the level's S1 rows: ptr remapped through
//   did (ROOTED rows keep their original-space ptr), SETTLED and FIX
//   cleared, the absorbing filler (j, ROOTED, big, 0) and parent[j] = 0
//   past n_c; ok[0] goes to 0 when n_c > S1 (JAX's level overflow; the
//   rows past S1 are dropped as JAX drops them).
// K19 hier_expand: the upward pass.  Each row of the level below composes
//   its phase-A span with the converged row of its target one level up
//   (did of its ptr), whose ptr is translated back through parent unless
//   ROOTED.  It runs in place, over Qd: a thread reads its row as two
//   16-byte loads, issues the did load as soon as the ptr is in, and
//   writes two 16-byte streaming stores over that row; a ROOTED row comes
//   back unchanged, makes no random read and is not written.  The chain of
//   a row that is not ROOTED is did, then the F row, then parent: parent
//   (S1 x 8 bytes) stays in L2, so translating F through it first (JAX's
//   order) would save no time (measured on an H100 at 2^24 rows).
// The deepest level runs the plain doubling (K4).
//
// Bound: memory, and random rows.  K4 reads its row and, unless ROOTED,
// its target's row (a random sector beyond L2 at 2^24 rows), and writes
// 32 bytes; a round after convergence reads one word.  K17 reads its row
// (32 bytes, two 16-byte loads through the read-only path), the target's
// row (one random 32-byte sector, beyond L2 at 2^24 rows), the target's
// bit (L2) and, for a served target above level 0, gid[p] (a sector), and
// writes 32 bytes (two 16-byte streaming stores); K18 reads the rows twice
// (the mark's flags and pointers, the gather's selected rows), valid,
// tmask and gid once, and writes did and S1 rows; K19 reads its row and,
// unless ROOTED, a sector of did and of F (each beyond L2 at 2^24 rows)
// and parent (L2), and writes 32 bytes unless ROOTED.  Each kernel is one
// thread per row with the random reads issued as early as the control flow
// allows; the selection is one look-back pass, not JAX's sort, and no (S, 4) table
// of served rows is materialised.
#include "lookback.cuh"
#include "compose.cuh"

namespace {

// bcalm_tpu/ops/chains.py:_sampled, in wrapping uint32_t arithmetic
__device__ __forceinline__ bool level_sampled(long long g, uint32_t salt) {
  uint32_t h = static_cast<uint32_t>(g) ^ salt;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (h & 7u) == 0u;  // % _SAMPLE_DIV (8)
}

__device__ __forceinline__ long long clampi(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// The level's fixpoint bitmap: bit v & 31 of word v >> 5 is valid[v] &&
// level_sampled(gid[v]).  Level 0 (no gid: gid[v] = v) reads valid alone:
// a thread takes 16 rows, their valid bytes as one 16-byte load (valid is
// 16-byte aligned; the rows where S cuts a group a byte at a time), and
// the two threads of a pair join their 16-bit halves into one word, which
// the even one writes.  Above level 0 a block covers kBitRows rows, a
// thread kBitItems of them, one per 256-row slice, its loads all issued
// before the first is used; a warp's ballot over a slice is one word.
// That kernel keeps its test for a null gid although it is never given
// one: without it nvcc issues each slice's loads just before its ballot,
// and the kernel is slower (measured on an H100 at 2^22 and 2^24 rows).
constexpr int kBitSpan = 16;
constexpr int kBitItems = 8;
constexpr long long kBitRows = bt::kThreads * kBitItems;

__global__ void __launch_bounds__(bt::kThreads)
hier_fixbits0_kernel(const uint8_t* __restrict__ valid, long long S,
                     uint32_t salt, uint32_t* __restrict__ bits) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long v0 = t * kBitSpan;
  uint32_t half = 0;
  if (v0 < S) {
    union {
      uint4 word;
      uint8_t b[kBitSpan];
    } live;
    if (v0 + kBitSpan <= S) {
      live.word = __ldg(reinterpret_cast<const uint4*>(valid + v0));
    } else {
#pragma unroll
      for (int i = 0; i < kBitSpan; ++i) live.b[i] = v0 + i < S ? valid[v0 + i] : 0;
    }
#pragma unroll
    for (int i = 0; i < kBitSpan; ++i) {
      half |= static_cast<uint32_t>(live.b[i] != 0 && level_sampled(v0 + i, salt)) << i;
    }
  }
  const uint32_t high = __shfl_down_sync(0xFFFFFFFFu, half, 1);
  if ((t & 1) == 0 && v0 < S) bits[t >> 1] = half | (high << kBitSpan);
}

__global__ void __launch_bounds__(bt::kThreads)
hier_fixbits_kernel(const int64_t* __restrict__ gid,
                    const uint8_t* __restrict__ valid, long long S,
                    uint32_t salt, uint32_t* __restrict__ bits) {
  const long long base = static_cast<long long>(blockIdx.x) * kBitRows + threadIdx.x;
  bool live[kBitItems];
  long long g[kBitItems];
#pragma unroll
  for (int k = 0; k < kBitItems; ++k) {
    const long long v = base + k * bt::kThreads;
    live[k] = v < S && valid[v];
    g[k] = v < S && gid != nullptr ? gid[v] : v;
  }
#pragma unroll
  for (int k = 0; k < kBitItems; ++k) {
    const long long v = base + k * bt::kThreads;
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, live[k] && level_sampled(g[k], salt));
    if ((threadIdx.x & 31) == 0 && v < S) bits[v >> 5] = word;
  }
}

// K17 hier_round (kFix) and K4 jump_round (no fixpoints): one doubling
// round, a thread a row.  The row comes in as two 16-byte loads through
// the read-only path; unless ROOTED, the ancestor's two halves are issued
// together as soon as the ptr is in (one random sector); the new row goes
// out as two 16-byte streaming stores; `changed` (optional) gets one store
// a block, after a vote, when a row of the block moved (stores to one
// word serialise in the L2: one a warp doubled K4's time at 2^19 rows,
// measured on an H100).  prev (the flag mode of a converging phase): the
// word the round before wrote; when it is 0 that round moved no row, so Q
// and Qn hold the same state, JAX's fixed point, and the round returns at
// once, reading and writing no row.
template <bool kFix>
__global__ void __launch_bounds__(bt::kThreads)
round_kernel(const longlong2* __restrict__ Q, longlong2* __restrict__ Qn,
             const int64_t* __restrict__ gid, const uint32_t* __restrict__ bits,
             long long S, int* __restrict__ changed,
             const int* __restrict__ prev) {
  if (prev != nullptr && __ldg(prev) == 0) return;
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool moved = false;
  if (v < S) {
    const longlong2 a = __ldg(Q + 2 * v), b = __ldg(Q + 2 * v + 1);
    const int64_t q[4] = {a.x, a.y, b.x, b.y};
    int64_t out[4] = {a.x, a.y, b.x, b.y};
    if (!(a.y & bt::kRooted)) {
      const long long p = clampi(a.x, S - 1);
      if constexpr (kFix) {
        // the target's bit (L2) and both halves of its row (one sector)
        // issued together; gid[p] only once the bit says served
        const bool fix = (__ldg(bits + (p >> 5)) >> (p & 31)) & 1u;
        const longlong2 ta = __ldg(Q + 2 * p), tb = __ldg(Q + 2 * p + 1);
        const long long g =
            fix && gid != nullptr ? __ldg(reinterpret_cast<const long long*>(gid) + p) : p;
        if (fix && !(ta.y & bt::kRooted)) {
          const int64_t ident[4] = {p, bt::kFix, g, 0};
          moved = bt::compose_row(q, ident, out);
        } else {
          const int64_t t[4] = {ta.x, ta.y, tb.x, tb.y};
          moved = bt::compose_row(q, t, out);
        }
      } else {
        const longlong2 ta = __ldg(Q + 2 * p), tb = __ldg(Q + 2 * p + 1);
        const int64_t t[4] = {ta.x, ta.y, tb.x, tb.y};
        moved = bt::compose_row(q, t, out);
      }
    }
    __stcs(Qn + 2 * v, make_longlong2(out[0], out[1]));
    __stcs(Qn + 2 * v + 1, make_longlong2(out[2], out[3]));
  }
  if (changed != nullptr && __syncthreads_or(moved) && threadIdx.x == 0) {
    *changed = 1;
  }
}

// Rows per tile of the selection: kSelItems per thread.
constexpr int kSelItems = 8;
constexpr long long kSelTile = bt::kThreads * kSelItems;  // 2048 rows

// zero: the selection's ticket and status words (n_zero of them).
__global__ void hier_mark_kernel(const int64_t* __restrict__ Q,
                                 const uint8_t* __restrict__ valid, long long S,
                                 uint8_t* __restrict__ tmask,
                                 unsigned long long* __restrict__ zero,
                                 long long n_zero) {
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v < n_zero) zero[v] = 0;
  if (v >= S) return;
  long long f = Q[4 * v + 1];
  if (valid[v] && !(f & (bt::kSettled | bt::kRooted))) {
    long long p = Q[4 * v];
    if (p >= 0 && p < S) tmask[p] = 1;  // JAX's .at[].set(mode="drop")
  }
}

__global__ void __launch_bounds__(bt::kThreads)
hier_select_kernel(const int64_t* __restrict__ gid,
                   const uint8_t* __restrict__ valid,
                   const uint8_t* __restrict__ tmask, long long S,
                   uint32_t salt, long long S1,
                   unsigned long long* __restrict__ next_tile,
                   unsigned long long* __restrict__ status,
                   int64_t* __restrict__ did, int64_t* __restrict__ parent,
                   int64_t* __restrict__ n_c) {
  const long long tile = take_tile(next_tile);
  const long long first = tile * kSelTile + threadIdx.x;
  bool keep[kSelItems];
#pragma unroll
  for (int q = 0; q < kSelItems; ++q) {
    const long long i = first + q * bt::kThreads;
    keep[q] = i < S && valid[i] && (tmask[i] || level_sampled(gid[i], salt));
  }
  long long dest[kSelItems];
  const long long total = select_ranks<kSelItems>(keep, tile, status, dest);
  if (threadIdx.x == 0 && tile == (S - 1) / kSelTile) n_c[0] = total;
#pragma unroll
  for (int q = 0; q < kSelItems; ++q) {
    const long long i = first + q * bt::kThreads;
    if (i >= S) break;
    did[i] = dest[q] >= 0 ? dest[q] : S1;
    if (dest[q] >= 0 && dest[q] < S1) parent[dest[q]] = i;
  }
}

// parent[j] for j >= n_c is written here (0), the rest by the selection.
__global__ void hier_gather_kernel(const int64_t* __restrict__ Q,
                                   const int64_t* __restrict__ gid,
                                   const int64_t* __restrict__ did,
                                   int64_t* __restrict__ parent,
                                   const int64_t* __restrict__ n_c, long long S,
                                   long long S1, long long big,
                                   int64_t* __restrict__ Q1,
                                   int64_t* __restrict__ gid1,
                                   uint8_t* __restrict__ valid1,
                                   int* __restrict__ ok) {
  long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= S1) return;
  long long n = n_c[0];
  if (j == 0 && n > S1) *ok = 0;
  int64_t* out = Q1 + 4 * j;
  if (j < n) {
    long long i = parent[j];
    const int64_t* r = Q + 4 * i;
    long long f = r[1];
    out[0] = (f & bt::kRooted) ? r[0] : did[clampi(r[0], S - 1)];
    out[1] = f & (bt::kDmask | bt::kRooted);
    out[2] = r[2];
    out[3] = r[3];
    gid1[j] = gid[i];
    valid1[j] = 1;
  } else {
    // the absorbing filler, its SETTLED cleared as the hop clears it
    out[0] = j; out[1] = bt::kRooted; out[2] = big; out[3] = 0;
    gid1[j] = big;
    valid1[j] = 0;
    parent[j] = 0;
  }
}

// In place: a thread reads its own row of Qd, and only it, before it
// writes that row (plain loads: Qd is written in this launch, so not
// through the read-only path); a ROOTED row comes back unchanged and is
// not written.
__global__ void __launch_bounds__(bt::kThreads)
hier_expand_kernel(const longlong2* __restrict__ F,
                   const int64_t* __restrict__ parent, longlong2* __restrict__ Qd,
                   const int64_t* __restrict__ did, long long S, long long S1) {
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= S) return;
  // both halves of the own row (one sector), then did as soon as the ptr
  // is in
  const longlong2 a = Qd[2 * v], b = Qd[2 * v + 1];
  if (a.y & bt::kRooted) return;
  const long long t = __ldg(did + clampi(a.x, S - 1));
  const long long tgt = clampi(t, S1 - 1);
  const longlong2 fa = __ldg(F + 2 * tgt), fb = __ldg(F + 2 * tgt + 1);
  // parent (S1 x 8 bytes) is read where the row above is not ROOTED
  const int64_t q[4] = {a.x, a.y, b.x, b.y};
  const int64_t anc[4] = {
      (fa.y & bt::kRooted) ? fa.x : __ldg(parent + clampi(fa.x, S1 - 1)), fa.y,
      fb.x, fb.y};
  int64_t o[4];
  bt::compose_row(q, anc, o);
  __stcs(Qd + 2 * v, make_longlong2(o[0], o[1]));
  __stcs(Qd + 2 * v + 1, make_longlong2(o[2], o[3]));
}

}  // namespace

// bits: ceil(S / 32) words, every one written.  gid null: level 0, and
// valid 16-byte aligned.
extern "C" int bt_fixpoint_bits(const int64_t* gid, const uint8_t* valid,
                                long long S, unsigned int salt, uint32_t* bits,
                                void* stream) {
  if (S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gid == nullptr) {
    const long long threads = 2 * ((S + 31) / 32);  // two a word
    hier_fixbits0_kernel<<<bt::blocks_for(threads), bt::kThreads, 0, s>>>(
        valid, S, salt, bits);
  } else {
    hier_fixbits_kernel<<<static_cast<unsigned int>((S + kBitRows - 1) / kBitRows),
                          bt::kThreads, 0, s>>>(gid, valid, S, salt, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

// bits: the level's bitmap (bt_fixpoint_bits).  gid null: level 0.
// changed: as in round_kernel (may be null); K17 has no flag mode.
extern "C" int bt_hier_round(const int64_t* Q, int64_t* Qn, const int64_t* gid,
                             const uint32_t* bits, long long S, int* changed,
                             void* stream) {
  if (S == 0) return 0;
  round_kernel<true><<<bt::blocks_for(S), bt::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const longlong2*>(Q), reinterpret_cast<longlong2*>(Qn),
      gid, bits, S, changed, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K4: the round with no fixpoints; changed, prev: as in round_kernel
// (each may be null).
extern "C" int bt_jump_round(const int64_t* Q, int64_t* Qn, long long M,
                             int* changed, const int* prev, void* stream) {
  if (M == 0) return 0;
  round_kernel<false><<<bt::blocks_for(M), bt::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const longlong2*>(Q), reinterpret_cast<longlong2*>(Qn),
      nullptr, nullptr, M, changed, prev);
  return static_cast<int>(cudaGetLastError());
}

// work: 1 + ceil(S / 2048) + ceil(S / 8) int64 words, needing no fill:
// the selection's ticket and tile status words (zeroed by the mark pass),
// then S bytes of tmask (zeroed by a memset).
extern "C" int bt_hier_contract(const int64_t* Q, const int64_t* gid,
                                const uint8_t* valid, long long S,
                                unsigned int salt, long long S1, long long big,
                                long long* work, int64_t* did, int64_t* parent,
                                int64_t* n_c, int64_t* Q1, int64_t* gid1,
                                uint8_t* valid1, int* ok, void* stream) {
  if (S == 0 || S1 == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (S + kSelTile - 1) / kSelTile;
  auto* words = reinterpret_cast<unsigned long long*>(work);
  auto* tmask = reinterpret_cast<uint8_t*>(work + 1 + tiles);
  cudaError_t err = cudaMemsetAsync(tmask, 0, S, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  hier_mark_kernel<<<bt::blocks_for(S > tiles + 1 ? S : tiles + 1),
                     bt::kThreads, 0, s>>>(Q, valid, S, tmask, words,
                                           1 + tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hier_select_kernel<<<static_cast<unsigned int>(tiles), bt::kThreads, 0, s>>>(
      gid, valid, tmask, S, salt, S1, words, words + 1, did, parent, n_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hier_gather_kernel<<<bt::blocks_for(S1), bt::kThreads, 0, s>>>(
      Q, gid, did, parent, n_c, S, S1, big, Q1, gid1, valid1, ok);
  return static_cast<int>(cudaGetLastError());
}

// Over Qd, in place.
extern "C" int bt_hier_expand(const int64_t* F, const int64_t* parent,
                              int64_t* Qd, const int64_t* did, long long S,
                              long long S1, void* stream) {
  if (S == 0) return 0;
  hier_expand_kernel<<<bt::blocks_for(S), bt::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const longlong2*>(F), parent,
      reinterpret_cast<longlong2*>(Qd), did, S, S1);
  return static_cast<int>(cudaGetLastError());
}
