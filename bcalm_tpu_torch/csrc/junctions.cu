// K3 junction_keys + junction_pairs: the (k-1)-overlap successor array.
//
// Replaces bcalm_tpu/ops/junctions.py:successor_arrays (its key build and
// its pair detection / scatter; the sort between them is torch.sort).
//
// junction_keys, one thread per solid k-mer i < C: the suffix and prefix
// (k-1)-mers, their canonical forms, strands and palindrome flags; writes
// the strand-0 representative entry of each side (suffix at i, prefix at
// C+i): the exact canonical (k-1)-mer, as its lanes (one row each) or,
// with `packed` (past 3 lanes), as its packed words (models.lanes.pack_keys:
// two lanes a word, an odd last lane alone), all lanes the sentinel where
// invalid or palindromic, and the payload oid | role << 30.
//
// junction_pairs, over the sort's own output: the top packed key word in
// sorted order (the values torch.sort returns), the permutation, and the
// payload and the key's lower packed words in entry order; no sorted copy
// of the keys or the payload exists.  Equal packed words mean equal keys
// (the packing is a bijection on u32 pairs), and the sentinel test is on
// the packed word too: a key's first lane is its top word's high half (or
// the word itself for one lane); past 3 lanes its last lane, the low half
// of its last word, must be the sentinel too.  A group of exactly two
// entries (one OUT, one IN, on distinct vertices) sets succ[src] = dst and
// the mirror edge succ[mirror(dst)] = mirror(src).
// Those stores go by window, as junction_scatter's (below): the pair rule
// runs inside the bin pass (PairEdges), which stages each edge's two
// words in its window's bin, and a block a window then writes succ whole,
// -1 where no edge lands: no memset of succ and no random store into it.
// The windows rely on one invariant: every oriented node has one out-end
// and one in-end, so no two words name one slot of succ.
//
// The sharded glue of the -devices N build (global mode) replaces
// bcalm_tpu/parallel/distcompact.py:_local_succ_shard (:53) around its
// exchanges.  junction_entries, one thread per local k-mer i < slot_cap:
// all four entries of its two sides (suffix at i and N+i, prefix at 2N+i
// and 3N+i, N = slot_cap), keyed by the exact canonical (k-1)-mer lanes
// with the strand folded into the spare bits of the top lane (or carried
// as an extra first row when k-1 is a multiple of 16; palindromic sides
// take strand 0 on both entries), oriented ids global (+ = gbase + i,
// - = gbase + i + tot), and each entry's owner rank = hash_lanes(key rows)
// % n_dev (hash.cuh); the key rows and the payload as one (K+1, 4N)
// stack, the exchange's input, and each entry's validity (i < n_local).
// After the exchange, junction_words compacts the valid received slots,
// in receive order, into the sort's input: each one's K key rows packed
// into the sort words (models.lanes.pack_keys) and its payload, and their
// count n into a device word (one pass, decoupled look-back, as K9).  The
// sort then takes exactly the n valid entries: JAX sorts every slot with
// the empty ones filled with the sentinel, but no valid key is the
// sentinel (its first row is a strand, or a top lane with the strand in a
// spare bit: below 2^31), so the empty slots sort after every valid one,
// and a stable sort keeps the valid ones in receive order: JAX's first n
// sorted entries are these, and its pair rule finds no edge past them.
// junction_edges reads the sort's own output, as junction_pairs does:
// the sorted top word in a shared tile, a neighbour's lower words through
// perm only where the top words are equal, and a pair head's two payloads
// through perm (no sorted copy of the keys or the payload exists); it
// writes per sorted entry ok, the edge (src, dst) and the rank owning
// src's slot (-1, -1, 0 where not ok), the next exchange's input.
// junction_scatter, at src's owner, writes each received edge into the
// rank's successor shard by windows of 16384 slots (below): a pass that
// bins the edges into their windows, then a block a window that builds
// the window in shared memory and writes it whole, -1 where no edge
// lands, so the table is written once, in whole sectors, with no memset.
//
// Bound on this card: memory.  junction_keys reads L*8 bytes per k-mer
// and writes 2*(K+1)*8 (K key rows or words); junction_entries writes
// 4*(K+2)*8 and 4 validity bytes.
// Their arithmetic is the two (k-1)-mers' reverse complements, which
// common.cuh's revcomp_field builds a word at a time (revcomp_word on
// each lane, then one field shift): O(A) word operations per side, where
// the base-by-base shifts it replaces cost ~4(k-1)*A (~9,600 at k = 151,
// A = 16) and outweighed the bytes above 8 lanes.  Above 8 lanes the
// k-mer sits right-aligned in a 16- or 32-lane array (common.cuh); every
// lane loop runs over the array's compile-time width with the live lanes
// as a predicate, so the arrays stay in registers.  A thread's loads and
// stores are consecutive columns of each row: coalesced per warp.
// junction_pairs loads each sorted word once (neighbours by shuffle, a
// warp's edge entries again from L1; for a key of two words the second
// through perm: a random 32-byte sector per entry; of three words or more,
// the lower words through perm one at a time, only where two neighbours'
// top words tie); only a pair head (about half the valid entries) reads
// perm[i], perm[i+1] and the two payloads (random sectors).  Its bytes are the word (8 per entry),
// those sectors and succ written once (16 per k-mer); its bins write 8
// bytes a word into succ's own slots and the windows read them back.  In
// the global mode junction_words reads a
// validity byte per received slot and (K+1)*8 bytes per valid one, and
// writes (ceil(K/2)+1)*8 per valid one; junction_edges reads the sorted word (8 per entry; a lower word through
// perm, a random sector, only where top words tie) and a pair head's perm
// and payload sectors, and writes 25 bytes per entry (ok, src, dst,
// owner), which the router reads next; junction_scatter must read a
// validity byte a received slot and 16 bytes a valid edge and write the
// table once: its bins read each edge's source twice and its target once
// and write 10 bytes an edge into the table's own slots and a u16 array
// (kept in L2 while a window's bin fills), and its windows read those
// back and write every slot once.
#include "common.cuh"
#include "hash.cuh"
#include "lookback.cuh"

namespace {

constexpr uint32_t kRoleShift = 30;
constexpr uint32_t kOidMask = (1u << 30) - 1u;

// models.lanes.pack_keys of the u32 key rows r, r+1: ((hi - 2^31) << 32)
// | lo, an odd last row alone.
__device__ __forceinline__ long long pack_word(unsigned long long hi,
                                               unsigned long long lo,
                                               bool pair) {
  return pair ? static_cast<long long>(((hi ^ 0x80000000ull) << 32) | lo)
              : static_cast<long long>(hi);
}

// Whether sorted entries a and b, whose top words are equal, agree on the
// nl lower words of their keys: row j of `lower` (stride lstride, entry
// order) holds word j + 1, read through perm one word at a time, so that
// no key is held in registers.  The pair rule of junction_pairs and of
// junction_edges.
__device__ __forceinline__ bool lower_equal(const int64_t* __restrict__ lower,
                                            long long lstride, int nl,
                                            const int64_t* __restrict__ perm,
                                            long long a, long long b) {
  if (nl == 0) return true;
  const long long pa = perm[a], pb = perm[b];
  bool eq = true;
  for (int j = 0; j < nl && eq; ++j) {
    eq = lower[j * lstride + pa] == lower[j * lstride + pb];
  }
  return eq;
}

// The suffix and prefix (k-1)-mers of solid k-mer i (right-aligned in L
// lanes, zeros above), their reverse complements, the strands that make
// them canonical (sig, tau: the reverse complement is smaller) and their
// palindrome flags.
template <int L>
struct Sides {
  uint32_t suf[L], pre[L], suf_rc[L], pre_rc[L];
  bool sig, tau, suf_pal, pre_pal;
};

template <int L>
__device__ __forceinline__ void load_sides(const int64_t* solid,
                                           long long stride, long long i,
                                           int m, int lanes, Sides<L>& s) {
  const int off = L - (m + 15) / 16;  // lanes above the (k-1)-mer
  const int pad = L - bt::live_lanes<L>(lanes);  // zero lanes above the k-mer
#pragma unroll
  for (int j = 0; j < L; ++j) {
    s.suf[j] = s.pre[j] =
        j < pad ? 0u : static_cast<uint32_t>(solid[(j - pad) * stride + i]);
  }
  bt::shr2<L>(s.pre);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (j < off) s.suf[j] = s.pre[j] = 0u;
    else if (j == off) s.suf[j] &= bt::top_mask(m);
  }
  bt::revcomp_field<L>(s.suf, m, s.suf_rc);
  bt::revcomp_field<L>(s.pre, m, s.pre_rc);
  s.sig = bt::less<L>(s.suf_rc, s.suf);
  s.tau = bt::less<L>(s.pre_rc, s.pre);
  s.suf_pal = s.pre_pal = m % 2 == 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    s.suf_pal &= s.suf[j] == s.suf_rc[j];
    s.pre_pal &= s.pre[j] == s.pre_rc[j];
  }
}

template <int L>
__global__ void junction_keys_kernel(const int64_t* __restrict__ solid,
                                     long long stride, long long C,
                                     long long n_solid, int k, int packed,
                                     int64_t* __restrict__ keys,
                                     long long kstride,
                                     int64_t* __restrict__ payload, int lanes) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int m = k - 1;
  const int off = L - (m + 15) / 16;  // lanes above the (k-1)-mer
  Sides<L> s;
  load_sides<L>(solid, stride, i, m, lanes, s);
  const bool sig = s.sig, tau = s.tau;
  bool valid = i < n_solid;
  bool vs = valid && !s.suf_pal, vp = valid && !s.pre_pal;
  long long oid_s = sig ? i + C : i, oid_p = tau ? i + C : i;
  payload[i] = oid_s | (static_cast<long long>(sig ? 1 : 0) << kRoleShift);
  payload[C + i] = oid_p | (static_cast<long long>(tau ? 0 : 1) << kRoleShift);
  // key row r = j - off: lane r, or with packed, word r / 2 holds lanes
  // r and r + 1 (hs, hp keep the even lane until its partner comes)
  uint32_t hs = 0u, hp = 0u;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (j < off) continue;
    const int r = j - off;
    const uint32_t sc = vs ? (sig ? s.suf_rc[j] : s.suf[j]) : bt::kSentinel;
    const uint32_t pc = vp ? (tau ? s.pre_rc[j] : s.pre[j]) : bt::kSentinel;
    if (!packed) {
      keys[r * kstride + i] = sc;
      keys[r * kstride + C + i] = pc;
    } else if (r % 2 == 0 && j + 1 < L) {
      hs = sc;
      hp = pc;
    } else {
      const bool pair = r % 2 == 1;
      keys[(r / 2) * kstride + i] = pack_word(pair ? hs : sc, sc, pair);
      keys[(r / 2) * kstride + C + i] = pack_word(pair ? hp : pc, pc, pair);
    }
  }
}

template <int L>
void launch_keys(const int64_t* solid, long long stride, long long C,
                 long long n_solid, int k, int packed, int64_t* keys,
                 long long kstride, int64_t* payload, int lanes,
                 cudaStream_t s) {
  junction_keys_kernel<L><<<bt::blocks_for(C), bt::kThreads, 0, s>>>(
      solid, stride, C, n_solid, k, packed, keys, kstride, payload, lanes);
}

// Entries per junction_edges block: kPairItems per thread, item q of
// thread t being entry base + q * kThreads + t (coalesced per warp).
constexpr int kPairItems = 4;
constexpr int kPairTile = bt::kThreads * kPairItems;

template <int L>
__global__ void junction_entries_kernel(
    const int64_t* __restrict__ solid, long long stride, long long N,
    long long n_local, int k, long long gbase, long long tot, int n_dev,
    int64_t* __restrict__ keys, long long kstride, int64_t* __restrict__ payload,
    int64_t* __restrict__ owner, uint8_t* __restrict__ valid_out, int lanes) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int m = k - 1;
  const int off = L - (m + 15) / 16;
  const int r = m % 16 == 0 ? 16 : m % 16;
  const bool folded = r < 16;
  Sides<L> s;
  load_sides<L>(solid, stride, i, m, lanes, s);
  const bool sig = s.sig, tau = s.tau, suf_pal = s.suf_pal,
             pre_pal = s.pre_pal;
  const bool valid = i < n_local;
  const long long g = gbase + i;
  // (side, strand, oid, role) of the four entries, as _local_succ_shard
  const uint32_t strand[4] = {suf_pal ? 0u : (sig ? 1u : 0u),
                              suf_pal ? 0u : (sig ? 0u : 1u),
                              pre_pal ? 0u : (tau ? 1u : 0u),
                              pre_pal ? 0u : (tau ? 0u : 1u)};
  const long long oid[4] = {g, g + tot, g, g + tot};
  const long long role[4] = {0, 1, 1, 0};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool is_suf = e < 2;
    long long col = e * N + i;
    uint32_t h = bt::kHashSeed;
    int row = 0;
    if (!folded) {
      uint32_t v = valid ? strand[e] : bt::kSentinel;
      keys[col] = v;
      h = bt::hash_step(h, v);
      row = 1;
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (j < off) continue;
      uint32_t c = is_suf ? (sig ? s.suf_rc[j] : s.suf[j])
                          : (tau ? s.pre_rc[j] : s.pre[j]);
      if (folded && j == off) c |= strand[e] << (2 * r);
      uint32_t v = valid ? c : bt::kSentinel;
      keys[row * kstride + col] = v;
      h = bt::hash_step(h, v);
      ++row;
    }
    payload[col] = oid[e] | (role[e] << kRoleShift);
    owner[col] = h % static_cast<uint32_t>(n_dev);
    valid_out[col] = valid;
  }
}

template <int L>
void launch_entries(const int64_t* solid, long long stride, long long N,
                    long long n_local, int k, long long gbase, long long tot,
                    int n_dev, int64_t* keys, long long kstride,
                    int64_t* payload, int64_t* owner, uint8_t* valid,
                    int lanes, cudaStream_t s) {
  junction_entries_kernel<L><<<bt::blocks_for(N), bt::kThreads, 0, s>>>(
      solid, stride, N, n_local, k, gbase, tot, n_dev, keys, kstride, payload,
      owner, valid, lanes);
}

// The compaction in front of the sort: one block a tile of kWordsTile
// received slots from the ticket, item q of thread t being slot tile *
// kWordsTile + q * kThreads + t; select_ranks (lookback.cuh) gives each
// valid slot its rank among the valid slots of all tiles, in receive
// order, and the slot's key rows are packed into the sort words and its
// payload moved to that rank.  Only a valid slot's rows are read.
constexpr int kWordsItems = 16;
constexpr long long kWordsTile = bt::kThreads * kWordsItems;  // 4096 slots

__global__ void __launch_bounds__(bt::kThreads)
junction_words_kernel(const int64_t* __restrict__ rows, long long rstride,
                      int K, const uint8_t* __restrict__ valid, long long E,
                      unsigned long long* __restrict__ next_tile,
                      unsigned long long* __restrict__ status,
                      int64_t* __restrict__ words, long long wstride,
                      int64_t* __restrict__ payload,
                      int64_t* __restrict__ n_out) {
  const long long tile = take_tile(next_tile);
  const long long first = tile * kWordsTile + threadIdx.x;
  bool keep[kWordsItems];
#pragma unroll
  for (int q = 0; q < kWordsItems; ++q) {
    const long long i = first + q * bt::kThreads;
    keep[q] = i < E && valid[i] != 0;
  }
  long long dest[kWordsItems];
  const long long total = select_ranks<kWordsItems>(keep, tile, status, dest);
  if (threadIdx.x == 0 && tile == (E - 1) / kWordsTile) n_out[0] = total;
  for (int r = 0; r < K; r += 2) {
    const bool pair = r + 1 < K;
#pragma unroll
    for (int q = 0; q < kWordsItems; ++q) {
      if (dest[q] < 0) continue;
      const long long i = first + q * bt::kThreads;
      const unsigned long long hi = rows[r * rstride + i];
      const unsigned long long lo = pair ? rows[(r + 1) * rstride + i] : 0ull;
      words[(r / 2) * wstride + dest[q]] = pack_word(hi, lo, pair);
    }
  }
#pragma unroll
  for (int q = 0; q < kWordsItems; ++q) {
    if (dest[q] >= 0) payload[dest[q]] = rows[K * rstride + first + q * bt::kThreads];
  }
}

// One block a tile of kPairTile sorted entries.  Slot j of the shared
// tile holds the top word of entry base - 1 + j (j < kPairTile + 3), and
// eqn[j] whether that entry's key equals the next one's (both < E): the
// top words, then the W - 1 lower words of the two through perm, read only
// where the top words are equal.
__global__ void __launch_bounds__(bt::kThreads)
junction_edges_kernel(const int64_t* __restrict__ top,
                      const int64_t* __restrict__ perm,
                      const int64_t* __restrict__ words, long long wstride,
                      int W, const int64_t* __restrict__ pay, long long E,
                      long long tot, long long slot_cap, int shift,
                      long long sent_hi, uint8_t* __restrict__ ok,
                      int64_t* __restrict__ edges,
                      int64_t* __restrict__ owner) {
  __shared__ long long s0[kPairTile + 3];
  __shared__ uint8_t eqn[kPairTile + 2];
  const long long base = static_cast<long long>(blockIdx.x) * kPairTile;
  for (int j = threadIdx.x; j < kPairTile + 3; j += bt::kThreads) {
    const long long e = base - 1 + j;
    s0[j] = (e >= 0 && e < E) ? top[e] : 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kPairTile + 2; j += bt::kThreads) {
    const long long e = base - 1 + j;
    bool eq = e >= 0 && e + 1 < E && s0[j] == s0[j + 1];
    if (eq) eq = lower_equal(words + wstride, wstride, W - 1, perm, e, e + 1);
    eqn[j] = eq;
  }
  __syncthreads();
  bool head[kPairItems];
  long long pa[kPairItems], pb[kPairItems];
#pragma unroll
  for (int q = 0; q < kPairItems; ++q) {
    const int j = q * bt::kThreads + threadIdx.x + 1;  // slot of entry i
    const long long i = base + j - 1;
    head[q] = i < E && (s0[j] >> shift) != sent_hi && eqn[j] && !eqn[j - 1] &&
              !eqn[j + 1];
  }
  // only a pair head reads the permutation and the two payloads
#pragma unroll
  for (int q = 0; q < kPairItems; ++q) {
    if (!head[q]) continue;
    const long long i = base + q * bt::kThreads + threadIdx.x;
    pa[q] = perm[i];
    pb[q] = perm[i + 1];
  }
#pragma unroll
  for (int q = 0; q < kPairItems; ++q) {
    if (!head[q]) continue;
    pa[q] = pay[pa[q]];
    pb[q] = pay[pb[q]];
  }
#pragma unroll
  for (int q = 0; q < kPairItems; ++q) {
    const long long i = base + q * bt::kThreads + threadIdx.x;
    if (i >= E) continue;
    long long src = -1, dst = -1, own = 0;
    bool edge = false;
    if (head[q]) {
      const long long role_a = pa[q] >> kRoleShift, role_b = pb[q] >> kRoleShift;
      const long long oid_a = pa[q] & kOidMask, oid_b = pb[q] & kOidMask;
      const long long vert_a = oid_a >= tot ? oid_a - tot : oid_a;
      const long long vert_b = oid_b >= tot ? oid_b - tot : oid_b;
      edge = role_a != role_b && vert_a != vert_b;
      if (edge) {
        src = role_a == 0 ? oid_a : oid_b;
        dst = role_a == 0 ? oid_b : oid_a;
        own = (src >= tot ? src - tot : src) / slot_cap;
      }
    }
    ok[i] = edge;
    edges[i] = src;
    edges[E + i] = dst;
    owner[i] = own;
  }
}

// The successor shard's scatter, by windows of kWin table slots.  Every
// oriented node has one out-end, so no two edges name one slot and a
// window receives at most its own width of edges: window w's bin is the
// table's own slots [w * kWin, w * kWin + width).  An edge (a, b) whose
// local id `at` lies in the table enters its window's bin as one word,
// b << kWinShift | (at's offset in the window).
// scatter_bin_kernel: a block stages the edges of up to kStageWin windows
// (blockIdx.y picks which; a table of more windows costs a pass over the
// edge source for each kStageWin of them) in shared memory, kStageCap
// words a window, while it walks the tiles of kBinThreads * kItems items
// of its edge source (ReceivedEdges: the received slots; PairEdges: the
// sorted entries, one edge and its mirror a pair head) blockIdx.x,
// blockIdx.x + gridDim.x, ... (item q of thread t: item q * kBinThreads +
// t); after each tile it moves every window's whole
// 32-byte groups of 4 words to the bottom of the window's bin (one global
// atomic on the window's bottom count, 16-byte stores: whole sectors,
// never a part of one) and keeps the rest (at most 3) for the next tile.
// Its last words, and an edge that finds its window's stage full, go to
// the top of the bin (the top count, from the bin's end downwards), so
// that every bottom group stays sector-aligned.  The order inside a bin
// is the atomics', which no output depends on.
// scatter_window_kernel, one block a window: it loads the bin's words
// (the bottom count's, then the top count's) into registers, sets the
// window's image in shared memory to -1, stores each word's b at its
// offset there, and writes the image over the window's slots as whole
// 16-byte vectors: the table is written once more, in whole sectors, and
// no memset runs before.
constexpr int kWinShift = 14;
constexpr long long kWin = 1LL << kWinShift;   // 16384 slots, 128 KB
constexpr int kWinThreads = 1024;
constexpr int kWinItems = static_cast<int>(kWin / kWinThreads);
constexpr int kBinThreads = 1024;
constexpr int kBinItems = 4;
constexpr int kStageWin = 1024;
constexpr int kStageCap = 16;   // words a window: 128 KB of stage a block
constexpr size_t kStageBytes =
    kStageWin * kStageCap * sizeof(long long) + kStageWin * sizeof(int);

// The local oriented id of edge source a, or -1 where it is outside the
// table of T = 2 * slot_cap slots.
__device__ __forceinline__ long long local_id(long long a, long long tot,
                                              long long base,
                                              long long slot_cap, long long T) {
  const long long slot = (a >= tot ? a - tot : a) - base;
  const long long at = a >= tot ? slot + slot_cap : slot;
  return at >= 0 && at < T ? at : -1;
}

// The width of window w of a table of T slots.
__device__ __forceinline__ long long win_width(long long w, long long T) {
  const long long rest = T - (w << kWinShift);
  return rest < kWin ? rest : kWin;
}

// The edges of junction_scatter: received slot i holds edge (edges[i],
// edges[R + i]) where ev[i] is set; at is its source's local id.
struct ReceivedEdges {
  static constexpr int kItems = kBinItems;   // items a thread
  static constexpr int kPer = 1;             // edges an item
  const int64_t* edges;
  const uint8_t* ev;
  long long R, tot, base, slot_cap, T;

  template <int Q>
  __device__ __forceinline__ void load(long long first,
                                       long long (&at)[Q][kPer],
                                       long long (&b)[Q][kPer]) const {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const long long i = first + q * kBinThreads;
      at[q][0] = i < R && ev[i] ? 0 : -1;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (at[q][0] < 0) continue;
      const long long i = first + q * kBinThreads;
      at[q][0] = local_id(edges[i], tot, base, slot_cap, T);
      b[q][0] = edges[R + i];
    }
  }
};

// The edges of junction_pairs, found on the sort's own output: sorted
// entry i is a pair head when its key is valid and equals entry i+1's
// and neither i-1's nor i+2's; a head's two payloads (through perm) give
// the edge src -> dst (one OUT and one IN on distinct vertices) and its
// mirror mirror(dst) -> mirror(src); at is the oriented id itself (the
// table is the whole 2C successor array).  Neighbouring top words come by
// shuffle, a warp's edge entries from memory.  kWords: 1, 2 (the second
// word read through perm and shuffled like the first) or 0, a key of nl + 1
// >= 3 words, whose lower words lower_equal reads through perm where two
// neighbours' top words tie.
template <int kWords>
struct PairEdges {
  // 2 items a thread: at 4 the pair rule's registers spilled under the
  // bin kernel's 64-register cap (0.63 against 0.48 device ms on an H100
  // SXM, 16.8 M entries)
  static constexpr int kItems = 2;
  static constexpr int kPer = 2;
  const int64_t* w0;
  const int64_t* lower;   // the key's words 1.. in entry order
  long long lstride;
  int nl;
  const int64_t* perm;
  const int64_t* pay;
  long long E, C, sent_hi;
  int shift;
  int last_sent;  // packed keys (past 3 lanes): the last lane decides too

  __device__ __forceinline__ long long second(long long e) const {
    if constexpr (kWords == 2) return lower[perm[e]];
    else return 0;
  }

  // entries e and e+1, whose top (and second) words are equal, agree on
  // the rest of their keys
  __device__ __forceinline__ bool rest_equal(long long e) const {
    if constexpr (kWords == 0) return lower_equal(lower, lstride, nl, perm, e, e + 1);
    else return true;
  }

  // entry i, whose top words are x and x1, is the sentinel: its first
  // lane is, and with last_sent its last lane too (a valid canonical key
  // whose first lane is 16 G ends in 16 C).  The last word is read
  // through perm only where the first lane reads as the sentinel.
  __device__ __forceinline__ bool sentinel(long long i, long long x,
                                           long long x1) const {
    if ((x >> shift) != sent_hi) return false;
    // a packed key has two words or more: one word is always a key of at
    // most 2 lanes
    if constexpr (kWords == 1) return true;
    if (!last_sent) return true;
    const long long last =
        kWords == 2 ? x1 : lower[(nl - 1) * lstride + perm[i]];
    return (last & 0xFFFFFFFFll) == 0xFFFFFFFFll;
  }

  template <int Q>
  __device__ __forceinline__ void load(long long first,
                                       long long (&at)[Q][kPer],
                                       long long (&b)[Q][kPer]) const {
    const int lane = threadIdx.x & 31;
    long long x0[Q], x1[Q];  // entry i's top words
    long long n0[Q], n1[Q];  // lane 0: entry i-1's; lane 31: entry i+1's
    long long m0[Q], m1[Q];  // lane 31: entry i+2's
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const long long i = first + q * kBinThreads;
      const long long e = lane == 0 ? i - 1 : i + 1;
      const bool edge = (lane == 0 || lane == 31) && e >= 0 && e < E;
      x0[q] = i < E ? w0[i] : 0;
      n0[q] = edge ? w0[e] : 0;
      m0[q] = lane == 31 && i + 2 < E ? w0[i + 2] : 0;
      x1[q] = n1[q] = m1[q] = 0;
      if constexpr (kWords == 2) {
        if (i < E) x1[q] = second(i);
        if (edge) n1[q] = second(e);
        if (lane == 31 && i + 2 < E) m1[q] = second(i + 2);
      }
    }
    bool head[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const long long i = first + q * kBinThreads;
      // eqn: entry i equals entry i+1 (both exist)
      long long y0 = __shfl_down_sync(0xFFFFFFFFu, x0[q], 1);
      long long y1 = __shfl_down_sync(0xFFFFFFFFu, x1[q], 1);
      if (lane == 31) {
        y0 = n0[q];
        y1 = n1[q];
      }
      const bool eqn = i + 1 < E && x0[q] == y0 && x1[q] == y1 && rest_equal(i);
      bool eqp = __shfl_up_sync(0xFFFFFFFFu, eqn, 1);      // i-1 equals i
      bool eqnn = __shfl_down_sync(0xFFFFFFFFu, eqn, 1);   // i+1 equals i+2
      if (lane == 0) {
        eqp = i > 0 && i < E && n0[q] == x0[q] && n1[q] == x1[q] &&
              rest_equal(i - 1);
      }
      if (lane == 31) {
        eqnn = i + 2 < E && n0[q] == m0[q] && n1[q] == m1[q] && rest_equal(i + 1);
      }
      head[q] = eqn && !eqp && !eqnn && !sentinel(i, x0[q], x1[q]);
    }
    // only a pair head reads the permutation and the two payloads
    long long pa[Q], pb[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const long long i = first + q * kBinThreads;
      if (head[q]) {
        pa[q] = perm[i];
        pb[q] = perm[i + 1];
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (head[q]) {
        pa[q] = pay[pa[q]];
        pb[q] = pay[pb[q]];
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      at[q][0] = at[q][1] = -1;
      if (!head[q]) continue;
      const long long role_a = pa[q] >> kRoleShift, role_b = pb[q] >> kRoleShift;
      const long long oid_a = pa[q] & kOidMask, oid_b = pb[q] & kOidMask;
      const long long vert_a = oid_a >= C ? oid_a - C : oid_a;
      const long long vert_b = oid_b >= C ? oid_b - C : oid_b;
      if (role_a == role_b || vert_a == vert_b) continue;
      const long long src = role_a == 0 ? oid_a : oid_b;
      const long long dst = role_a == 0 ? oid_b : oid_a;
      at[q][0] = src;
      b[q][0] = dst;
      at[q][1] = dst >= C ? dst - C : dst + C;
      b[q][1] = src >= C ? src - C : src + C;
    }
  }
};

template <class Edges>
__global__ void __launch_bounds__(kBinThreads)
scatter_bin_kernel(Edges src, long long R, long long T, long long nwin,
                   int* __restrict__ bottom, int* __restrict__ top,
                   int64_t* __restrict__ table) {
  constexpr int kQ = Edges::kItems, kPer = Edges::kPer;
  constexpr long long kTileN = static_cast<long long>(kBinThreads) * kQ;
  extern __shared__ long long s_stage[];   // kStageWin x kStageCap words
  int* s_len = reinterpret_cast<int*>(s_stage + kStageWin * kStageCap);
  const long long w_lo = static_cast<long long>(blockIdx.y) * kStageWin;
  const int n_w = static_cast<int>(nwin - w_lo < kStageWin ? nwin - w_lo
                                                           : kStageWin);
  for (int w = threadIdx.x; w < n_w; w += kBinThreads) s_len[w] = 0;
  __syncthreads();
  const long long tiles = (R + kTileN - 1) / kTileN;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long first = tile * kTileN + threadIdx.x;
    long long at[kQ][kPer], b[kQ][kPer];
    src.template load<kQ>(first, at, b);
    bool any = false;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const long long w = at[q][e] >> kWinShift;
        if (at[q][e] >= 0 && (w < w_lo || w >= w_lo + n_w)) at[q][e] = -1;
        any |= at[q][e] >= 0;
      }
    }
    if (!__syncthreads_or(any)) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (at[q][e] < 0) continue;
        const long long word = static_cast<long long>(
            (static_cast<unsigned long long>(b[q][e]) << kWinShift) |
            static_cast<unsigned long long>(at[q][e] & (kWin - 1)));
        const long long gw = at[q][e] >> kWinShift;
        const int w = static_cast<int>(gw - w_lo);
        const int r = atomicAdd(&s_len[w], 1);
        if (r < kStageCap) {
          s_stage[w * kStageCap + r] = word;
        } else {   // the stage is full: straight to the top of the bin
          const long long pos = win_width(gw, T) - 1 - atomicAdd(&top[gw], 1);
          if (pos >= 0) table[(gw << kWinShift) + pos] = word;
        }
      }
    }
    __syncthreads();
    for (int w = threadIdx.x; w < n_w; w += kBinThreads) {
      const int len = s_len[w] < kStageCap ? s_len[w] : kStageCap;
      const int m = len & ~3;
      long long* st = s_stage + w * kStageCap;
      if (m) {
        const long long gw = w_lo + w;
        const long long p = atomicAdd(&bottom[gw], m);
        if (p + m <= win_width(gw, T)) {
          auto* dst = reinterpret_cast<longlong2*>(table + (gw << kWinShift) + p);
          const auto* src2 = reinterpret_cast<const longlong2*>(st);
          for (int j = 0; j < m / 2; ++j) dst[j] = src2[j];
        }
        for (int j = m; j < len; ++j) st[j - m] = st[j];
      }
      s_len[w] = len - m;
    }
    __syncthreads();
  }
  // the words left in the stage: to the top of their bins
  for (int w = threadIdx.x; w < n_w; w += kBinThreads) {
    const int len = s_len[w];
    if (!len) continue;
    const long long gw = w_lo + w;
    const long long end = win_width(gw, T) - atomicAdd(&top[gw], len);
    for (int j = 0; j < len; ++j) {
      if (end - 1 - j >= 0) {
        table[(gw << kWinShift) + end - 1 - j] = s_stage[w * kStageCap + j];
      }
    }
  }
}

__global__ void __launch_bounds__(kWinThreads)
scatter_window_kernel(const int* __restrict__ bottom,
                      const int* __restrict__ top,
                      int64_t* __restrict__ table, long long T) {
  extern __shared__ long long s_img[];   // kWin slots
  const long long w0 = static_cast<long long>(blockIdx.x) << kWinShift;
  const int width = static_cast<int>(win_width(blockIdx.x, T));
  const int n_lo = bottom[blockIdx.x] < width ? bottom[blockIdx.x] : width;
  const int n_hi =
      top[blockIdx.x] < width - n_lo ? top[blockIdx.x] : width - n_lo;
  long long v[kWinItems];
  bool has[kWinItems];
#pragma unroll
  for (int j = 0; j < kWinItems; ++j) {
    const int e = j * kWinThreads + threadIdx.x;
    has[j] = e < n_lo || (e >= width - n_hi && e < width);
    if (has[j]) v[j] = table[w0 + e];
  }
  auto* img2 = reinterpret_cast<longlong2*>(s_img);
  for (int j = threadIdx.x; j < kWin / 2; j += kWinThreads) {
    img2[j] = make_longlong2(-1, -1);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kWinItems; ++j) {
    if (has[j]) s_img[v[j] & (kWin - 1)] = v[j] >> kWinShift;
  }
  __syncthreads();
  if (width == kWin) {
    auto* out2 = reinterpret_cast<longlong2*>(table + w0);
    for (int j = threadIdx.x; j < kWin / 2; j += kWinThreads) out2[j] = img2[j];
  } else {
    for (int j = threadIdx.x; j < width; j += kWinThreads) table[w0 + j] = s_img[j];
  }
}

// The T-slot table of the edges of src's R items, by windows: the memset
// of the windows' counts (2 * ceil(T / kWin) ints: each window's bottom
// and top count), the bins, the windows.  Every slot is written.
template <class Edges>
int scatter_windows(const Edges& src, long long R, long long T, int* counts,
                    int64_t* table, cudaStream_t s) {
  if (T == 0) return 0;
  if (T > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long nwin = (T + kWin - 1) / kWin;
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * nwin * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      (R + kBinThreads * Edges::kItems - 1) / (kBinThreads * Edges::kItems);
  if (tiles > 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(scatter_bin_kernel<Edges>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kStageBytes));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned int>(tiles < sms ? tiles : sms),
                    static_cast<unsigned int>((nwin + kStageWin - 1) / kStageWin));
    scatter_bin_kernel<Edges><<<grid, kBinThreads, kStageBytes, s>>>(
        src, R, T, nwin, counts, counts + nwin, table);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int smem = static_cast<int>(kWin * sizeof(long long));
  err = cudaFuncSetAttribute(scatter_window_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_window_kernel<<<static_cast<unsigned int>(nwin), kWinThreads, smem,
                          s>>>(counts, counts + nwin, table, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bt_junction_keys(const int64_t* solid, long long stride,
                                long long C, long long n_solid, int L, int k,
                                int packed, int64_t* keys, long long kstride,
                                int64_t* payload, void* stream) {
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BT_DISPATCH_LANES(L, launch_keys, solid, stride, C, n_solid, k, packed,
                    keys, kstride, payload, L, s);
  return static_cast<int>(cudaGetLastError());
}

// succ: 2C slots, every one written (-1 where no edge lands); counts:
// 2 * ceil(2C / 16384) ints of scratch (scatter_windows).  lower: the
// key's nl lower words (row stride lstride, entry order), null when the
// key is one word.  A key is a sentinel when w0 >> shift == sent_hi and,
// with last_sent, its last lane (the low half of its last word) is too.
// Three device operations: the memset of the counts, the pair rule with
// its bins, the windows.
extern "C" int bt_junction_pairs(const int64_t* w0, const int64_t* lower,
                                 long long lstride, int nl,
                                 const int64_t* perm, const int64_t* pay,
                                 long long E, long long C, long long sent_hi,
                                 int shift, int last_sent, int* counts,
                                 int64_t* succ, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long R = E < 2 ? 0 : E;   // a pair needs two entries
  if (nl == 0) {
    const PairEdges<1> src{w0, lower, lstride, nl, perm, pay, E, C, sent_hi,
                           shift, last_sent};
    return scatter_windows(src, R, 2 * C, counts, succ, s);
  }
  if (nl == 1) {
    const PairEdges<2> src{w0, lower, lstride, nl, perm, pay, E, C, sent_hi,
                           shift, last_sent};
    return scatter_windows(src, R, 2 * C, counts, succ, s);
  }
  const PairEdges<0> src{w0, lower, lstride, nl, perm, pay, E, C, sent_hi,
                         shift, last_sent};
  return scatter_windows(src, R, 2 * C, counts, succ, s);
}

// keys (K rows, stride kstride) and payload: the (K+1, 4N) stack; valid:
// 4N bytes.
extern "C" int bt_junction_entries(const int64_t* solid, long long stride,
                                   long long N, long long n_local, int L, int k,
                                   long long gbase, long long tot, int n_dev,
                                   int64_t* keys, long long kstride,
                                   int64_t* payload, int64_t* owner,
                                   uint8_t* valid, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BT_DISPATCH_LANES(L, launch_entries, solid, stride, N, n_local, k, gbase,
                    tot, n_dev, keys, kstride, payload, owner, valid, L, s);
  return static_cast<int>(cudaGetLastError());
}

// rows: the K key rows and the payload row (stride rstride); valid: E
// bytes; scratch: 2 + ceil(E / 4096) zeroed words ([0] receives the valid
// count n, [1] the tile counter, [2:] one status word per tile); words:
// ceil(K/2) rows of stride wstride and payload, each written at [0, n).
extern "C" int bt_junction_words(const int64_t* rows, long long rstride,
                                 int K, const uint8_t* valid, long long E,
                                 long long* scratch, int64_t* words,
                                 long long wstride, int64_t* payload,
                                 void* stream) {
  if (E == 0) return 0;
  auto* w = reinterpret_cast<unsigned long long*>(scratch);
  const long long tiles = (E + kWordsTile - 1) / kWordsTile;
  junction_words_kernel<<<static_cast<unsigned int>(tiles), bt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      rows, rstride, K, valid, E, w + 1, w + 2, words, wstride, payload,
      reinterpret_cast<int64_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// words: W rows of stride wstride, E entries each, in entry order (row
// 0, the top word, is read sorted from `top`); edges: (2, E).
extern "C" int bt_junction_edges(const int64_t* top, const int64_t* perm,
                                 const int64_t* words, long long wstride,
                                 int W,
                                 const int64_t* pay, long long E,
                                 long long tot, long long slot_cap, int shift,
                                 long long sent_hi, uint8_t* ok,
                                 int64_t* edges, int64_t* owner,
                                 void* stream) {
  if (E == 0) return 0;
  const unsigned int grid =
      static_cast<unsigned int>((E + kPairTile - 1) / kPairTile);
  junction_edges_kernel<<<grid, bt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      top, perm, words, wstride, W, pay, E, tot, slot_cap, shift, sent_hi, ok,
      edges, owner);
  return static_cast<int>(cudaGetLastError());
}

// edges: (2, R) received, ev: R bytes; table: 2 * slot_cap slots, every
// one written; counts: 2 * ceil(2 * slot_cap / 16384) ints of scratch,
// each window's bottom and top count (zeroed here).  A target b must lie
// in [-2^49, 2^49) (an oriented id always does).  Three device
// operations: the memset of the counts, the bins, the windows.
extern "C" int bt_junction_scatter(const int64_t* edges, const uint8_t* ev,
                                   long long R, long long tot, long long base,
                                   long long slot_cap, int* counts,
                                   int64_t* table, void* stream) {
  const long long T = 2 * slot_cap;
  const ReceivedEdges src{edges, ev, R, tot, base, slot_cap, T};
  return scatter_windows(src, R, T, counts, table,
                         static_cast<cudaStream_t>(stream));
}
