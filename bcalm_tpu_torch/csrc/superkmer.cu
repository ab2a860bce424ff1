// K13 form_superkmers and K14 mmer_histograms: minimizer windows of packed
// reads.
//
// K13 replaces bcalm_tpu/ops/superkmer.py:form_superkmers (with
// canonical_mmers :74 and window_min_keys :85); K14 replaces
// sample_cmmer_histogram :194 and sample_minimizer_load :211.
//
// Every position p of a read row of P = 16W positions gets its canonical
// m-mer (each m-mer canonicalized on its own; bases past the row's end
// are the row's first bases again, which is what the JAX version's rolled
// window packs read), its key (the frequency rank, or the m-mer) and the
// minimum key of its window [p, p + k - m + 1).  K13 then needs two scans
// along the row: a prefix max of the run-change positions (position
// within the run, for the span cuts) and a suffix min of the run
// terminators (the run's end, for the span).  Each position writes Wn
// packed words (16-base packs at p + 16w, the span in the low bits of the
// last), an optional stream-slot word, its owner (table[window key]) and
// its start flag, at column b*P + p, so the layout is the JAX version's.
//
// K13 is bound on this card by its launch path at the -devices rounds'
// size (1,024 rows of 160 positions), then by its dependent steps per
// row; the bytes (Wn + 2) * 8 + 1 written per position, and the table and
// rank lookups, which stay in L2, are far below either.  So a warp takes
// a row, and a block takes up to 8 rows.  The row's W words sit in shared
// memory followed by the wrapped copy of its first words that the rolled
// packs read past the row's end, so a 16-base pack at any base offset is
// one __funnelshift_l of two neighbouring words (no per-base modulo), and
// the reverse complement is a __brev.  The window minimum is van Herk /
// Gil-Werman's: prefix and suffix minima over segments of k - m + 1 keys
// (a lane a segment), two reads per position.  Lane l holds positions
// i*32 + l, so every store of a row is 32 neighbouring columns, and both
// scans are warp shuffles (5 steps a row of 32 positions) with a carry
// from row to row: no block barrier inside a row.  The valid k-mer count
// is an extra block's sum over the row lengths: no fill beforehand,
// one launch.
//
// K14 runs on the same row machinery: a warp a row, up to 8 rows a block,
// the row and its wrapped copy staged in shared memory, each position's
// canonical m-mer from one pack16 and canonical_of.  Its m-mer mode adds
// one to the bin of every position with a whole m-mer; its minimizer-load
// mode takes the window minima as K13 does and adds each run of equal
// minima (a superkmer's k-mers, ~(k - m + 1) / 2 of them) within a warp's
// 32 positions with one atomic of the run's length.  It adds into the
// caller's histogram (integer atomics: the sum is exact and does not
// depend on the order), so the sampling zeroes one histogram per mode and
// launches once per mode over all its rounds' rows.
#include "common.cuh"

namespace {

constexpr int kMaxRowWords = 64;  // P <= 1024 positions per row

constexpr int kRowWarps = 8;          // rows (warps) per K13 or K14 block
constexpr int kRowSmem = 40 * 1024;   // shared bytes a block gives its rows

// 16 bases starting at base q of a row staged with its wrapped copy.
__device__ __forceinline__ uint32_t pack16(const uint32_t* ext, int q) {
  return __funnelshift_l(ext[(q >> 4) + 1], ext[q >> 4], 2 * (q & 15));
}

// min(m-mer, its reverse complement) of the first m bases of a 16-base pack.
__device__ __forceinline__ uint32_t canonical_of(uint32_t v, int m) {
  const uint32_t mask = m == 16 ? 0xFFFFFFFFu : (1u << (2 * m)) - 1u;
  const uint32_t fwd = v >> (2 * (16 - m));
  // reverse the 16 bases: swap the bits of each base, reverse all 32 bits
  const uint32_t rev =
      __brev(((v >> 1) & 0x55555555u) | ((v & 0x55555555u) << 1));
  const uint32_t rc = (rev & mask) ^ (0xAAAAAAAAu & mask);
  return fwd < rc ? fwd : rc;
}

// Per-row shared words: the staged words (ext_words), the prefix minima
// and the keys, then their suffix minima (Lx = P + w - 1 each).
__host__ __device__ __forceinline__ int row_ext_words(int W, int Wn, int w) {
  const int past = Wn > (w + 15) / 16 + 1 ? Wn : (w + 15) / 16 + 1;
  return W + past + 1;
}

// Stages a row's W words in ext[0, ew), followed by the wrapped copy of
// its first words that the rolled packs read past the row's end.
__device__ __forceinline__ void stage_row(const int64_t* __restrict__ row,
                                          int W, int ew, uint32_t* ext,
                                          int lane) {
  for (int j = lane; j < ew; j += 32) {
    int jj = j;
    while (jj >= W) jj -= W;
    ext[j] = static_cast<uint32_t>(row[jj]);
  }
  __syncwarp();
}

// The key of every position q < Lx (rank[canonical m-mer], or the m-mer)
// into suf, then van Herk / Gil-Werman: pre holds the prefix minima and
// suf the suffix minima inside each segment of w_len positions, so the
// minimum of the window [p, p + w_len) is min(suf[p], pre[p + w_len - 1]).
__device__ __forceinline__ void window_minima(const uint32_t* ext, int Lx,
                                              int w_len, int m,
                                              const int64_t* __restrict__ rank,
                                              uint32_t* pre, uint32_t* suf,
                                              int lane) {
#pragma unroll 8
  for (int q = lane; q < Lx; q += 32) {
    const uint32_t cm = canonical_of(pack16(ext, q), m);
    suf[q] = rank ? static_cast<uint32_t>(__ldg(rank + cm)) : cm;
  }
  __syncwarp();
  for (int a = lane * w_len; a < Lx; a += 32 * w_len) {
    const int e = a + w_len < Lx ? a + w_len : Lx;
    // four keys loaded before each four stores: the loads need not wait
    uint32_t run = 0xFFFFFFFFu, kv[4];
    for (int x = a; x < e; x += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) kv[u] = x + u < e ? suf[x + u] : run;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        run = min(run, kv[u]);
        if (x + u < e) pre[x + u] = run;
      }
    }
    run = 0xFFFFFFFFu;
    for (int x = e - 1; x >= a; x -= 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) kv[u] = x - u >= a ? suf[x - u] : run;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        run = min(run, kv[u]);
        if (x - u >= a) suf[x - u] = run;
      }
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kRowWarps)
form_superkmers_kernel(
    const int64_t* __restrict__ words, const int64_t* __restrict__ lengths,
    int B, int W, int k, int m, const int64_t* __restrict__ table,
    const int64_t* __restrict__ rank, int max_span, int Wn, int bits,
    int with_pos, uint32_t pos_base, int64_t* __restrict__ skm,
    long long N, int64_t* __restrict__ owner, uint8_t* __restrict__ start,
    int64_t* __restrict__ n_kmers) {
  extern __shared__ uint32_t sh[];
  __shared__ long long s_n;
  const int P = 16 * W, w_len = k - m + 1, Lx = P + w_len - 1;
  const int ew = row_ext_words(W, Wn, w_len);
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + r;
  uint32_t* ext = sh + r * (ew + 2 * Lx);
  uint32_t* pre = ext + ew;   // prefix minima inside each segment
  uint32_t* suf = pre + Lx;   // keys, then suffix minima inside each segment
  if (b < B) {
    stage_row(words + static_cast<long long>(b) * W, W, ew, ext, lane);
    window_minima(ext, Lx, w_len, m, rank, pre, suf, lane);
    const int last = static_cast<int>(lengths[b]) - k;  // valid: p <= last
    auto wmin = [&](int p) { return min(suf[p], pre[p + w_len - 1]); };
    auto change_at = [&](int p, uint32_t wm) {
      return p <= last && (p == 0 || p - 1 > last || wmin(p - 1) != wm);
    };
    const long long col0 = static_cast<long long>(b) * P;
    const int n_rows = (P + 31) >> 5;
#pragma unroll 8
    for (int p = lane; p < P; p += 32) owner[col0 + p] = __ldg(table + wmin(p));
    // forward: the run start (prefix max of the change positions) -> start
    // flags
    int carry_a = 0;
#pragma unroll 2
    for (int i = 0; i < n_rows; ++i) {
      const int p = i * 32 + lane;
      const bool in = p < P;
      const uint32_t wm = in ? wmin(p) : 0u;
      const bool change = in && change_at(p, wm);
      int a = change ? p : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, a, d);
        if (lane >= d) a = max(a, y);
      }
      a = max(a, carry_a);
      carry_a = __shfl_sync(0xFFFFFFFFu, a, 31);
      if (in) {
        const int within0 = p - a;
        start[col0 + p] =
            change || (p <= last && within0 > 0 && within0 % max_span == 0);
      }
    }
    // backward: the run end (suffix min of the terminators) -> span; packs
    int carry_t = P;
#pragma unroll 2
    for (int i = n_rows - 1; i >= 0; --i) {
      const int p = i * 32 + lane;
      const bool in = p < P;
      int t = P;
      if (in && (p > last || change_at(p, wmin(p)))) t = p;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_down_sync(0xFFFFFFFFu, t, d);
        if (lane + d < 32) t = min(t, y);
      }
      t = min(t, carry_t);
      int end0 = __shfl_down_sync(0xFFFFFFFFu, t, 1);
      if (lane == 31) end0 = carry_t;
      carry_t = __shfl_sync(0xFFFFFFFFu, t, 0);
      if (in) {
        const int span = end0 - p < max_span ? end0 - p : max_span;
        const long long col = col0 + p;
        for (int v = 0; v < Wn; ++v) {
          uint32_t x = pack16(ext, p + 16 * v);
          if (v == Wn - 1) x = ((x >> bits) << bits) | static_cast<uint32_t>(span);
          skm[v * N + col] = x;
        }
        if (with_pos) skm[Wn * N + col] = pos_base + static_cast<uint32_t>(col);
      }
    }
  }
  // the last block, which holds no row: n_kmers, the valid positions of
  // every row, from the lengths
  if (blockIdx.x == gridDim.x - 1) {
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    long long n = 0;
    for (int j = threadIdx.x; j < B; j += blockDim.x) {
      const long long v = lengths[j] - k + 1;
      n += v < 0 ? 0 : v > P ? P : v;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(0xFFFFFFFFu, n, d);
    if (lane == 0 && n) atomicAdd(reinterpret_cast<unsigned long long*>(&s_n),
                                  static_cast<unsigned long long>(n));
    __syncthreads();
    if (threadIdx.x == 0) n_kmers[0] = s_n;
  }
}

// K14: a warp a row, as K13.  LOAD false: every position p <= len - m
// adds one to the bin of its canonical m-mer; true: every position p <=
// len - k adds one to the bin of its window's minimum key, one atomic per
// run of equal minima among the warp's 32 positions.
template <bool LOAD>
__global__ void __launch_bounds__(32 * kRowWarps)
mmer_histograms_kernel(const int64_t* __restrict__ words,
                       const int64_t* __restrict__ lengths, int B, int W,
                       int k, int m, const int64_t* __restrict__ rank,
                       int row_words, int64_t* __restrict__ histo) {
  extern __shared__ uint32_t sh[];
  const int P = 16 * W, w_len = k - m + 1, Lx = P + w_len - 1;
  const int ew = row_ext_words(W, 1, w_len);
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + r;
  if (b >= B) return;
  uint32_t* ext = sh + r * row_words;
  stage_row(words + static_cast<long long>(b) * W, W, ew, ext, lane);
  const long long len = lengths[b];
  unsigned long long* bins = reinterpret_cast<unsigned long long*>(histo);
  if (!LOAD) {
    const int end = static_cast<int>(min(static_cast<long long>(P), len - m + 1));
    for (int p = lane; p < end; p += 32)
      atomicAdd(bins + canonical_of(pack16(ext, p), m), 1ull);
    return;
  }
  uint32_t* pre = ext + ew;
  uint32_t* suf = pre + Lx;
  window_minima(ext, Lx, w_len, m, rank, pre, suf, lane);
  const int end = static_cast<int>(min(static_cast<long long>(P), len - k + 1));
  for (int p0 = 0; p0 < end; p0 += 32) {  // the valid positions: [0, end)
    const int p = p0 + lane;
    const bool in = p < end;
    const uint32_t wm = in ? min(suf[p], pre[p + w_len - 1]) : 0u;
    const uint32_t prev = __shfl_up_sync(0xFFFFFFFFu, wm, 1);
    const bool head = in && (lane == 0 || prev != wm);
    const unsigned heads = __ballot_sync(0xFFFFFFFFu, head);
    if (head) {
      // the run ends at the next head, or at the last valid position
      const unsigned later = lane == 31 ? 0u : heads >> (lane + 1);
      const int stop = later ? lane + __ffs(later) : min(32, end - p0);
      atomicAdd(bins + wm, static_cast<unsigned long long>(stop - lane));
    }
  }
}

}  // namespace

extern "C" int bt_form_superkmers(const int64_t* words, const int64_t* lengths,
                                  int B, int W, int k, int m,
                                  const int64_t* table, const int64_t* rank,
                                  int max_span, int Wn, int bits, int with_pos,
                                  unsigned int pos_base, int64_t* skm,
                                  int64_t* owner, uint8_t* start,
                                  int64_t* n_kmers, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || W > kMaxRowWords || m < 1 || m > 16 || k <= m || k > 512 ||
      max_span < 1 || Wn < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = 16 * W, w_len = k - m + 1;
  const size_t row_bytes =
      4 * static_cast<size_t>(row_ext_words(W, Wn, w_len) + 2 * (P + w_len - 1));
  int rows = static_cast<int>(kRowSmem / row_bytes);
  rows = rows < 1 ? 1 : rows > kRowWarps ? kRowWarps : rows;
  // one more block than the rows need: it sums the valid positions
  const unsigned int blocks = static_cast<unsigned int>((B + rows - 1) / rows + 1);
  form_superkmers_kernel<<<blocks, 32 * rows, rows * row_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      words, lengths, B, W, k, m, table, rank, max_span, Wn, bits, with_pos,
      pos_base, skm, static_cast<long long>(B) * P, owner, start, n_kmers);
  return static_cast<int>(cudaGetLastError());
}

// K14 adds into histo (4^m,); it zeroes nothing.
extern "C" int bt_mmer_histograms(const int64_t* words, const int64_t* lengths,
                                  int B, int W, int k, int m,
                                  const int64_t* rank, int load,
                                  int64_t* histo, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || W > kMaxRowWords || m < 1 || m > 16 || k <= m || k > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = 16 * W, w_len = k - m + 1;
  // the staged words, then (minimizer load) the prefix and suffix minima
  const int row_words =
      row_ext_words(W, 1, w_len) + (load ? 2 * (P + w_len - 1) : 0);
  int rows = static_cast<int>(kRowSmem / (4 * row_words));
  rows = rows < 1 ? 1 : rows > kRowWarps ? kRowWarps : rows;
  const unsigned int blocks = static_cast<unsigned int>((B + rows - 1) / rows);
  const size_t smem = static_cast<size_t>(rows) * row_words * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (load)
    mmer_histograms_kernel<true><<<blocks, 32 * rows, smem, s>>>(
        words, lengths, B, W, k, m, rank, row_words, histo);
  else
    mmer_histograms_kernel<false><<<blocks, 32 * rows, smem, s>>>(
        words, lengths, B, W, k, m, rank, row_words, histo);
  return static_cast<int>(cudaGetLastError());
}
