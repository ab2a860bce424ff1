// K13 form_superkmers and K14 mmer_histograms: minimizer windows of packed
// reads.
//
// K13 replaces bcalm_tpu/ops/superkmer.py:form_superkmers (with
// canonical_mmers :74 and window_min_keys :85); K14 replaces
// sample_cmmer_histogram :194 and sample_minimizer_load :211.
//
// One block per read row of a (B, W) block, one thread per position p of
// the row's P = 16W positions.  The row's W words sit in shared memory;
// base q of the row is read at q mod P, which is what the JAX version's
// rolled window packs read past the row's end.  Each thread builds its
// canonical m-mer (forward value and reverse complement from m bases, no
// window-pack doubling: that form exists for the TPU's vector unit), its
// key (the frequency rank, or the m-mer), and the minimum key of its
// window [p, p+k-m+1) from shared memory.  K13 then needs two scans along
// the row, done in shared memory (Hillis-Steele, log2 P steps): a prefix
// max of the run-change positions (position within the run, for the span
// cuts) and a suffix min of the run terminators (the run's end, for the
// span).  Each position writes Wn packed words (window packs at p + 16w,
// the span in the low bits of the last), an optional stream-slot word,
// its owner (table[window key]) and its start flag, at column b*P + p, so
// the layout is the JAX version's.  K14 adds one to its histogram bin per
// valid position (integer atomics: the sum is exact and deterministic).
//
// Bound: memory.  K13 writes (Wn + 1 + 1) * 8 + 1 bytes per position and
// reads 8 bytes of the table (and 8 of the rank), both of which stay in L2
// for a 4^10-entry table; the reads' own words are 8W bytes per row.  The
// shared-memory scans are ~2 * 9 steps per row, far below the stores.
// K14 reads the same and does one global atomic per position, spread over
// 4^m bins.
#include "common.cuh"

namespace {

constexpr int kMaxRowWords = 64;  // P <= 1024 positions per row

struct Row {
  const int64_t* words;
  int W, P;
};

__device__ __forceinline__ uint32_t base_at(const uint32_t* w, int P, int q) {
  q %= P;
  return (w[q >> 4] >> (2 * (15 - (q & 15)))) & 3u;
}

// 16-base window pack starting at q (wrapping mod P).
__device__ __forceinline__ uint32_t fwd_pack(const uint32_t* w, int P, int q) {
  uint32_t v = 0;
  for (int i = 0; i < 16; ++i) v = (v << 2) | base_at(w, P, q + i);
  return v;
}

__device__ __forceinline__ uint32_t canonical_mmer(const uint32_t* w, int P,
                                                   int p, int m) {
  uint32_t fwd = 0, rc = 0;
  for (int i = 0; i < m; ++i) {
    uint32_t b = base_at(w, P, p + i);
    fwd = (fwd << 2) | b;
    rc |= (b ^ 2u) << (2 * i);
  }
  return fwd < rc ? fwd : rc;
}

// Loads the row's words and every position's key into shared memory.
// Returns this thread's window-min key (only for threads p < P).
__device__ uint32_t window_key(const int64_t* words, int W, int P, int m,
                               int w_len, const int64_t* rank,
                               uint32_t* s_words, uint32_t* s_key) {
  const int p = threadIdx.x;
  for (int i = p; i < W; i += blockDim.x) {
    s_words[i] = static_cast<uint32_t>(words[static_cast<long long>(blockIdx.x) * W + i]);
  }
  __syncthreads();
  if (p < P) {
    uint32_t cm = canonical_mmer(s_words, P, p, m);
    s_key[p] = rank ? static_cast<uint32_t>(rank[cm]) : cm;
  }
  __syncthreads();
  uint32_t wmin = 0xFFFFFFFFu;
  if (p < P) {
    for (int j = 0; j < w_len; ++j) {
      uint32_t v = s_key[(p + j) % P];
      wmin = v < wmin ? v : wmin;
    }
  }
  return wmin;
}

__global__ void form_superkmers_kernel(
    const int64_t* __restrict__ words, const int64_t* __restrict__ lengths,
    int W, int k, int m, const int64_t* __restrict__ table,
    const int64_t* __restrict__ rank, int max_span, int Wn, int bits,
    int with_pos, uint32_t pos_base, int64_t* __restrict__ skm,
    long long N, int64_t* __restrict__ owner, uint8_t* __restrict__ start,
    unsigned long long* __restrict__ n_kmers) {
  extern __shared__ uint32_t sh[];
  const int P = 16 * W;
  uint32_t* s_words = sh;               // W
  uint32_t* s_key = s_words + W;        // P (keys, then window-min keys)
  int* s_a = reinterpret_cast<int*>(s_key + P);  // P (prefix max)
  int* s_t = s_a + P;                   // P (suffix min)
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_t + P);  // P
  const int p = threadIdx.x;
  const int b = blockIdx.x;
  uint32_t wmin = window_key(words, W, P, m, k - m + 1, rank, s_words, s_key);
  bool valid = p < P && p <= static_cast<int>(lengths[b]) - k;
  __syncthreads();  // every thread has read s_key
  if (p < P) {
    s_key[p] = wmin;
    s_valid[p] = valid;
  }
  __syncthreads();
  bool change = false;
  if (p < P) {
    uint32_t prev_key = p == 0 ? s_key[0] : s_key[p - 1];
    bool prev_valid = p == 0 ? false : s_valid[p - 1];
    change = valid && (!prev_valid || wmin != prev_key);
    s_a[p] = change ? p : 0;
    s_t[p] = (change || !valid) ? p : P;
  }
  __syncthreads();
  for (int d = 1; d < P; d <<= 1) {
    int a = 0, t = 0;
    if (p < P) {
      a = s_a[p];
      if (p >= d && s_a[p - d] > a) a = s_a[p - d];
      t = s_t[p];
      if (p + d < P && s_t[p + d] < t) t = s_t[p + d];
    }
    __syncthreads();
    if (p < P) {
      s_a[p] = a;
      s_t[p] = t;
    }
    __syncthreads();
  }
  int n_valid = __syncthreads_count(valid);
  if (p == 0 && n_valid) atomicAdd(n_kmers, static_cast<unsigned long long>(n_valid));
  if (p >= P) return;
  int within0 = p - s_a[p];
  bool st = change || (valid && within0 > 0 && within0 % max_span == 0);
  int end0 = p + 1 < P ? s_t[p + 1] : P;
  int span = end0 - p < max_span ? end0 - p : max_span;
  long long col = static_cast<long long>(b) * P + p;
  for (int w = 0; w < Wn; ++w) {
    uint32_t v = fwd_pack(s_words, P, p + 16 * w);
    if (w == Wn - 1) v = ((v >> bits) << bits) | static_cast<uint32_t>(span);
    skm[w * N + col] = v;
  }
  if (with_pos) skm[Wn * N + col] = pos_base + static_cast<uint32_t>(col);
  owner[col] = table[wmin];
  start[col] = st;
}

__global__ void mmer_histograms_kernel(const int64_t* __restrict__ words,
                                       const int64_t* __restrict__ lengths,
                                       int W, int k, int m,
                                       const int64_t* __restrict__ rank,
                                       int load, int64_t* __restrict__ histo) {
  extern __shared__ uint32_t sh[];
  const int P = 16 * W;
  uint32_t* s_words = sh;
  uint32_t* s_key = s_words + W;
  const int p = threadIdx.x;
  const int len = static_cast<int>(lengths[blockIdx.x]);
  if (!load) {
    // canonical m-mer histogram: every position with a whole m-mer
    for (int i = p; i < W; i += blockDim.x) {
      s_words[i] = static_cast<uint32_t>(words[static_cast<long long>(blockIdx.x) * W + i]);
    }
    __syncthreads();
    if (p < P && p <= len - m) {
      atomicAdd(reinterpret_cast<unsigned long long*>(histo) +
                    canonical_mmer(s_words, P, p, m), 1ull);
    }
    return;
  }
  uint32_t wmin = window_key(words, W, P, m, k - m + 1, rank, s_words, s_key);
  if (p < P && p <= len - k) {
    atomicAdd(reinterpret_cast<unsigned long long*>(histo) + wmin, 1ull);
  }
}

int threads_for(int P) { return (P + 31) / 32 * 32; }

}  // namespace

extern "C" int bt_form_superkmers(const int64_t* words, const int64_t* lengths,
                                  int B, int W, int k, int m,
                                  const int64_t* table, const int64_t* rank,
                                  int max_span, int Wn, int bits, int with_pos,
                                  unsigned int pos_base, int64_t* skm,
                                  int64_t* owner, uint8_t* start,
                                  int64_t* n_kmers, void* stream) {
  if (B == 0) return 0;
  if (W > kMaxRowWords) return static_cast<int>(cudaErrorInvalidValue);
  const int P = 16 * W;
  size_t smem = W * 4 + P * 4 + 2 * P * 4 + P;
  form_superkmers_kernel<<<B, threads_for(P), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      words, lengths, W, k, m, table, rank, max_span, Wn, bits, with_pos,
      pos_base, skm, static_cast<long long>(B) * P, owner, start,
      reinterpret_cast<unsigned long long*>(n_kmers));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bt_mmer_histograms(const int64_t* words, const int64_t* lengths,
                                  int B, int W, int k, int m,
                                  const int64_t* rank, int load,
                                  int64_t* histo, void* stream) {
  if (B == 0) return 0;
  if (W > kMaxRowWords) return static_cast<int>(cudaErrorInvalidValue);
  const int P = 16 * W;
  size_t smem = W * 4 + P * 4;
  mmer_histograms_kernel<<<B, threads_for(P), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      words, lengths, W, k, m, rank, load, histo);
  return static_cast<int>(cudaGetLastError());
}
