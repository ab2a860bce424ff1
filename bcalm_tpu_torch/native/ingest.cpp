// Native ingest: FASTA/FASTQ(.gz) streaming parser + 2-bit block packer.
//
// TPU-native replacement for the reference's native bank layer (gatb
// bank/impl/BankFasta with zlib — reconstructed, SURVEY.md §3.2): the
// byte-bashing hot path (parse + validate + 2-bit pack) stays native, but
// instead of yielding Sequence objects it fills fixed-shape uint32 blocks
// ready for device infeed (layout identical to bcalm_tpu/io/packing.py:
// 16 bases/word, big-endian within a word, A=0 C=1 T=2 G=3).
//
// Semantics mirror io/packing.py exactly (validated by tests):
//   - non-ACGT characters split a read; pieces shorter than k are dropped,
//   - pieces longer than the block's base capacity stream out as max_len
//     windows overlapping by k-1 (exact k-mer multiset partition),
//   - gzip handled transparently via zlib gzFile (plain files too).
//
// C ABI (consumed by bcalm_tpu/io/native.py via ctypes):
//   void*   btpu_open(const char* path);           // NULL on failure
//   long    btpu_next_block(void* h, int k, int block_reads,
//                           int width_words, unsigned* words,
//                           int* lengths);         // rows filled; 0 = EOF
//   void    btpu_close(void* h);

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBasesPerWord = 16;

struct Lut {
  uint8_t t[256];
  Lut() {
    memset(t, 255, sizeof(t));
    t['A'] = t['a'] = 0;
    t['C'] = t['c'] = 1;
    t['T'] = t['t'] = 2;
    t['G'] = t['g'] = 3;
  }
};
const Lut kLut;

enum Format { FMT_BAD = 0, FMT_FASTA, FMT_FASTQ };

class Reader {
 public:
  explicit Reader(const char* path)
      : f_(gzopen(path, "rb")), storage_(1 << 20) {
    inbuf_ = storage_.data();
    if (f_ != nullptr) {
      gzbuffer(f_, 1 << 20);
      sniff();
    }
  }

  // Memory-buffer reader: parses one record-aligned DECOMPRESSED chunk
  // (the parallel single-file ingest path: a decompress thread feeds
  // record-aligned chunks to a pool of these, since gzip inflation is
  // inherently serial but parsing/packing is not).  The caller must
  // keep `data` alive until btpu_close.
  Reader(const uint8_t* data, size_t len)
      : mem_data_(data), mem_len_(len) {
    mem_mode_ = true;
    // sniff over memory: skip leading whitespace
    size_t i = 0;
    while (i < len && (data[i] == '\n' || data[i] == '\r' ||
                       data[i] == ' ' || data[i] == '\t'))
      ++i;
    if (i < len && data[i] == '>')
      fmt_ = FMT_FASTA;
    else if (i < len && data[i] == '@')
      fmt_ = FMT_FASTQ;
    else
      fmt_ = FMT_BAD;
    inbuf_ = data;
    in_pos_ = i;
    in_len_ = len;
    mem_served_ = true;
    at_line_start_ = true;
  }

  ~Reader() {
    if (f_ != nullptr) gzclose(f_);
  }

  bool ok() const {
    return (mem_mode_ || f_ != nullptr) && fmt_ != FMT_BAD;
  }

  long next_block(int k, int block_reads, int width_words, uint32_t* words,
                  int32_t* lengths) {
    const size_t max_len = (size_t)width_words * kBasesPerWord;
    const size_t step = max_len - (size_t)(k - 1);
    memset(words, 0, sizeof(uint32_t) * (size_t)block_reads * width_words);
    memset(lengths, 0, sizeof(int32_t) * (size_t)block_reads);
    long fill = 0;
    while (fill < block_reads) {
      if (buf_.size() >= max_len) {  // full window ready
        pack_row(buf_.data(), (int)max_len,
                 words + (size_t)fill * width_words);
        lengths[fill++] = (int32_t)max_len;
        buf_.erase(buf_.begin(), buf_.begin() + step);
        if (closed_ && buf_.size() < (size_t)k) {
          buf_.clear();
          closed_ = false;
        }
        continue;
      }
      if (closed_) {
        if (buf_.size() >= (size_t)k) {
          pack_row(buf_.data(), (int)buf_.size(),
                   words + (size_t)fill * width_words);
          lengths[fill++] = (int32_t)buf_.size();
        }
        buf_.clear();
        closed_ = false;
        continue;
      }
      if (eof_) break;
      pump(max_len);  // consume input until window full / piece closed / eof
    }
    return fill;
  }

 private:
  void sniff() {
    int c;
    while ((c = gzgetc(f_)) != -1 &&
           (c == '\n' || c == '\r' || c == ' ' || c == '\t')) {
    }
    if (c == '>')
      fmt_ = FMT_FASTA;
    else if (c == '@')
      fmt_ = FMT_FASTQ;
    else {
      fmt_ = FMT_BAD;
      return;
    }
    gzungetc(c, f_);
    at_line_start_ = true;
  }

  static void pack_row(const uint8_t* codes, int n, uint32_t* row) {
    for (int i = 0; i < n; ++i) {
      row[i / kBasesPerWord] |=
          (uint32_t)codes[i] << (2 * (kBasesPerWord - 1 - (i % kBasesPerWord)));
    }
  }

  // Close the current piece: keep it for emission iff it can yield a k-mer.
  // `min_keep` is k for fresh pieces; window remainders are handled by the
  // next_block loop (same >= k test).
  void close_piece(int k) {
    if (buf_.size() >= (size_t)k)
      closed_ = true;
    else
      buf_.clear();
  }

  // ---- bulk input buffering (a per-byte gzgetc loop measured ~126 MB/s
  // uncompressed-equivalent; bulk gzread + pointer scanning removes the
  // per-byte call overhead — the gatb BankFasta buffered-parse analog) ----
  bool refill() {
    if (in_eof_) return false;
    if (mem_mode_) {  // the whole buffer was served up front
      in_eof_ = true;
      return false;
    }
    int n = gzread(f_, storage_.data(), (unsigned)storage_.size());
    if (n <= 0) {
      in_eof_ = true;
      return false;
    }
    inbuf_ = storage_.data();
    in_pos_ = 0;
    in_len_ = (size_t)n;
    return true;
  }

  void skip_line() {
    for (;;) {
      if (in_pos_ == in_len_ && !refill()) {
        eof_ = true;
        break;
      }
      const uint8_t* nl = (const uint8_t*)memchr(inbuf_ + in_pos_, '\n',
                                                 in_len_ - in_pos_);
      if (nl != nullptr) {
        in_pos_ = (size_t)(nl - inbuf_) + 1;
        break;
      }
      in_pos_ = in_len_;
    }
    at_line_start_ = true;
  }

  // Append up to `limit` sequence bytes from the current line (stops at
  // newline / buffer end / an invalid char, which closes the piece).
  // Returns true if the line's newline was consumed.
  bool take_seq_span(size_t limit, int k) {
    if (in_pos_ == in_len_ && !refill()) {
      eof_ = true;
      close_piece(k);
      return false;
    }
    size_t avail = in_len_ - in_pos_;
    const uint8_t* p = inbuf_ + in_pos_;
    const uint8_t* nl = (const uint8_t*)memchr(p, '\n', avail);
    size_t span = (nl != nullptr) ? (size_t)(nl - p) : avail;
    bool hit_nl = nl != nullptr;
    if (span > limit) {
      span = limit;
      hit_nl = false;
    }
    size_t old = buf_.size();
    buf_.resize(old + span);
    uint8_t bad = 0;
    for (size_t i = 0; i < span; ++i) {
      uint8_t c = kLut.t[p[i]];
      buf_[old + i] = c;
      bad |= (uint8_t)(c == 255);
    }
    if (bad) {  // rare: invalid chars (N, \r) split the piece byte-wise
      buf_.resize(old);
      size_t i = 0;
      for (; i < span && !closed_; ++i) {
        uint8_t c = kLut.t[p[i]];
        if (c == 255) {
          if (p[i] != '\r') close_piece(k);
        } else {
          buf_.push_back(c);
        }
      }
      if (closed_) {  // piece done: leave the span remainder for later
        in_pos_ += i;
        return false;
      }
    }
    in_pos_ += span + (hit_nl ? 1 : 0);
    if (hit_nl) at_line_start_ = true;
    return hit_nl;
  }

  void pump(size_t max_len) { fmt_ == FMT_FASTA ? pump_fasta(max_len)
                                                : pump_fastq(max_len); }

  void pump_fasta(size_t max_len) {
    const int k = k_;
    while (buf_.size() < max_len && !closed_) {
      if (in_pos_ == in_len_ && !refill()) {
        eof_ = true;
        close_piece(k);
        return;
      }
      uint8_t c = inbuf_[in_pos_];
      if (c == '\n') {
        ++in_pos_;
        at_line_start_ = true;
        continue;
      }
      if (at_line_start_ && c == '>') {
        close_piece(k);
        skip_line();
        return;
      }
      at_line_start_ = false;
      take_seq_span(max_len - buf_.size(), k);
      if (eof_) return;
    }
  }

  // FASTQ: strict 4-line records (header/seq/plus/quality).
  void pump_fastq(size_t max_len) {
    const int k = k_;
    while (buf_.size() < max_len && !closed_) {
      switch (fq_state_) {
        case 0:  // header
          skip_line();
          if (eof_) { close_piece(k); return; }
          fq_state_ = 1;
          break;
        case 1:  // sequence line (may span refills until its newline)
          if (take_seq_span(max_len - buf_.size(), k)) fq_state_ = 2;
          if (eof_) { close_piece(k); return; }
          break;
        case 2:  // '+' line
          skip_line();
          if (eof_) { close_piece(k); return; }
          fq_state_ = 3;
          break;
        case 3:  // quality line
          skip_line();
          fq_state_ = 0;
          close_piece(k);
          if (eof_) return;
          return;  // piece boundary: let caller emit
      }
    }
  }

 public:
  void set_k(int k) { k_ = k; }

 private:
  gzFile f_ = nullptr;
  Format fmt_ = FMT_BAD;
  std::vector<uint8_t> buf_;
  std::vector<uint8_t> storage_;      // gz-path input buffer
  const uint8_t* inbuf_ = nullptr;    // storage_ or the caller's memory
  bool mem_mode_ = false;
  bool mem_served_ = false;
  const uint8_t* mem_data_ = nullptr;
  size_t mem_len_ = 0;
  size_t in_pos_ = 0;
  size_t in_len_ = 0;
  bool in_eof_ = false;
  bool closed_ = false;
  bool eof_ = false;
  bool at_line_start_ = true;
  int fq_state_ = 0;
  int k_ = 31;
};

}  // namespace

extern "C" {

void* btpu_open(const char* path) {
  Reader* r = new Reader(path);
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

void* btpu_open_mem(const void* data, long len) {
  Reader* r = new Reader(static_cast<const uint8_t*>(data), (size_t)len);
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

long btpu_next_block(void* h, int k, int block_reads, int width_words,
                     uint32_t* words, int32_t* lengths) {
  Reader* r = static_cast<Reader*>(h);
  r->set_k(k);
  return r->next_block(k, block_reads, width_words, words, lengths);
}

void btpu_close(void* h) { delete static_cast<Reader*>(h); }

}  // extern "C"
