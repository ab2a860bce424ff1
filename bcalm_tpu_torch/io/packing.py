"""Host-side 2-bit read packing into fixed-shape device blocks.

TPU-native replacement for the byte-oriented read streaming of gatb
bank/impl/BankFasta + the superkmer binning input path
(kmer/impl/Sequence2SuperKmer, reconstructed — see SURVEY.md §3.2):
instead of streaming variable-length sequences into per-thread bags, reads
are packed on the host into fixed-shape uint32 blocks (16 bases/word,
big-endian within each word, same bit-order as the lane format of
bcalm_tpu.models.lanes) that are consumed by the device extraction kernel.

Semantics:
- non-ACGT characters (N etc.) split a read: k-mers spanning an invalid
  base never exist (matches reference behavior — gatb marks such k-mers
  invalid during extraction; splitting yields the identical k-mer multiset),
- reads longer than the block's base capacity are chunked into windows with
  k-1 overlap, which partitions the k-mer multiset exactly (no loss, no
  duplication).

Copy of ``bcalm_tpu/io/packing.py`` with the imports pointed at this package:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Sequence

import numpy as np

BASES_PER_WORD = 16

# ASCII -> 2-bit code; 255 marks invalid (split points).  A=0 C=1 T=2 G=3.
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for ch, code in (("A", 0), ("C", 1), ("T", 2), ("G", 3)):
    _CODE_LUT[ord(ch)] = code
    _CODE_LUT[ord(ch.lower())] = code

# Packing weights: first base of a word in the highest bits.
_SHIFTS = (2 * (BASES_PER_WORD - 1 - np.arange(BASES_PER_WORD))).astype(np.uint32)


@dataclass
class ReadBlock:
    """A fixed-shape batch of packed reads ready for device infeed."""

    words: np.ndarray   # (B, W) uint32, 2-bit packed, zero-padded
    lengths: np.ndarray  # (B,) int32 read lengths in bases (0 = empty slot)

    @property
    def capacity(self) -> int:
        return self.words.shape[0]

    @property
    def max_len(self) -> int:
        return self.words.shape[1] * BASES_PER_WORD


def encode_ascii(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 code array (255 for invalid characters)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def split_on_invalid(codes: np.ndarray, k: int) -> List[np.ndarray]:
    """Split a code array at invalid bases, keeping pieces of length >= k."""
    if codes.size == 0:
        return []
    bad = codes == 255
    if not bad.any():
        return [codes] if codes.size >= k else []
    out = []
    idx = np.flatnonzero(bad)
    prev = 0
    for i in idx:
        if i - prev >= k:
            out.append(codes[prev:i])
        prev = i + 1
    if codes.size - prev >= k:
        out.append(codes[prev:])
    return out


def pack_codes(codes: np.ndarray, width_words: int) -> np.ndarray:
    """(n,) uint8 codes -> (width_words,) uint32 big-endian packed, 0-padded."""
    n = codes.shape[0]
    padded = np.zeros(width_words * BASES_PER_WORD, dtype=np.uint32)
    padded[:n] = codes
    return (padded.reshape(width_words, BASES_PER_WORD) << _SHIFTS).sum(
        axis=1, dtype=np.uint32
    )


def chunk_codes(codes: np.ndarray, k: int, max_len: int) -> Iterator[np.ndarray]:
    """Chunk a long sequence into <=max_len windows overlapping by k-1."""
    n = codes.shape[0]
    if n <= max_len:
        yield codes
        return
    step = max_len - (k - 1)
    start = 0
    while start < n - (k - 1):
        yield codes[start : start + max_len]
        start += step


def iter_blocks(
    seqs: Iterable[bytes | str],
    k: int,
    block_reads: int = 4096,
    max_len: int = 512,
) -> Iterator[ReadBlock]:
    """Pack an iterable of raw sequences into ReadBlocks.

    max_len is rounded up to a multiple of 16 and to at least max(k, 16)+15.
    """
    max_len = max(max_len, k, BASES_PER_WORD)
    width = (max_len + BASES_PER_WORD - 1) // BASES_PER_WORD
    max_len = width * BASES_PER_WORD

    words = np.zeros((block_reads, width), dtype=np.uint32)
    lengths = np.zeros((block_reads,), dtype=np.int32)
    fill = 0
    for seq in seqs:
        for piece in split_on_invalid(encode_ascii(seq), k):
            for chunk in chunk_codes(piece, k, max_len):
                words[fill] = pack_codes(chunk, width)
                lengths[fill] = chunk.shape[0]
                fill += 1
                if fill == block_reads:
                    yield ReadBlock(words, lengths)
                    words = np.zeros((block_reads, width), dtype=np.uint32)
                    lengths = np.zeros((block_reads,), dtype=np.int32)
                    fill = 0
    if fill:
        yield ReadBlock(words, lengths)


def unpack_words(words: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_codes (host-side, for tests): (W,) words -> (length,) codes."""
    w = words.astype(np.uint32)
    codes = ((w[:, None] >> _SHIFTS[None, :]) & 3).reshape(-1)
    return codes[:length].astype(np.uint8)
