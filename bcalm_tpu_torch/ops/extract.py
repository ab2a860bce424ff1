"""Canonical k-mer extraction from packed read blocks (K1).

Counterpart of ``bcalm_tpu/ops/extract.py:extract_canonical`` fused with
``bcalm_tpu/engine.py:_extract_insert``: every position of a (B, W) block
of 2-bit packed reads yields its canonical k-mer lanes and its
first-occurrence key ``((slot_base + slot) << 1) | rc`` (clamped below the
sentinel), invalid positions fold to the all-ones sentinel, and the
(L+1, B*P_eff) result lands in the chunk buffer at `offset`.  The port
writes into the buffer in place (the JAX version donates it).

:func:`extract_insert` launches the CUDA kernel (csrc/extract.cu) for CUDA
tensors and runs :func:`extract_insert_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels

BASES_PER_WORD = 16


def block_slots(words_shape, k: int) -> int:
    """Folded slots one (B, W) block emits: B * max(1, 16W - (k-1))."""
    B, W = words_shape
    return B * max(1, W * BASES_PER_WORD - (k - 1))


def decode_words(words: torch.Tensor) -> torch.Tensor:
    """(B, W) packed words -> (B, 16W) base codes."""
    shifts = 2 * (BASES_PER_WORD - 1 - torch.arange(BASES_PER_WORD,
                                                    device=words.device))
    return ((words[:, :, None] >> shifts) & 3).reshape(words.shape[0], -1)


def kmer_lanes(bases: torch.Tensor, k: int, P_eff: int):
    """Forward and reverse-complement lanes at positions [0, P_eff):
    each (L, B, P_eff).  Base p+i of the window sits at exponent k-1-i of
    the forward value and at exponent i of the reverse complement."""
    B, P = bases.shape
    L = ln.num_lanes(k)
    if P_eff + k - 1 > P:   # rows shorter than k: every position is invalid
        bases = torch.cat([bases, bases.new_zeros((B, P_eff + k - 1 - P))], dim=1)
    fwd = torch.zeros((L, B, P_eff), dtype=torch.int64, device=bases.device)
    rc = torch.zeros_like(fwd)
    for i in range(k):
        b = bases[:, i:i + P_eff]
        e = k - 1 - i
        fwd[L - 1 - e // 16] |= b << (2 * (e % 16))
        rc[L - 1 - i // 16] |= (b ^ 2) << (2 * (i % 16))
    return fwd, rc


def extract_insert_plain(buf: torch.Tensor, words: torch.Tensor,
                         lengths: torch.Tensor, k: int, slot_base: int,
                         offset: int, row_base=None) -> None:
    """Plain PyTorch version of the K1 kernel (same arguments)."""
    B, W = words.shape
    P_eff = max(1, W * BASES_PER_WORD - (k - 1))
    L = buf.shape[0] - 1
    fwd, rc = kmer_lanes(decode_words(words), k, P_eff)
    use_rc = ln.less(rc, fwd)
    canon = torch.where(use_rc[None], rc, fwd).reshape(L, -1)
    pos_idx = torch.arange(P_eff, device=words.device)
    valid = (pos_idx[None, :] <= (lengths[:, None] - k)).reshape(-1)
    if row_base is None:
        slot = slot_base + torch.arange(B * P_eff, device=words.device)
    else:
        slot = ((row_base[:, None] + pos_idx[None, :]) & 0x3FFFFFFF).reshape(-1)
    pos = ((slot << 1) & ln.U32) | use_rc.reshape(-1).to(torch.int64)
    pos = torch.clamp(pos, max=0xFFFFFFFE)
    rows = torch.cat([canon, pos[None]], dim=0)
    buf[:, offset:offset + B * P_eff] = torch.where(valid[None], rows,
                                                    ln.SENTINEL)


def extract_insert(buf: torch.Tensor, words: torch.Tensor,
                   lengths: torch.Tensor, k: int, slot_base: int,
                   offset: int, row_base=None) -> None:
    """Write a block's folded extraction into buf[:, offset:offset+F].

    buf: (L+1, cap) int64; words: (B, W) int64 packed reads (u32 values);
    lengths: (B,) int64; slot_base < 2**31.  row_base: (B,) int64 per-row
    stream slots (the received superkmers of the -devices N build,
    bcalm_tpu/parallel/pipeline.py:348): position p of row b then keys
    ((row_base[b] + p) & 0x3FFFFFFF) << 1 | rc."""
    if buf.device.type == "cpu":
        extract_insert_plain(buf, words, lengths, k, slot_base, offset,
                             row_base)
    else:
        _kernels.extract_insert(buf, words, lengths, k, slot_base, offset,
                                row_base)
