"""Superkmer formation and packing (K13) and the sampling histograms (K14).

Counterpart of ``bcalm_tpu/ops/superkmer.py``.  Consecutive k-mers of a
read that share a minimizer form a superkmer, and the whole base run is
routed to the minimizer's partition as one unit.  The minimizer of a
k-mer is the minimum canonical m-mer of its window (each m-mer
canonicalized on its own, the minimum over the k-m+1 positions),
optionally ordered by a sampled frequency rank (minimizer-type 1); a
k-mer and its reverse complement share it.

The layout of the JAX package is kept at the public functions: every
result has a column per read position, B*P of them (P = 16W), valid only
at superkmer starts; positions past a read's end see the row's first
bases again (the JAX version rolls its window packs), so even the
columns a caller ignores match.

:func:`form_superkmers` launches K13 (csrc/superkmer.cu) for CUDA tensors
and runs :func:`form_superkmers_plain` for CPU tensors;
:func:`sample_cmmer_histogram` and :func:`sample_minimizer_load` launch
K14 (same source), which adds into a histogram they zero, or run their
plain versions.  Lane values are u32 held in int64 tensors, as everywhere
in the port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels
from bcalm_tpu_torch.ops import extract as extract_op


def span_field_bits(max_span: int) -> int:
    return max(1, int(math.ceil(math.log2(max_span + 1))))


def span_words(k: int, max_span: int) -> int:
    """u32 words holding a superkmer of <= max_span k-mers plus the span
    field embedded in the low bits of its last word."""
    bits = span_field_bits(max_span)
    return (max_span + k - 1 + (bits + 1) // 2 + 15) // 16


def default_max_span(k: int) -> int:
    """Largest span cap that fits the word count of a ~32-k-mer superkmer
    with room for the embedded span field."""
    Wn = (32 + k - 1 + 15) // 16
    ms = 16 * Wn - (k - 1)
    return ms - (span_field_bits(ms) + 1) // 2


def est_span(k: int, m: int) -> int:
    """Conservative expected k-mers per superkmer (capacity sizing)."""
    return max(1, (k - m + 1) // 2)


def _shift_pos(x: torch.Tensor, off: int) -> torch.Tensor:
    """x[:, p + off] with wraparound along the positions."""
    return x if off == 0 else torch.roll(x, -off, dims=1)


def window_packs(bases: torch.Tensor) -> torch.Tensor:
    """(B, P) base codes -> (B, P) forward 16-base window packs:
    M(p) = sum_{i<16} bases[(p+i) mod P] * 4**(15-i)."""
    f = bases
    w = 1
    while w < 16:
        f = ((f << (2 * w)) & ln.U32) | _shift_pos(f, w)
        w *= 2
    return f


def canonical_mmers(fwd_pack: torch.Tensor, m: int) -> torch.Tensor:
    """Canonical m-mer at each position: min(mmer, revcomp(mmer))."""
    if m > 16:
        raise ValueError("minimizer size must be <= 16")
    mm = fwd_pack >> (2 * (16 - m))
    rev = ln._reverse_bases_in_lane(mm) >> (2 * (16 - m))
    rc = rev ^ (0xAAAAAAAA & ((1 << (2 * m)) - 1))
    return torch.minimum(mm, rc)


def window_min_keys(keys: torch.Tensor, w: int) -> torch.Tensor:
    """Sliding-window minimum over [p, p+w) along the last axis
    (wrapping), by log-step doubling."""
    t = 1
    r = keys
    while t * 2 <= w:
        r = torch.minimum(r, _shift_pos(r, t))
        t *= 2
    if t < w:
        r = torch.minimum(r, _shift_pos(r, w - t))
    return r


def decode_span(last_word: torch.Tensor, max_span: int) -> torch.Tensor:
    """Span (k-mer count) embedded in a received superkmer's last word."""
    return last_word & ((1 << span_field_bits(max_span)) - 1)


def _minimizer_keys(words, k: int, m: int, rank, use_rank: bool):
    bases = extract_op.decode_words(words)
    fwd_pack = window_packs(bases)
    cm = canonical_mmers(fwd_pack, m)
    key = rank[cm] if use_rank else cm
    return fwd_pack, cm, key


def form_superkmers_plain(words: torch.Tensor, lengths: torch.Tensor, k: int,
                          m: int, owner_by_key: torch.Tensor,
                          rank: Optional[torch.Tensor] = None,
                          max_span: int = 32, use_rank: bool = False,
                          with_pos: bool = False, pos_base: int = 0):
    """Plain PyTorch version of K13 (see form_superkmers)."""
    B, W = words.shape
    P = 16 * W
    dev = words.device
    fwd_pack, _, key = _minimizer_keys(words, k, m, rank, use_rank)
    pos = torch.arange(P, device=dev)[None, :]
    valid = pos <= (lengths[:, None] - k)
    wmin = window_min_keys(key, k - m + 1)
    owner = owner_by_key[wmin]

    prev_key = torch.cat([wmin[:, :1], wmin[:, :-1]], dim=1)
    prev_valid = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                            valid[:, :-1]], dim=1)
    change = valid & (~prev_valid | (wmin != prev_key))
    idx = pos.expand(B, P)
    run_start0 = torch.cummax(torch.where(change, idx, 0), dim=1).values
    within0 = idx - run_start0
    start = change | (valid & (within0 > 0) & (within0 % max_span == 0))
    term = torch.where(change | ~valid, idx, P)
    rev_min = torch.cummin(term.flip(1), dim=1).values.flip(1)
    end0 = torch.cat([rev_min[:, 1:], torch.full((B, 1), P, dtype=torch.int64,
                                                 device=dev)], dim=1)
    span = torch.clamp(end0 - idx, max=max_span)

    Wn = span_words(k, max_span)
    bits = span_field_bits(max_span)
    rows = [_shift_pos(fwd_pack, 16 * w) for w in range(Wn)]
    rows[-1] = ((rows[-1] >> bits) << bits) | (span & ln.U32)
    if with_pos:
        rows.append((torch.arange(B * P, device=dev).reshape(B, P)
                     + pos_base) & ln.U32)
    skm_words = torch.stack(rows, dim=0).reshape(len(rows), B * P)
    return (skm_words, owner.reshape(B * P), start.reshape(B * P),
            valid.sum().reshape(1))


def form_superkmers(words: torch.Tensor, lengths: torch.Tensor, k: int, m: int,
                    owner_by_key: torch.Tensor,
                    rank: Optional[torch.Tensor] = None, max_span: int = 32,
                    use_rank: bool = False, with_pos: bool = False,
                    pos_base: int = 0):
    """Form and pack the superkmers of a (B, W) block of packed reads.

    owner_by_key: (4^m,) int64 partition table indexed by the window-min
    key (the frequency rank when use_rank, else the canonical m-mer);
    rank: (4^m,) int64 canonical m-mer -> frequency rank (use_rank).
    with_pos appends a channel holding each position's global stream slot
    (pos_base + flat position, u32 wraparound).

    Returns, over the B*P positions: skm_words (Wn [+1], B*P) packed bases
    with the span in the low span_field_bits of word Wn-1 (decode_span),
    the position channel last; owner (B*P,) int64; start (B*P,) bool, the
    superkmer starts; n_kmers (1,) int64, the valid k-mer positions."""
    if words.device.type == "cpu":
        return form_superkmers_plain(words, lengths, k, m, owner_by_key, rank,
                                     max_span, use_rank, with_pos, pos_base)
    return _kernels.form_superkmers(words, lengths, k, m, owner_by_key,
                                    rank if use_rank else None, max_span,
                                    span_words(k, max_span),
                                    span_field_bits(max_span), with_pos,
                                    pos_base)


def sample_cmmer_histogram_plain(words, lengths, k: int, m: int):
    """Plain version of K14's m-mer mode."""
    B, W = words.shape
    P = 16 * W
    _, cm, _ = _minimizer_keys(words, k, m, None, False)
    pos = torch.arange(P, device=words.device)[None, :]
    v = (pos <= (lengths[:, None] - m)).reshape(-1)
    return torch.bincount(cm.reshape(-1)[v], minlength=4 ** m)


def sample_minimizer_load_plain(words, lengths, k: int, m: int,
                                rank: Optional[torch.Tensor] = None,
                                use_rank: bool = False):
    """Plain version of K14's minimizer-load mode."""
    B, W = words.shape
    P = 16 * W
    _, _, key = _minimizer_keys(words, k, m, rank, use_rank)
    wmin = window_min_keys(key, k - m + 1)
    pos = torch.arange(P, device=words.device)[None, :]
    v = (pos <= (lengths[:, None] - k)).reshape(-1)
    return torch.bincount(wmin.reshape(-1)[v], minlength=4 ** m)


def sample_cmmer_histogram(words: torch.Tensor, lengths: torch.Tensor, k: int,
                           m: int) -> torch.Tensor:
    """(4^m,) int64 canonical m-mer histogram over a block's read
    positions (the repartition sampling pass)."""
    if words.device.type == "cpu":
        return sample_cmmer_histogram_plain(words, lengths, k, m)
    histo = torch.zeros((4 ** m,), dtype=torch.int64, device=words.device)
    return _kernels.mmer_histograms(words, lengths, k, m, None, False, histo)


def sample_minimizer_load(words: torch.Tensor, lengths: torch.Tensor, k: int,
                          m: int, rank: Optional[torch.Tensor] = None,
                          use_rank: bool = False) -> torch.Tensor:
    """(4^m,) int64 k-mers per window-min key over a block (drives the
    balanced repartition)."""
    if words.device.type == "cpu":
        return sample_minimizer_load_plain(words, lengths, k, m, rank, use_rank)
    load = torch.zeros((4 ** m,), dtype=torch.int64, device=words.device)
    return _kernels.mmer_histograms(words, lengths, k, m,
                                    rank if use_rank else None, True, load)
