"""K-mer counting: sort + run reduction (K2), key ranges (K5, K6), the
solidity fold + histogram (K7) and the solid compaction of the store (K9).

Counterpart of ``bcalm_tpu/ops/count.py`` and of the range programs of
``bcalm_tpu/engine.py`` (_lex_lt, _count_chunk_ranged, _count_lt,
_settle_n).  Lanes are lane-major (L, N) int64 tensors holding u32
values; invalid columns are folded to the all-ones sentinel, which sorts
after every canonical k-mer and compares above every range bound.

:func:`count_canonical` sorts with ``torch.sort`` (ops.sort) and reduces
the sorted runs with :func:`count_runs`.  Each kernel entry here
(count_runs, range_fold, lower_bound, solid_fold_histogram, solid_compact)
launches its CUDA kernel (csrc/{count,ranges,solid,compact}.cu) for CUDA
tensors and runs its
``*_plain`` version for CPU tensors.  Counts are int64; the JAX package's
are int32 and equal wherever those do not overflow.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels
from bcalm_tpu_torch.ops import sort as sort_op

SENTINEL = ln.SENTINEL


def column_valid(lanes: torch.Tensor) -> torch.Tensor:
    """Columns of (L, N) that are not the all-ones sentinel."""
    return ~torch.all(lanes == SENTINEL, dim=0)


def count_runs_plain(s_lanes: torch.Tensor, weights: Optional[torch.Tensor],
                     pos: Optional[torch.Tensor]):
    """Plain PyTorch version of the K2 kernels: run heads of sorted (L, N)
    lanes, per-group weight sum (1 per column when unweighted) and min
    pos, compacted to the front.  Returns (unique (L,N) zero-filled,
    counts (N,), minpos (N,) sentinel-filled or None, n_unique tensor)."""
    L, N = s_lanes.shape
    dev = s_lanes.device
    valid = column_valid(s_lanes)
    head = valid.clone()
    if N > 1:
        head[1:] &= torch.any(s_lanes[:, 1:] != s_lanes[:, :-1], dim=0)
    gid = torch.cumsum(head.to(torch.int64), 0) - 1
    unique = torch.zeros((L, N), dtype=torch.int64, device=dev)
    unique[:, gid[head]] = s_lanes[:, head]
    w = weights[valid] if weights is not None else torch.ones(
        int(valid.sum()), dtype=torch.int64, device=dev)
    counts = torch.zeros((N,), dtype=torch.int64, device=dev)
    counts.index_add_(0, gid[valid], w)
    minpos = None
    if pos is not None:
        minpos = torch.full((N,), SENTINEL, dtype=torch.int64, device=dev)
        minpos.scatter_reduce_(0, gid[valid], pos[valid], "amin")
    n_unique = head.sum()
    return unique, counts, minpos, n_unique


def count_runs(s_lanes, weights=None, pos=None):
    """K2 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if s_lanes.device.type == "cpu":
        return count_runs_plain(s_lanes, weights, pos)
    return _kernels.count_runs(s_lanes, weights, pos)


def count_canonical(lanes: torch.Tensor, weights: Optional[torch.Tensor] = None,
                    pos: Optional[torch.Tensor] = None):
    """Count occurrences of sentinel-folded canonical k-mers.

    lanes: (L, N); weights: optional (N,) per-column weights (merging
    counted runs); pos: optional (N,) first-occurrence keys, reduced by min.
    Returns (unique (L, N) sorted and compacted to the front, zero-filled;
    counts (N,); minpos (N,) or None; n_unique 0-d tensor)."""
    L = lanes.shape[0]
    perm = sort_op.lex_argsort([lanes[j] for j in range(L)])
    s_lanes = lanes[:, perm]
    return count_runs(s_lanes,
                      None if weights is None else weights[perm],
                      None if pos is None else pos[perm])


def lex_lt_plain(lanes: torch.Tensor, bound: Sequence[int]) -> torch.Tensor:
    """Columnwise lexicographic lanes[:, i] < bound over L u32 lanes."""
    lt = torch.zeros(lanes.shape[1], dtype=torch.bool, device=lanes.device)
    eq = torch.ones_like(lt)
    for j in range(lanes.shape[0]):
        b = int(bound[j])
        lt |= eq & (lanes[j] < b)
        eq &= lanes[j] == b
    return lt


def range_fold_plain(body: torch.Tensor, lo: Sequence[int],
                     hi: Sequence[int]) -> torch.Tensor:
    """Plain version of K5: fold, in place, the columns of the (L+1, N)
    body (key lanes + pos row) whose key lies outside [lo, hi) to the
    sentinel; returns the (1,) count of in-range columns."""
    keys = body[:-1]
    keep = ~lex_lt_plain(keys, lo) & lex_lt_plain(keys, hi)
    body.masked_fill_(~keep[None], SENTINEL)
    return keep.sum().reshape(1)


def range_fold(body: torch.Tensor, lo: Sequence[int], hi: Sequence[int]):
    """K5 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if body.device.type == "cpu":
        return range_fold_plain(body, lo, hi)
    return _kernels.range_fold(body, lo, hi)


def lower_bound_plain(run: torch.Tensor, n: int,
                      bounds: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: for each column of the (L, P) bounds, the
    number of the run's first n columns whose key is below it."""
    return torch.stack([lex_lt_plain(run[:, :n], bounds[:, p].tolist()).sum()
                        for p in range(bounds.shape[1])]).reshape(-1)


def lower_bound(run: torch.Tensor, n: int, bounds: torch.Tensor):
    """K6 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if run.device.type == "cpu":
        return lower_bound_plain(run, n, bounds)
    return _kernels.lower_bound(run, n, bounds)


def count_chunk_ranged(body: torch.Tensor, lo: Sequence[int],
                       hi: Sequence[int]):
    """Count a chunk body restricted to the key range [lo, hi): the
    out-of-range columns fold in place (K5), then count_canonical.
    Returns (unique, counts, minpos, n_unique, in-range occurrences), the
    last two as 0-d tensors."""
    occ = range_fold(body, lo, hi)
    unique, counts, minpos, n_unique = count_canonical(body[:-1], pos=body[-1])
    return unique, counts, minpos, n_unique, occ[0]


def filter_abundance_fold(unique, counts, minpos, n_unique: int,
                          abundance_min: int, abundance_max: int):
    """Solidity filter: columns outside [abundance_min, abundance_max] (or
    past n_unique) fold to the sentinel.  Returns (solid, counts', pos',
    n_solid tensor)."""
    N = unique.shape[1]
    idx = torch.arange(N, device=unique.device)
    keep = (idx < n_unique) & (counts >= abundance_min) & (counts <= abundance_max)
    solid = torch.where(keep[None], unique, SENTINEL)
    solid_counts = torch.where(keep, counts, 0)
    solid_pos = torch.where(keep, minpos, SENTINEL)
    return solid, solid_counts, solid_pos, keep.sum()


def abundance_histogram(counts: torch.Tensor, n_unique: int,
                        histo_max: int = 10000) -> torch.Tensor:
    """(histo_max+1,) bin i = distinct k-mers with count i (the last bin
    takes every count >= histo_max)."""
    binned = torch.clamp(counts[:n_unique], 0, histo_max)
    return torch.bincount(binned, minlength=histo_max + 1)


def solid_fold_histogram_plain(unique, counts, minpos, n_unique: int,
                               abundance_min: int, abundance_max: int,
                               histo_max: int):
    """Plain version of K7: filter_abundance_fold + abundance_histogram.
    Returns (solid, counts', pos', n_solid (1,), histogram)."""
    solid, scounts, spos, n_solid = filter_abundance_fold(
        unique, counts, minpos, n_unique, abundance_min, abundance_max)
    return (solid, scounts, spos, n_solid.reshape(1),
            abundance_histogram(counts, n_unique, histo_max))


def solid_fold_histogram(unique, counts, minpos, n_unique: int,
                         abundance_min: int, abundance_max: int,
                         histo_max: int):
    """K7 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if unique.device.type == "cpu":
        return solid_fold_histogram_plain(unique, counts, minpos, n_unique,
                                          abundance_min, abundance_max,
                                          histo_max)
    return _kernels.solid_fold_histogram(unique, counts, minpos, n_unique,
                                         abundance_min, abundance_max,
                                         histo_max)


def solid_compact_plain(unique, counts, minpos, n_unique: int,
                        abundance_min: int, abundance_max: int, width=None):
    """Plain version of K9 (bcalm_tpu filter_abundance_pos): the solid
    columns' lanes, counts and minpos stably compacted to the front of one
    stacked (L+2, W) tensor (rows: lanes, counts, minpos; W = width or N),
    0 past n_solid and the sentinel in the minpos row.  Returns (stacked,
    n_solid (1,))."""
    L, N = unique.shape
    W = N if width is None else width
    idx = torch.arange(N, device=unique.device)
    keep = (idx < n_unique) & (counts >= abundance_min) & (counts <= abundance_max)
    dest = torch.cumsum(keep.to(torch.int64), 0)[keep] - 1
    fits = dest < W
    dest = dest[fits]
    out = torch.zeros((L + 2, W), dtype=torch.int64, device=unique.device)
    out[L + 1] = SENTINEL
    out[:L, dest] = unique[:, keep][:, fits]
    out[L, dest] = counts[keep][fits]
    out[L + 1, dest] = minpos[keep][fits]
    return out, keep.sum().reshape(1)


def solid_compact(unique, counts, minpos, n_unique: int, abundance_min: int,
                  abundance_max: int, width=None):
    """K9 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if unique.device.type == "cpu":
        return solid_compact_plain(unique, counts, minpos, n_unique,
                                   abundance_min, abundance_max, width)
    return _kernels.solid_compact(unique, counts, minpos, n_unique,
                                  abundance_min, abundance_max, width)
