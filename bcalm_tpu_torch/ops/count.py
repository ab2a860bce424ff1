"""K-mer counting: lexicographic sort + run reduction (K2).

Counterpart of ``bcalm_tpu/ops/count.py``.  Lanes are lane-major (L, N)
int64 tensors holding u32 values; invalid columns are folded to the
all-ones sentinel, which sorts after every canonical k-mer.

:func:`count_canonical` sorts with ``torch.sort`` (ops.sort) and reduces
the sorted runs with :func:`count_runs`, which launches the CUDA kernels
(csrc/count.cu) for CUDA tensors and runs :func:`count_runs_plain` for
CPU tensors.  Counts are int64; the JAX package's are int32 and equal
wherever those do not overflow.
"""

from __future__ import annotations

from typing import Optional

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
