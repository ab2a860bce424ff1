"""Minimizers of k-mers, the frequency order of m-mers and the minimizer
-> device repartition table.

Counterpart of ``bcalm_tpu/models/minimizer.py``: frequency_rank and
build_repartition, numpy on the host (the ModelMinimizer / Repartitor
analogs of gatb, minimizer-type 1 and repartition-type 1 by default), and
the per-k-mer entry points on (L, N) canonical k-mer lanes: mmer_count,
extract_mmers, minimizers, mmer_histogram and partition_of.  The last
three launch K20 (csrc/minimizer.cu, ops/_kernels.kmer_minimizers) for
CUDA tensors and run their ``*_plain`` versions for CPU tensors.  Values
are u32 in int64 tensors, as everywhere in the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels


def mmer_count(k: int, m: int) -> int:
    return k - m + 1


def extract_mmers(lanes: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """All m-mers of each k-mer: (L, ...) -> (k-m+1, ...); m-mer j covers
    bases [j, j+m), m <= 16 (one lane)."""
    if m > 16:
        raise ValueError("minimizer size must be <= 16")
    mask = (1 << (2 * m)) - 1
    return torch.stack([ln.shift_right_bits(lanes, 2 * (k - (j + m)))[-1] & mask
                        for j in range(mmer_count(k, m))])


def minimizers_plain(lanes: torch.Tensor, k: int, m: int,
                     freq_rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K20's minimizer mode: the least m-mer, or the
    m-mer of least freq_rank (torch.argmin: the first minimum wins, as
    jnp.argmin)."""
    mm = extract_mmers(lanes, k, m)
    if freq_rank is None:
        return mm.min(dim=0).values
    best = torch.argmin(freq_rank[mm], dim=0)
    return torch.gather(mm, 0, best[None])[0]


def minimizers(lanes: torch.Tensor, k: int, m: int,
               freq_rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Minimizer m-mer of each canonical k-mer of the (L, N) lanes,
    lexicographic or frequency-ordered ((4^m,) freq_rank): (N,)."""
    if lanes.device.type == "cpu":
        return minimizers_plain(lanes, k, m, freq_rank)
    return _kernels.kmer_minimizers(lanes, k, m, rank=freq_rank)


def mmer_histogram_plain(lanes: torch.Tensor, valid: torch.Tensor, k: int,
                         m: int) -> torch.Tensor:
    """Plain version of K20's histogram mode (a scatter-add)."""
    mm = extract_mmers(lanes, k, m)[:, valid].reshape(-1)
    histo = torch.zeros((4 ** m,), dtype=torch.int64, device=lanes.device)
    return histo.index_put_((mm,), torch.ones_like(mm), accumulate=True)


def mmer_histogram(lanes: torch.Tensor, valid: torch.Tensor, k: int,
                   m: int) -> torch.Tensor:
    """m-mer frequency histogram over the valid columns of a k-mer set:
    (4^m,)."""
    if lanes.device.type == "cpu":
        return mmer_histogram_plain(lanes, valid, k, m)
    return _kernels.kmer_minimizers(lanes, k, m, valid=valid, histogram=True)


def partition_of_plain(lanes: torch.Tensor, k: int, m: int,
                       table: torch.Tensor,
                       freq_rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K20's partition mode: table[minimizer]."""
    return table[minimizers_plain(lanes, k, m, freq_rank)]


def partition_of(lanes: torch.Tensor, k: int, m: int, table: torch.Tensor,
                 freq_rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Partition id of each canonical k-mer via its minimizer: (N,)."""
    if lanes.device.type == "cpu":
        return partition_of_plain(lanes, k, m, table, freq_rank)
    return _kernels.kmer_minimizers(lanes, k, m, rank=freq_rank, table=table)


def frequency_rank(histogram: np.ndarray) -> np.ndarray:
    """Rank m-mers by ascending frequency (ties by value): rank 0 = rarest.

    The returned (4^m,) uint32 array is the order used by frequency-based
    minimizers (minimizer-type 1)."""
    histogram = np.asarray(histogram)
    order = np.lexsort((np.arange(histogram.size), histogram))
    rank = np.empty_like(order, dtype=np.uint32)
    rank[order] = np.arange(order.size, dtype=np.uint32)
    return rank


def build_repartition(minimizer_load: np.ndarray, n_partitions: int,
                      repartition_type: int = 1) -> np.ndarray:
    """Minimizer -> partition table ((4^m,) int32).

    type 0: uniform (minimizer mod n_partitions).
    type 1: balanced snake packing of the load-sorted minimizers
            (largest first), as in bcalm_tpu.
    """
    n_min = minimizer_load.shape[0]
    if repartition_type == 0:
        return (np.arange(n_min) % n_partitions).astype(np.int32)
    order = np.argsort(-minimizer_load.astype(np.int64), kind="stable")
    snake = np.concatenate(
        [np.arange(n_partitions), np.arange(n_partitions - 1, -1, -1)]
    )
    assign = snake[np.arange(n_min) % (2 * n_partitions)]
    table = np.empty(n_min, dtype=np.int32)
    table[order] = assign.astype(np.int32)
    return table
