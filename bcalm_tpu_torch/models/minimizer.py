"""Frequency order of m-mers and the minimizer -> device repartition table.

Counterpart of ``bcalm_tpu/models/minimizer.py``: frequency_rank and
build_repartition, both numpy on the host (the ModelMinimizer /
Repartitor analogs of gatb, minimizer-type 1 and repartition-type 1 by
default).  The per-k-mer helpers of that module (minimizers,
mmer_histogram, partition_of) serve only the JAX package's tests and are
not carried here.
"""

from __future__ import annotations

import numpy as np


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
