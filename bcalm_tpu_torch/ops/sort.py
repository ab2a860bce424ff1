"""Lexicographic multi-operand sort (counterpart of bcalm_tpu/ops/sort_tpu.py).

The JAX package sorts with XLA's library sort; the port sorts with
``torch.sort`` (a radix sort on the GPU).  Key columns are u32 values held
in int64 and are packed two per int64 key (models.lanes.pack_keys), so a
k <= 32 k-mer sorts on one key.  Multiple keys sort least-significant
first, each pass stable, which gives the lexicographic order.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bcalm_tpu_torch.models import lanes as ln


def lex_sort(cols: Sequence[torch.Tensor]):
    """(perm, top): the stable permutation sorting u32 key columns (most
    significant first), and the most significant packed key
    (models.lanes.pack_keys) in sorted order, the values of the last
    ``torch.sort``, so a caller that compares adjacent sorted keys needs
    no gather of its own."""
    return lex_sort_words(ln.pack_keys(list(cols)))


def lex_sort_words(keys: Sequence[torch.Tensor]):
    """lex_sort on keys already packed (most significant first): (perm,
    the first key in sorted order)."""
    perm = None
    for key in reversed(keys):
        if perm is None:
            top, perm = torch.sort(key, stable=True)
        else:
            top, idx = torch.sort(key[perm], stable=True)
            perm = perm[idx]
    return perm, top


def lex_argsort(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting u32 key columns (most significant first)."""
    return lex_sort(cols)[0]
