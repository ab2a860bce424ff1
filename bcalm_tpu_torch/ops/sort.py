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


def lex_argsort(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting u32 key columns (most significant first)."""
    keys = ln.pack_keys(list(cols))
    perm = None
    for key in reversed(keys):
        if perm is None:
            perm = torch.sort(key, stable=True).indices
        else:
            perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm
