"""32-bit mixing hash over k-mer lanes: the owner of a routed entry.

Counterpart of ``bcalm_tpu/ops/hashing.py`` (mix32, hash_lanes): a
murmur3-style finalizer with u32 wraparound.  Lane values are u32 held in
int64 tensors; every product goes through junctions._mul32, because a
plain int64 product of two u32 values overflows.  ``hash_lanes(keys) %
n_dev`` decides which rank owns a junction entry, so one wrong bit sends
an entry to another rank: the CUDA side (csrc/hash.cuh) computes the same
function in uint32_t.
"""

from __future__ import annotations

import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops.junctions import _mul32

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_SEED = 0x9747B28C
_GOLD = 0x9E3779B1


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def hash_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """Lane-major (L, ...) u32 lanes -> (...) u32 hash."""
    h = torch.full(lanes.shape[1:], _SEED, dtype=torch.int64,
                   device=lanes.device)
    for j in range(lanes.shape[0]):
        h = mix32(_mul32(h, _GOLD) ^ (lanes[j] & ln.U32))
    return h
