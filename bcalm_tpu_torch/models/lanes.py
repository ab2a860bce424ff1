"""Multi-lane 2-bit k-mer arithmetic on torch tensors.

Counterpart of ``bcalm_tpu/models/lanes.py``.  A k-mer is ``L = ceil(k/16)``
32-bit lanes, 16 bases per lane, most-significant lane first, value
right-aligned; base codes A=0, C=1, T=2, G=3 so complement(b) = b ^ 2.

Representation: torch has no unsigned 32-bit compare, shift or scatter on
the CPU, so every u32 lane value is held in an ``int64`` tensor with values
in ``[0, 2**32)``.  The layout stays lane-major, ``(L, ...batch)``, as in
the JAX package.  Left shifts are masked back to 32 bits; right shifts of
non-negative int64 are logical.  The fold sentinel is the all-ones lane
value ``0xFFFFFFFF``.

Sorting packs two lanes into one int64 key,
``((hi - 2**31) << 32) | lo``, whose signed order is the unsigned
lexicographic order of (hi, lo) (see :func:`pack_keys`).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

BASES_PER_LANE = 16
U32 = 0xFFFFFFFF
SENTINEL = 0xFFFFFFFF
_BIAS = 0x80000000

_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_M8 = 0x00FF00FF
_COMP = 0xAAAAAAAA


def num_lanes(k: int) -> int:
    """Lanes needed for a k-mer: ceil(k / 16)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return (k + BASES_PER_LANE - 1) // BASES_PER_LANE


def top_lane_bases(k: int) -> int:
    """Number of bases stored in the most-significant lane (in 1..16)."""
    r = k % BASES_PER_LANE
    return BASES_PER_LANE if r == 0 else r


def top_lane_mask(k: int) -> int:
    """AND-mask of the most-significant lane's 2r live bits."""
    return (1 << (2 * top_lane_bases(k))) - 1


def shift_right_bits(lanes: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the whole multi-lane field by `s` bits."""
    if s == 0:
        return lanes
    L = lanes.shape[0]
    lane_move, bit = divmod(s, 32)
    if lane_move:
        pad = torch.zeros((lane_move,) + lanes.shape[1:], dtype=lanes.dtype,
                          device=lanes.device)
        lanes = torch.cat([pad, lanes[:L - lane_move]], dim=0)
    if bit:
        zero = torch.zeros((1,) + lanes.shape[1:], dtype=lanes.dtype,
                           device=lanes.device)
        hi = torch.cat([zero, lanes[:-1]], dim=0)
        lanes = (lanes >> bit) | ((hi << (32 - bit)) & U32)
    return lanes


def _reverse_bases_in_lane(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit base fields inside each 32-bit lane value."""
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M4) | ((x & _M4) << 4)
    x = ((x >> 8) & _M8) | ((x & _M8) << 8)
    return (x >> 16) | ((x << 16) & U32)


def revcomp(lanes: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of (L, ...) k-mers."""
    L = lanes.shape[0]
    rev = _reverse_bases_in_lane(lanes ^ _COMP).flip(0)
    return shift_right_bits(rev, 32 * L - 2 * k)


def less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the lane axis; bool of batch shape."""
    L = a.shape[0]
    lt = a[L - 1] < b[L - 1]
    for j in range(L - 2, -1, -1):
        lt = (a[j] < b[j]) | ((a[j] == b[j]) & lt)
    return lt


def equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=0)


def canonical(lanes: torch.Tensor, k: int):
    """(min(kmer, revcomp), was_rc) with was_rc where rc is strictly smaller."""
    rc = revcomp(lanes, k)
    was_rc = less(rc, lanes)
    return torch.where(was_rc[None], rc, lanes), was_rc


def is_palindrome(lanes: torch.Tensor, k: int) -> torch.Tensor:
    """kmer == revcomp(kmer); never true for odd k."""
    if k % 2 == 1:
        return torch.zeros(lanes.shape[1:], dtype=torch.bool,
                           device=lanes.device)
    return equal(lanes, revcomp(lanes, k))


def suffix_kminus1(lanes: torch.Tensor, k: int) -> torch.Tensor:
    """Last k-1 bases as a right-aligned (k-1)-mer."""
    L2 = num_lanes(k - 1)
    out = lanes[lanes.shape[0] - L2:].clone()
    out[0] &= top_lane_mask(k - 1)
    return out


def prefix_kminus1(lanes: torch.Tensor, k: int) -> torch.Tensor:
    """First k-1 bases as a right-aligned (k-1)-mer (value >> 2)."""
    L2 = num_lanes(k - 1)
    return shift_right_bits(lanes, 2)[lanes.shape[0] - L2:]


def pack_keys(cols: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """u32 key columns (most significant first) -> int64 sort keys.

    Columns pair up as ``((hi - 2**31) << 32) | lo``: the bias moves hi into
    the signed range, so signed int64 order equals the unsigned
    lexicographic order of (hi, lo).  An odd trailing column stays a key of
    its own (its values are already non-negative)."""
    keys = []
    for j in range(0, len(cols) - 1, 2):
        keys.append(((cols[j] - _BIAS) << 32) | cols[j + 1])
    if len(cols) % 2:
        keys.append(cols[-1])
    return keys


def lanes_to_int(lanes) -> int:
    """One k-mer's L u32 lane values (host) -> its integer, first base most
    significant (bcalm_tpu.models.lanes.lanes_to_int)."""
    x = 0
    for v in lanes:
        x = (x << 32) | int(v)
    return x


def int_to_string(x: int, k: int) -> str:
    """A k-mer's integer -> its bases (bcalm_tpu.models.lanes.int_to_string)."""
    return "".join("ACTG"[(x >> (2 * (k - 1 - i))) & 3] for i in range(k))
