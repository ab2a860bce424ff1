"""Junction classification: the (k-1)-overlap successor array (K3).

Counterpart of ``bcalm_tpu/ops/junctions.py:successor_arrays``.  Oriented
node (i, +) = i and (i, -) = i + C.  Each k-mer side (suffix, prefix)
emits its strand-0 representative entry keyed by its canonical (k-1)-mer
(exact lanes, or a 96-bit hash when k-1 > 48) with payload
``oid | role << 30``; palindromic sides are dropped.  After the sort, a
group of exactly two entries, one OUT and one IN on distinct vertices, is
a unitig edge: ``succ[src] = dst`` and its mirror edge.

:func:`junction_keys` and :func:`junction_pairs` launch the CUDA kernels
(csrc/junctions.cu) for CUDA tensors and run their plain versions for
CPU tensors; the sort between them is ``torch.sort``.
"""

from __future__ import annotations

import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels
from bcalm_tpu_torch.ops import sort as sort_op

SENTINEL = ln.SENTINEL
ROLE_OUT = 0
_ROLE_SHIFT = 30
_OID_MASK = (1 << 30) - 1

_H = (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
_H_INIT = (0x9E3779B1, 0x61C88647, 0x2545F491)
_F1 = 0x7FEB352D
_F2 = 0x846CA68B


def use_hash_keys(k: int) -> bool:
    """96-bit hashed keys when the exact key needs more than 3 lanes
    (k-1 > 48), as in the JAX package."""
    return ln.num_lanes(k - 1) + 1 > 4


def key_rows(k: int) -> int:
    return 3 if use_hash_keys(k) else ln.num_lanes(k - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for u32 a in int64 without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & ln.U32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _F1)
    h = h ^ (h >> 15)
    h = _mul32(h, _F2)
    return h ^ (h >> 16)


def hash96(keys: torch.Tensor):
    """(L2, N) key lanes -> three u32 hash words (bcalm_tpu _hash96)."""
    hs = []
    for w in range(3):
        h = torch.full((keys.shape[1],), _H_INIT[w], dtype=torch.int64,
                       device=keys.device)
        for j in range(keys.shape[0]):
            h = (_mul32(h ^ keys[j], _H[w]) + (w + 1) * j + 1) & ln.U32
        hs.append(_mix32(h))
    return hs


def junction_keys_plain(solid: torch.Tensor, n_solid: int, k: int):
    """Plain PyTorch version of the key-build kernel: returns
    (keys (K, 2C), payload (2C,)), suffix entries at [0, C), prefix
    entries at [C, 2C)."""
    C = solid.shape[1]
    suf = ln.suffix_kminus1(solid, k)
    pre = ln.prefix_kminus1(solid, k)
    suf_c, sig = ln.canonical(suf, k - 1)
    pre_c, tau = ln.canonical(pre, k - 1)
    ids = torch.arange(C, device=solid.device)
    valid = ids < n_solid
    vs = valid & ~ln.is_palindrome(suf, k - 1)
    vp = valid & ~ln.is_palindrome(pre, k - 1)
    oid_s = torch.where(sig, ids + C, ids)
    oid_p = torch.where(tau, ids + C, ids)
    payload = torch.cat([oid_s | (sig.to(torch.int64) << _ROLE_SHIFT),
                         oid_p | ((~tau).to(torch.int64) << _ROLE_SHIFT)])
    if use_hash_keys(k):
        hs, hp = hash96(suf_c), hash96(pre_c)
        keys = torch.stack([
            torch.cat([torch.where(vs, hs[i], SENTINEL),
                       torch.where(vp, hp[i], SENTINEL)]) for i in range(3)])
    else:
        keys = torch.cat([torch.where(vs[None], suf_c, SENTINEL),
                          torch.where(vp[None], pre_c, SENTINEL)], dim=1)
    return keys, payload


def junction_keys(solid: torch.Tensor, n_solid: int, k: int):
    if solid.device.type == "cpu":
        return junction_keys_plain(solid, n_solid, k)
    return _kernels.junction_keys(solid, n_solid, k, use_hash_keys(k),
                                  key_rows(k))


def junction_pairs_plain(s_keys: torch.Tensor, s_pay: torch.Tensor, C: int,
                         hashed: bool) -> torch.Tensor:
    """Plain PyTorch version of the pair kernel over sorted entries."""
    E = s_pay.shape[0]
    dev = s_pay.device
    if hashed:
        s_valid = ~torch.all(s_keys == SENTINEL, dim=0)
    else:
        s_valid = s_keys[0] != SENTINEL
    f = torch.zeros((1,), dtype=torch.bool, device=dev)
    eq_prev = torch.cat([f, torch.all(s_keys[:, 1:] == s_keys[:, :-1], dim=0)])
    eq_next = torch.cat([eq_prev[1:], f])
    pair_head = s_valid & ~eq_prev & eq_next & ~torch.cat([eq_next[1:], f])
    nxt_pay = torch.cat([s_pay[1:], torch.zeros((1,), dtype=torch.int64,
                                                device=dev)])
    role_a, role_b = s_pay >> _ROLE_SHIFT, nxt_pay >> _ROLE_SHIFT
    oid_a, oid_b = s_pay & _OID_MASK, nxt_pay & _OID_MASK
    vert_a = torch.where(oid_a >= C, oid_a - C, oid_a)
    vert_b = torch.where(oid_b >= C, oid_b - C, oid_b)
    ok = pair_head & (role_a != role_b) & (vert_a != vert_b)
    src = torch.where(role_a == ROLE_OUT, oid_a, oid_b)[ok]
    dst = torch.where(role_a == ROLE_OUT, oid_b, oid_a)[ok]
    succ = torch.full((2 * C,), -1, dtype=torch.int64, device=dev)
    succ[src] = dst
    succ[torch.where(dst >= C, dst - C, dst + C)] = torch.where(
        src >= C, src - C, src + C)
    return succ


def junction_pairs(s_keys, s_pay, C: int, hashed: bool) -> torch.Tensor:
    if s_pay.device.type == "cpu":
        return junction_pairs_plain(s_keys, s_pay, C, hashed)
    return _kernels.junction_pairs(s_keys, s_pay, C, hashed)


def successor_arrays(solid: torch.Tensor, n_solid: int, k: int) -> torch.Tensor:
    """(2C,) int64 unitig-successor oriented id per oriented node, -1 if
    none (solid: (L, C), columns >= n_solid ignored)."""
    C = solid.shape[1]
    keys, payload = junction_keys(solid, n_solid, k)
    perm = sort_op.lex_argsort([keys[r] for r in range(keys.shape[0])])
    return junction_pairs(keys[:, perm].contiguous(), payload[perm], C,
                          use_hash_keys(k))


# ---- global mode: the sharded junction matching of the -devices N build
# (bcalm_tpu/parallel/distcompact.py:_local_succ_shard) ----

def strand_folded(k: int) -> bool:
    """The strand bit fits the spare bits of the top key lane."""
    return ln.top_lane_bases(k - 1) < 16


def entry_key_rows(k: int) -> int:
    """Rows of a global-mode entry key: the (k-1)-mer lanes, plus a strand
    row when k-1 is a multiple of 16 (always exact, never hashed)."""
    return ln.num_lanes(k - 1) + (0 if strand_folded(k) else 1)


def _make_keys(keys: torch.Tensor, strand: torch.Tensor, valid: torch.Tensor,
               k: int) -> torch.Tensor:
    """Fold the strand (and the validity sentinel) into (L2, N) key lanes
    (bcalm_tpu junctions._make_keys)."""
    if strand_folded(k):
        r = ln.top_lane_bases(k - 1)
        out = torch.cat([(keys[0] | (strand << (2 * r)))[None], keys[1:]])
    else:
        out = torch.cat([strand[None], keys])
    return torch.where(valid[None], out, SENTINEL)


def junction_entries_plain(solid: torch.Tensor, n_local: int, k: int,
                           gbase: int, tot: int, n_dev: int):
    """Plain version of K3a's global mode: the four junction entries of
    each local k-mer, (keys (K, 4N), payload (4N,), owner (4N,)); suffix
    entries at [0, 2N), prefix entries at [2N, 4N); oriented ids global
    (gbase + i, + tot for the - strand); owner = hash_lanes(key) % n_dev."""
    from bcalm_tpu_torch.ops import hashing

    N = solid.shape[1]
    dev = solid.device
    suf = ln.suffix_kminus1(solid, k)
    pre = ln.prefix_kminus1(solid, k)
    suf_c, sig = ln.canonical(suf, k - 1)
    pre_c, tau = ln.canonical(pre, k - 1)
    suf_pal = ln.is_palindrome(suf, k - 1)
    pre_pal = ln.is_palindrome(pre, k - 1)
    sig = torch.where(suf_pal, False, sig).to(torch.int64)
    tau = torch.where(pre_pal, False, tau).to(torch.int64)
    inv_sig = torch.where(suf_pal, 0, 1 - sig)
    inv_tau = torch.where(pre_pal, 0, 1 - tau)
    ids = torch.arange(N, device=dev)
    valid1 = ids < n_local
    keys = torch.cat([_make_keys(suf_c, sig, valid1, k),
                      _make_keys(suf_c, inv_sig, valid1, k),
                      _make_keys(pre_c, tau, valid1, k),
                      _make_keys(pre_c, inv_tau, valid1, k)], dim=1)
    g = gbase + ids
    oid = torch.cat([g, g + tot, g, g + tot])
    role = torch.cat([torch.zeros(N, dtype=torch.int64, device=dev),
                      torch.ones(N, dtype=torch.int64, device=dev),
                      torch.ones(N, dtype=torch.int64, device=dev),
                      torch.zeros(N, dtype=torch.int64, device=dev)])
    payload = oid | (role << _ROLE_SHIFT)
    return keys, payload, hashing.hash_lanes(keys) % n_dev


def junction_entries(solid: torch.Tensor, n_local: int, k: int, gbase: int,
                     tot: int, n_dev: int):
    """K3a global-mode entry: kernel for CUDA tensors, plain version for
    CPU tensors."""
    if solid.device.type == "cpu":
        return junction_entries_plain(solid, n_local, k, gbase, tot, n_dev)
    return _kernels.junction_entries(solid, n_local, k, gbase, tot, n_dev,
                                     entry_key_rows(k))


def junction_edges_plain(s_keys: torch.Tensor, s_pay: torch.Tensor, tot: int):
    """Plain version of K3b's global mode: per sorted entry, (ok, src, dst)
    of the pair rule (a group of exactly two entries, one OUT and one IN,
    on distinct vertices; src/dst are meaningful where ok)."""
    dev = s_pay.device
    s_valid = s_keys[0] != SENTINEL
    f = torch.zeros((1,), dtype=torch.bool, device=dev)
    eq_prev = torch.cat([f, torch.all(s_keys[:, 1:] == s_keys[:, :-1], dim=0)])
    eq_next = torch.cat([eq_prev[1:], f])
    pair_head = s_valid & ~eq_prev & eq_next & ~torch.cat([eq_next[1:], f])
    nxt_pay = torch.cat([s_pay[1:], torch.zeros((1,), dtype=torch.int64,
                                                device=dev)])
    role_a, role_b = s_pay >> _ROLE_SHIFT, nxt_pay >> _ROLE_SHIFT
    oid_a, oid_b = s_pay & _OID_MASK, nxt_pay & _OID_MASK
    vert_a = torch.where(oid_a >= tot, oid_a - tot, oid_a)
    vert_b = torch.where(oid_b >= tot, oid_b - tot, oid_b)
    ok = pair_head & (role_a != role_b) & (vert_a != vert_b)
    src = torch.where(role_a == ROLE_OUT, oid_a, oid_b)
    dst = torch.where(role_a == ROLE_OUT, oid_b, oid_a)
    return ok, src, dst


def junction_edges(s_keys: torch.Tensor, s_pay: torch.Tensor, tot: int):
    """K3b global-mode entry: kernel for CUDA tensors, plain version for
    CPU tensors."""
    if s_pay.device.type == "cpu":
        return junction_edges_plain(s_keys, s_pay, tot)
    return _kernels.junction_edges(s_keys, s_pay, tot)
