"""Chain extraction by pointer doubling over the successor graph (K4).

Counterpart of ``bcalm_tpu/ops/chains.py``: ``build_pred``, ``_init_Q``,
``_composeF``, ``_phase`` (without fixpoints), ``plain_jumpF`` and
``finish_fast``.  The packed state row is (ptr, dist|flags, mn, dmn) with
the flags in bits 28-30 of the dist column and dist saturating at
``_DMASK``, as in the JAX package; the port holds it as an (M, 4) int64
tensor.

The JAX package switches to a hierarchical sampled jump (``hier_jump``)
for M >= 2**18; its output equals the plain doubling's, so the port always
runs the plain doubling.  Each round is :func:`jump_round`, which launches
the K4 kernel (csrc/chains.cu) for CUDA tensors and runs
:func:`jump_round_plain` for CPU tensors; :func:`finish_fast` likewise
launches K10 (csrc/finish.cu) or runs :func:`finish_fast_plain`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bcalm_tpu_torch.ops import _kernels

_PTR, _DSF, _MN, _DMN = 0, 1, 2, 3
_F_SETTLED = 1 << 28
_F_FIX = 1 << 29
_F_ROOTED = 1 << 30
_DMASK = (1 << 28) - 1


def _mirror(x: torch.Tensor, N: int) -> torch.Tensor:
    return torch.where(x >= N, x - N, x + N)


def max_rounds(M: int) -> int:
    """Doubling rounds covering any chain or cycle (window 2^t >= M); the
    cap is what ends the loop on cycles, whose ptr never settles."""
    return max(1, int(math.ceil(math.log2(max(M, 2)))) + 1)


def build_pred(succ: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Predecessor array from the mirror symmetry:
    pred(v) = mirror(succ(mirror(v)))."""
    N = succ.shape[0] // 2
    succ = torch.where(valid, succ, -1)
    s_m = torch.cat([succ[N:], succ[:N]])
    return torch.where(s_m >= 0, _mirror(s_m, N), -1)


def init_state(pred: torch.Tensor, valid: torch.Tensor,
               dist0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Initial (M, 4) state; dist0 is the weight of the edge v -> pred(v)
    (1 when None)."""
    M = pred.shape[0]
    idx = torch.arange(M, device=pred.device)
    has_pred = (pred >= 0) & valid
    d0 = torch.ones_like(idx) if dist0 is None else dist0
    return torch.stack([
        torch.where(has_pred, pred, idx),
        torch.where(has_pred, d0, _F_ROOTED | _F_SETTLED),
        torch.where(valid, idx, M),
        torch.zeros_like(idx),
    ], dim=1).contiguous()


def compose_plain(Q: torch.Tensor, anc: torch.Tensor) -> torch.Tensor:
    """Each row composed with its ancestor's row (bcalm_tpu chains
    _composeF); ROOTED rows come back unchanged (csrc/compose.cuh)."""
    qd, ad = Q[:, _DSF], anc[:, _DSF]
    dq = qd & _DMASK
    dist = torch.clamp(dq + (ad & _DMASK), max=_DMASK)
    stop = (ad & (_F_FIX | _F_ROOTED)) != 0
    flg = ((qd | ad) & _F_ROOTED) | torch.where(stop, _F_SETTLED, 0)
    better = anc[:, _MN] < Q[:, _MN]
    new = torch.stack([
        anc[:, _PTR],
        dist | flg,
        torch.minimum(Q[:, _MN], anc[:, _MN]),
        torch.where(better, dq + anc[:, _DMN], Q[:, _DMN]),
    ], dim=1)
    rooted = (qd & _F_ROOTED) != 0
    return torch.where(rooted[:, None], Q, new)


def jump_round_plain(Q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the K4 kernel: one doubling round."""
    M = Q.shape[0]
    return compose_plain(Q, Q[torch.clamp(Q[:, _PTR], 0, M - 1)])


def jump_round(Q: torch.Tensor, Qn: torch.Tensor,
               changed: torch.Tensor) -> None:
    """One round Q -> Qn; changed[0] is set to 1 when any row moved."""
    if Q.device.type == "cpu":
        Qn.copy_(jump_round_plain(Q))
        if not torch.equal(Qn, Q):
            changed.fill_(1)
    else:
        _kernels.jump_round(Q, Qn, changed)


def plain_jumpF(pred: torch.Tensor, valid: torch.Tensor,
                dist0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Doubling rounds to convergence, capped at max_rounds(M) + 1."""
    M = pred.shape[0]
    Q = init_state(pred, valid, dist0)
    Qn = torch.empty_like(Q)
    changed = torch.zeros((1,), dtype=torch.int32, device=Q.device)
    for _ in range(max_rounds(M) + 1):
        changed.zero_()
        jump_round(Q, Qn, changed)
        Q, Qn = Qn, Q
        if not int(changed.item()):
            break
    return Q


def finish_fast_plain(succ: torch.Tensor, pred: torch.Tensor,
                      valid: torch.Tensor, state: torch.Tensor,
                      wlen: Optional[torch.Tensor] = None):
    """Plain version of K10 (bcalm_tpu finish_fast): chain start, rank,
    cycle break, mirror dedup and per-unitig arrays from a converged
    state; out-of-range scatter destinations are masked before the
    writes."""
    M = succ.shape[0]
    N = M // 2
    dev = succ.device
    idx = torch.arange(M, device=dev)
    succ = torch.where(valid, succ, -1)
    has_pred = pred >= 0
    ptr = state[:, _PTR]
    dist = state[:, _DSF] & _DMASK
    mn = state[:, _MN]
    dmn = state[:, _DMN]
    rooted = (state[:, _DSF] & _F_ROOTED) != 0

    in_cycle = valid & ~rooted
    break_node = in_cycle & (mn == idx)
    start = torch.where(in_cycle, mn, ptr)
    rank = torch.where(in_cycle, dmn, dist)
    is_start = valid & (~has_pred | break_node)
    is_end = valid & ((succ < 0) | (in_cycle & (succ == mn)))

    w_end = 1 if wlen is None else wlen[is_end]
    end_of = torch.full((M,), -1, dtype=torch.int64, device=dev)
    end_of[start[is_end]] = idx[is_end]
    length_at_start = torch.full((M,), -1, dtype=torch.int64, device=dev)
    length_at_start[start[is_end]] = rank[is_end] + w_end

    mirror_start = torch.where(break_node, torch.roll(mn, N),
                               _mirror(torch.where(end_of >= 0, end_of, idx), N))
    keep = is_start & (end_of >= 0) & (idx < mirror_start)
    uid_at_start = torch.cumsum(keep.to(torch.int64), 0) - 1
    n_unitigs = keep.sum()
    ks = torch.where(keep, uid_at_start, -1)
    val = ks[torch.clamp(start, 0, M - 1)]
    uid = torch.where(valid & (val >= 0), val, -1)

    pk = length_at_start | torch.where(break_node, 1 << 30, 0)
    start_oid = torch.zeros((M,), dtype=torch.int64, device=dev)
    lenw = torch.zeros((M,), dtype=torch.int64, device=dev)
    start_oid[uid_at_start[keep]] = idx[keep]
    lenw[uid_at_start[keep]] = pk[keep]
    return {
        "uid": uid,
        "rank": torch.where(uid >= 0, rank, 0),
        "n_unitigs": n_unitigs.reshape(1),
        "start_oid": start_oid,
        "length": lenw & ((1 << 30) - 1),
        "circular": (lenw & (1 << 30)) != 0,
    }


def finish_fast(succ: torch.Tensor, pred: torch.Tensor, valid: torch.Tensor,
                state: torch.Tensor, wlen: Optional[torch.Tensor] = None):
    """K10 entry: kernel for CUDA tensors, plain version for CPU tensors.
    n_unitigs is a (1,) tensor."""
    if succ.device.type == "cpu":
        return finish_fast_plain(succ, pred, valid, state, wlen)
    return _kernels.chain_finish(succ, pred, valid, state, wlen)


def chain_decompose(succ: torch.Tensor, valid: torch.Tensor):
    """Deduplicated unitig chains of a mirror-symmetric successor graph
    (bcalm_tpu chain_decompose; always the plain doubling)."""
    pred = build_pred(succ, valid)
    return finish_fast(succ, pred, valid, plain_jumpF(pred, valid))
