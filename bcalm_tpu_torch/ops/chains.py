"""Chain extraction by pointer jumping over the successor graph.

Counterpart of ``bcalm_tpu/ops/chains.py``: ``build_pred``, ``_init_Q``,
``_composeF``, ``_phase``, ``plain_jumpF``, ``hier_jump``, ``finish_fast``
and ``chain_decompose``.  The packed state row is (ptr, dist|flags, mn,
dmn) with the flags in bits 28-30 of the dist column and dist saturating
at ``_DMASK``, as in the JAX package; the port holds it as an (M, 4) int64
tensor.

chain_decompose picks the hierarchical jump (:func:`hier_jump`) for M >=
``_HIER_MIN`` (variant "auto"), as JAX does: per level, _R_A doubling
rounds in which sampled fixpoint rows answer as identity rows (K17,
:func:`hier_round`), the contraction to a level a quarter the size (K18,
:func:`hier_contract`), plain doubling at the deepest level (K4,
:func:`jump_round`), and the upward composition (K19,
:func:`hier_expand`).  Below it, for variant "plain", and for "auto" after
a level overflowed, the plain doubling runs alone; a converging phase
syncs with the host after its first round, then once every ``_BATCH``
rounds (:func:`_phase`).  Each
wrapper launches its kernel (csrc/hier.cu) for CUDA tensors and runs its
``*_plain`` version for CPU tensors; :func:`finish_fast` likewise
launches K10 (csrc/finish.cu) or runs :func:`finish_fast_plain`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels
from bcalm_tpu_torch.ops.hashing import _mul32

_PTR, _DSF, _MN, _DMN = 0, 1, 2, 3
_F_SETTLED = 1 << 28
_F_FIX = 1 << 29
_F_ROOTED = 1 << 30
_DMASK = (1 << 28) - 1

_HIER_MIN = 1 << 18     # below this, plain doubling (as in the JAX package)
_FINAL_CAP = 1 << 15    # deepest level size: plain doubling there
_SAMPLE_DIV = 8         # fixpoint sampling rate 1/8
_LEVEL_SHRINK = 4       # static capacity per level
_R_A = 5                # phase-A rounds per level (gaps <= 32)
_BATCH = 4              # rounds of a converging phase between host syncs
                        # (its first batch is one round)
VARIANTS = ("auto", "plain", "hier")
# converging phases (_phase's converge=True) since reset_rounds(): the
# rounds launched, the rounds that moved a row, the host syncs
ROUNDS = {"launched": 0, "moved": 0, "syncs": 0}


def reset_rounds() -> None:
    for name in ROUNDS:
        ROUNDS[name] = 0


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


def jump_round(Q: torch.Tensor, Qn: torch.Tensor, changed=None, *,
               at=None) -> None:
    """One round Q -> Qn; changed[0] (optional) is set to 1 when any row
    moved; at = r, the flag mode of a converging phase: changed holds a
    word a round, this round sets word r and, for r > 0, returns at once,
    reading and writing no row, when word r - 1 is 0."""
    if Q.device.type != "cpu":
        _kernels.jump_round(Q, Qn, changed, at=at)
        return
    if at is not None and at > 0 and not int(changed[at - 1]):
        return
    Qn.copy_(jump_round_plain(Q))
    if changed is not None and not torch.equal(Qn, Q):
        changed[0 if at is None else at] = 1


def _identity_rows(local_idx: torch.Tensor, gid: torch.Tensor,
                   flg_rooted: torch.Tensor) -> torch.Tensor:
    """Rows a fixpoint serves: (local id, FIX [| ROOTED | SETTLED], gid, 0)."""
    flags = torch.where(flg_rooted, _F_FIX | _F_ROOTED | _F_SETTLED, _F_FIX)
    return torch.stack([local_idx, flags, gid, torch.zeros_like(local_idx)],
                       dim=1)


def _sampled(gid: torch.Tensor, salt: int) -> torch.Tensor:
    """Murmur-style level sample (1 in _SAMPLE_DIV), u32 wraparound through
    _mul32: gid may reach M (filler rows)."""
    h = (gid & ln.U32) ^ (salt & ln.U32)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h % _SAMPLE_DIV) == 0


def _absorbing_filler(S: int, big: int, device) -> torch.Tensor:
    """Filler rows for unused level slots: rooted identity, mn = big."""
    idx = torch.arange(S, device=device)
    return torch.stack([idx, torch.full_like(idx, _F_ROOTED | _F_SETTLED),
                        torch.full_like(idx, big), torch.zeros_like(idx)], dim=1)


def _level_gid(gid, S: int, device) -> torch.Tensor:
    """gid None stands for level 0, whose gid is the row index."""
    return torch.arange(S, device=device) if gid is None else gid


def fixpoint_bits_plain(gid, valid: torch.Tensor, salt: int) -> torch.Tensor:
    """Plain version of K17's bitmap: bit v % 32 of word v // 32 is
    valid[v] & _sampled(gid[v], salt) (gid None: level 0), as
    (ceil(S / 32),) int32 words, rows past S zero."""
    S = valid.shape[0]
    fix = _sampled(_level_gid(gid, S, valid.device), salt) & valid
    pad = torch.zeros((-(-S // 32) * 32,), dtype=torch.int64,
                      device=valid.device)
    pad[:S] = fix.to(torch.int64)
    shift = torch.arange(32, device=valid.device)
    words = (pad.reshape(-1, 32) << shift).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def fixpoint_bits(gid, valid: torch.Tensor, salt: int) -> torch.Tensor:
    """The level's fixpoint bitmap (K17's, built once per level)."""
    if valid.device.type == "cpu":
        return fixpoint_bits_plain(gid, valid, salt)
    return _kernels.fixpoint_bits(gid, valid, salt)


def hier_round_plain(Q: torch.Tensor, gid, bits: torch.Tensor) -> torch.Tensor:
    """Plain version of K17: one round of _phase with the level's fixpoints
    (bits, from fixpoint_bits_plain) served as identity rows; gid None:
    level 0 (gid is the row index).  JAX flags an identity row ROOTED when
    the row was ROOTED at the phase's start; such a row is ROOTED now and
    served as itself, so the current flag gives the same table."""
    S = Q.shape[0]
    idx = torch.arange(S, device=Q.device)
    fix = ((bits.to(torch.int64)[idx >> 5] >> (idx & 31)) & 1) != 0
    rooted = (Q[:, _DSF] & _F_ROOTED) != 0
    ident = _identity_rows(idx, _level_gid(gid, S, Q.device), rooted)
    T = torch.where((fix & ~rooted)[:, None], ident, Q)
    return compose_plain(Q, T[torch.clamp(Q[:, _PTR], 0, S - 1)])


def hier_round(Q: torch.Tensor, Qn: torch.Tensor, gid, bits: torch.Tensor) -> None:
    """One phase-A round Q -> Qn.  gid None: level 0; bits: the level's
    fixpoint_bits."""
    if Q.device.type == "cpu":
        Qn.copy_(hier_round_plain(Q, gid, bits))
    else:
        _kernels.hier_round(Q, Qn, gid, bits)


def _phase(Q0: torch.Tensor, gid, valid, salt, rounds: int,
           converge: bool = True) -> torch.Tensor:
    """Doubling rounds from Q0 (whose buffer is reused): with the sampled
    fixpoints of (gid, valid, salt) (K17; gid None at level 0), or none
    when salt is None (K4).
    converge=False runs exactly `rounds` rounds with no flag and no host
    sync.  converge=True (K4 only: plain_jumpF and the deepest level) is
    JAX's while_loop: it stops after a round that moved no row, or at the
    cap.  Its rounds take a flag word each, zeroed once (the flag mode of
    jump_round): a round after one that moved no row returns at once, so
    the state stays JAX's fixed point, and the host syncs after the first
    round and then once every _BATCH rounds (the deepest level is mostly
    converged from its first round, which then costs one launch and one
    sync); ROUNDS counts the rounds launched, those that moved a row and
    the syncs."""
    assert salt is None or not converge, "only K4's phase converges"
    Q = Q0
    Qn = torch.empty_like(Q)
    bits = None if salt is None else fixpoint_bits(gid, valid, salt)
    flags = (torch.zeros((rounds,), dtype=torch.int32, device=Q.device)
             if converge else None)
    seen, r = [], 0
    while r < rounds:
        end = min(rounds, r + (_BATCH if r else 1)) if converge else rounds
        for t in range(r, end):
            at = t if converge else None
            if salt is None:
                jump_round(Q, Qn, flags, at=at)
            else:
                hier_round(Q, Qn, gid, bits)
            Q, Qn = Qn, Q
        r = end
        if converge:
            seen = flags[:r].tolist()     # the batch's one host sync
            ROUNDS["syncs"] += 1
            if not seen[-1]:
                break
    if converge:
        ROUNDS["launched"] += r
        ROUNDS["moved"] += sum(seen)
    return Q


def plain_jumpF(pred: torch.Tensor, valid: torch.Tensor,
                dist0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Doubling rounds to convergence, capped at max_rounds(M) + 1."""
    M = pred.shape[0]
    return _phase(init_state(pred, valid, dist0), None, None, None,
                  max_rounds(M) + 1)


def hier_contract_plain(Q: torch.Tensor, gid: torch.Tensor,
                        valid: torch.Tensor, salt: int, S1: int, big: int,
                        ok: torch.Tensor):
    """Plain version of K18 (bcalm_tpu hier_jump's level build): the rows
    to keep (sampled fixpoints and the targets of unresolved rows, valid)
    in index order with their dense ids; (Q1 (S1, 4), gid1, valid1 (S1,),
    did (S,), parent (S1,), n_c (1,)); ok (1,) int32 cleared in place when
    n_c > S1."""
    S = Q.shape[0]
    dev = Q.device
    fix = _sampled(gid, salt) & valid
    flg = Q[:, _DSF]
    unres = valid & ((flg & (_F_SETTLED | _F_ROOTED)) == 0)
    tmask = torch.zeros((S,), dtype=torch.bool, device=dev)
    p = Q[:, _PTR][unres]
    tmask[p[(p >= 0) & (p < S)]] = True
    cmask = (fix | tmask) & valid
    did = torch.cumsum(cmask.to(torch.int64), 0) - 1
    n_c = cmask.sum().reshape(1)
    ok.mul_((n_c <= S1).to(torch.int32))
    did = torch.where(cmask, did, S1)
    sel = torch.nonzero(cmask).flatten()[:S1]
    n = sel.shape[0]
    parent = torch.zeros((S1,), dtype=torch.int64, device=dev)
    parent[:n] = sel
    Q1 = _absorbing_filler(S1, big, dev)
    Q1[:n] = Q[sel]
    gid1 = torch.full((S1,), big, dtype=torch.int64, device=dev)
    gid1[:n] = gid[sel]
    valid1 = torch.arange(S1, device=dev) < n
    # ROOTED rows keep their original-space ptr (never dereferenced)
    rooted1 = (Q1[:, _DSF] & _F_ROOTED) != 0
    ptr_new = did[torch.clamp(torch.where(rooted1, 0, Q1[:, _PTR]), 0, S - 1)]
    Q1[:, _PTR] = torch.where(rooted1, Q1[:, _PTR], ptr_new)
    # a level hop clears SETTLED/FIX (they were level-local)
    Q1[:, _DSF] &= _DMASK | _F_ROOTED
    return Q1, gid1, valid1, did, parent, n_c


def hier_contract(Q, gid, valid, salt: int, S1: int, big: int, ok):
    """K18 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if Q.device.type == "cpu":
        return hier_contract_plain(Q, gid, valid, salt, S1, big, ok)
    return _kernels.hier_contract(Q, gid, valid, salt, S1, big, ok)


def hier_expand_plain(F: torch.Tensor, parent: torch.Tensor, Qd: torch.Tensor,
                      did: torch.Tensor) -> torch.Tensor:
    """Plain version of K19 (bcalm_tpu hier_jump's upward pass): each row's
    phase-A span composed with the converged row of its target one level
    up, that row's ptr translated back through parent unless ROOTED."""
    S1, S = F.shape[0], Qd.shape[0]
    rooted_hi = (F[:, _DSF] & _F_ROOTED) != 0
    F_conv = F.clone()
    F_conv[:, _PTR] = torch.where(rooted_hi, F[:, _PTR],
                                  parent[torch.clamp(F[:, _PTR], 0, S1 - 1)])
    rooted_q = (Qd[:, _DSF] & _F_ROOTED) != 0
    tgt = did[torch.clamp(torch.where(rooted_q, 0, Qd[:, _PTR]), 0, S - 1)]
    return compose_plain(Qd, F_conv[torch.clamp(tgt, 0, S1 - 1)])


def hier_expand(F, parent, Qd, did) -> torch.Tensor:
    """K19 entry: kernel for CUDA tensors, plain version for CPU tensors;
    the result is written over Qd, which is returned."""
    if F.device.type == "cpu":
        return Qd.copy_(hier_expand_plain(F, parent, Qd, did))
    return _kernels.hier_expand(F, parent, Qd, did)


def level_sizes(M: int):
    """The static level schedule of hier_jump: M, M/4, ... while >= _FINAL_CAP."""
    sizes = [M]
    while sizes[-1] // _LEVEL_SHRINK >= _FINAL_CAP:
        sizes.append(sizes[-1] // _LEVEL_SHRINK)
    return sizes


def hier_jump(pred: torch.Tensor, valid: torch.Tensor,
              dist0: Optional[torch.Tensor] = None):
    """Hierarchical pointer jumping (bcalm_tpu hier_jump).  Returns (state,
    ok): the converged packed-flag state in the original node space, equal
    to JAX's row for row, and a (1,) bool tensor on the device, False when
    a level overflowed its capacity (the caller reruns the plain
    doubling).  No host sync outside the deepest level's rounds."""
    M = pred.shape[0]
    Q = init_state(pred, valid, dist0)
    gid = torch.arange(M, device=pred.device)
    lvl_valid = valid
    ok = torch.ones((1,), dtype=torch.int32, device=pred.device)
    sizes = level_sizes(M)
    stack = []
    for li in range(len(sizes) - 1):
        salt = (0x85EBCA6B * (li + 1)) & ln.U32
        # level 0's gid is the row index: K17 is told so, not given it
        Q = _phase(Q, gid if li else None, lvl_valid, salt, _R_A,
                   converge=False)
        Q1, gid1, valid1, did, parent, _ = hier_contract(
            Q, gid, lvl_valid, salt, sizes[li + 1], M, ok)
        stack.append((Q, did, parent))
        Q, gid, lvl_valid = Q1, gid1, valid1
    # deepest level: plain doubling to convergence, the cap covering cycles
    F = _phase(Q, None, None, None, max_rounds(sizes[-1]) + 1)
    # each level's phase-A state is read only here: K19 writes over it
    for Qd, did, parent in reversed(stack):
        F = hier_expand(F, parent, Qd, did)
    return F, ok.bool()


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


def jump_finish(succ: torch.Tensor, pred: torch.Tensor, valid: torch.Tensor,
                variant: str = "auto", dist0: Optional[torch.Tensor] = None,
                wlen: Optional[torch.Tensor] = None):
    """The pointer jump and its finish.  variant: "plain"; "hier", whose
    n_unitigs is -1 when a level overflowed; or "auto": hierarchical for M
    >= _HIER_MIN, as JAX picks, and after a level overflow the plain
    doubling, as the JAX package's compaction reruns it.  Only "auto"'s
    overflow check syncs with the host, and only where the hierarchical
    jump ran."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if variant == "plain" or (variant == "auto" and succ.shape[0] < _HIER_MIN):
        return finish_fast(succ, pred, valid, plain_jumpF(pred, valid, dist0),
                           wlen)
    state, ok = hier_jump(pred, valid, dist0)
    if variant == "auto":
        if not bool(ok):
            state = plain_jumpF(pred, valid, dist0)
        return finish_fast(succ, pred, valid, state, wlen)
    info = finish_fast(succ, pred, valid, state, wlen)
    info["n_unitigs"] = torch.where(ok, info["n_unitigs"], -1)
    return info


def chain_decompose(succ: torch.Tensor, valid: torch.Tensor,
                    variant: str = "auto"):
    """Deduplicated unitig chains of a mirror-symmetric successor graph
    (bcalm_tpu chain_decompose); variant as in jump_finish."""
    return jump_finish(succ, build_pred(succ, valid), valid, variant)
