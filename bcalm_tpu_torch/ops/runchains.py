"""Locality-ordered chain decomposition: contract consecutive runs first.

Counterpart of ``bcalm_tpu/ops/runchains.py``.  The solid table is
reordered by first-occurrence key and flipped to its as-read strand, so
consecutive k-mers of a read sit at consecutive indices; maximal runs of
consecutive links are contracted with scans, pointer jumping (ops.chains,
weighted by run length) runs on the contracted run graph, and unitig
ids/ranks are broadcast back over the runs.

The JAX package writes its scans as log-doubling shifts for the TPU
compiler; here they are ``torch.cummax``/``torch.cummin`` and
index-carrying fills.
"""

from __future__ import annotations

import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import chains as chains_op
from bcalm_tpu_torch.ops import junctions as junctions_op
from bcalm_tpu_torch.ops import sort as sort_op


def round_capacity(n: int) -> int:
    """Next power of two >= max(n, 16) (the JAX package's capacity classes;
    oriented ids depend on them, so the port keeps them)."""
    c = 16
    while c < n:
        c *= 2
    return c


def reorder_by_pos(solid: torch.Tensor, counts: torch.Tensor,
                   minpos: torch.Tensor, k: int):
    """Sort the solid set by first-occurrence key and flip each k-mer to
    its as-read orientation (key LSB).  Returns (solid_r, counts_r)."""
    perm = sort_op.lex_argsort([minpos])
    lanes = solid[:, perm]
    pos_s = minpos[perm]
    strand = (pos_s & 1) == 1
    return torch.where(strand[None], ln.revcomp(lanes, k), lanes), counts[perm]


def _cummin_rev(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(0), 0).values.flip(0)


def junction_runs(solid_r: torch.Tensor, n_solid: int, k: int):
    """Successor array plus the consecutive-run structure of the + half:
    (succ, {is_head, rid, head_pos, end_pos, R})."""
    C = solid_r.shape[1]
    succ = junctions_op.successor_arrays(solid_r, n_solid, k)
    idx = torch.arange(C, device=solid_r.device)
    vplus = idx < n_solid
    nxt = vplus & (succ[:C] == idx + 1) & (idx + 1 < C)
    prev = torch.cat([torch.zeros((1,), dtype=torch.bool, device=idx.device),
                      nxt[:-1]])
    is_head = vplus & ~prev
    is_tail = vplus & ~nxt
    rid = torch.cumsum(is_head.to(torch.int64), 0) - 1
    head_pos = torch.cummax(torch.where(is_head, idx, -1), 0).values
    end_pos = _cummin_rev(torch.where(is_tail, idx, C))
    return succ, {"is_head": is_head, "rid": rid, "head_pos": head_pos,
                  "end_pos": end_pos, "R": int(is_head.sum())}


def _fill(have: torch.Tensor, vals, reverse: bool = False):
    """Each position takes the values of the nearest position at or before
    it (at or after it when reverse) where `have` is set; 0 where there is
    none (the JAX _ffill's fill value)."""
    n = have.shape[0]
    idx = torch.arange(n, device=have.device)
    if reverse:
        src = _cummin_rev(torch.where(have, idx, n))
        found = src < n
    else:
        src = torch.cummax(torch.where(have, idx, -1), 0).values
        found = src >= 0
    src = torch.clamp(src, 0, n - 1)
    return tuple(torch.where(found, v[src], 0) for v in vals)


def contracted_jump(csucc: torch.Tensor, cvalid: torch.Tensor,
                    wlen2: torch.Tensor):
    """Weighted pointer jump + finish over a contracted run graph."""
    R2 = csucc.shape[0]
    cpred = chains_op.build_pred(csucc, cvalid)
    dist0 = wlen2[torch.clamp(cpred, 0, R2 - 1)]
    state = chains_op.plain_jumpF(cpred, cvalid, dist0)
    return chains_op.finish_fast(csucc, cpred, cvalid, state, wlen=wlen2)


def run_decompose(succ: torch.Tensor, n_solid: int, is_head, rid, head_pos,
                  end_pos, R: int, R_cap: int):
    """Chain decomposition over the contracted run graph; the output
    contract of ops.chains.chain_decompose with per-unitig arrays of
    length 2*R_cap."""
    M = succ.shape[0]
    C = M // 2
    dev = succ.device
    idx = torch.arange(C, device=dev)
    vplus = idx < n_solid

    # run representatives: heads in index order, padded with C-1
    hpos = torch.full((R_cap,), C - 1, dtype=torch.int64, device=dev)
    hpos[:R] = torch.nonzero(is_head).flatten()
    rvalid = torch.arange(R_cap, device=dev) < R
    epos = end_pos[hpos]
    rlen = torch.where(rvalid, epos - hpos + 1, 0)

    def xlate(w):
        wv = torch.where(w >= C, w - C, w)
        r_t = rid[torch.clamp(wv, 0, C - 1)]
        c = torch.where(w >= C, r_t + R_cap, r_t)
        return torch.where((w >= 0) & rvalid, c, -1)

    w_plus = succ[torch.clamp(epos, 0, C - 1)]
    w_minus = succ[torch.clamp(hpos + C, 0, M - 1)]
    csucc = torch.cat([xlate(w_plus), xlate(w_minus)])
    cvalid = torch.cat([rvalid, rvalid])
    wlen2 = torch.cat([rlen, rlen])
    cinfo = contracted_jump(csucc, cvalid, wlen2)

    cstart = cinfo["start_oid"]
    csv = torch.clamp(torch.where(cstart >= R_cap, cstart - R_cap, cstart),
                      0, R_cap - 1)
    orig_start = torch.where(cstart >= R_cap, C + epos[csv], hpos[csv])

    cuid, crank = cinfo["uid"], cinfo["rank"]
    a_uid = torch.full((C,), -1, dtype=torch.int64, device=dev)
    a_rank = torch.zeros((C,), dtype=torch.int64, device=dev)
    a_uid[hpos[rvalid]] = cuid[:R_cap][rvalid]
    a_rank[hpos[rvalid]] = crank[:R_cap][rvalid]
    uid_p, rank_p = _fill(is_head, (a_uid, a_rank))
    uid_plus = torch.where(vplus, uid_p, -1)
    rank_plus = rank_p + (idx - head_pos)

    is_tail = end_pos == idx
    b_uid = torch.full((C,), -1, dtype=torch.int64, device=dev)
    b_rank = torch.zeros((C,), dtype=torch.int64, device=dev)
    b_uid[epos[rvalid]] = cuid[R_cap:][rvalid]
    b_rank[epos[rvalid]] = crank[R_cap:][rvalid]
    uid_m, rank_m = _fill(is_tail, (b_uid, b_rank), reverse=True)
    uid_minus = torch.where(vplus, uid_m, -1)
    rank_minus = rank_m + (end_pos - idx)

    uid = torch.cat([uid_plus, uid_minus])
    rank = torch.where(uid >= 0, torch.cat([rank_plus, rank_minus]), 0)
    return {"uid": uid, "rank": rank, "n_unitigs": cinfo["n_unitigs"],
            "start_oid": orig_start, "length": cinfo["length"],
            "circular": cinfo["circular"]}
