"""Locality-ordered chain decomposition: contract consecutive runs first.

Counterpart of ``bcalm_tpu/ops/runchains.py``.  The solid table is
reordered by first-occurrence key and flipped to its as-read strand, so
consecutive k-mers of a read sit at consecutive indices; maximal runs of
consecutive links are contracted with scans, pointer jumping (ops.chains,
weighted by run length) runs on the contracted run graph, and unitig
ids/ranks are broadcast back over the runs.

The JAX package writes its scans as log-doubling shifts for the TPU
compiler; here :func:`run_scans` launches the K8 block scan
(csrc/runscan.cu) for CUDA tensors and runs :func:`run_scans_plain`
(``torch.cumsum``/``cummax``/``cummin``) for CPU tensors.  run_decompose's
contraction and broadcast are :func:`run_contract` and
:func:`run_broadcast` (K12, csrc/runcontract.cu), which read the same
scans: a head i is run ``rid[i]``, ``head_pos`` is the nearest head at or
before each entry and ``end_pos`` the nearest tail at or after it, so each
member gathers its run's values directly (JAX scatters them at the heads
and tails and fills).
"""

from __future__ import annotations

import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels
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


def run_scans_plain(succ: torch.Tensor, n_solid: int, C: int, gbase: int = 0):
    """Plain version of K8: the consecutive-run structure of [0, C) from
    the successor array (entry i links to i+1 when succ[i] == gbase+i+1;
    gbase is a rank's first global slot in the sharded glue).  Returns
    (is_head, is_tail, rid, head_pos, end_pos, R (1,)); head_pos is -1
    before the first head, end_pos is C past the last tail."""
    idx = torch.arange(C, device=succ.device)
    vplus = idx < n_solid
    nxt = vplus & (succ[:C] == gbase + idx + 1) & (idx + 1 < C)
    prev = torch.cat([torch.zeros((1,), dtype=torch.bool, device=idx.device),
                      nxt[:-1]])
    is_head = vplus & ~prev
    is_tail = vplus & ~nxt
    rid = torch.cumsum(is_head.to(torch.int64), 0) - 1
    head_pos = torch.cummax(torch.where(is_head, idx, -1), 0).values
    end_pos = torch.cummin(torch.where(is_tail, idx, C).flip(0), 0).values.flip(0)
    return is_head, is_tail, rid, head_pos, end_pos, is_head.sum().reshape(1)


def run_scans(succ: torch.Tensor, n_solid: int, C: int, gbase: int = 0):
    """K8 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if succ.device.type == "cpu":
        return run_scans_plain(succ, n_solid, C, gbase)
    return _kernels.run_scans(succ, n_solid, C, gbase)


def junction_runs(solid_r: torch.Tensor, n_solid: int, k: int):
    """Successor array plus the consecutive-run structure of the + half:
    (succ, {is_head, is_tail, rid, head_pos, end_pos, R})."""
    C = solid_r.shape[1]
    succ = junctions_op.successor_arrays(solid_r, n_solid, k)
    is_head, is_tail, rid, head_pos, end_pos, R = run_scans(succ, n_solid, C)
    return succ, {"is_head": is_head, "is_tail": is_tail, "rid": rid,
                  "head_pos": head_pos, "end_pos": end_pos, "R": int(R[0])}


def run_contract_plain(succ: torch.Tensor, is_head: torch.Tensor,
                       rid: torch.Tensor, end_pos: torch.Tensor, R: int,
                       R_cap: int):
    """Plain version of K12a: the contracted run graph.  Returns (hpos,
    epos (R_cap,), csucc, cvalid, wlen2 (2 R_cap,)); run slots past R are
    padded with hpos = C-1, as JAX's sort-based selection pads."""
    C = is_head.shape[0]
    M = 2 * C
    dev = succ.device
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
    return (hpos, epos, torch.cat([xlate(w_plus), xlate(w_minus)]),
            torch.cat([rvalid, rvalid]), torch.cat([rlen, rlen]))


def run_contract(succ, is_head, rid, end_pos, R: int, R_cap: int):
    """K12a entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if succ.device.type == "cpu":
        return run_contract_plain(succ, is_head, rid, end_pos, R, R_cap)
    return _kernels.run_contract(succ, is_head, rid, end_pos, R, R_cap)


def run_broadcast_plain(cuid, crank, cstart, rid, head_pos, end_pos, hpos,
                        epos, n_solid: int):
    """Plain version of K12b: the contracted chains broadcast over the run
    members, (uid, rank (2C,)), and the unitig starts as original oriented
    ids (start_oid (2 R_cap,))."""
    C = rid.shape[0]
    R_cap = hpos.shape[0]
    idx = torch.arange(C, device=rid.device)
    vplus = idx < n_solid
    r = torch.clamp(rid, 0, R_cap - 1)
    uid_plus = torch.where(vplus, cuid[r], -1)
    uid_minus = torch.where(vplus, cuid[r + R_cap], -1)
    rank_plus = crank[r] + (idx - head_pos)
    rank_minus = crank[r + R_cap] + (end_pos - idx)
    uid = torch.cat([uid_plus, uid_minus])
    rank = torch.where(uid >= 0, torch.cat([rank_plus, rank_minus]), 0)
    csv = torch.clamp(torch.where(cstart >= R_cap, cstart - R_cap, cstart),
                      0, R_cap - 1)
    start_oid = torch.where(cstart >= R_cap, C + epos[csv], hpos[csv])
    return uid, rank, start_oid


def run_broadcast(cuid, crank, cstart, rid, head_pos, end_pos, hpos, epos,
                  n_solid: int):
    """K12b entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if rid.device.type == "cpu":
        return run_broadcast_plain(cuid, crank, cstart, rid, head_pos,
                                   end_pos, hpos, epos, n_solid)
    return _kernels.run_broadcast(cuid, crank, cstart, rid, head_pos, end_pos,
                                  hpos, epos, n_solid)


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
    hpos, epos, csucc, cvalid, wlen2 = run_contract(succ, is_head, rid,
                                                    end_pos, R, R_cap)
    cinfo = contracted_jump(csucc, cvalid, wlen2)
    uid, rank, start_oid = run_broadcast(cinfo["uid"], cinfo["rank"],
                                         cinfo["start_oid"], rid, head_pos,
                                         end_pos, hpos, epos, n_solid)
    return {"uid": uid, "rank": rank, "n_unitigs": cinfo["n_unitigs"],
            "start_oid": start_oid, "length": cinfo["length"],
            "circular": cinfo["circular"]}
