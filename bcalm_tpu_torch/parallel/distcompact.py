"""Sharded compaction of the ``-devices N`` build.

Counterpart of ``bcalm_tpu/parallel/distcompact.py``'s device path
(``distributed_compact_dev``), one process per rank over
``parallel.mesh``:

1. reshard_pos: each rank sorts its solid k-mers by first-occurrence key,
   quantile pivots from every rank (all_gather) cut the key space, the
   k-mers move to the rank owning their range (K15 + all_to_all), are
   sorted again and flipped to their as-read strand; rank d then owns the
   global slots [d*slot_cap, (d+1)*slot_cap) in stream order;
2. local_succ_shard: the four junction entries of each local k-mer with
   global oriented ids (K3a, global mode) go to the rank owning
   hash_lanes(key) % n_dev (K15 + exchange); sorted there (torch.sort),
   the pair rule (K3b, global mode) finds the unitig edges, which go back
   to the rank owning their source slot (K15 + exchange) and fill its
   successor shard;
3. glue_shard: consecutive runs of the shard (K8 with a global slot
   base), the contracted run graph through request/response lookups at
   the owners, the sharded weighted doubling (per round: K15 + exchange of
   the ancestor requests, the owners' rows back, K16, the changed flag
   summed over the ranks), and the chain finish through three more
   exchanges;
4. rank 0 gathers the glue outputs and the re-sharded solid table and
   spells the unitigs on its device (K11) and links them (link_join).

Every exchange has a fixed capacity; an overflow is counted over the
ranks and the capacities grow, as in the JAX package.  The capacities are
the JAX package's (powers of two >= 16), because the unitig numbering
depends on them.  The host-driven compaction of the JAX module
(distributed_compact_pos, distributed_compact) is not carried.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels
from bcalm_tpu_torch.ops import chains as chains_op
from bcalm_tpu_torch.ops import junctions as junc
from bcalm_tpu_torch.ops import runchains
from bcalm_tpu_torch.ops import sort as sort_op
from bcalm_tpu_torch.ops.runchains import round_capacity
from bcalm_tpu_torch.parallel.pipeline import empty_unitigs, route_to_buckets

SENTINEL = ln.SENTINEL


def reshard_pos(mesh, stk: torch.Tensor, k: int, slot_cap: int,
                route_cap: int, Q: int = 64):
    """Global sort by first-occurrence key and re-shard (bcalm_tpu
    reshard_pos_fn).  stk: this rank's (L+2, cap) solid run.  Returns
    (lanes (L, slot_cap) as-read, counts (slot_cap,), n_here, bad): bad is
    the route drops plus the slot overflow, summed over the ranks."""
    L = stk.shape[0] - 2
    n_dev = mesh.n_dev
    perm = sort_op.lex_argsort([stk[L + 1]])
    stk_s = stk[:, perm]
    pos_s = stk_s[L + 1]
    valid = pos_s != SENTINEL
    n_sol = int(valid.sum())
    qi = torch.clamp(((torch.arange(Q, device=stk.device) + 1) * n_sol)
                     // (Q + 1), 0, stk.shape[1] - 1)
    qs = pos_s[qi] if n_sol > 0 else torch.full((Q,), SENTINEL,
                                                dtype=torch.int64,
                                                device=stk.device)
    allq = torch.sort(mesh.all_gather(qs).reshape(-1)).values
    owner = torch.zeros_like(pos_s)
    for j in range(n_dev - 1):
        owner += (pos_s >= allq[(j + 1) * Q]).to(torch.int64)
    buckets, bvalid, dropped = route_to_buckets(stk_s, valid, owner, n_dev,
                                                route_cap)
    recv, rvalid = mesh.exchange(buckets, bvalid)
    rvalid = rvalid.reshape(-1)
    ent = torch.where(rvalid[None], recv.reshape(L + 2, -1), SENTINEL)
    ent = ent[:, sort_op.lex_argsort([ent[L + 1]])]
    n_recv = int(rvalid.sum())
    pos2 = ent[L + 1, :slot_cap]
    in_slot = pos2 != SENTINEL
    lanes2 = ent[:L, :slot_cap]
    flip = ((pos2 & 1) == 1) & in_slot
    lanes2 = torch.where(flip[None], ln.revcomp(lanes2, k), lanes2)
    counts2 = torch.where(in_slot, ent[L, :slot_cap], 0)
    bad = mesh.psum(dropped + max(0, n_recv - slot_cap))
    return (lanes2.contiguous(), counts2.contiguous(), min(n_recv, slot_cap),
            int(bad[0]))


def local_succ_shard(mesh, solid: torch.Tensor, n_local: int, k: int,
                     cap_entries: int, slot_cap: int):
    """This rank's successor shard (2*slot_cap,) of global oriented ids
    (-1 = none) and the route drops summed over the ranks (bcalm_tpu
    _local_succ_shard; the predecessor shard it also builds is unused
    there and not built here)."""
    n_dev, me = mesh.n_dev, mesh.rank
    N = solid.shape[1]
    tot = n_dev * slot_cap
    keys, payload, owner = junc.junction_entries(solid, n_local, k,
                                                 me * slot_cap, tot, n_dev)
    valid = (torch.arange(4 * N, device=solid.device) % N) < n_local
    K = keys.shape[0]
    bl, bv, drop1 = route_to_buckets(torch.cat([keys, payload[None]]), valid,
                                     owner, n_dev, cap_entries)
    recv, rv = mesh.exchange(bl, bv)
    ent = recv.reshape(K + 1, -1)
    ev = rv.reshape(-1)
    e_keys = torch.where(ev[None], ent[:K], SENTINEL)
    e_pay = torch.where(ev, ent[K], 0)
    perm = sort_op.lex_argsort([e_keys[j] for j in range(K)])
    ok, src, dst = junc.junction_edges(e_keys[:, perm].contiguous(),
                                       e_pay[perm], tot)
    a_slot = torch.where(src >= tot, src - tot, src)
    bl, bv, drop2 = route_to_buckets(torch.stack([src, dst]), ok,
                                     a_slot // slot_cap, n_dev, cap_entries)
    recv, rv = mesh.exchange(bl, bv)
    edges = recv.reshape(2, -1)
    ev = rv.reshape(-1)
    ea, eb = edges[0][ev], edges[1][ev]
    eslot = torch.where(ea >= tot, ea - tot, ea) - me * slot_cap
    lidx = torch.where(ea >= tot, eslot + slot_cap, eslot)
    succ = torch.full((2 * slot_cap,), -1, dtype=torch.int64,
                      device=solid.device)
    succ[lidx] = eb
    return succ, int(mesh.psum(drop1 + drop2)[0])


def _respond(mesh, ans_rows: torch.Tensor, qcap: int) -> torch.Tensor:
    """Answers computed in the received-bucket layout back to their
    senders, at the flat slot each query was routed from: (C, n_dev*qcap)."""
    C = ans_rows.shape[0]
    return mesh.all_to_all(ans_rows.reshape(C, mesh.n_dev, qcap)).reshape(C, -1)


def glue_compose_plain(Q: torch.Tensor, anc: torch.Tensor,
                       need: torch.Tensor):
    """Plain PyTorch version of K16: (Qn, changed (1,) int32)."""
    new = chains_op.compose_plain(Q, anc)
    Qn = torch.where(need[:, None], new, Q)
    return Qn, (Qn != Q).any().to(torch.int32).reshape(1)


def glue_compose(Q: torch.Tensor, anc: torch.Tensor, need: torch.Tensor):
    """K16 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if Q.device.type == "cpu":
        return glue_compose_plain(Q, anc, need)
    return _kernels.glue_compose(Q, anc, need)


def _lookup(mesh, q: torch.Tensor, ok: torch.Tensor, owner: torch.Tensor,
            qcap: int, answer):
    """Request/response round: each valid query value goes to its owner
    (K15 + exchange), answer(received values, received validity) gives
    (C, n_dev*qcap) rows there, and the rows come back to the querying
    entries.  Returns ((C, n) rows per query entry, drops)."""
    bl, bv, drop, slots = route_to_buckets(q.contiguous()[None], ok, owner,
                                           mesh.n_dev, qcap, with_slots=True)
    recv, rv = mesh.exchange(bl, bv)
    back = _respond(mesh, answer(recv.reshape(-1), rv.reshape(-1)), qcap)
    return back[:, torch.clamp(slots, 0, mesh.n_dev * qcap - 1)], drop


def glue_shard(mesh, succ_l: torch.Tensor, n_loc: int, slot_cap: int,
               run_cap: int, qcap: int):
    """This rank's glue (bcalm_tpu _glue_shard).  Returns None when a rank
    has more runs than run_cap (the caller grows run_cap), else (outputs
    of the JAX version's 10 sharded arrays, as a tuple of this rank's
    tensors, n_unitigs, dropped)."""
    n_dev, me = mesh.n_dev, mesh.rank
    dev = succ_l.device
    tot = n_dev * slot_cap
    C_tot = n_dev * run_cap
    two_rc = 2 * run_cap
    i64 = dict(dtype=torch.int64, device=dev)

    # consecutive runs (K8 with this rank's global slot base)
    is_head, _, rid_loc, head_pos_v, end_pos_v, R = runchains.run_scans(
        succ_l, n_loc, slot_cap, me * slot_cap)
    n_runs = int(R[0])
    if mesh.sum_int(n_runs > run_cap):
        return None
    hpos = torch.full((run_cap,), max(0, slot_cap - 1), **i64)
    hpos[:n_runs] = torch.nonzero(is_head).flatten()
    rvalid = torch.arange(run_cap, device=dev) < n_runs
    epos = end_pos_v[hpos]
    rlen = torch.where(rvalid, epos - hpos + 1, 0)

    def gq_owner(g):
        return torch.where(g >= C_tot, g - C_tot, g) // run_cap

    def gq_local(g):
        s = torch.where(g >= C_tot, g - C_tot, g)
        return s % run_cap + torch.where(g >= C_tot, run_cap, 0)

    def mirror_g(g):
        return torch.where(g >= C_tot, g - C_tot, g + C_tot)

    # contracted successors: run id and weight of w at its owner
    w = torch.cat([succ_l[epos], succ_l[slot_cap + hpos]])
    rvalid2 = torch.cat([rvalid, rvalid])
    q_ok = rvalid2 & (w >= 0)
    wv = torch.where(w >= tot, w - tot, w)

    def run_of(vals, ok):
        lv = torch.clamp(vals - me * slot_cap, 0, slot_cap - 1)
        return torch.stack([
            torch.where(ok, me * run_cap + rid_loc[lv], -1),
            torch.where(ok, end_pos_v[lv] - head_pos_v[lv] + 1, 0)])

    back, drop1 = _lookup(mesh, wv, q_ok, torch.where(q_ok, wv // slot_cap,
                                                      n_dev), qcap, run_of)
    a_rid = torch.where(q_ok, back[0], -1)
    wsucc = torch.where(q_ok, back[1], 0)
    csucc = torch.where(a_rid >= 0, torch.where(w >= tot, a_rid + C_tot, a_rid),
                        -1)
    cvalid = rvalid2
    wlen2 = torch.cat([rlen, rlen])

    # pred and its edge weight by mirror symmetry (local)
    succ_m = torch.roll(csucc, run_cap)
    w_m = torch.roll(wsucc, run_cap)
    pred = torch.where(succ_m >= 0, mirror_g(succ_m), -1)

    # sharded weighted doubling over the contracted graph
    ar = torch.arange(run_cap, device=dev)
    gidx2 = torch.cat([me * run_cap + ar, C_tot + me * run_cap + ar])
    has_pred = (pred >= 0) & cvalid
    Q = torch.stack([
        torch.where(has_pred, pred, gidx2),
        torch.where(has_pred, w_m, chains_op._F_ROOTED | chains_op._F_SETTLED),
        torch.where(cvalid, gidx2, 2 * C_tot),
        torch.zeros_like(gidx2)], dim=1).contiguous()
    R_rounds = chains_op.max_rounds(2 * C_tot)
    loop_drops = 0
    rounds = 0
    changed = True
    while changed and rounds < R_rounds:
        need = cvalid & ((Q[:, chains_op._DSF] & chains_op._F_ROOTED) == 0)
        qg = Q[:, chains_op._PTR]

        def rows_of(vals, ok, Q=Q):
            return Q[torch.clamp(gq_local(vals), 0, two_rc - 1)].t()

        anc, dr = _lookup(mesh, qg, need, torch.where(need, gq_owner(qg), n_dev),
                          qcap, rows_of)
        Q, ch = glue_compose(Q, anc.t().contiguous(), need)
        sums = mesh.psum(torch.cat([ch.to(torch.int64), dr]))
        changed = int(sums[0]) > 0
        loop_drops += int(sums[1])
        rounds += 1

    # finish: chain starts, ends and unitig ids through three exchanges
    rooted = (Q[:, chains_op._DSF] & chains_op._F_ROOTED) != 0
    dist = Q[:, chains_op._DSF] & chains_op._DMASK
    mn = Q[:, chains_op._MN]
    dmn = Q[:, chains_op._DMN]
    ptr = Q[:, chains_op._PTR]
    in_cycle = cvalid & ~rooted
    break_node = in_cycle & (mn == gidx2)
    start_g = torch.where(in_cycle, mn, ptr)
    rank = torch.where(in_cycle, dmn, dist)
    is_start = cvalid & (~has_pred | break_node)
    is_end = cvalid & ((csucc < 0) | (in_cycle & (csucc == mn)))

    ebl, ebv, drop2 = route_to_buckets(
        torch.stack([start_g, gidx2, rank + wlen2]), is_end,
        torch.where(is_end, gq_owner(start_g), n_dev), n_dev, qcap)
    erl, erv = mesh.exchange(ebl, ebv)
    ent = erl.reshape(3, -1)
    ev = erv.reshape(-1)
    erow = torch.clamp(gq_local(ent[0]), 0, two_rc - 1)[ev]
    end_of = torch.full((two_rc,), -1, **i64)
    end_of[erow] = ent[1][ev]
    len_at = torch.zeros((two_rc,), **i64)
    len_at[erow] = ent[2][ev]

    mirror_start = torch.where(break_node, torch.roll(mn, run_cap),
                               mirror_g(torch.where(end_of >= 0, end_of, gidx2)))
    keep = is_start & (end_of >= 0) & (gidx2 < mirror_start)
    local_kept = int(keep.sum())
    kept_all = mesh.gather_ints([local_kept])[:, 0]
    dev_off = int(kept_all[:me].sum())
    uid_at = torch.where(keep, dev_off + torch.cumsum(keep.to(torch.int64), 0)
                         - 1, -1)
    n_unitigs = int(kept_all.sum())

    def uid_of(vals, ok):
        return torch.where(ok, uid_at[torch.clamp(gq_local(vals), 0,
                                                  two_rc - 1)], -1)[None]

    uback, drop3 = _lookup(mesh, start_g, cvalid,
                           torch.where(cvalid, gq_owner(start_g), n_dev), qcap,
                           uid_of)
    uid2 = torch.where(cvalid, uback[0], -1)
    dropped = int(mesh.psum(drop1 + drop2 + drop3)[0]) + loop_drops
    outs = (torch.tensor([n_runs], **i64), hpos, epos, rlen, uid2,
            torch.where(uid2 >= 0, rank, 0), keep, uid_at, len_at, break_node)
    return outs, n_unitigs, dropped, rounds


def distributed_compact_dev(mesh, stacked: torch.Tensor, n_np: np.ndarray,
                            k: int, timing: Optional[dict] = None,
                            probe: Optional[dict] = None):
    """Sharded compaction of the ranks' solid runs (bcalm_tpu
    distributed_compact_dev).  stacked: this rank's (L+2, cap) solid run
    (lanes, counts, first-occurrence keys, folded past its solid k-mers);
    n_np: every rank's solid count.  Returns the UnitigSet on rank 0, None
    on the other ranks.  probe: rank 0 records the gathered glue outputs
    (the JAX version's ten sharded arrays, flat), n_unitigs, slot_cap and
    run_cap."""
    import time

    timing = {} if timing is None else timing
    n_dev = mesh.n_dev
    L = stacked.shape[0] - 2
    N = int(np.asarray(n_np).sum())
    if N == 0:
        return (empty_unitigs(k, {"devices": n_dev, "solid_kmers": 0})
                if mesh.rank == 0 else None)
    t0 = time.time()
    slot_cap = round_capacity(max(16, int(np.ceil(1.3 * N / n_dev))))
    route_cap = max(64, -(-int(1.5 * slot_cap) // n_dev))
    while True:
        solid_sh, counts_sh, n_here, bad = reshard_pos(mesh, stacked, k,
                                                       slot_cap, route_cap)
        if bad == 0:
            break
        route_cap *= 2
        if route_cap > 4 * slot_cap:
            slot_cap *= 2
            route_cap = max(64, -(-int(1.5 * slot_cap) // n_dev))
        if slot_cap > (1 << 28):
            raise RuntimeError("reshard overflow persists")
    timing["reshard"] = time.time() - t0
    t0 = time.time()
    succ_sh, dropped = local_succ_shard(mesh, solid_sh, n_here, k,
                                        4 * slot_cap, slot_cap)
    if dropped:
        raise RuntimeError(f"junction exchange overflow: {dropped} entries")
    timing["junctions"] = time.time() - t0
    t0 = time.time()
    run_cap = max(16, slot_cap // 4)
    qcap = max(64, (4 * 2 * run_cap) // n_dev)
    while True:
        got = glue_shard(mesh, succ_sh, n_here, slot_cap, run_cap, qcap)
        if got is None:
            run_cap = min(slot_cap, run_cap * 4)
            qcap = max(qcap, (4 * 2 * run_cap) // n_dev)
            continue
        outs, n_unitigs, g_dropped, rounds = got
        if g_dropped > 0:
            qcap *= 2
            if qcap > 2 * run_cap * n_dev:
                raise RuntimeError(
                    f"glue exchange overflow persists at qcap {qcap}")
            continue
        break
    timing["glue"] = time.time() - t0
    t0 = time.time()
    # rank 0 gathers the glue outputs and the re-sharded solid table
    outs_all = [mesh.all_gather(o) for o in outs]
    solid_all = mesh.all_gather(solid_sh)
    counts_all = mesh.all_gather(counts_sh)
    n_local = mesh.gather_ints([n_here])[:, 0]
    if mesh.rank != 0:
        return None
    outs_np = tuple(o.cpu().numpy().reshape(-1) for o in outs_all)
    if probe is not None:
        probe.update(glue=outs_np, n_unitigs=n_unitigs, slot_cap=slot_cap,
                     run_cap=run_cap)
    solid_global = torch.cat(list(solid_all), dim=1).contiguous()
    counts_global = counts_all.reshape(-1).contiguous()
    us = assemble_from_glue(outs_np, n_unitigs, solid_global, counts_global,
                            n_local, slot_cap, run_cap, n_dev, k)
    us.stats["glue_doubling_rounds"] = rounds
    timing["assembly"] = time.time() - t0
    return us


def assemble_from_glue(outs_np, n_unitigs: int, solid_global: torch.Tensor,
                       counts_global: torch.Tensor, n_local, slot_cap: int,
                       run_cap: int, n_dev: int, k: int):
    """Unitigs from the gathered glue outputs (bcalm_tpu
    assemble_from_glue): per-run labels broadcast over the run members on
    the host (numpy), then spelling on the device of the solid table (K11)
    and the links (link_join)."""
    from bcalm_tpu_torch import engine

    (n_runs_sh, hpos_sh, epos_sh, rlen_sh, uid2_sh, rank2_sh, keep_sh,
     uid_at_sh, len_at_sh, circ_sh) = outs_np
    tot = n_dev * slot_cap
    n_runs = n_runs_sh.reshape(n_dev)
    hpos = hpos_sh.reshape(n_dev, run_cap)
    epos = epos_sh.reshape(n_dev, run_cap)
    rlen = rlen_sh.reshape(n_dev, run_cap)
    uid2 = uid2_sh.reshape(n_dev, 2 * run_cap)
    rank2 = rank2_sh.reshape(n_dev, 2 * run_cap)
    keep = keep_sh.reshape(n_dev, 2 * run_cap)
    uid_at = uid_at_sh.reshape(n_dev, 2 * run_cap)
    len_at = len_at_sh.reshape(n_dev, 2 * run_cap)
    circ_at = circ_sh.reshape(n_dev, 2 * run_cap)
    R_total = int(n_runs.sum())

    rmask = np.arange(run_cap)[None, :] < n_runs[:, None]
    heads_g = (np.arange(n_dev)[:, None] * slot_cap + hpos)[rmask]
    tails_g = (np.arange(n_dev)[:, None] * slot_cap + epos)[rmask]
    rlen_g = rlen[rmask]
    uid_p = uid2[:, :run_cap][rmask]
    uid_m = uid2[:, run_cap:][rmask]
    rank_p = rank2[:, :run_cap][rmask]
    rank_m = rank2[:, run_cap:][rmask]

    uid = np.full((2 * tot,), -1, np.int64)
    rank = np.zeros((2 * tot,), np.int64)
    members = np.repeat(heads_g, rlen_g) + (
        np.arange(rlen_g.sum()) -
        np.repeat(np.concatenate([[0], np.cumsum(rlen_g)[:-1]]), rlen_g))
    uid[members] = np.repeat(uid_p, rlen_g)
    rank[members] = np.repeat(rank_p, rlen_g) + (
        members - np.repeat(heads_g, rlen_g))
    uid[tot + members] = np.repeat(uid_m, rlen_g)
    rank[tot + members] = np.repeat(rank_m, rlen_g) + (
        np.repeat(tails_g, rlen_g) - members)
    rank = np.where(uid >= 0, rank, 0)

    dev_of = np.repeat(np.arange(n_dev)[:, None], 2 * run_cap, axis=1)
    row_of = np.repeat(np.arange(2 * run_cap)[None, :], n_dev, axis=0)
    kmask = keep.astype(bool)
    kd = dev_of[kmask]
    kr = row_of[kmask]
    is_minus = kr >= run_cap
    ri = np.where(is_minus, kr - run_cap, kr)
    start_oid = np.where(is_minus, tot + kd * slot_cap + epos[kd, ri],
                         kd * slot_cap + hpos[kd, ri]).astype(np.int64)
    length = len_at[kmask].astype(np.int64)
    circular = circ_at[kmask].astype(bool)
    assert np.array_equal(uid_at[kmask], np.arange(n_unitigs))

    dev = solid_global.device
    info = {"uid": torch.from_numpy(uid).to(dev),
            "rank": torch.from_numpy(rank).to(dev),
            "n_unitigs": n_unitigs,
            "start_oid": torch.from_numpy(start_oid).to(dev),
            "length": torch.from_numpy(length).to(dev),
            "circular": torch.from_numpy(circular).to(dev)}
    n_solid = int(np.asarray(n_local).sum())
    seqs, kc, abund, circular_u = engine.assemble_unitigs_device(
        solid_global, counts_global, info, k, n_unitigs, n_solid)
    links = engine.link_join(seqs, k)
    return engine.UnitigSet(
        k=k, seqs=seqs, kc=kc, abundances=abund, circular=circular_u,
        links=links, stats={
            "devices": n_dev,
            "solid_kmers": n_solid,
            "glue_runs": R_total,
            "glue_contraction": float(n_solid) / max(1, R_total),
        })
