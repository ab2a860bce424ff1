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
   hash_lanes(key) % n_dev (K15 + exchange); the valid received entries
   are compacted into their packed sort words and payloads (K3, global
   mode) and only those are sorted there (torch.sort), the pair rule (K3b,
   global mode) reads the sort's output and finds the unitig edges, which
   go back to the rank owning their source slot (K15 + exchange) and are
   scattered into its successor shard, a window of the table at a time
   (K3, global mode);
3. glue_shard: consecutive runs of the shard (K8 with a global slot
   base), the contracted run graph through request/response lookups at
   the owners (each owner's answer K21, written in the response's
   layout), the sharded weighted doubling (glue_round: K15 + exchange
   of the ancestor requests, the owners' rows back, K16 in place over the
   state, reading the response where it lands and writing the next
   round's routing; then the changed flag summed over the ranks), and the
   chain finish through three more exchanges;
4. rank 0 gathers the glue outputs and the re-sharded solid table and
   spells the unitigs on its device (K11) and links them there
   (engine.unitig_links: K22, K23).

Every exchange has a fixed capacity; an overflow is counted over the
ranks and the capacities grow, as in the JAX package.  The capacities are
the JAX package's (powers of two >= 16), because the unitig numbering
depends on them.

The host-driven compaction of the JAX module is carried too:
distributed_compact_pos takes every device's (solid, counts,
first-occurrence keys) on the host, as its JAX signature does; every rank
sorts their concatenation by key, flips each k-mer to its as-read strand
and takes its own position-contiguous shard at JAX's capacity
(round_capacity(ceil(N / n_dev)) slots, not the 1.3x rule of step 1),
then runs steps 2-4.  distributed_compact gives it all-zero keys: one run
per k-mer, the stress case of the sharded jump.
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
    send, dropped = route_to_buckets(stk_s, valid, owner, n_dev, route_cap,
                                     fill=SENTINEL)
    recv, rvalid = mesh.exchange(send)
    del send
    ent = recv.reshape(L + 2, -1)
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


def _scatter_edges(mesh, edges: torch.Tensor, ok: torch.Tensor,
                   owner: torch.Tensor, slot_cap: int, cap_entries: int):
    """The (a -> b) edges (2, E) where ok, routed to owner (the rank owning
    a's slot) and scattered into its local table (2*slot_cap,) by a's
    local oriented id (-1 = none).  Returns (table, drops)."""
    send, drop = route_to_buckets(edges, ok, owner, mesh.n_dev, cap_entries)
    recv, rv = mesh.exchange(send)
    table = junc.junction_scatter(recv.reshape(2, -1), rv.reshape(-1),
                                  mesh.n_dev * slot_cap, mesh.rank * slot_cap,
                                  slot_cap)
    return table, drop


def _host_count(n_t: torch.Tensor) -> int:
    """The valid received count on the host: the step's one sync
    (torch.sort needs the length)."""
    return int(n_t[0])


def _pair_edges(words: torch.Tensor, payload: torch.Tensor, K: int,
                tot: int, slot_cap: int):
    """The sort of the n valid received entries and the pair rule on its
    output: (ok (n,), edges (2, n), src's owner (n,)); at n = 0 nothing
    is launched."""
    n = payload.shape[0]
    if n == 0:
        dev = payload.device
        return (torch.zeros((0,), dtype=torch.bool, device=dev),
                torch.zeros((2, 0), dtype=torch.int64, device=dev),
                torch.zeros((0,), dtype=torch.int64, device=dev))
    perm, top = sort_op.lex_sort_words(words)
    return junc.junction_edges(top, perm, words, payload, K, tot, slot_cap)


def local_succ_shard(mesh, solid: torch.Tensor, n_local: int, k: int,
                     cap_entries: int, slot_cap: int, with_pred: bool = False):
    """This rank's successor shard (2*slot_cap,) of global oriented ids
    (-1 = none) and the route drops summed over the ranks (bcalm_tpu
    _local_succ_shard).  The valid received entries are compacted, in
    receive order, into their packed sort words and payloads, and only
    those n are sorted (one host read of n a step: torch.sort needs the
    length); the pair rule reads the sort's own output, so no sorted copy
    of the keys or the payload is made.  JAX sorts every received slot,
    the empty ones as the sentinel, which no valid key equals: they sort
    last and it finds no edge among them.  with_pred: also the
    predecessor shard, the same edges routed to their dst owners, which
    JAX builds and the glue does not use: (succ, pred, drops)."""
    n_dev, me = mesh.n_dev, mesh.rank
    tot = n_dev * slot_cap
    ent, valid, owner = junc.junction_entries(solid, n_local, k,
                                              me * slot_cap, tot, n_dev)
    K = ent.shape[0] - 1
    send, drop1 = route_to_buckets(ent, valid, owner, n_dev, cap_entries)
    del ent, valid, owner
    recv, rv = mesh.exchange(send)
    del send
    words, payload, n_t = junc.junction_words(recv.reshape(K + 1, -1),
                                              rv.reshape(-1))
    del recv, rv
    n = _host_count(n_t)
    ok, edges, src_owner = _pair_edges(words[:, :n], payload[:n], K, tot,
                                       slot_cap)
    del words, payload
    succ, drop2 = _scatter_edges(mesh, edges, ok, src_owner, slot_cap,
                                 cap_entries)
    if not with_pred:
        return succ, int(mesh.psum(drop1 + drop2)[0])
    dst = edges[1]
    dst_owner = torch.where(dst >= tot, dst - tot, dst) // slot_cap
    pred, drop3 = _scatter_edges(mesh, torch.stack([dst, edges[0]]), ok,
                                 dst_owner, slot_cap, cap_entries)
    return succ, pred, int(mesh.psum(drop1 + drop2 + drop3)[0])


def distributed_succ(mesh, solid: torch.Tensor, n_local: int, k: int,
                     cap_entries: int, slot_cap: int):
    """This rank's successor and predecessor shards and the drops summed
    over the ranks (bcalm_tpu distributed_succ, :170): (succ, pred,
    dropped)."""
    return local_succ_shard(mesh, solid, n_local, k, cap_entries, slot_cap,
                            with_pred=True)


def _respond(mesh, ans_rows: torch.Tensor, qcap: int) -> torch.Tensor:
    """Answers computed in the received-bucket layout back to their
    senders, at the flat slot each query was routed from: (C, n_dev*qcap)."""
    C = ans_rows.shape[0]
    return mesh.all_to_all(ans_rows.reshape(C, mesh.n_dev, qcap)).reshape(C, -1)


def _gq_owner(g: torch.Tensor, run_cap: int, c_tot: int) -> torch.Tensor:
    """The rank owning contracted run node g (c_tot runs a strand, run_cap
    a rank)."""
    return torch.where(g >= c_tot, g - c_tot, g) // run_cap


def _gq_local(g: torch.Tensor, run_cap: int, c_tot: int) -> torch.Tensor:
    """Node g's row at its owner: the plus strand's run_cap rows, then the
    minus strand's."""
    s = torch.where(g >= c_tot, g - c_tot, g)
    return s % run_cap + torch.where(g >= c_tot, run_cap, 0)


def glue_compose_plain(Q: torch.Tensor, back: torch.Tensor,
                       slots: torch.Tensor, need: torch.Tensor,
                       changed: torch.Tensor, route: torch.Tensor,
                       run_cap: int, n_dev: int) -> None:
    """Plain PyTorch version of K16, in place (the contract of
    _kernels.glue_compose): where need, Q's row composed with
    back[:, slots] (JAX's clipped take), changed set when a row moved, and
    the next round's need and route (ptr, owner; n_dev where no step is
    needed); the other rows and their need and route stay as they are."""
    anc = back[:, torch.clamp(slots, 0, back.shape[1] - 1)].t()
    new = torch.where(need[:, None], chains_op.compose_plain(Q, anc), Q)
    if not torch.equal(new, Q):
        changed.fill_(1)
    Q.copy_(new)
    ptr = Q[:, chains_op._PTR]
    nxt = need & ((Q[:, chains_op._DSF] & chains_op._F_ROOTED) == 0)
    owner = torch.where(nxt, _gq_owner(ptr, run_cap, n_dev * run_cap), n_dev)
    route[0] = torch.where(need, ptr, route[0])
    route[1] = torch.where(need, owner, route[1])
    need.copy_(nxt)


def glue_compose(Q: torch.Tensor, back: torch.Tensor, slots: torch.Tensor,
                 need: torch.Tensor, changed: torch.Tensor, route: torch.Tensor,
                 run_cap: int, n_dev: int) -> None:
    """K16 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if Q.device.type == "cpu":
        glue_compose_plain(Q, back, slots, need, changed, route, run_cap, n_dev)
    else:
        _kernels.glue_compose(Q, back, slots, need, changed, route, run_cap,
                              n_dev)


def glue_answer_plain(mode: str, vals: torch.Tensor, valid: torch.Tensor,
                      tables, run_cap: int, n_dev: int,
                      me: int) -> torch.Tensor:
    """Plain PyTorch version of K21: the owner's answer to the received
    query values (S,) and their validity (S,), channel-major (C, S) (the
    layout _respond sends), at every slot.  mode "rows": tables (Q,), Q's
    row clip(gq_local(v), 0, 2*run_cap-1) at every slot, the empty ones
    included (JAX's take); "run": tables (rid_loc, head_pos_v, end_pos_v)
    of this rank's slot_cap slots, (me*run_cap + rid_loc[lv], end_pos_v[lv]
    - head_pos_v[lv] + 1) where valid and (-1, 0) elsewhere, lv =
    clip(v - me*slot_cap, 0, slot_cap-1); "uid": tables (uid_at,),
    uid_at[clip(gq_local(v), 0, 2*run_cap-1)] where valid, -1 elsewhere."""
    c_tot = n_dev * run_cap
    if mode == "rows":
        (Q,) = tables
        local = torch.clamp(_gq_local(vals, run_cap, c_tot), 0, 2 * run_cap - 1)
        return Q[local].t().contiguous()
    if mode == "uid":
        (uid_at,) = tables
        local = torch.clamp(_gq_local(vals, run_cap, c_tot), 0, 2 * run_cap - 1)
        return torch.where(valid, uid_at[local], -1)[None]
    if mode != "run":
        raise ValueError(f"glue_answer: unknown mode {mode!r}")
    rid_loc, head_pos_v, end_pos_v = tables
    slot_cap = rid_loc.shape[0]
    lv = torch.clamp(vals - me * slot_cap, 0, slot_cap - 1)
    return torch.stack([
        torch.where(valid, me * run_cap + rid_loc[lv], -1),
        torch.where(valid, end_pos_v[lv] - head_pos_v[lv] + 1, 0)])


def glue_answer(mode: str, vals: torch.Tensor, valid: torch.Tensor, tables,
                run_cap: int, n_dev: int, me: int) -> torch.Tensor:
    """K21 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if vals.device.type == "cpu":
        return glue_answer_plain(mode, vals, valid, tables, run_cap, n_dev, me)
    return _kernels.glue_answer(mode, vals, valid, tables, run_cap, n_dev, me)


def _request(mesh, q: torch.Tensor, ok: torch.Tensor, owner: torch.Tensor,
             qcap: int, mode: str, tables, run_cap: int):
    """Request/response round: each valid query value of q (1, n) goes to
    its owner (K15 + exchange), which answers it there (glue_answer in
    `mode` over its `tables`: (C, n_dev*qcap) rows), and the answers come
    back in the layout of the routed queries.  Returns (back (C,
    n_dev*qcap), slots (n,): each query's column of back (n_dev*qcap where
    it was dropped or not valid), drops)."""
    send, drop, slots = route_to_buckets(q, ok, owner, mesh.n_dev, qcap,
                                         with_slots=True)
    recv, rv = mesh.exchange(send)
    ans = glue_answer(mode, recv.reshape(-1), rv.reshape(-1), tables, run_cap,
                      mesh.n_dev, mesh.rank)
    return _respond(mesh, ans, qcap), slots, drop


def _lookup(mesh, q: torch.Tensor, ok: torch.Tensor, owner: torch.Tensor,
            qcap: int, mode: str, tables, run_cap: int):
    """_request for a query vector q (n,), its rows gathered per query
    entry: ((C, n) rows, drops)."""
    back, slots, drop = _request(mesh, q.contiguous()[None], ok, owner, qcap,
                                 mode, tables, run_cap)
    return back[:, torch.clamp(slots, 0, mesh.n_dev * qcap - 1)], drop


def glue_round(mesh, Q: torch.Tensor, need: torch.Tensor, route: torch.Tensor,
               changed: torch.Tensor, qcap: int, run_cap: int) -> torch.Tensor:
    """One round of the sharded weighted doubling (the loop body of
    bcalm_tpu _glue_shard), in place: each row that needs a step (need)
    sends its ptr to the owner (route: (2, M), the ptr column and each
    row's owner, n_dev where no step is needed), the owners answer with
    their rows of Q as they are before this round's compose, and K16
    composes the row with its answer where the exchange left it, sets
    changed[0] when a row moved and writes the next round's need and
    route.  Returns this rank's dropped queries (1,)."""
    back, slots, drop = _request(mesh, route[:1], need, route[1], qcap,
                                 "rows", (Q,), run_cap)
    glue_compose(Q, back, slots, need, changed, route, run_cap, mesh.n_dev)
    return drop


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

    def mirror_g(g):
        return torch.where(g >= C_tot, g - C_tot, g + C_tot)

    # contracted successors: run id and weight of w at its owner
    w = torch.cat([succ_l[epos], succ_l[slot_cap + hpos]])
    rvalid2 = torch.cat([rvalid, rvalid])
    q_ok = rvalid2 & (w >= 0)
    wv = torch.where(w >= tot, w - tot, w)
    back, drop1 = _lookup(mesh, wv, q_ok, torch.where(q_ok, wv // slot_cap,
                                                      n_dev), qcap, "run",
                          (rid_loc, head_pos_v, end_pos_v), run_cap)
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
    ptr = Q[:, chains_op._PTR]
    need = cvalid & ((Q[:, chains_op._DSF] & chains_op._F_ROOTED) == 0)
    route = torch.stack([ptr, torch.where(need, _gq_owner(ptr, run_cap, C_tot),
                                          n_dev)])
    flags = torch.zeros((R_rounds,), dtype=torch.int32, device=dev)
    loop_drops = 0
    rounds = 0
    changed = True
    while changed and rounds < R_rounds:
        flag = flags[rounds:rounds + 1]
        dr = glue_round(mesh, Q, need, route, flag, qcap, run_cap)
        moved, drops = mesh.psum(torch.cat([flag.to(torch.int64), dr])).tolist()
        changed = moved > 0
        loop_drops += drops
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

    esend, drop2 = route_to_buckets(
        torch.stack([start_g, gidx2, rank + wlen2]), is_end,
        torch.where(is_end, _gq_owner(start_g, run_cap, C_tot), n_dev), n_dev,
        qcap)
    erl, erv = mesh.exchange(esend)
    ent = erl.reshape(3, -1)
    ev = erv.reshape(-1)
    erow = torch.clamp(_gq_local(ent[0], run_cap, C_tot), 0, two_rc - 1)[ev]
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
    uback, drop3 = _lookup(mesh, start_g, cvalid,
                           torch.where(cvalid, _gq_owner(start_g, run_cap, C_tot),
                                       n_dev), qcap, "uid", (uid_at,), run_cap)
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
    return _glue_and_assemble(mesh, solid_sh, counts_sh, n_here, slot_cap, k,
                              timing, probe)


def _glue_and_assemble(mesh, solid_sh: torch.Tensor, counts_sh: torch.Tensor,
                       n_here: int, slot_cap: int, k: int, timing: dict,
                       probe: Optional[dict] = None):
    """Steps 2-4 on this rank's shard (L, slot_cap) of n_here k-mers in
    stream order: junctions, glue with JAX's run_cap/qcap escalation, the
    gather to rank 0 and its assembly.  Returns the UnitigSet on rank 0,
    None on the other ranks."""
    import time

    n_dev = mesh.n_dev
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


def distributed_compact_pos(mesh, solid_per_dev, counts_per_dev, pos_per_dev,
                            k: int, timing: Optional[dict] = None,
                            probe: Optional[dict] = None):
    """Position-ordered compaction of every device's solid k-mers
    (bcalm_tpu distributed_compact_pos); every rank calls it with the same
    per-device host lists ((L, n_d) u32 lanes, (n_d,) counts, (n_d,) u32
    first-occurrence keys).  On the host: the stable sort by key, the
    strand flip, the re-shard into slot_cap = round_capacity(ceil(N /
    n_dev)) position-contiguous slots per rank (JAX's capacities, on which
    the unitig numbering depends); then this rank's junctions, glue and the
    assembly on rank 0.  Returns the UnitigSet on rank 0, None on the
    other ranks."""
    timing = {} if timing is None else timing
    n_dev = mesh.n_dev
    L = np.asarray(solid_per_dev[0]).shape[0]
    lanes = np.concatenate([np.asarray(a) for a in solid_per_dev], axis=1)
    counts = np.concatenate([np.asarray(c) for c in counts_per_dev])
    pos = np.concatenate([np.asarray(p) for p in pos_per_dev])
    N = lanes.shape[1]
    if N == 0:
        return (empty_unitigs(k, {"devices": n_dev, "solid_kmers": 0})
                if mesh.rank == 0 else None)
    order = np.argsort(pos, kind="stable")
    lanes_t = torch.from_numpy(lanes[:, order].astype(np.int64))
    strand = torch.from_numpy((pos[order] & 1).astype(bool))
    lanes_t = torch.where(strand[None], ln.revcomp(lanes_t, k), lanes_t)
    counts_t = torch.from_numpy(counts[order].astype(np.int64))
    slot_cap = round_capacity(max(1, -(-N // n_dev)))
    off = min(N, mesh.rank * slot_cap)
    n_here = min(slot_cap, N - off)
    solid_sh = torch.zeros((L, slot_cap), dtype=torch.int64)
    solid_sh[:, :n_here] = lanes_t[:, off:off + n_here]
    counts_sh = torch.zeros((slot_cap,), dtype=torch.int64)
    counts_sh[:n_here] = counts_t[off:off + n_here]
    return _glue_and_assemble(mesh, solid_sh.to(mesh.device),
                              counts_sh.to(mesh.device), n_here, slot_cap, k,
                              timing, probe)


def distributed_compact(mesh, solid_per_dev, counts_per_dev, k: int,
                        timing: Optional[dict] = None):
    """Compaction without first-occurrence keys (bcalm_tpu
    distributed_compact): distributed_compact_pos with all-zero keys, which
    leaves the k-mers in their given order and makes every k-mer a run."""
    zeros = [np.zeros((np.asarray(c).shape[0],), np.uint32)
             for c in counts_per_dev]
    return distributed_compact_pos(mesh, solid_per_dev, counts_per_dev, zeros,
                                   k, timing)


def assemble_from_glue(outs_np, n_unitigs: int, solid_global: torch.Tensor,
                       counts_global: torch.Tensor, n_local, slot_cap: int,
                       run_cap: int, n_dev: int, k: int):
    """Unitigs from the gathered glue outputs (bcalm_tpu
    assemble_from_glue): per-run labels broadcast over the run members on
    the host (numpy), then spelling on the device of the solid table (K11)
    and the links from its codes (engine.unitig_links)."""
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
    seqs, kc, abund, circular_u, codes = engine.assemble_unitigs_device(
        solid_global, counts_global, info, k, n_unitigs, n_solid)
    links = engine.unitig_links(codes, info["length"], k)
    return engine.UnitigSet(
        k=k, seqs=seqs, kc=kc, abundances=abund, circular=circular_u,
        links=links, stats={
            "devices": n_dev,
            "solid_kmers": n_solid,
            "glue_runs": R_total,
            "glue_contraction": float(n_solid) / max(1, R_total),
        })
