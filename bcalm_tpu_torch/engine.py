"""Single-device end-to-end build on torch: reads -> unitigs + links.

Counterpart of ``bcalm_tpu/engine.py`` for its resident single-device
path (``build_from_blocks`` without the out-of-core branch):

  1. count_blocks: extraction (K1) into fixed-size chunks, per-chunk
     counting (sort + K2), LSM merges of the counted runs;
  2. abundance histogram + solidity fold;
  3. compact_solid_pos: reorder by first-occurrence key, junctions (K3),
     consecutive-run contraction and the weighted pointer jump (K4);
  4. assembly on the device, link join and UnitigSet on the host.

Every function takes an explicit ``device``; tensors stay on it until the
assembled bytes are fetched.  The host pieces that the JAX package keeps
in its engine (EngineConfig, UnitigSet, link_join) are carried here,
because importing that engine imports JAX.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from bcalm_tpu.io import packing
from bcalm_tpu.utils import dna
from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import count as count_op
from bcalm_tpu_torch.ops import extract as extract_op
from bcalm_tpu_torch.ops import runchains

# device memory of one H100 80GB card; the counting budgets are sized for it
DEVICE_BYTES = 80 * 10**9


def resident_slots(k: int) -> int:
    """Distinct k-mers the resident counter may hold on one card.

    A resident distinct k-mer costs (L+2)*8 bytes (lanes, count, pos); a
    merge costs per slot what counting a chunk slot does, (3L+10)*8 bytes
    (the L+1 row input, sort key, permutation and sort workspace, sorted
    lanes and pos, flags, group ids, and the L+2 outputs).  60% of the
    card keeps the largest merge inside it."""
    L = ln.num_lanes(k)
    return int(0.6 * DEVICE_BYTES) // ((L + 2) * 8 + (3 * L + 10) * 8)


@dataclass
class EngineConfig:
    k: int = 31
    abundance_min: int = 2
    abundance_max: int = 2**31 - 1
    block_reads: int = 4096
    max_len: int = 512
    histo_max: int = 10000
    # occurrence slots counted per chunk, each costing (3L+10)*8 bytes of
    # workspace (resident_slots); the counted output does not depend on it
    chunk_kmers: int = 1 << 25


@dataclass
class UnitigSet:
    """Engine output: the compacted bi-directed de Bruijn graph."""

    k: int
    seqs: List[str]
    kc: np.ndarray                # (U,) total k-mer abundance per unitig
    abundances: List[np.ndarray]  # per-k-mer abundances along each unitig
    circular: np.ndarray          # (U,) bool
    links: List[Tuple[int, str, int, str]] = field(default_factory=list)
    histogram: Optional[np.ndarray] = None
    stats: Dict = field(default_factory=dict)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _merge_runs(runs):
    """Weighted merge of counted (unique, counts, minpos) runs into one."""
    lanes = torch.cat([r[0] for r in runs], dim=1)
    weights = torch.cat([r[1] for r in runs])
    pos = torch.cat([r[2] for r in runs])
    unique, counts, minpos, n = count_op.count_canonical(lanes, weights, pos)
    n = int(n)
    return unique[:, :n].clone(), counts[:n].clone(), minpos[:n].clone()


def count_blocks(blocks: Iterable[packing.ReadBlock], cfg: EngineConfig,
                 device):
    """Extract + count canonical k-mers over all blocks, resident on one
    device.

    Blocks stream into a (L+1, chunk) buffer of k-mer lanes plus
    first-occurrence keys; each full chunk is counted into a sorted
    distinct run, and runs of equal generation merge as they appear
    (an LSM ladder), so residency tracks the distinct set.

    Returns (unique (L, n), counts (n,), minpos (n,), stats): the sorted
    distinct k-mers, their counts and min first-occurrence keys."""
    k = cfg.k
    L = ln.num_lanes(k)
    budget = resident_slots(k)
    buf = None
    cap = fill = block_F = 0
    slot_base = 0
    runs: list = []          # (unique, counts, minpos, generation)
    stats = {"reads": 0, "bases": 0, "kmer_occurrences": 0}

    def merge_generations():
        while len(runs) >= 2 and runs[-1][3] == runs[-2][3]:
            b, a = runs.pop(), runs.pop()
            runs.append(_merge_runs([a[:3], b[:3]]) + (a[3] + 1,))

    def check_budget():
        if sum(r[0].shape[1] for r in runs) <= budget:
            return
        merged = _merge_runs([r[:3] for r in runs])
        runs[:] = [merged + (max(r[3] for r in runs) + 1,)]
        if merged[0].shape[1] > budget:
            raise RuntimeError(
                f"{merged[0].shape[1]} distinct {k}-mers exceed the resident "
                f"budget of {budget} on {device}: multi-pass out-of-core "
                f"counting is not yet ported (ROADMAP A10)")

    def flush():
        nonlocal fill
        if fill == 0:
            return
        unique, counts, minpos, n = count_op.count_canonical(
            buf[:L, :fill], pos=buf[L, :fill])
        n = int(n)
        runs.append((unique[:, :n].clone(), counts[:n].clone(),
                     minpos[:n].clone(), 0))
        fill = 0
        merge_generations()
        check_budget()

    for block in blocks:
        F = extract_op.block_slots(block.words.shape, k)
        if buf is None or F != block_F:
            flush()
            block_F = F
            cap = max(cfg.chunk_kmers, F)
            buf = torch.empty((L + 1, cap), dtype=torch.int64, device=device)
        if fill + F > cap:
            flush()
        lens = block.lengths.astype(np.int64)
        stats["reads"] += int((lens > 0).sum())
        stats["bases"] += int(lens.sum())
        stats["kmer_occurrences"] += int(np.maximum(0, lens - k + 1).sum())
        words = torch.from_numpy(block.words.astype(np.int64)).to(device)
        lengths = torch.from_numpy(lens).to(device)
        extract_op.extract_insert(buf, words, lengths, k,
                                  slot_base & 0x7FFFFFFF, fill)
        slot_base += F
        fill += F
    flush()
    if not runs:
        empty = torch.zeros((L, 0), dtype=torch.int64, device=device)
        e1 = torch.zeros((0,), dtype=torch.int64, device=device)
        return empty, e1, e1.clone(), stats
    unique, counts, minpos = (_merge_runs([r[:3] for r in runs])
                              if len(runs) > 1 else runs[0][:3])
    return unique, counts, minpos, stats


def compact_solid_pos(solid, counts, minpos, n_solid: int, k: int):
    """Locality-ordered junction + chain stages on a sentinel-folded solid
    table.  Returns (solid_r, counts_r, info): the reordered table (width
    C = round_capacity(n_solid)) that the chain arrays refer to."""
    solid_r, counts_r = runchains.reorder_by_pos(solid, counts, minpos, k)
    C = runchains.round_capacity(max(1, n_solid))
    pad = C - solid_r.shape[1]
    if pad > 0:
        solid_r = torch.cat([solid_r, torch.full(
            (solid_r.shape[0], pad), ln.SENTINEL, dtype=torch.int64,
            device=solid_r.device)], dim=1)
        counts_r = torch.cat([counts_r, counts_r.new_zeros(pad)])
    solid_r, counts_r = solid_r[:, :C].contiguous(), counts_r[:C]
    succ, scan = runchains.junction_runs(solid_r, n_solid, k)
    R = scan["R"]
    info = runchains.run_decompose(
        succ, n_solid, scan["is_head"], scan["rid"], scan["head_pos"],
        scan["end_pos"], R, runchains.round_capacity(max(1, R)))
    return solid_r, counts_r, info


def _start_kmer_codes(s_lanes: torch.Tensor, k: int) -> torch.Tensor:
    """(L, U) k-mer lanes -> (k, U) base codes, first base first."""
    r = ln.top_lane_bases(k)
    j = torch.arange(k, device=s_lanes.device)
    t = j - r
    lane = torch.where(j < r, 0, 1 + torch.div(t, 16, rounding_mode="floor"))
    shift = torch.where(j < r, 2 * (r - 1 - j), 2 * (15 - torch.remainder(t, 16)))
    return (s_lanes[lane] >> shift[:, None]) & 3


def assemble_device(solid, counts, info, k: int, n_unitigs: int):
    """Spell unitigs on the device (bcalm_tpu engine._assemble_dev).

    Every member oriented k-mer writes its last base at
    offset(uid) + k-1 + rank, each unitig's start k-mer writes its k bases,
    and member counts come out in (uid, rank) order.  Returns (codes u8,
    member-ordered counts, per-unitig lengths)."""
    C = solid.shape[1]
    uid, rank = info["uid"], info["rank"]
    M = uid.shape[0]
    dev = solid.device
    len_u = info["length"][:n_unitigs]
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                         torch.cumsum(len_u + (k - 1), 0)])
    codes = torch.zeros((int(offsets[-1]),), dtype=torch.uint8, device=dev)

    m_oid = torch.nonzero(uid >= 0).flatten()
    v = torch.where(m_oid >= C, m_oid - C, m_oid)
    r = ln.top_lane_bases(k)
    first_b = (solid[0, v] >> (2 * (r - 1))) & 3
    last_b = torch.where(m_oid >= C, first_b ^ 2, solid[-1, v] & 3)
    m_uid, m_rank = uid[m_oid], rank[m_oid]
    codes[offsets[m_uid] + (k - 1) + m_rank] = last_b.to(torch.uint8)

    so = info["start_oid"][:n_unitigs]
    sv = torch.where(so >= C, so - C, so)
    fwd = _start_kmer_codes(solid[:, sv], k)
    start_codes = torch.where((so >= C)[None], (fwd ^ 2).flip(0), fwd)
    dest = offsets[:-1][None, :] + torch.arange(k, device=dev)[:, None]
    codes[dest.flatten()] = start_codes.flatten().to(torch.uint8)

    order = torch.sort(m_uid * M + m_rank).indices
    return codes, counts[v[order]], len_u


def assemble_unitigs_device(solid, counts, info, k: int, n_unitigs: int):
    """Device assembly + host string slicing: (seqs, kc, abundances,
    circular)."""
    if n_unitigs == 0:
        return [], np.zeros(0, np.int64), [], np.zeros(0, bool)
    codes_d, counts_d, len_d = assemble_device(solid, counts, info, k,
                                               n_unitigs)
    codes = codes_d.cpu().numpy()
    mcounts = counts_d.cpu().numpy().astype(np.int64)
    length = len_d.cpu().numpy()
    circular = info["circular"][:n_unitigs].cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(length + (k - 1))])
    ascii_all = dna.CODE_TO_ASCII[codes].tobytes()
    seqs = [ascii_all[offsets[u]: offsets[u + 1]].decode()
            for u in range(n_unitigs)]
    run_bounds = np.concatenate([[0], np.cumsum(length)])
    kc = np.add.reduceat(mcounts, run_bounds[:-1])
    abund = np.split(mcounts.astype(np.int32), run_bounds[1:-1])
    return seqs, kc, abund, circular


def _pack_ends(codes: np.ndarray) -> np.ndarray:
    """(E, k-1) uint8 base codes -> (E, W) uint64 packed key columns."""
    E, m = codes.shape
    W = max(1, (m + 31) // 32)
    out = np.zeros((E, W), dtype=np.uint64)
    for j in range(m):
        out[:, j // 32] |= codes[:, j].astype(np.uint64) << np.uint64(
            2 * (31 - j % 32))
    return out


def link_join(seqs: List[str], k: int) -> List[Tuple[int, str, int, str]]:
    """All (k-1)-overlap links between unitig extremities, sorted by
    (src, sign, dst, sign) (numpy; bcalm_tpu engine.link_join)."""
    U = len(seqs)
    if U == 0:
        return []
    m = k - 1
    lut = np.zeros(256, dtype=np.uint8)
    lut[np.frombuffer(b"ACTG", np.uint8)] = np.arange(4, dtype=np.uint8)
    lut[np.frombuffer(b"actg", np.uint8)] = np.arange(4, dtype=np.uint8)
    pre = lut[np.frombuffer(b"".join(s[:m].encode() for s in seqs),
                            np.uint8)].reshape(U, m)
    suf = lut[np.frombuffer(b"".join(s[-m:].encode() for s in seqs),
                            np.uint8)].reshape(U, m)
    rc_pre = (pre ^ 2)[:, ::-1]
    rc_suf = (suf ^ 2)[:, ::-1]
    # out-ends: (i,+) -> suf, (i,-) -> rc(pre); in-ends: (i,+) -> pre,
    # (i,-) -> rc(suf)
    out_keys = _pack_ends(np.concatenate([suf, rc_pre]))
    in_keys = _pack_ends(np.concatenate([pre, rc_suf]))
    _, gid = np.unique(np.concatenate([out_keys, in_keys]), axis=0,
                       return_inverse=True)
    gid = gid.reshape(-1)
    g_out, g_in = gid[: 2 * U], gid[2 * U:]
    ci = np.bincount(g_in, minlength=int(gid.max()) + 1)
    o_order = np.argsort(g_out, kind="stable")
    i_order = np.argsort(g_in, kind="stable")
    g_out_s = g_out[o_order]
    in_start = np.concatenate([[0], np.cumsum(ci)])
    rep = ci[g_out_s]
    P = int(rep.sum())
    if P == 0:
        return []
    out_rep = np.repeat(o_order, rep)
    g_rep = np.repeat(g_out_s, rep)
    first_slot = np.concatenate([[0], np.cumsum(rep)])[:-1]
    within = np.arange(P) - np.repeat(first_slot, rep)
    in_rep = i_order[in_start[g_rep] + within]
    src_id = (out_rep % U).astype(np.int64)
    src_sign = np.where(out_rep < U, "+", "-")
    dst_id = (in_rep % U).astype(np.int64)
    dst_sign = np.where(in_rep < U, "+", "-")
    order = np.lexsort((dst_sign, dst_id, src_sign, src_id))
    return [(int(src_id[t]), str(src_sign[t]), int(dst_id[t]),
             str(dst_sign[t])) for t in order]


def build_from_blocks(blocks: Iterable[packing.ReadBlock], cfg: EngineConfig,
                      device) -> UnitigSet:
    """Device-resident end-to-end build from packed read blocks."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    unique, counts, minpos, stats = count_blocks(blocks, cfg, device)
    _sync(device)
    stats["t_count_s"] = round(time.time() - t0, 2)
    n_u = unique.shape[1]
    histo = count_op.abundance_histogram(counts, n_u, cfg.histo_max)
    histo = histo.cpu().numpy().astype(np.int32)
    solid, counts_s, pos_s, n_solid = count_op.filter_abundance_fold(
        unique, counts, minpos, n_u, cfg.abundance_min, cfg.abundance_max)
    n_solid = int(n_solid)
    stats["distinct_kmers"] = n_u
    stats["solid_kmers"] = n_solid
    stats["solid_kmer_abundance"] = int(counts_s.sum())
    if n_solid == 0:
        return UnitigSet(k=cfg.k, seqs=[], kc=np.zeros(0, np.int64),
                         abundances=[], circular=np.zeros(0, bool),
                         histogram=histo, stats=stats)
    t1 = time.time()
    solid_r, counts_r, info = compact_solid_pos(solid, counts_s, pos_s,
                                                n_solid, cfg.k)
    n_unitigs = int(info["n_unitigs"])
    _sync(device)
    stats["t_compact_s"] = round(time.time() - t1, 2)
    t1 = time.time()
    seqs, kc, abund, circular = assemble_unitigs_device(
        solid_r, counts_r, info, cfg.k, n_unitigs)
    links = link_join(seqs, cfg.k)
    stats["t_assemble_s"] = round(time.time() - t1, 2)
    stats["unitigs"] = len(seqs)
    if device.type == "cuda":
        stats["device_peak_mb"] = torch.cuda.max_memory_allocated(device) >> 20
    return UnitigSet(k=cfg.k, seqs=seqs, kc=kc, abundances=abund,
                     circular=circular, links=links, histogram=histo,
                     stats=stats)


def build_from_seqs(seqs: Iterable[str], cfg: EngineConfig,
                    device) -> UnitigSet:
    blocks = packing.iter_blocks(seqs, cfg.k, block_reads=cfg.block_reads,
                                 max_len=cfg.max_len)
    return build_from_blocks(blocks, cfg, device)
