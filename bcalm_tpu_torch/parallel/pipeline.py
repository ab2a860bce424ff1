"""The ``-devices N`` build: streamed, minimizer-partitioned counting.

Counterpart of ``bcalm_tpu/parallel/pipeline.py``'s production path
(``distributed_build`` and the shard_map bodies it runs), one process per
rank over ``parallel.mesh``:

1. sampling: each rank's share of the first SAMPLE_ROUNDS rounds feeds the
   canonical m-mer histogram and the per-minimizer load (K14), summed over
   the ranks; frequency rank and repartition table on the host
   (models.minimizer);
2. each round, every rank forms the superkmers of its rows (K13), places
   them in per-rank buckets (K15), exchanges them (all_to_all), re-extracts
   the received superkmers' k-mers with their stream slots (K1, one slot
   base per superkmer) and counts them (torch.sort + K2); an exchange
   overflow doubles the capacity and re-runs the round;
3. per-rank distinct runs merge in LSM generations (torch.sort + K2,
   weighted); when a rank's resident distinct set passes the budget,
   counting restarts multi-pass over global key ranges (K5), reading the
   input again;
4. abundance histogram (summed over the ranks) and solidity fold (K7),
   optional ``-abundance-min auto``, store checkpoint with the repartition
   table (rank 0 writes);
5. sharded compaction (parallel.distcompact).

Every rank iterates the same input rounds and takes rows
``[rank*B, (rank+1)*B)`` of each, so each rank parses the whole input.
The per-k-mer hash-routing helpers of the JAX module (distributed_count,
pack_global_blocks, gather_solid) and its compile-latency capacity ladder
are not carried: the ladder's hit count is reported as 0.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from bcalm_tpu_torch.io import packing
from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.models import minimizer as mz
from bcalm_tpu_torch.ops import _kernels
from bcalm_tpu_torch.ops import count as count_op
from bcalm_tpu_torch.ops import extract as extract_op
from bcalm_tpu_torch.ops import superkmer as skm
from bcalm_tpu_torch.ops.runchains import round_capacity

SENTINEL = ln.SENTINEL
# rounds buffered for the repartition sampling pass
SAMPLE_ROUNDS = 8


def route_to_buckets_plain(stacked: torch.Tensor, valid: torch.Tensor,
                           owner: torch.Tensor, n_dev: int, cap: int,
                           with_slots: bool = False):
    """Plain PyTorch version of K15 (bcalm_tpu _route_to_buckets: stable
    argsort by owner, position within each owner run)."""
    C, N = stacked.shape
    dev = stacked.device
    owner = torch.where(valid, owner, n_dev)
    order = torch.sort(owner, stable=True).indices
    s_owner = owner[order]
    s_valid = valid[order]
    idx = torch.arange(N, device=dev)
    is_start = torch.ones(N, dtype=torch.bool, device=dev)
    if N > 1:
        is_start[1:] = s_owner[1:] != s_owner[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    within = idx - run_start
    ok = s_valid & (within < cap) & (s_owner < n_dev) & (s_owner >= 0)
    dest = torch.where(ok, s_owner * cap + within, n_dev * cap)
    buckets = torch.zeros((C, n_dev * cap), dtype=torch.int64, device=dev)
    buckets[:, dest[ok]] = stacked[:, order[ok]]
    bvalid = torch.zeros((n_dev * cap,), dtype=torch.bool, device=dev)
    bvalid[dest[ok]] = True
    dropped = (s_valid & ~ok).sum().reshape(1)
    out = (buckets.reshape(C, n_dev, cap), bvalid.reshape(n_dev, cap), dropped)
    if with_slots:
        slots = torch.empty(N, dtype=torch.int64, device=dev)
        slots[order] = dest
        out = out + (slots,)
    return out


def route_to_buckets(stacked: torch.Tensor, valid: torch.Tensor,
                     owner: torch.Tensor, n_dev: int, cap: int,
                     with_slots: bool = False):
    """Scatter the valid columns of a channel-major (C, N) stack into
    per-rank buckets by owner, in entry order within each bucket.

    Returns (buckets (C, n_dev, cap), bucket_valid (n_dev, cap), n_dropped
    (1,)[, slots (N,)]); an entry past its bucket's cap is dropped and
    counted, never silent.  slots: each entry's flat bucket slot
    (owner*cap + within; n_dev*cap when dropped or invalid), which matches
    answers that come back in the same layout to their entries.  K15 for
    CUDA tensors, the plain version for CPU tensors."""
    if stacked.device.type == "cpu":
        return route_to_buckets_plain(stacked, valid, owner, n_dev, cap,
                                      with_slots)
    return _kernels.route_buckets(stacked, valid, owner, n_dev, cap,
                                  with_slots)


def iter_global_blocks(seqs, k: int, n_dev: int, block_reads: int,
                       max_len: int):
    """Stream (words, lengths) rounds of exactly n_dev * block_reads rows
    (numpy; the last round zero-padded)."""
    acc_w, acc_l = [], []
    width = None
    for b in packing.iter_blocks(seqs, k, block_reads=block_reads,
                                 max_len=max_len):
        acc_w.append(b.words)
        acc_l.append(b.lengths)
        width = b.words.shape[1]
        if len(acc_w) == n_dev:
            yield np.concatenate(acc_w), np.concatenate(acc_l)
            acc_w, acc_l = [], []
    if acc_w:
        pad = n_dev - len(acc_w)
        acc_w += [np.zeros((block_reads, width), np.uint32)] * pad
        acc_l += [np.zeros((block_reads,), np.int32)] * pad
        yield np.concatenate(acc_w), np.concatenate(acc_l)


@dataclass
class MinimizerConfig:
    """-minimizer-size, -minimizer-type, -repartition-type (bcalm_tpu
    MinimizerConfig)."""
    m: int = 8
    minimizer_type: int = 1     # 0 lexicographic, 1 frequency
    repartition_type: int = 1   # 0 uniform, 1 balanced bin packing
    max_span: Optional[int] = None  # k-mers/superkmer cap (None = per-k)
    cap_per_dest: Optional[int] = None  # superkmer exchange capacity


def effective_m(k: int, m: int) -> int:
    """m must leave at least one m-mer per k-mer and fit one lane."""
    return max(1, min(m, k - 1, 16))


def _my_rows(mesh, words: np.ndarray, lengths: np.ndarray):
    """This rank's rows of a global round, as int64 tensors on its device."""
    B = words.shape[0] // mesh.n_dev
    rows = slice(mesh.rank * B, (mesh.rank + 1) * B)
    w = torch.from_numpy(words[rows].astype(np.int64)).to(mesh.device)
    l = torch.from_numpy(lengths[rows].astype(np.int64)).to(mesh.device)
    return w, l


def sample_tables_multi(mesh, sample_rounds, k: int, mcfg: MinimizerConfig,
                        n_parts: int):
    """Frequency rank and repartition table from the buffered sample
    rounds (bcalm_tpu sample_tables_multi): each rank histograms its rows
    (K14), the ranks' sums are added.  Returns (freq_rank or None, table,
    load), numpy, the same on every rank."""
    m = effective_m(k, mcfg.m)
    freq_rank = None
    rank_d = None
    if mcfg.minimizer_type == 1:
        histo = torch.zeros((4 ** m,), dtype=torch.int64, device=mesh.device)
        for words, lengths in sample_rounds:
            histo += skm.sample_cmmer_histogram(*_my_rows(mesh, words, lengths),
                                                k, m)
        histo = mesh.psum(histo).cpu().numpy()
        freq_rank = mz.frequency_rank(np.minimum(histo, 2**31 - 1).astype(np.int32))
        rank_d = torch.from_numpy(freq_rank.astype(np.int64)).to(mesh.device)
    load = torch.zeros((4 ** m,), dtype=torch.int64, device=mesh.device)
    for words, lengths in sample_rounds:
        load += skm.sample_minimizer_load(*_my_rows(mesh, words, lengths), k, m,
                                          rank_d, use_rank=rank_d is not None)
    load = np.minimum(mesh.psum(load).cpu().numpy(), 2**31 - 1).astype(np.int32)
    table = mz.build_repartition(load, n_parts, mcfg.repartition_type)
    return freq_rank, table, load


def superkmer_capacity(block_reads: int, max_len: int, k: int, m: int,
                       n_dev: int, max_span: int, slack: float = 3.0,
                       max_share: Optional[float] = None) -> int:
    """Per-destination superkmer bucket capacity for one round, sized to
    the sampled worst per-rank load share."""
    occ = max(1, max_len - k + 1)
    per_read = occ / skm.est_span(k, m) + 1.0
    share = max(1.0 / n_dev, max_share if max_share else 1.0 / n_dev)
    return int(max(64, np.ceil(block_reads * n_dev * per_read
                               * slack * share)))


def local_skm_count(mesh, words, lengths, table, rank, round_base: int, *,
                    k: int, m: int, cap: int, max_span: int, use_rank: bool):
    """One superkmer round on this rank (bcalm_tpu _local_skm_count):
    superkmers (K13), buckets (K15), exchange, re-extraction with
    first-occurrence keys ((slot & 0x3FFFFFFF) << 1 | rc, K1 with one slot
    base per received superkmer), count (torch.sort + K2).  Returns
    (unique, counts, minpos, n_unique, stats (4,) summed over the ranks:
    dropped, k-mer positions, superkmers, re-extracted k-mers)."""
    n_dev = mesh.n_dev
    B, W = words.shape
    pos_base = (round_base + mesh.rank * B * W * 16) & ln.U32
    skm_words, owner, start, n_kmers = skm.form_superkmers(
        words, lengths, k, m, table, rank, max_span=max_span,
        use_rank=use_rank, with_pos=True, pos_base=pos_base)
    Wn = skm_words.shape[0] - 1
    bl, bv, dropped = route_to_buckets(skm_words, start, owner, n_dev, cap)
    recv, rv = mesh.exchange(bl, bv)
    ent = recv.reshape(Wn + 1, -1)
    ev = rv.reshape(-1)
    r_words = ent[:Wn].t().contiguous()
    span = skm.decode_span(ent[Wn - 1], max_span)
    r_len = torch.where(ev, span + (k - 1), 0)
    L = ln.num_lanes(k)
    P_eff = max(1, 16 * Wn - (k - 1))
    body = torch.empty((L + 1, r_words.shape[0] * P_eff), dtype=torch.int64,
                       device=words.device)
    extract_op.extract_insert(body, r_words, r_len, k, 0, 0,
                              row_base=ent[Wn].contiguous())
    n_valid = (body[L] != SENTINEL).sum().reshape(1)
    unique, counts, minpos, n_unique = count_op.count_canonical(
        body[:L], pos=body[L])
    stats = mesh.psum(torch.cat([dropped, n_kmers, start.sum().reshape(1),
                                 n_valid]))
    return unique, counts, minpos, int(n_unique), stats.cpu().numpy()


def stack_trim(unique, counts, minpos, n_u: int, cap_out: int, lo=None,
               hi=None):
    """A counted round trimmed to one stacked (L+2, cap_out) run (lanes,
    counts, first-occurrence keys), the tail folded (bcalm_tpu
    stack_trim_fn).  With lo/hi, the columns outside the global key range
    [lo, hi) fold too (K5).  Returns (stacked, n)."""
    L = unique.shape[0]
    keep = torch.arange(cap_out, device=unique.device) < n_u
    lanes = torch.where(keep[None], unique[:, :cap_out], SENTINEL)
    c = torch.where(keep, counts[:cap_out], 0)
    p = torch.where(keep, minpos[:cap_out], SENTINEL)
    n = min(n_u, cap_out)
    if lo is not None:
        body = torch.cat([lanes, p[None]])
        n = int(count_op.range_fold(body, lo, hi)[0])
        lanes, p = body[:L], body[L]
        c = torch.where(p != SENTINEL, c, 0)
    return torch.cat([lanes, c[None], p[None]]), n


def sharded_merge(a: torch.Tensor, b: torch.Tensor, cap_out: int):
    """Weighted merge of two stacked runs of this rank (bcalm_tpu
    sharded_merge_fn; torch.sort + K2).  Returns (stacked at cap_out, n)."""
    L = a.shape[0] - 2
    stk = torch.cat([a, b], dim=1)
    pad = cap_out - stk.shape[1]
    if pad > 0:
        tail = torch.zeros((L + 2, pad), dtype=torch.int64, device=stk.device)
        tail[:L] = SENTINEL
        tail[L + 1] = SENTINEL
        stk = torch.cat([stk, tail], dim=1)
    u, c, p, n = count_op.count_canonical(stk[:L], weights=stk[L],
                                          pos=stk[L + 1])
    n = int(n)
    keep = torch.arange(u.shape[1], device=u.device) < n
    u = torch.where(keep[None], u, SENTINEL)
    p = torch.where(keep, p, SENTINEL)
    return torch.cat([u, c[None], p[None]]), n


def finish_count(mesh, stk: torch.Tensor, n_loc: int, amin: int, amax: int,
                 histo_max: int):
    """Abundance histogram (summed over the ranks) and solidity fold (K7)
    of this rank's final run (bcalm_tpu finish_count_fn).  Returns (solid
    stacked (L+2, cap), n_solid, histogram (histo_max+1,) numpy)."""
    L = stk.shape[0] - 2
    solid, c, p, n_solid, histo = count_op.solid_fold_histogram(
        stk[:L], stk[L], stk[L + 1], n_loc, amin, amax, histo_max)
    histo = mesh.psum(histo).cpu().numpy()
    return torch.cat([solid, c[None], p[None]]), int(n_solid[0]), histo


def empty_unitigs(k: int, stats: dict, histo=None):
    """The UnitigSet of a build without solid k-mers."""
    from bcalm_tpu_torch import engine

    return engine.UnitigSet(k=k, seqs=[], kc=np.zeros(0, np.int64),
                            abundances=[], circular=np.zeros(0, bool),
                            histogram=histo, stats=stats)


def distributed_build(mesh, seqs, cfg, mcfg: Optional[MinimizerConfig] = None,
                      auto_amin_cap: Optional[int] = None, store=None,
                      reread=None, timing: Optional[dict] = None,
                      probe: Optional[dict] = None):
    """Streamed, minimizer-partitioned build on this rank of the mesh
    (bcalm_tpu distributed_build); every rank calls it with the same
    arguments.  Returns the UnitigSet on rank 0, None on the other ranks.

    auto_amin_cap: derive the abundance cutoff from the merged histogram
    (cfg.abundance_min is updated in place on every rank).  store: the
    solid counts, histogram, first-occurrence keys and the repartition
    table are checkpointed (rank 0 writes).  reread: a callable giving the
    sequences again, for the multi-pass key ranges.  timing: filled with
    the wall seconds of each stage."""
    import time

    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.parallel import distcompact

    timing = {} if timing is None else timing
    t0 = time.time()
    mcfg = mcfg or MinimizerConfig()
    n_dev = mesh.n_dev
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    k = cfg.k
    m = effective_m(k, mcfg.m)
    max_span = mcfg.max_span or skm.default_max_span(k)
    block_reads = min(cfg.block_reads, 1024)
    L = ln.num_lanes(k)

    rounds = iter_global_blocks(seqs, k, n_dev, block_reads, cfg.max_len)
    sample = list(itertools.islice(rounds, SAMPLE_ROUNDS))
    if not sample:
        return empty_unitigs(k, {"solid_kmers": 0}) if mesh.rank == 0 else None
    freq_rank, table, load = sample_tables_multi(mesh, sample, k, mcfg, n_dev)
    table_d = torch.from_numpy(table.astype(np.int64)).to(dev)
    rank_d = (torch.from_numpy(freq_rank.astype(np.int64)).to(dev)
              if freq_rank is not None else None)
    load_per_dev = np.bincount(table, weights=load.astype(np.float64),
                               minlength=n_dev)
    max_share = float(load_per_dev.max()) / max(1.0, load_per_dev.sum())
    cap = mcfg.cap_per_dest or superkmer_capacity(
        block_reads, cfg.max_len, k, m, n_dev, max_span, max_share=max_share)
    use_rank = freq_rank is not None
    timing["sampling"] = time.time() - t0
    if probe is not None:
        probe.update(table=table, freq_rank=freq_rank)

    totals = np.zeros((4,), np.int64)   # dropped, kmers, skms, routed
    retries = 0
    resident_kmers = cfg.resident_kmers or engine.resident_slots(
        k, engine.device_bytes(dev))
    budget_dev = max(resident_kmers // max(1, n_dev), 1024)
    partials: list = []                 # [stacked, n (per rank), gen]

    def merge_two(a, b):
        cap_out = round_capacity(a[0].shape[1] + b[0].shape[1])
        stk, n = sharded_merge(a[0], b[0], cap_out)
        n_all = mesh.gather_ints([n])[:, 0]
        cap_t = round_capacity(max(1, int(n_all.max())))
        if cap_t < cap_out:
            stk = stk[:, :cap_t].contiguous()
        return [stk, n_all, max(a[2], b[2]) + 1]

    def run_pass(round_iter, lo, hi, first_pass, watch_budget):
        """One pass over the input for one key range.  Returns (final
        [stacked, n_all] or None if empty, budget overflow flag)."""
        nonlocal cap, retries, totals
        partials.clear()
        round_base = 0
        resident = np.zeros((n_dev,), np.int64)
        for words, lengths in round_iter:
            w_d, l_d = _my_rows(mesh, words, lengths)
            rb = round_base & 0x3FFFFFFF
            while True:
                unique, counts, minpos, n_u, st = local_skm_count(
                    mesh, w_d, l_d, table_d, rank_d, rb, k=k, m=m, cap=cap,
                    max_span=max_span, use_rank=use_rank)
                if st[0] == 0:
                    break
                # exchange overflow: double the capacity, re-run the round
                cap *= 2
                retries += 1
                if cap > (1 << 24):
                    raise RuntimeError(
                        f"superkmer exchange overflow persists at {cap}")
            if first_pass:
                totals += st
            round_base += words.shape[0] * words.shape[1] * 16
            n_all = mesh.gather_ints([n_u])[:, 0]
            cap_d = min(unique.shape[1], round_capacity(max(1, int(n_all.max()))))
            stk, n = stack_trim(unique, counts, minpos, n_u, cap_d, lo, hi)
            del unique, counts, minpos
            n_all = mesh.gather_ints([n])[:, 0] if lo is not None else n_all
            partials.append([stk, n_all, 0])
            resident += n_all
            while len(partials) >= 2 and partials[-1][2] == partials[-2][2]:
                b = partials.pop()
                a = partials.pop()
                merged = merge_two(a, b)
                resident += merged[1] - a[1] - b[1]
                partials.append(merged)
            if watch_budget and int(resident.max()) > budget_dev:
                return None, True
        if first_pass:
            assert totals[1] == totals[3], "routed k-mers != extracted k-mers"
        while len(partials) > 1:
            b = partials.pop()
            a = partials.pop()
            partials.append(merge_two(a, b))
        if not partials:
            return None, False
        final = partials.pop()
        return [final[0], final[1]], False

    def pivots_from(final):
        """Global key-range pivots: Q quantile keys of each rank's resident
        run, gathered, as a sorted list of distinct lane tuples."""
        stk, n_all = final
        Q = 256
        capF = stk.shape[1]
        n_loc = int(n_all[mesh.rank])
        qi = torch.clamp(((torch.arange(Q, device=dev) + 1) * n_loc) // (Q + 1),
                         0, capF - 1)
        qs = mesh.all_gather(stk[:L, qi].contiguous()).cpu().numpy()
        qs = np.concatenate(list(qs), axis=1)
        return sorted({tuple(int(x) for x in qs[:, j])
                       for j in range(qs.shape[1])})

    t1 = time.time()
    first_rounds = itertools.chain(sample, rounds)
    final, overflow = run_pass(first_rounds, None, None, True,
                               watch_budget=reread is not None)
    timing["rounds"] = time.time() - t1
    t1 = time.time()
    bounds = None
    if overflow:
        # multi-pass key ranges: force-merge what is resident, pivots from
        # its quantiles, then one pass over the input per range
        while len(partials) > 1:
            b = partials.pop()
            a = partials.pop()
            partials.append(merge_two(a, b))
        part = partials.pop()
        d_now = int(part[1].sum())
        seen = max(1, int(totals[1]))
        total_est = max(cfg.est_total_occ, 2 * seen, seen)
        proj = d_now * (total_est / seen)
        n_ranges = int(np.clip(np.ceil(1.5 * proj / (budget_dev * n_dev)), 2,
                               64))
        cols = pivots_from([part[0], part[1]])
        partials.clear()
        del part
        step = max(1, len(cols) // n_ranges)
        pivots = [list(cols[j]) for j in range(step - 1, len(cols) - 1, step)
                  ][:n_ranges - 1]
        bounds = [[0] * L] + pivots + [[SENTINEL] * L]
        totals[:] = 0
        histo_acc = np.zeros((cfg.histo_max + 1,), np.int64)
        mine = []
        for r in range(len(bounds) - 1):
            rounds_r = iter_global_blocks(reread(), k, n_dev, block_reads,
                                          cfg.max_len)
            final_r, _ = run_pass(rounds_r, bounds[r], bounds[r + 1], r == 0,
                                  watch_budget=False)
            if final_r is None:
                continue
            n_res = int(final_r[1].max())
            if n_res > 2 * budget_dev:
                raise RuntimeError(
                    f"mesh key range still exceeds 2x the per-device "
                    f"residency budget ({n_res} > 2*{budget_dev}); raise "
                    f"-max-memory or use fewer ranges/devices")
            s_stk, _, h_np = finish_count(mesh, final_r[0],
                                          int(final_r[1][mesh.rank]),
                                          cfg.abundance_min, cfg.abundance_max,
                                          cfg.histo_max)
            histo_acc += h_np
            keep = s_stk[L] >= max(1, cfg.abundance_min)
            mine.append(s_stk[:, keep])
            del s_stk
        mine = (torch.cat(mine, dim=1) if mine
                else torch.zeros((L + 2, 0), dtype=torch.int64, device=dev))
        histo = np.minimum(histo_acc, 2**31 - 1).astype(np.int32)
        if auto_amin_cap is not None:
            cfg.abundance_min = engine.auto_abundance_min(histo, auto_amin_cap)
            mine = mine[:, mine[L] >= cfg.abundance_min]
        n_solid_np = mesh.gather_ints([mine.shape[1]])[:, 0]
        capS = round_capacity(max(16, int(n_solid_np.max())))
        solid_stk = torch.zeros((L + 2, capS), dtype=torch.int64, device=dev)
        solid_stk[:L] = SENTINEL
        solid_stk[L + 1] = SENTINEL
        solid_stk[:, :mine.shape[1]] = mine
        del mine
    else:
        if final is None:
            return empty_unitigs(k, {"solid_kmers": 0}) if mesh.rank == 0 else None
        n_loc = int(final[1][mesh.rank])
        if auto_amin_cap is not None:
            # histogram first (abundance 1), then the cutoff, then re-finish
            _, _, h1 = finish_count(mesh, final[0], n_loc, 1, 2**31 - 1,
                                    cfg.histo_max)
            cfg.abundance_min = engine.auto_abundance_min(h1, auto_amin_cap)
        solid_stk, n_sol, histo = finish_count(
            mesh, final[0], n_loc, cfg.abundance_min, cfg.abundance_max,
            cfg.histo_max)
        histo = histo.astype(np.int32)
        n_solid_np = mesh.gather_ints([n_sol])[:, 0]
        del final
    amin = cfg.abundance_min
    timing["finish"] = time.time() - t1
    if probe is not None:
        probe.update(solid=solid_stk.cpu().numpy(), n_solid=n_solid_np)

    if store is not None:
        # the solid runs of every rank, in rank order, to rank 0
        stk_all = mesh.all_gather(solid_stk)
        if mesh.rank == 0:
            stk_np = torch.cat(list(stk_all), dim=1).cpu().numpy()
            counts_np = np.minimum(stk_np[L], 2**31 - 1).astype(np.int32)
            keep = counts_np >= max(1, amin)
            store.write_counts(
                stk_np[:L, keep].astype(np.uint32), counts_np[keep], k,
                histogram=histo, minpos=stk_np[L + 1, keep].astype(np.uint32),
                config={"abundance_min": cfg.abundance_min,
                        "abundance_max": cfg.abundance_max,
                        "solidity_kind": "sum"})
            store.write_repartition(table, freq_rank, m)
        del stk_all

    sizes = [int(x) for x in n_solid_np]
    mean_sz = max(1.0, float(np.mean(sizes)))
    stats = {
        "devices": n_dev,
        "device_load_imbalance": float(max(sizes)) / mean_sz,
        "minimizer_size": m,
        "minimizer_type": mcfg.minimizer_type,
        "repartition_type": mcfg.repartition_type,
        "exchange_cap_retries": retries,
        "ooc_ranges": (len(bounds) - 1) if overflow else 1,
        "ooc_passes": len(bounds) if overflow else 1,
        "exchange_ladder_hits": 0,
        "exchange_max_share": round(max_share, 4),
        "abundance_min": cfg.abundance_min,
        "kmer_occurrences": int(totals[1]),
        "superkmers": int(totals[2]),
        "mean_superkmer_span": float(totals[1]) / max(1, int(totals[2])),
        "exchange_words_per_kmer": (
            float(int(totals[2]) * (skm.span_words(k, max_span) + 1))
            / max(1, int(totals[1]))),
        # every rank packs the reads with the python packer
        # (iter_global_blocks), as the JAX package's mesh path does
        "ingest_parser": "python",
    }
    if int(n_solid_np.sum()) == 0:
        return (empty_unitigs(k, dict(stats, solid_kmers=0), histo)
                if mesh.rank == 0 else None)
    us = distcompact.distributed_compact_dev(mesh, solid_stk, n_solid_np, k,
                                             timing=timing, probe=probe)
    if us is None:
        return None
    us.histogram = histo
    us.stats.update(stats)
    us.stats["unitigs"] = len(us.seqs)
    us.stats["timing"] = dict(timing)
    if dev.type == "cuda":
        us.stats["device_peak_mb"] = torch.cuda.max_memory_allocated(dev) >> 20
    return us
