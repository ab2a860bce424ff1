"""Single-device end-to-end build on torch: reads -> unitigs + links.

Counterpart of ``bcalm_tpu/engine.py``'s single-device path
(``build_from_blocks``, resident and out-of-core):

  1. count_blocks: extraction (K1) into fixed-size chunks, per-chunk
     counting (sort + K2), LSM merges of the counted runs; when the
     distinct set outgrows the resident budget, multi-pass counting over
     key ranges (K5 range fold, K6 bounds) with one asynchronous fetch of
     each finished range to the host;
  2. abundance histogram + solidity fold (K7), or in numpy on the host
     table of a multi-pass count (compact_from_counts);
  3. with a Store, the checkpoint of the solid set: K9 compaction and one
     pinned asynchronous copy that rides behind compaction (the host
     table of a multi-pass count is written as it is);
  4. compact_solid_pos: reorder by first-occurrence key, junctions (K3),
     run scans (K8), run contraction (K12), the weighted pointer jump
     (hierarchical from 2^18 contracted nodes, K17-K19 with K4 at its
     deepest level; else K4) and its finish (K10); a table without
     first-occurrence keys (multi-sample counts) goes through compact_solid
     instead: junctions and the chain decomposition of all 2C oriented
     nodes (K3, K17-K19 and K4, K10);
  5. spelling on the device (K11), link join and UnitigSet on the host.

Every function takes an explicit ``device``; tensors stay on it until the
assembled bytes are fetched.  The host pieces that the JAX package keeps
in its engine (EngineConfig, configure_chunk, _BlockCache, UnitigSet,
link_join, combine_sample_counts, auto_abundance_min, chain_stats) are
carried here, because importing that engine imports JAX.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from bcalm_tpu_torch import convert
from bcalm_tpu_torch.io import packing
from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels
from bcalm_tpu_torch.ops import chains as chains_op
from bcalm_tpu_torch.ops import count as count_op
from bcalm_tpu_torch.ops import extract as extract_op
from bcalm_tpu_torch.ops import junctions as junctions_op
from bcalm_tpu_torch.ops import runchains
from bcalm_tpu_torch.utils import dna

# CPU tensors have no card to ask for its memory: the plain paths are
# sized as if for an 80 GB card
CPU_DEVICE_BYTES = 80 * 10**9
MIN_CHUNK = 1 << 20
MAX_CHUNK = 1 << 25
# raw resident runs may reach a few times the resident budget before an
# exact merge brings them back (the LSM ladder's unmerged generations and
# the 1.2x hysteresis of split_current_range); the model pays for this many
RESIDENT_SLACK = 4


class CompactionOOM(RuntimeError):
    """The device ran out of memory in compaction after the counted solid
    set was checkpointed to the store: the run resumes with -skip-bcalm
    in a fresh process, whose allocator is clean
    (bcalm_tpu.engine.CompactionOOM)."""


def _is_resource_exhausted(e: BaseException) -> bool:
    """An allocator's death: torch's OutOfMemoryError, or the text that
    bcalm_tpu.engine._is_resource_exhausted matches."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    s = f"{type(e).__name__}: {e}"
    return "RESOURCE_EXHAUSTED" in s or "ResourceExhausted" in s


def device_bytes(device) -> int:
    """Memory of the device: the card's total memory, or CPU_DEVICE_BYTES."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return CPU_DEVICE_BYTES


def chunk_slot_bytes(k: int) -> int:
    """Device bytes per chunk slot: the (L+1)-row buffer, counting the
    chunk, (3L+10)*8 (the L+1 row input, sort key, permutation and sort
    workspace, sorted lanes and pos, flags, group ids, the L+2 outputs),
    and the previous chunk's L+2 outputs, which the lagged settle keeps
    until this chunk is counted."""
    L = ln.num_lanes(k)
    return (L + 1) * 8 + (3 * L + 10) * 8 + (L + 2) * 8


def resident_slot_bytes(k: int) -> int:
    """Device bytes per slot of the resident budget: RESIDENT_SLACK times
    a settled distinct k-mer ((L+2)*8: lanes, count, pos) plus merging it
    ((3L+10)*8, as counting a chunk slot)."""
    L = ln.num_lanes(k)
    return RESIDENT_SLACK * ((L + 2) * 8 + (3 * L + 10) * 8)


def resident_slots(k: int, budget_bytes: int) -> int:
    """Distinct k-mers the counter may hold resident in three quarters of
    budget_bytes (the other quarter buys the chunk)."""
    return (budget_bytes - budget_bytes // 4) // resident_slot_bytes(k)


@dataclass
class EngineConfig:
    k: int = 31
    abundance_min: int = 2
    abundance_max: int = 2**31 - 1
    block_reads: int = 4096
    max_len: int = 512
    histo_max: int = 10000
    # occurrence slots counted per chunk (rounded up to a power of two
    # covering one block); the counted output does not depend on it
    chunk_kmers: int = MAX_CHUNK
    # distinct k-mers held resident before counting goes multi-pass over
    # key ranges; 0 = resident_slots of the device's memory
    resident_kmers: int = 0
    # multi-pass staging of a one-shot block iterator: host RAM, or a
    # memmap file under spill_dir bounded by max_disk_mb (0 = unbounded)
    spill_dir: Optional[str] = None
    max_disk_mb: int = 0
    # estimate of the total k-mer occurrences (from the input's size);
    # sharpens the first pass's choice of range count (0 = unknown)
    est_total_occ: int = 0
    # multi-pass device block cache (MB): the first pass keeps each
    # block's device words and lengths while they fit, and later passes
    # replay them instead of re-reading the input (0 = off)
    dev_block_cache_mb: int = 512


def configure_chunk(cfg: EngineConfig, max_memory_mb: int, device) -> int:
    """Size the counting chunk and the resident budget from a device
    memory budget: ``-max-memory`` M MiB when M > 0, else the device's
    memory (device_bytes).

    Under ``-max-memory`` the device block cache is reserved first, as
    bcalm_tpu.engine.configure_chunk reserves it: at most a quarter of the
    budget, cfg.dev_block_cache_mb shrunk to fit.  Of the rest, a quarter
    buys chunk slots (chunk_slot_bytes, a power of two in [MIN_CHUNK,
    MAX_CHUNK]); three quarters buy resident slots (resident_slots).  The
    resident budget holds at least two chunks (a chunk's distinct run must
    fit): the chunk shrinks to keep that floor inside the budget.  Below
    MIN_CHUNK the budget cannot be met and the floor wins.  Returns
    cfg.chunk_kmers."""
    if max_memory_mb > 0:
        budget = max_memory_mb << 20
        if cfg.dev_block_cache_mb * 1_000_000 > budget // 4:
            cfg.dev_block_cache_mb = (budget // 4) // 1_000_000
        budget -= int(cfg.dev_block_cache_mb * 1_000_000)
    else:
        budget = device_bytes(device)
    res = resident_slots(cfg.k, budget)
    chunk = MAX_CHUNK
    while chunk > MIN_CHUNK and (chunk * chunk_slot_bytes(cfg.k) > budget // 4
                                 or 2 * chunk > res):
        chunk //= 2
    cfg.chunk_kmers = chunk
    cfg.resident_kmers = max(2 * chunk, res)
    return chunk


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
    # -only-uf: the chain decomposition in JAX's numpy dtypes, for the
    # store's chains.npz (convert.chain_info_to_numpy)
    chain_info: Optional[Dict] = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _merge_runs(runs):
    """Weighted merge of counted (unique, counts, minpos) runs into one."""
    lanes = torch.cat([r[0] for r in runs], dim=1)
    weights = torch.cat([r[1] for r in runs])
    pos = torch.cat([r[2] for r in runs])
    unique, counts, minpos, n = count_op.count_canonical(lanes, weights, pos)
    return _exact(unique, counts, minpos, int(n))


def _exact(unique, counts, minpos, n: int):
    """Exact-size copies of a run's first n columns, so that the wider
    source can be released."""
    if n == unique.shape[1]:
        return unique, counts, minpos
    return unique[:, :n].clone(), counts[:n].clone(), minpos[:n].clone()


class _BlockCache:
    """Staging for multi-pass re-reads of a one-shot block iterator: host
    RAM, or a memmap-backed file under spill_dir (the ``-max-disk``
    staging).  max_disk_mb bounds the staging file (0 = unbounded)."""

    def __init__(self, spill_dir: Optional[str] = None, max_disk_mb: int = 0):
        self.spill_dir = spill_dir
        self.max_disk_mb = max_disk_mb
        self._mem: list = []
        self._meta: list = []       # (B, W, offset) per block
        self._file = None
        self._path = None
        self._bytes = 0

    def add(self, words: np.ndarray, lengths: np.ndarray):
        if self.spill_dir is None:
            self._mem.append((words, lengths))
            return
        if self._file is None:
            os.makedirs(self.spill_dir, exist_ok=True)
            fd, self._path = tempfile.mkstemp(suffix=".blocks",
                                              dir=self.spill_dir)
            self._file = os.fdopen(fd, "wb")
        B, W = words.shape
        self._meta.append((B, W, self._bytes))
        data = (words.astype(np.uint32).tobytes()
                + lengths.astype(np.int32).tobytes())
        self._bytes += len(data)
        if self.max_disk_mb and self._bytes > self.max_disk_mb * 1_000_000:
            raise RuntimeError(
                f"-max-disk exceeded: block staging needs "
                f">{self._bytes >> 20} MB (limit {self.max_disk_mb} MB)")
        self._file.write(data)

    def blocks(self) -> Iterator[packing.ReadBlock]:
        if self.spill_dir is None:
            for words, lengths in self._mem:
                yield packing.ReadBlock(words, lengths)
            return
        self._file.flush()
        mm = np.memmap(self._path, dtype=np.uint8, mode="r")
        for B, W, off in self._meta:
            nw = B * W * 4
            words = np.frombuffer(mm, np.uint32, count=B * W,
                                  offset=off).reshape(B, W)
            lengths = np.frombuffer(mm, np.int32, count=B, offset=off + nw)
            yield packing.ReadBlock(words, lengths)

    def close(self):
        if self._file is not None:
            self._file.close()
            try:
                os.unlink(self._path)
            except OSError:
                pass
            self._file = None


def _solve_G(m: float, t: float) -> float:
    """Effective key-universe size from m distinct at t occurrences:
    solve m = G*(1 - exp(-t/G)) ((1-e^-x)/x = m/t, decreasing in x)."""
    ratio = m / t
    lo_x, hi_x = 1e-6, 50.0
    for _ in range(60):
        mid = 0.5 * (lo_x + hi_x)
        if (1.0 - np.exp(-mid)) / mid > ratio:
            lo_x = mid
        else:
            hi_x = mid
    return t / (0.5 * (lo_x + hi_x))


class _Fetch:
    """A stacked (L+2, n) table (lanes, counts, minpos rows: a finished key
    range, or the store's compacted solid set) on its way to the host.  On
    a card: one copy into pinned memory, asynchronous, completed by an
    event; the device source lives until materialize()."""

    def __init__(self, stacked: torch.Tensor):
        self.L = stacked.shape[0] - 2
        self.event = None
        self.src = None
        self.triple = None
        if stacked.is_cuda:
            self.src = stacked
            self.host = torch.empty(stacked.shape, dtype=torch.int64,
                                    pin_memory=True)
            self.host.copy_(stacked, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = stacked

    def materialize(self):
        """(lanes u32 (L, n), counts int32 (n,), pos u32 (n,)) in numpy."""
        if self.triple is None:
            if self.event is not None:
                self.event.synchronize()
            arr = self.host.numpy()
            L = self.L
            self.triple = (arr[:L].astype(np.uint32),
                           np.minimum(arr[L], 2**31 - 1).astype(np.int32),
                           arr[L + 1].astype(np.uint32))
            self.src = self.host = self.event = None
        return self.triple


def _cap(n: int) -> int:
    """The JAX package's power-of-two capacity of an n-column run: the
    unit of its resident-slot accounting, which split_current_range's
    memory trigger reads."""
    return runchains.round_capacity(max(1, n))


class _RangeCounter:
    """State of count_blocks: the chunk buffer, the settled runs of the
    current key range, and the multi-pass range machinery.  Method names
    follow the nested functions of bcalm_tpu.engine.count_blocks."""

    def __init__(self, cfg: EngineConfig, device, use_cache: bool):
        self.cfg = cfg
        self.device = device
        self.L = ln.num_lanes(cfg.k)
        self.resident_kmers = (cfg.resident_kmers
                               or resident_slots(cfg.k, device_bytes(device)))
        self.buf = None         # (L+1, cap + block_F): lanes + pos row
        self.cap = 0            # power-of-two counting capacity
        self.block_F = 0        # slots per block (fixed block geometry)
        self.fill = 0
        # buf[:, :fill] holds columns K1 wrote under a wider key range than
        # the current one (flush)
        self.owed = False
        self.slot_base = 0      # stream slot counter (first-occurrence keys)
        self.partials: list = []  # (unique, counts, minpos, n, generation)
        self.pending = None     # last chunk: (unique, counts, minpos, n, occ)
        self.resident_slots = 0  # sum of _cap(n) over partials
        self.n_reads = self.n_bases = self.n_occ = 0
        self.lo = (0,) * self.L
        self.hi = (ln.SENTINEL,) * self.L
        self.range_stack: list = []   # pending (lo, hi), ascending on pop
        self.results: List[_Fetch] = []
        self.cache = (_BlockCache(cfg.spill_dir, cfg.max_disk_mb)
                      if use_cache else None)
        # the device block cache (bcalm_tpu.engine.count_blocks' dev_cache):
        # (words, lengths, F, occ) of every block of the first pass while
        # their device bytes stay within cfg.dev_block_cache_mb, dropped
        # whole when they do not; later passes replay it
        self.block_cache: list = []
        self.block_cache_bytes = 0
        self.block_cache_ok = cfg.dev_block_cache_mb > 0
        self.pass_no = 0
        self.did_split = False
        # a split happened since the last settle: the pending chunk was
        # counted under the old hi and is cut again when it settles (else
        # its upper-half keys are counted twice)
        self.refilter_pending = False
        self.t_seen = 0           # in-range occurrences settled this pass
        self.pass_occ_seen = 0    # all occurrences streamed this pass
        self.total_occ_known = 0  # the stream's total, known after pass 1
        # saturation anchor of the current range: [exact distinct at the
        # last full merge, in-range occurrences then, learned dedup ratio]
        self.anchor = [0, 0, 1.0]
        self.tm = {"settle_wait": 0.0, "split": 0.0, "final_merge": 0.0,
                   "fetch_wait": 0.0, "passes": []}

    # ---- settled runs of the current range ----
    def resident_n(self) -> int:
        return sum(r[3] for r in self.partials)

    def _append(self, run, gen: int):
        n = run[0].shape[1]
        self.partials.append(run + (n, gen))
        self.resident_slots += _cap(n)

    def merge_generations(self):
        """LSM compaction: merge equal-generation runs as they appear, so
        residency tracks the distinct set."""
        p = self.partials
        while len(p) >= 2 and p[-1][4] == p[-2][4]:
            b, a = p.pop(), p.pop()
            self.resident_slots -= _cap(a[3]) + _cap(b[3])
            self._append(_merge_runs([a[:3], b[:3]]), a[4] + 1)

    def force_merge_all(self):
        """Merge all resident runs into one (the exact distinct so far)."""
        p = self.partials
        while len(p) > 1:
            b, a = p.pop(), p.pop()
            self.resident_slots -= _cap(a[3]) + _cap(b[3])
            self._append(_merge_runs([a[:3], b[:3]]), max(a[4], b[4]) + 1)

    def projected_distinct(self) -> int:
        """Duplicate-corrected estimate of the range's distinct count:
        m(t) = G*(1 - exp(-t/G)) anchored at the last exact merge, clamped
        to [m0, raw run sum]."""
        raw = self.resident_n()
        m0, t0 = self.anchor[0], self.anchor[1]
        if m0 <= 0 or self.t_seen <= t0:
            return raw
        if m0 >= 0.98 * t0:
            return raw
        G = _solve_G(m0, t0)
        m_proj = G * (1.0 - np.exp(-self.t_seen / G))
        return int(min(max(m_proj, m0), raw))

    def _bound(self, key) -> torch.Tensor:
        return torch.tensor(key, dtype=torch.int64,
                            device=self.device).reshape(self.L, 1)

    def split_current_range(self):
        """Partition the current key range when residency exceeds the
        budget (bcalm_tpu.engine.count_blocks.split_current_range: the
        triggers, the rarefaction projection of the range's final distinct
        count, and P-1 quantile pivots of the merged run).  The kept range
        narrows to [lo, first pivot); the others queue for later passes;
        every resident run is cut at the new hi (K6)."""
        cfg, tm, anchor = self.cfg, self.tm, self.anchor
        budget = max(self.resident_kmers, 2 * self.cap)
        if not self.partials:
            return
        raw = self.resident_n()
        m0 = anchor[0]
        est = m0 + 1.2 * anchor[2] * max(0, raw - m0)
        if (self.projected_distinct() <= 1.2 * budget
                and est <= 1.2 * budget
                and self.resident_slots <= 8 * budget):
            return
        t0 = time.time()
        self.force_merge_all()
        tm["split_merge"] = round(tm.get("split_merge", 0.0)
                                  + time.time() - t0, 3)
        tm["n_force_merges"] = tm.get("n_force_merges", 0) + 1
        m_new = self.resident_n()
        anchor[2] = float(np.clip((m_new - m0) / max(1, raw - m0), 0.02, 1.0))
        anchor[0] = m_new
        anchor[1] = self.t_seen
        if m_new <= 1.2 * budget:
            return
        tm["n_splits"] = tm.get("n_splits", 0) + 1
        m2 = m_new
        t2 = max(1, self.t_seen)
        total_est = (self.total_occ_known or cfg.est_total_occ
                     or 2 * self.pass_occ_seen)
        total_est = max(total_est, self.pass_occ_seen)
        t_final = t2 * (total_est / max(1, self.pass_occ_seen))
        if m2 >= 0.98 * t2:
            d_est = t_final
        else:
            G = _solve_G(m2, t2)
            d_est = G * (1.0 - np.exp(-t_final / G))
        P = int(np.ceil(d_est * 1.15 / budget))
        if P <= 1 and m2 <= budget:
            return
        P = max(2, min(256, P))
        u, _, _, n, _ = max(self.partials, key=lambda r: r[3])
        qidx = np.unique(np.asarray([(j * n) // P for j in range(1, P)],
                                    np.int64))
        qidx = qidx[(qidx > 0) & (qidx < n)]
        if qidx.size == 0:
            qidx = np.asarray([n // 2], np.int64)
        cols = u[:, torch.from_numpy(qidx).to(u.device)].cpu().numpy()
        pivots = []
        prev = self.lo
        for j in range(cols.shape[1]):
            cand = tuple(int(x) for x in cols[:, j])
            if prev < cand < self.hi:
                pivots.append(cand)
                prev = cand
        if not pivots:
            return
        self.did_split = True
        self.refilter_pending = True
        bounds = pivots + [self.hi]
        for i in reversed(range(len(pivots))):
            self.range_stack.append((bounds[i], bounds[i + 1]))
        self.hi = pivots[0]
        hi_t = self._bound(self.hi)
        runs, self.partials, self.resident_slots = self.partials, [], 0
        for ru, rc, rp, rn, gen in runs:
            n_new = int(count_op.lower_bound(ru, rn, hi_t)[0])
            self._append(_exact(ru, rc, rp, n_new), gen)
        # re-anchor on the kept range: its distinct is exact (one merged
        # run, just cut); t_seen rescales by the kept share
        anchor[0] = self.resident_n()
        self.t_seen = max(1, int(self.t_seen * anchor[0] / max(1, m2)))
        anchor[1] = self.t_seen
        anchor[2] = 1.0

    def settle_pending(self):
        """Settle the previous chunk's counted run, lagged by one chunk so
        that reading its size overlaps the next chunk's device work."""
        if self.pending is None:
            return
        unique, counts, minpos, n_dev, occ_dev = self.pending
        self.pending = None
        t0 = time.time()
        n_eff = int(n_dev)
        self.t_seen += int(occ_dev)
        self.tm["settle_wait"] += time.time() - t0
        if self.refilter_pending:
            n_eff = int(count_op.lower_bound(unique, n_eff,
                                             self._bound(self.hi))[0])
            self.refilter_pending = False
        self._append(_exact(unique, counts, minpos, n_eff), 0)
        self.merge_generations()
        t0 = time.time()
        self.split_current_range()
        self.tm["split"] += time.time() - t0

    # ---- the chunk buffer ----
    def range_active(self) -> bool:
        return self.lo != (0,) * self.L or self.hi != (ln.SENTINEL,) * self.L

    def flush(self):
        """Count the buffer's first min(fill, cap) columns (restricted to
        the key range when one is active), settle the previous chunk, and
        carry the columns past cap to the front.

        K1 folds the columns outside the range as it writes them, so a
        chunk is folded again (K5) only when it is owed: it holds columns
        carried past a split that narrowed the range after they were
        written.  Otherwise every column that is not the sentinel is in
        range, and the in-range occurrences are the counts' sum."""
        if self.fill == 0:
            return
        m = min(self.fill, self.cap)
        body = self.buf[:, :m]
        if self.owed:
            counted = count_op.count_chunk_ranged(body, self.lo, self.hi)
        else:
            unique, counts, minpos, n = count_op.count_canonical(
                body[:-1], pos=body[-1])
            counted = (unique, counts, minpos, n, counts.sum())
        written_under = self.hi
        self.settle_pending()
        self.pending = counted
        left = self.fill - m
        if left:
            self.buf[:, :left] = self.buf[:, self.cap:self.cap + left]
        self.fill = left
        # a split only narrows hi; lo changes between passes, on an empty
        # buffer
        self.owed = left > 0 and self.hi != written_under

    def insert(self, words, lengths, F: int, occ: int):
        cfg = self.cfg
        if self.buf is None or F != self.block_F:
            if self.buf is not None:   # geometry change: drain the buffer
                self.flush()
            self.block_F = F
            self.cap = runchains.round_capacity(max(cfg.chunk_kmers, F))
            self.buf = torch.empty((self.L + 1, self.cap + F),
                                   dtype=torch.int64, device=self.device)
            self.fill = 0
        self.pass_occ_seen += occ
        rng = ({"lo": self.lo, "hi": self.hi} if self.range_active()
               else {})
        extract_op.extract_insert(self.buf, words, lengths, cfg.k,
                                  self.slot_base & 0x7FFFFFFF, self.fill,
                                  **rng)
        self.slot_base += F
        self.fill += F
        if self.fill >= self.cap:
            self.flush()

    def upload(self, block_iter, first_pass: bool):
        """The blocks on the device, as (words, lengths, F, occ).  The
        first pass also counts the reads, stages the blocks of a one-shot
        iterator (_BlockCache) and fills the device block cache."""
        k = self.cfg.k
        limit = self.cfg.dev_block_cache_mb * 1_000_000
        for block in block_iter:
            if first_pass and self.cache is not None:
                self.cache.add(block.words, block.lengths)
            F = extract_op.block_slots(block.words.shape, k)
            lens = block.lengths.astype(np.int64)
            occ = int(np.maximum(0, lens - k + 1).sum())
            if first_pass:
                self.n_reads += int((lens > 0).sum())
                self.n_bases += int(lens.sum())
                self.n_occ += occ
            words = torch.from_numpy(block.words.astype(np.int64)).to(self.device)
            lengths = torch.from_numpy(lens).to(self.device)
            if first_pass and self.block_cache_ok:
                self.block_cache_bytes += (words.numel() * words.element_size()
                                           + lengths.numel() * lengths.element_size())
                if self.block_cache_bytes > limit:
                    self.block_cache.clear()
                    self.block_cache_ok = False
                else:
                    self.block_cache.append((words, lengths, F, occ))
            yield words, lengths, F, occ

    def run_pass(self, blocks):
        """Stream every block once.  slot_base restarts at 0, so every pass
        gives each occurrence the same first-occurrence key."""
        self.slot_base = self.fill = self.t_seen = self.pass_occ_seen = 0
        for words, lengths, F, occ in blocks:
            self.insert(words, lengths, F, occ)
        self.flush()

    def final_range_run(self):
        """Merge the range's runs into one exact-size (unique, counts,
        minpos); the merge takes at least two runs per step and otherwise
        stays within chunk_kmers columns."""
        if self.pending is not None and not self.partials:
            unique, counts, minpos, n_dev, _ = self.pending
            self.pending = None
            return _exact(unique, counts, minpos, int(n_dev))
        self.settle_pending()
        if not self.partials:
            e = torch.zeros((0,), dtype=torch.int64, device=self.device)
            return e.reshape(self.L, 0), e, e.clone()
        group = [r[:4] for r in self.partials]
        self.partials = []
        # the JAX counter leaves resident_slots at the finished range's
        # sum here, so its memory trigger over-counts in the next range
        # until a split recounts; the port starts each range from 0
        self.resident_slots = 0
        while len(group) > 1:
            take, rest, acc = [], [], 0
            for r in group:
                if len(take) >= 2 and acc + r[3] > self.cfg.chunk_kmers:
                    rest.append(r)
                else:
                    take.append(r)
                    acc += r[3]
            merged = _merge_runs([r[:3] for r in take])
            group = rest + [merged + (merged[0].shape[1],)]
        return group[0][:3]

    def stats(self) -> Dict:
        return {"reads": self.n_reads, "bases": self.n_bases,
                "kmer_occurrences": self.n_occ}

    def count(self, blocks: Iterable[packing.ReadBlock], reread):
        tm = self.tm
        block_iter = iter(blocks)
        try:
            while True:
                self.pass_no += 1
                first = self.pass_no == 1
                tp = time.time()
                if first:
                    self.run_pass(self.upload(block_iter, True))
                elif self.block_cache_ok and self.block_cache:
                    self.run_pass(self.block_cache)
                elif reread is not None:
                    self.run_pass(self.upload(reread(), False))
                else:
                    self.run_pass(self.upload(self.cache.blocks(), False))
                tm["passes"].append(round(time.time() - tp, 3))
                if self.device.type == "cuda":
                    tm.setdefault("hbm_mb", []).append(
                        torch.cuda.memory_allocated(self.device) >> 20)
                if first and not self.did_split and not self.range_stack:
                    # a count that never split replays nothing: the cache
                    # goes before the final merge allocates
                    self.block_cache = []
                    stats = self.stats()
                    if self.device.type == "cuda":
                        # the peak of pass 1 (the final merge's comes after)
                        stats["device_pass1_peak_mb"] = (
                            torch.cuda.max_memory_allocated(self.device) >> 20)
                    return self.final_range_run() + (stats,)
                t0 = time.time()
                unique, counts, minpos = self.final_range_run()
                tm["final_merge"] += time.time() - t0
                self.total_occ_known = self.n_occ
                # the previous range's copy had a whole pass to land:
                # completing it now keeps two fetches in flight at most
                t0 = time.time()
                if self.results:
                    self.results[-1].materialize()
                self.results.append(_Fetch(torch.cat(
                    [unique, counts[None], minpos[None]])))
                tm["fetch_wait"] += time.time() - t0
                del unique, counts, minpos
                if not self.range_stack:
                    break
                self.lo, self.hi = self.range_stack.pop()
                self.anchor = [0, 0, 1.0]
        finally:
            cached = self.block_cache_ok and bool(self.block_cache)
            self.block_cache = []     # release the device block cache
            if self.cache is not None:
                self.cache.close()
        # ranges are ascending: their concatenation is the sorted table
        t0 = time.time()
        triples = [f.materialize() for f in self.results]
        tm["fetch_wait"] += time.time() - t0
        lanes = np.concatenate([t[0] for t in triples], axis=1)
        counts = np.concatenate([t[1] for t in triples])
        pos = np.concatenate([t[2] for t in triples])
        for key in ("settle_wait", "split", "final_merge", "fetch_wait"):
            tm[key] = round(tm[key], 3)
        stats = self.stats()
        # the MB the device block cache held when it served the later
        # passes; 0 when they re-read the input (cache off or overflowed)
        stats.update(ooc_passes=self.pass_no, ooc_ranges=len(self.results),
                     ooc_block_cache_mb=(round(self.block_cache_bytes / 1e6, 3)
                                         if cached else 0.0),
                     timing=tm)
        return lanes, counts, pos, stats


def count_blocks(blocks: Iterable[packing.ReadBlock], cfg: EngineConfig,
                 device, reread=None):
    """Extract + count canonical k-mers over all blocks on one device.

    Blocks stream into a (L+1, chunk) buffer of k-mer lanes plus
    first-occurrence keys; each full chunk is counted into a sorted
    distinct run, and runs of equal generation merge as they appear (an
    LSM ladder), so residency tracks the distinct set.

    Out of core: when the distinct set outgrows the resident budget
    (cfg.resident_kmers), counting goes multi-pass over key ranges
    (bcalm_tpu.engine.count_blocks): the current range splits at quantile
    keys of its merged run, keeps the lowest part, and queues the rest
    for later passes.  Those replay the first pass's blocks from the
    device block cache when they fit in cfg.dev_block_cache_mb, else
    re-read the input through reread() when given, else from a
    _BlockCache; the cache is freed before count_blocks returns.  Each
    finished range is fetched to the host once, asynchronously, while the
    next pass runs.

    Returns (unique, counts, minpos, stats): the sorted distinct k-mers,
    their counts and min first-occurrence keys; device tensors of exact
    size when everything stayed resident, else numpy arrays (lanes u32
    (L, n), counts int32, pos u32) with stats "ooc_passes", "ooc_ranges",
    "ooc_block_cache_mb" and "timing"."""
    counter = _RangeCounter(cfg, torch.device(device), reread is None)
    return counter.count(blocks, reread)


def compact_solid_pos(solid, counts, minpos, n_solid: int, k: int):
    """Locality-ordered junction + chain stages on a sentinel-folded or
    zero-padded solid table (bcalm_tpu engine.compact_solid_pos): the
    reorder by first-occurrence key, junctions (K3), run scans (K8), run
    contraction (K12), the weighted jump (K17-K19 over 2*R_cap >=
    _HIER_MIN contracted nodes, K4 at its deepest level or alone; a level
    overflow reruns the plain doubling) and its finish (K10).  Returns
    (solid_r, counts_r, info): the reordered table (width C =
    round_capacity(n_solid)) that the chain arrays refer to."""
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
    R_cap = runchains.round_capacity(max(1, R))
    info = runchains.run_decompose(succ, n_solid, scan["is_head"], scan["rid"],
                                   scan["head_pos"], scan["end_pos"], R, R_cap)
    return solid_r, counts_r, info


def compact_solid(solid, n_solid: int, k: int):
    """Canonical-order junction + chain stages (bcalm_tpu engine
    compact_solid / _compact_solid_jit): junctions (K3) and the chain
    decomposition of all 2C oriented nodes, hierarchical for 2C >=
    _HIER_MIN (K17-K19, K4 at the deepest level; a level overflow reruns
    the plain doubling) or plain doubling (K4), and its finish (K10).
    solid: (L, C), columns >= n_solid ignored.  Returns (succ, info)."""
    C = solid.shape[1]
    succ = junctions_op.successor_arrays(solid, n_solid, k)
    oid = torch.arange(2 * C, device=solid.device)
    valid = torch.where(oid >= C, oid - C, oid) < n_solid
    return succ, chains_op.chain_decompose(succ, valid)


def _extract_fold(words: torch.Tensor, lengths: torch.Tensor, k: int,
                  slot_base: int = 0):
    """The per-block extract + canonical + sentinel fold front end
    (bcalm_tpu engine._extract_fold): K1 into a fresh (L+1, F) buffer at
    offset 0, F = extract.block_slots(words.shape, k); the last row holds
    the first-occurrence keys, clamped below the sentinel.  Returns
    (folded, the number of valid k-mer positions as a 0-d tensor)."""
    B, W = words.shape
    F = extract_op.block_slots((B, W), k)
    P_eff = F // max(1, B)
    folded = torch.empty((ln.num_lanes(k) + 1, F), dtype=torch.int64,
                         device=words.device)
    extract_op.extract_insert(folded, words, lengths, k, slot_base, 0)
    return folded, torch.clamp(lengths - k + 1, 0, P_eff).sum()


block_slots = extract_op.block_slots


def _start_kmer_codes(s_lanes: torch.Tensor, k: int) -> torch.Tensor:
    """(L, U) k-mer lanes -> (k, U) base codes, first base first."""
    r = ln.top_lane_bases(k)
    j = torch.arange(k, device=s_lanes.device)
    t = j - r
    lane = torch.where(j < r, 0, 1 + torch.div(t, 16, rounding_mode="floor"))
    shift = torch.where(j < r, 2 * (r - 1 - j), 2 * (15 - torch.remainder(t, 16)))
    return (s_lanes[lane] >> shift[:, None]) & 3


def spell_unitigs_plain(solid, counts, uid, rank, length, start_oid,
                        n_unitigs: int, k: int, n_members: int):
    """Plain version of K11 (bcalm_tpu engine._assemble_dev): every member
    oriented k-mer writes its last base at offset(uid) + k-1 + rank and
    its count at run_start(uid) + rank, then each unitig's start k-mer
    writes its k bases at offset(uid), where run_start is the exclusive
    prefix of the lengths and offset(u) = run_start(u) + (k-1) u.  Returns
    (codes u8 (n_members + (k-1) U,), member-ordered counts (n_members,))."""
    C = solid.shape[1]
    dev = solid.device
    U = n_unitigs
    len_u = length[:U]
    run_start = torch.cumsum(len_u, 0) - len_u
    offsets = run_start + (k - 1) * torch.arange(U, device=dev)
    total = n_members + (k - 1) * U
    codes = torch.zeros((total,), dtype=torch.uint8, device=dev)
    mcounts = torch.zeros((n_members,), dtype=torch.int64, device=dev)

    m_oid = torch.nonzero((uid >= 0) & (uid < U)).flatten()
    v = torch.where(m_oid >= C, m_oid - C, m_oid)
    r = ln.top_lane_bases(k)
    first_b = (solid[0, v] >> (2 * (r - 1))) & 3
    last_b = torch.where(m_oid >= C, first_b ^ 2, solid[-1, v] & 3)
    m_uid, m_rank = uid[m_oid], rank[m_oid]
    m = run_start[m_uid] + m_rank
    d = offsets[m_uid] + (k - 1) + m_rank
    ok = (d >= 0) & (d < total)
    codes[d[ok]] = last_b[ok].to(torch.uint8)
    ok = (m >= 0) & (m < n_members)
    mcounts[m[ok]] = counts[v[ok]]

    so = start_oid[:U]
    sv = torch.clamp(torch.where(so >= C, so - C, so), 0, C - 1)
    fwd = _start_kmer_codes(solid[:, sv], k)
    start_codes = torch.where((so >= C)[None], (fwd ^ 2).flip(0), fwd)
    dest = (offsets[None, :] + torch.arange(k, device=dev)[:, None]).flatten()
    ok = (dest >= 0) & (dest < total)
    codes[dest[ok]] = start_codes.flatten()[ok].to(torch.uint8)
    return codes, mcounts


def spell_unitigs(solid, counts, uid, rank, length, start_oid, n_unitigs: int,
                  k: int, n_members: int):
    """K11 entry: kernel for CUDA tensors, plain version for CPU tensors."""
    if solid.device.type == "cpu":
        return spell_unitigs_plain(solid, counts, uid, rank, length, start_oid,
                                   n_unitigs, k, n_members)
    return _kernels.spell_unitigs(solid, counts, uid, rank, length, start_oid,
                                  n_unitigs, k, n_members)


def assemble_unitigs_device(solid, counts, info, k: int, n_unitigs: int,
                            n_solid: int):
    """Spelling on the device (K11), then host string slicing: (seqs, kc,
    abundances, circular).  A unitig set of n_solid members spells
    n_solid + (k-1) U bases."""
    if n_unitigs == 0:
        return [], np.zeros(0, np.int64), [], np.zeros(0, bool)
    codes_d, counts_d = spell_unitigs(solid, counts, info["uid"], info["rank"],
                                      info["length"], info["start_oid"],
                                      n_unitigs, k, n_solid)
    codes = codes_d.cpu().numpy()
    mcounts = counts_d.cpu().numpy().astype(np.int64)
    length = info["length"][:n_unitigs].cpu().numpy()
    circular = info["circular"][:n_unitigs].cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(length + (k - 1))])
    ascii_all = dna.CODE_TO_ASCII[codes[:offsets[-1]]].tobytes()
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


def _empty_set(cfg: EngineConfig, histo, stats: Dict) -> UnitigSet:
    return UnitigSet(k=cfg.k, seqs=[], kc=np.zeros(0, np.int64),
                     abundances=[], circular=np.zeros(0, bool),
                     histogram=histo, stats=stats)


def _finish_build(solid_r, counts_r, info, n_solid: int, cfg: EngineConfig,
                  histo, stats: Dict, only_uf: bool = False,
                  uf_stats: bool = False) -> UnitigSet:
    """After compaction: the chain statistics (-uf-stats), the chain
    checkpoint of -only-uf, or assembly (K11) and links."""
    if uf_stats or only_uf:
        info_np = convert.chain_info_to_numpy(info)
        stats.update(chain_stats(info_np, n_solid))
    if only_uf:
        us = _empty_set(cfg, histo, stats)
        us.chain_info = info_np
        return us
    t1 = time.time()
    seqs, kc, abund, circular = assemble_unitigs_device(
        solid_r, counts_r, info, cfg.k, int(info["n_unitigs"]), n_solid)
    links = link_join(seqs, cfg.k)
    stats["t_assemble_s"] = round(time.time() - t1, 2)
    stats["unitigs"] = len(seqs)
    return UnitigSet(k=cfg.k, seqs=seqs, kc=kc, abundances=abund,
                     circular=circular, links=links, histogram=histo,
                     stats=stats)


def compact_from_counts(solid_np: np.ndarray, counts_np: np.ndarray,
                        cfg: EngineConfig, device, only_uf: bool = False,
                        uf_stats: bool = False,
                        chain_info: Optional[Dict] = None,
                        minpos_np: Optional[np.ndarray] = None) -> UnitigSet:
    """Compaction + assembly + links from a host solid table (lanes u32
    (L, n), counts; bcalm_tpu.engine.compact_from_counts): the multi-pass
    count's last step and the resume entry point.

    The table is padded with zeros to round_capacity(n) columns, as JAX
    pads it.  With first-occurrence keys (minpos_np) it compacts on the
    locality-ordered path (compact_solid_pos), else on the canonical-order
    path (compact_solid).  chain_info: a chain checkpoint (-skip-bglue)
    for exactly this solid set, in JAX's numpy form; with minpos the
    (deterministic) reorder is re-derived and the decompose skipped.  A
    checkpoint of another size raises ValueError.  only_uf / uf_stats as
    in build_from_blocks."""
    device = torch.device(device)
    n_solid = int(solid_np.shape[1])
    stats = {"solid_kmers": n_solid,
             "solid_kmer_abundance": int(np.asarray(counts_np).sum(dtype=np.int64))}
    if n_solid == 0:
        return _empty_set(cfg, None, stats)
    cap = runchains.round_capacity(n_solid)
    L = solid_np.shape[0]
    solid = torch.zeros((L, cap), dtype=torch.int64, device=device)
    solid[:, :n_solid] = convert.lanes_from_numpy(solid_np, device)
    counts = torch.zeros((cap,), dtype=torch.int64, device=device)
    counts[:n_solid] = convert.counts_from_numpy(counts_np, device)
    minpos = None
    if minpos_np is not None:
        minpos = torch.full((cap,), ln.SENTINEL, dtype=torch.int64,
                            device=device)
        minpos[:n_solid] = convert.pos_from_numpy(minpos_np, device)
    t1 = time.time()
    if chain_info is not None:
        if np.asarray(chain_info["uid"]).shape[0] != 2 * cap:
            raise ValueError("chain checkpoint is stale (solid set size "
                             "changed); rerun without -skip-bglue")
        if minpos is not None:
            solid, counts = runchains.reorder_by_pos(solid, counts, minpos,
                                                     cfg.k)
        info = convert.chain_info_from_numpy(chain_info, device)
    elif minpos is not None:
        solid, counts, info = compact_solid_pos(solid, counts, minpos,
                                                n_solid, cfg.k)
    else:
        _, info = compact_solid(solid, n_solid, cfg.k)
    _sync(device)
    stats["t_compact_s"] = round(time.time() - t1, 2)
    us = _finish_build(solid, counts, info, n_solid, cfg, None, stats,
                       only_uf, uf_stats)
    if device.type == "cuda":
        us.stats["device_peak_mb"] = torch.cuda.max_memory_allocated(device) >> 20
    return us


def _host_solidity(unique: np.ndarray, counts: np.ndarray, cfg: EngineConfig,
                   auto_amin_cap: Optional[int] = None):
    """Histogram and solidity mask of a host distinct table (numpy); with
    auto_amin_cap, cfg.abundance_min is first chosen from the histogram."""
    histo = np.bincount(np.minimum(counts, cfg.histo_max),
                        minlength=cfg.histo_max + 1).astype(np.int32)
    if auto_amin_cap is not None:
        cfg.abundance_min = auto_abundance_min(histo, auto_amin_cap)
    keep = (counts >= cfg.abundance_min) & (counts <= cfg.abundance_max)
    return histo, keep


def build_from_blocks(blocks: Iterable[packing.ReadBlock], cfg: EngineConfig,
                      device, reread=None, store=None,
                      auto_amin_cap: Optional[int] = None,
                      only_uf: bool = False, uf_stats: bool = False,
                      solidity_kind: str = "sum") -> UnitigSet:
    """End-to-end build from packed read blocks.  reread: a callable that
    yields the same blocks again, for the passes of a multi-pass count
    (else the first pass stages them in a _BlockCache).

    A resident count stays on the device through the solidity fold (K7)
    and compaction; a multi-pass count's host table gets its histogram
    and solidity mask in numpy and compacts through compact_from_counts.

    store (bcalm_tpu.storage.store.Store): the solid k-mers, their counts
    and first-occurrence keys and the histogram are checkpointed for
    ``-skip-bcalm``, in JAX's dtypes.  On the resident path K9 compacts
    the solid set on the device and one pinned asynchronous copy brings it
    to the host while compaction runs; a multi-pass count writes its host
    table.  auto_amin_cap: choose cfg.abundance_min from the histogram
    (``-abundance-min auto``).  only_uf / uf_stats: stop after the chain
    decomposition, keeping it in UnitigSet.chain_info / add chain
    statistics (bcalm_tpu's glue debug flags).

    On a card, stats carry device_count_peak_mb (the peak through
    counting) and device_peak_mb (through the whole build).  On the
    multi-pass path with a store, the device's running out of memory in
    compaction raises CompactionOOM: the solid set is checkpointed, and
    ``-skip-bcalm`` in a fresh process resumes from it (cli.main does)."""
    device = torch.device(device)
    if device.type == "cuda":
        # the allocator's statistics exist once CUDA is initialised; a
        # build that is the process's first CUDA call initialises it here
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    unique, counts, minpos, stats = count_blocks(blocks, cfg, device, reread)
    _sync(device)
    stats["t_count_s"] = round(time.time() - t0, 2)
    if device.type == "cuda":
        stats["device_count_peak_mb"] = torch.cuda.max_memory_allocated(device) >> 20

    def write_store(solid_np, counts_np, minpos_np, histo):
        if store is not None:
            store.write_counts(
                solid_np, counts_np, cfg.k, histogram=histo, minpos=minpos_np,
                config={"abundance_min": cfg.abundance_min,
                        "abundance_max": cfg.abundance_max,
                        "solidity_kind": solidity_kind})

    if isinstance(unique, np.ndarray):
        histo, keep = _host_solidity(unique, counts, cfg, auto_amin_cap)
        stats["distinct_kmers"] = int(counts.shape[0])
        write_store(unique[:, keep], counts[keep], minpos[keep], histo)
        try:
            us = compact_from_counts(unique[:, keep], counts[keep], cfg,
                                     device, only_uf=only_uf,
                                     uf_stats=uf_stats, minpos_np=minpos[keep])
        except Exception as e:  # noqa: BLE001 — classify the allocator's death
            # after a long multi-pass count a fresh process compacts the
            # checkpointed solid set on a clean allocator
            if store is not None and _is_resource_exhausted(e):
                raise CompactionOOM(
                    f"device allocator exhausted during compaction "
                    f"({type(e).__name__}); the counted solid set is "
                    f"checkpointed — resume with -skip-bcalm in a fresh "
                    f"process") from e
            raise
        us.histogram = histo
        us.stats.update(stats)
    else:
        n_u = unique.shape[1]
        amax = cfg.abundance_max
        if auto_amin_cap is not None:
            # the cutoff depends on the histogram: read it first
            histo = count_op.solid_fold_histogram(
                unique, counts, minpos, n_u, 1, amax, cfg.histo_max)[4]
            cfg.abundance_min = auto_abundance_min(histo.cpu().numpy(),
                                                   auto_amin_cap)
        solid, counts_s, pos_s, n_solid_t, histo = count_op.solid_fold_histogram(
            unique, counts, minpos, n_u, cfg.abundance_min, amax, cfg.histo_max)
        n_solid = int(n_solid_t[0])
        histo = histo.cpu().numpy().astype(np.int32)
        stats["distinct_kmers"] = n_u
        stats["solid_kmers"] = n_solid
        stats["solid_kmer_abundance"] = int(counts_s.sum())
        fetch = None
        if store is not None:
            # the checkpoint needs the solid set compacted in canonical
            # order (the fold leaves it scattered): K9, then one copy
            # that rides behind compaction
            stacked, _ = count_op.solid_compact(unique, counts, minpos, n_u,
                                                cfg.abundance_min, amax,
                                                width=n_solid)
            fetch = _Fetch(stacked)
            del stacked
        if n_solid:
            t1 = time.time()
            solid_r, counts_r, info = compact_solid_pos(solid, counts_s, pos_s,
                                                        n_solid, cfg.k)
            _sync(device)
            stats["t_compact_s"] = round(time.time() - t1, 2)
        if fetch is not None:
            t1 = time.time()
            write_store(*fetch.materialize(), histo)
            stats["t_store_s"] = round(time.time() - t1, 2)
        us = (_finish_build(solid_r, counts_r, info, n_solid, cfg, histo,
                            stats, only_uf, uf_stats)
              if n_solid else _empty_set(cfg, histo, stats))
    if device.type == "cuda":
        us.stats["device_peak_mb"] = torch.cuda.max_memory_allocated(device) >> 20
    return us


def count_and_filter(blocks: Iterable[packing.ReadBlock], cfg: EngineConfig,
                     device, reread=None):
    """Counting phase -> host arrays: (solid lanes u32 (L, n), counts
    int32, minpos u32, histogram int32, stats), the histogram and the
    solidity filter in numpy (bcalm_tpu.engine.count_and_filter)."""
    unique, counts, minpos, stats = count_blocks(blocks, cfg, device, reread)
    if not isinstance(unique, np.ndarray):
        unique = convert.lanes_to_numpy(unique)
        counts = convert.counts_to_numpy(counts)
        minpos = convert.pos_to_numpy(minpos)
    histo, keep = _host_solidity(unique, counts, cfg)
    stats["distinct_kmers"] = int(counts.shape[0])
    stats["solid_kmers"] = int(keep.sum())
    return unique[:, keep], counts[keep], minpos[keep], histo, stats


def combine_sample_counts(runs, kind: str = "sum", k: Optional[int] = None):
    """Combine per-sample distinct (lanes u32 (L, n_i), counts int32) runs
    under a solidity kind (numpy; bcalm_tpu.engine.combine_sample_counts):
    sum = total over samples, min = 0 unless present in every sample,
    else the least count, max = best count.  Returns (lanes (L, n) sorted,
    counts int32)."""
    runs = [r for r in runs if r[0].shape[1] > 0]
    if not runs:
        L = ln.num_lanes(k) if k is not None else 1
        return np.zeros((L, 0), np.uint32), np.zeros((0,), np.int32)
    n_samples = len(runs)
    lanes = np.concatenate([r[0] for r in runs], axis=1)
    counts = np.concatenate([r[1] for r in runs])
    L = lanes.shape[0]
    order = np.lexsort(tuple(lanes[j] for j in reversed(range(L))))
    lanes = lanes[:, order]
    counts = counts[order]
    first = np.ones(lanes.shape[1], bool)
    if lanes.shape[1] > 1:
        first[1:] = np.any(lanes[:, 1:] != lanes[:, :-1], axis=0)
    starts = np.nonzero(first)[0]
    sizes = np.diff(np.concatenate([starts, [lanes.shape[1]]]))
    if kind == "sum":
        agg = np.add.reduceat(counts.astype(np.int64), starts)
    elif kind == "max":
        agg = np.maximum.reduceat(counts, starts).astype(np.int64)
    elif kind == "min":
        agg = np.minimum.reduceat(counts, starts).astype(np.int64)
        agg = np.where(sizes < n_samples, 0, agg)
    else:
        raise ValueError(f"unknown solidity kind: {kind}")
    return lanes[:, starts], np.minimum(agg, 2**31 - 1).astype(np.int32)


def auto_abundance_min(histogram: np.ndarray, cap: int = 20) -> int:
    """The abundance cutoff of ``-abundance-min auto`` (numpy;
    bcalm_tpu.engine.auto_abundance_min): the first valley of the
    histogram after count 1, capped by ``-abundance-min-threshold``."""
    h = np.asarray(histogram, np.int64)
    if h.size < 4:
        return 2
    for i in range(2, min(h.size - 1, cap + 1)):
        if h[i] <= h[i - 1] and h[i] <= h[i + 1]:
            return max(2, min(i, cap))
    return 2 if cap >= 2 else max(1, cap)


def chain_stats(info: Dict, n_solid: int) -> Dict:
    """Chain-decomposition statistics of a numpy chain dict (``-uf-stats``;
    bcalm_tpu.engine.chain_stats)."""
    n_unitigs = int(info["n_unitigs"])
    length = np.asarray(info["length"])[:n_unitigs].astype(np.int64)
    circular = np.asarray(info["circular"])[:n_unitigs]
    return {
        "uf_classes": n_unitigs,
        "uf_nodes": int(n_solid),
        "uf_singletons": int((length == 1).sum()),
        "uf_largest_class": int(length.max()) if n_unitigs else 0,
        "uf_mean_class": float(length.mean()) if n_unitigs else 0.0,
        "uf_circular_classes": int(circular.sum()),
    }


def build_from_seqs(seqs: Iterable[str], cfg: EngineConfig,
                    device) -> UnitigSet:
    """build_from_blocks over the packed blocks of `seqs` (a multi-pass
    count stages them in a _BlockCache)."""
    blocks = packing.iter_blocks(seqs, cfg.k, block_reads=cfg.block_reads,
                                 max_len=cfg.max_len)
    return build_from_blocks(blocks, cfg, device)
