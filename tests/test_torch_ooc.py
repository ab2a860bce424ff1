"""Out-of-core multi-pass counting of bcalm_tpu_torch vs bcalm_tpu.

The counting scenarios of tests/test_ooc_count.py run through both
engines with the same seeds and tiny chunk and resident budgets, so the
multi-pass path engages: the host tables (lanes, counts, first-occurrence
keys) must be exactly equal and both must count in the same number of
passes.  The port's plain versions of K5-K8 are held against the JAX
programs they replace on seeded inputs, and configure_chunk against its
contract.  All values are integers: exact equality.  The multi-pass
builds and the command line are in tests/test_torch_ooc_build.py.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bcalm_tpu import engine as jengine
from bcalm_tpu.io import packing
from bcalm_tpu.ops import count as jcount
from bcalm_tpu.ops import runchains as jrun
from bcalm_tpu_torch import convert
from bcalm_tpu_torch import engine as tengine
from bcalm_tpu_torch.ops import count as tcount
from bcalm_tpu_torch.ops import runchains as trun
from tests.test_ooc_count import _reads

SENT = 0xFFFFFFFF


def configs(k, chunk=512, resident=1024, block_reads=16, max_len=64, amin=1):
    """The same configuration for both engines."""
    kw = dict(k=k, abundance_min=amin, block_reads=block_reads,
              max_len=max_len, chunk_kmers=chunk, resident_kmers=resident)
    return jengine.EngineConfig(**kw), tengine.EngineConfig(**kw)


def blocks_of(reads, cfg):
    return packing.iter_blocks(reads, cfg.k, block_reads=cfg.block_reads,
                               max_len=cfg.max_len)


def assert_same_tables(jout, tout):
    ju, jc, jp, jn, jstats = jout
    tu, tc, tp, tstats = tout
    assert isinstance(ju, np.ndarray) and isinstance(tu, np.ndarray)
    assert tu.shape[1] == jn
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tp, jp)
    for key in ("reads", "bases", "kmer_occurrences"):
        assert tstats[key] == jstats[key]
    assert jstats["ooc_passes"] > 1 and tstats["ooc_passes"] > 1
    assert tstats["ooc_passes"] == jstats["ooc_passes"]
    assert tstats["ooc_ranges"] == jstats["ooc_ranges"]
    return tstats


# the scenarios of tests/test_ooc_count.py: (reads seed, genome length,
# read length, step, copies, k, chunk, resident)
SCENARIOS = {
    "spill_path": (11, 4000, 60, 3, 2, 21, 512, 1024),
    "pass_count": (23, 6000, 60, 2, 3, 21, 512, 2048),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_multipass_tables_equal_jax(name):
    seed, glen, rlen, step, copies, k, chunk, resident = SCENARIOS[name]
    reads = _reads(seed, glen, rlen, step, copies)
    jcfg, tcfg = configs(k, chunk, resident)
    tout = tengine.count_blocks(blocks_of(reads, tcfg), tcfg, "cpu")
    tstats = assert_same_tables(
        jengine.count_blocks(blocks_of(reads, jcfg), jcfg), tout)
    if name == "pass_count":   # near ceil(distinct / budget) passes
        assert tstats["ooc_passes"] <= -(-tout[0].shape[1] // resident) + 2


# a split while the chunk buffer holds columns carried past cap: K1 wrote
# them under the wider range, so the next chunk is owed a K5 fold; every
# scenario splits so at least twice.  (reads seed, genome length, read
# length, step, copies, k, chunk, resident, block reads)
SPLIT_CARRY = {
    "k13": (41, 3000, 50, 2, 2, 13, 256, 512, 8),
    "k31": (31, 5000, 60, 3, 2, 31, 512, 1024, 16),
    "k31_small_chunk": (37, 5000, 64, 3, 2, 31, 256, 1024, 8),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CARRY))
def test_split_with_carry_folds_owed_chunks(name, monkeypatch):
    """K1 folds in range mode; K5 runs only on chunks owed a fold; no
    column outside the current range reaches a chunk count; the tables,
    passes, ranges and occurrences equal bcalm_tpu's."""
    seed, glen, rlen, step, copies, k, chunk, resident, br = SPLIT_CARRY[name]
    reads = _reads(seed, glen, rlen, step, copies)
    jcfg, tcfg = configs(k, chunk, resident, block_reads=br)
    counter = tengine._RangeCounter(tcfg, torch.device("cpu"), True)
    seen = {"folds": 0, "ranged_inserts": 0, "chunks": 0}
    count_canonical, range_fold = tcount.count_canonical, tcount.range_fold
    extract_insert = tengine.extract_op.extract_insert

    def checked_count(lanes, weights=None, pos=None):
        if weights is None:       # a chunk (merges carry weights)
            inside = (~tcount.lex_lt_plain(lanes, counter.lo)
                      & tcount.lex_lt_plain(lanes, counter.hi))
            assert bool((inside | ~tcount.column_valid(lanes)).all()), \
                "a column outside the key range reached count_canonical"
            seen["chunks"] += 1
        return count_canonical(lanes, weights, pos)

    def counted_fold(body, lo, hi):
        assert counter.owed
        seen["folds"] += 1
        return range_fold(body, lo, hi)

    def counted_insert(*args, **kw):
        assert ("lo" in kw) == counter.range_active()
        seen["ranged_inserts"] += "lo" in kw
        return extract_insert(*args, **kw)

    monkeypatch.setattr(tcount, "count_canonical", checked_count)
    monkeypatch.setattr(tcount, "range_fold", counted_fold)
    monkeypatch.setattr(tengine.extract_op, "extract_insert", counted_insert)
    tout = counter.count(blocks_of(reads, tcfg), None)
    assert seen["folds"] >= 2 and seen["ranged_inserts"] > 0
    assert seen["chunks"] > seen["folds"]
    tstats = assert_same_tables(
        jengine.count_blocks(blocks_of(reads, jcfg), jcfg), tout)
    assert tstats["kmer_occurrences"] == sum(
        max(0, len(r) - k + 1) for r in reads)


def test_multipass_reread_no_cache():
    reads = _reads(11, 4000, 60, 3)
    jcfg, tcfg = configs(21)

    def mk(cfg):
        return lambda: blocks_of(reads, cfg)

    assert_same_tables(
        jengine.count_blocks(mk(jcfg)(), jcfg, reread=mk(jcfg)),
        tengine.count_blocks(mk(tcfg)(), tcfg, "cpu", reread=mk(tcfg)))


def test_multipass_disk_staging(tmp_path):
    reads = _reads(13, 3000, 60, 3)
    jcfg, tcfg = configs(21)
    jcfg.spill_dir = str(tmp_path / "jax")
    tcfg.spill_dir = str(tmp_path / "torch")
    assert_same_tables(
        jengine.count_blocks(blocks_of(reads, jcfg), jcfg),
        tengine.count_blocks(blocks_of(reads, tcfg), tcfg, "cpu"))
    assert os.listdir(tmp_path / "torch") == []   # staging file removed


def test_max_disk_exceeded_raises(tmp_path):
    reads = _reads(17, 3000, 60, 3) * 40
    _, tcfg = configs(21, chunk=1 << 16, resident=1 << 20, block_reads=256)
    tcfg.spill_dir = str(tmp_path)
    tcfg.max_disk_mb = 1
    with pytest.raises(RuntimeError, match="max-disk"):
        tengine.count_blocks(blocks_of(reads, tcfg), tcfg, "cpu")
    assert os.listdir(tmp_path) == []


def test_spill_and_resident_filtered_tables_identical():
    reads = _reads(5, 1500, 50, 2)
    out = []
    for resident in (512, 1 << 30):
        jcfg, tcfg = configs(13, chunk=256, resident=resident, block_reads=8)
        got = tengine.count_and_filter(blocks_of(reads, tcfg), tcfg, "cpu")
        assert ("ooc_passes" in got[4]) == (resident == 512)
        if resident == 512:
            want = jengine.count_and_filter(blocks_of(reads, jcfg), jcfg)
            for g, w in zip(got[:4], want[:4]):
                np.testing.assert_array_equal(g, w)
            assert got[4]["ooc_passes"] == want[4]["ooc_passes"]
        out.append([g.tolist() for g in got[:4]])
    assert out[0] == out[1]


# ---- the plain versions of K5-K8 against the JAX programs ----

def random_body(L, n, seed):
    """(L+1, n) chunk body: L key lanes from a small pool (so bounds hit
    equal prefixes), a pos row, ~15% sentinel columns."""
    rng = np.random.RandomState(seed)
    pool = rng.randint(0, 4, size=(L, 6)).astype(np.uint32) * np.uint32(0x40000000)
    lanes = pool[np.arange(L)[:, None], rng.randint(0, 6, size=(L, n))]
    lanes += rng.randint(0, 3, size=(L, n)).astype(np.uint32)
    pos = rng.randint(0, 2**31, n).astype(np.uint32)
    body = np.concatenate([lanes, pos[None]])
    body[:, rng.rand(n) < 0.15] = SENT
    return body


def key_between(body, rng):
    L = body.shape[0] - 1
    return body[:L, rng.randint(0, body.shape[1])].copy()


@pytest.mark.parametrize("L", [1, 2, 3])
def test_range_fold_and_count_match_jax(L):
    rng = np.random.RandomState(L)
    body = random_body(L, 900, L)
    ranges = [(np.zeros(L, np.uint32), np.full(L, SENT, np.uint32))]
    for _ in range(4):
        a, b = key_between(body, rng), key_between(body, rng)
        if tuple(b) < tuple(a):
            a, b = b, a
        ranges.append((a, b))
    ranges.append((key_between(body, rng), np.full(L, SENT, np.uint32)))
    for lo, hi in ranges:
        ju, jc, jnw, jp = jengine._count_chunk_ranged(
            jnp.asarray(body), jnp.asarray(lo), jnp.asarray(hi))
        tb = convert.lanes_from_numpy(body, "cpu")
        folded = tb.clone()
        occ = tcount.range_fold_plain(folded, lo.tolist(), hi.tolist())
        keep = (~np.asarray(jengine._lex_lt(jnp.asarray(body[:L]), jnp.asarray(lo)))
                & np.asarray(jengine._lex_lt(jnp.asarray(body[:L]), jnp.asarray(hi))))
        np.testing.assert_array_equal(
            convert.lanes_to_numpy(folded), np.where(keep[None], body, SENT))
        tu, tc, tp, tn, tocc = tcount.count_chunk_ranged(tb, lo.tolist(),
                                                         hi.tolist())
        jn, jocc = (int(x) for x in np.asarray(jnw))
        assert int(occ[0]) == int(tocc) == jocc
        assert int(tn) == jn
        np.testing.assert_array_equal(convert.lanes_to_numpy(tu)[:, :jn],
                                      np.asarray(ju)[:, :jn])
        np.testing.assert_array_equal(convert.counts_to_numpy(tc)[:jn],
                                      np.asarray(jc)[:jn])
        np.testing.assert_array_equal(convert.pos_to_numpy(tp)[:jn],
                                      np.asarray(jp)[:jn])


@pytest.mark.parametrize("L", [1, 2, 4])
def test_lower_bound_matches_count_lt_and_settle_n(L):
    rng = np.random.RandomState(10 + L)
    body = random_body(L, 700, 10 + L)
    ju, _, jnw, _ = jengine._count_chunk_ranged(
        jnp.asarray(body), jnp.asarray(np.zeros(L, np.uint32)),
        jnp.asarray(np.full(L, SENT, np.uint32)))
    n = int(np.asarray(jnw)[0])
    run = convert.lanes_from_numpy(np.asarray(ju), "cpu")   # zero tail past n
    refolded = np.asarray(jengine._refold_tail(ju, jnp.asarray(n, jnp.int32)))
    bounds = [key_between(body, rng) for _ in range(5)]
    bounds += [np.zeros(L, np.uint32), np.full(L, SENT, np.uint32),
               np.asarray(ju)[:, n - 1]]
    B = convert.lanes_from_numpy(np.stack(bounds, axis=1), "cpu")
    got = tcount.lower_bound_plain(run, n, B).tolist()
    for j, b in enumerate(bounds):
        bj = jnp.asarray(b)
        assert got[j] == int(jengine._count_lt(jnp.asarray(refolded), bj))
        assert got[j] == int(jengine._settle_n(ju, jnp.asarray(n, jnp.int32), bj))
    for m in (0, 1, n // 3):   # the search range is the given n
        sub = tcount.lower_bound_plain(run, m, B).tolist()
        assert sub == [int(jengine._settle_n(ju, jnp.asarray(m, jnp.int32),
                                             jnp.asarray(b))) for b in bounds]


def dup_run(L, n, seed):
    """(L, n) u32 keys sorted over all n columns, from a pool of n // 40 so
    that stretches of ~40 equal keys are common; the first lanes small,
    so keys often differ only in their last lanes."""
    rng = np.random.RandomState(seed)
    pool = rng.randint(0, 2**32, size=(L, n // 40), dtype=np.uint64)
    pool[:L // 2] &= 3
    keys = pool[:, rng.randint(0, n // 40, n)].astype(np.uint32)
    return np.ascontiguousarray(keys[:, np.lexsort(keys[::-1])])


@pytest.mark.parametrize("L", [9, 16, 32])
@pytest.mark.parametrize("n_of", ["all", "one", "none"])
def test_lower_bound_edges_match_count_lt_and_settle_n(L, n_of):
    """K6's plain version at 9-32 lanes, on the edges the warp search must
    keep: runs of equal keys, bounds equal to run keys (at the start, the
    middle and the end of a stretch), 0 and the sentinel, n = the run, 1
    and 0, and P = 0.  One jit shape per L."""
    N = 600
    rng = np.random.RandomState(L)
    keys = dup_run(L, N, L)
    n = {"all": N, "one": 1, "none": 0}[n_of]
    ju = np.where(np.arange(N) < n, keys, 0).astype(np.uint32)   # zero tail
    refolded = np.where(np.arange(N) < n, keys, SENT).astype(np.uint32)
    first = keys[:, :1]
    bounds = np.concatenate(
        [keys[:, rng.randint(0, N, 6)], first, keys[:, -1:],
         np.zeros((L, 1), np.uint32), np.full((L, 1), SENT, np.uint32),
         keys[:, rng.randint(0, N, 2)] + np.uint32(1)], axis=1)
    run = convert.lanes_from_numpy(ju, "cpu")
    B = convert.lanes_from_numpy(bounds, "cpu")
    got = tcount.lower_bound_plain(run, n, B).tolist()
    for j in range(bounds.shape[1]):
        bj = jnp.asarray(bounds[:, j])
        assert got[j] == int(jengine._settle_n(jnp.asarray(ju),
                                               jnp.asarray(n, jnp.int32), bj))
        assert got[j] == int(jengine._count_lt(jnp.asarray(refolded), bj))
    assert got[-3] == n        # the sentinel bound is above every key
    assert tcount.lower_bound_plain(run, n, B[:, :0]).shape == (0,)


@pytest.mark.parametrize("histo_max", [10000, 5])
def test_solid_fold_histogram_matches_jax(histo_max):
    rng = np.random.RandomState(histo_max)
    N, n_u, L = 1000, 850, 2
    unique = rng.randint(0, 2**32, size=(L, N), dtype=np.uint64).astype(np.uint32)
    counts = np.minimum(rng.geometric(0.3, N), 40).astype(np.int32)
    minpos = rng.randint(0, 2**31, N).astype(np.uint32)
    js, jc, jp, jnn = jcount.filter_abundance_fold(
        jnp.asarray(unique), jnp.asarray(counts), jnp.asarray(minpos),
        jnp.asarray(n_u, jnp.int32), 2, 30)
    jh = jcount.abundance_histogram(jnp.asarray(counts),
                                    jnp.asarray(n_u, jnp.int32), histo_max)
    ts, tc, tp, tn, th = tcount.solid_fold_histogram_plain(
        convert.lanes_from_numpy(unique, "cpu"),
        convert.counts_from_numpy(counts, "cpu"),
        convert.pos_from_numpy(minpos, "cpu"), n_u, 2, 30, histo_max)
    np.testing.assert_array_equal(convert.lanes_to_numpy(ts), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(convert.pos_to_numpy(tp), np.asarray(jp))
    assert int(tn[0]) == int(np.asarray(jnn)[1])
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("C,n_solid,link", [(16, 16, 0.9), (1024, 1000, 0.7),
                                            (4096, 3000, 0.95), (4096, 0, 0.5)])
def test_run_scans_match_junction_runs(C, n_solid, link):
    """succ with consecutive links at rate `link`, other links random."""
    rng = np.random.RandomState(C + n_solid)
    idx = np.arange(2 * C)
    succ = np.where(rng.rand(2 * C) < 0.3, -1, rng.randint(0, 2 * C, 2 * C))
    succ[:C] = np.where(rng.rand(C) < link, idx[:C] + 1, succ[:C])
    got = trun.run_scans_plain(torch.from_numpy(succ), n_solid, C)
    # junction_runs' scans, on the same succ (successor_arrays replaced)
    jn = jnp.asarray(n_solid, jnp.int32)
    i = jnp.arange(C, dtype=jnp.int32)
    vplus = i < jn
    nxt = vplus & (jnp.asarray(succ[:C]) == i + 1) & (i + 1 < C)
    is_head = vplus & ~jnp.concatenate([jnp.zeros((1,), bool), nxt[:-1]])
    is_tail = vplus & ~nxt
    want = (is_head, is_tail, jnp.cumsum(is_head.astype(jnp.int32)) - 1,
            jrun._cummax(jnp.where(is_head, i, -1), -1),
            jrun._cummin_rev(jnp.where(is_tail, i, C), C),
            jnp.sum(is_head.astype(jnp.int32))[None])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_run_scans_sources_are_the_fills():
    """run_broadcast gathers each member's run values through rid where the
    JAX package scatters them at the run heads (tails) and fills (_ffill)
    from is_head (is_tail): the same values below n_solid."""
    rng = np.random.RandomState(4)
    C, n_solid = 2048, 1900
    idx = np.arange(2 * C)
    succ = np.where(rng.rand(2 * C) < 0.8, idx + 1, -1)
    succ[n_solid - 1] = -1      # no edge leaves the solid set
    is_head, is_tail, rid, _, _, R = trun.run_scans_plain(
        torch.from_numpy(succ), n_solid, C)
    vals = rng.randint(0, 1000, size=(2, int(R[0])))
    member_rid = rid.numpy()[:n_solid]
    for have, reverse in ((is_head.numpy(), False), (is_tail.numpy(), True)):
        scattered = np.zeros((2, C), np.int32)
        scattered[:, np.nonzero(have)[0]] = vals
        want = jrun._ffill(jnp.asarray(have),
                           tuple(jnp.asarray(v) for v in scattered),
                           reverse=reverse)
        for v, w in zip(vals, want):
            np.testing.assert_array_equal(v[member_rid],
                                          np.asarray(w)[:n_solid])


# ---- configuration ----

@pytest.mark.parametrize("k", [21, 31, 63])
def test_configure_chunk_monotone_with_floor(k):
    prev = (0, 0)
    for mb in (64, 128, 300, 1000, 1900, 2200, 4000, 16000, 80000):
        cfg = tengine.EngineConfig(k=k)
        chunk = tengine.configure_chunk(cfg, mb, "cpu")
        assert chunk == cfg.chunk_kmers and chunk & (chunk - 1) == 0
        assert tengine.MIN_CHUNK <= chunk <= tengine.MAX_CHUNK
        assert cfg.resident_kmers >= 2 * chunk          # the budget floor
        assert (chunk, cfg.resident_kmers) >= prev
        assert chunk >= prev[0] and cfg.resident_kmers >= prev[1]
        prev = (chunk, cfg.resident_kmers)
        if chunk > tengine.MIN_CHUNK:   # inside the budget
            used = (chunk * tengine.chunk_slot_bytes(k)
                    + cfg.resident_kmers * tengine.resident_slot_bytes(k))
            assert used <= mb << 20
    cfg = tengine.EngineConfig(k=k)
    tengine.configure_chunk(cfg, 0, "cpu")      # no -max-memory: the device
    assert cfg.resident_kmers == tengine.resident_slots(
        k, tengine.CPU_DEVICE_BYTES)
