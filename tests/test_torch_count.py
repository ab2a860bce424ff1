"""K2 counting (plain path on the CPU) vs bcalm_tpu.ops.count + engine.count_blocks.

Covers unweighted counting with first-occurrence keys, the weighted merge
of counted runs whose pos values interleave (the per-group min must be a
real segmented min), the solidity fold, the abundance histogram, and the
resident counting loop at chunk sizes that force many chunks and LSM
merges.  All outputs are integer: exact equality.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from bcalm_tpu import engine as jengine
from bcalm_tpu.io import packing
from bcalm_tpu.ops import count as jcount
from bcalm_tpu_torch import convert, engine as tengine
from bcalm_tpu_torch.ops import count as tcount

SENT = 0xFFFFFFFF


def random_occurrences(L: int, n: int, seed: int):
    """n draws from one pool of 50 k-mers per L, ~20% invalid."""
    pool = np.random.RandomState(L).randint(
        0, 2**32, size=(L, 50), dtype=np.uint64).astype(np.uint32)
    rng = np.random.RandomState(seed)
    lanes = pool[:, rng.randint(0, 50, n)]
    valid = rng.rand(n) > 0.2
    pos = rng.permutation(n).astype(np.uint32) * np.uint32(7)
    return lanes, valid, pos


def t(x):
    return convert.lanes_from_numpy(x, "cpu")


@pytest.mark.parametrize("L", [1, 2, 3])
def test_count_canonical_with_pos(L):
    lanes, valid, pos = random_occurrences(L, 700, L)
    ju, jc, jn, jp = jcount.count_canonical(
        jnp.asarray(lanes), jnp.asarray(valid), pos=jnp.asarray(pos),
        with_pos=True)
    folded = np.where(valid[None], lanes, np.uint32(SENT))
    tu, tc, tp, tn = tcount.count_canonical(t(folded), pos=t(pos))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(convert.lanes_to_numpy(tu), np.asarray(ju))
    np.testing.assert_array_equal(convert.counts_to_numpy(tc), np.asarray(jc))
    np.testing.assert_array_equal(convert.pos_to_numpy(tp), np.asarray(jp))


def test_weighted_merge_interleaved_pos():
    """Two counted runs sharing k-mers, the smaller pos in either run."""
    L = 2
    rng = np.random.RandomState(5)
    runs = []
    for seed in (1, 2):
        lanes, valid, pos = random_occurrences(L, 400, seed)
        valid[:] = True
        u, c, n, p = jcount.count_canonical(
            jnp.asarray(lanes), jnp.asarray(valid), pos=jnp.asarray(pos),
            with_pos=True)
        n = int(n)
        runs.append((np.asarray(u)[:, :n], np.asarray(c)[:n] * 3,
                     np.asarray(p)[:n] ^ np.uint32(rng.randint(0, 64))))
    lanes = np.concatenate([r[0] for r in runs], axis=1)
    w = np.concatenate([r[1] for r in runs])
    p = np.concatenate([r[2] for r in runs])
    ju, jc, jn, jp = jcount.count_canonical(
        jnp.asarray(lanes), jnp.ones(lanes.shape[1], bool), weights=jnp.asarray(w),
        weighted=True, pos=jnp.asarray(p), with_pos=True)
    tu, tc, tp, tn = tcount.count_canonical(t(lanes), convert.counts_from_numpy(w, "cpu"),
                                            t(p))
    assert int(tn) == int(jn) < lanes.shape[1]
    np.testing.assert_array_equal(convert.lanes_to_numpy(tu), np.asarray(ju))
    np.testing.assert_array_equal(convert.counts_to_numpy(tc), np.asarray(jc))
    np.testing.assert_array_equal(convert.pos_to_numpy(tp), np.asarray(jp))


def test_filter_fold_and_histogram():
    lanes, valid, pos = random_occurrences(2, 900, 9)
    ju, jc, jn, jp = jcount.count_canonical(
        jnp.asarray(lanes), jnp.asarray(valid), pos=jnp.asarray(pos),
        with_pos=True)
    n = int(jn)
    js, jsc, jsp, jnn = jcount.filter_abundance_fold(ju, jc, jp, jn, 14, 20)
    ts, tsc, tsp, tns = tcount.filter_abundance_fold(
        t(np.asarray(ju)), convert.counts_from_numpy(np.asarray(jc), "cpu"),
        t(np.asarray(jp)), n, 14, 20)
    assert int(tns) == int(np.asarray(jnn)[1])
    np.testing.assert_array_equal(convert.lanes_to_numpy(ts), np.asarray(js))
    np.testing.assert_array_equal(convert.counts_to_numpy(tsc), np.asarray(jsc))
    np.testing.assert_array_equal(convert.pos_to_numpy(tsp), np.asarray(jsp))
    jh = jcount.abundance_histogram(jc, jn, histo_max=16)
    th = tcount.abundance_histogram(
        convert.counts_from_numpy(np.asarray(jc), "cpu"), n, histo_max=16)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def reads(seed: int):
    rng = np.random.RandomState(seed)
    genome = "".join("ACGT"[c] for c in rng.randint(0, 4, 700))
    out = []
    for _ in range(120):
        i = rng.randint(0, 640)
        out.append(genome[i:i + rng.randint(30, 60)])
    return out + ["ACGTN" * 12, genome[:20]]


@pytest.mark.parametrize("k", [21, 33])
def test_count_blocks_independent_of_chunk_size(k):
    seqs = reads(k)
    jcfg = jengine.EngineConfig(k=k, abundance_min=1, block_reads=8,
                                max_len=64)
    ju, jc, jp, jn, _ = jengine.count_blocks(
        packing.iter_blocks(seqs, k, block_reads=8, max_len=64), jcfg)
    n = int(jn)
    expect = (np.asarray(ju)[:, :n], np.asarray(jc)[:n], np.asarray(jp)[:n])
    tcfg = convert.engine_config_from_jax(jcfg)
    for chunk in (300, 2000, 1 << 20):   # 300: a flush per block, many merges
        tcfg.chunk_kmers = chunk
        tu, tc, tp, stats = tengine.count_blocks(
            packing.iter_blocks(seqs, k, block_reads=8, max_len=64), tcfg, "cpu")
        np.testing.assert_array_equal(convert.lanes_to_numpy(tu), expect[0])
        np.testing.assert_array_equal(convert.counts_to_numpy(tc), expect[1])
        np.testing.assert_array_equal(convert.pos_to_numpy(tp), expect[2])
    assert stats["kmer_occurrences"] == int(expect[1].sum())


def test_count_blocks_raises_past_resident_budget(monkeypatch):
    monkeypatch.setattr(tengine, "resident_slots", lambda k: 50)
    cfg = tengine.EngineConfig(k=21, abundance_min=1, block_reads=8,
                               max_len=64, chunk_kmers=300)
    with pytest.raises(RuntimeError, match="ROADMAP A10"):
        tengine.count_blocks(
            packing.iter_blocks(reads(1), 21, block_reads=8, max_len=64), cfg,
            "cpu")
