"""K2 counting (plain path on the CPU) vs bcalm_tpu.ops.count + engine.count_blocks.

Covers unweighted counting with first-occurrence keys, the weighted merge
of counted runs whose pos values interleave (the per-group min must be a
real segmented min), the run shapes the kernel's tiles of 2048 columns
meet (one run over every column, a run over several tiles among short
ones, all sentinel, one column, a weighted run whose pos values
interleave), the solidity fold, the abundance histogram, and the
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
from bcalm_tpu_torch.models import lanes as tln
from bcalm_tpu_torch.ops import count as tcount
from bcalm_tpu_torch.ops import sort as tsort

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


@pytest.mark.parametrize("L", [1, 2, 3, 10])
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


def run_case(case: str):
    """(lanes (L, N) u32, valid, weights or None, pos) of one run shape."""
    rng = np.random.RandomState(len(case))
    L = 2
    pool = rng.randint(0, 2**32, size=(L, 40), dtype=np.uint64).astype(np.uint32)
    if case == "one_run":            # one k-mer in every column
        idx = np.zeros(5000, np.int64)
    elif case in ("long_run", "weighted_long_run"):
        # a run of 4500 columns (past two tiles) among 40 short ones
        idx = np.concatenate([rng.randint(1, 40, 700), np.zeros(4500, np.int64),
                              rng.randint(1, 40, 900)])
    elif case == "all_sentinel":
        idx = rng.randint(0, 40, 3000)
    else:                             # "single": N = 1
        idx = np.zeros(1, np.int64)
    N = idx.size
    lanes = pool[:, idx]
    valid = np.ones(N, bool) if case != "all_sentinel" else np.zeros(N, bool)
    pos = rng.permutation(N).astype(np.uint32) * np.uint32(3) + np.uint32(5)
    weights = (rng.randint(1, 1000, N).astype(np.int32)
               if case == "weighted_long_run" else None)
    return lanes, valid, weights, pos


@pytest.mark.parametrize("case", ["one_run", "long_run", "all_sentinel",
                                  "single", "weighted_long_run"])
def test_count_canonical_run_shapes(case):
    lanes, valid, weights, pos = run_case(case)
    kw = {} if weights is None else {"weights": jnp.asarray(weights),
                                     "weighted": True}
    ju, jc, jn, jp = jcount.count_canonical(
        jnp.asarray(lanes), jnp.asarray(valid), pos=jnp.asarray(pos),
        with_pos=True, **kw)
    folded = np.where(valid[None], lanes, np.uint32(SENT))
    tu, tc, tp, tn = tcount.count_canonical(
        t(folded), None if weights is None else convert.counts_from_numpy(
            weights, "cpu"), t(pos))
    assert int(tn) == int(jn) == {"one_run": 1, "single": 1,
                                  "all_sentinel": 0}.get(case, int(jn))
    np.testing.assert_array_equal(convert.lanes_to_numpy(tu), np.asarray(ju))
    np.testing.assert_array_equal(convert.counts_to_numpy(tc), np.asarray(jc))
    np.testing.assert_array_equal(convert.pos_to_numpy(tp), np.asarray(jp))
    if case != "all_sentinel":
        assert int(tc.sum()) == (len(valid) if weights is None
                                 else int(weights.sum()))


def sorted_case(L: int, case: str):
    """(lanes (L, N) u32, valid, weights or None, pos or None) in entry
    order: draws from a pool of 60 k-mers, ~15% sentinel columns and, past
    two lanes, ~5% whose first two lanes alone are the sentinel (valid);
    "long_run": one k-mer in 4500 columns (past two 2048-column tiles) in
    a random order among the draws; "one"/"empty": N = 1 / 0."""
    rng = np.random.RandomState(10 * L + len(case))
    pool = rng.randint(0, 2**32, size=(L, 60), dtype=np.uint64).astype(np.uint32)
    N = {"one": 1, "empty": 0}.get(case, 3000)
    idx = rng.randint(0, 60, N)
    if case == "long_run":
        idx = rng.permutation(np.concatenate([idx, np.zeros(4500, np.int64)]))
        N = idx.size
    lanes = pool[:, idx]
    valid = rng.rand(N) > 0.15
    if L > 2:
        lanes[:2, rng.rand(N) < 0.05] = SENT
    weights = (rng.randint(1, 1000, N).astype(np.int32)
               if case in ("weighted", "long_run") else None)
    pos = (None if case == "unweighted"
           else rng.permutation(N).astype(np.uint32) * np.uint32(3))
    return lanes, valid, weights, pos


@pytest.mark.parametrize("L", [1, 2, 3, 10])
@pytest.mark.parametrize("case", ["unweighted", "weighted", "pos", "one",
                                  "empty", "long_run"])
def test_count_sorted_plain_matches_jax(L, case):
    """K2's entry on the sort's own output (top word, perm, lower packed
    words, weights and pos in entry order; its plain version on the CPU)
    against bcalm_tpu's count_canonical, exactly (at N = 0, which JAX's
    indexing refuses, against empty outputs)."""
    lanes, valid, weights, pos = sorted_case(L, case)
    N = lanes.shape[1]
    kw = {}
    if weights is not None:
        kw.update(weights=jnp.asarray(weights), weighted=True)
    if pos is not None:
        kw.update(pos=jnp.asarray(pos), with_pos=True)
    if N:
        out = jcount.count_canonical(jnp.asarray(lanes), jnp.asarray(valid), **kw)
    else:
        out = (np.zeros((L, 0), np.uint32), np.zeros(0, np.int32), 0,
               np.zeros(0, np.uint32))
    ju, jc, jn = out[:3]
    folded = t(np.where(valid[None], lanes, np.uint32(SENT)))
    keys = tln.pack_rows(folded)
    perm, top = tsort.lex_sort_words(list(keys))
    tu, tc, tp, tn = tcount.count_sorted(
        top, perm, keys[1:] if L > 2 else None, L,
        None if weights is None else convert.counts_from_numpy(weights, "cpu"),
        None if pos is None else t(pos))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(convert.lanes_to_numpy(tu), np.asarray(ju))
    np.testing.assert_array_equal(convert.counts_to_numpy(tc), np.asarray(jc))
    if pos is not None:
        np.testing.assert_array_equal(convert.pos_to_numpy(tp), np.asarray(out[3]))
    else:
        assert tp is None


@pytest.mark.parametrize("L", [1, 2, 3, 4, 10, 32])
def test_pack_rows_and_unpack(L):
    """pack_rows is pack_keys in one tensor; unpack_keys inverts it."""
    rng = np.random.RandomState(L)
    lanes = t(rng.randint(0, 2**32, size=(L, 257), dtype=np.uint64)
              .astype(np.uint32))
    rows = tln.pack_rows(lanes)
    for a, b in zip(rows, tln.pack_keys(list(lanes))):
        assert a.dtype == b.dtype and bool((a == b).all())
    assert rows.shape[0] == (L + 1) // 2
    assert bool((tln.unpack_keys(list(rows), L) == lanes).all())


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
    """Past the resident budget the count no longer raises: it goes
    multi-pass over key ranges and still equals bcalm_tpu's count."""
    k = 21
    seqs = reads(1)
    jcfg = jengine.EngineConfig(k=k, abundance_min=1, block_reads=2,
                                max_len=64)
    ju, jc, jp, jn, _ = jengine.count_blocks(
        packing.iter_blocks(seqs, k, block_reads=2, max_len=64), jcfg)
    n = int(jn)
    monkeypatch.setattr(tengine, "resident_slots", lambda k, budget: 50)
    cfg = tengine.EngineConfig(k=k, abundance_min=1, block_reads=2,
                               max_len=64, chunk_kmers=64)
    tu, tc, tp, stats = tengine.count_blocks(
        packing.iter_blocks(seqs, k, block_reads=2, max_len=64), cfg, "cpu")
    assert stats["ooc_passes"] > 1
    np.testing.assert_array_equal(tu, np.asarray(ju)[:, :n])
    np.testing.assert_array_equal(tc, np.asarray(jc)[:n])
    np.testing.assert_array_equal(tp, np.asarray(jp)[:n])
