"""The hierarchical jump (K17-K19 plain paths on the CPU) vs bcalm_tpu.

hier_jump's converged state and `ok` must equal JAX's row for row on
successor graphs of M = 2**19 (two levels) and 2**21 (three levels) with
cycles longer than a level's reach, isolated and invalid nodes and edge
weights (dist0); a level overflow (_LEVEL_SHRINK patched to 64 in both
packages) must give ok == False in both, with equal states.  Then the
decompositions: chain_decompose's three variants, run_decompose's, and the
engine's compaction where "auto" picks the hierarchical jump (FASTA
byte-identical to bcalm_tpu's), with the plain rerun after a forced
overflow; and the _extract_fold front end.  Exact equality throughout.
"""

import io

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bcalm_tpu import engine as jeng
from bcalm_tpu.io import fasta_writer as jfw
from bcalm_tpu.io import packing as jpacking
from bcalm_tpu.ops import chains as jchains
from bcalm_tpu.ops import runchains as jrun
from bcalm_tpu_torch import engine as teng
from bcalm_tpu_torch.io import fasta_writer as tfw
from bcalm_tpu_torch.io import packing as tpacking
from bcalm_tpu_torch.ops import chains as tchains
from bcalm_tpu_torch.ops import runchains as trun
from tests.test_torch_cuda import expand_case, mirror_graph


def jump_inputs(M: int):
    """pred, valid and dist0 (numpy) of a graph of M nodes with a cycle of
    5000, isolated nodes and hairpins."""
    succ, valid = mirror_graph(M // 2, M.bit_length(), long_cycle=5000)
    pred = np.asarray(jchains.build_pred(jnp.asarray(succ.astype(np.int32)),
                                         jnp.asarray(valid)))
    w = np.random.RandomState(1).randint(1, 30, M).astype(np.int32)
    return pred, valid, w[np.clip(pred, 0, M - 1)]


def both_hier(pred, valid, dist0):
    js, jok = jchains.hier_jump(jnp.asarray(pred), jnp.asarray(valid),
                                jnp.asarray(dist0))
    ts, tok = tchains.hier_jump(torch.from_numpy(pred.astype(np.int64)),
                                torch.from_numpy(valid),
                                torch.from_numpy(dist0.astype(np.int64)))
    return (np.asarray(js), bool(jok)), (ts.numpy(), bool(tok.item()))


@pytest.mark.parametrize("log_m,levels", [(19, 2), (21, 3)])
def test_hier_jump_state_matches_jax(log_m, levels):
    M = 1 << log_m
    assert len(tchains.level_sizes(M)) == levels + 1
    (js, jok), (ts, tok) = both_hier(*jump_inputs(M))
    assert jok and tok
    np.testing.assert_array_equal(ts, js)
    # the long cycle resolved: no ROOTED flag, its rank column below its length
    assert not (ts[:, 1] & tchains._F_ROOTED).all()


def test_hier_level_overflow(monkeypatch):
    """_LEVEL_SHRINK 64: level 1 of M = 2**21 holds 2**15 rows, far fewer
    than the ~1/7 of the nodes selected; both packages report it."""
    monkeypatch.setattr(jchains, "_LEVEL_SHRINK", 64)
    monkeypatch.setattr(tchains, "_LEVEL_SHRINK", 64)
    (js, jok), (ts, tok) = both_hier(*jump_inputs(1 << 21))
    assert not jok and not tok
    np.testing.assert_array_equal(ts, js)


@pytest.fixture(scope="module")
def level_rounds():
    """K17's input at the first round of each level of hier_jump on M =
    2**19 with _FINAL_CAP cut to 2**11 (five levels): {level: (Q, gid,
    valid, salt)}; level 0's gid is None (the row index)."""
    mp = pytest.MonkeyPatch()
    seen = {}
    real = tchains._phase

    def record(Q, gid, valid, salt, rounds, converge=True):
        if salt is not None:
            seen[len(seen)] = (Q.clone(), gid, valid, salt)
        return real(Q, gid, valid, salt, rounds, converge)

    mp.setattr(tchains, "_FINAL_CAP", 1 << 11)
    mp.setattr(tchains, "_phase", record)
    try:
        pred, valid, dist0 = jump_inputs(1 << 19)
        tchains.hier_jump(torch.from_numpy(pred.astype(np.int64)),
                          torch.from_numpy(valid),
                          torch.from_numpy(dist0.astype(np.int64)))
    finally:
        mp.undo()
    return seen


@pytest.mark.parametrize("level", [0, 2])
def test_fixpoint_bitmap_matches_jax(level_rounds, level):
    """K17's plain bitmap against JAX's `_sampled(gid, salt) & valid` at
    levels 0 (gid None: the row index) and 2, and one round of
    hier_round_plain given the bitmap against one round of JAX's _phase
    with those fixpoints."""
    Q, gid, valid, salt = level_rounds[level]
    assert (gid is None) == (level == 0)
    S = Q.shape[0]
    jgid = np.arange(S, dtype=np.int32) if gid is None else gid.numpy().astype(np.int32)
    fix = np.asarray(jchains._sampled(jnp.asarray(jgid), salt) & jnp.asarray(valid.numpy()))
    bits = tchains.fixpoint_bits(gid, valid, salt)
    assert bits.dtype == torch.int32 and bits.shape == (-(-S // 32),)
    words = bits.numpy().astype(np.uint32)
    unpacked = ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1).ravel()
    np.testing.assert_array_equal(unpacked[:S].astype(bool), fix)
    assert not unpacked[S:].any()
    got = tchains.hier_round_plain(Q, gid, bits)
    want = jchains._phase(jnp.asarray(Q.numpy().astype(np.int32)),
                          jnp.asarray(fix), jnp.asarray(jgid), 1,
                          converge=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def exact_level_inputs(M: int, S1: int, extra: int):
    """pred, valid and dist0 of M nodes whose level 0 selects exactly
    S1 + extra rows: S1 + extra of the level's sampled fixpoints are valid
    (half of them roots, the rest pointing at an earlier one), every other
    sampled node invalid, and every other node valid, pointing at a valid
    fixpoint (so phase A settles it and marks no target) or a root."""
    rng = np.random.RandomState(S1 + extra)
    salt = (0x85EBCA6B * 1) & 0xFFFFFFFF
    sampled = tchains._sampled(torch.arange(M), salt).numpy()
    fix = np.flatnonzero(sampled)
    assert fix.size > S1 + extra
    sel = fix[:S1 + extra]
    valid = ~sampled
    valid[sel] = True
    pred = np.full(M, -1, np.int64)
    rest = np.flatnonzero(~sampled)
    pred[rest] = np.where(rng.rand(rest.size) < 0.75,
                          sel[rng.randint(0, sel.size, rest.size)], -1)
    odd = np.arange(1, sel.size, 2)
    pred[sel[odd]] = sel[(rng.rand(odd.size) * odd).astype(np.int64)]
    w = rng.randint(1, 30, M).astype(np.int64)
    return pred, valid, w[np.clip(pred, 0, M - 1)]


@pytest.mark.parametrize("extra", [0, 1])
def test_hier_contract_selects_exactly_the_level(extra, monkeypatch):
    """K18's plain version at its capacity: a level 0 that selects exactly
    S1 rows (n_c = S1, ok) and one more (n_c > S1, the overflow), on M =
    2**14 with the level cut to S1 = M / 16 (_LEVEL_SHRINK and _FINAL_CAP
    patched in both packages); the state and ok equal bcalm_tpu's
    hier_jump's, and n_c and ok come from hier_contract_plain."""
    M, S1 = 1 << 14, 1 << 10
    for mod in (jchains, tchains):
        monkeypatch.setattr(mod, "_LEVEL_SHRINK", 16)
        monkeypatch.setattr(mod, "_FINAL_CAP", S1)
    assert tchains.level_sizes(M) == [M, S1]
    pred, valid, dist0 = exact_level_inputs(M, S1, extra)
    calls = []
    real = tchains.hier_contract
    monkeypatch.setattr(tchains, "hier_contract",
                        lambda *a: calls.append(real(*a)) or calls[-1])
    (js, jok), (ts, tok) = both_hier(pred, valid, dist0)
    np.testing.assert_array_equal(ts, js)
    assert jok == tok == (extra == 0)
    n_c = int(calls[0][5])
    assert n_c == S1 + extra
    assert bool(calls[0][2].all())            # every row of the level valid


def assert_info_equal(tinfo, jinfo):
    n = int(jinfo["n_unitigs"])
    assert int(tinfo["n_unitigs"]) == n and n > 0
    for key in ("uid", "rank"):
        np.testing.assert_array_equal(tinfo[key].numpy(), np.asarray(jinfo[key]))
    for key in ("start_oid", "length", "circular"):
        np.testing.assert_array_equal(tinfo[key].numpy()[:n],
                                      np.asarray(jinfo[key])[:n])


@pytest.mark.parametrize("variant", ["auto", "plain", "hier"])
def test_chain_decompose_variants(variant, monkeypatch):
    """M = 2**18: "auto" picks the hierarchical jump in both packages."""
    succ, valid = mirror_graph(1 << 17, 3, long_cycle=700)
    calls = []
    real = tchains.hier_jump
    monkeypatch.setattr(tchains, "hier_jump",
                        lambda *a: calls.append(1) or real(*a))
    jinfo = jchains.chain_decompose(jnp.asarray(succ.astype(np.int32)),
                                    jnp.asarray(valid), variant=variant)
    tinfo = tchains.chain_decompose(torch.from_numpy(succ),
                                    torch.from_numpy(valid), variant=variant)
    assert_info_equal(tinfo, jinfo)
    assert len(calls) == (variant != "plain")


# ---- the engine's compaction where "auto" picks the hierarchical jump ----

K = 31


def genome_kmers(n_bases: int, seed: int):
    """Distinct canonical k-mers of a random genome into which 40-base
    repeats (one of 50) are copied every 150 bases on average, so that the
    graph branches: lexicographic order, (2, n) u32 lanes, random counts
    (no counting)."""
    rng = np.random.RandomState(seed)
    g = rng.randint(0, 4, n_bases).astype(np.uint64)
    repeats = rng.randint(0, 4, (50, 40)).astype(np.uint64)
    for at in rng.randint(0, n_bases - 40, n_bases // 150):
        g[at:at + 40] = repeats[rng.randint(0, 50)]
    P = n_bases - K + 1
    fwd = np.zeros(P, np.uint64)
    rc = np.zeros(P, np.uint64)
    for j in range(K):
        fwd = (fwd << np.uint64(2)) | g[j:j + P]
        rc |= (g[j:j + P] ^ np.uint64(2)) << np.uint64(2 * j)
    v = np.unique(np.minimum(fwd, rc))
    lanes = np.stack([(v >> np.uint64(32)).astype(np.uint32),
                      (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
    counts = rng.randint(2, 60, v.shape[0]).astype(np.int32)
    return lanes, counts, rng


def fasta(us, writer) -> str:
    buf = io.StringIO()
    writer.write_fasta(us, buf)
    return buf.getvalue()


@pytest.fixture(scope="module")
def positioned():
    """140 K k-mers with shuffled first-occurrence keys: runs are short, so
    R > 2**16 and the contracted graph has 2**19 nodes; JAX's FASTA."""
    lanes, counts, rng = genome_kmers(140_000, 11)
    n = lanes.shape[1]
    keys = (rng.permutation(n).astype(np.uint32) << np.uint32(1)) \
        | rng.randint(0, 2, n).astype(np.uint32)
    cfg = jeng.EngineConfig(k=K, abundance_min=2)
    want = fasta(jeng.compact_from_counts(lanes, counts, cfg, minpos_np=keys),
                 jfw)
    return lanes, counts, keys, want


def test_compact_solid_pos_hier_fasta(positioned, monkeypatch):
    lanes, counts, keys, want = positioned
    calls = []
    real = tchains.hier_jump
    monkeypatch.setattr(tchains, "hier_jump",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    us = teng.compact_from_counts(lanes, counts, teng.EngineConfig(k=K), "cpu",
                                  minpos_np=keys)
    assert calls == [1 << 19]
    assert fasta(us, tfw) == want and want.count(">") > 1000


def test_compact_solid_pos_overflow_reruns_plain(positioned, monkeypatch):
    """A forced level overflow (level 1 of 2**13 rows) makes the port's
    compact_solid_pos rerun the jump with the plain doubling, as
    bcalm_tpu's does; the FASTA stays bcalm_tpu's."""
    lanes, counts, keys, want = positioned
    monkeypatch.setattr(tchains, "_LEVEL_SHRINK", 64)
    monkeypatch.setattr(tchains, "_FINAL_CAP", 1 << 13)
    jumps = []
    for name in ("hier_jump", "plain_jumpF"):
        real = getattr(tchains, name)
        monkeypatch.setattr(tchains, name, lambda *a, _n=name, _f=real: (
            jumps.append(_n) or _f(*a)))
    us = teng.compact_from_counts(lanes, counts, teng.EngineConfig(k=K), "cpu",
                                  minpos_np=keys)
    assert jumps == ["hier_jump", "plain_jumpF"]
    assert fasta(us, tfw) == want


@pytest.mark.parametrize("variant", ["auto", "plain", "hier"])
def test_run_decompose_variants(positioned, variant):
    """run_decompose of the reordered table, each variant of the port
    against bcalm_tpu's auto (hierarchical here) decomposition."""
    lanes, counts, keys, _ = positioned
    n = lanes.shape[1]
    C = jeng._round_capacity(n)
    pad = lambda a, fill: np.concatenate(  # noqa: E731
        [a, np.full(a.shape[:-1] + (C - n,), fill, a.dtype)], axis=-1)
    solid_r, _ = jrun.reorder_by_pos(jnp.asarray(pad(lanes, 0xFFFFFFFF)),
                                     jnp.asarray(pad(counts, 0)),
                                     jnp.asarray(pad(keys, 0xFFFFFFFF)), K)
    succ, scan = jrun.junction_runs(solid_r, jnp.asarray(n, jnp.int32), K)
    R = int(scan["R"])
    R_cap = jeng._round_capacity(R)
    assert 2 * R_cap == 1 << 19
    names = ("is_head", "rid", "head_pos", "end_pos")
    jinfo = jrun.run_decompose(succ, jnp.asarray(n, jnp.int32),
                               *(scan[k] for k in names), scan["R"], R_cap=R_cap)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(  # noqa: E731
        np.int64 if np.asarray(a).dtype != bool else bool))
    tinfo = trun.run_decompose(t(succ), n, *(t(scan[k]) for k in names), R,
                               R_cap, variant=variant)
    n_u = int(jinfo["n_unitigs"])
    assert int(tinfo["n_unitigs"]) == n_u > 0
    for key in ("uid", "rank"):
        np.testing.assert_array_equal(tinfo[key].numpy(), np.asarray(jinfo[key]))
    for key in ("start_oid", "length", "circular"):
        np.testing.assert_array_equal(tinfo[key].numpy()[:n_u],
                                      np.asarray(jinfo[key])[:n_u])


def test_compact_solid_canonical_hier_fasta(monkeypatch):
    """The canonical-order path (no first-occurrence keys) at C = 2**17:
    M = 2**18 oriented nodes, so "auto" is hierarchical in both packages."""
    lanes, counts, _ = genome_kmers(100_000, 12)
    assert jeng._round_capacity(lanes.shape[1]) == 1 << 17
    want = fasta(jeng.compact_from_counts(
        lanes, counts, jeng.EngineConfig(k=K, abundance_min=2)), jfw)
    calls = []
    real = tchains.hier_jump
    monkeypatch.setattr(tchains, "hier_jump",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    us = teng.compact_from_counts(lanes, counts, teng.EngineConfig(k=K), "cpu")
    assert calls == [1 << 18]
    assert fasta(us, tfw) == want


# ---- the extract + fold front end ----

@pytest.mark.parametrize("k,slot_base", [(21, 0), (31, 123_457),
                                         (31, (1 << 31) - 5), (41, 1 << 30)])
def test_extract_fold_matches_jax(k, slot_base):
    """slot_base 2**31 - 5: the keys of the slots past 2**31 - 1 wrap, and
    slot 2**31 - 1 (column 4: the first read is all G, read on the reverse
    strand) would key as the sentinel itself: both packages clamp it to
    0xFFFFFFFE."""
    rng = np.random.RandomState(k)
    g = "".join("ACGT"[c] for c in rng.randint(0, 4, 2000))
    reads = ["G" * (k + 10)] + [g[i:i + rng.randint(5, 120)]
                                for i in rng.randint(0, 1900, 70)]
    jb = next(iter(jpacking.iter_blocks(reads, k, block_reads=128, max_len=128)))
    tb = next(iter(tpacking.iter_blocks(reads, k, block_reads=128, max_len=128)))
    jf, jn = jeng._extract_fold(jnp.asarray(jb.words), jnp.asarray(jb.lengths),
                                k, np.uint32(slot_base))
    tf, tn = teng._extract_fold(torch.from_numpy(tb.words.astype(np.int64)),
                                torch.from_numpy(tb.lengths.astype(np.int64)),
                                k, slot_base)
    assert tf.shape[1] == teng.block_slots(tb.words.shape, k) == \
        jeng.block_slots(jb.words.shape, k)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf).astype(np.int64))
    assert int(tn) == int(jn) > 0
    if slot_base == (1 << 31) - 5:
        assert int(tf[-1, 4]) == 0xFFFFFFFE


@pytest.mark.parametrize("rooted", [0.0, 0.5])
def test_hier_expand_entry_writes_over_qd(rooted):
    """K19's entry writes the plain upward pass over Qd and returns Qd, as
    the kernel does on the card (hier_jump reads no level's Qd after it)."""
    S = 4096 + 3
    F, parent, Qd, did = expand_case(S, S // 4, rooted, 5)
    want = tchains.hier_expand_plain(F, parent, Qd, did)
    got = tchains.hier_expand(F, parent, Qd, did)
    assert got.data_ptr() == Qd.data_ptr() and torch.equal(Qd, want)
