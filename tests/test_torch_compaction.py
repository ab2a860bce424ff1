"""Plain versions of K9-K12 and the canonical-order compaction vs bcalm_tpu.

- K9 solid_compact_plain vs bcalm_tpu.ops.count.filter_abundance_pos;
- K10 finish_fast_plain vs bcalm_tpu.ops.chains.finish_fast, with and
  without wlen, on mirror-symmetric chains, cycles and hairpins (a chain
  that is its own mirror, as palindromic runs give);
- K11 spell_unitigs_plain vs bcalm_tpu.engine._assemble_dev's codes and
  member-ordered counts, on the locality-ordered and the canonical-order
  chains of a branching input and of circular fixtures;
- K12 (run_decompose) on circular fixtures, and the port's compact_solid
  vs bcalm_tpu.engine.compact_solid on a branching input;
- K16 glue_compose_plain (in place, the response in the exchange's
  layout) vs the compose step of bcalm_tpu's _glue_shard;
- K21 glue_answer_plain (the owners' answer, channel-major) vs the
  answers _glue_shard computes for a doubling round and its two lookups.
Every input is made with numpy and fed to both; exact equality.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bcalm_tpu import engine as jengine
from bcalm_tpu.io import packing
from bcalm_tpu.ops import chains as jchains
from bcalm_tpu.ops import count as jcount
from bcalm_tpu_torch import convert
from bcalm_tpu_torch import engine as tengine
from bcalm_tpu_torch.ops import chains as tchains
from bcalm_tpu_torch.ops import count as tcount
from bcalm_tpu_torch.parallel import distcompact
from tests.test_oracle import CIRC1, CIRC2, CIRC3
from tests.test_torch_chains import assert_info_equal, successor_graph

import bench


def t64(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("L,n_unique,amin,amax", [
    (1, 5000, 2, 2**31 - 1), (2, 4000, 3, 40), (4, 5000, 1, 1)])
def test_solid_compact_plain_matches_filter_abundance_pos(L, n_unique, amin,
                                                          amax):
    rng = np.random.RandomState(L)
    N = 5000
    unique = rng.randint(0, 2**32, size=(L, N), dtype=np.uint64).astype(np.uint32)
    counts = rng.geometric(0.3, N).astype(np.int32)
    minpos = rng.randint(0, 2**31, N).astype(np.uint32)
    js, jc, jp, jn = jcount.filter_abundance_pos(
        jnp.asarray(unique), jnp.asarray(counts), jnp.asarray(minpos),
        jnp.asarray(n_unique, jnp.int32), amin, amax)
    out, n = tcount.solid_compact_plain(t64(unique), t64(counts), t64(minpos),
                                        n_unique, amin, amax)
    n = int(n[0])
    assert n == int(jn) > 0
    np.testing.assert_array_equal(out[:L].numpy(), np.asarray(js))
    np.testing.assert_array_equal(out[L].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(out[L + 1].numpy(), np.asarray(jp))
    narrow, _ = tcount.solid_compact_plain(t64(unique), t64(counts),
                                           t64(minpos), n_unique, amin, amax,
                                           width=n)
    assert torch.equal(narrow, out[:, :n])


# K9's kernel compacts tiles of 4096 columns: N at a tile minus one, a
# tile and a tile plus one, with none, some or all columns solid, or
# n_unique = 0
@pytest.mark.parametrize("N,kind", [(4095, "none"), (4096, "all"),
                                    (4097, "no_unique"), (4095, "some"),
                                    (4096, "some"), (4097, "some")])
def test_solid_compact_edges_match_filter_abundance(N, kind):
    """solid_compact_plain vs filter_abundance_pos and filter_abundance_plain
    vs filter_abundance at the widths N, above n_solid (a 0 and sentinel
    tail) and below it (the first solid columns only)."""
    rng = np.random.RandomState(N)
    L, amin, amax = 2, 2, 40
    unique = rng.randint(0, 2**32, size=(L, N), dtype=np.uint64).astype(np.uint32)
    counts = {"none": np.ones(N), "all": np.full(N, 7)}.get(
        kind, rng.geometric(0.3, N)).astype(np.int32)
    minpos = rng.randint(0, 2**31, N).astype(np.uint32)
    n_unique = 0 if kind == "no_unique" else N - 2
    nu = jnp.asarray(n_unique, jnp.int32)
    js, jc, jp, jn = jcount.filter_abundance_pos(
        jnp.asarray(unique), jnp.asarray(counts), jnp.asarray(minpos), nu,
        amin, amax)
    fs, fc, fn = jcount.filter_abundance(jnp.asarray(unique),
                                         jnp.asarray(counts), nu, amin, amax)
    want = np.concatenate([np.asarray(js), np.asarray(jc)[None],
                           np.asarray(jp)[None]]).astype(np.int64)
    n = int(jn)
    assert n == int(fn) == {"none": 0, "all": N - 2, "no_unique": 0}.get(kind, n)
    tu, tc, tp = t64(unique), t64(counts), t64(minpos)
    for width in (N, n + (N - n) // 2, n // 2):
        out, tn = tcount.solid_compact_plain(tu, tc, tp, n_unique, amin, amax,
                                             width=width)
        assert int(tn[0]) == n
        np.testing.assert_array_equal(out.numpy(), want[:, :width])
    ts, tsc, tsn = tcount.filter_abundance_plain(tu, tc, n_unique, amin, amax)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(fs))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(fc))
    assert int(tsn) == n


def hairpin_graph(N, seed):
    """succ of chains, cycles and hairpins (a -> ... -> mirror(a)) over N
    vertices, mirror-symmetric, with a few invalid vertices at the end."""
    succ, valid = successor_graph(N, N - 8, seed, 0.3)
    rng = np.random.RandomState(seed)
    free = [v for v in range(N - 8) if succ[v] < 0 and succ[v + N] < 0
            and all(succ[w] != v and succ[w] != v + N for w in range(2 * N))]
    for v in rng.permutation(free)[:6]:
        succ[v] = v + N                # v -> mirror(v): its own mirror chain
    return succ, valid


@pytest.mark.parametrize("N,weighted", [(64, False), (64, True), (512, False),
                                        (512, True)])
def test_finish_fast_plain_matches_jax(N, weighted):
    succ, valid = hairpin_graph(N, N + weighted)
    M = 2 * N
    jpred = jchains.build_pred(jnp.asarray(succ), jnp.asarray(valid))
    wlen = dist0 = None
    if weighted:
        w = np.random.RandomState(N).randint(1, 6, N).astype(np.int32)
        wlen = np.concatenate([w, w])
        dist0 = jnp.take(jnp.asarray(wlen), jnp.clip(jpred, 0, M - 1))
    jstate = jchains.plain_jumpF(jpred, jnp.asarray(valid), dist0)
    jinfo = jchains.finish_fast(jnp.asarray(succ), jpred, jnp.asarray(valid),
                                jstate,
                                wlen=None if wlen is None else jnp.asarray(wlen))
    tinfo = tchains.finish_fast_plain(
        t64(succ), t64(jpred), torch.from_numpy(valid), t64(jstate),
        None if wlen is None else t64(wlen))
    assert_info_equal(tinfo, jinfo)
    n = int(jinfo["n_unitigs"])
    assert n > 0 and (N < 512 or bool(np.asarray(jinfo["circular"])[:n].any()))
    assert torch.equal(tchains.build_pred(t64(succ), torch.from_numpy(valid)),
                       t64(jpred))


def counted(seqs, k, amin):
    """bcalm_tpu's solidity-folded table (capacity of the distinct count)
    of seqs: (solid, counts, minpos, n_solid)."""
    cfg = jengine.EngineConfig(k=k, abundance_min=amin, block_reads=64,
                               max_len=160)
    u, c, p, n, _ = jengine.count_blocks(
        packing.iter_blocks(seqs, k, block_reads=64, max_len=160), cfg)
    cap = jengine._round_capacity(int(n))
    s, sc, sp, nn = jcount.filter_abundance_fold(u, c, p, n, amin, 2**31 - 1)
    return (np.asarray(s)[:, :cap], np.asarray(sc)[:cap],
            np.asarray(sp)[:cap], int(np.asarray(nn)[1]))


def branching(seed=3):
    rng = np.random.RandomState(seed)
    genome = bench.make_genome(6000, rng, repeat_frac=0.1)
    reads = bench.sample_reads(genome, 300, 100, rng, err_rate=0.003,
                               dup_frac=0.2)
    return ["".join("ACTG"[c] for c in r) for r in reads]


def canonical_table(solid, counts, n_solid):
    """The solid prefix in canonical order, zero-padded to its capacity
    (compact_from_counts' table without first-occurrence keys)."""
    keep = ~np.all(solid == 0xFFFFFFFF, axis=0)
    cols = np.nonzero(keep)[0][:n_solid]
    cap = jengine._round_capacity(n_solid)
    s = np.zeros((solid.shape[0], cap), np.uint32)
    c = np.zeros(cap, np.int32)
    s[:, :n_solid], c[:n_solid] = solid[:, cols], counts[cols]
    return s, c


CASES = [("branching", branching, 31, 2), ("circular1", lambda: [CIRC1], 7, 1),
         ("circular2", lambda: [CIRC2], 7, 1), ("circular3", lambda: CIRC3, 7, 1)]


@pytest.mark.parametrize("name,seqs,k,amin", CASES)
@pytest.mark.parametrize("order", ["positioned", "canonical"])
def test_spell_unitigs_plain_matches_assemble_dev(name, seqs, k, amin, order):
    solid, counts, minpos, n_solid = counted(seqs(), k, amin)
    if order == "positioned":
        s_r, c_r, _, info = jengine.compact_solid_pos(
            jnp.asarray(solid), jnp.asarray(counts), jnp.asarray(minpos),
            n_solid, k)
    else:
        s_np, c_np = canonical_table(solid, counts, n_solid)
        s_r, c_r = jnp.asarray(s_np), jnp.asarray(c_np)
        _, _, info = jengine.compact_solid(s_r, c_r, n_solid, k)
    U = int(info["n_unitigs"])
    total = n_solid + (k - 1) * U
    u_cap = min(jengine._round_capacity(U), int(info["length"].shape[0]))
    mem_cap = min(jengine._round_capacity(n_solid), int(info["uid"].shape[0]))
    codes, mcounts, _, _ = jengine._assemble_dev(
        s_r, c_r, info["uid"], info["rank"], info["length"], info["start_oid"],
        jnp.asarray(U, jnp.int32), k, jengine._round_capacity(total), mem_cap,
        u_cap)
    tcodes, tcounts = tengine.spell_unitigs_plain(
        convert.lanes_from_numpy(np.asarray(s_r), "cpu"), t64(c_r),
        t64(info["uid"]), t64(info["rank"]), t64(info["length"]),
        t64(info["start_oid"]), U, k, n_solid)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes)[:total])
    np.testing.assert_array_equal(tcounts.numpy(),
                                  np.asarray(mcounts)[:n_solid].astype(np.int64))
    if name == "circular1":
        assert bool(np.asarray(info["circular"])[:U].any())


@pytest.mark.parametrize("name,seqs,k,amin", CASES[1:])
def test_run_decompose_circular(name, seqs, k, amin):
    from tests.test_torch_runchains import assert_runs_equal

    solid, counts, minpos, n_solid = counted(seqs(), k, amin)
    from bcalm_tpu.ops import runchains as jrun
    js, _ = jrun.reorder_by_pos(jnp.asarray(solid), jnp.asarray(counts),
                                jnp.asarray(minpos), k)
    assert_runs_equal(np.asarray(js), n_solid, k)


@pytest.mark.parametrize("k", [21, 31])
def test_compact_solid_matches_jax(k):
    solid, counts, _, n_solid = counted(branching(k), k, 2)
    s_np, c_np = canonical_table(solid, counts, n_solid)
    jsucc, _, jinfo = jengine.compact_solid(jnp.asarray(s_np),
                                            jnp.asarray(c_np), n_solid, k)
    tsucc, tinfo = tengine.compact_solid(
        convert.lanes_from_numpy(s_np, "cpu"), n_solid, k)
    np.testing.assert_array_equal(tsucc.numpy(), np.asarray(jsucc))
    assert_info_equal(tinfo, jinfo)
    assert int(jinfo["n_unitigs"]) > 20


def test_chain_info_round_trip():
    """chain_info_to_numpy gives JAX's dtypes and shapes (uid of 2C), and
    chain_info_from_numpy reads JAX's own dict back to equal tensors."""
    solid, counts, minpos, n_solid = counted(branching(), 31, 2)
    _, _, _, jinfo = jengine.compact_solid_pos(
        jnp.asarray(solid), jnp.asarray(counts), jnp.asarray(minpos),
        n_solid, 31)
    jnp_info = {key: np.asarray(val) for key, val in jinfo.items()}
    tinfo = convert.chain_info_from_numpy(jnp_info, "cpu")
    back = convert.chain_info_to_numpy(tinfo)
    assert set(back) == set(jnp_info)
    for key, val in jnp_info.items():
        assert back[key].dtype == val.dtype and back[key].shape == val.shape
        np.testing.assert_array_equal(back[key], val)
    assert back["uid"].shape[0] == 2 * jengine._round_capacity(n_solid)


@pytest.mark.parametrize("n_dev", [1, 3])
def test_glue_compose_in_place_matches_jax(n_dev):
    """K16's plain version (in place, the response read in the exchange's
    (4, W) layout at each row's slot) against JAX's where(need,
    _composeF(Q, anc), Q) of _glue_shard: ROOTED targets, FIX targets,
    dists that saturate, ties in mn, dropped slots (clipped to W - 1);
    the next round's need and route where need was set, the rest kept."""
    rng = np.random.RandomState(16 + n_dev)
    run_cap = 300
    M, c_tot = 2 * run_cap, n_dev * run_cap
    flags = rng.choice([0, tchains._F_ROOTED, tchains._F_FIX,
                        tchains._F_SETTLED], M, p=[0.6, 0.2, 0.1, 0.1])
    dist = np.where(rng.rand(M) < 0.2, tchains._DMASK - rng.randint(0, 3, M),
                    rng.randint(1, 50, M))
    Q = np.stack([rng.randint(0, 2 * c_tot, M), dist | flags,
                  rng.randint(0, 40, M), rng.randint(0, 9, M)], axis=1)
    cvalid = rng.rand(M) < 0.9
    need = cvalid & ((Q[:, 1] & tchains._F_ROOTED) == 0)
    W = 4 * M
    aflags = rng.choice([0, tchains._F_ROOTED, tchains._F_FIX], W,
                        p=[0.6, 0.2, 0.2])
    back = np.stack([rng.randint(0, 2 * c_tot, W),
                     np.where(rng.rand(W) < 0.2, tchains._DMASK,
                              rng.randint(1, 50, W)) | aflags,
                     rng.randint(0, 40, W), rng.randint(0, 9, W)])
    slots = rng.permutation(W)[:M]
    slots[rng.rand(M) < 0.05] = W          # dropped: JAX clips to W - 1
    ptr0, owner0 = rng.randint(0, 9, M), rng.randint(0, 9, M)

    anc = back[:, np.clip(slots, 0, W - 1)].T
    jq = jnp.asarray(Q.astype(np.int32))
    want = np.asarray(jnp.where(jnp.asarray(need)[:, None],
                                jchains._composeF(jq, jnp.asarray(anc.astype(np.int32))),
                                jq)).astype(np.int64)
    nxt = need & ((want[:, 1] & tchains._F_ROOTED) == 0)
    p = want[:, 0]
    owner = np.where(nxt, np.where(p >= c_tot, p - c_tot, p) // run_cap, n_dev)

    tQ, tneed = t64(Q), torch.from_numpy(need.copy())
    route = torch.stack([t64(ptr0), t64(owner0)])
    changed = torch.zeros(1, dtype=torch.int32)
    distcompact.glue_compose(tQ, t64(back), t64(slots), tneed, changed, route,
                             run_cap, n_dev)
    np.testing.assert_array_equal(tQ.numpy(), want)
    assert int(changed) == int((want != Q).any())
    np.testing.assert_array_equal(tneed.numpy(), nxt)
    np.testing.assert_array_equal(route[0].numpy(), np.where(need, p, ptr0))
    np.testing.assert_array_equal(route[1].numpy(), np.where(need, owner, owner0))
    assert 0 < nxt.sum() < need.sum()
    assert ((want[:, 1] & tchains._DMASK) == tchains._DMASK).any()


def _jax_gq_local(g, run_cap, c_tot):
    """_glue_shard's gq_local (int32, floored remainder)."""
    s = jnp.where(g >= c_tot, g - c_tot, g)
    return s % run_cap + jnp.where(g >= c_tot, run_cap, 0)


@pytest.mark.parametrize("n_dev", [1, 3])
@pytest.mark.parametrize("mode", ["rows", "run", "uid"])
def test_glue_answer_matches_jax(mode, n_dev):
    """K21's plain version against the answers of bcalm_tpu's _glue_shard
    at every slot of the exchange: the round's rows (:313-318, take of Q
    at every slot, the empty ones included), the run lookup (:258-264) and
    the uid lookup (:378-381).  The received values are zero where the
    slot is empty, as K15 leaves them; valid ones include values the clip
    bounds (off this rank's slots, negative, past both strands)."""
    rng = np.random.RandomState(21 + 3 * n_dev + len(mode))
    run_cap, slot_cap, qcap = 300, 1024, 96
    me = n_dev - 1
    c_tot, two_rc, S = n_dev * run_cap, 2 * run_cap, n_dev * qcap
    valid = rng.rand(S) < 0.4
    if mode == "run":
        v = np.where(rng.rand(S) < 0.8, me * slot_cap + rng.randint(0, slot_cap, S),
                     rng.randint(-5, n_dev * slot_cap + 5, S))
    else:
        v = np.where(rng.rand(S) < 0.8, rng.randint(0, 2 * c_tot, S),
                     rng.randint(-3 * run_cap, 3 * c_tot, S))
    vals = np.where(valid, v, 0)
    jv, jok = jnp.asarray(vals.astype(np.int32)), jnp.asarray(valid)
    if mode == "rows":
        Q = np.stack([rng.randint(0, 2 * c_tot, two_rc), rng.randint(0, 1 << 30, two_rc),
                      rng.randint(0, 2 * c_tot + 1, two_rc), rng.randint(0, 50, two_rc)],
                     axis=1)
        tables = (t64(Q),)
        rloc = jnp.clip(_jax_gq_local(jv, run_cap, c_tot), 0, two_rc - 1)
        want = jnp.transpose(jnp.take(jnp.asarray(Q.astype(np.int32)), rloc, axis=0))
    elif mode == "run":
        head = np.sort(rng.randint(0, slot_cap, slot_cap))
        end = head + rng.randint(0, 40, slot_cap)
        rid = np.cumsum(rng.rand(slot_cap) < 0.1)
        tables = tuple(t64(a) for a in (rid, head, end))
        lv = jnp.clip(jv - me * slot_cap, 0, slot_cap - 1)
        j = [jnp.asarray(a.astype(np.int32)) for a in (rid, head, end)]
        want = jnp.stack([
            jnp.where(jok, me * run_cap + jnp.take(j[0], lv), -1),
            jnp.where(jok, jnp.take(j[2], lv) - jnp.take(j[1], lv) + 1, 0)])
    else:
        uid_at = np.where(rng.rand(two_rc) < 0.3, rng.randint(0, 5000, two_rc), -1)
        tables = (t64(uid_at),)
        urow = jnp.clip(_jax_gq_local(jv, run_cap, c_tot), 0, two_rc - 1)
        want = jnp.where(jok, jnp.take(jnp.asarray(uid_at.astype(np.int32)), urow),
                         -1)[None]
    got = distcompact.glue_answer(mode, t64(vals), torch.from_numpy(valid), tables,
                                  run_cap, n_dev, me)
    assert got.shape == ({"rows": 4, "run": 2, "uid": 1}[mode], S)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert 0 < valid.sum() < S and (vals[~valid] == 0).all()
