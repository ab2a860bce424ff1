"""Plain versions of K9-K12 and the canonical-order compaction vs bcalm_tpu.

- K9 solid_compact_plain vs bcalm_tpu.ops.count.filter_abundance_pos;
- K10 finish_fast_plain vs bcalm_tpu.ops.chains.finish_fast, with and
  without wlen, on mirror-symmetric chains, cycles and hairpins (a chain
  that is its own mirror, as palindromic runs give);
- K11 spell_unitigs_plain vs bcalm_tpu.engine._assemble_dev's codes and
  member-ordered counts, on the locality-ordered and the canonical-order
  chains of a branching input and of circular fixtures;
- K12 (run_decompose) on circular fixtures, and the port's compact_solid
  vs bcalm_tpu.engine.compact_solid on a branching input.
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
