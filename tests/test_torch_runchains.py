"""Run-contracted chain decomposition (ops.runchains) vs bcalm_tpu.ops.runchains.

The solid table comes from bcalm_tpu's own counting of reads over a
repeat-seeded genome with errors, so first-occurrence keys are real.
Each stage (reorder_by_pos, junction_runs, run_decompose) is fed the same
inputs in both packages.  The constant-pos case keeps the table in key
order with no locality, the worst-case run structure (runs of length ~1).
Exact equality.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bcalm_tpu import engine as jengine
from bcalm_tpu.io import packing
from bcalm_tpu.ops import count as jcount
from bcalm_tpu.ops import runchains as jrun
from bcalm_tpu_torch import convert
from bcalm_tpu_torch.ops import runchains as trun

import bench


def solid_table(k: int, seed: int):
    rng = np.random.RandomState(seed)
    genome = bench.make_genome(6000, rng, repeat_frac=0.1)
    reads = bench.sample_reads(genome, 300, 100, rng, err_rate=0.003,
                               dup_frac=0.2)
    return count_solid(["".join("ACTG"[c] for c in r) for r in reads], k)


def count_solid(seqs, k: int):
    cfg = jengine.EngineConfig(k=k, abundance_min=2, block_reads=64,
                               max_len=112)
    u, c, p, n, _ = jengine.count_blocks(
        packing.iter_blocks(seqs, k, block_reads=64, max_len=112), cfg)
    cap = jengine._round_capacity(int(n))
    s, sc, sp, nn = jcount.filter_abundance_fold(u, c, p, n, 2, 2**31 - 1)
    return (np.asarray(s)[:, :cap], np.asarray(sc)[:cap],
            np.asarray(sp)[:cap], int(np.asarray(nn)[1]))


def lanes(x):
    return convert.lanes_from_numpy(x, "cpu")


def assert_runs_equal(solid_r, n_solid, k):
    C = jengine._round_capacity(n_solid)
    solid_r = solid_r[:, :C]
    jsucc, jscan = jrun.junction_runs(jnp.asarray(solid_r),
                                      jnp.asarray(n_solid, jnp.int32), k)
    tsucc, tscan = trun.junction_runs(lanes(solid_r), n_solid, k)
    np.testing.assert_array_equal(tsucc.numpy(), np.asarray(jsucc))
    for key in ("is_head", "rid", "head_pos", "end_pos"):
        np.testing.assert_array_equal(tscan[key].numpy(), np.asarray(jscan[key]))
    R = int(jscan["R"])
    assert tscan["R"] == R
    R_cap = jengine._round_capacity(R)
    jinfo = jrun.run_decompose(
        jsucc, jnp.asarray(n_solid, jnp.int32), jscan["is_head"], jscan["rid"],
        jscan["head_pos"], jscan["end_pos"], jscan["R"], R_cap=R_cap,
        variant="plain")
    tinfo = trun.run_decompose(tsucc, n_solid, tscan["is_head"], tscan["rid"],
                               tscan["head_pos"], tscan["end_pos"], R, R_cap)
    n = int(jinfo["n_unitigs"])
    assert int(tinfo["n_unitigs"]) == n > 0
    for key in ("uid", "rank"):
        np.testing.assert_array_equal(tinfo[key].numpy(), np.asarray(jinfo[key]))
    for key in ("start_oid", "length", "circular"):
        np.testing.assert_array_equal(tinfo[key].numpy()[:n],
                                      np.asarray(jinfo[key])[:n])
    return R


@pytest.mark.parametrize("k", [21, 31, 33])
def test_reorder_and_run_decompose(k):
    solid, counts, pos, n_solid = solid_table(k, k)
    js, jc = jrun.reorder_by_pos(jnp.asarray(solid), jnp.asarray(counts),
                                 jnp.asarray(pos), k)
    ts, tc = trun.reorder_by_pos(lanes(solid),
                                 convert.counts_from_numpy(counts, "cpu"),
                                 lanes(pos), k)
    np.testing.assert_array_equal(convert.lanes_to_numpy(ts)[:, :n_solid],
                                  np.asarray(js)[:, :n_solid])
    np.testing.assert_array_equal(convert.counts_to_numpy(tc)[:n_solid],
                                  np.asarray(jc)[:n_solid])
    R = assert_runs_equal(np.asarray(js), n_solid, k)
    assert R < n_solid // 4                # locality: long runs


def test_constant_pos_worst_case_runs():
    k = 31
    solid, _, _, n_solid = solid_table(k, 3)
    # constant keys keep the canonical key order (the solid columns in
    # sorted order, folded ones last): no stream locality
    folded = np.all(solid == 0xFFFFFFFF, axis=0)
    order = np.argsort(folded, kind="stable")
    R = assert_runs_equal(solid[:, order], n_solid, k)
    assert R > n_solid // 2


def test_one_genome_long_runs():
    """A repeat-free genome read twice over in order, without errors: the
    first-occurrence order is the genome's, so one run spans nearly every
    solid entry (the long runs of the kernels' look-back)."""
    k = 31
    rng = np.random.RandomState(17)
    genome = "".join("ACTG"[c] for c in bench.make_genome(3000, rng))
    seqs = [genome[i:i + 100] for i in range(0, 2901, 20) for _ in range(2)]
    solid, counts, pos, n_solid = count_solid(seqs, k)
    js, _ = jrun.reorder_by_pos(jnp.asarray(solid), jnp.asarray(counts),
                                jnp.asarray(pos), k)
    R = assert_runs_equal(np.asarray(js), n_solid, k)
    assert n_solid > 2900 and R <= 2
