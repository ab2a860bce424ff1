"""The port's per-k-mer mesh entry points on gloo ranks against bcalm_tpu's
on make_mesh(N), N = 2 and 4 (conftest's virtual CPU devices), exact.

One module-scoped fixture per world size spawns the ranks once
(parallel.launch.run_entry_points) and runs every job:
  - distributed_count (K1 -> hash routing -> exchange -> count) and
    gather_solid on tests/test_parallel.py::test_distributed_counts_vs_oracle's
    reads: each device's unique/counts/n_unique, the dropped count and the
    gathered solid set; a tiny cap_per_dest gives the same nonzero drops;
  - distributed_compact_pos and distributed_compact on
    tests/test_distcompact.py's scenarios (the circular read included),
    the per-device lists split by the routing hash as that file splits
    them: seqs, kc, abundances, circular and links of the UnitigSet.
"""

import pickle
import random

import numpy as np
import pytest
import jax.numpy as jnp

from bcalm_tpu import engine as jeng
from bcalm_tpu.io import packing as jpacking
from bcalm_tpu.ops import hashing as jhashing
from bcalm_tpu.parallel import distcompact as jdc
from bcalm_tpu.parallel import pipeline as jpl
from bcalm_tpu_torch.parallel import launch
from bcalm_tpu_torch.parallel import pipeline as tpl


def make_reads(seed, k, n=120, glen=400):
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(glen))
    return [genome[i:i + rng.randint(k + 2, k + 40)]
            for i in [rng.randrange(0, glen - k - 10) for _ in range(n)]]


def compact_reads(seed, k, glen, span, n):
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(glen))
    return [genome[i:i + rng.randint(k + 2, k + 40)]
            for i in [rng.randrange(0, span) for _ in range(n)]]


# name -> (kind, reads, k, amin, cap_per_dest)
COUNTS = {
    "count": ("count", make_reads(7, 13, n=60), 13, 1, 4096),
    "count_tiny_cap": ("count", make_reads(7, 13, n=60), 13, 1, 64),
}
CIRCULAR = ["ACTTAGCGGACTTAGC"]
COMPACTS = {
    # tests/test_distcompact.py::test_distributed_compact_pos_matches
    "pos_seed0_k13": ("compact_pos", compact_reads(0, 13, 700, 650, 200), 13, 1),
    "pos_seed1_k21": ("compact_pos", compact_reads(1, 21, 700, 650, 200), 21, 2),
    "pos_seed5_k31": ("compact_pos", compact_reads(5, 31, 700, 650, 200), 31, 1),
    "pos_circular": ("compact_pos", CIRCULAR, 7, 1),
    # ::test_distributed_compact_matches
    "seed0_k13": ("compact", compact_reads(0, 13, 500, 450, 150), 13, 1),
    "seed1_k21": ("compact", compact_reads(1, 21, 500, 450, 150), 21, 2),
    "seed3_k33": ("compact", compact_reads(3, 33, 500, 450, 150), 33, 1),
    "circular": ("compact", CIRCULAR, 7, 1),
}


def solid_split(name, n_dev):
    """bcalm_tpu's solid set of a compaction scenario, split over n_dev
    devices by the routing hash: ([lanes], [counts], [first-occurrence keys])."""
    _, reads, k, amin = COMPACTS[name]
    br, ml = (8, 32) if k == 7 else (64, 128)
    cfg = jeng.EngineConfig(k=k, abundance_min=amin, block_reads=br, max_len=ml)
    solid, counts, minpos, _, _ = jeng.count_and_filter(
        jpacking.iter_blocks(reads, k, block_reads=br, max_len=ml), cfg)
    owner = np.asarray(jhashing.hash_lanes(jnp.asarray(solid))) % n_dev
    parts = [[], [], []]
    for d in range(n_dev):
        m = owner == d
        for part, a in zip(parts, (solid[:, m], counts[m], minpos[m])):
            part.append(np.ascontiguousarray(a))
    return parts


def packed(name, n_dev):
    _, reads, k, _, _ = COUNTS[name]
    return tpl.pack_global_blocks(reads, k, n_dev, block_reads=32, max_len=128)


@pytest.fixture(scope="module", params=[2, 4])
def port(request, tmp_path_factory):
    """(n_dev, {job: [per-rank results]}) of one spawn of n_dev gloo ranks
    over every job."""
    n_dev = request.param
    out = tmp_path_factory.mktemp(f"entry{n_dev}")
    jobs = []
    for name, (_, reads, k, amin, cap) in COUNTS.items():
        words, lengths = packed(name, n_dev)
        jobs.append({"name": name, "kind": "count", "words": words,
                     "lengths": lengths, "k": k, "cap": cap, "amin": amin,
                     "amax": 2**31 - 1})
    for name, (kind, _, k, _) in COMPACTS.items():
        solid, counts, pos = solid_split(name, n_dev)
        jobs.append({"name": name, "kind": kind, "solid": solid,
                     "counts": counts, "pos": pos, "k": k})
    launch.spawn(n_dev, "cpu", launch.run_entry_points, jobs, str(out))
    results = {}
    for job in jobs:
        results[job["name"]] = []
        for r in range(n_dev):
            with open(out / f"{job['name']}.{r}.pkl", "rb") as f:
                results[job["name"]].append(pickle.load(f))
    return n_dev, results


@pytest.mark.parametrize("name", list(COUNTS))
def test_distributed_count_matches_jax(port, name):
    n_dev, results = port
    _, _, k, amin, cap = COUNTS[name]
    words, lengths = packed(name, n_dev)
    want_w, want_l = jpl.pack_global_blocks(COUNTS[name][1], k, n_dev,
                                            block_reads=32, max_len=128)
    assert np.array_equal(words, want_w) and np.array_equal(lengths, want_l)
    res = jpl.distributed_count(jpl.make_mesh(n_dev), jnp.asarray(words),
                                jnp.asarray(lengths), k, cap_per_dest=cap)
    uniq, cnts = np.asarray(res.unique), np.asarray(res.counts)
    per = uniq.shape[1] // n_dev
    for d, r in enumerate(results[name]):
        assert r["n_unique"].tolist() == res.n_unique.tolist()
        assert r["dropped"] == res.dropped
        assert np.array_equal(r["unique"], uniq[:, d * per:(d + 1) * per]), d
        assert np.array_equal(r["counts"], cnts[d * per:(d + 1) * per]), d
    solid, counts = jpl.gather_solid(res, amin, 2**31 - 1)
    for r in results[name]:
        assert r["solid"].dtype == solid.dtype and np.array_equal(r["solid"], solid)
        assert r["solid_counts"].dtype == counts.dtype
        assert np.array_equal(r["solid_counts"], counts)
    if name == "count_tiny_cap":
        assert res.dropped > 0
    else:
        assert res.dropped == 0 and solid.shape[1] > 100


@pytest.mark.parametrize("name", list(COMPACTS))
def test_distributed_compact_matches_jax(port, name):
    n_dev, results = port
    kind, _, k, _ = COMPACTS[name]
    solid, counts, pos = solid_split(name, n_dev)
    mesh = jpl.make_mesh(n_dev)
    us = (jdc.distributed_compact_pos(mesh, solid, counts, pos, k)
          if kind == "compact_pos"
          else jdc.distributed_compact(mesh, solid, counts, k))
    got = results[name][0]
    assert all(r is None for r in results[name][1:])
    assert got["seqs"] == us.seqs and len(us.seqs) > 0
    assert np.array_equal(got["kc"], us.kc)
    assert len(got["abundances"]) == len(us.abundances)
    for a, b in zip(got["abundances"], us.abundances):
        assert np.array_equal(a, b)
    assert np.array_equal(got["circular"], us.circular)
    assert got["links"] == us.links
    for key in ("devices", "solid_kmers", "glue_runs"):
        assert got["stats"][key] == us.stats[key], key
    if "circular" in name:
        assert len(us.seqs) == 1 and bool(us.circular[0])
