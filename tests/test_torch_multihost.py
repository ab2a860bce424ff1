"""Ranks across hosts: one group of gloo ranks started by several launchers.

The JAX package runs its mesh over 2 processes x 4 devices with
jax.distributed (tests/multihost_worker.py).  Here each launcher stands in
for one host: ``launch.spawn_host`` starts its share of the ranks (global
ranks rank_base.., local ranks 0..), which meet the other launchers' ranks
at ``tcp://localhost:<port>``.  Two launchers of 2 ranks each form a group
of 4 whose per-rank outputs of the mesh steps (sample_tables,
local_skm_count over every round, distributed_succ, glue_shard) equal
those of the same world-4 group started by one launcher.  The one-launcher
runs at world sizes 2 and 4 also hold sample_tables and distributed_succ
against bcalm_tpu's on 2 and 4 of conftest's virtual CPU devices; at world
size 2 also distributed_succ on k-mers whose junction entries all go to
rank 0, so that rank 1 receives no entry, and Mesh.exchange of K15's send
buffer against bcalm_tpu's all_to_all of the buckets and their validity.

The launchers are this file run as a script:
    python tests/test_torch_multihost.py N_LOCAL WORLD RANK_BASE INIT_METHOD OUT_DIR
"""

import functools
import os
import pickle
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, M = 21, 6
BLOCK_READS, MAX_LEN = 16, 64


def _reads():
    rng = np.random.RandomState(11)
    genome = "".join("ACGT"[c] for c in rng.randint(0, 4, 3000))
    genome += genome[500:900]          # a repeat: branching unitigs
    starts = rng.randint(0, len(genome) - 60, 240)
    return [genome[s:s + 60] for s in starts]


def _solid_shards(n_dev):
    """The reads' canonical k-mers in value order, cut into contiguous
    shards of slot_cap columns (zero padded): (L, n_dev*slot_cap) uint32,
    n_local (n_dev,), slot_cap."""
    from bcalm_tpu_torch.oracle import brute
    from bcalm_tpu_torch.ops.runchains import round_capacity

    kmers = sorted(brute.count_kmers(_reads(), K))
    L = (K + 15) // 16
    N = len(kmers)
    slot_cap = round_capacity(-(-N // n_dev))
    solid = np.zeros((L, n_dev * slot_cap), np.uint32)
    n_local = np.zeros((n_dev,), np.int32)
    for d in range(n_dev):
        part = kmers[d * slot_cap:(d + 1) * slot_cap]
        n_local[d] = len(part)
        for i, x in enumerate(part):
            for j in range(L):
                solid[j, d * slot_cap + i] = (x >> (32 * (L - 1 - j))) & 0xFFFFFFFF
    return solid, n_local, slot_cap


def _shards_of(kmers, n_dev):
    """k-mers dealt to n_dev shards in turn (k-mer i to shard i % n_dev),
    each zero padded to slot_cap columns: (L, n_dev*slot_cap) uint32,
    n_local (n_dev,), slot_cap."""
    from bcalm_tpu_torch.ops.runchains import round_capacity

    L = (K + 15) // 16
    slot_cap = round_capacity(-(-len(kmers) // n_dev))
    solid = np.zeros((L, n_dev * slot_cap), np.uint32)
    n_local = np.zeros((n_dev,), np.int32)
    for i, x in enumerate(kmers):
        d = i % n_dev
        for j in range(L):
            solid[j, d * slot_cap + n_local[d]] = (x >> (32 * (L - 1 - j))) & 0xFFFFFFFF
        n_local[d] += 1
    return solid, n_local, slot_cap


def _rank0_owned_shards():
    """The reads' k-mers whose four junction entries all hash to rank 0 of
    2, dealt to two shards: at world size 2, rank 1 receives no entry in
    the junction exchange, yet owns the source slots of some edges."""
    import torch

    from bcalm_tpu_torch.oracle import brute
    from bcalm_tpu_torch.ops import junctions

    kmers = sorted(brute.count_kmers(_reads(), K))
    L = (K + 15) // 16
    lanes = torch.tensor([[(x >> (32 * (L - 1 - j))) & 0xFFFFFFFF
                           for x in kmers] for j in range(L)],
                         dtype=torch.int64)
    N = len(kmers)
    _, _, owner = junctions.junction_entries_plain(lanes, N, K, 0, N, 2)
    keep = (owner.view(4, N) == 0).all(dim=0).tolist()
    return _shards_of([x for x, kept in zip(kmers, keep) if kept], 2)


def rank_work(mesh, out_dir):
    """The mesh steps on this rank; pickles what they gave to
    out_dir/<rank>.pkl."""
    import torch

    from bcalm_tpu_torch.ops import superkmer as skm
    from bcalm_tpu_torch.parallel import distcompact, pipeline

    n_dev, me = mesh.n_dev, mesh.rank
    rounds = list(pipeline.iter_global_blocks(_reads(), K, n_dev, BLOCK_READS,
                                              MAX_LEN))
    mcfg = pipeline.MinimizerConfig(m=M)
    freq_rank, table, load = pipeline.sample_tables(mesh, *rounds[0], K, mcfg,
                                                    n_dev)
    out = {"freq_rank": freq_rank, "table": table, "load": load, "rounds": []}
    table_d = torch.from_numpy(table.astype(np.int64))
    rank_d = torch.from_numpy(freq_rank.astype(np.int64))
    max_span = skm.default_max_span(K)
    cap = pipeline.superkmer_capacity(BLOCK_READS, MAX_LEN, K, M, n_dev,
                                      max_span)
    round_base = 0
    for words, lengths in rounds:
        w, l = pipeline._my_rows(mesh, words, lengths)
        u, c, p, n, st = pipeline.local_skm_count(
            mesh, w, l, table_d, rank_d, round_base & 0x3FFFFFFF, k=K, m=M,
            cap=cap, max_span=max_span, use_rank=True)
        out["rounds"].append((u[:, :n].numpy(), c[:n].numpy(), p[:n].numpy(),
                              st))
        round_base += words.shape[0] * words.shape[1] * 16

    solid, n_local, slot_cap = _solid_shards(n_dev)
    mine = torch.from_numpy(
        solid[:, me * slot_cap:(me + 1) * slot_cap].astype(np.int64))
    succ, pred, dropped = distcompact.distributed_succ(
        mesh, mine.contiguous(), int(n_local[me]), K, 4 * slot_cap, slot_cap)
    out.update(succ=succ.numpy(), pred=pred.numpy(), succ_dropped=dropped)
    if n_dev == 2:
        out["rank0_owned"] = _rank0_owned_step(mesh)
        out["exchange"] = _exchange_step(mesh)
    run_cap = max(16, slot_cap // 4)
    while True:   # distcompact._glue_and_assemble's run_cap escalation
        qcap = max(64, (4 * 2 * run_cap) // n_dev)
        got = distcompact.glue_shard(mesh, succ, int(n_local[me]), slot_cap,
                                     run_cap, qcap)
        if got is not None:
            break
        run_cap = min(slot_cap, run_cap * 4)
    outs, n_unitigs, g_dropped, g_rounds = got
    out.update(glue=[o.numpy() for o in outs], n_unitigs=n_unitigs,
               glue_dropped=g_dropped, glue_rounds=g_rounds)
    with open(os.path.join(out_dir, f"{me}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _rank0_owned_step(mesh):
    """distributed_succ on _rank0_owned_shards, with the count of valid
    entries this rank's compaction received."""
    import torch

    from bcalm_tpu_torch.ops import junctions
    from bcalm_tpu_torch.parallel import distcompact

    solid, n_local, slot_cap = _rank0_owned_shards()
    me = mesh.rank
    mine = torch.from_numpy(
        solid[:, me * slot_cap:(me + 1) * slot_cap].astype(np.int64))
    received, compact = [], junctions.junction_words

    def counted(rows, valid):
        out = compact(rows, valid)
        received.append(int(out[2][0]))
        return out

    junctions.junction_words = counted
    try:
        succ, pred, dropped = distcompact.distributed_succ(
            mesh, mine.contiguous(), int(n_local[me]), K, 4 * slot_cap,
            slot_cap)
    finally:
        junctions.junction_words = compact
    return {"succ": succ.numpy(), "pred": pred.numpy(), "dropped": dropped,
            "received": received}


# the exchange cases: (cap, fill word, hash mode, validity channel); the
# second cap drops; the last is the per-k-mer count's buffer
EXCHANGES = ((150, 0, False, True), (150, 0, True, True),
             (100, 0xFFFFFFFF, False, True), (100, 0xFFFFFFFF, True, True),
             (150, 0xFFFFFFFF, True, False))


def _exchange_case(rank, n_dev):
    """Rank `rank`'s seeded entries: (stacked (3, 300) uint32, valid,
    owner)."""
    rng = np.random.RandomState(50 + rank)
    stacked = rng.randint(0, 2**32, size=(3, 300), dtype=np.uint64).astype(np.uint32)
    valid = rng.rand(300) < 0.8
    owner = rng.randint(0, n_dev, 300).astype(np.int32)
    return stacked, valid, owner


def _exchange_step(mesh):
    """K15's send buffer of this rank's entries through Mesh.exchange, for
    each of EXCHANGES: [(recv (C, n_dev, cap), rvalid (None with no
    validity channel), dropped)]."""
    import torch

    from bcalm_tpu_torch.parallel import pipeline

    stacked, valid, owner = _exchange_case(mesh.rank, mesh.n_dev)
    out = []
    for cap, fill, hashed, with_valid in EXCHANGES:
        send, dropped = pipeline.route_to_buckets(
            torch.from_numpy(stacked.astype(np.int64)), torch.from_numpy(valid),
            None if hashed else torch.from_numpy(owner.astype(np.int64)),
            mesh.n_dev, cap, fill=fill, with_valid=with_valid)
        recv, rvalid = mesh.exchange(send, with_valid)
        out.append((recv.numpy(), None if rvalid is None else rvalid.numpy(),
                    int(dropped[0])))
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_launchers(tmp, n_dev, shares):
    """Run one launcher per (n_local, rank_base) share, all at once, and
    return the per-rank outputs."""
    out_dir = os.path.join(tmp, f"{n_dev}_{len(shares)}")
    os.makedirs(out_dir, exist_ok=True)
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(n_local), str(n_dev),
         str(base), init, out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for n_local, base in shares]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r in range(n_dev):
        with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


@functools.lru_cache(maxsize=None)
def _runs(tmp):
    return {"hosts4": _run_launchers(tmp, 4, [(2, 0), (2, 2)]),
            "one4": _run_launchers(tmp, 4, [(4, 0)]),
            "one2": _run_launchers(tmp, 2, [(2, 0)])}


def _tmp(tmp_path_factory):
    return str(tmp_path_factory.getbasetemp() / "multihost")


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _assert_equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_two_launchers_match_one_launcher(tmp_path_factory):
    runs = _runs(_tmp(tmp_path_factory))
    for got, want in zip(runs["hosts4"], runs["one4"]):
        _assert_equal(got, want)
    assert sum(o["rounds"][0][0].shape[1] for o in runs["one4"]) > 1000
    assert runs["one4"][0]["n_unitigs"] > 5
    assert all(o["succ_dropped"] == 0 and o["glue_dropped"] == 0
               for o in runs["one4"])


def _jax_succ(n_dev, solid, n_local, slot_cap):
    """bcalm_tpu's distributed_succ on n_dev of conftest's virtual CPU
    devices: (succ, pred, dropped)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bcalm_tpu.parallel import distcompact, pipeline

    mesh = pipeline.make_mesh(n_dev)
    g_solid = jax.device_put(jnp.asarray(solid),
                             NamedSharding(mesh, P(None, pipeline.AXIS)))
    g_nloc = jax.device_put(jnp.asarray(n_local),
                            NamedSharding(mesh, P(pipeline.AXIS)))
    succ, pred, dropped = distcompact.distributed_succ(
        mesh, g_solid, g_nloc, K, 4 * slot_cap, slot_cap)
    return np.asarray(succ), np.asarray(pred), dropped


def _jax_mesh_steps(n_dev):
    from bcalm_tpu.parallel import pipeline

    rounds = list(pipeline.iter_global_blocks(_reads(), K, n_dev, BLOCK_READS,
                                              MAX_LEN))
    tables = pipeline.sample_tables(*rounds[0], K,
                                    pipeline.MinimizerConfig(m=M), n_dev)
    return (tables,) + _jax_succ(n_dev, *_solid_shards(n_dev))


def test_sample_tables_and_distributed_succ_match_jax(tmp_path_factory):
    runs = _runs(_tmp(tmp_path_factory))
    for n_dev, name in ((2, "one2"), (4, "one4")):
        (freq_rank, table, load), succ, pred, dropped = _jax_mesh_steps(n_dev)
        assert dropped == 0
        span = succ.shape[0] // n_dev
        n_edges = 0
        for r, out in enumerate(runs[name]):
            np.testing.assert_array_equal(out["freq_rank"], freq_rank)
            np.testing.assert_array_equal(out["table"], table)
            np.testing.assert_array_equal(out["load"], load)
            np.testing.assert_array_equal(out["succ"],
                                          succ[r * span:(r + 1) * span])
            np.testing.assert_array_equal(out["pred"],
                                          pred[r * span:(r + 1) * span])
            n_edges += int((out["succ"] >= 0).sum())
        assert n_edges > 1000


def test_distributed_succ_with_a_rank_that_receives_no_entry(tmp_path_factory):
    """At world size 2, every junction entry hashed to rank 0: rank 1's
    compaction receives no valid entry (nothing sorted, no pair rule
    launched), yet it takes part in the edges' exchange and scatters the
    edges whose source slot it owns.  Both shards equal bcalm_tpu's."""
    outs = [o["rank0_owned"] for o in _runs(_tmp(tmp_path_factory))["one2"]]
    solid, n_local, slot_cap = _rank0_owned_shards()
    succ, pred, dropped = _jax_succ(2, solid, n_local, slot_cap)
    assert dropped == 0 and all(o["dropped"] == 0 for o in outs)
    assert outs[0]["received"] == [4 * int(n_local.sum())]
    assert outs[1]["received"] == [0]
    span = succ.shape[0] // 2
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["succ"], succ[r * span:(r + 1) * span])
        np.testing.assert_array_equal(out["pred"], pred[r * span:(r + 1) * span])
        assert int((out["succ"] >= 0).sum()) > 0


def _jax_exchange(n_dev, cap, hashed):
    """bcalm_tpu's route and exchange on n_dev of conftest's virtual CPU
    devices, each device the entries of _exchange_case: _route_to_buckets,
    then jax.lax.all_to_all of the buckets and of their validity, as
    _local_shard_count exchanges.  Per rank: (recv, rvalid, dropped)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bcalm_tpu.ops import hashing
    from bcalm_tpu.parallel import pipeline

    cases = [_exchange_case(r, n_dev) for r in range(n_dev)]
    stacked = np.concatenate([c[0] for c in cases], axis=1)
    valid = np.concatenate([c[1] for c in cases])
    owner = np.concatenate([c[2] for c in cases])
    ax = pipeline.AXIS

    def body(st, v, o):
        if hashed:
            o = (hashing.hash_lanes(st) % np.uint32(n_dev)).astype(jnp.int32)
        bl, bv, dropped = pipeline._route_to_buckets(st, v, o, n_dev, cap)
        return (jax.lax.all_to_all(bl, ax, split_axis=1, concat_axis=1),
                jax.lax.all_to_all(bv, ax, split_axis=0, concat_axis=0),
                dropped[None])

    fn = jax.jit(shard_map(body, mesh=pipeline.make_mesh(n_dev),
                           in_specs=(P(None, ax), P(ax), P(ax)),
                           out_specs=(P(None, ax), P(ax), P(ax)),
                           check_vma=False))
    rl, rv, dropped = (np.asarray(x) for x in fn(stacked, valid, owner))
    return [(rl[:, r * n_dev:(r + 1) * n_dev], rv[r * n_dev:(r + 1) * n_dev],
             int(dropped[r])) for r in range(n_dev)]


def test_exchange_of_the_send_buffer_matches_jax(tmp_path_factory):
    """At world size 2 (gloo), Mesh.exchange sends K15's (n_dev, C+1, cap)
    buffer as it is and returns what bcalm_tpu's all_to_all of the buckets
    and of their validity gives each rank: the buckets channel-major, the
    empty slots holding the fill word (0 as JAX fills, or the sentinel),
    the validity and the drops; given and hashed owners, with and without
    drops at cap; and the count's buffer, with no validity channel and
    the sentinel in its empty slots."""
    outs = [o["exchange"] for o in _runs(_tmp(tmp_path_factory))["one2"]]
    drops, empty = 0, 0
    for j, (cap, fill, hashed, with_valid) in enumerate(EXCHANGES):
        for r, (rl, rv, dropped) in enumerate(_jax_exchange(2, cap, hashed)):
            recv, rvalid, got_dropped = outs[r][j]
            assert recv.shape == (3, 2, cap)
            if not with_valid:
                assert rvalid is None
                rvalid = (recv != fill).any(0)
            np.testing.assert_array_equal(rvalid, rv)
            np.testing.assert_array_equal(
                recv, np.where(rv[None], rl.astype(np.int64), fill))
            assert got_dropped == dropped and rvalid.any()
            drops += dropped
            empty += int((~rvalid).sum())
    assert drops > 0 and empty > 0


def test_init_from_env_reads_the_ranks(monkeypatch):
    """init_from_env joins through env:// as the rank and world size of the
    environment say; a CPU rank is a gloo rank (its card would be
    LOCAL_RANK's)."""
    import torch
    import torch.distributed as dist

    from bcalm_tpu_torch.parallel import launch

    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    for key, val in (("RANK", "5"), ("WORLD_SIZE", "8"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(key, val)
    threads = torch.get_num_threads()
    try:
        mesh = launch.init_from_env("cpu")
    finally:
        torch.set_num_threads(threads)
    assert (mesh.n_dev, mesh.rank, mesh.device) == (8, 5, torch.device("cpu"))
    assert seen == {"backend": "gloo", "init_method": "env://",
                    "world_size": 8, "rank": 5}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    from bcalm_tpu_torch.parallel import launch

    n_local, n_dev, rank_base = (int(x) for x in sys.argv[1:4])
    launch.spawn_host(n_local, n_dev, rank_base, sys.argv[4], "cpu",
                      rank_work, sys.argv[5])
