"""K4 chain decomposition (plain path on the CPU) vs bcalm_tpu.ops.chains.

Successor graphs are mirror-symmetric paths and cycles over random
orientations, with invalid tail nodes.  The port always runs the plain
doubling; it must equal JAX's plain variant and, on a graph of 2**17
oriented nodes (one hierarchical level), JAX's hierarchical variant.
Exact equality.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from bcalm_tpu.ops import chains as jchains
from bcalm_tpu_torch.ops import chains as tchains
import torch


def successor_graph(N: int, n_valid: int, seed: int, cycle_frac: float):
    """(2N,) succ: chains of random length over a permutation of the valid
    vertices, each vertex in a random orientation, some closed as cycles;
    every edge also sets its mirror edge."""
    rng = np.random.RandomState(seed)
    succ = np.full(2 * N, -1, np.int32)
    order = rng.permutation(n_valid)
    i = 0
    while i < n_valid:
        m = int(min(n_valid - i, rng.geometric(0.02)))
        oids = order[i:i + m] + N * rng.randint(0, 2, m)
        ring = m > 1 and rng.rand() < cycle_frac
        nxt = np.roll(oids, -1)
        stop = m if ring else m - 1
        for a, b in zip(oids[:stop], nxt[:stop]):
            succ[a] = b
            succ[(b + N) % (2 * N)] = (a + N) % (2 * N)
        i += m
    valid = (np.arange(2 * N) % N) < n_valid
    return succ, valid


def assert_info_equal(tinfo, jinfo):
    n = int(jinfo["n_unitigs"])
    assert int(tinfo["n_unitigs"]) == n
    for key in ("uid", "rank"):
        np.testing.assert_array_equal(tinfo[key].numpy(), np.asarray(jinfo[key]))
    for key in ("start_oid", "length", "circular"):
        np.testing.assert_array_equal(tinfo[key].numpy()[:n],
                                      np.asarray(jinfo[key])[:n])


@pytest.mark.parametrize("N,n_valid,cycle_frac", [
    (64, 60, 0.5), (1024, 1000, 0.2), (4096, 4096, 0.05)])
def test_chain_decompose_matches_plain(N, n_valid, cycle_frac):
    succ, valid = successor_graph(N, n_valid, N, cycle_frac)
    jinfo = jchains.chain_decompose(jnp.asarray(succ), jnp.asarray(valid),
                                    variant="plain")
    tinfo = tchains.chain_decompose(torch.from_numpy(succ.astype(np.int64)),
                                    torch.from_numpy(valid))
    assert_info_equal(tinfo, jinfo)
    assert bool(tinfo["circular"][: int(tinfo["n_unitigs"])].any())


def test_chain_decompose_matches_hier():
    N = 1 << 16                       # M = 2**17 oriented nodes
    succ, valid = successor_graph(N, N - 100, 17, 0.1)
    jinfo = jchains.chain_decompose(jnp.asarray(succ), jnp.asarray(valid),
                                    variant="hier")
    assert int(jinfo["n_unitigs"]) >= 0
    tinfo = tchains.chain_decompose(torch.from_numpy(succ.astype(np.int64)),
                                    torch.from_numpy(valid))
    assert_info_equal(tinfo, jinfo)


def test_jump_round_saturates_cycles():
    """A long cycle's dist saturates at _DMASK without touching the flags
    and the round cap ends the loop (ptr never settles on a cycle)."""
    M = 8
    Q = torch.tensor([[(v + 1) % M, tchains._DMASK - 1, v, 0] for v in range(M)],
                     dtype=torch.int64)
    Qn = tchains.jump_round_plain(Q)
    assert torch.all(Qn[:, 1] == tchains._DMASK)
    pred = torch.tensor([(v - 1) % M for v in range(M)])
    state = tchains.plain_jumpF(pred, torch.ones(M, dtype=torch.bool))
    assert not torch.any(state[:, 1] & tchains._F_ROOTED)
    jstate = jchains.plain_jumpF(jnp.asarray(pred.numpy().astype(np.int32)),
                                 jnp.ones(M, bool))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))


def converge_case(case: str):
    """(pred, valid, dist0) of a chain forest with weights, of a graph that
    is converged at the first round (every node a root), and of a cycle of
    200 nodes, whose cap of 10 rounds (1, then batches of 4) ends the last
    batch after one round."""
    rng = np.random.RandomState(5)
    if case == "forest":
        M = 3000
        order = rng.permutation(M)
        pred = np.full(M, -1)
        starts = rng.rand(M) < 0.02
        starts[0] = True
        pred[order] = np.where(starts, -1, np.roll(order, 1))
        valid = rng.rand(M) < 0.97
        dist0 = rng.randint(1, 40, M)
    elif case == "converged":
        M = 500
        pred, valid, dist0 = np.full(M, -1), np.ones(M, bool), np.ones(M, int)
    else:
        M = 200
        pred = (np.arange(M) - 1) % M
        valid, dist0 = np.ones(M, bool), rng.randint(1, 9, M)
    return pred, valid, dist0


@pytest.mark.parametrize("case", ["forest", "converged", "cycle"])
def test_converge_flags_match_jax(case):
    """The converging phase in its plain form (a flag word a round, one
    round and then batches of _BATCH, one host read a batch) against JAX's
    plain_jumpF and against the deepest level's _phase on the same state;
    the rounds launched, moved and the syncs as the flags say."""
    pred, valid, dist0 = converge_case(case)
    M = pred.shape[0]
    tp, tv, td = (torch.from_numpy(pred.astype(np.int64)),
                  torch.from_numpy(valid), torch.from_numpy(dist0.astype(np.int64)))
    tchains.reset_rounds()
    state = tchains.plain_jumpF(tp, tv, td)
    jp, jv = jnp.asarray(pred.astype(np.int32)), jnp.asarray(valid)
    jd = jnp.asarray(dist0.astype(np.int32))
    np.testing.assert_array_equal(state.numpy(),
                                  np.asarray(jchains.plain_jumpF(jp, jv, jd)))
    cap = tchains.max_rounds(M) + 1
    rounds = dict(tchains.ROUNDS)
    batch = tchains._BATCH
    assert rounds["syncs"] == 1 - (-(rounds["launched"] - 1) // batch)
    if case == "converged":
        assert rounds == {"launched": 1, "moved": 0, "syncs": 1}
    elif case == "cycle":
        assert (cap - 1) % batch == 1
        assert rounds == {"launched": cap, "moved": cap,
                          "syncs": 1 - (-(cap - 1) // batch)}
    else:
        assert 0 < rounds["moved"] < rounds["launched"] < cap
    # the deepest level of hier_jump runs the same phase on its own state
    Q0 = tchains.init_state(tp, tv, td[torch.clamp(tp, 0, M - 1)])
    got = tchains._phase(Q0.clone(), None, None, None, cap)
    want = jchains._phase(jnp.asarray(Q0.numpy().astype(np.int32)),
                          jnp.zeros((M,), bool),
                          jnp.arange(M, dtype=jnp.int32), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
