"""CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: each test asks the `card` fixture for a device and skips
when torch has no CUDA device (the kernels have no CPU mode).  The file
imports no JAX, so a GPU machine without JAX runs it with
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`.
Every kernel does integer work: exact equality.
"""

import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from bcalm_tpu_torch import engine
from bcalm_tpu_torch.io import fasta_writer, packing
from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.models import minimizer as mz
from bcalm_tpu_torch.oracle import brute
from bcalm_tpu_torch.ops import _kernels, chains, count, extract, junctions
from bcalm_tpu_torch.ops import runchains, superkmer
from bcalm_tpu_torch.ops import sort as sort_op
from bcalm_tpu_torch.parallel import distcompact, launch, pipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def reads(seed, n=300, k=31):
    rng = np.random.RandomState(seed)
    genome = "".join("ACGT"[c] for c in rng.randint(0, 4, 3000))
    out = []
    for _ in range(n):
        i = rng.randint(0, 2900)
        out.append(genome[i:i + rng.randint(k - 3, k + 70)])
    return out + ["ACGTN" * 30, genome[:500]]


@pytest.mark.parametrize("k", [7, 21, 31, 33, 63, 127])
def test_extract_insert(card, k):
    L = ln.num_lanes(k)
    for b in packing.iter_blocks(reads(k, k=k), k, block_reads=64, max_len=128):
        F = extract.block_slots(b.words.shape, k)
        words = torch.from_numpy(b.words.astype(np.int64)).to(card)
        lengths = torch.from_numpy(b.lengths.astype(np.int64)).to(card)
        bufs = [torch.full((L + 1, F + 9), 7, dtype=torch.int64, device=card)
                for _ in range(2)]
        _kernels.extract_insert(bufs[0], words, lengths, k, 0x7FFFFF00, 9)
        extract.extract_insert_plain(bufs[1], words, lengths, k, 0x7FFFFF00, 9)
        assert torch.equal(bufs[0], bufs[1])


def count_inputs(lanes):
    """K2's inputs from entry-order (L, N) lanes, as count_canonical makes
    them: (top, perm, lower, L)."""
    L = lanes.shape[0]
    keys = ln.pack_rows(lanes)
    perm, top = sort_op.lex_sort_words(list(keys))
    return top, perm, keys[1:] if L > 2 else None, L


@pytest.mark.parametrize("L,weighted", [(1, False), (2, True), (4, False),
                                        (3, True)])
def test_count_runs(card, L, weighted):
    """K2 on the sort's output against its plain version and against the
    reduction of lexsorted columns; 10% sentinel columns, and columns
    whose first two lanes are the sentinel and the rest not (valid)."""
    rng = np.random.RandomState(L)
    pool = rng.randint(0, 2**32, size=(L, 300), dtype=np.uint64)
    lanes = torch.from_numpy(pool[:, rng.randint(0, 300, 50_000)].astype(np.int64))
    lanes[:, rng.rand(50_000) < 0.1] = ln.SENTINEL
    if L > 2:
        lanes[:2, rng.rand(50_000) < 0.05] = ln.SENTINEL
    w = torch.from_numpy(rng.randint(1, 9, 50_000)) if weighted else None
    pos = torch.from_numpy(rng.randint(0, 2**32, 50_000, dtype=np.uint64).astype(np.int64))
    args = [t if t is None or isinstance(t, int) else t.to(card)
            for t in count_inputs(lanes) + (w, pos)]
    got = _kernels.count_sorted(*args)
    perm = torch.from_numpy(np.lexsort(tuple(lanes.numpy()[::-1])))
    for a, b, c in zip(got, count.count_sorted_plain(*args), count.count_runs_plain(
            lanes[:, perm], None if w is None else w[perm], pos[perm])):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def sorted_pairs_inputs(keys, pay, K=None):
    """K3b's inputs from K3a's keys and payload: (s_word, perm, payload,
    K, lower), the sort's own top word and permutation.  keys: the K key
    lanes as rows (K <= 3), or the packed words of a key of K lanes."""
    K = keys.shape[0] if K is None else K
    if keys.shape[0] == K:
        perm, s_word = sort_op.lex_sort(list(keys))
        return s_word, perm, pay, K, keys[2:] if K == 3 else None
    perm, s_word = sort_op.lex_sort_words(list(keys))
    return s_word, perm, pay, K, keys[1:] if keys.shape[0] > 1 else None


# 1, 2 and 3 key rows (k = 13, 31-32, 49), then the packed words of 4
# lanes (63), W = 3, 5, 8 and 16 (97, 151, 255, 512)
@pytest.mark.parametrize("k", [13, 31, 32, 49, 63, 97, 151, 255, 512])
def test_junctions(card, k):
    """K3a, then K3b on the sort's word and permutation (and past one word
    the lower words), each bitwise against its plain version."""
    L = ln.num_lanes(k)
    kmers = sorted(brute.count_kmers(reads(k, k=k), k))
    cols = [[(x >> (32 * (L - 1 - j))) & 0xFFFFFFFF for x in kmers]
            for j in range(L)]
    solid = torch.tensor(cols, dtype=torch.int64, device=card)
    n = solid.shape[1]
    keys, pay = _kernels.junction_keys(solid, n - 3, k,
                                       junctions.packed_keys(k),
                                       junctions.key_rows(k))
    pkeys, ppay = junctions.junction_keys_plain(solid, n - 3, k)
    assert torch.equal(keys, pkeys) and torch.equal(pay, ppay)
    assert keys.shape[0] == (junctions.key_words(k) if k > 49 else ln.num_lanes(k - 1))
    s_word, perm, pay, K, lower = sorted_pairs_inputs(keys, pay,
                                                      ln.num_lanes(k - 1))
    succ = _kernels.junction_pairs(s_word, perm, pay, n, K, lower)
    assert torch.equal(succ, junctions.junction_pairs_plain(
        s_word, perm, pay, n, K, lower))
    assert torch.equal(succ.cpu(), junctions.successor_arrays(
        solid.cpu(), n - 3, k))
    assert int((succ >= 0).sum()) > 0


@pytest.mark.parametrize("k", [65, 97])
def test_junctions_first_lane_all_g(card, k):
    """k-1 a multiple of 16, past 3 lanes: the junction (k-1)-mer G^16 X
    C^16 of a read, whose top packed word reads as the sentinel's, is
    glued by K3b as by the plain pair rule, and the read is one unitig."""
    m = k - 1
    rng = np.random.RandomState(k)
    while True:
        mid = "".join("ACGT"[c] for c in rng.randint(0, 4, m - 32))
        x = "G" * 16 + mid + "C" * 16
        if (brute.canonical_num(brute.str2num(x), m) == brute.str2num(x)
                and brute.revcomp_str(x) != x):
            break
    read = "".join("ACGT"[c] for c in rng.randint(0, 4, 30)) + x + "TTGACCA"
    L = ln.num_lanes(k)
    kmers = sorted(brute.count_kmers([read], k))
    solid = torch.tensor([[(v >> (32 * (L - 1 - j))) & 0xFFFFFFFF
                           for v in kmers] for j in range(L)],
                         dtype=torch.int64)
    n = solid.shape[1]
    want = junctions.successor_arrays(solid, n, k)
    got = junctions.successor_arrays(solid.to(card), n, k)
    assert torch.equal(got.cpu(), want)
    # a path of n k-mers: n - 1 edges, each with its mirror
    assert int((want >= 0).sum()) == 2 * (n - 1)


def packed(keys: torch.Tensor, K: int) -> torch.Tensor:
    """K key lanes as K3a writes them: rows up to 3 lanes, else packed
    words (models.lanes.pack_rows)."""
    return keys if K <= 3 else ln.pack_rows(keys)


def pair_groups(K: int, C: int, seed: int):
    """Keys (K3a's layout of K lanes: rows, or packed words past 3) and
    payload (2C,) of 2C junction entries (entry i < C the suffix of vertex
    i, C + i its prefix, payloads by K3a's rule with random strands) in
    groups of 1-4 equal keys, most of two, in a random entry order; a
    fifth of the keys share all but the last lane with the key before,
    past 3 lanes a tenth only the first two (the top word); 5% have the
    sentinel as their first lane, and half of those as every lane (K3a's
    invalid entries): past 3 lanes the others are valid keys.  The groups are laid out in key order, a
    group of two at entry 1023 of every 1024-entry tile."""
    rng = np.random.RandomState(seed)
    E = 2 * C
    sig, tau = rng.randint(0, 2, C), rng.randint(0, 2, C)
    ids = np.arange(C)
    pay = np.concatenate([(ids + C * sig) | (sig << 30),
                          (ids + C * tau) | ((1 - tau) << 30)])
    pool = rng.randint(0, 2**32, size=(K, E), dtype=np.uint64).astype(np.int64)
    share = np.flatnonzero(rng.rand(E) < 0.2)[1:]
    pool[:K - 1, share] = pool[:K - 1, share - 1]
    if K > 3:
        share = np.flatnonzero(rng.rand(E) < 0.1)[1:]
        pool[:2, share] = pool[:2, share - 1]
    r = rng.rand(E)
    pool[:1, r < 0.05] = ln.SENTINEL
    pool[:, r < 0.025] = ln.SENTINEL
    pool = pool[:, np.lexsort(tuple(pool[::-1]))]
    keys = np.empty((K, E), np.int64)
    order = rng.permutation(E)
    a = g = 0
    while a < E:
        size, pos = rng.choice([1, 2, 2, 2, 3, 4]), a % 1024
        size = 2 if pos == 1023 else min(size, 1023 - pos)
        keys[:, order[a:a + size]] = pool[:, g, None]
        a += size
        g += 1
    return packed(torch.from_numpy(keys), K), torch.from_numpy(pay)


# key lanes: 1, 2 and 3 rows, then W = 2, 3, 5, 8 and 16 packed words
@pytest.mark.parametrize("K", [1, 2, 3, 4, 6, 10, 16, 32])
@pytest.mark.parametrize("C", [5000, 2048])
def test_junction_pairs_tiles(card, K, C):
    """K3b against its plain version on groups of 1-4 equal keys, pair
    heads at the last entry of a 1024-entry tile (the partner in the next
    tile), E = 2C not (C = 5000) and exactly (2048) a multiple of the
    tile; run twice for equal bytes."""
    keys, pay = pair_groups(K, C, seed=K + C)
    s_word, perm, pay, K, lower = sorted_pairs_inputs(keys, pay, K)
    heads = junctions.pair_heads(s_word, None if lower is None
                                 else lower[:, perm], K,
                                 junctions.exact_sentinel(K))
    assert bool(heads[1023::1024].any()) and int(heads.sum()) > C // 4
    want = junctions.junction_pairs_plain(s_word, perm, pay, C, K, lower)
    args = [t if t is None else t.to(card) for t in (s_word, perm, pay)]
    low = None if lower is None else lower.to(card)
    for _ in range(2):
        got = _kernels.junction_pairs(*args, C, K, low)
        assert torch.equal(got.cpu(), want)
    assert int((want >= 0).sum()) > C // 4


def ring_pairs(K: int, C: int, linked: bool, seed: int):
    """Keys of K lanes (K3a's layout) and payload (2C,) in a random entry
    order: linked, vertex i's suffix (OUT) shares a key with vertex i+1's
    prefix (IN) in a ring, so every one of the 2C slots of succ gets an
    edge; else every key is distinct and no slot gets one."""
    rng = np.random.RandomState(seed)
    ids = np.arange(C)
    pay = np.concatenate([ids, ids | (1 << 30)])   # all strands +
    pool = rng.randint(0, 2**31, size=(K, 2 * C), dtype=np.uint64)
    pool[-1] = np.arange(2 * C)   # distinct keys
    keys = pool.astype(np.int64)
    if linked:
        keys[:, C + (ids + 1) % C] = keys[:, ids]
    order = torch.from_numpy(rng.permutation(2 * C))
    return (packed(torch.from_numpy(keys), K)[:, order].contiguous(),
            torch.from_numpy(pay)[order].contiguous())


@pytest.mark.parametrize("case,C", [
    ("no_edge", 20000), ("every_slot", 20000),
    ("partial_window", 3 * 8192 + 77), ("every_slot", (1 << 23) + 4099)])
@pytest.mark.parametrize("K", [1, 3, 10])
def test_junction_pairs_windows(card, case, C, K):
    """K3b's windowed succ: no edge (every slot -1), every slot written (a
    ring), random groups in a succ whose 2C is not a multiple of the
    16384-slot window, and 2C past 2^24 (more windows than one block
    stages, so the pair rule runs once a window group); one-word,
    two-word and five-word keys (1, 3 and 10 lanes); on poisoned memory,
    twice."""
    if case == "partial_window":
        keys, pay = pair_groups(K, C, seed=C + K)
    else:
        keys, pay = ring_pairs(K, C, case == "every_slot", seed=K)
    s_word, perm, pay, K, lower = [t.to(card) if isinstance(t, torch.Tensor)
                                   else t for t in sorted_pairs_inputs(
                                       keys.to(card), pay.to(card), K)]
    want = junctions.junction_pairs_plain(s_word, perm, pay, C, K, lower)
    n_edge = int((want >= 0).sum())
    if case == "partial_window":
        assert 2 * C % _kernels.SCATTER_WINDOW and n_edge > C // 4
    else:
        assert n_edge == (2 * C if case == "every_slot" else 0)
    for _ in range(2):
        poisoned(card, 16 * C + (1 << 20))
        before = _kernels.LAUNCHES["junction_pairs"]
        got = _kernels.junction_pairs(s_word, perm, pay, C, K, lower)
        assert _kernels.LAUNCHES["junction_pairs"] == before + 1
        assert torch.equal(got, want)


def test_jump_round(card):
    rng = np.random.RandomState(0)
    M = 4096
    pred = torch.from_numpy(np.where(rng.rand(M) < 0.9, rng.randint(0, M, M), -1))
    Q = chains.init_state(pred, torch.ones(M, dtype=torch.bool)).to(card)
    for _ in range(4):
        Qn = torch.empty_like(Q)
        changed = torch.zeros(1, dtype=torch.int32, device=card)
        _kernels.jump_round(Q, Qn, changed)
        want = chains.jump_round_plain(Q)
        assert torch.equal(Qn, want)
        assert bool(changed.item()) == (not torch.equal(want, Q))
        Q = Qn


def flag_graph(M: int):
    """(pred, valid) of chains of geometric length (mean 40) in a random
    order, 3% of the nodes not valid."""
    rng = np.random.RandomState(M % 1000)
    order = rng.permutation(M)
    starts = rng.rand(M) < 1 / 40
    starts[0] = True
    pred = np.full(M, -1)
    pred[order] = np.where(starts, -1, np.roll(order, 1))
    return torch.from_numpy(pred), torch.from_numpy(rng.rand(M) < 0.97)


def test_round_flag_mode(card):
    """K4's flag mode: from a poisoned Qn, each round writes the plain
    version's next state and its flag word; after the round that moved no
    row every launch returns at once (a poisoned Qn stays poisoned, its
    word stays 0) and both buffers hold the plain version's converged
    state; the converging phase counts its launches, the rounds that moved
    a row and one sync a batch."""
    M = (1 << 16) + 77
    pred, valid = flag_graph(M)
    Q0 = chains.init_state(pred, valid)
    states = [Q0]
    while len(states) < 2 or not torch.equal(states[-1], states[-2]):
        states.append(chains.jump_round_plain(states[-1]))
    k = len(states) - 2            # round k is the first that moved no row
    rounds = k + 3
    flags = torch.zeros(rounds, dtype=torch.int32, device=card)
    A = Q0.to(card)
    B = torch.full_like(A, -7)
    for r in range(rounds):
        _kernels.jump_round(A, B, flags, at=r)
        A, B = B, A
        want = states[min(r + 1, k + 1)]
        assert torch.equal(A.cpu(), want)
        if r > k:
            assert torch.equal(B.cpu(), want)
    assert flags.tolist() == [1] * k + [0] * 3
    poison = torch.full_like(A, -7)
    _kernels.jump_round(A, poison, flags, at=rounds - 1)
    assert bool((poison == -7).all()) and int(flags[-1]) == 0
    chains.reset_rounds()
    before = _kernels.LAUNCHES["jump_round"]
    got = chains.plain_jumpF(pred.to(card), valid.to(card))
    assert torch.equal(got.cpu(), states[-1])
    n = chains.ROUNDS
    assert n["launched"] == _kernels.LAUNCHES["jump_round"] - before
    assert n["moved"] == k
    assert n["syncs"] == 1 - (-(n["launched"] - 1) // chains._BATCH)
    assert n["launched"] == min(chains.max_rounds(M) + 1,
                                1 + chains._BATCH * (n["syncs"] - 1))


@pytest.mark.parametrize("k", [21, 31, 63])
def test_build_card_equals_cpu(card, k):
    seqs = reads(k + 1, n=600, k=k)
    cfg = engine.EngineConfig(k=k, abundance_min=2, block_reads=64, max_len=128,
                              chunk_kmers=20_000)
    outs = []
    for dev in (card, "cpu"):
        buf = io.StringIO()
        fasta_writer.write_fasta(engine.build_from_seqs(seqs, cfg, dev), buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0]


_FIRST_CUDA_CALL = """
from bcalm_tpu_torch import engine
reads = ["ACTGATGCAGATGACACTGATGCAGATGACTTGACCA"] * 3 + ["GGTACCATGACACTGATGCAG"]
us = engine.build_from_seqs(reads, engine.EngineConfig(k=15, abundance_min=2),
                            "cuda")
assert us.seqs and us.stats["device_peak_mb"] >= 0
print("OK")
"""


def test_build_as_first_cuda_call(card):
    """engine.build_from_seqs as the first CUDA call of a process (a fresh
    interpreter): it resets the peak-memory statistics, which exist only
    once CUDA is initialised."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _FIRST_CUDA_CALL], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


def random_body(L, n, seed):
    """(L+1, n) body: key lanes from a small pool (equal prefixes are
    common), a pos row, ~15% sentinel columns."""
    rng = np.random.RandomState(seed)
    pool = rng.randint(0, 4, size=(L, 6)).astype(np.int64) << 30
    lanes = pool[np.arange(L)[:, None], rng.randint(0, 6, size=(L, n))]
    lanes += rng.randint(0, 3, size=(L, n))
    body = np.concatenate([lanes, rng.randint(0, 2**31, size=(1, n))])
    body[:, rng.rand(n) < 0.15] = ln.SENTINEL
    return torch.from_numpy(body)


@pytest.mark.parametrize("L", [1, 2, 4])
def test_range_fold(card, L):
    body = random_body(L, 70_000, L)
    rng = np.random.RandomState(L)
    keys = [tuple(body[:L, rng.randint(0, body.shape[1])].tolist())
            for _ in range(4)]
    ranges = [((0,) * L, (ln.SENTINEL,) * L), (min(keys[:2]), max(keys[:2])),
              (keys[2], (ln.SENTINEL,) * L), ((0,) * L, keys[3])]
    wide = torch.full((L + 1, body.shape[1] + 5), 3, dtype=torch.int64)
    for lo, hi in ranges:
        # a column slice of a wider buffer, as the chunk buffer is
        wide[:, :body.shape[1]] = body
        got_buf = wide.to(card)
        got = _kernels.range_fold(got_buf[:, :body.shape[1]], lo, hi)
        want_buf = wide.clone()
        want = count.range_fold_plain(want_buf[:, :body.shape[1]], lo, hi)
        assert torch.equal(got_buf.cpu(), want_buf)
        assert int(got[0]) == int(want[0])


@pytest.mark.parametrize("L", [1, 2, 3])
def test_lower_bound(card, L):
    body = random_body(L, 50_000, 7 + L)
    unique, _, _, n = count.count_canonical(body[:L].contiguous())
    n = int(n)
    rng = np.random.RandomState(L)
    cols = [unique[:, rng.randint(0, n)] for _ in range(6)]
    cols += [torch.zeros(L, dtype=torch.int64),
             torch.full((L,), ln.SENTINEL, dtype=torch.int64), unique[:, n - 1]]
    bounds = torch.stack(cols, dim=1).contiguous()
    for m in (n, n // 2, 1, 0):
        got = _kernels.lower_bound(unique.to(card), m, bounds.to(card))
        assert torch.equal(got.cpu(), count.lower_bound_plain(unique, m, bounds))


@pytest.mark.parametrize("histo_max", [10000, 7, 20000])
def test_solid_fold_histogram(card, histo_max):
    rng = np.random.RandomState(histo_max)
    N, L = 300_000, 2
    unique = torch.from_numpy(rng.randint(0, 2**32, size=(L, N), dtype=np.uint64).astype(np.int64))
    counts = torch.from_numpy(np.minimum(rng.geometric(0.2, N), 30000))
    minpos = torch.from_numpy(rng.randint(0, 2**31, N))
    args = (N - 1000, 2, 50, histo_max)
    got = _kernels.solid_fold_histogram(unique.to(card), counts.to(card),
                                        minpos.to(card), *args)
    want = count.solid_fold_histogram_plain(unique, counts, minpos, *args)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


RUN_TILE = _kernels.RUNSCAN_TILE


def succ_with_heads(C, n_solid, heads, gbase=0, seed=0, last_links=False):
    """A (2C,) successor array whose runs over [0, n_solid) start exactly
    at `heads` (0 among them): entry i links to i+1 unless i+1 is a head;
    a run's last entry links nowhere (or, for the last run when
    last_links, on to n_solid), the minus half is random."""
    rng = np.random.RandomState(seed)
    succ = np.where(rng.rand(2 * C) < 0.3, -1, rng.randint(0, 2 * C, 2 * C))
    idx = np.arange(C)
    succ[:C] = gbase + idx + 1
    cut = np.zeros(C + 1, bool)
    cut[np.asarray(heads, np.int64)] = True
    ends = cut[1:C + 1] | (idx >= n_solid - 1)
    succ[:C] = np.where(ends, -1, succ[:C])
    if last_links and 0 < n_solid < C:
        succ[n_solid - 1] = gbase + n_solid
    return torch.from_numpy(succ)


def check_runs(card, succ, n_solid, C, gbase=0):
    """K8 and then K12a on its output, bitwise against the plain versions."""
    got = _kernels.run_scans(succ.to(card), n_solid, C, gbase)
    want = runchains.run_scans_plain(succ, n_solid, C, gbase)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    is_head, _, rid, _, end_pos, R = want
    R = int(R[0])
    R_cap = runchains.round_capacity(R)
    cargs = (is_head, rid, end_pos, R, R_cap)
    got = _kernels.run_contract(succ.to(card), *[a.to(card) for a in cargs[:3]],
                                R, R_cap)
    for a, b in zip(got, runchains.run_contract_plain(succ, *cargs)):
        assert torch.equal(a.cpu(), b)
    return R


def run_case(case, C, n_solid):
    """The run structures of test_run_scans beside its random links."""
    T = RUN_TILE
    if case == "one_run":                       # R = 1 over many tiles
        return succ_with_heads(C, n_solid, [0])
    if case == "tile_heads":                    # heads on tile boundaries,
        heads = [0, T - 1, T, 2 * T, 2 * T + 1, 5 * T, 9 * T - 1]
        return succ_with_heads(C, n_solid, heads)   # runs over several tiles
    if case == "tile_tails":                    # runs end on a tile's last
        heads = [0] + [j * T for j in range(1, C // T)]  # entry, n_solid-1 too
        return succ_with_heads(C, n_solid, heads)
    if case == "open_end":                      # the last run links on past
        return succ_with_heads(C, n_solid, [0, 5000], last_links=True)
    if case == "no_links":                      # every entry a run
        return succ_with_heads(C, n_solid, np.arange(C))
    if case == "r_eq_cap":                      # R = 64 = R_cap
        heads = np.sort(np.random.RandomState(64).choice(
            np.arange(1, n_solid), 63, replace=False))
        return succ_with_heads(C, n_solid, np.concatenate([[0], heads]))
    raise ValueError(case)


@pytest.mark.parametrize("C,n_solid,case", [
    pytest.param(16, 16, None, id="16-16"),
    pytest.param(1024, 1000, None, id="1024-1000"),
    pytest.param(1 << 20, 900_000, None, id="1048576-900000"),
    pytest.param(4096, 0, None, id="4096-0"),
    pytest.param(5 * RUN_TILE + 7, 5 * RUN_TILE + 7, None, id="n_eq_C"),
    pytest.param(3 * RUN_TILE + 1, 0, None, id="n_zero"),
    pytest.param(3 << 20, 3 << 20, "one_run", id="one_run_n_eq_C"),
    pytest.param((1 << 20) + 5, (1 << 20) - 3, "one_run", id="one_run"),
    pytest.param(12 * RUN_TILE, 11 * RUN_TILE - 40, "tile_heads", id="tile_heads"),
    pytest.param(16 * RUN_TILE, 12 * RUN_TILE, "tile_tails", id="tile_tails"),
    pytest.param(8 * RUN_TILE, 9000, "open_end", id="open_end"),
    pytest.param(3 * RUN_TILE + 9, 3 * RUN_TILE + 2, "no_links", id="no_links"),
    pytest.param(40_000, 37_000, "r_eq_cap", id="r_eq_cap"),
])
def test_run_scans(card, C, n_solid, case):
    """K8 against its plain version on random links (about one entry in
    ten a run head) and on run structures at the look-back tiles' edges;
    K12a on each result."""
    if case is None:
        rng = np.random.RandomState(C)
        idx = np.arange(2 * C)
        succ = np.where(rng.rand(2 * C) < 0.3, -1, rng.randint(0, 2 * C, 2 * C))
        succ[:C] = np.where(rng.rand(C) < 0.9, idx[:C] + 1, succ[:C])
        succ = torch.from_numpy(succ)
    else:
        succ = run_case(case, C, n_solid)
    R = check_runs(card, succ, n_solid, C)
    if case == "one_run":
        assert R == 1
    if case == "r_eq_cap":
        assert R == runchains.round_capacity(R) == 64


@pytest.mark.parametrize("k", [21, 31])
def test_multipass_build_card_equals_cpu(card, k):
    seqs = reads(k + 2, n=600, k=k)
    cfg = engine.EngineConfig(k=k, abundance_min=2, block_reads=4,
                              max_len=128, chunk_kmers=512, resident_kmers=1024)
    outs = []
    for dev in (card, "cpu"):
        us = engine.build_from_seqs(seqs, cfg, dev)
        assert us.stats["ooc_passes"] > 1
        buf = io.StringIO()
        fasta_writer.write_fasta(us, buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("L,amin,amax", [(1, 2, 2**31 - 1), (2, 3, 40),
                                         (4, 1, 1)])
def test_solid_compact(card, L, amin, amax):
    rng = np.random.RandomState(L)
    N = 300_000
    unique = torch.from_numpy(rng.randint(0, 2**32, size=(L, N), dtype=np.uint64).astype(np.int64))
    counts = torch.from_numpy(rng.geometric(0.3, N))
    minpos = torch.from_numpy(rng.randint(0, 2**31, N))
    args = (N - 777, amin, amax)
    out, n = _kernels.solid_compact(unique.to(card), counts.to(card),
                                    minpos.to(card), *args)
    want, want_n = count.solid_compact_plain(unique, counts, minpos, *args)
    assert torch.equal(out.cpu(), want) and torch.equal(n.cpu(), want_n)
    w = int(want_n[0])
    narrow, _ = _kernels.solid_compact(unique.to(card), counts.to(card),
                                       minpos.to(card), *args, width=w)
    assert torch.equal(narrow.cpu(), want[:, :w])


def mirror_graph(N: int, seed: int, long_cycle: int = 0, n_invalid: int = 8):
    """(2N,) succ (int64) and valid (bool) numpy arrays of a
    mirror-symmetric graph: first one cycle of `long_cycle` nodes (none
    for 0), then chains and cycles of geometric length (mean 100) over the
    other valid vertices in random orientations, a third of the
    single-vertex chains hairpins (v -> mirror(v)); the last n_invalid
    vertices invalid.  tests/test_torch_hier.py uses it too."""
    rng = np.random.RandomState(seed)
    n_valid = N - n_invalid
    succ = np.full(2 * N, -1, np.int64)
    order = rng.permutation(n_valid)
    i = 0
    while i < n_valid:
        first = i == 0 and long_cycle > 0
        m = long_cycle if first else int(min(n_valid - i, rng.geometric(0.01)))
        oids = order[i:i + m] + N * rng.randint(0, 2, m)
        if m == 1 and rng.rand() < 0.3:
            succ[oids[0]] = (oids[0] + N) % (2 * N)
        ring = m > 1 and (first or rng.rand() < 0.2)
        nxt = np.roll(oids, -1)
        stop = m if ring else m - 1
        succ[oids[:stop]] = nxt[:stop]
        succ[(nxt[:stop] + N) % (2 * N)] = (oids[:stop] + N) % (2 * N)
        i += m
    valid = (np.arange(2 * N) % N) < n_valid
    return succ, valid


@pytest.mark.parametrize("N,weighted", [(4096, False), (4096, True),
                                        (1 << 18, False)])
def test_chain_finish(card, N, weighted):
    succ, valid = map(torch.from_numpy, mirror_graph(N, N + weighted))
    pred = chains.build_pred(succ, valid)
    wlen = None
    if weighted:
        w = torch.from_numpy(np.random.RandomState(N).randint(1, 6, N))
        wlen = torch.cat([w, w])
    dist0 = None if wlen is None else wlen[torch.clamp(pred, 0, 2 * N - 1)]
    state = chains.plain_jumpF(pred.to(card), valid.to(card),
                               None if dist0 is None else dist0.to(card))
    got = _kernels.chain_finish(succ.to(card), pred.to(card), valid.to(card),
                                state, None if wlen is None else wlen.to(card))
    want = chains.finish_fast_plain(succ, pred, valid, state.cpu(), wlen)
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key
    assert int(want["n_unitigs"][0]) > 0


def cycles_graph(N: int, seed: int):
    """(2N,) succ and valid of a mirror-symmetric graph whose every chain is
    a cycle: all N vertices, in random orientations, cut into rings of
    2-100 vertices."""
    rng = np.random.RandomState(seed)
    oids = rng.permutation(N) + N * rng.randint(0, 2, N)
    succ = np.full(2 * N, -1, np.int64)
    i = 0
    while i < N:
        m = min(N - i, int(rng.randint(2, 101)))
        if N - i - m == 1:
            m += 1
        ring = oids[i:i + m]
        nxt = np.roll(ring, -1)
        succ[ring] = nxt
        succ[(nxt + N) % (2 * N)] = (ring + N) % (2 * N)
        i += m
    return succ, np.ones(2 * N, bool)


@pytest.mark.parametrize("case,N,weighted", [
    ("empty", 4096, False), ("cycles", 4096, False), ("cycles", 3000, True),
    ("chains", 3000, False), ("chains", (1 << 18) + 777, True)])
def test_chain_finish_lookback(card, case, N, weighted):
    """K10's one-pass selection against its plain version: no valid node
    (n_unitigs 0), every chain a cycle, M = 2N not a multiple of the
    1024-node tile (FINISH_TILE: the N = 3000 and N = 2**18 + 777 cases;
    the N = 4096 ones are multiples of it), weighted and not; run twice for
    equal bytes, the second call on the workspace the first one left."""
    if case == "cycles":
        succ, valid = cycles_graph(N, N)
    else:
        succ, valid = mirror_graph(N, N + 1)
        if case == "empty":
            valid[:] = False
    succ, valid = torch.from_numpy(succ), torch.from_numpy(valid)
    pred = chains.build_pred(succ, valid)
    wlen = dist0 = None
    if weighted:
        w = torch.from_numpy(np.random.RandomState(N).randint(1, 6, N))
        wlen = torch.cat([w, w])
        dist0 = wlen[torch.clamp(pred, 0, 2 * N - 1)]
    state = chains.plain_jumpF(pred, valid, dist0)
    want = chains.finish_fast_plain(succ, pred, valid, state, wlen)
    n = int(want["n_unitigs"][0])
    assert (n == 0) == (case == "empty")
    if case == "cycles":
        assert bool(want["circular"][:n].all())
    args = [None if a is None else a.to(card)
            for a in (succ, pred, valid, state, wlen)]
    keys = ("uid", "rank", "n_unitigs", "start_oid", "length", "circular")
    twice_equal(lambda: [_kernels.chain_finish(*args)[k] for k in keys],
                [want[k] for k in keys])


def compacted(k, seed=5, max_len=128):
    """The port's locality-ordered compaction (CPU) of a read set: the
    reordered table, its counts, the run structure and the chain dict."""
    seqs = reads(seed, n=600, k=k)
    cfg = engine.EngineConfig(k=k, abundance_min=2, block_reads=64,
                              max_len=max_len)
    unique, counts, minpos, _ = engine.count_blocks(
        packing.iter_blocks(seqs, k, block_reads=64, max_len=max_len), cfg,
        "cpu")
    solid, cs, ps, n_solid, _ = count.solid_fold_histogram(
        unique, counts, minpos, unique.shape[1], 2, 2**31 - 1, 10)
    n_solid = int(n_solid[0])
    solid_r, counts_r, info = engine.compact_solid_pos(solid, cs, ps, n_solid, k)
    return solid_r, counts_r, info, n_solid


@pytest.mark.parametrize("k", [21, 31, 63])
def test_spell_unitigs(card, k):
    solid_r, counts_r, info, n_solid = compacted(k)
    U = int(info["n_unitigs"])
    args = [info[key] for key in ("uid", "rank", "length", "start_oid")]
    got = _kernels.spell_unitigs(solid_r.to(card), counts_r.to(card),
                                 *[a.to(card) for a in args], U, k, n_solid)
    want = engine.spell_unitigs_plain(solid_r, counts_r, *args, U, k, n_solid)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert U > 1


@pytest.mark.parametrize("k", [21, 31])
def test_run_contract_broadcast(card, k):
    solid_r, _, _, n_solid = compacted(k)
    succ, scan = runchains.junction_runs(solid_r, n_solid, k)
    R = scan["R"]
    R_cap = runchains.round_capacity(max(1, R))
    cargs = (scan["is_head"], scan["rid"], scan["end_pos"], R, R_cap)
    got = _kernels.run_contract(succ.to(card), *[a.to(card) for a in cargs[:3]],
                                R, R_cap)
    want = runchains.run_contract_plain(succ, *cargs)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    hpos, epos, csucc, cvalid, wlen2 = want
    cinfo = runchains.contracted_jump(csucc, cvalid, wlen2)
    bargs = (cinfo["uid"], cinfo["rank"], cinfo["start_oid"], scan["rid"],
             scan["head_pos"], scan["end_pos"], hpos, epos)
    got = _kernels.run_broadcast(*[a.to(card) for a in bargs], n_solid)
    want = runchains.run_broadcast_plain(*bargs, n_solid)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_multi_sample_cli_card_equals_cpu(card, tmp_path, monkeypatch):
    """-solidity-kind min and max over an album of two read sets (the
    canonical-order compaction), and a store + -skip-bcalm -skip-bglue
    resume: the card writes the CPU's bytes."""
    from bcalm_tpu_torch import cli

    paths = []
    for n in (600, 400):            # one genome: reads() draws it first
        path = tmp_path / f"s{n}.fa"
        path.write_text("".join(f">r{i}\n{r}\n"
                                for i, r in enumerate(reads(11, n=n))))
        paths.append(str(path))
    album = tmp_path / "album.txt"
    album.write_text("\n".join(paths) + "\n")
    for kind in ("min", "max"):
        outs = []
        for dev in ("cuda", "cpu"):
            monkeypatch.setenv(cli.DEVICE_ENV, dev)
            out = str(tmp_path / f"{kind}_{dev}")
            assert cli.main(["-in", str(album), "-kmer-size", "31",
                             "-abundance-min", "1", "-solidity-kind", kind,
                             "-nb-cores", "1", "-verbose", "0", "-out", out]) == 0
            outs.append(open(out + ".unitigs.fa").read())
        assert outs[0] == outs[1] and outs[0]
    monkeypatch.setenv(cli.DEVICE_ENV, "cuda")
    base = ["-in", paths[0], "-kmer-size", "31", "-abundance-min", "2",
            "-verbose", "0"]
    out = str(tmp_path / "resume")
    assert cli.main(base + ["-out", out + "_full"]) == 0
    assert cli.main(base + ["-out", out, "-only-uf"]) == 0
    assert cli.main(base + ["-out", out, "-skip-bcalm", "-skip-bglue"]) == 0
    assert open(out + ".unitigs.fa").read() == open(out + "_full.unitigs.fa").read()


@pytest.mark.parametrize("k", [21, 31, 63])
def test_extract_insert_row_base(card, k):
    """K1 with one stream slot base per row (the received superkmers of
    the -devices N build), wrapping at 2^30."""
    L = ln.num_lanes(k)
    for b in packing.iter_blocks(reads(k, k=k), k, block_reads=64, max_len=128):
        F = extract.block_slots(b.words.shape, k)
        words = torch.from_numpy(b.words.astype(np.int64))
        lengths = torch.from_numpy(b.lengths.astype(np.int64))
        rng = np.random.RandomState(k)
        base = torch.from_numpy(rng.randint(0, 2**32, words.shape[0],
                                            dtype=np.uint64).astype(np.int64))
        bufs = [torch.full((L + 1, F), 7, dtype=torch.int64) for _ in range(2)]
        extract.extract_insert_plain(bufs[1], words, lengths, k, 0, 0, base)
        bufs[0] = bufs[0].to(card)
        _kernels.extract_insert(bufs[0], words.to(card), lengths.to(card), k,
                                0, 0, base.to(card))
        assert torch.equal(bufs[0].cpu(), bufs[1])


@pytest.mark.parametrize("C,n_solid,gbase,long_runs", [
    pytest.param(1024, 1000, 5 << 20, False, id="1024-1000-5242880"),
    pytest.param(1 << 20, 900_000, 3 << 20, False, id="1048576-900000-3145728"),
    pytest.param(20 * RUN_TILE, 19 * RUN_TILE + 3, 7 << 20, True,
                 id="long_runs")])
def test_run_scans_global_base(card, C, n_solid, gbase, long_runs):
    """K8 with a rank's global base: random links, or runs longer than a
    look-back tile (and K12a on them)."""
    if long_runs:
        heads = [0, 3 * RUN_TILE + 5, 4 * RUN_TILE, 11 * RUN_TILE - 1]
        succ = succ_with_heads(C, n_solid, heads, gbase=gbase, last_links=True)
        check_runs(card, succ, n_solid, C, gbase)
        return
    rng = np.random.RandomState(C)
    idx = np.arange(2 * C)
    succ = np.where(rng.rand(2 * C) < 0.3, -1, rng.randint(0, 8 * C, 2 * C))
    succ[:C] = np.where(rng.rand(C) < 0.9, gbase + idx[:C] + 1, succ[:C])
    succ = torch.from_numpy(succ)
    got = _kernels.run_scans(succ.to(card), n_solid, C, gbase)
    want = runchains.run_scans_plain(succ, n_solid, C, gbase)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k", [13, 17, 31, 33, 63])
@pytest.mark.parametrize("n_dev", [1, 4])
def test_junctions_global_mode(card, k, n_dev):
    """K3a/K3b global mode: four entries per k-mer with global oriented ids
    and owner ranks (k = 17: the strand is a key row of its own)."""
    L = ln.num_lanes(k)
    kmers = sorted(brute.count_kmers(reads(k, k=k), k))
    cols = [[(x >> (32 * (L - 1 - j))) & 0xFFFFFFFF for x in kmers]
            for j in range(L)]
    solid = torch.tensor(cols, dtype=torch.int64)
    n = solid.shape[1]
    gbase, tot = 3 * n, 8 * n
    got = junctions.junction_entries(solid.to(card), n - 3, k, gbase, tot, n_dev)
    want = junctions.junction_entries_plain(solid, n - 3, k, gbase, tot, n_dev)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    ent, valid, _ = want
    K = ent.shape[0] - 1
    words, payload, n_t = junctions.junction_words_plain(ent, valid)
    assert_compacted(_kernels.junction_words(ent.to(card), valid.to(card)),
                     (words, payload, n_t))
    perm, top = sort_op.lex_sort_words(words)
    args = (top, perm, words, payload, K, tot, n)
    got = junctions.junction_edges(*[a.to(card) if torch.is_tensor(a) else a
                                     for a in args])
    want = junctions.junction_edges_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int(want[0].sum()) > 0


def received(ent, keep, n_dev, rng):
    """The kept columns of ent shuffled into a receive buffer of n_dev
    buckets, each a valid prefix with zeros after (as K15 and the
    all_to_all leave them): (received (C, n_dev * cap), valid)."""
    cols = torch.nonzero(keep).flatten()
    cols = cols[torch.from_numpy(rng.permutation(cols.numel()))]
    cap = -(-cols.numel() // (n_dev - 1)) + 5
    recv = torch.zeros((ent.shape[0], n_dev * cap), dtype=torch.int64)
    ev = torch.zeros((n_dev * cap,), dtype=torch.bool)
    for b, part in enumerate(torch.tensor_split(cols, n_dev - 1)):
        recv[:, b * cap:b * cap + part.numel()] = ent[:, part]
        ev[b * cap:b * cap + part.numel()] = True
    return recv, ev


def launched(fn, name):
    """fn()'s result, asserting that it added one to LAUNCHES[name] and to
    no other count."""
    before = dict(_kernels.LAUNCHES)
    out = fn()
    assert {n: c - before[n] for n, c in _kernels.LAUNCHES.items()
            if c != before[n]} == {name: 1}
    return out


def assert_compacted(got, want):
    """junction_words' kernel output (capacity E, written at [0, n)) equals
    its plain version's (width n)."""
    words, payload, n_t = got
    n = int(n_t[0])
    assert n == int(want[2][0]) and n_t.shape == (1,)
    assert words.shape[0] == want[0].shape[0]
    assert torch.equal(words[:, :n].cpu(), want[0])
    assert torch.equal(payload[:n].cpu(), want[1])


@pytest.mark.parametrize("k", [17, 31, 33, 63])
def test_junction_edges_global(card, k):
    """K3's global step after the exchange on its interface: the compaction
    of a receive buffer with empty (zero) slots into the sort words and
    payloads of its valid slots (junction_words), the pair rule on the
    sort's own output over those alone, reading the lower words (k = 33,
    63: rows of the compaction's wider output) and a strand row (k = 17,
    33) through perm, over many 1024-entry tiles, and the successor
    shard's scatter of the received edges; each against its plain version
    on poisoned memory, twice, and counted once a launch under its own key
    in LAUNCHES (the pair rule under K3b's junction_pairs)."""
    L = ln.num_lanes(k)
    kmers = sorted(brute.count_kmers(reads(k, n=3000, k=k), k))
    solid = torch.tensor([[(x >> (32 * (L - 1 - j))) & 0xFFFFFFFF for x in kmers]
                          for j in range(L)], dtype=torch.int64)
    n = solid.shape[1]
    slot_cap, n_dev, me = n, 4, 2
    tot = n_dev * slot_cap
    rng = np.random.RandomState(k)
    ent, valid, _ = junctions.junction_entries_plain(solid, n - 3, k,
                                                     me * slot_cap, tot, n_dev)
    K = ent.shape[0] - 1
    recv, ev = received(ent, valid, n_dev, rng)
    E = ev.numel()
    want_c = junctions.junction_words_plain(recv, ev)
    for _ in range(2):
        poisoned(card, 8 * (K + 3) * E + (1 << 20))
        got_c = launched(lambda: _kernels.junction_words(recv.to(card),
                                                         ev.to(card)),
                         "junction_words")
        assert_compacted(got_c, want_c)
    words, payload, n_t = want_c
    nv = int(n_t[0])
    perm, top = sort_op.lex_sort_words(words)
    want = junctions.junction_edges_plain(top, perm, words, payload, K, tot,
                                          slot_cap)
    for _ in range(2):
        poisoned(card, 25 * nv + (1 << 20))
        got = launched(lambda: _kernels.junction_edges(
            top.to(card), perm.to(card), got_c[0][:, :nv], got_c[1][:nv], K,
            tot, slot_cap), "junction_pairs")
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    ok, edges, owner = want
    assert nv > 8 * 1024 and int(ok.sum()) > 1000
    erecv, eev = received(edges, ok, n_dev, rng)
    want = junctions.junction_scatter_plain(erecv, eev, tot, me * slot_cap,
                                            slot_cap)
    for _ in range(2):
        poisoned(card, 16 * slot_cap + (1 << 20))
        got = launched(lambda: _kernels.junction_scatter(
            erecv.to(card), eev.to(card), tot, me * slot_cap, slot_cap),
            "junction_scatter")
        assert torch.equal(got.cpu(), want)
    assert int((want >= 0).sum()) == int(ok.sum())


@pytest.mark.parametrize("case", ["full", "none", "one", "scattered",
                                  "tiles"])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_junction_words_compaction(card, case, K):
    """The compaction in front of the global sort against its plain
    version, on poisoned outputs, twice: no empty slot, no valid slot, one
    valid slot (in the buffer's middle), valid slots scattered over the
    buffer (not bucket prefixes), and a receive buffer of ~300 look-back
    tiles whose valid slots are bucket prefixes; K key rows (the odd last
    row a word of its own), the received stack's rows lying apart (a row
    slice of the exchange's output)."""
    rng = np.random.RandomState(K)
    E = {"tiles": 300 * 4096 + 77}.get(case, 20_000)
    stack = torch.from_numpy(rng.randint(0, 2**32, size=(K + 2, E),
                                         dtype=np.uint64).astype(np.int64))
    rows = stack[:K + 1]
    if case == "full":
        ev = np.ones(E, bool)
    elif case == "none":
        ev = np.zeros(E, bool)
    elif case == "one":
        ev = np.zeros(E, bool)
        ev[E // 2 + 3] = True
    elif case == "scattered":
        ev = rng.rand(E) < 0.37
    else:
        ev = np.zeros(E, bool)
        cap = E // 4
        for b, fill in enumerate((cap, cap // 2, 0, cap - 5)):
            ev[b * cap:b * cap + fill] = True
    ev = torch.from_numpy(ev)
    want = junctions.junction_words_plain(rows, ev)
    for _ in range(2):
        poisoned(card, 8 * (K + 3) * E + (1 << 20))
        got = _kernels.junction_words(stack.to(card)[:K + 1], ev.to(card))
        assert_compacted(got, want)
    assert int(want[2][0]) == int(ev.sum())


@pytest.mark.parametrize("slot_cap", [1, 8192, 8193, 50_000])
@pytest.mark.parametrize("edges_case", ["edges", "none"])
def test_junction_scatter_windows(card, slot_cap, edges_case):
    """The successor shard's scatter by 16384-slot windows against its
    plain version, on poisoned memory, twice: a table of 2 slots, one
    window, one window and 2 slots, several windows (the last one part
    filled); edges at each window's first and last slot and at random
    slots on both strands, many more a tile than a window's stage holds
    (the stage's overflow to the top of the bin), received ids whose local id falls outside the
    table (below the rank's base on the + strand, past its last slot on
    the - strand: dropped) and empty received slots holding garbage; or
    no edge at all (every slot -1)."""
    rng = np.random.RandomState(slot_cap)
    n_dev, me = 3, 1
    tot, base, T = n_dev * slot_cap, me * slot_cap, 2 * slot_cap
    W = _kernels.SCATTER_WINDOW
    ends = np.unique(np.concatenate([np.arange(0, T, W),
                                     np.minimum(np.arange(W - 1, T + W - 1, W),
                                                T - 1)]))
    at = np.unique(np.concatenate([ends, rng.randint(0, T, T // 3 + 1)]))
    at = at[rng.permutation(at.size)]
    a = np.where(at >= slot_cap, at - slot_cap + base + tot, at + base)
    # ids whose local id (JAX's lidx) falls outside [0, T)
    outside = np.array([0, base - 1, tot + base + slot_cap, 2 * tot - 1])
    lidx = np.where(outside >= tot, outside - tot - base + slot_cap,
                    outside - base)
    assert ((lidx < 0) | (lidx >= T)).all()
    src = np.concatenate([a, outside])
    dst = rng.randint(0, 2 * tot, src.size)
    R = 2 * src.size + 9
    edges = torch.from_numpy(rng.randint(-5, 2 * tot, size=(2, R)).astype(np.int64))
    ev = torch.zeros((R,), dtype=torch.bool)
    if edges_case == "edges":
        slots = torch.from_numpy(np.sort(rng.choice(R, src.size, replace=False)))
        edges[0, slots] = torch.from_numpy(src)
        edges[1, slots] = torch.from_numpy(dst)
        ev[slots] = True
    want = junctions.junction_scatter_plain(edges, ev, tot, base, slot_cap)
    for _ in range(2):
        poisoned(card, 8 * T + 16 * R + (1 << 20))
        got = launched(lambda: _kernels.junction_scatter(
            edges.to(card), ev.to(card), tot, base, slot_cap),
            "junction_scatter")
        assert torch.equal(got.cpu(), want)
    assert int((want >= 0).sum()) == (at.size if edges_case == "edges" else 0)


@pytest.mark.parametrize("slot_cap", [(1 << 23) + 8192, 3 << 23])
def test_junction_scatter_many_windows(card, slot_cap):
    """Tables of more windows than a block stages (1,025 and 3,072
    windows: 2 and 3 passes over the received edges), with about 4 edges
    a window in each 4096-slot tile as at phase 3f's shape: against the
    plain version, 3 M edges at random slots and every window's first and
    last slot."""
    rng = np.random.RandomState(5)
    T, W = 2 * slot_cap, _kernels.SCATTER_WINDOW
    ends = np.concatenate([np.arange(0, T, W), np.arange(W - 1, T, W)])
    at = np.unique(np.concatenate([ends, rng.randint(0, T, 3_000_000)]))
    # one rank: a's local id is a itself (base 0, tot = slot_cap)
    at = torch.from_numpy(at[rng.permutation(at.size)]).to(card)
    edges = torch.stack([at, torch.arange(at.numel(), device=card)])
    ev = torch.ones((at.numel(),), dtype=torch.bool, device=card)
    got = _kernels.junction_scatter(edges, ev, slot_cap, 0, slot_cap)
    want = junctions.junction_scatter_plain(edges, ev, slot_cap, 0, slot_cap)
    assert torch.equal(got, want)
    assert int((got >= 0).sum()) == at.numel()


def skm_block(k, m, seed=0):
    b = next(packing.iter_blocks(reads(seed, n=1000, k=k), k, block_reads=1024,
                                 max_len=160))
    words = torch.from_numpy(b.words.astype(np.int64))
    lengths = torch.from_numpy(b.lengths.astype(np.int64))
    histo = superkmer.sample_cmmer_histogram_plain(words, lengths, k, m)
    rank = torch.from_numpy(mz.frequency_rank(histo.numpy()).astype(np.int64))
    load = superkmer.sample_minimizer_load_plain(words, lengths, k, m, rank, True)
    table = torch.from_numpy(mz.build_repartition(load.numpy(), 4).astype(np.int64))
    return words, lengths, rank, table


@pytest.mark.parametrize("k,m", [(31, 10), (21, 8), (63, 12)])
@pytest.mark.parametrize("use_rank,with_pos", [(True, True), (False, False)])
def test_form_superkmers(card, k, m, use_rank, with_pos):
    words, lengths, rank, table = skm_block(k, m)
    ms = superkmer.default_max_span(k)
    args = (k, m, table, rank if use_rank else None, ms, use_rank, with_pos,
            0xFFFFF000)
    got = superkmer.form_superkmers(words.to(card), lengths.to(card),
                                    *[a.to(card) if isinstance(a, torch.Tensor)
                                      else a for a in args])
    want = superkmer.form_superkmers_plain(words, lengths, *args)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k,m", [(31, 10), (21, 8)])
def test_mmer_histograms(card, k, m):
    words, lengths, rank, _ = skm_block(k, m, seed=1)
    w, l = words.to(card), lengths.to(card)
    assert torch.equal(superkmer.sample_cmmer_histogram(w, l, k, m).cpu(),
                       superkmer.sample_cmmer_histogram_plain(words, lengths, k, m))
    for use_rank in (True, False):
        r = rank if use_rank else None
        got = superkmer.sample_minimizer_load(w, l, k, m,
                                              None if r is None else r.to(card),
                                              use_rank)
        want = superkmer.sample_minimizer_load_plain(words, lengths, k, m, r,
                                                     use_rank)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k,m", [(151, 10), (255, 12), (151, 13)])
def test_mmer_histograms_rows(card, k, m):
    """K14 on rows of W = 64 words (1024 positions) whose lengths are 0,
    m - 1, m, k - 1, k, 1024 and random, one row of one base throughout,
    adding into a histogram that is not zero (twice: the sums accumulate),
    in its m-mer mode and its load mode keyed by the m-mer and by a rank
    full of ties."""
    rng = np.random.RandomState(k + m)
    W, B = 64, 700
    words = torch.from_numpy(rng.randint(0, 2**32, size=(B, W),
                                         dtype=np.uint64).astype(np.int64))
    words[5] = 0
    lengths = rng.randint(0, 16 * W + 1, B)
    lengths[:7] = [0, m - 1, m, k - 1, k, 16 * W, 16 * W]
    lengths = torch.from_numpy(lengths.astype(np.int64))
    rank = torch.from_numpy(rng.randint(0, 8, 4 ** m))
    w, l = words.to(card), lengths.to(card)
    for load, r in ((False, None), (True, None), (True, rank)):
        start = torch.from_numpy(rng.randint(0, 1 << 40, 4 ** m))
        histo = start.to(card)
        want = superkmer.sample_minimizer_load_plain(
            words, lengths, k, m, r, r is not None) if load else \
            superkmer.sample_cmmer_histogram_plain(words, lengths, k, m)
        for reps in (1, 2):
            got = _kernels.mmer_histograms(w, l, k, m,
                                           None if r is None else r.to(card),
                                           load, histo)
            assert got.data_ptr() == histo.data_ptr()
            assert torch.equal(got.cpu(), start + reps * want)
        assert int(want.sum()) > 0


@pytest.mark.parametrize("n_dev", [1, 4, 8, 256])
@pytest.mark.parametrize("with_slots", [False, True])
def test_route_buckets(card, n_dev, with_slots):
    """K15 writes the exchange's send buffer (n_dev, C+1, cap): every
    element, the empty slots holding the fill word (0 or the sentinel),
    twice on poisoned memory, bitwise equal to its plain version."""
    rng = np.random.RandomState(n_dev)
    N, C = 300_000, 3
    stacked = torch.from_numpy(rng.randint(0, 2**32, size=(C, N),
                                           dtype=np.uint64).astype(np.int64))
    valid = torch.from_numpy(rng.rand(N) < 0.8)
    owner = torch.from_numpy(np.where(rng.rand(N) < 0.3, 0,
                                      rng.randint(0, n_dev, N)))
    gs, gv, go = stacked.to(card), valid.to(card), owner.to(card)
    for cap in (N, max(1, N // (3 * n_dev))):
        for fill in (0, ln.SENTINEL):
            args = (n_dev, cap, with_slots, fill)
            want = pipeline.route_to_buckets_plain(stacked, valid, owner, *args)
            twice_poisoned(card, lambda: _kernels.route_buckets(gs, gv, go, *args),
                           want)


@pytest.mark.parametrize("L,n_dev", [(1, 1), (2, 4), (3, 8), (8, 256)])
def test_route_buckets_hash_mode(card, L, n_dev):
    """K15 with no owner array: each entry goes to hash_lanes of its L
    lanes % n_dev, as the per-k-mer mesh count routes its k-mers; the send
    buffer on poisoned memory, twice, with both fill words, and at the
    sentinel also with no validity channel (the count's buffer); each
    call counted as route_buckets_hash."""
    rng = np.random.RandomState(L)
    N = 300_000
    lanes = torch.from_numpy(rng.randint(0, 2**32, size=(L, N),
                                         dtype=np.uint64).astype(np.int64))
    valid = torch.from_numpy(rng.rand(N) < 0.8)
    gl, gv = lanes.to(card), valid.to(card)
    for cap in (N, max(1, N // (3 * n_dev))):
        for fill, with_valid in ((0, True), (ln.SENTINEL, True),
                                 (ln.SENTINEL, False)):
            args = (n_dev, cap, True, fill, with_valid)
            want = pipeline.route_to_buckets_plain(lanes, valid, None, *args)
            twice_poisoned(card, lambda: launched(lambda: _kernels.route_buckets(
                gl, gv, None, *args), "route_buckets_hash"), want)


@pytest.mark.parametrize("L", [1, 2, 4])
def test_route_buckets_hash_one_rank(card, L):
    """Phase 3g's shape: the hash mode at n_dev = 1 (no hash computed, every
    valid entry to bucket 0) with a cap of twice the valid entries, so
    that the slots at or past N are empty from the start and the last
    tile ends the fill; invalid runs at the end of every 130-slot row, as
    K1 leaves them; the sentinel as the fill word."""
    rng = np.random.RandomState(30 + L)
    rows, P = 7_700, 130
    N = rows * P
    lanes = torch.from_numpy(rng.randint(0, 2**32, size=(L, N),
                                         dtype=np.uint64).astype(np.int64))
    valid = torch.from_numpy(np.tile(np.arange(P) < 120, rows)
                             & (rng.rand(N) < 0.99))
    cap = 2 * int(valid.sum())
    gl, gv = lanes.to(card), valid.to(card)
    for fill, with_slots, with_valid in ((ln.SENTINEL, False, False),
                                         (ln.SENTINEL, False, True),
                                         (0, True, True)):
        args = (1, cap, with_slots, fill, with_valid)
        want = pipeline.route_to_buckets_plain(lanes, valid, None, *args)
        assert want[0].shape == (1, L + with_valid, cap)
        if with_valid:
            assert int(want[0][0, L].sum()) == int(valid.sum())
        twice_poisoned(card, lambda: _kernels.route_buckets(
            gl, gv, None, *args), want)


@pytest.mark.parametrize("C", [4, 5, 9])
@pytest.mark.parametrize("n_dev", [1, 4])
def test_route_buckets_wide_stack(card, C, n_dev):
    """Owners given and C = 4 (the reshard's stack at k = 31: all in
    registers) or past K15's register channels (5, the 3f superkmer
    rounds' stack; 9): one channel loaded while the previous one is
    stored.  Over many tiles, with and without drops."""
    rng = np.random.RandomState(C * n_dev)
    N = 500_003
    stacked = torch.from_numpy(rng.randint(0, 2**32, size=(C, N),
                                           dtype=np.uint64).astype(np.int64))
    valid = torch.from_numpy(rng.rand(N) < 0.7)
    owner = torch.from_numpy(rng.randint(0, n_dev, N))
    gs, gv, go = stacked.to(card), valid.to(card), owner.to(card)
    n_valid = int(valid.sum())
    for cap, fill in ((-(-2 * n_valid // n_dev), ln.SENTINEL),
                      (max(1, n_valid // (2 * n_dev)), 0)):
        want = pipeline.route_to_buckets_plain(stacked, valid, owner, n_dev,
                                               cap, True, fill)
        twice_poisoned(card, lambda: _kernels.route_buckets(
            gs, gv, go, n_dev, cap, True, fill), want)


def test_glue_compose(card):
    """K16 in place against its plain version: each round's ancestor rows
    placed in a (4, W) response at shuffled slots (a few dropped: clipped
    to W - 1), the other columns garbage; Q, changed, need and route
    (ptr, owner at 3 ranks) equal, the kernel run twice for equal bytes."""
    rng = np.random.RandomState(0)
    run_cap, n_dev = 1 << 15, 3
    M, c_tot = 2 * run_cap, n_dev * run_cap
    pred = np.where(rng.rand(M) < 0.9, rng.randint(0, 2 * c_tot, M), -1)
    Q = chains.init_state(torch.from_numpy(pred), torch.ones(M, dtype=torch.bool))
    need = torch.from_numpy(rng.rand(M) < 0.9) & ((Q[:, 1] & chains._F_ROOTED) == 0)
    ptr = Q[:, 0].clone()
    route = torch.stack([ptr, torch.where(need, ptr // run_cap, n_dev)])
    W = 4 * M
    for _ in range(4):
        slots = torch.from_numpy(rng.permutation(W)[:M].copy())
        slots[torch.from_numpy(rng.rand(M) < 0.02)] = W
        back = torch.from_numpy(rng.randint(0, 1 << 30, (4, W)))
        back[:, torch.clamp(slots, 0, W - 1)] = Q[torch.clamp(Q[:, 0], 0, M - 1)].t()
        want = [t.clone() for t in (Q, need, route)]
        ch_want = torch.zeros(1, dtype=torch.int32)
        distcompact.glue_compose_plain(want[0], back, slots, want[1], ch_want,
                                       want[2], run_cap, n_dev)
        outs = []
        for _ in range(2):
            got = [t.to(card, copy=True) for t in (Q, need, route)]
            ch = torch.zeros(1, dtype=torch.int32, device=card)
            _kernels.glue_compose(got[0], back.to(card), slots.to(card), got[1],
                                  ch, got[2], run_cap, n_dev)
            for a, b in zip(got + [ch], want + [ch_want]):
                assert torch.equal(a.cpu(), b)
            outs.append(got)
        assert int(ch_want) == 1
        Q, need, route = want


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("mode", ["rows", "run", "uid"])
def test_glue_answer(card, mode, n_dev):
    """K21 against its plain version at every slot, on poisoned memory:
    an exchange of n_dev * qcap slots (qcap = 1000, not a multiple of the
    256-slot block), 1% valid, zero elsewhere as K15 leaves them, a few
    empty slots holding garbage (rows answers them by value, run and uid
    not at all), valid values the clip bounds; the last column, which a
    dropped query reads, once empty and once valid; an empty exchange.
    Each call twice, for equal bytes, counted once a launch under its own
    mode's key in LAUNCHES (none for the empty exchange)."""
    rng = np.random.RandomState(17 + n_dev + len(mode))
    run_cap, slot_cap = 1 << 12, 1 << 14
    me = n_dev - 1
    c_tot = n_dev * run_cap
    if mode == "rows":
        tables = (torch.from_numpy(rng.randint(-(1 << 40), 1 << 40, (2 * run_cap, 4))),)
    elif mode == "run":
        head = np.sort(rng.randint(0, slot_cap, slot_cap))
        tables = tuple(torch.from_numpy(a) for a in (
            np.cumsum(rng.rand(slot_cap) < 0.1), head,
            head + rng.randint(0, 40, slot_cap)))
    else:
        tables = (torch.from_numpy(np.where(rng.rand(2 * run_cap) < 0.3,
                                            rng.randint(0, 1 << 20, 2 * run_cap), -1)),)
    hi = n_dev * slot_cap if mode == "run" else 2 * c_tot
    for qcap, last_valid in ((1000, False), (1000, True), (0, False)):
        S = n_dev * qcap
        valid = rng.rand(S) < 0.01
        v = np.where(rng.rand(S) < 0.9, rng.randint(0, hi, S),
                     rng.randint(-hi, 3 * hi, S))
        if mode == "run":
            v = np.where(rng.rand(S) < 0.9, me * slot_cap + v % slot_cap, v)
        vals = np.where(valid, v, np.where(rng.rand(S) < 0.005, v, 0))
        if S:
            valid[-1] = last_valid
            vals[-1] = v[-1] if last_valid else 0
        vals, valid = torch.from_numpy(vals), torch.from_numpy(valid)
        want = distcompact.glue_answer_plain(mode, vals, valid, tables, run_cap,
                                             n_dev, me)
        for _ in range(2):
            poisoned(card, 8 * want.numel() + (1 << 20))
            before = dict(_kernels.LAUNCHES)
            got = _kernels.glue_answer(mode, vals.to(card), valid.to(card),
                                       tuple(t.to(card) for t in tables),
                                       run_cap, n_dev, me)
            assert got.shape == want.shape and got.is_contiguous()
            assert torch.equal(got.cpu(), want)
            assert {n: c - before[n] for n, c in _kernels.LAUNCHES.items()
                    if c != before[n]} == ({f"glue_answer_{mode}": 1} if S
                                           else {})


def hier_level0(M: int):
    """Level 0 of the hierarchical jump of a weighted graph of M nodes
    with a cycle of 5000: (Q after phase A, gid, valid, salt)."""
    succ, valid = map(torch.from_numpy, mirror_graph(M // 2, M.bit_length(),
                                                     long_cycle=5000))
    pred = chains.build_pred(succ, valid)
    dist0 = torch.from_numpy(np.random.RandomState(1).randint(1, 30, M))
    Q = chains.init_state(pred, valid, dist0[torch.clamp(pred, 0, M - 1)])
    return Q, torch.arange(M), valid, (0x85EBCA6B * 1) & 0xFFFFFFFF


def test_hier_kernels(card):
    """K17-K19 on level 0 of M = 2**19 against their plain versions, with
    and without K17's changed flag; K18 with a level too small (ok 0), and
    on M = 2**19 + 1554 rows (not a multiple of its tile)."""
    M = 1 << 19
    Q, gid, valid, salt = hier_level0(M)
    g, v = gid.to(card), valid.to(card)
    for r in range(chains._R_A):
        Qn = torch.empty_like(Q).to(card)
        changed = torch.zeros(1, dtype=torch.int32, device=card)
        bits = chains.fixpoint_bits_plain(gid, valid, salt)
        _kernels.hier_round(Q.to(card), Qn, g, bits.to(card),
                            changed if r else None)
        want = chains.hier_round_plain(Q, gid, bits)
        assert torch.equal(Qn.cpu(), want)
        if r:
            assert bool(changed.item()) == (not torch.equal(want, Q))
        Q = want
    want = hier_contract_both(card, Q, gid, valid, salt, M)
    Q1, _, _, did, parent, _ = want
    F = chains._phase(Q1, None, None, None, chains.max_rounds(M // 4) + 1)
    got = _kernels.hier_expand(F.to(card), parent.to(card), Q.to(card), did.to(card))
    assert torch.equal(got.cpu(), chains.hier_expand_plain(F, parent, Q, did))
    # K18 where the rows are not a multiple of its 2048-row selection tile
    M2 = M + 2 * 777
    Q, gid, valid, salt = hier_level0(M2)
    Q = chains._phase(Q, gid, valid, salt, chains._R_A, converge=False)
    hier_contract_both(card, Q, gid, valid, salt, M2)


def hier_contract_both(card, Q, gid, valid, salt, M):
    """K18 against its plain version at S1 = 2**12 (overflow: ok 0) and
    S1 = M / 4 (ok 1), the kernel run twice for equal bytes; returns the
    plain outputs at M / 4."""
    g, v = gid.to(card), valid.to(card)
    for S1 in (1 << 12, M // 4):
        ok_cpu = torch.ones(1, dtype=torch.int32)
        want = chains.hier_contract_plain(Q, gid, valid, salt, S1, M, ok_cpu)
        assert int(want[5]) > 1 << 12
        for _ in range(2):
            ok_card = torch.ones(1, dtype=torch.int32, device=card)
            got = _kernels.hier_contract(Q.to(card), g, v, salt, S1, M, ok_card)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
            assert int(ok_card.item()) == int(ok_cpu.item()) == int(S1 == M // 4)
    return want


def hier_round_both(card, Q, gid, valid, salt):
    """K17 against its plain version for _R_A rounds from Q: the level's
    fixpoint bitmap built once (equal to fixpoint_bits_plain, twice for
    equal bytes), then each round given it and run twice, without and with
    `changed`, for equal bytes."""
    g = None if gid is None else gid.to(card)
    want_bits = chains.fixpoint_bits_plain(gid, valid, salt)
    bits = _kernels.fixpoint_bits(g, valid.to(card), salt)
    assert torch.equal(bits.cpu(), want_bits)
    assert torch.equal(_kernels.fixpoint_bits(g, valid.to(card), salt), bits)
    for r in range(chains._R_A):
        want = chains.hier_round_plain(Q, gid, want_bits)
        Qc = Q.to(card)
        outs = []
        for with_changed in (False, True):
            Qn = torch.empty_like(Qc)
            changed = (torch.zeros(1, dtype=torch.int32, device=card)
                       if with_changed else None)
            _kernels.hier_round(Qc, Qn, g, bits, changed)
            assert torch.equal(Qn.cpu(), want)
            if changed is not None:
                assert bool(changed.item()) == (not torch.equal(want, Q))
            outs.append(Qn)
        assert torch.equal(outs[0], outs[1])
        Q = want
    return Q


@pytest.mark.parametrize("case", ["level1", "odd", "rooted", "clamp"])
def test_hier_round_bitmap(card, case):
    """K17 with its per-level fixpoint bitmap: at level 1 (gid not the row
    index; the plain level build of 2**19 rows), at level 0 of 2**19 +
    1554 rows (not a multiple of a block or of a bitmap word), with every
    row ROOTED, and with 5% of the targets out of range (the clamp)."""
    if case == "level1":
        M = 1 << 19
        Q, gid, valid, salt = hier_level0(M)
        Q = chains._phase(Q, None, valid, salt, chains._R_A, converge=False)
        ok = torch.ones(1, dtype=torch.int32)
        Q, gid, valid, _, _, _ = chains.hier_contract_plain(Q, gid, valid, salt,
                                                            M // 4, M, ok)
        assert int(ok) == 1 and not torch.equal(gid, torch.arange(M // 4))
        salt = (0x85EBCA6B * 2) & 0xFFFFFFFF
    else:
        M = (1 << 19) + 2 * 777 if case == "odd" else 1 << 19
        Q, _, valid, salt = hier_level0(M)
        gid = None
        if case == "rooted":
            Q[:, 1] |= chains._F_ROOTED
        if case == "clamp":
            rng = np.random.RandomState(7)
            out = torch.from_numpy(rng.rand(M) < 0.05)
            far = torch.from_numpy(np.where(rng.rand(M) < 0.5,
                                            -rng.randint(1, 100, M),
                                            M + rng.randint(0, 100, M)))
            Q[:, 0] = torch.where(out, far, Q[:, 0])
    got = hier_round_both(card, Q, gid, valid, salt)
    assert torch.equal(got, Q) == (case == "rooted")


@pytest.mark.parametrize("variant", ["auto", "plain", "hier"])
def test_chain_decompose_card_equals_cpu(card, variant):
    succ, valid = map(torch.from_numpy, mirror_graph(1 << 17, 3,
                                                     long_cycle=5000))
    want = chains.chain_decompose(succ, valid, variant=variant)
    got = chains.chain_decompose(succ.to(card), valid.to(card), variant=variant)
    n = int(want["n_unitigs"])
    assert int(got["n_unitigs"]) == n > 0
    for key in ("uid", "rank"):
        assert torch.equal(got[key].cpu(), want[key])
    for key in ("start_oid", "length", "circular"):
        assert torch.equal(got[key].cpu()[:n], want[key][:n])


@pytest.mark.parametrize("k", [151, 255, 511])
@pytest.mark.parametrize("m", [11, 16])
@pytest.mark.parametrize("order", ["random", "sorted_with_repeats"])
def test_kmer_minimizers_long_k(card, k, m, order):
    """K20 at 10, 16 and 32 lanes with m = 11 and 16, so that m-mers
    straddle two lanes at every offset; N not a multiple of the block;
    random columns, or sorted ones drawn from a small pool (equal m-mers
    in neighbouring threads).  m = 11: minimizers with and without a rank
    full of ties, partition ids, the histogram with and without valid, on
    poisoned memory; m = 16: the lexicographic minimizers (a 4^16 rank,
    table or histogram would not fit)."""
    rng = np.random.RandomState(k * m)
    L, N = ln.num_lanes(k), 100_003
    lanes = rng.randint(0, 2**32, size=(L, N), dtype=np.uint64)
    if order != "random":
        lanes = lanes[:, rng.randint(0, 997, N)]
        lanes = lanes[:, np.lexsort(lanes[::-1])]
    lanes[0] &= (1 << (2 * (k - 16 * (L - 1)))) - 1
    lanes = torch.from_numpy(np.ascontiguousarray(lanes).astype(np.int64))
    lc = lanes.to(card)
    assert torch.equal(mz.minimizers(lc, k, m).cpu(),
                       mz.minimizers_plain(lanes, k, m))
    if m == 16:
        return
    rank = torch.from_numpy(rng.randint(0, 8, 4 ** m))
    table = torch.from_numpy(rng.randint(0, 16, 4 ** m))
    rc, tc = rank.to(card), table.to(card)
    assert torch.equal(mz.minimizers(lc, k, m, rc).cpu(),
                       mz.minimizers_plain(lanes, k, m, rank))
    for r in (None, rank):
        assert torch.equal(
            mz.partition_of(lc, k, m, tc, None if r is None else rc).cpu(),
            mz.partition_of_plain(lanes, k, m, table, r))
    valid = torch.from_numpy(rng.rand(N) < 0.7)
    for v in (None, valid):
        poisoned(card, 8 * 4 ** m + (1 << 20))
        got = _kernels.kmer_minimizers(lc, k, m, valid=None if v is None
                                       else v.to(card), histogram=True)
        want = mz.mmer_histogram_plain(
            lanes, torch.ones(N, dtype=torch.bool) if v is None else v, k, m)
        assert torch.equal(got.cpu(), want)


def test_kmer_histogram_past_32_bits(card):
    """K20's histogram where N(k - m + 1) >= 2^32: its 64-bit atomics.
    8.5 M all-A 511-mers (32 lanes) at m = 1 put N * 511 > 2^32 in bin 0."""
    k, m, N = 511, 1, 8_500_000
    lanes = torch.zeros((32, N), dtype=torch.int64, device=card)
    poisoned(card, 1 << 20)
    got = _kernels.kmer_minimizers(lanes, k, m, histogram=True).cpu()
    assert got.tolist() == [N * (k - m + 1), 0, 0, 0]
    assert N * (k - m + 1) >= 1 << 32


@pytest.mark.parametrize("k,m", [(31, 10), (41, 10), (13, 3), (63, 12)])
def test_kmer_minimizers(card, k, m):
    """K20 in each mode: minimizers (lexicographic; a rank with many ties),
    partition_of through a table, the histogram of the valid columns."""
    rng = np.random.RandomState(k)
    L, N = ln.num_lanes(k), 100_000
    lanes = rng.randint(0, 2**32, size=(L, N), dtype=np.uint64)
    lanes[0] &= (1 << (2 * (k - 16 * (L - 1)))) - 1
    lanes = torch.from_numpy(lanes.astype(np.int64))
    rank = torch.from_numpy(rng.randint(0, 8, 4 ** m))
    table = torch.from_numpy(rng.randint(0, 16, 4 ** m))
    valid = torch.from_numpy(rng.rand(N) < 0.8)
    lc = lanes.to(card)
    for r in (None, rank):
        rc = None if r is None else r.to(card)
        assert torch.equal(mz.minimizers(lc, k, m, rc).cpu(),
                           mz.minimizers_plain(lanes, k, m, r))
        assert torch.equal(mz.partition_of(lc, k, m, table.to(card), rc).cpu(),
                           mz.partition_of_plain(lanes, k, m, table, r))
    assert torch.equal(mz.mmer_histogram(lc, valid.to(card), k, m).cpu(),
                       mz.mmer_histogram_plain(lanes, valid, k, m))


def test_devices_build_card_equals_cpu(card, tmp_path):
    """The -devices build at world size 1: one NCCL rank on the card
    writes the bytes of one gloo rank on the CPU."""
    k = 31
    seqs = reads(13, n=1000, k=k) + reads(14, n=1000, k=k)   # two genomes
    outs = []
    for kind in ("cuda", "cpu"):
        out = tmp_path / kind
        out.mkdir()
        job = {"name": "b", "reads": seqs, "cfg": engine.EngineConfig(
            k=k, abundance_min=2, block_reads=64, max_len=128)}
        launch.spawn(1, kind, launch.run_builds, [job], str(out))
        with open(out / "b.0.pkl", "rb") as f:
            outs.append(pickle.load(f)["fasta"])
    assert outs[0] == outs[1] and outs[0].count(">") > 1


# -- 9 to 32 lanes (k = 129-512): the 16- and 32-lane instantiations ------

LONG_K = [143, 151, 255, 512]    # L = 9, 10, 16, 32


def solid_columns(kmers, L):
    cols = [[(x >> (32 * (L - 1 - j))) & 0xFFFFFFFF for x in kmers]
            for j in range(L)]
    return torch.tensor(cols, dtype=torch.int64)


@pytest.mark.parametrize("k", LONG_K)
def test_extract_insert_long_k(card, k):
    """K1 at 9-32 lanes, with a slot base and with per-row bases."""
    L = ln.num_lanes(k)
    rng = np.random.RandomState(k)
    for b in packing.iter_blocks(reads(k, k=k), k, block_reads=64,
                                 max_len=k + 80):
        F = extract.block_slots(b.words.shape, k)
        words = torch.from_numpy(b.words.astype(np.int64))
        lengths = torch.from_numpy(b.lengths.astype(np.int64))
        base = torch.from_numpy(rng.randint(0, 2**32, words.shape[0],
                                            dtype=np.uint64).astype(np.int64))
        for row_base in (None, base):
            bufs = [torch.full((L + 1, F + 9), 7, dtype=torch.int64)
                    for _ in range(2)]
            extract.extract_insert_plain(bufs[1], words, lengths, k,
                                         0x7FFFFF00, 9, row_base)
            bufs[0] = bufs[0].to(card)
            _kernels.extract_insert(
                bufs[0], words.to(card), lengths.to(card), k, 0x7FFFFF00, 9,
                None if row_base is None else row_base.to(card))
            assert torch.equal(bufs[0].cpu(), bufs[1])
            assert int((bufs[1][L] != ln.SENTINEL).sum()) > 0


@pytest.mark.parametrize("k", LONG_K)
def test_junctions_long_k(card, k):
    """K3a/K3b at 9-32 lanes, single-device and global mode."""
    L = ln.num_lanes(k)
    kmers = sorted(brute.count_kmers(reads(k, k=k), k))
    solid = solid_columns(kmers, L)
    n = solid.shape[1]
    keys, pay = _kernels.junction_keys(solid.to(card), n - 3, k,
                                       junctions.packed_keys(k),
                                       junctions.key_rows(k))
    pkeys, ppay = junctions.junction_keys_plain(solid, n - 3, k)
    assert torch.equal(keys.cpu(), pkeys) and torch.equal(pay.cpu(), ppay)
    s_word, perm, ppay, K, lower = sorted_pairs_inputs(pkeys, ppay,
                                                       ln.num_lanes(k - 1))
    succ = _kernels.junction_pairs(
        s_word.to(card), perm.to(card), ppay.to(card), n, K,
        None if lower is None else lower.to(card))
    want = junctions.junction_pairs_plain(s_word, perm, ppay, n, K, lower)
    assert torch.equal(succ.cpu(), want) and int((want >= 0).sum()) > 0
    gbase, tot = 3 * n, 8 * n
    got = junctions.junction_entries(solid.to(card), n - 3, k, gbase, tot, 4)
    want = junctions.junction_entries_plain(solid, n - 3, k, gbase, tot, 4)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("L", [9, 10, 16, 32])
def test_range_kernels_long_lanes(card, L):
    """K5 and K6 at 9-32 lanes."""
    body = random_body(L, 70_000, L)
    rng = np.random.RandomState(L)
    keys = [tuple(body[:L, rng.randint(0, body.shape[1])].tolist())
            for _ in range(2)]
    for lo, hi in (((0,) * L, (ln.SENTINEL,) * L), (min(keys), max(keys))):
        got_buf = body.to(card)
        got = _kernels.range_fold(got_buf, lo, hi)
        want_buf = body.clone()
        want = count.range_fold_plain(want_buf, lo, hi)
        assert torch.equal(got_buf.cpu(), want_buf)
        assert int(got[0]) == int(want[0])
    unique, _, _, n = count.count_canonical(body[:L].contiguous())
    n = int(n)
    cols = [unique[:, rng.randint(0, n)] for _ in range(6)]
    cols += [torch.zeros(L, dtype=torch.int64), unique[:, n - 1]]
    bounds = torch.stack(cols, dim=1).contiguous()
    for m in (n, n // 2, 0):
        got = _kernels.lower_bound(unique.to(card), m, bounds.to(card))
        assert torch.equal(got.cpu(), count.lower_bound_plain(unique, m, bounds))


@pytest.mark.parametrize("L", [9, 10, 16, 32])
def test_solid_kernels_long_lanes(card, L):
    """K7, and K9 with and without its minpos row (filter_abundance), at
    9-32 lanes."""
    rng = np.random.RandomState(L)
    N = 200_000
    unique = torch.from_numpy(rng.randint(0, 2**32, size=(L, N),
                                          dtype=np.uint64).astype(np.int64))
    counts = torch.from_numpy(rng.geometric(0.3, N))
    minpos = torch.from_numpy(rng.randint(0, 2**31, N))
    args = (N - 777, 2, 40)
    got = _kernels.solid_fold_histogram(unique.to(card), counts.to(card),
                                        minpos.to(card), *args, 10000)
    want = count.solid_fold_histogram_plain(unique, counts, minpos, *args,
                                            10000)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    out, n = _kernels.solid_compact(unique.to(card), counts.to(card),
                                    minpos.to(card), *args)
    want, want_n = count.solid_compact_plain(unique, counts, minpos, *args)
    assert torch.equal(out.cpu(), want) and torch.equal(n.cpu(), want_n)
    got = count.filter_abundance(unique.to(card), counts.to(card), *args)
    want = count.filter_abundance_plain(unique, counts, *args)
    assert got[0].shape == (L, N) and got[1].shape == (N,)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("L,amin,amax", [(1, 2, 2**31 - 1), (2, 3, 40)])
def test_filter_abundance_mode(card, L, amin, amax):
    """K9 without its minpos row: (L, N) lanes and (N,) counts, 0 past
    n_solid."""
    rng = np.random.RandomState(L + 100)
    N = 300_000
    unique = torch.from_numpy(rng.randint(0, 2**32, size=(L, N),
                                          dtype=np.uint64).astype(np.int64))
    counts = torch.from_numpy(rng.geometric(0.3, N))
    before = dict(_kernels.LAUNCHES)
    got = count.filter_abundance(unique.to(card), counts.to(card), N - 5,
                                 amin, amax)
    assert _kernels.LAUNCHES["solid_compact"] == before["solid_compact"] + 1
    want = count.filter_abundance_plain(unique, counts, N - 5, amin, amax)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert 0 < int(want[2]) < N and int(want[1][int(want[2]):].abs().sum()) == 0


@pytest.mark.parametrize("k", LONG_K)
def test_spell_and_minimizers_long_k(card, k):
    """K11 and K20 (each mode) at 9-32 lanes."""
    solid_r, counts_r, info, n_solid = compacted(k, max_len=k + 80)
    U = int(info["n_unitigs"])
    args = [info[key] for key in ("uid", "rank", "length", "start_oid")]
    got = _kernels.spell_unitigs(solid_r.to(card), counts_r.to(card),
                                 *[a.to(card) for a in args], U, k, n_solid)
    want = engine.spell_unitigs_plain(solid_r, counts_r, *args, U, k, n_solid)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert U > 1
    m = 10
    lanes = solid_r[:, :n_solid].contiguous()
    rng = np.random.RandomState(k)
    rank = torch.from_numpy(rng.randint(0, 8, 4 ** m))
    table = torch.from_numpy(rng.randint(0, 16, 4 ** m))
    valid = torch.from_numpy(rng.rand(n_solid) < 0.8)
    lc = lanes.to(card)
    for r in (None, rank):
        rc = None if r is None else r.to(card)
        assert torch.equal(mz.minimizers(lc, k, m, rc).cpu(),
                           mz.minimizers_plain(lanes, k, m, r))
        assert torch.equal(mz.partition_of(lc, k, m, table.to(card), rc).cpu(),
                           mz.partition_of_plain(lanes, k, m, table, r))
    assert torch.equal(mz.mmer_histogram(lc, valid.to(card), k, m).cpu(),
                       mz.mmer_histogram_plain(lanes, valid, k, m))


@pytest.mark.parametrize("k", [151, 255])
def test_build_card_equals_cpu_long_k(card, k):
    """The whole single-device build at 10 and 16 lanes, resident and over
    several key ranges."""
    seqs = reads(k + 1, n=600, k=k)
    for extra in ({}, {"block_reads": 4, "chunk_kmers": 512,
                       "resident_kmers": 1024}):
        cfg = engine.EngineConfig(k=k, abundance_min=2, max_len=k + 80,
                                  **{"block_reads": 64, **extra})
        outs = []
        for dev in (card, "cpu"):
            us = engine.build_from_seqs(seqs, cfg, dev)
            buf = io.StringIO()
            fasta_writer.write_fasta(us, buf)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1] and outs[0]


def test_init_group_local_rank(card, tmp_path, monkeypatch):
    """A rank takes the card of its local rank, not of its global rank:
    global rank 5 of 8 with local rank 0 uses cuda:0; and a group of one
    joined through env:// (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
    LOCAL_RANK) runs a collective on cuda:0."""
    import socket

    import torch.distributed as dist

    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    mesh = launch.init_group(8, 5, "cuda", "tcp://localhost:1", local_rank=0)
    assert mesh.device == torch.device("cuda", 0) and mesh.rank == 5
    assert seen == {"backend": "nccl", "init_method": "tcp://localhost:1",
                    "world_size": 8, "rank": 5}
    assert torch.cuda.current_device() == 0
    monkeypatch.undo()
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    for key, val in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                     ("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, val)
    mesh = launch.init_from_env("cuda")
    try:
        assert mesh.device == torch.device("cuda", 0)
        assert int(mesh.psum(torch.ones(1, dtype=torch.int64,
                                        device=mesh.device))[0]) == 1
    finally:
        dist.destroy_process_group()


# -- K6's warp search and K9's one-pass compaction at their edges ---------

def dup_run(L, n, seed):
    """(L, n) keys sorted over all n columns, drawn from a pool of n // 50
    so that stretches of ~50 equal keys are common; lanes use all 32 bits
    and share prefixes."""
    rng = np.random.RandomState(seed)
    pool = rng.randint(0, 2**32, size=(L, max(1, n // 50)), dtype=np.uint64)
    pool[: L // 2] &= 0xF            # equal leading lanes, as long k-mers have
    keys = pool[:, rng.randint(0, pool.shape[1], n)]
    return np.ascontiguousarray(keys[:, np.lexsort(keys[::-1])])


def as_bytes(keys):
    """(L, m) u32 lanes -> m big-endian byte strings: numpy compares them in
    the lanes' lexicographic order."""
    return np.ascontiguousarray(keys.T.astype(">u4")).view(f"S{4 * keys.shape[0]}")[:, 0]


@pytest.mark.parametrize("L", [1, 2, 5, 8, 9, 16, 17, 32])
def test_lower_bound_warp_search(card, L):
    """K6 on 4096 bounds: keys of the run (duplicates), keys between and
    outside them, 0 and the sentinel; n from the whole run down to 0, and
    P = 0.  Reference: numpy's searchsorted on byte strings."""
    rng = np.random.RandomState(L)
    n_all = 60_000
    keys = dup_run(L, n_all, L)
    bounds = np.concatenate([
        keys[:, rng.randint(0, n_all, 2048)],
        rng.randint(0, 2**32, size=(L, 2040), dtype=np.uint64),
        np.zeros((L, 4), np.uint64), np.full((L, 4), 0xFFFFFFFF, np.uint64)],
        axis=1)
    run = torch.from_numpy(keys.astype(np.int64)).to(card)
    b = torch.from_numpy(bounds.astype(np.int64)).to(card)
    s_keys, s_bounds = as_bytes(keys), as_bytes(bounds)
    for n in (n_all, n_all // 3 + 1, 33, 32, 31, 1, 0):
        got = _kernels.lower_bound(run, n, b).cpu().numpy()
        np.testing.assert_array_equal(
            got, np.searchsorted(s_keys[:n], s_bounds, side="left"))
    few = b[:, ::512].contiguous()
    assert torch.equal(_kernels.lower_bound(run, n_all // 3, few).cpu(),
                       count.lower_bound_plain(run.cpu(), n_all // 3, few.cpu()))
    assert _kernels.lower_bound(run, n_all, b[:, :0]).shape == (0,)


@pytest.mark.parametrize("L,N,solid", [(2, 3_000_000, 0.6), (2, 3_000_000, 1.0),
                                       (2, 3_000_000, 0.0), (1, 4095, 0.6),
                                       (3, 4096, 0.6), (2, 4097, 0.6),
                                       (10, 2_000_000, 0.6)])
def test_solid_compact_lookback(card, L, N, solid):
    """K9 over many look-back tiles (4096 columns each), at a tile's size
    minus one, the size and plus one, with none, some and all columns
    solid: widths N, n_solid and below it, and the filter_abundance mode."""
    rng = np.random.RandomState(N + L)
    unique = torch.from_numpy(rng.randint(0, 2**32, size=(L, N),
                                          dtype=np.uint64).astype(np.int64))
    counts = torch.from_numpy(np.where(rng.rand(N) < solid, 5, 1))
    minpos = torch.from_numpy(rng.randint(0, 2**31, N))
    args = (N - 3, 2, 40)
    want, want_n = count.solid_compact_plain(unique, counts, minpos, *args)
    gu, gc, gp = unique.to(card), counts.to(card), minpos.to(card)
    w = int(want_n[0])
    for width in (None, w, w // 2):
        out, n = _kernels.solid_compact(gu, gc, gp, *args, width=width)
        assert int(n[0]) == w
        assert torch.equal(out.cpu(), want[:, :N if width is None else width])
    got = count.filter_abundance(gu, gc, *args)
    for a, b in zip(got, count.filter_abundance_plain(unique, counts, *args)):
        assert torch.equal(a.cpu(), b)


def twice_equal(fn, want):
    """fn() twice: each result equal to want, and the two runs' bytes equal
    (the placement must not depend on the order tiles or rows run in)."""
    first = fn()
    second = fn()
    for a, b, c in zip(first, second, want):
        assert torch.equal(a.cpu(), c)
        assert torch.equal(a, b)


def twice_poisoned(card, fn, want):
    """twice_equal, the caching allocator's memory poisoned before each
    call: K15 writes every element of its send buffer, no fill before it."""
    nbytes = sum(8 * t.numel() for t in want) + (1 << 20)

    def run():
        poisoned(card, nbytes)
        return fn()

    twice_equal(run, want)


@pytest.mark.parametrize("N,n_dev", [(0, 3), (1, 1), (1023, 2), (1025, 3),
                                     (2_000_000, 1), (2_000_000, 4),
                                     (300_000, 32), (300_000, 33),
                                     (300_000, 256), (5000, 256)])
def test_route_buckets_lookback(card, N, n_dev):
    """K15's one-pass multi-split over 2048-entry look-back tiles: no entry,
    one, 1023 and 1025 entries, and hundreds of tiles; owners out of range
    among them; every entry invalid; every entry to one owner; a cap
    that every owner overflows at once; with and without slots; the send
    buffer on poisoned memory, twice, with fill words 0 and the sentinel."""
    rng = np.random.RandomState(N + n_dev)
    C = 3
    stacked = torch.from_numpy(rng.randint(0, 2**32, size=(C, N),
                                           dtype=np.uint64).astype(np.int64))
    valid = torch.from_numpy(rng.rand(N) < 0.8)
    owner = torch.from_numpy(rng.randint(-1, n_dev + 1, N))
    n_valid = int(valid.sum())
    cases = [(valid, owner, max(1, N)),
             (valid, owner, max(1, n_valid // (2 * n_dev))),
             (torch.zeros(N, dtype=torch.bool), owner, 5),
             (valid, torch.full((N,), n_dev - 1, dtype=torch.int64),
              max(1, n_valid // 2))]
    for n_case, (v, o, cap) in enumerate(cases):
        for with_slots in (False, True):
            fill = (0, ln.SENTINEL)[(n_case + with_slots) % 2]
            args = (n_dev, cap, with_slots, fill)
            want = pipeline.route_to_buckets_plain(stacked, v, o, *args)
            gs, gv, go = stacked.to(card), v.to(card), o.to(card)
            twice_poisoned(card, lambda: _kernels.route_buckets(gs, gv, go,
                                                                *args), want)


@pytest.mark.parametrize("N", [2047, 2048, 2049, 4097])
@pytest.mark.parametrize("n_dev", [1, 3])
def test_route_buckets_tile_edges(card, N, n_dev):
    """K15 at a 2048-entry tile minus one, a tile, a tile plus one and two
    tiles plus one, in the hash and the owner mode, with caps that leave
    slots at or past N empty from the start (cap > N) and that drop: the
    fills of the first tile and of the last one, twice on poisoned
    memory."""
    rng = np.random.RandomState(N * n_dev)
    stacked = torch.from_numpy(rng.randint(0, 2**32, size=(2, N),
                                           dtype=np.uint64).astype(np.int64))
    valid = torch.from_numpy(rng.rand(N) < 0.9)
    owner = torch.from_numpy(rng.randint(0, n_dev, N))
    gs, gv, go = stacked.to(card), valid.to(card), owner.to(card)
    for o, go_ in ((None, None), (owner, go)):
        for cap, fill in ((N + 77, ln.SENTINEL), (N // (2 * n_dev) + 1, 0)):
            want = pipeline.route_to_buckets_plain(stacked, valid, o, n_dev,
                                                   cap, True, fill)
            twice_poisoned(card, lambda: _kernels.route_buckets(
                gs, gv, go_, n_dev, cap, True, fill), want)


@pytest.mark.parametrize("tiles,n_dev", [(80, 1), (80, 4), (80, 8), (1, 8),
                                         (2, 3), (65, 2), (66, 2), (67, 5),
                                         (131, 4), (132, 4), (133, 4)])
def test_route_buckets_pool_blocks(card, tiles, n_dev):
    """A grid of fewer 2048-entry tiles than the card has SMs: the blocks
    past the last tile fill the last tiles' ranges of each bucket's tail
    (80 tiles: the -devices rounds' 163,840 entries), on both sides of
    half the SMs and of all of them; N one short of the tiles, caps that
    leave most of each bucket empty, that leave slots at or past N empty
    and that drop, both modes, with and without a validity channel, twice
    on poisoned memory."""
    rng = np.random.RandomState(tiles * 10 + n_dev)
    N, C = tiles * _kernels.ROUTE_TILE - 1, 5
    stacked = torch.from_numpy(rng.randint(0, 2**32, size=(C, N),
                                           dtype=np.uint64).astype(np.int64))
    valid = torch.from_numpy(rng.rand(N) < 0.1)
    owner = torch.from_numpy(rng.randint(0, n_dev, N))
    gs, gv, go = stacked.to(card), valid.to(card), owner.to(card)
    n_valid = int(valid.sum())
    for o, go_ in ((owner, go), (None, None)):
        for cap, fill, with_valid in (
                (-(-2 * n_valid // n_dev), 0, True),
                (-(-2 * n_valid // n_dev), ln.SENTINEL, False),
                (N + 5, ln.SENTINEL, True),
                (max(1, n_valid // (2 * n_dev)), 0, True)):
            args = (n_dev, cap, True, fill, with_valid)
            want = pipeline.route_to_buckets_plain(stacked, valid, o, *args)
            twice_poisoned(card, lambda: _kernels.route_buckets(
                gs, gv, go_, *args), want)


@pytest.mark.parametrize("L,n_dev", [(1, 1), (2, 4), (10, 3), (32, 33)])
def test_route_buckets_hash_lookback(card, L, n_dev):
    """K15's hash mode (owner = hash_lanes % n_dev, hashed once per entry,
    none at one rank) over many tiles, at 1, 2, 10 and 32 lanes, with and
    without overflow, on poisoned memory with both fill words."""
    rng = np.random.RandomState(L * n_dev)
    N = 1_000_003
    lanes = torch.from_numpy(rng.randint(0, 2**32, size=(L, N),
                                         dtype=np.uint64).astype(np.int64))
    valid = torch.from_numpy(rng.rand(N) < 0.8)
    gl, gv = lanes.to(card), valid.to(card)
    for cap, fill in ((-(-2 * N // n_dev), 0),
                      (max(1, N // (3 * n_dev)), ln.SENTINEL)):
        want = pipeline.route_to_buckets_plain(lanes, valid, None, n_dev, cap,
                                               True, fill)
        twice_poisoned(card, lambda: _kernels.route_buckets(
            gl, gv, None, n_dev, cap, True, fill), want)


@pytest.mark.parametrize("k,m,W,max_span", [(31, 10, 10, None), (31, 10, 64, 3),
                                            (21, 8, 3, 2), (151, 10, 20, None),
                                            (255, 12, 17, 5)])
def test_form_superkmers_rows(card, k, m, W, max_span):
    """K13's warp-per-row windows: rows of length 0, k - 1, k and 16W and
    random ones; an all-A row and a periodic one, whose runs of equal keys
    are longer than 2 max_span; W = 64; k = 151 and 255 (Wn = 12 and 18);
    with and without the rank and the position channel."""
    rng = np.random.RandomState(k + W)
    B, P = 300, 16 * W
    words = rng.randint(0, 2**32, size=(B, W), dtype=np.uint64).astype(np.int64)
    words[0] = 0                      # all A: one key over the whole row
    words[1] = 0x1B1B1B1B             # ACTG repeated: a period of 4
    lengths = rng.randint(0, P + 1, B)
    lengths[:6] = [P, P, 0, k - 1, k, P]
    words, lengths = torch.from_numpy(words), torch.from_numpy(lengths)
    rank = torch.from_numpy(rng.permutation(4 ** m).astype(np.int64))
    table = torch.from_numpy(rng.randint(0, 4, 4 ** m).astype(np.int64))
    ms = max_span or superkmer.default_max_span(k)
    gw, gl, gt, gr = (t.to(card) for t in (words, lengths, table, rank))
    for use_rank, with_pos in ((True, True), (False, False), (True, False)):
        want = superkmer.form_superkmers_plain(
            words, lengths, k, m, table, rank if use_rank else None, ms,
            use_rank, with_pos, 0xFFFFFF00)
        twice_equal(lambda: superkmer.form_superkmers(
            gw, gl, k, m, gt, gr if use_rank else None, ms, use_rank,
            with_pos, 0xFFFFFF00), want)


# -- K1's word-parallel windows and range mode; K5's vector fold ----------

WINDOW_K = [1, 15, 16, 17, 31, 32, 33, 127, 128, 129, 151, 255, 256, 257, 512]


@pytest.mark.parametrize("k", WINDOW_K)
def test_extract_insert_windows(card, k):
    """K1 at every lane boundary: random rows of W words with lengths 0,
    k - 1, k and 16W and random ones; rows narrower than k (P_eff = 1,
    every slot folds); with a slot base near 2^31 and with per-row bases;
    in range mode with bounds taken from the block's own keys."""
    L = ln.num_lanes(k)
    rng = np.random.RandomState(k)
    blocks = []
    for W in (k // 16 + 3, k // 16 + 1):
        B, P = 97, 16 * W
        words = rng.randint(0, 2**32, size=(B, W), dtype=np.uint64).astype(np.int64)
        words[0] = 0                          # all A
        words[1] = 0xFFFFFFFF                 # all T
        lengths = rng.randint(0, P + 1, B)
        lengths[:6] = [P, P, 0, max(0, k - 1), min(k, P), P]
        blocks.append((torch.from_numpy(words), torch.from_numpy(lengths)))
    if k > 16:                                # rows narrower than k
        Wn = (k - 1) // 16
        words = torch.from_numpy(rng.randint(0, 2**32, size=(9, Wn), dtype=np.uint64).astype(np.int64))
        blocks.append((words, torch.full((9,), 16 * Wn, dtype=torch.int64)))
    for words, lengths in blocks:
        F = extract.block_slots(words.shape, k)
        ref = torch.full((L + 1, F), 7, dtype=torch.int64)
        extract.extract_insert_plain(ref, words, lengths, k, 0, 0)
        live = torch.nonzero(ref[L] != ln.SENTINEL).reshape(-1)
        modes = [{}]
        if live.numel() >= 2:
            pick = live[torch.from_numpy(rng.randint(0, live.numel(), 2))]
            keys = sorted(tuple(ref[:L, i].tolist()) for i in pick)
            modes += [{"lo": keys[0], "hi": keys[1]},
                      {"lo": keys[1], "hi": (ln.SENTINEL,) * L}]
        else:
            modes.append({"lo": (0,) * L, "hi": (ln.SENTINEL,) * L})
        base = torch.from_numpy(rng.randint(0, 2**32, words.shape[0],
                                            dtype=np.uint64).astype(np.int64))
        for row_base in (None, base):
            for kw in modes:
                bufs = [torch.full((L + 1, F + 9), 7, dtype=torch.int64)
                        for _ in range(2)]
                extract.extract_insert_plain(bufs[1], words, lengths, k,
                                             0x7FFFFF00, 9, row_base, **kw)
                before = dict(_kernels.LAUNCHES)
                bufs[0] = bufs[0].to(card)
                _kernels.extract_insert(
                    bufs[0], words.to(card), lengths.to(card), k, 0x7FFFFF00,
                    9, None if row_base is None else row_base.to(card), **kw)
                assert torch.equal(bufs[0].cpu(), bufs[1])
                name = "extract_insert_ranged" if kw else "extract_insert"
                assert _kernels.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("L", list(range(1, 33)))
def test_range_fold_columns(card, L):
    """K5 at every lane count on column slices: odd strides, column
    offsets that break the 16-byte alignment, N not a multiple of 4, an
    empty range (every column folds: the 16-byte stores) and the whole
    range; the count right on consecutive calls (the scratch pair is left
    zeroed)."""
    rng = np.random.RandomState(100 + L)
    for N, width, start in ((4099, 4105, 3), (70_001, 70_004, 0),
                            (64, 64, 0), (5, 8, 1), (2051, 2052, 1)):
        body = random_body(L, N, L + N)
        keys = sorted(tuple(body[:L, rng.randint(0, N)].tolist())
                      for _ in range(2))
        wide = torch.full((L + 1, width), 3, dtype=torch.int64)
        wide[:, start:start + N] = body
        for lo, hi in ((keys[0], keys[1]), ((0,) * L, (ln.SENTINEL,) * L),
                       (keys[1], keys[1]), (keys[0], (ln.SENTINEL,) * L)):
            got_buf = wide.to(card)
            got = _kernels.range_fold(got_buf[:, start:start + N], lo, hi)
            want_buf = wide.clone()
            want = count.range_fold_plain(want_buf[:, start:start + N], lo, hi)
            assert torch.equal(got_buf.cpu(), want_buf)
            assert int(got[0]) == int(want[0])


# -- K2's one-pass segmented reduce on the sort's output; K3's word-parallel
# reverse complement --

def sorted_runs(L, lengths, n_sent, seed, device):
    """Sorted (L, N) lanes: len(lengths) distinct random keys in order, key
    r repeated lengths[r] times, then n_sent sentinel columns."""
    rng = np.random.RandomState(seed)
    P = len(lengths)
    pool = rng.randint(0, 2**32 - 1, size=(L, P), dtype=np.uint64).astype(np.int64)
    pool = pool[:, np.lexsort(tuple(pool[::-1]))]
    idx = torch.repeat_interleave(torch.arange(P), torch.as_tensor(lengths))
    lanes = torch.from_numpy(pool).to(device)[:, idx.to(device)]
    sent = torch.full((L, n_sent), ln.SENTINEL, dtype=torch.int64, device=device)
    return torch.cat([lanes, sent], dim=1).contiguous()


def run_lengths(N, seed, long_runs=()):
    """Geometric run lengths (mean 4) summing to N, with the given long
    runs spliced in at random places."""
    rng = np.random.RandomState(seed)
    short = N - sum(long_runs)
    lengths = rng.geometric(0.25, max(1, short))
    cum = np.cumsum(lengths)
    n = int(np.searchsorted(cum, short))
    lengths = lengths[:n + 1] if short else lengths[:0]
    if short:
        lengths[-1] -= cum[n] - short
    for r in long_runs:
        lengths = np.insert(lengths, rng.randint(0, len(lengths) + 1), r)
    return lengths.astype(np.int64)


@pytest.mark.parametrize("L", [1, 2, 8, 10, 16, 32])
def test_count_runs_segmented(card, L):
    """K2 on the sort's output against its plain version, bitwise, at N =
    0, 1, around one tile and past 3 * 2^20 with runs crossing 1, 2 and
    ~300 tiles (2048 columns each), the columns in a random entry order;
    weighted (sums past 2^32) and not, with and without pos; all-sentinel
    inputs; one launch a call, the same bytes twice (the workspace is
    reused with no fill between launches)."""
    shapes = [(1, ()), (4095, ()), (4096, ()), (4097, (3000,)),
              (3 * 2**20 + 5, (2100, 4200, 300 * 2048 + 17))]
    rng = np.random.RandomState(L)
    for N, long_runs in shapes:
        n_sent = N // 10
        lanes = sorted_runs(L, run_lengths(N - n_sent, N + L, long_runs),
                            n_sent, N, card)
        lanes = lanes[:, torch.from_numpy(rng.permutation(N)).to(card)]
        inputs = count_inputs(lanes)
        weights = torch.from_numpy(rng.randint(1, 2**31, N)).to(card)
        pos = torch.from_numpy(rng.randint(0, 2**32, N, dtype=np.uint64)
                               .astype(np.int64)).to(card)
        for w in (None, weights):
            for p in (None, pos):
                key = "count_sorted" if w is None else "count_sorted_weighted"
                before = _kernels.LAUNCHES[key]
                got = _kernels.count_sorted(*inputs, w, p)
                assert _kernels.LAUNCHES[key] == before + 1
                again = _kernels.count_sorted(*inputs, w, p)
                want = count.count_sorted_plain(*inputs, w, p)
                for a, b, c in zip(got, again, want):
                    assert (a is None) == (b is None) == (c is None)
                    if a is not None:
                        assert torch.equal(a, c) and torch.equal(a, b)
        if long_runs:
            g = count.count_sorted_plain(*inputs, weights, None)[1]
            assert int(g.max()) > 2**32
    for N in (0, 4097):   # empty, and every column the sentinel
        lanes = torch.full((L, N), ln.SENTINEL, dtype=torch.int64, device=card)
        pos = torch.arange(N, device=card)
        got = _kernels.count_sorted(*count_inputs(lanes), None, pos)
        want = count.count_sorted_plain(*count_inputs(lanes), None, pos)
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)


def kmer_set(k, n, seed):
    """n random k-mers plus ones whose suffix, prefix or both are
    palindromic (k - 1 even), all-A and all-T, as Python ints."""
    rng = np.random.RandomState(seed)
    rand = lambda b: "".join("ACGT"[c] for c in rng.randint(0, 4, b))
    out = [brute.str2num(rand(k)) for _ in range(n)]
    out += [0, 4**k - 1]
    m = k - 1
    if m % 2 == 0:
        for _ in range(6):
            half = rand(m // 2)
            pal = half + brute.revcomp_str(half)
            out += [brute.str2num(rand(1) + pal), brute.str2num(pal + rand(1))]
    return out


RESIDUE_L = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 16, 17, 32]


@pytest.mark.parametrize("L", RESIDUE_L)
def test_junction_keys_residues(card, L):
    """K3a and its global mode (junction_entries) at every residue of
    (k-1) mod 16 for k-mers of L lanes (k = 16(L-1)+1 .. 16L), key lanes
    as rows and, past 3 lanes, as packed words, with palindromic sides and
    columns past n_solid."""
    for k in range(16 * (L - 1) + 1, 16 * L + 1):
        if k < 2:
            continue
        kmers = kmer_set(k, 300, k)
        solid = solid_columns(kmers, L)
        n = solid.shape[1]
        keys, pay = _kernels.junction_keys(solid.to(card), n - 5, k,
                                           junctions.packed_keys(k),
                                           junctions.key_rows(k))
        pkeys, ppay = junctions.junction_keys_plain(solid, n - 5, k)
        assert torch.equal(keys.cpu(), pkeys) and torch.equal(pay.cpu(), ppay)
        gbase, tot = 2 * n, 5 * n
        got = junctions.junction_entries(solid.to(card), n - 5, k, gbase, tot, 3)
        want = junctions.junction_entries_plain(solid, n - 5, k, gbase, tot, 3)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def poisoned(card, nbytes):
    """Fill nbytes of the caching allocator's memory with 0xAB and free it,
    so that a kernel's outputs allocated next start as garbage, not as
    zeros or an earlier run's bytes: an element the kernel fails to write
    then shows."""
    torch.full((nbytes,), 0xAB, dtype=torch.uint8, device=card)


def expand_case(S, S1, rooted, seed):
    """K19's inputs (F, parent, Qd, did) with random rows: a share `rooted`
    of Qd's rows ROOTED, 30% of F's, the other flags random, Qd's and F's
    pointers up to 3 past either end (the clamps) and did up to S1 (a row
    not selected: clamped)."""
    rng = np.random.RandomState(seed)

    def rows(n, hi, share):
        dsf = rng.randint(0, 1 << 28, n)
        dsf |= (rng.rand(n) < 0.3) * chains._F_SETTLED
        dsf |= (rng.rand(n) < 0.2) * chains._F_FIX
        dsf |= (rng.rand(n) < share) * chains._F_ROOTED
        return torch.from_numpy(np.stack([rng.randint(-3, hi + 3, n), dsf,
                                          rng.randint(0, 1 << 40, n),
                                          rng.randint(0, 1 << 20, n)], 1))

    F = rows(S1, S1, 0.3)
    Qd = rows(S, S, rooted)
    parent = torch.from_numpy(rng.randint(0, S, S1))
    did = torch.from_numpy(rng.randint(0, S1 + 1, S))
    return F, parent, Qd, did


@pytest.mark.parametrize("case,S,rooted", [
    ("mostly_rooted", 1 << 19, 0.95), ("none_rooted", 1 << 19, 0.0),
    ("odd", (1 << 19) + 1554, 0.5), ("level_2_22", 1 << 22, 0.46),
    ("twice", (1 << 19) + 3, 0.5)])
def test_hier_expand_rows(card, case, S, rooted):
    """K19 against its plain version: most rows ROOTED, none, S not a
    multiple of the 256-row block, a level of 2^22 rows, and (twice) the
    kernel again over its own output; each written over a fresh copy of
    Qd, which is returned, and run twice."""
    S1 = S // 4
    args = expand_case(S, S1, rooted, S % 9973)
    want = chains.hier_expand_plain(*args)
    F, parent, Qd, did = [a.to(card) for a in args]
    for _ in range(2):
        Qc = Qd.clone()
        got = _kernels.hier_expand(F, parent, Qc, did)
        assert got.data_ptr() == Qc.data_ptr()
        assert torch.equal(got.cpu(), want)
    if case == "twice":
        again = chains.hier_expand_plain(F.cpu(), parent.cpu(), Qc.cpu(), did.cpu())
        assert torch.equal(_kernels.hier_expand(F, parent, Qc, did).cpu(), again)
    assert torch.equal(Qd.cpu(), args[2])


def spell_case(k, n, C, U, seed, one_member=False, unassigned=0):
    """K11's inputs: n random k-mers of k bases (C columns, the rest the
    sentinel) cut at random into U unitigs (one_member: U = n unitigs of
    one member), each walking its columns forward or backward, each k-mer
    a member on a random strand (so starts and members on the minus
    strand), ranks 0 .. length-1 along the walk, uid in start order as
    chain_finish numbers them; the last `unassigned` k-mers belong to no
    unitig."""
    rng = np.random.RandomState(seed)
    L = (k + 15) // 16
    solid = np.full((L, C), 0xFFFFFFFF, np.int64)
    solid[:, :n] = rng.randint(0, 1 << 32, (L, n), dtype=np.uint64).astype(np.int64)
    solid[0, :n] &= (1 << (2 * (k % 16 or 16))) - 1
    m = n - unassigned
    if one_member:
        U = m
    cut = np.sort(1 + rng.choice(m - 1, U - 1, replace=False))
    s, e = np.concatenate([[0], cut]), np.concatenate([cut, [m]])
    # each unitig walks its columns forward or backward; each k-mer is a
    # member on a random strand (its canonical form's)
    back = rng.rand(U) < 0.5
    piece = np.repeat(np.arange(U), e - s)
    col = np.arange(m)
    rk = np.where(back[piece], e[piece] - 1 - col, col - s[piece])
    o = col + C * (rng.rand(m) < 0.5)
    so = np.zeros(U, np.int64)
    so[piece[rk == 0]] = o[rk == 0]
    uid_of = np.empty(U, np.int64)
    uid_of[np.argsort(so, kind="stable")] = np.arange(U)
    uid, rank = np.full(2 * C, -1, np.int64), np.zeros(2 * C, np.int64)
    uid[o] = uid_of[piece]
    rank[o] = rk
    length, start_oid = np.zeros(2 * C, np.int64), np.zeros(2 * C, np.int64)
    length[uid_of], start_oid[uid_of] = e - s, so
    counts = np.zeros(C, np.int64)
    counts[:n] = rng.randint(2, 60, n)
    return ([torch.from_numpy(a) for a in (solid, counts, uid, rank, length,
                                           start_oid)], U)


@pytest.mark.parametrize("case,k", [
    ("k16", 16), ("k32", 32), ("k512", 512), ("k151", 151), ("k255", 255),
    ("one_member", 31), ("one_member", 255), ("drop", 31), ("drop", 151),
    ("tail", 31), ("tail", 63)])
def test_spell_unitigs_shapes(card, case, k):
    """K11 against its plain version at k = 16, 32, 512 (whole top lanes),
    151 and 255; with unitigs of one member, half of them starting on the
    minus strand; with n_members below the members' count (writes past
    both outputs dropped); and with k-mers in no unitig (zero tails past
    the unitigs).  Each run twice on poisoned memory (no output is filled
    before the kernels write it)."""
    n, C = 3000, 4096 + 37
    tensors, U = spell_case(k, n, C, 211, k, one_member=case == "one_member",
                            unassigned=100 if case == "tail" else 0)
    n_members = n - 333 if case == "drop" else n
    want = engine.spell_unitigs_plain(*tensors, U, k, n_members)
    args = [t.to(card) for t in tensors]
    for _ in range(2):
        poisoned(card, 16 * (n + k * U) + (1 << 20))
        got = _kernels.spell_unitigs(*args, U, k, n_members)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    if case == "tail":
        assert int((want[1] == 0).sum()) == 100
    if case == "drop":
        assert want[0].shape[0] == n_members + (k - 1) * U


@pytest.mark.parametrize("offset,S", [(0, (1 << 19) + 1554), (1, 1 << 19),
                                      (2, 1 << 19), (3, 4100)])
def test_fixpoint_bits_vector_loads(card, offset, S):
    """K17's bitmap where valid and gid are 16-byte aligned and S cuts a
    16-row group, and where they are views that start `offset` entries in:
    above level 0 (a row a thread) the bitmap is still right, at level 0
    (16 valid bytes a load) such a valid is refused."""
    rng = np.random.RandomState(S + offset)
    vfull = torch.from_numpy(rng.rand(S + offset) < 0.7)
    gfull = torch.from_numpy(rng.randint(0, 1 << 40, S + offset))
    salt = (0x85EBCA6B * 3) & 0xFFFFFFFF
    valid, gid = vfull[offset:], gfull[offset:]
    vc, gc = vfull.to(card)[offset:], gfull.to(card)[offset:]
    assert (vc.data_ptr() % 16 == 0) == (offset == 0)
    for g, gcard in ((None, None), (gid, gc)):
        if g is None and offset:
            with pytest.raises(ValueError, match="16-byte alignment"):
                _kernels.fixpoint_bits(None, vc, salt)
            continue
        want = chains.fixpoint_bits_plain(g, valid, salt)
        poisoned(card, 4 * S)
        assert torch.equal(_kernels.fixpoint_bits(gcard, vc, salt).cpu(), want)


def link_case(k, U, n_pool, seed):
    """K11's layout of U unitigs of k-1 to k+4 k-mers (a fifth of them 1-5,
    whose ends overlap), random bases, each end overwritten half the time by a (k-1)-mer of a pool of n_pool (or its
    reverse complement; n_pool = 1: every end, the pool's one key): codes
    u8 and the k-mer counts."""
    rng = np.random.RandomState(seed)
    m = k - 1
    length = np.where(rng.rand(U) < 0.2, rng.randint(1, 6, U),
                      rng.randint(m, m + 6, U)).astype(np.int64)
    codes = rng.randint(0, 4, int(length.sum()) + m * U).astype(np.uint8)
    pool = rng.randint(0, 4, (n_pool, m)).astype(np.uint8)
    pre = np.concatenate([[0], np.cumsum(length + m)[:-1]])
    for u in range(U):
        for at in (pre[u], pre[u] + length[u]):
            if n_pool == 1 or rng.rand() < 0.5:
                x = pool[rng.randint(n_pool)]
                codes[at:at + m] = (x ^ 2)[::-1] if rng.rand() < 0.5 else x
    return torch.from_numpy(codes), torch.from_numpy(length)


@pytest.mark.parametrize("case", ["pool", "one_group", "tiles"])
@pytest.mark.parametrize("k", [31, 151])
def test_link_kernels(card, k, case):
    """K22 and K23 against their plain versions, bitwise, through the
    stable sort between them (the same permutation on both sides), each
    launched once; K23's words in their sorted order (its blocks land in
    any order); one key for every end needs more room than K23's first 8U
    (a second launch); 70,000 unitigs put groups across its 1024-entry
    blocks.  Then the whole unitig_links on the card against the CPU's,
    and link_join of the unitigs' strings on the card."""
    U, n_pool = {"pool": (3000, 600), "one_group": (40, 1),
                 "tiles": (70000, 20000)}[case]
    codes, length = link_case(k, U, n_pool, 7 * k + U)
    ends = torch.cumsum(length, 0)
    keys = engine.link_ends_plain(codes, ends, k)
    perm, top = sort_op.lex_sort_words(list(keys))
    lower = keys[1:] if keys.shape[0] > 1 else None
    want = engine.link_pairs_plain(top, perm, lower, U)
    codes_c, ends_c = codes.to(card), ends.to(card)
    before = dict(_kernels.LAUNCHES)
    poisoned(card, 64 * U + (1 << 20))
    keys_c = _kernels.link_ends(codes_c, ends_c, k)
    assert torch.equal(keys_c.cpu(), keys)
    perm_c, top_c = sort_op.lex_sort_words(list(keys_c))
    assert torch.equal(perm_c.cpu(), perm)
    poisoned(card, 64 * U + (1 << 20))
    got = _kernels.link_pairs(top_c, perm_c, keys_c[1:] if lower is not None
                              else None, U)
    assert torch.equal(torch.sort(got).values.cpu(), torch.sort(want).values)
    assert _kernels.LAUNCHES["link_ends"] == before["link_ends"] + 1
    assert (_kernels.LAUNCHES["link_pairs"]
            == before["link_pairs"] + (2 if case == "one_group" else 1))
    if case == "one_group":
        assert want.shape[0] > 8 * U
    links = engine.unitig_links(codes, length, k)
    assert engine.unitig_links(codes_c, length.to(card), k) == links
    bases = np.frombuffer(b"ACTG", np.uint8)[codes.numpy()].tobytes().decode()
    at = np.concatenate([[0], np.cumsum(length.numpy() + k - 1)])
    seqs = [bases[a:b] for a, b in zip(at[:-1], at[1:])]
    before = dict(_kernels.LAUNCHES)
    assert engine.link_join(seqs, k, card) == links
    assert _kernels.LAUNCHES["link_pairs"] > before["link_pairs"]
