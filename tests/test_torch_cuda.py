"""CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: each test asks the `card` fixture for a device and skips
when torch has no CUDA device (the kernels have no CPU mode).  The file
imports no JAX, so a GPU machine without JAX runs it with
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`.
Every kernel does integer work: exact equality.
"""

import io

import numpy as np
import pytest
import torch

from bcalm_tpu.io import packing
from bcalm_tpu.oracle import brute
from bcalm_tpu_torch import engine
from bcalm_tpu_torch.io import fasta_writer
from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels, chains, count, extract, junctions
from bcalm_tpu_torch.ops import sort as sort_op

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


@pytest.mark.parametrize("L,weighted", [(1, False), (2, True), (4, False)])
def test_count_runs(card, L, weighted):
    rng = np.random.RandomState(L)
    pool = rng.randint(0, 2**32, size=(L, 300), dtype=np.uint64)
    lanes = torch.from_numpy(pool[:, rng.randint(0, 300, 50_000)].astype(np.int64))
    lanes[:, rng.rand(50_000) < 0.1] = ln.SENTINEL
    w = torch.from_numpy(rng.randint(1, 9, 50_000)) if weighted else None
    pos = torch.from_numpy(rng.randint(0, 2**32, 50_000, dtype=np.uint64).astype(np.int64))
    perm = torch.from_numpy(np.lexsort(tuple(lanes.numpy()[::-1])))
    args = [lanes[:, perm].contiguous().to(card),
            None if w is None else w[perm].to(card), pos[perm].to(card)]
    got, want = _kernels.count_runs(*args), count.count_runs_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [13, 31, 32, 63])
def test_junctions(card, k):
    L = ln.num_lanes(k)
    kmers = sorted(brute.count_kmers(reads(k, k=k), k))
    cols = [[(x >> (32 * (L - 1 - j))) & 0xFFFFFFFF for x in kmers]
            for j in range(L)]
    solid = torch.tensor(cols, dtype=torch.int64, device=card)
    n = solid.shape[1]
    hashed = junctions.use_hash_keys(k)
    keys, pay = _kernels.junction_keys(solid, n - 3, k, hashed,
                                       junctions.key_rows(k))
    pkeys, ppay = junctions.junction_keys_plain(solid, n - 3, k)
    assert torch.equal(keys, pkeys) and torch.equal(pay, ppay)
    perm = sort_op.lex_argsort(list(keys))
    s_keys, s_pay = keys[:, perm].contiguous(), pay[perm]
    succ = _kernels.junction_pairs(s_keys, s_pay, n, hashed)
    assert torch.equal(succ, junctions.junction_pairs_plain(s_keys, s_pay, n, hashed))
    assert int((succ >= 0).sum()) > 0


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
