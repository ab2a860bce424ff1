"""CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: each test asks the `card` fixture for a device and skips
when torch has no CUDA device (the kernels have no CPU mode).  The file
imports no JAX, so a GPU machine without JAX runs it with
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`.
Every kernel does integer work: exact equality.
"""

import io
import pickle

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


@pytest.mark.parametrize("C,n_solid", [(16, 16), (1024, 1000), (1 << 20, 900_000),
                                       (4096, 0)])
def test_run_scans(card, C, n_solid):
    rng = np.random.RandomState(C)
    idx = np.arange(2 * C)
    succ = np.where(rng.rand(2 * C) < 0.3, -1, rng.randint(0, 2 * C, 2 * C))
    succ[:C] = np.where(rng.rand(C) < 0.9, idx[:C] + 1, succ[:C])
    succ = torch.from_numpy(succ)
    got = _kernels.run_scans(succ.to(card), n_solid, C)
    want = runchains.run_scans_plain(succ, n_solid, C)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


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


def mirror_graph(N, seed, n_invalid=8):
    """(2N,) mirror-symmetric succ: chains, cycles and hairpins (v ->
    mirror(v)) over random orientations; valid (2N,) bool."""
    rng = np.random.RandomState(seed)
    n_valid = N - n_invalid
    succ = np.full(2 * N, -1, np.int64)
    order = rng.permutation(n_valid)
    i = 0
    while i < n_valid:
        m = int(min(n_valid - i, rng.geometric(0.01)))
        oids = order[i:i + m] + N * rng.randint(0, 2, m)
        if m == 1 and rng.rand() < 0.3:
            succ[oids[0]] = (oids[0] + N) % (2 * N)
        ring = m > 1 and rng.rand() < 0.2
        nxt = np.roll(oids, -1)
        for a, b in zip(oids[:m if ring else m - 1], nxt[:m if ring else m - 1]):
            succ[a] = b
            succ[(b + N) % (2 * N)] = (a + N) % (2 * N)
        i += m
    valid = (np.arange(2 * N) % N) < n_valid
    return torch.from_numpy(succ), torch.from_numpy(valid)


@pytest.mark.parametrize("N,weighted", [(4096, False), (4096, True),
                                        (1 << 18, False)])
def test_chain_finish(card, N, weighted):
    succ, valid = mirror_graph(N, N + weighted)
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


def compacted(k, seed=5):
    """The port's locality-ordered compaction (CPU) of a read set: the
    reordered table, its counts, the run structure and the chain dict."""
    seqs = reads(seed, n=600, k=k)
    cfg = engine.EngineConfig(k=k, abundance_min=2, block_reads=64, max_len=128)
    unique, counts, minpos, _ = engine.count_blocks(
        packing.iter_blocks(seqs, k, block_reads=64, max_len=128), cfg, "cpu")
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


@pytest.mark.parametrize("C,n_solid,gbase", [(1024, 1000, 5 << 20),
                                             (1 << 20, 900_000, 3 << 20)])
def test_run_scans_global_base(card, C, n_solid, gbase):
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
    keys, pay, _ = want
    perm = sort_op.lex_argsort(list(keys))
    s_keys, s_pay = keys[:, perm].contiguous(), pay[perm]
    got = junctions.junction_edges(s_keys.to(card), s_pay.to(card), tot)
    want = junctions.junction_edges_plain(s_keys, s_pay, tot)
    ok = want[0]
    assert torch.equal(got[0].cpu(), ok) and int(ok.sum()) > 0
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu()[ok], b[ok])


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


@pytest.mark.parametrize("n_dev", [1, 4, 8, 256])
@pytest.mark.parametrize("with_slots", [False, True])
def test_route_buckets(card, n_dev, with_slots):
    rng = np.random.RandomState(n_dev)
    N, C = 300_000, 3
    stacked = torch.from_numpy(rng.randint(0, 2**32, size=(C, N),
                                           dtype=np.uint64).astype(np.int64))
    valid = torch.from_numpy(rng.rand(N) < 0.8)
    owner = torch.from_numpy(np.where(rng.rand(N) < 0.3, 0,
                                      rng.randint(0, n_dev, N)))
    for cap in (N, max(1, N // (3 * n_dev))):
        args = (n_dev, cap, with_slots)
        got = _kernels.route_buckets(stacked.to(card), valid.to(card),
                                     owner.to(card), *args)
        want = pipeline.route_to_buckets_plain(stacked, valid, owner, *args)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_glue_compose(card):
    rng = np.random.RandomState(0)
    M = 1 << 16
    pred = torch.from_numpy(np.where(rng.rand(M) < 0.9, rng.randint(0, M, M), -1))
    Q = chains.init_state(pred, torch.ones(M, dtype=torch.bool))
    for _ in range(4):
        anc = Q[torch.clamp(Q[:, 0], 0, M - 1)]
        need = torch.from_numpy(rng.rand(M) < 0.7)
        got = _kernels.glue_compose(Q.to(card), anc.to(card), need.to(card))
        want = distcompact.glue_compose_plain(Q, anc, need)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        Q = want[0]


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
