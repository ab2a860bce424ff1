"""Exact junction keys past 3 lanes (k-1 > 48), on the port's plain paths.

bcalm_tpu keys a (k-1)-mer of more than 3 lanes by a 96-bit hash, lane by
lane through ``h = (h ^ lane) * H + c`` with odd multipliers: a flip of
bit 31 in one lane passes to bit 31 of h, and a flip of bit 31 in the
next lane cancels it, in all three words.  Two (k-1)-mers that differ so
key one group of four entries there, and neither junction is glued.  The
port keys by the exact (k-1)-mer (its packed words), so its output is the
brute oracle's and the benchmark's plain reference's, and differs from
bcalm_tpu's exactly there.  Then a seeded 300 bp read set at k = 151,
judged by the plain reference, and the plain W-word pair rule on groups
built by hand for W = 1-16.
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bcalm_tpu import engine as jengine
from bcalm_tpu.io import fasta_writer as jwriter
from bcalm_tpu.models import lanes as jln
from bcalm_tpu.ops import junctions as jjunc
from bcalm_tpu_torch import cli as tcli
from bcalm_tpu_torch import convert
from bcalm_tpu_torch import engine as tengine
from bcalm_tpu_torch.io import fasta_writer as twriter
from bcalm_tpu_torch.models import lanes as tln
from bcalm_tpu_torch.ops import junctions as tjunc
from bcalm_tpu_torch.ops import sort as tsort
from bcalm_tpu_torch.oracle import brute
from tests.test_torch_engine import fasta

BENCH = pathlib.Path(__file__).resolve().parent.parent / "cdbg_bench"
_FLIP = str.maketrans("ACGT", "TGCA")   # code ^ 2: bit 1 of a base


def _bench_module(name):
    spec = importlib.util.spec_from_file_location(
        f"exact_keys_test_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # reference.py's dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def _rand(rng, n: int) -> str:
    return "".join("ACGT"[c] for c in rng.randint(0, 4, n))


def colliding_pair(k: int, seed: int):
    """Two canonical (k-1)-mers x, y whose lanes differ only in bit 31 of
    lanes 1 and 2 (the first base of each, A <-> T or C <-> G)."""
    m = k - 1
    p1 = tln.top_lane_bases(m)          # the first base of lane 1
    p2 = p1 + 16                        # of lane 2
    rng = np.random.RandomState(seed)
    while True:
        x = "A" + _rand(rng, m - 1)
        y = (x[:p1] + x[p1].translate(_FLIP) + x[p1 + 1:p2]
             + x[p2].translate(_FLIP) + x[p2 + 1:])
        if all(brute.canonical_num(brute.str2num(s), m) == brute.str2num(s)
               for s in (x, y)):
            return x, y


def collision_reads(k: int, seed: int):
    """Reads holding x and y each once inside random flanks, twice each
    (abundance 2): each read is one unitig in the brute oracle."""
    x, y = colliding_pair(k, seed)
    rng = np.random.RandomState(seed + 1)
    reads = [_rand(rng, 40) + s + _rand(rng, 40) for s in (x, y)]
    return reads + reads, x, y


@pytest.mark.parametrize("k", [63, 151])
def test_colliding_kminus1_mers_are_glued(k, tmp_path):
    """At k = 63 (4 lanes) and k = 151 (10 lanes): the two (k-1)-mers'
    lanes differ in bit 31 of two adjacent lanes and bcalm_tpu's three
    hash words are equal; the port's FASTA has the brute oracle's unitigs
    and links, the plain reference finds no error in it, and bcalm_tpu's
    FASTA differs (it leaves both junctions unglued)."""
    reads, x, y = collision_reads(k, k)
    m = k - 1
    lanes = jln.ints_to_lanes([brute.str2num(x), brute.str2num(y)], m)
    diff = lanes[:, 0] ^ lanes[:, 1]
    assert diff.tolist() == [0, 1 << 31, 1 << 31] + [0] * (lanes.shape[0] - 3)
    assert jjunc.use_hash_keys(k)
    h = [np.asarray(w) for w in jjunc._hash96(jnp.asarray(lanes))]
    assert all(w[0] == w[1] for w in h)

    jcfg = jengine.EngineConfig(k=k, abundance_min=2, block_reads=32,
                                max_len=256)
    got = tengine.build_from_seqs(reads, convert.engine_config_from_jax(jcfg),
                                  "cpu")
    want = brute.build(reads, k, abundance_min=2)
    assert len(got.seqs) == len(want.unitigs) == 2
    assert (brute.canonical_unitig_set(got.seqs)
            == brute.canonical_unitig_set(u.seq for u in want.unitigs))
    assert sorted(map(brute.unitig_key, reads[:2])) == \
        brute.canonical_unitig_set(got.seqs)

    reads_fa, out_fa = tmp_path / "reads.fa", tmp_path / "port.unitigs.fa"
    reads_fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    out_fa.write_text(fasta(got, twriter))
    reference = _bench_module("reference")
    sol = reference.reference(str(reads_fa), k, 2, torch.device("cpu"))
    checks, _ = reference.judge(sol, str(out_fa))
    assert checks == {name: 0 for name in reference.CHECKS}

    jax_us = jengine.build_from_seqs(reads, jcfg)
    assert len(jax_us.seqs) == 4
    assert fasta(jax_us, jwriter) != fasta(got, twriter)


def test_k151_reads_judged_by_the_reference(tmp_path, monkeypatch, capsys):
    """A seeded set of 300 bp reads (the benchmark's generator: repeats,
    errors, duplicates) built by the port's CLI on the CPU at k = 151 with
    -abundance-min 2, and the plain reference's comparison: every count
    0."""
    gen = _bench_module("gen")
    reference = _bench_module("reference")
    cfg = {"genome_len": 12000, "repeat_frac": 0.05, "coverage": 30,
           "read_len": 300, "err_rate": 0.0008, "dup_frac": 0.2}
    reads_fa = tmp_path / "reads.fa"
    n_reads = gen.write_reads(str(reads_fa), cfg, 2147483700)
    assert n_reads == 1200
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(["-in", str(reads_fa), "-kmer-size", "151",
                      "-abundance-min", "2", "-verbose", "1",
                      "-out", str(tmp_path / "o")]) == 0
    assert "[junction_key_words] 5" in capsys.readouterr().out
    sol = reference.reference(str(reads_fa), 151, 2, torch.device("cpu"))
    checks, detail = reference.judge(sol, str(tmp_path / "o.unitigs.fa"))
    assert checks == {name: 0 for name in reference.CHECKS}
    assert detail["unitigs"] > 10 and detail["links"] > 10


def _word_groups(W: int, seed: int):
    """Packed keys (W, E) and payloads (E,) of hand-made groups, in a
    shuffled entry order, over C = 18 vertices, and the successor array
    the pair rule must give: an OUT/IN pair on distinct vertices (an
    edge), a pair differing only in the last word, one differing only in
    a middle word, a group of three, a pair of sentinel keys (every lane
    the sentinel), a pair of two OUT ends, a pair on one vertex, a second
    edge, and an OUT/IN pair whose key's first lane alone is the sentinel
    (an edge past 3 lanes, where the last lane decides too; at W = 1, 2
    lanes, the first lane decides)."""
    rng = np.random.RandomState(seed)
    C = 18

    def key():
        return [int(v) for v in rng.randint(-2**62, 2**62, W, dtype=np.int64)]

    def pay(oid, role):
        return oid | (role << 30)

    entries = []
    k1 = key()
    entries += [(k1, pay(0, 0)), (k1, pay(1, 1))]            # edge 0 -> 1
    k2 = key()
    entries += [(k2, pay(2, 0)), (k2[:-1] + [k2[-1] ^ 1], pay(3, 1))]
    k3 = key()
    mid = (W - 1) // 2
    k3b = list(k3)
    k3b[mid] ^= 1 << 40
    entries += [(k3, pay(4, 0)), (k3b, pay(5, 1))]
    k4 = key()
    entries += [(k4, pay(6, 0)), (k4, pay(7, 1)), (k4, pay(8 + C, 1))]
    sent0, _ = tjunc.sentinel_words(2)
    k5 = [sent0] * W                                        # the sentinel
    entries += [(k5, pay(9, 0)), (k5, pay(10, 1))]
    k9 = key()
    k9[0] = (sent0 & ~0xFFFFFFFF) | (k9[0] & 0xFFFFFFFF)   # first lane only
    entries += [(k9, pay(16, 0)), (k9, pay(17, 1))]
    k6 = key()
    entries += [(k6, pay(11, 0)), (k6, pay(12 + C, 0))]
    k7 = key()
    entries += [(k7, pay(13, 0)), (k7, pay(13 + C, 1))]
    k8 = key()
    entries += [(k8, pay(14 + C, 0)), (k8, pay(15, 1))]      # edge 14- -> 15
    order = rng.permutation(len(entries))
    keys = torch.tensor([[entries[i][0][w] for i in order] for w in range(W)],
                        dtype=torch.int64)
    payload = torch.tensor([entries[i][1] for i in order], dtype=torch.int64)
    succ = torch.full((2 * C,), -1, dtype=torch.int64)
    for src, dst in ((0, 1), (14 + C, 15)) + (((16, 17),) if W > 1 else ()):
        succ[src] = dst
        succ[(dst + C) % (2 * C)] = (src + C) % (2 * C)
    return keys, payload, C, succ


@pytest.mark.parametrize("W", list(range(1, 17)))
def test_plain_pair_rule_on_w_words(W):
    """junction_pairs_plain (what K3b is held against on the card) on a
    key of W packed words: only the two whole-key pairs of one OUT and one
    IN end on distinct vertices are edges; a difference in the last or a
    middle word, a third entry, the sentinel, equal roles and one vertex
    each break the pair; a key whose first lane alone is the sentinel is
    valid past 3 lanes.  lex_sort_words sorts the W words."""
    keys, payload, C, want = _word_groups(W, seed=W)
    perm, top = tsort.lex_sort_words(list(keys))
    assert torch.equal(top, keys[0][perm])
    lower = keys[1:] if W > 1 else None
    succ = tjunc.junction_pairs_plain(top, perm, payload, C, 2 * W, lower)
    assert torch.equal(succ, want)
    heads = tjunc.pair_heads(top, None if lower is None else lower[:, perm],
                             2 * W, tjunc.exact_sentinel(2 * W))
    # the edges, the same-role and the one-vertex pairs are pair heads
    assert int(heads.sum()) == (5 if W > 1 else 4)


def first_lane_all_g_reads(k: int, seed: int):
    """A read, twice, that holds a canonical (k-1)-mer x = G^16 X C^16
    (k-1 a multiple of 16, X random and not its own reverse complement)
    inside random flanks: x's first lane is the sentinel's value, its last
    lane is not."""
    m = k - 1
    assert m % 16 == 0
    rng = np.random.RandomState(seed)
    while True:
        mid = _rand(rng, m - 32)
        x = "G" * 16 + mid + "C" * 16
        if brute.canonical_num(brute.str2num(x), m) == brute.str2num(x) \
                and brute.revcomp_str(x) != x:
            break
    read = _rand(rng, 30) + x + _rand(rng, 30)
    return [read, read], x


@pytest.mark.parametrize("k", [65, 97])
def test_first_lane_all_g_junction_is_glued(k, tmp_path):
    """k-1 a multiple of 16, past 3 lanes: a junction (k-1)-mer whose
    first lane is 16 G (so its packed top word reads as the sentinel's)
    and whose last lane is 16 C is glued: the port's FASTA has the brute
    oracle's unitigs (the read is one unitig), the plain reference finds
    no error in it, and it is bcalm_tpu's FASTA (whose hashed key is no
    sentinel)."""
    reads, x = first_lane_all_g_reads(k, k)
    m = k - 1
    lanes = jln.ints_to_lanes([brute.str2num(x)], m)
    assert int(lanes[0, 0]) == tln.SENTINEL and int(lanes[-1, 0]) == 0x55555555
    jcfg = jengine.EngineConfig(k=k, abundance_min=2, block_reads=32,
                                max_len=256)
    got = tengine.build_from_seqs(reads, convert.engine_config_from_jax(jcfg),
                                  "cpu")
    want = brute.build(reads, k, abundance_min=2)
    assert (brute.canonical_unitig_set(got.seqs)
            == brute.canonical_unitig_set(u.seq for u in want.unitigs))
    assert brute.canonical_unitig_set(got.seqs) == [brute.unitig_key(reads[0])]
    reads_fa, out_fa = tmp_path / "reads.fa", tmp_path / "port.unitigs.fa"
    reads_fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    out_fa.write_text(fasta(got, twriter))
    reference = _bench_module("reference")
    sol = reference.reference(str(reads_fa), k, 2, torch.device("cpu"))
    checks, _ = reference.judge(sol, str(out_fa))
    assert checks == {name: 0 for name in reference.CHECKS}
    assert fasta(jengine.build_from_seqs(reads, jcfg), jwriter) == \
        fasta(got, twriter)
