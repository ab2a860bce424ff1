"""The links between unitig ends (plain K22 link_ends, the stable sort,
plain K23 link_pairs, the pair words' sort and the host tuples) vs
bcalm_tpu.engine.link_join, through link_join(seqs, k) and through the
codes entry (engine.unitig_links on K11's layout).

The unitig sets are drawn with numpy: each end a (k-1)-mer of a small
pool (or its reverse complement) or a fresh random one, so key groups of
one to eight and more ends occur, with self-links (a unitig whose suffix
is its prefix) and a unitig linked to both strands of itself (a
palindromic end, k-1 even).  The cases also hold no unitig, one unitig,
a set with no link and one key shared by every end.  k = 5 to 151 covers
one and two key words, the word edges (k-1 = 31, 32, 33) and five words.
Exact equality, order included.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from bcalm_tpu import cli as jcli
from bcalm_tpu import engine as jengine
from bcalm_tpu_torch import cli as tcli
from bcalm_tpu_torch import engine
from bcalm_tpu_torch.models import lanes as ln

KS = [5, 31, 32, 33, 34, 63, 65, 151]
CASES = ["pool", "pool_wide", "none", "one", "one_circular", "no_links",
         "one_group"]
_RC = str.maketrans("ACGT", "TGCA")


def rc(s: str) -> str:
    return s.translate(_RC)[::-1]


def rand_seq(rng, n: int) -> str:
    return "".join("ACGT"[c] for c in rng.randint(0, 4, n))


def palindrome(rng, m: int) -> str:
    half = rand_seq(rng, m // 2)
    return half + rc(half)


def pooled_set(rng, k: int, U: int, n_pool: int):
    """U unitigs whose ends come from a pool of n_pool (k-1)-mers half the
    time; the first two are a self-linked one and, k-1 even, one whose
    suffix is a palindrome also starting it (linked to both of its
    strands)."""
    m = k - 1
    pool = [rand_seq(rng, m) for _ in range(n_pool)]
    if m % 2 == 0:
        pool[0] = palindrome(rng, m)

    def end():
        if rng.rand() < 0.5:
            x = pool[rng.randint(n_pool)]
            return rc(x) if rng.rand() < 0.5 else x
        return rand_seq(rng, m)
    seqs = [pool[1] + rand_seq(rng, 2) + pool[1],
            pool[0] + rand_seq(rng, 1) + pool[0]]
    for _ in range(U - 2):
        if rng.rand() < 0.15:            # a short unitig: its ends overlap
            seqs.append(rand_seq(rng, k + rng.randint(0, m)))
        else:
            seqs.append(end() + rand_seq(rng, rng.randint(0, 4)) + end())
    return seqs


def distinct_ends(rng, k: int, U: int):
    """U unitigs whose ends and their reverse complements are all distinct
    and none a palindrome: no link."""
    m, seen, seqs = k - 1, set(), []
    while len(seqs) < U:
        a, b = rand_seq(rng, m), rand_seq(rng, m)
        keys = {a, rc(a), b, rc(b)}
        if len(keys) == 4 and not keys & seen:
            seen |= keys
            seqs.append(a + rand_seq(rng, 3) + b)
    return seqs


def unitig_set(case: str, k: int):
    rng = np.random.RandomState(1000 * k + CASES.index(case))
    if case == "pool":
        return pooled_set(rng, k, 60, 8)
    if case == "pool_wide":
        return pooled_set(rng, k, 120, 40)
    if case == "none":
        return []
    if case == "one":
        return [rand_seq(rng, k + 7)]
    if case == "one_circular":
        x = rand_seq(rng, k - 1)
        return [x + rand_seq(rng, 5) + x]
    if case == "no_links":
        return distinct_ends(rng, k, 20)
    if case == "one_group":
        x = rand_seq(rng, k - 1)
        return [x + rand_seq(rng, rng.randint(0, 4)) + x for _ in range(24)]
    raise ValueError(case)


def codes_of(seqs, k: int):
    """K11's layout: the unitigs' bases back to back, and their k-mer
    counts."""
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACTG", np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = lut[np.frombuffer("".join(seqs).encode(), np.uint8)]
    length = np.array([len(s) - (k - 1) for s in seqs], np.int64)
    return torch.from_numpy(codes.copy()), torch.from_numpy(length)


@pytest.mark.parametrize("entry", ["strings", "codes"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_links_match_jax(k, case, entry):
    seqs = unitig_set(case, k)
    want = jengine.link_join(seqs, k)
    if entry == "strings":
        got = engine.link_join(seqs, k)
        assert engine.link_join(seqs, k, torch.device("cpu")) == got
    else:
        got = engine.unitig_links(*codes_of(seqs, k), k)
    assert got == want
    assert all(type(x) is str for t in got[:4] for x in t[1::2])
    if case == "no_links" or case == "none":
        assert want == []
    if case == "one_group":
        assert len(want) == 2 * len(seqs) ** 2
    if case in ("pool", "pool_wide"):
        # the drawn set holds what the case is for
        m = k - 1
        groups = Counter([s[-m:] for s in seqs] + [rc(s[:m]) for s in seqs]
                         + [s[:m] for s in seqs] + [rc(s[-m:]) for s in seqs])
        assert min(groups.values()) == 1
        assert max(groups.values()) >= (8 if case == "pool" else 2)
        assert (0, "+", 0, "+") in want
        if m % 2 == 0:
            assert {(1, "+", 1, "+"), (1, "+", 1, "-")} <= set(want)


@pytest.mark.parametrize("k", KS)
def test_link_ends_plain_packs_as_jax(k):
    """The plain K22's keys are the JAX package's packed key columns of the
    same ends (out: suffix, rc(prefix); in: prefix, rc(suffix)), word for
    word, in K22's entry order."""
    seqs = unitig_set("pool", k)
    codes, length = codes_of(seqs, k)
    keys = engine.link_ends_plain(codes, torch.cumsum(length, 0), k)
    m = k - 1
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACTG", np.uint8)] = np.arange(4, dtype=np.uint8)

    def mat(strs):
        return lut[np.frombuffer("".join(strs).encode(), np.uint8)].reshape(-1, m)
    pre = mat([s[:m] for s in seqs])
    suf = mat([s[-m:] for s in seqs])
    want = jengine._pack_ends(np.concatenate(
        [suf, (pre ^ 2)[:, ::-1], pre, (suf ^ 2)[:, ::-1]]))
    assert keys.shape == (ln.end_words(k), 4 * len(seqs))
    np.testing.assert_array_equal(keys.numpy().view(np.uint64), want.T)


@pytest.mark.parametrize("k", [5, 34])
def test_plain_kernels_on_no_unitig(k):
    empty = torch.zeros((0,), dtype=torch.int64)
    keys = engine.link_ends_plain(torch.zeros((0,), dtype=torch.uint8), empty, k)
    assert keys.shape == (ln.end_words(k), 0)
    assert engine.link_pairs_plain(empty, empty, keys[1:] if k > 33 else None,
                                   0).shape == (0,)


def write_unitigs(path, seqs, k: int):
    """A unitigs FASTA of seqs with BCALM-style headers and stale links."""
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{i} LN:i:{len(s)} KC:i:{len(s) - k + 1} km:f:2.0 "
                    f"L:+:{(i + 1) % len(seqs)}:-\n{s}\n")


@pytest.mark.parametrize("case", ["pool_wide", "one_group", "no_links"])
@pytest.mark.parametrize("k", [31, 151])
def test_redo_links_cli(tmp_path, monkeypatch, k, case):
    """-redo-links through the port's CLI on the CPU rewrites a unitigs
    file's L: fields exactly as the JAX package's CLI does, byte for byte,
    and again leaves the file as it is."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    seqs = unitig_set(case, k)
    paths = {}
    for side in ("jax", "torch"):
        paths[side] = str(tmp_path / side)
        write_unitigs(paths[side] + ".unitigs.fa", seqs, k)
    args = ["-in", "x", "-redo-links", "-kmer-size", str(k)]
    assert jcli.main(args + ["-out", paths["jax"]]) == 0
    assert tcli.main(args + ["-out", paths["torch"]]) == 0
    data = {side: open(p + ".unitigs.fa", "rb").read()
            for side, p in paths.items()}
    assert data["torch"] == data["jax"]
    n_links = sum(t.startswith("L:") for t in data["torch"].decode().split())
    assert n_links == len(jengine.link_join(seqs, k))
    assert tcli.main(args + ["-out", paths["torch"]]) == 0
    assert open(paths["torch"] + ".unitigs.fa", "rb").read() == data["jax"]


def test_redo_links_wants_the_card(tmp_path, monkeypatch, capsys):
    """-redo-links, like a build, runs on the device the CLI resolves: with
    CUDA asked for and no card it exits 1 and leaves the file alone."""
    monkeypatch.delenv(tcli.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prefix = str(tmp_path / "u")
    write_unitigs(prefix + ".unitigs.fa", unitig_set("pool", 31), 31)
    before = open(prefix + ".unitigs.fa", "rb").read()
    assert tcli.main(["-in", "x", "-redo-links", "-kmer-size", "31",
                      "-out", prefix]) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert open(prefix + ".unitigs.fa", "rb").read() == before
