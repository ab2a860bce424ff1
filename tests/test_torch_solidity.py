"""Multi-sample solidity, `-abundance-min auto` and `-solid-kmers-out` of
`python -m bcalm_tpu_torch` vs bcalm_tpu's command line.

An album (a file of filenames) of two read sets from one genome goes
through both CLIs (bcalm_tpu on JAX's CPU backend, the port with
BCALM_TORCH_DEVICE=cpu) under each `-solidity-kind`; min and max count
each sample at abundance 1, combine the tables and compact on the
canonical-order path (no first-occurrence keys).  Every unitigs file and
every solid k-mer listing must be byte-identical.

Album runs pass `-nb-cores 1`: with more workers both packages interleave
the album's files in arrival order (bcalm_tpu.utils.dispatcher
.parallel_files), and under `-solidity-kind sum` the first-occurrence
keys, and with them the unitig order, follow that interleave.
"""

import numpy as np
import pytest

from bcalm_tpu import cli as jcli
from bcalm_tpu import engine as jengine
from bcalm_tpu_torch import cli as tcli
from bcalm_tpu_torch import engine as tengine
from tests.test_torch_cli import write_reads
from tests.test_torch_resume import both, fasta, write_fasta

import bench


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")


def album(tmp_path, n=200):
    """Two read sets of one genome (write_reads' seed-5 reads, and other
    reads of the same genome) and their album; returns its path."""
    write_reads(tmp_path / "s5.fa", seed=5, n=n)
    genome = bench.make_genome(20_000, np.random.RandomState(5),
                               repeat_frac=0.05)
    reads = bench.sample_reads(genome, n, 150, np.random.RandomState(6),
                               err_rate=0.002, dup_frac=0.2)
    with open(tmp_path / "s6.fa", "w") as f:
        for i, r in enumerate(reads):
            f.write(f">q{i}\n{''.join('ACTG'[c] for c in r)}\n")
    path = tmp_path / "album.txt"
    path.write_text(f"{tmp_path / 's5.fa'}\n{tmp_path / 's6.fa'}\n")
    return str(path)


def album_args(tmp_path, amin, kind):
    return ["-in", album(tmp_path), "-kmer-size", "31", "-abundance-min",
            str(amin), "-solidity-kind", kind, "-nb-cores", "1"]


@pytest.mark.parametrize("kind,amin", [("min", 1), ("min", 2), ("max", 2),
                                       ("sum", 2)])
def test_multi_sample_byte_identical(tmp_path, kind, amin):
    rcs, (pj, pt) = both(tmp_path, kind, album_args(tmp_path, amin, kind))
    assert rcs == (0, 0)
    assert fasta(pt) == fasta(pj) and fasta(pt).count(b">") > 10


def test_solidity_kinds_fixture(tmp_path):
    """tests/test_cli.py's three-sequence fixture: min keeps the k-mers of
    both samples only, max and sum all of them."""
    s1, s2, both_s = "ACTGCTGACTGAGTCA", "GGTCATCGGCATATAG", "TTTACGCATCGAATCC"
    write_fasta(tmp_path / "s1.fa", [s1, both_s])
    write_fasta(tmp_path / "s2.fa", [s2, both_s])
    (tmp_path / "album.txt").write_text(
        f"{tmp_path / 's1.fa'}\n{tmp_path / 's2.fa'}\n")
    sizes = {}
    for kind in ("min", "max", "sum"):
        rcs, (pj, pt) = both(tmp_path, kind, [
            "-in", str(tmp_path / "album.txt"), "-kmer-size", "13",
            "-abundance-min", "1", "-solidity-kind", kind, "-nb-cores", "1"])
        assert rcs == (0, 0) and fasta(pt) == fasta(pj)
        sizes[kind] = len(fasta(pt))
    assert sizes["min"] < sizes["max"] == sizes["sum"]


def test_multi_sample_resume_canonical_chains(tmp_path):
    """-only-uf over an album stores counts without first-occurrence keys
    and the canonical-order chains; -skip-bcalm -skip-bglue resumes from
    them, byte-identical to the full runs of both packages."""
    args = album_args(tmp_path, 2, "min")
    rcs, (fj, ft) = both(tmp_path, "full", args)
    assert rcs == (0, 0) and fasta(fj) == fasta(ft)
    rcs, (pj, pt) = both(tmp_path, "r", args + ["-only-uf"])
    assert rcs == (0, 0)
    rcs, _ = both(tmp_path, "r", args + ["-skip-bcalm", "-skip-bglue"])
    assert rcs == (0, 0)
    assert fasta(pt) == fasta(pj) == fasta(fj)


def noisy_reads(tmp_path):
    """Signal k-mers at abundance 8 and singleton noise reads (a histogram
    valley), as tests/test_cli.py's auto tests."""
    import random
    rng = random.Random(9)
    genome = "".join(rng.choice("ACTG") for _ in range(400))
    reads = [genome[i:i + 40] for _ in range(8) for i in range(0, 360, 15)]
    reads += ["".join(rng.choice("ACTG") for _ in range(40)) for _ in range(30)]
    fa = tmp_path / "noisy.fa"
    write_fasta(fa, reads)
    return str(fa)


@pytest.mark.parametrize("extra", [[], ["-abundance-min-threshold", "3"]])
def test_abundance_min_auto(tmp_path, capsys, extra):
    args = ["-in", noisy_reads(tmp_path), "-kmer-size", "15",
            "-abundance-min", "auto", "-verbose", "1"] + extra
    rcs, (pj, pt) = both(tmp_path, "auto", args)
    assert rcs == (0, 0) and fasta(pt) == fasta(pj)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("auto abundance-min = ")]
    assert len(lines) == 2 and lines[0] == lines[1]
    cutoff = int(lines[0].split("= ")[1])
    assert cutoff >= 2
    rcs, (ej, et) = both(tmp_path, "explicit", args[:5] + [str(cutoff)])
    assert rcs == (0, 0) and fasta(et) == fasta(pt)


def test_abundance_min_auto_multi_sample(tmp_path):
    args = album_args(tmp_path, "auto", "max")
    rcs, (pj, pt) = both(tmp_path, "auto", args)
    assert rcs == (0, 0) and fasta(pt) == fasta(pj)


@pytest.mark.parametrize("multi", [False, True])
def test_solid_kmers_out(tmp_path, multi):
    if multi:
        args = album_args(tmp_path, 2, "min")
    else:
        write_reads(tmp_path / "s5.fa", seed=5, n=200)
        args = ["-in", str(tmp_path / "s5.fa"), "-kmer-size", "31",
                "-abundance-min", "2"]
    pj, pt = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jcli.main(args + ["-out", str(tmp_path / "j"),
                             "-solid-kmers-out", str(pj)]) == 0
    assert tcli.main(args + ["-out", str(tmp_path / "t"),
                             "-solid-kmers-out", str(pt)]) == 0
    assert pt.read_bytes() == pj.read_bytes()
    assert pt.read_text().count("\n") > 1000


def test_numpy_helpers_match_jax():
    """combine_sample_counts, auto_abundance_min and the k-mer string of
    the port (numpy copies) equal the JAX package's."""
    rng = np.random.RandomState(2)
    pool = rng.randint(0, 2**32, size=(2, 400), dtype=np.uint64).astype(np.uint32)
    runs = []
    for _ in range(3):
        cols = np.unique(rng.randint(0, 400, 250))
        runs.append((pool[:, cols], rng.randint(1, 50, cols.size).astype(np.int32)))
    runs.append((np.zeros((2, 0), np.uint32), np.zeros(0, np.int32)))
    for kind in ("sum", "min", "max"):
        for a, b in zip(tengine.combine_sample_counts(runs, kind, k=31),
                        jengine.combine_sample_counts(runs, kind, k=31)):
            np.testing.assert_array_equal(a, b)
    for h in (rng.randint(0, 100, 40), np.array([5, 9, 4, 4, 7, 1]),
              np.arange(30)[::-1], np.array([1, 2])):
        for cap in (1, 2, 5, 20):
            assert (tengine.auto_abundance_min(h, cap)
                    == jengine.auto_abundance_min(h, cap))
    from bcalm_tpu.models import lanes as jl
    from bcalm_tpu_torch.models import lanes as tl
    for col in pool[:, :20].T:
        assert (tl.int_to_string(tl.lanes_to_int(col), 31)
                == jl.int_to_string(jl.lanes_to_int(col), 31))
