"""`python -m bcalm_tpu_torch` command line: output parity, the -devices N
build and its refusals (the keep-alive server: tests/test_torch_server.py).

The parity tests drive both command lines (bcalm_tpu on JAX's CPU
backend, the port with BCALM_TORCH_DEVICE=cpu) on one FASTA file and
require byte-identical unitigs files; with -devices N, JAX runs on N of
conftest's virtual CPU devices and the port on N gloo ranks.
"""

import os

import numpy as np
import pytest
import torch

from bcalm_tpu import cli as jcli
from bcalm_tpu_torch import cli as tcli
from bcalm_tpu_torch import engine as teng

import bench


def write_reads(path, seed=5, n=400):
    rng = np.random.RandomState(seed)
    genome = bench.make_genome(20_000, rng, repeat_frac=0.05)
    reads = bench.sample_reads(genome, n, 150, rng, err_rate=0.002,
                               dup_frac=0.2)
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{''.join('ACTG'[c] for c in r)}\n")


def test_cli_byte_identical(tmp_path, monkeypatch):
    fa = tmp_path / "reads.fa"
    write_reads(fa)
    args = ["-in", str(fa), "-kmer-size", "31", "-abundance-min", "2",
            "-verbose", "0"]
    assert jcli.main(args + ["-out", str(tmp_path / "jax")]) == 0
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(args + ["-out", str(tmp_path / "torch")]) == 0
    want = (tmp_path / "jax.unitigs.fa").read_bytes()
    assert (tmp_path / "torch.unitigs.fa").read_bytes() == want
    assert want.count(b">") > 10


def test_missing_input_exits_1(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(["-in", str(tmp_path / "nope.fa")]) == 1
    assert "input not found" in capsys.readouterr().err


@pytest.mark.parametrize("n_dev", [2, 4])
def test_cli_devices_byte_identical(tmp_path, monkeypatch, n_dev):
    fa = tmp_path / "reads.fa"
    write_reads(fa, seed=n_dev)
    args = ["-in", str(fa), "-kmer-size", "31", "-abundance-min", "2",
            "-verbose", "0", "-devices", str(n_dev)]
    assert jcli.main(args + ["-out", str(tmp_path / "jax")]) == 0
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(args + ["-out", str(tmp_path / "torch")]) == 0
    want = (tmp_path / "jax.unitigs.fa").read_bytes()
    assert (tmp_path / "torch.unitigs.fa").read_bytes() == want
    assert want.count(b">") > 10
    # the store written during the build is removed at the end, as JAX's
    assert not os.path.exists(str(tmp_path / "torch") + "_btpu")


def _both_refuse(tmp_path, monkeypatch, capsys, extra):
    """Exit codes and messages of both command lines for one refusal."""
    fa = tmp_path / "reads.fa"
    fa.write_text(">r\nACGTACGTACGTACGTACGTACGT\n")
    args = ["-in", str(fa), "-kmer-size", "21", "-out",
            str(tmp_path / "out")] + extra
    codes = [jcli.main(args)]
    jerr = capsys.readouterr().err
    codes.append(tcli.main(args))
    terr = capsys.readouterr().err
    assert codes == [1, 1]
    assert not (tmp_path / "out.unitigs.fa").exists()
    return jerr, terr


@pytest.mark.parametrize("kind", ["min", "max"])
def test_devices_refuses_min_max_solidity(tmp_path, monkeypatch, capsys, kind):
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    jerr, terr = _both_refuse(tmp_path, monkeypatch, capsys,
                              ["-devices", "2", "-solidity-kind", kind])
    assert "-devices with -solidity-kind min/max is not supported" in terr
    assert terr == jerr


def test_devices_beyond_the_cards(tmp_path, monkeypatch, capsys):
    """With CUDA requested, -devices N past torch.cuda.device_count() exits
    1 with JAX's message (here 8 cards are claimed, as conftest gives JAX 8
    devices; no rank is started)."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(teng, "device_bytes", lambda device: 80 << 30)
    jerr, terr = _both_refuse(tmp_path, monkeypatch, capsys,
                              ["-devices", "9"])
    assert terr == jerr == "-devices 9: only 8 devices available\n"


def test_devices_missing_input_exits_1(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    args = ["-in", str(tmp_path / "nope.fa"), "-devices", "2"]
    assert jcli.main(args) == 1
    jerr = capsys.readouterr().err
    assert tcli.main(args) == 1
    assert capsys.readouterr().err == jerr
    assert "input not found" in jerr


def write_album(tmp_path, seed=9):
    """An album of one FASTA file and one gzipped FASTQ file drawn from one
    genome, with lowercase reads and N bases."""
    import gzip

    rng = np.random.RandomState(seed)
    genome = bench.make_genome(6000, rng, repeat_frac=0.05)
    seqs = ["".join("ACTG"[c] for c in r) for r in bench.sample_reads(
        genome, 360, 120, rng, err_rate=0.003, dup_frac=0.2)]
    seqs = [s.lower() if i % 7 == 0 else s for i, s in enumerate(seqs)]
    seqs = [s[:50] + "N" + s[51:] if i % 11 == 0 else s
            for i, s in enumerate(seqs)]
    fa, fq = tmp_path / "a.fa", tmp_path / "b.fastq.gz"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs[:180])))
    with gzip.open(fq, "wt") as f:
        for i, s in enumerate(seqs[180:]):
            f.write(f"@q{i}\n{s}\n+\n{'I' * len(s)}\n")
    album = tmp_path / "album.txt"
    album.write_text(f"{fa}\n{fq}\n")
    return album


def test_cli_album_fastq_gz_counts_byte_identical(tmp_path, monkeypatch):
    """A FASTA + FASTQ.gz album under -all-abundance-counts with an
    abundance cap and a short histogram: the same unitigs bytes."""
    album = write_album(tmp_path)
    args = ["-in", str(album), "-kmer-size", "27", "-abundance-min", "2",
            "-abundance-max", "5", "-histo-max", "20", "-all-abundance-counts",
            "-nb-cores", "1", "-verbose", "0"]
    assert jcli.main(args + ["-out", str(tmp_path / "jax")]) == 0
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(args + ["-out", str(tmp_path / "torch")]) == 0
    want = (tmp_path / "jax.unitigs.fa").read_bytes()
    assert (tmp_path / "torch.unitigs.fa").read_bytes() == want
    assert want.count(b">") > 10


def test_cli_devices_k63_byte_identical(tmp_path, monkeypatch):
    """-devices 2 at k = 63 (four key lanes): the same unitigs bytes."""
    fa = tmp_path / "reads.fa"
    write_reads(fa, seed=63, n=200)
    args = ["-in", str(fa), "-kmer-size", "63", "-abundance-min", "2",
            "-verbose", "0", "-devices", "2"]
    assert jcli.main(args + ["-out", str(tmp_path / "jax")]) == 0
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(args + ["-out", str(tmp_path / "torch")]) == 0
    want = (tmp_path / "jax.unitigs.fa").read_bytes()
    assert (tmp_path / "torch.unitigs.fa").read_bytes() == want
    assert want.count(b">") > 10
