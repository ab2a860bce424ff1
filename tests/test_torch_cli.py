"""`python -m bcalm_tpu_torch` command line: output parity and the options
that are not ported (the multi-device build and the keep-alive server).

The parity test drives both command lines (bcalm_tpu on JAX's CPU
backend, the port with BCALM_TORCH_DEVICE=cpu) on one FASTA file and
requires byte-identical unitigs files.
"""

import numpy as np
import pytest

from bcalm_tpu import cli as jcli
from bcalm_tpu_torch import cli as tcli

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


@pytest.mark.parametrize("extra,item", [
    (["-devices", "2"], "A14"),
    (["-server", "sock"], "A12"),
])
def test_not_ported_options_exit_1(tmp_path, monkeypatch, capsys, extra, item):
    fa = tmp_path / "reads.fa"
    fa.write_text(">r\nACGTACGTACGTACGTACGTACGT\n")
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(["-in", str(fa), "-kmer-size", "21", "-out",
                      str(tmp_path / "out")] + extra) == 1
    assert f"not yet ported (ROADMAP {item})" in capsys.readouterr().err


def test_missing_input_exits_1(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(["-in", str(tmp_path / "nope.fa")]) == 1
    assert "input not found" in capsys.readouterr().err
