"""Multi-pass builds of bcalm_tpu_torch vs bcalm_tpu, end to end.

The port's out-of-core build writes the bytes of the JAX package's
out-of-core build and of its own resident build: on the end-to-end
scenario of tests/test_ooc_count.py, on a branching input (repeats, read
errors, duplicates) at abundance-min 1 and 2, and through the command
line with ``-max-memory``; with the device block cache on, off and
overflowing.  The counting itself is held against the JAX package table
by table in tests/test_torch_ooc.py.
"""

import io

import numpy as np
import pytest

from bcalm_tpu import cli as jcli
from bcalm_tpu import engine as jengine
from bcalm_tpu.io import fasta_writer as jwriter
from bcalm_tpu_torch import cli as tcli
from bcalm_tpu_torch import engine as tengine
from bcalm_tpu_torch.io import fasta_writer as twriter
from tests.test_ooc_count import _reads
from tests.test_torch_ooc import configs

import bench


def fasta(us, writer) -> str:
    buf = io.StringIO()
    writer.write_fasta(us, buf)
    return buf.getvalue()


def test_end_to_end_build_matches_jax_and_in_memory():
    reads = _reads(7, 3500, 55, 3)
    jcfg, tcfg = configs(17)
    want = jengine.build_from_seqs(reads, jcfg)
    got = tengine.build_from_seqs(reads, tcfg, "cpu")
    assert got.stats["ooc_passes"] == want.stats["ooc_passes"] > 1
    text = fasta(got, twriter)
    assert text == fasta(want, jwriter)
    np.testing.assert_array_equal(got.histogram, want.histogram)
    tcfg.resident_kmers = 1 << 30
    in_memory = tengine.build_from_seqs(reads, tcfg, "cpu")
    assert "ooc_passes" not in in_memory.stats
    assert fasta(in_memory, twriter) == text
    np.testing.assert_array_equal(in_memory.histogram, got.histogram)


@pytest.fixture(scope="module")
def branching():
    """Motivation's branching input: 2,000 reads of a 20 kbp genome with
    5% repeats, 0.2% errors and 20% duplicates."""
    rng = np.random.RandomState(0)
    genome = bench.make_genome(20_000, rng, repeat_frac=0.05)
    reads = bench.sample_reads(genome, 2000, 150, rng, err_rate=0.002,
                               dup_frac=0.2)
    return ["".join("ACTG"[c] for c in r) for r in reads]


@pytest.mark.parametrize("amin", [1, 2])
def test_branching_fasta_byte_identical(branching, amin):
    jcfg, tcfg = configs(31, chunk=2048, resident=4096, max_len=160,
                         amin=amin)
    want = jengine.build_from_seqs(branching, jcfg)
    got = tengine.build_from_seqs(branching, tcfg, "cpu")
    assert got.stats["ooc_passes"] == want.stats["ooc_passes"] > 1
    assert got.stats["ooc_ranges"] >= 3
    text = fasta(got, twriter)
    assert text == fasta(want, jwriter) and text.count(">") > 100
    tcfg.resident_kmers = 1 << 30
    resident = tengine.build_from_seqs(branching, tcfg, "cpu")
    assert "ooc_passes" not in resident.stats
    assert fasta(resident, twriter) == text


def test_cli_max_memory_byte_identical(tmp_path, monkeypatch, capsys):
    """-max-memory is honoured (no 'ignored' note) and the output is the
    JAX command line's; a budget this small forces multi-pass counting on
    a larger input, so the in-process run checks that separately."""
    from tests.test_torch_cli import write_reads

    fa = tmp_path / "reads.fa"
    write_reads(fa)
    args = ["-in", str(fa), "-kmer-size", "31", "-abundance-min", "2",
            "-verbose", "0", "-max-memory", "300", "-max-disk", "100"]
    assert jcli.main(args + ["-out", str(tmp_path / "jax")]) == 0
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    capsys.readouterr()
    assert tcli.main(args + ["-out", str(tmp_path / "torch")]) == 0
    assert "ignored" not in capsys.readouterr().err
    want = (tmp_path / "jax.unitigs.fa").read_bytes()
    assert (tmp_path / "torch.unitigs.fa").read_bytes() == want
    assert want.count(b">") > 10


def test_cli_multipass_rereads_input(tmp_path, monkeypatch):
    """The CLI's multi-pass count re-reads the FASTA for each pass
    (reread) and writes the resident run's bytes."""
    from tests.test_torch_cli import write_reads

    fa = tmp_path / "reads.fa"
    write_reads(fa)
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    args = ["-in", str(fa), "-kmer-size", "31", "-abundance-min", "2"]
    assert tcli.main(args + ["-out", str(tmp_path / "res")]) == 0
    seen = {}
    real = tengine.build_from_blocks

    def small_budget(blocks, cfg, device, reread=None, **kw):
        # the block generator has not started: its geometry follows cfg
        cfg.block_reads, cfg.chunk_kmers, cfg.resident_kmers = 16, 1024, 2048
        us = real(blocks, cfg, device, reread=reread, **kw)
        seen.update(us.stats)
        return us

    monkeypatch.setattr(tengine, "build_from_blocks", small_budget)
    assert tcli.main(args + ["-out", str(tmp_path / "ooc")]) == 0
    assert seen["ooc_passes"] > 1
    assert ((tmp_path / "ooc.unitigs.fa").read_bytes()
            == (tmp_path / "res.unitigs.fa").read_bytes())


@pytest.mark.parametrize("cache_mb", [512, 0, 0.05])
def test_device_block_cache_matches_jax(cache_mb):
    """The device block cache held (512 MB), off (0) and overflowing (50
    kB: the port's int64 blocks take ~170 kB, JAX's uint32 ones ~85 kB)
    gives JAX's bytes and passes at the same chunk and resident sizes."""
    reads = _reads(7, 3500, 55, 3)
    jcfg, tcfg = configs(17)
    jcfg.dev_block_cache_mb = tcfg.dev_block_cache_mb = cache_mb
    want = jengine.build_from_seqs(reads, jcfg)
    got = tengine.build_from_seqs(reads, tcfg, "cpu")
    assert got.stats["ooc_passes"] == want.stats["ooc_passes"] > 1
    assert fasta(got, twriter) == fasta(want, jwriter)
    held = got.stats["ooc_block_cache_mb"]
    assert (held > 0) == (cache_mb == 512), held


@pytest.mark.parametrize("cache_mb", [512, 0])
def test_cli_later_passes_replay_the_cache(tmp_path, monkeypatch, cache_mb):
    """With the cache holding the input the CLI reads the FASTA once, for
    the first pass; without it every pass re-reads it.  Same bytes as the
    resident run either way."""
    from tests.test_torch_cli import write_reads

    fa = tmp_path / "reads.fa"
    write_reads(fa)
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    args = ["-in", str(fa), "-kmer-size", "31", "-abundance-min", "2"]
    assert tcli.main(args + ["-out", str(tmp_path / "res")]) == 0
    seen, opened = {}, []
    real, real_blocks = tengine.build_from_blocks, tcli._input_blocks

    def counting(*a, **kw):
        opened.append(1)
        return real_blocks(*a, **kw)

    def small_budget(blocks, cfg, device, reread=None, **kw):
        cfg.block_reads, cfg.chunk_kmers, cfg.resident_kmers = 16, 1024, 2048
        cfg.dev_block_cache_mb = cache_mb
        us = real(blocks, cfg, device, reread=reread, **kw)
        seen.update(us.stats)
        return us

    monkeypatch.setattr(tcli, "_input_blocks", counting)
    monkeypatch.setattr(tengine, "build_from_blocks", small_budget)
    assert tcli.main(args + ["-out", str(tmp_path / "ooc")]) == 0
    assert seen["ooc_passes"] > 1
    if cache_mb:
        assert len(opened) == 1 and seen["ooc_block_cache_mb"] > 0
    else:
        assert len(opened) == seen["ooc_passes"]
        assert seen["ooc_block_cache_mb"] == 0
    assert ((tmp_path / "ooc.unitigs.fa").read_bytes()
            == (tmp_path / "res.unitigs.fa").read_bytes())

