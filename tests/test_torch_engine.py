"""End to end: bcalm_tpu_torch's unitigs FASTA is byte-identical to bcalm_tpu's.

Both packages get the same reads and configuration (through
convert.engine_config_from_jax); the port runs its plain paths on the CPU.
Fixtures: tiny_read, minitip, circular test1-3, pufferize, plus a
branching input (bench.make_genome with repeats, read through
bench.sample_reads with errors and duplicates).
"""

import io

import numpy as np
import pytest
import torch

from bcalm_tpu import engine as jengine
from bcalm_tpu.io import fasta_writer as jwriter
from bcalm_tpu_torch import convert
from bcalm_tpu_torch import engine as tengine
from bcalm_tpu_torch.io import fasta_writer as twriter
from tests.test_oracle import CIRC1, CIRC2, CIRC3, MINITIP_SEQS, PUFFERIZE, TINY

import bench


def fasta(us, writer, **kw) -> str:
    buf = io.StringIO()
    writer.write_fasta(us, buf, **kw)
    return buf.getvalue()


def assert_same_build(seqs, k, amin, block_reads=32, max_len=128):
    jcfg = jengine.EngineConfig(k=k, abundance_min=amin,
                                block_reads=block_reads, max_len=max_len)
    want = jengine.build_from_seqs(seqs, jcfg)
    got = tengine.build_from_seqs(seqs, convert.engine_config_from_jax(jcfg),
                                  "cpu")
    assert fasta(got, twriter) == fasta(want, jwriter)
    assert (fasta(got, twriter, all_abundance_counts=True)
            == fasta(want, jwriter, all_abundance_counts=True))
    np.testing.assert_array_equal(got.histogram, want.histogram)
    for key in ("distinct_kmers", "solid_kmers", "kmer_occurrences"):
        assert got.stats[key] == want.stats[key]
    return got


@pytest.mark.parametrize("name,seqs,k,amin", [
    ("tiny_read", [TINY], 13, 1),
    ("minitip", MINITIP_SEQS, 21, 2),
    ("minitip_amin1", MINITIP_SEQS, 21, 1),
    ("circular1", [CIRC1], 7, 1),
    ("circular2", [CIRC2], 7, 1),
    ("circular3", CIRC3, 7, 1),
    ("pufferize", PUFFERIZE, 9, 1),
])
def test_fixtures_byte_identical(name, seqs, k, amin):
    got = assert_same_build(seqs, k, amin)
    if name.startswith("circular1"):
        assert bool(got.circular[0])


def branching_reads(seed=3):
    rng = np.random.RandomState(seed)
    genome = bench.make_genome(20_000, rng, repeat_frac=0.05)
    reads = bench.sample_reads(genome, 800, 150, rng, err_rate=0.002,
                               dup_frac=0.2)
    return ["".join("ACTG"[c] for c in r) for r in reads]


@pytest.mark.parametrize("k", [31, 63])
def test_branching_input_byte_identical(k):
    got = assert_same_build(branching_reads(), k, 2, block_reads=64,
                            max_len=160)
    assert len(got.seqs) > 50 and len(got.links) > 50


def test_empty_result():
    cfg = tengine.EngineConfig(k=21, abundance_min=99)
    us = tengine.build_from_seqs(branching_reads()[:10], cfg, torch.device("cpu"))
    assert us.seqs == [] and us.stats["solid_kmers"] == 0
    assert fasta(us, twriter) == ""


def test_unitig_graph_over_the_port():
    """bcalm_tpu.graph.unitigs (numpy-only) navigates the port's UnitigSet
    exactly as it navigates bcalm_tpu's."""
    from bcalm_tpu.graph.unitigs import UnitigGraph

    seqs = branching_reads(4)
    jcfg = jengine.EngineConfig(k=31, abundance_min=2, block_reads=64,
                                max_len=160)
    want = UnitigGraph.from_unitig_set(jengine.build_from_seqs(seqs, jcfg))
    got = UnitigGraph.from_unitig_set(tengine.build_from_seqs(
        seqs, convert.engine_config_from_jax(jcfg), "cpu"))
    assert len(got) == len(want) > 50
    nodes = list(want.nodes())
    assert list(got.nodes()) == nodes
    for node in nodes:
        assert got.successors(node) == want.successors(node)
        assert got.predecessors(node) == want.predecessors(node)
    assert sum(got.is_branching(n) for n in nodes) > 0
