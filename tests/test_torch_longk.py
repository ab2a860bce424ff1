"""Long k (k > 128, 9-32 lanes) on the port's plain paths against bcalm_tpu,
and filter_abundance (K9 without its minpos row) against JAX's.

200 reads of 400 bp (bench.make_genome with repeats, bench.sample_reads
with errors and duplicates): reads of 150 bp hold no 151-mer.  At k = 151
(10 lanes) and k = 255 (16 lanes) the port's FASTA is byte-identical to
bcalm_tpu's, resident and with chunks small enough for a multi-pass count
over key ranges (K5 and K6's plain versions at 10 and 16 lanes).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from bcalm_tpu import engine as jengine
from bcalm_tpu.io import fasta_writer as jwriter
from bcalm_tpu.ops import count as jcount
from bcalm_tpu_torch import convert
from bcalm_tpu_torch import engine as tengine
from bcalm_tpu_torch.io import fasta_writer as twriter
from bcalm_tpu_torch.ops import count as tcount
from tests.test_torch_engine import fasta

import bench

MAX_LEN = 416


@functools.lru_cache(maxsize=None)
def long_reads(seed=5):
    rng = np.random.RandomState(seed)
    genome = bench.make_genome(20_000, rng, repeat_frac=0.05)
    reads = bench.sample_reads(genome, 200, 400, rng, err_rate=0.002,
                               dup_frac=0.2)
    return tuple("".join("ACTG"[c] for c in r) for r in reads)


def jax_config(k):
    return jengine.EngineConfig(k=k, abundance_min=2, block_reads=64,
                                max_len=MAX_LEN)


@functools.lru_cache(maxsize=None)
def jax_build(k):
    return jengine.build_from_seqs(list(long_reads()), jax_config(k))


@pytest.mark.parametrize("k", [151, 255])
def test_long_k_byte_identical(k):
    want = jax_build(k)
    got = tengine.build_from_seqs(list(long_reads()),
                                  convert.engine_config_from_jax(jax_config(k)),
                                  "cpu")
    assert fasta(got, twriter) == fasta(want, jwriter)
    assert (fasta(got, twriter, all_abundance_counts=True)
            == fasta(want, jwriter, all_abundance_counts=True))
    np.testing.assert_array_equal(got.histogram, want.histogram)
    for key in ("distinct_kmers", "solid_kmers", "kmer_occurrences"):
        assert got.stats[key] == want.stats[key]
    assert len(got.seqs) > 40 and len(got.links) > 10


@pytest.mark.parametrize("k", [151, 255])
def test_long_k_multipass_byte_identical(k):
    """Small chunks (chunk_kmers, resident_kmers, 8-read blocks): the count
    goes over several key ranges and writes the resident build's bytes."""
    cfg = convert.engine_config_from_jax(jax_config(k))
    cfg.block_reads, cfg.chunk_kmers, cfg.resident_kmers = 8, 2048, 4096
    got = tengine.build_from_seqs(list(long_reads()), cfg, "cpu")
    assert got.stats["ooc_passes"] > 1 and got.stats["ooc_ranges"] > 1
    assert fasta(got, twriter) == fasta(jax_build(k), jwriter)


@pytest.mark.parametrize("k", [13, 151])
def test_filter_abundance_matches_jax(k):
    L = (k + 15) // 16
    N = 3000
    rng = np.random.RandomState(k)
    unique = rng.randint(0, 2**32, size=(L, N), dtype=np.uint64).astype(np.uint32)
    counts = rng.randint(0, 7, size=N).astype(np.int32)
    n_unique = 2500
    for amin, amax in ((2, 2**31 - 1), (1, 3), (7, 9)):
        js, jc, jn = jcount.filter_abundance(
            jnp.asarray(unique), jnp.asarray(counts), jnp.int32(n_unique),
            amin, amax)
        ts, tc, tn = tcount.filter_abundance(
            convert.lanes_from_numpy(unique, "cpu"),
            convert.counts_from_numpy(counts, "cpu"), n_unique, amin, amax)
        assert tuple(ts.shape) == (L, N) and tuple(tc.shape) == (N,)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(convert.lanes_to_numpy(ts),
                                      np.asarray(js))
        np.testing.assert_array_equal(convert.counts_to_numpy(tc),
                                      np.asarray(jc))
