"""The read generator of the benchmark, frozen: a random genome with
repeats, sampled as short reads with substitution errors and PCR
duplicates, written as a FASTA file of one-line records.

It is the simulator of ``chip_smoke.py`` (make_genome, sample_reads,
write_reads), copied so that the benchmark imports nothing of the program
and later changes to the smoke cannot move the yardstick.  A configuration
file (configs/<name>.json) gives its parameters under ``reads``.
"""

from __future__ import annotations

import numpy as np

# the byte of each 2-bit code as the smoke writes it (A=0 C=1 T=2 G=3)
CODE_TO_ASCII = np.frombuffer(b"ACTG", dtype=np.uint8)
SEED_SPACE = 1 << 32   # numpy's RandomState takes seeds below 2**32


def make_genome(genome_len, rng, repeat_frac=0.0):
    """Random genome; repeat_frac of its length is covered by copies of
    earlier segments of 500-5000 bp, so the graph has real junctions."""
    genome = rng.randint(0, 4, size=genome_len).astype(np.uint8)
    target = int(genome_len * repeat_frac)
    placed = 0
    while placed < target:
        seg_len = int(rng.randint(500, 5001))
        src = int(rng.randint(0, genome_len - seg_len))
        dst = int(rng.randint(0, genome_len - seg_len))
        genome[dst:dst + seg_len] = genome[src:src + seg_len]
        placed += seg_len
    return genome


def sample_reads(genome, n_reads, read_len, rng, err_rate=0.0,
                 dup_frac=0.0):
    """(n_reads, read_len) uint8 codes with substitution errors at
    err_rate; dup_frac of the reads are emitted twice (PCR duplicates),
    so some error k-mers reach count 2 and survive -abundance-min 2."""
    n_orig = int(n_reads / (1.0 + dup_frac)) if dup_frac else n_reads
    starts = rng.randint(0, genome.shape[0] - read_len, size=n_orig)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]].copy()
    if err_rate > 0:
        n_err = rng.binomial(n_orig * read_len, err_rate)
        pos_r = rng.randint(0, n_orig, size=n_err)
        pos_c = rng.randint(0, read_len, size=n_err)
        shift = rng.randint(1, 4, size=n_err).astype(np.uint8)
        reads[pos_r, pos_c] = (reads[pos_r, pos_c] + shift) % 4
    if dup_frac:
        n_dup = n_reads - n_orig
        dup_idx = rng.randint(0, n_orig, size=n_dup)
        reads = np.concatenate([reads, reads[dup_idx]], axis=0)
        perm = rng.permutation(reads.shape[0])
        reads = reads[perm]
    return reads


def n_reads(reads_cfg: dict) -> int:
    """Reads of a configuration: its coverage of the genome."""
    return int(reads_cfg["coverage"] * reads_cfg["genome_len"]
               / reads_cfg["read_len"])


def write_reads(path: str, reads_cfg: dict, seed: int) -> int:
    """Write the configuration's reads for `seed` to path; returns the
    number of reads.  One generator, seeded by `seed`, draws the genome
    and then the reads."""
    rng = np.random.RandomState(seed % SEED_SPACE)
    genome = make_genome(reads_cfg["genome_len"], rng,
                         repeat_frac=reads_cfg["repeat_frac"])
    read_len = reads_cfg["read_len"]
    reads = sample_reads(genome, n_reads(reads_cfg), read_len, rng,
                         err_rate=reads_cfg["err_rate"],
                         dup_frac=reads_cfg["dup_frac"])
    rec = np.empty((reads.shape[0], 3 + read_len + 1), np.uint8)
    rec[:, :3] = np.frombuffer(b">r\n", np.uint8)
    rec[:, 3:3 + read_len] = CODE_TO_ASCII[reads]
    rec[:, 3 + read_len] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())
    return reads.shape[0]
