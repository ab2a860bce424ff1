"""Smoke run of bcalm_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--coverage 50] [--seed 0]

Phases (any failure raises, and the script exits non-zero):

1. device: card name, power limit, kernel build time, the build of the
   native ingest library (phase 3 asserts that it parsed the input);
2. fixtures: the port's build on the card vs the brute-force oracle on the
   reference fixtures, and the card's FASTA vs the CPU plain path's on a
   branching input;
3. full-size CLI run: an E. coli-class genome (4.6 Mbp, 5% repeats) read
   at 50x with 150 bp reads, 0.08% errors and 20% duplicates, built with
   ``-kmer-size 31 -abundance-min 2``, first as ``python -m
   bcalm_tpu_torch``, then through ``bcalm_tpu_torch.cli.main`` in this
   process, whose kernel launch counters are reset just before the call;
   the build checkpoints its solid set in ``<prefix>_btpu/`` (K9) and
   removes it at the end;
3b. the same reads and flags with ``-max-memory M``, M chosen from the
   port's memory model so that the resident budget holds at most a third
   of the distinct k-mers phase 3 counted: counting goes multi-pass over
   key ranges; again first as ``python -m bcalm_tpu_torch``, then
   through ``cli.main`` with the counters reset just before it.  At least
   3 ranges, the FASTA byte-identical to phase 3's, peak device memory
   within M;
3c. store and resume on the same reads: ``-only-uf -uf-stats`` keeps the
   store and its chains (as many classes as phase 3's unitigs); with the
   input renamed away, ``-skip-bcalm -skip-bglue`` and, after a fresh
   ``-only-uf``, ``-skip-bcalm`` alone (in process too, counters reset)
   write phase 3's bytes; ``-redo-links`` leaves phase 3's FASTA as it is;
3d. multi-sample solidity: a second read set of the same genome (seed +
   1); an album of the two under ``-solidity-kind min`` and ``max`` must
   give the canonical k-mers and the KC of numpy's min/max combination of
   the two samples' count tables; ``min`` over phase 3's file and a hard
   link to it (the canonical-order compaction at full width, in process
   too) gives phase 3's unitigs and KC; M, the doubling rounds and the
   K4/K10 times of that compaction are printed;
3e. ``-abundance-min auto``: the chosen cutoff, and the bytes of a run
   with that cutoff given;
3f. the ``-devices N`` build (parallel.pipeline.distributed_build) on the
   same reads with m = 10, in this process over an NCCL group of world
   size 1 (one card: every exchange is a real collective, trivially a
   copy), the launch counters reset just before it: its canonical unitig
   set, KC, km, per-k-mer abundances and link count must equal phase 3's
   output, and K13-K16 with the reused K1, K2, K3, K7, K8 and K11 must
   have launched; its stats and wall split are printed.  Then its
   multi-pass branch: the first 1/32 of the reads under a residency
   budget of a third of their distinct k-mers (key ranges, K5, one pass
   over the input per range), counters reset just before it, equal to
   the single-device build of the same reads.  ``python -m bcalm_tpu_torch
   ... -devices N`` with N past the cards exits 1 with the JAX package's
   message;
4. output invariants of the phase 3 run: each solid canonical k-mer once,
   KC sums, every L: link a real (k-1)-overlap;
5. each kernel vs its plain PyTorch version on the card, on the inputs
   the full-size runs fed it: bitwise equality, CUDA-event times, the
   launches of the run whose path needs it, the bound (bytes moved over
   the card's memory rate, or integer operations over its peak rate) and,
   where one PyTorch call computes the same function, that call's time;
   K14 in both its modes; K13 and K3's global mode (the sharded glue's
   junction entries) also with 4 ranks as owners, since at world size 1
   every owner is 0; K15 also at 4 and 8 destinations (synthetic owners).

The last line is {"ok": true, "device": {...}}.  Exits 1 without a result
when no CUDA device is available.

    python3 chip_smoke.py --devices N

runs only the kernel build and the ``-devices N`` build across N cards
(one NCCL rank per card, ``python -m bcalm_tpu_torch ... -devices N``) on
the phase 3 reads, held against the single-device build of the same
reads: unitig set, KC, km and link count.

    python3 chip_smoke.py --compare-tree DIR

runs only ``python -m bcalm_tpu_torch`` of the tree unpacked in DIR (for
example a parent commit, ``git archive``) and of this tree in turns on
the phase 3 reads, resident and with ``-max-memory 2192``, after a
warm-up run of each that builds its kernels and ingest library.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K = 31
KERNELS = {  # wrapper name -> (CUDA source, the JAX device program it replaces)
    "extract_insert": ("bcalm_tpu_torch/csrc/extract.cu",
                       "bcalm_tpu/engine.py:243"),
    "count_runs": ("bcalm_tpu_torch/csrc/count.cu",
                   "bcalm_tpu/ops/count.py:78"),
    "junction_keys": ("bcalm_tpu_torch/csrc/junctions.cu",
                      "bcalm_tpu/ops/junctions.py:142"),
    "junction_pairs": ("bcalm_tpu_torch/csrc/junctions.cu",
                       "bcalm_tpu/ops/junctions.py:142"),
    "jump_round": ("bcalm_tpu_torch/csrc/chains.cu",
                   "bcalm_tpu/ops/chains.py:298"),
    "range_fold": ("bcalm_tpu_torch/csrc/ranges.cu",
                   "bcalm_tpu/engine.py:404"),
    "lower_bound": ("bcalm_tpu_torch/csrc/ranges.cu",
                    "bcalm_tpu/engine.py:443"),
    "solid_fold_histogram": ("bcalm_tpu_torch/csrc/solid.cu",
                             "bcalm_tpu/ops/count.py:173"),
    "run_scans": ("bcalm_tpu_torch/csrc/runscan.cu",
                  "bcalm_tpu/ops/runchains.py:116"),
    "solid_compact": ("bcalm_tpu_torch/csrc/compact.cu",
                      "bcalm_tpu/ops/count.py:197"),
    "chain_finish": ("bcalm_tpu_torch/csrc/finish.cu",
                     "bcalm_tpu/ops/chains.py:476"),
    "spell_unitigs": ("bcalm_tpu_torch/csrc/spell.cu",
                      "bcalm_tpu/engine.py:1297"),
    "run_contract": ("bcalm_tpu_torch/csrc/runcontract.cu",
                     "bcalm_tpu/ops/runchains.py:190"),
    "run_broadcast": ("bcalm_tpu_torch/csrc/runcontract.cu",
                      "bcalm_tpu/ops/runchains.py:190"),
    "form_superkmers": ("bcalm_tpu_torch/csrc/superkmer.cu",
                        "bcalm_tpu/ops/superkmer.py:100"),
    "mmer_histograms": ("bcalm_tpu_torch/csrc/superkmer.cu",
                        "bcalm_tpu/ops/superkmer.py:194"),
    "route_buckets": ("bcalm_tpu_torch/csrc/route.cu",
                      "bcalm_tpu/parallel/pipeline.py:59"),
    "glue_compose": ("bcalm_tpu_torch/csrc/glue.cu",
                     "bcalm_tpu/parallel/distcompact.py:303"),
}
# K3's global mode (the sharded junction matching) counts its launches
# under junction_keys and junction_pairs
GLOBAL_K3 = ("junction_entries", "junction_edges")
# H100 SXM: HBM3 rate, and the fp32 non-tensor peak taken as the rate of
# 32-bit integer operations (no lower bound in time is lost by taking a
# rate that is at least the real one)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
# the kernels each main path must launch: the resident build (with its
# store), the multi-pass build (whose solidity filter and store run in
# numpy on the host), the -skip-bcalm resume (compaction only), and the
# multi-sample build (counting, then the canonical-order compaction)
COMPACT_POS = ("junction_keys", "junction_pairs", "run_scans", "run_contract",
               "jump_round", "chain_finish", "run_broadcast", "spell_unitigs")
RESIDENT_PATH = ("extract_insert", "count_runs", "solid_fold_histogram",
                 "solid_compact") + COMPACT_POS
OOC_PATH = ("extract_insert", "count_runs", "range_fold",
            "lower_bound") + COMPACT_POS
SKIP_BCALM_PATH = COMPACT_POS
CANONICAL_PATH = ("extract_insert", "count_runs", "junction_keys",
                  "junction_pairs", "jump_round", "chain_finish",
                  "spell_unitigs")
MESH_PATH = ("form_superkmers", "mmer_histograms", "route_buckets",
             "glue_compose", "extract_insert", "count_runs", "junction_keys",
             "junction_pairs", "solid_fold_histogram", "run_scans",
             "spell_unitigs")


# the fixtures of tests/test_oracle.py (the reference's example inputs)
TINY = "ACTGCTGACTGAGTCATGTGTGGGT"
MINITIP_SEQS = (["ACTGATGCAGATGACACTGATGCAGATGAC"] * 3
                + ["ATGACACTGATGCAGATGACAGTAGTGGGG"] * 3
                + ["ATGACACTGATGCAGATGACT"])
CIRC1 = "ACTTAGCGGACTTAGC"
CIRC2 = "ACCATGATTCAGAAAAAAAAA"
CIRC3 = ["ACTAAA", "ACTTAGCGGACTTAGC"]
PUFFERIZE = ["ACTAATCATTACATGAGATCAGGCAATG",
             "CAGGCAATGAGATGATAACATGATAGATGAGACCAATT",
             "AATTGGTCTGGTTGGATTGTACTCATGATG"]


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    from bcalm_tpu_torch.ops import _kernels

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.time()
    _kernels.load()
    say(f"[device] {name}; kernels built in {time.time() - t0:.1f}s "
        f"(nvcc sm_90a, sources {_kernels.source_hash()})")
    build_ingest()
    return name, smi


def build_ingest() -> None:
    """The port's C++ ingest parser, built (g++) before any timed run; the
    CLI's main path needs it (without it the CLI packs reads in python)."""
    from bcalm_tpu_torch.io import native

    t0 = time.time()
    if not native.available():
        raise AssertionError("the native ingest library did not build")
    say(f"[device] native ingest library built and loaded in "
        f"{time.time() - t0:.2f}s ({native._lib_path()})")


def _unitig_graph(us, brute):
    return brute.CompactedGraph(k=us.k, unitigs=[
        brute.Unitig(seq=s, kc=int(us.kc[i]), abundances=list(us.abundances[i]),
                     is_circular=bool(us.circular[i]))
        for i, s in enumerate(us.seqs)], links=list(us.links))


def _fasta(us) -> str:
    from bcalm_tpu_torch.io import fasta_writer

    buf = io.StringIO()
    fasta_writer.write_fasta(us, buf)
    return buf.getvalue()


def phase_fixtures(dev, seed: int):
    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.oracle import brute

    cases = [("tiny_read", [TINY], 13, 1), ("minitip", MINITIP_SEQS, 21, 2),
             ("circular1", [CIRC1], 7, 1), ("circular2", [CIRC2], 7, 1),
             ("circular3", CIRC3, 7, 1), ("pufferize", PUFFERIZE, 9, 1)]
    for name, seqs, k, amin in cases:
        cfg = engine.EngineConfig(k=k, abundance_min=amin, block_reads=32,
                                  max_len=128)
        got = engine.build_from_seqs(seqs, cfg, dev)
        exp = brute.build(seqs, k, abundance_min=amin)
        g = _unitig_graph(got, brute)
        if (brute.content_unitig_set(got.seqs, got.circular, k)
                != brute.content_unitig_set([u.seq for u in exp.unitigs],
                                            [u.is_circular for u in exp.unitigs], k)):
            raise AssertionError(f"{name}: unitig content differs from the oracle")

        def kc_map(us_):
            return {brute.content_key(u.seq, k, u.is_circular):
                    (u.kc, sorted(u.abundances)) for u in us_}

        if kc_map(g.unitigs) != kc_map(exp.unitigs):
            raise AssertionError(f"{name}: KC/abundances differ from the oracle")
        if brute.canonical_link_set(g) != brute.canonical_link_set(exp):
            raise AssertionError(f"{name}: links differ from the oracle")
        circ = {brute.content_key(s, k, True)
                for i, s in enumerate(got.seqs) if got.circular[i]}
        if circ != {brute.content_key(u.seq, k, True)
                    for u in exp.unitigs if u.is_circular}:
            raise AssertionError(f"{name}: circular flags differ from the oracle")
    rng = np.random.RandomState(seed)
    reads = sample_reads(make_genome(20_000, rng, repeat_frac=0.05), 800, 150,
                         rng, err_rate=0.002, dup_frac=0.2)
    seqs = ["".join("ACTG"[c] for c in r) for r in reads]
    for k in (31, 63):
        cfg = engine.EngineConfig(k=k, abundance_min=2, block_reads=64,
                                  max_len=160)
        on_card = engine.build_from_seqs(seqs, cfg, dev)
        on_cpu = engine.build_from_seqs(seqs, cfg, "cpu")
        if _fasta(on_card) != _fasta(on_cpu):
            raise AssertionError(f"branching input k={k}: card FASTA differs "
                                 f"from the CPU plain path")
    say(f"[fixtures] {len(cases)} fixtures equal to the oracle on {dev}; "
        f"branching 20 kbp input byte-identical card vs CPU at k=31, 63 "
        f"({on_card.stats['unitigs']} unitigs at k=63)")


# the read simulator of bench.py (make_genome, sample_reads), carried here
# so that the smoke imports nothing of the JAX package's tree
def make_genome(genome_len, rng, repeat_frac=0.0):
    """Random genome, optionally seeded with duplicated segments so the
    de Bruijn graph has real junctions (repeat_frac of the length is
    covered by copies of earlier segments, 500-5000 bp each — the
    round-4 scale runs compacted uniform-random genomes to ONE unitig,
    exercising no glue machinery at scale)."""
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
    """(n_reads, read_len) uint8 codes; substitution errors at err_rate
    (error k-mers inflate the distinct set ~k-fold per error — the
    realistic counting load real Illumina data presents).

    dup_frac: fraction of reads emitted twice (PCR duplicates).  Errors
    in duplicated reads reach count 2 and SURVIVE -abundance-min 2 —
    the realistic mechanism that gives deep short-read assemblies their
    millions of error-bubble/tip unitigs."""
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


def write_reads(path: str, coverage: float, seed: int,
                sample_seed=None) -> int:
    """Reads of the genome made from `seed`; sample_seed draws another read
    set of the same genome (default: the genome's own generator goes on)."""
    from bcalm_tpu_torch.utils import dna

    rng = np.random.RandomState(seed)
    genome = make_genome(4_600_000, rng, repeat_frac=0.05)
    if sample_seed is not None:
        rng = np.random.RandomState(sample_seed)
    n_reads = int(coverage * genome.shape[0] / 150)
    reads = sample_reads(genome, n_reads, 150, rng, err_rate=0.0008,
                         dup_frac=0.2)
    rec = np.empty((reads.shape[0], 3 + 150 + 1), np.uint8)
    rec[:, :3] = np.frombuffer(b">r\n", np.uint8)
    rec[:, 3:153] = dna.CODE_TO_ASCII[reads]
    rec[:, 153] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())
    return reads.shape[0]


def _record_key(name: str, args) -> str:
    """mmer_histograms runs in two modes, the m-mer histogram and the
    minimizer load (its last argument): each mode is recorded apart."""
    if name == "mmer_histograms":
        return f"{name}:{'load' if args[-1] else 'mmer'}"
    return name


class Recorder:
    """Keeps the first inputs each kernel wrapper (each mode of
    mmer_histograms) received, copied to the host before the call
    (extract_insert and range_fold write in place; host copies leave the
    run's peak device memory as a user's run has it)."""

    def __init__(self, kmod, names=tuple(KERNELS)):
        self.kmod = kmod
        self.inputs = {}
        self.saved = {n: getattr(kmod, n) for n in names}

    def _wrap(self, name):
        fn = self.saved[name]

        def recorded(*args):
            key = _record_key(name, args)
            if key not in self.inputs:
                self.inputs[key] = tuple(
                    a.to("cpu", copy=True) if isinstance(a, torch.Tensor) else a
                    for a in args)
            return fn(*args)
        return recorded

    def __enter__(self):
        for n in self.saved:
            setattr(self.kmod, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.kmod, n, fn)


def _stats(text: str) -> dict:
    """The `[key] value` lines the CLI prints with -verbose 1."""
    stats = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("[") and "] " in line:
            key, val = line[1:].split("] ", 1)
            stats[key] = val
    return stats


def _report(what: str, wall: float, stats: dict) -> None:
    say(f"[full] {what}: wall {wall:.2f}s, t_count_s {stats['t_count_s']}, "
        f"t_compact_s {stats['t_compact_s']}, t_assemble_s "
        f"{stats['t_assemble_s']}, write {stats['time:write']}; "
        f"kmer_occurrences {stats['kmer_occurrences']}, distinct_kmers "
        f"{stats['distinct_kmers']}, solid_kmers {stats['solid_kmers']}, "
        f"unitigs {stats['unitigs']}; device_peak_mb {stats.get('device_peak_mb', 'not measured')}")


def _sub(args, what: str, repo: str = None):
    """`python -m bcalm_tpu_torch` once, a user's run, from the tree at
    repo (default: this one): (wall, stats, stdout)."""
    repo = repo or os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "bcalm_tpu_torch", *args], cwd=repo,
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=repo),
        timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"python -m bcalm_tpu_torch {what} exited "
                           f"{proc.returncode}:\n{proc.stderr}")
    return wall, _stats(proc.stdout), proc.stdout


def _inproc(args, what: str):
    """cli.main in this process with the launch counters reset just before
    it: (wall, stats, stdout, launches, recorded kernel inputs)."""
    from bcalm_tpu_torch import cli
    from bcalm_tpu_torch.ops import _kernels

    buf = io.StringIO()
    with Recorder(_kernels) as rec:
        _kernels.reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"cli.main {what} exited {rc}:\n{buf.getvalue()}")
    return wall, _stats(buf.getvalue()), buf.getvalue(), launches, rec.inputs


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _run_cli(tmp: str, args, what: str, out: str):
    """The CLI once as `python -m bcalm_tpu_torch` (a user's run), then
    once through cli.main in this process with the launch counters reset
    just before it; both outputs must be byte-identical.  Returns (path of
    the in-process output, its stats, the subprocess's stats, its
    launches, recorded inputs)."""
    wall, sub_stats, _ = _sub(args + ["-out", os.path.join(tmp, out + "_sub")],
                              what)
    _report(f"python -m bcalm_tpu_torch {what} (process start included)",
            wall, sub_stats)
    wall, stats, _, launches, inputs = _inproc(
        args + ["-out", os.path.join(tmp, out)], what)
    _report("cli.main, same arguments, in this process", wall, stats)
    stats["wall_s"] = wall
    path = os.path.join(tmp, out + ".unitigs.fa")
    if _read(path) != _read(os.path.join(tmp, out + "_sub.unitigs.fa")):
        raise AssertionError("the two CLI runs wrote different unitigs")
    for prefix in (out, out + "_sub"):
        if os.path.exists(os.path.join(tmp, prefix + "_btpu")):
            raise AssertionError(f"{prefix}_btpu/ was left after the run")
    say(f"[launches] {json.dumps(launches)}")
    return path, stats, sub_stats, launches, inputs


def _require_launched(launches, path_kernels, what: str):
    for name in path_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"{what} main path")


def phase_full(tmp: str, coverage: float, seed: int):
    """The resident build of the E. coli-class reads."""
    fa = os.path.join(tmp, "reads.fa")
    t0 = time.time()
    n_reads = write_reads(fa, coverage, seed)
    say(f"[input] {n_reads} reads of 150 bp (4.6 Mbp genome, {coverage}x, "
        f"seed {seed}) written in {time.time() - t0:.1f}s")
    args = ["-in", fa, "-kmer-size", str(K), "-abundance-min", "2",
            "-verbose", "1"]
    path, stats, sub_stats, launches, inputs = _run_cli(
        tmp, args, "-kmer-size 31 -abundance-min 2", "ec")
    _require_launched(launches, RESIDENT_PATH, "resident")
    for what, st in (("python -m", sub_stats), ("cli.main", stats)):
        if st.get("ingest_parser") != "native":
            raise AssertionError(f"{what}: ingest_parser "
                                 f"{st.get('ingest_parser')}, expected native")
    say("[full] ingest_parser native in both runs")
    return fa, path, stats, launches, inputs


def pick_max_memory(distinct: int, dev):
    """The largest -max-memory (a multiple of 16 MiB) whose resident
    budget, in the port's memory model, holds at most a third of the
    distinct k-mers."""
    from bcalm_tpu_torch import engine

    for mb in range(16384, 0, -16):
        cfg = engine.EngineConfig(k=K)
        engine.configure_chunk(cfg, mb, dev)
        if cfg.resident_kmers <= distinct // 3:
            return mb, cfg.chunk_kmers, cfg.resident_kmers
    raise AssertionError(f"no -max-memory gives a budget under {distinct // 3}")


def phase_ooc(tmp: str, fa: str, resident_path: str, resident_stats, dev):
    """Phase 3b: the multi-pass build of the same reads under -max-memory."""
    distinct = int(resident_stats["distinct_kmers"])
    mb, chunk, res = pick_max_memory(distinct, dev)
    say(f"[ooc] -max-memory {mb} MiB: chunk {chunk} slots, resident budget "
        f"{res} distinct k-mers ({distinct} distinct counted in phase 3)")
    args = ["-in", fa, "-kmer-size", str(K), "-abundance-min", "2",
            "-verbose", "1", "-max-memory", str(mb)]
    path, stats, sub_stats, launches, inputs = _run_cli(
        tmp, args, f"-kmer-size 31 -abundance-min 2 -max-memory {mb}", "ooc")
    for what, st in (("python -m", sub_stats), ("cli.main", stats)):
        if int(st["ooc_ranges"]) < 3:
            raise AssertionError(f"{what}: {st['ooc_ranges']} key ranges, "
                                 f"expected at least 3")
        if int(st["device_peak_mb"]) > mb:
            raise AssertionError(f"{what}: peak device memory "
                                 f"{st['device_peak_mb']} MiB > -max-memory {mb}")
        say(f"[ooc] {what}: ooc_passes {st['ooc_passes']}, ooc_ranges "
            f"{st['ooc_ranges']}, device_peak_mb {st['device_peak_mb']} "
            f"<= {mb}; timing {st['timing']}")
    with open(path, "rb") as f1, open(resident_path, "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("the multi-pass FASTA differs from the "
                                 "resident run's")
    say(f"[ooc] multi-pass FASTA byte-identical to the resident run's; "
        f"in-process wall {stats['wall_s']:.2f}s")
    _require_launched(launches, OOC_PATH, "multi-pass")
    return launches, inputs


def phase_resume(tmp: str, fa: str, ref_path: str, ref_stats: dict):
    """Phase 3c: -only-uf, -skip-bcalm [-skip-bglue] and -redo-links."""
    base = ["-in", fa, "-kmer-size", str(K), "-abundance-min", "2",
            "-verbose", "1"]
    ref = _read(ref_path)
    uf = os.path.join(tmp, "uf")
    wall, st, _ = _sub(base + ["-only-uf", "-uf-stats", "-out", uf], "-only-uf")
    if (not os.path.exists(os.path.join(uf + "_btpu", "chains.npz"))
            or os.path.exists(uf + ".unitigs.fa")):
        raise AssertionError("-only-uf did not keep its store and chains")
    if int(st["uf_classes"]) != int(ref_stats["unitigs"]):
        raise AssertionError(f"uf_classes {st['uf_classes']} != phase 3's "
                             f"{ref_stats['unitigs']} unitigs")
    say(f"[resume] -only-uf -uf-stats: wall {wall:.2f}s, store and chains "
        f"kept, uf_classes {st['uf_classes']} (phase 3: {ref_stats['unitigs']} "
        f"unitigs), uf_largest_class {st['uf_largest_class']}, "
        f"uf_circular_classes {st['uf_circular_classes']}")
    away = fa + ".away"
    os.rename(fa, away)
    try:
        wall, st, out = _sub(base + ["-skip-bcalm", "-skip-bglue", "-out", uf],
                             "-skip-bcalm -skip-bglue")
        if "reusing stored chain decomposition" not in out:
            raise AssertionError("-skip-bglue did not read the chains")
        if _read(uf + ".unitigs.fa") != ref or os.path.exists(uf + "_btpu"):
            raise AssertionError("-skip-bcalm -skip-bglue: FASTA differs from "
                                 "phase 3's, or the store was left")
        say(f"[resume] input renamed away; -skip-bcalm -skip-bglue: wall "
            f"{wall:.2f}s, FASTA byte-identical to phase 3's, store removed")
    finally:
        os.rename(away, fa)
    uf2, uf3 = os.path.join(tmp, "uf2"), os.path.join(tmp, "uf3")
    _inproc(base + ["-only-uf", "-out", uf2], "-only-uf")
    shutil.copytree(uf2 + "_btpu", uf3 + "_btpu")
    os.rename(fa, away)
    try:
        wall, _, _ = _sub(base + ["-skip-bcalm", "-out", uf3], "-skip-bcalm")
        wall_in, st, _, launches, _ = _inproc(base + ["-skip-bcalm", "-out", uf2],
                                              "-skip-bcalm")
    finally:
        os.rename(away, fa)
    for prefix in (uf2, uf3):
        if _read(prefix + ".unitigs.fa") != ref or os.path.exists(prefix + "_btpu"):
            raise AssertionError("-skip-bcalm: FASTA differs from phase 3's, "
                                 "or the store was left")
    _require_launched(launches, SKIP_BCALM_PATH, "-skip-bcalm")
    say(f"[resume] fresh -only-uf, then -skip-bcalm: wall {wall:.2f}s "
        f"(python -m), {wall_in:.2f}s in process (t_compact_s "
        f"{st['t_compact_s']}, t_assemble_s {st['t_assemble_s']}); FASTA "
        f"byte-identical to phase 3's; launches {json.dumps(launches)}")
    rl = os.path.join(tmp, "rl")
    shutil.copyfile(ref_path, rl + ".unitigs.fa")
    wall, _, _ = _sub(["-in", rl, "-redo-links", "-kmer-size", str(K),
                       "-out", rl], "-redo-links")
    if _read(rl + ".unitigs.fa") != ref:
        raise AssertionError("-redo-links changed phase 3's FASTA")
    say(f"[resume] -redo-links on phase 3's FASTA: wall {wall:.2f}s, "
        f"byte-identical")


def _kmer_values(lanes: np.ndarray) -> np.ndarray:
    """(2, n) u32 lanes of k <= 32 -> (n,) 2k-bit values."""
    return (lanes[0].astype(np.uint64) << np.uint64(32)) | lanes[1].astype(np.uint64)


def count_table(path: str, dev):
    """One sample's distinct canonical k-mers (sorted 62-bit values) and
    counts, counted on the card at abundance 1."""
    from bcalm_tpu_torch import cli, engine
    from bcalm_tpu_torch.io import bank as bank_mod

    bank = bank_mod.Bank.open(path)
    cfg = engine.EngineConfig(k=K, abundance_min=1)
    engine.configure_chunk(cfg, 0, dev)
    cli.adapt_max_len(bank, cfg)
    lanes, counts, _, _, _ = engine.count_and_filter(
        cli._input_blocks(bank, cfg, 0), cfg, dev)
    return _kmer_values(lanes), counts.astype(np.int64)


def combine(t1, t2, kind: str, amin: int = 2):
    """numpy's min/max combination of two count tables, filtered at amin."""
    (v1, c1), (v2, c2) = t1, t2
    if kind == "min":
        v, i1, i2 = np.intersect1d(v1, v2, assume_unique=True,
                                   return_indices=True)
        c = np.minimum(c1[i1], c2[i2])
    else:
        v = np.union1d(v1, v2)
        c = np.zeros(v.shape[0], np.int64)
        c[np.searchsorted(v, v1)] = c1
        j = np.searchsorted(v, v2)
        c[j] = np.maximum(c[j], c2)
    keep = c >= amin
    return v[keep], c[keep]


def unitig_kmers(path: str):
    """(canonical k-mer values in unitig order, k-mers per unitig, KC per
    unitig) of a unitigs FASTA."""
    from bcalm_tpu_torch.io import fasta_writer

    seqs, headers = fasta_writer.parse_unitigs_fasta(path)
    per = np.array([len(s) - K + 1 for s in seqs], np.int64)
    kc = np.array([int(t[5:]) for h in headers for t in h.split()
                   if t.startswith("KC:i:")], np.int64)
    return _canonical_kmers(seqs, K), per, kc


def unitig_keys(path: str):
    """Each unitig as (its least canonical k-mer, k-mers, KC), sorted: the
    unitig set and KC whatever the ids and orientations."""
    km, per, kc = unitig_kmers(path)
    starts = np.concatenate([[0], np.cumsum(per)[:-1]])
    keys = np.minimum.reduceat(km, starts)
    order = np.argsort(keys)
    return keys[order], per[order], kc[order]


def phase_multi(tmp: str, fa: str, ref_path: str, coverage: float, seed: int,
                dev):
    """Phase 3d: multi-sample solidity (count each sample, combine, the
    canonical-order compaction)."""
    fa2 = os.path.join(tmp, "reads2.fa")
    t0 = time.time()
    n2 = write_reads(fa2, coverage, seed, sample_seed=seed + 1)
    album = os.path.join(tmp, "album.txt")
    with open(album, "w") as f:
        f.write(f"{fa}\n{fa2}\n")
    say(f"[multi] second sample: {n2} reads of the same genome (read seed "
        f"{seed + 1}) in {time.time() - t0:.1f}s")
    t0 = time.time()
    tables = [count_table(p, dev) for p in (fa, fa2)]
    say(f"[multi] the two samples' count tables: {tables[0][0].shape[0]} and "
        f"{tables[1][0].shape[0]} distinct k-mers ({time.time() - t0:.1f}s)")
    for kind in ("min", "max"):
        out = os.path.join(tmp, f"ms_{kind}")
        wall, st, _ = _sub(["-in", album, "-kmer-size", str(K),
                            "-abundance-min", "2", "-solidity-kind", kind,
                            "-verbose", "1", "-out", out], f"album {kind}")
        v, c = combine(*tables, kind)
        km, per, kc = unitig_kmers(out + ".unitigs.fa")
        if not np.array_equal(np.sort(km), v):
            raise AssertionError(f"-solidity-kind {kind}: the canonical k-mers "
                                 f"differ from numpy's combination")
        starts = np.concatenate([[0], np.cumsum(per)[:-1]])
        if not np.array_equal(np.add.reduceat(c[np.searchsorted(v, km)],
                                              starts), kc):
            raise AssertionError(f"-solidity-kind {kind}: KC differs from "
                                 f"numpy's combination")
        say(f"[multi] -solidity-kind {kind}: wall {wall:.2f}s, {v.shape[0]} "
            f"solid k-mers and the KC of {kc.shape[0]} unitigs equal numpy's "
            f"{kind} combination; t_compact_s {st['t_compact_s']}, "
            f"device_peak_mb {st.get('device_peak_mb', 'not measured')}")
    link = os.path.join(tmp, "reads_link.fa")
    os.link(fa, link)
    same = os.path.join(tmp, "album_same.txt")
    with open(same, "w") as f:
        f.write(f"{fa}\n{link}\n")
    args = ["-in", same, "-kmer-size", str(K), "-abundance-min", "2",
            "-solidity-kind", "min", "-verbose", "1"]
    out = os.path.join(tmp, "ms_same")
    wall, _, _ = _sub(args + ["-out", out + "_sub"], "album min, same file")
    wall_in, st, _, launches, inputs = _inproc(args + ["-out", out],
                                               "album min, same file")
    want = unitig_keys(ref_path)
    for prefix in (out, out + "_sub"):
        got = unitig_keys(prefix + ".unitigs.fa")
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("min over a file and its hard link: unitigs "
                                 "or KC differ from phase 3's")
    _require_launched(launches, CANONICAL_PATH, "multi-sample")
    from bcalm_tpu_torch.ops import runchains

    M = 2 * runchains.round_capacity(int(st["solid_kmers"]))
    say(f"[multi] -solidity-kind min over phase 3's file and a hard link: "
        f"wall {wall:.2f}s (python -m), {wall_in:.2f}s in process "
        f"(t_compact_s {st['t_compact_s']}, t_assemble_s "
        f"{st['t_assemble_s']}); {len(want[0])} unitigs and their KC equal "
        f"phase 3's; launches {json.dumps(launches)}")
    return M, launches, inputs, tables[0]


def phase_auto(tmp: str, fa: str, ref_path: str):
    """Phase 3e: -abundance-min auto."""
    out = os.path.join(tmp, "auto")
    base = ["-in", fa, "-kmer-size", str(K), "-verbose", "1"]
    wall, _, text = _sub(base + ["-abundance-min", "auto", "-out", out],
                         "-abundance-min auto")
    lines = [l for l in text.splitlines() if l.startswith("auto abundance-min = ")]
    if len(lines) != 1:
        raise AssertionError("-abundance-min auto printed no cutoff")
    cutoff = int(lines[0].split("= ")[1])
    if cutoff == 2:
        want, what = _read(ref_path), "phase 3's run"
    else:
        explicit = os.path.join(tmp, "explicit")
        _sub(base + ["-abundance-min", str(cutoff), "-out", explicit],
             f"-abundance-min {cutoff}")
        want, what = _read(explicit + ".unitigs.fa"), f"a -abundance-min {cutoff} run"
    if _read(out + ".unitigs.fa") != want:
        raise AssertionError(f"-abundance-min auto ({cutoff}) differs from {what}")
    say(f"[auto] -abundance-min auto chose {cutoff} (wall {wall:.2f}s); "
        f"FASTA byte-identical to {what}")


def _links(path: str) -> int:
    from bcalm_tpu_torch.io import fasta_writer

    _, headers = fasta_writer.parse_unitigs_fasta(path)
    return sum(1 for h in headers for t in h.split() if t.startswith("L:"))


def _km(path: str) -> np.ndarray:
    """km:f: of each unitig, in the order of unitig_keys."""
    from bcalm_tpu_torch.io import fasta_writer

    km, per, _ = unitig_kmers(path)
    starts = np.concatenate([[0], np.cumsum(per)[:-1]])
    order = np.argsort(np.minimum.reduceat(km, starts))
    _, headers = fasta_writer.parse_unitigs_fasta(path)
    vals = np.array([float(t[5:]) for h in headers for t in h.split()
                     if t.startswith("km:f:")])
    return vals[order]


def phase_mesh(tmp: str, fa: str, ref_path: str, table, dev):
    """Phase 3f: the -devices build over an NCCL group of world size 1."""
    import torch.distributed as dist

    from bcalm_tpu_torch import cli, engine
    from bcalm_tpu_torch.io import bank as bank_mod
    from bcalm_tpu_torch.ops import _kernels
    from bcalm_tpu_torch.parallel import launch, pipeline

    mesh = launch.init_group(1, 0, "cuda", os.path.join(tmp, "nccl_group"))
    try:
        bank = bank_mod.Bank.open(fa)
        cfg = engine.EngineConfig(k=K, abundance_min=2)
        engine.configure_chunk(cfg, 0, dev)
        cli.adapt_max_len(bank, cfg)
        timing = {}
        with Recorder(_kernels, tuple(KERNELS) + GLOBAL_K3) as rec:
            _kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            us = pipeline.distributed_build(
                mesh, bank.sequences(), cfg, pipeline.MinimizerConfig(m=10),
                timing=timing)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(_kernels.LAUNCHES)
        check_mesh(tmp, ref_path, table, us, wall, timing, launches)
        phase_mesh_ranged(tmp, fa, mesh, dev)
    finally:
        dist.destroy_process_group()
    check_too_many_devices(tmp, fa)
    return launches, rec.inputs


def check_mesh(tmp, ref_path, table, us, wall, timing, launches):
    """Phase 3f's main run against phase 3's output."""
    from bcalm_tpu_torch.io import fasta_writer

    _require_launched(launches, MESH_PATH, "-devices")
    path = os.path.join(tmp, "mesh.unitigs.fa")
    with open(path, "w") as f:
        fasta_writer.write_fasta(us, f)
    got, want = unitig_keys(path), unitig_keys(ref_path)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("-devices build: unitigs or KC differ from "
                             "phase 3's")
    if not np.array_equal(_km(path), _km(ref_path)):
        raise AssertionError("-devices build: km differs from phase 3's")
    if _links(path) != _links(ref_path):
        raise AssertionError(f"-devices build: {_links(path)} links, phase 3 "
                             f"{_links(ref_path)}")
    # per-k-mer abundances against phase 3d's count table of the same reads
    values, counts = table
    km = _canonical_kmers(us.seqs, K)
    ab = np.concatenate([np.asarray(a, np.int64) for a in us.abundances])
    if not np.array_equal(counts[np.searchsorted(values, km)], ab):
        raise AssertionError("-devices build: per-k-mer abundances differ "
                             "from the counted table")
    st = us.stats
    split = {key: round(timing[key], 3) for key in
             ("sampling", "rounds", "finish", "reshard", "junctions", "glue",
              "assembly")}
    say(f"[mesh] distributed_build, NCCL world size 1, m = 10: wall "
        f"{wall:.2f}s, split (s) {json.dumps(split)}; {len(us.seqs)} unitigs, "
        f"KC, km, per-k-mer abundances and {_links(path)} links equal phase "
        f"3's; superkmers {st['superkmers']}, mean_superkmer_span "
        f"{st['mean_superkmer_span']:.3f}, exchange_words_per_kmer "
        f"{st['exchange_words_per_kmer']:.4f}, exchange_cap_retries "
        f"{st['exchange_cap_retries']}, exchange_max_share "
        f"{st['exchange_max_share']}, glue_runs {st['glue_runs']}, "
        f"glue_contraction {st['glue_contraction']:.2f}, "
        f"glue_doubling_rounds {st['glue_doubling_rounds']}, device_peak_mb "
        f"{st['device_peak_mb']}, ingest {st['ingest_parser']}")
    say(f"[launches] {json.dumps(launches)}")


def phase_mesh_ranged(tmp: str, fa: str, mesh, dev):
    """Phase 3f's multi-pass run: the mesh build of the first 1/32 of the
    reads with a residency budget of a third of their distinct k-mers, so
    that it counts in key ranges (K5 folds, pivots through all_gather, one
    pass over the input per range); held against the single-device build
    of the same reads.  Returns its launches.

    The number of ranges is the JAX package's projection: the distinct
    k-mers seen when the first pass passed the budget, scaled by the
    input's estimated occurrences over those seen.  A read set deep
    enough to repeat its k-mers makes it over-split (a quarter of the
    phase 3 reads, 12.5x, takes 28 ranges), and every range re-reads
    the input: 1/32 of the reads keeps the run short."""
    from bcalm_tpu_torch import cli, engine
    from bcalm_tpu_torch.io import bank as bank_mod
    from bcalm_tpu_torch.io import fasta_writer
    from bcalm_tpu_torch.ops import _kernels
    from bcalm_tpu_torch.parallel import pipeline

    part = os.path.join(tmp, "reads_part.fa")
    record = 3 + 150 + 1          # write_reads' fixed record
    with open(fa, "rb") as f:
        data = f.read((os.path.getsize(fa) // record // 32) * record)
    with open(part, "wb") as f:
        f.write(data)
    ref = os.path.join(tmp, "part_single")
    wall, ref_st, _ = _sub(["-in", part, "-kmer-size", str(K),
                            "-abundance-min", "2", "-verbose", "1", "-out", ref],
                           "1/32 of the reads")
    bank = bank_mod.Bank.open(part)
    cfg = engine.EngineConfig(k=K, abundance_min=2)
    engine.configure_chunk(cfg, 0, dev)
    cli.adapt_max_len(bank, cfg)
    cfg.resident_kmers = int(ref_st["distinct_kmers"]) // 3
    timing = {}
    _kernels.reset_launches()
    t0 = time.time()
    us = pipeline.distributed_build(
        mesh, bank.sequences(), cfg, pipeline.MinimizerConfig(m=10),
        reread=bank.sequences, timing=timing)
    torch.cuda.synchronize()
    wall_mesh = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    _require_launched(launches, MESH_PATH + ("range_fold",), "-devices multi-pass")
    st = us.stats
    if st["ooc_ranges"] < 2:
        raise AssertionError(f"-devices multi-pass: {st['ooc_ranges']} key "
                             f"range, expected at least 2")
    path = os.path.join(tmp, "mesh_ranged.unitigs.fa")
    with open(path, "w") as f:
        fasta_writer.write_fasta(us, f)
    ref_path = ref + ".unitigs.fa"
    got, want = unitig_keys(path), unitig_keys(ref_path)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("-devices multi-pass: unitigs or KC differ from "
                             "the single-device build's")
    if not np.array_equal(_km(path), _km(ref_path)):
        raise AssertionError("-devices multi-pass: km differs")
    if _links(path) != _links(ref_path):
        raise AssertionError("-devices multi-pass: link count differs")
    # "rounds" is the first pass, cut where the budget was passed;
    # "finish" holds the passes over the key ranges
    split = {key: round(timing[key], 3) for key in ("rounds", "finish")}
    say(f"[mesh] multi-pass: the first {len(data) // record} reads "
        f"({ref_st['distinct_kmers']} distinct k-mers, single-device build "
        f"{wall:.2f}s), residency budget {cfg.resident_kmers}: "
        f"{st['ooc_ranges']} key ranges, {st['ooc_passes']} passes, wall "
        f"{wall_mesh:.2f}s, split (s) {json.dumps(split)}; {len(got[0])} "
        f"unitigs, KC, km and {_links(path)} links equal the single-device "
        f"build's; range_fold launches {launches['range_fold']}, "
        f"device_peak_mb {st.get('device_peak_mb', 'not measured')}")
    say(f"[launches] {json.dumps(launches)}")
    return launches


def check_too_many_devices(tmp: str, fa: str) -> None:
    """-devices N past the cards: exit 1 with the JAX package's message."""
    n = torch.cuda.device_count() + 1
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "bcalm_tpu_torch", "-in", fa, "-kmer-size",
         str(K), "-devices", str(n), "-out", os.path.join(tmp, "toomany")],
        cwd=repo, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=repo), timeout=300)
    msg = f"-devices {n}: only {n - 1} devices available"
    if proc.returncode != 1 or msg not in proc.stderr:
        raise AssertionError(f"-devices {n}: exit {proc.returncode}, "
                             f"stderr {proc.stderr!r}")
    say(f"[mesh] python -m bcalm_tpu_torch -devices {n}: exit 1, '{msg}'")


def phase_cards(tmp: str, n_dev: int, coverage: float, seed: int) -> None:
    """--devices N: the -devices N CLI build over N cards against the
    single-device build of the same reads."""
    fa = os.path.join(tmp, "reads.fa")
    n_reads = write_reads(fa, coverage, seed)
    args = ["-in", fa, "-kmer-size", str(K), "-abundance-min", "2",
            "-verbose", "1"]
    ref = os.path.join(tmp, "single")
    wall, st, _ = _sub(args + ["-out", ref], "single device")
    say(f"[cards] {n_reads} reads; single-device build: wall {wall:.2f}s "
        f"(process start included), {st['unitigs']} unitigs, device_peak_mb "
        f"{st['device_peak_mb']}")
    out = os.path.join(tmp, "cards")
    wall, st, _ = _sub(args + ["-devices", str(n_dev), "-out", out],
                       f"-devices {n_dev}")
    got, want = unitig_keys(out + ".unitigs.fa"), unitig_keys(ref + ".unitigs.fa")
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"-devices {n_dev}: unitigs or KC differ from the "
                             f"single-device build's")
    if not np.array_equal(_km(out + ".unitigs.fa"), _km(ref + ".unitigs.fa")):
        raise AssertionError(f"-devices {n_dev}: km differs")
    links = _links(out + ".unitigs.fa")
    if links != _links(ref + ".unitigs.fa"):
        raise AssertionError(f"-devices {n_dev}: link count differs")
    keys = ("superkmers", "mean_superkmer_span", "exchange_words_per_kmer",
            "exchange_cap_retries", "exchange_max_share",
            "device_load_imbalance", "glue_runs", "glue_doubling_rounds",
            "device_peak_mb", "timing", "time:build_distributed")
    say(f"[cards] -devices {n_dev} over {n_dev} cards (NCCL): wall {wall:.2f}s "
        f"(process start and the ranks' spawn included); {len(got[0])} "
        f"unitigs, KC, km and {links} links equal the single-device build's; "
        + ", ".join(f"{key} {st[key]}" for key in keys))


def phase_compare(tmp: str, parent: str, coverage: float, seed: int) -> None:
    """--compare-tree DIR: `python -m bcalm_tpu_torch` from the tree in DIR
    and from this one in turns (DIR, this, this, DIR) on the phase 3 reads,
    resident and at -max-memory 2192.  A warm-up run of each tree on a
    small input builds its kernels and ingest library first, so that no
    timed run builds anything."""
    fa = os.path.join(tmp, "reads.fa")
    n_reads = write_reads(fa, coverage, seed)
    small = os.path.join(tmp, "small.fa")
    with open(fa, "rb") as f, open(small, "wb") as g:
        g.write(f.read(2000 * (3 + 150 + 1)))
    trees = {"parent": os.path.abspath(parent),
             "change": os.path.dirname(os.path.abspath(__file__))}
    for name, root in trees.items():
        wall, st, _ = _sub(["-in", small, "-kmer-size", str(K), "-verbose", "1",
                            "-out", os.path.join(tmp, f"warm_{name}")],
                           f"{name} warm-up", root)
        say(f"[compare] {name} ({root}) warm-up on 2000 reads: {wall:.2f}s "
            f"(builds included), ingest_parser "
            f"{st.get('ingest_parser', 'not printed')}")
    base = ["-in", fa, "-kmer-size", str(K), "-abundance-min", "2",
            "-verbose", "1"]
    outputs = {}
    for turn, name in enumerate(("parent", "change", "change", "parent")):
        for extra in ([], ["-max-memory", "2192"]):
            out = os.path.join(tmp, f"cmp{turn}{len(extra)}")
            wall, st, _ = _sub(base + extra + ["-out", out],
                               f"{name} {' '.join(extra)}", trees[name])
            outputs.setdefault(len(extra), set()).add(_read(out + ".unitigs.fa"))
            say(f"[compare] {name} {' '.join(extra) or 'resident'}: wall "
                f"{wall:.2f}s (process start included), time:build "
                f"{st['time:build']}, t_count_s {st['t_count_s']}, "
                f"t_compact_s {st['t_compact_s']}, t_assemble_s "
                f"{st['t_assemble_s']}, write {st['time:write']}, "
                f"ingest_parser {st.get('ingest_parser', 'not printed')}, "
                f"device_peak_mb {st.get('device_peak_mb', 'not measured')}")
    if any(len(v) != 1 for v in outputs.values()):
        raise AssertionError("the two trees wrote different unitigs")
    say(f"[compare] {n_reads} reads; both trees wrote the same bytes")


def _canonical_kmers(seqs, k: int) -> np.ndarray:
    """Canonical 2k-bit values of every k-mer of every sequence (k <= 32)."""
    from bcalm_tpu_torch.io import packing

    lens = np.array([len(s) for s in seqs], np.int64)
    flat = packing.encode_ascii("".join(seqs)).astype(np.uint64)
    n = flat.shape[0]
    P = n - k + 1
    fwd = np.zeros(P, np.uint64)
    rc = np.zeros(P, np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | flat[j:j + P]
        rc |= (flat[j:j + P] ^ np.uint64(2)) << np.uint64(2 * j)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    idx = np.arange(P)
    u = np.searchsorted(starts, idx, side="right") - 1
    ok = idx + k <= starts[u] + lens[u]
    return np.minimum(fwd, rc)[ok]


def phase_invariants(path: str, stats: dict):
    from bcalm_tpu_torch.io import fasta_writer

    seqs, headers = fasta_writer.parse_unitigs_fasta(path)
    km = _canonical_kmers(seqs, K)
    n_solid = int(stats["solid_kmers"])
    if km.shape[0] != n_solid or np.unique(km).shape[0] != n_solid:
        raise AssertionError(f"unitig k-mers: {km.shape[0]} total, "
                             f"{np.unique(km).shape[0]} distinct, expected "
                             f"{n_solid} each")
    kc = sum(int(t[5:]) for h in headers for t in h.split() if t.startswith("KC:i:"))
    if kc != int(stats["solid_kmer_abundance"]):
        raise AssertionError(f"sum of KC {kc} != solid abundance "
                             f"{stats['solid_kmer_abundance']}")
    rc_tab = str.maketrans("ACGT", "TGCA")

    def oriented(i, sign):
        return seqs[i] if sign == "+" else seqs[i].translate(rc_tab)[::-1]

    n_links = 0
    for u, h in enumerate(headers):
        for t in h.split():
            if t.startswith("L:"):
                _, su, v, sv = t.split(":")
                if oriented(u, su)[-(K - 1):] != oriented(int(v), sv)[:K - 1]:
                    raise AssertionError(f"link {u}{su} -> {v}{sv} is no overlap")
                n_links += 1
    say(f"[invariants] {n_solid} solid k-mers each once in {len(seqs)} "
        f"unitigs; sum KC = {kc}; {n_links} links all (k-1)-overlaps")


def _time_ms(fn, reps: int = 20) -> float:
    """Mean CUDA-event time of fn over `reps` calls, after two warm-ups."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(_max_err(x, y) for x, y in zip(a, b))
    if a is None and b is None:
        return 0.0
    if not isinstance(a, torch.Tensor):
        return float(abs(int(a) - int(b)))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.bool:
        return float((a != b).sum().item())
    return float((a.long() - b.long()).abs().max().item()) if a.numel() else 0.0


def _finish_tuple(info):
    return tuple(info[key] for key in ("uid", "rank", "n_unitigs", "start_oid",
                                       "length", "circular"))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    return 0


def _bound(moved: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the peak rate."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(inputs, launches, dev):
    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.models import lanes as ln
    from bcalm_tpu_torch.models import minimizer
    from bcalm_tpu_torch.ops import (_kernels, chains, count, extract,
                                     junctions, runchains, superkmer)
    from bcalm_tpu_torch.parallel import distcompact, pipeline

    inputs = {name: tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                          for a in args) for name, args in inputs.items()}
    rows = []

    def check(name, kernel_fn, plain_fn, kernel_timed=None, plain_timed=None,
              reads=(), written=None, ops=0, library=None, row=True):
        """Bitwise check of kernel_fn() vs plain_fn(); the *_timed variants
        (default: the same calls) are what the CUDA events time.  The bound
        counts `reads` read once and the kernel's outputs (or `written`
        bytes) written once; `library` is one PyTorch call computing the
        same function, timed beside it."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = _max_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max abs err {err})")
        moved = _nbytes(reads) + (_nbytes(got) if written is None else written)
        bound_ms, bound_by = _bound(moved, ops)
        r = {"name": name, "route": "cuda", "source": KERNELS[name][0],
             "replaces": KERNELS[name][1], "launches": launches[name],
             "max_abs_err": err, "ms": _time_ms(kernel_timed or kernel_fn),
             "plain_ms": _time_ms(plain_timed or plain_fn),
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": _time_ms(library) if library else None}
        if row:
            rows.append(r)
        return r

    # K1 writes in place: compare on fresh copies of the recorded buffer,
    # time into one preallocated buffer (no 0.8 GB clone inside the timing)
    buf, words, lengths, k, slot_base, offset, row_base = inputs["extract_insert"]
    ext_args = (words, lengths, k, slot_base, offset, row_base)
    scratch = buf.clone()

    def fresh(fn):
        def run():
            out = buf.clone()
            fn(out, *ext_args)
            return out
        return run

    check("extract_insert", fresh(_kernels.extract_insert),
          fresh(extract.extract_insert_plain),
          lambda: _kernels.extract_insert(scratch, *ext_args),
          lambda: extract.extract_insert_plain(scratch, *ext_args),
          reads=(words, lengths),
          written=buf.shape[0] * extract.block_slots(words.shape, k) * 8)
    s_lanes, w, pos = inputs["count_runs"]
    check("count_runs", lambda: _kernels.count_runs(s_lanes, w, pos),
          lambda: count.count_runs_plain(s_lanes, w, pos),
          reads=(s_lanes, w, pos))
    solid, n_solid, k, hashed, rows_k = inputs["junction_keys"]
    check("junction_keys",
          lambda: _kernels.junction_keys(solid, n_solid, k, hashed, rows_k),
          lambda: junctions.junction_keys_plain(solid, n_solid, k),
          reads=solid)
    s_keys, s_pay, C, hashed = inputs["junction_pairs"]
    check("junction_pairs", lambda: _kernels.junction_pairs(s_keys, s_pay, C, hashed),
          lambda: junctions.junction_pairs_plain(s_keys, s_pay, C, hashed),
          reads=(s_keys, s_pay))
    Q = inputs["jump_round"][0]
    Qn = torch.empty_like(Q)
    changed = torch.zeros((1,), dtype=torch.int32, device=Q.device)

    def jr_kernel():
        changed.zero_()
        _kernels.jump_round(Q, Qn, changed)
        return Qn.clone(), changed.bool()

    def jr_plain():
        new = chains.jump_round_plain(Q)
        return new, torch.tensor([not torch.equal(new, Q)], device=Q.device)

    check("jump_round", jr_kernel, jr_plain,
          lambda: _kernels.jump_round(Q, Qn, changed),
          lambda: chains.jump_round_plain(Q), reads=Q)

    # K5 folds in place: compare on fresh copies, time on one scratch copy
    body, lo, hi = inputs["range_fold"]
    body_scratch = body.clone()

    def fold(fn):
        def run():
            out = body.clone()
            return out, fn(out, lo, hi)
        return run

    check("range_fold", fold(_kernels.range_fold), fold(count.range_fold_plain),
          lambda: _kernels.range_fold(body_scratch, lo, hi),
          lambda: count.range_fold_plain(body_scratch, lo, hi),
          reads=body, written=_nbytes(body) + 8)
    run, n, bounds = inputs["lower_bound"]
    library = None
    if run.shape[0] <= 2:       # one packed int64 key per column
        packed_run = ln.pack_keys(list(run[:, :n]))[0].contiguous()
        packed_bounds = ln.pack_keys(list(bounds))[0].contiguous()
        if not torch.equal(torch.searchsorted(packed_run, packed_bounds),
                           _kernels.lower_bound(run, n, bounds)):
            raise AssertionError("lower_bound differs from torch.searchsorted")
        library = lambda: torch.searchsorted(packed_run, packed_bounds)  # noqa: E731
    check("lower_bound", lambda: _kernels.lower_bound(run, n, bounds),
          lambda: count.lower_bound_plain(run, n, bounds),
          reads=(run[:, :n], bounds), library=library)
    sf_args = inputs["solid_fold_histogram"]
    check("solid_fold_histogram", lambda: _kernels.solid_fold_histogram(*sf_args),
          lambda: count.solid_fold_histogram_plain(*sf_args), reads=sf_args)
    succ, n_solid, C, gbase = inputs["run_scans"]
    check("run_scans", lambda: _kernels.run_scans(succ, n_solid, C, gbase),
          lambda: runchains.run_scans_plain(succ, n_solid, C, gbase),
          reads=succ[:n_solid])      # links are read for the solid entries
    sc_args = inputs["solid_compact"]
    uq, cq, pq, nq, amin, amax = sc_args[:6]
    stacked_in = torch.cat([uq, cq[None], pq[None]])
    idx = torch.arange(uq.shape[1], device=dev)
    keep = (idx < nq) & (cq >= amin) & (cq <= amax)
    check("solid_compact", lambda: _kernels.solid_compact(*sc_args),
          lambda: count.solid_compact_plain(*sc_args), reads=sc_args,
          library=lambda: stacked_in[:, keep])
    del stacked_in
    cf_args = inputs["chain_finish"]
    check("chain_finish", lambda: _finish_tuple(_kernels.chain_finish(*cf_args)),
          lambda: _finish_tuple(chains.finish_fast_plain(*cf_args)),
          reads=cf_args)
    su_args = inputs["spell_unitigs"]
    check("spell_unitigs", lambda: _kernels.spell_unitigs(*su_args),
          lambda: engine.spell_unitigs_plain(*su_args), reads=su_args)
    rc_args = inputs["run_contract"]
    r_succ, r_head, r_rid, r_end, R, _ = rc_args
    # every head flag; the rid, end and two successors of each of R heads
    check("run_contract", lambda: _kernels.run_contract(*rc_args),
          lambda: runchains.run_contract_plain(*rc_args),
          reads=(r_head, r_rid[:R], r_end[:R], r_succ[:2 * R]))
    rb_args = inputs["run_broadcast"]
    n_members = rb_args[8]
    # the run structure of the n_solid members, the contracted arrays whole
    check("run_broadcast", lambda: _kernels.run_broadcast(*rb_args),
          lambda: runchains.run_broadcast_plain(*rb_args),
          reads=rb_args[:3] + tuple(a[:n_members] for a in rb_args[3:6])
          + rb_args[6:8])

    # the -devices path (phase 3f): K13-K16 and K3's global mode
    extra = []

    def gathered(table_, n_pos_):
        """Bytes of a (4^m,) table that n_pos_ lookups must read: each
        lookup's 8 bytes, or the whole table where that is less."""
        return 0 if table_ is None else min(_nbytes(table_), 8 * n_pos_)

    # K14 in both modes, on the first sampling block of each
    for mode, row in (("mmer", True), ("load", False)):
        hw, hl, hk, hm, hrank, hload = inputs[f"mmer_histograms:{mode}"]
        n_pos = hw.shape[0] * 16 * hw.shape[1]
        r = check("mmer_histograms",
                  lambda: _kernels.mmer_histograms(hw, hl, hk, hm, hrank, hload),
                  lambda: (superkmer.sample_minimizer_load_plain(
                      hw, hl, hk, hm, hrank, hrank is not None) if hload else
                      superkmer.sample_cmmer_histogram_plain(hw, hl, hk, hm)),
                  reads=(hw, hl), written=gathered(hrank, n_pos) + 8 * 4 ** hm,
                  ops=n_pos * (6 * hm + (2 * (hk - hm + 1) if hload else 0)),
                  row=row)
        if not row:
            extra.append((f"mmer_histograms, minimizer-load mode "
                          f"({tuple(hw.shape)}, rank {hrank is not None})", r))
    (sw, sl, sk, sm, table, rank, max_span, Wn, bits, with_pos,
     pos_base) = inputs["form_superkmers"]
    P = 16 * sw.shape[1]
    n_pos = sw.shape[0] * P
    # per position: the m-mer and its reverse complement, the window
    # minimum, two shared-memory scans, Wn 16-base packs; its rank and
    # owner are one 8-byte lookup each
    skm_ops = n_pos * (6 * sm + 2 * (sk - sm + 1)
                       + 8 * int(np.ceil(np.log2(P))) + 80 * Wn)
    skm_gathers = gathered(table, n_pos) + gathered(rank, n_pos)

    def skm_check(table_, row=True):
        args = (sw, sl, sk, sm, table_, rank, max_span, Wn, bits, with_pos,
                pos_base)
        got = _kernels.form_superkmers(*args)
        r = check("form_superkmers", lambda: _kernels.form_superkmers(*args),
                  lambda: superkmer.form_superkmers_plain(
                      sw, sl, sk, sm, table_, rank, max_span, rank is not None,
                      with_pos, pos_base),
                  reads=(sw, sl),
                  written=_nbytes(got) + skm_gathers, ops=skm_ops, row=row)
        return r, got[1][got[2]]

    _, owners = skm_check(table)
    # at world size 1 every owner is 0: hold the owner lookup at 4 ranks
    # too, with the table the sampled load of phase 3f gives for 4 ranks
    lw, ll, lk, lm, lrank, _ = inputs["mmer_histograms:load"]
    load = superkmer.sample_minimizer_load_plain(lw, ll, lk, lm, lrank,
                                                 lrank is not None)
    table4 = torch.from_numpy(minimizer.build_repartition(
        np.minimum(load.cpu().numpy(), 2**31 - 1).astype(np.int32), 4)
        .astype(np.int64)).to(dev)
    r, owners = skm_check(table4, row=False)
    spread = torch.bincount(owners, minlength=4).tolist()
    if min(spread) == 0:
        raise AssertionError(f"form_superkmers at 4 ranks: superkmer starts "
                             f"per owner {spread}")
    extra.append((f"form_superkmers with a 4-rank table (build_repartition "
                  f"of the sampled load; starts per owner {spread})", r))
    stk, valid, owner, n_dev, cap, with_slots = inputs["route_buckets"]
    check("route_buckets",
          lambda: _kernels.route_buckets(*inputs["route_buckets"]),
          lambda: pipeline.route_to_buckets_plain(*inputs["route_buckets"]),
          reads=(stk, valid, owner))
    rng = torch.Generator(device="cpu").manual_seed(0)
    for nd in (4, 8):
        syn = torch.randint(0, nd, (stk.shape[1],), generator=rng).to(dev)
        cap_nd = max(1, -(-2 * int(valid.sum()) // nd))
        r = check("route_buckets",
                  lambda: _kernels.route_buckets(stk, valid, syn, nd, cap_nd, True),
                  lambda: pipeline.route_to_buckets_plain(stk, valid, syn, nd,
                                                          cap_nd, True),
                  reads=(stk, valid, syn), row=False)
        extra.append((f"route_buckets at {nd} destinations (synthetic owners, "
                      f"cap {cap_nd}, with slots)", r))
    gQ, anc, need = inputs["glue_compose"]
    check("glue_compose", lambda: _kernels.glue_compose(gQ, anc, need),
          lambda: distcompact.glue_compose_plain(gQ, anc, need),
          reads=(gQ, anc, need))
    ge = inputs["junction_entries"]
    r = check("junction_keys", lambda: _kernels.junction_entries(*ge),
              lambda: junctions.junction_entries_plain(*ge[:6]), reads=ge[0],
              row=False)
    extra.append((f"junction_keys, global mode (4 entries per k-mer, owner "
                  f"ranks; {tuple(ge[0].shape)})", r))
    # the owner ranks (hash_lanes(key) % n_dev) are all 0 at world size 1:
    # the same entries at 4 ranks
    ge4 = ge[:5] + (4,) + ge[6:]
    r = check("junction_keys", lambda: _kernels.junction_entries(*ge4),
              lambda: junctions.junction_entries_plain(*ge4[:6]), reads=ge[0],
              row=False)
    owner4 = _kernels.junction_entries(*ge4)[2].view(4, -1)[:, :ge[1]]
    spread = torch.bincount(owner4.reshape(-1), minlength=4).tolist()
    if min(spread) == 0:
        raise AssertionError(f"junction_entries at 4 ranks: entries per owner "
                             f"{spread}")
    extra.append((f"junction_keys, global mode at 4 ranks (entries per owner "
                  f"{spread})", r))
    gk, gp, tot = inputs["junction_edges"]

    def edges(fn):
        """(ok, src, dst) with src and dst kept where ok only."""
        ok, src, dst = fn(gk, gp, tot)
        return ok, torch.where(ok, src, -1), torch.where(ok, dst, -1)

    r = check("junction_pairs", lambda: edges(_kernels.junction_edges),
              lambda: edges(junctions.junction_edges_plain),
              lambda: _kernels.junction_edges(gk, gp, tot),
              lambda: junctions.junction_edges_plain(gk, gp, tot),
              reads=(gk, gp), row=False)
    extra.append((f"junction_pairs, global mode (edges of {gk.shape[1]} sorted "
                  f"entries)", r))
    for r in rows:
        lib = ("" if r["library_ms"] is None
               else f", library call {r['library_ms']:.4f} ms")
        say(f"[kernel] {r['name']}: equal to plain (bitwise), {r['ms']:.4f} ms "
            f"vs plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){lib}, {r['launches']} launches in the "
            f"full-size run")
    for what, r in extra:
        say(f"[kernel] {what}: equal to plain, {r['ms']:.4f} ms vs plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    shapes = {"extract_insert": tuple(words.shape), "count_runs": tuple(s_lanes.shape),
              "junction_keys": tuple(solid.shape), "junction_pairs": tuple(s_keys.shape),
              "jump_round": tuple(Q.shape), "range_fold": tuple(body.shape),
              "lower_bound": [tuple(run.shape), n, tuple(bounds.shape)],
              "solid_fold_histogram": tuple(sf_args[0].shape),
              "run_scans": [tuple(succ.shape), n_solid, C],
              "solid_compact": [tuple(sc_args[0].shape), sc_args[6]],
              "chain_finish": tuple(cf_args[3].shape),
              "spell_unitigs": [tuple(su_args[0].shape), su_args[6]],
              "run_contract": [tuple(rc_args[0].shape), rc_args[4], rc_args[5]],
              "run_broadcast": [tuple(rb_args[3].shape), tuple(rb_args[0].shape)],
              "form_superkmers": [tuple(sw.shape), tuple(table.shape)],
              "mmer_histograms": [tuple(hw.shape), tuple(lw.shape)],
              "route_buckets": [tuple(stk.shape), n_dev, cap],
              "glue_compose": tuple(gQ.shape),
              "junction_entries": tuple(ge[0].shape),
              "junction_edges": tuple(gk.shape)}
    say(f"[shapes] {json.dumps(shapes)}")
    return rows


def phase_canonical_times(M: int, launches, inputs, dev):
    """Phase 3d's last step: the doubling rounds and the K4/K10 times of
    the canonical-order compaction at full width (M = 2C oriented nodes),
    on the inputs that run fed them."""
    from bcalm_tpu_torch.ops import _kernels, chains

    Q = inputs["jump_round"][0].to(dev)
    Qn = torch.empty_like(Q)
    changed = torch.zeros((1,), dtype=torch.int32, device=dev)
    k4 = _time_ms(lambda: _kernels.jump_round(Q, Qn, changed))
    k4_plain = _time_ms(lambda: chains.jump_round_plain(Q))
    del Q, Qn
    cf_args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                    for a in inputs["chain_finish"])
    got = _finish_tuple(_kernels.chain_finish(*cf_args))
    want = _finish_tuple(chains.finish_fast_plain(*cf_args))
    if _max_err(got, want) != 0:
        raise AssertionError("chain_finish differs from its plain version at "
                             "full width")
    k10 = _time_ms(lambda: _kernels.chain_finish(*cf_args), reps=5)
    k10_plain = _time_ms(lambda: chains.finish_fast_plain(*cf_args), reps=5)
    say(f"[multi] canonical-order compaction: M = {M} oriented nodes, "
        f"{launches['jump_round']} doubling rounds; K4 {k4:.4f} ms per round "
        f"(plain {k4_plain:.4f} ms); K10 {k10:.4f} ms (plain {k10_plain:.4f} "
        f"ms), equal to its plain version at M")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coverage", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1: only the -devices N build over N cards")
    ap.add_argument("--compare-tree", metavar="DIR",
                    help="only time the CLI of the tree in DIR against this "
                         "one's, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    name, smi = phase_device()
    if args.compare_tree:
        with tempfile.TemporaryDirectory() as tmp:
            phase_compare(tmp, args.compare_tree, args.coverage, args.seed)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if args.devices > 1:
        if torch.cuda.device_count() < args.devices:
            print(f"chip_smoke: --devices {args.devices} needs as many cards, "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 1
        with tempfile.TemporaryDirectory() as tmp:
            phase_cards(tmp, args.devices, args.coverage, args.seed)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    phase_fixtures(dev, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        fa, path, stats, launches, inputs = phase_full(tmp, args.coverage,
                                                       args.seed)
        ooc_launches, ooc_inputs = phase_ooc(tmp, fa, path, stats, dev)
        phase_resume(tmp, fa, path, stats)
        M, ms_launches, ms_inputs, table = phase_multi(
            tmp, fa, path, args.coverage, args.seed, dev)
        phase_canonical_times(M, ms_launches, ms_inputs, dev)
        del ms_inputs
        phase_auto(tmp, fa, path)
        mesh_launches, mesh_inputs = phase_mesh(tmp, fa, path, table, dev)
        del table
        phase_invariants(path, stats)
    # each kernel is held against its plain version on the inputs of the
    # run whose path needs it, and reports that run's launches
    for kernel in ("range_fold", "lower_bound"):
        inputs[kernel] = ooc_inputs[kernel]
        launches[kernel] = ooc_launches[kernel]
    for kernel in ("form_superkmers", "mmer_histograms:mmer",
                   "mmer_histograms:load", "route_buckets",
                   "glue_compose") + GLOBAL_K3:
        inputs[kernel] = mesh_inputs[kernel]
    for kernel in ("form_superkmers", "mmer_histograms", "route_buckets",
                   "glue_compose"):
        launches[kernel] = mesh_launches[kernel]
    del mesh_inputs
    rows = phase_kernels(inputs, launches, dev)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
