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
   removes it at the end.  Its contracted run graph (2^19 nodes) is jumped
   hierarchically (K17-K19, K4 at the deepest level); on that graph the
   hierarchical and the plain variant must give equal finish outputs, and
   their level sizes, rounds and stage times are printed;
3b. the same reads and flags with ``-max-memory M``, M chosen from the
   port's memory model so that the resident budget holds at most a third
   of the distinct k-mers phase 3 counted: counting goes multi-pass over
   key ranges; again first as ``python -m bcalm_tpu_torch``, then
   through ``cli.main`` with the counters reset just before it.  At least
   3 ranges, the FASTA byte-identical to phase 3's, peak device memory
   within M (the device block cache reserved inside it), the passes after
   the first replayed from the device block cache (ooc_block_cache_mb and
   each pass's time printed, with the counting peak), K1 launched in
   range mode (after the first split it folds the columns outside the
   range as it writes them; K5 runs only on the chunks a split left owing
   a fold, and their count is printed); then once more through
   ``cli.main`` with the cache made to overflow, so that passes 2.. re-read
   and re-upload the input (the path of an input too large for the
   cache): ooc_block_cache_mb 0, the same passes, K1 in range mode, the
   same bytes and peak within M, its pass times beside the cached run's;
3c. store and resume on the same reads: ``-only-uf -uf-stats`` keeps the
   store and its chains (as many classes as phase 3's unitigs); with the
   input renamed away, ``-skip-bcalm -skip-bglue`` and, after a fresh
   ``-only-uf``, ``-skip-bcalm`` alone (in process too, counters reset)
   write phase 3's bytes; ``-redo-links`` leaves phase 3's FASTA as it is,
   and (in process) restores its stripped links with K22 and K23;
3i. the keep-alive server: ``python -m bcalm_tpu_torch -server`` timed
   from its spawn to its listening line (its ready line, kernels and
   ingest library loaded, comes first); phase 3's arguments three times
   and 3b's once through ``python -m bcalm_tpu_torch -connect``, each
   answer phase 3's bytes with the in-process run's device_peak_mb (a
   gzip cut short, which fails mid-build with rc 1, sent between the
   second and the third), each client's wall printed beside phase 3's
   fresh ``python -m`` wall; a
   missing input answered rc 1, then a shutdown ends the server with rc
   0; the server's log gives its reserved memory after each request;
3j. the compaction-OOM respawn: 3b's build in a child process whose
   allocator is capped between 3b's counting peak and its build's peak
   (both printed): compaction raises torch.OutOfMemoryError, and the CLI
   re-runs itself with -skip-bcalm in a fresh process on the card, which
   writes phase 3's bytes;
3d. multi-sample solidity: a second read set of the same genome (seed +
   1); an album of the two under ``-solidity-kind min`` and ``max`` must
   give the canonical k-mers and the KC of numpy's min/max combination of
   the two samples' count tables; ``min`` over phase 3's file and a hard
   link to it (the canonical-order compaction at full width, in process
   too) gives phase 3's unitigs and KC; at its M = 2C oriented nodes the
   hierarchical and the plain jump are compared as in phase 3, and K10's
   time and the run's device_peak_mb are printed;
3e. ``-abundance-min auto``: the chosen cutoff, and the bytes of a run
   with that cutoff given;
3f. the ``-devices N`` build (parallel.pipeline.distributed_build) on the
   same reads with m = 10, in this process over an NCCL group of world
   size 1 (one card: every exchange is a real collective, trivially a
   copy), the launch counters reset just before it: its canonical unitig
   set, KC, km, per-k-mer abundances and link count must equal phase 3's
   output, and K13-K16 and K21 with the reused K1, K2, K3, K7, K8 and K11
   must have launched; its stats and wall split are printed, and, while
   its group is up, K3's global step on its shard (the entries, K15 and
   the exchange, the compaction of the valid entries, the sort of those,
   the pair rule, the edges' exchange, the scatter) against the step with
   the plain versions, with the CUDA-event times of its two exchanges
   (the all_to_all alone, then Mesh.exchange on K15's send buffer).  Then
   its
   multi-pass branch: the first 1/32 of the reads under a residency
   budget of a third of their distinct k-mers (key ranges, K5, one pass
   over the input per range), counters reset just before it, equal to
   the single-device build of the same reads.  ``python -m bcalm_tpu_torch
   ... -devices N`` with N past the cards exits 1 with the JAX package's
   message;
3g. the per-k-mer mesh entry points over the same NCCL group, on the
   first 1/8 of the reads, counters reset just before them:
   pack_global_blocks, distributed_count (K1, K15 in its hash mode, K2)
   and gather_solid
   (nothing dropped, equal to the single-device count), the per-k-mer
   minimizers and partition ids of the solid set (K20), then
   distributed_compact_pos with first-occurrence keys and
   distributed_compact (K3 global mode, K8, K16, K11): both equal to the
   single-device CLI on those reads (unitigs, KC, km, links); after the
   launches are read, the count's exchange (CUDA events: the all_to_all
   alone, Mesh.exchange on K15's send buffer, and K15 with it);
3h. long k (9-32 lanes): a second read set of the same genome at 30x with
   300 bp reads (the MiSeq 2x300 length), 0.08% errors and 20% duplicates,
   built in this process with ``-kmer-size 151`` (10 lanes), then its first
   quarter with ``-kmer-size 255`` (16 lanes), the counters reset just
   before each build: each build's wall, device_peak_mb and launches, its
   resident path's kernels all launched, and the phase 4 invariants held
   at its k; the k = 151 build is also judged by the benchmark's plain
   reference (cdbg_bench/reference.py), every compared count 0;
4. output invariants of the phase 3 run: each solid canonical k-mer once,
   KC sums, every L: link a real (k-1)-overlap;
5. each kernel vs its plain PyTorch version on the card, on the inputs
   the full-size runs fed it: bitwise equality, CUDA-event times, the
   launches of the run whose path needs it, the bound (bytes moved over
   the card's memory rate, or integer operations over its peak rate) and,
   where one PyTorch call computes the same function, that call's time;
   K1 on phase 3's block, with per-row slot bases on phase 3f's received
   superkmers, in range mode on phase 3b's first range-mode block, and at
   L = 10 and 16 on phase 3h's blocks; K2 (count_sorted, on the sort's
   own output) on phase 3's, phase 3b's and phase 3f's first count and on
   phase 3b's first LSM merge (weighted), each with the launches of its
   kind in its run (the merges counted as count_sorted_weighted), its
   bound counting the run's data (perm and the random sectors of pos,
   weights and lower words only where a column needs its entry); K5 on phase 3b's first chunk in
   range mode (that block extracted without the range, the chunk a column
   slice), the same chunk at an odd stride, and the first chunk 3b owed a
   fold, if any; each K1 and K5 row with its device time and operations
   and its launches in phases 3, 3b, 3f and 3h;
   K14 in both its modes on phase 3f's sampling (every buffered round's
   rows in one launch, timed adding into one histogram) and the whole
   sampling of a 3f build (both modes, each into a histogram it zeroes),
   with the L2 atomics K14 makes; K13 and K3's global mode (the sharded glue's
   junction entries) also with 4 ranks as owners, since at world size 1
   every owner is 0; K15 (which writes the exchange's send buffer, each
   call also held with the other fill word, 0 or the sentinel) also at 4
   and 8 destinations (synthetic owners) and in its hash mode on phase
   3g's k-mers at world size 1 (a row of its own) and 4, with the passes
   of the exchange's receive side on those buffers (device time);
   K17-K19 at level 0 of phase 3's and of phase 3d's hierarchical jump,
   K17 also at level 1 of phase 3d's (K17's round and K19's bounds count
   a random row's 32-byte sector per row not ROOTED only where its array
   exceeds the L2, each beside the earlier count; K19, which runs over
   Qd, writes no ROOTED row, and is timed on a fresh copy of Qd each call
   with the copy taken out) and K10 also at phase
   3d's M; K4's plain variant on the first round of phase 3's and phase
   3d's plain runs (compare_jumps), with those runs' launches and rounds
   that moved a row and those of phase 3h's k = 255 build, which jumps
   below _HIER_MIN, and its converging phase (the flag mode, a host sync
   a batch) held against plain rounds; K16 in place on the first round of
   phase 3f's sharded doubling and, measured in phase 3f while its group
   is up, that whole glue round (K15, the exchange, the owners' answer
   K21, the response, K16) against the round with plain K15, K21 and K16,
   each over fresh copies of the state with the copies taken out; K21 in
   its three modes on phase 3f's first round and its two lookups (with
   torch.index_select at the local rows, not the same function, beside
   it) and K3's global mode after the exchange (the compaction of the
   valid received entries into their sort words and payloads, the pair
   rule over those alone, the windowed scatter with index_put_ at
   precomputed slots beside it, not the same function) on phase 3f's
   step, with the step's row from phase 3f (n, the count sorted, and the
   wall time of its host read; the inputs of K21 and of the compaction,
   pair rule and scatter are recorded after 3f's timed build, by running
   its K3 global step and glue again: REPLAYED); the pair rule's bound
   counts what the run's data needs (the top words, the pair heads' perm
   and payload sectors, the lower words only where the top words tie);
   K20's three modes on phase 3's solid k-mers (its launches are phase
   3g's, on 3g's own solid set): the histogram (torch.bincount is its
   library call), partition ids with phase 3f's frequency rank and a 4-rank
   table, lexicographic minimizers, each with the L2 operations that set
   its pace (N(k-m+1) atomics or random rank sectors) and their rate.  Then
   one row per lane-dependent kernel at L = 10, on the inputs phase 3h's
   k = 151 build fed it (K1, K2, K3a with its five packed words, K3b on
   them, K7, K9, K11), or made from them where
   that build does not run the kernel (K5 and K6 on its sorted chunk, K3's
   global mode and K20's three modes on a 2^20-column slice of its solid
   table, K20 also at L = 16 on the k = 255 build's), and one for K9 in
   filter_abundance mode (no minpos row) on its counted table.  K6 also
   runs at 256 quantile bounds of phase 3b's run.  Every row carries the
   device time and device operations per call (torch.profiler) of the
   kernel and the device time of its library call, beside their CUDA-event
   times, which include the launch path.  K3b's
   bound counts its own bytes: the sorted top word, the perm sectors and
   random payload sectors its pair heads read, and succ written once.

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
the phase 3 reads, resident and with each tree's phase 3b ``-max-memory``
(its pass times printed), after a
warm-up run of each that builds its kernels and ingest library; before
those runs, KERNEL_AB (below) times the L = 2 lane kernels, K1 at L = 10
and in range mode, the count step after the sort at phase 3's, 3b's
chunk's, an LSM merge's, 3h's L = 10 and a 3f round's shapes (a tree
whose K2 reads the sort's own output: that kernel; else the gathers of
the sorted lanes, weights and pos, then the earlier kernel) beside
torch.unique_consecutive, K3a at L = 10 and 16, K6, K9, K13 and K15 (and
K15's hash mode with one exchange as the per-k-mer count makes it, the
all_to_all a copy of the buffer, at 1 and 4 ranks), the
K3b step at phase 3's shape (a tree whose pair kernel takes the sort's own
word: that kernel; else the gathers of the sorted keys and payload, then
the kernel), K18 at level 0 of phase 3's and the canonical order's
jump, K17 at the first round of its levels 0 and 1 and of phase 3's level
0 (in a tree with the fixpoint bitmap, the round given it, and the
bitmap's own build),
K10 at phase 3's M and at 2^24, K19 at the same three levels as K17 (on
a fresh copy of Qd each call, the copy taken out) and
K11 at phase 3's and phase 3h's shapes (k = 31, 151, 255), K4 at 2^19
and 2^24 (a round, and plain_jumpF to convergence), K16's compose step
at phase 3f's 2^22 rows (in a tree whose K16 works in place, the kernel
over fresh copies of the state; else the response's gather and
transpose, the kernel and the passes that make the next round's need,
ptr column and owners), K21 in its three modes at phase 3f's shapes (in a
tree without it, the answer and the copy its _respond made: the
all_to_all, alike in both, is left out), K3's global step at phase 3f's
shape after its exchanges (entries with their validity and stack; the
compaction of the valid entries, the sort of those and the pair rule, or
the sort words of every slot, the sort and the pair rule, or the fills,
the gathers and the earlier pair kernel; the windowed scatter, the
scatter after a memset, or the boolean compaction and scatter), of each
tree in the same turns
(CUDA events, device time and operations, and for K13 and K15 the host
time per call split into the wrapper's Python, the ctypes call and the
runtime's launch; the K3b step's, K8's, K12a's, K17's, K18's, K10's,
K19's, K11's, K4's, K16's, K21's and K3's global step's outputs must
agree across the trees),
K20's three modes at phase 3's and 3h's shapes and K14's sampling of 8
rounds in both modes (one launch per mode in a tree whose K14 adds into
the caller's histogram, else one per round and the sums; outputs must
agree); then
SPLIT once in each tree (device time per operation); and DIST_AB runs
each tree's ``-devices`` build at world size 1 on the first 1/8 of the
reads in the same turns, held against the single-device build.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K = 31
LONG_K, LONG_K2 = 151, 255    # 10 and 16 lanes (phase 3h)
LONG_READ_LEN, LONG_COVERAGE = 300, 30.0
KERNELS = {  # wrapper name -> (CUDA source, the JAX device program it replaces)
    "extract_insert": ("bcalm_tpu_torch/csrc/extract.cu",
                       "bcalm_tpu/engine.py:243"),
    "count_sorted": ("bcalm_tpu_torch/csrc/count.cu",
                     "bcalm_tpu/ops/count.py:78"),
    "junction_keys": ("bcalm_tpu_torch/csrc/junctions.cu",
                      "bcalm_tpu/ops/junctions.py:142"),
    "junction_pairs": ("bcalm_tpu_torch/csrc/junctions.cu",
                       "bcalm_tpu/ops/junctions.py:142"),
    "jump_round": ("bcalm_tpu_torch/csrc/hier.cu",
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
    "glue_answer": ("bcalm_tpu_torch/csrc/glue.cu",
                    "bcalm_tpu/parallel/distcompact.py:313"),
    "junction_words": ("bcalm_tpu_torch/csrc/junctions.cu",
                       "bcalm_tpu/parallel/distcompact.py:100"),
    "junction_scatter": ("bcalm_tpu_torch/csrc/junctions.cu",
                         "bcalm_tpu/parallel/distcompact.py:128"),
    "fixpoint_bits": ("bcalm_tpu_torch/csrc/hier.cu",
                      "bcalm_tpu/ops/chains.py:336"),
    "hier_round": ("bcalm_tpu_torch/csrc/hier.cu",
                   "bcalm_tpu/ops/chains.py:298"),
    "hier_contract": ("bcalm_tpu_torch/csrc/hier.cu",
                      "bcalm_tpu/ops/chains.py:402"),
    "hier_expand": ("bcalm_tpu_torch/csrc/hier.cu",
                    "bcalm_tpu/ops/chains.py:448"),
    "kmer_minimizers": ("bcalm_tpu_torch/csrc/minimizer.cu",
                        "bcalm_tpu/models/minimizer.py:59"),
    "link_ends": ("bcalm_tpu_torch/csrc/links.cu",
                  "bcalm_tpu/engine.py:1415"),
    "link_pairs": ("bcalm_tpu_torch/csrc/links.cu",
                   "bcalm_tpu/engine.py:1415"),
}
HIER = ("fixpoint_bits", "hier_round", "hier_contract", "hier_expand")
# kernels whose last call is recorded: the upward pass of the hierarchical
# jump ends at level 0
RECORD_LAST = ("hier_expand",)
# K3's global mode (the sharded junction matching): the entries count
# their launches under junction_keys and the pair rule under
# junction_pairs (the global modes of K3a and K3b); the sort words and the
# successor shard's scatter count their own
GLOBAL_K3 = ("junction_entries", "junction_words", "junction_edges",
             "junction_scatter")
# wrappers whose inputs phase 3f records after its timed build, by running
# the build's K3 global step and glue again (their first inputs are ~3 GB,
# whose copy to the host would fall inside the build's own timing)
REPLAYED = ("junction_words", "junction_edges", "junction_scatter",
            "glue_answer")
# K21's modes and the JAX lines each replaces (_glue_shard's answers);
# LAUNCHES counts each mode as glue_answer_<mode>
GLUE_ANSWER = {"rows": "bcalm_tpu/parallel/distcompact.py:313",
               "run": "bcalm_tpu/parallel/distcompact.py:258",
               "uid": "bcalm_tpu/parallel/distcompact.py:378"}
# H100 SXM: HBM3 rate, and the fp32 non-tensor peak taken as the rate of
# 32-bit integer operations (no lower bound in time is lost by taking a
# rate that is at least the real one)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
# H100's L2: a table that fits is read from HBM once however often its
# rows are gathered
L2_BYTES = 50 * 2**20
# the kernels each main path must launch: the resident build (with its
# store), the multi-pass build (whose solidity filter and store run in
# numpy on the host; K1 folds in range mode after the first split, and K5
# runs only on chunks owed a fold, so it need not launch), the -skip-bcalm
# resume (compaction only), and the multi-sample build (counting, then the
# canonical-order compaction); at the smoke's size both compactions jump
# hierarchically (K17-K19, K4 at the deepest level); every build that
# assembles links its unitigs on the card (K22, K23)
LINKS = ("link_ends", "link_pairs")
COMPACT_POS = ("junction_keys", "junction_pairs", "run_scans", "run_contract",
               "jump_round", "chain_finish", "run_broadcast",
               "spell_unitigs") + HIER + LINKS
RESIDENT_PATH = ("extract_insert", "count_sorted", "solid_fold_histogram",
                 "solid_compact") + COMPACT_POS
OOC_PATH = ("extract_insert", "extract_insert_ranged", "count_sorted",
            "lower_bound") + COMPACT_POS
SKIP_BCALM_PATH = COMPACT_POS
CANONICAL_PATH = ("extract_insert", "count_sorted", "junction_keys",
                  "junction_pairs", "jump_round", "chain_finish",
                  "spell_unitigs") + HIER + LINKS
K21_MODES = tuple(f"glue_answer_{m}" for m in GLUE_ANSWER)
MESH_PATH = ("form_superkmers", "mmer_histograms", "route_buckets",
             "glue_compose", "extract_insert", "count_sorted", "junction_keys",
             "junction_words", "junction_pairs", "junction_scatter",
             "solid_fold_histogram", "run_scans",
             "spell_unitigs") + K21_MODES + LINKS
# the per-k-mer mesh entry points (phase 3g): the hash-routed count, the
# per-k-mer minimizers of its solid set, the host-driven compactions
ENTRY_PATH = ("extract_insert", "route_buckets_hash", "route_buckets",
              "count_sorted",
              "kmer_minimizers", "junction_keys", "junction_words",
              "junction_pairs", "junction_scatter", "run_scans",
              "glue_compose", "spell_unitigs") + K21_MODES + LINKS
# the long-k resident builds (phase 3h): the resident path, the jump
# hierarchical only where the run graph reaches 2^18 nodes
LONGK_PATH = ("extract_insert", "count_sorted", "solid_fold_histogram",
              "solid_compact", "junction_keys", "junction_pairs", "run_scans",
              "run_contract", "jump_round", "chain_finish", "run_broadcast",
              "spell_unitigs") + LINKS


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
                sample_seed=None, read_len: int = 150) -> int:
    """Reads of the genome made from `seed`; sample_seed draws another read
    set of the same genome (default: the genome's own generator goes on)."""
    from bcalm_tpu_torch.utils import dna

    rng = np.random.RandomState(seed)
    genome = make_genome(4_600_000, rng, repeat_frac=0.05)
    if sample_seed is not None:
        rng = np.random.RandomState(sample_seed)
    n_reads = int(coverage * genome.shape[0] / read_len)
    reads = sample_reads(genome, n_reads, read_len, rng, err_rate=0.0008,
                         dup_frac=0.2)
    rec = np.empty((reads.shape[0], 3 + read_len + 1), np.uint8)
    rec[:, :3] = np.frombuffer(b">r\n", np.uint8)
    rec[:, 3:3 + read_len] = dna.CODE_TO_ASCII[reads]
    rec[:, 3 + read_len] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())
    return reads.shape[0]


def _record_key(name: str, args) -> str:
    """mmer_histograms runs in two modes, the m-mer histogram and the
    minimizer load (its sixth argument), kmer_minimizers in two, the
    minimizer (or partition id) and the histogram (its last argument),
    route_buckets in two, given owners and hashed ones (no owner array),
    and extract_insert in two, with and without a key range (lo, hi),
    count_sorted in two, with weights (an LSM merge) and without:
    each mode is recorded apart; fixpoint_bits' and hier_round's first
    call with a gid array (level 1) apart from their first call (level 0,
    which passes no gid); glue_answer's three modes (its first argument)
    apart."""
    if name == "glue_answer":
        return f"glue_answer:{args[0]}"
    if name == "count_sorted" and args[4] is not None:
        return "count_sorted:weighted"
    if name == "route_buckets" and args[2] is None:
        return "route_buckets:hash"
    if name == "fixpoint_bits" and args[0] is not None:
        return "fixpoint_bits:upper"
    if name == "hier_round" and args[2] is not None:
        return "hier_round:upper"
    if name == "extract_insert" and len(args) > 7 and args[7] is not None:
        return "extract_insert:ranged"
    if name == "mmer_histograms":
        return f"{name}:{'load' if args[5] else 'mmer'}"
    if name == "kmer_minimizers":
        return f"{name}:{'histogram' if args[-1] else 'minimizer'}"
    return name


class Recorder:
    """Keeps the first inputs each kernel wrapper (each mode of
    mmer_histograms and kmer_minimizers) received, or for RECORD_LAST its
    last ones, copied to the host before the call (extract_insert and
    range_fold write in place; host copies leave the run's peak device
    memory as a user's run has it).  Arguments passed by keyword are
    recorded in the wrapper's parameter order, defaults filled in."""

    def __init__(self, kmod, names=tuple(KERNELS)):
        self.kmod = kmod
        self.inputs = {}
        self.saved = {n: getattr(kmod, n) for n in names}

    def _wrap(self, name):
        import inspect

        fn = self.saved[name]
        sig = inspect.signature(fn)

        def recorded(*args, **kwargs):
            flat = args
            if kwargs:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                flat = tuple(bound.arguments.values())
            key = _record_key(name, flat)
            if key not in self.inputs or name in RECORD_LAST:
                self.inputs[key] = _moved(flat, "cpu")
            return fn(*args, **kwargs)
        return recorded

    def __enter__(self):
        for n in self.saved:
            setattr(self.kmod, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.kmod, n, fn)


def _moved(args, device):
    """Recorded arguments on `device` (copies), tensors inside tuples too
    (glue_answer's tables)."""
    if isinstance(args, torch.Tensor):
        return args.to(device, copy=True)
    if isinstance(args, tuple):
        return tuple(_moved(a, device) for a in args)
    return args


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


def _inproc(args, what: str, record=tuple(KERNELS)):
    """cli.main in this process with the launch counters and the converging
    phases' round counts reset just before it: (wall, stats (with the
    round counts as `converge_rounds`), stdout, launches, the inputs of the
    kernels named in record).  The allocator's cache is emptied first, so
    the run's device_peak_mb is a fresh process's (a cached block reused
    whole counts in full)."""
    import gc

    from bcalm_tpu_torch import cli
    from bcalm_tpu_torch.ops import _kernels, chains

    gc.collect()
    torch.cuda.empty_cache()
    buf = io.StringIO()
    with Recorder(_kernels, record) as rec:
        _kernels.reset_launches()
        chains.reset_rounds()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"cli.main {what} exited {rc}:\n{buf.getvalue()}")
    stats = _stats(buf.getvalue())
    stats["converge_rounds"] = dict(chains.ROUNDS)
    return wall, stats, buf.getvalue(), launches, rec.inputs


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _run_cli(tmp: str, args, what: str, out: str):
    """The CLI once as `python -m bcalm_tpu_torch` (a user's run), then
    once through cli.main in this process with the launch counters reset
    just before it; both outputs must be byte-identical.  Returns (path of
    the in-process output, its stats, the subprocess's stats, its
    launches, recorded inputs)."""
    sub_wall, sub_stats, _ = _sub(
        args + ["-out", os.path.join(tmp, out + "_sub")], what)
    _report(f"python -m bcalm_tpu_torch {what} (process start included)",
            sub_wall, sub_stats)
    wall, stats, _, launches, inputs = _inproc(
        args + ["-out", os.path.join(tmp, out)], what)
    _report("cli.main, same arguments, in this process", wall, stats)
    stats["wall_s"] = wall
    stats["sub_wall_s"] = sub_wall
    path = os.path.join(tmp, out + ".unitigs.fa")
    if _read(path) != _read(os.path.join(tmp, out + "_sub.unitigs.fa")):
        raise AssertionError("the two CLI runs wrote different unitigs")
    for prefix in (out, out + "_sub"):
        if os.path.exists(os.path.join(tmp, prefix + "_btpu")):
            raise AssertionError(f"{prefix}_btpu/ was left after the run")
    say(f"[launches] {json.dumps(launches)}; converging phases (K4 rounds "
        f"launched, rounds that moved a row, host syncs): "
        f"{json.dumps(stats['converge_rounds'])}")
    return path, stats, sub_stats, launches, inputs


def _require_launched(launches, path_kernels, what: str):
    for name in path_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"{what} main path")


def resident_args(fa: str):
    """Phase 3's command line."""
    return ["-in", fa, "-kmer-size", str(K), "-abundance-min", "2",
            "-verbose", "1"]


def phase_full(tmp: str, coverage: float, seed: int):
    """The resident build of the E. coli-class reads."""
    fa = os.path.join(tmp, "reads.fa")
    t0 = time.time()
    n_reads = write_reads(fa, coverage, seed)
    say(f"[input] {n_reads} reads of 150 bp (4.6 Mbp genome, {coverage}x, "
        f"seed {seed}) written in {time.time() - t0:.1f}s")
    path, stats, sub_stats, launches, inputs = _run_cli(
        tmp, resident_args(fa), "-kmer-size 31 -abundance-min 2", "ec")
    _require_launched(launches, RESIDENT_PATH, "resident")
    for what, st in (("python -m", sub_stats), ("cli.main", stats)):
        if st.get("ingest_parser") != "native":
            raise AssertionError(f"{what}: ingest_parser "
                                 f"{st.get('ingest_parser')}, expected native")
    say("[full] ingest_parser native in both runs")
    for what, st in (("python -m", sub_stats), ("cli.main", stats)):
        say(f"[full] {what}: device_pass1_peak_mb "
            f"{st['device_pass1_peak_mb']} (the count's one pass, the device "
            f"block cache's fill included), device_count_peak_mb "
            f"{st['device_count_peak_mb']} (its final merge too), "
            f"device_peak_mb {st['device_peak_mb']} (the whole build)")
    return fa, path, stats, launches, inputs


def compare_jumps(what: str, run, q0, q_deep):
    """The hierarchical and the plain variant of one chain decomposition on
    the card (run(variant) -> finish outputs): equal outputs, the level
    sizes, the rounds per level, each variant's stage time (CUDA events,
    the deepest level's host syncs included), and K4's time per round on
    the plain variant's state q0 and on the deepest level's q_deep.
    Returns the stage times and, for phase 5's row of K4's plain variant,
    q0 (on the host), the plain run's K4 launches and its converging
    phase's round counts (chains.ROUNDS)."""
    from bcalm_tpu_torch.ops import _kernels, chains

    out, launched, ms, peak, rounds = {}, {}, {}, {}, {}
    for variant in ("hier", "plain"):
        before = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        chains.reset_rounds()
        out[variant] = run(variant)
        torch.cuda.synchronize()
        rounds[variant] = dict(chains.ROUNDS)
        peak[variant] = (torch.cuda.max_memory_allocated() - base) >> 20
        launched[variant] = {n: _kernels.LAUNCHES[n] - before[n] for n in before}
        ms[variant] = _time_ms(lambda: run(variant), reps=5)
    h, p = out["hier"], out["plain"]
    n = int(p["n_unitigs"])
    if int(h["n_unitigs"]) != n:
        raise AssertionError(f"{what}: hierarchical n_unitigs {int(h['n_unitigs'])}"
                             f" (-1: a level overflowed), plain {n}")
    for key in ("uid", "rank"):
        if not torch.equal(h[key], p[key]):
            raise AssertionError(f"{what}: hierarchical {key} differs from plain")
    for key in ("start_oid", "length", "circular"):
        if not torch.equal(h[key][:n], p[key][:n]):
            raise AssertionError(f"{what}: hierarchical {key} differs from plain")
    M = q0.shape[0]
    sizes = chains.level_sizes(M)
    lh, lp = launched["hier"], launched["plain"]
    k4 = {}
    for name, q in (("M", q0), ("deepest", q_deep)):
        qn = torch.empty_like(q)
        changed = torch.zeros((1,), dtype=torch.int32, device=q.device)
        k4[name] = _time_ms(lambda: _kernels.jump_round(q, qn, changed))
    k4_plain = _time_ms(lambda: chains.jump_round_plain(q0), reps=5)
    say(f"[hier] {what}: M = {M}, levels {sizes}; hierarchical jump ok, its "
        f"finish outputs equal the plain doubling's ({n} unitigs); hier: "
        f"{chains._R_A} K17 rounds at each of the first {len(sizes) - 1} "
        f"levels ({lh['hier_round']} launches), {lh['hier_contract']} K18, "
        f"{lh['jump_round']} K4 rounds at the deepest level ({sizes[-1]} "
        f"rows; {rounds['hier']['moved']} moved a row, "
        f"{rounds['hier']['syncs']} host syncs), {lh['hier_expand']} K19; "
        f"plain: {lp['jump_round']} K4 rounds at M ({rounds['plain']['moved']} "
        f"moved a row, {rounds['plain']['syncs']} host syncs); stage time "
        f"(pred, jump and finish) hier {ms['hier']:.4f} ms, "
        f"plain {ms['plain']:.4f} ms; stage peak above its inputs hier "
        f"{peak['hier']} MiB, plain {peak['plain']} MiB; K4 per round "
        f"{k4['M']:.4f} ms at M (bound {_bound(2 * _nbytes(q0), 0)[0]:.4f} "
        f"ms, plain version {k4_plain:.4f} ms), {k4['deepest']:.4f} ms at the "
        f"deepest level")
    return ms, (q0.cpu(), lp["jump_round"], rounds["plain"])


def phase_hier_resident(inputs, dev):
    """Phase 3's hierarchical vs plain jump on the contracted run graph it
    recorded (run_contract's inputs give csucc, cvalid, wlen2).  Returns the
    plain variant's first K4 input and its K4 launches (compare_jumps)."""
    from bcalm_tpu_torch.ops import chains, runchains

    rc = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
               for a in inputs["run_contract"])
    _, _, csucc, cvalid, wlen2 = runchains.run_contract(*rc)
    cpred = chains.build_pred(csucc, cvalid)
    R2 = csucc.shape[0]
    q0 = chains.init_state(cpred, cvalid, wlen2[torch.clamp(cpred, 0, R2 - 1)])
    return compare_jumps("resident run (phase 3), contracted run graph",
                         lambda v: runchains.contracted_jump(csucc, cvalid,
                                                             wlen2, v),
                         q0, inputs["jump_round"][0].to(dev))[1]


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
        # the device block cache holds the input: passes 2.. replay it
        if float(st["ooc_block_cache_mb"]) <= 0:
            raise AssertionError(f"{what}: the later passes re-read the "
                                 f"input (ooc_block_cache_mb "
                                 f"{st['ooc_block_cache_mb']})")
        say(f"[ooc] {what}: ooc_passes {st['ooc_passes']}, ooc_ranges "
            f"{st['ooc_ranges']}, ooc_block_cache_mb "
            f"{st['ooc_block_cache_mb']} (passes 2-{st['ooc_passes']} "
            f"replayed from the device), pass times "
            f"{_literal(st['timing'])['passes']} s, device_count_peak_mb "
            f"{st['device_count_peak_mb']}, device_peak_mb "
            f"{st['device_peak_mb']} <= {mb}; timing {st['timing']}")
    with open(path, "rb") as f1, open(resident_path, "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("the multi-pass FASTA differs from the "
                                 "resident run's")
    say(f"[ooc] multi-pass FASTA byte-identical to the resident run's; "
        f"in-process wall {stats['wall_s']:.2f}s; launches: K1 "
        f"{launches['extract_insert']} without a key range, "
        f"{launches['extract_insert_ranged']} in range mode; K5 "
        f"{launches['range_fold']} (chunks owed a fold); K6 "
        f"{launches['lower_bound']}")
    _require_launched(launches, OOC_PATH, "multi-pass")
    stats["max_memory"] = mb
    phase_ooc_reread(tmp, args, resident_path, stats)
    return launches, inputs, (args, path, stats)


def phase_ooc_reread(tmp: str, args, resident_path: str, cached) -> None:
    """3b's arguments once more in this process with the device block
    cache made to overflow (its size set to half what 3b's cache held,
    after configure_chunk sized the chunk and the resident budget with
    the full reservation): passes 2.. re-read and re-upload the input
    (the path of an input too large for the cache), with 3b's passes,
    phase 3's bytes and device_peak_mb <= M."""
    from bcalm_tpu_torch import engine

    mb = cached["max_memory"]
    small = int(float(cached["ooc_block_cache_mb"])) // 2
    real = engine.configure_chunk

    def overflowing(cfg, max_memory_mb, device):
        chunk = real(cfg, max_memory_mb, device)
        cfg.dev_block_cache_mb = small
        return chunk

    engine.configure_chunk = overflowing
    try:
        wall, st, _, launches, _ = _inproc(
            args + ["-out", os.path.join(tmp, "ooc_reread")],
            "-max-memory with the block cache overflowing", record=())
    finally:
        engine.configure_chunk = real
    if float(st["ooc_block_cache_mb"]) != 0:
        raise AssertionError(f"the overflowing cache served the later "
                             f"passes (ooc_block_cache_mb "
                             f"{st['ooc_block_cache_mb']})")
    if st["ooc_passes"] != cached["ooc_passes"]:
        raise AssertionError(f"{st['ooc_passes']} passes re-reading, "
                             f"{cached['ooc_passes']} from the cache")
    if int(st["device_peak_mb"]) > mb:
        raise AssertionError(f"peak device memory {st['device_peak_mb']} "
                             f"MiB > -max-memory {mb}")
    if launches["extract_insert_ranged"] <= 0:
        raise AssertionError("K1 did not launch in range mode")
    _require_launched(launches, OOC_PATH, "multi-pass (re-read)")
    if _read(os.path.join(tmp, "ooc_reread.unitigs.fa")) != _read(resident_path):
        raise AssertionError("the re-reading multi-pass FASTA differs from "
                             "the resident run's")
    say(f"[ooc] cache overflowing at {small} MB (cli.main, 3b's arguments): "
        f"ooc_block_cache_mb 0 (passes 2-{st['ooc_passes']} re-read the "
        f"input), pass times {_literal(st['timing'])['passes']} s against "
        f"{_literal(cached['timing'])['passes']} s from the cache, t_count_s "
        f"{st['t_count_s']} against {cached['t_count_s']}, wall {wall:.2f}s "
        f"against {cached['wall_s']:.2f}s; K1 {launches['extract_insert_ranged']} "
        f"in range mode; device_peak_mb {st['device_peak_mb']} <= {mb}; "
        f"FASTA byte-identical to phase 3's")


def _literal(text: str):
    """A python literal the CLI printed (a stat's dict or list)."""
    import ast

    return ast.literal_eval(text)


def _poll(path: str, text: str, proc, timeout: float) -> float:
    """Seconds until `text` shows in the file at path; raises if proc
    ends or the time runs out first."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if os.path.exists(path) and text in open(path).read():
            return time.time() - t0
        if proc.poll() is not None:
            raise RuntimeError(f"the server exited {proc.returncode} before "
                               f"'{text}'")
        time.sleep(0.02)
    raise AssertionError(f"no '{text}' within {timeout}s")


def _client(tmp: str, args):
    """`python -m bcalm_tpu_torch -connect srv.sock ...` once, a user's
    client: (wall from its spawn, exit code, stdout)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "bcalm_tpu_torch", "-connect", "srv.sock",
         *args], cwd=tmp, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=repo), timeout=600)
    return time.time() - t0, proc.returncode, proc.stdout


def _shutdown(sock: str) -> bytes:
    import socket

    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.connect(sock)
        c.sendall(b'{"op": "shutdown"}\n')
        return c.recv(1 << 10)


def phase_server(tmp: str, full, ooc) -> None:
    """Phase 3i: the keep-alive server.  `python -m bcalm_tpu_torch -server`
    (a relative socket path in tmp, so no path limit binds), timed from
    its spawn to its listening line; phase 3's arguments sent three times
    and 3b's once through `python -m bcalm_tpu_torch -connect`, each
    answer phase 3's bytes with the in-process run's device_peak_mb, a
    gzip cut short under 3b's M (rc 1: it fails after its first chunks
    were counted on the card) between the second and the third; a missing
    input answered rc 1; a shutdown ending the server with rc 0.
    Each client's wall (its start included) beside phase 3's fresh
    `python -m` wall, and the server's memory_reserved after each request
    (its log)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    args3, path3, stats3 = full
    args3b, _, stats3b = ooc
    want = _read(path3)
    out_log, err_log = (os.path.join(tmp, "srv.out"),
                        os.path.join(tmp, "srv.err"))
    t0 = time.time()
    with open(out_log, "w") as out, open(err_log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "bcalm_tpu_torch", "-server", "srv.sock"],
            cwd=tmp, stdout=out, stderr=err,
            env=dict(os.environ, PYTHONPATH=repo))
    try:
        up = _poll(out_log, "listening on srv.sock", proc, 300)
        log = open(err_log).read()
        if "ready" not in log:
            raise AssertionError(f"the server listened before it was ready:"
                                 f"\n{log}")
        say(f"[server] python -m bcalm_tpu_torch -server: listening "
            f"{up:.2f}s after its spawn; {log.strip().splitlines()[-1]}")
        # a request that fails mid-build: a gzip cut short, under 3b's M,
        # whose first 16 MB of reads fill and count 3b's 2^20-slot chunk
        # (K1, K2) a dozen times before the reader's EOFError
        import gzip

        cut = os.path.join(tmp, "cut.fa.gz")
        with open(args3[1], "rb") as f:
            packed = gzip.compress(f.read(48 << 20), compresslevel=1)
        with open(cut, "wb") as f:
            f.write(packed[: len(packed) * 3 // 4])
        rows = []
        plan = [(args3, stats3)] * 2 + [None] + [(args3, stats3),
                                                (args3b, stats3b)]
        for i, req in enumerate(plan):
            prefix = os.path.join(tmp, f"srv{i}")
            if req is None:
                wall, rc, text = _client(tmp, ["-in", cut, "-kmer-size",
                                               str(K), "-max-memory",
                                               str(stats3b["max_memory"]),
                                               "-out", prefix])
                if rc != 1 or "EOFError" not in text:
                    raise AssertionError(f"the cut gzip answered rc {rc}:"
                                         f"\n{text}")
                rows.append(f"a gzip cut short: rc 1 after {wall:.2f}s "
                            f"({text.strip().splitlines()[-1][:120]})")
                continue
            args, st_in = req
            wall, rc, text = _client(tmp, args + ["-out", prefix])
            st = _stats(text)
            if rc != 0:
                raise AssertionError(f"server request {i + 1} exited {rc}:"
                                     f"\n{text}")
            if _read(prefix + ".unitigs.fa") != want:
                raise AssertionError(f"server request {i + 1}: FASTA differs "
                                     f"from phase 3's")
            if st["device_peak_mb"] != st_in["device_peak_mb"]:
                raise AssertionError(
                    f"server request {i + 1}: device_peak_mb "
                    f"{st['device_peak_mb']}, in process "
                    f"{st_in['device_peak_mb']}")
            ooc = args is args3b
            rows.append(f"{'3b' if ooc else '3'}: client wall "
                        f"{wall:.2f}s (fresh python -m "
                        f"{st_in['sub_wall_s']:.2f}s), time:build "
                        f"{st['time:build']}, t_count_s {st['t_count_s']}, "
                        f"device_peak_mb {st['device_peak_mb']}"
                        + (f", ooc_passes {st['ooc_passes']}, pass times "
                           f"{_literal(st['timing'])['passes']} s"
                           if ooc else ""))
        say("[server] requests (each build's FASTA phase 3's bytes, its "
            "device_peak_mb the in-process run's): " + "; ".join(rows))
        wall, rc, text = _client(tmp, ["-in", os.path.join(tmp, "nope.fa")])
        if rc != 1:
            raise AssertionError(f"a missing input answered rc {rc}")
        reply = _shutdown(os.path.join(tmp, "srv.sock"))
        rc = proc.wait(timeout=120)
        if rc != 0 or reply != b'{"rc": 0, "output": "bye"}\n':
            raise AssertionError(f"shutdown: reply {reply!r}, exit {rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    served = [line for line in open(err_log).read().splitlines()
              if line.startswith("bcalm-tpu server: request")]
    say(f"[server] missing input: rc 1 (client wall {wall:.2f}s); shutdown: "
        f"rc 0, server up {time.time() - t0:.2f}s; its log: "
        + " | ".join(served))


def phase_respawn(tmp: str, ref_path: str, ooc) -> None:
    """Phase 3j: the compaction-OOM respawn.  3b's build in a child process
    that first caps its allocator (torch.cuda.set_per_process_memory_fraction)
    between 3b's counting peak and its whole build's peak: the count
    fits, compaction raises torch.OutOfMemoryError after the store's
    checkpoint, and the CLI re-runs itself with -skip-bcalm in a fresh
    process without the cap, on the card, which writes phase 3's bytes."""
    repo = os.path.dirname(os.path.abspath(__file__))
    args, _, st = ooc
    count_peak = int(st["device_count_peak_mb"])
    peak = int(st["device_peak_mb"])
    if peak - count_peak < 256:
        raise AssertionError(f"3b's counting peak {count_peak} MiB and its "
                             f"build's peak {peak} MiB leave no room for a "
                             f"cap between them")
    total = torch.cuda.get_device_properties(0).total_memory
    cap_mb = (count_peak + peak) // 2
    frac = (cap_mb << 20) / total
    prefix = os.path.join(tmp, "respawn")
    child = ("import sys, torch\n"
             f"torch.cuda.set_per_process_memory_fraction({frac!r})\n"
             "from bcalm_tpu_torch import cli\n"
             "sys.exit(cli.main(sys.argv[1:]))\n")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", child, *args, "-out", prefix],
                          cwd=repo, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=repo), timeout=900)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the capped build exited {proc.returncode}:\n"
                             f"{proc.stderr}")
    if ("(OutOfMemoryError)" not in proc.stderr
            or "restarting compaction in a fresh process" not in proc.stderr):
        raise AssertionError(f"no compaction OOM and respawn:\n{proc.stderr}")
    if _read(prefix + ".unitigs.fa") != _read(ref_path):
        raise AssertionError("the respawned build's FASTA differs from "
                             "phase 3's")
    if "(cuda)" not in proc.stdout or os.path.exists(prefix + "_btpu"):
        raise AssertionError("the respawned child did not finish on the card")
    child_st = _stats(proc.stdout)
    say(f"[respawn] 3b's arguments with the allocator capped at {cap_mb} MiB "
        f"(fraction {frac:.5f} of the card) between 3b's counting peak "
        f"{count_peak} MiB and its build's peak {peak} MiB: compaction "
        f"raised torch.OutOfMemoryError, the CLI re-ran itself with "
        f"-skip-bcalm in a fresh process (t_compact_s "
        f"{child_st['t_compact_s']}, device_peak_mb "
        f"{child_st['device_peak_mb']}) that wrote phase 3's bytes; wall "
        f"{wall:.2f}s, both processes' starts included")


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
    # in process, on phase 3's FASTA with its links stripped: the links
    # come back byte for byte, joined on the card
    with open(rl + ".unitigs.fa", "w") as f:
        f.write("\n".join(" ".join(t for t in line.split(" ")
                                   if not t.startswith("L:"))
                          for line in ref.decode().splitlines()) + "\n")
    wall_in, _, _, launches, _ = _inproc(
        ["-in", rl, "-redo-links", "-kmer-size", str(K), "-out", rl],
        "-redo-links")
    if _read(rl + ".unitigs.fa") != ref:
        raise AssertionError("-redo-links did not restore phase 3's links")
    _require_launched(launches, LINKS, "-redo-links")
    say(f"[resume] -redo-links on phase 3's FASTA: wall {wall:.2f}s, "
        f"byte-identical; on it without links, in process: {wall_in:.2f}s, "
        f"the links restored (K22 {launches['link_ends']}, K23 "
        f"{launches['link_pairs']} launches)")


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
    return (M, launches, inputs, tables[0],
            st.get("device_peak_mb", "not measured"))


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
    from bcalm_tpu_torch.parallel import distcompact, launch, pipeline

    mesh = launch.init_group(1, 0, "cuda",
                             "file://" + os.path.join(tmp, "nccl_group"))
    try:
        bank = bank_mod.Bank.open(fa)
        cfg = engine.EngineConfig(k=K, abundance_min=2)
        engine.configure_chunk(cfg, 0, dev)
        cli.adapt_max_len(bank, cfg)
        timing = {}
        # the glue's calls (their shard and capacities: scalars, no copy)
        glue_calls, glue_shard = [], distcompact.glue_shard

        def noted(mesh, succ_l, *caps):
            glue_calls.append(caps)
            return glue_shard(mesh, succ_l, *caps)

        recorded = tuple(n for n in tuple(KERNELS) + GLOBAL_K3
                         if n not in REPLAYED)
        distcompact.glue_shard = noted
        try:
            with Recorder(_kernels, recorded) as rec:
                _kernels.reset_launches()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.time()
                us = pipeline.distributed_build(
                    mesh, bank.sequences(), cfg,
                    pipeline.MinimizerConfig(m=10), timing=timing)
                torch.cuda.synchronize()
                wall = time.time() - t0
                launches = dict(_kernels.LAUNCHES)
        finally:
            distcompact.glue_shard = glue_shard
        check_mesh(tmp, ref_path, table, us, wall, timing, launches)
        # the replayed inputs, K16's whole glue round and K3's global step
        # need the group (phase 5 prints their rows)
        rec.inputs.update(replay_inputs(mesh, rec.inputs["junction_entries"],
                                        glue_calls, dev))
        _, glue_round_row = glue_rows(rec.inputs["glue_compose"], launches,
                                      dev, mesh)
        step_row = k3_step_row(rec.inputs["junction_entries"],
                               launches["junction_words"], dev, mesh)
        say(f"[mesh] K3's global step on phase 3f's shard "
            f"({step_row['slot_cap']} slots, {step_row['n_local']} k-mers, "
            f"{step_row['launches']} step(s) in the build): equal to the step "
            f"with every kernel's plain version; {step_row['ms']:.4f} ms, "
            f"plain {step_row['plain_ms']:.4f} ms (CUDA events), bound "
            f"{step_row['bound_ms']:.4f} ms; the sort took the "
            f"{step_row['n_sorted']} valid received entries, and the host "
            f"read of that count {step_row['host_read_ms']:.4f} ms wall "
            f"(waiting for the queued work); its two exchanges: "
            f"{exchange_text(step_row['exchanges'])}")
        say(f"[mesh] K16's whole glue round on its first round's state "
            f"({glue_round_row['rows']} rows, {glue_round_row['need_step']} "
            f"need a step, {glue_round_row['moved']} move): equal to the "
            f"round with plain K15 and K16; {glue_round_row['ms']:.4f} ms, "
            f"plain {glue_round_row['plain_ms']:.4f} ms (CUDA events), bound "
            f"{glue_round_row['bound_ms']:.4f} ms; its exchange: "
            f"{exchange_text(glue_round_row['exchanges'])}")
        ranged_launches = phase_mesh_ranged(tmp, fa, mesh, dev)
        entry_launches, entry_route, entry_solid = phase_entry_points(
            tmp, fa, mesh, dev)
    finally:
        dist.destroy_process_group()
    check_too_many_devices(tmp, fa)
    return launches, dict(rec.inputs, **{"route_buckets:hash": entry_route}), \
        entry_launches, entry_solid, ranged_launches, \
        [glue_round_row, step_row]


def replay_inputs(mesh, entries_args, glue_calls, dev) -> dict:
    """The first inputs that phase 3f's build gave each REPLAYED wrapper
    (K21 each mode apart), recorded after the build: its K3 global step
    again on the shard its junction_entries call was given, then its
    glue_shard calls again, with their shard and capacities, on that
    step's successor shard, until each of K21's modes has been called.
    Both are deterministic, so the calls are the build's."""
    from bcalm_tpu_torch.ops import _kernels
    from bcalm_tpu_torch.parallel import distcompact

    solid, n_local, k = entries_args[0].to(dev), entries_args[1], entries_args[2]
    slot_cap = solid.shape[1]
    with Recorder(_kernels, REPLAYED) as rec:
        succ, _ = distcompact.local_succ_shard(mesh, solid, n_local, k,
                                               4 * slot_cap, slot_cap)
        for caps in glue_calls:
            if all(f"glue_answer:{m}" in rec.inputs for m in GLUE_ANSWER):
                break
            distcompact.glue_shard(mesh, succ, *caps)
    missing = [m for m in GLUE_ANSWER if f"glue_answer:{m}" not in rec.inputs]
    if missing:
        raise AssertionError(f"phase 3f's glue, run again, called no K21 in "
                             f"mode(s) {missing}")
    return rec.inputs


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
    n_part = _first_reads(fa, part, 32)
    ref = os.path.join(tmp, "part_single")
    wall, ref_st = _inproc(["-in", part, "-kmer-size", str(K),
                            "-abundance-min", "2", "-verbose", "1", "-out", ref],
                           "1/32 of the reads")[:2]
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
    say(f"[mesh] multi-pass: the first {n_part} reads "
        f"({ref_st['distinct_kmers']} distinct k-mers, single-device build "
        f"{wall:.2f}s), residency budget {cfg.resident_kmers}: "
        f"{st['ooc_ranges']} key ranges, {st['ooc_passes']} passes, wall "
        f"{wall_mesh:.2f}s, split (s) {json.dumps(split)}; {len(got[0])} "
        f"unitigs, KC, km and {_links(path)} links equal the single-device "
        f"build's; range_fold launches {launches['range_fold']}, "
        f"device_peak_mb {st.get('device_peak_mb', 'not measured')}")
    say(f"[launches] {json.dumps(launches)}")
    return launches


def _first_reads(fa: str, path: str, div: int, read_len: int = 150) -> int:
    """Write the first 1/div of write_reads' file to path; the read count."""
    record = 3 + read_len + 1     # write_reads' fixed record
    with open(fa, "rb") as f:
        data = f.read((os.path.getsize(fa) // record // div) * record)
    with open(path, "wb") as f:
        f.write(data)
    return len(data) // record


def _same_unitigs(path: str, ref_path: str, what: str) -> None:
    got, want = unitig_keys(path), unitig_keys(ref_path)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: unitigs or KC differ from the "
                             f"single-device build's")
    if not np.array_equal(_km(path), _km(ref_path)):
        raise AssertionError(f"{what}: km differs")
    if _links(path) != _links(ref_path):
        raise AssertionError(f"{what}: link count differs")


def phase_entry_points(tmp: str, fa: str, mesh, dev):
    """Phase 3g: the per-k-mer mesh entry points at world size 1 on the
    first 1/8 of the reads, the launch counters reset just before them:
    pack_global_blocks -> distributed_count -> gather_solid, the per-k-mer
    minimizers of the solid set (mmer_histogram -> frequency_rank ->
    minimizers -> build_repartition -> partition_of, 4 partitions), then
    distributed_compact_pos with the first-occurrence keys of the
    single-device count of the same reads, and distributed_compact.  Both
    must give the single-device CLI's unitigs, KC, km and links, with
    nothing dropped.  Returns the launches, K15's hash-mode inputs and the
    number of solid k-mers K20 ran on."""
    from bcalm_tpu_torch import cli, engine
    from bcalm_tpu_torch.io import bank as bank_mod
    from bcalm_tpu_torch.io import fasta_writer
    from bcalm_tpu_torch.models import minimizer
    from bcalm_tpu_torch.ops import _kernels
    from bcalm_tpu_torch.parallel import distcompact, pipeline

    part = os.path.join(tmp, "reads_eighth.fa")
    n_part = _first_reads(fa, part, 8)
    ref = os.path.join(tmp, "eighth_single")
    wall_ref, ref_st = _inproc(["-in", part, "-kmer-size", str(K),
                                "-abundance-min", "2", "-verbose", "1", "-out",
                                ref], "1/8 of the reads")[:2]
    bank = bank_mod.Bank.open(part)
    cfg = engine.EngineConfig(k=K, abundance_min=2)
    engine.configure_chunk(cfg, 0, dev)
    cli.adapt_max_len(bank, cfg)
    s_solid, s_counts, minpos, _, _ = engine.count_and_filter(
        cli._input_blocks(bank, cfg, 0), cfg, dev)
    m = 10
    walls = {}
    _kernels.reset_launches()
    t0 = time.time()
    words, lengths = pipeline.pack_global_blocks(bank.sequences(), K, 1,
                                                 block_reads=4096, max_len=160)
    walls["pack"] = time.time() - t0
    t0 = time.time()
    cap = 1 << int(np.ceil(np.log2(int(np.maximum(lengths - K + 1, 0).sum()))))
    # K15's hash mode: its inputs, copied to the host, for phase 5
    with Recorder(_kernels, ("route_buckets",)) as rec:
        res = pipeline.distributed_count(mesh, words, lengths, K, cap)
    solid, counts = pipeline.gather_solid(res, 2, 2**31 - 1)
    walls["count"] = time.time() - t0
    t0 = time.time()
    lanes = torch.from_numpy(np.ascontiguousarray(solid, dtype=np.int64)).to(dev)
    n = lanes.shape[1]
    histo = minimizer.mmer_histogram(
        lanes, torch.ones((n,), dtype=torch.bool, device=dev), K, m)
    rank = minimizer.frequency_rank(histo.cpu().numpy())
    rank_t = torch.from_numpy(rank.astype(np.int64)).to(dev)
    load = np.bincount(minimizer.minimizers(lanes, K, m, rank_t).cpu().numpy(),
                       minlength=4 ** m)
    table = minimizer.build_repartition(load.astype(np.int32), 4)
    parts = minimizer.partition_of(lanes, K, m,
                                   torch.from_numpy(table.astype(np.int64)).to(dev),
                                   rank_t).cpu().numpy()
    walls["minimizers"] = time.time() - t0
    del lanes
    t0 = time.time()
    us_pos = distcompact.distributed_compact_pos(mesh, [solid], [counts],
                                                 [minpos], K)
    torch.cuda.synchronize()
    walls["compact_pos"] = time.time() - t0
    t0 = time.time()
    us_zero = distcompact.distributed_compact(mesh, [solid], [counts], K)
    torch.cuda.synchronize()
    walls["compact"] = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    # after the launches are read: the count's exchange on its K15 send
    # buffer, and K15 with it, as _local_shard_count runs them (CUDA
    # events, under the group)
    route_args = _moved(rec.inputs["route_buckets:hash"], dev)
    send = _kernels.route_buckets(*route_args)[0]
    count_x = exchange_text(exchange_times(mesh, [(send, False)]))
    del send
    routed_x = _time_ms(lambda: mesh.exchange(
        _kernels.route_buckets(*route_args)[0], False), reps=5)
    del route_args
    _require_launched(launches, ENTRY_PATH, "per-k-mer mesh entry points")
    if res.dropped != 0:
        raise AssertionError(f"distributed_count dropped {res.dropped} k-mers")
    if not (np.array_equal(solid, s_solid) and np.array_equal(counts, s_counts)):
        raise AssertionError("gather_solid differs from the single-device count")
    if int(histo.sum()) != n * (K - m + 1):
        raise AssertionError("mmer_histogram does not count every m-mer")
    per_part = np.bincount(parts, minlength=4)
    if not np.array_equal(per_part, [load[table == d].sum() for d in range(4)]):
        raise AssertionError(f"partition_of: k-mers per partition {per_part} "
                             f"differ from the minimizer load the table packs")
    for what, us in (("distributed_compact_pos", us_pos),
                     ("distributed_compact", us_zero)):
        path = os.path.join(tmp, f"entry_{what}.unitigs.fa")
        with open(path, "w") as f:
            fasta_writer.write_fasta(us, f)
        _same_unitigs(path, ref + ".unitigs.fa", what)
    say(f"[entry] per-k-mer mesh entry points, NCCL world size 1, on the first "
        f"{n_part} reads (single-device cli.main {wall_ref:.2f}s, "
        f"{ref_st['unitigs']} unitigs): distributed_count over a "
        f"{tuple(words.shape)} block, cap {cap}, dropped 0, {n} solid k-mers "
        f"equal to the single-device count; minimizers m = {m}: k-mers per "
        f"partition {per_part.tolist()}; distributed_compact_pos "
        f"(glue_runs {us_pos.stats['glue_runs']}) and distributed_compact "
        f"(glue_runs {us_zero.stats['glue_runs']}) give the CLI's unitigs, KC, "
        f"km and {_links(ref + '.unitigs.fa')} links; walls (s) "
        f"{json.dumps({key: round(v, 3) for key, v in walls.items()})}")
    say(f"[exchange] phase 3g's count: {count_x}; K15 and Mesh.exchange "
        f"as the count runs them {routed_x:.4f} ms event (no sentinel pass "
        f"after: K15 fills the empty slots with it)")
    say(f"[launches] {json.dumps(launches)}")
    return launches, rec.inputs["route_buckets:hash"], n


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


# Run in a tree's root by phase_compare: the lane kernels that take 1-8
# lanes (K1, K3a, K5, K6, K9) at L = 2 (k = 31), K1 also at L = 10 and in
# range mode, K2 at phase 3's shape (2 x 2^25 sorted columns from 8,125,243
# distinct keys, 5% sentinel; with pos, and with weights too) beside
# torch.unique_consecutive on the packed keys (not the same function: no
# weights, no min pos), K3a also at L = 10 and 16 (5,595,027 and
# 1,175,295 random k-mers at k = 151 and 255), K13 and K15, on inputs
# made from a seed, as one JSON line: {"ms": CUDA-event time per call,
# "device_ms": device time per call, "ops": device operations per call
# (kernels, fills and copies the profiler saw), "host_ms": host time per
# call of enqueues without a synchronisation, split into "python" (checks,
# allocations and torch operations: the wrapper with its C functions
# replaced by no-ops), "ctypes" (each C call the wrapper makes, with
# arguments that make it return before it launches) and "launch" (the
# rest: the CUDA runtime's launch path)}.  K6 runs one bound (the
# multi-pass count's settle and split: P = 1) and 256 bounds (P = 256) in
# a sorted run of 2^22 keys of 62 bits; K9 the phase 3 shape (8,125,243
# distinct columns, 62.5% solid, width = n_solid).  Beside them their
# library calls (torch.searchsorted on packed keys, stacked[:, keep]).
# K13 runs on 1,024 reads of 150 bp (W = 10, k = 31, m = 10, rank and
# position channel) with a 1-rank and a 4-rank table; K15 on K13's own
# output (phase 3f's (5, 163,840) shape: skm_words, start as valid,
# owner) at 1, 4 and 8 destinations with slots, cap from
# superkmer_capacity, and in its hash mode on 2^24 2-lane slots, ~80%
# valid, at 1 and 4 ranks with cap = ceil(2 valid / n) (phase 3g's
# sizing).  K2, K3a at L = 10 and 16, K13, K15, K1 in range mode and the
# kernels of STEP_INPUTS are held bitwise against their plain versions.
# It calls only wrappers whose signatures have not changed since K20 was
# ported, K1's range mode only where the wrapper takes lo and hi, K17's
# bitmap only where it takes bits and K14 with the histogram it adds into
# only where it takes histo, so an older tree runs it as well.
# K3b's, K8's, K12a's, K17's, K18's, K10's, K19's and K11's inputs at the
# main paths' shapes, seeded, for KERNEL_AB and
# SPLIT (run in a tree's root, after `dev` is set): step_solid() is the
# solid table of a random genome's first 5,075,200 31-mers (phase 3's
# solid count), canonical, in genome order (reorder_by_pos keeps first
# occurrences in read order), padded to C = 2^23 columns with the
# sentinel; level_inputs() gives the input of K18 at level 0 of the
# hierarchical jump over chains of geometric length and K17's at the first
# round of each level: HIER_LEVELS gives phase 3's run graph (2^19 nodes,
# 2 x 148,391 valid, 2 x 71,928 chains) and the canonical order's (2^24
# nodes, 2 x 5,075,200 valid, as many chains); finish_inputs() K10's at
# FINISH_SHAPES; expand_inputs() K19's at every level of the same
# jumps (jump_graph()); spell_inputs() K11's at SPELL_SHAPES.
STEP_INPUTS = r"""
import numpy as np
import torch
from bcalm_tpu_torch.ops import _kernels, chains, junctions, runchains
from bcalm_tpu_torch.ops import sort as sort_op

HIER_LEVELS = ((1 << 19, 296782, 296782 / 143856),
               (1 << 24, 10150400, 10150400 / 143856))

def step_kmers(n, k):
    r = np.random.RandomState(11)
    codes = torch.from_numpy(r.randint(0, 4, n + k - 1).astype(np.int64)).to(dev)
    fwd = torch.zeros((n,), dtype=torch.int64, device=dev)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | codes[j:j + n]
        rc = rc | ((codes[j:j + n] ^ 2) << (2 * j))
    return fwd, torch.minimum(fwd, rc)

def step_solid(n=5075200, C=1 << 23, k=31):
    canon = step_kmers(n, k)[1]
    solid = torch.full((2, C), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    solid[0, :n] = canon >> 32
    solid[1, :n] = canon & 0xFFFFFFFF
    return solid, n, C

def step_pos(n=5075200, C=1 << 23, k=31, R=148391):
    # counts and first-occurrence keys for step_solid(): the genome cut at
    # random into R pieces, first seen in a random order of the pieces,
    # each read forward (the key's low bit: the canonical k-mer is the
    # reverse complement), so compact_solid_pos finds about R runs
    r = np.random.RandomState(13)
    fwd, canon = step_kmers(n, k)
    cut = np.zeros(n, np.int64)
    cut[1 + r.choice(n - 1, R - 1, replace=False)] = 1
    piece = np.cumsum(cut)
    start = np.flatnonzero(np.concatenate([[1], cut[1:]]))
    length = np.diff(np.concatenate([start, [n]]))
    order = r.permutation(R)
    first = np.zeros(R, np.int64)
    first[order] = np.concatenate([[0], np.cumsum(length[order])[:-1]])
    seen = torch.from_numpy(first[piece] + np.arange(n) - start[piece]).to(dev)
    minpos = torch.full((C,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    minpos[:n] = 2 * seen + (canon != fwd).long()
    counts = torch.zeros((C,), dtype=torch.int64, device=dev)
    counts[:n] = 2
    return counts, minpos

def run_succ(n=5075200, C=1 << 23, R=148391):
    # a successor array with phase 3's run structure: R runs over n solid
    # entries, cut at random; each run's tail links to a random run's head,
    # or reversed to its tail, or to nothing, and so does its head on the
    # minus strand
    r = np.random.RandomState(12)
    heads = np.sort(np.concatenate([[0], 1 + r.choice(n - 1, R - 1, replace=False)]))
    tails = np.concatenate([heads[1:] - 1, [n - 1]])
    def ends(own):
        pick, kind = r.randint(0, R, R), r.randint(0, 3, R)
        out = np.where(kind == 0, heads[pick], np.where(kind == 1, C + tails[pick], -1))
        return np.where(out == own + 1, -1, out)
    succ = np.full(2 * C, -1, np.int64)
    succ[:n] = np.arange(1, n + 1)
    succ[tails] = ends(tails)
    succ[C + 1:C + n] = C + np.arange(n - 1)
    succ[C + heads] = ends(C + heads)
    return torch.from_numpy(succ).to(dev), n, C

def jump_graph(M, n_valid, mean):
    # (pred, valid) of M nodes, n_valid of them in chains of geometric
    # length (mean), in a random order
    r = np.random.RandomState(M % 9973)
    nodes = r.permutation(M)[:n_valid]
    start = r.rand(n_valid) < 1.0 / mean
    start[0] = True
    pred = np.full(M, -1, np.int64)
    pred[nodes] = np.where(start, -1, np.roll(nodes, 1))
    valid = np.zeros(M, bool)
    valid[nodes] = True
    return torch.from_numpy(pred).to(dev), torch.from_numpy(valid).to(dev)

def level_inputs(M, n_valid, mean):
    # (K18's input at level 0, [K17's input at the first round of each
    # level: (Q, gid, valid, salt), gid as the tree passes it])
    seen, rounds = [], []
    real, real_phase = chains.hier_contract, chains._phase
    keep = lambda a: tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)
    def record(*a):
        if not seen:
            seen.append(keep(a[:6]))
        return real(*a)
    def record_phase(Q, gid, valid, salt, *a, **kw):
        if salt is not None:
            rounds.append(keep((Q, gid, valid, salt)))
        return real_phase(Q, gid, valid, salt, *a, **kw)
    chains.hier_contract, chains._phase = record, record_phase
    try:
        chains.hier_jump(*jump_graph(M, n_valid, mean))
    finally:
        chains.hier_contract, chains._phase = real, real_phase
    return seen[0], rounds

def expand_inputs(M, n_valid, mean):
    # K19's inputs (F, parent, Qd, did) at each level of the hierarchical
    # jump over jump_graph(), level 0 first, recorded through
    # chains.hier_expand (so a tree of either K19 interface runs it)
    seen, real = [], chains.hier_expand
    def record(*a, **kw):
        seen.append(tuple(x.clone() for x in a[:4]))
        return real(*a, **kw)
    chains.hier_expand = record
    try:
        chains.hier_jump(*jump_graph(M, n_valid, mean))
    finally:
        chains.hier_expand = real
    return seen[::-1]

def glue_inputs(R=148391, rc=1 << 21, mean=296782 / 143856, qcap=1 << 24):
    # phase 3f's sharded doubling at world size 1: 2 rc rows, the first R
    # of each strand valid, in chains of geometric length (mean) in a
    # random order, weights 1-40, and its first round's response as one
    # owner gives it (a query's slot is its rank among the rows that need
    # a step; the other columns zero): (Q, cvalid, need, back, slots)
    r = np.random.RandomState(16)
    M = 2 * rc
    nodes = r.permutation(np.concatenate([np.arange(R), rc + np.arange(R)]))
    start = r.rand(2 * R) < 1.0 / mean
    start[0] = True
    pred = np.full(M, -1, np.int64)
    pred[nodes] = np.where(start, -1, np.roll(nodes, 1))
    valid = np.zeros(M, bool)
    valid[nodes] = True
    pred, valid = torch.from_numpy(pred).to(dev), torch.from_numpy(valid).to(dev)
    Q = chains.init_state(pred, valid, torch.from_numpy(r.randint(1, 41, M)).to(dev))
    need = valid & ((Q[:, 1] & chains._F_ROOTED) == 0)
    slots = torch.where(need, torch.cumsum(need.long(), 0) - 1, qcap)
    back = torch.zeros((4, qcap), dtype=torch.int64, device=dev)
    back[:, slots[need]] = Q[Q[need, 0]].t()
    return Q, valid, need, back, slots

# K11's inputs: n solid k-mers (random lanes, C columns) cut at random into
# U unitigs, each walking its columns forward or backward, each k-mer a
# member on a random strand (its canonical form's, as in the locality
# order), ranks 0 .. length-1 along the walk, uid in the order of the
# start ids as chain_finish numbers them.
# SPELL_SHAPES: phase 3's (k = 31) and phase 3h's (k = 151 and 255)
SPELL_SHAPES = ((31, 5075200, 1 << 23, 71928), (151, 5595027, 1 << 23, 31018),
                (255, 1175295, 1 << 21, 33707))

def spell_inputs(k, n, C, U):
    r = np.random.RandomState(k)
    L = (k + 15) // 16
    solid = np.full((L, C), 0xFFFFFFFF, np.int64)
    solid[:, :n] = r.randint(0, 1 << 32, (L, n), dtype=np.uint64).astype(np.int64)
    solid[0, :n] &= (1 << (2 * (k % 16 or 16))) - 1
    cut = np.sort(1 + r.choice(n - 1, U - 1, replace=False))
    s, e = np.concatenate([[0], cut]), np.concatenate([cut, [n]])
    # each unitig walks its columns forward or backward; each k-mer is a
    # member on a random strand (its canonical form's)
    back = r.rand(U) < 0.5
    piece = np.repeat(np.arange(U), e - s)
    col = np.arange(n)
    rk = np.where(back[piece], e[piece] - 1 - col, col - s[piece])
    o = col + C * (r.rand(n) < 0.5)
    so = np.zeros(U, np.int64)
    so[piece[rk == 0]] = o[rk == 0]
    uid_of = np.empty(U, np.int64)
    uid_of[np.argsort(so, kind="stable")] = np.arange(U)
    uid, rank = np.full(2 * C, -1, np.int64), np.zeros(2 * C, np.int64)
    uid[o] = uid_of[piece]
    rank[o] = rk
    length, start_oid = np.zeros(2 * C, np.int64), np.zeros(2 * C, np.int64)
    length[uid_of], start_oid[uid_of] = e - s, so
    counts = np.zeros(C, np.int64)
    counts[:n] = r.randint(2, 60, n)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(solid), t(counts), t(uid), t(rank), t(length), t(start_oid), U,
            k, n)

# K10's inputs at M oriented nodes: n_valid / 2 vertices in chains of
# geometric length (mean), each vertex in a random orientation, a fifth of
# the chains of two or more closed into cycles, every edge with its mirror
# edge; weighted (wlen, dist0) as the run graph's jump feeds it; the state
# converged by the plain doubling.  FINISH_SHAPES: phase 3's run graph
# (weighted) and the canonical order's (not)
FINISH_SHAPES = ((1 << 19, 296782, 296782 / 143856, True),
                 (1 << 24, 10150400, 10150400 / 143856, False))

def finish_inputs(M, n_valid, mean, weighted):
    r = np.random.RandomState(M % 9973 + 1)
    N, nv = M // 2, n_valid // 2
    order = r.permutation(N)[:nv]
    oid = order + N * r.randint(0, 2, nv)
    start = r.rand(nv) < 1.0 / mean
    start[0] = True
    first = np.flatnonzero(start)
    last = np.concatenate([first[1:] - 1, [nv - 1]])
    ring = (last > first) & (r.rand(first.size) < 0.2)
    link = ~start[1:]
    a = np.concatenate([oid[:-1][link], oid[last[ring]]])
    b = np.concatenate([oid[1:][link], oid[first[ring]]])
    succ = np.full(M, -1, np.int64)
    succ[a] = b
    succ[(b + N) % M] = (a + N) % M
    valid = np.zeros(M, bool)
    valid[order] = True
    valid[order + N] = True
    succ, valid = torch.from_numpy(succ).to(dev), torch.from_numpy(valid).to(dev)
    pred = chains.build_pred(succ, valid)
    wlen = dist0 = None
    if weighted:
        wlen = torch.from_numpy(np.tile(r.randint(1, 60, N), 2)).to(dev)
        dist0 = wlen[torch.clamp(pred, 0, M - 1)]
    return succ, pred, valid, chains.plain_jumpF(pred, valid, dist0), wlen

# K20's inputs: phase 3's solid k-mers (step_kmers()' canonical 31-mers,
# sorted as a count table holds them) and 2^20 sorted random 151-mers
# (phase 5's L = 10 slice), m = 10, each with the frequency rank of its
# m-mer histogram and the 4-way table of its minimizer load (phase 3g's
# chain); k20_calls() gives each mode's kernel and plain calls
def k20_inputs():
    from bcalm_tpu_torch.models import minimizer as mz
    canon = torch.sort(step_kmers(5075200, 31)[1])[0]
    r = np.random.RandomState(10)
    l10 = r.randint(0, 2**32, size=(10, 1 << 20), dtype=np.uint64)
    l10[0] &= (1 << 14) - 1
    l10 = np.ascontiguousarray(l10[:, np.lexsort(l10[::-1])])
    out = []
    for lanes, k in ((torch.stack([canon >> 32, canon & 0xFFFFFFFF]).contiguous(), 31),
                     (torch.from_numpy(l10.astype(np.int64)).to(dev), 151)):
        allv = torch.ones(lanes.shape[1], dtype=torch.bool, device=dev)
        rank = mz.frequency_rank(mz.mmer_histogram_plain(lanes, allv, k, 10).cpu().numpy())
        rank = torch.from_numpy(rank.astype(np.int64)).to(dev)
        load = torch.bincount(mz.minimizers_plain(lanes, k, 10, rank), minlength=4 ** 10)
        table = mz.build_repartition(load.cpu().numpy().astype(np.int32), 4)
        out.append((lanes, k, 10, rank, torch.from_numpy(table.astype(np.int64)).to(dev)))
    return out

def k20_calls(lanes, k, m, rank, table):
    from bcalm_tpu_torch.models import minimizer as mz
    allv = torch.ones(lanes.shape[1], dtype=torch.bool, device=dev)
    return {"histogram": (lambda: _kernels.kmer_minimizers(lanes, k, m, valid=allv, histogram=True),
                          lambda: mz.mmer_histogram_plain(lanes, allv, k, m)),
            "partition": (lambda: _kernels.kmer_minimizers(lanes, k, m, rank=rank, table=table),
                          lambda: mz.partition_of_plain(lanes, k, m, table, rank)),
            "lexicographic": (lambda: _kernels.kmer_minimizers(lanes, k, m),
                              lambda: mz.minimizers_plain(lanes, k, m))}

# K14's inputs: the 8 sample rounds of a -devices build at world size 1
# (1024 reads of 150 bp each, W = 10) of a random genome, and the
# frequency rank of their m-mer histogram (k = 31, m = 10); k14_sampling()
# gives each mode's sampling as the tree's pipeline runs it: a tree whose
# K14 adds into the caller's histogram launches once over every round's
# rows; else once per round, each into its own zeroed histogram, added up
def k14_rounds():
    from bcalm_tpu_torch.io import packing
    from bcalm_tpu_torch.models import minimizer as mz
    from bcalm_tpu_torch.ops import superkmer
    r = np.random.RandomState(3)
    genome = r.randint(0, 4, 1_000_000)
    starts = r.randint(0, genome.size - 150, 8 * 1024)
    seqs = ["".join("ACGT"[c] for c in genome[s:s + 150]) for s in starts]
    rounds = [(torch.from_numpy(b.words.astype(np.int64)).to(dev),
               torch.from_numpy(b.lengths.astype(np.int64)).to(dev))
              for b in packing.iter_blocks(seqs, 31, block_reads=1024, max_len=160)]
    h = sum(superkmer.sample_cmmer_histogram_plain(w, l, 31, 10) for w, l in rounds)
    rank = mz.frequency_rank(h.cpu().numpy())
    return rounds, torch.from_numpy(rank.astype(np.int64)).to(dev)

def k14_sampling(rounds, rank):
    import inspect
    from bcalm_tpu_torch.ops import superkmer
    cat_w = torch.cat([w for w, _ in rounds])
    cat_l = torch.cat([l for _, l in rounds])
    adds_into = "histo" in inspect.signature(_kernels.mmer_histograms).parameters
    calls = {}
    for mode, load, rk in (("mmer", False, None), ("load", True, rank)):
        def sampling(load=load, rk=rk):
            h = torch.zeros((4 ** 10,), dtype=torch.int64, device=dev)
            if adds_into:
                return _kernels.mmer_histograms(cat_w, cat_l, 31, 10, rk, load, h)
            for w, l in rounds:
                h += _kernels.mmer_histograms(w, l, 31, 10, rk, load)
            return h
        plain = (lambda rk=rk: superkmer.sample_minimizer_load_plain(cat_w, cat_l, 31, 10, rk, True)
                 if rk is not None else
                 superkmer.sample_cmmer_histogram_plain(cat_w, cat_l, 31, 10))
        calls[mode] = (sampling, plain)
    return calls

def digest_of(t):
    w = torch.arange(t.numel(), device=t.device) % 997
    return [int(t.sum()), int((t * w).sum())]
"""


# Run in a tree's root (`python3 -c "import chip_smoke;
# exec(chip_smoke.SPLIT, {})"`): the split of the K3b step and of K18 by
# device operation (torch.profiler: device ms and calls per step), with
# each piece's CUDA-event ms and K18's host time per call (its enqueue,
# no synchronisation); then K8 and K12a on the successor arrays of
# step_solid() and run_succ() (device ms per operation, with R and
# R_cap); K17 at canonical levels 0 and 1 and phase 3's level 0 (the
# level's fixpoint bitmap and a round given it), K10 at phase 3's M
# and at 2^24, K19 at the same levels as K17 and K11 at SPELL_SHAPES, by
# device operation.  Prints one JSON line.
SPLIT = r"""
import inspect, json, sys, time
import torch
sys.path.insert(0, ".")
dev = torch.device("cuda", 0)
""" + STEP_INPUTS + r"""
def time_ms(fn, reps=20):
    fn(); fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

def breakdown(fn, reps=20):
    fn(); torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            d = out.setdefault(e.name[:72], [0.0, 0.0])
            d[0] += e.device_time_total / 1e3 / reps
            d[1] += 1 / reps
    return out

def host_ms(fn, reps=50):
    fn(); torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t

out = {}
# a tree before exact keys past 3 lanes takes K3b's `hashed` flag
JP_HASHED = (False,) if "hashed" in inspect.signature(_kernels.junction_pairs).parameters else ()
solid, n, C = step_solid()
keys, pay = junctions.junction_keys(solid, n, 31)
rows = [keys[r] for r in range(keys.shape[0])]
perm, word = sort_op.lex_sort(rows)
pieces = {"sort": lambda: sort_op.lex_sort(rows),
          "junction_pairs": lambda: _kernels.junction_pairs(word, perm, pay, C, 2, *JP_HASHED),
          "successor_arrays": lambda: junctions.successor_arrays(solid, n, 31)}
out.update({"entries": 2 * C, "heads_and_edges": None, "pieces": {}})
for name, fn in pieces.items():
    out["pieces"][name] = {"ms": time_ms(fn), "device": breakdown(fn)}
succ = pieces["junction_pairs"]()
out["heads_and_edges"] = [int((succ >= 0).sum())]
# K8 and K12a at phase 3's shape on the random genome's own successor
# array and on phase 3's run structure
for label, (succ_r, n_r, C_r) in (
        ("step", (junctions.successor_arrays(solid, n, 31), n, C)),
        ("phase-3 runs", run_succ())):
    scan = _kernels.run_scans(succ_r, n_r, C_r)
    R = int(scan[5])
    R_cap = runchains.round_capacity(R)
    k8 = lambda: _kernels.run_scans(succ_r, n_r, C_r)
    k12 = lambda: _kernels.run_contract(succ_r, scan[0], scan[2], scan[4], R, R_cap)
    out["run_scans " + label] = {"n_solid": n_r, "C": C_r, "R": R, "R_cap": R_cap,
                                 "ms": time_ms(k8), "device": breakdown(k8)}
    out["run_contract " + label] = {"ms": time_ms(k12), "device": breakdown(k12)}
    del succ_r, scan
del succ, keys, pay, rows, solid
out["hier_contract"] = {}
for M, n_valid, mean in HIER_LEVELS:
    hargs = level_inputs(M, n_valid, mean)[0]
    ok = torch.ones((1,), dtype=torch.int32, device=dev)
    fn = lambda: _kernels.hier_contract(*hargs, ok)
    n_c = int(fn()[5])
    out["hier_contract"][str(M)] = {"S1": hargs[4], "n_c": n_c, "ms": time_ms(fn),
                                    "host_ms": host_ms(fn), "device": breakdown(fn)}
# K17 at the first round of canonical levels 0 and 1 (2^24 and 2^22
# rows) and of level 0 of phase 3's run graph (2^19): the level's bitmap
# and a round given it
out["hier_round"] = {}
for M, n_valid, mean in HIER_LEVELS:
    rounds = level_inputs(M, n_valid, mean)[1]
    for li, (Q, gid, valid, salt) in enumerate(rounds[:2 if M > 1 << 19 else 1]):
        Qn = torch.empty_like(Q)
        bits_fn = lambda: _kernels.fixpoint_bits(gid, valid, salt)
        bits = bits_fn()
        round_fn = lambda: _kernels.hier_round(Q, Qn, gid, bits)
        out["hier_round"][f"{M} level {li}"] = {
            "S": Q.shape[0], "rooted": int(((Q[:, 1] >> 30) & 1).sum()),
            "fixpoint_bits": {"ms": time_ms(bits_fn), "device": breakdown(bits_fn)},
            "round": {"ms": time_ms(round_fn), "device": breakdown(round_fn)}}
        del Q, Qn, gid, valid, bits
    del rounds
# K10 at phase 3's M (weighted) and the canonical order's, by device
# operation, with its host time per call
out["chain_finish"] = {}
for M, n_valid, mean, weighted in FINISH_SHAPES:
    cf = finish_inputs(M, n_valid, mean, weighted)
    fn = lambda: _kernels.chain_finish(*cf)
    out["chain_finish"][str(M)] = {
        "weighted": weighted, "n_unitigs": int(fn()["n_unitigs"]),
        "ms": time_ms(fn), "host_ms": host_ms(fn), "device": breakdown(fn)}
    del cf
# K19 at canonical levels 0 and 1 and phase 3's level 0 (with the share of
# rows not ROOTED), K11 at SPELL_SHAPES, by device operation
out["hier_expand"], out["spell_unitigs"] = {}, {}
for M, n_valid, mean in HIER_LEVELS:
    for li, eargs in enumerate(expand_inputs(M, n_valid, mean)[:2 if M > 1 << 19 else 1]):
        Qd = eargs[2]
        scratch = torch.empty_like(Qd)
        # a copy of Qd, then the kernel over it (a tree whose K19 writes a
        # new output leaves the copy as it is)
        fn = lambda: _kernels.hier_expand(eargs[0], eargs[1], scratch.copy_(Qd),
                                          eargs[3])
        out["hier_expand"][f"{M} level {li}"] = {
            "S": Qd.shape[0], "S1": eargs[0].shape[0],
            "not_rooted": int((((Qd[:, 1] >> 30) & 1) == 0).sum()),
            "ms (the copy included)": time_ms(fn), "device": breakdown(fn)}
        del eargs, Qd, scratch
for kk, n_k, C_k, U_k in SPELL_SHAPES:
    sargs = spell_inputs(kk, n_k, C_k, U_k)
    fn = lambda: _kernels.spell_unitigs(*sargs)
    out["spell_unitigs"][f"k={kk}"] = {"n": n_k, "C": C_k, "U": U_k,
                                       "ms": time_ms(fn), "device": breakdown(fn)}
    del sargs
# K20's three modes (k20_inputs()) and K14's sampling of 8 rounds
# (k14_sampling()), by device operation, K14 with its host time per call
out["kmer_minimizers"], out["mmer_histograms"] = {}, {}
for lanes, kk, mk, rank_k, table_k in k20_inputs():
    for mode, (fn, _) in k20_calls(lanes, kk, mk, rank_k, table_k).items():
        out["kmer_minimizers"][f"{mode} L={lanes.shape[0]}"] = {
            "n": lanes.shape[1], "k": kk, "m": mk, "ms": time_ms(fn),
            "device": breakdown(fn)}
    del lanes, rank_k, table_k
rounds14, rank14 = k14_rounds()
for mode, (fn, _) in k14_sampling(rounds14, rank14).items():
    out["mmer_histograms"][f"sampling {mode}"] = {
        "rounds": len(rounds14), "rows": sum(w.shape[0] for w, _ in rounds14),
        "ms": time_ms(fn), "host_ms": host_ms(fn), "device": breakdown(fn)}
print(json.dumps(out))
"""


KERNEL_AB = r"""
import inspect, json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
from bcalm_tpu_torch import engine
from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels, count, extract, junctions, superkmer
from bcalm_tpu_torch.parallel import pipeline

def time_ms(fn, reps=50):
    fn(); fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy",
                "cudaMemset", "cuMemcpy", "cuMemset")

def device_ms(fn, reps=20, only=""):
    # (device time per call, device operations per call): every kernel,
    # fill and copy the profiler saw over reps calls whose name holds
    # `only`; the time None where it saw none, or where the profile lost
    # operations (not a whole number a call, or fewer than the launch
    # calls seen on the host)
    fn(); torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda]
    calls = sum(1 for e in prof.events()
                if e.device_type != cuda and e.name.startswith(LAUNCH_CALLS))
    mine = [e for e in evs if only in e.name]
    us = sum(e.device_time_total for e in mine)
    whole = len(evs) % reps == 0 and len(evs) >= calls
    return (us / 1e3 / reps if us and whole else None), len(mine) / reps

# the argument of each C function that makes it return before it launches
# (bt_route_count and bt_route_place: the two launches of the earlier K15)
EARLY = {"bt_route_count": 6, "bt_route_place": 6, "bt_route_buckets": 6,
         "bt_form_superkmers": 2, "bt_mmer_histograms": 2}

def host_ms(fn, reps=20):
    calls, saved = [], dict(_kernels._FNS)
    def spy(name):
        def call(*a):
            calls.append((name, a))
            return saved[name](*a)
        return call
    fn(); torch.cuda.synchronize()
    _kernels._FNS.update({n: spy(n) for n in saved})
    try:
        fn()
    finally:
        _kernels._FNS.update(saved)
    torch.cuda.synchronize()
    def per_call(f):
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        t = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        return t
    total = per_call(fn)
    _kernels._FNS.update({n: (lambda *a: 0) for n in saved})
    try:
        python = per_call(fn)
    finally:
        _kernels._FNS.update(saved)
    early = [(saved[n], a[:EARLY[n]] + (0,) + a[EARLY[n] + 1:]) for n, a in calls]
    ctypes_ms = per_call(lambda: [f(*a) for f, a in early])
    return {"total": total, "python": python, "ctypes": ctypes_ms,
            "launch": total - python - ctypes_ms, "c_calls": len(calls)}

def same(got, want, what):
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(what + " differs from its plain version")

dev = torch.device("cuda", 0)
rng = np.random.RandomState(0)
u32 = lambda *shape: torch.from_numpy(rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.int64)).to(dev)
k = 31
words, lengths = u32(4096, 10), torch.full((4096,), 150, dtype=torch.int64, device=dev)
buf = torch.empty((3, extract.block_slots(tuple(words.shape), k)), dtype=torch.int64, device=dev)
solid = u32(2, 1 << 22)
solid[0] &= (1 << 30) - 1
body = u32(3, 1 << 22)
lo = tuple(int(x) for x in body[:2, 7].tolist())
hi = tuple(int(x) for x in body[:2, 9].tolist())
lo, hi = min(lo, hi), max(lo, hi)
keys = torch.sort(torch.from_numpy(rng.randint(0, 2**62, size=1 << 22, dtype=np.int64)).to(dev))[0]
run = torch.stack([keys >> 32, keys & 0xFFFFFFFF]).contiguous()
bounds = {1: run[:, 1234567:1234568].contiguous(), 256: run[:, ::16384].contiguous()}
N = 8125243
uq = u32(2, N)
uq[0] &= (1 << 30) - 1
cq = torch.from_numpy(rng.geometric(0.375, N)).to(dev)
pq = torch.from_numpy(rng.randint(0, 2**31, N)).to(dev)
keep = cq >= 2
sc_args = (uq, cq, pq, N, 2, 2**31 - 1, int(keep.sum()))
stacked_in = torch.cat([uq, cq[None], pq[None]])
# K1 at L = 10 (k = 151 on 300 bp reads, phase 3h's block shape), and in
# range mode at L = 2 with bounds from the block's own keys; a tree whose
# K1 has no range mode runs the work the multi-pass count did there: K1,
# then K5 over the block's columns
w10 = torch.from_numpy(np.random.RandomState(10).randint(
    0, 2**32, size=(4096, 19), dtype=np.uint64).astype(np.int64)).to(dev)
l10 = torch.full((4096,), 300, dtype=torch.int64, device=dev)
buf10 = torch.empty((11, extract.block_slots(tuple(w10.shape), 151)), dtype=torch.int64, device=dev)
ref = torch.empty_like(buf)
extract.extract_insert_plain(ref, words, lengths, k, 0, 0)
live = ref[:2, ref[2] != 0xFFFFFFFF]
klo, khi = sorted(tuple(int(x) for x in live[:, j].tolist())
                  for j in (live.shape[1] // 3, 2 * live.shape[1] // 3))
if "lo" in inspect.signature(_kernels.extract_insert).parameters:
    ranged = lambda: _kernels.extract_insert(buf, words, lengths, k, 0, 0, lo=klo, hi=khi)
else:
    ranged = lambda: (_kernels.extract_insert(buf, words, lengths, k, 0, 0),
                      _kernels.range_fold(buf, klo, khi))
count.range_fold_plain(ref, klo, khi)
ranged()
same([buf], [ref], "extract_insert in range mode")
fns = {
    "extract_insert": (lambda: _kernels.extract_insert(buf, words, lengths, k, 0, 0), 50),
    "extract_insert L=10": (lambda: _kernels.extract_insert(buf10, w10, l10, 151, 0, 0), 20),
    "extract_insert ranged": (ranged, 50),
    "junction_keys": (lambda: _kernels.junction_keys(solid, 1 << 22, k, False, junctions.key_rows(k)), 50),
    "range_fold": (lambda: _kernels.range_fold(body, lo, hi), 50),
}
pr = ln.pack_keys(list(run))[0].contiguous()
for P, b in bounds.items():
    pb = ln.pack_keys(list(b))[0].contiguous()
    if not torch.equal(_kernels.lower_bound(run, 1 << 22, b), torch.searchsorted(pr, pb)):
        raise AssertionError("lower_bound differs from torch.searchsorted")
    fns[f"lower_bound P={P}"] = (lambda b=b: _kernels.lower_bound(run, 1 << 22, b), 20)
    fns[f"searchsorted P={P}"] = (lambda pr=pr, pb=pb: torch.searchsorted(pr, pb), 20)
if not torch.equal(_kernels.solid_compact(*sc_args)[0], stacked_in[:, keep]):
    raise AssertionError("solid_compact differs from stacked[:, keep]")
fns["solid_compact"] = (lambda: _kernels.solid_compact(*sc_args), 20)
fns["stacked[:, keep]"] = (lambda: stacked_in[:, keep], 20)
# K13 and K15 (with the host split)
m, rows = 10, 1024
ms_ = superkmer.default_max_span(k)
Wn, bits = superkmer.span_words(k, ms_), superkmer.span_field_bits(ms_)
kw = u32(rows, 10)
kl = torch.full((rows,), 150, dtype=torch.int64, device=dev)
rank = torch.from_numpy(rng.permutation(4 ** m).astype(np.int64)).to(dev)
split = {}
for n in (1, 4, 8):
    table = torch.from_numpy(rng.randint(0, n, 4 ** m).astype(np.int64)).to(dev)
    args = (kw, kl, k, m, table, rank, ms_, Wn, bits, True, 0xFFFFF000)
    got = _kernels.form_superkmers(*args)
    same(got, superkmer.form_superkmers_plain(kw, kl, k, m, table, rank, ms_, True,
                                              True, 0xFFFFF000), "form_superkmers")
    if n in (1, 4):
        fns[f"form_superkmers {n}-rank"] = (lambda args=args: _kernels.form_superkmers(*args), 20)
        split[f"form_superkmers {n}-rank"] = True
    sw, own, st = got[0], got[1], got[2]
    cap = pipeline.superkmer_capacity(rows, 160, k, m, n, ms_)
    rargs = (sw, st, own, n, cap, True)
    same(_kernels.route_buckets(*rargs), pipeline.route_to_buckets_plain(*rargs),
         "route_buckets")
    name = f"route_buckets 3f n={n}"
    fns[name] = (lambda rargs=rargs: _kernels.route_buckets(*rargs), 20)
    split[name] = True
hl = u32(2, 1 << 24)
hv = torch.from_numpy(rng.rand(1 << 24) < 0.8).to(dev)
n_valid = int(hv.sum())
for n in (1, 4):
    rargs = (hl, hv, None, n, -(-2 * n_valid // n), True)
    same(_kernels.route_buckets(*rargs), pipeline.route_to_buckets_plain(*rargs),
         "route_buckets hash mode")
    name = f"route_buckets hash n={n}"
    fns[name] = (lambda rargs=rargs: _kernels.route_buckets(*rargs), 20)
    split[name] = True
# K3a at L = 10 and 16 (phase 3h's solid table sizes at k = 151 and 255)
r2 = np.random.RandomState(2)
for L, kk, C in ((10, 151, 5595027), (16, 255, 1175295)):
    sl = torch.from_numpy(r2.randint(0, 2**32, size=(L, C), dtype=np.uint64).astype(np.int64)).to(dev)
    sl[0] &= (1 << (2 * (kk % 16 or 16))) - 1
    # past 3 lanes: the exact packed words, or in a tree before them the
    # three hash words (not the same work)
    long_flag = getattr(junctions, "packed_keys", None) or junctions.use_hash_keys
    kargs = (sl, C, kk, long_flag(kk), junctions.key_rows(kk))
    same(_kernels.junction_keys(*kargs), junctions.junction_keys_plain(sl, C, kk),
         f"junction_keys L={L}")
    fns[f"junction_keys L={L}"] = (lambda kargs=kargs: _kernels.junction_keys(*kargs), 20)
""" + STEP_INPUTS + r"""
# the count step after the sort (K2's part of count_canonical) at the
# main paths' shapes: in a tree whose K2 reads the sort's own output
# (count.count_sorted), that kernel on the sort's top word and perm, the
# lower packed words (past 2 lanes), weights and pos in entry order; else
# the gathers of the sorted lanes, weights and pos, then the earlier
# kernel.  Columns drawn from a pool of distinct keys (first lane below
# 2^30, as k = 31's), a share of them the sentinel, in a random order;
# pos a permutation.  Each held against its plain version, with digests;
# torch.unique_consecutive on phase 3's sorted word beside it is not the
# same function (no weights, no min pos)
K2_SHAPES = {  # name: (L, N, sentinel share, distinct keys, weighted)
    "count step phase 3 (2 x 2^25, pos)": (2, 1 << 25, 0.05, 8125243, False),
    "count step 3b chunk (2 x 2^20, pos)": (2, 1 << 20, 0.05, 8125243, False),
    "count step LSM merge (2 x 2^24, weighted, pos)": (2, 1 << 24, 0.0, 10 << 20, True),
    "count step 3h L=10 (10 x 2^24, pos)": (10, 1 << 24, 0.05, 5595027, False),
    "count step 3f round (2 x 1,338,852, pos)": (2, 1338852, 0.907, 8125243, False),
}
digest = {}
r3 = np.random.RandomState(3)
for name, (L, N, sent, pool, weighted) in K2_SHAPES.items():
    pv = torch.from_numpy(r3.randint(0, 2**32, size=(L, pool), dtype=np.uint64).astype(np.int64)).to(dev)
    pv[0] &= (1 << 30) - 1
    k2_lanes = pv[:, torch.from_numpy(r3.randint(0, pool, size=N)).to(dev)].contiguous()
    k2_lanes[:, torch.from_numpy(r3.choice(N, int(N * sent), replace=False)).to(dev)] = 0xFFFFFFFF
    k2_pos = torch.from_numpy(r3.permutation(N).astype(np.int64)).to(dev)
    k2_w = (torch.from_numpy(r3.randint(1, 9, size=N).astype(np.int64)).to(dev)
            if weighted else None)
    k2_keys = ln.pack_keys([k2_lanes[j] for j in range(L)])
    k2_perm, k2_top = sort_op.lex_sort_words(k2_keys)
    if hasattr(count, "count_sorted"):
        k2_args = (k2_top, k2_perm, torch.stack(k2_keys[1:]) if L > 2 else None, L,
                   k2_w, k2_pos)
        step = lambda a=k2_args: _kernels.count_sorted(*a)
        plain_step = lambda a=k2_args: count.count_sorted_plain(*a)
    else:
        def gathered(x=k2_lanes, p=k2_perm, w=k2_w, q=k2_pos):
            return x[:, p], None if w is None else w[p], q[p]
        step = lambda g=gathered: _kernels.count_runs(*g())
        plain_step = lambda g=gathered: count.count_runs_plain(*g())
    got = step()
    same(got, plain_step(), name)
    digest[name] = [digest_of(t.reshape(-1)) for t in got[:3]] + [int(got[3])]
    fns[name] = (step, 20 if L == 2 else 5)
    if name.startswith("count step phase 3"):
        k2_word = k2_top
    del got, k2_keys, pv
fns["unique_consecutive (not the same function: no weights, no min pos)"] = (
    lambda: torch.unique_consecutive(k2_word, return_counts=True), 20)
# the K3b step at phase 3's shape: in a tree whose pair kernel takes the
# sort's own output (sort.lex_sort), that kernel alone; else the two
# gathers of the sorted keys and payload, then the kernel.  K18 at level 0
# of phase 3's jump and of the canonical order's.  Each held against its
# plain version; `digest` (sums of the outputs) must agree across trees
solid_s, n_s, C_s = step_solid()
keys_s, pay_s = junctions.junction_keys(solid_s, n_s, 31)
rows_s = [keys_s[r] for r in range(keys_s.shape[0])]
JP_HASHED = (False,) if "hashed" in inspect.signature(_kernels.junction_pairs).parameters else ()
if hasattr(sort_op, "lex_sort"):
    perm_s, word_s = sort_op.lex_sort(rows_s)
    step = lambda: _kernels.junction_pairs(word_s, perm_s, pay_s, C_s, 2, *JP_HASHED)
    plain_step = lambda: junctions.junction_pairs_plain(word_s, perm_s, pay_s, C_s, 2, *JP_HASHED)
else:
    perm_s = sort_op.lex_argsort(rows_s)
    step = lambda: _kernels.junction_pairs(keys_s[:, perm_s].contiguous(), pay_s[perm_s], C_s, False)
    plain_step = lambda: junctions.junction_pairs_plain(keys_s[:, perm_s].contiguous(), pay_s[perm_s], C_s, False)
succ_s = step()
same([succ_s], [plain_step()], "junction_pairs step")
digest["junction_pairs step"] = [int(succ_s.sum()), int((succ_s >= 0).sum())]
fns["junction_pairs step"] = (step, 20)
del succ_s
# compact_solid_pos (reorder, successor arrays, K8, K12a, the jump, K10,
# K12b) on step_solid() with step_pos()'s first-occurrence keys
counts_s, minpos_s = step_pos()
got = engine.compact_solid_pos(solid_s, counts_s, minpos_s, n_s, 31)[2]
digest["compact_solid_pos"] = [int(got["n_unitigs"]), int(got["uid"].sum()),
                               int(got["rank"].sum())]
fns["compact_solid_pos"] = (lambda: engine.compact_solid_pos(solid_s, counts_s, minpos_s, n_s, 31), 5)
del got
# K8 and K12a at phase 3's shape: on step_solid()'s successor array (its
# canonical k-mers link only where both strands agree, so its runs are
# short) and on run_succ()'s, phase 3's run structure
for label, (succ_k, n_k, C_k) in (
        ("step", (junctions.successor_arrays(solid_s, n_s, 31), n_s, C_s)),
        ("phase-3 runs", run_succ())):
    scan = _kernels.run_scans(succ_k, n_k, C_k)
    same(scan, runchains.run_scans_plain(succ_k, n_k, C_k), "run_scans")
    R = int(scan[5])
    R_cap = runchains.round_capacity(R)
    cargs = (succ_k, scan[0], scan[2], scan[4], R, R_cap)
    got = _kernels.run_contract(*cargs)
    same(got, runchains.run_contract_plain(*cargs), "run_contract")
    digest["run_scans " + label] = [int(t.long().sum()) for t in scan]
    digest["run_contract " + label] = [int(t.long().sum()) for t in got]
    fns["run_scans " + label] = (lambda a=(succ_k, n_k, C_k): _kernels.run_scans(*a), 20)
    fns["run_contract " + label] = (lambda a=cargs: _kernels.run_contract(*a), 20)
    del got
# K17 at the first round of canonical levels 0 and 1 and of phase 3's
# level 0 (one round; a tree with the fixpoint bitmap also times the
# bitmap, built once per level, and is given it for the round), K18 at
# level 0 of both jumps, K10 at phase 3's M (weighted) and at the
# canonical order's M = 2^24 on finish_inputs()
has_bits = hasattr(_kernels, "fixpoint_bits")
for M, n_valid, mean in HIER_LEVELS:
    hargs, rounds = level_inputs(M, n_valid, mean)
    ok_h = torch.ones((1,), dtype=torch.int32, device=dev)
    got = _kernels.hier_contract(*hargs, ok_h)
    ok_p = torch.ones((1,), dtype=torch.int32, device=dev)
    same(got + (ok_h,), chains.hier_contract_plain(*hargs, ok_p) + (ok_p,), "hier_contract")
    name = f"hier_contract S={M}"
    digest[name] = [int(t.long().sum()) for t in got] + [int(ok_h)]
    fns[name] = (lambda hargs=hargs, ok_h=ok_h: _kernels.hier_contract(*hargs, ok_h), 20)
    del got
    for li, (Q, gid, valid, salt) in enumerate(rounds[:2 if M > 1 << 19 else 1]):
        Qn = torch.empty_like(Q)
        name = f"hier_round S={Q.shape[0]} (level {li} of {M})"
        if has_bits:
            make = lambda a=(gid, valid, salt): _kernels.fixpoint_bits(*a)
            bits = make()
            same([bits], [chains.fixpoint_bits_plain(gid, valid, salt)], "fixpoint_bits")
            fns[f"fixpoint_bits S={Q.shape[0]} (level {li} of {M})"] = (make, 20)
            step = lambda a=(Q, Qn, gid, bits): _kernels.hier_round(*a)
            want = chains.hier_round_plain(Q, gid, bits)
        else:
            step = lambda a=(Q, Qn, gid, valid, salt): _kernels.hier_round(*a)
            want = chains.hier_round_plain(Q, gid, valid, salt)
        step()
        same([Qn], [want], "hier_round")
        digest[name] = [int(Qn.sum()), int(Qn[:, 1].sum())]
        fns[name] = (step, 20)
    del rounds, Q, Qn, gid, valid, want
for M, n_valid, mean, weighted in FINISH_SHAPES:
    cf = finish_inputs(M, n_valid, mean, weighted)
    keys = ("uid", "rank", "n_unitigs", "start_oid", "length", "circular")
    got = _kernels.chain_finish(*cf)
    want = chains.finish_fast_plain(*cf)
    same([got[k] for k in keys], [want[k] for k in keys], "chain_finish")
    name = f"chain_finish M={M}"
    digest[name] = [int(got[k].long().sum()) for k in keys]
    fns[name] = (lambda cf=cf: _kernels.chain_finish(*cf), 20)
    del got, want
# K19 at canonical levels 0 and 1 and at phase 3's level 0, each call on
# a fresh copy of Qd (a tree whose K19 writes over Qd needs one; the other
# leaves it as it is): its time is the kernel's alone, the copy's event
# time taken out (copies) and its device operation not counted (only).
# K11 at SPELL_SHAPES
copies, only = {}, {}
for M, n_valid, mean in HIER_LEVELS:
    for li, eargs in enumerate(expand_inputs(M, n_valid, mean)[:2 if M > 1 << 19 else 1]):
        F_e, parent_e, Qd_e, did_e = eargs
        got = _kernels.hier_expand(F_e, parent_e, Qd_e.clone(), did_e)
        same([got], [chains.hier_expand_plain(*eargs)], "hier_expand")
        name = f"hier_expand S={Qd_e.shape[0]} (level {li} of {M})"
        digest[name] = [int(got.sum()), int(got[:, 1].sum())]
        scratch = torch.empty_like(Qd_e)
        copies[name] = lambda scratch=scratch, Qd_e=Qd_e: scratch.copy_(Qd_e)
        only[name] = "hier_expand"
        fns[name] = (lambda eargs=eargs, copy=copies[name]:
                     _kernels.hier_expand(eargs[0], eargs[1], copy(), eargs[3]), 20)
        del got, F_e, parent_e, Qd_e, did_e, scratch
# K4 at 2^19 and 2^24 (HIER_LEVELS' graphs, unweighted): one round from
# the initial state, and plain_jumpF to convergence (in a tree with the
# flag mode one host sync after the first round and then every
# chains._BATCH rounds, else one a round),
# each held against plain rounds.  K16 at phase 3f's 2^22 rows
# (glue_inputs()): a round's compose step, from the response to the next
# round's routing (need, the ptr column, the owners); in a tree whose K16
# works in place, the kernel alone over fresh copies of the state (the
# copies' time taken out, their device operations not counted), in the
# other the response gathered per row and transposed, the kernel, and the
# passes that make the routing
from bcalm_tpu_torch.parallel import distcompact

def converge_plain(Q, cap):
    for _ in range(cap):
        new = chains.jump_round_plain(Q)
        if torch.equal(new, Q):
            break
        Q = new
    return Q

for M, n_valid, mean in HIER_LEVELS:
    pred_j, valid_j = jump_graph(M, n_valid, mean)
    Q0 = chains.init_state(pred_j, valid_j)
    Qn0 = torch.empty_like(Q0)
    ch0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    _kernels.jump_round(Q0, Qn0, ch0)
    same([Qn0], [chains.jump_round_plain(Q0)], "jump_round")
    name = f"jump_round S={M}"
    digest[name] = digest_of(Qn0.reshape(-1))
    fns[name] = (lambda a=(Q0, Qn0, ch0): _kernels.jump_round(*a), 20)
    got = chains.plain_jumpF(pred_j, valid_j)
    same([got], [converge_plain(Q0, chains.max_rounds(M) + 1)], "plain_jumpF")
    name = f"plain_jumpF M={M}"
    digest[name] = digest_of(got.reshape(-1))
    fns[name] = (lambda a=(pred_j, valid_j): chains.plain_jumpF(*a), 5)
    del got, Q0, Qn0
gQ, g_cvalid, g_need, g_back, g_slots = glue_inputs()
g_rc, g_nd = gQ.shape[0] // 2, 1
g_owner = lambda q: torch.where(q >= g_rc, q - g_rc, q) // g_rc
if "route" in inspect.signature(_kernels.glue_compose).parameters:
    g_route = torch.stack([gQ[:, 0], torch.where(g_need, g_owner(gQ[:, 0]), g_nd)])
    g_state = [torch.empty_like(t) for t in (gQ, g_need, g_route)]
    g_ch = torch.zeros((1,), dtype=torch.int32, device=dev)
    def g_copies():
        for t, src in zip(g_state, (gQ, g_need, g_route)):
            t.copy_(src)
    def g_step(compose=_kernels.glue_compose):
        g_copies()
        compose(g_state[0], g_back, g_slots, g_state[1], g_ch, g_state[2], g_rc, g_nd)
        return [t.clone() for t in (g_state[0], g_state[1], g_state[2][0], g_state[2][1])]
    name = "glue_compose step S=4194304"
    copies[name], only[name] = g_copies, "glue_compose"
    g_timed = lambda: (g_copies(), _kernels.glue_compose(
        g_state[0], g_back, g_slots, g_state[1], g_ch, g_state[2], g_rc, g_nd))
else:
    def g_step(compose=_kernels.glue_compose):
        anc = g_back[:, torch.clamp(g_slots, 0, g_back.shape[1] - 1)]
        Qn, _ = compose(gQ, anc.t().contiguous(), g_need)
        need = g_cvalid & ((Qn[:, 1] & chains._F_ROOTED) == 0)
        qg = Qn[:, 0].contiguous()
        return [Qn, need, qg, torch.where(need, g_owner(qg), g_nd)]
    name = "glue_compose step S=4194304"
    g_timed = g_step
got = g_step()
same(got, g_step(distcompact.glue_compose_plain), "glue_compose step")
digest[name] = [digest_of(t.reshape(-1).long()) for t in got]
fns[name] = (g_timed, 20)
del got
# K21 at phase 3f's first round (glue_inputs(): the 2^24 slots of the
# exchange, the ptr of each row that needs a step in the first slots, as
# one owner receives them, zeros after) and at its two lookups' shapes
# (run: K8's tables of run_succ() and 197,556 queries; uid: 2^22 uids and
# 296,782 queries, as in phase 3f): in a tree with glue_answer, the
# kernel, whose output is the response's layout; in the other the answer
# as that tree's glue computed it (rows: Q gathered at every slot, then
# transposed, and the copy of that view its _respond made for the
# all_to_all); the all_to_all, which both trees run alike, is left out
# here (no process group).  K3's global step after its exchanges at phase 3f's shape
# (step_solid() at world size 1: the valid entries first in the receive
# buffer, zeros after, as K15 places them): in a tree whose junction_words
# compacts, the entries (with their validity and stack), the compaction,
# the host read of its count, the sort of the valid entries and the pair
# rule on its output, then the windowed scatter; in a tree with the
# earlier junction_words, the sort words of every slot instead of the
# compaction and the scatter kernel after a memset; in the other the entries, validity and stack, the fills,
# lex_argsort, the gathers of the sorted keys and payload, the pair
# kernel, then the boolean compaction and the scatter
g_S = g_back.shape[1]
g_vals = torch.zeros((g_S,), dtype=torch.int64, device=dev)
g_ok = torch.zeros((g_S,), dtype=torch.bool, device=dev)
g_vals[g_slots[g_need]] = gQ[g_need, 0]
g_ok[g_slots[g_need]] = True
r21 = np.random.RandomState(21)
a_succ, a_n, a_C = run_succ()
_, _, a_rid, a_head, a_end, _ = runchains.run_scans(a_succ, a_n, a_C, 0)
a_vals = torch.zeros_like(g_vals)
a_ok = torch.zeros_like(g_ok)
a_vals[:197556] = torch.from_numpy(r21.randint(0, a_n, 197556)).to(dev)
a_ok[:197556] = True
u_at = torch.from_numpy(np.where(r21.rand(2 * g_rc) < 0.07,
                                 r21.randint(0, 1 << 17, 2 * g_rc), -1)).to(dev)
u_vals = torch.zeros_like(g_vals)
u_ok = torch.zeros_like(g_ok)
u_vals[:296782] = torch.from_numpy(r21.randint(0, 4 * g_rc, 296782)).to(dev)
u_ok[:296782] = True
k21_cases = {"rows": (g_vals, g_ok, (gQ,)), "run": (a_vals, a_ok, (a_rid, a_head, a_end)),
             "uid": (u_vals, u_ok, (u_at,))}
for mode, (v21, o21, t21) in k21_cases.items():
    name = f"glue_answer {mode} S={g_S}"
    if hasattr(distcompact, "glue_answer"):
        fn21 = lambda a=(mode, v21, o21, t21, g_rc, 1, 0): distcompact.glue_answer(*a)
        same([fn21()], [distcompact.glue_answer_plain(mode, v21, o21, t21, g_rc, 1, 0)],
             "glue_answer " + mode)
    elif mode == "rows":
        fn21 = lambda: gQ[torch.clamp(distcompact._gq_local(g_vals, g_rc, g_rc), 0,
                                      2 * g_rc - 1)].t().contiguous().reshape(4, 1, -1)
    elif mode == "run":
        def fn21():
            lv = torch.clamp(a_vals, 0, a_C - 1)
            return torch.stack([torch.where(a_ok, a_rid[lv], -1),
                                torch.where(a_ok, a_end[lv] - a_head[lv] + 1, 0)]
                               ).reshape(2, 1, -1)
    else:
        def fn21():
            local = distcompact._gq_local(u_vals, g_rc, g_rc)
            return torch.where(u_ok, u_at[torch.clamp(local, 0, 2 * g_rc - 1)],
                               -1)[None].reshape(1, 1, -1)
    got = fn21()
    digest[name] = [int(got.sum()), int((got == -1).sum())]
    fns[name] = (fn21, 20)
del a_succ, got
ge_solid, ge_n, ge_C = step_solid()
if hasattr(junctions, "junction_words"):
    def k3_entries():
        return junctions.junction_entries(ge_solid, ge_n, 31, 0, ge_C, 1)[:2]
else:
    def k3_entries():
        keys_e, pay_e, _ = junctions.junction_entries(ge_solid, ge_n, 31, 0, ge_C, 1)
        return (torch.cat([keys_e, pay_e[None]]),
                (torch.arange(4 * ge_C, device=dev) % ge_C) < ge_n)
ent_e, valid_e = k3_entries()
K_e = ent_e.shape[0] - 1
n_v = int(valid_e.sum())
recv_e = torch.zeros_like(ent_e)
recv_e[:, :n_v] = ent_e[:, valid_e]
ev_e = torch.zeros_like(valid_e)
ev_e[:n_v] = True
del ent_e, valid_e
if hasattr(junctions, "junction_words") and "rows" in inspect.signature(
        junctions.junction_words).parameters:
    def k3_pairs(plain=False):
        compact = junctions.junction_words_plain if plain else junctions.junction_words
        words, pay, n_t = compact(recv_e, ev_e)
        n = int(n_t[0])
        words, pay = words[:, :n], pay[:n]
        perm, top = sort_op.lex_sort_words(words)
        edges = junctions.junction_edges_plain if plain else junctions.junction_edges
        return edges(top, perm, words, pay, K_e, ge_C, ge_C)
    k3_edges = lambda out: (out[0], out[1][0], out[1][1])
elif hasattr(junctions, "junction_words"):
    def k3_pairs(plain=False):
        if plain:
            words = junctions.junction_words_plain(recv_e[:K_e], ev_e)
            perm, top = sort_op.lex_sort_words(words)
            return junctions.junction_edges_plain(top, perm, words, recv_e[K_e], K_e, ge_C, ge_C)
        words = junctions.junction_words(recv_e[:K_e], ev_e)
        perm, top = sort_op.lex_sort_words(words)
        return junctions.junction_edges(top, perm, words, recv_e[K_e], K_e, ge_C, ge_C)
    k3_edges = lambda out: (out[0], out[1][0], out[1][1])
else:
    def k3_pairs(plain=False):
        e_keys = torch.where(ev_e[None], recv_e[:K_e], ln.SENTINEL)
        e_pay = torch.where(ev_e, recv_e[K_e], 0)
        perm = sort_op.lex_argsort([e_keys[j] for j in range(K_e)])
        edges = junctions.junction_edges_plain if plain else junctions.junction_edges
        return edges(e_keys[:, perm].contiguous(), e_pay[perm], ge_C)
    k3_edges = lambda out: out
ok_e, src_e, dst_e = k3_edges(k3_pairs())
same([ok_e, torch.where(ok_e, src_e, -1), torch.where(ok_e, dst_e, -1)],
     [torch.where(ok_e, t, -1) if t.dtype != torch.bool else t
      for t in k3_edges(k3_pairs(True))], "junction_edges step")
n_ok = int(ok_e.sum())
erecv = torch.zeros((2, ev_e.shape[0]), dtype=torch.int64, device=dev)
erecv[0, :n_ok], erecv[1, :n_ok] = src_e[ok_e], dst_e[ok_e]
eev = torch.zeros_like(ev_e)
eev[:n_ok] = True
del ok_e, src_e, dst_e
if hasattr(junctions, "junction_scatter"):
    k3_scatter = lambda: junctions.junction_scatter(erecv, eev, ge_C, 0, ge_C)
else:
    def k3_scatter():
        ea, eb = erecv[0][eev], erecv[1][eev]
        eslot = torch.where(ea >= ge_C, ea - ge_C, ea)
        lidx = torch.where(ea >= ge_C, eslot + ge_C, eslot)
        table = torch.full((2 * ge_C,), -1, dtype=torch.int64, device=dev)
        table[lidx] = eb
        return table
got = k3_scatter()
digest["K3 global step"] = [n_v, n_ok, int(got.sum()), int((got >= 0).sum())]
for name, fn in (("K3 global entries", k3_entries), ("K3 global pairs", k3_pairs),
                 ("K3 global scatter", k3_scatter)):
    fns[f"{name} E={ev_e.shape[0]}"] = (fn, 10)
del got
for kk, n_k, C_k, U_k in SPELL_SHAPES:
    sargs = spell_inputs(kk, n_k, C_k, U_k)
    got = _kernels.spell_unitigs(*sargs)
    same(got, engine.spell_unitigs_plain(*sargs), "spell_unitigs")
    name = f"spell_unitigs k={kk}"
    digest[name] = [int(t.long().sum()) for t in got]
    fns[name] = (lambda sargs=sargs: _kernels.spell_unitigs(*sargs), 20)
    del got
# K20's three modes at phase 3's and 3h's shapes (k20_inputs()) and K14's
# sampling of 8 rounds in both modes (k14_sampling(): one launch per mode
# in a tree whose K14 adds into the caller's histogram, else one per
# round), each held against its plain version, with digests
for lanes, kk, mk, rank_k, table_k in k20_inputs():
    for mode, (fn, plain) in k20_calls(lanes, kk, mk, rank_k, table_k).items():
        got = fn()
        same([got], [plain()], "kmer_minimizers " + mode)
        name = f"kmer_minimizers {mode} L={lanes.shape[0]}"
        digest[name] = digest_of(got)
        fns[name] = (fn, 20)
    del lanes, rank_k, table_k, got
rounds14, rank14 = k14_rounds()
for mode, (fn, plain) in k14_sampling(rounds14, rank14).items():
    got = fn()
    same([got], [plain()], "mmer_histograms " + mode)
    name = f"mmer_histograms sampling {mode} (8 rounds)"
    digest[name] = digest_of(got)
    fns[name] = (fn, 20)
    split[name] = True
# one exchange as the per-k-mer count makes it, on the hash mode's inputs
# at 1 and 4 ranks: K15, then Mesh.exchange (in a tree whose K15 writes
# the send buffer, that buffer as it is, the sentinel its fill word; else
# the validity's cast and torch.cat, the send permute, then the receive's
# and the count's sentinel pass).  No process group here: all_to_all_single
# is a copy of the buffer, what NCCL does at world size 1 (at 4 ranks this
# rank's own buckets come back); digests agree across the trees
import torch.distributed as dist
from bcalm_tpu_torch.parallel.mesh import Mesh
dist.all_to_all_single = lambda out, inp: out.copy_(inp)
route_params = inspect.signature(_kernels.route_buckets).parameters
writes_send = "fill" in route_params
# the count's buffer has no validity channel where K15 can leave it out
count_valid = (False,) if "with_valid" in route_params else ()
for n in (1, 4):
    xmesh, xcap = Mesh(n, 0, dev), -(-2 * int(hv.sum()) // n)
    if writes_send:
        def count_exchange(xmesh=xmesh, n=n, xcap=xcap):
            send = _kernels.route_buckets(hl, hv, None, n, xcap, False, ln.SENTINEL,
                                          *count_valid)[0]
            return xmesh.exchange(send, False)[0].reshape(2, -1)
    else:
        def count_exchange(xmesh=xmesh, n=n, xcap=xcap):
            bl, bv, _ = _kernels.route_buckets(hl, hv, None, n, xcap)
            recv, rv = xmesh.exchange(bl, bv)
            return torch.where(rv.reshape(-1)[None], recv.reshape(2, -1), ln.SENTINEL)
    name = f"route_buckets hash + exchange n={n} (count)"
    digest[name] = digest_of(count_exchange().reshape(-1))
    fns[name] = (count_exchange, 20)
dms = {n: device_ms(f, r, only.get(n, "")) for n, (f, r) in fns.items()}
print(json.dumps({"ms": {n: time_ms(f, r) - (time_ms(copies[n], r) if n in copies else 0)
                         for n, (f, r) in fns.items()},
                  "device_ms": {n: d[0] for n, d in dms.items()},
                  "ops": {n: d[1] for n, d in dms.items()},
                  "host_ms": {n: host_ms(fns[n][0]) for n in split},
                  "digest": digest}))
"""


# Run in a tree's root by phase_compare: parallel.pipeline.distributed_build
# in this process over an NCCL group of world size 1 (argv: the reads, the
# output FASTA, a fresh group file), as phase 3f runs it; prints one JSON
# line with the wall, timing's rounds and the stats the rounds move.
DIST_AB = r"""
import json, sys, time
import torch
import torch.distributed as dist
sys.path.insert(0, ".")
from bcalm_tpu_torch import cli, engine
from bcalm_tpu_torch.io import bank as bank_mod
from bcalm_tpu_torch.io import fasta_writer
from bcalm_tpu_torch.parallel import launch, pipeline
fa, out, group = sys.argv[1:4]
dev = torch.device("cuda", 0)
mesh = launch.init_group(1, 0, "cuda", "file://" + group)
try:
    bank = bank_mod.Bank.open(fa)
    cfg = engine.EngineConfig(k=31, abundance_min=2)
    engine.configure_chunk(cfg, 0, dev)
    cli.adapt_max_len(bank, cfg)
    timing = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    us = pipeline.distributed_build(mesh, bank.sequences(), cfg,
                                    pipeline.MinimizerConfig(m=10),
                                    timing=timing)
    torch.cuda.synchronize()
    wall = time.time() - t0
    with open(out, "w") as f:
        fasta_writer.write_fasta(us, f)
finally:
    dist.destroy_process_group()
st = us.stats
print(json.dumps({"wall": wall, "rounds": timing["rounds"],
                  "superkmers": st["superkmers"],
                  "exchange_cap_retries": st["exchange_cap_retries"],
                  "device_peak_mb": st.get("device_peak_mb")}))
"""


def kernel_ab_line(times: dict) -> str:
    """KERNEL_AB's JSON line as text: per kernel, CUDA-event ms / device ms
    [device operations per call], and for K13 and K15 the host ms per call
    (python + ctypes + launch)."""
    parts = []
    for n, t in times["ms"].items():
        text = (f"{n} {t:.4f} / {_fmt_ms(times['device_ms'][n])} "
                f"[{times['ops'][n]:g} ops]")
        h = times["host_ms"].get(n)
        if h:
            text += (f" host {h['total']:.4f} = python {h['python']:.4f} + "
                     f"ctypes {h['ctypes']:.4f} + launch {h['launch']:.4f} "
                     f"({h['c_calls']} C calls)")
        parts.append(text)
    return ("kernels (ms: CUDA events / device time [device operations per "
            "call], host time per call): " + ", ".join(parts))


def phase_compare(tmp: str, parent: str, coverage: float, seed: int) -> None:
    """--compare-tree DIR: `python -m bcalm_tpu_torch` from the tree in DIR
    and from this one in turns (DIR, this, this, DIR) on the phase 3 reads,
    resident and at each tree's phase 3b -max-memory (its pass times
    printed); before them, KERNEL_AB and DIST_AB
    (the -devices build at world size 1 on 1/8 of the reads) in each tree
    in the same turns.  A warm-up run of each tree on a small input builds
    its kernels and ingest library first, so that no timed run builds
    anything."""
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
    digests = []
    for name in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, "-c", KERNEL_AB],
                              cwd=trees[name], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} kernel timings failed:\n{proc.stderr}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        digests.append(times["digest"])
        say(f"[compare] {name} " + kernel_ab_line(times))
    if any(d != digests[0] for d in digests):
        raise AssertionError(f"a kernel of KERNEL_AB's digests gave other "
                             f"outputs in the two trees: {digests}")
    say(f"[compare] the K3b step, K8, K12a, K17-K19, K4, K16, K21, K3's "
        f"global step, K10, K11, K20, K14 and K15's hash mode with the "
        f"count's exchange give "
        f"the same outputs in both trees (sums and counts): "
        f"{json.dumps(digests[0])}")
    # SPLIT once in each tree: device time per operation
    for name in ("parent", "change"):
        proc = subprocess.run([sys.executable, "-c", SPLIT], cwd=trees[name],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} SPLIT failed:\n{proc.stderr}")
        say(f"[compare] {name} split {proc.stdout.strip().splitlines()[-1]}")
    # the -devices build at world size 1 on the first 1/8 of the reads,
    # against the single-device build of the same reads
    part = os.path.join(tmp, "reads_eighth.fa")
    n_part = _first_reads(fa, part, 8)
    ref = os.path.join(tmp, "eighth_single")
    _sub(["-in", part, "-kmer-size", str(K), "-abundance-min", "2", "-out",
          ref], "1/8 of the reads")
    for turn, name in enumerate(("parent", "change", "change", "parent")):
        out = os.path.join(tmp, f"dist{turn}.unitigs.fa")
        proc = subprocess.run(
            [sys.executable, "-c", DIST_AB, part, out,
             os.path.join(tmp, f"dist_group{turn}")], cwd=trees[name],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} distributed_build failed:\n"
                               f"{proc.stderr}")
        _same_unitigs(out, ref + ".unitigs.fa",
                      f"{name} distributed_build on {n_part} reads")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        say(f"[compare] {name} distributed_build, NCCL world size 1, "
            f"{n_part} reads: wall {r['wall']:.2f}s, rounds "
            f"{r['rounds']:.3f}s, superkmers {r['superkmers']}, "
            f"exchange_cap_retries {r['exchange_cap_retries']}, "
            f"device_peak_mb {r['device_peak_mb']}; unitigs, KC, km and "
            f"links equal the single-device build's")
    base = ["-in", fa, "-kmer-size", str(K), "-abundance-min", "2",
            "-verbose", "1"]
    outputs, max_memory = {}, {}
    for turn, name in enumerate(("parent", "change", "change", "parent")):
        for ooc in (False, True):
            extra = []
            if ooc:
                # each tree at its own phase 3b M (pick_max_memory), whose
                # resident budget is the same in both
                if name not in max_memory:
                    proc = subprocess.run(
                        [sys.executable, "-c", "import chip_smoke, torch; "
                         f"print(chip_smoke.pick_max_memory({distinct}, "
                         "torch.device('cuda', 0))[0])"],
                        cwd=trees[name], capture_output=True, text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(f"{name} pick_max_memory failed:\n"
                                           f"{proc.stderr}")
                    max_memory[name] = int(proc.stdout.split()[-1])
                extra = ["-max-memory", str(max_memory[name])]
            out = os.path.join(tmp, f"cmp{turn}{len(extra)}")
            wall, st, _ = _sub(base + extra + ["-out", out],
                               f"{name} {' '.join(extra)}", trees[name])
            distinct = int(st["distinct_kmers"])
            outputs.setdefault(ooc, set()).add(_read(out + ".unitigs.fa"))
            passes = (f", ooc_passes {st['ooc_passes']}, pass times "
                      f"{_literal(st['timing'])['passes']} s, "
                      f"ooc_block_cache_mb "
                      f"{st.get('ooc_block_cache_mb', 'none')}" if ooc else "")
            say(f"[compare] {name} {' '.join(extra) or 'resident'}: wall "
                f"{wall:.2f}s (process start included), time:build "
                f"{st['time:build']}, t_count_s {st['t_count_s']}, "
                f"t_compact_s {st['t_compact_s']}, t_assemble_s "
                f"{st['t_assemble_s']}, write {st['time:write']}, "
                f"ingest_parser {st.get('ingest_parser', 'not printed')}, "
                f"device_peak_mb {st.get('device_peak_mb', 'not measured')}"
                + passes)
    if any(len(v) != 1 for v in outputs.values()):
        raise AssertionError("the two trees wrote different unitigs")
    say(f"[compare] {n_reads} reads; both trees wrote the same bytes")


def phase_longk(tmp: str, seed: int, dev):
    """Phase 3h: the k = 151 build of a 300 bp read set and the k = 255
    build of its first quarter, in this process.  Returns, per k, the
    build's recorded kernel inputs (k = 255: extract_insert's and
    junction_keys' alone), its launches and its converging phases' round
    counts (phase 5)."""
    fa = os.path.join(tmp, "reads300.fa")
    t0 = time.time()
    n_reads = write_reads(fa, LONG_COVERAGE, seed, sample_seed=seed + 2,
                          read_len=LONG_READ_LEN)
    quarter = os.path.join(tmp, "reads300_quarter.fa")
    n_quarter = _first_reads(fa, quarter, 4, LONG_READ_LEN)
    say(f"[longk] {n_reads} reads of {LONG_READ_LEN} bp (the 4.6 Mbp genome, "
        f"{LONG_COVERAGE}x, sample seed {seed + 2}) written in "
        f"{time.time() - t0:.1f}s; the first {n_quarter} for k = {LONG_K2}")
    out = {}
    for k, reads_fa, record in ((LONG_K, fa, tuple(KERNELS)),
                                (LONG_K2, quarter, ("extract_insert",
                                                    "junction_keys"))):
        args = ["-in", reads_fa, "-kmer-size", str(k), "-abundance-min", "2",
                "-verbose", "1", "-out", os.path.join(tmp, f"long{k}")]
        wall, st, _, launches, inputs = _inproc(args, f"-kmer-size {k}",
                                                record=record)
        _require_launched(launches, LONGK_PATH, f"k = {k}")
        if st.get("ingest_parser") != "native":
            raise AssertionError(f"k = {k}: ingest_parser "
                                 f"{st.get('ingest_parser')}, expected native")
        n_links = phase_invariants(os.path.join(tmp, f"long{k}.unitigs.fa"),
                                   st, k, dev)
        if k == LONG_K:
            judge_by_reference(reads_fa, os.path.join(tmp, f"long{k}.unitigs.fa"),
                               k, 2, dev)
        say(f"[longk] k = {k} ({(k + 15) // 16} lanes), in process: wall "
            f"{wall:.2f}s (kernel inputs recorded to the host: "
            f"{len(record)} kernels), "
            f"t_count_s {st['t_count_s']}, t_compact_s {st['t_compact_s']}, "
            f"t_assemble_s {st['t_assemble_s']}; kmer_occurrences "
            f"{st['kmer_occurrences']}, distinct_kmers {st['distinct_kmers']}, "
            f"solid_kmers {st['solid_kmers']}, unitigs {st['unitigs']}, links "
            f"{n_links}; device_peak_mb {st.get('device_peak_mb', 'not measured')}"
            f"; ingest wait {st.get('time:count.ingest_wait', 'not printed')}")
        say(f"[launches] k = {k}: {json.dumps(launches)}; converging phases "
            f"(K4 rounds launched, rounds that moved a row, host syncs): "
            f"{json.dumps(st['converge_rounds'])}")
        out[k] = inputs, launches, st["converge_rounds"]
    return out


def judge_by_reference(reads_fa: str, fasta: str, k: int, amin: int, dev):
    """The benchmark's plain reference (cdbg_bench/reference.py, exact
    keys at any k) built from the same reads on the card, and its
    comparison with the build's FASTA: every compared count must be 0."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "cdbg_bench", "reference.py")
    spec = importlib.util.spec_from_file_location("cdbg_bench_reference", path)
    reference = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = reference   # its dataclasses look it up
    spec.loader.exec_module(reference)
    t0 = time.time()
    sol = reference.reference(reads_fa, k, amin, dev)
    checks, detail = reference.judge(sol, fasta)
    del sol
    torch.cuda.empty_cache()
    say(f"[reference] k = {k}: {json.dumps(checks)} ({json.dumps(detail)}) "
        f"in {time.time() - t0:.1f}s")
    if any(checks.values()):
        raise AssertionError(f"k = {k}: the build differs from the plain "
                             f"reference: {checks}")


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


def _canonical_hashes(seqs, k: int, dev) -> torch.Tensor:
    """A strand-independent 64-bit hash of every k-mer of every sequence,
    any k, on the card: the least of the polynomial hashes (mod 2^64) of
    its forward and its reverse-complement base string.  Distinct k-mers
    collide with probability ~n^2 / 2^65 (1e-5 at 2e7 k-mers)."""
    from bcalm_tpu_torch.io import packing

    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int64, device=dev)
    flat = torch.from_numpy(packing.encode_ascii("".join(seqs))
                            .astype(np.int64)).to(dev)
    P = flat.shape[0] - k + 1
    base = 0x100000001B3            # odd: invertible mod 2^64
    fwd = torch.zeros(P, dtype=torch.int64, device=dev)
    rc = torch.zeros(P, dtype=torch.int64, device=dev)
    power = 1
    for j in range(k):
        b = flat[j:j + P]
        fwd = fwd * base + (b + 1)
        # the forward hash of the reverse complement: comp(b_j) at B^j
        rc = rc + ((b ^ 2) + 1) * (power - (1 << 64) if power >= 1 << 63
                                   else power)
        power = power * base % (1 << 64)
    starts = torch.cumsum(lens, 0) - lens
    idx = torch.arange(P, device=dev)
    u = torch.searchsorted(starts, idx, right=True) - 1
    return torch.minimum(fwd, rc)[idx + k <= starts[u] + lens[u]]


def phase_invariants(path: str, stats: dict, k: int = K, dev=None):
    """Each solid canonical k-mer once in the unitigs (exact 2k-bit values
    for k <= 32, else _canonical_hashes), the KC sum, and every link a
    (k-1)-overlap."""
    from bcalm_tpu_torch.io import fasta_writer

    seqs, headers = fasta_writer.parse_unitigs_fasta(path)
    n_solid = int(stats["solid_kmers"])
    if k <= 32:
        km = _canonical_kmers(seqs, k)
        total, distinct = km.shape[0], np.unique(km).shape[0]
    else:
        km = _canonical_hashes(seqs, k, dev)
        total, distinct = km.shape[0], torch.unique(km).shape[0]
    del km
    if total != n_solid or distinct != n_solid:
        raise AssertionError(f"k={k}: unitig k-mers: {total} total, "
                             f"{distinct} distinct, expected {n_solid} each")
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
                if oriented(u, su)[-(k - 1):] != oriented(int(v), sv)[:k - 1]:
                    raise AssertionError(f"link {u}{su} -> {v}{sv} is no overlap")
                n_links += 1
    say(f"[invariants] k={k}: {n_solid} solid k-mers each once in {len(seqs)} "
        f"unitigs; sum KC = {kc}; {n_links} links all (k-1)-overlaps")
    return n_links


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


# the runtime and driver calls that put an operation on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy",
                "cudaMemset", "cuMemcpy", "cuMemset")


def _device_ms(fn, reps: int = 20, only: str = ""):
    """(device time per call, device operations per call) of fn over `reps`
    calls: every kernel, fill and copy that torch.profiler saw whose name
    holds `only`.  The time is None where it saw none, and where the
    profile lost device operations: fn does the same work each call, so
    a whole profile holds a whole number of operations a call, and no
    fewer than the launch calls it saw on the host.  A time summed over
    part of the launches would understate the kernel."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda]
    calls = sum(1 for e in prof.events()
                if e.device_type != cuda and e.name.startswith(LAUNCH_CALLS))
    mine = [e for e in evs if only in e.name]
    us = sum(e.device_time_total for e in mine)
    whole = len(evs) % reps == 0 and len(evs) >= calls
    return (us / 1e3 / reps if us and whole else None), len(mine) / reps


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def receive_line(got, valid_channel: bool = True) -> str:
    """The passes parallel.mesh.received makes on a received buffer (n_dev,
    C+1, cap): without and with the validity (a buffer with no validity
    channel, (n_dev, C, cap): without), device ms [device operations] and
    CUDA-event ms."""
    from bcalm_tpu_torch.parallel import mesh as mesh_mod

    parts = []
    for with_valid in (False, True) if valid_channel else (False,):
        fn = (lambda w=with_valid: mesh_mod.received(got, w))
        dms, ops = _device_ms(fn)
        dev_text = (f"{_fmt_ms(dms)} device ms [{ops:g} operations]" if ops
                    else "no device operation")
        parts.append(f"{'with' if with_valid else 'without'} the validity "
                     f"{dev_text}, {_time_ms(fn):.4f} ms event")
    return "; ".join(parts)


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
    err = float((a.long() - b.long()).abs().max().item()) if a.numel() else 0.0
    # two int64 words 2^63 apart (a key whose top base differs by 2) wrap
    # to a negative difference
    return err if err > 0 or torch.equal(a, b) else float("inf")


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


def _search_bytes(run: torch.Tensor, n: int, bounds: torch.Tensor) -> int:
    """What K6 must read: each bound's L lanes and the L lanes of the
    ceil(log2(n + 1)) columns its binary search probes."""
    L, B = bounds.shape
    return B * L * 8 * (1 + max(1, math.ceil(math.log2(n + 1))))


def _fold_bytes(body: torch.Tensor, lo, hi) -> int:
    """What K5 must move: of each column, the lanes its two comparisons
    read (up to the first lane that differs from lo or from hi), all L+1
    rows of each column it folds, and the count."""
    from bcalm_tpu_torch.ops import count

    L = body.shape[0] - 1
    lanes = body[:L]
    seen = torch.zeros(body.shape[1], dtype=torch.int64, device=body.device)
    for key in (lo, hi):
        eq = torch.ones_like(seen, dtype=torch.bool)
        depth = torch.zeros_like(seen)
        for j in range(L):
            depth += eq               # lane j is read where j-1 matched
            eq &= lanes[j] == key[j]
        seen = torch.maximum(seen, depth)
    n_fold = body.shape[1] - int(count.range_fold_plain(body.clone(), lo,
                                                        hi)[0])
    return 8 * int(seen.sum()) + 8 * (L + 1) * n_fold + 8


def _pairs_bytes(s_word, perm, payload, C, K, lower=None) -> tuple:
    """(read, written) bytes K3b must move: the sorted top word; for a
    two-word key the permutation and the second word through it (random:
    a 32-byte sector each); for a key of three words or more what
    pair_rule_bytes counts (the lower words and perm only where the top
    words tie); else the sectors of perm that the pair heads' perm[i],
    perm[i+1] touch; the two payloads of each head (random sectors); succ
    written once (its windows are written whole)."""
    from bcalm_tpu_torch.ops import junctions

    E = s_word.shape[0]
    if lower is not None and lower.shape[0] > 1:
        # pair_rule_bytes reads words 1.. of a (W, E) stack
        words = torch.cat([s_word[None], lower])
        return pair_rule_bytes(s_word, perm, words, K), 16 * C
    s_lower = None if lower is None else lower[:, perm]
    heads = torch.nonzero(junctions.pair_heads(
        s_word, s_lower, K, junctions.exact_sentinel(K))).flatten()
    read = 8 * E + 2 * 32 * heads.numel()
    if lower is not None:
        read += 8 * E + 32 * E
    else:
        read += 32 * torch.unique(torch.cat([heads, heads + 1]) // 4).numel()
    return read, 16 * C


def _count_bytes(top, perm, lower, L, weights, pos) -> int:
    """Bytes that K2 on the sort's output must read on this run's data:
    every sorted top word; perm, and through it the weight, pos and lower
    words of each column that needs its entry (at 1 or 2 lanes a valid
    column, where there are weights or pos; past 2 lanes every column),
    each a random 32-byte sector where its row exceeds the L2."""
    N = top.shape[0]
    if lower is None:
        sent = 0x7FFFFFFFFFFFFFFF if L == 2 else 0xFFFFFFFF
        need = (int((top != sent).sum())
                if weights is not None or pos is not None else 0)
    else:
        need = N
    moved = 8 * N + 8 * need
    for t in (weights, pos):
        if t is not None:
            moved += _gathered(t, need)
    if lower is not None:
        moved += sum(_gathered(lower[j], N) for j in range(lower.shape[0]))
    return moved


def _spell_bytes(solid, counts, uid, rank, length, start_oid, U, k,
                 n_members) -> int:
    """What K11 must read: the uid and rank of every oriented id, one lane
    (its new base) and the count of each member, and the start id, length
    and every lane of each unitig's first k-mer."""
    L, C = solid.shape
    return 2 * C * 16 + n_members * 16 + U * (L + 2) * 8


def _link_ends_bytes(codes, ends, k) -> int:
    """What K22 must read: the two ends of k-1 bases and the length prefix
    of each unitig (its keys, written once, are counted from its output)."""
    return ends.shape[0] * (2 * (k - 1) + 8)


def _sorted_words(words: torch.Tensor) -> torch.Tensor:
    return torch.sort(words).values


def _link_pairs_bytes(top, perm, lower, U) -> int:
    """What K23 must read: the top word and permutation of every sorted
    entry, and past one key word each entry's lower words once (its pair
    words, written once, are counted from its output)."""
    return _nbytes((top, perm, lower))


def _gathered(t: torch.Tensor, queries: int) -> int:
    """Bytes that `queries` reads of random rows of t must move: a 32-byte
    sector each where t exceeds the L2, else at most all of t once."""
    n = _nbytes(t)
    return 32 * queries if n > L2_BYTES else min(n, 32 * queries)


def pair_rule_bytes(s_word, perm, words, K: int) -> int:
    """Bytes that K3b's pair rule on the sort's output (junction_edges)
    must read on this run's data: every sorted top word; where the key has
    lower words, those of the two entries of each valid neighbour pair
    whose top words are equal; perm at those entries (with one word, at
    each pair head's two); the payload of each pair head's two entries.  perm,
    each lower word row and the payload count the distinct 32-byte sectors
    read, or the valid entries' 8 bytes each where that is less (the step
    sorts the valid entries alone)."""
    from bcalm_tpu_torch.ops import junctions

    sent0, shift = junctions.sentinel_words(K)
    E, W = s_word.shape[0], words.shape[0]
    valid = (s_word >> shift) != (sent0 >> shift)
    n_valid = int(valid.sum())

    def sectors(idx):
        return min(8 * n_valid, 32 * torch.unique(idx // 4).numel())

    # eqn[j + 1]: entry j's key equals entry j + 1's, both valid
    eqn = torch.zeros((E + 2,), dtype=torch.bool, device=s_word.device)
    eqn[1:E] = (s_word[1:] == s_word[:-1]) & valid[1:]
    top_eq = torch.nonzero(eqn).flatten() - 1
    lower = 0
    if W > 1:
        pa, pb = perm[top_eq], perm[top_eq + 1]
        same = torch.ones_like(pa, dtype=torch.bool)
        for w in range(1, W):
            same &= words[w][pa] == words[w][pb]
        eqn[top_eq[~same] + 1] = False
        lower = (W - 1) * sectors(torch.cat([pa, pb]))
    head = valid & eqn[1:E + 1] & ~eqn[:E] & ~eqn[2:]
    heads = torch.nonzero(head).flatten()
    at = torch.cat([top_eq, top_eq + 1] if W > 1 else [heads, heads + 1])
    return (8 * E + lower + sectors(at)
            + sectors(perm[torch.cat([heads, heads + 1])]))


def _bound(moved: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the peak rate."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _lookup_bytes(table, n: int) -> int:
    """Bytes of a (4^m,) table that n lookups must read: each lookup's 8
    bytes, or the whole table where that is less (0: no table)."""
    return 0 if table is None else min(_nbytes(table), 8 * n)


def _l2(row: dict, count: int, what: str) -> None:
    """Add to a row the L2 operations that set its pace (K14's and K20's
    atomics, K20's random rank sectors) and their rate on the device in
    this run."""
    row["l2_ops"], row["l2_what"] = count, what
    ms = row.get("device_ms")
    row["l2_g_per_s"] = count / (ms * 1e6) if ms else None


def _k14_plain(words, lengths, k, m, rank, load):
    from bcalm_tpu_torch.ops import superkmer

    if load:
        return superkmer.sample_minimizer_load_plain(words, lengths, k, m, rank,
                                                     rank is not None)
    return superkmer.sample_cmmer_histogram_plain(words, lengths, k, m)


def _k14_atomics(words, lengths, k, m, rank, load) -> int:
    """The global atomics K14 makes on a block: one per position with a
    whole m-mer (m-mer mode), or one per run of equal window minima within
    each 32-position segment of a row (minimizer-load mode)."""
    from bcalm_tpu_torch.ops import superkmer

    P = 16 * words.shape[1]
    pos = torch.arange(P, device=words.device)[None, :]
    if not load:
        return int((pos <= lengths[:, None] - m).sum())
    key = superkmer._minimizer_keys(words, k, m, rank, rank is not None)[2]
    wmin = superkmer.window_min_keys(key, k - m + 1)
    head = (pos % 32 == 0) | (wmin != torch.roll(wmin, 1, dims=1))
    return int((head & (pos <= lengths[:, None] - k)).sum())


def _rank_and_table(lanes, k: int, m: int):
    """Phase 3g's chain on a k-mer set: the frequency rank of its m-mer
    histogram and the 4-way table of its minimizer load."""
    from bcalm_tpu_torch.models import minimizer

    allv = torch.ones((lanes.shape[1],), dtype=torch.bool, device=lanes.device)
    rank = minimizer.frequency_rank(
        minimizer.mmer_histogram(lanes, allv, k, m).cpu().numpy())
    rank = torch.from_numpy(rank.astype(np.int64)).to(lanes.device)
    load = np.bincount(minimizer.minimizers(lanes, k, m, rank).cpu().numpy(),
                       minlength=4 ** m)
    table = minimizer.build_repartition(load.astype(np.int32), 4)
    return rank, torch.from_numpy(table.astype(np.int64)).to(lanes.device)


def k20_rows(lanes, k: int, m: int, rank, table, launched: int, tag: str,
             reps: int = 20) -> list:
    """K20's three modes on the (L, N) k-mers, each bitwise against its
    plain version: the histogram (its library call torch.bincount of the
    m-mers), the partition ids through rank and table, the lexicographic
    minimizers.  The histogram and partition rows also carry the L2
    operations that set their pace, N(k-m+1) atomics or random rank
    sectors, with their rate on the device in this run."""
    from bcalm_tpu_torch.models import minimizer
    from bcalm_tpu_torch.ops import _kernels

    n, w = lanes.shape[1], k - m + 1
    allv = torch.ones((n,), dtype=torch.bool, device=lanes.device)
    mm_flat = minimizer.extract_mmers(lanes, k, m).reshape(-1)
    launches = {"kmer_minimizers": launched}
    rows = [check_kernel(
        "kmer_minimizers", launches,
        lambda: _kernels.kmer_minimizers(lanes, k, m, valid=allv,
                                         histogram=True),
        lambda: minimizer.mmer_histogram_plain(lanes, allv, k, m),
        reads=(lanes, allv), ops=n * w * 4, label="kmer_minimizers" + tag,
        library=lambda: torch.bincount(mm_flat, minlength=4 ** m), reps=reps)]
    _l2(rows[-1], n * w, "L2 atomics")
    del mm_flat
    for mode, rk, tb in (("partition", rank, table),
                         ("lexicographic", None, None)):
        rows.append(check_kernel(
            "kmer_minimizers", launches,
            lambda: _kernels.kmer_minimizers(lanes, k, m, rank=rk, table=tb),
            lambda: (minimizer.minimizers_plain(lanes, k, m, rk) if tb is None
                     else minimizer.partition_of_plain(lanes, k, m, tb, rk)),
            reads=lanes,
            written=8 * n + _lookup_bytes(rk, n * w) + _lookup_bytes(tb, n),
            ops=n * w * 4, label=f"kmer_minimizers:{mode}{tag}", reps=reps))
        if rk is not None:
            _l2(rows[-1], n * w, "random rank sectors")
    return rows


def check_kernel(name, launches, kernel_fn, plain_fn, kernel_timed=None,
                 plain_timed=None, reads=(), read_bytes=0, written=None, ops=0,
                 library=None, label=None, replaces=None, launched=None,
                 reps=20, device=True) -> dict:
    """Bitwise check of kernel_fn() vs plain_fn() and the kernel's row; the
    *_timed variants (default: the same calls) are what the CUDA events
    time.  The bound counts `reads` read once, `read_bytes` more (what a
    kernel that reads parts of a tensor needs), and the kernel's outputs
    (or `written` bytes) written once; `library` is one PyTorch call
    computing the same function, timed beside it.  label, replaces and launched
    override the row's name, JAX program and launch count (default:
    launches[name]).  device (default): the row also gets the device time
    and operations per call of the kernel (device_ms, device_ops) and the
    device time of the library call (library_device_ms), beside their
    CUDA-event times, which include the launch path."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = _max_err(got, want)
    if err != 0:
        raise AssertionError(f"{label or name}: kernel differs from its plain "
                             f"version (max abs err {err})")
    moved = (_nbytes(reads) + read_bytes
             + (_nbytes(got) if written is None else written))
    del got, want
    bound_ms, bound_by = _bound(moved, ops)
    row = {"name": label or name, "route": "cuda", "source": KERNELS[name][0],
           "replaces": replaces or KERNELS[name][1],
           "launches": launches[name] if launched is None else launched,
           "max_abs_err": err, "ms": _time_ms(kernel_timed or kernel_fn, reps),
           "plain_ms": _time_ms(plain_timed or plain_fn, reps),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": _time_ms(library, reps) if library else None}
    if device:
        row["device_ms"], row["device_ops"] = _device_ms(
            kernel_timed or kernel_fn, reps)
        row["library_device_ms"] = (_device_ms(library, reps)[0] if library
                                    else None)
    return row


def _phase_launches(phases, counter: str) -> dict:
    return {ph: counts[counter] for ph, counts in phases.items()}


def k1_row(args, launches, label, counter, phases, reps=20) -> dict:
    """K1 on recorded arguments (buf, words, lengths, k, slot_base, offset,
    row_base[, lo, hi]): bitwise against its plain version on fresh copies
    of the buffer (it writes in place), timed into one preallocated copy
    (no 0.8 GB clone inside the timing), with its device time and
    operations and the launches of `counter` in each phase."""
    from bcalm_tpu_torch.ops import _kernels, extract

    buf, words, lengths, k, slot_base, offset, row_base = args[:7]
    kw = ({"lo": args[7], "hi": args[8]}
          if len(args) > 7 and args[7] is not None else {})
    ext_args = (words, lengths, k, slot_base, offset, row_base)
    scratch = buf.clone()

    def fresh(fn):
        def run():
            out = buf.clone()
            fn(out, *ext_args, **kw)
            return out
        return run

    r = check_kernel(
        "extract_insert", launches, fresh(_kernels.extract_insert),
        fresh(extract.extract_insert_plain),
        lambda: _kernels.extract_insert(scratch, *ext_args, **kw),
        lambda: extract.extract_insert_plain(scratch, *ext_args, **kw),
        reads=(words, lengths),
        written=buf.shape[0] * extract.block_slots(words.shape, k) * 8,
        label=label, launched=launches[counter], reps=reps)
    r["phase_launches"] = _phase_launches(phases, counter)
    return r


def k5_row(body, lo, hi, launches, label, phases, launched=None,
           reps=20) -> dict:
    """K5 on a chunk body (it folds in place: compared on fresh copies,
    timed on one scratch copy of the same strides), with its device time
    and operations and its launches in each phase."""
    from bcalm_tpu_torch.ops import _kernels, count

    def copy_of(t):
        out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                  device=t.device)
        out.copy_(t)
        return out

    body_scratch = copy_of(body)

    def fold(fn):
        def run():
            out = copy_of(body)
            return out, fn(out, lo, hi)
        return run

    r = check_kernel("range_fold", launches, fold(_kernels.range_fold),
                     fold(count.range_fold_plain),
                     lambda: _kernels.range_fold(body_scratch, lo, hi),
                     lambda: count.range_fold_plain(body_scratch, lo, hi),
                     written=_fold_bytes(body, lo, hi), label=label,
                     launched=launched, reps=reps)
    r["phase_launches"] = _phase_launches(phases, "range_fold")
    return r


def k5_chunks(ranged_args, owed_args):
    """K5's inputs in phase 5: phase 3b's first chunk in range mode (the
    buffer its first range-mode K1 launch wrote into, with that block
    extracted without the range, as the chunk was before K1 folded; cut to
    the chunk's cap columns: a column slice whose stride is cap + F), the
    same chunk at an odd stride, and the first chunk 3b owed a fold, when
    it owed one.  Returns [(label, body, lo, hi, on 3b's path)]."""
    from bcalm_tpu_torch.ops import extract

    buf, words, lengths, k, slot_base, offset, row_base, lo, hi = ranged_args
    chunk = buf.clone()
    extract.extract_insert_plain(chunk, words, lengths, k, slot_base, offset,
                                 row_base)
    cap = chunk.shape[1] - extract.block_slots(words.shape, k)
    width = cap + 1 + cap % 2
    odd = torch.empty((chunk.shape[0], width), dtype=chunk.dtype,
                      device=chunk.device)
    odd[:, :cap] = chunk[:, :cap]
    out = [("range_fold", chunk[:, :cap], lo, hi, True),
           ("range_fold:odd_stride", odd[:, :cap], lo, hi, False)]
    if owed_args is not None:
        out.append(("range_fold:owed",) + tuple(owed_args) + (True,))
    return out


def glue_rows(recorded, launches, dev, mesh=None):
    """K16 on the inputs of its first call in phase 3f (Q, back, slots,
    need, changed, route, run_cap, n_dev), bitwise against its plain
    version; with a mesh, K16's whole glue round (distcompact.glue_round:
    K15, the exchange, the owners' answer (K21), the response, K16) from
    the same state, against the round with the plain K15, K21 and K16.
    Each call runs
    over fresh copies of Q, need and route (the round and K16 write them
    in place): the copies' event time is taken out of ms and plain_ms,
    and K16's device time is its kernel's alone (by name).  The round's
    row has no device time: that needs a profiler session while the NCCL
    group is up, and on an H100 the later sessions of a smoke run that had
    one lost device operations.  The bound counts need read for every
    row; for each row that needs a step its row, its ancestor's
    32 bytes and its slot (K16) or its ptr and owner (the round) read, and
    need, ptr and owner written; and each row that moved written.
    Returns (K16's row, the round's row or None)."""
    from bcalm_tpu_torch.ops import _kernels
    from bcalm_tpu_torch.parallel import distcompact, pipeline

    Q, back, slots, need, _, route, run_cap, n_dev = (
        a.to(dev) if isinstance(a, torch.Tensor) else a for a in recorded)
    state = [torch.empty_like(t) for t in (Q, need, route)]
    ch = torch.zeros((1,), dtype=torch.int32, device=dev)

    def copies():
        for t, src in zip(state, (Q, need, route)):
            t.copy_(src)
        ch.zero_()

    def k16(compose):
        copies()
        compose(state[0], back, slots, state[1], ch, state[2], run_cap, n_dev)

    def glue_round(plain):
        copies()
        saved = (distcompact.glue_compose, distcompact.route_to_buckets,
                 distcompact.glue_answer)
        if plain:
            distcompact.glue_compose = distcompact.glue_compose_plain
            distcompact.route_to_buckets = pipeline.route_to_buckets_plain
            distcompact.glue_answer = distcompact.glue_answer_plain
        try:
            return distcompact.glue_round(mesh, state[0], state[1], state[2],
                                          ch, back.shape[1] // n_dev, run_cap)
        finally:
            (distcompact.glue_compose, distcompact.route_to_buckets,
             distcompact.glue_answer) = saved

    def outputs(fn):
        def run():
            extra = fn()
            return tuple(t.clone() for t in state) + (ch.clone(), extra)
        return run

    plain = outputs(lambda: k16(distcompact.glue_compose_plain))()
    n_need, n_moved = int(need.sum()), int((plain[0] != Q).any(dim=1).sum())
    copy_ms = _time_ms(copies)
    rows = []
    for name, kernel_fn, plain_fn, per_need in (
            ("glue_compose", lambda: k16(_kernels.glue_compose),
             lambda: k16(distcompact.glue_compose_plain), 8 + 32 + 32),
            ("glue_compose:round", lambda: glue_round(False),
             lambda: glue_round(True), 16 + 32 + 32)):
        if name == "glue_compose:round" and mesh is None:
            rows.append(None)
            continue
        r = check_kernel("glue_compose", launches, outputs(kernel_fn),
                         outputs(plain_fn), kernel_fn, plain_fn,
                         read_bytes=need.numel() + per_need * n_need,
                         written=17 * n_need + 32 * n_moved, label=name,
                         device=False)
        r["ms"] -= copy_ms
        r["plain_ms"] -= copy_ms
        if mesh is None:
            r["device_ms"], r["device_ops"] = _device_ms(kernel_fn,
                                                         only="glue_compose")
            r["library_device_ms"] = None
        r["rows"], r["need_step"], r["moved"] = Q.shape[0], n_need, n_moved
        if mesh is not None:
            with sends_of(mesh) as sends:
                kernel_fn()
            r["exchanges"] = exchange_times(mesh, sends)
            del sends
        rows.append(r)
    # the earlier K16's bound: Q, its ancestor rows and need read, every
    # row written
    rows[0]["bound_old_ms"] = _bound(3 * _nbytes(Q) + _nbytes(need), 0)[0]
    rows[0]["bound_old_what"] = "Q, anc and need read once, every row written"
    return rows[0], rows[1]


@contextlib.contextmanager
def sends_of(mesh):
    """The send buffers of the exchanges made inside the block (kept, not
    copied: no caller writes one after its exchange)."""
    sends, real = [], mesh.exchange

    def noted(send, with_valid=True):
        sends.append((send, with_valid))
        return real(send, with_valid)

    mesh.exchange = noted
    try:
        yield sends
    finally:
        del mesh.exchange


def exchange_times(mesh, sends, reps: int = 5) -> list:
    """CUDA-event ms of each (send buffer, with_valid) exchange under the
    NCCL group: the all_to_all_single alone, then Mesh.exchange (the
    all_to_all and the receive side) as its caller made it, and for a
    buffer with a validity channel also without the validity's compare."""
    import torch.distributed as dist

    out = []
    for send, with_valid in sends:
        got = torch.empty_like(send)
        out.append({
            "shape": tuple(send.shape), "validity": with_valid,
            "all_to_all": _time_ms(lambda: dist.all_to_all_single(got, send),
                                   reps),
            "exchange": _time_ms(lambda: mesh.exchange(send, with_valid),
                                 reps),
            "without_valid": (_time_ms(lambda: mesh.exchange(send, False),
                                       reps) if with_valid else None)})
        del got
    return out


def exchange_text(times) -> str:
    return "; ".join(
        f"{t['shape']}: all_to_all {t['all_to_all']:.4f}, Mesh.exchange "
        + (f"{t['exchange']:.4f} (without the validity's compare "
           f"{t['without_valid']:.4f})" if t["validity"]
           else f"{t['exchange']:.4f} (no validity channel)")
        for t in times) + " ms event"


def k3_step_row(entries_args, n_steps, dev, mesh):
    """K3's global step (distcompact.local_succ_shard: the entries, K15 and
    the exchange, the compaction of the valid received entries, the host
    read of their count n, torch.sort of those n, the pair rule on the
    sort's output, K15 and the exchange of the edges, the scatter into the
    successor shard) on the shard phase 3f's build gave its first call, at
    NCCL world size 1, against the same step with the plain versions of
    K3's global mode and of K15: the successor shard bitwise equal.  CUDA
    events only (no profiler session while the group is up).  The bound
    counts the solid shard read once and the successor shard written
    once.  The row also gives n and the host read's wall time (the wait
    for the step's queued work included), over 5 steps."""
    from bcalm_tpu_torch.ops import junctions
    from bcalm_tpu_torch.parallel import distcompact, pipeline

    solid, n_local, k = entries_args[0].to(dev), entries_args[1], entries_args[2]
    slot_cap = solid.shape[1]
    names = ("junction_entries", "junction_words", "junction_edges",
             "junction_scatter")

    def step():
        return distcompact.local_succ_shard(mesh, solid, n_local, k,
                                            4 * slot_cap, slot_cap)

    def plain_step():
        saved = ([getattr(junctions, n) for n in names],
                 distcompact.route_to_buckets)
        for n in names:
            setattr(junctions, n, getattr(junctions, n + "_plain"))
        distcompact.route_to_buckets = pipeline.route_to_buckets_plain
        try:
            return step()
        finally:
            for n, fn in zip(names, saved[0]):
                setattr(junctions, n, fn)
            distcompact.route_to_buckets = saved[1]

    r = check_kernel("junction_pairs", {}, step, plain_step, reads=solid,
                     written=16 * slot_cap, label="K3 global step",
                     replaces="bcalm_tpu/parallel/distcompact.py:53",
                     launched=n_steps, reps=5, device=False)
    r["slot_cap"], r["n_local"] = slot_cap, n_local
    reads, count = [], distcompact._host_count

    def timed_count(n_t):
        t0 = time.perf_counter()
        n = count(n_t)
        reads.append(((time.perf_counter() - t0) * 1e3, n))
        return n

    distcompact._host_count = timed_count
    try:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    finally:
        distcompact._host_count = count
    r["n_sorted"] = reads[0][1]
    r["host_read_ms"] = sum(t for t, _ in reads) / len(reads)
    with sends_of(mesh) as sends:
        step()
    r["exchanges"] = exchange_times(mesh, sends)
    del sends
    return r


def compaction_row(args, launches) -> dict:
    """The compaction in front of K3's global sort (junction_words) on the
    inputs of phase 3f's first step, (received rows (K+1, E), valid (E,)),
    against its plain version: the words and payloads at [0, n) and n
    (timed without the host read of n that the step makes).  The bound
    counts the validity read once, each valid slot's K+1 rows read, and
    its words and payload and the count written."""
    from bcalm_tpu_torch.ops import _kernels, junctions

    rows_w, valid = args
    K, n = rows_w.shape[0] - 1, int(valid.sum())

    def compacted():
        words, payload, n_t = _kernels.junction_words(rows_w, valid)
        m = int(n_t[0])
        return words[:, :m], payload[:m], n_t

    r = check_kernel("junction_words", launches, compacted,
                     lambda: junctions.junction_words_plain(rows_w, valid),
                     lambda: _kernels.junction_words(rows_w, valid),
                     read_bytes=valid.numel() + 8 * (K + 1) * n,
                     written=8 * ((K + 1) // 2 + 1) * n + 8)
    r["n"] = n
    r["launched_on"] = (f"phase 3f's build; {tuple(rows_w.shape)} received "
                        f"rows, {n} valid, compacted for the sort")
    return r


def scatter_row(args, launches, dev) -> dict:
    """The successor shard's scatter (junction_scatter) on the inputs of
    phase 3f's first step, (edges (2, R), ev (R,), tot, base, slot_cap),
    against its plain version.  The library call is the yardstick
    torch.Tensor.index_put_ of the valid edges' targets at their local
    slots computed beforehand, into a table filled with -1 (fill_, then
    index_put_): not the same function (no validity, no local ids, no
    drop of ids outside the table).  The bound counts the validity read
    once, 16 bytes a valid edge, and the table written once."""
    from bcalm_tpu_torch.ops import _kernels, junctions

    edges, ev, tot, base, slot_cap = args
    ea, eb = edges[0][ev], edges[1][ev]
    slot = torch.where(ea >= tot, ea - tot, ea) - base
    lidx = torch.where(ea >= tot, slot + slot_cap, slot)
    keep = (lidx >= 0) & (lidx < 2 * slot_cap)
    lidx, eb = lidx[keep].contiguous(), eb[keep].contiguous()
    table = torch.empty((2 * slot_cap,), dtype=torch.int64, device=dev)

    def library():
        return table.fill_(-1).index_put_((lidx,), eb)

    if not torch.equal(library(), _kernels.junction_scatter(*args)):
        raise AssertionError("the scatter's index_put_ yardstick differs from "
                             "the kernel")
    n_edges = int(ev.sum())
    r = check_kernel("junction_scatter", launches,
                     lambda: _kernels.junction_scatter(*args),
                     lambda: junctions.junction_scatter_plain(*args),
                     read_bytes=ev.numel() + 16 * n_edges, library=library)
    r["library_what"] = ("index_put_ at local slots computed beforehand into "
                         "a table filled with -1, not the same function")
    r["launched_on"] = (f"phase 3f's build; {n_edges} received edges into "
                        f"{2 * slot_cap} slots")
    return r


def glue_answer_rows(inputs, launches, reps=20) -> list:
    """K21 in each mode on the inputs phase 3f's build gave its first call
    of that mode (the first doubling round's rows, the run lookup, the uid
    lookup), bitwise against its plain version, with the mode's launches
    in that build (LAUNCHES' glue_answer_<mode>).  The library call is torch.index_select of
    the mode's table at the local rows computed beforehand (Q's rows; rid
    at the clipped slots; uid_at's rows): not the same function (no mask,
    no channel-major layout, one table).  The bound counts the answer
    written and each query's table sectors; rows: every slot's value read
    (its row is taken whether the slot is valid or not), and a sector for
    each slot whose row is not the one the empty slots share, and that
    one; run and uid: every slot's validity byte, and the value of each
    valid slot (8 bytes: a bucket's valid slots come first)."""
    from bcalm_tpu_torch.ops import _kernels
    from bcalm_tpu_torch.parallel import distcompact

    rows = []
    for mode, replaces in GLUE_ANSWER.items():
        args = inputs[f"glue_answer:{mode}"]
        _, vals, valid, tables, run_cap, n_dev, me = args
        c_tot, S = n_dev * run_cap, vals.shape[0]
        n_valid = int(valid.sum())
        if mode == "run":
            T = tables[0].shape[0]
            loc = torch.clamp(vals - me * T, 0, T - 1)
            sectors = sum(_gathered(t, n_valid) for t in tables) + 8 * n_valid
            per_slot = 1 + 16
        else:
            loc = torch.clamp(distcompact._gq_local(vals, run_cap, c_tot), 0,
                              2 * run_cap - 1)
            if mode == "rows":
                loc0 = int(torch.clamp(distcompact._gq_local(
                    torch.zeros(1, dtype=torch.int64, device=vals.device),
                    run_cap, c_tot), 0, 2 * run_cap - 1))
                sectors = _gathered(tables[0], int((loc != loc0).sum()) + 1)
                per_slot = 8 + 32
            else:
                sectors = _gathered(tables[0], n_valid) + 8 * n_valid
                per_slot = 1 + 8
        r = check_kernel("glue_answer", {}, lambda a=args: _kernels.glue_answer(*a),
                         lambda a=args: distcompact.glue_answer_plain(*a),
                         read_bytes=per_slot * S + sectors, written=0,
                         label=f"glue_answer:{mode}", replaces=replaces,
                         launched=launches[f"glue_answer_{mode}"],
                         library=lambda t=tables[0], l=loc: torch.index_select(t, 0, l),
                         reps=reps)
        r["slots"], r["valid"] = S, n_valid
        r["library_what"] = ("torch.index_select at the local rows computed "
                             "beforehand, not the same function")
        rows.append(r)
    return rows


def phase_kernels(inputs, launches, canon_hier, canon_launches, solid_table,
                  longk, phases, entry_solid, dev):
    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.models import lanes as ln
    from bcalm_tpu_torch.models import minimizer
    from bcalm_tpu_torch.ops import (_kernels, chains, count, hashing,
                                     junctions, runchains, superkmer)
    from bcalm_tpu_torch.parallel import distcompact, pipeline

    inputs = {name: _moved(args, dev) for name, args in inputs.items()}
    rows = []
    extra = []

    def check(name, *fns, row=True, **kw):
        r = check_kernel(name, launches, *fns, **kw)
        if row:
            rows.append(r)
        return r

    # K1 in each of its modes, on the inputs of the run that used it:
    # phase 3's first block, the received superkmers of phase 3f (per-row
    # slot bases) and phase 3b's first block in range mode
    words = inputs["extract_insert"][1]
    if inputs["extract_insert:row_base"][6] is None:
        raise AssertionError("phase 3f's K1 recorded no per-row slot bases")
    for key, label, counter, run_launches in (
            ("extract_insert", None, "extract_insert", launches),
            ("extract_insert:row_base", "extract_insert:row_base",
             "extract_insert", phases["3f"]),
            ("extract_insert:ranged", "extract_insert:ranged",
             "extract_insert_ranged", launches)):
        rows.append(k1_row(inputs[key], run_launches, label, counter, phases))
    # K2 on the sort's output: phase 3's first chunk count, phase 3b's
    # first chunk count and first LSM merge (weighted), and phase 3f's
    # first round count, each with the launches of its kind in its run
    # (count_sorted_weighted: the merges)
    k2_shapes = {}
    for key, launched in (
            ("count_sorted", launches["count_sorted"]),
            ("count_sorted:3b", phases["3b"]["count_sorted"]),
            ("count_sorted:weighted@3b", phases["3b"]["count_sorted_weighted"]),
            ("count_sorted:3f", phases["3f"]["count_sorted"])):
        c_args = inputs[key]
        k2_shapes[key] = [c_args[3], c_args[0].shape[0]]
        check("count_sorted", lambda a=c_args: _kernels.count_sorted(*a),
              lambda a=c_args: count.count_sorted_plain(*a),
              read_bytes=_count_bytes(*c_args), label=key, launched=launched)
        del c_args
    solid, n_solid, k, packed, rows_k = inputs["junction_keys"]
    check("junction_keys",
          lambda: _kernels.junction_keys(solid, n_solid, k, packed, rows_k),
          lambda: junctions.junction_keys_plain(solid, n_solid, k),
          reads=solid)
    jp_args = inputs["junction_pairs"]
    jp_read, jp_written = _pairs_bytes(*jp_args)
    check("junction_pairs", lambda: _kernels.junction_pairs(*jp_args),
          lambda: junctions.junction_pairs_plain(*jp_args),
          read_bytes=jp_read, written=jp_written)
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

    r4 = check("jump_round", jr_kernel, jr_plain,
               lambda: _kernels.jump_round(Q, Qn, changed),
               lambda: chains.jump_round_plain(Q), reads=Q)
    # what a launch of the flag mode costs after convergence (word 0 is 0,
    # so round 1 returns at once): a converging phase pays up to
    # _BATCH - 1 of them in its last batch
    idle = torch.zeros((2,), dtype=torch.int32, device=Q.device)
    r4["idle_launch_ms"] = _time_ms(
        lambda: _kernels.jump_round(Q, Qn, idle, at=1))
    if int(idle[1]):
        raise AssertionError("jump_round: a round after one that moved no "
                             "row set its flag word")
    say(f"[kernels] K4 at the deepest level ({Q.shape[0]} rows): a round "
        f"{r4['ms']:.4f} ms, a launch after convergence "
        f"{r4['idle_launch_ms']:.4f} ms (CUDA events)")

    k5_shapes = []
    for label, body, lo, hi, on_path in k5_chunks(
            inputs["extract_insert:ranged"], inputs.get("range_fold:owed")):
        rows.append(k5_row(body, lo, hi, launches, label, phases,
                           launched=None if on_path else 0))
        k5_shapes.append([label, tuple(body.shape), body.stride(0)])
    del body
    # K6 at the path's P = 1 (its recorded bound), then at P = 256 (256
    # quantile bounds in the same run, as a range split's pivots)
    run, n, bounds = inputs["lower_bound"]
    quantiles = run[:, (torch.arange(256, device=dev) + 1) * n // 257]
    for P, bds in ((bounds.shape[1], bounds), (256, quantiles.contiguous())):
        library = None
        if run.shape[0] <= 2:       # one packed int64 key per column
            packed_run = ln.pack_keys(list(run[:, :n]))[0].contiguous()
            packed_bounds = ln.pack_keys(list(bds))[0].contiguous()
            if not torch.equal(torch.searchsorted(packed_run, packed_bounds),
                               _kernels.lower_bound(run, n, bds)):
                raise AssertionError("lower_bound differs from torch.searchsorted")
            library = (lambda pr=packed_run, pb=packed_bounds:
                       torch.searchsorted(pr, pb))
        check("lower_bound", lambda b=bds: _kernels.lower_bound(run, n, b),
              lambda b=bds: count.lower_bound_plain(run, n, b),
              read_bytes=_search_bytes(run, n, bds), library=library,
              label=None if P == bounds.shape[1] else f"lower_bound@P{P}",
              launched=None if P == bounds.shape[1] else 0)
    sf_args = inputs["solid_fold_histogram"]
    check("solid_fold_histogram", lambda: _kernels.solid_fold_histogram(*sf_args),
          lambda: count.solid_fold_histogram_plain(*sf_args), reads=sf_args)
    succ, n_solid, C, gbase = inputs["run_scans"]
    check("run_scans", lambda: _kernels.run_scans(succ, n_solid, C, gbase),
          lambda: runchains.run_scans_plain(succ, n_solid, C, gbase),
          reads=succ[:n_solid])      # links are read for the solid entries
    # K8 with a nonzero global base (a rank of the sharded glue): the same
    # links, every successor shifted by it
    g8 = 3 * C
    succ_g = torch.where(succ >= 0, succ + g8, succ)
    r = check("run_scans", lambda: _kernels.run_scans(succ_g, n_solid, C, g8),
              lambda: runchains.run_scans_plain(succ_g, n_solid, C, g8),
              reads=succ_g[:n_solid], label="run_scans@gbase", launched=0,
              row=False)
    extra.append((f"run_scans with a global base of {g8} (phase 3's links, "
                  f"shifted)", r))
    del succ_g
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
          lambda: engine.spell_unitigs_plain(*su_args),
          read_bytes=_spell_bytes(*su_args))
    le_args = inputs["link_ends"]
    check("link_ends", lambda: _kernels.link_ends(*le_args),
          lambda: engine.link_ends_plain(*le_args),
          read_bytes=_link_ends_bytes(*le_args))
    lp_args = inputs["link_pairs"]
    # K23's words compared in their sorted order (its blocks land in any
    # order), the kernel alone timed
    check("link_pairs", lambda: _sorted_words(_kernels.link_pairs(*lp_args)),
          lambda: _sorted_words(engine.link_pairs_plain(*lp_args)),
          lambda: _kernels.link_pairs(*lp_args),
          lambda: engine.link_pairs_plain(*lp_args),
          read_bytes=_link_pairs_bytes(*lp_args))
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

    def k17(args, bits_args, row, where=None, counts=None):
        """K17 on a level's first-round input and the level's fixpoint
        bitmap (built once per level), each bitwise against its plain
        version.  The round's bound counts Q, the bitmap and gid (none at
        level 0) read once and Qn written once, and where the table
        exceeds L2 the target row's 32-byte sector of every query (each
        row not ROOTED): only then must a gathered row come from HBM again;
        bound_old_ms is PR 11's count (Q, valid and gid, at level 0 too,
        read once, Qn written once).  The bitmap's counts gid and valid
        read once and the bitmap written once.  where: the rows' label
        after the kernel's name; counts: the launches of the run the inputs
        come from (None: the resident run's)."""
        Q, Qn, gid, bits = args[:4]
        S = Q.shape[0]
        queries = int(((Q[:, 1] & chains._F_ROOTED) == 0).sum())

        def run():
            _kernels.hier_round(Q, Qn, gid, bits)
            return Qn

        r = check("hier_round", run,
                  lambda: chains.hier_round_plain(Q, gid, bits),
                  reads=(Q, bits) if gid is None else (Q, bits, gid),
                  read_bytes=32 * queries if 32 * S > L2_BYTES else 0,
                  written=_nbytes(Q), row=row,
                  label=None if where is None else "hier_round" + where,
                  launched=None if counts is None else counts["hier_round"])
        r["bound_old_ms"] = _bound(2 * _nbytes(Q) + 9 * S, 0)[0]
        r["bound_old_what"] = "Q, gid and valid once, no target sectors"
        b_gid, b_valid, b_salt = bits_args[:3]
        rb = check("fixpoint_bits",
                   lambda: _kernels.fixpoint_bits(b_gid, b_valid, b_salt),
                   lambda: chains.fixpoint_bits_plain(b_gid, b_valid, b_salt),
                   reads=(b_valid,) if b_gid is None else (b_valid, b_gid),
                   row=row,
                   label=None if where is None else "fixpoint_bits" + where,
                   launched=None if counts is None else counts["fixpoint_bits"])
        return r, rb

    # K17-K19 at level 0 of the resident run's hierarchical jump (the
    # rows) and of the canonical-order one (phase 3d, M = 2C)
    def hier_checks(hin, row):
        r17, r17b = k17(hin["hier_round"], hin["fixpoint_bits"], row)
        Qh = hin["hier_round"][0]
        Qc, gid_c, valid_c, salt_c, S1, big, _ = hin["hier_contract"]

        def contract(fn):
            def run():
                ok = torch.ones((1,), dtype=torch.int32, device=dev)
                return fn(Qc, gid_c, valid_c, salt_c, S1, big, ok) + (ok,)
            return run

        # timed with one `ok` made before, so the device operations counted
        # are the call's own
        ok_t = torch.ones((1,), dtype=torch.int32, device=dev)
        r18 = check("hier_contract", contract(_kernels.hier_contract),
                    contract(chains.hier_contract_plain),
                    lambda: _kernels.hier_contract(Qc, gid_c, valid_c, salt_c,
                                                   S1, big, ok_t),
                    lambda: chains.hier_contract_plain(Qc, gid_c, valid_c,
                                                       salt_c, S1, big, ok_t),
                    reads=(Qc, gid_c, valid_c), row=row)
        F, parent, Qd, did = hin["hier_expand"][:4]
        queries = int(((Qd[:, 1] & chains._F_ROOTED) == 0).sum())
        scratch = torch.empty_like(Qd)

        def over_copy():
            # as hier_jump runs it: over a level's phase-A state, here a
            # fresh copy of it each call
            return _kernels.hier_expand(F, parent, scratch.copy_(Qd), did)

        # Qd read once, 32 bytes written for each row not ROOTED (a ROOTED
        # row is not written), and of did, F and parent what the rows not
        # ROOTED gather (_gathered); ms and the device time are the
        # kernel's own: the copy's event time taken out, its device
        # operation not counted
        r19 = check("hier_expand", over_copy,
                    lambda: chains.hier_expand_plain(F, parent, Qd, did),
                    reads=Qd, read_bytes=sum(_gathered(t, queries)
                                             for t in (did, F, parent)),
                    written=32 * queries, row=row, device=False)
        r19["ms"] -= _time_ms(lambda: scratch.copy_(Qd), 20)
        r19["device_ms"], r19["device_ops"] = _device_ms(over_copy,
                                                         only="hier_expand")
        r19["library_device_ms"] = None
        r19["bound_old_ms"] = _bound(_nbytes((F, parent, Qd, did, Qd)), 0)[0]
        r19["bound_old_what"] = "F, parent, Qd and did read once, every row written"
        del scratch
        return (Qh.shape[0], S1), (r17b, r17, r18, r19)

    res_shape, _ = hier_checks({n: inputs[n] for n in HIER}, True)
    canon = {n: tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                      for a in args) for n, args in canon_hier.items()}
    (S_c, S1_c), rs = hier_checks(canon, False)
    for name, r in zip(HIER, rs):
        extra.append((f"{name} at level 0 of the canonical-order compaction "
                      f"(phase 3d: {S_c} -> {S1_c} rows)", r))
    # K17 at level 1 of the canonical-order compaction and K10 at its M
    # (phase 3d), with that run's launches (K17: all its levels')
    up = canon["hier_round:upper"]
    k17(up, canon["fixpoint_bits:upper"], True,
        where=f"@canonical level 1 ({up[0].shape[0]} rows)",
        counts=canon_launches)
    cf_c = canon["chain_finish"]
    check("chain_finish", lambda: _finish_tuple(_kernels.chain_finish(*cf_c)),
          lambda: _finish_tuple(chains.finish_fast_plain(*cf_c)), reads=cf_c,
          label=f"chain_finish@M={cf_c[0].shape[0]}",
          launched=canon_launches["chain_finish"])

    def k4_plain(q0, launched, rounds, where):
        """K4 on the first round of a plain run (chains.plain_jumpF) at its
        M (launches 0: phase 3's path jumps hierarchically; the plain
        run's own launches and round counts beside them); its bound counts
        the state read and written once and, where the state exceeds L2,
        the target row's sector of every row not ROOTED.  Below _HIER_MIN
        the CLI runs this variant: the launches of phase 3h's k = 255
        build, whose jump did not go hierarchical, are its CLI launches.
        The converging phase (the flag mode: one round, then batches of
        chains._BATCH rounds) is held against plain rounds on the card run
        until a round moves no row."""
        qn = torch.empty_like(q0)
        changed = torch.zeros((1,), dtype=torch.int32, device=dev)
        queries = int(((q0[:, 1] & chains._F_ROOTED) == 0).sum())

        def run():
            changed.zero_()
            _kernels.jump_round(q0, qn, changed)
            return qn.clone(), changed.bool()

        def plain():
            new = chains.jump_round_plain(q0)
            return new, torch.tensor([not torch.equal(new, q0)], device=dev)

        r = check("jump_round", run, plain,
                  lambda: _kernels.jump_round(q0, qn, changed),
                  lambda: chains.jump_round_plain(q0), reads=q0,
                  read_bytes=32 * queries if _nbytes(q0) > L2_BYTES else 0,
                  written=_nbytes(q0), launched=0,
                  label=f"jump_round:plain@{where} (M={q0.shape[0]})")
        _, k255, k255_rounds = longk[LONG_K2]
        plain_path = not k255["hier_round"]
        r["cli_launches_below_hier_min"] = {
            f"{where}'s plain run": launched,
            f"3h k={LONG_K2}": k255["jump_round"] if plain_path else 0}
        r["cli_rounds_below_hier_min"] = {
            f"{where}'s plain run": rounds,
            f"3h k={LONG_K2}": k255_rounds if plain_path else None}
        cap = chains.max_rounds(q0.shape[0]) + 1
        chains.reset_rounds()
        got = chains._phase(q0.clone(), None, None, None, cap)
        r["converge"] = dict(chains.ROUNDS)
        want, moved = q0, 0
        while moved < cap:
            new = chains.jump_round_plain(want)
            if torch.equal(new, want):
                break
            want, moved = new, moved + 1
        if not torch.equal(got, want) or r["converge"]["moved"] != moved:
            raise AssertionError(f"jump_round's flag mode at {where}: the "
                                 f"converged state or its {moved} moving "
                                 f"rounds differ from plain rounds")

    k4_plain(*inputs["jump_round:plain"], "phase 3")
    k4_plain(*canon["jump_round:plain"], "phase 3d")
    del canon, up, cf_c

    # the -devices path (phase 3f): K13-K16 and K3's global mode


    # K14 in both modes on phase 3f's sampling (the first call of each:
    # every buffered round's rows in one launch), a row each, timed adding
    # into one histogram; then the whole sampling as the pipeline runs it,
    # both modes, each into a histogram it zeroes first
    k14_in = {}
    for mode in ("mmer", "load"):
        hw, hl, hk, hm, hrank, hload, _ = inputs[f"mmer_histograms:{mode}"]
        k14_in[mode] = (hw, hl, hk, hm, hrank, hload)
        n_pos = hw.shape[0] * 16 * hw.shape[1]
        acc = torch.zeros((4 ** hm,), dtype=torch.int64, device=dev)
        r = check("mmer_histograms",
                  lambda: _kernels.mmer_histograms(hw, hl, hk, hm, hrank, hload,
                                                   torch.zeros_like(acc)),
                  lambda: _k14_plain(hw, hl, hk, hm, hrank, hload),
                  kernel_timed=lambda: _kernels.mmer_histograms(
                      hw, hl, hk, hm, hrank, hload, acc),
                  reads=(hw, hl), written=_lookup_bytes(hrank, n_pos) + 8 * 4 ** hm,
                  ops=n_pos * (12 + (4 if hload else 0)),
                  label=None if mode == "mmer" else "mmer_histograms:load")
        _l2(r, _k14_atomics(hw, hl, hk, hm, hrank, hload), "L2 atomics")
    mw, ml, mk, mm_ = k14_in["mmer"][:4]
    lw, ll, lk, lm, lrank = k14_in["load"][:5]
    n_pos = mw.shape[0] * 16 * mw.shape[1]
    r = check("mmer_histograms",
              lambda: (superkmer.sample_cmmer_histogram(mw, ml, mk, mm_),
                       superkmer.sample_minimizer_load(lw, ll, lk, lm, lrank,
                                                       lrank is not None)),
              lambda: (_k14_plain(mw, ml, mk, mm_, None, False),
                       _k14_plain(lw, ll, lk, lm, lrank, True)),
              reads=(mw, ml), written=_lookup_bytes(lrank, n_pos) + 16 * 4 ** mm_,
              ops=n_pos * 28, label="mmer_histograms:sampling")
    _l2(r, sum(_k14_atomics(*k14_in[md]) for md in k14_in), "L2 atomics")
    (sw, sl, sk, sm, table, rank, max_span, Wn, bits, with_pos,
     pos_base) = inputs["form_superkmers"]
    P = 16 * sw.shape[1]
    n_pos = sw.shape[0] * P
    # per position: the canonical m-mer (a funnel shift, a bit reversal,
    # ~12 operations), the window minimum (van Herk/Gil-Werman: ~4), two
    # scans (5 shuffle steps each, ~20), Wn 16-base packs (~3 each); its
    # rank and owner are one 8-byte lookup each
    skm_ops = n_pos * (36 + 3 * Wn)
    skm_gathers = _lookup_bytes(table, n_pos) + _lookup_bytes(rank, n_pos)

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

    # K20's three modes on phase 3's solid k-mers (phase 3d's count table
    # of the same reads, counts >= 2) with phase 3f's frequency rank and
    # the 4-rank table; their launches are phase 3g's, on its own solid set
    values, kcounts = solid_table
    v = values[kcounts >= 2]
    lanes20 = torch.from_numpy(np.stack([v >> np.uint64(32),
                                         v & np.uint64(0xFFFFFFFF)])
                               .astype(np.int64)).to(dev)
    n20, m20 = lanes20.shape[1], sm
    for r in k20_rows(lanes20, K, m20, rank, table4,
                      launches["kmer_minimizers"], ""):
        r["launched_on"] = f"phase 3g's {entry_solid} solid k-mers"
        rows.append(r)
    del lanes20
    # K15 writes the exchange's send buffer: each call held bitwise against
    # its plain version with the fill word its run gave it, and once more
    # with the other one (0 as JAX fills, the sentinel as the count and the
    # reshard fill)
    def route_check(args, what, row=True, **kw):
        other = args[:6] + (0 if args[6] else ln.SENTINEL,) + args[7:]
        err = _max_err(_kernels.route_buckets(*other),
                       pipeline.route_to_buckets_plain(*other))
        if err != 0:
            raise AssertionError(f"{what}: K15 differs from its plain "
                                 f"version with fill word {other[6]}")
        return check("route_buckets", lambda: _kernels.route_buckets(*args),
                     lambda: pipeline.route_to_buckets_plain(*args), row=row,
                     **kw)

    stk, valid, owner, n_dev, cap, with_slots, fill, _ = inputs["route_buckets"]
    route_check(inputs["route_buckets"], "route_buckets",
                reads=(stk, valid, owner))
    rng = torch.Generator(device="cpu").manual_seed(0)
    for nd in (4, 8):
        syn = torch.randint(0, nd, (stk.shape[1],), generator=rng).to(dev)
        cap_nd = max(1, -(-2 * int(valid.sum()) // nd))
        r = route_check((stk, valid, syn, nd, cap_nd, True, fill),
                        f"route_buckets at {nd} destinations",
                        reads=(stk, valid, syn), row=False)
        extra.append((f"route_buckets at {nd} destinations (synthetic owners, "
                      f"cap {cap_nd}, with slots)", r))
    # the hash mode (owner = hash_lanes(k-mer) % n_dev, computed in the
    # kernel; none at one rank) on phase 3g's k-mers: as the world-size-1
    # count ran it (its row), and at 4 ranks, where the owners spread; then
    # the receive side of the exchange on those send buffers, the passes
    # Mesh.exchange makes after its all_to_all (a view and no pass at one
    # rank; the validity's compare where the caller takes it)
    hl, hv, _, hn, hcap, hslots, hfill, hvc = inputs["route_buckets:hash"]
    hcap4 = max(1, -(-2 * int(hv.sum()) // 4))
    for nd, cap_nd, slots_nd in ((hn, hcap, hslots), (4, hcap4, True)):
        r = route_check((hl, hv, None, nd, cap_nd, slots_nd, hfill, hvc),
                        f"route_buckets hash mode at {nd} ranks",
                        reads=(hl, hv), row=nd == hn, label="route_buckets:hash",
                        replaces="bcalm_tpu/parallel/pipeline.py:111",
                        launched=launches["route_buckets:hash"])
        spread = torch.bincount(
            (hashing.hash_lanes(hl) % nd)[hv], minlength=nd).tolist()
        if min(spread) == 0:
            raise AssertionError(f"route_buckets hash mode at {nd} ranks: "
                                 f"k-mers per owner {spread}")
        what = (f"route_buckets, hash mode at {nd} rank(s) ({hl.shape[1]} "
                f"slots of phase 3g's count, {int(hv.sum())} k-mers; per "
                f"owner {spread}; cap {cap_nd}; "
                f"{launches['route_buckets:hash']} launches in phase 3g)")
        if nd == hn:
            r["launched_on"] = what
        else:
            extra.append((what, r))
        send = _kernels.route_buckets(hl, hv, None, nd, cap_nd, False, hfill,
                                      hvc)[0]
        say(f"[exchange] receive side at {nd} rank(s) of phase 3g's count "
            f"(the send buffer {tuple(send.shape)}, K15's output as it is "
            f"sent: no send pass): " + receive_line(send, hvc))
        del send
    del hl, hv
    # K16 in place on the first round of phase 3f's sharded doubling
    r16, _ = glue_rows(inputs["glue_compose"], launches, dev)
    rows.append(r16)
    gQ = inputs["glue_compose"][0]
    ge = inputs["junction_entries"]
    r = check("junction_keys", lambda: _kernels.junction_entries(*ge),
              lambda: junctions.junction_entries_plain(*ge[:6]), reads=ge[0],
              row=False)
    extra.append((f"junction_keys, global mode (4 entries per k-mer, owner "
                  f"ranks; {tuple(ge[0].shape)}; "
                  f"{launches['junction_keys:global']} launch(es) in phase 3f)",
                  r))
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
    # K3's global mode after the exchange, on phase 3f's first step's
    # inputs: the compaction of the valid received slots into their sort
    # words and payloads (which reads a slot's rows only where it is
    # valid), the pair rule on the sort's output over those alone, the
    # successor shard's scatter (which reads a slot's edge only where the
    # slot is valid), with index_put_ at precomputed slots beside it
    rows.append(compaction_row(inputs["junction_words"], launches))
    gx = inputs["junction_edges"]
    r = check("junction_pairs", lambda: _kernels.junction_edges(*gx),
              lambda: junctions.junction_edges_plain(*gx),
              read_bytes=pair_rule_bytes(*gx[:3], gx[4]), row=False)
    r["bound_old_ms"] = _bound(_nbytes(gx[:4]) + 25 * gx[0].shape[0], 0)[0]
    r["bound_old_what"] = "every sorted top word, perm, word and payload read"
    extra.append((f"junction_pairs, global mode's pair rule on the sort's output "
                  f"({gx[0].shape[0]} sorted entries, the valid ones alone, "
                  f"{gx[2].shape[0]} word(s); "
                  f"{launches['junction_pairs:global']} launch(es) in phase 3f)",
                  r))
    rows.append(scatter_row(inputs["junction_scatter"], launches, dev))
    # K21 in its three modes on phase 3f's first calls
    rows += glue_answer_rows(inputs, launches)
    rows += longk_rows(longk, phases, dev)
    for r in rows:
        lib = ("" if r["library_ms"] is None
               else f", library call {r['library_ms']:.4f} ms"
               + (f" ({r['library_what']})" if "library_what" in r else ""))
        if "device_ms" in r:
            lib += (f"; device time {_fmt_ms(r['device_ms'])} ms "
                    f"[{r['device_ops']:g} device operations per call], "
                    f"library call's {_fmt_ms(r['library_device_ms'])} ms")
        if "bound_old_ms" in r:
            lib += (f"; the earlier bound ({r['bound_old_what']}) "
                    f"{r['bound_old_ms']:.4f} ms")
        if "l2_ops" in r:
            rate = r["l2_g_per_s"]
            lib += (f"; {r['l2_ops']} {r['l2_what']}, "
                    f"{'not measured' if rate is None else f'{rate:.1f}'} G/s "
                    f"on the device")
        by_phase = ""
        if "phase_launches" in r:
            by_phase = " (by phase: " + ", ".join(
                f"{ph} {n}" for ph, n in r["phase_launches"].items()) + ")"
        if "cli_launches_below_hier_min" in r:
            by_phase = " (the plain variant's runs: " + ", ".join(
                f"{ph} {n}" for ph, n in
                r["cli_launches_below_hier_min"].items()) + ")"
        if "launched_on" in r:
            by_phase = f" ({r['launched_on']})"
        say(f"[kernel] {r['name']}: equal to plain (bitwise), {r['ms']:.4f} ms "
            f"vs plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){lib}, {r['launches']} launches in the "
            f"full-size run{by_phase}")
    for what, r in extra:
        dev_ms = (f" / device {_fmt_ms(r['device_ms'])} ms" if "device_ms" in r
                  else "")
        if "bound_old_ms" in r:
            dev_ms += (f" (the earlier bound, {r['bound_old_what']}: "
                       f"{r['bound_old_ms']:.4f} ms)")
        say(f"[kernel] {what}: equal to plain, {r['ms']:.4f} ms{dev_ms} vs "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    shapes = {"extract_insert": tuple(words.shape), **k2_shapes,
              "junction_keys": tuple(solid.shape),
              "junction_pairs": [tuple(jp_args[0].shape), jp_args[4]],
              "jump_round": tuple(Q.shape), "range_fold": k5_shapes,
              "lower_bound": [tuple(run.shape), n, tuple(bounds.shape)],
              "solid_fold_histogram": tuple(sf_args[0].shape),
              "run_scans": [tuple(succ.shape), n_solid, C],
              "solid_compact": [tuple(sc_args[0].shape), sc_args[6]],
              "chain_finish": tuple(cf_args[3].shape),
              "spell_unitigs": [tuple(su_args[0].shape), su_args[6]],
              "link_ends": [le_args[1].shape[0], le_args[2]],
              "link_pairs": [tuple(lp_args[0].shape), lp_args[3]],
              "run_contract": [tuple(rc_args[0].shape), rc_args[4], rc_args[5]],
              "run_broadcast": [tuple(rb_args[3].shape), tuple(rb_args[0].shape)],
              "form_superkmers": [tuple(sw.shape), tuple(table.shape)],
              "mmer_histograms": [tuple(mw.shape), tuple(lw.shape)],
              "route_buckets": [tuple(stk.shape), n_dev, cap],
              "glue_compose": tuple(gQ.shape),
              "junction_entries": tuple(ge[0].shape),
              "junction_edges": tuple(gx[2].shape),
              "glue_answer": {m: inputs[f"glue_answer:{m}"][1].shape[0]
                              for m in GLUE_ANSWER},
              "hier (S, S1)": res_shape,
              "kmer_minimizers": [(2, n20), m20]}
    say(f"[shapes] {json.dumps(shapes)}")
    return rows


def longk_rows(longk, phases, dev):
    """Phase 5's rows at L = 10: each lane-dependent kernel on the inputs
    phase 3h's k = 151 build fed it, or made from them where that build
    does not run it (launches then 0): K5 and K6 on its first sorted chunk,
    K3's global mode and K20 on a 2^20-column slice of its solid table; and
    K9 in filter_abundance mode on its counted table.  K1 also at L = 16,
    on the k = 255 build's first block; then K3a at L = 16 on that build's
    solid table (its two reverse complements are O(k * lanes) per k-mer).
    Plain versions are timed over 5 calls (some take seconds at this
    width)."""
    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.models import lanes as ln
    from bcalm_tpu_torch.models import minimizer
    from bcalm_tpu_torch.ops import _kernels, count, junctions

    def on_card(recorded):
        return {name: tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                            for a in args) for name, args in recorded.items()}

    inputs, launches, _ = longk[LONG_K]
    inputs = on_card(inputs)
    rows = []
    L = (LONG_K + 15) // 16
    tag = f"@L{L}"

    def row(name, *fns, label=None, on_path=True, **kw):
        rows.append(check_kernel(name, launches, *fns,
                                 label=(label or name) + tag,
                                 launched=launches[name] if on_path else 0,
                                 reps=5, **kw))

    buf, words, lengths, k = inputs["extract_insert"][:4]
    if k != LONG_K or buf.shape[0] != L + 1:
        raise AssertionError(f"phase 3h recorded k = {k}, {buf.shape[0] - 1} lanes")
    rows.append(k1_row(inputs["extract_insert"], launches,
                       "extract_insert" + tag, "extract_insert", phases,
                       reps=5))
    del buf, words, lengths
    inputs2, launches2, _ = longk[LONG_K2]
    k255 = on_card({"extract_insert": inputs2["extract_insert"]})
    rows.append(k1_row(k255["extract_insert"], launches2,
                       f"extract_insert@L{(LONG_K2 + 15) // 16}",
                       "extract_insert", phases, reps=5))
    del k255
    # K3a writing the exact key's five packed words, and K3b on them (the
    # top word, the four lower words through perm where top words tie)
    solid, n_solid, k, packed, rows_k = inputs["junction_keys"]
    row("junction_keys",
        lambda: _kernels.junction_keys(solid, n_solid, k, packed, rows_k),
        lambda: junctions.junction_keys_plain(solid, n_solid, k), reads=solid)
    jp_args = inputs["junction_pairs"]
    jp_read, jp_written = _pairs_bytes(*jp_args)
    row("junction_pairs", lambda: _kernels.junction_pairs(*jp_args),
        lambda: junctions.junction_pairs_plain(*jp_args), read_bytes=jp_read,
        written=jp_written)
    del jp_args
    c_args = inputs["count_sorted"]
    row("count_sorted", lambda: _kernels.count_sorted(*c_args),
        lambda: count.count_sorted_plain(*c_args),
        read_bytes=_count_bytes(*c_args))
    # the build's first chunk, sorted
    top, perm, lower, L, _, pos = c_args
    s_lanes = ln.unpack_keys([top] + [lower[j][perm] for j in
                                      range(lower.shape[0])], L)
    pos = pos[perm]
    del c_args, top, perm, lower
    # K5 and K6 (the multi-pass count's, not on this resident path) on the
    # build's first sorted chunk: the middle third of its keys, and 256
    # quantile bounds as the range split's pivots
    n_valid = int((s_lanes[0] != 0xFFFFFFFF).sum())
    body = torch.cat([s_lanes, pos[None]]).contiguous()
    lo = tuple(int(x) for x in s_lanes[:, n_valid // 3].tolist())
    hi = tuple(int(x) for x in s_lanes[:, 2 * n_valid // 3].tolist())
    rows.append(k5_row(body, lo, hi, launches, "range_fold" + tag, phases,
                       launched=0, reps=5))
    del body
    qi = (torch.arange(256, device=dev) + 1) * n_valid // 257
    bounds = s_lanes[:, qi].contiguous()
    row("lower_bound", lambda: _kernels.lower_bound(s_lanes, n_valid, bounds),
        lambda: count.lower_bound_plain(s_lanes, n_valid, bounds),
        read_bytes=_search_bytes(s_lanes, n_valid, bounds), on_path=False)
    sf_args = inputs["solid_fold_histogram"]
    row("solid_fold_histogram", lambda: _kernels.solid_fold_histogram(*sf_args),
        lambda: count.solid_fold_histogram_plain(*sf_args), reads=sf_args)
    # K9 and its filter_abundance mode; their library call is the boolean
    # column index of the stacked rows (the solid columns alone, no tail)
    sc_args = inputs["solid_compact"]
    uq, cq, pq, nq, amin, amax = sc_args[:6]
    keep = ((torch.arange(uq.shape[1], device=dev) < nq) & (cq >= amin)
            & (cq <= amax))
    stacked_in = torch.cat([uq, cq[None], pq[None]])
    row("solid_compact", lambda: _kernels.solid_compact(*sc_args),
        lambda: count.solid_compact_plain(*sc_args), reads=sc_args,
        library=lambda: stacked_in[:, keep])
    stacked_in = stacked_in[:-1]
    fa_args = (uq, cq, nq, amin, amax)
    # filter_abundance: K9 without its minpos row, through its entry point
    rows.append(check_kernel(
        "solid_compact", launches, lambda: count.filter_abundance(*fa_args),
        lambda: count.filter_abundance_plain(*fa_args), reads=(uq, cq),
        label=f"filter_abundance{tag}", replaces="bcalm_tpu/ops/count.py:158",
        launched=0, reps=5, library=lambda: stacked_in[:, keep]))
    del stacked_in, keep
    su_args = inputs["spell_unitigs"]
    row("spell_unitigs", lambda: _kernels.spell_unitigs(*su_args),
        lambda: engine.spell_unitigs_plain(*su_args),
        read_bytes=_spell_bytes(*su_args))
    le_args = inputs["link_ends"]
    row("link_ends", lambda: _kernels.link_ends(*le_args),
        lambda: engine.link_ends_plain(*le_args),
        read_bytes=_link_ends_bytes(*le_args))
    lp_args = inputs["link_pairs"]
    row("link_pairs", lambda: _sorted_words(_kernels.link_pairs(*lp_args)),
        lambda: _sorted_words(engine.link_pairs_plain(*lp_args)),
        lambda: _kernels.link_pairs(*lp_args),
        lambda: engine.link_pairs_plain(*lp_args),
        read_bytes=_link_pairs_bytes(*lp_args))
    del le_args, lp_args
    # the mesh kernels (the -devices path, not run at long k here) on a
    # slice of the solid table
    n20 = min(n_solid, 1 << 20)
    sl = solid[:, :n20].contiguous()
    ge = (sl, n20, k, 0, n20, 1, junctions.entry_key_rows(k))
    row("junction_keys", lambda: _kernels.junction_entries(*ge),
        lambda: junctions.junction_entries_plain(*ge[:6]), reads=sl,
        label="junction_entries", on_path=False,
        replaces="bcalm_tpu/parallel/distcompact.py:53")
    # K20's three modes on that slice (phase 3g's chain gives it a rank
    # and a table; not on 3h's path)
    rows += k20_rows(sl, k, 10, *_rank_and_table(sl, k, 10), 0, tag, reps=5)
    del sl, inputs
    solid, n_solid, k, packed, rows_k = on_card(
        {"junction_keys": inputs2["junction_keys"]})["junction_keys"]
    rows.append(check_kernel(
        "junction_keys", launches2,
        lambda: _kernels.junction_keys(solid, n_solid, k, packed, rows_k),
        lambda: junctions.junction_keys_plain(solid, n_solid, k), reads=solid,
        label=f"junction_keys@L{solid.shape[0]}", reps=5))
    # K20 at L = 16 on a 2^20-column slice of the k = 255 solid table
    sl = solid[:, :min(n_solid, 1 << 20)].contiguous()
    del solid
    rows += k20_rows(sl, k, 10, *_rank_and_table(sl, k, 10), 0,
                     f"@L{sl.shape[0]}", reps=5)
    return rows


def phase_canonical_times(M: int, launches, inputs, peak_mb, dev):
    """Phase 3d's last step: the canonical-order compaction at full width
    (M = 2C oriented nodes) on the inputs that run fed it: the
    hierarchical vs the plain jump, and K10 against its plain version.
    Returns the K17-K19 inputs of its level 0, K17's of level 1, K10's and
    the plain variant's first K4 input with its launches (for phase 5)."""
    from bcalm_tpu_torch.ops import _kernels, chains

    cf_args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                    for a in inputs["chain_finish"])
    succ, pred, valid = cf_args[:3]
    _, plain = compare_jumps("canonical-order compaction (phase 3d)",
                             lambda v: chains.chain_decompose(succ, valid, v),
                             chains.init_state(pred, valid),
                             inputs["jump_round"][0].to(dev))
    got = _finish_tuple(_kernels.chain_finish(*cf_args))
    want = _finish_tuple(chains.finish_fast_plain(*cf_args))
    if _max_err(got, want) != 0:
        raise AssertionError("chain_finish differs from its plain version at "
                             "full width")
    k10 = _time_ms(lambda: _kernels.chain_finish(*cf_args), reps=5)
    k10_plain = _time_ms(lambda: chains.finish_fast_plain(*cf_args), reps=5)
    say(f"[multi] canonical-order compaction: M = {M} oriented nodes, "
        f"{launches['hier_round']} K17 rounds ({launches['fixpoint_bits']} "
        f"fixpoint bitmaps), {launches['jump_round']} K4 rounds in "
        f"its run; K10 {k10:.4f} ms (plain {k10_plain:.4f} ms), equal to its "
        f"plain version at M; device_peak_mb of the run {peak_mb}")
    return {name: inputs[name] for name in HIER + (
        "fixpoint_bits:upper", "hier_round:upper", "chain_finish")} | {
        "jump_round:plain": plain}


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
        ooc_launches, ooc_inputs, ooc = phase_ooc(tmp, fa, path, stats, dev)
        phase_resume(tmp, fa, path, stats)
        phase_server(tmp, (resident_args(fa), path, stats), ooc)
        phase_respawn(tmp, path, ooc)
        inputs["jump_round:plain"] = phase_hier_resident(inputs, dev)
        M, ms_launches, ms_inputs, table, peak_mb = phase_multi(
            tmp, fa, path, args.coverage, args.seed, dev)
        canon_hier = phase_canonical_times(M, ms_launches, ms_inputs, peak_mb,
                                           dev)
        del ms_inputs
        phase_auto(tmp, fa, path)
        (mesh_launches, mesh_inputs, entry_launches, entry_solid,
         mesh_ranged, mesh_rows) = phase_mesh(tmp, fa, path, table,
                                                          dev)
        phase_invariants(path, stats)
        longk = phase_longk(tmp, args.seed, dev)
    # each kernel is held against its plain version on the inputs of the
    # run whose path needs it, and reports that run's launches; K1 and K5
    # also their launches in each phase (3f: the -devices build and its
    # multi-pass branch; 3h: both long-k builds)
    phases = {"3": dict(launches), "3b": ooc_launches,
              "3f": {n: mesh_launches[n] + mesh_ranged[n]
                     for n in mesh_launches},
              "3h": {n: longk[LONG_K][1][n] + longk[LONG_K2][1][n]
                     for n in longk[LONG_K][1]}}
    inputs["lower_bound"] = ooc_inputs["lower_bound"]
    inputs["count_sorted:3b"] = ooc_inputs["count_sorted"]
    inputs["count_sorted:3f"] = mesh_inputs["count_sorted"]
    inputs["count_sorted:weighted@3b"] = ooc_inputs["count_sorted:weighted"]
    inputs["extract_insert:ranged"] = ooc_inputs["extract_insert:ranged"]
    inputs["extract_insert:row_base"] = mesh_inputs["extract_insert"]
    if "range_fold" in ooc_inputs:
        inputs["range_fold:owed"] = ooc_inputs["range_fold"]
    for kernel in ("range_fold", "lower_bound", "extract_insert_ranged"):
        launches[kernel] = ooc_launches[kernel]
    for kernel in ("form_superkmers", "mmer_histograms:mmer",
                   "mmer_histograms:load", "route_buckets",
                   "route_buckets:hash", "glue_compose") + GLOBAL_K3 + tuple(
                       f"glue_answer:{m}" for m in GLUE_ANSWER):
        inputs[kernel] = mesh_inputs[kernel]
    for kernel in ("form_superkmers", "mmer_histograms", "route_buckets",
                   "glue_compose", "junction_words",
                   "junction_scatter") + K21_MODES:
        launches[kernel] = mesh_launches[kernel]
    # K3a's and K3b's global modes (3f runs no local K3)
    launches["junction_keys:global"] = mesh_launches["junction_keys"]
    launches["junction_pairs:global"] = mesh_launches["junction_pairs"]
    launches["kmer_minimizers"] = entry_launches["kmer_minimizers"]
    launches["route_buckets:hash"] = entry_launches["route_buckets_hash"]
    del mesh_inputs
    rows = phase_kernels(inputs, launches, canon_hier, ms_launches, table, longk,
                         phases, entry_solid, dev)
    rows += mesh_rows
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
