"""Smoke run of bcalm_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--coverage 50] [--seed 0]

Phases (any failure raises, and the script exits non-zero):

1. device: card name, power limit, kernel build time;
2. fixtures: the port's build on the card vs the brute-force oracle on the
   reference fixtures, and the card's FASTA vs the CPU plain path's on a
   branching input;
3. full-size CLI run: an E. coli-class genome (4.6 Mbp, 5% repeats) read
   at 50x with 150 bp reads, 0.08% errors and 20% duplicates, built with
   ``-kmer-size 31 -abundance-min 2``, first as ``python -m
   bcalm_tpu_torch``, then through ``bcalm_tpu_torch.cli.main`` in this
   process, whose kernel launch counters are reset just before the call;
4. output invariants of that run: each solid canonical k-mer once, KC
   sums, every L: link a real (k-1)-overlap;
5. each kernel vs its plain PyTorch version on the card, on the inputs the
   full-size run fed it: bitwise equality, CUDA-event times, launches.

The last line is {"ok": true, "device": {...}}.  Exits 1 without a result
when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
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
}


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
    return name, smi


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
    from bcalm_tpu.oracle import brute
    from bench import make_genome, sample_reads
    from bcalm_tpu_torch import engine

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


def write_reads(path: str, coverage: float, seed: int) -> int:
    from bench import make_genome, sample_reads
    from bcalm_tpu.utils import dna

    rng = np.random.RandomState(seed)
    genome = make_genome(4_600_000, rng, repeat_frac=0.05)
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


class Recorder:
    """Keeps the first inputs each kernel wrapper received (cloned before
    the call, since extract_insert writes in place)."""

    def __init__(self, kmod):
        self.kmod = kmod
        self.inputs = {}
        self.saved = {n: getattr(kmod, n) for n in KERNELS}

    def _wrap(self, name):
        fn = self.saved[name]

        def recorded(*args):
            if name not in self.inputs:
                self.inputs[name] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            return fn(*args)
        return recorded

    def __enter__(self):
        for n in KERNELS:
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


def phase_full(tmp: str, coverage: float, seed: int):
    """The CLI once as `python -m bcalm_tpu_torch` (a user's run), then once
    through cli.main in this process with the launch counters reset just
    before it; both outputs must be byte-identical."""
    from bcalm_tpu_torch import cli
    from bcalm_tpu_torch.ops import _kernels

    fa = os.path.join(tmp, "reads.fa")
    t0 = time.time()
    n_reads = write_reads(fa, coverage, seed)
    say(f"[input] {n_reads} reads of 150 bp (4.6 Mbp genome, {coverage}x, "
        f"seed {seed}) written in {time.time() - t0:.1f}s")
    args = ["-in", fa, "-kmer-size", str(K), "-abundance-min", "2",
            "-verbose", "1"]
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "bcalm_tpu_torch", *args, "-out",
         os.path.join(tmp, "sub")], cwd=repo, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=repo), timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"python -m bcalm_tpu_torch exited "
                           f"{proc.returncode}:\n{proc.stderr}")
    _report("python -m bcalm_tpu_torch -kmer-size 31 -abundance-min 2 "
            "(process start included)", wall, _stats(proc.stdout))

    out = io.StringIO()
    with Recorder(_kernels) as rec:
        _kernels.reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(args + ["-out", os.path.join(tmp, "ec")])
        wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"cli.main exited {rc}:\n{out.getvalue()}")
    stats = _stats(out.getvalue())
    _report("cli.main, same arguments, in this process", wall, stats)
    path = os.path.join(tmp, "ec.unitigs.fa")
    with open(path, "rb") as f1, open(os.path.join(tmp, "sub.unitigs.fa"), "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("the two CLI runs wrote different unitigs")
    say(f"[launches] {json.dumps(launches)}")
    for name in KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    return path, stats, launches, rec.inputs


def _canonical_kmers(seqs, k: int) -> np.ndarray:
    """Canonical 2k-bit values of every k-mer of every sequence (k <= 32)."""
    from bcalm_tpu.io import packing

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


def phase_kernels(inputs, launches):
    from bcalm_tpu_torch.ops import _kernels, chains, count, extract, junctions

    rows = []

    def check(name, kernel_fn, plain_fn, kernel_timed=None, plain_timed=None):
        """Bitwise check of kernel_fn() vs plain_fn(); the *_timed variants
        (default: the same calls) are what the CUDA events time."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = _max_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max abs err {err})")
        rows.append({"name": name, "route": "cuda", "source": KERNELS[name][0],
                     "replaces": KERNELS[name][1], "launches": launches[name],
                     "max_abs_err": err, "ms": _time_ms(kernel_timed or kernel_fn),
                     "plain_ms": _time_ms(plain_timed or plain_fn)})

    # K1 writes in place: compare on fresh copies of the recorded buffer,
    # time into one preallocated buffer (no 0.8 GB clone inside the timing)
    buf, words, lengths, k, slot_base, offset = inputs["extract_insert"]
    ext_args = (words, lengths, k, slot_base, offset)
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
          lambda: extract.extract_insert_plain(scratch, *ext_args))
    s_lanes, w, pos = inputs["count_runs"]
    check("count_runs", lambda: _kernels.count_runs(s_lanes, w, pos),
          lambda: count.count_runs_plain(s_lanes, w, pos))
    solid, n_solid, k, hashed, rows_k = inputs["junction_keys"]
    check("junction_keys",
          lambda: _kernels.junction_keys(solid, n_solid, k, hashed, rows_k),
          lambda: junctions.junction_keys_plain(solid, n_solid, k))
    s_keys, s_pay, C, hashed = inputs["junction_pairs"]
    check("junction_pairs", lambda: _kernels.junction_pairs(s_keys, s_pay, C, hashed),
          lambda: junctions.junction_pairs_plain(s_keys, s_pay, C, hashed))
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
          lambda: chains.jump_round_plain(Q))
    for r in rows:
        say(f"[kernel] {r['name']}: equal to plain (bitwise), {r['ms']:.4f} ms "
            f"vs plain {r['plain_ms']:.4f} ms, {r['launches']} launches in the "
            f"full-size run")
    shapes = {"extract_insert": tuple(words.shape), "count_runs": tuple(s_lanes.shape),
              "junction_keys": tuple(solid.shape), "junction_pairs": tuple(s_keys.shape),
              "jump_round": tuple(Q.shape)}
    say(f"[shapes] {json.dumps(shapes)}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coverage", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    name, smi = phase_device()
    phase_fixtures(dev, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        path, stats, launches, inputs = phase_full(tmp, args.coverage, args.seed)
        phase_invariants(path, stats)
    rows = phase_kernels(inputs, launches)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
