"""Tests of the benchmark (cdbg_bench/): the generator, the reference and
its comparison, the control and the planted faults, the metric arithmetic
on a recorded trace, the result line, the data-driven discovery of cells
and metrics, and the import rules.

    python -m pytest cdbg_bench/ -q

CPU tests drive the harness at a few kbp with the port on the CPU
(BCALM_TORCH_DEVICE=cpu); the test marked ``cuda`` runs on a card and
skips without one.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import control  # noqa: E402
import gen  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402
import tracing  # noqa: E402

CELL = "ecoli_k31.resident"
# the cell's configuration at a test's size: 20 kbp of genome at 10x
SMALL = {"genome_len": 20000, "coverage": 10}


def small_spec(workload: str = CELL, root: str = ROOT, mod=run, **reads):
    spec = mod.load_spec(workload, root)
    spec["config"] = dict(spec["config"], reads=dict(
        spec["config"]["reads"], **dict(SMALL, **reads)))
    return spec


@pytest.fixture
def cpu_port(monkeypatch):
    monkeypatch.setenv("BCALM_TORCH_DEVICE", "cpu")


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def test_generator_counts_of_the_cells():
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = run.load_json(os.path.join(ROOT, bench["configs"][0]["file"]))
    n = gen.n_reads(cfg["reads"])
    assert n == cfg["at_seed_0"]["reads"] == 1533333
    occ = n * (cfg["reads"]["read_len"] - cfg["k"] + 1)
    assert occ == cfg["at_seed_0"]["kmer_occurrences"] == 183999960


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**33 + 5])
def test_generator_is_deterministic_per_seed(tmp_path, seed):
    cfg = dict(run.load_spec(CELL)["config"]["reads"], **SMALL)
    a, b, c = (str(tmp_path / x) for x in "abc")
    n = gen.write_reads(a, cfg, seed)
    assert n == gen.n_reads(cfg)
    gen.write_reads(b, cfg, seed)
    gen.write_reads(c, cfg, seed + 1)
    data = open(a, "rb").read()
    assert data == open(b, "rb").read()
    assert data != open(c, "rb").read()
    assert len(data) == n * (3 + cfg["read_len"] + 1)


# ---------------------------------------------------------------------------
# the reference against the port's brute-force oracle
# ---------------------------------------------------------------------------

def _circular_reads(path: str) -> None:
    """A circular 3 kbp genome read in 100 bp windows that wrap round."""
    rng = np.random.RandomState(4)
    g = "".join("ACGT"[c] for c in rng.randint(0, 4, 3000))
    gg = g + g[:200]
    with open(path, "w") as f:
        for i in range(0, 3000, 7):
            for c in range(2):
                f.write(f">r{i}_{c}\n{gg[i:i + 100]}\n")


@pytest.mark.parametrize("k,read_len,seed", [(31, 100, 3), (33, 80, 9),
                                             (151, 300, 1), (31, 0, 0)])
def test_reference_equals_brute_oracle(tmp_path, k, read_len, seed):
    from bcalm_tpu_torch.oracle import brute

    reads = str(tmp_path / "r.fa")
    if read_len:
        cfg = dict(genome_len=5000, repeat_frac=0.05, coverage=10,
                   read_len=read_len, err_rate=0.003, dup_frac=0.2)
        gen.write_reads(reads, cfg, seed)
    else:
        _circular_reads(reads)
    seqs = [x.strip() for x in open(reads) if not x.startswith(">")]
    want = brute.build(seqs, k, 2)
    sol = reference.reference(reads, k, 2, "cpu")
    out = str(tmp_path / "ref.unitigs.fa")
    reference.emit_fasta(sol, out)
    headers, got = reference.parse_fasta(out)
    circ = [u.is_circular for u in want.unitigs]
    mine = [s[:k - 1] == s[len(s) - k + 1:] for s in got]
    assert sum(mine) == sum(circ) == (read_len == 0)
    assert (brute.content_unitig_set(got, mine, k)
            == brute.content_unitig_set([u.seq for u in want.unitigs], circ,
                                        k))
    assert sum(h.count("L:") for h in headers) == len(want.links)
    assert sorted(h.split()[2] for h in headers) == sorted(
        f"KC:i:{u.kc}" for u in want.unitigs)
    checks, _ = reference.judge(sol, out)
    assert checks == dict.fromkeys(reference.CHECKS, 0)


def test_lookup_multiword(tmp_path):
    rng = np.random.RandomState(0)
    keys = [torch.from_numpy(rng.randint(0, 5, 400)) for _ in range(3)]
    perm = reference.lexsort(keys)
    keys = [k[perm] for k in keys]
    head = torch.ones(400, dtype=torch.bool)
    head[1:] = torch.stack([k[1:] != k[:-1] for k in keys]).any(0)
    keys = [k[head] for k in keys]
    q = [torch.from_numpy(rng.randint(0, 6, 300)) for _ in range(3)]
    got = reference.lookup(keys, q)
    table = {tuple(int(k[i]) for k in keys): i for i in range(keys[0].numel())}
    want = [table.get(tuple(int(x[j]) for x in q), -1) for j in range(300)]
    assert got.tolist() == want


# ---------------------------------------------------------------------------
# the control and the planted faults
# ---------------------------------------------------------------------------

def test_control_comes_out_not_correct():
    """The reference with counts from a count sketch, at the test's size
    with 2**16 counters (about as many k-mers a counter as the cells' 8 M
    distinct k-mers on 2**32 counters give no collision here: the cells'
    control uses 2**32), fails the comparison; with exact counts the
    reference passes it."""
    spec = small_spec()
    checks, _ = control.control(spec, 5, "cpu", bits=16)
    assert not all(checks[n] <= run.LIMITS[n] for n in checks)
    assert checks["kmer_errors"] > 0 and checks["abundance_errors"] > 0


def _alter_base(fasta_writer):
    real = fasta_writer.write_fasta

    def write_fasta(us, out, **kw):
        buf = io.StringIO()
        real(us, buf, **kw)
        lines = buf.getvalue().split("\n")
        s, i = lines[1], len(lines[1]) // 2
        lines[1] = s[:i] + "ACGT"[("ACGT".index(s[i]) + 1) % 4] + s[i + 1:]
        out.write("\n".join(lines))
    return write_fasta


def _alter_kc(fasta_writer):
    real = fasta_writer.format_header

    def format_header(us, i, *a, **kw):
        h = real(us, i, *a, **kw)
        return h.replace("KC:i:", "KC:i:1", 1) if i == 0 else h
    return format_header


def _half_reads(cli):
    real = cli._input_blocks

    def _input_blocks(*a, **kw):
        for blk in real(*a, **kw):
            lengths = blk.lengths.copy()
            lengths[1::2] = 0
            yield dataclasses.replace(blk, lengths=lengths)
    return _input_blocks


def _drop_link(fasta_writer):
    real = fasta_writer.format_header

    def format_header(us, i, *a, **kw):
        h = real(us, i, *a, **kw)
        return " ".join(f for j, f in enumerate(h.split())
                        if not (f.startswith("L:") and j == 4))
    return format_header


def _later_build_altered(fasta_writer):
    real = _alter_base(fasta_writer)
    plain = fasta_writer.write_fasta

    def write_fasta(us, out, **kw):
        last = os.path.basename(out.name) == "b1.unitigs.fa"
        return (real if last else plain)(us, out, **kw)
    return write_fasta


def _fails_after_warm_up(cli):
    real = cli.main
    calls = []

    def main(argv):
        calls.append(1)
        return real(argv) if len(calls) < 3 else 1
    return main


def _unchanged(fasta_writer):
    def write_fasta(us, out, **kw):
        return None   # the output file is left as the build opened it
    return write_fasta


FAULTS = {
    # an answer altered where it is produced
    "base_altered": ("fasta_writer", "write_fasta", _alter_base,
                     "kmer_errors"),
    "kc_altered": ("fasta_writer", "format_header", _alter_kc,
                   "abundance_errors"),
    "link_dropped": ("fasta_writer", "format_header", _drop_link,
                     "link_errors"),
    # half of the batch left out
    "half_the_reads": ("cli", "_input_blocks", _half_reads, "kmer_errors"),
    # a step that returns its state unchanged: the output never written
    "output_unchanged": ("fasta_writer", "write_fasta", _unchanged,
                         "kmer_errors"),
    # a later build of the window writes other bytes than the first
    "later_build_altered": ("fasta_writer", "write_fasta",
                            _later_build_altered, "builds_differ"),
    # a build of the window fails
    "build_fails": ("cli", "main", _fails_after_warm_up, "builds_failed"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_comes_out_not_correct(cpu_port, monkeypatch, fault):
    """A run on the CPU, the harness's look for a card skipped, with the
    timed path broken underneath: `correct` is false."""
    from bcalm_tpu_torch import cli
    from bcalm_tpu_torch.io import fasta_writer

    owner_name, attr, make, check = FAULTS[fault]
    owner = {"cli": cli, "fasta_writer": fasta_writer}[owner_name]
    monkeypatch.setattr(owner, attr, make(owner))
    out, checks = run.run(small_spec(), 2**31 + 3, 3.0, False, "cpu")
    assert out["attempted"] >= 2
    assert out["correct"] is False
    assert checks[check] > 0


def test_sound_run_is_correct(cpu_port):
    out, checks = run.run(small_spec(), 2**31 + 3, 0.5, False, "cpu")
    assert out["correct"] is True
    assert all(v == 0 for v in checks.values())


# ---------------------------------------------------------------------------
# metric arithmetic on a recorded trace
# ---------------------------------------------------------------------------

# a traced window of 1 s (ns): two builds, device work that overlaps, a
# count step span synchronised at both edges, and launch spans that are
# not: one whose kernel of the program runs after the span has closed
# (beside a fill, which is not the program's), one whose kernel runs
# later, and one whose launching call the profiler lost
RECORDED = {
    "spans": [("cdbg.window", 0, 1_000_000_000),
              ("cdbg.build", 0, 500_000_000),
              ("cdbg.count_step", 100_000_000, 200_000_000),
              ("cdbg.launch.count_sorted", 150_000_000, 160_000_000),
              ("cdbg.build", 500_000_000, 1_000_000_000),
              ("cdbg.launch.spell_unitigs", 540_000_000, 545_000_000),
              ("cdbg.assemble", 600_000_000, 900_000_000),
              ("cdbg.launch.spell_unitigs", 690_000_000, 695_000_000)],
    "device": [("sortKernel", 110_000_000, 140_000_000, 1),
               ("void count_sorted_kernel<false, false>", 165_000_000,
                185_000_000, 2),
               ("void at::native::FillFunctor", 160_000_000, 180_000_000, 3),
               ("spell", 550_000_000, 600_000_000, 4),
               ("spell", 700_000_000, 710_000_000, 5),
               ("outside", 1_500_000_000, 1_600_000_000, 6)],
    "launched": [(1, 105_000_000), (2, 155_000_000), (3, 157_000_000),
                 (4, 541_000_000), (6, 1_400_000_000)],
}


def test_trace_reduction():
    tr = tracing.reduce(RECORDED)
    assert tr["window_s"] == 1.0
    # 30 + (160..185) 25 + 50 + 10 ms, the last event past the window out
    assert tr["busy_s"] == pytest.approx(0.115)
    assert tr["span_device_s"]["cdbg.count_step"] == pytest.approx(0.055)
    # kernels counted by the host time of their launching call
    assert tr["launch_ops"] == [("count_sorted", 1), ("spell_unitigs", 1),
                                ("spell_unitigs", 0)]
    assert tr["device_ops"][0] == ["spell", pytest.approx(0.06)]
    assert len(tr["device_ops"]) == 4   # every operation, not the top
    gaps = dict((round(s, 6), n) for n, s in tr["idle_gaps"])
    assert gaps == {
        0.365: "cdbg.count_step 15ms > cdbg.build 340ms > "
               "cdbg.launch.spell_unitigs 5ms > cdbg.build 5ms",  # 185..550
        0.29: "cdbg.assemble 190ms > cdbg.build 100ms",          # 710..1000
        0.11: "cdbg.build 100ms > cdbg.count_step 10ms",          # 0..110
        0.1: "cdbg.assemble 90ms > cdbg.launch.spell_unitigs 5ms > "
             "cdbg.assemble 5ms",                                 # 600..700
        0.02: "cdbg.count_step 10ms > "
              "cdbg.launch.count_sorted 10ms"}                    # 140..160
    calls = [("count_sorted", 1), ("spell_unitigs", 1), ("spell_unitigs", 0)]
    assert run.launch_shortfall(calls, tr["launch_ops"], 2) is None
    lost = calls[:2] + [("spell_unitigs", 1)]
    assert "missed" in run.launch_shortfall(lost, tr["launch_ops"], 3)
    assert "do not match" in run.launch_shortfall(calls, tr["launch_ops"], 3)


def _record(trace=None):
    work = run.module("work", "count_step")
    lanes = torch.zeros((2, 1000), dtype=torch.int32)
    return {
        "setup": {"setup_s": 20.0, "port_start_s": 1.5},
        "bases": 230_000_000,
        "builds": [
            {"start": 10.0, "end": 13.0, "rc": 0, "peak_bytes": 3 << 30,
             "stats": {"t_count_s": 0.5, "t_assemble_s": 1.0,
                       "time:write": 0.3, "t_store_s": 0.1}},
            {"start": 13.1, "end": 16.0, "rc": 0, "peak_bytes": 4 << 30,
             "stats": {"t_count_s": 0.7, "t_assemble_s": 1.2,
                       "time:write": 0.5, "t_store_s": 0.1}}],
        "trace": trace,
        "host_spans": {"cdbg.compact": [0.010, 0.014]},
        "work": {"count_step": [
            work.of_call((lanes,), {"pos": lanes[0]}, (None,) * 3 + (600,)),
            work.bytes_moved(10, 500, True, True, 100)]},
        "device_kind": "NVIDIA H100 80GB HBM3",
        "peaks": run.load_json(os.path.join(HERE, "peaks.json")),
    }


def test_metric_arithmetic():
    rec = _record(tracing.reduce(RECORDED))
    m = {name: run.module("metrics", name).read(rec) for name in (
        "build_mbp_per_s", "device_peak_mib", "setup_s", "port_start_s",
        "count_s", "assemble_s", "write_s", "compact_ms", "device_idle_pct",
        "count_step_roofline_pct")}
    assert m["build_mbp_per_s"] == pytest.approx(2 * 230 / 6.0)
    assert m["device_peak_mib"] == 4096
    assert m["setup_s"] == 20.0 and m["port_start_s"] == 1.5
    assert m["count_s"] == pytest.approx(0.6)
    assert m["assemble_s"] == pytest.approx(1.1)
    assert m["write_s"] == pytest.approx(0.5)
    assert m["compact_ms"] == pytest.approx(24.0)
    assert m["device_idle_pct"] == pytest.approx(88.5)
    # 1000 x (8 + 8) + 600 x (8 + 8 + 8); 500 x (40 + 16) + 100 x (40 + 16)
    assert sum(rec["work"]["count_step"]) == 30400 + 33600
    assert m["count_step_roofline_pct"] == pytest.approx(
        100 * 64000 / 3.35e12 / 0.055)


def test_metrics_absent_without_their_data():
    rec = _record()
    rec["builds"] = [dict(b, peak_bytes=None, stats={}) for b in rec["builds"]]
    rec["host_spans"], rec["work"] = {}, {}
    for name in ("device_peak_mib", "count_s", "compact_ms", "device_idle_pct",
                 "count_step_roofline_pct"):
        assert run.module("metrics", name).read(rec) is None


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(cpu_port, trace):
    out, checks = run.run(small_spec(), 12, 0.5, bool(trace), "cpu")
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    names = {m["name"] for m in run.load_spec(CELL)[
        "per_layer" if trace else "end_to_end"]}
    assert set(out["metrics"]) <= names
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "compact_ms" in out["metrics"]
    else:
        assert {"build_mbp_per_s", "setup_s"} <= set(out["metrics"])
    assert set(checks) == set(run.LIMITS)
    json.dumps(out)


def test_traced_segment_retried(cpu_port, monkeypatch):
    """A traced build whose launch cross-check falls short is thrown away
    and the next build is traced; when every traced build falls short the
    run fails."""
    verdicts = iter(["missed"] + [None] * 10)
    monkeypatch.setattr(run, "launch_shortfall",
                        lambda *a: next(verdicts))
    out, _ = run.run(small_spec(), 12, 8.0, True, "cpu")
    assert out["attempted"] >= 2 and "compact_ms" in out["metrics"]
    monkeypatch.setattr(run, "launch_shortfall", lambda *a: "missed")
    with pytest.raises(RuntimeError, match="each of"):
        run.run(small_spec(), 12, 1.0, True, "cpu")


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# data-driven: a metric and a traffic file added are found by name
# ---------------------------------------------------------------------------

def test_added_metric_and_traffic_are_found(cpu_port, tmp_path):
    """A copy of the benchmark with a traffic file, an end-to-end metric
    and two per-layer metrics added (one declares a span, one reads the
    program's counters) and their BENCHMARK.json entries: the harness
    finds each by name, spans what the metric declares, and keeps the
    counters in each build's record."""
    import importlib.util

    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "cdbg_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    metrics = root / "cdbg_bench" / "metrics"
    (metrics / "builds_done.py").write_text(
        "def read(rec):\n    return float(len(rec['builds']))\n")
    (metrics / "count_host_s.py").write_text(
        "SPANS = [{'target': 'bcalm_tpu_torch.engine:count_blocks',\n"
        "          'name': 'cdbg.count', 'sync': True}]\n\n\n"
        "def read(rec):\n"
        "    return sum(rec['host_spans'].get('cdbg.count', [])) or None\n")
    (metrics / "rounds_per_build.py").write_text(
        "def read(rec):\n"
        "    c = [b['counters'] for b in rec['builds']]\n"
        "    assert all(set(x) == {'launches', 'rounds'} for x in c)\n"
        "    return sum(x['rounds'].get('launched', 0) for x in c) / len(c)\n")
    (root / "cdbg_bench" / "traffic" / "two_cores.json").write_text(
        json.dumps({"flags": ["-nb-cores", "2"]}))
    cell = "ecoli_k31.two_cores"
    bench["workloads"].append({"name": cell, "config": "ecoli_k31",
                               "traffic": "two_cores", "chips": 1,
                               "why": "a test's cell"})
    bench["end_to_end"].append({"name": "builds_done", "unit": "builds",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": [cell]})
    for name in ("count_host_s", "rounds_per_build"):
        bench["per_layer"].append({"name": name, "unit": "s",
                                   "better": "lower", "source": "host_clock",
                                   "layer": "counting",
                                   "moves": "builds_done",
                                   "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = importlib.util.spec_from_file_location(
        "cdbg_bench_copy_run", root / "cdbg_bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    s = small_spec(cell, str(root), mod)
    assert s["traffic"]["flags"] == ["-nb-cores", "2"]
    out, _ = mod.run(s, 4, 0.3, False, "cpu")
    assert out["metrics"]["builds_done"]["value"] == out["attempted"]
    assert out["correct"] is True
    assert mod.span_plan(s)["bcalm_tpu_torch.engine:count_blocks"] == {
        "name": "cdbg.count", "sync": True, "work": None}
    out, _ = mod.run(s, 4, 0.3, True, "cpu")
    assert set(out["metrics"]) == {"count_host_s", "rounds_per_build"}
    assert out["metrics"]["count_host_s"]["value"] > 0
    assert out["correct"] is True


def test_span_declarations_must_agree(monkeypatch):
    """Two declarations of one target under different span names are
    refused; the same name merges, synchronised if either asks."""
    spec = run.load_spec(CELL)
    plan = run.span_plan(spec)
    assert plan["bcalm_tpu_torch.ops.count:count_canonical"] == {
        "name": "cdbg.count_step", "sync": True, "work": "count_step"}
    assert plan["bcalm_tpu_torch.engine:count_blocks"]["sync"] is False
    monkeypatch.setattr(run, "STAGE_SPANS", run.STAGE_SPANS + (
        {"target": "bcalm_tpu_torch.engine:compact_solid_pos",
         "name": "cdbg.other"},))
    with pytest.raises(ValueError, match="spanned as both"):
        run.span_plan(spec)


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def _imports(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, HERE) for p in _sources()))
def test_imports(path):
    names = set(_imports(os.path.join(HERE, path)))
    assert not names & set(run.FORBIDDEN), path
    # the reference, its generator, the trace reduction and the yardstick's
    # files import nothing of the program
    if path not in ("run.py", "test_cdbg_bench.py"):
        assert "bcalm_tpu_torch" not in names, path


def test_no_forbidden_module_after_a_run(cpu_port):
    run.run(small_spec(), 5, 0.3, False, "cpu")
    assert run.forbidden_loaded() == []


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_reference_on_the_card_equals_cpu(card, tmp_path):
    cfg = dict(run.load_spec(CELL)["config"]["reads"], **SMALL)
    reads = str(tmp_path / "r.fa")
    gen.write_reads(reads, cfg, 3)
    out = str(tmp_path / "ref.unitigs.fa")
    reference.emit_fasta(reference.reference(reads, 31, 2, "cpu"), out)
    sol = reference.reference(reads, 31, 2, card)
    checks, _ = reference.judge(sol, out)
    assert checks == dict.fromkeys(reference.CHECKS, 0)
