"""The port's stage spans (utils/timeinfo.py): the recorder's totals, calls
and nesting, the profiler ranges they open only while torch's profiler
records, the CLI's -verbose report, the engine's t_*_s stats read from
them, the junction step's span and key-word stat, the benchmark's readers
of them, and their names against the names the benchmark uses."""

import ast
import importlib.util
import json
import pathlib
import re
import time

import numpy as np
import pytest
import torch

from bcalm_tpu_torch import cli as tcli
from bcalm_tpu_torch import engine
from bcalm_tpu_torch.io import packing
from bcalm_tpu_torch.ops import junctions
from bcalm_tpu_torch.storage.store import Store
from bcalm_tpu_torch.utils import timeinfo
from bcalm_tpu_torch.utils.timeinfo import TRACE_PREFIX, TimeInfo, span

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "cdbg_bench"
# the spans of a resident single-device CLI build (the benchmark's cell)
CLI_SPANS = {"build", "count", "count.pass", "count.ingest_wait",
             "count.upload", "count.final_merge", "solid", "compaction",
             "compaction.junctions", "checkpoint", "assemble",
             "assemble.spell", "assemble.links", "write", "remove_store"}
# every span the program opens
ALL_SPANS = CLI_SPANS | {
    "count.settle_wait", "count.split", "count.split.merge",
    "count.fetch_wait", "store", "compact", "load_counts",
    "build_distributed"}


def _reads(n, seed=3, genome_len=6000, read_len=60):
    rng = np.random.RandomState(seed)
    g = "".join("ACGT"[c] for c in rng.randint(0, 4, genome_len))
    starts = rng.randint(0, genome_len - read_len, n)
    return [g[s:s + read_len] for s in starts]


def _write_fasta(path, reads):
    with open(path, "w") as f:
        f.write("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))


def test_recorder_totals_calls_and_nesting():
    ti = TimeInfo()
    with ti.active():
        with span("outer") as outer:
            for _ in range(3):
                with span("outer.inner") as inner:
                    time.sleep(0.002)
    assert ti.spans["outer"] == [outer.seconds, 1]
    assert ti.spans["outer.inner"][1] == 3 and inner.seconds >= 0.002
    assert 0.006 <= ti.spans["outer.inner"][0] <= outer.seconds
    # a span that ends in an exception adds its time but no call
    with ti.active():
        with pytest.raises(StopIteration):
            with span("outer.inner") as failed:
                raise StopIteration
    assert ti.spans["outer.inner"][1] == 3
    assert ti.spans["outer.inner"][0] >= 0.006 + failed.seconds
    # a recorder made active inside another keeps its own spans
    inner_ti = TimeInfo()
    with ti.active():
        with inner_ti.active():
            with span("request"):
                pass
        with span("after"):
            pass
    assert set(inner_ti.spans) == {"request"}
    assert "request" not in ti.spans and ti.spans["after"][1] == 1
    # with no recorder active a span measures itself and records nowhere
    with span("alone") as sp:
        time.sleep(0.001)
    assert sp.seconds >= 0.001 and "alone" not in ti.spans
    lines = ti.report_lines()
    assert lines[0].startswith("[time:outer") and "[calls:outer] 1" not in lines
    assert "[calls:outer.inner] 3" in lines
    # a child stage reports its calls even where it ran once
    one = TimeInfo()
    with one.active():
        with span("outer"):
            with span("outer.inner"):
                pass
    assert "[calls:outer.inner] 1" in one.report_lines()
    assert not any(l.startswith("[calls:outer]") for l in one.report_lines())
    assert all(re.fullmatch(r"\[time:[\w.]+\] \d+\.\d{4}s", l)
               for l in lines if l.startswith("[time:"))


def test_untraced_build_enters_no_record_function(monkeypatch):
    """No profiler: no range is entered.  Under one, a span enters its
    range (torch's user-range call, the one record_function makes)."""
    entered = []
    real = torch._C._autograd._record_function_with_args_enter

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch._C._autograd,
                        "_record_function_with_args_enter", counting)
    ti = TimeInfo()
    with ti.active():
        us = engine.build_from_seqs(_reads(300), engine.EngineConfig(k=21),
                                    "cpu")
    assert us.seqs and {"count", "assemble.links"} <= set(ti.spans)
    assert entered == []
    # under the profiler the same spans enter their ranges
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("count"):
            pass
    assert entered == [TRACE_PREFIX + "count"]


def _program_ranges(prof):
    """name -> (total ns, count) of the cdbg.bcalm.* annotations of a
    finished profile, read as cdbg_bench/tracing.collect reads them."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name().startswith(TRACE_PREFIX):
            tot, n = out.get(e.name(), (0, 0))
            out[e.name()] = (tot + e.end_ns() - e.start_ns(), n + 1)
    return out


def test_profiler_sees_the_program_spans(tmp_path, monkeypatch):
    fa = tmp_path / "reads.fa"
    _write_fasta(fa, _reads(600))
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    seen = []
    real_add = TimeInfo.add

    def add(self, name, seconds, calls=1):
        seen.append(self)
        real_add(self, name, seconds, calls)

    monkeypatch.setattr(TimeInfo, "add", add)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tcli.main(["-in", str(fa), "-kmer-size", "21",
                          "-abundance-min", "2", "-verbose", "0",
                          "-out", str(tmp_path / "o")]) == 0
    ranges = _program_ranges(prof)
    assert {TRACE_PREFIX + n for n in CLI_SPANS} <= set(ranges)
    ti = seen[0]
    assert all(t is ti for t in seen)
    # one clock: each range's total on the profiler's clock holds the
    # program's own total, within 1 ms + 1%
    for name in ("assemble.spell", "assemble.links", "count.ingest_wait",
                 "count", "build"):
        prog = ti.spans[name][0]
        trace = ranges[TRACE_PREFIX + name][0] / 1e9
        assert abs(trace - prog) <= 1e-3 + 0.01 * prog, (name, prog, trace)


def _stats(text):
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("[") and "] " in line:
            key, val = line[1:].split("] ", 1)
            out[key] = val
    return out


def test_cli_verbose_prints_span_times_and_calls(tmp_path, monkeypatch,
                                                 capsys):
    fa = tmp_path / "reads.fa"
    _write_fasta(fa, _reads(9000, read_len=40))
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    blocks = []
    real = tcli._input_blocks

    def counting(*a, **kw):
        for blk in real(*a, **kw):
            blocks.append(blk.words.shape[0])
            yield blk

    monkeypatch.setattr(tcli, "_input_blocks", counting)
    assert tcli.main(["-in", str(fa), "-kmer-size", "21", "-abundance-min",
                      "2", "-verbose", "1", "-out", str(tmp_path / "o")]) == 0
    st = _stats(capsys.readouterr().out)
    assert len(blocks) > 1
    assert int(st["calls:count.ingest_wait"]) == len(blocks)
    assert int(st["calls:count.upload"]) == len(blocks)
    for name in CLI_SPANS:
        assert re.fullmatch(r"\d+\.\d{4}s", st[f"time:{name}"]), name
    for name in ("build", "write", "count", "assemble"):
        assert f"calls:{name}" not in st
    assert st["calls:compaction.junctions"] == "1"
    assert "ingest_mbps" not in st
    # the stats keep their keys, rounded from the spans' totals
    assert float(st["t_count_s"]) == pytest.approx(
        float(st["time:count"][:-1]), abs=0.0051)
    # a second command line in the process (a -server request) reports
    # its own spans only
    blocks.clear()
    assert tcli.main(["-in", str(fa), "-kmer-size", "21", "-abundance-min",
                      "2", "-verbose", "1", "-out", str(tmp_path / "o2")]) == 0
    again = _stats(capsys.readouterr().out)
    assert int(again["calls:count.ingest_wait"]) == len(blocks)
    assert "calls:build" not in again


@pytest.mark.parametrize("k,words", [(31, 1), (151, 5)])
def test_junction_step_span_and_key_words(tmp_path, monkeypatch, capsys, k,
                                          words):
    """-verbose 1 reports the junction step's span (K3a, the key words'
    sort, K3b), its one call inside compaction, and the packed words a
    junction key sorts on: 1 at k = 31, 5 at k = 151 (10 lanes)."""
    fa = tmp_path / "reads.fa"
    _write_fasta(fa, _reads(400, genome_len=3000, read_len=k + 50))
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(["-in", str(fa), "-kmer-size", str(k), "-abundance-min",
                      "2", "-verbose", "1", "-out", str(tmp_path / "o")]) == 0
    st = _stats(capsys.readouterr().out)
    assert st["junction_key_words"] == str(words)
    assert re.fullmatch(r"\d+\.\d{4}s", st["time:compaction.junctions"])
    assert st["calls:compaction.junctions"] == "1"
    assert (float(st["time:compaction.junctions"][:-1])
            <= float(st["time:compaction"][:-1]))
    assert int(st["unitigs"]) > 0


def test_stats_are_the_rounded_span_totals(tmp_path):
    reads = _reads(400)
    cfg = engine.EngineConfig(k=21)
    ti = TimeInfo()
    with ti.active():
        us = engine.build_from_blocks(
            packing.iter_blocks(reads, cfg.k, block_reads=64,
                                max_len=cfg.max_len),
            cfg, "cpu", store=Store(str(tmp_path / "p")))
    for stat, name in (("t_count_s", "count"), ("t_compact_s", "compaction"),
                       ("t_assemble_s", "assemble"),
                       ("t_store_s", "checkpoint")):
        assert us.stats[stat] == round(ti.spans[name][0], 2), stat
    assert ti.spans["count.ingest_wait"][1] == -(-len(reads) // 64)
    # the children lie inside their parents
    spell, links = ti.spans["assemble.spell"][0], ti.spans["assemble.links"][0]
    assert spell + links <= ti.spans["assemble"][0]
    assert ti.spans["count.pass"][0] <= ti.spans["count"][0]


def test_multipass_timing_is_filled_from_the_spans():
    rng = np.random.RandomState(1)
    g = "".join("ACGT"[c] for c in rng.randint(0, 4, 600))
    reads = [g[i:i + 40] for i in range(0, 560, 5)] * 2
    cfg = engine.EngineConfig(k=15, abundance_min=2, block_reads=1,
                              max_len=48, chunk_kmers=16, resident_kmers=8)
    ti = TimeInfo()
    with ti.active():
        us = engine.build_from_seqs(reads, cfg, "cpu")
    tm = us.stats["timing"]
    assert us.stats["ooc_passes"] > 1
    assert len(tm["passes"]) == ti.spans["count.pass"][1] == us.stats["ooc_passes"]
    assert tm["passes"] == [pytest.approx(p, abs=0.0015) for p in tm["passes"]]
    for key in ("settle_wait", "split", "final_merge", "fetch_wait"):
        assert tm[key] == round(tm[key], 3)
        assert f"count.{key}" in ti.spans
    assert tm["fetch_wait"] == round(ti.spans["count.fetch_wait"][0], 3)
    assert sum(tm["passes"]) == pytest.approx(ti.spans["count.pass"][0],
                                              abs=0.001 * len(tm["passes"]))
    # pass 1 waits for each block of the input; the later passes replay
    # the device block cache
    assert us.stats["ooc_block_cache_mb"] > 0
    assert ti.spans["count.ingest_wait"][1] == len(reads)


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        f"spans_test_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("metric,key", [
    ("ingest_wait_s", "time:count.ingest_wait"),
    ("spell_s", "time:assemble.spell"),
    ("links_s", "time:assemble.links")])
def test_new_metric_readers(metric, key):
    read = _metric(metric).read
    rec = {"builds": [{"stats": {key: 0.25}}, {"stats": {key: 0.75}},
                      {"stats": {"time:build": 3.0}}]}
    assert read(rec) == pytest.approx(0.5)
    assert read({"builds": [{"stats": {"time:build": 3.0}}]}) is None
    assert read({"builds": []}) is None


def _program_span_names():
    names = set()
    for path in (REPO / "bcalm_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "span" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def _benchmark_names():
    """Every string the benchmark's code holds that starts with cdbg.: its
    window, build and release spans, STAGE_SPANS, the metric files' SPANS
    and the launch spans' prefix."""
    names = set()
    files = [BENCH / "run.py", BENCH / "tracing.py",
             *sorted((BENCH / "metrics").glob("*.py"))]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and node.value.startswith("cdbg.")):
                names.add(node.value)
    return names


def test_span_names_do_not_collide_with_the_benchmark():
    names = _program_span_names()
    assert names == ALL_SPANS
    bench = _benchmark_names()
    assert {"cdbg.window", "cdbg.build", "cdbg.release", "cdbg.count",
            "cdbg.compact", "cdbg.launch."} <= bench
    for name in names:
        # a child is its parent's name plus a dot and a word
        parent, _, word = name.rpartition(".")
        assert not parent or (parent in names and word.isidentifier()), name
        traced = TRACE_PREFIX + name
        assert traced not in bench and not traced.startswith("cdbg.launch.")
        assert name not in bench and f"time:{name}" not in bench
    assert not any(b.startswith(TRACE_PREFIX) for b in bench)


def test_engine_stages_time_with_spans_only():
    src = (REPO / "bcalm_tpu_torch" / "engine.py").read_text()
    assert "time.time(" not in src and "perf_counter" not in src
    assert timeinfo.TRACE_PREFIX == "cdbg.bcalm."
    assert "ingest_mbps" not in (REPO / "bcalm_tpu_torch" / "cli.py").read_text()


def _bench_run():
    spec = importlib.util.spec_from_file_location("spans_test_bench_run",
                                                  BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _junction_record(**over):
    rec = {"builds": [{"stats": {"junction_key_words": 5.0}},
                      {"stats": {"time:build": 3.0}}],
           "host_spans": {"cdbg.junction_step": [0.002]},
           "trace": {"span_device_s": {"cdbg.junction_step": 0.001}},
           "work": {"junction_step": [1.675e9, 1.675e9]},
           "peaks": {"card": {"hbm_bytes_per_s": 3.35e12}},
           "device_kind": "card"}
    rec.update(over)
    return rec


def test_junction_metric_readers():
    """junction_ms reads the synchronised span's host time; the roofline
    share the step's bytes at the card's rate over the span's device
    time; neither reads where the span or its work is missing.  Their
    synchronised span lies inside compact_ms's, so no cell lists both."""
    ms = _metric("junction_ms").read
    roof = _metric("junction_step_roofline_pct").read
    assert ms(_junction_record()) == pytest.approx(2.0)
    assert roof(_junction_record()) == pytest.approx(100.0)
    rec = _junction_record(host_spans={}, work={}, trace=None)
    assert ms(rec) is None and roof(rec) is None
    assert roof(_junction_record(trace={"span_device_s": {}})) is None
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {m["name"]: set(m["workloads"]) for m in bench["per_layer"]}
    assert cells["junction_ms"] == cells["junction_step_roofline_pct"]
    assert cells["junction_ms"] and not cells["junction_ms"] & cells["compact_ms"]
    # both declare one synchronised span, with the step's work
    decls = [d for name in ("junction_ms", "junction_step_roofline_pct")
             for d in _metric(name).SPANS]
    assert len({(d["target"], d["name"], d["sync"], d["work"])
                for d in decls}) == 1
    owner, attr = _bench_run().resolve(decls[0]["target"])
    assert getattr(owner, attr) is junctions.successor_arrays


def test_junction_step_work():
    """work/junction_step.py: W is the junction key's packed words (the
    program's own count, 1 at k = 31, 5 at k = 151); the bytes of a call
    on a (10, C) table at k = 151 from the list in its docstring."""
    spec = importlib.util.spec_from_file_location(
        "spans_test_work_junction_step", BENCH / "work" / "junction_step.py")
    work = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(work)
    for k in range(2, 513):
        assert work.key_words(k) == junctions.key_words(k), k
    assert (work.key_words(31), work.key_words(151)) == (1, 5)
    solid = torch.zeros((10, 1024), dtype=torch.int64)
    E = 2048
    want = (600 * 8 * 5 + E * 8 * 6 + 5 * E * 32 + E * 8 * 6 + E * 8)
    assert work.of_call((solid, 600, 151), {}, None) == want
    assert work.of_call((solid,), {"n_solid": 600, "k": 151}, None) == want


def test_harness_reads_the_junction_step_on_the_new_cell(monkeypatch):
    """The benchmark's cell ecoli300_k151.resident at a test's size (20
    kbp of genome at 10x, 300 bp reads, k = 151) on the CPU, traced: the
    build is correct against the plain reference, junction_ms reads the
    step's span, and every per-layer metric the cell lists that reads the
    program's stats or the set-up has a reading (the device's need a
    card)."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    run = _bench_run()
    spec = run.load_spec("ecoli300_k151.resident")
    assert spec["config"]["k"] == 151 and spec["cell"]["chips"] == 1
    assert {"junction_ms", "junction_step_roofline_pct"} <= {
        m["name"] for m in spec["per_layer"]}
    spec["config"] = dict(spec["config"], reads=dict(
        spec["config"]["reads"], genome_len=20000, coverage=10))
    out, checks = run.run(spec, 2147483700, 0.5, True, "cpu")
    assert out["correct"] and not any(checks.values())
    assert out["metrics"]["junction_ms"]["value"] > 0
    assert {"port_start_s", "count_s", "assemble_s", "write_s",
            "ingest_wait_s", "spell_s", "links_s"} <= set(out["metrics"])
    assert {m["name"] for m in spec["per_layer"]} - set(out["metrics"]) <= {
        "device_idle_pct", "count_step_roofline_pct",
        "junction_step_roofline_pct"}
