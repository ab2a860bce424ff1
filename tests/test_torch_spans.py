"""The port's stage spans (utils/timeinfo.py): the recorder's totals, calls
and nesting, the profiler ranges they open only while torch's profiler
records, the CLI's -verbose report, the engine's t_*_s stats read from
them, the benchmark's readers of three of them, and their names against
the names the benchmark uses."""

import ast
import importlib.util
import pathlib
import re
import time

import numpy as np
import pytest
import torch

from bcalm_tpu_torch import cli as tcli
from bcalm_tpu_torch import engine
from bcalm_tpu_torch.io import packing
from bcalm_tpu_torch.storage.store import Store
from bcalm_tpu_torch.utils import timeinfo
from bcalm_tpu_torch.utils.timeinfo import TRACE_PREFIX, TimeInfo, span

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "cdbg_bench"
# the spans of a resident single-device CLI build (the benchmark's cell)
CLI_SPANS = {"build", "count", "count.pass", "count.ingest_wait",
             "count.upload", "count.final_merge", "solid", "compaction",
             "checkpoint", "assemble", "assemble.spell", "assemble.links",
             "write", "remove_store"}
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
    assert all(re.fullmatch(r"\[time:[\w.]+\] \d+\.\d{4}s", l)
               for l in lines if l.startswith("[time:"))


class _Counted:
    """A stand-in for torch.profiler.record_function that counts the
    ranges entered."""
    entered = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Counted.entered.append(self.name)
        return self

    def __exit__(self, *exc):
        return False


def test_untraced_build_enters_no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counted)
    _Counted.entered = []
    ti = TimeInfo()
    with ti.active():
        us = engine.build_from_seqs(_reads(300), engine.EngineConfig(k=21),
                                    "cpu")
    assert us.seqs and {"count", "assemble.links"} <= set(ti.spans)
    assert _Counted.entered == []
    # under the profiler the same spans enter their ranges
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("count"):
            pass
    assert _Counted.entered == [TRACE_PREFIX + "count"]


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
