#!/usr/bin/env python3
"""Benchmark of bcalm_tpu_torch: one run of one cell.

    python3 cdbg_bench/run.py --workload ecoli_k31.resident --seed 7 \
        --seconds 51 --trace 0

A cell (an entry of BENCHMARK.json's ``workloads``) pairs a configuration
(configs/<name>.json: the read generator's parameters, k, the abundance
cut-off) with a traffic mix (traffic/<name>.json: the CLI's extra flags).
A run:

1. set-up: writes the reads of --seed into a directory under TMPDIR,
   imports the port and calls ``bcalm_tpu_torch.cli._warm`` (the
   keep-alive server's own set-up: the CUDA context, the kernel and ingest
   libraries, which are built inside the checkout on its first run, and a
   small build), then runs one build of the cell's input;
2. window: a closed loop of one client, ``bcalm_tpu_torch.cli.main(argv)``
   in this process, build after build, each followed by gc.collect() and
   torch.cuda.empty_cache() (what the server does after a request), until
   --seconds have passed; the build under way then finishes and counts;
3. after the window: every build's FASTA is hashed (all must be equal),
   and the first is judged against the plain reference (reference.py),
   which counts and compacts the same reads again on the card;
4. prints one JSON line: with --trace 0 the cell's end-to-end metrics;
   with --trace 1 its per-layer metrics, read from the harness's spans
   around the port's entry functions and from torch.profiler over the
   window's first build (the rest of the window runs untraced).  The
   numbers compared for ``correct``, each with its limit, come last in
   that line and as the last lines of standard error; earlier lines of
   standard error give the set-up's split, each build's wall and stage
   times, and the bytes the process wrote.

Each metric is computed by metrics/<name>.py from the run's record; a
metric whose reader finds nothing is left out.  A per-layer metric's file
may declare, as ``SPANS``, the port's functions it needs a span around:
each a dict with ``target`` ("module:attribute", the attribute may be
dotted), the span's ``name``, ``sync`` (synchronise the device at both
edges and keep the span's host time) and ``work`` (the name of a
work/<name>.py whose ``of_call(args, kwargs, out)`` gives the bytes the
call has to move).  Without a card, or with fewer cards than the cell
asks for, the run exits 1 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from collections import defaultdict  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import gen  # noqa: E402
import reference  # noqa: E402
import tracing  # noqa: E402

# top-level module names that no run may load (compared whole: the
# port's own name begins with the last one)
FORBIDDEN = ("jax", "jaxlib", "flax", "bcalm_tpu")
# every compared number is a count of disagreements: the limit is 0
LIMITS = {name: 0 for name in reference.CHECKS + ("builds_differ",
                                                  "builds_failed")}
# a traced run profiles one build of its window.  The profiler has
# dropped kernels from a build (one resident build in eleven), so a build
# whose launch cross-check falls short is thrown away and the next build
# is traced, up to TRACE_ATTEMPTS times; then the run fails.
TRACE_ATTEMPTS = 5
# the harness's spans around the port's stages, which name the idle gaps
# of the breakdown; a metric's SPANS add to them
STAGE_SPANS = (
    {"target": "bcalm_tpu_torch.engine:count_blocks", "name": "cdbg.count"},
    {"target": "bcalm_tpu_torch.engine:_finish_build",
     "name": "cdbg.assemble"},
    {"target": "bcalm_tpu_torch.io.fasta_writer:write_fasta",
     "name": "cdbg.write"},
    {"target": "bcalm_tpu_torch.storage.store:Store.write_counts",
     "name": "cdbg.store"})
# the kernel library: each of its public functions that launches gets a
# launch span (not synchronised) for the profiler's cross-check
KERNELS = "bcalm_tpu_torch.ops._kernels"
NOT_LAUNCHES = ("reset_launches", "source_hash", "build", "load")
# the program's counters: each build's record keeps what it added to them
COUNTERS = {"launches": KERNELS + ":LAUNCHES",
            "rounds": "bcalm_tpu_torch.ops.chains:ROUNDS"}


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_spec(workload: str, root: str = ROOT) -> dict:
    """The cell, its configuration and traffic, and the metrics it
    reports, from BENCHMARK.json and the files it names."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"name": workload, "cell": cell,
            "config": load_json(os.path.join(root, cfg["file"])),
            "traffic": load_json(os.path.join(HERE, "traffic",
                                              cell["traffic"] + ".json")),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def resolve(target: str):
    """(owner, attribute) of "module:attribute", the attribute dotted
    where it lies on a class of the module."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


def span_plan(spec: dict) -> dict:
    """target -> {"name", "sync", "work"}: the stages' spans and those
    that the cell's per-layer metrics declare."""
    plan = {}
    decls = list(STAGE_SPANS) + [
        d for m in spec["per_layer"]
        for d in getattr(module("metrics", m["name"]), "SPANS", ())]
    for d in decls:
        p = plan.setdefault(d["target"], {"name": d["name"], "sync": False,
                                          "work": None})
        if p["name"] != d["name"]:
            raise ValueError(f"{d['target']} is spanned as both "
                             f"{p['name']} and {d['name']}")
        p["sync"] = p["sync"] or bool(d.get("sync"))
        p["work"] = d.get("work") or p["work"]
    return plan


def counters() -> dict:
    """The program's counters as they stand (COUNTERS), copied."""
    out = {}
    for key, target in COUNTERS.items():
        owner, attr = resolve(target)
        out[key] = dict(getattr(owner, attr))
    return out


def added(before: dict, after: dict) -> dict:
    """What each counter gained between two readings of counters()."""
    return {key: {n: v - before[key].get(n, 0) for n, v in vals.items()
                  if v != before[key].get(n, 0)}
            for key, vals in after.items()}


def module(kind: str, name: str):
    """cdbg_bench/<kind>/<name>.py, loaded by path."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"cdbg_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_stats(text: str) -> dict:
    """The ``[key] value`` lines that cli.main prints with -verbose 1
    (chip_smoke.py's _stats), values as numbers where they are."""
    stats = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("[") and "] " in line:
            key, val = line[1:].split("] ", 1)
            val = val[:-1] if key.startswith("time:") else val
            try:
                stats[key] = float(val)
            except ValueError:
                stats[key] = val
    return stats


def cli_argv(spec: dict, reads: str, prefix: str):
    cfg = spec["config"]
    return (["-in", reads, "-kmer-size", str(cfg["k"]), "-abundance-min",
             str(cfg["abundance_min"]), "-verbose", "1"]
            + list(spec["traffic"].get("flags", [])) + ["-out", prefix])


def sha256(path: str):
    if not os.path.exists(path):
        return None
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


class Spans:
    """The traced run's spans around the port's entry functions, put in
    place of their module attributes and taken out again on exit.  A span
    marked `sync` synchronises the device at both edges, so that the
    device work it launched lies inside it, and its host time is kept; a
    span with a work module records the bytes of each call; a launch span
    (each function of the kernel library) records how many launches its
    call added to ``LAUNCHES``, for the profiler's cross-check, and does
    not synchronise."""

    def __init__(self, device, record_function):
        self.device = device
        self.rf = record_function
        self.saved = []
        self.host_s = defaultdict(list)
        self.work = defaultdict(list)
        self.launch_calls = []
        self.depth = 0

    def _sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def wrap(self, owner, attr, name, sync=False, work=None, counter=None):
        fn = getattr(owner, attr)
        of_call = module("work", work).of_call if work else None
        self.saved.append((owner, attr, fn))

        def spanned(*a, **kw):
            if counter is not None and self.depth:
                return fn(*a, **kw)
            self.depth += counter is not None
            try:
                if sync:
                    self._sync()
                before = sum(counter.values()) if counter is not None else 0
                t0 = time.perf_counter()
                with self.rf(name):
                    out = fn(*a, **kw)
                    if sync:
                        self._sync()
                dt = time.perf_counter() - t0
            finally:
                self.depth -= counter is not None
            if sync:
                self.host_s[name].append(dt)
            if counter is not None:
                self.launch_calls.append((attr, sum(counter.values()) - before))
            if of_call is not None:
                self.work[work].append(of_call(a, kw, out))
            return out

        setattr(owner, attr, spanned)

    def install(self, plan: dict, kmod):
        for target, p in plan.items():
            owner, attr = resolve(target)
            self.wrap(owner, attr, p["name"], sync=p["sync"], work=p["work"])
        for attr in dir(kmod):
            obj = getattr(kmod, attr)
            if (callable(obj) and not attr.startswith("_")
                    and getattr(obj, "__module__", None) == kmod.__name__
                    and attr not in NOT_LAUNCHES):
                self.wrap(kmod, attr, tracing.LAUNCH + attr,
                          counter=kmod.LAUNCHES)

    def remove(self):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        self.saved = []


class TracedBuild:
    """One traced build of the window: the spans installed, the profiler
    running, the window's span open, from construction to stop()."""

    def __init__(self, device, plan: dict):
        from torch.profiler import ProfilerActivity, profile, record_function

        self.kernels = importlib.import_module(KERNELS)
        self.spans = Spans(device, record_function)
        self.spans.install(plan, self.kernels)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.window = record_function(tracing.WINDOW)
        self.window.__enter__()
        self.span = record_function
        self.launches = sum(self.kernels.LAUNCHES.values())

    def close(self) -> None:
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.spans.remove()

    def stop(self):
        """(trace summary, shortfall: None when the profiler saw every
        kernel the build launched)."""
        launches = sum(self.kernels.LAUNCHES.values()) - self.launches
        self.close()
        summary = tracing.reduce(tracing.collect(self.prof))
        del self.prof
        return summary, launch_shortfall(self.spans.launch_calls,
                                         summary["launch_ops"], launches)


def _release(device) -> None:
    """What the keep-alive server does after each request (cli._release)."""
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def one_build(cli, argv, device, span) -> dict:
    """cli.main(argv) with its output captured, the device peak read after
    it (reset before it), then the release; times on the host clock, and
    what the build added to the program's counters."""
    import torch

    cuda = device.type == "cuda"
    out, err = io.StringIO(), io.StringIO()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = counters()
    start = time.perf_counter()
    try:
        with span("cdbg.build"), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    except Exception as e:  # noqa: BLE001 — a failed build is a result
        rc = f"{type(e).__name__}: {e}"
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    gained = added(before, counters())
    with span("cdbg.release"):
        _release(device)
    return {"start": start, "end": time.perf_counter(), "rc": rc,
            "peak_bytes": peak, "stats": parse_stats(out.getvalue()),
            "counters": gained,
            "log_tail": (out.getvalue() + err.getvalue())[-2000:]}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def disk_written() -> dict:
    """This process's write counters (/proc/self/io), where readable."""
    try:
        with open("/proc/self/io") as f:
            rows = dict(line.split(": ") for line in f.read().splitlines())
        return {k: int(rows[k]) for k in ("wchar", "write_bytes")}
    except (OSError, KeyError, ValueError):
        return {}


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(spec: dict, seed: int, seconds: float, trace: bool, device_name: str,
        t_start: float = None):
    """One run of the cell: (result line as a dict, compared numbers)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device_name)
    cuda = device.type == "cuda"
    cfg = spec["config"]
    tmp = tempfile.mkdtemp(prefix="cdbg_bench-")
    try:
        reads = os.path.join(tmp, "reads.fa")
        t0 = time.perf_counter()
        n_reads = gen.write_reads(reads, cfg["reads"], seed)
        bases = n_reads * cfg["reads"]["read_len"]
        t1 = time.perf_counter()
        from bcalm_tpu_torch import cli

        cli._warm(device)
        t2 = time.perf_counter()
        null = contextlib.nullcontext
        warm = one_build(cli, cli_argv(spec, reads, os.path.join(tmp, "w")),
                         device, lambda name: null())
        if warm["rc"] != 0:
            raise RuntimeError(f"the warm-up build failed ({warm['rc']}):\n"
                               f"{warm['log_tail']}")
        os.remove(os.path.join(tmp, "w.unitigs.fa"))
        t3 = time.perf_counter()
        setup = {"inputs_s": t1 - t0, "port_start_s": t2 - t1,
                 "warm_build_s": t3 - t2, "setup_s": t3 - t_start}

        plan = span_plan(spec) if trace else None
        no_span = lambda name: null()  # noqa: E731
        seg = kept = None
        attempts = []
        builds = []
        w0 = time.perf_counter()
        try:
            while True:
                if trace and kept is None and len(attempts) < TRACE_ATTEMPTS:
                    seg = TracedBuild(device, plan)
                prefix = os.path.join(tmp, f"b{len(builds)}")
                builds.append(one_build(cli, cli_argv(spec, reads, prefix),
                                        device, seg.span if seg else no_span))
                builds[-1]["out"] = prefix + ".unitigs.fa"
                if seg is not None:
                    summary, short = seg.stop()
                    attempts.append(short)
                    if short is None:
                        kept = (seg, summary)
                    else:
                        say(f"traced build {len(attempts)} thrown away: "
                            f"{short}")
                    seg = None
                if (builds[-1]["rc"] != 0
                        or time.perf_counter() - w0 >= seconds):
                    break
            w1 = time.perf_counter()
        finally:
            if seg is not None:
                seg.close()
        if trace and kept is None:
            raise RuntimeError(f"the profiler missed kernels in each of "
                               f"{len(attempts)} traced builds")
        trace_sum = kept[1] if kept else None
        failed = [b for b in builds if b["rc"] != 0]
        for b in failed:
            say(f"build failed ({b['rc']}):\n{b['log_tail']}")
        peak = max((b["peak_bytes"] or 0) for b in builds)

        # every build of the window wrote the same bytes; the first is judged
        digests = [sha256(b["out"]) for b in builds]
        judged = builds[0]["out"]
        for b in builds[1:]:
            if os.path.exists(b["out"]):
                os.remove(b["out"])
        _release(device)
        t4 = time.perf_counter()
        if os.path.exists(judged):
            sol = reference.reference(reads, cfg["k"], cfg["abundance_min"],
                                      device)
            checks, detail = reference.judge(sol, judged)
            say(f"judged {os.path.basename(judged)}: {detail}")
            del sol
        else:
            checks = {name: 1 for name in reference.CHECKS}
        checks["builds_differ"] = sum(d != digests[0] or d is None
                                      for d in digests)
        checks["builds_failed"] = len(failed)
        ref_s = time.perf_counter() - t4

        rec = {"spec": spec, "setup": setup, "bases": bases, "builds": builds,
               "window": {"start": w0, "end": w1}, "trace": trace_sum,
               "host_spans": dict(kept[0].spans.host_s) if kept else {},
               "work": dict(kept[0].spans.work) if kept else {},
               "device_kind": (torch.cuda.get_device_name(device) if cuda
                               else "cpu"),
               "peaks": load_json(os.path.join(HERE, "peaks.json"))}
        metrics = {}
        for m in spec["per_layer" if trace else "end_to_end"]:
            val = module("metrics", m["name"]).read(rec)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else device.type,
               "kind": rec["device_kind"], "count": spec["cell"]["chips"],
               "memory_peak_bytes": peak}
        out = {"correct": all(checks[n] <= LIMITS[n] for n in LIMITS),
               "attempted": len(builds), "failed": len(failed),
               "metrics": metrics, "device": dev}
        if trace:
            dev["busy_s"] = trace_sum["busy_s"]
            dev["window_s"] = trace_sum["window_s"]
            out["breakdown"] = {"device_ops": trace_sum["device_ops"][:10],
                                "idle_gaps": trace_sum["idle_gaps"][:10]}
            say(f"profiler cross-check: traced build {len(attempts)} of "
                f"{TRACE_ATTEMPTS} kept, "
                f"{sum(d for _, d in kept[0].spans.launch_calls)} kernel "
                f"launches all seen")
            if cuda:
                say(f"card: {power_limit()}")
        out["checks"] = {n: {"value": checks[n], "limit": LIMITS[n]}
                         for n in LIMITS}
        say(f"set-up {setup['setup_s']:.3f} s: inputs {setup['inputs_s']:.3f}"
            f", port start {setup['port_start_s']:.3f}, warm build "
            f"{setup['warm_build_s']:.3f}, the rest (interpreter, torch) "
            f"{setup['setup_s'] - setup['inputs_s'] - setup['port_start_s'] - setup['warm_build_s']:.3f}"
            f"; reference after the window {ref_s:.3f} s; "
            f"{len(builds)} builds in {w1 - w0:.3f} s; build walls "
            f"{[round(b['end'] - b['start'], 3) for b in builds]}")
        keys = ("t_count_s", "t_compact_s", "t_assemble_s", "t_store_s",
                "time:write", "time:build")
        say("stages per build (" + ", ".join(keys) + "): " + "; ".join(
            " ".join(str(b["stats"].get(x, "-")) for x in keys)
            for b in builds))
        say(f"disk written by this process: {disk_written()}")
        return out, checks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def launch_shortfall(calls, seen, launches: int):
    """None when the profiler saw, inside each launch span, at least as
    many of the program's kernels as the call added to LAUNCHES; else what
    it missed (a missed kernel would read as idle time)."""
    if sum(d for _, d in calls) != launches or len(calls) != len(seen):
        return (f"launch spans do not match LAUNCHES: {len(calls)} calls "
                f"adding {sum(d for _, d in calls)}, LAUNCHES {launches}, "
                f"{len(seen)} spans in the trace")
    short = [(i, name, d, n) for i, ((name, d), (_, n))
             in enumerate(zip(calls, seen)) if n < d]
    if short:
        return (f"the profiler missed kernels in {len(short)} of "
                f"{len(calls)} launch spans (index, name, launches, kernels "
                f"seen): first {short[:3]}, last {short[-3:]}")
    return None


def print_checks(checks: dict) -> None:
    for name in LIMITS:
        say(f"check {name} {checks[name]} limit {LIMITS[name]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"this cell needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f": no result")
        return 1
    os.environ["BCALM_TORCH_DEVICE"] = "cuda"
    out, checks = run(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start=T_START)
    found = forbidden_loaded()
    if found:
        say(f"modules that no run may load were loaded: {found}: no result")
        return 1
    print(json.dumps(out), flush=True)
    print_checks(checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
