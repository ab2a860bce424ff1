"""Command line of the port.

    python -m bcalm_tpu_torch -in reads.fa -kmer-size 31 -abundance-min 2 \
        [-out prefix] [-max-memory MiB] [-max-disk MB] [-devices N]

The option surface, the input block stream, the output naming and the
store are the JAX package's, carried here as copies (build_parser,
_input_blocks and default_prefix of bcalm_tpu/cli.py; storage.store,
io.bank and the native ingest parser, which the port builds itself), so
both packages read the same blocks, write the same ``<prefix>.unitigs.fa``
and read each other's ``<prefix>_btpu/`` checkpoint.  As in
bcalm_tpu.cli.main:

- the build checkpoints its solid k-mers in ``<prefix>_btpu/`` and removes
  it at the end; ``-only-uf`` stops after the chain decomposition and
  keeps the store with ``chains.npz``; ``-skip-bcalm`` resumes from the
  stored counts (refiltering at a higher cutoff, refusing a lower one),
  ``-skip-bglue`` also from the stored chains; ``-redo-links`` rewrites
  the links of an existing unitigs file;
- a file of filenames with ``-solidity-kind min|max`` counts each sample
  at abundance 1 and combines the counts (combine_sample_counts);
- ``-abundance-min auto`` takes the histogram's first valley, capped by
  ``-abundance-min-threshold``; ``-solid-kmers-out`` lists the solid
  k-mers with their counts; ``-uf-stats`` adds chain statistics.

The device is ``cuda`` unless ``BCALM_TORCH_DEVICE`` names another; a
requested CUDA device that is absent is an error, never a silent CPU run.
``-max-memory`` sizes the counting chunk and the resident budget
(engine.configure_chunk; without it, the device's memory does); a distinct
set past that budget is counted in several passes over key ranges, each
re-reading the input.  ``-devices N`` (N > 1) runs the
minimizer-partitioned build on N ranks (parallel.launch, parallel.pipeline):
one NCCL rank per card, or N gloo processes on the CPU.

``-server SOCK`` keeps one process alive that serves builds on a unix
socket, and ``-connect SOCK <arguments>`` sends one command line to it
(serve, connect: bcalm_tpu.cli's protocol, so either package's client
talks to either server).  A multi-pass build whose compaction runs out of
device memory after the store's checkpoint re-runs itself once with
``-skip-bcalm`` in a fresh process (_respawn_skip_bcalm).  torch is
imported only past ``-version``, ``-connect`` and ``-help``, so those run
without it.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

from bcalm_tpu_torch.utils.logging import Progress
from bcalm_tpu_torch.utils.options import OptionFailure, OptionsParser
from bcalm_tpu_torch.utils.timeinfo import TimeInfo, peak_rss_mb
from bcalm_tpu_torch.version import version_string

DEVICE_ENV = "BCALM_TORCH_DEVICE"


def build_parser() -> OptionsParser:
    p = OptionsParser("bcalm-tpu")
    # core graph options (GraphUnitigsTemplate::getOptionsParser analog)
    p.one_param("-in", "input reads (fasta/fastq[.gz] or file of filenames)",
                mandatory=True)
    p.one_param("-out", "output prefix", default=None)
    p.one_param("-kmer-size", "k-mer size", default="31")
    p.one_param("-abundance-min",
                "filter k-mers seen strictly fewer times than this",
                default="2")
    p.one_param("-abundance-max", "max k-mer abundance", default=str(2**31 - 1),
                visible=False)
    p.one_param("-minimizer-size", "minimizer size", default="10")
    p.one_param("-minimizer-type", "0: lexicographic, 1: frequency-based",
                default="1")
    p.one_param("-repartition-type", "0: uniform, 1: frequency-balanced",
                default="1")
    p.one_param("-max-memory", "max device memory in MB", default="0")
    p.one_param("-max-disk", "max disk for multi-pass staging in MB "
                             "(0 = unlimited)", default="0")
    p.one_param("-nb-cores", "host worker threads (0=auto)", default="0")
    p.one_param("-verbose", "verbosity level", default="1")
    p.no_param("-all-abundance-counts",
               "emit ab:Z: per-k-mer abundance vectors in headers")
    # stage-skipping / resume flags (scripts/pufferize.py:143)
    p.no_param("-skip-bcalm", "reuse stored counts, skip counting+compaction input")
    p.no_param("-skip-bglue", "with -skip-bcalm: skip gluing")
    p.no_param("-redo-links", "recompute L: link annotations of an existing "
                              "unitigs file")
    p.one_param("-nb-glue-partitions", "legacy: glue partition count",
                default="0", visible=False)
    # hidden gatb options surfaced for parity (src/bcalm_1.cpp:34-37)
    p.one_param("-histo-max", "max histogram bin", default="10000",
                visible=False)
    p.one_param("-solidity-kind", "multi-sample solidity: sum|min|max",
                default="sum", visible=False)
    p.one_param("-abundance-min-threshold",
                "cap for '-abundance-min auto'", default="20",
                visible=False)
    p.one_param("-solid-kmers-out", "write solid (kmer,count) pairs to file",
                default=None, visible=False)
    # glue diagnostics (legacy --only-uf/--uf-stats, src/bcalm_1.cpp:26-27)
    p.no_param("-only-uf", "stop after chain labeling (UF analog); no "
                           "unitig assembly or output", visible=False)
    p.no_param("-uf-stats", "print chain-decomposition (UF-class) stats",
               visible=False)
    # TPU-specific
    p.one_param("-devices", "number of devices to use (0 = all)", default="0")
    p.one_param("-server", "serve build requests on a unix socket "
                           "(keep-alive mode: amortizes backend init + "
                           "program loads across invocations)",
                default=None, visible=False)
    p.one_param("-connect", "send this command line to a -server socket "
                            "instead of running locally",
                default=None, visible=False)
    p.no_param("-version", "show version")
    p.no_param("-help", "show this help")
    p.no_param("-h", "show this help", visible=False)
    return p


def default_prefix(in_path: str) -> str:
    base = os.path.basename(in_path)
    for ext in (".gz",):
        if base.endswith(ext):
            base = base[: -len(ext)]
    root, ext = os.path.splitext(base)
    return root if ext in (".fa", ".fasta", ".fq", ".fastq", ".txt", ".list") \
        else base


def _input_blocks(bank, cfg, verbose: int, nb_cores: int = 0,
                  info: Optional[dict] = None):
    """Packed-block stream: native C++ parser when available (with host
    prefetch overlapping device compute), else python.

    One big file (the common production case) fans its decompressed
    stream out to a parse-worker pool (io.parallel_ingest — the gatb
    Dispatcher -nb-cores analog, SURVEY.md §3.2); multiple files fan out
    per file as before.

    info: when given, info["ingest_parser"] names the parser that ran
    ("binary", "native" or "python"; bcalm_tpu.cli._input_blocks, the
    parser choice and the stream unchanged)."""
    info = {} if info is None else info
    from bcalm_tpu_torch.io import bank_binary, native as native_mod
    from bcalm_tpu_torch.io import packing
    from bcalm_tpu_torch.utils import dispatcher

    binary = [p for p in bank.paths if bank_binary.is_binary_bank(p)]
    if binary and len(binary) == len(bank.paths):
        info["ingest_parser"] = "binary"
        for p in bank.paths:
            yield from bank_binary.read_bank(p)
        return

    if native_mod.available():
        info["ingest_parser"] = "native"
        if verbose > 1:
            print("using native ingest (libbcalmio)")
        workers = nb_cores if nb_cores > 0 else min(4, max(2, len(bank.paths)))
        if (len(bank.paths) == 1 and workers > 1
                and native_mod.mem_available()):
            from bcalm_tpu_torch.io import parallel_ingest

            yield from dispatcher.prefetch(
                parallel_ingest.iter_blocks_parallel(
                    bank.paths[0], cfg.k, block_reads=cfg.block_reads,
                    max_len=cfg.max_len, n_workers=workers))
            return
        yield from dispatcher.parallel_files(
            bank.paths,
            lambda p: native_mod.iter_blocks_native(
                p, cfg.k, block_reads=cfg.block_reads, max_len=cfg.max_len
            ),
            n_workers=workers,
        )
    else:
        info["ingest_parser"] = "python"
        yield from dispatcher.prefetch(
            packing.iter_blocks(
                bank.sequences(), cfg.k, block_reads=cfg.block_reads,
                max_len=cfg.max_len,
            )
        )


def adapt_max_len(bank, cfg) -> None:
    """Block geometry and occurrence estimate from the bank: the max_len
    and est_total_occ rules of bcalm_tpu.cli._adapt_max_len, so both
    packages cut the input into identical blocks (first-occurrence keys
    depend on it).  The chunk stays configure_chunk's: the JAX rule's
    2^24 chunk at >= 2^26 occurrences was measured on a TPU."""
    sampled = bank.sample_max_len()
    if sampled >= cfg.k:
        cfg.max_len = max(cfg.k + 1, min(512, -(-sampled // 16) * 16))
    raw = sum(os.path.getsize(p) for p in bank.paths if os.path.exists(p))
    mult = 3.0 if any(str(p).endswith(".gz") for p in bank.paths) else 1.0
    bases = raw * mult * 0.9
    if sampled > 0 and bases > 0:
        cfg.est_total_occ = int(
            bases * max(0.1, 1.0 - (cfg.k - 1) / max(cfg.k, sampled)))


def redo_links(unitigs_path: str, k: int, verbose: int) -> None:
    """Recompute every L: field of an existing unitigs file in place, the
    other header fields kept (bcalm_tpu.cli.redo_links)."""
    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.io import fasta_writer

    seqs, headers = fasta_writer.parse_unitigs_fasta(unitigs_path)
    by_src: dict = {}
    for (u, su, v, sv) in engine.link_join(seqs, k):
        by_src.setdefault(u, []).append(f"L:{su}:{v}:{sv}")
    with open(unitigs_path, "w") as f:
        for i, s in enumerate(seqs):
            toks = [t for t in headers[i].split(" ") if t and not t.startswith("L:")]
            toks.extend(by_src.get(i, ()))
            f.write(">" + " ".join(toks) + "\n" + s + "\n")
    if verbose:
        print(f"re-linked {len(seqs)} unitigs -> {unitigs_path}")


def _load_store(store, cfg, k: int, auto_amin: bool, verbose: int):
    """-skip-bcalm: the stored counts, validated against the requested
    abundance bounds and refiltered at a higher cutoff.  Returns (solid,
    counts, minpos, histogram), or an exit code."""
    if not store.exists():
        print(f"-skip-bcalm: no stored counts at {store.path}", file=sys.stderr)
        return 1
    try:
        solid, counts, minpos = store.read_counts(k)
    except ValueError as e:
        print(f"-skip-bcalm: {e}", file=sys.stderr)
        return 1
    scfg = store.config()
    stored_amin = int(scfg.get("abundance_min", 1))
    stored_amax = int(scfg.get("abundance_max", 2**31 - 1))
    if auto_amin:
        cfg.abundance_min = stored_amin
    if cfg.abundance_min < stored_amin or cfg.abundance_max > stored_amax:
        print(f"-skip-bcalm: stored counts were filtered at abundance "
              f"[{stored_amin}, {stored_amax}]; cannot widen to "
              f"[{cfg.abundance_min}, {cfg.abundance_max}] — recount "
              f"without -skip-bcalm", file=sys.stderr)
        return 1
    if cfg.abundance_min > stored_amin or cfg.abundance_max < stored_amax:
        keep = (counts >= cfg.abundance_min) & (counts <= cfg.abundance_max)
        solid, counts = solid[:, keep], counts[keep]
        if minpos is not None:
            minpos = minpos[keep]
    if verbose:
        print(f"reusing stored counts: {solid.shape[1]} solid k-mers "
              f"({store.path})")
    return solid, counts, minpos, store.read_histogram()


def _count_samples(bank, cfg, props, verbose: int, device, auto_amin: bool,
                   counted=iter):
    """Multi-sample solidity: each bank counted on its own at abundance 1,
    the counts combined by -solidity-kind, the histogram and the cutoff
    taken over the combination.  counted wraps each bank's first pass.
    Returns (solid, counts, histogram, stats)."""
    import numpy as np

    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.io import bank as bank_mod

    cfg1 = dataclasses.replace(cfg, abundance_min=1, abundance_max=2**31 - 1)
    nb_cores = props.get_int("-nb-cores")
    runs, stats, ingest = [], {}, {}
    for p in bank.paths:
        sub = bank_mod.Bank([p])

        def blocks(sub=sub):
            return _input_blocks(sub, cfg, verbose, nb_cores=nb_cores,
                                 info=ingest)

        s_i, c_i, _, _, st = engine.count_and_filter(counted(blocks()), cfg1,
                                                     device, reread=blocks)
        runs.append((s_i, c_i))
        for key in ("reads", "bases", "kmer_occurrences"):
            stats[key] = stats.get(key, 0) + st.get(key, 0)
    lanes, agg = engine.combine_sample_counts(
        runs, props.get_str("-solidity-kind"), k=cfg.k)
    histo = np.bincount(np.minimum(agg, cfg.histo_max),
                        minlength=cfg.histo_max + 1).astype(np.int32)
    if auto_amin:
        cfg.abundance_min = engine.auto_abundance_min(
            histo, props.get_int("-abundance-min-threshold"))
    keep = (agg >= cfg.abundance_min) & (agg <= cfg.abundance_max)
    stats["distinct_kmers"] = int(lanes.shape[1])
    stats["solid_kmers"] = int(keep.sum())
    stats["ingest_parser"] = ingest.get("ingest_parser", "none")
    return lanes[:, keep], agg[keep], histo, stats


def _devices_build(props, cfg, device, n_dev: int, in_path: str, prefix: str,
                   auto_amin: bool, verbose: int) -> int:
    """-devices N > 1: the minimizer-partitioned build on N ranks
    (parallel.launch; bcalm_tpu.cli.main's mesh branch, its refusals and
    messages).  On the CPU the ranks are gloo processes, on the card one
    NCCL rank per device."""
    import torch

    from bcalm_tpu_torch.io import bank as bank_mod
    from bcalm_tpu_torch.parallel import launch, pipeline

    if props.get_str("-solidity-kind") != "sum":
        print("-devices with -solidity-kind min/max is not supported "
              "yet; run without -devices", file=sys.stderr)
        return 1
    avail = (torch.cuda.device_count() if device.type == "cuda"
             else os.cpu_count() or 1)
    if n_dev > avail:
        print(f"-devices {n_dev}: only {avail} devices available",
              file=sys.stderr)
        return 1
    adapt_max_len(bank_mod.Bank.open(in_path), cfg)
    job = {
        "in_path": in_path, "prefix": prefix, "cfg": cfg, "verbose": verbose,
        "mcfg": pipeline.MinimizerConfig(
            m=props.get_int("-minimizer-size"),
            minimizer_type=props.get_int("-minimizer-type"),
            repartition_type=props.get_int("-repartition-type")),
        "auto_amin_cap": (props.get_int("-abundance-min-threshold")
                          if auto_amin else None),
        "all_abundance_counts": props.get_bool("-all-abundance-counts"),
    }
    if device.type == "cuda":
        from bcalm_tpu_torch.ops import _kernels

        _kernels.build()    # once here, not once per rank
    try:
        launch.spawn(n_dev, device.type, devices_rank, job)
    except Exception as e:  # noqa: BLE001 — a rank failed: report, exit 1
        print(f"-devices {n_dev}: a rank failed: {e}", file=sys.stderr)
        return 1
    return 0


def devices_rank(mesh, job: dict) -> None:
    """One rank of a -devices N build: every rank reads the whole input
    and takes its rows of each round; rank 0 writes the store (removed at
    the end), the unitigs and the verbose report."""
    from bcalm_tpu_torch.io import bank as bank_mod
    from bcalm_tpu_torch.io import fasta_writer
    from bcalm_tpu_torch.parallel import pipeline
    from bcalm_tpu_torch.storage.store import Store

    ti = TimeInfo()
    cfg = job["cfg"]
    bank = bank_mod.Bank.open(job["in_path"])
    store = Store(job["prefix"])
    with ti.timer("build_distributed"):
        us = pipeline.distributed_build(
            mesh, bank.sequences(), cfg, job["mcfg"],
            auto_amin_cap=job["auto_amin_cap"], store=store,
            reread=lambda: bank.sequences())
    if mesh.rank != 0:
        return
    verbose = job["verbose"]
    if job["auto_amin_cap"] is not None and verbose:
        print(f"auto abundance-min = {cfg.abundance_min}")
    unitigs_path = job["prefix"] + ".unitigs.fa"
    with ti.timer("write"):
        with open(unitigs_path, "w") as f:
            fasta_writer.write_fasta(
                us, f, all_abundance_counts=job["all_abundance_counts"])
    store.remove()
    if verbose:
        print(f"wrote {len(us.seqs)} unitigs -> {unitigs_path} "
              f"({mesh.n_dev} devices)")
        for key, val in sorted(us.stats.items()):
            print(f"    [{key}] {val}")
        for name, secs in ti.report().items():
            print(f"    [time:{name}] {secs:.2f}s")
        print(f"    [peak_rss_mb] {peak_rss_mb():.0f}")


def resolve_device():
    """The device of BCALM_TORCH_DEVICE (default cuda); None, after a
    message, when CUDA is asked for and torch sees no card (never a
    silent CPU run)."""
    import torch

    device = torch.device(os.environ.get(DEVICE_ENV, "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"CUDA device requested ({DEVICE_ENV} unset or 'cuda') but "
              f"torch.cuda.is_available() is false; set {DEVICE_ENV}=cpu "
              f"to run on the CPU", file=sys.stderr)
        return None
    return device


def _warm(device) -> None:
    """Pay a build's fixed costs once: CUDA's context, the kernel library
    (built with nvcc when its sources have no build yet), the native
    ingest library, the modules a request imports, and the library
    kernels a build launches (a small build of random reads)."""
    import numpy as np
    import torch

    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.io import bank, fasta_writer, native  # noqa: F401
    from bcalm_tpu_torch.storage import store  # noqa: F401

    if device.type == "cuda":
        from bcalm_tpu_torch.ops import _kernels

        torch.cuda.init()
        torch.zeros((1,), device=device)
        _kernels.load()
    native.available()
    rng = np.random.RandomState(0)
    genome = "".join("ACGT"[c] for c in rng.randint(0, 4, 2000))
    reads = [genome[i:i + 100] for i in range(0, 1900, 20)] * 2
    engine.build_from_seqs(
        reads, engine.EngineConfig(k=31, chunk_kmers=engine.MIN_CHUNK), device)


def _reset_peak(device) -> None:
    """device_peak_mb counts from here: each run's own, also in a server
    process."""
    if device.type == "cuda":
        import torch

        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)


def _release(device) -> None:
    """Free what a finished request left: collected objects, and on a
    card the allocator's cached blocks, so that another process (a
    -devices rank, a respawned compaction) gets the card's memory."""
    import gc

    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def serve(socket_path: str) -> int:
    """Keep-alive server: one process holds the initialised device and
    every loaded library; each connection carries one JSON line
    {"argv": [...]} and receives {"rc": N, "output": "..."} (the
    request's standard output); {"op": "shutdown"} stops the server
    (bcalm_tpu.cli.serve's protocol byte for byte).  Requests run one at a
    time, in the server's working directory and on its device; a client
    that vanishes does not stop the server.

    Before it listens, the server resolves its device (a cuda server
    without a card exits 1 here) and pays a build's fixed costs (_warm).
    After each request it frees the allocator's cache (_release), and
    logs the request, with the memory the allocator still reserves, on
    its standard error."""
    import contextlib
    import io
    import json
    import socket as socket_mod

    device = resolve_device()
    if device is None:
        return 1
    t0 = time.time()
    _warm(device)
    _release(device)
    from bcalm_tpu_torch.io import native

    print(f"bcalm-tpu server: {device} ready in {time.time() - t0:.2f}s "
          f"(CUDA context and kernels loaded: {device.type == 'cuda'}; "
          f"ingest parser {'native' if native.available() else 'python'})",
          file=sys.stderr, flush=True)
    if os.path.exists(socket_path):
        os.unlink(socket_path)
    srv = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    srv.bind(socket_path)
    srv.listen(4)
    print(f"bcalm-tpu server listening on {socket_path}", flush=True)
    served = 0
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    data = b""
                    while not data.endswith(b"\n"):
                        chunk = conn.recv(1 << 16)
                        if not chunk:
                            break
                        data += chunk
                    if not data.strip():
                        continue
                    try:
                        req = json.loads(data)
                    except ValueError:
                        req = None
                    if not isinstance(req, dict):
                        conn.sendall(b'{"rc": 1, "output": "bad request"}\n')
                        continue
                    if req.get("op") == "shutdown":
                        conn.sendall(b'{"rc": 0, "output": "bye"}\n')
                        return 0
                    argv = [str(a) for a in req.get("argv", [])]
                    buf = io.StringIO()
                    t0 = time.time()
                    if "-server" in argv or "-connect" in argv:
                        buf.write("server error: a request cannot carry "
                                  "-server or -connect\n")
                        rc = 1
                    else:
                        try:
                            with contextlib.redirect_stdout(buf):
                                rc = main(argv)
                        except SystemExit as e:   # argv errors
                            rc = e.code if isinstance(e.code, int) else 1
                        except Exception as e:  # noqa: BLE001 — report, keep serving
                            import traceback

                            traceback.print_exc(file=sys.stderr)
                            buf.write(f"server error: {e!r}\n")
                            rc = 1
                    _release(device)
                    served += 1
                    note = ""
                    if device.type == "cuda":
                        import torch

                        note = (f"; device memory reserved "
                                f"{torch.cuda.memory_reserved(device) >> 20} MiB")
                    print(f"bcalm-tpu server: request {served}: rc {rc} in "
                          f"{time.time() - t0:.2f}s{note}", file=sys.stderr,
                          flush=True)
                    conn.sendall(json.dumps(
                        {"rc": rc, "output": buf.getvalue()}).encode() + b"\n")
                except OSError:
                    # the client vanished mid-request or mid-reply: keep
                    # serving
                    continue
    finally:
        srv.close()
        if os.path.exists(socket_path):
            os.unlink(socket_path)


def connect(socket_path: str, argv: List[str]) -> int:
    """Client side of -server: forward one command line, print its
    output, return its exit code (bcalm_tpu.cli.connect)."""
    import json
    import socket as socket_mod

    cli = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    cli.connect(socket_path)
    cli.sendall(json.dumps({"argv": argv}).encode() + b"\n")
    data = b""
    while not data.endswith(b"\n"):
        chunk = cli.recv(1 << 16)
        if not chunk:
            break
        data += chunk
    resp = json.loads(data)
    sys.stdout.write(resp.get("output", ""))
    return int(resp.get("rc", 1))


def _respawn_skip_bcalm(argv: List[str], err) -> int:
    """Continue a run whose compaction ran out of device memory in a
    fresh process (bcalm_tpu.cli._respawn_skip_bcalm).  The solid set is
    already checkpointed, so the same command line runs again with
    -skip-bcalm and BTPU_NO_RESPAWN=1 (a respawned child never respawns):
    compaction restarts on a clean allocator, on the same device (the
    child inherits the environment), and the child owns the rest of the
    run.  Where this process's standard output is no file (a -server
    request's buffer), the child's is captured and written there, so it
    reaches the client.  Returns the child's exit code."""
    import subprocess

    print(f"{err} — restarting compaction in a fresh process",
          file=sys.stderr)
    env = dict(os.environ, BTPU_NO_RESPAWN="1")
    # the child imports this package, wherever the parent found it
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "bcalm_tpu_torch", *argv, "-skip-bcalm"]
    try:
        sys.stdout.fileno()
    except (AttributeError, OSError, ValueError):
        proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, text=True)
        sys.stdout.write(proc.stdout)
        return proc.returncode
    return subprocess.call(cmd, env=env)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "-version" in argv or "--version" in argv:
        print(version_string())
        return 0
    if "-server" in argv:
        i = argv.index("-server")
        if i + 1 >= len(argv):
            print("-server requires a socket path", file=sys.stderr)
            return 1
        return serve(argv[i + 1])
    if "-connect" in argv:
        i = argv.index("-connect")
        if i + 1 >= len(argv):
            print("-connect requires a socket path", file=sys.stderr)
            return 1
        return connect(argv[i + 1], argv[:i] + argv[i + 2:])
    parser = build_parser()
    try:
        props = parser.parse(argv)
    except OptionFailure as e:
        print(str(e), file=sys.stderr)
        return 1
    if props.get_bool("-help") or props.get_bool("-h"):
        print(parser.usage())
        return 0

    k = props.get_int("-kmer-size")
    verbose = props.get_int("-verbose")
    in_path = props.get_str("-in")
    prefix = props.get_str("-out") or default_prefix(in_path)
    unitigs_path = prefix + ".unitigs.fa"

    if props.get_bool("-redo-links"):
        if not os.path.exists(unitigs_path):
            print(f"-redo-links: {unitigs_path} not found", file=sys.stderr)
            return 1
        redo_links(unitigs_path, k, verbose)
        return 0

    device = resolve_device()
    if device is None:
        return 1

    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.io import bank as bank_mod
    from bcalm_tpu_torch.storage.store import Store
    from bcalm_tpu_torch.io import fasta_writer
    from bcalm_tpu_torch.models import lanes as ln

    amin_raw = props.get_str("-abundance-min")
    auto_amin = amin_raw == "auto"
    cfg = engine.EngineConfig(
        k=k,
        abundance_min=1 if auto_amin else int(amin_raw),
        abundance_max=props.get_int("-abundance-max"),
        histo_max=props.get_int("-histo-max"),
        max_disk_mb=props.get_int("-max-disk"),
    )
    engine.configure_chunk(cfg, props.get_int("-max-memory"), device)
    solidity_kind = props.get_str("-solidity-kind")
    store = Store(prefix)
    cfg.spill_dir = store.path
    skip_bcalm = props.get_bool("-skip-bcalm")
    skip_bglue = props.get_bool("-skip-bglue")
    only_uf = props.get_bool("-only-uf")
    uf_stats = props.get_bool("-uf-stats")
    if skip_bglue and not skip_bcalm:
        print("-skip-bglue requires -skip-bcalm (resume workflow: run "
              "with -only-uf, then -skip-bcalm -skip-bglue)", file=sys.stderr)
        return 1

    ti = TimeInfo()
    solid = counts = minpos = histo = None
    built_us = None
    stats = {}
    if skip_bcalm:
        _reset_peak(device)
        with ti.timer("load_counts"):
            loaded = _load_store(store, cfg, k, auto_amin, verbose)
        if isinstance(loaded, int):
            return loaded
        solid, counts, minpos, histo = loaded
    else:
        if not os.path.exists(in_path):
            print(f"input not found: {in_path}", file=sys.stderr)
            return 1
        n_dev = props.get_int("-devices")
        if n_dev > 1:
            return _devices_build(props, cfg, device, n_dev, in_path, prefix,
                                  auto_amin, verbose)
        for flag, default in (("-minimizer-size", "10"),
                              ("-minimizer-type", "1"),
                              ("-repartition-type", "1")):
            if props.get_str(flag) != default:
                print(f"note: {flag} only affects the -devices N mesh "
                      f"path; ignored on the single-device path",
                      file=sys.stderr)
        _reset_peak(device)
        bank = bank_mod.Bank.open(in_path)
        adapt_max_len(bank, cfg)
        nb_cores = props.get_int("-nb-cores")
        ingest: dict = {}

        def blocks():
            return _input_blocks(bank, cfg, verbose, nb_cores=nb_cores,
                                 info=ingest)

        progress = Progress("reads packed", enabled=verbose >= 1)
        ingest_t = {"t0": None, "t1": None, "bases": 0}
        oom = None

        def counted(it):
            # a first pass: the progress line and the ingest rate
            if ingest_t["t0"] is None:
                ingest_t["t0"] = time.time()
            for blk in it:
                progress.update(int((blk.lengths > 0).sum()))
                ingest_t["bases"] += int(blk.lengths.sum())
                ingest_t["t1"] = time.time()
                yield blk

        with ti.timer("build"):
            if solidity_kind != "sum" and len(bank.paths) > 1:
                solid, counts, histo, stats = _count_samples(
                    bank, cfg, props, verbose, device, auto_amin, counted)
            else:
                # reread re-opens the bank for each further pass of a
                # multi-pass count, with the same block geometry
                try:
                    built_us = engine.build_from_blocks(
                        counted(blocks()), cfg, device, reread=blocks,
                        store=store,
                        auto_amin_cap=(props.get_int("-abundance-min-threshold")
                                       if auto_amin else None),
                        only_uf=only_uf, uf_stats=uf_stats,
                        solidity_kind=solidity_kind)
                except engine.CompactionOOM as e:
                    # a respawned child does not respawn again (and a run
                    # given -skip-bcalm never reaches this count)
                    if os.environ.get("BTPU_NO_RESPAWN") == "1":
                        raise
                    oom = str(e)
        if oom is not None:
            # the error and the tensors its frames held are gone: free
            # the card for the child
            _release(device)
            return _respawn_skip_bcalm(argv, oom)
        progress.done()
        if built_us is not None and ingest_t["t1"]:
            # stream rate over the packing loop (overlapped with device
            # compute, so a lower bound on the parser's speed)
            dt = max(1e-6, ingest_t["t1"] - ingest_t["t0"])
            built_us.stats["ingest_mbps"] = round(
                ingest_t["bases"] / 1e6 / dt, 1)
        if auto_amin and verbose:
            print(f"auto abundance-min = {cfg.abundance_min}")
        stats.setdefault("ingest_parser", ingest.get("ingest_parser", "none"))
        if built_us is not None:
            built_us.stats["ingest_parser"] = stats["ingest_parser"]
        if solid is not None:
            with ti.timer("store"):
                store.write_counts(
                    solid, counts, k, histogram=histo, minpos=minpos,
                    config={"abundance_min": cfg.abundance_min,
                            "abundance_max": cfg.abundance_max,
                            "solidity_kind": solidity_kind})

    solid_out = props.get_str("-solid-kmers-out")
    if solid_out:
        if solid is None:   # resident build: read the checkpoint
            solid, counts, _ = store.read_counts(k)
        with open(solid_out, "w") as f:
            for i in range(solid.shape[1]):
                f.write(f"{ln.int_to_string(ln.lanes_to_int(solid[:, i]), k)}"
                        f"\t{int(counts[i])}\n")

    if built_us is not None:
        us = built_us
    else:
        chain_info = None
        if skip_bglue:
            if not (skip_bcalm and store.has_chains()):
                print("-skip-bglue: no chain checkpoint in store (run with "
                      "-only-uf first, resume with -skip-bcalm -skip-bglue)",
                      file=sys.stderr)
                return 1
            try:
                chain_info = store.read_chains(k, int(solid.shape[1]))
            except ValueError as e:
                print(f"-skip-bglue: {e}", file=sys.stderr)
                return 1
            if verbose:
                print("reusing stored chain decomposition (skip-bglue)")
        with ti.timer("compact"):
            try:
                us = engine.compact_from_counts(
                    solid, counts, cfg, device, only_uf=only_uf,
                    uf_stats=uf_stats, chain_info=chain_info,
                    minpos_np=minpos)
            except ValueError as e:
                print(f"-skip-bglue: {e}", file=sys.stderr)
                return 1
        us.stats.update(stats)
        us.histogram = histo
    if only_uf and us.chain_info is not None:
        store.write_chains(us.chain_info, k, int(us.stats.get("solid_kmers", 0)))

    if not only_uf:
        with ti.timer("write"):
            with open(unitigs_path, "w") as f:
                fasta_writer.write_fasta(
                    us, f,
                    all_abundance_counts=props.get_bool("-all-abundance-counts"))
        # a finished run removes its checkpoint; -only-uf keeps it for the
        # resume stages
        with ti.timer("remove_store"):
            store.remove()

    if verbose:
        if only_uf:
            print(f"-only-uf: stopped after chain labeling "
                  f"({us.stats.get('uf_classes', 0)} classes)")
        else:
            print(f"wrote {len(us.seqs)} unitigs -> {unitigs_path} ({device})")
        for key, val in sorted(us.stats.items()):
            print(f"    [{key}] {val}")
        for name, secs in ti.report().items():
            print(f"    [time:{name}] {secs:.2f}s")
        print(f"    [peak_rss_mb] {peak_rss_mb():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
