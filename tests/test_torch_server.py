"""The port's keep-alive server (-server/-connect) and compaction-OOM
respawn, against bcalm_tpu's.

The server runs in a thread of this process on a short socket path under
/tmp (unix socket paths hold at most 108 bytes), with the port on the CPU
(BCALM_TORCH_DEVICE=cpu).  Builds sent by either package's client, and by
the port's client to bcalm_tpu's server, write bcalm_tpu.cli.main's bytes;
a failed request leaves no thread behind; the client imports no torch.
The respawn tests are bcalm_tpu's (tests/test_cli.py) against the port,
with torch's OutOfMemoryError added, and one whose respawned child really
runs.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from bcalm_tpu import cli as jcli
from bcalm_tpu_torch import cli as tcli
from bcalm_tpu_torch import engine as tengine
from bcalm_tpu_torch.storage.store import Store
from tests.test_torch_cli import write_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "ACTGCTGACTGAGTCATGTGTGGGT"


def _args(fa):
    return ["-in", str(fa), "-kmer-size", "31", "-abundance-min", "2",
            "-verbose", "0"]


def _start(serve, sock):
    """serve(sock) in a thread; returns the thread once the socket
    accepts connections."""
    t = threading.Thread(target=serve, args=(sock,), daemon=True)
    t.start()
    for _ in range(600):
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                c.connect(sock)
            return t
        except OSError:
            assert t.is_alive(), "the server thread ended before listening"
            time.sleep(0.05)
    raise AssertionError("the server did not listen")


def _raw(sock, payload: bytes) -> bytes:
    """One raw request: payload out, the reply line back."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.connect(sock)
        c.sendall(payload)
        data = b""
        while not data.endswith(b"\n"):
            chunk = c.recv(1 << 16)
            if not chunk:
                break
            data += chunk
    return data


@pytest.fixture(scope="module")
def work():
    d = tempfile.mkdtemp(prefix="bts", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def reference(work):
    """The reads, and bcalm_tpu.cli.main's unitigs of them in process."""
    fa = os.path.join(work, "reads.fa")
    write_reads(fa)
    assert jcli.main(_args(fa) + ["-out", os.path.join(work, "ref")]) == 0
    with open(os.path.join(work, "ref.unitigs.fa"), "rb") as f:
        want = f.read()
    assert want.count(b">") > 10
    return fa, want


@pytest.fixture(scope="module")
def server(work):
    """The port's server on the CPU, in a thread."""
    old = os.environ.get(tcli.DEVICE_ENV)
    os.environ[tcli.DEVICE_ENV] = "cpu"
    sock = os.path.join(work, "s")
    t = _start(tcli.serve, sock)
    yield sock, t
    if t.is_alive():
        _raw(sock, b'{"op": "shutdown"}\n')
        t.join(timeout=60)
    if old is None:
        os.environ.pop(tcli.DEVICE_ENV, None)
    else:
        os.environ[tcli.DEVICE_ENV] = old


@pytest.mark.parametrize("client", ["port", "jax"])
def test_server_build_byte_identical(reference, server, work, capsys, client):
    fa, want = reference
    sock, _ = server
    out = os.path.join(work, f"by_{client}")
    connect = tcli.connect if client == "port" else jcli.connect
    assert connect(sock, _args(fa) + ["-out", out]) == 0
    with open(out + ".unitigs.fa", "rb") as f:
        assert f.read() == want
    assert not os.path.exists(out + "_btpu")


def test_port_client_against_jax_server(reference, work, capsys):
    fa, want = reference
    sock = os.path.join(work, "j")
    t = _start(jcli.serve, sock)
    out = os.path.join(work, "from_jax")
    assert tcli.connect(sock, _args(fa) + ["-out", out, "-verbose", "1"]) == 0
    assert "wrote" in capsys.readouterr().out     # the server's output
    with open(out + ".unitigs.fa", "rb") as f:
        assert f.read() == want
    assert _raw(sock, b'{"op": "shutdown"}\n') == b'{"rc": 0, "output": "bye"}\n'
    t.join(timeout=60)
    assert not t.is_alive()


def test_server_missing_input_keeps_serving(reference, server, work, capsys):
    fa, want = reference
    sock, t = server
    assert tcli.connect(sock, ["-in", os.path.join(work, "nope.fa")]) == 1
    assert t.is_alive()
    out = os.path.join(work, "after_missing")
    assert tcli.connect(sock, _args(fa) + ["-out", out]) == 0
    with open(out + ".unitigs.fa", "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("payload", [b"not json\n", b"[1, 2]\n"])
def test_server_bad_request(server, payload):
    sock, t = server
    assert _raw(sock, payload) == b'{"rc": 1, "output": "bad request"}\n'
    assert t.is_alive()


def test_server_survives_a_vanished_client(reference, server, work):
    """A client that closes before its reply does not stop the server."""
    fa, _ = reference
    sock, t = server
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.connect(sock)
        c.sendall(json.dumps({"argv": _args(fa) + [
            "-out", os.path.join(work, "vanished")]}).encode() + b"\n")
    reply = json.loads(_raw(sock, json.dumps(
        {"argv": ["-in", os.path.join(work, "nope.fa")]}).encode() + b"\n"))
    assert reply["rc"] == 1 and t.is_alive()


def test_server_shutdown(work, monkeypatch):
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    sock = os.path.join(work, "d")
    t = _start(tcli.serve, sock)
    assert _raw(sock, b'{"op": "shutdown"}\n') == b'{"rc": 0, "output": "bye"}\n'
    t.join(timeout=60)
    assert not t.is_alive() and not os.path.exists(sock)


def test_cuda_server_without_a_card_exits_1(work, monkeypatch, capsys):
    monkeypatch.delenv(tcli.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sock = os.path.join(work, "c")
    assert tcli.main(["-server", sock]) == 1
    assert not os.path.exists(sock)
    assert "is_available() is false" in capsys.readouterr().err


def test_failed_request_leaves_no_thread(server, work, monkeypatch):
    """A build that fails mid-ingest (after its first block) stops the
    ingest threads and closes the input before the server replies."""
    sock, _ = server
    fa = os.path.join(work, "big.fa")
    rng = np.random.RandomState(3)
    genome = rng.randint(0, 4, 200_000)
    starts = rng.randint(0, genome.size - 150, 30_000)
    with open(fa, "w") as f:
        for i, s in enumerate(starts):
            f.write(f">r{i}\n{''.join('ACGT'[c] for c in genome[s:s + 150])}\n")
    args = ["-in", fa, "-kmer-size", "31", "-verbose", "0"]
    assert tcli.connect(sock, args + ["-out", os.path.join(work, "big")]) == 0
    before = threading.active_count()
    real = tengine._RangeCounter.insert
    seen = []

    def fail_on_second(self, *a):
        seen.append(1)
        if len(seen) == 2:
            raise RuntimeError("injected failure mid-ingest")
        return real(self, *a)

    monkeypatch.setattr(tengine._RangeCounter, "insert", fail_on_second)
    reply = json.loads(_raw(sock, json.dumps(
        {"argv": args + ["-out", os.path.join(work, "failed")]}).encode()
        + b"\n"))
    assert reply["rc"] == 1 and "injected failure" in reply["output"]
    assert len(seen) == 2
    assert threading.active_count() == before, threading.enumerate()


def test_abandoned_ingest_stops_reading(work, monkeypatch):
    """A stream abandoned after its first block (a request failing
    mid-ingest) stops its reader at the next chunk: it neither reads the
    rest of the file nor leaves a thread behind."""
    from bcalm_tpu_torch.io import parallel_ingest

    fa = os.path.join(work, "stream.fa")
    rng = np.random.RandomState(5)
    with open(fa, "w") as f:
        for i in range(4000):
            f.write(f">r{i}\n{''.join('ACGT'[c] for c in rng.randint(0, 4, 150))}\n")
    size = os.path.getsize(fa)
    real_open = parallel_ingest._open_raw
    read = [0]

    class Counted:
        def __init__(self, f):
            self.f = f

        def read(self, n):
            piece = self.f.read(n)
            read[0] += len(piece)
            return piece

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()

    monkeypatch.setattr(parallel_ingest, "_open_raw",
                        lambda path: Counted(real_open(path)))
    before = threading.active_count()
    stream = parallel_ingest.iter_blocks_parallel(
        fa, 31, block_reads=16, max_len=160, n_workers=2, chunk_bytes=4096)
    next(stream)
    stream.close()
    assert threading.active_count() == before, threading.enumerate()
    # the probe's 256 bytes, the chunks queued and in parsing (2 workers:
    # at most 4 queued, 4 pending) and the one the reader held
    assert read[0] <= 256 + 10 * 4096 < size // 4, (read[0], size)


_CLIENT = """
import sys
from bcalm_tpu_torch.__main__ import run
sys.argv = ["bcalm_tpu_torch"] + sys.argv[1:]
rc = run()
print("torch imported" if "torch" in sys.modules else "no torch", rc)
"""


@pytest.mark.parametrize("what", ["-version", "-help", "-connect"])
def test_light_client_imports_no_torch(server, work, what):
    sock, _ = server
    argv, rc = {"-version": (["-version"], 0),
                "-help": (["-in", "x.fa", "-help"], 0),
                "-connect": (["-connect", sock, "-in",
                              os.path.join(work, "nope.fa")], 1)}[what]
    proc = subprocess.run([sys.executable, "-c", _CLIENT, *argv],
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.splitlines()[-1] == f"no torch {rc}", proc.stderr


# ---- the compaction-OOM respawn ----

def _tiny(tmp_path):
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">r{i}\n{TINY}\n" for i in range(3)))
    return ["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
            "-verbose", "0"]


def test_compaction_oom_respawns_skip_bcalm(tmp_path, monkeypatch):
    """A CompactionOOM from the build re-execs the same command with
    -skip-bcalm in a fresh process and returns the child's exit code; a
    respawned child (BTPU_NO_RESPAWN=1) never loops."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    monkeypatch.delenv("BTPU_NO_RESPAWN", raising=False)

    def boom(*a, **kw):
        raise tengine.CompactionOOM("device allocator exhausted during "
                                    "compaction")

    monkeypatch.setattr(tengine, "build_from_blocks", boom)
    calls = []

    def fake_call(cmd, env=None):
        calls.append((cmd, env))
        return 0

    monkeypatch.setattr(subprocess, "call", fake_call)
    args = _tiny(tmp_path)
    assert tcli.main(args) == 0
    assert len(calls) == 1
    cmd, env = calls[0]
    assert cmd[:3] == [sys.executable, "-m", "bcalm_tpu_torch"]
    assert cmd[3:] == args + ["-skip-bcalm"]
    assert env["BTPU_NO_RESPAWN"] == "1"
    assert env[tcli.DEVICE_ENV] == "cpu"      # the same device
    monkeypatch.setenv("BTPU_NO_RESPAWN", "1")
    calls.clear()
    with pytest.raises(tengine.CompactionOOM):
        tcli.main(args)
    assert not calls


def test_is_resource_exhausted_classifier():
    assert tengine._is_resource_exhausted(
        RuntimeError("RESOURCE_EXHAUSTED: TPU backend error"))
    assert tengine._is_resource_exhausted(
        RuntimeError("TPU backend error (ResourceExhausted)"))
    assert tengine._is_resource_exhausted(
        torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"))
    assert tengine._is_resource_exhausted(
        torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not tengine._is_resource_exhausted(ValueError("shape mismatch"))


def _multipass_cfg():
    return tengine.EngineConfig(k=31, chunk_kmers=1024, resident_kmers=2048,
                                block_reads=16, max_len=160)


@pytest.mark.parametrize("with_store, error, raised", [
    (True, torch.OutOfMemoryError, tengine.CompactionOOM),
    (False, torch.OutOfMemoryError, torch.OutOfMemoryError),
    (True, ValueError, ValueError),
])
def test_multipass_compaction_error_classified(tmp_path, monkeypatch,
                                               with_store, error, raised):
    """Only the multi-pass path with a store turns the allocator's death
    in compaction into CompactionOOM, after the checkpoint."""
    fa = tmp_path / "reads.fa"
    write_reads(fa)
    reads = [line.strip() for line in open(fa) if not line.startswith(">")]

    def fail(*a, **kw):
        raise error("injected")

    monkeypatch.setattr(tengine, "compact_from_counts", fail)
    store = Store(str(tmp_path / "o")) if with_store else None
    cfg = _multipass_cfg()
    blocks = tengine.packing.iter_blocks(reads, cfg.k,
                                         block_reads=cfg.block_reads,
                                         max_len=cfg.max_len)
    with pytest.raises(raised) as info:
        tengine.build_from_blocks(blocks, cfg, "cpu", store=store)
    if raised is tengine.CompactionOOM:
        assert isinstance(info.value.__cause__, torch.OutOfMemoryError)
        assert store.exists()


def test_respawned_child_writes_the_bytes(reference, tmp_path, monkeypatch):
    """A multi-pass CLI build whose compaction runs out of memory (torch's
    error, injected in this process) respawns; the real child resumes
    from the checkpoint on the same device and writes bcalm_tpu's bytes."""
    fa, want = reference
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    monkeypatch.delenv("BTPU_NO_RESPAWN", raising=False)
    real = tengine.build_from_blocks
    seen = {}

    def small_budget(blocks, cfg, device, reread=None, **kw):
        cfg.block_reads, cfg.chunk_kmers, cfg.resident_kmers = 16, 1024, 2048
        seen["store"] = kw.get("store")
        return real(blocks, cfg, device, reread=reread, **kw)

    def oom(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(tengine, "build_from_blocks", small_budget)
    monkeypatch.setattr(tengine, "compact_from_counts", oom)
    out = str(tmp_path / "resp")
    assert tcli.main(_args(fa) + ["-out", out]) == 0
    assert seen["store"] is not None
    with open(out + ".unitigs.fa", "rb") as f:
        assert f.read() == want
    assert not os.path.exists(out + "_btpu")


def test_server_respawn_output_reaches_the_client(reference, server, work,
                                                  monkeypatch):
    """A server request whose compaction runs out of memory respawns; the
    child's standard output (its `wrote` line) comes back in the reply,
    and the child writes bcalm_tpu's bytes."""
    fa, want = reference
    sock, t = server
    monkeypatch.delenv("BTPU_NO_RESPAWN", raising=False)
    real = tengine.build_from_blocks

    def small_budget(blocks, cfg, device, reread=None, **kw):
        cfg.block_reads, cfg.chunk_kmers, cfg.resident_kmers = 16, 1024, 2048
        return real(blocks, cfg, device, reread=reread, **kw)

    def oom(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(tengine, "build_from_blocks", small_budget)
    monkeypatch.setattr(tengine, "compact_from_counts", oom)
    out = os.path.join(work, "srv_respawn")
    reply = json.loads(_raw(sock, json.dumps(
        {"argv": _args(fa) + ["-out", out, "-verbose", "1"]}).encode()
        + b"\n"))
    assert reply["rc"] == 0 and t.is_alive()
    assert "wrote " in reply["output"] and "-> " + out in reply["output"]
    with open(out + ".unitigs.fa", "rb") as f:
        assert f.read() == want
    assert not os.path.exists(out + "_btpu")
