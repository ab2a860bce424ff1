"""Parallel single-file ingest: decompress thread + parse worker pool.

The common production input is ONE big fastq.gz/fasta.gz — the per-file
fan-out (utils.dispatcher.parallel_files) gives it a single worker
(round-4 VERDICT weak #5).  gzip inflation is inherently serial, but
parsing + 2-bit packing is not: a reader thread inflates (zlib's C core
releases the GIL) and cuts the decompressed stream into RECORD-ALIGNED
chunks; a pool of workers parses each chunk with the native memory
parser (io.native.parse_chunk_native, GIL-free in C); chunks are emitted
IN ORDER so block sequence — and therefore first-occurrence keys, unitig
ids and orientations — stay deterministic (the determinism edge over
the reference that README documents).

Record alignment:
  FASTA — split at the last b"\\n>" of each piece;
  FASTQ — split at the start of the last complete 4-line record
  (each emitted chunk starts at a record boundary, so line phase is 0
  within every chunk).

The reference's analog is gatb's Dispatcher fanning one bank's
sequences to -nb-cores threads (SURVEY.md §3.2).

Copy of ``bcalm_tpu/io/parallel_ingest.py`` with the imports pointed at this package
(the port imports nothing of the JAX package); an abandoned stream stops
its reader at the next chunk and waits for the chunks in parsing, so it
leaves no thread behind and reads no further.
"""

from __future__ import annotations

import concurrent.futures as cf
import gzip
import threading
from queue import Queue
from typing import Iterator

from bcalm_tpu_torch.io import native as native_mod
from bcalm_tpu_torch.io.packing import ReadBlock


def _open_raw(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _split_point(buf: bytes, is_fastq: bool) -> int:
    """Largest prefix length that ends exactly at a record boundary
    (0 = no complete record boundary inside)."""
    if not is_fastq:
        pos = buf.rfind(b"\n>")
        return pos + 1 if pos >= 0 else 0
    # FASTQ: the chunk starts at a record start, so line j starts a
    # record iff j % 4 == 0; take the last such complete line start
    n_nl = buf.count(b"\n")
    want = (n_nl // 4) * 4
    if want == 0:
        return 0
    # position after the want-th newline = start of line `want`
    pos = -1
    for _ in range(want):
        pos = buf.find(b"\n", pos + 1)
    return pos + 1


def iter_blocks_parallel(path: str, k: int, block_reads: int = 4096,
                         max_len: int = 512, n_workers: int = 4,
                         chunk_bytes: int = 16 << 20,
                         ) -> Iterator[ReadBlock]:
    """Ordered parallel ReadBlock stream of one FASTA/FASTQ(.gz)."""
    first = b""
    with _open_raw(path) as probe:
        while len(first) < 256:
            piece = probe.read(256)
            if not piece:
                break
            first += piece
    stripped = first.lstrip()
    is_fastq = stripped.startswith(b"@")

    chunk_q: "Queue" = Queue(maxsize=n_workers * 2)
    err: list = []
    stop = threading.Event()

    def reader():
        try:
            carry = b""
            with _open_raw(path) as f:
                while True:
                    if stop.is_set():
                        return      # the consumer left: read no further
                    piece = f.read(chunk_bytes)
                    if not piece:
                        break
                    buf = carry + piece
                    cut = _split_point(buf, is_fastq)
                    if cut == 0:
                        carry = buf
                        continue
                    chunk_q.put(buf[:cut])
                    carry = buf[cut:]
            if carry.strip():
                chunk_q.put(carry)
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            err.append(e)
        finally:
            chunk_q.put(None)

    t = threading.Thread(target=reader, daemon=True)
    t.start()

    pool = cf.ThreadPoolExecutor(max_workers=n_workers)
    try:
        pending = []      # ordered futures
        done_reading = False
        while True:
            # keep the pool fed ahead of consumption
            while not done_reading and len(pending) < 2 * n_workers:
                chunk = chunk_q.get()
                if chunk is None:
                    done_reading = True
                    break
                pending.append(pool.submit(
                    native_mod.parse_chunk_native, chunk, k,
                    block_reads, max_len))
            if not pending:
                break
            fut = pending.pop(0)      # ordered emission: determinism
            for block in fut.result():
                yield block
        t.join()
        if err:
            raise err[0]
    finally:
        # consumer may abandon the generator mid-stream (GeneratorExit):
        # stop the reader at its next chunk and drain the queue so the
        # blocked reader thread can exit instead of leaking with ~100s of
        # MB of buffered chunks; the chunks in parsing finish before this
        # returns, so no pool thread outlives it
        stop.set()
        pool.shutdown(wait=True, cancel_futures=True)
        while t.is_alive():
            try:
                item = chunk_q.get_nowait()
            except Exception:   # noqa: BLE001 — queue.Empty
                item = False
            if item is None:
                break
            if item is False:
                import time as _t
                _t.sleep(0.01)
        t.join(timeout=5)
