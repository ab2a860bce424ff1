"""Host-side block prefetcher (gatb Dispatcher/ThreadPool analog).

The reference fans sequences out to worker threads with
`Dispatcher::iterate(bank, functor, nbCores)` (SURVEY.md §3.2) backed by
the vendored ThreadPool/ConcurrentQueue.  On the TPU pipeline the only
host-side parallel work is ingest (parse + pack), so the analog is a small
producer pool that keeps packed ReadBlocks ready ahead of device compute,
overlapping host I/O with TPU execution.

Copy of ``bcalm_tpu/utils/dispatcher.py`` with the imports pointed at this package
(the port imports nothing of the JAX package), and one change that leaves
the stream as it was: a consumer that stops early (the generator closed, as
when a build fails mid-ingest in a server process) stops the workers,
which close their source iterators, and joins them, where the copy's
workers stayed blocked on a full queue with their files open.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def _stop(threads, q: "queue.Queue", stop: threading.Event) -> None:
    """Stop the workers: drain the queue, which unblocks any put, until
    each has left."""
    stop.set()
    while any(t.is_alive() for t in threads):
        try:
            q.get(timeout=0.01)
        except queue.Empty:
            pass
    for t in threads:
        t.join()


def _feed(it: Iterable[T], q: "queue.Queue", stop: threading.Event) -> None:
    """A worker's loop: put the items of `it` until it ends or the
    consumer stops; then close `it` (in this thread, which runs it)."""
    try:
        for item in it:
            q.put(item)
            if stop.is_set():
                break
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def prefetch(it: Iterable[T], depth: int = 4) -> Iterator[T]:
    """Run `it` in a background thread, buffering up to `depth` items."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: List[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            _feed(it, q, stop)
        except BaseException as e:  # noqa: BLE001 — re-raised on consumer side
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
    finally:
        _stop([t], q, stop)
    if err:
        raise err[0]


def parallel_files(paths: List[str], make_iter: Callable[[str], Iterable[T]],
                   n_workers: int = 2, depth: int = 8) -> Iterator[T]:
    """Iterate several files' blocks with a worker pool, preserving a
    deterministic per-file order (files interleave, blocks within a file
    stay ordered — block order never affects counting results)."""
    if n_workers <= 1 or len(paths) <= 1:
        for p in paths:
            yield from prefetch(make_iter(p), depth=depth)
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: List[BaseException] = []
    stop = threading.Event()

    def worker(my_paths: List[str]):
        try:
            for p in my_paths:
                if stop.is_set():
                    break
                _feed(make_iter(p), q, stop)
        except BaseException as e:  # noqa: BLE001
            err.append(e)
        finally:
            q.put(_SENTINEL)

    shards = [paths[i::n_workers] for i in range(n_workers)]
    shards = [s for s in shards if s]
    threads = [threading.Thread(target=worker, args=(s,), daemon=True)
               for s in shards]
    for t in threads:
        t.start()
    try:
        done = 0
        while done < len(threads):
            item = q.get()
            if item is _SENTINEL:
                done += 1
                continue
            yield item
    finally:
        _stop(threads, q, stop)
    if err:
        raise err[0]
