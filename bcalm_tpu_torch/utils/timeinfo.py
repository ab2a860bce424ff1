"""Per-stage timing of a build (gatb TimeInfo analog) + peak-RSS probe
(the reference ships scripts/memused polling /proc VmHWM — cited
SURVEY.md §6).

``span(name)`` times one stage where it runs, with ``time.perf_counter``:

    with span("count") as sp:
        ...
    stats["t_count_s"] = round(sp.seconds, 2)

It adds its seconds and one call, under ``name``, to the TimeInfo that is
active (``TimeInfo.active()``: cli.main makes one per command line, so a
-server request has its own); with none active (library calls, the
server's warm-up) it only measures itself.  While torch's profiler
records, a span is also a user range named ``TRACE_PREFIX + name`` (what
``torch.profiler.record_function`` opens), so the stage's edges land on
the profiler's clock beside the device operations.  A span never synchronises the device: a
stage that must include its device work synchronises inside the span.
A child stage is named after its parent plus a dot and a word
(``count.ingest_wait`` lies inside ``count``).
"""

from __future__ import annotations

import functools
import operator
import sys
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, List, Optional

# the root of the program's ranges in a profiler trace
TRACE_PREFIX = "cdbg.bcalm."

_ACTIVE: ContextVar[Optional["TimeInfo"]] = ContextVar(
    "bcalm_tpu_torch_timeinfo", default=None)


class TimeInfo:
    """Seconds and calls of each span name, over one command line."""

    def __init__(self):
        self.spans: Dict[str, List] = {}   # name -> [seconds, calls]

    def add(self, name: str, seconds: float, calls: int = 1) -> None:
        entry = self.spans.get(name)
        if entry is None:
            self.spans[name] = [seconds, calls]
        else:
            entry[0] += seconds
            entry[1] += calls

    @contextmanager
    def active(self):
        """Make this the recorder that spans add to, until exit."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def report_lines(self) -> List[str]:
        """``[time:<name>] <s>s`` for each span name, longest first, and
        ``[calls:<name>] <n>`` after it where the span ran more than once
        or is a child stage (how often it ran inside its parent)."""
        lines = []
        for name, (secs, calls) in sorted(self.spans.items(),
                                          key=lambda kv: -kv[1][0]):
            lines.append(f"[time:{name}] {secs:.4f}s")
            if calls > 1 or "." in name:
                lines.append(f"[calls:{name}] {calls}")
        return lines


class span:
    """One timed stage (see the module docstring); ``seconds`` holds its
    time after exit.  A span that ends in an exception adds its time but
    no call (a block iterator's last fetch ends in StopIteration)."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._range = None

    # With a profiler recording, each edge's clock reading and the range's
    # own stamp are taken back to back by one C call: map() runs the range
    # call and time.perf_counter without the interpreter loop between them,
    # and the range call holds the interpreter lock, so no other thread
    # (the ingest's producer takes the lock as a block arrives) can run
    # between the two readings.
    def __enter__(self) -> "span":
        # no torch imported: no profiler can be recording
        torch = sys.modules.get("torch")
        if torch is not None and torch._C._autograd._profiler_enabled():
            ag = torch._C._autograd
            enter = functools.partial(ag._record_function_with_args_enter,
                                      TRACE_PREFIX + self.name)
            handle, self._t0 = map(operator.call, (enter, time.perf_counter))
            self._range = functools.partial(
                ag._record_function_with_args_exit, handle)
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            t, _ = map(operator.call, (time.perf_counter, self._range))
            self._range = None
        else:
            t = time.perf_counter()
        self.seconds = t - self._t0
        ti = _ACTIVE.get()
        if ti is not None:
            ti.add(self.name, self.seconds, int(exc_type is None))
        return False


def peak_rss_mb() -> float:
    """VmHWM from /proc/self/status (same source as scripts/memused:1-24)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0
