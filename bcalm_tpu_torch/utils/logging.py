"""Timestamped progress + memory logging.

The analog of gatb's IteratorListener/Progress console bars and the
bcalm2 logging helper (bcalm2/logging.cpp: timestamped lines with current
memory usage — reconstructed, SURVEY.md §6).

Copy of ``bcalm_tpu/utils/logging.py`` with the imports pointed at this package:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from .timeinfo import peak_rss_mb


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def log_line(msg: str, stream=None) -> None:
    """bcalm2-style timestamped log line with memory accounting."""
    stream = stream or sys.stderr
    t = time.strftime("%H:%M:%S")
    stream.write(f"[{t}] [mem: {_rss_mb():.0f}MB / peak {peak_rss_mb():.0f}MB] "
                 f"{msg}\n")
    stream.flush()


class Progress:
    """Throttled progress reporter (console progress-bar analog)."""

    def __init__(self, label: str, total: Optional[int] = None,
                 interval_s: float = 5.0, enabled: bool = True):
        self.label = label
        self.total = total
        self.interval = interval_s
        self.enabled = enabled
        self.count = 0
        self._last = time.time()
        self._t0 = self._last

    def update(self, n: int = 1) -> None:
        self.count += n
        if not self.enabled:
            return
        now = time.time()
        if now - self._last >= self.interval:
            self._last = now
            rate = self.count / max(1e-9, now - self._t0)
            frac = f" ({100.0 * self.count / self.total:.1f}%)" if self.total else ""
            log_line(f"{self.label}: {self.count}{frac}  [{rate:.3g}/s]")

    def done(self) -> None:
        if self.enabled and self.count:
            dt = time.time() - self._t0
            log_line(f"{self.label}: {self.count} done in {dt:.1f}s")
