"""Per-stage wall-clock accounting (gatb TimeInfo analog) + peak-RSS probe
(the reference ships scripts/memused polling /proc VmHWM — cited
SURVEY.md §6).

Copy of ``bcalm_tpu/utils/timeinfo.py`` with the imports pointed at this package:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class TimeInfo:
    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextmanager
    def timer(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0

    def report(self) -> Dict[str, float]:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))


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
