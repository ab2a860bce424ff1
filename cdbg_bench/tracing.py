"""Reduction of a traced window to the numbers the per-layer metrics
read: the device's busy intervals, the harness's spans, the device time
inside each span, every device operation's time, the longest idle gaps,
and the program's kernels launched inside each launch span.

A trace here is plain data, so that tests can hand it a recorded one:

    {"device":   [(name, start_ns, end_ns, correlation), ...],  # kernels,
                                                  # copies, sets
     "launched": [(correlation, host_start_ns), ...],  # CUDA API calls
     "spans":    [(name, start_ns, end_ns), ...]}      # the harness's spans

``collect`` makes one from a finished ``torch.profiler.profile``.  A
span that the harness synchronises at both edges holds all the device
work launched inside it, so the device time inside such a span is the
busy time that falls between its edges.  A span that is not synchronised
is matched to its kernels by launch: the CUDA call that launched a
kernel carries the kernel's correlation id, and lies inside the span on
the host's clock.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

WINDOW = "cdbg.window"
LAUNCH = "cdbg.launch."
NAME_CHARS = 120   # a device operation's name in the breakdown
# parts of the names of device operations that torch and its libraries
# launch (fills, copies, sorts), which a launch span may hold beside the
# program's own kernels
LIBRARY_OPS = ("at::", "cub::", "Memcpy", "Memset", "memcpy", "memset")


def collect(prof) -> Dict[str, list]:
    """Device operations, CUDA API calls and ``cdbg.*`` spans of a
    finished profile."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    device, launched, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cpu:
            if e.is_user_annotation():
                if name.startswith("cdbg."):
                    spans.append((name, e.start_ns(), e.end_ns()))
            elif name.startswith("cu") and e.correlation_id():
                # a runtime or driver call (cudaLaunchKernel, cuLaunchKernel)
                launched.append((e.correlation_id(), e.start_ns()))
        elif not e.is_user_annotation() and not name.startswith("cdbg."):
            # kernels, copies and sets; the device-side copies of the
            # harness's annotations are left out
            device.append((name, e.start_ns(), e.end_ns(),
                           e.correlation_id()))
    return {"device": device, "launched": launched, "spans": spans}


def merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of intervals as sorted disjoint intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Busy:
    """The device's busy time as a union of intervals, queried by span."""

    def __init__(self, device_events, lo: int, hi: int):
        clipped = [(max(a, lo), min(b, hi)) for _, a, b, _ in device_events
                   if b > lo and a < hi]
        self.merged = merge(clipped)
        self.starts = [a for a, _ in self.merged]
        self.lo, self.hi = lo, hi
        self.cum = [0]
        for a, b in self.merged:
            self.cum.append(self.cum[-1] + b - a)

    def total_ns(self) -> int:
        return self.cum[-1]

    def _upto(self, t: int) -> int:
        """Busy time before t."""
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0
        a, b = self.merged[i - 1]
        return self.cum[i - 1] + min(b, t) - a

    def within(self, a: int, b: int) -> int:
        return self._upto(b) - self._upto(a)

    def gaps(self) -> List[Tuple[int, int]]:
        out, t = [], self.lo
        for a, b in self.merged:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.hi > t:
            out.append((t, self.hi))
        return out


def innermost(spans: Sequence[Tuple[str, int, int]], t: int) -> str:
    """The latest-starting span open at t (the host's innermost stage)."""
    best, start = "outside spans", None
    for name, a, b in spans:
        if a <= t < b and name != WINDOW and (start is None or a >= start):
            best, start = name, a
    return best


def host_stages(spans: Sequence[Tuple[str, int, int]], a: int, b: int) -> str:
    """What the host was doing through [a, b): the innermost spans in
    time order, each with its share of the interval in ms."""
    cuts = sorted({a, b} | {t for _, s, e in spans for t in (s, e)
                            if a < t < b})
    parts: List[List] = []
    for lo, hi in zip(cuts, cuts[1:]):
        name = innermost(spans, lo)
        if parts and parts[-1][0] == name:
            parts[-1][1] += hi - lo
        else:
            parts.append([name, hi - lo])
    return " > ".join(f"{n} {t / 1e6:.0f}ms" for n, t in parts
                      if t >= 1e6 or len(parts) == 1)[:NAME_CHARS]


def reduce(trace: Dict[str, list], top: int = 10) -> Dict:
    """The window's busy and idle time, the device time inside each span
    name (summed over its instances), every device operation's time
    (longest first), the `top` longest idle gaps named by what the host was
    doing through them, and the number of the program's kernels launched
    inside each launch span, in order."""
    windows = [(a, b) for n, a, b in trace["spans"] if n == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"expected one {WINDOW} span, found {len(windows)}")
    lo, hi = windows[0]
    busy = Busy(trace["device"], lo, hi)
    spans = sorted((s for s in trace["spans"] if s[1] < hi and s[2] > lo),
                   key=lambda s: s[1])
    span_device_ns: Dict[str, int] = defaultdict(int)
    span_wall_ns: Dict[str, int] = defaultdict(int)
    span_count: Dict[str, int] = defaultdict(int)
    for name, a, b in spans:
        span_device_ns[name] += busy.within(a, b)
        span_wall_ns[name] += b - a
        span_count[name] += 1
    by_op: Dict[str, int] = defaultdict(int)
    for name, a, b, _ in trace["device"]:
        if b > lo and a < hi:
            by_op[name[:NAME_CHARS]] += min(b, hi) - max(a, lo)
    ops = sorted(by_op.items(), key=lambda x: -x[1])
    gaps = sorted(busy.gaps(), key=lambda g: g[0] - g[1])[:top]
    # the program's kernels by the host time of the call that launched
    # them; a kernel whose call the trace lacks is not counted
    launched = dict(trace["launched"])
    calls = sorted(launched[c] for n, _, _, c in trace["device"]
                   if c in launched and not any(p in n for p in LIBRARY_OPS))
    launches = []
    for name, a, b in spans:
        if name.startswith(LAUNCH):
            n = bisect.bisect_left(calls, b) - bisect.bisect_left(calls, a)
            launches.append((name[len(LAUNCH):], n))
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy.total_ns() / 1e9,
        "span_device_s": {k: v / 1e9 for k, v in span_device_ns.items()},
        "span_wall_s": {k: v / 1e9 for k, v in span_wall_ns.items()},
        "span_count": dict(span_count),
        "device_ops": [[n, t / 1e9] for n, t in ops],
        "idle_gaps": [[host_stages(spans, a, b), (b - a) / 1e9]
                      for a, b in gaps],
        "launch_ops": launches,
    }
