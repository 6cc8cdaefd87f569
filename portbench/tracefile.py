"""Reading a ``torch.profiler`` Chrome trace: device intervals, their union,
the time of named device operations, and the idle gaps between them.

Times in the trace are microseconds; everything returned here is seconds.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals, lo: float, hi: float):
    """(start, end) of every stretch of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def op_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0].split("<", 1)[0]
    return name.strip().split(" ")[-1].split("::")[-1]


class Trace:
    """Device intervals and the benchmark's spans of one traced window."""

    def __init__(self, path: Path, window_span: str):
        events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]

        def interval(e):
            start = float(e["ts"]) / 1e6
            return start, start + float(e.get("dur", 0)) / 1e6

        self.device = [(e["cat"], e.get("name", ""), *interval(e)) for e in events
                       if e.get("cat") in DEVICE_KINDS]
        self.spans = [(e["name"], *interval(e)) for e in events
                      if e.get("cat") == "user_annotation"]
        windows = [(a, b) for name, a, b in self.spans if name == window_span]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} '{window_span}' spans")
        self.lo, self.hi = windows[0]

    def intervals(self, kind=None, name_part=None):
        return [(a, b) for k, n, a, b in self.device
                if (kind is None or k == kind) and (name_part is None or name_part in n)]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return union_s([(max(a, self.lo), min(b, self.hi)) for a, b in self.intervals()
                        if b > self.lo and a < self.hi])

    def op_seconds(self, ops) -> dict:
        """Seconds of device time of each named operation found in the trace."""
        out = defaultdict(float)
        for kind, name, a, b in self.device:
            if kind == "kernel" and op_name(name) in ops:
                out[op_name(name)] += b - a
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps inside the window, each named by the innermost benchmark span
        the host was in at its middle."""
        by_op = defaultdict(float)
        for kind, name, a, b in self.device:
            by_op[op_name(name) if kind == "kernel" else name] += b - a
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps(self.intervals(), self.lo, self.hi), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[name, s] for name, s in ops],
                "idle_gaps": [[self.span_at((a + b) / 2), b - a] for a, b in idle]}

    def span_at(self, t: float) -> str:
        inner = [(b - a, name) for name, a, b in self.spans if a <= t <= b]
        return min(inner)[1] if inner else "outside any span"
