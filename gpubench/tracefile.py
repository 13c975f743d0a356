"""Reading a torch.profiler trace (Chrome's JSON) over the window.

The window is the harness's `bench.window` range. Device time is the
union of the kernel, memcpy and memset events that start inside it;
ranges are every `record_function` range of every thread (the program's
`--profile` stages, the harness's `bench.*` steps and `gc`), except the
window's own.
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(iv, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


def short_name(name: str) -> str:
    """A kernel's name without its return type, its anonymous namespace
    and its argument list."""
    name = re.sub(r"^void ", "", name.strip())
    name = name.replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i].strip() or name
    return name


class Trace:
    """The window's device events and ranges, in seconds."""

    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("ph") == "X" and
               e.get("name") == WINDOW]
        if not win:
            raise ValueError("the trace holds no %s range" % WINDOW)
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = []      # (start, end, name) in microseconds
        self.ranges = []      # (start, end, name, tid)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                if self.t0 <= ts < self.t1:
                    self.device.append((ts, ts + dur, short_name(e["name"])))
            elif cat == "user_annotation" and e["name"] != WINDOW:
                if ts < self.t1 and ts + dur > self.t0:
                    self.ranges.append((ts, ts + dur, e["name"],
                                        e.get("tid")))

    @classmethod
    def load(cls, trace_dir: str) -> "Trace":
        files = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
        if not files:
            raise ValueError("no trace written into %s" % trace_dir)
        with open(files[-1]) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self):
        return _clip(_union([(a, b) for a, b, _ in self.device]),
                     self.t0, self.t1)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device time of the events whose name matches."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, n in self.device if rx.search(n)) / 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for a, b, n in self.device:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def covered_s(self) -> float:
        """Seconds of the window in which some range is open on some
        thread."""
        iv = _clip(_union([(a, b) for a, b, _, _ in self.ranges]),
                   self.t0, self.t1)
        return sum(b - a for a, b in iv) / 1e6

    def label_at(self, t: float) -> str:
        """The innermost range open at time t on any thread (the latest
        to start), or `outside_every_stage`."""
        best = None
        for a, b, n, _ in self.ranges:
            if a <= t < b and (best is None or a > best[0]):
                best = (a, n)
        return best[1] if best else "outside_every_stage"

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest stretches of the window with no device event, each
        named by what the host was doing at its middle."""
        busy = self.busy_intervals()
        gaps, t = [], self.t0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.label_at((a + b) / 2), (b - a) / 1e6]
                for a, b in gaps[:top]]
