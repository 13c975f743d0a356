"""Per-stage profiling: timing struct and counters.

The TPU re-expression of the reference's compile-time MEASURE_* timing
macros (chain_hardware.h:39-45: MEASURE_CHAINING_TIME,
MEASURE_CORE_CHAINING_TIME, MEASURE_CHAINING_TIME_HW_FINE) and its OpenCL
profiling queues (chain_hardware.cpp:374). Instead of recompiling with
macros, `--profile` turns on a process-wide stage accumulator
(seed/chain/align/emit/...) reported as a table on exit.

Overhead when disabled: one module-bool check per stage entry.

The port's copy of `mm2tpu/utils/profiling.py`, verbatim apart from its
imports and its TPU branches: the jax.profiler trace of `--profile-trace`
is not copied (the port's CLI refuses that option, ROADMAP M10).
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

import threading as _threading

enabled = False
_acc: Dict[str, List[float]] = {}   # name -> [seconds, calls]
counters: Dict[str, float] = {}     # name -> accumulated count
_cnt_lock = _threading.Lock()


def reset() -> None:
    _acc.clear()
    counters.clear()


def count(name: str, v: float = 1.0) -> None:
    """Accumulate a quantity (launch counts, wire bytes, anchors) under
    `name` — the evidence feed for bench.py's device-path accounting
    (the reference's MEASURE_CHAINING_TIME_HW_FINE analogue). Locked:
    callers include ExtBatcher worker threads and -t N mapping threads."""
    if enabled:
        with _cnt_lock:
            counters[name] = counters.get(name, 0.0) + v


def enable() -> None:
    global enabled
    enabled = True
    reset()


def disable() -> None:
    global enabled
    enabled = False


@contextmanager
def stage(name: str):
    """Accumulate wall time under `name`. Nestable; each level accounts
    its own wall (inner stages are not subtracted — the table reports the
    hierarchy by dotted names, e.g. 'chain.device')."""
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t0)


def add(name: str, seconds: float, calls: int = 1) -> None:
    """Record externally-measured time (e.g. device time from a bench).
    Locked, as `count` is."""
    if enabled:
        with _cnt_lock:
            s = _acc.setdefault(name, [0.0, 0])
            s[0] += seconds
            s[1] += calls


def snapshot() -> Dict[str, Tuple[float, int]]:
    return {k: (v[0], v[1]) for k, v in _acc.items()}


def report(file=None) -> str:
    """Render + print the stage table (sorted by total time)."""
    file = file if file is not None else sys.stderr
    rows = sorted(_acc.items(), key=lambda kv: -kv[1][0])
    total = sum(v[0] for k, v in rows if "." not in k)
    lines = ["[PROF] %-24s %10s %9s %12s" % ("stage", "total_s", "calls",
                                             "ms/call")]
    for name, (sec, calls) in rows:
        lines.append("[PROF] %-24s %10.3f %9d %12.3f"
                     % (name, sec, calls, sec * 1e3 / max(calls, 1)))
    lines.append("[PROF] %-24s %10.3f  (top-level stages)" % ("SUM", total))
    for name in sorted(counters):  # routing/wire evidence counters
        lines.append("[PROF] %-24s %14.0f" % (name, counters[name]))
    out = "\n".join(lines)
    print(out, file=file)
    return out
