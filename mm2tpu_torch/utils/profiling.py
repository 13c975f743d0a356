"""Per-stage profiling: timing struct, counters and an optional
torch.profiler trace.

The TPU re-expression of the reference's compile-time MEASURE_* timing
macros (chain_hardware.h:39-45: MEASURE_CHAINING_TIME,
MEASURE_CORE_CHAINING_TIME, MEASURE_CHAINING_TIME_HW_FINE) and its OpenCL
profiling queues (chain_hardware.cpp:374). Instead of recompiling with
macros, `--profile` turns on a process-wide stage accumulator
(seed/chain/align/emit/...) reported as a table on exit, and
`--profile-trace DIR` additionally captures a torch.profiler trace of
the mapping loop into DIR, in TensorBoard's layout (one
`*.pt.trace.json` a process, which Perfetto and chrome://tracing also
open).

Overhead when disabled: one module-bool check per stage entry.

The port's copy of `mm2tpu/utils/profiling.py`, verbatim apart from its
imports, the lock in `add` and the trace: where the JAX
package takes a `jax.profiler` trace, `trace_if_enabled` takes a
`torch.profiler` one, with CPU activity and, on a card, CUDA activity
(each kernel launch of the port's library is a named device event),
from every thread (`profile_all_threads`: the `-t` pool of stream mode
and the extension batcher's align threads map off the main thread),
without shapes or stacks. While it runs, `stage(name)` also opens
`torch.profiler.record_function(name)`, so the trace shows the stage
names of the `--profile` table.
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import threading as _threading

enabled = False
_acc: Dict[str, List[float]] = {}   # name -> [seconds, calls]
counters: Dict[str, float] = {}     # name -> accumulated count
_cnt_lock = _threading.Lock()
_trace_dir: Optional[str] = None
_trace_active = False


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


def enable(trace_dir: Optional[str] = None) -> None:
    global enabled, _trace_dir
    enabled = True
    _trace_dir = trace_dir
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
        if _trace_active:
            import torch
            with torch.profiler.record_function(name):
                yield
        else:
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


def end_trace() -> None:
    """Forget the trace directory: a later run traces only if it asks."""
    global _trace_dir
    _trace_dir = None


@contextmanager
def trace_if_enabled(device=None):
    """torch.profiler trace around the mapping loop when --profile-trace
    gave a directory, written there when the block ends; CUDA activity
    too when `device` is a card. A no-op otherwise, and inside a trace
    already running. The stages `trace.start` and `trace.write` time the
    trace's start (the first in a process sets up the profiler's
    tracing) and its end (the events gathered and written)."""
    global _trace_active
    if not (enabled and _trace_dir) or _trace_active:
        yield
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    act = torch.profiler.ProfilerActivity
    on_card = device is not None and torch.device(device).type == "cuda"
    prof = torch.profiler.profile(
        activities=[act.CPU] + ([act.CUDA] if on_card else []),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(_trace_dir),
        record_shapes=False, with_stack=False,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    t0 = time.perf_counter()
    prof.start()
    add("trace.start", time.perf_counter() - t0)
    _trace_active = True
    try:
        yield
    finally:
        _trace_active = False
        t0 = time.perf_counter()
        prof.stop()     # writes the trace
        add("trace.write", time.perf_counter() - t0)


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
    if _trace_dir:
        lines.append("[PROF] torch.profiler trace written to %s"
                     % _trace_dir)
    out = "\n".join(lines)
    print(out, file=file)
    return out
