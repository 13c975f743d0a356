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

Overhead when disabled: one module-bool check per stage entry, which
then returns the shared no-op context `NO_STAGE`, and one per `timed`
call, which then calls straight through.

The port's copy of `mm2tpu/utils/profiling.py`, verbatim apart from its
imports, the lock in `add` and the trace: where the JAX
package takes a `jax.profiler` trace, `trace_if_enabled` takes a
`torch.profiler` one, with CPU activity and, on a card, CUDA activity
(each kernel launch of the port's library is a named device event),
from every thread (`profile_all_threads`: the `-t` pool of stream mode
and the extension batcher's align threads map off the main thread),
without shapes or stacks. While it runs, `stage(name)` also opens a
`record_function` range of its name (through the two operators that
`torch.profiler.record_function` calls), so the trace shows the stage
names of the `--profile` table. `timed(name, fn, ...)` adds a call's
seconds to the table under `name` and opens no range: the calls into
the native runtime (`seed.native`, `post.native`) nest inside ranges
the trace already has. `count("fallback.<op>")` counts each run of a
Python twin where the native runtime would have run the call.
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager, nullcontext
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
    """Accumulate a quantity (launches, anchors, fills, fall-backs to
    Python) under `name`, printed by `report` and read by the
    benchmark's per-layer metrics (`gpubench/metrics/`). Locked: callers
    include ExtBatcher worker threads and -t N mapping threads."""
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


# what `stage` returns while profiling is off: one shared no-op context
NO_STAGE = nullcontext()


def stage(name: str):
    """Accumulate wall time under `name`. Nestable; each level accounts
    its own wall (inner stages are not subtracted — the table reports the
    hierarchy by dotted names, e.g. 'chain.device'). While profiling is
    off it returns `NO_STAGE`."""
    if not enabled:
        return NO_STAGE
    return _Stage(name)


class _Stage:
    """A stage while profiling is on; while a trace runs, also a
    `record_function` range of its name."""
    __slots__ = ("name", "t0", "rec")

    def __init__(self, name: str):
        self.name = name

    # The seconds count the range's opening; the bookkeeping lies inside
    # the range, so that little of a stage's cost falls between ranges.
    def __enter__(self):
        self.t0 = time.perf_counter()
        self.rec = _rf_open(self.name, None) if _trace_active else None

    def __exit__(self, *exc):
        add(self.name, time.perf_counter() - self.t0)
        if self.rec is not None:
            with _rf_guard():
                _rf_close(self.rec)
        return False


# While a trace runs: the two operators that
# `torch.profiler.record_function` calls to open and close a range, and
# the guard it closes one under. A stage calls them directly: the Python
# layers around them cost time that falls mostly between the ranges.
_rf_open = _rf_close = _rf_guard = None


def _bind_range_ops() -> None:
    global _rf_open, _rf_close, _rf_guard
    import torch
    ops = torch.ops.profiler
    enter = ops._record_function_enter_new.default
    exit_ = ops._record_function_exit._RecordFunction
    _rf_open = getattr(enter, "_op", enter)
    _rf_close = getattr(exit_, "_op", exit_)
    _rf_guard = torch._C.DisableTorchFunctionSubclass


def timed(name: str, fn, *args, **kw):
    """`fn(*args, **kw)`, its seconds added to `name` while profiling is
    on: a stage of the table that opens no trace range."""
    if not enabled:
        return fn(*args, **kw)
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
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
    _bind_range_ops()
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
