"""Phase-boundary tracing: wall/CPU time + peak RSS logging
(reference: misc.c realtime/cputime/peakrss; log lines main.c:396-398,
index.c:365-371, map.c:616-617, trailer main.c:432-438).

The port's copy of `mm2tpu/utils/timing.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

import resource
import sys
import time

_T0 = time.monotonic()

verbose = 3  # mm_verbose equivalent (misc.c:4); set by the CLI's -v


def realtime() -> float:
    """Seconds since process start (misc.c realtime)."""
    return time.monotonic() - _T0


def cputime() -> float:
    """User+system CPU seconds, self + children (misc.c cputime)."""
    ru_s = resource.getrusage(resource.RUSAGE_SELF)
    ru_c = resource.getrusage(resource.RUSAGE_CHILDREN)
    return (ru_s.ru_utime + ru_s.ru_stime +
            ru_c.ru_utime + ru_c.ru_stime)


def peakrss() -> int:
    """Peak RSS in bytes (misc.c peakrss; Linux reports KB)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    mul = 1024 if sys.platform != "darwin" else 1
    return ru.ru_maxrss * mul


def log(func: str, msg: str, min_verbose: int = 3) -> None:
    """stderr `[M::func::real*cpu] msg` line (e.g. index.c:366)."""
    if verbose >= min_verbose:
        rt = realtime()
        print("[M::%s::%.3f*%.2f] %s"
              % (func, rt, cputime() / rt if rt > 0 else 0.0, msg),
              file=sys.stderr)


def log_trailer(version: str, cmdline: str) -> None:
    """Final CMD/Version/Real-time/RSS trailer (main.c:432-438)."""
    if verbose >= 3:
        print("[M::main] Version: %s" % version, file=sys.stderr)
        print("[M::main] CMD: %s" % cmdline, file=sys.stderr)
        print("[M::main] Real time: %.3f sec; CPU: %.3f sec; "
              "Peak RSS: %.3f GB"
              % (realtime(), cputime(), peakrss() / 1024.0 ** 3),
              file=sys.stderr)
