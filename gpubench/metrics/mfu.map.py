"""Device (H100): the whole window's share of the card's peak, in %: the
least time of all the kernels' counted work (K1-K4, counts.py) over the
window. A kernel taken off the path leaves its roofline silent; this
share still bounds what the card did."""
from gpubench.counts import least_time


def read(run):
    if run.ops_peak <= 0:
        return None
    t = sum(least_time(w.ops, w.bytes, run.ops_peak)
            for w in run.work.values() if w.ops)
    return 100.0 * t / run.trace.window_s if t > 0 else None
