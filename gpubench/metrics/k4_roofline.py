"""Kernel K4 (csrc/ksw2_exts2.cu), on the batcher's splice flushes. Work: each fill's qlen x tlen cells (counts.exts2_cells) x 24 operations; bytes: query, target, CIGAR, result.
Share of the roofline (max of operations over the int32 peak and bytes
over 3.35 TB/s) over the kernel's device time in the window, in %."""
from gpubench.counts import roofline_share


def read(run):
    return roofline_share(run, "k4", r"exts2_kernel")
