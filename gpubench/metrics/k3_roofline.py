"""Kernel K3 (csrc/ksw2_extd2.cu, with the trace K3a), on the batcher's extd2 flushes. Work: each fill's band cells for its real qlen, tlen and w (counts.extd2_cells) x 20 operations; bytes: query, target, CIGAR, result.
Share of the roofline (max of operations over the int32 peak and bytes
over 3.35 TB/s) over the kernel's device time in the window, in %."""
from gpubench.counts import roofline_share


def read(run):
    return roofline_share(run, "k3", r"extd2_kernel")
