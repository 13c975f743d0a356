"""Kernel K1 (csrc/chain.cu, UNISEG: single-segment, non-cDNA tasks), on the tasks of chain_fn and seed_fn. Work: the predecessors its DP scores for each real anchor (counts.py) x 28 operations, and 24 B an anchor.
Share of the roofline (max of operations over the int32 peak and bytes
over 3.35 TB/s) over the kernel's device time in the window, in %."""
from gpubench.counts import roofline_share


def read(run):
    return roofline_share(run, "k1", r"chain_kernel<0>")
