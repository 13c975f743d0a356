"""Kernel K2 (csrc/chain.cu, MULTISEG/CDNA/CDNA_MULTISEG), on the tasks of chain_fn. Work: as K1's (counts.py), the same recurrence with cDNA's gap cost.
Share of the roofline (max of operations over the int32 peak and bytes
over 3.35 TB/s) over the kernel's device time in the window, in %."""
from gpubench.counts import roofline_share


def read(run):
    return roofline_share(run, "k2", r"chain_kernel<[123]>")
