"""Chaining gaps of a fragment (map.c:305-314).

The port's copy of `chain_gaps` from `mm2tpu/mapping/chain.py`. The
rest of that module (`ChainRouter`, `chain_dp` and its cost model) is
the per-task routing of the stream mode, which the port does not run
(ROADMAP M3): the port chains every task in batch mode on the device.
"""
from __future__ import annotations

from typing import Tuple

from ..options import MapOptions


def chain_gaps(opt: MapOptions, qlen_sum: int) -> Tuple[int, int]:
    """max chaining gap on query/ref (map.c:305-314)."""
    is_sr = bool(opt.flag & 0x1000)
    if is_sr:
        max_chain_gap_qry = max(qlen_sum, opt.max_gap)
    else:
        max_chain_gap_qry = opt.max_gap
    if opt.max_gap_ref > 0:
        max_chain_gap_ref = opt.max_gap_ref
    elif opt.max_frag_len > 0:
        max_chain_gap_ref = max(opt.max_frag_len - qlen_sum, opt.max_gap)
    else:
        max_chain_gap_ref = opt.max_gap
    return max_chain_gap_qry, max_chain_gap_ref
