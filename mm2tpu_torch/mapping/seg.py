"""Multi-segment chain splitting (reference: mm_seg_gen, hit.c:373-427).

The port's copy of `mm2tpu/mapping/seg.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from ..options import MM_SEED_SEG_MASK, MM_SEED_SEG_SHIFT
from . import hit as hit_mod
from .hit import Region


@dataclass
class Seg:
    u: np.ndarray
    a: np.ndarray
    regs: List[Region] = field(default_factory=list)


def seg_gen(hash_: int, qlens: Sequence[int], regs0: List[Region],
            a: np.ndarray) -> List[Seg]:
    n_segs = len(qlens)
    acc = [0]
    for s in range(1, n_segs):
        acc.append(acc[s - 1] + qlens[s - 1])
    qlen_sum = acc[-1] + qlens[-1]

    n_regs0 = len(regs0)
    # per-region segment id of each anchor + per-segment counts (vectorized)
    reg_sids = []
    counts = np.zeros((n_segs, n_regs0), np.int64)
    for i, r in enumerate(regs0):
        sids = ((a[r.as_: r.as_ + r.cnt, 1] & np.uint64(MM_SEED_SEG_MASK))
                >> np.uint64(MM_SEED_SEG_SHIFT)).astype(np.int64)
        reg_sids.append(sids)
        counts[:, i] = np.bincount(sids, minlength=n_segs)
    segs = []
    for s in range(n_segs):
        idx_chunks, su_vals = [], []
        for i, r in enumerate(regs0):
            c = int(counts[s, i])
            if c:
                su_vals.append((r.score << 32) + c)
                idx_chunks.append(r.as_ + np.nonzero(reg_sids[i] == s)[0])
        if idx_chunks:
            idx = np.concatenate(idx_chunks)
            sa = a[idx]  # fancy indexing copies
            rev = (sa[:, 0] >> np.uint64(63)).astype(bool)
            shift = np.where(rev, qlen_sum - (qlens[s] + acc[s]),
                             acc[s]).astype(np.uint64)
            sa[:, 1] = sa[:, 1] - shift  # uint64 wraparound, as in the C
        else:
            sa = np.zeros((0, 2), np.uint64)
        su = np.array(su_vals, dtype=np.uint64)
        seg = Seg(u=su, a=sa)
        seg.regs = hit_mod.gen_regs(hash_, qlens[s], su, sa)
        for r in seg.regs:
            r.seg_split = True
            r.seg_id = s
        segs.append(seg)
    return segs
