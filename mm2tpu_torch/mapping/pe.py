"""Paired-end / multi-segment logic (reference: pe.c).

The port's copy of `mm2tpu/mapping/pe.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from .hit import Region, sync_regs

f32 = np.float32


def select_sub_multi(regs: List[Region], pri_ratio: float, pri1: float,
                     pri2: float, max_gap_ref: int, min_diff: int, best_n: int,
                     n_segs: int, qlens: Sequence[int]) -> List[Region]:
    """mm_select_sub_multi (pe.c:6-44)."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    max_dist = qlens[0] + qlens[1] + max_gap_ref if n_segs == 2 else 0
    out = []
    n_2nd = 0
    for i, r in enumerate(regs):
        to_keep = False
        if r.parent == i:
            to_keep = True
        elif r.score + min_diff >= regs[r.parent].score:
            to_keep = True
        else:
            p = regs[r.parent]
            if (p.rev == r.rev and p.rid == r.rid and
                    r.re - p.rs < max_dist and p.re - r.rs < max_dist):
                if f32(r.score) >= f32(p.score) * f32(pri1):
                    to_keep = True
            else:
                is_par_both = n_segs == 2 and p.qs < qlens[0] and p.qe > qlens[0]
                is_chi_both = n_segs == 2 and r.qs < qlens[0] and r.qe > qlens[0]
                if is_chi_both or is_chi_both == is_par_both:
                    if f32(r.score) >= f32(p.score) * f32(pri_ratio):
                        to_keep = True
                else:
                    if f32(r.score) >= f32(p.score) * f32(pri2):
                        to_keep = True
        if to_keep and r.parent != i:
            if n_2nd >= best_n:
                to_keep = False
            n_2nd += 1
        if to_keep:
            out.append(r)
    if len(out) != len(regs):
        sync_regs(out)
    return out


def set_pe_thru(qlens: Sequence[int], regs_per_seg: List[List[Region]]) -> None:
    """mm_set_pe_thru (pe.c:45-63)."""
    n_pri = [0, 0]
    pri = [-1, -1]
    for s in range(2):
        for i, r in enumerate(regs_per_seg[s]):
            if r.id == r.parent:
                n_pri[s] += 1
                pri[s] = i
    if n_pri[0] == 1 and n_pri[1] == 1:
        p = regs_per_seg[0][pri[0]]
        q = regs_per_seg[1][pri[1]]
        if (p.rid == q.rid and p.rev == q.rev and abs(p.rs - q.rs) < 3 and
                abs(p.re - q.re) < 3 and
                ((p.qs == 0 and qlens[1] - q.qe == 0) or
                 (q.qs == 0 and qlens[0] - p.qe == 0))):
            p.pe_thru = q.pe_thru = True


def pair(max_gap_ref: int, pe_bonus: int, sub_diff: int, match_sc: int,
         qlens: Sequence[int], regs_per_seg: List[List[Region]]) -> None:
    """mm_pair (pe.c:76-177): joint pair selection + PE mapQ update."""
    entries = []  # (key, s, rev, region)
    dp_thres = 0
    segs = 0
    for s in range(2):
        mx = 0
        for r in regs_per_seg[s]:
            key = (r.rid << 32) | (r.rs << 1) | (s ^ int(r.rev))
            entries.append([key, s, int(r.rev), r])
            mx = max(mx, r.p.dp_max if r.p else 0)
            segs |= 1 << s
        dp_thres += mx
    if segs != 3:
        return
    dp_thres = max(dp_thres - pe_bonus, 0)
    entries.sort(key=lambda e: e[0])

    best = -1
    max_idx = [-1, -1]
    last = [-1, -1]
    sc: List[int] = []
    for i, (key, s, rev, r) in enumerate(entries):
        if key & 1:
            if last[rev] < 0:
                continue
            q = entries[last[rev]][3]
            if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                continue
            for j in range(last[rev], -1, -1):
                if entries[j][2] != rev or entries[j][1] == s:
                    continue
                q = entries[j][3]
                if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                    break
                if r.p.dp_max + q.p.dp_max < dp_thres:
                    continue
                score = ((r.p.dp_max + q.p.dp_max) << 32) | ((r.hash + q.hash) & 0xFFFFFFFF)
                if score > best:
                    best = score
                    max_idx[entries[j][1]] = j
                    max_idx[s] = i
                sc.append(score)
        else:
            last[rev] = i
    sc.sort()

    if sc and best > 0:
        r = [entries[max_idx[0]][3], entries[max_idx[1]][3]]
        r[0].proper_frag = r[1].proper_frag = True
        for s in range(2):
            if r[s].id != r[s].parent:
                p = regs_per_seg[s][r[s].parent]
                for rr in regs_per_seg[s]:
                    if rr.parent == p.id:
                        rr.parent = r[s].id
                p.mapq = 0
            if not r[s].sam_pri:
                for rr in regs_per_seg[s]:
                    rr.sam_pri = False
                r[s].sam_pri = True
        mapq_pe = max(r[0].mapq, r[1].mapq)
        n_sub = sum(1 for v in sc if (v >> 32) + sub_diff >= best >> 32)
        if len(sc) > 1:
            mapq_pe_alt = int(f32(6.02) * f32((best >> 32) - (sc[-2] >> 32)) / f32(match_sc)
                              - f32(4.343) * f32(math.log(n_sub)))
            mapq_pe = min(mapq_pe, mapq_pe_alt)
        for s in range(2):
            if r[s].mapq < mapq_pe:
                r[s].mapq = int(f32(0.2) * f32(r[s].mapq) + f32(0.8) * f32(mapq_pe) + f32(0.499))
        if len(sc) == 1:
            for s in range(2):
                r[s].mapq = max(r[s].mapq, 2)
        elif best >> 32 > sc[-2] >> 32:
            for s in range(2):
                r[s].mapq = max(r[s].mapq, 1)

    set_pe_thru(qlens, regs_per_seg)
