"""SDUST low-complexity masking (reference: sdust.c; the symmetric DUST
algorithm of Morgulis et al.). `sdust_core` produces the masked-interval
list over one sequence; `dust_minimizers` drops minimizers that overlap
a masked region by more than half their span (mm_dust_minier,
map.c:38-62). Off by default in every preset (-T enables it).

The window state: a deque of 3-mer words (capacity W-2), running suffix
length L, word counts over the whole window (cw/rw) and over the suffix
(cv/rv), and the list P of "perfect" (maximal-score) intervals sorted by
descending start then ascending finish.

The port's copy of `mm2tpu/mapping/sdust.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

from ..index.sketch import encode_nt4

WLEN = 3
WTOT = 1 << (WLEN << 1)
WMSK = WTOT - 1


def sdust_core(codes: np.ndarray, T: int, W: int) -> List[Tuple[int, int]]:
    """Masked intervals [(start, finish), ...] over nt4 codes
    (sdust_core, sdust.c:139-169)."""
    res: List[Tuple[int, int]] = []
    P: List[list] = []  # [start, finish, r, l]
    w: deque = deque()
    cv = [0] * WTOT
    cw = [0] * WTOT
    state = [0, 0, 0]  # rv, rw, L

    def save_masked(start: int) -> None:
        # sdust.c:91-104
        if not P or P[-1][0] >= start:
            return
        p = P[-1]
        saved = False
        if res:
            s, f = res[-1]
            if p[0] <= f:  # overlapping or adjacent: merge
                saved = True
                res[-1] = (s, f if f > p[1] else p[1])
        if not saved:
            res.append((p[0], p[1]))
        i = len(P) - 1
        while i >= 0 and P[i][0] < start:
            i -= 1
        del P[i + 1:]

    def shift_window(t: int) -> None:
        # sdust.c:66-86
        rv, rw, L = state
        if len(w) >= W - WLEN + 1:
            s = w.popleft()
            cw[s] -= 1
            rw -= cw[s]
            if L > len(w):
                L -= 1
                cv[s] -= 1
                rv -= cv[s]
        w.append(t)
        L += 1
        rw += cw[t]
        cw[t] += 1
        rv += cv[t]
        cv[t] += 1
        if cv[t] * 10 > T << 1:
            while True:
                s = w[len(w) - L]
                cv[s] -= 1
                rv -= cv[s]
                L -= 1
                if s == t:
                    break
        state[0], state[1], state[2] = rv, rw, L

    def find_perfect(start: int) -> None:
        # sdust.c:106-131; max_r/max_l persist across the i loop
        rv, _, L = state
        c = cv.copy()
        r = rv
        max_r = max_l = 0
        for i in range(len(w) - L - 1, -1, -1):
            t = w[i]
            r += c[t]
            c[t] += 1
            new_r, new_l = r, len(w) - i - 1
            if new_r * 10 > T * new_l:
                j = 0
                while j < len(P) and P[j][0] >= i + start:
                    p = P[j]
                    if max_r == 0 or p[2] * max_l > max_r * p[3]:
                        max_r, max_l = p[2], p[3]
                    j += 1
                if max_r == 0 or new_r * max_l >= max_r * new_l:
                    max_r, max_l = new_r, new_l
                    P.insert(j, [i + start, len(w) + WLEN - 1 + start,
                                 new_r, new_l])

    n = len(codes)
    l = t = 0
    for i in range(n + 1):
        b = int(codes[i]) if i < n else 4
        if b < 4:
            l += 1
            t = ((t << 2) | b) & WMSK
            if l >= WLEN:
                start = (l - W if l - W > 0 else 0) + (i + 1 - l)
                save_masked(start)
                shift_window(t)
                if state[1] * 10 > state[2] * T:
                    find_perfect(start)
        else:  # N or end: breaks the sequence into independent pieces
            start = (l - W + 1 if l - W + 1 > 0 else 0) + (i + 1 - l)
            while P:
                save_masked(start)
                start += 1
            l = t = 0
    return res


def dust_minimizers(mm: np.ndarray, seq, thres: int) -> np.ndarray:
    """Drop minimizers overlapping masked regions by more than half their
    span (mm_dust_minier, map.c:38-62). `mm` carries the cumulative
    query-offset in y — the reference compares those offset positions
    against per-segment dust intervals for sid>0 too (map.c:71-74), a
    quirk reproduced here deliberately: do NOT subtract the offset."""
    codes = encode_nt4(seq)
    try:
        from ..native import lib as native_lib
        has_native = native_lib.has_sdust()
    except Exception:
        has_native = False
    dreg = (native_lib.sdust(codes, thres, 64) if has_native
            else sdust_core(codes, thres, 64))
    if not dreg:
        return mm
    nd = len(dreg)
    keep = np.ones(len(mm), bool)
    u = 0
    for j in range(len(mm)):
        qpos = (int(mm[j, 1]) & 0xFFFFFFFF) >> 1
        span = int(mm[j, 0]) & 0xFF
        s = qpos - (span - 1)
        e = s + span
        while u < nd and dreg[u][1] <= s:
            u += 1
        if u < nd and dreg[u][0] < e:
            ll = 0
            v = u
            while v < nd and dreg[v][0] < e:
                ss = s if s > dreg[v][0] else dreg[v][0]
                ee = e if e < dreg[v][1] else dreg[v][1]
                ll += ee - ss
                v += 1
            keep[j] = ll <= span >> 1
    return mm[keep]
