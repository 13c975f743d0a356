"""Host reference port of the ksw2 splice-aware extension kernel.

Semantics-exact NumPy port of ksw_exts2_sse (SSE4.1 build of
ksw2_exts2_sse.c) — the spliced-alignment DP used by the `splice`
presets. Differences from extd2 (see ops/ksw2_ref.py):

  - no band: the wavefront spans the full anti-diagonal
    (ksw2_exts2_sse.c:179-181 has no `w` clipping),
  - the second gap state is the *intron* state: opening costs q2 at a
    donor site (x2[t] = max(a2, donor[t]) - q2, :235), closing adds the
    acceptor score (a2a = a2 + acceptor[t], :55), and extension is free,
  - donor/acceptor site arrays encode canonical GT..AG (or CT..AC on the
    reverse strand) detection with -noncan penalties, GTr/yAG half-bit
    flank scoring under KSW_EZ_SPLICE_FLANK, and per-base annotated
    junction bonuses from --junc-bed (:119-171),
  - requires q2 > q + e (:73); x2 is initialised to -q2 (:104),
  - long_thres/long_diff use e only (:93-96) and the first-column u/v
    boundary decays to 0 past long_thres (:190,194),
  - Z-drop is applied with e=0 (:382),
  - backtrack maps state 3 to the N (intron) op via
    min_intron_len=long_thres (:410), and there is no
    EXTZ_ONLY/reach_end branch (:409-412).

All arithmetic is int32; the int8 SIMD value ranges are preserved by
mm_check_opt's constraints, so the port computes identical numbers.

A frozen copy of `mm2tpu_torch/ops/ksw2_splice_ref.py` (itself the port's
copy of `mm2tpu/ops/ksw2_splice_ref.py`), kept with the benchmark as its
plain reference.
"""
from __future__ import annotations

import numpy as np

from .ksw2_ref import (
    KSW_EZ_APPROX_DROP,
    KSW_EZ_APPROX_MAX,
    KSW_EZ_GENERIC_SC,
    KSW_EZ_REV_CIGAR,
    KSW_EZ_RIGHT,
    KSW_EZ_SCORE_ONLY,
    KSW_EZ_SPLICE_FLANK,
    KSW_EZ_SPLICE_FOR,
    KSW_EZ_SPLICE_REV,
    KSW_NEG_INF,
    ExtzResult,
    _apply_zdrop,
    _backtrack,
    _exact_max_scan,
)


def _site_arrays(tlen: int, tpad: int, target: np.ndarray, junc, noncan: int,
                 junc_bonus: int, flag: int) -> tuple:
    """Donor/acceptor score arrays (ksw2_exts2_sse.c:119-171)."""
    donor = np.zeros(tpad, np.int32)
    acceptor = np.zeros(tpad, np.int32)
    if not (flag & (KSW_EZ_SPLICE_FOR | KSW_EZ_SPLICE_REV)):
        return donor, acceptor
    # C's -noncan/2 truncates toward zero (e.g. -9/2 == -4), not floor
    semi_cost = -(noncan // 2) if flag & KSW_EZ_SPLICE_FLANK else 0
    donor[:] = -noncan
    acceptor[:] = -noncan
    t = np.asarray(target, np.int32)
    if not (flag & KSW_EZ_REV_CIGAR):
        for i in range(tlen - 4):
            can_type = 0
            if (flag & KSW_EZ_SPLICE_FOR) and t[i + 1] == 2 and t[i + 2] == 3:
                can_type = 1  # GTr...
            if (flag & KSW_EZ_SPLICE_REV) and t[i + 1] == 1 and t[i + 2] == 3:
                can_type = 1  # CTr...
            if can_type and (t[i + 3] == 0 or t[i + 3] == 2):
                can_type = 2
            if can_type:
                donor[i] = 0 if can_type == 2 else semi_cost
        if junc is not None:
            for i in range(tlen - 1):
                if (((flag & KSW_EZ_SPLICE_FOR) and (junc[i + 1] & 1)) or
                        ((flag & KSW_EZ_SPLICE_REV) and (junc[i + 1] & 8))):
                    donor[i] += junc_bonus
        for i in range(2, tlen):
            can_type = 0
            if (flag & KSW_EZ_SPLICE_FOR) and t[i - 1] == 0 and t[i] == 2:
                can_type = 1  # ...yAG
            if (flag & KSW_EZ_SPLICE_REV) and t[i - 1] == 0 and t[i] == 1:
                can_type = 1  # ...yAC
            if can_type and (t[i - 2] == 1 or t[i - 2] == 3):
                can_type = 2
            if can_type:
                acceptor[i] = 0 if can_type == 2 else semi_cost
        if junc is not None:
            for i in range(tlen):
                if (((flag & KSW_EZ_SPLICE_FOR) and (junc[i] & 2)) or
                        ((flag & KSW_EZ_SPLICE_REV) and (junc[i] & 4))):
                    acceptor[i] += junc_bonus
    else:  # sequences are reversed: mirror-image site motifs
        for i in range(tlen - 4):
            can_type = 0
            if (flag & KSW_EZ_SPLICE_FOR) and t[i + 1] == 2 and t[i + 2] == 0:
                can_type = 1  # GAy...
            if (flag & KSW_EZ_SPLICE_REV) and t[i + 1] == 1 and t[i + 2] == 0:
                can_type = 1  # CAy...
            if can_type and (t[i + 3] == 1 or t[i + 3] == 3):
                can_type = 2
            if can_type:
                donor[i] = 0 if can_type == 2 else semi_cost
        if junc is not None:
            for i in range(tlen - 1):
                if (((flag & KSW_EZ_SPLICE_FOR) and (junc[i + 1] & 2)) or
                        ((flag & KSW_EZ_SPLICE_REV) and (junc[i + 1] & 4))):
                    donor[i] += junc_bonus
        for i in range(2, tlen):
            can_type = 0
            if (flag & KSW_EZ_SPLICE_FOR) and t[i - 1] == 3 and t[i] == 2:
                can_type = 1  # ...rTG
            if (flag & KSW_EZ_SPLICE_REV) and t[i - 1] == 3 and t[i] == 1:
                can_type = 1  # ...rTC
            if can_type and (t[i - 2] == 0 or t[i - 2] == 2):
                can_type = 2
            if can_type:
                acceptor[i] = 0 if can_type == 2 else semi_cost
        if junc is not None:
            for i in range(tlen):
                if (((flag & KSW_EZ_SPLICE_FOR) and (junc[i] & 1)) or
                        ((flag & KSW_EZ_SPLICE_REV) and (junc[i] & 8))):
                    acceptor[i] += junc_bonus
    return donor, acceptor


def ksw_exts2(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
              mat: np.ndarray, q: int, e: int, q2: int, noncan: int,
              zdrop: int, junc_bonus: int, flag: int,
              junc=None) -> ExtzResult:
    """Port of ksw_exts2_sse (SSE4.1 semantics), m=5."""
    ez = ExtzResult()
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)
    if qlen <= 0 or tlen <= 0 or q2 <= q + e:
        return ez
    mat = np.asarray(mat, dtype=np.int32).reshape(-1)
    m = 5
    sc_mch, sc_mis = int(mat[0]), int(mat[1])
    sc_N = -e if mat[m * m - 1] == 0 else int(mat[m * m - 1])

    tlen_ = (tlen + 15) // 16
    qlen_ = (qlen + 15) // 16
    min_sc = int(mat[1:].min())
    if -min_sc > 2 * (q + e):
        return ez
    long_thres = (q2 - q) // e - 1
    if q2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * e - (q2 - q)

    tpad = tlen_ * 16
    u = np.full(tpad, -q - e, np.int32)
    v = np.full(tpad, -q - e, np.int32)
    x = np.full(tpad, -q - e, np.int32)
    y = np.full(tpad, -q - e, np.int32)
    x2 = np.full(tpad, -q2, np.int32)
    s = np.zeros(tpad + 16, np.int32)
    H = np.full(tpad, KSW_NEG_INF, np.int64) if not approx_max else None
    H0 = 0
    last_H0_t = 0
    p_rows = []
    off = np.zeros(qlen + tlen - 1, np.int64)
    off_end = np.zeros(qlen + tlen - 1, np.int64)

    donor, acceptor = _site_arrays(tlen, tpad, target, junc, noncan,
                                   junc_bonus, flag)

    qr = np.zeros(qlen_ * 16 + 16, np.int32)
    qr[:qlen] = query[::-1]
    # sf as read by the score loop: target, zero padding to tpad, then the
    # qr buffer (the SIMD loadu runs past sf into qr; deterministic)
    sf_read = np.concatenate([np.asarray(target, np.int32),
                              np.zeros(tpad - tlen, np.int32), qr])

    last_st = last_en = -1
    for r in range(qlen + tlen - 1):
        st, en = 0, tlen - 1
        if st < r - qlen + 1:
            st = r - qlen + 1
        if en > r:
            en = r
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, x21, v1 = int(x[st - 1]), int(x2[st - 1]), int(v[st - 1])
            else:
                x1, x21, v1 = -q - e, -q2, -q - e
        else:
            x1, x21 = -q - e, -q2
            v1 = (-q - e if r == 0 else
                  -e if r < long_thres else
                  long_diff if r == long_thres else 0)
        if en >= r:
            y[r] = -q - e
            u[r] = (-q - e if r == 0 else
                    -e if r < long_thres else
                    long_diff if r == long_thres else 0)
        qoff = qlen - 1 - r
        if not (flag & KSW_EZ_GENERIC_SC):
            for t0 in range(st0, en0 + 1, 16):
                sq = sf_read[t0: t0 + 16]
                stq = qr[qoff + t0: qoff + t0 + 16]
                mask = (sq == m - 1) | (stq == m - 1)
                val = np.where(sq == stq, sc_mch, sc_mis)
                s[t0: t0 + 16] = np.where(mask, sc_N, val)
        else:
            for t in range(st0, en0 + 1):
                s[t] = int(mat[int(sf_read[t]) * m + int(qr[qoff + t])])

        sl = slice(st, en + 1)
        xt1 = np.concatenate(([x1], x[st: en]))
        x2t1 = np.concatenate(([x21], x2[st: en]))
        vt1 = np.concatenate(([v1], v[st: en]))
        ut = u[sl].copy()
        z = s[sl].copy()
        a = xt1 + vt1
        b = y[sl] + ut
        a2 = x2t1 + vt1
        a2a = a2 + acceptor[sl]
        if with_cigar:
            if not (flag & KSW_EZ_RIGHT):
                d = np.where(a > z, 1, 0)
                z = np.maximum(z, a)
                d = np.where(b > z, 2, d)
                z = np.maximum(z, b)
                d = np.where(a2a > z, 3, d)
                z = np.maximum(z, a2a)
            else:
                d = np.where(z > a, 0, 1)
                z = np.maximum(z, a)
                d = np.where(z > b, d, 2)
                z = np.maximum(z, b)
                d = np.where(z > a2a, d, 3)
                z = np.maximum(z, a2a)
        else:
            z = np.maximum.reduce([z, a, b, a2a])
        u[sl] = z - vt1
        v[sl] = z - ut
        tmp = z - q
        a = a - tmp
        b = b - tmp
        a2 = a2 - (z - q2)
        dn = donor[sl]
        if with_cigar:
            if not (flag & KSW_EZ_RIGHT):
                ga, gb, ga2 = a > 0, b > 0, a2 > dn
            else:
                ga, gb, ga2 = a >= 0, b >= 0, a2 >= dn
            x[sl] = np.where(ga, a, 0) - (q + e)
            y[sl] = np.where(gb, b, 0) - (q + e)
            x2[sl] = np.maximum(a2, dn) - q2
            d = (d | np.where(ga, 0x08, 0) | np.where(gb, 0x10, 0)
                 | np.where(ga2, 0x20, 0))
            off[r], off_end[r] = st, en
            while len(p_rows) < r:
                p_rows.append(None)
            p_rows.append(d.astype(np.uint8))
        else:
            x[sl] = np.where(a > 0, a, 0) - (q + e)
            y[sl] = np.where(b > 0, b, 0) - (q + e)
            x2[sl] = np.maximum(a2, dn) - q2

        if not approx_max:
            if r > 0:
                max_H, max_t = _exact_max_scan(H, u, v, st0, en0, r, 0)
            else:
                H[0] = int(v[0]) - (q + e)
                max_H, max_t = int(H[0]), 0
            if en0 == tlen - 1 and H[en0] > ez.mte:
                ez.mte, ez.mte_q = int(H[en0]), r - en
            if r - st0 == qlen - 1 and H[st0] > ez.mqe:
                ez.mqe, ez.mqe_t = int(H[st0]), st0
            if _apply_zdrop(ez, max_H, r, max_t, zdrop, 0):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = int(H[tlen - 1])
        else:
            if r > 0:
                if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                    d0 = int(v[last_H0_t])
                    d1 = int(u[last_H0_t + 1])
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0 += d1
                        last_H0_t += 1
                elif st0 <= last_H0_t <= en0:
                    H0 += int(v[last_H0_t])
                else:
                    last_H0_t += 1
                    H0 += int(u[last_H0_t])
            else:
                H0 = int(v[0]) - (q + e)
                last_H0_t = 0
            if (flag & KSW_EZ_APPROX_DROP) and _apply_zdrop(
                    ez, H0, r, last_H0_t, zdrop, 0):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    if with_cigar:
        rev_cigar = bool(flag & KSW_EZ_REV_CIGAR)
        from .ksw2_ref import KSW_EZ_EXTZ_ONLY
        if not ez.zdropped and not (flag & KSW_EZ_EXTZ_ONLY):
            ez.cigar = _backtrack(p_rows, off, off_end, tlen - 1, qlen - 1,
                                  rev_cigar, min_intron_len=long_thres)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = _backtrack(p_rows, off, off_end, ez.max_t, ez.max_q,
                                  rev_cigar, min_intron_len=long_thres)
    return ez
