"""Host reference port of the ksw2 extension kernels.

Semantics-exact NumPy ports of the reference's SSE4.1 builds:
  - extd2: dual affine-gap anti-diagonal DP (ksw2_extd2_sse.c) — the main
    base-level kernel for map-ont/asm*/sr presets,
  - backtrack/zdrop helpers (ksw2.h:119-176).

The ports replicate the SIMD implementations' observable quirks because
minimap2's output depends on them: 16-lane-aligned band boundaries (cells
outside [st0,en0] are computed and persist), the score array reading the
reversed-query/zero padding beyond sequence ends, the 4-lane tie-breaking
of the exact-max scan, and the approximate-max tracker. All arithmetic is
int32; value ranges are bounded by mm_check_opt's (q+e)+(q2+e2) <= 127
constraint so the int8 SIMD and this port compute identical numbers.

A frozen copy of what extd2 and the splice DP use of
`mm2tpu_torch/ops/ksw2_ref.py` (itself the port's copy of
`mm2tpu/ops/ksw2_ref.py`), kept with the benchmark as its plain reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

KSW_NEG_INF = -0x40000000

KSW_EZ_SCORE_ONLY = 0x01
KSW_EZ_RIGHT = 0x02
KSW_EZ_GENERIC_SC = 0x04
KSW_EZ_APPROX_MAX = 0x08
KSW_EZ_APPROX_DROP = 0x10
KSW_EZ_EXTZ_ONLY = 0x40
KSW_EZ_REV_CIGAR = 0x80
KSW_EZ_SPLICE_FOR = 0x100
KSW_EZ_SPLICE_REV = 0x200
KSW_EZ_SPLICE_FLANK = 0x400


@dataclass
class ExtzResult:
    """ksw_extz_t (ksw2.h:23-32)."""
    max: int = 0
    zdropped: bool = False
    max_q: int = -1
    max_t: int = -1
    mqe: int = KSW_NEG_INF
    mqe_t: int = -1
    mte: int = KSW_NEG_INF
    mte_q: int = -1
    score: int = KSW_NEG_INF
    reach_end: bool = False
    cigar: List[int] = field(default_factory=list)

    @property
    def n_cigar(self) -> int:
        return len(self.cigar)


_MAT_MEMO: dict = {}


def gen_simple_mat(a: int, b: int, sc_ambi: int) -> np.ndarray:
    """ksw_gen_simple_mat (align.c:9-22); m=5. Memoized: align1 calls
    this per region, and the native bindings cache the FFI pointer by
    object identity — a stable array object makes that cache hit."""
    key = (a, b, sc_ambi)
    memo = _MAT_MEMO.get(key)
    if memo is not None:
        return memo
    a = abs(a)
    b = -abs(b)
    sc_ambi = -abs(sc_ambi)
    mat = np.full((5, 5), b, dtype=np.int32)
    np.fill_diagonal(mat, a)
    mat[4, :] = sc_ambi
    mat[:, 4] = sc_ambi
    mat[:4, 4] = sc_ambi
    out = mat.reshape(-1)
    out.setflags(write=False)
    if len(_MAT_MEMO) > 64:
        _MAT_MEMO.clear()
    _MAT_MEMO[key] = out
    return out


def _push_cigar(cigar: List[int], op: int, length: int) -> None:
    if not cigar or op != (cigar[-1] & 0xF):
        cigar.append(length << 4 | op)
    else:
        cigar[-1] += length << 4


def _backtrack(p_rows, off, off_end, i0: int, j0: int,
               rev_cigar: bool, min_intron_len: int = 0) -> List[int]:
    """ksw_backtrack for the rotated (anti-diagonal) matrices (ksw2.h:119)."""
    cigar: List[int] = []
    i, j, state = i0, j0, 0
    while i >= 0 and j >= 0:
        r = i + j
        force_state = -1
        if i < off[r]:
            force_state = 2
        if off_end is not None and i > off_end[r]:
            force_state = 1
        tmp = int(p_rows[r][i - off[r]]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2) & 1):
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            _push_cigar(cigar, 0, 1)
            i -= 1
            j -= 1
        elif state == 1 or (state == 3 and min_intron_len <= 0):
            _push_cigar(cigar, 2, 1)
            i -= 1
        elif state == 3 and min_intron_len > 0:
            _push_cigar(cigar, 3, 1)
            i -= 1
        else:
            _push_cigar(cigar, 1, 1)
            j -= 1
    if i >= 0:
        _push_cigar(cigar, 3 if (min_intron_len > 0 and i >= min_intron_len) else 2, i + 1)
    if j >= 0:
        _push_cigar(cigar, 1, j + 1)
    if not rev_cigar:
        cigar.reverse()
    return cigar


def _apply_zdrop(ez: ExtzResult, H: int, r: int, t: int, zdrop: int, e: int) -> bool:
    """ksw_apply_zdrop, rotated variant (ksw2.h:160-176)."""
    if H > ez.max:
        ez.max, ez.max_t, ez.max_q = H, t, r - t
    elif t >= ez.max_t and r - t >= ez.max_q:
        tl = t - ez.max_t
        ql = (r - t) - ez.max_q
        l = abs(tl - ql)
        if zdrop >= 0 and ez.max - H > zdrop + l * e:
            ez.zdropped = True
            return True
    return False


def _exact_max_scan(H, u8, v8, st0, en0, r, qe_sub: int):
    """The SIMD exact-max update (extd2 l.326-358 / extz2 l.235-269),
    including its 4-lane tie-breaking. Returns (max_H, max_t)."""
    if en0 > 0:
        H[en0] = H[en0 - 1] + int(u8[en0]) - qe_sub
    else:
        H[en0] = H[en0] + int(v8[en0]) - qe_sub
    max_H, max_t = int(H[en0]), en0
    en1 = st0 + (en0 - st0) // 4 * 4
    if en1 > st0:
        ts = np.arange(st0, en1)
        H[st0:en1] += v8[st0:en1].astype(np.int64) - qe_sub
        blocks = H[st0:en1].reshape(-1, 4)
        tpos = ts.reshape(-1, 4)
        # per-lane running max with strict '>' (first occurrence wins),
        # seeded with (max_H, max_t)
        lane_best = np.full(4, max_H, dtype=np.int64)
        lane_t = np.full(4, max_t, dtype=np.int64)
        for lane in range(4):
            col = blocks[:, lane]
            k = int(np.argmax(col))
            if col[k] > lane_best[lane]:
                lane_best[lane] = col[k]
                lane_t[lane] = tpos[k, lane]
        for lane in range(4):
            if max_H < lane_best[lane]:
                max_H, max_t = int(lane_best[lane]), int(lane_t[lane])
    for t in range(en1, en0):
        H[t] += int(v8[t]) - qe_sub
        if H[t] > max_H:
            max_H, max_t = int(H[t]), t
    return max_H, max_t


def ksw_extd2(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
              mat: np.ndarray, q: int, e: int, q2: int, e2: int, w: int,
              zdrop: int, end_bonus: int, flag: int) -> ExtzResult:
    """Port of ksw_extd2_sse (SSE4.1 semantics), m=5."""
    ez = ExtzResult()
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)
    if qlen <= 0 or tlen <= 0:
        return ez
    if q2 + e2 < q + e:
        q, q2 = q2, q
        e, e2 = e2, e
    mat = np.asarray(mat, dtype=np.int32).reshape(-1)
    m = 5
    sc_mch, sc_mis = int(mat[0]), int(mat[1])
    sc_N = -e2 if mat[m * m - 1] == 0 else int(mat[m * m - 1])

    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen_ = (tlen + 15) // 16
    n_col_ = min(qlen, tlen)
    n_col_ = (min(n_col_, w + 1) + 15) // 16 + 1
    qlen_ = (qlen + 15) // 16
    max_sc = int(mat.max())
    min_sc = int(mat[1:].min())
    if -min_sc > 2 * (q + e):
        return ez
    long_thres = (q2 - q) // (e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2

    tpad = tlen_ * 16
    # diff arrays (persist across rows); int32 but values fit int8
    u = np.full(tpad, -q - e, np.int32)
    v = np.full(tpad, -q - e, np.int32)
    x = np.full(tpad, -q - e, np.int32)
    y = np.full(tpad, -q - e, np.int32)
    x2 = np.full(tpad, -q2 - e2, np.int32)
    y2 = np.full(tpad, -q2 - e2, np.int32)
    s = np.zeros(tpad + 16, np.int32)  # score array (stale cells persist)
    H = np.full(tpad, KSW_NEG_INF, np.int64) if not approx_max else None
    H0 = 0
    last_H0_t = 0
    p_rows: List[Optional[np.ndarray]] = []
    off = np.zeros(qlen + tlen - 1, np.int64)
    off_end = np.zeros(qlen + tlen - 1, np.int64)

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
        if st < (r - wr + 1) >> 1:
            st = (r - wr + 1) >> 1
        if en > (r + wl) >> 1:
            en = (r + wl) >> 1
        if st > en:
            ez.zdropped = True
            break
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1
        # boundary conditions
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, x21, v1 = int(x[st - 1]), int(x2[st - 1]), int(v[st - 1])
            else:
                x1, x21, v1 = -q - e, -q2 - e2, -q - e
        else:
            x1, x21 = -q - e, -q2 - e2
            v1 = (-q - e if r == 0 else
                  -e if r < long_thres else
                  long_diff if r == long_thres else -e2)
        if en >= r:
            y[r] = -q - e
            y2[r] = -q2 - e2
            u[r] = (-q - e if r == 0 else
                    -e if r < long_thres else
                    long_diff if r == long_thres else -e2)
        # score row: 16-wide blocks from st0 (unaligned stores, like SIMD)
        qoff = qlen - 1 - r
        if not (flag & KSW_EZ_GENERIC_SC):
            for t0 in range(st0, en0 + 1, 16):
                sq = sf_read[t0: t0 + 16]
                stq = qr[qoff + t0: qoff + t0 + 16] if qoff + t0 >= 0 else \
                    np.concatenate([np.zeros(-(qoff + t0), np.int32),
                                    qr[:qoff + t0 + 16]])
                mask = (sq == m - 1) | (stq == m - 1)
                val = np.where(sq == stq, sc_mch, sc_mis)
                s[t0: t0 + 16] = np.where(mask, sc_N, val)
        else:
            for t in range(st0, en0 + 1):
                s[t] = int(mat[int(sf_read[t]) * m + int(qr[qoff + t])])

        # core row, vectorized over [st, en]
        sl = slice(st, en + 1)
        xt1 = np.concatenate(([x1], x[st: en]))
        x2t1 = np.concatenate(([x21], x2[st: en]))
        vt1 = np.concatenate(([v1], v[st: en]))
        ut = u[sl].copy()
        z = s[sl].copy()
        a = xt1 + vt1
        b = y[sl] + ut
        a2 = x2t1 + vt1
        b2 = y2[sl] + ut
        if with_cigar:
            if not (flag & KSW_EZ_RIGHT):
                d = np.where(a > z, 1, 0)
                z = np.maximum(z, a)
                d = np.where(b > z, 2, d)
                z = np.maximum(z, b)
                d = np.where(a2 > z, 3, d)
                z = np.maximum(z, a2)
                d = np.where(b2 > z, 4, d)
                z = np.maximum(z, b2)
            else:
                d = np.where(z > a, 0, 1)
                z = np.maximum(z, a)
                d = np.where(z > b, d, 2)
                z = np.maximum(z, b)
                d = np.where(z > a2, d, 3)
                z = np.maximum(z, a2)
                d = np.where(z > b2, d, 4)
                z = np.maximum(z, b2)
        else:
            z = np.maximum.reduce([z, a, b, a2, b2])
        z = np.minimum(z, sc_mch)
        u[sl] = z - vt1
        v[sl] = z - ut
        tmp = z - q
        a = a - tmp
        b = b - tmp
        tmp = z - q2
        a2 = a2 - tmp
        b2 = b2 - tmp
        if with_cigar:
            if not (flag & KSW_EZ_RIGHT):
                ga, gb, ga2, gb2 = a > 0, b > 0, a2 > 0, b2 > 0
            else:
                ga, gb, ga2, gb2 = a >= 0, b >= 0, a2 >= 0, b2 >= 0
            x[sl] = np.where(ga, a, 0) - (q + e)
            y[sl] = np.where(gb, b, 0) - (q + e)
            x2[sl] = np.where(ga2, a2, 0) - (q2 + e2)
            y2[sl] = np.where(gb2, b2, 0) - (q2 + e2)
            d = (d | np.where(ga, 0x08, 0) | np.where(gb, 0x10, 0)
                 | np.where(ga2, 0x20, 0) | np.where(gb2, 0x40, 0))
            off[r], off_end[r] = st, en
            while len(p_rows) < r:
                p_rows.append(None)
            p_rows.append(d.astype(np.uint8))
        else:
            x[sl] = np.where(a > 0, a, 0) - (q + e)
            y[sl] = np.where(b > 0, b, 0) - (q + e)
            x2[sl] = np.where(a2 > 0, a2, 0) - (q2 + e2)
            y2[sl] = np.where(b2 > 0, b2, 0) - (q2 + e2)

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
            if _apply_zdrop(ez, max_H, r, max_t, zdrop, e2):
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
            if (flag & KSW_EZ_APPROX_DROP) and _apply_zdrop(ez, H0, r, last_H0_t, zdrop, e2):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    if with_cigar:
        rev_cigar = bool(flag & KSW_EZ_REV_CIGAR)
        if not ez.zdropped and not (flag & KSW_EZ_EXTZ_ONLY):
            ez.cigar = _backtrack(p_rows, off, off_end, tlen - 1, qlen - 1, rev_cigar)
        elif not ez.zdropped and (flag & KSW_EZ_EXTZ_ONLY) and ez.mqe + end_bonus > ez.max:
            ez.reach_end = True
            ez.cigar = _backtrack(p_rows, off, off_end, ez.mqe_t, qlen - 1, rev_cigar)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = _backtrack(p_rows, off, off_end, ez.max_t, ez.max_q, rev_cigar)
    return ez
