"""The reference's chaining: the bounded-lookback DP whose contract the
chaining kernels (K1, K2) implement, and the backtrack.

Frozen copies of `mm2tpu_torch/ops/chain_ref.py`'s `unpack_anchors`,
`avg_qspan_scaled`, `chain_scores_window`, `_ilog2_arr` and the NumPy
path of `chain_backtrack` (chain.c:348-422), and of
`mm2tpu_torch/mapping/chain.py::chain_gaps` (map.c:305-314). For anchor
i the DP scores the predecessors j in [max(st_i, i - max_iter, i -
window), i), where st_i is the first anchor within max_dist_x of i on
the reference; no max_skip. float arithmetic is float32 where the C code
uses float, so scores match exactly.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

MAX_TRIPCOUNT = 1024
NEG_INF32 = np.int32(-0x40000000)
MM_SEED_SEG_SHIFT = 48
MM_SEED_SEG_MASK = 0xFF << MM_SEED_SEG_SHIFT


def chain_gaps(max_gap: int, max_gap_ref: int, max_frag_len: int,
               is_sr: bool, qlen_sum: int) -> Tuple[int, int]:
    """(max chaining gap on the query, on the reference)."""
    gap_qry = max(qlen_sum, max_gap) if is_sr else max_gap
    if max_gap_ref > 0:
        gap_ref = max_gap_ref
    elif max_frag_len > 0:
        gap_ref = max(max_frag_len - qlen_sum, max_gap)
    else:
        gap_ref = max_gap
    return gap_qry, gap_ref


def avg_qspan_scaled(a: np.ndarray) -> np.float32:
    """.01 * (float)sum_qspan / n as float32 (chain.c:48-49)."""
    sum_qspan = int(np.sum((a[:, 1] >> np.uint64(32)) & np.uint64(0xFF)))
    return np.float32((0.01 * float(np.float32(sum_qspan))) / len(a))


def unpack_anchors(a: np.ndarray):
    """(ax, qi, q_span, sid): x with its sign bit flipped, so that int64
    order is the C code's uint64 order."""
    x = a[:, 0]
    y = a[:, 1]
    ax = (x ^ np.uint64(1 << 63)).astype(np.int64)
    qi = (y & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    q_span = ((y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    sid = ((y & np.uint64(MM_SEED_SEG_MASK)) >>
           np.uint64(MM_SEED_SEG_SHIFT)).astype(np.int32)
    return ax, qi, q_span, sid


def _ilog2_arr(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64)
    r = np.zeros(v.shape, dtype=np.int64)
    t = v.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        big = t >= (np.uint64(1) << np.uint64(shift))
        r[big] += shift
        t[big] >>= np.uint64(shift)
    return r


def chain_scores_window(a: np.ndarray, max_dist_x: int, max_dist_y: int,
                        bw: int, max_iter: int, gap_scale: float,
                        is_cdna: bool, n_segs: int,
                        window: int = MAX_TRIPCOUNT, log_gap: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bounded-lookback DP: (f int32, p int64, v int32), p = -1 where
    an anchor starts its chain. `log_gap=False` drops the log2 term of
    the gap cost (the comparison's control; minimap2 always has it)."""
    n = len(a)
    ax, qi, q_span, sid = unpack_anchors(a)
    avg = np.float32(avg_qspan_scaled(a))
    f = np.zeros(n, dtype=np.int32)
    p = np.full(n, -1, dtype=np.int64)
    v = np.zeros(n, dtype=np.int32)
    multi_other = n_segs > 1 and not is_cdna
    st = 0
    for i in range(n):
        ri = ax[i]
        while st < i and ri > ax[st] + max_dist_x:
            st += 1
        st2 = st
        if i - st2 > max_iter:
            st2 = i - max_iter
        lo = max(st2, i - window)
        if lo >= i:
            f[i] = q_span[i]
            v[i] = f[i]
            continue
        j = np.arange(lo, i)
        dr = ri - ax[j]
        dq = np.int64(qi[i]) - qi[j]
        same = sid[j] == sid[i]
        ok = ~(((same) & (dr == 0)) | (dq <= 0))
        ok &= ~((same & (dq > max_dist_y)) | (dq > max_dist_x))
        dd = np.abs(dr - dq)
        ok &= ~(same & (dd > bw))
        if multi_other:
            ok &= ~(same & (dr > max_dist_y))
        min_d = np.minimum(dq, dr)
        sc = np.minimum(min_d, np.int64(q_span[i])).astype(np.int64)
        log_dd = np.where(dd > 0, _ilog2_arr(dd), 0) if log_gap else \
            np.zeros_like(dd)
        c_lin = (dd.astype(np.float32) * avg).astype(np.int64)
        lin_cost = c_lin + (log_dd >> 1)
        if is_cdna or n_segs > 1:
            in_branch = is_cdna | ~same
            pair_bonus = (~same) & (dr == 0)
            min_cost = np.minimum(c_lin, log_dd)
            branch_cost = np.where(pair_bonus, 0,
                                   np.where((dr > dq) | ~same, min_cost,
                                            lin_cost))
            gap_cost = np.where(in_branch, branch_cost, lin_cost)
            sc = np.where(in_branch & pair_bonus, sc + 1, sc)
        else:
            gap_cost = lin_cost
        sc = sc - (np.asarray(gap_cost, np.float64) * gap_scale
                   + 0.499).astype(np.int64)
        sc = sc + f[j]
        sc = np.where(ok, sc, np.int64(NEG_INF32))
        best = int(np.max(sc)) if len(sc) else NEG_INF32
        if best > q_span[i]:
            # C scans j descending with strict '>': ties pick the largest j
            jbest = lo + int(np.max(np.nonzero(sc == best)[0]))
            f[i] = best
            p[i] = jbest
        else:
            f[i] = q_span[i]
            p[i] = -1
        pj = p[i]
        v[i] = v[pj] if (pj >= 0 and v[pj] > f[i]) else f[i]
    return f, p, v


def chain_backtrack(n: int, f: np.ndarray, p: np.ndarray, v: np.ndarray,
                    a: np.ndarray, min_cnt: int, min_sc: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Chain ends, peak backtrack, compaction and position re-sort: (b,
    u), b the chains' anchors, u[i] = score << 32 | cnt a chain."""
    if n == 0:
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.uint64)
    t = np.zeros(n, dtype=np.int64)
    used = p[p >= 0]
    t[used] = 1
    ends = np.nonzero((t == 0) & (v >= min_sc))[0]
    if len(ends) == 0:
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.uint64)
    u = []
    for i in ends:
        j = int(i)
        while j >= 0 and f[j] < v[j]:
            j = int(p[j])
        if j < 0:
            j = int(i)
        u.append((int(f[j]) << 32) | j)
    u = np.sort(np.array(u, dtype=np.uint64))[::-1]
    t[:] = 0
    chains = []
    for ui in u:
        j = int(ui & np.uint64(0xFFFFFFFF))
        path = []
        while True:
            path.append(j)
            t[j] = 1
            j = int(p[j])
            if j < 0 or t[j] != 0:
                break
        if j < 0:
            if len(path) >= min_cnt:
                chains.append(((int(ui >> np.uint64(32))), path))
        elif int(ui >> np.uint64(32)) - int(f[j]) >= min_sc:
            if len(path) >= min_cnt:
                chains.append((int(ui >> np.uint64(32)) - int(f[j]), path))
    if not chains:
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.uint64)
    b_parts = []
    u_arr = np.empty(len(chains), dtype=np.uint64)
    for ci, (sc, path) in enumerate(chains):
        b_parts.append(a[np.array(path[::-1], dtype=np.int64)])
        u_arr[ci] = np.uint64((sc << 32) | len(path))
    firsts = np.array([part[0, 0] for part in b_parts], dtype=np.uint64)
    order = np.argsort(firsts, kind="stable")
    b = np.concatenate([b_parts[i] for i in order], axis=0)
    return b, u_arr[order]
