"""Host reference implementations of the anchor-chaining DP.

Two variants, mirroring the reference fork's two execution paths:

- chain_scores_exact: the software DP with max_skip/max_iter heuristics
  (chain.c:184-238, ENABLE_MAX_SKIP_ON_SW semantics) — bit-exact parity
  with the reference binary.
- chain_scores_window: bounded-lookback DP, no max_skip, window capped at
  MAX_TRIPCOUNT=1024 predecessors (chain.c:195 VERIFY semantics; identical
  to the FPGA kernel's contract, device/minimap2_opencl.cl:5-6). This is
  the semantics the Pallas TPU kernel implements; used as its oracle.

All float arithmetic is float32 where the C code uses float
(avg_qspan_scaled products), so scores match exactly.

The port's copy of `mm2tpu/ops/chain_ref.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..options import MM_SEED_SEG_MASK, MM_SEED_SEG_SHIFT
from ..utils import profiling

MAX_TRIPCOUNT = 1024
TRIPCOUNT_PER_SUBPART = 128

NEG_INF32 = np.int32(-0x40000000)


def _ilog2(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else 0


def avg_qspan_scaled(a: np.ndarray) -> np.float32:
    """.01 * (float)sum_qspan / n as float32 (chain.c:48-49)."""
    sum_qspan = int(np.sum((a[:, 1] >> np.uint64(32)) & np.uint64(0xFF)))
    return np.float32((0.01 * float(np.float32(sum_qspan))) / len(a))


def unpack_anchors(a: np.ndarray):
    """Split packed (n,2) uint64 anchors into DP-relevant int arrays.

    x is compared as uint64 in the C code (chain.c:121); flipping the sign
    bit maps it to int64 preserving both order and differences, so the
    strand bit (1<<63) doesn't break window arithmetic.
    """
    x = a[:, 0]
    y = a[:, 1]
    ax = (x ^ np.uint64(1 << 63)).astype(np.int64)
    qi = (y & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    q_span = ((y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    sid = ((y & np.uint64(MM_SEED_SEG_MASK)) >> np.uint64(MM_SEED_SEG_SHIFT)).astype(np.int32)
    return ax, qi, q_span, sid


def chain_scores_exact(a: np.ndarray, max_dist_x: int, max_dist_y: int,
                       bw: int, max_skip: int, max_iter: int,
                       gap_scale: float, is_cdna: bool, n_segs: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact SW DP (chain.c:184-238). Returns (f, p, v) int32/int64."""
    n = len(a)
    ax, qi, q_span, sid = unpack_anchors(a)
    avg = float(avg_qspan_scaled(a))
    f = np.zeros(n, dtype=np.int32)
    p = np.full(n, -1, dtype=np.int64)
    v = np.zeros(n, dtype=np.int32)
    t = np.zeros(n, dtype=np.int64)
    axl = ax.tolist()
    qil = qi.tolist()
    spanl = q_span.tolist()
    sidl = sid.tolist()
    fl = f.tolist()
    pl = p.tolist()
    tl = t.tolist()
    multi_other = n_segs > 1 and not is_cdna
    f32 = np.float32
    st = 0
    for i in range(n):
        ri = axl[i]
        qii = qil[i]
        spani = spanl[i]
        sidi = sidl[i]
        max_f = spani
        max_j = -1
        n_skip = 0
        while st < i and ri > axl[st] + max_dist_x:
            st += 1
        if i - st > max_iter:
            st = i - max_iter
        j = i - 1
        while j >= st:
            dr = ri - axl[j]
            dq = qii - qil[j]
            sidj = sidl[j]
            same = sidi == sidj
            ok = True
            if (same and dr == 0) or dq <= 0:
                ok = False
            elif (same and dq > max_dist_y) or dq > max_dist_x:
                ok = False
            else:
                dd = dr - dq if dr > dq else dq - dr
                if same and dd > bw:
                    ok = False
                elif multi_other and same and dr > max_dist_y:
                    ok = False
            if ok:
                min_d = dq if dq < dr else dr
                sc = spani if min_d > spani else min_d
                log_dd = _ilog2(dd) if dd else 0
                if is_cdna or not same:
                    c_lin = int(f32(dd) * f32(avg))
                    c_log = log_dd
                    if not same and dr == 0:
                        sc += 1
                        gap_cost = 0
                    elif dr > dq or not same:
                        gap_cost = c_lin if c_lin < c_log else c_log
                    else:
                        gap_cost = c_lin + (c_log >> 1)
                else:
                    gap_cost = int(f32(dd) * f32(avg)) + (log_dd >> 1)
                sc -= int(float(gap_cost) * gap_scale + 0.499)
                sc += fl[j]
                if sc > max_f:
                    max_f = sc
                    max_j = j
                    if n_skip > 0:
                        n_skip -= 1
                elif tl[j] == i:
                    n_skip += 1
                    if n_skip > max_skip:
                        break
                if pl[j] >= 0:
                    tl[pl[j]] = i
            j -= 1
        fl[i] = max_f
        pl[i] = max_j
        v[i] = v[max_j] if (max_j >= 0 and v[max_j] > max_f) else max_f
    return (np.array(fl, dtype=np.int32), np.array(pl, dtype=np.int64), v)


def chain_scores_window(a: np.ndarray, max_dist_x: int, max_dist_y: int,
                        bw: int, max_iter: int, gap_scale: float,
                        is_cdna: bool, n_segs: int,
                        window: int = MAX_TRIPCOUNT
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bounded-lookback DP (VERIFY semantics, chain.c:195): for anchor i,
    predecessors j in [max(st, i-window), i), no max_skip. Vectorized per i."""
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
        log_dd = np.where(dd > 0, _ilog2_arr(dd), 0)
        c_lin = (dd.astype(np.float32) * avg).astype(np.int64)
        lin_cost = c_lin + (log_dd >> 1)
        if is_cdna or n_segs > 1:
            # per-element branch of chain.c:136-143
            in_branch = is_cdna | ~same
            pair_bonus = (~same) & (dr == 0)
            min_cost = np.minimum(c_lin, log_dd)
            branch_cost = np.where(pair_bonus, 0,
                                   np.where((dr > dq) | ~same, min_cost, lin_cost))
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


def _ilog2_arr(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64)
    r = np.zeros(v.shape, dtype=np.int64)
    t = v.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        big = t >= (np.uint64(1) << np.uint64(shift))
        r[big] += shift
        t[big] >>= np.uint64(shift)
    return r


def num_subparts(a: np.ndarray, max_dist_x: int) -> Tuple[np.ndarray, int, int]:
    """Per-anchor quantized trip counts (chain.c:62-78): window length capped
    at MAX_TRIPCOUNT, quantized into subparts of 128. Returns
    (subparts uint8, total_subparts, total_trip_count)."""
    n = len(a)
    ax = (a[:, 0] ^ np.uint64(1 << 63)).astype(np.int64)  # unsigned order
    # window start for anchor i = first st with ax[st] >= ax[i] - max_dist_x
    # (the reference's incremental st advance, vectorized; a[] is x-sorted)
    with np.errstate(over="ignore"):
        target = ax - np.int64(max_dist_x)
    target[target > ax] = np.iinfo(np.int64).min  # clamp int64 underflow
    st = np.searchsorted(ax, target, side="left")
    tc = np.minimum(np.arange(n, dtype=np.int64) - st, MAX_TRIPCOUNT)
    s = tc // TRIPCOUNT_PER_SUBPART
    s += (tc == 0) | (tc % TRIPCOUNT_PER_SUBPART > 0)
    return s.astype(np.uint8), int(s.sum()), int(tc.sum())


def chain_backtrack(n: int, f: np.ndarray, p: np.ndarray, v: np.ndarray,
                    a: np.ndarray, min_cnt: int, min_sc: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Chain-end detection, peak backtrack, compaction and position re-sort
    (chain.c:348-422). Returns (b, u): b = compacted anchors, u[i] =
    score<<32 | cnt per chain, ordered by chain start position. The
    native call's time is `post.native`; each run of the NumPy path in
    its place counts as `fallback.backtrack`."""
    if n == 0:
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.uint64)
    try:
        from ..native import lib as native_lib
        if native_lib.has_backtrack():
            return profiling.timed("post.native", native_lib.chain_backtrack,
                                   n, f, p, v, a, min_cnt, min_sc)
    except ImportError:
        pass
    profiling.count("fallback.backtrack")
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

    # backtrack from the highest-scoring ends, marking used anchors
    t[:] = 0
    n_v = 0
    chains = []  # (net_score, [anchor idx reversed])
    vlist = []
    for ui in u:
        start_nv = n_v
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
                vlist.extend(path)
                n_v += len(path)
        elif int(ui >> np.uint64(32)) - int(f[j]) >= min_sc:
            if len(path) >= min_cnt:
                chains.append((int(ui >> np.uint64(32)) - int(f[j]), path))
                vlist.extend(path)
                n_v += len(path)
    if not chains:
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.uint64)

    # write chains' anchors in ascending order (chain.c:396-402)
    b_parts = []
    u_arr = np.empty(len(chains), dtype=np.uint64)
    for ci, (sc, path) in enumerate(chains):
        b_parts.append(a[np.array(path[::-1], dtype=np.int64)])
        u_arr[ci] = np.uint64((sc << 32) | len(path))
    # re-sort chains by first-anchor x (chain.c:405-419), stable
    firsts = np.array([part[0, 0] for part in b_parts], dtype=np.uint64)
    order = np.argsort(firsts, kind="stable")
    b = np.concatenate([b_parts[i] for i in order], axis=0)
    return b, u_arr[order]
