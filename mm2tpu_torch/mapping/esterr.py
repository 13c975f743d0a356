"""Sequence-divergence estimate from minimizer match fraction
(reference: esterr.c).

The port's copy of `mm2tpu/mapping/esterr.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils import profiling
from .hit import Region, _i32, _i32v

f32 = np.float32


def _get_for_qpos(qlen: int, a_row) -> int:
    """esterr.c:7-14."""
    x = _i32(a_row[1])
    q_span = (int(a_row[1]) >> 32) & 0xFF
    if int(a_row[0]) >> 63:
        x = qlen - 1 - (x + 1 - q_span)
    return x


def _qpos_vec(qlen: int, seg: np.ndarray) -> np.ndarray:
    """_get_for_qpos over a chain's anchor rows (vectorized)."""
    x = _i32v(seg[:, 1])
    span = ((seg[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    rev = (seg[:, 0] >> np.uint64(63)).astype(bool)
    return np.where(rev, qlen - 1 - (x + 1 - span), x)


def _match_loop(qlen, a, r, mp_low, st):
    """The reference's sequential two-pointer match (esterr.c:43-52) —
    fallback for non-monotone inputs."""
    n = len(mp_low)
    en, n_match, k, j = st, 1, 1, st + 1
    while j < n and k < r.cnt:
        xx = _get_for_qpos(
            qlen, a[r.as_ + r.cnt - 1 - k] if r.rev else a[r.as_ + k])
        if xx == int(mp_low[j]):
            k += 1
            en = j
            n_match += 1
        j += 1
    return en, n_match


_NATIVE = None


def _native():
    global _NATIVE
    if _NATIVE is None:
        try:
            from ..native import lib as native_lib
            _NATIVE = (native_lib if native_lib.available() and
                       native_lib.has_est_err() else False)
        except Exception:
            _NATIVE = False
    return _NATIVE


def est_err(mi, qlen: int, regs: List[Region], a: np.ndarray,
            mini_pos: np.ndarray) -> None:
    """mm_est_err (esterr.c:30-64): sets Region.div. The native call's
    time is `post.native`; each run of `est_err_py` in its place counts
    as `fallback.est_err`."""
    n = len(mini_pos)
    if n == 0:
        return
    nat = _native()
    if nat and regs:
        nr = len(regs)
        div = profiling.timed(
            "post.native", nat.est_err_div,
            qlen,
            np.fromiter((r.as_ for r in regs), np.int64, nr),
            np.fromiter((r.cnt for r in regs), np.int32, nr),
            np.fromiter((r.rev for r in regs), np.uint8, nr),
            np.fromiter((r.qs for r in regs), np.int32, nr),
            np.fromiter((r.rs for r in regs), np.int32, nr),
            np.fromiter((r.re for r in regs), np.int32, nr),
            np.fromiter((mi.seq[r.rid].length for r in regs), np.int32, nr),
            a, mini_pos)
        for r, d in zip(regs, div.tolist()):
            r.div = d
        return
    if not nat:
        profiling.count("fallback.est_err")
    est_err_py(mi, qlen, regs, a, mini_pos)


def est_err_py(mi, qlen: int, regs: List[Region], a: np.ndarray,
               mini_pos: np.ndarray) -> None:
    """NumPy reference implementation (the native path's oracle)."""
    n = len(mini_pos)
    if n == 0:
        return
    sum_k = int(np.sum((mini_pos >> np.uint64(32)) & np.uint64(0xFF)))
    avg_k = float(f32(sum_k) / f32(n))
    mp_low = (mini_pos & np.uint64(0xFFFFFFFF)).astype(np.int64)
    # the vectorized matcher assumes strictly increasing positions on both
    # sides (true for real chains); otherwise use the reference loop
    mp_strict = bool(np.all(np.diff(mp_low) > 0))

    for r in regs:
        r.div = -1.0
        if r.cnt == 0:
            continue
        seg = a[r.as_:r.as_ + r.cnt]
        xs = _qpos_vec(qlen, seg)
        if r.rev:
            xs = xs[::-1]
        st = int(np.searchsorted(mp_low, xs[0]))
        if st >= n or mp_low[st] != xs[0]:
            continue  # logic inconsistency warning in the reference
        l_ref = mi.seq[r.rid].length
        if r.cnt == 1:
            en, n_match = st, 1
        elif mp_strict and bool(np.all(np.diff(xs) > 0)):
            idx = np.searchsorted(mp_low, xs[1:])
            safe = np.minimum(idx, n - 1)
            ok = (idx < n) & (mp_low[safe] == xs[1:])
            # the sequential scan stalls at the first unmatched anchor
            fail = np.flatnonzero(~ok)
            n_cons = int(fail[0]) if len(fail) else len(ok)
            n_match = 1 + n_cons
            en = int(idx[n_cons - 1]) if n_cons > 0 else st
        else:
            en, n_match = _match_loop(qlen, a, r, mp_low, st)
        n_tot = en - st + 1
        if r.qs > avg_k and r.rs > avg_k:
            n_tot += 1
        if qlen - r.qs > avg_k and l_ref - r.re > avg_k:
            n_tot += 1
        if n_match >= n_tot:
            r.div = 0.0
        else:
            r.div = float(f32(1.0 - pow(n_match / n_tot, 1.0 / avg_k)))
