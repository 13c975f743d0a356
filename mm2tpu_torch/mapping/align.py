"""Base-level alignment orchestration (port of the reference align.c).

Drives the ksw2 extension kernels (ops/ksw2_ref.py, differential-tested
against the reference SSE builds) through the reference's exact recipe:
chain-end fixing, bad-seed filters, DP window computation, left extension,
seed-to-seed gap fills with two-pass Z-drop and inversion detection, right
extension, CIGAR fixups and stats (align.c:565-920).

The port's copy of `mm2tpu/mapping/align.py`, verbatim apart from its
imports and its TPU branches. An extd2 or splice fill of `--align-backend
gpu` reaches the device through the port's `extbatch.current()` when a
batcher is in scope (batch mode); without one (stream mode) a fill of at
least `--align-tpu-min-mat` cells runs alone on the port's
`ops.ksw2_exts2.exts2_batch` or `ops.ksw2_extd2.extd2_batch` (K4 or K3
on a CUDA device) on `extbatch.fill_device()`, where the JAX package
calls its Pallas `exts2_batch([fill])` and `extd2_batch([fill])`.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from ..options import (MapOptions, MM_F_SR, MM_F_SPLICE, MM_F_SPLICE_FOR,
                       MM_F_SPLICE_REV, MM_F_SPLICE_FLANK, MM_F_FOR_ONLY,
                       MM_F_REV_ONLY, MM_F_EQX, MM_F_NO_END_FLT,
                       MM_SEED_IGNORE, MM_SEED_TANDEM, MM_SEED_LONG_JOIN,
                       MM_SEED_SELF)
from ..ops import ksw2_ref as K
from .hit import (Region, Extra, _i32, _i32v, split_reg, filter_regs,
                  hit_sort, squeeze_a, MM_PARENT_UNSET, MM_PARENT_TMP_PRI)

INT32_MIN = -2**31


def _span(ay: int) -> int:
    return (ay >> 32) & 0xFF


_NATIVE_CAPS: dict = {}


def _native_has(probe: str) -> bool:
    """Memoized native-runtime capability check (has_* probe name)."""
    if probe not in _NATIVE_CAPS:
        try:
            from ..native import lib as native_lib
            _NATIVE_CAPS[probe] = getattr(native_lib, probe)()
        except Exception:
            _NATIVE_CAPS[probe] = False
    return _NATIVE_CAPS[probe]


def _cigar_fits(cigar, qseq, tseq) -> bool:
    """True iff the cigar's q/t spans stay inside the sequences — the
    native walks require this (the Python paths clamp, then assert)."""
    ca = np.asarray(cigar, np.uint32)
    ops = ca & 0xF
    lns = (ca >> 4).astype(np.int64)
    qspan = int(lns[(ops == 0) | (ops == 1)].sum())
    tspan = int(lns[(ops == 0) | (ops == 2) | (ops == 3)].sum())
    return qspan <= len(qseq) and tspan <= len(tseq)


def _zdrop_scan(opt: MapOptions, qseq, tseq, cigar, mat):
    """The per-base max/zdrop walk of mm_test_zdrop (align.c:52-68),
    vectorized: running last-occurrence max via prefix scans, first-
    occurrence best zdrop via argmax. Returns (max_zdrop, pos)."""
    if _native_has("has_cigar_walks") and _cigar_fits(cigar, qseq, tseq):
        from ..native import lib as native_lib
        return native_lib.zdrop_scan(np.asarray(cigar, np.uint32),
                                     qseq, tseq, mat, opt.q, opt.e)
    iv, jv, inc = [], [], []
    i = j = 0
    mat_i = np.asarray(mat, np.int64)
    for c in cigar:
        op, ln = c & 0xF, c >> 4
        if op == 0:
            inc.append(mat_i[np.asarray(tseq[i:i + ln], np.int64) * 5
                             + np.asarray(qseq[j:j + ln], np.int64)])
            iv.append(np.arange(i, i + ln, dtype=np.int64))
            jv.append(np.arange(j, j + ln, dtype=np.int64))
            i += ln
            j += ln
        elif op in (1, 2, 3):
            inc.append(np.array([-(opt.q + opt.e * ln)], np.int64))
            if op == 1:
                j += ln
            else:
                i += ln
            iv.append(np.array([i], np.int64))
            jv.append(np.array([j], np.int64))
    if not inc:
        return 0, [[-1, -1], [-1, -1]]
    s = np.cumsum(np.concatenate(inc))
    iv = np.concatenate(iv)
    jv = np.concatenate(jv)
    T = len(s)
    m_before = np.concatenate(([INT32_MIN],
                               np.maximum.accumulate(s)[:-1]))
    upd = s >= m_before  # state-update steps (align.c:43, ties update)
    idx = np.arange(T, dtype=np.int64)
    m_idx = np.maximum.accumulate(np.where(upd, idx, -1))
    d = iv - jv
    # z only where the score dropped below the running max
    z = np.where(upd, np.int64(INT32_MIN),
                 s[m_idx] - s - np.abs(d - d[m_idx]) * opt.e)
    kbest = int(np.argmax(z))  # first occurrence wins (strict > updates)
    max_zdrop = int(z[kbest])
    if max_zdrop <= 0:  # state[3] starts at 0; only z > 0 ever records pos
        return 0, [[-1, -1], [-1, -1]]
    mk = int(m_idx[kbest])
    pos = [[int(iv[mk]), int(iv[kbest])], [int(jv[mk]), int(jv[kbest])]]
    return max_zdrop, pos


def test_zdrop(opt: MapOptions, qseq, tseq, cigar, mat) -> int:
    """mm_test_zdrop (align.c:47-89): 0 = pass, 1 = zdrop, 2 = inversion."""
    max_zdrop, pos = _zdrop_scan(opt, qseq, tseq, cigar, mat)
    q_len = pos[1][1] - pos[1][0]
    t_len = pos[0][1] - pos[0][0]
    if (not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_FOR_ONLY | MM_F_REV_ONLY))
            and max_zdrop > opt.zdrop_inv and q_len < opt.max_gap
            and t_len < opt.max_gap):
        sub = qseq[pos[1][1] - q_len: pos[1][1]][::-1]
        qseq2 = np.where(sub >= 4, 4, 3 - sub).astype(np.uint8)
        score, _, _ = _ksw_ll(q_len, qseq2, t_len,
                               tseq[pos[0][0]: pos[0][0] + t_len], mat,
                               opt.q, opt.e)
        if score >= opt.min_chain_score * opt.a and score >= opt.min_dp_max:
            return 2
    return 1 if max_zdrop > opt.zdrop else 0


def fix_cigar(r: Region, qseq, tseq) -> Tuple[int, int]:
    """mm_fix_cigar (align.c:91-167): indel left-shift, 5I6D7I merge,
    leading-indel trim. Returns (qshift, tshift)."""
    p = r.p
    qshift = tshift = 0
    if p.n_cigar <= 1:
        return 0, 0
    if _native_has("has_fix_cigar"):
        from ..native import lib as native_lib
        carr = np.array(p.cigar, dtype=np.uint32)
        n, qshift, tshift, lead_op, qoff, toff = native_lib.fix_cigar(
            carr, qseq, tseq)
        assert qoff == r.qe - r.qs and toff == r.re - r.rs
        if lead_op == 1:
            if r.rev:
                r.qe -= qshift
            else:
                r.qs += qshift
        elif lead_op == 2:
            r.rs += tshift
        p.cigar = carr[:n].tolist()
        return qshift, tshift
    cig = p.cigar
    toff = qoff = 0
    to_shrink = False
    for k in range(len(cig)):
        op, ln = cig[k] & 0xF, cig[k] >> 4
        if ln == 0:
            to_shrink = True
        if op == 0:
            toff += ln
            qoff += ln
        elif op in (1, 2):
            if 0 < k < len(cig) - 1 and (cig[k - 1] & 0xF) == 0 and (cig[k + 1] & 0xF) == 0:
                prev_len = cig[k - 1] >> 4
                l = 0
                if op == 1:
                    while l < prev_len and qseq[qoff - 1 - l] == qseq[qoff + ln - 1 - l]:
                        l += 1
                else:
                    while l < prev_len and tseq[toff - 1 - l] == tseq[toff + ln - 1 - l]:
                        l += 1
                if l > 0:
                    cig[k - 1] -= l << 4
                    cig[k + 1] += l << 4
                    qoff -= l
                    toff -= l
                if l == prev_len:
                    to_shrink = True
            if op == 1:
                qoff += ln
            else:
                toff += ln
        elif op == 3:
            toff += ln
    assert qoff == r.qe - r.qs and toff == r.re - r.rs
    k = 0
    while k + 2 < len(cig):  # fix CIGAR like 5I6D7I
        if (cig[k] & 0xF) > 0 and (cig[k] & 0xF) + (cig[k + 1] & 0xF) == 3:
            s = [0, 0, 0]
            l = k
            while l < len(cig):
                op = cig[l] & 0xF
                if op == 1 or op == 2 or cig[l] >> 4 == 0:
                    if op < 3:
                        s[op] += cig[l] >> 4
                else:
                    break
                l += 1
            if s[1] > 0 and s[2] > 0 and l - k > 2:
                cig[k] = s[1] << 4 | 1
                cig[k + 1] = s[2] << 4 | 2
                for kk in range(k + 2, l):
                    cig[kk] &= 0xF
                to_shrink = True
            # the C loop is `for (...; ++k)` with `k = l` in the body
            # (align.c:126-143): the post-increment is what guarantees
            # progress when l == k (e.g. an N op matching the 0x3 sum)
            k = l + 1
        else:
            k += 1
    if to_shrink:
        cig[:] = [c for c in cig if c >> 4 != 0]
        merged: List[int] = []
        for c in cig:
            if merged and (merged[-1] & 0xF) == (c & 0xF):
                merged[-1] += (c >> 4) << 4
            else:
                merged.append(c)
        cig[:] = merged
    if cig and (cig[0] & 0xF) in (1, 2):
        l = cig[0] >> 4
        if (cig[0] & 0xF) == 1:
            if r.rev:
                r.qe -= l
            else:
                r.qs += l
            qshift = l
        else:
            r.rs += l
            tshift = l
        cig.pop(0)
    return qshift, tshift


def update_cigar_eqx(r: Region, qseq, tseq) -> None:
    """mm_update_cigar_eqx (align.c:169-238)."""
    if r.p is None:
        return
    out: List[int] = []
    toff = qoff = 0
    for c in r.p.cigar:
        op, ln = c & 0xF, c >> 4
        if op == 0:
            while ln > 0:
                l = 0
                while l < ln and qseq[qoff + l] == tseq[toff + l]:
                    l += 1
                if l > 0:
                    out.append(l << 4 | 7)
                    ln -= l
                    toff += l
                    qoff += l
                l = 0
                while l < ln and qseq[qoff + l] != tseq[toff + l]:
                    l += 1
                if l > 0:
                    out.append(l << 4 | 8)
                    ln -= l
                    toff += l
                    qoff += l
            continue
        elif op == 1:
            qoff += ln
        elif op in (2, 3):
            toff += ln
        out.append(c)
    r.p.cigar = out


def update_extra(r: Region, qseq, tseq, mat, q: int, e: int, is_eqx: bool) -> None:
    """mm_update_extra (align.c:240-286). qseq/tseq start at qs1/rs1."""
    p = r.p
    if p is None:
        return
    qshift, tshift = fix_cigar(r, qseq, tseq)
    qseq = qseq[qshift:]
    tseq = tseq[tshift:]
    if _native_has("has_cigar_walks") and _cigar_fits(p.cigar, qseq, tseq):
        from ..native import lib as native_lib
        blen, mlen, n_ambi, dp_max, qoff, toff = native_lib.update_stats(
            np.asarray(p.cigar, np.uint32), qseq, tseq, mat, q, e)
        r.blen, r.mlen = int(blen), int(mlen)
        p.n_ambi += int(n_ambi)
        p.dp_max = int(dp_max)
        assert qoff == r.qe - r.qs and toff == r.re - r.rs
        if is_eqx:
            update_cigar_eqx(r, qseq, tseq)
        return
    r.blen = r.mlen = 0
    s = mx = 0
    toff = qoff = 0
    for c in p.cigar:
        op, ln = c & 0xF, c >> 4
        if op == 0:
            cq = qseq[qoff: qoff + ln]
            ct = tseq[toff: toff + ln]
            ambi = (ct > 3) | (cq > 3)
            n_ambi = int(np.sum(ambi))
            n_diff = int(np.sum(~ambi & (ct != cq)))
            # running clamped score (sequential; uses per-base mat values)
            vals = mat.reshape(5, 5)[ct, cq]
            for vv in vals:
                s += int(vv)
                if s < 0:
                    s = 0
                elif s > mx:
                    mx = s
            r.blen += ln - n_ambi
            r.mlen += ln - (n_ambi + n_diff)
            p.n_ambi += n_ambi
            toff += ln
            qoff += ln
        elif op == 1:
            n_ambi = int(np.sum(qseq[qoff: qoff + ln] > 3))
            r.blen += ln - n_ambi
            p.n_ambi += n_ambi
            s -= q + e * ln
            if s < 0:
                s = 0
            qoff += ln
        elif op == 2:
            n_ambi = int(np.sum(tseq[toff: toff + ln] > 3))
            r.blen += ln - n_ambi
            p.n_ambi += n_ambi
            s -= q + e * ln
            if s < 0:
                s = 0
            toff += ln
        elif op == 3:
            toff += ln
    p.dp_max = mx
    assert qoff == r.qe - r.qs and toff == r.re - r.rs
    if is_eqx:
        update_cigar_eqx(r, qseq, tseq)


def append_cigar(r: Region, cigar: List[int]) -> None:
    """mm_append_cigar (align.c:288-311)."""
    if not cigar:
        return
    if r.p is None:
        r.p = Extra()
    p = r.p
    if p.cigar and (p.cigar[-1] & 0xF) == (cigar[0] & 0xF):
        p.cigar[-1] += (cigar[0] >> 4) << 4
        p.cigar.extend(cigar[1:])
    else:
        p.cigar.extend(cigar)


def _ksw_ll(qlen, qseq, tlen, tseq, mat, gapo, gape):
    """ksw_ll_i16 dispatch: native striped local SW when built."""
    if _native_has("has_ksw_ll"):
        from ..native import lib as native_lib
        return native_lib.ksw_ll(qlen, qseq, tlen, tseq, mat, gapo, gape)
    return K.ksw_ll(qlen, qseq, tlen, tseq, mat, gapo, gape)


def _native_exts2() -> bool:
    return _native_has("has_exts2")


def _native_ksw() -> bool:
    return _native_has("has_ksw")


def _index_sptr(mi) -> int:
    """Raw pointer of the 4-bit packed reference, cached on the index
    (ndarray.ctypes costs ~2us per access — per fill it dominated)."""
    p = getattr(mi, "_S_ptr", None)
    if p is None:
        p = mi.S.ctypes.data
        try:
            mi._S_ptr = p
        except AttributeError:
            pass
    return p


def _fill_fused_ok(opt: MapOptions, qlen_: int, tlen_: int) -> bool:
    """True when a seed-gap fill may take the fused native path — every
    condition under which align_pair would route this fill to the native
    extd2 kernel (and test_zdrop would use the native scan)."""
    if not _native_has("has_fill") or opt.dbg_print_aln_seq:
        return False
    if opt.flag & MM_F_SPLICE:
        return False
    if opt.max_sw_mat > 0 and qlen_ * tlen_ > opt.max_sw_mat:
        return False
    if opt.align_backend == "gpu" and qlen_ * tlen_ >= opt.align_tpu_min_mat:
        return False
    from . import extbatch
    b = extbatch.current()
    if b is not None and qlen_ * tlen_ >= b.min_cells:
        return False
    return True


def align_pair(opt: MapOptions, qseq, tseq, junc, mat, w: int,
               end_bonus: int, zdrop: int, flag: int) -> K.ExtzResult:
    """mm_align_pair (align.c:313-339)."""
    qlen, tlen = len(qseq), len(tseq)
    if opt.dbg_print_aln_seq:  # --print-aln-seq (align.c:315-322)
        import sys as _sys
        print("===> q=(%d,%d), e=(%d,%d), bw=%d, flag=%d, zdrop=%d <==="
              % (opt.q, opt.q2, opt.e, opt.e2, w, flag, opt.zdrop),
              file=_sys.stderr)
        code = "ACGTN"
        print("".join(code[min(int(c), 4)] for c in tseq), file=_sys.stderr)
        print("".join(code[min(int(c), 4)] for c in qseq), file=_sys.stderr)
    if opt.max_sw_mat > 0 and tlen * qlen > opt.max_sw_mat:
        ez = K.ExtzResult()
        ez.zdropped = True
        return ez
    if opt.flag & MM_F_SPLICE:
        from . import extbatch
        _bat = extbatch.current()
        if _bat is not None and qlen * tlen >= _bat.min_cells:
            # the splice counterpart of the batched dispatch below (the
            # JAX package sends these fills to exts2_batch)
            return _bat.submit_exts2(qseq, tseq, junc,
                                     np.asarray(mat, np.int8), opt.q, opt.e,
                                     opt.q2, opt.noncan, zdrop,
                                     opt.junc_bonus, flag)
        if opt.align_backend == "gpu" and \
                qlen * tlen >= opt.align_tpu_min_mat:
            # no batcher in scope (stream mode): this fill alone on K4
            from ..ops.ksw2_exts2 import exts2_batch
            return exts2_batch(
                [(np.asarray(qseq, np.uint8), np.asarray(tseq, np.uint8),
                  junc)], np.asarray(mat, np.int8), opt.q, opt.e, opt.q2,
                opt.noncan, zdrop, opt.junc_bonus, flag,
                device=extbatch.fill_device())[0]
        if _native_exts2():
            from ..native import lib as native_lib
            return native_lib.ksw_exts2(
                qlen, qseq, tlen, tseq, mat, opt.q, opt.e, opt.q2,
                opt.noncan, zdrop, opt.junc_bonus, flag, junc)
        from ..ops.ksw2_splice_ref import ksw_exts2
        return ksw_exts2(qlen, qseq, tlen, tseq, mat, opt.q, opt.e, opt.q2,
                         opt.noncan, zdrop, opt.junc_bonus, flag, junc)
    from . import extbatch
    _bat = extbatch.current()
    if _bat is not None and qlen * tlen >= _bat.min_cells:
        # cross-read batched device dispatch (extbatch.ExtBatcher): this
        # thread parks until the dispatcher flushes a full bucket — many
        # reads' fills amortize one Pallas launch, the per-call analogue
        # of the reference's DMA batching (chain_hardware.cpp:104-189)
        return _bat.submit(qseq, tseq, np.asarray(mat, np.int8), opt.q,
                           opt.e, opt.q2, opt.e2, w, zdrop, end_bonus,
                           flag)
    if opt.align_backend == "gpu" and \
            qlen * tlen >= opt.align_tpu_min_mat:
        # no batcher in scope (stream mode): this fill alone on K3 (bit-
        # exact vs the host ports, incl. the extz2 single-affine case —
        # extd2 with q2=q, e2=e is cell-identical)
        from ..ops.ksw2_extd2 import extd2_batch
        return extd2_batch(
            [(np.asarray(qseq, np.uint8), np.asarray(tseq, np.uint8))],
            np.asarray(mat, np.int8), opt.q, opt.e, opt.q2, opt.e2, w,
            zdrop, end_bonus, flag, device=extbatch.fill_device())[0]
    if _native_ksw():
        # native C++ extd2 (bit-identical to the NumPy oracle; the
        # equal-cost identity serves the extz2 branch too)
        from ..native import lib as native_lib
        return native_lib.ksw_extd2(qlen, qseq, tlen, tseq, mat, opt.q,
                                    opt.e, opt.q2, opt.e2, w, zdrop,
                                    end_bonus, flag)
    if opt.q == opt.q2 and opt.e == opt.e2:
        return K.ksw_extz2(qlen, qseq, tlen, tseq, mat, opt.q, opt.e, w,
                           zdrop, end_bonus, flag)
    return K.ksw_extd2(qlen, qseq, tlen, tseq, mat, opt.q, opt.e,
                       opt.q2, opt.e2, w, zdrop, end_bonus, flag)


def _get_hplen_back(mi, rid: int, x: int) -> int:
    """mm_get_hplen_back (align.c:341-348)."""
    seq = mi.getseq_fast(rid, 0, x + 1)
    c = seq[x]
    i = x - 1
    while i >= 0 and seq[i] == c:
        i -= 1
    return x - i


def adjust_minier(mi, qseq0, ax: int, ay: int) -> Tuple[int, int]:
    """mm_adjust_minier (align.c:350-365): returns (r, q)."""
    if mi.flag & 0x1:  # HPC
        qseq = qseq0[ax >> 63]
        qpos = _i32(ay)
        c = qseq[qpos]
        i = qpos - 1
        while i > 0 and qseq[i] == c:
            i -= 1
        qv = i + 1
        c = _get_hplen_back(mi, (ax << 1 >> 33) & 0x7FFFFFFF, _i32(ax))
        rv = _i32(ax) + 1 - c
    else:
        rv = _i32(ax) - (mi.k >> 1)
        qv = _i32(ay) - (mi.k >> 1)
    return rv, qv


def collect_long_gaps(as1, cnt1, a, min_gap) -> List[int]:
    """align.c:367-384 (vectorized over the chain's seeds)."""
    if cnt1 <= 1:
        return []
    ax = _i32v(a[as1: as1 + cnt1, 0])
    ay = _i32v(a[as1: as1 + cnt1, 1])
    gap = np.diff(ay) - np.diff(ax)
    ks = (np.nonzero((gap < -min_gap) | (gap > min_gap))[0] + 1).tolist()
    return ks if len(ks) > 1 else []


def filter_bad_seeds(as1, cnt1, a, min_gap, diff_thres, max_ext_len,
                     max_ext_cnt) -> None:
    """mm_filter_bad_seeds (align.c:386-421)."""
    ks = collect_long_gaps(as1, cnt1, a, min_gap)
    if not ks:
        return
    n = len(ks)
    mx, max_st, max_en = 0, -1, -1
    k = 0
    while True:
        if k == n or k >= max_en:
            if max_en > 0:
                for i in range(ks[max_st], ks[max_en]):
                    a[as1 + i, 1] |= np.uint64(MM_SEED_IGNORE)
            mx, max_st, max_en = 0, -1, -1
            if k == n:
                break
        i = ks[k]
        gap = (_i32(a[as1 + i, 1]) - _i32(a[as1 + i - 1, 1])) - \
              (_i32(a[as1 + i, 0]) - _i32(a[as1 + i - 1, 0]))
        n_ins = gap if gap > 0 else 0
        n_del = -gap if gap <= 0 else 0
        qs = _i32(a[as1 + i - 1, 1])
        rs = _i32(a[as1 + i - 1, 0])
        max_diff, max_diff_l = 0, -1
        l = k + 1
        while l < n and l <= k + max_ext_cnt:
            j = ks[l]
            if _i32(a[as1 + j, 1]) - qs > max_ext_len or \
               _i32(a[as1 + j, 0]) - rs > max_ext_len:
                break
            gap = (_i32(a[as1 + j, 1]) - _i32(a[as1 + j - 1, 1])) - \
                  (_i32(a[as1 + j, 0]) - _i32(a[as1 + j - 1, 0]))
            if gap > 0:
                n_ins += gap
            else:
                n_del += -gap
            diff = n_ins + n_del - abs(n_ins - n_del)
            if max_diff < diff:
                max_diff, max_diff_l = diff, l
            l += 1
        if max_diff > diff_thres and max_diff > mx:
            mx, max_st, max_en = max_diff, k, max_diff_l
        k += 1


def filter_bad_seeds_alt(as1, cnt1, a, min_gap, max_ext) -> None:
    """mm_filter_bad_seeds_alt (align.c:423-457)."""
    ks = collect_long_gaps(as1, cnt1, a, min_gap)
    if not ks:
        return
    n = len(ks)
    k = 0
    while k < n:
        i = ks[k]
        gap1 = (_i32(a[as1 + i, 1]) - _i32(a[as1 + i - 1, 1])) - \
               (_i32(a[as1 + i, 0]) - _i32(a[as1 + i - 1, 0]))
        re1 = _i32(a[as1 + i, 0])
        qe1 = _i32(a[as1 + i, 1])
        gap1 = abs(gap1)
        l = k + 1
        while l < n:
            j = ks[l]
            if _i32(a[as1 + j, 1]) - qe1 > max_ext or \
               _i32(a[as1 + j, 0]) - re1 > max_ext:
                break
            gap2 = (_i32(a[as1 + j, 1]) - _i32(a[as1 + j - 1, 1])) - \
                   (_i32(a[as1 + j, 0]) - _i32(a[as1 + j - 1, 0]))
            q_span_pre = _span(int(a[as1 + j - 1, 1]))
            rs2 = _i32(a[as1 + j - 1, 0]) + q_span_pre
            qs2 = _i32(a[as1 + j - 1, 1]) + q_span_pre
            mval = min(rs2 - re1, qs2 - qe1)
            gap2 = abs(gap2)
            if mval > gap1 + gap2:
                break
            re1 = _i32(a[as1 + j, 0])
            qe1 = _i32(a[as1 + j, 1])
            gap1 = gap2
            l += 1
        if l > k + 1:
            end = ks[l - 1]
            for j in range(ks[k], end):
                a[as1 + j, 1] |= np.uint64(MM_SEED_IGNORE)
            a[as1 + end, 1] |= np.uint64(MM_SEED_LONG_JOIN)
        k = l


def fix_bad_ends(r: Region, a, bw: int, min_match: int) -> Tuple[int, int]:
    """mm_fix_bad_ends (align.c:459-493)."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 3:
        return as_, cnt
    if _native_has("has_fix_bad_ends"):
        from ..native import lib as native_lib
        return native_lib.fix_bad_ends(a, r.as_, r.cnt, bw, min_match,
                                       r.mlen)
    return fix_bad_ends_py(r, a, bw, min_match)


def fix_bad_ends_py(r: Region, a, bw: int, min_match: int
                    ) -> Tuple[int, int]:
    """Pure-Python mm_fix_bad_ends (the native path's oracle)."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 3:
        return as_, cnt
    # python-int lists: the scans walk O(bw/spacing) anchors with 4
    # element reads per step — numpy scalar indexing dominates otherwise
    xs = a[r.as_: r.as_ + r.cnt, 0].tolist()
    ys = a[r.as_: r.as_ + r.cnt, 1].tolist()
    base = r.as_
    m = l = (ys[0] >> 32) & 0xFF
    for i in range(1, r.cnt - 1):
        yi = ys[i]
        q_span = (yi >> 32) & 0xFF
        if yi & MM_SEED_LONG_JOIN:
            break
        lr = _i32(xs[i]) - _i32(xs[i - 1])
        lq = _i32(yi) - _i32(ys[i - 1])
        mn, mx = (lr, lq) if lr < lq else (lq, lr)
        if mx - mn > l >> 1:
            as_ = base + i
        l += mn
        m += mn if mn < q_span else q_span
        if l >= bw << 1 or (m >= min_match and m >= bw) or m >= r.mlen >> 1:
            break
    cnt = base + r.cnt - as_
    m = l = (ys[r.cnt - 1] >> 32) & 0xFF
    for i in range(r.cnt - 2, as_ - base, -1):
        y1 = ys[i + 1]
        q_span = (y1 >> 32) & 0xFF
        if y1 & MM_SEED_LONG_JOIN:
            break
        lr = _i32(xs[i + 1]) - _i32(xs[i])
        lq = _i32(y1) - _i32(ys[i])
        mn, mx = (lr, lq) if lr < lq else (lq, lr)
        if mx - mn > l >> 1:
            cnt = base + i + 1 - as_
        l += mn
        m += mn if mn < q_span else q_span
        if l >= bw << 1 or (m >= min_match and m >= bw) or m >= r.mlen >> 1:
            break
    return as_, cnt


def max_stretch(r: Region, a) -> Tuple[int, int]:
    """mm_max_stretch (align.c:495-521)."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 2:
        return as_, cnt
    if cnt < 24:  # short chains (sr): the scalar scan beats numpy overhead
        max_score, max_i, max_len = -1, -1, 0
        score = _span(int(a[as_, 1]))
        length = 1
        i = as_ + 1
        for i in range(as_ + 1, as_ + cnt):
            q_span = _span(int(a[i, 1]))
            lr = _i32(a[i, 0]) - _i32(a[i - 1, 0])
            lq = _i32(a[i, 1]) - _i32(a[i - 1, 1])
            if lq == lr:
                score += min(lq, q_span)
                length += 1
            else:
                if score > max_score:
                    max_score, max_len, max_i = score, length, i - length
                score, length = q_span, 1
        i = as_ + cnt
        if score > max_score:
            max_score, max_len, max_i = score, length, i - length
        return max_i, max_len
    # vectorized: split into equal-diagonal runs, score each run, pick the
    # first maximum (the scalar scan's strict-> tie-break)
    seg = a[as_: as_ + cnt]
    spans = ((seg[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    lr = np.diff(_i32v(seg[:, 0]))
    lq = np.diff(_i32v(seg[:, 1]))
    cont = lq == lr
    run_id = np.concatenate(([0], np.cumsum(~cont)))
    contrib = np.empty(cnt, np.int64)
    contrib[0] = spans[0]
    contrib[1:] = np.where(cont, np.minimum(lq, spans[1:]), spans[1:])
    sums = np.bincount(run_id, weights=contrib).astype(np.int64)
    lens = np.bincount(run_id)
    starts = np.concatenate(([0], np.nonzero(~cont)[0] + 1))
    best = int(np.argmax(sums))
    return as_ + int(starts[best]), int(lens[best])


def seed_ext_score(opt: MapOptions, mi, mat, qlen: int, qseq0, ax, ay) -> int:
    """mm_seed_ext_score (align.c:523-543)."""
    q_span = _span(int(ay))
    rid = (int(ax) << 1 >> 33) & 0x7FFFFFFF
    re = _i32(ax) + 1
    rs = re - q_span
    qe = _i32(ay) + 1
    qs = qe - q_span
    ext = opt.anchor_ext_len
    rs = max(rs - ext, 0)
    qs = max(qs - ext, 0)
    re = min(re + ext, mi.seq[rid].length)
    qe = min(qe + ext, qlen)
    tseq = mi.getseq_fast(rid, rs, re)
    qseq = qseq0[int(ax) >> 63][qs:qe]
    score, _, _ = _ksw_ll(qe - qs, qseq, re - rs, tseq, mat, opt.q, opt.e)
    return score


def fix_bad_ends_splice(opt: MapOptions, mi, r: Region, mat, qlen: int,
                        qseq0, a) -> Tuple[int, int]:
    """mm_fix_bad_ends_splice (align.c:545-563)."""
    as1, cnt1 = r.as_, r.cnt
    if r.cnt < 3:
        return as1, cnt1
    log_gap = math.log(_i32(a[r.as_ + 1, 0]) - _i32(a[r.as_, 0]))
    if _span(int(a[r.as_, 1])) < log_gap + opt.anchor_ext_shift:
        score = seed_ext_score(opt, mi, mat, qlen, qseq0, a[r.as_, 0], a[r.as_, 1])
        if score / mat[0] < log_gap + opt.anchor_ext_shift:
            as1 += 1
            cnt1 -= 1
    log_gap = math.log(_i32(a[r.as_ + r.cnt - 1, 0]) - _i32(a[r.as_ + r.cnt - 2, 0]))
    if _span(int(a[r.as_ + r.cnt - 1, 1])) < log_gap + opt.anchor_ext_shift:
        score = seed_ext_score(opt, mi, mat, qlen, qseq0,
                               a[r.as_ + r.cnt - 1, 0], a[r.as_ + r.cnt - 1, 1])
        if score / mat[0] < log_gap + opt.anchor_ext_shift:
            cnt1 -= 1
    return as1, cnt1


def _get_junc(mi, rid, st, en):
    """mm_idx_bed_junc per-base flags; zeros when no BED loaded."""
    if getattr(mi, "junc", None) is not None:
        return mi.junc.flags(rid, st, en)
    return np.zeros(en - st, np.uint8)


def align1(opt: MapOptions, mi, qlen: int, qseq0, r: Region, n_a: int,
           a: np.ndarray, splice_flag: int) -> Optional[Region]:
    """mm_align1 (align.c:565-795). Returns r2 (split region) or None."""
    is_sr = bool(opt.flag & MM_F_SR)
    is_splice = bool(opt.flag & MM_F_SPLICE)
    rid = (int(a[r.as_, 0]) << 1 >> 33) & 0x7FFFFFFF
    rev = int(a[r.as_, 0]) >> 63
    r2: Optional[Region] = None
    if r.cnt == 0:
        return None
    mat = K.gen_simple_mat(opt.a, opt.b, opt.sc_ambi)
    bw = int(opt.bw * 1.5 + 1.0)
    _qptr = [None]  # lazy (fwd, rc) base pointers for the fused fill

    if is_sr and not (mi.flag & 0x1):
        as1, cnt1 = max_stretch(r, a)
        rs = _i32(a[as1, 0]) + 1 - _span(int(a[as1, 1]))
        qs = _i32(a[as1, 1]) + 1 - _span(int(a[as1, 1]))
        re = _i32(a[as1 + cnt1 - 1, 0]) + 1
        qe = _i32(a[as1 + cnt1 - 1, 1]) + 1
    else:
        if not (opt.flag & MM_F_NO_END_FLT):
            if is_splice:
                as1, cnt1 = fix_bad_ends_splice(opt, mi, r, mat, qlen, qseq0, a)
            else:
                as1, cnt1 = fix_bad_ends(r, a, opt.bw, opt.min_chain_score * 2)
        else:
            as1, cnt1 = r.as_, r.cnt
        filter_bad_seeds(as1, cnt1, a, 10, 40, opt.max_gap >> 1, 10)
        filter_bad_seeds_alt(as1, cnt1, a, 30, opt.max_gap >> 1)
        rs, qs = adjust_minier(mi, qseq0, int(a[as1, 0]), int(a[as1, 1]))
        re, qe = adjust_minier(mi, qseq0, int(a[as1 + cnt1 - 1, 0]),
                               int(a[as1 + cnt1 - 1, 1]))
    assert cnt1 > 0

    extra_flag = 0
    if is_splice:
        if splice_flag & MM_F_SPLICE_FOR:
            extra_flag |= K.KSW_EZ_SPLICE_REV if rev else K.KSW_EZ_SPLICE_FOR
        if splice_flag & MM_F_SPLICE_REV:
            extra_flag |= K.KSW_EZ_SPLICE_FOR if rev else K.KSW_EZ_SPLICE_REV
        if opt.flag & MM_F_SPLICE_FLANK:
            extra_flag |= K.KSW_EZ_SPLICE_FLANK

    # DP window [rs0,re0) x [qs0,qe0)  (align.c:608-684)
    if is_sr:
        qs0, qe0 = 0, qlen
        l = qs
        l += (l * opt.a + opt.end_bonus - opt.q) // opt.e \
            if l * opt.a + opt.end_bonus > opt.q else 0
        rs0 = max(rs - l, 0)
        l = qlen - qe
        l += (l * opt.a + opt.end_bonus - opt.q) // opt.e \
            if l * opt.a + opt.end_bonus > opt.q else 0
        re0 = min(re + l, mi.seq[rid].length)
    else:
        rs0 = _i32(a[r.as_, 0]) + 1 - _span(int(a[r.as_, 1]))
        qs0 = _i32(a[r.as_, 1]) + 1 - _span(int(a[r.as_, 1]))
        if rs0 < 0:
            rs0 = 0
        assert qs0 >= 0
        rs1 = qs1 = 0
        l = 0
        i = r.as_ - 1
        while i >= 0 and int(a[i, 0]) >> 32 == int(a[r.as_, 0]) >> 32:
            x = _i32(a[i, 0]) + 1 - _span(int(a[i, 1]))
            yv = _i32(a[i, 1]) + 1 - _span(int(a[i, 1]))
            if x < rs0 and yv < qs0:
                l += 1
                if l > opt.min_cnt:
                    l = max(rs0 - x, qs0 - yv)
                    rs1, qs1 = rs0 - l, qs0 - l
                    if rs1 < 0:
                        rs1 = 0
                    break
            i -= 1
        if qs > 0 and rs > 0:
            l = min(qs, opt.max_gap)
            qs1 = max(qs1, qs - l)
            qs0 = min(qs0, qs1)
            l += (l * opt.a - opt.q) // opt.e if l * opt.a > opt.q else 0
            l = min(l, opt.max_gap)
            l = min(l, rs)
            rs1 = max(rs1, rs - l)
            rs0 = min(rs0, rs1)
            rs0 = min(rs0, rs)
        else:
            rs0, qs0 = rs, qs
        re0 = _i32(a[r.as_ + r.cnt - 1, 0]) + 1
        qe0 = _i32(a[r.as_ + r.cnt - 1, 1]) + 1
        re1, qe1 = mi.seq[rid].length, qlen
        l = 0
        i = r.as_ + r.cnt
        while i < n_a and int(a[i, 0]) >> 32 == int(a[r.as_, 0]) >> 32:
            x = _i32(a[i, 0]) + 1
            yv = _i32(a[i, 1]) + 1
            if x > re0 and yv > qe0:
                l += 1
                if l > opt.min_cnt:
                    l = max(x - re0, yv - qe0)
                    re1, qe1 = re0 + l, qe0 + l
                    break
            i += 1
        if qe < qlen and re < mi.seq[rid].length:
            l = min(qlen - qe, opt.max_gap)
            qe1 = min(qe1, qe + l)
            qe0 = max(qe0, qe1)
            l += (l * opt.a - opt.q) // opt.e if l * opt.a > opt.q else 0
            l = min(l, opt.max_gap)
            l = min(l, mi.seq[rid].length - re)
            re1 = min(re1, re + l)
            re0 = max(re0, re1)
        else:
            re0, qe0 = re, qe
    if int(a[r.as_, 1]) & MM_SEED_SELF:
        max_ext = abs(r.qs - r.rs)
        if r.rs - rs0 > max_ext:
            rs0 = r.rs - max_ext
        if r.qs - qs0 > max_ext:
            qs0 = r.qs - max_ext
        max_ext = abs(r.qe - r.re)
        if re0 - r.re > max_ext:
            re0 = r.re + max_ext
        if qe0 - r.qe > max_ext:
            qe0 = r.qe + max_ext

    assert re0 > rs0
    dropped = False

    if qs > 0 and rs > 0:  # left extension
        qseq = qseq0[rev][qs0:qs][::-1]
        tseq = mi.getseq_fast(rid, rs0, rs)[::-1]
        junc = _get_junc(mi, rid, rs0, rs)[::-1]
        ez = align_pair(opt, qseq, tseq, junc, mat, bw, opt.end_bonus,
                        opt.zdrop_inv if r.split_inv else opt.zdrop,
                        extra_flag | K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT | K.KSW_EZ_REV_CIGAR)
        if ez.n_cigar > 0:
            append_cigar(r, ez.cigar)
            r.p.dp_score += ez.max
        rs1 = rs - (ez.mqe_t + 1 if ez.reach_end else ez.max_t + 1)
        qs1 = qs - (qs - qs0 if ez.reach_end else ez.max_q + 1)
    else:
        rs1, qs1 = rs, qs
    re1, qe1 = rs, qs
    assert qs1 >= 0 and rs1 >= 0

    # seed-walk precompute: python-int lists instead of per-iteration
    # numpy scalar indexing, and the non-HPC adjust_minier (a constant
    # k/2 shift, align.c:361-363) vectorized over the chain's seeds
    ax_l = a[as1: as1 + cnt1, 0].tolist()
    ay_l = a[as1: as1 + cnt1, 1].tolist()
    if not (mi.flag & 0x1):
        rv_l = (_i32v(a[as1: as1 + cnt1, 0]) - (mi.k >> 1)).tolist()
        qv_l = (_i32v(a[as1: as1 + cnt1, 1]) - (mi.k >> 1)).tolist()
    else:
        rv_l = qv_l = None
    # hoist the fused-fill eligibility invariants out of the fill loop
    # (_fill_fused_ok's per-call module/flag/threadlocal lookups)
    _fused_const = (_native_has("has_fill") and not opt.dbg_print_aln_seq
                    and not (opt.flag & MM_F_SPLICE) and mi.S is not None)
    _fused_mat_cap = opt.max_sw_mat if opt.max_sw_mat > 0 else None
    _fused_tpu_cap = (opt.align_tpu_min_mat
                      if opt.align_backend == "gpu" else None)
    if _fused_const:
        from . import extbatch as _eb
        _b = _eb.current()
        _fused_batch_cap = _b.min_cells if _b is not None else None
    else:
        _fused_batch_cap = None

    def _fused_ok_fast(qlen_, tlen_):
        if not _fused_const:
            return False
        cells = qlen_ * tlen_
        if _fused_mat_cap is not None and cells > _fused_mat_cap:
            return False
        if _fused_tpu_cap is not None and cells >= _fused_tpu_cap:
            return False
        if _fused_batch_cap is not None and cells >= _fused_batch_cap:
            return False
        return True

    # batched seed-walk: the gap-fill geometry is deterministic (each
    # fill starts at the previous seed's endpoint whatever the fill
    # returned, until a zdrop breaks the walk) — so plan every gap up
    # front and run the WHOLE walk in one native call
    # (native_lib.ksw_fill_walk), instead of ~50 FFI crossings per read.
    # Fallback to the per-gap loop for sr/HPC/splice or when any gap is
    # routed off the fused path (device caps).
    walked = False
    if (_fused_const and not is_sr and rv_l is not None
            and _native_has("has_fill_walk")):
        sseq = mi.seq[rid]
        plan = []  # (i_seed, qlen, tlen, q_off, ref_off, bw1)
        plan_ok = True
        rs_p, qs_p = rs, qs
        i = 1
        while i < cnt1:
            ay = ay_l[i]
            if (ay & (MM_SEED_IGNORE | MM_SEED_TANDEM)) and i != cnt1 - 1:
                i += 1
                continue
            re_p, qe_p = rv_l[i], qv_l[i]
            if i == cnt1 - 1 or (ay & MM_SEED_LONG_JOIN) or \
                    (qe_p - qs_p >= opt.min_ksw_len and
                     re_p - rs_p >= opt.min_ksw_len):
                if not _fused_ok_fast(qe_p - qs_p, re_p - rs_p):
                    plan_ok = False
                    break
                bw1 = max(qe_p - qs_p, re_p - rs_p) \
                    if ay & MM_SEED_LONG_JOIN else bw
                plan.append((i, qe_p - qs_p,
                             min(re_p, sseq.length) - rs_p, qs_p,
                             sseq.offset + rs_p, bw1))
                rs_p, qs_p = re_p, qe_p
            i += 1
        if plan_ok and plan:
            from ..native import lib as native_lib
            if _qptr[0] is None:
                _qptr[0] = (qseq0[0].ctypes.data, qseq0[1].ctypes.data)
            garr = np.array([p[1:] for p in plan], np.int64)
            n_done, zcode, ssum, zflag, wcig, wez = native_lib.ksw_fill_walk(
                garr, _index_sptr(mi), _qptr[0][rev], mat, opt.q, opt.e,
                opt.q2, opt.e2, opt.zdrop, opt.zdrop_inv, extra_flag,
                not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_FOR_ONLY |
                                 MM_F_REV_ONLY)),
                opt.max_gap, opt.min_chain_score * opt.a, opt.min_dp_max)
            if wcig:
                append_cigar(r, wcig)
            if r.p is None:
                r.p = Extra()
            r.p.dp_score += ssum
            i_seed, _, _, gq, goff, _ = plan[n_done - 1]
            gr = goff - sseq.offset  # last executed gap's rs
            if zflag:
                j = i_seed - 1
                while j >= 0:
                    if _i32(ax_l[j]) <= gr + wez.max_t:
                        break
                    j -= 1
                dropped = True
                if j < 0:
                    j = 0
                r.p.dp_score += wez.max
                # mirror the fallback loop's state on break: re/qe hold the
                # dropped seed's endpoint (set at the top of its iteration)
                re, qe = rv_l[i_seed], qv_l[i_seed]
                re1 = gr + (wez.max_t + 1)
                qe1 = gq + (wez.max_q + 1)
                if cnt1 - (j + 1) >= opt.min_cnt:
                    r2 = split_reg(r, as1 + j + 1 - r.as_, qlen, a)
                    if r2 is not None and zcode == 2:
                        r2.split_inv = True
            else:
                rs, qs = rv_l[i_seed], qv_l[i_seed]
                re, qe = rs, qs
                re1, qe1 = rs, qs
            walked = True

    i = cnt1 if walked else (cnt1 - 1 if is_sr else 1)
    while i < cnt1:  # gap filling
        ay = ay_l[i]
        if (ay & (MM_SEED_IGNORE | MM_SEED_TANDEM)) and i != cnt1 - 1:
            i += 1
            continue
        if is_sr and not (mi.flag & 0x1):
            re = _i32(ax_l[i]) + 1
            qe = _i32(ay) + 1
        elif rv_l is not None:
            re, qe = rv_l[i], qv_l[i]
        else:
            re, qe = adjust_minier(mi, qseq0, ax_l[i], ay)
        re1, qe1 = re, qe
        if i == cnt1 - 1 or (ay & MM_SEED_LONG_JOIN) or \
                (qe - qs >= opt.min_ksw_len and re - rs >= opt.min_ksw_len):
            bw1 = bw
            if ay & MM_SEED_LONG_JOIN:
                bw1 = max(qe - qs, re - rs)
            zdrop_code = None
            if not is_sr and _fused_ok_fast(qe - qs, re - rs):
                # fused native fill: approx extd2 + mm_test_zdrop (incl.
                # inversion probe) + exact re-run in ONE FFI call, with
                # the target unpacked in C from the 4-bit reference and
                # the query passed as base pointer + offset — no per-fill
                # getseq, slicing, or array marshalling (the per-call
                # Python overhead of the 3-4 call sequence was most of
                # the align stage's cost)
                from ..native import lib as native_lib
                sseq = mi.seq[rid]
                if _qptr[0] is None:
                    _qptr[0] = (qseq0[0].ctypes.data, qseq0[1].ctypes.data)
                ez, zdrop_code = native_lib.ksw_extd2_fill_ref(
                    _index_sptr(mi), sseq.offset + rs,
                    min(re, sseq.length) - rs, _qptr[0][rev] + qs, qe - qs,
                    mat, opt.q, opt.e, opt.q2, opt.e2, bw1, opt.zdrop,
                    opt.zdrop_inv, extra_flag,
                    not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_FOR_ONLY |
                                     MM_F_REV_ONLY)),
                    opt.max_gap, opt.min_chain_score * opt.a,
                    opt.min_dp_max)
            else:
                qseq = qseq0[rev][qs:qe]
                tseq = mi.getseq_fast(rid, rs, re)
                junc = _get_junc(mi, rid, rs, re)
                if is_sr:  # ungapped
                    ez = K.ExtzResult()
                    score = 0
                    for j in range(qe - qs):
                        if qseq[j] >= 4 or tseq[j] >= 4:
                            score += opt.e2
                        else:
                            score += opt.a if qseq[j] == tseq[j] else -opt.b
                    ez.score = score
                    ez.cigar = [(qe - qs) << 4 | 0]
                else:
                    ez = align_pair(opt, qseq, tseq, junc, mat, bw1, -1,
                                    opt.zdrop,
                                    extra_flag | K.KSW_EZ_APPROX_MAX)
            if zdrop_code is None:
                zdrop_code = test_zdrop(opt, qseq, tseq, ez.cigar, mat)
                if zdrop_code != 0:
                    ez = align_pair(opt, qseq, tseq, junc, mat, bw1, -1,
                                    opt.zdrop_inv if zdrop_code == 2
                                    else opt.zdrop,
                                    extra_flag)
            if ez.n_cigar > 0:
                append_cigar(r, ez.cigar)
            if ez.zdropped:
                if r.p is None:
                    r.p = Extra()
                j = i - 1
                while j >= 0:
                    if _i32(ax_l[j]) <= rs + ez.max_t:
                        break
                    j -= 1
                dropped = True
                if j < 0:
                    j = 0
                r.p.dp_score += ez.max
                re1 = rs + (ez.max_t + 1)
                qe1 = qs + (ez.max_q + 1)
                if cnt1 - (j + 1) >= opt.min_cnt:
                    r2 = split_reg(r, as1 + j + 1 - r.as_, qlen, a)
                    if r2 is not None and zdrop_code == 2:
                        r2.split_inv = True
                break
            else:
                r.p.dp_score += ez.score
            rs, qs = re, qe
        i += 1

    if not dropped and qe < qe0 and re < re0:  # right extension
        qseq = qseq0[rev][qe:qe0]
        tseq = mi.getseq_fast(rid, re, re0)
        junc = _get_junc(mi, rid, re, re0)
        ez = align_pair(opt, qseq, tseq, junc, mat, bw, opt.end_bonus,
                        opt.zdrop, extra_flag | K.KSW_EZ_EXTZ_ONLY)
        if ez.n_cigar > 0:
            append_cigar(r, ez.cigar)
            r.p.dp_score += ez.max
        re1 = re + (ez.mqe_t + 1 if ez.reach_end else ez.max_t + 1)
        qe1 = qe + (qe0 - qe if ez.reach_end else ez.max_q + 1)
    assert qe1 <= qlen

    r.rs, r.re = rs1, re1
    if rev:
        r.qs, r.qe = qlen - qe1, qlen - qs1
    else:
        r.qs, r.qe = qs1, qe1

    assert re1 - rs1 <= re0 - rs0
    if r.p:
        tseq = mi.getseq_fast(rid, rs1, re1)
        update_extra(r, qseq0[int(r.rev)][qs1:], tseq, mat, opt.q, opt.e,
                     bool(opt.flag & MM_F_EQX))
        if rev and r.p.trans_strand:
            r.p.trans_strand ^= 3
    return r2


def align1_inv(opt: MapOptions, mi, qlen: int, qseq0, r1: Region,
               r2: Region) -> Optional[Region]:
    """mm_align1_inv (align.c:797-852)."""
    if not (r1.split & 1) or not (r2.split & 2):
        return None
    if r1.id != r1.parent and r1.parent != MM_PARENT_TMP_PRI:
        return None
    if r2.id != r2.parent and r2.parent != MM_PARENT_TMP_PRI:
        return None
    if r1.rid != r2.rid or r1.rev != r2.rev:
        return None
    ql = r1.qs - r2.qe if r1.rev else r2.qs - r1.qe
    tl = r2.rs - r1.re
    if ql < opt.min_chain_score or ql > opt.max_gap:
        return None
    if tl < opt.min_chain_score or tl > opt.max_gap:
        return None

    mat = K.gen_simple_mat(opt.a, opt.b, opt.sc_ambi)
    tseq = mi.getseq_fast(r1.rid, r1.re, r2.rs)
    if r1.rev:
        qseq = qseq0[0][r2.qe: r2.qe + ql]
    else:
        qseq = qseq0[1][qlen - r2.qs: qlen - r2.qs + ql]

    qrev = qseq[::-1]
    trev = tseq[::-1]
    score, q_off, t_off = _ksw_ll(ql, qrev, tl, trev, mat, opt.q, opt.e)
    if score < opt.min_dp_max:
        return None
    q_off = ql - (q_off + 1)
    t_off = tl - (t_off + 1)
    ez = align_pair(opt, qseq[q_off:], tseq[t_off:], None, mat,
                    int(opt.bw * 1.5), -1, opt.zdrop, K.KSW_EZ_EXTZ_ONLY)
    if ez.n_cigar == 0:
        return None
    r_inv = Region()
    append_cigar(r_inv, ez.cigar)
    r_inv.p.dp_score = ez.max
    r_inv.id = -1
    r_inv.parent = MM_PARENT_UNSET
    r_inv.inv = True
    r_inv.rev = not r1.rev
    r_inv.rid = r1.rid
    r_inv.div = -1.0
    if not r_inv.rev:
        r_inv.qs = r2.qe + q_off
        r_inv.qe = r_inv.qs + ez.max_q + 1
    else:
        r_inv.qe = r2.qs - q_off
        r_inv.qs = r_inv.qe - (ez.max_q + 1)
    r_inv.rs = r1.re + t_off
    r_inv.re = r_inv.rs + ez.max_t + 1
    update_extra(r_inv, qseq[q_off:], tseq[t_off:], mat, opt.q, opt.e,
                 bool(opt.flag & MM_F_EQX))
    return r_inv


def align_skeleton(mi, opt: MapOptions, qlen: int, qstr: str,
                   regs: List[Region], a: np.ndarray) -> List[Region]:
    """mm_align_skeleton (align.c:864-920)."""
    import copy
    from ..index.sketch import encode_nt4
    fwd = encode_nt4(qstr)
    rc = np.where(fwd[::-1] < 4, 3 - fwd[::-1], 4).astype(np.uint8)
    qseq0 = [fwd, rc]

    n_a = squeeze_a(regs, a)
    out: List[Region] = list(regs)
    i = 0
    while i < len(out):
        r = out[i]
        if (opt.flag & MM_F_SPLICE) and (opt.flag & MM_F_SPLICE_FOR) and \
                (opt.flag & MM_F_SPLICE_REV):
            s = [copy.copy(r), copy.copy(r)]
            s2 = [align1(opt, mi, qlen, qseq0, s[0], n_a, a, MM_F_SPLICE_FOR),
                  align1(opt, mi, qlen, qseq0, s[1], n_a, a, MM_F_SPLICE_REV)]
            if s[0].p.dp_score > s[1].p.dp_score:
                which, trans_strand = 0, 1
            elif s[0].p.dp_score < s[1].p.dp_score:
                which, trans_strand = 1, 2
            else:
                trans_strand = 3
                which = (qlen + s[0].p.dp_score) & 1
            out[i] = s[which]
            r2 = s2[which]
            out[i].p.trans_strand = trans_strand
        else:
            r2 = align1(opt, mi, qlen, qseq0, r, n_a, a, opt.flag)
            if opt.flag & MM_F_SPLICE:
                out[i].p.trans_strand = 1 if opt.flag & MM_F_SPLICE_FOR else 2
        if r2 is not None and r2.cnt > 0:
            out.insert(i + 1, r2)
        if i > 0 and out[i].split_inv:
            r_inv = align1_inv(opt, mi, qlen, qseq0, out[i - 1], out[i])
            if r_inv is not None:
                out.insert(i, r_inv)
                i += 1
        i += 1
    out = filter_regs(out, opt, qlen)
    out = hit_sort(out, opt.alt_drop)
    return out
