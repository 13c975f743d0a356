"""Chain -> region conversion, primary/secondary selection, long-join and
mapQ (reference: hit.c). Float arithmetic is float32 wherever the C code
uses float, so selection decisions and mapQ values match bit-exactly.

The port's copy of `mm2tpu/mapping/hit.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils import profiling
from ..utils.hashing import hash64
from ..options import (MapOptions,
                       MM_SEED_LONG_JOIN, MM_F_ALL_CHAINS, MM_F_SPLICE,
                       MM_F_SR, MM_F_NO_LJOIN, MM_F_HARD_MLEVEL)

MM_PARENT_UNSET = -1
MM_PARENT_TMP_PRI = -2

f32 = np.float32


@dataclass
class Extra:
    """mm_extra_t (minimap.h:77-83)."""
    dp_score: int = 0
    dp_max: int = 0
    dp_max2: int = 0
    n_ambi: int = 0
    trans_strand: int = 0
    cigar: List[int] = field(default_factory=list)  # len<<4|op packed

    @property
    def n_cigar(self) -> int:
        return len(self.cigar)


@dataclass
class Region:
    """mm_reg1_t (minimap.h:85-100)."""
    id: int = 0
    cnt: int = 0
    rid: int = 0
    score: int = 0
    qs: int = 0
    qe: int = 0
    rs: int = 0
    re: int = 0
    parent: int = MM_PARENT_UNSET
    subsc: int = 0
    as_: int = 0
    mlen: int = 0
    blen: int = 0
    n_sub: int = 0
    score0: int = 0
    mapq: int = 0
    split: int = 0
    rev: bool = False
    inv: bool = False
    sam_pri: bool = False
    proper_frag: bool = False
    pe_thru: bool = False
    seg_split: bool = False
    seg_id: int = 0
    split_inv: bool = False
    is_alt: bool = False
    hash: int = 0
    div: float = -1.0
    p: Optional[Extra] = None


def _cal_fuzzy_len(r: Region, a: np.ndarray) -> None:
    """hit.c:8-21 (vectorized over the chain's anchors)."""
    r.mlen = r.blen = 0
    if r.cnt <= 0:
        return
    if r.cnt < 24:  # short chains (sr): scalar beats numpy overhead
        ax, ay = int(a[r.as_, 0]), int(a[r.as_, 1])
        r.mlen = r.blen = (ay >> 32) & 0xFF
        for i in range(r.as_ + 1, r.as_ + r.cnt):
            bx, by = int(a[i, 0]), int(a[i, 1])
            sp = (by >> 32) & 0xFF
            tl = _i32(bx) - _i32(ax)
            ql = _i32(by) - _i32(ay)
            r.blen += tl if tl > ql else ql
            r.mlen += sp if (tl > sp and ql > sp) else min(tl, ql)
            ax, ay = bx, by
        return
    seg = a[r.as_:r.as_ + r.cnt]
    spans = ((seg[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    r.mlen = r.blen = int(spans[0])
    if r.cnt == 1:
        return
    xi = _i32v(seg[:, 0])
    yi = _i32v(seg[:, 1])
    tl = np.diff(xi)
    ql = np.diff(yi)
    sp = spans[1:]
    r.blen += int(np.sum(np.maximum(tl, ql)))
    r.mlen += int(np.sum(np.where((tl > sp) & (ql > sp), sp,
                                  np.minimum(tl, ql))))


def _i32(v) -> int:
    """(int32_t)v on a uint64."""
    v = int(v) & 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def _i32v(col: np.ndarray) -> np.ndarray:
    """(int32_t) of each uint64 element, as int64."""
    x = (col & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return x - ((x >> 31) << 32)


def reg_set_coor(r: Region, qlen: int, a: np.ndarray) -> None:
    """hit.c:23-38."""
    k = r.as_
    q_span = int((a[k, 1] >> np.uint64(32)) & np.uint64(0xFF))
    r.rev = bool(int(a[k, 0]) >> 63)
    r.rid = (int(a[k, 0]) << 1 >> 33) & 0x7FFFFFFF
    rs = _i32(a[k, 0]) + 1 - q_span
    r.rs = rs if _i32(a[k, 0]) + 1 > q_span else 0
    r.re = _i32(a[k + r.cnt - 1, 0]) + 1
    if not r.rev:
        r.qs = _i32(a[k, 1]) + 1 - q_span
        r.qe = _i32(a[k + r.cnt - 1, 1]) + 1
    else:
        r.qs = qlen - (_i32(a[k + r.cnt - 1, 1]) + 1)
        r.qe = qlen - (_i32(a[k, 1]) + 1 - q_span)
    _cal_fuzzy_len(r, a)


def gen_regs(hash_: int, qlen: int, u: np.ndarray, a: np.ndarray) -> List[Region]:
    """mm_gen_regs (hit.c:52-88): chains -> regions sorted by tie-broken score."""
    n_u = len(u)
    if n_u == 0:
        return []
    try:
        from ..native import lib as native_lib
        native = native_lib.has_backtrack()
    except ImportError:
        native = False
    if native:
        (score, hash_out, cnt, as_, rev, rid, rs, re, qs, qe, mlen,
         blen) = native_lib.gen_regs_arrays(u, a, hash_, qlen)
        regs = []
        for i in range(n_u):
            r = Region()
            r.id = i
            r.parent = MM_PARENT_UNSET
            r.score = r.score0 = int(score[i])
            r.hash = int(hash_out[i])
            r.cnt = int(cnt[i])
            r.as_ = int(as_[i])
            r.div = -1.0
            r.rev = bool(rev[i])
            r.rid = int(rid[i])
            r.rs, r.re = int(rs[i]), int(re[i])
            r.qs, r.qe = int(qs[i]), int(qe[i])
            r.mlen, r.blen = int(mlen[i]), int(blen[i])
            regs.append(r)
        return regs
    z = np.empty((n_u, 2), dtype=np.uint64)
    k = 0
    for i in range(n_u):
        h = hash64((hash64(int(a[k, 0])) + hash64(int(a[k, 1]))) ^ hash_) & 0xFFFFFFFF
        z[i, 0] = np.uint64(int(u[i]) ^ h)
        z[i, 1] = np.uint64(k << 32 | (int(u[i]) & 0xFFFFFFFF))
        k += int(u[i]) & 0xFFFFFFFF
    order = np.argsort(z[:, 0], kind="stable")[::-1]
    regs = []
    for i, oi in enumerate(order):
        r = Region()
        r.id = i
        r.parent = MM_PARENT_UNSET
        r.score = r.score0 = int(z[oi, 0] >> np.uint64(32))
        r.hash = int(z[oi, 0] & np.uint64(0xFFFFFFFF))
        r.cnt = int(z[oi, 1] & np.uint64(0xFFFFFFFF))
        r.as_ = int(z[oi, 1] >> np.uint64(32))
        r.div = -1.0
        reg_set_coor(r, qlen, a)
        regs.append(r)
    return regs


def gen_regs_chain_post_fast(hash_: int, qlen: int, u: np.ndarray,
                             a: np.ndarray, opt, min_diff: int):
    """Fused native gen_regs + pre-align set_parent/select_sub/sync:
    Region objects are built only for the ~best_n survivors (the 500+
    repeat-dense candidate regions never materialize in Python).
    Caller guarantees: single segment, no ALT contigs, not ALL_CHAINS,
    regions carry no alignment Extra yet. Returns a reg list or None when
    the native runtime is unavailable, counted as `fallback.gen_regs_fast`
    (the caller then runs the Python path); the two native calls' time
    is `post.native`."""
    try:
        from ..native import lib as native_lib
        if not native_lib.has_set_parent():
            profiling.count("fallback.gen_regs_fast")
            return None
    except ImportError:
        profiling.count("fallback.gen_regs_fast")
        return None
    n_u = len(u)
    if n_u == 0:
        return []
    (score, hash_out, cnt, as_, rev, rid, rs, re, qs, qe, mlen,
     blen) = profiling.timed("post.native", native_lib.gen_regs_arrays,
                             u, a, hash_, qlen)
    keep, parent, n_sub, subsc, sam_pri = profiling.timed(
        "post.native", native_lib.set_parent_select,
        score, qs, qe, cnt, rid, rs, re, float(opt.mask_level),
        opt.mask_len, opt.a * 2 + opt.b,
        bool(opt.flag & MM_F_HARD_MLEVEL), float(opt.pri_ratio),
        min_diff, opt.best_n)
    shrunk = len(keep) != n_u
    regs = []
    for o in range(len(keep)):
        i = int(keep[o])
        r = Region()
        r.id = o
        r.parent = int(parent[o])
        r.score = r.score0 = int(score[i])
        r.hash = int(hash_out[i])
        r.cnt = int(cnt[i])
        r.as_ = int(as_[i])
        r.div = -1.0
        r.rev = bool(rev[i])
        r.rid = int(rid[i])
        r.rs, r.re = int(rs[i]), int(re[i])
        r.qs, r.qe = int(qs[i]), int(qe[i])
        r.mlen, r.blen = int(mlen[i]), int(blen[i])
        r.n_sub = int(n_sub[o])
        r.subsc = int(subsc[o])
        # the Python path only assigns sam_pri via sync_regs, which runs
        # only when select_sub dropped something
        r.sam_pri = bool(sam_pri[o]) if shrunk else False
        regs.append(r)
    return regs


def mark_alt(mi, regs: List[Region]) -> None:
    if mi.n_alt == 0:
        return
    for r in regs:
        if mi.seq[r.rid].is_alt:
            r.is_alt = True


def _alt_score(score: int, alt_diff_frac: float) -> int:
    if score < 0:
        return score
    score = int(score * (1.0 - alt_diff_frac) + 0.499)
    return score if score > 0 else 1


def set_parent(regs: List[Region], mask_level: float, mask_len: int,
               sub_diff: int, hard_mask_level: bool, alt_diff_frac: float) -> None:
    """mm_set_parent (hit.c:125-186)."""
    n = len(regs)
    if n <= 0:
        return
    for i, r in enumerate(regs):
        r.id = i
    w = [0]
    regs[0].parent = 0
    k = 1
    for i in range(1, n):
        ri = regs[i]
        si, ei = ri.qs, ri.qe
        uncov_len = 0
        if not hard_mask_level:
            cov = []
            for j in range(k):
                rp = regs[w[j]]
                sj, ej = rp.qs, rp.qe
                if ej <= si or sj >= ei:
                    continue
                cov.append((max(sj, si) << 32) | min(ej, ei))
            if cov:
                cov.sort()
                x = si
                for cj in cov:
                    cs, ce = cj >> 32, cj & 0xFFFFFFFF
                    if cs > x:
                        uncov_len += cs - x
                    x = max(ce, x)
                if ei > x:
                    uncov_len += ei - x
            else:
                w.append(i)
                ri.parent = i
                ri.n_sub = 0
                k += 1
                continue
        found = False
        for j in range(k):
            rp = regs[w[j]]
            sj, ej = rp.qs, rp.qe
            if ej <= si or sj >= ei:
                continue
            mn = min(ej - sj, ei - si)
            mx = max(ej - sj, ei - si)
            if si < sj:
                ol = 0 if ei < sj else (ei - sj if ei < ej else ej - sj)
            else:
                ol = 0 if ej < si else (ej - si if ej < ei else ei - si)
            if (f32(ol) / f32(mn) - f32(uncov_len) / f32(mx) > f32(mask_level)
                    and uncov_len <= mask_len):
                ri.parent = rp.parent
                sci = ri.score
                if not rp.is_alt and ri.is_alt:
                    sci = _alt_score(sci, alt_diff_frac)
                rp.subsc = max(rp.subsc, sci)
                cnt_sub = 1 if ri.cnt >= rp.cnt else 0
                if (rp.p and ri.p and (rp.rid != ri.rid or rp.rs != ri.rs or
                                       rp.re != ri.re or ol != mn)):
                    sci = ri.p.dp_max
                    if not rp.is_alt and ri.is_alt:
                        sci = _alt_score(sci, alt_diff_frac)
                    rp.p.dp_max2 = max(rp.p.dp_max2, sci)
                    if rp.p.dp_max - ri.p.dp_max <= sub_diff:
                        cnt_sub = 1
                if cnt_sub:
                    rp.n_sub += 1
                found = True
                break
        if not found:
            w.append(i)
            ri.parent = i
            ri.n_sub = 0
            k += 1


def set_sam_pri(regs: List[Region]) -> int:
    n_pri = 0
    for r in regs:
        if r.id == r.parent:
            n_pri += 1
            r.sam_pri = n_pri == 1
        else:
            r.sam_pri = False
    return n_pri


def sync_regs(regs: List[Region]) -> None:
    """mm_sync_regs (hit.c:231-253)."""
    if not regs:
        return
    tmp = {}
    for i, r in enumerate(regs):
        if r.id >= 0:
            tmp[r.id] = i
    for i, r in enumerate(regs):
        old_parent = r.parent
        r.id = i
        if old_parent == MM_PARENT_TMP_PRI:
            r.parent = i
        elif old_parent >= 0 and old_parent in tmp:
            r.parent = tmp[old_parent]
        else:
            r.parent = MM_PARENT_UNSET
    set_sam_pri(regs)


def select_sub(regs: List[Region], pri_ratio: float, min_diff: int,
               best_n: int) -> List[Region]:
    """mm_select_sub (hit.c:255-272)."""
    if pri_ratio > 0.0 and len(regs) > 0:
        out = []
        n_2nd = 0
        for i, r in enumerate(regs):
            p = r.parent
            if p == i or r.inv:
                out.append(r)
            elif (f32(r.score) >= f32(regs[p].score) * f32(pri_ratio)
                  or r.score + min_diff >= regs[p].score) and n_2nd < best_n:
                if not (r.qs == regs[p].qs and r.qe == regs[p].qe and
                        r.rid == regs[p].rid and r.rs == regs[p].rs and
                        r.re == regs[p].re):
                    out.append(r)
                    n_2nd += 1
        if len(out) != len(regs):
            sync_regs(out)
        return out
    return regs


def filter_regs(regs: List[Region], opt: MapOptions, qlen: int) -> List[Region]:
    """mm_filter_regs (hit.c:274-293)."""
    out = []
    for r in regs:
        flt = False
        if not r.inv and not r.seg_split and r.cnt < opt.min_cnt:
            flt = True
        if r.p:
            if r.mlen < opt.min_chain_score:
                flt = True
            elif r.p.dp_max < opt.min_dp_max:
                flt = True
            elif (f32(r.qs) > f32(qlen) * f32(opt.max_clip_ratio) and
                  f32(qlen - r.qe) > f32(qlen) * f32(opt.max_clip_ratio)):
                flt = True
        if not flt:
            out.append(r)
    return out


def squeeze_a(regs: List[Region], a: np.ndarray) -> int:
    """mm_squeeze_a (hit.c:295-313): compact a[] runs referenced by regs."""
    aux = sorted(range(len(regs)), key=lambda i: (regs[i].as_, i))
    as_ = 0
    for i in aux:
        r = regs[i]
        if r.as_ != as_:
            a[as_: as_ + r.cnt] = a[r.as_: r.as_ + r.cnt]
            r.as_ = as_
        as_ += r.cnt
    return as_


def join_long(regs: List[Region], opt: MapOptions, qlen: int,
              a: np.ndarray) -> List[Region]:
    """mm_join_long (hit.c:315-371)."""
    if len(regs) < 2:
        return regs
    squeeze_a(regs, a)
    aux = sorted((i for i, r in enumerate(regs)
                  if r.parent == i or r.parent < 0),
                 key=lambda i: (regs[i].as_, i))
    n_drop = 0
    for t in range(len(aux) - 1, 0, -1):
        r0, r1 = regs[aux[t - 1]], regs[aux[t]]
        if r0.as_ + r0.cnt != r1.as_:
            continue
        if r0.rid != r1.rid or r0.rev != r1.rev:
            continue
        a0e = a[r0.as_ + r0.cnt - 1]
        a1s = a[r1.as_]
        if int(a1s[0]) <= int(a0e[0]) or _i32(a1s[1]) <= _i32(a0e[1]):
            continue
        g = _i32(a1s[1]) - _i32(a0e[1])
        rg = int(a1s[0]) - int(a0e[0])
        max_gap = max(g, rg)
        min_gap = min(g, rg)
        if max_gap > opt.max_join_long or min_gap > opt.max_join_short:
            continue
        sc_thres = int(float(f32(f32(opt.min_join_flank_sc) / f32(opt.max_join_long))
                             * f32(max_gap)) + 0.499)
        if r0.score < sc_thres or r1.score < sc_thres:
            continue
        min_flank_len = int(max_gap * opt.min_join_flank_ratio)
        if r0.re - r0.rs < min_flank_len or r0.qe - r0.qs < min_flank_len:
            continue
        if r1.re - r1.rs < min_flank_len or r1.qe - r1.qs < min_flank_len:
            continue
        a[r1.as_, 1] |= np.uint64(MM_SEED_LONG_JOIN)
        r0.cnt += r1.cnt
        r0.score += r1.score
        reg_set_coor(r0, qlen, a)
        r1.cnt = 0
        r1.parent = r0.id
        n_drop += 1
    if n_drop > 0:
        for r in regs:
            if r.parent >= 0 and r.id != r.parent:
                pp = regs[r.parent].parent
                if pp >= 0 and pp != r.parent:
                    r.parent = pp
        regs = filter_regs(regs, opt, qlen)
        sync_regs(regs)
    return regs


def hit_sort(regs: List[Region], alt_diff_frac: float) -> List[Region]:
    """mm_hit_sort (hit.c:188-218)."""
    if len(regs) <= 1:
        return regs
    aux = []
    for i, r in enumerate(regs):
        if r.inv or r.cnt > 0:
            score = r.p.dp_max if r.p else r.score
            if r.is_alt:
                score = _alt_score(score, alt_diff_frac)
            aux.append(((score << 32) | r.hash, i))
    aux.sort(key=lambda t: t[0])
    return [regs[i] for _, i in reversed(aux)]


def chain_post(regs: List[Region], opt: MapOptions, max_chain_gap_ref: int,
               mi, qlen: int, n_segs: int, qlens, a: np.ndarray) -> List[Region]:
    """chain_post (map.c:249-258)."""
    if not (opt.flag & MM_F_ALL_CHAINS):
        set_parent(regs, opt.mask_level, opt.mask_len, opt.a * 2 + opt.b,
                   bool(opt.flag & MM_F_HARD_MLEVEL), opt.alt_drop)
        if n_segs <= 1:
            regs = select_sub(regs, opt.pri_ratio, mi.k * 2, opt.best_n)
        else:
            from .pe import select_sub_multi
            regs = select_sub_multi(regs, opt.pri_ratio, 0.2, 0.7,
                                    max_chain_gap_ref, mi.k * 2, opt.best_n,
                                    n_segs, qlens)
        if not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_NO_LJOIN)):
            regs = join_long(regs, opt, qlen, a)
    return regs


def chain_post_tail(regs: List[Region], opt: MapOptions, qlen: int,
                    a: np.ndarray) -> List[Region]:
    """The long-join tail of chain_post (map.c:256-257), for callers that
    did set_parent/select_sub through the native fast path."""
    if not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_NO_LJOIN)):
        regs = join_long(regs, opt, qlen, a)
    return regs


def _logf(x: float) -> float:
    """float32-rounded natural log (C logf)."""
    return float(f32(math.log(float(x))))


def set_mapq(regs: List[Region], min_chain_sc: int, match_sc: int,
             rep_len: int, is_sr: bool) -> None:
    """mm_set_mapq (hit.c:463-508). float32 arithmetic throughout."""
    if not regs:
        return
    q_coef = f32(40.0)
    sum_sc = 0
    for r in regs:
        if r.parent == r.id:
            sum_sc += r.score
    with np.errstate(invalid="ignore"):  # 0/0 -> NaN, as in the C float math
        uniq_ratio = f32(sum_sc) / f32(sum_sc + rep_len)
    for r in regs:
        if r.inv:
            r.mapq = 0
        elif r.parent == r.id:
            pen_s1 = (f32(1.0) if r.score > 100 else f32(0.01) * f32(r.score)) * uniq_ratio
            pen_cm = f32(1.0) if r.cnt > 10 else f32(0.1) * f32(r.cnt)
            pen_cm = pen_s1 if pen_s1 < pen_cm else pen_cm
            subsc = max(r.subsc, min_chain_sc)
            if r.p and r.p.dp_max2 > 0 and r.p.dp_max > 0:
                identity = f32(r.mlen) / f32(r.blen)
                x = f32(r.p.dp_max2) * f32(subsc) / f32(r.p.dp_max) / f32(r.score0)
                mapq = int(identity * pen_cm * q_coef * (f32(1.0) - x * x) *
                           f32(_logf(f32(r.p.dp_max) / f32(match_sc))))
                if not is_sr:
                    mapq_alt = int(f32(6.02) * identity * identity *
                                   f32(r.p.dp_max - r.p.dp_max2) / f32(match_sc) + f32(0.499))
                    mapq = min(mapq, mapq_alt)
            else:
                x = f32(subsc) / f32(r.score0)
                if r.p:
                    identity = f32(r.mlen) / f32(r.blen)
                    mapq = int(identity * pen_cm * q_coef * (f32(1.0) - x) *
                               f32(_logf(f32(r.p.dp_max) / f32(match_sc))))
                else:
                    mapq = int(pen_cm * q_coef * (f32(1.0) - x) * f32(_logf(r.score)))
            mapq -= int(f32(4.343) * f32(_logf(r.n_sub + 1)) + f32(0.499))
            mapq = max(mapq, 0)
            r.mapq = min(mapq, 60)
            if r.p and r.p.dp_max > r.p.dp_max2 and r.mapq == 0:
                r.mapq = 1
        else:
            r.mapq = 0
    _set_inv_mapq(regs)


def _set_inv_mapq(regs: List[Region]) -> None:
    """hit.c:437-461."""
    if len(regs) < 3 or not any(r.inv for r in regs):
        return
    aux = sorted(((r.rid << 32 | r.rs, i) for i, r in enumerate(regs)
                  if r.parent == i or r.parent < 0))
    for t in range(1, len(aux) - 1):
        inv = regs[aux[t][1]]
        if inv.inv:
            l, r_ = regs[aux[t - 1][1]], regs[aux[t + 1][1]]
            inv.mapq = min(l.mapq, r_.mapq)


def split_reg(r: Region, n: int, qlen: int, a: np.ndarray) -> Optional[Region]:
    """mm_split_reg (hit.c:106-123)."""
    if n <= 0 or n >= r.cnt:
        return None
    import copy
    r2 = copy.copy(r)
    r2.id = -1
    r2.sam_pri = False
    r2.p = None
    r2.split_inv = False
    r2.cnt = r.cnt - n
    # the C multiply is float32 x float32 (score converted first); numpy's
    # int-scalar path rounds differently on ~1-ulp cases (hit.c:115)
    r2.score = int(float(f32(f32(r.score) * (f32(r2.cnt) / f32(r.cnt))))
                   + 0.499)
    r2.as_ = r.as_ + n
    if r.parent == r.id:
        r2.parent = MM_PARENT_TMP_PRI
    reg_set_coor(r2, qlen, a)
    r.cnt -= r2.cnt
    r.score -= r2.score
    reg_set_coor(r, qlen, a)
    r.split |= 1
    r2.split |= 2
    return r2
