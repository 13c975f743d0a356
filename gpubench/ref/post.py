"""The reference's post-chain: chains to regions, primary and secondary
selection, the long join, the divergence estimate, mapping quality and
the PAF line of a region without an alignment, as minimap2 v2.18 (hit.c,
esterr.c, format.c, map.c:249-258, 290-292).

Frozen copies of the plain Python paths of `mm2tpu_torch/mapping/hit.py`
(`gen_regs`, `reg_set_coor`, `_cal_fuzzy_len`, `set_parent`,
`sync_regs`, `select_sub`, `filter_regs`, `squeeze_a`, `join_long`,
`set_mapq`), `mapping/esterr.py::est_err_py`, `utils/hashing.py`'s
`reg_hash`, and `io/format.py`'s `write_paf` and `write_tags`, cut to one
query segment with no ALT contigs and no alignment (`Region.p` is never
set). float arithmetic is float32 where the C code uses float, so every
selection and mapping quality matches exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .sketch import hash64

f32 = np.float32
MM_PARENT_UNSET = -1
MM_PARENT_TMP_PRI = -2
MM_SEED_LONG_JOIN = 1 << 40


@dataclass
class Region:
    """The fields of mm_reg1_t (minimap.h:85-100) that a region without
    an alignment uses."""
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
    rev: bool = False
    sam_pri: bool = False
    hash: int = 0
    div: float = -1.0


# ---- hashing (map.c:290-292, khash.h) ---------------------------------


def _wang_hash32(key: int) -> int:
    M = 0xFFFFFFFF
    key = (key + (~(key << 15) & M)) & M
    key ^= key >> 10
    key = (key + (key << 3)) & M
    key ^= key >> 6
    key = (key + (~(key << 11) & M)) & M
    key ^= key >> 16
    return key


def reg_hash(qname: str, qlen: int, seed: int) -> int:
    """The read's tie-breaking hash."""
    h = 0
    for c in qname.encode():
        h = ((h << 5) - h + c) & 0xFFFFFFFF
    h ^= (_wang_hash32(qlen) + _wang_hash32(seed)) & 0xFFFFFFFF
    return _wang_hash32(h & 0xFFFFFFFF)


# ---- regions (hit.c) --------------------------------------------------


def _i32(v) -> int:
    v = int(v) & 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def _i32v(col: np.ndarray) -> np.ndarray:
    x = (col & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return x - ((x >> 31) << 32)


def _cal_fuzzy_len(r: Region, a: np.ndarray) -> None:
    """hit.c:8-21."""
    r.mlen = r.blen = 0
    if r.cnt <= 0:
        return
    seg = a[r.as_:r.as_ + r.cnt]
    spans = ((seg[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    r.mlen = r.blen = int(spans[0])
    if r.cnt == 1:
        return
    tl = np.diff(_i32v(seg[:, 0]))
    ql = np.diff(_i32v(seg[:, 1]))
    sp = spans[1:]
    r.blen += int(np.sum(np.maximum(tl, ql)))
    r.mlen += int(np.sum(np.where((tl > sp) & (ql > sp), sp,
                                  np.minimum(tl, ql))))


def reg_set_coor(r: Region, qlen: int, a: np.ndarray) -> None:
    """hit.c:23-38."""
    k = r.as_
    q_span = int((a[k, 1] >> np.uint64(32)) & np.uint64(0xFF))
    r.rev = bool(int(a[k, 0]) >> 63)
    r.rid = (int(a[k, 0]) << 1 >> 33) & 0x7FFFFFFF
    r.rs = _i32(a[k, 0]) + 1 - q_span if _i32(a[k, 0]) + 1 > q_span else 0
    r.re = _i32(a[k + r.cnt - 1, 0]) + 1
    if not r.rev:
        r.qs = _i32(a[k, 1]) + 1 - q_span
        r.qe = _i32(a[k + r.cnt - 1, 1]) + 1
    else:
        r.qs = qlen - (_i32(a[k + r.cnt - 1, 1]) + 1)
        r.qe = qlen - (_i32(a[k, 1]) + 1 - q_span)
    _cal_fuzzy_len(r, a)


def gen_regs(hash_: int, qlen: int, u: np.ndarray,
             a: np.ndarray) -> List[Region]:
    """mm_gen_regs (hit.c:52-88): chains to regions, sorted by score with
    the hash breaking ties."""
    z = np.empty((len(u), 2), dtype=np.uint64)
    k = 0
    for i in range(len(u)):
        h = hash64((hash64(int(a[k, 0])) + hash64(int(a[k, 1]))) ^ hash_) \
            & 0xFFFFFFFF
        z[i, 0] = np.uint64(int(u[i]) ^ h)
        z[i, 1] = np.uint64(k << 32 | (int(u[i]) & 0xFFFFFFFF))
        k += int(u[i]) & 0xFFFFFFFF
    regs = []
    for i, oi in enumerate(np.argsort(z[:, 0], kind="stable")[::-1]):
        r = Region(id=i)
        r.score = r.score0 = int(z[oi, 0] >> np.uint64(32))
        r.hash = int(z[oi, 0] & np.uint64(0xFFFFFFFF))
        r.cnt = int(z[oi, 1] & np.uint64(0xFFFFFFFF))
        r.as_ = int(z[oi, 1] >> np.uint64(32))
        reg_set_coor(r, qlen, a)
        regs.append(r)
    return regs


def set_parent(regs: List[Region], mask_level: float, mask_len: int) -> None:
    """mm_set_parent (hit.c:125-186), soft mask level, no ALT contigs,
    no alignments."""
    if not regs:
        return
    for i, r in enumerate(regs):
        r.id = i
    w = [0]
    regs[0].parent = 0
    for i in range(1, len(regs)):
        ri = regs[i]
        si, ei = ri.qs, ri.qe
        cov = sorted((max(regs[j].qs, si) << 32) | min(regs[j].qe, ei)
                     for j in w if not (regs[j].qe <= si or regs[j].qs >= ei))
        if not cov:
            w.append(i)
            ri.parent = i
            ri.n_sub = 0
            continue
        uncov_len, x = 0, si
        for cj in cov:
            cs, ce = cj >> 32, cj & 0xFFFFFFFF
            if cs > x:
                uncov_len += cs - x
            x = max(ce, x)
        if ei > x:
            uncov_len += ei - x
        for j in w:
            rp = regs[j]
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
                rp.subsc = max(rp.subsc, ri.score)
                if ri.cnt >= rp.cnt:
                    rp.n_sub += 1
                break
        else:
            w.append(i)
            ri.parent = i
            ri.n_sub = 0


def _sync_regs(regs: List[Region]) -> None:
    """mm_sync_regs (hit.c:231-253)."""
    tmp = {r.id: i for i, r in enumerate(regs) if r.id >= 0}
    for i, r in enumerate(regs):
        old = r.parent
        r.id = i
        if old == MM_PARENT_TMP_PRI:
            r.parent = i
        elif old >= 0 and old in tmp:
            r.parent = tmp[old]
        else:
            r.parent = MM_PARENT_UNSET
    n_pri = 0
    for r in regs:
        n_pri += r.id == r.parent
        r.sam_pri = r.id == r.parent and n_pri == 1


def select_sub(regs: List[Region], pri_ratio: float, min_diff: int,
               best_n: int) -> List[Region]:
    """mm_select_sub (hit.c:255-272)."""
    if not (pri_ratio > 0.0 and regs):
        return regs
    out, n_2nd = [], 0
    for i, r in enumerate(regs):
        p = r.parent
        if p == i:
            out.append(r)
        elif (f32(r.score) >= f32(regs[p].score) * f32(pri_ratio)
              or r.score + min_diff >= regs[p].score) and n_2nd < best_n:
            if not (r.qs == regs[p].qs and r.qe == regs[p].qe and
                    r.rid == regs[p].rid and r.rs == regs[p].rs and
                    r.re == regs[p].re):
                out.append(r)
                n_2nd += 1
    if len(out) != len(regs):
        _sync_regs(out)
    return out


def _squeeze_a(regs: List[Region], a: np.ndarray) -> None:
    """mm_squeeze_a (hit.c:295-313)."""
    as_ = 0
    for i in sorted(range(len(regs)), key=lambda i: (regs[i].as_, i)):
        r = regs[i]
        if r.as_ != as_:
            a[as_: as_ + r.cnt] = a[r.as_: r.as_ + r.cnt]
            r.as_ = as_
        as_ += r.cnt


def join_long(regs: List[Region], o: "PostOpt", qlen: int,
              a: np.ndarray) -> List[Region]:
    """mm_join_long (hit.c:315-371); `a` is changed in place."""
    if len(regs) < 2:
        return regs
    _squeeze_a(regs, a)
    aux = sorted((i for i, r in enumerate(regs)
                  if r.parent == i or r.parent < 0),
                 key=lambda i: (regs[i].as_, i))
    n_drop = 0
    for t in range(len(aux) - 1, 0, -1):
        r0, r1 = regs[aux[t - 1]], regs[aux[t]]
        if r0.as_ + r0.cnt != r1.as_ or r0.rid != r1.rid or r0.rev != r1.rev:
            continue
        a0e, a1s = a[r0.as_ + r0.cnt - 1], a[r1.as_]
        if int(a1s[0]) <= int(a0e[0]) or _i32(a1s[1]) <= _i32(a0e[1]):
            continue
        g = _i32(a1s[1]) - _i32(a0e[1])
        rg = int(a1s[0]) - int(a0e[0])
        max_gap, min_gap = max(g, rg), min(g, rg)
        if max_gap > o.max_join_long or min_gap > o.max_join_short:
            continue
        sc_thres = int(float(f32(f32(o.min_join_flank_sc) /
                                 f32(o.max_join_long)) * f32(max_gap))
                       + 0.499)
        if r0.score < sc_thres or r1.score < sc_thres:
            continue
        min_flank_len = int(max_gap * o.min_join_flank_ratio)
        if (r0.re - r0.rs < min_flank_len or r0.qe - r0.qs < min_flank_len
                or r1.re - r1.rs < min_flank_len
                or r1.qe - r1.qs < min_flank_len):
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
        regs = [r for r in regs if r.cnt >= o.min_cnt]   # mm_filter_regs
        _sync_regs(regs)
    return regs


def _logf(x: float) -> float:
    return float(f32(math.log(float(x))))


def set_mapq(regs: List[Region], min_chain_sc: int, rep_len: int) -> None:
    """mm_set_mapq (hit.c:463-508) of regions without an alignment."""
    if not regs:
        return
    sum_sc = sum(r.score for r in regs if r.parent == r.id)
    with np.errstate(invalid="ignore"):
        uniq_ratio = f32(sum_sc) / f32(sum_sc + rep_len)
    for r in regs:
        if r.parent != r.id:
            r.mapq = 0
            continue
        pen_s1 = (f32(1.0) if r.score > 100 else
                  f32(0.01) * f32(r.score)) * uniq_ratio
        pen_cm = f32(1.0) if r.cnt > 10 else f32(0.1) * f32(r.cnt)
        pen_cm = pen_s1 if pen_s1 < pen_cm else pen_cm
        x = f32(max(r.subsc, min_chain_sc)) / f32(r.score0)
        mapq = int(pen_cm * f32(40.0) * (f32(1.0) - x) * f32(_logf(r.score)))
        mapq -= int(f32(4.343) * f32(_logf(r.n_sub + 1)) + f32(0.499))
        r.mapq = min(max(mapq, 0), 60)


# ---- divergence (esterr.c:30-64) --------------------------------------


def est_err(qlen: int, regs: List[Region], a: np.ndarray,
            mini_pos: np.ndarray, ref_lens: Sequence[int]) -> None:
    """Sets each region's `div` from the share of the query's minimizers
    that its chain matches."""
    n = len(mini_pos)
    if n == 0:
        return
    sum_k = int(np.sum((mini_pos >> np.uint64(32)) & np.uint64(0xFF)))
    avg_k = float(f32(sum_k) / f32(n))
    mp_low = (mini_pos & np.uint64(0xFFFFFFFF)).astype(np.int64)
    for r in regs:
        r.div = -1.0
        if r.cnt == 0:
            continue
        seg = a[r.as_:r.as_ + r.cnt]
        qx = [_qpos(qlen, row) for row in (seg[::-1] if r.rev else seg)]
        st = int(np.searchsorted(mp_low, qx[0]))
        if st >= n or mp_low[st] != qx[0]:
            continue
        en, n_match, k, j = st, 1, 1, st + 1
        while j < n and k < r.cnt:
            if qx[k] == int(mp_low[j]):
                k += 1
                en = j
                n_match += 1
            j += 1
        n_tot = en - st + 1
        if r.qs > avg_k and r.rs > avg_k:
            n_tot += 1
        if qlen - r.qs > avg_k and ref_lens[r.rid] - r.re > avg_k:
            n_tot += 1
        r.div = 0.0 if n_match >= n_tot else \
            float(f32(1.0 - pow(n_match / n_tot, 1.0 / avg_k)))


def _qpos(qlen: int, row) -> int:
    x = _i32(row[1])
    if int(row[0]) >> 63:
        x = qlen - 1 - (x + 1 - ((int(row[1]) >> 32) & 0xFF))
    return x


# ---- the whole of it, and its PAF -------------------------------------


@dataclass
class PostOpt:
    """The mapping options post-chain reads (the configuration's
    `reference`)."""
    k: int
    a: int
    seed: int
    mask_level: float
    mask_len: int
    pri_ratio: float
    best_n: int
    min_cnt: int
    min_chain_score: int
    max_join_long: int
    max_join_short: int
    min_join_flank_sc: int
    min_join_flank_ratio: float
    splice: bool

    @classmethod
    def of(cls, r: dict) -> "PostOpt":
        return cls(**{k: r[k] for k in cls.__dataclass_fields__})


def regions(o: PostOpt, qname: str, qlen: int, a: np.ndarray, u: np.ndarray,
            rep_len: int, mini_pos: np.ndarray,
            ref_lens: Sequence[int]) -> List[Region]:
    """The read's regions from its chains (`u`, over anchors `a`, which
    the long join may change), as the program's `_post_chain` leaves
    them where it makes no alignment (map.c:344-391)."""
    if len(u) == 0:
        return []
    regs = gen_regs(reg_hash(qname, qlen, o.seed), qlen, u, a)
    set_parent(regs, o.mask_level, o.mask_len)
    regs = select_sub(regs, o.pri_ratio, o.k * 2, o.best_n)
    if not o.splice:
        regs = join_long(regs, o, qlen, a)
    est_err(qlen, regs, a, mini_pos, ref_lens)
    set_mapq(regs, o.min_chain_score, rep_len)
    return regs


def _fmt(v: float) -> str:
    return "0" if v == 0.0 else "%.4f" % v


def paf_line(name: str, qlen: int, r: Region, tname: str, tlen: int,
             rep_len: int) -> str:
    """mm_write_paf3 (format.c:308-334) of a region without CIGAR."""
    s = "%s\t%d\t%d\t%d\t%s\t%s\t%d\t%d\t%d\t%d\t%d\t%d" % (
        name, qlen, r.qs, r.qe, "+-"[r.rev], tname, tlen, r.rs, r.re,
        r.mlen, r.blen, r.mapq)
    s += "\ttp:A:%s\tcm:i:%d\ts1:i:%d" % ("P" if r.id == r.parent else "S",
                                          r.cnt, r.score)
    if r.parent == r.id:
        s += "\ts2:i:%d" % r.subsc
    if 0.0 <= r.div <= 1.0:
        s += "\tdv:f:" + _fmt(r.div)
    return s + "\trl:i:%d" % rep_len
