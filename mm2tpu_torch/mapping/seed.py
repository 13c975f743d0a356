"""Seeding: query minimizers -> index matches -> position-sorted anchors.

Reference: map.c:38-247 (collect_minimizers, collect_matches, skip_seed,
collect_seed_hits). Anchor encoding (minimap.h:53 comment, map.c:232-241):
  a.x = strand<<63 | rid<<32 | ref_last_pos
  a.y = flags | seg_id<<48 | q_span<<32 | query_last_pos

The port's copy of `mm2tpu/mapping/seed.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..index.build import MMIndex
from ..index.sketch import sketch_np
from ..options import (MapOptions, MM_F_NO_DIAG, MM_F_NO_DUAL, MM_F_FOR_ONLY,
                       MM_F_REV_ONLY, MM_SEED_TANDEM, MM_SEED_SELF,
                       MM_SEED_SEG_SHIFT)
from ..utils import profiling

U64 = np.uint64


@dataclass
class SeedResult:
    anchors: np.ndarray      # (n, 2) uint64 [x, y], sorted by x (stable)
    rep_len: int
    mini_pos: np.ndarray     # uint64 q_span<<32 | q_pos, per kept minimizer
    n_mv: int                # number of query minimizers collected


def collect_minimizers(mi: MMIndex, opt: MapOptions, seqs: Sequence[str],
                       qlens: Sequence[int]) -> np.ndarray:
    """Per-segment sketch with cumulative query-offset shift
    (map.c:64-77). SDUST masking (sdust_thres>0) applied per segment.
    Stage `seed.sketch`; the native sketch's own time is `seed.native`."""
    with profiling.stage("seed.sketch"):
        chunks = []
        total = 0
        for sid, (s, ql) in enumerate(zip(seqs, qlens)):
            mm = sketch_np(s, mi.w, mi.k, sid, bool(mi.flag & 0x1),
                           native_stage="seed.native")
            if len(mm):
                mm[:, 1] += U64(total << 1)
            if opt.sdust_thres > 0 and len(mm):
                from .sdust import dust_minimizers
                mm = dust_minimizers(mm, s, opt.sdust_thres)
            chunks.append(mm)
            total += ql
        return (np.concatenate(chunks, axis=0) if chunks
                else np.zeros((0, 2), U64))


def collect_seed_hits(mi: MMIndex, opt: MapOptions, max_occ: int,
                      mv: np.ndarray, qname: Optional[str], qlen: int) -> SeedResult:
    """collect_matches + collect_seed_hits (map.c:90-123, 215-247).
    Stage `seed.hits`; the native one-pass call's own time is
    `seed.native`, and each run of the NumPy path where that call would
    have run counts as `fallback.seed_hits`."""
    with profiling.stage("seed.hits"):
        return _collect_seed_hits(mi, opt, max_occ, mv, qname, qlen)


def _collect_seed_hits(mi: MMIndex, opt: MapOptions, max_occ: int,
                       mv: np.ndarray, qname: Optional[str],
                       qlen: int) -> SeedResult:
    n_mv = len(mv)
    if n_mv == 0:
        return SeedResult(np.zeros((0, 2), U64), 0, np.zeros(0, U64), 0)

    # native one-pass fast path (probe + anchors + radix sort); the
    # qname-dependent ava-* rules (NO_DIAG/NO_DUAL) stay below
    if not (qname is not None and
            (opt.flag & (MM_F_NO_DIAG | MM_F_NO_DUAL))) and \
            not ((opt.flag & MM_F_FOR_ONLY) and (opt.flag & MM_F_REV_ONLY)) \
            and len(mi.keys) >= 512:
        try:
            from ..native import lib as native_lib
            if native_lib.has_seed_hits():
                skip_mode = (1 if (opt.flag & MM_F_FOR_ONLY) else
                             2 if (opt.flag & MM_F_REV_ONLY) else 0)
                bits, shift, lut = mi._native_lut()
                a, rep_len, mini_pos = profiling.timed(
                    "seed.native", native_lib.seed_hits, mv, mi.keys,
                    mi.start, mi.cnt, bits, shift, lut, mi.pos, max_occ,
                    qlen, skip_mode, cache_obj=mi)
                return SeedResult(a, rep_len, mini_pos, n_mv)
        except Exception:
            pass
        profiling.count("fallback.seed_hits")
    miniers = mv[:, 0] >> U64(8)
    q_pos = (mv[:, 1] & U64(0xFFFFFFFF)).astype(np.int64)
    q_span = (mv[:, 0] & U64(0xFF)).astype(np.int64)
    seg_id = (mv[:, 1] >> U64(32)).astype(np.int64)
    start, cnt = mi.get_many(miniers)

    # repeat-length accounting for over-occurring minimizers (map.c:104-110)
    over = cnt >= max_occ
    rep_len = 0
    rep_st = rep_en = 0
    for i in np.nonzero(over)[0]:
        en = int(q_pos[i] >> 1) + 1
        st = en - int(q_span[i])
        if st > rep_en:
            rep_len += rep_en - rep_st
            rep_st, rep_en = st, en
        else:
            rep_en = en
    rep_len += rep_en - rep_st

    keep = ~over
    k_idx = np.nonzero(keep)[0]
    # tandem flag: same hash as a neighbouring query minimizer (map.c:114-115)
    tandem = np.zeros(n_mv, dtype=bool)
    if n_mv > 1:
        same_prev = miniers[1:] == miniers[:-1]
        tandem[1:] |= same_prev
        tandem[:-1] |= same_prev
    # mini_pos over kept minimizers (map.c:117)
    mini_pos = (q_span[k_idx].astype(U64) << U64(32)) | (q_pos[k_idx] >> 1).astype(U64)

    # expand matches to hits
    c = cnt[k_idx]
    s = start[k_idx]
    total = int(c.sum())
    if total == 0:
        return SeedResult(np.zeros((0, 2), U64), rep_len, mini_pos, n_mv)
    match_of = np.repeat(np.arange(len(k_idx)), c)
    flat = np.repeat(s, c) + (np.arange(total) - np.repeat(np.cumsum(c) - c, c))
    r = mi.pos[flat]  # hit payloads, y-sorted within each minimizer

    mq_pos = q_pos[k_idx][match_of]
    mq_span = q_span[k_idx][match_of]
    mseg = seg_id[k_idx][match_of]
    mtandem = tandem[k_idx][match_of]

    r_rid = (r >> U64(32)).astype(np.int64)
    r_pos = ((r & U64(0xFFFFFFFF)) >> U64(1)).astype(np.int64)
    r_strand = (r & U64(1)).astype(np.int64)
    q_strand = mq_pos & 1
    forward = r_strand == q_strand

    # skip_seed rules (map.c:125-147)
    skip = np.zeros(total, dtype=bool)
    is_self = np.zeros(total, dtype=bool)
    if qname is not None and (opt.flag & (MM_F_NO_DIAG | MM_F_NO_DUAL)):
        cmp = np.array([_strcmp(qname, mi.seq[int(t)].name or "")
                        for t in np.unique(r_rid)])
        cmp_map = dict(zip([int(t) for t in np.unique(r_rid)], cmp))
        cmp_a = np.array([cmp_map[int(t)] for t in r_rid])
        len_eq = np.array([mi.seq[int(t)].length == qlen for t in r_rid])
        if opt.flag & MM_F_NO_DIAG:
            diag_ctx = (cmp_a == 0) & len_eq
            skip |= diag_ctx & (r_pos == (mq_pos >> 1))
            is_self |= diag_ctx & forward
        if opt.flag & MM_F_NO_DUAL:
            skip |= cmp_a > 0
    if opt.flag & (MM_F_FOR_ONLY | MM_F_REV_ONLY):
        if opt.flag & MM_F_REV_ONLY:
            skip |= forward
        if opt.flag & MM_F_FOR_ONLY:
            skip |= ~forward

    keep_a = ~skip
    r_rid, r_pos, forward = r_rid[keep_a], r_pos[keep_a], forward[keep_a]
    mq_pos, mq_span, mseg = mq_pos[keep_a], mq_span[keep_a], mseg[keep_a]
    mtandem, is_self = mtandem[keep_a], is_self[keep_a]

    x = (r_rid.astype(U64) << U64(32)) | r_pos.astype(U64)
    x = np.where(forward, x, x | U64(1 << 63))
    y_pos = np.where(forward, mq_pos >> 1,
                     qlen - ((mq_pos >> 1) + 1 - mq_span) - 1)
    y = (mq_span.astype(U64) << U64(32)) | y_pos.astype(U64)
    y |= mseg.astype(U64) << U64(MM_SEED_SEG_SHIFT)
    y = np.where(mtandem, y | U64(MM_SEED_TANDEM), y)
    y = np.where(is_self, y | U64(MM_SEED_SELF), y)

    order = np.argsort(x, kind="stable")  # radix_sort_128x equivalent
    a = np.stack([x[order], y[order]], axis=1)
    return SeedResult(a, rep_len, mini_pos, n_mv)


def _strcmp(a: str, b: str) -> int:
    ab, bb = a.encode(), b.encode()
    return (ab > bb) - (ab < bb)
