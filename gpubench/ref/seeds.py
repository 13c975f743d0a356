"""The reference's index and seeding: minimizer hits to position-sorted
anchors, as minimap2 v2.18 (index.c:191-243, map.c:90-123, 215-247).

`RefIndex` holds the genome's minimizers grouped by hash, each group's
positions sorted, as the program's index does; it is built from
`sketch.sketch_genome` and nothing of the program. `collect_seed_hits`
is a frozen copy of the NumPy path of
`mm2tpu_torch/mapping/seed.py::collect_seed_hits` for one query of one
segment (no ava-* rules). Anchor encoding (minimap.h:53, map.c:232-241):
  a.x = strand << 63 | rid << 32 | ref_last_pos
  a.y = flags | seg_id << 48 | q_span << 32 | query_last_pos
"""
from __future__ import annotations

import numpy as np

from . import sketch as sk

U64 = np.uint64
MM_SEED_TANDEM = 1 << 42
MM_SEED_SEG_SHIFT = 48


class RefIndex:
    """keys (sorted distinct hashes), start, cnt and pos (the positions
    y, sorted within each hash), as NumPy arrays."""

    def __init__(self, genome, w: int, k: int, device):
        import torch
        x, y = sk.sketch_genome(genome, w, k, device)
        h = x >> 8
        o = torch.sort(y, stable=True).indices
        h, y = h[o], y[o]
        o = torch.sort(h, stable=True).indices
        h, y = h[o], y[o]
        keys, cnt = torch.unique_consecutive(h, return_counts=True)
        self.w, self.k = w, k
        self.keys = keys.cpu().numpy().astype(np.uint64)
        self.cnt = cnt.cpu().numpy().astype(np.int64)
        self.start = np.concatenate(([0], np.cumsum(self.cnt)[:-1]))
        self.pos = y.cpu().numpy().view(np.uint64)

    def cal_max_occ(self, f: float) -> int:
        """mm_idx_cal_max_occ (index.c:245-262)."""
        if f <= 0.0 or len(self.cnt) == 0:
            return np.iinfo(np.int32).max
        a = np.sort(self.cnt.astype(np.uint32))
        kk = int((1.0 - f) * len(a))
        return int(a[min(kk, len(a) - 1)]) + 1

    def get_many(self, miniers: np.ndarray):
        """(start, cnt) of each hash; cnt 0 where it is absent."""
        i = np.searchsorted(self.keys, miniers)
        i = np.minimum(i, len(self.keys) - 1)
        hit = self.keys[i] == miniers
        return (np.where(hit, self.start[i], 0),
                np.where(hit, self.cnt[i], 0))


def mid_occ(index: RefIndex, frac: float, min_mid_occ: int) -> int:
    """mm_mapopt_update (options.c:59-69)."""
    return max(index.cal_max_occ(frac), min_mid_occ)


def collect_seed_hits(index: RefIndex, max_occ: int, mv: np.ndarray,
                      qlen: int):
    """(anchors (n, 2) uint64 sorted by x, stably; rep_len; mini_pos, the
    q_span << 32 | q_pos of each minimizer kept) of one single-segment
    query's minimizers `mv` (sketch_np's rows)."""
    n_mv = len(mv)
    if n_mv == 0:
        return np.zeros((0, 2), U64), 0, np.zeros(0, U64)
    miniers = mv[:, 0] >> U64(8)
    q_pos = (mv[:, 1] & U64(0xFFFFFFFF)).astype(np.int64)
    q_span = (mv[:, 0] & U64(0xFF)).astype(np.int64)
    seg_id = (mv[:, 1] >> U64(32)).astype(np.int64)
    start, cnt = index.get_many(miniers)

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

    k_idx = np.nonzero(~over)[0]
    mini_pos = (q_span[k_idx].astype(U64) << U64(32)) | \
        (q_pos[k_idx] >> 1).astype(U64)
    tandem = np.zeros(n_mv, dtype=bool)
    if n_mv > 1:
        same_prev = miniers[1:] == miniers[:-1]
        tandem[1:] |= same_prev
        tandem[:-1] |= same_prev
    c = cnt[k_idx]
    s = start[k_idx]
    total = int(c.sum())
    if total == 0:
        return np.zeros((0, 2), U64), rep_len, mini_pos
    match_of = np.repeat(np.arange(len(k_idx)), c)
    flat = np.repeat(s, c) + (np.arange(total) - np.repeat(np.cumsum(c) - c, c))
    r = index.pos[flat]

    mq_pos = q_pos[k_idx][match_of]
    mq_span = q_span[k_idx][match_of]
    mseg = seg_id[k_idx][match_of]
    mtandem = tandem[k_idx][match_of]

    r_rid = (r >> U64(32)).astype(np.int64)
    r_pos = ((r & U64(0xFFFFFFFF)) >> U64(1)).astype(np.int64)
    r_strand = (r & U64(1)).astype(np.int64)
    forward = r_strand == (mq_pos & 1)

    x = (r_rid.astype(U64) << U64(32)) | r_pos.astype(U64)
    x = np.where(forward, x, x | U64(1 << 63))
    y_pos = np.where(forward, mq_pos >> 1,
                     qlen - ((mq_pos >> 1) + 1 - mq_span) - 1)
    y = (mq_span.astype(U64) << U64(32)) | y_pos.astype(U64)
    y |= mseg.astype(U64) << U64(MM_SEED_SEG_SHIFT)
    y = np.where(mtandem, y | U64(MM_SEED_TANDEM), y)

    order = np.argsort(x, kind="stable")
    return np.stack([x[order], y[order]], axis=1), rep_len, mini_pos


def read_anchors(index: RefIndex, seq: np.ndarray, max_occ: int):
    """A read's (anchors, rep_len, mini_pos): its minimizers (rid 0, the
    segment) and their hits."""
    mv = sk.sketch_np(seq, index.w, index.k, 0)
    return collect_seed_hits(index, max_occ, mv, len(seq))
