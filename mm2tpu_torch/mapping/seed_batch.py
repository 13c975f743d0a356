"""Host seeding a batch of reads at a time: the first seeding pass of
`pipeline.map_frags_batched`.

Each read gets the minimizers and seed hits that `seed.collect_minimizers`
and `seed.collect_seed_hits` give it, from two calls into the native
runtime a batch (`native.lib.sketch_batch`, `native.lib.seed_hits_batch`)
in place of two a read. Each call spreads the batch's reads over
`threads(n)` threads of the host, and drops the interpreter lock for its
whole run. Every read's `mv` and its `SeedResult`'s arrays are views of
the batch's arrays.

`covers` says where the two calls compute what the per-read path does;
elsewhere the pipeline seeds a read at a time (`pipeline._seed_ctx`).
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..index.build import MMIndex
from ..native import lib as native_lib
from ..options import (MapOptions, MM_F_NO_DIAG, MM_F_NO_DUAL, MM_F_FOR_ONLY,
                       MM_F_REV_ONLY)
from ..utils import profiling
from .seed import SeedResult

# the fewest reads a thread is given: one read, or a mappy-sized call,
# runs on the calling thread alone
READS_PER_THREAD = 16


def threads(n_reads: int) -> int:
    """The threads a batch call of `n_reads` reads runs on: the host's
    usable cores, or fewer where the batch is small."""
    return max(1, min(len(os.sched_getaffinity(0)),
                      -(-n_reads // READS_PER_THREAD)))


def covers(mi: MMIndex, opt: MapOptions, seed_hits: bool) -> bool:
    """Whether the batch calls compute what the per-read path does. Not
    with SDUST masking (`opt.sdust_thres > 0`, a Python pass a segment);
    for the seed hits, not with the read-name rules of the ava presets
    (`MM_F_NO_DIAG`, `MM_F_NO_DUAL`), with both strand filters, or on an
    index of under 512 keys: `collect_seed_hits` runs its NumPy path
    there."""
    if opt.sdust_thres > 0:
        return False
    if not seed_hits:
        return True
    both = MM_F_FOR_ONLY | MM_F_REV_ONLY
    return not (opt.flag & (MM_F_NO_DIAG | MM_F_NO_DUAL)) and \
        (opt.flag & both) != both and len(mi.keys) >= 512


def _encode(ctxs: Sequence) -> tuple:
    """The batch's bases as bytes, segment after segment, with each
    segment's byte offsets and y shift (twice its read's earlier query
    bases, as `collect_minimizers` adds them) and each read's segment
    offsets. The sketch call codes the bases itself."""
    segs = [s if isinstance(s, bytes) else s.encode()
            for c in ctxs for s in c.seqs]
    seg_off = np.zeros(len(segs) + 1, np.int64)
    np.cumsum([len(s) for s in segs], out=seg_off[1:])
    read_seg = np.zeros(len(ctxs) + 1, np.int64)
    np.cumsum([len(c.seqs) for c in ctxs], out=read_seg[1:])
    qlens = np.array([q for c in ctxs for q in c.qlens], np.int64)
    before = np.cumsum(qlens) - qlens   # the batch's bases before each
    first = np.repeat(read_seg[:-1], np.diff(read_seg))
    seg_shift = ((before - before[first]) << 1).astype(np.uint64)
    return b"".join(segs), seg_off, seg_shift, read_seg


def seed_frags(mi: MMIndex, opt: MapOptions, ctxs: Sequence,
               seed_hits: bool = True) -> None:
    """Fills every context's `mv` and, with `seed_hits`, its `sr` (max_occ
    `opt.mid_occ`, as `pipeline._seed_ctx`), where `covers` holds. One
    `seed` range: the encoding and the sketch call in `seed.sketch`, the
    hits call and the reads' views in `seed.hits`; both calls' seconds
    in `seed.native`. Counts `seed.batch_calls` and the threads they ran
    on, `seed.threads`."""
    n = len(ctxs)
    nt = threads(n)
    with profiling.stage("seed"):
        with profiling.stage("seed.sketch"):
            seq, seg_off, seg_shift, read_seg = _encode(ctxs)
            mv, mv_off = profiling.timed(
                "seed.native", native_lib.sketch_batch, seq, seg_off,
                seg_shift, read_seg, mi.w, mi.k, bool(mi.flag & 0x1), nt)
            bounds = mv_off.tolist()
            for c, s, e in zip(ctxs, bounds, bounds[1:]):
                c.mv = mv[s:e]
        if seed_hits:
            with profiling.stage("seed.hits"):
                qlen = np.array([c.qlen_sum for c in ctxs], np.int64)
                skip_mode = (1 if (opt.flag & MM_F_FOR_ONLY) else
                             2 if (opt.flag & MM_F_REV_ONLY) else 0)
                bits, shift, lut = mi._native_lut()
                a, a_off, mini, m_off, rep = profiling.timed(
                    "seed.native", native_lib.seed_hits_batch, mv, mv_off,
                    qlen, mi.keys, mi.start, mi.cnt, bits, shift, lut,
                    mi.pos, opt.mid_occ, skip_mode, nt, cache_obj=mi)
                for c, s, e, sa, ea, sm, em, r in zip(
                        ctxs, bounds, bounds[1:], a_off.tolist(),
                        a_off[1:].tolist(), m_off.tolist(),
                        m_off[1:].tolist(), rep.tolist()):
                    c.sr = SeedResult(a[sa:ea], r, mini[sm:em], e - s)
    calls = 2 if seed_hits else 1
    profiling.count("seed.batch_calls", calls)
    profiling.count("seed.threads", calls * nt)
