"""Batched mapping with the chaining DP, and optionally the extension
fills, on a torch device.

Counterpart of `mm2tpu/mapping/pipeline.py::map_frags_batched` (its
single-device, host-seeded branch). The per-fragment stages around the
chaining call are the port's verbatim copies of that module's
`FragResult`, `_FragCtx`, `_prepare` (seeding), `_needs_rechain` (the
re-seed trigger), `_post_chain` (everything after chaining) and
`_align_regs`, with `BUCKETS`/`bucket_for` from
`mm2tpu/parallel/batching.py`. Its device seeding round
(`_seed_device_eligible`, `_seed_device_round`) is ported on
`ops/seed_device.py`. With a mesh (`parallel/mesh.py`) each bucket's
rows are split over its devices, as in the JAX package's mesh branch.
The per-bucket chaining call changes, and with `--align-backend gpu`
the reads are aligned on a thread pool whose extension fills meet in a
`TorchExtBatcher`.

The stream mode's per-read path, `map_frag` with `_chain_ctx` and
`_chain_ctx_inner`, is the JAX package's, with the run's device passed
down: each chaining task is placed by `mapping.chain.chain_dp` (the
host DP, or K1/K2 at B = 1 on the device), and with `--align-backend
gpu` each fill of at least `--align-tpu-min-mat` cells runs alone on
the device (`extbatch.fill_scope`).
"""
from __future__ import annotations

import contextlib
import functools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..index.build import MMIndex
from ..native import lib as native
from ..ops import card_spans, chain_ref, span_seconds
from ..ops import seed_device as sd
from ..ops.chain_packed import (WINDOW, chain_scores_packed, count_wide,
                                derive_qss, pack_tasks8, pack_tasks16,
                                planes_to_torch, unpack_prel, v_carry_host)
from ..options import (MapOptions, MM_F_SPLICE, MM_F_SR, MM_F_CIGAR,
                       MM_F_ALL_CHAINS, MM_F_HARD_MLEVEL,
                       MM_SEED_SEG_MASK, MM_MAX_SEG)
from ..parallel.mesh import gather
from ..utils import profiling
from ..utils.hashing import reg_hash
from . import hit as hit_mod
from . import seed_batch
from .chain import chain_dp, chain_gaps
from .esterr import est_err
from .extbatch import TorchExtBatcher, fill_scope, worker_scope
from .hit import Region
from .seed import SeedResult, collect_minimizers, collect_seed_hits

# the batch sizes of the JAX package, kept so both packages form the same
# batches (a task's chaining does not depend on its batch either way)
B_SIZES = (8, 16, 32, 64, 128)

# ---- copied verbatim from mm2tpu/parallel/batching.py ----

# bucket boundaries in anchors; multiples of the 1024 ring so tiles
# align. 1.5x intermediate rungs (3072, 6144, ...) bound padding waste
# at 1.5x instead of 2x — the bench accounting showed padded/real
# anchors at 2.4x, and padding ships on the wire like real anchors
BUCKETS = (1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384, 24576,
           32768, 49152, 65536, 98304, 131072)


def bucket_for(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return -(-n // WINDOW) * WINDOW


# ---- copied verbatim from mm2tpu/mapping/pipeline.py ----

@dataclass
class FragResult:
    regs: List[List[Region]]          # per segment
    rep_len: int = 0
    frag_gap: int = 0
    anchors: Optional[np.ndarray] = None  # post-chain anchors (debug)


@dataclass
class _FragCtx:
    """Per-fragment state between the seeding and post-chain stages —
    lets the batched driver interleave many fragments' chaining."""
    seqs: Sequence[str]
    qlens: List[int]
    qlen_sum: int
    qname: Optional[str]
    hash_: int
    is_splice: bool
    is_sr: bool
    n_segs: int
    mv: object
    sr: object
    gap_qry: int
    gap_ref: int


def _frag_ctx(seqs: Sequence[str], opt: MapOptions,
              qname: Optional[str]):
    """The prologue of mm_map_frag (map.c:272-316) before seeding: a
    _FragCtx whose minimizers and seed hits are still None, or a final
    FragResult for degenerate inputs."""
    n_segs = len(seqs)
    qlens = [len(s) for s in seqs]
    qlen_sum = sum(qlens)
    if qlen_sum == 0 or n_segs <= 0 or n_segs > MM_MAX_SEG or \
            (opt.max_qlen > 0 and qlen_sum > opt.max_qlen):
        return FragResult(regs=[[] for _ in range(max(n_segs, 0))])
    gap_qry, gap_ref = chain_gaps(opt, qlen_sum)
    return _FragCtx(seqs=seqs, qlens=qlens, qlen_sum=qlen_sum, qname=qname,
                    hash_=reg_hash(qname, qlen_sum, opt.seed),
                    is_splice=bool(opt.flag & MM_F_SPLICE),
                    is_sr=bool(opt.flag & MM_F_SR), n_segs=n_segs,
                    mv=None, sr=None, gap_qry=gap_qry, gap_ref=gap_ref)


def _seed_ctx(mi: MMIndex, ctx: _FragCtx, opt: MapOptions,
              seed_hits: bool = True) -> None:
    """The seeding of mm_map_frag (stage `seed`): fills ctx.mv and, with
    seed_hits, ctx.sr (else ctx.sr stays None — the batched
    device-seeding path fills it from the chip)."""
    with profiling.stage("seed"):
        ctx.mv = collect_minimizers(mi, opt, ctx.seqs, ctx.qlens)
        if seed_hits:
            ctx.sr = collect_seed_hits(mi, opt, opt.mid_occ, ctx.mv,
                                       ctx.qname, ctx.qlen_sum)


def _seed_first_pass(mi: MMIndex, opt: MapOptions, ctxs: List[_FragCtx],
                     seed_hits: bool) -> None:
    """`_seed_ctx` of every context, by `seed_batch.seed_frags`' two calls
    a batch where `seed_batch.covers` holds, else a read at a time. Counts
    the reads as `seed.reads`, those of the batch calls as
    `seed.batched`, and a batch whose runtime lacks the batch calls as
    `fallback.seed_batch`."""
    profiling.count("seed.reads", len(ctxs))
    if ctxs and seed_batch.covers(mi, opt, seed_hits):
        if native.has_seed_batch():
            seed_batch.seed_frags(mi, opt, ctxs, seed_hits)
            profiling.count("seed.batched", len(ctxs))
            return
        profiling.count("fallback.seed_batch")
    for ctx in ctxs:
        _seed_ctx(mi, ctx, opt, seed_hits)


def _prepare(mi: MMIndex, seqs: Sequence[str], opt: MapOptions,
             qname: Optional[str], seed_hits: bool = True):
    """Seeding stage of mm_map_frag (map.c:272-316): `_frag_ctx` (stage
    `seed.prep`), then `_seed_ctx`. Returns the _FragCtx, or a final
    FragResult for degenerate inputs."""
    with profiling.stage("seed.prep"):
        prep = _frag_ctx(seqs, opt, qname)
    if isinstance(prep, _FragCtx):
        _seed_ctx(mi, prep, opt, seed_hits)
    return prep


def _chain_ctx(ctx: _FragCtx, opt: MapOptions, anchors: np.ndarray,
               device=None):
    with profiling.stage("chain"):
        return _chain_ctx_inner(ctx, opt, anchors, device)


def _chain_ctx_inner(ctx: _FragCtx, opt: MapOptions, anchors: np.ndarray,
                     device=None):
    return chain_dp(ctx.gap_ref, ctx.gap_qry, opt.bw, opt.max_chain_skip,
                    opt.max_chain_iter, opt.min_cnt, opt.min_chain_score,
                    opt.chain_gap_scale, ctx.is_splice, ctx.n_segs,
                    anchors, backend=opt.chain_backend, preset=opt.preset,
                    device=device)


def _needs_rechain(ctx: _FragCtx, opt: MapOptions, a: np.ndarray,
                   u: np.ndarray) -> bool:
    """Re-seed trigger: best chain misses segments (map.c:318-340)."""
    if not (opt.max_occ > opt.mid_occ and ctx.sr.rep_len > 0):
        return False
    if len(u) == 0:
        return True
    scores = (u >> np.uint64(32)).astype(np.int64)
    cnts = (u & np.uint64(0xFFFFFFFF)).astype(np.int64)
    max_i = int(np.argmax(scores))
    off = int(np.sum(cnts[:max_i]))
    segs_in = a[off: off + int(cnts[max_i]), 1] & np.uint64(MM_SEED_SEG_MASK)
    n_chained_segs = 1 + int(np.sum(segs_in[1:] != segs_in[:-1]))
    return n_chained_segs < ctx.n_segs


def _dump_anchor(tag, mi, a, i, first):
    """--print-seeds SD/CN line (map.c:298-303, 350-354)."""
    import sys as _sys

    from .hit import _i32
    x, y = int(a[i, 0]), int(a[i, 1])
    rid = (x << 1 >> 33) & 0x7FFFFFFF
    diff = 0
    if not first:
        diff = (_i32(a[i, 1]) - _i32(a[i - 1, 1])) - \
               (_i32(a[i, 0]) - _i32(a[i - 1, 0]))
    print("\t".join(map(str, tag + (
        mi.seq[rid].name, _i32(np.uint64(x)), "+-"[x >> 63],
        _i32(np.uint64(y)), (y >> 32) & 0xFF, diff))), file=_sys.stderr)


def map_frag(mi: MMIndex, seqs: Sequence[str], opt: MapOptions,
             qname: Optional[str] = None, device=None) -> FragResult:
    """One fragment through seeding, per-task chaining (`chain_dp`, whose
    device route runs on `device`) and everything after it; with
    `--align-backend gpu` its large fills run on `device` one at a
    time. `device` is the run's ("cuda" or "cpu")."""
    prep = _prepare(mi, seqs, opt, qname)
    if isinstance(prep, FragResult):
        return prep
    ctx = prep
    if opt.dbg_print_seed:
        import sys as _sys
        print("RS\t%d" % ctx.sr.rep_len, file=_sys.stderr)
        for i in range(len(ctx.sr.anchors)):
            _dump_anchor(("SD",), mi, ctx.sr.anchors, i, i == 0)
    a, u = _chain_ctx(ctx, opt, ctx.sr.anchors, device)
    with profiling.stage("chain.rechain"):
        rechain = _needs_rechain(ctx, opt, a, u)
    if rechain:
        profiling.count("chain.rechained")
        ctx.sr = collect_seed_hits(mi, opt, opt.max_occ, ctx.mv, qname,
                                   ctx.qlen_sum)
        a, u = _chain_ctx(ctx, opt, ctx.sr.anchors, device)
    with fill_scope(device):
        return _post_chain(mi, ctx, opt, a, u)


def _post_chain(mi: MMIndex, ctx: _FragCtx, opt: MapOptions,
                a: np.ndarray, u: np.ndarray) -> FragResult:
    """Everything after chaining (map.c:344-391): the regions
    (`_post_regions`), their alignment (`_post_align`), then mapq,
    pairing and the result (`_post_finish`, stage `post.finish`)."""
    regss = _post_align(mi, ctx, opt, _post_regions(mi, ctx, opt, a, u), a)
    with profiling.stage("post.finish"):
        return _post_finish(ctx, opt, regss, a)


def _post_regions(mi: MMIndex, ctx: _FragCtx, opt: MapOptions,
                  a: np.ndarray, u: np.ndarray) -> List[Region]:
    """The chains' regions, post-chained, with their divergence (map.c:
    344-375; stage `post`)."""
    n_segs, qlens, qlen_sum = ctx.n_segs, ctx.qlens, ctx.qlen_sum
    hash_, sr, is_sr = ctx.hash_, ctx.sr, ctx.is_sr
    if (not mi.n_alt and n_segs == 1 and not opt.dbg_print_seed and
            not (opt.flag & MM_F_ALL_CHAINS)):
        with profiling.stage("post"):
            fast = hit_mod.gen_regs_chain_post_fast(
                hash_, qlen_sum, u, a, opt, mi.k * 2)
            if fast is not None:
                regs0 = hit_mod.chain_post_tail(fast, opt, qlen_sum, a)
                if not is_sr:
                    est_err(mi, qlen_sum, regs0, a, sr.mini_pos)
                return regs0
    regs0 = hit_mod.gen_regs(hash_, qlen_sum, u, a)
    if mi.n_alt:
        hit_mod.mark_alt(mi, regs0)
        regs0 = hit_mod.hit_sort(regs0, opt.alt_drop)
    if opt.dbg_print_seed:
        for j, r in enumerate(regs0):
            for i in range(r.as_, r.as_ + r.cnt):
                _dump_anchor(("CN", j), mi, a, i, i == r.as_)

    with profiling.stage("post"):
        regs0 = hit_mod.chain_post(regs0, opt, ctx.gap_ref, mi, qlen_sum,
                                   n_segs, qlens, a)
        if not is_sr:
            est_err(mi, qlen_sum, regs0, a, sr.mini_pos)
    return regs0


def _post_align(mi: MMIndex, ctx: _FragCtx, opt: MapOptions,
                regs0: List[Region], a: np.ndarray) -> List[List[Region]]:
    """Each segment's regions, aligned with CIGARs on (stage `align`):
    a fragment of several segments is split and its parents set first
    (map.c:376-386)."""
    if ctx.n_segs == 1:
        return [_align_regs(mi, opt, ctx.qlens[0], ctx.seqs[0], regs0, a)]
    from .seg import seg_gen
    segs = seg_gen(ctx.hash_, ctx.qlens, regs0, a)
    for seg in segs:
        hit_mod.set_parent(seg.regs, opt.mask_level, opt.mask_len,
                           opt.a * 2 + opt.b,
                           bool(opt.flag & MM_F_HARD_MLEVEL), opt.alt_drop)
    return [_align_regs(mi, opt, ctx.qlens[i], ctx.seqs[i], seg.regs, seg.a)
            for i, seg in enumerate(segs)]


def _post_finish(ctx: _FragCtx, opt: MapOptions, regss: List[List[Region]],
                 a: np.ndarray) -> FragResult:
    """Each segment's mapq, the pairing of two, the result (map.c:
    377-391)."""
    sr = ctx.sr
    for regs in regss:
        hit_mod.set_mapq(regs, opt.min_chain_score, opt.a, sr.rep_len,
                         ctx.is_sr)
    if ctx.n_segs == 2 and opt.pe_ori >= 0 and (opt.flag & MM_F_CIGAR):
        from .pe import pair
        pair(ctx.gap_ref, opt.pe_bonus, opt.a * 2 + opt.b, opt.a, ctx.qlens,
             regss)
    return FragResult(regss, sr.rep_len, ctx.gap_ref, a)


def _align_regs(mi: MMIndex, opt: MapOptions, qlen: int, seq: str,
                regs: List[Region], a: np.ndarray) -> List[Region]:
    """align_regs (map.c:260-270)."""
    if not (opt.flag & MM_F_CIGAR):
        return regs
    from .align import align_skeleton
    with profiling.stage("align"):
        regs = align_skeleton(mi, opt, qlen, seq, regs, a)
    if not (opt.flag & MM_F_ALL_CHAINS):
        hit_mod.set_parent(regs, opt.mask_level, opt.mask_len,
                           opt.a * 2 + opt.b,
                           bool(opt.flag & MM_F_HARD_MLEVEL), opt.alt_drop)
        regs = hit_mod.select_sub(regs, opt.pri_ratio, mi.k * 2, opt.best_n)
        hit_mod.set_sam_pri(regs)
    return regs


# ---- the port's batch driver ----


@contextlib.contextmanager
def _count_host_fills():
    """Under --profile, count the fills that stay on the host's native
    extension (below `--align-tpu-min-mat`) as `ext.host_fills`. The port's
    align code looks its native entry points up on its own `native.lib`
    at each call: `ksw_extd2`, `ksw_extd2_fill_ref` and `ksw_exts2` (a
    splice fill) run one fill, `ksw_fill_walk` a read's whole seed-gap
    walk (it returns how many fills it ran first). They are wrapped for
    the duration, in this process only."""
    if not profiling.enabled:
        yield
        return
    per_call = {"ksw_extd2": lambda out: 1,
                "ksw_extd2_fill_ref": lambda out: 1,
                "ksw_fill_walk": lambda out: out[0],
                "ksw_exts2": lambda out: 1}
    saved = {name: getattr(native, name) for name in per_call}

    def counted(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            profiling.count("ext.host_fills", per_call[name](out))
            return out
        return call

    for name, fn in saved.items():
        setattr(native, name, counted(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)


def _v_carry(native_v: bool, f: np.ndarray, p: np.ndarray) -> np.ndarray:
    """A chained row's carried scores: on the native runtime where it is
    `native_v` (its time `post.native`), else on the host's NumPy twin,
    counted as `fallback.v_carry`."""
    if native_v:
        return profiling.timed("post.native", native.v_carry, f, p)
    profiling.count("fallback.v_carry")
    return v_carry_host(f[None], p[None])[0]


def _seed_device_eligible(opt: MapOptions, ctx: _FragCtx) -> bool:
    """The JAX package's coverage contract of device seeding
    (`mm2tpu/mapping/pipeline.py::_seed_device_eligible`, verbatim)."""
    from ..options import (MM_F_FOR_ONLY, MM_F_NO_DIAG, MM_F_NO_DUAL,
                           MM_F_REV_ONLY)
    return (ctx.n_segs == 1 and not ctx.is_splice and
            not (opt.flag & (MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_FOR_ONLY |
                             MM_F_REV_ONLY)) and
            0 < opt.mid_occ < 4096 and len(ctx.mv) > 0)


# reads a device-seeding dispatch carries at most
SEED_B = 32

# the largest anchor bucket a device-seeding dispatch builds and chains: a
# read whose anchor total needs a larger one is handed back to host seeding
# (`_chain_chunks`, `_seed_device_round`)
DEVICE_ANCHOR_CAP = 131072


def _m_bucket(m: int) -> int:
    """The minimizer count a read's row is padded to."""
    for b in (512, 2048, 8192):
        if m <= b:
            return b
    return -(-m // 8192) * 8192


def _seed_chunks(groups: dict) -> list:
    """(key, chunk, B) of each dispatch: every group split into chunks of
    SEED_B reads, in key order; B is SEED_B where a group fills more than
    one chunk, else the chunk's reads rounded up to a multiple of 8."""
    out = []
    for key, members in sorted(groups.items()):
        for off in range(0, len(members), SEED_B):
            chunk = members[off:off + SEED_B]
            B = SEED_B if len(members) > SEED_B else \
                max(8, -(-len(chunk) // 8) * 8)
            out.append((key, chunk, B))
    return out


def _probe_chunks(ctxs: dict, idxs: List[int]) -> list:
    """The count probes' dispatches: reads grouped by `_m_bucket`."""
    groups: dict = {}
    for i in idxs:
        groups.setdefault(_m_bucket(len(ctxs[i].mv)), []).append(i)
    return _seed_chunks(groups)


def _seed_meta(prep, c: np.ndarray, mid_occ: int):
    """From one read's minimizers (`split_query_minimizers`) and their
    counts: (rep_len, mini_pos, anchor total, avg), as host seeding
    computes them (the JAX package's round, verbatim; avg's f32 rounding
    is chain.c:48-49's)."""
    _, qpos, qspan, _ = prep
    over = c >= mid_occ
    rep_len = 0
    rep_st = rep_en = 0
    for j in np.nonzero(over)[0]:
        en = int(qpos[j] >> 1) + 1
        st = en - int(qspan[j])
        if st > rep_en:
            rep_len += rep_en - rep_st
            rep_st, rep_en = st, en
        else:
            rep_en = en
    rep_len += rep_en - rep_st
    keep = ~over
    mini_pos = (qspan[keep].astype(np.uint64) << np.uint64(32)) | \
        (qpos[keep].astype(np.int64) >> 1).astype(np.uint64)
    total = int(c[keep].sum())
    sum_span = int((qspan[keep].astype(np.int64) * c[keep]).sum())
    avg = np.float32((0.01 * float(np.float32(sum_span))) /
                     total) if total else np.float32(0.0)
    return rep_len, mini_pos, total, avg


def _chain_chunks(ctxs: dict, idxs: List[int], meta: dict):
    """The fused dispatches of the reads with anchors: (key = (M, N,
    gap_ref, gap_qry), chunk, B) each, and the reads whose total needs a
    bucket over `DEVICE_ANCHOR_CAP` (seeded on the host)."""
    groups: dict = {}
    big = []
    for i in idxs:
        total = meta[i][2]
        if total == 0:
            continue
        N = bucket_for(total)
        if N > DEVICE_ANCHOR_CAP:
            big.append(i)
            continue
        groups.setdefault((_m_bucket(len(ctxs[i].mv)), N, ctxs[i].gap_ref,
                           ctxs[i].gap_qry), []).append(i)
    return _seed_chunks(groups), big


def _seed_planes(prep: dict, ctxs: dict, meta: dict, chunk, B: int,
                 M: int):
    """The host planes of one fused dispatch: q (B, M) int64 padded with
    `PAD_Q`, qpos and qyhi = span | TANDEM<<10 (B, M) int32, qlen (B,)
    int32 and avg (B, 1) float32."""
    q = np.full((B, M), sd.PAD_Q, np.int64)
    qpos_a = np.zeros((B, M), np.int32)
    qyhi_a = np.zeros((B, M), np.int32)
    qlen_a = np.ones(B, np.int32)
    avg_a = np.zeros((B, 1), np.float32)
    for r, i in enumerate(chunk):
        h, qpos, qspan, qtand = prep[i]
        q[r, :len(h)] = h
        qpos_a[r, :len(h)] = qpos
        qyhi_a[r, :len(h)] = qspan | (qtand << 10)
        qlen_a[r] = ctxs[i].qlen_sum
        avg_a[r, 0] = meta[i][3]
    return q, qpos_a, qyhi_a, qlen_a, avg_a


class _Marks:
    """CUDA events recorded at the marks of one dispatch (none on the CPU
    or without --profile), read into stages when its results are back."""

    def __init__(self, on):
        self.events = [] if on else None

    def __call__(self):
        if self.events is not None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

    def add(self, *names):
        """Add the time between consecutive marks to the stages `names`."""
        if self.events:
            for k, name in enumerate(names):
                profiling.add(name, self.events[k].elapsed_time(
                    self.events[k + 1]) / 1e3)


def _seed_device_round(mi: MMIndex, opt: MapOptions, ctxs: dict,
                       idxs: List[int], dev, seed_fn) -> dict:
    """Device seeding and chaining of the eligible fragments `idxs`
    (`mm2tpu/mapping/pipeline.py::_seed_device_round`): the host ships
    each read's minimizers, the device probes the index it holds for the
    counts, the host derives rep_len, mini_pos, the anchor total and avg
    from them, and then one dispatch per (M, N, gap) bucket of up to
    SEED_B reads probes again, builds and sorts the anchors and chains
    them on K1 (`seed_fn`, default `ops.seed_device.seed_chain`). Fills
    ctx.sr and returns {i: (a, u)} backtrack results; a fragment whose
    anchor total needs a bucket over `DEVICE_ANCHOR_CAP` keeps ctx.sr
    None (the caller seeds it on the host). Dispatches run two deep:
    chunk k+1 is packed and launched while chunk k's results come back.
    `--profile`'s seed.launches counts each K5 launch (a count probe) and
    each K6 launch (a fused dispatch's chain of seeding kernels) as one;
    seed.device_reads the fragments the round seeds, seed.capped those it
    hands back past the cap. The host glue has leaf stages of its own:
    `seed.split` (every read's `split_query_minimizers`) and `seed.meta`
    (every read's `_seed_meta`, and `_chain_chunks`), one range a round,
    and `seed.pack` (a dispatch's `_seed_planes`), one range a
    dispatch."""
    fn = sd.seed_chain if seed_fn is None else seed_fn
    timed = dev.type == "cuda" and profiling.enabled
    mid_occ = int(opt.mid_occ)
    with profiling.stage("seed.split"):
        prep = {i: sd.split_query_minimizers(ctxs[i].mv) for i in idxs}
        if profiling.enabled:
            profiling.count("seed.minimizers", sum(len(prep[i][0])
                                                   for i in idxs))

    # ---- the counts: one probe per chunk of each M bucket ----
    cnts = {}
    with profiling.stage("seed.device_probe"):
        index = sd.prepare_index_device(mi, dev)
        jobs = []
        for M, chunk, B in _probe_chunks(ctxs, idxs):
            q = np.full((B, M), sd.PAD_Q, np.int64)
            for r, i in enumerate(chunk):
                q[r, :len(prep[i][0])] = prep[i][0]
            (qt,) = planes_to_torch(q, dev)
            marks = _Marks(timed)
            marks()
            _, c = sd.probe_index(index, qt)
            marks()
            jobs.append((chunk, gather((dev,), [(c,)]), marks))
            if profiling.enabled:
                profiling.count("seed.launches")
                profiling.count("seed.bytes_up", q.nbytes)
        for chunk, c, marks in jobs:
            c = c.result()[0].numpy()
            marks.add("seed.gpu_busy")
            if profiling.enabled:
                profiling.count("seed.bytes_down", c.nbytes)
            for r, i in enumerate(chunk):
                cnts[i] = c[r, :len(ctxs[i].mv)]

    # ---- host: rep_len / mini_pos / totals / avg (seed.py semantics) ----
    outs: dict = {}
    with profiling.stage("seed.meta"):
        meta = {i: _seed_meta(prep[i], cnts[i], mid_occ) for i in idxs}
        for i in idxs:
            rep_len, mini_pos, total, _ = meta[i]
            if total == 0:
                ctxs[i].sr = SeedResult(np.zeros((0, 2), np.uint64),
                                        rep_len, mini_pos, len(ctxs[i].mv))
                outs[i] = (np.zeros((0, 2), np.uint64),
                           np.zeros(0, np.uint64))
        plan, big = _chain_chunks(ctxs, idxs, meta)
    profiling.count("seed.device_reads", len(idxs) - len(big))
    profiling.count("seed.capped", len(big))

    # ---- fused probe + build + sort + chain per (M, N, gap) bucket ----
    iter_cap = min(WINDOW, opt.max_chain_iter)
    for i in big:
        ctxs[i].sr = None  # seeded on the host
    native_v = native.available()

    def dispatch(job):
        (M, N, gap_ref, gap_qry), chunk, B = job
        with profiling.stage("seed.pack"):
            arrays = _seed_planes(prep, ctxs, meta, chunk, B, M)
        with profiling.stage("seed.device_chain"):
            if profiling.enabled:
                totals = [meta[i][2] for i in chunk]
                profiling.count("seed.launches")
                profiling.count("seed.anchors", sum(totals))
                profiling.count("seed.bytes_up", sum(a.nbytes
                                                     for a in arrays))
                profiling.count("chain.launches")
                profiling.count("chain.anchors", sum(totals))
                profiling.count("chain.padded_anchors", B * N)
                profiling.count("chain.steps", max(totals))
            planes = planes_to_torch(*arrays, dev)
            marks = _Marks(timed)
            out = fn(index, *planes, N=N, mid_occ=mid_occ,
                     max_dist_x=gap_ref, max_dist_y=gap_qry, bw=opt.bw,
                     iter_cap=iter_cap, gap_scale=float(opt.chain_gap_scale),
                     mark=marks)
            out = gather((dev,), [out])
        return chunk, out, marks

    def consume(item):
        chunk, out, marks = item
        with profiling.stage("seed.device_chain"):
            hi, lo, yhi, ylo, f, prel, n = (t.numpy() for t in out.result())
        marks.add("seed.gpu_busy", "chain.gpu_busy")
        if profiling.enabled:
            profiling.count("seed.bytes_down", sum(
                a.nbytes for a in (hi, lo, yhi, ylo, f, prel, n)))
        with profiling.stage("chain.backtrack"):
            for r, i in enumerate(chunk):
                rep_len, mini_pos, total, _ = meta[i]
                if int(n[r, 0]) != total:
                    raise RuntimeError(
                        "device seeding built %d anchors for read %d, the "
                        "counts gave %d" % (int(n[r, 0]), i, total))
                a = sd.anchors_from_device(hi[r], lo[r], yhi[r], ylo[r],
                                           total)
                ctxs[i].sr = SeedResult(a, rep_len, mini_pos,
                                        len(ctxs[i].mv))
                count_wide([a])
                p = unpack_prel(prel[r], total)
                v = _v_carry(native_v, f[r, :total], p)
                outs[i] = chain_ref.chain_backtrack(
                    total, f[r, :total], p, v, a, opt.min_cnt,
                    opt.min_chain_score)

    inflight = deque()
    for job in plan:
        inflight.append(dispatch(job))
        if len(inflight) > 2:
            consume(inflight.popleft())
    while inflight:
        consume(inflight.popleft())
    return outs


@functools.lru_cache(maxsize=256)
def _sharded_step(mesh, key, packed8: bool):
    """The mesh's chaining step for a bucket key, made once (the JAX
    package's `_sharded_step`); `packed8` picks the 8 B wire's."""
    from ..parallel.mesh import sharded_chain_step, sharded_chain_step8
    mdx, mdy, bw, iter_cap, gs, is_cdna, n_segs, _N = key
    mk = sharded_chain_step8 if packed8 else sharded_chain_step
    return mk(mesh, max_dist_x=mdx, max_dist_y=mdy, bw=bw,
              iter_cap=iter_cap, gap_scale=gs, is_cdna=is_cdna,
              n_segs=n_segs)


def map_frags_batched(mi: MMIndex, frag_seqs: Sequence[Sequence[str]],
                      opt: MapOptions, qnames: Sequence[Optional[str]],
                      device, *, chain_fn=None, ext_fn=None,
                      exts2_fn=None, seed_fn=None,
                      mesh=None) -> List[FragResult]:
    """Map many fragments with batched chaining on `device` ("cuda" or
    "cpu"): fragments are seeded on the host, their anchor arrays grouped
    into fixed (B, N) buckets, and each bucket chained in one call, then
    backtracked and post-processed on the host. Output equals
    `mm2tpu.mapping.pipeline.map_frags_batched` on one device.

    The first seeding pass seeds the whole batch in two native calls
    spread over the host's cores (`seed_batch.seed_frags`), where they
    cover the options and the index (`seed_batch.covers`), else a read
    at a time (`_seed_first_pass`).

    On CUDA, chunk k+1 is packed and launched while chunk k's results
    come back: the launch and a non-blocking copy into pinned host
    memory go on the current stream, and a CUDA event tells the host
    when the copy is done. With `--profile` on, CUDA events also time
    each bucket's chaining kernel on the card (stage `chain.gpu_busy`,
    the launch's own span, `ops.card_spans`), and
    `chain.steps` counts the launches' serial DP steps (each launch's
    longest row: the chaining kernel stops every row at its n).
    Single-segment non-cDNA tasks chain on K1, every other task (read
    pairs, spliced reads) on K2. `chain_fn` replaces the chaining
    function (see `ops.chain_packed.chain_scores_packed`).

    With `opt.seed_backend == "gpu"` the fragments that the JAX package's
    coverage contract admits (`_seed_device_eligible`) are seeded on
    `device` by `_seed_device_round` (the index probe, the anchor build
    and sort, and K1, fused; `seed_fn` replaces
    `ops.seed_device.seed_chain`); the others are seeded on the host and
    chained as above, and `--profile` counts them as `seed.host_frags`.

    With `opt.align_backend == "gpu"` and CIGARs on, the reads are
    aligned on a pool of up to 32 threads. Every extd2 or splice fill of
    at least `opt.align_tpu_min_mat` cells goes to a `TorchExtBatcher` on
    `device` (up to 64 fills a flush); smaller fills run inline on the
    host's native extension, the JAX package's placement rule. `ext_fn`
    and `exts2_fn` replace the extension function of every extd2 and
    splice flush (see `ops.ksw2_extd2.extd2_batch` and
    `ops.ksw2_exts2.exts2_batch`).

    With `mesh` (`parallel.mesh.make_mesh`) each bucket's B is rounded up
    to a multiple of the mesh size and its rows are split over the mesh's
    devices: on the 8 B delta wire (`sharded_chain_step8`) where
    `pack_tasks8` can pack the bucket, else on raw planes
    (`sharded_chain_step`), as the JAX package's mesh branch does.
    `device` must then be the mesh's first device, which runs device
    seeding and the extension batcher (the JAX package does not shard
    them either). `--profile` adds `mesh.shards` (shard launches) and
    `mesh.wire8` (buckets on the 8 B wire); `chain.bytes_up` counts the
    wire sent.

    A task whose span sum (`ops.chain_packed.score_bound`) could wrap
    K1/K2's int32 key is keyed in int64 by the kernels themselves, on
    every path; `--profile` counts it as `chain.wide_key`.

    The host work between the stages above is in leaf stages of its own:
    `seed.prep` (every read's prologue, one range a batch), `chain.plan`
    (a round's buckets), `chain.rechain` (the re-seed test; the re-seeded
    reads count as `chain.rechained`), `post.finish` (without the
    thread pool, every read's tail in one range) and `batch.free` (the
    reads' seeding and chaining state dropped)."""
    if opt.seed_backend == "tpu":
        raise NotImplementedError(
            "--seed-backend tpu runs the JAX package's device seeding; the "
            "port's is --seed-backend gpu")
    if opt.align_backend == "tpu":
        raise NotImplementedError(
            "--align-backend tpu runs the Pallas kernels; the port's "
            "device extension is --align-backend gpu")
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    if mesh is not None:
        if chain_fn is not None:
            raise ValueError("chain_fn replaces the single-device chaining "
                             "only; the mesh steps run the kernels")
        if mesh[0] != dev:
            raise ValueError("the run's device %s is not the mesh's first, "
                             "%s" % (dev, mesh[0]))
    use_dev_seed = opt.seed_backend == "gpu"
    with profiling.stage("seed.prep"):
        # a degenerate read's final result, or its context
        results: List[Optional[FragResult]] = [
            _frag_ctx(seqs, opt, qname)
            for seqs, qname in zip(frag_seqs, qnames)]
        ctxs = {i: c for i, c in enumerate(results)
                if isinstance(c, _FragCtx)}
        for i in ctxs:
            results[i] = None
    pending: List[int] = list(ctxs)
    _seed_first_pass(mi, opt, [ctxs[i] for i in pending],
                     seed_hits=not use_dev_seed)
    native_v = native.available()
    empty = np.zeros((0, 2), np.uint64)

    def run_round(idxs):
        outs = {}
        groups: dict = {}
        iter_cap = min(WINDOW, opt.max_chain_iter)
        with profiling.stage("chain.plan"):
            for i in idxs:
                ctx = ctxs[i]
                n = len(ctx.sr.anchors)
                if n == 0:
                    outs[i] = (np.zeros((0, 2), np.uint64),
                               np.zeros(0, np.uint64))
                    continue
                key = (ctx.gap_ref, ctx.gap_qry, opt.bw, iter_cap,
                       float(opt.chain_gap_scale), ctx.is_splice,
                       ctx.n_segs, bucket_for(n))
                groups.setdefault(key, []).append(i)
            plan = []
            for key, members in groups.items():
                for off in range(0, len(members), B_SIZES[-1]):
                    plan.append((key, members[off:off + B_SIZES[-1]]))

        def dispatch(job):
            key, chunk = job
            mdx, mdy, bw, iter_cap, gs, is_cdna, n_segs, N = key
            B = next(b for b in B_SIZES if b >= len(chunk))
            if mesh is not None:
                B = -(-B // len(mesh)) * len(mesh)
            tasks = [ctxs[i].sr.anchors for i in chunk] + \
                [empty] * (B - len(chunk))
            with profiling.stage("chain.device"):
                count_wide(tasks)
                if mesh is None:
                    planes = pack_tasks16(tasks, N)
                    wire8 = raw_p = False
                else:
                    # the JAX package's mesh branch: the 8 B wire where
                    # the bucket fits its exception budget, else the raw
                    # planes, whose step returns p itself
                    planes = pack_tasks8(tasks, N)
                    wire8 = planes is not None
                    raw_p = not wire8
                    if raw_p:
                        hi, lo, yhi, ylo, n_arr, avg = pack_tasks16(tasks, N)
                        planes = (hi, lo, *derive_qss(yhi, ylo), n_arr, avg)
                if profiling.enabled:
                    profiling.count("chain.launches")
                    profiling.count("chain.anchors",
                                    sum(len(t) for t in tasks))
                    profiling.count("chain.padded_anchors", B * N)
                    # the launch's serial DP steps: its longest row's n
                    profiling.count("chain.steps",
                                    max(len(t) for t in tasks))
                    profiling.count("chain.bytes_up",
                                    sum(a.nbytes for a in planes))
                    if mesh is not None:
                        profiling.count("mesh.shards", len(mesh))
                        profiling.count("mesh.wire8", int(wire8))
                with card_spans(on_cuda and profiling.enabled) as spans:
                    if mesh is not None:
                        out = _sharded_step(mesh, key, wire8)(*planes)
                    else:
                        f, prel = chain_scores_packed(
                            *planes_to_torch(*planes, dev), max_dist_x=mdx,
                            max_dist_y=mdy, bw=bw, iter_cap=iter_cap,
                            gap_scale=gs, is_cdna=is_cdna, n_segs=n_segs,
                            chain_fn=chain_fn)
                        out = gather((dev,), [(f, prel)])
            return chunk, out, spans, raw_p

        def consume(item):
            chunk, out, spans, raw_p = item
            with profiling.stage("chain.device"):
                f, pr = (t.numpy() for t in out.result())
            if spans:
                # the kernel launches' own spans (`ops.card_spans`)
                profiling.add("chain.gpu_busy", span_seconds(spans))
            with profiling.stage("chain.backtrack"):
                for row, i in enumerate(chunk):
                    anchors = ctxs[i].sr.anchors
                    n = len(anchors)
                    p = pr[row, :n] if raw_p else unpack_prel(pr[row], n)
                    v = _v_carry(native_v, f[row, :n], p)
                    outs[i] = chain_ref.chain_backtrack(
                        n, f[row, :n], p, v, anchors,
                        opt.min_cnt, opt.min_chain_score)

        inflight = deque()
        for job in plan:
            inflight.append(dispatch(job))
            if len(inflight) > 2:
                consume(inflight.popleft())
        while inflight:
            consume(inflight.popleft())
        return outs

    on_device = torch.cuda.device(dev) if on_cuda else \
        contextlib.nullcontext()
    with on_device:
        if use_dev_seed:
            elig = [i for i in pending if _seed_device_eligible(opt, ctxs[i])]
            outs = _seed_device_round(mi, opt, ctxs, elig, dev, seed_fn)
            rest = []
            for i in pending:
                if ctxs[i].sr is None:  # outside the contract, or too big
                    profiling.count("seed.host_frags")
                    with profiling.stage("seed"):
                        ctxs[i].sr = collect_seed_hits(
                            mi, opt, opt.mid_occ, ctxs[i].mv, ctxs[i].qname,
                            ctxs[i].qlen_sum)
                if i not in outs:
                    rest.append(i)
            outs.update(run_round(rest))
        else:
            outs = run_round(pending)
        with profiling.stage("chain.rechain"):
            rechain = [i for i in pending
                       if _needs_rechain(ctxs[i], opt, *outs[i])]
        for i in rechain:   # re-seeded (stage seed.hits) and chained again
            profiling.count("chain.rechained")
            ctxs[i].sr = collect_seed_hits(mi, opt, opt.max_occ, ctxs[i].mv,
                                           ctxs[i].qname, ctxs[i].qlen_sum)
        if rechain:
            outs.update(run_round(rechain))
    if opt.align_backend == "gpu" and (opt.flag & MM_F_CIGAR) and pending:
        batcher = TorchExtBatcher(dev, max_batch=64,
                                  min_cells=opt.align_tpu_min_mat,
                                  ext_fn=ext_fn, exts2_fn=exts2_fn)

        def post_one(i):
            with worker_scope(batcher):
                a, u = outs[i]
                return _post_chain(mi, ctxs[i], opt, a, u)

        with _count_host_fills(), \
                ThreadPoolExecutor(min(32, len(pending))) as ex:
            for i, res in zip(pending, ex.map(post_one, pending)):
                results[i] = res
    else:
        # every read's regions and alignment, then all their tails in one
        # `post.finish` range
        regss = [_post_align(mi, ctxs[i], opt,
                             _post_regions(mi, ctxs[i], opt, *outs[i]),
                             outs[i][0]) for i in pending]
        with profiling.stage("post.finish"):
            for i, regs in zip(pending, regss):
                results[i] = _post_finish(ctxs[i], opt, regs, outs[i][0])
    with profiling.stage("batch.free"):   # the reads' seeds and chains
        ctxs.clear()
        outs.clear()
    return results
