"""Batched mapping with the chaining DP, and optionally the extension
fills, on a torch device.

Counterpart of `mm2tpu/mapping/pipeline.py::map_frags_batched` (its
single-device, host-seeded branch). The per-fragment stages around the
chaining call are the port's verbatim copies of that module's
`FragResult`, `_FragCtx`, `_prepare` (seeding), `_needs_rechain` (the
re-seed trigger), `_post_chain` (everything after chaining) and
`_align_regs`, with `BUCKETS`/`bucket_for` from
`mm2tpu/parallel/batching.py`. The JAX package's `map_frag`, device
seeding and mesh steps are not copied. The per-bucket chaining call
changes, and with `--align-backend gpu` the reads are aligned on a
thread pool whose extension fills meet in a `TorchExtBatcher`.
"""
from __future__ import annotations

import contextlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..index.build import MMIndex
from ..native import lib as native
from ..ops import chain_ref
from ..ops.chain_packed import (WINDOW, chain_scores_packed, pack_tasks16,
                                planes_to_torch, unpack_prel, v_carry_host)
from ..options import (MapOptions, MM_F_SPLICE, MM_F_SR, MM_F_CIGAR,
                       MM_F_ALL_CHAINS, MM_F_HARD_MLEVEL,
                       MM_SEED_SEG_MASK, MM_MAX_SEG)
from ..utils import profiling
from ..utils.hashing import reg_hash
from . import hit as hit_mod
from .chain import chain_gaps
from .esterr import est_err
from .extbatch import TorchExtBatcher, worker_scope
from .hit import Region
from .seed import collect_minimizers, collect_seed_hits

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


def _prepare(mi: MMIndex, seqs: Sequence[str], opt: MapOptions,
             qname: Optional[str], seed_hits: bool = True):
    """Seeding stage of mm_map_frag (map.c:272-316). Returns a _FragCtx,
    or a final FragResult for degenerate inputs. With seed_hits=False
    only the minimizers are collected (ctx.sr stays None — the batched
    device-seeding path fills it from the chip)."""
    n_segs = len(seqs)
    qlens = [len(s) for s in seqs]
    qlen_sum = sum(qlens)
    if qlen_sum == 0 or n_segs <= 0 or n_segs > MM_MAX_SEG or \
            (opt.max_qlen > 0 and qlen_sum > opt.max_qlen):
        return FragResult(regs=[[] for _ in range(max(n_segs, 0))])
    hash_ = reg_hash(qname, qlen_sum, opt.seed)
    with profiling.stage("seed"):
        mv = collect_minimizers(mi, opt, seqs, qlens)
        sr = (collect_seed_hits(mi, opt, opt.mid_occ, mv, qname, qlen_sum)
              if seed_hits else None)
    gap_qry, gap_ref = chain_gaps(opt, qlen_sum)
    return _FragCtx(seqs=seqs, qlens=qlens, qlen_sum=qlen_sum, qname=qname,
                    hash_=hash_, is_splice=bool(opt.flag & MM_F_SPLICE),
                    is_sr=bool(opt.flag & MM_F_SR), n_segs=n_segs,
                    mv=mv, sr=sr, gap_qry=gap_qry, gap_ref=gap_ref)


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


def _post_chain(mi: MMIndex, ctx: _FragCtx, opt: MapOptions,
                a: np.ndarray, u: np.ndarray) -> FragResult:
    """Everything after chaining (map.c:344-391)."""
    n_segs, qlens, qlen_sum = ctx.n_segs, ctx.qlens, ctx.qlen_sum
    seqs, hash_, sr, is_sr = ctx.seqs, ctx.hash_, ctx.sr, ctx.is_sr
    max_chain_gap_ref = ctx.gap_ref
    res = FragResult(regs=[[] for _ in range(n_segs)])
    res.rep_len = sr.rep_len
    res.frag_gap = max_chain_gap_ref

    from ..options import MM_F_ALL_CHAINS as _ALL
    fast = None
    if (not mi.n_alt and n_segs == 1 and not opt.dbg_print_seed and
            not (opt.flag & _ALL)):
        with profiling.stage("post"):
            fast = hit_mod.gen_regs_chain_post_fast(
                hash_, qlen_sum, u, a, opt, mi.k * 2)
    if fast is not None:
        with profiling.stage("post"):
            regs0 = hit_mod.chain_post_tail(fast, opt, qlen_sum, a)
            if not is_sr:
                est_err(mi, qlen_sum, regs0, a, sr.mini_pos)
    else:
        regs0 = hit_mod.gen_regs(hash_, qlen_sum, u, a)
        if mi.n_alt:
            hit_mod.mark_alt(mi, regs0)
            regs0 = hit_mod.hit_sort(regs0, opt.alt_drop)
        if opt.dbg_print_seed:
            for j, r in enumerate(regs0):
                for i in range(r.as_, r.as_ + r.cnt):
                    _dump_anchor(("CN", j), mi, a, i, i == r.as_)

        with profiling.stage("post"):
            regs0 = hit_mod.chain_post(regs0, opt, max_chain_gap_ref, mi,
                                       qlen_sum, n_segs, qlens, a)
            if not is_sr:
                est_err(mi, qlen_sum, regs0, a, sr.mini_pos)

    if n_segs == 1:
        regs0 = _align_regs(mi, opt, qlens[0], seqs[0], regs0, a)
        hit_mod.set_mapq(regs0, opt.min_chain_score, opt.a, sr.rep_len, is_sr)
        res.regs[0] = regs0
    else:
        from .seg import seg_gen
        segs = seg_gen(hash_, qlens, regs0, a)
        for i in range(n_segs):
            regs_i = segs[i].regs
            hit_mod.set_parent(regs_i, opt.mask_level, opt.mask_len,
                               opt.a * 2 + opt.b,
                               bool(opt.flag & MM_F_HARD_MLEVEL), opt.alt_drop)
            regs_i = _align_regs(mi, opt, qlens[i], seqs[i], regs_i, segs[i].a)
            hit_mod.set_mapq(regs_i, opt.min_chain_score, opt.a, sr.rep_len, is_sr)
            res.regs[i] = regs_i
        if n_segs == 2 and opt.pe_ori >= 0 and (opt.flag & MM_F_CIGAR):
            from .pe import pair
            pair(max_chain_gap_ref, opt.pe_bonus, opt.a * 2 + opt.b, opt.a,
                 qlens, res.regs)
    res.anchors = a
    return res


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


def map_frags_batched(mi: MMIndex, frag_seqs: Sequence[Sequence[str]],
                      opt: MapOptions, qnames: Sequence[Optional[str]],
                      device, *, chain_fn=None, ext_fn=None,
                      exts2_fn=None) -> List[FragResult]:
    """Map many fragments with batched chaining on `device` ("cuda" or
    "cpu"): fragments are seeded on the host, their anchor arrays grouped
    into fixed (B, N) buckets, and each bucket chained in one call, then
    backtracked and post-processed on the host. Output equals
    `mm2tpu.mapping.pipeline.map_frags_batched` on one device.

    On CUDA, chunk k+1 is packed and launched while chunk k's results
    come back: the launch and a non-blocking copy into pinned host
    memory go on the current stream, and a CUDA event tells the host
    when the copy is done. With `--profile` on, CUDA events also time
    each bucket's chaining on the card (stage `chain.gpu_busy`), and
    `chain.steps` counts the launches' serial DP steps (each launch's
    longest row: the chaining kernel stops every row at its n).
    Single-segment non-cDNA tasks chain on K1, every other task (read
    pairs, spliced reads) on K2. `chain_fn` replaces the chaining
    function (see `ops.chain_packed.chain_scores_packed`).

    With `opt.align_backend == "gpu"` and CIGARs on, the reads are
    aligned on a pool of up to 32 threads. Every extd2 or splice fill of
    at least `opt.align_tpu_min_mat` cells goes to a `TorchExtBatcher` on
    `device` (up to 64 fills a flush); smaller fills run inline on the
    host's native extension, the JAX package's placement rule. `ext_fn`
    and `exts2_fn` replace the extension function of every extd2 and
    splice flush (see `ops.ksw2_extd2.extd2_batch` and
    `ops.ksw2_exts2.exts2_batch`)."""
    if opt.seed_backend == "tpu":
        raise NotImplementedError(
            "device seeding (--seed-backend tpu) is not ported yet "
            "(ROADMAP M7)")
    if opt.align_backend == "tpu":
        raise NotImplementedError(
            "--align-backend tpu runs the Pallas kernels; the port's "
            "device extension is --align-backend gpu")
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    results: List[Optional[FragResult]] = [None] * len(frag_seqs)
    ctxs: dict = {}
    pending: List[int] = []
    for i, (seqs, qname) in enumerate(zip(frag_seqs, qnames)):
        prep = _prepare(mi, seqs, opt, qname)
        if isinstance(prep, FragResult):
            results[i] = prep
        else:
            ctxs[i] = prep
            pending.append(i)
    native_v = native.available()
    empty = np.zeros((0, 2), np.uint64)

    def run_round(idxs):
        outs = {}
        groups: dict = {}
        for i in idxs:
            ctx = ctxs[i]
            n = len(ctx.sr.anchors)
            if n == 0:
                outs[i] = (np.zeros((0, 2), np.uint64),
                           np.zeros(0, np.uint64))
                continue
            iter_cap = min(WINDOW, opt.max_chain_iter)
            key = (ctx.gap_ref, ctx.gap_qry, opt.bw, iter_cap,
                   float(opt.chain_gap_scale), ctx.is_splice, ctx.n_segs,
                   bucket_for(n))
            groups.setdefault(key, []).append(i)
        plan = []
        for key, members in groups.items():
            for off in range(0, len(members), B_SIZES[-1]):
                plan.append((key, members[off:off + B_SIZES[-1]]))

        def dispatch(job):
            key, chunk = job
            mdx, mdy, bw, iter_cap, gs, is_cdna, n_segs, N = key
            B = next(b for b in B_SIZES if b >= len(chunk))
            tasks = [ctxs[i].sr.anchors for i in chunk] + \
                [empty] * (B - len(chunk))
            with profiling.stage("chain.device"):
                if profiling.enabled:
                    profiling.count("chain.launches")
                    profiling.count("chain.anchors",
                                    sum(len(t) for t in tasks))
                    profiling.count("chain.padded_anchors", B * N)
                    # the launch's serial DP steps: its longest row's n
                    profiling.count("chain.steps",
                                    max(len(t) for t in tasks))
                    profiling.count("chain.bytes_up", 16 * B * N + 8 * B)
                planes = planes_to_torch(*pack_tasks16(tasks, N), dev)
                busy = None
                if on_cuda and profiling.enabled:
                    busy = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                    busy[0].record()
                f, prel = chain_scores_packed(
                    *planes, max_dist_x=mdx, max_dist_y=mdy, bw=bw,
                    iter_cap=iter_cap, gap_scale=gs, is_cdna=is_cdna,
                    n_segs=n_segs, chain_fn=chain_fn)
                if busy is not None:
                    busy[1].record()
                done = None
                if on_cuda:
                    f_h = torch.empty(f.shape, dtype=f.dtype,
                                      pin_memory=True)
                    pr_h = torch.empty(prel.shape, dtype=prel.dtype,
                                       pin_memory=True)
                    f_h.copy_(f, non_blocking=True)
                    pr_h.copy_(prel, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                    f, prel = f_h, pr_h
            return chunk, f, prel, done, busy

        def consume(item):
            chunk, f, pr, done, busy = item
            with profiling.stage("chain.device"):
                if done is not None:
                    done.synchronize()
                f = f.numpy()
                pr = pr.numpy()
            if profiling.enabled:
                profiling.count("chain.bytes_down", f.nbytes + pr.nbytes)
            if busy is not None:
                # card time from the first op after the upload to the
                # last op before the copy back (host enqueue gaps included)
                profiling.add("chain.gpu_busy",
                              busy[0].elapsed_time(busy[1]) / 1e3)
            with profiling.stage("chain.backtrack"):
                for row, i in enumerate(chunk):
                    anchors = ctxs[i].sr.anchors
                    n = len(anchors)
                    p = unpack_prel(pr[row], n)
                    if native_v:
                        v = native.v_carry(f[row, :n], p)
                    else:
                        v = v_carry_host(f[row:row + 1, :n], p[None])[0]
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
        outs = run_round(pending)
        rechain = []
        for i in pending:
            a, u = outs[i]
            if _needs_rechain(ctxs[i], opt, a, u):
                ctxs[i].sr = collect_seed_hits(mi, opt, opt.max_occ,
                                               ctxs[i].mv, ctxs[i].qname,
                                               ctxs[i].qlen_sum)
                rechain.append(i)
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
        for i in pending:
            a, u = outs[i]
            results[i] = _post_chain(mi, ctxs[i], opt, a, u)
    return results
