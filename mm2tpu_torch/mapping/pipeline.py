"""Batched mapping with the chaining DP, and optionally the extension
fills, on a torch device.

Counterpart of `mm2tpu/mapping/pipeline.py::map_frags_batched` (its
single-device, host-seeded branch). Seeding, the re-seed trigger and
everything after chaining are the JAX package's host code, imported as
is; the per-bucket chaining call changes, and with `--align-backend gpu`
the reads are aligned on a thread pool whose extension fills meet in a
`TorchExtBatcher`.
"""
from __future__ import annotations

import contextlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from mm2tpu.index.build import MMIndex
from mm2tpu.mapping.extbatch import worker_scope
from mm2tpu.mapping.pipeline import (FragResult, _needs_rechain,
                                     _post_chain, _prepare)
from mm2tpu.mapping.seed import collect_seed_hits
from mm2tpu.ops import chain_ref
from mm2tpu.options import MM_F_CIGAR, MapOptions
from mm2tpu.parallel.batching import bucket_for

from ..device import resolve_device
from ..ops.chain_packed import (WINDOW, chain_scores_packed, pack_tasks16,
                                planes_to_torch, unpack_prel, v_carry_host)
from ..utils import native, profiling
from .extbatch import TorchExtBatcher

# the batch sizes of the JAX package, kept so both packages form the same
# batches (a task's chaining does not depend on its batch either way)
B_SIZES = (8, 16, 32, 64, 128)


@contextlib.contextmanager
def _count_host_fills():
    """Under --profile, count the fills that stay on the host's native
    extension (below `--align-tpu-min-mat`) as `ext.host_fills`. The JAX
    package's align code looks its native entry points up on
    `mm2tpu.native.lib` at each call: `ksw_extd2` and `ksw_extd2_fill_ref`
    run one fill, `ksw_fill_walk` a read's whole seed-gap walk (it
    returns how many fills it ran first). They are wrapped for the
    duration, in this process only."""
    if not profiling.enabled:
        yield
        return
    per_call = {"ksw_extd2": lambda out: 1,
                "ksw_extd2_fill_ref": lambda out: 1,
                "ksw_fill_walk": lambda out: out[0]}
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
                      device, *, chain_fn=None,
                      ext_fn=None) -> List[FragResult]:
    """Map many fragments with batched chaining on `device` ("cuda" or
    "cpu"): fragments are seeded on the host, their anchor arrays grouped
    into fixed (B, N) buckets, and each bucket chained in one call, then
    backtracked and post-processed on the host. Output equals
    `mm2tpu.mapping.pipeline.map_frags_batched` on one device.

    On CUDA, chunk k+1 is packed and launched while chunk k's results
    come back: the launch and a non-blocking copy into pinned host
    memory go on the current stream, and a CUDA event tells the host
    when the copy is done. With `--profile` on, CUDA events also time
    each bucket's chaining on the card (stage `chain.gpu_busy`).
    `chain_fn` replaces the chaining function (see
    `ops.chain_packed.chain_scores_packed`).

    With `opt.align_backend == "gpu"` and CIGARs on, the reads are
    aligned on a pool of up to 32 threads. Every extd2 fill of at least
    `opt.align_tpu_min_mat` cells goes to a `TorchExtBatcher` on `device`
    (up to 64 fills a flush); smaller fills run inline on the host's
    native extension, the JAX package's placement rule. `ext_fn`
    replaces the extension function of every flush (see
    `ops.ksw2_extd2.extd2_batch`)."""
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
                                  ext_fn=ext_fn)

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
