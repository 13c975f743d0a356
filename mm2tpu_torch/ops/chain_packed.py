"""Chaining on the 16 B/anchor wire planes.

Counterpart of `mm2tpu/ops/chain_packed.py`: the host packs each task's
(x, y) uint64 anchor words into four int32 planes (hi, lo, yhi, ylo);
on the device `derive_qss` extracts qi/span/sid from y, the kernel of
the task's contract scores the batch, and `p_rel` compresses p to a
relative int16 for the copy back. As in the JAX package, a
single-segment non-cDNA batch goes to the v3 kernel (K1, `chain_v3`)
and every other batch to the v2 kernel (K2, `chain_v2`); the JAX
package's `B % 8 == 0` clause always holds for the port's batch sizes.
The 8 B delta wire of the JAX package (`pack_tasks8`, `_decode8`) is not
ported: it was built for a narrow TPU link and yields the same f/prel
as this wire.

`chain_scores_task` chains one task at B = 1, the counterpart of
`mm2tpu/ops/chain_pallas_v2.py::chain_scores_tpu_v2`, for the stream
mode's device route. `pack_tasks16`, `unpack_prel` and `v_carry_host`
are NumPy code copied verbatim from the JAX package, whose modules
load JAX when they are imported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from . import card_spans, chain_v2, chain_v3, span_seconds
from .chain_v3 import WINDOW


def derive_qss(yhi, ylo):
    """qi/span/sid from the split y word (pack_anchors semantics)."""
    qi = ylo
    span = yhi & 0xFF
    sid = (yhi >> 16) & 0xFF
    return qi, span, sid


def p_rel(p):
    """Relative-predecessor compression: int32 absolute -> int16 rel
    (0 = no predecessor)."""
    i = torch.arange(p.shape[-1], dtype=torch.int32, device=p.device)
    return torch.where(p >= 0, i - p, 0).to(torch.int16)


def chain_scores(hi, lo, qi, span, sid, n, avg, *, max_dist_x: int,
                 max_dist_y: int, bw: int, iter_cap: int, gap_scale: float,
                 is_cdna: bool, n_segs: int, plain: bool = False):
    """Chaining scores (f, p), (B, N) int32, by contract: the
    single-segment non-cDNA contract on `chain_v3` (K1), every other on
    `chain_v2` (K2). Their wrappers run the plain versions on CPU
    tensors; `plain=True` runs the plain versions on any device."""
    kw = dict(max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
              iter_cap=iter_cap, gap_scale=gap_scale)
    if not is_cdna and n_segs == 1:
        fn = chain_v3.chain_scores_v3_reference if plain \
            else chain_v3.chain_scores_v3
        return fn(hi, lo, qi, span, n, avg, **kw)
    fn = chain_v2.chain_scores_v2_reference if plain \
        else chain_v2.chain_scores_v2
    return fn(hi, lo, qi, span, sid, n, avg, is_cdna=is_cdna,
              n_segs=n_segs, **kw)


def chain_scores_plain(*args, **kw):
    """`chain_scores` through the plain versions, on any device."""
    return chain_scores(*args, plain=True, **kw)


def chain_scores_packed(hi, lo, yhi, ylo, n, avg, *, max_dist_x: int,
                        max_dist_y: int, bw: int, iter_cap: int,
                        gap_scale: float, is_cdna: bool, n_segs: int,
                        chain_fn=None):
    """Batched chaining on the wire planes: (B, N) int32 hi/lo/yhi/ylo,
    (B, 1) n and avg. Returns (f int32, prel int16), both (B, N).
    `chain_fn` (default `chain_scores`) takes `chain_scores`'s arguments;
    `chain_scores_plain` runs the plain versions of both contracts on any
    device."""
    fn = chain_scores if chain_fn is None else chain_fn
    qi, span, sid = derive_qss(yhi, ylo)
    f, p = fn(hi, lo, qi.contiguous(), span.contiguous(), sid.contiguous(),
              n, avg, max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
              iter_cap=iter_cap, gap_scale=gap_scale, is_cdna=is_cdna,
              n_segs=n_segs)
    return f, p_rel(p)


def planes_to_torch(*arrays_then_device):
    """NumPy arrays (`pack_tasks16`'s planes, or device seeding's) as
    tensors on the device given last. A CUDA upload goes through pinned
    memory and does not block the host."""
    *arrays, device = arrays_then_device
    dev = torch.device(device)
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out.append(t)
    return tuple(out)


def chain_scores_task(a: np.ndarray, max_dist_x: int, max_dist_y: int,
                      bw: int, max_iter: int, gap_scale: float,
                      is_cdna: bool, n_segs: int, *, device):
    """One task's chaining on `device`: its (n, 2) uint64 anchors packed
    at B = 1, N = max(1024, ceil(n / 1024) * 1024), scored by
    `chain_scores` (on a CUDA tensor K1 for the single-segment non-cDNA
    contract and K2 for every other; on a CPU tensor their plain
    versions), then v by `v_carry_host`. Returns (f int32, p int64, v)
    like the host DPs. The JAX package sends every contract to its v2
    kernel; K1 computes the same contract
    (`chain_ref.chain_scores_window`) for the tasks it takes. Under
    --profile the task adds to `chain.launches`, `chain.anchors`,
    `chain.padded_anchors`, `chain.steps` and, on CUDA, `chain.gpu_busy`
    (the kernel launch's own span, `ops.card_spans`: events around the
    whole task would also hold the work other mapping threads queue in
    between)."""
    n = len(a)
    N = max(WINDOW, -(-n // WINDOW) * WINDOW)
    dev = torch.device(device)
    on = dev.type == "cuda" and profiling.enabled
    with profiling.stage("chain.device"):
        if profiling.enabled:
            profiling.count("chain.launches")
            profiling.count("chain.anchors", n)
            profiling.count("chain.padded_anchors", N)
            profiling.count("chain.steps", n)
            profiling.count("chain.bytes_up", 16 * N + 8)
        hi, lo, yhi, ylo, n_arr, avg = planes_to_torch(
            *pack_tasks16([a], N), dev)
        qi, span, sid = derive_qss(yhi, ylo)
        with card_spans(on) as spans:
            f, p = chain_scores(hi, lo, qi.contiguous(), span.contiguous(),
                                sid.contiguous(), n_arr, avg,
                                max_dist_x=max_dist_x, max_dist_y=max_dist_y,
                                bw=bw, iter_cap=min(WINDOW, max_iter),
                                gap_scale=float(gap_scale),
                                is_cdna=bool(is_cdna), n_segs=int(n_segs))
        f = f[:, :n].cpu().numpy()
        p = p[:, :n].cpu().numpy().astype(np.int64)
    if spans:
        profiling.add("chain.gpu_busy", span_seconds(spans))
    if profiling.enabled:
        profiling.count("chain.bytes_down", 8 * n)
    v = v_carry_host(f, p)
    return f[0], p[0], v[0]


# ---- copied verbatim from mm2tpu/ops/chain_packed.py ----

def unpack_prel(prel_row: np.ndarray, n: int) -> np.ndarray:
    """Host-side inverse of _p_rel for one row truncated to n."""
    rel = np.asarray(prel_row[:n], dtype=np.int32)
    i = np.arange(n, dtype=np.int32)
    return np.where(rel > 0, i - rel, -1)


def pack_tasks16(tasks, N: int):
    """Pack anchor arrays into the four 16 B/anchor wire planes +
    (n, avg) scalars. Padding rows carry the never-matching hi sentinel
    (pack_anchors:202)."""
    from .chain_ref import avg_qspan_scaled
    B = len(tasks)
    hi = np.full((B, N), -0x7FFFFF0, np.int32)
    lo = np.zeros((B, N), np.int32)
    yhi = np.zeros((B, N), np.int32)
    ylo = np.zeros((B, N), np.int32)
    n_arr = np.zeros((B, 1), np.int32)
    avg_arr = np.zeros((B, 1), np.float32)
    for b, a in enumerate(tasks):
        m = len(a)
        if m == 0:
            continue
        x = a[:, 0]
        y = a[:, 1]
        hi[b, :m] = (x >> np.uint64(32)).astype(np.uint32).view(np.int32)
        lo[b, :m] = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32) \
            .view(np.int32)
        yhi[b, :m] = (y >> np.uint64(32)).astype(np.uint32).view(np.int32)
        ylo[b, :m] = (y & np.uint64(0xFFFFFFFF)).astype(np.uint32) \
            .view(np.int32)
        n_arr[b, 0] = m
        avg_arr[b, 0] = avg_qspan_scaled(a)
    return hi, lo, yhi, ylo, n_arr, avg_arr


# ---- copied verbatim from mm2tpu/ops/chain_pallas_v2.py ----

def v_carry_host(f: np.ndarray, p: np.ndarray) -> np.ndarray:
    """v[i] = max f along the predecessor chain — host-side vectorized
    pointer doubling over (B, N) batches (chain.c:110 semantics)."""
    B, N = f.shape
    idx = np.broadcast_to(np.arange(N, dtype=np.int64), (B, N))
    ptr = np.where(p >= 0, p, idx).astype(np.int64)
    v = f.copy()
    steps = max(1, int(np.ceil(np.log2(max(N, 2)))))
    for _ in range(steps):
        v = np.maximum(v, np.take_along_axis(v, ptr, axis=1))
        ptr = np.take_along_axis(ptr, ptr, axis=1)
    return v


__all__ = ["chain_scores", "chain_scores_packed", "chain_scores_plain",
           "chain_scores_task",
           "derive_qss", "p_rel", "planes_to_torch", "pack_tasks16",
           "unpack_prel", "v_carry_host", "WINDOW"]
