"""Chaining on the wire planes: 16 B an anchor, or the 8 B delta wire.

Counterpart of `mm2tpu/ops/chain_packed.py`: the host packs each task's
(x, y) uint64 anchor words into four int32 planes (hi, lo, yhi, ylo);
on the device `derive_qss` extracts qi/span/sid from y, the kernel of
the task's contract scores the batch, and `p_rel` compresses p to a
relative int16 for the copy back. As in the JAX package, a
single-segment non-cDNA batch goes to the v3 kernel (K1, `chain_v3`)
and every other batch to the v2 kernel (K2, `chain_v2`); the JAX
package's `B % 8 == 0` clause always holds for the port's batch sizes.

The 8 B delta wire (`pack_tasks8`, `decode8`, `chain_scores_packed8`)
carries the same planes in half the bytes: a uint16 delta of lo, qi, and
span | sid << 8 an anchor, with a side channel of exceptions where a
delta overflows or hi changes. `decode8` rebuilds hi, lo, qi, span and
sid with torch ops on the planes' device (a scatter-add and a cumsum for
lo, a scatter-amax and a cummax for the biased hi), in place of the JAX
package's `_decode8`, which is XLA glue and no Pallas kernel. The mesh
steps (`parallel/mesh.py`) use it wherever the JAX package's mesh path
does; the single-device batch path keeps the 16 B wire.

Score overflow. K1 and K2 pick a predecessor by the key sc * 1024 +
(1024 - d), which in int32, as the Pallas kernels hold it, wraps without
an error once sc passes `KEY_SCORE_MAX`. `score_bound` (a task's span
sum) bounds its scores; the kernels and their plain versions sum each
row's spans themselves and key a row over the bound in int64, which
gives `chain_ref.chain_scores_window`'s f and p on every device
chaining site, with no host route. `count_wide` counts such tasks under
--profile as `chain.wide_key`. The JAX package keeps the int32 key, so
on such tasks its device paths give wrapped scores where the port's give
the contract's.

`chain_scores_task` chains one task at B = 1, the counterpart of
`mm2tpu/ops/chain_pallas_v2.py::chain_scores_tpu_v2`, for the stream
mode's device route. `pack_tasks16`, `pack_tasks8` with `E_LADDER`,
`unpack_prel` and `v_carry_host` are NumPy code copied verbatim from the
JAX package, whose modules load JAX when they are imported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from . import card_spans, chain_v2, chain_v3, count_lock, span_seconds
from .chain_v3 import KEY_SCORE_MAX, WINDOW

INT32_MIN = -(1 << 31)

# K1/K2 launches on the 8 B wire (`chain_scores_packed8` on CUDA tensors)
launches8 = 0


def score_bound(a: np.ndarray) -> int:
    """An upper bound of the largest chaining score of the task with the
    (n, 2) uint64 anchors `a`: the sum of their spans. A step adds at most
    its anchor's span to its predecessor's score (min(dq, dr, span) less
    a gap cost >= 0, or 1 at the pair bonus, where dr = 0), so f <= the
    span sum. The int32 key sc * 1024 + (1024 - d) is exact while sc *
    1024 + 1024 <= 2^31 - 1, that is sc <= KEY_SCORE_MAX = 2^21 - 2 =
    2,097,150; K1 and K2 key a task whose bound exceeds it in int64."""
    return int(((a[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).sum())


def count_wide(tasks) -> None:
    """Under --profile, count as `chain.wide_key` the tasks (anchor
    arrays) that K1/K2 key in int64: those whose `score_bound` exceeds
    KEY_SCORE_MAX."""
    if profiling.enabled:
        k = sum(score_bound(a) > KEY_SCORE_MAX for a in tasks)
        if k:
            profiling.count("chain.wide_key", k)


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


def _u16(t):
    """A uint16 plane (or its int16 view) as int32 values 0..65535."""
    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    return t.to(torch.int32) & 0xFFFF


def decode8(d, qi, spansid, exc_pos, exc_c, exc_hib):
    """The inverse of `pack_tasks8` on the planes' device (the JAX
    package's `_decode8`): lo = cumsum of the deltas with the
    corrections scatter-added at the exception positions, hi = cummax of
    the biased hi scattered there (-2^31 elsewhere), unbiased. d and
    spansid (B, N) uint16 (or their int16 views), qi (B, N) int32,
    exc_* (B, E) int32; a position of N marks an unused exception slot
    (the JAX scatter's mode="drop"), which lands in a spare column.
    Returns hi, lo, qi, span, sid, contiguous (B, N) int32."""
    B, N = d.shape
    dev = d.device
    pos = exc_pos.to(torch.int64)
    c = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    c[:, :N] = _u16(d)
    c.scatter_add_(1, pos, exc_c.to(torch.int64))
    lo = torch.cumsum(c[:, :N], dim=1)
    # the JAX cumsum runs in int32 and wraps; so does this, mod 2^32
    lo = ((lo - INT32_MIN) % (1 << 32) + INT32_MIN).to(torch.int32)
    hib = torch.full((B, N + 1), INT32_MIN, dtype=torch.int32, device=dev)
    hib.scatter_reduce_(1, pos, exc_hib, reduce="amax")
    hi = torch.cummax(hib[:, :N], dim=1).values ^ INT32_MIN
    s = _u16(spansid)
    return (hi.contiguous(), lo, qi.contiguous(), (s & 0xFF).contiguous(),
            (s >> 8).contiguous())


def chain_scores_packed8(d, qi, spansid, exc_pos, exc_c, exc_hib, n, avg,
                         *, max_dist_x: int, max_dist_y: int, bw: int,
                         iter_cap: int, gap_scale: float, is_cdna: bool,
                         n_segs: int, chain_fn=None):
    """`chain_scores_packed` on the 8 B delta wire: `pack_tasks8`'s planes
    as tensors on one device, decoded there by `decode8` and scored by
    `chain_scores` (K1 for the single-segment non-cDNA contract, K2 for
    every other), or by `chain_fn`, which takes its arguments. Returns (f
    int32, prel int16), (B, N). A launch on CUDA without `chain_fn` adds
    one to `launches8`."""
    global launches8
    fn = chain_scores if chain_fn is None else chain_fn
    hi, lo, qi, span, sid = decode8(d, qi, spansid, exc_pos, exc_c, exc_hib)
    f, p = fn(
        hi, lo, qi, span, sid, n, avg, max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
        iter_cap=iter_cap, gap_scale=gap_scale, is_cdna=is_cdna,
        n_segs=n_segs)
    if d.device.type == "cuda" and chain_fn is None:
        with count_lock:
            launches8 += 1
    return f, p_rel(p)


def planes_to_torch(*arrays_then_device):
    """NumPy arrays (`pack_tasks16`'s or `pack_tasks8`'s planes, or device
    seeding's) as tensors on the device given last. A CUDA upload goes
    through pinned memory and does not block the host."""
    *arrays, device = arrays_then_device
    dev = torch.device(device)
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        # uint16 planes (the 8 B wire's) go as their int16 views
        t = torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                             else a)
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
    --profile the task adds to `chain.wide_key` (`count_wide`),
    `chain.launches`, `chain.anchors`,
    `chain.padded_anchors`, `chain.steps` and, on CUDA, `chain.gpu_busy`
    (the kernel launch's own span, `ops.card_spans`: events around the
    whole task would also hold the work other mapping threads queue in
    between)."""
    n = len(a)
    N = max(WINDOW, -(-n // WINDOW) * WINDOW)
    dev = torch.device(device)
    on = dev.type == "cuda" and profiling.enabled
    with profiling.stage("chain.device"):
        count_wide([a])
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


# ---- copied verbatim from mm2tpu/ops/chain_packed.py ----

# exception-slot ladder (hi changes + big lo jumps per task row):
# repeat-rich reads hit many loci, so their x streams carry hundreds of
# >64 KiB jumps; the second tier keeps them on the 8 B wire (the side
# channel is still <=19% of the planes at N=4096). Beyond that, fall
# back to the 16 B path. Fixed tiers bound the jit shape count at two.
E_LADDER = (128, 512)


def pack_tasks8(tasks, N: int):
    """Delta-packed 8 B/anchor up-plane (VERDICT r4 item 4): anchors are
    x-sorted, so the top word hi (strand|rid) is non-decreasing under a
    sign-bias and the low word delta-encodes to uint16 almost everywhere.

    Per-anchor wire: d uint16 (lo delta) + qi int32 + spansid uint16
    = 8 B, plus an (B, E) exception side-channel carrying absolute
    (pos, lo-correction, biased-hi) triples wherever the delta overflows
    or hi changes; E is the smallest E_LADDER tier that fits the whole
    batch (fixed tiers keep the jit shape count at two). Decode on
    device is one cumsum + one cummax fused into the kernel's jit
    (_decode8).

    Returns None if any row needs more than max(E_LADDER) exceptions —
    the caller falls back to pack_tasks16 (same results, wider wire)."""
    from .chain_ref import avg_qspan_scaled
    B = len(tasks)
    SENT_HI = -0x7FFFFF0  # never-matching pad sentinel (pack_anchors:202)
    BIAS = np.uint32(0x80000000)
    d = np.zeros((B, N), np.uint16)
    qi = np.zeros((B, N), np.int32)
    spansid = np.zeros((B, N), np.uint16)
    n_arr = np.zeros((B, 1), np.int32)
    avg_arr = np.zeros((B, 1), np.float32)
    sent_hib = int((np.array(SENT_HI, np.int32).view(np.uint32) ^ BIAS)
                   .view(np.int32))
    per_row = []  # (idx, c, hib, m, last_lo) for the fill pass
    k_max = 0
    for b, a in enumerate(tasks):
        m = len(a)
        n_arr[b, 0] = m
        if m:
            avg_arr[b, 0] = avg_qspan_scaled(a)
        x = a[:, 0] if m else np.zeros(0, np.uint64)
        y = a[:, 1] if m else np.zeros(0, np.uint64)
        hi_u = (x >> np.uint64(32)).astype(np.uint32)
        lo_i = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        hib = (hi_u ^ BIAS).view(np.int32)
        yhi = (y >> np.uint64(32)).astype(np.uint32).view(np.int32)
        qi[b, :m] = (y & np.uint64(0xFFFFFFFF)).astype(np.uint32) \
            .view(np.int32)
        spansid[b, :m] = ((yhi & 0xFF) | (((yhi >> 16) & 0xFF) << 8)) \
            .astype(np.uint16)
        # exception positions: first anchor, hi changes, lo-delta
        # overflow/negative, and the first pad cell (restores the
        # sentinel hi and zero lo of the padded region)
        c = np.zeros(m, np.int64)
        if m:
            c[0] = int(lo_i[0])
            c[1:] = lo_i[1:].astype(np.int64) - lo_i[:-1].astype(np.int64)
        need = np.zeros(m, bool)
        if m:
            need[0] = True
            need[1:] |= hib[1:] != hib[:-1]
            need |= (c < 0) | (c > 0xFFFF)
        idx = np.flatnonzero(need)
        k = len(idx) + (1 if m < N else 0)
        if k > E_LADDER[-1]:
            return None
        k_max = max(k_max, k)
        fit = ~need
        d[b, :m][fit] = c[fit].astype(np.uint16)
        per_row.append((idx, c, hib, m,
                        int(lo_i[m - 1]) if m else 0))
    E = next(e for e in E_LADDER if e >= k_max)
    exc_pos = np.full((B, E), N, np.int32)   # N = out-of-bounds: drop
    exc_c = np.zeros((B, E), np.int32)
    exc_hib = np.zeros((B, E), np.int32)
    for b, (idx, c, hib, m, last_lo) in enumerate(per_row):
        exc_pos[b, :len(idx)] = idx
        exc_c[b, :len(idx)] = c[idx].astype(np.int32)
        exc_hib[b, :len(idx)] = hib[idx]
        if m < N:  # pad region: sentinel hi, lo back to 0
            exc_pos[b, len(idx)] = m
            exc_c[b, len(idx)] = -last_lo
            exc_hib[b, len(idx)] = sent_hib
    return (d, qi, spansid, exc_pos, exc_c, exc_hib, n_arr, avg_arr)


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


__all__ = ["chain_scores", "chain_scores_packed", "chain_scores_packed8",
           "chain_scores_plain", "chain_scores_task", "count_wide",
           "decode8", "derive_qss", "E_LADDER", "KEY_SCORE_MAX", "p_rel",
           "pack_tasks8", "pack_tasks16", "planes_to_torch", "score_bound",
           "unpack_prel", "v_carry_host", "WINDOW"]
