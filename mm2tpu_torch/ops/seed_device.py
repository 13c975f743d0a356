"""Device seeding: the index probe (K5), the anchor build and sort (K6's
front half) and the chaining of the built anchors on K1, on a torch
device.

Counterpart of `mm2tpu/ops/seed_device.py` (`prepare_index_device`,
`probe_counts`, `seed_chain_device`, `anchors_from_device`,
`split_query_minimizers`) with the probe of
`mm2tpu/parallel/mesh.py::lookup_index_device`. The host sketches each
read and ships only its minimizers; the device probes the CSR index it
holds, expands the hits into anchors, drops the minimizers at or over
`mid_occ`, sorts the anchors stably by x and chains them, with nothing
uploaded between the build and the chaining. The host reads back the
anchors, f and the relative p, 20 B an anchor.

Coverage (the JAX package's; callers seed the rest on the host):
single-segment reads, no NO_DIAG/NO_DUAL (the ava presets), no
FOR/REV_ONLY, occurrence cap `mid_occ`. The TANDEM bit is computed on
the host; SELF never fires without the qname rules.

The JAX package carries every 64-bit value as a pair of int32 (the TPU
has no int64). Here they are int64: minimizer hashes are below 2^56, so
int64 orders them as uint64 does, and the sort key is x with bit 63
flipped, so that signed order is the unsigned order of x. The built
anchors come out as K1's planes, with `pack_tasks16`'s pad past each
row's n, so the chaining sees what the host-seeded path packs.

Two wrappers hold a kernel each, in `csrc/seed.cu`:

- `probe_counts` (K5, `mm2tpu_seed_probe`): (start, cnt) of each query;
- `build_anchors` (K6, `mm2tpu_seed_build`): the kept hits expanded into
  unsorted sort keys and y words, pads past each row's total, and n.

A CPU tensor goes to the plain version (`probe_counts_reference`,
`build_anchors_reference`); a CUDA tensor launches the kernel or raises.
`launches` and `reference_calls` count, per kernel ("probe", "build"),
the kernel launches and the runs of the plain version. The sort is
`torch.sort(..., stable=True)` on one int64 key, as the JAX package
leaves it to XLA's sort.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import chain_v3, count_lock
from .chain_packed import p_rel

INT64_MIN = -(1 << 63)
PAD_Q = -1                 # a padded query: never equals a key (>= 0)
PAD_KEY = (1 << 63) - 1    # a padded slot's sort key: after every anchor
PAD_HI = -0x7FFFFF0        # pack_tasks16's never-matching hi sentinel

launches = {"probe": 0, "build": 0}
reference_calls = {"probe": 0, "build": 0}


def reset_counts() -> None:
    for d in (launches, reference_calls):
        for k in d:
            d[k] = 0


def prepare_index_device(mi, device) -> dict:
    """The CSR index on `device` (cached on `mi` per device): `keys` int64
    (the sorted minimizer hashes), `start`/`cnt` int32 and `pos` int64
    (rid<<32 | rpos<<1 | strand)."""
    dev = torch.device(device)
    cache = mi.__dict__.setdefault("_torch_dev_idx", {})
    key = str(dev)
    if key not in cache:
        arrays = dict(keys=mi.keys.astype(np.int64),
                      start=mi.start.astype(np.int32),
                      cnt=mi.cnt.astype(np.int32),
                      pos=mi.pos.astype(np.int64))
        cache[key] = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for k, a in arrays.items()}
    return cache[key]


def split_query_minimizers(mv: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Host-side prep of one read's minimizers (n, 2) uint64: (hash int64,
    qpos int32 = lastpos<<1 | strand, qspan int32, TANDEM bit int32), as
    `mapping/seed.py` extracts them (map.c:90-123)."""
    miniers = mv[:, 0] >> np.uint64(8)
    q = miniers.astype(np.int64)
    qpos = (mv[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.int64) \
        .astype(np.int32)
    qspan = (mv[:, 0] & np.uint64(0xFF)).astype(np.int32)
    tandem = np.zeros(len(mv), np.int32)
    if len(mv) > 1:
        same_prev = miniers[1:] == miniers[:-1]
        tandem[1:] |= same_prev
        tandem[:-1] |= same_prev
    return q, qpos, qspan, tandem


# ---- K5: the index probe ----

def probe_counts_reference(keys, start, cnt, q):
    """Plain version of K5: a lower bound of each query in the sorted
    int64 `keys` by a branchless binary search, one gather a step (as
    `lookup_index_device`). Returns (start, cnt), int32 of q's shape, 0
    on a miss or a pad."""
    with count_lock:
        reference_calls["probe"] += 1
    n = keys.shape[0]
    zeros = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    if n == 0:
        return zeros, zeros.clone()
    steps = max(1, int(np.ceil(np.log2(n + 1))))
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        go = lo < hi
        less = keys[mid.clamp(max=n - 1)] < q
        lo = torch.where(go & less, mid + 1, lo)
        hi = torch.where(go & ~less, mid, hi)
    idx = lo.clamp(max=n - 1)
    hit = (keys[idx] == q) & (lo < n)
    return (torch.where(hit, start[idx], zeros),
            torch.where(hit, cnt[idx], zeros))


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or \
            not t.is_contiguous():
        raise ValueError("%s must be a contiguous %s %s tensor on %s, got "
                         "%s %s on %s" % (name, shape, dtype, dev, t.dtype,
                                          tuple(t.shape), t.device))


def probe_counts(keys, start, cnt, q):
    """(start, cnt) of each query minimizer hash in `q` (int64, any
    shape), int32 of q's shape, cnt = 0 on a miss or a pad (`PAD_Q`).
    CPU tensors run the plain version; CUDA tensors launch `csrc/seed.cu`'s
    `mm2tpu_seed_probe` on the current stream."""
    if q.device.type == "cpu":
        return probe_counts_reference(keys, start, cnt, q)
    if q.device.type != "cuda":
        raise ValueError("probe_counts: unsupported device %s" % q.device)
    dev = q.device
    nk = keys.shape[0]
    _check("keys", keys, torch.int64, (nk,), dev)
    _check("start", start, torch.int32, (nk,), dev)
    _check("cnt", cnt, torch.int32, (nk,), dev)
    _check("q", q, torch.int64, tuple(q.shape), dev)
    if q.numel() == 0 or q.numel() >= 1 << 31 or nk >= 1 << 31:
        raise ValueError("probe_counts: need 0 < queries < 2^31 and keys < "
                         "2^31, got %d and %d" % (q.numel(), nk))
    from . import _build
    lib = _build.load()
    s = torch.empty(q.shape, dtype=torch.int32, device=dev)
    c = torch.empty(q.shape, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mm2tpu_seed_probe(keys.data_ptr(), start.data_ptr(),
                                    cnt.data_ptr(), nk, q.data_ptr(),
                                    q.numel(), s.data_ptr(), c.data_ptr(),
                                    stream)
    if err != 0:
        raise RuntimeError("seed_probe kernel launch failed: cudaError %d"
                           % err)
    with count_lock:
        launches["probe"] += 1
    return s, c


# ---- K6: the anchor build ----

def build_anchors_reference(start, cnt, qpos, qyhi, qlen, pos, *, N: int,
                            mid_occ: int):
    """Plain version of K6 (`seed_chain_device`'s expansion): per row, the
    hits of the minimizers with cnt < mid_occ laid out in slot order
    (minimizer, then hit in `pos`), slot ownership by a search of the
    counts' prefix sum. (B, M) int32 start, cnt, qpos (lastpos<<1 |
    strand) and qyhi (span | TANDEM<<10); (B,) int32 qlen; int64 pos.
    Returns (key, y), (B, N) int64, and n, (B,) int32 = each row's total.
    key = x ^ (1 << 63) with x = strand<<63 | rid<<32 | rpos (strand: the
    hit's and the minimizer's strands differ), `PAD_KEY` past the total;
    y = qyhi<<32 | y_pos (y_pos reversed on a strand mismatch), 0 past
    it. Slots past N are not built."""
    with count_lock:
        reference_calls["build"] += 1
    B, M = cnt.shape
    dev = cnt.device
    c = torch.where(cnt < mid_occ, cnt, 0).to(torch.int64)
    cum = c.cumsum(1)                                         # (B, M)
    total = cum[:, -1]
    slots = torch.arange(N, dtype=torch.int64, device=dev) \
        .expand(B, N).contiguous()
    m_of = torch.searchsorted(cum, slots, right=True).clamp(max=M - 1)
    prev = torch.where(m_of > 0,
                       torch.gather(cum, 1, (m_of - 1).clamp(min=0)), 0)
    valid = slots < total[:, None]
    hit = torch.gather(start, 1, m_of).to(torch.int64) + slots - prev
    hit = torch.where(valid, hit, 0)
    if pos.numel() == 0:
        r = torch.zeros_like(hit)
    else:
        r = pos[hit.clamp(max=pos.numel() - 1)]
    rid = r >> 32
    rpos = (r & 0xFFFFFFFF) >> 1
    mpos = torch.gather(qpos, 1, m_of).to(torch.int64)
    myhi = torch.gather(qyhi, 1, m_of).to(torch.int64)
    mspan = myhi & 0xFF
    forward = (r & 1) == (mpos & 1)
    ql = qlen.to(torch.int64)[:, None]
    y_pos = torch.where(forward, mpos >> 1,
                        ql - ((mpos >> 1) + 1 - mspan) - 1)
    x = (rid << 32) | rpos
    x = torch.where(forward, x, x | INT64_MIN)
    key = torch.where(valid, x ^ INT64_MIN, PAD_KEY)
    y = torch.where(valid, (myhi << 32) | (y_pos & 0xFFFFFFFF), 0)
    return key, y, total.to(torch.int32)


def build_anchors(start, cnt, qpos, qyhi, qlen, pos, *, N: int,
                  mid_occ: int):
    """K6's anchor build, as `build_anchors_reference`. CPU tensors run the
    plain version; CUDA tensors launch `csrc/seed.cu`'s `mm2tpu_seed_build`
    on the current stream (one block a row)."""
    if cnt.device.type == "cpu":
        return build_anchors_reference(start, cnt, qpos, qyhi, qlen, pos,
                                       N=N, mid_occ=mid_occ)
    if cnt.device.type != "cuda":
        raise ValueError("build_anchors: unsupported device %s" % cnt.device)
    dev = cnt.device
    if cnt.dim() != 2:
        raise ValueError("cnt must be (B, M), got %s" % (tuple(cnt.shape),))
    B, M = cnt.shape
    for name, t in (("start", start), ("cnt", cnt), ("qpos", qpos),
                    ("qyhi", qyhi)):
        _check(name, t, torch.int32, (B, M), dev)
    _check("qlen", qlen, torch.int32, (B,), dev)
    _check("pos", pos, torch.int64, (pos.shape[0],), dev)
    if B < 1 or M < 1 or N < 1 or B * max(M, N) >= 1 << 31:
        raise ValueError("build_anchors: bad shape B=%d M=%d N=%d" % (B, M,
                                                                     N))
    from . import _build
    lib = _build.load()
    key = torch.empty((B, N), dtype=torch.int64, device=dev)
    y = torch.empty((B, N), dtype=torch.int64, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mm2tpu_seed_build(
            start.data_ptr(), cnt.data_ptr(), qpos.data_ptr(),
            qyhi.data_ptr(), qlen.data_ptr(), pos.data_ptr(),
            key.data_ptr(), y.data_ptr(), n.data_ptr(), B, M, N,
            int(mid_occ), stream)
    if err != 0:
        raise RuntimeError("seed_build kernel launch failed: cudaError %d"
                           % err)
    with count_lock:
        launches["build"] += 1
    return key, y, n


def sort_anchors(key, y, n):
    """Sort each row stably by `key` (pads, `PAD_KEY`, last; equal x keep
    slot order, the order of the host's stable radix sort) and split the
    anchors into K1's planes with `pack_tasks16`'s pad past n: hi, lo, qi
    (= y_pos), span, (B, N) int32; yhi (span | TANDEM<<10), (B, N) int16;
    n, (B, 1) int32."""
    B, N = key.shape
    ks, order = torch.sort(key, dim=1, stable=True)
    ys = torch.gather(y, 1, order)
    x = ks ^ INT64_MIN
    n = n.reshape(B, 1)
    valid = torch.arange(N, device=key.device)[None, :] < n
    zero = torch.zeros((), dtype=torch.int32, device=key.device)
    hi = torch.where(valid, (x >> 32).to(torch.int32),
                     torch.full((), PAD_HI, dtype=torch.int32,
                                device=key.device))
    lo = torch.where(valid, (x & 0xFFFFFFFF).to(torch.int32), zero)
    qi = torch.where(valid, (ys & 0xFFFFFFFF).to(torch.int32), zero)
    yhi = (ys >> 32).to(torch.int32)
    span = torch.where(valid, yhi & 0xFF, zero)
    return hi, lo, qi, span, yhi.to(torch.int16), n.contiguous()


def seed_anchors_reference(index, q, qpos, qyhi, qlen, *, N: int,
                           mid_occ: int):
    """`seed_anchors` through the plain versions, on any device."""
    s, c = probe_counts_reference(index["keys"], index["start"],
                                  index["cnt"], q)
    key, y, n = build_anchors_reference(s, c, qpos, qyhi, qlen, index["pos"],
                                        N=N, mid_occ=mid_occ)
    return sort_anchors(key, y, n)


def seed_anchors(index, q, qpos, qyhi, qlen, *, N: int, mid_occ: int):
    """The sorted anchors of a (B, M) bucket of reads: probe (K5), build
    (K6), `sort_anchors`. `index` from `prepare_index_device`; q (B, M)
    int64 hashes padded with `PAD_Q`; qpos, qyhi (B, M) int32; qlen (B,)
    int32. Returns `sort_anchors`' hi, lo, qi, span, yhi, n."""
    s, c = probe_counts(index["keys"], index["start"], index["cnt"], q)
    key, y, n = build_anchors(s, c, qpos, qyhi, qlen, index["pos"], N=N,
                              mid_occ=mid_occ)
    return sort_anchors(key, y, n)


def seed_chain(index, q, qpos, qyhi, qlen, avg, *, N: int, mid_occ: int,
               max_dist_x: int, max_dist_y: int, bw: int, iter_cap: int,
               gap_scale: float, mark=None, plain: bool = False):
    """Fused probe -> build -> sort -> chain of one (B, M) bucket
    (`seed_chain_device`): `seed_anchors`, then K1
    (`chain_v3.chain_scores_v3`) on the same device tensors. avg (B, 1)
    float32 is computed on the host (its f32 rounding must match the
    host path's bit for bit). Returns (hi, lo, yhi int16, ylo, f, prel
    int16, n (B, 1)), each row valid over [:n]; decode with
    `anchors_from_device` and `chain_packed.unpack_prel`. `mark()`, when
    given, is called before the seeding, between it and the chaining,
    and after the chaining (the pipeline records CUDA events there).
    `plain=True` runs the plain versions on any device."""
    if mark is not None:
        mark()
    seed = seed_anchors_reference if plain else seed_anchors
    hi, lo, qi, span, yhi, n = seed(index, q, qpos, qyhi, qlen, N=N,
                                    mid_occ=mid_occ)
    if mark is not None:
        mark()
    chain = chain_v3.chain_scores_v3_reference if plain \
        else chain_v3.chain_scores_v3
    f, p = chain(hi, lo, qi, span, n, avg, max_dist_x=max_dist_x,
                 max_dist_y=max_dist_y, bw=bw, iter_cap=iter_cap,
                 gap_scale=gap_scale)
    if mark is not None:
        mark()
    return hi, lo, yhi, qi, f, p_rel(p), n


def seed_chain_plain(*args, **kw):
    """`seed_chain` through the plain versions, on any device."""
    return seed_chain(*args, plain=True, **kw)


def anchors_from_device(hi, lo, yhi, ylo, n: int) -> np.ndarray:
    """Reassemble the (n, 2) uint64 anchor array of one row from the
    readback planes (hi, lo, ylo int32; yhi int16)."""
    x = (np.asarray(hi[:n]).astype(np.uint32).astype(np.uint64)
         << np.uint64(32)) | \
        np.asarray(lo[:n]).astype(np.uint32).astype(np.uint64)
    y = (np.asarray(yhi[:n]).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(ylo[:n]).astype(np.uint32).astype(np.uint64)
    a = np.empty((n, 2), np.uint64)
    a[:, 0] = x
    a[:, 1] = y
    return a


__all__ = ["PAD_Q", "anchors_from_device", "build_anchors",
           "build_anchors_reference", "prepare_index_device", "probe_counts",
           "probe_counts_reference", "reset_counts", "seed_anchors",
           "seed_anchors_reference", "seed_chain", "seed_chain_plain",
           "sort_anchors", "split_query_minimizers"]
