"""Device seeding: the index probe (K5), the anchor pipeline (K6: probe,
count, expand and stable sort into K1's planes) and the chaining of the
anchors on K1, on a torch device.

Counterpart of `mm2tpu/ops/seed_device.py` (`prepare_index_device`,
`probe_counts`, `seed_chain_device`, `anchors_from_device`,
`split_query_minimizers`) with the probe of
`mm2tpu/parallel/mesh.py::lookup_index_device`. The host sketches each
read and ships only its minimizers; the device probes the CSR index it
holds, expands the hits into anchors, drops the minimizers at or over
`mid_occ`, sorts the anchors stably by x and chains them, with nothing
uploaded between the seeding and the chaining. The host reads back the
anchors, f and the relative p, 20 B an anchor.

Coverage (the JAX package's; callers seed the rest on the host):
single-segment reads, no NO_DIAG/NO_DUAL (the ava presets), no
FOR/REV_ONLY, occurrence cap `mid_occ`. The TANDEM bit is computed on
the host; SELF never fires without the qname rules.

The JAX package carries every 64-bit value as a pair of int32 (the TPU
has no int64). Here they are int64: minimizer hashes are below 2^56, so
int64 orders them as uint64 does, and the plain version's sort key is x
with bit 63 flipped, so that signed order is the unsigned order of x.
The anchors come out as K1's planes, with `pack_tasks16`'s pad past each
row's n, so the chaining sees what the host-seeded path packs.

The index on the card (`device_index`, `prepare_index_device`) carries a
bucket table (`bucket_table`, the host index's native LUT): 2^bits + 1
int32 offsets of the keys by their top bits, and (start, cnt) interleaved
as one (n_keys, 2) int32 plane. Two wrappers launch `csrc/seed.cu`:

- `probe_index` (K5, `mm2tpu_seed_probe`): (start, cnt) of each query
  through the table;
- `seed_anchors` (K6, `mm2tpu_seed_anchors`): probe, count, expand and
  sort of a (B, M) bucket into K1's planes and n, in one chain of
  launches (see the source).

A CPU tensor goes to the plain version (`probe_counts_reference`;
`seed_anchors_reference` = `probe_counts_reference`,
`build_anchors_reference` and `sort_anchors`, which the card's path never
runs); a CUDA tensor launches the kernels or raises. `launches` and
`reference_calls` count, per kernel ("probe", "build"), the launches (a
K6 launch is its whole chain) and the runs of the plain version;
`sort_passes` counts the `seed_sort_pass` kernels of those K6 chains (a
chain launches `seed_count`, `seed_offsets`, `seed_expand`, then one
pass per 8 bits of its sort key), so that a profiler trace's kernels
can be held to the counts.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import chain_v3, count_lock
from .chain_packed import p_rel

INT64_MIN = -(1 << 63)
PAD_Q = -1                 # a padded query: never equals a key (>= 0)
PAD_KEY = (1 << 63) - 1    # a padded slot's sort key, or a padded key
PAD_HI = -0x7FFFFF0        # pack_tasks16's never-matching hi sentinel
LUT_MAX_BITS = 22          # the bucket table's size, as the native LUT's

launches = {"probe": 0, "build": 0}
reference_calls = {"probe": 0, "build": 0}
sort_passes = 0


def reset_counts() -> None:
    global sort_passes
    for d in (launches, reference_calls):
        for k in d:
            d[k] = 0
    sort_passes = 0


class BucketTable(NamedTuple):
    """The index's bucket table on a device: `keys` (n,) int64, `sc` (n,
    2) int32 (start, cnt), `lut` (2^bits + 1,) int32 with bucket k's keys
    at lut[k] .. lut[k + 1], bucket = min(key >> shift, 2^bits - 1)."""
    keys: torch.Tensor
    sc: torch.Tensor
    lut: torch.Tensor
    bits: int
    shift: int


def bucket_table(keys, start, cnt) -> BucketTable:
    """The bucket table of sorted int64 `keys` (a shard's may end in
    `PAD_KEY`s) and their start/cnt, on the keys' device, by the integer
    ops of `index/build.py::MMIndex._native_lut` (bincount and cumsum):
    bits = min(22, bit length of the real key count), shift from the last
    real key's bit length. Equal to that LUT on an unpadded index."""
    keys = keys.to(torch.int64).contiguous()
    n = keys.shape[0]
    if n >= 1 << 31:
        raise ValueError("bucket_table: need fewer than 2^31 keys, got %d"
                         % n)
    real = n - int((keys == PAD_KEY).sum()) if n else 0
    bits = min(LUT_MAX_BITS, max(1, real.bit_length()))
    top = int(keys[real - 1]) if real else 0
    shift = max(0, top.bit_length() - bits)
    nb = 1 << bits
    lut = torch.zeros(nb + 1, dtype=torch.int64, device=keys.device)
    lut[1:] = torch.bincount((keys >> shift).clamp(max=nb - 1),
                             minlength=nb).cumsum(0)
    sc = torch.stack([start.to(torch.int32), cnt.to(torch.int32)],
                     1).contiguous()
    return BucketTable(keys, sc, lut.to(torch.int32), bits, shift)


def device_index(keys, start, cnt, device, pos=None) -> dict:
    """The CSR index (host arrays or tensors) on `device`: `keys` int64,
    `start`/`cnt` int32 (the columns of the table's sc plane), `table`
    (`bucket_table`) and, given `pos` (rid<<32 | rpos<<1 | strand),
    `pos` int64 with `rid_bits`/`pos_bits`, the bits of its largest rid
    and rpos (the width of K6's sort key)."""
    dev = torch.device(device)

    def to(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a) if isinstance(
            a, np.ndarray) else a).to(device=dev, dtype=dtype)

    table = bucket_table(to(keys, torch.int64), to(start, torch.int32),
                         to(cnt, torch.int32))
    out = dict(keys=table.keys, start=table.sc[:, 0], cnt=table.sc[:, 1],
               table=table)
    if pos is not None:
        p = to(pos, torch.int64).contiguous()
        out.update(pos=p, rid_bits=int((p >> 32).max()).bit_length()
                   if p.numel() else 0,
                   pos_bits=int(((p & 0xFFFFFFFF) >> 1).max()).bit_length()
                   if p.numel() else 0)
    return out


def prepare_index_device(mi, device) -> dict:
    """`device_index` of the host index `mi` with its positions (cached
    on `mi` per device)."""
    dev = torch.device(device)
    cache = mi.__dict__.setdefault("_torch_dev_idx", {})
    key = str(dev)
    if key not in cache:
        cache[key] = device_index(mi.keys.astype(np.int64), mi.start,
                                  mi.cnt, dev, pos=mi.pos.astype(np.int64))
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


_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from . import _build
        _lib = _build.load()
    return _lib


def _launch(dev, fn, *args):
    """fn(*args, stream) on `dev`'s current stream, entering the device
    only where it is not the current one already; raises on an error."""
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(dev, fn, *args)
    err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (fn.__name__,
                                                               err))


def _check_table(table, dev):
    """`bucket_table` makes a table's planes contiguous and of their
    dtypes: a launch checks only that it is one, on `dev`."""
    if not isinstance(table, BucketTable):
        raise ValueError("the card's probe needs the index's bucket table "
                         "(`bucket_table`, `device_index`), got %r"
                         % type(table).__name__)
    if table.keys.device != dev:
        raise ValueError("the bucket table is on %s, the queries on %s"
                         % (table.keys.device, dev))


def probe_index(index, q):
    """(start, cnt) of each query minimizer hash in `q` (int64, any
    shape) in a `device_index`, int32 of q's shape, cnt = 0 on a miss or
    a pad (`PAD_Q`). CPU tensors run the plain version on the index's
    keys, start and cnt; CUDA tensors launch `csrc/seed.cu`'s
    `mm2tpu_seed_probe` on the current stream through its bucket
    table."""
    if q.device.type == "cpu":
        return probe_counts_reference(index["keys"], index["start"],
                                      index["cnt"], q)
    if q.device.type != "cuda":
        raise ValueError("probe_index: unsupported device %s" % q.device)
    dev = q.device
    table = index["table"]
    _check_table(table, dev)
    _check("q", q, torch.int64, tuple(q.shape), dev)
    nq = q.numel()
    if nq == 0 or nq >= 1 << 30:
        raise ValueError("probe_index: need 0 < queries < 2^30, got %d"
                         % nq)
    out = torch.empty((2,) + tuple(q.shape), dtype=torch.int32, device=dev)
    ptr = out.data_ptr()
    _launch(dev, _kernels().mm2tpu_seed_probe, table.keys.data_ptr(),
            table.lut.data_ptr(), table.sc.data_ptr(), table.bits,
            table.shift, q.data_ptr(), nq, ptr, ptr + 4 * nq)
    with count_lock:
        launches["probe"] += 1
    return out.unbind(0)


# ---- K6: the anchor pipeline (its plain version, then the kernels) ----

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


_workspaces: dict = {}


def _workspace(B, M, N, rid_bits, pos_bits) -> Tuple[int, int]:
    """Scratch bytes of K6 at these sizes and its sort passes
    (`mm2tpu_seed_workspace`)."""
    key = (B, M, N, rid_bits, pos_bits)
    if key not in _workspaces:
        nbytes, passes = ctypes.c_longlong(), ctypes.c_int()
        err = _kernels().mm2tpu_seed_workspace(
            B, M, N, rid_bits, pos_bits, ctypes.byref(nbytes),
            ctypes.byref(passes))
        if err != 0:
            raise ValueError("seed_anchors: no workspace for B=%d M=%d N=%d "
                             "rid_bits=%d pos_bits=%d (a sort key over 64 "
                             "bits?)" % key)
        _workspaces[key] = nbytes.value, passes.value
    return _workspaces[key]


def seed_anchors(index, q, qpos, qyhi, qlen, *, N: int, mid_occ: int):
    """The sorted anchors of a (B, M) bucket of reads as K1's planes.
    `index` from `device_index` with pos (`prepare_index_device`); q (B,
    M) int64 hashes padded with `PAD_Q`; qpos, qyhi (B, M) int32; qlen
    (B,) int32. Returns `sort_anchors`' hi, lo, qi, span, yhi, n. CPU
    tensors run the plain versions; CUDA tensors launch `csrc/seed.cu`'s
    `mm2tpu_seed_anchors` (one chain of kernels) on the current stream."""
    if q.device.type == "cpu":
        return seed_anchors_reference(index, q, qpos, qyhi, qlen, N=N,
                                      mid_occ=mid_occ)
    if q.device.type != "cuda":
        raise ValueError("seed_anchors: unsupported device %s" % q.device)
    dev = q.device
    if q.dim() != 2:
        raise ValueError("q must be (B, M), got %s" % (tuple(q.shape),))
    B, M = q.shape
    if B < 1 or M < 1 or N < 1 or B * N >= 1 << 30 or B * M >= 1 << 31:
        raise ValueError("seed_anchors: bad shape B=%d M=%d N=%d" % (B, M,
                                                                    N))
    _check("q", q, torch.int64, (B, M), dev)
    _check("qpos", qpos, torch.int32, (B, M), dev)
    _check("qyhi", qyhi, torch.int32, (B, M), dev)
    _check("qlen", qlen, torch.int32, (B,), dev)
    table, pos = index["table"], index["pos"]
    _check_table(table, dev)
    _check("pos", pos, torch.int64, (pos.shape[0],), dev)
    rid_bits, pos_bits = index["rid_bits"], index["pos_bits"]
    nbytes, passes = _workspace(B, M, N, rid_bits, pos_bits)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    planes = torch.empty((4, B, N), dtype=torch.int32, device=dev)
    yhi = torch.empty((B, N), dtype=torch.int16, device=dev)
    n = torch.empty((B, 1), dtype=torch.int32, device=dev)
    hi, lo, qi, span = planes.unbind(0)
    _launch(dev, _kernels().mm2tpu_seed_anchors, table.keys.data_ptr(),
            table.lut.data_ptr(), table.sc.data_ptr(), table.bits,
            table.shift, pos.data_ptr(), q.data_ptr(), qpos.data_ptr(),
            qyhi.data_ptr(), qlen.data_ptr(), B, M, N, int(mid_occ),
            rid_bits, pos_bits, ws.data_ptr(), ws.numel(), hi.data_ptr(),
            lo.data_ptr(), qi.data_ptr(), span.data_ptr(), yhi.data_ptr(),
            n.data_ptr())
    global sort_passes
    with count_lock:
        launches["build"] += 1
        sort_passes += passes
    return hi, lo, qi, span, yhi, n


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
    if plain:
        hi, lo, qi, span, yhi, n = seed_anchors_reference(
            index, q, qpos, qyhi, qlen, N=N, mid_occ=mid_occ)
    else:
        hi, lo, qi, span, yhi, n = seed_anchors(
            index, q, qpos, qyhi, qlen, N=N, mid_occ=mid_occ)
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


__all__ = ["BucketTable", "PAD_Q", "anchors_from_device", "bucket_table",
           "build_anchors_reference", "device_index", "prepare_index_device",
           "probe_counts_reference", "probe_index",
           "reset_counts", "seed_anchors", "seed_anchors_reference",
           "seed_chain", "seed_chain_plain", "sort_anchors",
           "split_query_minimizers"]
