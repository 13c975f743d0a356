"""Data-parallel mesh steps over several torch devices of one process.

Counterpart of `mm2tpu/parallel/mesh.py`. A `Mesh` is an ordered tuple
of `torch.device`s in this process, the counterpart of a JAX mesh over
`jax.local_devices()`: as there, a mesh never spans processes (several
hosts are `--hosts`' business). A device may repeat: (cuda:0, cuda:0)
puts two shards on one card, and eight `cpu` entries are the
counterpart of the JAX tests' virtual CPU mesh.

Each step splits its B rows into D equal slices, one a shard (B must be
a multiple of D, as under `shard_map`), launches each slice's work on
its device's current stream without waiting in between, and gathers
the outputs in row order into host memory (pinned, by non-blocking
copies on CUDA). It returns a `Gathered`, whose `result()` waits for
the copies, so that a caller can prepare the next step meanwhile.

- `sharded_chain_step`: K1/K2 on the raw (hi, lo, qi, span, sid)
  planes; returns (f, p). K1 takes every single-segment non-cDNA shard,
  also where the JAX package's `_chain_auto` sends a shard of B/D % 8 !=
  0 to its v2 kernel: both compute `chain_ref.chain_scores_window`.
- `sharded_chain_step8`: the same on the 8 B delta wire (`decode8` on
  each shard's device, then K1/K2); returns (f, prel).
- `sharded_probe_step`: the index sharded by key range (`shard_index`
  puts it on the mesh once); the queries are all-gathered, each shard
  probes its key range with K5, and the (start, cnt) are
  reduce-scattered back (one shard at most hits).
- `sharded_map_step`: K5 on the replicated index (`replicate_index`),
  K1/K2 and, with `ext_params`, K3 on each shard's fills.

The two collectives, `all_gather` and `psum_scatter`, are copies
between the mesh's devices (`Tensor.to(dev, non_blocking=True)`) and a
sum, not `torch.distributed`: NCCL needs a process per card and refuses
two ranks on one card, so on a single card it would run at world size 1
and move no byte, where this mesh puts two or four shards on one card
and runs the split, the gather and the reduce-scatter on it.

Host arrays go to the shards' devices through
`chain_packed.planes_to_torch` (pinned, non-blocking on CUDA).
`launches` counts the shard launches (a shard's kernels in one step
call) made on CUDA devices.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..ops import count_lock
from ..ops import seed_device as sd
from ..ops.chain_packed import (chain_scores, chain_scores_packed8,
                                planes_to_torch)

launches = 0

# a padded key slot of a sharded index: sorts after every minimizer hash
# (< 2^56) and never equals a query (a hash, or seed_device.PAD_Q = -1)
PAD_KEY = (1 << 63) - 1


class Mesh(tuple):
    """The shards' devices, in order; a device may repeat."""


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh of `n_devices` shards (default: all) over `devices`
    (default: this process's CUDA cards, cuda:0, cuda:1, ...; the JAX
    package takes `jax.local_devices()`). Fewer devices than `n_devices`
    raise, naming the count: where the JAX package's `devs[:n]` quietly
    builds a smaller mesh, no shard here is dropped or moved elsewhere."""
    if devices is not None:
        devs, what = [torch.device(d) for d in devices], "given"
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        what = "CUDA devices visible"
    n = n_devices or len(devs)
    if n < 1 or n > len(devs):
        raise ValueError("a mesh of %d shards needs %d devices; %d %s"
                         % (n, n, len(devs), what))
    return Mesh(devs[:n])


def _on(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _count(dev) -> None:
    global launches
    if dev.type == "cuda":
        with count_lock:
            launches += 1


def _slices(B: int, D: int):
    if B % D:
        raise ValueError("%d rows do not split into %d equal shards"
                         % (B, D))
    b = B // D
    return [slice(s * b, (s + 1) * b) for s in range(D)]


def _split(mesh: Mesh, arrays):
    """Each shard's row slice of the host `arrays` (NumPy, or CPU
    tensors), on its device."""
    arrays = [np.asarray(a) for a in arrays]
    return [planes_to_torch(*(a[sl] for a in arrays), dev)
            for sl, dev in zip(_slices(len(arrays[0]), len(mesh)), mesh)]


class Gathered:
    """A step's outputs as host tensors in row order, and the CUDA events
    after their copies; `result()` waits for those and returns them."""

    def __init__(self, outs, events):
        self.outs, self.events = outs, events

    def result(self):
        for e in self.events:
            e.synchronize()
        return self.outs


def gather(mesh: Mesh, parts) -> Gathered:
    """`parts[s]`, shard s's outputs on mesh[s] (each with the shard's
    rows), concatenated by rows into host tensors (pinned and filled by
    non-blocking copies on CUDA)."""
    pinned = any(dev.type == "cuda" for dev in mesh)
    outs = [torch.empty((sum(p[k].shape[0] for p in parts),) +
                        tuple(t.shape[1:]), dtype=t.dtype, pin_memory=pinned)
            for k, t in enumerate(parts[0])]
    events, r0 = [], 0
    for dev, part in zip(mesh, parts):
        with _on(dev):
            for out, t in zip(outs, part):
                out[r0:r0 + t.shape[0]].copy_(t, non_blocking=True)
            if dev.type == "cuda":
                events.append(torch.cuda.Event())
                events[-1].record()
        r0 += part[0].shape[0]
    return Gathered(tuple(outs), events)


def all_gather(mesh: Mesh, parts):
    """`parts[s]` on mesh[s]: on each shard's device, the row-wise
    concatenation of all parts (`jax.lax.all_gather(..., tiled=True)`)."""
    return [torch.cat([p.to(dev, non_blocking=True) for p in parts])
            for dev in mesh]


def psum_scatter(mesh: Mesh, parts):
    """`parts[s]`, (B, ...) on mesh[s]: shard s gets, on its device, the
    sum over all parts of its row slice
    (`jax.lax.psum_scatter(..., tiled=True)`)."""
    out = []
    for sl, dev in zip(_slices(parts[0].shape[0], len(mesh)), mesh):
        acc = parts[0][sl].to(dev, non_blocking=True)
        for p in parts[1:]:
            acc = acc + p[sl].to(dev, non_blocking=True)
        out.append(acc)
    return out


def sharded_chain_step(mesh: Mesh, *, max_dist_x: int, max_dist_y: int,
                       bw: int, iter_cap: int, gap_scale: float,
                       is_cdna: bool, n_segs: int):
    """`step(hi, lo, qi, span, sid, n, avg)` on host planes ((B, N) int32,
    (B, 1) int32 n and float32 avg; B a multiple of the mesh size):
    each shard's rows chained on its device by K1 (single-segment
    non-cDNA) or K2, a `Gathered` of (f, p), (B, N) int32."""
    kw = dict(max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
              iter_cap=iter_cap, gap_scale=gap_scale, is_cdna=is_cdna,
              n_segs=n_segs)

    def step(hi, lo, qi, span, sid, n, avg):
        parts = []
        for dev, shard in zip(mesh, _split(mesh, (hi, lo, qi, span, sid, n,
                                                  avg))):
            with _on(dev):
                parts.append(chain_scores(*shard, **kw))
            _count(dev)
        return gather(mesh, parts)

    return step


def sharded_chain_step8(mesh: Mesh, *, max_dist_x: int, max_dist_y: int,
                        bw: int, iter_cap: int, gap_scale: float,
                        is_cdna: bool, n_segs: int):
    """`sharded_chain_step` on the 8 B delta wire: `step(d, qi, spansid,
    exc_pos, exc_c, exc_hib, n, avg)` on `pack_tasks8`'s host planes;
    each shard's rows decoded (`decode8`, row by row, so the split is
    exact) and chained on its device, a `Gathered` of (f int32, prel
    int16), (B, N)."""
    kw = dict(max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
              iter_cap=iter_cap, gap_scale=gap_scale, is_cdna=is_cdna,
              n_segs=n_segs)

    def step(d, qi, spansid, exc_pos, exc_c, exc_hib, n, avg):
        parts = []
        for dev, shard in zip(mesh, _split(mesh, (d, qi, spansid, exc_pos,
                                                  exc_c, exc_hib, n, avg))):
            with _on(dev):
                parts.append(chain_scores_packed8(*shard, **kw))
            _count(dev)
        return gather(mesh, parts)

    return step


def split_keys(keys_u64: np.ndarray) -> np.ndarray:
    """uint64 minimizer hashes as the port's device keys: int64 (they are
    below 2^56, so int64 orders them as uint64 does;
    `ops/seed_device.py::prepare_index_device`). The JAX package splits
    them into an int32 (hi, lo) pair, since the TPU has no int64."""
    keys = np.asarray(keys_u64, np.uint64)
    if len(keys) and int(keys.max()) >= PAD_KEY:
        raise ValueError("minimizer hashes must be below 2^63 - 1")
    return keys.astype(np.int64)


def shard_index_arrays(keys: np.ndarray, start: np.ndarray,
                       cnt: np.ndarray, n_shards: int):
    """Range-partition the sorted CSR key arrays for a D-shard mesh: the
    key count padded to a multiple of D with never-matching `PAD_KEY`
    slots (cnt 0), `start` kept global (it indexes the global pos array).
    Returns (keys int64, start int32, cnt int32, ranges): shard s holds
    the s-th 1/D of each array, and ranges[s] = [lo, hi) of the real
    keys it holds."""
    n = len(keys)
    npad = -(-max(n, n_shards) // n_shards) * n_shards
    keys_p = np.full(npad, PAD_KEY, np.int64)
    start_p = np.zeros(npad, np.int32)
    cnt_p = np.zeros(npad, np.int32)
    keys_p[:n] = split_keys(keys)
    start_p[:n] = start
    cnt_p[:n] = cnt
    per = npad // n_shards
    ranges = [(min(d * per, n), min((d + 1) * per, n))
              for d in range(n_shards)]
    return keys_p, start_p, cnt_p, ranges


def shard_index(mesh: Mesh, keys, start, cnt):
    """The `shard_index_arrays` arrays on the mesh, once for many probes:
    shard s's `seed_device.device_index` (keys, start, cnt and the bucket
    table built from them) of the s-th 1/D of each, on mesh[s]."""
    return [sd.device_index(*shard, shard[0].device)
            for shard in _split(mesh, (keys, start, cnt))]


def replicate_index(mesh: Mesh, keys, start, cnt):
    """The CSR index (keys int64, start and cnt int32, host arrays) on
    every shard's device, one copy a distinct device: shard s's
    `seed_device.device_index` on mesh[s]."""
    copies = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = sd.device_index(keys, start, cnt, dev)
    return [copies[dev] for dev in mesh]


def sharded_probe_step(mesh: Mesh):
    """The index-sharded probe: `step(index, q)` with `index` the key
    ranges on the mesh (`shard_index`) and host queries q (B, M) int64
    (`seed_device.PAD_Q` for a pad; B a multiple of the mesh size,
    row-sharded). The queries are all-gathered, each shard probes its
    key range with K5 (`seed_device.probe_index`), and the (start, cnt)
    of each query, at most one shard's nonzero, are reduce-scattered back
    to the row shards: a `Gathered` of (start, cnt), (B, M) int32, 0 on a
    miss."""

    def step(index, q):
        qs = all_gather(mesh, [t for (t,) in _split(mesh, (q,))])
        s_parts, c_parts = [], []
        for dev, shard, qq in zip(mesh, index, qs):
            with _on(dev):
                hit_start, hit_cnt = sd.probe_index(shard, qq)
            s_parts.append(hit_start)
            c_parts.append(hit_cnt)
            _count(dev)
        return gather(mesh, list(zip(psum_scatter(mesh, s_parts),
                                     psum_scatter(mesh, c_parts))))

    return step


def sharded_map_step(mesh: Mesh, *, max_dist_x: int, max_dist_y: int,
                     bw: int, iter_cap: int, gap_scale: float,
                     is_cdna: bool, n_segs: int,
                     ext_params: Optional[dict] = None):
    """The device side of mapping over a mesh: `step(index, q, hi, lo, qi,
    span, sid, n, avg, *ext)` probes each shard's query minimizers q (B,
    M) int64 in the index replicated on the mesh (`replicate_index`)
    with K5, chains its (B, N) planes
    on K1/K2 and, with `ext_params` (the keywords of
    `ops.ksw2_extd2.extd2_traced` but `lens_h`), runs K3 on its fills
    `ext` = (lens (B, 2) int32, tsf (B, Tpad) uint8, qcol (B, Qpad)
    uint8). A `Gathered` of (hit start, hit cnt, f, p), and with the
    fills (ez, ops, i_fin, j_fin), ops padded with 255 (the trace's end)
    to the widest shard's."""
    kw = dict(max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
              iter_cap=iter_cap, gap_scale=gap_scale, is_cdna=is_cdna,
              n_segs=n_segs)

    def step(index, q, hi, lo, qi, span, sid, n, avg, *ext):
        if bool(ext) != (ext_params is not None):
            raise ValueError("the fills go with ext_params, and only with "
                             "them")
        rows = (q, hi, lo, qi, span, sid, n, avg) + ext
        slices = _slices(len(q), len(mesh))
        parts = []
        for dev, ix, sl, sh in zip(mesh, index, slices, _split(mesh, rows)):
            with _on(dev):
                out = list(sd.probe_index(ix, sh[0]))
                out += chain_scores(*sh[1:8], **kw)
                if ext:
                    from ..ops.ksw2_extd2 import extd2_traced
                    out += extd2_traced(*sh[8:],
                                        lens_h=np.asarray(ext[0])[sl],
                                        **ext_params)
            parts.append(out)
            _count(dev)
        if ext:
            width = max(p[5].shape[1] for p in parts)
            for p in parts:
                p[5] = torch.nn.functional.pad(
                    p[5], (0, width - p[5].shape[1]), value=255)
        return gather(mesh, parts)

    return step


__all__ = ["Gathered", "Mesh", "PAD_KEY", "all_gather", "gather",
           "launches", "make_mesh", "psum_scatter", "replicate_index",
           "shard_index", "shard_index_arrays", "sharded_chain_step",
           "sharded_chain_step8", "sharded_map_step", "sharded_probe_step",
           "split_keys"]
