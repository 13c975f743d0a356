"""Minimizer index as sorted CSR arrays.

Replaces the reference's bucketed khash (index.c:27-98) with a flat,
device-friendly layout:

  keys[]   sorted distinct minimizer hashes (minier = x >> 8), uint64
  start[]  offset of each key's hit run in pos[], int64
  cnt[]    run length per key, int32
  pos[]    hit payloads y = rid<<32 | last_pos<<1 | strand, sorted by y
           within each key (matches index.c:230 radix_sort_64 of p[])

Lookup is a binary search (host: np.searchsorted; device: vectorized
searchsorted gather in ops/seed_gather.py). The reference's 1-occurrence
inlining trick (index.c:226-228) is unnecessary here — singleton runs are
just length-1 runs.

The port's copy of `mm2tpu/index/build.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .sketch import sketch_np, encode_nt4

MM_I_HPC = 0x1
MM_I_NO_SEQ = 0x2
MM_I_NO_NAME = 0x4


@dataclass
class IndexOptions:
    """mm_idxopt_t equivalent (minimap.h:103, defaults options.c:8-15)."""
    k: int = 15
    w: int = 10
    flag: int = 0
    bucket_bits: int = 14
    mini_batch_size: int = 50_000_000
    batch_size: int = 4_000_000_000


@dataclass
class RefSeq:
    name: Optional[str]
    offset: int
    length: int
    is_alt: bool = False


@dataclass
class MMIndex:
    w: int
    k: int
    b: int
    flag: int
    seq: List[RefSeq] = field(default_factory=list)
    keys: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    cnt: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    pos: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    S: Optional[np.ndarray] = None  # 4-bit packed reference, uint32
    index: int = 0                  # part number in a multi-part index
    n_alt: int = 0

    @property
    def n_seq(self) -> int:
        return len(self.seq)

    # ---- query (mm_idx_get, index.c:81-98) ----
    def get(self, minier: int) -> np.ndarray:
        """All hit payloads for a minimizer hash; empty array if absent."""
        i = np.searchsorted(self.keys, np.uint64(minier))
        if i >= len(self.keys) or self.keys[i] != np.uint64(minier):
            return self.pos[0:0]
        s = int(self.start[i])
        return self.pos[s: s + int(self.cnt[i])]

    _lut: Optional[Tuple[int, np.ndarray]] = None

    def _bucket_lut(self) -> Tuple[int, np.ndarray]:
        """(shift, boundaries) two-level lookup table over the top 14 bits
        of the key space: replaces the first ~14 cold binary-search levels
        with one gather (index.c's bucket split, re-keyed to high bits)."""
        if self._lut is None:
            bb = 14
            shift = max(0, int(self.keys[-1]).bit_length() - bb)
            probes = np.arange(1 << bb, dtype=np.uint64) << np.uint64(shift)
            bnd = np.concatenate([np.searchsorted(self.keys, probes),
                                  [len(self.keys)]]).astype(np.int64)
            self._lut = (shift, bnd)
        return self._lut

    _nlut: Optional[Tuple[int, int, np.ndarray]] = None

    def _native_lut(self) -> Tuple[int, int, np.ndarray]:
        """Finer (up to 22-bit) LUT for the native probe: average bucket
        run ~1-2 keys, so the per-query binary search is ~1 probe. Built
        O(n) with bincount (not n·log n searchsorted)."""
        if self._nlut is None:
            bits = min(22, max(1, int(len(self.keys)).bit_length()))
            shift = max(0, int(self.keys[-1]).bit_length() - bits)
            bkt = (self.keys >> np.uint64(shift)).astype(np.int64)
            counts = np.bincount(bkt, minlength=1 << bits)
            lut = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            self._nlut = (bits, shift, lut)
        return self._nlut

    def get_many(self, miniers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized lookup: returns (start, cnt) per query; cnt==0 if absent."""
        nk = len(self.keys)
        if nk == 0 or len(miniers) == 0:
            z = np.zeros(len(miniers), np.int64)
            return z, z.astype(np.int32)
        if nk >= 512:
            try:
                from ..native import lib as native_lib
                if native_lib.has_lookup():
                    bits, shift, lut = self._native_lut()
                    return native_lib.lookup_many(
                        miniers, self.keys, self.start, self.cnt,
                        bits, shift, lut)
            except Exception:
                pass
        if nk >= (1 << 16):
            shift, bnd = self._bucket_lut()
            # clamp: a query hashing above keys[-1]'s bucket must not
            # index past the LUT (or past keys below)
            bkt = np.minimum((miniers >> np.uint64(shift)).astype(np.int64),
                             (1 << 14) - 1)
            lo = bnd[bkt]
            hi = bnd[bkt + 1]
            # short vectorized binary search within each bucket run
            while int(np.max(hi - lo)) > 1:
                mid = (lo + hi) >> 1
                less = self.keys[np.minimum(mid, nk - 1)] < miniers
                go = hi - lo > 1
                lo = np.where(go & less, mid, lo)
                hi = np.where(go & ~less, mid, hi)
            # lo is the last index with key <= query within the bucket
            # (or the run start, or nk for an empty tail bucket); a
            # clamped direct probe resolves the hit
            lo_c = np.minimum(lo, nk - 1)
            cand = np.minimum(
                np.where(self.keys[lo_c] < miniers, lo + 1, lo), nk - 1)
            hit = self.keys[cand] == miniers
        else:
            idx = np.searchsorted(self.keys, miniers)
            cand = np.minimum(idx, nk - 1)
            hit = (self.keys[cand] == miniers) & (idx < nk)
        start = np.where(hit, self.start[cand], 0)
        cnt = np.where(hit, self.cnt[cand], 0)
        return start.astype(np.int64), cnt.astype(np.int32)

    # ---- reference sequence fetch (mm_idx_getseq, index.c:152-162) ----
    def getseq(self, rid: int, st: int, en: int) -> np.ndarray:
        """nt4 codes of the reference subsequence [st, en)."""
        assert self.S is not None, "index was built with NO_SEQ"
        s = self.seq[rid]
        en = min(en, s.length)
        out = np.empty(en - st, dtype=np.uint8)
        for j, o in enumerate(range(s.offset + st, s.offset + en)):
            out[j] = (int(self.S[o >> 3]) >> ((o & 7) << 2)) & 0xF
        return out

    def getseq_fast(self, rid: int, st: int, en: int) -> np.ndarray:
        """Vectorized getseq."""
        assert self.S is not None
        s = self.seq[rid]
        en = min(en, s.length)
        o = np.arange(s.offset + st, s.offset + en, dtype=np.int64)
        return ((self.S[o >> 3] >> ((o & 7) << 2).astype(np.uint32)) & 0xF).astype(np.uint8)

    # ---- occurrence threshold (mm_idx_cal_max_occ, index.c:164-185) ----
    def cal_max_occ(self, f: float) -> int:
        if f <= 0.0 or len(self.cnt) == 0:
            return np.iinfo(np.int32).max
        a = np.sort(self.cnt.astype(np.uint32))
        kk = int((1.0 - f) * len(a))
        return int(a[min(kk, len(a) - 1)]) + 1

    def name2id(self, name: str) -> int:
        for i, s in enumerate(self.seq):
            if s.name == name:
                return i
        return -1

    # ---- stats (mm_idx_stat, index.c:100-122) ----
    def stat(self) -> dict:
        n = len(self.keys)
        n1 = int(np.sum(self.cnt == 1)) if n else 0
        total = int(np.sum(self.cnt)) if n else 0
        length = sum(s.length for s in self.seq)
        return dict(distinct_minimizers=n, singleton_pct=100.0 * n1 / max(n, 1),
                    avg_occurrences=total / max(n, 1),
                    avg_spacing=length / max(total, 1), total_length=length)


def _pack_seq4(codes: np.ndarray, S: np.ndarray, offset: int) -> None:
    """mm_seq4_set (mmpriv.h:29) over a code array starting at offset.
    The aligned body packs 8 codes/word vectorized; only the unaligned
    head/tail (< 8 codes each) use the scatter path."""
    try:
        from ..native import lib as native_lib
        if native_lib.has_pack_seq4():
            native_lib.pack_seq4(codes, S, offset)
            return
    except ImportError:
        pass
    n = len(codes)
    head = min(-offset % 8, n)
    nb = (n - head) // 8
    for sl, off in (((0, head), offset), ((head + nb * 8, n), offset + head + nb * 8)):
        if sl[1] > sl[0]:
            o = np.arange(off, off + (sl[1] - sl[0]), dtype=np.int64)
            np.bitwise_or.at(S, o >> 3,
                             codes[sl[0]:sl[1]].astype(np.uint32)
                             << ((o.astype(np.uint32) & 7) << 2))
    if nb > 0:
        body = codes[head: head + nb * 8].astype(np.uint32).reshape(nb, 8)
        words = body[:, 0]
        for j in range(1, 8):
            words = words | (body[:, j] << np.uint32(4 * j))
        w0 = (offset + head) >> 3
        S[w0: w0 + nb] |= words


def build_index(names: Sequence[Optional[str]], seqs: Sequence[str],
                opt: IndexOptions | None = None, *,
                w: int | None = None, k: int | None = None,
                flag: int | None = None, bucket_bits: int | None = None,
                n_threads: int = 1) -> MMIndex:
    """Build a one-part index from in-memory sequences
    (mm_idx_gen / mm_idx_str semantics, index.c:354-434)."""
    opt = opt or IndexOptions()
    w = opt.w if w is None else w
    k = opt.k if k is None else k
    flag = opt.flag if flag is None else flag
    b = opt.bucket_bits if bucket_bits is None else bucket_bits
    if k * 2 < b:
        b = k * 2
    w = max(w, 1)

    mi = MMIndex(w=w, k=k, b=b, flag=flag)
    sum_len = sum(len(s) for s in seqs)
    if not (flag & MM_I_NO_SEQ):
        mi.S = np.zeros((sum_len + 7) // 8, dtype=np.uint32)

    try:
        from ..native import lib as native_lib
        native_sketch = native_lib.available()
    except Exception:
        native_sketch = False

    def _sk(rid, codes):
        if native_sketch:  # keep x/y planar: no interleave/deinterleave
            return native_lib.sketch_xy(codes, w, k, rid,
                                        bool(flag & MM_I_HPC))
        mm = sketch_np(codes, w, k, rid, bool(flag & MM_I_HPC))
        return mm[:, 0], mm[:, 1]

    # kt_for equivalent (index.c:247): the native sketch releases the GIL,
    # so contigs sketch on a pool on multi-core hosts; codes buffers are
    # released as each contig completes (not retained for the whole build)
    ex = None
    if n_threads > 1 and native_sketch and len(seqs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(min(n_threads, len(seqs)))
    offset = 0
    futs = []
    results = []
    for rid, (name, s) in enumerate(zip(names, seqs)):
        mi.seq.append(RefSeq(name=None if (flag & MM_I_NO_NAME) else name,
                             offset=offset, length=len(s)))
        if len(s) > 0:
            codes = encode_nt4(s)
            if mi.S is not None:
                _pack_seq4(codes, mi.S, offset)
            if ex is not None:
                futs.append(ex.submit(_sk, rid, codes))
            else:
                results.append(_sk(rid, codes))
            del codes
        offset += len(s)
    if ex is not None:
        results = [f.result() for f in futs]
        ex.shutdown()
    xs = [r[0] for r in results]
    ys = [r[1] for r in results]
    finalize_index_parts(mi, xs, ys, n_threads=n_threads)
    return mi


def finalize_index_parts(mi: MMIndex, xs, ys, n_threads: int = 1) -> None:
    """Finalize straight from per-contig sketch pieces. The native path
    (mm2_finalize_pieces) skips the Python concatenation and the staging
    copy — together ~3 full passes over the minimizer array, seconds at
    genome scale on a bandwidth-limited host."""
    if sum(len(x) for x in xs) == 0:
        return
    try:
        from ..native import lib as native_lib
        if native_lib.has_finalize_pieces():
            mi.keys, mi.start, mi.cnt, mi.pos = \
                native_lib.finalize_index_pieces(xs, ys, 2 * mi.k,
                                                 n_threads)
            return
    except Exception:
        pass
    x = np.concatenate(xs) if xs else np.zeros(0, np.uint64)
    y = np.concatenate(ys) if ys else np.zeros(0, np.uint64)
    finalize_index(mi, x, y, n_threads=n_threads)


def finalize_index(mi: MMIndex, x: np.ndarray, y: np.ndarray,
                   n_threads: int = 1) -> None:
    """Sort collected minimizers into the CSR layout (index.c:191-243).
    x/y are the planar minimizer columns."""
    if len(x) == 0:
        return
    try:
        from ..native import lib as native_lib
        if native_lib.has_finalize():
            mi.keys, mi.start, mi.cnt, mi.pos = native_lib.finalize_index(
                x, y, n_threads)
            return
    except Exception:
        pass
    minier = x >> np.uint64(8)
    order = np.lexsort((y, minier))  # group by hash, position-sorted runs
    minier_s, y_s = minier[order], y[order]
    # run boundaries on the already-sorted keys (np.unique would re-sort)
    bnd = np.nonzero(np.concatenate(([True], minier_s[1:] != minier_s[:-1])))[0]
    mi.keys = minier_s[bnd]
    mi.start = bnd.astype(np.int64)
    mi.cnt = np.diff(np.concatenate((bnd, [len(minier_s)]))).astype(np.int32)
    mi.pos = y_s


# ---- serialization (device-ready; .mmi interop lives in mmi.py) ----
#
# Format MMX1: a tiny JSON header + 64-byte-aligned raw array blocks,
# loaded zero-copy with mmap (pages fault in lazily during mapping).
# This is SURVEY §5's 'serialized device-ready index arrays' — the .mmi
# checkpoint role (index.c:440-534) without the parse/copy cost: loading
# a ~50 Mb-genome index is ~ms instead of the seconds np.savez needs.

_MMX_MAGIC = b"MMX1"


def save_index(mi: MMIndex, path: str) -> None:
    import json
    arrays = dict(
        lens=np.array([s.length for s in mi.seq], np.int64),
        offsets=np.array([s.offset for s in mi.seq], np.int64),
        is_alt=np.array([s.is_alt for s in mi.seq], bool),
        keys=mi.keys, start=mi.start, cnt=mi.cnt, pos=mi.pos,
        S=mi.S if mi.S is not None else np.zeros(0, np.uint32),
    )
    meta = dict(w=mi.w, k=mi.k, b=mi.b, flag=mi.flag, index=mi.index,
                has_S=mi.S is not None,
                names=[s.name or "" for s in mi.seq], arrays={})
    if len(mi.keys):
        # persist the probe LUT: derived data, but ~1 s to rebuild at
        # load time on a big index vs free via mmap
        bits, shift, lut = mi._native_lut()
        arrays["lut"] = lut
        meta["lut_bits"], meta["lut_shift"] = bits, shift
    order = list(arrays)
    off = 0  # array offsets are RELATIVE to the 64-aligned data base
    for nm in order:
        a = np.ascontiguousarray(arrays[nm])
        arrays[nm] = a
        off = (off + 63) & ~63
        meta["arrays"][nm] = dict(dtype=a.dtype.str, shape=list(a.shape),
                                  offset=off)
        off += a.nbytes
    hdr = json.dumps(meta).encode()
    base = (len(_MMX_MAGIC) + 8 + len(hdr) + 63) & ~63
    with open(path, "wb") as f:
        f.write(_MMX_MAGIC)
        f.write(np.int64(len(hdr)).tobytes())
        f.write(hdr)
        f.write(b"\0" * (base - len(_MMX_MAGIC) - 8 - len(hdr)))
        for nm in order:
            pos = f.tell() - base
            f.write(b"\0" * (meta["arrays"][nm]["offset"] - pos))
            # zero-copy write via the buffer protocol: .tobytes() would
            # materialize a second multi-GB copy per array, which on THP-
            # challenged virtualized hosts costs minutes at hg38 scale
            f.write(memoryview(arrays[nm]).cast("B"))


def load_index(path: str) -> MMIndex:
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic.startswith(b"PK"):
        return _load_index_npz(path)
    if magic != _MMX_MAGIC:
        raise ValueError("%s: not an mm2tpu index" % path)
    import json
    import mmap as mmap_mod
    f = open(path, "rb")
    mm = mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_READ)
    hlen = int(np.frombuffer(mm, np.int64, 1, 4)[0])
    meta = json.loads(mm[12:12 + hlen].decode())
    base = (12 + hlen + 63) & ~63
    arrs = {}
    for nm, d in meta["arrays"].items():
        dt = np.dtype(d["dtype"])
        n = int(np.prod(d["shape"])) if d["shape"] else 1
        arrs[nm] = np.frombuffer(mm, dt, n,
                                 base + d["offset"]).reshape(d["shape"])
    mi = MMIndex(w=meta["w"], k=meta["k"], b=meta["b"], flag=meta["flag"],
                 index=meta["index"])
    for i, nm in enumerate(meta["names"]):
        mi.seq.append(RefSeq(name=nm or None,
                             offset=int(arrs["offsets"][i]),
                             length=int(arrs["lens"][i]),
                             is_alt=bool(arrs["is_alt"][i])))
    mi.keys, mi.start = arrs["keys"], arrs["start"]
    mi.cnt, mi.pos = arrs["cnt"], arrs["pos"]
    mi.S = arrs["S"] if meta["has_S"] else None
    if "lut" in arrs:
        mi._nlut = (meta["lut_bits"], meta["lut_shift"], arrs["lut"])
    mi.n_alt = int(np.sum(arrs["is_alt"]))
    mi._mmap = mm  # keep the mapping alive for the arrays' lifetime
    return mi


def _load_index_npz(path: str) -> MMIndex:
    """Round-1 .npz format (np.savez_compressed), kept loadable."""
    z = np.load(path, allow_pickle=False)
    w, k, b, flag, n_seq, part = [int(v) for v in z["header"]]
    mi = MMIndex(w=w, k=k, b=b, flag=flag, index=part)
    names, lens, offs, alt = z["names"], z["lens"], z["offsets"], z["is_alt"]
    for i in range(n_seq):
        mi.seq.append(RefSeq(name=str(names[i]) or None, offset=int(offs[i]),
                             length=int(lens[i]), is_alt=bool(alt[i])))
    mi.keys, mi.start, mi.cnt, mi.pos = z["keys"], z["start"], z["cnt"], z["pos"]
    mi.S = z["S"] if bool(z["has_S"][0]) else None
    mi.n_alt = int(np.sum(alt))
    return mi
