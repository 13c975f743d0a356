"""Reader/writer for the reference binary index format (.mmi, magic MMI\\2).

Format (index.c:440-534): header (w,k,b,n_seq,flag as uint32), per-seq
name-length/name/len records, then 1<<b buckets each holding a position
array p[] and khash (key,val) pairs, then the 4-bit packed reference.

The khash key stores minier>>b (low b bits are the bucket number); LSB set
means singleton with the position inlined in val, otherwise
val = start<<32 | count into p[] (index.c:91-97).

Reading reconstructs our CSR layout exactly. Writing emits keys in sorted
order per bucket — a valid .mmi (pair order within a bucket is
reader-irrelevant), though not byte-identical to the C writer's khash
iteration order.

The port's copy of `mm2tpu/index/mmi.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

import struct

import numpy as np

from .build import MMIndex, RefSeq, MM_I_NO_SEQ

MAGIC = b"MMI\x02"


def read_mmi(path: str) -> MMIndex:
    """Read the first part of a .mmi file."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError("not a .mmi index")
        return _read_part(f)


def read_mmi_parts(path: str):
    """Generator over all parts of a (possibly multi-part) .mmi file
    (mm_idx_reader_read/eof semantics, index.c:586-605)."""
    with open(path, "rb") as f:
        while True:
            magic = f.read(4)
            if len(magic) < 4:
                return
            if magic != MAGIC:
                raise ValueError("corrupt .mmi part header")
            yield _read_part(f)


def _read_part(f) -> MMIndex:
    w, k, b, n_seq, flag = struct.unpack("<5I", f.read(20))
    mi = MMIndex(w=w, k=k, b=b, flag=flag)
    sum_len = 0
    for _ in range(n_seq):
        (l,) = struct.unpack("<B", f.read(1))
        name = f.read(l).decode() if l else None
        (ln,) = struct.unpack("<I", f.read(4))
        mi.seq.append(RefSeq(name=name, offset=sum_len, length=ln))
        sum_len += ln
    try:
        from ..native import lib as native_lib
        has_native = native_lib.has_mmi_reader()
    except Exception:
        has_native = False
    if has_native:
        # native parse. Chunk sizing: each ValueError retry re-parses
        # from scratch AND copies the whole buffer, so undershooting is
        # expensive at genome scale (a 1.4 GB part re-parsed 3x). When
        # the remaining file is one part (the common case) slurp it all;
        # otherwise start at the remaining size capped at 4 GB — still
        # only over-reads into the next part's header, never re-parses.
        base = f.tell()
        import os as _os
        remaining = _os.fstat(f.fileno()).st_size - base
        chunk = max(64 << 20, min(remaining, 4 << 30))
        data = bytearray(f.read(chunk))
        while True:
            try:
                keys, start, cnt, pos, consumed = \
                    native_lib.read_mmi_buckets(data, b)
                break
            except ValueError:
                more = f.read(chunk)
                if not more:
                    raise
                data += more  # amortized in-place growth
                chunk *= 2
        mi.keys, mi.start, mi.cnt, mi.pos = keys, start, cnt, pos
        s_words = 0 if (flag & MM_I_NO_SEQ) else (sum_len + 7) // 8
        if s_words:
            short = consumed + 4 * s_words - len(data)
            if short > 0:  # S region extends past the scanned chunks
                data += f.read(short)
            mi.S = np.frombuffer(
                data[consumed: consumed + 4 * s_words], dtype=np.uint32)
        f.seek(base + consumed + 4 * s_words)
        return mi
    # collect per-bucket entry arrays, then sort/gather globally
    p_chunks, m_chunks, v_chunks, s_chunks = [], [], [], []
    p_off = 0
    for bucket in range(1 << b):
        (n,) = struct.unpack("<i", f.read(4))
        p = np.frombuffer(f.read(8 * n), dtype=np.uint64)
        (size,) = struct.unpack("<I", f.read(4))
        p_chunks.append(p)
        if size == 0:
            p_off += n
            continue
        kv = np.frombuffer(f.read(16 * size), dtype=np.uint64).reshape(-1, 2)
        key, val = kv[:, 0], kv[:, 1]
        minier = (key >> np.uint64(1)) << np.uint64(b) | np.uint64(bucket)
        single = (key & np.uint64(1)) != 0
        # start into the global p stream; singles marked -1 (resolved below)
        st = np.where(single, np.int64(-1),
                      (val >> np.uint64(32)).astype(np.int64) + p_off)
        m_chunks.append(minier)
        v_chunks.append(val)
        s_chunks.append(st)
        p_off += n
    if not (flag & MM_I_NO_SEQ):
        mi.S = np.frombuffer(f.read(4 * ((sum_len + 7) // 8)), dtype=np.uint32)
    if m_chunks:
        miniers = np.concatenate(m_chunks)
        vals = np.concatenate(v_chunks)
        st_all = np.concatenate(s_chunks)
        single = st_all < 0
        # singleton payloads become a tail region of the p stream so the
        # final re-pack is one gather
        sv = vals[single]
        st_all[single] = p_off + np.arange(len(sv), dtype=np.int64)
        cnt_all = np.where(single, np.int64(1),
                           (vals & np.uint64(0xFFFFFFFF)).astype(np.int64))
        P = np.concatenate(p_chunks + [sv])
        order = np.argsort(miniers)
        mi.keys = miniers[order]
        cnts = cnt_all[order]
        src = st_all[order]
        new_starts = np.concatenate(([0], np.cumsum(cnts)[:-1]))
        total = int(cnts.sum())
        gi = (np.repeat(src, cnts) + np.arange(total, dtype=np.int64)
              - np.repeat(new_starts, cnts))
        mi.start = new_starts.astype(np.int64)
        mi.cnt = cnts.astype(np.int32)
        mi.pos = P[gi]
    return mi


def write_mmi(mi: MMIndex, path: str, append: bool = False) -> None:
    """Write one index part; append=True adds a part to an existing file
    (multi-part dump, mm_idx_dump per reader part)."""
    b = mi.b
    mask = np.uint64((1 << b) - 1)
    bucket_of = (mi.keys & mask).astype(np.int64) if len(mi.keys) else np.zeros(0, np.int64)
    with open(path, "ab" if append else "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<5I", mi.w, mi.k, mi.b, mi.n_seq, mi.flag))
        sum_len = 0
        for s in mi.seq:
            name = (s.name or "").encode()
            f.write(struct.pack("<B", len(name)))
            f.write(name)
            f.write(struct.pack("<I", s.length))
            sum_len += s.length
        # group keys by bucket (stable: keys stay sorted within a bucket),
        # assemble the whole p/kv payload globally, then slice per bucket
        order = np.argsort(bucket_of, kind="stable")
        sorted_buckets = bucket_of[order]
        bnd = np.searchsorted(sorted_buckets, np.arange((1 << b) + 1))
        c_g = mi.cnt.astype(np.int64)[order]
        stj_g = mi.start.astype(np.int64)[order]
        single_g = c_g == 1
        multi_g = ~single_g
        mc = c_g[multi_g]
        mb = sorted_buckets[multi_g]
        cs = np.concatenate(([0], np.cumsum(mc)))
        total_p = int(cs[-1])
        # per-bucket restart of the p-stream offsets: base = global offset
        # at the bucket's first multi-occurrence key
        first = np.concatenate(([True], mb[1:] != mb[:-1])) \
            if len(mb) else np.zeros(0, bool)
        base = np.maximum.accumulate(np.where(first, cs[:-1], 0)) \
            if len(mb) else cs[:0]
        out_start = cs[:-1] - base
        if total_p:
            gi = (np.repeat(stj_g[multi_g], mc)
                  + np.arange(total_p, dtype=np.int64)
                  - np.repeat(cs[:-1], mc))
            p_all = mi.pos[gi]
        else:
            p_all = np.zeros(0, np.uint64)
        kv = np.empty((len(order), 2), np.uint64)
        kv[:, 0] = ((mi.keys[order] >> np.uint64(b)) << np.uint64(1)) | single_g
        if single_g.any():
            kv[single_g, 1] = mi.pos[stj_g[single_g]]
        if len(mc):
            kv[multi_g, 1] = ((out_start.astype(np.uint64) << np.uint64(32))
                              | mc.astype(np.uint64))
        plen = (np.bincount(mb, weights=mc, minlength=1 << b).astype(np.int64)
                if len(mb) else np.zeros(1 << b, np.int64))
        pbnd = np.concatenate(([0], np.cumsum(plen)))
        for bucket in range(1 << b):
            lo, hi = bnd[bucket], bnd[bucket + 1]
            plo, phi = pbnd[bucket], pbnd[bucket + 1]
            f.write(struct.pack("<i", int(phi - plo)))
            f.write(p_all[plo:phi].tobytes())
            f.write(struct.pack("<I", int(hi - lo)))
            f.write(kv[lo:hi].tobytes())
        if not (mi.flag & MM_I_NO_SEQ) and mi.S is not None:
            f.write(mi.S.astype(np.uint32).tobytes())
