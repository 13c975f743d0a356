"""Splice-junction BED annotation (reference: index.c:640-753).

`read_bed` parses BED6/BED12 (plain or gzipped). With read_junc (the
--junc-bed path, main.c:401), BED12 block structure is converted to the
intron intervals between blocks (index.c:689-704); otherwise whole
intervals are kept. Intervals are sorted by start per contig
(mm_idx_bed_read, index.c:718-726).

`JuncAnnotation.flags` reproduces mm_idx_bed_junc (index.c:730-753):
per-base uint8 flags over [st, en) where, for an interval fully inside
the window with a known strand, bit 1|2 mark the +strand donor/acceptor
base and bit 8|4 the -strand ones. These flags feed the exts2 kernel's
junction bonus (ksw2_exts2_sse.c:132-169).

The port's copy of `mm2tpu/index/bed.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

import gzip
from typing import List, Optional

import numpy as np


def _open_text(fn: str):
    f = open(fn, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.close()
        return gzip.open(fn, "rt")
    f.seek(0)
    import io
    return io.TextIOWrapper(f)


class JuncAnnotation:
    """Per-contig sorted interval arrays: (st, en, score, strand)."""

    def __init__(self, n_seq: int):
        self.iv: List[Optional[np.ndarray]] = [None] * n_seq

    def _finalize(self, per_rid: List[List[tuple]]) -> None:
        for rid, rows in enumerate(per_rid):
            if rows:
                arr = np.array(rows, dtype=np.int64)
                self.iv[rid] = arr[np.argsort(arr[:, 0], kind="stable")]

    def flags(self, rid: int, st: int, en: int) -> np.ndarray:
        s = np.zeros(en - st, np.uint8)
        if rid < 0 or rid >= len(self.iv) or self.iv[rid] is None:
            return s
        a = self.iv[rid]
        left = int(np.searchsorted(a[:, 0], st, side="left"))
        for i in range(left, len(a)):
            ist, ien, _, strand = (int(a[i, 0]), int(a[i, 1]),
                                   int(a[i, 2]), int(a[i, 3]))
            if ist >= en:
                break
            if st <= ist and en >= ien and strand != 0:
                if strand > 0:
                    s[ist - st] |= 1
                    s[ien - 1 - st] |= 2
                else:
                    s[ist - st] |= 8
                    s[ien - 1 - st] |= 4
        return s


def read_bed(mi, fn: str, read_junc: bool = True) -> JuncAnnotation:
    """mm_idx_read_bed + mm_idx_bed_read (index.c:640-726)."""
    name2id = {s.name: i for i, s in enumerate(mi.seq)}
    per_rid: List[List[tuple]] = [[] for _ in mi.seq]
    with _open_text(fn) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if not cols or cols[0] not in name2id:
                continue
            rid = name2id[cols[0]]
            try:
                st = int(cols[1])
                en = int(cols[2])
            except (IndexError, ValueError):
                continue
            if st < 0 or st >= en:
                continue
            score = int(cols[4]) if len(cols) > 4 and _is_num(cols[4]) else 0
            strand = 0
            if len(cols) > 5 and cols[5]:
                strand = 1 if cols[5][0] == "+" else \
                    -1 if cols[5][0] == "-" else 0
            if read_junc and len(cols) >= 12 and cols[9][:1].isdigit():
                # BED12: introns = gaps between blocks (index.c:689-704)
                n_blk = int(cols[9])
                sizes = [int(x) for x in cols[10].split(",") if x != ""]
                starts = [int(x) for x in cols[11].split(",") if x != ""]
                if len(sizes) < n_blk or len(starts) < n_blk:
                    continue
                blk_en = st + starts[0] + sizes[0]
                for b in range(1, n_blk):
                    ist, ien = blk_en, st + starts[b]
                    blk_en = st + starts[b] + sizes[b]
                    if ien > ist:
                        per_rid[rid].append((ist, ien, score, strand))
            else:
                per_rid[rid].append((st, en, score, strand))
    ann = JuncAnnotation(len(mi.seq))
    ann._finalize(per_rid)
    return ann


def _is_num(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False
