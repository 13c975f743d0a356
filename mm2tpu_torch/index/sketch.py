"""(w,k)-minimizer sketch with invertible hashing, HPC, and duplicate-minimum
emission — exact semantics of the reference mm_sketch (sketch.c:77-143).

Output per minimizer, as in the reference:
  x = hash64(canonical_kmer) << 8 | kmer_span
  y = rid << 32 | last_pos << 1 | strand

The port's copy of `mm2tpu/index/sketch.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

from ..utils import profiling
from ..utils.hashing import hash64

U64MAX = 0xFFFFFFFFFFFFFFFF

# A=0 C=1 G=2 T/U=3, everything else 4 (sketch.c:9 seq_nt4_table)
SEQ_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    SEQ_NT4[ord(_c)] = _i
    SEQ_NT4[ord(_c.lower())] = _i
SEQ_NT4[ord("U")] = 3
SEQ_NT4[ord("u")] = 3


def encode_nt4(seq: str | bytes) -> np.ndarray:
    """Sequence string -> nt4 codes (0..4) as uint8."""
    if isinstance(seq, str):
        seq = seq.encode()
    return SEQ_NT4[np.frombuffer(seq, dtype=np.uint8)]


def sketch(seq: str | bytes | np.ndarray, w: int, k: int, rid: int,
           is_hpc: bool = False) -> List[Tuple[int, int]]:
    """Exact reference port (sketch.c:77-143). Returns [(x, y), ...] in the
    reference's emission order (sorted by position with duplicate minima)."""
    c_arr = seq if isinstance(seq, np.ndarray) else encode_nt4(seq)
    n = len(c_arr)
    assert n > 0 and 0 < w < 256 and 0 < k <= 28
    shift1 = 2 * (k - 1)
    mask = (1 << (2 * k)) - 1
    kmer0 = kmer1 = 0
    buf: List[Tuple[int, int]] = [(U64MAX, U64MAX)] * w
    tq: deque = deque()
    out: List[Tuple[int, int]] = []
    l = buf_pos = min_pos = kmer_span = 0
    mn = (U64MAX, U64MAX)
    rid_hi = (rid & 0xFFFFFFFF) << 32

    i = 0
    while i < n:
        c = int(c_arr[i])
        info = (U64MAX, U64MAX)
        if c < 4:
            if is_hpc:
                skip_len = 1
                if i + 1 < n and int(c_arr[i + 1]) == c:
                    skip_len = 2
                    while i + skip_len < n and int(c_arr[i + skip_len]) == c:
                        skip_len += 1
                    i += skip_len - 1  # jump to end of the homopolymer run
                tq.append(skip_len)
                kmer_span += skip_len
                if len(tq) > k:
                    kmer_span -= tq.popleft()
            else:
                kmer_span = l + 1 if l + 1 < k else k
            kmer0 = ((kmer0 << 2) | c) & mask
            kmer1 = (kmer1 >> 2) | ((3 ^ c) << shift1)
            if kmer0 == kmer1:  # symmetric k-mer: strand unknown, drop
                i += 1
                continue
            z = 0 if kmer0 < kmer1 else 1
            l += 1
            if l >= k and kmer_span < 256:
                info = (hash64(kmer1 if z else kmer0, mask) << 8 | kmer_span,
                        rid_hi | ((i & 0xFFFFFFFF) << 1) | z)
        else:
            l = 0
            tq.clear()
            kmer_span = 0
        buf[buf_pos] = info
        if l == w + k - 1 and mn[0] != U64MAX:
            # first full window: emit identical-minimum dups not yet stored
            for j in range(buf_pos + 1, w):
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    out.append(buf[j])
            for j in range(0, buf_pos):
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    out.append(buf[j])
        if info[0] <= mn[0]:  # new minimum; write the old one out
            if l >= w + k and mn[0] != U64MAX:
                out.append(mn)
            mn, min_pos = info, buf_pos
        elif buf_pos == min_pos:  # old minimum slid out of the window
            if l >= w + k - 1 and mn[0] != U64MAX:
                out.append(mn)
            mn = (U64MAX, U64MAX)
            for j in range(buf_pos + 1, w):  # two loops keep min closest
                if mn[0] >= buf[j][0]:
                    mn, min_pos = buf[j], j
            for j in range(0, buf_pos + 1):
                if mn[0] >= buf[j][0]:
                    mn, min_pos = buf[j], j
            if l >= w + k - 1 and mn[0] != U64MAX:
                for j in range(buf_pos + 1, w):  # emit dups, sorted order
                    if mn[0] == buf[j][0] and mn[1] != buf[j][1]:
                        out.append(buf[j])
                for j in range(0, buf_pos + 1):
                    if mn[0] == buf[j][0] and mn[1] != buf[j][1]:
                        out.append(buf[j])
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
        i += 1
    if mn[0] != U64MAX:
        out.append(mn)
    return out


def sketch_np(seq, w, k, rid, is_hpc=False,
              native_stage=None) -> np.ndarray:
    """sketch() returning a (n,2) uint64 array [[x, y], ...]. Uses the
    native runtime when built (differentially tested against sketch()),
    its call timed under `native_stage` (`profiling.timed`) where one is
    given; each run of sketch() in its place counts as `fallback.sketch`."""
    codes = seq if isinstance(seq, np.ndarray) else encode_nt4(seq)
    try:
        from ..native import lib as native_lib
        if native_lib.available():
            if native_stage is None:
                return native_lib.sketch(codes, w, k, rid, is_hpc)
            return profiling.timed(native_stage, native_lib.sketch, codes,
                                   w, k, rid, is_hpc)
    except Exception:
        pass
    profiling.count("fallback.sketch")
    mm = sketch(codes, w, k, rid, is_hpc)
    if not mm:
        return np.zeros((0, 2), dtype=np.uint64)
    return np.array(mm, dtype=np.uint64)
