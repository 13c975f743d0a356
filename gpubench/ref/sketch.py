"""(w,k)-minimizers with minimap2 v2.18's semantics (sketch.c:77-143).

`sketch` is a frozen copy of the scalar port in
`mm2tpu_torch/index/sketch.py` (itself a copy of `mm2tpu/index/sketch.py`),
with `hash64` from `utils/hashing.py`: exact, emission order included.
The reference sketches each read with it.

`sketch_genome` gives the same minimizers for a whole genome in a few
vectorised passes (plain PyTorch, on the card or the CPU). Where no two
equal k-mers lie within one window, a k-mer is emitted exactly when it
is the least of some full window of w k-mers, once. Around equal k-mers
closer than w (a tandem repeat), the scalar `sketch` runs on the stretch
with a margin on each side, and its output, duplicates included, takes
the place of the vectorised one there.
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

U64MAX = 0xFFFFFFFFFFFFFFFF

SEQ_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    SEQ_NT4[ord(_c)] = _i
    SEQ_NT4[ord(_c.lower())] = _i
SEQ_NT4[ord("U")] = 3
SEQ_NT4[ord("u")] = 3


def hash64(key: int, mask: int = 0xFFFFFFFFFFFFFFFF) -> int:
    """Thomas Wang's invertible 64-bit mix, masked to 2k bits
    (sketch.c:28-38)."""
    M = 0xFFFFFFFFFFFFFFFF
    key = ((~key & M) + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def encode_nt4(seq) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, bytes):
        seq = np.frombuffer(seq, dtype=np.uint8)
    return SEQ_NT4[np.asarray(seq, np.uint8)]


def sketch(c_arr: np.ndarray, w: int, k: int, rid: int,
           is_hpc: bool = False) -> List[Tuple[int, int]]:
    """The scalar mm_sketch on nt4 codes: [(x, y), ...] in emission order.
    x = hash64(canonical k-mer) << 8 | span, y = rid << 32 | last_pos << 1
    | strand."""
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
                    i += skip_len - 1
                tq.append(skip_len)
                kmer_span += skip_len
                if len(tq) > k:
                    kmer_span -= tq.popleft()
            else:
                kmer_span = l + 1 if l + 1 < k else k
            kmer0 = ((kmer0 << 2) | c) & mask
            kmer1 = (kmer1 >> 2) | ((3 ^ c) << shift1)
            if kmer0 == kmer1:
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
            for j in range(buf_pos + 1, w):
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    out.append(buf[j])
            for j in range(0, buf_pos):
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    out.append(buf[j])
        if info[0] <= mn[0]:
            if l >= w + k and mn[0] != U64MAX:
                out.append(mn)
            mn, min_pos = info, buf_pos
        elif buf_pos == min_pos:
            if l >= w + k - 1 and mn[0] != U64MAX:
                out.append(mn)
            mn = (U64MAX, U64MAX)
            for j in range(buf_pos + 1, w):
                if mn[0] >= buf[j][0]:
                    mn, min_pos = buf[j], j
            for j in range(0, buf_pos + 1):
                if mn[0] >= buf[j][0]:
                    mn, min_pos = buf[j], j
            if l >= w + k - 1 and mn[0] != U64MAX:
                for j in range(buf_pos + 1, w):
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


def sketch_np(seq, w: int, k: int, rid: int) -> np.ndarray:
    """`sketch` of a sequence (str, bytes or uint8 ASCII) as an (n, 2)
    uint64 array."""
    mm = sketch(encode_nt4(seq), w, k, rid)
    if not mm:
        return np.zeros((0, 2), dtype=np.uint64)
    return np.array(mm, dtype=np.uint64)


def _hash64_t(key, mask: int):
    """hash64 on an int64 tensor of k-mers below 2**(2k), k <= 15: every
    intermediate stays below 2**63."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    return (key + (key << 31)) & mask


def _sketch_contig(codes, w: int, k: int, rid: int, device):
    """Vectorised minimizers of one contig without ambiguous bases:
    (x, y) int64 tensors, sorted by position, with the scalar sketch's
    output in place around equal k-mers closer than w."""
    import torch
    n = len(codes)
    m = n - k + 1
    if m < w:  # too short for a full window: the scalar one decides
        mm = sketch_np(codes, w, k, rid) if n else np.zeros((0, 2), np.uint64)
        return (torch.as_tensor(mm[:, 0].view(np.int64), device=device),
                torch.as_tensor(mm[:, 1].view(np.int64), device=device))
    c = torch.as_tensor(SEQ_NT4[codes].astype(np.int64), device=device)
    fwd = torch.zeros(m, dtype=torch.int64, device=device)
    rev = torch.zeros(m, dtype=torch.int64, device=device)
    for t in range(k):
        seg = c[t:t + m]
        fwd = (fwd << 2) | seg
        rev = rev | ((3 - seg) << (2 * t))
    del c
    mask = (1 << (2 * k)) - 1
    z = (fwd > rev).to(torch.int64)
    x = (_hash64_t(torch.minimum(fwd, rev), mask) << 8) | k
    del fwd, rev
    # the least value of each full window of w k-mers, and each k-mer that
    # equals the least of a window holding it
    mins = x[:m - w + 1].clone()
    for d in range(1, w):
        mins = torch.minimum(mins, x[d:d + m - w + 1])
    sel = torch.zeros(m, dtype=torch.bool, device=device)
    for d in range(w):
        # window s = i - d, for i in [d, d + m - w]
        sel[d:d + m - w + 1] |= x[d:d + m - w + 1] == mins
    tie = torch.zeros(m, dtype=torch.bool, device=device)
    for d in range(1, w):
        e = x[:m - d] == x[d:]
        tie[:m - d] |= e
        tie[d:] |= e
    pos = torch.nonzero(sel).flatten()
    y_of = lambda p: (rid << 32) | ((p + k - 1) << 1) | z[p]  # noqa: E731
    xs, ys = x[pos], y_of(pos)
    tpos = torch.nonzero(tie).flatten().cpu().numpy()
    if len(tpos) == 0:
        return xs, ys
    # tie zones: the scalar sketch with a margin, its output replacing the
    # vectorised one over each zone's core
    margin = 3 * w + k
    zones, a = [], tpos[0]
    for p0, p1 in zip(tpos[:-1], tpos[1:]):
        if p1 - p0 > 2 * margin:
            zones.append((a, p0))
            a = p1
    zones.append((a, tpos[-1]))
    keep = torch.ones(len(pos), dtype=torch.bool, device=device)
    xs_extra, ys_extra = [], []
    for a, b in zones:
        lo, hi = max(0, a - w), min(m - 1, b + w)   # the core, in k-mers
        keep &= ~((pos >= lo) & (pos <= hi))
        s0 = max(0, a - margin)
        s1 = min(n, b + margin + k)
        mm = sketch(SEQ_NT4[codes[s0:s1]], w, k, 0)
        for xv, yv in mm:
            p = ((yv & 0xFFFFFFFF) >> 1) + s0 - (k - 1)  # k-mer index
            if lo <= p <= hi:
                xs_extra.append(xv)
                ys_extra.append((rid << 32) | ((p + k - 1) << 1) | (yv & 1))
    xs = torch.cat([xs[keep], torch.as_tensor(
        np.array(xs_extra, np.uint64).view(np.int64), device=device)])
    ys = torch.cat([ys[keep], torch.as_tensor(
        np.array(ys_extra, np.uint64).view(np.int64), device=device)])
    return xs, ys


def sketch_genome(genome, w: int, k: int, device):
    """The minimizers of every contig of `genome` (`gen.genome.Genome`):
    (x, y) int64 tensors on `device`."""
    import torch
    if k % 2 == 0 or k > 15:
        raise ValueError("the vectorised sketch takes an odd k <= 15")
    xs, ys = [], []
    for rid in range(len(genome.lens)):
        codes = np.asarray(genome.contig(rid))
        if (SEQ_NT4[codes] > 3).any():
            raise ValueError("contig %d has ambiguous bases" % rid)
        x, y = _sketch_contig(codes, w, k, rid, device)
        xs.append(x)
        ys.append(y)
    return torch.cat(xs), torch.cat(ys)
