"""Batched ksw2 extd2 extension (dual affine gaps) with the backtrack on
the device.

Counterpart of the extd2 half of `mm2tpu/ops/ksw2_pallas.py`:
`_extd2_kernel` + `extd2_device` (K3), `trace_device` and the start
selection of `extd2_device_traced` (K3a), and the host side of
`extd2_batch` with the device trace on. The contract is the Pallas
kernel's, field for field: the ez registers, the per-step op codes
(255 = inactive) and the final (i, j) of the trace. `csrc/ksw2_extd2.cu`
states the Hopper design.

- `pack_fills`: the host packing of `extd2_batch` (skip rule, `sc_N`,
  the sf image, the zero-padded queries).
- `extd2_traced_reference`: the plain PyTorch version, serial over
  anti-diagonal rows and vectorised over (fill, column), then a
  vectorised trace.
- `ring_need`, `ring_plan`, `launch_plan`: the columns of the
  shared-memory ring a fill's band needs, a launch's ring width, shared
  memory and the fills too wide for it, and the layout of its band
  planes.
- `extd2_traced`: the wrapper. A CPU tensor runs the plain version; a
  CUDA tensor launches `csrc/ksw2_extd2.cu` or raises.
- `extd2_batch`: (q8, t8) pairs in, `ExtzResult`s with CIGARs out.

`launches` counts kernel launches, `wide_fills` the fills they ran on
state in device memory (too wide for the ring) and `reference_calls`
runs of the plain version; `launch_stamps()` gives the calling thread's
last launch's (B, 3) int64 `%globaltimer` readings of each fill (start,
after the last row, after the trace), on the card.

Left out on purpose: the XLA shape ladder (`quantize_shapes`,
`_ROW_LADDER`), `rows_per_program` and the padding of a batch to a power
of two. They exist so that XLA compiles few programs; a CUDA kernel takes
any (B, Tpad), so a batch is exactly its fills and Tpad follows the
longest target. The direction plane holds each row's band only (row r at
the band's start `st`, width `band_cap`), not the (Rmax, B, Tpad) plane
of the TPU kernel.
"""
from __future__ import annotations

import threading
from typing import List, Sequence

import numpy as np
import torch

from . import card_spans, count_lock, launching, span_seconds

from ..utils import profiling
from .ksw2_ref import (KSW_EZ_APPROX_DROP, KSW_EZ_APPROX_MAX,
                       KSW_EZ_EXTZ_ONLY, KSW_EZ_REV_CIGAR, KSW_EZ_RIGHT,
                       KSW_NEG_INF, ExtzResult, _push_cigar)

# ---------------------------------------------------------------------------
# copied verbatim from mm2tpu/ops/ksw2_pallas.py:60-62 (regs columns)
# regs columns
R_ZDROP, R_MAX, R_MAXQ, R_MAXT, R_MQE, R_MQET, R_MTE, R_MTEQ, \
    R_SCORE, R_H0, R_LAST, R_PST, R_PEN, R_BREAK = range(14)
# ---------------------------------------------------------------------------

NREG = 16   # width of the ez register rows (the 14 columns above, 2 unused)

launches = 0
wide_fills = 0
reference_calls = 0
_stamps = threading.local()


def record_stamps(stamps) -> None:
    """Keep a launch's (B, 3) stamps (or None) as the calling thread's
    last, which the batch wrappers read under --profile."""
    _stamps.last = stamps


def launch_stamps():
    """The (B, 3) stamps of the calling thread's last K3 or K4 launch, on
    the card (None before the first)."""
    return getattr(_stamps, "last", None)

# csrc/ksw2_extd2.cu: the widest ring (columns), the int32 values a ring
# column holds (u, v, x, y, x2, y2, H in two generations, s), the
# trace's staged tile and the dynamic shared memory a block may have
RING_MAX = 2048
RING_STATES = 15
TRACE_TILE_BYTES = (2 * 64 - 1) * 64
SMEM_MAX = 232448 - 1024


# ---------------------------------------------------------------------------
# copied verbatim from mm2tpu/ops/ksw2_pallas.py:561-585
def band_offsets(qlen: int, tlen: int, w: int):
    """Host replica of the per-row band [st0, en0] -> 16-aligned [st, en]
    (pure function of the geometry; the kernel needn't emit it)."""
    if w < 0:
        w = max(qlen, tlen)
    R = qlen + tlen - 1
    r = np.arange(R, dtype=np.int64)
    st0 = np.maximum(np.maximum(0, r - qlen + 1), (r - w + 1) >> 1)
    en0 = np.minimum(np.minimum(tlen - 1, r), (r + w) >> 1)
    st = st0 // 16 * 16
    en = (en0 + 16) // 16 * 16 - 1
    return st, en, st0, en0


def _sf_image(t8: np.ndarray, Tpad: int, qr: np.ndarray) -> np.ndarray:
    """target + zero pad to the C tpad, then the qr bytes the SIMD loadu
    runs into (ops/ksw2_ref.py sf_read semantics), padded to Tpad."""
    tlen = len(t8)
    tpad_c = (tlen + 15) // 16 * 16
    out = np.zeros(Tpad, np.int32)
    out[:tlen] = t8
    if tpad_c < Tpad:
        n = min(Tpad - tpad_c, len(qr))
        out[tpad_c:tpad_c + n] = qr[:n]
    return out
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# copied from mm2tpu/ops/ksw2_pallas.py:688-710, with `min_intron_len`
# added: the leftover i-run is N (op 3) when it reaches it, as in
# _backtrack_abs (:511-513)
def _cigar_from_ops(ops_row: np.ndarray, i_fin: int, j_fin: int,
                    rev_cigar: bool, min_intron_len: int = 0) -> List[int]:
    """Host tail of trace_device: RLE the op codes + the final D/N and I
    runs, reproducing _backtrack_abs's _push_cigar merging exactly."""
    n = int(np.argmax(ops_row == 255)) if ops_row[-1] == 255 else \
        len(ops_row)
    if n == 0 and ops_row[0] == 255:
        n = 0
    cigar: List[int] = []
    if n:
        v = ops_row[:n].astype(np.int32)
        brk = np.flatnonzero(v[1:] != v[:-1])
        starts = np.concatenate(([0], brk + 1))
        ends = np.concatenate((brk + 1, [n]))
        for s, t in zip(starts, ends):
            _push_cigar(cigar, int(v[s]), int(t - s))
    if i_fin >= 0:
        _push_cigar(cigar, 3 if 0 < min_intron_len <= i_fin else 2,
                    i_fin + 1)
    if j_fin >= 0:
        _push_cigar(cigar, 1, j_fin + 1)
    if not rev_cigar:
        cigar.reverse()
    return cigar
# ---------------------------------------------------------------------------


def band_cap(qlen, tlen, w: int):
    """Bytes of one direction row: every 16-aligned band [st, en] of the
    fill fits (`n_col_ * 16` of ksw_extd2_sse, native/mm2tpu_native.cpp
    :981-997). qlen and tlen are ints, or arrays of one launch's fills
    (then an array)."""
    narrow = np.minimum(qlen, tlen)
    if w >= 0:
        narrow = np.minimum(narrow, w + 1)
    cap = ((narrow + 15) // 16 + 1) * 16
    return cap if np.ndim(cap) else int(cap)


def gap_constants(q: int, e: int, q2: int, e2: int):
    """(q, e, q2, e2, long_thres, long_diff) after the reference's swap
    that makes (q, e) the short-gap pair (ksw2_pallas.py:433-438)."""
    if q2 + e2 < q + e:
        q, q2, e, e2 = q2, q, e2, e
    long_thres = (q2 - q) // (e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2
    return q, e, q2, e2, long_thres, long_diff


class Packed:
    """One flush's fills, packed on the host (`extd2_batch`'s layout
    without the shape ladder): `run_idx` are the task indices that run;
    lens (B, 2) int32 = [qlen, tlen]; tsf (B, Tpad) uint8, the sf image
    of each target; qcol (B, Qpad) uint8, each query zero-padded. Splice
    fills add don, acc (B, Tpad) int32, the donor and acceptor scores of
    each target column (`ksw2_exts2.pack_splice_fills`)."""

    def __init__(self, run_idx, lens, tsf, qcol, sc_mch, sc_mis, sc_N,
                 don=None, acc=None):
        self.run_idx = run_idx
        self.lens, self.tsf, self.qcol = lens, tsf, qcol
        self.sc_mch, self.sc_mis, self.sc_N = sc_mch, sc_mis, sc_N
        self.don, self.acc = don, acc

    def planes(self):
        return [a for a in (self.lens, self.tsf, self.qcol, self.don,
                            self.acc) if a is not None]


def pack_fills(tasks: Sequence[tuple], mat, q: int, e: int, q2: int,
               e2: int) -> Packed:
    """Host packing of `ksw2_pallas.extd2_batch` (:722-749). Empty tasks
    and a matrix with -min_sc > 2(q+e) do not run (their ExtzResult stays
    the default, as in ksw_extd2_sse). Tpad = 16-rounded longest target
    + 16 (the score row's 16-wide stores read up to en0 + 15), Qpad =
    16-rounded longest query."""
    mat = np.asarray(mat, np.int32).reshape(-1)
    sc_mch, sc_mis = int(mat[0]), int(mat[1])
    sc_N = -e2 if mat[24] == 0 else int(mat[24])
    min_sc = int(mat[1:].min())
    run_idx = [i for i, (q8, t8) in enumerate(tasks)
               if len(q8) > 0 and len(t8) > 0 and -min_sc <= 2 * (q + e)]
    B = len(run_idx)
    Tpad = (max((len(tasks[i][1]) for i in run_idx), default=0) + 15) \
        // 16 * 16 + 16
    Qpad = max(16, (max((len(tasks[i][0]) for i in run_idx), default=0)
                    + 15) // 16 * 16)
    lens = np.zeros((B, 2), np.int32)
    tsf = np.zeros((B, Tpad), np.uint8)
    qcol = np.zeros((B, Qpad), np.uint8)
    for bi, i in enumerate(run_idx):
        q8, t8 = tasks[i]
        qlen, tlen = len(q8), len(t8)
        lens[bi] = (qlen, tlen)
        qr = np.zeros((qlen + 15) // 16 * 16 + 16, np.int32)
        qr[:qlen] = np.asarray(q8, np.int32)[::-1]
        tsf[bi] = _sf_image(np.asarray(t8, np.int32), Tpad, qr)
        qcol[bi, :qlen] = np.asarray(q8, np.uint8)
    return Packed(run_idx, lens, tsf, qcol, sc_mch, sc_mis, sc_N)


BIG = 1 << 40   # a column index no band reaches


def _geometry(lens_h: np.ndarray, w: int, R: int):
    """Band geometry of every fill on every row, from `band_offsets`:
    (st0, en0, st, en) as (R, B) int64, `alive` (R, B) bool (rows 0 ..
    the row before the band breaks or the fill ends) and the fill's row
    count qlen + tlen - 1 (B,)."""
    B = len(lens_h)
    st0 = np.zeros((R, B), np.int64)
    en0 = np.full((R, B), -1, np.int64)
    st = np.zeros((R, B), np.int64)
    en = np.full((R, B), -1, np.int64)
    alive = np.zeros((R, B), bool)
    n_rows = np.zeros(B, np.int64)
    for b, (qlen, tlen) in enumerate(lens_h):
        s, e_, s0, e0 = band_offsets(int(qlen), int(tlen), w)
        n = len(s)
        st[:n, b], en[:n, b], st0[:n, b], en0[:n, b] = s, e_, s0, e0
        brk = np.flatnonzero(s0 > e0)
        alive[:int(brk[0]) if len(brk) else n, b] = True
        n_rows[b] = n
    return st0, en0, st, en, alive, n_rows


def _next_state_table(intron: bool = False) -> np.ndarray:
    """The `_backtrack_abs` state machine as a table: entry state * 130 +
    code gives sn * 4 + op, for code = the direction byte (0..127), 128 =
    below the band (forced D) and 129 = above it (forced I). With
    `intron` (the splice fills' min_intron_len > 0) state 3 is N (op 3),
    else a long deletion (op 2)."""
    tbl = np.zeros(5 * 130, np.int64)
    for state in range(5):
        for code in range(130):
            if code >= 128:
                sn = 2 if code == 128 else 1
            else:
                tmp = code
                s1 = tmp & 7 if state == 0 else \
                    (0 if ((tmp >> (state + 2)) & 1) == 0 else state)
                sn = tmp & 7 if s1 == 0 else s1
            op = 0 if sn == 0 else (3 if sn == 3 and intron else
                                    2 if sn in (1, 3) else 1)
            tbl[state * 130 + code] = sn * 4 + op
    return tbl


def extd2_traced_reference(lens, tsf, qcol, *, q: int, e: int, q2: int,
                           e2: int, zdrop: int, sc_mch: int, sc_mis: int,
                           sc_N: int, w: int, right: bool, approx: bool,
                           approx_drop: bool, extz_only: bool,
                           end_bonus: int, lens_h=None):
    """Plain version of `extd2_traced`. lens (B, 2) int32, tsf (B, Tpad)
    uint8, qcol (B, Qpad) uint8, all on one device; lens_h, if given, is
    lens on the host. Returns (ez (B, 16) int32, ops (B, Smax) uint8
    with 255 = inactive, i_fin (B,) int32, j_fin (B,) int32), Smax =
    max(qlen + tlen - 1).

    The DP follows `_extd2_kernel` without its band window: every row is
    a (B, Tpad) masked update, so cells outside a fill's band keep their
    stale values. Each row's band [st, st + cap) of direction bytes is
    kept, cap = the batch's largest `band_cap`.

    Laid out to keep the tensor ops of a row few, since they, not the
    cells, set its time: the band geometry of every row is computed on
    the host up front; the state is one (2, 3, B, Tpad + 1) tensor, [x,
    x2, v] read at t - 1 (column 0 is a pad that the boundary at st
    always replaces) and [y, y2, u] read at t; the direction is the first
    (left-aligned) or last (right-aligned) argmax of [s, a, b, a2, b2],
    which is what the chain of `>` (`>=`) compares of the kernel yields;
    the exact max is one argmax over (H << 28) + priority. Rows record
    (max, column, H at en0, H at st0) (or the H0 walk), and the ez
    registers, Z-drop included, come from those records after the last
    row: a fill's registers stop at its Z-drop or band break, and the
    DP cells it goes on computing after that are never read."""
    global reference_calls
    with count_lock:
        reference_calls += 1
    dev = lens.device
    i32, i64 = torch.int32, torch.int64
    B, T = tsf.shape
    q, e, q2, e2, long_thres, long_diff = gap_constants(q, e, q2, e2)
    qe, qe2 = q + e, q2 + e2
    lens_h = np.asarray(lens.cpu().numpy() if lens_h is None else lens_h,
                        np.int64)
    qlen_h, tlen_h = lens_h[:, 0], lens_h[:, 1]
    R = int((qlen_h + tlen_h).max()) - 1
    cap = max(band_cap(int(a), int(b), w) for a, b in lens_h)
    st0, en0, st, en, alive, n_rows = _geometry(lens_h, w, R)
    na = alive.sum(0)

    def dev_t(a, dt=i64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    # per-row tables; a row a fill does not run gets an empty band
    rr_h = np.arange(R)[:, None]
    prev_st = np.vstack([np.full((1, B), -1), st[:-1]])
    prev_en = np.vstack([np.full((1, B), -1), en[:-1]])
    covered = (st > 0) & (prev_st <= st - 1) & (st - 1 <= prev_en)
    row0 = np.where(rr_h == 0, -qe, np.where(
        rr_h < long_thres, -e, np.where(rr_h == long_thres, long_diff,
                                        -e2)))                     # (R, 1)
    GEO = dev_t(np.stack([
        np.where(alive, st0, BIG), np.where(alive, en0, -1),
        np.where(alive, st, BIG), np.where(alive, en, -1),
        st0 + (en0 - st0) // 16 * 16 + 16,       # end of the fresh scores
        st0 + (en0 - st0) // 4 * 4,              # end of the 4-lane blocks
        np.where(alive & ~covered, st, -BIG),    # st where t-1 is boundary
    ], 1)[..., None])                                            # (R, 7, B, 1)
    full = np.ones((R, B), np.int64)
    LB = dev_t(np.stack([-qe * full, -qe2 * full,
                         np.where(st > 0, -qe, row0)], 1)[..., None], i32)
    UB = dev_t(np.stack([-qe * full[:, :1], -qe2 * full[:, :1], row0],
                        1)[..., None], i32)                       # (R, 3, 1, 1)
    UB = UB[:, :, 0]                                              # (R, 3, 1)
    BND = dev_t((alive & (en >= rr_h))[:, None, :], torch.bool)   # (R, 1, B)
    bcol = np.arange(B)[None, :] * T
    FLAT = dev_t(np.stack([
        bcol + np.clip(np.where(en0 > 0, en0 - 1, en0), 0, T - 1),
        np.where(en0 > 0, 3 * B * T, 0) + 2 * B * T + bcol
        + np.clip(en0, 0, T - 1),
        bcol + np.clip(st0, 0, T - 1),
    ], 1)[..., None])                                            # (R, 3, B, 1)

    col = torch.arange(T, dtype=i64, device=dev).unsqueeze(0)
    band_col = torch.arange(cap, dtype=i64, device=dev).unsqueeze(0)
    tbl = torch.tensor([sc_N if a == 4 or b == 4 else
                        (sc_mch if a == b else sc_mis)
                        for a in range(5) for b in range(5)], dtype=i32,
                       device=dev)
    sq5 = tsf.to(i64) * 5
    # F[b, R-1-m] = query[b, m]: row r's query at column t, query[r - t],
    # is the view F[:, R-1-r : R-1-r+T] (zero where r - t is outside)
    F = torch.zeros((B, R + T - 1), dtype=i64, device=dev)
    nq = min(qcol.shape[1], R)
    F[:, R - nq:R] = qcol[:, :nq].to(i64).flip(1)
    PB = torch.tensor([(2 << 26) - ((k & 3) << 22) - (k >> 2)
                       for k in range(T)], dtype=i64, device=dev)
    PT = (1 << 26) - col
    QV = torch.tensor([q, q2], dtype=i32, device=dev).view(2, 1, 1, 1)
    QEV = torch.tensor([qe, qe2], dtype=i32, device=dev).view(2, 1, 1, 1)
    WTS = torch.tensor([[8, 16], [32, 64]], dtype=i64,
                       device=dev).view(2, 2, 1, 1)

    S = torch.empty((2, 3, B, T + 1), dtype=i32, device=dev)
    S[:] = torch.tensor([-qe, -qe2, -qe], dtype=i32, device=dev).view(
        1, 3, 1, 1)
    C = torch.zeros((5, B, T), dtype=i32, device=dev)   # s, a, b, a2, b2
    N = torch.empty((2, 3, B, T), dtype=i32, device=dev)
    H = torch.full((B, T), KSW_NEG_INF, dtype=i64, device=dev)
    plane = torch.empty((max(R, 1), B, cap), dtype=torch.uint8, device=dev)
    REC = torch.zeros((R, B, 2 if approx else 4), dtype=i64, device=dev)
    SC = torch.full((B,), KSW_NEG_INF, dtype=i64, device=dev)
    ends = {}
    for b in range(B):
        ends.setdefault(int(n_rows[b]) - 1, []).append(b)
    ends = {r: (dev_t(bs), dev_t(tlen_h[bs] - 1)) for r, bs in ends.items()}
    s, S_l, S_u, S_in = C[0], S[0, :, :, :T], S[1, :, :, 1:], S[:, :, :, 1:]
    C_a, C_b, C4 = C[1::2], C[2::2], C[1:].view(2, 2, B, T)
    N_gap = N[:, 0:2].transpose(0, 1)     # [[x, y], [x2, y2]] like C4
    v_n, u_n = N[0, 2], N[1, 2]
    H0 = last = None

    for r in range(R):
        st0_r, en0_r, st_r, en_r, fe_r, en1_r, stb_r = GEO[r]
        # score row: fresh 16-blocks from st0 (stale cells persist)
        qw = F[:, R - 1 - r:R - 1 - r + T]
        torch.where((col >= st0_r) & (col < fe_r), tbl.take(sq5 + qw), s,
                    out=s)
        # y[r]/y2[r]/u[r] take boundary values where the band reaches
        # column r; the band then also overwrites them below
        if r < T:
            up = S[1, :, :, r + 1]
            up.copy_(torch.where(BND[r], UB[r], up))
        # x, x2, v at t-1, with the boundary at st
        left = torch.where(col == stb_r, LB[r], S_l)
        torch.add(left[0:2], left[2:3], out=C_a)
        torch.add(S_u[0:2], S_u[2:3], out=C_b)
        if right:   # last of the tied maxima
            z, d = torch.max(C.flip(0), 0)
            d = 4 - d
        else:       # first of the tied maxima
            z, d = torch.max(C, 0)
        z.clamp_(max=sc_mch)
        torch.sub(z, left[2], out=u_n)
        torch.sub(z, S_u[2], out=v_n)
        G = C4 - (z - QV)
        gt = G >= 0 if right else G > 0
        torch.sub(G.clamp_(min=0), QEV, out=N_gap)
        d += (gt * WTS).sum((0, 1))
        plane[r].copy_(d.gather(1, (st_r + band_col).clamp_(max=T - 1)))
        torch.where((col >= st_r) & (col <= en_r), N, S_in, out=S_in)

        if not approx:
            # exact max with the H row (ksw2_extd2_sse.c:326-358)
            upd = (col >= st0_r) & (col < en0_r)
            h_idx, uv_idx, s_idx = FLAT[r]
            if r == 0:
                h_en0 = N.take(uv_idx) - qe
            else:
                h_en0 = H.take(h_idx) + N.take(uv_idx)
            at_en0 = col == en0_r
            H = torch.where(at_en0, h_en0, torch.where(upd, H + v_n, H))
            # ties: the seed at en0, then the 4-lane blocks by (lane, row
            # in lane), then the scalar tail, as the SSE scan breaks them
            pri = torch.where(col < en1_r,
                              PB.take((col - st0_r).clamp_(min=0)), PT)
            pri = torch.where(at_en0, 3 << 26, pri)
            key = torch.where(upd | at_en0, torch.add(pri, H, alpha=1 << 28),
                              -(1 << 62))
            max_t = key.argmax(1, keepdim=True)
            if r == 0:
                max_t, max_h = torch.zeros_like(max_t), h_en0
            else:
                max_h = H.gather(1, max_t)
            torch.cat([max_h, max_t, h_en0, H.take(s_idx)], 1, out=REC[r])
            if r in ends:
                ib, tc = ends[r]
                SC[ib] = H[ib, tc]
        else:
            # approximate max: walk H0 along the main diagonal
            v_c, u_c = S[0, 2, :, 1:], S[1, 2, :, 1:]
            if r == 0:
                H0 = v_c[:, 0:1].to(i64) - qe
                last = torch.zeros((B, 1), dtype=i64, device=dev)
            else:
                c1 = (last >= st0_r) & (last <= en0_r)
                c2 = (last + 1 >= st0_r) & (last + 1 <= en0_r)
                d0 = v_c.gather(1, last.clamp(0, T - 1))
                d1 = u_c.gather(1, (last + 1).clamp(0, T - 1))
                both = c1 & c2
                last = last + ((both & (d1 >= d0)) | ~c1)
                H0 = H0 + torch.where(both, torch.maximum(d0, d1),
                                      torch.where(c1, d0, u_c.gather(
                                          1, last.clamp(0, T - 1))))
            torch.cat([H0, last], 1, out=REC[r])

    ez = _registers(REC, SC, GEO, dev_t(alive, torch.bool), dev_t(na),
                    dev_t(n_rows), dev_t(qlen_h), dev_t(tlen_h), approx=approx,
                    do_drop=approx_drop or not approx, zdrop=zdrop, e2=e2)
    i0, j0 = _trace_start(ez, dev_t(qlen_h), dev_t(tlen_h), extz_only,
                          end_bonus)
    ops, i_f, j_f = _trace_reference(plane, dev_t(st), dev_t(en), i0, j0,
                                     max(R, 1))
    return ez, ops, i_f.to(i32), j_f.to(i32)


def _registers(REC, SC, GEO, alive, na, n_rows, qlen, tlen, *, approx,
               do_drop, zdrop, e2):
    """The ez registers (B, 16) int32 from the per-row records: the
    running max and Z-drop (ksw_apply_zdrop, e2 as the slope) as a
    cumulative max over rows, then every register at the fill's last
    live row (its Z-drop row, the row before its band broke, or its last
    row)."""
    R, B, _ = REC.shape
    dev = REC.device
    i64 = torch.int64
    rr = torch.arange(R, dtype=i64, device=dev).unsqueeze(1)
    zH, zt = REC[:, :, 0], REC[:, :, 1]
    st0, en0, st, en = GEO[:, 0, :, 0], GEO[:, 1, :, 0], GEO[:, 2, :, 0], \
        GEO[:, 3, :, 0]
    big, none = 1 << 32, -(1 << 62)
    if do_drop:
        # the first row that sets each running max wins ties; row -1
        # holds the initial max 0
        key = torch.where(alive, zH * big - rr, none)
        _, pos = torch.cummax(torch.cat([torch.ones((1, B), dtype=i64,
                                                    device=dev), key]), 0)
        prow = pos[1:] - 1
        has = prow >= 0
        pc = prow.clamp(min=0)
        M = torch.where(has, zH.gather(0, pc), 0)
        mt = torch.where(has, zt.gather(0, pc), -1)
        mq = torch.where(has, prow - mt, -1)
        chk = alive & (prow != rr) & (zt >= mt) & (rr - zt >= mq)
        ldiff = ((zt - mt) - ((rr - zt) - mq)).abs()
        dropped = chk & (M - zH > zdrop + ldiff * e2) if zdrop >= 0 \
            else torch.zeros_like(chk)
    else:
        M = torch.zeros_like(zH)
        mt = mq = torch.full_like(zH, -1)
        dropped = torch.zeros_like(alive)
    drop_any = dropped.any(0)
    drop_row = torch.where(drop_any, dropped.to(torch.int32).argmax(0), R)
    end = torch.minimum(drop_row, na - 1).unsqueeze(0)        # (1, B)
    within = alive & (rr <= end)

    def first_max(cond, val):
        """First row of the strict running max of `val` over `cond` rows,
        from the initial KSW_NEG_INF; (value, row), row -1 if none."""
        k = torch.where(cond, val * big - rr, none)
        kmax, row = k.max(0, keepdim=True)
        ok = kmax > KSW_NEG_INF * big + 1
        return (torch.where(ok, val.gather(0, row), KSW_NEG_INF),
                torch.where(ok, row, -1))

    if not approx:
        mte, mte_r = first_max(within & (en0 == tlen - 1), REC[:, :, 2])
        mqe, mqe_r = first_max(within & (rr - st0 == qlen - 1), REC[:, :, 3])
        mte_q = torch.where(mte_r >= 0, mte_r - en.gather(0, mte_r.clamp(
            min=0)), -1)
        mqe_t = torch.where(mqe_r >= 0, st0.gather(0, mqe_r.clamp(min=0)),
                            -1)
        h0 = last = torch.zeros_like(end)
    else:
        mte = mqe = torch.full_like(end, KSW_NEG_INF)
        mte_q = mqe_t = torch.full_like(end, -1)
        h0, last = zH.gather(0, end), zt.gather(0, end)
    fin = (n_rows - 1).unsqueeze(0)
    sc_ok = ~drop_any & (na == n_rows) & \
        (en0.gather(0, fin)[0] == tlen - 1)
    score = torch.where(sc_ok, zH.gather(0, fin)[0] if approx else SC,
                        KSW_NEG_INF)
    zdropped = (drop_any | (na < n_rows)).to(i64)
    ez = torch.zeros((B, NREG), dtype=i64, device=dev)
    cols = {R_ZDROP: zdropped, R_MAX: M.gather(0, end)[0],
            R_MAXQ: mq.gather(0, end)[0], R_MAXT: mt.gather(0, end)[0],
            R_MQE: mqe[0], R_MQET: mqe_t[0], R_MTE: mte[0],
            R_MTEQ: mte_q[0], R_SCORE: score, R_H0: h0[0], R_LAST: last[0],
            R_PST: st.gather(0, end)[0], R_PEN: en.gather(0, end)[0],
            R_BREAK: zdropped}
    for k, v in cols.items():
        ez[:, k] = v
    return ez.to(torch.int32)


def _trace_start(rg, qlen, tlen, extz_only: bool, end_bonus: int):
    """Backtrack start (i0, j0) from the ez registers, -1 = no CIGAR
    (`extd2_device_traced`, ksw2_pallas.py:668-683)."""
    rg = rg.to(torch.int64)
    zdropped = rg[:, R_ZDROP] != 0
    mx, mq, mt = rg[:, R_MAX], rg[:, R_MAXQ], rg[:, R_MAXT]
    have_max = (mt >= 0) & (mq >= 0)
    if not extz_only:
        i0 = torch.where(~zdropped, tlen - 1, torch.where(have_max, mt, -1))
        j0 = torch.where(~zdropped, qlen - 1, torch.where(have_max, mq, -1))
    else:
        reach = ~zdropped & (rg[:, R_MQE] + end_bonus > mx)
        i0 = torch.where(reach, rg[:, R_MQET],
                         torch.where(have_max, mt, -1))
        j0 = torch.where(reach, qlen - 1, torch.where(have_max, mq, -1))
    return i0, j0


_NEXT = _next_state_table()


def _trace_reference(plane, st, en, i0, j0, Smax: int, table=_NEXT):
    """`trace_device` over the band plane, vectorised over fills: the
    `_backtrack_abs` state machine (`table`), one op code a step; M and
    I step j, M, D and N step i. st, en (R, B) int64: every row's
    16-aligned band."""
    R, B, cap = plane.shape
    dev = plane.device
    nxt = torch.from_numpy(table).to(dev)
    flat = plane.view(-1)
    st, en = st.reshape(-1), en.reshape(-1)
    bidx = torch.arange(B, dtype=torch.int64, device=dev)
    i, j = i0.clone(), j0.clone()
    state = torch.zeros_like(i)
    ops = torch.full((B, Smax), 255, dtype=torch.uint8, device=dev)
    steps = int((i0 + j0 + 1).clamp(min=0).max()) if B else 0
    for k in range(min(steps, Smax)):
        act = (i >= 0) & (j >= 0)
        rb = torch.add(bidx, (i + j).clamp_(0, R - 1), alpha=B)
        st_k, en_k = st.take(rb), en.take(rb)
        tmp = flat.take(torch.add((i - st_k).clamp_(0, cap - 1), rb,
                                  alpha=cap))
        code = torch.where(i < st_k, 128, torch.where(i > en_k, 129, tmp))
        nx = nxt.take(state * 130 + code)
        opc = nx & 3
        i = torch.where(act & (opc != 1), i - 1, i)
        j = torch.where(act & (opc < 2), j - 1, j)
        state = torch.where(act, nx >> 2, state)
        ops[:, k] = torch.where(act, opc, 255)
    return ops, i, j


def ring_need(qlen: int, tlen: int, w: int) -> int:
    """Ring columns the rows of one (qlen, tlen) fill under band w need:
    the largest over its rows r (up to the row before its band breaks)
    of M_r - st_r + 2, where st_r is the row's 16-aligned start and M_r
    the largest hi = max(en, fe - 1) of rows 0..r, so that the columns a
    row reads (from st_r - 1 on) and every column written since they
    were last written (up to M_r) never share a slot t mod W. At most
    `ring_bound`."""
    st, en, st0, en0 = band_offsets(qlen, tlen, w)
    brk = np.flatnonzero(st0 > en0)
    n = int(brk[0]) if len(brk) else len(st)
    fe = st0[:n] + (en0[:n] - st0[:n]) // 16 * 16 + 16
    hi = np.maximum(en[:n], fe - 1)
    return int((np.maximum.accumulate(hi) - st[:n] + 2).max())


def ring_bound(lens_h, w: int):
    """An upper bound of `ring_need` for each fill of lens_h (B, 2), in a
    few numpy operations on (B,) arrays: min(qlen, tlen, w + 1) + 31
    (a band is at most w + 1 columns wide, and M_r - st_r exceeds the
    band's width by less than 32)."""
    lens_h = np.asarray(lens_h, np.int64).reshape(-1, 2)
    narrow = lens_h.min(1)
    return (narrow if w < 0 else np.minimum(narrow, w + 1)) + 31


def ring_plan(lens_h, w: int):
    """(W, smem bytes, wide mask) of one launch over fills lens_h (B, 2)
    = [qlen, tlen] under band w. A fill's need is `ring_bound`, or its
    exact `ring_need` when the bound exceeds RING_MAX; a fill whose need
    exceeds RING_MAX runs on state in device memory (wide). W is the
    smallest power of two (at least 16) that the others need, and the
    block's dynamic shared memory holds W columns of RING_STATES int32
    values or the trace's tile, whichever is larger."""
    lens_h = np.asarray(lens_h, np.int64).reshape(-1, 2)
    need = ring_bound(lens_h, w)
    for k in np.flatnonzero(need > RING_MAX):
        need[k] = ring_need(int(lens_h[k, 0]), int(lens_h[k, 1]), w)
    wide = need > RING_MAX
    most = int(need[~wide].max()) if (~wide).any() else 16
    W = max(16, 1 << (most - 1).bit_length())
    return W, max(RING_STATES * 4 * W, TRACE_TILE_BYTES), wide


def launch_plan(lens_h, w: int):
    """Host side of one kernel launch over fills lens_h (B, 2) under band
    w: (meta (B, 3) int64 = [byte offset of the fill's band plane, its
    row width `band_cap`, -1 for a ring fill else its index in the
    device-memory state], plane bytes, Smax = the most rows, W, smem,
    wide mask) (`ring_plan`). Each plane holds R_b rows of its width,
    laid end to end; numpy on (B,) arrays, no loop over fills."""
    lens_h = np.asarray(lens_h, np.int64).reshape(-1, 2)
    R = lens_h.sum(1) - 1
    caps = band_cap(lens_h[:, 0], lens_h[:, 1], w)
    d_off = np.concatenate(([0], np.cumsum(R * caps)))
    W, smem, wide = ring_plan(lens_h, w)
    slot = np.where(wide, np.cumsum(wide) - 1, -1)
    return (np.stack([d_off[:-1], caps, slot], 1), int(d_off[-1]),
            int(R.max()), W, smem, wide)


def _check_inputs(lens, tsf, qcol) -> None:
    dev = lens.device
    if lens.dim() != 2 or lens.shape[1] != 2 or lens.shape[0] < 1:
        raise ValueError("lens must be (B, 2) with B >= 1, got %s"
                         % (tuple(lens.shape),))
    B = lens.shape[0]
    for name, t, dt in (("lens", lens, torch.int32),
                        ("tsf", tsf, torch.uint8),
                        ("qcol", qcol, torch.uint8)):
        if t.device != dev or t.dtype != dt or t.dim() != 2 or \
                t.shape[0] != B or not t.is_contiguous():
            raise ValueError("%s must be a contiguous (%d, n) %s tensor on "
                             "%s, got %s %s on %s" % (
                                 name, B, dt, dev, t.dtype, tuple(t.shape),
                                 t.device))


def extd2_traced(lens, tsf, qcol, *, q: int, e: int, q2: int, e2: int,
                 zdrop: int, sc_mch: int, sc_mis: int, sc_N: int, w: int,
                 right: bool, approx: bool, approx_drop: bool,
                 extz_only: bool, end_bonus: int, lens_h=None):
    """extd2 DP + backtrack start + trace for B fills in one call (the
    contract of `ksw2_pallas.extd2_device_traced`). CPU tensors run the
    plain version; CUDA tensors launch `csrc/ksw2_extd2.cu` on the
    current stream. lens (B, 2) int32, tsf (B, Tpad) and qcol (B, Qpad)
    uint8, contiguous, with Tpad >= longest target + 16 and Qpad >=
    longest query (as `pack_fills` makes them). lens_h is lens on the
    host (`Packed.lens`); without it the wrapper reads lens back, which
    waits for the stream. Returns (ez (B, 16) int32, ops (B, Smax) uint8,
    i_fin (B,) int32, j_fin (B,) int32)."""
    global launches, wide_fills
    kw = dict(q=q, e=e, q2=q2, e2=e2, zdrop=zdrop, sc_mch=sc_mch,
              sc_mis=sc_mis, sc_N=sc_N, w=w, right=right, approx=approx,
              approx_drop=approx_drop, extz_only=extz_only,
              end_bonus=end_bonus)
    if lens.device.type not in ("cpu", "cuda"):
        raise ValueError("extd2_traced: unsupported device %s" % lens.device)
    _check_inputs(lens, tsf, qcol)
    lens_h = np.asarray(lens.cpu().numpy() if lens_h is None else lens_h,
                        np.int64)
    if lens_h.shape != tuple(lens.shape) or (lens_h < 1).any() or \
            int(lens_h[:, 1].max()) + 16 > tsf.shape[1] or \
            int(lens_h[:, 0].max()) > qcol.shape[1]:
        raise ValueError("lens do not fit tsf (needs tlen + 16 <= %d) or "
                         "qcol (needs qlen <= %d)"
                         % (tsf.shape[1], qcol.shape[1]))
    if lens.device.type == "cpu":
        return extd2_traced_reference(lens, tsf, qcol, **kw, lens_h=lens_h)
    from . import _build
    lib = _build.load()
    B, Tpad = tsf.shape
    meta, plane_bytes, Smax, W, smem, wide = launch_plan(lens_h, w)
    n_wide = int(wide.sum())
    q_, e_, q2_, e2_, long_thres, long_diff = gap_constants(q, e, q2, e2)
    dev = lens.device
    meta = torch.from_numpy(meta).pin_memory().to(dev, non_blocking=True)
    # the wide fills' u, v, x, y, x2, y2, H in two generations and s, a
    # column's values side by side
    stride = Tpad + 16
    state = torch.empty((n_wide, stride, RING_STATES), dtype=torch.int32,
                        device=dev) if n_wide else None
    plane = torch.empty(plane_bytes, dtype=torch.uint8, device=dev)
    ez = torch.empty((B, NREG), dtype=torch.int32, device=dev)
    ops = torch.empty((B, Smax), dtype=torch.uint8, device=dev)
    ij = torch.empty((B, 2), dtype=torch.int32, device=dev)
    stamps = torch.empty((B, 3), dtype=torch.int64, device=dev)
    flags = (int(right) | int(approx) << 1 | int(approx_drop) << 2
             | int(extz_only) << 3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with launching():
            err = lib.mm2tpu_ksw2_extd2(
                lens.data_ptr(), tsf.data_ptr(), qcol.data_ptr(),
                meta.data_ptr(), None if state is None else state.data_ptr(),
                plane.data_ptr(), ez.data_ptr(), ops.data_ptr(), ij.data_ptr(),
                stamps.data_ptr(), B, Tpad, qcol.shape[1], stride, Smax, W,
                smem, q_, e_, q2_, e2_, long_thres, long_diff, zdrop, sc_mch,
                sc_mis, sc_N, w, end_bonus, flags, stream)
    if err != 0:
        raise RuntimeError("ksw2_extd2 kernel launch failed: cudaError %d"
                           % err)
    with count_lock:
        launches += 1
        wide_fills += n_wide
    record_stamps(stamps)
    return ez, ops, ij[:, 0], ij[:, 1]


def run_packed(pk: Packed, device, call):
    """Upload the packed planes of one flush to `device`, run
    `call(*planes)` -> (ez, ops, i_fin, j_fin) there and bring the four
    back as numpy arrays. Under --profile, count the flush (`ext.*`) and
    add its kernel's card time to `ext.gpu_busy` (`ops.card_spans`)."""
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    arrays = pk.planes()
    if on_cuda:
        planes = [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                  for a in arrays]
    else:
        planes = [torch.from_numpy(a).to(dev) for a in arrays]
    with card_spans(on_cuda and profiling.enabled) as spans:
        out = call(*planes)
    out = [t.cpu().numpy() for t in out]

    if profiling.enabled:  # align-stage transport evidence
        profiling.count("ext.dispatches", 1)
        profiling.count("ext.fills", len(pk.run_idx))
        if spans:
            # the kernel launch's own span (`ops.card_spans`)
            profiling.add("ext.gpu_busy", span_seconds(spans))
    return out


def set_ez_fields(rz: ExtzResult, ez_row: np.ndarray) -> None:
    """The ExtzResult fields that the ez registers carry."""
    rz.zdropped = bool(ez_row[R_ZDROP])
    rz.max = int(ez_row[R_MAX])
    rz.max_q = int(ez_row[R_MAXQ])
    rz.max_t = int(ez_row[R_MAXT])
    rz.mqe = int(ez_row[R_MQE])
    rz.mqe_t = int(ez_row[R_MQET])
    rz.mte = int(ez_row[R_MTE])
    rz.mte_q = int(ez_row[R_MTEQ])
    rz.score = int(ez_row[R_SCORE])


def extd2_batch(tasks: Sequence[tuple], mat, q: int, e: int, q2: int,
                e2: int, w: int, zdrop: int, end_bonus: int, flag: int, *,
                device, fn=None) -> List[ExtzResult]:
    """Run (q8, t8) fills that share (mat, gaps, w, zdrop, end_bonus,
    flag) through one `extd2_traced` call on `device` and finish each on
    the host: the ez fields, `reach_end`, and the CIGAR from the op codes
    (`ksw2_pallas.extd2_batch` with the device trace on, :762-828).
    `fn` replaces `extd2_traced` (for example with the plain version)."""
    fn = extd2_traced if fn is None else fn
    results: List[ExtzResult] = [ExtzResult() for _ in tasks]
    pk = pack_fills(tasks, mat, q, e, q2, e2)
    run_idx = pk.run_idx
    if not run_idx:
        return results
    record_stamps(None)
    ez, ops, i_f, j_f = run_packed(pk, device, lambda *planes: fn(
        *planes, q=q, e=e, q2=q2, e2=e2, zdrop=zdrop, sc_mch=pk.sc_mch,
        sc_mis=pk.sc_mis, sc_N=pk.sc_N, w=w, right=bool(flag & KSW_EZ_RIGHT),
        approx=bool(flag & KSW_EZ_APPROX_MAX),
        approx_drop=bool(flag & KSW_EZ_APPROX_DROP),
        extz_only=bool(flag & KSW_EZ_EXTZ_ONLY), end_bonus=int(end_bonus),
        lens_h=pk.lens))
    if profiling.enabled:
        # the flush's serial rows (its longest fill's) and the fills that
        # the kernel runs on state in device memory
        profiling.count("ext.d2_rows", int(pk.lens.sum(1).max()) - 1)
        profiling.count("ext.d2_wide", int(ring_plan(pk.lens, w)[2].sum()))
        st = launch_stamps()
        if st is not None:
            # the kernel's own time, from its first fill's start to its
            # last fill's end (ext.gpu_busy is the launch's, from events)
            st = st.cpu().numpy()
            profiling.add("ext.d2_kernel",
                          float(st[:, 2].max() - st[:, 0].min()) / 1e9)

    rev_cigar = bool(flag & KSW_EZ_REV_CIGAR)
    for bi, i in enumerate(run_idx):
        q8, t8 = tasks[i]
        qlen = len(q8)
        rz = results[i]
        set_ez_fields(rz, ez[bi])
        # the host mirror of the device's start selection (`_start`,
        # ksw2_pallas.py:806-820); it also sets reach_end
        if not rz.zdropped and not (flag & KSW_EZ_EXTZ_ONLY):
            s_i, s_j = len(t8) - 1, qlen - 1
        elif not rz.zdropped and (flag & KSW_EZ_EXTZ_ONLY) \
                and rz.mqe + end_bonus > rz.max:
            rz.reach_end = True
            s_i, s_j = rz.mqe_t, qlen - 1
        elif rz.max_t >= 0 and rz.max_q >= 0:
            s_i, s_j = rz.max_t, rz.max_q
        else:
            s_i = s_j = -1
        if s_i >= 0 and s_j >= 0:
            rz.cigar = _cigar_from_ops(ops[bi], int(i_f[bi]), int(j_f[bi]),
                                       rev_cigar)
    return results
