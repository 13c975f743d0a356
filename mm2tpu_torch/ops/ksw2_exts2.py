"""Batched ksw2 exts2 splice extension with the backtrack on the device.

Counterpart of the exts2 half of `mm2tpu/ops/ksw2_pallas.py`:
`_exts2_kernel` + `exts2_device` (K4) and the host side of `exts2_batch`
(:1100-1234). The contract is the Pallas kernel's, field for field: the
ez registers. The port's kernel also selects the backtrack start and
walks the direction plane, as `ksw2_extd2` does for K3, so only the ez
registers, the per-step op codes (255 = inactive, 3 = N) and the final
(i, j) of the trace come back; `exts2_batch` builds the CIGARs from them
exactly as `_backtrack_abs(..., min_intron_len=long_thres)` does.
`csrc/ksw2_exts2.cu` states the Hopper design.

- `pack_splice_fills`: the host packing of `exts2_batch` (skip rules,
  `sc_N`, the sf image, the donor/acceptor rows with each fill's junc).
- `exts2_traced_reference`: the plain PyTorch version, serial over
  anti-diagonal rows and vectorised over (fill, column), then the trace.
- `ring_need`, `ring_plan`, `launch_plan`: the columns of the
  shared-memory ring each fill's rows need, a launch's ring width,
  shared memory and the fills too wide for it, and the layout of its
  direction planes.
- `exts2_traced`: the wrapper. A CPU tensor runs the plain version; a
  CUDA tensor launches `csrc/ksw2_exts2.cu` or raises.
- `exts2_batch`: (q8, t8, junc) fills in, `ExtzResult`s with CIGARs out.

`launches` counts kernel launches, `wide_fills` the fills they ran on
state in device memory (too wide for the ring) and `reference_calls`
runs of the plain version; `launch_stamps()` gives the calling thread's
last launch's (B, 3) int64 `%globaltimer` readings of each fill (start,
after the last row, after the trace), on the card. What the splice DP shares with extd2 (the
band geometry with w = -1, the registers from per-row records, the trace
and its host tail, the packing class and the transfer) comes from
`ksw2_extd2`.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import count_lock, launching

from .ksw2_extd2 import (BIG, NREG, _NEXT, Packed, _cigar_from_ops,
                         _geometry, _next_state_table, _registers, _sf_image,
                         _trace_reference, band_cap, launch_stamps,
                         record_stamps, run_packed, set_ez_fields, R_MAXQ,
                         R_MAXT, R_ZDROP)
from .ksw2_extd2 import _check_inputs as _check_planes
from ..utils import profiling
from .ksw2_ref import (KSW_EZ_APPROX_DROP, KSW_EZ_APPROX_MAX,
                       KSW_EZ_EXTZ_ONLY, KSW_EZ_REV_CIGAR, KSW_EZ_RIGHT,
                       KSW_EZ_SPLICE_FLANK, KSW_EZ_SPLICE_FOR,
                       KSW_EZ_SPLICE_REV, KSW_NEG_INF, ExtzResult)

launches = 0
wide_fills = 0
reference_calls = 0

# csrc/ksw2_exts2.cu: the widest ring (columns), the int32 values a ring
# column holds (u, v, x, y, x2, H in two generations, s), the trace's
# staged tile and the dynamic shared memory a block may have
RING_MAX = 4096
RING_STATES = 13
TRACE_TILE_BYTES = (2 * 64 - 1) * 64
SMEM_MAX = 232448 - 1024

_NEXT_INTRON = _next_state_table(intron=True)


def gap_constants(q: int, e: int, q2: int):
    """(long_thres, long_diff) of the splice DP: e is the only extension
    cost (ksw2_pallas.py:1111-1114, ksw2_exts2_sse.c:93-96). long_thres
    is also the trace's min_intron_len."""
    long_thres = (q2 - q) // e - 1
    if q2 > q + e + long_thres * e:
        long_thres += 1
    return long_thres, long_thres * e - (q2 - q)


def site_arrays(tlen: int, tpad: int, target: np.ndarray, junc,
                noncan: int, junc_bonus: int, flag: int):
    """Donor and acceptor score rows (tpad,) int32 of one target: the
    values of `ksw2_splice_ref._site_arrays` (ksw2_exts2_sse.c:119-171),
    computed with whole-array numpy instead of a Python loop a base (the
    loop set the pace of a flush's packing). A site whose motif matches
    scores 0, one with a half motif under SPLICE_FLANK -(noncan // 2),
    any other -noncan; a --junc-bed flag adds junc_bonus; with REV_CIGAR
    the sequences are reversed and so are the motifs."""
    donor = np.zeros(tpad, np.int32)
    acceptor = np.zeros(tpad, np.int32)
    fw, rv = bool(flag & KSW_EZ_SPLICE_FOR), bool(flag & KSW_EZ_SPLICE_REV)
    if not (fw or rv):
        return donor, acceptor
    semi = -(noncan // 2) if flag & KSW_EZ_SPLICE_FLANK else 0
    donor[:] = -noncan
    acceptor[:] = -noncan
    t = np.asarray(target, np.int32)[:tlen]
    mirror = bool(flag & KSW_EZ_REV_CIGAR)
    # (second base of GT / CT (or of GA / CA mirrored), the third base,
    # the fourth's two choices) for the donor; (AG / AC, or TG / TC
    # mirrored) and the base before them for the acceptor
    d2, d4 = (0, (1, 3)) if mirror else (3, (0, 2))
    a1, a0 = (3, (0, 2)) if mirror else (0, (1, 3))
    n = max(tlen - 4, 0)
    can = ((fw & (t[1:n + 1] == 2)) | (rv & (t[1:n + 1] == 1))) \
        & (t[2:n + 2] == d2)
    full = can & np.isin(t[3:n + 3], d4)
    donor[:n] = np.where(full, 0, np.where(can, semi, -noncan))
    if tlen > 2:
        can = ((fw & (t[2:] == 2)) | (rv & (t[2:] == 1))) & (t[1:-1] == a1)
        full = can & np.isin(t[:-2], a0)
        acceptor[2:tlen] = np.where(full, 0, np.where(can, semi, -noncan))
    if junc is not None:
        j = np.asarray(junc, np.int32)[:tlen]
        don_bits, acc_bits = ((2, 4), (1, 8)) if mirror else ((1, 8), (2, 4))
        donor[:tlen - 1] += np.where((fw & (j[1:] & don_bits[0] != 0))
                                     | (rv & (j[1:] & don_bits[1] != 0)),
                                     junc_bonus, 0).astype(np.int32)
        acceptor[:tlen] += np.where((fw & (j & acc_bits[0] != 0))
                                    | (rv & (j & acc_bits[1] != 0)),
                                    junc_bonus, 0).astype(np.int32)
    return donor, acceptor


def ring_need(qlen, tlen):
    """Ring columns the rows of each (qlen, tlen) fill need: the largest
    over rows r of M_r - st_r + 2, where st_r is the row's 16-aligned
    start and M_r the largest hi = max(en, fe - 1) of rows 0..r, so that
    the columns a row reads (from st_r - 1 on) and every column written
    since they were last written (up to M_r) never share a slot t mod W.
    In closed form (held against the row spans in the tests): tlen + 16
    when tlen < qlen, else qlen + 16 + min(tlen - qlen, 15, 16 - (qlen -
    1) % 16). At most min(qlen, tlen) + 31."""
    q = np.asarray(qlen, np.int64)
    t = np.asarray(tlen, np.int64)
    return np.where(t < q, t + 16, q + 16 + np.minimum(
        np.minimum(t - q, 15), 16 - (q - 1) % 16))


def ring_plan(lens_h):
    """(W, smem bytes, wide mask) of one launch over fills lens_h (B, 2)
    = [qlen, tlen]: a fill whose `ring_need` exceeds RING_MAX runs on
    state in device memory (wide); W is the smallest power of two (at
    least 16) that the others need, and the block's dynamic shared memory
    holds W columns of RING_STATES int32 values or the trace's tile,
    whichever is larger."""
    lens_h = np.asarray(lens_h, np.int64).reshape(-1, 2)
    need = ring_need(lens_h[:, 0], lens_h[:, 1])
    wide = need > RING_MAX
    most = int(need[~wide].max()) if (~wide).any() else 16
    W = max(16, 1 << (most - 1).bit_length())
    return W, max(RING_STATES * 4 * W, TRACE_TILE_BYTES), wide


def launch_plan(lens_h):
    """Host side of one kernel launch over fills lens_h (B, 2): (meta (B,
    3) int64 = [byte offset of the fill's direction plane, its row width
    band_cap(qlen, tlen, -1), -1 for a ring fill else its index in the
    device-memory state], plane bytes, Smax = the most rows, W, smem,
    wide mask) (`ring_plan`). Each plane holds R_b rows of its width,
    laid end to end."""
    lens_h = np.asarray(lens_h, np.int64).reshape(-1, 2)
    R = lens_h.sum(1) - 1
    caps = np.array([band_cap(int(a), int(b), -1) for a, b in lens_h],
                    np.int64)
    d_off = np.concatenate(([0], np.cumsum(R * caps)))
    W, smem, wide = ring_plan(lens_h)
    slot = np.where(wide, np.cumsum(wide) - 1, -1)
    return (np.stack([d_off[:-1], caps, slot], 1), int(d_off[-1]),
            int(R.max()), W, smem, wide)


def pack_splice_fills(tasks: Sequence[tuple], mat, q: int, e: int, q2: int,
                      noncan: int, junc_bonus: int, flag: int) -> Packed:
    """Host packing of `ksw2_pallas.exts2_batch` (:1158-1198) without its
    shape ladder. Tasks are (q8, t8, junc), junc the fill's --junc-bed
    flags or None. Nothing runs when q2 <= q + e, and a task does not run
    when it is empty or -min_sc > 2(q+e) (its ExtzResult stays the
    default, as in ksw_exts2_sse). sc_N is -e when mat[24] == 0. Tpad =
    16-rounded longest target + 16, Qpad = 16-rounded longest query; the
    donor/acceptor rows come from `site_arrays` over each target's
    16-rounded length, zero past it."""
    mat = np.asarray(mat, np.int32).reshape(-1)
    sc_mch, sc_mis = int(mat[0]), int(mat[1])
    sc_N = -e if mat[24] == 0 else int(mat[24])
    min_sc = int(mat[1:].min())
    run_idx = [] if q2 <= q + e else [
        i for i, (q8, t8, _) in enumerate(tasks)
        if len(q8) > 0 and len(t8) > 0 and -min_sc <= 2 * (q + e)]
    B = len(run_idx)
    Tpad = (max((len(tasks[i][1]) for i in run_idx), default=0) + 15) \
        // 16 * 16 + 16
    Qpad = max(16, (max((len(tasks[i][0]) for i in run_idx), default=0)
                    + 15) // 16 * 16)
    lens = np.zeros((B, 2), np.int32)
    tsf = np.zeros((B, Tpad), np.uint8)
    qcol = np.zeros((B, Qpad), np.uint8)
    don = np.zeros((B, Tpad), np.int32)
    acc = np.zeros((B, Tpad), np.int32)
    for bi, i in enumerate(run_idx):
        q8, t8, junc = tasks[i]
        qlen, tlen = len(q8), len(t8)
        lens[bi] = (qlen, tlen)
        qr = np.zeros((qlen + 15) // 16 * 16 + 16, np.int32)
        qr[:qlen] = np.asarray(q8, np.int32)[::-1]
        t32 = np.asarray(t8, np.int32)
        tsf[bi] = _sf_image(t32, Tpad, qr)
        qcol[bi, :qlen] = np.asarray(q8, np.uint8)
        tpad_c = (tlen + 15) // 16 * 16
        don[bi, :tpad_c], acc[bi, :tpad_c] = site_arrays(
            tlen, tpad_c, t32, junc, noncan, junc_bonus, flag)
    return Packed(run_idx, lens, tsf, qcol, sc_mch, sc_mis, sc_N, don, acc)


def exts2_traced_reference(lens, tsf, qcol, don, acc, *, q: int, e: int,
                           q2: int, zdrop: int, sc_mch: int, sc_mis: int,
                           sc_N: int, right: bool, approx: bool,
                           approx_drop: bool, extz_only: bool,
                           lens_h=None):
    """Plain version of `exts2_traced`. lens (B, 2) int32, tsf (B, Tpad)
    uint8, qcol (B, Qpad) uint8, don and acc (B, Tpad) int32, all on one
    device; lens_h, if given, is lens on the host. Returns (ez (B, 16)
    int32, ops (B, Smax) uint8 with 255 = inactive, i_fin (B,) int32,
    j_fin (B,) int32), Smax = max(qlen + tlen - 1).

    The DP follows `_exts2_kernel` (ksw2_pallas.py:885-1077): no band
    (row r spans [max(0, r-qlen+1), min(tlen-1, r)], 16-aligned), the
    intron state x2 (-q2 at the start, opened at a donor's score as a
    floor, closed with the acceptor's score inside the max), the first
    column decaying to 0 past long_thres, Z-drop with slope 0. Every row
    is a (B, Tpad) masked update, so cells outside a fill's band keep
    their stale values. The state is one (5, B, Tpad + 1) tensor [x2, v,
    x, y, u]: the first three are read at t - 1 (column 0 is a pad that
    the boundary at st always replaces), y and u at t. The direction is
    the first (left-aligned) or last (right-aligned) argmax of [s, a, b,
    a2 + acc]. Rows record (max, column, H at en0, H at st0) or the H0
    walk, and the ez registers come from those records after the last
    row (`ksw2_extd2._registers` with slope 0)."""
    global reference_calls
    with count_lock:
        reference_calls += 1
    dev = lens.device
    i32, i64 = torch.int32, torch.int64
    B, T = tsf.shape
    long_thres, long_diff = gap_constants(q, e, q2)
    qe = q + e
    lens_h = np.asarray(lens.cpu().numpy() if lens_h is None else lens_h,
                        np.int64)
    qlen_h, tlen_h = lens_h[:, 0], lens_h[:, 1]
    R = int((qlen_h + tlen_h).max()) - 1
    cap = max(band_cap(int(a), int(b), -1) for a, b in lens_h)
    st0, en0, st, en, alive, n_rows = _geometry(lens_h, -1, R)

    def dev_t(a, dt=i64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    # per-row tables; a row a fill does not run gets an empty band
    rr_h = np.arange(R)[:, None]
    prev_st = np.vstack([np.full((1, B), -1), st[:-1]])
    prev_en = np.vstack([np.full((1, B), -1), en[:-1]])
    covered = (st > 0) & (prev_st <= st - 1) & (st - 1 <= prev_en)
    row0 = np.where(rr_h == 0, -qe, np.where(
        rr_h < long_thres, -e, np.where(rr_h == long_thres, long_diff, 0)))
    fe = st0 + (en0 - st0) // 16 * 16 + 16       # end of the fresh scores
    # row r works on the columns [c0, c1) that some fill's span or fresh
    # scores reach: about the longest query wide, not the longest target
    c0s = np.where(alive, st, BIG).min(1)
    c1s = np.where(alive, np.maximum(en, fe - 1), -1).max(1) + 1
    wid = (c1s - c0s)[:, None]
    GEO = dev_t(np.stack([
        np.where(alive, st0, BIG), np.where(alive, en0, -1),
        np.where(alive, st, BIG), np.where(alive, en, -1), fe,
        st0 + (en0 - st0) // 4 * 4,              # end of the 4-lane blocks
        np.where(alive & ~covered, st, -BIG),    # st where t-1 is boundary
    ], 1)[..., None])                                            # (R, 7, B, 1)
    full = np.ones((R, B), np.int64)
    # boundary of [x2, v, x] at t-1 (column st), of [y, u] at column r
    LB = dev_t(np.stack([-q2 * full, np.where(st > 0, -qe, row0),
                         -qe * full], 1)[..., None], i32)        # (R, 3, B, 1)
    UB = dev_t(np.stack([-qe * full[:, :1], row0], 1), i32)     # (R, 2, 1)
    BND = dev_t((alive & (en >= rr_h))[:, None, :], torch.bool)   # (R, 1, B)
    bcol = np.arange(B)[None, :]
    FLAT = dev_t(np.stack([
        # H at en0 - 1 (or en0) and at st0, in the (B, Tpad) H row
        bcol * T + np.clip(np.where(en0 > 0, en0 - 1, en0), 0, T - 1),
        bcol * T + np.clip(st0, 0, T - 1),
        # u (en0 > 0) or v at en0, in the row's (5, B, c1 - c0) window
        (np.where(en0 > 0, 4, 1) * B + bcol) * wid
        + np.clip(en0 - c0s[:, None], 0, wid - 1),
    ], 1)[..., None])                                            # (R, 3, B, 1)

    col = torch.arange(T, dtype=i64, device=dev).unsqueeze(0)
    band_col = torch.arange(cap, dtype=i64, device=dev).unsqueeze(0)
    tbl = torch.tensor([sc_N if a == 4 or b == 4 else
                        (sc_mch if a == b else sc_mis)
                        for a in range(5) for b in range(5)], dtype=i32,
                       device=dev)
    sq5 = tsf.to(i64) * 5
    # F[b, R-1-m] = query[b, m]: row r's query at column t, query[r - t],
    # is column R-1-r+t of F (zero where r - t is outside)
    F = torch.zeros((B, R + T - 1), dtype=i64, device=dev)
    nq = min(qcol.shape[1], R)
    F[:, R - nq:R] = qcol[:, :nq].to(i64).flip(1)
    PB = torch.tensor([(2 << 26) - ((k & 3) << 22) - (k >> 2)
                       for k in range(T)], dtype=i64, device=dev)
    PT = (1 << 26) - col
    WTS = torch.tensor([8, 16], dtype=i32, device=dev).view(2, 1, 1)

    S = torch.empty((5, B, T + 1), dtype=i32, device=dev)    # x2 v x y u
    S[:] = torch.tensor([-q2, -qe, -qe, -qe, -qe], dtype=i32,
                        device=dev).view(5, 1, 1)
    s = torch.zeros((B, T), dtype=i32, device=dev)           # score row
    H = torch.full((B, T), KSW_NEG_INF, dtype=i64, device=dev)
    plane = torch.empty((max(R, 1), B, cap), dtype=torch.uint8, device=dev)
    REC = torch.zeros((R, B, 2 if approx else 4), dtype=i64, device=dev)
    SC = torch.full((B,), KSW_NEG_INF, dtype=i64, device=dev)
    ends = {}
    for b in range(B):
        ends.setdefault(int(n_rows[b]) - 1, []).append(b)
    ends = {r: (dev_t(bs), dev_t(tlen_h[bs] - 1)) for r, bs in ends.items()}
    H0 = last = None

    for r in range(R):
        c0, c1 = int(c0s[r]), int(c1s[r])
        st0_r, en0_r, st_r, en_r, fe_r, en1_r, stb_r = GEO[r]
        cw, s_w = col[:, c0:c1], s[:, c0:c1]
        # score row: fresh 16-blocks from st0 (stale cells persist)
        qw = F[:, R - 1 - r + c0:R - 1 - r + c1]
        torch.where((cw >= st0_r) & (cw < fe_r),
                    tbl.take(sq5[:, c0:c1] + qw), s_w, out=s_w)
        # y[r]/u[r] take boundary values where the band reaches column r;
        # the band then also overwrites them below
        if r < T:
            up = S[3:5, :, r + 1]
            up.copy_(torch.where(BND[r], UB[r], up))
        # x2, v, x at t-1, with the boundary at st; y, u at t
        left = torch.where(cw == stb_r, LB[r], S[0:3, :, c0:c1])
        S_u = S[4, :, c0 + 1:c1 + 1]
        A2 = left[0] + left[1]
        C = torch.stack([s_w, left[2] + left[1], S[3, :, c0 + 1:c1 + 1] + S_u,
                         A2 + acc[:, c0:c1]])           # s, a, b, a2 + acc
        if right:   # last of the tied maxima
            z, d = torch.max(C.flip(0), 0)
            d = 3 - d
        else:       # first of the tied maxima
            z, d = torch.max(C, 0)
        N = torch.empty((5, B, c1 - c0), dtype=i32, device=dev)
        torch.sub(z, left[1], out=N[4])
        torch.sub(z, S_u, out=N[1])
        G = C[1:3] - (z - q)
        gt = G >= 0 if right else G > 0
        torch.sub(G.clamp_(min=0), qe, out=N[2:4])
        A2 -= z - q2
        dn_w = don[:, c0:c1]
        g2 = A2 >= dn_w if right else A2 > dn_w
        torch.sub(torch.maximum(A2, dn_w), q2, out=N[0])
        d += (gt * WTS).sum(0) + g2 * 32
        plane[r].copy_(d.gather(1, (st_r - c0 + band_col).clamp_(
            0, c1 - c0 - 1)))
        S_w = S[:, :, c0 + 1:c1 + 1]
        torch.where((cw >= st_r) & (cw <= en_r), N, S_w, out=S_w)

        if not approx:
            # exact max with the H row (ksw2_pallas.py:984-1026)
            H_w = H[:, c0:c1]
            upd = (cw >= st0_r) & (cw < en0_r)
            h_idx, s_idx, uv_idx = FLAT[r]
            if r == 0:
                h_en0 = N.take(uv_idx) - qe
            else:
                h_en0 = H.take(h_idx) + N.take(uv_idx)
            at_en0 = cw == en0_r
            torch.where(at_en0, h_en0, torch.where(upd, H_w + N[1], H_w),
                        out=H_w)
            # ties: the seed at en0, then the 4-lane blocks by (lane, row
            # in lane), then the scalar tail, as the SSE scan breaks them
            pri = torch.where(cw < en1_r,
                              PB.take((cw - st0_r).clamp_(min=0)),
                              PT[:, c0:c1])
            pri = torch.where(at_en0, 3 << 26, pri)
            key = torch.where(upd | at_en0,
                              torch.add(pri, H_w, alpha=1 << 28), -(1 << 62))
            max_t = key.argmax(1, keepdim=True) + c0
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
            v_c, u_c = S[1, :, 1:], S[4, :, 1:]
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

    ez = _registers(REC, SC, GEO, dev_t(alive, torch.bool), dev_t(n_rows),
                    dev_t(n_rows), dev_t(qlen_h), dev_t(tlen_h),
                    approx=approx, do_drop=approx_drop or not approx,
                    zdrop=zdrop, e2=0)
    i0, j0 = _trace_start(ez, dev_t(qlen_h), dev_t(tlen_h), extz_only)
    ops, i_f, j_f = _trace_reference(plane, dev_t(st), dev_t(en), i0, j0,
                                     max(R, 1),
                                     _NEXT_INTRON if long_thres > 0 else _NEXT)
    return ez, ops, i_f.to(i32), j_f.to(i32)


def _trace_start(rg, qlen, tlen, extz_only: bool):
    """Backtrack start (i0, j0) from the ez registers, -1 = no CIGAR
    (`exts2_batch`, ksw2_pallas.py:1226-1233): the fill's end unless it
    was z-dropped or extends only, else the max when it has one."""
    rg = rg.to(torch.int64)
    mq, mt = rg[:, R_MAXQ], rg[:, R_MAXT]
    at_max = (rg[:, R_ZDROP] != 0) | extz_only
    have_max = (mt >= 0) & (mq >= 0)
    i0 = torch.where(~at_max, tlen - 1, torch.where(have_max, mt, -1))
    j0 = torch.where(~at_max, qlen - 1, torch.where(have_max, mq, -1))
    return i0, j0


def _check_inputs(lens, tsf, qcol, don, acc) -> None:
    _check_planes(lens, tsf, qcol)
    for name, t in (("don", don), ("acc", acc)):
        if t.device != tsf.device or t.dtype != torch.int32 or \
                t.shape != tsf.shape or not t.is_contiguous():
            raise ValueError("%s must be a contiguous %s torch.int32 tensor "
                             "on %s, got %s %s on %s" % (
                                 name, tuple(tsf.shape), tsf.device,
                                 t.dtype, tuple(t.shape), t.device))


def exts2_traced(lens, tsf, qcol, don, acc, *, q: int, e: int, q2: int,
                 zdrop: int, sc_mch: int, sc_mis: int, sc_N: int,
                 right: bool, approx: bool, approx_drop: bool,
                 extz_only: bool, lens_h=None):
    """exts2 DP + backtrack start + trace for B fills in one call. CPU
    tensors run the plain version; CUDA tensors launch
    `csrc/ksw2_exts2.cu` on the current stream. lens (B, 2) int32, tsf
    (B, Tpad) and qcol (B, Qpad) uint8, don and acc (B, Tpad) int32,
    contiguous, with Tpad >= longest target + 16, Qpad >= longest query
    and q2 > q + e (as `pack_splice_fills` makes them). lens_h is lens on
    the host (`Packed.lens`); without it the wrapper reads lens back,
    which waits for the stream. Returns (ez (B, 16) int32, ops (B, Smax)
    uint8, i_fin (B,) int32, j_fin (B,) int32)."""
    global launches, wide_fills
    kw = dict(q=q, e=e, q2=q2, zdrop=zdrop, sc_mch=sc_mch, sc_mis=sc_mis,
              sc_N=sc_N, right=right, approx=approx, approx_drop=approx_drop,
              extz_only=extz_only)
    if lens.device.type not in ("cpu", "cuda"):
        raise ValueError("exts2_traced: unsupported device %s" % lens.device)
    _check_inputs(lens, tsf, qcol, don, acc)
    lens_h = np.asarray(lens.cpu().numpy() if lens_h is None else lens_h,
                        np.int64)
    if lens_h.shape != tuple(lens.shape) or (lens_h < 1).any() or \
            int(lens_h[:, 1].max()) + 16 > tsf.shape[1] or \
            int(lens_h[:, 0].max()) > qcol.shape[1] or q2 <= q + e:
        raise ValueError("lens do not fit tsf (needs tlen + 16 <= %d) or "
                         "qcol (needs qlen <= %d), or q2 <= q + e"
                         % (tsf.shape[1], qcol.shape[1]))
    if lens.device.type == "cpu":
        return exts2_traced_reference(lens, tsf, qcol, don, acc, **kw,
                                      lens_h=lens_h)
    from . import _build
    lib = _build.load()
    B, Tpad = tsf.shape
    meta, plane_bytes, Smax, W, smem, wide = launch_plan(lens_h)
    n_wide = int(wide.sum())
    long_thres, long_diff = gap_constants(q, e, q2)
    dev = lens.device
    meta = torch.from_numpy(meta).pin_memory().to(dev, non_blocking=True)
    # the wide fills' u, v, x, y, x2, H in two generations and s, a
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
            err = lib.mm2tpu_ksw2_exts2(
                lens.data_ptr(), tsf.data_ptr(), qcol.data_ptr(),
                don.data_ptr(), acc.data_ptr(), meta.data_ptr(),
                None if state is None else state.data_ptr(),
                plane.data_ptr(), ez.data_ptr(), ops.data_ptr(),
                ij.data_ptr(), stamps.data_ptr(),
                B, Tpad, qcol.shape[1], stride, Smax, W, smem, q, e, q2,
                long_thres, long_diff, zdrop, sc_mch, sc_mis, sc_N, flags,
                stream)
    if err != 0:
        raise RuntimeError("ksw2_exts2 kernel launch failed: cudaError %d"
                           % err)
    with count_lock:
        launches += 1
        wide_fills += n_wide
    record_stamps(stamps)
    return ez, ops, ij[:, 0], ij[:, 1]


def exts2_batch(tasks: Sequence[tuple], mat, q: int, e: int, q2: int,
                noncan: int, zdrop: int, junc_bonus: int, flag: int, *,
                device, fn=None) -> List[ExtzResult]:
    """Run (q8, t8, junc) splice fills that share (mat, q, e, q2, noncan,
    zdrop, junc_bonus, flag) through one `exts2_traced` call on `device`
    and finish each on the host: the ez fields and the CIGAR, with N for
    the intron state (`ksw2_pallas.exts2_batch`, :1210-1233). There is no
    reach_end. `fn` replaces `exts2_traced` (for example with the plain
    version)."""
    fn = exts2_traced if fn is None else fn
    results: List[ExtzResult] = [ExtzResult() for _ in tasks]
    pk = pack_splice_fills(tasks, mat, q, e, q2, noncan, junc_bonus, flag)
    run_idx = pk.run_idx
    if not run_idx:
        return results
    record_stamps(None)
    ez, ops, i_f, j_f = run_packed(pk, device, lambda *planes: fn(
        *planes, q=q, e=e, q2=q2, zdrop=zdrop, sc_mch=pk.sc_mch,
        sc_mis=pk.sc_mis, sc_N=pk.sc_N, right=bool(flag & KSW_EZ_RIGHT),
        approx=bool(flag & KSW_EZ_APPROX_MAX),
        approx_drop=bool(flag & KSW_EZ_APPROX_DROP),
        extz_only=bool(flag & KSW_EZ_EXTZ_ONLY), lens_h=pk.lens))
    if profiling.enabled:
        # the flush's serial rows (its longest fill's) and the fills that
        # the kernel runs on state in device memory
        profiling.count("ext.s2_rows", int(pk.lens.sum(1).max()) - 1)
        profiling.count("ext.s2_wide", int(ring_plan(pk.lens)[2].sum()))
        st = launch_stamps()
        if st is not None:
            # the kernel's own time, from its first fill's start to its
            # last fill's end (ext.gpu_busy is the launch's, from events)
            st = st.cpu().numpy()
            profiling.add("ext.s2_kernel",
                          float(st[:, 2].max() - st[:, 0].min()) / 1e9)

    min_intron_len, _ = gap_constants(q, e, q2)
    rev_cigar = bool(flag & KSW_EZ_REV_CIGAR)
    for bi, i in enumerate(run_idx):
        rz = results[i]
        set_ez_fields(rz, ez[bi])
        # the host mirror of the device's start selection (`_trace_start`)
        if (not rz.zdropped and not (flag & KSW_EZ_EXTZ_ONLY)) or \
                (rz.max_t >= 0 and rz.max_q >= 0):
            rz.cigar = _cigar_from_ops(ops[bi], int(i_f[bi]), int(j_f[bi]),
                                       rev_cigar, min_intron_len)
    return results
