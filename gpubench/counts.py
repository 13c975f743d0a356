"""The work that the reads themselves ask of each kernel, for the
rooflines: operations and bytes counted from the real rows and fills,
never from padded shapes or from a kernel's instructions.

Chaining (K1, K2). For each real anchor i, the DP scores the
predecessors j in [lo_i, i), lo_i = max(st_i, i - min(max_iter,
window)), st_i the first anchor within max_dist_x of i on the reference
(`ref.chain.chain_scores_window`). Each such pair costs CHAIN_OPS
operations of the recurrence (chain.c:121-150), counted from that
function's body:
  dr, dq                                   2 subtractions
  same segment, the four rejection tests   5 compares, 4 logic ops
  dd = |dr - dq|                           2
  min(dq, dr), min(., span)                2
  ilog2(dd)                                2 (count leading zeros, subtract)
  dd * avg as float, back to int           3
  c_lin + (log >> 1)                       2
  * gap_scale + .499, to int               3
  sc - cost + f[j]                         2
  select on the tests, compare with best   2
                                           --
                                           29, counted as 28
Bytes: each real anchor read once (16 B: x and y as four int32) and its
f and p written once (8 B).

Extension. An extd2 fill (K3) computes the cells of its band on each
anti-diagonal r of its real qlen x tlen matrix (ksw2_extd2_sse.c:
st = max(r - qlen + 1, (r - w + 1) >> 1, 0), en = min(r, tlen - 1,
(r + w) >> 1)); a splice fill (K4, ksw2_exts2_sse.c) has no band, so
every cell of qlen x tlen. A cell of the dual affine recurrence costs
EXTD2_OPS: the match score (lookup, add), four gap states each
max(prev - e, H - q - e) (3 a state), the cell's max over five (4), and
the two trace bits (2): 2 + 12 + 4 + 2 = 20. A splice cell adds the
intron state with its donor and acceptor scores (4): EXTS2_OPS = 24.
Bytes: the query and the target read once (1 B a base), the CIGAR (4 B
an op) and the fill's result (44 B) written once.

Peak: the int32 lanes, 64 a streaming multiprocessor on Hopper, times
the multiprocessors, times the SM clock at its maximum (`nvidia-smi
clocks.max.sm`, read in the same run); HBM3 at 3.35 TB/s (H100 SXM data
sheet).
"""
from __future__ import annotations

import numpy as np

CHAIN_OPS = 28
CHAIN_BYTES_IN = 16
CHAIN_BYTES_OUT = 8
EXTD2_OPS = 20
EXTS2_OPS = 24
EXT_RESULT_BYTES = 44
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12


def chain_pairs_np(ax: np.ndarray, max_dist_x: int, max_iter: int,
                   window: int = 1024) -> int:
    """Predecessors scored over one row of x-sorted anchors (`ax`: x with
    its sign bit flipped, as int64)."""
    n = len(ax)
    if n == 0:
        return 0
    lim = np.iinfo(np.int64).min + max_dist_x
    target = np.where(ax < lim, np.iinfo(np.int64).min, ax - max_dist_x)
    st = np.searchsorted(ax, target, side="left")
    i = np.arange(n)
    lo = np.maximum(st, i - min(max_iter, window))
    return int(np.maximum(i - lo, 0).sum())


def chain_pairs_t(hi, lo_plane, n, max_dist_x: int, iter_cap: int):
    """`chain_pairs_np` summed over the rows of a (B, N) bucket on its
    device: hi/lo the int32 halves of x, n (B, 1) the real anchors a
    row. Returns an int64 scalar tensor (no synchronisation)."""
    import torch
    B, N = hi.shape
    x = (hi.to(torch.int64) << 32) | (lo_plane.to(torch.int64) & 0xFFFFFFFF)
    imin = torch.iinfo(torch.int64).min
    ax = x ^ imin
    i = torch.arange(N, device=hi.device).expand(B, N)
    real = i < n.to(torch.int64).reshape(B, 1)
    ax = torch.where(real, ax, torch.iinfo(torch.int64).max)
    target = torch.where(ax < imin + max_dist_x, imin, ax - max_dist_x)
    st = torch.searchsorted(ax, target, side="left")
    lo = torch.maximum(st, i - iter_cap)
    return torch.where(real, (i - lo).clamp(min=0), 0).sum()


def extd2_cells(qlen: int, tlen: int, w: int) -> int:
    """Band cells of one extd2 fill."""
    if qlen <= 0 or tlen <= 0:
        return 0
    if w < 0:
        w = max(qlen, tlen)
    r = np.arange(qlen + tlen - 1, dtype=np.int64)
    st = np.maximum(np.maximum(r - qlen + 1, (r - w + 1) >> 1), 0)
    en = np.minimum(np.minimum(r, tlen - 1), (r + w) >> 1)
    return int(np.maximum(en - st + 1, 0).sum())


def exts2_cells(qlen: int, tlen: int) -> int:
    """Cells of one splice fill."""
    return max(qlen, 0) * max(tlen, 0)


def int32_peak(n_sm: int, sm_clock_mhz: float) -> float:
    """int32 operations a second."""
    return n_sm * INT32_LANES_PER_SM * sm_clock_mhz * 1e6


def least_time(ops: float, nbytes: float, ops_peak: float) -> float:
    """The least time the card could take for this work."""
    return max(ops / ops_peak, nbytes / HBM_BYTES_PER_S)


def roofline_share(run, kernel: str, pattern: str):
    """A kernel's share of its roofline, in %: the least time of the work
    the reads asked of it in the window (`run.work[kernel]`) over its
    summed device time there (trace events whose name matches
    `pattern`). None where there is nothing to read."""
    w = run.work[kernel]
    t = run.trace.kernel_seconds(pattern)
    if w.ops == 0 or t <= 0 or run.ops_peak <= 0:
        return None
    return 100.0 * least_time(w.ops, w.bytes, run.ops_peak) / t
