"""Batched bounded-lookback chaining scores under the general contract:
multi-segment tasks (paired reads) and cDNA scoring (spliced reads).

Counterpart of `mm2tpu/ops/chain_pallas_v2.py` (`_chain_kernel_v2`,
`chain_scores_device_v2`) with the general branch of `_pair_key` and
`_ilog2_tile`. The contract is the Pallas kernel's, bit for bit;
`csrc/chain.cu` states it in full. The single-segment non-cDNA contract
is `chain_v3`'s (K1), and both functions here refuse it.

- `chain_scores_v2_reference`: the plain PyTorch version, serial over
  anchors and vectorised over tasks and candidates.
- `chain_scores_v2`: the wrapper. A CPU tensor goes to the plain version;
  a CUDA tensor launches the Hopper kernel (`mm2tpu_chain_v2`) or raises.

As with `chain_v3`, the kernel reads each row's n and stops there
(f = span, p = -1 past it: the DP's value on `pack_tasks16`'s pad);
the plain version scans all N and ignores n. A row whose span sum
exceeds `chain_v3.KEY_SCORE_MAX` is keyed in int64 by both.

`launches` counts kernel launches and `reference_calls` counts runs of
the plain version, so a caller can show which one did the work.
"""
from __future__ import annotations

import torch

from . import count_lock, launching
from .chain_v3 import NEG, WINDOW, _check_inputs, _ilog2, pair_keys, \
    wide_rows

launches = 0
reference_calls = 0


def _check_contract(is_cdna: bool, n_segs: int) -> None:
    if n_segs < 1 or (not is_cdna and n_segs == 1):
        raise ValueError("chain_v2 takes the general contract (is_cdna or "
                         "n_segs > 1), got is_cdna=%s, n_segs=%d; the "
                         "single-segment non-cDNA contract is chain_v3's"
                         % (is_cdna, n_segs))


def chain_scores_v2_reference(hi, lo, qi, span, sid, n, avg, *,
                              max_dist_x: int, max_dist_y: int, bw: int,
                              iter_cap: int, gap_scale: float, is_cdna: bool,
                              n_segs: int):
    """Plain version. hi/lo/qi/span/sid (B, N) int32, avg (B, 1) float32;
    `n` is not read (as in the Pallas kernel): every row runs all N
    steps. The kernel stops at n, so past n a row must hold
    `pack_tasks16`'s pad for the two to agree. Returns (f, p), (B, N)
    int32, on the inputs' device."""
    global reference_calls
    _check_contract(is_cdna, n_segs)
    with count_lock:
        reference_calls += 1
    B, N = hi.shape
    dev = hi.device
    cap = min(iter_cap, WINDOW)
    exact_max = max(max_dist_x, max_dist_y, bw) + 1
    seg_gate = n_segs > 1 and not is_cdna
    avg = avg.reshape(B, 1).to(torch.float32)
    gs = torch.tensor(gap_scale, dtype=torch.float32, device=dev)
    half = torch.tensor(0.499, dtype=torch.float32, device=dev)
    age = WINDOW - torch.arange(max(cap, 0), 0, -1, dtype=torch.int32,
                                device=dev)   # 1024 - d, d = cap..1
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    wide = wide_rows(span)
    f = torch.zeros((B, N), dtype=torch.int32, device=dev)
    p = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    for i in range(N):
        w = min(cap, i)
        span_i = span[:, i:i + 1]
        if w <= 0:
            f[:, i] = span[:, i]
            continue
        j0 = i - w
        dr = lo[:, i:i + 1] - lo[:, j0:i]
        dq = qi[:, i:i + 1] - qi[:, j0:i]
        same = sid[:, j0:i] == sid[:, i:i + 1]
        ok = (hi[:, j0:i] == hi[:, i:i + 1]) & (dr <= max_dist_x)
        ok &= ~((same & (dr == 0)) | (dq <= 0))
        ok &= ~((same & (dq > max_dist_y)) | (dq > max_dist_x))
        dd = (dr - dq).abs()
        ok &= ~(same & (dd > bw))
        if seg_gate:
            ok &= ~(same & (dr > max_dist_y))
        min3 = torch.minimum(torch.minimum(dq, dr), span_i)
        log_dd = _ilog2(dd, exact_max)
        c_lin = (dd.to(torch.float32) * avg).to(torch.int32)
        lin_cost = c_lin + (log_dd >> 1)
        in_branch = torch.ones_like(same) if is_cdna else ~same
        pair_bonus = (~same) & (dr == 0)
        min_cost = torch.minimum(c_lin, log_dd)
        branch_cost = torch.where(
            pair_bonus, zero,
            torch.where((dr > dq) | ~same, min_cost, lin_cost))
        gap = torch.where(in_branch, branch_cost, lin_cost)
        base = min3 + (in_branch & pair_bonus).to(torch.int32)
        if gap_scale != 1.0:
            gap = (gap.to(torch.float32) * gs + half).to(torch.int32)
        key = pair_keys(base - gap + f[:, j0:i], age[cap - w:], wide)
        best = torch.where(ok, key, NEG).amax(dim=1)
        best_sc = (best >> 10).to(torch.int32)
        best_d = WINDOW - (best & (WINDOW - 1)).to(torch.int32)
        better = best_sc > span[:, i]
        f[:, i] = torch.where(better, best_sc, span[:, i])
        p[:, i] = torch.where(better, i - best_d, -1)
    return f, p


def chain_scores_v2(hi, lo, qi, span, sid, n, avg, *, max_dist_x: int,
                    max_dist_y: int, bw: int, iter_cap: int,
                    gap_scale: float, is_cdna: bool, n_segs: int):
    """Chaining scores (f, p), (B, N) int32, under the general contract.
    CPU tensors run the plain version; CUDA tensors launch
    `csrc/chain.cu`'s `mm2tpu_chain_v2` on the current stream (B >= 1,
    N % 1024 == 0, contiguous int32 planes, (B, 1) int32 n, float32
    avg), which stops each row at its n."""
    global launches
    kw = dict(max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
              iter_cap=iter_cap, gap_scale=gap_scale, is_cdna=is_cdna,
              n_segs=n_segs)
    if hi.device.type == "cpu":
        return chain_scores_v2_reference(hi, lo, qi, span, sid, n, avg, **kw)
    if hi.device.type != "cuda":
        raise ValueError("chain_scores_v2: unsupported device %s" % hi.device)
    _check_contract(is_cdna, n_segs)
    _check_inputs(hi, lo, qi, span, n, avg, sid=sid)
    from . import _build
    lib = _build.load()
    B, N = hi.shape
    f = torch.empty_like(hi)
    p = torch.empty_like(hi)
    exact_log = max(max_dist_x, max_dist_y, bw) + 1 >= (1 << 24)
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream(hi.device).cuda_stream
        with launching():
            err = lib.mm2tpu_chain_v2(
                hi.data_ptr(), lo.data_ptr(), qi.data_ptr(), span.data_ptr(),
                sid.data_ptr(), n.data_ptr(), avg.data_ptr(), f.data_ptr(),
                p.data_ptr(), B, N, max_dist_x, max_dist_y, bw,
                min(iter_cap, WINDOW),
                float(gap_scale), int(gap_scale != 1.0), int(exact_log),
                int(bool(is_cdna)), n_segs, stream)
    if err != 0:
        raise RuntimeError("chain_v2 kernel launch failed: cudaError %d"
                           % err)
    with count_lock:
        launches += 1
    return f, p
