"""Batched bounded-lookback chaining scores (uniseg, non-cDNA).

Counterpart of `mm2tpu/ops/chain_pallas_v3.py` (`_chain_kernel_v3`,
`chain_scores_device_v3`) with the uniseg branch of
`mm2tpu/ops/chain_pallas_v2.py::_pair_key` and `_ilog2_tile`. The
contract is the Pallas kernel's, bit for bit; `csrc/chain.cu` states
it in full.

- `chain_scores_v3_reference`: the plain PyTorch version, serial over
  anchors and vectorised over tasks and candidates.
- `chain_scores_v3`: the wrapper. A CPU tensor goes to the plain version;
  a CUDA tensor launches the Hopper kernel or raises.

The kernel reads each row's n and runs the DP for its first n anchors
only; past n it writes f = span, p = -1, which is what the DP gives on
`pack_tasks16`'s pad. The plain version scans all N and ignores n; the
two agree wherever a row's tail past n is that pad.

`launches` counts kernel launches and `reference_calls` counts runs of
the plain version, so a caller can show which one did the work.
"""
from __future__ import annotations

import torch

from . import count_lock, launching

WINDOW = 1024        # lookback cap (chain_pallas.WINDOW)
NEG = -0x20000000    # masked-key sentinel (chain_pallas_v2.NEG)

launches = 0
reference_calls = 0


def _ilog2(v: torch.Tensor, exact_max: int) -> torch.Tensor:
    """floor(log2(v)) for v > 0, 0 for v <= 0 (`_ilog2_tile`): the f32
    exponent field when every gated value is below 2^24, else a shift
    cascade."""
    if exact_max < (1 << 24):
        bits = v.to(torch.float32).view(torch.int32)
        return ((bits >> 23) - 127).clamp_min(0)
    r = torch.zeros_like(v)
    t = v
    for shift in (16, 8, 4, 2, 1):
        big = t >= (1 << shift)
        r = torch.where(big, r + shift, r)
        t = torch.where(big, t >> shift, t)
    return r


def chain_scores_v3_reference(hi, lo, qi, span, n, avg, *, max_dist_x: int,
                              max_dist_y: int, bw: int, iter_cap: int,
                              gap_scale: float):
    """Plain version. hi/lo/qi/span (B, N) int32, avg (B, 1) float32;
    `n` is not read (as in the Pallas kernel): every row runs all N
    steps. The kernel stops at n, so past n a row must hold
    `pack_tasks16`'s pad for the two to agree. Returns (f, p), (B, N)
    int32, on the inputs' device."""
    global reference_calls
    with count_lock:
        reference_calls += 1
    B, N = hi.shape
    dev = hi.device
    cap = min(iter_cap, WINDOW)
    fast = max_dist_x <= max_dist_y
    max_dq = min(max_dist_x, max_dist_y)
    exact_max = max(max_dist_x, max_dist_y, bw) + 1
    avg = avg.reshape(B, 1).to(torch.float32)
    gs = torch.tensor(gap_scale, dtype=torch.float32, device=dev)
    half = torch.tensor(0.499, dtype=torch.float32, device=dev)
    age = WINDOW - torch.arange(max(cap, 0), 0, -1, dtype=torch.int32,
                                device=dev)   # 1024 - d, d = cap..1
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
        ok = hi[:, j0:i] == hi[:, i:i + 1]
        if fast:
            lohi = torch.maximum(dr, dq)
            lolo = torch.minimum(dr, dq)
            ok &= (lolo >= 1) & (lohi <= max_dist_x)
            dd = lohi - lolo
            min3 = torch.minimum(lolo, span_i)
        else:
            ok &= (dr <= max_dist_x) & (dr != 0) & (dq > 0) & (dq <= max_dq)
            dd = (dr - dq).abs()
            min3 = torch.minimum(torch.minimum(dq, dr), span_i)
        ok &= dd <= bw
        gap = (dd.to(torch.float32) * avg).to(torch.int32) + \
            (_ilog2(dd, exact_max) >> 1)
        if gap_scale != 1.0:
            gap = (gap.to(torch.float32) * gs + half).to(torch.int32)
        key = (min3 - gap + f[:, j0:i]) * WINDOW + age[cap - w:]
        best = torch.where(ok, key, NEG).amax(dim=1)
        best_sc = best >> 10
        best_d = WINDOW - (best & (WINDOW - 1))
        better = best_sc > span[:, i]
        f[:, i] = torch.where(better, best_sc, span[:, i])
        p[:, i] = torch.where(better, i - best_d, -1)
    return f, p


def _check_inputs(hi, lo, qi, span, n, avg, sid=None) -> None:
    """What the kernels take: contiguous (B, N) int32 planes (and `sid`
    for the general contract) with N % 1024 == 0, a contiguous (B, 1)
    int32 n, a float32 avg of B values, all on one device."""
    dev = hi.device
    if hi.dim() != 2:
        raise ValueError("hi must be (B, N), got %s" % (tuple(hi.shape),))
    B, N = hi.shape
    if B < 1 or N < WINDOW or N % WINDOW != 0:
        raise ValueError("need B >= 1 and N a multiple of %d, got (%d, %d)"
                         % (WINDOW, B, N))
    planes = [("hi", hi), ("lo", lo), ("qi", qi), ("span", span)]
    if sid is not None:
        planes.append(("sid", sid))
    for name, t in planes:
        if t.device != dev or t.dtype != torch.int32 or \
                tuple(t.shape) != (B, N) or not t.is_contiguous():
            raise ValueError("%s must be a contiguous (%d, %d) int32 tensor "
                             "on %s, got %s %s on %s" % (
                                 name, B, N, dev, t.dtype, tuple(t.shape),
                                 t.device))
    if n.device != dev or n.dtype != torch.int32 or \
            tuple(n.shape) != (B, 1) or not n.is_contiguous():
        raise ValueError("n must be a contiguous (%d, 1) int32 tensor on "
                         "%s, got %s %s on %s" % (B, dev, n.dtype,
                                                  tuple(n.shape), n.device))
    if avg.device != dev or avg.dtype != torch.float32 or \
            avg.numel() != B or not avg.is_contiguous():
        raise ValueError("avg must be a contiguous (%d, 1) float32 tensor on "
                         "%s" % (B, dev))


def chain_scores_v3(hi, lo, qi, span, n, avg, *, max_dist_x: int,
                    max_dist_y: int, bw: int, iter_cap: int,
                    gap_scale: float):
    """Chaining scores (f, p), (B, N) int32. CPU tensors run the plain
    version; CUDA tensors launch `csrc/chain.cu`'s `mm2tpu_chain_v3` on
    the current stream (B >= 1, N % 1024 == 0, contiguous int32 planes,
    (B, 1) int32 n, float32 avg), which stops each row at its n."""
    global launches
    kw = dict(max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
              iter_cap=iter_cap, gap_scale=gap_scale)
    if hi.device.type == "cpu":
        return chain_scores_v3_reference(hi, lo, qi, span, n, avg, **kw)
    if hi.device.type != "cuda":
        raise ValueError("chain_scores_v3: unsupported device %s" % hi.device)
    _check_inputs(hi, lo, qi, span, n, avg)
    from . import _build
    lib = _build.load()
    B, N = hi.shape
    f = torch.empty_like(hi)
    p = torch.empty_like(hi)
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream(hi.device).cuda_stream
        with launching():
            err = lib.mm2tpu_chain_v3(
                hi.data_ptr(), lo.data_ptr(), qi.data_ptr(), span.data_ptr(),
                n.data_ptr(), avg.data_ptr(), f.data_ptr(), p.data_ptr(), B,
                N, max_dist_x, max_dist_y, bw, min(iter_cap, WINDOW),
                float(gap_scale), int(gap_scale != 1.0), stream)
    if err != 0:
        raise RuntimeError("chain_v3 kernel launch failed: cudaError %d"
                           % err)
    with count_lock:
        launches += 1
    return f, p
