"""Chaining orchestration: backend routing + backtrack (chain.c:29-423).

The port's copy of `mm2tpu/mapping/chain.py` (`ChainRouter`, `_native`,
`chain_dp`, `chain_gaps`), verbatim apart from its imports and its
device route. The route that the JAX package names "tpu" is "gpu" here:
a task placed there is chained by `ops.chain_packed.chain_scores_task`
on the run's device, which the caller passes in (`device`; the router
never picks one), so on a CUDA device by K1 or K2 at B = 1. Its route
counters are `route.gpu` and `route.gpu_anchors`; `chain_dp` also
counts the tasks left on the host (`route.host`) and times the
placement itself (stage `route`).

Backend routing re-expresses the fork's learned HW/SW cost-model split
(chain.c:80-111): large tasks go to the device kernel (bounded-lookback
semantics, like the FPGA kernel), small tasks to the exact host DP
(native C++ when built, Python otherwise). The routing threshold is by
predicted work, mirroring hw_time_pred/sw_time_pred.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops import chain_ref
from ..options import MapOptions
from ..utils import profiling
from . import costmodel


class ChainRouter:
    """Backend selection for one chaining task.

    With a trained CostModel (scripts/train_router_torch.py), placement
    follows the reference's predicted-time comparison (chain.c:80-111)
    plus queue-aware admission with host fallback when the device is
    predicted busy (chain_hardware.cpp:54-92). Without one, a size
    threshold is the static approximation. `device` is the run's device:
    the default-loaded constants route to it only when it is a CUDA
    device whose backend is up (`costmodel.device_ready`)."""

    def __init__(self, backend: str = "auto", tpu_min_anchors: int = 8192,
                 cost_model=None, queue=None, preset: Optional[str] = None,
                 device=None):
        self.backend = backend
        self.tpu_min_anchors = tpu_min_anchors
        self.device = device
        # an explicitly-passed model is trusted as-is (tests, --router-
        # params); the default-loaded constants describe REAL device
        # dispatch, so routing through them additionally requires the
        # card to be up (device_ready) — see pick()
        self._default_model = cost_model is None
        self.cost_model = (cost_model if cost_model is not None
                           else costmodel.get_default_model(preset))
        self.queue = queue if queue is not None \
            else costmodel.get_default_queue()
        self._n_min_dev = self._feasible_n(self.cost_model)

    @staticmethod
    def _feasible_n(m) -> float:
        """Smallest task size at which the device could POSSIBLY win under
        model m, assuming the densest window (MAX_TRIPCOUNT trips per
        anchor). Below it pick() skips the per-task feature pass
        (num_subparts) entirely — the placement answer is already known."""
        if m is None:
            return 0.0
        from ..ops.chain_ref import MAX_TRIPCOUNT, TRIPCOUNT_PER_SUBPART
        max_sub = MAX_TRIPCOUNT // TRIPCOUNT_PER_SUBPART
        s_m = max_sub if m.k2_dev < 0 else 1  # minimizes t_dev
        d = MAX_TRIPCOUNT * m.k_host - m.k1_dev - m.k2_dev * s_m
        gap = m.c_dev - m.c_host
        if gap <= 0:
            return 0.0  # no dispatch floor: always consult the model
        if d <= 0:
            return float("inf")  # device can never win: pure host
        return gap / d

    def pick(self, n: int, a: Optional[np.ndarray] = None,
             max_dist_x: int = 5000) -> str:
        if self.backend != "auto":
            return self.backend
        if costmodel.is_cuda(self.device):
            # the card's warm-up failed: raise, never place on the host
            costmodel.raise_probe_error()
        if self.cost_model is not None and a is not None:
            if n < self._n_min_dev:
                return "native"  # device infeasible: skip the feature pass
            _, total_sub, total_trip = chain_ref.num_subparts(a, max_dist_x)
            t_dev = self.cost_model.predict_dev(n, total_sub)
            t_host = self.cost_model.predict_host(total_trip)
            if t_dev < t_host:
                if not self._default_model or \
                        costmodel.device_ready(self.device):
                    if self.queue.admit(t_dev, t_host):
                        if profiling.enabled:  # routing evidence
                            profiling.count("route.gpu")
                            profiling.count("route.gpu_anchors", n)
                        return "gpu"
                elif costmodel.is_cuda(self.device):
                    # the model WANTS the card but it is not up yet: bring
                    # it up asynchronously and place this task on the host
                    # (chain_hardware.cpp:54-92's SW-if-HW-busy, applied
                    # to device init)
                    costmodel.ensure_backend_async(self.device)
            return "native"
        if n >= self.tpu_min_anchors and costmodel.backend_ready():
            # never block a host-capable task on device init: until the
            # async probe brings the backend up, place on host
            return "gpu"
        return "native"


_NATIVE = None
_NATIVE_LOCK = __import__("threading").Lock()


def _native():
    global _NATIVE
    if _NATIVE is None:
        with _NATIVE_LOCK:
            if _NATIVE is None:
                try:
                    from ..native import lib as native_lib
                    _NATIVE = (native_lib if native_lib.available()
                               else False)
                except Exception:
                    _NATIVE = False
    return _NATIVE


def chain_dp(max_dist_x: int, max_dist_y: int, bw: int, max_skip: int,
             max_iter: int, min_cnt: int, min_sc: int, gap_scale: float,
             is_cdna: bool, n_segs: int, a: np.ndarray,
             backend: str = "auto",
             preset: Optional[str] = None,
             device=None) -> Tuple[np.ndarray, np.ndarray]:
    """mm_chain_dp equivalent. a: (n,2) uint64 anchors sorted by x.
    Returns (anchors_compacted, u) with u[i] = score<<32 | cnt. A task
    routed to "gpu" is chained on `device`."""
    n = len(a)
    if n == 0:
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.uint64)

    with profiling.stage("route"):
        router = ChainRouter(backend, preset=preset, device=device)
        which = router.pick(n, a=a, max_dist_x=max_dist_x)
    if which == "gpu":
        if device is None:
            raise ValueError("chain_dp: the gpu route needs the run's "
                             "device")
        from ..ops.chain_packed import chain_scores_task
        f, p, v = chain_scores_task(a, max_dist_x, max_dist_y, bw, max_iter,
                                    gap_scale, is_cdna, n_segs,
                                    device=device)
    else:
        if profiling.enabled:
            profiling.count("route.host")
        if which == "native" and _native():
            f, p, v = _native().chain_scores_exact(
                a, max_dist_x, max_dist_y, bw, max_skip, max_iter,
                gap_scale, is_cdna, n_segs)
        else:
            f, p, v = chain_ref.chain_scores_exact(
                a, max_dist_x, max_dist_y, bw, max_skip, max_iter,
                gap_scale, is_cdna, n_segs)

    return chain_ref.chain_backtrack(n, f, p, v, a, min_cnt, min_sc)


def chain_gaps(opt: MapOptions, qlen_sum: int) -> Tuple[int, int]:
    """max chaining gap on query/ref (map.c:305-314)."""
    is_sr = bool(opt.flag & 0x1000)
    if is_sr:
        max_chain_gap_qry = max(qlen_sum, opt.max_gap)
    else:
        max_chain_gap_qry = opt.max_gap
    if opt.max_gap_ref > 0:
        max_chain_gap_ref = opt.max_gap_ref
    elif opt.max_frag_len > 0:
        max_chain_gap_ref = max(opt.max_frag_len - qlen_sum, opt.max_gap)
    else:
        max_chain_gap_ref = opt.max_gap
    return max_chain_gap_qry, max_chain_gap_ref
