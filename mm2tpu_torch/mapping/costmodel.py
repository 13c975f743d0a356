"""Learned device/host cost-model split for chaining tasks.

The port's copy of `mm2tpu/mapping/costmodel.py`. `CostModel`,
`DeviceQueue`, `fit_cost_model`, `_bounded_lstsq`, `regime_for_preset`,
`set_default_model`, `get_default_model` and `get_default_queue` are
verbatim; the constant files (`_REGIME_FILES`) are the port's own,
`mm2tpu_torch/data/router_params_h100*.json`, fitted on an H100 by
`scripts/train_router_torch.py`. The backend probe is rewritten on
`torch.cuda`: `backend_ready()` is true once the CUDA context is up and
`ops._build.load()` has returned, `device_ready(device)` adds that the
run's device is a CUDA device, and `ensure_backend_async(device)` builds
or loads the kernels and creates the context on a daemon thread. Unlike
the JAX package's probe, that thread keeps its exception, and
`raise_probe_error()` raises it on the mapping thread (the router calls
it at every `auto` pick on a CUDA device, the CLI at the end of a run):
a failed build never turns into host placement. `reset_probe()`, which
the CLI calls when a run ends, forgets a finished probe, so that one
run's failure does not outlive it in the process.

- time predictors (chain.c:80-81, constants chain_hardware.h:18-30):
      t_dev[ms]  ~= k1_dev*n + k2_dev*total_subparts + c_dev
      t_host[ms] ~= k_host*total_trip_count + c_host
  `total_subparts`/`total_trip_count` are the reference's own task-size
  features (chain.c:53-78), computed by `ops.chain_ref.num_subparts`.

- queue-aware admission (chain_hardware.cpp:54-92): the device keeps a
  predicted-completion clock; a task is only sent to the device if
  wait + t_dev still beats t_host, otherwise it falls back to the host
  path (PROCESS_ON_SW_IF_HW_BUSY semantics, chain.c:105-164).
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass
class CostModel:
    """Linear time predictors; times in milliseconds."""
    k1_dev: float    # per anchor
    k2_dev: float    # per subpart (128-wide window tile)
    c_dev: float     # device launch/transfer overhead
    k_host: float    # per inner-loop trip
    c_host: float

    def predict_dev(self, n: int, total_subparts: int) -> float:
        return self.k1_dev * n + self.k2_dev * total_subparts + self.c_dev

    def predict_host(self, total_trip_count: int) -> float:
        return self.k_host * total_trip_count + self.c_host

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "CostModel":
        with open(path) as f:
            d = json.load(f)
        return cls(**{k: float(d[k]) for k in
                      ("k1_dev", "k2_dev", "c_dev", "k_host", "c_host")})


class DeviceQueue:
    """Predicted-completion bookkeeping for the device (the reference keeps
    `end_times[]` per kernel and a FIFO of waiters, chain_hardware.cpp:54-92;
    one logical TPU stream here)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._end = 0.0  # predicted completion, in clock seconds
        self._lock = threading.Lock()  # mapping threads race on admission

    def wait_ms(self) -> float:
        return max(0.0, self._end - self._clock()) * 1e3

    def admit(self, t_dev_ms: float, t_host_ms: float) -> bool:
        """True if the task should run on the device given the queue;
        on admission the predicted-completion clock is extended."""
        with self._lock:
            if max(0.0, self._end - self._clock()) * 1e3 + t_dev_ms \
                    >= t_host_ms:
                return False
            now = self._clock()
            self._end = max(self._end, now) + t_dev_ms * 1e-3
            return True


def fit_cost_model(rows: Sequence[Sequence[float]],
                   floor_dev_ms: Optional[float] = None) -> CostModel:
    """Physically-constrained least-squares fit of the five constants from
    measurement rows (n, total_subparts, total_trip_count, dev_ms, host_ms)
    — the analogue of hw_sw_split/find_params.py's two sklearn
    LinearRegressions, with bounds an unconstrained regression can violate
    when the feature columns are collinear (n and subparts nearly are):

      k1_dev, k2_dev >= 0   — more anchors/subparts never make the device
                              faster (the reference's fits agree,
                              chain_hardware.h:19-30)
      c_dev >= floor_dev_ms — the dispatch floor: a device call cannot
                              complete faster than one launch round-trip.
                              The trainer measures it directly by timing
                              a minimal device launch (train_router.py);
                              defaults to 0 (nonnegativity only).
      k_host >= 0           — c_host stays free (the reference's host fits
                              have negative intercepts too)
    """
    m = np.asarray(rows, dtype=np.float64)
    if m.ndim != 2 or m.shape[1] != 5 or len(m) < 3:
        raise ValueError("need >=3 rows of (n, subparts, tripcount, "
                         "dev_ms, host_ms)")
    if floor_dev_ms is None:
        floor_dev_ms = 0.0
    A = np.stack([m[:, 0], m[:, 1], np.ones(len(m))], axis=1)
    k1, k2, c = _bounded_lstsq(A, m[:, 3],
                               np.array([0.0, 0.0, floor_dev_ms]))
    B = np.stack([m[:, 2], np.ones(len(m))], axis=1)
    kh, ch = _bounded_lstsq(B, m[:, 4], np.array([0.0, -np.inf]))
    return CostModel(k1_dev=float(k1), k2_dev=float(k2), c_dev=float(c),
                     k_host=float(kh), c_host=float(ch))


def _bounded_lstsq(A: np.ndarray, y: np.ndarray,
                   lo: np.ndarray) -> np.ndarray:
    """min ||Ax - y|| s.t. x >= lo. scipy's lsq_linear when available;
    otherwise a tiny active-set iteration (exact for these 2-3-parameter
    fits): solve unconstrained, clamp violators to their bound, re-solve
    the free coordinates against the residual, repeat to fixpoint."""
    try:
        from scipy.optimize import lsq_linear
        return lsq_linear(A, y, bounds=(lo, np.full(len(lo),
                                                    np.inf))).x
    except ImportError:
        pass
    p = A.shape[1]
    clamped = np.zeros(p, bool)
    x = np.zeros(p)
    for _ in range(p + 1):
        free = ~clamped
        rhs = y - A[:, clamped] @ np.where(np.isfinite(lo[clamped]),
                                           lo[clamped], 0.0)
        if free.any():
            sol, *_ = np.linalg.lstsq(A[:, free], rhs, rcond=None)
            x[free] = sol
        x[clamped] = lo[clamped]
        viol = free & (x < lo)
        if not viol.any():
            return x
        clamped |= viol
    x[clamped] = lo[clamped]
    return x


_DEFAULT_MODELS: dict = {}
_DEFAULT_QUEUE = DeviceQueue()
_FORCED_MODEL: Optional[CostModel] = None
_FORCED = False

# trained constant files per regime — the analogue of the reference's two
# pasted-in parameter sets (ONT vs PacBio-CCS/asm, chain_hardware.h:18-30),
# fitted on an H100 by scripts/train_router_torch.py
_REGIME_FILES = {
    "map": "router_params_h100.json",
    "asm": "router_params_h100_asm20.json",
}


def regime_for_preset(preset: Optional[str]) -> str:
    """Map a preset name to a trained-constant regime: asm-to-ref /
    high-identity presets produce far denser, larger chaining tasks than
    read mapping, so the reference fits them separately
    (chain_hardware.h:24-30's PacBio-CCS/asm set)."""
    if preset in ("asm5", "asm10", "asm20", "map-hifi", "map10k-ccs"):
        return "asm"
    return "map"


def set_default_model(model: Optional[CostModel]) -> None:
    """Force one model for every regime (the --router-params override)."""
    global _FORCED_MODEL, _FORCED
    _FORCED_MODEL = model
    _FORCED = True


def reset_default_model() -> None:
    """Undo `set_default_model`: every regime reads its file again. The
    CLI calls it at the end of each run, so that one run's
    --router-params does not outlive it in the process."""
    global _FORCED_MODEL, _FORCED
    _FORCED_MODEL = None
    _FORCED = False


def backend_ready() -> bool:
    """True once the CUDA context is up and the kernels' library is
    loaded (`ops._build.load()` has returned). Checked WITHOUT starting
    either: a host-placed run never pays the nvcc build or the context."""
    import sys
    torch = sys.modules.get("torch")
    build = sys.modules.get("mm2tpu_torch.ops._build")
    return bool(torch is not None and build is not None and
                torch.cuda.is_initialized() and build.loaded())


def device_ready(device) -> bool:
    """True once the backend is ready and the run's device is a CUDA
    device. The default-loaded router constants describe dispatch to
    the card; on a `--device cpu` run the device route would run the
    kernels' plain versions on the host, never what the trained split
    means, so there it is always False."""
    return is_cuda(device) and backend_ready()


def is_cuda(device) -> bool:
    """True when `device` ("cuda", "cuda:0", a torch.device) is a CUDA
    device."""
    return device is not None and \
        getattr(device, "type", str(device)).split(":")[0] == "cuda"


_PROBE_STARTED = False
_PROBE_THREAD = None
_PROBE_ERROR: Optional[BaseException] = None


def raise_probe_error() -> None:
    """Raise, on the calling thread, what the warm-up thread raised."""
    if _PROBE_ERROR is not None:
        raise RuntimeError("bringing up the CUDA backend failed: %r"
                           % (_PROBE_ERROR,)) from _PROBE_ERROR


def reset_probe() -> None:
    """Forget a finished warm-up thread and its exception, so that the
    next `ensure_backend_async` probes afresh. A thread still running is
    left to finish (`join_backend_probe`)."""
    global _PROBE_STARTED, _PROBE_THREAD, _PROBE_ERROR
    if _PROBE_THREAD is not None and _PROBE_THREAD.is_alive():
        return
    _PROBE_STARTED = False
    _PROBE_THREAD = None
    _PROBE_ERROR = None


def join_backend_probe(timeout: Optional[float] = None) -> bool:
    """Wait for the warm-up thread to finish. Returns True when no probe
    is running (or it finished in time); False when it is still
    running."""
    t = _PROBE_THREAD
    if t is None or not t.is_alive():
        return True
    t.join(timeout)
    return not t.is_alive()


def ensure_backend_async(device) -> None:
    """Build or load `csrc/*.cu` and create the CUDA context of `device`
    on a daemon thread. Until it is ready, the router places every task
    on the host (the reference's PROCESS_ON_SW_IF_HW_BUSY stance,
    chain_hardware.cpp:54-92, applied to device init). An exception in
    the thread is kept and raised on the mapping thread by
    `raise_probe_error`."""
    global _PROBE_STARTED, _PROBE_THREAD
    if _PROBE_STARTED or backend_ready():
        return
    _PROBE_STARTED = True

    def _probe():
        global _PROBE_ERROR
        try:
            import torch
            from ..ops import _build
            _build.load()
            torch.zeros(1, device=device)  # the context of `device`
        except Exception as e:  # noqa: BLE001 - raised on the mapping thread
            _PROBE_ERROR = e

    _PROBE_THREAD = threading.Thread(target=_probe, daemon=True,
                                     name="mm2tpu-torch-backend-probe")
    _PROBE_THREAD.start()


def get_default_model(preset: Optional[str] = None) -> Optional[CostModel]:
    """Explicitly-set model, else the in-tree trained constants for the
    preset's regime (mm2tpu_torch/data/router_params_h100*.json — the
    analogue of the two constant sets the reference ships in
    chain_hardware.h:18-30, selected per preset). Loaded from JSON with
    NO torch.cuda dependency: the router uses the predictions to decide
    when bringing the card up is even worthwhile (ensure_backend_async)
    — placement intent must not require paying device init first."""
    if _FORCED:
        return _FORCED_MODEL
    regime = regime_for_preset(preset)
    if regime not in _DEFAULT_MODELS:
        model = None
        try:
            import pathlib
            data = pathlib.Path(__file__).resolve().parent.parent / "data"
            p = data / _REGIME_FILES[regime]
            if not p.exists():  # regime not fitted: fall back to base
                p = data / _REGIME_FILES["map"]
            if p.exists():
                model = CostModel.load(str(p))
        except Exception:
            pass
        _DEFAULT_MODELS[regime] = model
    return _DEFAULT_MODELS[regime]


def get_default_queue() -> DeviceQueue:
    return _DEFAULT_QUEUE
