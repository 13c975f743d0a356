"""Cross-read batched extension on a torch device.

Counterpart of `mm2tpu/mapping/extbatch.py`, whose `ExtBatcher`,
`current()` and `worker_scope` are merged here. align1's control flow is
sequential per read, so batching across reads uses threads: N reads run
align1 concurrently; each `align_pair` fill of at least `min_cells`
cells posts a request to the `TorchExtBatcher` that `worker_scope`
installed on its thread (`current()`) and blocks on its future. A group
(fills of one kind and parameter set: extd2 fills by mat, gaps, w,
zdrop, end_bonus and flag; splice fills by mat, q, e, q2, noncan, zdrop,
junc_bonus and flag) is flushed when every live worker waits or the
group is full. A flush runs through the port's
`ops.ksw2_extd2.extd2_batch` or `ops.ksw2_exts2.exts2_batch` on the
batcher's device, and groups are flushed one at a time, so that fills
gather while the device works. Smaller fills run inline on the host's
native extension.

Without a batcher (the stream mode), `fill_scope(device)` names the
device on which `align_pair` runs each fill of at least
`--align-tpu-min-mat` cells, one fill a launch (`fill_device()`).
"""
from __future__ import annotations

import contextlib
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.ksw2_extd2 import extd2_batch
from ..ops.ksw2_exts2 import exts2_batch


class TorchExtBatcher:
    """Batching service for extd2 and splice fills across concurrently
    aligned reads, whose flushes run on `device` ("cuda" or "cpu").
    `ext_fn` and `exts2_fn` replace the extension function of every extd2
    and splice flush (see the `fn` of `extd2_batch` and `exts2_batch`)."""

    def __init__(self, device, max_batch: int = 64, min_cells: int = 0,
                 ext_fn=None, exts2_fn=None):
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.min_cells = min_cells
        self.ext_fn = ext_fn
        self.exts2_fn = exts2_fn
        self._lock = threading.Condition()
        self._pending: Dict[tuple, List[Tuple[tuple, Future]]] = {}
        self._n_pending = 0
        self._active = 0          # workers currently inside align work
        self._blocked = 0         # workers waiting on a future
        self._flushing = False    # a group is on the device (under _lock)
        self.n_dispatches = 0
        self.n_batched = 0

    # -- worker lifecycle ---------------------------------------------------
    def worker_enter(self):
        with self._lock:
            self._active += 1

    def worker_exit(self):
        with self._lock:
            self._active -= 1
            self._maybe_flush_locked()

    # -- fill submission ----------------------------------------------------
    def submit(self, qseq, tseq, mat, q, e, q2, e2, w, zdrop, end_bonus,
               flag):
        """Blocking: returns the extd2 ExtzResult once a flush covers this
        fill."""
        return self._post(("extd2", mat.tobytes(), q, e, q2, e2, w, zdrop,
                           end_bonus, flag), qseq, tseq, None, mat)

    def submit_exts2(self, qseq, tseq, junc, mat, q, e, q2, noncan, zdrop,
                     junc_bonus, flag):
        """Blocking: returns the splice ExtzResult once a flush covers this
        fill. `junc` (the fill's --junc-bed flags, or None) travels with
        the fill, outside the group key."""
        return self._post(("exts2", mat.tobytes(), q, e, q2, noncan, zdrop,
                           junc_bonus, flag), qseq, tseq, junc, mat)

    def _post(self, key, qseq, tseq, junc, mat):
        fut: Future = Future()
        with self._lock:
            self._pending.setdefault(key, []).append(
                ((np.asarray(qseq, np.uint8), np.asarray(tseq, np.uint8),
                  junc, mat), fut))
            self._n_pending += 1
            self._blocked += 1
            self._maybe_flush_locked()
            while not fut.done():
                # another worker's flush may complete us while we wait
                self._lock.wait(timeout=0.05)
                self._maybe_flush_locked()
        with self._lock:
            self._blocked -= 1
        err = fut.exception()
        if err is not None:
            raise err
        return fut.result()

    # -- dispatch -----------------------------------------------------------
    def _maybe_flush_locked(self):
        """Flush the largest group when every worker waits or a group is
        full, one flush at a time: while a group runs, the fills that
        arrive wait in their groups, and the next flush, started by a
        waiter when this one ends, takes them together. Without this, a
        waiter counted as blocked after its fill came back makes every
        new fill a flush of its own: the 1000-read smoke map ran 49,451
        flushes for 49,571 fills. Called with the lock held; the flush
        runs outside it."""
        if self._flushing or self._n_pending == 0:
            return
        full = any(len(v) >= self.max_batch for v in self._pending.values())
        if not (full or self._blocked >= self._active > 0):
            return
        key = max(self._pending, key=lambda k: len(self._pending[k]))
        group = self._pending.pop(key)
        if len(group) > self.max_batch:
            self._pending[key] = group[self.max_batch:]
            group = group[:self.max_batch]
        self._n_pending -= len(group)
        self._flushing = True
        self._lock.release()
        try:
            self._run_group(key, group)
        finally:
            self._lock.acquire()
            self._flushing = False
            self._lock.notify_all()

    def _run_group(self, key, group):
        kind, _, *params = key
        mat = group[0][0][3]
        # the flushing thread is a pool worker: it does not inherit the
        # main thread's current CUDA device
        on_device = torch.cuda.device(self.device) \
            if self.device.type == "cuda" else contextlib.nullcontext()
        try:
            with on_device:
                self.n_dispatches += 1
                self.n_batched += len(group)
                if kind == "exts2":
                    results = exts2_batch([t[0][:3] for t in group], mat,
                                          *params, device=self.device,
                                          fn=self.exts2_fn)
                else:
                    results = extd2_batch([t[0][:2] for t in group], mat,
                                          *params, device=self.device,
                                          fn=self.ext_fn)
            for (_, fut), rz in zip(group, results):
                fut.set_result(rz)
        except Exception as err:  # noqa: BLE001 - raised in every waiter
            for _, fut in group:
                if not fut.done():
                    fut.set_exception(err)


_TLS = threading.local()


def current() -> Optional[TorchExtBatcher]:
    """The batcher installed on this thread by `worker_scope`, if any."""
    return getattr(_TLS, "batcher", None)


def fill_device():
    """The device installed on this thread by `fill_scope`; raises when
    there is none (a fill of --align-backend gpu never stays on the host
    for want of one)."""
    dev = getattr(_TLS, "device", None)
    if dev is None:
        raise RuntimeError("--align-backend gpu: a device fill outside a "
                           "batcher needs fill_scope(device)")
    return dev


@contextlib.contextmanager
def fill_scope(device):
    """Install `device` (None: no device) for the one-fill device launches
    of align_pair on this thread (the stream mode's)."""
    prev = getattr(_TLS, "device", None)
    _TLS.device = None if device is None else torch.device(device)
    try:
        yield
    finally:
        _TLS.device = prev


class worker_scope:
    """Context manager installing `batcher` for align_pair on this thread."""

    def __init__(self, batcher: Optional[TorchExtBatcher]):
        self._b = batcher

    def __enter__(self):
        if self._b is not None:
            _TLS.batcher = self._b
            self._b.worker_enter()
        return self._b

    def __exit__(self, *exc):
        if self._b is not None:
            _TLS.batcher = None
            self._b.worker_exit()
        return False
