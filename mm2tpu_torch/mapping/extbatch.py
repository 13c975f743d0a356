"""Cross-read batched extension on a torch device.

Counterpart of `mm2tpu/mapping/extbatch.py`: the JAX package's
`ExtBatcher` groups the extd2 fills that concurrently aligned reads post
(`align_pair` reaches it through `extbatch.current()`, installed by
`worker_scope`) and flushes a group when every worker waits or a group
is full. Only the flush changes: a group runs through the port's
`ops.ksw2_extd2.extd2_batch` on the batcher's device, and groups are
flushed one at a time, so that fills gather while the device works.
"""
from __future__ import annotations

import contextlib

import torch

from mm2tpu.mapping.extbatch import ExtBatcher

from ..ops.ksw2_extd2 import extd2_batch


class TorchExtBatcher(ExtBatcher):
    """`ExtBatcher` whose flushes run on `device` ("cuda" or "cpu").
    `ext_fn` replaces the extension function of every flush (see
    `extd2_batch`'s `fn`)."""

    def __init__(self, device, max_batch: int = 64, min_cells: int = 0,
                 ext_fn=None):
        super().__init__(max_batch=max_batch, min_cells=min_cells)
        self.device = torch.device(device)
        self.ext_fn = ext_fn
        self._flushing = False   # a group is on the device (under _lock)

    def _maybe_flush_locked(self):
        """`ExtBatcher._maybe_flush_locked` (flush the largest group when
        every worker waits or a group is full), one flush at a time: while
        a group runs, the fills that arrive wait in their groups, and the
        next flush, started by a waiter when this one ends, takes them
        together. Without this, a waiter counted as blocked after its
        fill came back makes every new fill a flush of its own: the
        1000-read smoke map ran 49,451 flushes for 49,571 fills. Called
        with the lock held; the flush runs outside it."""
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
        _, q, e, q2, e2, w, zdrop, end_bonus, flag = key
        tasks = [(t[0][0], t[0][1]) for t in group]
        mat = group[0][0][2]
        # the flushing thread is a pool worker: it does not inherit the
        # main thread's current CUDA device
        on_device = torch.cuda.device(self.device) \
            if self.device.type == "cuda" else contextlib.nullcontext()
        try:
            with on_device:
                self.n_dispatches += 1
                self.n_batched += len(tasks)
                results = extd2_batch(tasks, mat, q=q, e=e, q2=q2, e2=e2,
                                      w=w, zdrop=zdrop, end_bonus=end_bonus,
                                      flag=flag, device=self.device,
                                      fn=self.ext_fn)
            for (_, fut), rz in zip(group, results):
                fut.set_result(rz)
        except Exception as err:  # noqa: BLE001 - raised in every waiter
            for _, fut in group:
                if not fut.done():
                    fut.set_exception(err)
