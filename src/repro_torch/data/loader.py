"""Prefetching, resumable data loader.

The port of ``repro.data.loader``.  Wraps any step->batch function and
prefetches ahead on a background thread, overlapping host data generation
with the device's step.  Where the reference places batches with the
plan's input shardings, the port places them on ``device``: a batch bound
for the CUDA card is pinned and copied with ``non_blocking`` on the
thread, stream-ordered before the step that reads it.  ``device=None``
means the card, as at every entry point; ``device="cpu"`` leaves batches
where ``batch_fn`` made them.  An error in ``batch_fn`` or the copy is
raised by the ``next`` that would have returned its batch (the reference's
thread dies with it, and ``next`` waits for ever).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable

from repro_torch.core.tables import resolve_device
from repro_torch.tree import tree_map


class ShardedLoader:
    def __init__(self, batch_fn: Callable[[int], dict], start_step: int = 0,
                 device=None, prefetch: int = 2):
        self.batch_fn = batch_fn
        self.device = resolve_device(device)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch):
        if self.device.type != "cuda":
            return batch
        return tree_map(lambda x: x.pin_memory().to(self.device,
                                                    non_blocking=True),
                        batch)

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                b = self._place(self.batch_fn(step))
            except Exception as e:          # handed to the consumer
                b = e
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.2)
                    break
                except queue.Full:
                    continue
            if isinstance(b, Exception):
                return
            step += 1

    def __next__(self):
        step, b = self._q.get()
        if isinstance(b, Exception):
            raise b
        self.step = step + 1
        return b

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def state(self) -> dict:
        """Checkpointable loader state (resume = rebuild at this step)."""
        return {"step": self.step}
