"""The shared request-pool pattern (PR 4): a grow-only
``ThreadPoolExecutor`` plus semaphore-gated batch submission, factored out so
``runtime.server.QueryServer``, ``runtime.server.BatchServer`` and
``core.api.Session`` all drive admission through one idiom instead of three
hand-rolled pools.

Two invariants every user relies on:

* **grow-only** — a superseded (smaller) pool is never shut down: an
  in-flight submit may still hold it, and ``shutdown`` would raise
  ``RuntimeError`` mid-request.  Idle threads of an old pool park until
  process exit; growth happens at most a handful of times.
* **submission-time gating** — when a batch asks for fewer workers than the
  pool has, the width limit is enforced with a semaphore taken by the
  SUBMITTING thread, not by parking excess tasks inside workers: parked
  tasks would occupy pool threads and FIFO-starve a concurrent caller's
  batch.

This module is stdlib-only so ``core`` can import it without touching
``runtime``.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence


class RequestPool:
    """A lazily-built, grow-only thread pool for request admission."""

    DEFAULT_WORKERS = 4

    def __init__(self, thread_name_prefix: str = "bigdawg-request"):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._size = 0
        self._lock = threading.Lock()
        self._prefix = thread_name_prefix

    def pool(self, workers: Optional[int] = None) -> ThreadPoolExecutor:
        want = workers or self.DEFAULT_WORKERS
        with self._lock:
            if self._pool is None or self._size < want:
                self._pool = ThreadPoolExecutor(
                    max_workers=want, thread_name_prefix=self._prefix)
                self._size = want
            return self._pool

    def submit(self, fn: Callable, *args, workers: Optional[int] = None,
               **kwargs) -> Future:
        """Submit one task (growing the pool to ``workers`` if asked)."""
        return self.pool(workers).submit(fn, *args, **kwargs)

    def map_ordered(self, fn: Callable[[Any], Any], items: Sequence,
                    workers: Optional[int] = None) -> List:
        """Run ``fn`` over ``items`` at most ``workers`` wide and return the
        results in input order.  ``workers<=1`` (or a single item) degrades
        to a plain sequential loop — no pool round-trips.  The width gate is
        taken at submission time (see module docstring); a task exception
        propagates out of the corresponding ``result()`` call, in input
        order."""
        items = list(items)
        w = workers if workers is not None else self.DEFAULT_WORKERS
        if w <= 1 or len(items) <= 1:
            return [fn(item) for item in items]
        pool = self.pool(w)
        gate = threading.Semaphore(w)
        futures: List[Future] = []
        for item in items:
            gate.acquire()
            fut = pool.submit(fn, item)
            fut.add_done_callback(lambda _f: gate.release())
            futures.append(fut)
        return [f.result() for f in futures]
