"""The hand kernels' launch counters: thread-safe, and credited across CUDA
graph replays.

Each wrapper (``haar_cuda``, ``knn_scores_cuda``, ``flash_attention_cuda``,
``ssd_intra_cuda``) keeps its counts as plain integers on itself and adds
to them through ``count`` where it launches its kernel, and nowhere else.
Serving threads launch kernels side by side, so every change takes one lock.

A CUDA graph replays the launches it captured without calling the wrapper
again.  ``core.fuseplan`` therefore captures a segment inside
``recording()``, which gathers the counts that the capture added on this
thread; it takes them back out (a capture launches nothing) and ``credit``s
them again on every replay.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterable, Tuple

_LOCK = threading.Lock()
_LOCAL = threading.local()

Deltas = Dict[Tuple[object, str], int]


def count(fn, *attrs: str) -> None:
    """Add one to each counter ``fn.<attr>`` (a wrapper's launch)."""
    with _LOCK:
        for attr in attrs:
            setattr(fn, attr, getattr(fn, attr) + 1)
    deltas = getattr(_LOCAL, "deltas", None)
    if deltas is not None:
        for attr in attrs:
            deltas[fn, attr] = deltas.get((fn, attr), 0) + 1


@contextmanager
def recording():
    """Yield a dict that gathers ``{(fn, attr): n}``, the counts that this
    thread adds inside the block."""
    outer = getattr(_LOCAL, "deltas", None)
    _LOCAL.deltas = deltas = {}
    try:
        yield deltas
    finally:
        _LOCAL.deltas = outer


def credit(deltas: Deltas, times: int = 1) -> None:
    """Add ``times`` x each recorded count (negative takes them out)."""
    with _LOCK:
        for (fn, attr), n in deltas.items():
            setattr(fn, attr, getattr(fn, attr) + times * n)


def reset(pairs: Iterable[Tuple[object, str]]) -> None:
    with _LOCK:
        for fn, attr in pairs:
            setattr(fn, attr, 0)


def read(named: Dict[str, Tuple[object, str]]) -> Dict[str, int]:
    with _LOCK:
        return {name: getattr(fn, attr) for name, (fn, attr) in named.items()}
