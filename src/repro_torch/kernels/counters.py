"""The hand kernels' launch counters and the program's work counters:
thread-safe, and credited across CUDA graph replays.

Each wrapper (``haar_cuda``, ``knn_scores_cuda``, ``flash_attention_cuda``,
``ssd_intra_cuda``, ``decode_attention_cuda``) keeps its counts as plain
integers on itself and adds to them through ``count`` where it launches its kernel, and nowhere else.
The LM path's work counts live on ``LM_WORK`` here, so that
``kernels.ops`` reads them without importing ``models``, and grow through
``add`` by amounts computed from tensor shapes on the host:
``expand_kv_bytes`` (the bytes of each tensor that
``models.layers._expand_kv`` returns where it repeats KV heads: the
context-parallel decode and the encoder-decoder's cross-attention),
``moe_rows_computed`` (groups x the rank's experts x the capacity, each
``moe_apply``) and ``moe_rows_routed`` (groups x tokens x top-k).
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


class Counts:
    """Named integer counts held on one object, as a wrapper holds its
    launch counts."""

    def __init__(self, *names: str):
        for name in names:
            setattr(self, name, 0)


LM_WORK = Counts("expand_kv_bytes", "moe_rows_computed", "moe_rows_routed")


def _add(fn, attrs: Tuple[str, ...], n: int) -> None:
    with _LOCK:
        for attr in attrs:
            setattr(fn, attr, getattr(fn, attr) + n)
    deltas = getattr(_LOCAL, "deltas", None)
    if deltas is not None:
        for attr in attrs:
            deltas[fn, attr] = deltas.get((fn, attr), 0) + n


def count(fn, *attrs: str) -> None:
    """Add one to each counter ``fn.<attr>`` (a wrapper's launch)."""
    _add(fn, attrs, 1)


def add(fn, attr: str, n: int) -> None:
    """Add ``n`` to the counter ``fn.<attr>`` (a work count)."""
    _add(fn, (attr,), n)


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
