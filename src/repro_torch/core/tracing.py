"""Tracing in two halves: request-scoped span trees for polystore queries,
and regions on the profiler's clock for the LM path.

**Span trees.**  The paper's middleware carries a *monitor* that
"collects performance information about each query"; ``Monitor``
(monitor.py) keeps the *aggregate* half of that story (per-signature
engine rates that feed the optimizer).  This module adds the
*request-scoped* half: a ``Tracer``
produces one ``Trace`` per request — a tree of timed ``Span`` records
(``plan``, ``cache_hit``/``cache_miss``, ``train``, ``cast``,
``engine_op``, ``fused_segment``, ``ivm_patch``, ``failover``,
``queue_wait``, ``worker_dispatch``, ...) with ids, parent ids, and
attributes (signature, engine, plan key, bytes).

Design constraints, in order:

1. **Near-zero overhead when disabled.**  A disabled ``Tracer`` returns
   ``None`` from :meth:`Tracer.start`; every instrumentation site guards
   with ``if span is not None`` and makes *no* ``perf_counter`` calls and
   *no* allocations on the disabled path.
2. **Cross-process.**  A trace survives the procpool pipe RPC: the master
   ships ``(trace_id, parent_span_id)`` with the request, the worker roots
   its spans under that parent, and the master re-attaches the worker's
   serialized records into its own tree (:meth:`Trace.adopt`).  Span ids
   embed the pid so records from different processes never collide.
3. **Cheap when enabled.**  Spans are recorded as flat dicts appended
   under one lock; the tree is only materialized on demand
   (:meth:`Trace.tree`).  Hot paths that already measured a duration
   attach it via :meth:`Span.static_child` instead of re-timing.

**Profiler regions.**  The LM path (``BatchServer``, the model blocks, the
MoE layer, the train step) marks its layers with :func:`region`: a
``torch.profiler.record_function`` named ``repro_torch.<name>`` while a
profiler runs, so that an operator sees the regions in any
``torch.profiler`` trace of a serving or training process, on the same
clock as the CUDA activity the profiler collects, and each idle gap of the
device can be put down to what the program was doing.  With no profiler
running a region is one shared no-op context: no clock read, no
allocation and no dispatcher call.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["Span", "Trace", "Tracer", "NULL_TRACER", "region"]

_IDS = itertools.count(1)


def _new_id() -> str:
    """Process-unique span id; pid prefix keeps ids unique across workers."""
    return "%x-%d" % (os.getpid(), next(_IDS))


class Span:
    """A live (in-progress) span.  Use as a context manager, or call
    :meth:`end` explicitly.  Finished spans live on as plain dicts inside
    the owning :class:`Trace`."""

    __slots__ = ("trace", "name", "sid", "parent", "attrs", "t0", "_done")

    def __init__(self, trace: "Trace", name: str, parent: Optional[str],
                 attrs: Dict[str, Any]):
        self.trace = trace
        self.name = name
        self.sid = _new_id()
        self.parent = parent
        self.attrs = attrs
        self.t0 = time.perf_counter()
        self._done = False

    # -- lifecycle ---------------------------------------------------------
    def end(self, seconds: Optional[float] = None) -> None:
        if self._done:
            return
        self._done = True
        dt = time.perf_counter() - self.t0 if seconds is None else seconds
        self.trace._append(self.name, self.sid, self.parent, dt, self.attrs)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end()

    # -- children ----------------------------------------------------------
    def child(self, name: str, **attrs: Any) -> "Span":
        """Start a timed child span."""
        return Span(self.trace, name, self.sid, attrs)

    def static_child(self, name: str, seconds: float, **attrs: Any) -> str:
        """Record an already-measured child span; returns its span id so
        further static children can nest under it (pro-rata attribution)."""
        return self.trace._append(name, _new_id(), self.sid, seconds, attrs)

    def event(self, name: str, **attrs: Any) -> str:
        """Record a zero-duration child marker (e.g. ``cache_hit``)."""
        return self.trace._append(name, _new_id(), self.sid, 0.0, attrs)

    def annotate(self, **attrs: Any) -> None:
        self.attrs.update(attrs)


class Trace:
    """One request's span records.  Thread-safe appends; records from
    worker processes are merged in via :meth:`adopt`."""

    __slots__ = ("trace_id", "parent_sid", "spans", "_lock")

    def __init__(self, trace_id: Optional[str] = None,
                 parent_sid: Optional[str] = None):
        self.trace_id = trace_id or _new_id()
        self.parent_sid = parent_sid        # cross-process root attachment
        self.spans: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def _append(self, name: str, sid: str, parent: Optional[str],
                seconds: float, attrs: Dict[str, Any]) -> str:
        rec = {"name": name, "sid": sid,
               "parent": parent if parent is not None else self.parent_sid,
               "seconds": float(seconds)}
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            self.spans.append(rec)
        return sid

    def static(self, name: str, parent: Optional[str], seconds: float,
               **attrs: Any) -> str:
        """Record an already-measured span under an arbitrary parent sid
        (e.g. per-member ``engine_op`` records nested under a
        ``fused_segment``'s id)."""
        return self._append(name, _new_id(), parent, seconds, attrs)

    def root(self, name: str, **attrs: Any) -> Span:
        """Start this trace's root span (parented across the process
        boundary when ``parent_sid`` was propagated)."""
        return Span(self, name, None, attrs)

    def adopt(self, blob: Optional[Dict[str, Any]]) -> None:
        """Merge serialized records from another process into this tree.
        Worker records arrive already parented (their root carries the
        ``parent_sid`` the master sent), so this is a plain extend."""
        if not blob:
            return
        recs = blob.get("spans", []) if isinstance(blob, dict) else list(blob)
        with self._lock:
            self.spans.extend(recs)

    # -- context propagation ----------------------------------------------
    def ctx(self, span: Optional[Span] = None) -> Tuple[str, Optional[str]]:
        """``(trace_id, parent_span_id)`` tuple to ship across an RPC."""
        return (self.trace_id, span.sid if span is not None else None)

    # -- export ------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {"trace_id": self.trace_id, "spans": list(self.spans)}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False)

    def tree(self) -> List[Dict[str, Any]]:
        """Materialize the nested tree: a list of root nodes, each
        ``{name, sid, seconds, attrs, children: [...]}`` in record order.
        Spans whose parent is unknown (e.g. a worker-side fragment whose
        master span was elided) surface as roots rather than vanishing."""
        with self._lock:
            recs = [dict(r) for r in self.spans]
        by_sid = {r["sid"]: r for r in recs}
        for r in recs:
            r["children"] = []
        roots: List[Dict[str, Any]] = []
        for r in recs:
            p = by_sid.get(r.get("parent"))
            if p is None:
                roots.append(r)
            else:
                p["children"].append(r)
        return roots

    def find(self, name: str) -> List[Dict[str, Any]]:
        """All span records with the given name, in record order."""
        with self._lock:
            return [r for r in self.spans if r["name"] == name]

    def __len__(self) -> int:
        with self._lock:
            return len(self.spans)


class Tracer:
    """Trace factory.  ``Tracer(enabled=False)`` (or the module-level
    :data:`NULL_TRACER`) never allocates a trace: :meth:`start` returns
    ``None`` unless the caller passes a propagated context, and every
    instrumentation site checks for ``None`` before touching the clock."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)

    def start(self, ctx: Optional[Tuple[str, Optional[str]]] = None
              ) -> Optional[Trace]:
        """Begin a trace for one request.  ``ctx`` is a propagated
        ``(trace_id, parent_span_id)`` from an upstream process; when
        given, tracing is forced on for this request so the worker's
        spans can re-attach to the master's tree."""
        if ctx is not None:
            return Trace(trace_id=ctx[0], parent_sid=ctx[1])
        if not self.enabled:
            return None
        return Trace()

    def __bool__(self) -> bool:
        return self.enabled


NULL_TRACER = Tracer(enabled=False)


def portable(trace: Optional[Any]) -> Optional[Dict[str, Any]]:
    """Picklable form of a trace for the pipe RPC (Trace carries a lock)."""
    if trace is None:
        return None
    return trace.to_dict() if isinstance(trace, Trace) else trace


_PROFILER = torch.autograd.profiler
_NULL_REGION = nullcontext()


def region(name: str):
    """A ``record_function`` named ``repro_torch.<name>`` while a profiler
    runs (``_is_profiler_enabled``, the module flag torch keeps for fast
    Python checks), else one shared no-op context."""
    if _PROFILER._is_profiler_enabled:
        return _PROFILER.record_function("repro_torch." + name)
    return _NULL_REGION
