"""Migrator (paper §III-C / [18]): executes casts between engines, keeps
account of the bytes moved (the executor charges them to the plan's stats),
and times every transfer so the calibrated cost model can learn real cast
bandwidth per (src, dst) data-model pair.

Given a cost model, the migrator follows ``cast_path`` — the cheapest route
over the calibrated cast graph, which may be multi-hop (coo->dense->columnar
when the direct pair is slow), with every hop sized from the format the data
is actually in at that hop (a coo->dense hop densifies the payload).  Every
hop is timed and reported separately, so the model keeps learning true
per-pair bandwidths even on detours.

One Migrator instance is shared by all of a plan's nodes; in the executor's
thread-pooled concurrent mode several host workers cast through it at once,
so the byte/cast accounting is guarded by a lock (the casts themselves run
outside it and genuinely overlap).  Nothing is shared ACROSS plans: every
``execute_plan`` call builds its own Migrator, so concurrent request
threads (and background exploration tasks) never contend on each other's
accounting — the executor reads the totals only after the final level
barrier, when all of this plan's workers have joined."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from repro_torch.core import cast as castmod
from repro_torch.core.engines import ENGINES


@dataclass
class Migrator:
    bytes_moved: float = 0.0
    n_casts: int = 0
    # (src_kind, dst_kind, bytes, seconds) per executed cast hop
    events: List[Tuple[str, str, float, float]] = field(default_factory=list)
    cost_model: Optional[Any] = None     # enables calibrated multi-hop routes
    trace: Optional[Any] = None          # parent tracing.Span for cast spans
    device: Any = "cpu"                  # where dense cast outputs are built
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                  compare=False)

    def to_engine(self, obj, engine_name: str):
        eng = ENGINES[engine_name]
        if obj.kind == eng.kind:
            return obj
        path = castmod.cast_path(obj.kind, eng.kind, obj.nbytes,
                                 self.cost_model, obj=obj)
        for dst_kind in path[1:]:
            src_kind, nbytes = obj.kind, obj.nbytes
            t0 = time.perf_counter()
            obj = castmod.cast_step(obj, dst_kind, self.device)
            dt = time.perf_counter() - t0
            with self._lock:
                self.bytes_moved += nbytes
                self.n_casts += 1
                self.events.append((src_kind, dst_kind, float(nbytes), dt))
            if self.trace is not None:     # Trace appends take their own lock
                self.trace.static_child("cast", dt, src=src_kind,
                                        dst=dst_kind, bytes=float(nbytes))
        return obj

    def reset(self):
        with self._lock:
            self.bytes_moved = 0.0
            self.n_casts = 0
            self.events.clear()
