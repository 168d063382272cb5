"""Performance monitor (paper §III-C / [17]): a history DB keyed by query
signature, holding per-plan statistics and the system-usage snapshot at
measurement time.  Production-phase matching compares the current usage
snapshot against the recorded one; large drift triggers retraining advice
(paper: "the optimizer may ... recommend that the user rerun the query under
the training phase under the current usage").

Beyond per-plan timings, the monitor stores *measured intermediate sizes*
AND *measured dense-equivalent shapes*: the executor reports each node's
actual logical output bytes and output shape (keyed by post-order position,
which is stable across structurally-identical query rebuilds — the same
property plan keys rely on), and ``measured_sizes`` / ``measured_shapes``
hand them back to the planner so data-dependent ops (select, join,
distinct) are sized from observation instead of shape rules, and downstream
shape-driven estimates (matmul, transpose) build on observed geometry.

**History decay.**  All running means (per-plan seconds and cast bytes,
per-position sizes) are *exponentially decayed*: each new sample enters with
weight ``alpha = max(1 / (n + 1), decay)``, so the first few samples behave
exactly like a cumulative mean and, once ``n + 1 > 1 / decay``, the mean
becomes an EMA whose newest-sample weight floors at ``decay``.  A workload
shift (the same signature suddenly selecting 10x the rows, or a plan's
runtime regressing) therefore moves the mean within ~``1/decay`` runs
instead of being diluted by an unbounded tail of stale samples.  The knob is
``Monitor(path, decay=...)`` (default ``DECAY = 0.2``, i.e. full cumulative
averaging through the first 5 samples, then a 5-run effective window);
``decay=0.0`` restores pure cumulative means.

**Thread safety and batched flushing.**  The monitor is written to from
many threads at once — concurrent production serves, training runs on
different signatures, and background exploration tasks on the host pool.
``record`` therefore never mutates the history dicts directly: it appends
the raw observation to a pending queue (one lock-guarded list append, cheap
enough for the request path) and ``flush()`` drains that queue, applying the
decayed-mean updates in arrival order.  Every reader (``best``,
``known_plans``, ``measured_sizes``, ``measured_shapes``) and ``save()``
flushes first, so external behavior is exactly the per-record semantics —
batched only between a record and the next read.  All state is guarded by
one internal ``RLock``.

Persistence: one JSON file (``Monitor(path)``), written atomically through
``ioutil.atomic_json_dump`` — the blob is dumped to a same-directory temp
file and moved into place with ``os.replace``, so a crash mid-save can never
truncate or corrupt the DB (the previous version survives intact).  Format
(version 3 adds ``shapes``; version-2 files and version-1 files — a bare
``{sig: {plan_key: stats}}`` mapping — still load)::

    {"format": 3,
     "plans":  {sig: {plan_key: PlanStats-dict}},    # timings + usage
     "sizes":  {sig: {post_order_pos: [mean_bytes, n_samples]}},
     "shapes": {sig: {post_order_pos: [dim, ...]}}}  # last observed shape

Worked example (round-trips through one file)::

    >>> m = Monitor("/tmp/demo.monitor.json")
    >>> m.record("s1", "0:dense_array", 0.02, sizes={0: 4096.0},
    ...          shapes={0: (32, 32)})
    >>> m.save()                              # atomic write
    >>> m2 = Monitor("/tmp/demo.monitor.json")    # fresh process: warm start
    >>> m2.best("s1")[0]
    '0:dense_array'
    >>> m2.measured_sizes("s1")
    {0: 4096.0}
    >>> m2.measured_shapes("s1")
    {0: (32, 32)}
"""
from __future__ import annotations

import os
import resource
import threading
import time
from dataclasses import dataclass, field, asdict
from typing import Dict, Optional, Tuple

from repro_torch.core.ioutil import (atomic_json_dump, file_version, load_json,
                               load_json_versioned)


def _ema_alpha(n: int, decay: float) -> float:
    """Weight of the newest sample: cumulative-mean behavior for the first
    ``1/decay`` samples, then an EMA floored at ``decay`` (see module
    docstring)."""
    return max(1.0 / (n + 1), decay)


@dataclass
class PlanStats:
    mean_seconds: float = 0.0
    n: int = 0
    last_seconds: float = 0.0
    cast_bytes: float = 0.0
    usage: Dict[str, float] = field(default_factory=dict)
    extra: Dict[str, float] = field(default_factory=dict)

    def record(self, seconds: float, usage: Dict[str, float],
               cast_bytes: float = 0.0, extra: Optional[Dict] = None,
               decay: float = 0.0):
        a = _ema_alpha(self.n, decay)
        self.mean_seconds = (1.0 - a) * self.mean_seconds + a * seconds
        # decayed like mean_seconds — a single light run must not overwrite
        # the history (cast traffic can vary with catalog state)
        self.cast_bytes = (1.0 - a) * self.cast_bytes + a * cast_bytes
        self.n += 1
        self.last_seconds = seconds
        self.usage = dict(usage)
        if extra:
            self.extra.update(extra)


def usage_snapshot(device=None) -> Dict[str, float]:
    """The usage environment a measurement was taken under.  ``devices``
    counts the devices of ``device``'s type: the visible CUDA devices for a
    CUDA session, 1 for the CPU (what the reference reports on a CPU host,
    so histories carry over between the two packages)."""
    import torch   # deferred: keeps Monitor importable/usable (with explicit
                   # usage=) without loading torch
    ru = resource.getrusage(resource.RUSAGE_SELF)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return {
        "devices": float(torch.cuda.device_count()
                         if dev.type == "cuda" else 1),
        "rss_gb": ru.ru_maxrss / 1e6,
        "time": time.time(),
    }


def usage_drift(a: Dict[str, float], b: Dict[str, float]) -> float:
    """Relative drift between two snapshots (0 = identical environment)."""
    d = 0.0
    for k in ("devices", "rss_gb"):
        va, vb = a.get(k, 0.0), b.get(k, 0.0)
        if max(va, vb) > 0:
            d = max(d, abs(va - vb) / max(va, vb))
    return d


class Monitor:
    """signature -> {plan_key: PlanStats} (+ measured sizes/shapes);
    JSON-persistent, with exponentially-decayed means and thread-safe
    batched recording (see module docstring)."""

    DRIFT_THRESHOLD = 0.5
    DECAY = 0.2           # newest-sample floor weight for all running means

    def __init__(self, path: Optional[str] = None,
                 decay: Optional[float] = None, shared: bool = False):
        self.path = path
        self.decay = self.DECAY if decay is None else float(decay)
        # shared=True: this monitor's file is co-owned by other processes
        # (the procpool workers).  save() then MERGES into the current file
        # instead of overwriting it, and ``reload_if_changed`` adopts other
        # writers' signatures.  Ownership is per-signature: a signature this
        # process has recorded itself (``_local_sigs``) is ours — our stats
        # win on save and a reload never clobbers them; everything else is
        # adopted from the file (last writer wins per signature).
        self.shared = bool(shared)
        self._local_sigs: set = set()
        self._file_version = None
        self.db: Dict[str, Dict[str, PlanStats]] = {}
        # sig -> {post-order position: [mean logical bytes, n]} — actual
        # intermediate sizes, fed back into estimate_sizes on re-plans
        self.sizes: Dict[str, Dict[int, list]] = {}
        # sig -> {post-order position: (dim, ...)} — last observed
        # dense-equivalent shapes (shapes are discrete: the newest
        # observation replaces, it is not averaged)
        self.shapes: Dict[str, Dict[int, Tuple[int, ...]]] = {}
        self.background_queue: list = []     # plans to re-explore when idle
        # guards db/sizes/shapes/background_queue AND the pending-record
        # queue; re-entrant so flush() may run inside a locked reader
        self._lock = threading.RLock()
        # raw observations awaiting application — record() only appends
        # here, flush() drains in arrival order (see module docstring)
        self._pending: list = []
        if path and os.path.exists(path):
            self.load(path)

    # -- recording ---------------------------------------------------------
    def record(self, sig: str, plan_key: str, seconds: float,
               cast_bytes: float = 0.0, extra: Optional[Dict] = None,
               usage: Optional[Dict[str, float]] = None,
               sizes: Optional[Dict[int, float]] = None,
               shapes: Optional[Dict[int, Tuple[int, ...]]] = None):
        """Enqueue one observation (cheap; safe from any thread).  The
        decayed-mean updates happen at the next ``flush()`` — which every
        reader performs — so behavior is indistinguishable from immediate
        application unless you bypass the accessors and read ``db`` raw."""
        rec = (sig, plan_key, seconds, cast_bytes, extra,
               usage or usage_snapshot(), sizes, shapes)
        with self._lock:
            self._pending.append(rec)

    def _apply(self, rec) -> None:
        """Apply one queued observation to the history dicts (lock held)."""
        sig, plan_key, seconds, cast_bytes, extra, usage, sizes, shapes = rec
        self._local_sigs.add(sig)
        entry = self.db.setdefault(sig, {}).setdefault(plan_key, PlanStats())
        entry.record(seconds, usage, cast_bytes, extra, decay=self.decay)
        if sizes:
            store = self.sizes.setdefault(sig, {})
            for pos, nbytes in sizes.items():
                m = store.setdefault(int(pos), [0.0, 0])
                a = _ema_alpha(m[1], self.decay)
                m[0] = (1.0 - a) * m[0] + a * float(nbytes)
                m[1] += 1
        if shapes:
            store_s = self.shapes.setdefault(sig, {})
            for pos, shp in shapes.items():
                store_s[int(pos)] = tuple(int(d) for d in shp)

    def flush(self) -> int:
        """Drain the pending-record queue into the history dicts, in arrival
        order.  Returns the number of records applied.  Readers call this
        implicitly; call it directly after hammering ``record`` from worker
        threads if you are about to inspect ``db`` by hand."""
        with self._lock:
            pending, self._pending = self._pending, []
            for rec in pending:
                self._apply(rec)
            return len(pending)

    def pending_records(self) -> int:
        """Queued-but-unapplied observation count (diagnostics/tests)."""
        with self._lock:
            return len(self._pending)

    def measured_sizes(self, sig: str) -> Dict[int, float]:
        """Post-order position -> decayed-mean measured logical output bytes
        (empty dict when the signature has never been executed)."""
        with self._lock:
            self.flush()
            return {pos: m[0] for pos, m in self.sizes.get(sig, {}).items()}

    def measured_shapes(self, sig: str) -> Dict[int, Tuple[int, ...]]:
        """Post-order position -> last observed dense-equivalent output
        shape (only positions whose container format carries a cheap shape —
        dense/coo/stream; columnar outputs are absent)."""
        with self._lock:
            self.flush()
            return dict(self.shapes.get(sig, {}))

    # -- production-phase matching ------------------------------------------
    def best(self, sig: str, usage: Optional[Dict[str, float]] = None):
        """Returns (plan_key, stats, drifted).  (None, None, False) if the
        signature has never been trained."""
        with self._lock:
            self.flush()
            plans = self.db.get(sig)
            if not plans:
                return None, None, False
            key, stats = min(plans.items(), key=lambda kv: kv[1].mean_seconds)
        drifted = False
        if usage is not None and stats.usage:
            drifted = usage_drift(usage, stats.usage) > self.DRIFT_THRESHOLD
        return key, stats, drifted

    def known_plans(self, sig: str) -> Dict[str, PlanStats]:
        """Snapshot of the signature's stats dict (flushed first).  The
        dict is a copy — a concurrent flush adding a new plan key must not
        blow up a caller mid-iteration — but the PlanStats values are the
        live objects."""
        with self._lock:
            self.flush()
            return dict(self.db.get(sig, {}))

    def queue_background(self, sig: str, plan_key: str):
        with self._lock:
            self.background_queue.append((sig, plan_key))

    def pop_background(self):
        """Atomically pop one queued (sig, plan_key), or None when the queue
        is empty — the race-free consumer for ``run_background_queue`` (an
        unguarded check-then-pop can raise IndexError under two drainers)."""
        with self._lock:
            return self.background_queue.pop() if self.background_queue \
                else None

    # -- persistence ---------------------------------------------------------
    def save(self, path: Optional[str] = None, merge: Optional[bool] = None):
        """Persist atomically.  With ``merge`` (default: ``self.shared``) the
        current file is read first and signatures this process never recorded
        are carried through — concurrent writers only ever lose a signature
        race to a LATER writer of that same signature, never to an unrelated
        save (last-writer-wins per signature, no dropped entries)."""
        path = path or self.path
        if not path:
            return
        if merge is None:
            merge = self.shared
        with self._lock:
            self.flush()
            blob = {
                "format": 3,
                "plans": {sig: {pk: asdict(st) for pk, st in plans.items()}
                          for sig, plans in self.db.items()},
                "sizes": {sig: {str(pos): list(m) for pos, m in store.items()}
                          for sig, store in self.sizes.items()},
                "shapes": {sig: {str(pos): list(s) for pos, s in store.items()}
                           for sig, store in self.shapes.items()},
            }
            if merge:
                try:
                    cur = load_json(path)
                except (OSError, ValueError):
                    cur = None
                if isinstance(cur, dict) and "plans" in cur:
                    for section in ("plans", "sizes", "shapes"):
                        for sig, entry in cur.get(section, {}).items():
                            if sig not in self._local_sigs:
                                blob[section][sig] = entry
            atomic_json_dump(path, blob)
            self._file_version = file_version(path)

    def reload_if_changed(self, path: Optional[str] = None) -> bool:
        """Cross-process read path: if another process has replaced the file
        since we last read/wrote it, adopt its entries for every signature
        this process has not recorded itself.  One ``stat`` when nothing
        changed.  Returns True when new state was adopted."""
        path = path or self.path
        if not path:
            return False
        with self._lock:
            blob, ver = load_json_versioned(path, self._file_version)
            if blob is None:
                return False
            self._file_version = ver
            self.flush()
            db, sizes, shapes = self._parse_blob(blob)
            changed = False
            for src, dst in ((db, self.db), (sizes, self.sizes),
                             (shapes, self.shapes)):
                for sig, entry in src.items():
                    if sig not in self._local_sigs:
                        dst[sig] = entry
                        changed = True
            return changed

    @staticmethod
    def _parse_blob(blob):
        if isinstance(blob, dict) and "plans" in blob:      # format >= 2
            plans, sizes = blob["plans"], blob.get("sizes", {})
            shapes = blob.get("shapes", {})                 # format >= 3
        else:                       # format 1: bare {sig: {plan_key: stats}}
            plans, sizes, shapes = blob, {}, {}
        db = {sig: {pk: PlanStats(**st) for pk, st in pls.items()}
              for sig, pls in plans.items()}
        sizes = {sig: {int(pos): [float(m[0]), int(m[1])]
                       for pos, m in store.items()}
                 for sig, store in sizes.items()}
        shapes = {sig: {int(pos): tuple(int(d) for d in s)
                        for pos, s in store.items()}
                  for sig, store in shapes.items()}
        return db, sizes, shapes

    def load(self, path: str):
        blob = load_json(path)
        with self._lock:
            self.db, self.sizes, self.shapes = self._parse_blob(blob)
            self._file_version = file_version(path)
