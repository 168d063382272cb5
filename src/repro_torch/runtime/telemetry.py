"""Process-wide metrics registry: counters, gauges, latency histograms.

Absorbs the serving stack's scattered ``stats[...]`` dicts (server,
middleware, health, procpool) behind one API with a lock-free read path:
writers mutate plain floats/ints under one registry lock, readers
(:meth:`Metrics.snapshot`, the ``QueryServer.stats`` view) copy them
without taking it — under CPython each individual read is consistent, and
stats consumers only ever want a monotone point-in-time view.

Persistence mirrors the monitor's merge-on-save protocol, adapted for
counters: the JSON blob (``monitor.metrics.json`` beside the plan cache,
atomic via :mod:`repro_torch.core.ioutil`) holds one section per *writer*
(a process-unique id), and each save rewrites only the caller's section
while carrying every other writer's through.  Totals are therefore exact
under multi-process contention — a worker's section is its own full
counts, last-writer-wins per section — which is what the procpool's
convergence tests hammer.

Histograms use fixed log-spaced buckets (factor ``10**(1/8)`` ≈ 1.33 from
3.2 µs to 100 s), so quantile estimates are within one bucket ratio of the
exact percentile; ``snapshot()`` surfaces p50/p95/p99 per histogram.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
from typing import Any, Dict, List, Optional

try:
    import fcntl
except ImportError:          # non-POSIX: degrade to best-effort merge
    fcntl = None

from repro_torch.core.ioutil import atomic_json_dump, load_json

__all__ = ["Histogram", "Metrics", "default_metrics_path", "load_merged"]

_FORMAT = 1

# log-spaced bucket upper bounds: 10**(-5.5) .. 10**2 seconds, factor 10**(1/8)
HIST_BOUNDS: List[float] = [10.0 ** (e / 8.0) for e in range(-44, 17)]

_WRITER_IDS = itertools.count(1)


def default_metrics_path(monitor_path: str) -> str:
    """``state/monitor.json`` -> ``state/monitor.metrics.json`` — same
    satellite-file convention as the plan cache / views / health blobs."""
    root, _ = os.path.splitext(monitor_path)
    return root + ".metrics.json"


def _bucket(v: float) -> int:
    # branchless-ish bisect; HIST_BOUNDS is small and fixed
    lo, hi = 0, len(HIST_BOUNDS)
    while lo < hi:
        mid = (lo + hi) // 2
        if v <= HIST_BOUNDS[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo          # == len(HIST_BOUNDS) -> overflow bucket


class Histogram:
    """Fixed-bucket latency histogram with streaming sum/min/max."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        b = _bucket(v)
        self.counts[b] = self.counts.get(b, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile: the geometric midpoint of the bucket
        where the cumulative count crosses ``q * count``, clamped to the
        observed min/max so tail quantiles never over/under-shoot."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0.0
        for b in sorted(self.counts):
            acc += self.counts[b]
            if acc >= target:
                lo = HIST_BOUNDS[b - 1] if b > 0 else HIST_BOUNDS[0] / 10.0
                hi = HIST_BOUNDS[b] if b < len(HIST_BOUNDS) else self.max
                est = (lo * hi) ** 0.5 if hi > 0 else 0.0
                return min(max(est, self.min), self.max)
        return self.max

    def merge(self, other: "Histogram") -> None:
        for b, n in other.counts.items():
            self.counts[b] = self.counts.get(b, 0) + n
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    # -- (de)serialization -------------------------------------------------
    def to_blob(self) -> Dict[str, Any]:
        return {"counts": {str(b): n for b, n in self.counts.items()},
                "count": self.count, "sum": self.sum,
                "min": (None if self.count == 0 else self.min),
                "max": self.max}

    @classmethod
    def from_blob(cls, blob: Dict[str, Any]) -> "Histogram":
        h = cls()
        h.counts = {int(b): int(n) for b, n in blob.get("counts", {}).items()}
        h.count = int(blob.get("count", 0))
        h.sum = float(blob.get("sum", 0.0))
        mn = blob.get("min")
        h.min = float("inf") if mn is None else float(mn)
        h.max = float(blob.get("max", 0.0))
        return h

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": round(self.sum, 9),
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99),
                "min": (0.0 if self.count == 0 else self.min),
                "max": self.max}


class Metrics:
    """One process's metrics registry, optionally backed by a shared file.

    Writes (``counter``/``gauge``/``observe``) take one internal lock;
    reads (``value``/``snapshot``) do not — they see a consistent-enough
    point-in-time view (CPython dict reads are atomic, and stats are
    monotone counters).
    """

    def __init__(self, path: Optional[str] = None, shared: bool = False):
        self.path = path
        self.shared = bool(shared)
        # process-unique writer id: pid + in-process counter so respawns /
        # multiple registries in one process never collide in the file
        self.writer_id = "%d-%d" % (os.getpid(), next(_WRITER_IDS))
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- write path --------------------------------------------------------
    def counter(self, name: str, delta: float = 1.0) -> float:
        with self._lock:
            v = self._counters.get(name, 0.0) + delta
            self._counters[name] = v
            return v

    def set_counter(self, name: str, value: float) -> None:
        with self._lock:
            self._counters[name] = float(value)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(seconds)

    # -- lock-free read path ----------------------------------------------
    def value(self, name: str, default: float = 0.0) -> float:
        return self._counters.get(name, self._gauges.get(name, default))

    def histogram(self, name: str) -> Optional[Histogram]:
        return self._hists.get(name)

    def snapshot(self, merged: bool = False) -> Dict[str, Any]:
        """Point-in-time view: ``{"counters", "gauges", "histograms"}``.
        With ``merged=True`` and a backing file, other writers' persisted
        sections are folded in (counters/histograms sum; gauges are
        per-process, local values win)."""
        counters = dict(self._counters)
        gauges = dict(self._gauges)
        hists = {k: Histogram.from_blob(h.to_blob())
                 for k, h in list(self._hists.items())}
        if merged and self.path:
            for wid, sec in self._read_sections().items():
                if wid == self.writer_id:
                    continue
                for k, v in sec.get("counters", {}).items():
                    counters[k] = counters.get(k, 0.0) + float(v)
                for k, v in sec.get("gauges", {}).items():
                    gauges.setdefault(k, float(v))
                for k, hb in sec.get("histograms", {}).items():
                    h = hists.get(k)
                    if h is None:
                        hists[k] = Histogram.from_blob(hb)
                    else:
                        h.merge(Histogram.from_blob(hb))
        return {"counters": counters, "gauges": gauges,
                "histograms": {k: h.summary() for k, h in hists.items()}}

    # -- persistence -------------------------------------------------------
    def _section(self) -> Dict[str, Any]:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "histograms": {k: h.to_blob()
                                   for k, h in self._hists.items()}}

    def _read_sections(self) -> Dict[str, Dict[str, Any]]:
        if not self.path:
            return {}
        try:
            blob = load_json(self.path)
        except (OSError, ValueError):
            return {}
        if not isinstance(blob, dict):
            return {}
        return blob.get("writers", {})

    @contextlib.contextmanager
    def _file_lock(self, path: str):
        """Advisory lock serializing the read-modify-write below.  The
        monitor's merge-on-save tolerates a racing writer resurrecting a
        stale sibling section (counts may trail, never corrupt); a metrics
        registry is judged on exact totals, so saves take a per-file flock
        when the platform has one and the hammer test asserts exactness."""
        if fcntl is None:
            yield
            return
        with open(path + ".lock", "a") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)

    def save(self, path: Optional[str] = None) -> None:
        """Merge-on-save: rewrite only this writer's section, carry every
        other writer's through.  Atomic via ``ioutil.atomic_json_dump``;
        exact under multi-process contention via the advisory file lock."""
        path = path or self.path
        if not path:
            return
        with self._file_lock(path):
            writers = self._read_sections() \
                if (self.shared or path == self.path) else {}
            writers[self.writer_id] = self._section()
            atomic_json_dump(path, {"format": _FORMAT, "writers": writers})


def load_merged(path: str) -> Dict[str, Any]:
    """Merged snapshot of a metrics file, summed across all writers."""
    agg = Metrics()           # pathless scratch registry
    try:
        blob = load_json(path)
    except (OSError, ValueError):
        return agg.snapshot()
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Histogram] = {}
    for sec in blob.get("writers", {}).values():
        for k, v in sec.get("counters", {}).items():
            counters[k] = counters.get(k, 0.0) + float(v)
        for k, v in sec.get("gauges", {}).items():
            gauges[k] = float(v)
        for k, hb in sec.get("histograms", {}).items():
            h = hists.get(k)
            if h is None:
                hists[k] = Histogram.from_blob(hb)
            else:
                h.merge(Histogram.from_blob(hb))
    return {"counters": counters, "gauges": gauges,
            "histograms": {k: h.summary() for k, h in hists.items()}}


# -- multi-process contention hammer (spawn target; must be importable) ----
def _metrics_hammer(path: str, private: str, shared_name: str,
                    rounds: int, seed: int) -> None:
    """Worker body for the 3-process merge-on-save contention test: bump a
    private counter and a shared-name counter each round, observe a
    latency, and save after every round so writers constantly race on the
    file.  Exactness invariant: the final merged file must show each
    private counter == rounds and the shared counter == writers*rounds."""
    import random
    rng = random.Random(seed)
    m = Metrics(path, shared=True)
    for i in range(rounds):
        m.counter(private)
        m.counter(shared_name)
        m.observe("hammer.latency", rng.uniform(1e-4, 1e-1))
        m.gauge("hammer.last_round", float(i))
        m.save()
