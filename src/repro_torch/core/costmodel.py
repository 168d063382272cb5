"""Calibrated planner cost model (paper §III-C): predicted seconds for
engine ops and casts, learned from two sources —

  1. a one-shot *microbenchmark calibration* pass (``CostModel.calibrate``)
     that measures per-engine per-op throughput (elements/s) and per-cast-pair
     bandwidth (bytes/s) on small containers, and
  2. *monitor history*: every measured execution feeds per-node op timings and
     per-cast transfer timings back via ``observe_op`` / ``observe_cast``.

Cast predictions route *multi-hop*: ``cast_route`` searches the registered
cast graph for the cheapest path under the calibrated per-pair bandwidths, so
e.g. coo->dense->columnar wins over a direct coo->columnar pair that has been
measured slow.  Multi-hop routes are only trusted when every edge on them has
been observed — optimistic defaults never beat a real measurement.  Each hop
is sized from the format the data is in when that hop starts (pass
``kind_nbytes``, see ``kind_nbytes_from_logical`` /
``container_kind_nbytes``): a coo->dense hop *densifies* the payload, so the
following dense->columnar hop must be charged for the inflated dense bytes,
not the original COO triple bytes.

Beyond op and cast rates, the model learns the **host thread-dispatch
overhead** (``observe_dispatch`` / ``dispatch_overhead_s``): the measured
cost of a submit→result round trip through the executor's host pool on THIS
machine.  The executor's auto-threading gate compares each task's predicted
seconds against a multiple of this overhead — a task must dwarf the pool
round trip to be worth dispatching — replacing the old static byte
threshold (see ``executor.execute_plan``).

The model is **thread-safe**: every observation and every prediction takes
an internal lock (concurrent production serves, training runs, and
background exploration all read and write it), and ``save`` snapshots under
the same lock.

Persistence: the model is saved as JSON *beside the monitor DB*
(``default_calibration_path`` maps ``monitor.json`` -> ``monitor.calib.json``)
through ``ioutil.atomic_json_dump`` — a same-directory temp file moved into
place with ``os.replace``, so a crash mid-save can never truncate the file.
The blob stores each running mean with its sample count::

    {"calibrated": true,
     "op_rate":   {"dense_array": {"matmul": [5.2e8, 3]}},   # elems/s, n
     "cast_rate": {"dense>columnar": [1.8e8, 2]},            # bytes/s, n
     "dispatch_overhead": [2.1e-4, 5]}                       # s/round-trip, n

Worked example (everything round-trips through one file)::

    >>> cm = CostModel("/tmp/demo.calib.json")
    >>> cm.observe_op("dense_array", "matmul", elems=1e6, seconds=0.002)
    >>> cm.observe_cast("dense", "coo", nbytes=4e6, seconds=0.01)
    >>> cm.save()                              # atomic write
    >>> cm2 = CostModel("/tmp/demo.calib.json")    # fresh process: warm start
    >>> round(cm2.op_seconds("dense_array", "matmul", 1e6), 4)
    0.0021
    >>> cm2.cast_route("dense", "coo", 4e6)[1]     # calibrated direct route
    ['dense', 'coo']

All predictions degrade gracefully: an unobserved (engine, op) pair falls
back to the engine's measured mean, then to a per-kind default.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.ioutil import atomic_json_dump, load_json

# a-priori throughput guesses per engine *kind* (elements/s on one host core);
# only used before any calibration/history exists.  Relative order encodes the
# engines' real strengths (dense GEMM-shaped ops beat triple-scan layouts).
_DEFAULT_ELEMS_PER_S = {
    "dense": 5e8,
    "columnar": 1e8,
    "coo": 1.5e8,
    "stream": 3e8,
}
_DEFAULT_CAST_BYTES_PER_S = 2e8     # host-side format conversion, not ICI
# fixed per-dispatch overhead (python + torch dispatch), seconds
_OP_OVERHEAD_S = 5e-5
_CAST_OVERHEAD_S = 1e-4
# a-priori host-pool submit->result round-trip cost, before any measurement
_DEFAULT_DISPATCH_OVERHEAD_S = 2e-4


@dataclass
class _Mean:
    """Running mean with sample count (JSON-serializable)."""
    mean: float = 0.0
    n: int = 0

    def update(self, v: float):
        self.mean = (self.mean * self.n + v) / (self.n + 1)
        self.n += 1


def container_elems(obj) -> float:
    """LOGICAL element count of a tables.* container — the throughput unit.

    Columnar/COO count rows/nnz, not physical cells: the planner predicts
    from dense-equivalent sizes (it cannot know per-engine layouts of
    intermediates), so observed rates must use the same unit or row-store
    throughput gets inflated by the triples blow-up factor."""
    from repro_torch.core.tables import array_numel
    kind = getattr(obj, "kind", None)
    if kind == "dense":
        return float(array_numel(obj.data))
    if kind == "columnar":
        return float(obj.nrows)
    if kind == "coo":
        return float(obj.nnz)
    if kind == "stream":
        return float(array_numel(obj.data))
    return float(getattr(obj, "nbytes", 4)) / 4.0


def observed_nbytes(obj) -> float:
    """Measured LOGICAL output bytes of a container — the size-feedback unit
    the executor reports and ``Monitor`` stores per signature.

    Logical = the data an op semantically produced, not its physical layout:
    a dense select keeps its padded shape but only ``valid_count`` live cells,
    a columnar select masks rows without compacting, a COO result carries
    ``nnz`` triples.  This is what downstream cast volume and data-dependent
    op output (select/join/distinct) actually scale with — the quantity the
    planner's shape rules can only guess at.

    The unit is the valid-aware refinement of ``container_elems`` (4 bytes per
    dense-EQUIVALENT element): columnar counts valid rows, not cells, because
    a (i, j, value) triple table's rows ARE the dense equivalent's cells —
    index/coordinate columns are layout overhead the planner deliberately
    excludes (see ``_ref_size``), and op rates were learned in this unit."""
    from repro_torch.core.tables import array_numel
    kind = getattr(obj, "kind", None)
    if kind == "dense":
        n = obj.valid_count if obj.valid_count >= 0 \
            else array_numel(obj.data)
        return 4.0 * float(n)
    if kind == "columnar":
        return 4.0 * float(obj.valid.sum())
    if kind == "coo":
        return 4.0 * float(obj.nnz)
    if kind == "stream":
        return 4.0 * float(array_numel(obj.data))
    return float(getattr(obj, "nbytes", 4.0))


def observed_shape(obj) -> Optional[Tuple[int, ...]]:
    """Measured dense-equivalent SHAPE of a container, or None when the
    format does not carry one cheaply (columnar tables would need a max-scan
    over index columns).  This is the shape-feedback unit the executor
    reports (``ExecutionResult.shape_obs``) and the monitor stores so
    downstream matmul/transpose output estimates use observed shapes instead
    of rule-propagated guesses."""
    kind = getattr(obj, "kind", None)
    if kind in ("dense", "stream"):
        return tuple(int(d) for d in obj.data.shape)
    if kind == "coo":
        return tuple(int(d) for d in obj.shape)
    return None


def kind_nbytes_from_logical(logical_bytes: float,
                             shape: Optional[Tuple[int, ...]] = None
                             ) -> Dict[str, float]:
    """Predicted PHYSICAL bytes of a payload held in each data-model kind,
    from its logical size (4 bytes per live element) and, when known, its
    dense-equivalent shape.

    Dense/stream layouts materialize the full shape (densification: a sparse
    payload inflates to 4 * prod(shape)); triple layouts (columnar, coo)
    carry ~3 columns (i, j, value) per live element.  This is what makes
    per-hop cast sizing honest on multi-hop routes."""
    dense_b = float(logical_bytes)
    if shape:
        n = 1.0
        for d in shape:
            n *= d
        dense_b = 4.0 * n
    triple_b = 3.0 * float(logical_bytes)
    return {"dense": dense_b, "stream": dense_b,
            "columnar": triple_b, "coo": triple_b}


def container_kind_nbytes(obj) -> Dict[str, float]:
    """Per-kind physical bytes for an ACTUAL container (exact for the format
    the object is currently in, shape-derived estimates for the others) —
    what the migrator hands ``cast_route`` so every hop of a multi-hop cast
    is sized from its true intermediate format."""
    kn = kind_nbytes_from_logical(observed_nbytes(obj), observed_shape(obj))
    kind = getattr(obj, "kind", None)
    if kind in kn:
        kn[kind] = float(getattr(obj, "nbytes", kn[kind]))
    return kn


def _registered_cast_edges() -> Tuple[Tuple[str, str], ...]:
    """Edges of the executable cast graph (lazy: cast.py imports tables)."""
    from repro_torch.core.cast import _CASTS
    return tuple(sorted(_CASTS))


def _simple_paths(src: str, dst: str,
                  edges: Tuple[Tuple[str, str], ...]) -> List[List[str]]:
    """All simple paths src -> dst over the registered cast edges (the kind
    graph has four nodes, so exhaustive DFS is trivially cheap)."""
    out_edges: Dict[str, List[str]] = {}
    for a, b in edges:
        out_edges.setdefault(a, []).append(b)
    paths: List[List[str]] = []

    def dfs(node: str, path: List[str]):
        if node == dst:
            paths.append(list(path))
            return
        for nxt in out_edges.get(node, ()):
            if nxt not in path:
                path.append(nxt)
                dfs(nxt, path)
                path.pop()

    dfs(src, [src])
    return paths


_PATHS_CACHE: Dict[Tuple[str, str, Tuple], List[List[str]]] = {}


def default_calibration_path(monitor_path: Optional[str]) -> Optional[str]:
    """Calibration file that rides alongside a monitor DB path."""
    if not monitor_path:
        return None
    root, _ = os.path.splitext(monitor_path)
    return root + ".calib.json"


class CostModel:
    """Predicts op and cast seconds from calibrated/learned throughputs."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        # engine -> op -> elements/s
        self.op_rate: Dict[str, Dict[str, _Mean]] = {}
        # "src>dst" (kinds) -> bytes/s
        self.cast_rate: Dict[str, _Mean] = {}
        # measured host-pool submit->result round trip on this machine — the
        # executor's predicted-seconds auto-threading gate compares against it
        self.dispatch_overhead = _Mean()
        # per-worker-count refinement: worker count -> per-task amortized
        # overhead (the executor probes at 1/2/4 workers; the gate
        # interpolates at the level's actual count).  ``dispatch_overhead``
        # stays as the legacy single-point fallback for old calib files
        self.dispatch_table: Dict[int, _Mean] = {}
        self.calibrated = False
        # guards every rate dict: observations arrive from concurrent serves
        # and background exploration while other threads predict
        self._lock = threading.RLock()
        if path and os.path.exists(path):
            self.load(path)

    # -- prediction ----------------------------------------------------------
    def op_seconds(self, engine: str, op: str, elems: float) -> float:
        """Predicted seconds for `op` on `engine` over `elems` input elements."""
        from repro_torch.core.engines import ENGINES
        from repro_torch.core.ops import SCOPE_OP
        if op == SCOPE_OP:
            # an island boundary is the identity on its input — all of its
            # real cost is the inter-island cast, which the planner charges
            # on the boundary edge via cast_seconds (never here, or the cast
            # would be double-counted)
            return 0.0
        rate = None
        with self._lock:
            per_op = self.op_rate.get(engine)
            if per_op:
                m = per_op.get(op)
                if m and m.n:
                    rate = m.mean
                else:                   # engine-level mean over observed ops
                    obs = [x.mean for x in per_op.values() if x.n]
                    if obs:
                        rate = sum(obs) / len(obs)
        if rate is None:
            kind = ENGINES[engine].kind if engine in ENGINES else "dense"
            rate = _DEFAULT_ELEMS_PER_S.get(kind, 1e8)
        return _OP_OVERHEAD_S + max(elems, 1.0) / max(rate, 1.0)

    def dispatch_overhead_s(self, workers: Optional[int] = None) -> float:
        """Learned per-task host-pool dispatch overhead (seconds), falling
        back to a conservative default before any measurement.

        With ``workers`` and a measured per-worker-count table, linearly
        interpolates between the bracketing measured counts (flat
        extrapolation outside the measured range); without a table — or
        without ``workers`` — the legacy single-point mean is used."""
        with self._lock:
            pts = sorted((w, m.mean) for w, m in self.dispatch_table.items()
                         if m.n)
            if workers is not None and pts:
                w = int(workers)
                if w <= pts[0][0]:
                    return pts[0][1]
                if w >= pts[-1][0]:
                    return pts[-1][1]
                for (w0, s0), (w1, s1) in zip(pts, pts[1:]):
                    if w0 <= w <= w1:
                        f = (w - w0) / float(w1 - w0)
                        return s0 + f * (s1 - s0)
            if pts:                       # table only: mean over the probes
                return sum(s for _, s in pts) / len(pts)
            if self.dispatch_overhead.n:
                return self.dispatch_overhead.mean
        return _DEFAULT_DISPATCH_OVERHEAD_S

    def _edge_seconds(self, src_kind: str, dst_kind: str, nbytes: float) -> float:
        """One hop: overhead + bytes over the (observed or default) bandwidth."""
        with self._lock:
            m = self.cast_rate.get(f"{src_kind}>{dst_kind}")
            bw = m.mean if (m and m.n) else _DEFAULT_CAST_BYTES_PER_S
        return _CAST_OVERHEAD_S + max(nbytes, 1.0) / max(bw, 1.0)

    def _edge_observed(self, src_kind: str, dst_kind: str) -> bool:
        with self._lock:
            m = self.cast_rate.get(f"{src_kind}>{dst_kind}")
            return bool(m and m.n)

    def cast_route(self, src_kind: str, dst_kind: str, nbytes: float,
                   kind_nbytes: Optional[Dict[str, float]] = None
                   ) -> Tuple[float, List[str]]:
        """(predicted seconds, hop path) of the cheapest cast route.

        Candidate routes are the direct registered pair plus every multi-hop
        simple path whose edges have ALL been observed — an uncalibrated
        default bandwidth must never make a detour look cheaper than a
        measured direct conversion.  When nothing on the graph is calibrated
        the shortest registered path (defaults) is used, and an unregistered,
        unreachable pair falls back to a direct-default estimate.

        ``kind_nbytes`` (kind -> physical bytes of this payload in that
        format, see ``kind_nbytes_from_logical``) sizes EACH HOP from the
        format the data is in when the hop starts — a coo->dense hop
        densifies, so a following dense->columnar hop moves more bytes than
        the original triples did.  Without it every hop is charged the flat
        ``nbytes`` (the pre-PR-3 behavior)."""
        if src_kind == dst_kind:
            return 0.0, [src_kind]

        def hop_bytes(kind: str) -> float:
            if kind_nbytes is not None:
                return kind_nbytes.get(kind, nbytes)
            return nbytes

        def route_cost(hops) -> float:
            return sum(self._edge_seconds(a, b, hop_bytes(a))
                       for a, b in hops)

        edges = _registered_cast_edges()
        ck = (src_kind, dst_kind, edges)
        paths = _PATHS_CACHE.get(ck)
        if paths is None:
            paths = _PATHS_CACHE[ck] = _simple_paths(src_kind, dst_kind, edges)
        best: Optional[Tuple[float, List[str]]] = None
        for path in paths:
            hops = list(itertools.pairwise(path))
            if len(hops) > 1 and not all(self._edge_observed(a, b)
                                         for a, b in hops):
                continue
            cost = route_cost(hops)
            if best is None or cost < best[0]:
                best = (cost, path)
        if best is not None:
            return best
        if paths:                       # registered routes, none fully observed:
            # cheapest under whatever mix of observed/default edge rates we
            # have — a partially-observed slow edge still steers away
            costed = [(route_cost(list(itertools.pairwise(p))), p)
                      for p in paths]
            return min(costed, key=lambda t: t[0])
        return (self._edge_seconds(src_kind, dst_kind, hop_bytes(src_kind)),
                [src_kind, dst_kind])

    def cast_seconds(self, src_kind: str, dst_kind: str, nbytes: float,
                     kind_nbytes: Optional[Dict[str, float]] = None) -> float:
        """Predicted seconds to move/convert `nbytes` between data models
        (cheapest route over the cast graph, possibly multi-hop; see
        ``cast_route`` for per-hop sizing via ``kind_nbytes``)."""
        if src_kind == dst_kind:
            return 0.0
        return self.cast_route(src_kind, dst_kind, nbytes, kind_nbytes)[0]

    # -- learning ------------------------------------------------------------
    def observe_op(self, engine: str, op: str, elems: float, seconds: float):
        if seconds <= 0 or elems <= 0:
            return
        with self._lock:
            self.op_rate.setdefault(engine, {}).setdefault(op, _Mean()) \
                .update(elems / seconds)

    def observe_cast(self, src_kind: str, dst_kind: str, nbytes: float,
                     seconds: float):
        if seconds <= 0 or nbytes <= 0:
            return
        with self._lock:
            self.cast_rate.setdefault(f"{src_kind}>{dst_kind}", _Mean()) \
                .update(nbytes / seconds)

    def observe_dispatch(self, seconds: float, workers: int = 1):
        """Fold one measured per-task host-pool dispatch overhead into the
        model (see ``executor._dispatch_overhead``): the per-worker-count
        table entry for ``workers``, plus the legacy single-point mean so
        old readers keep working."""
        if seconds <= 0:
            return
        with self._lock:
            self.dispatch_table.setdefault(int(workers), _Mean()) \
                .update(seconds)
            self.dispatch_overhead.update(seconds)

    def observe_execution(self, result):
        """Fold one measured ExecutionResult (sequential run) into the model."""
        for engine, op, elems, seconds in getattr(result, "node_obs", ()):
            self.observe_op(engine, op, elems, seconds)
        for src, dst, nbytes, seconds in getattr(result, "cast_obs", ()):
            self.observe_cast(src, dst, nbytes, seconds)

    # -- calibration ---------------------------------------------------------
    def calibrate(self, n: int = 128, repeats: int = 2, *, device):
        """One-shot microbenchmark: time a representative op per engine and
        every registered cast pair on an (n, n) container on ``device``.
        Each timing ends in a device synchronize, so it measures the op and
        not its launch.  Only a pair or op that does not apply to the sample
        (a ``KeyError``/``ValueError`` from the cast or op) is skipped;
        anything else — a CUDA or kernel error — propagates."""
        import numpy as np
        import torch
        from repro_torch.core import cast as castmod
        from repro_torch.core.engines import ENGINES
        from repro_torch.core.tables import DenseTensor

        device = torch.device(device)

        def sync():
            # CPU torch ops return finished; CUDA launches return at once
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        rng = np.random.default_rng(0)
        base = DenseTensor(torch.as_tensor(
            rng.normal(size=(n, n)).astype(np.float32), device=device))
        sync()

        # cast bandwidth per registered (src, dst) pair
        homed = {"dense": base}
        for (src, dst) in list(castmod._CASTS):
            try:
                if src not in homed:
                    homed[src] = castmod.cast(base, src, device=device)
                obj = homed[src]
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    out = castmod.cast(obj, dst, device=device)
                    sync()
                    dt = time.perf_counter() - t0
                self.observe_cast(src, dst, obj.nbytes, dt)
            except (KeyError, ValueError):
                continue            # pair not reachable from a dense sample

        # per-engine op throughput: cheap scans, the binary matmul (the
        # planner's dominant op), and the layout-sensitive transforms whose
        # cross-engine cost spread is widest (haar's ORDER BY + restructure in
        # a row store vs a strided slice in the array store)
        hb = {"nbins": 8, "levels": 2}
        probe = {
            "dense_array": [("count", {}), ("distinct", {}), ("tfidf", {}),
                            ("select", {"lo": 0.0}), ("matmul", {}),
                            ("haar", {"levels": 2}), ("bin_hist", dict(hb))],
            "columnar": [("count", {}), ("distinct", {"column": "value"}),
                         ("tfidf", {}),
                         ("select", {"column": "value", "lo": 0.0}),
                         ("matmul", {}),
                         ("haar", {"levels": 2}), ("bin_hist", dict(hb))],
            "kv_sparse": [("count", {}), ("distinct", {}), ("tfidf", {})],
            "stream": [("window_agg", {"fn": "mean"}), ("to_array", {}),
                       ("haar", {"levels": 2})],
        }
        for ename, ops in probe.items():
            eng = ENGINES[ename]
            try:
                inp = homed.get(eng.kind) or castmod.cast(base, eng.kind,
                                                          device=device)
            except (KeyError, ValueError):
                continue
            for op, attrs in ops:
                if not eng.supports(op):
                    continue
                args = (inp, inp) if op == "matmul" else (inp,)
                try:
                    for _ in range(repeats):
                        t0 = time.perf_counter()
                        out = eng.run(op, attrs, *args, device=device)
                        sync()
                        dt = time.perf_counter() - t0
                    elems = sum(container_elems(a) for a in args)
                    self.observe_op(ename, op, elems, dt)
                except (KeyError, ValueError):
                    continue
        self.calibrated = True
        self.save()

    # -- persistence ---------------------------------------------------------
    def save(self, path: Optional[str] = None):
        path = path or self.path
        if not path:
            return
        with self._lock:
            blob = {
                "calibrated": self.calibrated,
                "op_rate": {e: {op: [m.mean, m.n] for op, m in ops.items()}
                            for e, ops in self.op_rate.items()},
                "cast_rate": {k: [m.mean, m.n]
                              for k, m in self.cast_rate.items()},
                "dispatch_overhead": [self.dispatch_overhead.mean,
                                      self.dispatch_overhead.n],
                "dispatch_table": {str(w): [m.mean, m.n]
                                   for w, m in self.dispatch_table.items()},
            }
        atomic_json_dump(path, blob)

    def load(self, path: str):
        blob = load_json(path)
        with self._lock:
            self.calibrated = bool(blob.get("calibrated", False))
            self.op_rate = {e: {op: _Mean(mean=m, n=cnt)
                                for op, (m, cnt) in ops.items()}
                            for e, ops in blob.get("op_rate", {}).items()}
            self.cast_rate = {k: _Mean(mean=m, n=cnt)
                              for k, (m, cnt)
                              in blob.get("cast_rate", {}).items()}
            do = blob.get("dispatch_overhead")
            if do:
                self.dispatch_overhead = _Mean(mean=float(do[0]),
                                               n=int(do[1]))
            self.dispatch_table = {int(w): _Mean(mean=float(m), n=int(cnt))
                                   for w, (m, cnt)
                                   in blob.get("dispatch_table", {}).items()}
