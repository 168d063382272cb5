"""The user-facing polystore API — ``connect() -> Session``.

This is the front door the paper's client surface implies (§III: applications
speak to the middleware, which spans islands): one object that owns the
middleware stack (catalog + planner + monitor + executor + plan cache),
exposes the islands, executes queries — programmatic ``PolyOp`` trees, the
textual ``BIGDAWG(ISLAND(...))`` syntax, or a mix — and returns structured
``Result``s instead of the middleware's raw ``Report``.

    from repro_torch.core import connect, DenseTensor

    s = connect("state/monitor.json", explore_budget=0.5)   # on the card
    s.register("A", table_a, engine="columnar")
    s.register("B", table_b, engine="columnar")
    s.register("W", DenseTensor(w), engine="dense_array")

    # textual (the demo-paper surface) ...
    res = s.execute("RELATIONAL(join(A, B, left_on=key, right_on=key)) "
                    "|> ARRAY(matmul(_, W))")
    # ... or programmatic, with explicit island boundaries
    isl = s.islands
    q = isl.array.matmul(isl.array.scope(
            isl.relational.join("A", "B", left_on="key", right_on="key")),
            "W")
    res = s.execute(q)

    res.value               # the container, in the root island's data model
    res.islands             # ('relational', 'array') — every island involved
    res.provenance          # ('relational.join@columnar',
                            #  'array.scope@dense_array',
                            #  'array.matmul@dense_array')
    res.per_node_seconds    # post-order position -> measured seconds
    res.cast_bytes          # bytes the migrator moved across boundaries

    srv = s.server(max_pending=64)   # bounded-admission QueryServer

``BigDAWG.execute`` (returning the raw ``Report``) and the module-level
island objects (``repro_torch.core.array`` etc.) remain supported as the low-level
API — ``Session`` is a veneer over them, so both surfaces share one catalog,
one plan cache, and one monitor history.
"""
from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core import islands as islands_mod
from repro_torch.core import qlang
from repro_torch.core.engines import ENGINES
# the error taxonomy is part of the public API surface: sessions raise these
# (re-exported here so `from repro_torch.core.api import EngineDown` works)
from repro_torch.core.errors import (BigDAWGError, EngineDown, Overloaded,
                               PlanInfeasible, QueryParseError)
from repro_torch.core.health import EngineHealth
from repro_torch.core.middleware import BigDAWG, Report, _plan_from_key
from repro_torch.core.monitor import Monitor
from repro_torch.core.ops import PolyOp
from repro_torch.core.reqpool import RequestPool


class IslandNamespace:
    """The islands a session can scope query fragments to — handles for
    ``session.islands.relational / .array / .text / .stream`` plus
    ``.degenerate(engine)`` (full power of one engine, zero location
    transparency, paper §III-B)."""

    def __init__(self):
        self.array = islands_mod.array
        self.relational = islands_mod.relational
        self.text = islands_mod.text
        self.stream = islands_mod.stream

    @staticmethod
    def degenerate(engine: str) -> islands_mod.Island:
        isl = islands_mod.ISLANDS.get(f"degenerate:{engine}")
        if isl is None:
            raise ValueError(f"no degenerate island for engine {engine!r}; "
                             f"engines: {', '.join(sorted(ENGINES))}")
        return isl


@dataclass(frozen=True)
class Result:
    """A structured query result: the value plus full plan provenance.

    ``provenance`` names, per post-order node, the island that governed it,
    the operator, and the engine the planner placed it on —
    ``"relational.join@columnar"`` — so a cross-island query's answer says
    exactly which islands took part (``islands``) and where every seam was
    cast.  ``per_node_seconds`` is keyed by post-order position (the same
    stable key plan keys and size feedback use)."""
    value: Any
    sig: str
    mode: str                      # "training" | "production"
    seconds: float
    cast_bytes: float
    plan_key: str
    provenance: Tuple[str, ...]    # per node: "island.op@engine"
    islands: Tuple[str, ...]       # distinct islands, first-appearance order
    per_node_seconds: Dict[int, float] = field(default_factory=dict)
    report: Optional[Report] = None    # the raw middleware report
    # -- resilience surface (meaningful when the middleware has a health
    #    registry; defaults describe a healthy, unmasked serve) ------------
    status: str = "ok"             # "ok" | "degraded"  (an Overloaded slot
    #                                from submit_many carries "shed")
    degraded: bool = False         # planned under an engine mask
    failovers: int = 0             # EngineDown retries this request survived
    # position groups that executed as single compiled segments (plan-level
    # kernel fusion; empty on training serves or with fuse=False)
    fused_segments: Tuple[Tuple[int, ...], ...] = ()
    # served by patching a materialized view with a delta fragment (or by
    # the view verbatim) instead of recomputing — streaming/IVM serves
    incremental: bool = False
    # the request's completed span tree (core.tracing.Trace) when the
    # session was opened with trace=True; None otherwise.  Inspect with
    # .trace.tree() / .trace.find("engine_op") or export .trace.to_json()
    trace: Any = None

    def describe(self) -> str:
        return " -> ".join(self.provenance)


def _result_from_report(query: PolyOp, rep: Report) -> Result:
    nodes = query.nodes()
    if getattr(rep, "shards", 0):
        # scatter–gather result: plan_key describes ONE shard fragment
        # (possibly scope-wrapped, so its node positions need not align
        # with the query's) — per-node provenance is not meaningful for
        # the merged whole
        provenance: Tuple[str, ...] = ()
    else:
        amap = dict(_plan_from_key(rep.plan_key).assignment)
        provenance = tuple(f"{n.island}.{n.op}@{amap[i]}"
                           for i, n in enumerate(nodes))
    seen: Dict[str, None] = {}
    for n in nodes:
        seen.setdefault(n.island)
    return Result(value=rep.result, sig=rep.sig, mode=rep.mode,
                  seconds=rep.seconds, cast_bytes=rep.cast_bytes,
                  plan_key=rep.plan_key, provenance=provenance,
                  islands=tuple(seen), per_node_seconds=rep.per_node_seconds,
                  report=rep, status=getattr(rep, "status", "ok"),
                  degraded=getattr(rep, "degraded", False),
                  failovers=getattr(rep, "failovers", 0),
                  fused_segments=getattr(rep, "fused_segments", ()),
                  incremental=getattr(rep, "incremental", False),
                  trace=getattr(rep, "trace", None))


class Session:
    """A connection to one middleware instance (see module docstring).

    Thread-safe to the same degree as the underlying ``BigDAWG``: ``execute``
    may be called from many threads (per-signature locking trains a cold
    signature exactly once); for managed concurrent admission use
    ``server()``."""

    def __init__(self, bigdawg: BigDAWG):
        self.bigdawg = bigdawg
        self.islands = IslandNamespace()
        # the session's request pool (PR 4 pattern, shared idiom with
        # QueryServer/BatchServer): execute_async futures and map batches
        # run here, NOT on the executor's host pool — request threads block
        # on level barriers and would starve the pool running the levels
        self._requests = RequestPool(thread_name_prefix="bigdawg-session")

    @property
    def catalog(self):
        return self.bigdawg.catalog

    def register(self, name: str, obj, engine: str,
                 shards: Optional[int] = None,
                 streaming: bool = False) -> "Session":
        """Home a container on an engine under ``name`` (casting it to the
        engine's native data model if needed).  ``shards=N`` additionally
        row-range splits the table for scatter–gather execution (shard
        parts are registered as ``name#i``; on a ``processes=`` session
        part ``i`` lives only on worker ``i % processes``).
        ``streaming=True`` declares an append-able STREAM-island table:
        ``session.append(name, rows)`` grows it, and warm serves over it
        may be patched incrementally from materialized views instead of
        recomputing (see ``connect(incremental=)``).  Returns the session,
        so registrations chain."""
        self.bigdawg.register(name, obj, engine, shards=shards,
                              streaming=streaming)
        return self

    def append(self, name: str, rows) -> int:
        """Append rows to a streaming registration (the STREAM island's
        ingest path) and return the table's new version.  The next serve of
        any cached query over ``name`` either patches its materialized view
        with the appended suffix (``Result.incremental`` is then True) or
        recomputes in full, whichever the cost model prices cheaper."""
        return self.bigdawg.append(name, rows)

    def parse(self, text: str) -> PolyOp:
        """Compile the textual ``BIGDAWG(ISLAND(...))`` / ``|>`` syntax to
        the PolyOp IR without executing it (``qlang.bigdawg``)."""
        return qlang.bigdawg(text)

    def execute(self, query: Union[PolyOp, str], mode: str = "auto") -> Result:
        """Plan and run a query — a ``PolyOp`` tree or a textual qlang
        string — and return a structured ``Result``.  ``mode`` follows the
        paper's protocol: ``"training"`` enumerates and measures candidate
        plans, ``"production"`` serves from the signature-keyed plan cache,
        ``"auto"`` picks by signature history."""
        if isinstance(query, str):
            query = qlang.bigdawg(query)
        return _result_from_report(query, self.bigdawg.execute(query, mode))

    def execute_async(self, query: Union[PolyOp, str], mode: str = "auto",
                      workers: Optional[int] = None) -> "Future[Result]":
        """``execute`` off the calling thread: returns a
        ``concurrent.futures.Future`` resolving to the ``Result`` (or
        carrying the structured ``BigDAWGError`` — ``EngineDown`` after
        failover exhaustion, ``PlanInfeasible``, ... — via
        ``future.exception()``).  A textual query is parsed EAGERLY, so a
        ``QueryParseError`` raises here at the call site, not inside the
        future — a syntactically-broken query should fail fast, not
        asynchronously.  Futures run on the session's request pool
        (``workers`` grows it); the middleware's per-signature locking makes
        any interleaving safe."""
        if isinstance(query, str):
            query = qlang.bigdawg(query)
        return self._requests.submit(self.execute, query, mode,
                                     workers=workers)

    def map(self, queries: Sequence[Union[PolyOp, str]], mode: str = "auto",
            workers: Optional[int] = None) -> List[Result]:
        """Execute a batch concurrently on the request pool and return the
        ``Result``s in input order (``workers<=1`` runs sequentially).  All
        textual queries are parsed up front — one malformed query fails the
        whole batch before anything executes.  The first structured error
        raised by a query propagates, input-order first."""
        parsed = [qlang.bigdawg(q) if isinstance(q, str) else q
                  for q in queries]
        return self._requests.map_ordered(
            lambda q: self.execute(q, mode), parsed, workers=workers)

    def server(self, max_pending: Optional[int] = None,
               latency_target_s: Optional[float] = None):
        """A ``QueryServer`` over this session's middleware — concurrent
        admission (``submit_many``/``serve``) with optional bounded
        admission: with ``max_pending=N``, batch overflow beyond N in-flight
        requests is shed (``stats["shed"]``) instead of queued;
        ``latency_target_s`` switches to the adaptive AIMD bound with
        degrade-before-shed (see ``QueryServer``)."""
        from repro_torch.runtime.server import QueryServer
        return QueryServer(self.bigdawg, max_pending=max_pending,
                           latency_target_s=latency_target_s)

    def metrics(self, merged: bool = True) -> Dict[str, Any]:
        """Point-in-time snapshot of the middleware's telemetry registry:
        ``{"counters", "gauges", "histograms"}`` (histograms summarized as
        count/sum/p50/p95/p99).  With ``merged=True`` (default) and a
        ``state_path``-backed session, persisted sections from other
        processes (procpool workers, earlier lives) are folded in.  Empty
        snapshot when the backing middleware carries no registry."""
        reg = getattr(self.bigdawg, "metrics", None)
        if reg is None:
            return {"counters": {}, "gauges": {}, "histograms": {}}
        return reg.snapshot(merged=merged)

    def persist(self) -> None:
        """Flush monitor DB, calibration and plan cache (waiting for
        in-flight background explorations first) so a later ``connect`` to
        the same path starts warm."""
        self.bigdawg.persist()

    def close(self) -> None:
        """Release backend resources: a ``processes=`` session stops its
        worker pool; an in-process session is a no-op.  Sessions are also
        context managers (``with connect(processes=4) as s: ...``)."""
        closer = getattr(self.bigdawg, "close", None)
        if closer is not None:
            closer()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def connect(state_path: Optional[str] = None, *,
            monitor: Optional[Monitor] = None,
            bigdawg: Optional[BigDAWG] = None,
            resilient: bool = False,
            processes: Optional[int] = None,
            device=None,
            **bigdawg_kwargs) -> Session:
    """Open a polystore session.

    ``state_path`` — optional monitor-DB path; the calibration file and the
    plan cache ride beside it (``<root>.calib.json`` / ``<root>.plans.json``),
    so a second ``connect`` to the same path serves previously-trained
    signatures warm.  ``monitor`` passes a pre-built Monitor instead (e.g.
    with a custom ``decay``); ``bigdawg`` wraps an existing middleware
    instance as-is.  ``resilient=True`` attaches a default
    ``core.health.EngineHealth`` registry — per-engine circuit breakers with
    failover re-planning (pass ``health=EngineHealth(...)`` instead to tune
    thresholds or plug in a fault injector).  Remaining keyword arguments go
    to ``BigDAWG`` — ``train_plans``, ``explore_budget``, ``calibrate``,
    ``replan_factor``, ``health``, ``fuse`` (plan-level fusion of warm
    serves, default on: each dense_array chain runs as one CUDA graph
    replay on the card, one eager call on the CPU; ``fuse=False`` forces
    node-by-node dispatch),
    ``incremental`` (streaming IVM: ``True`` — the default — patches
    materialized views after ``append()`` when the cost model prices the
    delta path cheaper than recomputing, ``"force"`` skips the gate,
    ``False`` disables materialization entirely), ``trace`` (``trace=True``
    records a per-request span tree on every ``Result.trace`` — including
    worker-side spans on a ``processes=`` session), ``metrics_path``
    (where the telemetry registry persists; defaults to
    ``<root>.metrics.json`` beside the monitor DB)...

    ``device`` is where the catalog's containers live and every op runs:
    ``None`` (the default) means the CUDA card, and raises when there is
    none — pass ``device="cpu"`` to run on the CPU.

    ``processes=N`` backs the session with a ``core.procpool.ProcPool`` —
    N worker processes each running a full middleware stack on ``device``
    (each worker resolves it; this process never touches the card),
    sharing plans and monitor history through the ``state_path`` files,
    with sharded scatter–gather execution for ``register(..., shards=)``
    tables.  A worker that finds no card fails the first call that reaches
    it with ``EngineDown``.  Close the session (or use it as a context
    manager) to stop the workers.
    """
    if processes is not None and processes > 1:
        if bigdawg is not None or monitor is not None:
            raise ValueError("processes= builds its own per-worker "
                             "middleware; it cannot be combined with "
                             "bigdawg=/monitor=")
        from repro_torch.core.procpool import ProcPool
        return Session(ProcPool(processes=processes, state_path=state_path,
                                resilient=resilient, device=device,
                                **bigdawg_kwargs))
    if bigdawg is not None:
        if state_path or monitor or resilient or bigdawg_kwargs or \
                device is not None:
            raise ValueError("bigdawg= wraps an existing instance; it cannot "
                             "be combined with state_path/monitor/kwargs")
        return Session(bigdawg)
    if resilient and "health" not in bigdawg_kwargs:
        bigdawg_kwargs["health"] = EngineHealth()
    if monitor is None and state_path is not None:
        monitor = Monitor(state_path)
    return Session(BigDAWG(monitor=monitor, device=device, **bigdawg_kwargs))
