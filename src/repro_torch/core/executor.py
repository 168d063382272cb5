"""Executor (paper §III-C / [19]): runs a plan tree — resolves refs against
the catalog, migrates inputs to each node's engine via the migrator, invokes
the shim (engine op), and collects wall time + cast statistics for the
monitor.

Two dispatch modes:

  sequential (default) — blocks after every node, yielding honest per-node
      timings; these feed the calibrated cost model (training phase).
  concurrent — groups the DAG into topological levels and submits every node
      in a level (including its multi-hop input casts) to a shared host
      ``ThreadPoolExecutor``.  Numpy-eager engine work — columnar joins, COO
      conversions, cast hops — releases the GIL on real arrays, so host work
      genuinely overlaps across workers, on top of CUDA's asynchronous
      launches overlapping the device work.  One barrier per level (futures are
      drained before the next level starts).  Used by the production phase,
      where per-node attribution is not needed.  In auto mode
      (``host_workers=None``) a level is threaded only when at least two of
      its tasks are predicted heavy enough to overlap: with a ``cost_model``
      at hand the gate compares each task's *predicted seconds* (op seconds
      from learned throughputs + cast seconds for inputs homed on another
      data model) against ``HOST_TASK_GATE_FACTOR x`` the model's learned
      per-host thread-dispatch overhead (measured once per process as real
      submit->result round trips on the live pool, persisted with the
      calibration file); without a model it falls back to the static
      ``HOST_TASK_MIN_BYTES`` byte threshold.  Tiny launch-bound levels stay
      inline, where single-threaded async dispatch is already optimal;
      ``host_workers<=1`` falls back to inline single-threaded level
      dispatch (the pre-PR-3 behavior), and a single-node level always runs
      inline (no pool round-trip).

Both modes report each node's *actual* logical output size (``size_obs``)
and dense-equivalent output shape (``shape_obs``), keyed by post-order
position, so the monitor can feed real intermediate sizes AND shapes back
into the planner's estimates — the other half of the §III-C feedback loop
(a measured select size overrides the bytes rule; a measured shape feeds
downstream matmul output estimates).  When a ``cost_model`` is supplied, the
migrator routes casts along the model's cheapest (possibly multi-hop) path,
each hop sized from its intermediate format, instead of always taking the
direct pair.

The host pool is process-wide and lazily built (``host_pool``): plans are
short-lived but frequent on the serving path, and thread churn per plan
would dominate the win.  ``execute_plan`` is safe to call from many request
threads at once — each call keeps its own value/timing dicts, the shared
Migrator accounting is lock-guarded, and pool workers never submit to the
pool themselves.  Do not call ``execute_plan(concurrent=True)`` with
``host_workers>1`` from *inside* a pool worker — a saturated pool could
deadlock on the level barrier; background tasks that must execute a plan
from a worker (the middleware's off-path exploration) pass
``host_workers=1`` so their level dispatch stays inline.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import tables
from repro_torch.core.costmodel import (CostModel, container_elems, observed_nbytes,
                                  observed_shape)
from repro_torch.core.engines import ENGINES
from repro_torch.core.errors import EngineDown, is_engine_failure
from repro_torch.core.islands import ISLAND_KIND, island_kind
from repro_torch.core.migrator import Migrator
from repro_torch.core.ops import SCOPE_OP, PolyOp, Ref
from repro_torch.core.planner import Plan

# (ISLAND_KIND — the data model a query's result is delivered in, i.e. its
# root island's model — is re-exported from islands.py, its canonical home
# since island boundaries became first-class IR nodes)

# default size of the shared host pool; override per call via host_workers=
# or process-wide via REPRO_HOST_WORKERS
DEFAULT_HOST_WORKERS = min(8, os.cpu_count() or 1)

# auto-mode FALLBACK gate (no cost model): threads a level only when at
# least two of its nodes each move this many input bytes.  Small-payload
# levels are launch-bound, and multi-threaded dispatch of many tiny
# ops pays lock contention for zero overlap (measured ~0.6x on
# fig_host_parallel's pipeline family).  An explicit host_workers forces
# threading regardless.  With a cost model, the predicted-seconds gate below
# replaces this static threshold.
HOST_TASK_MIN_BYTES = 1e6

# predicted-seconds gate: a task is worth a pool round trip only when its
# predicted seconds dwarf the measured dispatch overhead by this factor
HOST_TASK_GATE_FACTOR = 4.0

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_SIZE = 0
_POOL_LOCK = threading.Lock()

# one measurement of the pool round-trip cost per worker count per process
# (see _dispatch_overhead); cached so later cost models inherit it without
# re-measuring on the serve path
DISPATCH_PROBE_WORKERS = (1, 2, 4)
_DISPATCH_MEASURED: Dict[int, float] = {}
_DISPATCH_LOCK = threading.Lock()


def host_pool(max_workers: Optional[int] = None) -> ThreadPoolExecutor:
    """The process-wide host-task pool for concurrent dispatch (lazily
    created; rebuilt only if a larger size is requested)."""
    global _POOL, _POOL_SIZE
    want = max_workers or int(os.environ.get("REPRO_HOST_WORKERS", 0)) \
        or DEFAULT_HOST_WORKERS
    with _POOL_LOCK:
        if _POOL is None or _POOL_SIZE < want:
            # a superseded pool is NOT shut down: another plan may still
            # hold a reference and submit to it (shutdown would raise
            # RuntimeError mid-plan).  Its idle threads simply park until
            # process exit; pool growth happens at most a handful of times.
            _POOL = ThreadPoolExecutor(max_workers=want,
                                       thread_name_prefix="bigdawg-host")
            _POOL_SIZE = want
        return _POOL


@dataclass
class ExecutionResult:
    value: Any
    seconds: float
    cast_bytes: float
    n_casts: int
    plan: Plan
    per_node_seconds: Dict[int, float] = field(default_factory=dict)
    # measured (engine, op, input_elems, seconds) per node — sequential only
    node_obs: List[Tuple[str, str, float, float]] = field(default_factory=list)
    # measured (src_kind, dst_kind, bytes, seconds) per cast
    cast_obs: List[Tuple[str, str, float, float]] = field(default_factory=list)
    levels: int = 0                     # topological depth actually dispatched
    # post-order position -> measured logical output bytes (both modes) —
    # the monitor stores these per signature for size-estimate feedback
    size_obs: Dict[int, float] = field(default_factory=dict)
    # post-order position -> measured dense-equivalent output shape (both
    # modes, where the format carries one) — shape feedback for downstream
    # matmul/transpose output estimates
    shape_obs: Dict[int, Tuple[int, ...]] = field(default_factory=dict)
    # position groups that executed as single fused segments this run
    # (empty when fusion was off, nothing was fusable, or every segment
    # fell back)
    fused_segments: Tuple[Tuple[int, ...], ...] = ()
    # fused segments that failed to capture/run THIS run and were
    # re-executed node-by-node (each also marks its key sticky-broken)
    fusion_fallbacks: int = 0
    # fused segments that paid their warm-up and CUDA graph capture THIS
    # run (first serve of a segment signature at these shapes) — the
    # middleware keeps such a serve's wall time out of the plan's measured
    # mean so a one-off capture spike can never trigger a divergence re-plan
    fusion_cold_compiles: int = 0


def _block(x):
    """Wait for the device work that produced a container (honest timing):
    CUDA launches return before the kernel runs, so a timing without this
    synchronize would measure the launch, not the op."""
    for leaf in tables.leaves(x):
        if tables.is_tensor(leaf) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            break
    return x


def topo_levels(query: PolyOp) -> List[List[PolyOp]]:
    """Nodes grouped by topological depth; everything within a level is
    mutually independent and can be dispatched together."""
    depth: Dict[int, int] = {}
    levels: List[List[PolyOp]] = []
    for node in query.nodes():              # post-order: inputs first
        if node.uid in depth:               # shared subtree: already placed
            continue
        d = 0
        for inp in node.inputs:
            if isinstance(inp, PolyOp):
                d = max(d, depth[inp.uid] + 1)
        depth[node.uid] = d
        while len(levels) <= d:
            levels.append([])
        levels[d].append(node)
    return levels


def _node_input_nbytes(node: PolyOp, catalog, values) -> float:
    """Physical bytes this node's inputs occupy right now — the cheap proxy
    the FALLBACK auto-threading gate uses when no cost model is at hand."""
    total = 0.0
    for inp in node.inputs:
        if isinstance(inp, Ref):
            if catalog is not None and inp.name in catalog:
                total += float(getattr(catalog[inp.name].obj, "nbytes", 0.0))
        else:
            total += float(getattr(values.get(inp.uid), "nbytes", 0.0) or 0.0)
    return total


def _dispatch_overhead(cost_model, workers: Optional[int] = None,
                       reps: int = 5) -> float:
    """The learned per-host thread-dispatch overhead, in seconds, for a
    level dispatched over ``workers`` pool threads.

    Measured once per process at each of ``DISPATCH_PROBE_WORKERS`` (1/2/4
    host workers): the median over ``reps`` rounds of (submit ``w`` no-op
    tasks, await all, divide by ``w``) — per-task amortized overhead, which
    FALLS with worker count as submissions overlap result waits.  The table
    is folded into the cost model (``observe_dispatch(s, workers=w)``) so
    it persists beside the calibration and later processes start from real
    numbers; the auto-threading gate then interpolates at the level's
    actual worker count instead of assuming the single-point cost.  A model
    that already carries measurements (restored from disk) is trusted
    without re-measuring.

    The round trips run on PRIVATE probe pools, not the live host pool:
    the quantity of interest is pure submit->result overhead, and on the
    shared pool a queued background exploration trial would be timed as
    'overhead', poisoning the persisted value (seconds-scale floor => the
    gate never threads again)."""
    if cost_model.dispatch_overhead.n or cost_model.dispatch_table:
        return cost_model.dispatch_overhead_s(workers)
    with _DISPATCH_LOCK:
        if not _DISPATCH_MEASURED:
            for w in DISPATCH_PROBE_WORKERS:
                with ThreadPoolExecutor(max_workers=w) as probe:
                    # concurrent sleeps force all w threads to spin up
                    # before the timed rounds
                    for f in [probe.submit(time.sleep, 0.001)
                              for _ in range(w)]:
                        f.result()
                    samples = []
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        futs = [probe.submit(lambda: None)
                                for _ in range(w)]
                        for f in futs:
                            f.result()
                        samples.append((time.perf_counter() - t0) / w)
                samples.sort()
                _DISPATCH_MEASURED[w] = samples[len(samples) // 2]
    for w, s in _DISPATCH_MEASURED.items():
        cost_model.observe_dispatch(s, workers=w)
    return cost_model.dispatch_overhead_s(workers)


def _task_pred_seconds(node: PolyOp, engine_name: str, catalog, values,
                       cost_model) -> float:
    """Predicted seconds of one host task (engine op + any input casts onto
    the op's data model) — what the auto-threading gate weighs against the
    dispatch overhead.  Sized from the inputs' CURRENT containers, so the
    estimate sharpens level by level as real intermediates materialize."""
    eng = ENGINES[engine_name]
    elems = 0.0
    secs = 0.0
    for inp in node.inputs:
        if isinstance(inp, Ref):
            obj = catalog[inp.name].obj if (catalog is not None
                                            and inp.name in catalog) else None
        else:
            obj = values.get(inp.uid)
        if obj is None:
            continue
        elems += container_elems(obj)
        kind = getattr(obj, "kind", eng.kind)
        if kind != eng.kind:
            # flat nbytes (no per-hop kind sizing): the gate must stay cheap
            # — container_kind_nbytes scans columnar validity masks
            secs += cost_model.cast_seconds(kind, eng.kind,
                                            float(getattr(obj, "nbytes", 0.0)))
    return secs + cost_model.op_seconds(engine_name, node.op, elems)


def _gather_args(node: PolyOp, eng, catalog, values, migrator):
    args = []
    for inp in node.inputs:
        if isinstance(inp, Ref):
            obj = catalog[inp.name].obj
        else:
            obj = values[inp.uid]
        args.append(migrator.to_engine(obj, eng.name))
    return args


def _deliver(query: PolyOp, result, device):
    """Deliver in the root island's data model (location transparency: the
    caller sees the island model regardless of which engine produced it).

    A 0-d dense result — an aggregate scalar (``count``) — is delivered
    as-is on every island: a scalar has no data-model home, and every
    engine's aggregate already emits the same shape, so the scatter–gather
    ``sum`` merge sees one uniform container regardless of root island."""
    if getattr(result, "kind", None) == "dense" \
            and getattr(result.data, "ndim", None) == 0:
        return result
    want = island_kind(query.island)
    if getattr(result, "kind", want) != want:
        from repro_torch.core import cast as castmod
        result = castmod.cast(result, want, device=device)
        _block(result)
    return result


def execute_plan(query: PolyOp, plan: Plan, catalog,
                 concurrent: bool = False,
                 cost_model: Optional[CostModel] = None,
                 host_workers: Optional[int] = None,
                 health=None, fused=None, trace=None, *,
                 device) -> ExecutionResult:
    """``health`` (a ``core.health.EngineHealth``) opts the run into the
    resilience path: the registry's ``before_op`` hook fires ahead of every
    engine op (the fault-injection seam), and any *engine* failure — an
    exception ``errors.is_engine_failure`` classifies as infrastructure, in
    the op itself or in an input cast onto the op's engine — feeds the
    engine's circuit breaker and re-raises as ``EngineDown`` so the
    middleware can fail over.  Query errors (bad column names, shape
    mismatches) propagate unchanged: they would fail identically on every
    engine, so retrying them elsewhere is never correct.

    ``fused`` (a ``core.fuseplan.FusedPlan`` for this plan) opts concurrent
    dispatch into fused execution: each segment runs as ONE host task — the
    migrator casts its external inputs onto the segment engine (cast-in),
    one callable evaluates the whole chain with intermediates on device (a
    CUDA graph replay on the card), and the segment's measured seconds are
    attributed back to member nodes pro-rata by predicted cost
    (``per_node_seconds`` keeps its meaning for the monitor, drift
    re-planning and the straggler detectors).  ``health.before_op`` still
    fires per member op, so fault-injection and breakers see fused serves
    exactly like unfused ones.  Any fused-call failure falls back to
    node-by-node execution of the members inside the same task (sticky per
    segment signature — see ``fuseplan.mark_broken``), so fusion can never
    turn a servable query into an error.  Sequential (training) mode
    ignores ``fused``: per-node calibration timings must stay pure.

    ``device`` is the session's device: every engine op and every cast
    that builds a dense tensor puts its output there.

    ``trace`` (a ``core.tracing.Span``, or None) attaches already-measured
    ``engine_op`` / ``fused_segment`` / ``cast`` child spans under the
    caller's span — no extra clock reads beyond the timings this function
    takes anyway, and zero work when None."""
    amap = plan.engine_map(query)
    migrator = Migrator(cost_model=cost_model, trace=trace, device=device)
    values: Dict[int, Any] = {}
    per_node: Dict[int, float] = {}
    node_obs: List[Tuple[str, str, float, float]] = []
    size_obs: Dict[int, float] = {}
    shape_obs: Dict[int, Tuple[int, ...]] = {}
    t0 = time.perf_counter()
    n_levels = 0

    def run_node(node: PolyOp):
        """One host task: migrate inputs (possibly multi-hop casts) and run
        the engine op — the numpy-eager parts release the GIL, so tasks of
        one level overlap on the pool.  Deliberately does NOT block on the
        result: CUDA-backed ops stay async (dispatch returns immediately;
        blocking here would serialize the device pipeline behind each
        worker), and the level boundary blocks everything once.

        An island-boundary (scope) node IS its input migration: the cast
        onto the boundary engine's data model happens in ``_gather_args``
        (migrator-routed, byte-accounted), and the node itself is the
        identity."""
        eng = ENGINES[amap[node.uid]]
        tn = time.perf_counter()
        try:
            if health is not None:
                health.before_op(eng.name, node.op)
            args = _gather_args(node, eng, catalog, values, migrator)
            out = args[0] if node.op == SCOPE_OP \
                else eng.run(node.op, node.attrs, *args, device=device)
        except Exception as exc:
            _engine_fail(exc, eng.name, node.op)
            raise
        dt = time.perf_counter() - tn
        per_node[node.uid] = dt
        if trace is not None:
            trace.static_child("engine_op", dt, op=node.op, engine=eng.name)
        return node.uid, out

    def _engine_fail(exc: BaseException, engine: str, op: str):
        """Failure attribution: infrastructure-shaped exceptions feed the
        breaker and become EngineDown; anything else falls through to the
        caller's bare re-raise (a query error, not an engine one)."""
        if health is not None and is_engine_failure(exc):
            health.record_failure(engine)
            raise EngineDown(engine, op, exc) from exc

    fused_ran: List[Tuple[int, ...]] = []
    fallbacks = [0]
    cold_compiles = [0]

    if concurrent and fused is not None and getattr(fused, "segments", ()):
        from repro_torch.core import fuseplan
        nodes = query.nodes()
        node_at = {pos: n for pos, n in enumerate(nodes)}
        uid_at = {pos: n.uid for pos, n in enumerate(nodes)}

        def run_segment(seg):
            """One host task for a whole fused segment: cast-in the external
            inputs, run the segment (one CUDA graph replay on the card;
            intermediates stay on device), attribute the measured seconds
            pro-rata.  A broken (or
            just-failed) segment executes its members node-by-node inside
            the SAME task — identical results, one sticky mark per key."""
            eng = ENGINES[seg.engine]
            tn = time.perf_counter()
            try:
                if health is not None:
                    for op in seg.ops:       # breakers/injectors see every
                        health.before_op(eng.name, op)   # member op
                out = None
                if not fuseplan.is_broken(seg.key):
                    try:
                        if fused.injector is not None:
                            fused.injector.on_fuse(seg.key)
                        ext_objs = [
                            migrator.to_engine(
                                catalog[src].obj if kind == "ref"
                                else values[uid_at[src]], eng.name)
                            for kind, src in seg.ext_sources]
                        out, was_cold = fuseplan.run_fused_segment(
                            seg, ext_objs, device)
                        fused_ran.append(seg.positions)
                        if was_cold:
                            cold_compiles[0] += 1
                    except Exception as exc:
                        # capture/replay failure: never an error for the
                        # caller — mark sticky, count, re-run unfused below
                        fuseplan.mark_broken(seg.key, repr(exc))
                        fallbacks[0] += 1
                        out = None
                if out is None:
                    out = _segment_unfused(seg, eng)
            except Exception as exc:
                _engine_fail(exc, eng.name, seg.ops[-1])
                raise
            dt = time.perf_counter() - tn
            for p, w in zip(seg.positions, seg.weights):
                per_node[uid_at[p]] = dt * w
            if trace is not None:
                # one fused_segment span, with per-member engine_op children
                # carrying the same pro-rata attribution per_node got
                sid = trace.static_child("fused_segment", dt,
                                         engine=seg.engine,
                                         positions=list(seg.positions))
                for p, w in zip(seg.positions, seg.weights):
                    trace.trace.static("engine_op", sid, dt * w,
                                       op=node_at[p].op, engine=seg.engine)
            return uid_at[seg.root_pos], out

        def _segment_unfused(seg, eng):
            """Node-by-node fallback, inline in the segment's task.  Member
            intermediates land in ``values`` so size/shape feedback is as
            complete as an unfused serve's."""
            out = None
            for p in seg.positions:
                node = node_at[p]
                args = _gather_args(node, eng, catalog, values, migrator)
                out = eng.run(node.op, node.attrs, *args, device=device)
                values[node.uid] = out
            return out

        # collapse the DAG to units (fused segments + leftover plain nodes)
        # level them by longest path, like topo_levels over the unit graph.
        # Post-order guarantees a unit's depth is final before any outside
        # consumer reads it (a segment's members all precede its consumer).
        seg_at: Dict[int, int] = {}      # position -> segment index
        for si, seg in enumerate(fused.segments):
            for p in seg.positions:
                seg_at[p] = si

        def unit_of(pos: int):
            si = seg_at.get(pos)
            return ("s", si) if si is not None else ("n", pos)

        pos_of = {n.uid: p for p, n in enumerate(nodes)}
        depth: Dict[Tuple[str, int], int] = {}
        for pos, node in enumerate(nodes):
            u = unit_of(pos)
            d = depth.get(u, 0)
            for inp in node.inputs:
                if isinstance(inp, PolyOp):
                    iu = unit_of(pos_of[inp.uid])
                    if iu != u:
                        d = max(d, depth[iu] + 1)
            depth[u] = d
        unit_levels: List[List[Tuple[str, int]]] = []
        for u, d in depth.items():
            while len(unit_levels) <= d:
                unit_levels.append([])
            unit_levels[d].append(u)
        n_levels = len(unit_levels)

        def run_unit(u):
            kind, x = u
            return run_segment(fused.segments[x]) if kind == "s" \
                else run_node(node_at[x])

        workers = host_workers if host_workers is not None else \
            int(os.environ.get("REPRO_HOST_WORKERS", 0)) or \
            DEFAULT_HOST_WORKERS
        pool = host_pool(workers) if workers > 1 else None
        for level in unit_levels:
            outs = []
            use_pool = pool is not None and len(level) > 1
            if use_pool and host_workers is None and cost_model is not None:
                # same predicted-seconds gate as the unfused path; a
                # segment's task prediction sums its members'
                floor_s = HOST_TASK_GATE_FACTOR * _dispatch_overhead(
                    cost_model, workers)

                def _unit_pred(u):
                    kind, x = u
                    ps = [x] if kind == "n" else \
                        list(fused.segments[x].positions)
                    return sum(_task_pred_seconds(
                        node_at[p], amap[uid_at[p]], catalog, values,
                        cost_model) for p in ps)
                use_pool = sum(1 for u in level
                               if _unit_pred(u) >= floor_s) >= 2
            if not use_pool:
                for u in level:
                    uid, out = run_unit(u)
                    values[uid] = out
                    outs.append(out)
            else:
                futs = [pool.submit(run_unit, u) for u in level]
                for fut in futs:
                    uid, out = fut.result()
                    values[uid] = out
                    outs.append(out)
            for out in outs:
                _block(out)
    elif concurrent:
        lvls = topo_levels(query)
        n_levels = len(lvls)
        workers = host_workers if host_workers is not None else \
            int(os.environ.get("REPRO_HOST_WORKERS", 0)) or \
            DEFAULT_HOST_WORKERS
        pool = host_pool(workers) if workers > 1 else None
        for level in lvls:
            outs = []
            use_pool = pool is not None and len(level) > 1
            if use_pool and host_workers is None:
                # auto mode: thread only when >= 2 tasks are heavy enough to
                # overlap.  With a cost model: predicted task seconds vs the
                # learned dispatch overhead; without: the static byte gate.
                if cost_model is not None:
                    floor_s = HOST_TASK_GATE_FACTOR * \
                        _dispatch_overhead(cost_model, workers)
                    heavy = sum(1 for n in level
                                if _task_pred_seconds(n, amap[n.uid], catalog,
                                                      values, cost_model)
                                >= floor_s)
                else:
                    heavy = sum(1 for n in level
                                if _node_input_nbytes(n, catalog, values)
                                >= HOST_TASK_MIN_BYTES)
                use_pool = heavy >= 2
            if not use_pool:
                for node in level:           # inline fallback / trivial level
                    uid, out = run_node(node)
                    values[uid] = out
                    outs.append(out)
            else:
                # one future per node; .result() re-raises the first worker
                # exception in submission order — a failing node fails the
                # plan, it does not vanish into the pool
                futs = [pool.submit(run_node, node) for node in level]
                for fut in futs:
                    uid, out = fut.result()
                    values[uid] = out
                    outs.append(out)
            for out in outs:                 # one block per level boundary
                _block(out)
    else:
        for node in query.nodes():          # post-order
            eng = ENGINES[amap[node.uid]]
            # per_node covers migration + op (same meaning as concurrent
            # mode's run_node timing); node_obs — what calibrates op rates —
            # starts after the gather, so learned throughputs stay pure op
            tg = time.perf_counter()
            try:
                if health is not None:
                    health.before_op(eng.name, node.op)
                args = _gather_args(node, eng, catalog, values, migrator)
                elems = sum(container_elems(a) for a in args)
                tn = time.perf_counter()
                if node.op == SCOPE_OP:
                    # island boundary: the migration above WAS the work
                    # (timed per hop by the migrator); the node is the
                    # identity, so no op observation — a ~0s "scope" rate
                    # would poison the engine-level mean the cost model
                    # falls back to
                    out = args[0]
                else:
                    out = eng.run(node.op, node.attrs, *args, device=device)
                    _block(out)
                    node_obs.append((eng.name, node.op, elems,
                                     time.perf_counter() - tn))
            except Exception as exc:
                _engine_fail(exc, eng.name, node.op)
                raise
            dt = time.perf_counter() - tg
            per_node[node.uid] = dt
            if trace is not None:
                trace.static_child("engine_op", dt, op=node.op,
                                   engine=eng.name)
            values[node.uid] = out

    result = _deliver(query, values[query.uid], device)
    total = time.perf_counter() - t0
    # size/shape measurement happens OUTSIDE the timed window: observed_nbytes
    # can touch host memory (columnar validity sum) and must not inflate the
    # seconds the monitor records and the replan comparison consumes
    for pos, node in enumerate(query.nodes()):
        obj = values.get(node.uid)
        if obj is None:
            # fused-segment interior: stayed on device inside the segment,
            # so there is nothing to measure (the monitor keeps whatever it
            # learned from unfused serves of this signature)
            continue
        size_obs[pos] = observed_nbytes(obj)
        shp = observed_shape(obj)
        if shp is not None:
            shape_obs[pos] = shp
    return ExecutionResult(result, total, migrator.bytes_moved,
                           migrator.n_casts, plan, per_node, node_obs,
                           list(migrator.events), n_levels, size_obs,
                           shape_obs, tuple(fused_ran), fallbacks[0],
                           cold_compiles[0])


def merge_shard_results(merge: str, parts, by: Optional[str] = None):
    """Gather step of partitioned (scatter–gather) execution: reassemble the
    per-shard fragment results the workers returned.  Returns ``(container,
    merge_seconds)``.

    Deliberately numpy-only (the ``tables`` merge primitives): the gather
    runs on the host and never touches a device.  ``merge`` is one of
    ``"concat"`` (row-wise ops), ``"sum"`` (decomposable aggregates), or
    ``"kmerge"`` (k-way ordered merge on sort column ``by``); see
    ``core.shardplan`` for which ops map to which."""
    from repro_torch.core import tables
    t0 = time.perf_counter()
    if merge == "concat":
        out = tables.concat_shards(parts)
    elif merge == "sum":
        out = tables.sum_shards(parts)
    elif merge == "kmerge":
        out = tables.kmerge_shards(parts, by)
    else:
        raise ValueError(f"unknown merge kind {merge!r}")
    return out, time.perf_counter() - t0
