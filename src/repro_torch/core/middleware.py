"""BigDAWG middleware facade (paper Fig. 3): planner + monitor + executor +
migrator behind one ``execute()`` entry point with the training/production
phase protocol of §III-C-3, plus the adaptive feedback loop the paper's
monitor sketches ("collects performance data ... and uses it to improve
future plans"):

  training   — enumerate candidate plans via the cost-model DP (sized from
               measured intermediate sizes where history exists), run (up to
               ``train_plans`` of) them sequentially (per-node timings feed
               the calibrated cost model), record stats + actual sizes,
               return the best run's result, and cache the winning Plan with
               its predicted cost.
  production — serve from the signature-keyed plan cache (no re-enumeration,
               no plan-key parsing), dispatching DAG levels concurrently over
               the executor's host thread pool; on signature miss fall back
               to training; on usage drift, re-train (paper: "rerun the
               query under the training phase under the current usage") and
               queue the DP's true runner-up plans for background
               exploration.  After every run, the measured seconds are
               compared against the cached plan's predicted cost: divergence
               beyond ``replan_factor`` invalidates the entry and re-runs the
               cheap DP under the updated cost model + measured sizes and
               shapes (online re-planning, no training-phase trials needed).
  auto       — production if the signature is known, else training.

Each cache entry carries the k-best DP's runner-up plans
(``CachedPlan.alternates``).  With a non-zero ``explore_budget``, production
occasionally *explores*: after serving the winner, it schedules the next
alternate in rotation as a **background task on the executor's host pool**
— the request path never pays for it — and the task records its measured
seconds/sizes/shapes into the monitor (the paper's "the monitor must
continuously try alternate plans" loop), bounded so exploration time never
exceeds ``explore_budget`` x cumulative serve time.  An alternate that
proves faster becomes the monitor's best and is promoted on a later serve.
``drain_explorations()`` waits for in-flight trials (tests, shutdown).

**Concurrent admission.**  ``execute`` is safe to call from many request
threads at once: a per-signature lock serializes requests for the SAME
signature (two cold requests train once — the second waits, then serves the
fresh cache entry) while different signatures train and serve fully in
parallel.  The monitor and cost model take their own internal locks, the
plan cache is guarded here, the stats counters live in the lock-free
``runtime.telemetry.Metrics`` registry, and exploration runs
off-path, so the whole middleware admits multi-threaded traffic (see
``runtime.server.QueryServer.submit_many``).

**Resilient serving.**  Constructed with a ``core.health.EngineHealth``
registry, ``execute`` runs through a failover driver: every request plans
under the current circuit-breaker mask, an ``EngineDown`` mid-plan feeds the
engine's breaker and retries (first burning the breaker's failure threshold
on the incumbent path, then — breaker open, engine masked — re-running the
cheap k=1 DP around the dead engine), and masked plans are cached and
monitored under a mask-suffixed signature so the incumbent's history stays
pure and recovery (the breaker's half-open probe succeeding) restores it
verbatim.  Reports then carry ``status``/``degraded``/``failovers``.

The plan cache (winning plan + predicted cost + alternate keys) persists
beside the monitor DB (``<monitor>.plans.json``, atomic JSON via
``ioutil``), so a restarted production process serves previously-trained
signatures warm — zero plan enumerations — and keeps exploring the same
alternates.
"""
from __future__ import annotations

import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple, Union

from repro_torch.core import deltaplan, tables, tracing
from repro_torch.core.costmodel import CostModel, default_calibration_path
from repro_torch.core.engines import ENGINES
from repro_torch.core.errors import EngineDown, PlanInfeasible
from repro_torch.core.executor import ExecutionResult, execute_plan, host_pool
from repro_torch.core.health import EngineHealth
from repro_torch.core.ioutil import (atomic_json_dump, file_version, load_json,
                               load_json_versioned)
from repro_torch.core.monitor import Monitor, usage_snapshot
from repro_torch.core.ops import PolyOp
from repro_torch.core.planner import (Plan, dp_plans, estimate_sizes_shapes,
                                plan_cost, price_incremental)
from repro_torch.core.signature import signature

# separator between a signature and the engine mask it was served under:
# masked (failover/degraded) plans live in the plan cache and the monitor
# under "sig@!engine+engine", so the UNMASKED signature's history and cache
# entry stay pure — when the breaker closes again, monitor.best(sig) still
# names the incumbent and recovery restores it verbatim
MASK_SEP = "@!"


def masked_sig(sig: str, mask: FrozenSet[str]) -> str:
    return sig + MASK_SEP + "+".join(sorted(mask))


def _plan_from_key(plan_key: str) -> Plan:
    """Parse ``pos:engine|pos:engine|...``; raises ValueError on malformed or
    unknown-engine keys (callers decide whether to skip or retrain)."""
    try:
        pairs = tuple((int(u), e) for u, e in
                      (p.split(":") for p in plan_key.split("|")))
    except (ValueError, AttributeError) as exc:
        raise ValueError(f"malformed plan key {plan_key!r}") from exc
    for _, eng in pairs:
        if eng not in ENGINES:
            raise ValueError(f"plan key {plan_key!r} names unknown engine "
                             f"{eng!r}")
    if [u for u, _ in pairs] != list(range(len(pairs))):
        raise ValueError(f"plan key {plan_key!r} positions are not "
                         f"consecutive from 0")
    return Plan(pairs)


def default_plan_cache_path(monitor_path: Optional[str]) -> Optional[str]:
    """Plan-cache file that rides alongside a monitor DB path."""
    if not monitor_path:
        return None
    root, _ = os.path.splitext(monitor_path)
    return root + ".plans.json"


def default_view_cache_path(monitor_path: Optional[str]) -> Optional[str]:
    """Materialized-view file that rides alongside a monitor DB path."""
    if not monitor_path:
        return None
    root, _ = os.path.splitext(monitor_path)
    return root + ".views.json"


def default_health_path(monitor_path: Optional[str]) -> Optional[str]:
    """Breaker-state file that rides alongside a monitor DB path."""
    if not monitor_path:
        return None
    root, _ = os.path.splitext(monitor_path)
    return root + ".health.json"


# views above this physical size are served and patched in memory but not
# persisted: the JSON codec is for warm-start of SMALL hot results, not a
# second storage engine (a restarted process simply re-materializes)
VIEW_PERSIST_MAX_BYTES = 4 << 20


@dataclass
class CatalogEntry:
    name: str
    obj: Any                 # a tables.* container
    engine: str              # home engine
    # STREAM island append semantics: a streaming registration may grow by
    # appended rows (BigDAWG.append), its signature renders shape-free, and
    # warm serves may be patched incrementally from a materialized view
    streaming: bool = False
    # registration generation (bumped when register() replaces the name) —
    # a view stamped under another epoch must not be delta-patched, the
    # content may be unrelated even at identical row counts
    epoch: int = 0
    # append generation (bumped per append) — cheap change detection
    version: int = 0


@dataclass
class MaterializedView:
    """A signature's materialized result: the delivered value plus, per
    referenced table, the (epoch, version, rows, kind) stamp it was computed
    at.  A warm serve whose only drift from the stamps is appended rows on
    streaming tables may run the derived ``deltaplan.UpdatePlan`` against
    the pending suffixes and patch ``value`` in place of recomputing."""
    value: Any
    refs: Dict[str, Dict[str, Any]]
    # frozenset(changed names) -> UpdatePlan | None (None = proven
    # non-incremental for that change set; derivation runs once per set)
    update_plans: Dict[FrozenSet[str], Optional[deltaplan.UpdatePlan]] = \
        field(default_factory=dict)
    # loaded from a persisted view file: stamps carry another process's
    # epochs, so the first freshness check trusts (kind, rows) identity —
    # the procpool deployment contract, where every worker registers the
    # same tables — and then adopts this process's epochs
    restored: bool = False


@dataclass
class CachedPlan:
    """A plan-cache entry: the winning Plan plus the predicted cost it was
    cached under (the baseline the online re-planner diverges against), and
    the k-best DP's runner-up plans for budgeted exploration."""
    plan: Plan
    predicted_s: float = 0.0
    # a freshly re-planned entry is served once ahead of monitor history so
    # its measured seconds enter the history and the comparison is live
    pinned: bool = False
    # loaded from a persisted cache: the first serve re-syncs the prediction
    # to this process's runtime instead of re-planning (a cold process —
    # kernels loading, allocator warming — can legitimately be >2x slower
    # than the recording process was)
    restored: bool = False
    # the DP's true runner-up plans (training order, best first) — what the
    # budgeted exploration path executes in rotation
    alternates: Tuple[Plan, ...] = ()
    next_alt: int = 0        # rotation cursor (not persisted)
    # the fusion pass's output for this entry's plan (fuseplan.FusedPlan),
    # built lazily on the first fused serve and invalidated when the plan or
    # the query's exact structure changes.  Runtime-only, like next_alt: the
    # compiled callables live in fuseplan's process-wide cache, and a
    # restarted process re-runs the (cheap) segmentation pass
    fused: Any = None
    # the signature's materialized view (streaming/IVM serves) — validity is
    # plan-independent (query + data only), so entry replacements carry it
    view: Optional[MaterializedView] = None


@dataclass
class Report:
    result: Any
    plan_key: str
    mode: str                # "training" | "production"
    seconds: float
    cast_bytes: float
    sig: str
    plans_tried: int = 1
    drifted: bool = False
    cache_hit: bool = False  # plan came from the signature-keyed plan cache
    replanned: bool = False  # predicted/measured divergence re-ran the DP
    predicted_s: float = 0.0  # cached prediction for the executed plan
    # this serve scheduled a background alternate trial (it runs off-path on
    # the host pool; drain_explorations() waits for its measurement)
    explored: bool = False
    explored_key: str = ""   # which alternate (empty when explored is False)
    # post-order position -> measured seconds of that node in the served run
    # (position-keyed like plan keys and size feedback, so it survives query
    # rebuilds; the Session API surfaces it as Result.per_node_seconds)
    per_node_seconds: Dict[int, float] = field(default_factory=dict)
    # -- resilience surface (populated when the middleware has a health
    #    registry; defaults describe the non-resilient path) ---------------
    status: str = "ok"       # "ok" | "degraded" ("shed" is stamped by the
    #                          server on Overloaded results, never here)
    degraded: bool = False   # served under an engine mask (failover/degrade)
    failovers: int = 0       # EngineDown retries this request survived
    # scatter–gather: number of shard fragments this result was merged from
    # (0 = ordinary unsharded execution; plan_key then describes one
    # fragment's plan — fragments share a node structure with the query)
    shards: int = 0
    # position groups that executed as single compiled segments this serve
    # (empty on training serves — calibration stays unfused — and when
    # fusion is off, nothing was fusable, or every segment fell back)
    fused_segments: Tuple[Tuple[int, ...], ...] = ()
    # fused segments that failed to trace/compile/run this serve and were
    # re-executed node-by-node (sticky: later serves skip the fused attempt)
    fusion_fallbacks: int = 0
    # served by patching the materialized view with a delta fragment (or by
    # the view verbatim when nothing changed) instead of a full recompute
    incremental: bool = False
    # the request's span tree (core.tracing.Trace) when tracing was on (or a
    # propagated cross-process context forced it); the Session surfaces it
    # as Result.trace.  Inside a procpool worker this is converted to its
    # portable dict form before crossing the pipe
    trace: Any = None


def _pos_seconds(query: PolyOp, res: ExecutionResult) -> Dict[int, float]:
    """Re-key an ExecutionResult's uid-keyed per-node timings by post-order
    position (shared subtrees collapse to their one executed timing)."""
    return {pos: res.per_node_seconds.get(n.uid, 0.0)
            for pos, n in enumerate(query.nodes())}


def _metric_prop(name: str, cast=int) -> property:
    """A lifetime counter backed by the Metrics registry, exposed under the
    historical attribute name (``bd.replans`` etc.) so every existing reader
    keeps working — reads are lock-free snapshot lookups, writes go through
    the registry (one lock for ALL middleware stats instead of a private
    ``_stats_lock``)."""
    def _get(self):
        return cast(self.metrics.value(name))

    def _set(self, v):
        self.metrics.set_counter(name, float(v))
    return property(_get, _set)


class BigDAWG:
    # measured/predicted divergence factor that triggers online re-planning
    REPLAN_FACTOR = 2.0
    # max fraction of cumulative production serve seconds spendable on
    # executing alternate plans (0.0 disables exploration)
    EXPLORE_BUDGET = 0.0
    # how many DP runner-ups each cache entry keeps for exploration
    MAX_ALTERNATES = 3

    def __init__(self, monitor: Optional[Monitor] = None,
                 train_plans: int = 8, train_repeats: int = 2,
                 cost_model: Optional[CostModel] = None,
                 calibrate: bool = False,
                 plan_cache_path: Optional[str] = None,
                 replan_factor: float = REPLAN_FACTOR,
                 explore_budget: float = EXPLORE_BUDGET,
                 health: Optional[EngineHealth] = None,
                 fuse: bool = True, fusion_injector: Any = None,
                 incremental: Union[bool, str] = True,
                 trace: bool = False, metrics: Any = None,
                 metrics_path: Optional[str] = None, device=None):
        # every container the catalog homes, every op output and every
        # dense cast lives on this device; None means the CUDA card, and a
        # host without one raises instead of quietly running on the CPU
        self.device = tables.resolve_device(device)
        self.catalog: Dict[str, CatalogEntry] = {}
        # name -> shardplan.ShardInfo for tables registered with shards=N
        # (the shard parts live in the catalog as "name#i")
        self.sharded: Dict[str, "shardplan.ShardInfo"] = {}
        self.monitor = monitor or Monitor()
        # request tracing (core.tracing): trace=True makes every execute()
        # build a per-request span tree, returned on Report.trace.  Off by
        # default — the disabled tracer allocates nothing and every
        # instrumentation site is a single None check
        self.tracer = tracing.Tracer(enabled=bool(trace))
        # process-wide metrics registry (runtime.telemetry): absorbs the old
        # per-middleware stats counters behind lock-free-read properties
        # (below) and persists merge-on-save beside the monitor DB
        if metrics is None:
            from repro_torch.runtime.telemetry import (Metrics,
                                                 default_metrics_path)
            mpath = metrics_path or (default_metrics_path(self.monitor.path)
                                     if self.monitor.path else None)
            metrics = Metrics(mpath, shared=self.monitor.shared)
        self.metrics = metrics
        # optional per-engine circuit-breaker registry: when present, every
        # execute() runs through the failover driver (_execute_resilient) —
        # tripped engines are masked out of planning, EngineDown retries
        # re-plan, successes/stragglers feed the breakers
        self.health = health
        if health is not None and getattr(health, "metrics", None) is None:
            health.metrics = self.metrics    # breaker trips -> registry
        self.train_plans = train_plans
        # run each candidate plan this many times during training and record
        # only the last — first-run costs (kernel build and load, allocator
        # growth) would otherwise bias the monitor toward never-run plans
        # (cold-start bias)
        self.train_repeats = max(1, train_repeats)
        # cost model persists alongside the monitor DB when the latter has one
        self.cost_model = cost_model or CostModel(
            default_calibration_path(self.monitor.path))
        if calibrate and not self.cost_model.calibrated:
            self.cost_model.calibrate(device=self.device)
        self.replan_factor = replan_factor
        # budgeted alternate exploration (see module docstring): exploration
        # seconds may never exceed explore_budget x cumulative serve seconds.
        # The counters themselves (replans/explorations/explore_seconds/
        # serve_seconds/failovers/fusion/ivm stats) live in the metrics
        # registry, exposed under their historical names via _metric_prop
        self.explore_budget = explore_budget
        # plan-level fusion (core.fuseplan): production serves execute each
        # cached plan's same-engine fusable chains as single callables — one
        # CUDA graph replay over the hand kernels on the card.  Safe to flip
        # at runtime (the FusedPlan rides the cache entry; fuse=False simply
        # stops passing it to the executor).  fusion_injector
        # (runtime.fault.FusionFaultInjector) is the capture-failure seam
        # for the fallback fault tests
        self.fuse = fuse
        self.fusion_injector = fusion_injector
        # incremental view maintenance (core.deltaplan): warm serves whose
        # only drift is appended rows on streaming registrations run the
        # derived update fragment and patch the materialized view.  True
        # gates each serve on the cost model (incremental-vs-full); the
        # string "force" skips the gate (tests/benchmarks pinning the delta
        # path); False disables materialization and patching entirely.
        # Inert without streaming registrations, safe to flip at runtime.
        self.incremental = incremental
        # registration-epoch counter (CatalogEntry.epoch source)
        self._catalog_epoch = 0
        # signature -> CachedPlan: production requests skip re-enumeration
        # and plan-key parsing entirely; persisted beside the monitor DB so
        # restarted processes serve warm
        self.plan_cache: Dict[str, CachedPlan] = {}
        self.plan_cache_path = plan_cache_path or default_plan_cache_path(
            self.monitor.path)
        # -- concurrency state (see module docstring) -----------------------
        # per-signature serialization: same-signature requests queue (one
        # training per signature), different signatures run in parallel
        self._sig_locks: Dict[str, threading.RLock] = {}
        self._sig_locks_guard = threading.Lock()
        # guards plan_cache dict mutation + CachedPlan alternate rotation
        self._cache_lock = threading.RLock()
        # background exploration bookkeeping: at most one in-flight trial per
        # signature, futures kept so drain_explorations() can wait
        self._explore_guard = threading.Lock()
        self._explore_inflight: set = set()
        self._explore_futures: List = []
        # cross-process plan-cache sharing: stamp of the file we last
        # read/wrote (reload_plan_cache_if_changed polls it)
        self._plan_cache_version = None
        if self.plan_cache_path and os.path.exists(self.plan_cache_path):
            self.load_plan_cache(self.plan_cache_path)
        # materialized views ride beside the plan cache; breaker state
        # beside the monitor DB (satellite files of one state root)
        self.view_cache_path = default_view_cache_path(self.monitor.path)
        if self.view_cache_path and os.path.exists(self.view_cache_path):
            self.load_views(self.view_cache_path)
        self.health_path = default_health_path(self.monitor.path)
        if self.health is not None and self.health_path \
                and os.path.exists(self.health_path):
            self._restore_health(self.health_path)

    # -- lifetime stats (metrics-registry backed, historical names) ----------
    replans = _metric_prop("bd.replans")
    explorations = _metric_prop("bd.explorations")
    explore_seconds = _metric_prop("bd.explore_seconds", float)
    serve_seconds = _metric_prop("bd.serve_seconds", float)
    failovers = _metric_prop("bd.failovers")
    fused_serves = _metric_prop("bd.fused_serves")
    fusion_segments = _metric_prop("bd.fusion_segments")
    fusion_fallbacks = _metric_prop("bd.fusion_fallbacks")
    ivm_serves = _metric_prop("bd.ivm_serves")
    ivm_fallbacks = _metric_prop("bd.ivm_fallbacks")

    def _sig_lock(self, sig: str) -> threading.RLock:
        with self._sig_locks_guard:
            return self._sig_locks.setdefault(sig, threading.RLock())

    # -- catalog -----------------------------------------------------------
    def register(self, name: str, obj, engine: str,
                 shards: Optional[int] = None, streaming: bool = False):
        """Home ``obj`` on ``engine`` under ``name``.  With ``shards=N`` the
        object is ALSO split into N contiguous row-range parts registered as
        ``name#0 .. name#N-1`` (each homed/cast like any registration), and
        the shard registry records the decomposition — what
        ``shardplan.analyze`` consults to offer scatter–gather execution.

        ``streaming=True`` declares an append-able STREAM-island table:
        ``append(name, rows)`` grows it in place, its signature renders
        shape-free (appends keep plan-cache/monitor history), and warm
        serves over it may be patched incrementally from materialized
        views.  Streaming registrations must be homed on an engine whose
        native data model matches the object (a cast home would explode
        rows, breaking append row-identity) and cannot be sharded."""
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine}")
        if streaming:
            if shards is not None:
                raise ValueError("streaming registrations cannot be sharded")
            if ENGINES[engine].kind != obj.kind:
                raise ValueError(
                    f"streaming registration {name!r} must be homed "
                    f"natively: object kind {obj.kind!r} vs engine "
                    f"{engine!r} ({ENGINES[engine].kind!r}) — casts are not "
                    f"append-preserving")
            tables.leading_rows(obj)     # raises for 0-d: nothing to append
        if shards is not None:
            from repro_torch.core import shardplan
            if shards < 1:
                raise ValueError(f"shards must be >= 1, got {shards}")
            parts = tables.shard_rows(obj, shards)   # split BEFORE the home
            info = shardplan.ShardInfo(              # cast: row semantics
                shards, obj.kind, shardplan.nrows_of(obj))   # follow the src
            for i, part in enumerate(parts):
                self.register(shardplan.shard_name(name, i), part, engine)
            self.sharded[name] = info
        if ENGINES[engine].kind != obj.kind:
            from repro_torch.core import cast as castmod
            # casts leave triple formats numpy-eager (right for short-lived
            # intermediates); a catalog object is long-lived and re-consumed
            # by device ops every query, so home it on the device once here
            obj = tables.device_ready(
                castmod.cast(obj, ENGINES[engine].kind, self.cost_model,
                             device=self.device), self.device)
        elif streaming:
            # streaming tables stay HOST-resident: every append reshapes
            # them, so device residency never amortizes — and host storage
            # makes the IVM path a numpy append plus a zero-copy suffix
            # slice per serve
            obj = tables.host_copy(obj)
        else:
            obj = tables.device_ready(obj, self.device)
        self._catalog_epoch += 1
        self.catalog[name] = CatalogEntry(name, obj, engine,
                                          streaming=streaming,
                                          epoch=self._catalog_epoch)

    def append(self, name: str, rows) -> int:
        """Append ``rows`` (a container of the table's kind) to streaming
        registration ``name`` — the STREAM island's ingest path.  The table
        grows in place along its leading dimension and its version bumps;
        the signature is shape-free for streaming tables, so warm plans and
        materialized views stay valid and the next serve either patches the
        view with the pending suffix (``deltaplan``) or recomputes, per the
        cost model.  Returns the new version number."""
        entry = self.catalog.get(name)
        if entry is None:
            raise KeyError(f"no registration named {name!r}")
        if not entry.streaming:
            raise ValueError(f"{name!r} is not a streaming registration; "
                             f"register(..., streaming=True) enables "
                             f"append()")
        if getattr(rows, "kind", None) != entry.obj.kind:
            raise TypeError(f"append to {name!r} needs a "
                            f"{entry.obj.kind!r} container, got "
                            f"{type(rows).__name__}")
        rows = tables.host_copy(rows)    # host-resident, like the base
        with self._cache_lock:
            entry.obj = tables.append_rows(entry.obj, rows)
            entry.version += 1
            return entry.version

    # -- plan-cache persistence ---------------------------------------------
    def save_plan_cache(self, path: Optional[str] = None,
                        merge: Optional[bool] = None):
        """Persist the plan cache atomically.  With ``merge`` (default: the
        monitor's ``shared`` flag, so procpool workers merge automatically)
        the current file is read first and signatures this process has no
        local entry for are carried through — concurrent workers training
        DIFFERENT signatures never drop each other's entries; the same
        signature resolves last-writer-wins."""
        path = path or self.plan_cache_path
        if not path:
            return
        if merge is None:
            merge = self.monitor.shared
        with self._cache_lock:     # snapshot: concurrent trainings of other
            blob = {"format": 2,   # signatures keep mutating the dict
                    "entries": {sig: {"plan": e.plan.key,
                                      "predicted_s": e.predicted_s,
                                      "alternates": [p.key
                                                     for p in e.alternates]}
                                for sig, e in self.plan_cache.items()
                                # masked (degraded) entries are transient —
                                # tied to this process's breaker state, they
                                # must not warm-start a healthy restart
                                if MASK_SEP not in sig}}
            if merge:
                try:
                    cur = load_json(path)
                except (OSError, ValueError):
                    cur = None
                if isinstance(cur, dict):
                    for sig, ent in cur.get("entries", {}).items():
                        # a sibling that crashed mid-outage (or a hand edit)
                        # can leave masked entries in the file; adopting one
                        # would resurrect transient degraded state forever —
                        # masked signatures never survive a merge
                        if sig not in self.plan_cache and MASK_SEP not in sig:
                            blob["entries"][sig] = ent
            atomic_json_dump(path, blob)
            self._plan_cache_version = file_version(path)

    def reload_plan_cache_if_changed(self) -> bool:
        """Cross-process read path: adopt plan-cache entries other workers
        have persisted since we last read/wrote the file.  Local entries are
        never clobbered (this process's live pin/alternate state wins);
        adopted entries arrive ``restored=True`` so their first serve
        re-syncs the prediction to this process's runtime.  One ``stat``
        when nothing changed."""
        path = self.plan_cache_path
        if not path:
            return False
        with self._cache_lock:
            blob, ver = load_json_versioned(path, self._plan_cache_version)
            if blob is None:
                return False
            self._plan_cache_version = ver
            adopted = False
            for sig, ent in (blob.get("entries", {})
                             if isinstance(blob, dict) else {}).items():
                if sig in self.plan_cache or MASK_SEP in sig:
                    continue
                try:
                    alts = tuple(_plan_from_key(k)
                                 for k in ent.get("alternates", []) or [])
                    self.plan_cache[sig] = CachedPlan(
                        _plan_from_key(ent["plan"]),
                        float(ent.get("predicted_s", 0.0)),
                        restored=True, alternates=alts)
                    adopted = True
                except (ValueError, KeyError, TypeError) as exc:
                    warnings.warn(f"plan cache {path}: skipping bad shared "
                                  f"entry {sig!r}: {exc}")
            return adopted

    def reload_shared(self) -> bool:
        """Poll both shared-state files (monitor DB + plan cache) for changes
        by other processes — the procpool worker calls this before serving
        each request (two ``stat`` calls on the idle path)."""
        m = self.monitor.reload_if_changed()
        p = self.reload_plan_cache_if_changed()
        return m or p

    def load_plan_cache(self, path: str):
        """Load a persisted plan cache, skipping (with a warning) any entry a
        hand edit or corruption has mangled — bad entries, or a whole file
        that no longer parses, must not take down the warm-start path."""
        try:
            blob = load_json(path)
        except (OSError, ValueError) as exc:   # JSONDecodeError is a ValueError
            warnings.warn(f"plan cache {path}: unreadable ({exc}); "
                          f"starting cold")
            return
        self._plan_cache_version = file_version(path)
        entries = blob.get("entries", {}) if isinstance(blob, dict) else {}
        for sig, ent in entries.items():
            if MASK_SEP in sig:
                # a crashed sibling's degraded entry — masked plans are tied
                # to that process's breaker state and must never warm-start
                # a healthy one
                continue
            try:
                if not isinstance(ent, dict):
                    raise ValueError(f"entry for {sig!r} is not an object")
                plan = _plan_from_key(ent["plan"])
                alts = []
                for ak in ent.get("alternates", []) or []:
                    try:
                        alts.append(_plan_from_key(ak))
                    except ValueError as exc:   # one bad alternate must not
                        warnings.warn(           # sink the whole entry
                            f"plan cache {path}: dropping bad alternate "
                            f"for {sig!r}: {exc}")
                with self._cache_lock:
                    self.plan_cache[sig] = CachedPlan(
                        plan, float(ent.get("predicted_s", 0.0)),
                        restored=True, alternates=tuple(alts))
            except (ValueError, KeyError, TypeError) as exc:
                warnings.warn(f"plan cache {path}: skipping bad entry "
                              f"{sig!r}: {exc}")

    # -- materialized-view persistence ---------------------------------------
    def save_views(self, path: Optional[str] = None,
                   merge: Optional[bool] = None):
        """Persist materialized views atomically beside the plan cache, so a
        restarted production process patches instead of re-materializing.
        Views above ``VIEW_PERSIST_MAX_BYTES`` stay memory-only (the JSON
        codec warm-starts SMALL hot results, it is not a storage engine).
        Merge-on-save follows ``save_plan_cache``: signatures this process
        has no local view for are carried through, masked signatures never
        persist, same-signature resolves local-wins."""
        path = path or self.view_cache_path
        if not path:
            return
        if merge is None:
            merge = self.monitor.shared
        with self._cache_lock:
            entries = {}
            for sig, e in self.plan_cache.items():
                v = e.view
                if v is None or MASK_SEP in sig:
                    continue
                if getattr(v.value, "nbytes", VIEW_PERSIST_MAX_BYTES + 1) \
                        > VIEW_PERSIST_MAX_BYTES:
                    continue
                blob_v = tables.container_to_jsonable(
                    tables.host_copy(v.value))
                if blob_v is None:        # unknown container: memory-only
                    continue
                entries[sig] = {"value": blob_v, "refs": v.refs}
            blob = {"format": 1, "entries": entries}
            if merge:
                try:
                    cur = load_json(path)
                except (OSError, ValueError):
                    cur = None
                if isinstance(cur, dict):
                    for sig, ent in cur.get("entries", {}).items():
                        if sig not in entries and MASK_SEP not in sig:
                            blob["entries"][sig] = ent
            atomic_json_dump(path, blob)

    def load_views(self, path: str):
        """Load persisted materialized views, attaching each (``restored``,
        so the first freshness check trusts (kind, rows) identity and adopts
        this process's epochs) to its signature's plan-cache entry.  A view
        whose signature has no cache entry is dropped — the view rides the
        entry, and without a plan the serve retrains and re-materializes
        anyway.  Bad entries are skipped with a warning, like the plan
        cache."""
        try:
            blob = load_json(path)
        except (OSError, ValueError) as exc:
            warnings.warn(f"view cache {path}: unreadable ({exc}); "
                          f"starting cold")
            return
        entries = blob.get("entries", {}) if isinstance(blob, dict) else {}
        for sig, ent in entries.items():
            try:
                value = tables.container_from_jsonable(ent["value"])
                refs = {str(n): dict(st) for n, st in ent["refs"].items()}
                with self._cache_lock:
                    entry = self.plan_cache.get(sig)
                    if entry is not None:
                        entry.view = MaterializedView(value, refs,
                                                      restored=True)
            except (ValueError, KeyError, TypeError) as exc:
                warnings.warn(f"view cache {path}: skipping bad entry "
                              f"{sig!r}: {exc}")

    # -- breaker-state persistence -------------------------------------------
    def _save_health(self, path: Optional[str] = None):
        """Persist the circuit-breaker registry's snapshot beside the
        monitor DB, so a restarted process does not re-burn an EngineDown
        failure budget rediscovering an outage it already knew about."""
        path = path or self.health_path
        if self.health is None or not path:
            return
        atomic_json_dump(path, {"format": 1,
                                "channels": self.health.snapshot()})

    def _restore_health(self, path: str):
        """Restore persisted breaker state (warn-and-continue on damage:
        health state is an optimization, never worth failing startup over)."""
        try:
            blob = load_json(path)
        except (OSError, ValueError) as exc:
            warnings.warn(f"health state {path}: unreadable ({exc}); "
                          f"starting closed")
            return
        channels = blob.get("channels", {}) if isinstance(blob, dict) else {}
        try:
            self.health.restore(channels)
        except (ValueError, KeyError, TypeError) as exc:
            warnings.warn(f"health state {path}: not restored ({exc})")

    # -- phases --------------------------------------------------------------
    def _predict(self, query: PolyOp, plan: Plan, sig: str) -> float:
        """Current predicted seconds for a plan, under measured sizes and
        shapes."""
        sizes, shapes = estimate_sizes_shapes(
            query, self.catalog, measured=self.monitor.measured_sizes(sig),
            measured_shapes=self.monitor.measured_shapes(sig))
        return plan_cost(query, plan, self.catalog, self.cost_model,
                         sizes=sizes, shapes=shapes)

    def _train(self, query: PolyOp, sig: str,
               span: Optional[tracing.Span] = None) -> Report:
        tspan = span.child("train", sig=sig) if span is not None else None
        ranked = dp_plans(query, self.catalog, max_plans=self.train_plans,
                          cost_model=self.cost_model,
                          measured_sizes=self.monitor.measured_sizes(sig),
                          measured_shapes=self.monitor.measured_shapes(sig))
        best: Optional[ExecutionResult] = None
        usage = usage_snapshot(self.device)
        for _, plan in ranked:
            # sequential warm-up runs: kill cold-start bias AND feed
            # honest per-node timings to the cost model (sequential only)
            for _ in range(self.train_repeats):
                res = execute_plan(query, plan, self.catalog,
                                   cost_model=self.cost_model,
                                   health=self.health, device=self.device)
            self.cost_model.observe_execution(res)
            # the RECORDED measurement uses concurrent dispatch — the same
            # mode production executes in, so every seconds value a
            # Monitor.best() comparison sees is from one dispatch mode
            res = execute_plan(query, plan, self.catalog, concurrent=True,
                               cost_model=self.cost_model,
                               health=self.health, trace=tspan,
                               device=self.device)
            self.monitor.record(sig, plan.key, res.seconds,
                                cast_bytes=res.cast_bytes, usage=usage,
                                sizes=res.size_obs, shapes=res.shape_obs)
            if best is None or res.seconds < best.seconds:
                best = res
        # the cached prediction is recomputed AFTER the training observations
        # and size measurements landed — the freshest model state, the
        # baseline online re-planning diverges against.  If the model is
        # still off by more than the replan factor from the measurement we
        # JUST took, the measurement is the better baseline (caching a known-
        # bad prediction would trigger a pointless re-plan on the very next
        # production run)
        predicted = self._predict(query, best.plan, sig)
        if self._diverged(predicted, best.seconds):
            predicted = best.seconds
        # the DP's runner-ups are the TRUE alternates (ROADMAP: background
        # exploration must try these, not whatever the monitor happens to
        # have recorded) — kept with the entry for budgeted exploration
        alternates = tuple(p for _, p in ranked
                           if p.key != best.plan.key)[:self.MAX_ALTERNATES]
        with self._cache_lock:
            self.plan_cache[sig] = CachedPlan(best.plan, predicted,
                                              alternates=alternates)
        if tspan is not None:
            tspan.annotate(plans=len(ranked))
            tspan.end()
        self.cost_model.save()
        self.monitor.save()
        self.save_plan_cache()
        self._maybe_materialize(query, sig, best.value)
        return Report(best.value, best.plan.key, "training", best.seconds,
                      best.cast_bytes, sig, plans_tried=len(ranked),
                      predicted_s=predicted,
                      per_node_seconds=_pos_seconds(query, best))

    def _diverged(self, predicted: float, measured: float) -> bool:
        """The online re-planner's divergence policy: prediction and
        measurement disagree by more than ``replan_factor`` in either
        direction (non-positive values never diverge)."""
        if predicted <= 0.0 or measured <= 0.0:
            return False
        return max(measured / predicted,
                   predicted / measured) > self.replan_factor

    def _maybe_replan(self, query: PolyOp, sig: str, measured: float,
                      entry: CachedPlan) -> bool:
        """Online re-planning: >replan_factor divergence between the measured
        cost (the monitor's history-damped mean for the served plan — a
        single run's timing noise on short queries can exceed the factor by
        itself) and the cached prediction invalidates the entry and re-runs
        the cheap DP under the updated cost model + measured sizes."""
        pred = entry.predicted_s
        if measured <= 0.0:
            return False
        if entry.restored:
            # first serve after a warm restart: a cold process makes this
            # run incomparable to the recording process's baseline — re-sync
            # the prediction instead of re-planning.  A restored entry with
            # no usable baseline (predicted_s missing from the file -> 0.0)
            # must also adopt the measurement, or the loop stays dead
            entry.restored = False
            if pred <= 0.0 or self._diverged(pred, measured):
                entry.predicted_s = measured
            return False
        if pred <= 0.0 or not self._diverged(pred, measured):
            return False
        # the "cheap DP": only the new optimum is consumed, so k=1 (per-engine
        # fronts keep the top-1 exact — see dp_plans)
        ranked = dp_plans(query, self.catalog, max_plans=1,
                          cost_model=self.cost_model,
                          measured_sizes=self.monitor.measured_sizes(sig),
                          measured_shapes=self.monitor.measured_shapes(sig))
        cost, plan = ranked[0]
        if plan.key == entry.plan.key:
            # same plan still wins — the divergence is model form error, not
            # a placement mistake; adopt the measured cost as the entry's
            # prediction so a stable runtime stops re-triggering
            with self._cache_lock:
                self.plan_cache[sig] = CachedPlan(plan, measured,
                                                  alternates=entry.alternates,
                                                  view=entry.view)
        else:
            # prefer the plan's measured history (training trials measured
            # every candidate) over the raw model cost as the new baseline —
            # a model-based baseline could itself diverge and cascade
            stats = self.monitor.known_plans(sig).get(plan.key)
            pred_new = stats.mean_seconds if stats is not None and stats.n \
                else cost
            with self._cache_lock:
                self.plan_cache[sig] = CachedPlan(
                    plan, pred_new, pinned=True,
                    # the dethroned incumbent joins the alternates —
                    # exploration keeps measuring it so a wrong re-plan can
                    # be reversed
                    alternates=tuple(
                        p for p in (entry.plan,) + entry.alternates
                        if p.key != plan.key)[:self.MAX_ALTERNATES],
                    view=entry.view)
        self.metrics.counter("bd.replans")
        self.save_plan_cache()
        return True

    def _fused_for(self, query: PolyOp, plan: Plan,
                   entry: Optional[CachedPlan]):
        """The FusedPlan to serve ``plan`` with (None when fusion is off).
        Cached on the plan-cache entry and reused only when both the plan
        key and the query's EXACT structural fingerprint still match —
        signatures bin constant attrs, so two queries can share a signature
        (and this entry) yet need differently-closed-over callables."""
        if not self.fuse:
            return None
        from repro_torch.core import fuseplan
        fp = fuseplan.query_fingerprint(query)
        with self._cache_lock:
            f = entry.fused if entry is not None else None
            if f is not None and f.plan_key == plan.key \
                    and f.fingerprint == fp:
                return f
        f = fuseplan.fuse_plan(query, plan, self.catalog,
                               cost_model=self.cost_model,
                               injector=self.fusion_injector)
        with self._cache_lock:
            if entry is not None:
                entry.fused = f
        return f

    def _note_fusion(self, res: ExecutionResult) -> None:
        """Roll one serve's fusion outcome into the lifetime counters."""
        if res.fused_segments:
            self.metrics.counter("bd.fused_serves")
            self.metrics.counter("bd.fusion_segments",
                                 float(len(res.fused_segments)))
        if res.fusion_fallbacks:
            self.metrics.counter("bd.fusion_fallbacks",
                                 float(res.fusion_fallbacks))

    # -- incremental view maintenance ----------------------------------------
    def _ref_stamps(self, query: PolyOp) -> Optional[Dict[str, Dict]]:
        """Current (epoch, version, rows, kind, streaming) stamp for every
        table the query references — what a materialized view records at
        materialization time and what the freshness check compares against.
        None when a ref is unregistered (the serve will fail anyway)."""
        stamps: Dict[str, Dict] = {}
        for r in query.refs():
            e = self.catalog.get(r.name)
            if e is None:
                return None
            try:
                rows = tables.leading_rows(e.obj)
            except TypeError:        # 0-d scalar: no append axis to track
                rows = None
            stamps[r.name] = {"epoch": e.epoch, "version": e.version,
                              "rows": rows, "kind": e.obj.kind,
                              "streaming": bool(e.streaming)}
        return stamps

    def _maybe_materialize(self, query: PolyOp, sig: str, value) -> None:
        """Attach a full serve's result to the signature's cache entry as a
        materialized view (only when incremental serving is on and the query
        touches at least one streaming table — views over static tables
        would never be patched, only invalidated)."""
        if not self.incremental or MASK_SEP in sig:
            return
        stamps = self._ref_stamps(query)
        if not stamps or not any(st["streaming"] for st in stamps.values()):
            return
        with self._cache_lock:
            entry = self.plan_cache.get(sig)
            if entry is not None:
                # host-resident like the streaming tables it tracks: the
                # patch concat then runs in numpy on the host
                entry.view = MaterializedView(tables.host_copy(value),
                                              stamps)

    def _try_incremental(self, query: PolyOp, sig: str, entry: CachedPlan,
                         span: Optional[tracing.Span] = None
                         ) -> Optional[Report]:
        """Serve from the materialized view when the only drift since
        materialization is appended rows on streaming tables: derive (once
        per change set) the ``deltaplan`` update fragment, price it against
        the full recompute, execute it over the pending suffixes through the
        ordinary concurrent executor path, and patch the view.  Returns None
        — full recompute, never wrong — when the view is stale in any other
        way (re-registration, shrinkage, kind change), the lineage is not
        provably incremental, the cost model prefers recomputing, or the
        delta execution fails.  Deliberately feeds NEITHER the monitor nor
        the health stragglers: a delta serve's near-zero per-node seconds
        would corrupt the full-serve statistics both consume."""
        view = entry.view
        if view is None:
            return None
        t0 = time.perf_counter()
        stamps = self._ref_stamps(query)
        if stamps is None or set(stamps) != set(view.refs):
            entry.view = None
            return None
        changed: Dict[str, int] = {}
        for name, st in stamps.items():
            old = view.refs[name]
            if old.get("kind") != st["kind"] or \
                    (not view.restored and old.get("epoch") != st["epoch"]):
                entry.view = None     # re-registered / re-homed: the content
                return None           # may be unrelated at equal row counts
            o_rows, n_rows = old.get("rows"), st["rows"]
            if st["streaming"] and o_rows is not None \
                    and n_rows is not None and n_rows > o_rows:
                changed[name] = int(o_rows)
            elif o_rows != n_rows:
                # shrunk, or a non-streaming table grew: not append history
                entry.view = None
                return None
        if view.restored:
            # persisted by another process (or a previous life): the stamps
            # carry foreign epochs, so the check above trusted (kind, rows)
            # identity — the procpool deployment contract, every worker
            # registers the same tables.  Adopt this process's epochs so
            # later re-registrations invalidate normally
            view.restored = False
            for name, st in stamps.items():
                view.refs[name]["epoch"] = st["epoch"]
                view.refs[name]["version"] = st["version"]
        if not changed:
            # nothing drifted at all: the view IS the answer
            self.metrics.counter("bd.ivm_serves")
            return Report(view.value, entry.plan.key, "production",
                          time.perf_counter() - t0, 0.0, sig, cache_hit=True,
                          predicted_s=entry.predicted_s, incremental=True)
        if len(changed) > 1:
            # multi-table appends must align (the only derivable multi-hot
            # ops, add-family, consume their operands row-for-row): equal
            # old sizes and equal delta sizes, else recompute
            if len({changed[n] for n in changed}) > 1 or \
                    len({stamps[n]["rows"] - changed[n]
                         for n in changed}) > 1:
                self.metrics.counter("bd.ivm_fallbacks")
                return None
        key = frozenset(changed)
        if key not in view.update_plans:
            view.update_plans[key] = deltaplan.derive(
                query, set(key),
                kinds={n: st["kind"] for n, st in stamps.items()})
        up = view.update_plans[key]
        if up is None:               # proven non-incremental for this set
            self.metrics.counter("bd.ivm_fallbacks")
            return None
        # bind each pending suffix under its delta name in a temporary
        # catalog overlay — the fragment executes through the ordinary
        # planner/executor path against it
        tmp = dict(self.catalog)
        for name, old_rows in changed.items():
            src = self.catalog[name]
            dn = deltaplan.delta_name(name)
            tmp[dn] = CatalogEntry(dn, tables.suffix_rows(src.obj, old_rows),
                                   src.engine)
        # restrict the fragment's planning to the incumbent plan's engine
        # set (plus the root island's natives, for the delivery scope): the
        # delta operands are tiny, and an unconstrained DP flips to
        # cast-heavy placements the full serve never validated
        from repro_torch.core.islands import scope_candidates
        allowed = {eng for _, eng in entry.plan.assignment}
        allowed.update(scope_candidates(up.fragment.island))
        mask = frozenset(e for e in ENGINES if e not in allowed)
        try:
            price, fplan = price_incremental(
                up.fragment, tmp, cost_model=self.cost_model,
                view_bytes=float(getattr(view.value, "nbytes", 0.0)),
                full_s=entry.predicted_s or
                self._predict(query, entry.plan, sig), mask=mask)
        except Exception as exc:
            warnings.warn(f"incremental pricing for {sig!r} failed "
                          f"({exc}); recomputing")
            self.metrics.counter("bd.ivm_fallbacks")
            return None
        if self.incremental != "force" and not price.worthwhile:
            # the delta dominates (or the patch would stream more bytes than
            # recomputing costs): the gate picks the full path
            self.metrics.counter("bd.ivm_fallbacks")
            return None
        try:
            res = execute_plan(up.fragment, fplan, tmp, concurrent=True,
                               cost_model=self.cost_model,
                               health=self.health, trace=span,
                               device=self.device)
            merged = deltaplan.apply_update(up, view.value, res.value)
        except EngineDown:
            raise    # the failover driver owns breaker-feeding and retries
        except Exception as exc:
            warnings.warn(f"incremental update for {sig!r} failed ({exc}); "
                          f"dropping the view and recomputing")
            entry.view = None
            self.metrics.counter("bd.ivm_fallbacks")
            return None
        with self._cache_lock:
            view.value = merged
            view.refs = stamps
        seconds = time.perf_counter() - t0
        self.metrics.counter("bd.ivm_serves")
        self.metrics.counter("bd.serve_seconds", seconds)
        self.metrics.observe("bd.serve_latency", seconds)
        return Report(merged, entry.plan.key, "production", seconds,
                      res.cast_bytes, sig, cache_hit=True,
                      predicted_s=entry.predicted_s, incremental=True)

    def _production(self, query: PolyOp, sig: str,
                    span: Optional[tracing.Span] = None) -> Report:
        usage = usage_snapshot(self.device)
        # the "plan" span covers plan SELECTION (monitor lookup + cache
        # resolution); it is ended explicitly before any fall-through to
        # _train so training time never hides inside it
        pspan = span.child("plan", sig=sig) if span is not None else None
        plan_key, stats, drifted = self.monitor.best(sig, usage)
        if plan_key is None:
            if pspan is not None:
                pspan.end()
            return self._train(query, sig, span=span)
        if drifted:
            # usage changed too much since training — re-train now, queue the
            # DP's true runner-up plans for background exploration (not the
            # monitor's historical leftovers, which may never have been
            # planner candidates under the current sizes)
            with self._cache_lock:
                self.plan_cache.pop(sig, None)
            if pspan is not None:
                pspan.end()
            rep = self._train(query, sig, span=span)
            for alt in self.plan_cache[sig].alternates:
                self.monitor.queue_background(sig, alt.key)
            rep.drifted = True
            return rep
        with self._cache_lock:
            entry = self.plan_cache.get(sig)
            if entry is not None and entry.pinned:
                # freshly re-planned entry: serve the DP's new choice once
                # ahead of monitor history so its measured seconds enter the
                # comparison
                plan, plan_key, hit = entry.plan, entry.plan.key, True
                entry.pinned = False
            else:
                hit = entry is not None and entry.plan.key == plan_key
                if hit:
                    plan = entry.plan
                else:
                    try:
                        plan = _plan_from_key(plan_key)
                    except ValueError as exc:    # corrupted monitor history
                        warnings.warn(f"monitor best for {sig!r} unusable "
                                      f"({exc}); retraining")
                        # retrain OUTSIDE the cache lock: training runs every
                        # candidate plan — holding the global lock that long
                        # would stall every other signature's serve
                        plan = None
                    if plan is not None:
                        # measured history as the baseline (stats exist:
                        # best() just picked this plan by mean seconds) —
                        # model predictions are only baselines when no
                        # measurement is available.  An exploration win lands
                        # here: the promoted alternate keeps the old entry's
                        # alternate pool (incumbent included) so exploration
                        # continues to challenge it
                        alts = ()
                        view = None
                        if entry is not None:
                            alts = tuple(
                                p for p in (entry.plan,) + entry.alternates
                                if p.key != plan_key)[:self.MAX_ALTERNATES]
                            # view validity is plan-independent (query +
                            # data only) — a promoted alternate keeps it
                            view = entry.view
                        entry = CachedPlan(plan,
                                           stats.mean_seconds if stats.n
                                           else self._predict(query, plan,
                                                              sig),
                                           alternates=alts, view=view)
                        self.plan_cache[sig] = entry
        if plan is None:
            if pspan is not None:
                pspan.end()
            return self._train(query, sig, span=span)
        if len(plan.assignment) != len(query.nodes()):
            # a persisted entry (or hand-edited history) for a different
            # query shape under this signature: unusable, retrain
            warnings.warn(f"plan for {sig!r} covers {len(plan.assignment)} "
                          f"positions, query has {len(query.nodes())}; "
                          f"retraining")
            with self._cache_lock:
                self.plan_cache.pop(sig, None)
            if pspan is not None:
                pspan.end()
            return self._train(query, sig, span=span)
        if pspan is not None:
            pspan.annotate(plan_key=plan_key)
            pspan.end()
            span.event("cache_hit" if hit else "cache_miss",
                       plan_key=plan_key)
        if self.incremental:
            ispan = span.child("ivm_patch", sig=sig) if span is not None \
                else None
            served = False
            try:
                rep = self._try_incremental(query, sig, entry, span=ispan)
                served = rep is not None
            finally:
                if ispan is not None:
                    ispan.annotate(served=served)
                    ispan.end()
            if rep is not None:
                return rep
        res = execute_plan(query, plan, self.catalog, concurrent=True,
                           cost_model=self.cost_model, health=self.health,
                           fused=self._fused_for(query, plan, entry),
                           trace=span, device=self.device)
        self._note_fusion(res)
        if res.fusion_cold_compiles:
            # first serve of a fused segment signature at these shapes: the
            # wall time includes trace+compile, a one-off.  Treat the serve
            # as a warm-up — neither the plan's measured mean nor the
            # divergence re-plan trigger may see the compile spike (sizes/
            # shapes were already learned from the unfused training serves)
            replanned = False
        else:
            self.monitor.record(sig, plan_key, res.seconds,
                                cast_bytes=res.cast_bytes, usage=usage,
                                sizes=res.size_obs, shapes=res.shape_obs)
            after = self.monitor.known_plans(sig).get(plan_key)
            measured = after.mean_seconds if after is not None and after.n \
                else res.seconds
            replanned = self._maybe_replan(query, sig, measured, entry)
        self.metrics.counter("bd.serve_seconds", res.seconds)
        self.metrics.observe("bd.serve_latency", res.seconds)
        self._maybe_materialize(query, sig, res.value)
        explored_key = self._maybe_explore(query, sig, usage)
        return Report(res.value, plan_key, "production", res.seconds,
                      res.cast_bytes, sig, cache_hit=hit, replanned=replanned,
                      predicted_s=entry.predicted_s,
                      explored=bool(explored_key), explored_key=explored_key,
                      per_node_seconds=_pos_seconds(query, res),
                      fused_segments=res.fused_segments,
                      fusion_fallbacks=res.fusion_fallbacks)

    def _maybe_explore(self, query: PolyOp, sig: str,
                       usage: Dict[str, float]) -> str:
        """Budgeted alternate exploration (paper: the monitor "continuously"
        tries alternate plans), OFF the request path: pick the next DP
        runner-up in rotation and schedule it as a background task on the
        executor's host pool.  The serve returns immediately; the task feeds
        its measured seconds/sizes/shapes to the monitor's batched record
        queue (which the planner and cost model consume on every later
        planning pass).  Scheduling happens only while cumulative
        exploration time stays within ``explore_budget`` x cumulative serve
        time (at most one in-flight trial per signature, so the overshoot is
        bounded by one trial).  Returns the scheduled plan key, or '' when
        nothing was scheduled."""
        if self.explore_budget <= 0.0:
            return ""
        if self.metrics.value("bd.explore_seconds") > \
                self.explore_budget * self.metrics.value("bd.serve_seconds"):
            return ""
        with self._explore_guard:
            if sig in self._explore_inflight:    # one trial per sig at a time
                return ""                        # (before burning a rotation
        n_pos = len(query.nodes())               # slot on a skipped serve)
        with self._cache_lock:               # alternate rotation is shared
            entry = self.plan_cache.get(sig)
            if entry is None or not entry.alternates:
                return ""
            for _ in range(len(entry.alternates)):
                alt = entry.alternates[entry.next_alt % len(entry.alternates)]
                entry.next_alt += 1
                if len(alt.assignment) == n_pos and alt.key != entry.plan.key:
                    break
            else:
                return ""
        with self._explore_guard:
            # same-signature callers hold the signature lock, so the
            # inflight check above cannot race another scheduler for sig
            self._explore_inflight.add(sig)
            self._explore_futures = [f for f in self._explore_futures
                                     if not f.done()]
            self._explore_futures.append(host_pool().submit(
                self._explore_task, query, sig, alt, dict(usage)))
        return alt.key

    def _explore_task(self, query: PolyOp, sig: str, alt: Plan,
                      usage: Dict[str, float]) -> None:
        """One background alternate trial (runs on a host-pool worker).

        Level dispatch is concurrent-but-inline (``host_workers=1``): a pool
        worker must never submit to its own pool (a saturated pool would
        deadlock on the level barrier).  The auto gate keeps serve-path
        levels inline for sub-threshold tasks anyway, so the alternate's
        measured mean stays comparable to the incumbent's for exactly the
        levels where threading could have diverged them.  The COST MODEL is
        deliberately NOT fed here: background-mode cast hops time worker
        contention, and folding them into cast_rate would corrupt the
        calibration that training keeps sequential-only.  The model still
        benefits through the monitor channel (sizes/shapes sharpen its size
        inputs)."""
        try:
            res = execute_plan(query, alt, self.catalog, concurrent=True,
                               host_workers=1, cost_model=self.cost_model,
                               device=self.device)
            self.metrics.counter("bd.explore_seconds", res.seconds)
            self.metrics.counter("bd.explorations")
            self.monitor.record(sig, alt.key, res.seconds,
                                cast_bytes=res.cast_bytes, usage=usage,
                                sizes=res.size_obs, shapes=res.shape_obs)
        except Exception as exc:     # an alternate that fails must not take
            warnings.warn(           # down the worker or block the drain
                f"background exploration of {alt.key!r} for {sig!r} "
                f"failed: {exc}")
            # evict it from the rotation: a doomed alternate charges no
            # explore_seconds, so the budget would never stop the serve path
            # from rescheduling it on every request
            with self._cache_lock:
                entry = self.plan_cache.get(sig)
                if entry is not None:
                    entry.alternates = tuple(p for p in entry.alternates
                                             if p.key != alt.key)
        finally:
            with self._explore_guard:
                self._explore_inflight.discard(sig)

    def reset_exploration_budget(self) -> None:
        """Zero the exploration-budget accounting (``explore_seconds`` and
        ``serve_seconds``).  The budget check compares *cumulative* totals,
        so a long stretch of cheap trials banks credit that a later busy
        phase can burn in a burst; epoch-style callers (benchmarks, load
        phases) re-anchor here so every phase sees the same steady-state
        ``explore_budget`` fraction."""
        self.metrics.set_counter("bd.explore_seconds", 0.0)
        self.metrics.set_counter("bd.serve_seconds", 0.0)

    def persist(self) -> None:
        """Flush all persistent state — monitor DB, cost-model calibration
        and plan cache — to their side-by-side files, waiting for in-flight
        background explorations first so their measurements are included
        (no-ops for components constructed without a path).  The one flush
        sequence `Session.persist` and `QueryServer.persist` both call."""
        self.drain_explorations()
        self.monitor.save()
        self.cost_model.save()
        self.save_plan_cache()
        self.save_views()
        self._save_health()
        self.metrics.save()

    def drain_explorations(self, timeout: Optional[float] = None) -> int:
        """Block until all in-flight background exploration trials finish
        (their measurements are then in the monitor's pending queue).
        Returns how many finished futures were retired.  With a ``timeout``
        (per future, seconds), ``concurrent.futures.TimeoutError``
        propagates and the unfinished trials STAY tracked — a later drain
        (or ``QueryServer.persist()``) still waits for them."""
        with self._explore_guard:
            futures = list(self._explore_futures)
        try:
            for f in futures:
                f.exception(timeout=timeout)   # surface nothing, just wait
        finally:
            with self._explore_guard:          # retire only what finished;
                done = sum(1 for f in futures if f.done())
                self._explore_futures = [f for f in self._explore_futures
                                         if not f.done()]
        return done

    # -- resilient serving ---------------------------------------------------
    def _serve_masked(self, query: PolyOp, sig: str, mask: FrozenSet[str],
                      span: Optional[tracing.Span] = None) -> Report:
        """Failover/degraded serve: plan and execute with ``mask`` engines
        excluded.  The plan comes from a mask-keyed cache entry (first
        request under a given mask pays one cheap k=1 DP; the rest of the
        outage serves cached) and the measurement is recorded under the
        mask-keyed monitor signature — the unmasked signature's history
        never sees degraded runs, so when the breaker closes,
        ``monitor.best(sig)`` still names the pre-failure incumbent and the
        half-open probe restores it verbatim.  Raises ``PlanInfeasible``
        when the mask leaves some op with no engine."""
        mkey = masked_sig(sig, mask)
        with self._cache_lock:
            entry = self.plan_cache.get(mkey)
            hit = entry is not None
        if entry is None:
            ranked = dp_plans(query, self.catalog, max_plans=1,
                              cost_model=self.cost_model,
                              measured_sizes=self.monitor.measured_sizes(sig),
                              measured_shapes=self.monitor.measured_shapes(
                                  sig),
                              mask=mask)
            cost, plan = ranked[0]
            entry = CachedPlan(plan, cost)
            with self._cache_lock:
                entry = self.plan_cache.setdefault(mkey, entry)
        res = execute_plan(query, entry.plan, self.catalog, concurrent=True,
                           cost_model=self.cost_model, health=self.health,
                           fused=self._fused_for(query, entry.plan, entry),
                           trace=span, device=self.device)
        self._note_fusion(res)
        if not res.fusion_cold_compiles:   # compile spikes stay out of the
            self.monitor.record(mkey, entry.plan.key, res.seconds,
                                cast_bytes=res.cast_bytes,
                                usage=usage_snapshot(self.device),
                                sizes=res.size_obs, shapes=res.shape_obs)
        self.metrics.counter("bd.serve_seconds", res.seconds)
        self.metrics.observe("bd.serve_latency", res.seconds)
        return Report(res.value, entry.plan.key, "production", res.seconds,
                      res.cast_bytes, sig, cache_hit=hit,
                      predicted_s=entry.predicted_s,
                      per_node_seconds=_pos_seconds(query, res),
                      fused_segments=res.fused_segments,
                      fusion_fallbacks=res.fusion_fallbacks)

    def _feed_health(self, rep: Report) -> None:
        """Feed one successful serve to the health registry: the executed
        plan's per-node (engine, seconds) pairs drive the per-engine
        straggler detectors and reset/close the breakers."""
        try:
            pairs = _plan_from_key(rep.plan_key).assignment
        except ValueError:
            return
        self.health.after_plan(
            (eng, rep.per_node_seconds.get(pos, 0.0)) for pos, eng in pairs)

    def _execute_resilient(self, query: PolyOp, sig: str, mode: str,
                           degrade: bool,
                           span: Optional[tracing.Span] = None) -> Report:
        """The failover driver (requires ``self.health``): plan under the
        current breaker mask, execute, and on ``EngineDown`` retry — the
        failed attempt fed the engine's breaker, so retries first burn the
        breaker's failure threshold on the incumbent path and then (breaker
        open, engine masked) re-plan around the dead engine.  Bounded: once
        every breaker could have tripped, the last ``EngineDown`` is
        surfaced (everything is down).  ``degrade`` additionally masks every
        non-always-up engine — the server's graceful-degradation path under
        overload."""
        health = self.health
        limit = 1 + sum(br.failure_threshold
                        for br in health.breakers.values())
        failovers = 0
        while True:
            mask, probes = health.mask_for_request()
            if degrade:
                mask = frozenset(mask | health.degrade_mask())
            try:
                rep = self._serve_masked(query, sig, mask, span=span) \
                    if mask else self._dispatch(query, sig, mode, span=span)
            except EngineDown as exc:
                failovers += 1
                self.metrics.counter("bd.failovers")
                if span is not None:
                    span.event("failover", engine=exc.engine, op=exc.op)
                if failovers >= limit:
                    raise
                continue
            except PlanInfeasible:
                if degrade:
                    # the degrade mask (on top of tripped breakers) left
                    # some op with no engine — degrading was too aggressive
                    # for this query; retry with the breaker mask alone
                    degrade = False
                    continue
                raise
            finally:
                health.release_probes(probes)
            if not rep.incremental:
                # a delta serve's near-zero per-node seconds would feed the
                # straggler z-stats a stream of false outliers-in-reverse
                # and skew every engine's mean toward zero
                self._feed_health(rep)
            rep.failovers = failovers
            rep.degraded = bool(mask)
            rep.status = "degraded" if mask else "ok"
            return rep

    @property
    def breaker_trips(self) -> int:
        """Lifetime circuit-breaker trips across engines (0 without a
        health registry) — surfaced as ``QueryServer.stats["breaker_trips"]``."""
        return self.health.trips() if self.health is not None else 0

    # -- public API ----------------------------------------------------------
    def _dispatch(self, query: PolyOp, sig: str, mode: str,
                  span: Optional[tracing.Span] = None) -> Report:
        """The paper's phase protocol (caller holds the signature lock)."""
        if mode == "training":
            return self._train(query, sig, span=span)
        if mode == "production":
            return self._production(query, sig, span=span)
        if mode == "auto":
            known, _, _ = self.monitor.best(sig)
            return self._production(query, sig, span=span) if known else \
                self._train(query, sig, span=span)
        raise ValueError(mode)

    def execute(self, query: PolyOp, mode: str = "auto", *,
                degrade: bool = False,
                trace_ctx: Optional[Tuple[str, Optional[str]]] = None
                ) -> Report:
        """Thread-safe entry point.  Requests for the SAME signature are
        serialized on a per-signature lock — two cold requests racing in
        ``auto`` mode train exactly once: the loser blocks, then re-checks
        the monitor inside the lock and serves the winner's fresh plan.
        Requests for different signatures hold different locks and
        train/serve fully in parallel.

        With a health registry (``BigDAWG(health=...)``) the request runs
        through the failover driver: tripped engines are masked out of
        planning, ``EngineDown`` mid-plan retries (re-planning around the
        dead engine once its breaker opens), and the Report carries
        ``status``/``degraded``/``failovers``.  ``degrade=True`` (the
        server's overload path) plans on the always-up engine set only.

        With tracing on (``BigDAWG(trace=True)``), or when an upstream
        process propagated a ``trace_ctx`` ``(trace_id, parent_span_id)``
        across the pipe RPC, the request records a span tree returned on
        ``Report.trace`` — a root ``request`` span over plan / train /
        cast / engine_op / ivm_patch / failover children."""
        sig = signature(query, self.catalog)
        trace = self.tracer.start(trace_ctx)
        span = trace.root("request", sig=sig, mode=mode) \
            if trace is not None else None
        try:
            with self._sig_lock(sig):
                if self.health is not None:
                    rep = self._execute_resilient(query, sig, mode, degrade,
                                                  span=span)
                else:
                    rep = self._dispatch(query, sig, mode, span=span)
        finally:
            if span is not None:
                span.end()
        rep.trace = trace
        return rep

    def run_background_queue(self, query_by_sig: Dict[str, PolyOp]):
        """Re-explore queued alternate plans 'when the system is
        underutilized' (paper §III-C-3)."""
        done = 0
        while True:
            item = self.monitor.pop_background()     # atomic: two drainers
            if item is None:                         # cannot double-pop
                break
            sig, plan_key = item
            if sig not in query_by_sig:
                continue
            query = query_by_sig[sig]
            try:
                plan = _plan_from_key(plan_key)
                if len(plan.assignment) != len(query.nodes()):
                    raise ValueError(f"plan covers {len(plan.assignment)} "
                                     f"positions, query has "
                                     f"{len(query.nodes())}")
            except ValueError as exc:    # corrupted history: skip, keep
                warnings.warn(f"background queue: skipping bad plan for "
                              f"{sig!r}: {exc}")       # draining the rest
                continue
            # concurrent, like production: exploration exists to challenge the
            # incumbent's production-mode mean, so its seconds must be
            # measured under the same dispatch mode or the comparison is
            # structurally biased toward whichever plan won training
            res = execute_plan(query, plan,
                               self.catalog, concurrent=True,
                               cost_model=self.cost_model,
                               device=self.device)
            self.monitor.record(sig, plan_key, res.seconds,
                                cast_bytes=res.cast_bytes,
                                usage=usage_snapshot(self.device),
                                sizes=res.size_obs, shapes=res.shape_obs)
            done += 1
        return done
