"""Multi-process serving: a master/worker pool that breaks the GIL ceiling.

BigDAWG's middleware is itself a *process* architecture — each engine is an
independent server process and the middleware "dispatches query fragments to
[them] and reassembles results".  The in-process serving stack gets real
concurrency only where engine ops release the GIL; every pure-Python
planning or merge step still serializes request threads, and same-signature
requests queue on the middleware's signature lock.  ``ProcPool`` is the
process-level answer: a master that owns NO engine state fans requests out
to N worker processes, each a full ``BigDAWG`` middleware stack with its own
CUDA context, kernel libraries and CUDA graphs on the card.

Design points:

* **spawn, not fork.**  CUDA is not fork-safe; every worker is a fresh
  interpreter that builds its own middleware from a picklable spec.  The
  spec carries the device as a string (``None`` means the card, as in
  every entry point) and each worker resolves it itself.  The master never
  initializes CUDA at all: it keeps numpy containers only, merges with the
  numpy helpers (``tables.concat_shards``/``sum_shards``/``kmerge_shards``),
  prices scatter with a ``CostModel`` loaded from its file (no
  calibration), and never resolves a device.  A worker that cannot start
  (no card, say) answers its first request with the reason and exits; the
  master then treats it as dead — there is no CPU fallback in a worker.
* **pickle-framed pipe RPC.**  One duplex ``multiprocessing.Pipe`` per
  worker; messages are ``(kind, rid, *payload)`` tuples and replies are
  ``("ok"|"err"|"down", rid, payload)``.  Replies are matched on ``rid`` —
  a stale reply from a timed-out predecessor request is discarded, never
  mis-delivered.  Per-worker locks serialize each pipe; different workers
  serve concurrently, so ``QueryServer.submit_many`` admission fans across
  processes.  Nothing that crosses a pipe carries a ``torch.Tensor``:
  results are ``tables.host_copy``'d in the worker.
* **shared persistence, not shared memory.**  Workers converge through the
  monitor DB / plan-cache files: every worker opens the monitor with
  ``shared=True`` (merge-on-save: last-writer-wins *per signature*, no
  dropped entries) and polls ``reload_shared()`` before each request (one
  ``stat`` when nothing changed), so a signature trained by worker 0 is
  served warm by worker 1 without any master-side plan state.
* **worker death is an engine failure one level up.**  The master tracks
  workers through the same ``EngineHealth`` breaker registry engines use,
  on channels ``worker:<i>``.  A dead/hung worker records a breaker failure
  (threshold 1 — process death is conclusive), is respawned with its full
  registration log replayed, and the breaker is force-``reset`` (the
  replacement is healthy; re-earning trust through a half-open probe would
  shed requests at a recovered worker).  The in-flight request is retried
  on the replacement; exhaustion — or a replacement that cannot start
  either — surfaces a clean ``EngineDown``: never a hang, never a lost
  request.
* **sharded scatter–gather.**  ``register(..., shards=N)`` row-range splits
  a table; part ``i`` is homed ONLY on worker ``i % processes`` (the full
  table goes everywhere).  A query whose ``shardplan.analyze`` decomposition
  exists — and which ``planner.price_scatter_gather`` prices as worthwhile —
  runs as per-shard fragments on the owning workers in parallel and is
  reassembled by the decomposition's merge (concat / sum / k-way ordered
  merge) in the master.  A shard fragment retries on the SAME worker index
  after a respawn: only that worker holds the shard's rows.  The gather is
  *incremental* (``IncrementalGather``): frames fold into the accumulator
  as workers reply — sum in arrival order, concat/kmerge over the
  contiguous ready prefix — so per-shard payloads are freed immediately
  instead of piling up until the slowest worker answers.
* **streaming appends fan out.**  ``register(..., streaming=True)`` mirrors
  the STREAM-island append contract across the pool: ``append(name, rows)``
  grows the table on every worker (each keeps its own materialized views
  patchable), in the master's catalog, and in the respawn replay log — a
  replacement worker replays the CURRENT rows, never a pre-append state.

``ProcPool`` duck-types the middleware surface the serving stack consumes —
``execute(query, mode, degrade=)`` returning a ``Report``, ``register``,
``persist``, ``health``, ``breaker_trips``, ``catalog`` — so
``QueryServer(bd, processes=N)`` and ``connect(processes=N)`` drop it in
without touching the admission logic.  ``launches()`` sums the hand
kernels' launch counters over the workers (each process counts its own).

The port of ``repro.core.procpool``.
"""
from __future__ import annotations

import itertools
import os
import pickle
import threading
import time
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import shardplan, tables, tracing
from repro_torch.core.engines import ENGINES
from repro_torch.core.errors import (EngineDown, Overloaded, PlanInfeasible,
                                     QueryParseError)
from repro_torch.core.health import EngineHealth
from repro_torch.core.ops import PolyOp
from repro_torch.core.shardplan import ShardInfo, shard_name
from repro_torch.core.signature import signature


def worker_channel(idx: int) -> str:
    """Breaker-registry channel name for worker ``idx``."""
    return f"worker:{idx}"


class _WorkerDied(Exception):
    """Internal: the pipe/process under an RPC went away (EOF, broken pipe,
    dead process, a hung request past its timeout, or a worker that could
    not start — ``reason`` then says why)."""

    def __init__(self, idx: int, reason: Optional[str] = None):
        super().__init__(f"worker {idx} died"
                         + (f": {reason}" if reason else ""))
        self.idx = idx
        self.reason = reason


# -- pipe framing ---------------------------------------------------------------

def _send_msg(conn, msg) -> None:
    """Send ``msg`` with its large array buffers out of band: the pickle
    (protocol 5) goes as one framed message with the buffers' sizes, then
    each buffer's raw bytes straight onto the socket.  ``Connection.recv``
    reads a message with one ``os.read(fd, remaining)`` a chunk, each
    allocating the whole remaining size: for a 256 MiB table that is
    thousands of 256 MiB allocations, and 25 s a registration on a host
    where they are slow.  ``_recv_msg`` reads the buffers into one
    preallocated block each."""
    bufs = []
    data = pickle.dumps(msg, protocol=5, buffer_callback=bufs.append)
    views = [b.raw() for b in bufs]
    conn.send((data, [v.nbytes for v in views]))
    fd = conn.fileno()
    for view in views:
        sent = 0
        while sent < view.nbytes:
            sent += os.write(fd, view[sent:])


def _recv_msg(conn):
    """Receive one ``_send_msg`` message (raises ``EOFError`` when the peer
    is gone, also in the middle of a buffer)."""
    data, sizes = conn.recv()
    fd = conn.fileno()
    bufs = []
    for size in sizes:
        buf = bytearray(size)
        view = memoryview(buf)
        got = 0
        while got < size:
            n = os.readv(fd, [view[got:]])
            if n == 0:
                raise EOFError("peer closed in the middle of a buffer")
            got += n
        bufs.append(buf)
    return pickle.loads(data, buffers=bufs)


# -- worker side --------------------------------------------------------------

def _portable_exc(exc: BaseException) -> BaseException:
    """An exception safe to pickle back over the pipe.

    The structured taxonomy is rebuilt field-by-field (BigDAWGError
    subclasses format their message from attributes, so default pickling
    by ``args`` would misconstruct them; an ``EngineDown.cause`` may not
    pickle at all).  Anything else round-trips as-is when picklable, else
    degrades to a ``RuntimeError`` carrying the repr."""
    if isinstance(exc, EngineDown):
        return EngineDown(exc.engine, exc.op)
    if isinstance(exc, PlanInfeasible):
        return PlanInfeasible(exc.op, exc.island, exc.masked)
    if isinstance(exc, Overloaded):
        return Overloaded(exc.query, exc.reason)
    if isinstance(exc, QueryParseError):
        return QueryParseError(str(exc))
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(f"{type(exc).__name__}: {exc}")


def _portable_report(rep) -> Any:
    """Report with its result's array leaves rebased to numpy — device
    tensors must not cross the process boundary (unpickling one would
    initialize CUDA in the master) — and its trace converted to a plain
    dict (a live Trace carries a threading.Lock)."""
    return replace(rep, result=tables.host_copy(rep.result),
                   trace=tracing.portable(getattr(rep, "trace", None)))


def _worker_main(widx: int, conn, spec: Dict[str, Any]) -> None:
    """Worker process entry point: build a full middleware stack from the
    picklable ``spec`` and serve the RPC loop until ``stop``/EOF.

    The monitor is opened ``shared=True`` so saves merge (per-signature
    last-writer-wins) instead of clobbering sibling workers, and
    ``reload_shared()`` runs before every execute so plans trained by
    siblings are served warm here.  A training serve persists immediately —
    that is the publication step of the cross-process warm path.

    A worker whose middleware cannot be built (no CUDA card for
    ``device=None``, say) answers its first request ``("down", rid,
    reason)`` and exits: the master surfaces that as a dead worker."""
    try:
        # deferred so the spawn bootstrap stays import-light until we commit
        from repro_torch.core.middleware import BigDAWG
        from repro_torch.core.monitor import Monitor

        state_path = spec.get("state_path")
        kwargs = dict(spec.get("bigdawg_kwargs") or {})
        if spec.get("resilient"):
            kwargs.setdefault("health", EngineHealth())
        bd = BigDAWG(monitor=Monitor(state_path, shared=bool(state_path)),
                     device=spec.get("device"), **kwargs)
        init = spec.get("worker_init")
        if init is not None:
            init(bd)
    except Exception as exc:              # noqa: BLE001 — startup boundary
        reason = f"{type(exc).__name__}: {exc}"
        try:
            msg = _recv_msg(conn)
            _send_msg(conn, ("down", msg[1], reason))
        except (EOFError, OSError):
            pass
        conn.close()
        return
    from repro_torch.kernels import ops as kops
    shared = bool(state_path)
    while True:
        try:
            msg = _recv_msg(conn)
        except (EOFError, OSError):
            break
        kind, rid = msg[0], msg[1]
        try:
            if kind == "execute":
                query, mode, degrade, tctx = msg[2], msg[3], msg[4], msg[5]
                if shared:
                    bd.reload_shared()
                rep = bd.execute(query, mode, degrade=degrade,
                                 trace_ctx=tctx)
                if shared and rep.mode == "training":
                    bd.monitor.save()
                    bd.save_plan_cache()
                _send_msg(conn, ("ok", rid, _portable_report(rep)))
            elif kind == "register":
                name, obj, engine, streaming = msg[2], msg[3], msg[4], msg[5]
                bd.register(name, obj, engine, streaming=streaming)
                _send_msg(conn, ("ok", rid, None))
            elif kind == "append":
                name, rows = msg[2], msg[3]
                _send_msg(conn, ("ok", rid, bd.append(name, rows)))
            elif kind == "persist":
                bd.persist()
                _send_msg(conn, ("ok", rid, None))
            elif kind == "launches":
                # this process's hand-kernel launch counts (then zeroed
                # when asked): each worker counts its own launches
                counts = kops.launches()
                if msg[2]:
                    kops.reset_launches()
                _send_msg(conn, ("ok", rid, counts))
            elif kind == "ping":
                _send_msg(conn, ("ok", rid, os.getpid()))
            elif kind == "stop":
                _send_msg(conn, ("ok", rid, None))
                break
            else:
                _send_msg(conn, ("err", rid,
                           RuntimeError(f"unknown message kind {kind!r}")))
        except BaseException as exc:          # noqa: BLE001 — RPC boundary
            try:
                _send_msg(conn, ("err", rid, _portable_exc(exc)))
            except (OSError, BrokenPipeError):
                break
    conn.close()


def _monitor_hammer(path: str, private_sig: str, shared_sig: str,
                    rounds: int, seed: int) -> None:
    """Spawn target for the persistence-contention test: hammer one shared
    monitor DB with interleaved merge-saves and reloads.  Lives here (not in
    the test module) because spawn pickles targets by import path.

    Each process records ``rounds`` observations under its OWN signature
    plus the contended ``shared_sig``, saving after every record — the
    merge-on-save protocol must keep every private signature intact and
    resolve the shared one last-writer-wins, with zero torn reads."""
    from repro_torch.core.monitor import Monitor

    m = Monitor(path, shared=True)
    usage = {"cpu": 0.5, "mem_frac": 0.1}
    for r in range(rounds):
        m.reload_if_changed()
        m.record(private_sig, f"0:plan{seed}", 0.001 * (r + 1), usage=usage)
        m.record(shared_sig, f"0:writer{seed}", 0.001 * (seed + 1),
                 usage=usage)
        m.save()
        time.sleep(0.001 * ((seed + r) % 3))


def _plan_cache_hammer(state_path: str, private_sig: str, bad_sig: str,
                       rounds: int, seed: int) -> None:
    """Spawn target for the masked-signature purity test: hammer one shared
    plan-cache file with interleaved merge-saves and reloads while a
    ``@!``-masked entry keeps being re-injected underneath.  Lives here (not
    in the test module) because spawn pickles targets by import path.

    Each process holds ONE private unmasked signature plus a live masked
    entry in its in-memory cache, and every other round writes the masked
    signature straight into the shared file (simulating a sibling that
    crashed mid-outage with degraded state persisted).  The merge-on-save
    protocol must carry every private signature forever while NEVER writing,
    re-adopting, or resurrecting the masked one.  The middleware runs on
    the CPU: nothing here touches a device."""
    from repro_torch.core.ioutil import atomic_json_dump, load_json
    from repro_torch.core.middleware import (BigDAWG, CachedPlan, MASK_SEP,
                                             _plan_from_key)
    from repro_torch.core.monitor import Monitor

    assert MASK_SEP in bad_sig
    bd = BigDAWG(monitor=Monitor(state_path, shared=True), device="cpu")
    bd.plan_cache[private_sig] = CachedPlan(_plan_from_key("0:dense_array"))
    bd.plan_cache[bad_sig] = CachedPlan(_plan_from_key("0:columnar"))
    for r in range(rounds):
        bd.reload_plan_cache_if_changed()
        bd.save_plan_cache()
        if (r + seed) % 2 == 0:
            # adversarial sibling: masked entry lands in the file between
            # this process's save and everyone else's next merge
            try:
                blob = load_json(bd.plan_cache_path)
            except (OSError, ValueError):
                blob = None
            if isinstance(blob, dict):
                blob.setdefault("entries", {})[bad_sig] = {
                    "plan": "0:kv_sparse", "predicted_s": 0.0,
                    "alternates": []}
                atomic_json_dump(bd.plan_cache_path, blob)
        time.sleep(0.001 * ((seed + r) % 3))


# -- master side --------------------------------------------------------------

class IncrementalGather:
    """Fold-on-arrival gather accumulator for the sharded scatter path.

    Holding every shard's full result frame until the LAST worker answered,
    then merging once, would make peak memory the sum of all shard results
    and land the whole merge cost after the slowest worker.  This
    accumulator merges frames as they ARRIVE instead: ``sum`` folds
    pairwise in any order (element-wise addition commutes and the group
    keys are aligned by construction); ``concat`` and ``kmerge`` are
    order-sensitive, so they fold the contiguous ready prefix in shard
    order — both are associative over a prefix, and ``kmerge`` ties stay
    stable because already-folded earlier shards always sit on the left.
    A folded frame's payload is dropped immediately; the master holds at
    most the running accumulator plus whatever out-of-order frames are
    still waiting on a predecessor.  Thread-safe: worker gather threads
    call ``add`` concurrently."""

    __slots__ = ("merge", "by", "n", "folds", "span", "_lock", "_acc",
                 "_next", "_pending")

    def __init__(self, merge: str, n_shards: int, by: Optional[str] = None,
                 span=None):
        if merge not in ("concat", "sum", "kmerge"):
            raise ValueError(f"unknown merge kind {merge!r}")
        self.merge = merge
        self.by = by
        self.n = n_shards
        self.folds = 0                 # pairwise merges performed (testing)
        self.span = span               # parent tracing.Span: gather_fold spans
        self._lock = threading.Lock()
        self._acc: Any = None
        self._next = 0                 # next shard index the prefix fold needs
        self._pending: Dict[int, Any] = {}

    def _fold(self, fn, shard: int):
        """One pairwise merge, counted and (when tracing) span-recorded —
        no clock reads on the untraced path."""
        if self.span is None:
            out = fn()
        else:
            t0 = time.perf_counter()
            out = fn()
            self.span.static_child("gather_fold",
                                   time.perf_counter() - t0,
                                   shard=shard, merge=self.merge)
        self.folds += 1
        return out

    def add(self, i: int, part) -> None:
        """Absorb shard ``i``'s result frame, folding whatever became
        contiguous (everything, for ``sum``) into the accumulator."""
        with self._lock:
            if self.merge == "sum":
                if self._acc is None:
                    self._acc = part
                else:
                    self._acc = self._fold(
                        lambda: tables.sum_shards([self._acc, part]), i)
                self._next += 1
                return
            self._pending[i] = part
            while self._next in self._pending:
                part = self._pending.pop(self._next)
                if self._acc is None:
                    self._acc = part
                elif self.merge == "concat":
                    self._acc = self._fold(
                        lambda: tables.concat_shards([self._acc, part]),
                        self._next)
                else:
                    self._acc = self._fold(
                        lambda: tables.kmerge_shards([self._acc, part],
                                                     self.by), self._next)
                self._next += 1

    def result(self):
        with self._lock:
            if self._next != self.n or self._pending:
                raise RuntimeError(
                    f"gather incomplete: {self._next}/{self.n} shards folded,"
                    f" {sorted(self._pending)} awaiting predecessors")
            return self._acc


class _Worker:
    """Master-side handle: process + pipe + the lock serializing its RPCs."""

    __slots__ = ("idx", "proc", "conn", "lock")

    def __init__(self, idx, proc, conn):
        self.idx = idx
        self.proc = proc
        self.conn = conn
        self.lock = threading.Lock()


class ProcPool:
    """Master of N worker processes — see the module docstring.

    ``scatter`` controls the sharded path: ``"auto"`` (default) asks
    ``planner.price_scatter_gather`` per signature, ``"always"``/``"never"``
    force it.  ``retries`` bounds how many replacement workers one request
    may try after deaths before surfacing ``EngineDown``.
    ``kill_injector`` (``runtime.fault.WorkerKillInjector``) is the fault
    seam: fired after every execute dispatch with the target's pid.
    ``device`` is each worker's device (``None``: the CUDA card, raising in
    the worker when there is none; ``"cpu"`` to run there on purpose).
    ``worker_init`` is an optional picklable callable run with each
    worker's ``BigDAWG`` once it is built (e.g. to pin adaptive knobs that
    are not constructor arguments).  Remaining keyword arguments go to each
    worker's ``BigDAWG``.
    """

    def __init__(self, processes: int = 2,
                 state_path: Optional[str] = None, *,
                 resilient: bool = False,
                 request_timeout_s: float = 120.0,
                 start_timeout_s: float = 300.0,
                 retries: int = 1,
                 scatter: str = "auto",
                 health: Optional[EngineHealth] = None,
                 kill_injector=None,
                 device=None,
                 worker_init: Optional[Callable[[Any], None]] = None,
                 **bigdawg_kwargs):
        if processes < 1:
            raise ValueError(f"processes must be >= 1, got {processes}")
        if scatter not in ("auto", "always", "never"):
            raise ValueError(f"scatter must be auto|always|never, "
                             f"got {scatter!r}")
        import multiprocessing
        self._ctx = multiprocessing.get_context("spawn")
        self.n = processes
        self.state_path = state_path
        self.device = None if device is None else str(device)
        self._spec = {"state_path": state_path, "resilient": resilient,
                      "device": self.device, "worker_init": worker_init,
                      "bigdawg_kwargs": dict(bigdawg_kwargs)}
        # tracing: the master mirrors the workers' trace= knob (it rides
        # bigdawg_kwargs into each worker's BigDAWG).  With it on, execute()
        # roots a master-side request span and ships (trace_id, span_id)
        # with every dispatch so worker spans re-attach under it
        self.tracer = tracing.Tracer(
            enabled=bool(bigdawg_kwargs.get("trace", False)))
        from repro_torch.runtime.telemetry import (Metrics,
                                                   default_metrics_path)
        self.metrics = Metrics(
            default_metrics_path(state_path) if state_path else None,
            shared=bool(state_path))
        self.request_timeout_s = request_timeout_s
        self.start_timeout_s = start_timeout_s
        self.retries = retries
        self.scatter = scatter
        self.kill_injector = kill_injector
        # worker-death breakers: threshold 1 — a dead process is conclusive
        self.health = health or EngineHealth(
            failure_threshold=1,
            channels=[worker_channel(i) for i in range(processes)])
        # master-side registry: the replay log (respawn re-registers; an
        # append rewrites the logged table in place so replacements replay
        # the CURRENT rows), the catalog mirror (signatures + scatter
        # pricing), the shard registry
        self._registrations: List[
            Tuple[str, Any, str, Optional[int], bool]] = []
        self.catalog: Dict[str, Any] = {}
        self.sharded: Dict[str, ShardInfo] = {}
        self._scatter_cache: Dict[str, bool] = {}
        self._cost_model = None            # built lazily for pricing
        self._rid = itertools.count(1)
        self._rr = itertools.count()
        self._lock = threading.Lock()      # guards workers[] swaps
        self._closed = False
        self.workers: List[_Worker] = [self._spawn(i)
                                       for i in range(processes)]

    # lifetime counters, backed by the metrics registry (``respawns`` etc.
    # stay readable/assignable attributes for existing callers and tests)
    def _metric_prop(name: str) -> property:      # noqa: N805 — factory
        def _get(self):
            return int(self.metrics.value(name))

        def _set(self, v):
            self.metrics.set_counter(name, float(v))
        return property(_get, _set)

    respawns = _metric_prop("pool.respawns")
    dispatches = _metric_prop("pool.dispatches")
    scatter_serves = _metric_prop("pool.scatter_serves")
    del _metric_prop

    # -- lifecycle -----------------------------------------------------------
    def _spawn(self, idx: int) -> _Worker:
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(target=_worker_main,
                                 args=(idx, child, self._spec),
                                 daemon=True, name=f"bigdawg-worker-{idx}")
        proc.start()
        child.close()
        return _Worker(idx, proc, parent)

    def _respawn(self, idx: int, dead: _Worker) -> None:
        """Replace a dead worker: breaker failure -> fresh process -> replay
        the registration log -> breaker reset.  Guarded so concurrent
        requests that watched the same death respawn exactly once — the
        loser finds ``workers[idx]`` already replaced and just retries.
        Raises ``_WorkerDied`` when the replacement dies too (it could not
        start, or died during the replay); the dead handle then stays in
        place, so the next request tries a fresh replacement."""
        with self._lock:
            if self.workers[idx] is not dead:
                return                     # another thread already replaced it
            ch = worker_channel(idx)
            self.health.ensure_channel(ch)
            self.health.record_failure(ch)
            try:
                dead.conn.close()
            except OSError:
                pass
            if dead.proc.is_alive():
                dead.proc.terminate()
            dead.proc.join(timeout=10)
            h = self._spawn(idx)
            # replay BEFORE publishing the handle: no request may overtake
            # the catalog rebuild on the fresh process
            try:
                for name, obj, engine, target, streaming in \
                        self._registrations:
                    if target is None or target == idx:
                        self._rpc(h, "register", name, obj, engine,
                                  streaming, timeout=self.start_timeout_s)
            except _WorkerDied:
                self._reap(h)
                self.workers[idx] = h      # dead too: the next call respawns
                raise
            self.workers[idx] = h
            self.metrics.counter("pool.respawns")
            # the replacement is healthy — don't make it re-earn trust
            # through a half-open probe
            self.health.reset(ch)

    def _recover(self, idx: int, dead: _Worker, what: str,
                 died: _WorkerDied) -> None:
        """``_respawn``, with a replacement that dies too surfaced as a
        clean ``EngineDown`` on the worker's channel (its cause says why,
        e.g. a worker that found no CUDA card) instead of a hang or a
        respawn loop."""
        try:
            self._respawn(idx, dead)
        except _WorkerDied as again:
            cause = RuntimeError(again.reason or died.reason
                                 or "replacement worker died")
            raise EngineDown(worker_channel(idx), what, cause=cause) from None

    @staticmethod
    def _reap(h: _Worker) -> None:
        try:
            h.conn.close()
        except OSError:
            pass
        if h.proc.is_alive():
            h.proc.terminate()
        h.proc.join(timeout=10)

    def close(self) -> None:
        """Stop every worker (idempotent; ``QueryServer``/``Session`` owners
        call it explicitly, or use the pool as a context manager)."""
        if self._closed:
            return
        self._closed = True
        for h in self.workers:
            try:
                self._rpc(h, "stop", timeout=5.0)
            except (_WorkerDied, Exception):   # noqa: BLE001 — best effort
                pass
            try:
                h.conn.close()
            except OSError:
                pass
        for h in self.workers:
            h.proc.join(timeout=5)
            if h.proc.is_alive():
                h.proc.terminate()
                h.proc.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- RPC core ------------------------------------------------------------
    def _rpc(self, h: _Worker, kind: str, *payload,
             timeout: Optional[float] = None, span=None):
        """One framed request/reply on a worker's pipe.  Raises
        ``_WorkerDied`` on EOF/broken pipe/dead process/timeout or a
        ``down`` reply; re-raises the worker's transported exception on an
        ``err`` reply.  Replies are rid-matched: a buffered reply to an
        earlier timed-out request is discarded here rather than
        mis-delivered.

        With a ``span``, the wait for the worker's pipe lock is recorded as
        a ``queue_wait`` child and the in-flight RPC as ``worker_dispatch``."""
        rid = next(self._rid)
        timeout = self.request_timeout_s if timeout is None else timeout
        qspan = span.child("queue_wait", worker=h.idx) \
            if span is not None else None
        with h.lock:
            if qspan is not None:
                qspan.end()
                dspan = span.child("worker_dispatch", worker=h.idx, kind=kind)
            else:
                dspan = None
            try:
                try:
                    _send_msg(h.conn, (kind, rid) + payload)
                except (OSError, BrokenPipeError, ValueError):
                    raise _WorkerDied(h.idx) from None
                if self.kill_injector is not None and kind == "execute":
                    # fault seam: the request is now in flight on that process
                    self.kill_injector.on_dispatch(h.idx, h.proc.pid)
                deadline = time.monotonic() + timeout
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        # hung worker: indistinguishable from dead at this
                        # layer — kill it so the respawn starts clean
                        if h.proc.is_alive():
                            h.proc.terminate()
                        raise _WorkerDied(h.idx)
                    if h.conn.poll(min(0.1, remaining)):
                        try:
                            status, r_rid, out = _recv_msg(h.conn)
                        except (EOFError, OSError):
                            raise _WorkerDied(h.idx) from None
                        if r_rid != rid:
                            continue       # stale reply — discard, keep waiting
                        if status == "ok":
                            return out
                        if status == "down":
                            raise _WorkerDied(h.idx, out)
                        raise out
                    if not h.proc.is_alive():
                        # one last poll: a reply can be buffered past death
                        if not h.conn.poll(0.2):
                            raise _WorkerDied(h.idx)
            finally:
                if dspan is not None:
                    dspan.end()

    # -- registration --------------------------------------------------------
    def register(self, name: str, obj, engine: str,
                 shards: Optional[int] = None,
                 streaming: bool = False) -> None:
        """Mirror of ``BigDAWG.register`` across the pool.  The full table
        goes to every worker; with ``shards=N`` part ``i`` additionally goes
        ONLY to worker ``i % processes`` under ``name#i`` — the placement
        the scatter path dispatches against.  ``streaming=True`` declares an
        append-able STREAM-island table (``append`` grows it on every
        worker); streaming tables cannot be sharded — appends would have to
        re-balance the row-range parts."""
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine}")
        if streaming and shards is not None:
            raise ValueError("a streaming registration cannot be sharded")
        obj = tables.host_copy(obj)
        if shards is not None:
            if shards < 1:
                raise ValueError(f"shards must be >= 1, got {shards}")
            parts = tables.shard_rows(obj, shards)
            self.sharded[name] = ShardInfo(shards, obj.kind,
                                           shardplan.nrows_of(obj))
            self._scatter_cache.clear()
            for i, part in enumerate(parts):
                self._register_one(shard_name(name, i), part, engine,
                                   target=i % self.n)
        self._register_one(name, obj, engine, target=None,
                           streaming=streaming)

    def _register_one(self, name: str, obj, engine: str,
                      target: Optional[int],
                      streaming: bool = False) -> None:
        from repro_torch.core.middleware import CatalogEntry
        # log first: any respawn from here on replays this entry itself
        self._registrations.append((name, obj, engine, target, streaming))
        self.catalog[name] = CatalogEntry(name, obj, engine,
                                          streaming=streaming)
        for idx in range(self.n):
            if target is not None and target != idx:
                continue
            h = self.workers[idx]
            try:
                self._rpc(h, "register", name, obj, engine, streaming,
                          timeout=self.start_timeout_s)
            except _WorkerDied as died:
                # the replay delivers this entry too
                self._recover(idx, h, "register", died)

    def append(self, name: str, rows) -> int:
        """Mirror of ``BigDAWG.append`` across the pool: grow a streaming
        registration on every worker and in the master's catalog/replay log.
        The replay log is rewritten IN PLACE first, so a worker that dies
        mid-broadcast respawns with the grown table already replayed — no
        worker can serve pre-append rows after this returns.  Returns the
        master's new version for the table."""
        entry = self.catalog.get(name)
        if entry is None:
            raise KeyError(f"no registration named {name!r}")
        if not entry.streaming:
            raise ValueError(f"{name!r} is not a streaming registration "
                             f"(register with streaming=True)")
        rows = tables.host_copy(rows)
        with self._lock:
            for j, reg in enumerate(self._registrations):
                if reg[0] == name and reg[4]:
                    self._registrations[j] = (
                        reg[0], tables.append_rows(reg[1], rows), reg[2],
                        reg[3], True)
            entry.obj = tables.append_rows(entry.obj, rows)
            entry.version += 1
        for idx in range(self.n):
            h = self.workers[idx]
            try:
                self._rpc(h, "append", name, rows)
            except _WorkerDied as died:
                # the replay log already holds the grown table — nothing
                # left to deliver
                self._recover(idx, h, "append", died)
        return entry.version

    @classmethod
    def from_bigdawg(cls, bd, processes: int, **kwargs) -> "ProcPool":
        """Lift an in-process middleware into a pool: same state paths (so
        the workers inherit its persisted monitor/plan-cache warmth), same
        catalog (shard placements preserved), same resilience posture, same
        device (unless ``device=`` is given)."""
        kwargs.setdefault("device", str(bd.device))
        pool = cls(processes=processes, state_path=bd.monitor.path,
                   resilient=bd.health is not None,
                   train_plans=bd.train_plans,
                   explore_budget=bd.explore_budget, **kwargs)
        part_target: Dict[str, int] = {}
        for name, info in bd.sharded.items():
            pool.sharded[name] = info
            for i in range(info.n_shards):
                part_target[shard_name(name, i)] = i % processes
        for name, entry in bd.catalog.items():
            pool._register_one(name, tables.host_copy(entry.obj),
                               entry.engine, part_target.get(name),
                               streaming=getattr(entry, "streaming", False))
        return pool

    # -- serving -------------------------------------------------------------
    @property
    def breaker_trips(self) -> int:
        return self.health.trips()

    def persist(self) -> None:
        """Ask every worker to flush its monitor/calibration/plan-cache —
        the merge-on-save protocol interleaves them safely."""
        for idx in range(self.n):
            h = self.workers[idx]
            try:
                self._rpc(h, "persist")
            except _WorkerDied as died:
                # nothing to retry: a dead worker's unflushed deltas died
                # with it
                self._recover(idx, h, "persist", died)
        self.metrics.save()

    def ping(self) -> List[Optional[int]]:
        """Liveness probe: worker pids (None where a worker had to be
        respawned to answer)."""
        out: List[Optional[int]] = []
        for idx in range(self.n):
            h = self.workers[idx]
            try:
                out.append(self._rpc(h, "ping", timeout=self.start_timeout_s))
            except _WorkerDied as died:
                self._recover(idx, h, "ping", died)
                out.append(None)
        return out

    def launches(self, reset: bool = False) -> Dict[str, int]:
        """The hand kernels' launch counts summed over the live workers
        (``kernels.ops.launches()`` names; each process counts its own, and
        a respawned worker starts from 0).  ``reset=True`` zeroes them in
        every worker after reading."""
        total: Dict[str, int] = {}
        for idx in range(self.n):
            h = self.workers[idx]
            try:
                counts = self._rpc(h, "launches", bool(reset))
            except _WorkerDied as died:
                self._recover(idx, h, "launches", died)
                continue
            for name, n in counts.items():
                total[name] = total.get(name, 0) + int(n)
        return total

    def execute(self, query: PolyOp, mode: str = "auto", *,
                degrade: bool = False,
                trace_ctx: Optional[Tuple[str, Optional[str]]] = None):
        """The serving entry point ``QueryServer``/``Session`` call.
        Scatter–gather when the query decomposes over sharded registrations
        and the pricing says it pays; otherwise round-robin to one worker.
        Worker death is retried on a respawned replacement up to
        ``retries`` times, then surfaces as ``EngineDown`` — requests are
        never lost to a crash and never hang past the timeout.

        With tracing on (``trace=True`` in the pool's bigdawg kwargs) —
        or a propagated ``trace_ctx`` — the Report carries ONE connected
        trace: the master's request/queue_wait/worker_dispatch (and
        gather_fold / respawn) spans plus every worker-side span, all
        under the same trace id."""
        if self._closed:
            raise RuntimeError("ProcPool is closed")
        trace = self.tracer.start(trace_ctx)
        span = trace.root("request", mode=mode, pool=self.n) \
            if trace is not None else None
        try:
            sg = shardplan.analyze_catalog(query, self.sharded)
            if sg is not None and self._scatter_worthwhile(query, sg):
                rep = self._execute_scatter(sg, mode, degrade, span=span)
            else:
                rep = self._execute_one(query, mode, degrade, span=span)
        finally:
            if span is not None:
                span.end()
        if trace is not None:
            rep.trace = trace
        return rep

    def _dispatch(self, idx: int, payload: tuple, what: str, span=None,
                  shard: Optional[int] = None):
        """One execute on worker ``idx``, retried on a respawned
        replacement up to ``retries`` times; ``EngineDown`` when they are
        spent (or a replacement cannot start)."""
        for _attempt in range(self.retries + 1):
            h = self.workers[idx]
            try:
                self.metrics.counter("pool.dispatches")
                rep = self._rpc(h, "execute", *payload, span=span)
            except _WorkerDied as died:
                if span is not None:
                    if shard is None:
                        span.event("respawn", worker=idx)
                    else:
                        span.event("respawn", worker=idx, shard=shard)
                self._recover(idx, h, what, died)
                continue
            self.health.record_success(worker_channel(idx))
            if span is not None:
                # re-attach the worker's serialized spans (the retry serve
                # after a respawn lands here too — same trace id)
                span.trace.adopt(rep.trace)
            return rep
        raise EngineDown(worker_channel(idx), what)

    def _execute_one(self, query: PolyOp, mode: str, degrade: bool,
                     span=None):
        idx = next(self._rr) % self.n
        tctx = span.trace.ctx(span) if span is not None else None
        rep = self._dispatch(idx, (query, mode, degrade, tctx), "execute",
                             span=span)
        if span is not None:
            rep.trace = None
        return rep

    def _execute_scatter(self, sg, mode: str, degrade: bool, span=None):
        """Fan the decomposition's fragments to their owning workers in
        parallel, merge in the master (numpy-only).  Fragment ``i`` is
        pinned to worker ``i % n`` — the only process holding shard ``i``'s
        rows — so a death retries the SAME index after respawn.

        The gather is incremental: each frame folds into an
        ``IncrementalGather`` accumulator the moment its worker replies and
        the per-shard payload is dropped, so the master's peak memory is
        the running accumulator (plus out-of-order stragglers), not the sum
        of every shard frame — and by the time the slowest worker answers,
        every other frame's merge work is already done."""
        t0 = time.perf_counter()
        gather = IncrementalGather(sg.merge, sg.n_shards, by=sg.merge_by,
                                   span=span)
        # Report metadata survives the payload drop: (cast_bytes, mode,
        # cache_hit, failovers, degraded) per shard, plus shard 0's Report
        # (payload stripped) as the roll-up base
        metas: List[Optional[Tuple]] = [None] * sg.n_shards
        first_rep: List[Any] = [None]
        errs: List[Optional[BaseException]] = [None] * sg.n_shards
        tctx = span.trace.ctx(span) if span is not None else None

        def run(i: int) -> None:
            try:
                rep = self._dispatch(i % self.n,
                                     (sg.fragment(i), mode, degrade, tctx),
                                     f"shard {i}", span=span, shard=i)
            except BaseException as exc:   # noqa: BLE001 — worker error
                errs[i] = exc
                return
            metas[i] = (rep.cast_bytes, rep.mode, rep.cache_hit,
                        getattr(rep, "failovers", 0),
                        getattr(rep, "degraded", False))
            if i == 0:
                first_rep[0] = replace(rep, result=None, trace=None)
            gather.add(i, rep.result)     # frees the frame once folded

        if self.n == 1:
            for i in range(sg.n_shards):
                run(i)
        else:
            threads = [threading.Thread(target=run, args=(i,), daemon=True)
                       for i in range(sg.n_shards)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        err = next((e for e in errs if e is not None), None)
        if err is not None:
            raise err
        merged = gather.result()
        self.metrics.counter("pool.scatter_serves")
        first = first_rep[0]
        return replace(
            first, result=merged,
            seconds=time.perf_counter() - t0,
            cast_bytes=float(sum(m[0] for m in metas)),
            mode="training" if any(m[1] == "training" for m in metas)
            else "production",
            cache_hit=all(m[2] for m in metas),
            per_node_seconds=dict(first.per_node_seconds),
            failovers=sum(m[3] for m in metas),
            degraded=any(m[4] for m in metas),
            shards=sg.n_shards)

    def _scatter_worthwhile(self, query: PolyOp, sg) -> bool:
        """Gate the scatter path on the planner's price (cached per
        signature).  Pricing is advisory: any modeling failure falls back
        to scattering — the decomposition is already proven valid.  The
        cost model is loaded from the calibration file beside the state
        path and never calibrated here: the master runs nothing on a
        device."""
        if self.scatter == "always":
            return True
        if self.scatter == "never":
            return False
        sig = signature(query, self.catalog)
        cached = self._scatter_cache.get(sig)
        if cached is not None:
            return cached
        try:
            from repro_torch.core import planner
            if self._cost_model is None:
                from repro_torch.core.costmodel import (
                    CostModel, default_calibration_path)
                self._cost_model = CostModel(
                    default_calibration_path(self.state_path))
            price = planner.price_scatter_gather(
                query, sg.fragment(0), catalog=self.catalog,
                n_shards=sg.n_shards, workers=self.n,
                cost_model=self._cost_model)
            ok = bool(price.worthwhile)
        except Exception:                  # noqa: BLE001 — advisory only
            ok = True
        self._scatter_cache[sig] = ok
        return ok
