"""Serving loops: batched LM decode (``BatchServer``) and polystore query
serving (``QueryServer``), the port of ``repro.runtime.server``.

``BatchServer`` is a fixed-capacity decode batch over a shared cache.
Incoming requests are prefilled one at a time into free slots (each
prefill writes its cache rows), decode steps advance ALL active slots
together, and finished slots (EOS, max-tokens or a full cache) are
released.  Under a profiler the loop's phases are regions
(``core.tracing.region``): ``serve.prefill`` (the host issuing a
prefill), ``serve.write_rows``, ``serve.first_token`` (where the host
waits for the prefill) and ``serve.decode``, a whole step whose children
``serve.decode.launch`` (the host issuing the step) and
``serve.decode.wait`` (the host waiting for its tokens) leave the per-slot
bookkeeping as its self time.

The cache is a dict of tensors on the serving device.  ``_write_rows``
copies a prefilled request's rows into its slot IN PLACE, and the decode
function updates the cache in place too (the reference rebuilds both).
Under a plan scope over a mesh (``models.partition``) the cache leaves
are ``DTensor``s, and rows are copied span by span on each rank.  Where
the mesh splits the slots over data-parallel ranks, a request's rows
(its prefill replicates a batch of one over them) are copied on the ranks
that hold its slot, and a decode step runs each rank on its own slots.

``QueryServer`` serves polystore queries through the middleware's
signature-keyed plan cache: a cold signature trains once (the middleware
serializes same-signature requests), every later request runs the cached
plan.  ``submit`` is safe from many threads; ``submit_many``/``serve`` fan a
batch over a request pool.  ``max_pending=N`` sheds batch requests beyond N
in flight (``Overloaded``); ``latency_target_s=T`` replaces that bound with
an AIMD one keyed to the serve-latency EWMA and admits the overflow below
twice the bound *degraded* (always-up engines) before it sheds.
``persist()`` flushes monitor, calibration and plan cache, so a restarted
server serves warm.  ``stats`` is a dict-shaped view (``StatsView``) over
the middleware's ``Metrics`` registry.  ``processes=N > 1`` serves through
a ``core.procpool.ProcPool`` of N worker processes behind the same
admission logic (``close()`` stops them).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from collections.abc import Mapping
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core.errors import Overloaded
from repro_torch.core.reqpool import RequestPool
from repro_torch.core.tracing import region

# The pre-taxonomy name for a shed request's result slot, kept as an alias
# of ``Overloaded`` as in the reference
Shed = Overloaded
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # (len,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


def _slot_block(dst: DTensor, b_axis: int) -> tuple:
    """(this rank's block of the slots, number of blocks): the mesh axes
    that split dimension ``b_axis`` of ``dst``, major to minor."""
    mesh = dst.device_mesh
    index, n = 0, 1
    for k, (pl, size) in enumerate(zip(dst.placements, mesh.shape)):
        if isinstance(pl, Shard) and pl.dim == b_axis and size > 1:
            index = index * size + mesh.get_local_rank(k)
            n *= size
    return index, n


def _check_spans(dst: DTensor, src, b_axis: int) -> None:
    """Rows copy span by span where the prefill's leaf is split as the
    server's along every dimension but the slots' (which a batch of one
    leaves whole)."""
    if not isinstance(src, DTensor) or src.device_mesh != dst.device_mesh:
        raise ValueError("a prefilled cache leaf not in the server "
                         "cache's layout")
    split = set()
    for a, b, n in zip(dst.placements, src.placements,
                       dst.device_mesh.shape):
        if n == 1:
            continue
        if isinstance(a, Shard) and a.dim == b_axis:
            ok = not isinstance(b, Shard)
        else:
            ok = a == b
        if not ok:
            raise ValueError("a prefilled cache leaf not in the server "
                             "cache's layout")
        if isinstance(a, Shard):
            split.add(a.dim)
    seq = b_axis + 1
    if seq in split and src.shape[seq] != dst.shape[seq]:
        raise NotImplementedError("a split seq dimension shorter in the "
                                  "prefill than in the server cache")


class BatchServer:
    def __init__(self, *, slots: int, max_len: int, prefill_fn, decode_fn,
                 params, init_cache_fn, eos_id: Optional[int] = None):
        """prefill_fn(params, tokens(1,L)) -> (logits(1,V), cache_rows, pos)
        decode_fn(params, cache, tokens(B,), pos(B,)) -> (next(B,), cache).

        The serving device is the cache's (``init_cache_fn(slots,
        max_len)``); prompts and decode inputs are moved there."""
        self.slots = slots
        self.max_len = max_len
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.params = params
        self.cache = init_cache_fn(slots, max_len)
        self.device = tree_leaves(self.cache)[0].device
        self.eos_id = eos_id
        self.active: Dict[int, Request] = {}     # slot -> request
        self.pos = np.zeros((slots,), np.int32)
        self.tokens = np.zeros((slots,), np.int32)
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens_out": 0,
                      "decode_seconds": 0.0}
        # guards slot state + the shared cache writes; prefill COMPUTE runs
        # pool-parallel in serve(), attachment is serialized here
        self._slot_lock = threading.Lock()
        self._requests = RequestPool(thread_name_prefix="bigdawg-prefill")

    # -- slot management -----------------------------------------------------
    def _free_slots(self):
        return [s for s in range(self.slots) if s not in self.active]

    @torch.inference_mode()
    def _write_rows(self, cache_rows, slot: int, plen: int):
        """Copy one request's prefilled cache rows into the batch cache.

        Generic across cache families: the batch axis of each leaf is
        located by matching (slots vs 1) dims; a following seq axis, if
        shorter in the source, is zero-filled past the source's length.
        Where the slots are split over ranks, only the ranks that hold
        ``slot`` copy, at its place in their block."""
        def place(dst, src):
            b_axis = None
            for ax in range(dst.ndim):
                if dst.shape[ax] == self.slots and src.shape[ax] == 1:
                    b_axis = ax
                    break
            if b_axis is None:           # state-style leaf without seq dim
                return dst
            if isinstance(dst, DTensor):
                _check_spans(dst, src, b_axis)
                block, n = _slot_block(dst, b_axis)
                per = self.slots // n
                if slot // per == block:
                    place_local(dst.to_local(), src.to_local(), b_axis,
                                slot - block * per)
                return dst
            place_local(dst, src, b_axis, slot)
            return dst

        def place_local(dst, src, b_axis, at):
            idx = [slice(None)] * dst.ndim
            idx[b_axis] = slice(at, at + 1)
            seq = b_axis + 1
            if seq < dst.ndim and src.shape[seq] != dst.shape[seq]:
                tail = list(idx)
                tail[seq] = slice(src.shape[seq], None)
                dst[tuple(tail)] = 0
                idx[seq] = slice(0, src.shape[seq])
            dst[tuple(idx)] = src.to(dst.dtype)
        self.cache = tree_map(place, self.cache, cache_rows)

    def _prefill_compute(self, req: Request):
        """The pure-compute half of a prefill (no shared state): safe to run
        on a request-pool worker while other prefills compute beside it."""
        with region("serve.prefill"):
            tok = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                                  device=self.device)
            return self.prefill_fn(self.params, tok)

    def _attach(self, slot: int, req: Request, logits, cache_rows) -> None:
        """The stateful half: copy the prefilled cache rows into the batch
        cache and activate the slot (serialized on the slot lock)."""
        with self._slot_lock:
            with region("serve.write_rows"):
                self._write_rows(cache_rows, slot, len(req.prompt))
            with region("serve.first_token"):    # waits for the prefill
                first = int(torch.argmax(logits[0]))
            req.out_tokens.append(first)
            self.tokens[slot] = first
            self.pos[slot] = len(req.prompt)
            self.active[slot] = req
            self.stats["prefills"] += 1

    def submit(self, req: Request) -> bool:
        free = self._free_slots()
        if not free:
            return False
        logits, cache_rows, pos = self._prefill_compute(req)
        self._attach(free[0], req, logits, cache_rows)
        return True

    # -- decode ----------------------------------------------------------------
    def step(self):
        if not self.active:
            return
        with region("serve.decode"):
            t0 = time.perf_counter()
            with region("serve.decode.launch"):
                nxt, self.cache = self.decode_fn(
                    self.params, self.cache,
                    torch.as_tensor(self.tokens, device=self.device),
                    torch.as_tensor(self.pos, device=self.device))
            with region("serve.decode.wait"):  # waits for the step to end
                nxt = nxt.cpu().numpy()
            self.stats["decode_seconds"] += time.perf_counter() - t0
            self.stats["decode_steps"] += 1
            for slot, req in list(self.active.items()):
                tok = int(nxt[slot])
                req.out_tokens.append(tok)
                self.pos[slot] += 1
                self.tokens[slot] = tok
                self.stats["tokens_out"] += 1
                if ((self.eos_id is not None and tok == self.eos_id)
                        or len(req.out_tokens) >= req.max_new_tokens
                        or self.pos[slot] >= self.max_len - 1):
                    req.done = True
                    del self.active[slot]

    def run(self, requests: List[Request], max_steps: int = 10000):
        pending = list(requests)
        steps = 0
        while (pending or self.active) and steps < max_steps:
            while pending and self._free_slots():
                self.submit(pending.pop(0))
            self.step()
            steps += 1
        return requests

    def serve(self, requests: List[Request], workers: Optional[int] = None,
              max_steps: int = 10000):
        """``run`` with pool-parallel prefill: each admission wave computes
        its prefills concurrently on the shared request pool, then attaches
        them to free slots on the caller thread — decode still advances all
        active slots together.  ``workers<=1`` degrades to ``run``'s
        sequential admission."""
        pending = list(requests)
        steps = 0
        while (pending or self.active) and steps < max_steps:
            free = self._free_slots()
            wave = pending[:len(free)]
            if wave:
                del pending[:len(wave)]
                outs = self._requests.map_ordered(self._prefill_compute,
                                                  wave, workers)
                for slot, req, (logits, cache_rows, _pos) in zip(
                        free, wave, outs):
                    self._attach(slot, req, logits, cache_rows)
            self.step()
            steps += 1
        return requests


class StatsView(Mapping):
    """Backward-compatible dict view over the server's ``Metrics`` registry.

    ``QueryServer.stats`` used to be a plain dict guarded by its own lock —
    one of three separately-locked counter stores in the serving stack.
    The counters now live in :class:`repro_torch.runtime.telemetry.Metrics`; this
    view keeps every old read working: ``srv.stats["requests"]``,
    ``dict(srv.stats)``, iteration, ``len``.  Middleware-lifetime keys
    (``breaker_trips``, ``fused_serves``, ...) are read live off the
    backend, exactly as ``submit`` used to mirror them.  Calling the view
    (``srv.stats()``) returns a plain dict snapshot."""

    _KEYS = ("requests", "cache_hits", "trainings", "replans",
             "explorations", "shed", "seconds", "degraded", "failovers",
             "breaker_trips", "latency_ewma", "fused_serves",
             "fusion_fallbacks", "ivm_serves", "ivm_fallbacks")
    _FLOAT = frozenset(("seconds", "latency_ewma"))
    # lifetime middleware counters read live off the backend (a ProcPool
    # backend lacks the fused/ivm attributes -> 0, like the old mirror)
    _LIVE = frozenset(("breaker_trips", "fused_serves", "fusion_fallbacks",
                       "ivm_serves", "ivm_fallbacks"))

    def __init__(self, server: "QueryServer"):
        self._server = server

    def __getitem__(self, key: str):
        if key not in self._KEYS:
            raise KeyError(key)
        if key in self._LIVE:
            return int(getattr(self._server.bd, key, 0))
        v = self._server.metrics.value("server." + key)
        return float(v) if key in self._FLOAT else int(v)

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self) -> int:
        return len(self._KEYS)

    def __call__(self) -> Dict[str, Any]:
        return {k: self[k] for k in self._KEYS}

    def __repr__(self) -> str:
        return repr(self())


class QueryServer:
    """Production-facing polystore front end over a ``BigDAWG`` instance.

    Serving path: signature -> plan cache -> concurrent plan execution.  Only
    a cache/monitor miss (a never-seen signature) falls back to the training
    phase, so steady-state traffic never re-enumerates plans.

    Thread-safe: ``submit`` may be called from many threads at once (see the
    module docstring); ``submit_many``/``serve`` spin the requests over the
    server's own request pool.

    **Bounded admission.**  With ``max_pending=N``, batch admission
    (``submit_many``/``serve``) keeps at most N requests in flight at once:
    a request arriving while N are outstanding is *shed* — its result slot
    holds an ``Overloaded`` marker, ``stats["shed"]`` counts it, and the
    request is never executed (load-shedding backpressure instead of an
    unbounded queue).  ``max_pending=None`` (default) admits everything.
    Direct ``submit`` calls bypass the bound: the caller already owns a
    thread and blocking it is the natural backpressure there.

    **Adaptive shedding.**  ``latency_target_s=T`` replaces the fixed bound
    with an AIMD one keyed to measured serve latency: the bound grows by 1
    after each completion whose latency EWMA sits under T and halves when
    the EWMA overshoots, floored at 1 and capped at ``max_pending`` (when
    given).  Requests landing between the bound and twice the bound are
    admitted *degraded* — executed with the middleware's degrade mask
    (always-up engines only; requires ``BigDAWG(health=...)``) — so the
    server sheds only after degrading, and ``stats["degraded"]`` counts the
    slow-but-alive serves.
    """

    # default size of the request admission pool (submit_many/serve)
    DEFAULT_REQUEST_WORKERS = RequestPool.DEFAULT_WORKERS

    def __init__(self, bigdawg, max_pending: Optional[int] = None,
                 latency_target_s: Optional[float] = None,
                 processes: Optional[int] = None,
                 fuse: Optional[bool] = None,
                 incremental: Optional[Any] = None):
        # ``processes=N`` lifts the middleware into a core.procpool.ProcPool
        # — N worker processes each owning a full middleware stack on the
        # middleware's device, sharing plans through the monitor/plan-cache
        # files — so batch admission fans across interpreters instead of
        # threads under one GIL.  The pool duck-types the middleware surface
        # (execute/persist/health/breaker_trips), so the admission logic
        # below is unchanged.
        if processes is not None and processes > 1:
            from repro_torch.core.procpool import ProcPool
            if not isinstance(bigdawg, ProcPool):
                bigdawg = ProcPool.from_bigdawg(bigdawg, processes)
        self.bd = bigdawg
        # fuse=True/False overrides the middleware's plan-level kernel
        # fusion knob for this server; None leaves the middleware's own
        # setting (BigDAWG(fuse=...)) untouched.  A ProcPool backend has no
        # fuse attribute — its workers own their middlewares — so the
        # override only applies to in-process backends that carry the knob
        if fuse is not None and hasattr(self.bd, "fuse"):
            self.bd.fuse = fuse
        # incremental=True/False/"force" overrides the middleware's
        # streaming-IVM knob the same way (None leaves BigDAWG(incremental=)
        # untouched; ProcPool backends without the attribute are skipped)
        if incremental is not None and hasattr(self.bd, "incremental"):
            self.bd.incremental = incremental
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if latency_target_s is not None and latency_target_s <= 0:
            raise ValueError(f"latency_target_s must be > 0, got "
                             f"{latency_target_s}")
        self.max_pending = max_pending
        self.latency_target_s = latency_target_s
        # counters live in the middleware's Metrics registry when it has one
        # (so server.* and bd.* metrics land in one snapshot/file); a
        # pre-taxonomy stand-in without a registry gets a pathless private
        # one.  ``self.stats`` stays a dict-shaped view over it.
        from repro_torch.runtime.telemetry import Metrics
        reg = getattr(self.bd, "metrics", None)
        self.metrics = reg if reg is not None else Metrics()
        self.stats = StatsView(self)
        self._pending = 0          # batch-admitted requests still in flight
        # adaptive in-flight bound (AIMD; only consulted when
        # latency_target_s is set) and the serve-latency EWMA driving it
        self._bound = float(max_pending or 2 * self.DEFAULT_REQUEST_WORKERS)
        self._lat_ewma = 0.0
        self._admit_lock = threading.Lock()
        # lazily-built request pool (NOT the executor host pool — request
        # threads block on level barriers); grows, never shrinks
        self._requests = RequestPool()

    def warm(self, queries) -> int:
        """Admission/warmup: train every query shape once so production
        traffic starts on cached plans."""
        n = 0
        for q in queries:
            self.bd.execute(q, mode="training")
            n += 1
        return n

    def persist(self) -> None:
        """Flush monitor DB, cost-model calibration and plan cache to their
        side-by-side files so the next server process restarts warm (no-ops
        for components constructed without a path).  Waits for in-flight
        background explorations first, so their measurements are included."""
        self.bd.persist()

    def close(self) -> None:
        """Shut down a process-pool backend (no-op for the in-process
        middleware): stops every worker after their pipes drain."""
        closer = getattr(self.bd, "close", None)
        if closer is not None:
            closer()

    def submit(self, query, degrade: bool = False):
        """Admit one request (safe from any thread).  The measured seconds
        cover the serve path only — background exploration the serve may
        have scheduled runs off-path and is never in this timing.
        ``degrade=True`` (the adaptive-shedding middle rung) executes under
        the middleware's degrade mask — always-up engines only."""
        t0 = time.perf_counter()
        if degrade:
            rep = self.bd.execute(query, mode="auto", degrade=True)
        else:     # plain call keeps pre-taxonomy BigDAWG stand-ins working
            rep = self.bd.execute(query, mode="auto")
        dt = time.perf_counter() - t0
        m = self.metrics
        m.counter("server.requests")
        m.counter("server.seconds", dt)
        m.observe("server.latency", dt)
        if rep.mode == "training":
            m.counter("server.trainings")
        if rep.cache_hit:
            m.counter("server.cache_hits")
        if rep.replanned:
            m.counter("server.replans")
        if rep.explored:
            m.counter("server.explorations")
        if getattr(rep, "degraded", False):
            m.counter("server.degraded")
        failovers = getattr(rep, "failovers", 0)
        if failovers:
            m.counter("server.failovers", float(failovers))
        if self.latency_target_s is not None and rep.mode != "training":
            # AIMD on the in-flight bound, driven by the latency EWMA:
            # under target -> +1 (up to max_pending when given), over ->
            # halve (floor 1).  Training requests are excluded — a cold
            # signature's plan-enumeration time says nothing about
            # steady-state serve latency
            with self._admit_lock:
                a = 0.2
                self._lat_ewma = dt if self._lat_ewma == 0.0 \
                    else (1 - a) * self._lat_ewma + a * dt
                if self._lat_ewma <= self.latency_target_s:
                    cap = float(self.max_pending) if self.max_pending \
                        else float("inf")
                    self._bound = min(cap, self._bound + 1.0)
                else:
                    self._bound = max(1.0, self._bound / 2.0)
                m.gauge("server.latency_ewma", self._lat_ewma)
        return rep

    def _try_admit(self) -> Optional[str]:
        """Reserve an in-flight slot for one batch request: ``"admit"``
        (serve normally), ``"degrade"`` (adaptive middle rung: serve on the
        always-up engines), or ``None`` (shed).  The check-and-increment is
        atomic under the admission lock, so concurrent ``submit_many`` batches
        can never jointly exceed the bound."""
        with self._admit_lock:
            if self.latency_target_s is not None:
                bound = max(1, int(self._bound))
                if self._pending < bound:
                    self._pending += 1
                    return "admit"
                # degrade before shedding — but only when the middleware
                # can actually plan a degraded serve (health registry)
                if self._pending < 2 * bound \
                        and getattr(self.bd, "health", None) is not None:
                    self._pending += 1
                    return "degrade"
                self.metrics.counter("server.shed")
                return None
            if self.max_pending is not None \
                    and self._pending >= self.max_pending:
                self.metrics.counter("server.shed")
                return None
            self._pending += 1
            return "admit"

    def _admitted_submit(self, q, degrade: bool = False):
        try:
            return self.submit(q, degrade=degrade)
        finally:
            with self._admit_lock:
                self._pending -= 1

    def submit_many(self, queries: Iterable, workers: Optional[int] = None
                    ) -> List:
        """Admit a batch of requests concurrently from the request pool and
        return their Reports in input order.  ``workers<=1`` degrades to a
        sequential loop (no pool round-trips).  Mixed cold/warm traffic is
        fine: the middleware's per-signature locking guarantees one training
        per cold signature no matter how the requests interleave.

        With ``max_pending=N`` on the server, a request arriving while N
        batch requests are in flight is rejected *without blocking*: its
        slot in the returned list is an ``Overloaded`` marker and
        ``stats["shed"]`` is bumped.  With ``latency_target_s`` the bound is
        the AIMD one, and overflow below twice the bound is served degraded
        instead of shed (see the class docstring)."""
        queries = list(queries)
        workers = workers or self.DEFAULT_REQUEST_WORKERS
        shed_reason = "latency_target" if self.latency_target_s is not None \
            else "max_pending"
        if workers <= 1 or len(queries) <= 1:
            # sequential admission still reserves an in-flight slot per
            # request: the bound is shared across batches, and a concurrent
            # submit_many on another thread must see this one's occupancy
            # (alone, a sequential batch never exceeds one slot)
            out = []
            for q in queries:
                adm = self._try_admit()
                out.append(Overloaded(q, shed_reason) if adm is None else
                           self._admitted_submit(q, degrade=adm == "degrade"))
            return out
        pool = self._requests.pool(workers)
        # the pool only grows (in-flight submits may hold the old one), so a
        # smaller `workers` must be enforced here or a 4-wide pool would run
        # a workers=2 batch 4 wide — and misreport every thread-count sweep.
        # The gate is taken at SUBMISSION time (this thread blocks, not a
        # pool worker): parking excess tasks inside workers would occupy
        # pool threads and FIFO-starve a concurrent caller's batch
        gate = threading.Semaphore(workers)
        futures: List = []
        for q in queries:
            # shed BEFORE the worker-width gate: a full server must reject
            # immediately, not park the caller until a slot frees
            adm = self._try_admit()
            if adm is None:
                futures.append(Overloaded(q, shed_reason))
                continue
            gate.acquire()
            fut = pool.submit(self._admitted_submit, q,
                              degrade=adm == "degrade")
            fut.add_done_callback(lambda _f: gate.release())
            futures.append(fut)
        return [f if isinstance(f, Overloaded) else f.result()
                for f in futures]

    def serve(self, queries: Iterable, workers: Optional[int] = None) -> Dict:
        """Drive a traffic batch through ``submit_many`` and summarize it:
        ``{"reports", "seconds" (wall), "rps", "shed", "workers"}`` — the
        requests/sec figure ``benchmarks/fig_concurrent_serving.py`` tracks
        (``rps`` counts served requests only; ``shed`` says how many of this
        batch admission control rejected)."""
        t0 = time.perf_counter()
        reports = self.submit_many(queries, workers=workers)
        wall = time.perf_counter() - t0
        shed = sum(1 for r in reports if isinstance(r, Overloaded))
        return {"reports": reports, "seconds": wall,
                "rps": (len(reports) - shed) / max(wall, 1e-9),
                "shed": shed,
                "workers": workers or self.DEFAULT_REQUEST_WORKERS}
