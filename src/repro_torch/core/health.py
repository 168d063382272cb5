"""Per-engine health tracking: circuit breakers + straggler watch.

The paper's monitor exists because "the plan that was optimal under
training-time conditions" stops being optimal when an engine slows or dies;
this module is the serving stack's account of that state.  One
``CircuitBreaker`` per engine follows the classic three-state protocol:

    CLOSED ──(failure_threshold consecutive failures)──> OPEN
    OPEN ──(cooldown elapses)──> HALF_OPEN
    HALF_OPEN ──(probe succeeds)──> CLOSED
    HALF_OPEN ──(probe fails)──> OPEN            (cooldown restarts)

While a breaker is OPEN its engine is *masked*: ``mask_for_request`` returns
it in the excluded set and the middleware re-runs the cheap planning DP with
that engine removed (failover re-planning — see ``BigDAWG._serve_masked``).
In HALF_OPEN exactly one request at a time is granted a *probe*: the engine
is left OUT of that request's mask, so the request is planned as if the
engine recovered (normally the cached incumbent plan).  Success closes the
breaker — and because masked serves were recorded under a mask-suffixed
signature, ``monitor.best`` still names the incumbent, which is therefore
restored verbatim.  Failure re-opens the breaker and the cooldown restarts.

Failures reach the breaker through two channels:

* the executor: an engine op or an input cast that dies with an
  infrastructure-shaped exception (``errors.is_engine_failure``) calls
  ``record_failure`` and re-raises as ``EngineDown``;
* the straggler watch: after every successful plan the middleware feeds the
  per-node seconds to ``after_plan``; a per-engine ``StragglerDetector``
  (Welford z-score over that engine's node times) flags pathological
  slowness, which counts as a breaker failure — a silently-slow engine trips
  the same way a crashing one does (timeout-equivalent).  Unflagged nodes
  count as successes and reset the consecutive-failure run.

The registry takes one lock around all state; every operation is O(engines)
dict work, so contention on the serve path is negligible.  ``time_fn`` is
injectable so breaker tests can step a fake clock through the cooldown.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from repro_torch.core.engines import ENGINES

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# engines the degrade path may still use: the "always-up" pair every island
# can reach (dense_array is the device-native home, columnar the relational
# one) — ``EngineHealth(always_up=...)`` overrides
DEFAULT_ALWAYS_UP = ("dense_array", "columnar")


@dataclass
class CircuitBreaker:
    """One engine's breaker.  NOT internally locked — every mutation happens
    under the owning ``EngineHealth`` registry lock."""
    engine: str
    failure_threshold: int = 3
    cooldown_s: float = 5.0
    state: str = CLOSED
    consecutive_failures: int = 0
    opened_at: float = 0.0
    trips: int = 0                    # lifetime CLOSED/HALF_OPEN -> OPEN count
    probe_inflight: bool = False      # HALF_OPEN: one probe grant at a time

    def poll(self, now: float) -> str:
        """Advance time-driven transitions (OPEN -> HALF_OPEN after the
        cooldown) and return the current state."""
        if self.state == OPEN and now - self.opened_at >= self.cooldown_s:
            self.state = HALF_OPEN
            self.probe_inflight = False
        return self.state

    def on_failure(self, now: float) -> bool:
        """Record one failure; returns True when this failure tripped the
        breaker open.  A HALF_OPEN probe failure re-opens immediately —
        the engine just proved it is still down."""
        self.consecutive_failures += 1
        if self.state == HALF_OPEN or (
                self.state == CLOSED
                and self.consecutive_failures >= self.failure_threshold):
            self.state = OPEN
            self.opened_at = now
            self.probe_inflight = False
            self.trips += 1
            return True
        return False

    def on_success(self):
        """Record one success: resets the consecutive-failure run and closes
        the breaker from HALF_OPEN (the probe came back healthy)."""
        self.consecutive_failures = 0
        if self.state == HALF_OPEN:
            self.state = CLOSED
            self.probe_inflight = False


class EngineHealth:
    """The per-engine breaker registry the serving stack consults.

    ``injector`` is an optional fault source with a
    ``before_op(engine, op)`` hook (see ``runtime.fault.EngineFaultInjector``)
    the executor fires before every engine op — the seam through which tests
    and benchmarks take an engine down mid-serve without touching engine
    code.

    Straggler defaults are deliberately conservative (``straggler_z=6``):
    node times on a healthy serve path vary with cache state and host load,
    and a false straggler trip would fail over AWAY from the fastest engine —
    strictly worse than tolerating a slow request.
    """

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0,
                 straggler_z: float = 6.0, straggler_warmup: int = 8,
                 straggler_min_s: float = 0.0,
                 always_up: Tuple[str, ...] = DEFAULT_ALWAYS_UP,
                 time_fn=time.monotonic, injector=None,
                 channels: Optional[Iterable[str]] = None):
        # ``channels`` overrides the default per-engine registry: the
        # procpool master tracks WORKER PROCESSES ("worker:0", ...) through
        # the same breaker protocol — a dead worker is an engine failure one
        # level up the stack
        self._failure_threshold = failure_threshold
        self._cooldown_s = cooldown_s
        names = tuple(channels) if channels is not None else tuple(ENGINES)
        self.breakers: Dict[str, CircuitBreaker] = {
            name: CircuitBreaker(name, failure_threshold, cooldown_s)
            for name in names}
        # built lazily per engine (StragglerDetector lives in runtime.fault;
        # importing it at module scope would couple core to runtime)
        self._stragglers: Dict[str, object] = {}
        self._straggler_z = straggler_z
        self._straggler_warmup = straggler_warmup
        # absolute floor under which a z-flagged node time is still NOT a
        # breaker failure: healthy node times have near-zero variance, so a
        # few ms of scheduler jitter can carry an enormous z-score — and a
        # false trip fails over AWAY from the fastest engine.  Set it around
        # the serving latency target; 0.0 keeps the pure-z behavior
        self._straggler_min_s = straggler_min_s
        self._steps: Dict[str, int] = {name: 0 for name in names}
        self.always_up = tuple(always_up)
        self.time_fn = time_fn
        self.injector = injector
        # optional runtime.telemetry.Metrics; the owning BigDAWG wires it so
        # breaker trips land in the shared registry ("health.breaker_trips")
        self.metrics = None
        self._lock = threading.Lock()

    # -- registry management ------------------------------------------------
    def ensure_channel(self, name: str):
        """Add a breaker channel on demand (procpool worker respawns can
        mint fresh channel names); a no-op when it already exists."""
        with self._lock:
            if name not in self.breakers:
                self.breakers[name] = CircuitBreaker(
                    name, self._failure_threshold, self._cooldown_s)
                self._steps[name] = 0

    def reset(self, name: str):
        """Force a channel back to CLOSED with a clean failure run — used
        after a worker respawn: the REPLACEMENT process is healthy, and
        making it re-earn trust through the half-open probe would shed
        requests at a fully recovered worker."""
        with self._lock:
            br = self.breakers[name]
            br.state = CLOSED
            br.consecutive_failures = 0
            br.probe_inflight = False

    # -- executor-facing hooks ---------------------------------------------
    def before_op(self, engine: str, op: str = ""):
        """Fired by the executor just before running ``op`` on ``engine`` —
        the fault-injection seam.  May raise (a raised ``SimulatedFailure``
        is classified as an engine failure and fed back to the breaker by
        the executor's failure path)."""
        if self.injector is not None:
            self.injector.before_op(engine, op)

    def record_failure(self, engine: str) -> bool:
        """One engine failure (op or cast).  Returns True when it tripped
        the breaker open."""
        with self._lock:
            br = self.breakers[engine]
            br.poll(self.time_fn())
            tripped = br.on_failure(self.time_fn())
        if tripped:
            self._note_trip(engine)
        return tripped

    def _note_trip(self, engine: str):
        """Mirror a breaker trip into the metrics registry (no-op until the
        owning middleware wires ``self.metrics``).  Called OUTSIDE
        ``self._lock``: metrics takes its own lock."""
        if self.metrics is not None:
            self.metrics.counter("health.breaker_trips")

    def record_success(self, engine: str):
        with self._lock:
            br = self.breakers[engine]
            br.poll(self.time_fn())
            br.on_success()

    # -- middleware-facing hooks -------------------------------------------
    def mask_for_request(self) -> Tuple[FrozenSet[str], Tuple[str, ...]]:
        """``(masked_engines, probe_grants)`` for one request.

        OPEN engines are masked.  A HALF_OPEN engine with no probe in flight
        is granted to THIS request (left unmasked, returned in
        ``probe_grants``) — the request serves as the recovery probe; its
        success/failure decides the breaker, and the caller must
        ``release_probes`` when done.  Other requests see a HALF_OPEN engine
        as still masked, so at most one request at a time risks the maybe-
        dead engine."""
        masked: List[str] = []
        probes: List[str] = []
        now = self.time_fn()
        with self._lock:
            for name, br in self.breakers.items():
                state = br.poll(now)
                if state == OPEN:
                    masked.append(name)
                elif state == HALF_OPEN:
                    if br.probe_inflight:
                        masked.append(name)
                    else:
                        br.probe_inflight = True
                        probes.append(name)
        return frozenset(masked), tuple(probes)

    def release_probes(self, probes: Iterable[str]):
        """Return probe grants (called from the request's ``finally``): a
        probe whose request neither succeeded nor failed on the engine (the
        plan never touched it) goes back to grantable HALF_OPEN."""
        with self._lock:
            for name in probes:
                br = self.breakers[name]
                if br.state == HALF_OPEN:
                    br.probe_inflight = False

    def degrade_mask(self) -> FrozenSet[str]:
        """The graceful-degradation mask: every engine EXCEPT the always-up
        set — what an overloaded server plans with before shedding."""
        return frozenset(n for n in self.breakers if n not in self.always_up)

    def after_plan(self, engine_seconds: Iterable[Tuple[str, float]]):
        """Feed one successful plan's per-node ``(engine, seconds)`` pairs:
        each engine's node times go through its straggler detector; a
        flagged node counts as a breaker failure for that engine (slow ==
        down, eventually), an unflagged run counts as a success."""
        per_engine: Dict[str, List[float]] = {}
        for engine, secs in engine_seconds:
            per_engine.setdefault(engine, []).append(secs)
        tripped: List[str] = []
        with self._lock:
            now = self.time_fn()
            for engine, times in per_engine.items():
                det = self._straggler(engine)
                flagged = False
                for secs in times:
                    step = self._steps[engine]
                    self._steps[engine] += 1
                    # a z-flagged observation is excluded from the Welford
                    # stats either way; it only counts as a breaker failure
                    # above the absolute floor
                    if det.observe(step, secs) and \
                            secs >= self._straggler_min_s:
                        flagged = True
                br = self.breakers[engine]
                br.poll(now)
                if flagged:
                    if br.on_failure(now):
                        tripped.append(engine)
                else:
                    br.on_success()
        for engine in tripped:
            self._note_trip(engine)

    def _straggler(self, engine: str):
        det = self._stragglers.get(engine)
        if det is None:
            # the detector lives in runtime/fault.py, not ported yet
            raise NotImplementedError(
                "straggler detection needs runtime/fault.py, which is not "
                "ported yet (ROADMAP queue 1, 'Serving stack')")
        return det

    # -- introspection ------------------------------------------------------
    def state(self, engine: str) -> str:
        with self._lock:
            return self.breakers[engine].poll(self.time_fn())

    def trips(self) -> int:
        """Lifetime breaker trips summed over engines — the
        ``stats["breaker_trips"]`` figure."""
        with self._lock:
            return sum(br.trips for br in self.breakers.values())

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Current breaker states for stats/debugging — also the persistence
        payload ``restore`` consumes (the middleware writes it beside the
        monitor DB on ``persist()``)."""
        now = self.time_fn()
        with self._lock:
            return {name: {"state": br.poll(now), "trips": br.trips,
                           "consecutive_failures": br.consecutive_failures}
                    for name, br in self.breakers.items()}

    def restore(self, channels: Dict[str, Dict[str, object]]):
        """Adopt a persisted ``snapshot()``: a restarted process must not
        re-burn a full failure budget rediscovering an outage it already
        paid to learn about.  CLOSED channels restore verbatim.  OPEN and
        HALF_OPEN both restore as OPEN with the cooldown restarted from NOW
        — the wall-clock gap since the snapshot is unknowable under an
        injectable monotonic clock, and an engine that recovered meanwhile
        re-earns trust through one half-open probe after the cooldown (the
        cheap direction to be wrong in).  Probe grants never persist: the
        granted request died with the old process.  Unknown channels are
        created on demand (procpool worker channels); malformed entries are
        skipped."""
        now = self.time_fn()
        for name, blob in channels.items():
            if not isinstance(blob, dict):
                continue
            self.ensure_channel(str(name))
            with self._lock:
                br = self.breakers[str(name)]
                state = blob.get("state")
                if state not in (CLOSED, OPEN, HALF_OPEN):
                    continue
                br.state = OPEN if state in (OPEN, HALF_OPEN) else CLOSED
                br.opened_at = now if br.state == OPEN else 0.0
                br.probe_inflight = False
                try:
                    br.trips = max(0, int(blob.get("trips", 0)))
                    br.consecutive_failures = max(0, int(
                        blob.get("consecutive_failures", 0)))
                except (TypeError, ValueError):
                    br.trips, br.consecutive_failures = br.trips, 0
