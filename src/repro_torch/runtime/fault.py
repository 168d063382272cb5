"""Fault-tolerance primitives: failure injection + straggler detection.

On a real cluster the failure signal is a missing heartbeat from a worker;
here ``FailureInjector`` raises at configured steps so the restart path is
exercised end-to-end in tests.  ``StragglerDetector`` watches step times — on
detection the caller notifies the monitor (the BigDAWG drift path: the plan
that was optimal under training-time conditions is re-evaluated).

The port of ``repro.runtime.fault`` (pure Python, copied).
"""
from __future__ import annotations

import math
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set


class SimulatedFailure(RuntimeError):
    # injected faults stand in for real infrastructure failures, so the
    # executor's errors.is_engine_failure classifier must treat them as
    # breaker-feedable (unlike, say, a KeyError from a bad query)
    engine_failure = True


@dataclass
class FailureInjector:
    fail_at_steps: Set[int] = field(default_factory=set)
    _fired: Set[int] = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


class EngineFaultInjector:
    """Engine-level fault source for the resilience path: plugged into
    ``core.health.EngineHealth(injector=...)``, its ``before_op`` hook fires
    in the executor just before every engine op, so a benchmark or test can
    take an engine down (or make it pathologically slow) MID-SERVE without
    touching engine code.

        inj = EngineFaultInjector()
        health = EngineHealth(injector=inj)
        ...
        inj.fail_engine("kv_sparse")          # ops now raise SimulatedFailure
        inj.slow_engine("dense_array", 0.05)  # ops now sleep 50 ms first
        inj.recover("kv_sparse")              # back to healthy

    Thread-safe: the serve path reads the fault maps under the same lock the
    control calls mutate them under."""

    def __init__(self):
        self._down: Set[str] = set()
        self._slow: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.faults_fired = 0

    def fail_engine(self, engine: str):
        with self._lock:
            self._down.add(engine)

    def slow_engine(self, engine: str, seconds: float):
        with self._lock:
            self._slow[engine] = seconds

    def recover(self, engine: str):
        with self._lock:
            self._down.discard(engine)
            self._slow.pop(engine, None)

    def before_op(self, engine: str, op: str = ""):
        with self._lock:
            down = engine in self._down
            delay = self._slow.get(engine, 0.0)
            if down or delay:
                self.faults_fired += 1
        if down:
            raise SimulatedFailure(
                f"injected outage on engine {engine!r}"
                + (f" (op {op!r})" if op else ""))
        if delay:
            time.sleep(delay)


class FusionFaultInjector:
    """Fused-segment fault source for plan-level fusion: plugged into
    ``BigDAWG(fusion_injector=...)``, its ``on_fuse`` hook fires in the
    executor just before every fused-segment invocation — the seam where a
    real capture failure would surface — so tests can force the
    fused->unfused fallback MID-SERVE and assert it is sticky per segment
    signature (``fired`` records each key the injector hit).

        inj = FusionFaultInjector()
        bd = BigDAWG(fusion_injector=inj)
        ...
        inj.arm(1)          # next fused invocation raises SimulatedFailure

    The raise lands inside the executor's per-segment fallback guard, so the
    serve completes unfused with identical results and the segment key is
    marked broken (``fuseplan.mark_broken``) — it never becomes an
    ``EngineDown``.  Thread-safe; disarmed (``fail_next=0``) by default."""

    def __init__(self, fail_next: int = 0):
        self._fail_next = fail_next
        self._lock = threading.Lock()
        self.fired: List[str] = []        # segment keys hit, in order

    def arm(self, n: int = 1) -> None:
        """Fail the next ``n`` fused invocations."""
        with self._lock:
            self._fail_next = n

    def on_fuse(self, key: str) -> None:
        with self._lock:
            if self._fail_next <= 0:
                return
            self._fail_next -= 1
            self.fired.append(key)
        raise SimulatedFailure(
            f"injected fused-segment compile failure for {key!r}")


class WorkerKillInjector:
    """Process-level fault source for the multi-process pool: plugged into
    ``core.procpool.ProcPool(kill_injector=...)``, its ``on_dispatch`` hook
    fires in the master right after an execute request is written to a
    worker's pipe — SIGKILL at that instant lands MID-REQUEST, the hardest
    point in the RPC lifecycle (the message may or may not have been picked
    up; either way the master must detect the death, respawn, and retry or
    surface a clean ``EngineDown``, never hang).

        inj = WorkerKillInjector(kill_on_dispatch=3)   # 3rd execute dispatch
        pool = ProcPool(2, kill_injector=inj)

    ``target_worker`` restricts the kill to one worker index; ``kills``
    counts delivered signals.  One-shot by default (``repeat=False``)."""

    def __init__(self, kill_on_dispatch: int = 1,
                 target_worker: Optional[int] = None, repeat: bool = False):
        self.kill_on_dispatch = kill_on_dispatch
        self.target_worker = target_worker
        self.repeat = repeat
        self.kills = 0
        self._count = 0
        self._lock = threading.Lock()

    def on_dispatch(self, widx: int, pid: int) -> None:
        with self._lock:
            if self.target_worker is not None and widx != self.target_worker:
                return
            self._count += 1
            due = (self._count == self.kill_on_dispatch if not self.repeat
                   else self._count % self.kill_on_dispatch == 0)
            if not due:
                return
            self.kills += 1
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass                           # already gone — death still lands


@dataclass
class StragglerDetector:
    """Welford running stats over step times; z-score threshold flags
    stragglers (slow steps) for plan re-selection / replacement."""
    z_threshold: float = 3.0
    warmup: int = 5
    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    flagged: List[int] = field(default_factory=list)
    on_straggler: Optional[Callable[[int, float], None]] = None

    def observe(self, step: int, seconds: float) -> bool:
        if self.n >= self.warmup:
            std = math.sqrt(self.m2 / max(self.n - 1, 1))
            if std > 0 and (seconds - self.mean) / std > self.z_threshold:
                self.flagged.append(step)
                if self.on_straggler:
                    self.on_straggler(step, seconds)
                return True              # straggler: exclude from stats
        self.n += 1
        d = seconds - self.mean
        self.mean += d / self.n
        self.m2 += d * (seconds - self.mean)
        return False
