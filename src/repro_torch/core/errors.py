"""The BigDAWG error taxonomy — one structured exception family for the
whole serving stack, so callers can react to *categories* of failure
instead of string-matching messages:

    BigDAWGError                 every error the polystore itself raises
     ├── QueryParseError         the textual qlang query did not parse
     ├── EngineDown              an engine op / cast failed or was tripped
     ├── PlanInfeasible          no engine assignment exists under the
     │                           current health mask (every candidate of
     │                           some op is on a tripped engine)
     └── Overloaded              admission control shed the request (also
                                 used as the in-order result slot for shed
                                 batch requests — never executed)

Anything NOT in this family (``KeyError`` on a bad column name, a
``TypeError`` from malformed attrs) is a *query* error: it propagates
unchanged and is never fed to the circuit breakers, because failing over a
buggy query to another engine would just fail there too.

``is_engine_failure`` draws that line for the executor: an exception
counts as an engine failure — breaker-feedable, failover-worthy — when it
is infrastructure-shaped (timeouts, connection loss) or explicitly marked
with an ``engine_failure = True`` class attribute (how
``runtime.fault.SimulatedFailure`` opts injected faults in without a
core -> runtime import).
"""
from __future__ import annotations

from typing import Optional, Tuple


class BigDAWGError(Exception):
    """Base of every error the polystore middleware raises on purpose."""


class QueryParseError(BigDAWGError, ValueError):
    """A qlang query failed to parse; the message carries the offset and a
    caret-annotated excerpt of the source text.  (Also a ``ValueError`` so
    pre-taxonomy ``except ValueError`` callers keep working.)"""


class EngineDown(BigDAWGError):
    """An engine op (or an input cast onto it) failed on ``engine`` —
    either a real exception classified as an engine failure, or the
    engine's circuit breaker rejecting work.  The middleware catches this
    and fails over: re-plans with the engine masked and retries."""

    def __init__(self, engine: str, op: str = "",
                 cause: Optional[BaseException] = None):
        self.engine = engine
        self.op = op
        self.cause = cause
        detail = f" running {op!r}" if op else ""
        tail = f": {cause!r}" if cause is not None else ""
        super().__init__(f"engine {engine!r} failed{detail}{tail}")


class PlanInfeasible(BigDAWGError):
    """No executable plan exists: some op's entire candidate engine set is
    masked (tripped breakers / a degrade mask).  Nothing was executed."""

    def __init__(self, op: str, island: str, masked: Tuple[str, ...] = ()):
        self.op = op
        self.island = island
        self.masked = tuple(masked)
        super().__init__(
            f"no engine can run {island}.{op}: every candidate is masked "
            f"({', '.join(self.masked) or 'none listed'})")


class Overloaded(BigDAWGError):
    """Admission control rejected the request without executing it — the
    bounded/adaptive shedding path.  Instances double as the in-order
    result slots ``QueryServer.submit_many`` returns for shed requests
    (the pre-taxonomy ``Shed`` sentinel, which remains importable as a
    deprecated alias), so ``query`` carries exactly what was dropped for
    the caller to retry."""

    # mirrors Report/Result.status so a mixed submit_many result list can be
    # partitioned on one attribute: r.status in ("ok", "degraded", "shed")
    status = "shed"

    def __init__(self, query=None, reason: str = "max_pending"):
        self.query = query
        self.reason = reason
        super().__init__(f"request shed ({reason})")


def is_engine_failure(exc: BaseException) -> bool:
    """Should this exception feed the engine's circuit breaker (True), or
    is it a query bug that would fail identically anywhere (False)?"""
    if getattr(exc, "engine_failure", False):
        return True
    return isinstance(exc, (TimeoutError, ConnectionError, BrokenPipeError))
