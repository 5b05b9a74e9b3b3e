"""Per-destination circuit breaker: closed → open → half-open → closed.

A dead or drowning sink must shed load into backpressure instead of
queuing unbounded work: after `failure_threshold` CONSECUTIVE write
failures the breaker opens and every call fails fast with
EtlError(DESTINATION_UNAVAILABLE) — no payload reaches the sink, the
apply worker's RetryPolicy backoff becomes the pacing, and WAL intake
pauses with it (the walsender buffers upstream). After `cooldown_s` one
trial call is admitted (half-open); its success closes the breaker, its
failure re-opens it for another cooldown.

DESTINATION_UNAVAILABLE is worker-retryable (re-stream after backoff)
but never writer-retryable in place — an in-place retry against an open
breaker would just spin the fast-fail.

Copy of the reference's `etl_tpu/supervision/breaker.py`.
"""

from __future__ import annotations

import enum
import time

from ..models.errors import ErrorKind, EtlError


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


def breaker_is_open(destination) -> bool:
    """True when `destination` (usually a SupervisedDestination) carries
    a circuit breaker in the OPEN (shedding) state. Plain destinations
    have no breaker. THE shared probe for dispatch gating
    (runtime/apply_loop.py) and poison-isolation abort
    (runtime/poison.py) — one definition of "the sink is being shed"."""
    breaker = getattr(destination, "breaker", None)
    if breaker is None:
        return False
    return getattr(breaker, "state", None) is BreakerState.OPEN


#: gauge encoding for ETL_DESTINATION_BREAKER_STATE
_STATE_VALUE = {BreakerState.CLOSED: 0, BreakerState.HALF_OPEN: 1,
                BreakerState.OPEN: 2}


class CircuitBreaker:
    def __init__(self, name: str = "destination", *,
                 failure_threshold: int = 5, cooldown_s: float = 15.0,
                 on_transition=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.opens_total = 0
        self._trial_in_flight = False
        self._on_transition = on_transition  # (old, new) -> None

    # -- gate ----------------------------------------------------------------

    def before_call(self) -> None:
        """Admission control; raises when the call must be shed."""
        if self.state is BreakerState.CLOSED:
            return
        now = time.monotonic()
        if self.state is BreakerState.OPEN:
            if now - self.opened_at < self.cooldown_s:
                raise EtlError(
                    ErrorKind.DESTINATION_UNAVAILABLE,
                    f"circuit breaker {self.name!r} open "
                    f"({self.consecutive_failures} consecutive failures; "
                    f"retry in "
                    f"{self.cooldown_s - (now - self.opened_at):.1f}s)")
            self._transition(BreakerState.HALF_OPEN)
        # half-open: admit exactly one trial at a time
        if self._trial_in_flight:
            raise EtlError(
                ErrorKind.DESTINATION_UNAVAILABLE,
                f"circuit breaker {self.name!r} half-open with a trial "
                f"call already in flight")
        self._trial_in_flight = True

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._trial_in_flight = False
        if self.state is not BreakerState.CLOSED:
            self._transition(BreakerState.CLOSED)

    def abort_call(self) -> None:
        """The admitted call ended without a verdict (cancelled mid-
        flight by a worker restart, or its ack was abandoned): release
        the half-open trial slot so the NEXT call can trial — without
        this a cancelled trial wedges the breaker open forever."""
        self._trial_in_flight = False

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state is BreakerState.HALF_OPEN:
            self._trial_in_flight = False
            self._open()
        elif self.state is BreakerState.CLOSED \
                and self.consecutive_failures >= self.failure_threshold:
            self._open()

    def _open(self) -> None:
        self.opened_at = time.monotonic()
        self.opens_total += 1
        from ..telemetry.metrics import (
            ETL_DESTINATION_BREAKER_OPENS_TOTAL, registry)

        registry.counter_inc(ETL_DESTINATION_BREAKER_OPENS_TOTAL,
                             labels={"breaker": self.name})
        self._transition(BreakerState.OPEN)

    def _transition(self, new: BreakerState) -> None:
        old, self.state = self.state, new
        from ..telemetry.metrics import (ETL_DESTINATION_BREAKER_STATE,
                                         registry)

        registry.gauge_set(ETL_DESTINATION_BREAKER_STATE, _STATE_VALUE[new],
                           {"breaker": self.name})
        if self._on_transition is not None and old is not new:
            self._on_transition(old, new)

    def snapshot(self) -> dict:
        return {
            "state": self.state.value,
            "consecutive_failures": self.consecutive_failures,
            "opens_total": self.opens_total,
            "cooldown_s": self.cooldown_s,
        }
