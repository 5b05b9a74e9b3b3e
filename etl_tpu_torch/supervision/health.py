"""Pipeline-wide health state machine: healthy → degraded → faulted.

The machine is reason-driven rather than edge-driven: anomaly sources
(the supervisor's stall/hang detections, non-closed circuit breakers,
the forced host-oracle degrade, memory backpressure) `set_reason` while
the condition holds and `clear_reason` when it lifts; the state is
recomputed as

    faulted    — a fatal was recorded (`fault()`): the apply worker
                 exhausted its retries or died with a permanent error.
                 Sticky until `reset()` (a restarted pipeline starts a
                 fresh machine).
    degraded   — at least one active anomaly reason.
    healthy    — no reasons.

`/health` serves this state (503 on faulted); `/health/detail` adds the
live reasons and the transition history. Listeners observe every
transition — the chaos runner uses one to assert a scenario's
healthy → degraded → healthy arc.

Copy of the reference's `etl_tpu/supervision/health.py`.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    FAULTED = "faulted"


#: gauge encoding for ETL_PIPELINE_HEALTH_STATE
_STATE_VALUE = {HealthState.HEALTHY: 0, HealthState.DEGRADED: 1,
                HealthState.FAULTED: 2}

_HISTORY_CAP = 64


class HealthStateMachine:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.state = HealthState.HEALTHY
        self.since = time.monotonic()
        self._reasons: dict[str, str] = {}
        self._fatal: str | None = None
        self._listeners: list[Callable[[HealthState, HealthState, str], None]] = []
        self.transitions: list[tuple[str, str, float]] = []  # (state, why, t)

    # -- inputs --------------------------------------------------------------

    def set_reason(self, key: str, detail: str) -> None:
        with self._lock:
            self._reasons[key] = detail
        self._recompute(detail)

    def clear_reason(self, key: str) -> None:
        with self._lock:
            existed = self._reasons.pop(key, None) is not None
        if existed:
            self._recompute(f"cleared: {key}")

    def fault(self, detail: str) -> None:
        with self._lock:
            self._fatal = detail
        self._recompute(detail)

    def reset(self) -> None:
        with self._lock:
            self._fatal = None
            self._reasons.clear()
        self._recompute("reset")

    def add_listener(
            self, cb: Callable[[HealthState, HealthState, str], None]) -> None:
        self._listeners.append(cb)

    # -- state ---------------------------------------------------------------

    def _recompute(self, why: str) -> None:
        with self._lock:
            if self._fatal is not None:
                new = HealthState.FAULTED
            elif self._reasons:
                new = HealthState.DEGRADED
            else:
                new = HealthState.HEALTHY
            old = self.state
            if new is old:
                return
            self.state = new
            self.since = time.monotonic()
            self.transitions.append((new.value, why, self.since))
            del self.transitions[:-_HISTORY_CAP]
            listeners = list(self._listeners)
        from ..telemetry.metrics import ETL_PIPELINE_HEALTH_STATE, registry

        registry.gauge_set(ETL_PIPELINE_HEALTH_STATE, _STATE_VALUE[new])
        for cb in listeners:
            cb(old, new, why)

    @property
    def reasons(self) -> dict[str, str]:
        with self._lock:
            return dict(self._reasons)

    @property
    def fatal(self) -> str | None:
        return self._fatal

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state.value,
                "since_s_ago": round(time.monotonic() - self.since, 3),
                "reasons": dict(self._reasons),
                "fatal": self._fatal,
                "transitions": [
                    {"state": s, "why": w} for s, w, _ in self.transitions],
            }
