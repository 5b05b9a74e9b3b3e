"""The supervisor: a periodic sweep over every component's heartbeat,
driving detections, escalations, and the health state machine.

Detection (per component, per sweep):

  hang   — heartbeat age exceeded the hang deadline: the task/thread
           stopped beating entirely (wedged await, blocked thread);
  stall  — heartbeat fresh, `busy=True`, progress token frozen past the
           stall deadline: alive but stuck (a flush that never acks, an
           apply loop whose durable LSN stopped advancing).

Escalation:

  restart — restartable components get their `on_restart` callback
            invoked (rate-limited by `restart_backoff_s`); the owning
            worker converts that into EtlError(STALL_DETECTED), which
            classifies TIMED, so recovery rides the existing RetryPolicy
            backoff and re-streams from durable progress;
  degrade — `device_degrade_threshold` detections on decode components
            force the batch engine to the host oracle for
            `device_degrade_cooldown_s` (ops/engine.force_host_oracle):
            a flaky device link costs throughput, not availability;
  breaker — destination breakers are polled; a non-closed breaker holds
            a degraded reason (the breaker itself is tripped inline by
            SupervisedDestination on write failures).

Every detection/escalation emits a SupervisionEvent to listeners (the
chaos runner budgets re-delivery from restart events) and a labeled
metric counter.

Copy of the reference's `etl_tpu/supervision/supervisor.py`; `ops.engine`
is the port's engine, so the degrade parks the CUDA engine's decoders on
the host oracle (each degraded batch counts in the oracle-routed rows).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Callable

from ..config.pipeline import SupervisionConfig
from .breaker import BreakerState, CircuitBreaker
from .health import HealthStateMachine
from .heartbeat import ComponentPolicy, Heartbeat, HeartbeatRegistry

logger = logging.getLogger("etl_tpu_torch.supervision")

#: component-name prefix that marks decode pipelines (device-side work):
#: their detections count toward the host-oracle degrade escalation
DECODE_PREFIX = "decode:"


@dataclass(frozen=True)
class SupervisionEvent:
    kind: str  # "stall" | "hang" | "restart" | "breaker" | "degrade"
    component: str
    detail: str
    at: float = field(default_factory=time.monotonic)


class Supervisor:
    """One per pipeline. `start()` spawns the sweep task on the running
    loop; components register through `self.registry` (or the `register`
    convenience that fills deadline defaults from config)."""

    def __init__(self, config: SupervisionConfig | None = None):
        self.config = config or SupervisionConfig()
        self.registry = HeartbeatRegistry()
        self.health = HealthStateMachine()
        self.breakers: dict[str, CircuitBreaker] = {}
        self.events: list[SupervisionEvent] = []
        self._listeners: list[Callable[[SupervisionEvent], None]] = []
        self._task: asyncio.Task | None = None
        self._last_restart: dict[str, float] = {}
        self._device_detections = 0
        self.started = False

    # -- wiring --------------------------------------------------------------

    def register(self, name: str, *, stall_deadline_s: float | None = None,
                 hang_deadline_s: float | None = None,
                 restartable: bool = False,
                 hang_requires_busy: bool | None = None,
                 on_restart: Callable[[], None] | None = None) -> Heartbeat:
        if hang_requires_busy is None:
            # work-driven by default for decode pipelines + destination:
            # they beat only when work flows
            hang_requires_busy = name.startswith(DECODE_PREFIX) \
                or name == "destination"
        policy = ComponentPolicy(
            stall_deadline_s=stall_deadline_s,
            hang_deadline_s=hang_deadline_s,
            restartable=restartable,
            hang_requires_busy=hang_requires_busy)
        return self.registry.register(name, policy, on_restart=on_restart)

    def breaker(self, name: str) -> CircuitBreaker:
        """Get-or-create the named destination breaker (thresholds from
        config); its transitions feed health + events."""
        b = self.breakers.get(name)
        if b is None:
            b = CircuitBreaker(
                name,
                failure_threshold=self.config.breaker_failure_threshold,
                cooldown_s=self.config.breaker_cooldown_s,
                on_transition=lambda old, new, _n=name:
                    self._on_breaker_transition(_n, old, new))
            self.breakers[name] = b
        return b

    def add_listener(self, cb: Callable[[SupervisionEvent], None]) -> None:
        self._listeners.append(cb)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self.started = True
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        interval = self.config.check_interval_s
        while True:
            try:
                self.sweep_once()
            except Exception:  # the watchdog must outlive its own bugs; CancelledError is BaseException, passes through
                logger.exception("supervision sweep failed")
            await asyncio.sleep(interval)

    # -- the sweep -----------------------------------------------------------

    def sweep_once(self) -> list[SupervisionEvent]:
        """One detection pass; returns the events it emitted (tests and
        the sweep task both call this)."""
        from ..telemetry.metrics import (ETL_HEARTBEAT_MAX_AGE_SECONDS,
                                         registry)

        cfg = self.config
        now = time.monotonic()
        emitted: list[SupervisionEvent] = []
        max_age = 0.0
        components = self.registry.components()
        for hb in components:
            age = hb.age(now)
            max_age = max(max_age, age)
            hang_deadline = hb.policy.hang_deadline_s \
                if hb.policy.hang_deadline_s is not None \
                else cfg.hang_deadline_s
            stall_deadline = hb.policy.stall_deadline_s \
                if hb.policy.stall_deadline_s is not None \
                else cfg.stall_deadline_s
            if age > hang_deadline \
                    and (hb.busy or not hb.policy.hang_requires_busy):
                emitted += self._detected(
                    "hang", hb,
                    f"heartbeat stale {age:.2f}s > {hang_deadline:.2f}s")
            elif hb.busy and hb.progress_age(now) > stall_deadline:
                emitted += self._detected(
                    "stall", hb,
                    f"busy with progress frozen "
                    f"{hb.progress_age(now):.2f}s > {stall_deadline:.2f}s "
                    f"at {hb.progress!r}")
            else:
                self.health.clear_reason(f"component:{hb.name}")
        # a component that unregistered (worker exit, pipeline close)
        # takes its anomaly with it — otherwise a restarted worker's old
        # reason pins the machine degraded forever
        active = {f"component:{hb.name}" for hb in components}
        for key in self.health.reasons:
            if key.startswith("component:") and key not in active:
                self.health.clear_reason(key)
        for name, b in self.breakers.items():
            if b.state is BreakerState.CLOSED:
                self.health.clear_reason(f"breaker:{name}")
            else:
                self.health.set_reason(
                    f"breaker:{name}", f"breaker {b.state.value} after "
                    f"{b.consecutive_failures} consecutive failures")
        registry.gauge_set(ETL_HEARTBEAT_MAX_AGE_SECONDS, max_age)
        # the device-degrade reason lifts itself once the cooldown lapses
        if "device-degraded" in self.health.reasons:
            from ..ops import engine

            if not engine.host_oracle_forced():
                self.health.clear_reason("device-degraded")
        return emitted

    def _detected(self, kind: str, hb: Heartbeat,
                  detail: str) -> list[SupervisionEvent]:
        from ..ops import engine
        from ..telemetry.metrics import (ETL_SUPERVISION_EVENTS_TOTAL,
                                         ETL_SUPERVISION_RESTARTS_TOTAL,
                                         registry)

        out = [self._emit(SupervisionEvent(kind, hb.name, detail))]
        registry.counter_inc(ETL_SUPERVISION_EVENTS_TOTAL,
                             labels={"kind": kind, "component": hb.name})
        self.health.set_reason(f"component:{hb.name}",
                               f"{kind}: {detail}")
        logger.warning("supervision %s on %s: %s", kind, hb.name, detail)
        if hb.name.startswith(DECODE_PREFIX):
            self._device_detections += 1
            if self._device_detections >= self.config.device_degrade_threshold:
                self._device_detections = 0
                cooldown = self.config.device_degrade_cooldown_s
                engine.force_host_oracle(cooldown)
                self.health.set_reason(
                    "device-degraded",
                    f"batch engine degraded to host oracle for "
                    f"{cooldown:.0f}s after repeated device-side stalls")
                out.append(self._emit(SupervisionEvent(
                    "degrade", hb.name,
                    f"host-oracle degrade for {cooldown:.0f}s")))
        if hb.policy.restartable and hb.on_restart is not None:
            now = time.monotonic()
            last = self._last_restart.get(hb.name, -1e9)
            if now - last >= self.config.restart_backoff_s:
                self._last_restart[hb.name] = now
                hb.reset_clocks()
                registry.counter_inc(ETL_SUPERVISION_RESTARTS_TOTAL,
                                     labels={"component": hb.name})
                out.append(self._emit(SupervisionEvent(
                    "restart", hb.name, f"cancel-and-restart after {kind}")))
                hb.on_restart()
        return out

    def _emit(self, ev: SupervisionEvent) -> SupervisionEvent:
        self.events.append(ev)
        del self.events[:-256]
        for cb in list(self._listeners):
            cb(ev)
        return ev

    def _on_breaker_transition(self, name: str, old: BreakerState,
                               new: BreakerState) -> None:
        self._emit(SupervisionEvent(
            "breaker", name, f"{old.value} -> {new.value}"))
        if new is BreakerState.CLOSED:
            self.health.clear_reason(f"breaker:{name}")
        else:
            self.health.set_reason(f"breaker:{name}",
                                   f"breaker {new.value}")

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "started": self.started,
            "health": self.health.snapshot(),
            "components": self.registry.snapshot(),
            "breakers": {n: b.snapshot() for n, b in self.breakers.items()},
            "recent_events": [
                {"kind": e.kind, "component": e.component,
                 "detail": e.detail} for e in self.events[-16:]],
        }
