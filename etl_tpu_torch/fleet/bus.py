"""One signal bus, three control loops as policy plugins.

Before the fleet, the pipeline's three feedback loops each owned a
private sampling path: autoscale read a SignalTimeline, admission read
lag gauges inside the scheduler, and the ack-window depth was a static
config knob. The bus unifies them behind the autoscale split —
sample (I/O) → decide (pure, `@control_loop`) → apply (actuation) —
so every loop consumes the SAME per-pipeline `SignalFrame` history and
every decision is a replayable function of it.

A plugin is three methods:

  sample(pipeline_id, frame)          I/O allowed — pull whatever extra
                                      evidence the decision needs (e.g.
                                      the ack-latency histogram);
  decide(pipeline_id, frames, obs,    PURE — `@control_loop`, no I/O,
         state) -> (action, state')   no clock (etl-lint rule 16);
                                      action None = hold;
  apply(pipeline_id, action)          actuation — drive the knob.

Shipping plugins:

  PidLagPolicy           PID on (aggregate lag − target): recommends a
                         target shard count per pipeline. The fleet
                         reconciler consumes recommendations as spec
                         resize suggestions — the PID never actuates
                         the orchestrator itself.
  AdaptiveAckDepthPolicy write-window depth from the MEASURED ack
                         latency (the etl_destination_ack_latency
                         histogram): depth ≈ mean_ack_latency /
                         flush_interval, clamped — deep enough to hide
                         the measured latency, no deeper. Applies via
                         `AckWindow.set_limit`.
  AdmissionWeightPolicy  per-tenant SLO weight = the spec quota's base
                         weight, boosted while the tenant's pipelines
                         hold backlog above a threshold — fed into
                         `AdmissionScheduler.set_slo_weight`.
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass

from ..analysis.annotations import control_loop
from ..autoscale.signals import SignalFrame, SignalTimeline
from .spec import MAX_SHARDS_PER_PIPELINE, FleetSpec


class FleetPolicyPlugin(abc.ABC):
    """The bus's plugin contract (module docstring). `decide` MUST be
    pure — decorate it `@control_loop`; sampling and actuation live in
    the other two phases."""

    name: str = "plugin"

    def sample(self, pipeline_id: int, frame: SignalFrame):
        """Optional extra evidence (I/O allowed). Default: nothing."""
        return None

    @abc.abstractmethod
    def decide(self, pipeline_id: int, frames: "tuple[SignalFrame, ...]",
               observation, state):
        """Pure decision: (action | None, new_state)."""

    def apply(self, pipeline_id: int, action) -> None:
        """Actuate. Default: recommendations-only plugins do nothing."""


class FleetSignalBus:
    """Per-pipeline frame fan-out to every registered plugin.

    `publish` records one pipeline's frame (tick-monotonic, same
    contract as the autoscale timeline); `step` runs every plugin over
    every pipeline that has history, threading per-(plugin, pipeline)
    decision state across calls. Returns the actions taken — the chaos
    scenario and tests assert on the trace."""

    def __init__(self, *, max_frames: int = 32):
        self._timelines: "dict[int, SignalTimeline]" = {}
        self._max_frames = max_frames
        self._plugins: "list[FleetPolicyPlugin]" = []
        self._state: "dict[tuple[str, int], object]" = {}
        self._spec = FleetSpec()

    def register(self, plugin: FleetPolicyPlugin) -> None:
        self._plugins.append(plugin)

    def bind_spec(self, spec: FleetSpec) -> None:
        """Give tenancy-aware plugins the current desired state (tenant
        of each pipeline, quota base weights)."""
        self._spec = spec

    @property
    def spec(self) -> FleetSpec:
        return self._spec

    def tenant_of(self, pipeline_id: int) -> "str | None":
        p = self._spec.by_id().get(pipeline_id)
        return p.tenant_id if p is not None else None

    def publish(self, pipeline_id: int, frame: SignalFrame) -> None:
        timeline = self._timelines.get(pipeline_id)
        if timeline is None:
            timeline = SignalTimeline(max_frames=self._max_frames)
            self._timelines[pipeline_id] = timeline
        timeline.record(frame)

    def drop(self, pipeline_id: int) -> None:
        """Forget a deleted pipeline's history and plugin state."""
        self._timelines.pop(pipeline_id, None)
        for plugin in self._plugins:
            self._state.pop((plugin.name, pipeline_id), None)

    def step(self) -> "list[dict]":
        actions: "list[dict]" = []
        for pipeline_id in sorted(self._timelines):
            frames = tuple(self._timelines[pipeline_id].frames)
            if not frames:
                continue
            latest = frames[-1]
            for plugin in self._plugins:
                key = (plugin.name, pipeline_id)
                observation = plugin.sample(pipeline_id, latest)
                action, new_state = plugin.decide(
                    pipeline_id, frames, observation,
                    self._state.get(key))
                self._state[key] = new_state
                if action is None:
                    continue
                plugin.apply(pipeline_id, action)
                actions.append({"plugin": plugin.name,
                                "pipeline_id": pipeline_id,
                                "action": action})
        return actions


# -- PID lag-target policy (carried from the autoscale roadmap) --------------


@dataclass(frozen=True)
class PidConfig:
    """PID gains over the lag error in BYTES, output in shards.
    Defaults are deliberately conservative: kp sized so ~64 MiB of
    sustained excess lag asks for one extra shard, ki an order of
    magnitude softer (wind-up clamped), kd damping tick-to-tick spikes."""

    target_lag_bytes: int = 8 * 1024 * 1024
    kp: float = 1.0 / (64 * 1024 * 1024)
    ki: float = 1.0 / (640 * 1024 * 1024)
    kd: float = 0.0
    integral_clamp: float = 4.0  # |ki * integral| ceiling, in shards
    min_shards: int = 1
    max_shards: int = MAX_SHARDS_PER_PIPELINE


@dataclass(frozen=True)
class PidState:
    integral: float = 0.0
    prev_error: float = 0.0


class PidLagPolicy(FleetPolicyPlugin):
    """PID-style lag-target controller: recommends `target_k` per
    pipeline. Deliberately recommendation-only — resize authority stays
    with the spec + reconciler (a PID that actuated directly would
    bypass quotas and the actuation journal)."""

    name = "pid_lag"

    def __init__(self, config: "PidConfig | None" = None):
        self.config = config or PidConfig()
        self.recommendations: "dict[int, int]" = {}

    @control_loop
    def decide(self, pipeline_id, frames, observation, state):
        cfg = self.config
        state = state or PidState()
        frame = frames[-1]
        current_k = max(1, frame.shard_count)
        error = float(frame.aggregate_backlog_bytes
                      - cfg.target_lag_bytes)
        integral = state.integral + error
        if cfg.ki > 0:  # anti-windup: clamp the integral TERM
            bound = cfg.integral_clamp / cfg.ki
            integral = max(-bound, min(bound, integral))
        derivative = error - state.prev_error
        effort = (cfg.kp * error + cfg.ki * integral
                  + cfg.kd * derivative)
        target = max(cfg.min_shards,
                     min(cfg.max_shards,
                         current_k + int(round(effort))))
        new_state = PidState(integral=integral, prev_error=error)
        if target == current_k:
            return None, new_state
        return {"target_k": target, "from_k": current_k}, new_state

    def apply(self, pipeline_id: int, action) -> None:
        self.recommendations[pipeline_id] = action["target_k"]


# -- adaptive ack-window depth (carried from the ack-window roadmap) ---------


@dataclass(frozen=True)
class AckDepthConfig:
    """Depth = ceil(mean_ack_latency / flush_interval) + 1: just enough
    in-flight writes to cover the measured destination round-trip at the
    apply loop's flush cadence. `min_samples` gates flapping on a cold
    histogram; a change smaller than one step is held."""

    flush_interval_s: float = 0.05
    min_depth: int = 1
    max_depth: int = 64
    min_samples: int = 8


class AdaptiveAckDepthPolicy(FleetPolicyPlugin):
    """Write-window depth from the measured ack-latency histogram.

    `window_of(pipeline_id)` must return the live AckWindow (or None) —
    the fleet wires the registry lookup in; tests pass a dict. Sampling
    reads (count, sum) from the shared telemetry registry's
    `etl_destination_ack_latency_seconds` histogram."""

    name = "ack_depth"

    def __init__(self, *, window_of, config: "AckDepthConfig | None" = None,
                 histogram_read=None):
        self.config = config or AckDepthConfig()
        self._window_of = window_of
        self._histogram_read = histogram_read  # () -> (count, sum) | None
        self.applied_depths: "dict[int, int]" = {}

    def sample(self, pipeline_id: int, frame: SignalFrame):
        if self._histogram_read is not None:
            return self._histogram_read()
        from ..telemetry.metrics import (
            ETL_DESTINATION_ACK_LATENCY_SECONDS, registry)

        return registry.get_histogram(ETL_DESTINATION_ACK_LATENCY_SECONDS,
                                      labels={"path": "apply"})

    @control_loop
    def decide(self, pipeline_id, frames, observation, state):
        cfg = self.config
        if not observation:
            return None, state
        count, total_s = observation
        if count < cfg.min_samples:
            return None, state
        mean_latency_s = total_s / count
        # the epsilon absorbs binary-float fenceposts: a mean that is
        # exactly N flush intervals must yield N, not ceil(N + 1e-16)
        depth = int(math.ceil(
            mean_latency_s / cfg.flush_interval_s - 1e-9)) + 1
        depth = max(cfg.min_depth, min(cfg.max_depth, depth))
        if state == depth:  # state IS the last applied depth
            return None, state
        return {"depth": depth, "mean_latency_s": mean_latency_s}, depth

    def apply(self, pipeline_id: int, action) -> None:
        self.applied_depths[pipeline_id] = action["depth"]
        window = self._window_of(pipeline_id)
        if window is not None:
            window.set_limit(action["depth"])


# -- admission SLO weights from quotas + live lag ----------------------------


@dataclass(frozen=True)
class AdmissionWeightConfig:
    """Boost a tenant's admission weight while its pipeline holds more
    than `boost_lag_bytes` of backlog — the scheduler clamps to its own
    max_weight envelope, so the boost can never starve other tenants."""

    boost_lag_bytes: int = 64 * 1024 * 1024
    boost: float = 2.0


class AdmissionWeightPolicy(FleetPolicyPlugin):
    """Feeds per-tenant SLO weights into the shared AdmissionScheduler:
    base weight from the fleet spec's TenantQuota, times the lag boost
    while the pipeline is behind."""

    name = "admission_weight"

    def __init__(self, bus: FleetSignalBus, *, scheduler=None,
                 config: "AdmissionWeightConfig | None" = None):
        self._bus = bus
        self._scheduler = scheduler
        self.config = config or AdmissionWeightConfig()
        self.applied_weights: "dict[str, float]" = {}

    def sample(self, pipeline_id: int, frame: SignalFrame):
        tenant = self._bus.tenant_of(pipeline_id)
        if tenant is None:
            return None
        quota = self._bus.spec.quotas.get(tenant)
        base = quota.slo_weight if quota is not None else 1.0
        return {"tenant": tenant, "base_weight": base}

    @control_loop
    def decide(self, pipeline_id, frames, observation, state):
        if observation is None:
            return None, state
        cfg = self.config
        frame = frames[-1]
        weight = observation["base_weight"]
        if frame.aggregate_backlog_bytes > cfg.boost_lag_bytes:
            weight *= cfg.boost
        if state is not None and abs(state - weight) < 1e-9:
            return None, state  # state IS the last applied weight
        return {"tenant": observation["tenant"], "weight": weight}, weight

    def apply(self, pipeline_id: int, action) -> None:
        scheduler = self._scheduler
        if scheduler is None:
            from ..ops.pipeline import global_admission

            scheduler = global_admission()
        scheduler.set_slo_weight(action["tenant"], action["weight"])
        self.applied_weights[action["tenant"]] = action["weight"]
