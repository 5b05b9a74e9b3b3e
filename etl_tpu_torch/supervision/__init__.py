"""Supervision tree: liveness watchdogs, health state machine, circuit
breakers, and escalation policies (docs/supervision.md).

Every long-running component publishes cheap heartbeats carrying a
progress token; the Supervisor detects stalls (fresh heartbeat, frozen
progress) and hangs (stale heartbeat), drives the pipeline-wide
healthy → degraded → faulted state machine, and escalates: cancel-and-
restart through the existing RetryPolicy backoff, degrade the CUDA batch
engine to the host oracle, trip per-destination circuit breakers that
shed load into backpressure.

Copy of the reference's `etl_tpu/supervision/`. The degrade reaches the
port's own engine (`etl_tpu_torch.ops.engine.force_host_oracle`).
"""

from .breaker import BreakerState, CircuitBreaker
from .destination import BoundedAck, SupervisedDestination
from .health import HealthState, HealthStateMachine
from .heartbeat import (ComponentPolicy, Heartbeat, HeartbeatRegistry,
                        beat_while_waiting)
from .supervisor import DECODE_PREFIX, SupervisionEvent, Supervisor

__all__ = [
    "BoundedAck",
    "BreakerState",
    "CircuitBreaker",
    "ComponentPolicy",
    "DECODE_PREFIX",
    "HealthState",
    "HealthStateMachine",
    "Heartbeat",
    "HeartbeatRegistry",
    "SupervisedDestination",
    "SupervisionEvent",
    "Supervisor",
    "beat_while_waiting",
]
