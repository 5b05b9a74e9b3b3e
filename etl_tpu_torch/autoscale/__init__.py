"""Closed-loop, SLO-driven elasticity (docs/autoscale.md).

Signals (signals.py) — per-shard lag/drain/pressure sampled into
seeded-replayable SignalFrame timelines; Policy (policy.py) — a pure
DS2-style rate model wrapped in hysteresis bands, cooldown windows,
max-step K→K±1 and flap damping; Controller (controller.py) — drives
`ShardCoordinator` two-phase rebalances and orchestrator rolls behind a
crash-resumable decision journal persisted through the StateStore
surface, and feeds per-tenant SLO weights into the shared
AdmissionScheduler.

`python -m etl_tpu_torch.autoscale --replay signals.json` replays a
recorded timeline through the policy and prints the deterministic
decision trace; `--synthetic --seed N` does the same over the seeded
surge→drain story the bench reaction-time gate uses.

Copy of the reference's `etl_tpu/autoscale/`. Nothing here touches the
card: the controller reaches the device layer only through the shard
pods it rolls and through the port's `ops.pipeline.global_admission`.
"""

from .controller import (AutoscaleController, AutoscaleJournal,
                         DecisionRecord, STATUS_ABORTED, STATUS_APPLIED,
                         STATUS_PENDING)
from .policy import (ACTION_DOWN, ACTION_HOLD, ACTION_UP, AutoscalePolicy,
                     AutoscalePolicyConfig, Decision)
from .signals import (RegistrySignalSource, ShardSignals, SignalFrame,
                      SignalTimeline, StoreSignalSource,
                      seeded_surge_timeline)

__all__ = [
    "ACTION_DOWN",
    "ACTION_HOLD",
    "ACTION_UP",
    "AutoscaleController",
    "AutoscaleJournal",
    "AutoscalePolicy",
    "AutoscalePolicyConfig",
    "Decision",
    "DecisionRecord",
    "RegistrySignalSource",
    "STATUS_ABORTED",
    "STATUS_APPLIED",
    "STATUS_PENDING",
    "ShardSignals",
    "SignalFrame",
    "SignalTimeline",
    "StoreSignalSource",
    "seeded_surge_timeline",
]
