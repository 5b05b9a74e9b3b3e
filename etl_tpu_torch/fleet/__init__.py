"""etl-fleet: declarative reconciliation of hundreds of pipelines.

One coordinator, one desired-state document, level-triggered
convergence (docs/fleet.md). The package splits along the control-loop
seam the rest of the repo already uses:

  spec.py        desired state — FleetSpec / PipelineSpec / TenantQuota,
                 versioned, persisted on the StateStore fleet surface;
  journal.py     per-pipeline persist-then-actuate records (the
                 autoscale-journal pattern generalized to fleet verbs);
  reconciler.py  observe → place (quota clamp) → diff (pure) →
                 converge, plus crash resume;
  runtime.py     the actuation seam (Orchestrator-backed production
                 runtime);
  sim.py         the 100-pipeline in-process fleet for chaos + bench;
  bus.py         the shared signal bus: admission / PID lag-target /
                 adaptive ack-depth policies as plugins.
"""

from .bus import (AckDepthConfig, AdaptiveAckDepthPolicy,
                  AdmissionWeightConfig, AdmissionWeightPolicy,
                  FleetPolicyPlugin, FleetSignalBus, PidConfig,
                  PidLagPolicy, PidState)
from .journal import (STATUS_ABORTED, STATUS_APPLIED, STATUS_PENDING,
                      VERB_CREATE, VERB_DELETE, VERB_RESIZE,
                      ActuationJournal, ActuationRecord)
from .reconciler import (FleetAction, FleetReconciler, ReconcileResult,
                         diff_fleet, place_fleet)
from .runtime import FleetRuntime, OrchestratorFleetRuntime
from .sim import (REDELIVERY_WINDOW, SimulatedFleetRuntime,
                  SimulatedPipeline, seeded_fleet_spec)
from .spec import (MAX_SHARDS_PER_PIPELINE, FleetSpec, PipelineSpec,
                   TenantQuota)

__all__ = [
    "AckDepthConfig",
    "ActuationJournal",
    "ActuationRecord",
    "AdaptiveAckDepthPolicy",
    "AdmissionWeightConfig",
    "AdmissionWeightPolicy",
    "FleetAction",
    "FleetPolicyPlugin",
    "FleetReconciler",
    "FleetRuntime",
    "FleetSignalBus",
    "FleetSpec",
    "MAX_SHARDS_PER_PIPELINE",
    "OrchestratorFleetRuntime",
    "PidConfig",
    "PidLagPolicy",
    "PidState",
    "PipelineSpec",
    "REDELIVERY_WINDOW",
    "ReconcileResult",
    "STATUS_ABORTED",
    "STATUS_APPLIED",
    "STATUS_PENDING",
    "SimulatedFleetRuntime",
    "SimulatedPipeline",
    "TenantQuota",
    "VERB_CREATE",
    "VERB_DELETE",
    "VERB_RESIZE",
    "diff_fleet",
    "place_fleet",
    "seeded_fleet_spec",
]
