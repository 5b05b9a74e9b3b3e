"""The reconciler's actuation seam: what a fleet runtime must do.

Three verbs plus enumeration — deliberately the smallest surface that
lets the reconciler converge a fleet, and every verb IDEMPOTENT by
contract (creating a pipeline that is already running at the target K,
resizing to the current K, deleting an absent pipeline: all no-ops).
Idempotence is what makes crash resume safe: a successor that cannot
tell whether the dead coordinator's actuation landed may re-drive the
verb without harm, and only skips it when the observed fleet already
shows the target (journal.py `satisfied_by`).

Implementations:
  - `OrchestratorFleetRuntime` (here): drives a real `Orchestrator`
    (K8s StatefulSets or local subprocesses) — the production path;
  - `SimulatedFleetRuntime` (sim.py): the 100-pipeline in-process
    model the chaos scenario and bench converge gate run against.
"""

from __future__ import annotations

import abc

from ..api.orchestrator import Orchestrator, ReplicatorSpec
from .spec import PipelineSpec


class FleetRuntime(abc.ABC):
    """What the reconciler actuates against. Resize takes the full
    desired `PipelineSpec` (its `shard_count` IS the target K): rolling
    a deployment needs the config document, not just the id."""

    @abc.abstractmethod
    async def list_pipelines(self) -> "dict[int, int]":
        """Observed fleet: pipeline_id -> live shard count. The
        reconciler's observe step AND the chaos leak check both
        enumerate through here — a runtime that cannot list cannot be
        reconciled."""

    @abc.abstractmethod
    async def create_pipeline(self, spec: PipelineSpec) -> None: ...

    @abc.abstractmethod
    async def resize_pipeline(self, spec: PipelineSpec) -> None: ...

    @abc.abstractmethod
    async def delete_pipeline(self, pipeline_id: int) -> None: ...


class OrchestratorFleetRuntime(FleetRuntime):
    """Fleet verbs over a real Orchestrator: create/resize both roll
    through `start_pipeline`/`scale_pipeline` (idempotent re-apply —
    the StatefulSet 409→PATCH path, the LocalOrchestrator same-spec
    no-op), delete through `delete_pipeline` (404-tolerant)."""

    def __init__(self, orchestrator: Orchestrator):
        self.orchestrator = orchestrator

    def _replicator_spec(self, spec: PipelineSpec) -> ReplicatorSpec:
        config = dict(spec.config)
        config.setdefault("pipeline_id", spec.pipeline_id)
        config.setdefault("destination", {"type": spec.destination})
        config["shard_count"] = spec.shard_count
        return ReplicatorSpec(
            pipeline_id=spec.pipeline_id, tenant_id=spec.tenant_id,
            config=config, shard_count=spec.shard_count)

    async def list_pipelines(self) -> "dict[int, int]":
        return await self.orchestrator.list_pipelines()

    async def create_pipeline(self, spec: PipelineSpec) -> None:
        await self.orchestrator.start_pipeline(self._replicator_spec(spec))

    async def resize_pipeline(self, spec: PipelineSpec) -> None:
        await self.orchestrator.scale_pipeline(
            self._replicator_spec(spec), spec.shard_count)

    async def delete_pipeline(self, pipeline_id: int) -> None:
        await self.orchestrator.delete_pipeline(pipeline_id)
