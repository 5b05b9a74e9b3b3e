"""Declarative fleet desired state: what SHOULD be running.

The Kubernetes-controller stance (level-triggered, Borg/Omega lineage):
operators edit a `FleetSpec` document — pipelines × shard counts ×
destinations × tenancy profile — and submit it whole; the reconciler
(reconciler.py) owns making reality match. Nothing in here runs
anything: the spec is pure data, persisted on the StateStore fleet
surface (store/base.py `update_fleet_spec`) with a MONOTONIC
`spec_version` so a stale operator or partitioned coordinator can never
roll the fleet's desired state back.

Tenancy rides two knobs:
  - `profile`: the seeded workload-mix name (workloads/) that
    describes the tenant's traffic shape — the simulated fleet draws
    its per-pipeline workload from it, and operators use it to group
    capacity planning;
  - per-tenant `TenantQuota`s: a hard shard budget (placement clamps a
    tenant's aggregate shard ask to it, deterministically) and an SLO
    weight fed into `AdmissionScheduler.set_slo_weight` so a tenant's
    admission share follows the same document that sizes its fleet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..models.errors import ErrorKind, EtlError

#: hard ceiling on a single pipeline's shard count inside a fleet spec —
#: matches the orchestrator's shard-discovery probing bound
#: (K8sOrchestrator.MAX_SHARDS); a fleet never creates what stop/status
#: could not later find
MAX_SHARDS_PER_PIPELINE = 64


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's fleet-wide budget. `max_shards` caps the tenant's
    AGGREGATE shard count across all its pipelines (0 = unlimited);
    `slo_weight` is the admission-scheduler priority the reconciler
    installs for the tenant prefix."""

    max_shards: int = 0
    slo_weight: float = 1.0

    def to_json(self) -> dict:
        return {"max_shards": self.max_shards,
                "slo_weight": self.slo_weight}

    @classmethod
    def from_json(cls, doc: dict) -> "TenantQuota":
        return cls(max_shards=int(doc.get("max_shards", 0)),
                   slo_weight=float(doc.get("slo_weight", 1.0)))


@dataclass(frozen=True)
class PipelineSpec:
    """One pipeline's desired state inside the fleet."""

    pipeline_id: int
    tenant_id: str
    shard_count: int = 1
    destination: str = "memory"  # destination type name (config doc key)
    profile: str = "insert_heavy"  # workload/tenancy profile name
    config: dict = field(default_factory=dict)  # replicator config overrides

    def validate(self) -> None:
        if self.pipeline_id < 1:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"pipeline_id must be >= 1, got "
                           f"{self.pipeline_id}")
        if not self.tenant_id:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"pipeline {self.pipeline_id}: empty tenant_id")
        if not 1 <= self.shard_count <= MAX_SHARDS_PER_PIPELINE:
            raise EtlError(
                ErrorKind.CONFIG_INVALID,
                f"pipeline {self.pipeline_id}: shard_count "
                f"{self.shard_count} outside [1, "
                f"{MAX_SHARDS_PER_PIPELINE}]")

    def to_json(self) -> dict:
        return {
            "pipeline_id": self.pipeline_id,
            "tenant_id": self.tenant_id,
            "shard_count": self.shard_count,
            "destination": self.destination,
            "profile": self.profile,
            "config": dict(self.config),
        }

    @classmethod
    def from_json(cls, doc: dict) -> "PipelineSpec":
        return cls(
            pipeline_id=int(doc["pipeline_id"]),
            tenant_id=str(doc["tenant_id"]),
            shard_count=int(doc.get("shard_count", 1)),
            destination=str(doc.get("destination", "memory")),
            profile=str(doc.get("profile", "insert_heavy")),
            config=dict(doc.get("config", {})),
        )


@dataclass(frozen=True)
class FleetSpec:
    """The whole fleet's desired state, versioned. One JSON document on
    the StateStore fleet surface; every edit submits a NEW spec with
    `spec_version` bumped — the store refuses regressions."""

    spec_version: int = 0
    pipelines: tuple = ()  # tuple[PipelineSpec] sorted by pipeline_id
    quotas: dict = field(default_factory=dict)  # tenant_id -> TenantQuota

    def validate(self) -> None:
        if self.spec_version < 0:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"spec_version must be >= 0, got "
                           f"{self.spec_version}")
        seen: set[int] = set()
        for p in self.pipelines:
            p.validate()
            if p.pipeline_id in seen:
                raise EtlError(
                    ErrorKind.CONFIG_INVALID,
                    f"duplicate pipeline_id {p.pipeline_id} in fleet spec")
            seen.add(p.pipeline_id)
        for tenant, q in self.quotas.items():
            if q.max_shards < 0:
                raise EtlError(
                    ErrorKind.CONFIG_INVALID,
                    f"tenant {tenant}: max_shards must be >= 0")
            if q.slo_weight <= 0:
                raise EtlError(
                    ErrorKind.CONFIG_INVALID,
                    f"tenant {tenant}: slo_weight must be > 0")

    def by_id(self) -> "dict[int, PipelineSpec]":
        return {p.pipeline_id: p for p in self.pipelines}

    def with_edit(self, *, add=(), remove=(),
                  resize: "dict[int, int] | None" = None) -> "FleetSpec":
        """A new spec (version + 1) with pipelines added/removed/resized
        — the operator-edit primitive the chaos and bench scripts use."""
        from dataclasses import replace

        by_id = self.by_id()
        for pid in remove:
            by_id.pop(int(pid), None)
        for p in add:
            by_id[p.pipeline_id] = p
        for pid, k in (resize or {}).items():
            if int(pid) in by_id:
                by_id[int(pid)] = replace(by_id[int(pid)],
                                          shard_count=int(k))
        spec = FleetSpec(
            spec_version=self.spec_version + 1,
            pipelines=tuple(sorted(by_id.values(),
                                   key=lambda p: p.pipeline_id)),
            quotas=dict(self.quotas))
        spec.validate()
        return spec

    def to_json(self) -> dict:
        return {
            "spec_version": self.spec_version,
            "pipelines": [p.to_json() for p in self.pipelines],
            "quotas": {t: q.to_json() for t, q in
                       sorted(self.quotas.items())},
        }

    @classmethod
    def from_json(cls, doc: "dict | None") -> "FleetSpec":
        if doc is None:
            return cls()
        spec = cls(
            spec_version=int(doc.get("spec_version", 0)),
            pipelines=tuple(sorted(
                (PipelineSpec.from_json(p)
                 for p in doc.get("pipelines", [])),
                key=lambda p: p.pipeline_id)),
            quotas={str(t): TenantQuota.from_json(q)
                    for t, q in doc.get("quotas", {}).items()},
        )
        spec.validate()
        return spec
