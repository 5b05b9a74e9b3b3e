"""The 100-pipeline simulated fleet: what the chaos scenario and the
bench converge gate reconcile against.

`SimulatedFleetRuntime` implements the FleetRuntime verbs over
in-process state — no subprocesses, no sockets — so a hundred
pipelines cost a hundred dataclasses and the whole
reconcile/kill/resume story runs in milliseconds, deterministic per
seed. What it faithfully models is exactly what the reconciler's
correctness depends on:

  - idempotent verbs (create at the current K, resize to the current K,
    delete of an absent pipeline: state no-ops);
  - an ACTUATION LOG: every runtime call is appended. The chaos
    invariant "zero double-actuations" is `len(log) == total APPLIED
    journal records` — a settle-mode resume adds no call, a re-driven
    resume adds exactly the one the dead coordinator never made;
  - crash windows: optional async `pre_actuate`/`post_actuate` hooks
    awaited around the state mutation. The chaos scenario parks a
    chosen pipeline's hook on an Event and cancels the coordinator
    task there — cancel in pre = crash-BEFORE-actuation (journal
    pending, fleet unchanged), cancel in post = crash-AFTER (fleet
    changed, settle never written);
  - per-pipeline delivery ledgers: each pipeline carries a seeded
    committed-row ledger drawn from its tenancy profile, delivered on
    create; a resize ROLL re-delivers a bounded tail window (the
    restart-overlap dup model every chaos scenario uses). Invariants:
    delivered keys == committed keys (zero loss) and max dup count ≤
    1 + rolls (bounded duplication).

`seeded_fleet_spec` builds the canonical N-pipeline desired state:
tenants are workload profiles (the tenancy-profile story — one tenant
per traffic shape), shard counts and quotas drawn per seed.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..workloads import profile_names
from .runtime import FleetRuntime
from .spec import FleetSpec, PipelineSpec, TenantQuota

#: resize re-delivery window: a roll re-sends at most this many of the
#: ledger's newest rows (the in-flight-at-kill overlap every restart
#: scenario budgets for)
REDELIVERY_WINDOW = 16


@dataclass
class SimulatedPipeline:
    """One fleet member's in-process stand-in."""

    pipeline_id: int
    tenant_id: str
    profile: str
    shard_count: int
    committed: "list[str]" = field(default_factory=list)
    delivered: "dict[str, int]" = field(default_factory=dict)
    rolls: int = 0

    def deliver_all(self) -> None:
        for key in self.committed:
            self.delivered[key] = self.delivered.get(key, 0) + 1

    def redeliver_tail(self) -> None:
        for key in self.committed[-REDELIVERY_WINDOW:]:
            self.delivered[key] = self.delivered.get(key, 0) + 1

    def violations(self) -> "list[str]":
        out: "list[str]" = []
        missing = set(self.committed) - set(self.delivered)
        if missing:
            out.append(f"pipeline {self.pipeline_id}: "
                       f"{len(missing)} committed rows never delivered")
        extra = set(self.delivered) - set(self.committed)
        if extra:
            out.append(f"pipeline {self.pipeline_id}: "
                       f"{len(extra)} delivered rows never committed")
        if self.delivered:
            worst = max(self.delivered.values())
            if worst > 1 + self.rolls:
                out.append(
                    f"pipeline {self.pipeline_id}: max dup count {worst} "
                    f"exceeds 1 + {self.rolls} rolls")
        return out


def _ledger(seed: int, spec: PipelineSpec) -> "list[str]":
    """The pipeline's seeded committed-row ledger: size drawn from the
    tenancy profile's name hash so different traffic shapes get
    different (but per-seed stable) volumes."""
    rng = random.Random((seed << 20) ^ (spec.pipeline_id * 2654435761))
    base = 24 + (sum(spec.profile.encode()) % 5) * 12
    n = rng.randint(base, base + 24)
    return [f"{spec.profile}:{spec.pipeline_id}:{i}" for i in range(n)]


class SimulatedFleetRuntime(FleetRuntime):
    """In-process fleet (module docstring)."""

    def __init__(self, *, seed: int = 0):
        self.seed = seed
        self.pipelines: "dict[int, SimulatedPipeline]" = {}
        self.retired: "dict[int, SimulatedPipeline]" = {}
        self.actuation_log: "list[dict]" = []
        # chaos crash windows: async (verb, pipeline_id) -> None
        self.pre_actuate = None
        self.post_actuate = None

    async def _hooks(self, which, verb: str, pipeline_id: int) -> None:
        if which is not None:
            await which(verb, pipeline_id)

    async def list_pipelines(self) -> "dict[int, int]":
        return {pid: p.shard_count
                for pid, p in sorted(self.pipelines.items())}

    async def create_pipeline(self, spec: PipelineSpec) -> None:
        await self._hooks(self.pre_actuate, "create", spec.pipeline_id)
        self.actuation_log.append(
            {"verb": "create", "pipeline_id": spec.pipeline_id,
             "to_k": spec.shard_count})
        existing = self.pipelines.get(spec.pipeline_id)
        if existing is None:
            p = SimulatedPipeline(
                pipeline_id=spec.pipeline_id, tenant_id=spec.tenant_id,
                profile=spec.profile, shard_count=spec.shard_count,
                committed=_ledger(self.seed, spec))
            p.deliver_all()
            self.pipelines[spec.pipeline_id] = p
        elif existing.shard_count != spec.shard_count:
            existing.shard_count = spec.shard_count  # idempotent re-apply
        await self._hooks(self.post_actuate, "create", spec.pipeline_id)

    async def resize_pipeline(self, spec: PipelineSpec) -> None:
        await self._hooks(self.pre_actuate, "resize", spec.pipeline_id)
        self.actuation_log.append(
            {"verb": "resize", "pipeline_id": spec.pipeline_id,
             "to_k": spec.shard_count})
        p = self.pipelines.get(spec.pipeline_id)
        if p is not None and p.shard_count != spec.shard_count:
            # a roll: every pod restarts — the bounded-overlap dup model
            p.shard_count = spec.shard_count
            p.rolls += 1
            p.redeliver_tail()
        await self._hooks(self.post_actuate, "resize", spec.pipeline_id)

    async def delete_pipeline(self, pipeline_id: int) -> None:
        await self._hooks(self.pre_actuate, "delete", pipeline_id)
        self.actuation_log.append(
            {"verb": "delete", "pipeline_id": pipeline_id, "to_k": 0})
        p = self.pipelines.pop(pipeline_id, None)
        if p is not None:
            self.retired[pipeline_id] = p
        await self._hooks(self.post_actuate, "delete", pipeline_id)

    # -- invariants ----------------------------------------------------------

    def violations(self) -> "list[str]":
        out: "list[str]" = []
        for pid in sorted(self.pipelines):
            out.extend(self.pipelines[pid].violations())
        return out

    def describe(self) -> dict:
        return {
            "pipelines": len(self.pipelines),
            "shards": sum(p.shard_count
                          for p in self.pipelines.values()),
            "actuations": len(self.actuation_log),
            "retired": len(self.retired),
        }


def seeded_fleet_spec(seed: int, n_pipelines: int,
                      spec_version: int = 1) -> FleetSpec:
    """The canonical simulated fleet: `n_pipelines` pipelines spread
    over one tenant per workload profile (the tenancy-profile mix),
    shard counts 1..4 per seed, and quotas that BITE for two tenants
    (placement must visibly clamp them) plus SLO weights that differ."""
    rng = random.Random(seed)
    profiles = profile_names()
    pipelines = []
    for pid in range(1, n_pipelines + 1):
        profile = profiles[(pid - 1) % len(profiles)]
        pipelines.append(PipelineSpec(
            pipeline_id=pid,
            tenant_id=f"tenant-{profile}",
            shard_count=rng.randint(1, 4),
            destination="memory",
            profile=profile,
        ))
    quotas = {
        # the clamped tenants: fewer aggregate shards than asked
        f"tenant-{profiles[0]}": TenantQuota(max_shards=max(
            2, n_pipelines // len(profiles)), slo_weight=2.0),
        f"tenant-{profiles[1]}": TenantQuota(max_shards=max(
            2, n_pipelines // len(profiles)), slo_weight=0.5),
        # an unlimited tenant with a loud SLO weight
        f"tenant-{profiles[2]}": TenantQuota(max_shards=0,
                                             slo_weight=4.0),
    }
    spec = FleetSpec(spec_version=spec_version,
                     pipelines=tuple(pipelines), quotas=quotas)
    spec.validate()
    return spec
