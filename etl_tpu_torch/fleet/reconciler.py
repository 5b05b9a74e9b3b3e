"""The fleet control loop: observe → diff → converge.

Level-triggered reconciliation (the Kubernetes controller pattern): the
reconciler never remembers what it did — every tick re-reads the
desired `FleetSpec` from the store, re-enumerates the OBSERVED fleet
from the runtime, and computes the delta from scratch. Missed events
cannot exist because there are no events; a coordinator can be
hard-killed at any instant and its successor starts from the same two
sources of truth.

The tick body:

  1. observe  — `runtime.list_pipelines()` (pipeline_id → live K) and
                the persisted `FleetSpec`;
  2. place    — per-tenant quota clamping (`place_fleet`, pure): a
                tenant's aggregate shard ask is trimmed to its
                `TenantQuota.max_shards`, deterministically (pipeline-id
                order, every pipeline keeps ≥ 1 shard);
  3. diff     — `diff_fleet` (pure, `@control_loop`: no I/O, no clock —
                etl-lint rule 16 enforces it): the verb list that
                converges observed onto placed, deletes first (they
                free quota), then creates, then resizes, each in
                pipeline-id order;
  4. converge — per verb: persist a PENDING `ActuationRecord` to that
                pipeline's journal, actuate the runtime, settle
                APPLIED. A pipeline whose journal already holds a
                pending record is HELD this tick (single-flight per
                pipeline; `resume()` owns pendings);
  5. feed     — per-tenant SLO weights from the spec's quotas into the
                shared `AdmissionScheduler`.

Crash recovery (`resume()`): scan every pipeline's journal for pending
records. If the observed fleet already shows the record's target, the
actuation landed before the crash — settle APPLIED with NO runtime
call (zero double-actuation, the chaos scenario's journal-verified
invariant). Otherwise re-drive the verb (idempotent by the
FleetRuntime contract) and settle. A pending record whose pipeline the
CURRENT spec no longer demands is settled ABORTED — the next tick
reconciles to the new truth anyway.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field, replace

from ..analysis.annotations import control_loop, domain, handoff
from ..telemetry.metrics import (ETL_FLEET_CONVERGED,
                                 ETL_FLEET_PIPELINES_DESIRED,
                                 ETL_FLEET_PIPELINES_OBSERVED,
                                 ETL_FLEET_RECONCILE_ACTIONS_TOTAL,
                                 ETL_FLEET_RECONCILE_HOLDS_TOTAL,
                                 ETL_FLEET_RESUMES_TOTAL,
                                 ETL_FLEET_SHARDS_DESIRED,
                                 ETL_FLEET_SPEC_VERSION, registry)
from .journal import (STATUS_ABORTED, STATUS_APPLIED, VERB_CREATE,
                      VERB_DELETE, VERB_RESIZE, ActuationJournal,
                      ActuationRecord)
from .runtime import FleetRuntime
from .spec import FleetSpec, PipelineSpec

logger = logging.getLogger("etl_tpu_torch.fleet")


@dataclass(frozen=True)
class FleetAction:
    """One diffed verb. `from_k` is the observed shard count (0 =
    absent), `to_k` the placed target (0 = delete)."""

    verb: str
    pipeline_id: int
    from_k: int
    to_k: int

    def describe(self) -> dict:
        return {"verb": self.verb, "pipeline_id": self.pipeline_id,
                "from_k": self.from_k, "to_k": self.to_k}


@control_loop
def place_fleet(spec: FleetSpec) -> "dict[int, int]":
    """Quota-clamped target shard counts: pipeline_id → K. Pure and
    deterministic: per tenant, every pipeline is first granted one
    shard (a quota can squeeze a tenant, never evict it — eviction is a
    spec edit, not a placement side effect), then the remaining budget
    is dealt in pipeline-id order up to each pipeline's ask.
    `max_shards == 0` means unlimited."""
    targets: dict[int, int] = {}
    by_tenant: dict[str, list[PipelineSpec]] = {}
    for p in spec.pipelines:
        by_tenant.setdefault(p.tenant_id, []).append(p)
    for tenant, pipes in by_tenant.items():
        pipes = sorted(pipes, key=lambda p: p.pipeline_id)
        quota = spec.quotas.get(tenant)
        budget = quota.max_shards if quota and quota.max_shards > 0 \
            else None
        if budget is None or budget >= sum(p.shard_count for p in pipes):
            for p in pipes:
                targets[p.pipeline_id] = p.shard_count
            continue
        for p in pipes:
            targets[p.pipeline_id] = 1
        remaining = budget - len(pipes)
        for p in pipes:
            if remaining <= 0:
                break
            grant = min(p.shard_count - 1, remaining)
            targets[p.pipeline_id] += grant
            remaining -= grant
    return targets


@control_loop
def diff_fleet(targets: "dict[int, int]",
               observed: "dict[int, int]") -> "tuple[FleetAction, ...]":
    """The verb list converging `observed` onto `targets`. Pure: no
    I/O, no clock, no randomness — the same two maps always yield the
    same actions in the same order (deletes, creates, resizes; each by
    pipeline_id)."""
    deletes = [FleetAction(VERB_DELETE, pid, observed[pid], 0)
               for pid in sorted(observed) if pid not in targets]
    creates = [FleetAction(VERB_CREATE, pid, 0, targets[pid])
               for pid in sorted(targets) if pid not in observed]
    resizes = [FleetAction(VERB_RESIZE, pid, observed[pid], targets[pid])
               for pid in sorted(targets)
               if pid in observed and observed[pid] != targets[pid]]
    return tuple(deletes + creates + resizes)


@dataclass
class ReconcileResult:
    """One tick's outcome."""

    spec_version: int = 0
    desired: int = 0
    observed: int = 0
    applied: list = field(default_factory=list)  # FleetAction
    held: list = field(default_factory=list)  # pipeline ids (pending)
    converged: bool = False

    def describe(self) -> dict:
        return {
            "spec_version": self.spec_version,
            "desired": self.desired,
            "observed": self.observed,
            "applied": [a.describe() for a in self.applied],
            "held": list(self.held),
            "converged": self.converged,
        }


class FleetReconciler:
    """The fleet coordinator's control loop. Singleton per fleet, like
    the autoscale controller per pipeline: the per-pipeline journals'
    single-flight check assumes one writer. Runs against the RAW store
    (never a shard view — `ShardScopedStore` refuses fleet writes)."""

    def __init__(self, *, store, runtime: FleetRuntime, bus=None,
                 scheduler=None):
        self.store = store
        self.runtime = runtime
        self.bus = bus  # optional FleetSignalBus (policy plugins)
        self._scheduler = scheduler  # AdmissionScheduler | None = global
        self.ticks = 0

    # -- journal persistence -------------------------------------------------

    async def _load_journal(self, pipeline_id: int) -> ActuationJournal:
        return ActuationJournal.from_json(
            await self.store.get_fleet_journal(pipeline_id))

    @handoff  # persist-then-actuate seam: the journal write IS the
    # happens-before edge a restarted coordinator resumes from
    async def _save_journal(self, pipeline_id: int,
                            journal: ActuationJournal) -> None:
        await self.store.update_fleet_journal(pipeline_id,
                                              journal.to_json())

    # -- observe / desired ---------------------------------------------------

    async def load_spec(self) -> FleetSpec:
        return FleetSpec.from_json(await self.store.get_fleet_spec())

    async def observe(self) -> "dict[int, int]":
        return dict(await self.runtime.list_pipelines())

    # -- SLO feed ------------------------------------------------------------

    def apply_slo_weights(self, spec: FleetSpec) -> None:
        """Per-tenant quota SLO weights into the shared admission
        scheduler (tenant names are prefixes there, so one weight covers
        every stream the tenant's pipelines register)."""
        if not spec.quotas:
            return
        scheduler = self._scheduler
        if scheduler is None:
            from ..ops.pipeline import global_admission

            scheduler = global_admission()
        for tenant, quota in sorted(spec.quotas.items()):
            scheduler.set_slo_weight(tenant, quota.slo_weight)

    # -- actuation -----------------------------------------------------------

    async def _actuate(self, action: FleetAction,
                       spec_by_id: "dict[int, PipelineSpec]") -> None:
        if action.verb == VERB_DELETE:
            await self.runtime.delete_pipeline(action.pipeline_id)
            return
        pipeline = replace(spec_by_id[action.pipeline_id],
                           shard_count=action.to_k)
        if action.verb == VERB_CREATE:
            await self.runtime.create_pipeline(pipeline)
        else:
            await self.runtime.resize_pipeline(pipeline)

    # -- the loop body -------------------------------------------------------

    @domain("coordinator")
    async def tick(self) -> ReconcileResult:
        """One reconcile turn (module docstring). Every applied action
        is journaled persist-then-actuate; a crash mid-tick leaves at
        most ONE pending record (actuation is sequential) for resume()."""
        spec = await self.load_spec()
        observed = await self.observe()
        targets = place_fleet(spec)
        actions = diff_fleet(targets, observed)
        spec_by_id = spec.by_id()
        result = ReconcileResult(
            spec_version=spec.spec_version,
            desired=len(targets), observed=len(observed))
        self.ticks += 1

        for action in actions:
            journal = await self._load_journal(action.pipeline_id)
            if journal.pending() is not None:
                # single-flight per pipeline: a pending record means a
                # crashed (or concurrent) actuation — resume() owns it
                result.held.append(action.pipeline_id)
                registry.counter_inc(ETL_FLEET_RECONCILE_HOLDS_TOTAL,
                                     labels={"reason": "pending"})
                continue
            rec = journal.open(verb=action.verb, from_k=action.from_k,
                               to_k=action.to_k,
                               spec_version=spec.spec_version)
            await self._save_journal(action.pipeline_id, journal)
            # persist-then-actuate: the crash window between these two
            # writes is exactly what resume() covers
            await self._actuate(action, spec_by_id)
            journal = await self._load_journal(action.pipeline_id)
            journal.settle(rec.decision_id, STATUS_APPLIED)
            await self._save_journal(action.pipeline_id, journal)
            result.applied.append(action)
            registry.counter_inc(ETL_FLEET_RECONCILE_ACTIONS_TOTAL,
                                 labels={"verb": action.verb})
            logger.info("fleet actuation %s pipeline %d: K=%d->%d "
                        "(spec v%d)", action.verb, action.pipeline_id,
                        action.from_k, action.to_k, spec.spec_version)

        self.apply_slo_weights(spec)
        result.converged = not actions and not result.held
        registry.gauge_set(ETL_FLEET_SPEC_VERSION, spec.spec_version)
        registry.gauge_set(ETL_FLEET_PIPELINES_DESIRED, len(targets))
        registry.gauge_set(ETL_FLEET_PIPELINES_OBSERVED, len(observed))
        registry.gauge_set(ETL_FLEET_SHARDS_DESIRED,
                           sum(targets.values()))
        registry.gauge_set(ETL_FLEET_CONVERGED,
                           1 if result.converged else 0)
        return result

    async def converge(self, max_ticks: int = 8) -> int:
        """Tick until steady (a tick that applies nothing and holds
        nothing). Returns the number of ticks that DID work; raises
        nothing on non-convergence — the caller gates on the count."""
        for i in range(max_ticks):
            result = await self.tick()
            if result.converged:
                return i
        return max_ticks

    # -- crash recovery ------------------------------------------------------

    @domain("coordinator")
    async def resume(self) -> "list[ActuationRecord]":
        """Settle every pending actuation a dead coordinator left
        behind (module docstring). Returns the settled records;
        idempotent — a second call finds nothing pending."""
        journals = await self.store.get_fleet_journals()
        pendings = [(pid, ActuationJournal.from_json(doc))
                    for pid, doc in sorted(journals.items())]
        pendings = [(pid, j, j.pending()) for pid, j in pendings
                    if j.pending() is not None]
        if not pendings:
            return []
        observed = await self.observe()
        spec = await self.load_spec()
        spec_by_id = spec.by_id()
        settled: list[ActuationRecord] = []
        for pid, journal, rec in pendings:
            observed_k = observed.get(pid, 0)
            if rec.satisfied_by(observed_k):
                # crash AFTER the actuation, before the settle write:
                # the fleet already shows the target — journal-only,
                # ZERO runtime calls (the no-double-actuation half)
                journal.settle(rec.decision_id, STATUS_APPLIED)
                await self._save_journal(pid, journal)
                settled.append(replace(rec, status=STATUS_APPLIED))
                registry.counter_inc(ETL_FLEET_RESUMES_TOTAL,
                                     labels={"mode": "settle"})
                logger.info("fleet resume: pipeline %d decision %d "
                            "already actuated — settled", pid,
                            rec.decision_id)
                continue
            if rec.verb != VERB_DELETE and pid not in spec_by_id:
                # the spec moved on while the record was pending (the
                # pipeline was removed): abort — the next tick diffs
                # against the new truth and deletes the stray if needed
                journal.settle(rec.decision_id, STATUS_ABORTED)
                await self._save_journal(pid, journal)
                settled.append(replace(rec, status=STATUS_ABORTED))
                registry.counter_inc(ETL_FLEET_RESUMES_TOTAL,
                                     labels={"mode": "abort"})
                continue
            # crash BEFORE the actuation landed: re-drive the verb
            # (idempotent by the FleetRuntime contract), then settle
            action = FleetAction(rec.verb, pid, observed_k, rec.to_k)
            await self._actuate(action, spec_by_id)
            journal = await self._load_journal(pid)
            journal.settle(rec.decision_id, STATUS_APPLIED)
            await self._save_journal(pid, journal)
            settled.append(replace(rec, status=STATUS_APPLIED))
            registry.counter_inc(ETL_FLEET_RESUMES_TOTAL,
                                 labels={"mode": "redrive"})
            logger.info("fleet resume: pipeline %d decision %d "
                        "re-driven to applied", pid, rec.decision_id)
        return settled
