"""The actuation half: decisions → two-phase rebalances → pod rolls.

`AutoscaleController.tick()` is one turn of the closed loop:

    sample (collector) → evaluate (policy, pure) → actuate:
      1. refuse overlap — a pending journal entry or an in-flight
         rebalance record means a decision is already being applied;
         this tick HOLDS (the two-phase protocol is single-flight by
         construction and the controller must never race itself);
      2. persist the decision to the journal (StateStore surface)
         BEFORE touching the topology — a controller crash after this
         point leaves a pending entry a successor can resume or abort;
      3. drive `ShardCoordinator.add_shard()/remove_shard()` (the
         two-phase fence: zero-loss/bounded-dup by construction);
      4. roll the fleet: `orchestrator.scale_pipeline()` (StatefulSet
         fan-out or LocalOrchestrator subprocesses) and/or the
         `scale_listener` hook (in-process fleets: chaos, tests);
      5. mark the journal entry applied.

Crash recovery (`resume()`): a pending journal entry is re-driven
through the SAME coordinator action — the coordinator's persisted
`rebalancing` record resumes with the original fence, so re-running is
idempotent; a pending entry whose target the assignment already shows
steady (crash between flip and journal mark) is marked applied with no
topology action at all — re-running a persisted decision is a no-op.
`resume(abort=True)` instead rolls the in-flight rebalance back via
`ShardCoordinator.abort_rebalance()` (slot deleted, epoch unchanged)
and marks the entry aborted.

The controller also feeds per-tenant SLO weights into the shared
`AdmissionScheduler` (ops/pipeline.py): lag decides
who is behind, the SLO weight decides whose backlog costs more per
second, and the autoscale config is where operators own both knobs.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field, replace

from ..analysis.annotations import domain, handoff
from ..models.errors import ErrorKind, EtlError
from ..telemetry.metrics import (ETL_AUTOSCALE_BACKLOG_BYTES,
                                 ETL_AUTOSCALE_CAPACITY_BYTES_PER_S,
                                 ETL_AUTOSCALE_DECISION_IN_FLIGHT,
                                 ETL_AUTOSCALE_DECISIONS_TOTAL,
                                 ETL_AUTOSCALE_HOLDS_TOTAL,
                                 ETL_AUTOSCALE_RESUMES_TOTAL,
                                 ETL_AUTOSCALE_TARGET_SHARDS, registry)
from .policy import (ACTION_DOWN, ACTION_HOLD, ACTION_UP, AutoscalePolicy,
                     Decision)
from .signals import SignalTimeline

logger = logging.getLogger("etl_tpu_torch.autoscale")

STATUS_PENDING = "pending"
STATUS_APPLIED = "applied"
STATUS_ABORTED = "aborted"


@dataclass(frozen=True)
class DecisionRecord:
    """One journaled decision. `decision_id` is monotonic per pipeline;
    `epoch_before` pins which topology the decision was made against so
    a resume can tell 'crash before flip' from 'crash after flip'."""

    decision_id: int
    tick: int
    action: str  # scale_up | scale_down
    from_k: int
    to_k: int
    epoch_before: int
    status: str = STATUS_PENDING

    def to_json(self) -> dict:
        return {
            "decision_id": self.decision_id,
            "tick": self.tick,
            "action": self.action,
            "from_k": self.from_k,
            "to_k": self.to_k,
            "epoch_before": self.epoch_before,
            "status": self.status,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "DecisionRecord":
        return cls(
            decision_id=int(doc["decision_id"]),
            tick=int(doc["tick"]),
            action=str(doc["action"]),
            from_k=int(doc["from_k"]),
            to_k=int(doc["to_k"]),
            epoch_before=int(doc["epoch_before"]),
            status=str(doc.get("status", STATUS_PENDING)),
        )


@dataclass
class AutoscaleJournal:
    """The persisted decision history (bounded) + the id counter. One
    small JSON doc rewritten whole per transition — the StateStore
    surface (store/base.py) keeps ids monotonic across controllers."""

    next_id: int = 1
    entries: list = field(default_factory=list)
    max_entries: int = 64

    def pending(self) -> "DecisionRecord | None":
        for rec in reversed(self.entries):
            if rec.status == STATUS_PENDING:
                return rec
        return None

    def open_decision(self, decision: Decision,
                      epoch_before: int) -> DecisionRecord:
        rec = DecisionRecord(
            decision_id=self.next_id, tick=decision.tick,
            action=decision.action, from_k=decision.current_k,
            to_k=decision.target_k, epoch_before=epoch_before)
        self.next_id += 1
        self.entries.append(rec)
        if len(self.entries) > self.max_entries:
            del self.entries[:len(self.entries) - self.max_entries]
        return rec

    def settle(self, decision_id: int, status: str) -> None:
        self.entries = [
            replace(r, status=status) if r.decision_id == decision_id
            else r for r in self.entries]

    def last_applied_tick(self) -> "int | None":
        for rec in reversed(self.entries):
            if rec.status == STATUS_APPLIED:
                return rec.tick
        return None

    def to_json(self) -> dict:
        return {"next_id": self.next_id,
                "max_entries": self.max_entries,
                "entries": [r.to_json() for r in self.entries]}

    @classmethod
    def from_json(cls, doc: "dict | None") -> "AutoscaleJournal":
        if doc is None:
            return cls()
        j = cls(next_id=int(doc.get("next_id", 1)),
                max_entries=int(doc.get("max_entries", 64)))
        j.entries = [DecisionRecord.from_json(r)
                     for r in doc.get("entries", [])]
        return j


class AutoscaleController:
    """One pipeline's scale controller. Pod-external like the
    coordinator it drives: writes through the RAW store (never a shard
    view) and must run as a singleton per pipeline — the journal's
    single-flight check assumes one writer."""

    def __init__(self, *, store, pipeline_id: int, collector,
                 coordinator, policy: "AutoscalePolicy | None" = None,
                 orchestrator=None, spec=None, scale_listener=None,
                 slo_weights: "dict[str, float] | None" = None):
        self.store = store
        self.pipeline_id = pipeline_id
        self.collector = collector  # async sample(at_s) -> SignalFrame
        self.coordinator = coordinator  # sharding.ShardCoordinator
        self.policy = policy or AutoscalePolicy()
        # orchestrator + spec: the production roll path
        # (Orchestrator.scale_pipeline). scale_listener: async
        # (from_k, to_k, RebalanceResult) — in-process fleets (chaos,
        # tests) roll their Pipelines here. Either, both, or neither.
        self.orchestrator = orchestrator
        self.spec = spec
        self.scale_listener = scale_listener
        self._slo_weights = dict(slo_weights or {})
        self._slo_applied = False
        self.timeline = SignalTimeline(
            max_frames=max(256, self.policy.config.window_frames))
        self.decisions: list[Decision] = []  # this process's trace
        # cooldown anchor after a restart: the journal's ticks belong to
        # the process that wrote them (see _last_decision_tick)
        self._restart_anchor: "int | None" = None

    # -- SLO weight feed into the admission scheduler ------------------------

    def apply_slo_weights(self, scheduler=None) -> None:
        """Push the configured per-tenant SLO weights into the shared
        admission scheduler. Idempotent; called once at controller start
        (and again whenever the operator updates the mapping)."""
        if not self._slo_weights:
            return
        if scheduler is None:
            from ..ops.pipeline import global_admission

            scheduler = global_admission()
        for tenant, weight in sorted(self._slo_weights.items()):
            scheduler.set_slo_weight(tenant, weight)
        self._slo_applied = True
        logger.info("applied SLO admission weights: %s",
                    sorted(self._slo_weights.items()))

    # -- journal persistence -------------------------------------------------

    async def _load_journal(self) -> AutoscaleJournal:
        return AutoscaleJournal.from_json(
            await self.store.get_autoscale_journal())

    @handoff  # persist-then-actuate seam: the journal write IS the
    # happens-before edge a restarted controller resumes from
    async def _save_journal(self, journal: AutoscaleJournal) -> None:
        await self.store.update_autoscale_journal(journal.to_json())

    # -- the loop body -------------------------------------------------------

    @domain("coordinator")
    async def tick(self, at_s: float) -> Decision:
        """One closed-loop turn. Returns the decision (HOLD decisions
        carry the reason — cooldown, dead zone, overlap refusal)."""
        frame = await self.collector.sample(at_s)
        self.timeline.record(frame)
        assignment = await self.coordinator.current(
            bootstrap_shard_count=max(1, frame.shard_count))
        journal = await self._load_journal()

        def publish(decision: Decision) -> Decision:
            registry.gauge_set(ETL_AUTOSCALE_TARGET_SHARDS,
                               decision.target_k)
            registry.gauge_set(ETL_AUTOSCALE_BACKLOG_BYTES,
                               decision.backlog_bytes)
            registry.gauge_set(ETL_AUTOSCALE_CAPACITY_BYTES_PER_S,
                               decision.capacity_bytes_per_s)
            if decision.action == ACTION_HOLD:
                registry.counter_inc(
                    ETL_AUTOSCALE_HOLDS_TOTAL,
                    labels={"reason": decision.reason.split(":")[0]
                            .split(",")[0][:40]})
            self.decisions.append(decision)
            return decision

        # single-flight: an in-flight rebalance (ours or an operator's)
        # or a pending journal entry refuses this tick's decision
        if assignment.rebalancing or journal.pending() is not None:
            registry.gauge_set(ETL_AUTOSCALE_DECISION_IN_FLIGHT, 1)
            decision = self.policy.evaluate(
                self.timeline.frames, assignment.shard_count,
                self._last_decision_tick(journal, frame.tick))
            if decision.action != ACTION_HOLD:
                decision = replace(
                    decision, action=ACTION_HOLD,
                    target_k=assignment.shard_count,
                    reason="in_flight: a decision/rebalance is already "
                           "being applied (resume() or abort first)")
            return publish(decision)
        registry.gauge_set(ETL_AUTOSCALE_DECISION_IN_FLIGHT, 0)

        decision = self.policy.evaluate(
            self.timeline.frames, assignment.shard_count,
            self._last_decision_tick(journal, frame.tick))
        if decision.action == ACTION_HOLD:
            return publish(decision)

        # persist-then-actuate: the crash window between these two is
        # exactly what resume() covers
        rec = journal.open_decision(decision, assignment.epoch)
        await self._save_journal(journal)
        registry.gauge_set(ETL_AUTOSCALE_DECISION_IN_FLIGHT, 1)
        try:
            result = await self._actuate(rec)
        except BaseException:
            # leave the entry pending: a successor resumes or aborts it
            registry.gauge_set(ETL_AUTOSCALE_DECISION_IN_FLIGHT, 0)
            raise
        journal = await self._load_journal()
        journal.settle(rec.decision_id, STATUS_APPLIED)
        await self._save_journal(journal)
        registry.gauge_set(ETL_AUTOSCALE_DECISION_IN_FLIGHT, 0)
        registry.counter_inc(
            ETL_AUTOSCALE_DECISIONS_TOTAL,
            labels={"direction": "up" if decision.action == ACTION_UP
                    else "down"})
        logger.info("autoscale %s: K=%d->%d (epoch %d->%d): %s",
                    decision.action, rec.from_k, rec.to_k,
                    result.old_epoch, result.new_epoch, decision.reason)
        return publish(decision)

    def _last_decision_tick(self, journal: AutoscaleJournal,
                            current_tick: int) -> "int | None":
        """The cooldown anchor for this evaluation. Journal ticks live
        in the PROCESS that wrote them: a restarted controller's
        collector counts from 0 again, so a persisted tick larger than
        the current frame's would read as a huge negative age and hold
        every decision until the fresh counter overtook the dead
        process's (hours). Across a restart boundary the conservative
        and correct stance is 'the cooldown starts now': clamp the
        anchor to the current tick once, remember it in-process, and
        from then on this process's own applied decisions (which share
        the live tick domain) take over."""
        last = journal.last_applied_tick()
        if last is None:
            return self._restart_anchor
        if last > current_tick:
            # foreign tick domain (pre-crash process): anchor the
            # cooldown at this process's first observation of it
            if self._restart_anchor is None:
                self._restart_anchor = current_tick
            return self._restart_anchor
        return last

    async def _actuate(self, rec: DecisionRecord):
        """Drive the two-phase rebalance, then roll the fleet."""
        if rec.action == ACTION_UP:
            result = await self.coordinator.add_shard()
        elif rec.action == ACTION_DOWN:
            result = await self.coordinator.remove_shard()
        else:  # pragma: no cover - open_decision never journals holds
            raise EtlError(ErrorKind.INVALID_STATE_TRANSITION,
                           f"journaled decision with action {rec.action!r}")
        if result.new_shard_count != rec.to_k:
            raise EtlError(
                ErrorKind.INVALID_STATE_TRANSITION,
                f"decision {rec.decision_id} targeted K={rec.to_k} but "
                f"the rebalance landed K={result.new_shard_count}")
        await self._roll_fleet(rec, result)
        return result

    async def _roll_fleet(self, rec: DecisionRecord, result) -> None:
        if self.orchestrator is not None and self.spec is not None:
            await self.orchestrator.scale_pipeline(self.spec, rec.to_k)
        if self.scale_listener is not None:
            await self.scale_listener(rec.from_k, rec.to_k, result)

    # -- crash recovery ------------------------------------------------------

    @domain("coordinator")
    async def resume(self, abort: bool = False) -> "DecisionRecord | None":
        """Recover from a controller crash. Returns the settled record,
        or None when nothing was pending. Idempotent: re-running against
        an already-settled journal does nothing, and resuming a decision
        whose flip already happened only marks the journal."""
        journal = await self._load_journal()
        rec = journal.pending()
        if rec is None:
            return None
        assignment = await self.coordinator.current()
        registry.counter_inc(ETL_AUTOSCALE_RESUMES_TOTAL,
                             labels={"mode": "abort" if abort else "resume"})
        flip_done = (not assignment.rebalancing
                     and assignment.shard_count == rec.to_k
                     and assignment.epoch > rec.epoch_before)
        if flip_done:
            # crash AFTER the flip, before the journal mark: the
            # topology is already there — re-running is a no-op beyond
            # settling the journal (and rolling the fleet, which is
            # itself an idempotent re-apply). This path wins even under
            # abort=True: an epoch flip is not abortable (pods are
            # already fenced onto the new topology); 'aborting' here
            # would strand a flipped assignment with an un-rolled fleet
            # — the moved tables would have no owning pod.
            if abort:
                logger.warning(
                    "autoscale decision %d (K=%d->%d): abort requested "
                    "but the epoch flip already happened — settling as "
                    "applied and rolling the fleet instead",
                    rec.decision_id, rec.from_k, rec.to_k)
            await self._roll_fleet(rec, _SettledResult(rec, assignment))
            journal.settle(rec.decision_id, STATUS_APPLIED)
            await self._save_journal(journal)
            return replace(rec, status=STATUS_APPLIED)
        if abort:
            if assignment.rebalancing:
                await self.coordinator.abort_rebalance()
            journal.settle(rec.decision_id, STATUS_ABORTED)
            await self._save_journal(journal)
            logger.info("autoscale decision %d (K=%d->%d) aborted",
                        rec.decision_id, rec.from_k, rec.to_k)
            return replace(rec, status=STATUS_ABORTED)
        # crash BEFORE or DURING the rebalance: re-drive the same
        # coordinator action — its persisted record resumes with the
        # original fence (or starts fresh if the crash preceded 1b)
        await self._actuate(rec)
        journal = await self._load_journal()
        journal.settle(rec.decision_id, STATUS_APPLIED)
        await self._save_journal(journal)
        logger.info("autoscale decision %d (K=%d->%d) resumed to applied",
                    rec.decision_id, rec.from_k, rec.to_k)
        return replace(rec, status=STATUS_APPLIED)

    # -- optional interval loop ----------------------------------------------

    async def run(self, interval_s: float = 5.0, shutdown=None) -> None:
        """Simple periodic driver for sidecar deployments: resume any
        crash-interrupted decision first, apply SLO weights, then tick
        forever (or until `shutdown` — a ShutdownSignal-alike with
        `.triggered` — fires). Chaos and bench drive tick() directly."""
        import time

        await self.resume()
        self.apply_slo_weights()
        while shutdown is None or not shutdown.triggered:
            await self.tick(time.monotonic())
            await asyncio.sleep(interval_s)


class _SettledResult:
    """RebalanceResult-shaped view of an already-flipped assignment (the
    resume-after-flip path has no live result to hand the listener)."""

    def __init__(self, rec: DecisionRecord, assignment):
        self.old_epoch = rec.epoch_before
        self.new_epoch = assignment.epoch
        self.old_shard_count = rec.from_k
        self.new_shard_count = assignment.shard_count
        self.fence_lsn = assignment.fence_lsn
        self.moved = {}
        self.duration_s = 0.0
