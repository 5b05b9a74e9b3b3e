"""Two-phase shard rebalancing: quiesce at a fence LSN, flip the epoch.

`ShardCoordinator` is the control-plane half of horizontal scale-out: it
owns the persisted `ShardAssignment` and drives add/remove-shard
topology changes so that NO committed row is lost and duplicates stay
bounded — by construction, not by luck:

  add shard (K → K+1):
    1. create the NEW shard's apply slot FIRST; its consistent point is
       the fence LSN. From this instant the source retains WAL ≥ fence
       for the new pod, no matter how long the rollout takes.
    2. persist `status=rebalancing` (fence, moved set, target K+1) at
       the CURRENT epoch — pods keep applying their current slices.
    3. wait until every shard that is LOSING tables has durable progress
       ≥ fence on its apply slot: everything committed before the fence
       is durably applied by its old owner.
    4. flip: persist (epoch+1, K+1, steady). From here stale-epoch pods
       are refused by the store fence (sharding/runtime.py) and the
       orchestrator rolls the fleet onto the new topology; the new owner
       resumes from max(durable, slot confirmed_flush) = fence.

    Zero-loss: events < fence were applied by old owners (step 3);
    events ≥ fence are retained by the new slot (step 1) and applied by
    the new owner. Bounded-dup: an old owner may have applied a window
    past the fence before the flip — the new owner re-applies it, the
    same at-least-once window every crash restart already funds.

  remove shard (K → K-1, the TOP shard retires):
    same dance with the fence at the source's current WAL position; the
    retiring shard must drain to the fence before the flip, then its
    slots are deleted.

The coordinator is deliberately pod-external (an operator action / API
call), writes through the RAW store (never a shard view), and is safe to
re-run after a crash: a persisted `rebalancing` record carries
everything needed to resume the wait-and-flip.

Copy of the reference's `etl_tpu/sharding/coordinator.py`. The wait for
the losers reads durable progress through the raw store it is given; with
a `PostgresStore` that read goes over the wire, once per poll.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from ..analysis.annotations import domain, handoff
from ..models.errors import ErrorKind, EtlError
from ..models.lsn import Lsn
from ..postgres.slots import apply_slot_name, table_sync_slot_name
from ..telemetry.metrics import (ETL_SHARD_COUNT, ETL_SHARD_EPOCH,
                                 ETL_SHARD_REBALANCE_DURATION_SECONDS,
                                 ETL_SHARD_REBALANCE_MOVED_TABLES_TOTAL,
                                 ETL_SHARD_TABLES, registry)
from .shardmap import (STATUS_REBALANCING, STATUS_STEADY, ShardAssignment,
                       ShardMap, moved_tables)

logger = logging.getLogger("etl_tpu_torch.sharding")


@dataclass
class RebalanceResult:
    old_epoch: int
    new_epoch: int
    old_shard_count: int
    new_shard_count: int
    fence_lsn: int
    moved: dict = field(default_factory=dict)  # {tid: (old, new)}
    duration_s: float = 0.0

    def describe(self) -> dict:
        return {
            "old_epoch": self.old_epoch, "new_epoch": self.new_epoch,
            "old_shard_count": self.old_shard_count,
            "new_shard_count": self.new_shard_count,
            "fence_lsn": self.fence_lsn,
            "moved": {str(t): list(m) for t, m in sorted(self.moved.items())},
            "moved_tables": len(self.moved),
            "duration_s": round(self.duration_s, 3),
        }


class ShardCoordinator:
    """Drives the assignment record in the SHARED store. `source_factory`
    opens control connections to the source database (slot creation /
    WAL position / slot cleanup)."""

    def __init__(self, store, pipeline_id: int, source_factory,
                 quiesce_timeout_s: float = 60.0,
                 poll_interval_s: float = 0.05):
        self.store = store
        self.pipeline_id = pipeline_id
        self.source_factory = source_factory
        self.quiesce_timeout_s = quiesce_timeout_s
        self.poll_interval_s = poll_interval_s

    # -- assignment access ----------------------------------------------------

    @handoff  # the ONE seam that mutates the multi-process shard fence:
    # every epoch/status transition pods act on goes through here, so a
    # crashed coordinator always leaves a resumable record behind
    async def _persist_assignment(self,
                                  assignment: ShardAssignment) -> None:
        await self.store.update_shard_assignment(assignment)

    @domain("coordinator")
    async def current(self, bootstrap_shard_count: int = 1
                      ) -> ShardAssignment:
        assignment = await self.store.get_shard_assignment()
        if assignment is None:
            assignment = ShardAssignment(
                epoch=0, shard_count=bootstrap_shard_count)
            await self._persist_assignment(assignment)
        return assignment

    async def _published_tables(self) -> list:
        # a deliberate cross-shard sweep: the coordinator owns the GLOBAL
        # view (it is not @shard_scoped, and must never run inside a pod)
        return sorted(await self.store.get_table_states())

    def publish_topology_metrics(self, assignment: ShardAssignment,
                                 tables) -> None:
        registry.gauge_set(ETL_SHARD_COUNT, assignment.shard_count)
        registry.gauge_set(ETL_SHARD_EPOCH, assignment.epoch)
        for shard, owned in assignment.shard_map().partition(tables).items():
            registry.gauge_set(ETL_SHARD_TABLES, len(owned),
                               labels={"shard": str(shard)})

    # -- two-phase rebalance --------------------------------------------------

    @domain("coordinator")
    async def add_shard(self) -> RebalanceResult:
        """Grow K→K+1 (the new shard is index K). Re-running after a
        crash or quiesce timeout RESUMES the persisted in-flight record
        (same fence, same target); a record targeting a DIFFERENT
        transition is refused."""
        assignment = await self.current()
        new_count = assignment.shard_count + 1
        resume = self._resumable(assignment, new_count)
        source = self.source_factory()
        await source.connect()
        try:
            # phase 1a: the new shard's apply slot anchors the fence —
            # WAL ≥ fence is retained for the new pod from this instant
            new_slot = apply_slot_name(self.pipeline_id, new_count - 1)
            if resume is not None:
                fence = resume  # the persisted record's fence wins
            else:
                existing = await source.get_slot(new_slot)
                if existing is not None:
                    # slot created but the record write was lost: its
                    # confirmed flush still marks the retention point
                    fence = existing.confirmed_flush_lsn
                else:
                    fence = (await source.create_slot(
                        new_slot)).consistent_point
            return await self._run_rebalance(assignment, new_count,
                                             fence, source)
        finally:
            await source.close()

    @domain("coordinator")
    async def abort_rebalance(self) -> None:
        """Roll an in-flight rebalance back to steady at the SAME epoch
        (pods never noticed); an add-shard's already-created slot is
        deleted so it cannot pin WAL."""
        assignment = await self.current()
        if not assignment.rebalancing:
            return
        if assignment.next_shard_count > assignment.shard_count:
            source = self.source_factory()
            await source.connect()
            try:
                await source.delete_slot(apply_slot_name(
                    self.pipeline_id, assignment.next_shard_count - 1))
            finally:
                await source.close()
        await self._persist_assignment(ShardAssignment(
            epoch=assignment.epoch, shard_count=assignment.shard_count,
            status=STATUS_STEADY))

    @domain("coordinator")
    async def remove_shard(self) -> RebalanceResult:
        """Shrink K→K-1 (the TOP shard retires; its tables re-home onto
        the survivors). The retired shard's slots are deleted after the
        flip. Re-running resumes an in-flight shrink like add_shard."""
        assignment = await self.current()
        if assignment.shard_count < 2:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           "cannot remove the only shard")
        new_count = assignment.shard_count - 1
        resume = self._resumable(assignment, new_count)
        source = self.source_factory()
        await source.connect()
        try:
            fence = resume if resume is not None \
                else await source.get_current_wal_lsn()
            result = await self._run_rebalance(assignment, new_count,
                                               fence, source)
            # cleanup: the retired shard's slots must not pin WAL forever
            retired = assignment.shard_count - 1
            await source.delete_slot(
                apply_slot_name(self.pipeline_id, retired))
            for tid, (old, _new) in result.moved.items():
                if old == retired:
                    await source.delete_slot(table_sync_slot_name(
                        self.pipeline_id, tid, retired))
            return result
        finally:
            await source.close()

    async def _run_rebalance(self, assignment: ShardAssignment,
                             new_count: int, fence: Lsn,
                             source) -> RebalanceResult:
        t0 = time.monotonic()
        old_map = assignment.shard_map()
        new_map = ShardMap(new_count, assignment.epoch + 1)
        tables = await self._published_tables()
        moved = moved_tables(old_map, new_map, tables)

        # phase 1b: persist the in-flight record — a coordinator crash
        # after this point leaves enough state to resume (same fence,
        # same moved set; re-running recomputes both identically)
        await self._persist_assignment(ShardAssignment(
            epoch=assignment.epoch, shard_count=assignment.shard_count,
            status=STATUS_REBALANCING, fence_lsn=int(fence),
            next_shard_count=new_count,
            moved=tuple((tid, a, b) for tid, (a, b) in sorted(moved.items()))))

        # phase 1c: quiesce — every shard LOSING tables must be durably
        # applied up to the fence before ownership flips away from it
        losing = sorted({a for (a, _b) in moved.values()
                         if a < assignment.shard_count})
        await self._wait_durable(losing, fence)

        # phase 2: flip. From here the old epoch is refused by the store
        # fence; the orchestrator rolls pods onto the new topology.
        flipped = ShardAssignment(epoch=assignment.epoch + 1,
                                  shard_count=new_count,
                                  status=STATUS_STEADY)
        await self._persist_assignment(flipped)

        duration = time.monotonic() - t0
        registry.histogram_observe(ETL_SHARD_REBALANCE_DURATION_SECONDS,
                                   duration)
        registry.counter_inc(ETL_SHARD_REBALANCE_MOVED_TABLES_TOTAL,
                             len(moved))
        self.publish_topology_metrics(flipped, tables)
        logger.info(
            "rebalanced %d->%d shards at epoch %d (fence %s, %d tables "
            "moved, %.3fs)", assignment.shard_count, new_count,
            flipped.epoch, fence, len(moved), duration)
        return RebalanceResult(
            old_epoch=assignment.epoch, new_epoch=flipped.epoch,
            old_shard_count=assignment.shard_count,
            new_shard_count=new_count, fence_lsn=int(fence),
            moved=moved, duration_s=duration)

    def _resumable(self, assignment: ShardAssignment,
                   new_count: int) -> "Lsn | None":
        """None = steady (fresh rebalance); the persisted fence when the
        in-flight record targets the SAME transition (crash/timeout
        retry); typed error when it targets a different one — that
        rebalance must finish or be abort_rebalance()d first."""
        if not assignment.rebalancing:
            return None
        if assignment.next_shard_count == new_count:
            return Lsn(assignment.fence_lsn)
        raise EtlError(
            ErrorKind.INVALID_STATE_TRANSITION,
            f"a rebalance to shard_count="
            f"{assignment.next_shard_count} is already in flight at "
            f"epoch {assignment.epoch} (fence "
            f"{assignment.fence_lsn}); finish it (re-run the same "
            f"action) or abort_rebalance() first")

    async def _wait_durable(self, shards, fence: Lsn) -> None:
        """Poll the per-shard apply-slot durable progress until every
        listed shard has applied through the fence."""
        deadline = time.monotonic() + self.quiesce_timeout_s
        pending = list(shards)
        while pending:
            still = []
            for shard in pending:
                key = apply_slot_name(self.pipeline_id, shard)
                durable = await self.store.get_durable_progress(key)
                if durable is None or durable < fence:
                    still.append(shard)
            pending = still
            if not pending:
                return
            if time.monotonic() >= deadline:
                raise EtlError(
                    ErrorKind.TIMEOUT,
                    f"quiesce timed out: shard(s) {pending} never reached "
                    f"the fence LSN {int(fence)} within "
                    f"{self.quiesce_timeout_s}s")
            await asyncio.sleep(self.poll_interval_s)
