"""In-memory destination + the fault-scripting test wrapper.

Reference parity: `MemoryDestination` (crates/etl/src/test_utils) and
`TestDestinationWrapper` with a scripted FIFO fault queue per operation
(test_utils/faults.rs:29-70): Reject / fail-after-apply ("lost-response
ambiguity") / hold / delay — the machinery behind the faulty-destination
integration suite (SURVEY §4.3).

Copy of the reference's `etl_tpu/destinations/memory.py`.
"""

from __future__ import annotations

import asyncio
import enum
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Sequence

from ..analysis.annotations import transactional_commit
from ..models.errors import ErrorKind, EtlError
from ..models.event import Event
from ..models.schema import ReplicatedTableSchema, TableId
from ..models.table_row import ColumnarBatch, TableRow
from .base import (CommitRange, Destination, WriteAck, event_coordinate,
                   expand_batch_events)
from .util import TaskSet


class MemoryDestination(Destination):
    """Durable-by-definition in-memory destination: rows and events are
    captured in plain lists for assertions."""

    def __init__(self) -> None:
        self.table_rows: dict[TableId, list[TableRow]] = defaultdict(list)
        self.events: list[Event] = []
        self.dropped_tables: list[TableId] = []
        self.truncated_tables: list[TableId] = []
        self.started = False

    async def startup(self) -> None:
        self.started = True

    async def write_table_rows(self, schema: ReplicatedTableSchema,
                               batch: ColumnarBatch) -> WriteAck:
        self.table_rows[schema.id].extend(batch.to_rows())
        return WriteAck.durable()

    async def write_events(self, events: Sequence[Event]) -> WriteAck:
        self.events.extend(expand_batch_events(events))
        return WriteAck.durable()

    async def drop_table(self, table_id: TableId,
                         schema=None) -> None:
        self.table_rows.pop(table_id, None)
        self.dropped_tables.append(table_id)

    async def truncate_table(self, table_id: TableId) -> None:
        self.table_rows[table_id] = []
        self.truncated_tables.append(table_id)


class TransactionalMemoryDestination(MemoryDestination):
    """Exactly-once fake sink: the in-memory analogue of a sink that
    records the acked WAL coordinate range atomically with the data
    (BigQuery MERGE, ClickHouse dedup tokens, Iceberg snapshot
    properties, Snowpipe offsets). Streamed writes dedup against the
    monotone high-water coordinate — a blind re-stream's rows at
    coordinates ≤ high-water are dropped, whatever the batch boundaries
    of the retry. Replay ranges (`commit.replay`) dedup by EXACT row key
    instead and never move the high-water mark. `high_water_log` is the
    chaos monotonicity evidence; `recover_*` knobs script recovery-query
    faults for the satellite-1 degradation tests."""

    def __init__(self) -> None:
        super().__init__()
        self.high_water: "tuple[int, int]" = (0, 0)
        self.committed_end_lsn = 0
        self.high_water_log: "list[tuple[int, int]]" = []
        self.dedup_skipped_rows = 0
        self.replayed_keys: set = set()
        self.replay_skipped_rows = 0
        self.recover_calls = 0
        # FIFO of EtlErrors the next recover_high_water() calls raise
        # (transient-recovery and degrade-to-blind-re-stream scripting)
        self.recover_faults: "deque[EtlError]" = deque()
        self.recover_delay_s = 0.0
        self.uncoordinated_writes = 0  # CDC writes that bypassed the seam

    def supports_transactional_commit(self) -> bool:
        return True

    async def write_events(self, events: Sequence[Event]) -> WriteAck:
        self.uncoordinated_writes += 1
        return await super().write_events(events)

    @staticmethod
    def _row_key(e: Event) -> "tuple | None":
        coord = event_coordinate(e)
        if coord is None:
            return None
        tid = getattr(getattr(e, "schema", None), "id", None)
        return (tid, coord[0], coord[1], type(e).__name__)

    @transactional_commit
    async def write_event_batches_committed(
            self, events: Sequence[Event],
            commit: "CommitRange | None") -> WriteAck:
        rows = expand_batch_events(list(events))
        if commit is not None and commit.replay:
            kept = []
            for e in rows:
                key = self._row_key(e)
                if key is not None and key in self.replayed_keys:
                    self.replay_skipped_rows += 1
                    continue
                if key is not None:
                    self.replayed_keys.add(key)
                kept.append(e)
        else:
            kept = []
            for e in rows:
                coord = event_coordinate(e)
                if coord is not None and coord <= self.high_water:
                    self.dedup_skipped_rows += 1
                    continue
                kept.append(e)
        # data + coordinate range land in ONE synchronous step — no await
        # between them, so a kill can never observe data without its range
        self.events.extend(kept)
        if commit is not None and not commit.replay:
            if commit.high > self.high_water:
                self.high_water = commit.high
            self.committed_end_lsn = max(
                self.committed_end_lsn, commit.commit_end_lsn or 0)
            self.high_water_log.append(self.high_water)
        if kept or commit is None:
            return WriteAck.durable()
        # fully-deduped flush: nothing was written, so don't fire the
        # DESTINATION_WRITE chaos site for a phantom destination write
        fut = asyncio.get_event_loop().create_future()
        fut.set_result(None)
        return WriteAck(fut)

    async def recover_high_water(self) -> "CommitRange | None":
        self.recover_calls += 1
        if self.recover_delay_s > 0:
            await asyncio.sleep(self.recover_delay_s)
        if self.recover_faults:
            raise self.recover_faults.popleft()
        if not self.high_water_log:
            return None
        return CommitRange(high=self.high_water,
                           commit_end_lsn=self.committed_end_lsn or None)


class FaultKind(enum.Enum):
    REJECT = "reject"  # fail before applying
    FAIL_AFTER_APPLY = "fail_after_apply"  # apply, then report failure
    HOLD = "hold"  # apply, ack Accepted, durable only on release()
    DELAY = "delay"  # apply after a delay, then durable


@dataclass
class FaultAction:
    kind: FaultKind
    delay_s: float = 0.0
    release_event: asyncio.Event | None = None


class FaultInjectingDestination(Destination):
    """Wraps a destination with per-operation FIFO fault scripts
    (reference TestDestinationWrapper)."""

    def __init__(self, inner: Destination):
        self.inner = inner
        self._faults: dict[str, deque[FaultAction]] = defaultdict(deque)
        self.write_events_calls = 0
        self.write_rows_calls = 0
        # strong refs: a bare ensure_future handle is GC-collectable and
        # the loop may cancel the release task mid-HOLD (etl-lint:
        # orphaned-task)
        self._tasks = TaskSet()
        self._held_acks: list[asyncio.Future] = []
        self._shut_down = False
        # HOLD acks shutdown had to force-fail because nothing released
        # them — the chaos no-leaks invariant reads this (counting
        # _held_acks after shutdown would always see the cleared list)
        self.forced_held_acks = 0

    def script(self, op: str, action: FaultAction) -> None:
        """op: one of write_table_rows / write_events / drop_table /
        truncate_table."""
        self._faults[op].append(action)

    def _next_fault(self, op: str) -> FaultAction | None:
        q = self._faults.get(op)
        return q.popleft() if q else None

    async def _apply_fault(self, op: str, run) -> WriteAck:
        fault = self._next_fault(op)
        if fault is None:
            return await run()
        if fault.kind is FaultKind.REJECT:
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           f"scripted reject on {op}")
        if fault.kind is FaultKind.FAIL_AFTER_APPLY:
            await run()
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           f"scripted fail-after-apply on {op}")
        if fault.kind is FaultKind.DELAY:
            await asyncio.sleep(fault.delay_s)
            return await run()
        # HOLD: apply now, durable on release
        await run()
        ack, fut = WriteAck.accepted()
        release = fault.release_event or asyncio.Event()

        async def _release() -> None:
            await release.wait()  # etl-lint: ignore[unbounded-await] — waiting for the test script's release IS the HOLD fault; the TaskSet cancels it at shutdown
            if not fut.done():
                fut.set_result(None)
            if fut in self._held_acks:  # released: nothing to resolve at
                # shutdown (and the list must not grow per HOLD); may be
                # gone already if shutdown swept mid-release
                self._held_acks.remove(fut)

        if self._shut_down:
            # the writer was suspended in `await run()` while shutdown
            # swept _held_acks — registering now would hang the consumer
            self._fail_held(fut)
            return ack
        self._tasks.spawn(_release())
        self._held_acks.append(fut)
        return ack

    @staticmethod
    def _fail_held(fut: asyncio.Future) -> None:
        fut.set_exception(EtlError(
            ErrorKind.DESTINATION_FAILED,
            "destination shut down with HOLD pending"))
        # the consumer may be gone already (cancelled apply loop); mark
        # retrieved so GC doesn't log "exception was never retrieved" —
        # a later await still sees the error
        fut.exception()

    async def startup(self) -> None:
        # a restarted pipeline reuses the wrapper: new HOLDs must be
        # registrable again after a previous clean shutdown
        self._shut_down = False
        await self.inner.startup()

    async def shutdown(self) -> None:
        self._shut_down = True  # writers mid-`await run()` must not
        # register new held acks after the sweep below
        await self._tasks.cancel_all()
        # a cancelled (or never-started) release task can't resolve its
        # ack — a consumer awaiting durability would hang forever
        for fut in self._held_acks:
            if not fut.done():
                self.forced_held_acks += 1
                self._fail_held(fut)
        self._held_acks.clear()
        await self.inner.shutdown()

    async def write_table_rows(self, schema: ReplicatedTableSchema,
                               batch: ColumnarBatch) -> WriteAck:
        self.write_rows_calls += 1
        return await self._apply_fault(
            "write_table_rows",
            lambda: self.inner.write_table_rows(schema, batch))

    async def write_events(self, events: Sequence[Event]) -> WriteAck:
        self.write_events_calls += 1
        return await self._apply_fault(
            "write_events", lambda: self.inner.write_events(events))

    # columnar seam: SAME fault-script keys as the row entry points, so
    # every chaos scenario scripted against write_table_rows/write_events
    # exercises the batch-granularity seam unchanged
    async def write_table_batch(self, schema: ReplicatedTableSchema,
                                batch: ColumnarBatch) -> WriteAck:
        self.write_rows_calls += 1
        return await self._apply_fault(
            "write_table_rows",
            lambda: self.inner.write_table_batch(schema, batch))

    async def write_event_batches(self, events: Sequence[Event]) -> WriteAck:
        self.write_events_calls += 1
        return await self._apply_fault(
            "write_events",
            lambda: self.inner.write_event_batches(events))

    # transactional seam: same "write_events" fault key, so every chaos
    # script against the CDC path exercises the exactly-once seam too
    def supports_transactional_commit(self) -> bool:
        return self.inner.supports_transactional_commit()

    async def write_event_batches_committed(self, events: Sequence[Event],
                                            commit) -> WriteAck:
        self.write_events_calls += 1
        return await self._apply_fault(
            "write_events",
            lambda: self.inner.write_event_batches_committed(events, commit))

    async def recover_high_water(self):
        return await self._apply_fault(
            "recover_high_water",
            lambda: self.inner.recover_high_water())

    async def drop_table(self, table_id: TableId,
                         schema=None) -> None:
        async def run():
            await self.inner.drop_table(table_id, schema)
            return WriteAck.durable()

        await self._apply_fault("drop_table", run)

    async def truncate_table(self, table_id: TableId) -> None:
        async def run():
            await self.inner.truncate_table(table_id)
            return WriteAck.durable()

        await self._apply_fault("truncate_table", run)


class PoisonRejectingDestination(Destination):
    """Wraps a destination with content-based rejection: any CDC write
    whose rows contain a marked poison value fails with
    `DESTINATION_REJECTED` — the deterministic analogue of an
    unencodable value / schema-drift row a real destination 4xxes. The
    trigger the isolation protocol (runtime/poison.py) bisects on.

    Rejection is CONTENT-keyed, not call-keyed (unlike the scripted
    FaultInjectingDestination FIFO): re-writing the same poisoned batch
    fails again, a sub-batch without the poison row succeeds — exactly
    the semantics binary bisection needs. The initial-copy path passes
    through untouched (poison-pill isolation is a streaming-CDC
    boundary; copy failures keep the per-table error states)."""

    def __init__(self, inner: Destination, marker: str = "POISON",
                 is_poison=None):
        self.inner = inner
        # egress/billing labels must name the REAL sink, not the wrapper
        self.telemetry_name = getattr(inner, "telemetry_name",
                                      type(inner).__name__)
        self.marker = marker
        self._is_poison = is_poison or (
            lambda v: isinstance(v, str) and v.startswith(marker))
        self.rejections = 0
        self.rejected_values: list = []

    def _scan(self, events: Sequence[Event]) -> None:
        from ..models.event import (DecodedBatchEvent, DeleteEvent,
                                    InsertEvent, UpdateEvent)

        for ev in events:
            if isinstance(ev, (InsertEvent, UpdateEvent)):
                rows = [ev.row]
                tid = ev.schema.id
            elif isinstance(ev, DeleteEvent):
                rows = [ev.old_row]
                tid = ev.schema.id
            elif isinstance(ev, DecodedBatchEvent):
                rows = ev.batch.to_rows()
                tid = ev.schema.id
            else:
                continue
            for row in rows:
                for v in row.values:
                    if self._is_poison(v):
                        self.rejections += 1
                        self.rejected_values.append(v)
                        raise EtlError(
                            ErrorKind.DESTINATION_REJECTED,
                            f"unencodable value in table {tid}: {v!r}")

    async def startup(self) -> None:
        await self.inner.startup()

    async def shutdown(self) -> None:
        await self.inner.shutdown()

    async def write_table_rows(self, schema: ReplicatedTableSchema,
                               batch: ColumnarBatch) -> WriteAck:
        return await self.inner.write_table_rows(schema, batch)

    async def write_table_batch(self, schema: ReplicatedTableSchema,
                                batch: ColumnarBatch) -> WriteAck:
        return await self.inner.write_table_batch(schema, batch)

    async def write_events(self, events: Sequence[Event]) -> WriteAck:
        self._scan(events)
        return await self.inner.write_events(events)

    async def write_event_batches(self, events: Sequence[Event]) -> WriteAck:
        self._scan(events)
        return await self.inner.write_event_batches(events)

    def supports_transactional_commit(self) -> bool:
        return self.inner.supports_transactional_commit()

    async def write_event_batches_committed(self, events: Sequence[Event],
                                            commit) -> WriteAck:
        self._scan(events)
        return await self.inner.write_event_batches_committed(events, commit)

    async def recover_high_water(self):
        return await self.inner.recover_high_water()

    async def drop_table(self, table_id: TableId, schema=None) -> None:
        await self.inner.drop_table(table_id, schema)

    async def truncate_table(self, table_id: TableId) -> None:
        await self.inner.truncate_table(table_id)
