"""In-memory store + the notifying test wrapper.

Reference parity: `MemoryStore` (crates/etl/src/store/both/memory.rs) and
`NotifyingStore` (test_utils/notifying_store.rs:27-70) — tests await
specific state transitions instead of sleeping; this is load-bearing for
deterministic tests (SURVEY §4 fixtures note).

Copy of the reference's `etl_tpu/store/memory.py`.
"""

from __future__ import annotations

import asyncio
from collections import defaultdict

from ..chaos import failpoints
from ..models.errors import ErrorKind, EtlError
from ..models.lsn import Lsn
from ..models.schema import ReplicatedTableSchema, SnapshotId, TableId
from ..models.table_state import TableState, TableStateType
from ..sharding.shardmap import ShardAssignment
from .base import (DeadLetterEntry, DestinationTableMetadata, PipelineStore,
                   ProgressKey, QuarantineRecord)


class MemoryStore(PipelineStore):
    def __init__(self) -> None:
        self._states: dict[TableId, TableState] = {}
        self._progress: dict[ProgressKey, Lsn] = {}
        self._schemas: dict[TableId, list[tuple[SnapshotId, ReplicatedTableSchema]]] = \
            defaultdict(list)  # sorted by snapshot id
        self._dest_meta: dict[TableId, DestinationTableMetadata] = {}
        self._shard_assignment: ShardAssignment | None = None
        self._autoscale_journal: dict | None = None
        self._fleet_spec: dict | None = None
        self._fleet_journals: dict[int, dict] = {}
        # dead-letter surface: WAL-coordinate key -> entry (the keyed
        # upsert that makes crash-era re-appends idempotent)
        self._dead_letters: dict[tuple, DeadLetterEntry] = {}
        self._next_dlq_id = 1
        self._quarantine: dict[TableId, QuarantineRecord] = {}

    # -- StateStore ----------------------------------------------------------

    async def get_table_states(self) -> dict[TableId, TableState]:
        return dict(self._states)

    async def get_table_state(self, table_id: TableId) -> TableState | None:
        return self._states.get(table_id)

    async def update_table_state(self, table_id: TableId,
                                 state: TableState) -> None:
        if not state.is_persistent:
            raise EtlError(ErrorKind.STORE_SERIALIZATION_FAILED,
                           f"{state.type.value} is memory-only, not storable")
        failpoints.fail_point(failpoints.STORE_STATE_COMMIT)
        await failpoints.stall_point(failpoints.STORE_STATE_COMMIT)
        self._states[table_id] = state

    async def delete_table_state(self, table_id: TableId) -> None:
        self._states.pop(table_id, None)

    async def get_durable_progress(self, key: ProgressKey) -> Lsn | None:
        return self._progress.get(key)

    async def update_durable_progress(self, key: ProgressKey,
                                      lsn: Lsn) -> bool:
        failpoints.fail_point(failpoints.STORE_PROGRESS_COMMIT)
        await failpoints.stall_point(failpoints.STORE_PROGRESS_COMMIT)
        cur = self._progress.get(key)
        if cur is not None and lsn < cur:
            return False
        self._progress[key] = lsn
        return True

    async def delete_durable_progress(self, key: ProgressKey) -> None:
        self._progress.pop(key, None)

    async def get_destination_metadata(
            self, table_id: TableId) -> DestinationTableMetadata | None:
        return self._dest_meta.get(table_id)

    async def update_destination_metadata(
            self, meta: DestinationTableMetadata) -> None:
        self._dest_meta[meta.table_id] = meta

    async def delete_destination_metadata(self, table_id: TableId) -> None:
        self._dest_meta.pop(table_id, None)

    # -- shard assignment ----------------------------------------------------

    async def get_shard_assignment(self) -> ShardAssignment | None:
        return self._shard_assignment

    async def update_shard_assignment(self,
                                      assignment: ShardAssignment) -> None:
        cur = self._shard_assignment
        if cur is not None and assignment.epoch < cur.epoch:
            raise EtlError(
                ErrorKind.PROGRESS_REGRESSION,
                f"shard assignment epoch regression: {cur.epoch} -> "
                f"{assignment.epoch}")
        failpoints.fail_point(failpoints.STORE_SHARD_COMMIT)
        await failpoints.stall_point(failpoints.STORE_SHARD_COMMIT)
        self._shard_assignment = assignment

    # -- autoscale decision journal ------------------------------------------

    async def get_autoscale_journal(self) -> dict | None:
        return self._autoscale_journal

    async def update_autoscale_journal(self, journal: dict) -> None:
        cur = self._autoscale_journal
        if cur is not None and int(journal.get("next_id", 0)) \
                < int(cur.get("next_id", 0)):
            raise EtlError(
                ErrorKind.PROGRESS_REGRESSION,
                f"autoscale journal id regression: {cur.get('next_id')} "
                f"-> {journal.get('next_id')}")
        failpoints.fail_point(failpoints.STORE_AUTOSCALE_COMMIT)
        await failpoints.stall_point(failpoints.STORE_AUTOSCALE_COMMIT)
        self._autoscale_journal = journal

    # -- fleet spec / actuation journals -------------------------------------

    async def get_fleet_spec(self) -> dict | None:
        return self._fleet_spec

    async def update_fleet_spec(self, spec: dict) -> None:
        cur = self._fleet_spec
        if cur is not None and int(spec.get("spec_version", 0)) \
                < int(cur.get("spec_version", 0)):
            raise EtlError(
                ErrorKind.PROGRESS_REGRESSION,
                f"fleet spec version regression: {cur.get('spec_version')} "
                f"-> {spec.get('spec_version')}")
        failpoints.fail_point(failpoints.STORE_FLEET_COMMIT)
        await failpoints.stall_point(failpoints.STORE_FLEET_COMMIT)
        self._fleet_spec = spec

    async def get_fleet_journal(self, pipeline_id: int) -> dict | None:
        return self._fleet_journals.get(int(pipeline_id))

    async def get_fleet_journals(self) -> dict[int, dict]:
        return dict(self._fleet_journals)

    async def update_fleet_journal(self, pipeline_id: int,
                                   journal: dict) -> None:
        cur = self._fleet_journals.get(int(pipeline_id))
        if cur is not None and int(journal.get("next_id", 0)) \
                < int(cur.get("next_id", 0)):
            raise EtlError(
                ErrorKind.PROGRESS_REGRESSION,
                f"fleet journal id regression for pipeline {pipeline_id}: "
                f"{cur.get('next_id')} -> {journal.get('next_id')}")
        failpoints.fail_point(failpoints.STORE_FLEET_COMMIT)
        await failpoints.stall_point(failpoints.STORE_FLEET_COMMIT)
        self._fleet_journals[int(pipeline_id)] = journal

    # -- dead-letter / quarantine surface ------------------------------------

    async def append_dead_letters(self, entries) -> list[int]:
        from dataclasses import replace

        import time

        failpoints.fail_point(failpoints.STORE_DLQ_COMMIT)
        await failpoints.stall_point(failpoints.STORE_DLQ_COMMIT)
        now = int(time.time())  # store-stamped compaction clock
        ids = []
        for e in entries:
            cur = self._dead_letters.get(e.key())
            if cur is not None:
                # idempotent keyed upsert: a re-streamed batch that
                # re-isolates the same poison row accumulates attempts
                # instead of duplicating the entry
                merged = replace(cur, attempts=cur.attempts + e.attempts,
                                 error_kind=e.error_kind,
                                 detail=e.detail or cur.detail,
                                 columns=e.columns or cur.columns,
                                 updated_at=now)
                self._dead_letters[e.key()] = merged
                ids.append(merged.entry_id)
                continue
            stored = replace(e, entry_id=self._next_dlq_id,
                             updated_at=now)
            self._next_dlq_id += 1
            self._dead_letters[stored.key()] = stored
            ids.append(stored.entry_id)
        return ids

    async def list_dead_letters(self, table_id=None,
                                status="dead") -> list[DeadLetterEntry]:
        out = [e for e in self._dead_letters.values()
               if (table_id is None or e.table_id == table_id)
               and (status is None or e.status == status)]
        out.sort(key=lambda e: e.entry_id)
        return out

    async def get_dead_letter(self, entry_id: int) -> DeadLetterEntry | None:
        for e in self._dead_letters.values():
            if e.entry_id == entry_id:
                return e
        return None

    async def set_dead_letter_status(self, entry_id: int,
                                     status: str) -> None:
        from dataclasses import replace

        import time

        for k, e in self._dead_letters.items():
            if e.entry_id == entry_id:
                self._dead_letters[k] = replace(e, status=status,
                                                updated_at=int(time.time()))
                return
        raise EtlError(ErrorKind.STATE_STORE_FAILED,
                       f"no dead-letter entry {entry_id}")

    async def purge_dead_letters(self, older_than_s, statuses=(
            "replayed", "discarded")) -> int:
        import time

        cutoff = int(time.time() - older_than_s)
        doomed = [k for k, e in self._dead_letters.items()
                  if e.status in statuses and e.updated_at < cutoff]
        for k in doomed:
            del self._dead_letters[k]
        return len(doomed)

    async def get_quarantined_tables(self) -> dict[TableId, QuarantineRecord]:
        return dict(self._quarantine)

    async def set_table_quarantine(self, table_id: TableId,
                                   record: QuarantineRecord | None) -> None:
        failpoints.fail_point(failpoints.STORE_DLQ_COMMIT)
        await failpoints.stall_point(failpoints.STORE_DLQ_COMMIT)
        if record is None:
            self._quarantine.pop(table_id, None)
        else:
            self._quarantine[table_id] = record

    # -- SchemaStore ---------------------------------------------------------

    async def store_table_schema(self, schema: ReplicatedTableSchema,
                                 snapshot_id: SnapshotId) -> None:
        failpoints.fail_point(failpoints.STORE_SCHEMA_COMMIT)
        await failpoints.stall_point(failpoints.STORE_SCHEMA_COMMIT)
        versions = self._schemas[schema.id]
        versions[:] = [(s, v) for s, v in versions if s != snapshot_id]
        versions.append((snapshot_id, schema))
        versions.sort(key=lambda p: p[0])

    async def get_table_schema(
            self, table_id: TableId,
            at_snapshot: SnapshotId | None = None
    ) -> ReplicatedTableSchema | None:
        versions = self._schemas.get(table_id)
        if not versions:
            return None
        if at_snapshot is None:
            return versions[-1][1]
        best = None
        for s, v in versions:
            if s <= at_snapshot:
                best = v
            else:
                break
        return best

    async def get_schema_versions(self, table_id: TableId) -> list[SnapshotId]:
        return [s for s, _ in self._schemas.get(table_id, [])]

    async def get_table_ids_with_schemas(self) -> list[TableId]:
        return [tid for tid, v in self._schemas.items() if v]

    async def prune_schema_versions(self, table_id: TableId,
                                    older_than: SnapshotId) -> int:
        versions = self._schemas.get(table_id)
        if not versions:
            return 0
        keep_from = 0
        for i, (s, _) in enumerate(versions):
            if s <= older_than:
                keep_from = i
        removed = keep_from
        versions[:] = versions[keep_from:]
        return removed

    async def delete_table_schemas(self, table_id: TableId) -> None:
        self._schemas.pop(table_id, None)


class NotifyingStore(MemoryStore):
    """MemoryStore that lets tests await specific table-state transitions
    (reference NotifyingStore, notifying_store.rs:27-70)."""

    def __init__(self) -> None:
        super().__init__()
        self._waiters: list[tuple] = []  # (table_id, state_type, future)
        self.state_history: list[tuple[TableId, TableState]] = []

    async def update_table_state(self, table_id: TableId,
                                 state: TableState) -> None:
        await super().update_table_state(table_id, state)
        self.state_history.append((table_id, state))
        self._notify(table_id, state)

    def _notify(self, table_id: TableId, state: TableState) -> None:
        still = []
        for tid, st, fut in self._waiters:
            if tid == table_id and st is state.type and not fut.done():
                fut.set_result(state)
            elif not fut.done():
                still.append((tid, st, fut))
        self._waiters = still

    def notify_on(self, table_id: TableId,
                  state_type: TableStateType) -> "asyncio.Future[TableState]":
        """Future resolving when the table ENTERS the given state (resolves
        immediately if already there — no missed-wakeup, reference
        worker.rs:211-264 subscribe-under-lock)."""
        fut: asyncio.Future[TableState] = \
            asyncio.get_event_loop().create_future()
        cur = self._states.get(table_id)
        if cur is not None and cur.type is state_type:
            fut.set_result(cur)
        else:
            self._waiters.append((table_id, state_type, fut))
        return fut
