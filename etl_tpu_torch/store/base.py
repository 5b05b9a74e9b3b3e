"""Store traits: state, schema, and cleanup interfaces.

Reference parity:
  - `StateStore` (crates/etl/src/store/state/base.rs:25-139): table
    replication states, monotonic durable progress LSN per worker,
    destination table metadata.
  - `SchemaStore` (crates/etl/src/store/schema/base.rs:19-69): table schemas
    versioned by `SnapshotId` (the LSN of the DDL message creating the
    version) with `get ≤ snapshot` semantics and pruning.
  - `TableStateLifecycleStore` (store/lifecycle.rs): compound operations
    spanning both (prepare-for-copy, reset, delete).

Contracts the implementations must uphold:
  - `update_durable_progress` is MONOTONIC: attempts to move the LSN
    backwards are ignored (reference state/base.rs:81-89).
  - Memory-only table states (SyncWait/Catchup) must never be persisted;
    `update_table_state` raises on them.

Copy of the reference's `etl_tpu/store/base.py`.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Sequence

from ..models.errors import ErrorKind, EtlError
from ..models.lsn import Lsn
from ..models.schema import ReplicatedTableSchema, SnapshotId, TableId
from ..models.table_state import TableState
from ..sharding.shardmap import ShardAssignment

# a worker's durable-progress key: the apply worker uses the pipeline slot
# name, table-sync workers their per-table slot name (reference progress
# rows keyed by slot)
ProgressKey = str


#: dead-letter entry lifecycle states (docs/dead-letter.md): `dead` =
#: parked awaiting operator action; `replayed` = re-delivered through
#: the destination seam (kept for audit); `discarded` = operator chose
#: to drop the row permanently (kept for audit).
DLQ_STATUS_DEAD = "dead"
DLQ_STATUS_REPLAYED = "replayed"
DLQ_STATUS_DISCARDED = "discarded"


@dataclass(frozen=True)
class DeadLetterEntry:
    """One poison row parked on the durable dead-letter surface.

    Identity is `(table_id, commit_lsn, tx_ordinal, change_type)` — the
    row's WAL coordinates — so a re-streamed batch that re-isolates the
    same poison row after a crash UPSERTS (attempts += 1) instead of
    duplicating, which is what makes both the isolation protocol and
    `replay` idempotent. `payload` is the dlq-codec JSON of the decoded
    row (etl_tpu/dlq/codec.py): enough to rebuild the event and push it
    back through `Destination.write_event_batches`."""

    entry_id: int  # store-assigned, monotonic per pipeline
    table_id: TableId
    commit_lsn: int
    tx_ordinal: int
    change_type: int  # models.event.ChangeType value
    payload: str  # dlq-codec JSON of the decoded row (+ old image)
    error_kind: str  # ErrorKind.name at isolation time
    detail: str  # the triggering error's detail, truncated
    attempts: int = 1  # write attempts that found this row poison
    status: str = DLQ_STATUS_DEAD
    # best-effort column attribution: replicated column names the
    # classified error detail names, comma-joined in schema order
    # (runtime/poison.py attribute_poison_columns); "" = unattributed
    columns: str = ""
    # store-stamped unix seconds of the last append/status transition —
    # the compaction clock (`python -m etl_tpu.dlq compact`)
    updated_at: int = 0

    def key(self) -> tuple:
        return (self.table_id, self.commit_lsn, self.tx_ordinal,
                self.change_type)

    def describe(self) -> dict:
        return {
            "entry_id": self.entry_id, "table_id": self.table_id,
            "commit_lsn": self.commit_lsn, "tx_ordinal": self.tx_ordinal,
            "change_type": self.change_type, "error_kind": self.error_kind,
            "detail": self.detail, "attempts": self.attempts,
            "status": self.status, "columns": self.columns,
            "updated_at": self.updated_at,
        }


@dataclass(frozen=True)
class QuarantineRecord:
    """A table parked out of the streaming path: its events bypass the
    destination and append straight to the dead-letter surface until an
    operator replays + unquarantines (docs/dead-letter.md)."""

    table_id: TableId
    since_lsn: int  # commit LSN of the flush that tripped the budget
    poison_rows: int  # dead-lettered rows that funded the budget
    parked_events: int = 0  # events parked since quarantine began
    reason: str = ""

    def to_json(self) -> dict:
        return {"table_id": self.table_id, "since_lsn": self.since_lsn,
                "poison_rows": self.poison_rows,
                "parked_events": self.parked_events, "reason": self.reason}

    @classmethod
    def from_json(cls, doc: dict) -> "QuarantineRecord":
        return cls(table_id=int(doc["table_id"]),
                   since_lsn=int(doc["since_lsn"]),
                   poison_rows=int(doc.get("poison_rows", 0)),
                   parked_events=int(doc.get("parked_events", 0)),
                   reason=str(doc.get("reason", "")))


@dataclass(frozen=True)
class DestinationTableMetadata:
    """What the destination knows about a table (name mapping + generation
    counter for truncate-versioned tables, reference table_mappings rows +
    BigQuery `table_N` successors)."""

    table_id: TableId
    destination_table_name: str
    generation: int = 0


class StateStore(abc.ABC):
    @abc.abstractmethod
    async def get_table_states(self) -> dict[TableId, TableState]: ...

    @abc.abstractmethod
    async def get_table_state(self, table_id: TableId) -> TableState | None: ...

    @abc.abstractmethod
    async def update_table_state(self, table_id: TableId,
                                 state: TableState) -> None: ...

    @abc.abstractmethod
    async def delete_table_state(self, table_id: TableId) -> None: ...

    @abc.abstractmethod
    async def get_durable_progress(self, key: ProgressKey) -> Lsn | None: ...

    @abc.abstractmethod
    async def update_durable_progress(self, key: ProgressKey,
                                      lsn: Lsn) -> bool:
        """Monotonic; returns False (and stores nothing) on regression."""

    @abc.abstractmethod
    async def delete_durable_progress(self, key: ProgressKey) -> None: ...

    # -- shard-assignment surface (docs/sharding.md) --------------------------
    # Concrete defaults rather than abstract methods: third-party and
    # test stores that never shard keep working unchanged; the memory and
    # sql backends override both with real persistence.

    async def get_shard_assignment(self) -> "ShardAssignment | None":
        """The authoritative (epoch, shard_count) record, or None when
        the pipeline has never been sharded."""
        return None

    async def update_shard_assignment(self,
                                      assignment: ShardAssignment) -> None:
        """Persist the assignment. Epochs are MONOTONIC: storing an
        assignment whose epoch is lower than the current record's is a
        typed error (a stale coordinator must never roll the fleet
        back)."""
        raise EtlError(
            ErrorKind.STATE_STORE_FAILED,
            f"{type(self).__name__} does not persist shard assignments")

    # -- autoscale decision-journal surface (docs/autoscale.md) ---------------
    # Same stance as the shard surface: concrete defaults so third-party
    # and test stores that never autoscale keep working unchanged; the
    # memory and sql backends override both with real persistence. The
    # journal is one small JSON document (etl_tpu/autoscale/controller.py
    # AutoscaleJournal shape) rewritten atomically per decision.

    async def get_autoscale_journal(self) -> "dict | None":
        """The persisted autoscale decision journal, or None when no
        controller has ever run against this pipeline."""
        return None

    async def update_autoscale_journal(self, journal: dict) -> None:
        """Persist the journal document. Decision ids inside it are
        MONOTONIC; storing a journal whose latest decision id is lower
        than the current record's is a typed error (a stale controller
        must never rewind the decision history)."""
        raise EtlError(
            ErrorKind.STATE_STORE_FAILED,
            f"{type(self).__name__} does not persist autoscale journals")

    # -- fleet spec / actuation-journal surface (docs/fleet.md) ---------------
    # Same stance again: concrete defaults so stores that never run under
    # a fleet coordinator keep working unchanged; the memory and sql
    # backends override with real persistence. The spec is one JSON
    # document (etl_tpu/fleet/spec.py FleetSpec shape) rewritten
    # atomically per edit; journals are one small JSON document per
    # PIPELINE (etl_tpu/fleet/journal.py ActuationJournal shape) so two
    # pipelines' actuations never contend on one row.

    async def get_fleet_spec(self) -> "dict | None":
        """The persisted desired-state fleet spec, or None when no
        operator has ever submitted one."""
        return None

    async def update_fleet_spec(self, spec: dict) -> None:
        """Persist the spec document. Spec versions are MONOTONIC;
        storing a spec whose version is lower than the current record's
        is a typed error (a stale operator or partitioned coordinator
        must never roll the fleet's desired state back)."""
        raise EtlError(
            ErrorKind.STATE_STORE_FAILED,
            f"{type(self).__name__} does not persist fleet specs")

    async def get_fleet_journal(self, pipeline_id: int) -> "dict | None":
        """One pipeline's persisted actuation journal, or None when the
        reconciler has never actuated it."""
        return None

    async def get_fleet_journals(self) -> "dict[int, dict]":
        """Every persisted actuation journal keyed by pipeline id — the
        successor coordinator's resume scan."""
        return {}

    async def update_fleet_journal(self, pipeline_id: int,
                                   journal: dict) -> None:
        """Persist one pipeline's journal document. Decision ids inside
        it are MONOTONIC; storing a journal whose next_id is lower than
        the current record's is a typed error (a stale coordinator must
        never rewind the actuation history)."""
        raise EtlError(
            ErrorKind.STATE_STORE_FAILED,
            f"{type(self).__name__} does not persist fleet journals")

    # -- dead-letter / quarantine surface (docs/dead-letter.md) ---------------
    # Concrete defaults like the shard and autoscale surfaces: stores
    # that never see poison keep working unchanged — READS return empty
    # (so the apply loop and CLI degrade to "no DLQ"), WRITES raise a
    # typed error (the isolation protocol then re-raises the original
    # poison error instead of silently dropping rows). The memory and
    # sql backends override all of them with real persistence.

    async def append_dead_letters(
            self, entries: "Sequence[DeadLetterEntry]") -> "list[int]":
        """Persist poison rows; returns assigned entry ids. MUST be an
        idempotent keyed upsert on `DeadLetterEntry.key()` (attempts
        accumulate) — a crash between bisection and ack re-streams the
        batch and re-appends the same rows."""
        raise EtlError(
            ErrorKind.STATE_STORE_FAILED,
            f"{type(self).__name__} does not persist dead letters")

    async def list_dead_letters(
            self, table_id: "TableId | None" = None,
            status: "str | None" = DLQ_STATUS_DEAD
    ) -> "list[DeadLetterEntry]":
        """Entries in id order, optionally filtered by table and status
        (None = every status)."""
        return []

    async def get_dead_letter(self,
                              entry_id: int) -> "DeadLetterEntry | None":
        return None

    async def set_dead_letter_status(self, entry_id: int,
                                     status: str) -> None:
        """dead → replayed/discarded transitions (operator CLI)."""
        raise EtlError(
            ErrorKind.STATE_STORE_FAILED,
            f"{type(self).__name__} does not persist dead letters")

    async def purge_dead_letters(self, older_than_s: float,
                                 statuses: "Sequence[str]" = (
                                     DLQ_STATUS_REPLAYED,
                                     DLQ_STATUS_DISCARDED)) -> int:
        """TTL compaction: delete entries in `statuses` whose last
        append/status transition is older than `older_than_s` seconds.
        Returns the number purged. Entries still `dead` are the
        zero-loss ledger and MUST NOT be offered for expiry; a store
        with no DLQ surface compacts nothing."""
        return 0

    async def get_quarantined_tables(self
                                     ) -> "dict[TableId, QuarantineRecord]":
        return {}

    async def set_table_quarantine(
            self, table_id: TableId,
            record: "QuarantineRecord | None") -> None:
        """Persist (record) or lift (None) a table's quarantine."""
        raise EtlError(
            ErrorKind.STATE_STORE_FAILED,
            f"{type(self).__name__} does not persist quarantine records")

    @abc.abstractmethod
    async def get_destination_metadata(
        self, table_id: TableId) -> DestinationTableMetadata | None: ...

    @abc.abstractmethod
    async def update_destination_metadata(
        self, meta: DestinationTableMetadata) -> None: ...

    @abc.abstractmethod
    async def delete_destination_metadata(self, table_id: TableId) -> None: ...


class SchemaStore(abc.ABC):
    @abc.abstractmethod
    async def store_table_schema(self, schema: ReplicatedTableSchema,
                                 snapshot_id: SnapshotId) -> None: ...

    @abc.abstractmethod
    async def get_table_schema(
        self, table_id: TableId,
        at_snapshot: SnapshotId | None = None
    ) -> ReplicatedTableSchema | None:
        """Latest version with snapshot_id ≤ at_snapshot (or overall latest
        when at_snapshot is None) — reference schema/base.rs `get ≤`."""

    @abc.abstractmethod
    async def get_schema_versions(self, table_id: TableId) -> list[SnapshotId]: ...

    @abc.abstractmethod
    async def get_table_ids_with_schemas(self) -> "list[TableId]":
        """Tables that have at least one stored schema version (the
        cleanup task's iteration set)."""

    @abc.abstractmethod
    async def prune_schema_versions(self, table_id: TableId,
                                    older_than: SnapshotId) -> int:
        """Drop versions strictly older than the newest one ≤ `older_than`
        (keeping that one: it is still the decode view for `older_than`)."""

    @abc.abstractmethod
    async def delete_table_schemas(self, table_id: TableId) -> None: ...


class PipelineStore(StateStore, SchemaStore, abc.ABC):
    """The full store facade a pipeline needs (reference capabilities.rs).

    Compound lifecycle ops (reference store/lifecycle.rs):"""

    async def prepare_table_for_copy(self, table_id: TableId) -> None:
        """Reset to DataSync and drop schema versions — the crash-consistent
        pre-copy reset (reference table_sync/mod.rs:225-241)."""
        await self.update_table_state(table_id, TableState.data_sync())
        await self.delete_table_schemas(table_id)

    async def reset_table(self, table_id: TableId) -> None:
        """Full-resync reset. Destination metadata is deliberately KEPT: it
        is the marker telling the next copy attempt to drop the (still
        populated) destination table first — deleting it here would make an
        invalidated-slot resync duplicate every existing row."""
        await self.update_table_state(table_id, TableState.init())
        await self.delete_table_schemas(table_id)

    async def purge_table(self, table_id: TableId) -> None:
        await self.delete_table_state(table_id)
        await self.delete_table_schemas(table_id)
        await self.delete_destination_metadata(table_id)
