"""Replication events.

Reference parity: `Event` enum Begin/Commit/Insert/Update/Delete/Truncate/
Relation each carrying `start_lsn`, `commit_lsn`, `tx_ordinal` and its
`ReplicatedTableSchema` (crates/etl/src/event.rs:21-320);
`EventSequenceKey = commit_lsn/tx_ordinal` (event.rs:323).

Copy of the reference's `etl_tpu/models/event.py`. `DecodedBatchEvent` is
a run of same-table row changes already decoded into a `ColumnarBatch` by
the device engine, with per-row change types and ordinals. The CPU engine
emits per-row events; the CUDA engine emits batch events. Destinations
accept both (destinations/base.py expands batches for row-oriented
writers).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Sequence, Union

import numpy as np

from .lsn import Lsn
from .schema import ReplicatedTableSchema, TableId
from .table_row import ColumnarBatch, PartialTableRow, TableRow


@dataclass(frozen=True, slots=True, order=True)
class EventSequenceKey:
    """Total order of row changes within the WAL stream: commit LSN of the
    owning transaction, then statement ordinal within it (event.rs:323)."""

    commit_lsn: Lsn
    tx_ordinal: int

    def with_ordinal(self, ordinal: int) -> str:
        """Hex sequence string used by CDC destinations (reference BigQuery
        `_CHANGE_SEQUENCE_NUMBER`, bigquery/core.rs:980-996)."""
        return f"{int(self.commit_lsn):016x}/{self.tx_ordinal:016x}/{ordinal:016x}"

    def __str__(self) -> str:
        return f"{self.commit_lsn}/{self.tx_ordinal}"


class ChangeType(enum.IntEnum):
    INSERT = 0
    UPDATE = 1
    DELETE = 2


@dataclass(slots=True)
class BeginEvent:
    start_lsn: Lsn
    commit_lsn: Lsn  # final LSN announced by the BEGIN message
    timestamp_us: int  # pg epoch-2000 micros converted to unix micros
    xid: int


@dataclass(slots=True)
class CommitEvent:
    start_lsn: Lsn
    commit_lsn: Lsn
    end_lsn: Lsn
    timestamp_us: int
    flags: int = 0


@dataclass(slots=True)
class RelationEvent:
    start_lsn: Lsn
    commit_lsn: Lsn
    schema: ReplicatedTableSchema


@dataclass(slots=True)
class InsertEvent:
    start_lsn: Lsn
    commit_lsn: Lsn
    tx_ordinal: int
    schema: ReplicatedTableSchema
    row: TableRow

    @property
    def sequence_key(self) -> EventSequenceKey:
        return EventSequenceKey(self.commit_lsn, self.tx_ordinal)


@dataclass(slots=True)
class UpdateEvent:
    start_lsn: Lsn
    commit_lsn: Lsn
    tx_ordinal: int
    schema: ReplicatedTableSchema
    row: TableRow
    # old identity values when replica identity produced them ('K'/'O' tuples);
    # merged-by-identity-mask semantics live in the codec (codec/event.rs:28-50)
    old_row: PartialTableRow | TableRow | None = None

    @property
    def sequence_key(self) -> EventSequenceKey:
        return EventSequenceKey(self.commit_lsn, self.tx_ordinal)


@dataclass(slots=True)
class DeleteEvent:
    start_lsn: Lsn
    commit_lsn: Lsn
    tx_ordinal: int
    schema: ReplicatedTableSchema
    old_row: PartialTableRow | TableRow

    @property
    def sequence_key(self) -> EventSequenceKey:
        return EventSequenceKey(self.commit_lsn, self.tx_ordinal)


@dataclass(slots=True)
class TruncateEvent:
    start_lsn: Lsn
    commit_lsn: Lsn
    tx_ordinal: int
    options: int  # bit 1: CASCADE, bit 2: RESTART IDENTITY
    schemas: tuple[ReplicatedTableSchema, ...]

    @property
    def cascade(self) -> bool:
        return bool(self.options & 1)

    @property
    def restart_identity(self) -> bool:
        return bool(self.options & 2)


@dataclass(slots=True)
class SchemaChangeEvent:
    """DDL logical message emitted by the source event trigger
    (reference: apply.rs:2160-2277 + migrations/source/...schema_change_messages.up.sql)."""

    start_lsn: Lsn
    commit_lsn: Lsn
    table_id: TableId
    new_schema: ReplicatedTableSchema | None  # None = table dropped


class DecodedBatchEvent:
    """Device-path event: a contiguous same-table run of changes decoded on
    device into columnar form. `change_types[i]` and `tx_ordinals[i]` /
    `commit_lsns[i]` give each row its identity in the WAL order.

    `batch` / `old_batch` resolve lazily: the assembler hands the event an
    in-flight device decode (`pending`, an object with `.result()`), so the
    device works and the result streams back to the host while the apply
    loop keeps reading WAL — the decode completes inside the destination
    write that consumes it (the software-pipelining analogue of the
    reference's one-in-flight flush, apply.rs:1956-2023).

    Old-tuple identity (reference codec/event.rs:28-50): `old_rows[j]` is
    the row index whose update carried an old/key tuple (stored as row j of
    `old_batch`); `old_is_key[j]` distinguishes 'K' key tuples from 'O'
    full tuples. `delete_is_key[i]` is True when DELETE row i carried a 'K'
    tuple (identity columns only) rather than a full 'O' old row.
    """

    __slots__ = ("start_lsn", "commit_lsn", "schema", "change_types",
                 "commit_lsns", "tx_ordinals", "old_rows", "old_is_key",
                 "delete_is_key", "_batch", "_pending", "_old_batch",
                 "_old_pending")

    def __init__(self, start_lsn: Lsn, commit_lsn: Lsn,
                 schema: ReplicatedTableSchema, *,
                 change_types: np.ndarray, commit_lsns: np.ndarray,
                 tx_ordinals: np.ndarray,
                 batch: ColumnarBatch | None = None, pending=None,
                 old_batch: ColumnarBatch | None = None, old_pending=None,
                 old_rows: np.ndarray | None = None,
                 old_is_key: np.ndarray | None = None,
                 delete_is_key: np.ndarray | None = None):
        if batch is None and pending is None:
            raise ValueError("DecodedBatchEvent needs batch or pending")
        self.start_lsn = start_lsn
        self.commit_lsn = commit_lsn
        self.schema = schema
        self.change_types = change_types
        self.commit_lsns = commit_lsns
        self.tx_ordinals = tx_ordinals
        self.old_rows = old_rows if old_rows is not None \
            else np.zeros(0, dtype=np.int64)
        self.old_is_key = old_is_key if old_is_key is not None \
            else np.zeros(0, dtype=np.bool_)
        self.delete_is_key = delete_is_key
        self._batch = batch
        self._pending = pending
        self._old_batch = old_batch
        self._old_pending = old_pending

    @property
    def batch(self) -> ColumnarBatch:
        if self._batch is None:
            self._batch = self._pending.result()
            self._pending = None
            surv = getattr(self._batch, "source_rows", None)
            if surv is not None:
                # fused publication row filter: the decode compacted the
                # rows, so the per-row identity arrays compact in lockstep
                # the moment the batch resolves. Consumers read these
                # arrays only alongside the batch (CoalescedBatch /
                # expand_batch_events both resolve `batch` first);
                # event_size_hint deliberately reads the pre-filter arrays
                # — an overestimate, never a forced decode.
                self.change_types = self.change_types[surv]
                self.commit_lsns = np.asarray(self.commit_lsns)[surv]
                self.tx_ordinals = np.asarray(self.tx_ordinals)[surv]
        return self._batch

    @property
    def old_batch(self) -> ColumnarBatch | None:
        if self._old_batch is None and self._old_pending is not None:
            self._old_batch = self._old_pending.result()
            self._old_pending = None
        return self._old_batch

    def abandon(self) -> None:
        """Discard an event that will never be consumed (a hard-killed
        worker's flushed-but-undelivered write window): release the
        pending decode's pooled resources (staging arena, window slot,
        admission ticket) without paying the fetch. Resolved events
        already returned them; handles without an abandon hook (the
        serial `_PendingDecode`) hold no pooled resources."""
        for pending in (self._pending, self._old_pending):
            ab = getattr(pending, "abandon", None)
            if ab is not None:
                ab()
        self._pending = None
        self._old_pending = None

    def __len__(self) -> int:
        return len(self.change_types)


Event = Union[
    BeginEvent, CommitEvent, RelationEvent, InsertEvent, UpdateEvent,
    DeleteEvent, TruncateEvent, SchemaChangeEvent, DecodedBatchEvent,
]

ROW_EVENT_TYPES = (InsertEvent, UpdateEvent, DeleteEvent)


def event_size_hint(e: Event) -> int:
    """Byte-size estimate for batch budgeting (reference: size hints consumed
    by EventBatch, apply.rs:633)."""
    if isinstance(e, (InsertEvent, UpdateEvent)):
        base = 64 + e.row.size_hint()
        if isinstance(e, UpdateEvent) and e.old_row is not None:
            base += e.old_row.size_hint()
        return base
    if isinstance(e, DeleteEvent):
        return 64 + e.old_row.size_hint()
    if isinstance(e, DecodedBatchEvent):
        # don't force a lazy in-flight decode just for accounting
        base = 64 + e.change_types.nbytes + 16 * len(e)
        if e._batch is not None:
            base += e._batch.size_hint()
        return base
    return 64
