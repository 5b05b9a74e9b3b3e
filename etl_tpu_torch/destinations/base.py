"""Destination trait and write-acknowledgement semantics.

Reference parity: `Destination` trait (crates/etl/src/destination/base.rs:27)
and `AsyncResult` Accepted/Durable (destination/async_result.rs:22-66):
`write_*` may return a *durable* ack (data is crash-safe at the destination)
or an *accepted* ack (handed off; durability signalled later through the
attached future). The apply loop advances durable progress — and therefore
the replication slot — only on durable acks at commit boundaries.

`write_table_rows` and `write_events` accept ColumnarBatch /
DecodedBatchEvent payloads straight from the device engine; the
`expand_batch_events` helper converts batch events to per-row events for
row-oriented writers.

Copy of the reference's `etl_tpu/destinations/base.py` without device
egress (queue 1, item 5 of ROADMAP.md): a `CoalescedBatch` carries
`egress = None`, so no merge of egress parts is ever reached.
"""

from __future__ import annotations

import abc
import asyncio
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from ..analysis.annotations import hot_loop
from ..chaos import failpoints
from ..models.event import (ChangeType, DecodedBatchEvent, DeleteEvent, Event,
                            InsertEvent, UpdateEvent)
from ..models.lsn import Lsn
from ..models.schema import ReplicatedTableSchema, TableId
from ..models.table_row import ColumnarBatch, TableRow


class WriteAck:
    """Acknowledgement of a write. `durable` may be True immediately;
    otherwise await `wait_durable()` (resolves when the destination reports
    crash-safety, or raises if the write ultimately failed).

    Chaos sites (chaos/failpoints.py): every destination constructs its
    ack through `durable()`/`accepted()`, so DESTINATION_WRITE armed
    there fires AFTER the write applied — the lost-response ambiguity —
    and DESTINATION_FLUSH fires on the durability wait, regardless of
    which destination implementation is under test."""

    __slots__ = ("_fut",)

    def __init__(self, fut: "asyncio.Future[None]"):
        self._fut = fut

    @classmethod
    def durable(cls) -> "WriteAck":
        failpoints.fail_point(failpoints.DESTINATION_WRITE)
        fut = asyncio.get_event_loop().create_future()
        fut.set_result(None)
        return cls(fut)

    @classmethod
    def accepted(cls) -> "tuple[WriteAck, asyncio.Future[None]]":
        failpoints.fail_point(failpoints.DESTINATION_WRITE)
        fut = asyncio.get_event_loop().create_future()
        return cls(fut), fut

    @property
    def is_durable(self) -> bool:
        return self._fut.done() and self._fut.exception() is None

    async def wait_durable(self) -> None:
        failpoints.fail_point(failpoints.DESTINATION_FLUSH)
        # chaos stall mode: a flush that never acks (SupervisedDestination
        # bounds this await; the watchdog sees frozen apply progress)
        await failpoints.stall_point(failpoints.DESTINATION_FLUSH)
        await asyncio.shield(self._fut)


@dataclass(frozen=True, slots=True)
class CommitRange:
    """The WAL coordinate range one transactional write covers.

    `high` is the lexicographic max `(commit_lsn, tx_ordinal)` across the
    rows shipped — the per-row dedup key the sinks already speak
    (`EventSequenceKey`, `offset_token_batch`, the DLQ's identity).
    `commit_end_lsn` is the commit watermark the flush may claim for
    durable progress (the ack window's `covered`); None for a
    mid-transaction prefix flush, whose rows still dedup by `high`.
    `replay` marks a DLQ re-delivery: the sink dedups those by EXACT row
    key (MERGE semantics) and must NOT advance its streaming high-water
    mark — replayed rows sit below it by construction (they were parked,
    not delivered, while the stream moved on)."""

    high: "tuple[int, int]"
    commit_end_lsn: "int | None" = None
    replay: bool = False

    def token(self) -> str:
        """Wire token for sinks that record the range as an opaque string
        (ClickHouse insert-dedup ids, Snowpipe offsets): same hex shape
        as `EventSequenceKey.offset_token`."""
        return f"{self.high[0]:016x}/{self.high[1]:016x}"

    @classmethod
    def from_events(cls, events: "Iterable[Event]",
                    commit_end_lsn: "Lsn | int | None" = None,
                    replay: bool = False) -> "CommitRange | None":
        """Derive the covered range from a WAL-ordered flush payload.
        Returns None when nothing in `events` carries row coordinates
        (schema/relation-only flushes have nothing to dedup)."""
        high: "tuple[int, int] | None" = None
        for e in events:
            if isinstance(e, DecodedBatchEvent):
                if len(e.commit_lsns) == 0:
                    continue
                lsns = np.asarray(e.commit_lsns, dtype=np.uint64)
                ords = np.asarray(e.tx_ordinals, dtype=np.uint64)
                top = int(lsns.max())
                cand = (top, int(ords[lsns == top].max()))
            else:
                lsn = getattr(e, "commit_lsn", None)
                ordinal = getattr(e, "tx_ordinal", None)
                if lsn is None or ordinal is None:
                    continue
                cand = (int(lsn), int(ordinal))
            if high is None or cand > high:
                high = cand
        if high is None:
            return None
        end = int(commit_end_lsn) if commit_end_lsn is not None else None
        return cls(high=high, commit_end_lsn=end, replay=replay)


def event_coordinate(e: Event) -> "tuple[int, int] | None":
    """The `(commit_lsn, tx_ordinal)` identity of one row-granular event,
    None for controls without row identity (Begin/Commit/Relation)."""
    lsn = getattr(e, "commit_lsn", None)
    ordinal = getattr(e, "tx_ordinal", None)
    if lsn is None or ordinal is None:
        return None
    return (int(lsn), int(ordinal))


class Destination(abc.ABC):
    """Where decoded rows and CDC events land. Implementations must be
    idempotent under at-least-once delivery (SURVEY §5 checkpoint/resume)."""

    #: wire-encoder name (ops/egress.py ENCODER_*) when this destination
    #: consumes device-rendered text buffers — the runtime binds it into
    #: each DeviceDecoder so decoded batches arrive with `device_egress`
    #: wire bytes attached (docs/destinations.md seam contract). None =
    #: the destination encodes host-side only.
    egress_encoder: "str | None" = None

    @abc.abstractmethod
    async def startup(self) -> None: ...

    @abc.abstractmethod
    async def write_table_rows(self, schema: ReplicatedTableSchema,
                               batch: ColumnarBatch) -> WriteAck:
        """Initial-copy path: append-only rows for one table."""

    @abc.abstractmethod
    async def write_events(self, events: Sequence[Event]) -> WriteAck:
        """CDC path: ordered events (possibly spanning tables)."""

    # -- columnar write seam (ROADMAP item 2) ---------------------------------
    #
    # The decode engine emits ColumnarBatches; these entry points let them
    # reach the wire without materializing Python TableRow objects. Both
    # default to the legacy row-oriented path so third-party / in-memory
    # destinations keep working unchanged — columnar-native writers
    # (BigQuery proto, ClickHouse TSV, lake/Iceberg Parquet) override them.

    async def write_table_batch(self, schema: ReplicatedTableSchema,
                                batch: ColumnarBatch) -> WriteAck:
        """Initial-copy path, columnar seam: append one decoded batch.
        Default: the existing `write_table_rows` implementation (which may
        row-expand internally — the compatibility shim)."""
        return await self.write_table_rows(schema, batch)

    async def write_event_batches(self, events: Sequence[Event]) -> WriteAck:
        """CDC path, columnar seam: ordered events where row changes may
        arrive as `DecodedBatchEvent`s. Default: hand the events to the
        legacy `write_events` path unchanged (destinations there expand
        batches to per-row events themselves — the compatibility shim)."""
        return await self.write_events(events)

    # -- transactional commit seam (ROADMAP item 1, exactly-once) -------------
    #
    # A destination that can record the acked WAL coordinate range
    # ATOMICALLY alongside the data opts in by returning True from the
    # capability probe and overriding the two methods below. The apply
    # loop then ships every CDC flush through
    # `write_event_batches_committed` with its CommitRange, and restart
    # recovery calls `recover_high_water` to trim the re-stream window to
    # exactly the unacked suffix — hard-kill anywhere, dup budget == 0.
    # Destinations that stay out keep today's at-least-once contract
    # bit-for-bit: the defaults below never change behavior.

    def supports_transactional_commit(self) -> bool:
        """Capability probe. True = this destination atomically persists
        each write's CommitRange with the data, dedups re-delivered rows
        by coordinate, and can answer `recover_high_water` after a crash.
        Wrappers delegate dynamically so the probe reflects the wrapped
        sink, never the wrapper."""
        return False

    async def write_event_batches_committed(
            self, events: Sequence[Event],
            commit: "CommitRange | None") -> WriteAck:
        """CDC path, transactional seam: ship `events` AND record `commit`
        in the same atomic unit (one MERGE / one insert with its dedup
        token / one snapshot commit). Rows at coordinates ≤ the sink's
        recorded high-water are duplicates of a blind re-stream and must
        not double-apply; `commit.replay` ranges dedup by exact row key
        instead (DLQ re-delivery). Default: the at-least-once compat shim
        — destinations that don't opt in ignore the range."""
        return await self.write_event_batches(events)

    async def recover_high_water(self) -> "CommitRange | None":
        """Restart recovery: the high-water CommitRange of the last
        transactional write this sink made durable, None when the sink
        has never committed one (fresh sink, or a non-transactional
        destination). Must be read-only and idempotent — recovery may be
        killed and re-run mid-query. Failures must surface as typed
        EtlErrors; the caller retries and degrades to a blind re-stream
        (sink-side dedup still holds the exactly-once invariant)."""
        return None

    @abc.abstractmethod
    async def drop_table(self, table_id: TableId,
                         schema: ReplicatedTableSchema | None = None) -> None:
        """Drop destination table before a (re)copy
        (reference table_sync/mod.rs:184-220 crash-consistency).

        `schema` is the prior stored schema, passed so a freshly restarted
        process — whose in-memory table-name mappings are empty — can still
        resolve which destination table (and channel, for Snowpipe) to
        drop. The reference resolves this through its schema store;
        destinations here rebuild the mapping from the hint."""

    @abc.abstractmethod
    async def truncate_table(self, table_id: TableId) -> None: ...

    async def shutdown(self) -> None:  # optional
        return None


@dataclass(slots=True)
class _RowChange:
    change: ChangeType
    key: tuple
    row: TableRow | None


def batch_event_columnar_ok(e: DecodedBatchEvent) -> bool:
    """True when a batch event can be encoded column-at-a-time with row-path
    semantics preserved: no old tuples (TOAST back-fill and the
    key-changing-update split both need the old image, expand_batch_events
    territory) and no TOAST-unchanged cells (which become column-wise PATCH
    rows on the row path). Resolves the lazy decode — the consumer needs
    the batch either way."""
    if len(e.old_rows) > 0 or e.old_batch is not None:
        return False
    for c in e.batch.columns:
        if c.toast_unchanged is not None and c.toast_unchanged.any():
            return False
    return True


class CoalescedBatch:
    """A contiguous same-table run of simple DecodedBatchEvents merged into
    ONE columnar write: concatenated batch + per-row CDC identity arrays.
    The unit the columnar destination encoders consume."""

    __slots__ = ("schema", "batch", "change_types", "commit_lsns",
                 "tx_ordinals", "egress")

    def __init__(self, events: "list[DecodedBatchEvent]"):
        self.schema = events[0].schema
        self.batch = ColumnarBatch.concat([e.batch for e in events]) \
            if len(events) > 1 else events[0].batch
        # device-rendered wire buffers are not ported yet: encoders take
        # their host path
        self.egress = None
        if len(events) == 1:
            self.change_types = events[0].change_types
            self.commit_lsns = events[0].commit_lsns
            self.tx_ordinals = events[0].tx_ordinals
        else:
            self.change_types = np.concatenate(
                [e.change_types for e in events])
            self.commit_lsns = np.concatenate(
                [np.asarray(e.commit_lsns, dtype=np.uint64) for e in events])
            self.tx_ordinals = np.concatenate(
                [np.asarray(e.tx_ordinals, dtype=np.uint64) for e in events])

    @property
    def num_rows(self) -> int:
        return self.batch.num_rows


@hot_loop
def sequential_batch_program(events: Iterable[Event]):
    """Order-preserving destination program over the columnar seam: yields
    ("batch", schema, CoalescedBatch) for runs of consecutive same-table
    simple DecodedBatchEvents, plus whatever the legacy program yields for
    everything in between — ("rows", schema, [row events…]) runs and
    ("truncate", ev) / ("schema_change", ev) barriers. Events that cannot
    take the columnar fast path (old tuples, TOAST-unchanged cells,
    per-row events from the CPU engine) drop to the row path in place, so
    WAL order is preserved across the two encodings.

    @hot_loop: one call per CDC flush — etl-lint rule 13 keeps row
    materialization out of it except the sanctioned fallback below."""
    from .util import sequential_event_program

    legacy: list[Event] = []
    run: list[DecodedBatchEvent] = []

    def flush_legacy():
        if legacy:
            yield from sequential_event_program(
                expand_batch_events(legacy))  # etl-lint: ignore[hot-loop-row-materialization] — the sanctioned compatibility shim: events that CANNOT encode columnar (old tuples / TOAST / per-row) take the row path here by design
            legacy.clear()

    def flush_run():
        if run:
            yield ("batch", run[0].schema, CoalescedBatch(run))
            run.clear()

    for e in events:
        if isinstance(e, DecodedBatchEvent) and batch_event_columnar_ok(e):
            if run and (run[0].schema.id != e.schema.id
                        or run[0].schema != e.schema):
                yield from flush_run()
            yield from flush_legacy()
            run.append(e)
        else:
            yield from flush_run()
            legacy.append(e)
    yield from flush_run()
    yield from flush_legacy()


def expand_batch_events(events: Iterable[Event]) -> list[Event]:
    """Expand DecodedBatchEvents into per-row Insert/Update/Delete events
    (helper for row-oriented destinations; columnar-native ones consume the
    batch directly).

    Emits events identical to the CPU codec path (codec/event.py): update
    old tuples become TableRow ('O') or identity-masked PartialTableRow
    ('K'), full old tuples back-fill TOAST-unchanged new values, and 'K'
    deletes yield PartialTableRow — reference codec/event.rs:28-50."""
    from ..models.cell import TOAST_UNCHANGED
    from ..models.table_row import PartialTableRow

    out: list[Event] = []
    for e in events:
        if not isinstance(e, DecodedBatchEvent):
            out.append(e)
            continue
        rows = e.batch.to_rows()
        old_batch = e.old_batch
        old_rows_list = old_batch.to_rows() if old_batch is not None else []
        old_by_row = {int(r): j for j, r in enumerate(e.old_rows)}
        identity = e.schema.identity_mask
        idx = e.schema.replicated_indices
        present = [identity[idx[i]] for i in range(len(idx))]

        def partial(row: TableRow) -> PartialTableRow:
            return PartialTableRow(row.values, list(present))

        for i, row in enumerate(rows):
            ct = ChangeType(int(e.change_types[i]))
            commit = Lsn(int(e.commit_lsns[i]))
            ordinal = int(e.tx_ordinals[i])
            if ct is ChangeType.INSERT:
                out.append(InsertEvent(e.start_lsn, commit, ordinal,
                                       e.schema, row))
            elif ct is ChangeType.UPDATE:
                old = None
                j = old_by_row.get(i)
                if j is not None:
                    old_row = old_rows_list[j]
                    if e.old_is_key[j]:
                        old = partial(old_row)
                    else:
                        old = old_row
                        # TOAST merge: unchanged columns take the full old
                        # tuple's values (codec/event.py decode_update)
                        values = row.values
                        for k, v in enumerate(values):
                            if v is TOAST_UNCHANGED:
                                values[k] = old_row.values[k]
                out.append(UpdateEvent(e.start_lsn, commit, ordinal,
                                       e.schema, row, old))
            else:
                old = partial(row) if e.delete_is_key is not None \
                    and e.delete_is_key[i] else row
                out.append(DeleteEvent(e.start_lsn, commit, ordinal,
                                       e.schema, old))
    return out
