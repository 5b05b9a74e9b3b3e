"""ReplicationSource: the seam between the runtime and Postgres.

The apply loop, table-sync workers and pipeline consume this interface; the
wire-protocol client (postgres/client.py) implements it against a real
server, and FakeSource (postgres/fake.py) implements it in-memory with the
same semantics (slots with consistent points, MVCC snapshots at slot
creation, publication filtering) — the substitute for the reference's
real-Postgres integration harness (SURVEY §4.2) in an environment without a
Postgres server.

Reference parity: `PgReplicationClient` surface (crates/etl/src/postgres/
client/raw.rs:212 — slot CRUD with snapshot transactions, publication
queries, START_REPLICATION) and `PgReplicationTransaction` (transaction.rs:
727 — schema introspection, COPY streams, snapshot forking).

Copy of the reference's `etl_tpu/postgres/source.py`.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import AsyncIterator

from ..models.lsn import Lsn
from ..models.schema import ReplicatedTableSchema, TableId
from .codec.pgoutput import ReplicationFrame


@dataclass(frozen=True)
class SlotInfo:
    name: str
    confirmed_flush_lsn: Lsn
    active: bool = False
    invalidated: bool = False  # wal_status = lost


@dataclass(frozen=True)
class CreatedSlot:
    name: str
    consistent_point: Lsn  # WAL position at slot creation
    snapshot_id: str  # exported snapshot (fake: internal snapshot key)


#: row-message tags that may aggregate into a FrameSpan
_ROW_TAGS = (b"I", b"U", b"D")

#: span length cap: the apply loop's batch-budget check runs once per
#: span, so an unbounded span inside one giant transaction could blow
#: far past max_size_bytes before the next check (the split-at-budget
#: e2e pins the resulting behavior)
SPAN_MAX_ROWS = 1024


class FrameSpan:
    """A contiguous run of row messages (Insert/Update/Delete) for ONE
    table, drained in bulk.

    This is the CDC hot-path unit: the overwhelming majority of WAL
    traffic is runs of row changes for a single table, and handing the
    apply loop one span (relid + raw payloads + int LSNs) instead of
    per-row frame objects removes the per-event allocation and dispatch
    that otherwise caps end-to-end throughput (the reference's analogue
    is a compiled-Rust per-event loop, apply.rs:1280-1336; a Python
    runtime must amortize instead). Control frames (Begin/Commit/
    Relation/Truncate/keepalives) never enter a span — they bound it, so
    transaction state is constant within one."""

    __slots__ = ("relid", "payloads", "start_lsns", "end_lsn")

    def __init__(self, relid: int, payloads: list, start_lsns: list,
                 end_lsn: int):
        self.relid = relid
        self.payloads = payloads  # list[bytes], pgoutput row messages
        self.start_lsns = start_lsns  # list[int], one per payload
        self.end_lsn = end_lsn  # server WAL end at drain time

    def __len__(self) -> int:
        return len(self.payloads)


class ReplicationStream(abc.ABC):
    """The START_REPLICATION copy-both stream: frames down, status up."""

    @abc.abstractmethod
    def __aiter__(self) -> AsyncIterator[ReplicationFrame]: ...

    def drain_buffered(self, max_n: int) -> list:
        """Already-received frames, synchronously (no event-loop round
        trip). Default: none — the apply loop then falls back to one
        awaited frame per select. Implementations override this to lift
        the per-frame asyncio overhead off the CDC hot path."""
        return []

    def drain_spans(self, max_n: int) -> list:
        """Drain buffered traffic as a mixed list of `FrameSpan`s (bulk
        row runs) and individual non-row frames, in WAL order. Default:
        segment `drain_buffered` output host-side; implementations that
        can segment closer to the wire (or skip per-frame objects
        entirely, like the in-memory fake) override this."""
        from .codec.pgoutput import XLogData

        frames = self.drain_buffered(max_n)
        if not frames:
            return frames
        out: list = []
        i, n = 0, len(frames)
        while i < n:
            f = frames[i]
            if type(f) is not XLogData or f.payload[:1] not in _ROW_TAGS:
                out.append(f)
                i += 1
                continue
            relid = int.from_bytes(f.payload[1:5], "big")
            payloads = [f.payload]
            lsns = [int(f.start_lsn)]
            end = int(f.end_lsn)
            j, cap = i + 1, i + SPAN_MAX_ROWS
            while j < n and j < cap:
                g = frames[j]
                if type(g) is not XLogData:
                    break
                p = g.payload
                if p[:1] not in _ROW_TAGS \
                        or int.from_bytes(p[1:5], "big") != relid:
                    break
                payloads.append(p)
                lsns.append(int(g.start_lsn))
                end = int(g.end_lsn)
                j += 1
            out.append(FrameSpan(relid, payloads, lsns, end))
            i = j
        return out

    @abc.abstractmethod
    async def send_status_update(self, written: Lsn, flushed: Lsn,
                                 applied: Lsn,
                                 reply_requested: bool = False) -> None: ...

    @abc.abstractmethod
    async def close(self) -> None: ...


class CopyStream(abc.ABC):
    """COPY TO STDOUT: yields raw text-format chunks (newline-complete)."""

    @abc.abstractmethod
    def __aiter__(self) -> AsyncIterator[bytes]: ...


class ReplicationSource(abc.ABC):
    """One logical connection to the source database."""

    @abc.abstractmethod
    async def connect(self) -> None: ...

    @abc.abstractmethod
    async def close(self) -> None: ...

    # -- catalog -------------------------------------------------------------

    @abc.abstractmethod
    async def publication_exists(self, publication: str) -> bool: ...

    @abc.abstractmethod
    async def get_publication_table_ids(self,
                                        publication: str) -> list[TableId]: ...

    @abc.abstractmethod
    async def get_table_schema(
        self, table_id: TableId, publication: str,
        snapshot_id: str | None = None) -> ReplicatedTableSchema:
        """Schema + replica identity + publication column filters, read in
        the slot snapshot when given (reference transaction.rs:750-768)."""

    async def get_row_filters(self, publication: str) -> "dict[TableId, str]":
        """Publication row-filter SQL per published table (PG15+
        `pg_publication_tables.rowfilter`). The pipeline compiles these
        into the fused decode programs (ops/predicate.py) so filtering
        runs client-side on device — required when the walsender does not
        filter (PG14, or the filter-offload deployment), idempotent when
        it does. Default: none (pre-15 sources)."""
        return {}

    @abc.abstractmethod
    async def get_current_wal_lsn(self) -> Lsn: ...

    # -- source migrations (reference postgres/migrations.rs) ---------------

    @abc.abstractmethod
    async def is_in_recovery(self) -> bool:
        """True on a standby/read replica (pg_is_in_recovery())."""

    @abc.abstractmethod
    async def applied_source_migrations(self) -> "list[str]":
        """Names recorded in etl.source_migrations ([] if absent)."""

    @abc.abstractmethod
    async def apply_source_migration(self, name: str, sql: str) -> None:
        """Run one migration script and record its name."""


    # -- slots ---------------------------------------------------------------

    @abc.abstractmethod
    async def get_slot(self, name: str) -> SlotInfo | None: ...

    @abc.abstractmethod
    async def create_slot(self, name: str) -> CreatedSlot:
        """CREATE_REPLICATION_SLOT ... USE_SNAPSHOT inside a transaction —
        the returned snapshot_id fences table copies against the slot's
        consistent point (reference raw.rs:419-529)."""

    @abc.abstractmethod
    async def delete_slot(self, name: str) -> None:
        """Drop if exists; no error when absent."""

    # -- data ----------------------------------------------------------------

    @abc.abstractmethod
    async def copy_table_stream(self, table_id: TableId, publication: str,
                                snapshot_id: str,
                                ctid_range: "tuple[int, int] | None" = None,
                                publication_table_id: "TableId | None" = None
                                ) -> CopyStream:
        """COPY text stream of the table as of the snapshot; optional CTID
        page range for partitioned parallel copy (transaction.rs:780,868).
        `publication_table_id`: the published relation when it differs from
        the physical one (leaf partitions under
        publish_via_partition_root inherit the root's filters)."""

    @abc.abstractmethod
    async def estimate_table_stats(self, table_id: TableId) -> tuple[int, int]:
        """(estimated_rows, heap_pages) from pg_class for copy planning."""

    async def get_partition_leaves(
            self, table_id: TableId) -> "list[tuple[TableId, int, int]]":
        """Leaf partitions of a partitioned table as (leaf_id, est_rows,
        heap_pages); empty for regular tables. Copy planning weights CTID
        ranges per leaf (reference transaction.rs:808-825,
        copy.rs:457-547)."""
        return []

    @abc.abstractmethod
    async def start_replication(self, slot_name: str, publication: str,
                                start_lsn: Lsn) -> ReplicationStream: ...
