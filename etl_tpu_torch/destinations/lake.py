"""Lake destination: a local lakehouse — Parquet data + SQL catalog.

The DuckLake-analogue (reference crates/etl-destinations/src/ducklake/,
13.5k LoC: DuckDB writing Parquet to S3 with a Postgres-backed catalog).
Here: pyarrow Parquet files in a warehouse directory with a sqlite catalog
— the same architecture with the embedded pieces this environment has.
Carried over semantics:

  - batch mutation application with retry (ducklake/batches.rs): every
    write lands as an immutable Parquet file recorded in the catalog;
  - replay-epoch markers for at-least-once dedup (replay_epoch.rs): CDC
    files carry their max sequence key; a re-delivered batch whose max
    sequence ≤ the table's high watermark is skipped;
  - truncate handling via generations; snapshot reads collapse CDC files
    by identity + sequence order (the `_current` semantics);
  - external maintenance handoff (external_maintenance.rs): `compact()`
    merges CDC files into a new base file under a catalog transaction,
    coordinated with writers through a catalog maintenance flag.

Copy of the reference's `etl_tpu/destinations/lake.py`. The decoded CDC
batches of the port (`DecodedBatchEvent` runs) go ColumnarBatch → Arrow
→ Parquet without per-row Python objects, through the port's
`ColumnarBatch.to_arrow()`: its Arrow schema is the reference's (text as
`string`, the same numeric, date and timestamp types). pyarrow is
imported inside the methods that need it, so this module imports where
pyarrow is not installed; constructing a `LakeDestination` there raises
a typed CONFIG_INVALID naming pyarrow (`util.require_pyarrow`). File
names and replay epochs draw from the `rng` the destination is built
with (a `random.Random` a test seeds), else from fresh version-4 UUIDs.
"""

from __future__ import annotations

import asyncio
import json
import random
import sqlite3
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np

from ..analysis.annotations import hot_loop, transactional_commit
from ..models.errors import ErrorKind, EtlError
from ..models.event import DeleteEvent, Event, UpdateEvent
from ..models.schema import ReplicatedTableSchema, TableId
from ..models.table_row import ColumnarBatch
from .base import CommitRange, Destination, WriteAck, expand_batch_events
from .util import (CHANGE_SEQUENCE_COLUMN, CHANGE_TYPE_COLUMN, CDC_DELETE,
                   CDC_PATCH, CDC_UPSERT, PATCH_MISSING_COLUMN,
                   _identity_values, escaped_table_name, new_uuid4,
                   require_pyarrow, sequential_event_program)


@dataclass(frozen=True)
class LakeConfig:
    warehouse_path: str  # directory for parquet files + catalog
    compact_min_files: int = 8  # compaction trigger threshold
    # data inlining (reference ducklake/inline_size.rs): CDC batches whose
    # Arrow payload is below inline_max_bytes are stored IN the catalog
    # (Arrow IPC blob) instead of as tiny Parquet files; when a table's
    # accumulated inlined bytes exceed inline_flush_bytes they flush into
    # one Parquet file. 0 disables inlining.
    inline_max_bytes: int = 0
    inline_flush_bytes: int = 256 * 1024


# replay epoch assigned to rows written before epoch tracking existed
# (reference replay_epoch.rs LEGACY_REPLAY_EPOCH)
LEGACY_REPLAY_EPOCH = "__legacy__"

# maintenance-policy sampling predicates — ONE definition shared with the
# coordination agent's off-thread sampler (maintenance_coordination.py),
# so the replicator side and the controller side can never drift on what
# counts as a compactable CDC file or pending inlined bytes
TABLE_GENERATION_SQL = "SELECT generation FROM lake_tables WHERE table_id = ?"
CDC_FILE_COUNT_SQL = (
    "SELECT COUNT(*) FROM lake_files WHERE table_id = ? AND "
    "generation = ? AND kind = 'cdc' AND inline_payload IS NULL")
PENDING_INLINE_BYTES_SQL = (
    "SELECT COALESCE(SUM(LENGTH(inline_payload)), 0) FROM "
    "lake_files WHERE table_id = ? AND generation = ? AND "
    "inline_payload IS NOT NULL")


def _concat_cdc_batches(batches: "list[pa.RecordBatch]") -> pa.Table:
    """Concatenate CDC record batches whose schemas may differ only in the
    the optional PATCH-missing column: align on the column union, null-filling
    the absentees (Arrow's schema unification does exactly this)."""
    import pyarrow as pa

    return pa.concat_tables([pa.Table.from_batches([b]) for b in batches],
                            promote_options="default")


class LakeDestination(Destination):
    def __init__(self, config: LakeConfig,
                 rng: "random.Random | None" = None):
        require_pyarrow("the lake destination")
        self.config = config
        self._rng = rng
        self.root = Path(config.warehouse_path)
        self._db: sqlite3.Connection | None = None

    # -- catalog ----------------------------------------------------------------

    async def startup(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        self._db = sqlite3.connect(self.root / "catalog.db")
        # WAL keeps readers unblocked during commits; the generous busy
        # timeout covers compact()'s observe→merge→swap transaction so a
        # concurrent writer (external maintenance binary vs replicator)
        # waits instead of failing with a raw 'database is locked'
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA busy_timeout=60000")
        self._db.executescript("""
CREATE TABLE IF NOT EXISTS lake_tables (
    table_id BIGINT PRIMARY KEY,
    name TEXT NOT NULL,
    schema_json TEXT NOT NULL,
    generation BIGINT NOT NULL DEFAULT 0,
    max_seq TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS lake_files (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    table_id BIGINT NOT NULL,
    generation BIGINT NOT NULL,
    path TEXT NOT NULL,
    kind TEXT NOT NULL,          -- 'base' | 'cdc'
    row_count BIGINT NOT NULL,
    max_seq TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS lake_maintenance (
    table_id BIGINT PRIMARY KEY,
    in_progress INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS lake_maintenance_history (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    table_id BIGINT NOT NULL,
    operation TEXT NOT NULL,        -- 'compact' | 'vacuum'
    started_at TEXT NOT NULL,
    finished_at TEXT,
    files_affected BIGINT NOT NULL DEFAULT 0,
    outcome TEXT NOT NULL DEFAULT 'running'  -- running|ok|skipped|failed
);
CREATE TABLE IF NOT EXISTS lake_replay_epochs (
    table_id BIGINT PRIMARY KEY,
    replay_epoch TEXT NOT NULL,
    pending_replay_epoch TEXT,
    updated_at TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS lake_commit_log (
    id INTEGER PRIMARY KEY CHECK (id = 1),  -- singleton high-water row
    commit_lsn BIGINT NOT NULL,
    tx_ordinal BIGINT NOT NULL,
    commit_end_lsn BIGINT
);
CREATE TABLE IF NOT EXISTS lake_replay_tokens (
    token TEXT PRIMARY KEY
);
""")
        # older catalogs: add per-file epoch + inline payload columns
        cols = {r[1] for r in self._db.execute(
            "PRAGMA table_info(lake_files)")}
        if "replay_epoch" not in cols:
            self._db.execute(
                "ALTER TABLE lake_files ADD COLUMN replay_epoch TEXT "
                f"NOT NULL DEFAULT '{LEGACY_REPLAY_EPOCH}'")
        if "inline_payload" not in cols:
            self._db.execute(
                "ALTER TABLE lake_files ADD COLUMN inline_payload BLOB")
        self._db.commit()
        # resume an interrupted replay-epoch transition (two-phase:
        # begin→reset→complete; a crash between begin and complete re-runs
        # the reset — an extra empty generation is harmless — and promotes)
        for (tid,) in self._db.execute(
                "SELECT table_id FROM lake_replay_epochs "
                "WHERE pending_replay_epoch IS NOT NULL").fetchall():
            await self._finish_replay_reset(tid)

    def _catalog(self) -> sqlite3.Connection:
        if self._db is None:
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           "lake destination not started")
        return self._db

    def _table_row(self, table_id: TableId):
        return self._catalog().execute(
            "SELECT name, schema_json, generation, max_seq FROM lake_tables "
            "WHERE table_id = ?", (table_id,)).fetchone()

    def _ensure_table(self, schema: ReplicatedTableSchema) -> tuple[str, int]:
        row = self._table_row(schema.id)
        name = escaped_table_name(schema.name)
        db = self._catalog()
        if row is None:
            db.execute(
                "INSERT INTO lake_tables (table_id, name, schema_json) "
                "VALUES (?, ?, ?)",
                (schema.id, name, json.dumps(schema.to_json())))
            db.commit()
            return name, 0
        if json.loads(row[1]) != schema.to_json():
            db.execute("UPDATE lake_tables SET schema_json = ? "
                       "WHERE table_id = ?",
                       (json.dumps(schema.to_json()), schema.id))
            db.commit()
        return row[0], row[2]

    # -- file writing -------------------------------------------------------------

    def _new_data_path(self, table_dir: Path) -> Path:
        return table_dir / f"data-{new_uuid4(self._rng).hex}.parquet"

    def _write_parquet(self, table_dir: Path, rb: "pa.RecordBatch") -> Path:
        import pyarrow as pa
        import pyarrow.parquet as pq

        table_dir.mkdir(parents=True, exist_ok=True)
        path = self._new_data_path(table_dir)
        pq.write_table(pa.Table.from_batches([rb]), path)
        return path

    def _record_file(self, table_id: TableId, generation: int,
                     path: "Path | str", kind: str, rows: int, max_seq: str,
                     epoch: str = LEGACY_REPLAY_EPOCH,
                     inline_payload: "bytes | None" = None) -> None:
        db = self._catalog()
        db.execute(
            "INSERT INTO lake_files (table_id, generation, path, kind, "
            "row_count, max_seq, replay_epoch, inline_payload) "
            "VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
            (table_id, generation, str(path), kind, rows, max_seq, epoch,
             inline_payload))
        if max_seq:
            db.execute("UPDATE lake_tables SET max_seq = MAX(max_seq, ?) "
                       "WHERE table_id = ?", (max_seq, table_id))
        db.commit()

    # -- Destination ---------------------------------------------------------------

    async def write_table_rows(self, schema: ReplicatedTableSchema,
                               batch: ColumnarBatch) -> WriteAck:
        await self._wait_maintenance_clear(schema.id)
        name, gen = self._ensure_table(schema)
        if batch.num_rows:
            rb = batch.to_arrow()
            path = self._write_parquet(self.root / name, rb)
            self._record_file(schema.id, gen, path, "base", batch.num_rows,
                              "", self.current_replay_epoch(schema.id))
        return WriteAck.durable()

    async def write_events(self, events: Sequence[Event]) -> WriteAck:
        for op in sequential_event_program(expand_batch_events(events)):
            if op[0] == "rows":
                _, schema, evs = op
                await self._write_cdc_file(schema, evs)
            elif op[0] == "truncate":
                for sch in op[1].schemas:
                    await self.truncate_table(sch.id)
            else:
                self._ensure_table(op[1].new_schema)
        return WriteAck.durable()

    # -- columnar seam --------------------------------------------------------

    async def write_table_batch(self, schema: ReplicatedTableSchema,
                                batch: ColumnarBatch) -> WriteAck:
        # write_table_rows is already Arrow-native; the seam override just
        # keeps the copy path's op label distinct for wrappers
        return await self.write_table_rows(schema, batch)

    async def write_event_batches(self, events: Sequence[Event]) -> WriteAck:
        """CDC path, columnar: decoded batch runs go ColumnarBatch → Arrow
        → Parquet/IPC with vectorized CDC metadata columns — no TableRow
        objects, no from_rows re-transpose. Old-tuple/TOAST batches and
        per-row events drop to the row path in place."""
        from .base import sequential_batch_program

        for op in sequential_batch_program(events):
            if op[0] == "batch":
                _, schema, cb = op
                await self._write_cdc_batch(schema, cb)
            elif op[0] == "rows":
                _, schema, evs = op
                await self._write_cdc_file(schema, evs)
            elif op[0] == "truncate":
                for sch in op[1].schemas:
                    await self.truncate_table(sch.id)
            else:
                self._ensure_table(op[1].new_schema)
        return WriteAck.durable()

    # -- transactional seam (docs/destinations.md exactly-once contract) ------

    def supports_transactional_commit(self) -> bool:
        return True

    @transactional_commit
    async def write_event_batches_committed(
            self, events: Sequence[Event], commit: CommitRange) -> WriteAck:
        """Committed CDC write: data files land first, then the WAL
        range commits to the sqlite catalog (`lake_commit_log`, the
        same transaction domain as the file records). A crash between
        them re-streams a flush whose duplicate rows the CDC sequence
        collapse absorbs at read time; replays dedup by exact token in
        `lake_replay_tokens` and never touch the high-water row."""
        db = self._catalog()
        if commit.replay:
            seen = db.execute(
                "SELECT 1 FROM lake_replay_tokens WHERE token = ?",
                (commit.token(),)).fetchone()
            if seen:
                return WriteAck.durable()
        ack = await self.write_event_batches(events)
        if commit.replay:
            db.execute("INSERT OR IGNORE INTO lake_replay_tokens "
                       "(token) VALUES (?)", (commit.token(),))
        else:
            lsn, ordinal = commit.high
            # monotone guard in SQL: out-of-order finalization must not
            # move the recorded high-water backwards
            db.execute(
                "INSERT INTO lake_commit_log "
                "(id, commit_lsn, tx_ordinal, commit_end_lsn) "
                "VALUES (1, ?, ?, ?) ON CONFLICT(id) DO UPDATE SET "
                "commit_lsn = excluded.commit_lsn, "
                "tx_ordinal = excluded.tx_ordinal, "
                "commit_end_lsn = excluded.commit_end_lsn "
                "WHERE excluded.commit_lsn > lake_commit_log.commit_lsn "
                "OR (excluded.commit_lsn = lake_commit_log.commit_lsn "
                "AND excluded.tx_ordinal > lake_commit_log.tx_ordinal)",
                (lsn, ordinal, commit.commit_end_lsn))
        db.commit()
        return ack

    async def recover_high_water(self) -> "CommitRange | None":
        row = self._catalog().execute(
            "SELECT commit_lsn, tx_ordinal, commit_end_lsn "
            "FROM lake_commit_log WHERE id = 1").fetchone()
        if row is None:
            return None
        return CommitRange(high=(int(row[0]), int(row[1])),
                           commit_end_lsn=int(row[2]) if row[2] else None)

    @hot_loop
    async def _write_cdc_batch(self, schema: ReplicatedTableSchema,
                               cb) -> None:
        """@hot_loop: the lake CDC egress hot path — ColumnarBatch → Arrow
        with vectorized metadata, no row objects (etl-lint rule 13)."""
        from .util import (change_type_arrow, fixed_width_string_arrow,
                           sequence_number_buffer)

        await self._wait_maintenance_clear(schema.id)
        name, gen = self._ensure_table(schema)
        row = self._table_row(schema.id)
        watermark = row[3] if row else ""
        n = cb.num_rows
        ordinals = np.arange(n, dtype=np.uint64)
        seq_buf = sequence_number_buffer(cb.commit_lsns, cb.tx_ordinals,
                                         ordinals)
        max_seq = max(seq_buf.reshape(-1).view("S50").tolist()).decode() \
            if n else ""
        if watermark and max_seq <= watermark:
            return  # replay-epoch dedup: whole batch already applied
        rb = cb.batch.to_arrow()
        rb = rb.append_column(CHANGE_TYPE_COLUMN,
                              change_type_arrow(cb.change_types))
        rb = rb.append_column(
            CHANGE_SEQUENCE_COLUMN,
            # the watermark render above already produced the (n, 50)
            # buffer — build the Arrow column from it instead of
            # re-rendering (the device-egress fixed-buffer idiom)
            fixed_width_string_arrow(seq_buf))
        await self._store_cdc_rb(schema, name, gen, rb, n, max_seq)

    async def _write_cdc_file(self, schema: ReplicatedTableSchema,
                              evs: list) -> None:
        from ..models.cell import TOAST_UNCHANGED

        await self._wait_maintenance_clear(schema.id)
        name, gen = self._ensure_table(schema)
        row = self._table_row(schema.id)
        watermark = row[3] if row else ""
        seqs, types, rows, missing = [], [], [], []
        for i, e in enumerate(evs):
            seq = e.sequence_key.with_ordinal(i)
            seqs.append(seq)
            if isinstance(e, DeleteEvent):
                types.append(CDC_DELETE)
                rows.append(e.old_row)
                missing.append(None)
            else:
                omitted = [c.name for c, v
                           in zip(schema.replicated_columns, e.row.values)
                           if v is TOAST_UNCHANGED]
                if omitted and isinstance(e, UpdateEvent) \
                        and e.old_row is not None \
                        and _identity_values(schema, e.old_row) \
                        != _identity_values(schema, e.row):
                    # the old-identity row is deleted by the split program;
                    # a patch keyed by the NEW identity has no stored row
                    # to preserve columns from — unreconstructable
                    raise EtlError(
                        ErrorKind.SOURCE_REPLICA_IDENTITY,
                        f"lake: identity-changing update for {schema.name} "
                        f"omits TOASTed column(s) {omitted}; set REPLICA "
                        f"IDENTITY FULL on the source table.")
                if omitted:
                    # unchanged-TOAST without an old image: column-wise
                    # patch — stored values for the omitted columns are
                    # preserved at collapse (ducklake/batches.rs Partial)
                    types.append(CDC_PATCH)
                    missing.append(json.dumps(omitted))
                else:
                    types.append(CDC_UPSERT)
                    missing.append(None)
                rows.append(e.row)
        max_seq = max(seqs)
        if watermark and max_seq <= watermark:
            return  # replay-epoch dedup: whole batch already applied
        import pyarrow as pa

        batch = ColumnarBatch.from_rows(schema, rows)
        rb = batch.to_arrow()
        rb = rb.append_column(CHANGE_TYPE_COLUMN,
                              pa.array(types, type=pa.string()))
        rb = rb.append_column(CHANGE_SEQUENCE_COLUMN,
                              pa.array(seqs, type=pa.string()))
        if any(m is not None for m in missing):
            rb = rb.append_column(PATCH_MISSING_COLUMN,
                                  pa.array(missing, type=pa.string()))
        await self._store_cdc_rb(schema, name, gen, rb, len(rows), max_seq)

    async def _store_cdc_rb(self, schema: ReplicatedTableSchema, name: str,
                            gen: int, rb: "pa.RecordBatch", n_rows: int,
                            max_seq: str) -> None:
        """Shared CDC storage tail (columnar + row paths): catalog-inlined
        IPC blob for tiny batches, Parquet file otherwise, then the
        inline-flush and compaction policies."""
        import pyarrow as pa

        epoch = self.current_replay_epoch(schema.id)
        if 0 < rb.nbytes < self.config.inline_max_bytes:
            # data inlining (ducklake/inline_size.rs): tiny CDC batches go
            # into the catalog as Arrow IPC blobs, not 1-row Parquet files
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, rb.schema) as w:
                w.write_batch(rb)
            self._record_file(schema.id, gen, "", "cdc", n_rows,
                              max_seq, epoch,
                              sink.getvalue().to_pybytes())
            if self._pending_inline_bytes(schema.id, gen) \
                    >= self.config.inline_flush_bytes:
                await self.flush_inlined(schema.id)
        else:
            path = self._write_parquet(self.root / name, rb)
            self._record_file(schema.id, gen, path, "cdc", n_rows,
                              max_seq, epoch)
        if self._cdc_file_count(schema.id, gen) >= self.config.compact_min_files:
            await self.compact(schema.id)

    def _pending_inline_bytes(self, table_id: TableId, gen: int) -> int:
        """Accumulated catalog-inlined bytes for one table generation —
        the flush-policy input, exported as a gauge (reference
        DuckLakePendingInlineSizeSampler)."""
        from ..telemetry.metrics import (ETL_LAKE_INLINED_DATA_BYTES,
                                         LABEL_TABLE, registry)

        (n,) = self._catalog().execute(
            PENDING_INLINE_BYTES_SQL, (table_id, gen)).fetchone()
        registry.gauge_set(ETL_LAKE_INLINED_DATA_BYTES, n,
                           labels={LABEL_TABLE: str(table_id)})
        return int(n)

    async def flush_inlined(self, table_id: TableId) -> int:
        """Flush this table's inlined CDC batches into ONE Parquet file.
        Sequence-aware collapse makes the reordering safe: application
        order is the CHANGE_SEQUENCE sort, not catalog insertion order.
        Returns the number of inlined entries flushed."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        db = self._catalog()
        db.execute("BEGIN IMMEDIATE")
        try:
            row = db.execute(
                "SELECT name, schema_json, generation, max_seq FROM "
                "lake_tables WHERE table_id = ?", (table_id,)).fetchone()
            if row is None:
                db.execute("ROLLBACK")
                return 0
            name, _, gen, _ = row
            entries = db.execute(
                "SELECT id, inline_payload, max_seq, replay_epoch FROM "
                "lake_files WHERE table_id = ? AND generation = ? AND "
                "inline_payload IS NOT NULL ORDER BY id",
                (table_id, gen)).fetchall()
            if not entries:
                db.execute("ROLLBACK")
                return 0
            batches = []
            for _id, payload, _seq, _ep in entries:
                with pa.ipc.open_stream(payload) as r:
                    batches.extend(r)
            merged = _concat_cdc_batches(batches)
            path = self._new_data_path(self.root / name)
            path.parent.mkdir(parents=True, exist_ok=True)
            pq.write_table(merged, path)
            ids = [e[0] for e in entries]
            db.execute(f"DELETE FROM lake_files WHERE id IN "
                       f"({','.join('?' * len(ids))})", ids)
            db.execute(
                "INSERT INTO lake_files (table_id, generation, path, kind, "
                "row_count, max_seq, replay_epoch) "
                "VALUES (?, ?, ?, 'cdc', ?, ?, ?)",
                (table_id, gen, str(path), merged.num_rows,
                 max(e[2] for e in entries), entries[-1][3]))
            db.commit()
        except BaseException:
            try:
                db.execute("ROLLBACK")
            except sqlite3.OperationalError:
                pass  # commit failures auto-rollback; keep the real error
            # the rollback restored the inlined entries, so the merged
            # file is unreferenced — remove it or it leaks forever
            # (vacuum only deletes cataloged paths)
            try:
                path.unlink(missing_ok=True)
            except (OSError, UnboundLocalError):
                pass
            raise
        self._pending_inline_bytes(table_id, gen)  # refresh the gauge
        return len(entries)

    def _cdc_file_count(self, table_id: TableId, gen: int) -> int:
        """Real CDC FILES only: catalog-inlined entries are the cheap tier
        flush_inlined consolidates — counting them would fire a full
        compaction after a handful of tiny batches, the exact cost
        inlining exists to avoid."""
        return self._catalog().execute(
            CDC_FILE_COUNT_SQL, (table_id, gen)).fetchone()[0]

    async def drop_table(self, table_id: TableId,
                         schema: ReplicatedTableSchema | None = None) -> None:
        # schema hint unused: the catalog is persistent, so the name
        # mapping survives restarts
        db = self._catalog()
        for (path,) in db.execute("SELECT path FROM lake_files WHERE "
                                  "table_id = ?", (table_id,)):
            if path:  # inlined entries have no file
                Path(path).unlink(missing_ok=True)
        db.execute("DELETE FROM lake_files WHERE table_id = ?", (table_id,))
        db.execute("DELETE FROM lake_tables WHERE table_id = ?", (table_id,))
        # a re-added table must start from LEGACY_REPLAY_EPOCH, not inherit
        # the dropped table's epoch chain
        db.execute("DELETE FROM lake_replay_epochs WHERE table_id = ?",
                   (table_id,))
        db.commit()
        from ..telemetry.metrics import (ETL_LAKE_INLINED_DATA_BYTES,
                                         LABEL_TABLE, registry)

        # clear the pending-inline gauge so a dropped table doesn't report
        # phantom unflushed bytes forever
        registry.gauge_set(ETL_LAKE_INLINED_DATA_BYTES, 0,
                           labels={LABEL_TABLE: str(table_id)})

    # -- replay epochs (reference ducklake/replay_epoch.rs) -------------------

    def current_replay_epoch(self, table_id: TableId) -> str:
        row = self._catalog().execute(
            "SELECT replay_epoch FROM lake_replay_epochs WHERE "
            "table_id = ?", (table_id,)).fetchone()
        return row[0] if row else LEGACY_REPLAY_EPOCH

    def _begin_replay_reset(self, table_id: TableId) -> str:
        """Start (or resume) an epoch transition: records the pending
        epoch BEFORE the reset mutates anything, so a crash mid-reset is
        detected and completed at the next startup (replay_epoch.rs
        begin_table_replay_epoch_transition; idempotent via coalesce)."""
        import datetime as _dt

        db = self._catalog()
        pending = new_uuid4(self._rng).hex
        db.execute(
            "INSERT INTO lake_replay_epochs "
            "(table_id, replay_epoch, pending_replay_epoch, updated_at) "
            "VALUES (?, ?, ?, ?) "
            "ON CONFLICT (table_id) DO UPDATE SET "
            "pending_replay_epoch = COALESCE("
            "  lake_replay_epochs.pending_replay_epoch, "
            "  excluded.pending_replay_epoch), "
            "updated_at = excluded.updated_at",
            (table_id, LEGACY_REPLAY_EPOCH, pending,
             _dt.datetime.now(_dt.timezone.utc).isoformat()))
        db.commit()
        row = db.execute(
            "SELECT pending_replay_epoch FROM lake_replay_epochs "
            "WHERE table_id = ?", (table_id,)).fetchone()
        return row[0]

    async def _finish_replay_reset(self, table_id: TableId) -> None:
        """The reset itself + promotion: bump the generation (re-running
        after a crash just adds another empty — therefore identical —
        generation) and promote the pending epoch
        (complete_table_replay_epoch_transition)."""
        db = self._catalog()
        db.execute("UPDATE lake_tables SET generation = generation + 1, "
                   "max_seq = '' WHERE table_id = ?", (table_id,))
        db.execute(
            "UPDATE lake_replay_epochs SET "
            "replay_epoch = pending_replay_epoch, "
            "pending_replay_epoch = NULL WHERE table_id = ? "
            "AND pending_replay_epoch IS NOT NULL", (table_id,))
        db.commit()

    async def truncate_table(self, table_id: TableId) -> None:
        """Generation bump UNDER a replay-epoch transition: reads see only
        the new (empty) generation, and the rotated epoch makes the
        sequence watermark inert for re-replayed data — a re-streamed
        batch after the reset can never be deduped against pre-reset
        sequence keys (the versioned-successor stance + replay_epoch.rs)."""
        self._begin_replay_reset(table_id)
        await self._finish_replay_reset(table_id)

    async def shutdown(self) -> None:
        if self._db is not None:
            self._db.close()
            self._db = None

    # -- reads (the `_current` semantics) -----------------------------------------

    def read_current(self, table_id: TableId) -> "pa.Table":
        """Collapse base + CDC files into live rows: per identity key, the
        highest sequence wins; deletes drop the key."""
        row = self._table_row(table_id)
        if row is None:
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           f"unknown table {table_id}")
        _, _, gen, _ = row
        files = self._catalog().execute(
            "SELECT path, kind, inline_payload FROM lake_files WHERE "
            "table_id = ? AND generation = ? ORDER BY id",
            (table_id, gen)).fetchall()
        return self._collapse(row, files)

    @staticmethod
    def _read_entry(path: str, payload: "bytes | None") -> "pa.Table":
        """One catalog entry's rows: a Parquet file, or a catalog-inlined
        Arrow IPC blob (path == '')."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        if payload is not None:
            with pa.ipc.open_stream(payload) as r:
                return pa.Table.from_batches(list(r))
        return pq.read_table(path)

    def _collapse(self, table_row,
                  files: "list[tuple[str, str, bytes | None]]") -> "pa.Table":
        """Collapse an EXPLICIT (path, kind, inline_payload) entry list —
        the caller passes the lake_tables row and file set it observed
        (compact: under its transaction) so the merge and the catalog swap
        agree on inputs.

        Application order is base entries (catalog order) then CDC records
        sorted by CHANGE_SEQUENCE — the sequence keys are the table's
        replay order, so catalog insertion order stops mattering and an
        inline flush may merge non-contiguous entries safely."""
        import pyarrow as pa

        name, schema_json, gen, _ = table_row
        schema = ReplicatedTableSchema.from_json(json.loads(schema_json))
        key_cols = [c.name for c in schema.identity_columns()] or \
            [c.name for c in schema.replicated_columns]
        live: dict[tuple, dict] = {}
        cdc_records: list[tuple[str, dict]] = []
        for path, kind, payload in files:
            t = self._read_entry(path, payload)
            if kind != "cdc":
                for rec in t.to_pylist():
                    live[tuple(rec[k] for k in key_cols)] = rec
                continue
            for rec in t.to_pylist():
                cdc_records.append((rec.get(CHANGE_SEQUENCE_COLUMN) or "",
                                    rec))
        cdc_records.sort(key=lambda sr: sr[0])
        for _seq, rec in cdc_records:
            key = tuple(rec[k] for k in key_cols)
            ct = rec.get(CHANGE_TYPE_COLUMN)
            if ct == CDC_DELETE:
                live.pop(key, None)
                continue
            patch_missing = rec.get(PATCH_MISSING_COLUMN)
            rec.pop(CHANGE_TYPE_COLUMN, None)
            rec.pop(CHANGE_SEQUENCE_COLUMN, None)
            rec.pop(PATCH_MISSING_COLUMN, None)
            if ct == CDC_PATCH:
                # column-wise update: omitted columns keep stored values;
                # patch for an absent key is a no-op (reference SQL
                # UPDATE-with-predicate semantics)
                prev = live.get(key)
                if prev is None:
                    continue
                omitted = set(json.loads(patch_missing or "[]"))
                for k, v in rec.items():
                    if k not in omitted:
                        prev[k] = v
            else:
                live[key] = rec
        if not live:
            return pa.table({c.name: [] for c in schema.replicated_columns})
        return pa.Table.from_pylist(list(live.values()))

    # -- maintenance (external-maintenance parity) ----------------------------------

    async def vacuum(self, table_id: TableId) -> int:
        """Delete files from superseded generations, under the maintenance
        flag (a concurrent reader of the current generation never loses
        files; old-generation files are unreachable once the bump commits,
        but the flag still serializes vs. other maintenance)."""
        db = self._catalog()
        busy = db.execute("SELECT in_progress FROM lake_maintenance WHERE "
                          "table_id = ?", (table_id,)).fetchone()
        if busy and busy[0]:
            return 0
        hid = self._history_start(table_id, "vacuum")
        db.execute("INSERT INTO lake_maintenance (table_id, in_progress) "
                   "VALUES (?, 1) ON CONFLICT (table_id) DO UPDATE SET "
                   "in_progress = 1", (table_id,))
        db.commit()
        outcome = "failed"
        n = 0
        try:
            rows = db.execute(
                "SELECT f.id, f.path FROM lake_files f JOIN lake_tables t "
                "ON t.table_id = f.table_id WHERE f.table_id = ? "
                "AND f.generation < t.generation", (table_id,)).fetchall()
            for fid, path in rows:
                if path:  # inlined entries have no file
                    Path(path).unlink(missing_ok=True)
                db.execute("DELETE FROM lake_files WHERE id = ?", (fid,))
            db.commit()
            n = len(rows)
            outcome = "ok" if n else "skipped"
            return n
        finally:
            db.execute("UPDATE lake_maintenance SET in_progress = 0 WHERE "
                       "table_id = ?", (table_id,))
            db.commit()
            self._history_finish(hid, outcome, n)

    def table_ids(self) -> "list[TableId]":
        return [r[0] for r in self._catalog().execute(
            "SELECT table_id FROM lake_tables").fetchall()]

    # writers give up on the maintenance flag after this long: a crashed
    # external maintenance process (flag never cleared) must surface as a
    # retryable error, not wedge the pipeline silently
    MAINTENANCE_WAIT_TIMEOUT_S = 60.0

    def _history_start(self, table_id: TableId, op: str) -> int:
        import datetime as _dt

        db = self._catalog()
        cur = db.execute(
            "INSERT INTO lake_maintenance_history "
            "(table_id, operation, started_at) VALUES (?, ?, ?)",
            (table_id, op, _dt.datetime.now(_dt.timezone.utc).isoformat()))
        db.commit()
        return cur.lastrowid

    def _history_finish(self, hid: int, outcome: str, files: int) -> None:
        import datetime as _dt

        db = self._catalog()
        db.execute(
            "UPDATE lake_maintenance_history SET finished_at = ?, "
            "outcome = ?, files_affected = ? WHERE id = ?",
            (_dt.datetime.now(_dt.timezone.utc).isoformat(), outcome,
             files, hid))
        db.commit()

    def current_cdc_file_count(self, table_id: TableId) -> int:
        """CDC files in the table's CURRENT generation — the compaction
        policy input (stable public surface; callers must not index
        catalog rows)."""
        row = self._table_row(table_id)
        if row is None:
            return 0
        return self._cdc_file_count(table_id, row[2])

    def pending_inline_bytes(self, table_id: TableId) -> int:
        """Catalog-inlined bytes awaiting flush in the current generation
        — the inline-flush policy input (maintenance coordination)."""
        row = self._table_row(table_id)
        if row is None:
            return 0
        return self._pending_inline_bytes(table_id, row[2])

    def record_maintenance_skip(self, table_id: TableId, op: str) -> None:
        """Audit row for a policy decision that never invoked the op."""
        self._history_finish(self._history_start(table_id, op),
                             "skipped", 0)

    def maintenance_history(self, table_id: "TableId | None" = None,
                            limit: int = 50) -> list[dict]:
        """Recent maintenance operations, newest first (reference
        etl-maintenance operation history)."""
        db = self._catalog()
        where = "WHERE table_id = ?" if table_id is not None else ""
        params = (table_id, limit) if table_id is not None else (limit,)
        rows = db.execute(
            f"SELECT table_id, operation, started_at, finished_at, "
            f"files_affected, outcome FROM lake_maintenance_history "
            f"{where} ORDER BY id DESC LIMIT ?", params).fetchall()
        return [{"table_id": t, "operation": op, "started_at": s0,
                 "finished_at": f, "files_affected": n, "outcome": o}
                for t, op, s0, f, n, o in rows]

    async def _wait_maintenance_clear(self, table_id: TableId) -> None:
        """Writers block while external maintenance holds the table (a
        writer that never checked the flag would let an external
        compaction race a live CDC commit)."""
        import logging

        db = self._catalog()
        waited = 0.0
        warned = False
        while True:
            busy = db.execute(
                "SELECT in_progress FROM lake_maintenance WHERE "
                "table_id = ?", (table_id,)).fetchone()
            if not busy or not busy[0]:
                return
            if waited >= self.MAINTENANCE_WAIT_TIMEOUT_S:
                raise EtlError(
                    ErrorKind.DESTINATION_FAILED,
                    f"lake: maintenance flag for table {table_id} held for "
                    f">{self.MAINTENANCE_WAIT_TIMEOUT_S:.0f}s — external "
                    f"maintenance crashed without clearing it? (UPDATE "
                    f"lake_maintenance SET in_progress = 0 to recover)")
            if waited >= 5.0 and not warned:
                warned = True
                logging.getLogger("etl_tpu_torch.destinations").warning(
                    "lake: writer waiting on maintenance flag for table %s",
                    table_id)
            await asyncio.sleep(0.05)
            waited += 0.05

    async def compact(self, table_id: TableId) -> int:
        """Merge the current generation's files into one base file.
        Returns merged file count. Guarded by the catalog maintenance flag
        (reference external_maintenance.rs coordination).

        The observe→merge→replace sequence runs inside ONE immediate
        catalog transaction and deletes ONLY the observed file ids — a CDC
        file committed concurrently (external maintenance binary vs a live
        replicator) survives the swap instead of being dropped unmerged."""
        import pyarrow.parquet as pq

        db = self._catalog()
        busy = db.execute("SELECT in_progress FROM lake_maintenance WHERE "
                          "table_id = ?", (table_id,)).fetchone()
        if busy and busy[0]:
            return 0
        hid = self._history_start(table_id, "compact")
        db.execute("INSERT INTO lake_maintenance (table_id, in_progress) "
                   "VALUES (?, 1) ON CONFLICT (table_id) DO UPDATE SET "
                   "in_progress = 1", (table_id,))
        db.commit()
        n_files = 0
        outcome = "skipped"
        try:
            db.execute("BEGIN IMMEDIATE")
            row = db.execute(
                "SELECT name, schema_json, generation, max_seq FROM "
                "lake_tables WHERE table_id = ?", (table_id,)).fetchone()
            if row is None:
                db.execute("ROLLBACK")
                return 0
            name, _, gen, max_seq = row
            files = db.execute(
                "SELECT id, path, kind, inline_payload FROM lake_files "
                "WHERE table_id = ? AND generation = ? ORDER BY id",
                (table_id, gen)).fetchall()
            if len(files) < 2:
                db.execute("ROLLBACK")
                return 0
            merged = self._collapse(row, [(p, k, b) for _, p, k, b in files])
            path = self._new_data_path(self.root / name)
            path.parent.mkdir(parents=True, exist_ok=True)
            pq.write_table(merged, path)
            ids = [fid for fid, *_ in files]
            db.execute(
                f"DELETE FROM lake_files WHERE id IN "
                f"({','.join('?' * len(ids))})", ids)
            db.execute(
                "INSERT INTO lake_files (table_id, generation, path, kind, "
                "row_count, max_seq, replay_epoch) "
                "VALUES (?, ?, ?, 'base', ?, ?, ?)",
                (table_id, gen, str(path), merged.num_rows, max_seq,
                 self.current_replay_epoch(table_id)))
            db.commit()
            self._pending_inline_bytes(table_id, gen)  # refresh the gauge
            for _id, p, _k, _b in files:
                if p:  # inlined entries have no file
                    Path(p).unlink(missing_ok=True)
            n_files = len(files)
            outcome = "ok"
            return n_files
        except BaseException:
            outcome = "failed"
            try:
                db.execute("ROLLBACK")
            except sqlite3.OperationalError:
                pass
            # rollback restored the source file rows: the merged file is
            # unreferenced — remove it or it leaks (vacuum only deletes
            # cataloged paths)
            try:
                path.unlink(missing_ok=True)
            except (OSError, UnboundLocalError):
                pass
            raise
        finally:
            db.execute("UPDATE lake_maintenance SET in_progress = 0 WHERE "
                       "table_id = ?", (table_id,))
            db.commit()
            self._history_finish(hid, outcome, n_files)
