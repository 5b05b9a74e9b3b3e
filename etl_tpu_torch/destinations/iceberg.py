"""Iceberg destination: REST catalog + Parquet appends committed as REAL
Iceberg v2 snapshots.

Reference parity: crates/etl-destinations/src/iceberg/ ({catalog,client,
core,schema}.rs, 5.6k LoC). Each append:

1. writes the Parquet data file into the warehouse;
2. gathers data-file statistics from the Parquet footer (record counts,
   per-column sizes/null counts, lower/upper bounds — iceberg_meta.py);
3. writes an Avro manifest file + manifest list (hand-rolled Avro OCF
   writer; no avro library in the environment);
4. commits through the standard Iceberg REST protocol:
   `POST /v1/namespaces/{ns}/tables/{t}` with an
   assert-ref-snapshot-id requirement (optimistic CAS against the main
   branch) and add-snapshot + set-snapshot-ref updates.

Schema evolution rides add-schema + set-current-schema updates; truncate
is a `delete`-operation snapshot whose manifest list is empty. The fake
catalog used in tests (testing/fake_iceberg.py) parses the manifest
chain with an INDEPENDENT Avro reader and rejects commits whose
metadata doesn't hold together.

Copy of the reference's `etl_tpu/destinations/iceberg.py`. pyarrow is
imported inside the methods that write data files, so this module
imports where pyarrow is not installed; constructing an
`IcebergDestination` there raises a typed CONFIG_INVALID naming pyarrow.
Data-file names, manifest names, OCF sync markers and snapshot ids draw
from the `rng` the destination is built with (a `random.Random` a test
seeds), else from fresh version-4 UUIDs.
"""

from __future__ import annotations

import asyncio
import json
import random
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import aiohttp

from ..analysis.annotations import hot_loop, transactional_commit
from ..models.errors import ErrorKind, EtlError
from ..models.event import ChangeType, DeleteEvent, Event
from ..models.pgtypes import CellKind
from ..models.schema import ReplicatedTableSchema, TableId
from ..models.table_row import ColumnarBatch
from .base import CommitRange, Destination, WriteAck, expand_batch_events
from .iceberg_meta import (DataFileInfo, build_snapshot, data_file_stats,
                           new_snapshot_id, write_manifest,
                           write_manifest_list)
from .util import (CHANGE_SEQUENCE_COLUMN, CHANGE_TYPE_COLUMN,
                   DestinationRetryPolicy, change_type_label,
                   classify_http_error, escaped_table_name, new_uuid4,
                   require_full_row, require_pyarrow,
                   sequential_event_program, with_retries)

_ICEBERG_TYPES: dict[CellKind, str] = {
    CellKind.BOOL: "boolean", CellKind.I16: "int", CellKind.I32: "int",
    CellKind.U32: "long", CellKind.I64: "long", CellKind.F32: "float",
    CellKind.F64: "double", CellKind.NUMERIC: "string",
    CellKind.DATE: "date", CellKind.TIME: "time",
    CellKind.TIMESTAMP: "timestamp", CellKind.TIMESTAMPTZ: "timestamptz",
    CellKind.UUID: "uuid", CellKind.JSON: "string",
    CellKind.BYTES: "binary", CellKind.STRING: "string",
    CellKind.ARRAY: "string", CellKind.INTERVAL: "string",
}


class _CasConflict(Exception):
    """assert-ref-snapshot-id lost the optimistic race (another writer
    advanced the branch) — recoverable by re-adopting catalog state."""


@dataclass(frozen=True)
class IcebergConfig:
    catalog_url: str  # REST catalog base, e.g. http://host:8181
    warehouse_path: str  # where parquet data files are written
    namespace: str = "etl"
    auth_token: str = ""


@dataclass
class _TableState:
    """Catalog-side state tracked per table between commits."""

    name: str
    snapshot_id: int | None = None  # main-branch head (CAS token)
    sequence_number: int = 0
    schema_id: int = 0
    schema_count: int = 1  # schemas registered (add-schema ids are dense)
    total_records: int = 0
    schema: ReplicatedTableSchema | None = None
    # column name → Iceberg field id. Ids are assigned once and NEVER
    # reused or reassigned (spec: schema evolution must keep existing
    # ids stable; manifests key statistics by id, so an ordinal
    # reassignment would silently corrupt scan pruning on old files)
    field_ids: dict[str, int] = None  # type: ignore[assignment]
    last_column_id: int = 0  # high-water mark; fresh ids start past it
    # the catalog's CURRENT schema fields (adopt path): lets a restarted
    # destination decide whether a SchemaChangeEvent still needs an
    # add-schema commit or the catalog already caught up
    catalog_fields: list | None = None


class IcebergDestination(Destination):
    def __init__(self, config: IcebergConfig,
                 retry: DestinationRetryPolicy | None = None,
                 rng: "random.Random | None" = None):
        require_pyarrow("the iceberg destination")
        self.config = config
        self._rng = rng
        self.retry = retry or DestinationRetryPolicy()
        self._session: aiohttp.ClientSession | None = None
        self._tables: dict[TableId, _TableState] = {}
        # exactly-once seam: the in-flight committed write's range,
        # stamped into every snapshot summary _commit_snapshot builds
        # while it is set (atomic with the catalog CAS commit)
        self._pending_commit = None
        # one commit at a time per table from this destination: its own
        # concurrent writers (a copy's partitions) would otherwise race
        # each other's CAS and lose 4 times in a row (a departure: the
        # reference's do). The CAS still guards against other writers.
        self._commit_locks: dict[str, asyncio.Lock] = {}

    async def _api(self, method: str, path: str,
                   body: dict | None = None,
                   conflict_ok: bool = False,
                   conflict_raises: bool = False) -> dict:
        if self._session is None:
            self._session = aiohttp.ClientSession()
        headers = {"Authorization": f"Bearer {self.config.auth_token}"} \
            if self.config.auth_token else {}

        async def attempt() -> dict:
            async with self._session.request(
                    method, f"{self.config.catalog_url}/v1{path}",
                    json=body, headers=headers) as resp:
                text = await resp.text()
                if resp.status == 409 and conflict_ok:
                    return {"alreadyExists": True}
                if resp.status == 409 and conflict_raises:
                    # optimistic-CAS loss: blind HTTP retry would replay
                    # the SAME stale requirement forever — the caller
                    # must re-adopt catalog state and rebuild the commit
                    raise _CasConflict(text[:300])
                if resp.status >= 400:
                    raise classify_http_error(
                        "iceberg", resp.status, f"{path}: {text[:300]}")
                return json.loads(text) if text else {}

        def retryable(e: BaseException) -> bool:
            if isinstance(e, EtlError):
                return e.kind is ErrorKind.DESTINATION_THROTTLED
            return isinstance(e, (aiohttp.ClientError, OSError))

        return await with_retries(attempt, self.retry, retryable)

    async def startup(self) -> None:
        Path(self.config.warehouse_path).mkdir(parents=True, exist_ok=True)
        await self._api("POST", "/namespaces",
                        {"namespace": [self.config.namespace]},
                        conflict_ok=True)

    # -- schema ---------------------------------------------------------------

    @staticmethod
    def _assign_field_ids(schema: ReplicatedTableSchema,
                          prev: dict[str, int] | None = None,
                          last: int = 0) -> tuple[dict[str, int], int]:
        """Stable field-id assignment: columns present in `prev` keep
        their ids; new columns get fresh ids past `last` (the table's
        last-column-id). Ids are never reused — a dropped-then-re-added
        column gets a NEW id, as the spec requires."""
        ids: dict[str, int] = {}
        names = [c.name for c in schema.replicated_columns]
        names += [CHANGE_TYPE_COLUMN, CHANGE_SEQUENCE_COLUMN]
        for name in names:
            if prev and name in prev:
                ids[name] = prev[name]
            else:
                last += 1
                ids[name] = last
        return ids, last

    def _iceberg_schema(self, schema: ReplicatedTableSchema,
                        field_ids: dict[str, int],
                        schema_id: int = 0) -> dict:
        fields = [{"id": field_ids[c.name], "name": c.name,
                   "required": not c.nullable,
                   "type": _ICEBERG_TYPES.get(c.kind, "string")}
                  for c in schema.replicated_columns]
        fields.append({"id": field_ids[CHANGE_TYPE_COLUMN],
                       "name": CHANGE_TYPE_COLUMN,
                       "required": False, "type": "string"})
        fields.append({"id": field_ids[CHANGE_SEQUENCE_COLUMN],
                       "name": CHANGE_SEQUENCE_COLUMN,
                       "required": False, "type": "string"})
        identifiers = [field_ids[c.name] for c in
                       schema.replicated_columns
                       if c.primary_key_ordinal is not None]
        return {"type": "struct", "schema-id": schema_id,
                "identifier-field-ids": identifiers, "fields": fields}

    def _field_meta(self, st: _TableState
                    ) -> tuple[dict[str, int], dict[int, str]]:
        """(column name → field id, field id → iceberg type), derived
        from the SAME schema document the catalog sees — one source of
        truth for the id assignment."""
        assert st.schema is not None
        doc = self._iceberg_schema(st.schema, st.field_ids, st.schema_id)
        ids = {f["name"]: f["id"] for f in doc["fields"]}
        types = {f["id"]: f["type"] for f in doc["fields"]}
        return ids, types

    async def _ensure_table(self, schema: ReplicatedTableSchema
                            ) -> _TableState:
        st = self._tables.get(schema.id)
        if st is not None and st.schema == schema:
            return st
        name = escaped_table_name(schema.name)
        field_ids, last_id = self._assign_field_ids(schema)
        schema_doc = self._iceberg_schema(schema, field_ids)
        doc = await self._api(
            "POST", f"/namespaces/{self.config.namespace}/tables",
            {"name": name, "schema": schema_doc,
             "partition-spec": {"spec-id": 0, "fields": []},
             "properties": {"format-version": "2"}},
            conflict_ok=True)
        st = _TableState(name=name, schema=schema, field_ids=field_ids,
                         last_column_id=last_id,
                         catalog_fields=schema_doc["fields"])
        if doc.get("alreadyExists"):
            await self._adopt_catalog_state(st, schema)
        self._tables[schema.id] = st
        return st

    async def _adopt_catalog_state(self, st: _TableState,
                                   schema: ReplicatedTableSchema) -> dict:
        """Refresh st from the catalog's CURRENT metadata (restart
        recovery, and CAS-conflict recovery — another writer advanced
        the branch, so the cached head/sequence/totals are stale).
        Returns the metadata document (conflict recovery inspects the
        snapshot list for its own lost-response commit)."""
        loaded = await self._api(
            "GET",
            f"/namespaces/{self.config.namespace}/tables/{st.name}")
        meta = loaded.get("metadata", {})
        st.snapshot_id = meta.get("current-snapshot-id")
        st.sequence_number = meta.get("last-sequence-number", 0)
        st.schema_id = meta.get("current-schema-id", 0)
        st.schema_count = max(1, len(meta.get("schemas", [])))
        st.catalog_fields = None  # unknown until found below
        adopted: dict[str, int] = {}
        all_ids = [0]
        for s in meta.get("schemas", []):
            all_ids += [f["id"] for f in s.get("fields", [])]
            if s.get("schema-id") == st.schema_id:
                st.catalog_fields = s.get("fields")
                adopted = {f["name"]: f["id"] for f in s["fields"]}
        # keep the catalog's ids; columns the target schema adds on
        # top get fresh ids past EVERY id any schema ever used
        st.field_ids, st.last_column_id = self._assign_field_ids(
            schema, adopted or None, max(all_ids))
        st.total_records = 0
        for snap in meta.get("snapshots", []):
            if snap.get("snapshot-id") == st.snapshot_id:
                st.total_records = int(
                    snap.get("summary", {}).get("total-records", 0))
        return meta

    # -- data + snapshot commit ------------------------------------------------

    def _table_dir(self, name: str) -> Path:
        return Path(self.config.warehouse_path) / self.config.namespace \
            / name

    def _write_data_file(self, st: _TableState,
                         rb: "pa.RecordBatch") -> DataFileInfo:
        import pyarrow as pa
        import pyarrow.parquet as pq

        d = self._table_dir(st.name) / "data"
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{new_uuid4(self._rng).hex}.parquet"
        field_ids, field_types = self._field_meta(st)
        # stamp Iceberg field ids into the Parquet schema
        # (PARQUET:field_id metadata → parquet field_id on write): the
        # spec requires data-file columns to resolve by ID, not name —
        # without this a conformant engine cannot project any column
        fields = [pa.field(f.name, f.type, f.nullable,
                           metadata={b"PARQUET:field_id":
                                     str(field_ids[f.name]).encode()})
                  for f in rb.schema]
        rb = pa.RecordBatch.from_arrays(list(rb.columns),
                                        schema=pa.schema(fields))
        pq.write_table(pa.Table.from_batches([rb]), path)
        return data_file_stats(path, field_ids, field_types)

    async def _commit_snapshot(self, st: _TableState,
                               files: list[DataFileInfo],
                               operation: str = "append") -> None:
        lock = self._commit_locks.setdefault(st.name, asyncio.Lock())
        async with lock:
            await self._commit_snapshot_locked(st, files, operation)

    async def _commit_snapshot_locked(self, st: _TableState,
                                      files: list[DataFileInfo],
                                      operation: str) -> None:
        # all state transitions are staged LOCALLY and applied only after
        # the catalog accepts the commit — a failed commit (CAS 409,
        # exhausted retries) must leave the table's sequence number and
        # row totals untouched or every later commit would be rejected.
        # A lost CAS race (another writer advanced the branch) re-adopts
        # the catalog state and REBUILDS the commit on the new head —
        # blind retry would replay the stale requirement forever.
        meta_dir = self._table_dir(st.name) / "metadata"
        # the files in this commit were ALREADY written (parquet field
        # ids stamped) under the pre-conflict schema identity — the
        # rebuilt manifest must keep describing them with that identity
        # (schemas are append-only, so the id stays valid) even though
        # adoption refreshes st for FUTURE writes
        commit_schema_id = st.schema_id
        commit_field_ids = dict(st.field_ids)
        assert st.schema is not None
        commit_schema_json = json.dumps(self._iceberg_schema(
            st.schema, commit_field_ids, commit_schema_id))
        # stable across retries: a lost RESPONSE re-POSTs, 409s on our own
        # head, and is recognized below
        snapshot_id = new_snapshot_id(self._rng)
        for attempt in range(4):
            sequence_number = st.sequence_number + 1
            manifests = []
            if files:
                manifests.append(write_manifest(
                    meta_dir, files, snapshot_id, sequence_number,
                    commit_schema_json, rng=self._rng))
            manifest_list = write_manifest_list(
                meta_dir, manifests, snapshot_id, sequence_number,
                rng=self._rng)
            added = sum(f.record_count for f in files)
            new_total = added if operation == "delete" \
                else st.total_records + added
            snapshot = build_snapshot(
                snapshot_id, st.snapshot_id, sequence_number, manifest_list,
                operation, len(files), added, new_total,
                int(time.time() * 1000), commit_schema_id)
            if self._pending_commit is not None:
                # exactly-once: the WAL range rides the snapshot summary
                # (the Flink/Iceberg checkpoint-id idiom) — data files
                # and coordinates land in ONE catalog CAS commit, and
                # recover_high_water reads them back from the snapshot
                # log
                pc = self._pending_commit
                if pc.replay:
                    snapshot["summary"]["etl-replay-token"] = pc.token()
                else:
                    snapshot["summary"]["etl-high-water"] = pc.token()
                    if pc.commit_end_lsn:
                        snapshot["summary"]["etl-commit-end-lsn"] = \
                            str(pc.commit_end_lsn)
            body = {
                "requirements": [{
                    "type": "assert-ref-snapshot-id", "ref": "main",
                    "snapshot-id": st.snapshot_id,
                }],
                "updates": [
                    {"action": "add-snapshot", "snapshot": snapshot},
                    {"action": "set-snapshot-ref", "ref-name": "main",
                     "type": "branch", "snapshot-id": snapshot_id},
                ],
            }
            def _drop_attempt_files() -> None:
                # a commit the catalog did NOT take leaves this
                # attempt's manifest files unreachable — drop them
                # instead of leaving orphans
                for p in ([manifest_list]
                          + [m.manifest_path for m in manifests]):
                    Path(p).unlink(missing_ok=True)

            try:
                await self._api(
                    "POST",
                    f"/namespaces/{self.config.namespace}/tables/{st.name}",
                    body, conflict_raises=True)
            except _CasConflict as e:
                meta = await self._adopt_catalog_state(st, st.schema)
                if any(s.get("snapshot-id") == snapshot_id
                       for s in meta.get("snapshots", [])):
                    # the commit APPLIED but its response was lost: the
                    # conflicting head is our own snapshot (or a later
                    # one on top of it) — committing again would
                    # double-write every row. Adoption already set
                    # st.snapshot_id/sequence/totals from the catalog;
                    # the metadata files stay (the catalog references
                    # them).
                    return
                _drop_attempt_files()
                if attempt == 3:
                    raise EtlError(
                        ErrorKind.DESTINATION_FAILED,
                        f"iceberg: commit lost the CAS race 4 times "
                        f"on {st.name}: {e}")
                # jittered backoff before racing the other writer again
                # (instant retries let a steady writer win every round)
                await asyncio.sleep(self.retry.delay(attempt))
                continue
            except BaseException:
                _drop_attempt_files()
                raise
            break
        st.snapshot_id = snapshot_id
        st.sequence_number = sequence_number
        st.total_records = new_total

    async def write_table_rows(self, schema: ReplicatedTableSchema,
                               batch: ColumnarBatch) -> WriteAck:
        from .util import hex16_arrow

        st = await self._ensure_table(schema)
        if batch.num_rows:
            import numpy as np
            import pyarrow as pa

            rb = batch.to_arrow()
            n = batch.num_rows
            rb = rb.append_column(CHANGE_TYPE_COLUMN,
                                  pa.array(["UPSERT"] * n, pa.string()))
            rb = rb.append_column(
                CHANGE_SEQUENCE_COLUMN,
                # vectorized hex render (same bytes as the f-string form)
                hex16_arrow(np.arange(n, dtype=np.uint64)))
            f = self._write_data_file(st, rb)
            await self._commit_snapshot(st, [f])
        return WriteAck.durable()

    # -- columnar seam --------------------------------------------------------

    async def write_table_batch(self, schema: ReplicatedTableSchema,
                                batch: ColumnarBatch) -> WriteAck:
        """Copy path, columnar: Arrow-native with vectorized CDC metadata
        (the row path's per-row f-string sequence suffixes were measurable
        at copy rates)."""
        from .util import hex16_arrow

        st = await self._ensure_table(schema)
        if batch.num_rows:
            import numpy as np
            import pyarrow as pa

            rb = batch.to_arrow()
            n = batch.num_rows
            rb = rb.append_column(CHANGE_TYPE_COLUMN,
                                  pa.array(["UPSERT"] * n, pa.string()))
            rb = rb.append_column(
                CHANGE_SEQUENCE_COLUMN,
                hex16_arrow(np.arange(n, dtype=np.uint64)))
            f = self._write_data_file(st, rb)
            await self._commit_snapshot(st, [f])
        return WriteAck.durable()

    async def write_event_batches(self, events: Sequence[Event]) -> WriteAck:
        """CDC path, columnar: decoded batch runs commit as Parquet +
        snapshot without row expansion; old-tuple/TOAST batches and
        per-row events drop to the row path in place."""
        from .base import sequential_batch_program

        for op in sequential_batch_program(events):
            if op[0] == "batch":
                _, schema, cb = op
                await self._write_cdc_batch(schema, cb)
            elif op[0] == "rows":
                _, schema, evs = op
                await self._write_cdc_run(schema, evs)
            elif op[0] == "truncate":
                for sch in op[1].schemas:
                    await self._ensure_table(sch)
                    await self.truncate_table(sch.id)
            else:
                await self._apply_schema_change(op[1])
        return WriteAck.durable()

    @hot_loop
    async def _write_cdc_batch(self, schema: ReplicatedTableSchema,
                               cb) -> None:
        """@hot_loop: the Iceberg CDC egress hot path (etl-lint rule 13)."""
        from .util import (change_type_arrow, require_full_batch,
                           sequence_number_arrow)

        import numpy as np

        st = await self._ensure_table(schema)
        require_full_batch("iceberg", schema, cb.batch, cb.change_types)
        n = cb.num_rows
        rb = cb.batch.to_arrow()
        rb = rb.append_column(CHANGE_TYPE_COLUMN,
                              change_type_arrow(cb.change_types))
        rb = rb.append_column(
            CHANGE_SEQUENCE_COLUMN,
            sequence_number_arrow(cb.commit_lsns, cb.tx_ordinals,
                                  np.arange(n, dtype=np.uint64)))
        f = self._write_data_file(st, rb)
        await self._commit_snapshot(st, [f])

    async def write_events(self, events: Sequence[Event]) -> WriteAck:
        for op in sequential_event_program(expand_batch_events(events)):
            if op[0] == "rows":
                _, schema, evs = op
                await self._write_cdc_run(schema, evs)
            elif op[0] == "truncate":
                for sch in op[1].schemas:
                    # ensure first: after a restart the table may not be
                    # in the in-memory map, and silently skipping a
                    # truncate the source applied would leave stale data
                    await self._ensure_table(sch)
                    await self.truncate_table(sch.id)
            else:
                await self._apply_schema_change(op[1])
        return WriteAck.durable()

    # -- transactional seam (docs/destinations.md exactly-once contract) ------

    def supports_transactional_commit(self) -> bool:
        return True

    @transactional_commit
    async def write_event_batches_committed(
            self, events: Sequence[Event], commit: CommitRange) -> WriteAck:
        """Committed CDC write: the flush's WAL range is stamped into
        every snapshot summary the write commits (`_commit_snapshot`
        reads `_pending_commit`), so data files and coordinates land in
        ONE catalog CAS commit per table. Replays dedup by their exact
        token against the snapshot log and never stamp the streaming
        high-water key."""
        if commit.replay and await self._replay_seen(commit.token()):
            return WriteAck.durable()
        self._pending_commit = commit
        try:
            return await self.write_event_batches(events)
        finally:
            self._pending_commit = None

    async def _catalog_table_names(self) -> list[str]:
        doc = await self._api(
            "GET", f"/namespaces/{self.config.namespace}/tables")
        return [t["name"] for t in doc.get("identifiers", [])]

    async def _replay_seen(self, token: str) -> bool:
        for name in await self._catalog_table_names():
            loaded = await self._api(
                "GET",
                f"/namespaces/{self.config.namespace}/tables/{name}")
            for snap in loaded.get("metadata", {}).get("snapshots", []):
                if snap.get("summary", {}).get("etl-replay-token") \
                        == token:
                    return True
        return False

    async def recover_high_water(self) -> "CommitRange | None":
        """Max `etl-high-water` token across every table's snapshot log
        in the catalog — the committed truth survives a hard kill
        because it rides the snapshot commits themselves."""
        best: "tuple[int, int] | None" = None
        best_end: "int | None" = None
        for name in await self._catalog_table_names():
            loaded = await self._api(
                "GET",
                f"/namespaces/{self.config.namespace}/tables/{name}")
            for snap in loaded.get("metadata", {}).get("snapshots", []):
                summary = snap.get("summary", {})
                tok = summary.get("etl-high-water")
                if not tok:
                    continue
                lsn_hex, _, ord_hex = tok.partition("/")
                coord = (int(lsn_hex, 16), int(ord_hex, 16))
                if best is None or coord > best:
                    best = coord
                    end = summary.get("etl-commit-end-lsn")
                    best_end = int(end) if end else None
        if best is None:
            return None
        return CommitRange(high=best, commit_end_lsn=best_end)

    async def _write_cdc_run(self, schema: ReplicatedTableSchema,
                             evs: list) -> None:
        import pyarrow as pa

        st = await self._ensure_table(schema)
        rows, types, seqs = [], [], []
        for i, e in enumerate(evs):
            if isinstance(e, DeleteEvent):
                rows.append(e.old_row)
                types.append(change_type_label(ChangeType.DELETE))
            else:
                require_full_row("iceberg", schema, e.row)
                rows.append(e.row)
                types.append(change_type_label(ChangeType.INSERT))
            seqs.append(e.sequence_key.with_ordinal(i))
        rb = ColumnarBatch.from_rows(schema, rows).to_arrow()
        rb = rb.append_column(CHANGE_TYPE_COLUMN, pa.array(types, pa.string()))
        rb = rb.append_column(CHANGE_SEQUENCE_COLUMN,
                              pa.array(seqs, pa.string()))
        f = self._write_data_file(st, rb)
        await self._commit_snapshot(st, [f])

    async def _apply_schema_change(self, ev) -> None:
        """Schema evolution: add-schema + set-current-schema updates on
        the SAME commit path (a table re-create 409 would silently
        diverge the registered schema from the data files)."""
        new = ev.new_schema
        assert new is not None
        st = self._tables.get(new.id)
        if st is not None and st.schema == new:
            # in-process redelivery (apply-worker timed retry): the
            # add-schema already committed — registering it again would
            # append a duplicate schema on every retry
            return
        if st is None:
            # restart recovery: adopt the catalog's state first, then
            # decide by comparing FIELDS whether the catalog's current
            # schema already matches the evolved one (st.schema alone
            # can't tell — _ensure_table stores the target schema)
            st = await self._ensure_table(new)
            desired = self._iceberg_schema(new, st.field_ids,
                                           st.schema_id)["fields"]
            if st.catalog_fields == desired:
                return
        for attempt in range(4):
            # existing columns keep their ids; additions get fresh ones
            ids, last = self._assign_field_ids(new, st.field_ids,
                                               st.last_column_id)
            new_schema_id = st.schema_count
            body = {
                "requirements": [{
                    "type": "assert-ref-snapshot-id", "ref": "main",
                    "snapshot-id": st.snapshot_id,
                }],
                "updates": [
                    {"action": "add-schema",
                     "schema": self._iceberg_schema(new, ids,
                                                    new_schema_id)},
                    {"action": "set-current-schema",
                     "schema-id": new_schema_id},
                ],
            }
            try:
                await self._api(
                    "POST",
                    f"/namespaces/{self.config.namespace}/tables/{st.name}",
                    body, conflict_raises=True)
            except (_CasConflict, EtlError) as e:
                # staleness here wears TWO shapes: a 409 when a data
                # commit moved the ref, and a 400 stale-schema-count
                # when a concurrent add-schema registered first (it
                # moves NO ref, so the CAS requirement still passes).
                # Both recover the same way: re-adopt, return if the
                # catalog already matches, else retry with the
                # refreshed count — a genuinely deterministic error
                # just fails again and surfaces on the last attempt.
                await self._adopt_catalog_state(st, new)
                desired = self._iceberg_schema(new, st.field_ids,
                                               st.schema_id)["fields"]
                if st.catalog_fields == desired:
                    st.schema = new  # catalog already caught up
                    return
                if attempt == 3:
                    raise
                await asyncio.sleep(self.retry.delay(attempt))
                continue
            break
        st.schema = new
        st.field_ids, st.last_column_id = ids, last
        st.schema_id = new_schema_id
        st.schema_count += 1
        st.catalog_fields = None

    async def drop_table(self, table_id: TableId,
                         schema: ReplicatedTableSchema | None = None) -> None:
        if table_id not in self._tables and schema is not None:
            # restart recovery: rebuild the name mapping from the hint
            self._tables[table_id] = _TableState(
                name=escaped_table_name(schema.name))
        st = self._tables.get(table_id)
        if st is not None:
            await self._api(
                "DELETE",
                f"/namespaces/{self.config.namespace}/tables/{st.name}")
            self._tables.pop(table_id, None)

    async def truncate_table(self, table_id: TableId) -> None:
        st = self._tables.get(table_id)
        if st is not None:
            # a delete-operation snapshot with an EMPTY manifest list:
            # readers of the new snapshot see zero data files
            await self._commit_snapshot(st, [], operation="delete")

    async def shutdown(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None
