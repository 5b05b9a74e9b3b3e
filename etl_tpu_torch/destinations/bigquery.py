"""BigQuery destination: Storage-Write-style CDC appends.

Reference parity: crates/etl-destinations/src/bigquery/ (6.6k LoC):
  - CDC appends carrying `_CHANGE_TYPE` (UPSERT/DELETE) and
    `_CHANGE_SEQUENCE_NUMBER` = commit_lsn/tx_ordinal/ordinal hex keys
    (core.rs:42-45,980-996) so BigQuery's CDC engine orders at-least-once
    deliveries correctly;
  - per-table batching between Relation/Truncate barriers
    (core.rs:956-978);
  - truncate → versioned successor tables `table`, `table_1`, … with a
    stable view over the latest generation (core.rs:55-106);
  - appends speak the REAL Storage Write wire format (bq_proto): an
    AppendRowsRequest proto carrying a self-describing DescriptorProto
    and per-row serialized proto messages, posted as
    `application/x-protobuf` against the table's `_default` stream —
    gRPC framing is the only transport difference from the reference
    (no gRPC stack in this environment; payload bytes are identical);
  - bounded LOCAL retry of Storage Write schema-propagation and
    NOT-FOUND-while-table-exists errors with exponential equal-jitter
    backoff (client.rs:58-68,551-650,1224-1285), on top of the transport
    retry policy for HTTP-level transient failures;
  - background TaskSet with the ack resolving to Durable when the append
    lands (core.rs:1371-1388) — `write_events` returns an *Accepted* ack
    immediately, letting the apply loop build the next batch while the
    upload is in flight.

Table/dataset DDL stays on the REST v2 JSON surface, which is what the
reference's client library uses for DDL as well.

Copy of the reference's `etl_tpu/destinations/bigquery.py`. Two
departures: a failed columnar encode (`bq_proto.encode_batch`, which takes
the device-rendered DATE text) fails the write with a typed EtlError
before anything is appended (`util.fast_render_error`); and concurrent
writes to a new table (the copy's partitions) create it once, where the
reference's each POST theirs.
"""

from __future__ import annotations

import asyncio
import base64
import datetime as dt
import json
from dataclasses import dataclass
from typing import Any, Sequence


from ..models.cell import (JSON_NULL, PgInterval, PgNumeric, PgSpecialDate,
                           PgSpecialTimestamp, PgTimeTz, TOAST_UNCHANGED)
from ..models.errors import ErrorKind, EtlError
from ..models.event import (ChangeType, DecodedBatchEvent, DeleteEvent,
                            Event, SchemaChangeEvent)
from ..models.pgtypes import CellKind
from ..models.schema import (ReplicatedTableSchema, SchemaDiff, TableId)
from ..models.table_row import ColumnarBatch, TableRow
from ..models.default_expression import column_default_sql
from ..analysis.annotations import transactional_commit
from . import bq_proto
from .base import CommitRange, Destination, WriteAck, expand_batch_events
from .util import (DestinationRetryPolicy, TaskSet, change_type_label,
                   classify_http_error, count_egress_write,
                   escaped_table_name, fast_render_error,
                   require_full_batch, require_full_row,
                   sequential_event_program, versioned_table_name,
                   with_retries)


@dataclass(frozen=True)
class BigQueryConfig:
    project_id: str
    dataset_id: str
    base_url: str  # endpoint root (emulator/fake in tests)
    auth_token: str = ""
    max_concurrent_appends: int = 4
    # Storage Write local-retry window (reference client.rs:58-70: schema
    # updates propagate to append streams "on the order of minutes")
    storage_write_retry_timeout_s: float = 600.0
    storage_write_retry_delay_s: float = 1.0
    storage_write_max_retry_delay_s: float = 30.0


_BQ_TYPES: dict[CellKind, str] = {
    CellKind.BOOL: "BOOL",
    CellKind.I16: "INT64", CellKind.I32: "INT64", CellKind.U32: "INT64",
    CellKind.I64: "INT64",
    CellKind.F32: "FLOAT64", CellKind.F64: "FLOAT64",
    CellKind.NUMERIC: "BIGNUMERIC",
    CellKind.DATE: "DATE", CellKind.TIME: "TIME",
    CellKind.TIMETZ: "STRING",
    CellKind.TIMESTAMP: "DATETIME", CellKind.TIMESTAMPTZ: "TIMESTAMP",
    CellKind.UUID: "STRING", CellKind.JSON: "JSON",
    CellKind.BYTES: "BYTES", CellKind.STRING: "STRING",
    CellKind.ARRAY: "JSON", CellKind.INTERVAL: "STRING",
}


def bq_field(col, identity: set[str]) -> dict:
    # non-identity columns stay NULLABLE so key-only DELETE rows append
    required = not col.nullable and col.name in identity
    out = {"name": col.name, "type": _BQ_TYPES.get(col.kind, "STRING"),
           "mode": "REQUIRED" if required else "NULLABLE"}
    # portable literal defaults (reference default_expression.rs →
    # bigquery/schema.rs:28-36); unsupported source defaults are omitted
    default = column_default_sql(col, "bigquery")
    if default is not None:
        out["defaultValueExpression"] = default
    return out


def encode_value(v: Any, kind: CellKind) -> Any:
    """Python value → BigQuery JSON value (reference bigquery/encoding.rs)."""
    if v is None or v is TOAST_UNCHANGED:
        return None
    if v is JSON_NULL:
        return "null"
    if isinstance(v, PgNumeric):
        return v.pg_text()
    if isinstance(v, (PgTimeTz, PgInterval, PgSpecialDate,
                      PgSpecialTimestamp)):
        return v.pg_text()
    if isinstance(v, dt.datetime):
        if v.tzinfo is not None:
            return v.isoformat()
        return v.isoformat(sep=" ")
    if isinstance(v, (dt.date, dt.time)):
        return v.isoformat()
    if isinstance(v, bytes):
        return base64.b64encode(v).decode()
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    if kind is CellKind.UUID:
        return str(v)
    if isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


class BigQueryDestination(Destination):
    egress_encoder = "tsv"  # device text feeds string-typed proto cells

    def __init__(self, config: BigQueryConfig,
                 retry: DestinationRetryPolicy | None = None):
        self.config = config
        self.retry = retry or DestinationRetryPolicy()
        self._session: aiohttp.ClientSession | None = None
        self._tasks = TaskSet()
        self._generations: dict[TableId, int] = {}
        self._created: dict[TableId, ReplicatedTableSchema] = {}
        self._ddl_locks: dict[TableId, asyncio.Lock] = {}
        self._names: dict[TableId, str] = {}
        self._append_sem: asyncio.Semaphore | None = None
        self._marker_ready = False
        self._marker_lock = asyncio.Lock()

    # -- REST transport ----------------------------------------------------------

    async def _api(self, method: str, path: str,
                   body: dict | None = None) -> dict:
        import aiohttp  # where a request is made: the encoders need none

        if self._session is None:
            self._session = aiohttp.ClientSession()
        headers = {}
        if self.config.auth_token:
            headers["Authorization"] = f"Bearer {self.config.auth_token}"

        async def attempt() -> dict:
            async with self._session.request(
                    method, f"{self.config.base_url}{path}",
                    json=body, headers=headers) as resp:
                text = await resp.text()
                if resp.status == 409:  # duplicate → idempotent success
                    return {"alreadyExists": True}
                if resp.status >= 400:
                    # shared status→kind map (util.classify_http_error):
                    # permanent 4xx become the poison-trigger kinds
                    raise classify_http_error(
                        "bigquery", resp.status, f"{path}: {text[:300]}")
                return json.loads(text) if text else {}

        def retryable(e: BaseException) -> bool:
            if isinstance(e, EtlError):
                return e.kind is ErrorKind.DESTINATION_THROTTLED
            return isinstance(e, (aiohttp.ClientError, OSError))

        return await with_retries(attempt, self.retry, retryable)

    def _dataset_path(self) -> str:
        return (f"/projects/{self.config.project_id}/datasets/"
                f"{self.config.dataset_id}")

    # -- lifecycle ---------------------------------------------------------------

    async def startup(self) -> None:
        self._append_sem = asyncio.Semaphore(
            self.config.max_concurrent_appends)
        await self._api("POST", f"/projects/{self.config.project_id}/datasets",
                        {"datasetReference":
                         {"datasetId": self.config.dataset_id}})

    def _base_name(self, schema: ReplicatedTableSchema) -> str:
        return self._names.setdefault(schema.id,
                                      escaped_table_name(schema.name))

    def _current_table(self, schema: ReplicatedTableSchema) -> str:
        gen = self._generations.get(schema.id, 0)
        return versioned_table_name(self._base_name(schema), gen)

    async def _ensure_table(self, schema: ReplicatedTableSchema) -> str:
        table = self._current_table(schema)
        known = self._created.get(schema.id)
        if known == schema:
            return table
        # one DDL round a table: concurrent copy partitions wait for the
        # first instead of each issuing its own (as the reference does)
        async with self._ddl_locks.setdefault(schema.id, asyncio.Lock()):
            table = self._current_table(schema)
            if self._created.get(schema.id) == schema:
                return table
            key_cols = [c.name for c in schema.identity_columns()]
            fields = [bq_field(c, set(key_cols))
                      for c in schema.replicated_columns]
            await self._api("POST", f"{self._dataset_path()}/tables", {
                "tableReference": {"tableId": table},
                "schema": {"fields": fields},
                "clustering": {"fields": key_cols[:4]} if key_cols else None,
                # storage-write CDC: primary keys drive UPSERT semantics
                "tableConstraints": {"primaryKey": {"columns": key_cols}}
                if key_cols else None,
            })
            self._created[schema.id] = schema
        return table

    # -- writes ------------------------------------------------------------------

    async def write_table_rows(self, schema: ReplicatedTableSchema,
                               batch: ColumnarBatch) -> WriteAck:
        table = await self._ensure_table(schema)
        rows = self._rows_from_batch(schema, batch, None)
        ack, fut = WriteAck.accepted()
        self._tasks.spawn(self._append_and_resolve(table, schema, rows, fut))
        return ack

    async def write_events(self, events: Sequence[Event]) -> WriteAck:
        """Build the ordered program (row runs split at truncate/DDL
        barriers), then execute it IN ORDER in one background task; the
        Accepted ack resolves when the whole program lands."""
        program = list(sequential_event_program(expand_batch_events(events)))
        if not program:
            return WriteAck.durable()
        # resolve table names up front (current generation at build time is
        # wrong for post-truncate runs — the executor re-resolves)
        ack, fut = WriteAck.accepted()

        async def execute() -> None:
            try:
                ordinal = 0
                for op in program:
                    if op[0] == "rows":
                        _, schema, evs = op
                        table = await self._ensure_table(schema)
                        rows = []
                        for e in evs:
                            if isinstance(e, DeleteEvent):
                                rows.append(self._row_tuple(
                                    schema, e.old_row, ChangeType.DELETE,
                                    e.sequence_key.with_ordinal(ordinal)))
                            else:
                                rows.append(self._row_tuple(
                                    schema, e.row, ChangeType.INSERT,
                                    e.sequence_key.with_ordinal(ordinal)))
                            ordinal += 1
                        await self._append_rows(table, schema, rows)
                    elif op[0] == "truncate":
                        for sch in op[1].schemas:
                            await self.truncate_table(sch.id)
                    else:
                        await self._apply_schema_change(op[1])
                if not fut.done():
                    fut.set_result(None)
            except BaseException as e:  # etl-lint: ignore[cancellation-swallow] — transferred to the ack future, not dropped
                if not fut.done():
                    fut.set_exception(e)

        self._tasks.spawn(execute())
        return ack

    # -- columnar seam --------------------------------------------------------

    async def write_table_batch(self, schema: ReplicatedTableSchema,
                                batch: ColumnarBatch) -> WriteAck:
        """Copy path, columnar: proto rows serialized column-at-a-time
        (bq_proto.encode_batch), byte-identical to the row path."""
        import numpy as np

        from .util import sequence_number_batch

        table = await self._ensure_table(schema)
        require_full_batch("bigquery", schema, batch)
        n = batch.num_rows
        zeros = np.zeros(n, dtype=np.uint64)
        seqs = sequence_number_batch(zeros, zeros,
                                     np.arange(n, dtype=np.uint64))
        egress = getattr(batch, "device_egress", None)
        try:
            encoded = bq_proto.encode_batch(schema, batch, [b"UPSERT"] * n,
                                            seqs, egress=egress)
        except EtlError:
            raise
        except Exception as e:  # no host re-render: fail, append nothing
            raise fast_render_error("bigquery", e) from e
        count_egress_write(egress is not None)
        ack, fut = WriteAck.accepted()
        self._tasks.spawn(self._append_encoded_and_resolve(
            table, schema, encoded, fut))
        return ack

    async def write_event_batches(self, events: Sequence[Event]) -> WriteAck:
        """CDC path, columnar: the ordered program executes in one
        background task like write_events, but simple decoded batch runs
        encode column-at-a-time; the global ordinal keeps
        `_CHANGE_SEQUENCE_NUMBER` identical to the expanded row path."""
        import numpy as np

        from .base import sequential_batch_program
        from .util import change_type_batch, sequence_number_batch

        program = list(sequential_batch_program(events))
        if not program:
            return WriteAck.durable()
        ack, fut = WriteAck.accepted()

        async def execute() -> None:
            try:
                ordinal = 0
                for op in program:
                    if op[0] == "batch":
                        _, schema, cb = op
                        table = await self._ensure_table(schema)
                        require_full_batch("bigquery", schema, cb.batch,
                                           cb.change_types)
                        n = cb.num_rows
                        seqs = sequence_number_batch(
                            cb.commit_lsns, cb.tx_ordinals,
                            np.arange(ordinal, ordinal + n, dtype=np.uint64))
                        labels = change_type_batch(cb.change_types).tolist()
                        ordinal += n
                        try:
                            encoded = bq_proto.encode_batch(
                                schema, cb.batch, labels, seqs,
                                egress=cb.egress)
                        except EtlError:
                            raise
                        except Exception as e:  # no host re-render
                            raise fast_render_error("bigquery", e) from e
                        count_egress_write(cb.egress is not None)
                        await self._append_encoded(table, schema, encoded)
                    elif op[0] == "rows":
                        _, schema, evs = op
                        table = await self._ensure_table(schema)
                        rows = []
                        for e in evs:
                            if isinstance(e, DeleteEvent):
                                rows.append(self._row_tuple(
                                    schema, e.old_row, ChangeType.DELETE,
                                    e.sequence_key.with_ordinal(ordinal)))
                            else:
                                rows.append(self._row_tuple(
                                    schema, e.row, ChangeType.INSERT,
                                    e.sequence_key.with_ordinal(ordinal)))
                            ordinal += 1
                        await self._append_rows(table, schema, rows)
                    elif op[0] == "truncate":
                        for sch in op[1].schemas:
                            await self.truncate_table(sch.id)
                    else:
                        await self._apply_schema_change(op[1])
                if not fut.done():
                    fut.set_result(None)
            except BaseException as e:  # etl-lint: ignore[cancellation-swallow] — transferred to the ack future, not dropped
                if not fut.done():
                    fut.set_exception(e)

        self._tasks.spawn(execute())
        return ack

    # -- transactional seam (docs/destinations.md exactly-once contract) ------
    #
    # BigQuery's CDC tables already MERGE on `_CHANGE_SEQUENCE_NUMBER`
    # (commit_lsn/tx_ordinal/ordinal), so a re-streamed duplicate row
    # collapses at query time; what the seam ADDS is the recoverable
    # coordinate record: a `_etl_commit_marker` table whose description
    # metadata holds the acked high-water JSON, PATCHed only after the
    # flush's storage-write appends are durable. Recovery reads it back
    # through the same REST surface.

    _COMMIT_MARKER = "_etl_commit_marker"
    _MAX_REPLAY_TOKENS = 256

    def supports_transactional_commit(self) -> bool:
        return True

    def _marker_path(self) -> str:
        return f"{self._dataset_path()}/tables/{self._COMMIT_MARKER}"

    async def _ensure_marker(self) -> None:
        if self._marker_ready:
            return
        await self._api("POST", f"{self._dataset_path()}/tables", {
            "tableReference": {"tableId": self._COMMIT_MARKER},
            "schema": {"fields": [{"name": "unused", "type": "STRING"}]},
        })  # 409 → alreadyExists: idempotent
        self._marker_ready = True

    async def _marker_state(self) -> dict:
        doc = await self._api("GET", self._marker_path())
        desc = doc.get("description") or ""
        try:
            state = json.loads(desc)
        except ValueError:
            state = {}
        return state if isinstance(state, dict) else {}

    async def _advance_marker(self, commit: CommitRange) -> None:
        """Read-modify-write under the marker lock: concurrent in-flight
        flushes finalize out of order, and the recorded high-water must
        stay monotone regardless."""
        async with self._marker_lock:
            state = await self._marker_state()
            if commit.replay:
                tokens = list(state.get("replay_tokens", []))
                if commit.token() not in tokens:
                    tokens.append(commit.token())
                state["replay_tokens"] = tokens[-self._MAX_REPLAY_TOKENS:]
            else:
                cur = state.get("high")
                high = list(commit.high)
                if cur is None or high > list(cur):
                    state["high"] = high
                    if commit.commit_end_lsn:
                        state["commit_end_lsn"] = commit.commit_end_lsn
            await self._api("PATCH", self._marker_path(),
                            {"description": json.dumps(state,
                                                       sort_keys=True)})

    async def _finalize_commit(self, inner: "WriteAck | None",
                               commit: CommitRange,
                               fut: asyncio.Future) -> None:
        try:
            if inner is not None:
                await inner.wait_durable()
            await self._advance_marker(commit)
            if not fut.done():
                fut.set_result(None)
        except BaseException as e:  # etl-lint: ignore[cancellation-swallow] — transferred to the ack future, not dropped
            if not fut.done():
                fut.set_exception(e)

    @transactional_commit
    async def write_event_batches_committed(
            self, events: Sequence[Event], commit: CommitRange) -> WriteAck:
        """Committed CDC write: the data program ships first (storage-
        write appends, MERGE-keyed), then the WAL range PATCHes the
        marker — the outer ack only resolves durable once BOTH landed.
        A crash between them re-streams a flush the sequence-number
        MERGE absorbs."""
        await self._ensure_marker()
        if commit.replay:
            state = await self._marker_state()
            if commit.token() in state.get("replay_tokens", []):
                return WriteAck.durable()
        inner = await self.write_event_batches(events)
        # plain ack, not accepted(): the inner write already fired the
        # DESTINATION_WRITE chaos site for this flush
        fut = asyncio.get_event_loop().create_future()
        self._tasks.spawn(self._finalize_commit(inner, commit, fut))
        return WriteAck(fut)

    async def recover_high_water(self) -> "CommitRange | None":
        await self._ensure_marker()
        state = await self._marker_state()
        high = state.get("high")
        if not high:
            return None
        return CommitRange(high=(int(high[0]), int(high[1])),
                           commit_end_lsn=state.get("commit_end_lsn"))

    async def _append_encoded_and_resolve(self, table: str,
                                          schema: ReplicatedTableSchema,
                                          encoded: list[bytes],
                                          fut: asyncio.Future) -> None:
        try:
            await self._append_encoded(table, schema, encoded)
            if not fut.done():
                fut.set_result(None)
        except BaseException as e:  # etl-lint: ignore[cancellation-swallow] — transferred to the ack future, not dropped
            if not fut.done():
                fut.set_exception(e)

    async def _append_and_resolve(self, table: str,
                                  schema: ReplicatedTableSchema,
                                  rows: list[tuple],
                                  fut: asyncio.Future) -> None:
        try:
            await self._append_rows(table, schema, rows)
            if not fut.done():
                fut.set_result(None)
        except BaseException as e:  # etl-lint: ignore[cancellation-swallow] — transferred to the ack future, not dropped
            if not fut.done():
                fut.set_exception(e)

    def _write_stream(self, table: str) -> str:
        return (f"projects/{self.config.project_id}/datasets/"
                f"{self.config.dataset_id}/tables/{table}/streams/_default")

    async def _post_append_proto(self, table: str, body: bytes) -> bytes:
        """POST the serialized AppendRowsRequest; transport-level transient
        failures retry under the destination policy (the gRPC library's
        internal retries in the reference); Storage Write STATUS errors come
        back inside the response proto and are classified by the caller."""
        import aiohttp  # where a request is made: the encoders need none

        if self._session is None:
            self._session = aiohttp.ClientSession()
        headers = {"Content-Type": "application/x-protobuf"}
        if self.config.auth_token:
            headers["Authorization"] = f"Bearer {self.config.auth_token}"
        path = (f"{self._dataset_path()}/tables/{table}"
                "/streams/_default:appendRows")

        async def attempt() -> bytes:
            async with self._session.post(
                    f"{self.config.base_url}{path}", data=body,
                    headers=headers) as resp:
                payload = await resp.read()
                if resp.status >= 400:
                    raise classify_http_error(
                        "bigquery", resp.status,
                        f"{path}: {payload[:200]!r}")
                return payload

        def retryable(e: BaseException) -> bool:
            if isinstance(e, EtlError):
                return e.kind is ErrorKind.DESTINATION_THROTTLED
            return isinstance(e, (aiohttp.ClientError, OSError))

        return await with_retries(attempt, self.retry, retryable)

    async def _table_exists(self, table: str) -> bool:
        """GET the table resource (the probe behind NOT_FOUND retry
        classification, client.rs:600-615). Transient probe failures retry
        under the destination policy — a flaky probe must not demote a
        retryable NOT_FOUND into a permanent failure."""
        import aiohttp  # where a request is made: the encoders need none

        if self._session is None:
            self._session = aiohttp.ClientSession()
        headers = {}
        if self.config.auth_token:
            headers["Authorization"] = f"Bearer {self.config.auth_token}"

        async def attempt() -> bool:
            async with self._session.get(
                    f"{self.config.base_url}{self._dataset_path()}"
                    f"/tables/{table}", headers=headers) as resp:
                await resp.read()
                if resp.status == 200:
                    return True
                if resp.status == 404:
                    return False
                raise classify_http_error(
                    "bigquery", resp.status, f"table probe for {table}")

        def retryable(e: BaseException) -> bool:
            if isinstance(e, EtlError):
                return e.kind is ErrorKind.DESTINATION_THROTTLED
            return isinstance(e, (aiohttp.ClientError, OSError))

        return await with_retries(attempt, self.retry, retryable)

    def _retryable_storage_write_detail(self, status) -> str | None:
        """Schema-propagation classification (client.rs:557-579): structured
        SCHEMA_MISMATCH_EXTRA_FIELDS in the status details, or the
        documented message forms when no structured code is present."""
        if status.code != bq_proto.GRPC_INVALID_ARGUMENT:
            return None
        if bq_proto.STORAGE_ERROR_SCHEMA_MISMATCH_EXTRA_FIELDS \
                in status.storage_error_codes:
            return status.message or "schema mismatch (structured)"
        msg = status.message.lower()
        if ("missing in the proto message" in msg
                or "extra proto fields" in msg
                or "schema_mismatch_extra_field" in msg):
            return status.message
        return None

    async def _append_rows(self, table: str,
                           schema: ReplicatedTableSchema,
                           rows: list[tuple]) -> None:
        """Proto-encode and append, absorbing locally retryable Storage
        Write errors (schema propagation; NOT_FOUND while the table exists)
        within a bounded window — exponential backoff with equal jitter
        (client.rs:197-216,1224-1285). Row-level errors are permanent."""
        encoded = [bq_proto.encode_row(schema, values, ct, seq)
                   for values, ct, seq in rows]
        await self._append_encoded(table, schema, encoded)

    async def _append_encoded(self, table: str,
                              schema: ReplicatedTableSchema,
                              encoded: list[bytes]) -> None:
        """Append pre-serialized proto rows (the columnar encoder's output
        or encode_row's) under the bounded Storage Write retry loop."""
        import random
        import time as _time

        assert self._append_sem is not None
        cfg = self.config
        descriptor = bq_proto.row_descriptor(schema)
        stream = self._write_stream(table)
        started = _time.monotonic()
        delay = cfg.storage_write_retry_delay_s
        attempt = 0
        while True:
            attempt += 1
            trace = (f"etl_tpu_{table}_{attempt}_"
                     f"{random.randrange(2**32)}")
            body = bq_proto.append_rows_request(
                stream, descriptor, encoded, trace)
            # concurrency slot held only for the POST itself — a
            # propagation backoff (minutes) must not starve other tables'
            # appends of their slots
            async with self._append_sem:
                payload = await self._post_append_proto(table, body)
            resp = bq_proto.decode_append_rows_response(payload)
            if resp.row_errors:
                # permanent: bad data / schema mismatch per row
                # (client.rs:222-244); row values are NOT echoed.
                # DESTINATION_REJECTED — the per-row refusal is THE
                # poison-pill trigger (docs/dead-letter.md): the
                # isolation protocol bisects the batch to the rejected
                # row(s) instead of blind-retrying the same bytes
                first = resp.row_errors[0]
                raise EtlError(
                    ErrorKind.DESTINATION_REJECTED,
                    f"bigquery rejected {len(resp.row_errors)} row(s); "
                    f"first: row {first.index} code {first.code}")
            status = resp.error
            if status is None or status.code == bq_proto.GRPC_OK:
                return
            detail = self._retryable_storage_write_detail(status)
            if detail is None \
                    and status.code == bq_proto.GRPC_NOT_FOUND \
                    and await self._table_exists(table):
                # stale default-stream routing after delete/recreate
                detail = status.message or "storage write NOT_FOUND"
            if detail is None:
                raise self._status_to_error(status)
            elapsed = _time.monotonic() - started
            remaining = cfg.storage_write_retry_timeout_s - elapsed
            if remaining <= 0:
                raise EtlError(
                    ErrorKind.DESTINATION_THROTTLED,
                    "bigquery storage write retry timed out after "
                    f"{cfg.storage_write_retry_timeout_s:.0f}s: {detail}")
            # equal jitter: [delay/2, delay], capped by the window
            sleep_s = min(delay / 2 + random.random() * (delay / 2),
                          remaining)
            await asyncio.sleep(sleep_s)
            delay = min(delay * 2, cfg.storage_write_max_retry_delay_s)

    @staticmethod
    def _status_to_error(status) -> EtlError:
        """gRPC code → error kind (client.rs:416-470): transient server
        conditions map to the retryable kind so the worker-level timed
        retry policy takes over; precondition/auth failures are final."""
        transient = {bq_proto.GRPC_UNAVAILABLE, bq_proto.GRPC_INTERNAL,
                     bq_proto.GRPC_ABORTED, bq_proto.GRPC_CANCELLED,
                     bq_proto.GRPC_DEADLINE_EXCEEDED,
                     bq_proto.GRPC_RESOURCE_EXHAUSTED}
        if status.code in transient:
            kind = ErrorKind.DESTINATION_THROTTLED
        elif status.code in (bq_proto.GRPC_PERMISSION_DENIED,):
            kind = ErrorKind.DESTINATION_AUTH_FAILED
        elif status.code == bq_proto.GRPC_NOT_FOUND:
            kind = ErrorKind.DESTINATION_SCHEMA_FAILED
        elif status.code in (bq_proto.GRPC_INVALID_ARGUMENT,
                             bq_proto.GRPC_FAILED_PRECONDITION):
            # the payload was refused — permanent for these bytes, the
            # poison-isolation trigger kind (docs/dead-letter.md)
            kind = ErrorKind.DESTINATION_REJECTED
        else:
            kind = ErrorKind.DESTINATION_FAILED
        return EtlError(kind, f"bigquery storage write error "
                              f"(grpc code {status.code}): {status.message}")

    def _row_tuple(self, schema: ReplicatedTableSchema, row: TableRow,
                   ct: ChangeType, seq: str) -> tuple:
        if ct is not ChangeType.DELETE:
            require_full_row("bigquery", schema, row)
        return (list(row.values), change_type_label(ct), seq)

    def _rows_from_batch(self, schema: ReplicatedTableSchema,
                         batch: ColumnarBatch,
                         ev: DecodedBatchEvent | None) -> list[tuple]:
        require_full_batch("bigquery", schema, batch,
                           ev.change_types if ev is not None else None)
        out = []
        for i in range(batch.num_rows):
            values = [c.value(i) for c in batch.columns]
            if ev is not None:
                ct = change_type_label(ChangeType(int(ev.change_types[i])))
                seq = (f"{int(ev.commit_lsns[i]):016x}/"
                       f"{int(ev.tx_ordinals[i]):016x}/{i:016x}")
            else:
                ct = "UPSERT"
                seq = f"{0:016x}/{0:016x}/{i:016x}"
            out.append((values, ct, seq))
        return out

    async def _apply_schema_change(self, ev: SchemaChangeEvent) -> None:
        old = self._created.get(ev.table_id)
        new = ev.new_schema
        assert new is not None
        if old is None or SchemaDiff.between(old.table_schema,
                                             new.table_schema).is_empty():
            self._created[ev.table_id] = new
            return
        table = self._current_table(new)
        keys = {c.name for c in new.identity_columns()}
        fields = [bq_field(c, keys) for c in new.replicated_columns]
        await self._api("PATCH", f"{self._dataset_path()}/tables/{table}",
                        {"schema": {"fields": fields}})
        self._created[ev.table_id] = new

    # -- truncate / drop ----------------------------------------------------------

    async def truncate_table(self, table_id: TableId) -> None:
        """Versioned successor table (core.rs:55-106): bump the generation,
        create `base_N`, repoint the stable view."""
        schema = self._created.get(table_id)
        if schema is None:
            return
        self._generations[table_id] = self._generations.get(table_id, 0) + 1
        self._created.pop(table_id, None)  # force re-create at new gen
        table = await self._ensure_table(schema)
        base = self._base_name(schema)
        await self._api("POST", f"{self._dataset_path()}/views", {
            "viewId": f"{base}_view",
            "query": f"SELECT * FROM `{self.config.dataset_id}.{table}`"})

    async def drop_table(self, table_id: TableId,
                         schema: ReplicatedTableSchema | None = None) -> None:
        if table_id not in self._names and schema is not None:
            self._base_name(schema)  # restart recovery: rebuild the mapping
        name = self._names.get(table_id)
        if name is None:
            return
        gen = self._generations.get(table_id, 0)
        table = versioned_table_name(name, gen)
        await self._api("DELETE", f"{self._dataset_path()}/tables/{table}")
        self._created.pop(table_id, None)

    async def shutdown(self) -> None:
        await self._tasks.join()
        if self._session is not None:
            await self._session.close()
            self._session = None
