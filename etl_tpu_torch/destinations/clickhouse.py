"""ClickHouse destination: HTTP inserts into ReplacingMergeTree CDC tables.

Reference parity: crates/etl-destinations/src/clickhouse/ — per-table CDC
tables keyed by `_CHANGE_SEQUENCE_NUMBER` with a ReplacingMergeTree-family
engine selectable via config (core.rs:19 ClickHouseEngine), `_current`
views collapsing to live rows (schema.rs create_current_view_sql), DDL for
schema diffs, HTTP-interface inserts (RowBinary in the reference; TSV here
— both stream row batches over one POST).

Copy of the reference's `etl_tpu/destinations/clickhouse.py`: the
destination (its HTTP client, DDL, the `_etl_commit_log` transactional
seam with `recover_high_water`, truncate and drop), `render_value` (one
TSV field),
`_column_texts` and `render_batch_tsv_columnar` (column-at-a-time render
and one join per row: the oracle), and `_column_piece_tsv` and
`render_batch_tsv_fast` (byte pieces — device-rendered text where a
`DeviceEgress` rode the batch, numpy host twins otherwise — scattered
into one body by `ops/egress.assemble_rows`), byte-identical to the
oracle. Text columns are read from the port's `TextArray` buffers, so
nothing here needs pyarrow.

Two departures: the reference's writes swallow a failed fast render and
re-render host-side; here the write fails with a typed EtlError and
nothing is posted (`util.fast_render_error`). A batch without device
text still renders host-side, by routing, inside `render_batch_tsv_fast`.
And concurrent writes to a new table (the copy's partitions) issue its
DDL once, where the reference's each issue theirs.
"""

from __future__ import annotations

import asyncio
import datetime as dt
import enum
import json
from dataclasses import dataclass
from typing import Sequence
from urllib.parse import urlencode

import numpy as np

from ..analysis.annotations import hot_loop, transactional_commit
from ..models.cell import (JSON_NULL, PgInterval, PgNumeric, PgSpecialDate,
                           PgSpecialTimestamp, PgTimeTz, TOAST_UNCHANGED)
from ..models.default_expression import column_default_sql
from ..models.errors import EtlError
from ..models.event import (ChangeType, DecodedBatchEvent, DeleteEvent,
                            Event, SchemaChangeEvent, UpdateEvent)
from ..models.pgtypes import CellKind
from ..models.schema import (ReplicatedTableSchema, SchemaDiff, TableId)
from ..models.table_row import ColumnarBatch
# dense timestamp/date sentinels/bounds — the SAME objects _from_dense
# decodes with, so detection can never drift from Column.value()
from ..models.table_row import (DATE_INFINITY_DAYS as _DATE_INF,
                                DATE_NEG_INFINITY_DAYS as _DATE_NEG_INF,
                                MAX_DATE_DAYS as _MAX_DATE_DAYS,
                                MAX_TS_US as _MAX_TS_US,
                                MIN_DATE_DAYS as _MIN_DATE_DAYS,
                                MIN_TS_US as _MIN_TS_US,
                                TS_INFINITY_US as _TS_INF,
                                TS_NEG_INFINITY_US as _TS_NEG_INF)
from .base import CommitRange, Destination, WriteAck, expand_batch_events
from .util import (CDC_DELETE, CDC_UPSERT, CHANGE_SEQUENCE_COLUMN,
                   CHANGE_TYPE_COLUMN, DestinationRetryPolicy,
                   change_type_label, classify_http_error, count_egress_write,
                   escaped_table_name, fast_render_error, require_full_batch,
                   require_full_row, sequential_event_program, with_retries)

class ClickHouseEngine(enum.Enum):
    REPLACING_MERGE_TREE = "ReplacingMergeTree"
    REPLICATED_REPLACING_MERGE_TREE = "ReplicatedReplacingMergeTree"


@dataclass(frozen=True)
class ClickHouseConfig:
    url: str  # http endpoint, e.g. http://localhost:8123
    database: str = "default"
    username: str = "default"
    password: str = ""
    engine: ClickHouseEngine = ClickHouseEngine.REPLACING_MERGE_TREE
    create_current_views: bool = True


_CH_TYPES: dict[CellKind, str] = {
    CellKind.BOOL: "Bool",
    CellKind.I16: "Int16",
    CellKind.I32: "Int32",
    CellKind.U32: "UInt32",
    CellKind.I64: "Int64",
    CellKind.F32: "Float32",
    CellKind.F64: "Float64",
    CellKind.NUMERIC: "String",  # exact text (Arrow stance, table_row.py)
    CellKind.DATE: "Date32",
    CellKind.TIME: "String",
    CellKind.TIMETZ: "String",
    CellKind.TIMESTAMP: "DateTime64(6)",
    CellKind.TIMESTAMPTZ: "DateTime64(6, 'UTC')",
    CellKind.UUID: "UUID",
    CellKind.JSON: "String",
    CellKind.BYTES: "String",
    CellKind.STRING: "String",
    CellKind.ARRAY: "String",
    CellKind.INTERVAL: "String",
}


def clickhouse_type(kind: CellKind, nullable: bool) -> str:
    base = _CH_TYPES.get(kind, "String")
    return f"Nullable({base})" if nullable else base


def create_table_sql(database: str, table: str,
                     schema: ReplicatedTableSchema,
                     engine: ClickHouseEngine) -> str:
    cols = []
    identity = {c.name for c in schema.identity_columns()}
    for c in schema.replicated_columns:
        # CDC tables must accept key-only DELETE rows: every non-identity
        # column is nullable at the destination regardless of source schema
        nullable = c.nullable or c.name not in identity
        spec = f"`{c.name}` {clickhouse_type(c.kind, nullable)}"
        default = column_default_sql(c, "clickhouse")
        if default is not None:
            spec += f" DEFAULT {default}"
        cols.append(spec)
    cols.append(f"`{CHANGE_TYPE_COLUMN}` String")
    cols.append(f"`{CHANGE_SEQUENCE_COLUMN}` String")
    pk = [c.name for c in schema.identity_columns()] or \
        [c.name for c in schema.replicated_columns]
    order = ", ".join(f"`{c}`" for c in pk)
    return (f"CREATE TABLE IF NOT EXISTS `{database}`.`{table}` "
            f"({', '.join(cols)}) ENGINE = {engine.value}"
            f"(`{CHANGE_SEQUENCE_COLUMN}`) ORDER BY ({order})")


def create_current_view_sql(database: str, table: str,
                            schema: ReplicatedTableSchema) -> str:
    """Live-rows view over the CDC table (reference
    clickhouse/schema.rs create_current_view_sql)."""
    cols = ", ".join(f"`{c.name}`" for c in schema.replicated_columns)
    return (f"CREATE OR REPLACE VIEW `{database}`.`{table}_current` AS "
            f"SELECT {cols} FROM `{database}`.`{table}` FINAL "
            f"WHERE `{CHANGE_TYPE_COLUMN}` != '{CDC_DELETE}'")


def _tsv_escape(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\t", "\\t")
             .replace("\n", "\\n").replace("\r", "\\r"))


def render_value(v, kind: CellKind) -> str:
    r""""One TSV field. ClickHouse TSV uses \N for NULL."""
    if v is None or v is TOAST_UNCHANGED:
        return "\\N"
    if v is JSON_NULL:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, PgNumeric):
        return v.pg_text()
    if isinstance(v, (PgTimeTz, PgInterval, PgSpecialDate,
                      PgSpecialTimestamp)):
        return _tsv_escape(v.pg_text())
    if isinstance(v, dt.datetime):
        # explicit zero-padded year: glibc strftime('%Y') renders year 99
        # as '99', diverging from the columnar bulk renderer
        # (np.datetime_as_string) and from what ClickHouse parses —
        # '0099-…' is the form both sides agree on
        return (f"{v.year:04d}-{v.month:02d}-{v.day:02d} "
                f"{v.hour:02d}:{v.minute:02d}:{v.second:02d}."
                f"{v.microsecond:06d}")
    if isinstance(v, dt.date):
        return v.isoformat()
    if isinstance(v, dt.time):
        return v.isoformat()
    if isinstance(v, bytes):
        return _tsv_escape(v.decode("utf-8", "backslashreplace"))
    if isinstance(v, (dict, list)):
        return _tsv_escape(json.dumps(v))
    return _tsv_escape(str(v))


# -- columnar TSV rendering (egress hot path) ---------------------------------

@hot_loop
def _column_texts(col) -> list:
    """One column's TSV field texts (str per present row, None = NULL →
    `\\N`), rendered column-at-a-time: one kind dispatch per column, dense
    numpy data stringified without boxing into datetime/Decimal objects.
    Byte-identical to `render_value(col.value(i), kind)` per row.
    @hot_loop: per column per CDC flush (etl-lint rule 13)."""
    n = len(col)
    kind = col.schema.kind
    valid = col.validity
    if col.toast_unchanged is not None:
        valid = valid & ~col.toast_unchanged
    out: list = [None] * n
    present = np.flatnonzero(valid)
    if present.size == 0:
        return out
    if col.is_dense and kind is CellKind.BOOL:
        data = col.data
        for i in present.tolist():
            out[i] = "true" if data[i] else "false"
        return out
    if col.is_dense and kind in (CellKind.I16, CellKind.I32, CellKind.U32,
                                 CellKind.I64):
        # decimal text straight from numpy (same digits as str(int))
        texts = col.data.astype("U21")
        for i in present.tolist():
            out[i] = texts[i]
        return out
    if col.is_dense and kind in (CellKind.F32, CellKind.F64):
        data = col.data.tolist()  # Python floats: str() matches row path
        for i in present.tolist():
            out[i] = str(data[i])
        return out
    if col.is_dense and kind in (CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ):
        data = col.data
        sel = data[present]
        ok = ((sel != _TS_INF) & (sel != _TS_NEG_INF)
              & (sel >= _MIN_TS_US) & (sel <= _MAX_TS_US))
        # bulk path: epoch-µs → 'YYYY-MM-DD HH:MM:SS.ffffff' (matches
        # strftime('%Y-%m-%d %H:%M:%S.%f') — both always emit 6 digits)
        texts = np.char.replace(
            np.datetime_as_string(data.astype("M8[us]"), unit="us"),
            "T", " ")
        for i in present.tolist():
            out[i] = texts[i]
        if not ok.all():
            for i in (present[~ok]).tolist():
                out[i] = render_value(col.value(i), kind)  # specials
        return out
    if col.is_dense and kind is CellKind.DATE:
        data = col.data
        sel = data[present]
        ok = ((sel != _DATE_INF) & (sel != _DATE_NEG_INF)
              & (sel >= _MIN_DATE_DAYS) & (sel <= _MAX_DATE_DAYS))
        texts = np.datetime_as_string(data.astype("M8[D]"), unit="D")
        for i in present.tolist():
            out[i] = texts[i]
        if not ok.all():
            for i in (present[~ok]).tolist():
                out[i] = render_value(col.value(i), kind)
        return out
    if col.is_text and kind is CellKind.STRING and col.lazy_text_oid is None:
        vals = col.data.to_pylist()
        for i in present.tolist():
            out[i] = _tsv_escape(vals[i])
        return out
    # generic fallback (NUMERIC/TIME/JSON/bytes/arrays/lazy-text columns):
    # box the value, reuse the row-path renderer
    for i in present.tolist():
        out[i] = render_value(col.value(i), kind)
    return out


@hot_loop
def render_batch_tsv_columnar(schema: ReplicatedTableSchema, batch,
                              change_types, seqs) -> bytes:
    """Whole-batch TSV: column-at-a-time field rendering + one join —
    byte-identical to the per-row `render_value` path. `change_types` /
    `seqs` are per-row strs (or one shared str for the copy path).
    @hot_loop: the ClickHouse egress hot path (etl-lint rule 13)."""
    n = batch.num_rows
    cols = [_column_texts(c) for c in batch.columns]
    if isinstance(change_types, str):
        change_types = [change_types] * n
    lines = []
    for i in range(n):
        fields = [c[i] if c[i] is not None else "\\N" for c in cols]
        fields.append(change_types[i])
        fields.append(seqs[i])
        lines.append("\t".join(fields))
    body = "\n".join(lines)
    return (body + "\n").encode() if lines else b""


_TSV_NULL = b"\\N"
_TSV_ESCAPE_BYTES = (9, 10, 13, 92)  # \t \n \r backslash


def _column_piece_tsv(col, dev, oracle_rows: set):
    """One column's TSV field bytes as an assembly piece (ops/egress.py
    piece protocol). Sources, in order: the device-rendered buffer
    (`dev`), the numpy host twin, a zero-copy text-buffer slice, or the
    per-value renderer. Rows neither source can render verbatim
    (temporal specials, strings needing escapes go per-value inside the
    piece; whole-row cases land in `oracle_rows`). Returns
    (piece, used_device)."""
    from ..ops import egress as eg

    n = len(col)
    kind = col.schema.kind
    valid = col.validity
    if col.toast_unchanged is not None:
        valid = valid & ~col.toast_unchanged
    nulls = np.flatnonzero(~valid)
    fixed_kinds = (CellKind.BOOL, CellKind.I16, CellKind.I32, CellKind.U32,
                   CellKind.I64, CellKind.DATE, CellKind.TIMESTAMP,
                   CellKind.TIMESTAMPTZ)
    if col.is_dense and kind in fixed_kinds:
        data = col.data
        if kind in (CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ):
            specials = valid & ((data == _TS_INF) | (data == _TS_NEG_INF)
                                | (data < _MIN_TS_US) | (data > _MAX_TS_US))
            oracle_rows.update(np.flatnonzero(specials).tolist())
        elif kind is CellKind.DATE:
            specials = valid & ((data == _DATE_INF) | (data == _DATE_NEG_INF)
                                | (data < _MIN_DATE_DAYS)
                                | (data > _MAX_DATE_DAYS))
            oracle_rows.update(np.flatnonzero(specials).tolist())
        if dev is not None:
            buf, lens = eg.patch_rows_fixed(dev[0], dev[1], nulls, _TSV_NULL)
            return eg.fixed_piece(buf, lens), True
        if kind is CellKind.BOOL:
            buf, lens = eg.bool_text_fixed(data)
        elif kind is CellKind.DATE:
            buf, lens = eg.date_text_fixed(data)
        elif kind in (CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ):
            buf, lens = eg.timestamp_text_fixed(data)
        else:
            buf, lens = eg.int_text_fixed(data)
        buf, lens = eg.patch_rows_fixed(buf, lens, nulls, _TSV_NULL)
        return eg.fixed_piece(buf, lens), False
    if col.is_dense and kind in (CellKind.F32, CellKind.F64):
        data = col.data.tolist()  # Python floats: str() matches row path
        items = [_TSV_NULL] * n
        for i in np.flatnonzero(valid).tolist():
            items[i] = str(data[i]).encode()
        return eg.var_from_texts(items), False
    if col.is_text and kind is CellKind.STRING \
            and col.lazy_text_oid is None:
        # the text column's own Arrow-layout buffers (TextArray)
        offs, vals = col.data.offsets, col.data.values
        region = vals[offs[0]:offs[n]]
        clean = True
        for b in _TSV_ESCAPE_BYTES:
            if (region == b).any():
                clean = False
                break
        if clean:
            piece = ("var", vals, offs.astype(np.int64))
            if nulls.size:
                out, starts = eg.assemble_rows(
                    n, [piece], {int(i): _TSV_NULL for i in nulls})
                piece = ("var", out, starts)
            return piece, False
        texts = col.data.to_pylist()
        items = [_TSV_NULL] * n
        for i in np.flatnonzero(valid).tolist():
            items[i] = _tsv_escape(texts[i]).encode()
        return eg.var_from_texts(items), False
    # generic fallback (NUMERIC/TIME/JSON/bytes/arrays/lazy-text): box the
    # value, reuse the row-path renderer — same stance as _column_texts
    items = [_TSV_NULL] * n
    for i in np.flatnonzero(valid).tolist():
        items[i] = render_value(col.value(i), kind).encode()
    return eg.var_from_texts(items), False


@hot_loop
def render_batch_tsv_fast(schema: ReplicatedTableSchema, batch,
                          change_types, seq_buf,
                          egress=None) -> "tuple[bytes, bool]":
    """Vectorized whole-batch TSV assembly: per-column byte pieces
    (device egress buffers when attached, numpy host twins otherwise)
    scattered into one contiguous body — no per-row join, no per-row
    Python except the oracle-spliced rows. Byte-identical to
    `render_batch_tsv_columnar` (the identity is gated, ops/egress.py
    module docstring). `change_types` is a shared str (copy path) or the
    `change_type_batch` S6 array; `seq_buf` the (n, 50) uint8
    `sequence_number_buffer`. Returns (body, used_device_buffers).
    @hot_loop: the ClickHouse egress hot path (etl-lint rule 13)."""
    from ..ops import egress as eg

    n = batch.num_rows
    oracle_rows: set = set()
    if egress is not None and egress.untrusted.size:
        oracle_rows.update(egress.untrusted.tolist())
    tab = eg.const_piece(b"\t")
    pieces = []
    used_device = False
    for j, col in enumerate(batch.columns):
        dev = egress.field(j) if egress is not None else None
        piece, used = _column_piece_tsv(col, dev, oracle_rows)
        used_device |= used
        pieces.append(piece)
        pieces.append(tab)
    if isinstance(change_types, str):
        pieces.append(eg.const_piece(change_types.encode()))
    else:
        ct_buf = np.frombuffer(change_types.tobytes(), dtype=np.uint8) \
            .reshape(n, change_types.dtype.itemsize)
        pieces.append(eg.fixed_piece(
            ct_buf, np.full(n, ct_buf.shape[1], dtype=np.int64)))
    pieces.append(tab)
    pieces.append(eg.fixed_piece(seq_buf, np.full(n, seq_buf.shape[1],
                                                  dtype=np.int64)))
    pieces.append(eg.const_piece(b"\n"))
    override = None
    if oracle_rows:
        override = {}
        for i in sorted(oracle_rows):
            fields = [render_value(c.value(i), c.schema.kind)
                      for c in batch.columns]
            ct = change_types if isinstance(change_types, str) \
                else change_types[i].decode()
            seq = seq_buf[i].tobytes().decode()
            override[i] = ("\t".join(fields + [ct, seq]) + "\n").encode()
    out, _ = eg.assemble_rows(n, pieces, override)
    return out.tobytes(), used_device


class ClickHouseDestination(Destination):
    egress_encoder = "tsv"  # device-rendered TSV fields (ops/egress.py)

    def __init__(self, config: ClickHouseConfig,
                 retry: DestinationRetryPolicy | None = None):
        self.config = config
        self.retry = retry or DestinationRetryPolicy()
        self._session: aiohttp.ClientSession | None = None
        self._created_tables: dict[TableId, ReplicatedTableSchema] = {}
        self._ddl_locks: dict[TableId, asyncio.Lock] = {}
        self._names: dict[TableId, str] = {}
        # exactly-once seam state: `_dedup_token` is attached (suffixed
        # with a per-INSERT ordinal) to every data INSERT issued inside
        # one committed write, so a re-streamed duplicate flush is
        # collapsed by ClickHouse's insert_deduplication_token window
        self._dedup_token: str | None = None
        self._dedup_seq = 0
        self._commit_log_ready = False

    # -- http ------------------------------------------------------------------

    async def _execute(self, sql: str, body: bytes = b"") -> str:
        import aiohttp  # where a request is made: the encoders need none

        if self._session is None:
            self._session = aiohttp.ClientSession()
        params = {"database": self.config.database, "query": sql}
        if self._dedup_token is not None and sql.startswith("INSERT INTO"):
            # one token per INSERT within the committed write: identical
            # token on two inserts into the SAME table would make
            # ClickHouse silently drop the second block, so suffix with
            # the (deterministic) per-call ordinal — a re-streamed
            # duplicate flush replays the same program order and lands
            # on the same tokens
            params["insert_deduplication_token"] = \
                f"{self._dedup_token}/{self._dedup_seq}"
            self._dedup_seq += 1

        async def attempt() -> str:
            async with self._session.post(
                    f"{self.config.url}/?{urlencode(params)}", data=body,
                    auth=aiohttp.BasicAuth(self.config.username,
                                           self.config.password)) as resp:
                text = await resp.text()
                if resp.status != 200:
                    # shared HTTP status → ErrorKind map
                    # (util.classify_http_error): throttle/5xx =
                    # transient, permanent 4xx = the poison-trigger
                    # kinds the isolation protocol bisects on
                    raise classify_http_error("clickhouse", resp.status,
                                              text[:300])
                return text

        return await with_retries(attempt, self.retry)

    # -- Destination ------------------------------------------------------------

    async def startup(self) -> None:
        await self._execute(
            f"CREATE DATABASE IF NOT EXISTS `{self.config.database}`")

    def _table_name(self, schema: ReplicatedTableSchema) -> str:
        return self._names.setdefault(schema.id,
                                      escaped_table_name(schema.name))

    async def _ensure_table(self, schema: ReplicatedTableSchema) -> str:
        name = self._table_name(schema)
        known = self._created_tables.get(schema.id)
        if known is not None and known == schema:
            return name
        # one DDL round a table: concurrent copy partitions wait for the
        # first instead of each issuing its own (as the reference does)
        async with self._ddl_locks.setdefault(schema.id, asyncio.Lock()):
            known = self._created_tables.get(schema.id)
            if known is not None and known == schema:
                return name
            await self._execute(create_table_sql(
                self.config.database, name, schema, self.config.engine))
            if self.config.create_current_views:
                await self._execute(create_current_view_sql(
                    self.config.database, name, schema))
            self._created_tables[schema.id] = schema
        return name

    async def write_table_rows(self, schema: ReplicatedTableSchema,
                               batch: ColumnarBatch) -> WriteAck:
        name = await self._ensure_table(schema)
        body = self._render_batch_tsv(schema, batch, change_type=CDC_UPSERT,
                                      seqs=None)
        cols = [c.name for c in schema.replicated_columns] + \
            [CHANGE_TYPE_COLUMN, CHANGE_SEQUENCE_COLUMN]
        col_list = ", ".join(f"`{c}`" for c in cols)
        await self._execute(
            f"INSERT INTO `{self.config.database}`.`{name}` ({col_list}) "
            f"FORMAT TabSeparated", body)
        return WriteAck.durable()

    async def write_events(self, events: Sequence[Event]) -> WriteAck:
        """Sequential program: row runs flush BEFORE any truncate/DDL
        barrier that follows them in WAL order (reference per-table
        batching between barriers, core.rs:956-978)."""
        for op in sequential_event_program(expand_batch_events(events)):
            if op[0] == "rows":
                _, schema, evs = op
                await self._write_row_events(schema, evs)
            elif op[0] == "truncate":
                for sch in op[1].schemas:
                    await self.truncate_table(sch.id)
            else:
                await self._apply_schema_change(op[1])
        return WriteAck.durable()

    # -- columnar seam --------------------------------------------------------

    async def write_table_batch(self, schema: ReplicatedTableSchema,
                                batch) -> WriteAck:
        """Copy path, columnar: TSV rendered column-at-a-time (no
        Column.value boxing), same bytes as `write_table_rows`."""
        from .util import sequence_number_buffer

        name = await self._ensure_table(schema)
        require_full_batch("clickhouse", schema, batch)
        n = batch.num_rows
        zeros = np.zeros(n, dtype=np.uint64)
        ords = np.arange(n, dtype=np.uint64)
        try:
            seq_buf = sequence_number_buffer(zeros, zeros, ords)
            body, used_device = render_batch_tsv_fast(
                schema, batch, CDC_UPSERT, seq_buf,
                egress=getattr(batch, "device_egress", None))
        except EtlError:
            raise
        except Exception as e:  # no host re-render: fail, post nothing
            raise fast_render_error("clickhouse", e) from e
        count_egress_write(used_device)
        await self._insert_tsv(name, schema, body)
        return WriteAck.durable()

    async def write_event_batches(self, events: Sequence[Event]) -> WriteAck:
        """CDC path, columnar: simple decoded batch runs render column-at-
        a-time; old-tuple/TOAST batches and per-row events drop to the row
        path in place (sequential_batch_program preserves WAL order)."""
        from .base import sequential_batch_program
        from .util import change_type_batch, sequence_number_buffer

        for op in sequential_batch_program(events):
            if op[0] == "batch":
                _, schema, cb = op
                name = await self._ensure_table(schema)
                require_full_batch("clickhouse", schema, cb.batch,
                                   cb.change_types)
                # row path renders with_ordinal(0): constant third key
                zeros = np.zeros(cb.num_rows, dtype=np.uint64)
                try:
                    seq_buf = sequence_number_buffer(
                        cb.commit_lsns, cb.tx_ordinals, zeros)
                    body, used_device = render_batch_tsv_fast(
                        schema, cb.batch,
                        change_type_batch(cb.change_types), seq_buf,
                        egress=cb.egress)
                except EtlError:
                    raise
                except Exception as e:  # no host re-render: fail, post nothing
                    raise fast_render_error("clickhouse", e) from e
                count_egress_write(used_device)
                await self._insert_tsv(name, schema, body)
            elif op[0] == "rows":
                _, schema, evs = op
                await self._write_row_events(schema, evs)
            elif op[0] == "truncate":
                for sch in op[1].schemas:
                    await self.truncate_table(sch.id)
            else:
                await self._apply_schema_change(op[1])
        return WriteAck.durable()

    # -- transactional seam (docs/destinations.md exactly-once contract) ------

    _COMMIT_LOG = "_etl_commit_log"

    def supports_transactional_commit(self) -> bool:
        return True

    async def _ensure_commit_log(self) -> None:
        if self._commit_log_ready:
            return
        await self._execute(
            f"CREATE TABLE IF NOT EXISTS "
            f"`{self.config.database}`.`{self._COMMIT_LOG}` ("
            f"token String, commit_lsn UInt64, tx_ordinal UInt64, "
            f"commit_end_lsn UInt64, replay UInt8) "
            f"ENGINE = ReplacingMergeTree ORDER BY (commit_lsn, "
            f"tx_ordinal, token)")
        self._commit_log_ready = True

    @transactional_commit
    async def write_event_batches_committed(
            self, events: Sequence[Event], commit: CommitRange) -> WriteAck:
        """Committed CDC write: every data INSERT carries an
        `insert_deduplication_token` derived from the flush's WAL range
        (ClickHouse collapses re-streamed duplicate blocks inside its
        dedup window), and the range lands in `_etl_commit_log` AFTER
        the data — recovery reads the log's maximum, so a crash between
        data and log re-streams a flush the tokens then absorb."""
        await self._ensure_commit_log()
        if commit.replay:
            # replay-mode: exact-token dedup against the log, never
            # advancing the streaming high-water (replay rows sit BELOW
            # it by construction)
            seen = await self._execute(
                f"SELECT count() FROM "
                f"`{self.config.database}`.`{self._COMMIT_LOG}` "
                f"WHERE token = '{commit.token()}' AND replay = 1 "
                f"FORMAT TabSeparated")
            if int(seen.strip() or 0):
                return WriteAck.durable()
        self._dedup_token = commit.token()
        self._dedup_seq = 0
        try:
            ack = await self.write_event_batches(events)
        finally:
            self._dedup_token = None
        lsn, ordinal = commit.high
        await self._execute(
            f"INSERT INTO `{self.config.database}`.`{self._COMMIT_LOG}` "
            f"(token, commit_lsn, tx_ordinal, commit_end_lsn, replay) "
            f"FORMAT TabSeparated",
            f"{commit.token()}\t{lsn}\t{ordinal}\t"
            f"{commit.commit_end_lsn or 0}\t"
            f"{1 if commit.replay else 0}\n".encode())
        return ack

    async def recover_high_water(self) -> "CommitRange | None":
        await self._ensure_commit_log()
        text = await self._execute(
            f"SELECT commit_lsn, tx_ordinal, commit_end_lsn FROM "
            f"`{self.config.database}`.`{self._COMMIT_LOG}` "
            f"WHERE replay = 0 "
            f"ORDER BY commit_lsn DESC, tx_ordinal DESC LIMIT 1 "
            f"FORMAT TabSeparated")
        line = text.strip()
        if not line:
            return None
        lsn, ordinal, end = (int(v) for v in line.split("\t"))
        return CommitRange(high=(lsn, ordinal),
                           commit_end_lsn=end or None)

    async def _insert_tsv(self, name: str, schema: ReplicatedTableSchema,
                          body: bytes) -> None:
        cols = [c.name for c in schema.replicated_columns] + \
            [CHANGE_TYPE_COLUMN, CHANGE_SEQUENCE_COLUMN]
        col_list = ", ".join(f"`{c}`" for c in cols)
        await self._execute(
            f"INSERT INTO `{self.config.database}`.`{name}` ({col_list}) "
            f"FORMAT TabSeparated", body)

    async def _write_row_events(self, schema: ReplicatedTableSchema,
                                evs: list) -> None:
        items = []
        for e in evs:
            if isinstance(e, DeleteEvent):
                items.append(("row", e.old_row, ChangeType.DELETE, e))
            else:
                items.append(("row", e.row,
                              ChangeType.UPDATE if isinstance(e, UpdateEvent)
                              else ChangeType.INSERT, e))
        await self._write_run(schema, items)

    async def _write_run(self, schema: ReplicatedTableSchema,
                         items: list[tuple]) -> None:
        name = await self._ensure_table(schema)
        lines: list[bytes] = []
        for item in items:
            _, row, ct, ev = item
            if ct is not ChangeType.DELETE:
                require_full_row("clickhouse", schema, row)
            seq = ev.sequence_key.with_ordinal(0)
            fields = [render_value(v, c.kind) for v, c in
                      zip(row.values, schema.replicated_columns)]
            fields += [change_type_label(ct), seq]
            lines.append(("\t".join(fields) + "\n").encode())
        cols = [c.name for c in schema.replicated_columns] + \
            [CHANGE_TYPE_COLUMN, CHANGE_SEQUENCE_COLUMN]
        col_list = ", ".join(f"`{c}`" for c in cols)
        await self._execute(
            f"INSERT INTO `{self.config.database}`.`{name}` ({col_list}) "
            f"FORMAT TabSeparated", b"".join(lines))

    def _render_batch_tsv(self, schema: ReplicatedTableSchema,
                          batch: ColumnarBatch, *, change_type: str | None,
                          seqs: DecodedBatchEvent | None) -> bytes:
        require_full_batch("clickhouse", schema, batch,
                           seqs.change_types if seqs is not None else None)
        cols = schema.replicated_columns
        out = []
        for i in range(batch.num_rows):
            fields = [render_value(c.value(i), c.schema.kind)
                      for c in batch.columns]
            if seqs is not None:
                ct = change_type_label(ChangeType(int(seqs.change_types[i])))
                seq = (f"{int(seqs.commit_lsns[i]):016x}/"
                       f"{int(seqs.tx_ordinals[i]):016x}/"
                       f"{i:016x}")
            else:
                ct = change_type or CDC_UPSERT
                seq = f"{0:016x}/{0:016x}/{i:016x}"
            fields += [ct, seq]
            out.append("\t".join(fields) + "\n")
        return "".join(out).encode()

    async def _apply_schema_change(self, ev: SchemaChangeEvent) -> None:
        """SchemaDiff → ALTER TABLE DDL (reference clickhouse DDL for
        schema diffs)."""
        old = self._created_tables.get(ev.table_id)
        new = ev.new_schema
        assert new is not None
        if old is None:
            self._created_tables.pop(ev.table_id, None)
            await self._ensure_table(new)
            return
        diff = SchemaDiff.between(old.table_schema, new.table_schema)
        name = self._table_name(new)
        identity = {c.name for c in new.identity_columns()}
        for col in diff.added:
            # same forced-nullable rule as create_table_sql: non-identity
            # columns must accept the NULLs key-only DELETE rows carry
            nullable = col.nullable or col.name not in identity
            # classified portable defaults travel into the ADD COLUMN DDL
            # (reference default_expression.rs); non-portable ones
            # (nextval/now()/expressions) are omitted — rows carry
            # explicit values, the column backfills NULL
            ddl = (f"ALTER TABLE `{self.config.database}`.`{name}` "
                   f"ADD COLUMN IF NOT EXISTS `{col.name}` "
                   f"{clickhouse_type(col.kind, nullable)}")
            default = column_default_sql(col, "clickhouse")
            if default is not None:
                ddl += f" DEFAULT {default}"
            await self._execute(ddl)
        for col in diff.dropped:
            await self._execute(
                f"ALTER TABLE `{self.config.database}`.`{name}` DROP COLUMN "
                f"IF EXISTS `{col.name}`")
        for mod in diff.modified:
            await self._execute(
                f"ALTER TABLE `{self.config.database}`.`{name}` MODIFY "
                f"COLUMN `{mod.name}` "
                f"{clickhouse_type(mod.new.kind, mod.new.nullable)}")
        self._created_tables[ev.table_id] = new
        if self.config.create_current_views:
            await self._execute(create_current_view_sql(
                self.config.database, name, new))

    async def drop_table(self, table_id: TableId,
                         schema: ReplicatedTableSchema | None = None) -> None:
        if table_id not in self._names and schema is not None:
            self._table_name(schema)  # restart recovery: rebuild the mapping
        name = self._names.get(table_id)
        if name is None:
            return
        await self._execute(
            f"DROP TABLE IF EXISTS `{self.config.database}`.`{name}`")
        if self.config.create_current_views:
            await self._execute(
                f"DROP VIEW IF EXISTS "
                f"`{self.config.database}`.`{name}_current`")
        self._created_tables.pop(table_id, None)

    async def truncate_table(self, table_id: TableId) -> None:
        name = self._names.get(table_id)
        if name is not None:
            await self._execute(
                f"TRUNCATE TABLE IF EXISTS "
                f"`{self.config.database}`.`{name}`")

    async def shutdown(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None
