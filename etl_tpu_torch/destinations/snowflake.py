"""Snowflake destination: real Snowpipe Streaming REST + keypair JWT.

Reference parity: crates/etl-destinations/src/snowflake/ (6.2k LoC):
  - Snowpipe Streaming wire protocol — hostname discovery, per-table
    channels under `pipes/{table}-STREAMING`, continuation-token chaining,
    zstd NDJSON row bodies, offset-token dedup and commit proof — lives in
    `snowpipe.py` (streaming/{rest_client,channel,batch,offset_token}.rs);
  - JWT keypair auth (auth.rs): RS256 tokens with the
    account.user.SHA256:fingerprint issuer convention, invalidated and
    re-signed when the API reports auth expiry;
  - SQL client for DDL (sql_client.rs) via the statements REST API;
  - CDC metadata columns `_cdc_operation` / `_cdc_sequence_number`
    (schema.rs:6-7, encoding.rs CdcMeta).

Durability model: the reference defers commit proof behind Accepted acks
and waits at pipeline barriers (core.rs:260-275). Here each write call
runs its own barrier before acking durable — the 64-batch/256 MB copy
window still amortizes status polls across the many batches of one call,
and the ack never claims durability Snowflake hasn't proven.

Copy of the reference's `etl_tpu/destinations/snowflake.py`: the
destination (SQL statements API for DDL, Snowpipe Streaming channels
through `snowpipe.py`, keypair JWT) and its columnar NDJSON encoders
(`offset_token_batch`, `_column_json_texts` and `encode_batch_ndjson`,
the column-at-a-time oracle, and `encode_batch_ndjson_fast`, byte pieces
with device-rendered int and bool text where a `DeviceEgress` rode the
batch). Text columns are read from the port's `TextArray`. One
departure: a failed fast encode fails the write with a typed EtlError
and nothing is posted, where the reference re-encodes host-side
(`util.fast_render_error`).
"""

from __future__ import annotations

import asyncio
import base64
import json
import time
from dataclasses import dataclass
from json.encoder import encode_basestring  # what json.dumps uses inside
from typing import Sequence

import numpy as np

from ..analysis.annotations import hot_loop, transactional_commit
from ..models.default_expression import column_default_sql
from ..models.errors import ErrorKind, EtlError
from ..models.event import (ChangeType, DeleteEvent, Event,
                            SchemaChangeEvent, UpdateEvent)
from ..models.pgtypes import CellKind
from ..models.schema import ReplicatedTableSchema, TableId
from ..models.table_row import ColumnarBatch
from .base import CommitRange, Destination, WriteAck, expand_batch_events
from .bigquery import encode_value  # same JSON value encoding rules
from .snowpipe import (ZERO_OFFSET, AcceptedBatch, ChannelHandle,
                       RestStreamClient, RowBatch, RowBatchBuilder,
                       decode_offset_token, offset_token)
from .util import (DestinationRetryPolicy, classify_http_error,
                   count_egress_write, escaped_table_name, fast_render_error,
                   require_full_batch, require_full_row, require_zstandard,
                   sequential_event_program, with_retries)

# CDC metadata column names (reference schema.rs:6-7)
CDC_OPERATION_COLUMN = "_cdc_operation"
CDC_SEQUENCE_COLUMN = "_cdc_sequence_number"

_SF_TYPES: dict[CellKind, str] = {
    CellKind.BOOL: "BOOLEAN", CellKind.I16: "NUMBER(5,0)",
    CellKind.I32: "NUMBER(10,0)", CellKind.U32: "NUMBER(10,0)",
    CellKind.I64: "NUMBER(19,0)", CellKind.F32: "FLOAT",
    CellKind.F64: "FLOAT", CellKind.NUMERIC: "VARCHAR",
    CellKind.DATE: "DATE", CellKind.TIME: "TIME",
    CellKind.TIMESTAMP: "TIMESTAMP_NTZ",
    CellKind.TIMESTAMPTZ: "TIMESTAMP_TZ", CellKind.UUID: "VARCHAR(36)",
    CellKind.JSON: "VARIANT", CellKind.BYTES: "BINARY",
    CellKind.STRING: "VARCHAR", CellKind.ARRAY: "VARIANT",
    CellKind.INTERVAL: "VARCHAR",
}

_OP_LABEL = {ChangeType.INSERT: "insert", ChangeType.UPDATE: "update",
             ChangeType.DELETE: "delete"}


# -- columnar NDJSON encoding (egress hot path) -------------------------------

def offset_token_batch(commit_lsns, tx_ordinals) -> list[str]:
    """Vectorized `offset_token` for a batch: `{lsn:016x}/{ord:016x}`
    per row off one fixed-width hex buffer (the sequence_number_buffer
    idiom), no per-row format calls."""
    from .util import _hex16

    commit_lsns = np.asarray(commit_lsns, dtype=np.uint64)
    n = len(commit_lsns)
    buf = np.empty((n, 33), dtype=np.uint8)
    _hex16(commit_lsns, buf[:, 0:16])
    buf[:, 16] = ord("/")
    _hex16(np.asarray(tx_ordinals, dtype=np.uint64), buf[:, 17:33])
    return [s.decode() for s in buf.reshape(-1).view("S33").tolist()]


@hot_loop
def _column_json_texts(col) -> list:
    """One column's JSON value literals (str per row, "null" for SQL
    NULL), rendered column-at-a-time: one kind dispatch per column,
    dense numpy data stringified without boxing into Python objects.
    Byte-identical to `json.dumps(encode_value(col.value(i), kind),
    separators=(",", ":"), ensure_ascii=False, allow_nan=False)` per
    row. @hot_loop: per column per CDC flush (etl-lint rule 13)."""
    n = len(col)
    kind = col.schema.kind
    valid = col.validity
    if col.toast_unchanged is not None:
        valid = valid & ~col.toast_unchanged
    out: list = ["null"] * n
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
        texts = col.data.astype("U21")  # same digits as str(int)
        for i in present.tolist():
            out[i] = texts[i]
        return out
    if col.is_dense and kind in (CellKind.F32, CellKind.F64):
        if not np.isfinite(col.data[present]).all():
            # reference encoding.rs rejects non-finite floats — the row
            # path raises the same way at push_row (allow_nan=False)
            raise EtlError(
                ErrorKind.DESTINATION_FAILED,
                "snowpipe: row not JSON-encodable: Out of range float "
                "values are not allowed")
        data = col.data.tolist()  # Python floats: repr == json.dumps
        for i in present.tolist():
            out[i] = repr(data[i])
        return out
    if col.is_text and kind is CellKind.STRING and col.lazy_text_oid is None:
        vals = col.data.to_pylist()
        for i in present.tolist():
            out[i] = encode_basestring(vals[i])
        return out
    # generic fallback (NUMERIC/temporal/JSON/bytes/arrays/lazy-text):
    # box the value, reuse the row path's exact encoding
    for i in present.tolist():
        out[i] = json.dumps(encode_value(col.value(i), kind),
                            separators=(",", ":"), ensure_ascii=False,
                            allow_nan=False)
    return out


@hot_loop
def encode_batch_ndjson(schema: ReplicatedTableSchema, batch: ColumnarBatch,
                        ops, seqs) -> list[bytes]:
    """Whole-batch NDJSON: column-at-a-time value rendering + one join
    per row — each returned line (newline included) is byte-identical to
    the row path's `json.dumps(_doc(...), separators=(",", ":"),
    ensure_ascii=False, allow_nan=False) + "\\n"`. `ops`/`seqs` are
    per-row strs or one shared str (the copy path). @hot_loop: the
    Snowpipe egress hot path (etl-lint rule 13)."""
    n = batch.num_rows
    keys = [encode_basestring(c.schema.name) + ":" for c in batch.columns]
    cols = [_column_json_texts(c) for c in batch.columns]
    op_key = encode_basestring(CDC_OPERATION_COLUMN) + ":"
    seq_key = encode_basestring(CDC_SEQUENCE_COLUMN) + ":"
    if isinstance(ops, str):
        ops = [encode_basestring(ops)] * n
    else:
        ops = [encode_basestring(o) for o in ops]
    if isinstance(seqs, str):
        seqs = [encode_basestring(seqs)] * n
    else:
        seqs = [encode_basestring(s) for s in seqs]
    lines = []
    for i in range(n):
        fields = [k + c[i] for k, c in zip(keys, cols)]
        fields.append(op_key + ops[i])
        fields.append(seq_key + seqs[i])
        lines.append(("{" + ",".join(fields) + "}\n").encode())
    return lines


_JSON_FIXED_KINDS = (CellKind.BOOL, CellKind.I16, CellKind.I32,
                     CellKind.U32, CellKind.I64)


@hot_loop
def encode_batch_ndjson_fast(schema: ReplicatedTableSchema,
                             batch: ColumnarBatch, ops, seqs,
                             egress=None) -> "tuple[list[bytes], bool]":
    """Whole-batch NDJSON via byte-piece assembly: int/bool fields come
    from device-rendered egress buffers when attached (numpy twins
    otherwise, NULLs patched to `null`), every other kind reuses
    `_column_json_texts` verbatim, and untrusted rows are overridden
    with the per-row oracle line. One scatter builds the body; lines are
    sliced back out for the Snowpipe compressor. Byte-identical to
    `encode_batch_ndjson` (gated). Returns (lines, used_device).
    @hot_loop: the Snowpipe egress hot path (etl-lint rule 13)."""
    from ..ops import egress as eg

    n = batch.num_rows
    oracle_rows: set = set()
    if egress is not None and egress.untrusted.size:
        oracle_rows.update(egress.untrusted.tolist())
    comma = eg.const_piece(b",")
    pieces = [eg.const_piece(b"{")]
    used_device = False
    # per-column value-text source, kept for the override rows: either the
    # oracle texts list or the (col, valid) pair the dense renderer used
    sources: list = []
    for j, col in enumerate(batch.columns):
        pieces.append(eg.const_piece(
            (encode_basestring(col.schema.name) + ":").encode()))
        kind = col.schema.kind
        dev = egress.field(j) if egress is not None else None
        if col.is_dense and kind in _JSON_FIXED_KINDS:
            valid = col.validity
            if col.toast_unchanged is not None:
                valid = valid & ~col.toast_unchanged
            nulls = np.flatnonzero(~valid)
            if dev is not None:
                buf, lens = eg.patch_rows_fixed(dev[0], dev[1], nulls,
                                                b"null")
                used_device = True
            else:
                buf, lens = eg.bool_text_fixed(col.data) \
                    if kind is CellKind.BOOL \
                    else eg.int_text_fixed(col.data)
                buf, lens = eg.patch_rows_fixed(buf, lens, nulls, b"null")
            pieces.append(eg.fixed_piece(buf, lens))
            sources.append((col, valid))
        else:
            # the oracle's own column renderer — identity by construction
            # (raises the same non-finite-float EtlError the row path does)
            texts = _column_json_texts(col)
            pieces.append(eg.var_from_texts(
                [str(t).encode() for t in texts]))
            sources.append(texts)
        pieces.append(comma)
    pieces.append(eg.const_piece(
        (encode_basestring(CDC_OPERATION_COLUMN) + ":").encode()))
    if isinstance(ops, str):
        pieces.append(eg.const_piece(encode_basestring(ops).encode()))
    else:
        pieces.append(eg.var_from_texts(
            [encode_basestring(o).encode() for o in ops]))
    pieces.append(comma)
    pieces.append(eg.const_piece(
        (encode_basestring(CDC_SEQUENCE_COLUMN) + ":").encode()))
    if isinstance(seqs, str):
        pieces.append(eg.const_piece(encode_basestring(seqs).encode()))
    else:
        pieces.append(eg.var_from_texts(
            [encode_basestring(s).encode() for s in seqs]))
    pieces.append(eg.const_piece(b"}\n"))
    override = None
    if oracle_rows:

        def _text(src, i):
            if isinstance(src, list):
                return str(src[i])
            col, valid = src
            if not valid[i]:
                return "null"
            if col.schema.kind is CellKind.BOOL:
                return "true" if col.data[i] else "false"
            return str(int(col.data[i]))  # same digits as the U21 twin

        override = {}
        keys = [encode_basestring(c.schema.name) + ":"
                for c in batch.columns]
        for i in sorted(oracle_rows):
            fields = [k + _text(src, i)
                      for k, src in zip(keys, sources)]
            fields.append(encode_basestring(CDC_OPERATION_COLUMN) + ":"
                          + encode_basestring(
                              ops if isinstance(ops, str) else ops[i]))
            fields.append(encode_basestring(CDC_SEQUENCE_COLUMN) + ":"
                          + encode_basestring(
                              seqs if isinstance(seqs, str) else seqs[i]))
            override[i] = ("{" + ",".join(fields) + "}\n").encode()
    out, starts = eg.assemble_rows(n, pieces, override)
    body = out.tobytes()
    return ([body[starts[i]:starts[i + 1]] for i in range(n)],
            used_device)


def _encode_cdc_batch(schema: ReplicatedTableSchema,
                      cb) -> "RowBatchBuilder":
    """Render one CoalescedBatch into a RowBatchBuilder: vectorized op
    labels + offset tokens, columnar NDJSON lines. Pure CPU work, kept
    out of the async write path (etl-lint rule 2; the @hot_loop markers
    live on the per-column/per-batch encoders below — this wrapper's
    np.asarray is a host-side label array, not a device fetch)."""
    cts = np.asarray(cb.change_types)
    labels = np.where(
        cts == int(ChangeType.DELETE), "delete",
        np.where(cts == int(ChangeType.UPDATE), "update",
                 "insert")).tolist()
    seqs = offset_token_batch(cb.commit_lsns, cb.tx_ordinals)
    builder = RowBatchBuilder()
    try:
        lines, used_device = encode_batch_ndjson_fast(
            schema, cb.batch, labels, seqs, egress=cb.egress)
    except EtlError:
        raise  # typed rejections (non-finite floats) are the contract
    except Exception as e:  # no host re-encode: fail, post nothing
        raise fast_render_error("snowflake", e) from e
    count_egress_write(used_device)
    for line, seq in zip(lines, seqs):
        builder.push_encoded_line(line, seq)
    return builder


@dataclass(frozen=True)
class SnowflakeConfig:
    base_url: str  # account REST endpoint (fake server in tests)
    account: str
    user: str
    database: str
    schema: str = "PUBLIC"
    private_key_pem: str = ""  # PKCS#8 RSA key for JWT; "" = no auth header
    pipeline_id: int = 0  # channel names embed it (channel.rs:251)
    commit_poll_interval_s: float = 0.5  # channel.rs:22
    commit_wait_timeout_s: float = 180.0  # channel.rs:28


def make_jwt(config: SnowflakeConfig, lifetime_s: int = 3600) -> str:
    """RS256 keypair JWT (reference auth.rs)."""
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    key = serialization.load_pem_private_key(
        config.private_key_pem.encode(), password=None)
    pub = key.public_key().public_bytes(
        serialization.Encoding.DER,
        serialization.PublicFormat.SubjectPublicKeyInfo)
    import hashlib

    fp = base64.b64encode(hashlib.sha256(pub).digest()).decode()
    qualified = f"{config.account.upper()}.{config.user.upper()}"
    now = int(time.time())
    header = {"alg": "RS256", "typ": "JWT"}
    claims = {"iss": f"{qualified}.SHA256:{fp}", "sub": qualified,
              "iat": now, "exp": now + lifetime_s}

    def b64(d: dict) -> bytes:
        return base64.urlsafe_b64encode(
            json.dumps(d, separators=(",", ":")).encode()).rstrip(b"=")

    signing_input = b64(header) + b"." + b64(claims)
    sig = key.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
    return (signing_input + b"."
            + base64.urlsafe_b64encode(sig).rstrip(b"=")).decode()


class _KeyPairTokenProvider:
    """Caches the signed JWT until near expiry; `invalidate_token` forces a
    re-sign on the next request (reference auth.rs TokenProvider)."""

    def __init__(self, config: SnowflakeConfig):
        self.config = config
        self._cached: tuple[str, float] | None = None

    async def get_token(self) -> str:
        if not self.config.private_key_pem:
            return ""
        now = time.time()
        if self._cached is None or now > self._cached[1] - 60:
            self._cached = (make_jwt(self.config), now + 3600)
        return self._cached[0]

    def invalidate_token(self) -> None:
        self._cached = None


class SnowflakeDestination(Destination):
    egress_encoder = "json"  # device-rendered NDJSON fields (ops/egress.py)

    def __init__(self, config: SnowflakeConfig,
                 retry: DestinationRetryPolicy | None = None):
        require_zstandard("the Snowflake destination")
        self.config = config
        self.retry = retry or DestinationRetryPolicy()
        self.auth = _KeyPairTokenProvider(config)
        self._session: aiohttp.ClientSession | None = None
        self._stream = RestStreamClient(config.base_url, self.auth,
                                        self._get_session, self.retry)
        self._created: dict[TableId, ReplicatedTableSchema] = {}
        self._names: dict[TableId, str] = {}
        self._channels: dict[TableId, ChannelHandle] = {}
        # ChannelHandle mirrors the Rust original's &mut self methods: it
        # is NOT safe under concurrent callers (continuation tokens chain
        # across awaits). Parallel copy partitions hit the same table's
        # channel, so every channel interaction holds this per-table lock.
        self._table_locks: dict[TableId, asyncio.Lock] = {}
        # exactly-once seam: DLQ replays route through dedicated `rp0`
        # channels — their rows sit BELOW the live channel's committed
        # offset, and the server's offset dedup would silently drop them
        # there (see write_event_batches_committed)
        self._replay_channels: dict[TableId, ChannelHandle] = {}
        self._replay_mode = False

    def _get_session(self) -> aiohttp.ClientSession:
        import aiohttp  # where a request is made: the encoders need none

        if self._session is None:
            self._session = aiohttp.ClientSession()
        return self._session

    # -- SQL statements API (sql_client.rs) ------------------------------------

    async def _sql(self, statement: str) -> dict:
        import aiohttp  # where a request is made: the encoders need none

        async def attempt() -> dict:
            headers = {}
            token = await self.auth.get_token()
            if token:
                headers["Authorization"] = f"Bearer {token}"
                headers["X-Snowflake-Authorization-Token-Type"] = \
                    "KEYPAIR_JWT"
            async with self._get_session().post(
                    f"{self.config.base_url}/api/v2/statements",
                    json={"statement": statement,
                          "database": self.config.database,
                          "schema": self.config.schema},
                    headers=headers) as resp:
                text = await resp.text()
                if resp.status == 401:
                    # auth expiry is transient once re-signed: invalidate
                    # the cached JWT and retry (reference auth.rs)
                    self.auth.invalidate_token()
                if resp.status >= 400:
                    if resp.status == 401:
                        # transient once re-signed (kept out of the
                        # shared map: the JWT invalidation above makes
                        # the retry meaningful)
                        raise EtlError(
                            ErrorKind.DESTINATION_THROTTLED,
                            f"snowflake 401 statements: {text[:300]}")
                    raise classify_http_error(
                        "snowflake", resp.status,
                        f"statements: {text[:300]}")
                return json.loads(text) if text else {}

        def retryable(e: BaseException) -> bool:
            if isinstance(e, EtlError):
                return e.kind is ErrorKind.DESTINATION_THROTTLED
            return isinstance(e, (aiohttp.ClientError, OSError))

        return await with_retries(attempt, self.retry, retryable)

    async def startup(self) -> None:
        await self._sql(
            f'CREATE SCHEMA IF NOT EXISTS "{self.config.schema}"')

    # -- table DDL -------------------------------------------------------------

    def _table_name(self, schema: ReplicatedTableSchema) -> str:
        return self._names.setdefault(
            schema.id, escaped_table_name(schema.name).upper())

    async def _ensure_table(self, schema: ReplicatedTableSchema) -> str:
        name = self._table_name(schema)
        if self._created.get(schema.id) == schema:
            return name
        for c in schema.replicated_columns:
            # reference schema.rs validate_no_cdc_collisions
            if c.name in (CDC_OPERATION_COLUMN, CDC_SEQUENCE_COLUMN):
                raise EtlError(
                    ErrorKind.CONFIG_INVALID,
                    f"snowflake: source column {c.name!r} collides with a "
                    f"CDC metadata column")
        identity = {c.name for c in schema.identity_columns()}
        # non-identity columns stay nullable: key-only DELETE rows carry
        # nulls for them
        def spec(c):
            s = f'"{c.name}" {_SF_TYPES.get(c.kind, "VARCHAR")}'
            default = column_default_sql(c, "snowflake")
            if default is not None:
                s += f" DEFAULT {default}"
            if not c.nullable and c.name in identity:
                s += " NOT NULL"
            return s

        cols = [spec(c) for c in schema.replicated_columns]
        cols.append(f'"{CDC_OPERATION_COLUMN}" VARCHAR NOT NULL')
        cols.append(f'"{CDC_SEQUENCE_COLUMN}" VARCHAR NOT NULL')
        await self._sql(f'CREATE TABLE IF NOT EXISTS "{name}" '
                        f'({", ".join(cols)})')
        self._created[schema.id] = schema
        return name

    # -- channels --------------------------------------------------------------

    def _channel(self, schema: ReplicatedTableSchema) -> ChannelHandle:
        table = self._replay_channels if self._replay_mode \
            else self._channels
        handle = table.get(schema.id)
        if handle is None:
            name = self._table_name(schema)
            suffix = "rp0" if self._replay_mode else "ch0"
            handle = ChannelHandle(
                self._stream, self.config.database, self.config.schema,
                name,
                channel=(f"etl_{self.config.pipeline_id}_"
                         f"{self.config.schema}_{name}_{suffix}"),
                poll_interval_s=self.config.commit_poll_interval_s,
                wait_timeout_s=self.config.commit_wait_timeout_s)
            table[schema.id] = handle
        return handle

    def _lock_for(self, table_id: TableId) -> asyncio.Lock:
        return self._table_locks.setdefault(table_id, asyncio.Lock())

    async def _open_channel(self, schema: ReplicatedTableSchema
                            ) -> ChannelHandle:
        handle = self._channel(schema)
        if not handle.is_open:
            await handle.open()
        return handle

    # -- row encoding ----------------------------------------------------------

    def _doc(self, schema: ReplicatedTableSchema, row, op: str,
             sequence: str) -> dict:
        doc = {c.name: encode_value(v, c.kind)
               for c, v in zip(schema.replicated_columns, row.values)}
        doc[CDC_OPERATION_COLUMN] = op
        doc[CDC_SEQUENCE_COLUMN] = sequence
        return doc

    # -- columnar encoding (egress hot path) -----------------------------------

    async def _stream_batches(self, schema: ReplicatedTableSchema,
                              batches: "list[RowBatch]") -> None:
        """Shared CDC tail of the row and columnar paths: accept the
        request bodies on the table's channel and wait out the
        aggregated commit proof (see _write_cdc_run for why the proof
        must cover EVERY accepted batch of the run)."""
        if not batches:
            return
        async with self._lock_for(schema.id):
            handle = await self._open_channel(schema)
            accepted = await handle.accept_streaming_batches(batches)
            if accepted:
                total = AcceptedBatch(
                    target_offset=accepted[-1].target_offset,
                    rows=sum(a.rows for a in accepted),
                    bytes=sum(a.bytes for a in accepted),
                    baseline_rows_inserted=
                        accepted[0].baseline_rows_inserted,
                    baseline_rows_error_count=
                        accepted[0].baseline_rows_error_count)
                await handle.wait_for_offsets_committed(
                    total.target_offset, total)

    # -- copy path -------------------------------------------------------------

    async def write_table_rows(self, schema: ReplicatedTableSchema,
                               batch: ColumnarBatch) -> WriteAck:
        await self._ensure_table(schema)
        builder = RowBatchBuilder()
        for i in range(batch.num_rows):
            doc = {c.schema.name: encode_value(c.value(i), c.schema.kind)
                   for c in batch.columns}
            doc[CDC_OPERATION_COLUMN] = "insert"
            doc[CDC_SEQUENCE_COLUMN] = ZERO_OFFSET
            builder.push_row(doc, ZERO_OFFSET)
        return await self._finish_copy(schema, builder)

    async def write_table_batch(self, schema: ReplicatedTableSchema,
                                batch: ColumnarBatch) -> WriteAck:
        """Columnar COPY path: NDJSON lines rendered column-at-a-time —
        byte-identical to write_table_rows' per-row dict + json.dumps —
        then pushed pre-encoded through the same compressor."""
        await self._ensure_table(schema)
        builder = RowBatchBuilder()
        try:
            lines, used_device = encode_batch_ndjson_fast(
                schema, batch, "insert", ZERO_OFFSET,
                egress=getattr(batch, "device_egress", None))
        except EtlError:
            raise
        except Exception as e:  # no host re-encode: fail, post nothing
            raise fast_render_error("snowflake", e) from e
        count_egress_write(used_device)
        for line in lines:
            builder.push_encoded_line(line, ZERO_OFFSET)
        return await self._finish_copy(schema, builder)

    async def _finish_copy(self, schema: ReplicatedTableSchema,
                           builder: RowBatchBuilder) -> WriteAck:
        batches = builder.finish()
        if batches:
            async with self._lock_for(schema.id):
                handle = await self._open_channel(schema)
                await handle.accept_table_copy_batches(batches)
                await handle.wait_for_table_copy_durability()
        return WriteAck.durable()

    # -- CDC path --------------------------------------------------------------

    async def write_event_batches(self, events: Sequence[Event]) -> WriteAck:
        """CDC path, columnar: simple decoded batch runs render NDJSON
        column-at-a-time; old-tuple/TOAST batches and per-row events
        drop to the row path in place (sequential_batch_program
        preserves WAL order) — the same stance as the ClickHouse and
        BigQuery encoders."""
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
                    self._table_name(sch)
                    self._created.setdefault(sch.id, sch)
                    await self.truncate_table(sch.id)
            else:
                await self._apply_ddl(op[1])
        return WriteAck.durable()

    async def _write_cdc_batch(self, schema: ReplicatedTableSchema,
                               cb) -> None:
        await self._ensure_table(schema)
        require_full_batch("snowflake", schema, cb.batch, cb.change_types)
        builder = _encode_cdc_batch(schema, cb)
        await self._stream_batches(schema, builder.finish())

    async def write_events(self, events: Sequence[Event]) -> WriteAck:
        for op in sequential_event_program(expand_batch_events(events)):
            if op[0] == "rows":
                _, schema, evs = op
                await self._write_cdc_run(schema, evs)
            elif op[0] == "truncate":
                for sch in op[1].schemas:
                    # register the mapping first: after a restart the
                    # truncate would otherwise silently no-op
                    self._table_name(sch)
                    self._created.setdefault(sch.id, sch)
                    await self.truncate_table(sch.id)
            else:
                await self._apply_ddl(op[1])
        return WriteAck.durable()

    async def _write_cdc_run(self, schema: ReplicatedTableSchema,
                             evs: list) -> None:
        await self._ensure_table(schema)
        builder = RowBatchBuilder()
        for e in evs:
            off = offset_token(int(e.commit_lsn), e.tx_ordinal)
            if isinstance(e, DeleteEvent):
                row, ct = e.old_row, ChangeType.DELETE
            else:
                row, ct = e.row, (ChangeType.UPDATE
                                  if isinstance(e, UpdateEvent)
                                  else ChangeType.INSERT)
                require_full_row("snowflake", schema, row)
            builder.push_row(self._doc(schema, row, _OP_LABEL[ct], off),
                             off)
        # durability barrier: don't ack until Snowflake proves the last
        # offset committed (_stream_batches aggregates EVERY accepted
        # batch of this run — validating only the last batch would let
        # rows silently dropped from an earlier batch pass the check
        # that exists to catch them)
        await self._stream_batches(schema, builder.finish())

    # -- transactional seam (docs/destinations.md exactly-once contract) ------
    #
    # Snowpipe Streaming IS a transactional sink: every insert ships its
    # WAL-coordinate offset-token range on the query string, the server
    # dedups re-streamed rows at-or-below the channel's committed offset,
    # and `wait_for_offsets_committed` is the atomic data+coordinate
    # commit. The seam therefore adds only (a) the replay channel split
    # and (b) reading the committed offsets back at recovery.

    def supports_transactional_commit(self) -> bool:
        return True

    @transactional_commit
    async def write_event_batches_committed(
            self, events: Sequence[Event], commit: CommitRange) -> WriteAck:
        """Committed CDC write. Streamed flushes take the normal path —
        the offset tokens already carried by every insert ARE the
        transactional coordinates. DLQ replays (`commit.replay`) route
        through per-table `rp0` channels: their rows sit below the live
        channel's committed offset and would be silently dropped by the
        server's dedup there, while the fresh replay channel accepts
        them once and dedups an identical re-run replay."""
        if not commit.replay:
            return await self.write_event_batches(events)
        self._replay_mode = True
        try:
            return await self.write_event_batches(events)
        finally:
            self._replay_mode = False

    async def recover_high_water(self) -> "CommitRange | None":
        """Max committed offset token across this destination's live
        channels (reopening each reads the server's persisted progress).
        With no channels yet — a cold process that has not streamed —
        there is nothing to ask; the caller degrades to the progress
        store and the per-channel offset dedup still bounds duplicates."""
        best: "tuple[int, int] | None" = None
        for tid in list(self._channels):
            handle = self._channels[tid]
            async with self._lock_for(tid):
                if not handle.is_open:
                    await handle.open()
            tok = handle.committed_offset
            if tok and tok != ZERO_OFFSET:
                coord = decode_offset_token(tok)
                if best is None or coord > best:
                    best = coord
        if best is None:
            return None
        return CommitRange(high=best)

    # -- DDL / lifecycle -------------------------------------------------------

    async def _apply_ddl(self, ev: SchemaChangeEvent) -> None:
        from ..models.schema import SchemaDiff

        old = self._created.get(ev.table_id)
        new = ev.new_schema
        assert new is not None
        if old is None:
            await self._ensure_table(new)
            return
        name = self._table_name(new)
        diff = SchemaDiff.between(old.table_schema, new.table_schema)
        for col in diff.added:
            ddl = (f'ALTER TABLE "{name}" ADD COLUMN IF NOT EXISTS '
                   f'"{col.name}" {_SF_TYPES.get(col.kind, "VARCHAR")}')
            default = column_default_sql(col, "snowflake")
            if default is not None:
                ddl += f" DEFAULT {default}"
            await self._sql(ddl)
        for col in diff.dropped:
            await self._sql(f'ALTER TABLE "{name}" DROP COLUMN IF EXISTS '
                            f'"{col.name}"')
        self._created[ev.table_id] = new

    async def drop_table(self, table_id: TableId,
                         schema: ReplicatedTableSchema | None = None) -> None:
        if table_id not in self._names and schema is not None:
            # restart recovery: rebuild the name mapping so the drop (and
            # the channel drop, which clears server-side offsets) happens
            self._table_name(schema)
            self._created.setdefault(table_id, schema)
        name = self._names.get(table_id)
        if name is not None:
            async with self._lock_for(table_id):
                stored = self._created.get(table_id)
                handle = self._channels.pop(table_id, None)
                if handle is None and stored is not None:
                    handle = self._channel(stored)
                    self._channels.pop(table_id, None)
                if handle is not None:
                    await handle.drop()
                await self._sql(f'DROP TABLE IF EXISTS "{name}"')
                self._created.pop(table_id, None)

    async def truncate_table(self, table_id: TableId) -> None:
        name = self._names.get(table_id)
        if name is not None:
            async with self._lock_for(table_id):
                await self._sql(f'TRUNCATE TABLE IF EXISTS "{name}"')
                # the table restarts empty: reset the channel so its
                # server-side committed offsets don't dedup the re-copied
                # rows — always, not only when locally open: a restarted
                # process must clear offsets a previous incarnation
                # committed
                schema = self._created.get(table_id)
                if schema is not None:
                    await self._channel(schema).reset()

    async def shutdown(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None
