"""Snowpipe Streaming wire client: the REAL REST surface Snowflake speaks.

Copy of the reference's `etl_tpu/destinations/snowpipe.py`.

Reference parity (behavioral, re-designed in async Python):
- hostname discovery, channel PUT/DELETE, zstd-NDJSON row POST with
  continuationToken/startOffsetToken/endOffsetToken query params, and
  `pipes/{table}-STREAMING:bulk-channel-status`
  (crates/etl-destinations/src/snowflake/streaming/rest_client.rs:47-418);
- offset tokens `{commit_lsn:016x}/{tx_ordinal:016x}` whose lexicographic
  order IS WAL order (streaming/offset_token.rs:7-40);
- compressed row batches split below the 4 MB API body limit
  (streaming/batch.rs:13-42);
- channel lifecycle: continuation-token chaining, stale-continuation
  reopen-and-recover, committed-offset dedup, uncommitted-rows wait loops,
  synthetic `0/N` table-copy offsets behind a durability barrier
  (streaming/channel.rs:22-634);
- error classification and retry decisions (snowflake/error.rs:64-131,
  rest_client.rs:420-450).
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass
from typing import Callable, Protocol


from ..models.errors import ErrorKind, EtlError
from .util import DestinationRetryPolicy, require_zstandard, with_retries

# -- offset tokens (offset_token.rs) ------------------------------------------

ZERO_OFFSET = "0000000000000000/0000000000000000"


def offset_token(commit_lsn: int, tx_ordinal: int) -> str:
    """`{lsn:016x}/{ordinal:016x}` — fixed width, so string order == WAL
    order and Snowflake's server-side `>=` dedup agrees with ours."""
    return f"{commit_lsn:016x}/{tx_ordinal:016x}"


def decode_offset_token(tok: str) -> tuple[int, int]:
    lsn_hex, sep, ord_hex = tok.partition("/")
    if sep != "/" or len(lsn_hex) != 16 or len(ord_hex) != 16:
        raise EtlError(ErrorKind.DESTINATION_FAILED,
                       f"snowpipe: invalid offset token format: {tok!r}")
    try:
        return int(lsn_hex, 16), int(ord_hex, 16)
    except ValueError:
        raise EtlError(ErrorKind.DESTINATION_FAILED,
                       f"snowpipe: invalid offset token hex: {tok!r}")


# -- row batches (batch.rs) ----------------------------------------------------

# Snowflake Streaming API hard limit on the compressed HTTP request body.
MAX_COMPRESSED_BYTES = 4 * 1024 * 1024
# Split when compressed output reaches this threshold (200 KB headroom
# covers up to MAX_UNFLUSHED_BYTES of input that arrives between checks).
BATCH_SPLIT_THRESHOLD = 3_800_000
# Max bytes written to the compressor between block flushes.
MAX_UNFLUSHED_BYTES = 128 * 1024
# Max serialized (uncompressed) size of a single row — rejects degenerate
# TOAST rows before they enter the encoder.
MAX_UNCOMPRESSED_ROW_BYTES = 2 * 1024 * 1024
ZSTD_COMPRESSION_LEVEL = 3


@dataclass
class RowBatch:
    """One compressed NDJSON request body with its inclusive offset range."""

    data: bytes
    row_count: int
    start_offset: str
    end_offset: str

    @property
    def size(self) -> int:
        return len(self.data)

    def with_request_offset(self, offset: str) -> "RowBatch":
        """Copy batches are encoded before the channel reserves their
        attempt-local offset; both request-range endpoints become `offset`
        while the encoded `_cdc_sequence_number`s stay unchanged
        (batch.rs:103-112)."""
        return RowBatch(self.data, self.row_count, offset, offset)


class RowBatchBuilder:
    """Builds compressed row batches with streaming zstd compression,
    splitting under the API body limit (batch.rs:114-248)."""

    def __init__(self) -> None:
        require_zstandard("a Snowpipe row batch")
        import zstandard

        self._zstd = zstandard.ZstdCompressor(level=ZSTD_COMPRESSION_LEVEL)
        self._flush_block = zstandard.COMPRESSOBJ_FLUSH_BLOCK
        self._new_encoder()
        self.batches: list[RowBatch] = []

    def _new_encoder(self) -> None:
        self._enc = self._zstd.compressobj()
        self._chunks: list[bytes] = []
        self._row_count = 0
        self._range: tuple[str, str] | None = None
        self._input_since_flush = 0

    def _compressed_size(self) -> int:
        return sum(len(c) for c in self._chunks)

    def push_row(self, doc: dict, offset: str) -> None:
        """Append one NDJSON row. `doc` already carries the CDC metadata
        columns; `offset` extends the batch's inclusive offset range."""
        try:
            line = (json.dumps(doc, separators=(",", ":"),
                               ensure_ascii=False, allow_nan=False)
                    + "\n").encode()
        except ValueError as e:
            # reference encoding.rs rejects non-finite floats
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           f"snowpipe: row not JSON-encodable: {e}")
        self.push_encoded_line(line, offset)

    def push_encoded_line(self, line: bytes, offset: str) -> None:
        """Append one PRE-ENCODED NDJSON line (newline included) — the
        columnar egress path (snowflake.encode_batch_ndjson) renders
        whole batches column-at-a-time and streams the finished lines
        here, so the compressor/split bookkeeping is shared byte-for-byte
        with the row path."""
        if len(line) > MAX_UNCOMPRESSED_ROW_BYTES:
            raise EtlError(
                ErrorKind.DESTINATION_FAILED,
                f"snowpipe: single row exceeds {MAX_UNCOMPRESSED_ROW_BYTES}B "
                f"limit ({len(line)}B uncompressed)")
        if self._input_since_flush + len(line) >= MAX_UNFLUSHED_BYTES:
            self._chunks.append(self._enc.flush(self._flush_block))
            self._input_since_flush = 0
            if (self._row_count > 0 and
                    self._compressed_size() + len(line)
                    > BATCH_SPLIT_THRESHOLD):
                self._finish_current()
        self._chunks.append(self._enc.compress(line))
        self._input_since_flush += len(line)
        self._row_count += 1
        if self._range is None:
            self._range = (offset, offset)
        else:
            self._range = (self._range[0], offset)

    def _finish_current(self) -> None:
        self._chunks.append(self._enc.flush())
        data = b"".join(self._chunks)
        if len(data) > MAX_COMPRESSED_BYTES:
            raise EtlError(
                ErrorKind.DESTINATION_FAILED,
                f"snowpipe: compressed batch exceeds {MAX_COMPRESSED_BYTES}B "
                f"API limit ({len(data)}B)")
        assert self._range is not None
        self.batches.append(RowBatch(data, self._row_count,
                                     self._range[0], self._range[1]))
        self._new_encoder()

    def finish(self) -> list[RowBatch]:
        if self._row_count > 0:
            self._finish_current()
        return self.batches


# -- error classification (error.rs) -------------------------------------------


class SnowpipeWireError(Exception):
    """Classified Snowpipe Streaming API failure. `kind` is one of:
    stale_continuation | uncommitted_rows | channel_not_found |
    auth_expired | api_status | http."""

    def __init__(self, kind: str, status: int, message: str,
                 api_code: int | None = None):
        super().__init__(f"snowpipe {kind} (HTTP {status}): {message[:300]}")
        self.kind = kind
        self.status = status
        self.api_code = api_code

    @classmethod
    def from_response(cls, status: int, body: str) -> "SnowpipeWireError":
        """Mirrors SnowpipeError::from_response (error.rs:95-124): numeric
        `status_code` in the body wins (3=auth expired, 4=stale), then the
        string `code`, then the HTTP status."""
        doc: dict = {}
        try:
            parsed = json.loads(body)
            if isinstance(parsed, dict):
                doc = parsed
        except ValueError:
            pass
        api_code = doc.get("status_code")
        if isinstance(api_code, int):
            if api_code == 3:
                return cls("auth_expired", status, body, api_code)
            if api_code == 4:
                return cls("stale_continuation", status, body, api_code)
            return cls("api_status", status, body, api_code)
        code = doc.get("code")
        if status == 400 and code == "STALE_CONTINUATION_TOKEN_SEQUENCER":
            return cls("stale_continuation", status, body)
        if status == 409 and code == "ERR_CHANNEL_HAS_UNCOMMITTED_DATA":
            return cls("uncommitted_rows", status, body)
        if status == 404:
            return cls("channel_not_found", status, body)
        return cls("http", status, body)

    @property
    def retryable(self) -> bool:
        """rest_client.rs:420-450 should_retry: auth expiry retries (the
        token provider refreshes), stale/uncommitted/not-found surface to
        the channel lifecycle, API codes 0|2|4 stop, 401/408/429/5xx
        retry."""
        if self.kind == "auth_expired":
            return True
        if self.kind in ("stale_continuation", "uncommitted_rows",
                         "channel_not_found"):
            return False
        if self.kind == "api_status":
            return self.api_code not in (0, 2, 4)
        return self.status in (401, 408, 429) or self.status >= 500


# -- REST client (rest_client.rs) ----------------------------------------------


class TokenProvider(Protocol):
    async def get_token(self) -> str: ...

    def invalidate_token(self) -> None: ...


@dataclass
class ChannelStatus:
    """Parsed channel status (rest_client.rs ChannelStatusDetail /
    BulkStatusChannel — both field spellings accepted)."""

    channel: str
    status_code: str
    offset_token: str | None
    rows_inserted: int
    rows_parsed: int
    rows_error_count: int
    last_error_message: str | None = None

    @classmethod
    def from_doc(cls, doc: dict, fallback_channel: str) -> "ChannelStatus":
        tok = doc.get("last_committed_offset_token") or None
        if tok is not None:
            decode_offset_token(tok)  # validate canonical form
        return cls(
            channel=doc.get("channel_name") or fallback_channel,
            status_code=doc.get("channel_status_code") or "",
            offset_token=tok,
            rows_inserted=int(doc.get("rows_inserted", 0)),
            rows_parsed=int(doc.get("rows_parsed", 0)),
            # Open Channel documents `rows_error_count`, Bulk Get Channel
            # Status documents `rows_errors` — accept both
            rows_error_count=int(doc.get("rows_error_count",
                                         doc.get("rows_errors", 0))),
            last_error_message=doc.get("last_error_message"))


def _pipe_name(table: str) -> str:
    return f"{table}-STREAMING"


USER_AGENT = "etl-tpu/0.1.0"


class RestStreamClient:
    """Snowpipe Streaming REST driver. Discovers the ingest host once,
    chains continuation tokens per channel, retries with backoff, and
    invalidates the auth token on 401 so the provider re-signs."""

    def __init__(self, account_url: str, auth: TokenProvider,
                 session_factory: Callable[[], aiohttp.ClientSession],
                 retry: DestinationRetryPolicy | None = None):
        self.account_url = account_url.rstrip("/")
        self.auth = auth
        self._session_factory = session_factory
        self.retry = retry or DestinationRetryPolicy()
        self._ingest_host: str | None = None

    async def _headers(self) -> dict[str, str]:
        token = await self.auth.get_token()
        h = {"User-Agent": USER_AGENT}
        if token:
            h["Authorization"] = f"Bearer {token}"
            h["X-Snowflake-Authorization-Token-Type"] = "KEYPAIR_JWT"
        return h

    async def _request(self, method: str, url: str, *,
                       params: dict | None = None,
                       json_body: dict | None = None,
                       data: bytes | None = None,
                       headers: dict[str, str] | None = None) -> bytes:
        import aiohttp  # where a request is made: the encoders need none

        async def attempt() -> bytes:
            h = await self._headers()
            if headers:
                h.update(headers)
            session = self._session_factory()
            async with session.request(method, url, params=params,
                                       json=json_body, data=data,
                                       headers=h) as resp:
                body = await resp.text()
                if resp.status != 200:
                    err = SnowpipeWireError.from_response(resp.status, body)
                    if resp.status == 401 or err.kind == "auth_expired":
                        # rest_client.rs:144-147,240-246: a 401 or an
                        # auth-expired API code invalidates the cached
                        # token; the retry re-signs
                        self.auth.invalidate_token()
                    raise err
                return body.encode()

        def retryable(e: BaseException) -> bool:
            if isinstance(e, SnowpipeWireError):
                return e.retryable
            return isinstance(e, (aiohttp.ClientError, OSError))

        return await with_retries(attempt, self.retry, retryable)

    async def discover_ingest_host(self) -> str:
        """GET /v2/streaming/hostname — the actual server returns plain
        text even with Accept: application/json (rest_client.rs:67-71);
        accept both shapes and default the scheme to https."""
        if self._ingest_host is not None:
            return self._ingest_host
        body = (await self._request(
            "GET", f"{self.account_url}/v2/streaming/hostname")).decode()
        hostname = body.strip()
        try:
            parsed = json.loads(body)
            if isinstance(parsed, dict) and parsed.get("hostname"):
                hostname = str(parsed["hostname"]).strip()
        except ValueError:
            pass
        if not hostname:
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           "snowpipe: hostname discovery returned empty "
                           "hostname")
        if not hostname.startswith(("http://", "https://")):
            hostname = f"https://{hostname}"
        self._ingest_host = hostname
        return hostname

    def _channel_url(self, db: str, schema: str, table: str,
                     channel: str, host: str) -> str:
        return (f"{host}/v2/streaming/databases/{db}/schemas/{schema}"
                f"/pipes/{_pipe_name(table)}/channels/{channel}")

    async def open_channel(self, db: str, schema: str, table: str,
                           channel: str) -> tuple[str, ChannelStatus]:
        """PUT the channel; returns (continuation_token, status). A
        non-OK channel_status_code is surfaced as an error
        (rest_client.rs:155-168)."""
        host = await self.discover_ingest_host()
        body = await self._request(
            "PUT", self._channel_url(db, schema, table, channel, host),
            json_body={"fail_on_uncommitted_rows": True})
        doc = json.loads(body)
        status_doc = doc.get("channel_status")
        if not isinstance(status_doc, dict):
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           "snowpipe: open_channel response missing "
                           "channel_status")
        code = status_doc.get("channel_status_code")
        if code is not None and code not in ("SUCCESS", "ACTIVE", "0"):
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           f"snowpipe: open_channel returned unexpected "
                           f"status: {code}")
        return (doc["next_continuation_token"],
                ChannelStatus.from_doc(status_doc, channel))

    async def insert_rows(self, db: str, schema: str, table: str,
                          channel: str, batch: RowBatch,
                          continuation_token: str) -> str:
        """POST one compressed NDJSON body; returns the next continuation
        token. The offset range rides the query string so the server can
        dedup without decompressing (rest_client.rs:182-260)."""
        host = await self.discover_ingest_host()
        url = (f"{host}/v2/streaming/data/databases/{db}/schemas/{schema}"
               f"/pipes/{_pipe_name(table)}/channels/{channel}/rows")
        body = await self._request(
            "POST", url,
            params={"continuationToken": continuation_token,
                    "startOffsetToken": batch.start_offset,
                    "endOffsetToken": batch.end_offset},
            data=batch.data,
            headers={"Content-Type": "application/x-ndjson",
                     "Content-Encoding": "zstd"})
        return json.loads(body)["next_continuation_token"]

    async def drop_channel(self, db: str, schema: str, table: str,
                           channel: str) -> None:
        host = await self.discover_ingest_host()
        await self._request(
            "DELETE", self._channel_url(db, schema, table, channel, host),
            json_body={"fail_on_uncommitted_rows": True})

    async def channel_status(self, db: str, schema: str, table: str,
                             channel: str) -> ChannelStatus:
        """POST pipes/{pipe}:bulk-channel-status for one channel
        (rest_client.rs:320-387)."""
        host = await self.discover_ingest_host()
        url = (f"{host}/v2/streaming/databases/{db}/schemas/{schema}"
               f"/pipes/{_pipe_name(table)}:bulk-channel-status")
        body = await self._request("POST", url,
                                   json_body={"channel_names": [channel]})
        statuses = json.loads(body).get("channel_statuses", {})
        for name, doc in statuses.items():
            return ChannelStatus.from_doc(doc, name)
        raise EtlError(ErrorKind.DESTINATION_FAILED,
                       "snowpipe: channel not found in status response")


# -- channel lifecycle (channel.rs) --------------------------------------------

# Maximum pending table-copy row batches / compressed bytes before a
# durability wait (channel.rs:30-40).
COPY_PENDING_MAX_ROW_BATCHES = 64
COPY_PENDING_MAX_BYTES = 256 * 1024 * 1024


@dataclass
class AcceptedBatch:
    """Row batch accepted by a channel but not yet proven committed, with
    the status baseline needed to detect server-side row rejections."""

    target_offset: str
    rows: int
    bytes: int
    baseline_rows_inserted: int
    baseline_rows_error_count: int


@dataclass
class _PendingCopyTarget:
    """Collapsed durability target: committed offsets are cumulative, so
    many accepted batches reduce to the latest offset + aggregates."""

    target_offset: str
    rows: int
    bytes: int
    row_batches: int
    baseline_rows_inserted: int
    baseline_rows_error_count: int

    def record(self, b: AcceptedBatch) -> None:
        self.target_offset = b.target_offset
        self.rows += b.rows
        self.bytes += b.bytes
        self.row_batches += 1

    def would_exceed_limits(self, batch_bytes: int) -> bool:
        return (self.row_batches + 1 > COPY_PENDING_MAX_ROW_BATCHES
                or self.bytes + batch_bytes > COPY_PENDING_MAX_BYTES)

    def as_accepted(self) -> AcceptedBatch:
        return AcceptedBatch(self.target_offset, self.rows, self.bytes,
                             self.baseline_rows_inserted,
                             self.baseline_rows_error_count)


def validate_committed_status(status: ChannelStatus,
                              accepted: AcceptedBatch) -> None:
    """Commit proof must not hide rejected rows (channel.rs:638-664): any
    new row errors past the baseline, or a committed offset that covers
    the range without the expected insert count, fails the pipeline
    closed rather than silently dropping data."""
    if status.rows_error_count > accepted.baseline_rows_error_count:
        raise EtlError(
            ErrorKind.DESTINATION_FAILED,
            f"snowpipe: channel {status.channel} rejected rows while "
            f"committing offset {accepted.target_offset}"
            + (f": {status.last_error_message}"
               if status.last_error_message else ""))
    if (status.offset_token is not None
            and status.offset_token >= accepted.target_offset):
        expected = accepted.baseline_rows_inserted + accepted.rows
        if status.rows_inserted < expected:
            raise EtlError(
                ErrorKind.DESTINATION_FAILED,
                f"snowpipe: channel {status.channel} committed offset "
                f"{accepted.target_offset} without inserting all accepted "
                f"rows: expected >= {expected}, got {status.rows_inserted}")


class ChannelHandle:
    """State and lifecycle of one Snowpipe Streaming channel: progress
    cache, continuation-token chaining, stale-token recovery, and the
    table-copy durability barrier (channel.rs:189-634).

    NOT safe under concurrent callers — the continuation token chains
    across awaits (the Rust original enforces single ownership with
    `&mut self`). Callers hold a per-channel lock; SnowflakeDestination
    keeps one per table."""

    def __init__(self, client: RestStreamClient, database: str,
                 schema: str, table: str, channel: str,
                 poll_interval_s: float = 0.5,
                 wait_timeout_s: float = 180.0):
        self.client = client
        self.database = database
        self.schema = schema
        self.table = table
        self.channel = channel
        self.poll_interval_s = poll_interval_s
        self.wait_timeout_s = wait_timeout_s
        # progress cache (channel.rs ChannelProgress)
        self.committed_offset: str | None = None
        self.rows_inserted = 0
        self.rows_error_count = 0
        self._continuation: str | None = None
        # table-copy state
        self._copy_offset_ordinal: int | None = None
        self._copy_barrier_pending = False
        self._copy_target: _PendingCopyTarget | None = None

    @property
    def is_open(self) -> bool:
        return self._continuation is not None

    def _observe(self, status: ChannelStatus) -> None:
        self.committed_offset = status.offset_token
        self.rows_inserted = status.rows_inserted
        self.rows_error_count = status.rows_error_count

    def is_offset_committed(self, offset: str) -> bool:
        return (self.committed_offset is not None
                and self.committed_offset >= offset)

    async def open(self) -> ChannelStatus:
        """Open or reopen without discarding uncommitted rows: an
        uncommitted-rows refusal waits for the server to commit instead of
        destructively reopening (channel.rs:269-298)."""
        deadline = time.monotonic() + self.wait_timeout_s
        while True:
            try:
                ct, status = await self.client.open_channel(
                    self.database, self.schema, self.table, self.channel)
            except SnowpipeWireError as e:
                if e.kind != "uncommitted_rows" \
                        or time.monotonic() >= deadline:
                    raise
                # poll status while waiting: commit progress is observed
                # (and some servers only advance commits on a status
                # read), then retry the safe open
                try:
                    await self.refresh_status()
                except (SnowpipeWireError, EtlError):
                    pass  # the PUT retry below is the real gate
                await asyncio.sleep(self.poll_interval_s)
                continue
            self._observe(status)
            self._continuation = ct
            return status

    async def drop(self) -> None:
        deadline = time.monotonic() + self.wait_timeout_s
        while True:
            try:
                await self.client.drop_channel(
                    self.database, self.schema, self.table, self.channel)
            except SnowpipeWireError as e:
                if e.kind == "channel_not_found":
                    break
                if e.kind != "uncommitted_rows" \
                        or time.monotonic() >= deadline:
                    raise
                try:
                    await self.refresh_status()
                except (SnowpipeWireError, EtlError):
                    pass
                await asyncio.sleep(self.poll_interval_s)
                continue
            break
        self.committed_offset = None
        self.rows_inserted = 0
        self.rows_error_count = 0
        self._continuation = None
        self._copy_offset_ordinal = None
        self._copy_barrier_pending = False
        self._copy_target = None

    async def reset(self) -> None:
        """Drop and reopen, clearing server-side offsets — the table-copy
        precondition (channel.rs:335-340)."""
        await self.drop()
        await self.open()

    async def refresh_status(self) -> ChannelStatus:
        status = await self.client.channel_status(
            self.database, self.schema, self.table, self.channel)
        self._observe(status)
        return status

    # -- streaming path --------------------------------------------------------

    async def accept_streaming_batches(
            self, batches: list[RowBatch]) -> list[AcceptedBatch]:
        """Send batches when no copy barrier is pending; committed batches
        are skipped, a committed offset INSIDE a batch fails closed
        (channel.rs:426-446)."""
        if self._copy_barrier_pending or self._copy_target is not None:
            raise EtlError(
                ErrorKind.DESTINATION_FAILED,
                "snowpipe: streaming cannot start before the table-copy "
                "durability barrier")
        self._copy_offset_ordinal = None
        accepted = []
        for batch in batches:
            got = await self._accept_batch(batch)
            if got is not None:
                accepted.append(got)
        return accepted

    async def wait_for_offsets_committed(self, target_offset: str,
                                         accepted: AcceptedBatch) -> None:
        """Streaming durability barrier: poll channel status until the
        committed offset covers `target_offset`, validating commit proof
        (channel.rs:495-522 applied to the streaming window)."""
        deadline = time.monotonic() + self.wait_timeout_s
        while True:
            if self.is_offset_committed(target_offset):
                return
            status = await self.refresh_status()
            validate_committed_status(status, accepted)
            if (status.offset_token is not None
                    and status.offset_token >= target_offset):
                return
            if time.monotonic() >= deadline:
                raise EtlError(
                    ErrorKind.DESTINATION_FAILED,
                    f"snowpipe: timed out waiting for offset "
                    f"{target_offset} to commit on {self.channel}")
            await asyncio.sleep(self.poll_interval_s)

    # -- table-copy path -------------------------------------------------------

    def _reserve_copy_offset(self) -> str:
        """Next attempt-local `0/N` synthetic offset; a copy may only
        start on a reset channel (channel.rs:450-473)."""
        if self._copy_offset_ordinal is None:
            if self.committed_offset is not None:
                raise EtlError(
                    ErrorKind.DESTINATION_FAILED,
                    "snowpipe: table copy must start from a reset channel")
            ordinal = 1
        else:
            self._validate_copy_committed()
            ordinal = self._copy_offset_ordinal + 1
        self._copy_offset_ordinal = ordinal
        self._copy_barrier_pending = True
        return offset_token(0, ordinal)

    def _validate_copy_committed(self) -> None:
        """A committed offset must belong to the live `0/1..0/N` copy
        sequence — anything else means the channel saw foreign writes
        (channel.rs:477-491)."""
        if self.committed_offset is None:
            return
        last = self._copy_offset_ordinal
        if last is None:
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           "snowpipe: table copy has no live offset "
                           "sequence")
        lsn, ordinal = decode_offset_token(self.committed_offset)
        if lsn != 0 or ordinal == 0 or ordinal > last:
            raise EtlError(
                ErrorKind.DESTINATION_FAILED,
                f"snowpipe: committed offset {self.committed_offset} does "
                f"not belong to the current table-copy attempt")

    async def accept_table_copy_batches(self,
                                        batches: list[RowBatch]) -> None:
        """Bounded deferred-durability window: before a batch would exceed
        the pending batch/byte limits, wait for the current cumulative
        target to commit (channel.rs:368-392)."""
        for batch in batches:
            if (self._copy_target is not None
                    and self._copy_target.would_exceed_limits(batch.size)):
                await self._wait_pending_copy_durability()
            off = self._reserve_copy_offset()
            got = await self._accept_batch(batch.with_request_offset(off))
            if got is None:
                continue
            if self._copy_target is None:
                self._copy_target = _PendingCopyTarget(
                    got.target_offset, got.rows, got.bytes, 1,
                    got.baseline_rows_inserted,
                    got.baseline_rows_error_count)
            else:
                self._copy_target.record(got)

    async def wait_for_table_copy_durability(self) -> None:
        """Terminal copy barrier; success permits streaming
        (channel.rs:401-419)."""
        if self._copy_offset_ordinal is not None:
            self._validate_copy_committed()
        elif self.committed_offset is not None:
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           "snowpipe: table copy must start from a reset "
                           "channel")
        await self._wait_pending_copy_durability()
        self._copy_barrier_pending = False

    async def _wait_pending_copy_durability(self) -> None:
        if self._copy_target is None:
            return
        deadline = time.monotonic() + self.wait_timeout_s
        accepted = self._copy_target.as_accepted()
        while True:
            status = await self.refresh_status()
            if status.offset_token is not None:
                self._validate_copy_committed()
            validate_committed_status(status, accepted)
            if (status.offset_token is not None
                    and status.offset_token >= self._copy_target.target_offset):
                self._copy_target = None
                return
            if time.monotonic() >= deadline:
                raise EtlError(
                    ErrorKind.DESTINATION_FAILED,
                    "snowpipe: timed out waiting for table-copy rows to "
                    "commit")
            await asyncio.sleep(self.poll_interval_s)

    # -- shared send path ------------------------------------------------------

    async def _accept_batch(self, batch: RowBatch) -> AcceptedBatch | None:
        """Send one batch unless progress already covers it; a stale
        continuation token reopens the channel and decides between
        already-committed, fail-closed overlap, and resend
        (channel.rs:524-619). Returns None when already committed."""
        if self._copy_barrier_pending:
            self._validate_copy_committed()
        if self.is_offset_committed(batch.end_offset):
            return None
        if self.is_offset_committed(batch.start_offset):
            raise EtlError(
                ErrorKind.DESTINATION_FAILED,
                f"snowpipe: batch {batch.start_offset}..{batch.end_offset} "
                f"overlaps committed offset {self.committed_offset}; replay "
                f"filtering should remove committed rows before batching")
        baseline_rows = self.rows_inserted
        baseline_errs = self.rows_error_count
        try:
            await self._append(batch)
        except SnowpipeWireError as e:
            if e.kind not in ("stale_continuation", "channel_not_found"):
                raise
            from ..telemetry.metrics import (
                ETL_SNOWPIPE_CHANNEL_RECOVERIES_TOTAL, registry)

            registry.counter_inc(ETL_SNOWPIPE_CHANNEL_RECOVERIES_TOTAL)
            status = await self.open()
            if self._copy_barrier_pending and status.offset_token:
                self._validate_copy_committed()
            if (status.offset_token is not None
                    and status.offset_token >= batch.end_offset):
                accepted = AcceptedBatch(batch.end_offset, batch.row_count,
                                         batch.size, baseline_rows,
                                         baseline_errs)
                validate_committed_status(status, accepted)
                return None
            if (status.offset_token is not None
                    and status.offset_token >= batch.start_offset):
                raise EtlError(
                    ErrorKind.DESTINATION_FAILED,
                    f"snowpipe: stale-channel recovery found committed "
                    f"offset {status.offset_token} inside batch "
                    f"{batch.start_offset}..{batch.end_offset}; failing "
                    f"closed for upstream replay")
            baseline_rows = self.rows_inserted
            baseline_errs = self.rows_error_count
            await self._append(batch)
        return AcceptedBatch(batch.end_offset, batch.row_count, batch.size,
                             baseline_rows, baseline_errs)

    async def _append(self, batch: RowBatch) -> None:
        if self._continuation is None:
            raise EtlError(ErrorKind.DESTINATION_FAILED,
                           "snowpipe: append on channel without "
                           "continuation token (open it first)")
        self._continuation = await self.client.insert_rows(
            self.database, self.schema, self.table, self.channel, batch,
            self._continuation)
