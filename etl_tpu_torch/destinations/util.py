"""Shared destination helpers.

Copy of the parts of the reference's `etl_tpu/destinations/util.py` that
the ported destinations and encoders use: the background task set, the
order-preserving event program row-oriented writers consume, and the
batch-granularity CDC metadata of the columnar encoders (`_CHANGE_TYPE`
labels, `_CHANGE_SEQUENCE_NUMBER` keys) with the egress write counter,
the row-level CDC helpers and table naming the HTTP warehouse
destinations share (`change_type_label`, `require_full_row`,
`require_full_batch`, `sequence_number`, `escaped_table_name`,
`versioned_table_name`), and the error classification the poison-pill
isolation keys on (the HTTP status map, transport-exception wrapping,
`with_retries`), the lake's column-wise patch labels (`CDC_PATCH`,
`PATCH_MISSING_COLUMN`), and the Arrow builders of the lake and Iceberg
writers (`sequence_number_arrow`, `hex16_arrow`, `change_type_arrow`,
`fixed_width_string_arrow`). Each of those imports pyarrow inside, so the
module imports where pyarrow is not installed; `require_pyarrow` turns
its absence into the typed refusal the Parquet writers raise.
"""

from __future__ import annotations

import asyncio
import random
import uuid
from typing import Awaitable, Callable, TypeVar

import numpy as np

from ..models.errors import ErrorKind, EtlError
from ..models.event import ChangeType, EventSequenceKey
from ..models.schema import TableName
from ..retry import RetryPolicy

T = TypeVar("T")

# CDC metadata column names (reference bigquery/core.rs:42-45)
CHANGE_TYPE_COLUMN = "_CHANGE_TYPE"
CHANGE_SEQUENCE_COLUMN = "_CHANGE_SEQUENCE_NUMBER"

CDC_UPSERT = "UPSERT"
CDC_DELETE = "DELETE"
# column-wise partial update: only the columns NOT listed in the row's
# `_PATCH_MISSING` metadata overwrite the stored row (the lake analogue of
# reference ducklake/batches.rs UpdatedTableRow::Partial → SQL UPDATE)
CDC_PATCH = "PATCH"
PATCH_MISSING_COLUMN = "_PATCH_MISSING"


def change_type_label(ct: ChangeType) -> str:
    return CDC_DELETE if ct is ChangeType.DELETE else CDC_UPSERT


def require_full_row(destination: str, schema, row) -> None:
    """Full-row UPSERT destinations cannot preserve omitted columns: an
    update row still carrying TOAST_UNCHANGED values (source has default
    replica identity and didn't ship the old image) must fail typed rather
    than overwrite stored values with NULL (reference
    bigquery/core.rs:1477-1495 bigquery_update_new_row).
    Remedy: ALTER TABLE ... REPLICA IDENTITY FULL on the source."""
    from ..models.cell import TOAST_UNCHANGED

    if any(v is TOAST_UNCHANGED for v in row.values):
        missing = [c.name for c, v in zip(schema.replicated_columns,
                                          row.values)
                   if v is TOAST_UNCHANGED]
        raise EtlError(
            ErrorKind.SOURCE_REPLICA_IDENTITY,
            f"{destination}: update for {schema.name} omits TOASTed "
            f"column(s) {missing} (unchanged-TOAST without an old image); "
            f"full-row upsert would overwrite them with NULL. Set REPLICA "
            f"IDENTITY FULL on the source table.")


def require_full_batch(destination: str, schema, batch,
                       change_types=None) -> None:
    """Columnar-path variant of `require_full_row`: reject TOAST-unchanged
    cells in non-DELETE rows of a ColumnarBatch."""
    for c in batch.columns:
        if c.toast_unchanged is None or not c.toast_unchanged.any():
            continue
        for i in range(batch.num_rows):
            if not c.toast_unchanged[i]:
                continue
            if change_types is not None \
                    and int(change_types[i]) == int(ChangeType.DELETE):
                continue
            raise EtlError(
                ErrorKind.SOURCE_REPLICA_IDENTITY,
                f"{destination}: update for {schema.name} omits TOASTed "
                f"column {c.schema.name} (unchanged-TOAST without an old "
                f"image); full-row upsert would overwrite it with NULL. "
                f"Set REPLICA IDENTITY FULL on the source table.")


def sequence_number(key: EventSequenceKey, ordinal: int) -> str:
    """Hex ordering key commit_lsn/tx_ordinal/ordinal
    (reference bigquery/core.rs:980-996)."""
    return key.with_ordinal(ordinal)


def fast_render_error(destination: str, exc: Exception) -> EtlError:
    """A failed columnar fast render (the assembly of device-rendered
    text into a request body) as a typed error. The port's destinations
    post nothing then, where the reference's re-render host-side (ROADMAP
    caveat "Device egress is best effort in the reference, not in the
    port"); the host encoders stay a routing decision for batches that
    carry no device text."""
    return EtlError(ErrorKind.DEVICE_DECODE_FAILED,
                    f"{destination}: columnar render failed: "
                    f"{type(exc).__name__}: {exc}")


def escaped_table_name(name: TableName) -> str:
    """`schema_table` with underscores in parts doubled so the mapping is
    injective (reference table_name.rs)."""
    return (name.schema.replace("_", "__") + "_"
            + name.name.replace("_", "__"))


def versioned_table_name(base: str, generation: int) -> str:
    """Truncate-versioned successor tables `base`, `base_1`, `base_2`…
    (reference bigquery/core.rs:55-106)."""
    return base if generation == 0 else f"{base}_{generation}"


# -- batch-granularity CDC metadata (columnar egress) -------------------------
#
# The row path renders `_CHANGE_SEQUENCE_NUMBER` with an f-string per row.
# These build the same `%016x/%016x/%016x` keys for a WHOLE batch as numpy
# nibble-lookup ops: one (n, 50)-byte buffer, no per-row Python.

_HEX_DIGITS = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
_SEQ_WIDTH = 50  # 16 hex + '/' + 16 hex + '/' + 16 hex


def _hex16(arr: np.ndarray, out: np.ndarray) -> None:
    """(n,) uint64 → 16 lowercase ASCII hex bytes per value, into `out`
    (an (n, 16) uint8 view)."""
    b = np.ascontiguousarray(arr, dtype=">u8").view(np.uint8).reshape(-1, 8)
    out[:, 0::2] = _HEX_DIGITS[b >> 4]
    out[:, 1::2] = _HEX_DIGITS[b & 0x0F]


def sequence_number_buffer(commit_lsns, tx_ordinals, ordinals) -> np.ndarray:
    """Vectorized CDC sequence keys: (n, 50) uint8 buffer of
    `{commit:016x}/{tx_ordinal:016x}/{ordinal:016x}` rows — byte-identical
    to `EventSequenceKey.with_ordinal` output."""
    commit_lsns = np.asarray(commit_lsns, dtype=np.uint64)
    n = len(commit_lsns)
    out = np.empty((n, _SEQ_WIDTH), dtype=np.uint8)
    _hex16(commit_lsns, out[:, 0:16])
    out[:, 16] = ord("/")
    _hex16(np.asarray(tx_ordinals, dtype=np.uint64), out[:, 17:33])
    out[:, 33] = ord("/")
    _hex16(np.asarray(ordinals, dtype=np.uint64), out[:, 34:50])
    return out


def sequence_number_batch(commit_lsns, tx_ordinals, ordinals) -> list[bytes]:
    """Per-row sequence keys as a list of ASCII bytes (TSV/proto form)."""
    buf = sequence_number_buffer(commit_lsns, tx_ordinals, ordinals)
    return buf.reshape(-1).view(f"S{_SEQ_WIDTH}").tolist()


def sequence_number_arrow(commit_lsns, tx_ordinals, ordinals):
    """Per-row sequence keys as a pyarrow StringArray built straight from
    the fixed-width buffer (no per-row Python strings)."""
    return fixed_width_string_arrow(
        sequence_number_buffer(commit_lsns, tx_ordinals, ordinals))


def hex16_arrow(values):
    """Vectorized `{v:016x}` strings as a pyarrow StringArray (the
    Iceberg copy path's per-row sequence suffix)."""
    arr = np.asarray(values, dtype=np.uint64)
    out = np.empty((len(arr), 16), dtype=np.uint8)
    _hex16(arr, out)
    return fixed_width_string_arrow(out)


def fixed_width_string_arrow(buf: np.ndarray):
    """pyarrow StringArray from an (n, W) uint8 buffer where every row is
    exactly W bytes (the sequence-key / hex-token shape): offsets are an
    arange, values the buffer itself, so a caller that already rendered
    the buffer (the lake's watermark comparison) reuses it."""
    import pyarrow as pa

    n, width = buf.shape
    offsets = np.arange(0, (n + 1) * width, width, dtype=np.int32)
    return pa.StringArray.from_buffers(
        n, pa.py_buffer(offsets.tobytes()),
        pa.py_buffer(np.ascontiguousarray(buf).tobytes()))


def change_type_batch(change_types) -> np.ndarray:
    """Vectorized `_CHANGE_TYPE` labels for a batch: (n,) bytes array
    (S6) of UPSERT/DELETE matching `change_type_label` per row."""
    cts = np.asarray(change_types)
    return np.where(cts == int(ChangeType.DELETE),
                    np.bytes_(CDC_DELETE), np.bytes_(CDC_UPSERT))


def change_type_arrow(change_types):
    """Vectorized `_CHANGE_TYPE` labels as a pyarrow StringArray."""
    import pyarrow as pa

    return pa.array(change_type_batch(change_types).astype("U6"))


def new_uuid4(rng: "random.Random | None" = None) -> uuid.UUID:
    """A version-4 UUID: drawn from `rng` where one is given (a
    `random.Random` a test seeds), else `uuid.uuid4()`. The lake's file
    names and replay epochs, the Iceberg data files, manifests, snapshot
    ids and OCF sync markers, and the maintenance run ids draw here."""
    if rng is None:
        return uuid.uuid4()
    return uuid.UUID(int=rng.getrandbits(128), version=4)


def require_pyarrow(what: str) -> None:
    """The typed refusal of the Parquet writers: raise CONFIG_INVALID
    naming pyarrow where it cannot be imported, never a quiet
    substitute."""
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet  # noqa: F401
    except ImportError as e:
        raise EtlError(
            ErrorKind.CONFIG_INVALID,
            f"{what} writes Parquet through pyarrow, which cannot be "
            f"imported here ({e})") from None


def require_zstandard(what: str) -> None:
    """The typed refusal of the Snowpipe Streaming writers, whose row
    batches are zstd-compressed: raise CONFIG_INVALID naming zstandard
    where it cannot be imported, at construction, not at the first
    write."""
    try:
        import zstandard  # noqa: F401
    except ImportError as e:
        raise EtlError(
            ErrorKind.CONFIG_INVALID,
            f"{what} compresses its row batches through zstandard, which "
            f"cannot be imported here ({e})") from None


def count_egress_write(used_device: bool) -> None:
    """Account one columnar wire write: path=device when any field came
    from device-rendered egress buffers, path=host when every field was
    rendered host-side."""
    from ..telemetry.metrics import ETL_EGRESS_WRITES_TOTAL, registry

    registry.counter_inc(ETL_EGRESS_WRITES_TOTAL,
                         labels={"path": "device" if used_device
                                 else "host"})


# transient classification (reference retry.rs)
_RETRYABLE_HTTP = frozenset({408, 409, 429, 500, 502, 503, 504})


def http_status_retryable(status: int) -> bool:
    return status in _RETRYABLE_HTTP


def classify_http_error(destination: str, status: int,
                        text: str = "") -> "EtlError":
    """HTTP status → concrete ErrorKind — ONE classification shared by
    every HTTP destination, so permanent-vs-transient can never drift
    per sink (docs/dead-letter.md: this is the trigger signal the
    poison-isolation protocol keys on).

      retryable statuses (408/409/429/5xx)  → DESTINATION_THROTTLED
                                              (transient: writer retries
                                              in place, then the worker
                                              re-streams)
      401 / 403                             → DESTINATION_AUTH_FAILED
      404 / 410                             → DESTINATION_SCHEMA_FAILED
                                              (the table/dataset/channel
                                              the write names is gone —
                                              schema drift)
      413                                   → DESTINATION_PAYLOAD_TOO_LARGE
      every other 4xx                       → DESTINATION_REJECTED
                                              (the payload was refused:
                                              permanent for these bytes,
                                              the poison-pill kind)
    """
    if http_status_retryable(status) or status >= 500:
        kind = ErrorKind.DESTINATION_THROTTLED
    elif status in (401, 403):
        kind = ErrorKind.DESTINATION_AUTH_FAILED
    elif status in (404, 410):
        kind = ErrorKind.DESTINATION_SCHEMA_FAILED
    elif status == 413:
        kind = ErrorKind.DESTINATION_PAYLOAD_TOO_LARGE
    elif 400 <= status < 500:
        kind = ErrorKind.DESTINATION_REJECTED
    else:
        kind = ErrorKind.DESTINATION_FAILED
    return EtlError(kind, f"{destination} {status}: {text[:300]}")


def classify_write_exception(destination: str,
                             exc: BaseException) -> "EtlError":
    """Any non-EtlError escaping a destination write path → a concrete
    ErrorKind, so nothing unclassified ever reaches the retry layer
    (etl-lint rule 18 `unclassified-destination-error` enforces the
    call-site discipline). Transport failures are transient connection
    kinds; everything else is the ambiguous DESTINATION_FAILED."""
    if isinstance(exc, EtlError):
        return exc
    if isinstance(exc, (asyncio.TimeoutError, TimeoutError)):
        return EtlError(ErrorKind.TIMEOUT,
                        f"{destination}: {exc!r}")
    if isinstance(exc, (ConnectionError, OSError, EOFError,
                        asyncio.IncompleteReadError)):
        return EtlError(ErrorKind.DESTINATION_CONNECTION_FAILED,
                        f"{destination}: {exc!r}")
    try:
        import aiohttp

        if isinstance(exc, aiohttp.ClientError):
            return EtlError(ErrorKind.DESTINATION_CONNECTION_FAILED,
                            f"{destination}: {exc!r}")
    except ImportError:  # aiohttp-less deployments (lake/iceberg only)
        pass
    return EtlError(ErrorKind.DESTINATION_FAILED,
                    f"{destination}: {exc!r}")


class DestinationRetryPolicy(RetryPolicy):
    """Writer-scoped alias of the unified RetryPolicy (retry.py):
    in-place retries for transient transport/capacity errors only
    (DESTINATION_TRANSIENT_KINDS) — rejected payloads escalate to the
    worker retry loop, which re-streams from durable progress."""


async def with_retries(op: Callable[[], Awaitable[T]],
                       policy: RetryPolicy,
                       retryable: "Callable[[BaseException], bool] | None"
                       = None, destination: str = "destination") -> T:
    """Classify-and-backoff retry wrapper (reference retry.rs:classify).
    Delegates to RetryPolicy.execute; `retryable=None` uses the policy's
    own per-ErrorKind classification. Whatever finally escapes is
    GUARANTEED to be an EtlError with a concrete kind: a raw transport
    exception surviving the in-place retries wraps through
    `classify_write_exception` instead of reaching the worker retry
    layer bare (the poison-isolation trigger contract)."""
    try:
        return await policy.execute(op, retryable)
    except (asyncio.CancelledError, EtlError):
        raise
    except Exception as e:
        # Exception, NOT BaseException: KeyboardInterrupt/SystemExit
        # must terminate the process, not become retryable
        # destination failures
        if type(e).__module__.partition(".")[0] == "etl_tpu_torch":
            # internal control-flow exceptions (runtime.shutdown.
            # ShutdownRequested, and those of destinations to come) are
            # caught-and-handled by their own call sites — wrapping them
            # would break those protocols, and they never reach the
            # worker retry layer
            raise
        raise classify_write_exception(destination, e) from e


class TaskSet:
    """Background destination tasks with joined shutdown
    (reference concurrency/task_set.rs)."""

    def __init__(self) -> None:
        self._tasks: set[asyncio.Task] = set()

    def spawn(self, coro) -> asyncio.Task:
        t = asyncio.ensure_future(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return t

    async def join(self) -> None:
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)

    async def cancel_all(self) -> None:
        for t in list(self._tasks):
            t.cancel()
        await self.join()


def _identity_values(schema, row):
    """Identity-column values of a row, in replicated order."""
    idx = schema.replicated_indices
    identity = schema.identity_mask
    return tuple(v for i, v in enumerate(row.values) if identity[idx[i]])


def split_key_changing_update(e):
    """An UPDATE whose old image shows a different replica identity leaves
    the old-identity row stale in upsert-keyed destinations. Emit
    DELETE(old identity) + the update, mirroring reference
    ducklake/batches.rs `Full → Delete{origin: update} + Upsert`
    (key-changing updates would otherwise leave duplicate rows in
    _current views). Returns [events…] to apply in order."""
    from ..models.event import DeleteEvent, UpdateEvent

    if not isinstance(e, UpdateEvent) or e.old_row is None:
        return [e]
    if _identity_values(e.schema, e.old_row) == \
            _identity_values(e.schema, e.row):
        return [e]
    return [DeleteEvent(e.start_lsn, e.commit_lsn, e.tx_ordinal, e.schema,
                        e.old_row), e]


def sequential_event_program(events):
    """Order-preserving destination program: yields ("rows", schema, [row
    events…]) runs and ("truncate", event) / ("schema_change", event)
    barriers, splitting runs so WAL order is preserved — rows preceding a
    truncate in the batch must land before it executes. Key-changing
    updates expand to DELETE(old identity) + update.

    Accepts expanded per-row events (use expand_batch_events first)."""
    from ..models.event import (DeleteEvent, InsertEvent, SchemaChangeEvent,
                                TruncateEvent, UpdateEvent)

    run_schema = None
    run: list = []
    flat = (e for outer in events
            for e in (split_key_changing_update(outer)
                      if isinstance(outer, UpdateEvent) else (outer,)))
    for e in flat:
        if isinstance(e, (InsertEvent, UpdateEvent, DeleteEvent)):
            if run_schema is not None and (run_schema.id != e.schema.id
                                           or run_schema != e.schema):
                yield ("rows", run_schema, run)
                run = []
            run_schema = e.schema
            run.append(e)
        elif isinstance(e, (TruncateEvent, SchemaChangeEvent)):
            if run:
                yield ("rows", run_schema, run)
                run, run_schema = [], None
            if isinstance(e, TruncateEvent):
                yield ("truncate", e)
            elif e.new_schema is not None:
                yield ("schema_change", e)
        # Begin/Commit/Relation: ordering barriers with no destination op
    if run:
        yield ("rows", run_schema, run)
