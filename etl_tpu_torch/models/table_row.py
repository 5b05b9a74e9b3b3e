"""Rows and columnar batches.

Copy of the reference's `etl_tpu/models/table_row.py` with one change of
storage: a text column holds a `TextArray` (Arrow-layout int32 offsets,
uint8 values and a validity mask, filled by the C `gather_string`) in
place of a pyarrow array, so the decode path needs no pyarrow. pyarrow is
imported only by `TextArray.to_arrow` and `ColumnarBatch.to_arrow`.

Reference parity: `TableRow`/`PartialTableRow`
(crates/etl/src/data/table_row.rs:15,68) and `SizeHint`
(crates/etl/src/data/size.rs) used for batch byte budgeting.
"""

from __future__ import annotations

import datetime as dt
import sys
from dataclasses import dataclass, field
from typing import Any, Iterator, Sequence

import numpy as np

from .cell import (TOAST_UNCHANGED, PgInterval, PgNumeric, PgSpecialDate,
                   PgSpecialTimestamp, PgTimeTz)
from .pgtypes import CellKind
from .schema import ColumnSchema, ReplicatedTableSchema


def value_size_hint(v: Any) -> int:
    """Approximate in-memory size of a decoded value, for batch budgeting
    (reference SizeHint, crates/etl/src/data/size.rs). Cheap, not exact."""
    if v is None or v is TOAST_UNCHANGED:
        return 8
    if isinstance(v, bool):
        return 8
    if isinstance(v, int):
        return 16
    if isinstance(v, float):
        return 16
    if isinstance(v, str):
        return 48 + len(v)
    if isinstance(v, bytes):
        return 32 + len(v)
    if isinstance(v, (dt.datetime, dt.date, dt.time)):
        return 48
    if isinstance(v, PgNumeric):
        return 64
    if isinstance(v, (list, tuple)):
        return 16 + sum(value_size_hint(x) for x in v)
    if isinstance(v, dict):
        return 64 + sum(value_size_hint(k) + value_size_hint(x) for k, x in v.items())
    return 64


#: process-wide count of TableRow constructions (mutable cell so the hot
#: path pays one list-index increment, no attribute lookup on a registry).
#: The columnar egress path never builds rows, so bench.py --smoke asserts
#: this counter's delta over the streamed CDC window is ZERO — the row
#: path creeping back into egress fails CI instead of silently eating the
#: decode speedups (ROADMAP item 2).
_ROWS_CONSTRUCTED = [0]


def rows_constructed() -> int:
    """Monotonic count of TableRow/PartialTableRow constructions."""
    return _ROWS_CONSTRUCTED[0]


class TableRow:
    """One decoded row: positional values matching a ReplicatedTableSchema's
    replicated columns (reference TableRow, data/table_row.rs:15)."""

    __slots__ = ("values", "_size_hint")

    def __init__(self, values: Sequence[Any]):
        _ROWS_CONSTRUCTED[0] += 1
        self.values = list(values)
        self._size_hint: int | None = None

    def size_hint(self) -> int:
        if self._size_hint is None:
            self._size_hint = 16 + sum(value_size_hint(v) for v in self.values)
        return self._size_hint

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, i: int) -> Any:
        return self.values[i]

    def __iter__(self) -> Iterator[Any]:
        return iter(self.values)

    def __eq__(self, other) -> bool:
        return isinstance(other, TableRow) and self.values == other.values

    def __repr__(self) -> str:
        return f"TableRow({self.values!r})"


class PartialTableRow(TableRow):
    """A row where only identity columns are populated (DELETE old tuples /
    key-only old tuples; reference PartialTableRow, table_row.rs:68).
    Non-identity positions hold None and `present` marks real values."""

    __slots__ = ("present",)

    def __init__(self, values: Sequence[Any], present: Sequence[bool]):
        super().__init__(values)
        self.present = list(present)

    def __repr__(self) -> str:
        return f"PartialTableRow({self.values!r}, present={self.present!r})"


# dtypes for the dense device-decodable kinds
_NUMPY_DTYPE: dict[CellKind, np.dtype] = {
    CellKind.BOOL: np.dtype(np.bool_),
    CellKind.I16: np.dtype(np.int16),
    CellKind.I32: np.dtype(np.int32),
    CellKind.U32: np.dtype(np.uint32),
    CellKind.I64: np.dtype(np.int64),
    CellKind.F32: np.dtype(np.float32),
    CellKind.F64: np.dtype(np.float64),
    CellKind.DATE: np.dtype(np.int32),      # days since 1970-01-01
    CellKind.TIME: np.dtype(np.int64),      # microseconds since midnight
    CellKind.TIMESTAMP: np.dtype(np.int64),  # microseconds since epoch (naive)
    CellKind.TIMESTAMPTZ: np.dtype(np.int64),  # microseconds since epoch UTC
}


def dense_dtype(kind: CellKind) -> np.dtype | None:
    """numpy dtype for kinds the device decodes densely; None for object kinds
    (strings, bytes, json, numeric-exact, arrays) which stay host-side."""
    return _NUMPY_DTYPE.get(kind)


class TextArray:
    """A string column in Arrow's layout without pyarrow: `offsets`
    int32[n + 1], `values` uint8[offsets[-1]] (UTF-8), `validity` bool[n].
    Row i is values[offsets[i]:offsets[i + 1]] where validity[i]."""

    __slots__ = ("offsets", "values", "validity")

    def __init__(self, offsets: np.ndarray, values: np.ndarray,
                 validity: np.ndarray):
        self.offsets = offsets
        self.values = values
        self.validity = validity

    def __len__(self) -> int:
        return len(self.validity)

    def __getitem__(self, i: int) -> str | None:
        if not self.validity[i]:
            return None
        return self.values[self.offsets[i]:self.offsets[i + 1]] \
            .tobytes().decode("utf-8")

    def to_pylist(self) -> list:
        return [self[i] for i in range(len(self))]

    @classmethod
    def concat(cls, parts: "Sequence[TextArray]") -> "TextArray":
        """One array holding the rows of `parts` in order."""
        offsets = [parts[0].offsets.astype(np.int64)]
        base = int(parts[0].offsets[-1])
        for p in parts[1:]:
            offsets.append(p.offsets[1:].astype(np.int64) + base)
            base += int(p.offsets[-1])
        if base >= 1 << 31:
            raise ValueError("text column past int32 offsets")
        return cls(np.concatenate(offsets).astype(np.int32),
                   np.concatenate([p.values[:p.offsets[-1]] for p in parts]),
                   np.concatenate([p.validity for p in parts]))

    def take(self, rows: np.ndarray) -> "TextArray":
        """Row-gather by index array, in Arrow layout (no Python
        objects): the values of each taken row, concatenated in order."""
        rows = np.asarray(rows, dtype=np.int64)
        lens = (self.offsets[1:] - self.offsets[:-1])[rows]
        offsets = np.zeros(len(rows) + 1, dtype=np.int32)
        np.cumsum(lens, out=offsets[1:])
        total = int(offsets[-1])
        src = np.repeat(self.offsets[rows].astype(np.int64)
                        - offsets[:-1], lens) + np.arange(total)
        return TextArray(offsets, self.values[src], self.validity[rows])

    def to_arrow(self):
        import pyarrow as pa

        n = len(self)
        return pa.StringArray.from_buffers(
            n, pa.py_buffer(self.offsets), pa.py_buffer(self.values),
            pa.array(self.validity).buffers()[1] if n else None)


@dataclass
class Column:
    """One typed column of a batch: dense numpy data + validity, or a Python
    object list for host-side kinds. `toast_unchanged[i]` marks cells whose
    value pgoutput did not re-send (TOAST 'u' kind) — distinct from NULL so
    CDC destinations can skip instead of overwrite (reference TOAST handling,
    codec/event.rs)."""

    schema: ColumnSchema
    data: Any  # np.ndarray (dense) | TextArray (text) | list (object)
    validity: np.ndarray  # bool[n], True = value present (not NULL/unchanged)
    toast_unchanged: np.ndarray | None = None  # bool[n] or None if none set
    # text columns may carry UNPARSED Postgres text for typed kinds
    # (numeric/uuid/json/…): exact for Arrow consumers, parsed lazily via
    # value(). None = data is already the final representation.
    lazy_text_oid: int | None = None

    def __len__(self) -> int:
        return len(self.validity)

    @property
    def is_dense(self) -> bool:
        return isinstance(self.data, np.ndarray)

    @property
    def is_text(self) -> bool:
        return isinstance(self.data, TextArray)

    def take(self, rows: np.ndarray) -> "Column":
        """Row-gather of this column by index array (the host half of
        publication row-filter compaction): dense data gathers as numpy,
        text as a TextArray gather (no Python objects), object lists by
        comprehension."""
        if self.is_dense or self.is_text:
            data: Any = self.data[rows] if self.is_dense \
                else self.data.take(rows)
        else:
            data = [self.data[int(i)] for i in rows]
        toast = self.toast_unchanged[rows] \
            if self.toast_unchanged is not None else None
        return Column(self.schema, data, self.validity[rows], toast,
                      lazy_text_oid=self.lazy_text_oid)

    def value(self, i: int) -> Any:
        """Python value at row i regardless of storage form."""
        if self.is_toast_unchanged(i):
            return TOAST_UNCHANGED
        if not self.validity[i]:
            return None
        if self.is_dense:
            return _from_dense(self.schema.kind, self.data[i])
        if self.is_text:
            raw = self.data[i]
            if self.lazy_text_oid is not None:
                from ..postgres.codec.text import parse_cell_text

                return parse_cell_text(raw, self.lazy_text_oid)
            return raw
        return self.data[i]

    def is_toast_unchanged(self, i: int) -> bool:
        return self.toast_unchanged is not None and bool(self.toast_unchanged[i])


class ColumnarBatch:
    """Typed columnar rows for one table — the unit the decode engine
    emits and Arrow-native destinations consume.

    `source_rows` (int64[num_rows] | None) is set by filtered decodes
    only: the staged-batch row index each surviving row came from, so
    consumers holding per-source-row side arrays can compact them to
    match.

    `device_egress` (ops/egress.py DeviceEgress | None) is attached by
    unfiltered device decodes whose render kernel turned the decoded
    words into wire text: per-column destination-ready byte buffers the
    columnar encoders splice instead of re-rendering. Row-count-
    preserving only — `take` drops it (the buffers are positional)."""

    __slots__ = ("schema", "columns", "num_rows", "source_rows",
                 "device_egress")

    def __init__(self, schema: ReplicatedTableSchema, columns: list[Column]):
        self.schema = schema
        self.columns = columns
        self.num_rows = len(columns[0]) if columns else 0
        self.source_rows: np.ndarray | None = None
        self.device_egress = None
        for c in columns:
            if len(c) != self.num_rows:
                raise ValueError("ragged columnar batch")

    def take(self, rows: np.ndarray) -> "ColumnarBatch":
        """Row-gather into a new batch (column-at-a-time, no row
        objects); `source_rows` composes through the gather when set."""
        out = ColumnarBatch(self.schema, [c.take(rows) for c in self.columns])
        if self.source_rows is not None:
            out.source_rows = self.source_rows[rows]
        return out

    @classmethod
    def concat(cls, batches: "Sequence[ColumnarBatch]") -> "ColumnarBatch":
        """Concatenate same-schema batches column-wise (the coalescing step
        of the columnar CDC write seam: consecutive same-table
        DecodedBatchEvents become ONE destination write). Dense columns
        concatenate as numpy arrays, text columns as one TextArray, object
        columns as list extend — no row objects."""
        if not batches:
            raise ValueError("concat of zero batches")
        if len(batches) == 1:
            return batches[0]
        first = batches[0]
        for b in batches[1:]:
            if b.schema is not first.schema and b.schema != first.schema:
                raise ValueError("concat across schemas")
        columns: list[Column] = []
        for j, cs in enumerate(first.schema.replicated_columns):
            parts = [b.columns[j] for b in batches]
            validity = np.concatenate([c.validity for c in parts])
            toast = None
            if any(c.toast_unchanged is not None for c in parts):
                toast = np.concatenate([
                    c.toast_unchanged if c.toast_unchanged is not None
                    else np.zeros(len(c), dtype=np.bool_) for c in parts])
            if all(c.is_dense for c in parts):
                data: Any = np.concatenate([c.data for c in parts])
                lazy = None
            elif all(c.is_text for c in parts) and len(
                    {c.lazy_text_oid for c in parts}) == 1:
                data = TextArray.concat([c.data for c in parts])
                lazy = parts[0].lazy_text_oid
            else:
                # mixed storage (e.g. a fixed-up batch next to a text
                # one): degrade to object values via each column's own
                # accessor — correctness over speed on this rare edge
                data = [c.value(i) for c in parts for i in range(len(c))]
                lazy = None
                validity = np.asarray(
                    [v is not None and v is not TOAST_UNCHANGED
                     for v in data], dtype=np.bool_)
            columns.append(Column(cs, data, validity, toast,
                                  lazy_text_oid=lazy))
        return cls(first.schema, columns)

    @classmethod
    def from_rows(cls, schema: ReplicatedTableSchema, rows: Sequence[TableRow]) -> "ColumnarBatch":
        """CPU transpose: list-of-rows → columns (the fallback for what the
        device path produces directly)."""
        return cls.from_cells(
            schema,
            [[r.values[j] for r in rows]
             for j in range(len(schema.replicated_columns))],
            len(rows))

    @classmethod
    def from_cells(cls, schema: ReplicatedTableSchema,
                   cells: Sequence[Sequence[Any]],
                   n: int) -> "ColumnarBatch":
        """Build a batch from per-COLUMN value lists (`cells[j][i]` = column
        j, row i) without ever materializing TableRow objects — the columnar
        form of `from_rows` used by the CPU-engine COPY path."""
        cols_schema = schema.replicated_columns
        columns: list[Column] = []
        for j, cs in enumerate(cols_schema):
            vals = cells[j]
            toast = np.asarray([v is TOAST_UNCHANGED for v in vals], dtype=np.bool_)
            validity = np.asarray(
                [v is not None and v is not TOAST_UNCHANGED for v in vals],
                dtype=np.bool_)
            toast_arr = toast if toast.any() else None
            dtype = dense_dtype(cs.kind)
            if dtype is not None:
                data = np.zeros(n, dtype=dtype)
                for i, v in enumerate(vals):
                    if validity[i]:
                        data[i] = _to_dense(cs.kind, v)
                columns.append(Column(cs, data, validity, toast_arr))
            else:
                columns.append(Column(
                    cs, [v if validity[i] else None for i, v in enumerate(vals)],
                    validity, toast_arr))
        return cls(schema, columns)

    def to_rows(self) -> list[TableRow]:
        return [TableRow([c.value(i) for c in self.columns])
                for i in range(self.num_rows)]

    def size_hint(self) -> int:
        total = 0
        for c in self.columns:
            if c.is_dense:
                total += c.data.nbytes + c.validity.nbytes
            else:
                total += sum(value_size_hint(v) for v in c.data)
        return total

    def to_arrow(self):
        """Convert to a pyarrow RecordBatch (zero-copy for dense columns).

        NUMERIC columns are emitted as Postgres text strings: exact at any
        precision and able to carry NaN/±Infinity, which Arrow decimal128
        cannot (same stance as the reference's BigQuery string encoding of
        numerics, bigquery/encoding.rs). TOAST-unchanged cells surface as
        nulls here; CDC writers that can skip columns should consult
        `Column.toast_unchanged` instead of using the Arrow form."""
        import pyarrow as pa

        arrays, names = [], []
        for c in self.columns:
            names.append(c.schema.name)
            mask = ~c.validity
            if c.is_text:
                arrays.append(c.data.to_arrow())
            elif c.schema.kind is CellKind.NUMERIC and not c.is_dense:
                # exact text form (numeric_mode="f64" stores dense floats
                # instead and takes the plain dense branch below)
                vals = [c.data[i].pg_text() if c.validity[i] else None
                        for i in range(self.num_rows)]
                arrays.append(pa.array(vals, type=pa.string()))
            elif c.schema.kind is CellKind.JSON:
                vals = [_json_text(c.data[i]) if c.validity[i] else None
                        for i in range(self.num_rows)]
                arrays.append(pa.array(vals, type=pa.string()))
            elif c.is_dense:
                kind = c.schema.kind
                if kind is CellKind.DATE:
                    arrays.append(pa.array(c.data, type=pa.date32(), mask=mask))
                elif kind is CellKind.TIME:
                    arrays.append(pa.array(c.data, type=pa.time64("us"), mask=mask))
                elif kind is CellKind.TIMESTAMP:
                    arrays.append(pa.array(c.data, type=pa.timestamp("us"), mask=mask))
                elif kind is CellKind.TIMESTAMPTZ:
                    arrays.append(pa.array(c.data, type=pa.timestamp("us", tz="UTC"), mask=mask))
                else:
                    arrays.append(pa.array(c.data, mask=mask))
            else:
                vals = [None if not c.validity[i] else _arrow_scalar(c.data[i])
                        for i in range(self.num_rows)]
                arrays.append(pa.array(vals))
        return pa.RecordBatch.from_arrays(arrays, names=names)


_EPOCH_DATE = dt.date(1970, 1, 1)
_EPOCH_DT = dt.datetime(1970, 1, 1)
_EPOCH_UTC = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)


_US = dt.timedelta(microseconds=1)

# Dense sentinel encodings and exact bounds of Python's datetime range in
# epoch microseconds / days. PUBLIC: the columnar destination encoders
# (bq_proto._column_cells, clickhouse._column_texts) import these so their
# special-value detection can never drift from what _from_dense decodes.
TS_INFINITY_US = 2**63 - 1
TS_NEG_INFINITY_US = -(2**63)
DATE_INFINITY_DAYS = 2**31 - 1
DATE_NEG_INFINITY_DAYS = -(2**31)
MIN_TS_US = -62_135_596_800_000_000  # 0001-01-01 00:00:00
MAX_TS_US = 253_402_300_799_999_999  # 9999-12-31 23:59:59.999999
MIN_DATE_DAYS = -719_162
MAX_DATE_DAYS = 2_932_896
_MIN_TS_US = MIN_TS_US
_MAX_TS_US = MAX_TS_US
_MIN_DATE_DAYS = MIN_DATE_DAYS
_MAX_DATE_DAYS = MAX_DATE_DAYS


def _to_dense(kind: CellKind, v: Any):
    # integer arithmetic throughout: float total_seconds() corrupts µs
    # beyond 2^53 and overflows on the datetime.max infinity sentinel
    if kind is CellKind.DATE:
        if isinstance(v, PgSpecialDate):
            return v.days
        return (v - _EPOCH_DATE).days
    if kind is CellKind.TIME:
        return ((v.hour * 60 + v.minute) * 60 + v.second) * 1_000_000 + v.microsecond
    if kind in (CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ):
        if isinstance(v, PgSpecialTimestamp):
            return v.micros
        if v.tzinfo is None:
            return (v - _EPOCH_DT) // _US
        return (v - _EPOCH_UTC) // _US
    return v


def _from_dense(kind: CellKind, v):
    if kind is CellKind.DATE:
        days = int(v)
        if days == DATE_INFINITY_DAYS:
            return PgSpecialDate(days, "infinity")
        if days == DATE_NEG_INFINITY_DAYS:
            return PgSpecialDate(days, "-infinity")
        if not _MIN_DATE_DAYS <= days <= _MAX_DATE_DAYS:
            return PgSpecialDate(days, f"<out-of-range date {days}d>")
        return _EPOCH_DATE + dt.timedelta(days=days)
    if kind is CellKind.TIME:
        us = int(v)
        s, us = divmod(us, 1_000_000)
        h, rem = divmod(s, 3600)
        m, s = divmod(rem, 60)
        return dt.time(h, m, s, us)
    if kind in (CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ):
        us = int(v)
        tz_aware = kind is CellKind.TIMESTAMPTZ
        if us == TS_INFINITY_US:
            return PgSpecialTimestamp(us, "infinity", tz_aware=tz_aware)
        if us == TS_NEG_INFINITY_US:
            return PgSpecialTimestamp(us, "-infinity", tz_aware=tz_aware)
        if not _MIN_TS_US <= us <= _MAX_TS_US:
            return PgSpecialTimestamp(us, f"<out-of-range timestamp {us}us>",
                                      tz_aware=tz_aware)
        if tz_aware:
            return _EPOCH_UTC + dt.timedelta(microseconds=us)
        return _EPOCH_DT + dt.timedelta(microseconds=us)
    if kind is CellKind.BOOL:
        return bool(v)
    if kind in (CellKind.I16, CellKind.I32, CellKind.U32, CellKind.I64):
        return int(v)
    # remaining dense kinds (floats; NUMERIC under numeric_mode="f64")
    return float(v)


def _json_text(v: Any) -> str:
    """Serialize a decoded JSON column value back to JSON text (Arrow/
    destination form). JSON_NULL is the literal `null`, distinct from SQL
    NULL which is an absent (masked) value."""
    import json

    from .cell import JSON_NULL

    if v is JSON_NULL:
        return "null"
    return json.dumps(v)


def _arrow_scalar(v: Any):
    import uuid as _uuid

    if isinstance(v, _uuid.UUID):
        # host-parsed UUID objects (the device path carries UUIDs as lazy
        # Arrow text and never reaches here): canonical string form, the
        # same rendering every destination uses
        return str(v)
    if isinstance(v, (PgSpecialDate, PgSpecialTimestamp)):
        return v.pg_text()
    if isinstance(v, PgTimeTz):
        return v.pg_text()
    if isinstance(v, PgInterval):
        return v.pg_text()
    if isinstance(v, dict):
        return _json_text(v)
    if v is TOAST_UNCHANGED:
        return None
    from .cell import JSON_NULL

    if v is JSON_NULL:
        return "null"
    return v
