"""BigQuery Storage Write API wire format.

Copy of the reference's `etl_tpu/destinations/bq_proto.py`: the protobuf
primitives, the row descriptor, the per-row `encode_row`
and the columnar `encode_batch`, byte-identical to it, whose string-typed
DATE cells take the device-rendered text where a `DeviceEgress` rode the
batch. Text columns are read from the port's `TextArray`. Also the
generic TLV parse and the AppendRows request/response framing (encode and
decode, `google.rpc.Status` with embedded `StorageError` details) that the
BigQuery destination posts and the Storage Write fake decodes.

Transport note (as in the reference): no gRPC stack, so the client POSTs
the serialized AppendRowsRequest as `application/x-protobuf` and receives
a serialized AppendRowsResponse.

Scalar encodings mirror the reference's encoding.rs:120-186: bool→varint,
i16/i32→int32 varint, i64→int64 varint, u32→uint32 varint, f32→fixed32,
f64→fixed64, timestamptz→int64 micros, and everything date/time/numeric/
uuid/json/interval renders to its Postgres text and encodes as a string.
"""

from __future__ import annotations

import datetime as dt
import struct
from dataclasses import dataclass, field

from ..analysis.annotations import hot_loop
from ..models.cell import (JSON_NULL, PgInterval, PgNumeric, PgSpecialDate,
                           PgSpecialTimestamp, PgTimeTz, TOAST_UNCHANGED)
from ..models.errors import ErrorKind, EtlError
from ..models.pgtypes import CellKind, array_element
from ..models.schema import ReplicatedTableSchema
# dense timestamptz sentinels/bounds — the SAME objects _from_dense
# decodes with, so detection can never drift from Column.value()
from ..models.table_row import (DATE_INFINITY_DAYS as _DATE_INF,
                                DATE_NEG_INFINITY_DAYS as _DATE_NEG_INF,
                                MAX_DATE_DAYS as _MAX_DATE_DAYS,
                                MAX_TS_US as _MAX_TS_US,
                                MIN_DATE_DAYS as _MIN_DATE_DAYS,
                                MIN_TS_US as _MIN_TS_US,
                                TS_INFINITY_US as _TS_INF,
                                TS_NEG_INFINITY_US as _TS_NEG_INF)

# -- protobuf primitives -----------------------------------------------------

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_LEN = 2
_WIRE_FIXED32 = 5


def _varint(n: int) -> bytes:
    """Unsigned LEB128. Negative int32/int64 values must be passed already
    masked to 64 bits (protobuf sign-extends them to 10 bytes)."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _signed(n: int) -> int:
    """Two's-complement 64-bit mask for int32/int64 varint encoding."""
    return n & 0xFFFFFFFFFFFFFFFF


def _key(field_no: int, wire: int) -> bytes:
    return _varint((field_no << 3) | wire)


def f_varint(field_no: int, value: int) -> bytes:
    return _key(field_no, _WIRE_VARINT) + _varint(value)


def f_int(field_no: int, value: int) -> bytes:
    return _key(field_no, _WIRE_VARINT) + _varint(_signed(value))


def f_bytes(field_no: int, data: bytes) -> bytes:
    return _key(field_no, _WIRE_LEN) + _varint(len(data)) + data


def f_string(field_no: int, s: str) -> bytes:
    return f_bytes(field_no, s.encode("utf-8"))


def f_double(field_no: int, v: float) -> bytes:
    return _key(field_no, _WIRE_FIXED64) + struct.pack("<d", v)


def f_float(field_no: int, v: float) -> bytes:
    return _key(field_no, _WIRE_FIXED32) + struct.pack("<f", v)


def parse_message(data: bytes) -> dict[int, list[tuple[int, object]]]:
    """Generic TLV parse: field_no → [(wire_type, value)]. LEN fields give
    bytes; varints give ints; fixed32/64 give raw 4/8 bytes."""
    out: dict[int, list[tuple[int, object]]] = {}
    i, n = 0, len(data)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field_no, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            v = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            value: object = v
        elif wire == _WIRE_LEN:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            value = data[i : i + ln]
            i += ln
        elif wire == _WIRE_FIXED64:
            value = data[i : i + 8]
            i += 8
        elif wire == _WIRE_FIXED32:
            value = data[i : i + 4]
            i += 4
        else:
            raise EtlError(ErrorKind.SERIALIZATION_FAILED,
                           f"unsupported protobuf wire type {wire}")
        out.setdefault(field_no, []).append((wire, value))
    return out


def _first_bytes(msg: dict, field_no: int, default: bytes = b"") -> bytes:
    vals = msg.get(field_no)
    return vals[0][1] if vals else default  # type: ignore[return-value]


def _first_int(msg: dict, field_no: int, default: int = 0) -> int:
    vals = msg.get(field_no)
    return vals[0][1] if vals else default  # type: ignore[return-value]


def _to_i64(v: int) -> int:
    """Undo 64-bit two's complement from a decoded varint."""
    return v - (1 << 64) if v >= (1 << 63) else v


# -- descriptor (ProtoSchema) ------------------------------------------------

# FieldDescriptorProto.Type values
_T_DOUBLE, _T_FLOAT, _T_INT64, _T_INT32 = 1, 2, 3, 5
_T_BOOL, _T_STRING, _T_BYTES, _T_UINT32 = 8, 9, 12, 13
_L_OPTIONAL, _L_REPEATED = 1, 3

CHANGE_TYPE_FIELD = "_CHANGE_TYPE"
CHANGE_SEQUENCE_FIELD = "_CHANGE_SEQUENCE_NUMBER"

# reference schema.rs:246-267 (ColumnType per Postgres type): ints widen to
# int32/int64, floats stay native, timestamptz is instant micros (int64),
# every civil/textual kind is a string, bytea stays bytes
_PROTO_TYPE: dict[CellKind, int] = {
    CellKind.BOOL: _T_BOOL,
    CellKind.I16: _T_INT32, CellKind.I32: _T_INT32,
    CellKind.U32: _T_UINT32, CellKind.I64: _T_INT64,
    CellKind.F32: _T_FLOAT, CellKind.F64: _T_DOUBLE,
    CellKind.TIMESTAMPTZ: _T_INT64,
    CellKind.BYTES: _T_BYTES,
}


def _field_descriptor(name: str, number: int, ftype: int,
                      label: int = _L_OPTIONAL) -> bytes:
    # FieldDescriptorProto: name=1, number=3, label=4, type=5
    return (f_string(1, name) + f_int(3, number) + f_varint(4, label)
            + f_varint(5, ftype))


def row_descriptor(schema: ReplicatedTableSchema,
                   msg_name: str = "TableRow") -> bytes:
    """Serialized DescriptorProto for one table's append rows: data columns
    at ordinal+1, then the two CDC pseudo-columns."""
    fields = []
    for i, col in enumerate(schema.replicated_columns):
        if col.kind is CellKind.ARRAY:
            elem = array_element(col.type_oid)
            etype = _PROTO_TYPE.get(elem[1], _T_STRING) if elem else _T_STRING
            fields.append(_field_descriptor(col.name, i + 1, etype,
                                            _L_REPEATED))
        else:
            fields.append(_field_descriptor(
                col.name, i + 1, _PROTO_TYPE.get(col.kind, _T_STRING)))
    n = len(schema.replicated_columns)
    fields.append(_field_descriptor(CHANGE_TYPE_FIELD, n + 1, _T_STRING))
    fields.append(_field_descriptor(CHANGE_SEQUENCE_FIELD, n + 2, _T_STRING))
    # DescriptorProto: name=1, field=2 (repeated)
    return f_string(1, msg_name) + b"".join(f_bytes(2, f) for f in fields)


# -- row encoding ------------------------------------------------------------


def _text(v) -> str:
    """Postgres text rendering for string-typed proto fields (mirrors the
    Cell::to-string forms of encoding.rs)."""
    if v is JSON_NULL:
        return "null"
    if isinstance(v, (PgNumeric, PgTimeTz, PgInterval, PgSpecialDate,
                      PgSpecialTimestamp)):
        return v.pg_text()
    if isinstance(v, dt.datetime):
        return v.isoformat(sep=" ")
    if isinstance(v, (dt.date, dt.time)):
        return v.isoformat()
    if isinstance(v, (dict, list)):
        import json as _json

        return _json.dumps(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


_EPOCH_UTC = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)
_US = dt.timedelta(microseconds=1)


def _tstz_micros(v) -> int:
    """Instant micros for a TIMESTAMPTZ proto field (declared TYPE_INT64 in
    the descriptor). Values with no instant representation — 'infinity' /
    '-infinity' specials — fail fast with a typed error, the reference's
    validate-then-encode stance (validation.rs): emitting a string here
    would violate the carried writer schema.

    Integer arithmetic, not `timestamp()*1e6`: float64 seconds resolve to
    ~0.2 µs at the 2024 epoch, so the float round-trip can flip the last
    microsecond — and the columnar encoder emits the decode engine's EXACT
    stored micros, which the row path must match bit-for-bit."""
    if isinstance(v, dt.datetime):
        if v.tzinfo is None:  # decode always attaches a zone; be safe
            v = v.replace(tzinfo=dt.timezone.utc)
        return (v - _EPOCH_UTC) // _US
    raise EtlError(
        ErrorKind.ROW_CONVERSION_FAILED,
        f"timestamptz value {v!r} has no instant representation for "
        "BigQuery TIMESTAMP (int64 micros)")


def _encode_scalar(tag: int, kind: CellKind, v, out: bytearray) -> None:
    if kind is CellKind.BOOL:
        out += f_varint(tag, 1 if v else 0)
    elif kind in (CellKind.I16, CellKind.I32, CellKind.I64):
        out += f_int(tag, int(v))
    elif kind is CellKind.U32:
        out += f_varint(tag, int(v))
    elif kind is CellKind.F32:
        out += f_float(tag, float(v))
    elif kind is CellKind.F64:
        out += f_double(tag, float(v))
    elif kind is CellKind.TIMESTAMPTZ:
        out += f_int(tag, _tstz_micros(v))
    elif kind is CellKind.BYTES:
        out += f_bytes(tag, bytes(v))
    else:
        out += f_string(tag, _text(v))


_PACKED_KINDS = frozenset({CellKind.BOOL, CellKind.I16, CellKind.I32,
                           CellKind.U32, CellKind.I64, CellKind.F32,
                           CellKind.F64, CellKind.TIMESTAMPTZ})


def _encode_array(tag: int, elem_kind: CellKind, values, out: bytearray,
                  col_name: str) -> None:
    for v in values:
        if v is None:
            raise EtlError(
                ErrorKind.ROW_CONVERSION_FAILED,
                f"array column {col_name} contains a NULL element: "
                "BigQuery REPEATED fields cannot hold NULLs")
    if elem_kind in _PACKED_KINDS and elem_kind not in (CellKind.F32,
                                                        CellKind.F64):
        payload = bytearray()
        for v in values:
            if elem_kind is CellKind.BOOL:
                payload += _varint(1 if v else 0)
            elif elem_kind is CellKind.TIMESTAMPTZ:
                payload += _varint(_signed(_tstz_micros(v)))
            elif elem_kind is CellKind.U32:
                payload += _varint(int(v))
            else:
                payload += _varint(_signed(int(v)))
        out += f_bytes(tag, bytes(payload))
    elif elem_kind is CellKind.F64:
        out += f_bytes(tag, b"".join(struct.pack("<d", float(v))
                                     for v in values))
    elif elem_kind is CellKind.F32:
        out += f_bytes(tag, b"".join(struct.pack("<f", float(v))
                                     for v in values))
    else:  # strings are repeated, never packed
        for v in values:
            out += f_string(tag, _text(v))


def encode_row(schema: ReplicatedTableSchema, values,
               change_type: str, change_sequence: str) -> bytes:
    """One append row: proto message bytes, NULLs omitted (proto3 absence),
    CDC columns last (core.rs:980-996)."""
    out = bytearray()
    cols = schema.replicated_columns
    for i, (col, v) in enumerate(zip(cols, values)):
        if v is None or v is TOAST_UNCHANGED:
            continue
        if col.kind is CellKind.ARRAY:
            elem = array_element(col.type_oid)
            _encode_array(i + 1, elem[1] if elem else CellKind.STRING,
                          v, out, col.name)
        else:
            _encode_scalar(i + 1, col.kind, v, out)
    n = len(cols)
    out += f_string(n + 1, change_type)
    out += f_string(n + 2, change_sequence)
    return bytes(out)


# -- columnar batch encoding (egress hot path) --------------------------------
#
# encode_row materializes a Python value per cell (Column.value boxes dense
# numpy scalars into datetimes/ints) and re-dispatches on CellKind per cell.
# encode_batch serializes column-at-a-time: one kind dispatch per COLUMN,
# dense numpy data encoded straight from the array (ints via tolist —
# already Python ints, no _from_dense boxing; floats sliced out of one
# astype().tobytes() blob; text columns sliced out of their TextArray
# value buffer without creating str objects). Output is byte-identical to
# encode_row over the expanded rows — asserted by the parity suite.

@hot_loop
def _column_cells(col, tag: int, dev=None, untrusted=None) -> list:
    """Encoded proto field bytes per row for one column (None = absent:
    NULL / TOAST-unchanged cells are omitted, proto3 absence). `dev` is
    the column's device-rendered text buffer (ops/egress.py DeviceEgress
    field) when one rode the decoded batch — consumed for the
    string-typed DATE field below, ignored for binary wire types.
    @hot_loop: runs per column per CDC flush — row materialization here
    would undo the columnar egress win (etl-lint rule 13)."""
    import numpy as np

    n = len(col)
    kind = col.schema.kind
    valid = col.validity
    if col.toast_unchanged is not None:
        valid = valid & ~col.toast_unchanged
    cells: list = [None] * n
    present = np.flatnonzero(valid)
    if present.size == 0:
        return cells
    if dev is not None and kind is CellKind.DATE and col.is_dense:
        # device-rendered ISO dates → f_string cells; specials /
        # out-of-range rows (never device-rendered, see egress module
        # docstring) drop to the generic per-value path below
        data = col.data
        ok = ((data != _DATE_INF) & (data != _DATE_NEG_INF)
              & (data >= _MIN_DATE_DAYS) & (data <= _MAX_DATE_DAYS))
        if untrusted is not None and untrusted.size:
            ok = ok.copy()
            ok[untrusted] = False  # fixed up after the device render
        key = _key(tag, _WIRE_LEN)
        buf, lens = dev
        blob = bytes(np.ascontiguousarray(buf).reshape(-1))
        width = buf.shape[1]
        for i in present.tolist():
            if ok[i]:
                ln = int(lens[i])
                cells[i] = key + _varint(ln) \
                    + blob[i * width:i * width + ln]
            else:
                out = bytearray()
                _encode_scalar(tag, kind, col.value(i), out)
                cells[i] = bytes(out)
        return cells
    if col.is_dense and kind is CellKind.BOOL:
        t1 = _key(tag, _WIRE_VARINT) + b"\x01"
        t0 = _key(tag, _WIRE_VARINT) + b"\x00"
        data = col.data
        for i in present.tolist():
            cells[i] = t1 if data[i] else t0
        return cells
    if col.is_dense and kind in (CellKind.I16, CellKind.I32, CellKind.I64):
        prefix = _key(tag, _WIRE_VARINT)
        data = col.data.tolist()
        for i in present.tolist():
            cells[i] = prefix + _varint(data[i] & 0xFFFFFFFFFFFFFFFF)
        return cells
    if col.is_dense and kind is CellKind.U32:
        prefix = _key(tag, _WIRE_VARINT)
        data = col.data.tolist()
        for i in present.tolist():
            cells[i] = prefix + _varint(data[i])
        return cells
    if col.is_dense and kind is CellKind.F64:
        prefix = _key(tag, _WIRE_FIXED64)
        blob = col.data.astype("<f8", copy=False).tobytes()
        for i in present.tolist():
            cells[i] = prefix + blob[8 * i : 8 * i + 8]
        return cells
    if col.is_dense and kind is CellKind.F32:
        prefix = _key(tag, _WIRE_FIXED32)
        blob = col.data.astype("<f4", copy=False).tobytes()
        for i in present.tolist():
            cells[i] = prefix + blob[4 * i : 4 * i + 4]
        return cells
    if col.is_dense and kind is CellKind.TIMESTAMPTZ:
        data = col.data
        sel = data[present]
        bad = ((sel == _TS_INF) | (sel == _TS_NEG_INF)
               | (sel < _MIN_TS_US) | (sel > _MAX_TS_US))
        if bad.any():
            i = int(present[np.flatnonzero(bad)[0]])
            _tstz_micros(col.value(i))  # raises the typed error
        prefix = _key(tag, _WIRE_VARINT)
        vals = data.tolist()
        for i in present.tolist():
            cells[i] = prefix + _varint(vals[i] & 0xFFFFFFFFFFFFFFFF)
        return cells
    if col.is_text and kind is CellKind.STRING and col.lazy_text_oid is None:
        from_text = _text_string_cells(col.data, tag, n)
        for i in present.tolist():
            cells[i] = from_text[i]
        return cells
    # generic fallback: box the value and reuse the row-path encoders
    # (NUMERIC/DATE/TIME/TIMESTAMP/JSON/ARRAY/lazy-text columns — exotic
    # kinds keep exact row-path semantics)
    elem = array_element(col.schema.type_oid) if kind is CellKind.ARRAY \
        else None
    for i in present.tolist():
        v = col.value(i)
        if v is None or v is TOAST_UNCHANGED:
            continue
        out = bytearray()
        if kind is CellKind.ARRAY:
            _encode_array(tag, elem[1] if elem else CellKind.STRING, v, out,
                          col.schema.name)
        else:
            _encode_scalar(tag, kind, v, out)
        cells[i] = bytes(out)
    return cells


def _text_string_cells(arr, tag: int, n: int) -> list:
    """Encoded f_string cells straight from a TextArray's value buffer
    (no per-row str objects)."""
    data = arr.values.tobytes()
    cells = [None] * n
    key = _key(tag, _WIRE_LEN)
    o = arr.offsets.tolist()
    for i in range(n):
        lo, hi = o[i], o[i + 1]
        cells[i] = key + _varint(hi - lo) + data[lo:hi]
    return cells


@hot_loop
def encode_batch(schema: ReplicatedTableSchema, batch,
                 change_types: list, change_sequences: list,
                 egress=None) -> list[bytes]:
    """Columnar AppendRows encoding: one serialized proto row per batch
    row, fields in column order then the two CDC pseudo-columns —
    byte-identical to per-row `encode_row` over the same values.
    `change_types` / `change_sequences` are per-row ASCII bytes (see
    util.change_type_batch / util.sequence_number_batch).
    @hot_loop: the BigQuery egress hot path (etl-lint rule 13 guards the
    row path out of it)."""
    n = batch.num_rows
    cols = schema.replicated_columns
    bufs = [bytearray() for _ in range(n)]
    for j, col in enumerate(batch.columns):
        dev = egress.field(j) if egress is not None else None
        cells = _column_cells(col, j + 1, dev,
                              egress.untrusted if egress is not None
                              else None)
        for i, cell in enumerate(cells):
            if cell is not None:
                bufs[i] += cell
    nc = len(cols)
    ct_key = _key(nc + 1, _WIRE_LEN)
    seq_key = _key(nc + 2, _WIRE_LEN)
    out = []
    for i in range(n):
        b = bufs[i]
        ct = change_types[i]
        seq = change_sequences[i]
        b += ct_key + _varint(len(ct)) + ct
        b += seq_key + _varint(len(seq)) + seq
        out.append(bytes(b))
    return out


# -- AppendRows request/response ---------------------------------------------

STORAGE_ERROR_TYPE_URL = (
    "type.googleapis.com/google.cloud.bigquery.storage.v1.StorageError")

# google.cloud.bigquery.storage.v1.StorageError.StorageErrorCode
STORAGE_ERROR_TABLE_NOT_FOUND = 1
STORAGE_ERROR_SCHEMA_MISMATCH_EXTRA_FIELDS = 7

# gRPC status codes (google.rpc.Code)
GRPC_OK = 0
GRPC_CANCELLED = 1
GRPC_INVALID_ARGUMENT = 3
GRPC_DEADLINE_EXCEEDED = 4
GRPC_NOT_FOUND = 5
GRPC_PERMISSION_DENIED = 7
GRPC_RESOURCE_EXHAUSTED = 8
GRPC_FAILED_PRECONDITION = 9
GRPC_ABORTED = 10
GRPC_INTERNAL = 13
GRPC_UNAVAILABLE = 14
GRPC_UNAUTHENTICATED = 16


def append_rows_request(write_stream: str, descriptor: bytes,
                        rows: list[bytes], trace_id: str,
                        offset: int | None = None) -> bytes:
    """Serialized AppendRowsRequest: write_stream=1, offset=2 (Int64Value),
    proto_rows=4 (writer_schema.proto_descriptor + rows.serialized_rows),
    trace_id=6."""
    proto_schema = f_bytes(1, descriptor)  # ProtoSchema.proto_descriptor=1
    proto_rows = b"".join(f_bytes(1, r) for r in rows)  # ProtoRows
    proto_data = f_bytes(1, proto_schema) + f_bytes(2, proto_rows)
    out = f_string(1, write_stream)
    if offset is not None:
        out += f_bytes(2, f_int(1, offset))  # google.protobuf.Int64Value
    out += f_bytes(4, proto_data)
    out += f_string(6, trace_id)
    return out


@dataclass
class DecodedAppendRequest:
    """Fake-server view of one AppendRowsRequest."""

    write_stream: str
    trace_id: str
    descriptor_fields: list[tuple[str, int, int, int]]  # name, number, label, type
    serialized_rows: list[bytes]
    offset: int | None = None

    def decode_rows(self) -> list[dict[str, object]]:
        """Decode each row against the carried descriptor — the framing
        validation a real Storage Write backend performs."""
        by_number = {num: (name, label, ftype)
                     for name, num, label, ftype in self.descriptor_fields}
        rows = []
        for raw in self.serialized_rows:
            msg = parse_message(raw)
            doc: dict[str, object] = {}
            for num, entries in msg.items():
                if num not in by_number:
                    raise EtlError(
                        ErrorKind.SERIALIZATION_FAILED,
                        f"append row has field {num} absent from the "
                        "writer schema")
                name, label, ftype = by_number[num]
                vals = []
                for wire, value in entries:
                    if ftype in (_T_STRING,):
                        vals.append(value.decode("utf-8"))  # type: ignore
                    elif ftype is _T_BYTES:
                        if label == _L_REPEATED and wire == _WIRE_LEN:
                            vals.append(value)
                        else:
                            vals.append(value)
                    elif ftype in (_T_INT32, _T_INT64):
                        if label == _L_REPEATED and wire == _WIRE_LEN:
                            vals.extend(_unpack_varints(value, signed=True))
                        else:
                            vals.append(_to_i64(value))  # type: ignore
                    elif ftype is _T_UINT32:
                        if label == _L_REPEATED and wire == _WIRE_LEN:
                            vals.extend(_unpack_varints(value, signed=False))
                        else:
                            vals.append(value)
                    elif ftype is _T_BOOL:
                        if label == _L_REPEATED and wire == _WIRE_LEN:
                            vals.extend(bool(x) for x in
                                        _unpack_varints(value, signed=False))
                        else:
                            vals.append(bool(value))
                    elif ftype is _T_DOUBLE:
                        if wire == _WIRE_LEN:  # packed
                            vals.extend(struct.unpack(
                                f"<{len(value)//8}d", value))
                        else:
                            vals.append(struct.unpack("<d", value)[0])
                    elif ftype is _T_FLOAT:
                        if wire == _WIRE_LEN:
                            vals.extend(struct.unpack(
                                f"<{len(value)//4}f", value))
                        else:
                            vals.append(struct.unpack("<f", value)[0])
                    else:
                        vals.append(value)
                doc[name] = vals if label == _L_REPEATED or len(vals) > 1 \
                    else vals[0]
            rows.append(doc)
        return rows


def _unpack_varints(data: bytes, signed: bool) -> list[int]:
    out = []
    i, n = 0, len(data)
    while i < n:
        v = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        out.append(_to_i64(v) if signed else v)
    return out


def decode_append_rows_request(data: bytes) -> DecodedAppendRequest:
    msg = parse_message(data)
    write_stream = _first_bytes(msg, 1).decode("utf-8")
    trace_id = _first_bytes(msg, 6).decode("utf-8")
    offset = None
    if 2 in msg:
        offset = _to_i64(_first_int(parse_message(_first_bytes(msg, 2)), 1))
    fields: list[tuple[str, int, int, int]] = []
    serialized: list[bytes] = []
    if 4 in msg:
        proto_data = parse_message(_first_bytes(msg, 4))
        if 1 in proto_data:  # writer_schema
            schema_msg = parse_message(_first_bytes(proto_data, 1))
            descriptor = parse_message(_first_bytes(schema_msg, 1))
            for _, fd in descriptor.get(2, []):
                f = parse_message(fd)  # type: ignore[arg-type]
                fields.append((
                    _first_bytes(f, 1).decode("utf-8"),
                    _to_i64(_first_int(f, 3)),
                    _first_int(f, 4, _L_OPTIONAL),
                    _first_int(f, 5, _T_STRING)))
        if 2 in proto_data:  # rows
            rows_msg = parse_message(_first_bytes(proto_data, 2))
            serialized = [v for _, v in rows_msg.get(1, [])]  # type: ignore
    return DecodedAppendRequest(write_stream=write_stream, trace_id=trace_id,
                                descriptor_fields=fields,
                                serialized_rows=serialized, offset=offset)


@dataclass
class RowError:
    index: int
    code: int
    message: str


@dataclass
class RpcStatus:
    code: int
    message: str
    storage_error_codes: list[int] = field(default_factory=list)


@dataclass
class AppendResponse:
    offset: int | None = None
    error: RpcStatus | None = None
    row_errors: list[RowError] = field(default_factory=list)


def encode_rpc_status(code: int, message: str,
                      storage_error_code: int | None = None) -> bytes:
    out = f_int(1, code) + f_string(2, message)
    if storage_error_code is not None:
        detail = f_varint(1, storage_error_code) + f_string(3, message)
        any_msg = f_string(1, STORAGE_ERROR_TYPE_URL) + f_bytes(2, detail)
        out += f_bytes(3, any_msg)
    return out


def encode_append_rows_response(offset: int | None = None,
                                error: bytes | None = None,
                                row_errors: list[RowError] | None = None
                                ) -> bytes:
    out = b""
    if offset is not None:
        out += f_bytes(1, f_bytes(1, f_int(1, offset)))  # AppendResult
    if error is not None:
        out += f_bytes(2, error)
    for re in row_errors or []:
        out += f_bytes(4, f_int(1, re.index) + f_varint(2, re.code)
                       + f_string(3, re.message))
    return out


def decode_append_rows_response(data: bytes) -> AppendResponse:
    msg = parse_message(data)
    resp = AppendResponse()
    if 1 in msg:
        result = parse_message(_first_bytes(msg, 1))
        if 1 in result:
            resp.offset = _to_i64(
                _first_int(parse_message(_first_bytes(result, 1)), 1))
    if 2 in msg:
        status = parse_message(_first_bytes(msg, 2))
        codes = []
        for _, any_bytes in status.get(3, []):
            any_msg = parse_message(any_bytes)  # type: ignore[arg-type]
            if _first_bytes(any_msg, 1).decode("utf-8") \
                    == STORAGE_ERROR_TYPE_URL:
                storage_err = parse_message(_first_bytes(any_msg, 2))
                codes.append(_first_int(storage_err, 1))
        resp.error = RpcStatus(
            code=_to_i64(_first_int(status, 1)),
            message=_first_bytes(status, 2).decode("utf-8"),
            storage_error_codes=codes)
    for _, re_bytes in msg.get(4, []):
        re_msg = parse_message(re_bytes)  # type: ignore[arg-type]
        resp.row_errors.append(RowError(
            index=_to_i64(_first_int(re_msg, 1)),
            code=_first_int(re_msg, 2),
            message=_first_bytes(re_msg, 3).decode("utf-8")))
    return resp
