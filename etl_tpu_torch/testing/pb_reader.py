"""Independent protobuf wire-format reader for AppendRows verification.

Copy of the reference's `etl_tpu/testing/pb_reader.py`.

Written directly against the protobuf wire spec and the public
descriptor.proto / storage.proto field numbers, and deliberately sharing
NO code with destinations/bq_proto.py (not even its generic TLV parser) —
the decode half of the break-the-self-confirmation-loop stance. It
parses the DescriptorProto the request itself carries and uses THAT to
decode the serialized row messages, so a bq_proto bug in either
the descriptor or the row encoding surfaces as a mismatch here instead of
round-tripping.

Field numbers (public protos):
- AppendRowsRequest: write_stream=1, offset=2 (Int64Value.value=1),
  proto_rows=4 (AppendRowsRequest.ProtoData: writer_schema=1, rows=2),
  trace_id=6
- ProtoSchema: proto_descriptor=1 (DescriptorProto)
- ProtoRows: serialized_rows=1 (repeated bytes)
- DescriptorProto: name=1, field=2 (repeated FieldDescriptorProto)
- FieldDescriptorProto: name=1, number=3, label=4, type=5
"""

from __future__ import annotations

import struct


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if i >= len(buf):
            raise ValueError("pb: truncated varint")
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("pb: varint too long")


def scan(buf: bytes):
    """Yield (field_no, wire_type, value) triples; LEN values are bytes,
    varints ints, fixed32/64 raw 4/8-byte buffers."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field_no, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
            yield field_no, 0, v
        elif wire == 1:
            if i + 8 > n:
                raise ValueError("pb: truncated fixed64")
            yield field_no, 1, buf[i : i + 8]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            if i + ln > n:
                raise ValueError("pb: truncated LEN field")
            yield field_no, 2, buf[i : i + ln]
            i += ln
        elif wire == 5:
            if i + 4 > n:
                raise ValueError("pb: truncated fixed32")
            yield field_no, 5, buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"pb: unsupported wire type {wire}")


def _to_int64(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def _to_int32(u: int) -> int:
    # int32 negatives arrive as 10-byte varints (64-bit two's complement)
    v = _to_int64(u)
    if not -(1 << 31) <= v < 1 << 31:
        raise ValueError(f"pb: int32 out of range: {v}")
    return v


def parse_descriptor(buf: bytes) -> dict:
    """DescriptorProto → {"name": ..., "fields": [{name, number, label,
    type}]} (nested types not needed for the flat row messages)."""
    name = ""
    fields = []
    for fno, wire, val in scan(buf):
        if fno == 1 and wire == 2:
            name = val.decode()
        elif fno == 2 and wire == 2:
            f = {"name": "", "number": 0, "label": 1, "type": 0}
            for ffno, fwire, fval in scan(val):
                if ffno == 1 and fwire == 2:
                    f["name"] = fval.decode()
                elif ffno == 3 and fwire == 0:
                    f["number"] = fval
                elif ffno == 4 and fwire == 0:
                    f["label"] = fval
                elif ffno == 5 and fwire == 0:
                    f["type"] = fval
            fields.append(f)
    return {"name": name, "fields": fields}


# FieldDescriptorProto.Type
_DOUBLE, _FLOAT, _INT64, _INT32 = 1, 2, 3, 5
_BOOL, _STRING, _BYTES, _UINT32 = 8, 9, 12, 13
_REPEATED = 3


def _decode_scalar(ftype: int, wire: int, val):
    # wire/type agreement: a corrupted tag can deliver the wrong wire
    # type for the declared field type — reject typed, never
    # AttributeError/struct.error into the caller
    expected_wire = {_DOUBLE: 1, _FLOAT: 5, _STRING: 2, _BYTES: 2}.get(
        ftype, 0)
    if wire != expected_wire:
        raise ValueError(
            f"pb: wire type {wire} mismatches declared type {ftype}")
    if ftype == _DOUBLE:
        return struct.unpack("<d", val)[0]
    if ftype == _FLOAT:
        return struct.unpack("<f", val)[0]
    if ftype == _INT64:
        return _to_int64(val)
    if ftype == _INT32:
        return _to_int32(val)
    if ftype == _BOOL:
        return bool(val)
    if ftype == _STRING:
        return val.decode()
    if ftype == _BYTES:
        return bytes(val)
    if ftype == _UINT32:
        return val
    raise ValueError(f"pb: unsupported field type {ftype}")


def decode_row(buf: bytes, descriptor: dict) -> dict:
    """Decode one serialized row message using the carried descriptor."""
    by_number = {f["number"]: f for f in descriptor["fields"]}
    row: dict = {}
    for fno, wire, val in scan(buf):
        f = by_number.get(fno)
        if f is None:
            raise ValueError(f"pb: row has unknown field {fno}")
        if f["label"] == _REPEATED:
            items = row.setdefault(f["name"], [])
            if wire == 2 and f["type"] in (_DOUBLE, _FLOAT, _INT64,
                                           _INT32, _BOOL, _UINT32):
                # packed encoding
                width = {_DOUBLE: 8, _FLOAT: 4}.get(f["type"], 0)
                if width and len(val) % width:
                    raise ValueError("pb: truncated packed payload")
                i = 0
                while i < len(val):
                    if f["type"] == _DOUBLE:
                        items.append(struct.unpack_from("<d", val, i)[0])
                        i += 8
                    elif f["type"] == _FLOAT:
                        items.append(struct.unpack_from("<f", val, i)[0])
                        i += 4
                    else:
                        u, i = _read_varint(val, i)
                        items.append(_decode_scalar(f["type"], 0, u))
            else:
                items.append(_decode_scalar(f["type"], wire, val))
        else:
            row[f["name"]] = _decode_scalar(f["type"], wire, val)
    return row


def decode_append_rows(buf: bytes) -> dict:
    """AppendRowsRequest bytes → {"write_stream", "offset", "trace_id",
    "descriptor", "rows": [decoded dicts]}."""
    out = {"write_stream": None, "offset": None, "trace_id": None,
           "descriptor": None, "rows": []}
    serialized_rows: list[bytes] = []
    for fno, wire, val in scan(buf):
        if fno == 1 and wire == 2:
            out["write_stream"] = val.decode()
        elif fno == 2 and wire == 2:  # Int64Value wrapper
            for wfno, wwire, wval in scan(val):
                if wfno == 1 and wwire == 0:
                    out["offset"] = _to_int64(wval)
        elif fno == 4 and wire == 2:  # ProtoData
            for pfno, pwire, pval in scan(val):
                if pfno == 1 and pwire == 2:  # ProtoSchema
                    for sfno, swire, sval in scan(pval):
                        if sfno == 1 and swire == 2:
                            out["descriptor"] = parse_descriptor(sval)
                elif pfno == 2 and pwire == 2:  # ProtoRows
                    for rfno, rwire, rval in scan(pval):
                        if rfno == 1 and rwire == 2:
                            serialized_rows.append(rval)
        elif fno == 6 and wire == 2:
            out["trace_id"] = val.decode()
    if out["descriptor"] is None:
        raise ValueError("pb: request carries no ProtoSchema descriptor")
    out["rows"] = [decode_row(r, out["descriptor"])
                   for r in serialized_rows]
    return out
