"""Independent Avro Object Container File reader.

Written directly against the Avro 1.11 specification (binary encoding +
object container files) and deliberately sharing NO code with the writer
in destinations/iceberg_meta.py — this is the decode half of the
break-the-self-confirmation-loop stance: if the writer mis-encodes
varints, unions, or block framing, this reader fails rather than
round-tripping the same bug.

Only the null codec is supported (all repo writers use it).

Copy of the reference's `etl_tpu/testing/avro_reader.py`.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        # n < 0 (a corrupted length varint) would move the cursor
        # BACKWARD and loop the parse forever — found by the avro_ocf
        # fuzz target's bit-flip pass
        if n < 0 or self.pos + n > len(self.buf):
            raise ValueError("avro: truncated file or negative length")
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def varint(self) -> int:
        shift = 0
        acc = 0
        while True:
            if self.pos >= len(self.buf):
                raise ValueError("avro: truncated varint")
            byte = self.buf[self.pos]
            self.pos += 1
            acc |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
            if shift > 70:
                raise ValueError("avro: varint too long")
        # zigzag decode
        return (acc >> 1) ^ -(acc & 1)

    def count(self, min_item_size: int = 1) -> int:
        """A block/item count: bounded by the bytes left — a corrupted
        huge count must fail fast, not spin through range(10^15).
        `min_item_size` is the schema item's minimum encoded size;
        zero-byte items (null, empty records) are instead capped by an
        absolute work budget so valid files of empty values still
        parse."""
        n = self.varint()
        if n < 0:
            raise ValueError(f"avro: negative block count {n}")
        bound = self.remaining() // min_item_size if min_item_size             else 1_000_000
        if n > bound:
            raise ValueError(f"avro: block count {n} exceeds file")
        return n


def _min_size(schema) -> int:
    """Minimum encoded bytes of one value of `schema` (0 for null and
    empty records — the bound switches to a work budget there)."""
    if isinstance(schema, list):
        return 1 + min(_min_size(s) for s in schema)
    t = schema["type"] if isinstance(schema, dict) else schema
    if t == "null":
        return 0
    if t == "record":
        return sum(_min_size(f["type"]) for f in schema["fields"])
    if t == "fixed":
        return schema["size"]
    return 1  # every other type encodes to >= 1 byte


def _read_value(cur: _Cursor, schema):
    if isinstance(schema, list):  # union
        idx = cur.varint()
        if not 0 <= idx < len(schema):
            raise ValueError(f"avro: union branch {idx} out of range")
        return _read_value(cur, schema[idx])
    t = schema["type"] if isinstance(schema, dict) else schema
    if t == "null":
        return None
    if t == "boolean":
        return cur.take(1) != b"\x00"
    if t in ("int", "long"):
        return cur.varint()
    if t == "float":
        return struct.unpack("<f", cur.take(4))[0]
    if t == "double":
        return struct.unpack("<d", cur.take(8))[0]
    if t == "bytes":
        return bytes(cur.take(cur.varint()))
    if t == "string":
        return cur.take(cur.varint()).decode()
    if t == "fixed":
        return bytes(cur.take(schema["size"]))
    if t == "record":
        return {f["name"]: _read_value(cur, f["type"])
                for f in schema["fields"]}
    if t == "array":
        out = []
        while True:
            n = cur.varint()
            if n == 0:
                return out
            if n < 0:  # block with byte-size prefix
                cur.varint()
                n = -n
            m = _min_size(schema["items"])
            if n > (cur.remaining() // m if m else 1_000_000):
                raise ValueError(f"avro: array count {n} exceeds file")
            for _ in range(n):
                out.append(_read_value(cur, schema["items"]))
    if t == "map":
        out = {}
        while True:
            n = cur.varint()
            if n == 0:
                return out
            if n < 0:
                cur.varint()
                n = -n
            # map entries: >= 1-byte key + value
            if n > cur.remaining() // (1 + _min_size(schema["values"])):
                raise ValueError(f"avro: map count {n} exceeds file")
            for _ in range(n):
                k = cur.take(cur.varint()).decode()
                out[k] = _read_value(cur, schema["values"])
    raise ValueError(f"avro reader: unsupported type {t!r}")


def read_avro_ocf(path: str | Path) -> tuple[dict, list[dict], dict]:
    """Read an Avro OCF → (schema, records, file_metadata)."""
    cur = _Cursor(Path(path).read_bytes())
    if cur.take(4) != b"Obj\x01":
        raise ValueError("avro: bad magic")
    meta = _read_value(cur, {"type": "map", "values": "bytes"})
    codec = meta.get("avro.codec", b"null").decode()
    if codec != "null":
        raise ValueError(f"avro: unsupported codec {codec}")
    schema = json.loads(meta["avro.schema"].decode())
    sync = cur.take(16)
    records: list[dict] = []
    min_rec = _min_size(schema)
    while cur.pos < len(cur.buf):
        count = cur.count(min_rec)
        cur.varint()  # block byte length (null codec: redundant)
        for _ in range(count):
            records.append(_read_value(cur, schema))
        if cur.take(16) != sync:
            raise ValueError("avro: sync marker mismatch")
    file_meta = {k: v.decode("utf-8", "replace") for k, v in meta.items()}
    return schema, records, file_meta
