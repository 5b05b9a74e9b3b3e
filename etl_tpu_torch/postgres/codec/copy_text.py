"""COPY text-format row decode: one COPY line → field texts → TableRow.

Copy of the reference's `etl_tpu/postgres/codec/copy_text.py`.

Reference parity: `parse_table_row_from_postgres_copy_bytes`
(crates/etl/src/postgres/codec/table_row.rs:13-53).

Format invariant this exploits (same one the reference's memchr3 scan does):
in COPY text format a literal TAB/NEWLINE inside a value is always escaped
(`\\t`, `\\n`), so raw 0x09 bytes are exclusively field delimiters and raw
0x0A bytes exclusively row terminators. Field split is therefore a plain
`split(b"\\t")`; escape resolution runs per-field only when a backslash is
present. Batch-level vectorized scanning for the device path lives in
etl_tpu_torch/ops/staging.py.
"""

from __future__ import annotations

from typing import Any, Sequence

from ...models.errors import ErrorKind, EtlError
from ...models.table_row import TableRow
from .text import parse_cell_text

NULL_FIELD = b"\\N"

_SIMPLE_ESCAPES = {
    ord("b"): 0x08, ord("f"): 0x0C, ord("n"): 0x0A, ord("r"): 0x0D,
    ord("t"): 0x09, ord("v"): 0x0B,
}
_HEX = b"0123456789abcdefABCDEF"


def unescape_copy_field(raw: bytes) -> bytes:
    """Resolve COPY text escapes in one field's raw bytes."""
    if b"\\" not in raw:
        return raw
    out = bytearray()
    i, n = 0, len(raw)
    while i < n:
        c = raw[i]
        if c != 0x5C:
            out.append(c)
            i += 1
            continue
        i += 1
        if i >= n:
            raise EtlError(ErrorKind.COPY_FORMAT_INVALID,
                           "dangling backslash in COPY field")
        e = raw[i]
        if e in _SIMPLE_ESCAPES:
            out.append(_SIMPLE_ESCAPES[e])
            i += 1
        elif e == 0x5C:
            out.append(0x5C)
            i += 1
        elif ord("0") <= e <= ord("7"):
            val = e - ord("0")
            i += 1
            for _ in range(2):
                if i < n and ord("0") <= raw[i] <= ord("7"):
                    val = (val << 3) | (raw[i] - ord("0"))
                    i += 1
            out.append(val & 0xFF)
        elif e == ord("x") and i + 1 < n and raw[i + 1] in _HEX:
            i += 1
            val = int(chr(raw[i]), 16)
            i += 1
            if i < n and raw[i] in _HEX:
                val = (val << 4) | int(chr(raw[i]), 16)
                i += 1
            out.append(val)
        else:
            # COPY FROM drops the backslash before any other character
            out.append(e)
            i += 1
    return bytes(out)


def split_copy_line(line: bytes) -> list[bytes | None]:
    """Split one COPY text line (no trailing newline) into unescaped field
    bytes; None = NULL (`\\N`)."""
    fields = line.split(b"\t")
    if b"\\" not in line:  # fast path: no NULLs, no escapes
        return fields  # type: ignore[return-value]
    return [None if f == NULL_FIELD else unescape_copy_field(f) for f in fields]


def parse_copy_row(line: bytes, type_oids: Sequence[int]) -> TableRow:
    """One COPY text line → typed TableRow against the given column OIDs."""
    fields = split_copy_line(line)
    if len(fields) != len(type_oids):
        raise EtlError(
            ErrorKind.COPY_FORMAT_INVALID,
            f"COPY row has {len(fields)} fields, schema expects {len(type_oids)}")
    values: list[Any] = []
    for raw, oid in zip(fields, type_oids):
        if raw is None:
            values.append(None)
        else:
            values.append(parse_cell_text(raw.decode("utf-8"), oid))
    return TableRow(values)


def parse_copy_chunk_columns(chunk: bytes, type_oids: Sequence[int]):
    """COPY text chunk → per-COLUMN typed value lists + row count (the
    columnar form of `parse_copy_row` over every line): the CPU-engine
    copy path feeds these straight into `ColumnarBatch.from_cells`,
    skipping the TableRow materialization + from_rows re-transpose that
    used to sit between the parse and the destination write
    (runtime/copy.py:177 row round-trip)."""
    n_cols = len(type_oids)
    cells: list[list[Any]] = [[] for _ in range(n_cols)]
    n = 0
    for line in chunk.split(b"\n"):
        if not line:
            continue
        fields = split_copy_line(line)
        if len(fields) != n_cols:
            raise EtlError(
                ErrorKind.COPY_FORMAT_INVALID,
                f"COPY row has {len(fields)} fields, schema expects {n_cols}")
        for j, (raw, oid) in enumerate(zip(fields, type_oids)):
            cells[j].append(
                None if raw is None
                else parse_cell_text(raw.decode("utf-8"), oid))
        n += 1
    return cells, n


def encode_copy_field(text: str | None) -> bytes:
    if text is None:
        return NULL_FIELD
    b = text.encode("utf-8")
    return (b.replace(b"\\", b"\\\\").replace(b"\t", b"\\t")
             .replace(b"\n", b"\\n").replace(b"\r", b"\\r")
             .replace(b"\x08", b"\\b").replace(b"\x0c", b"\\f")
             .replace(b"\x0b", b"\\v"))


def encode_copy_row(texts: Sequence[str | None]) -> bytes:
    """Encode pre-rendered field texts into one COPY text line (test/fixture
    helper — the framework never writes COPY, only reads it)."""
    return b"\t".join(encode_copy_field(t) for t in texts)
