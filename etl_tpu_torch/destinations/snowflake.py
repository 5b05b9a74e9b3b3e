"""Snowpipe NDJSON encoders: the columnar render of a decoded batch.

Copy of the encoder half of the reference's
`etl_tpu/destinations/snowflake.py`: `offset_token_batch` (vectorized
offset tokens), `_column_json_texts` and `encode_batch_ndjson` (the
column-at-a-time oracle, each line byte-identical to the row path's
`json.dumps`), and `encode_batch_ndjson_fast` (byte pieces — device-
rendered int and bool text where a `DeviceEgress` rode the batch, numpy
host twins otherwise — scattered into one body), with the JSON value
rules of the reference's `bigquery.encode_value`. Text columns are read
from the port's `TextArray`. The destination itself (Snowpipe Streaming
client, JWT, channels) is not ported yet.
"""

from __future__ import annotations

import base64
import datetime as dt
import json
from json.encoder import encode_basestring  # what json.dumps uses inside

import numpy as np

from ..analysis.annotations import hot_loop
from ..models.cell import (JSON_NULL, PgInterval, PgNumeric, PgSpecialDate,
                           PgSpecialTimestamp, PgTimeTz, TOAST_UNCHANGED)
from ..models.errors import ErrorKind, EtlError
from ..models.pgtypes import CellKind
from ..models.schema import ReplicatedTableSchema
from ..models.table_row import ColumnarBatch

# CDC metadata column names (reference schema.rs:6-7)
CDC_OPERATION_COLUMN = "_cdc_operation"
CDC_SEQUENCE_COLUMN = "_cdc_sequence_number"


def encode_value(v, kind: CellKind):
    """Python value → JSON value: the reference's `bigquery.encode_value`
    (reference bigquery/encoding.rs), whose rules Snowpipe shares."""
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
