"""ClickHouse TSV encoders: the columnar render of a decoded batch.

Copy of the encoder half of the reference's
`etl_tpu/destinations/clickhouse.py`: `render_value` (one TSV field),
`_column_texts` and `render_batch_tsv_columnar` (column-at-a-time render
and one join per row: the oracle), and `_column_piece_tsv` and
`render_batch_tsv_fast` (byte pieces — device-rendered text where a
`DeviceEgress` rode the batch, numpy host twins otherwise — scattered
into one body by `ops/egress.assemble_rows`), byte-identical to the
oracle. Text columns are read from the port's `TextArray` buffers, so
nothing here needs pyarrow. The destination itself (its HTTP client, DDL
and commit log) is not ported yet.
"""

from __future__ import annotations

import datetime as dt
import json

import numpy as np

from ..analysis.annotations import hot_loop
from ..models.cell import (JSON_NULL, PgInterval, PgNumeric, PgSpecialDate,
                           PgSpecialTimestamp, PgTimeTz, TOAST_UNCHANGED)
from ..models.pgtypes import CellKind
from ..models.schema import ReplicatedTableSchema
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
