"""Dead-letter payload codec: decoded row events ↔ JSON.

A poison row must survive on the `StateStore` dead-letter surface in a
form an OPERATOR can inspect and a later `replay` can push back through
`Destination.write_event_batches` — after the process that isolated it
is long gone. The codec therefore round-trips the full decoded-cell
value vocabulary (models/cell.py): None, bool, int, float, str, bytes,
Decimal/PgNumeric, datetime/date/time, PgTimeTz, PgInterval,
PgSpecialDate/PgSpecialTimestamp (BC values outside Python's datetime
range), uuid.UUID, JsonNull, ToastUnchanged, dicts (JSON columns) and
lists (ARRAY columns).

Encoding: scalars that JSON represents natively AND unambiguously stay
plain (None/bool/int/float/str); everything else becomes a small tagged
list `["<tag>", ...args]` — a plain JSON list can therefore never be
mistaken for an ARRAY value, which is itself tagged. An unknown value
type degrades to `["opaque", repr(v)]` (lossy but inspectable — the
isolation protocol must park SOMETHING rather than die on an exotic
cell), decoded back as its repr string.
"""

from __future__ import annotations

import datetime as dt
import json
import uuid as uuid_mod
from decimal import Decimal

from ..models.cell import (JSON_NULL, TOAST_UNCHANGED, JsonNull, PgInterval,
                           PgNumeric, PgSpecialDate, PgSpecialTimestamp,
                           PgTimeTz, ToastUnchanged)
from ..models.errors import ErrorKind, EtlError
from ..models.event import (ChangeType, DeleteEvent, InsertEvent,
                            UpdateEvent)
from ..models.lsn import Lsn
from ..models.table_row import PartialTableRow, TableRow

PAYLOAD_VERSION = 1


def encode_cell(v) -> object:
    """One decoded cell value → a JSON-representable object."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        # json round-trips float64 exactly via repr; NaN/Inf are not
        # valid JSON, so tag them
        if v != v or v in (float("inf"), float("-inf")):
            return ["fspecial", repr(v)]
        return v
    if isinstance(v, PgNumeric):
        return ["num", v.pg_text()]
    if isinstance(v, Decimal):
        return ["dec", str(v)]
    if isinstance(v, bytes):
        return ["bytes", v.hex()]
    if isinstance(v, dt.datetime):
        return ["tstz" if v.tzinfo is not None else "ts", v.isoformat()]
    if isinstance(v, dt.date):
        return ["date", v.isoformat()]
    if isinstance(v, PgTimeTz):
        return ["timetz", v.time.isoformat(), v.offset_seconds]
    if isinstance(v, dt.time):
        return ["time", v.isoformat()]
    if isinstance(v, PgInterval):
        return ["interval", v.months, v.days, v.microseconds]
    if isinstance(v, PgSpecialDate):
        return ["sdate", v.days, v.text]
    if isinstance(v, PgSpecialTimestamp):
        return ["sts", v.micros, v.text, v.tz_aware]
    if isinstance(v, uuid_mod.UUID):
        return ["uuid", str(v)]
    if isinstance(v, JsonNull):
        return ["jsonnull"]
    if isinstance(v, ToastUnchanged):
        return ["toast"]
    if isinstance(v, dict):
        return ["json", v]
    if isinstance(v, list):
        return ["arr", [encode_cell(x) for x in v]]
    return ["opaque", repr(v)]


_DECODERS = {
    "fspecial": lambda a: float(a[0]),
    "num": lambda a: PgNumeric(a[0]),
    "dec": lambda a: Decimal(a[0]),
    "bytes": lambda a: bytes.fromhex(a[0]),
    "ts": lambda a: dt.datetime.fromisoformat(a[0]),
    "tstz": lambda a: dt.datetime.fromisoformat(a[0]),
    "date": lambda a: dt.date.fromisoformat(a[0]),
    "time": lambda a: dt.time.fromisoformat(a[0]),
    "timetz": lambda a: PgTimeTz(dt.time.fromisoformat(a[0]), int(a[1])),
    "interval": lambda a: PgInterval(int(a[0]), int(a[1]), int(a[2])),
    "sdate": lambda a: PgSpecialDate(int(a[0]), a[1]),
    "sts": lambda a: PgSpecialTimestamp(int(a[0]), a[1], bool(a[2])),
    "uuid": lambda a: uuid_mod.UUID(a[0]),
    "jsonnull": lambda a: JSON_NULL,
    "toast": lambda a: TOAST_UNCHANGED,
    "json": lambda a: a[0],
    "arr": lambda a: [decode_cell(x) for x in a[0]],
    "opaque": lambda a: a[0],
}


def decode_cell(v):
    if isinstance(v, list):
        try:
            return _DECODERS[v[0]](v[1:])
        except (KeyError, IndexError, ValueError) as e:
            raise EtlError(ErrorKind.STORE_SERIALIZATION_FAILED,
                           f"undecodable dead-letter cell {v!r}: {e}")
    return v


def encode_row_event(ev) -> tuple[int, str]:
    """A per-row event (Insert/Update/Delete) → (change_type, payload
    JSON). The payload keeps everything `decode_row_event` needs to
    rebuild the event against the CURRENT schema: new values, the old
    image (with its identity-presence mask for 'K' tuples), the start
    LSN, and the column names at isolation time (inspection aid — replay
    binds by position against the live schema)."""
    if isinstance(ev, InsertEvent):
        change, values, old = ChangeType.INSERT, ev.row.values, None
    elif isinstance(ev, UpdateEvent):
        change, values = ChangeType.UPDATE, ev.row.values
        old = ev.old_row
    elif isinstance(ev, DeleteEvent):
        change, old = ChangeType.DELETE, ev.old_row
        values = ev.old_row.values
    else:
        raise EtlError(ErrorKind.STORE_SERIALIZATION_FAILED,
                       f"not a row event: {type(ev).__name__}")
    doc = {
        "v": PAYLOAD_VERSION,
        "start_lsn": int(ev.start_lsn),
        "values": [encode_cell(v) for v in values],
        "old": None,
        "columns": [c.name for c in ev.schema.replicated_columns],
    }
    if isinstance(ev, UpdateEvent) and old is not None:
        doc["old"] = {
            "values": [encode_cell(v) for v in old.values],
            "present": list(old.present)
            if isinstance(old, PartialTableRow) else None,
        }
    elif isinstance(ev, DeleteEvent):
        doc["old"] = {
            "values": None,  # same as `values` — stored once
            "present": list(old.present)
            if isinstance(old, PartialTableRow) else None,
        }
    return int(change), json.dumps(doc, sort_keys=True)


def decode_row_event(entry, schema):
    """A stored `DeadLetterEntry` + the table's CURRENT
    ReplicatedTableSchema → the replayable event. Raises typed when the
    payload's width no longer matches the schema (DDL moved on — the
    operator must migrate or discard)."""
    doc = json.loads(entry.payload)
    values = [decode_cell(v) for v in doc["values"]]
    n_cols = schema.replicated_column_count()
    if len(values) != n_cols:
        raise EtlError(
            ErrorKind.SCHEMA_MISMATCH,
            f"dead-letter entry {entry.entry_id} has {len(values)} "
            f"columns but table {entry.table_id}'s current schema has "
            f"{n_cols}; migrate the payload or discard the entry")
    start_lsn = Lsn(int(doc.get("start_lsn", entry.commit_lsn)))
    commit = Lsn(entry.commit_lsn)
    change = ChangeType(entry.change_type)
    if change is ChangeType.INSERT:
        return InsertEvent(start_lsn, commit, entry.tx_ordinal, schema,
                           TableRow(values))
    old_doc = doc.get("old")
    if change is ChangeType.UPDATE:
        old = None
        if old_doc is not None:
            old_values = [decode_cell(v) for v in old_doc["values"]]
            present = old_doc.get("present")
            old = PartialTableRow(old_values, present) \
                if present is not None else TableRow(old_values)
        return UpdateEvent(start_lsn, commit, entry.tx_ordinal, schema,
                           TableRow(values), old)
    present = old_doc.get("present") if old_doc else None
    old_row = PartialTableRow(values, present) if present is not None \
        else TableRow(values)
    return DeleteEvent(start_lsn, commit, entry.tx_ordinal, schema, old_row)
