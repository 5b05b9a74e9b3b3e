"""The comparison that decides `correct`.

What the program delivered is turned into plain arrays, column by column
(the program's outputs are only read here), and held against the plain
reference's decode of the same input text (`reference/`), row for row:

- `cells_bad`: every delivered row's every column against the reference:
  validity, integers, DATE days, TIMESTAMP microseconds, CHAR and VARCHAR
  bytes (padding included), NUMERIC as the exact scaled integer of the
  delivered text;
- `numeric_bad`: a sample of delivered NUMERIC cells, drawn from the
  seed, materialised as a destination gets them (the column's `value()`)
  against the reference's exact Decimal, value and scale;
- the traffic's delivery numbers (`kinds/<kind>.py`): rows missing, rows
  delivered twice or not due, rows out of order.

Each number has the limit 0: the comparison is exact.

The control (`--control 1`) puts the reference, computed one step below
the precision or guarantee the configuration states (its `control`, by
column type: `reference.decode.lower_precision`), in the program's place
at the same delivered rows; it has to come out not correct.
"""

from __future__ import annotations

import datetime as dt
from decimal import Decimal

import numpy as np

from .reference import decode as ref
from .textenc import starts_of

LIMITS = {"rows_missing": 0, "rows_extra": 0, "order_breaks": 0,
          "cells_bad": 0, "numeric_bad": 0}
#: NUMERIC cells materialised a table (or a sync's table) at most
NUMERIC_SAMPLE = 2048
#: rows whose every cell is compared: a table's, in every sync (copy),
#: and of the whole stream (CDC); drawn from the seed
COPY_SAMPLE_ROWS = 1 << 16
CDC_SAMPLE_ROWS = 1 << 20
#: rows of a text column compared at once: bounds the index arrays
CHUNK_ROWS = 1 << 20


def _width(lens: np.ndarray) -> "int | None":
    """The one length of every row, where they share one (and it is not
    0), else None."""
    if len(lens) and lens[0] > 0 and lens.min() == lens.max():
        return int(lens[0])
    return None


def ragged_take(lens: np.ndarray, flat: np.ndarray, idx: np.ndarray,
                starts: "np.ndarray | None" = None):
    """(lens, flat) of the rows `idx` of a ragged column, in that order;
    `starts` are the column's row starts where the caller has them."""
    width = _width(lens)
    if width is not None:  # every row as long: gather whole rows
        return lens[idx], flat[:width * len(lens)].reshape(
            -1, width)[idx].ravel()
    if starts is None:
        starts = starts_of(lens)
    sel = lens[idx]
    total = int(sel.sum())
    within = np.arange(total, dtype=np.int64) - np.repeat(starts_of(sel), sel)
    return sel, flat[np.repeat(starts[idx], sel) + within]


def sample(n: int, k: int, rng) -> np.ndarray:
    """`k` of `n` positions (all where n <= k), sorted, drawn by `rng`."""
    if n <= k:
        return np.arange(n)
    return np.sort(rng.choice(n, size=k, replace=False))


def take_ref(cols: list, idx: np.ndarray) -> list:
    """The reference's columns at rows `idx`."""
    out = []
    for c in cols:
        r = ref.RefCol(c.name, c.type, c.valid[idx], scale=c.scale)
        if c.values is not None:
            r.values = c.values[idx]
        else:
            r.lens, r.flat = ragged_take(c.lens, c.flat, idx)
        out.append(r)
    return out


TEXT_TYPES = ("bpchar", "varchar", "text")
#: a delivered value that is no number at its type's scale
NOT_A_VALUE = np.iinfo(np.int64).min
_EPOCH = dt.datetime(1970, 1, 1)


def _plain(v, spec: dict):
    """One delivered object-stored value as the reference holds it."""
    t = spec["type"]
    if t in TEXT_TYPES:
        return v.encode() if isinstance(v, str) else None
    if isinstance(v, bool):
        return NOT_A_VALUE
    if t == "numeric" and isinstance(v, Decimal):
        q = v.scaleb(spec.get("scale", 0))
        return int(q) if q == q.to_integral_value() else NOT_A_VALUE
    if t == "timestamp" and isinstance(v, dt.datetime) and v.tzinfo is None:
        return (v - _EPOCH) // dt.timedelta(microseconds=1)
    if t == "date" and isinstance(v, dt.date) \
            and not isinstance(v, dt.datetime):
        return (v - _EPOCH.date()).days
    if isinstance(v, int) and t in ("int2", "int4", "int8"):
        return v
    return NOT_A_VALUE


def _column(batch_col, spec: dict) -> dict:
    """One batch's column as plain arrays: `values` (int64) for numbers
    and times, `lens` + `flat` for text."""
    valid = np.asarray(batch_col.validity, dtype=bool)
    data = batch_col.data
    text = spec["type"] in TEXT_TYPES
    if hasattr(data, "offsets"):
        offs = np.asarray(data.offsets, dtype=np.int64)
        lens = np.diff(offs)
        flat = np.asarray(data.values)[offs[0]:offs[-1]]
        if text:
            return {"valid": valid, "lens": lens, "flat": flat}
        if spec["type"] == "numeric":
            values = np.full(len(valid), NOT_A_VALUE, dtype=np.int64)
            ok = np.flatnonzero(valid)
            try:
                values[ok] = ref.parse_numeric(
                    flat, starts_of(lens)[ok], lens[ok],
                    spec.get("scale", 0))
            except ValueError:
                pass  # malformed text: every cell stays not a value
            return {"valid": valid, "values": values}
        return {"valid": valid,
                "values": np.full(len(valid), NOT_A_VALUE, np.int64)}
    if isinstance(data, np.ndarray):
        if text:
            raise TypeError(f"{spec['name']}: text delivered as numbers")
        if data.dtype.kind == "f":  # a float where the type is exact
            data = np.round(data * 10.0 ** spec.get("scale", 0))
        return {"valid": valid, "values": data.astype(np.int64)}
    plain = [_plain(v, spec) if ok else None
             for v, ok in zip(data, valid.tolist())]
    if text:
        # a value that is no text is delivered as a byte no text holds
        enc = [b"" if p is None and not ok else
               p if isinstance(p, bytes) else b"\xff"
               for p, ok in zip(plain, valid.tolist())]
        return {"valid": valid,
                "lens": np.array([len(b) for b in enc], dtype=np.int64),
                "flat": np.frombuffer(b"".join(enc), dtype=np.uint8)}
    return {"valid": valid, "values": np.array(
        [0 if p is None else p for p in plain], dtype=np.int64)}


class Delivered:
    """The program's delivered batches of one table as plain columns, and
    the way back to each row's batch for the materialised sample."""

    def __init__(self, batches: list, specs: list):
        # a batch that is not this table's shape delivers none of its rows
        self.batches, shaped, self.malformed = [], [], 0
        for b in batches:
            try:
                if len(b.columns) != len(specs):
                    raise TypeError("another table's columns")
                cols = [_column(b.columns[c], s)
                        for c, s in enumerate(specs)]
            except (TypeError, ValueError, AttributeError):
                self.malformed += 1
                continue
            self.batches.append(b)
            shaped.append(cols)
        sizes = np.array([b.num_rows for b in self.batches], dtype=np.int64)
        self._first = starts_of(sizes)
        self.cols = []
        for c, spec in enumerate(specs):
            parts = [cols[c] for cols in shaped]
            col = {"valid": np.concatenate([p["valid"] for p in parts])
                   if parts else np.zeros(0, bool)}
            if spec["type"] in TEXT_TYPES:
                col["lens"] = np.concatenate([p["lens"] for p in parts]) \
                    if parts else np.zeros(0, np.int64)
                col["flat"] = np.concatenate([p["flat"] for p in parts]) \
                    if parts else np.zeros(0, np.uint8)
            else:
                col["values"] = np.concatenate([p["values"] for p in parts]) \
                    if parts else np.zeros(0, np.int64)
            self.cols.append(col)

    def key(self, c: int) -> np.ndarray:
        return self.cols[c]["values"]

    def materialise(self, c: int, i: int):
        b = int(np.searchsorted(self._first, i, side="right") - 1)
        return self.batches[b].columns[c].value(int(i - self._first[b]))


class Control:
    """The reference at lower precision in the program's place: `want`
    are the reference's columns at the delivered rows."""

    def __init__(self, want: list, lowering: dict):
        self._low = ref.lower_precision(want, lowering)
        self.cols = []
        for c in self._low:
            got = {"valid": c.valid}
            if c.values is not None:
                v = c.values
                if v.dtype.kind == "f":  # NUMERIC through float64
                    v = np.round(v * 10.0 ** c.scale).astype(np.int64)
                got["values"] = v
            else:
                got["lens"], got["flat"] = c.lens, c.flat
            self.cols.append(got)

    def materialise(self, c: int, i: int):
        return self._low[c].decimal(i)


def _row_mismatch(a_lens, a_flat, b_flat) -> np.ndarray:
    """Per row (of equal lengths `a_lens`): do the bytes differ?"""
    width = _width(a_lens)
    if width is not None:
        return (a_flat.reshape(-1, width) != b_flat.reshape(-1, width)).any(
            axis=1)
    diff = (a_flat != b_flat).astype(np.int64)
    out = np.zeros(len(a_lens), dtype=bool)
    nz = np.flatnonzero(a_lens > 0)
    if len(nz):
        out[nz] = np.add.reduceat(diff, starts_of(a_lens)[nz]) > 0
    return out


def cells_bad(want: list, got, rows: np.ndarray) -> dict:
    """Rows of `got` (Delivered or Control) at positions `rows` against
    the reference columns `want` (already at the same rows): bad cells a
    column."""
    bad = {}
    for c, w in enumerate(want):
        g = got.cols[c]
        gv = g["valid"][rows]
        wrong = gv != w.valid
        both = np.flatnonzero(gv & w.valid)
        if w.values is not None:
            wrong[both] |= g["values"][rows[both]] != w.values[both]
        else:
            if "lens" not in g:
                wrong[both] = True
            else:
                same_len = g["lens"][rows[both]] == w.lens[both]
                wrong[both[~same_len]] = True
                keep = both[same_len]
                w_starts, g_starts = starts_of(w.lens), starts_of(g["lens"])
                for a in range(0, len(keep), CHUNK_ROWS):
                    k = keep[a:a + CHUNK_ROWS]
                    gl, gf = ragged_take(g["lens"], g["flat"], rows[k],
                                         g_starts)
                    wf = ragged_take(w.lens, w.flat, k, w_starts)[1]
                    wrong[k] |= _row_mismatch(gl, gf, wf)
        bad[w.name] = int(wrong.sum())
    return bad


def numeric_bad(want: list, got, rows: np.ndarray, rng) -> int:
    """A seeded sample of NUMERIC cells, materialised as a destination
    gets them, against the reference's exact Decimal (value and scale)."""
    bad = 0
    n = len(rows)
    pick = np.sort(rng.choice(n, size=min(n, NUMERIC_SAMPLE), replace=False)) \
        if n else np.zeros(0, np.int64)
    for c, w in enumerate(want):
        if w.type != "numeric":
            continue
        for j in pick.tolist():
            if not w.valid[j]:
                continue
            exact = Decimal(int(w.values[j])).scaleb(-w.scale)
            v = got.materialise(c, int(rows[j]))
            if not (isinstance(v, Decimal) and v == exact
                    and v.as_tuple().exponent == exact.as_tuple().exponent):
                bad += 1
    return bad


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS if k in numbers)


def report(numbers: dict) -> dict:
    """{name: {"value", "limit"}} of every number compared."""
    return {k: {"value": numbers[k], "limit": LIMITS[k]}
            for k in LIMITS if k in numbers}
