"""The plain reference: Postgres text → typed values, in NumPy and Python.

It reads the same bytes the program reads (COPY text lines, pgoutput
INSERT messages) and decodes every field to the value the column's type
states, with no code of the program under test:

- INT2/INT4/INT8 as int64, range-checked;
- NUMERIC(p, s) exactly, as an integer scaled by 10**s (no float);
- DATE as days and TIMESTAMP as microseconds since 1970-01-01;
- CHAR(n) as its text with the padding Postgres sends, VARCHAR and TEXT
  as their text;
- NULL as a cleared `valid` bit.

`lower_precision` is the control: the same values as a decoder that
took the step below the stated precision would give them (NUMERIC
through float64, TIMESTAMP cut to the millisecond, INT4 through float32,
INT8 through float64). `keep_mask` is the publication row filter's keep
set, for filters of the form `<column> <op> <integer>`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from decimal import Decimal

import numpy as np

_INT_RANGE = {"int2": 1 << 15, "int4": 1 << 31, "int8": 1 << 63}
_POW10 = np.array([10 ** k for k in range(19)], dtype=np.int64)


@dataclass
class Fields:
    """A table's fields: `starts`, `lens` int64 [rows, cols] into `flat`,
    and `null` bool [rows, cols]."""

    flat: np.ndarray
    starts: np.ndarray
    lens: np.ndarray
    null: np.ndarray

    def rows(self, idx: np.ndarray) -> "Fields":
        return Fields(self.flat, self.starts[idx], self.lens[idx],
                      self.null[idx])

    def columns(self, idx: list) -> "Fields":
        return Fields(self.flat, self.starts[:, idx], self.lens[:, idx],
                      self.null[:, idx])


@dataclass
class RefCol:
    """One decoded column: `values` (int64; float64 in the control's
    NUMERIC) or `lens` + `flat` text; `valid` False where NULL."""

    name: str
    type: str
    valid: np.ndarray
    values: np.ndarray | None = None
    lens: np.ndarray | None = None
    flat: np.ndarray | None = None
    scale: int = 0

    def decimal(self, i: int) -> Decimal | None:
        """Row i of a NUMERIC column as the Decimal a destination gets:
        exact at the declared scale (the control: the float's own exact
        value)."""
        if not self.valid[i]:
            return None
        v = self.values[i]
        if self.values.dtype.kind == "f":
            return Decimal(float(v))
        return Decimal(int(v)).scaleb(-self.scale)


def _excl_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a), dtype=np.int64)
    if len(a) > 1:
        np.cumsum(a[:-1], out=out[1:])
    return out


def split_copy(buf: bytes, n_cols: int) -> Fields:
    """COPY text: one line a row ending in a newline, fields split by
    tabs, `\\N` for NULL. Backslash escapes are undone field by field."""
    flat = np.frombuffer(buf, dtype=np.uint8)
    seps = np.flatnonzero((flat == 9) | (flat == 10))
    if len(seps) % n_cols:
        raise ValueError("COPY text: a row has the wrong number of fields")
    if not np.array_equal(np.flatnonzero(flat == 10),
                          seps[n_cols - 1::n_cols]):
        raise ValueError("COPY text: a row has the wrong number of fields")
    ends = seps.reshape(-1, n_cols)
    starts = np.empty_like(ends)
    starts[:, 0] = np.concatenate(([0], ends[:-1, -1] + 1))
    starts[:, 1:] = ends[:, :-1] + 1
    lens = ends - starts
    null = (lens == 2) & (flat[starts] == 92) \
        & (flat[np.minimum(starts + 1, len(flat) - 1)] == 78)
    escaped = np.flatnonzero(flat == 92)
    if len(escaped) > null.sum():
        return _unescape(flat, starts, lens, null)
    return Fields(flat, starts, lens, null)


_ESCAPES = {ord("b"): 8, ord("f"): 12, ord("n"): 10, ord("r"): 13,
            ord("t"): 9, ord("v"): 11, ord("\\"): 92}


def _unescape(flat, starts, lens, null) -> Fields:
    """Rebuild the fields that hold a backslash escape, one by one."""
    pieces, new_starts, new_lens, at = [], np.empty_like(starts), \
        np.empty_like(lens), 0
    for r in range(starts.shape[0]):
        for c in range(starts.shape[1]):
            raw = flat[starts[r, c]:starts[r, c] + lens[r, c]].tobytes()
            if not null[r, c] and b"\\" in raw:
                out, i = bytearray(), 0
                while i < len(raw):
                    if raw[i] == 92 and i + 1 < len(raw) \
                            and raw[i + 1] in _ESCAPES:
                        out.append(_ESCAPES[raw[i + 1]])
                        i += 2
                    else:
                        out.append(raw[i])
                        i += 1
                raw = bytes(out)
            pieces.append(raw)
            new_starts[r, c], new_lens[r, c] = at, len(raw)
            at += len(raw)
    return Fields(np.frombuffer(b"".join(pieces), dtype=np.uint8),
                  new_starts, new_lens, null)


def split_inserts(buf: bytes, offs: np.ndarray, n_cols: int) -> Fields:
    """pgoutput INSERT messages ('I', relation id, 'N', column count,
    then 't' + length + text or 'n' a column), `offs` their bounds."""
    flat = np.frombuffer(buf, dtype=np.uint8)
    n = len(offs) - 1
    pos = np.asarray(offs[:-1], dtype=np.int64)
    if n and (np.any(flat[pos] != ord("I")) or np.any(flat[pos + 5]
                                                       != ord("N"))):
        raise ValueError("not an INSERT message with a new tuple")
    cols = flat[pos + 6].astype(np.int64) * 256 + flat[pos + 7]
    if n and np.any(cols != n_cols):
        raise ValueError("INSERT message: wrong column count")
    pos = pos + 8
    starts = np.zeros((n, n_cols), dtype=np.int64)
    lens = np.zeros((n, n_cols), dtype=np.int64)
    null = np.zeros((n, n_cols), dtype=bool)
    for c in range(n_cols):
        kind = flat[pos]
        is_text = kind == ord("t")
        if np.any(~is_text & (kind != ord("n"))):
            raise ValueError("INSERT message: unexpected tuple kind")
        ln = np.zeros(n, dtype=np.int64)
        t = np.flatnonzero(is_text)
        for j in range(4):
            ln[t] = ln[t] * 256 + flat[pos[t] + 1 + j]
        starts[:, c] = pos + 5
        lens[:, c] = ln
        null[:, c] = ~is_text
        pos = pos + np.where(is_text, 5 + ln, 1)
    if n and not np.array_equal(pos, offs[1:]):
        raise ValueError("INSERT message: length does not match its fields")
    return Fields(flat, starts, lens, null)


def _matrix(flat, starts, lens, right: bool) -> np.ndarray:
    """uint8 [n, max len] of the fields, aligned left or right, 0 where
    a field is shorter."""
    width = int(lens.max(initial=0))
    mat = np.zeros((len(lens), max(width, 1)), dtype=np.uint8)
    if width == 0:
        return mat
    cols = np.arange(width)
    mask = cols[None, :] >= (width - lens)[:, None] if right \
        else cols[None, :] < lens[:, None]
    total = int(lens.sum())
    within = np.arange(total) - np.repeat(_excl_cumsum(lens), lens)
    mat[mask] = flat[np.repeat(starts, lens) + within]
    return mat


def parse_int(flat, starts, lens, type_: str) -> np.ndarray:
    """'-'? digits → int64, refused outside the type's range."""
    mat = _matrix(flat, starts, lens, right=True)
    width = mat.shape[1]
    first = mat[np.arange(len(lens)), np.clip(width - lens, 0, width - 1)]
    neg = first == ord("-")
    digit = (mat >= 48) & (mat <= 57)
    sign_col = np.arange(width)[None, :] == (width - lens)[:, None]
    n_dig = digit.sum(axis=1)
    if np.any((n_dig + neg) != lens) or np.any(lens == 0) \
            or np.any(n_dig == 0) or np.any(n_dig > 19):
        raise ValueError("malformed integer text")
    if np.any(~digit & (mat != 0) & ~(sign_col & neg[:, None])):
        raise ValueError("malformed integer text")
    big = n_dig > 18
    val = np.zeros(len(lens), dtype=np.int64)
    ok = ~big
    for j in range(max(0, width - 18), width):
        w = width - 1 - j
        val[ok] += np.where(digit[ok, j], mat[ok, j].astype(np.int64) - 48,
                            0) * _POW10[w]
    out = np.where(neg, -val, val)
    for i in np.flatnonzero(big):  # 19 digits: Python ints, checked below
        v = int(bytes(flat[starts[i]:starts[i] + lens[i]]))
        out[i] = v if -(1 << 63) <= v < (1 << 63) else 0
        if not -(1 << 63) <= v < (1 << 63):
            raise ValueError("integer past int64")
    lim = _INT_RANGE[type_]
    if np.any(out < -lim) or np.any(out >= lim):
        raise ValueError(f"value outside {type_}")
    return out


def parse_numeric(flat, starts, lens, scale: int) -> np.ndarray:
    """'-'? digits ['.' digits] → the integer value × 10**scale, exactly.
    A value with more fraction digits than the scale is refused."""
    mat = _matrix(flat, starts, lens, right=True)
    n, width = mat.shape
    cols = np.arange(width)[None, :]
    inside = cols >= (width - lens)[:, None]
    first = mat[np.arange(n), np.clip(width - lens, 0, width - 1)]
    neg = first == ord("-")
    digit = (mat >= 48) & (mat <= 57)
    dot = mat == ord(".")
    n_dots = dot.sum(axis=1)
    sign_col = cols == (width - lens)[:, None]
    if np.any(n_dots > 1) or np.any(inside & ~digit & ~dot
                                    & ~(sign_col & neg[:, None])):
        raise ValueError("malformed numeric text")
    dot_at = np.where(n_dots == 1, np.argmax(dot, axis=1), width)
    frac = width - 1 - dot_at
    frac = np.where(n_dots == 1, frac, 0)
    if np.any(frac > scale):
        raise ValueError("numeric text past its declared scale")
    n_dig = digit.sum(axis=1)
    if np.any(n_dig == 0):
        raise ValueError("malformed numeric text")
    # exponent of each digit: digits to its right, plus the missing
    # fraction digits
    right = np.cumsum(digit[:, ::-1], axis=1)[:, ::-1] - digit
    exp = right + (scale - frac)[:, None]
    wide = np.any(digit & (exp > 18), axis=1)
    val = np.zeros(n, dtype=np.int64)
    d = (mat.astype(np.int64) - 48) * digit
    for j in range(width):
        e = np.clip(exp[:, j], 0, 18)
        val += np.where(digit[:, j] & ~wide, d[:, j] * _POW10[e], 0)
    out = np.where(neg, -val, val)
    for i in np.flatnonzero(wide):
        q = Decimal(bytes(flat[starts[i]:starts[i] + lens[i]]).decode())
        v = int(q.scaleb(scale))
        if not -(1 << 63) <= v < (1 << 63):
            raise ValueError("numeric past int64 at its scale")
        out[i] = v
    return out


def days_from_civil(y, m, d) -> np.ndarray:
    """Days since 1970-01-01 (H. Hinnant's algorithm)."""
    y = np.asarray(y, np.int64) - (np.asarray(m) <= 2)
    era = np.floor_divide(y, 400)
    yoe = y - era * 400
    mp = (np.asarray(m, np.int64) + 9) % 12
    doy = (153 * mp + 2) // 5 + np.asarray(d, np.int64) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _num(mat, a: int, b: int) -> np.ndarray:
    d = mat[:, a:b].astype(np.int64) - 48
    if np.any((d < 0) | (d > 9)):
        raise ValueError("malformed date or time text")
    return d @ _POW10[b - a - 1::-1]


def _days(mat) -> np.ndarray:
    if np.any(mat[:, 4] != ord("-")) or np.any(mat[:, 7] != ord("-")):
        raise ValueError("malformed date text")
    y, m, d = _num(mat, 0, 4), _num(mat, 5, 7), _num(mat, 8, 10)
    days_in = np.array([31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
    leap = (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))
    bad = (m < 1) | (m > 12) | (d < 1)
    bad |= d > np.where((m == 2) & ~leap, 28, days_in[np.clip(m, 1, 12) - 1])
    if np.any(bad):
        raise ValueError("impossible date")
    return days_from_civil(y, m, d)


def parse_date(flat, starts, lens) -> np.ndarray:
    """'YYYY-MM-DD' → days since 1970-01-01."""
    if np.any(lens != 10):
        raise ValueError("malformed date text")
    return _days(_matrix(flat, starts, lens, right=False))


def parse_timestamp(flat, starts, lens) -> np.ndarray:
    """'YYYY-MM-DD HH:MM:SS[.f{1,6}]' → microseconds since 1970-01-01."""
    if np.any((lens < 19) | (lens == 20) | (lens > 26)):
        raise ValueError("malformed timestamp text")
    mat = _matrix(flat, starts, lens, right=False)
    mat = np.pad(mat, ((0, 0), (0, 26 - mat.shape[1])))
    if np.any(mat[:, 10] != ord(" ")) or np.any(mat[:, 13] != ord(":")) \
            or np.any(mat[:, 16] != ord(":")) \
            or np.any((lens > 19) & (mat[:, 19] != ord("."))):
        raise ValueError("malformed timestamp text")
    h, mi, s = _num(mat, 11, 13), _num(mat, 14, 16), _num(mat, 17, 19)
    if np.any((h > 23) | (mi > 59) | (s > 59)):
        raise ValueError("impossible time of day")
    fd = mat[:, 20:26].astype(np.int64) - 48
    within = np.arange(6)[None, :] < (lens - 20)[:, None]
    if np.any(within & ((fd < 0) | (fd > 9))):
        raise ValueError("malformed timestamp fraction")
    frac = (np.where(within, fd, 0) * _POW10[5::-1]).sum(axis=1)
    return (_days(mat) * 86_400 + h * 3600 + mi * 60 + s) * 1_000_000 + frac


def decode(columns: list, fields: Fields) -> list:
    """Every column of a table, decoded: `columns` are the configuration's
    column entries (name, type, scale, length)."""
    out = []
    for c, spec in enumerate(columns):
        type_ = spec["type"]
        valid = ~fields.null[:, c]
        rows = np.flatnonzero(valid)
        st, ln = fields.starts[rows, c], fields.lens[rows, c]
        col = RefCol(spec["name"], type_, valid, scale=spec.get("scale", 0))
        if type_ in ("bpchar", "varchar", "text"):
            length = spec.get("length", 0)
            if type_ == "bpchar" and np.any(ln != length):
                raise ValueError(f"{spec['name']}: CHAR({length}) text "
                                 f"of another length")
            if type_ == "varchar" and length and np.any(ln > length):
                raise ValueError(f"{spec['name']}: past VARCHAR({length})")
            lens = np.zeros(len(valid), dtype=np.int64)
            lens[rows] = ln
            within = np.arange(int(ln.sum())) - np.repeat(_excl_cumsum(ln),
                                                          ln)
            col.lens = lens
            col.flat = fields.flat[np.repeat(st, ln) + within]
        else:
            if type_ in _INT_RANGE:
                v = parse_int(fields.flat, st, ln, type_)
            elif type_ == "numeric":
                v = parse_numeric(fields.flat, st, ln, col.scale)
            elif type_ == "date":
                v = parse_date(fields.flat, st, ln)
            elif type_ == "timestamp":
                v = parse_timestamp(fields.flat, st, ln)
            else:
                raise ValueError(f"no reference decode for {type_!r}")
            col.values = np.zeros(len(valid), dtype=np.int64)
            col.values[rows] = v
        out.append(col)
    return out


#: the control's steps, each one below a stated precision or guarantee:
#: a configuration's `control` maps a column type to one of them
LOWERINGS = ("float64", "float32", "ms", "trim")


def lower_precision(cols: list, lowering: dict) -> list:
    """The control: each column as the step `lowering[type]` below its
    stated precision would decode it: through float64 or float32, a
    TIMESTAMP to the millisecond, a CHAR with its padding trimmed."""
    out = []
    for c in cols:
        v, lens, flat = c.values, c.lens, c.flat
        step = lowering.get(c.type)
        if step not in (None,) + LOWERINGS:
            raise ValueError(f"unknown lowering {step!r}")
        if step == "trim":
            lens, flat = _trimmed(lens, flat)
        elif step == "ms":
            v = np.floor_divide(v, 1000) * 1000
        elif step == "float64" and c.type == "numeric":
            v = v.astype(np.float64) / float(10 ** c.scale)
        elif step is not None:
            with np.errstate(invalid="ignore"):  # 2**63 does not come back
                v = v.astype(step).astype(np.int64)
        out.append(RefCol(c.name, c.type, c.valid, v, lens, flat, c.scale))
    return out


def _trimmed(lens: np.ndarray, flat: np.ndarray) -> tuple:
    """Ragged text with the trailing spaces of every value cut off."""
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    row = np.repeat(np.arange(len(lens)), lens)
    keep_to = np.zeros(len(lens), dtype=np.int64)  # last non-space + 1
    nonspace = np.flatnonzero(flat[:int(lens.sum())] != ord(" "))
    np.maximum.at(keep_to, row[nonspace], nonspace - starts[row[nonspace]]
                  + 1)
    within = np.arange(len(row)) - starts[row]
    return keep_to, flat[:len(row)][within < keep_to[row]]


_FILTER = re.compile(r"^\s*([a-z_][a-z0-9_]*)\s*(<=|>=|<>|!=|=|<|>)\s*"
                     r"(-?\d+)\s*$")
_OPS = {"<": np.less, "<=": np.less_equal, ">": np.greater,
        ">=": np.greater_equal, "=": np.equal, "<>": np.not_equal,
        "!=": np.not_equal}


def keep_mask(sql: str, cols: list) -> np.ndarray:
    """Rows a publication row filter `<column> <op> <integer>` keeps
    (NULL compares false and is dropped, as in Postgres)."""
    m = _FILTER.match(sql)
    if m is None:
        raise ValueError(f"row filter {sql!r} is outside the reference")
    name, op, lit = m.groups()
    col = next(c for c in cols if c.name == name)
    if col.values is None or col.type not in _INT_RANGE:
        raise ValueError("the reference filters integer columns only")
    return col.valid & _OPS[op](col.values, int(lit))
