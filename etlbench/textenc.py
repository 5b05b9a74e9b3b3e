"""Vectorised NumPy rendering of typed columns into Postgres text, COPY
text lines and pgoutput INSERT payloads.

This is the benchmark's own encoder: the inputs that both the program and
the plain reference read are made here, from the generator's typed
columns, without any code of the program under test. A text column is
"ragged": `lens` (int64[n]) and `flat` (uint8, every row's bytes back to
back). NULL rows are rendered like any other and replaced where the
fields are assembled (`\\N` in COPY, the `n` kind in pgoutput).
"""

from __future__ import annotations

import numpy as np

#: rows assembled at once: bounds the temporary index arrays
CHUNK_ROWS = 1 << 16

_POW10 = np.array([10 ** k for k in range(20)], dtype=np.uint64)


def starts_of(lens: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum: where each row's bytes begin in `flat`."""
    out = np.zeros(len(lens), dtype=np.int64)
    if len(lens) > 1:
        np.cumsum(lens[:-1], out=out[1:])
    return out


def ragged_from_matrix(mat: np.ndarray, lens: np.ndarray,
                       right: bool) -> np.ndarray:
    """The row-major bytes of each row's `lens[i]` right-most (`right`)
    or left-most columns of the fixed-width matrix `mat`."""
    cols = np.arange(mat.shape[1])
    mask = cols[None, :] >= (mat.shape[1] - lens)[:, None] if right \
        else cols[None, :] < lens[:, None]
    return mat[mask]


def magnitude(v: np.ndarray) -> np.ndarray:
    """|v| of int64 values as uint64 (exact for the most negative)."""
    u = v.astype(np.uint64)
    neg = v < 0
    u[neg] = ~u[neg] + np.uint64(1)
    return u


def n_digits(u: np.ndarray) -> np.ndarray:
    """Decimal digits of each uint64 (0 has one)."""
    nd = np.ones(len(u), dtype=np.int64)
    for k in range(1, 20):
        nd += u >= _POW10[k]
    return nd


def _digit_matrix(u: np.ndarray, width: int) -> np.ndarray:
    """uint8 [n, width]: each value's last `width` digits, zero padded."""
    mat = np.empty((len(u), width), dtype=np.uint8)
    x = np.asarray(u).astype(np.uint64)
    ten = np.uint64(10)
    for j in range(width - 1, -1, -1):
        mat[:, j] = 48 + x % ten
        x //= ten
    return mat


def render_int(v: np.ndarray) -> tuple:
    """Postgres text of integers: optional '-', no leading zeros."""
    v = np.asarray(v, dtype=np.int64)
    neg = v < 0
    u = magnitude(v)
    nd = n_digits(u)
    width = int(nd.max(initial=1)) + 1
    mat = np.empty((len(v), width), dtype=np.uint8)
    mat[:, 1:] = _digit_matrix(u, width - 1)
    rows = np.flatnonzero(neg)
    mat[rows, width - 1 - nd[rows]] = ord("-")
    lens = nd + neg
    return lens, ragged_from_matrix(mat, lens, right=True)


def render_numeric(v: np.ndarray, scale: int) -> tuple:
    """Postgres text of NUMERIC(p, scale) held as scaled integers: exactly
    `scale` fraction digits after a '.', at least one integer digit."""
    if scale == 0:
        return render_int(v)
    v = np.asarray(v, dtype=np.int64)
    neg = v < 0
    u = magnitude(v)
    nd = np.maximum(n_digits(u), scale + 1)
    width = int(nd.max(initial=1)) + 2  # '-' and '.'
    mat = np.empty((len(v), width), dtype=np.uint8)
    digits = _digit_matrix(u, width - 2)
    mat[:, width - scale:] = digits[:, width - 2 - scale:]
    mat[:, width - scale - 1] = ord(".")
    mat[:, 1:width - scale - 1] = digits[:, :width - 2 - scale]
    rows = np.flatnonzero(neg)
    mat[rows, width - 2 - nd[rows]] = ord("-")
    lens = nd + 1 + neg
    return lens, ragged_from_matrix(mat, lens, right=True)


def civil_from_days(days: np.ndarray) -> tuple:
    """(year, month, day) of days since 1970-01-01, proleptic Gregorian
    (H. Hinnant's algorithm)."""
    z = np.asarray(days, dtype=np.int64) + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2), m, d


def _put(mat: np.ndarray, col: int, v: np.ndarray, width: int) -> None:
    mat[:, col:col + width] = _digit_matrix(np.asarray(v, np.int64), width)


def _date_matrix(days: np.ndarray, width: int) -> np.ndarray:
    y, m, d = civil_from_days(days)
    if len(y) and (y.min() < 1 or y.max() > 9999):
        raise ValueError("dates outside years 1..9999")
    mat = np.empty((len(y), width), dtype=np.uint8)
    _put(mat, 0, y, 4)
    mat[:, 4] = mat[:, 7] = ord("-")
    _put(mat, 5, m, 2)
    _put(mat, 8, d, 2)
    return mat


def render_date(days: np.ndarray) -> tuple:
    """'YYYY-MM-DD'."""
    mat = _date_matrix(days, 10)
    return np.full(len(mat), 10, dtype=np.int64), mat.ravel()


def render_timestamp(us: np.ndarray) -> tuple:
    """'YYYY-MM-DD HH:MM:SS[.ffffff]', the fraction without trailing
    zeros and left out when zero, as Postgres prints it."""
    us = np.asarray(us, dtype=np.int64)
    days = np.floor_divide(us, 86_400_000_000)
    rem = us - days * 86_400_000_000
    secs, frac = np.divmod(rem, 1_000_000)
    mat = _date_matrix(days, 26)
    mat[:, 10] = ord(" ")
    _put(mat, 11, secs // 3600, 2)
    mat[:, 13] = mat[:, 16] = ord(":")
    _put(mat, 14, secs // 60 % 60, 2)
    _put(mat, 17, secs % 60, 2)
    mat[:, 19] = ord(".")
    _put(mat, 20, frac, 6)
    nfrac = np.zeros(len(us), dtype=np.int64)
    f = frac.copy()
    for k in range(6, 0, -1):
        keep = (nfrac == 0) & (f % 10 != 0)
        nfrac[keep] = k
        f //= 10
    lens = 19 + np.where(nfrac > 0, nfrac + 1, 0)
    return lens, ragged_from_matrix(mat, lens, right=False)


def render(col) -> tuple:
    """(lens, flat) of a generated column's text (datagen.Col)."""
    kind = col.type
    if kind in ("int2", "int4", "int8"):
        return render_int(col.values)
    if kind == "numeric":
        return render_numeric(col.values, col.scale)
    if kind == "date":
        return render_date(col.values)
    if kind == "timestamp":
        return render_timestamp(col.values)
    return col.lens, col.flat


_SPECIAL = np.zeros(256, dtype=bool)
_SPECIAL[[9, 10, 13, 92]] = True  # tab, newline, CR, backslash


def gather_rows(flat: np.ndarray, starts: np.ndarray,
                lens: np.ndarray) -> tuple:
    """Rows made of pieces: row i is flat[starts[i, j] : starts[i, j] +
    lens[i, j]] for j in order. One gather a chunk of rows, its indices
    made by a running sum that jumps at each piece. Returns (buffer
    bytes, int64[n + 1] row offsets)."""
    n = starts.shape[0]
    row_len = lens.sum(axis=1)
    parts = []
    for a in range(0, n, CHUNK_ROWS):
        st = starts[a:a + CHUNK_ROWS].ravel()
        ln = lens[a:a + CHUNK_ROWS].ravel()
        keep = ln > 0
        st, ln = st[keep], ln[keep]
        total = int(ln.sum())
        step = np.ones(total, dtype=np.int64)
        if total:
            at = starts_of(ln)
            step[at[1:]] = st[1:] - (st[:-1] + ln[:-1]) + 1
            step[0] = st[0]
        parts.append(flat[np.cumsum(step)])
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_len, out=offs[1:])
    return (np.concatenate(parts).tobytes() if parts else b""), offs


def _layout(blocks: list) -> tuple:
    """Join the byte blocks into one source; returns it and each block's
    base offset in it."""
    bases = starts_of(np.array([len(b) for b in blocks], dtype=np.int64))
    return np.concatenate(blocks), bases


def copy_text(cols: list) -> bytes:
    """The table as COPY text: one line a row, fields split by tabs, NULL
    as \\N. The generators make no byte that COPY escapes; one that did
    would be refused here, not escaped."""
    texts = [render(c) for c in cols]
    for lens, flat in texts:
        if _SPECIAL[flat].any():
            raise ValueError("a generated value needs COPY escaping")
    const = np.frombuffer(b"\\N\t\n", dtype=np.uint8)
    src, bases = _layout([const] + [flat for _, flat in texts])
    n, k = len(cols[0].valid), len(cols)
    starts = np.empty((n, 2 * k), dtype=np.int64)
    lens = np.ones((n, 2 * k), dtype=np.int64)
    for j, (c, (ln, _)) in enumerate(zip(cols, texts)):
        starts[:, 2 * j] = np.where(c.valid, bases[j + 1] + starts_of(ln), 0)
        lens[:, 2 * j] = np.where(c.valid, ln, 2)
        starts[:, 2 * j + 1] = 2 if j < k - 1 else 3
    return gather_rows(src, starts, lens)[0]


def insert_payloads(cols: list, relid: int) -> tuple:
    """pgoutput INSERT messages, one a row, back to back: 'I', the
    relation id, 'N', the column count, then a 't' field (length and
    text) or an 'n' (NULL) a column. Returns (buffer bytes, int64[n + 1]
    message offsets)."""
    texts = [render(c) for c in cols]
    n, k = len(cols[0].valid), len(cols)
    head = np.frombuffer(b"nI" + int(relid).to_bytes(4, "big") + b"N"
                         + k.to_bytes(2, "big"), dtype=np.uint8)
    blocks = [head]
    for ln, flat in texts:
        hdr = np.empty((n, 5), dtype=np.uint8)
        hdr[:, 0] = ord("t")
        for j in range(4):
            hdr[:, 1 + j] = (ln >> (8 * (3 - j))) & 0xFF
        blocks += [hdr.ravel(), flat]
    src, bases = _layout(blocks)
    starts = np.empty((n, 1 + 2 * k), dtype=np.int64)
    lens = np.empty((n, 1 + 2 * k), dtype=np.int64)
    starts[:, 0], lens[:, 0] = 1, 8
    for j, (c, (ln, _)) in enumerate(zip(cols, texts)):
        starts[:, 1 + 2 * j] = np.where(
            c.valid, bases[1 + 2 * j] + 5 * np.arange(n), 0)
        lens[:, 1 + 2 * j] = np.where(c.valid, 5, 1)
        starts[:, 2 + 2 * j] = bases[2 + 2 * j] + starts_of(ln)
        lens[:, 2 + 2 * j] = np.where(c.valid, ln, 0)
    return gather_rows(src, starts, lens)
