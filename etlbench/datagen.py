"""Seeded, vectorised generation of a configuration's tables.

A configuration file (`configs/<name>.json`) lists its tables; each
column names its Postgres type and a generator (`gen`), and a table gives
its row count or expands each row of a parent table into a counted run of
rows. Everything is drawn from one `numpy.random.Generator` seeded by the
run's `--seed`, so the same seed gives the same tables. Sizes (row counts,
string lengths, the counts of an expansion) come from a fixed multiset
shuffled by the seed: every seed makes the same sizes in another order,
and only the contents change.

The typed values are the generator's truth: integers, NUMERIC as integers
scaled by 10**scale, DATE as days and TIMESTAMP as microseconds since
1970-01-01, text as ragged bytes (CHAR padded to its length).
"""

from __future__ import annotations

import datetime as dt
from dataclasses import dataclass
from decimal import Decimal

import numpy as np

from .textenc import starts_of

TYPES = ("int2", "int4", "int8", "numeric", "date", "timestamp", "bpchar",
         "varchar", "text")
TEXT_TYPES = ("bpchar", "varchar", "text")

_EPOCH = dt.datetime(1970, 1, 1)
_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
_ALNUM = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz"
                       b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
                       dtype=np.uint8)
_DIGITS = np.frombuffer(b"0123456789", dtype=np.uint8)
_SYLLABLES = ("BAR", "OUGHT", "ABLE", "PRI", "PRES", "ESE", "ANTI", "CALLY",
              "ATION", "EING")


@dataclass
class Col:
    """One generated column: `values` (int64) for numbers and times, or
    `lens` + `flat` for text; `valid` is False where the value is NULL."""

    name: str
    type: str
    valid: np.ndarray
    values: np.ndarray | None = None
    lens: np.ndarray | None = None
    flat: np.ndarray | None = None
    scale: int = 0
    length: int = 0
    pk: int = 0


@dataclass
class Table:
    name: str
    relid: int
    cols: list

    @property
    def n_rows(self) -> int:
        return len(self.cols[0].valid)

    def col(self, name: str) -> Col:
        for c in self.cols:
            if c.name == name:
                return c
        raise KeyError(name)


def balanced(rng, values: np.ndarray, n: int) -> np.ndarray:
    """`n` draws that hold each of `values` equally often (the remainder
    from the front), in the seed's order."""
    return rng.permutation(np.resize(np.asarray(values), n))


def timestamp_us(text: str) -> int:
    """Microseconds since 1970-01-01 of 'YYYY-MM-DD HH:MM:SS[.f]'."""
    t = dt.datetime.fromisoformat(text)
    return (t - _EPOCH) // dt.timedelta(microseconds=1)


def scaled(text: str, scale: int) -> int:
    """A decimal literal as an integer scaled by 10**scale (exact)."""
    q = Decimal(text).scaleb(scale)
    if q != q.to_integral_value():
        raise ValueError(f"{text} has more than {scale} fraction digits")
    return int(q)


def _random_text(rng, alphabet: np.ndarray, lens: np.ndarray) -> np.ndarray:
    return alphabet[rng.integers(0, len(alphabet), int(lens.sum()))]


def _string(rng, spec: dict, n: int, alphabet: np.ndarray) -> tuple:
    lens = balanced(rng, np.arange(spec["min_len"], spec["max_len"] + 1), n)
    flat = _random_text(rng, alphabet, lens)
    share = spec.get("original_share", 0.0)
    if share:
        # TPC-C 4.3.3.1: "ORIGINAL" at a random place in this share of rows
        rows = np.flatnonzero(balanced(rng, [1] * int(round(share * 100))
                                       + [0] * (100 - int(round(share * 100))),
                                       n))
        at = starts_of(lens)[rows] + rng.integers(
            0, lens[rows] - 7)
        flat[at[:, None] + np.arange(8)] = np.frombuffer(b"ORIGINAL",
                                                          np.uint8)
    return lens, flat


def _lastname(rng, spec: dict, n: int, cols: dict) -> tuple:
    """TPC-C's C_LAST: the syllables of a three-digit number, which is
    C_ID - 1 for the first 1,000 customers of a district and
    NURand(255, 0, 999) for the rest (2.1.6, 4.3.2.3)."""
    key = cols[spec["key_column"]].values
    c = int(rng.integers(0, 256))
    nurand = ((rng.integers(0, 256, n) | rng.integers(0, 1000, n)) + c) \
        % 1000
    num = np.where(key <= 1000, key - 1, nurand)
    names = [(_SYLLABLES[k // 100] + _SYLLABLES[k // 10 % 10]
              + _SYLLABLES[k % 10]).encode() for k in range(1000)]
    name_lens = np.array([len(s) for s in names], dtype=np.int64)
    name_flat = np.frombuffer(b"".join(names), dtype=np.uint8)
    lens = name_lens[num]
    within = np.arange(int(lens.sum())) - np.repeat(starts_of(lens), lens)
    return lens, name_flat[np.repeat(starts_of(name_lens)[num], lens)
                           + within]


def _ints(rng, spec: dict, n: int, index: dict, cols: dict,
          parent: "Table | None", scale: int) -> np.ndarray:
    kind = spec["kind"]
    if kind == "key":
        v = index[spec.get("of", "row")] // spec.get("div", 1)
        if "mod" in spec:
            v = v % spec["mod"]
        return v + spec.get("add", 0)
    if kind == "uniform":
        return rng.integers(spec["lo"], spec["hi"] + 1, n)
    if kind == "balanced":
        return balanced(rng, np.arange(spec["lo"], spec["hi"] + 1), n)
    if kind == "perm":
        g = spec["group"]
        if n % g:
            raise ValueError(f"perm: {n} rows are not whole groups of {g}")
        return rng.random((n // g, g)).argsort(axis=1).ravel() \
            + spec.get("add", 0)
    if kind == "numeric_uniform":
        return rng.integers(scaled(spec["lo"], scale),
                            scaled(spec["hi"], scale) + 1, n)
    if kind == "timestamp_uniform":
        lo = timestamp_us(spec["lo"])
        return lo + rng.integers(0, int(spec["span_s"] * 1_000_000), n)
    if kind == "const":
        v = spec["value"]
        if isinstance(v, str):
            v = timestamp_us(v) if ":" in v else scaled(v, scale)
        return np.full(n, v, dtype=np.int64)
    if kind == "copy":
        src = parent.col(spec["column"]).values[index["parent"]] \
            if spec.get("from_parent") else cols[spec["column"]].values
        return src.copy()
    raise ValueError(f"unknown generator {kind!r}")


def _text(rng, spec: dict, n: int, cols: dict) -> tuple:
    kind = spec["kind"]
    if kind in ("letters", "alnum", "digits"):
        alphabet = {"letters": _LETTERS, "alnum": _ALNUM,
                    "digits": _DIGITS}[kind]
        return _string(rng, spec, n, alphabet)
    if kind == "zip":  # TPC-C 4.3.2.7: n-string of 4 then "11111"
        mat = np.empty((n, 9), dtype=np.uint8)
        mat[:, :4] = _DIGITS[rng.integers(0, 10, (n, 4))]
        mat[:, 4:] = ord("1")
        return np.full(n, 9, dtype=np.int64), mat.ravel()
    if kind == "const":
        b = spec["value"].encode()
        return np.full(n, len(b), dtype=np.int64), \
            np.tile(np.frombuffer(b, np.uint8), n)
    if kind == "choice":  # exact shares (percent), in the seed's order
        pool = [v for v, w in zip(spec["values"], spec["percent"])
                for _ in range(w)]
        picks = balanced(rng, np.arange(len(pool)), n)
        words = [pool[i].encode() for i in range(len(pool))]
        wl = np.array([len(w) for w in words], dtype=np.int64)
        wf = np.frombuffer(b"".join(words), dtype=np.uint8)
        lens = wl[picks]
        within = np.arange(int(lens.sum())) - np.repeat(starts_of(lens),
                                                        lens)
        return lens, wf[np.repeat(starts_of(wl)[picks], lens) + within]
    if kind == "lastname":
        return _lastname(rng, spec, n, cols)
    raise ValueError(f"unknown text generator {kind!r}")


def _pad(lens: np.ndarray, flat: np.ndarray, length: int) -> tuple:
    """CHAR(length): each value padded with spaces to the length."""
    if len(lens) and lens.max() > length:
        raise ValueError(f"a value is longer than CHAR({length})")
    mat = np.full((len(lens), length), ord(" "), dtype=np.uint8)
    cols = np.arange(length)
    mat[cols[None, :] < lens[:, None]] = flat
    return np.full(len(lens), length, dtype=np.int64), mat.ravel()


def _when(spec: dict, cols: dict) -> np.ndarray:
    v = cols[spec["column"]].values
    return v >= spec["ge"] if "ge" in spec else v < spec["lt"]


def make_column(rng, cspec: dict, n: int, index: dict, cols: dict,
                parent: "Table | None") -> Col:
    kind = cspec["type"]
    if kind not in TYPES:
        raise ValueError(f"unsupported type {kind!r}")
    gen = cspec["gen"]
    col = Col(cspec["name"], kind, np.ones(n, dtype=bool),
              scale=cspec.get("scale", 0), length=cspec.get("length", 0),
              pk=cspec.get("pk", 0))
    if kind in TEXT_TYPES:
        col.lens, col.flat = _text(rng, gen, n, cols)
        if kind == "bpchar":
            col.lens, col.flat = _pad(col.lens, col.flat, col.length)
        elif col.length and len(col.lens) and col.lens.max() > col.length:
            raise ValueError(f"{col.name}: longer than VARCHAR({col.length})")
    else:
        col.values = np.asarray(_ints(rng, gen, n, index, cols, parent,
                                      col.scale), dtype=np.int64)
        if "const_if" in cspec:
            w = _when(cspec["const_if"], cols)
            col.values[w] = scaled(cspec["const_if"]["value"], col.scale)
    if "null_if" in cspec:
        col.valid = ~_when(cspec["null_if"], cols)
        if col.values is not None:
            col.values[~col.valid] = 0
    return col


def make_table(rng, tspec: dict, tables: dict, scale: float = 1.0) -> Table:
    """One table of the configuration; `scale` shrinks row counts for the
    CPU tests (never on the chip)."""
    parent = None
    if "expand" in tspec:
        parent = tables[tspec["expand"]["parent"]]
        counts = parent.col(tspec["expand"]["count_column"]).values
        pidx = np.repeat(np.arange(parent.n_rows), counts)
        sub = np.arange(len(pidx)) - np.repeat(starts_of(counts), counts)
        index = {"row": np.arange(len(pidx)), "parent": pidx, "sub": sub}
    else:
        n = max(1, int(round(tspec["rows"] * scale)))
        if "group" in tspec:  # keep whole groups at a reduced scale
            g = tspec["group"]
            n = max(g, n // g * g)
        index = {"row": np.arange(n)}
    n = len(index["row"])
    cols: dict = {}
    for cspec in tspec["columns"]:
        cols[cspec["name"]] = make_column(rng, cspec, n, index, cols, parent)
    return Table(tspec["name"], tspec["relid"], list(cols.values()))


def make_tables(config: dict, seed: int, scale: float = 1.0) -> list:
    """Every table of the configuration, in file order, from `seed`."""
    rng = np.random.default_rng(seed_words(seed, 1))
    tables: dict = {}
    for tspec in config["tables"]:
        tables[tspec["name"]] = make_table(rng, tspec, tables, scale)
    return list(tables.values())


def seed_words(seed: int, stream: int) -> list:
    """Entropy for numpy from any whole `--seed` (negative or past 64
    bits too) and a stream number, so that streams never share draws."""
    s = int(seed)
    return [stream, 1 if s < 0 else 0] + [
        (abs(s) >> (32 * k)) & 0xFFFFFFFF for k in range(4)]
