"""Portable classification of Postgres column default expressions.

Copy of the reference's `etl_tpu/models/default_expression.py`.

Reference parity: crates/etl-postgres/src/default_expression.rs (613 LoC).
The source's `pg_get_expr` output (captured into
`ColumnSchema.default_expression` by the schema queries and the DDL
trigger) is an arbitrary SQL expression. Destinations can only express a
conservative subset in their own DDL; everything else must be skipped
(the column arrives NULL-defaulted and rows carry explicit values, so
correctness is preserved — only destination-side `DEFAULT` convenience is
lost, exactly the reference's stance: "skipping unsupported source column
default", bigquery/schema.rs:33-36).

The parser is intentionally conservative (default_expression.rs:32-35):
 - normalization strips trailing `::type` casts and one layer of wrapping
   parens, iteratively;
 - `nextval(...)` (serial/identity), anything containing `select `, any
   remaining `::`, and `array[...]` are portability boundaries → None;
 - only single string/numeric/boolean literals classify, with type-shaped
   string literals (dates, times, timestamps, intervals, json) kept
   verbatim for typed rendering.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from .pgtypes import CellKind


class DefaultKind(enum.Enum):
    STRING = "string"
    NUMERIC = "numeric"
    BOOLEAN = "boolean"
    DATE = "date"
    TIME = "time"
    TIMETZ = "timetz"
    TIMESTAMP = "timestamp"
    TIMESTAMPTZ = "timestamptz"
    INTERVAL = "interval"
    JSON = "json"


@dataclass(frozen=True)
class DefaultExpression:
    """A classified, destination-expressible default. `text` holds the RAW
    value: for string-shaped kinds the UNESCAPED inner text (no quotes, PG
    ''-doubling undone), for numeric/boolean the bare literal. Quoting and
    escaping are DIALECT concerns applied at render time — Postgres
    ''-doubling is not valid GoogleSQL, and backslashes are escape
    characters in BigQuery/ClickHouse/Snowflake but not in Postgres."""

    kind: DefaultKind
    text: str


_TEXT_KINDS = frozenset({CellKind.STRING})
_NUMERIC_KINDS = frozenset({CellKind.I16, CellKind.I32, CellKind.I64,
                            CellKind.U32, CellKind.F32, CellKind.F64,
                            CellKind.NUMERIC})


# -- lexical helpers (default_expression.rs:226-400) -------------------------


def _string_literal_end(s: str, i: int) -> int | None:
    """Index after a single-quoted SQL literal starting at `i` ('' escapes),
    or None if unterminated / not a literal start."""
    if i >= len(s) or s[i] != "'":
        return None
    i += 1
    while i < len(s):
        if s[i] == "'":
            if i + 1 < len(s) and s[i + 1] == "'":
                i += 2
            else:
                return i + 1
        else:
            i += 1
    return None


def _is_string_literal(s: str) -> bool:
    end = _string_literal_end(s, 0)
    return end is not None and end == len(s)


def _is_numeric_literal(s: str) -> bool:
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    has_digit = has_dot = False
    for ch in s[i:]:
        if ch.isdigit():
            has_digit = True
        elif ch == "." and not has_dot:
            has_dot = True
        else:
            return False
    return has_digit


def _is_bool_literal(s: str) -> bool:
    return s.lower() in ("true", "false")


def _has_top_level_binary_operator(s: str) -> bool:
    i, depth = 0, 0
    n = len(s)
    while i < n:
        ch = s[i]
        if ch == "'":
            end = _string_literal_end(s, i)
            i = n if end is None else end
        elif ch == "(":
            depth += 1
            i += 1
        elif ch == ")":
            depth = max(0, depth - 1)
            i += 1
        elif ch in "+-" and depth == 0 and i == 0:
            i += 1  # leading sign
        elif ch in "+-*/%" and depth == 0:
            return True
        elif ch == "|" and depth == 0 and i + 1 < n and s[i + 1] == "|":
            return True
        else:
            i += 1
    return False


def _top_level_cast_start(s: str) -> int | None:
    i, depth, n = 0, 0, len(s)
    while i < n:
        ch = s[i]
        if ch == "'":
            end = _string_literal_end(s, i)
            i = n if end is None else end
        elif ch == "(":
            depth += 1
            i += 1
        elif ch == ")":
            depth = max(0, depth - 1)
            i += 1
        elif ch == ":" and depth == 0 and i + 1 < n and s[i + 1] == ":":
            return i
        else:
            i += 1
    return None


_CAST_NAME_CHARS = set("abcdefghijklmnopqrstuvwxyz"
                       "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
                       "_ \".[](),")


def _strip_cast(s: str) -> str:
    start = _top_level_cast_start(s)
    if start is None:
        return s
    type_name = s[start + 2 :].strip()
    subject = s[:start].strip()
    if type_name and all(c in _CAST_NAME_CHARS for c in type_name) \
            and not _has_top_level_binary_operator(subject):
        return subject
    return s


def _strip_outer_parens(s: str) -> str:
    s = s.strip()
    if not (s.startswith("(") and s.endswith(")")):
        return s
    i, depth, n = 0, 0, len(s)
    while i < n:
        ch = s[i]
        if ch == "'":
            end = _string_literal_end(s, i)
            i = n if end is None else end
        elif ch == "(":
            depth += 1
            i += 1
        elif ch == ")":
            depth -= 1
            if depth == 0 and i != n - 1:
                return s  # closes before the end: not a full wrap
            i += 1
        else:
            i += 1
    if depth != 0:
        return s
    return s[1:-1].strip()


def _normalize(s: str) -> str:
    s = s.strip()
    for _ in range(len(s) or 1):
        stripped = _strip_outer_parens(_strip_cast(s))
        if stripped == s or len(stripped) >= len(s):
            return s
        s = stripped
    return s


def _crosses_portability_boundary(s: str) -> bool:
    low = s.lower()
    return (low.startswith("nextval(")
            or "select " in low
            or "::" in s
            or low.startswith("array[")
            or low.startswith("array "))


def _unquote(s: str) -> str:
    return s[1:-1].replace("''", "'")


# -- classification ----------------------------------------------------------


def parse_default_expression(expression: str | None,
                             kind: CellKind) -> DefaultExpression | None:
    """Classify a source default against the column's decoded kind.
    Returns None for anything outside the portable subset — the caller
    must then OMIT the destination-side default (must-backfill stance)."""
    if expression is None:
        return None
    s = _normalize(expression)
    if not s or s.lower() == "null":
        return None
    if _crosses_portability_boundary(s):
        return None
    if _is_string_literal(s):
        return _classify_string_literal(s, kind)
    if _is_numeric_literal(s):
        if kind in _TEXT_KINDS:
            return DefaultExpression(DefaultKind.STRING, s)
        if kind in _NUMERIC_KINDS:
            return DefaultExpression(DefaultKind.NUMERIC, s)
        return None
    if _is_bool_literal(s):
        if kind in _TEXT_KINDS:
            return DefaultExpression(DefaultKind.STRING, s)
        if kind is CellKind.BOOL:
            return DefaultExpression(DefaultKind.BOOLEAN, s)
        return None
    return None


_TYPED_STRING = {
    CellKind.DATE: DefaultKind.DATE,
    CellKind.TIME: DefaultKind.TIME,
    CellKind.TIMETZ: DefaultKind.TIMETZ,
    CellKind.TIMESTAMP: DefaultKind.TIMESTAMP,
    CellKind.TIMESTAMPTZ: DefaultKind.TIMESTAMPTZ,
    CellKind.INTERVAL: DefaultKind.INTERVAL,
    CellKind.JSON: DefaultKind.JSON,
}


def _classify_string_literal(s: str,
                             kind: CellKind) -> DefaultExpression | None:
    inner = _unquote(s)
    if kind is CellKind.BOOL:
        if _is_bool_literal(inner):
            return DefaultExpression(DefaultKind.BOOLEAN, inner.lower())
        return None
    if kind in _NUMERIC_KINDS:
        if _is_numeric_literal(inner):
            return DefaultExpression(DefaultKind.NUMERIC, inner)
        return None
    typed = _TYPED_STRING.get(kind)
    if typed is not None:
        return DefaultExpression(typed, inner)
    if kind in (CellKind.STRING, CellKind.UUID):
        return DefaultExpression(DefaultKind.STRING, inner)
    # ARRAY / BYTES / anything unmapped: a quoted literal would be
    # type-mismatched at the destination (e.g. STRING default on a BQ JSON
    # array column) — must-backfill, omit the default
    return None


# -- destination rendering ---------------------------------------------------


_STRING_SHAPED = frozenset({
    DefaultKind.STRING, DefaultKind.DATE, DefaultKind.TIME,
    DefaultKind.TIMETZ, DefaultKind.TIMESTAMP, DefaultKind.TIMESTAMPTZ,
    DefaultKind.INTERVAL, DefaultKind.JSON,
})


def _quote_for(dialect: str, inner: str) -> str:
    """Dialect-correct string literal: Postgres ''-doubling is NOT valid
    GoogleSQL, and backslash is an escape character in BigQuery /
    ClickHouse / Snowflake string literals (unlike standard-conforming
    Postgres), so the raw value is re-escaped per target."""
    if dialect in ("bigquery", "clickhouse"):
        return "'" + inner.replace("\\", "\\\\").replace("'", "\\'") + "'"
    if dialect == "snowflake":  # '' doubling; backslash still escapes
        return "'" + inner.replace("\\", "\\\\").replace("'", "''") + "'"
    # duckdb & other standard-conforming dialects: '' doubling only
    return "'" + inner.replace("'", "''") + "'"


def render_default_sql(expr: DefaultExpression, dialect: str) -> str | None:
    """SQL text for a destination `DEFAULT` clause, or None when the
    dialect cannot express the kind (reference render_default_expression,
    bigquery/schema.rs:58-100 and the clickhouse/snowflake analogues)."""
    k = expr.kind
    if k in (DefaultKind.NUMERIC, DefaultKind.BOOLEAN):
        return expr.text
    if k not in _STRING_SHAPED:
        return None
    lit = _quote_for(dialect, expr.text)
    if dialect == "bigquery":
        if k is DefaultKind.DATE:
            return f"DATE {lit}"
        if k is DefaultKind.TIME:
            return f"TIME {lit}"
        if k is DefaultKind.TIMESTAMP:
            return f"DATETIME {lit}"
        if k is DefaultKind.TIMESTAMPTZ:
            return f"TIMESTAMP {lit}"
        if k is DefaultKind.JSON:
            return f"JSON {lit}"
        return lit  # TIMETZ/INTERVAL carried as STRING columns
    if dialect == "clickhouse":
        return lit  # CH casts string literals to Date/DateTime columns
    if dialect == "snowflake":
        if k is DefaultKind.JSON:
            return None  # VARIANT defaults are not expressible in SF DDL
        return lit
    if dialect == "duckdb":
        return lit
    return None


def column_default_sql(column, dialect: str) -> str | None:
    """One-call helper: classify `column.default_expression` against
    `column.kind` and render for `dialect`; None == omit (backfill)."""
    expr = parse_default_expression(column.default_expression, column.kind)
    if expr is None:
        return None
    return render_default_sql(expr, dialect)
