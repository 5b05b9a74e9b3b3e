"""Publication row-filter predicate IR and the evaluators it drives.

Copy of the reference's `etl_tpu/ops/predicate.py` (the IR, the SQL-subset
parser, literal coercion, `CompiledRowFilter` with `host_keep`, the
per-row python evaluators) with the device evaluator in two forms:

  - `CompiledRowFilter.device_keep`: plain PyTorch over the parsed
    components (`parsers.parse_column` output), the plain version of the
    filter half of the K2 kernel. The CPU decoder and the tests use it.
  - `CompiledRowFilter.program`: the same predicate lowered once, at
    compile time, to a flat postfix program for the CUDA kernel
    (`csrc/decode_pack.cu`, `ops/decode_kernel.pred_descriptor`). Leaves
    are `CMP(column, cmp, negate, folded literal words)` and
    `NULLTEST(column, negated)`; the rest is `AND n`, `OR n`, `NOT`. Every
    literal is folded on the host exactly as `_device_cmp` folds it:
    `ne`/`le`/`ge` become negations of `eq`/`gt`/`lt`, literals no
    in-range value can reach become constants, U32 literals take the
    sign-flip bias, I64 literals split into three base-10^9 limbs and a
    sign, TIME into (ms, µs), TIMESTAMP(TZ) into (days, ms, µs).

A row is published iff the predicate evaluates TRUE under SQL's
three-valued logic; NULL-involved comparisons are unknown and drop the
row. Device evaluation engages only when every referenced column is a
device-parsed kind with an exact int32-component comparison
(DEVICE_CMP_KINDS) and the postfix program fits the kernel's stack
(MAX_PROGRAM_DEPTH); anything else is applied by `host_keep` after an
unfiltered decode, with identical results. Compilation happens once, at
decoder construction, never per batch.

Supported grammar: comparisons `col {=,<>,!=,<,<=,>,>=} literal`,
`col IS [NOT] NULL`, AND/OR/NOT, parentheses. Literals: numbers,
'quoted strings' (dates/timestamps parse per the column's type),
TRUE/FALSE.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

import numpy as np
import torch

from ..models.pgtypes import CellKind, Oid
from ..models.schema import ReplicatedTableSchema, TableSchema

# kinds with an exact device-side comparison over parsed int32 components
DEVICE_CMP_KINDS = frozenset({
    CellKind.BOOL, CellKind.I16, CellKind.I32, CellKind.U32, CellKind.I64,
    CellKind.DATE, CellKind.TIME, CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ,
})

# representative OID per kind for literal coercion through the SAME text
# parser the decode oracle uses (postgres/codec/text.parse_cell_text), so
# a literal and a column value can never round-trip differently
_KIND_OID = {
    CellKind.BOOL: Oid.BOOL, CellKind.I16: Oid.INT2, CellKind.I32: Oid.INT4,
    CellKind.U32: Oid.OID, CellKind.I64: Oid.INT8, CellKind.F32: Oid.FLOAT4,
    CellKind.F64: Oid.FLOAT8, CellKind.NUMERIC: Oid.NUMERIC,
    CellKind.DATE: Oid.DATE, CellKind.TIME: Oid.TIME,
    CellKind.TIMESTAMP: Oid.TIMESTAMP, CellKind.TIMESTAMPTZ: Oid.TIMESTAMPTZ,
    CellKind.STRING: Oid.TEXT,
}

_CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")
_OP_TOKEN = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le",
             ">": "gt", ">=": "ge"}
_OP_SQL = {"eq": "=", "ne": "<>", "lt": "<", "le": "<=", "gt": ">",
           "ge": ">="}

# postfix program of the CUDA kernel (PRED_* / CMP_* in csrc/decode_pack.cu):
# one instruction = (opcode, column, cmp, negate, a, b, c, d)
P_CMP, P_NULLTEST, P_AND, P_OR, P_NOT = 0, 1, 2, 3, 4
CMP_EQ, CMP_LT, CMP_GT, CMP_CONST = 0, 1, 2, 3
# the kernel keeps the Kleene (true, false) stacks as two 32-bit registers
MAX_PROGRAM_DEPTH = 32


class RowFilterError(ValueError):
    """Unparseable / unsupported publication row filter."""


# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cmp:
    op: str  # one of _CMP_OPS
    column: str
    value: Any  # python literal (int | float | str | bool)

    def __post_init__(self):
        if self.op not in _CMP_OPS:
            raise RowFilterError(f"bad comparison op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class NullTest:
    column: str
    negated: bool  # True = IS NOT NULL


@dataclasses.dataclass(frozen=True)
class And:
    items: tuple


@dataclasses.dataclass(frozen=True)
class Or:
    items: tuple


@dataclasses.dataclass(frozen=True)
class Not:
    item: Any


def _walk_columns(node, out: set) -> None:
    if isinstance(node, (Cmp, NullTest)):
        out.add(node.column)
    elif isinstance(node, (And, Or)):
        for it in node.items:
            _walk_columns(it, out)
    elif isinstance(node, Not):
        _walk_columns(node.item, out)
    else:
        raise RowFilterError(f"bad IR node {node!r}")


def _node_json(node) -> dict:
    if isinstance(node, Cmp):
        return {"cmp": node.op, "col": node.column, "value": node.value}
    if isinstance(node, NullTest):
        return {"null_test": node.column, "negated": node.negated}
    if isinstance(node, And):
        return {"and": [_node_json(i) for i in node.items]}
    if isinstance(node, Or):
        return {"or": [_node_json(i) for i in node.items]}
    if isinstance(node, Not):
        return {"not": _node_json(node.item)}
    raise RowFilterError(f"bad IR node {node!r}")


def _node_from_json(d: dict):
    if "cmp" in d:
        return Cmp(d["cmp"], d["col"], d["value"])
    if "null_test" in d:
        return NullTest(d["null_test"], bool(d.get("negated", False)))
    if "and" in d:
        return And(tuple(_node_from_json(i) for i in d["and"]))
    if "or" in d:
        return Or(tuple(_node_from_json(i) for i in d["or"]))
    if "not" in d:
        return Not(_node_from_json(d["not"]))
    raise RowFilterError(f"bad IR json {d!r}")


def _node_sql(node) -> str:
    if isinstance(node, Cmp):
        v = node.value
        if isinstance(v, bool):
            lit = "TRUE" if v else "FALSE"
        elif isinstance(v, (int, float)):
            lit = repr(v)
        else:
            lit = "'" + str(v).replace("'", "''") + "'"
        return f'"{node.column}" {_OP_SQL[node.op]} {lit}'
    if isinstance(node, NullTest):
        return f'"{node.column}" IS {"NOT " if node.negated else ""}NULL'
    if isinstance(node, And):
        return "(" + " AND ".join(_node_sql(i) for i in node.items) + ")"
    if isinstance(node, Or):
        return "(" + " OR ".join(_node_sql(i) for i in node.items) + ")"
    if isinstance(node, Not):
        return f"(NOT {_node_sql(node.item)})"
    raise RowFilterError(f"bad IR node {node!r}")


def _fingerprint(node) -> tuple:
    if isinstance(node, Cmp):
        return ("cmp", node.op, node.column, repr(node.value))
    if isinstance(node, NullTest):
        return ("null", node.column, node.negated)
    if isinstance(node, And):
        return ("and",) + tuple(_fingerprint(i) for i in node.items)
    if isinstance(node, Or):
        return ("or",) + tuple(_fingerprint(i) for i in node.items)
    if isinstance(node, Not):
        return ("not", _fingerprint(node.item))
    raise RowFilterError(f"bad IR node {node!r}")


class RowFilter:
    """The schema-attachable IR root: a predicate tree plus the SQL text it
    came from. Hashable/immutable — it rides inside ReplicatedTableSchema
    and keys the kernel's predicate descriptors via `fingerprint()`."""

    __slots__ = ("root", "sql")

    def __init__(self, root, sql: str | None = None):
        _walk_columns(root, set())  # validates the tree shape
        self.root = root
        self.sql = sql if sql is not None else _node_sql(root)

    def __eq__(self, other) -> bool:
        return isinstance(other, RowFilter) \
            and self.fingerprint() == other.fingerprint()

    def __hash__(self) -> int:
        return hash(self.fingerprint())

    def __repr__(self) -> str:
        return f"RowFilter({self.sql!r})"

    def fingerprint(self) -> tuple:
        return _fingerprint(self.root)

    def referenced_columns(self) -> list[str]:
        out: set = set()
        _walk_columns(self.root, out)
        return sorted(out)

    def to_json(self) -> dict:
        return {"sql": self.sql, "ir": _node_json(self.root)}

    @classmethod
    def from_json(cls, d: dict) -> "RowFilter":
        return cls(_node_from_json(d["ir"]), d.get("sql"))

    # -- per-row python evaluators (workload truth) --------------------------

    def _compile_py(self, schema: TableSchema, cell) -> Callable:
        """Shared Kleene walker over one row; `cell(row, i, oid)` returns
        the parsed python value or None (NULL)."""
        idx = {c.name: (i, c.type_oid) for i, c in enumerate(schema.columns)}
        for name in self.referenced_columns():
            if name not in idx:
                raise RowFilterError(
                    f"row filter references unknown column {name!r}")
        root = self.root

        def ev(node, row) -> "bool | None":  # Kleene: True/False/None
            if isinstance(node, NullTest):
                i, oid = idx[node.column]
                is_null = cell(row, i, oid) is None
                return (not is_null) if node.negated else is_null
            if isinstance(node, Cmp):
                i, oid = idx[node.column]
                v = cell(row, i, oid)
                if v is None:
                    return None
                kind = kind_for(oid)
                if kind in _KIND_OID:
                    # dense domain: dates/timestamps compare as
                    # days/µs, which also orders the PgSpecial values
                    # (BC, ±infinity) python objects cannot
                    from ..models.table_row import _to_dense

                    return _py_cmp(node.op, _to_dense(kind, v),
                                   _dense_literal(kind, node.value))
                return _py_cmp(node.op, v,
                               _coerce_literal(node.value, kind, oid))
            if isinstance(node, And):
                vals = [ev(i2, row) for i2 in node.items]
                if any(v is False for v in vals):
                    return False
                return None if any(v is None for v in vals) else True
            if isinstance(node, Or):
                vals = [ev(i2, row) for i2 in node.items]
                if any(v is True for v in vals):
                    return True
                return None if any(v is None for v in vals) else False
            if isinstance(node, Not):
                v = ev(node.item, row)
                return None if v is None else (not v)
            raise RowFilterError(f"bad IR node {node!r}")

        def allows(row) -> bool:
            return ev(root, row) is True

        return allows

    def compile_texts(self, schema: TableSchema) -> Callable:
        """Per-row evaluator over the table's FULL column order in wire
        text form. Values parse through the oracle text codec, so the
        verdicts are exactly the host_keep/device_keep verdicts."""
        from ..postgres.codec.text import parse_cell_text

        def cell(row, i, oid):
            text = row[i]
            return None if text is None else parse_cell_text(text, oid)

        return self._compile_py(schema, cell)

    def compile_values(self, schema: TableSchema) -> Callable:
        """Per-row evaluator over ALREADY-DECODED python values (the
        parse_cell_text domain)."""
        def cell(row, i, oid):
            return row[i]

        return self._compile_py(schema, cell)


def kind_for(oid: int) -> CellKind:
    from ..models.pgtypes import kind_for_oid

    return kind_for_oid(oid)


# ---------------------------------------------------------------------------
# SQL-subset parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)"
    r"|(?P<str>'(?:[^']|'')*')"
    r"|(?P<qid>\"(?:[^\"]|\"\")*\")"
    r"|(?P<op><=|>=|<>|!=|=|<|>)"
    r"|(?P<lp>\()|(?P<rp>\))"
    r"|(?P<word>[A-Za-z_][A-Za-z_0-9$]*)"
    r")")


def _tokenize(sql: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            if sql[pos:].strip() == "":
                break
            raise RowFilterError(f"cannot tokenize row filter at {sql[pos:]!r}")
        pos = m.end()
        for name in ("num", "str", "qid", "op", "lp", "rp", "word"):
            v = m.group(name)
            if v is not None:
                out.append((name, v))
                break
    return out


def parse_row_filter(sql: str) -> RowFilter:
    """Parse a publication row filter's SQL text into the IR. Raises
    RowFilterError on anything outside the supported subset. PG wraps
    catalog rowfilter text in parens; they parse transparently."""
    toks = _tokenize(sql)
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else (None, None)

    def take():
        t = peek()
        pos[0] += 1
        return t

    def is_word(t, w):
        return t[0] == "word" and t[1].upper() == w

    def parse_or():
        items = [parse_and()]
        while is_word(peek(), "OR"):
            take()
            items.append(parse_and())
        return items[0] if len(items) == 1 else Or(tuple(items))

    def parse_and():
        items = [parse_not()]
        while is_word(peek(), "AND"):
            take()
            items.append(parse_not())
        return items[0] if len(items) == 1 else And(tuple(items))

    def parse_not():
        if is_word(peek(), "NOT"):
            take()
            return Not(parse_not())
        return parse_primary()

    def parse_literal():
        kind, v = take()
        if kind == "num":
            return float(v) if ("." in v or "e" in v.lower()) else int(v)
        if kind == "str":
            return v[1:-1].replace("''", "'")
        if kind == "word":
            u = v.upper()
            if u == "TRUE":
                return True
            if u == "FALSE":
                return False
        raise RowFilterError(f"expected literal, got {v!r}")

    def parse_primary():
        kind, v = take()
        if kind == "lp":
            inner = parse_or()
            if take()[0] != "rp":
                raise RowFilterError("unbalanced parens in row filter")
            return inner
        if kind == "qid":
            col = v[1:-1].replace('""', '"')
        elif kind == "word":
            if v.upper() in ("TRUE", "FALSE", "NOT", "AND", "OR"):
                raise RowFilterError(f"unsupported expression at {v!r}")
            col = v
        else:
            raise RowFilterError(f"expected column reference, got {v!r}")
        nkind, nv = peek()
        if nkind == "word" and nv.upper() == "IS":
            take()
            negated = False
            if is_word(peek(), "NOT"):
                take()
                negated = True
            if not is_word(peek(), "NULL"):
                raise RowFilterError("expected NULL after IS [NOT]")
            take()
            return NullTest(col, negated)
        if nkind != "op":
            raise RowFilterError(f"expected operator after column {col!r}")
        take()
        return Cmp(_OP_TOKEN[nv], col, parse_literal())

    root = parse_or()
    if pos[0] != len(toks):
        raise RowFilterError(
            f"trailing tokens in row filter: {toks[pos[0]:]!r}")
    return RowFilter(root, sql)


# ---------------------------------------------------------------------------
# literal coercion (shared by every evaluator)
# ---------------------------------------------------------------------------


def _coerce_literal(value: Any, kind: CellKind, oid: int) -> Any:
    """Literal → the python value domain parse_cell_text produces for the
    column, so comparisons run same-typed."""
    from ..postgres.codec.text import parse_cell_text

    if kind is CellKind.BOOL:
        if isinstance(value, bool):
            return value
        return parse_cell_text(str(value), oid)
    if kind in (CellKind.I16, CellKind.I32, CellKind.U32, CellKind.I64):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return parse_cell_text(str(value), oid)
        if isinstance(value, float) and value != int(value):
            raise RowFilterError(
                f"non-integral literal {value!r} for integer column")
        return int(value)
    if kind in (CellKind.F32, CellKind.F64):
        return float(value)
    if isinstance(value, str):
        return parse_cell_text(value, oid)
    return parse_cell_text(str(value), oid)


def _py_cmp(op: str, a: Any, b: Any) -> bool:
    if op == "eq":
        return a == b
    if op == "ne":
        return a != b
    if op == "lt":
        return a < b
    if op == "le":
        return a <= b
    if op == "gt":
        return a > b
    return a >= b


def _dense_literal(kind: CellKind, value: Any) -> "int | float | bool":
    """Literal in the DENSE domain (what Column.data and the device
    components encode): days for DATE, µs for TIME/TIMESTAMP[TZ]."""
    from ..models.table_row import _to_dense

    oid = _KIND_OID[kind]
    return _to_dense(kind, _coerce_literal(value, kind, oid))


# ---------------------------------------------------------------------------
# compiled form: device + host evaluators for one schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _ColBinding:
    index: int  # position among replicated columns
    kind: CellKind
    oid: int


class CompiledRowFilter:
    """One RowFilter bound to one schema's replicated-column view.
    Compiled ONCE at DeviceDecoder construction (never per batch):
    binding resolves column names to replicated indices, coerces every
    literal, decides device eligibility and lowers the kernel's postfix
    program, so the per-batch work is pure array math."""

    __slots__ = ("filter", "cols", "device_supported", "program",
                 "program_depth", "_root")

    def __init__(self, rf: RowFilter, schema: ReplicatedTableSchema):
        self.filter = rf
        by_name = {c.name: _ColBinding(i, c.kind, c.type_oid)
                   for i, c in enumerate(schema.replicated_columns)}
        cols: dict[str, _ColBinding] = {}
        for name in rf.referenced_columns():
            b = by_name.get(name)
            if b is None:
                raise RowFilterError(
                    f"row filter references column {name!r} absent from "
                    f"the replicated view of {schema.name}")
            cols[name] = b
        self.cols = cols
        self._root = rf.root
        # EVERY literal must coerce NOW, through the same path its
        # evaluator will use — a PG-valid filter the client codec cannot
        # represent ('v > 0.5' on an int column, an ISO-'T' timestamp
        # literal) must fail HERE as RowFilterError, so the decoder's
        # construction-time catch degrades to unfiltered decode with a
        # loud warning instead of raising per batch inside host_keep
        try:
            self._walk_literals(rf.root)
        except RowFilterError:
            raise
        except Exception as e:  # parse_cell_text raises EtlError etc.
            raise RowFilterError(
                f"row filter literal outside the client envelope: {e}") \
                from e
        self.device_supported = all(b.kind in DEVICE_CMP_KINDS
                                    for b in cols.values())
        self.program: tuple = ()
        self.program_depth = 0
        if self.device_supported:
            prog: list = []
            self._lower(rf.root, prog)
            self.program = tuple(prog)
            self.program_depth = program_depth(self.program)

    def _walk_literals(self, node) -> None:
        if isinstance(node, Cmp):
            b = self.cols[node.column]
            if b.kind in _KIND_OID:
                _dense_literal(b.kind, node.value)
                _coerce_literal(node.value, b.kind, _KIND_OID[b.kind])
        elif isinstance(node, (And, Or)):
            for i in node.items:
                self._walk_literals(i)
        elif isinstance(node, Not):
            self._walk_literals(node.item)

    def fingerprint(self) -> tuple:
        return self.filter.fingerprint()

    @property
    def referenced_indices(self) -> tuple[int, ...]:
        return tuple(sorted(b.index for b in self.cols.values()))

    @property
    def kernel_supported(self) -> bool:
        """True when the CUDA kernel can evaluate this filter: every
        referenced column has an exact device comparison and the postfix
        program fits the kernel's Kleene stacks."""
        return self.device_supported \
            and self.program_depth <= MAX_PROGRAM_DEPTH

    # -- plain device evaluator ----------------------------------------------

    def device_keep(self, colmap: dict, row_flags: torch.Tensor
                    ) -> torch.Tensor:
        """keep bool[R] for the fused filter (plain PyTorch).

        `colmap`: replicated column index → (comps dict, ok bool[R],
        is_null bool[R]) for every referenced column — the parsed
        components of `parsers.parse_column` (int64 tensors holding int32
        values). `row_flags`: [R] — 0 dead (bucket padding), 1 live,
        2 live + host-side force-keep (escapes / nibble-flagged /
        oversized or TOASTed referenced field: the device values are
        untrustworthy, the host re-evaluates after oracle fixup).

        keep = live & (TRUE | force-keep | not-device-evaluable); rows the
        device cannot judge are conservatively kept and re-judged on host.
        """
        t, _ = self._dev_node(self._root, colmap)
        unevaluable = None
        for b in self.cols.values():
            _, ok, is_null = colmap[b.index]
            bad = (~ok) & (~is_null)
            unevaluable = bad if unevaluable is None else (unevaluable | bad)
        live = row_flags > 0
        force = row_flags > 1
        keep = t | force
        if unevaluable is not None:
            keep = keep | unevaluable
        return keep & live

    def _dev_node(self, node, colmap):
        """(is_true, is_false) bool[R] pair — Kleene three-valued logic;
        neither set = unknown (a NULL-involved comparison)."""
        if isinstance(node, NullTest):
            _, _, is_null = colmap[self.cols[node.column].index]
            t = (~is_null) if node.negated else is_null
            return t, ~t
        if isinstance(node, Cmp):
            b = self.cols[node.column]
            comps, _, is_null = colmap[b.index]
            res = _device_cmp(b.kind, node.op, comps,
                              _dense_literal(b.kind, node.value))
            known = ~is_null
            return known & res, known & ~res
        if isinstance(node, And):
            ts, fs = zip(*(self._dev_node(i, colmap) for i in node.items))
            t = ts[0]
            for x in ts[1:]:
                t = t & x
            f = fs[0]
            for x in fs[1:]:
                f = f | x
            return t, f
        if isinstance(node, Or):
            ts, fs = zip(*(self._dev_node(i, colmap) for i in node.items))
            t = ts[0]
            for x in ts[1:]:
                t = t | x
            f = fs[0]
            for x in fs[1:]:
                f = f & x
            return t, f
        if isinstance(node, Not):
            t, f = self._dev_node(node.item, colmap)
            return f, t
        raise RowFilterError(f"bad IR node {node!r}")

    # -- the kernel's postfix program ----------------------------------------

    def _lower(self, node, out: list) -> None:
        """Append the postfix instructions of `node` to `out`; columns are
        replicated indices (the wrapper maps them to spec slots)."""
        if isinstance(node, NullTest):
            b = self.cols[node.column]
            out.append((P_NULLTEST, b.index, 0, int(node.negated), 0, 0, 0, 0))
        elif isinstance(node, Cmp):
            b = self.cols[node.column]
            out.append((P_CMP, b.index) + _fold_cmp(
                b.kind, node.op, _dense_literal(b.kind, node.value)))
        elif isinstance(node, (And, Or)):
            for i in node.items:
                self._lower(i, out)
            out.append((P_AND if isinstance(node, And) else P_OR, 0, 0, 0,
                        len(node.items), 0, 0, 0))
        elif isinstance(node, Not):
            self._lower(node.item, out)
            out.append((P_NOT, 0, 0, 0, 0, 0, 0, 0))
        else:
            raise RowFilterError(f"bad IR node {node!r}")

    # -- host evaluator ------------------------------------------------------

    def host_keep(self, batch) -> np.ndarray:
        """keep bool[n] over a decoded ColumnarBatch — the oracle the
        device path must agree with bit for bit on evaluable rows. Dense
        referenced columns compare vectorized in the dense domain;
        object/text columns (NUMERIC/text/uuid/…) fall back to per-row
        python over parse-exact values. TOAST-unchanged referenced cells
        keep the row (the value is unknowable client-side)."""
        n = batch.num_rows
        t, _ = self._host_node(self._root, batch, n)
        keep = t
        toast_any = None
        for b in self.cols.values():
            c = batch.columns[b.index]
            if c.toast_unchanged is not None:
                toast_any = c.toast_unchanged if toast_any is None \
                    else (toast_any | c.toast_unchanged)
        if toast_any is not None:
            keep = keep | toast_any
        return keep

    def _host_values(self, b: _ColBinding, batch, n: int):
        """(comparable value array/list, present bool[n])."""
        c = batch.columns[b.index]
        present = np.asarray(c.validity[:n], dtype=bool)
        if c.toast_unchanged is not None:
            present = present & ~np.asarray(c.toast_unchanged[:n], dtype=bool)
        if c.is_dense:
            return np.asarray(c.data[:n]), present
        vals = [c.value(i) if present[i] else None for i in range(n)]
        return vals, present

    def _host_node(self, node, batch, n: int):
        if isinstance(node, NullTest):
            b = self.cols[node.column]
            _, present = self._host_values(b, batch, n)
            t = ~present if not node.negated else present
            return t, ~t
        if isinstance(node, Cmp):
            b = self.cols[node.column]
            vals, present = self._host_values(b, batch, n)
            if isinstance(vals, np.ndarray):
                lit = _dense_literal(b.kind, node.value)
                with np.errstate(invalid="ignore"):
                    res = _np_cmp(node.op, vals, lit)
            else:
                lit = _coerce_literal(node.value, b.kind, _KIND_OID[b.kind]) \
                    if b.kind in _KIND_OID else node.value
                res = np.fromiter(
                    (bool(_py_cmp(node.op, v, lit)) if v is not None
                     else False for v in vals), dtype=bool, count=n)
            return present & res, present & ~res
        if isinstance(node, And):
            ts, fs = zip(*(self._host_node(i, batch, n) for i in node.items))
            return np.logical_and.reduce(ts), np.logical_or.reduce(fs)
        if isinstance(node, Or):
            ts, fs = zip(*(self._host_node(i, batch, n) for i in node.items))
            return np.logical_or.reduce(ts), np.logical_and.reduce(fs)
        if isinstance(node, Not):
            t, f = self._host_node(node.item, batch, n)
            return f, t
        raise RowFilterError(f"bad IR node {node!r}")


def _np_cmp(op: str, a: np.ndarray, b) -> np.ndarray:
    if op == "eq":
        return a == b
    if op == "ne":
        return a != b
    if op == "lt":
        return a < b
    if op == "le":
        return a <= b
    if op == "gt":
        return a > b
    return a >= b


def program_depth(program: tuple) -> int:
    """Most Kleene stack entries the postfix `program` holds at once."""
    depth = top = 0
    for ins in program:
        if ins[0] in (P_CMP, P_NULLTEST):
            top += 1
        elif ins[0] in (P_AND, P_OR):
            top -= ins[4] - 1
        depth = max(depth, top)
    return depth


# -- device comparisons per kind --------------------------------------------


def _limbs_of(mag: int) -> tuple[int, int, int]:
    return mag % 10**9, (mag // 10**9) % 10**9, mag // 10**18


def _lex3(gt_hi, eq_hi, gt_mid, eq_mid, gt_lo):
    """a > b over a 3-component lexicographic compare, given per-component
    gt/eq masks (hi → lo)."""
    return gt_hi | (eq_hi & (gt_mid | (eq_mid & gt_lo)))


def _device_cmp(kind: CellKind, op: str, comps: dict, lit):
    """Exact comparison of parsed components against a dense-domain
    literal; multi-word values compare limb-lexicographic, as the
    reference's int32 program does."""
    if op == "ne":
        return ~_device_cmp(kind, "eq", comps, lit)
    if op == "le":
        return ~_device_cmp(kind, "gt", comps, lit)
    if op == "ge":
        return ~_device_cmp(kind, "lt", comps, lit)

    if kind is CellKind.BOOL:
        v = comps["v"]
        b = 1 if lit else 0
        if op == "eq":
            return v == b
        if op == "lt":
            return v < b
        return v > b
    if kind is CellKind.U32:
        # the parsed component wraps uint32 values into int32; its low 32
        # bits are the unsigned value (the reference compares in
        # sign-flipped int32 space, which orders the same)
        v = comps["v"]
        lit = int(lit)
        if lit < 0 or lit > 2**32 - 1:
            return _const_mask(v, op, lit, lit > 0)
        u = v & 0xFFFFFFFF
        if op == "eq":
            return u == lit
        if op == "lt":
            return u < lit
        return u > lit
    if kind in (CellKind.I16, CellKind.I32, CellKind.DATE):
        v = comps["v"] if kind is not CellKind.DATE else comps["days"]
        lit = int(lit)
        # constant-fold literals outside the int32 range (the reference's
        # int32 compare would wrap): v < 10**12 is simply always true
        if lit < -(2**31) or lit > 2**31 - 1:
            return _const_mask(v, op, lit, lit > 0)
        if op == "eq":
            return v == lit
        if op == "lt":
            return v < lit
        return v > lit
    if kind is CellKind.I64:
        neg = comps["neg"] > 0
        l0, l1, l2 = comps["l0"], comps["l1"], comps["l2"]
        nonzero = (l0 > 0) | (l1 > 0) | (l2 > 0)
        sign_neg = neg & nonzero  # "-0" is 0
        lit = int(lit)
        lneg = lit < 0
        c0, c1, c2 = _limbs_of(abs(lit))
        if c2 >= 10**9:
            # |literal| beyond any parseable int8 text — constant fold
            return _const_mask(l0, op, lit, not lneg)
        mag_eq = (l0 == c0) & (l1 == c1) & (l2 == c2)
        mag_gt = _lex3(l2 > c2, l2 == c2, l1 > c1, l1 == c1, l0 > c0)
        if op == "eq":
            return mag_eq & (sign_neg == lneg)
        if op == "gt":
            if lneg:
                return (~sign_neg) | (sign_neg & ~mag_gt & ~mag_eq)
            return (~sign_neg) & mag_gt
        if lneg:
            return sign_neg & mag_gt
        return sign_neg | ((~sign_neg) & ~mag_gt & ~mag_eq)
    if kind is CellKind.TIME:
        ms, us = comps["ms"], comps["us"]
        lit = int(lit)
        lms, lus = lit // 1000, lit % 1000
        if op == "eq":
            return (ms == lms) & (us == lus)
        if op == "gt":
            return (ms > lms) | ((ms == lms) & (us > lus))
        return (ms < lms) | ((ms == lms) & (us < lus))
    if kind in (CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ):
        days, ms, us = comps["days"], comps["ms"], comps["us"]
        # tz folding can push ms out of [0, 86_400_000); one borrow/carry
        # renormalizes (|tz| ≤ 16h < 1 day)
        day_ms = 86_400_000
        borrow = ms < 0
        carry = ms >= day_ms
        days_n = days - borrow.long() + carry.long()
        ms_n = ms + torch.where(borrow, day_ms, 0) \
            - torch.where(carry, day_ms, 0)
        lit = int(lit)
        ld, rem = divmod(lit, 86_400_000_000)
        lms, lus = rem // 1000, rem % 1000
        if abs(ld) > 4_000_000:  # beyond any parseable date
            return _const_mask(days, op, lit, ld > 0)
        eq = (days_n == ld) & (ms_n == lms) & (us == lus)
        gt = _lex3(days_n > ld, days_n == ld, ms_n > lms, ms_n == lms,
                   us > lus)
        if op == "eq":
            return eq
        if op == "gt":
            return gt
        return ~gt & ~eq
    raise RowFilterError(f"kind {kind} has no device comparison")


def _const_value(op: str, lit_is_big_positive: bool) -> bool:
    """The value every in-range row compares to against a literal no
    in-range value can reach."""
    if op == "eq":
        return False
    # lit far above every value: v < lit true, v > lit false (and mirrored)
    return op == "lt" if lit_is_big_positive else op == "gt"


def _const_mask(ref, op: str, lit, lit_is_big_positive: bool):
    return torch.full_like(ref, _const_value(op, lit_is_big_positive),
                           dtype=torch.bool)


def _fold_cmp(kind: CellKind, op: str, lit) -> tuple:
    """(cmp, negate, a, b, c, d) of one comparison leaf of the kernel's
    program: the host half of `_device_cmp`, folded once. `ne`/`le`/`ge`
    become the negation of `eq`/`gt`/`lt`; a literal no in-range value
    can reach becomes CMP_CONST with its value in `a`."""
    negate = op in ("ne", "le", "ge")
    base = {"ne": "eq", "le": "gt", "ge": "lt"}.get(op, op)
    cmp = {"eq": CMP_EQ, "lt": CMP_LT, "gt": CMP_GT}[base]

    def const(big_positive: bool) -> tuple:
        return (CMP_CONST, int(negate),
                int(_const_value(base, big_positive)), 0, 0, 0)

    if kind is CellKind.BOOL:
        return (cmp, int(negate), 1 if lit else 0, 0, 0, 0)
    lit = int(lit)
    if kind is CellKind.U32:
        if lit < 0 or lit > 2**32 - 1:
            return const(lit > 0)
        biased = (lit ^ 0x8000_0000) & 0xFFFF_FFFF
        return (cmp, int(negate),
                biased - 2**32 if biased >= 2**31 else biased, 0, 0, 0)
    if kind in (CellKind.I16, CellKind.I32, CellKind.DATE):
        if lit < -(2**31) or lit > 2**31 - 1:
            return const(lit > 0)
        return (cmp, int(negate), lit, 0, 0, 0)
    if kind is CellKind.I64:
        lneg = lit < 0
        c0, c1, c2 = _limbs_of(abs(lit))
        if c2 >= 10**9:
            return const(not lneg)
        return (cmp, int(negate), c0, c1, c2, int(lneg))
    if kind is CellKind.TIME:
        return (cmp, int(negate), lit // 1000, lit % 1000, 0, 0)
    if kind in (CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ):
        ld, rem = divmod(lit, 86_400_000_000)
        if abs(ld) > 4_000_000:
            return const(ld > 0)
        return (cmp, int(negate), ld, rem // 1000, rem % 1000, 0)
    raise RowFilterError(f"kind {kind} has no device comparison")


# ---------------------------------------------------------------------------
# convenience
# ---------------------------------------------------------------------------


def compile_row_filter(rf: "RowFilter | str",
                       schema: ReplicatedTableSchema) -> CompiledRowFilter:
    """Bind a RowFilter (or its SQL text) to a schema. Call at decoder
    construction only — never per batch."""
    if isinstance(rf, str):
        rf = parse_row_filter(rf)
    return CompiledRowFilter(rf, schema)
