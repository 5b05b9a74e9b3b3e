"""Table schemas, replication/identity masks, schema diffs.

Copy of the reference's `etl_tpu/models/schema.py`.

Reference parity:
  - `TableId`/`TableName`/`ColumnSchema`/`TableSchema`
    (crates/etl-postgres/src/schema.rs:213-286)
  - `ReplicationMask`/`IdentityMask`/`ReplicatedTableSchema`
    (crates/etl/src/schema.rs:69,207,344) — bit-per-column masks over the
    schema's column order; the replicated view is the positional decode view
    used by pgoutput tuple decode.
  - `SchemaDiff`/`ColumnChange` (crates/etl/src/schema.rs:729-770).

TPU-first notes: masks are also exposed as numpy bool vectors
(`as_bool_array`) so publication column filtering can be applied on device
as a gather over replicated column indices.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Iterable, Sequence

import numpy as np

from .pgtypes import CellKind, kind_for_oid, type_name

TableId = int  # pg_class OID of the table
SnapshotId = int  # LSN of the DDL message creating a schema version (0 = initial)


@dataclass(frozen=True, slots=True)
class TableName:
    schema: str
    name: str

    def __str__(self) -> str:
        return f"{self.schema}.{self.name}"

    def quoted(self) -> str:
        s = self.schema.replace('"', '""')
        n = self.name.replace('"', '""')
        return f'"{s}"."{n}"'


@dataclass(frozen=True, slots=True)
class ColumnSchema:
    """One column. `primary_key_ordinal` is the 1-based position in the PK,
    or None (reference: ColumnSchema, etl-postgres/src/schema.rs:213)."""

    name: str
    type_oid: int
    modifier: int = -1
    nullable: bool = True
    primary_key_ordinal: int | None = None
    default_expression: str | None = None

    @property
    def kind(self) -> CellKind:
        return kind_for_oid(self.type_oid)

    @property
    def is_primary_key(self) -> bool:
        return self.primary_key_ordinal is not None

    @property
    def type_name(self) -> str:
        return type_name(self.type_oid)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "type_oid": self.type_oid,
            "modifier": self.modifier,
            "nullable": self.nullable,
            "primary_key_ordinal": self.primary_key_ordinal,
            "default_expression": self.default_expression,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ColumnSchema":
        return cls(
            name=d["name"],
            type_oid=d["type_oid"],
            modifier=d.get("modifier", -1),
            nullable=d.get("nullable", True),
            primary_key_ordinal=d.get("primary_key_ordinal"),
            default_expression=d.get("default_expression"),
        )


@dataclass(frozen=True)
class TableSchema:
    id: TableId
    name: TableName
    columns: tuple[ColumnSchema, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "columns", tuple(self.columns))

    def column_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)

    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    def primary_key_columns(self) -> list[ColumnSchema]:
        pk = [c for c in self.columns if c.is_primary_key]
        pk.sort(key=lambda c: c.primary_key_ordinal or 0)
        return pk

    def has_primary_key(self) -> bool:
        return any(c.is_primary_key for c in self.columns)

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "schema": self.name.schema,
            "name": self.name.name,
            "columns": [c.to_json() for c in self.columns],
        }

    @classmethod
    def from_json(cls, d: dict) -> "TableSchema":
        return cls(
            id=d["id"],
            name=TableName(d["schema"], d["name"]),
            columns=tuple(ColumnSchema.from_json(c) for c in d["columns"]),
        )


class ColumnMask:
    """Immutable bit-per-column mask over a table schema's column order
    (reference: ReplicationMask/IdentityMask, crates/etl/src/schema.rs:69,207)."""

    __slots__ = ("_bits", "_n")

    def __init__(self, bits: Iterable[bool]):
        b = tuple(bool(x) for x in bits)
        self._bits = b
        self._n = len(b)

    @classmethod
    def all_set(cls, n: int) -> "ColumnMask":
        return cls([True] * n)

    @classmethod
    def from_column_names(cls, schema: TableSchema, names: Iterable[str]) -> "ColumnMask":
        wanted = set(names)
        return cls(c.name in wanted for c in schema.columns)

    @classmethod
    def from_bytes(cls, raw: bytes, n: int) -> "ColumnMask":
        # packed little-endian bit order, one bit per column
        return cls(bool(raw[i // 8] & (1 << (i % 8))) for i in range(n))

    def to_bytes(self) -> bytes:
        out = bytearray((self._n + 7) // 8)
        for i, b in enumerate(self._bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> bool:
        return self._bits[i]

    def __iter__(self):
        return iter(self._bits)

    def __eq__(self, other) -> bool:
        return isinstance(other, ColumnMask) and self._bits == other._bits

    def __hash__(self) -> int:
        return hash(self._bits)

    def __repr__(self) -> str:
        return "ColumnMask(" + ",".join("1" if b else "0" for b in self._bits) + ")"

    def count(self) -> int:
        return sum(self._bits)

    def indices(self) -> list[int]:
        return [i for i, b in enumerate(self._bits) if b]

    def as_bool_array(self) -> np.ndarray:
        return np.asarray(self._bits, dtype=np.bool_)


class ReplicatedTableSchema:
    """A table schema plus its replication & identity masks: the positional
    view that pgoutput tuples decode against (reference:
    crates/etl/src/schema.rs:344; ordering rationale at apply.rs:2386-2394 —
    pgoutput RELATION messages list only replicated columns, in schema order).
    """

    __slots__ = ("table_schema", "replication_mask", "identity_mask",
                 "row_predicate", "_replicated_columns", "_replicated_indices")

    def __init__(self, table_schema: TableSchema, replication_mask: ColumnMask,
                 identity_mask: ColumnMask, row_predicate=None):
        n = len(table_schema.columns)
        if len(replication_mask) != n or len(identity_mask) != n:
            raise ValueError("mask length != column count")
        self.table_schema = table_schema
        self.replication_mask = replication_mask
        self.identity_mask = identity_mask
        # publication row filter (ops/predicate.RowFilter | None): the
        # WHERE clause this table's publication carries. The decode engine
        # compiles it into the fused device program (coerce → filter →
        # transpose with in-kernel compaction); kept OUT of __eq__ —
        # schema-diff semantics compare the positional decode view, and a
        # filter change is a publication change, not a DDL change.
        self.row_predicate = row_predicate
        self._replicated_indices = replication_mask.indices()
        self._replicated_columns = tuple(
            table_schema.columns[i] for i in self._replicated_indices
        )

    def with_row_predicate(self, row_predicate) -> "ReplicatedTableSchema":
        """Copy with the publication row filter attached (None detaches).
        Identity-preserving when nothing changes — the table cache's
        `is`-based decoder reuse must survive RELATION re-sends."""
        if row_predicate is self.row_predicate:
            return self
        return ReplicatedTableSchema(self.table_schema, self.replication_mask,
                                     self.identity_mask, row_predicate)

    @classmethod
    def with_all_columns(cls, schema: TableSchema) -> "ReplicatedTableSchema":
        n = len(schema.columns)
        identity = ColumnMask(c.is_primary_key for c in schema.columns)
        if identity.count() == 0:
            identity = ColumnMask.all_set(n)  # replica identity full fallback
        return cls(schema, ColumnMask.all_set(n), identity)

    @property
    def id(self) -> TableId:
        return self.table_schema.id

    @property
    def name(self) -> TableName:
        return self.table_schema.name

    @property
    def replicated_columns(self) -> tuple[ColumnSchema, ...]:
        return self._replicated_columns

    @property
    def replicated_indices(self) -> list[int]:
        return self._replicated_indices

    def replicated_column_count(self) -> int:
        return len(self._replicated_columns)

    def identity_columns(self) -> list[ColumnSchema]:
        return [self.table_schema.columns[i] for i in self.identity_mask.indices()]

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ReplicatedTableSchema)
            and self.table_schema == other.table_schema
            and self.replication_mask == other.replication_mask
            and self.identity_mask == other.identity_mask
        )

    def to_json(self) -> dict:
        out = {
            "table": self.table_schema.to_json(),
            "replicated": self.replication_mask.indices(),
            "identity": self.identity_mask.indices(),
        }
        if self.row_predicate is not None:
            out["row_filter"] = self.row_predicate.to_json()
        return out

    @classmethod
    def from_json(cls, d: dict) -> "ReplicatedTableSchema":
        schema = TableSchema.from_json(d["table"])
        n = len(schema.columns)
        repl = set(d["replicated"])
        ident = set(d["identity"])
        pred = None
        if d.get("row_filter") is not None:
            from ..ops.predicate import RowFilter  # late: models←ops cycle

            pred = RowFilter.from_json(d["row_filter"])
        return cls(schema,
                   ColumnMask(i in repl for i in range(n)),
                   ColumnMask(i in ident for i in range(n)),
                   row_predicate=pred)

    def __repr__(self) -> str:
        return (f"ReplicatedTableSchema({self.table_schema.name}, "
                f"repl={self.replication_mask}, ident={self.identity_mask})")


@dataclass(frozen=True, slots=True)
class ColumnModification:
    """A changed column attribute (reference ColumnModification,
    crates/etl/src/schema.rs:745)."""

    name: str
    old: ColumnSchema
    new: ColumnSchema

    @property
    def type_changed(self) -> bool:
        return (self.old.type_oid, self.old.modifier) != (self.new.type_oid, self.new.modifier)

    @property
    def nullability_changed(self) -> bool:
        return self.old.nullable != self.new.nullable


@dataclass(frozen=True)
class SchemaDiff:
    """Column-level diff between two schema versions, for destination DDL
    (reference SchemaDiff, crates/etl/src/schema.rs:729-770)."""

    added: tuple[ColumnSchema, ...] = ()
    dropped: tuple[ColumnSchema, ...] = ()
    modified: tuple[ColumnModification, ...] = ()

    def is_empty(self) -> bool:
        return not (self.added or self.dropped or self.modified)

    @classmethod
    def between(cls, old: TableSchema, new: TableSchema) -> "SchemaDiff":
        old_by_name = {c.name: c for c in old.columns}
        new_by_name = {c.name: c for c in new.columns}
        added = tuple(c for c in new.columns if c.name not in old_by_name)
        dropped = tuple(c for c in old.columns if c.name not in new_by_name)
        modified = tuple(
            ColumnModification(name, old_by_name[name], new_by_name[name])
            for name in (set(old_by_name) & set(new_by_name))
            if old_by_name[name] != new_by_name[name]
        )
        return cls(added=added, dropped=dropped,
                   modified=tuple(sorted(modified, key=lambda m: m.name)))


def apply_column_changes(schema: TableSchema, new_columns: Sequence[ColumnSchema]) -> TableSchema:
    """New schema version with replaced column list (same id/name)."""
    return replace(schema, columns=tuple(new_columns))
