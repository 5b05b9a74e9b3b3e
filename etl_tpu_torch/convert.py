"""State carried across from the reference as plain data.

The port imports nothing of `etl_tpu`; a caller holding the reference's
objects (a schema, a staged batch) hands their plain contents to these
functions and gets the port's equivalents, so both sides can decode
identical inputs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .models.schema import (ColumnMask, ColumnSchema, ReplicatedTableSchema,
                            TableName, TableSchema)
from .ops.predicate import RowFilter, parse_row_filter
from .ops.staging import StagedBatch


def schema_from_plain(table_id: int, schema_name: str, table_name: str,
                      columns: Sequence[tuple],
                      replicated: Sequence[bool],
                      identity: Sequence[bool],
                      row_filter: "dict | str | None" = None
                      ) -> ReplicatedTableSchema:
    """The port's ReplicatedTableSchema from plain data: `columns` holds
    (name, type_oid, modifier, nullable, primary_key_ordinal) per column
    of the table, `replicated` and `identity` one flag per column, and
    `row_filter` the publication row filter as the reference's
    `RowFilter.to_json()` dict or as its SQL text."""
    table = TableSchema(
        table_id, TableName(schema_name, table_name),
        tuple(ColumnSchema(name, oid, modifier=mod, nullable=nullable,
                           primary_key_ordinal=pk)
              for name, oid, mod, nullable, pk in columns))
    pred = None
    if isinstance(row_filter, dict):
        pred = RowFilter.from_json(row_filter)
    elif row_filter is not None:
        pred = parse_row_filter(row_filter)
    return ReplicatedTableSchema(table, ColumnMask(replicated),
                                 ColumnMask(identity), row_predicate=pred)


def staged_from_arrays(data: np.ndarray, offsets: np.ndarray,
                       lengths: np.ndarray, nulls: np.ndarray,
                       toast: np.ndarray, n_rows: int,
                       cpu_fallback_rows: np.ndarray | None = None,
                       copy_escapes: bool = False,
                       allow_row_filter: bool = True) -> StagedBatch:
    """The port's StagedBatch from a staged batch's arrays (uint8 data,
    int32 offsets and lengths [R, C], bool nulls and toast [R, C])."""
    fb = np.zeros(0, dtype=np.int64) if cpu_fallback_rows is None \
        else np.asarray(cpu_fallback_rows, dtype=np.int64)
    return StagedBatch(
        np.ascontiguousarray(data, dtype=np.uint8),
        np.ascontiguousarray(offsets, dtype=np.int32),
        np.ascontiguousarray(lengths, dtype=np.int32),
        np.ascontiguousarray(nulls, dtype=np.bool_),
        np.ascontiguousarray(toast, dtype=np.bool_),
        int(n_rows), cpu_fallback_rows=fb, copy_escapes=bool(copy_escapes),
        allow_row_filter=bool(allow_row_filter))
