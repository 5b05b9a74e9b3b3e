"""Shared per-table protocol state.

Reference parity: `SharedTableCache` (crates/etl/src/replication/
table_cache.rs:53). Invariant (table_cache.rs:10-44): exactly one worker
owns protocol interpretation for a table at a time — the apply worker for
Ready tables, the table-sync worker for its own table. The cache maps
relation id → the current positional decode view (from RELATION messages),
shared so a handoff does not re-learn schemas.

Copy of the reference's `etl_tpu/runtime/table_cache.py`.
"""

from __future__ import annotations

from ..models.schema import ReplicatedTableSchema, TableId


class SharedTableCache:
    def __init__(self) -> None:
        self._schemas: dict[TableId, ReplicatedTableSchema] = {}
        # publication row filters by table (ops/predicate.RowFilter):
        # RELATION messages carry no filter, so `set` re-attaches the
        # pipeline-discovered predicate to every decode view that enters
        # the cache — the decoder compiled from that view then fuses the
        # filter into its device program
        self._row_predicates: dict[TableId, object] = {}

    def get(self, table_id: TableId) -> ReplicatedTableSchema | None:
        return self._schemas.get(table_id)

    def set_row_predicates(self, predicates: "dict[TableId, object]") -> None:
        """Install the publication's parsed row filters (Pipeline.start).
        Already-cached schemas re-attach so a worker handoff can't decode
        through a filterless stale view."""
        self._row_predicates = dict(predicates)
        for tid, schema in list(self._schemas.items()):
            pred = self._row_predicates.get(tid)
            if pred is not None:
                self._schemas[tid] = schema.with_row_predicate(pred)

    def set(self, schema: ReplicatedTableSchema) -> None:
        pred = self._row_predicates.get(schema.id)
        if pred is not None and schema.row_predicate is None:
            schema = schema.with_row_predicate(pred)
        # identity-preserving on equal schemas: the walsender re-sends
        # RELATION per transaction; keeping the existing object lets
        # downstream `is` checks (assembler decoder reuse — and with it the
        # per-schema jit cache) survive the re-sends
        prev = self._schemas.get(schema.id)
        if prev is None or prev != schema:
            self._schemas[schema.id] = schema

    def remove(self, table_id: TableId) -> None:
        self._schemas.pop(table_id, None)

    def table_ids(self) -> list[TableId]:
        return list(self._schemas)
