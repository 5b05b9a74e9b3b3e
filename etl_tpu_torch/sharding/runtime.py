"""Shard-scoped runtime: one pod's view of a shared pipeline store.

A sharded deployment runs K replicator pods against ONE publication and
ONE shared state store. Each pod wraps the store in `ShardScopedStore`,
which makes the shard boundary structural instead of advisory:

  reads   — `get_table_states()` / `owned_table_states()` return only
            the tables this shard's ShardMap slice owns, so the
            table-sync pool spawns workers for owned tables only and
            the pipeline's init/purge sweep can never touch a sibling
            shard's rows;
  writes  — table-state and destination-metadata writes to a table the
            map assigns elsewhere raise `SHARD_NOT_OWNED`; any write
            after the coordinator bumped the authoritative epoch raises
            `SHARD_EPOCH_STALE` (both MANUAL, not retryable — a stale
            pod must be rolled with the new topology, not retried);
  schemas — schema-store writes pass through UNguarded: the apply loop
            stores DDL schema versions for every table it sees on the
            wire (owned or not) so a later rebalance hands the new owner
            a warm schema history.

Progress keys pass through untouched: slot names already carry the
`_s{shard}` suffix (postgres/slots.py), so shards cannot collide.

Copy of the reference's `etl_tpu/sharding/runtime.py`. The view wraps any
of the port's stores (`MemoryStore`, `SqliteStore`, `PostgresStore`)
through the `PipelineStore` surface alone, so the fence is the same on
each.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..analysis.annotations import shard_scoped
from ..models.errors import ErrorKind, EtlError
from ..models.lsn import Lsn
from ..models.schema import ReplicatedTableSchema, SnapshotId, TableId
from ..models.table_state import TableState
from ..store.base import (DestinationTableMetadata, PipelineStore,
                          ProgressKey)
from .shardmap import ShardAssignment, ShardMap


@dataclass(frozen=True)
class ShardIdentity:
    """Which slice of the publication THIS pod owns, at which epoch."""

    pipeline_id: int
    shard: int
    shard_count: int
    epoch: int

    def shard_map(self) -> ShardMap:
        return ShardMap(self.shard_count, self.epoch)

    def describe(self) -> dict:
        return {"shard": self.shard, "shard_count": self.shard_count,
                "epoch": self.epoch}


async def resolve_shard_scope(store: PipelineStore,
                              config) -> "ShardScopedStore":
    """Adopt (or bootstrap) the authoritative shard assignment and wrap
    `store` in this pod's shard view.

    The pod's configured shard_count must MATCH the store's record: a
    pod rolled out with a stale K would otherwise compute a different
    ShardMap and silently fight its siblings over table ownership."""
    assignment = await store.get_shard_assignment()
    if assignment is None:
        assignment = ShardAssignment(epoch=0,
                                     shard_count=config.shard_count)
        await store.update_shard_assignment(assignment)
    if assignment.shard_count != config.shard_count:
        raise EtlError(
            ErrorKind.SHARD_EPOCH_STALE,
            f"pod configured for shard_count={config.shard_count} but the "
            f"store's authoritative assignment (epoch {assignment.epoch}) "
            f"says shard_count={assignment.shard_count} — roll the pod "
            f"with the current topology")
    if not 0 <= config.shard < assignment.shard_count:
        raise EtlError(
            ErrorKind.CONFIG_INVALID,
            f"shard index {config.shard} out of range for "
            f"shard_count={assignment.shard_count}")
    identity = ShardIdentity(
        pipeline_id=config.pipeline_id, shard=config.shard,
        shard_count=assignment.shard_count, epoch=assignment.epoch)
    return ShardScopedStore(store, identity)


class ShardScopedStore(PipelineStore):
    """One shard's filtered, write-fenced view of a shared store."""

    def __init__(self, inner: PipelineStore, identity: ShardIdentity):
        self._inner = inner
        self.identity = identity
        self._map = identity.shard_map()

    # -- ownership fence -----------------------------------------------------

    def owns(self, table_id: TableId) -> bool:
        return self._map.owns(table_id, self.identity.shard)

    async def _check_write(self, table_id: TableId) -> None:
        from ..telemetry.metrics import (ETL_SHARD_WRITE_REFUSALS_TOTAL,
                                         registry)

        assignment = await self._inner.get_shard_assignment()
        if assignment is not None and assignment.epoch != self.identity.epoch:
            registry.counter_inc(ETL_SHARD_WRITE_REFUSALS_TOTAL,
                                 labels={"reason": "epoch_stale"})
            raise EtlError(
                ErrorKind.SHARD_EPOCH_STALE,
                f"shard {self.identity.shard} holds epoch "
                f"{self.identity.epoch} but the store's authoritative "
                f"epoch is {assignment.epoch}; refusing the write to "
                f"table {table_id}")
        if not self.owns(table_id):
            registry.counter_inc(ETL_SHARD_WRITE_REFUSALS_TOTAL,
                                 labels={"reason": "not_owned"})
            raise EtlError(
                ErrorKind.SHARD_NOT_OWNED,
                f"table {table_id} belongs to shard "
                f"{self._map.shard_of(table_id)}, not shard "
                f"{self.identity.shard} (epoch {self.identity.epoch})")

    # -- StateStore ----------------------------------------------------------

    @shard_scoped
    async def owned_table_states(self) -> dict[TableId, TableState]:
        """THE sanctioned filtered read: the shared store's full list
        narrowed to this shard's slice."""
        states = await self._inner.get_table_states()  # etl-lint: ignore[cross-shard-table-access] — this IS the shard filter the rule points everyone at
        return {tid: st for tid, st in states.items() if self.owns(tid)}

    async def get_table_states(self) -> dict[TableId, TableState]:
        # the PipelineStore contract spelling: runtime internals (the
        # table-sync pool, the init sweep) read through the same filter
        return await self.owned_table_states()

    async def get_table_state(self, table_id: TableId) -> TableState | None:
        if not self.owns(table_id):
            return None
        return await self._inner.get_table_state(table_id)

    async def update_table_state(self, table_id: TableId,
                                 state: TableState) -> None:
        await self._check_write(table_id)
        await self._inner.update_table_state(table_id, state)

    async def delete_table_state(self, table_id: TableId) -> None:
        await self._check_write(table_id)
        await self._inner.delete_table_state(table_id)

    async def get_durable_progress(self, key: ProgressKey) -> Lsn | None:
        return await self._inner.get_durable_progress(key)

    async def update_durable_progress(self, key: ProgressKey,
                                      lsn: Lsn) -> bool:
        return await self._inner.update_durable_progress(key, lsn)

    async def delete_durable_progress(self, key: ProgressKey) -> None:
        await self._inner.delete_durable_progress(key)

    async def get_destination_metadata(
            self, table_id: TableId) -> DestinationTableMetadata | None:
        return await self._inner.get_destination_metadata(table_id)

    async def update_destination_metadata(
            self, meta: DestinationTableMetadata) -> None:
        await self._check_write(meta.table_id)
        await self._inner.update_destination_metadata(meta)

    async def delete_destination_metadata(self, table_id: TableId) -> None:
        await self._check_write(table_id)
        await self._inner.delete_destination_metadata(table_id)

    async def get_shard_assignment(self) -> ShardAssignment | None:
        return await self._inner.get_shard_assignment()

    async def update_shard_assignment(self,
                                      assignment: ShardAssignment) -> None:
        # pods never move the assignment — only the coordinator does,
        # against the RAW store
        raise EtlError(
            ErrorKind.SHARD_NOT_OWNED,
            "shard-scoped runtimes cannot rewrite the shard assignment; "
            "drive rebalances through ShardCoordinator")

    # -- dead-letter / quarantine (docs/dead-letter.md) -----------------------
    # Reads pass through (the CLI and invariant checkers read the whole
    # pipeline's DLQ); WRITES are shard-fenced exactly like table-state
    # writes — a pod may only dead-letter or quarantine tables its
    # ShardMap slice owns, and never after the coordinator bumped the
    # epoch (a stale pod parking a freshly-rehomed table would fight the
    # new owner's delivery).

    async def append_dead_letters(self, entries) -> "list[int]":
        for e in entries:
            await self._check_write(e.table_id)
        return await self._inner.append_dead_letters(entries)

    async def list_dead_letters(self, table_id=None, status="dead"):
        return await self._inner.list_dead_letters(table_id, status)

    async def get_dead_letter(self, entry_id: int):
        return await self._inner.get_dead_letter(entry_id)

    async def set_dead_letter_status(self, entry_id: int,
                                     status: str) -> None:
        await self._inner.set_dead_letter_status(entry_id, status)

    async def get_quarantined_tables(self):
        return await self._inner.get_quarantined_tables()

    async def set_table_quarantine(self, table_id, record) -> None:
        await self._check_write(table_id)
        await self._inner.set_table_quarantine(table_id, record)

    async def get_autoscale_journal(self) -> "dict | None":
        return await self._inner.get_autoscale_journal()

    async def update_autoscale_journal(self, journal: dict) -> None:
        # pods never write scale decisions — only the (pod-external)
        # AutoscaleController does, against the RAW store
        raise EtlError(
            ErrorKind.SHARD_NOT_OWNED,
            "shard-scoped runtimes cannot rewrite the autoscale journal; "
            "drive scale decisions through AutoscaleController")

    # -- fleet spec / actuation journals (docs/fleet.md) ----------------------
    # Reads pass through (a pod may inspect the fleet's desired state,
    # e.g. to report its tenancy profile on /health/detail); WRITES are
    # control-plane-only — only the fleet coordinator, against the RAW
    # store, ever moves the spec or a journal.

    async def get_fleet_spec(self) -> "dict | None":
        return await self._inner.get_fleet_spec()

    async def update_fleet_spec(self, spec: dict) -> None:
        raise EtlError(
            ErrorKind.SHARD_NOT_OWNED,
            "shard-scoped runtimes cannot rewrite the fleet spec; "
            "submit desired state through the fleet API")

    async def get_fleet_journal(self, pipeline_id: int) -> "dict | None":
        return await self._inner.get_fleet_journal(pipeline_id)

    async def get_fleet_journals(self) -> "dict[int, dict]":
        return await self._inner.get_fleet_journals()

    async def update_fleet_journal(self, pipeline_id: int,
                                   journal: dict) -> None:
        raise EtlError(
            ErrorKind.SHARD_NOT_OWNED,
            "shard-scoped runtimes cannot rewrite a fleet actuation "
            "journal; drive convergence through FleetReconciler")

    # -- SchemaStore (shared, unguarded — see module docstring) ---------------

    async def store_table_schema(self, schema: ReplicatedTableSchema,
                                 snapshot_id: SnapshotId) -> None:
        await self._inner.store_table_schema(schema, snapshot_id)

    async def get_table_schema(
            self, table_id: TableId,
            at_snapshot: SnapshotId | None = None
    ) -> ReplicatedTableSchema | None:
        return await self._inner.get_table_schema(table_id, at_snapshot)

    async def get_schema_versions(self, table_id: TableId) -> list[SnapshotId]:
        return await self._inner.get_schema_versions(table_id)

    async def get_table_ids_with_schemas(self) -> list[TableId]:
        # the schema-cleanup sweep iterates this: scope it to owned
        # tables so K pods don't prune each other's versions concurrently
        all_ids = await self._inner.get_table_ids_with_schemas()
        return [tid for tid in all_ids if self.owns(tid)]

    async def prune_schema_versions(self, table_id: TableId,
                                    older_than: SnapshotId) -> int:
        return await self._inner.prune_schema_versions(table_id, older_than)

    async def delete_table_schemas(self, table_id: TableId) -> None:
        await self._inner.delete_table_schemas(table_id)
