"""Table-sync workers: initial copy + catchup + handoff.

Reference parity:
  - `start_table_sync` flow (crates/etl/src/replication/table_sync/mod.rs:97):
    drop pre-existing destination table (crash-consistency rationale at
    mod.rs:184-220), delete+create slot with snapshot, fetch schema inside
    the snapshot, copy, durability barrier, FinishedCopy → SyncWait →
    wait for Catchup → stream via ApplyLoop until SyncDone.
  - `TableSyncWorker` + pool (crates/etl/src/runtime/table_sync/):
    semaphore-bounded concurrency (permit count = max_table_sync_workers,
    pipeline.rs:201-202), panic containment → Errored, retry loop with
    store-backed state rollback (worker.rs:393-532), Notify-based state
    waits with no missed wakeups (worker.rs:211-264).

The pool implements `SyncCoordination` for the apply loop: the merged
store+memory state view (SyncWait/Catchup live only in memory,
lifecycle.rs:218-229), catchup fencing, and ready transitions.

Copy of the reference's `etl_tpu/runtime/table_sync.py` without the
supervision watchdog (not ported yet).
"""

from __future__ import annotations

import asyncio
import traceback
from dataclasses import dataclass, field

from ..config.pipeline import PipelineConfig
from ..models.errors import (ErrorKind, EtlError, RetryKind, retry_directive)
from ..models.lsn import Lsn
from ..models.schema import ReplicatedTableSchema, TableId
from ..postgres.slots import table_sync_slot_name
from ..postgres.source import ReplicationSource
from ..retry import RetryPolicy
from ..store.base import PipelineStore
from ..destinations.base import Destination
from ..telemetry.metrics import (ETL_WORKER_ERRORS_TOTAL,
                                 LABEL_WORKER_TYPE, registry)
from . import failpoints
from .apply_loop import ApplyLoop, ExitIntent, TableSyncContext
from .shutdown import ShutdownRequested, ShutdownSignal, or_shutdown
from .state import TableState, TableStateType
from .table_cache import SharedTableCache


@dataclass
class _WorkerHandle:
    table_id: TableId
    task: asyncio.Task
    catchup_target: "asyncio.Future[Lsn]"
    memory_state: TableState | None = None  # SyncWait/Catchup overlay
    done_event: asyncio.Event = field(default_factory=asyncio.Event)


class TableSyncWorkerPool:
    """Owns all table-sync workers of a pipeline; implements
    SyncCoordination for the apply loop."""

    def __init__(self, *, config: PipelineConfig, store: PipelineStore,
                 destination: Destination, source_factory,
                 table_cache: SharedTableCache, shutdown: ShutdownSignal,
                 monitor=None, budget=None):
        self.config = config
        self.store = store
        self.destination = destination
        self.source_factory = source_factory  # () -> ReplicationSource
        self.cache = table_cache
        self.shutdown = shutdown
        self.monitor = monitor  # MemoryMonitor | None
        self.budget = budget  # BatchBudgetController | None
        self._permits = asyncio.Semaphore(config.max_table_sync_workers)
        # unified worker-scoped backoff (etl_tpu/retry.py), built once:
        # same schedule as the apply worker, jitter decorrelates herds
        # of failed tables retrying in lockstep
        self.retry_policy = RetryPolicy.from_config(config.table_retry)
        # pulsed on every cached state transition: the apply loop selects
        # on it so SyncWait/SyncDone handoffs process immediately instead
        # of waiting out the next keepalive (Postgres parity: tablesync
        # workers wake the apply worker; polling cost ~3 keepalive
        # intervals of pure latency per table handoff)
        self.state_changed = asyncio.Event()
        self._workers: dict[TableId, _WorkerHandle] = {}
        self._states_cache: dict[TableId, TableState] = {}
        # transition-maintained index of non-Ready, non-Errored tables:
        # the apply loop consults this every keepalive/commit, so it must
        # be O(#syncing), not O(#tables) (the reference processes
        # transitions with cached state, apply.rs:2874-3441)
        self._syncing: set[TableId] = set()
        self._retry_attempts: dict[TableId, int] = {}
        self._retry_tasks: dict[TableId, asyncio.Task] = {}

    # -- state view ------------------------------------------------------------

    def _merged_state(self, tid: TableId) -> TableState | None:
        h = self._workers.get(tid)
        if h is not None and h.memory_state is not None:
            return h.memory_state
        return self._states_cache.get(tid)

    async def refresh_states(self) -> None:
        self._states_cache = await self.store.get_table_states()
        self._syncing = {
            tid for tid, st in self._states_cache.items()
            if st.type is not TableStateType.READY and not st.is_errored}
        self._update_table_gauges()

    def _cache_state(self, tid: TableId, st: TableState | None) -> None:
        if st is None:
            self._states_cache.pop(tid, None)
            self._syncing.discard(tid)
        else:
            self._states_cache[tid] = st
            if st.type is TableStateType.READY or st.is_errored:
                self._syncing.discard(tid)
            else:
                self._syncing.add(tid)
        self._update_table_gauges()
        self.state_changed.set()

    def _update_table_gauges(self) -> None:
        from ..telemetry.metrics import (ETL_TABLES_ERRORED,
                                         ETL_TABLES_READY, ETL_TABLES_TOTAL,
                                         registry)

        states = self._states_cache
        registry.gauge_set(ETL_TABLES_TOTAL, len(states))
        registry.gauge_set(ETL_TABLES_READY, sum(
            1 for s in states.values() if s.type is TableStateType.READY))
        registry.gauge_set(ETL_TABLES_ERRORED, sum(
            1 for s in states.values() if s.is_errored))

    def table_state(self, tid: TableId) -> TableState | None:
        return self._merged_state(tid)

    def syncing_table_states(self) -> dict[TableId, TableState]:
        out = {}
        for tid in list(self._syncing):
            merged = self._merged_state(tid) or self._states_cache.get(tid)
            if merged is None or merged.type is TableStateType.READY \
                    or merged.is_errored:
                self._syncing.discard(tid)  # self-heal on missed transition
                continue
            out[tid] = merged
        return out

    async def _record_state(self, tid: TableId, st: TableState) -> None:
        if st.is_persistent:
            await self.store.update_table_state(tid, st)
        self._cache_state(tid, st)

    # -- SyncCoordination --------------------------------------------------------

    async def set_catchup(self, table_id: TableId, target: Lsn) -> None:
        h = self._workers.get(table_id)
        if h is None:
            return
        if not h.catchup_target.done():
            h.memory_state = TableState.catchup(target)
            self._cache_state(table_id, h.memory_state)
            h.catchup_target.set_result(target)

    async def wait_for_sync_done_or_errored(self,
                                            table_id: TableId) -> TableState:
        h = self._workers.get(table_id)
        if h is not None:
            await or_shutdown(self.shutdown, h.done_event.wait())
        st = await self.store.get_table_state(table_id)
        self._cache_state(table_id, st or TableState.init())
        return self._states_cache[table_id]

    async def mark_ready(self, table_id: TableId) -> None:
        await self._record_state(table_id, TableState.ready())
        # the table's sync slot + progress row are no longer needed
        h = self._workers.pop(table_id, None)

    async def ensure_worker(self, table_id: TableId) -> None:
        h = self._workers.get(table_id)
        if h is not None and not h.task.done():
            return
        handle = _WorkerHandle(
            table_id=table_id, task=None,  # type: ignore[arg-type]
            catchup_target=asyncio.get_event_loop().create_future())
        worker = TableSyncWorker(pool=self, handle=handle)
        handle.task = asyncio.ensure_future(worker.run())
        self._workers[table_id] = handle

    # -- lifecycle ----------------------------------------------------------------

    async def wait_all(self) -> None:
        # pending timed retries are moot once the pipeline stops
        for t in self._retry_tasks.values():
            if not t.done():
                t.cancel()
        tasks = [h.task for h in self._workers.values()
                 if h.task is not None and not h.task.done()]
        tasks += [t for t in self._retry_tasks.values() if not t.done()]
        self._retry_tasks.clear()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    def active_worker_count(self) -> int:
        return sum(1 for h in self._workers.values()
                   if h.task is not None and not h.task.done())


class TableSyncWorker:
    def __init__(self, *, pool: TableSyncWorkerPool, handle: _WorkerHandle):
        self.pool = pool
        self.h = handle
        self.tid = handle.table_id
        self.config = pool.config
        self.store = pool.store

    # -- top level: permit + panic containment + retry -----------------------------

    async def run(self) -> None:
        pool = self.pool
        try:
            async with pool._permits:
                await self._run_guarded()
        except ShutdownRequested:
            pass
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # panic containment → Errored  # etl-lint: ignore[cancellation-swallow] — CancelledError re-raised above; containment mirrors reference worker.rs
            await self._mark_errored(e)
        finally:
            self.h.done_event.set()

    async def _run_guarded(self) -> None:
        try:
            await self._run_sync()
        except ShutdownRequested:
            raise
        except EtlError as e:
            await self._mark_errored(e)

    async def _mark_errored(self, e: BaseException) -> None:
        if isinstance(e, EtlError):
            kind = retry_directive(e).kind
            reason = str(e)
        else:
            kind = RetryKind.TIMED
            reason = f"worker panicked: {e!r}\n{traceback.format_exc()}"
        attempts = self.pool._retry_attempts.get(self.tid, 0)
        if kind is RetryKind.TIMED \
                and attempts + 1 >= self.config.table_retry.max_attempts:
            kind = RetryKind.MANUAL  # escalation (worker.rs:393-532)
        self.pool._retry_attempts[self.tid] = attempts + 1
        registry.counter_inc(ETL_WORKER_ERRORS_TOTAL,
                             labels={LABEL_WORKER_TYPE: "table_sync"})
        st = TableState.errored(reason, retry_policy=kind,
                                retry_attempts=attempts + 1)
        await self.pool._record_state(self.tid, st)
        self.h.memory_state = None
        if kind is RetryKind.TIMED and not self.pool.shutdown.is_triggered:
            # keep a strong reference: the loop holds tasks weakly, and
            # wait_all() must be able to cancel pending retries at shutdown
            self.pool._retry_tasks[self.tid] = asyncio.ensure_future(
                self._timed_retry(attempts + 1))

    async def _timed_retry(self, attempt: int) -> None:
        try:
            delay = self.pool.retry_policy.delay(attempt - 1)
            try:
                await or_shutdown(self.pool.shutdown, asyncio.sleep(delay))
            except ShutdownRequested:
                return
            # rollback to a copy-safe state and respawn
            await self.pool._record_state(self.tid, TableState.init())
            self.pool._workers.pop(self.tid, None)
            await self.pool.ensure_worker(self.tid)
        finally:
            self.pool._retry_tasks.pop(self.tid, None)

    # -- the sync flow ---------------------------------------------------------------

    async def _run_sync(self) -> None:
        pool = self.pool
        store = self.store
        shutdown = pool.shutdown
        slot_name = table_sync_slot_name(self.config.pipeline_id, self.tid,
                                         self.config.shard)
        source: ReplicationSource = pool.source_factory()
        await source.connect()
        try:
            state = await store.get_table_state(self.tid) or TableState.init()
            if state.type is TableStateType.READY:
                return
            if state.type is TableStateType.SYNC_DONE:
                return  # apply worker completes the Ready transition

            if state.type in (TableStateType.INIT, TableStateType.DATA_SYNC,
                              TableStateType.ERRORED):
                consistent_point, schema = await self._copy_phase(
                    source, slot_name)
            else:  # FINISHED_COPY: crashed between copy and catchup →
                # the copy is durable; resume streaming from the slot
                slot = await source.get_slot(slot_name)
                if slot is None or slot.invalidated:
                    # slot lost: the copy cannot be fenced — full recopy
                    consistent_point, schema = await self._copy_phase(
                        source, slot_name)
                else:
                    consistent_point = slot.confirmed_flush_lsn
                    schema = await source.get_table_schema(
                        self.tid, self.config.publication_name)
                    self.pool.cache.set(schema)

            # FinishedCopy → SyncWait (memory-only) → wait for Catchup
            self.h.memory_state = TableState.sync_wait(consistent_point)
            pool._cache_state(self.tid, self.h.memory_state)
            target = await or_shutdown(
                shutdown, asyncio.shield(self.h.catchup_target))
            self.h.memory_state = TableState.catchup(target)
            pool._cache_state(self.tid, self.h.memory_state)

            if target <= consistent_point:
                # nothing to catch up: the snapshot already covers the target
                await store.update_table_state(
                    self.tid, TableState.sync_done(consistent_point))
            else:
                failpoints.fail_point(failpoints.BEFORE_STREAMING)
                stream = await source.start_replication(
                    slot_name, self.config.publication_name, consistent_point)
                ctx = TableSyncContext(
                    table_id=self.tid, progress_key=slot_name,
                    catchup_target=self.h.catchup_target)
                loop = ApplyLoop(
                    ctx=ctx, stream=stream, store=store,
                    destination=pool.destination, table_cache=pool.cache,
                    config=self.config, shutdown=shutdown,
                    start_lsn=consistent_point,
                    monitor=pool.monitor, budget=pool.budget)
                intent = await loop.run()
                if intent is ExitIntent.PAUSE:
                    raise ShutdownRequested()
            # SyncDone recorded; cleanup this worker's resources
            await store.delete_durable_progress(slot_name)
            await source.delete_slot(slot_name)
            self.h.memory_state = None
            pool._cache_state(self.tid,
                              await store.get_table_state(self.tid))
            pool._retry_attempts.pop(self.tid, None)
        finally:
            await source.close()

    async def _copy_phase(self, source: ReplicationSource, slot_name: str
                          ) -> tuple[Lsn, ReplicatedTableSchema]:
        """Drop-recreate copy with snapshot fencing
        (reference table_sync/mod.rs:184-378)."""
        pool = self.pool
        store = self.store
        # 1. destination drop if a previous copy may have written rows.
        # Pass the prior stored schema: after a process restart the
        # destination's in-memory name mapping is empty and the drop would
        # silently no-op without it (schemas are only pruned below, in
        # prepare_table_for_copy, so the prior version is still readable)
        prior = await store.get_destination_metadata(self.tid)
        if prior is not None:
            prior_schema = await store.get_table_schema(self.tid)
            await pool.destination.drop_table(self.tid, prior_schema)
            await store.delete_destination_metadata(self.tid)
        # 2. fresh slot + snapshot
        await source.delete_slot(slot_name)
        await store.prepare_table_for_copy(self.tid)
        failpoints.fail_point(failpoints.BEFORE_SLOT_CREATION)
        created = await source.create_slot(slot_name)
        # 3. schema within the snapshot
        schema = await source.get_table_schema(
            self.tid, self.config.publication_name, created.snapshot_id)
        await store.store_table_schema(schema, 0)
        pool.cache.set(schema)
        # 4. record metadata BEFORE copying: a crash mid-copy (some batches
        # already durable at the destination) must leave a marker so the
        # next attempt drops the half-written table (mod.rs:184-220)
        from ..store.base import DestinationTableMetadata

        await store.update_destination_metadata(DestinationTableMetadata(
            table_id=self.tid,
            destination_table_name=str(schema.name)))
        # 5. copy, then record FinishedCopy
        await self._copy_table(source, schema, created.snapshot_id)
        try:
            from ..telemetry.metrics import (
                ETL_TABLE_COPY_END_TO_END_LAG_BYTES, registry)

            wal_now = await source.get_current_wal_lsn()
            registry.gauge_set(
                ETL_TABLE_COPY_END_TO_END_LAG_BYTES,
                max(0, int(wal_now) - int(created.consistent_point)))
        except EtlError:
            pass  # lag reporting must never fail a copy
        await store.update_table_state(self.tid, TableState.finished_copy())
        failpoints.fail_point(failpoints.AFTER_FINISHED_COPY)
        return created.consistent_point, schema

    async def _copy_table(self, source: ReplicationSource,
                          schema: ReplicatedTableSchema,
                          snapshot_id: str) -> None:
        """Single-connection copy; the CTID-partitioned parallel variant
        lives in runtime/copy.py and is used when the planner estimates
        enough rows."""
        from .copy import parallel_table_copy

        await parallel_table_copy(
            source_factory=self.pool.source_factory, primary_source=source,
            schema=schema, snapshot_id=snapshot_id, config=self.config,
            destination=self.pool.destination, shutdown=self.pool.shutdown,
            monitor=self.pool.monitor, budget=self.pool.budget)
