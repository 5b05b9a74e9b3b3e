"""Pipeline orchestrator.

Reference parity: `Pipeline` (crates/etl/src/pipeline.rs:74) —
`new/start/wait/shutdown` (pipeline.rs:96,142,249,320) and
`initialize_table_states` (pipeline.rs:354): tables in the publication get
Init states if absent; tables no longer published are purged (state,
schemas, destination metadata, slot).

Copy of the reference's `etl_tpu/runtime/pipeline.py`. Supervision,
sharding and poison-pill isolation are not ported yet (ROADMAP.md, queue
1): a config that enables any of them is refused at construction. The
reference's autotune and program-store prewarm have no counterpart until
queue 1 item 6 (the program store and autotune); with `BatchEngine.CUDA`
on a CUDA device, `start()` builds the kernel library instead, and raises
when there is no card.
"""

from __future__ import annotations

import asyncio
import logging

import torch

from ..config.pipeline import BatchEngine, PipelineConfig
from ..models.errors import ErrorKind, EtlError
from ..postgres.slots import table_sync_slot_name
from ..postgres.source import ReplicationSource
from ..store.base import PipelineStore
from ..destinations.base import Destination
from ..ops import decode_kernel
from .apply_worker import ApplyWorker
from .backpressure import BatchBudgetController, MemoryMonitor
from .shutdown import ShutdownSignal
from .state import TableState
from .table_cache import SharedTableCache
from .table_sync import TableSyncWorkerPool

logger = logging.getLogger("etl_tpu_torch.pipeline")


class Pipeline:
    """One replication pipeline: publication → destination."""

    def __init__(self, *, config: PipelineConfig, store: PipelineStore,
                 destination: Destination, source_factory):
        config.validate()
        _refuse_unported(config)
        self.config = config
        self.store = store
        self.destination = destination
        self.source_factory = source_factory  # () -> ReplicationSource
        self.shutdown_signal = ShutdownSignal()
        self.table_cache = SharedTableCache()
        self.pool: TableSyncWorkerPool | None = None
        self.apply_worker: ApplyWorker | None = None
        self._apply_task: asyncio.Task | None = None
        self.memory_monitor: MemoryMonitor | None = None
        self.batch_budget: BatchBudgetController | None = None

    async def start(self) -> None:
        batch = self.config.batch
        if batch.batch_engine is BatchEngine.CUDA \
                and batch.device.split(":")[0] == "cuda":
            # no fallback to the CPU: without a card the pipeline does not
            # start. The kernel library builds here, off the event loop,
            # and not at the first flush
            if not torch.cuda.is_available():
                raise EtlError(ErrorKind.DEVICE_UNAVAILABLE,
                               "BatchEngine.CUDA on device "
                               f"{batch.device!r}: no CUDA device is "
                               "available")
            await asyncio.to_thread(decode_kernel.load)
        # the reference's autotune and program-store prewarm come here;
        # they have no counterpart until ROADMAP.md queue 1 item 6
        source = self.source_factory()
        await source.connect()
        try:
            if self.config.run_source_migrations:
                # installs the supabase_etl_ddl event trigger so schema
                # changes flow through the WAL (pipeline.rs:153-164);
                # no-op on standbys and when already applied
                from ..postgres.migrations import run_source_migrations

                await run_source_migrations(source)
            await self._initialize_table_states(source)
            await self._install_row_filters(source)
        finally:
            await source.close()
        await self.destination.startup()
        # memory defense (reference pipeline.rs:168 MemoryMonitor::new +
        # batch_budget.rs): the monitor pauses WAL/COPY intake under RSS
        # pressure; the budget controller sizes batches by the active
        # stream count so concurrent copies don't multiply peak memory
        self.memory_monitor = MemoryMonitor(  # etl-lint: ignore[blocking-call-in-async]
            self.config.backpressure)
        self.memory_monitor.start()
        self.batch_budget = BatchBudgetController(
            self.config.backpressure, self.config.batch.max_size_bytes)
        self.pool = TableSyncWorkerPool(
            config=self.config, store=self.store,
            destination=self.destination,
            source_factory=self.source_factory,
            table_cache=self.table_cache, shutdown=self.shutdown_signal,
            monitor=self.memory_monitor, budget=self.batch_budget)
        await self.pool.refresh_states()
        self.apply_worker = ApplyWorker(
            config=self.config, store=self.store,
            destination=self.destination,
            source_factory=self.source_factory, pool=self.pool,
            table_cache=self.table_cache, shutdown=self.shutdown_signal,
            monitor=self.memory_monitor, budget=self.batch_budget)
        self._apply_task = self.apply_worker.spawn()

    async def _install_row_filters(self, source: ReplicationSource) -> None:
        """Discover the publication's row filters and install them on the
        shared table cache: RELATION messages carry no filter, so every
        decode view the apply loop builds re-attaches its table's
        predicate and the decoder fuses it into the device program
        (ops/predicate.py). Parsed ONCE here — never on the apply loop or
        per batch (etl-lint rule 13). Unsupported expressions degrade to
        server-side-only filtering with a log line; a failing catalog
        read is non-fatal for the same reason (pre-15 sources have no
        rowfilter column at all)."""
        from ..ops.predicate import RowFilterError, parse_row_filter

        try:
            filters = await source.get_row_filters(
                self.config.publication_name)
        except (EtlError, ConnectionError, OSError):
            # catalog quirk (e.g. a pre-15 server behind a version probe
            # that lied): filtering falls back to the server side —
            # never fatal, but logged so the offload deployment notices
            logger.info("publication row-filter discovery failed; "
                        "client-side filtering disabled", exc_info=True)
            return
        parsed: dict = {}
        for tid, sql in filters.items():
            try:
                parsed[tid] = parse_row_filter(sql)
            except RowFilterError:
                logger.info(
                    "row filter %r on table %s is outside the client-side "
                    "envelope; relying on server-side filtering", sql, tid)
        if parsed:
            self.table_cache.set_row_predicates(parsed)
            logger.info("client-side row filters active for tables %s",
                        sorted(parsed))

    async def _initialize_table_states(self,
                                       source: ReplicationSource) -> None:
        pub = self.config.publication_name
        if not await source.publication_exists(pub):
            raise EtlError(ErrorKind.PUBLICATION_NOT_FOUND, pub)
        published = set(await source.get_publication_table_ids(pub))
        known = await self.store.get_table_states()
        for tid in published:
            if tid not in known:
                await self.store.update_table_state(tid, TableState.init())
        for tid in set(known) - published:
            logger.info("purging table %s (no longer in publication)", tid)
            await self.store.purge_table(tid)
            await source.delete_slot(
                table_sync_slot_name(self.config.pipeline_id, tid,
                                     self.config.shard))

    async def wait(self) -> None:
        """Wait until the apply worker stops (shutdown or fatal error)."""
        assert self._apply_task is not None, "pipeline not started"
        try:
            await self._apply_task
        finally:
            # a fatal apply error must release table-sync workers parked on
            # catchup futures only the apply worker could resolve — trigger
            # shutdown so wait_all() cannot hang and the error propagates
            self.shutdown_signal.trigger()
            if self.pool is not None:
                await self.pool.wait_all()
            if self.memory_monitor is not None:
                await self.memory_monitor.stop()
            await self.destination.shutdown()

    def health_snapshot(self) -> dict:
        """The minimal health shape of an unsupervised pipeline."""
        return {"state": "unsupervised",
                "started": self._apply_task is not None}

    async def shutdown(self) -> None:
        self.shutdown_signal.trigger()

    async def shutdown_and_wait(self) -> None:
        await self.shutdown()
        await self.wait()


def _refuse_unported(config: PipelineConfig) -> None:
    """Supervision, poison-pill isolation and sharding are not ported
    yet: a config that enables one is refused, never run without it."""
    for on, what in ((config.supervision.enabled,
                      "supervision.enabled (the supervision tree)"),
                     (config.poison.enabled,
                      "poison.enabled (poison-pill isolation and the "
                      "dead-letter store)"),
                     (config.shard is not None,
                      "shard (sharded scale-out)")):
        if on:
            raise EtlError(
                ErrorKind.CONFIG_INVALID,
                f"{what} is not ported to etl_tpu_torch yet (ROADMAP.md, "
                f"queue 1: still to port); pass it off explicitly")
