"""Pipeline orchestrator.

Reference parity: `Pipeline` (crates/etl/src/pipeline.rs:74) —
`new/start/wait/shutdown` (pipeline.rs:96,142,249,320) and
`initialize_table_states` (pipeline.rs:354): tables in the publication get
Init states if absent; tables no longer published are purged (state,
schemas, destination metadata, slot).

Copy of the reference's `etl_tpu/runtime/pipeline.py`, with the
supervision tree (`supervision/`: heartbeats, the health state machine,
the destination's circuit breaker and op-timeout wrapper, the host-oracle
degrade) and poison-pill isolation (runtime/poison.py, through the apply
loop) on by default, as in the reference. A config that sets `shard` runs
one shard pod: `start()` adopts the store's shard assignment and swaps the
store for the pod's fenced view (sharding/runtime.py), and the pod keeps
its own `DecodePipeline`s and CUDA streams on the one card. With
`BatchEngine.CUDA` on a CUDA device, `start()` raises when there is no
card, then measures the routing cost model (ops/autotune.py) and loads
the kernel libraries through the program store (ops/program_store.py,
from the configured cache directory), all before the source connects;
after the destination's startup it prewarms the stored schemas'
layouts, before the apply loop sees traffic. It awaits any build it
needs: unlike the reference's nonblocking compile, no batch decodes on
the oracle while nvcc runs.
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
from ..destinations.base import Destination, egress_encoder
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
        self.config = config
        self.store = store
        # set at start() for sharded pods: the adopted ShardIdentity
        # (shard, shard_count, epoch) — the raw store stays reachable
        # through `self.store._inner` only via the scoped view
        self.shard_identity = None
        self.destination = destination
        self.source_factory = source_factory  # () -> ReplicationSource
        self.shutdown_signal = ShutdownSignal()
        self.table_cache = SharedTableCache()
        self.pool: TableSyncWorkerPool | None = None
        self.apply_worker: ApplyWorker | None = None
        self._apply_task: asyncio.Task | None = None
        self.memory_monitor: MemoryMonitor | None = None
        self.batch_budget: BatchBudgetController | None = None
        # what start()'s program prewarm warmed ({} when it did not run)
        self.prewarm_stats: dict = {}
        # supervision tree (docs/supervision.md): liveness watchdogs over
        # every long-running component + the pipeline health state
        # machine a health endpoint serves. Built here (not in start) so
        # the health surface can answer "starting" before start() runs.
        self.supervisor = None
        if config.supervision.enabled:
            from ..supervision import Supervisor

            self.supervisor = Supervisor(config.supervision)
        # what the workers actually write through: the configured
        # destination behind the supervision wrapper (per-op timeout
        # bound + circuit breaker + heartbeat); `destination` stays the
        # raw inner for tests
        self.active_destination: Destination = destination
        if self.supervisor is not None:
            from ..supervision import SupervisedDestination

            self.active_destination = SupervisedDestination(
                destination,
                timeout_s=config.destination_op_timeout_s,
                breaker=self.supervisor.breaker(
                    type(destination).__name__),
                heartbeat=self.supervisor.register("destination"))

    def _check_card(self, batch) -> None:
        """No fallback to the CPU: with `BatchEngine.CUDA` on a CUDA
        device and no card, the pipeline does not start."""
        if batch.device.split(":")[0] == "cuda" \
                and not torch.cuda.is_available():
            raise EtlError(ErrorKind.DEVICE_UNAVAILABLE,
                           "BatchEngine.CUDA on device "
                           f"{batch.device!r}: no CUDA device is "
                           "available")

    async def _load_decode(self, batch) -> None:
        """The CUDA engine's start-up before any resource opens, off the
        event loop (where the reference runs its autotune): the card
        check, the store's directory (first: the probe's host decode
        loads the packers), the routing cost model, then the kernel
        libraries — built here, if they must be, and not at the first
        flush. A failed build leaves nothing running."""
        from ..ops import autotune, program_store

        self._check_card(batch)
        program_store.configure_pipeline(batch)
        if batch.device.split(":")[0] != "cuda":
            return
        await autotune.prewarm()
        await asyncio.to_thread(decode_kernel.load)
        if egress_encoder(self.config,
                          self.active_destination) is not None:
            from ..ops import egress_kernel

            await asyncio.to_thread(egress_kernel.load)

    async def _prewarm(self, batch) -> None:
        """The program prewarm of the stored schemas' layouts, after the
        destination's startup as in the reference; on failure the
        watchdogs stop and the destination shuts down before it
        raises."""
        from ..ops import program_store

        try:
            self.prewarm_stats = await program_store.prewarm_pipeline(
                self.store, batch, egress=egress_encoder(
                    self.config, self.active_destination) is not None)
        except BaseException:
            if self.supervisor is not None:
                await self.supervisor.stop()
            await self.active_destination.shutdown()
            raise

    async def start(self) -> None:
        if self.config.shard is not None and self.shard_identity is None:
            # adopt the authoritative shard assignment and swap the store
            # for this pod's filtered, write-fenced view BEFORE anything
            # reads table states — init, the pool, and the apply worker
            # must all see only this shard's slice
            from ..sharding.runtime import resolve_shard_scope

            scoped = await resolve_shard_scope(self.store, self.config)
            self.store = scoped
            self.shard_identity = scoped.identity
            logger.info("shard scope: %s", scoped.identity.describe())
        batch = self.config.batch
        cuda_engine = batch.batch_engine is BatchEngine.CUDA
        if cuda_engine:
            await self._load_decode(batch)
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
        if self.supervisor is not None:
            self.supervisor.start()
        await self.active_destination.startup()
        if cuda_engine:
            await self._prewarm(batch)
        # memory defense (reference pipeline.rs:168 MemoryMonitor::new +
        # batch_budget.rs): the monitor pauses WAL/COPY intake under RSS
        # pressure; the budget controller sizes batches by the active
        # stream count so concurrent copies don't multiply peak memory
        monitor_hb = self.supervisor.register("memory_monitor") \
            if self.supervisor is not None else None
        self.memory_monitor = MemoryMonitor(  # etl-lint: ignore[blocking-call-in-async]
            self.config.backpressure, heartbeat=monitor_hb)
        self.memory_monitor.start()
        self.batch_budget = BatchBudgetController(
            self.config.backpressure, self.config.batch.max_size_bytes)
        self.pool = TableSyncWorkerPool(
            config=self.config, store=self.store,
            destination=self.active_destination,
            source_factory=self.source_factory,
            table_cache=self.table_cache, shutdown=self.shutdown_signal,
            monitor=self.memory_monitor, budget=self.batch_budget,
            supervisor=self.supervisor)
        await self.pool.refresh_states()
        self.apply_worker = ApplyWorker(
            config=self.config, store=self.store,
            destination=self.active_destination,
            source_factory=self.source_factory, pool=self.pool,
            table_cache=self.table_cache, shutdown=self.shutdown_signal,
            monitor=self.memory_monitor, budget=self.batch_budget,
            supervisor=self.supervisor)
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
        if self.shard_identity is not None:
            # this pod initialises (and may purge) only ITS slice of the
            # publication; sibling shards own the rest. The store view is
            # already filtered, so `known` below is owned tables only.
            smap = self.shard_identity.shard_map()
            published = {tid for tid in published
                         if smap.owns(tid, self.shard_identity.shard)}
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
        except BaseException as e:
            # the apply worker exhausted its retries (or died on a
            # permanent error): the health surface must say FAULTED, not
            # keep serving the last degraded/healthy state
            if self.supervisor is not None \
                    and not isinstance(e, asyncio.CancelledError):
                self.supervisor.health.fault(f"apply worker failed: {e}")
            raise
        finally:
            # a fatal apply error must release table-sync workers parked on
            # catchup futures only the apply worker could resolve — trigger
            # shutdown so wait_all() cannot hang and the error propagates
            self.shutdown_signal.trigger()
            if self.pool is not None:
                await self.pool.wait_all()
            if self.memory_monitor is not None:
                await self.memory_monitor.stop()
            if self.supervisor is not None:
                await self.supervisor.stop()
            await self.active_destination.shutdown()

    def health_snapshot(self) -> dict:
        """The live supervision surface a health endpoint serves; minimal
        shape when supervision is disabled. Sharded pods always report
        their identity (shard/shard_count/epoch) so an operator can tell
        WHICH slice a degraded pod owns."""
        if self.supervisor is None:
            snap = {"state": "unsupervised",
                    "started": self._apply_task is not None}
        else:
            snap = self.supervisor.snapshot()
        if self.config.shard is not None:
            snap["shard"] = self.shard_identity.describe() \
                if self.shard_identity is not None else {
                    "shard": self.config.shard,
                    "shard_count": self.config.shard_count,
                    "epoch": None}  # not adopted yet (before start())
        return snap

    async def shutdown(self) -> None:
        self.shutdown_signal.trigger()

    async def shutdown_and_wait(self) -> None:
        await self.shutdown()
        await self.wait()

