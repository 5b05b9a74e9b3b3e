"""Apply worker: owns the main replication slot and the retry loop.

Reference parity: crates/etl/src/runtime/apply/worker.rs —
start LSN = max(durable progress, slot confirmed_flush) (worker.rs:440-465);
invalidated-slot handling per InvalidatedSlotBehavior (Error vs
Recreate+reset-all-tables, worker.rs:476-527); policy-driven timed retry
loop (worker.rs:148-207,237-281).

Copy of the reference's `etl_tpu/runtime/apply_worker.py`.
"""

from __future__ import annotations

import asyncio
import logging

from ..config.pipeline import InvalidatedSlotBehavior, PipelineConfig
from ..models.errors import ErrorKind, EtlError, RetryKind
from ..retry import RetryPolicy
from ..models.lsn import Lsn
from ..postgres.slots import apply_slot_name
from ..postgres.source import ReplicationSource
from ..store.base import PipelineStore
from ..destinations.base import Destination
from .apply_loop import ApplyContext, ApplyLoop, ExitIntent
from .shutdown import ShutdownRequested, ShutdownSignal, or_shutdown
from .table_cache import SharedTableCache
from .table_sync import TableSyncWorkerPool

logger = logging.getLogger("etl_tpu_torch.apply_worker")


class ApplyWorker:
    def __init__(self, *, config: PipelineConfig, store: PipelineStore,
                 destination: Destination, source_factory,
                 pool: TableSyncWorkerPool, table_cache: SharedTableCache,
                 shutdown: ShutdownSignal, monitor=None, budget=None,
                 supervisor=None):
        self.config = config
        self.store = store
        self.destination = destination
        self.source_factory = source_factory
        self.pool = pool
        self.cache = table_cache
        self.shutdown = shutdown
        self.monitor = monitor
        self.budget = budget
        self.supervisor = supervisor  # supervision.Supervisor | None
        self._restart_requested: asyncio.Event | None = None
        self._hb = None  # registered in _guarded_run (loop must be live)
        # sharded pods stream through their own `_s{shard}` slot: the
        # durable-progress key AND the replication stream are per-shard
        self.slot_name = apply_slot_name(config.pipeline_id, config.shard)
        self._task: asyncio.Task | None = None

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.ensure_future(self._guarded_run())
        return self._task

    async def _guarded_run(self) -> None:
        """Timed-retry wrapper (reference worker.rs:237-281), backoff via
        the unified worker-scoped RetryPolicy (retry.py). Under
        supervision each attempt races the supervisor's restart request:
        a detected stall/hang cancels the attempt and funnels into the
        SAME retry loop as any transient error."""
        policy = RetryPolicy.from_config(self.config.apply_retry)
        if self.supervisor is not None:
            self._restart_requested = asyncio.Event()
            self._hb = self.supervisor.register(
                "apply", restartable=True,
                on_restart=self._restart_requested.set)
        attempt = 0
        try:
            await self._retry_loop(policy, attempt)
        finally:
            if self._hb is not None:
                self._hb.close()
                self._hb = None

    async def _retry_loop(self, policy: RetryPolicy, attempt: int) -> None:
        while not self.shutdown.is_triggered:
            try:
                await self._run_once_supervised()
                return  # clean pause
            except ShutdownRequested:
                return
            except asyncio.CancelledError:
                raise
            except EtlError as e:
                if policy.classify(e) is not RetryKind.TIMED \
                        or attempt + 1 >= policy.max_attempts:
                    logger.error("apply worker failed permanently: %s", e)
                    raise
                attempt += 1
                delay = policy.delay(attempt - 1)
                logger.warning("apply worker error (attempt %d, retry in "
                               "%.1fs): %s", attempt, delay, e)
                try:
                    await or_shutdown(self.shutdown, asyncio.sleep(delay))
                except ShutdownRequested:
                    return
            except Exception as e:  # containment → timed retry
                attempt += 1
                if attempt >= policy.max_attempts:
                    raise EtlError(ErrorKind.WORKER_PANICKED, repr(e))
                try:
                    await or_shutdown(
                        self.shutdown,
                        asyncio.sleep(policy.delay(attempt - 1)))
                except ShutdownRequested:
                    return

    async def _run_once_supervised(self) -> None:
        """Race one attempt against the supervisor's restart request; a
        won race cancels the wedged attempt (the stall sites are all
        cancellable awaits) and raises a TIMED-retryable stall error."""
        if self._restart_requested is None:
            return await self._run_once()
        if self._hb is not None:
            self._hb.reset_clocks()  # fresh deadlines per attempt
        # a restart request that landed while the previous attempt was
        # already failing on its own must not instantly abort THIS fresh
        # attempt with a fabricated stall
        self._restart_requested.clear()
        run = asyncio.ensure_future(self._run_once())
        trip = asyncio.ensure_future(self._restart_requested.wait())
        try:
            done, _ = await asyncio.wait({run, trip},
                                         return_when=asyncio.FIRST_COMPLETED)
            if run in done:
                return run.result()
            self._restart_requested.clear()
            raise EtlError(
                ErrorKind.STALL_DETECTED,
                "apply worker cancelled by the supervision watchdog "
                "(stalled or hung); restarting from durable progress")
        finally:
            # drain_cancelled, NOT try/await/except: a hard-kill cancel
            # landing in this finally must still kill us
            from .shutdown import drain_cancelled

            await drain_cancelled(run, trip)

    async def _run_once(self) -> None:
        source: ReplicationSource = self.source_factory()
        await source.connect()
        try:
            start_lsn = await self._get_start_lsn(source)
            await self.pool.refresh_states()
            stream = await source.start_replication(
                self.slot_name, self.config.publication_name, start_lsn)
            ctx = ApplyContext(progress_key=self.slot_name,
                               coordination=self.pool)
            loop = ApplyLoop(ctx=ctx, stream=stream, store=self.store,
                             destination=self.destination,
                             table_cache=self.cache, config=self.config,
                             shutdown=self.shutdown, start_lsn=start_lsn,
                             monitor=self.monitor, budget=self.budget,
                             heartbeat=self._hb, supervisor=self.supervisor)
            sampler = asyncio.ensure_future(self._lag_sampler(loop)) \
                if self.config.lag_sample_interval_s > 0 else None
            try:
                intent = await loop.run()
            finally:
                if sampler is not None:
                    sampler.cancel()
                    try:
                        await sampler
                    except asyncio.CancelledError:
                        pass
            assert intent is ExitIntent.PAUSE
        finally:
            await source.close()

    async def _lag_sampler(self, loop: ApplyLoop) -> None:
        """Out-of-band lag gauges on a lazy side connection (reference
        apply.rs:579-624 + observability.rs:46-50): polls the server's
        current WAL position so end-to-end and effective-flush lag keep
        updating even when the apply loop is busy or idle."""
        from ..telemetry.metrics import (
            ETL_APPLY_LOOP_EFFECTIVE_FLUSH_LAG_BYTES,
            ETL_APPLY_LOOP_END_TO_END_LAG_BYTES, registry)

        interval = self.config.lag_sample_interval_s
        source: ReplicationSource | None = None
        try:
            while True:
                await asyncio.sleep(interval)
                try:
                    if source is None:
                        source = self.source_factory()
                        await source.connect()
                    wal = await source.get_current_wal_lsn()
                except asyncio.CancelledError:
                    raise
                except Exception:  # etl-lint: ignore[cancellation-swallow]
                    # lag sampling must never take down the apply worker;
                    # drop the connection and retry on the next tick
                    if source is not None:
                        try:
                            await source.close()
                        except Exception:  # etl-lint: ignore[cancellation-swallow] — best-effort close of an already-broken connection
                            pass
                        source = None
                    continue
                registry.gauge_set(
                    ETL_APPLY_LOOP_END_TO_END_LAG_BYTES,
                    max(0, int(wal) - int(loop.state.durable_lsn)))
                registry.gauge_set(
                    ETL_APPLY_LOOP_EFFECTIVE_FLUSH_LAG_BYTES,
                    max(0, int(wal) - int(loop.state.last_status_flush_lsn)))
        finally:
            if source is not None:
                await source.close()

    async def _get_start_lsn(self, source: ReplicationSource) -> Lsn:
        """max(durable progress, slot confirmed_flush); create slot if
        missing; invalidation policy (worker.rs:366-527)."""
        slot = await source.get_slot(self.slot_name)
        if slot is not None and slot.invalidated:
            from ..telemetry.metrics import (ETL_SLOT_INVALIDATIONS_TOTAL,
                                             registry)

            registry.counter_inc(ETL_SLOT_INVALIDATIONS_TOTAL)
            behavior = self.config.invalidated_slot_behavior
            if behavior is InvalidatedSlotBehavior.ERROR:
                raise EtlError(
                    ErrorKind.SLOT_INVALIDATED,
                    f"slot {self.slot_name} invalidated; configure "
                    f"invalidated_slot_behavior=recreate_and_resync to "
                    f"rebuild")
            # recreate + full resync: reset every table and start fresh
            await source.delete_slot(self.slot_name)
            for tid in await source.get_publication_table_ids(
                    self.config.publication_name):
                await self.store.reset_table(tid)
            await self.store.delete_durable_progress(self.slot_name)
            slot = None
        if slot is None:
            created = await source.create_slot(self.slot_name)
            slot_flush = created.consistent_point
        else:
            slot_flush = slot.confirmed_flush_lsn
        durable = await self.store.get_durable_progress(self.slot_name)
        start = max(durable or Lsn.ZERO, slot_flush)
        sink = await self._recover_sink_high_water()
        if sink is not None and sink.commit_end_lsn:
            sink_lsn = Lsn(sink.commit_end_lsn)
            if sink_lsn > start:
                # sink is ahead of the progress store: the crash landed
                # between the committed write and the progress commit.
                # Bootstrap the store from the sink's own record so the
                # re-stream window starts past what the sink already
                # holds (exactly-once recovery, docs/destinations.md)
                logger.info(
                    "sink high-water %s ahead of durable progress %s; "
                    "bootstrapping store and resuming past it",
                    sink_lsn, start)
                await self.store.update_durable_progress(
                    self.slot_name, sink_lsn)
                start = sink_lsn
        return start

    async def _recover_sink_high_water(self):
        """Query a transactional sink's recovery high-water mark
        (`Destination.recover_high_water`), bounded and retried.

        Failure policy (exactly-once satellite): each attempt is bounded
        by `destination_op_timeout_s`, failures surface as typed
        `EtlError`s through the worker-scoped `RetryPolicy`, and
        exhausting it DEGRADES — loud warning + fallback counter, return
        None, resume from the progress store (blind at-least-once
        re-stream; the sink's own coordinate dedup still holds dup==0).
        `Pipeline.start` must never wedge on a sink that cannot answer
        its recovery query."""
        if not self.destination.supports_transactional_commit():
            return None
        from ..telemetry.metrics import (
            ETL_EXACTLY_ONCE_RECOVERIES_TOTAL,
            ETL_EXACTLY_ONCE_RECOVERY_FALLBACKS_TOTAL, registry)

        timeout_s = self.config.destination_op_timeout_s

        async def _one_attempt():
            try:
                if timeout_s > 0:
                    return await asyncio.wait_for(
                        self.destination.recover_high_water(), timeout_s)
                return await self.destination.recover_high_water()
            except asyncio.TimeoutError:
                raise EtlError(
                    ErrorKind.TIMEOUT,
                    f"sink recovery query exceeded {timeout_s:.1f}s")
            except EtlError:
                raise
            except asyncio.CancelledError:
                raise
            except Exception as e:  # untyped sink client failure
                raise EtlError(ErrorKind.DESTINATION_FAILED,
                               f"sink recovery query failed: {e!r}")

        policy = RetryPolicy.from_config(self.config.apply_retry)
        try:
            rng = await policy.execute(_one_attempt)
        except EtlError as e:
            reason = "timeout" if e.kind is ErrorKind.TIMEOUT else "error"
            registry.counter_inc(
                ETL_EXACTLY_ONCE_RECOVERY_FALLBACKS_TOTAL,
                labels={"reason": reason})
            logger.warning(
                "sink recovery high-water query failed after retries "
                "(%s); DEGRADING to blind re-stream from the progress "
                "store — at-least-once window reopens until the sink "
                "answers again (sink-side dedup still bounds "
                "duplicates): %s", reason, e)
            return None
        if rng is not None:
            registry.counter_inc(ETL_EXACTLY_ONCE_RECOVERIES_TOTAL)
        return rng
