"""The apply loop — heart of the replication runtime.

One loop type shared by the apply worker and table-sync workers via a
worker-context object (reference `ApplyLoop` + `WorkerContext`,
crates/etl/src/replication/apply.rs:215,1048). Responsibilities:

  - event-driven select with explicit priorities (apply.rs:1280-1336):
    shutdown > in-flight flush result > batch deadline > new WAL message
    > proactive keepalive;
  - decode pgoutput messages into typed events (via EventAssembler — CPU
    per-tuple or CUDA batched decode);
  - batch events by size-hint bytes + fill deadline; dispatch flushes in
    WAL order through a bounded write window (runtime/ack_window.py) —
    up to `BatchConfig.write_window` destination writes overlap their
    ack round-trips (the reference dispatches at most ONE in-flight
    `write_events`, apply.rs:1956-2023; the window generalizes it and
    window=1 reproduces it exactly);
  - advance durable progress only over the CONTIGUOUS ACKED PREFIX of
    the window, at commit boundaries (apply.rs:2665-2719), and send
    standby status updates with the effective flush LSN (the
    ack/flow-control channel, apply.rs:1575);
  - drive the table-sync handoff state machine at commit/flush/idle points
    (apply.rs:2874-3441) — the restart-window reasoning from
    apply.rs:2907-2929 applies: Catchup is set only in memory, so a crash
    between SyncWait and SyncDone re-runs the wait, which is safe;
  - handle DDL logical messages → versioned schema store (apply.rs:2160).

Exit intents (apply.rs:139): PAUSE (shutdown; resumable) or COMPLETE
(table-sync context reached its catchup target).

Copy of the reference's `etl_tpu/runtime/apply_loop.py`: the CUDA engine
takes the place of the reference's TPU engine.
"""

from __future__ import annotations

import asyncio
import enum
import time
from dataclasses import dataclass, field
from typing import Protocol

from ..config.pipeline import BatchEngine, PipelineConfig
from ..models.errors import ErrorKind, EtlError
from ..models.event import (BeginEvent, CommitEvent, RelationEvent,
                            SchemaChangeEvent, TruncateEvent)
from ..models.lsn import Lsn
from ..models.schema import TableId
from ..ops.engine import accelerator_backend
from ..ops.pipeline import WORKER_JOIN_S
from ..postgres.codec import event as event_codec
from ..postgres.codec import pgoutput
from ..postgres.source import FrameSpan, ReplicationStream
from ..store.base import PipelineStore
from ..analysis.annotations import flush_path
from ..destinations.base import Destination, egress_encoder
from ..telemetry.egress import record_egress
from ..telemetry.metrics import (ETL_APPLY_LOOP_BATCHES_TOTAL,
                                 ETL_APPLY_LOOP_EVENTS_TOTAL,
                                 ETL_APPLY_LOOP_FLUSH_LAG_BYTES,
                                 ETL_APPLY_LOOP_RECEIVED_LAG_BYTES,
                                 ETL_SHARD_DELIVERED_EVENTS,
                                 ETL_SLOT_LAG_BYTES,
                                 ETL_TRANSACTION_SIZE_BYTES,
                                 ETL_TRANSACTIONS_TOTAL, registry)
from . import failpoints
from .ack_window import AckWindow
from .assembler import RUN_SEAL_ROWS, EventAssembler
from .shutdown import ShutdownSignal
from .state import TableState, TableStateType
from .table_cache import SharedTableCache


class ExitIntent(enum.Enum):
    PAUSE = "pause"  # shutdown requested; resumable from durable progress
    COMPLETE = "complete"  # table-sync caught up to its target


class SyncCoordination(Protocol):
    """What the apply-context loop needs from the table-sync worker pool."""

    # pulsed on table-state transitions so the apply loop can process
    # handoffs immediately instead of polling on keepalives (optional —
    # the loop degrades to keepalive-paced processing without it)
    state_changed: asyncio.Event

    def table_state(self, table_id: TableId) -> TableState | None:
        """Merged store+memory view of one table's state (synchronous — the
        pool keeps its cache current across worker transitions)."""

    def syncing_table_states(self) -> dict[TableId, TableState]:
        """Merged store+memory view of tables NOT owned by the apply worker
        (everything except Ready)."""

    async def set_catchup(self, table_id: TableId, target: Lsn) -> None: ...

    async def wait_for_sync_done_or_errored(
        self, table_id: TableId) -> TableState: ...

    async def mark_ready(self, table_id: TableId) -> None: ...

    async def ensure_worker(self, table_id: TableId) -> None: ...


@dataclass
class ApplyContext:
    """Apply worker: owns the main slot and all Ready tables."""

    progress_key: str  # the apply slot name
    coordination: SyncCoordination


@dataclass
class TableSyncContext:
    """Table-sync worker: owns exactly one table; streams from its snapshot
    until the catchup target, then completes."""

    table_id: TableId
    progress_key: str  # the table-sync slot name
    catchup_target: "asyncio.Future[Lsn]"  # resolved when apply sets Catchup


@dataclass
class _LoopState:
    last_commit_end_lsn: Lsn | None = None  # end of last fully-seen commit
    current_commit_lsn: Lsn = Lsn.ZERO  # from BEGIN
    tx_ordinal: int = 0
    durable_lsn: Lsn = Lsn.ZERO
    received_lsn: Lsn = Lsn.ZERO
    server_end_lsn: Lsn = Lsn.ZERO  # latest end-of-WAL the server reported
    batch_commit_end: Lsn | None = None  # last commit boundary inside batch
    last_status_flush_lsn: Lsn = Lsn.ZERO  # flush LSN last reported upstream
    tx_bytes: int = 0  # payload bytes since the current BEGIN
    in_transaction: bool = False  # between BEGIN and COMMIT


class ApplyLoop:
    def __init__(self, *, ctx: "ApplyContext | TableSyncContext",
                 stream: ReplicationStream, store: PipelineStore,
                 destination: Destination, table_cache: SharedTableCache,
                 config: PipelineConfig, shutdown: ShutdownSignal,
                 start_lsn: Lsn, monitor=None, budget=None,
                 heartbeat=None, supervisor=None):
        self.ctx = ctx
        self.stream = stream
        self.store = store
        self.destination = destination
        self.cache = table_cache
        self.config = config
        self.shutdown = shutdown
        self.monitor = monitor  # MemoryMonitor | None
        # supervision wiring: this loop beats its owner's heartbeat on
        # every select wakeup, progress token = (durable, received) LSNs;
        # busy while a write is in flight or events are assembled — the
        # supervisor reads a frozen token under busy as a stall
        self._hb = heartbeat  # supervision.Heartbeat | None
        self._supervisor = supervisor  # for the decode pipeline's beat
        self._lease = budget.register_stream() if budget is not None else None
        # the assembler owns this loop's decode pipeline; the monitor
        # shrinks its in-flight window to 1 under memory pressure. The
        # lag reader feeds the fair-admission weight: received−durable is
        # this stream's replication lag in WAL bytes (the
        # SlotLagMetrics.confirmed_flush_lag shape, read in-process), so
        # when several streams share the device set the one furthest
        # behind wins proportionally more decode admissions
        self.assembler = EventAssembler(
            config.batch.batch_engine, monitor=monitor,
            decode_window=config.batch.decode_window,
            supervisor=supervisor,
            lag_bytes=lambda: max(
                0, int(self.state.received_lsn) - int(self.state.durable_lsn)),
            admission_capacity=config.batch.admission_capacity,
            seal_bytes=config.batch.max_size_bytes,
            device=config.batch.device,
            # the destination's wire encoder: unfiltered device batches
            # then carry device-rendered text (ops/egress.py)
            egress_encoder=egress_encoder(config, destination))
        self.state = _LoopState(durable_lsn=start_lsn, received_lsn=start_lsn,
                                last_status_flush_lsn=start_lsn)
        # bounded write window (runtime/ack_window.py): flushes keep
        # dispatching in WAL order while up to write_window earlier acks
        # settle; durable progress advances only over the contiguous
        # acked prefix. Shrinks to 1 under memory pressure (the decode
        # pipeline's stance), and window=1 reproduces the reference's
        # one-in-flight loop exactly.
        self._ack_window = AckWindow(
            config.batch.write_window,
            max_bytes=config.batch.write_window_max_bytes,
            pressure=(lambda: monitor.pressure)
            if monitor is not None else None)
        # poison-pill isolation boundary (runtime/poison.py): flush
        # submits route through it so a permanent destination error
        # bisects down to the poison row(s) and dead-letters them
        # instead of killing the worker. Apply context only — initial
        # sync keeps the reference's per-table error states
        # (table_retry), and a sync worker's batches cover one table
        # anyway.
        self._poison = None
        if config.poison.enabled and isinstance(ctx, ApplyContext):
            from .poison import PoisonIsolator

            self._poison = PoisonIsolator(store=store,
                                          destination=destination,
                                          config=config)
        self._batch_deadline: float | None = None
        # True while the CURRENT drain keeps coming back full: flush
        # pacing defers to mega-batching only during a live backlog
        # (the moment the producer pauses, normal deadlines resume)
        self._backlog_now = False
        self._ready_states: dict[TableId, bool] = {}
        # durably delivered event count, published per shard on the
        # status-update cadence (the autoscale collector's rate signal)
        self._delivered_events = 0
        interval = config.schema_cleanup_interval_s
        self._next_schema_cleanup = (time.monotonic() + interval) \
            if interval > 0 and isinstance(ctx, ApplyContext) else None

    # -- ownership filter -----------------------------------------------------

    async def _table_owned(self, table_id: TableId) -> bool:
        """Does THIS worker apply events for the table right now?

        Apply context: Ready tables, plus the SYNC_DONE window — a
        transaction whose commit LSN is ≥ the table's sync-done LSN was NOT
        delivered by the (already exited) sync worker, so the apply worker
        must deliver it even though the Ready transition hasn't happened
        yet (same rule as Postgres tablesync: apply when lsn > syncdone
        lsn). Proof of exactness: a sync-delivered transaction has commit
        END ≤ done_lsn, hence commit LSN < done_lsn — no overlap, no loss.
        """
        if isinstance(self.ctx, TableSyncContext):
            return table_id == self.ctx.table_id
        if self._ready_states.get(table_id):
            return True
        st = self.ctx.coordination.table_state(table_id)
        if st is None:
            return False
        if st.type is TableStateType.READY:
            self._ready_states[table_id] = True
            return True
        if st.type is TableStateType.SYNC_DONE:
            return self.state.current_commit_lsn >= (st.lsn or Lsn.ZERO)
        return False

    def _invalidate_ownership(self, table_id: TableId | None = None) -> None:
        if table_id is None:
            self._ready_states.clear()
        else:
            self._ready_states.pop(table_id, None)

    # -- main loop ------------------------------------------------------------

    async def run(self) -> ExitIntent:
        keepalive_s = self.config.keepalive_deadline_ms / 1000
        stream_iter = self.stream.__aiter__()
        msg_task: asyncio.Task | None = None
        resume_task: asyncio.Task | None = None
        coord_task: asyncio.Task | None = None
        coord_event: asyncio.Event | None = getattr(
            self.ctx.coordination, "state_changed", None) \
            if isinstance(self.ctx, ApplyContext) else None
        # table-sync context: selecting on the catchup future lets the
        # worker react the moment the apply loop sets its target instead
        # of at the next keepalive; disarmed after first resolution
        catchup_future = self.ctx.catchup_target \
            if isinstance(self.ctx, TableSyncContext) \
            and not self.ctx.catchup_target.done() else None
        shutdown_task = asyncio.ensure_future(self.shutdown.wait())
        # consecutive full drain windows: the backlog signal that grows
        # the assembler's seal toward device-size batches (CUDA engine)
        backlog_streak = 0
        try:
            while True:
                # memory backpressure: under RSS pressure stop pulling WAL
                # (the walsender buffers; standby feedback keeps flowing via
                # the keepalive timeout) until the monitor's hysteresis
                # resumes — reference BackpressureStream, stream.rs:45-122
                paused = self.monitor is not None and self.monitor.pressure
                if msg_task is None and not paused:
                    msg_task = asyncio.ensure_future(stream_iter.__anext__())
                waits = {shutdown_task}
                if msg_task is not None:
                    waits.add(msg_task)
                if paused:
                    if resume_task is None:
                        resume_task = asyncio.ensure_future(
                            self.monitor.wait_until_resumed())
                    waits.add(resume_task)
                if coord_event is not None and coord_task is None:
                    coord_task = asyncio.ensure_future(coord_event.wait())
                if coord_task is not None:
                    waits.add(coord_task)
                if catchup_future is not None:
                    waits.add(catchup_future)
                # every still-running window task: the head completion
                # advances the durable prefix, and a deeper failure must
                # fail fast. Done-but-unactionable tasks (successful
                # out-of-order completions held for contiguity) are
                # excluded — a done task in the wait set would make every
                # select return immediately until the head ack resolves
                waits.update(self._ack_window.pending_tasks())
                now = time.monotonic()
                if self._ack_window.any_actionable():
                    # a completion became actionable while the loop was
                    # busy elsewhere: handle it this iteration (its task
                    # is done, so nothing in `waits` would wake us)
                    timeout = 0.0
                # the batch deadline only matters when a flush could actually
                # dispatch — honoring it while the window is full (or the
                # breaker holds dispatch) would busy-spin with a zero
                # timeout until an ack settles
                elif self._batch_deadline is not None \
                        and not self._dispatch_blocked():
                    timeout = min(max(0.0, self._batch_deadline - now),
                                  keepalive_s)
                else:
                    timeout = keepalive_s
                done, _ = await asyncio.wait(
                    waits, timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED)
                if self._hb is not None:
                    # one beat per wakeup (≤ keepalive cadence when idle):
                    # cheap enough for the hot path, fresh enough for the
                    # hang deadline. Progress = the durability frontier.
                    self._hb.beat(
                        progress=(int(self.state.durable_lsn),
                                  int(self.state.received_lsn)),
                        busy=not self._ack_window.is_empty
                        or self.state.batch_commit_end is not None
                        or len(self.assembler) > 0)

                # priority 1: shutdown
                if shutdown_task in done:
                    await self._drain()
                    return ExitIntent.PAUSE
                if resume_task is not None and resume_task in done:
                    resume_task = None
                # priority 2: flush results — the contiguous acked prefix
                # advances durable progress; a mid-window failure raises
                # after the prefix is persisted (minimal re-stream). Keyed
                # on ACTIONABLE completions (head done, or any failure):
                # a successful out-of-order completion pops nothing yet,
                # and handling it here would spin the loop against an
                # empty pop until the head ack resolves
                if self._ack_window.any_actionable():
                    intent = await self._handle_flush_result()
                    if intent is not None:
                        return intent
                    continue  # re-select; a deadline flush may now proceed
                # priority 3: batch deadline. During a live backlog the
                # deadline defers while the open run is still growing
                # toward the (grown) seal: a deadline flush would seal —
                # and decode — the run below the device threshold, pinning
                # the saturated data plane to host-size batches. Lag is
                # queue depth under saturation anyway; the moment the
                # backlog clears, deadlines fire normally again.
                if self._batch_deadline is not None \
                        and time.monotonic() >= self._batch_deadline:
                    if (self._backlog_now
                            and self.assembler.seal_rows > RUN_SEAL_ROWS
                            and self.assembler.row_events
                            < self.assembler.seal_rows
                            and self.assembler.size_bytes
                            < self._scaled_max_bytes()):
                        self._batch_deadline = time.monotonic() \
                            + self.config.batch.max_fill_ms / 1000
                    else:
                        self._maybe_dispatch_flush(force=True)
                # priority 4: message — then bulk-drain frames that are
                # already buffered: a full select per message costs tens of
                # µs of asyncio machinery, which would cap CDC throughput
                # at ~30k events/s
                if msg_task is not None and msg_task in done:
                    exc = msg_task.exception()
                    if exc is not None:
                        raise exc
                    frame = msg_task.result()
                    msg_task = None
                    intent = await self._handle_frame(frame)
                    if intent is not None:
                        return intent
                    while not (self.shutdown.is_triggered
                               or self._ack_window.any_actionable() or (
                               self.monitor is not None
                               and self.monitor.pressure)):
                        frames = self.stream.drain_spans(4096)
                        if not frames:
                            backlog_streak = 0
                            self._backlog_now = False
                            break
                        # sustained backlog → mega-batching: when the
                        # drain keeps coming back full, the stream is
                        # producing faster than the loop consumes; grow
                        # the seal one row bucket per two full windows so
                        # staged runs reach the measured device threshold
                        # (paced/idle traffic never fills a window, so
                        # lag-sensitive loads keep the small seal)
                        drained = sum(
                            len(it.payloads) if type(it) is FrameSpan
                            else 1 for it in frames)
                        self._backlog_now = drained >= 4096
                        if self._backlog_now:
                            backlog_streak += 1
                            # mega-batching only pays where a card takes
                            # the grown batch (ops/engine
                            # .accelerator_backend)
                            if backlog_streak >= 2 and accelerator_backend(
                                    self.config.batch.device):
                                self.assembler.grow_seal()
                        else:
                            backlog_streak = 0
                        intent = await self._handle_frames(frames)
                        if intent is not None:
                            return intent
                elif not done:
                    # idle timeout: proactive keepalive + idle sync
                    # processing; an idle stream also ends any backlog
                    # episode — seals shrink back to the latency-tuned size
                    backlog_streak = 0
                    self._backlog_now = False
                    self.assembler.reset_seal()
                    await self._send_status_update()
                    if isinstance(self.ctx, ApplyContext):
                        await self._process_syncing_tables(
                            self.state.received_lsn)
                # priority 5: coordination wakes — immediate handoff
                # processing (no keepalive wait)
                if coord_task is not None and coord_task in done:
                    coord_task = None
                    coord_event.clear()
                    await self._process_syncing_tables(
                        self.state.received_lsn)
                if catchup_future is not None and catchup_future.done():
                    catchup_future = None  # disarm; target readable from ctx
                    intent = await self._check_catchup(self.state.received_lsn)
                    if intent is not None:
                        return intent
                if self._next_schema_cleanup is not None \
                        and time.monotonic() >= self._next_schema_cleanup:
                    self._next_schema_cleanup = time.monotonic() \
                        + self.config.schema_cleanup_interval_s
                    await self._run_schema_cleanup()
        finally:
            # an error/cancellation exit can leave in-flight writes
            # running (a supervision restart cancels THIS loop while a
            # write sits in a stalled destination call for seconds more)
            # — cancel the whole window with the select tasks; resume
            # re-streams from durable progress (which only ever covered
            # the contiguous acked prefix). drain_cancelled keeps a
            # hard-kill cancel landing mid-drain lethal.
            from .shutdown import drain_cancelled

            try:
                await drain_cancelled(msg_task, shutdown_task, resume_task,
                                      coord_task, *self._ack_window.tasks())
            finally:
                # a hard kill that lands while the drain is parked (a
                # loop that was already leaving on an error when the
                # kill came) raises out of it: the releases below are
                # synchronous and run either way, or the decode worker
                # and every arena its window held outlive the loop.
                # Cancelled window entries will never deliver: abandon
                # their pending decodes so staging arenas / window
                # slots / admission tickets return instead of leaking
                # with the discarded events (the leak probe in chaos
                # counts them)
                self._ack_window.abandon_payloads()
                if self._lease is not None:
                    self._lease.release()
                self.assembler.close()  # stop the decode worker
                # and close the stream on every exit, as a crash closes
                # the socket: a stream left open after a kill keeps its
                # slot active and its pending read parked
                await self.stream.close()
            # then wait for the worker, bounded and off the event loop
            await asyncio.to_thread(self.assembler.join, WORKER_JOIN_S)

    # -- frame handling ---------------------------------------------------------

    async def _handle_frames(self, items: list) -> ExitIntent | None:
        """Bulk path for a drained window of FrameSpans + control frames
        (stream.drain_spans). Spans — the overwhelming majority of CDC
        traffic — append into the assembler with per-SPAN bookkeeping
        (ownership check, LSN watermarks, flush check) instead of
        per-frame Python; control and keepalive frames take the per-frame
        slow path, which doubles as the barrier bounding every span (so
        ownership and current_commit_lsn are constants within one). This
        is what lifts end-to-end CDC from the tens of µs/event the
        per-frame machinery costs (reference loop: apply.rs:1280-1336
        runs it in compiled Rust; here the span batching amortizes it
        instead)."""
        st = self.state
        dev_engine = self.config.batch.batch_engine is BatchEngine.CUDA
        span_t = FrameSpan
        for item in items:
            if type(item) is not span_t:
                intent = await self._handle_frame(item)
                if intent is not None:
                    return intent
                continue
            lsns = item.start_lsns
            st.server_end_lsn = max(st.server_end_lsn, item.end_lsn)
            st.received_lsn = max(st.received_lsn, lsns[-1])
            relid = item.relid
            if not await self._table_owned(relid):
                continue
            schema = self.cache.get(relid)
            if schema is None:
                raise EtlError(ErrorKind.SCHEMA_NOT_FOUND,
                               f"no RELATION seen for table {relid}")
            payloads = item.payloads
            if dev_engine:
                nbytes = self.assembler.push_raw_rows(
                    payloads, schema, lsns, int(st.current_commit_lsn),
                    st.tx_ordinal)
                st.tx_ordinal += len(payloads)
                st.tx_bytes += nbytes
            else:
                # CPU engine: expand the span through the per-message
                # oracle path (host-parsed events, reference per-tuple
                # architecture)
                commit_lsn = st.current_commit_lsn
                for payload, lsn in zip(payloads, lsns):
                    msg = pgoutput.decode_logical_message(payload)
                    self.assembler.push_row_message(
                        msg, payload, schema, Lsn(lsn), commit_lsn,
                        st.tx_ordinal)
                    st.tx_ordinal += 1
                    st.tx_bytes += len(payload)
            if self._batch_deadline is None:
                self._batch_deadline = time.monotonic() \
                    + self.config.batch.max_fill_ms / 1000
            self._maybe_dispatch_flush()
        return None

    async def _handle_frame(self, frame) -> ExitIntent | None:
        # chaos stall mode: a wedged frame read — the loop stops beating
        # entirely and only the watchdog's hang detection recovers it.
        # Pre-guarded: this runs per frame, and the disarmed cost must
        # stay one dict check, not a coroutine allocation.
        if failpoints.stalls_armed():
            await failpoints.stall_point(failpoints.APPLY_FRAME_READ)
        if isinstance(frame, pgoutput.PrimaryKeepalive):
            self.state.server_end_lsn = max(self.state.server_end_lsn,
                                            frame.end_lsn)
            self.state.received_lsn = max(self.state.received_lsn,
                                          frame.end_lsn)
            if frame.reply_requested:
                await self._send_status_update()
            if isinstance(self.ctx, ApplyContext):
                await self._process_syncing_tables(frame.end_lsn)
            else:
                return await self._check_catchup(frame.end_lsn)
            return None
        assert isinstance(frame, pgoutput.XLogData)
        self.state.server_end_lsn = max(self.state.server_end_lsn,
                                        frame.end_lsn)
        self.state.received_lsn = max(self.state.received_lsn, frame.start_lsn)
        await self._handle_message(frame.start_lsn, frame.payload)
        self._maybe_dispatch_flush()
        # commit-boundary coordination
        if frame.payload[:1] == b"C":
            if isinstance(self.ctx, ApplyContext):
                await self._process_syncing_tables(
                    self.state.last_commit_end_lsn or frame.start_lsn)
            else:
                return await self._check_catchup(
                    self.state.last_commit_end_lsn or frame.start_lsn)
        return None

    async def _handle_message(self, start_lsn: Lsn, payload: bytes) -> None:
        st = self.state
        # CUDA-engine fast path for row messages: the batch engine needs
        # only (kind, relid, raw payload) — the native framer re-parses the
        # tuple data on the staging path, so a full host-side
        # decode_logical_message here would parse every tuple twice and cap
        # CDC throughput at the Python parse rate
        if payload[:1] in (b"I", b"U", b"D") \
                and self.config.batch.batch_engine is BatchEngine.CUDA:
            relid = int.from_bytes(payload[1:5], "big")
            if not await self._table_owned(relid):
                return
            schema = self.cache.get(relid)
            if schema is None:
                raise EtlError(ErrorKind.SCHEMA_NOT_FOUND,
                               f"no RELATION seen for table {relid}")
            self.assembler.push_raw_row(payload, schema, start_lsn,
                                        st.current_commit_lsn, st.tx_ordinal)
            st.tx_ordinal += 1
            st.tx_bytes += len(payload)
            if self.assembler.size_bytes and self._batch_deadline is None:
                self._batch_deadline = time.monotonic() \
                    + self.config.batch.max_fill_ms / 1000
            return
        msg = pgoutput.decode_logical_message(payload)
        dev_engine = self.config.batch.batch_engine is BatchEngine.CUDA
        if isinstance(msg, pgoutput.BeginMessage):
            st.current_commit_lsn = msg.final_lsn
            st.tx_ordinal = 0
            st.tx_bytes = 0
            st.in_transaction = True
            # CUDA engine: Begin/Commit are NOT run barriers — device
            # batches span transactions (each row carries its own
            # commit_lsn/tx_ordinal), so decode calls happen per FLUSH,
            # not per transaction. Sealing here would cap CDC throughput
            # at the per-transaction device-dispatch rate. Durability
            # still advances only at commit boundaries via
            # batch_commit_end (apply.rs:1932-1945 carries the commit LSN
            # separately from the batch for the same reason).
            if not dev_engine:
                self.assembler.push_control(
                    event_codec.decode_begin(msg, start_lsn))
        elif isinstance(msg, pgoutput.CommitMessage):
            ev = event_codec.decode_commit(msg, start_lsn)
            if not dev_engine:
                self.assembler.push_control(ev)
            elif self._batch_deadline is None:
                # no assembler event marks this boundary, so arm the
                # deadline: an empty commit window still needs the
                # force-flush to advance durable progress (see
                # _maybe_dispatch_flush)
                self._batch_deadline = time.monotonic() \
                    + self.config.batch.max_fill_ms / 1000
            st.in_transaction = False
            st.last_commit_end_lsn = ev.end_lsn
            st.batch_commit_end = ev.end_lsn
            # commit watermark for size-bounded flush splitting: a prefix
            # flush covering everything assembled so far may claim
            # durability at this commit end (runtime/assembler.py)
            self.assembler.note_commit_end(ev.end_lsn)
            registry.counter_inc(ETL_TRANSACTIONS_TOTAL)
            # owned-row payload bytes only (tx_bytes definition) — control
            # messages don't count toward transaction size
            registry.histogram_observe(ETL_TRANSACTION_SIZE_BYTES,
                                       st.tx_bytes)
            # commit fast path: while the write window has room, flushing
            # AT the commit boundary cuts p50 replication lag by the whole
            # fill window (an idle pipeline has nothing to batch FOR) and
            # — on destinations with real ack latency — keeps up to
            # write_window commits' writes overlapping their ack round
            # trips instead of serializing one per round trip. Once the
            # window fills, later commits coalesce into full batches, so
            # saturated throughput is unaffected (at window=1 this is
            # exactly the old idle-commit fast path).
            # Keyed on ROW events, not len(assembler): commits of
            # unowned-table transactions (whose CPU-engine Begin/Commit
            # controls still land in the assembler) stay on the deadline
            # path — an immediate flush per such commit would write
            # durable progress per commit instead of per fill window.
            # (suppressed during a live backlog: the fast flush exists to
            # cut IDLE lag, and here it would seal a growing mega run)
            if self.assembler.row_events and not self._backlog_now:
                self._maybe_dispatch_flush(force=True)  # no-op when blocked
        elif isinstance(msg, pgoutput.RelationMessage):
            schema = event_codec.schema_from_relation_message(msg)
            prev = self.cache.get(msg.relation_id)
            self.cache.set(schema)
            if await self._table_owned(msg.relation_id) \
                    and (prev is None or prev != schema):
                self.assembler.push_control(RelationEvent(
                    start_lsn, st.current_commit_lsn, schema))
        elif isinstance(msg, (pgoutput.InsertMessage, pgoutput.UpdateMessage,
                              pgoutput.DeleteMessage)):
            if not await self._table_owned(msg.relation_id):
                return
            schema = self.cache.get(msg.relation_id)
            if schema is None:
                raise EtlError(ErrorKind.SCHEMA_NOT_FOUND,
                               f"no RELATION seen for table {msg.relation_id}")
            self.assembler.push_row_message(
                msg, payload, schema, start_lsn, st.current_commit_lsn,
                st.tx_ordinal)
            st.tx_ordinal += 1
            st.tx_bytes += len(payload)
        elif isinstance(msg, pgoutput.TruncateMessage):
            schemas = []
            for rid in msg.relation_ids:
                if await self._table_owned(rid):
                    sch = self.cache.get(rid)
                    if sch is not None:
                        schemas.append(sch)
            if schemas:
                self.assembler.push_control(TruncateEvent(
                    start_lsn, st.current_commit_lsn, st.tx_ordinal,
                    msg.options, tuple(schemas)))
                st.tx_ordinal += 1
        elif isinstance(msg, pgoutput.LogicalMessage):
            if msg.prefix == event_codec.DDL_MESSAGE_PREFIX:
                ev = event_codec.decode_schema_change(
                    msg, start_lsn, st.current_commit_lsn)
                if ev.new_schema is not None:
                    await self.store.store_table_schema(
                        ev.new_schema, int(start_lsn))
                if await self._table_owned(ev.table_id):
                    self.assembler.push_control(ev)
        # Origin/Type messages are ignored
        if self.assembler.size_bytes and self._batch_deadline is None:
            self._batch_deadline = time.monotonic() \
                + self.config.batch.max_fill_ms / 1000

    # -- batching / flush -------------------------------------------------------

    def _scaled_max_bytes(self) -> int:
        """Size-flush threshold, scaled with seal growth: the static cap
        is tuned for latency-sized batches and would otherwise seal mega
        runs at ~max_size_bytes of payload — below the device threshold —
        no matter how far the seal grew. Memory stays bounded by the
        growth cap (MEGA/RUN = 16×) and the backpressure monitor."""
        return self.config.batch.max_size_bytes \
            * max(1, self.assembler.seal_rows // RUN_SEAL_ROWS)

    def _breaker_open(self) -> bool:
        """True when the destination's circuit breaker is OPEN (shedding).
        Reads through the SupervisedDestination wrapper when present;
        plain destinations have no breaker."""
        from ..supervision.breaker import breaker_is_open

        return breaker_is_open(self.destination)

    def _flush_threshold(self) -> int:
        """The size bound of the NEXT flush: the scaled cap, shrunk by
        the per-stream budget share (batch_budget.rs:72-96)."""
        threshold = self._scaled_max_bytes()
        if self._lease is not None:
            threshold = min(threshold, self._lease.ideal_batch_bytes())
        return threshold

    def _dispatch_blocked(self) -> bool:
        """A new flush must not dispatch right now: the write window is
        at capacity, or the breaker is open while earlier acks are still
        settling — in-flight writes may yet succeed, so the window drains
        before the breaker sheds a fresh call (which would fail the
        worker and cancel them). Once the window is empty the dispatch
        proceeds and the breaker's fast-fail becomes worker backoff, the
        existing shedding path. The byte-cap check sees the PROSPECTIVE
        flush size (≤ threshold — flush_bounded cuts there), not the
        whole assembler backlog: judging a 60 MiB backlog against the
        window's byte cap would collapse the window to one-in-flight
        exactly when the backlog is largest."""
        nbytes = min(self.assembler.size_bytes, self._flush_threshold())
        if not self._ack_window.can_dispatch(nbytes):
            return True
        return not self._ack_window.is_empty and self._breaker_open()

    @flush_path
    def _maybe_dispatch_flush(self, force: bool = False) -> None:
        """Dispatch as many flushes as the window accepts: one for a
        `force` trigger (deadline, commit fast path, catchup drain) plus
        size-triggered ones while the assembler still holds a full
        batch. With a size-bounded split in effect (write_window > 1) a
        drained backlog becomes a sequence of ≤ threshold-byte batches
        the window pipelines."""
        dispatched = False
        while not self._dispatch_blocked():
            if not self._dispatch_one(force and not dispatched):
                return
            dispatched = True

    def _dispatch_one(self, force: bool) -> bool:
        if len(self.assembler) == 0:
            # CUDA engine: commits are not assembler events, so a commit
            # window whose owned-row set is EMPTY (unowned tables,
            # mid-sync traffic) still must advance durable progress —
            # otherwise batch_commit_end never clears, _is_idle() stays
            # false, and the slot's confirmed_flush pins while source WAL
            # retention grows. Dispatch an event-less flush through the
            # normal write-window machinery (one per fill window,
            # amortized like any other deadline flush).
            if not (force and self.state.batch_commit_end is not None):
                return False
        # budget-aware threshold: under many active streams the per-stream
        # share shrinks below the static cap (batch_budget.rs:72-96) —
        # flushes happen mid-transaction with the commit LSN carried
        # separately (apply.rs:1932-1945), so splitting huge transactions
        # is safe for durability accounting
        threshold = self._flush_threshold()
        if not force and self.assembler.size_bytes < threshold:
            return False
        # size-bounded flush: flush a WAL-ordered prefix of ≤ threshold
        # bytes — a drained backlog then dispatches as a sequence of
        # bounded batches the write window pipelines, instead of one
        # backlog-sized write whose single ack serializes everything
        # behind it (and whose payload can exceed what a destination
        # accepts per request). max_size_bytes is now a real per-write
        # bound, not just a flush trigger; the delivered event stream is
        # byte-identical at every window depth (asserted by bench.py
        # --ack-latency). The commit watermark (`covered`) — not the raw
        # batch_commit_end — is what a PREFIX flush may claim durability
        # at; `remaining` is the highest boundary still awaiting a later
        # flush.
        before_bytes = self.assembler.size_bytes
        events, covered, remaining = \
            self.assembler.flush_bounded(max_bytes=threshold)
        batch_bytes = before_bytes - self.assembler.size_bytes
        commit_end = covered
        self.state.batch_commit_end = remaining
        if len(self.assembler) > 0:
            # a remainder stays assembled: keep it on the normal fill
            # cadence (the dispatch loop may also flush it immediately
            # when the size threshold still holds and the window has
            # room)
            self._batch_deadline = time.monotonic() \
                + self.config.batch.max_fill_ms / 1000
        else:
            self._batch_deadline = None

        # transactional commit seam (docs/destinations.md exactly-once):
        # when the destination opts in, the flush ships its WAL
        # coordinate range alongside the data so the sink records both
        # atomically — a blind re-stream's rows then dedup sink-side and
        # restart recovery can trim the re-stream window to the unacked
        # suffix. The range is derived from the SAME payload the write
        # carries (CoalescedBatch / row-event coordinates), with the
        # commit watermark `covered` as the resume anchor.
        commit_range = None
        if events and self.destination.supports_transactional_commit():
            from ..destinations.base import CommitRange

            commit_range = CommitRange.from_events(
                events, commit_end_lsn=commit_end)

        async def submit():
            if not events:
                return None  # commit-boundary-only flush: no destination
            # columnar write seam: DecodedBatchEvents reach the
            # destination as batches (columnar-native writers encode them
            # column-at-a-time; others fall back to the row path via the
            # base-class shim). The ack window owns the durability wait
            # (etl-lint rule 17): submissions stay in WAL order, only the
            # ack round trips overlap. The poison isolator sits between
            # the flush and the destination: a PERMANENT (poison-kind)
            # write failure bisects to the poison rows and dead-letters
            # them, quarantined tables' events park — transient failures
            # pass through to the worker-retry path unchanged.
            if self._poison is not None:
                return await self._poison.submit(events,
                                                 commit=commit_range)
            if commit_range is not None:
                return await self.destination.write_event_batches_committed(
                    events, commit_range)
            return await self.destination.write_event_batches(events)

        def on_durable() -> None:
            # billing/egress accounting rides durable acks (egress.rs:1-20)
            record_egress(pipeline_id=self.config.pipeline_id,
                          destination=getattr(
                              self.destination, "telemetry_name",
                              type(self.destination).__name__),
                          bytes_processed=batch_bytes, kind="streaming")

        registry.counter_inc(ETL_APPLY_LOOP_BATCHES_TOTAL)
        registry.counter_inc(ETL_APPLY_LOOP_EVENTS_TOTAL, len(events))
        self._ack_window.dispatch(
            submit, commit_end_lsn=commit_end, n_events=len(events),
            nbytes=batch_bytes, on_durable=on_durable if events else None,
            payload=events, commit_range=commit_range)
        return True

    @flush_path
    async def _apply_flush_result(self) -> bool:
        """Consume the contiguous acked prefix of the write window;
        advance durable progress over it. Returns True if progress
        advanced (a commit boundary was covered). A mid-window failure
        raises AFTER the durable prefix is persisted, so the restart
        re-streams only the unacked suffix (bounded-dup budget grows by
        at most the window size)."""
        done, failure = self._ack_window.pop_ready()
        advanced = False
        for entry in done:
            self._delivered_events += entry.n_events
            if entry.commit_end_lsn is None:
                continue
            self.state.durable_lsn = max(self.state.durable_lsn,
                                         entry.commit_end_lsn)
            advanced = True
        if advanced:
            failpoints.fail_point(failpoints.ON_PROGRESS_STORE)
            await self.store.update_durable_progress(
                self.ctx.progress_key, self.state.durable_lsn)
            if failure is None:
                # NO standby status when a failure was popped: the
                # failed entry is out of the window, so _is_idle() can
                # read True and the effective flush LSN would advance to
                # received_lsn — PAST the failed entry's undelivered WAL
                # — trimming the slot before the restart re-streams it
                # (found by the pipeline_pack_fault chaos scenario). The
                # durable-progress store write above is safe either way:
                # it only ever names acked commit ends.
                await self._send_status_update()
        if failure is not None:
            raise failure if isinstance(failure, EtlError) else EtlError(
                ErrorKind.DESTINATION_FAILED, str(failure))
        return advanced

    async def _handle_flush_result(self) -> ExitIntent | None:
        advanced = await self._apply_flush_result()
        if advanced:
            if isinstance(self.ctx, ApplyContext):
                await self._process_syncing_tables_after_flush()
            else:
                return await self._check_catchup(self.state.durable_lsn)
        return None

    @flush_path
    async def _drain(self) -> None:
        """Shutdown path: wait out every in-flight write, then stop
        without flushing the open batch (it re-streams on resume —
        at-least-once). A failed write ends the drain: everything past
        the durable prefix re-streams on resume."""
        while not self._ack_window.is_empty:
            await self._ack_window.wait_all()
            try:
                await self._handle_flush_result()
            except EtlError:
                return  # resume re-delivers from durable progress

    async def _run_schema_cleanup(self) -> None:
        """Prune schema versions no longer reachable by any decode: every
        event at or below the durable LSN is flushed, so only the newest
        version ≤ durable (plus anything newer) can still be consulted
        (reference hourly cleanup task, apply.rs:123,423-631,1607)."""
        from ..models.schema import SnapshotId

        failpoints.fail_point(failpoints.ON_SCHEMA_CLEANUP)
        if int(self.state.durable_lsn) == 0:
            return
        snapshot = SnapshotId(int(self.state.durable_lsn))
        for tid in await self.store.get_table_ids_with_schemas():
            await self.store.prune_schema_versions(tid, snapshot)

    def _is_idle(self) -> bool:
        """No open transaction, nothing assembled, an empty write window,
        no commit boundary awaiting durability (apply.rs:885-889). Only
        then may keepalive progress be reported as flushed."""
        return (not self.state.in_transaction
                and len(self.assembler) == 0
                and self._ack_window.is_empty
                and self.state.batch_commit_end is None)

    def _effective_flush_lsn(self) -> Lsn:
        """Flush LSN for standby feedback (apply.rs:891-912): when IDLE the
        last received LSN — so the slot advances past unpublished/keepalive
        WAL instead of pinning retention — otherwise the durable commit
        floor. Idle-only advances are deliberately NOT persisted as durable
        progress; monotonicity is enforced against the last report (a
        post-idle transaction would otherwise jump the LSN back)."""
        effective = self.state.received_lsn if self._is_idle() \
            else self.state.durable_lsn
        return max(effective, self.state.durable_lsn,
                   self.state.last_status_flush_lsn)

    async def _send_status_update(self) -> None:
        failpoints.fail_point(failpoints.ON_STATUS_UPDATE)
        registry.gauge_set(ETL_APPLY_LOOP_FLUSH_LAG_BYTES,
                           self.state.received_lsn - self.state.durable_lsn)
        registry.gauge_set(
            ETL_APPLY_LOOP_RECEIVED_LAG_BYTES,
            max(0, self.state.server_end_lsn - self.state.received_lsn))
        if isinstance(self.ctx, ApplyContext):
            # per-slot lag as a FIRST-CLASS series, on this loop's
            # existing cadence: the same received−durable number the
            # admission weight reads, labeled by shard so the autoscale
            # collector and an operator dashboard read the identical
            # gauge (table-sync loops deliberately excluded — their
            # transient catchup slots would clobber the shard series)
            shard_label = {"shard": str(self.config.shard or 0)}
            registry.gauge_set(
                ETL_SLOT_LAG_BYTES,
                max(0, int(self.state.received_lsn)
                    - int(self.state.durable_lsn)),
                labels=shard_label)
            registry.gauge_set(ETL_SHARD_DELIVERED_EVENTS,
                               self._delivered_events, labels=shard_label)
        flush = self._effective_flush_lsn()
        self.state.last_status_flush_lsn = flush
        await self.stream.send_status_update(
            written=self.state.received_lsn,
            flushed=flush,
            applied=flush)

    # -- table-sync coordination (apply context) --------------------------------

    async def _process_syncing_tables(self, current_lsn: Lsn) -> None:
        coord = self.ctx.coordination
        for tid, st in list(coord.syncing_table_states().items()):
            if st.type is TableStateType.SYNC_WAIT:
                target = max(st.lsn or Lsn.ZERO, current_lsn)
                await coord.set_catchup(tid, target)
                # the handoff wait parks this loop for as long as the
                # sync worker needs to reach its catchup target — keep
                # beating so the park never reads as a hang (the SYNC
                # WORKER's own watchdog covers a stall inside it)
                from ..supervision import beat_while_waiting

                result = await beat_while_waiting(
                    self._hb, coord.wait_for_sync_done_or_errored(tid))
                if result.type is TableStateType.SYNC_DONE:
                    # became SyncDone; Ready happens after a durable flush
                    # covering its LSN (or immediately if already covered)
                    await self._maybe_mark_ready(tid, result)
            elif st.type is TableStateType.SYNC_DONE:
                await self._maybe_mark_ready(tid, st)
            elif st.type in (TableStateType.INIT, TableStateType.DATA_SYNC,
                             TableStateType.FINISHED_COPY):
                await coord.ensure_worker(tid)

    async def _maybe_mark_ready(self, tid: TableId, st: TableState) -> None:
        done_lsn = st.lsn or Lsn.ZERO
        current = max(self.state.durable_lsn, self.state.received_lsn)
        if current >= done_lsn:
            await self.ctx.coordination.mark_ready(tid)
            self._invalidate_ownership(tid)

    async def _process_syncing_tables_after_flush(self) -> None:
        coord = self.ctx.coordination
        for tid, st in list(coord.syncing_table_states().items()):
            if st.type is TableStateType.SYNC_DONE:
                await self._maybe_mark_ready(tid, st)

    # -- catchup (table-sync context) --------------------------------------------

    async def _check_catchup(self, current_lsn: Lsn) -> ExitIntent | None:
        ctx = self.ctx
        assert isinstance(ctx, TableSyncContext)
        if not ctx.catchup_target.done():
            return None
        target = ctx.catchup_target.result()
        if current_lsn < target:
            return None
        # Reached the fence. Everything ≤ target MUST be durably flushed
        # before SyncDone is recorded — the apply worker takes over from
        # `target` believing this worker delivered durably up to it.
        while len(self.assembler) > 0 or not self._ack_window.is_empty:
            self._maybe_dispatch_flush(force=True)
            if not self._ack_window.is_empty:
                await self._ack_window.wait_all()
                await self._apply_flush_result()
        done_lsn = max(self.state.durable_lsn, target)
        await self.store.update_table_state(ctx.table_id,
                                            TableState.sync_done(done_lsn))
        return ExitIntent.COMPLETE
