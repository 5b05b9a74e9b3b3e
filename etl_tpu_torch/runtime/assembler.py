"""Event assembly: pgoutput row messages → destination events, on either
decode engine.

The apply loop pushes raw row messages here; `flush()` returns the ordered
event list for the destination write.

- CPU engine: each message decodes immediately via the codec oracle
  (reference-architecture per-tuple path, codec/event.rs).
- CUDA engine: row-message payloads accumulate as raw bytes per
  contiguous same-table run; at flush, each run is framed (native framer),
  staged and decoded on the device in one batch (a `DeviceDecoder` on
  `BatchConfig.device`, through the loop's `DecodePipeline`), emitted as
  `DecodedBatchEvent`s. Control events (Begin/Commit/Relation/Truncate/
  SchemaChange) stay host-decoded and act as run barriers — mirroring the
  reference's per-table batching between barriers
  (bigquery/core.rs:956-978).

Copy of the reference's `etl_tpu/runtime/assembler.py`; the engine value
CUDA takes the place of the reference's TPU. Every sealed run's row count
lands in the `etl_assembler_run_rows` histogram: what the runtime hands
the card.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np

from ..analysis.annotations import hot_loop
from ..config.pipeline import BatchEngine
from ..models.errors import ErrorKind, EtlError
from ..models.event import DecodedBatchEvent, Event
from ..models.lsn import Lsn
from ..models.schema import ReplicatedTableSchema, TableId
from ..ops.engine import DeviceDecoder
from ..ops.pipeline import DecodePipeline
from ..ops.wal import stage_wal_batch
from ..postgres.codec import event as event_codec
from ..postgres.codec import pgoutput


@dataclass
class _Run:
    """A contiguous run of row messages for one table."""

    table_id: TableId
    schema: ReplicatedTableSchema
    payloads: list[bytes] = field(default_factory=list)
    start_lsns: list[int] = field(default_factory=list)
    commit_lsns: list[int] = field(default_factory=list)
    tx_ordinals: list[int] = field(default_factory=list)
    nbytes: int = 0  # size-hint bytes (64/row + payload), the seal bound


#: seal an open run once it reaches this many rows: decode dispatch
#: starts while the stream keeps flowing (the device decode overlaps
#: further WAL intake instead of bunching at flush), and staged batches
#: stay within the 16384-row bucket unless a backlog grows the seal.
RUN_SEAL_ROWS = 16384

#: backlog growth cap for the dynamic seal (the largest standard row
#: bucket): under sustained backlog the apply loop grows seals toward
#: this, so each launch and its two copies carry more rows.
MEGA_SEAL_ROWS = 262_144


#: distinguishes concurrent assemblers' decode heartbeats (apply loop +
#: table-sync catchup loops each own one)
_ASSEMBLER_SEQ = [0]


class EventAssembler:
    def __init__(self, engine: BatchEngine, monitor=None,
                 decode_window: int = 3, supervisor=None, lag_bytes=None,
                 admission_capacity: int = 0, seal_bytes: int = 0,
                 device: str = "cuda", egress_encoder: "str | None" = None):
        self.engine = engine
        # wire-encoder name (ops/egress.py) the destination consumes —
        # threaded into every DeviceDecoder this loop creates, so device
        # batches carry device-rendered wire buffers (`device_egress`)
        self.egress_encoder = egress_encoder
        # torch device of the decoders this loop creates (BatchConfig.
        # device): "cuda" launches the kernels, "cpu" runs their plain
        # versions
        self.device = device
        # byte seal (0 = off): seal the open run once its size-hint
        # bytes reach this bound (scaled with the dynamic row seal the
        # same ×-factor _scaled_max_bytes uses), so one contiguous run
        # can never exceed the flush sizing — size-bounded flushes then
        # cut at event granularity and the write window has batches to
        # pipeline. The apply loop passes BatchConfig.max_size_bytes; at
        # typical row widths the 16384-row seal binds first, so decode
        # batch shapes are unchanged.
        self.seal_bytes = seal_bytes
        # fair-admission wiring (ops/pipeline.AdmissionScheduler): this
        # loop's decode pipeline takes one tenant seat on the process-
        # wide scheduler, weighted by `lag_bytes` (the apply loop's
        # received−durable delta — the SlotLagMetrics shape) so a
        # lagging stream wins more batch admissions when several streams
        # share the device set
        self._lag_bytes = lag_bytes
        self._admission_capacity = admission_capacity
        self._events: list[Event] = []
        # per-event (size_bytes, row_events) — lets flush(max_bytes=...)
        # cut a WAL-ordered prefix at event granularity and keep the
        # remainder's accounting exact (the write window dispatches
        # size-bounded batches instead of one backlog-sized mega write)
        self._meta: list[tuple[int, int]] = []
        # commit watermarks: (n_events_covered, commit_end_lsn) — all
        # events with index < n (counting the open run as one future
        # event) belong to commits ending ≤ commit_end_lsn, so a prefix
        # flush of ≥ n events may claim durability at that LSN once
        # acked. The apply loop records one per commit boundary
        # (note_commit_end); flush() consumes the covered prefix.
        self._commit_marks: list[tuple[int, int]] = []
        self._run: _Run | None = None
        self._decoders: dict[TableId, DeviceDecoder] = {}
        # one decode pipeline (worker thread + bounded in-flight window)
        # serves every table this loop assembles; created lazily so the
        # CPU engine never spawns the thread. The monitor shrinks the
        # window to 1 under memory pressure (runtime/backpressure).
        self._monitor = monitor
        self._decode_window = decode_window
        _ASSEMBLER_SEQ[0] += 1
        self._seq = _ASSEMBLER_SEQ[0]
        self._pipeline: DecodePipeline | None = None
        self._closed = False
        self._supervisor = supervisor  # supervision.Supervisor | None
        # dynamic: the apply loop grows it ×4 (one row bucket per step)
        # under sustained backlog and resets it when the stream idles
        self.seal_rows = RUN_SEAL_ROWS
        self.size_bytes = 0
        # row (non-control) events in the open window: the apply loop's
        # idle-commit fast flush keys on this — control-only windows
        # (CPU-engine Begin/Commit of unowned-table transactions) must
        # stay on the deadline path or durable progress would be written
        # once per commit instead of once per fill window
        self.row_events = 0

    def __len__(self) -> int:
        return len(self._events) + (len(self._run.payloads) if self._run else 0)

    # -- pushes ---------------------------------------------------------------

    def push_control(self, ev: Event, size_hint: int = 64) -> None:
        """Begin/Commit/Relation/Truncate/SchemaChange — barrier events."""
        self._seal_run()
        self._events.append(ev)
        self._meta.append((size_hint, 0))
        self.size_bytes += size_hint

    @hot_loop
    def push_raw_row(self, payload: bytes, schema: ReplicatedTableSchema,
                     start_lsn: Lsn, commit_lsn: Lsn,
                     tx_ordinal: int) -> None:
        """Device fast path: accumulate the raw row-message payload without
        host-side tuple parsing (the framer parses it on the device staging
        path). Callers guarantee payload[0] is I/U/D. @hot_loop: runs once
        per CDC row — a host transfer here caps stream throughput."""
        if self._run is None or self._run.table_id != schema.id \
                or self._run.schema is not schema:
            self._seal_run()
            self._run = _Run(table_id=schema.id, schema=schema)
        r = self._run
        r.payloads.append(payload)
        r.start_lsns.append(int(start_lsn))
        r.commit_lsns.append(int(commit_lsn))
        r.tx_ordinals.append(tx_ordinal)
        r.nbytes += 64 + len(payload)
        self.size_bytes += 64 + len(payload)
        self.row_events += 1
        if len(r.payloads) >= self.seal_rows \
                or (self.seal_bytes
                    and r.nbytes >= self._scaled_seal_bytes()):
            self._seal_run()

    @hot_loop
    def push_raw_rows(self, payloads: list[bytes],
                      schema: ReplicatedTableSchema, start_lsns: list[int],
                      commit_lsn: int, tx_ordinal0: int) -> int:
        """Bulk form of push_raw_row for a contiguous same-table span (the
        apply loop's drained-window fast path): one call per span, list
        extends instead of per-row pushes. Returns the span's payload
        bytes (the caller's tx_bytes accounting needs the same sum).
        @hot_loop: one call per drained span on the saturated path."""
        if self._run is None or self._run.table_id != schema.id \
                or self._run.schema is not schema:
            self._seal_run()
            self._run = _Run(table_id=schema.id, schema=schema)
        r = self._run
        k = len(payloads)
        if len(r.payloads) + k > self.seal_rows and r.payloads:
            # seal BEFORE extending: overshooting the cap would bump the
            # staged batch into the next (unwarmed) row bucket
            self._seal_run()
            self._run = r = _Run(table_id=schema.id, schema=schema)
        r.payloads.extend(payloads)
        r.start_lsns.extend(start_lsns)
        r.commit_lsns.extend([commit_lsn] * k)
        r.tx_ordinals.extend(range(tx_ordinal0, tx_ordinal0 + k))
        nbytes = sum(map(len, payloads))
        r.nbytes += 64 * k + nbytes
        self.size_bytes += 64 * k + nbytes
        self.row_events += k
        if len(r.payloads) >= self.seal_rows \
                or (self.seal_bytes
                    and r.nbytes >= self._scaled_seal_bytes()):
            # byte overshoot of at most one span: the seal check runs per
            # span push, so a drained-window span lands whole
            self._seal_run()
        return nbytes

    def _scaled_seal_bytes(self) -> int:
        """Byte seal scaled with the dynamic row seal — the same growth
        factor the apply loop's _scaled_max_bytes applies, so backlog
        mega-batching grows flush payloads and run seals in lockstep."""
        return self.seal_bytes * max(1, self.seal_rows // RUN_SEAL_ROWS)

    # -- dynamic seal (backlog mega-batching) ---------------------------------

    def grow_seal(self) -> None:
        """×4 per step = exactly one standard row bucket (16384 → 65536 →
        262144), so growth never lands in an intermediate bucket whose
        decode program would be a wasted compile."""
        if self.seal_rows < MEGA_SEAL_ROWS:
            self.seal_rows = min(self.seal_rows * 4, MEGA_SEAL_ROWS)

    def reset_seal(self) -> None:
        self.seal_rows = RUN_SEAL_ROWS

    def push_row_message(self, msg: pgoutput.LogicalReplicationMessage,
                         payload: bytes, schema: ReplicatedTableSchema,
                         start_lsn: Lsn, commit_lsn: Lsn,
                         tx_ordinal: int) -> None:
        if self.engine is BatchEngine.CPU:
            if isinstance(msg, pgoutput.InsertMessage):
                ev: Event = event_codec.decode_insert(
                    msg, schema, start_lsn, commit_lsn, tx_ordinal)
            elif isinstance(msg, pgoutput.UpdateMessage):
                ev = event_codec.decode_update(
                    msg, schema, start_lsn, commit_lsn, tx_ordinal)
            elif isinstance(msg, pgoutput.DeleteMessage):
                ev = event_codec.decode_delete(
                    msg, schema, start_lsn, commit_lsn, tx_ordinal)
            else:
                raise EtlError(ErrorKind.REPLICATION_MESSAGE_INVALID,
                               f"not a row message: {type(msg).__name__}")
            self._events.append(ev)
            self._meta.append((64 + len(payload), 1))
            self.size_bytes += 64 + len(payload)
            self.row_events += 1
            return
        # device path: defer decode, accumulate raw payloads
        self.push_raw_row(payload, schema, start_lsn, commit_lsn, tx_ordinal)

    # -- flush ----------------------------------------------------------------

    def _seal_run(self) -> None:
        if self._run is None or not self._run.payloads:
            self._run = None
            return
        from ..chaos import failpoints

        # chaos site: fires once per sealed run (a decode batch is born)
        failpoints.fail_point(failpoints.ASSEMBLER_SEAL)
        r = self._run
        self._run = None
        decoder = self._decoders.get(r.table_id)
        if decoder is None or decoder.schema is not r.schema:
            # the kernel reads its layout from a runtime descriptor, so a
            # new schema compiles nothing; on "cuda" the kernel library
            # was built at Pipeline.start, and a card that cannot build or
            # launch it fails the flush (no fallback to the oracle)
            decoder = DeviceDecoder(r.schema, device=self.device,
                                    egress=self.egress_encoder)
            self._decoders[r.table_id] = decoder
        from ..telemetry.metrics import ETL_ASSEMBLER_RUN_ROWS, registry

        registry.histogram_observe(ETL_ASSEMBLER_RUN_ROWS, len(r.payloads))
        lens = np.fromiter((len(p) for p in r.payloads), dtype=np.int32,
                           count=len(r.payloads))
        offs = np.zeros(len(r.payloads), dtype=np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        buf = b"".join(r.payloads)
        n_cols = r.schema.replicated_column_count()
        wal = stage_wal_batch(buf, offs, lens, n_cols)
        if wal.bad_from >= 0:
            raise EtlError(ErrorKind.WAL_DECODE_FAILED,
                           f"malformed row message at run index {wal.bad_from}")
        # pipelined dispatch (ops/pipeline.py): the pack runs on the
        # pipeline's worker thread into a pooled arena and the device
        # decodes (and streams results back) while the apply loop keeps
        # reading WAL; the DecodedBatchEvent resolves the batch lazily
        # when the destination write consumes it, in submit order — the
        # bounded in-flight window caps staged memory across flushes
        if self._closed:
            raise EtlError(ErrorKind.INVALID_STATE_TRANSITION,
                           "event assembler is closed: a resumed apply loop "
                           "builds a new one")
        if self._pipeline is None:
            hb = None
            if self._supervisor is not None:
                # decode components are observe-only: recovery of a stuck
                # pipeline rides the owning worker's restart, and repeated
                # detections escalate to the host-oracle degrade
                from ..supervision import DECODE_PREFIX

                hb = self._supervisor.register(
                    f"{DECODE_PREFIX}cdc-{self._seq}")
            from ..ops.pipeline import global_admission

            admission = global_admission(
                self._admission_capacity or None).register(
                    f"cdc-{self._seq}", lag_bytes=self._lag_bytes,
                    monitor=self._monitor)
            self._pipeline = DecodePipeline(window=self._decode_window,
                                            monitor=self._monitor,
                                            name="cdc", heartbeat=hb,
                                            admission=admission)
            # an assembler dropped without close() (a caller that never
            # ran the apply loop's teardown) still stops its worker and
            # frees its admission seat when it is collected: the worker
            # holds the pipeline, never the assembler, so nothing else
            # would ever close it
            weakref.finalize(self, self._pipeline.close)
        # publication row-filter eligibility: the fused device filter
        # compacts INSERT-only runs (and the COPY path); runs carrying
        # updates/deletes keep the server-side filtering contract — the
        # U/D row-filter transforms (UPDATE whose old image leaves the
        # filter becomes INSERT, etc.) are walsender semantics the client
        # does not re-implement (docs/decode-pipeline.md)
        from ..models.event import ChangeType

        wal.staged.allow_row_filter = bool(
            wal.old_staged is None
            and (wal.change_types == ChangeType.INSERT).all())
        if wal.old_staged is not None:
            wal.old_staged.allow_row_filter = False
        pending = self._pipeline.submit(decoder, wal.staged)
        old_pending = self._pipeline.submit(decoder, wal.old_staged) \
            if wal.old_staged is not None else None
        self._events.append(DecodedBatchEvent(
            Lsn(r.start_lsns[0]), Lsn(r.commit_lsns[-1]), r.schema,
            pending=pending,
            change_types=wal.change_types,
            commit_lsns=np.asarray(r.commit_lsns, dtype=np.uint64),
            tx_ordinals=np.asarray(r.tx_ordinals, dtype=np.uint64),
            old_pending=old_pending, old_rows=wal.old_rows,
            old_is_key=wal.old_is_key, delete_is_key=wal.delete_is_key,
        ))
        self._meta.append((64 * len(r.payloads) + sum(map(len, r.payloads)),
                           len(r.payloads)))

    def note_commit_end(self, end_lsn: Lsn) -> None:
        """Record a commit watermark: every event assembled SO FAR
        (counting the open run as the one event it seals into) belongs
        to transactions whose commit ends ≤ `end_lsn`. The open run may
        still grow past the mark — the sealed event then carries extra
        later rows, which only makes the covered prefix a superset
        (claiming durability at the mark stays exact). The apply loop
        calls this once per commit boundary; flush() consumes marks with
        the prefix they cover."""
        n = len(self._events) \
            + (1 if self._run is not None and self._run.payloads else 0)
        lsn = int(end_lsn)
        if self._commit_marks and self._commit_marks[-1][0] == n:
            self._commit_marks[-1] = (n, max(self._commit_marks[-1][1], lsn))
        else:
            self._commit_marks.append((n, lsn))

    def flush(self) -> list[Event]:
        """Seal any open run, return and reset the assembled events
        (the whole window — legacy signature; the apply loop's
        size-bounded dispatch goes through `flush_bounded`)."""
        return self.flush_bounded()[0]

    def flush_bounded(self, max_bytes: "int | None" = None
                      ) -> "tuple[list[Event], Lsn | None, Lsn | None]":
        """Seal any open run and return `(events, covered_commit_end,
        remaining_commit_end)`.

        With `max_bytes=None` (or everything fitting) the whole window
        flushes — exact legacy behavior. Otherwise a WAL-ORDERED PREFIX
        of events totalling ≤ max_bytes (always at least one event) is
        returned and the remainder stays assembled, so the write window
        dispatches size-bounded batches a backlog can pipeline instead
        of one backlog-sized mega write.

        `covered_commit_end` is the highest commit watermark whose
        events are ALL inside the returned prefix (None = the flush
        covers no commit boundary — mid-transaction split);
        `remaining_commit_end` is the highest watermark still pending in
        the assembler (None = nothing awaits a future flush)."""
        self._seal_run()
        if max_bytes is None or self.size_bytes <= max_bytes \
                or len(self._events) <= 1:
            events = self._events
            covered = Lsn(self._commit_marks[-1][1]) \
                if self._commit_marks else None
            self._events = []
            self._meta = []
            self._commit_marks = []
            self.size_bytes = 0
            self.row_events = 0
            return events, covered, None
        cum = 0
        k = 0
        n = len(self._events)
        while k < n and (k == 0 or cum + self._meta[k][0] <= max_bytes):
            cum += self._meta[k][0]
            k += 1
        events = self._events[:k]
        self._events = self._events[k:]
        self._meta = self._meta[k:]
        self.size_bytes -= cum
        self.row_events = sum(r for _, r in self._meta)
        covered = None
        while self._commit_marks and self._commit_marks[0][0] <= k:
            covered = Lsn(self._commit_marks.pop(0)[1])
        self._commit_marks = [(m - k, lsn) for m, lsn in self._commit_marks]
        remaining = Lsn(self._commit_marks[-1][1]) \
            if self._commit_marks else None
        return events, covered, remaining

    def close(self) -> None:
        """Stop the decode pipeline's worker (apply-loop teardown).
        Already-flushed DecodedBatchEvents stay resolvable — close only
        fences new submits. A closed assembler seals no more runs: a
        resumed apply loop builds a fresh one. `join` then waits for the
        worker to exit.

        Runs sealed (and submitted) but not flushed yet can never be
        delivered from this incarnation — the resumed loop re-streams
        them — so their pending decodes are abandoned here: a hard-killed
        loop would otherwise leave their staging arenas leased."""
        self._closed = True
        for ev in self._events:
            abandon = getattr(ev, "abandon", None)
            if abandon is not None:
                abandon()
        self._events = []
        self._meta = []
        self._commit_marks = []
        self.size_bytes = 0
        self.row_events = 0
        if self._pipeline is not None:
            self._pipeline.close()

    def join(self, timeout: float) -> bool:
        """Wait up to `timeout` s for the worker `close` stopped; True when
        it has exited (or there was none). Blocks: the apply loop runs it
        in an executor."""
        return self._pipeline is None or self._pipeline.join(timeout)
