"""Poison-pill isolation: batch bisection, per-table quarantine, and the
durable dead-letter protocol on the apply path.

Before this module, a single undeliverable row took the whole shard
down: a PERMANENT destination error (schema drift, unencodable value,
destination 4xx → `models.errors.POISON_KINDS`) exhausted `RetryPolicy`
at the worker level and the apply worker died, halting replication for
every table the shard owns. The streaming CDC path had no isolation
boundary between one poisoned row and the pipeline.

`PoisonIsolator.submit(events)` is that boundary. It sits inside the
ack-window write task (the apply loop's flush `submit()` calls it
instead of `Destination.write_event_batches` directly) and guarantees:

  fast path     — one extra set-membership check per flush when nothing
                  is quarantined and the write succeeds;
  quarantine    — events of quarantined tables bypass the destination
                  and park straight on the dead-letter surface (counted,
                  durable) while every other table's events deliver;
  isolation     — a write failing with a poison kind (and only a poison
                  kind: transient/breaker failures re-raise into the
                  normal worker-retry path, destination-down NEVER
                  bisects) is split by table, each failing table's batch
                  is binary-bisected down to the poison row(s) in
                  O(log batch) probe writes, the healthy complement
                  delivers in WAL order, and the poison rows append to
                  the DLQ keyed by their WAL coordinates (idempotent
                  under crash-and-re-stream);
  budget        — a table exceeding `PoisonConfig.budget_rows`
                  dead-lettered rows inside a sliding window transitions
                  active → quarantined: its remaining rows park WITHOUT
                  further probe writes (the budget bounds isolation work)
                  and the quarantine record persists so a restarted
                  worker parks the table from its first flush.

The zero-loss invariant becomes `delivered ∪ dead-lettered == committed
truth`, enforced together with the bisection write bound (≤ 2·log₂(batch)
probe writes per poison row, `bisection_bound`, checked off
`ISOLATION_TRACE`).

Durability ordering: a flush only acks durable after its healthy rows
are destination-durable AND its poison/parked rows are store-durable
(`STORE_DLQ_COMMIT` fires inside the append). A hard kill anywhere in
between re-streams the whole flush from durable progress; re-isolated
rows UPSERT on their WAL key (attempts += 1), re-delivered healthy rows
ride the normal at-least-once dup budget.

This module — like runtime/ack_window.py — is a sanctioned owner of
inline durability waits (etl-lint rule 17 applies to @flush_path
callers, not here): the probe writes ARE the durability protocol.

Copy of the reference's `etl_tpu/runtime/poison.py`. A batch event the
device decoded expands to per-row events only when it must be probed
(`destinations.base.expand_batch_events`); the probe writes then carry no
device-rendered text, and the destination encodes them host-side.
"""

from __future__ import annotations

import asyncio
import logging
import math
import re
import time
from collections import deque

from ..config.pipeline import PipelineConfig
from ..destinations.base import (CommitRange, WriteAck,
                                 expand_batch_events)
from ..models.errors import ErrorKind, EtlError, is_poison_error
from ..models.event import (DecodedBatchEvent, DeleteEvent, InsertEvent,
                            RelationEvent, TruncateEvent, UpdateEvent)
from ..models.schema import TableId
from ..store.base import DeadLetterEntry, QuarantineRecord
from ..telemetry.metrics import (ETL_DLQ_ENTRIES_TOTAL,
                                 ETL_POISON_BISECTION_WRITES_TOTAL,
                                 ETL_POISON_ISOLATIONS_TOTAL,
                                 ETL_QUARANTINE_PARKED_EVENTS_TOTAL,
                                 ETL_QUARANTINED_TABLES, registry)
from . import failpoints

logger = logging.getLogger("etl_tpu_torch.poison")

_ROW_EVENTS = (InsertEvent, UpdateEvent, DeleteEvent)

#: per-isolation trace records (appended by every `_isolate` run):
#: {"rows", "tables", "probe_writes", "control_probes", "poison_rows",
#: "quarantined"} — the chaos scenario and bench gate read these to
#: assert the bisection bound (≤ 2·log₂(batch) probes per poison row +
#: one probe per table; control-event barrier writes are counted
#: separately, outside the bound). Bounded: a long-running worker
#: facing a poison trickle must not grow this without limit.
ISOLATION_TRACE: "deque[dict]" = deque(maxlen=256)


def reset_isolation_trace() -> None:
    ISOLATION_TRACE.clear()


#: cap on the stored per-entry column attribution (comma-joined names)
_COLUMNS_MAX_CHARS = 200


def attribute_poison_columns(detail: str, schema) -> str:
    """Best-effort column attribution for an isolated poison row: the
    replicated column names that appear as whole tokens in the
    classified error detail (destinations name the offending column in
    schema-drift / unencodable-value rejections), comma-joined in
    schema order. Empty when the detail names no column — attribution
    is a hint for `dlq inspect`, never load-bearing."""
    if not detail:
        return ""
    hits = []
    for col in schema.replicated_columns:
        name = col.name
        if not name:
            continue
        if re.search(r"(?<![A-Za-z0-9_])" + re.escape(name)
                     + r"(?![A-Za-z0-9_])", detail):
            hits.append(name)
    return ",".join(hits)[:_COLUMNS_MAX_CHARS]


def bisection_bound(rows: int, tables: int, poison_rows: int) -> int:
    """The probe-write budget the protocol must stay under for one
    isolation: one split probe per table in the flush plus 2·⌈log₂ n⌉
    probes per poison row found (each bisection level retries both
    halves of one failing batch). Quarantine parking consumes NO
    probes, so a budget trip only ever tightens the real count."""
    if rows <= 0:
        return tables
    levels = max(1, math.ceil(math.log2(max(2, rows))))
    return tables + max(1, poison_rows) * 2 * levels


class _IsolationAborted(Exception):
    """A probe write failed with a NON-poison error (destination sick,
    breaker opened, store down): isolation stops and the original
    transient error surfaces into the worker-retry path."""

    def __init__(self, cause: BaseException):
        self.cause = cause


class _PoisonGuardedAck:
    """Wraps a deferred (accepted) destination ack so a write error that
    only surfaces at DURABILITY time — BigQuery resolves append failures
    through the ack future — still hits the isolation boundary. The ack
    window awaits this inside its own write task, so overlap across the
    window is preserved; isolations themselves serialize on the
    isolator's lock like any synchronous-failure isolation. On a poison
    failure, `wait_durable` runs the full protocol and then RESOLVES
    (the flush is durable: healthy rows delivered or re-delivered,
    poison rows on the dead-letter store); every other failure
    propagates into the normal worker-retry path."""

    __slots__ = ("_inner", "_events", "_isolator")

    def __init__(self, inner, events, isolator: "PoisonIsolator"):
        self._inner = inner
        self._events = events
        self._isolator = isolator

    @property
    def is_durable(self) -> bool:
        return self._inner.is_durable

    async def wait_durable(self) -> None:
        try:
            await self._inner.wait_durable()
        except EtlError as e:
            await self._isolator._handle_poison(self._events, e)
        finally:
            self._events = None  # the payload is consumed either way


def _settled_ack() -> WriteAck:
    """A durable ack constructed WITHOUT the destination-write failpoint
    (nothing was written by the destination for a fully-parked flush —
    chaos must not count a phantom destination write)."""
    fut = asyncio.get_event_loop().create_future()
    fut.set_result(None)
    return WriteAck(fut)


def _event_table(ev) -> "TableId | None":
    """The table a flush event belongs to, None for table-less controls
    (Begin/Commit)."""
    if isinstance(ev, (DecodedBatchEvent, RelationEvent, *_ROW_EVENTS)):
        return ev.schema.id
    sch = getattr(ev, "table_id", None)
    return sch


class PoisonIsolator:
    """One apply loop's isolation boundary. Created per ApplyLoop (apply
    context only — initial sync keeps the reference's per-table error
    states), shares the loop's store and (wrapped) destination."""

    def __init__(self, *, store, destination, config: PipelineConfig):
        self.store = store
        self.destination = destination
        self.config = config.poison
        # quarantined-table set: loaded from the store on first use so a
        # restarted worker parks from its very first flush; updated by
        # this isolator on budget trips. External lifts (the operator
        # CLI's `unquarantine`) are adopted LIVE: submit() re-reads the
        # store every `quarantine_poll_s` and swaps in the fresh set, so
        # a lifted table resumes streaming without a worker restart.
        self._quarantined: "set[TableId] | None" = None
        self._records: dict[TableId, QuarantineRecord] = {}
        self._last_poll = time.monotonic()
        # sliding poison budget per table: dead-letter timestamps
        self._poison_times: "dict[TableId, deque[float]]" = {}
        # serialize isolations across overlapping ack-window tasks: two
        # concurrent bisections would interleave probe writes and the
        # trace/budget accounting
        self._lock = asyncio.Lock()
        self.stats = {"isolations": 0, "poison_rows": 0,
                      "parked_events": 0, "probe_writes": 0,
                      "quarantined_tables": 0}

    # -- quarantine state -----------------------------------------------------

    async def _ensure_loaded(self) -> None:
        if self._quarantined is not None:
            return
        try:
            self._records = dict(await self.store.get_quarantined_tables())
        except EtlError:
            self._records = {}
        self._quarantined = set(self._records)
        self._last_poll = time.monotonic()
        registry.gauge_set(ETL_QUARANTINED_TABLES, len(self._quarantined))

    async def _maybe_refresh(self) -> None:
        """Live quarantine-lift adoption: every `quarantine_poll_s` the
        flush path re-reads the store's quarantine records and swaps in
        the fresh set, so an operator `unquarantine` (another process)
        takes effect without a worker restart. Serialized on the
        isolation lock — a budget trip persists its record BEFORE the
        local set mutates, so a refresh that waited out an isolation
        always reads at-least-as-current state. A store read failure
        keeps the current set and retries next poll (never fails a
        flush over a poll)."""
        poll = getattr(self.config, "quarantine_poll_s", 0.0)
        if not poll or self._quarantined is None:
            return
        if time.monotonic() - self._last_poll < poll:
            return
        async with self._lock:
            if time.monotonic() - self._last_poll < poll:
                return  # a concurrent submit refreshed while we waited
            self._last_poll = time.monotonic()
            try:
                fresh = dict(await self.store.get_quarantined_tables())
            except EtlError:
                return
            lifted = set(self._quarantined) - set(fresh)
            adopted = set(fresh) - set(self._quarantined)
            self._records = fresh
            self._quarantined = set(fresh)
            registry.gauge_set(ETL_QUARANTINED_TABLES,
                               len(self._quarantined))
            if lifted:
                logger.info(
                    "quarantine lift adopted live for table(s) %s: "
                    "their events stream to the destination again",
                    sorted(lifted))
            if adopted:
                logger.warning(
                    "externally-quarantined table(s) %s adopted from "
                    "the store", sorted(adopted))

    def quarantined_tables(self) -> "set[TableId]":
        return set(self._quarantined or ())

    async def _quarantine(self, table_id: TableId, since_lsn: int,
                          reason: str) -> None:
        assert self._quarantined is not None
        if table_id in self._quarantined:
            return
        record = QuarantineRecord(
            table_id=table_id, since_lsn=since_lsn,
            poison_rows=len(self._poison_times.get(table_id, ())),
            reason=reason[:self.config.max_detail_chars])
        await self.store.set_table_quarantine(table_id, record)
        self._quarantined.add(table_id)
        self._records[table_id] = record
        self.stats["quarantined_tables"] += 1
        registry.gauge_set(ETL_QUARANTINED_TABLES, len(self._quarantined))
        logger.error(
            "table %d QUARANTINED after %d poison rows inside %.0fs "
            "(budget %d): its events now park on the dead-letter store "
            "while other tables keep replicating; replay + unquarantine "
            "via `python -m etl_tpu_torch.dlq` (%s)",
            table_id, record.poison_rows, self.config.window_s,
            self.config.budget_rows, reason[:200])

    def _budget_tripped(self, table_id: TableId) -> bool:
        times = self._poison_times.get(table_id)
        if not times:
            return False
        horizon = time.monotonic() - self.config.window_s
        while times and times[0] < horizon:
            times.popleft()
        return len(times) >= self.config.budget_rows

    def _note_poison(self, table_id: TableId) -> None:
        self._poison_times.setdefault(table_id, deque()).append(
            time.monotonic())

    # -- breaker integration --------------------------------------------------

    def _breaker_open(self) -> bool:
        from ..supervision.breaker import breaker_is_open

        return breaker_is_open(self.destination)

    # -- dead-letter appends --------------------------------------------------

    async def _dead_letter(self, events, error: "EtlError | None",
                           reason: str, columns: str = "") -> int:
        """Append per-row events to the DLQ (idempotent keyed upsert).
        Returns the number appended. A store that cannot persist dead
        letters surfaces as _IsolationAborted carrying the ORIGINAL
        poison error — pre-PR worker behavior, never silent row loss."""
        from ..dlq.codec import encode_row_event

        entries = []
        # parked rows are labeled `quarantine` regardless of the
        # triggering error: most of them are HEALTHY rows the quarantine
        # owns, and the operator CLI must distinguish them from rows a
        # bisection actually proved poison
        kind_name = reason if reason == "quarantine" or error is None \
            else error.kind.name
        detail = (error.detail if error is not None else reason)
        detail = detail[:self.config.max_detail_chars]
        for ev in events:
            change, payload = encode_row_event(ev)
            entries.append(DeadLetterEntry(
                entry_id=0, table_id=ev.schema.id,
                commit_lsn=int(ev.commit_lsn), tx_ordinal=ev.tx_ordinal,
                change_type=change, payload=payload,
                error_kind=kind_name, detail=detail, columns=columns))
        if not entries:
            return 0
        try:
            await self.store.append_dead_letters(entries)
        except EtlError as e:
            if e.kind is ErrorKind.STATE_STORE_FAILED \
                    and "does not persist" in e.detail:
                # store has no DLQ surface: isolation is impossible —
                # fail the flush with the original poison error (the
                # pre-isolation behavior) rather than dropping rows
                raise _IsolationAborted(error or e)
            raise _IsolationAborted(e)
        registry.counter_inc(ETL_DLQ_ENTRIES_TOTAL, len(entries),
                             labels={"reason": reason})
        return len(entries)

    # -- probe writes ---------------------------------------------------------

    async def _probe_write(self, events, trace: dict, *,
                           control: bool = False) -> None:
        """One bisection probe: write a candidate sub-batch and wait its
        durability. Raises EtlError(poison kind) when the sub-batch is
        (still) poisoned, _IsolationAborted on anything else. Control-
        event barrier writes (`control=True`) are accounted separately —
        they are WAL-order bookkeeping, not bisection cost, and must not
        eat into the 2·log₂(batch) bound the chaos gate asserts."""
        if self._breaker_open():
            # the destination went down mid-isolation: stop bisecting
            # immediately — the worker's backoff (not probe writes) is
            # the backpressure against a sick destination
            raise _IsolationAborted(EtlError(
                ErrorKind.DESTINATION_UNAVAILABLE,
                "circuit breaker opened during poison isolation; "
                "re-streaming from durable progress"))
        failpoints.fail_point(failpoints.POISON_BISECT)
        await failpoints.stall_point(failpoints.POISON_BISECT)
        if control:
            trace["control_probes"] += 1
        else:
            trace["probe_writes"] += 1
            self.stats["probe_writes"] += 1
            registry.counter_inc(ETL_POISON_BISECTION_WRITES_TOTAL)
        try:
            batch = list(events)
            if self.destination.supports_transactional_commit():
                # per-probe sub-range: the healthy complement of a
                # bisection must stay coordinated (WAL order makes the
                # sink's high-water advance monotone across probes),
                # while a failing probe lands nothing — so a later DLQ
                # replay of the isolated row deduplicates by exact key,
                # not against a high-water this probe never earned
                rng = CommitRange.from_events(batch)
                if rng is not None:
                    ack = await self.destination \
                        .write_event_batches_committed(batch, rng)
                else:
                    ack = await self.destination.write_event_batches(batch)
            else:
                ack = await self.destination.write_event_batches(batch)
            if ack is not None:
                await ack.wait_durable()
        except EtlError as e:
            if is_poison_error(e):
                raise
            raise _IsolationAborted(e)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            raise _IsolationAborted(e)

    async def _bisect(self, table_id: TableId, events: list,
                      error: EtlError, trace: dict) -> None:
        """Binary-bisect one table's failing per-row batch down to the
        poison row(s): halves that deliver are done, failing halves
        recurse, a failing singleton IS a poison row → dead-letter it.
        WAL order within the table is preserved (left half probes before
        right). O(2·log₂ n) probes per poison row."""
        if self._budget_tripped(table_id):
            # budget exhausted mid-bisection: park the remainder without
            # further probes — the budget bounds isolation work
            await self._quarantine(
                table_id, int(events[0].commit_lsn),
                f"poison budget exceeded during isolation: {error}")
            n = await self._dead_letter(events, error, "quarantine")
            trace["parked"] += n
            self.stats["parked_events"] += n
            registry.counter_inc(ETL_QUARANTINE_PARKED_EVENTS_TOTAL, n)
            return
        if len(events) == 1:
            ev = events[0]
            self._note_poison(table_id)
            await self._dead_letter(
                [ev], error, "poison",
                columns=attribute_poison_columns(error.detail or "",
                                                 ev.schema))
            trace["poison_rows"] += 1
            self.stats["poison_rows"] += 1
            logger.warning(
                "poison row isolated: table %d commit_lsn %s ordinal %d "
                "(%s) parked on the dead-letter store",
                table_id, ev.commit_lsn, ev.tx_ordinal, error.kind.name)
            if self._budget_tripped(table_id):
                await self._quarantine(
                    table_id, int(ev.commit_lsn),
                    f"poison budget exceeded: {error}")
            return
        mid = len(events) // 2
        for half in (events[:mid], events[mid:]):
            try:
                await self._probe_write(half, trace)
            except EtlError as e:
                await self._bisect(table_id, half, e, trace)

    async def _isolate(self, events, error: EtlError) -> None:
        """The isolation protocol over one failed flush: expand to
        per-row events (WAL order preserved), split by table within
        control-event-delimited segments, probe each table once, bisect
        the failing ones, park everything a quarantine owns."""
        registry.counter_inc(ETL_POISON_ISOLATIONS_TOTAL)
        self.stats["isolations"] += 1
        expanded = expand_batch_events(list(events))
        n_rows = sum(1 for e in expanded if isinstance(e, _ROW_EVENTS))
        trace = {"rows": n_rows, "tables": 0, "probe_writes": 0,
                 "control_probes": 0, "poison_rows": 0, "parked": 0,
                 "quarantined": []}
        before_q = set(self._quarantined or ())
        logger.warning(
            "flush failed with permanent %s over %d rows: entering "
            "poison isolation (bisection bound: see docs/dead-letter.md)",
            error.kind.name, n_rows)
        try:
            segment: "dict[TableId, list]" = {}
            seg_order: list[TableId] = []

            async def flush_segment() -> None:
                for tid in seg_order:
                    rows = segment[tid]
                    trace["tables"] += 1
                    if self._budget_tripped(tid) \
                            or tid in (self._quarantined or ()):
                        await self._quarantine(
                            tid, int(rows[0].commit_lsn),
                            f"poison budget exceeded: {error}")
                        n = await self._dead_letter(rows, error,
                                                    "quarantine")
                        trace["parked"] += n
                        self.stats["parked_events"] += n
                        registry.counter_inc(
                            ETL_QUARANTINE_PARKED_EVENTS_TOTAL, n)
                        continue
                    try:
                        await self._probe_write(rows, trace)
                    except EtlError as e:
                        await self._bisect(tid, rows, e, trace)
                segment.clear()
                seg_order.clear()

            for ev in expanded:
                if isinstance(ev, _ROW_EVENTS):
                    tid = ev.schema.id
                    if tid not in segment:
                        segment[tid] = []
                        seg_order.append(tid)
                    segment[tid].append(ev)
                    continue
                # control event: a WAL-order barrier — deliver every
                # pending row segment first, then the control alone. A
                # control write that fails poison cannot be bisected
                # further; it aborts isolation with the original error.
                await flush_segment()
                try:
                    await self._probe_write([ev], trace, control=True)
                except EtlError as e:
                    raise _IsolationAborted(e)
            await flush_segment()
        except _IsolationAborted as a:
            trace["aborted"] = repr(a.cause)
            ISOLATION_TRACE.append(trace)
            cause = a.cause
            raise cause if isinstance(cause, BaseException) else EtlError(
                ErrorKind.DESTINATION_FAILED, str(cause))
        trace["quarantined"] = sorted(set(self._quarantined or ())
                                      - before_q)
        ISOLATION_TRACE.append(trace)

    # -- the flush seam -------------------------------------------------------

    async def _handle_poison(self, events, e: EtlError) -> WriteAck:
        """The single poison dispatch point for BOTH failure surfaces —
        a write call raising synchronously, and a deferred (accepted)
        ack resolving its error at durability time. Re-raises anything
        that must keep worker-retry semantics; isolates otherwise and
        returns a settled ack."""
        if not is_poison_error(e):
            # transient / ambiguous failures keep the existing
            # worker-retry semantics: backoff + re-stream
            raise e
        if self._breaker_open():
            # destination-down never bisects — but the poison error
            # itself must not surface either: its MANUAL directive
            # would park the worker permanently for a row that WILL
            # isolate once the breaker closes. Re-classify as the
            # breaker's own (worker-TIMED) kind; the re-streamed
            # flush isolates after the backoff.
            raise EtlError(
                ErrorKind.DESTINATION_UNAVAILABLE,
                "circuit breaker open at poison classification; "
                "deferring isolation to the re-streamed flush") from e
        async with self._lock:
            # _isolate owns the _IsolationAborted unwrap: any abort
            # (transient probe failure, breaker opening mid-isolation,
            # a DLQ-less store) re-raises its cause from there
            await self._isolate(events, e)
        return _settled_ack()

    async def submit(self, events,
                     commit=None) -> "WriteAck | None":
        """The apply loop's flush `submit()` body. Fast path: one
        membership check + the destination write. Slow paths: park
        quarantined tables' events, isolate on a poison failure —
        whether it surfaces at the write call or (deferred-ack
        destinations: BigQuery transfers append errors to the ack
        future) at durability time, via the guarded ack.

        `commit` (a `CommitRange`, exactly-once pipelines only) rides
        the fast path through `write_event_batches_committed` so the
        sink lands data + coordinate range atomically. Isolation probe
        writes re-derive their own sub-ranges (`_probe_write`): the
        flush-level range covers rows a bisection may park, and
        advancing the sink's high-water past a parked row would make
        its DLQ replay look like a duplicate."""
        await self._ensure_loaded()
        await self._maybe_refresh()
        if self._quarantined:
            healthy, parked = [], []
            for ev in events:
                tid = _event_table(ev)
                if tid in self._quarantined \
                        and isinstance(ev, (DecodedBatchEvent,
                                            *_ROW_EVENTS)):
                    parked.append(ev)
                elif isinstance(ev, TruncateEvent) and all(
                        s.id in self._quarantined for s in ev.schemas):
                    # a truncate of ONLY quarantined tables would clear
                    # destination rows the quarantine still owes; park
                    # it as a log-only drop (content-independent, the
                    # replay runbook re-syncs the table anyway)
                    logger.warning("dropping TRUNCATE of quarantined "
                                   "table(s) %s",
                                   [s.id for s in ev.schemas])
                else:
                    healthy.append(ev)
            if parked:
                rows = expand_batch_events(parked)
                rows = [e for e in rows if isinstance(e, _ROW_EVENTS)]
                n = await self._park_rows(rows)
                self.stats["parked_events"] += n
            events = healthy
        if not events:
            return _settled_ack()
        events = list(events)
        try:
            if commit is not None:
                ack = await self.destination.write_event_batches_committed(
                    events, commit)
            else:
                ack = await self.destination.write_event_batches(events)
        except EtlError as e:
            return await self._handle_poison(events, e)
        if ack is None or ack.is_durable:
            return ack
        # deferred (accepted) ack: the write's errors may only surface
        # at durability time — extend the isolation boundary over the
        # wait, or a poison rejection there would reach the worker
        # unisolated (and, being MANUAL, park the whole shard)
        return _PoisonGuardedAck(ack, events, self)

    async def _park_rows(self, rows) -> int:
        try:
            n = await self._dead_letter(rows, None, "quarantine")
        except _IsolationAborted as a:
            raise a.cause
        if n:
            registry.counter_inc(ETL_QUARANTINE_PARKED_EVENTS_TOTAL, n)
            # keep the persisted record's parked counter current so the
            # operator CLI shows how much the table owes on replay.
            # RECOMPUTED from the store, not incremented: an
            # at-least-once re-stream re-parks the same rows (the DLQ
            # upsert absorbs them by WAL key) and an increment would
            # double-count them on the operator-facing record
            assert self._quarantined is not None
            for tid in {r.schema.id for r in rows}:
                rec = self._records.get(tid)
                if rec is None:
                    continue
                from dataclasses import replace

                parked = await self.store.list_dead_letters(
                    table_id=tid, status=None)
                rec = replace(rec, parked_events=sum(
                    1 for p in parked if p.error_kind == "quarantine"))
                self._records[tid] = rec
                await self.store.set_table_quarantine(tid, rec)
        return n
