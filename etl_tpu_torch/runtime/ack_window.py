"""Bounded destination-ack window: overlap N in-flight writes with
contiguous-prefix durability.

Every upstream stage is batched and overlapped (decode pipeline,
columnar egress, mesh sharding), but a one-in-flight apply loop caps the
whole pipeline at `batch_size / ack_round-trip` on any destination with
real ack latency. The `WriteAck` seam already separates submission from
durability — this module exploits it:

  - the apply loop keeps dispatching flushes IN WAL ORDER while up to
    `BatchConfig.write_window` earlier acks are still pending (bytes-
    capped by `write_window_max_bytes`; the memory monitor shrinks the
    window to 1 under pressure, same as the decode pipeline);
  - submissions are CHAINED: write N+1's `write_event_batches` call
    starts only after write N's submission returned its ack — the
    destination sees batches in WAL order, only the durability waits
    overlap (the ack-pipelining contract, docs/destinations.md);
  - durable progress advances only over the CONTIGUOUS ACKED PREFIX:
    an out-of-order ack completion is held until everything before it
    is durable, so the progress store — and the replication slot —
    never claim durability past an unacked write;
  - a mid-window failure fails the worker, which re-streams from
    durable progress: at-least-once preserved, and the bounded-dup
    budget grows by at most the window size (the batches that were in
    flight past the durable prefix).

THE WINDOW OWNS THE DURABILITY WAITS. Flush/dispatch paths are marked
`@flush_path` and etl-lint rule 17 (`inline-durability-wait`) forbids a
bare `await ack.wait_durable()` there — an inline wait would silently
re-serialize the pipeline to one ack round-trip per batch. This module
is the sanctioned owner (and is deliberately unmarked).

`CopyAckWindow` is the copy-path sibling: `runtime/copy.py` used to
accumulate every partition ack in an unbounded list until end-of-copy —
a huge table could hold arbitrarily many unresolved acks (and surface a
failed ack only at the partition barrier). The bounded window caps
outstanding copy acks and awaits the OLDEST first, preserving
per-partition ordering while surfacing errors as soon as the window
turns over.

Copy of the reference's `etl_tpu/runtime/ack_window.py`.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Awaitable, Callable

from ..destinations.base import WriteAck
from ..models.errors import ErrorKind, EtlError
from ..telemetry.metrics import (ETL_DESTINATION_ACK_BUSY_SECONDS_TOTAL,
                                 ETL_DESTINATION_ACK_IN_FLIGHT,
                                 ETL_DESTINATION_ACK_LATENCY_SECONDS,
                                 ETL_DESTINATION_ACK_OVERLAP_RATIO,
                                 ETL_DESTINATION_ACK_OVERLAP_SECONDS_TOTAL,
                                 ETL_EXACTLY_ONCE_HIGH_WATER_LSN,
                                 registry)


class AckEntry:
    """One dispatched flush: its write task (submission + durability
    wait), the durable watermark it covers, the transactional
    CommitRange it shipped (None on at-least-once paths), its
    accounting, and the payload events (so a hard-killed loop can
    abandon the pending decodes of entries that will never deliver)."""

    __slots__ = ("task", "commit_end_lsn", "commit_range", "n_events",
                 "nbytes", "dispatched_at", "payload")

    def __init__(self, task: asyncio.Task, commit_end_lsn, n_events: int,
                 nbytes: int, dispatched_at: float, payload=None,
                 commit_range=None):
        self.task = task
        self.commit_end_lsn = commit_end_lsn
        self.commit_range = commit_range
        self.n_events = n_events
        self.nbytes = nbytes
        self.dispatched_at = dispatched_at
        self.payload = payload


class AckWindow:
    """The apply loop's bounded write window.

    `dispatch(submit, ...)` spawns one write task per flush. Tasks chain
    their SUBMISSIONS (WAL order at the destination) and overlap their
    durability waits; `pop_ready()` consumes the contiguous completed
    prefix and reports the first failure. Capacity: at most
    `effective_limit()` entries (1 under memory pressure) and at most
    `max_bytes` of pending payload — but an empty window always accepts
    one dispatch, so a single over-budget mega batch can never deadlock.
    """

    def __init__(self, limit: int, max_bytes: int = 0,
                 pressure: "Callable[[], bool] | None" = None,
                 path: str = "apply"):
        self._limit = max(1, int(limit))
        self._max_bytes = max(0, int(max_bytes))
        self._pressure = pressure
        self._entries: "deque[AckEntry]" = deque()
        self._bytes = 0
        # tail of the submission chain: resolves True when that entry's
        # write_event_batches returned (ack obtained), False when it
        # failed/was cancelled — the successor refuses to submit after a
        # failed predecessor so the destination never sees a gap
        self._submit_tail: "asyncio.Future[bool] | None" = None
        self._labels = {"path": path}
        # overlap accounting: busy = ≥1 in flight, overlap = ≥2
        self._last_t = time.monotonic()
        self._busy_s = 0.0
        self._overlap_s = 0.0
        # max (commit_lsn, tx_ordinal) across ACKED transactional writes:
        # monotone because submissions chain in WAL order and only the
        # contiguous durable prefix pops
        self._acked_high: "tuple[int, int] | None" = None

    @property
    def acked_high_water(self) -> "tuple[int, int] | None":
        return self._acked_high

    # -- capacity -------------------------------------------------------------

    def effective_limit(self) -> int:
        if self._pressure is not None and self._pressure():
            return 1  # drain-to-serial under memory pressure
        return self._limit

    def set_limit(self, limit: int) -> None:
        """Retarget the window depth at runtime (the fleet signal bus's
        adaptive-depth plugin drives this from the measured ack-latency
        histogram). Shrinking never cancels in-flight writes — the
        window just refuses new dispatches until it drains below the
        new depth; memory pressure still clamps to 1 regardless."""
        self._limit = max(1, int(limit))

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def is_empty(self) -> bool:
        return not self._entries

    @property
    def pending_bytes(self) -> int:
        return self._bytes

    def can_dispatch(self, nbytes: int = 0) -> bool:
        if not self._entries:
            return True  # always admit one: no byte-cap deadlock
        if len(self._entries) >= self.effective_limit():
            return False
        if self._max_bytes and self._bytes + nbytes > self._max_bytes:
            return False
        return True

    def tasks(self) -> "list[asyncio.Task]":
        return [e.task for e in self._entries]

    def any_done(self) -> bool:
        return any(e.task.done() for e in self._entries)

    def any_actionable(self) -> bool:
        """A completion the select loop can act on NOW: the HEAD entry
        finished (the contiguous prefix can advance) or any completed
        entry failed (fail fast). A successful OUT-OF-ORDER completion
        is deliberately not actionable — it pops only once contiguous,
        so treating it as a wake condition would spin the loop against
        pop_ready's empty result until the head ack resolves."""
        if self._entries and self._entries[0].task.done():
            return True
        return any(
            e.task.done() and (e.task.cancelled()
                               or e.task.exception() is not None)
            for e in self._entries)

    def pending_tasks(self) -> "list[asyncio.Task]":
        """Tasks still running — what the select loop waits on (a done
        task in the wait set would make asyncio.wait return immediately
        on every iteration)."""
        return [e.task for e in self._entries if not e.task.done()]

    # -- dispatch -------------------------------------------------------------

    def dispatch(self, submit: "Callable[[], Awaitable[WriteAck | None]]",
                 *, commit_end_lsn=None, n_events: int = 0,
                 nbytes: int = 0,
                 on_durable: "Callable[[], None] | None" = None,
                 payload=None, commit_range=None) -> AckEntry:
        """Start one write: `submit()` performs the destination call and
        returns its ack (None for an event-less commit-boundary flush).
        The window serializes submissions in dispatch order and owns the
        durability wait; `on_durable` runs after the ack resolves (egress
        accounting rides durable acks). `commit_range` is the
        transactional CommitRange the submit ships (None on at-least-once
        paths): because submissions chain in WAL order and pops consume
        only the contiguous durable prefix, the acked ranges advance
        monotonically — `acked_high_water` exposes the max, the
        coordinate a restart's sink-side recovery should agree with."""
        prev = self._submit_tail
        loop = asyncio.get_event_loop()
        submitted: "asyncio.Future[bool]" = loop.create_future()
        self._submit_tail = submitted
        t0 = time.monotonic()

        async def run() -> None:
            ack = None
            try:
                if prev is not None and not await prev:
                    raise EtlError(
                        ErrorKind.DESTINATION_FAILED,
                        "an earlier write in the ack window failed to "
                        "submit; this batch re-streams from durable "
                        "progress")
                ack = await submit()
            except BaseException:
                if not submitted.done():
                    submitted.set_result(False)
                raise
            if not submitted.done():
                submitted.set_result(True)
            if ack is not None:
                await ack.wait_durable()
                registry.histogram_observe(
                    ETL_DESTINATION_ACK_LATENCY_SECONDS,
                    time.monotonic() - t0, labels=self._labels)
            if on_durable is not None:
                on_durable()

        self._tick()
        entry = AckEntry(asyncio.ensure_future(run()), commit_end_lsn,
                         n_events, nbytes, t0, payload,
                         commit_range=commit_range)
        self._entries.append(entry)
        self._bytes += nbytes
        self._publish()
        return entry

    @staticmethod
    def _abandon_entry(entry: AckEntry) -> None:
        for ev in entry.payload or ():
            ab = getattr(ev, "abandon", None)
            if ab is not None:
                ab()

    def abandon_payloads(self) -> None:
        """Teardown (cancel/kill path): the remaining entries will never
        deliver — abandon their events' pending decodes so pooled
        resources (staging arenas, decode-window slots, admission
        tickets) return instead of leaking with the discarded window.
        Safe after the tasks were cancelled; popped/delivered entries
        already resolved their decodes inside the destination write
        (failed pops abandoned theirs in pop_ready)."""
        for entry in self._entries:
            self._abandon_entry(entry)

    # -- completion -----------------------------------------------------------

    @staticmethod
    def _entry_tables(entry: AckEntry) -> "list[int]":
        tids = set()
        for ev in entry.payload or ():
            sch = getattr(ev, "schema", None)
            if sch is not None:
                tids.add(sch.id)
            for s in getattr(ev, "schemas", ()) or ():
                tids.add(s.id)
        return sorted(tids)

    @staticmethod
    def _entry_failure(entry: AckEntry) -> "BaseException | None":
        if entry.task.cancelled():
            return EtlError(ErrorKind.DESTINATION_FAILED,
                            "in-flight destination write cancelled")
        return entry.task.exception()

    @classmethod
    def _aggregate_failures(
            cls, failed: "list[tuple[AckEntry, BaseException]]"
    ) -> "BaseException | None":
        """EVERY completed failure in the window surfaces at once, each
        annotated with its entry's tables. A single failure raises
        unchanged (exact legacy behavior); multiple failures aggregate
        into one EtlError whose `kinds()` union all causes — so
        multi-table poison in one window reaches the isolation layer as
        ONE signal (bisected once), not across N worker restarts, and
        the retry classifier still sees every kind."""
        if not failed:
            return None
        if len(failed) == 1:
            return failed[0][1]
        causes = []
        table_note = []
        for entry, exc in failed:
            tables = cls._entry_tables(entry)
            table_note.append(f"tables {tables}")
            if isinstance(exc, EtlError):
                wrapped = EtlError(
                    exc.kind, f"{exc.detail} [tables {tables}]",
                    causes=exc.causes)
            else:
                wrapped = EtlError(
                    ErrorKind.DESTINATION_FAILED,
                    f"{exc!r} [tables {tables}]")
            # keep the original exception (and its traceback) on the
            # chain — a repr alone makes a multi-failure window
            # materially harder to debug than the single-failure path
            wrapped.__cause__ = exc
            causes.append(wrapped)
        # kind of the FIRST failure, every other as a cause: kinds()
        # reports the full union (no synthetic UNKNOWN diluting the
        # poison/transient classification the way EtlError.many would)
        return EtlError(
            causes[0].kind,
            f"{len(causes)} window writes failed "
            f"({'; '.join(table_note)})", causes=causes[1:])

    def pop_ready(self) -> "tuple[list[AckEntry], BaseException | None]":
        """Consume the contiguous completed prefix. Returns the entries
        that completed durably (in WAL order) plus the failure signal:
        ALL completed failures — the popped head-most one and every
        completed failure DEEPER in the window — aggregated into one
        error naming each failed entry's tables (a permanent multi-table
        poison in one window surfaces whole, not one table per worker
        restart). Still-running entries before a deep failure are NOT
        popped. The caller advances durable progress over the returned
        entries BEFORE raising, so a mid-window error re-streams as
        little as possible."""
        self._tick()
        done: "list[AckEntry]" = []
        failed: "list[tuple[AckEntry, BaseException]]" = []
        while self._entries and self._entries[0].task.done():
            entry = self._entries.popleft()
            self._bytes -= entry.nbytes
            exc = self._entry_failure(entry)
            if exc is not None:
                failed.append((entry, exc))
                # the failed entry leaves the window here, so teardown's
                # abandon_payloads would miss it: release its pending
                # decodes now (the restart re-streams the events — they
                # will never be consumed from this incarnation).
                # Successors stay in the window: durable progress must
                # never advance past the failed entry's undelivered WAL,
                # so a done SUCCESSOR cannot pop either.
                self._abandon_entry(entry)
                break
            if entry.commit_range is not None \
                    and not entry.commit_range.replay:
                high = entry.commit_range.high
                if self._acked_high is None or high > self._acked_high:
                    self._acked_high = high
                    registry.gauge_set(ETL_EXACTLY_ONCE_HIGH_WATER_LSN,
                                       high[0], labels=self._labels)
            done.append(entry)
        # surface every other completed failure too (fail fast + the
        # whole poison signal): a later entry that already failed can
        # never become durable, and every entry after the first failure
        # re-streams anyway. Cancellation counts (same as the head path)
        # — any_actionable treats it as a failure, so skipping it here
        # would zero-timeout-spin the select loop against an empty pop
        for entry in self._entries:
            if not entry.task.done():
                continue
            exc = self._entry_failure(entry)
            if exc is not None:
                failed.append((entry, exc))
        self._publish()
        return done, self._aggregate_failures(failed)

    async def wait_all(self) -> None:
        """Await every in-flight task (results stay queued for
        `pop_ready`; exceptions are NOT raised here)."""
        tasks = self.tasks()
        if tasks:
            await asyncio.wait(tasks)

    # -- telemetry ------------------------------------------------------------

    def _tick(self) -> None:
        now = time.monotonic()
        dt = now - self._last_t
        self._last_t = now
        n = len(self._entries)
        if n >= 1:
            self._busy_s += dt
            registry.counter_inc(ETL_DESTINATION_ACK_BUSY_SECONDS_TOTAL,
                                 dt, labels=self._labels)
        if n >= 2:
            self._overlap_s += dt
            registry.counter_inc(ETL_DESTINATION_ACK_OVERLAP_SECONDS_TOTAL,
                                 dt, labels=self._labels)

    def _publish(self) -> None:
        registry.gauge_set(ETL_DESTINATION_ACK_IN_FLIGHT,
                           len(self._entries), labels=self._labels)
        if self._busy_s > 0:
            registry.gauge_set(ETL_DESTINATION_ACK_OVERLAP_RATIO,
                               self._overlap_s / self._busy_s,
                               labels=self._labels)

    def stats(self) -> dict:
        self._tick()
        return {
            "in_flight": len(self._entries),
            "pending_bytes": self._bytes,
            "busy_seconds": self._busy_s,
            "overlap_seconds": self._overlap_s,
            "overlap_ratio": (self._overlap_s / self._busy_s)
            if self._busy_s else 0.0,
        }


class CopyAckWindow:
    """Bounded FIFO of unresolved copy acks for ONE partition: `add()`
    awaits the oldest ack once the window is full (per-partition ordering
    preserved — exactly the order the old end-of-copy drain used), so a
    huge table holds at most `limit` pending acks instead of one per
    batch, and a failed ack surfaces within `limit` batches instead of at
    the partition barrier. Shrinks to 1 under memory pressure."""

    def __init__(self, limit: int,
                 pressure: "Callable[[], bool] | None" = None):
        self._limit = max(1, int(limit))
        self._pressure = pressure
        self._acks: "deque[tuple[WriteAck, float]]" = deque()
        self._labels = {"path": "copy"}

    def effective_limit(self) -> int:
        if self._pressure is not None and self._pressure():
            return 1
        return self._limit

    def set_limit(self, limit: int) -> None:
        """Runtime depth retarget (see AckWindow.set_limit): excess
        pending acks drain FIFO on the next add()."""
        self._limit = max(1, int(limit))

    def __len__(self) -> int:
        return len(self._acks)

    async def _pop_oldest(self) -> None:
        ack, t0 = self._acks.popleft()
        try:
            await ack.wait_durable()
        finally:
            registry.gauge_set(ETL_DESTINATION_ACK_IN_FLIGHT,
                               len(self._acks), labels=self._labels)
        registry.histogram_observe(ETL_DESTINATION_ACK_LATENCY_SECONDS,
                                   time.monotonic() - t0,
                                   labels=self._labels)

    async def add(self, ack: WriteAck) -> None:
        self._acks.append((ack, time.monotonic()))
        registry.gauge_set(ETL_DESTINATION_ACK_IN_FLIGHT,
                           len(self._acks), labels=self._labels)
        while len(self._acks) > self.effective_limit():
            await self._pop_oldest()

    async def drain(self) -> None:
        """The partition durability barrier (reference mod.rs:360-378):
        every remaining ack must resolve before copy progress counts."""
        while self._acks:
            await self._pop_oldest()
