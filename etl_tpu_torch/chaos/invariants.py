"""Recovery invariants checked after every chaos scenario run.

After the workload drains and the (possibly restarted) pipeline shuts
down, the checker reconstructs the destination's final view and asserts:

  zero-loss       — every committed source row is present (with its final
                    values) after recovery; deletes are absent;
  bounded-dup     — at-least-once duplicates are accounted: a row event
                    may appear more than once only within the re-streamed
                    window budget (restarts + injected fault firings);
                    a fault-free run must be exactly-once;
  monotonic-lsn   — the stored durable-progress trajectory of every
                    progress key never regresses;
  store-consistency — every table ends READY with a stored schema and
                    destination metadata; no table is parked Errored;
  no-leaks        — asyncio tasks, decode-pipeline worker threads, and
                    staging-arena leases return to their pre-run baseline;
                    the fault-injecting destination holds no unresolved
                    acks.

The checker REPORTS rather than raises: the runner embeds the report in
its JSON so the CLI can print every violation of a failing scenario at
once.

Copy of the reference's `etl_tpu/chaos/invariants.py`. The leak probe
counts the port's own decode workers (`ops.pipeline.worker_threads`), by
type and not by thread name: the reference names its workers the same,
and a process that runs both packages must not count the other's.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from ..models.event import (DeleteEvent, InsertEvent, TruncateEvent,
                            UpdateEvent)
from ..models.table_state import TableStateType


#: how long the leak check waits, in all, for the decode workers started
#: since the probe to exit: a closed pipeline's worker leaves within it
#: even on a loaded host, a never-closed one does not
WORKER_JOIN_S = 10.0


@dataclass
class LeakProbe:
    """Pre-run baseline for the leak invariant."""

    tasks: int = 0
    arenas_outstanding: int = 0
    # the port's decode workers alive at the capture
    workers: frozenset = frozenset()

    @classmethod
    def capture(cls) -> "LeakProbe":
        from ..ops.staging import ARENA_POOL

        try:
            tasks = len(asyncio.all_tasks())
        except RuntimeError:  # no running loop (CLI teardown)
            tasks = 0
        from ..ops.pipeline import worker_threads

        return cls(tasks=tasks, arenas_outstanding=ARENA_POOL.outstanding,
                   workers=frozenset(worker_threads()))

    def leaked_workers(self, timeout_s: float = WORKER_JOIN_S) -> list:
        """The port's decode workers started since the capture that are
        still alive after each was joined (`timeout_s` in all), described.
        Joined, not counted at once: a closed pipeline's worker exits a
        beat after the close, later on a busy host."""
        from ..ops.pipeline import describe_thread, worker_threads

        deadline = time.monotonic() + timeout_s
        for t in worker_threads(exclude=self.workers):
            t.join(max(0.0, deadline - time.monotonic()))
        return [describe_thread(t) for t in
                worker_threads(exclude=self.workers) if t.is_alive()]


def _pipeline_thread_count() -> int:
    from ..ops.pipeline import worker_threads

    return sum(1 for t in worker_threads() if t.is_alive())


@dataclass
class InvariantReport:
    ok: bool = True
    violations: list[str] = field(default_factory=list)
    stats: dict = field(default_factory=dict)

    def fail(self, message: str) -> None:
        self.ok = False
        self.violations.append(message)

    def describe(self) -> dict:
        return {"ok": self.ok, "violations": list(self.violations),
                "stats": dict(self.stats)}


def _row_pk(row) -> object:
    return row.values[0]


def reconstruct_final_view(dest, table_ids) -> dict:
    """{table_id: {pk: tuple(values)}} from copied rows + delivered
    events, replayed in WAL order.

    Events delivered before a table's LAST destination drop belong to an
    abandoned copy attempt (the drop-and-recopy crash-consistency path)
    and are excluded. The survivors are sorted by their WAL rank
    (commit_lsn, tx_ordinal) — at-least-once re-delivery then collapses
    naturally, because applying the same ranked event twice is idempotent
    — and applied as a destination would apply them:

      insert/update — upsert by pk; an update carrying an old image whose
                      identity differs from the new row (a PK-changing
                      update) also removes the OLD pk (the delete+upsert
                      split key-aware destinations perform); a new value
                      that is TOAST-unchanged patches column-wise,
                      keeping the stored value (the PATCH path);
      delete        — remove the pk (the old image under replica identity
                      DEFAULT carries only identity columns — the pk is
                      all that is consulted);
      truncate      — clear every listed table, including its copied
                      baseline rows (the barrier the coalesced columnar
                      write path must order correctly).
    """
    from ..models.cell import TOAST_UNCHANGED

    view: dict = {}
    last_drop = getattr(dest, "drop_seq_by_table", {})
    event_seqs = getattr(dest, "event_seqs", None)
    wanted = set(table_ids)
    for tid in table_ids:
        view[tid] = {_row_pk(r): tuple(r.values)
                     for r in dest.table_rows.get(tid, [])}
    # (rank, delivery order, table, event) for every surviving event that
    # touches a wanted table; truncates fan out to each listed table
    ordered: list = []
    for i, e in enumerate(dest.events):
        seq = event_seqs[i] if event_seqs is not None else i
        if isinstance(e, (InsertEvent, UpdateEvent, DeleteEvent)):
            tid = e.schema.id
            if tid not in wanted or seq < last_drop.get(tid, -1):
                continue
            ordered.append(((int(e.commit_lsn), e.tx_ordinal), i, tid, e))
        elif isinstance(e, TruncateEvent):
            for sch in e.schemas:
                if sch.id not in wanted \
                        or seq < last_drop.get(sch.id, -1):
                    continue
                ordered.append(((int(e.commit_lsn), e.tx_ordinal), i,
                                sch.id, e))
    ordered.sort(key=lambda t: (t[0], t[1]))
    for _, _, tid, e in ordered:
        table = view[tid]
        if isinstance(e, TruncateEvent):
            table.clear()
        elif isinstance(e, DeleteEvent):
            table.pop(_row_pk(e.old_row), None)
        else:
            pk = _row_pk(e.row)
            prev = table.get(pk)
            if isinstance(e, UpdateEvent) and e.old_row is not None:
                old_pk = _row_pk(e.old_row)
                if old_pk != pk:
                    # a PK-changing update: the stored row (and so the
                    # TOAST patch source) lives under the OLD key
                    popped = table.pop(old_pk, None)
                    if popped is not None:
                        prev = popped
            values = tuple(
                (prev[k] if prev is not None and k < len(prev) else v)
                if v is TOAST_UNCHANGED else v
                for k, v in enumerate(e.row.values))
            table[pk] = values
    return view


def view_matches(dest, table_ids, expected: dict) -> bool:
    """True when the destination's reconstructed final view equals the
    committed source truth — the shared quiescence/verification test used
    by both the chaos runner and the workload bench harness, so the
    collapse rules above can never silently diverge between them."""
    view = reconstruct_final_view(dest, table_ids)
    for tid, rows in expected.items():
        got = view.get(tid, {})
        if set(got) != set(rows):
            return False
        if any(got[pk] != vals for pk, vals in rows.items()):
            return False
    return True


def check_invariants(*, expected: dict, dest, store,
                     restarts: list, fault_firings: int,
                     leak_probe: LeakProbe,
                     report: InvariantReport | None = None
                     ) -> InvariantReport:
    """Run every invariant; `expected` is {table_id: {pk: tuple(values)}}
    of committed source state, `restarts` the runner's restart records,
    `fault_firings` the number of injected fault firings (the
    redelivery budget), `leak_probe` the pre-run baseline."""
    r = report if report is not None else InvariantReport()

    # -- zero-loss ----------------------------------------------------------
    view = reconstruct_final_view(dest, list(expected))
    lost = dup_rows = 0
    for tid, rows in expected.items():
        got = view.get(tid, {})
        for pk, values in rows.items():
            if pk not in got:
                lost += 1
                r.fail(f"zero-loss: table {tid} row pk={pk!r} missing "
                       f"after recovery")
            elif got[pk] != values:
                r.fail(f"zero-loss: table {tid} pk={pk!r} final values "
                       f"{got[pk]!r} != committed {values!r}")
        for pk in got:
            if pk not in rows:
                r.fail(f"zero-loss: table {tid} pk={pk!r} present at the "
                       f"destination but deleted/never-committed at the "
                       f"source")

    # -- bounded duplication -------------------------------------------------
    budget = 1 + len(restarts) + fault_firings
    counts: dict = {}
    for e in dest.events:
        if not isinstance(e, (InsertEvent, UpdateEvent, DeleteEvent)):
            continue
        row = e.old_row if isinstance(e, DeleteEvent) else e.row
        key = (e.schema.id, int(e.commit_lsn), e.tx_ordinal,
               type(e).__name__, _row_pk(row))
        counts[key] = counts.get(key, 0) + 1
    max_dup = max(counts.values(), default=0)
    for key, n in counts.items():
        if n > budget:
            dup_rows += 1
            r.fail(f"bounded-dup: event {key} delivered {n}x, budget "
                   f"{budget} (1 + {len(restarts)} restarts + "
                   f"{fault_firings} fault firings)")

    # -- monotonic durable progress ------------------------------------------
    progress_log = getattr(store, "progress_log", {})
    for key, lsns in progress_log.items():
        for a, b in zip(lsns, lsns[1:]):
            if b < a:
                r.fail(f"monotonic-lsn: progress key {key!r} regressed "
                       f"{a} -> {b}")

    # -- store / table-state consistency -------------------------------------
    states = getattr(store, "_states", {})
    for tid in expected:
        st = states.get(tid)
        if st is None or st.type is not TableStateType.READY:
            r.fail(f"store-consistency: table {tid} final state "
                   f"{st.type.value if st else 'missing'}, expected ready")
        if not store_has_schema(store, tid):
            r.fail(f"store-consistency: table {tid} has no stored schema")
        if getattr(store, "_dest_meta", {}).get(tid) is None:
            r.fail(f"store-consistency: table {tid} has no destination "
                   f"metadata")

    # -- no leaked tasks / threads / arenas / held acks ----------------------
    from ..ops.staging import ARENA_POOL

    try:
        tasks_now = len(asyncio.all_tasks())
    except RuntimeError:
        tasks_now = 0
    if tasks_now > leak_probe.tasks:
        r.fail(f"no-leaks: {tasks_now - leak_probe.tasks} asyncio task(s) "
               f"leaked past shutdown")
    leaked = leak_probe.leaked_workers()
    if leaked:
        r.fail(f"no-leaks: {len(leaked)} decode-pipeline worker thread(s) "
               f"leaked: {leaked}")
    if ARENA_POOL.outstanding > leak_probe.arenas_outstanding:
        r.fail(f"no-leaks: {ARENA_POOL.outstanding - leak_probe.arenas_outstanding} "
               f"staging arena(s) leased but never released")
    held = getattr(dest, "held_ack_count", None)
    if held:
        r.fail(f"no-leaks: destination still holds {held} unresolved "
               f"ack(s)")

    r.stats.update({
        "tables": len(expected),
        "lost_rows": lost,
        "duplicate_keys_over_budget": dup_rows,
        "expected_rows": sum(len(v) for v in expected.values()),
        "delivered_events": sum(
            1 for e in dest.events
            if isinstance(e, (InsertEvent, UpdateEvent, DeleteEvent))),
        "max_duplication": max_dup,
        "duplication_budget": budget,
        "restarts": len(restarts),
        "fault_firings": fault_firings,
    })
    return r


def store_has_schema(store, tid) -> bool:
    schemas = getattr(store, "_schemas", None)
    if schemas is None:
        return True  # non-memory store: not introspectable here
    return bool(schemas.get(tid))
