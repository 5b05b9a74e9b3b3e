"""External-maintenance coordination between replicator and controller.

Reference parity: crates/etl-maintenance/src/coordination.rs (the
backend-neutral ExternalMaintenanceState document and its policies) with
the Postgres/Kubernetes store impls (coordination/{postgres,kubernetes}.rs)
collapsed onto the lake catalog — the one shared, crash-safe medium both
sides already reach (WAL-mode sqlite at `<warehouse>/catalog.db`).

Protocol (coordination.rs roles):
  - the REPLICATOR samples destination state (pending inlined bytes, CDC
    file counts) and posts an *operation request* when policy thresholds
    are crossed, subject to a request cooldown; it also watches for a
    controller-owned *pause lease* and pauses its lake writes while one
    is active, reporting its paused status back;
  - the CONTROLLER (maintenance binary) polls the state, turns a pending
    request into an *active run*, takes the pause lease, waits for the
    replicator to report paused (bounded), executes the selected
    operations, records per-operation history + last_completed_at, and
    clears the lease;
  - the pause lease carries `max_pause_s` (reference
    DEFAULT_MAX_PAUSE_SECONDS): if the controller dies mid-run, the
    replicator resumes on lease expiry instead of staying paused forever.

Copy of the reference's `etl_tpu/maintenance_coordination.py`. It needs
no pyarrow: the store samples the catalog through its own sqlite
connection, and the controller drives the lake it is given. The agent's
pause and resume callbacks are the port's `MemoryMonitor.
set_external_pause` (runtime/backpressure.py). Run ids draw from the
controller's `rng` where one is given (a `random.Random` a test seeds),
else from a fresh version-4 UUID.
"""

from __future__ import annotations

import asyncio
import json
import random
import sqlite3
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path

# reference coordination.rs defaults
DEFAULT_POLL_SECONDS = 5.0
DEFAULT_INLINE_FLUSH_MIN_INLINED_BYTES = 10_000_000
DEFAULT_MERGE_MIN_CDC_FILES = 40
DEFAULT_REQUEST_COOLDOWN_SECONDS = 300.0
DEFAULT_MAX_PAUSE_SECONDS = 2700.0


@dataclass(frozen=True)
class MaintenancePolicy:
    """Thresholds + cadence (coordination.rs policy constants)."""

    poll_seconds: float = DEFAULT_POLL_SECONDS
    inline_flush_min_inlined_bytes: int = \
        DEFAULT_INLINE_FLUSH_MIN_INLINED_BYTES
    merge_min_cdc_files: int = DEFAULT_MERGE_MIN_CDC_FILES
    request_cooldown_seconds: float = DEFAULT_REQUEST_COOLDOWN_SECONDS
    max_pause_seconds: float = DEFAULT_MAX_PAUSE_SECONDS
    # operation enablement (ExternalMaintenanceOperationPolicy)
    inline_flush_enabled: bool = True
    merge_adjacent_files_enabled: bool = True
    cleanup_old_files_enabled: bool = False


@dataclass
class Operations:
    """Requested/selected operation flags
    (ExternalMaintenanceOperations)."""

    inline_flush: bool = False
    merge_adjacent_files: bool = False
    cleanup_old_files: bool = False

    @property
    def is_empty(self) -> bool:
        return not (self.inline_flush or self.merge_adjacent_files
                    or self.cleanup_old_files)


@dataclass
class MaintenanceState:
    """The shared coordination document (ExternalMaintenanceState)."""

    exists: bool = False
    # controller-owned
    active_run_id: str | None = None
    active_run_started_at: float | None = None
    active_operations: Operations = field(default_factory=Operations)
    pause_run_id: str | None = None
    pause_requested_at: float | None = None
    pause_max_pause_s: float = DEFAULT_MAX_PAUSE_SECONDS
    # replicator-owned
    request_operations: Operations = field(default_factory=Operations)
    request_at: float | None = None
    replicator_paused: bool = False
    replicator_observed_run_id: str | None = None
    replicator_reported_at: float | None = None
    # history
    last_successful: dict = field(default_factory=dict)  # op -> ts
    last_completed_at: float | None = None

    def pause_active(self, now: float | None = None) -> bool:
        """Lease check: a pause request is live until max_pause expires —
        the replicator self-resumes past that (controller crash)."""
        if self.pause_run_id is None or self.pause_requested_at is None:
            return False
        now = time.time() if now is None else now
        return now - self.pause_requested_at < self.pause_max_pause_s

    def to_json(self) -> str:
        doc = asdict(self)
        return json.dumps(doc, separators=(",", ":"))

    @classmethod
    def from_json(cls, raw: str) -> "MaintenanceState":
        doc = json.loads(raw)
        doc["active_operations"] = Operations(**doc["active_operations"])
        doc["request_operations"] = Operations(**doc["request_operations"])
        return cls(**doc)


class CatalogMaintenanceStore:
    """Coordination state in the lake catalog (the sqlite analogue of
    coordination/postgres.rs `ensure_schema` + state row per pipeline)."""

    def __init__(self, warehouse_path: str, pipeline_id: int):
        self.path = Path(warehouse_path) / "catalog.db"
        self.pipeline_id = pipeline_id
        self._db: sqlite3.Connection | None = None

    def _conn(self) -> sqlite3.Connection:
        if self._db is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # check_same_thread=False: the replicator agent runs its ticks
            # via asyncio.to_thread so catalog lock waits never stall the
            # event loop (WAL keepalives must keep flowing)
            self._db = sqlite3.connect(self.path, timeout=10.0,
                                       check_same_thread=False)
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA busy_timeout=10000")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS lake_external_maintenance ("
                "pipeline_id INTEGER PRIMARY KEY, state TEXT NOT NULL)")
            self._db.commit()
        return self._db

    def load(self) -> MaintenanceState:
        row = self._conn().execute(
            "SELECT state FROM lake_external_maintenance WHERE "
            "pipeline_id = ?", (self.pipeline_id,)).fetchone()
        if row is None:
            return MaintenanceState()
        return MaintenanceState.from_json(row[0])

    def save(self, state: MaintenanceState) -> None:
        state.exists = True
        db = self._conn()
        db.execute(
            "INSERT INTO lake_external_maintenance (pipeline_id, state) "
            "VALUES (?, ?) ON CONFLICT (pipeline_id) DO UPDATE SET "
            "state = excluded.state", (self.pipeline_id, state.to_json()))
        db.commit()

    def mutate(self, fn) -> MaintenanceState:
        """Read-modify-write under one catalog transaction (the CAS-like
        update both sides use; sqlite's write lock serializes them)."""
        db = self._conn()
        db.execute("BEGIN IMMEDIATE")
        try:
            row = db.execute(
                "SELECT state FROM lake_external_maintenance WHERE "
                "pipeline_id = ?", (self.pipeline_id,)).fetchone()
            state = MaintenanceState.from_json(row[0]) if row \
                else MaintenanceState()
            fn(state)
            state.exists = True
            db.execute(
                "INSERT INTO lake_external_maintenance (pipeline_id, "
                "state) VALUES (?, ?) ON CONFLICT (pipeline_id) DO UPDATE "
                "SET state = excluded.state",
                (self.pipeline_id, state.to_json()))
            db.commit()
        except BaseException:
            try:
                db.execute("ROLLBACK")
            except sqlite3.OperationalError:
                pass
            raise
        return state

    def delete(self) -> None:
        db = self._conn()
        db.execute("DELETE FROM lake_external_maintenance WHERE "
                   "pipeline_id = ?", (self.pipeline_id,))
        db.commit()

    # -- destination-state sampling (agent side) -------------------------------
    # The agent samples through THIS connection, not the pipeline's
    # LakeDestination: its ticks run on a worker thread, and the
    # destination's sqlite connection belongs to the event-loop thread.

    def sample_table_ids(self) -> list[int]:
        try:
            return [r[0] for r in self._conn().execute(
                "SELECT table_id FROM lake_tables").fetchall()]
        except sqlite3.OperationalError:
            return []  # lake not initialized yet

    def _current_generation(self, table_id: int) -> int | None:
        from .destinations.lake import TABLE_GENERATION_SQL

        row = self._conn().execute(TABLE_GENERATION_SQL,
                                   (table_id,)).fetchone()
        return None if row is None else row[0]

    def sample_cdc_file_count(self, table_id: int) -> int:
        from .destinations.lake import CDC_FILE_COUNT_SQL

        gen = self._current_generation(table_id)
        if gen is None:
            return 0
        return self._conn().execute(CDC_FILE_COUNT_SQL,
                                    (table_id, gen)).fetchone()[0]

    def sample_pending_inline_bytes(self, table_id: int) -> int:
        from .destinations.lake import PENDING_INLINE_BYTES_SQL

        gen = self._current_generation(table_id)
        if gen is None:
            return 0
        (n,) = self._conn().execute(PENDING_INLINE_BYTES_SQL,
                                    (table_id, gen)).fetchone()
        return int(n)

    def close(self) -> None:
        if self._db is not None:
            self._db.close()
            self._db = None


class ReplicatorMaintenanceAgent:
    """The replicator side: samples lake stats into operation requests
    and honors the controller's pause lease (coordination.rs replicator
    role). `pause`/`resume` callbacks wire into the pipeline's intake
    pause (MemoryMonitor.set_external_pause).

    The background loop runs ticks via asyncio.to_thread, so the
    callbacks MAY FIRE FROM A WORKER THREAD — wire them through
    `loop.call_soon_threadsafe` when they touch event-loop state (the
    replicator does)."""

    def __init__(self, store: CatalogMaintenanceStore,
                 policy: MaintenancePolicy = MaintenancePolicy(),
                 pause=None, resume=None):
        self.store = store
        self.policy = policy
        self._pause_cb = pause or (lambda: None)
        self._resume_cb = resume or (lambda: None)
        self.paused = False
        self._task: asyncio.Task | None = None

    def sample_operations(self) -> Operations:
        """Destination-state sampling → requested operation flags. Reads
        ride the store's own (thread-safe) catalog connection — the
        pipeline's LakeDestination connection belongs to the loop
        thread."""
        ops = Operations()
        p = self.policy
        for tid in self.store.sample_table_ids():
            if (p.inline_flush_enabled and
                    self.store.sample_pending_inline_bytes(tid)
                    >= p.inline_flush_min_inlined_bytes):
                ops.inline_flush = True
            if (p.merge_adjacent_files_enabled and
                    self.store.sample_cdc_file_count(tid)
                    >= p.merge_min_cdc_files):
                ops.merge_adjacent_files = True
        return ops

    def tick(self, now: float | None = None) -> MaintenanceState:
        """One coordination step; returns the state after the step."""
        now = time.time() if now is None else now
        ops = self.sample_operations()

        def step(state: MaintenanceState) -> None:
            # publish the CURRENT sampled need, subject to the cooldown —
            # including clearing a stale request whose need has since
            # vanished (e.g. the lake's own flush threshold fired first),
            # so the controller never pauses the pipeline for nothing
            cooled = (state.request_at is None or
                      now - state.request_at
                      >= self.policy.request_cooldown_seconds)
            if cooled and state.request_operations != ops:
                state.request_operations = ops
                state.request_at = now
            # honor (or release) the pause lease
            want_paused = state.pause_active(now)
            if want_paused and not self.paused:
                self._pause_cb()
                self.paused = True
            elif not want_paused and self.paused:
                self._resume_cb()
                self.paused = False
            state.replicator_paused = self.paused
            state.replicator_observed_run_id = state.pause_run_id
            state.replicator_reported_at = now

        return self.store.mutate(step)

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        while True:
            try:
                # to_thread: a tick can wait up to busy_timeout on the
                # catalog write lock (e.g. mid-compaction); that wait must
                # never stall the event loop carrying WAL keepalives
                await asyncio.to_thread(self.tick)
            except Exception:  # coordination must never kill replication
                import logging

                logging.getLogger("etl_tpu_torch.maintenance").exception(
                    "maintenance coordination tick failed")
            await asyncio.sleep(self.policy.poll_seconds)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self.paused:
            self._resume_cb()
            self.paused = False

    def clear_status(self) -> None:
        def step(state: MaintenanceState) -> None:
            state.replicator_paused = False
            state.replicator_observed_run_id = None
            state.replicator_reported_at = None

        self.store.mutate(step)


class MaintenanceController:
    """The controller side (the maintenance binary's coordination role):
    request → active run → pause lease → execute → history."""

    def __init__(self, store: CatalogMaintenanceStore, lake,
                 policy: MaintenancePolicy = MaintenancePolicy(),
                 rng: "random.Random | None" = None):
        self.store = store
        self.lake = lake
        self.policy = policy
        self._rng = rng

    def _conditions_still_hold(self, op: str) -> bool:
        """Re-sample the destination before acting: a stale request whose
        need has since vanished (e.g. the lake auto-flushed) must not
        pause the pipeline for nothing."""
        p = self.policy
        if op == "inline_flush":
            return any(self.lake.pending_inline_bytes(t) > 0
                       for t in self.lake.table_ids())
        if op == "merge_adjacent_files":
            return any(self.lake.current_cdc_file_count(t)
                       >= p.merge_min_cdc_files
                       for t in self.lake.table_ids())
        return True

    def _select_operations(self, state: MaintenanceState,
                           now: float) -> Operations:
        """Requested + re-validated + per-operation success cooldown
        (reference DEFAULT_REQUEST_COOLDOWN_SECONDS applied to history).
        cleanup_old_files is OPERATOR-driven (policy enablement, the
        --vacuum flag) rather than replicator-sampled."""
        req = state.request_operations
        sel = Operations()
        cd = self.policy.request_cooldown_seconds

        def cooled(op: str) -> bool:
            last = state.last_successful.get(op)
            return last is None or now - last >= cd

        sel.inline_flush = (req.inline_flush and cooled("inline_flush")
                            and self._conditions_still_hold("inline_flush"))
        sel.merge_adjacent_files = (
            req.merge_adjacent_files and cooled("merge_adjacent_files")
            and self._conditions_still_hold("merge_adjacent_files"))
        sel.cleanup_old_files = (
            (req.cleanup_old_files
             or self.policy.cleanup_old_files_enabled)
            and cooled("cleanup_old_files"))
        return sel

    async def run_once(self, *, wait_for_pause_s: float = 30.0,
                       now: float | None = None) -> dict:
        """One controller pass. Returns a report dict (the binary prints
        it as JSON)."""
        now = time.time() if now is None else now
        from .destinations.util import new_uuid4

        run_id = new_uuid4(self._rng).hex[:12]
        selected = Operations()
        outcome: dict = {}

        def take(state: MaintenanceState) -> None:
            # check-and-take inside ONE catalog transaction: two
            # overlapping cron-launched controllers must not both take the
            # lease and clobber each other's run
            if state.active_run_id is not None and state.pause_active(now):
                outcome["skipped"] = "run already active"
                outcome["run_id"] = state.active_run_id
                return
            sel = self._select_operations(state, now)
            if sel.is_empty:
                outcome["skipped"] = ("no operations requested or all "
                                      "cooling down")
                # consume ONLY flags whose conditions no longer hold (a
                # merely-cooling-down request stays pending)
                req = state.request_operations
                state.request_operations = Operations(
                    inline_flush=req.inline_flush
                    and self._conditions_still_hold("inline_flush"),
                    merge_adjacent_files=req.merge_adjacent_files
                    and self._conditions_still_hold(
                        "merge_adjacent_files"),
                    cleanup_old_files=req.cleanup_old_files)
                return
            selected.inline_flush = sel.inline_flush
            selected.merge_adjacent_files = sel.merge_adjacent_files
            selected.cleanup_old_files = sel.cleanup_old_files
            state.active_run_id = run_id
            state.active_run_started_at = now
            state.active_operations = sel
            state.pause_run_id = run_id
            state.pause_requested_at = now
            state.pause_max_pause_s = self.policy.max_pause_seconds

        self.store.mutate(take)
        if "skipped" in outcome:
            return outcome
        # wait (bounded) for the replicator to observe the lease and
        # report paused; proceeding without it is still SAFE — the lake
        # catalog's per-table maintenance flag serializes writers — but
        # pausing first avoids compaction/writer catalog contention
        deadline = time.monotonic() + wait_for_pause_s
        replicator_paused = False
        while time.monotonic() < deadline:
            st = self.store.load()
            if st.replicator_paused and \
                    st.replicator_observed_run_id == run_id:
                replicator_paused = True
                break
            await asyncio.sleep(min(0.05, self.policy.poll_seconds))
        report: dict = {"run_id": run_id,
                        "replicator_paused": replicator_paused,
                        "operations": {}}
        succeeded: list[str] = []
        try:
            if selected.inline_flush:
                n = 0
                for tid in self.lake.table_ids():
                    n += await self.lake.flush_inlined(tid)
                report["operations"]["inline_flush"] = n
                succeeded.append("inline_flush")
            if selected.merge_adjacent_files:
                n = 0
                for tid in self.lake.table_ids():
                    n += await self.lake.compact(tid)
                report["operations"]["merge_adjacent_files"] = n
                succeeded.append("merge_adjacent_files")
            if selected.cleanup_old_files:
                n = 0
                for tid in self.lake.table_ids():
                    n += await self.lake.vacuum(tid)
                report["operations"]["cleanup_old_files"] = n
                succeeded.append("cleanup_old_files")
        finally:
            done_at = time.time()

            def finish(state: MaintenanceState) -> None:
                for op in succeeded:
                    state.last_successful[op] = done_at
                state.last_completed_at = done_at
                if state.active_run_id == run_id:
                    # only the lease owner clears it — an expired lease
                    # may have been re-taken by another controller whose
                    # live run must not be resumed from under it
                    state.active_run_id = None
                    state.active_run_started_at = None
                    state.active_operations = Operations()
                    state.pause_run_id = None
                    state.pause_requested_at = None
                # a satisfied request is consumed; a partial failure
                # leaves the remaining flags for the next pass
                state.request_operations = Operations(
                    inline_flush=state.request_operations.inline_flush
                    and "inline_flush" not in succeeded,
                    merge_adjacent_files=
                        state.request_operations.merge_adjacent_files
                        and "merge_adjacent_files" not in succeeded,
                    cleanup_old_files=
                        state.request_operations.cleanup_old_files
                        and "cleanup_old_files" not in succeeded)

            self.store.mutate(finish)
        return report
