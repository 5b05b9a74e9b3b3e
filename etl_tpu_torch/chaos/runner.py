"""Scenario runner: arm faults, drive the workload, crash, restart,
verify.

One `run_scenario(scenario, seed)` call:

  1. seeds `random.Random(seed)` — the ONLY randomness source — and
     builds the fake walsender database, a recording store, and a
     tracing MemoryDestination behind the fault-injecting wrapper;
  2. arms every `FaultSpec` (failpoint errors, hard crashes, scripted
     destination faults, wire severs) and records each firing into the
     per-site injection trace;
  3. runs the workload: initial copy → CDC transactions → drain. A
     CRASH firing hard-kills the pipeline (every task cancelled, no
     drain — process-death semantics) and restarts a fresh `Pipeline`
     from the same store/destination, resuming the remaining workload;
  4. checks the recovery invariants (chaos/invariants.py) and reports
     chaos metrics (telemetry/metrics.py).

Same (scenario, seed) → same workload bytes and same injection trace:
the run is replayable from the CLI (`python -m etl_tpu_torch.chaos`).

Copy of the reference's `etl_tpu/chaos/runner.py`, on the port's pipeline:
`BatchEngine.CUDA` decodes through the kernels on `device` ("cuda", the
card, unless the caller asks for "cpu", where the kernels' plain versions
run). The program-cache scenarios run on the port's program store
(ops/program_store.py): a private cache directory seeded with the
libraries a restarted process would inherit (copied out of the default
store, so no build), the in-process library state dropped at each hard
restart, and for the corrupt variant every cache file replaced by
garbage before the restart, which then pays the real rebuild. One
departure: the port has no per-batch device-OOM fallback: an
`engine.device_oom` firing fails its batch, and the worker re-streams it
like any other failed batch, so the firing funds the duplication budget
instead of being exempt from it.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import random
import shutil
import tempfile
import time
from dataclasses import dataclass, field

from ..config import (BatchConfig, BatchEngine, PipelineConfig, RetryConfig,
                      SupervisionConfig)
from ..destinations import (FaultAction, FaultInjectingDestination, FaultKind
                            as DestFaultKind, MemoryDestination)
from ..models import ColumnSchema, Oid, TableName, TableSchema
from ..models.lsn import Lsn
from ..models.errors import EtlError
from ..models.table_state import TableStateType
from ..postgres.fake import FakeDatabase, FakeSource
from ..postgres.slots import apply_slot_name
from ..store import NotifyingStore
from ..telemetry.metrics import (ETL_CHAOS_INJECTED_FAULTS_TOTAL,
                                 ETL_CHAOS_RECOVERY_DURATION_SECONDS,
                                 ETL_CHAOS_SCENARIOS_TOTAL, registry)
from . import failpoints
from .invariants import (InvariantReport, LeakProbe, check_invariants,
                         view_matches)
from .scenario import FaultKind, FaultSpec, Scenario

BASE_TABLE_ID = 16384
_DEST_OPS = ("write_events", "write_table_rows", "truncate_table",
             "drop_table")


@contextlib.contextmanager
def device_floor(rows: "int | None"):
    """Route every batch of at least `rows` rows to the kernels while the
    block runs: decoders built inside take `rows` as their threshold in
    place of the measured one (None keeps the decoder's own routing).
    The corpus's transactions are a few rows each, so most of its batches
    would otherwise take the host route or the oracle and never reach the
    card; `chip_smoke.py` phase 14 and the CLI's `--device-floor` lower
    it to hold the kernels to every fault. Routing only: the same rows
    decode, to the same values."""
    from ..ops.engine import DeviceDecoder

    if rows is None:
        yield
        return
    before = DeviceDecoder.PINNED_MIN_ROWS
    DeviceDecoder.PINNED_MIN_ROWS = rows
    try:
        yield
    finally:
        DeviceDecoder.PINNED_MIN_ROWS = before


# -- program-cache restart scenarios ------------------------------------------

#: row buckets prewarmed for the program-cache scenarios (every bucket the
#: scenarios' flushes can stage into: txs × rows_per_tx stays under 4096)
_PC_PREWARM_BUCKETS = (256, 1024, 4096)
#: added to a program-cache scenario's time budget: the corrupt variant's
#: restart rebuilds every library for real (decode_pack.cu alone takes
#: 40-70 s of nvcc on an H100's host)
_PC_BUILD_BUDGET_S = 240.0


def _clear_program_memory_caches() -> None:
    """Process-death semantics for the program state a real crash frees
    with the process: the loaded libraries, the descriptors on the device,
    K2c's status buffers and the store's memory layer. The program-cache
    scenarios clear these after seeding and at every hard restart, so the
    restarted pipeline can only be warm through the disk layer."""
    from .. import native
    from ..ops import decode_kernel, egress_kernel, program_store

    for mod in (decode_kernel, egress_kernel, native):
        mod._lib = None
    with decode_kernel._lock:
        decode_kernel._desc_cache.clear()
        decode_kernel._pred_cache.clear()
        decode_kernel._scan_states.clear()
    with egress_kernel._lock:
        egress_kernel._desc_cache.clear()
    program_store.forget_memory()


def _corrupt_program_cache(cache_dir: str) -> None:
    """Replace every file of the cache by garbage (the power-loss /
    torn-disk case the degrade contract covers), through tmp + rename: a
    library this process still maps is never written into."""
    for root, _dirs, files in os.walk(cache_dir):
        for f in files:
            path = os.path.join(root, f)
            with open(path + ".garbage", "wb") as fh:
                fh.write(b"not a shared library")
            os.replace(path + ".garbage", path)


def _program_cache_counters() -> dict:
    from ..telemetry.metrics import (ETL_COMPILE_CACHE_HITS_TOTAL,
                                     ETL_COMPILE_CACHE_MISSES_TOTAL,
                                     ETL_PROGRAMS_COMPILED_TOTAL)

    return {
        "compiled": registry.get_counter(ETL_PROGRAMS_COMPILED_TOTAL),
        "disk_hits": registry.get_counter(ETL_COMPILE_CACHE_HITS_TOTAL,
                                          {"layer": "disk"}),
        "invalid": registry.get_counter(ETL_COMPILE_CACHE_MISSES_TOTAL,
                                        {"reason": "invalid"}),
    }


def _check_program_cache(scenario: Scenario, run: "ChaosRun", base: dict,
                         restart_base: "dict | None") -> None:
    """The program-cache scenarios' own checks, on the store's counters
    since seeding (`base`) and since the last restart (`restart_base`)."""
    now = _program_cache_counters()
    run.program_cache = {k: now[k] - base[k] for k in now}
    if scenario.program_cache == "warm":
        if run.program_cache["compiled"] != 0:
            run.report.fail(
                f"warm program cache: {run.program_cache['compiled']:g} "
                "builds after seeding — the restart did not load its "
                "libraries from the cache")
        if restart_base is not None \
                and now["disk_hits"] <= restart_base["disk_hits"]:
            run.report.fail("warm program cache: the restarted pipeline "
                            "never loaded a library from disk")
        return
    if now["invalid"] <= base["invalid"]:
        run.report.fail("corrupt program cache: no invalid miss recorded "
                        "— the corrupted files were never probed (the "
                        "degrade path did not run)")
    if restart_base is not None \
            and now["compiled"] <= restart_base["compiled"]:
        run.report.fail("corrupt program cache: the restart rebuilt "
                        "nothing")


class SimulatedCrash(Exception):
    """Raised at a CRASH site; the watcher hard-kills the pipeline before
    any in-process retry can proceed."""


class RecordingStore(NotifyingStore):
    """NotifyingStore that records the stored durable-progress trajectory
    per key (the monotonic-lsn invariant's evidence)."""

    def __init__(self) -> None:
        super().__init__()
        self.progress_log: dict[str, list[Lsn]] = {}

    async def update_durable_progress(self, key, lsn) -> bool:
        stored = await super().update_durable_progress(key, lsn)
        if stored:
            self.progress_log.setdefault(key, []).append(lsn)
        return stored


class TracingDestination(MemoryDestination):
    """MemoryDestination that remembers WHERE in the event timeline each
    destination drop happened, so the invariant checker can exclude
    events of abandoned (dropped-and-recopied) copy attempts."""

    def __init__(self) -> None:
        super().__init__()
        self.drop_seq_by_table: dict = {}
        self.held_ack_count = 0  # set by the runner after shutdown

    async def drop_table(self, table_id, schema=None) -> None:
        self.drop_seq_by_table[table_id] = len(self.events)
        await super().drop_table(table_id, schema)


@dataclass
class RestartRecord:
    kind: str  # "crash" | "clean"
    resume_lsn: int
    at_tx: int
    recovery_s: float = 0.0

    def describe(self) -> dict:
        return {"kind": self.kind, "resume_lsn": self.resume_lsn,
                "at_tx": self.at_tx,
                "recovery_s": round(self.recovery_s, 4)}


@dataclass
class ChaosRun:
    scenario: Scenario
    seed: int
    trace: dict[str, list[dict]] = field(default_factory=dict)
    restarts: list[RestartRecord] = field(default_factory=list)
    report: InvariantReport = field(default_factory=InvariantReport)
    fault_firings: int = 0  # every injection, for the trace
    # only firings that can cause re-delivery (worker retry re-streams):
    # the bounded-dup budget — OOM fallbacks, HOLDs, and crashes (already
    # counted via restarts) must NOT loosen the exactly-once assertion
    redelivery_firings: int = 0
    # supervision: health-state transitions observed across every
    # pipeline incarnation, and watchdog cancel-and-restart escalations
    # (each one re-streams a window, so each adds to the dup budget)
    health_track: list[str] = field(default_factory=list)
    supervision_restarts: int = 0
    duration_s: float = 0.0
    # program-cache scenarios: the store's counter deltas since seeding
    # (builds, disk hits, invalid misses)
    program_cache: dict | None = None

    @property
    def ok(self) -> bool:
        return self.report.ok

    def describe(self) -> dict:
        return {
            "scenario": self.scenario.name,
            "workload": self.scenario.workload or "default",
            "seed": self.seed,
            "ok": self.ok,
            "trace": {site: list(fires)
                      for site, fires in sorted(self.trace.items())},
            "restarts": [r.describe() for r in self.restarts],
            "fault_firings": self.fault_firings,
            "redelivery_firings": self.redelivery_firings,
            "health_track": list(self.health_track),
            "supervision_restarts": self.supervision_restarts,
            "invariants": self.report.describe(),
            "duration_s": round(self.duration_s, 3),
            **({"program_cache": dict(self.program_cache)}
               if self.program_cache is not None else {}),
        }


def _make_workload(scenario: Scenario, rng: random.Random):
    """The scenario's traffic source: a named workload profile
    (workloads/ — update/delete/TOAST/truncate/DDL/partitioned
    shapes) when `scenario.workload` is set, else the default mixed-insert
    workload below. Both expose the same interface (build_db / run_tx /
    table_ids / expected / tx_index / delivered) and draw from the
    scenario's single seeded RNG, so the injection interleaving replays
    bit-identically either way."""
    if scenario.workload:
        from ..workloads import make_chaos_workload

        return make_chaos_workload(scenario.workload, rng)
    return _Workload(scenario, rng)


class _Workload:
    """Deterministic workload state: per-table expected rows + next pk."""

    def __init__(self, scenario: Scenario, rng: random.Random):
        self.scenario = scenario
        self.rng = rng
        self.table_ids = [BASE_TABLE_ID + i for i in range(scenario.tables)]
        self.expected: dict[int, dict[int, tuple]] = \
            {tid: {} for tid in self.table_ids}
        self._next_pk: dict[int, int] = {tid: 1 for tid in self.table_ids}
        self.tx_index = 0

    def build_db(self) -> FakeDatabase:
        db = FakeDatabase()
        for i, tid in enumerate(self.table_ids):
            rows = []
            for _ in range(self.scenario.rows_per_table):
                pk = self._next_pk[tid]
                self._next_pk[tid] += 1
                v = self.rng.randrange(0, 1000)
                note = f"seed-{self.rng.randrange(10**6)}"
                rows.append([str(pk), str(v), note])
                self.expected[tid][pk] = (pk, v, note)
            db.create_table(TableSchema(
                tid, TableName("public", f"chaos_t{i}"),
                (ColumnSchema("id", Oid.INT8, nullable=False,
                              primary_key_ordinal=1),
                 ColumnSchema("v", Oid.INT4),
                 ColumnSchema("note", Oid.TEXT))), rows=rows)
        db.create_publication("pub", list(self.table_ids))
        return db

    async def run_tx(self, db: FakeDatabase) -> None:
        """One CDC transaction: inserts, sometimes an update or delete."""
        rng = self.rng
        tid = self.table_ids[rng.randrange(len(self.table_ids))]
        exp = self.expected[tid]
        async with db.transaction() as tx:
            for _ in range(self.scenario.rows_per_tx):
                roll = rng.random()
                existing = sorted(exp)
                if roll < 0.15 and existing:  # delete
                    pk = existing[rng.randrange(len(existing))]
                    tx.delete(tid, [str(pk), None, None])
                    del exp[pk]
                elif roll < 0.40 and existing:  # update
                    pk = existing[rng.randrange(len(existing))]
                    v = rng.randrange(0, 1000)
                    note = f"upd-{rng.randrange(10**6)}"
                    tx.update(tid, [str(pk), None, None],
                              [str(pk), str(v), note])
                    exp[pk] = (pk, v, note)
                else:  # insert
                    pk = self._next_pk[tid]
                    self._next_pk[tid] += 1
                    v = rng.randrange(0, 1000)
                    note = f"ins-{rng.randrange(10**6)}"
                    tx.insert(tid, [str(pk), str(v), note])
                    exp[pk] = (pk, v, note)
        self.tx_index += 1

    def delivered(self, dest: TracingDestination) -> bool:
        return view_matches(dest, self.table_ids, self.expected)


class _CrashState:
    """Crash flag settable from ANY thread: failpoint sites on the decode
    pipeline's worker thread (pipeline.*) trip it via
    call_soon_threadsafe, sites on the event loop set it directly."""

    def __init__(self) -> None:
        self.event = asyncio.Event()
        self._loop = asyncio.get_running_loop()

    def trip(self) -> None:
        try:
            on_loop = asyncio.get_running_loop() is self._loop
        except RuntimeError:
            on_loop = False
        if on_loop:
            self.event.set()
        else:
            self._loop.call_soon_threadsafe(self.event.set)


async def _race_crash(crash: _CrashState, coro) -> None:
    """Run `coro` unless/until the crash trips; on crash, cancel it and
    raise SimulatedCrash to the caller's restart loop."""
    task = asyncio.ensure_future(coro)
    crash_task = asyncio.ensure_future(crash.event.wait())
    try:
        done, _ = await asyncio.wait({task, crash_task},
                                     return_when=asyncio.FIRST_COMPLETED)
        if crash_task in done and crash.event.is_set():
            if task.done():
                # both finished in the same round: retrieve the task's
                # outcome so a real failure is not silently dropped as
                # "exception was never retrieved" noise
                task.exception()
            raise SimulatedCrash()
        return task.result()
    finally:
        for t in (task, crash_task):
            if not t.done():
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass  # cancel-then-drain of our own helper tasks


async def _hard_kill(pipeline) -> None:
    """Process-death semantics: cancel every pipeline task with no drain
    and no destination shutdown. In-process resources that a real crash
    would free with the process (decode-pipeline threads, the memory
    monitor's sampler, the supervision sweep) are closed via the tasks'
    finally blocks."""
    if pipeline.supervisor is not None:
        await pipeline.supervisor.stop()
    tasks = []
    if pipeline._apply_task is not None:
        tasks.append(pipeline._apply_task)
    pool = pipeline.pool
    if pool is not None:
        tasks += [h.task for h in pool._workers.values()
                  if h.task is not None]
        tasks += list(pool._retry_tasks.values())
        pool._retry_tasks.clear()
    for t in tasks:
        if not t.done():
            t.cancel()
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)
    if pipeline.memory_monitor is not None:
        await pipeline.memory_monitor.stop()


async def _wait_until(predicate, timeout: float, what: str,
                      interval: float = 0.02) -> None:
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() >= deadline:
            raise TimeoutError(what)
        await asyncio.sleep(interval)


async def run_scenario(scenario: Scenario, seed: int,
                       timeout_s: float = 60.0,
                       device: str = "cuda") -> ChaosRun:
    """Run one scenario to completion and verify invariants. Always
    disarms every failpoint on the way out. `device` is where the CUDA
    engine's decoders run. A program-cache scenario's budget grows by
    `_PC_BUILD_BUDGET_S` for its real rebuild."""
    if scenario.program_cache:
        timeout_s += _PC_BUILD_BUDGET_S
    failpoints.disarm_all()
    run = ChaosRun(scenario=scenario, seed=seed)
    t_start = time.monotonic()
    try:
        await asyncio.wait_for(
            _run_scenario_inner(scenario, seed, run, device), timeout_s)
    except (TimeoutError, asyncio.TimeoutError) as e:
        run.report.fail(f"scenario did not complete: {e or 'timeout'}")
    except Exception as e:
        # an unexpected error is a FAILED run, not a pass with an empty
        # report — the metrics and run.ok must say so
        run.report.fail(f"scenario crashed: {e!r}")
    finally:
        failpoints.disarm_all()
        run.duration_s = time.monotonic() - t_start
        registry.counter_inc(
            ETL_CHAOS_SCENARIOS_TOTAL,
            labels={"result": "pass" if run.ok else "fail"})
    return run


async def _run_scenario_inner(scenario: Scenario, seed: int,
                              run: ChaosRun, device: str) -> None:
    rng = random.Random(seed)
    leak_probe = LeakProbe.capture()
    workload = _make_workload(scenario, rng)
    db = workload.build_db()
    pc_dir = pc_base = pc_restart_base = None
    if scenario.program_cache:
        # a private cache dir seeded with the verified libraries out of
        # the default store (what a restarted process on a shared dir
        # inherits, without a build), then the in-process state made to
        # look like a fresh process: from here on, warmth can only come
        # from disk
        from ..ops import program_store

        pc_dir = tempfile.mkdtemp(prefix="etl-chaos-progcache-")
        for lib in program_store.libraries(device):
            await asyncio.to_thread(program_store.export_entry, lib, pc_dir)
        program_store.configure(pc_dir)
        _clear_program_memory_caches()
        pc_base = _program_cache_counters()
    store = RecordingStore()
    inner = TracingDestination()
    dest = FaultInjectingDestination(inner)
    crash = _CrashState()
    held_releases: list[tuple[asyncio.Event, int | None]] = []

    def record_fire(spec: FaultSpec, action: str) -> None:
        fires = run.trace.setdefault(spec.site, [])
        fires.append({"fire": len(fires) + 1, "action": action,
                      "error_kind": spec.error_kind.name})
        run.fault_firings += 1
        if spec.kind in (FaultKind.ERROR, FaultKind.DEST_REJECT,
                         FaultKind.DEST_FAIL_AFTER_APPLY, FaultKind.SEVER):
            # faults the worker recovers from by re-streaming (on the
            # port a device-OOM firing too: it fails its batch, there is
            # no oracle fallback); crashes are accounted via restarts,
            # HOLDs never re-deliver. STALL firings fund NOTHING here — a
            # stall causes re-delivery only through its recovery mechanism,
            # and both mechanisms are counted where they fire (a
            # supervision restart via on_supervision_event, a
            # destination-op timeout via the counter delta at the end) —
            # funding the firing too would double the budget and loosen
            # the exactly-once assertion.
            run.redelivery_firings += 1
        registry.counter_inc(ETL_CHAOS_INJECTED_FAULTS_TOTAL,
                             labels={"site": spec.site})

    def arm_failpoint(spec: FaultSpec) -> None:
        state = {"hits": 0, "fired": 0}

        def action() -> None:
            state["hits"] += 1
            if state["hits"] <= spec.after_hits \
                    or state["fired"] >= spec.times:
                return
            state["fired"] += 1
            if spec.kind is FaultKind.CRASH:
                record_fire(spec, "crash")
                crash.trip()
                raise SimulatedCrash(f"simulated crash at {spec.site}")
            record_fire(spec, "error")
            raise EtlError(spec.error_kind,
                           f"chaos injection at {spec.site}")

        failpoints.arm(spec.site, action)

    # firings are recorded when the wrapper actually CONSUMES a scripted
    # fault, not at scripting time — the trace must never claim an
    # injection that didn't happen, and the bounded-dup budget must not
    # be inflated by scripts the workload never reached. The per-op spec
    # FIFO mirrors the wrapper's own FIFO action queue exactly.
    scripted_specs: dict[str, list[FaultSpec]] = {}
    _orig_next_fault = dest._next_fault

    def _observing_next_fault(op: str):
        fault = _orig_next_fault(op)
        if fault is not None:
            pending = scripted_specs.get(op)
            if pending:
                spec = pending.pop(0)
                record_fire(spec, spec.kind.value)
        return fault

    dest._next_fault = _observing_next_fault

    def script_dest_fault(spec: FaultSpec) -> None:
        if spec.kind is FaultKind.DEST_REJECT:
            kind = DestFaultKind.REJECT
        elif spec.kind is FaultKind.DEST_FAIL_AFTER_APPLY:
            kind = DestFaultKind.FAIL_AFTER_APPLY
        else:
            kind = DestFaultKind.HOLD
        for _ in range(spec.times):
            if kind is DestFaultKind.HOLD:
                release = asyncio.Event()
                held_releases.append((release, spec.hold_release_after_tx))
                dest.script(spec.site, FaultAction(kind,
                                                   release_event=release))
            else:
                dest.script(spec.site, FaultAction(kind))
            scripted_specs.setdefault(spec.site, []).append(spec)

    def arm_stall_spec(spec: FaultSpec) -> None:
        failpoints.arm_stall(
            spec.site, duration_s=spec.stall_s, times=spec.times,
            after_hits=spec.after_hits,
            on_fire=lambda spec=spec: record_fire(spec, "stall"))

    # arm everything without a tx trigger now; tx-triggered specs arm in
    # the workload loop below
    deferred: list[FaultSpec] = []
    for spec in scenario.faults:
        if spec.kind in (FaultKind.ERROR, FaultKind.CRASH):
            arm_failpoint(spec)
        elif spec.kind is FaultKind.STALL:
            arm_stall_spec(spec)
        elif spec.at_tx is None:
            if spec.kind is FaultKind.SEVER:
                deferred.append(spec)  # severing needs open streams
            else:
                script_dest_fault(spec)
        else:
            deferred.append(spec)

    copy_started = asyncio.Event()
    if scenario.tx_during_copy:
        # non-destructive observer on the during-copy site (scenarios
        # combining tx_during_copy with a fault at that same site would
        # clobber each other's arming — none do)
        failpoints.arm(failpoints.DURING_COPY, copy_started.set)

    if scenario.fast_watchdog:
        # stall scenarios: sweeps every 50 ms, sub-second stall deadline,
        # ~2 s hang deadline — detection + recovery must land inside the
        # scenario budget. wal_sender 1 s keeps an idle apply loop
        # beating every 600 ms, safely under the hang deadline.
        # stall deadline must clear a legitimately slow first fetch (the
        # first launch on the card, a loaded CPU) or it reads as a stall
        sup_cfg = SupervisionConfig(
            check_interval_s=0.05, stall_deadline_s=1.3,
            hang_deadline_s=2.2, restart_backoff_s=0.3,
            device_degrade_threshold=3, device_degrade_cooldown_s=1.0,
            breaker_failure_threshold=5, breaker_cooldown_s=0.4)
        dest_timeout_s = 1.5
        wal_sender_ms = 1_000
    else:
        # fault scenarios: supervision stays LIVE (its false-positive
        # rate under normal recovery churn is itself under test) but the
        # deadlines sit far above any legitimate pause in these runs
        sup_cfg = SupervisionConfig(
            check_interval_s=0.25, stall_deadline_s=10.0,
            hang_deadline_s=25.0, restart_backoff_s=1.0)
        dest_timeout_s = 30.0
        wal_sender_ms = 60_000
    config = PipelineConfig(
        pipeline_id=1, publication_name="pub",
        batch=BatchConfig(max_size_bytes=64 * 1024, max_fill_ms=25,
                          batch_engine=BatchEngine(scenario.engine),
                          device=device,
                          # program-cache scenarios: each (re)started
                          # pipeline prewarms from the private dir
                          program_cache_dir=pc_dir,
                          prewarm_row_buckets=_PC_PREWARM_BUCKETS
                          if pc_dir else None),
        apply_retry=RetryConfig(max_attempts=10, initial_delay_ms=15,
                                max_delay_ms=120),
        table_retry=RetryConfig(max_attempts=10, initial_delay_ms=15,
                                max_delay_ms=120),
        supervision=sup_cfg,
        destination_op_timeout_s=dest_timeout_s,
        wal_sender_timeout_ms=wal_sender_ms,
        lag_sample_interval_s=0)

    def on_supervision_event(ev) -> None:
        if ev.kind not in ("restart", "degrade", "breaker"):
            return  # stall/hang detections precede a restart — count once
        fires = run.trace.setdefault(f"supervision.{ev.kind}", [])
        fires.append({"fire": len(fires) + 1, "component": ev.component})
        if ev.kind == "restart":
            # a cancel-and-restart re-streams the cancelled window: it
            # funds the bounded-dup budget exactly like a worker retry
            run.supervision_restarts += 1
            run.redelivery_firings += 1

    def make_pipeline():
        from ..runtime import Pipeline

        p = Pipeline(config=config, store=store, destination=dest,
                     source_factory=lambda: FakeSource(db))
        if p.supervisor is not None:
            p.supervisor.add_listener(on_supervision_event)
            p.supervisor.health.add_listener(
                lambda old, new, why: run.health_track.append(new.value))
        return p

    async def release_due_holds(tx_index: int | None) -> None:
        for release, due in list(held_releases):
            if due is None or tx_index is None or tx_index >= due:
                release.set()
                held_releases.remove((release, due))
                await asyncio.sleep(0)  # let the release task run

    async def drive() -> None:
        """The workload phases; raises SimulatedCrash when a crash site
        fires and the caller restarts."""
        if scenario.tx_during_copy and workload.tx_index == 0:
            await _race_crash(crash, copy_started.wait())
            await _race_crash(crash, workload.run_tx(db))
        await _race_crash(crash, _wait_until(
            lambda: all(
                (st := store._states.get(tid)) is not None
                and st.type is TableStateType.READY
                for tid in workload.table_ids), 30.0, "tables never ready"))
        while workload.tx_index < scenario.txs:
            for spec in list(deferred):
                if (spec.at_tx or 0) <= workload.tx_index:
                    deferred.remove(spec)
                    if spec.kind is FaultKind.SEVER:
                        record_fire(spec, "sever")
                        await db.sever_streams()
                    else:
                        script_dest_fault(spec)
            await _race_crash(crash, workload.run_tx(db))
            await release_due_holds(workload.tx_index)
        await release_due_holds(None)
        await _race_crash(crash, _wait_until(
            lambda: workload.delivered(inner), 30.0,
            "workload never fully delivered"))

    def _dest_timeouts_total() -> float:
        from ..telemetry.metrics import (ETL_DESTINATION_OP_TIMEOUTS_TOTAL,
                                         registry)

        return sum(registry.get_counter(ETL_DESTINATION_OP_TIMEOUTS_TOTAL,
                                        {"op": op})
                   for op in ("startup", "write_events", "write_table_rows",
                              "drop_table", "truncate_table", "flush"))

    timeouts_before = _dest_timeouts_total()
    pipeline = make_pipeline()
    try:
        await pipeline.start()
        max_restarts = scenario.expect_restarts + 2
        t_phase = time.monotonic()
        while True:
            try:
                await drive()
                break
            except SimulatedCrash:
                crash.event.clear()
                await _hard_kill(pipeline)
                if scenario.program_cache:
                    # a real crash loses the loaded libraries with the
                    # process; the corrupt variant also trashes the disk
                    # layer, so the restart takes the degrade path
                    _clear_program_memory_caches()
                    if scenario.program_cache == "corrupt":
                        await asyncio.to_thread(_corrupt_program_cache,
                                                pc_dir)
                    pc_restart_base = _program_cache_counters()
                resume = await store.get_durable_progress(
                    apply_slot_name(1))
                rec = RestartRecord(kind="crash",
                                    resume_lsn=int(resume or Lsn.ZERO),
                                    at_tx=workload.tx_index)
                run.restarts.append(rec)
                if len(run.restarts) > max_restarts:
                    run.report.fail(
                        f"crash loop: {len(run.restarts)} restarts "
                        f"exceeded the scenario budget {max_restarts}")
                    return
                t_phase = time.monotonic()
                pipeline = make_pipeline()
                await pipeline.start()
        if run.restarts:
            recovery = time.monotonic() - t_phase
            run.restarts[-1].recovery_s = recovery
            registry.histogram_observe(
                ETL_CHAOS_RECOVERY_DURATION_SECONDS, recovery)

        if scenario.clean_restart:
            await pipeline.shutdown_and_wait()
            resume = await store.get_durable_progress(apply_slot_name(1))
            run.restarts.append(RestartRecord(
                kind="clean", resume_lsn=int(resume or Lsn.ZERO),
                at_tx=workload.tx_index))
            t_phase = time.monotonic()
            pipeline = make_pipeline()
            await pipeline.start()
            end = workload.tx_index + scenario.txs_after_restart
            while workload.tx_index < end:
                await _race_crash(crash, workload.run_tx(db))
            await _race_crash(crash, _wait_until(
                lambda: workload.delivered(inner), 30.0,
                "post-restart workload never delivered"))
            run.restarts[-1].recovery_s = time.monotonic() - t_phase

        if scenario.program_cache:
            _check_program_cache(scenario, run, pc_base, pc_restart_base)

        if scenario.expect_health_recovery and pipeline.supervisor is not None:
            # the acceptance arc: /health's state machine must have gone
            # healthy → degraded during the stall and settled back to
            # healthy once the watchdog recovered the component
            from ..supervision import HealthState

            if "degraded" not in run.health_track:
                run.report.fail(
                    "health: state machine never left healthy during a "
                    "stall scenario (watchdog detected nothing)")

            def _settled() -> bool:
                pipeline.supervisor.sweep_once()
                return pipeline.supervisor.health.state \
                    is HealthState.HEALTHY

            try:
                await _wait_until(_settled, 8.0, "health stuck degraded")
            except TimeoutError:
                run.report.fail(
                    f"health: did not settle back to healthy after "
                    f"recovery: {pipeline.supervisor.health.snapshot()}")

        await pipeline.shutdown_and_wait()
    finally:
        # a failed scenario (timeout cancellation, unexpected error) must
        # not leak a live pipeline into the next scenario/test: hard-kill
        # whatever is still running and close the destination; release
        # any still-armed (or mid-stall) chaos stalls so no thread stays
        # parked, and lift a supervision-forced host-oracle degrade so it
        # cannot leak into the next scenario/test. After a clean shutdown
        # every call is an idempotent no-op.
        failpoints.release_stalls()
        from ..ops import engine

        engine.clear_forced_oracle()
        await _hard_kill(pipeline)
        await dest.shutdown()
        if pc_dir is not None:
            from ..ops import program_store

            program_store.configure(None)
            shutil.rmtree(pc_dir, ignore_errors=True)
    # unresolved = still pending now (shutdown missed them) PLUS any the
    # wrapper had to force-fail because no release ever came (shutdown
    # clears _held_acks, so counting the list alone would always be 0)
    inner.held_ack_count = dest.forced_held_acks + sum(
        1 for f in dest._held_acks if not f.done())
    # (decode-pipeline workers exit a beat after close(): the leak check
    # joins them, `LeakProbe.leaked_workers`)
    # a released thread-stall (decode fetch) finishes its fetch — and
    # releases its staging arena — a beat after the release; give it the
    # same grace as the worker threads before the leak probe counts
    from ..ops.staging import ARENA_POOL

    await _wait_until(
        lambda: ARENA_POOL.outstanding <= leak_probe.arenas_outstanding,
        3.0, "staging arenas lingering after stall release")

    # each destination-op timeout classified one call as failed and sent
    # the worker back through a re-stream: it funds the dup budget like
    # any other recovery (counted by mechanism, not by injected firing)
    run.redelivery_firings += int(_dest_timeouts_total() - timeouts_before)

    check_invariants(
        expected=workload.expected, dest=inner, store=store,
        restarts=run.restarts, fault_firings=run.redelivery_firings,
        leak_probe=leak_probe, report=run.report)
