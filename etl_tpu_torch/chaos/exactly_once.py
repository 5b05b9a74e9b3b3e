"""Exactly-once chaos: a hard-kill matrix over the transactional
commit seam (docs/destinations.md).

The at-least-once scenarios (--ack-window, the corpus) prove bounded
duplication — budget = 1 + restarts. This matrix proves the STRICT
invariant the transactional seam buys: against a sink that records the
acked WAL coordinate range atomically with the data
(`TransactionalMemoryDestination`, the in-memory analogue of BigQuery
MERGE keys / ClickHouse dedup tokens / Iceberg snapshot properties /
Snowpipe offsets), a hard kill ANYWHERE leaves duplication == 0 — every
row delivered exactly once — alongside zero-loss and a monotone sink
high-water mark.

Three kill windows, each its own seeded sub-run:

  mid_write     — acks turn durable a fixed delay late
                  (DelayedAckDestination); the kill lands with >= 2
                  committed-but-unacked writes: the sink holds data +
                  range the progress store never heard about.
  pre_progress  — a stall armed at STORE_PROGRESS_COMMIT wedges the
                  durable-progress write AFTER the flush acked; the kill
                  lands inside the classic write-vs-progress gap.
  mid_recovery  — the FIRST restart is itself hard-killed while the
                  sink's recovery query (`recover_high_water`) is in
                  flight (scripted delay + one transient fault exercises
                  the satellite-1 retry path); the second restart must
                  still converge.

After each kill the restarted pipeline recovers the sink's high-water
mark (`ApplyWorker._recover_sink_high_water`), bootstraps the progress
store past what the sink already holds, and re-streams at most the
unacked suffix — whose rows the sink's coordinate dedup absorbs.

`python -m etl_tpu_torch.chaos --exactly-once [--seed N]` replays the
matrix; the workload bytes are seed-deterministic and every kill is
event-triggered, so the end state replays bit-identically per seed.

Copy of the reference's `etl_tpu/chaos/exactly_once.py`, on the port's
pipeline: `BatchEngine.CUDA` decodes on `device` ("cuda", the card, or
"cpu", the kernels' plain versions); under
`chaos.runner.device_floor(1)` every batch of these few-row transactions
goes through the kernels. The decode workers are joined by the invariant
check's leak probe (`LeakProbe.leaked_workers`), not counted at once.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from ..config import (BatchConfig, BatchEngine, PipelineConfig, RetryConfig,
                      SupervisionConfig)
from ..destinations import TransactionalMemoryDestination
from ..destinations import DelayedAckDestination
from ..models.errors import ErrorKind, EtlError
from ..models.lsn import Lsn
from ..models.table_state import TableStateType
from ..postgres.fake import FakeSource
from ..postgres.slots import apply_slot_name
from . import failpoints
from .invariants import InvariantReport, LeakProbe, check_invariants
from .runner import RecordingStore, RestartRecord, _hard_kill, _wait_until, \
    _Workload
from .scenario import Scenario

KILL_WINDOWS = ("mid_write", "pre_progress", "mid_recovery")


class TracingTransactionalDestination(TransactionalMemoryDestination):
    """TransactionalMemoryDestination + the drop bookkeeping the
    invariant checker expects from chaos sinks."""

    def __init__(self) -> None:
        super().__init__()
        self.drop_seq_by_table: dict = {}
        self.held_ack_count = 0

    async def drop_table(self, table_id, schema=None) -> None:
        self.drop_seq_by_table[table_id] = len(self.events)
        await super().drop_table(table_id, schema)


@dataclass
class ExactlyOnceRun:
    seed: int
    report: InvariantReport = field(default_factory=InvariantReport)
    windows: list[dict] = field(default_factory=list)
    duration_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.report.ok

    def describe(self) -> dict:
        return {
            "scenario": "exactly_once_kill_matrix",
            "seed": self.seed,
            "ok": self.ok,
            "windows": list(self.windows),
            "invariants": self.report.describe(),
            "duration_s": round(self.duration_s, 3),
        }


def _config(write_window: int = 4, device: str = "cuda") -> PipelineConfig:
    return PipelineConfig(
        pipeline_id=1, publication_name="pub",
        batch=BatchConfig(max_size_bytes=2048, max_fill_ms=25,
                          batch_engine=BatchEngine.CUDA, device=device,
                          write_window=write_window),
        apply_retry=RetryConfig(max_attempts=10, initial_delay_ms=15,
                                max_delay_ms=120),
        table_retry=RetryConfig(max_attempts=10, initial_delay_ms=15,
                                max_delay_ms=120),
        supervision=SupervisionConfig(
            check_interval_s=0.25, stall_deadline_s=10.0,
            hang_deadline_s=25.0, restart_backoff_s=1.0),
        wal_sender_timeout_ms=60_000,
        lag_sample_interval_s=0)


async def _run_window(window: str, seed: int, report: InvariantReport,
                      txs: int = 8, rows_per_tx: int = 5,
                      device: str = "cuda") -> dict:
    """One kill window against a fresh workload + transactional sink.
    Returns the window's describe() fragment; failures land on the
    shared report prefixed with the window name."""
    failpoints.disarm_all()
    leak_probe = LeakProbe.capture()
    shape = Scenario(name=f"exactly_once_{window}",
                     description=f"hard kill at {window}",
                     txs=txs, rows_per_tx=rows_per_tx)
    workload = _Workload(shape, random.Random(seed))
    db = workload.build_db()
    store = RecordingStore()
    inner = TracingTransactionalDestination()
    ack_delay_s = 0.25 if window == "mid_write" else 0.0
    dest = DelayedAckDestination(inner, ack_delay_s) \
        if window == "mid_write" else inner
    config = _config(device=device)
    restarts: list[RestartRecord] = []
    doc: dict = {"window": window, "seed": seed}

    def make_pipeline():
        from ..runtime import Pipeline

        return Pipeline(config=config, store=store, destination=dest,
                        source_factory=lambda: FakeSource(db))

    pipeline = make_pipeline()
    try:
        await pipeline.start()
        await _wait_until(
            lambda: all(
                (st := store._states.get(tid)) is not None
                and st.type is TableStateType.READY
                for tid in workload.table_ids),
            30.0, "tables never ready")
        half = txs // 2
        while workload.tx_index < half:
            await workload.run_tx(db)

        if window == "mid_write":
            # the kill must land with >= 2 committed-but-unacked writes:
            # the sink already holds their data + coordinate ranges
            await _wait_until(lambda: dest.pending >= 2, 20.0,
                              "never held 2 delayed acks in flight")
            doc["acks_in_flight_at_kill"] = dest.pending
        elif window == "pre_progress":
            # wedge the NEXT durable-progress store write and kill
            # inside the stall: flush acked, progress never committed
            spec = failpoints.arm_stall(failpoints.STORE_PROGRESS_COMMIT,
                                        duration_s=30.0, times=1)
            while workload.tx_index < half + 1:
                await workload.run_tx(db)
            await _wait_until(lambda: spec.fired >= 1, 20.0,
                              "progress-store stall never fired")
        doc["sink_end_at_kill"] = int(inner.committed_end_lsn)
        doc["sink_high_at_kill"] = list(inner.high_water)
        await _hard_kill(pipeline)
        failpoints.release_stalls()
        failpoints.disarm_all()
        resume = await store.get_durable_progress(apply_slot_name(1))
        restarts.append(RestartRecord(
            kind="crash", resume_lsn=int(resume or Lsn.ZERO),
            at_tx=workload.tx_index))

        if window == "mid_recovery":
            # restart whose sink recovery query is slow + transiently
            # failing, then kill it MID-RECOVERY; the second restart
            # must still converge (satellite-1 retry path exercised)
            inner.recover_delay_s = 0.6
            inner.recover_faults.append(EtlError(
                ErrorKind.TIMEOUT, "scripted recovery-query fault"))
            calls_before = inner.recover_calls
            pipeline = make_pipeline()
            await pipeline.start()
            await _wait_until(
                lambda: inner.recover_calls > calls_before, 20.0,
                "sink recovery query never ran on restart")
            await _hard_kill(pipeline)
            inner.recover_delay_s = 0.0
            resume = await store.get_durable_progress(apply_slot_name(1))
            restarts.append(RestartRecord(
                kind="crash", resume_lsn=int(resume or Lsn.ZERO),
                at_tx=workload.tx_index))

        t_restart = time.monotonic()
        pipeline = make_pipeline()
        await pipeline.start()
        while workload.tx_index < txs:
            await workload.run_tx(db)
        await _wait_until(lambda: workload.delivered(inner), 30.0,
                          "workload never fully delivered after restart")
        restarts[-1].recovery_s = time.monotonic() - t_restart
        await pipeline.shutdown_and_wait()
    except Exception as e:
        report.fail(f"{window}: scenario crashed: {e!r}")
    finally:
        failpoints.release_stalls()
        failpoints.disarm_all()
        from ..ops import engine

        engine.clear_forced_oracle()
        await _hard_kill(pipeline)
        await dest.shutdown()

    # the standard invariants (zero-loss, monotonic durable LSN,
    # no-leaks) — with dup budget temporarily at-least-once so the sub-
    # report carries max_duplication for the STRICT check below
    sub = check_invariants(
        expected=workload.expected, dest=inner, store=store,
        restarts=restarts, fault_firings=0, leak_probe=leak_probe)
    for f in sub.violations:
        report.fail(f"{window}: {f}")

    # -- the exactly-once invariants ------------------------------------------
    # the kill must have landed inside a REAL write-vs-progress gap: the
    # sink held committed coordinate ranges the progress store never
    # named (otherwise the window exercised nothing)
    if window in ("mid_write", "pre_progress") and restarts:
        if doc["sink_end_at_kill"] <= restarts[0].resume_lsn:
            report.fail(
                f"{window}: kill landed outside the gap — sink commit "
                f"end {doc['sink_end_at_kill']} not ahead of durable "
                f"progress {restarts[0].resume_lsn}")
    max_dup = sub.stats.get("max_duplication", 0)
    if max_dup > 1:
        report.fail(
            f"{window}: exactly-once violated — a row delivered "
            f"{max_dup}x through the transactional sink (dup budget 0)")
    for a, b in zip(inner.high_water_log, inner.high_water_log[1:]):
        if b < a:
            report.fail(f"{window}: sink high-water regressed {a} -> {b}")
    if inner.recover_calls < len(restarts):
        report.fail(
            f"{window}: sink recovery query ran {inner.recover_calls}x "
            f"for {len(restarts)} restart(s) — a restart resumed blind")
    if inner.uncoordinated_writes:
        report.fail(
            f"{window}: {inner.uncoordinated_writes} CDC write(s) "
            f"bypassed the transactional seam")

    doc.update({
        "restarts": [r.describe() for r in restarts],
        "max_duplication": max_dup,
        "dedup_skipped_rows": inner.dedup_skipped_rows,
        "recover_calls": inner.recover_calls,
        "high_water": list(inner.high_water),
        "high_water_log_len": len(inner.high_water_log),
        "delivered_events": sub.stats.get("delivered_events", 0),
        "expected_rows": sub.stats.get("expected_rows", 0),
    })
    return doc


async def run_exactly_once_crash(seed: int = 11,
                                 device: str = "cuda") -> ExactlyOnceRun:
    """The full kill matrix: every window in KILL_WINDOWS, each against
    a fresh seeded workload (seed + window index keeps the sub-runs
    independent AND deterministic), decoded on `device`."""
    run = ExactlyOnceRun(seed=seed)
    t_start = time.monotonic()
    for i, window in enumerate(KILL_WINDOWS):
        run.windows.append(
            await _run_window(window, seed + i, run.report,
                              device=device))
    run.duration_s = time.monotonic() - t_start
    return run
