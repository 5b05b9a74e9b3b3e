"""Ack-window chaos: hard-kill with K ≥ 2 destination acks in flight.

The bounded write window (runtime/ack_window.py) widens the classic
write-vs-progress-store crash window: at the kill instant up to
`write_window` batches have been SUBMITTED to the destination while none
of their acks has resolved — durable progress covers only the contiguous
acked prefix, so the restart must re-stream every in-flight batch. The
scenario proves, with a destination whose acks turn durable a fixed
delay late (destinations/delay.py — the deterministic way to hold
multiple acks open):

  1. the kill lands while ≥ 2 acks are verifiably in flight (the
     delayed destination's pending counter is the evidence — window=1
     could never reach 2);
  2. zero-loss: every committed row is present after recovery;
  3. bounded-dup: re-delivered batches stay within budget = 1 + restarts
     — i.e. the window-full of unacked batches re-streams ONCE;
  4. monotonic durable LSN across the kill (the contiguous-prefix rule
     means the store never named an unacked batch's commit);
  5. no leaked tasks/threads/arena leases.

`python -m etl_tpu_torch.chaos --ack-window [--seed N]` replays it: the
workload bytes are seed-deterministic and the kill is event-triggered
(pending ≥ 2), so the delivered end state replays identically.

Copy of the reference's `etl_tpu/chaos/ack_window.py`, on the port's
pipeline: `BatchEngine.CUDA` decodes on `device` ("cuda", the card, or
"cpu", the kernels' plain versions). The transactions are a few rows
each, so at the decoder's 64-row floor their batches take the host
oracle; `chaos.runner.device_floor(1)` routes every batch to the kernels.
The decode workers are joined by the invariant check's leak probe
(`LeakProbe.leaked_workers`), not counted at once.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field

from ..config import (BatchConfig, BatchEngine, PipelineConfig, RetryConfig,
                      SupervisionConfig)
from ..destinations import DelayedAckDestination
from ..models.lsn import Lsn
from ..models.table_state import TableStateType
from ..postgres.fake import FakeSource
from ..postgres.slots import apply_slot_name
from . import failpoints
from .invariants import InvariantReport, LeakProbe, check_invariants
from .runner import (RecordingStore, RestartRecord, TracingDestination,
                     _hard_kill, _wait_until, _Workload)
from .scenario import Scenario


@dataclass
class AckWindowCrashRun:
    seed: int
    report: InvariantReport = field(default_factory=InvariantReport)
    restarts: list[RestartRecord] = field(default_factory=list)
    acks_in_flight_at_kill: int = 0
    max_acks_pending: int = 0
    duration_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.report.ok

    def describe(self) -> dict:
        return {
            "scenario": "ack_window_crash_k_inflight",
            "seed": self.seed,
            "ok": self.ok,
            "restarts": [r.describe() for r in self.restarts],
            "acks_in_flight_at_kill": self.acks_in_flight_at_kill,
            "max_acks_pending": self.max_acks_pending,
            "invariants": self.report.describe(),
            "duration_s": round(self.duration_s, 3),
        }


async def run_ack_window_crash(seed: int = 7, txs: int = 8,
                               rows_per_tx: int = 6,
                               ack_delay_s: float = 0.25,
                               write_window: int = 4,
                               device: str = "cuda") -> AckWindowCrashRun:
    """Drive CDC until the write window verifiably holds ≥ 2 pending
    acks, hard-kill the pipeline with process-death semantics, restart
    from durable state, finish the workload, and check every recovery
    invariant. Small batches (2 KiB) + per-commit dispatch + a 250 ms
    ack delay stack the window deterministically within the first
    transactions. `device` is where the CUDA engine's decoders run."""
    failpoints.disarm_all()
    run = AckWindowCrashRun(seed=seed)
    t_start = time.monotonic()
    leak_probe = LeakProbe.capture()
    shape = Scenario(name="ack_window", description="K-in-flight crash",
                     txs=txs, rows_per_tx=rows_per_tx)
    workload = _Workload(shape, random.Random(seed))
    db = workload.build_db()
    store = RecordingStore()
    inner = TracingDestination()
    dest = DelayedAckDestination(inner, ack_delay_s)
    config = PipelineConfig(
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
        # commit transactions until ≥ 2 acks are in flight at once; each
        # commit's fast-path flush dispatches while earlier acks pend
        half = txs // 2
        while workload.tx_index < half:
            await workload.run_tx(db)
        await _wait_until(lambda: dest.pending >= 2, 20.0,
                          "the write window never held 2 acks in flight")
        run.acks_in_flight_at_kill = dest.pending

        # hard kill with K acks in flight: every pipeline task cancelled,
        # no drain — the unacked batches' durability never reached the
        # progress store (contiguous-prefix rule), so restart re-streams
        # them (at-least-once, budget = the window)
        await _hard_kill(pipeline)
        resume = await store.get_durable_progress(apply_slot_name(1))
        run.restarts.append(RestartRecord(
            kind="crash", resume_lsn=int(resume or Lsn.ZERO),
            at_tx=workload.tx_index))

        t_restart = time.monotonic()
        pipeline = make_pipeline()
        await pipeline.start()
        while workload.tx_index < txs:
            await workload.run_tx(db)
        await _wait_until(lambda: workload.delivered(inner), 30.0,
                          "workload never fully delivered after restart")
        run.restarts[-1].recovery_s = time.monotonic() - t_restart
        await pipeline.shutdown_and_wait()
    except Exception as e:
        run.report.fail(f"scenario crashed: {e!r}")
    finally:
        failpoints.release_stalls()
        from ..ops import engine

        engine.clear_forced_oracle()
        await _hard_kill(pipeline)
        await dest.shutdown()
        run.duration_s = time.monotonic() - t_start
    run.max_acks_pending = dest.max_pending

    if run.acks_in_flight_at_kill < 2:
        run.report.fail(
            f"kill landed with only {run.acks_in_flight_at_kill} ack(s) "
            f"in flight — the scenario did not exercise the window")

    # budget = 1 + 1 restart: the window-full of unacked batches may
    # deliver exactly twice, nothing may deliver three times
    check_invariants(
        expected=workload.expected, dest=inner, store=store,
        restarts=run.restarts, fault_firings=0, leak_probe=leak_probe,
        report=run.report)
    return run
