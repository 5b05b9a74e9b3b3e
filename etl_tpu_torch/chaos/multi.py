"""Multi-pipeline chaos: two replication streams sharing one device set.

The fair batch-admission scheduler (ops/pipeline.AdmissionScheduler) is
the one piece of state that spans pipelines, so it gets its own scenario
shape: two full Pipelines (separate fake databases, stores, and
destinations — they share NOTHING but the process device set and its
scheduler) run concurrently, one of them is hard-killed mid-stream with
process-death semantics and restarted, and the run proves

  1. the SURVIVOR keeps decoding while the other stream is down — its
     remaining transactions must deliver during the outage window, which
     fails if the dead pipeline stranded admission tickets the survivor
     needed (capacity is deliberately small so stranded tickets bite);
  2. the zero-loss / bounded-dup / monotonic-LSN / leak invariants hold
     for BOTH streams independently (chaos/invariants.py per stream);
  3. scheduler shutdown leaks nothing: after both pipelines close, the
     scheduler holds zero tickets and zero tenants, and staging-arena
     leases and decode-pipeline threads return to their baselines.

`python -m etl_tpu_torch.chaos --multi-pipeline [--seed N]` replays it;
the same seed replays the same workload bytes on both streams.

Copy of the reference's `etl_tpu/chaos/multi.py`, over the port's
process-wide `global_admission` scheduler; the streams decode on `device`
("cuda", the card, or "cpu").
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field

from ..config import (BatchConfig, BatchEngine, PipelineConfig, RetryConfig,
                      SupervisionConfig)
from ..models.lsn import Lsn
from ..models.table_state import TableStateType
from ..postgres.fake import FakeSource
from ..postgres.slots import apply_slot_name
from . import failpoints
from .invariants import InvariantReport, LeakProbe, check_invariants
from .runner import (RecordingStore, RestartRecord, TracingDestination,
                     _hard_kill, _wait_until, _Workload)
from .scenario import Scenario

#: distinct table-id bases so a cross-stream delivery bug (events of one
#: stream reaching the other's destination) breaks invariants loudly
#: instead of aliasing
_STREAM_BASE_IDS = (16384, 18432)


@dataclass
class MultiPipelineRun:
    seed: int
    report: InvariantReport = field(default_factory=InvariantReport)
    restarts: list[RestartRecord] = field(default_factory=list)
    survivor_txs_during_outage: int = 0
    scheduler_drained: bool = False
    duration_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.report.ok

    def describe(self) -> dict:
        return {
            "scenario": "multi_pipeline_crash_one_stream",
            "seed": self.seed,
            "ok": self.ok,
            "restarts": [r.describe() for r in self.restarts],
            "survivor_txs_during_outage": self.survivor_txs_during_outage,
            "scheduler_drained": self.scheduler_drained,
            "invariants": self.report.describe(),
            "duration_s": round(self.duration_s, 3),
        }


class _Stream:
    """One replication stream: its own fake database, store, destination,
    and Pipeline — nothing shared with the other stream but the process
    device set and its admission scheduler."""

    def __init__(self, index: int, scenario: Scenario, seed: int,
                 admission_capacity: int, device: str = "cuda"):
        self.index = index
        self.workload = _Workload(scenario, random.Random(seed))
        # re-base the table ids so the two streams can never alias
        base = _STREAM_BASE_IDS[index]
        self.workload.table_ids = [base + i for i in range(scenario.tables)]
        self.workload.expected = {t: {} for t in self.workload.table_ids}
        self.workload._next_pk = {t: 1 for t in self.workload.table_ids}
        self.db = self.workload.build_db()
        self.store = RecordingStore()
        self.dest = TracingDestination()
        # supervision LIVE but lenient (the runner's fault-scenario
        # stance): deadlines far above any legitimate pause here, so the
        # dup budget needs no supervision-restart accounting
        self.config = PipelineConfig(
            pipeline_id=index + 1, publication_name="pub",
            batch=BatchConfig(max_size_bytes=64 * 1024, max_fill_ms=25,
                              batch_engine=BatchEngine.CUDA,
                              device=device,
                              admission_capacity=admission_capacity),
            apply_retry=RetryConfig(max_attempts=10, initial_delay_ms=15,
                                    max_delay_ms=120),
            table_retry=RetryConfig(max_attempts=10, initial_delay_ms=15,
                                    max_delay_ms=120),
            supervision=SupervisionConfig(
                check_interval_s=0.25, stall_deadline_s=10.0,
                hang_deadline_s=25.0, restart_backoff_s=1.0),
            wal_sender_timeout_ms=60_000,
            lag_sample_interval_s=0)
        self.pipeline = None

    def make_pipeline(self):
        from ..runtime import Pipeline

        self.pipeline = Pipeline(config=self.config, store=self.store,
                                 destination=self.dest,
                                 source_factory=lambda: FakeSource(self.db))
        return self.pipeline

    async def wait_ready(self) -> None:
        await _wait_until(
            lambda: all(
                (st := self.store._states.get(tid)) is not None
                and st.type is TableStateType.READY
                for tid in self.workload.table_ids),
            30.0, f"stream {self.index}: tables never ready")

    async def wait_delivered(self, what: str) -> None:
        await _wait_until(lambda: self.workload.delivered(self.dest),
                          30.0, f"stream {self.index}: {what}")


async def run_multi_pipeline_scenario(seed: int = 7, txs: int = 6,
                                      rows_per_tx: int = 100,
                                      admission_capacity: int = 2,
                                      device: str = "cuda"
                                      ) -> MultiPipelineRun:
    """Two streams share the admission scheduler; stream 1 is hard-killed
    after half its transactions and restarted. rows_per_tx defaults past
    the decoder's device row floor so flushes actually take admission tickets
    (sub-threshold flushes decode on the oracle, which holds none), and
    admission_capacity=2 keeps the scheduler tight enough that tickets
    stranded by the kill would visibly choke the survivor."""
    failpoints.disarm_all()
    from ..ops.pipeline import global_admission, reset_global_admission

    run = MultiPipelineRun(seed=seed)
    t_start = time.monotonic()
    reset_global_admission()
    leak_probe = LeakProbe.capture()
    shape = Scenario(name="multi", description="per-stream workload",
                     txs=txs, rows_per_tx=rows_per_tx)
    survivor = _Stream(0, shape, seed, admission_capacity, device)
    victim = _Stream(1, shape, seed + 1_000, admission_capacity, device)
    streams = (survivor, victim)
    try:
        for s in streams:
            s.make_pipeline()
            await s.pipeline.start()
        await asyncio.gather(*(s.wait_ready() for s in streams))
        half = txs // 2

        async def drive(s: _Stream, until: int) -> None:
            while s.workload.tx_index < until:
                await s.workload.run_tx(s.db)

        await asyncio.gather(*(drive(s, half) for s in streams))

        # hard crash stream 1: every task cancelled, no drain — the
        # decode pipeline's finally path must hand its admission tickets
        # back (DecodePipeline.close → TenantAdmission.close)
        await _hard_kill(victim.pipeline)
        resume = await victim.store.get_durable_progress(
            apply_slot_name(victim.config.pipeline_id))
        run.restarts.append(RestartRecord(
            kind="crash", resume_lsn=int(resume or Lsn.ZERO),
            at_tx=victim.workload.tx_index))

        # the survivor must keep decoding DURING the outage: its whole
        # remaining workload delivers while stream 1 is down
        before = survivor.workload.tx_index
        await drive(survivor, txs)
        await survivor.wait_delivered("survivor stalled during the "
                                      "other stream's outage")
        run.survivor_txs_during_outage = survivor.workload.tx_index - before

        # restart the crashed stream from its durable state; it must
        # finish its workload and reconverge
        t_restart = time.monotonic()
        victim.make_pipeline()
        await victim.pipeline.start()
        await drive(victim, txs)
        await victim.wait_delivered("crashed stream never reconverged "
                                    "after restart")
        run.restarts[-1].recovery_s = time.monotonic() - t_restart

        for s in streams:
            await s.pipeline.shutdown_and_wait()
    except Exception as e:
        run.report.fail(f"scenario crashed: {e!r}")
    finally:
        failpoints.release_stalls()
        from ..ops import engine

        engine.clear_forced_oracle()
        for s in streams:
            if s.pipeline is not None:
                await _hard_kill(s.pipeline)
            await s.dest.shutdown()
        run.duration_s = time.monotonic() - t_start

    # the scheduler-leak half of the satellite: zero tickets and zero
    # tenants after both pipelines closed — a stranded TenantAdmission
    # would throttle every future stream in the process
    sched = global_admission(admission_capacity)
    stats = sched.stats()
    run.scheduler_drained = stats["in_flight"] == 0 and not stats["tenants"]
    if not run.scheduler_drained:
        run.report.fail(
            f"admission scheduler leaked after shutdown: {stats}")

    # invariants per stream, independently: the victim's crash funds one
    # restart's worth of dup budget; the survivor gets none
    for s, restarts in ((survivor, []), (victim, run.restarts)):
        check_invariants(
            expected=s.workload.expected, dest=s.dest, store=s.store,
            restarts=restarts, fault_firings=0, leak_probe=leak_probe,
            report=run.report)
    return run
