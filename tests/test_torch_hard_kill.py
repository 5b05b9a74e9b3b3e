"""A hard-killed pipeline releases its decode worker and its staging
arenas, also when the kill lands while the apply loop is already leaving.

The apply loop's teardown first cancels and drains its in-flight writes,
then abandons their pending decodes, returns its lease and closes the
assembler's decode pipeline. A hard kill that arrives while that drain is
parked (the loop was leaving on an error, or on a first cancel, and a
write is slow to unwind) raises out of the drain; the releases after it
must run all the same. Two checks:

- deterministic: a write that takes 0.3 s to unwind its cancellation,
  a first cancel of the apply task, then the hard kill's cancel inside
  the drain;
- under load: the DLQ bisection crash scenario (seed 7) with busy
  processes beside it, the load under which the leak first showed, each
  run time-boxed.

A restart after a kill resumes at the slot's confirmed flush when that is
past durable progress, so nothing may confirm WAL the stream has not
delivered: the fake walsender's keepalive carries the stream's sent
position (a real walsender's sentPtr), not the server's WAL end, and a
closed stream carries no feedback. Before, a keepalive whose wait timed
out just after a commit appended WAL reported that WAL as received, the
idle apply loop confirmed it, and the restart resumed past rows that
were never delivered. Checked deterministically (the commit's wakeup held
past the keepalive timeout, then a kill inside the drain and a restart on
the same database) and at the stream.

Tolerance: none — no worker of the port outlives the join, the arena
pool's outstanding count returns to its baseline, and every committed row
arrives after the restart.
"""

from __future__ import annotations

import asyncio
import random
import subprocess
import sys
import time

import pytest

from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.chaos.invariants import LeakProbe, view_matches
from etl_tpu_torch.chaos.runner import (RecordingStore, TracingDestination,
                                        _Workload, _wait_until)
from etl_tpu_torch.chaos.scenario import Scenario
from etl_tpu_torch.config import (BatchConfig, BatchEngine, PipelineConfig,
                                  RetryConfig, SupervisionConfig)
from etl_tpu_torch.models.lsn import Lsn
from etl_tpu_torch.models.table_state import TableStateType
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission
from etl_tpu_torch.ops.staging import ARENA_POOL
from etl_tpu_torch.postgres.codec import pgoutput
from etl_tpu_torch.postgres.fake import FakeSource

SEED = 7
#: busy processes beside the loaded runs: with a parallel test run's other
#: workers they keep an 8-core host over-subscribed, the load under which
#: the leak showed (more only stretches the scenario's own 30 s deadlines)
SPINNERS = 6
#: each loaded run's time box, seconds (a clean run takes well under 2 s;
#: a leaked worker alone costs the leak probe's 10 s join)
RUN_BOX_S = 60.0


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    engine.clear_forced_oracle()
    failpoints.disarm_all()
    reset_global_admission()


class _SlowUnwindDestination(TracingDestination):
    """Once armed, a write hangs until cancelled and then takes
    `unwind_s` to unwind, as a write stuck in a slow client does."""

    def __init__(self, unwind_s: float) -> None:
        super().__init__()
        self.unwind_s = unwind_s
        self.armed = False
        self.hung = asyncio.Event()

    async def write_events(self, events):
        if not self.armed:
            return await super().write_events(events)
        self.hung.set()
        try:
            await asyncio.Event().wait()
        except asyncio.CancelledError:
            await asyncio.sleep(self.unwind_s)
            raise


async def _kill_inside_the_drain() -> tuple:
    probe = LeakProbe.capture()
    workload = _Workload(Scenario(name="hard_kill_drain",
                                  description="kill inside the drain",
                                  txs=2, rows_per_tx=6),
                         random.Random(SEED))
    db = workload.build_db()
    store = RecordingStore()
    dest = _SlowUnwindDestination(unwind_s=0.3)
    from etl_tpu_torch.runtime import Pipeline

    pipeline = Pipeline(
        config=PipelineConfig(
            pipeline_id=1, publication_name="pub",
            batch=BatchConfig(max_size_bytes=2048, max_fill_ms=10,
                              batch_engine=BatchEngine.CUDA,
                              device="cpu", write_window=2),
            apply_retry=RetryConfig(max_attempts=3, initial_delay_ms=15,
                                    max_delay_ms=60),
            # no supervision: the apply task awaits the loop itself, so
            # both cancels below reach the loop, as a hard kill's does
            # when the loop is already leaving
            supervision=SupervisionConfig(enabled=False),
            wal_sender_timeout_ms=60_000, lag_sample_interval_s=0),
        store=store, destination=dest,
        source_factory=lambda: FakeSource(db))
    await pipeline.start()
    await _wait_until(
        lambda: all((st := store._states.get(tid)) is not None
                    and st.type is TableStateType.READY
                    for tid in workload.table_ids),
        30.0, "tables never ready")
    dest.armed = True
    await workload.run_tx(db)
    await asyncio.wait_for(dest.hung.wait(), 20.0)
    task = pipeline._apply_task
    task.cancel()  # the loop leaves; its drain waits on the slow write
    await asyncio.sleep(0.05)
    task.cancel()  # the hard kill, landing inside that drain
    await asyncio.gather(task, return_exceptions=True)
    leaked = probe.leaked_workers()
    deadline = time.monotonic() + 3.0
    while ARENA_POOL.outstanding > probe.arenas_outstanding \
            and time.monotonic() < deadline:
        await asyncio.sleep(0.02)
    return leaked, ARENA_POOL.outstanding - probe.arenas_outstanding


def test_kill_inside_the_drain_releases_worker_and_arenas():
    leaked, arenas = asyncio.run(_kill_inside_the_drain())
    assert leaked == []
    assert arenas <= 0


async def _keepalive_past_unread_wal_then_kill() -> dict:
    """A keepalive whose timeout fires after a commit appended WAL but
    before the stream read it, then a kill inside the drain of the
    write that carries that commit, then a restart on the same
    FakeDatabase. The commit must arrive after the restart."""
    workload = _Workload(Scenario(name="keepalive_past_unread_wal",
                                  description="keepalive past unread WAL",
                                  txs=2, rows_per_tx=6),
                         random.Random(SEED))
    db = workload.build_db()
    store = RecordingStore()
    dest = _SlowUnwindDestination(unwind_s=0.3)
    from etl_tpu_torch.runtime import Pipeline

    def make_pipeline() -> "Pipeline":
        return Pipeline(
            config=PipelineConfig(
                pipeline_id=1, publication_name="pub",
                batch=BatchConfig(max_size_bytes=2048, max_fill_ms=10,
                                  batch_engine=BatchEngine.CUDA,
                                  device="cpu", write_window=2),
                apply_retry=RetryConfig(max_attempts=3,
                                        initial_delay_ms=15,
                                        max_delay_ms=60),
                supervision=SupervisionConfig(enabled=False),
                wal_sender_timeout_ms=60_000, lag_sample_interval_s=0),
            store=store, destination=dest,
            source_factory=lambda: FakeSource(db))

    pipeline = make_pipeline()
    await pipeline.start()
    await _wait_until(
        lambda: all((st := store._states.get(tid)) is not None
                    and st.type is TableStateType.READY
                    for tid in workload.table_ids),
        30.0, "tables never ready")
    await asyncio.sleep(0.1)  # the stream is caught up and waiting
    dest.armed = True
    slot = db.slots["supabase_etl_apply_1"]
    # hold the stream's wakeup: the commit appends its WAL and then waits
    # for the lock, while the stream's keepalive timeout fires
    await db._wal_cond.acquire()
    first_unread = len(db.wal)
    commit = asyncio.ensure_future(workload.run_tx(db))
    await asyncio.sleep(0.3)
    assert len(db.wal) > first_unread  # appended, not read yet
    tx_first_lsn = int(db.wal[first_unread][0])
    db._wal_cond.release()
    await commit
    await asyncio.wait_for(dest.hung.wait(), 20.0)
    confirmed_at_write = int(slot.confirmed_flush)
    task = pipeline._apply_task
    task.cancel()  # the loop leaves; its drain waits on the slow write
    await asyncio.sleep(0.05)
    task.cancel()  # the kill, landing inside that drain
    await asyncio.gather(task, return_exceptions=True)
    old_streams_open = [s.id for s in db.active_streams]
    dest.armed = False
    pipeline = make_pipeline()
    await pipeline.start()
    try:
        await _wait_until(
            lambda: view_matches(dest, workload.table_ids,
                                 workload.expected),
            10.0, "the restart never delivered the commit")
        delivered = True
    except TimeoutError:
        delivered = False
    finally:
        await pipeline.shutdown_and_wait()
    return {"tx_first_lsn": tx_first_lsn,
            "confirmed_at_write": confirmed_at_write,
            "old_streams_open": old_streams_open,
            "delivered": delivered}


def test_keepalive_past_unread_wal_loses_nothing_across_a_kill():
    r = asyncio.run(_keepalive_past_unread_wal_then_kill())
    # the slot never covers WAL the stream had not sent
    assert r["confirmed_at_write"] <= r["tx_first_lsn"], r
    # the killed loop closed its stream, as a crash closes the socket
    assert r["old_streams_open"] == [], r
    assert r["delivered"], r


def test_closed_stream_feedback_moves_no_slot():
    async def run() -> tuple:
        workload = _Workload(Scenario(name="closed_feedback",
                                      description="feedback after close",
                                      txs=1, rows_per_tx=2),
                             random.Random(SEED))
        db = workload.build_db()
        source = FakeSource(db)
        await source.create_slot("s")
        stream = await source.start_replication("s", "pub", Lsn.ZERO)
        await workload.run_tx(db)
        before = db.slots["s"].confirmed_flush
        await stream.close()
        await stream.send_status_update(db.current_lsn, db.current_lsn,
                                        db.current_lsn)
        return before, db.slots["s"].confirmed_flush, db.slots["s"].active

    before, after, active = asyncio.run(run())
    assert after == before
    assert active is False


def test_keepalive_carries_the_sent_position():
    """Every WAL entry before a keepalive's end was sent on the stream
    (a walsender's sentPtr), also when WAL was appended between the last
    read and the keepalive's timeout."""
    async def run() -> tuple:
        workload = _Workload(Scenario(name="sent_position",
                                      description="keepalive end",
                                      txs=1, rows_per_tx=3),
                             random.Random(SEED))
        db = workload.build_db()
        source = FakeSource(db, keepalive_interval_s=0.02)
        await source.create_slot("s")
        stream = await source.start_replication("s", "pub",
                                                db.current_lsn)
        frames = stream.__aiter__()
        first = await frames.__anext__()  # caught up: a keepalive
        nxt = asyncio.ensure_future(frames.__anext__())
        await asyncio.sleep(0.005)  # the read waits for WAL
        await db._wal_cond.acquire()
        unread = len(db.wal)
        commit = asyncio.ensure_future(workload.run_tx(db))
        await asyncio.sleep(0.15)
        db._wal_cond.release()
        await commit
        frame = await nxt
        await stream.close()
        return first, frame, int(db.wal[unread][0])

    first, frame, unread_lsn = asyncio.run(run())
    assert isinstance(first, pgoutput.PrimaryKeepalive)
    if isinstance(frame, pgoutput.PrimaryKeepalive):
        assert int(frame.end_lsn) <= unread_lsn
    else:
        assert int(frame.start_lsn) == unread_lsn


def _spinners(n: int) -> list:
    return [subprocess.Popen([sys.executable, "-c", "while True: pass"],
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL) for _ in range(n)]


def test_dlq_bisection_crash_under_load_leaks_nothing():
    from etl_tpu_torch.chaos.dlq import run_dlq_bisection_crash

    spinners = _spinners(SPINNERS)
    try:
        for _ in range(3):
            run = asyncio.run(asyncio.wait_for(
                run_dlq_bisection_crash(seed=SEED, device="cpu"),
                RUN_BOX_S))
            leaks = [v for v in run.report.violations if "no-leaks" in v]
            assert leaks == [], leaks
            assert run.ok, run.report.violations
    finally:
        for p in spinners:
            p.kill()
        for p in spinners:
            p.wait()
