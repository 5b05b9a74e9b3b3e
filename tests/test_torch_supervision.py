"""The port's supervision tree (`etl_tpu_torch.supervision`), held to the
reference's tests/test_supervision.py: heartbeat contract, stall/hang
detection, health state machine, circuit breaker, destination op
timeouts, the host-oracle degrade on the port's own DeviceDecoder, and
the supervised `Pipeline`. Plus the decode pipeline's heartbeat (beaten
from its worker thread), the memory monitor's beat under the shrink path
of tests/test_backpressure.py, and a supervisor restart of the apply
worker that leaves no decode worker behind.

The reference's `TestReplicatorHealthEndpoint` waits for the port of
`replicator.py` (ROADMAP.md, queue 1): its `/health` surface reads
`Pipeline.health_snapshot()`, which the tests here hold.
"""

from __future__ import annotations

import asyncio
import threading
import time

import numpy as np
import pytest

from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.config import (BatchConfig, BatchEngine, PipelineConfig,
                                  RetryConfig, SupervisionConfig)
from etl_tpu_torch.destinations import MemoryDestination
from etl_tpu_torch.models.errors import (ErrorKind, EtlError, RetryKind,
                                         retry_directive)
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission
from etl_tpu_torch.postgres.fake import FakeSource
from etl_tpu_torch.runtime import Pipeline
from etl_tpu_torch.store import NotifyingStore
from etl_tpu_torch.supervision import (BreakerState, CircuitBreaker,
                                       HealthState, HealthStateMachine,
                                       SupervisedDestination, Supervisor,
                                       beat_while_waiting)

from tests.test_torch_pipeline_e2e import (ACCOUNTS, _account_ids,
                                           _wait_for, make_db, wait_ready)


@pytest.fixture(autouse=True)
def _port_hygiene():
    """The forced-oracle state is module-global (as in the reference): a
    test that left it set would move every later batch of this worker
    onto the oracle."""
    yield
    engine.clear_forced_oracle()
    failpoints.disarm_all()
    reset_global_admission()


def fast_supervisor(**overrides) -> Supervisor:
    cfg = dict(check_interval_s=0.01, stall_deadline_s=0.05,
               hang_deadline_s=0.1, restart_backoff_s=0.05,
               device_degrade_threshold=2, device_degrade_cooldown_s=0.3,
               breaker_failure_threshold=3, breaker_cooldown_s=0.1)
    cfg.update(overrides)
    return Supervisor(SupervisionConfig(**cfg))


def make_pipeline(db, **cfg):
    """The port's Pipeline with the reference defaults (supervision and
    poison on) unless overridden, the CUDA engine's plain versions on the
    CPU."""
    config = PipelineConfig(
        pipeline_id=1, publication_name="pub",
        batch=BatchConfig(max_size_bytes=256 * 1024, max_fill_ms=50,
                          batch_engine=BatchEngine.CUDA, device="cpu"),
        **cfg)
    store, dest = NotifyingStore(), MemoryDestination()
    return Pipeline(config=config, store=store, destination=dest,
                    source_factory=lambda: FakeSource(db)), store, dest


class TestHeartbeat:
    def test_beat_updates_progress_clock_only_on_change(self):
        sup = fast_supervisor()
        hb = sup.register("c")
        hb.beat(progress=("lsn", 1), busy=True)
        t1 = hb.progress_at
        time.sleep(0.01)
        hb.beat(progress=("lsn", 1), busy=True)  # same token
        assert hb.progress_at == t1
        hb.beat(progress=("lsn", 2), busy=True)
        assert hb.progress_at > t1

    def test_register_replaces_and_unregister_removes(self):
        sup = fast_supervisor()
        a = sup.register("c")
        b = sup.register("c")
        assert sup.registry.get("c") is b and a is not b
        b.close()
        assert sup.registry.get("c") is None

    async def test_beat_while_waiting_keeps_fresh_and_returns(self):
        sup = fast_supervisor()
        hb = sup.register("c")

        async def slow():
            await asyncio.sleep(0.12)
            return 42

        assert await beat_while_waiting(hb, slow(), interval_s=0.02) == 42
        assert hb.age() < 0.1  # beats happened during the park
        assert sup.sweep_once() == []  # no hang despite the 0.1s deadline

    def test_beats_from_another_thread_are_seen(self):
        """The decode worker beats from its own thread while the event
        loop sweeps: the publish path takes no lock and the sweep reads
        whatever the last beat left."""
        sup = fast_supervisor(hang_deadline_s=10.0)
        hb = sup.register("decode:cdc-t")

        def worker():
            for i in range(200):
                hb.beat(progress=("completed", i), busy=True)

        th = threading.Thread(target=worker)
        th.start()
        th.join()
        assert hb.progress == ("completed", 199) and hb.beats == 200
        assert sup.sweep_once() == []


class TestDetection:
    def test_hang_detected_on_stale_heartbeat(self):
        sup = fast_supervisor()
        sup.register("apply")
        time.sleep(0.12)
        events = sup.sweep_once()
        assert [e.kind for e in events] == ["hang"]
        assert sup.health.state is HealthState.DEGRADED

    def test_stall_detected_only_when_busy(self):
        sup = fast_supervisor(hang_deadline_s=10.0)
        hb = sup.register("apply")
        hb.beat(progress=("lsn", 7), busy=False)
        time.sleep(0.07)
        hb.beat(progress=("lsn", 7), busy=False)  # idle: parked clock
        assert sup.sweep_once() == []
        hb.beat(progress=("lsn", 7), busy=True)
        time.sleep(0.07)
        hb.beat(progress=("lsn", 7), busy=True)  # busy + frozen = stall
        events = sup.sweep_once()
        assert [e.kind for e in events] == ["stall"]

    def test_progress_change_resets_stall_clock(self):
        sup = fast_supervisor(hang_deadline_s=10.0)
        hb = sup.register("apply")
        hb.beat(progress=1, busy=True)
        time.sleep(0.07)
        hb.beat(progress=2, busy=True)  # advanced: no stall
        assert sup.sweep_once() == []

    def test_work_driven_component_idle_staleness_is_not_a_hang(self):
        sup = fast_supervisor()
        hb = sup.register("decode:cdc-1")  # hang_requires_busy default
        hb.beat(progress=1, busy=False)
        time.sleep(0.12)
        assert sup.sweep_once() == []  # idle decode pipeline: fine
        hb.beat(progress=1, busy=True)
        time.sleep(0.12)
        kinds = {e.kind for e in sup.sweep_once()}
        assert "hang" in kinds  # busy + stale = wedged

    def test_recovery_clears_reason_back_to_healthy(self):
        sup = fast_supervisor()
        hb = sup.register("apply")
        time.sleep(0.12)
        sup.sweep_once()
        assert sup.health.state is HealthState.DEGRADED
        hb.beat(progress=1)
        assert sup.sweep_once() == []
        assert sup.health.state is HealthState.HEALTHY

    def test_unregistered_component_reason_is_dropped(self):
        sup = fast_supervisor()
        hb = sup.register("table_sync:1")
        time.sleep(0.12)
        sup.sweep_once()
        assert sup.health.state is HealthState.DEGRADED
        hb.close()  # worker exited; its anomaly leaves with it
        sup.sweep_once()
        assert sup.health.state is HealthState.HEALTHY


def _staged(n_rows: int = 64):
    from etl_tpu_torch.ops.staging import stage_copy_chunk

    line = b"\t".join(str(10 + i).encode() for i in range(3))
    return stage_copy_chunk((line + b"\n") * n_rows, 3)


def _schema():
    from etl_tpu_torch.models import (ColumnSchema, Oid,
                                      ReplicatedTableSchema, TableName,
                                      TableSchema)

    return ReplicatedTableSchema.with_all_columns(TableSchema(
        1, TableName("etl", "sup_degrade"),
        tuple(ColumnSchema(f"c{i}", Oid.INT8) for i in range(3))))


class TestEscalation:
    def test_restart_callback_fired_with_backoff(self):
        sup = fast_supervisor(restart_backoff_s=0.2)
        restarts = []
        sup.register("apply", restartable=True,
                     on_restart=lambda: restarts.append(1))
        time.sleep(0.12)
        events = sup.sweep_once()
        assert [e.kind for e in events] == ["hang", "restart"]
        assert restarts == [1]
        # the restart reset the clocks: the next sweep is quiet, and even
        # a re-detection within the backoff window must not re-fire
        assert sup.sweep_once() == []
        time.sleep(0.12)
        events = sup.sweep_once()
        assert [e.kind for e in events] == ["hang"]  # backoff: no restart
        assert restarts == [1]

    def test_stall_detected_classifies_timed_for_worker_retry(self):
        e = EtlError(ErrorKind.STALL_DETECTED, "watchdog")
        assert retry_directive(e).kind is RetryKind.TIMED

    def test_device_degrade_after_repeated_decode_detections(self):
        sup = fast_supervisor(device_degrade_threshold=2)
        hb = sup.register("decode:cdc-9")
        assert not engine.host_oracle_forced()
        for _ in range(2):
            hb.beat(progress=1, busy=True)
            time.sleep(0.12)
            sup.sweep_once()
        assert engine.host_oracle_forced()
        assert "device-degraded" in sup.health.reasons
        assert [e.kind for e in sup.events].count("degrade") == 1
        engine.clear_forced_oracle()
        sup.sweep_once()  # cooldown lapsed: reason lifts itself
        assert "device-degraded" not in sup.health.reasons

    def test_degrade_lifts_itself_after_the_cooldown(self):
        sup = fast_supervisor(device_degrade_threshold=1,
                              device_degrade_cooldown_s=0.15)
        hb = sup.register("decode:copy:1:p0")
        hb.beat(progress=1, busy=True)
        time.sleep(0.12)
        sup.sweep_once()
        assert engine.host_oracle_forced()
        hb.close()
        time.sleep(0.2)
        assert not engine.host_oracle_forced()
        sup.sweep_once()
        assert "device-degraded" not in sup.health.reasons
        assert sup.health.state is HealthState.HEALTHY

    def test_non_decode_detections_never_degrade(self):
        sup = fast_supervisor(device_degrade_threshold=1)
        hb = sup.register("apply")
        hb.beat(progress=1, busy=True)
        time.sleep(0.12)
        sup.sweep_once()
        assert not engine.host_oracle_forced()

    def test_forced_oracle_reroutes_decode(self):
        """On the port's DeviceDecoder: the forced state routes every
        batch to the host oracle, counted as oracle-routed rows, and the
        degraded batch equals the undegraded one."""
        from etl_tpu_torch.telemetry.metrics import (
            ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL, registry)

        staged = _staged(64)
        dec = engine.DeviceDecoder(_schema(), device="cpu")
        assert dec._route(staged)[0] == "device"
        want = dec.decode(staged)
        engine.force_host_oracle(30.0)
        try:
            before = registry.get_counter(ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL)
            assert dec._route(staged)[0] == "oracle"
            assert registry.get_counter(
                ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL) == before + 64
            got = dec.decode(staged)  # the degraded path still decodes
        finally:
            engine.clear_forced_oracle()
        assert dec._route(staged)[0] == "device"
        assert got.num_rows == want.num_rows == 64
        for a, b in zip(got.columns, want.columns):
            assert np.array_equal(a.data, b.data)
            assert np.array_equal(a.validity, b.validity)

    def test_small_rows_counted_only_when_the_device_is_free(self):
        """`routed_small_rows` counts the rows routed to the oracle for
        their batch's size alone: a batch below `device_min_rows` adds
        its rows, a batch at the floor and a forced batch add none."""
        from etl_tpu_torch.telemetry.metrics import (
            ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL, registry)

        dec = engine.DeviceDecoder(_schema(), device="cpu")
        small = engine.routed_small_rows
        oracle = registry.get_counter(ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL)
        assert dec._route(_staged(63))[0] == "oracle"
        assert dec._route(_staged(64))[0] == "device"
        assert engine.routed_small_rows == small + 63
        engine.force_host_oracle(30.0)
        assert dec._route(_staged(63))[0] == "oracle"
        assert dec._route(_staged(64))[0] == "oracle"
        assert engine.routed_small_rows == small + 63
        assert registry.get_counter(
            ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL) == oracle + 63 + 63 + 64

    def test_no_device_route_counted_after_the_force(self):
        """`_route` holds the routing lock across its check of the forced
        state and its counters: once `force_host_oracle` returns, the
        device-routed batches and rows stay flat, with routes racing it
        from other threads."""
        from etl_tpu_torch.telemetry.metrics import (
            ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL, registry)

        staged = _staged(64)
        dec = engine.DeviceDecoder(_schema(), device="cpu")
        stop = threading.Event()

        def route():
            while not stop.is_set():
                dec._route(staged)

        workers = [threading.Thread(target=route) for _ in range(4)]
        for w in workers:
            w.start()
        try:
            time.sleep(0.02)
            engine.force_host_oracle(30.0)
            batches = engine.routed_device_batches
            rows = registry.get_counter(ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL)
            time.sleep(0.05)
            assert engine.routed_device_batches == batches > 0
            assert registry.get_counter(
                ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL) == rows
        finally:
            stop.set()
            for w in workers:
                w.join()
            engine.clear_forced_oracle()

    def test_forced_oracle_expires_on_its_own(self):
        engine.force_host_oracle(0.05)
        assert engine.host_oracle_forced()
        time.sleep(0.08)
        assert not engine.host_oracle_forced()


class TestHealthStateMachine:
    def test_reason_driven_transitions_and_listeners(self):
        m = HealthStateMachine()
        seen = []
        m.add_listener(lambda old, new, why: seen.append(new.value))
        m.set_reason("x", "bad")
        m.set_reason("y", "worse")
        m.clear_reason("x")
        assert m.state is HealthState.DEGRADED
        m.clear_reason("y")
        assert m.state is HealthState.HEALTHY
        assert seen == ["degraded", "healthy"]

    def test_fault_is_sticky_until_reset(self):
        m = HealthStateMachine()
        m.fault("apply worker failed permanently")
        m.clear_reason("anything")
        assert m.state is HealthState.FAULTED
        m.set_reason("x", "bad")
        assert m.state is HealthState.FAULTED
        m.reset()
        assert m.state is HealthState.HEALTHY

    def test_snapshot_shape(self):
        m = HealthStateMachine()
        m.set_reason("component:apply", "stall")
        snap = m.snapshot()
        assert snap["state"] == "degraded"
        assert snap["reasons"] == {"component:apply": "stall"}
        assert snap["transitions"][-1]["state"] == "degraded"


class TestCircuitBreaker:
    def test_trips_open_after_consecutive_failures_and_half_opens(self):
        b = CircuitBreaker("m", failure_threshold=3, cooldown_s=0.05)
        for _ in range(2):
            b.record_failure()
        b.before_call()  # still closed
        b.record_failure()
        assert b.state is BreakerState.OPEN
        with pytest.raises(EtlError) as ei:
            b.before_call()
        assert ErrorKind.DESTINATION_UNAVAILABLE in ei.value.kinds()
        time.sleep(0.06)
        b.before_call()  # cooldown lapsed: half-open trial admitted
        assert b.state is BreakerState.HALF_OPEN
        with pytest.raises(EtlError):
            b.before_call()  # only ONE trial at a time
        b.record_success()
        assert b.state is BreakerState.CLOSED

    def test_half_open_failure_reopens(self):
        b = CircuitBreaker("m", failure_threshold=1, cooldown_s=0.05)
        b.record_failure()
        assert b.state is BreakerState.OPEN
        time.sleep(0.06)
        b.before_call()
        b.record_failure()
        assert b.state is BreakerState.OPEN

    def test_cancelled_trial_releases_slot_instead_of_wedging(self):
        b = CircuitBreaker("m", failure_threshold=1, cooldown_s=0.05)
        b.record_failure()
        time.sleep(0.06)
        b.before_call()  # the admitted trial...
        b.abort_call()   # ...is cancelled with no verdict
        b.before_call()  # next call may trial again
        b.record_success()
        assert b.state is BreakerState.CLOSED

    async def test_cancelled_supervised_write_aborts_trial(self):
        b = CircuitBreaker("m", failure_threshold=1, cooldown_s=0.01)
        b.record_failure()
        time.sleep(0.02)
        dest = SupervisedDestination(_NeverReturns(), timeout_s=30.0,
                                     breaker=b)
        task = asyncio.ensure_future(dest.write_events([]))
        await asyncio.sleep(0.01)
        assert b._trial_in_flight
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        assert not b._trial_in_flight  # slot released, not wedged

    def test_success_resets_consecutive_count(self):
        b = CircuitBreaker("m", failure_threshold=3)
        b.record_failure()
        b.record_failure()
        b.record_success()
        b.record_failure()
        b.record_failure()
        assert b.state is BreakerState.CLOSED

    def test_breaker_open_is_worker_retryable_not_writer_retryable(self):
        from etl_tpu_torch.retry import RetryPolicy, WORKER_TRANSIENT_KINDS

        e = EtlError(ErrorKind.DESTINATION_UNAVAILABLE, "open")
        writer = RetryPolicy()
        worker = RetryPolicy(transient_kinds=WORKER_TRANSIENT_KINDS)
        assert writer.classify(e) is RetryKind.MANUAL
        assert worker.classify(e) is RetryKind.TIMED


class _NeverReturns:
    """Destination whose write never resolves (the eternal-await bug the
    op timeout bounds)."""

    async def startup(self):
        return None

    async def write_events(self, events):
        await asyncio.sleep(3600)

    async def write_table_rows(self, schema, batch):
        await asyncio.sleep(3600)

    async def drop_table(self, table_id, schema=None):
        return None

    async def truncate_table(self, table_id):
        return None

    async def shutdown(self):
        return None


class TestSupervisedDestination:
    async def test_op_timeout_surfaces_classified_etl_error(self):
        from etl_tpu_torch.telemetry.metrics import (
            ETL_DESTINATION_OP_TIMEOUTS_TOTAL, registry)

        sup = fast_supervisor()
        dest = SupervisedDestination(_NeverReturns(), timeout_s=0.05,
                                     breaker=sup.breaker("never"))
        with pytest.raises(EtlError) as ei:
            await dest.write_events([])
        assert ErrorKind.TIMEOUT in ei.value.kinds()
        assert registry.get_counter(ETL_DESTINATION_OP_TIMEOUTS_TOTAL,
                                    {"op": "write_events"}) >= 1

    async def test_flush_timeout_bounded(self):
        from etl_tpu_torch.destinations.base import WriteAck

        class HeldAck:
            async def startup(self):
                return None

            async def write_events(self, events):
                ack, _fut = WriteAck.accepted()  # never resolved
                return ack

        dest = SupervisedDestination(HeldAck(), timeout_s=0.05)
        ack = await dest.write_events([])
        with pytest.raises(EtlError) as ei:
            await ack.wait_durable()
        assert ErrorKind.TIMEOUT in ei.value.kinds()

    async def test_open_breaker_sheds_before_calling_inner(self):
        calls = []

        class Counting(_NeverReturns):
            async def write_events(self, events):
                calls.append(1)
                raise EtlError(ErrorKind.DESTINATION_FAILED, "down")

        sup = fast_supervisor(breaker_failure_threshold=2,
                              breaker_cooldown_s=30.0)
        dest = SupervisedDestination(Counting(), timeout_s=1.0,
                                     breaker=sup.breaker("c"))
        for _ in range(2):
            with pytest.raises(EtlError):
                await dest.write_events([])
        assert sup.breaker("c").state is BreakerState.OPEN
        with pytest.raises(EtlError) as ei:
            await dest.write_events([])
        assert ErrorKind.DESTINATION_UNAVAILABLE in ei.value.kinds()
        assert len(calls) == 2  # the shed call never reached the sink
        # non-closed breaker holds a degraded health reason each sweep
        sup.sweep_once()
        assert sup.health.state is HealthState.DEGRADED

    async def test_durable_write_closes_breaker_and_passes_through(self):
        sup = fast_supervisor()
        inner = MemoryDestination()
        dest = SupervisedDestination(inner, timeout_s=1.0,
                                     breaker=sup.breaker("m"),
                                     heartbeat=sup.register("destination"))
        await dest.startup()
        ack = await dest.write_events([])
        await ack.wait_durable()
        assert inner.started
        assert sup.breaker("m").state is BreakerState.CLOSED
        assert dest.telemetry_name == "MemoryDestination"

    def test_forwards_the_inner_egress_encoder(self):
        """A departure from the reference, whose wrapper hides the
        encoder: under the default config the decoders render the inner
        sink's text."""
        from etl_tpu_torch import bench
        from etl_tpu_torch.destinations.base import egress_encoder

        config = PipelineConfig(pipeline_id=1, publication_name="p")
        assert egress_encoder(config, SupervisedDestination(
            bench._tsv_destination())) == "tsv"
        assert egress_encoder(config, SupervisedDestination(
            MemoryDestination())) is None


class TestPipelineIntegration:
    async def test_pipeline_wraps_destination_and_starts_supervisor(self):
        db = make_db()
        pipeline, store, dest = make_pipeline(db)
        assert pipeline.supervisor is not None
        assert not pipeline.supervisor.started
        await pipeline.start()
        assert pipeline.supervisor.started
        assert pipeline.active_destination.inner is dest
        await wait_ready(store, ACCOUNTS)
        snap = pipeline.health_snapshot()
        assert snap["health"]["state"] in ("healthy", "degraded")
        assert "apply" in snap["components"]
        assert "memory_monitor" in snap["components"]
        assert "MemoryDestination" in snap["breakers"]
        await pipeline.shutdown_and_wait()

    async def test_fatal_apply_error_faults_health(self):
        from etl_tpu_torch.postgres.fake import FakeDatabase

        db = FakeDatabase()  # publication never created -> fatal at start
        config = PipelineConfig(pipeline_id=1, publication_name="nope",
                                batch=BatchConfig(device="cpu"))
        pipeline = Pipeline(config=config, store=NotifyingStore(),
                            destination=MemoryDestination(),
                            source_factory=lambda: FakeSource(db))
        with pytest.raises(EtlError):
            await pipeline.start()
        # start() failed before the apply worker spawned: health surface
        # still answers (starting), it just never started
        assert not pipeline.supervisor.started

    async def test_apply_worker_exhausted_retries_faults_health(self):
        """The apply worker dies on a permanent error: `wait()` marks the
        health FAULTED with the cause."""
        db = make_db()
        pipeline, store, _ = make_pipeline(
            db, apply_retry=RetryConfig(max_attempts=1, initial_delay_ms=1,
                                        max_delay_ms=2))
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        failpoints.arm_error(failpoints.ON_PROGRESS_STORE,
                             ErrorKind.CONFIG_INVALID, times=1)
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["9", "x", "1"])
        with pytest.raises(EtlError):
            await asyncio.wait_for(pipeline.wait(), 10)
        assert pipeline.supervisor.health.state is HealthState.FAULTED

    async def test_supervision_disabled_runs_unwrapped(self):
        db = make_db()
        pipeline, store, dest = make_pipeline(
            db, supervision=SupervisionConfig(enabled=False))
        assert pipeline.supervisor is None
        assert pipeline.active_destination is dest
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        assert pipeline.health_snapshot()["state"] == "unsupervised"
        await pipeline.shutdown_and_wait()

    async def test_decode_heartbeat_registered_and_beating(self):
        """A CDC run through the CUDA engine registers a `decode:cdc-N`
        component whose worker-thread beats carry ("completed", n)."""
        db = make_db()
        pipeline, store, dest = make_pipeline(db)
        await pipeline.start()
        try:
            await wait_ready(store, ACCOUNTS)
            async with db.transaction() as tx:
                for i in range(100, 200):
                    tx.insert(ACCOUNTS, [str(i), "n", str(i)])
            await _wait_for(lambda: 199 in _account_ids(dest))
            comps = pipeline.supervisor.snapshot()["components"]
            dec = [n for n in comps if n.startswith("decode:cdc-")]
            assert dec, sorted(comps)
            hb = pipeline.supervisor.registry.get(dec[0])
            assert hb.progress[0] == "completed" and hb.progress[1] >= 1
        finally:
            await pipeline.shutdown_and_wait()
        # shutdown closes the pipeline and unregisters its heartbeat
        assert not any(hb.name.startswith("decode:")
                       for hb in pipeline.supervisor.registry.components())


class TestRestartLeavesNoWorker:
    async def test_apply_restart_then_shutdown_leaves_no_port_worker(self):
        """A stall of the apply loop (the APPLY_FRAME_READ stall site) is
        detected, the supervisor restarts the apply worker (a new apply
        loop with a new decode pipeline), CDC resumes, and after shutdown
        no decode worker created during the run survives."""
        from etl_tpu_torch.ops.pipeline import worker_threads

        before = set(worker_threads())
        db = make_db()
        pipeline, store, dest = make_pipeline(
            db, supervision=SupervisionConfig(
                check_interval_s=0.02, stall_deadline_s=0.3,
                hang_deadline_s=0.6, restart_backoff_s=0.1),
            apply_retry=RetryConfig(max_attempts=10, initial_delay_ms=10,
                                    max_delay_ms=50),
            wal_sender_timeout_ms=1_000)
        restarts = []
        pipeline.supervisor.add_listener(
            lambda ev: restarts.append(ev.component)
            if ev.kind == "restart" else None)
        await pipeline.start()
        try:
            await wait_ready(store, ACCOUNTS)
            async with db.transaction() as tx:
                for i in range(100, 180):
                    tx.insert(ACCOUNTS, [str(i), "a", str(i)])
            await _wait_for(lambda: 179 in _account_ids(dest))
            failpoints.arm_stall(failpoints.APPLY_FRAME_READ,
                                 duration_s=5.0)
            async with db.transaction() as tx:
                for i in range(200, 280):
                    tx.insert(ACCOUNTS, [str(i), "b", str(i)])
            await _wait_for(lambda: "apply" in restarts, timeout=10)
            await _wait_for(lambda: 279 in _account_ids(dest), timeout=15)
        finally:
            failpoints.disarm_all()
            await pipeline.shutdown_and_wait()
        left = [t for t in worker_threads() if t not in before]
        deadline = time.monotonic() + 5
        while left and time.monotonic() < deadline:
            time.sleep(0.02)
            left = [t for t in left if t.is_alive()]
        assert left == []


class TestDecodePipelineShrinkPath:
    """tests/test_backpressure.py's shrink path on the port's
    DecodePipeline, with the memory monitor's heartbeat beating once per
    sample."""

    @staticmethod
    def make_monitor(readings: list[int], heartbeat=None):
        """Monitor over a scripted RSS sequence (last value repeats)."""
        from etl_tpu_torch.config import MemoryBackpressureConfig
        from etl_tpu_torch.runtime.backpressure import MemoryMonitor

        seq = list(readings)

        def reader() -> int:
            return seq.pop(0) if len(seq) > 1 else seq[0]

        return MemoryMonitor(
            MemoryBackpressureConfig(activate_ratio=0.85, resume_ratio=0.75,
                                     refresh_interval_ms=10),
            limit_bytes=1000, rss_reader=reader, heartbeat=heartbeat)

    async def test_pipeline_degrades_to_serial_under_pressure(self):
        from etl_tpu_torch.ops.pipeline import DecodePipeline

        sup = fast_supervisor()
        hb = sup.register("memory_monitor")
        mon = self.make_monitor([900, 700], heartbeat=hb)
        mon.sample_once()  # pressure on
        assert hb.progress == ("samples", 1)
        decoder = engine.DeviceDecoder(_schema(), device="cpu",
                                       device_min_rows=1 << 30)
        pipe = DecodePipeline(window=3, monitor=mon)
        try:
            assert pipe.effective_window == 1
            handles = [pipe.submit(decoder, _staged(32)) for _ in range(4)]
            # serial drain (the copy path's stance when the window is 1)
            for h in handles:
                batch = await asyncio.to_thread(h.result)
                assert batch.num_rows == 32
            assert pipe.in_flight == 0
            mon.sample_once()  # resume
            assert pipe.effective_window == 3
            assert hb.progress == ("samples", 2)
        finally:
            pipe.close()
            assert pipe.join(5.0)

    async def test_copy_drain_threshold_follows_effective_window(self):
        from etl_tpu_torch.ops.pipeline import DecodePipeline

        mon = self.make_monitor([900])
        mon.sample_once()
        decoder = engine.DeviceDecoder(_schema(), device="cpu",
                                       device_min_rows=1 << 30)
        pipe = DecodePipeline(window=3, monitor=mon)
        in_flight: list = []
        max_seen = 0
        try:
            for _ in range(5):
                in_flight.append(pipe.submit(decoder, _staged(16)))
                while len(in_flight) > pipe.effective_window:
                    h = in_flight.pop(0)
                    await asyncio.to_thread(h.result)
                max_seen = max(max_seen, len(in_flight))
            assert max_seen == 1  # shrunk: never more than one queued
        finally:
            for h in in_flight:
                await asyncio.to_thread(h.result)
            pipe.close()
            assert pipe.join(5.0)

    async def test_monitor_heartbeat_closes_with_the_monitor(self):
        sup = fast_supervisor()
        hb = sup.register("memory_monitor")
        mon = self.make_monitor([100], heartbeat=hb)
        mon.start()
        await asyncio.sleep(0.1)  # 10 ms sampling: several beats
        await mon.stop()
        assert hb.beats >= 2
        assert sup.registry.get("memory_monitor") is None


class TestDecodeHeartbeat:
    """The decode pipeline's heartbeat: beaten from the worker thread
    with ("completed", n), busy while batches are in flight, closed with
    the pipeline."""

    def test_worker_beats_completed_count(self):
        from etl_tpu_torch.ops.pipeline import DecodePipeline

        sup = fast_supervisor(hang_deadline_s=10.0, stall_deadline_s=10.0)
        hb = sup.register("decode:cdc-x")
        decoder = engine.DeviceDecoder(_schema(), device="cpu")
        pipe = DecodePipeline(window=3, heartbeat=hb, name="hb")
        try:
            handles = [pipe.submit(decoder, _staged(64)) for _ in range(3)]
            for h in handles:
                assert h.result().num_rows == 64
            assert hb.progress == ("completed", 3)
            assert hb.beats >= 6  # worker after each job + each fetch
        finally:
            pipe.close()
            assert pipe.join(5.0)
        assert sup.registry.get("decode:cdc-x") is None

    def test_held_fetch_reads_as_a_stall_and_degrades(self):
        """A fetch held past the stall deadline in a thread (the copy
        path fetches in `asyncio.to_thread`) leaves the decode heartbeat
        busy with its progress frozen: the sweep degrades the engine."""
        from etl_tpu_torch.ops.pipeline import DecodePipeline

        sup = fast_supervisor(hang_deadline_s=10.0, stall_deadline_s=0.1,
                              device_degrade_threshold=1,
                              device_degrade_cooldown_s=30.0)
        hb = sup.register("decode:copy:1:p0")
        decoder = engine.DeviceDecoder(_schema(), device="cpu")
        pipe = DecodePipeline(window=3, heartbeat=hb, name="stall")
        spec = failpoints.arm_stall(failpoints.PIPELINE_FETCH,
                                    duration_s=5.0)
        try:
            h = pipe.submit(decoder, _staged(64))
            out: list = []
            th = threading.Thread(target=lambda: out.append(h.result()))
            th.start()
            deadline = time.monotonic() + 5
            while not engine.host_oracle_forced() \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
                sup.sweep_once()
            assert engine.host_oracle_forced()
            assert "degrade" in [e.kind for e in sup.events]
            spec.release.set()
            th.join(5)
            assert out and out[0].num_rows == 64
            # degraded: the next batch takes the oracle route
            assert decoder._route(_staged(64))[0] == "oracle"
        finally:
            failpoints.disarm_all()
            pipe.close()
            assert pipe.join(5.0)


class TestNoOomFallback:
    def test_device_oom_failpoint_has_no_degrade_in_the_port(self):
        """The reference degrades a batch to the oracle when its
        ENGINE_DEVICE_OOM failpoint fires (ops/pipeline.py:655-668). The
        port does not: the only way off the kernel is the supervisor's
        degrade, and a failing device step fails its batch. The port's
        OOM site fires on the device route, and a firing fails the batch
        as any device error does: no oracle route."""
        from etl_tpu_torch.ops import pipeline as port_pipeline

        # the reference's OOM site, armed, degrades nothing in the port
        failpoints.arm_error(failpoints.ENGINE_DEVICE_OOM,
                             ErrorKind.DEVICE_UNAVAILABLE, times=5)
        failpoints.arm_error(failpoints.PIPELINE_DISPATCH,
                             ErrorKind.DEVICE_UNAVAILABLE, times=1)
        pipe = port_pipeline.DecodePipeline(window=2, name="oom")
        try:
            h = pipe.submit(engine.DeviceDecoder(_schema(), device="cpu"),
                            _staged(64))
            with pytest.raises(EtlError) as ei:
                h.result()
            assert ei.value.kind is ErrorKind.DEVICE_UNAVAILABLE
        finally:
            pipe.close()
            assert pipe.join(5.0)


class TestChipSmokePhase10Paths:
    """`chip_smoke.py` phase 10's runs on the CPU at a small size: the
    default config's stream and the held-fetch degrade, with every check
    they make on the card."""

    async def test_default_config_stream(self):
        from etl_tpu_torch import bench

        r = await bench.run_table_streaming(
            4_000, device="cpu", warmup_events=4_400, subsystems="default")
        assert r["ok"], {k: v for k, v in r.items() if k.endswith("_ok")}
        sv = r["supervision"]
        assert sv["started"] and sv["wrapped"]
        assert sv["health"] == "healthy" and sv["degrade_events"] == 0
        assert r["device_runs"] > 0

    async def test_tsv_stream_carries_device_text(self):
        """Phase 9(c)'s run under the default config: the
        SupervisedDestination forwards the TSV encoder, so device runs
        carry rendered text and every body equals the columnar oracle's."""
        from etl_tpu_torch import bench

        r = await bench.run_table_streaming(
            4_000, device="cpu", warmup_events=4_400, tsv=True,
            subsystems="default")
        assert r["ok"] and r["supervision_ok"]
        assert r["device_runs"] == r["tsv"]["device_batches"] > 0
        t = r["tsv"]
        assert t["bodies_identical"] and t["device_runs_carried_text"]
        assert t["used_device_when_carried"] and t["device_writes"] > 0

    async def test_held_copy_fetch_degrades_and_lifts(self):
        from etl_tpu_torch import bench

        r = await bench.run_device_degrade(20_000, 5_000, device="cpu")
        assert r["degrade_fired"]
        assert r["degrade_component"].startswith("decode:copy:")
        wd = r["while_degraded"]
        assert wd["device_rows"] == 0 and wd["device_batches"] == 0
        assert wd["oracle_rows"] > 0
        # the plain versions launch nothing; the device route still counts
        assert r["device_batches"] > 0 and r["k1_per_device_batch"]
        assert r["lifted"] and r["after_lift"]["oracle_rows"] == 0
        assert r["copy_ok"] and r["cdc_ok"] and r["ok"]
        assert not engine.host_oracle_forced()
