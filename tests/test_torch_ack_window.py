"""The port's windowed destination ack, held to the reference's
tests/test_ack_window.py `TestApplyLoopBreakerHold` and `TestEndToEnd`
(the window's unit classes are in tests/test_torch_runtime_units.py):
the apply loop's dispatch hold under an open breaker, the ack-latency A/B
harness at miniature scale (`etl_tpu_torch.benchmarks.harness.
run_ack_latency`) on the per-tuple engine and on the CUDA engine (the
kernels' plain versions here), the drain on shutdown, and the
K-in-flight hard-kill scenario (`etl_tpu_torch.chaos.ack_window`) with
the decoder's floor at one row, so that every batch takes the device
route. Parity: on the per-tuple engine the port's delivery digest is the
reference's, for the same backlog. Tolerance: none; the wall-clock
speedup is asserted only by the smoke gate, as in the reference.
"""

from __future__ import annotations

import asyncio

from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission


def _hygiene():
    engine.clear_forced_oracle()
    failpoints.disarm_all()
    reset_global_admission()


class TestApplyLoopBreakerHold:
    def test_dispatch_blocked_matrix(self):
        from types import SimpleNamespace

        from etl_tpu_torch.runtime.apply_loop import ApplyLoop
        from etl_tpu_torch.supervision.breaker import BreakerState

        class FakeWindow:
            def __init__(self, empty, can):
                self.is_empty = empty
                self._can = can

            def can_dispatch(self, n):
                return self._can

        def ns(empty, can, breaker_state):
            breaker = None if breaker_state is None else \
                SimpleNamespace(state=breaker_state)
            return SimpleNamespace(
                _ack_window=FakeWindow(empty, can),
                destination=SimpleNamespace(breaker=breaker),
                assembler=SimpleNamespace(size_bytes=10),
                _flush_threshold=lambda: 10,
                _breaker_open=lambda s=None: ApplyLoop._breaker_open(
                    SimpleNamespace(destination=SimpleNamespace(
                        breaker=breaker))))

        # window full → blocked regardless of breaker
        assert ApplyLoop._dispatch_blocked(ns(False, False, None))
        # room + closed breaker → dispatch
        assert not ApplyLoop._dispatch_blocked(
            ns(True, True, BreakerState.CLOSED))
        # OPEN breaker + in-flight acks → hold (drain before shedding)
        assert ApplyLoop._dispatch_blocked(
            ns(False, True, BreakerState.OPEN))
        # OPEN breaker + EMPTY window → dispatch (the shed path)
        assert not ApplyLoop._dispatch_blocked(
            ns(True, True, BreakerState.OPEN))


class TestEndToEnd:
    async def test_window1_equivalence_and_overlap(self):
        """The A/B harness at miniature scale: byte-identical delivery
        digests across window depths, the one-in-flight contract at
        window=1, provable overlap at the default window (the gated
        version runs in `bench --smoke`)."""
        from etl_tpu_torch.benchmarks import harness

        out = await harness.run_ack_latency(ack_ms=5.0, n_events=300,
                                            tx_size=20, device="cpu")
        assert out["engine"] == "cpu"
        assert out["failures"] == []
        assert out["windowed"]["delivery_digest"] \
            == out["window1"]["delivery_digest"]
        assert out["window1"]["max_acks_pending"] <= 1
        assert out["windowed"]["max_acks_pending"] >= 2
        assert out["windowed"]["ack_overlap_seconds"] > 0

    async def test_window1_equivalence_on_the_device_route(self):
        """The same A/B on the CUDA engine with every batch on the device
        route: the columnar digests agree across window depths."""
        from etl_tpu_torch.benchmarks import harness
        from etl_tpu_torch.chaos.runner import device_floor

        with device_floor(1):
            out = await harness.run_ack_latency(
                ack_ms=5.0, n_events=300, tx_size=20, engine="cuda",
                device="cpu")
        _hygiene()
        assert out["failures"] == []
        assert out["windowed"]["delivery_digest"] \
            == out["window1"]["delivery_digest"]
        assert out["windowed"]["device_batches"] > 0
        assert out["window1"]["device_batches"] > 0
        # on the CPU nothing launches: the plain versions decode
        assert out["windowed"]["launches"] == 0
        assert out["window1"]["max_acks_pending"] <= 1
        assert out["windowed"]["max_acks_pending"] >= 2

    async def test_digest_equals_the_reference(self):
        """Per-tuple engine: the port's delivery digest of the backlog is
        the reference's, row for row and coordinate for coordinate."""
        from etl_tpu.benchmarks import harness as ref_harness
        from etl_tpu_torch.benchmarks import harness

        port = await harness._ack_latency_run(4, 2.0, 200, 20, 2048, 10,
                                              "cpu", "cpu")
        ref = await ref_harness._ack_latency_run(4, 2.0, 200, 20, 2048, 10,
                                                 "cpu")
        assert port["delivery_digest"] == ref["delivery_digest"]

    async def test_drain_on_shutdown_waits_every_ack(self):
        """Shutdown with acks in flight: the drain must wait them out
        and persist durable progress for the full acked prefix."""
        from etl_tpu_torch.config import (BatchConfig, BatchEngine,
                                          PipelineConfig)
        from etl_tpu_torch.destinations import (DelayedAckDestination,
                                                MemoryDestination)
        from etl_tpu_torch.models import (ColumnSchema, InsertEvent, Oid,
                                          TableName, TableSchema)
        from etl_tpu_torch.models.table_state import TableStateType
        from etl_tpu_torch.postgres.fake import FakeDatabase, FakeSource
        from etl_tpu_torch.postgres.slots import apply_slot_name
        from etl_tpu_torch.runtime import Pipeline
        from etl_tpu_torch.store import NotifyingStore

        TID = 16395
        db = FakeDatabase()
        db.create_table(TableSchema(
            TID, TableName("public", "drain_t"),
            (ColumnSchema("id", Oid.INT8, nullable=False,
                          primary_key_ordinal=1),
             ColumnSchema("v", Oid.INT4))))
        db.create_publication("pub", [TID])
        store = NotifyingStore()
        inner = MemoryDestination()
        dest = DelayedAckDestination(inner, 0.15)
        pipeline = Pipeline(
            config=PipelineConfig(
                pipeline_id=1, publication_name="pub",
                batch=BatchConfig(max_size_bytes=512, max_fill_ms=10,
                                  batch_engine=BatchEngine.CPU,
                                  write_window=4)),
            store=store, destination=dest,
            source_factory=lambda: FakeSource(db))
        await pipeline.start()
        await asyncio.wait_for(
            store.notify_on(TID, TableStateType.READY), 60)
        last_commit = None
        for t in range(3):
            tx = db.transaction()
            for i in range(8):
                tx.insert(TID, [str(t * 8 + i + 1), str(i)])
            last_commit = await tx.commit()
        # writes reach the destination quickly; acks are still pending
        # when shutdown begins — the drain must wait them out
        while sum(1 for e in inner.events
                  if isinstance(e, InsertEvent)) < 24:
            await asyncio.sleep(0.005)
        assert dest.pending >= 1
        await pipeline.shutdown_and_wait()
        assert dest.pending == 0
        durable = await store.get_durable_progress(apply_slot_name(1))
        # the drain consumed every acked entry: durable covers the whole
        # stream (commit END of the last transaction ≥ its commit lsn)
        assert durable is not None and int(durable) >= int(last_commit)

    async def test_chaos_k_inflight_crash(self):
        """The tier-1 chaos gate: hard-kill with ≥ 2 acks in flight,
        zero-loss, dup budget = the window, monotonic durable LSN, no
        leaked worker or arena — every batch on the device route."""
        from etl_tpu_torch.chaos.ack_window import run_ack_window_crash
        from etl_tpu_torch.chaos.runner import device_floor

        before = engine.routed_device_batches
        with device_floor(1):
            run = await run_ack_window_crash(seed=11, device="cpu")
        _hygiene()
        assert run.ok, run.describe()
        assert run.acks_in_flight_at_kill >= 2
        assert run.max_acks_pending >= 2
        assert run.report.stats["max_duplication"] <= \
            run.report.stats["duplication_budget"]
        assert engine.routed_device_batches > before
