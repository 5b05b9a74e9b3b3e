"""Runtime units of the port: the cases of tests/test_backpressure.py,
tests/test_ack_window.py, tests/test_admission.py and
tests/test_runtime_units.py that exercise the modules the port copies
(backpressure, ack windows, the admission scheduler, the assembler, table
states, slots, copy planning, the memory store, the table cache and the
fake walsender), run against etl_tpu_torch on the CPU: the CUDA engine's
decoders take `device="cpu"` and run the kernels' plain versions. The
reference's supervision breaker, program store, autotune, chaos scenarios
(the multi-pipeline scenario) and replicator config are not ported, and
their cases stay with the reference."""

import asyncio
import threading
import time

import numpy as np
import pytest

from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.config import (MemoryBackpressureConfig, PipelineConfig,
                                  RetryConfig)
from etl_tpu_torch.destinations.base import WriteAck
from etl_tpu_torch.models import (ColumnSchema, EtlError, Lsn, Oid,
                                  ReplicatedTableSchema, RetryKind,
                                  TableName, TableSchema)
from etl_tpu_torch.models.errors import ErrorKind
from etl_tpu_torch.ops.engine import DeviceDecoder
from etl_tpu_torch.ops.pipeline import (AdmissionScheduler, DecodePipeline,
                                        reset_global_admission)
from etl_tpu_torch.ops.staging import stage_tuples
from etl_tpu_torch.postgres.codec.pgoutput import (TUPLE_NULL, TUPLE_TEXT,
                                                   TupleData)
from etl_tpu_torch.postgres.slots import (apply_slot_name, parse_slot_name,
                                          slots_for_pipeline,
                                          table_sync_slot_name)
from etl_tpu_torch.runtime.ack_window import AckWindow, CopyAckWindow
from etl_tpu_torch.runtime.backpressure import InFlightWindow, MemoryMonitor
from etl_tpu_torch.runtime.copy import plan_copy_partitions
from etl_tpu_torch.runtime.state import TableState, TableStateType
from etl_tpu_torch.store import MemoryStore
from etl_tpu_torch.telemetry.metrics import (
    ETL_DECODE_ADMISSION_BYPASS_GRANTS_TOTAL,
    ETL_DECODE_ADMISSION_GRANTS_TOTAL,
    ETL_DECODE_ADMISSION_STARVATION_GRANTS_TOTAL,
    ETL_DECODE_ADMISSION_WAIT_SECONDS, registry)
from tests.test_torch_decoder import assert_same_batch

CFG = MemoryBackpressureConfig(activate_ratio=0.85, resume_ratio=0.75,
                               refresh_interval_ms=10)
MB64 = 64 * 1024 * 1024


@pytest.fixture(autouse=True)
def _port_hygiene():
    """The port's own failpoints and process-wide admission scheduler
    are reset after every test (the conftest fixture covers the
    reference's only)."""
    yield
    failpoints.disarm_all()
    reset_global_admission()


def make_monitor(readings: list[int]) -> MemoryMonitor:
    """Monitor over a scripted RSS sequence (last value repeats)."""
    seq = list(readings)

    def reader() -> int:
        return seq.pop(0) if len(seq) > 1 else seq[0]

    return MemoryMonitor(CFG, limit_bytes=1000, rss_reader=reader)


async def _settle() -> None:
    """Give spawned window tasks a few loop cycles to progress."""
    for _ in range(6):
        await asyncio.sleep(0)


def _submitter(ack, log=None, name=None):
    async def submit():
        if log is not None:
            log.append(name)
        return ack

    return submit


def _drain_grant(sched, tenant):
    """Apply one grant's bookkeeping the way _acquire does (fairness-math
    unit tests drive _pick directly so thread timing can't blur the
    stride arithmetic)."""
    sched._vt = max(sched._vt, tenant._pass)
    tenant._pass += sched.STRIDE / sched._weight(tenant)
    tenant._grants += 1


def make_schema(cols):
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        1, TableName("public", "t"),
        tuple(ColumnSchema(f"c{i}", oid) for i, oid in enumerate(cols))))


def tuples_from_texts(rows):
    return [TupleData([TUPLE_NULL if v is None else TUPLE_TEXT for v in r],
                      [None if v is None else v.encode() for v in r])
            for r in rows]


def _staged_batch(n=128):
    return stage_tuples(
        tuples_from_texts([[str(i + 1), str(i * 3)] for i in range(n)]), 2)


def assert_batches_equal(got, want):
    assert_same_batch(want, got)


# ---- from tests/test_backpressure.py
class TestHysteresis:
    async def test_activates_at_085_resumes_only_below_075(self):
        mon = make_monitor([800, 860, 800, 760, 740, 740])
        assert mon.sample_once() is False  # 0.80: below activate
        assert mon.sample_once() is True   # 0.86: activated
        assert mon.sample_once() is True   # 0.80: inside the band — holds
        assert mon.sample_once() is True   # 0.76: still above resume
        assert mon.sample_once() is False  # 0.74: resumed
        assert mon.sample_once() is False

    async def test_activation_counted_once_per_episode(self):
        from etl_tpu_torch.telemetry.metrics import (
            ETL_MEMORY_BACKPRESSURE_ACTIVATIONS_TOTAL, registry)

        before = registry.get_counter(
            ETL_MEMORY_BACKPRESSURE_ACTIVATIONS_TOTAL)
        mon = make_monitor([900, 900, 900, 700, 900, 700])
        for _ in range(6):
            mon.sample_once()
        assert registry.get_counter(
            ETL_MEMORY_BACKPRESSURE_ACTIVATIONS_TOTAL) == before + 2

    async def test_resumed_event_pulses_waiters(self):
        mon = make_monitor([900, 900, 700, 700])
        mon.sample_once()
        assert mon.pressure
        waited = []

        async def waiter():
            await mon.wait_until_resumed()
            waited.append(True)

        t = asyncio.ensure_future(waiter())
        await asyncio.sleep(0)
        assert not waited
        mon.sample_once()  # still 900: no resume
        mon.sample_once()  # 700: resumes
        await asyncio.sleep(0.01)
        assert waited == [True]
        await t


# ---- from tests/test_backpressure.py
class TestExternalPause:
    async def test_pause_composes_with_memory_pressure(self):
        """Intake resumes only when BOTH the maintenance lease and the
        memory hysteresis clear — in either order."""
        mon = make_monitor([900, 900, 700, 700])
        mon.set_external_pause(True)
        assert mon.pressure  # paused with no memory pressure at all
        mon.sample_once()  # 900: memory pressure too
        mon.set_external_pause(False)
        assert mon.pressure  # memory episode still active
        mon.sample_once()  # 900
        mon.sample_once()  # 700: memory resumes -> fully clear
        assert not mon.pressure
        # other order: memory clears first, pause holds
        mon.set_external_pause(True)
        assert mon.pressure
        mon.set_external_pause(False)
        assert not mon.pressure

    async def test_pause_toggle_without_memory_pressure_pulses_event(self):
        mon = make_monitor([100])
        mon.sample_once()
        mon.set_external_pause(True)
        assert mon.pressure
        mon.set_external_pause(False)
        assert not mon.pressure
        await asyncio.wait_for(mon.wait_until_resumed(), 1)


# ---- from tests/test_backpressure.py
class TestInFlightWindowUnderPressure:
    async def test_effective_limit_shrinks_to_1_and_recovers(self):
        mon = make_monitor([900, 700])
        win = InFlightWindow(3, mon)
        assert win.effective_limit == 3
        mon.sample_once()  # 900: pressure
        assert win.effective_limit == 1
        mon.sample_once()  # 700: resumed
        assert win.effective_limit == 3

    async def test_acquire_blocks_at_shrunk_limit_until_resume(self):
        """With one slot held under pressure, a second acquire must park
        — and wake on the poll tick once the monitor resumes, with no
        explicit signal."""
        mon = make_monitor([900, 700])
        mon.sample_once()
        win = InFlightWindow(3, mon)
        win.acquire()
        acquired = threading.Event()
        t = threading.Thread(target=lambda: (win.acquire(),
                                             acquired.set()), daemon=True)
        t.start()
        assert not acquired.wait(0.15)  # parked at effective limit 1
        mon.sample_once()  # resume: limit back to 3
        assert acquired.wait(1.0)  # poll tick sees it, no notify needed
        t.join(1.0)
        assert len(win) == 2

    async def test_release_wakes_blocked_acquirer_under_pressure(self):
        mon = make_monitor([900])
        mon.sample_once()
        win = InFlightWindow(3, mon)
        win.acquire()
        acquired = threading.Event()
        t = threading.Thread(target=lambda: (win.acquire(),
                                             acquired.set()), daemon=True)
        t.start()
        assert not acquired.wait(0.1)
        win.release()  # serial handoff: one in flight at a time
        assert acquired.wait(1.0)
        t.join(1.0)

    async def test_bypass_valve_overshoots_instead_of_deadlocking(self):
        mon = make_monitor([900])
        mon.sample_once()
        win = InFlightWindow(3, mon)
        win.acquire()
        # a demanded-but-undispatched consumer: the window must overshoot
        win.acquire(bypass=lambda: True)
        assert len(win) == 2


# ---- from tests/test_backpressure.py
class TestDecodePipelineShrinkPath:
    async def test_pipeline_degrades_to_serial_under_pressure(self):
        """End-to-end shrink: under scripted RSS pressure the pipeline's
        effective window is 1 (serial decode), results stay correct, and
        the window recovers after resume."""
        from etl_tpu_torch.models import (ColumnSchema, Oid,
                                    ReplicatedTableSchema, TableName,
                                    TableSchema)
        from etl_tpu_torch.ops.engine import DeviceDecoder
        from etl_tpu_torch.ops.pipeline import DecodePipeline
        from etl_tpu_torch.ops.staging import stage_copy_chunk

        mon = make_monitor([900, 700])
        mon.sample_once()  # pressure on
        schema = ReplicatedTableSchema.with_all_columns(TableSchema(
            1, TableName("etl", "bp_shrink"),
            tuple(ColumnSchema(f"c{i}", Oid.INT8) for i in range(3))))
        decoder = DeviceDecoder(schema, device="cpu",
                                device_min_rows=1 << 30)
        line = b"\t".join(str(i).encode() for i in range(3))
        pipe = DecodePipeline(window=3, monitor=mon)
        try:
            assert pipe.effective_window == 1
            handles = [pipe.submit(decoder,
                                   stage_copy_chunk((line + b"\n") * 32, 3))
                       for _ in range(4)]
            # serial drain (the copy path's stance when the window is 1)
            for h in handles:
                batch = await asyncio.to_thread(h.result)
                assert batch.num_rows == 32
            assert pipe.in_flight == 0
            mon.sample_once()  # resume
            assert pipe.effective_window == 3
        finally:
            pipe.close()

    async def test_copy_drain_threshold_follows_effective_window(self):
        """The copy path drains ahead of `pipe.effective_window`
        (runtime/copy.py): under pressure that bound is 1, so at most one
        batch rides the window while another is being fetched."""
        from etl_tpu_torch.models import (ColumnSchema, Oid,
                                    ReplicatedTableSchema, TableName,
                                    TableSchema)
        from etl_tpu_torch.ops.engine import DeviceDecoder
        from etl_tpu_torch.ops.pipeline import DecodePipeline
        from etl_tpu_torch.ops.staging import stage_copy_chunk

        mon = make_monitor([900])
        mon.sample_once()
        schema = ReplicatedTableSchema.with_all_columns(TableSchema(
            1, TableName("etl", "bp_copy"),
            (ColumnSchema("c0", Oid.INT8),)))
        decoder = DeviceDecoder(schema, device="cpu",
                                device_min_rows=1 << 30)
        pipe = DecodePipeline(window=3, monitor=mon)
        in_flight: list = []
        max_seen = 0
        try:
            for _ in range(5):
                in_flight.append(pipe.submit(
                    decoder, stage_copy_chunk(b"1\n" * 16, 1)))
                while len(in_flight) > pipe.effective_window:
                    h = in_flight.pop(0)
                    await asyncio.to_thread(h.result)
                max_seen = max(max_seen, len(in_flight))
            assert max_seen == 1  # shrunk: never more than one queued
        finally:
            for h in in_flight:
                await asyncio.to_thread(h.result)
            pipe.close()


# ---- from tests/test_ack_window.py
class TestAckWindow:
    async def test_contiguous_prefix_holds_out_of_order_acks(self):
        w = AckWindow(4)
        pairs = [WriteAck.accepted() for _ in range(3)]
        entries = [w.dispatch(_submitter(ack), commit_end_lsn=Lsn(i + 1),
                              n_events=1, nbytes=10)
                   for i, (ack, _) in enumerate(pairs)]
        await _settle()
        # resolve the MIDDLE ack first: nothing may pop (the head is
        # still pending), and durability must never leapfrog
        pairs[1][1].set_result(None)
        await _settle()
        done, failure = w.pop_ready()
        assert done == [] and failure is None
        assert len(w) == 3
        # head resolves: exactly the head pops
        pairs[0][1].set_result(None)
        await _settle()
        done, failure = w.pop_ready()
        # the held-out-of-order entry pops WITH the head the moment the
        # prefix is contiguous
        assert [e.commit_end_lsn for e in done] == [Lsn(1), Lsn(2)]
        assert failure is None
        # tail resolves: window drains fully
        pairs[2][1].set_result(None)
        await _settle()
        done, failure = w.pop_ready()
        assert [e.commit_end_lsn for e in done] == [Lsn(3)]
        assert w.is_empty
        assert entries[0].n_events == 1

    async def test_out_of_order_completion_is_not_actionable(self):
        """Review regression: a successful non-head completion must not
        read as actionable (the select loop would spin against an empty
        pop until the head ack resolves) and its done task must leave
        the pending wait set; a FAILED non-head completion stays
        actionable (fail fast)."""
        w = AckWindow(4)
        pairs = [WriteAck.accepted() for _ in range(3)]
        for i, (ack, _) in enumerate(pairs):
            w.dispatch(_submitter(ack), commit_end_lsn=Lsn(i + 1),
                       n_events=1, nbytes=1)
        await _settle()
        assert not w.any_actionable()
        assert len(w.pending_tasks()) == 3
        pairs[1][1].set_result(None)  # middle resolves first
        await _settle()
        assert w.any_done()
        assert not w.any_actionable()  # held for contiguity: no action
        assert len(w.pending_tasks()) == 2  # done task leaves the waits
        pairs[0][1].set_result(None)  # head resolves: actionable now
        await _settle()
        assert w.any_actionable()
        done, failure = w.pop_ready()
        assert len(done) == 2 and failure is None
        pairs[2][1].set_exception(
            EtlError(ErrorKind.DESTINATION_FAILED, "late fail"))
        await _settle()
        # a FAILED completion is always actionable, head or not
        assert w.any_actionable()
        done, failure = w.pop_ready()
        assert done == [] and isinstance(failure, EtlError)

    async def test_submissions_chain_in_dispatch_order(self):
        w = AckWindow(4)
        log: list = []
        gate = asyncio.Event()
        ack0, fut0 = WriteAck.accepted()
        ack1, fut1 = WriteAck.accepted()

        async def slow_submit():
            log.append("first-start")
            await gate.wait()
            log.append("first-done")
            return ack0

        w.dispatch(slow_submit, n_events=1, nbytes=1)
        w.dispatch(_submitter(ack1, log, "second"), n_events=1, nbytes=1)
        await _settle()
        # the second submission must NOT start until the first returned
        assert log == ["first-start"]
        gate.set()
        await _settle()
        assert log == ["first-start", "first-done", "second"]
        fut0.set_result(None)
        fut1.set_result(None)
        await _settle()
        done, failure = w.pop_ready()
        assert len(done) == 2 and failure is None

    async def test_mid_window_failure_pops_prefix_then_raises(self):
        w = AckWindow(4)
        ack0, fut0 = WriteAck.accepted()
        ack1, fut1 = WriteAck.accepted()
        ack2, fut2 = WriteAck.accepted()
        for i, ack in enumerate((ack0, ack1, ack2)):
            w.dispatch(_submitter(ack), commit_end_lsn=Lsn(i + 1),
                       n_events=1, nbytes=1)
        await _settle()
        fut0.set_result(None)
        fut1.set_exception(EtlError(ErrorKind.DESTINATION_FAILED, "boom"))
        await _settle()
        done, failure = w.pop_ready()
        # the durable prefix surfaces BEFORE the failure so the caller
        # persists it and the restart re-streams only the suffix
        assert [e.commit_end_lsn for e in done] == [Lsn(1)]
        assert isinstance(failure, EtlError)
        assert failure.kind is ErrorKind.DESTINATION_FAILED
        fut2.set_result(None)
        await _settle()

    async def test_failed_submission_fails_successors_without_submitting(
            self):
        w = AckWindow(4)
        log: list = []

        async def failing_submit():
            raise EtlError(ErrorKind.DESTINATION_FAILED, "submit died")

        ack1, fut1 = WriteAck.accepted()
        w.dispatch(failing_submit, n_events=1, nbytes=1)
        w.dispatch(_submitter(ack1, log, "second"), n_events=1, nbytes=1)
        await _settle()
        # the successor must never reach the destination (WAL-order gap)
        assert log == []
        done, failure = w.pop_ready()
        assert done == [] and isinstance(failure, EtlError)

    async def test_depth_and_byte_caps_and_pressure_shrink(self):
        pressure = [False]
        w = AckWindow(3, max_bytes=100,
                      pressure=lambda: pressure[0])
        assert w.can_dispatch(10**9)  # empty window always admits one
        ack0, fut0 = WriteAck.accepted()
        w.dispatch(_submitter(ack0), n_events=1, nbytes=60)
        await _settle()
        assert w.can_dispatch(30)
        assert not w.can_dispatch(50)  # byte cap: 60 + 50 > 100
        ack1, fut1 = WriteAck.accepted()
        w.dispatch(_submitter(ack1), n_events=1, nbytes=30)
        await _settle()
        # memory pressure shrinks the effective depth to 1: nothing
        # more dispatches until the window fully drains
        pressure[0] = True
        assert w.effective_limit() == 1
        assert not w.can_dispatch(1)
        pressure[0] = False
        assert w.can_dispatch(5)  # depth 3, bytes 90+5 <= 100
        ack2, fut2 = WriteAck.accepted()
        w.dispatch(_submitter(ack2), n_events=1, nbytes=5)
        await _settle()
        assert not w.can_dispatch(1)  # depth cap
        for f in (fut0, fut1, fut2):
            f.set_result(None)
        await _settle()
        done, failure = w.pop_ready()
        assert len(done) == 3 and failure is None
        assert w.pending_bytes == 0

    async def test_wait_all_then_drain(self):
        w = AckWindow(4)
        pairs = [WriteAck.accepted() for _ in range(3)]
        for i, (ack, _) in enumerate(pairs):
            w.dispatch(_submitter(ack), commit_end_lsn=Lsn(i + 1),
                       n_events=2, nbytes=1)
        for _, fut in pairs:
            asyncio.get_event_loop().call_later(0.01, fut.set_result, None)
        await asyncio.wait_for(w.wait_all(), 5)
        done, failure = w.pop_ready()
        assert [int(e.commit_end_lsn) for e in done] == [1, 2, 3]
        assert failure is None and w.is_empty

    async def test_event_less_entry_carries_commit_watermark(self):
        w = AckWindow(4)

        async def submit_none():
            return None

        w.dispatch(submit_none, commit_end_lsn=Lsn(9), n_events=0,
                   nbytes=0)
        await _settle()
        done, failure = w.pop_ready()
        assert [e.commit_end_lsn for e in done] == [Lsn(9)]
        assert failure is None


# ---- from tests/test_ack_window.py
class TestCopyAckWindow:
    async def test_bounds_outstanding_and_preserves_order(self):
        order: list = []

        class TrackedAck(WriteAck):
            __slots__ = ("index",)

            async def wait_durable(self):
                order.append(self.index)
                await super().wait_durable()

        def tracked(i):
            ack, fut = TrackedAck.accepted()
            ack.index = i
            return ack, fut

        w = CopyAckWindow(2)
        pairs = [tracked(i) for i in range(4)]
        for _, fut in pairs:
            fut.set_result(None)
        for i, (ack, _) in enumerate(pairs):
            await w.add(ack)
            assert len(w) <= 2
        await w.drain()
        assert order == [0, 1, 2, 3]  # oldest-first: partition order
        assert len(w) == 0

    async def test_early_error_surfacing(self):
        w = CopyAckWindow(1)
        ok_ack, ok_fut = WriteAck.accepted()
        ok_fut.set_result(None)
        bad_ack, bad_fut = WriteAck.accepted()
        bad_fut.set_exception(
            EtlError(ErrorKind.DESTINATION_FAILED, "copy write died"))
        bad_fut.exception()  # retrieved
        await w.add(bad_ack)
        # the NEXT add must surface the oldest ack's failure — within
        # `limit` batches, not at the end-of-copy barrier
        with pytest.raises(EtlError):
            await w.add(ok_ack)

    async def test_pressure_shrinks_to_serial(self):
        pressure = [True]
        w = CopyAckWindow(4, pressure=lambda: pressure[0])
        for _ in range(3):
            ack, fut = WriteAck.accepted()
            fut.set_result(None)
            await w.add(ack)
            assert len(w) <= 1  # shrunk to 1 outstanding ack
        pressure[0] = False
        for _ in range(3):
            ack, fut = WriteAck.accepted()
            fut.set_result(None)
            await w.add(ack)
        assert len(w) > 1  # pressure lifted: the full window is back


# ---- from tests/test_ack_window.py
class TestAssemblerWatermarks:
    def _assembler(self):
        from etl_tpu_torch.config.pipeline import BatchEngine
        from etl_tpu_torch.runtime.assembler import EventAssembler

        return EventAssembler(BatchEngine.CPU)

    def _ev(self):
        from etl_tpu_torch.models.event import BeginEvent

        return BeginEvent(Lsn(1), Lsn(2), 0, 0)

    def test_bounded_flush_cuts_prefix_with_covered_watermark(self):
        a = self._assembler()
        a.push_control(self._ev(), size_hint=100)
        a.note_commit_end(Lsn(10))
        a.push_control(self._ev(), size_hint=100)
        a.note_commit_end(Lsn(20))
        a.push_control(self._ev(), size_hint=100)
        events, covered, remaining = a.flush_bounded(max_bytes=100)
        assert len(events) == 1
        assert covered == Lsn(10)  # only commit 10's events are inside
        assert remaining == Lsn(20)  # commit 20 still awaits a flush
        assert a.size_bytes == 200
        events, covered, remaining = a.flush_bounded(max_bytes=None)
        assert len(events) == 2
        assert covered == Lsn(20)
        assert remaining is None
        assert a.size_bytes == 0

    def test_mid_transaction_prefix_covers_no_commit(self):
        a = self._assembler()
        a.push_control(self._ev(), size_hint=100)
        a.push_control(self._ev(), size_hint=100)
        events, covered, remaining = a.flush_bounded(max_bytes=100)
        assert len(events) == 1
        assert covered is None and remaining is None

    def test_event_less_commit_window(self):
        a = self._assembler()
        a.note_commit_end(Lsn(33))
        events, covered, remaining = a.flush_bounded()
        assert events == [] and covered == Lsn(33) and remaining is None

    def test_always_takes_at_least_one_event(self):
        a = self._assembler()
        a.push_control(self._ev(), size_hint=500)
        a.push_control(self._ev(), size_hint=500)
        events, _, _ = a.flush_bounded(max_bytes=1)
        assert len(events) == 1  # a single over-budget event still flushes

    def test_legacy_flush_signature_unchanged(self):
        a = self._assembler()
        a.push_control(self._ev())
        events = a.flush()
        assert isinstance(events, list) and len(events) == 1

    def test_byte_seal_bounds_run_size(self):
        import numpy as np

        from etl_tpu_torch.config.pipeline import BatchEngine
        from etl_tpu_torch.models import (ColumnSchema, Oid, ReplicatedTableSchema,
                                    TableName, TableSchema)
        from etl_tpu_torch.postgres.codec import pgoutput
        from etl_tpu_torch.runtime.assembler import EventAssembler

        rts = ReplicatedTableSchema.with_all_columns(TableSchema(
            7, TableName("public", "t"),
            (ColumnSchema("id", Oid.INT4, nullable=False,
                          primary_key_ordinal=1),)))
        a = EventAssembler(BatchEngine.CUDA, device="cpu", seal_bytes=256)
        payload = pgoutput.encode_insert(7, [b"1"])
        for i in range(40):
            a.push_raw_row(payload, rts, Lsn(100 + i), Lsn(9999), i)
        events = a.flush()
        try:
            # one unbounded run would be a single event; the byte seal
            # must have cut it into several ≤ ~256-byte runs
            assert len(events) > 3
            total = sum(len(e.tx_ordinals) for e in events)
            assert total == 40
        finally:
            a.close()


# ---- from tests/test_ack_window.py
class TestDispatchBlockedByteCap:
    async def test_byte_cap_judges_prospective_flush_not_backlog(self):
        """Review regression: the byte-cap check must see the ≤threshold
        prefix the next flush would actually dispatch — judging the
        whole assembler backlog against the window cap would collapse
        the window to one-in-flight exactly when the backlog is
        largest."""
        from types import SimpleNamespace

        from etl_tpu_torch.runtime.apply_loop import ApplyLoop

        w = AckWindow(4, max_bytes=100)
        ack, fut = WriteAck.accepted()
        w.dispatch(_submitter(ack), n_events=1, nbytes=60)
        await _settle()
        ns = SimpleNamespace(
            _ack_window=w,
            assembler=SimpleNamespace(size_bytes=10**9),  # huge backlog
            _flush_threshold=lambda: 30)  # the next flush is ≤ 30 bytes
        # 60 in flight + a 30-byte prospective flush ≤ 100: must dispatch
        assert not ApplyLoop._dispatch_blocked(ns)
        ns._flush_threshold = lambda: 50
        # 60 + 50 > 100: the byte cap legitimately blocks
        assert ApplyLoop._dispatch_blocked(ns)
        fut.set_result(None)
        await _settle()
        w.pop_ready()


# ---- from tests/test_ack_window.py
class TestAbandon:
    def test_abandoned_handle_returns_pooled_resources(self):
        """A hard-killed loop's flushed-but-undelivered window entries
        abandon their pending decodes: the staging arena and the decode
        window slot return without the fetch (the leak the chaos probe
        counts)."""
        import time as _time

        from etl_tpu_torch.models import (ColumnSchema, Oid,
                                    ReplicatedTableSchema, TableName,
                                    TableSchema)
        from etl_tpu_torch.ops.engine import DeviceDecoder
        from etl_tpu_torch.ops.pipeline import DecodePipeline
        from etl_tpu_torch.ops.staging import ARENA_POOL
        from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
        from etl_tpu_torch.postgres.codec import pgoutput

        rts = ReplicatedTableSchema.with_all_columns(TableSchema(
            7, TableName("public", "ab_t"),
            (ColumnSchema("id", Oid.INT4, nullable=False,
                          primary_key_ordinal=1),)))
        payloads = [pgoutput.encode_insert(7, [str(i).encode()])
                    for i in range(128)]
        buf, offs, lens = concat_payloads(payloads)
        staged = stage_wal_batch(buf, offs, lens, 1).staged
        dec = DeviceDecoder(rts, device="cpu", device_min_rows=0)
        baseline = ARENA_POOL.outstanding
        pipe = DecodePipeline(window=2)
        try:
            handle = pipe.submit(dec, staged)
            deadline = _time.monotonic() + 10
            while not handle._future.done():
                assert _time.monotonic() < deadline
                _time.sleep(0.01)
            assert ARENA_POOL.outstanding > baseline
            handle.abandon()
            assert ARENA_POOL.outstanding == baseline
            assert len(pipe.window) == 0
            with pytest.raises(RuntimeError):
                handle.result()  # post-abandon consumption is forbidden
        finally:
            pipe.close()

    def test_abandon_after_result_is_noop(self):
        from etl_tpu_torch.models import (ColumnSchema, Oid,
                                    ReplicatedTableSchema, TableName,
                                    TableSchema)
        from etl_tpu_torch.ops.engine import DeviceDecoder
        from etl_tpu_torch.ops.pipeline import DecodePipeline
        from etl_tpu_torch.ops.staging import ARENA_POOL
        from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
        from etl_tpu_torch.postgres.codec import pgoutput

        rts = ReplicatedTableSchema.with_all_columns(TableSchema(
            7, TableName("public", "ab2_t"),
            (ColumnSchema("id", Oid.INT4, nullable=False,
                          primary_key_ordinal=1),)))
        payloads = [pgoutput.encode_insert(7, [str(i).encode()])
                    for i in range(128)]
        buf, offs, lens = concat_payloads(payloads)
        staged = stage_wal_batch(buf, offs, lens, 1).staged
        dec = DeviceDecoder(rts, device="cpu", device_min_rows=0)
        baseline = ARENA_POOL.outstanding
        pipe = DecodePipeline(window=2)
        try:
            handle = pipe.submit(dec, staged)
            batch = handle.result()
            assert batch.num_rows == 128
            handle.abandon()  # already fetched: no double release
            assert ARENA_POOL.outstanding == baseline
            assert handle.result() is batch  # result stays idempotent
        finally:
            pipe.close()


# ---- from tests/test_admission.py
class TestSchedulerUnits:
    def test_acquire_release_counts(self):
        s = AdmissionScheduler(2)
        t = s.register("a")
        t.acquire()
        assert s.in_flight == 1 and t.held == 1
        t.release()
        assert s.in_flight == 0 and t.held == 0

    def test_release_without_hold_is_noop(self):
        s = AdmissionScheduler(1)
        t = s.register("a")
        t.release()
        assert s.in_flight == 0

    def test_stride_split_proportional_to_lag_weight(self):
        # B lags 7×64MB → weight 8; over 90 contended grants the stride
        # invariant gives B eight grants for each of A's (±1)
        s = AdmissionScheduler(1, starvation_s=999.0)
        a = s.register("a", lag_bytes=lambda: 0)
        b = s.register("b", lag_bytes=lambda: 7 * MB64)
        now = time.monotonic()
        a._wait_since = now
        b._wait_since = now
        for _ in range(90):
            picked = s._pick(now)
            assert picked is not None and not picked[1]
            _drain_grant(s, picked[0])
        assert 9 <= a._grants <= 11
        assert a._grants + b._grants == 90

    def test_zero_lag_tenant_never_locked_out(self):
        # even against an infinitely-lagging tenant, the weight clamp
        # keeps A's share at 1/max_weight — not zero
        s = AdmissionScheduler(1, starvation_s=999.0, max_weight=16.0)
        a = s.register("a", lag_bytes=lambda: 0)
        b = s.register("b", lag_bytes=lambda: float("inf"))
        now = time.monotonic()
        a._wait_since = now
        b._wait_since = now
        for _ in range(64):
            _drain_grant(s, s._pick(now)[0])
        assert a._grants >= 3  # 64/16 = 4 expected, ±1

    def test_starvation_aging_overrides_weight(self):
        s = AdmissionScheduler(1, starvation_s=0.05)
        a = s.register("a", lag_bytes=lambda: 0)
        b = s.register("b", lag_bytes=lambda: 100 * MB64)
        t0 = time.monotonic()
        a._wait_since = t0
        b._wait_since = t0
        # before the deadline: weight wins — after the cold-start tie is
        # broken, b's tiny stride keeps it ahead of a for a long run
        _drain_grant(s, s._pick(t0 + 0.01)[0])
        for _ in range(10):
            picked, starved = s._pick(t0 + 0.01)
            assert picked is b and not starved
            _drain_grant(s, picked)
        # past the deadline both are starved: FIFO among starved; tie on
        # wait_since resolves deterministically and the grant is flagged
        a._wait_since = t0
        b._wait_since = t0 + 0.001
        picked, starved = s._pick(t0 + 0.2)
        assert picked is a and starved

    def test_bad_lag_provider_degrades_to_weight_one(self):
        s = AdmissionScheduler(1)

        def boom():
            raise RuntimeError("lag reader died")

        t = s.register("a", lag_bytes=boom)
        assert s._weight(t) == 1.0

    def test_blocked_acquire_wakes_on_release(self):
        s = AdmissionScheduler(1)
        a = s.register("a")
        b = s.register("b")
        a.acquire()
        granted = threading.Event()

        def waiter():
            b.acquire()
            granted.set()

        th = threading.Thread(target=waiter, daemon=True)
        th.start()
        time.sleep(0.08)
        assert not granted.is_set(), "capacity 1 must block the second"
        a.release()
        assert granted.wait(2.0)
        b.release()
        th.join(2.0)
        assert s.in_flight == 0

    def test_bypass_valve_overshoots_capacity(self):
        before = registry.get_counter(
            ETL_DECODE_ADMISSION_BYPASS_GRANTS_TOTAL, {"pipeline": "b"})
        s = AdmissionScheduler(1)
        a = s.register("a")
        b = s.register("b")
        a.acquire()
        b.acquire(bypass=lambda: True)  # demanded consumer: no deadlock
        assert s.in_flight == 2  # overshoot, accounted symmetrically
        assert registry.get_counter(
            ETL_DECODE_ADMISSION_BYPASS_GRANTS_TOTAL,
            {"pipeline": "b"}) == before + 1
        a.release()
        b.release()
        assert s.in_flight == 0

    def test_memory_pressure_shrinks_capacity_to_one(self):
        class FakeMonitor:
            pressure = True

        s = AdmissionScheduler(4)
        s.register("a", monitor=FakeMonitor())
        assert s.effective_capacity == 1

    def test_close_reclaims_held_tickets_and_deregisters(self):
        s = AdmissionScheduler(4)
        a = s.register("a")
        b = s.register("b")
        a.acquire()
        a.acquire()
        b.acquire()
        assert s.in_flight == 3
        a.close()
        assert s.in_flight == 1 and a.held == 0 and a.closed
        a.release()  # late release from a drained handle: no-op
        assert s.in_flight == 1
        with pytest.raises(RuntimeError):
            a.acquire()
        b.close()
        assert s.in_flight == 0
        assert s.stats()["tenants"] == {}

    def test_grant_telemetry_observed(self):
        g0 = registry.get_counter(ETL_DECODE_ADMISSION_GRANTS_TOTAL,
                                  {"pipeline": "telem"})
        h0, _ = registry.get_histogram(ETL_DECODE_ADMISSION_WAIT_SECONDS,
                                       {"pipeline": "telem"})
        s = AdmissionScheduler(2)
        t = s.register("telem")
        t.acquire()
        t.release()
        assert registry.get_counter(ETL_DECODE_ADMISSION_GRANTS_TOTAL,
                                    {"pipeline": "telem"}) == g0 + 1
        h1, _ = registry.get_histogram(ETL_DECODE_ADMISSION_WAIT_SECONDS,
                                       {"pipeline": "telem"})
        assert h1 == h0 + 1

    def test_starvation_grant_counted_end_to_end(self):
        # threaded: A hogs the only slot long enough for B to age out,
        # then B's grant must be flagged as a starvation grant
        c0 = registry.get_counter(
            ETL_DECODE_ADMISSION_STARVATION_GRANTS_TOTAL,
            {"pipeline": "slow"})
        s = AdmissionScheduler(1, starvation_s=0.05)
        a = s.register("hog", lag_bytes=lambda: 100 * MB64)
        b = s.register("slow", lag_bytes=lambda: 0)
        a.acquire()
        done = threading.Event()

        def waiter():
            b.acquire()
            done.set()

        th = threading.Thread(target=waiter, daemon=True)
        th.start()
        time.sleep(0.12)  # b ages past the starvation deadline
        a.release()
        assert done.wait(2.0)
        th.join(2.0)
        b.release()
        assert registry.get_counter(
            ETL_DECODE_ADMISSION_STARVATION_GRANTS_TOTAL,
            {"pipeline": "slow"}) == c0 + 1


# ---- from tests/test_admission.py
class TestPipelineIntegration:
    def test_two_pipelines_share_capacity_byte_identical(self):
        schema = make_schema([Oid.INT4, Oid.INT8])
        # device route (the plain versions) for every batch: each dispatch
        # takes a ticket on the shared scheduler
        dec = DeviceDecoder(schema, device="cpu", device_min_rows=0)
        serial = [dec.decode(_staged_batch()) for _ in range(4)]
        s = AdmissionScheduler(1)  # maximum contention between the two
        pa = DecodePipeline(window=2, name="tenant-a",
                            admission=s.register("tenant-a"))
        pb = DecodePipeline(window=2, name="tenant-b",
                            admission=s.register("tenant-b"))
        try:
            ha = [pa.submit(dec, _staged_batch()) for _ in range(4)]
            hb = [pb.submit(dec, _staged_batch()) for _ in range(4)]
            for want, h in zip(serial, ha):
                assert_batches_equal(h.result(), want)
            for want, h in zip(serial, hb):
                assert_batches_equal(h.result(), want)
        finally:
            pa.close()
            pb.close()
        assert s.in_flight == 0
        assert s.stats()["tenants"] == {}
        ga = registry.get_counter(ETL_DECODE_ADMISSION_GRANTS_TOTAL,
                                  {"pipeline": "tenant-a"})
        gb = registry.get_counter(ETL_DECODE_ADMISSION_GRANTS_TOTAL,
                                  {"pipeline": "tenant-b"})
        assert ga >= 4 and gb >= 4

    def test_close_with_undrained_handles_releases_tickets(self):
        schema = make_schema([Oid.INT4, Oid.INT8])
        dec = DeviceDecoder(schema, device="cpu", device_min_rows=0)
        s = AdmissionScheduler(2)
        pipe = DecodePipeline(window=3, name="abandon",
                              admission=s.register("abandon"))
        handles = [pipe.submit(dec, _staged_batch()) for _ in range(3)]
        # drain ONE handle first so the worker is provably past pack/
        # dispatch for it — the rest are left undrained at close time
        assert handles[0].result().num_rows == 128
        pipe.close()  # reclaim with undrained handles outstanding
        assert s.in_flight == 0
        # handles already packed/dispatched stay resolvable after close;
        # their late releases into the closed tenant are no-ops
        for h in handles[1:]:
            try:
                assert h.result().num_rows == 128
            except RuntimeError:
                pass  # queued behind the close: fails fast by contract
        assert s.in_flight == 0

    def test_oracle_route_takes_no_ticket(self):
        schema = make_schema([Oid.INT4, Oid.INT8])
        # default thresholds: a 4-row batch routes to the oracle
        dec = DeviceDecoder(schema, device="cpu")
        s = AdmissionScheduler(1)
        tenant = s.register("oracle-t")
        pipe = DecodePipeline(window=2, name="oracle-t", admission=tenant)
        try:
            g0 = registry.get_counter(ETL_DECODE_ADMISSION_GRANTS_TOTAL,
                                      {"pipeline": "oracle-t"})
            h = pipe.submit(dec, _staged_batch(4))
            assert h.result().num_rows == 4
            assert registry.get_counter(
                ETL_DECODE_ADMISSION_GRANTS_TOTAL,
                {"pipeline": "oracle-t"}) == g0
        finally:
            pipe.close()
        assert s.in_flight == 0


# ---- from tests/test_runtime_units.py
class TestTableState:
    def test_happy_path_transitions(self):
        st = TableState.init()
        seq = [TableState.data_sync(), TableState.finished_copy(),
               TableState.sync_wait(Lsn(1)), TableState.catchup(Lsn(2)),
               TableState.sync_done(Lsn(3)), TableState.ready()]
        for nxt in seq:
            st = st.transition_to(nxt)
        assert st.type is TableStateType.READY

    def test_invalid_transition_rejected(self):
        with pytest.raises(EtlError):
            TableState.init().transition_to(TableState.ready())
        with pytest.raises(EtlError):
            TableState.ready().transition_to(TableState.data_sync())

    def test_error_and_rollback_from_any_state(self):
        for st in [TableState.init(), TableState.catchup(Lsn(1)),
                   TableState.ready()]:
            assert st.can_transition_to(TableStateType.ERRORED)
            assert st.can_transition_to(TableStateType.INIT)

    def test_serialization_roundtrip(self):
        for st in [TableState.init(), TableState.finished_copy(),
                   TableState.sync_done(Lsn("AB/CD")), TableState.ready(),
                   TableState.errored("boom", solution="fix it",
                                      retry_policy=RetryKind.MANUAL,
                                      retry_attempts=3)]:
            assert TableState.from_json(st.to_json()) == st

    def test_memory_only_states_not_serializable(self):
        for st in [TableState.sync_wait(Lsn(1)), TableState.catchup(Lsn(2))]:
            with pytest.raises(EtlError):
                st.to_json()

    async def test_memory_store_rejects_memory_only(self):
        store = MemoryStore()
        with pytest.raises(EtlError):
            await store.update_table_state(1, TableState.sync_wait(Lsn(1)))


# ---- from tests/test_runtime_units.py
class TestSlots:
    def test_names(self):
        assert apply_slot_name(7) == "supabase_etl_apply_7"
        assert table_sync_slot_name(7, 16384) == \
            "supabase_etl_table_sync_7_16384"

    def test_parse(self):
        p = parse_slot_name("supabase_etl_apply_12")
        assert p.pipeline_id == 12 and p.is_apply
        p = parse_slot_name("supabase_etl_table_sync_12_99")
        assert (p.pipeline_id, p.table_id) == (12, 99)
        assert parse_slot_name("someone_elses_slot") is None
        assert parse_slot_name("supabase_etl_apply_xyz") is None

    def test_filter_for_pipeline(self):
        names = ["supabase_etl_apply_1", "supabase_etl_apply_2",
                 "supabase_etl_table_sync_1_5", "other"]
        assert slots_for_pipeline(names, 1) == \
            ["supabase_etl_apply_1", "supabase_etl_table_sync_1_5"]

    def test_length_limit(self):
        with pytest.raises(EtlError):
            table_sync_slot_name(10**40, 10**40)


# ---- from tests/test_runtime_units.py
class TestCopyPlanning:
    def cfg(self):
        return PipelineConfig(pipeline_id=1, publication_name="p")

    def test_small_table_single_partition(self):
        parts = plan_copy_partitions(100, 2, self.cfg())
        assert len(parts) <= 2
        assert sum(p.estimated_rows for p in parts) <= 100 + len(parts)

    def test_partition_count_math(self):
        # 10M rows / 250k target = 40 partitions (> 4×4 floor)
        parts = plan_copy_partitions(10_000_000, 100_000, self.cfg())
        assert len(parts) == 40
        # page ranges tile [0, heap_pages) exactly
        ordered = sorted(parts, key=lambda p: p.start_page)
        assert ordered[0].start_page == 0
        for a, b in zip(ordered, ordered[1:]):
            assert a.end_page == b.start_page
        assert ordered[-1].end_page is None

    def test_clamped_to_max_partitions(self):
        parts = plan_copy_partitions(10**9, 10**6, self.cfg())
        assert len(parts) == 1024

    def test_largest_first(self):
        parts = plan_copy_partitions(1_000_000, 101, self.cfg())
        sizes = [p.estimated_rows for p in parts]
        assert sizes == sorted(sizes, reverse=True)

    def test_empty_stats(self):
        parts = plan_copy_partitions(0, 0, self.cfg())
        assert len(parts) == 1 and parts[0].start_page == 0


# ---- from tests/test_runtime_units.py
class TestRetryConfig:
    def test_backoff(self):
        r = RetryConfig(max_attempts=5, initial_delay_ms=100,
                        max_delay_ms=1000, backoff_factor=2.0)
        assert [r.delay_ms(i) for i in range(5)] == [100, 200, 400, 800, 1000]


# ---- from tests/test_runtime_units.py
class TestMemoryStoreContracts:
    async def test_progress_monotonic(self):
        store = MemoryStore()
        assert await store.update_durable_progress("k", Lsn(100))
        assert not await store.update_durable_progress("k", Lsn(50))
        assert await store.get_durable_progress("k") == Lsn(100)
        assert await store.update_durable_progress("k", Lsn(100))  # equal ok

    async def test_schema_versioning(self):
        store = MemoryStore()
        s = TableSchema(5, TableName("p", "t"),
                        (ColumnSchema("a", Oid.INT4),))
        s2 = TableSchema(5, TableName("p", "t"),
                         (ColumnSchema("a", Oid.INT4),
                          ColumnSchema("b", Oid.TEXT)))
        r1 = ReplicatedTableSchema.with_all_columns(s)
        r2 = ReplicatedTableSchema.with_all_columns(s2)
        await store.store_table_schema(r1, 10)
        await store.store_table_schema(r2, 20)
        assert (await store.get_table_schema(5)).table_schema == s2
        assert (await store.get_table_schema(5, at_snapshot=15)) \
            .table_schema == s
        assert (await store.get_table_schema(5, at_snapshot=5)) is None
        # prune keeps the version still needed for snapshot 20
        removed = await store.prune_schema_versions(5, 25)
        assert removed == 1
        assert await store.get_schema_versions(5) == [20]


# ---- from tests/test_runtime_units.py
class TestAssemblerBulkPush:
    """push_raw_rows (the drained-window span path) must be byte-equivalent
    to N push_raw_row calls — same runs, ordinals, size accounting."""

    def _schema(self):
        from etl_tpu_torch.models import ReplicatedTableSchema, TableName, TableSchema
        return ReplicatedTableSchema.with_all_columns(TableSchema(
            7, TableName("public", "t"),
            (ColumnSchema("id", Oid.INT4, nullable=False,
                          primary_key_ordinal=1),)))

    def test_bulk_equals_single(self):
        from etl_tpu_torch.config.pipeline import BatchEngine
        from etl_tpu_torch.postgres.codec import pgoutput
        from etl_tpu_torch.runtime.assembler import EventAssembler

        schema = self._schema()
        payloads = [pgoutput.encode_insert(7, [str(i).encode()])
                    for i in range(10)]
        a1 = EventAssembler(BatchEngine.CUDA, device="cpu")
        for i, p in enumerate(payloads):
            a1.push_raw_row(p, schema, Lsn(100 + i), Lsn(500), i)
        a2 = EventAssembler(BatchEngine.CUDA, device="cpu")
        nbytes = a2.push_raw_rows(payloads, schema,
                                  [100 + i for i in range(10)], 500, 0)
        assert nbytes == sum(len(p) for p in payloads)
        assert a1.size_bytes == a2.size_bytes
        r1, r2 = a1._run, a2._run
        assert r1.payloads == r2.payloads
        assert r1.start_lsns == r2.start_lsns
        assert r1.commit_lsns == r2.commit_lsns
        assert list(r1.tx_ordinals) == list(r2.tx_ordinals)

    def test_bulk_seals_on_schema_change(self):
        from etl_tpu_torch.config.pipeline import BatchEngine
        from etl_tpu_torch.models import (ReplicatedTableSchema, TableName,
                                    TableSchema)
        from etl_tpu_torch.postgres.codec import pgoutput
        from etl_tpu_torch.runtime.assembler import EventAssembler

        s1 = self._schema()
        s2 = ReplicatedTableSchema.with_all_columns(TableSchema(
            8, TableName("public", "u"),
            (ColumnSchema("id", Oid.INT4, nullable=False,
                          primary_key_ordinal=1),)))
        a = EventAssembler(BatchEngine.CUDA, device="cpu")
        a.push_raw_rows([pgoutput.encode_insert(7, [b"1"])], s1, [1], 10, 0)
        a.push_raw_rows([pgoutput.encode_insert(8, [b"2"])], s2, [2], 10, 1)
        events = a.flush()
        assert len(events) == 2  # two sealed DecodedBatchEvents


# ---- from tests/test_runtime_units.py
class TestIdentityPreservingTableCache:
    def test_equal_schema_keeps_object(self):
        from etl_tpu_torch.models import (ReplicatedTableSchema, TableName,
                                    TableSchema)
        from etl_tpu_torch.runtime.table_cache import SharedTableCache

        def make():
            return ReplicatedTableSchema.with_all_columns(TableSchema(
                7, TableName("public", "t"),
                (ColumnSchema("id", Oid.INT4, nullable=False,
                              primary_key_ordinal=1),)))

        cache = SharedTableCache()
        a = make()
        cache.set(a)
        cache.set(make())  # equal but not identical (RELATION re-send)
        assert cache.get(7) is a, \
            "equal re-set must preserve identity (decoder/jit reuse)"
        changed = ReplicatedTableSchema.with_all_columns(TableSchema(
            7, TableName("public", "t"),
            (ColumnSchema("id", Oid.INT8, nullable=False,
                          primary_key_ordinal=1),)))
        cache.set(changed)
        assert cache.get(7) is changed  # real change replaces


# ---- from tests/test_runtime_units.py
class TestPreencodedInserts:
    def test_wal_identical_to_plain_insert(self):
        import asyncio as _a

        from etl_tpu_torch.models import TableName, TableSchema
        from etl_tpu_torch.postgres.codec import pgoutput
        from etl_tpu_torch.postgres.fake import FakeDatabase

        def mk_db():
            db = FakeDatabase()
            db.create_table(TableSchema(
                16384, TableName("public", "t"),
                (ColumnSchema("id", Oid.INT4, nullable=False,
                              primary_key_ordinal=1),)))
            db.create_publication("pub", [16384])
            return db

        async def run():
            db1, db2 = mk_db(), mk_db()
            tx = db1.transaction(xid=9)
            for i in range(3):
                tx.insert(16384, [str(i)])
            lsn1 = await tx.commit()
            tx = db2.transaction(xid=9)
            for i in range(3):
                tx.insert_preencoded(
                    16384, pgoutput.encode_insert(16384, [str(i).encode()]),
                    [str(i)])
            lsn2 = await tx.commit()
            assert int(lsn1) == int(lsn2)
            assert [int(lsn) for lsn, *_ in db1.wal] \
                == [int(lsn) for lsn, *_ in db2.wal]
            for (l1, p1, t1, r1), (l2, p2, t2, r2) in zip(db1.wal, db2.wal):
                if p1[:1] in (b"I", b"R"):
                    assert p1 == p2
                    assert t1 == t2 and r1 == r2
                else:  # BEGIN/COMMIT embed wall-clock timestamps
                    assert p1[:1] == p2[:1]
            # table state advanced identically
            assert db1.tables[16384].rows == db2.tables[16384].rows

        asyncio.run(run())


# ---- from tests/test_runtime_units.py
class TestDynamicSeal:
    """Backlog mega-batching: the seal grows one row
    bucket per step toward MEGA_SEAL_ROWS and resets to the latency size."""

    def _schema(self):
        from etl_tpu_torch.models import ReplicatedTableSchema, TableName, TableSchema
        return ReplicatedTableSchema.with_all_columns(TableSchema(
            7, TableName("public", "t"),
            (ColumnSchema("id", Oid.INT4, nullable=False,
                          primary_key_ordinal=1),)))

    def test_grow_and_reset_steps_are_row_buckets(self):
        from etl_tpu_torch.config.pipeline import BatchEngine
        from etl_tpu_torch.ops.staging import ROW_BUCKETS
        from etl_tpu_torch.runtime.assembler import (MEGA_SEAL_ROWS, RUN_SEAL_ROWS,
                                               EventAssembler)

        a = EventAssembler(BatchEngine.CUDA, device="cpu")
        assert a.seal_rows == RUN_SEAL_ROWS
        seen = [a.seal_rows]
        for _ in range(5):
            a.grow_seal()
            seen.append(a.seal_rows)
        # monotone, capped, and every step lands exactly on a standard
        # bucket (an off-bucket seal would compile a wasted program)
        assert seen[-1] == MEGA_SEAL_ROWS
        assert all(s in ROW_BUCKETS for s in seen)
        assert seen == sorted(seen)
        a.reset_seal()
        assert a.seal_rows == RUN_SEAL_ROWS

    def test_grown_seal_accumulates_past_default(self):
        from etl_tpu_torch.config.pipeline import BatchEngine
        from etl_tpu_torch.postgres.codec import pgoutput
        from etl_tpu_torch.runtime.assembler import RUN_SEAL_ROWS, EventAssembler

        schema = self._schema()
        a = EventAssembler(BatchEngine.CUDA, device="cpu")
        a.grow_seal()
        n = RUN_SEAL_ROWS + 8
        payloads = [pgoutput.encode_insert(7, [b"1"])] * n
        a.push_raw_rows(payloads, schema, list(range(n)), 999, 0)
        # the run is still OPEN (one future DecodedBatchEvent, not two)
        assert a._run is not None and len(a._run.payloads) == n

    def test_scaled_flush_threshold_tracks_seal(self):
        from etl_tpu_torch.config import BatchConfig, PipelineConfig
        from etl_tpu_torch.config.pipeline import BatchEngine
        from etl_tpu_torch.runtime.apply_loop import ApplyLoop
        from etl_tpu_torch.runtime.assembler import EventAssembler

        loop = ApplyLoop.__new__(ApplyLoop)
        loop.config = PipelineConfig(
            pipeline_id=1, publication_name="p",
            batch=BatchConfig(max_size_bytes=1000))
        loop.assembler = EventAssembler(BatchEngine.CUDA, device="cpu")
        assert loop._scaled_max_bytes() == 1000
        loop.assembler.grow_seal()
        assert loop._scaled_max_bytes() == 4000
        loop.assembler.grow_seal()
        assert loop._scaled_max_bytes() == 16000
        loop.assembler.reset_seal()
        assert loop._scaled_max_bytes() == 1000
