"""The port's exactly-once delivery, held to the reference's
tests/test_exactly_once.py (`TestCommitRange` through
`TestExactlyOnceBenchHarness`), each case restated on the port's objects:
`CommitRange` and the transactional sink, the wrappers' forwarding of the
seam, the apply worker's recovery-query policy, DLQ replay keyed by the
original coordinates, the hard-kill matrix (`etl_tpu_torch.chaos.
exactly_once`, on the CPU: the kernels' plain versions, the decoder's
floor at one row so every batch takes the device route) with the CLI's
per-seed determinism, and the bench harness's slice. Parity: the port's
matrix and the reference's, same seed, deliver the same seed-stable end
state; the port's CommitRange token equals the reference's. Tolerance:
none.
"""

from __future__ import annotations

import asyncio
import json

import pytest

from etl_tpu_torch.config import PipelineConfig, RetryConfig
from etl_tpu_torch.destinations import (DelayedAckDestination,
                                  FaultInjectingDestination,
                                  MemoryDestination,
                                  PoisonRejectingDestination,
                                  TransactionalMemoryDestination)
from etl_tpu_torch.destinations.base import CommitRange, event_coordinate
from etl_tpu_torch.dlq import DeadLetterQueue
from etl_tpu_torch.models import ColumnSchema, Oid, TableName, TableSchema
from etl_tpu_torch.models.errors import ErrorKind, EtlError
from etl_tpu_torch.models.event import BeginEvent, CommitEvent, InsertEvent
from etl_tpu_torch.models.lsn import Lsn
from etl_tpu_torch.models.schema import ReplicatedTableSchema
from etl_tpu_torch.models.table_row import TableRow
from etl_tpu_torch.store import MemoryStore
from etl_tpu_torch.supervision.destination import SupervisedDestination


def make_schema(tid: int = 16384) -> ReplicatedTableSchema:
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        tid, TableName("public", f"t{tid}"),
        (ColumnSchema("id", Oid.INT8, nullable=False,
                      primary_key_ordinal=1),
         ColumnSchema("note", Oid.TEXT))))


def insert_event(schema, pk: int, note: str, commit: int = 100,
                 ordinal: int | None = None) -> InsertEvent:
    return InsertEvent(Lsn(commit - 1), Lsn(commit),
                       ordinal if ordinal is not None else pk, schema,
                       TableRow([pk, note]))


# -- CommitRange --------------------------------------------------------------


class TestCommitRange:
    def test_from_events_takes_lexicographic_max(self):
        schema = make_schema()
        events = [insert_event(schema, 1, "a", commit=100, ordinal=3),
                  insert_event(schema, 2, "b", commit=200, ordinal=1),
                  insert_event(schema, 3, "c", commit=200, ordinal=2)]
        rng = CommitRange.from_events(events, commit_end_lsn=250)
        assert rng.high == (200, 2)
        assert rng.commit_end_lsn == 250
        assert rng.replay is False

    def test_token_is_offset_token_hex_shape(self):
        rng = CommitRange(high=(0x1A2B, 7))
        assert rng.token() == "0000000000001a2b/0000000000000007"

    def test_controls_have_no_coordinates(self):
        # Begin/Commit envelopes carry no row identity: a control-only
        # flush has nothing to dedup and derives no range
        controls = [BeginEvent(Lsn(99), Lsn(100), 0, 5),
                    CommitEvent(Lsn(100), Lsn(100), Lsn(101), 0)]
        assert all(event_coordinate(e) is None for e in controls)
        assert CommitRange.from_events(controls) is None

    def test_row_coordinate_identity(self):
        e = insert_event(make_schema(), 9, "x", commit=300, ordinal=4)
        assert event_coordinate(e) == (300, 4)

    def test_token_equals_the_reference(self):
        from etl_tpu.destinations.base import CommitRange as RefRange

        for high in ((0, 0), (0x1A2B, 7), ((1 << 63) + 5, (1 << 40) - 1)):
            assert CommitRange(high=high).token() == \
                RefRange(high=high).token()

    def test_replay_flag_carried(self):
        rng = CommitRange.from_events(
            [insert_event(make_schema(), 1, "a")], replay=True)
        assert rng.replay is True and rng.commit_end_lsn is None


# -- the reference transactional sink -----------------------------------------


class TestTransactionalMemorySink:
    def _sink(self):
        return TransactionalMemoryDestination()

    async def test_stream_commit_records_data_and_range_atomically(self):
        sink = self._sink()
        schema = make_schema()
        events = [insert_event(schema, i, f"r{i}", commit=100 + i)
                  for i in range(3)]
        ack = await sink.write_event_batches_committed(
            events, CommitRange.from_events(events, commit_end_lsn=110))
        await ack.wait_durable()
        assert [e.row.values[0] for e in sink.events] == [0, 1, 2]
        assert sink.high_water == (102, 2)
        assert sink.committed_end_lsn == 110
        assert sink.high_water_log == [(102, 2)]

    async def test_blind_restream_dedups_below_high_water(self):
        """The crash shape: re-streamed rows at coordinates <= the
        recorded high-water drop regardless of the retry's batch
        boundaries; only the genuinely-new suffix applies."""
        sink = self._sink()
        schema = make_schema()
        first = [insert_event(schema, i, f"r{i}", commit=100 + i)
                 for i in range(4)]
        await sink.write_event_batches_committed(
            first, CommitRange.from_events(first, commit_end_lsn=104))
        # re-stream overlaps the last two rows and adds two new ones
        retry = first[2:] + [
            insert_event(schema, i, f"r{i}", commit=100 + i)
            for i in range(4, 6)]
        await sink.write_event_batches_committed(
            retry, CommitRange.from_events(retry, commit_end_lsn=106))
        assert sink.dedup_skipped_rows == 2
        assert [e.row.values[0] for e in sink.events] == [0, 1, 2, 3, 4, 5]
        assert sink.high_water == (105, 5)

    async def test_fully_deduped_flush_is_a_noop_write(self):
        sink = self._sink()
        schema = make_schema()
        events = [insert_event(schema, 1, "a", commit=100)]
        await sink.write_event_batches_committed(
            events, CommitRange.from_events(events, commit_end_lsn=100))
        before = len(sink.events)
        ack = await sink.write_event_batches_committed(
            events, CommitRange.from_events(events, commit_end_lsn=100))
        await ack.wait_durable()
        assert len(sink.events) == before
        assert sink.dedup_skipped_rows == 1
        # the range still committed (log appends; monotone, not strict)
        assert sink.high_water_log == [(100, 1), (100, 1)]

    async def test_replay_dedups_by_exact_key_not_high_water(self):
        """Replayed rows sit BELOW the streaming high-water mark by
        construction (they were parked while the stream moved on) — a
        replay must still apply them once, keyed exactly, and must not
        move the high-water mark."""
        sink = self._sink()
        schema = make_schema()
        live = [insert_event(schema, 9, "live", commit=900)]
        await sink.write_event_batches_committed(
            live, CommitRange.from_events(live, commit_end_lsn=900))
        parked = [insert_event(schema, 1, "parked", commit=100),
                  insert_event(schema, 2, "parked", commit=101)]
        rng = CommitRange.from_events(parked, replay=True)
        await sink.write_event_batches_committed(parked, rng)
        assert [e.row.values[0] for e in sink.events] == [9, 1, 2]
        assert sink.replay_skipped_rows == 0
        assert sink.high_water == (900, 9)  # unmoved
        # replay twice: the second pass is a keyed no-op
        await sink.write_event_batches_committed(parked, rng)
        assert [e.row.values[0] for e in sink.events] == [9, 1, 2]
        assert sink.replay_skipped_rows == 2

    async def test_plain_write_counts_as_uncoordinated(self):
        sink = self._sink()
        await sink.write_events([insert_event(make_schema(), 1, "a")])
        assert sink.uncoordinated_writes == 1

    async def test_recover_high_water_round_trip_and_faults(self):
        sink = self._sink()
        assert await sink.recover_high_water() is None  # fresh sink
        schema = make_schema()
        events = [insert_event(schema, 1, "a", commit=100)]
        await sink.write_event_batches_committed(
            events, CommitRange.from_events(events, commit_end_lsn=100))
        rng = await sink.recover_high_water()
        assert rng.high == (100, 1) and rng.commit_end_lsn == 100
        sink.recover_faults.append(
            EtlError(ErrorKind.TIMEOUT, "scripted"))
        with pytest.raises(EtlError):
            await sink.recover_high_water()
        # faults are FIFO: the next query answers again
        assert (await sink.recover_high_water()).high == (100, 1)
        assert sink.recover_calls == 4


# -- wrapper forwarding -------------------------------------------------------


class TestWrapperForwarding:
    WRAPPERS = [
        ("supervised", lambda inner: SupervisedDestination(
            inner, timeout_s=5.0)),
        ("delayed_ack", lambda inner: DelayedAckDestination(inner, 0.0)),
        ("fault_injecting", FaultInjectingDestination),
        ("poison_rejecting", PoisonRejectingDestination),
    ]

    @pytest.mark.parametrize("name,make", WRAPPERS,
                             ids=[w[0] for w in WRAPPERS])
    async def test_probe_reflects_inner(self, name, make):
        wrapped = make(TransactionalMemoryDestination())
        assert wrapped.supports_transactional_commit() is True
        plain = make(MemoryDestination())
        assert plain.supports_transactional_commit() is False
        await wrapped.shutdown()
        await plain.shutdown()

    @pytest.mark.parametrize("name,make", WRAPPERS,
                             ids=[w[0] for w in WRAPPERS])
    async def test_committed_write_and_recovery_forward(self, name, make):
        inner = TransactionalMemoryDestination()
        wrapped = make(inner)
        schema = make_schema()
        events = [insert_event(schema, 1, "a", commit=100)]
        ack = await wrapped.write_event_batches_committed(
            events, CommitRange.from_events(events, commit_end_lsn=100))
        await ack.wait_durable()
        assert inner.high_water == (100, 1)
        assert inner.uncoordinated_writes == 0
        rng = await wrapped.recover_high_water()
        assert rng is not None and rng.high == (100, 1)
        assert inner.recover_calls == 1
        await wrapped.shutdown()


# -- satellite 1: recovery-query failure policy -------------------------------


class _RecoveryEnv:
    """An ApplyWorker wired just enough to drive
    `_recover_sink_high_water` (the method touches only config,
    destination, and the metrics registry)."""

    def __init__(self, destination, *, max_attempts: int = 3,
                 op_timeout_s: float = 5.0):
        from etl_tpu_torch.runtime.apply_worker import ApplyWorker
        from etl_tpu_torch.runtime.shutdown import ShutdownSignal

        config = PipelineConfig(
            pipeline_id=1, publication_name="pub",
            destination_op_timeout_s=op_timeout_s,
            apply_retry=RetryConfig(max_attempts=max_attempts,
                                    initial_delay_ms=1, max_delay_ms=5))
        self.worker = ApplyWorker(
            config=config, store=MemoryStore(), destination=destination,
            source_factory=None, pool=None, table_cache=None,
            shutdown=ShutdownSignal())


def _counters():
    from etl_tpu_torch.telemetry.metrics import (
        ETL_EXACTLY_ONCE_RECOVERIES_TOTAL,
        ETL_EXACTLY_ONCE_RECOVERY_FALLBACKS_TOTAL, registry)

    return (registry.get_counter(ETL_EXACTLY_ONCE_RECOVERIES_TOTAL),
            registry.get_counter(ETL_EXACTLY_ONCE_RECOVERY_FALLBACKS_TOTAL,
                                 labels={"reason": "error"}),
            registry.get_counter(ETL_EXACTLY_ONCE_RECOVERY_FALLBACKS_TOTAL,
                                 labels={"reason": "timeout"}))


class TestRecoveryFailurePolicy:
    async def test_non_transactional_sink_never_queried(self):
        env = _RecoveryEnv(MemoryDestination())
        assert await env.worker._recover_sink_high_water() is None

    async def test_transient_fault_retried_to_success(self):
        sink = TransactionalMemoryDestination()
        schema = make_schema()
        events = [insert_event(schema, 1, "a", commit=100)]
        await sink.write_event_batches_committed(
            events, CommitRange.from_events(events, commit_end_lsn=100))
        sink.recover_faults.append(
            EtlError(ErrorKind.DESTINATION_CONNECTION_FAILED, "blip"))
        ok_before, *_ = _counters()
        env = _RecoveryEnv(sink)
        rng = await env.worker._recover_sink_high_water()
        assert rng is not None and rng.high == (100, 1)
        assert sink.recover_calls == 2  # fault, then the retried success
        assert _counters()[0] == ok_before + 1

    async def test_exhausted_retries_degrade_to_blind_restream(self):
        sink = TransactionalMemoryDestination()
        for _ in range(5):
            sink.recover_faults.append(
                EtlError(ErrorKind.DESTINATION_FAILED, "down"))
        _, err_before, _ = _counters()
        env = _RecoveryEnv(sink, max_attempts=2)
        assert await env.worker._recover_sink_high_water() is None
        assert sink.recover_calls == 2  # bounded by the policy
        assert _counters()[1] == err_before + 1

    async def test_op_timeout_bounds_each_attempt(self):
        sink = TransactionalMemoryDestination()
        sink.recover_delay_s = 5.0  # far past the op bound
        _, _, to_before = _counters()
        env = _RecoveryEnv(sink, max_attempts=2, op_timeout_s=0.05)
        assert await env.worker._recover_sink_high_water() is None
        assert _counters()[2] == to_before + 1

    async def test_untyped_sink_exception_surfaces_typed(self):
        class BrokenSink(TransactionalMemoryDestination):
            async def recover_high_water(self):
                self.recover_calls += 1
                raise RuntimeError("raw client explosion")

        sink = BrokenSink()
        _, err_before, _ = _counters()
        env = _RecoveryEnv(sink, max_attempts=2)
        # the raw exception is wrapped DESTINATION_FAILED, retried, and
        # degrades — it never propagates out of recovery
        assert await env.worker._recover_sink_high_water() is None
        assert sink.recover_calls == 2
        assert _counters()[1] == err_before + 1


# -- satellite 2: DLQ replay keyed by original coordinates --------------------


class TestDlqReplayTransactional:
    async def _parked_store(self, schema, rows):
        from etl_tpu_torch.dlq.codec import encode_row_event
        from etl_tpu_torch.store.base import DeadLetterEntry

        store = MemoryStore()
        await store.store_table_schema(schema, 1)
        entries = []
        for pk, note, commit in rows:
            ev = insert_event(schema, pk, note, commit=commit)
            change, payload = encode_row_event(ev)
            entries.append(DeadLetterEntry(
                entry_id=0, table_id=schema.id,
                commit_lsn=int(ev.commit_lsn), tx_ordinal=ev.tx_ordinal,
                change_type=change, payload=payload,
                error_kind="DESTINATION_REJECTED", detail="test"))
        await store.append_dead_letters(entries)
        return store

    async def test_replay_twice_is_idempotent_on_transactional_sink(self):
        schema = make_schema()
        store = await self._parked_store(
            schema, [(1, "p1", 100), (2, "p2", 101)])
        sink = TransactionalMemoryDestination()
        # the live stream moved on while these rows were parked
        live = [insert_event(schema, 9, "live", commit=900)]
        await sink.write_event_batches_committed(
            live, CommitRange.from_events(live, commit_end_lsn=900))

        dlq = DeadLetterQueue(store)
        out = await dlq.replay(sink)
        assert len(out["replayed"]) == 2
        assert [e.row.values[0] for e in sink.events] == [9, 1, 2]
        # replays dedup by EXACT key, below the high-water mark, and
        # never advance it
        assert sink.high_water == (900, 9)
        assert sink.dedup_skipped_rows == 0

        # status-flip idempotence: a second replay finds nothing
        again = await dlq.replay(sink)
        assert again["replayed"] == []
        # crash-between-write-and-flip shape: force a re-push of
        # already-replayed entries — the sink's replay keys absorb it
        forced = await dlq.replay(sink, include_replayed=True)
        assert len(forced["replayed"]) == 2
        assert [e.row.values[0] for e in sink.events] == [9, 1, 2]
        assert sink.replay_skipped_rows == 2
        assert sink.uncoordinated_writes == 0

    async def test_replay_on_plain_sink_keeps_at_least_once(self):
        """A non-transactional destination replays through the plain
        seam unchanged — the DLQ stays destination-agnostic."""
        schema = make_schema()
        store = await self._parked_store(schema, [(1, "p1", 100)])
        sink = MemoryDestination()
        out = await DeadLetterQueue(store).replay(sink)
        assert len(out["replayed"]) == 1
        assert [e.row.values[0] for e in sink.events] == [1]


# -- satellite 3: the hard-kill matrix in tier-1 ------------------------------


def _stable_window_view(doc: dict) -> dict:
    """The seed-deterministic end-state subset of one window's
    describe(): kill timing races (resume LSN, in-flight acks, dedup
    counts) vary run to run; the DELIVERED state must not."""
    return {k: doc[k] for k in ("window", "seed", "max_duplication",
                                "delivered_events", "expected_rows",
                                "high_water")}


class TestExactlyOnceChaos:
    async def test_kill_matrix_exactly_once(self):
        from etl_tpu_torch.chaos.exactly_once import (KILL_WINDOWS,
                                                      run_exactly_once_crash)
        from etl_tpu_torch.chaos.runner import device_floor
        from etl_tpu_torch.ops import engine

        before = engine.routed_device_batches
        with device_floor(1):
            run = await run_exactly_once_crash(seed=7, device="cpu")
        assert engine.routed_device_batches > before  # the device route
        assert run.ok, run.report.violations
        assert [w["window"] for w in run.windows] == list(KILL_WINDOWS)
        for w in run.windows:
            # dup budget 0: no row event delivered more than once
            assert w["max_duplication"] <= 1, w
            assert w["delivered_events"] > 0, w
            assert w["recover_calls"] >= len(w["restarts"]), w
            assert len(w["restarts"]) >= 1, w
        # the mid-recovery window really took two kills
        assert len(run.windows[2]["restarts"]) == 2

    def test_cli_determinism(self):
        """`python -m etl_tpu_torch.chaos --exactly-once` delivers the
        same end state per seed (timing-raced kill diagnostics
        stripped)."""
        import os
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        outs = []
        for _ in range(2):
            proc = subprocess.run(
                [sys.executable, "-m", "etl_tpu_torch.chaos",
                 "--exactly-once", "--seed", "11", "--device", "cpu",
                 "--device-floor", "1"],
                capture_output=True, text=True, timeout=240, cwd=repo,
                env=dict(os.environ))
            assert proc.returncode == 0, proc.stdout + proc.stderr
            doc = json.loads(proc.stdout.strip().splitlines()[-1])
            assert doc["ok"] is True
            outs.append({
                "seed": doc["seed"],
                "invariants": doc["invariants"]["violations"],
                "windows": [_stable_window_view(w)
                            for w in doc["windows"]],
            })
        assert outs[0] == outs[1]


# -- satellite 5: the bench harness slice -------------------------------------


class TestExactlyOnceBenchHarness:
    async def test_run_exactly_once_smoke_slice(self):
        """One small pass of the full A/B + restart-leg harness: the
        gate arithmetic (zero dups, loss, re-stream <= unacked suffix,
        seam coverage) holds at smoke size."""
        from etl_tpu_torch.benchmarks import harness

        out = await harness.run_exactly_once(n_events=400, tx_size=20,
                                             repeats=1, device="cpu")
        assert out["failures"] == [], out
        assert out["ok"] is True
        assert out["transactional"]["uncoordinated_writes"] == 0
        leg = out["restart"]
        assert leg["duplicate_rows"] == 0
        assert leg["rows_delivered"] == 400
        assert leg["restreamed_deduped_rows"] <= leg["unacked_suffix_rows"]
        assert leg["recover_calls"] >= 1


class TestExactlyOnceParity:
    async def test_matrix_end_state_equals_the_reference(self):
        """The port's kill matrix and the reference's, one seed: the same
        windows, the same seed-stable delivered end state. The reference
        runs in a process of its own (`python -m etl_tpu.chaos
        --exactly-once`), so no program state that an earlier reference
        test left in this test process reaches its decoder."""
        import json
        import os
        import subprocess
        import sys

        from etl_tpu_torch.chaos.exactly_once import run_exactly_once_crash
        from etl_tpu_torch.chaos.runner import device_floor

        with device_floor(1):
            port = await run_exactly_once_crash(seed=11, device="cpu")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, "-m", "etl_tpu.chaos", "--exactly-once",
             "--seed", "11"],
            capture_output=True, text=True, timeout=240, cwd=repo,
            env=dict(os.environ))
        assert proc.stdout.strip(), proc.stderr
        ref = json.loads(proc.stdout.strip().splitlines()[-1])
        assert port.ok and ref["ok"] is True, (
            port.report.violations, ref["invariants"]["violations"])
        assert [_stable_window_view(w) for w in port.windows] == \
            [_stable_window_view(w) for w in ref["windows"]]
