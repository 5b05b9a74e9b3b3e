"""The port's poison-pill isolation and durable dead-letter store, held to
the reference's tests/test_poison_dlq.py: the DLQ payload codec (and its
bytes equal to the reference codec's on the same seeded events), the
store surface on MemoryStore and SqliteStore, the isolator protocol
units, the AckWindow multi-failure aggregation, destination error
classification, the operator verbs through `DeadLetterQueue` and the CLI
(in process and as a subprocess over a sqlite file another connection
holds open), live quarantine lifts, column attribution and compaction.

The CLI's `--postgres` and `replay --destination-json` are here too; the
Postgres dialect of the store surface is in test_torch_sql_store.py.
`TestShardScopedDlqFence` holds the shard fence over the dead-letter and
quarantine writes (memory and sqlite), and `TestDlqChaosScenarios` the
port's DLQ chaos scenarios on its own pipeline (`device="cpu"`), held to
the thread-leak invariant. Waiting for later slices (ROADMAP.md, queue
1): the classification tests that need Iceberg.
"""

from __future__ import annotations

import asyncio
import contextlib
import datetime as dt
import json
import uuid

import numpy as np
import pytest

from etl_tpu_torch.config import PipelineConfig, PoisonConfig
from etl_tpu_torch.destinations import (MemoryDestination,
                                  PoisonRejectingDestination)
from etl_tpu_torch.destinations.base import WriteAck
from etl_tpu_torch.dlq import DeadLetterQueue
from etl_tpu_torch.dlq.codec import (decode_cell, decode_row_event,
                               encode_cell, encode_row_event)
from etl_tpu_torch.models import ColumnSchema, Oid, TableName, TableSchema
from etl_tpu_torch.models.cell import (JSON_NULL, PgInterval, PgNumeric,
                                 PgSpecialDate, PgSpecialTimestamp,
                                 PgTimeTz, TOAST_UNCHANGED)
from etl_tpu_torch.models.errors import (ErrorKind, EtlError, is_poison_error,
                                   retry_directive, RetryKind)
from etl_tpu_torch.models.event import DeleteEvent, InsertEvent, UpdateEvent
from etl_tpu_torch.models.lsn import Lsn
from etl_tpu_torch.models.schema import ReplicatedTableSchema
from etl_tpu_torch.models.table_row import PartialTableRow, TableRow
from etl_tpu_torch.runtime import poison as poison_mod
from etl_tpu_torch.runtime.poison import PoisonIsolator, bisection_bound
from etl_tpu_torch.store import MemoryStore, SqliteStore
from etl_tpu_torch.store.base import (DLQ_STATUS_DEAD, DLQ_STATUS_DISCARDED,
                                DLQ_STATUS_REPLAYED, DeadLetterEntry,
                                QuarantineRecord)
from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission


@pytest.fixture(autouse=True)
def _port_hygiene():
    """The forced-oracle state is module-global (as in the reference): a
    test that left it set would move every later batch of this worker
    onto the oracle."""
    yield
    engine.clear_forced_oracle()
    failpoints.disarm_all()
    reset_global_admission()


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


def make_entry(ev, kind: str = "DESTINATION_REJECTED") -> DeadLetterEntry:
    change, payload = encode_row_event(ev)
    return DeadLetterEntry(
        entry_id=0, table_id=ev.schema.id, commit_lsn=int(ev.commit_lsn),
        tx_ordinal=ev.tx_ordinal, change_type=change, payload=payload,
        error_kind=kind, detail="test")


@pytest.fixture
def config() -> PipelineConfig:
    return PipelineConfig(pipeline_id=1, publication_name="pub",
                          poison=PoisonConfig(budget_rows=3,
                                              window_s=300.0))


# -- codec --------------------------------------------------------------------


class TestDlqCodec:
    CELLS = [
        None, True, False, 0, -5, 2**62, 1.5, -0.25, "text", "",
        "POISON-1", b"\x00\xff", PgNumeric("123.450"),
        PgNumeric("NaN"), dt.date(2024, 5, 1),
        dt.datetime(2024, 5, 1, 12, 30, 15, 123456),
        dt.datetime(2024, 5, 1, 12, 30, 15, tzinfo=dt.timezone.utc),
        dt.time(23, 59, 59, 5),
        PgTimeTz(dt.time(1, 2, 3), 3600),
        PgInterval(1, 2, 3_000_000),
        PgSpecialDate(-1_000_000, "1000-01-01 BC"),
        PgSpecialTimestamp(-(2**45), "2000-01-01 00:00:00 BC", True),
        uuid.UUID(int=7), JSON_NULL, TOAST_UNCHANGED,
        {"k": [1, "two"]}, [1, "two", None, [3]],
        float("inf"), float("-inf"),
    ]

    def test_cell_round_trip(self):
        for v in self.CELLS:
            enc = encode_cell(v)
            json_safe = json.loads(json.dumps(enc))
            got = decode_cell(json_safe)
            assert got == v or (v != v and got != got), (v, got)
            # identity-style singletons survive as the same sentinel
            if v is TOAST_UNCHANGED or v is JSON_NULL:
                assert got is v

    def test_nan_round_trips(self):
        got = decode_cell(json.loads(json.dumps(encode_cell(
            float("nan")))))
        assert got != got

    def test_opaque_fallback(self):
        class Exotic:
            def __repr__(self):
                return "<exotic>"

        assert decode_cell(encode_cell(Exotic())) == "<exotic>"

    def test_insert_round_trip(self):
        schema = make_schema()
        ev = insert_event(schema, 7, "POISON-1", commit=500, ordinal=3)
        entry = make_entry(ev)
        got = decode_row_event(entry, schema)
        assert isinstance(got, InsertEvent)
        assert got.row.values == [7, "POISON-1"]
        assert int(got.commit_lsn) == 500 and got.tx_ordinal == 3

    def test_update_with_key_old_row(self):
        schema = make_schema()
        ev = UpdateEvent(Lsn(9), Lsn(10), 1, schema, TableRow([2, "new"]),
                         PartialTableRow([2, None], [True, False]))
        got = decode_row_event(make_entry(ev), schema)
        assert isinstance(got, UpdateEvent)
        assert isinstance(got.old_row, PartialTableRow)
        assert got.old_row.present == [True, False]
        assert got.row.values == [2, "new"]

    def test_delete_round_trip(self):
        schema = make_schema()
        ev = DeleteEvent(Lsn(9), Lsn(10), 1, schema,
                         PartialTableRow([2, None], [True, False]))
        got = decode_row_event(make_entry(ev), schema)
        assert isinstance(got, DeleteEvent)
        assert isinstance(got.old_row, PartialTableRow)

    def test_schema_width_mismatch_is_typed(self):
        schema = make_schema()
        entry = make_entry(insert_event(schema, 1, "x"))
        wider = ReplicatedTableSchema.with_all_columns(TableSchema(
            16384, TableName("public", "t"),
            (ColumnSchema("id", Oid.INT8, nullable=False,
                          primary_key_ordinal=1),
             ColumnSchema("note", Oid.TEXT),
             ColumnSchema("extra", Oid.INT4))))
        with pytest.raises(EtlError) as ei:
            decode_row_event(entry, wider)
        assert ei.value.kind is ErrorKind.SCHEMA_MISMATCH


# -- error taxonomy -----------------------------------------------------------


class TestPoisonKinds:
    def test_rejected_is_manual_and_poison(self):
        e = EtlError(ErrorKind.DESTINATION_REJECTED, "4xx")
        assert retry_directive(e).kind is RetryKind.MANUAL
        assert is_poison_error(e)

    def test_transient_kinds_are_not_poison(self):
        for kind in (ErrorKind.DESTINATION_THROTTLED,
                     ErrorKind.DESTINATION_CONNECTION_FAILED,
                     ErrorKind.DESTINATION_UNAVAILABLE,
                     ErrorKind.DESTINATION_FAILED,
                     ErrorKind.TIMEOUT):
            assert not is_poison_error(EtlError(kind, "x"))

    def test_aggregate_poison_only_if_every_cause_is(self):
        pois = EtlError(ErrorKind.DESTINATION_REJECTED, "a")
        trans = EtlError(ErrorKind.DESTINATION_THROTTLED, "b")
        both_poison = EtlError(ErrorKind.DESTINATION_SCHEMA_FAILED, "c",
                               causes=[pois])
        assert is_poison_error(both_poison)
        mixed = EtlError(ErrorKind.DESTINATION_REJECTED, "d",
                         causes=[trans])
        assert not is_poison_error(mixed)

    def test_non_etl_error_is_not_poison(self):
        assert not is_poison_error(RuntimeError("boom"))


# -- store surface ------------------------------------------------------------


def sqlite_store(tmp_path):
    return SqliteStore(tmp_path / "state.db", 1)


class _StoreEnv:
    """One dialect's store over shared backing storage (the test_sql_store
    pattern — no pytest-asyncio, so construction happens inside the
    async test body)."""

    def __init__(self, dialect: str, tmp_path):
        self.dialect = dialect
        self.tmp_path = tmp_path
        self._stores: list = []

    async def make(self, pipeline_id: int = 1):
        if self.dialect == "memory":
            s = MemoryStore()
            self._stores.append(s)
            return s
        s = SqliteStore(self.tmp_path / "store.db", pipeline_id)
        await s.connect()
        self._stores.append(s)
        return s

    async def cleanup(self):
        for s in self._stores:
            close = getattr(s, "close", None)
            if close is not None:
                try:
                    await close()
                except Exception:
                    pass


@pytest.fixture(params=["memory", "sqlite"])
def dialect(request):
    return request.param


class TestDlqStoreSurface:
    """The dead-letter + quarantine surface on the memory and sqlite
    backends."""

    async def test_append_list_get(self, dialect, tmp_path):
        env = _StoreEnv(dialect, tmp_path)
        try:
            store = await env.make()
            schema = make_schema()
            ids = await store.append_dead_letters(
                [make_entry(insert_event(schema, i, f"v{i}",
                                         commit=100 + i))
                 for i in range(3)])
            assert len(ids) == 3 and len(set(ids)) == 3
            entries = await store.list_dead_letters()
            assert [e.entry_id for e in entries] == sorted(ids)
            assert all(e.status == DLQ_STATUS_DEAD for e in entries)
            got = await store.get_dead_letter(ids[1])
            assert got is not None and got.commit_lsn == 101
            assert await store.get_dead_letter(10**9) is None
        finally:
            await env.cleanup()

    async def test_append_is_idempotent_keyed_upsert(self, dialect,
                                                     tmp_path):
        env = _StoreEnv(dialect, tmp_path)
        try:
            store = await env.make()
            e = make_entry(insert_event(make_schema(), 1, "x"))
            (id1,) = await store.append_dead_letters([e])
            (id2,) = await store.append_dead_letters([e])
            assert id1 == id2
            entries = await store.list_dead_letters()
            assert len(entries) == 1
            assert entries[0].attempts == 2
        finally:
            await env.cleanup()

    async def test_filters_and_status_transitions(self, dialect,
                                                  tmp_path):
        env = _StoreEnv(dialect, tmp_path)
        try:
            store = await env.make()
            s1, s2 = make_schema(16384), make_schema(16385)
            await store.append_dead_letters(
                [make_entry(insert_event(s1, 1, "a")),
                 make_entry(insert_event(s2, 2, "b", commit=200))])
            only = await store.list_dead_letters(table_id=16385)
            assert [e.table_id for e in only] == [16385]
            (eid,) = [e.entry_id for e in only]
            await store.set_dead_letter_status(eid, DLQ_STATUS_REPLAYED)
            assert await store.list_dead_letters(table_id=16385) == []
            replayed = await store.list_dead_letters(
                table_id=16385, status=DLQ_STATUS_REPLAYED)
            assert [e.entry_id for e in replayed] == [eid]
            assert len(await store.list_dead_letters(status=None)) == 2
            with pytest.raises(EtlError):
                await store.set_dead_letter_status(12345,
                                                   DLQ_STATUS_DISCARDED)
        finally:
            await env.cleanup()

    async def test_quarantine_round_trip(self, dialect, tmp_path):
        env = _StoreEnv(dialect, tmp_path)
        try:
            store = await env.make()
            rec = QuarantineRecord(16384, since_lsn=500, poison_rows=4,
                                   parked_events=2, reason="drift")
            await store.set_table_quarantine(16384, rec)
            assert await store.get_quarantined_tables() == {16384: rec}
            await store.set_table_quarantine(16384, None)
            assert await store.get_quarantined_tables() == {}
        finally:
            await env.cleanup()

    async def test_persists_across_store_restart(self, tmp_path):
        """Hard-kill semantics on the durable dialect: a NEW store over
        the same backing storage sees the DLQ and the quarantine record
        — what a restarted replicator loads at its first flush. (The
        memory store dies with the process by design.)"""
        env = _StoreEnv("sqlite", tmp_path)
        try:
            store = await env.make()
            await store.append_dead_letters(
                [make_entry(insert_event(make_schema(), 1, "POISON-1"))])
            await store.set_table_quarantine(
                16384, QuarantineRecord(16384, 100, 1, reason="r"))
            second = await env.make()  # fresh process over same storage
            assert set(await second.get_quarantined_tables()) == {16384}
            entries = await second.list_dead_letters()
            assert len(entries) == 1 and entries[0].table_id == 16384
        finally:
            await env.cleanup()

    async def test_dlq_failpoint_fires(self, dialect, tmp_path):
        env = _StoreEnv(dialect, tmp_path)
        try:
            store = await env.make()
            failpoints.arm_error(failpoints.STORE_DLQ_COMMIT,
                                 ErrorKind.STATE_STORE_FAILED, times=1)
            try:
                with pytest.raises(EtlError):
                    await store.append_dead_letters(
                        [make_entry(insert_event(make_schema(), 1, "x"))])
            finally:
                failpoints.disarm_all()
            # next append succeeds and nothing was half-written
            await store.append_dead_letters(
                [make_entry(insert_event(make_schema(), 1, "x"))])
            assert len(await store.list_dead_letters()) == 1
        finally:
            await env.cleanup()


class TestSqliteQuarantinePersistence:
    async def test_survives_process_death(self, tmp_path):
        """Hard-kill semantics: a NEW store over the same file sees the
        quarantine record and the DLQ — what a restarted replicator
        loads at its first flush."""
        s = sqlite_store(tmp_path)
        await s.connect()
        schema = make_schema()
        await s.append_dead_letters(
            [make_entry(insert_event(schema, 1, "POISON-1"))])
        await s.set_table_quarantine(
            16384, QuarantineRecord(16384, 100, 1, reason="r"))
        await s.close()  # no graceful anything else — process death

        s2 = sqlite_store(tmp_path)
        await s2.connect()
        assert set(await s2.get_quarantined_tables()) == {16384}
        entries = await s2.list_dead_letters()
        assert len(entries) == 1 and entries[0].table_id == 16384
        await s2.close()

    async def test_replay_then_unquarantine_round_trip(self, tmp_path):
        s = sqlite_store(tmp_path)
        await s.connect()
        schema = make_schema()
        await s.store_table_schema(schema, 1)
        ev = insert_event(schema, 9, "fixed-now", commit=300)
        await s.append_dead_letters([make_entry(ev)])
        await s.set_table_quarantine(
            16384, QuarantineRecord(16384, 300, 1))
        dest = MemoryDestination()
        dlq = DeadLetterQueue(s)
        out = await dlq.replay(dest)
        assert len(out["replayed"]) == 1 and not out["skipped"]
        assert [e.row.values for e in dest.events] == [[9, "fixed-now"]]
        assert await dlq.unquarantine(16384) is True
        assert await s.get_quarantined_tables() == {}
        # idempotent: nothing left to replay, nothing re-delivered
        again = await dlq.replay(dest)
        assert again["replayed"] == [] and len(dest.events) == 1
        assert await dlq.unquarantine(16384) is False
        # an explicitly-requested non-replayable id is REPORTED skipped,
        # never silent empty success
        entries = await s.list_dead_letters(status=None)
        out = await dlq.replay(dest, entry_ids=[entries[0].entry_id])
        assert out["replayed"] == []
        assert out["skipped"][0]["entry_id"] == entries[0].entry_id
        assert "replayed" in out["skipped"][0]["reason"]
        await s.close()


# -- the shard fence over dead letters and quarantines ------------------------


class TestShardScopedDlqFence:
    async def _scoped(self, env, shard: int, epoch: int = 0,
                      count: int = 2):
        from etl_tpu_torch.sharding.runtime import (ShardIdentity,
                                                    ShardScopedStore)
        from etl_tpu_torch.sharding.shardmap import ShardAssignment

        inner = await env.make()
        await inner.update_shard_assignment(
            ShardAssignment(epoch=epoch, shard_count=count))
        return inner, ShardScopedStore(
            inner, ShardIdentity(pipeline_id=1, shard=shard,
                                 shard_count=count, epoch=epoch))

    async def test_owned_writes_pass_others_fenced(self, dialect,
                                                   tmp_path):
        from etl_tpu_torch.sharding.shardmap import ShardMap

        env = _StoreEnv(dialect, tmp_path)
        try:
            inner, scoped = await self._scoped(env, shard=0)
            smap = ShardMap(2, 0)
            owned = next(t for t in range(16384, 16500) if smap.owns(t, 0))
            foreign = next(t for t in range(16384, 16500)
                           if not smap.owns(t, 0))
            ev = insert_event(make_schema(owned), 1, "x")
            await scoped.append_dead_letters([make_entry(ev)])
            await scoped.set_table_quarantine(
                owned, QuarantineRecord(owned, 1, 1))
            with pytest.raises(EtlError) as ei:
                await scoped.append_dead_letters([make_entry(
                    insert_event(make_schema(foreign), 1, "x"))])
            assert ei.value.kind is ErrorKind.SHARD_NOT_OWNED
            with pytest.raises(EtlError):
                await scoped.set_table_quarantine(
                    foreign, QuarantineRecord(foreign, 1, 1))
            # reads pass through whole (CLI/invariant vantage)
            assert len(await scoped.list_dead_letters()) == 1
            assert set(await scoped.get_quarantined_tables()) == {owned}
        finally:
            await env.cleanup()

    async def test_epoch_stale_refuses(self, dialect, tmp_path):
        from etl_tpu_torch.sharding.shardmap import ShardAssignment, ShardMap

        env = _StoreEnv(dialect, tmp_path)
        try:
            inner, scoped = await self._scoped(env, shard=0)
            smap = ShardMap(2, 0)
            owned = next(t for t in range(16384, 16500) if smap.owns(t, 0))
            await inner.update_shard_assignment(
                ShardAssignment(epoch=1, shard_count=2))
            with pytest.raises(EtlError) as ei:
                await scoped.set_table_quarantine(
                    owned, QuarantineRecord(owned, 1, 1))
            assert ei.value.kind is ErrorKind.SHARD_EPOCH_STALE
            with pytest.raises(EtlError) as ei:
                await scoped.append_dead_letters([make_entry(
                    insert_event(make_schema(owned), 1, "x"))])
            assert ei.value.kind is ErrorKind.SHARD_EPOCH_STALE
            assert await inner.list_dead_letters() == []
        finally:
            await env.cleanup()


# -- the DLQ chaos scenarios on the port's pipeline ---------------------------


class TestDlqChaosScenarios:
    async def test_poison_quarantine_scenario(self):
        from etl_tpu_torch.chaos.dlq import run_dlq_poison

        run = await run_dlq_poison(seed=7, device="cpu")
        assert run.ok, run.report.violations
        assert run.quarantined_tables == [16384]
        assert run.poison_entries >= 3
        assert run.parked_entries > 0
        assert run.probe_writes <= run.probe_bound
        assert run.replayed == run.dlq_entries

    async def test_bisection_crash_scenario(self):
        from etl_tpu_torch.chaos.dlq import run_dlq_bisection_crash

        run = await run_dlq_bisection_crash(seed=7, device="cpu")
        assert run.ok, run.report.violations
        assert len(run.restarts) == 1
        assert run.poison_entries >= 1

    def test_cli_determinism(self):
        """`python -m etl_tpu_torch.chaos --dlq --device cpu` replays
        bit-identically per seed (timings stripped)."""
        import os
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = repo
        outs = []
        for _ in range(2):
            proc = subprocess.run(
                [sys.executable, "-m", "etl_tpu_torch.chaos", "--dlq",
                 "--device", "cpu", "--seed", "11"],
                capture_output=True, text=True, timeout=240, cwd=repo,
                env=env)
            assert proc.returncode == 0, proc.stdout + proc.stderr
            docs = [json.loads(line)
                    for line in proc.stdout.strip().splitlines()]
            for d in docs:
                d.pop("duration_s", None)
                for r in d.get("restarts", []):
                    r.pop("recovery_s", None)
            outs.append(docs)
        assert outs[0] == outs[1]


# -- isolator protocol units --------------------------------------------------


class RecordingPoisonDest(PoisonRejectingDestination):
    """Poison rejection + write-order recording (WAL-order proof)."""

    def __init__(self, inner):
        super().__init__(inner)
        self.write_sizes: list[int] = []

    async def write_event_batches(self, events):
        self.write_sizes.append(len(list(events)))
        return await super().write_event_batches(events)


class TestPoisonIsolator:
    def make(self, config, budget: "int | None" = None):
        if budget is not None:
            from dataclasses import replace

            config = replace(config,
                             poison=PoisonConfig(budget_rows=budget))
        store = MemoryStore()
        inner = MemoryDestination()
        dest = RecordingPoisonDest(inner)
        iso = PoisonIsolator(store=store, destination=dest, config=config)
        return store, inner, dest, iso

    async def test_single_poison_bisects_within_bound(self, config):
        poison_mod.reset_isolation_trace()
        store, inner, dest, iso = self.make(config, budget=100)
        schema = make_schema()
        events = [insert_event(schema, i,
                               "POISON-x" if i == 11 else f"v{i}")
                  for i in range(16)]
        ack = await iso.submit(events)
        assert ack.is_durable
        delivered = sorted(e.row.values[0] for e in inner.events)
        assert delivered == [i for i in range(16) if i != 11]
        entries = await store.list_dead_letters()
        assert [(e.table_id, e.tx_ordinal) for e in entries] \
            == [(16384, 11)]
        (trace,) = poison_mod.ISOLATION_TRACE
        assert trace["poison_rows"] == 1
        assert trace["probe_writes"] <= bisection_bound(16, 1, 1)

    async def test_wal_order_within_table_preserved(self, config):
        store, inner, dest, iso = self.make(config, budget=100)
        schema = make_schema()
        events = [insert_event(schema, i,
                               "POISON-x" if i == 3 else f"v{i}")
                  for i in range(8)]
        await iso.submit(events)
        pks = [e.row.values[0] for e in inner.events]
        assert pks == sorted(pks)  # delivered in WAL order

    async def test_multi_table_multi_poison(self, config):
        store, inner, dest, iso = self.make(config, budget=100)
        s1, s2, s3 = (make_schema(t) for t in (16384, 16385, 16386))
        events = []
        for i in range(6):
            events.append(insert_event(
                s1, i, "POISON-a" if i == 2 else f"a{i}"))
            events.append(insert_event(
                s2, i, "POISON-b" if i in (1, 4) else f"b{i}",
                commit=200))
            events.append(insert_event(s3, i, f"c{i}", commit=300))
        await iso.submit(events)
        entries = await store.list_dead_letters()
        assert sorted((e.table_id, e.tx_ordinal) for e in entries) \
            == [(16384, 2), (16385, 1), (16385, 4)]
        by_table: dict = {}
        for e in inner.events:
            by_table.setdefault(e.schema.id, []).append(e.row.values[0])
        assert by_table[16384] == [0, 1, 3, 4, 5]
        assert by_table[16385] == [0, 2, 3, 5]
        assert by_table[16386] == list(range(6))  # untouched survivor

    async def test_budget_trips_quarantine_and_parks(self, config):
        store, inner, dest, iso = self.make(config, budget=2)
        schema = make_schema()
        events = [insert_event(schema, i,
                               f"POISON-{i}" if i < 4 else f"v{i}")
                  for i in range(12)]
        await iso.submit(events)
        q = await store.get_quarantined_tables()
        assert set(q) == {16384}
        assert q[16384].poison_rows >= 2
        # every committed row is delivered or dead-lettered
        entries = await store.list_dead_letters()
        accounted = {e.tx_ordinal for e in entries} \
            | {e.row.values[0] for e in inner.events}
        assert accounted == set(range(12))
        # a LATER flush parks without touching the destination
        n_before = len(inner.events)
        ack = await iso.submit(
            [insert_event(schema, 100, "healthy-but-parked")])
        assert ack.is_durable
        assert len(inner.events) == n_before
        parked = [e for e in await store.list_dead_letters()
                  if e.error_kind == "quarantine"]
        assert any(e.tx_ordinal == 100 for e in parked)

    async def test_quarantine_loaded_from_store_on_first_use(self, config):
        """A restarted worker parks from its FIRST flush: the quarantine
        set loads from the store, not from this process's history."""
        store, inner, dest, iso = self.make(config)
        await store.set_table_quarantine(
            16384, QuarantineRecord(16384, 1, 5, reason="previous life"))
        schema = make_schema()
        await iso.submit([insert_event(schema, 1, "v1")])
        assert inner.events == []
        assert len(await store.list_dead_letters()) == 1

    async def test_transient_error_never_bisects(self, config):
        store, inner, dest, iso = self.make(config)

        class FlakyDest(MemoryDestination):
            async def write_event_batches(self, events):
                raise EtlError(ErrorKind.DESTINATION_CONNECTION_FAILED,
                               "down")

        iso.destination = FlakyDest()
        with pytest.raises(EtlError) as ei:
            await iso.submit([insert_event(make_schema(), 1, "v")])
        assert ei.value.kind is ErrorKind.DESTINATION_CONNECTION_FAILED
        assert await store.list_dead_letters() == []

    async def test_transient_mid_bisection_aborts(self, config):
        """A destination that goes DOWN mid-bisection aborts isolation
        with the transient error (worker re-streams), leaving no
        spurious dead letters behind."""
        store, inner, dest, iso = self.make(config, budget=100)
        schema = make_schema()
        calls = [0]
        orig = dest.write_event_batches

        async def flaky(events):
            calls[0] += 1
            if calls[0] >= 3:
                raise EtlError(ErrorKind.DESTINATION_CONNECTION_FAILED,
                               "went down mid-bisection")
            return await orig(events)

        dest.write_event_batches = flaky
        events = [insert_event(schema, i,
                               "POISON-x" if i == 0 else f"v{i}")
                  for i in range(8)]
        with pytest.raises(EtlError) as ei:
            await iso.submit(events)
        assert ErrorKind.DESTINATION_CONNECTION_FAILED in ei.value.kinds()

    async def test_open_breaker_never_bisects(self, config):
        """Breaker open when the poison error surfaces: NO bisection,
        and the MANUAL poison kind must not leak either — the worker
        gets the breaker's own TIMED kind and re-streams; the row
        isolates once the breaker closes."""
        from etl_tpu_torch.supervision.breaker import BreakerState

        store, inner, dest, iso = self.make(config)

        class FakeBreaker:
            state = BreakerState.OPEN

        class RejectingWithBreaker(MemoryDestination):
            breaker = FakeBreaker()

            async def write_event_batches(self, events):
                raise EtlError(ErrorKind.DESTINATION_REJECTED, "4xx")

        iso.destination = RejectingWithBreaker()
        with pytest.raises(EtlError) as ei:
            await iso.submit([insert_event(make_schema(), 1, "v")])
        assert ei.value.kind is ErrorKind.DESTINATION_UNAVAILABLE
        assert retry_directive(ei.value).kind is RetryKind.TIMED
        assert await store.list_dead_letters() == []

    async def test_store_without_dlq_degrades_to_original_error(
            self, config):
        """No DLQ surface → the ORIGINAL poison error surfaces (pre-PR
        worker behavior), never silent row loss."""

        class BareStore(MemoryStore):
            async def append_dead_letters(self, entries):
                raise EtlError(ErrorKind.STATE_STORE_FAILED,
                               "BareStore does not persist dead letters")

        inner = MemoryDestination()
        dest = PoisonRejectingDestination(inner)
        iso = PoisonIsolator(store=BareStore(), destination=dest,
                             config=config)
        with pytest.raises(EtlError) as ei:
            await iso.submit([insert_event(make_schema(), 1, "POISON-1")])
        assert ei.value.kind is ErrorKind.DESTINATION_REJECTED

    async def test_deferred_ack_poison_isolates(self, config):
        """BigQuery shape: write_event_batches returns an ACCEPTED ack
        and the rejection only surfaces at wait_durable — the guarded
        ack must run the same isolation instead of leaking the MANUAL
        poison error to the worker unisolated."""

        class DeferredFirstRejection(RecordingPoisonDest):
            """First poisoned write fails via the ack FUTURE (deferred);
            later writes (the bisection probes) reject synchronously."""

            def __init__(self, inner):
                super().__init__(inner)
                self.deferred_fired = False

            async def write_event_batches(self, events):
                events = list(events)
                if not self.deferred_fired:
                    try:
                        self._scan(events)
                    except EtlError as e:
                        self.deferred_fired = True
                        ack, fut = WriteAck.accepted()
                        fut.set_exception(e)
                        fut.exception()  # mark retrieved
                        return ack
                return await super().write_event_batches(events)

        store = MemoryStore()
        inner = MemoryDestination()
        dest = DeferredFirstRejection(inner)
        from dataclasses import replace

        iso = PoisonIsolator(
            store=store, destination=dest,
            config=replace(config, poison=PoisonConfig(budget_rows=100)))
        schema = make_schema()
        events = [insert_event(schema, i,
                               "POISON-x" if i == 5 else f"v{i}")
                  for i in range(10)]
        ack = await iso.submit(events)
        assert not ack.is_durable  # the guarded deferred ack
        assert dest.deferred_fired
        await ack.wait_durable()  # isolation runs HERE and resolves
        delivered = sorted(e.row.values[0] for e in inner.events)
        assert delivered == [i for i in range(10) if i != 5]
        entries = await store.list_dead_letters()
        assert [(e.table_id, e.tx_ordinal) for e in entries] \
            == [(16384, 5)]

    async def test_deferred_ack_transient_passes_through(self, config):
        """A transient failure surfacing at wait_durable keeps the
        worker-retry semantics — the guard never isolates it."""
        store = MemoryStore()

        class DeferredTransient(MemoryDestination):
            async def write_event_batches(self, events):
                ack, fut = WriteAck.accepted()
                fut.set_exception(EtlError(
                    ErrorKind.DESTINATION_CONNECTION_FAILED, "lost"))
                fut.exception()
                return ack

        iso = PoisonIsolator(store=store,
                             destination=DeferredTransient(),
                             config=config)
        ack = await iso.submit([insert_event(make_schema(), 1, "v")])
        with pytest.raises(EtlError) as ei:
            await ack.wait_durable()
        assert ei.value.kind is ErrorKind.DESTINATION_CONNECTION_FAILED
        assert await store.list_dead_letters() == []

    async def test_crash_era_reappend_accumulates_attempts(self, config):
        """Re-running the same isolation (the re-streamed flush after a
        mid-bisection kill) upserts the same poison rows."""
        store, inner, dest, iso = self.make(config, budget=100)
        schema = make_schema()
        events = [insert_event(schema, i,
                               "POISON-x" if i == 2 else f"v{i}")
                  for i in range(4)]
        await iso.submit(events)
        await iso.submit(events)  # the re-streamed window
        entries = await store.list_dead_letters()
        assert len(entries) == 1
        assert entries[0].attempts == 2


# -- ack-window multi-failure surfacing --------------------------------------


class TestAckWindowMultiFailure:
    async def test_all_failed_entries_tables_surface(self):
        from etl_tpu_torch.runtime.ack_window import AckWindow

        window = AckWindow(4)
        s1, s2 = make_schema(16384), make_schema(16385)

        async def ok():
            return None

        def failing(kind, msg):
            # fail at the DURABILITY stage (submission succeeded): this
            # is how a poisoned write actually fails — successors have
            # already submitted theirs, so multiple entries can fail in
            # one window (a submit-stage failure fences successors
            # before they submit instead)
            async def run():
                ack, fut = WriteAck.accepted()
                fut.set_exception(EtlError(kind, msg))
                return ack

            return run

        e1 = window.dispatch(
            failing(ErrorKind.DESTINATION_REJECTED, "t1 poison"),
            payload=[insert_event(s1, 1, "x")])
        e2 = window.dispatch(ok, payload=[insert_event(s2, 2, "y")])
        e3 = window.dispatch(
            failing(ErrorKind.DESTINATION_SCHEMA_FAILED, "t2 drift"),
            payload=[insert_event(s2, 3, "z")])
        await asyncio.wait([e1.task, e2.task, e3.task])
        done, failure = window.pop_ready()
        # head failed → nothing pops as done, both failures aggregate
        assert done == []
        assert isinstance(failure, EtlError)
        kinds = set(failure.kinds())
        assert {ErrorKind.DESTINATION_REJECTED,
                ErrorKind.DESTINATION_SCHEMA_FAILED} <= kinds
        assert "16384" in failure.detail and "16385" in failure.detail
        # every kind permanent → the aggregate still reads as poison
        assert is_poison_error(failure)
        window.abandon_payloads()

    async def test_single_failure_raises_unchanged(self):
        from etl_tpu_torch.runtime.ack_window import AckWindow

        window = AckWindow(4)
        boom = EtlError(ErrorKind.DESTINATION_FAILED, "one")

        async def failing():
            raise boom

        window.dispatch(failing, payload=[])
        await asyncio.wait(window.tasks())
        done, failure = window.pop_ready()
        assert failure is boom

    async def test_success_never_pops_past_failure(self):
        """Durable progress must not advance over a done SUCCESSOR of a
        failed entry — its WAL would be skipped forever."""
        from etl_tpu_torch.runtime.ack_window import AckWindow

        window = AckWindow(4)

        async def ok():
            return None

        async def failing():
            raise EtlError(ErrorKind.DESTINATION_FAILED, "x")

        window.dispatch(ok, commit_end_lsn=Lsn(10), payload=[])
        window.dispatch(failing, commit_end_lsn=Lsn(20), payload=[])
        window.dispatch(ok, commit_end_lsn=Lsn(30), payload=[])
        await asyncio.wait(window.tasks())
        done, failure = window.pop_ready()
        assert [int(e.commit_end_lsn) for e in done] == [10]
        assert failure is not None
        assert len(window) == 1  # the done successor stays


# -- destination classification ----------------------------------------------


class TestErrorClassification:
    def test_http_status_map(self):
        from etl_tpu_torch.destinations.util import classify_http_error

        cases = {
            429: ErrorKind.DESTINATION_THROTTLED,
            503: ErrorKind.DESTINATION_THROTTLED,
            500: ErrorKind.DESTINATION_THROTTLED,
            401: ErrorKind.DESTINATION_AUTH_FAILED,
            403: ErrorKind.DESTINATION_AUTH_FAILED,
            404: ErrorKind.DESTINATION_SCHEMA_FAILED,
            410: ErrorKind.DESTINATION_SCHEMA_FAILED,
            413: ErrorKind.DESTINATION_PAYLOAD_TOO_LARGE,
            400: ErrorKind.DESTINATION_REJECTED,
            422: ErrorKind.DESTINATION_REJECTED,
        }
        for status, kind in cases.items():
            err = classify_http_error("dest", status, "detail")
            assert err.kind is kind, (status, err.kind)
            assert "dest" in str(err)

    def test_permanent_4xx_is_poison_transient_is_not(self):
        from etl_tpu_torch.destinations.util import classify_http_error

        assert is_poison_error(classify_http_error("d", 400))
        assert is_poison_error(classify_http_error("d", 404))
        assert not is_poison_error(classify_http_error("d", 429))
        assert not is_poison_error(classify_http_error("d", 503))

    def test_transport_exceptions_classify(self):
        from etl_tpu_torch.destinations.util import classify_write_exception

        assert classify_write_exception("d", ConnectionError("x")).kind \
            is ErrorKind.DESTINATION_CONNECTION_FAILED
        assert classify_write_exception("d", OSError("x")).kind \
            is ErrorKind.DESTINATION_CONNECTION_FAILED
        assert classify_write_exception(
            "d", asyncio.TimeoutError()).kind is ErrorKind.TIMEOUT
        assert classify_write_exception("d", RuntimeError("x")).kind \
            is ErrorKind.DESTINATION_FAILED
        passthrough = EtlError(ErrorKind.DESTINATION_REJECTED, "as-is")
        assert classify_write_exception("d", passthrough) is passthrough

    async def test_with_retries_never_leaks_bare_exceptions(self):
        from etl_tpu_torch.destinations.util import (DestinationRetryPolicy,
                                               with_retries)

        policy = DestinationRetryPolicy(max_attempts=2,
                                        initial_delay_s=0.001,
                                        max_delay_s=0.002)

        async def bad():
            raise ConnectionResetError("socket died")

        with pytest.raises(EtlError) as ei:
            await with_retries(bad, policy,
                               lambda e: isinstance(e, ConnectionError),
                               destination="testdest")
        assert ei.value.kind is ErrorKind.DESTINATION_CONNECTION_FAILED
        assert "testdest" in ei.value.detail

    async def test_with_retries_passes_internal_control_flow(self):
        """The package's own control-flow exceptions pass through
        unwrapped (the reference's example is iceberg's CAS conflict,
        not ported; the port's is the shutdown race's)."""
        from etl_tpu_torch.destinations.util import (DestinationRetryPolicy,
                                                     with_retries)
        from etl_tpu_torch.runtime.shutdown import ShutdownRequested

        async def stop():
            raise ShutdownRequested()

        with pytest.raises(ShutdownRequested):
            await with_retries(stop, DestinationRetryPolicy(
                max_attempts=1, initial_delay_s=0.001,
                max_delay_s=0.002))

    async def test_breaker_ignores_poison_rejections(self):
        """A definitive payload rejection proves the sink is UP: the
        availability breaker must not count it (bisection probes would
        otherwise trip shedding for every table), while transient
        failures still trip it."""
        from etl_tpu_torch.supervision.breaker import BreakerState, CircuitBreaker
        from etl_tpu_torch.supervision.destination import SupervisedDestination

        class Rejecting(MemoryDestination):
            kind = ErrorKind.DESTINATION_REJECTED

            async def write_events(self, events):
                raise EtlError(self.kind, "scripted")

        breaker = CircuitBreaker(failure_threshold=2)
        dest = Rejecting()
        sup = SupervisedDestination(dest, timeout_s=5, breaker=breaker)
        for _ in range(5):
            with pytest.raises(EtlError):
                await sup.write_events([])
        assert breaker.state is BreakerState.CLOSED
        dest.kind = ErrorKind.DESTINATION_CONNECTION_FAILED
        for _ in range(2):
            with pytest.raises(EtlError):
                await sup.write_events([])
        assert breaker.state is BreakerState.OPEN


# -- operator CLI -------------------------------------------------------------


@contextlib.contextmanager
def server_in_thread(server):
    """`server` (a FakePgServer) started on an event loop of its own in a
    thread, for the CLI's `asyncio.run` in this one; yields the server
    and a function that runs a coroutine on its loop."""
    import threading

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    run(server.start())
    try:
        yield server, run
    finally:
        run(server.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()


class TestDlqCli:
    def run_cli(self, *argv) -> dict:
        from etl_tpu_torch.dlq.__main__ import main
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
        assert rc == 0, buf.getvalue()
        return json.loads(buf.getvalue())

    @pytest.fixture
    def seeded_db(self, tmp_path):
        async def seed():
            s = sqlite_store(tmp_path)
            await s.connect()
            schema = make_schema()
            await s.store_table_schema(schema, 1)
            await s.append_dead_letters(
                [make_entry(insert_event(schema, i, f"v{i}",
                                         commit=100 + i))
                 for i in range(3)])
            await s.set_table_quarantine(
                16384, QuarantineRecord(16384, 100, 3))
            await s.close()

        asyncio.new_event_loop().run_until_complete(seed())
        return str(tmp_path / "state.db")

    def test_list_inspect_discard_quarantine(self, seeded_db, tmp_path):
        base = ["--sqlite", seeded_db, "--pipeline-id", "1"]
        out = self.run_cli(*base, "list")
        assert out["count"] == 3
        eid = out["entries"][0]["entry_id"]
        detail = self.run_cli(*base, "inspect", str(eid))
        assert detail["payload"]["columns"] == ["id", "note"]
        assert detail["decoded_values"][0] == "0"
        out = self.run_cli(*base, "discard", str(eid))
        assert out["discarded"] == [eid]
        assert self.run_cli(*base, "list")["count"] == 2
        q = self.run_cli(*base, "quarantined")
        assert [r["table_id"] for r in q["quarantined"]] == [16384]

    def run_cli_failing(self, *argv) -> dict:
        from etl_tpu_torch.dlq.__main__ import main
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
        assert rc == 1, buf.getvalue()
        return json.loads(buf.getvalue())

    def test_replay_via_registry_destination_waits_typed(self, seeded_db,
                                                         tmp_path):
        """`replay --destination-json` builds the destination through
        `destinations/registry.py`: a type the port has not ported yet
        fails typed (exit 1), naming it, and marks nothing replayed;
        `memory` replays every dead entry, and a second run none."""
        base = ["--sqlite", seeded_db, "--pipeline-id", "1"]
        unported = tmp_path / "lake.json"
        unported.write_text('{"type": "lake"}')
        out = self.run_cli_failing(*base, "replay", "--destination-json",
                                   str(unported))
        assert "lake" in out["error"] and "not ported" in out["error"]
        assert self.run_cli(*base, "list")["count"] == 3
        dest_json = tmp_path / "dest.json"
        dest_json.write_text('{"type": "memory"}')
        ids = [e["entry_id"] for e in self.run_cli(*base, "list")["entries"]]
        out = self.run_cli(*base, "replay", "--destination-json",
                           str(dest_json))
        assert out == {"replayed": ids, "skipped": []}
        assert self.run_cli(*base, "list")["count"] == 0
        out = self.run_cli(*base, "replay", "--destination-json",
                           str(dest_json))
        assert out["replayed"] == []
        out = self.run_cli(*base, "unquarantine", "16384")
        assert out["lifted"] is True

    def test_postgres_store_waits_typed(self):
        """`--postgres` opens the shared PostgresStore over the wire: with
        nothing listening the CLI fails typed (exit 1, the connection
        error); against a server it lists what a PostgresStore wrote."""
        out = self.run_cli_failing("--postgres", "host=127.0.0.1 port=1",
                                   "--pipeline-id", "1", "list")
        assert "127.0.0.1:1" in out["error"]
        from etl_tpu_torch.postgres.fake import FakeDatabase
        from etl_tpu_torch.store import PostgresStore
        from etl_tpu_torch.testing.fake_pg_server import FakePgServer

        with server_in_thread(FakePgServer(FakeDatabase(),
                                           password="pw")) as (srv, run):
            from etl_tpu_torch.config import PgConnectionConfig

            async def seed():
                s = PostgresStore(PgConnectionConfig(
                    host="127.0.0.1", port=srv.port, name="postgres",
                    username="etl", password="pw"), 1)
                await s.connect()
                schema = make_schema()
                await s.store_table_schema(schema, 1)
                await s.append_dead_letters(
                    [make_entry(insert_event(schema, i, f"v{i}",
                                             commit=100 + i))
                     for i in range(2)])
                await s.close()

            run(seed())
            dsn = f"host=127.0.0.1 port={srv.port} dbname=postgres " \
                  "user=etl password=pw"
            out = self.run_cli("--postgres", dsn, "--pipeline-id", "1",
                               "list")
            assert out["count"] == 2
            assert [e["commit_lsn"] for e in out["entries"]] == [100, 101]

    def test_subprocess_reads_what_an_open_store_wrote(self, tmp_path):
        """`python -m etl_tpu_torch.dlq --sqlite` in another process lists
        the entries a store still holding the file open appended."""
        import os
        import subprocess
        import sys

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

        async def run():
            s = sqlite_store(tmp_path)
            await s.connect()
            schema = make_schema()
            await s.append_dead_letters(
                [make_entry(insert_event(schema, i, f"POISON-{i}",
                                         commit=100 + i))
                 for i in range(4)])
            proc = await asyncio.to_thread(
                subprocess.run,
                [sys.executable, "-m", "etl_tpu_torch.dlq", "--sqlite",
                 str(tmp_path / "state.db"), "--pipeline-id", "1", "list"],
                capture_output=True, text=True, timeout=120, cwd=root,
                env={**os.environ, "PYTHONPATH": root})
            entries = await s.list_dead_letters()
            await s.close()
            return proc, entries

        proc, entries = asyncio.run(run())
        assert proc.returncode == 0, proc.stderr
        out = json.loads(proc.stdout)
        assert out["count"] == 4
        assert [(d["commit_lsn"], d["tx_ordinal"], d["entry_id"])
                for d in out["entries"]] == [
            (e.commit_lsn, e.tx_ordinal, e.entry_id) for e in entries]


# -- live quarantine lifts ----------------------------------------------------


class TestLiveQuarantineLift:
    """submit() re-reads the store's quarantine records every
    `quarantine_poll_s`, so an operator `unquarantine` from another
    process takes effect on a RUNNING worker — no restart."""

    def make(self, poll: float):
        config = PipelineConfig(
            pipeline_id=1, publication_name="pub",
            poison=PoisonConfig(budget_rows=3, window_s=300.0,
                                quarantine_poll_s=poll))
        store = MemoryStore()
        inner = MemoryDestination()
        iso = PoisonIsolator(store=store,
                             destination=RecordingPoisonDest(inner),
                             config=config)
        return store, inner, iso

    async def test_lift_adopted_without_restart(self):
        store, inner, iso = self.make(poll=0.01)
        schema = make_schema()
        await store.set_table_quarantine(
            16384, QuarantineRecord(16384, 100, 3))
        ack = await iso.submit([insert_event(schema, 1, "v1")])
        assert ack.is_durable
        assert inner.events == []  # parked: quarantine loaded at start
        # the operator lifts from ANOTHER process (store-level write)
        await store.set_table_quarantine(16384, None)
        await asyncio.sleep(0.02)
        await iso.submit([insert_event(schema, 2, "v2")])
        assert [e.row.values[0] for e in inner.events] == [2]
        assert iso.quarantined_tables() == set()

    async def test_external_quarantine_adopted(self):
        store, inner, iso = self.make(poll=0.01)
        schema = make_schema()
        await iso.submit([insert_event(schema, 1, "v1")])
        assert len(inner.events) == 1
        await store.set_table_quarantine(
            16384, QuarantineRecord(16384, 100, 3))
        await asyncio.sleep(0.02)
        await iso.submit([insert_event(schema, 2, "v2")])
        assert len(inner.events) == 1  # second write parked
        entries = await store.list_dead_letters()
        assert [(e.table_id, e.tx_ordinal) for e in entries] \
            == [(16384, 2)]

    async def test_poll_zero_disables_refresh(self):
        store, inner, iso = self.make(poll=0.0)
        schema = make_schema()
        await iso.submit([insert_event(schema, 1, "v1")])
        await store.set_table_quarantine(
            16384, QuarantineRecord(16384, 100, 3))
        await asyncio.sleep(0.02)
        await iso.submit([insert_event(schema, 2, "v2")])
        # never re-read: both events delivered on the startup-loaded set
        assert len(inner.events) == 2

    async def test_store_error_keeps_current_set(self):
        store, inner, iso = self.make(poll=0.01)
        schema = make_schema()
        await store.set_table_quarantine(
            16384, QuarantineRecord(16384, 100, 3))
        await iso.submit([insert_event(schema, 1, "v1")])
        assert inner.events == []

        async def boom():
            raise EtlError(ErrorKind.STATE_STORE_FAILED, "poll down")

        store.get_quarantined_tables = boom  # type: ignore[assignment]
        await asyncio.sleep(0.02)
        await iso.submit([insert_event(schema, 2, "v2")])
        # a poll failure never fails a flush NOR forgets the local set
        assert inner.events == []
        assert iso.quarantined_tables() == {16384}


# -- per-column poison attribution --------------------------------------------


class TestColumnAttribution:
    def test_token_matching(self):
        from etl_tpu_torch.runtime.poison import attribute_poison_columns

        schema = make_schema()
        assert attribute_poison_columns(
            "invalid value for column note", schema) == "note"
        assert attribute_poison_columns(
            "note and id both malformed", schema) == "id,note"
        # substrings are NOT matches: token boundaries only
        assert attribute_poison_columns(
            "noteworthy identity mismatch", schema) == ""
        assert attribute_poison_columns("", schema) == ""

    async def test_attribution_lands_in_dlq_entry(self, config):
        store = MemoryStore()
        inner = MemoryDestination()
        iso = PoisonIsolator(store=store,
                             destination=RecordingPoisonDest(inner),
                             config=config)
        schema = make_schema()
        # the rejection detail embeds the value repr — the poison value
        # names the column, as real schema-drift rejections do
        events = [insert_event(schema, i,
                               "POISON note overflow" if i == 2
                               else f"v{i}")
                  for i in range(6)]
        await iso.submit(events)
        (entry,) = await store.list_dead_letters()
        assert entry.columns == "note"
        assert entry.describe()["columns"] == "note"

    def test_inspect_surfaces_columns(self, tmp_path):
        import dataclasses

        async def seed():
            s = sqlite_store(tmp_path)
            await s.connect()
            schema = make_schema()
            e = make_entry(insert_event(schema, 1, "v1"))
            await s.append_dead_letters(
                [dataclasses.replace(e, columns="note")])
            await s.close()

        asyncio.new_event_loop().run_until_complete(seed())
        cli = TestDlqCli()
        base = ["--sqlite", str(tmp_path / "state.db"),
                "--pipeline-id", "1"]
        out = cli.run_cli(*base, "list")
        eid = out["entries"][0]["entry_id"]
        assert out["entries"][0]["columns"] == "note"
        detail = cli.run_cli(*base, "inspect", str(eid))
        assert detail["columns"] == "note"


# -- DLQ TTL compaction -------------------------------------------------------


class TestDlqCompaction:
    async def test_purge_respects_status_and_age(self, dialect, tmp_path):
        env = _StoreEnv(dialect, tmp_path)
        try:
            store = await env.make()
            schema = make_schema()
            await store.append_dead_letters(
                [make_entry(insert_event(schema, i, f"v{i}",
                                         commit=100 + i))
                 for i in range(4)])
            got = await store.list_dead_letters()
            assert all(e.updated_at > 0 for e in got)
            dlq = DeadLetterQueue(store)
            # terminal entries inside the retention window: kept
            await store.set_dead_letter_status(got[0].entry_id,
                                               DLQ_STATUS_REPLAYED)
            await store.set_dead_letter_status(got[1].entry_id,
                                               DLQ_STATUS_DISCARDED)
            out = await dlq.compact(3600.0)
            assert out["purged"] == 0
            assert len(await store.list_dead_letters(status=None)) == 4
            # status-restricted expiry (cutoff in the future via a
            # negative window: every terminal entry is "old enough")
            out = await dlq.compact(-2.0, statuses=["replayed"])
            assert out["purged"] == 1
            # full terminal expiry; `dead` entries survive any window
            out = await dlq.compact(-2.0)
            assert out["purged"] == 1
            left = await store.list_dead_letters(status=None)
            assert sorted(e.status for e in left) \
                == [DLQ_STATUS_DEAD, DLQ_STATUS_DEAD]
        finally:
            await env.cleanup()

    async def test_compact_refuses_dead(self):
        dlq = DeadLetterQueue(MemoryStore())
        with pytest.raises(EtlError):
            await dlq.compact(0.0, statuses=["dead"])
        with pytest.raises(EtlError):
            await dlq.compact(0.0, statuses=["replayed", "dead"])

    async def test_status_transition_bumps_updated_at(self):
        import dataclasses

        store = MemoryStore()
        schema = make_schema()
        await store.append_dead_letters(
            [make_entry(insert_event(schema, 1, "v1"))])
        (e,) = await store.list_dead_letters()
        key = next(iter(store._dead_letters))
        store._dead_letters[key] = dataclasses.replace(
            e, updated_at=e.updated_at - 7 * 86400)  # age it a week
        await store.set_dead_letter_status(e.entry_id,
                                           DLQ_STATUS_REPLAYED)
        (bumped,) = await store.list_dead_letters(status=None)
        assert bumped.updated_at >= e.updated_at  # transition re-stamps

    def test_cli_compact(self, tmp_path):
        async def seed():
            s = sqlite_store(tmp_path)
            await s.connect()
            schema = make_schema()
            ids = await s.append_dead_letters(
                [make_entry(insert_event(schema, i, f"v{i}",
                                         commit=100 + i))
                 for i in range(2)])
            await s.set_dead_letter_status(ids[0], DLQ_STATUS_DISCARDED)
            await s.close()

        asyncio.new_event_loop().run_until_complete(seed())
        cli = TestDlqCli()
        base = ["--sqlite", str(tmp_path / "state.db"),
                "--pipeline-id", "1"]
        out = cli.run_cli(*base, "compact", "--older-than-s=-2")
        assert out["purged"] == 1
        assert out["statuses"] == ["discarded", "replayed"]
        # default window: nothing fresh expires
        out = cli.run_cli(*base, "compact")
        assert out["purged"] == 0 and out["older_than_s"] == 604800.0
        assert cli.run_cli(*base, "list")["count"] == 1


# -- parity with the reference codec ------------------------------------------


class TestCodecParityWithReference:
    """The same seeded events through the reference's `etl_tpu.dlq.codec`
    and the port's give the same (change type, payload) bytes: a dead
    letter the port writes reads back the same through either CLI."""

    OIDS = ("INT2", "INT4", "INT8", "BOOL", "FLOAT8", "NUMERIC", "TEXT",
            "VARCHAR", "DATE", "TIME", "TIMESTAMP", "TIMESTAMPTZ", "UUID",
            "JSONB", "BYTEA", "INTERVAL", "TIMETZ", "INT4_ARRAY")

    @staticmethod
    def texts(rng, oid: str, n: int) -> list:
        def one(i):
            if rng.random() < 0.08:
                return None
            r = int(rng.integers(0, 1 << 30))
            return {
                "INT2": lambda: str(int(rng.integers(-32768, 32768))),
                "INT4": lambda: str(int(rng.integers(-2**31, 2**31))),
                "INT8": lambda: str(int(rng.integers(-2**62, 2**62))),
                "BOOL": lambda: "tf"[r % 2],
                "FLOAT8": lambda: ["NaN", "Infinity", "-Infinity",
                                   repr(float(rng.normal()) * 1e6),
                                   "0"][r % 5],
                "NUMERIC": lambda: ["NaN", f"{r - 2**29}.{r % 1000:03d}",
                                    "0.000100"][r % 3],
                "TEXT": lambda: ["POISON-" + str(r), "",
                                 "it's a \"quoted\"\ttab", "ünï"][r % 4],
                "VARCHAR": lambda: f"v{r}",
                "DATE": lambda: ["infinity", "-infinity",
                                 f"{1 + r % 9998:04d}-{1 + r % 12:02d}-"
                                 f"{1 + r % 28:02d}"][r % 3],
                "TIME": lambda: f"{r % 24:02d}:{r % 60:02d}:"
                                f"{r % 59:02d}.{r % 10**6:06d}",
                "TIMESTAMP": lambda: f"20{r % 100:02d}-0{1 + r % 9}-1"
                                     f"{r % 9} 0{r % 10}:1{r % 10}:"
                                     f"2{r % 10}.{r % 1000:03d}",
                "TIMESTAMPTZ": lambda: f"19{r % 100:02d}-1{r % 3}-0"
                                       f"{1 + r % 9} 1{r % 10}:0{r % 10}:"
                                       f"0{r % 10}+0{r % 10}",
                "UUID": lambda: str(uuid.UUID(int=r * 7919)),
                "JSONB": lambda: ['{"k": [1, "two", null]}', "null",
                                  "[1, 2.5]", '"s"'][r % 4],
                "BYTEA": lambda: "\\x" + bytes([r % 256, 0, 255]).hex(),
                "INTERVAL": lambda: f"{r % 5} mons {r % 30} days "
                                    f"0{r % 10}:00:01",
                "TIMETZ": lambda: f"0{r % 10}:1{r % 10}:00+0{r % 10}",
                "INT4_ARRAY": lambda: "{1,NULL," + str(r) + "}",
            }[oid]()

        return [one(i) for i in range(n)]

    def rows(self, seed: int, n: int) -> list:
        rng = np.random.default_rng(seed)
        cols = [self.texts(rng, o, n) for o in self.OIDS]
        return [[c[i] for c in cols] for i in range(n)]

    @staticmethod
    def schema(pkg, oids):
        m = pkg.models
        return m.ReplicatedTableSchema.with_all_columns(m.TableSchema(
            16384, m.TableName("public", "parity"),
            tuple(m.ColumnSchema(f"c{i}", getattr(m.Oid, o),
                                 nullable=i > 0,
                                 primary_key_ordinal=1 if i == 0 else None)
                  for i, o in enumerate(oids))))

    def events(self, pkg, seed: int, n: int) -> list:
        """Per-row events of each kind over the rows' values as the
        package's CPU text codec parses them."""
        from importlib import import_module

        text = import_module(pkg.__name__ + ".postgres.codec.text")
        ev = import_module(pkg.__name__ + ".models.event")
        tr = import_module(pkg.__name__ + ".models.table_row")
        lsn = import_module(pkg.__name__ + ".models.lsn")
        schema = self.schema(pkg, self.OIDS)
        oids = [c.type_oid for c in schema.replicated_columns]
        out = []
        for i, row in enumerate(self.rows(seed, n)):
            vals = [None if v is None else text.parse_cell_text(v, o)
                    for v, o in zip(row, oids)]
            vals[0] = i  # the primary key is never NULL
            start, commit = lsn.Lsn(1000 + i), lsn.Lsn(2000 + i)
            kind = i % 3
            if kind == 0:
                out.append(ev.InsertEvent(start, commit, i, schema,
                                          tr.TableRow(vals)))
            elif kind == 1:
                present = [j == 0 for j in range(len(vals))]
                old = tr.PartialTableRow(
                    [v if p else None for v, p in zip(vals, present)],
                    present)
                out.append(ev.UpdateEvent(start, commit, i, schema,
                                          tr.TableRow(vals), old))
            else:
                out.append(ev.DeleteEvent(start, commit, i, schema,
                                          tr.TableRow(vals)))
        return out

    def test_seeded_events_encode_to_the_same_bytes(self):
        import etl_tpu
        import etl_tpu_torch
        from etl_tpu.dlq.codec import encode_row_event as ref_encode

        ref = [ref_encode(e) for e in self.events(etl_tpu, 11, 300)]
        port = [encode_row_event(e)
                for e in self.events(etl_tpu_torch, 11, 300)]
        assert len(ref) == len(port) == 300
        for i, (a, b) in enumerate(zip(ref, port)):
            assert a == b, (i, a, b)

    def test_decoded_pgbench_rows_encode_to_the_same_bytes(self):
        """Rows of one staged pgbench batch decoded by the reference's
        engine (the XLA twin on the CPU) and by the port's (the plain
        versions), expanded to per-row events: the same dead-letter bytes
        — the port's rows hold the same Python values, not numpy
        scalars."""
        from etl_tpu.destinations.base import \
            expand_batch_events as ref_expand
        from etl_tpu.dlq.codec import encode_row_event as ref_encode
        from etl_tpu.models.event import DecodedBatchEvent as RefBatchEvent
        from etl_tpu.models.lsn import Lsn as RefLsn
        from etl_tpu.ops import DeviceDecoder as RefDecoder
        from etl_tpu.ops.wal import concat_payloads as ref_concat
        from etl_tpu.ops.wal import stage_wal_batch as ref_stage
        from etl_tpu_torch import bench
        from etl_tpu_torch.destinations.base import expand_batch_events
        from etl_tpu_torch.models.event import DecodedBatchEvent
        from etl_tpu_torch.ops.engine import DeviceDecoder
        from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch

        from tests.test_torch_decoder import port_schema

        t = bench.pgbench_table(200, 5)
        bench.poison_rows(t, 0.05, 6)
        payloads = bench.table_payloads(t)
        import bench as ref_bench

        ref_schema = ref_bench.make_schema()
        ref_batch = RefDecoder(ref_schema, mesh=None, device_min_rows=0) \
            .decode(ref_stage(*ref_concat(payloads), 4).staged)
        port_batch = DeviceDecoder(port_schema(ref_schema), device="cpu",
                                   device_min_rows=0) \
            .decode(stage_wal_batch(*concat_payloads(payloads), 4).staged)
        n = ref_batch.num_rows
        ids = dict(change_types=np.zeros(n, dtype=np.uint8),
                   commit_lsns=np.full(n, 777, dtype=np.uint64),
                   tx_ordinals=np.arange(n, dtype=np.uint64))
        ref_rows = ref_expand([RefBatchEvent(
            RefLsn(700), RefLsn(777), ref_schema, batch=ref_batch, **ids)])
        port_rows = expand_batch_events([DecodedBatchEvent(
            Lsn(700), Lsn(777), port_schema(ref_schema), batch=port_batch,
            **ids)])
        assert len(ref_rows) == len(port_rows) == 200
        for a, b in zip(ref_rows, port_rows):
            assert all(type(v) in (int, str) for v in b.row.values)
            assert ref_encode(a) == encode_row_event(b)


class TestChipSmokePoisonedStream:
    async def test_poisoned_stream_over_sqlite(self, tmp_path):
        """`chip_smoke.py` phase 10(b)'s streaming run on the CPU at a
        small size: every poison row on the DLQ once under its WAL key, the
        healthy rows once each in order, the probe writes within the
        bound, and the CLI in another process listing the same entries."""
        from etl_tpu_torch import bench

        r = await bench.run_table_streaming(
            4_000, device="cpu", warmup_events=4_400, subsystems="default",
            poison_rate=0.002, store_dir=str(tmp_path))
        q = r["dlq"]
        assert q["poison_rows"] == q["entries"] == 8
        assert q["exactly_once"] and q["values_ok"] and q["bound_ok"]
        assert q["cli_ok"], q["cli_stderr"]
        assert r["count_ok"] and r["digest_ok"] and r["order_ok"]
        assert r["delivered_rows"] == 4_000 - 8 and r["ok"]
