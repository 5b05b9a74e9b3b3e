"""End-to-end pipeline tests of the port against the in-memory fake
walsender: the scenarios of tests/test_pipeline_e2e.py on
`etl_tpu_torch.runtime.Pipeline` — fake walsender → replication stream →
apply loop → EventAssembler → DecodePipeline → DeviceDecoder →
MemoryDestination — with the CUDA engine on `device="cpu"` (the kernels'
plain versions) and the CPU engine. Supervision and poison-pill isolation
are not ported, so every pipeline here passes them off explicitly."""

import asyncio

import pytest

from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.config import (BatchConfig, BatchEngine, PipelineConfig,
                                  PoisonConfig, RetryConfig,
                                  SupervisionConfig)
from etl_tpu_torch.destinations import (FaultAction,
                                        FaultInjectingDestination, FaultKind,
                                        MemoryDestination)
from etl_tpu_torch.models import (ColumnSchema, DeleteEvent, InsertEvent,
                                  Oid, TableName, TableSchema, UpdateEvent)
from etl_tpu_torch.ops.pipeline import reset_global_admission
from etl_tpu_torch.postgres.fake import FakeDatabase, FakeSource
from etl_tpu_torch.runtime import Pipeline, TableStateType
from etl_tpu_torch.store import NotifyingStore

ACCOUNTS = 16384
ORDERS = 16385

#: the unported subsystems, off (the port's Pipeline refuses them on)
OFF = dict(supervision=SupervisionConfig(enabled=False),
           poison=PoisonConfig(enabled=False))


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    failpoints.disarm_all()
    reset_global_admission()


def make_pipeline(db, store=None, destination=None, engine=BatchEngine.CUDA,
                  batch=None, **cfg):
    config = PipelineConfig(
        pipeline_id=1, publication_name="pub",
        batch=batch if batch is not None else
        BatchConfig(max_size_bytes=256 * 1024, max_fill_ms=50,
                    batch_engine=engine, device="cpu"),
        **OFF, **cfg)
    store = store if store is not None else NotifyingStore()
    destination = destination if destination is not None \
        else MemoryDestination()
    pipeline = Pipeline(config=config, store=store, destination=destination,
                        source_factory=lambda: FakeSource(db))
    return pipeline, store, destination


def make_db() -> FakeDatabase:
    db = FakeDatabase()
    db.create_table(TableSchema(
        ACCOUNTS, TableName("public", "accounts"),
        (ColumnSchema("id", Oid.INT4, nullable=False, primary_key_ordinal=1),
         ColumnSchema("name", Oid.TEXT),
         ColumnSchema("balance", Oid.INT8))),
        rows=[["1", "alice", "100"], ["2", "bob", "-5"], ["3", None, "0"]])
    db.create_table(TableSchema(
        ORDERS, TableName("public", "orders"),
        (ColumnSchema("oid", Oid.INT4, nullable=False, primary_key_ordinal=1),
         ColumnSchema("amount", Oid.NUMERIC))),
        rows=[["10", "9.99"]])
    db.create_publication("pub", [ACCOUNTS, ORDERS])
    return db


async def wait_ready(store, table_id, timeout=10.0):
    await asyncio.wait_for(store.notify_on(table_id, TableStateType.READY),
                           timeout)


class TestInitialCopyAndCdc:
    async def test_copy_then_ready(self):
        db = make_db()
        pipeline, store, dest = make_pipeline(db)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        await wait_ready(store, ORDERS)
        rows = {tuple(r.values) for r in dest.table_rows[ACCOUNTS]}
        assert rows == {(1, "alice", 100), (2, "bob", -5), (3, None, 0)}
        from etl_tpu_torch.models import PgNumeric
        assert [tuple(r.values) for r in dest.table_rows[ORDERS]] == \
            [(10, PgNumeric("9.99"))]
        await pipeline.shutdown_and_wait()

    async def test_idle_commit_flushes_before_fill_window(self):
        """Idle-commit fast path: with no write in flight, a commit
        boundary flushes IMMEDIATELY — an idle pipeline must not sit on
        a committed transaction for the whole fill window (here 5s; the
        wait below would time out if the deadline were the trigger)."""
        db = make_db()
        pipeline, store, dest = make_pipeline(
            db, batch=BatchConfig(max_size_bytes=256 * 1024,
                                  max_fill_ms=5000,
                                  batch_engine=BatchEngine.CUDA,
                                  device="cpu"))
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["42", "instant", "1"])
        await asyncio.wait_for(
            _wait_for(lambda: 42 in _account_ids(dest)), 2.0)
        await pipeline.shutdown_and_wait()

    async def test_cdc_after_ready(self):
        db = make_db()
        pipeline, store, dest = make_pipeline(db)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["4", "carol", "7"])
            tx.update(ACCOUNTS, ["1", None, None], ["1", "alice", "150"])
            tx.delete(ACCOUNTS, ["2", None, None])
        # wait for the events to land (batch deadline = 50ms)
        await _wait_for(lambda: len(_row_events(dest)) >= 3)
        evs = _row_events(dest)
        ins = [e for e in evs if isinstance(e, InsertEvent)]
        upd = [e for e in evs if isinstance(e, UpdateEvent)]
        dele = [e for e in evs if isinstance(e, DeleteEvent)]
        assert [tuple(e.row.values) for e in ins] == [(4, "carol", 7)]
        assert [tuple(e.row.values) for e in upd] == [(1, "alice", 150)]
        assert len(dele) == 1 and dele[0].old_row.values[0] == 2
        # ordering matches WAL order
        assert [type(e).__name__ for e in evs] == \
            ["InsertEvent", "UpdateEvent", "DeleteEvent"]
        await pipeline.shutdown_and_wait()

    async def test_rows_during_copy_window_arrive_once(self):
        """Rows committed between pipeline start and catchup arrive exactly
        once (via snapshot copy or CDC catchup, never both)."""
        db = make_db()
        pipeline, store, dest = make_pipeline(db)
        await pipeline.start()
        # race: insert while copy likely in flight
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["100", "race", "1"])
        await wait_ready(store, ACCOUNTS)
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["101", "after", "2"])
        await _wait_for(lambda: _account_ids(dest) >= {100, 101})
        copied = [tuple(r.values) for r in dest.table_rows[ACCOUNTS]]
        cdc = [tuple(e.row.values) for e in _row_events(dest)
               if isinstance(e, InsertEvent) and e.schema.id == ACCOUNTS]
        seen_100 = [v for v in copied + cdc if v[0] == 100]
        assert len(seen_100) == 1, f"row 100 seen {len(seen_100)} times"
        await pipeline.shutdown_and_wait()


def _row_events(dest):
    return [e for e in dest.events
            if isinstance(e, (InsertEvent, UpdateEvent, DeleteEvent))]


def _account_ids(dest):
    ids = {r.values[0] for r in dest.table_rows[ACCOUNTS]}
    for e in _row_events(dest):
        if isinstance(e, InsertEvent) and e.schema.id == ACCOUNTS:
            ids.add(e.row.values[0])
    return ids


async def _wait_for(cond, timeout=10.0, interval=0.02):
    async def poll():
        while not cond():
            await asyncio.sleep(interval)

    await asyncio.wait_for(poll(), timeout)


class TestResume:
    async def test_restart_resumes_without_duplicates(self):
        db = make_db()
        store = NotifyingStore()
        dest = MemoryDestination()
        pipeline, _, _ = make_pipeline(db, store=store, destination=dest)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        await wait_ready(store, ORDERS)
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["50", "first", "1"])
        await _wait_for(lambda: 50 in _account_ids(dest))
        await pipeline.shutdown_and_wait()
        n_events_before = len(dest.events)

        # offline WAL while pipeline is down
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["51", "offline", "2"])

        pipeline2, _, _ = make_pipeline(db, store=store, destination=dest)
        await pipeline2.start()
        await _wait_for(lambda: 51 in _account_ids(dest))
        ins_50 = [e for e in _row_events(dest)
                  if isinstance(e, InsertEvent) and e.row.values[0] == 50]
        assert len(ins_50) == 1, "event 50 re-delivered after restart"
        # copy must not re-run: tables stayed READY
        states = await store.get_table_states()
        assert states[ACCOUNTS].type is TableStateType.READY
        assert dest.dropped_tables == []
        await pipeline2.shutdown_and_wait()


class TestColumnFilters:
    async def test_publication_column_list(self):
        db = make_db()
        db.create_publication("pub", [ACCOUNTS],
                              column_filters={ACCOUNTS: ["id", "balance"]})
        pipeline, store, dest = make_pipeline(db)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        rows = {tuple(r.values) for r in dest.table_rows[ACCOUNTS]}
        assert rows == {(1, 100), (2, -5), (3, 0)}  # name filtered out
        await pipeline.shutdown_and_wait()


class TestTruncate:
    async def test_truncate_event(self):
        from etl_tpu_torch.models import TruncateEvent

        db = make_db()
        pipeline, store, dest = make_pipeline(db)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        async with db.transaction() as tx:
            tx.truncate([ACCOUNTS])
        await _wait_for(lambda: any(isinstance(e, TruncateEvent)
                                    for e in dest.events))
        ev = next(e for e in dest.events if isinstance(e, TruncateEvent))
        assert [s.id for s in ev.schemas] == [ACCOUNTS]
        await pipeline.shutdown_and_wait()


class TestEngines:
    @pytest.mark.parametrize("engine", [BatchEngine.CPU, BatchEngine.CUDA])
    async def test_both_engines_same_events(self, engine):
        db = make_db()
        pipeline, store, dest = make_pipeline(db, engine=engine)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["7", "x\ty", None])
            tx.insert(ACCOUNTS, ["8", None, "-9223372036854775808"])
        await _wait_for(lambda: len(_row_events(dest)) >= 2)
        vals = [tuple(e.row.values) for e in _row_events(dest)]
        assert vals == [(7, "x\ty", None), (8, None, -9223372036854775808)]
        await pipeline.shutdown_and_wait()

    @pytest.mark.parametrize("engine", [BatchEngine.CPU, BatchEngine.CUDA])
    async def test_old_tuple_identity_both_engines(self, engine):
        """PK-changing updates ('K' tuples), identity-full updates/deletes
        ('O' tuples) and key deletes must produce IDENTICAL events on both
        engines (reference codec/event.rs:28-50 old/new merge)."""
        from etl_tpu_torch.models.table_row import PartialTableRow

        db = make_db()
        pipeline, store, dest = make_pipeline(db, engine=engine)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        await wait_ready(store, ORDERS)
        db.set_replica_identity(ORDERS, "f")
        async with db.transaction() as tx:
            # PK change 1 → 50: PG sends a 'K' key tuple
            tx.update(ACCOUNTS, ["1", None, None], ["50", "alice", "150"])
            # non-key update: no old tuple at all
            tx.update(ACCOUNTS, ["2", None, None], ["2", "bob", "77"])
            # delete with default identity: 'K' key-only tuple
            tx.delete(ACCOUNTS, ["3", None, None])
            # identity-full table: updates and deletes carry full 'O' rows
            tx.update(ORDERS, ["10", None], ["10", "19.99"])
            tx.delete(ORDERS, ["10", None])
        await _wait_for(lambda: len(_row_events(dest)) >= 5)
        evs = _row_events(dest)
        upd_pk = next(e for e in evs if isinstance(e, UpdateEvent)
                      and e.schema.id == ACCOUNTS and e.row.values[0] == 50)
        assert isinstance(upd_pk.old_row, PartialTableRow)
        assert upd_pk.old_row.values[0] == 1
        assert list(upd_pk.old_row.present) == [True, False, False]

        upd_plain = next(e for e in evs if isinstance(e, UpdateEvent)
                         and e.schema.id == ACCOUNTS and e.row.values[0] == 2)
        assert upd_plain.old_row is None

        del_k = next(e for e in evs if isinstance(e, DeleteEvent)
                     and e.schema.id == ACCOUNTS)
        assert isinstance(del_k.old_row, PartialTableRow)
        assert del_k.old_row.values[0] == 3
        assert list(del_k.old_row.present) == [True, False, False]

        from etl_tpu_torch.models import PgNumeric
        upd_full = next(e for e in evs if isinstance(e, UpdateEvent)
                        and e.schema.id == ORDERS)
        assert type(upd_full.old_row).__name__ == "TableRow"
        assert tuple(upd_full.old_row.values) == (10, PgNumeric("9.99"))

        del_full = next(e for e in evs if isinstance(e, DeleteEvent)
                        and e.schema.id == ORDERS)
        assert type(del_full.old_row).__name__ == "TableRow"
        assert tuple(del_full.old_row.values) == (10, PgNumeric("19.99"))
        await pipeline.shutdown_and_wait()


class TestFaults:
    async def test_copy_reject_then_retry_recovers(self):
        db = make_db()
        db.create_publication("pub", [ACCOUNTS])
        dest = FaultInjectingDestination(MemoryDestination())
        dest.script("write_table_rows", FaultAction(FaultKind.REJECT))
        pipeline, store, _ = make_pipeline(
            db, destination=dest,
            table_retry=RetryConfig(max_attempts=5, initial_delay_ms=20))
        await pipeline.start()
        # first copy attempt fails → Errored → timed retry → success
        await asyncio.wait_for(
            store.notify_on(ACCOUNTS, TableStateType.ERRORED), 10.0)
        await wait_ready(store, ACCOUNTS)
        rows = {tuple(r.values) for r in dest.inner.table_rows[ACCOUNTS]}
        assert rows == {(1, "alice", 100), (2, "bob", -5), (3, None, 0)}
        # crash-consistency: the second attempt dropped the half-written table
        assert ACCOUNTS in dest.inner.dropped_tables
        await pipeline.shutdown_and_wait()

    async def test_held_write_defers_durability(self):
        """An Accepted-but-not-durable write must not advance durable
        progress until released (reference async_result.rs semantics)."""
        db = make_db()
        db.create_publication("pub", [ACCOUNTS])
        release = asyncio.Event()
        dest = FaultInjectingDestination(MemoryDestination())
        pipeline, store, _ = make_pipeline(db, destination=dest)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        from etl_tpu_torch.postgres.slots import apply_slot_name

        key = apply_slot_name(1)
        progress_before = await store.get_durable_progress(key)
        dest.script("write_events", FaultAction(FaultKind.HOLD,
                                                release_event=release))
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["60", "held", "0"])
        await _wait_for(lambda: dest.write_events_calls >= 1)
        await asyncio.sleep(0.1)  # give the loop a chance to (wrongly) ack
        progress_held = await store.get_durable_progress(key)
        assert progress_held == progress_before, \
            "durable progress advanced on a non-durable ack"
        release.set()
        await _wait_for(lambda: (asyncio.get_event_loop(),)[0] is not None
                        and True)
        await _wait_for_progress(store, key, progress_before)
        await pipeline.shutdown_and_wait()


async def _wait_for_progress(store, key, above, timeout=10.0):
    async def poll():
        while True:
            p = await store.get_durable_progress(key)
            if p is not None and (above is None or p > above):
                return
            await asyncio.sleep(0.02)

    await asyncio.wait_for(poll(), timeout)


class TestPublicationChanges:
    async def test_unpublished_table_purged(self):
        db = make_db()
        store = NotifyingStore()
        pipeline, _, dest = make_pipeline(db, store=store)
        await pipeline.start()
        await wait_ready(store, ORDERS)
        await pipeline.shutdown_and_wait()
        # drop ORDERS from the publication and restart
        db.create_publication("pub", [ACCOUNTS])
        pipeline2, _, _ = make_pipeline(db, store=store, destination=dest)
        await pipeline2.start()
        await _wait_for(lambda: True)
        states = await store.get_table_states()
        assert ORDERS not in states
        await pipeline2.shutdown_and_wait()


class TestSchemaChanges:
    async def test_ddl_message_versions_schema_and_reaches_destination(self):
        """DDL logical messages (the source event-trigger payload) version
        the schema store and flow to the destination
        (reference pipelines_with_schema_changes.rs)."""
        from etl_tpu_torch.models import SchemaChangeEvent
        from etl_tpu_torch.models.schema import ColumnSchema as CS, TableSchema as TS
        from etl_tpu_torch.postgres.codec.event import (DDL_MESSAGE_PREFIX,
                                                  encode_schema_change)

        db = make_db()
        db.create_publication("pub", [ACCOUNTS])
        pipeline, store, dest = make_pipeline(db)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)

        old = db.tables[ACCOUNTS].schema
        new_schema = TS(ACCOUNTS, old.name, old.columns
                        + (CS("added_col", Oid.TEXT),))
        async with db.transaction() as tx:
            tx.logical_message(DDL_MESSAGE_PREFIX,
                               encode_schema_change(ACCOUNTS, new_schema))
        await _wait_for(lambda: any(isinstance(e, SchemaChangeEvent)
                                    for e in dest.events))
        ev = next(e for e in dest.events if isinstance(e, SchemaChangeEvent))
        assert [c.name for c in ev.new_schema.table_schema.columns][-1] == \
            "added_col"
        # versioned store: old schema still readable below the DDL LSN
        versions = await store.get_schema_versions(ACCOUNTS)
        assert len(versions) == 2
        at_old = await store.get_table_schema(ACCOUNTS,
                                              at_snapshot=versions[0])
        assert len(at_old.table_schema.columns) == 3
        latest = await store.get_table_schema(ACCOUNTS)
        assert len(latest.table_schema.columns) == 4
        await pipeline.shutdown_and_wait()


class TestConnectionChaos:
    async def test_stream_drop_mid_cdc_recovers(self):
        """Severing the replication stream mid-CDC (the NetworkChaos
        analogue, SURVEY §4.8) must retry and deliver everything exactly
        once past the durable watermark."""
        from etl_tpu_torch.config import RetryConfig

        db = make_db()
        db.create_publication("pub", [ACCOUNTS])
        pipeline, store, dest = make_pipeline(
            db, apply_retry=RetryConfig(max_attempts=10, initial_delay_ms=20))
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["600", "pre-cut", "1"])
        await _wait_for(lambda: 600 in _account_ids(dest))
        await db.sever_streams()
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["601", "post-cut", "2"])
        await _wait_for(lambda: 601 in _account_ids(dest), timeout=20)
        n600 = sum(1 for e in _row_events(dest)
                   if isinstance(e, InsertEvent) and e.row.values[0] == 600)
        assert n600 == 1, "duplicate delivery after reconnect"
        await pipeline.shutdown_and_wait()


class TestBackpressure:
    async def test_pressure_pauses_intake_then_recovers(self):
        """Memory pressure must pause WAL intake (no events land) and the
        hysteresis resume must deliver everything afterwards: the memory
        defense wired into the data path."""
        from etl_tpu_torch.config import MemoryBackpressureConfig

        db = make_db()
        pipeline, store, dest = make_pipeline(
            db, backpressure=MemoryBackpressureConfig(
                refresh_interval_ms=10))
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)

        # drive the monitor with a fake RSS: pressure on
        fake_rss = [10**9]
        m = pipeline.memory_monitor
        m.limit_bytes = 10**6
        m._rss_reader = lambda: fake_rss[0]
        for _ in range(100):
            if m.pressure:
                break
            await asyncio.sleep(0.01)
        assert m.pressure

        async with db.transaction() as tx:
            for i in range(50):
                tx.insert(ACCOUNTS, [str(1000 + i), "bulk", str(i)])
        await asyncio.sleep(0.3)
        assert len(_row_events(dest)) == 0, \
            "events delivered while intake should be paused"

        fake_rss[0] = 0  # below resume ratio → hysteresis releases
        await _wait_for(lambda: len(_row_events(dest)) >= 50)
        vals = {e.row.values[0] for e in _row_events(dest)}
        assert vals == {1000 + i for i in range(50)}
        await pipeline.shutdown_and_wait()

    async def test_budget_shrinks_batch_threshold(self):
        """With many active streams the per-stream budget drops below the
        static max_size_bytes (batch_budget.rs:72-96)."""
        from etl_tpu_torch.config import MemoryBackpressureConfig
        from etl_tpu_torch.runtime.backpressure import BatchBudgetController

        ctl = BatchBudgetController(
            MemoryBackpressureConfig(memory_ratio=0.2), max_bytes=8 << 20,
            limit_bytes=100 << 20)
        leases = [ctl.register_stream() for _ in range(10)]
        try:
            # 100MiB × 0.2 / 10 = 2MiB < 8MiB cap
            assert leases[0].ideal_batch_bytes() == 2 << 20
        finally:
            for l in leases:
                l.release()


class TestPortRules:
    """What the port refuses, and the route its batches take."""

    @pytest.mark.parametrize("field", ["supervision", "poison", "shard"])
    def test_unported_subsystems_refused_at_construction(self, field):
        from etl_tpu_torch.models.errors import EtlError

        kw = dict(OFF)
        if field == "shard":
            kw["shard"], kw["shard_count"] = 0, 2
        else:
            kw.pop(field)  # the reference default: enabled
        config = PipelineConfig(pipeline_id=1, publication_name="pub",
                                batch=BatchConfig(device="cpu"), **kw)
        with pytest.raises(EtlError, match="not ported"):
            Pipeline(config=config, store=NotifyingStore(),
                     destination=MemoryDestination(),
                     source_factory=lambda: FakeSource(make_db()))

    async def test_cuda_engine_without_card_raises_at_start(self):
        import torch

        from etl_tpu_torch.models.errors import EtlError

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        db = make_db()
        db.create_publication("pub", [ACCOUNTS])
        pipeline, _, _ = make_pipeline(
            db, batch=BatchConfig(batch_engine=BatchEngine.CUDA,
                                  device="cuda"))
        with pytest.raises(EtlError, match="no CUDA device"):
            await pipeline.start()

    async def test_copy_and_cdc_take_the_device_route(self, monkeypatch):
        """Copy chunks and CDC runs of >= 64 rows go through the kernel
        wrapper (its plain version on the CPU), never the oracle; under
        an offload row filter the filtered wrapper runs."""
        from etl_tpu_torch.ops import decode_kernel
        from etl_tpu_torch.ops import engine as engine_mod

        calls = {"decode_pack": 0, "prepare_filtered": 0}

        def counting(name):
            inner = getattr(decode_kernel, name)

            def wrapped(*a, **kw):
                calls[name] += 1
                return inner(*a, **kw)
            return wrapped

        for name in calls:
            monkeypatch.setattr(engine_mod.decode_kernel, name,
                                counting(name))
        db = FakeDatabase()
        db.create_table(TableSchema(
            ACCOUNTS, TableName("public", "accounts"),
            (ColumnSchema("id", Oid.INT4, nullable=False,
                          primary_key_ordinal=1),
             ColumnSchema("bid", Oid.INT4))),
            rows=[[str(i), str(i % 10)] for i in range(200)])
        db.create_publication("pub", [ACCOUNTS], row_filters={
            ACCOUNTS: ("bid <= 5", lambda r: int(r[1]) <= 5)})
        db.server_row_filtering = False
        pipeline, store, dest = make_pipeline(db)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        assert calls["prepare_filtered"] >= 1  # the copy chunk
        assert sorted(r.values[0] for r in dest.table_rows[ACCOUNTS]) \
            == [i for i in range(200) if i % 10 <= 5]
        before = calls["prepare_filtered"]
        async with db.transaction() as tx:
            for i in range(1000, 1100):
                tx.insert(ACCOUNTS, [str(i), str(i % 10)])
        await _wait_for(lambda: len(_row_events(dest)) >= 60)
        await asyncio.sleep(0.1)
        assert calls["prepare_filtered"] > before  # the CDC insert run
        assert sorted(e.row.values[0] for e in _row_events(dest)) \
            == [i for i in range(1000, 1100) if i % 10 <= 5]
        # an unfiltered table's runs take the unfiltered wrapper
        await pipeline.shutdown_and_wait()
        db2 = make_db()
        async with db2.transaction() as tx:
            for i in range(500, 600):
                tx.insert(ACCOUNTS, [str(i), "n", str(i)])
        pipeline, store, dest = make_pipeline(db2)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        n0 = calls["decode_pack"]
        assert n0 >= 1  # the 103-row copy
        async with db2.transaction() as tx:
            for i in range(700, 780):
                tx.insert(ACCOUNTS, [str(i), "m", str(i)])
        await _wait_for(lambda: len(_row_events(dest)) >= 80)
        assert calls["decode_pack"] > n0
        await pipeline.shutdown_and_wait()

    async def test_no_decode_thread_outlives_shutdown(self):
        import threading

        from etl_tpu_torch.ops.pipeline import global_admission

        db = make_db()
        pipeline, store, dest = make_pipeline(db)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        async with db.transaction() as tx:
            for i in range(2000, 2100):
                tx.insert(ACCOUNTS, [str(i), "t", "1"])
        await _wait_for(lambda: len(_row_events(dest)) >= 100)
        await pipeline.shutdown_and_wait()
        deadline = asyncio.get_event_loop().time() + 10
        while any(t.name.startswith("etl-") and t.name.endswith("-pipeline")
                  for t in threading.enumerate()):
            assert asyncio.get_event_loop().time() < deadline
            await asyncio.sleep(0.02)
        sched = global_admission()
        assert sched.in_flight == 0
        assert sched.stats()["tenants"] == {}
