"""The port's durable SQL stores (`etl_tpu_torch.store.sql.SqliteStore` and
`PostgresStore`), held to the reference's tests/test_sql_store.py: state
history, pipeline isolation, progress, schema versions, destination
metadata and quoting across a restart, on both dialects (Postgres over
the port's wire client against the port's socket-level fake server); a
Pipeline restarted over the same file; the extended protocol's
placeholders and bound values; the Postgres store's connection pool; a
store written before the dead-letter columns existed, upgraded in place;
bound values that quote the store's own table names. Plus the
reference's stores and the port's reading each other's data: the same
sqlite file, and the same `etl` schema over the wire (the fake servers'
embedded sqlite), down to a replicator moved from the reference to the
port resuming from the reference's PostgresStore.
"""

import asyncio
import importlib
import sqlite3

import pytest

from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.models import (ColumnSchema, Lsn, Oid,
                                  ReplicatedTableSchema, RetryKind,
                                  TableName, TableSchema)
from etl_tpu_torch.models.errors import EtlError
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission
from etl_tpu_torch.runtime.state import TableState, TableStateType
from etl_tpu_torch.store.base import DestinationTableMetadata
from etl_tpu_torch.config import PgConnectionConfig
from etl_tpu_torch.postgres.fake import FakeDatabase
from etl_tpu_torch.store.sql import PostgresStore, SqliteStore
from etl_tpu_torch.testing.fake_pg_server import FakePgServer


@pytest.fixture(autouse=True)
def _port_hygiene():
    """The forced-oracle state is module-global (as in the reference): a
    test that left it set would move every later batch of this worker
    onto the oracle."""
    yield
    engine.clear_forced_oracle()
    failpoints.disarm_all()
    reset_global_admission()


def schema(tid=5):
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        tid, TableName("public", "t"),
        (ColumnSchema("a", Oid.INT4, nullable=False, primary_key_ordinal=1),
         ColumnSchema("b", Oid.TEXT))))


class StoreEnv:
    """Stores of one dialect sharing backing storage (a sqlite file, or
    one fake server's embedded database), so a second `make()` models a
    process restart."""

    def __init__(self, dialect: str, tmp_path):
        self.dialect = dialect
        self.tmp_path = tmp_path
        self._server = None
        self._stores = []

    async def make(self, pipeline_id: int = 1):
        if self.dialect == "sqlite":
            s = SqliteStore(self.tmp_path / "store.db", pipeline_id)
        else:
            if self._server is None:
                self._server = FakePgServer(FakeDatabase())
                await self._server.start()
            s = PostgresStore(pg_config(self._server.port), pipeline_id)
        await s.connect()
        self._stores.append(s)
        return s

    async def cleanup(self):
        for s in self._stores:
            try:
                await s.close()
            except Exception:
                pass
        if self._server is not None:
            await self._server.stop()


def pg_config(port: int) -> PgConnectionConfig:
    return PgConnectionConfig(host="127.0.0.1", port=port, name="postgres",
                              username="etl")


DIALECTS = ["sqlite", "postgres"]


@pytest.mark.parametrize("dialect", DIALECTS)
class TestSqlStoreDialects:
    async def test_states_persist_across_restart(self, dialect, tmp_path):
        env = StoreEnv(dialect, tmp_path)
        try:
            s1 = await env.make()
            await s1.update_table_state(5, TableState.init())
            await s1.update_table_state(5, TableState.data_sync())
            await s1.update_table_state(
                5, TableState.errored("x", retry_policy=RetryKind.MANUAL,
                                      retry_attempts=2))
            await s1.close()

            s2 = await env.make()
            st = await s2.get_table_state(5)
            assert st.type is TableStateType.ERRORED
            assert st.retry_policy is RetryKind.MANUAL
            assert st.retry_attempts == 2
            # prev-pointer history chain preserved oldest→newest
            hist = await s2.state_history(5)
            assert [h.type for h in hist] == [
                TableStateType.INIT, TableStateType.DATA_SYNC,
                TableStateType.ERRORED]
        finally:
            await env.cleanup()

    async def test_pipeline_isolation(self, dialect, tmp_path):
        env = StoreEnv(dialect, tmp_path)
        try:
            a = await env.make(1)
            b = await env.make(2)
            await a.update_table_state(5, TableState.ready())
            assert await b.get_table_state(5) is None
        finally:
            await env.cleanup()

    async def test_memory_only_rejected(self, dialect, tmp_path):
        env = StoreEnv(dialect, tmp_path)
        try:
            s = await env.make()
            with pytest.raises(EtlError):
                await s.update_table_state(1, TableState.sync_wait(Lsn(1)))
        finally:
            await env.cleanup()

    async def test_progress_monotonic_and_durable(self, dialect, tmp_path):
        env = StoreEnv(dialect, tmp_path)
        try:
            s = await env.make()
            assert await s.update_durable_progress("slot_a", Lsn(100))
            assert not await s.update_durable_progress("slot_a", Lsn(50))
            await s.close()
            s2 = await env.make()
            assert await s2.get_durable_progress("slot_a") == Lsn(100)
            # regression attempt after reload also rejected
            assert not await s2.update_durable_progress("slot_a", Lsn(99))
            await s2.delete_durable_progress("slot_a")
            assert await s2.get_durable_progress("slot_a") is None
        finally:
            await env.cleanup()

    async def test_schema_versions_durable(self, dialect, tmp_path):
        env = StoreEnv(dialect, tmp_path)
        try:
            s = await env.make()
            r1 = schema()
            await s.store_table_schema(r1, 0)
            cols2 = r1.table_schema.columns + (ColumnSchema("c", Oid.BOOL),)
            r2 = ReplicatedTableSchema.with_all_columns(
                TableSchema(5, r1.name, cols2))
            await s.store_table_schema(r2, 500)
            await s.close()

            s2 = await env.make()
            assert (await s2.get_table_schema(5, at_snapshot=100)) == r1
            assert (await s2.get_table_schema(5)) == r2
            assert await s2.get_schema_versions(5) == [0, 500]
            assert await s2.prune_schema_versions(5, 600) == 1
            assert await s2.get_schema_versions(5) == [500]
            await s2.close()
            # prune is durable too
            s3 = await env.make()
            assert await s3.get_schema_versions(5) == [500]
        finally:
            await env.cleanup()

    async def test_destination_metadata(self, dialect, tmp_path):
        env = StoreEnv(dialect, tmp_path)
        try:
            s = await env.make()
            await s.update_destination_metadata(
                DestinationTableMetadata(5, "public_t", generation=2))
            await s.close()
            s2 = await env.make()
            m = await s2.get_destination_metadata(5)
            assert m.destination_table_name == "public_t" \
                and m.generation == 2
        finally:
            await env.cleanup()

    async def test_state_json_with_quotes_roundtrips(self, dialect, tmp_path):
        env = StoreEnv(dialect, tmp_path)
        try:
            s = await env.make()
            msg = "it's a 'quoted' failure; DROP TABLE x; --"
            await s.update_table_state(7, TableState.errored(
                msg, retry_policy=RetryKind.MANUAL, retry_attempts=1))
            await s.close()
            s2 = await env.make()
            st = await s2.get_table_state(7)
            assert st.reason == msg
        finally:
            await env.cleanup()


class TestPipelineWithSqliteStore:
    @pytest.mark.parametrize("defaults", [False, True],
                             ids=["unsupervised", "reference-defaults"])
    async def test_e2e_with_durable_store(self, tmp_path, defaults):
        """Pipeline restart with a durable store: states and progress come
        from disk, copy doesn't re-run. With the reference defaults too
        (supervision and poison on)."""
        from etl_tpu_torch.config import (BatchConfig, BatchEngine,
                                          PipelineConfig, PoisonConfig,
                                          SupervisionConfig)
        from etl_tpu_torch.destinations import MemoryDestination
        from etl_tpu_torch.models import InsertEvent
        from etl_tpu_torch.postgres.fake import FakeSource
        from etl_tpu_torch.runtime import Pipeline

        from tests.test_torch_pipeline_e2e import ACCOUNTS, _wait_for, \
            make_db

        db = make_db()
        db.create_publication("pub2", [ACCOUNTS])
        dest = MemoryDestination()
        path = tmp_path / "pipeline.db"
        off = {} if defaults else dict(
            supervision=SupervisionConfig(enabled=False),
            poison=PoisonConfig(enabled=False))

        async def run_once(insert_id=None):
            store = SqliteStore(path, 1)
            await store.connect()
            p = Pipeline(
                config=PipelineConfig(
                    pipeline_id=1, publication_name="pub2",
                    batch=BatchConfig(max_size_bytes=1 << 20, max_fill_ms=30,
                                      batch_engine=BatchEngine.CUDA,
                                      device="cpu"), **off),
                store=store, destination=dest,
                source_factory=lambda: FakeSource(db))
            await p.start()
            await _wait_for(lambda: store._states.get(ACCOUNTS) is not None
                            and store._states[ACCOUNTS].type
                            is TableStateType.READY, timeout=15)
            if insert_id is not None:
                async with db.transaction() as tx:
                    tx.insert(ACCOUNTS, [str(insert_id), "d", "0"])
                await _wait_for(lambda: any(
                    isinstance(e, InsertEvent)
                    and e.row.values[0] == insert_id for e in dest.events))
            await p.shutdown_and_wait()
            await store.close()

        await run_once(insert_id=80)
        assert len(dest.table_rows[ACCOUNTS]) == 3
        await run_once(insert_id=81)
        # copy did not re-run; no duplicate CDC for 80
        assert len(dest.table_rows[ACCOUNTS]) == 3
        n80 = sum(1 for e in dest.events
                  if getattr(e, "row", None) and e.row.values[0] == 80)
        assert n80 == 1


_LEGACY_SCRIPT = """
CREATE TABLE etl_replication_state (
    id INTEGER PRIMARY KEY, pipeline_id BIGINT NOT NULL,
    table_id BIGINT NOT NULL, state TEXT NOT NULL, prev BIGINT,
    is_current INTEGER NOT NULL DEFAULT 1);
CREATE UNIQUE INDEX etl_replication_state_current
    ON etl_replication_state (pipeline_id, table_id) WHERE is_current = 1;
CREATE TABLE etl_replication_progress (
    pipeline_id BIGINT NOT NULL, progress_key TEXT NOT NULL,
    lsn BIGINT NOT NULL, PRIMARY KEY (pipeline_id, progress_key));
CREATE TABLE etl_dead_letter (
    id INTEGER PRIMARY KEY, pipeline_id BIGINT NOT NULL,
    table_id BIGINT NOT NULL, commit_lsn BIGINT NOT NULL,
    tx_ordinal BIGINT NOT NULL, change_type BIGINT NOT NULL,
    payload TEXT NOT NULL, error_kind TEXT NOT NULL, detail TEXT NOT NULL,
    attempts BIGINT NOT NULL DEFAULT 1,
    status TEXT NOT NULL DEFAULT 'dead');
CREATE UNIQUE INDEX etl_dead_letter_key
    ON etl_dead_letter (pipeline_id, table_id, commit_lsn, tx_ordinal,
                        change_type);
INSERT INTO etl_replication_state
    (pipeline_id, table_id, state, prev, is_current)
    VALUES (1, 777, '{"state": "ready"}', NULL, 1);
INSERT INTO etl_replication_progress VALUES (1, 'apply', 4096);
INSERT INTO etl_dead_letter
    (pipeline_id, table_id, commit_lsn, tx_ordinal, change_type, payload,
     error_kind, detail)
    VALUES (1, 777, 300, 2, 0, '{"v": 1, "values": [1]}',
            'DESTINATION_REJECTED', 'old');
"""


class TestLegacySchemaUpgrade:
    async def test_flat_table_state_survives_upgrade(self, tmp_path):
        """A sqlite file written before the later migrations (no
        `poison_columns`/`updated_at` on the dead letters, no shard,
        autoscale, quarantine or fleet tables): `connect()` upgrades it in
        place and keeps what it held, instead of restarting replication
        from empty."""
        path = tmp_path / "legacy.db"
        legacy = sqlite3.connect(path)
        legacy.executescript(_LEGACY_SCRIPT)
        legacy.commit()
        legacy.close()
        s = SqliteStore(path, 1)
        await s.connect()
        try:
            st = await s.get_table_state(777)
            assert st is not None and st.type.value == "ready"
            assert await s.get_durable_progress("apply") == Lsn(4096)
            (entry,) = await s.list_dead_letters()
            assert (entry.table_id, entry.commit_lsn, entry.tx_ordinal) \
                == (777, 300, 2)
            assert entry.columns == "" and entry.updated_at == 0
            assert await s.get_quarantined_tables() == {}
        finally:
            await s.close()
        # a second connect finds every migration applied already
        s2 = SqliteStore(path, 1)
        await s2.connect()
        assert (await s2.get_table_state(777)).type.value == "ready"
        await s2.close()


class TestQualifiedNameInBoundValue:
    async def test_literal_containing_qualified_table_name_roundtrips(
            self, tmp_path):
        """Bound values that quote the store's own table names (an error
        reason naming a relation) round-trip byte-identical, read back from
        the file after a restart, not from the cache."""
        reason = ('relation "etl.replication_state" does not exist; '
                  "DELETE FROM etl_replication_state; --")
        s = SqliteStore(tmp_path / "q.db", 1)
        await s.connect()
        await s.update_table_state(5, TableState.errored(reason))
        await s.close()
        s2 = SqliteStore(tmp_path / "q.db", 1)
        await s2.connect()
        st = await s2.get_table_state(5)
        assert st is not None and st.reason == reason
        assert (await s2.state_history(5))[-1].reason == reason
        await s2.close()


class TestFileParityWithReference:
    """The port's SqliteStore and the reference's run the same statement
    set: a file either writes, the other reads the same."""

    async def test_reference_file_reads_back_in_the_port(self, tmp_path):
        from etl_tpu.models import Lsn as RefLsn
        from etl_tpu.runtime.state import TableState as RefState
        from etl_tpu.store.base import QuarantineRecord as RefRecord
        from etl_tpu.store.sql import SqliteStore as RefStore

        ref = RefStore(tmp_path / "x.db", 1)
        await ref.connect()
        await ref.update_table_state(5, RefState.init())
        await ref.update_table_state(5, RefState.ready())
        await ref.update_durable_progress("apply", RefLsn(512))
        await ref.set_table_quarantine(5, RefRecord(5, 100, 2, reason="r"))
        await ref.close()
        port = SqliteStore(tmp_path / "x.db", 1)
        await port.connect()
        try:
            assert (await port.get_table_state(5)).type \
                is TableStateType.READY
            assert [h.type for h in await port.state_history(5)] == [
                TableStateType.INIT, TableStateType.READY]
            assert await port.get_durable_progress("apply") == Lsn(512)
            rec = (await port.get_quarantined_tables())[5]
            assert (rec.since_lsn, rec.poison_rows, rec.reason) \
                == (100, 2, "r")
        finally:
            await port.close()

    async def test_port_dead_letters_read_back_in_the_reference(
            self, tmp_path):
        from etl_tpu.store.sql import SqliteStore as RefStore
        from etl_tpu_torch.store.base import DeadLetterEntry

        port = SqliteStore(tmp_path / "y.db", 1)
        await port.connect()
        ids = await port.append_dead_letters([DeadLetterEntry(
            entry_id=0, table_id=16384, commit_lsn=100 + i, tx_ordinal=i,
            change_type=0, payload='{"v": 1}', error_kind="poison",
            detail="d", columns="note") for i in range(3)])
        await port.close()
        ref = RefStore(tmp_path / "y.db", 1)
        await ref.connect()
        try:
            got = await ref.list_dead_letters()
            assert [e.entry_id for e in got] == ids
            assert [(e.commit_lsn, e.tx_ordinal, e.columns) for e in got] \
                == [(100 + i, i, "note") for i in range(3)]
        finally:
            await ref.close()

    def test_store_module_has_no_postgres_dialect(self):
        """Since the wire client is ported, the store module has the
        Postgres dialect beside the sqlite one, exported as the
        reference's is."""
        import etl_tpu_torch.store as store
        import etl_tpu_torch.store.sql as sql

        assert store.PostgresStore is sql.PostgresStore
        assert store.SqliteStore is SqliteStore
        assert asyncio.iscoroutinefunction(SqliteStore.connect)
        assert asyncio.iscoroutinefunction(PostgresStore.connect)
        assert sql.STORE_TABLE_NAMES == \
            importlib.import_module("etl_tpu.store.sql").STORE_TABLE_NAMES


class TestExtendedProtocol:
    def test_dollar_conversion(self):
        from etl_tpu_torch.store.sql import to_dollar_params

        assert to_dollar_params("a = ? AND b = ?", 2) == "a = $1 AND b = $2"
        assert to_dollar_params("SELECT '?' , ?", 1) == "SELECT '?' , $1"
        with pytest.raises(EtlError):
            to_dollar_params("a = ?", 2)

    def test_qualification_equals_reference(self):
        from etl_tpu.store.sql import MIGRATIONS as REF_MIGRATIONS
        from etl_tpu.store.sql import qualify_etl_schema as ref_qualify
        from etl_tpu_torch.store.sql import MIGRATIONS, qualify_etl_schema

        assert MIGRATIONS == REF_MIGRATIONS
        for _, ddl in MIGRATIONS:
            assert qualify_etl_schema(ddl) == ref_qualify(ddl)
        assert qualify_etl_schema(
            "SELECT * FROM etl_replication_state_current, "
            "etl_dead_letter") == \
            "SELECT * FROM etl_replication_state_current, etl.dead_letter"

    async def test_hostile_params_are_data_not_sql(self, tmp_path):
        """Server-side binding: a value full of quote, comment and
        statement syntax round-trips verbatim on the Postgres dialect."""
        env = StoreEnv("postgres", tmp_path)
        try:
            s = await env.make()
            evil = "x'; DROP TABLE etl_replication_state; --\n$1 ' OR '1'='1"
            await s.update_table_state(5, TableState.errored(
                evil, retry_policy=RetryKind.MANUAL, retry_attempts=1))
            await s.close()
            s2 = await env.make()
            st = await s2.get_table_state(5)
            assert st.reason == evil
            assert (await s2.state_history(5))[-1].reason == evil
        finally:
            await env.cleanup()

    async def test_nul_byte_refused_typed(self, tmp_path):
        env = StoreEnv("postgres", tmp_path)
        try:
            s = await env.make()
            with pytest.raises(EtlError) as ei:
                await s.update_destination_metadata(
                    DestinationTableMetadata(5, "a\x00b"))
            assert ei.value.kind.name == "STORE_SERIALIZATION_FAILED"
        finally:
            await env.cleanup()


class TestLegacySchemaUpgradeOverWire:
    async def test_flat_table_state_survives_upgrade(self):
        """The Postgres dialect's one-time legacy migration (flat `etl_*`
        tables moved into the `etl` schema): seeded flat tables in the
        fake server's embedded database read back through the qualified
        statement set, as in the reference's test."""
        db = FakeDatabase()
        legacy = sqlite3.connect(":memory:", check_same_thread=False)
        legacy.isolation_level = None
        legacy.executescript(_LEGACY_SCRIPT)
        db._store_sql_db = legacy
        server = FakePgServer(db)
        await server.start()
        try:
            s = PostgresStore(pg_config(server.port), 1)
            await s.connect()
            st = await s.get_table_state(777)
            assert st is not None and st.type.value == "ready"
            assert await s.get_durable_progress("apply") == Lsn(4096)
            (entry,) = await s.list_dead_letters()
            assert (entry.table_id, entry.commit_lsn) == (777, 300)
            await s.close()
            alters = [q for q in server.queries if q.startswith("ALTER")]
            assert "ALTER TABLE IF EXISTS etl_replication_state SET SCHEMA " \
                "etl" in alters
        finally:
            await server.stop()

    async def test_literal_containing_qualified_table_name_roundtrips(self):
        reason = ('relation "etl.replication_state" does not exist; '
                  "DELETE FROM etl_replication_state; --")
        server = FakePgServer(FakeDatabase())
        await server.start()
        try:
            s = PostgresStore(pg_config(server.port), 1)
            await s.connect()
            await s.update_table_state(5, TableState.errored(reason))
            s2 = PostgresStore(pg_config(server.port), 1)
            await s2.connect()
            st = await s2.get_table_state(5)
            assert st is not None and st.reason == reason
            await s.close()
            await s2.close()
        finally:
            await server.stop()


class TestPostgresPool:
    """The PostgresStore's connection pool (the reference's sqlx pool):
    concurrent callers ride separate wire connections; a transaction pins
    one connection for its whole BEGIN..COMMIT."""

    async def test_concurrent_writers_use_separate_connections(self):
        server = FakePgServer(FakeDatabase())
        await server.start()
        try:
            s = PostgresStore(pg_config(server.port), 1)
            await s.connect()

            async def write(i: int) -> None:
                await s.update_table_state(
                    2000 + i, TableState.errored(f"e{i}"))

            async def read(i: int) -> None:
                await s.get_table_state(2000 + (i % 8))

            await asyncio.gather(*(write(i) for i in range(8)),
                                 *(read(i) for i in range(8)))
            assert server.connections > 1, server.connections
            s2 = PostgresStore(pg_config(server.port), 1)
            await s2.connect()
            for i in range(8):
                st = await s2.get_table_state(2000 + i)
                assert st is not None and st.reason == f"e{i}"
            await s.close()
            await s2.close()
        finally:
            await server.stop()

    async def test_broken_connection_slot_reconnects(self):
        server = FakePgServer(FakeDatabase())
        await server.start()
        try:
            s = PostgresStore(pg_config(server.port), 1, pool_size=1)
            await s.connect()
            await s.update_table_state(1, TableState.errored("before"))
            for w in list(server._writers):
                w.close()
            await asyncio.sleep(0.05)
            # the first write fails on the dead wire (reads are served
            # from the cache) and marks the slot broken...
            with pytest.raises(BaseException):
                await s.update_table_state(2, TableState.errored("dead"))
            # ...and the next acquire reconnects it
            await s.update_table_state(3, TableState.errored("after"))
            s2 = PostgresStore(pg_config(server.port), 1)
            await s2.connect()
            st = await s2.get_table_state(3)
            assert st is not None and st.reason == "after"
            await s.close()
            await s2.close()
        finally:
            await server.stop()

    async def test_close_wakes_waiters_typed(self):
        server = FakePgServer(FakeDatabase())
        await server.start()
        try:
            s = PostgresStore(pg_config(server.port), 1, pool_size=1)
            await s.connect()
            await s.close()
            with pytest.raises(EtlError) as ei:
                await s.update_table_state(1, TableState.errored("x"))
            assert ei.value.kind.name == "STATE_STORE_FAILED"
        finally:
            await server.stop()


# -- the `etl` schema over the wire, across the two packages -------------------


def _pkg_store(name: str):
    sql = importlib.import_module(f"{name}.store.sql")
    cfg = importlib.import_module(f"{name}.config")
    state = importlib.import_module(f"{name}.runtime.state")
    base = importlib.import_module(f"{name}.store.base")
    models = importlib.import_module(f"{name}.models")
    srv = importlib.import_module(f"{name}.testing.fake_pg_server")
    fake = importlib.import_module(f"{name}.postgres.fake")
    return sql, cfg, state, base, models, srv, fake


async def _write_everything(name: str, port: int) -> None:
    """Table states with history, schemas, progress, destination
    metadata, a quarantine and dead letters, through `name`'s
    PostgresStore."""
    sql, cfg, state, base, M, _, _ = _pkg_store(name)
    s = sql.PostgresStore(cfg.PgConnectionConfig(
        host="127.0.0.1", port=port, name="postgres", username="etl"), 1)
    await s.connect()
    TS = state.TableState
    await s.update_table_state(5, TS.init())
    await s.update_table_state(5, TS.data_sync())
    await s.update_table_state(5, TS.ready())
    await s.update_table_state(6, TS.errored(
        "boom 'quoted'", retry_policy=M.RetryKind.MANUAL, retry_attempts=3))
    sch = M.ReplicatedTableSchema.with_all_columns(M.TableSchema(
        5, M.TableName("public", "t"),
        (M.ColumnSchema("a", M.Oid.INT4, nullable=False,
                        primary_key_ordinal=1),
         M.ColumnSchema("b", M.Oid.TEXT))))
    await s.store_table_schema(sch, 10)
    await s.store_table_schema(sch, 20)
    await s.update_durable_progress("apply", M.Lsn(4096))
    await s.update_durable_progress("table_sync_5", M.Lsn(512))
    await s.update_destination_metadata(
        base.DestinationTableMetadata(5, "public_t", 2))
    await s.set_table_quarantine(6, base.QuarantineRecord(
        6, 300, 2, reason="poison"))
    await s.append_dead_letters([base.DeadLetterEntry(
        entry_id=0, table_id=6, commit_lsn=300 + i, tx_ordinal=i,
        change_type=0, payload='{"v": 1, "values": [%d]}' % i,
        error_kind="DESTINATION_REJECTED", detail=f"d{i}",
        columns="b") for i in range(3)])
    await s.close()


async def _read_everything(name: str, port: int) -> dict:
    sql, cfg, _, _, M, _, _ = _pkg_store(name)
    s = sql.PostgresStore(cfg.PgConnectionConfig(
        host="127.0.0.1", port=port, name="postgres", username="etl"), 1)
    await s.connect()
    try:
        states = await s.get_table_states()
        out = {
            "states": {t: st.to_json() for t, st in sorted(states.items())},
            "history": [st.to_json() for st in await s.state_history(5)],
            "schemas": await s.get_schema_versions(5),
            "schema": (await s.get_table_schema(5, 15)).to_json(),
            "progress": [int(await s.get_durable_progress(k))
                         for k in ("apply", "table_sync_5")],
            "meta": vars(await s.get_destination_metadata(5)),
            "quarantine": {t: r.to_json() for t, r in
                           (await s.get_quarantined_tables()).items()},
            "dlq": [(e.entry_id, e.table_id, e.commit_lsn, e.tx_ordinal,
                     e.change_type, e.payload, e.error_kind, e.detail,
                     e.attempts, e.status, e.columns)
                    for e in await s.list_dead_letters(status=None)],
        }
    finally:
        await s.close()
    return out


async def _server_for(name: str, store_db=None):
    *_, srv, fake = _pkg_store(name)
    db = fake.FakeDatabase()
    if store_db is not None:
        db._store_sql_db = store_db
    server = srv.FakePgServer(db)
    await server.start()
    return server, db


class TestWireStoreParityWithReference:
    """The reference's PostgresStore and the port's run one statement set
    over the wire: an `etl` schema either writes, the other reads back the
    same (the two fake servers meet through one embedded database)."""

    @pytest.mark.parametrize("writer,reader", [
        ("etl_tpu", "etl_tpu_torch"), ("etl_tpu_torch", "etl_tpu")],
        ids=["reference-writes", "port-writes"])
    async def test_schema_reads_back_across_packages(self, writer, reader):
        w_server, w_db = await _server_for(writer)
        try:
            await _write_everything(writer, w_server.port)
            want = await _read_everything(writer, w_server.port)
        finally:
            await w_server.stop()
        r_server, _ = await _server_for(reader, w_db._store_sql_db)
        try:
            got = await _read_everything(reader, r_server.port)
        finally:
            await r_server.stop()
        assert got == want
        assert want["states"][5] and len(want["history"]) == 3
        assert len(want["dlq"]) == 3

    async def test_port_store_against_reference_server(self):
        server, _ = await _server_for("etl_tpu")
        try:
            await _write_everything("etl_tpu_torch", server.port)
            got = await _read_everything("etl_tpu_torch", server.port)
            want = await _read_everything("etl_tpu", server.port)
        finally:
            await server.stop()
        assert got == want

    async def test_replicator_moved_to_the_port_resumes(self):
        """A reference Pipeline over TCP with a PostgresStore copies and
        streams; the port's Pipeline, started on the same server and
        store, copies nothing again and delivers only what came after."""
        from etl_tpu.postgres.client import \
            PgReplicationClient as RefClient
        from etl_tpu.store.sql import PostgresStore as RefStore
        from etl_tpu_torch.config import BatchConfig, BatchEngine, \
            PipelineConfig
        from etl_tpu_torch.destinations import MemoryDestination
        from etl_tpu_torch.postgres.client import PgReplicationClient
        from etl_tpu_torch.runtime import Pipeline
        from tests.test_torch_runtime_parity import (
            ACCOUNTS, _accounts_rows, _make_db, _pkg, _row_events,
            _wait_for, _warm_reference_pyarrow)

        _warm_reference_pyarrow()
        ref = _pkg("etl_tpu")
        db, rng = _make_db(ref, seed=41, n_accounts=70, n_orders=3)
        db.create_publication("pub", [ACCOUNTS])
        *_, srv, _ = _pkg_store("etl_tpu")
        server = srv.FakePgServer(db, keepalive_interval_s=0.03)
        await server.start()
        ref_conn = ref.cfg.PgConnectionConfig(
            host="127.0.0.1", port=server.port, name="postgres",
            username="etl")
        try:
            store = RefStore(ref_conn, 1)
            await store.connect()
            dest = ref.dest.MemoryDestination()
            p = ref.runtime.Pipeline(
                config=ref.cfg.PipelineConfig(
                    pipeline_id=1, publication_name="pub",
                    pg_connection=ref_conn,
                    batch=ref.cfg.BatchConfig(max_fill_ms=30,
                                              batch_engine=ref.engine)),
                store=store, destination=dest,
                source_factory=lambda: RefClient(ref_conn))
            await p.start()
            await _wait_for(lambda: len(dest.table_rows[ACCOUNTS]) == 70)
            async with db.transaction() as tx:
                for r in _accounts_rows(rng, range(1000, 1040)):
                    tx.insert(ACCOUNTS, r)
            await _wait_for(lambda: len(_row_events(dest)) >= 40)
            await _wait_for(lambda: store._states[ACCOUNTS].type.value
                            == "ready")
            await p.shutdown_and_wait()
            await store.close()

            async with db.transaction() as tx:
                for r in _accounts_rows(rng, range(2000, 2030)):
                    tx.insert(ACCOUNTS, r)
            conn = pg_config(server.port)
            pstore = PostgresStore(conn, 1)
            await pstore.connect()
            assert (await pstore.get_table_state(ACCOUNTS)).type \
                is TableStateType.READY
            pdest = MemoryDestination()
            p2 = Pipeline(
                config=PipelineConfig(
                    pipeline_id=1, publication_name="pub",
                    pg_connection=conn,
                    batch=BatchConfig(max_fill_ms=30,
                                      batch_engine=BatchEngine.CUDA,
                                      device="cpu")),
                store=pstore, destination=pdest,
                source_factory=lambda: PgReplicationClient(conn))
            await p2.start()
            await _wait_for(lambda: len(_row_events(pdest)) >= 30)
            await asyncio.sleep(0.2)  # a re-delivered row would land here
            await p2.shutdown_and_wait()
            await pstore.close()
        finally:
            await server.stop()
        assert not pdest.table_rows.get(ACCOUNTS)  # no re-copy
        ids = [e.row.values[0] for e in _row_events(pdest)]
        assert ids == list(range(2000, 2030))
