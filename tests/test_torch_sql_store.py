"""The port's durable SQL store (`etl_tpu_torch.store.sql.SqliteStore`),
held to the sqlite arms of the reference's tests/test_sql_store.py: state
history, pipeline isolation, progress, schema versions, destination
metadata and quoting across a restart; a Pipeline restarted over the
same file; a database written before the dead-letter columns existed,
upgraded in place; bound values that quote the store's own table names.
Plus the reference's SqliteStore and the port's reading each other's
files.

Waiting for the Postgres client (ROADMAP.md, queue 1): the Postgres
dialect (`PostgresStore`), and with it `TestExtendedProtocol` and
`TestPostgresPool`. `TestLegacySchemaUpgrade` and
`TestQualifiedNameInBoundValue` are Postgres tests in the reference;
here they are restated for the sqlite file.
"""

import asyncio
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
from etl_tpu_torch.store.sql import SqliteStore


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
    """Stores sharing one sqlite file, so a second `make()` models a
    process restart."""

    def __init__(self, tmp_path):
        self.tmp_path = tmp_path
        self._stores = []

    async def make(self, pipeline_id: int = 1):
        s = SqliteStore(self.tmp_path / "store.db", pipeline_id)
        await s.connect()
        self._stores.append(s)
        return s

    async def cleanup(self):
        for s in self._stores:
            await s.close()


class TestSqlStoreDialects:
    async def test_states_persist_across_restart(self, tmp_path):
        env = StoreEnv(tmp_path)
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

    async def test_pipeline_isolation(self, tmp_path):
        env = StoreEnv(tmp_path)
        try:
            a = await env.make(1)
            b = await env.make(2)
            await a.update_table_state(5, TableState.ready())
            assert await b.get_table_state(5) is None
        finally:
            await env.cleanup()

    async def test_memory_only_rejected(self, tmp_path):
        env = StoreEnv(tmp_path)
        try:
            s = await env.make()
            with pytest.raises(EtlError):
                await s.update_table_state(1, TableState.sync_wait(Lsn(1)))
        finally:
            await env.cleanup()

    async def test_progress_monotonic_and_durable(self, tmp_path):
        env = StoreEnv(tmp_path)
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

    async def test_schema_versions_durable(self, tmp_path):
        env = StoreEnv(tmp_path)
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

    async def test_destination_metadata(self, tmp_path):
        env = StoreEnv(tmp_path)
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

    async def test_state_json_with_quotes_roundtrips(self, tmp_path):
        env = StoreEnv(tmp_path)
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
        import etl_tpu_torch.store as store
        import etl_tpu_torch.store.sql as sql

        assert not hasattr(sql, "PostgresStore")
        assert not hasattr(store, "PostgresStore")
        assert asyncio.iscoroutinefunction(SqliteStore.connect)
