"""The port's sharded scale-out, held to the reference's
tests/test_sharding.py: the rendezvous map against the reference's for
every table id 16384–20480 and K = 1…8 (shard_of, partition,
moved_tables), the shard-scoped store's read filter and write fence over
each of the port's stores (MemoryStore, SqliteStore, PostgresStore on the
fake wire server), K = 2 shard pods over one seeded fake database whose
per-shard end states equal the reference's pods of the same shard, the
coordinator's 2 → 3 rebalance on both packages (the union of the pods'
destinations equals the committed truth on each, and both move the same
tables at the same epochs), the coordinator's refusals, resume, abort and
typed timeout, the sharded pod-kill scenario, `/health` shard fields, and
the replicator binary running as one shard pod. The reference runs as its
own tests run it (JAX on the CPU). Tolerance: none — equal maps, equal
views, equal documents.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import subprocess
import sys

import pytest

from etl_tpu.sharding import ShardMap as RefShardMap
from etl_tpu.sharding import moved_tables as ref_moved_tables
from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.config import PipelineConfig
from etl_tpu_torch.models import (ColumnSchema, Oid, ReplicatedTableSchema,
                                  TableName, TableSchema)
from etl_tpu_torch.models.errors import ErrorKind, EtlError
from etl_tpu_torch.models.table_state import TableState
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission
from etl_tpu_torch.postgres.slots import apply_slot_name
from etl_tpu_torch.sharding import (STATUS_REBALANCING, ShardAssignment,
                                    ShardMap, moved_tables)
from etl_tpu_torch.sharding.runtime import (ShardIdentity, ShardScopedStore,
                                            resolve_shard_scope)
from etl_tpu_torch.store.base import DestinationTableMetadata
from etl_tpu_torch.telemetry.metrics import (ETL_SHARD_WRITE_REFUSALS_TOTAL,
                                             registry)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = list(range(16384, 20481))
TABLES_1K = TABLES[:1000]


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    engine.clear_forced_oracle()
    failpoints.disarm_all()
    reset_global_admission()


# -- the map, against the reference's ------------------------------------------


class TestShardMapParity:
    @pytest.mark.parametrize("k", range(1, 9))
    def test_shard_of_partition_and_moves_equal_reference(self, k):
        port, ref = ShardMap(k), RefShardMap(k)
        assert [port.shard_of(t) for t in TABLES] \
            == [ref.shard_of(t) for t in TABLES]
        assert port.partition(TABLES) == ref.partition(TABLES)
        assert moved_tables(port, ShardMap(k + 1), TABLES) \
            == ref_moved_tables(ref, RefShardMap(k + 1), TABLES)
        if k > 1:
            assert moved_tables(port, port.shrunk(), TABLES) \
                == ref_moved_tables(ref, ref.shrunk(), TABLES)

    def test_deterministic_across_processes(self):
        """A fresh interpreter with another hash seed computes the same
        map: K pods each compute it locally."""
        script = ("import json;from etl_tpu_torch.sharding import ShardMap;"
                  "m=ShardMap(4);"
                  "print(json.dumps([m.shard_of(t) for t in "
                  "range(16384,16484)]))")
        proc = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True,
            env={"PYTHONHASHSEED": "12345", "PATH": "/usr/bin:/bin",
                 "PYTHONPATH": ROOT}, cwd=ROOT, timeout=120)
        assert proc.returncode == 0, proc.stderr[-500:]
        assert json.loads(proc.stdout) == \
            [ShardMap(4).shard_of(t) for t in range(16384, 16484)]

    @pytest.mark.parametrize("k", [2, 3, 4, 7])
    def test_grow_moves_only_to_the_new_shard(self, k):
        old, new = ShardMap(k), ShardMap(k + 1)
        moved = moved_tables(old, new, TABLES_1K)
        ideal = 1 / (k + 1)
        assert 0.6 * ideal <= len(moved) / len(TABLES_1K) <= 1.5 * ideal
        assert all(dst == k for _src, dst in moved.values())
        assert all(old.shard_of(t) == new.shard_of(t)
                   for t in TABLES_1K if t not in moved)

    def test_validation_and_assignment_record(self):
        with pytest.raises(EtlError):
            ShardMap(0)
        with pytest.raises(EtlError):
            ShardMap(2, epoch=-1)
        with pytest.raises(EtlError):
            ShardMap(1).shrunk()
        assert ShardMap(2, epoch=3).grown() == ShardMap(3, epoch=4)
        a = ShardAssignment(epoch=2, shard_count=3, status=STATUS_REBALANCING,
                            fence_lsn=99, next_shard_count=4,
                            moved=((16390, 1, 3),))
        assert ShardAssignment.from_json(a.to_json()) == a
        assert a.shard_map() == ShardMap(3, 2) and a.rebalancing


# -- the shard-scoped store, over every store of the port -----------------------


STORES = ["memory", "sqlite", "postgres"]


class _Stores:
    """One raw store of each kind the port has; `make()` again gives a
    second handle on the same backing storage."""

    def __init__(self, kind: str, tmp_path):
        self.kind = kind
        self.tmp_path = tmp_path
        self._server = None
        self._open = []
        self._memory = None

    async def make(self):
        from etl_tpu_torch.config import PgConnectionConfig
        from etl_tpu_torch.postgres.fake import FakeDatabase
        from etl_tpu_torch.store import MemoryStore
        from etl_tpu_torch.store.sql import PostgresStore, SqliteStore

        if self.kind == "memory":
            if self._memory is None:
                self._memory = MemoryStore()
            return self._memory
        if self.kind == "sqlite":
            s = SqliteStore(self.tmp_path / "store.db", 1)
        else:
            from etl_tpu_torch.testing.fake_pg_server import FakePgServer

            if self._server is None:
                self._server = FakePgServer(FakeDatabase())
                await self._server.start()
            s = PostgresStore(PgConnectionConfig(
                host="127.0.0.1", port=self._server.port, name="postgres",
                username="etl"), 1)
        await s.connect()
        self._open.append(s)
        return s

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        for s in self._open:
            await s.close()
        if self._server is not None:
            await self._server.stop()


@pytest.fixture
def stores(request, tmp_path):
    return _Stores(request.param, tmp_path)


def _identity(shard=0, count=2, epoch=0):
    return ShardIdentity(pipeline_id=1, shard=shard, shard_count=count,
                         epoch=epoch)


async def _seeded(env, tables):
    inner = await env.make()
    await inner.update_shard_assignment(ShardAssignment(0, 2))
    for tid in tables:
        await inner.update_table_state(tid, TableState.ready())
    return inner


@pytest.mark.parametrize("stores", STORES, indirect=True)
class TestShardScopedStore:
    async def test_reads_filtered_to_owned_slice(self, stores):
        async with stores:
            tables = list(range(16384, 16392))
            inner = await _seeded(stores, tables)
            smap = ShardMap(2)
            view0 = ShardScopedStore(inner, _identity(0))
            view1 = ShardScopedStore(inner, _identity(1))
            got0 = set(await view0.get_table_states())
            got1 = set(await view1.owned_table_states())
            assert got0 == set(smap.tables_for_shard(tables, 0))
            assert got1 == set(smap.tables_for_shard(tables, 1))
            assert got0 | got1 == set(tables) and not (got0 & got1)
            foreign = min(got1)
            assert await view0.get_table_state(foreign) is None
            assert await view1.get_table_state(foreign) is not None

    async def test_write_to_foreign_table_refused(self, stores):
        async with stores:
            tables = list(range(16384, 16392))
            inner = await _seeded(stores, tables)
            view0 = ShardScopedStore(inner, _identity(0))
            foreign = ShardMap(2).tables_for_shard(tables, 1)[0]
            with pytest.raises(EtlError) as e:
                await view0.update_table_state(foreign, TableState.init())
            assert e.value.kind is ErrorKind.SHARD_NOT_OWNED
            with pytest.raises(EtlError):
                await view0.delete_table_state(foreign)
            with pytest.raises(EtlError):
                await view0.update_destination_metadata(
                    DestinationTableMetadata(foreign, "t"))
            # the refused writes left the shared store as it was
            st = await inner.get_table_state(foreign)
            assert st.type.value == "ready"

    async def test_stale_epoch_refused_after_flip(self, stores):
        async with stores:
            tables = list(range(16384, 16392))
            inner = await _seeded(stores, tables)
            view0 = ShardScopedStore(inner, _identity(0, epoch=0))
            owned = ShardMap(2).tables_for_shard(tables, 0)[0]
            await view0.update_table_state(owned, TableState.ready())
            await inner.update_shard_assignment(
                ShardAssignment(epoch=1, shard_count=3))
            label = {"reason": "epoch_stale"}
            before = registry.get_counter(ETL_SHARD_WRITE_REFUSALS_TOTAL,
                                          label)
            with pytest.raises(EtlError) as e:
                await view0.update_table_state(owned, TableState.ready())
            assert e.value.kind is ErrorKind.SHARD_EPOCH_STALE
            assert registry.get_counter(ETL_SHARD_WRITE_REFUSALS_TOTAL,
                                        label) == before + 1

    async def test_schema_ops_pass_through_but_cleanup_is_scoped(
            self, stores):
        async with stores:
            tables = list(range(16384, 16392))
            inner = await _seeded(stores, tables)
            view0 = ShardScopedStore(inner, _identity(0))
            foreign = ShardMap(2).tables_for_shard(tables, 1)[0]
            schema = ReplicatedTableSchema.with_all_columns(TableSchema(
                foreign, TableName("public", "x"),
                (ColumnSchema("id", Oid.INT8, nullable=False,
                              primary_key_ordinal=1),)))
            await view0.store_table_schema(schema, 5)
            assert await view0.get_table_schema(foreign) is not None
            assert foreign not in await view0.get_table_ids_with_schemas()

    async def test_pod_cannot_rewrite_assignment(self, stores):
        async with stores:
            inner = await _seeded(stores, [16384])
            view = ShardScopedStore(inner, _identity(0))
            with pytest.raises(EtlError) as e:
                await view.update_shard_assignment(ShardAssignment(9, 9))
            assert e.value.kind is ErrorKind.SHARD_NOT_OWNED
            assert await inner.get_shard_assignment() == \
                ShardAssignment(0, 2)

    async def test_resolve_shard_scope_bootstrap_and_mismatch(self, stores):
        async with stores:
            store = await stores.make()
            cfg = PipelineConfig(pipeline_id=1, publication_name="pub",
                                 shard=0, shard_count=2)
            scoped = await resolve_shard_scope(store, cfg)
            assert scoped.identity == _identity(0, 2, 0)
            # the bootstrap is durable: a second handle reads it back
            again = await stores.make()
            assert (await again.get_shard_assignment()).shard_count == 2
            bad = PipelineConfig(pipeline_id=1, publication_name="pub",
                                 shard=0, shard_count=3)
            with pytest.raises(EtlError) as e:
                await resolve_shard_scope(again, bad)
            assert e.value.kind is ErrorKind.SHARD_EPOCH_STALE


def test_config_validation():
    with pytest.raises(EtlError):
        PipelineConfig(pipeline_id=1, publication_name="p",
                       shard=2, shard_count=2).validate()
    with pytest.raises(EtlError):
        PipelineConfig(pipeline_id=1, publication_name="p",
                       shard=None, shard_count=2).validate()
    PipelineConfig(pipeline_id=1, publication_name="p",
                   shard=1, shard_count=2).validate()


# -- shard pods over one fake source, port and reference -----------------------


def _fresh_reference_programs() -> None:
    """A reference pipeline run in a worker that ran the reference's red
    program-store tests first fails on their cached 8-shard executables
    (ROADMAP.md, reference caveats): start from an empty cache."""
    from etl_tpu.ops import engine as ref_engine
    from etl_tpu.ops import program_store

    program_store.configure(None)
    program_store.reset_for_tests()
    ref_engine._SHARED_FN_CACHE.clear()


def _warm_reference_pyarrow() -> None:
    """Reference caveat (ROADMAP.md, as in test_torch_runtime_parity.py):
    pyarrow's first array conversions in a process, made from the
    reference's copy-partition threads at once, crash the interpreter in
    the reference's `_gather_string_arrow`; they run once on the main
    thread first. The port builds no pyarrow array on its decode path."""
    import numpy as np
    import pyarrow as pa

    valid = np.ones(3, dtype=bool)
    pa.StringArray.from_buffers(
        3, pa.py_buffer(np.zeros(4, dtype=np.int32)),
        pa.py_buffer(np.zeros(0, dtype=np.uint8)),
        pa.array(valid).buffers()[1])


def _pkg(port: bool):
    import importlib
    from types import SimpleNamespace

    name = "etl_tpu_torch" if port else "etl_tpu"
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    if port:
        reset_global_admission()
    else:
        _fresh_reference_programs()
        _warm_reference_pyarrow()
    return SimpleNamespace(
        port=port, cfg=m("config"), runner=m("chaos.runner"),
        scenario=m("chaos.scenario"), inv=m("chaos.invariants"),
        sharded=m("chaos.sharded"), fake=m("postgres.fake"),
        runtime=m("runtime"), sharding=m("sharding"),
        table_state=m("models.table_state"))


def _shard_cfg(pkg, shard, count):
    cfg = pkg.cfg
    batch = dict(max_size_bytes=64 * 1024, max_fill_ms=25)
    if pkg.port:
        batch.update(batch_engine=cfg.BatchEngine.CUDA, device="cpu")
    else:
        batch.update(batch_engine=cfg.BatchEngine.TPU)
    return cfg.PipelineConfig(
        pipeline_id=1, publication_name="pub",
        batch=cfg.BatchConfig(**batch),
        supervision=cfg.SupervisionConfig(check_interval_s=0.25,
                                          stall_deadline_s=10.0,
                                          hang_deadline_s=25.0),
        wal_sender_timeout_ms=60_000, lag_sample_interval_s=0,
        shard=shard, shard_count=count)


def _plain_view(pkg, dest, tables) -> dict:
    view = pkg.inv.reconstruct_final_view(dest, tables)
    return {tid: {pk: tuple(repr(v) for v in vals)
                  for pk, vals in rows.items()}
            for tid, rows in view.items()}


async def _two_shards(pkg, seed: int) -> dict:
    """K = 2 shard pods over one seeded fake database and one shared
    store: each pod's final view of its slice, and what it delivered."""
    shape = pkg.scenario.Scenario(name="s", description="d", tables=8,
                                  rows_per_table=3, txs=4, rows_per_tx=20)
    wl = pkg.runner._Workload(shape, random.Random(seed))
    db = wl.build_db()
    store = pkg.runner.RecordingStore()
    part = ShardMap(2).partition(wl.table_ids)
    dests = {s: pkg.runner.TracingDestination() for s in range(2)}
    pipes = {}
    ready = pkg.table_state.TableStateType.READY
    try:
        for shard in range(2):
            pipes[shard] = pkg.runtime.Pipeline(
                config=_shard_cfg(pkg, shard, 2), store=store,
                destination=dests[shard],
                source_factory=lambda: pkg.fake.FakeSource(db))
            await pipes[shard].start()
        await pkg.runner._wait_until(
            lambda: all((st := store._states.get(tid)) is not None
                        and st.type is ready for tid in wl.table_ids),
            30.0, "tables never ready")
        while wl.tx_index < shape.txs:
            await wl.run_tx(db)
        for shard in range(2):
            owned = part[shard]
            exp = {t: wl.expected[t] for t in owned}
            await pkg.runner._wait_until(
                lambda sh=shard, o=owned, e=exp:
                    pkg.inv.view_matches(dests[sh], o, e),
                30.0, f"shard {shard} never delivered its slice")
        delivered = {
            s: sorted({e.schema.id for e in dests[s].events
                       if type(e).__name__ in ("InsertEvent", "UpdateEvent",
                                               "DeleteEvent")}
                      | set(dests[s].table_rows))
            for s in range(2)}
        return {"views": {s: _plain_view(pkg, dests[s], part[s])
                          for s in range(2)},
                "delivered": delivered, "part": part,
                "states": sorted(store._states),
                "tables": wl.table_ids,
                "identities": {s: pipes[s].shard_identity.describe()
                               for s in range(2)}}
    finally:
        for p in pipes.values():
            if p._apply_task is not None:
                await p.shutdown_and_wait()


class TestShardedPipelines:
    async def test_two_shards_equal_reference_pods(self):
        """Each port pod delivers exactly its slice, and its final view
        equals the reference's pod of the same shard on the same seed;
        neither pod purged the other's tables."""
        port = await _two_shards(_pkg(True), seed=7)
        ref = await _two_shards(_pkg(False), seed=7)
        assert port["views"] == ref["views"]
        for s in range(2):
            assert port["delivered"][s] == sorted(port["part"][s])
            assert all(port["views"][s][t] for t in port["part"][s])
        assert port["states"] == port["tables"]  # no cross-purge
        assert port["identities"] == ref["identities"] == {
            0: {"shard": 0, "shard_count": 2, "epoch": 0},
            1: {"shard": 1, "shard_count": 2, "epoch": 0}}

    async def test_health_surfaces_shard_identity(self):
        from aiohttp.test_utils import TestClient, TestServer

        from etl_tpu_torch.destinations import MemoryDestination
        from etl_tpu_torch.postgres.fake import FakeDatabase, FakeSource
        from etl_tpu_torch.replicator import build_observability_app
        from etl_tpu_torch.runtime import Pipeline
        from etl_tpu_torch.store import MemoryStore

        p = Pipeline(config=_shard_cfg(_pkg(True), 1, 2),
                     store=MemoryStore(), destination=MemoryDestination(),
                     source_factory=lambda: FakeSource(FakeDatabase()))
        want = {"shard": 1, "shard_count": 2, "epoch": None}
        assert p.health_snapshot()["shard"] == want
        client = TestClient(TestServer(build_observability_app(p)))
        await client.start_server()
        try:
            r = await client.get("/health")
            assert r.status == 503
            assert await r.json() == {"status": "starting", "shard": want}
            r = await client.get("/health/detail")
            assert (await r.json())["shard"] == want
        finally:
            await client.close()


# -- two-phase rebalance --------------------------------------------------------


async def _rebalance_2_to_3(pkg, seed: int) -> dict:
    """K = 2 → 3 mid-stream: the coordinator fences at the new slot,
    waits for the losers, flips; the rolled fleet finishes the workload.
    Returns whether the union converged to the truth, the rebalance's
    record and what the old epoch's store view does after the flip."""
    shape = pkg.scenario.Scenario(name="s", description="d", tables=8,
                                  rows_per_table=3, txs=10, rows_per_tx=30)
    wl = pkg.runner._Workload(shape, random.Random(seed))
    db = wl.build_db()
    store = pkg.runner.RecordingStore()
    dests = {s: pkg.runner.TracingDestination() for s in range(3)}
    ready = pkg.table_state.TableStateType.READY
    pipes = []

    async def start_fleet(k):
        fleet = []
        for shard in range(k):
            p = pkg.runtime.Pipeline(
                config=_shard_cfg(pkg, shard, k), store=store,
                destination=dests[shard],
                source_factory=lambda: pkg.fake.FakeSource(db))
            await p.start()
            fleet.append(p)
        return fleet

    try:
        pipes = await start_fleet(2)
        await pkg.runner._wait_until(
            lambda: all((st := store._states.get(tid)) is not None
                        and st.type is ready for tid in wl.table_ids),
            30.0, "never ready")
        while wl.tx_index < 5:
            await wl.run_tx(db)
        coord = pkg.sharding.ShardCoordinator(
            store, 1, lambda: pkg.fake.FakeSource(db),
            quiesce_timeout_s=30.0)
        rebalance = asyncio.ensure_future(coord.add_shard())
        for _ in range(3):
            await asyncio.sleep(0.15)
            await wl.run_tx(db)
        result = await rebalance
        stale = pipes[0].store
        owned = next(t for t in wl.table_ids
                     if ShardMap(2).owns(t, 0))
        try:
            await stale.update_table_state(
                owned, pkg.table_state.TableState.ready())
            stale_refusal = None
        except Exception as e:  # the fence's typed refusal
            stale_refusal = e.kind.name
        for p in pipes:
            await p.shutdown_and_wait()
        pipes = await start_fleet(3)
        while wl.tx_index < shape.txs:
            await wl.run_tx(db)
        await pkg.runner._wait_until(
            lambda: pkg.inv.view_matches(
                pkg.sharded._UnionDest(list(dests.values())),
                wl.table_ids, wl.expected),
            30.0, "union never converged after the rebalance")
        assignment = await store.get_shard_assignment()
        return {"moved": {t: list(m) for t, m in result.moved.items()},
                "epochs": (result.old_epoch, result.new_epoch),
                "counts": (result.old_shard_count, result.new_shard_count),
                "assignment": (assignment.epoch, assignment.shard_count,
                               assignment.status),
                "stale_refusal": stale_refusal,
                "identities": [p.shard_identity.describe() for p in pipes]}
    finally:
        for p in pipes:
            if p._apply_task is not None:
                await p.shutdown_and_wait()


class TestRebalance:
    async def test_add_shard_loses_nothing_on_both_packages(self):
        """The union of the pods' destinations equals the committed truth
        after 2 → 3 on the port and on the reference (each asserted
        inside the run), and both move the same tables to shard 2 at the
        same epochs; the old epoch's view is refused after the flip."""
        port = await _rebalance_2_to_3(_pkg(True), seed=11)
        ref = await _rebalance_2_to_3(_pkg(False), seed=11)
        assert port == ref
        assert port["moved"] and all(dst == 2 for _src, dst
                                     in port["moved"].values())
        assert port["epochs"] == (0, 1) and port["counts"] == (2, 3)
        assert port["assignment"] == (1, 3, "steady")
        assert port["stale_refusal"] == "SHARD_EPOCH_STALE"
        assert port["identities"] == [
            {"shard": s, "shard_count": 3, "epoch": 1} for s in range(3)]

    async def test_conflicting_rebalance_refused(self):
        from etl_tpu_torch.postgres.fake import FakeDatabase, FakeSource
        from etl_tpu_torch.sharding import ShardCoordinator
        from etl_tpu_torch.store import MemoryStore

        store = MemoryStore()
        await store.update_shard_assignment(ShardAssignment(
            epoch=0, shard_count=2, status=STATUS_REBALANCING,
            fence_lsn=100, next_shard_count=3))
        coord = ShardCoordinator(store, 1,
                                 lambda: FakeSource(FakeDatabase()))
        with pytest.raises(EtlError) as e:
            await coord.remove_shard()
        assert e.value.kind is ErrorKind.INVALID_STATE_TRANSITION

    async def _moving_store(self):
        from etl_tpu_torch.models.table_state import TableState
        from etl_tpu_torch.postgres.fake import FakeDatabase
        from etl_tpu_torch.store import MemoryStore

        db = FakeDatabase()
        store = MemoryStore()
        await store.update_shard_assignment(ShardAssignment(0, 2))
        moving = next(iter(moved_tables(ShardMap(2), ShardMap(3),
                                        TABLES_1K)))
        await store.update_table_state(moving, TableState.ready())
        return db, store, moving

    async def test_resume_after_timeout_completes(self):
        from etl_tpu_torch.models.lsn import Lsn
        from etl_tpu_torch.postgres.fake import FakeSource
        from etl_tpu_torch.sharding import ShardCoordinator

        db, store, moving = await self._moving_store()
        coord = ShardCoordinator(store, 1, lambda: FakeSource(db),
                                 quiesce_timeout_s=0.2,
                                 poll_interval_s=0.02)
        with pytest.raises(EtlError):
            await coord.add_shard()
        fence = (await store.get_shard_assignment()).fence_lsn
        losing = ShardMap(2).shard_of(moving)
        await store.update_durable_progress(
            apply_slot_name(1, losing), Lsn(fence + 1))
        result = await coord.add_shard()
        assert result.fence_lsn == fence
        assert await store.get_shard_assignment() == \
            ShardAssignment(epoch=1, shard_count=3)

    async def test_abort_rebalance_rolls_back_and_frees_slot(self):
        from etl_tpu_torch.postgres.fake import FakeSource
        from etl_tpu_torch.sharding import ShardCoordinator

        db, store, _ = await self._moving_store()
        coord = ShardCoordinator(store, 1, lambda: FakeSource(db),
                                 quiesce_timeout_s=0.2,
                                 poll_interval_s=0.02)
        with pytest.raises(EtlError):
            await coord.add_shard()
        assert apply_slot_name(1, 2) in db.slots
        await coord.abort_rebalance()
        assert await store.get_shard_assignment() == \
            ShardAssignment(epoch=0, shard_count=2)
        assert apply_slot_name(1, 2) not in db.slots
        await coord.abort_rebalance()  # idempotent when steady

    async def test_quiesce_timeout_is_typed(self):
        from etl_tpu_torch.postgres.fake import FakeSource
        from etl_tpu_torch.sharding import ShardCoordinator

        db, store, _ = await self._moving_store()
        coord = ShardCoordinator(store, 1, lambda: FakeSource(db),
                                 quiesce_timeout_s=0.3,
                                 poll_interval_s=0.02)
        with pytest.raises(EtlError) as e:
            await coord.add_shard()
        assert e.value.kind is ErrorKind.TIMEOUT
        assignment = await store.get_shard_assignment()
        assert assignment.rebalancing and assignment.next_shard_count == 3


# -- the sharded pod-kill scenario ----------------------------------------------


def _stable(d: dict) -> dict:
    d = json.loads(json.dumps(d))
    d.pop("duration_s")
    for r in d["restarts"]:
        r.pop("recovery_s")
    return d


class TestShardedChaos:
    @pytest.mark.parametrize("shards", [2, 3])
    async def test_pod_kill_scenario_passes(self, shards):
        from etl_tpu_torch.chaos.sharded import run_sharded_scenario

        run = await run_sharded_scenario(seed=7, shards=shards,
                                         device="cpu")
        assert run.ok, run.describe()
        assert run.union_matches and run.survivor_txs_during_outage > 0
        assert len(run.restarts) == 1
        # the same split as the reference's map
        ref = RefShardMap(shards).partition(range(16384, 16392))
        assert run.tables_per_shard == {s: len(t) for s, t in ref.items()}

    async def test_deterministic_per_seed(self):
        from etl_tpu_torch.chaos.sharded import run_sharded_scenario

        a = await run_sharded_scenario(seed=23, device="cpu")
        b = await run_sharded_scenario(seed=23, device="cpu")
        assert a.ok and b.ok
        assert _stable(a.describe()) == _stable(b.describe())


# -- the binary as one shard pod ------------------------------------------------


class TestShardPodBinary:
    async def test_run_replicator_as_shard_pod(self, tmp_path):
        """`run_replicator` with `shard`/`shard_count` in its document
        adopts the scope, copies only its slice, streams its slot
        (`supabase_etl_apply_1_s1`) to the last commit and serves the
        shard identity on `/health`."""
        import logging
        import signal

        from etl_tpu_torch import bench, replicator
        from etl_tpu_torch.chaos.runner import _Workload, _wait_until
        from etl_tpu_torch.chaos.scenario import Scenario
        from etl_tpu_torch.store.sql import SqliteStore
        from etl_tpu_torch.testing.fake_pg_server import FakePgServer

        shape = Scenario(name="s", description="d", tables=8,
                         rows_per_table=80, txs=3, rows_per_tx=80)
        wl = _Workload(shape, random.Random(5))
        db = wl.build_db()
        server = FakePgServer(db)
        await server.start()
        port = bench.free_port()
        cfg_dir = str(tmp_path / "cfg")
        bench.write_replicator_config(
            cfg_dir, server_port=server.port, metrics_port=port,
            device="cpu", store={"type": "sqlite",
                                 "path": str(tmp_path / "s.db")})
        doc_path = os.path.join(cfg_dir, "base.yaml")
        with open(doc_path) as f:
            doc = json.load(f)
        doc.update(shard=1, shard_count=2)
        with open(doc_path, "w") as f:
            json.dump(doc, f)
        root = logging.getLogger()
        handlers, level = list(root.handlers), root.level
        task = asyncio.ensure_future(replicator.run_replicator(cfg_dir))
        try:
            async def healthy():
                try:
                    status, body = await bench.http_get(port, "/health")
                except OSError:
                    return None
                return json.loads(body) if status == 200 else None

            body = None
            for _ in range(600):
                body = await healthy()
                if body is not None or task.done():
                    break
                await asyncio.sleep(0.05)
            assert body == {"status": "healthy", "shard": {
                "shard": 1, "shard_count": 2, "epoch": 0}}, body
            owned = ShardMap(2).tables_for_shard(wl.table_ids, 1)
            check = SqliteStore(tmp_path / "s.db", 1)
            await check.connect()

            async def states():
                return await check.get_table_states()

            for _ in range(600):
                got = await states()
                if set(got) == set(owned) and all(
                        st.type.value == "ready" for st in got.values()):
                    break
                await asyncio.sleep(0.05)
            assert set(await states()) == set(owned)
            while wl.tx_index < shape.txs:
                await wl.run_tx(db)
            tx = db.transaction()
            tx.insert(owned[0], ["1000000", "1", "last"])
            last = await tx.commit()
            slot = apply_slot_name(1, 1)
            await _wait_until(
                lambda: slot in db.slots
                and db.slots[slot].confirmed_flush >= last, 60.0,
                "the shard's slot never confirmed the last commit")
            await check.close()
        finally:
            os.kill(os.getpid(), signal.SIGTERM)
            await asyncio.wait_for(task, 60)
            root.handlers = handlers
            root.setLevel(level)
            await server.stop()


# -- chip_smoke.py phase 13 at a small size -----------------------------------------


class TestChipSmokePhase13Paths:
    async def test_sharded_replication_small(self):
        """Phase 13's run on the CPU at 16,000 rows and 16,000 events:
        every check it makes on the card holds (the plain versions count
        no launch, so each pod is held to its device-routed batches)."""
        from etl_tpu_torch.bench_sharded import run_sharded_replication

        r = await run_sharded_replication(16_000, 16_000, device="cpu")
        assert r["ok"], {k: v for k, v in r.items() if k.endswith("_ok")}
        assert r["tables_per_shard"] == {"k2": {0: 5, 1: 3},
                                         "k3": {0: 5, 1: 2, 2: 1}}
        assert r["moved_tables"] == [16390]
        assert r["stale_epoch_refusal"] == "SHARD_EPOCH_STALE"
        assert r["oracle_rows"] == 0
        # the filtered pod's tables kept about half their rows
        kept = [r["per_table"][t]["copied"] for t in r["filtered_tables"]]
        assert all(800 < k < 1200 for k in kept), kept
