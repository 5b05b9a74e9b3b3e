"""The port's replication runtime against the reference's, end to end.

The same seeded FakeDatabase workload runs through
`etl_tpu.runtime.Pipeline` (BatchEngine.TPU, JAX on the CPU) and through
`etl_tpu_torch.runtime.Pipeline` (BatchEngine.CUDA on `device="cpu"`, the
kernels' plain versions), with supervision and poison-pill isolation off
unless a scenario runs the reference's defaults. The two MemoryDestination
end states, reduced to plain tuples (event type, table id, LSNs, ordinal,
values), must be equal with no tolerance. Scenarios: initial copy + CDC
inserts, updates and deletes with REPLICA IDENTITY FULL old tuples (also
under the default PipelineConfig: supervision and poison on); a truncate;
a pgbench table with initial rows under the publication row filter
`bid <= 5` in offload mode (the walsender ships every row, the client
filters); a restart that resumes from durable progress; a stream with
poison rows into a PoisonRejectingDestination over a SqliteStore, where
the dead-letter entries (WAL keys, payload bytes) must be equal too."""

import asyncio
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

ACCOUNTS = 16384
ORDERS = 16385
PGBENCH = 16390


def _fresh_reference_programs() -> None:
    """Reference caveat (ROADMAP.md): the reference's red
    `test_program_store.py::TestPersistence` leaves executables in its
    process-wide program cache that expect 8 shards, and a reference
    pipeline run later in the same pytest worker fails on them (seen
    when the two files share a worker). Each reference run here starts
    from an empty program cache and no program store."""
    from etl_tpu.ops import engine, program_store

    program_store.configure(None)
    program_store.reset_for_tests()
    engine._SHARED_FN_CACHE.clear()


def _pkg(name: str) -> SimpleNamespace:
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    cfg = m("config")
    port = name == "etl_tpu_torch"
    if port:
        from etl_tpu_torch.ops.pipeline import reset_global_admission

        reset_global_admission()
    else:
        _fresh_reference_programs()
    return SimpleNamespace(
        port=port, cfg=cfg, models=m("models"), fake=m("postgres.fake"),
        runtime=m("runtime"), store=m("store"),
        dest=m("destinations.memory"),
        engine=cfg.BatchEngine.CUDA if port else cfg.BatchEngine.TPU)


def _pipeline(pkg, db, store, dest, defaults: bool = False, **fields):
    """`defaults` keeps PipelineConfig's defaults (supervision and poison
    on); `fields` override config fields."""
    batch = dict(max_size_bytes=256 * 1024, max_fill_ms=50,
                 batch_engine=pkg.engine)
    if pkg.port:
        batch["device"] = "cpu"
    if not defaults:
        fields = dict(supervision=pkg.cfg.SupervisionConfig(enabled=False),
                      poison=pkg.cfg.PoisonConfig(enabled=False), **fields)
    config = pkg.cfg.PipelineConfig(
        pipeline_id=1, publication_name="pub",
        batch=pkg.cfg.BatchConfig(**batch), **fields)
    return pkg.runtime.Pipeline(config=config, store=store, destination=dest,
                                source_factory=lambda: pkg.fake.FakeSource(db))


def _norm(v):
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    return repr(v)  # PgNumeric and the other value classes of each package


def _row(r):
    if r is None:
        return None
    present = getattr(r, "present", None)
    return (type(r).__name__, tuple(_norm(v) for v in r.values),
            None if present is None else tuple(present))


def reduce_state(dest) -> dict:
    """The destination's end state as plain data: rows per table (copy
    order is partition order, so sorted), events in delivery order."""
    rows = {tid: sorted(tuple(_norm(v) for v in r.values) for r in rs)
            for tid, rs in dest.table_rows.items()}
    events = []
    for e in dest.events:
        name = type(e).__name__
        head = (name, int(e.start_lsn), int(e.commit_lsn))
        if name in ("InsertEvent", "UpdateEvent", "DeleteEvent"):
            events.append(head + (e.schema.id, e.tx_ordinal,
                                  _row(getattr(e, "row", None)),
                                  _row(getattr(e, "old_row", None))))
        elif name == "TruncateEvent":
            events.append(head + (e.tx_ordinal, e.options,
                                  tuple(s.id for s in e.schemas)))
        else:
            events.append(head)
    return {"rows": rows, "events": events,
            "truncated": list(dest.truncated_tables)}


def _row_events(dest):
    return [e for e in dest.events if type(e).__name__ in
            ("InsertEvent", "UpdateEvent", "DeleteEvent", "TruncateEvent")]


async def _wait_for(cond, timeout=60.0):
    async def poll():
        while not cond():
            await asyncio.sleep(0.02)

    await asyncio.wait_for(poll(), timeout)


async def _ready(pkg, store, tid):
    await asyncio.wait_for(
        store.notify_on(tid, pkg.runtime.TableStateType.READY), 60)


def _accounts_rows(rng, ids):
    out = []
    for i in ids:
        name = None if rng.random() < 0.1 else \
            f"n{int(rng.integers(0, 10**6))}" + ("\tx" if i % 17 == 0 else "")
        bal = None if rng.random() < 0.05 else \
            str(int(rng.integers(-2**62, 2**62)))
        out.append([str(i), name, bal])
    return out


def _make_db(pkg, seed, n_accounts=150, n_orders=80):
    M = pkg.models
    rng = np.random.default_rng(seed)
    db = pkg.fake.FakeDatabase()
    db.create_table(M.TableSchema(
        ACCOUNTS, M.TableName("public", "accounts"),
        (M.ColumnSchema("id", M.Oid.INT4, nullable=False,
                        primary_key_ordinal=1),
         M.ColumnSchema("name", M.Oid.TEXT),
         M.ColumnSchema("balance", M.Oid.INT8))),
        rows=_accounts_rows(rng, range(1, n_accounts + 1)))
    db.create_table(M.TableSchema(
        ORDERS, M.TableName("public", "orders"),
        (M.ColumnSchema("oid", M.Oid.INT4, nullable=False,
                        primary_key_ordinal=1),
         M.ColumnSchema("amount", M.Oid.NUMERIC),
         M.ColumnSchema("placed", M.Oid.DATE))),
        rows=[[str(i), f"{int(rng.integers(0, 10**5))}.{i % 100:02d}",
               f"2024-{1 + i % 12:02d}-{1 + i % 28:02d}"]
              for i in range(1, n_orders + 1)])
    return db, rng


async def scenario_copy_cdc(pkg, defaults: bool = False):
    """Copy, then CDC inserts, updates (key-changing and not) and deletes,
    with REPLICA IDENTITY FULL old tuples on `orders`."""
    db, rng = _make_db(pkg, seed=11)
    db.create_publication("pub", [ACCOUNTS, ORDERS])
    db.set_replica_identity(ORDERS, "f")
    store, dest = pkg.store.NotifyingStore(), pkg.dest.MemoryDestination()
    p = _pipeline(pkg, db, store, dest, defaults=defaults)
    if defaults:
        assert p.supervisor is not None
    await p.start()
    await _ready(pkg, store, ACCOUNTS)
    await _ready(pkg, store, ORDERS)
    n = 0
    async with db.transaction() as tx:
        for r in _accounts_rows(rng, range(1000, 1100)):
            tx.insert(ACCOUNTS, r)
            n += 1
    async with db.transaction() as tx:
        for i in range(1, 71):
            new_id = str(5000 + i) if i % 10 == 0 else str(i)
            tx.update(ACCOUNTS, [str(i), None, None],
                      [new_id, f"u{i}", str(i * 7)])
            n += 1
        for i in range(80, 100):
            tx.delete(ACCOUNTS, [str(i), None, None])
            n += 1
    async with db.transaction() as tx:
        for i in range(1, 81):
            tx.update(ORDERS, [str(i), None, None],
                      [str(i), f"{i}.5", "2025-01-01"])
            n += 1
        for i in range(1, 11):
            tx.delete(ORDERS, [str(i), None, None])
            n += 1
    await _wait_for(lambda: len(_row_events(dest)) >= n)
    await p.shutdown_and_wait()
    return reduce_state(dest)


async def scenario_truncate(pkg):
    db, rng = _make_db(pkg, seed=12)
    db.create_publication("pub", [ACCOUNTS])
    store, dest = pkg.store.NotifyingStore(), pkg.dest.MemoryDestination()
    p = _pipeline(pkg, db, store, dest)
    await p.start()
    await _ready(pkg, store, ACCOUNTS)
    async with db.transaction() as tx:
        for r in _accounts_rows(rng, range(2000, 2080)):
            tx.insert(ACCOUNTS, r)
    async with db.transaction() as tx:
        tx.truncate([ACCOUNTS])
    async with db.transaction() as tx:
        for r in _accounts_rows(rng, range(3000, 3070)):
            tx.insert(ACCOUNTS, r)
    await _wait_for(lambda: len(_row_events(dest)) >= 151)
    await p.shutdown_and_wait()
    return reduce_state(dest)


def _pgbench_rows(rng, ids):
    return [[str(i), str(int(rng.integers(1, 11))),
             str(int(rng.integers(-10**9, 10**9))), " " * 84] for i in ids]


async def scenario_offload_filter(pkg):
    """pgbench_accounts with initial rows under `bid <= 5`: the server
    ships every row (server_row_filtering off) and the client's fused
    filter keeps the matching ones, in the copy and in CDC."""
    M = pkg.models
    rng = np.random.default_rng(13)
    db = pkg.fake.FakeDatabase()
    db.create_table(M.TableSchema(
        PGBENCH, M.TableName("public", "pgbench_accounts"),
        (M.ColumnSchema("aid", M.Oid.INT4, nullable=False,
                        primary_key_ordinal=1),
         M.ColumnSchema("bid", M.Oid.INT4),
         M.ColumnSchema("abalance", M.Oid.INT4),
         M.ColumnSchema("filler", M.Oid.BPCHAR, modifier=88))),
        rows=_pgbench_rows(rng, range(1, 301)))
    db.create_publication("pub", [PGBENCH], row_filters={
        PGBENCH: ("bid <= 5", lambda r: r[1] is not None
                  and int(r[1]) <= 5)})
    db.server_row_filtering = False
    store, dest = pkg.store.NotifyingStore(), pkg.dest.MemoryDestination()
    p = _pipeline(pkg, db, store, dest)
    await p.start()
    await _ready(pkg, store, PGBENCH)
    want = 0
    for k in range(4):
        rows = _pgbench_rows(rng, range(1000 + 100 * k, 1100 + 100 * k))
        want += sum(int(r[1]) <= 5 for r in rows)
        async with db.transaction() as tx:
            for r in rows:
                tx.insert(PGBENCH, r)
    await _wait_for(lambda: len(_row_events(dest)) >= want)
    await asyncio.sleep(0.2)  # a wrongly unfiltered row would land here
    await p.shutdown_and_wait()
    state = reduce_state(dest)
    state["want_cdc"] = want
    return state


async def scenario_restart(pkg):
    """Copy and CDC, shutdown, offline WAL, restart on the same store:
    the second pipeline resumes from durable progress, no re-copy, no
    re-delivery."""
    db, rng = _make_db(pkg, seed=14)
    db.create_publication("pub", [ACCOUNTS])
    store, dest = pkg.store.NotifyingStore(), pkg.dest.MemoryDestination()
    p = _pipeline(pkg, db, store, dest)
    await p.start()
    await _ready(pkg, store, ACCOUNTS)
    async with db.transaction() as tx:
        for r in _accounts_rows(rng, range(4000, 4090)):
            tx.insert(ACCOUNTS, r)
    await _wait_for(lambda: len(_row_events(dest)) >= 90)
    await p.shutdown_and_wait()
    async with db.transaction() as tx:
        for r in _accounts_rows(rng, range(5000, 5100)):
            tx.insert(ACCOUNTS, r)
        tx.delete(ACCOUNTS, ["4000", None, None])
    p2 = _pipeline(pkg, db, store, dest)
    await p2.start()
    await _wait_for(lambda: len(_row_events(dest)) >= 191)
    await asyncio.sleep(0.2)  # a re-delivered event would land here
    await p2.shutdown_and_wait()
    return reduce_state(dest)


async def scenario_default_config(pkg):
    """scenario_copy_cdc under the reference's default PipelineConfig:
    supervision (the destination behind SupervisedDestination) and
    poison-pill isolation on."""
    return await scenario_copy_cdc(pkg, defaults=True)


async def scenario_poison_sqlite(pkg):
    """Copy, then CDC with poison rows (names starting `POISON`) into a
    PoisonRejectingDestination, under the default config with the
    reference harness's PoisonConfig(budget_rows=1_000_000), the state in
    a SqliteStore: the healthy rows' end state and the dead-letter entries
    (WAL keys, change type, payload bytes, error) of both runtimes."""
    import tempfile

    from importlib import import_module

    sql = import_module(("etl_tpu_torch" if pkg.port else "etl_tpu")
                        + ".store.sql")
    db, rng = _make_db(pkg, seed=15)
    db.create_publication("pub", [ACCOUNTS, ORDERS])
    inner = pkg.dest.MemoryDestination()
    dest = pkg.dest.PoisonRejectingDestination(inner)
    with tempfile.TemporaryDirectory() as tmp:
        store = sql.SqliteStore(f"{tmp}/state.db", 1)
        await store.connect()
        p = _pipeline(pkg, db, store, dest, defaults=True,
                      poison=pkg.cfg.PoisonConfig(budget_rows=1_000_000))
        await p.start()
        for tid in (ACCOUNTS, ORDERS):
            await _wait_for(lambda: (store._states.get(tid) is not None
                                     and store._states[tid].type
                                     is pkg.runtime.TableStateType.READY))
        healthy = poison = 0
        for k in range(4):
            async with db.transaction() as tx:
                for r in _accounts_rows(rng, range(6000 + 100 * k,
                                                   6100 + 100 * k)):
                    if int(r[0]) % 37 == 0:
                        r[1] = f"POISON-{r[0]}"
                        poison += 1
                    else:
                        healthy += 1
                    tx.insert(ACCOUNTS, r)
        await _wait_for(lambda: len(_row_events(inner)) >= healthy)
        await _wait_for(lambda: dest.rejections > 0)
        deadline = asyncio.get_running_loop().time() + 60
        while len(await store.list_dead_letters()) < poison \
                and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.02)
        await p.shutdown_and_wait()
        entries = await store.list_dead_letters(status=None)
        await store.close()
    state = reduce_state(inner)
    state["dlq"] = sorted(
        (e.table_id, e.commit_lsn, e.tx_ordinal, e.change_type, e.payload,
         e.error_kind, e.detail, e.attempts, e.status, e.columns)
        for e in entries)
    state["poison"] = poison
    return state


SCENARIOS = {"copy_cdc_identity_full": scenario_copy_cdc,
             "default_config": scenario_default_config,
             "poison_sqlite_dlq": scenario_poison_sqlite,
             "truncate": scenario_truncate,
             "offload_row_filter": scenario_offload_filter,
             "restart_resume": scenario_restart}


def _warm_reference_pyarrow():
    """Reference caveat (ROADMAP.md): the reference decoder builds its text
    columns with pyarrow on the copy partitions' threads, and pyarrow's
    first array conversion in a process, made from several threads at
    once, crashed the interpreter (SIGSEGV in `pa.array`, in the
    reference's `_gather_string_arrow`) in 4 of 8 runs of the first two
    scenarios here. The first conversion therefore runs once on the main
    thread. The port builds no pyarrow array on its decode path."""
    import pyarrow as pa

    pa.array(np.zeros(3, dtype=bool))


@pytest.mark.parametrize("name", list(SCENARIOS))
async def test_port_end_state_equals_reference(name):
    _warm_reference_pyarrow()
    ref = await SCENARIOS[name](_pkg("etl_tpu"))
    port = await SCENARIOS[name](_pkg("etl_tpu_torch"))
    assert port["rows"] == ref["rows"]
    assert len(port["events"]) == len(ref["events"])
    for i, (a, b) in enumerate(zip(ref["events"], port["events"])):
        assert a == b, (i, a, b)
    assert port == ref
    assert ref["events"], "the scenario delivered no CDC"
    if "dlq" in ref:
        assert len(ref["dlq"]) == ref["poison"] > 0


async def test_offload_filter_keeps_exactly_the_matching_rows():
    """The offload scenario on the port alone, against the filter's truth:
    copy rows and CDC inserts are exactly those with bid <= 5, and each
    delivered event keeps its own commit LSN and ordinal."""
    state = await scenario_offload_filter(_pkg("etl_tpu_torch"))
    copied = state["rows"][PGBENCH]
    assert copied and all(r[1] <= 5 for r in copied)
    assert len(copied) == sum(
        int(r[1]) <= 5 for r in _pgbench_rows(np.random.default_rng(13),
                                              range(1, 301)))
    ins = [e for e in state["events"] if e[0] == "InsertEvent"]
    assert len(ins) == state["want_cdc"]
    assert all(e[5][1][1] <= 5 for e in ins)
    # ordinals restart per transaction and rise within one: compacted
    # with the rows, not renumbered
    by_commit: dict = {}
    for e in ins:
        by_commit.setdefault(e[2], []).append(e[4])
    assert len(by_commit) == 4
    for ords in by_commit.values():
        assert ords == sorted(ords) and len(set(ords)) == len(ords)
    assert any(o != list(range(len(o))) for o in by_commit.values())
