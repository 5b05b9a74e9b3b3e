"""tests/test_property_and_lag.py restated on the port: the property
decode over the port's own generators (`etl_tpu_torch.testing.property`),
the port's decoder on the CPU (the kernels' plain versions) against the
port's CPU codec and against the reference's CPU codec on the same rows;
the slot lag query over the port's wire client and fake
server; and the two packages' generators held to the same draws."""

import random

import numpy as np
import pytest

from etl_tpu_torch.models import ColumnSchema, Oid, TableName, TableSchema
from etl_tpu_torch.models.schema import ReplicatedTableSchema
from etl_tpu_torch.ops.engine import DeviceDecoder
from etl_tpu_torch.ops.staging import stage_tuples
from etl_tpu_torch.postgres.codec.pgoutput import (TUPLE_NULL, TUPLE_TEXT,
                                                   TupleData)
from etl_tpu_torch.testing.property import (GENERATORS, PropertyRunner,
                                            generate_value)


def _schema(oids):
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        1, TableName("public", "t"),
        tuple(ColumnSchema(f"c{i}", oid) for i, oid in enumerate(oids))))


def _staged(rows, n_cols):
    return stage_tuples([TupleData([TUPLE_NULL if v is None else TUPLE_TEXT
                                    for v in r],
                                   [None if v is None else v.encode()
                                    for v in r]) for r in rows], n_cols)


def _assert_batches_equal(dev, cpu) -> None:
    """Same rows: validity, and every value by repr."""
    assert dev.num_rows == cpu.num_rows
    for c, (dc, cc) in enumerate(zip(dev.columns, cpu.columns)):
        np.testing.assert_array_equal(dc.validity, cc.validity, f"col {c}")
        for i in range(dev.num_rows):
            assert repr(dc.value(i)) == repr(cc.value(i)), (c, i)


def decode_reference(oids, rows):
    """The reference's CPU codec (`etl_tpu.postgres.codec.text`) over the
    same rows: its parsers, not the port's."""
    from etl_tpu.models import ColumnarBatch, TableRow
    from etl_tpu.postgres.codec.text import parse_cell_text
    from tests.test_ops_decode import make_schema

    return ColumnarBatch.from_rows(
        make_schema([int(o) for o in oids]),
        [TableRow([None if v is None else parse_cell_text(v, int(oid))
                   for v, oid in zip(r, oids)]) for r in rows])


def decode_both(oids, rows):
    """The port's decoder on its device route (the plain versions on the
    CPU) and on its CPU codec route, over the same staged rows."""
    schema = _schema(oids)
    staged = _staged(rows, len(oids))
    dev = DeviceDecoder(schema, device="cpu", device_min_rows=0) \
        .decode(staged)
    cpu = DeviceDecoder(schema, device="cpu", device_min_rows=10**9) \
        .decode(staged)
    return dev, cpu


class TestPropertyDecode:
    """CPU-decode ≡ device-decode over randomized typed values
    (reference tests/value_roundtrip.rs strategy)."""

    OIDS = list(GENERATORS.keys())

    def test_differential_random_schemas(self):
        runner = PropertyRunner(budget_s=4.0, seed=20260728)

        def case(rng: random.Random):
            n_cols = rng.randint(1, 6)
            oids = [rng.choice(self.OIDS) for _ in range(n_cols)]
            n_rows = rng.randint(1, 40)
            rows = [[generate_value(rng, oid).text for oid in oids]
                    for _ in range(n_rows)]
            dev, cpu = decode_both(oids, rows)
            _assert_batches_equal(dev, cpu)
            _assert_batches_equal(dev, decode_reference(oids, rows))

        runner.run(case)
        assert runner.cases_run >= 3

    def test_seed_replay_reproduces_failure(self):
        runner = PropertyRunner(budget_s=0.5, seed=42)
        seen = []

        def failing(rng: random.Random):
            v = rng.randint(0, 10**9)
            seen.append(v)
            if len(seen) == 3:
                raise ValueError("boom")

        with pytest.raises(AssertionError) as ei:
            runner.run(failing)
        assert "seed 44" in str(ei.value)  # base 42 + case index 2
        # replay: same seed → same value
        replay_rng = random.Random(44)
        assert replay_rng.randint(0, 10**9) == seen[2]

    def test_null_rate_bounds(self):
        """null_rate 0 draws no NULL, 1 draws only NULLs, for every OID."""
        rng = random.Random(7)
        for oid in self.OIDS:
            assert generate_value(rng, oid, null_rate=0.0).text is not None
            v = generate_value(rng, oid, null_rate=1.0)
            assert v.text is None and v.oid == oid


class TestGeneratorParity:
    def test_both_packages_draw_the_same_text(self):
        """200 seeds × every OID: the port's generators and the
        reference's draw identical text (NULLs included)."""
        from etl_tpu.testing.property import GENERATORS as REF_GENERATORS
        from etl_tpu.testing.property import \
            generate_value as ref_generate_value

        assert sorted(int(o) for o in GENERATORS) \
            == sorted(int(o) for o in REF_GENERATORS)
        for seed in range(200):
            for oid in GENERATORS:
                a, b = random.Random(seed), random.Random(seed)
                mine = [generate_value(a, oid).text for _ in range(3)]
                ref = [ref_generate_value(b, int(oid)).text
                       for _ in range(3)]
                assert mine == ref, (seed, oid)


ACCOUNTS = 16384


def make_db():
    from etl_tpu_torch.postgres.fake import FakeDatabase

    db = FakeDatabase()
    db.create_table(TableSchema(
        ACCOUNTS, TableName("public", "accounts"),
        (ColumnSchema("id", Oid.INT4, nullable=False, primary_key_ordinal=1),
         ColumnSchema("name", Oid.TEXT),
         ColumnSchema("balance", Oid.INT8))),
        rows=[["1", "alice", "100"], ["2", "bob", "-5"], ["3", None, "0"]])
    db.create_publication("pub", [ACCOUNTS])
    return db


class TestSlotLag:
    async def test_lag_query_over_wire(self):
        from etl_tpu_torch.postgres.lag import query_slot_lag
        from etl_tpu_torch.postgres.wire import PgWireConnection
        from etl_tpu_torch.testing.fake_pg_server import FakePgServer

        db = make_db()
        server = FakePgServer(db)
        await server.start()
        try:
            conn = PgWireConnection(host="127.0.0.1", port=server.port,
                                    database="postgres", user="etl")
            await conn.connect()
            # create a slot, advance WAL, observe lag
            await conn.query(
                'CREATE_REPLICATION_SLOT "supabase_etl_apply_9" '
                "LOGICAL pgoutput (SNAPSHOT 'export')")
            async with db.transaction() as tx:
                tx.insert(ACCOUNTS, ["999", "lag", "0"])
            metrics = await query_slot_lag(conn)
            assert len(metrics) == 1
            m = metrics[0]
            assert m.slot_name == "supabase_etl_apply_9"
            assert m.confirmed_flush_lag_bytes > 0
            assert m.wal_status == "reserved"
            db.invalidate_slot("supabase_etl_apply_9")
            metrics = await query_slot_lag(conn)
            assert metrics[0].wal_status == "lost"
            await conn.close()
        finally:
            await server.stop()
