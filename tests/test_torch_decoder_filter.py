"""The port's DeviceDecoder with a publication row filter, on the CPU (the
kernels' plain versions), against the reference's DeviceDecoder on the
same staged batches: the compacted batches and their `source_rows` must be
identical, and equal the port's oracle route (every row through the CPU
codec, then `host_keep`) and the filter's per-row truth. The cases of
tests/test_filter_fusion.py that need no runtime, plus the pgbench slice
of the main path (`bid <= 5`) at a small size."""

import random

import numpy as np
import pytest

import bench as ref_bench
from etl_tpu.models import (ColumnSchema, Oid, ReplicatedTableSchema,
                            TableName, TableSchema)
from etl_tpu.ops import DeviceDecoder as RefDecoder
from etl_tpu.ops import stage_tuples
from etl_tpu.ops.predicate import parse_row_filter as ref_parse
from etl_tpu.ops.wal import concat_payloads, stage_wal_batch
from etl_tpu.postgres.codec.pgoutput import TUPLE_NULL, TUPLE_TEXT, TupleData
from etl_tpu_torch import bench
from etl_tpu_torch import convert
from etl_tpu_torch.ops.engine import DeviceDecoder
from etl_tpu_torch.ops.predicate import MAX_PROGRAM_DEPTH

rng = random.Random(1234)


def filtered_batches_identical(a, b) -> bool:
    """Copy of the reference's `harness._filtered_batches_identical`, with
    values compared by repr so that a port batch and a reference batch
    (two packages' value classes) can be held against each other."""
    if a.num_rows != b.num_rows:
        return False
    sa = getattr(a, "source_rows", None)
    sb = getattr(b, "source_rows", None)
    if (sa is None) != (sb is None):
        return False
    if sa is not None and not np.array_equal(sa, sb):
        return False
    for ca, cb in zip(a.columns, b.columns):
        if not np.array_equal(ca.validity, cb.validity):
            return False
        if ca.is_dense and cb.is_dense:
            if not np.array_equal(ca.data[ca.validity],
                                  cb.data[cb.validity]):
                return False
        else:
            for i in range(a.num_rows):
                if ca.validity[i] and repr(ca.value(i)) != repr(cb.value(i)):
                    return False
    return True


def make_rts(cols, row_filter=None):
    rts = ReplicatedTableSchema.with_all_columns(TableSchema(
        1, TableName("public", "t"),
        tuple(ColumnSchema(f"c{i}", oid) for i, oid in enumerate(cols))))
    if row_filter is not None:
        rts = rts.with_row_predicate(ref_parse(row_filter))
    return rts


def port_schema(ref):
    rf = ref.row_predicate
    return convert.schema_from_plain(
        ref.id, ref.name.schema, ref.name.name,
        [(c.name, c.type_oid, c.modifier, c.nullable, c.primary_key_ordinal)
         for c in ref.table_schema.columns],
        list(ref.replication_mask), list(ref.identity_mask),
        row_filter=None if rf is None else rf.to_json())


def port_staged(ref):
    return convert.staged_from_arrays(
        ref.data, ref.offsets, ref.lengths, ref.nulls, ref.toast, ref.n_rows,
        ref.cpu_fallback_rows, ref.copy_escapes, ref.allow_row_filter)


def stage_texts(rows, n_cols):
    return stage_tuples([TupleData(
        [TUPLE_NULL if v is None else TUPLE_TEXT for v in r],
        [None if v is None else v.encode() for v in r]) for r in rows],
        n_cols)


def decode_all(rts, staged):
    """(reference device decode, port device decode on the CPU, port
    oracle route) of one staged batch."""
    ref = RefDecoder(rts, device_min_rows=0, mesh=None).decode(staged)
    ps = port_schema(rts)
    dev = DeviceDecoder(ps, device="cpu", device_min_rows=0) \
        .decode(port_staged(staged))
    orc = DeviceDecoder(ps, device="cpu", device_min_rows=10**9) \
        .decode(port_staged(staged))
    return ref, dev, orc


def assert_all_identical(rts, staged, expected=None):
    ref, dev, orc = decode_all(rts, staged)
    assert filtered_batches_identical(ref, dev), "port != reference"
    assert filtered_batches_identical(dev, orc), "port != port oracle"
    if expected is not None:
        assert dev.source_rows is not None
        assert list(dev.source_rows) == list(expected)
    return dev


def truth(rts, rows):
    allows = rts.row_predicate.compile_texts(rts.table_schema)
    return [i for i, r in enumerate(rows) if allows(r)]


def _rand_ts(frac=True):
    base = (f"2024-{rng.randrange(1, 13):02d}-{rng.randrange(1, 29):02d} "
            f"{rng.randrange(24):02d}:{rng.randrange(60):02d}"
            f":{rng.randrange(60):02d}")
    if frac and rng.random() < 0.7:
        base += f".{rng.randrange(10**6):06d}"
    return base


KIND_CASES = [
    # (oid, value renderer, literal for a mid-split comparison) — the
    # cases of tests/test_filter_fusion.py::TestDifferentialAllKinds
    (Oid.BOOL, lambda: rng.choice(["t", "f"]), "TRUE"),
    (Oid.INT2, lambda: str(rng.randrange(-32768, 32768)), "0"),
    (Oid.INT4, lambda: str(rng.randrange(-2**31, 2**31)), "12345"),
    (Oid.OID, lambda: str(rng.randrange(0, 2**32)), "2147483648"),
    (Oid.INT8, lambda: str(rng.randrange(-2**63, 2**63)),
     "-1234567890123"),
    (Oid.DATE, lambda: f"{rng.randrange(1, 9999):04d}-"
                       f"{rng.randrange(1, 13):02d}-"
                       f"{rng.randrange(1, 29):02d}", "'2024-06-15'"),
    (Oid.TIME, lambda: f"{rng.randrange(24):02d}:{rng.randrange(60):02d}"
                       f":{rng.randrange(60):02d}"
                       f".{rng.randrange(10**6):06d}", "'12:00:00'"),
    (Oid.TIMESTAMP, _rand_ts, "'2024-06-15 12:00:00'"),
    (Oid.TIMESTAMPTZ,
     lambda: _rand_ts() + rng.choice(["+00", "-05", "+09:30", "+02:00"]),
     "'2024-06-15 12:00:00+00'"),
]


class TestDifferentialAllKinds:
    @pytest.mark.parametrize("op", ["<", "=", ">=", "<>"])
    @pytest.mark.parametrize(
        "oid,render,literal", KIND_CASES,
        ids=["bool", "i16", "i32", "u32", "i64", "date", "time", "ts",
             "tstz"])
    def test_device_kinds_match_reference_and_truth(self, oid, render,
                                                    literal, op):
        rts = make_rts([Oid.INT8, oid], f"c1 {op} {literal}")
        rows = [[str(i), None if rng.random() < 0.08 else render()]
                for i in range(300)]
        assert_all_identical(rts, stage_texts(rows, 2), truth(rts, rows))

    @pytest.mark.parametrize("oid,render,literal", [
        (Oid.FLOAT8, lambda: f"{rng.randrange(-10**6, 10**6)}"
                             f".{rng.choice(('0', '25', '5', '75'))}",
         "0.5"),
        (Oid.NUMERIC, lambda: f"{rng.randrange(0, 10**9)}"
                              f".{rng.randrange(100):02d}", "500000000"),
        (Oid.TEXT, lambda: rng.choice(["alpha", "beta", "gamma"]),
         "'beta'"),
    ], ids=["F64", "NUMERIC", "TEXT"])
    def test_host_path_kinds_filter_via_host_keep(self, oid, render,
                                                  literal):
        """Predicates outside the device envelope apply host-side after an
        unfiltered decode (no filter kernel), with identical results."""
        rts = make_rts([Oid.INT8, oid], f"c1 = {literal}")
        rows = [[str(i), None if rng.random() < 0.08 else render()]
                for i in range(300)]
        staged = stage_texts(rows, 2)
        dec = DeviceDecoder(port_schema(rts), device="cpu")
        assert not dec._row_filter.device_supported
        assert dec._device_filter_for(port_staged(staged)) is None
        assert_all_identical(rts, staged, truth(rts, rows))

    def test_compound_predicate(self):
        rts = make_rts(
            [Oid.INT8, Oid.INT4, Oid.DATE],
            "(c1 >= 0 AND c1 < 500000) OR c2 > '2024-06-01' "
            "OR c1 IS NULL")
        rows = [[str(i),
                 None if rng.random() < 0.1
                 else str(rng.randrange(-10**6, 10**6)),
                 f"2024-{rng.randrange(1, 13):02d}-"
                 f"{rng.randrange(1, 29):02d}"]
                for i in range(512)]
        expected = truth(rts, rows)
        assert expected
        assert_all_identical(rts, stage_texts(rows, 3), expected)


class TestSelectivityEdges:
    def _staged(self, n=400):
        rows = [[str(i), str(rng.randrange(-1000, 1000))] for i in range(n)]
        return rows, stage_texts(rows, 2)

    def test_zero_survivors(self):
        _, staged = self._staged()
        batch = assert_all_identical(
            make_rts([Oid.INT8, Oid.INT4], "c1 < -5000"), staged, [])
        assert batch.num_rows == 0

    def test_all_survive(self):
        rows, staged = self._staged()
        assert_all_identical(make_rts([Oid.INT8, Oid.INT4], "c1 >= -1000"),
                             staged, list(range(len(rows))))

    def test_single_survivor(self):
        _, staged = self._staged()
        batch = assert_all_identical(
            make_rts([Oid.INT8, Oid.INT8], "c0 = 123"), staged, [123])
        assert batch.columns[0].data[0] == 123

    def test_all_rows_fallback_bc_dates(self):
        """Every referenced value is device-unparseable (BC dates): the
        device keeps every row, the oracle fixup decodes, and the host
        re-check applies the predicate exactly."""
        rows = [[str(i), f"{rng.randrange(1, 500):04d}-06-15 BC"]
                for i in range(96)]
        rts = make_rts([Oid.INT8, Oid.DATE], "c1 < '0300-01-01 BC'")
        expected = truth(rts, rows)
        assert 0 < len(expected) < len(rows)
        assert_all_identical(rts, stage_texts(rows, 2), expected)


class TestFallbackRecheck:
    def test_oversized_referenced_field_forces_host_recheck(self):
        """A referenced int wider than its gather width (zero-padded past
        the widest gather, MAX_FIELD_WIDTH) is device-untrustworthy:
        force-keep + fixup + host re-evaluation keep or drop it on its
        TRUE value."""
        rows = []
        for i in range(128):
            if i % 5 == 0:
                v = ("-" if i % 2 else "+") + "0" * 2100 + f"{i:03d}"
            else:
                v = str(rng.randrange(-1000, 1000))
            rows.append([str(i), v])
        rts = make_rts([Oid.INT8, Oid.INT4], "c1 < 0")
        staged = stage_texts(rows, 2)
        dec = DeviceDecoder(port_schema(rts), device="cpu",
                            device_min_rows=0)
        pstaged = port_staged(staged)
        flags = dec._row_flags(pstaged, dec._specs(pstaged,
                                                   dec._widths(pstaged)),
                               dec._row_filter, None)
        assert (flags[:128:5] == 2).all()  # every oversized row force-kept
        assert_all_identical(rts, staged, truth(rts, rows))

    def test_nibble_flagged_rows_recheck(self):
        """Bytes outside the nibble alphabet (DATE 'infinity') make the
        packer flag the row: force-kept on the device, fixed up on the
        oracle and re-judged on the decoded value."""
        rows = [[str(i), rng.choice(["infinity", "-infinity"]) if i % 7 == 0
                 else f"{rng.randrange(1990, 2010)}-06-15", f"n{i}"]
                for i in range(200)]
        rts = make_rts([Oid.INT8, Oid.DATE, Oid.TEXT], "c1 > '2000-01-01'")
        dec = DeviceDecoder(port_schema(rts), device="cpu")
        staged = stage_texts(rows, 3)
        pstaged = port_staged(staged)
        specs = dec._specs(pstaged, dec._widths(pstaged))
        packed = dec._pack_host(pstaged, tuple(w for _, _, w, _ in specs))
        assert packed.nibble and packed.bad_rows[:200:7].all()
        expected = truth(rts, rows)
        assert any(rows[i][1] == "infinity" for i in expected)
        assert_all_identical(rts, staged, expected)

    def test_update_runs_are_never_filtered(self):
        """allow_row_filter=False (runs with updates/deletes) bypasses
        filtering entirely."""
        rows = [[str(i), str(-100)] for i in range(200)]
        staged = stage_texts(rows, 2)
        staged.allow_row_filter = False
        rts = make_rts([Oid.INT8, Oid.INT4], "c1 > 0")
        ref, dev, orc = decode_all(rts, staged)
        assert dev.num_rows == orc.num_rows == ref.num_rows == 200
        assert dev.source_rows is None and orc.source_rows is None
        assert filtered_batches_identical(ref, dev)


@pytest.mark.parametrize("sql", [
    "c1 > 0.5",                     # non-integral vs int column
    "c2 > '2024-01-01T00:00:00'",   # ISO 'T' — the codec cannot parse it
])
def test_unrepresentable_literal_degrades_to_unfiltered(sql, caplog):
    """PG accepts these filters; the client envelope cannot represent
    them: the decoder warns and decodes UNFILTERED, as the reference."""
    rts = make_rts([Oid.INT8, Oid.INT4, Oid.TIMESTAMP], sql)
    rows = [[str(i), str(i - 5), f"2024-06-15 12:00:0{i % 10}"]
            for i in range(100)]
    ref, dev, orc = decode_all(rts, stage_texts(rows, 3))
    assert dev.num_rows == orc.num_rows == 100 and dev.source_rows is None
    assert filtered_batches_identical(ref, dev)
    assert "UNFILTERED" in caplog.text


def test_filter_deeper_than_the_kernel_goes_host_side():
    """A postfix program deeper than the kernel's stack: the port applies
    the filter host-side (the reference fuses it); same batch."""
    wide = " OR ".join(f"c1 = {i}" for i in range(MAX_PROGRAM_DEPTH + 8))
    rts = make_rts([Oid.INT8, Oid.INT4], wide)
    rows = [[str(i), str(rng.randrange(0, 80))] for i in range(300)]
    dec = DeviceDecoder(port_schema(rts), device="cpu", device_min_rows=0)
    staged = stage_texts(rows, 2)
    assert dec._row_filter.device_supported
    assert dec._device_filter_for(port_staged(staged)) is None
    assert dec._host_filter_for(port_staged(staged)) is dec._row_filter
    assert_all_identical(rts, staged, truth(rts, rows))


def test_pgbench_slice_bid_le_5():
    """The main path's filtered slice at a small size: pgbench insert CDC
    framed and staged by the reference, `bid <= 5`, decoded by the
    reference, by the port (plain kernels) and by the port's oracle
    route; the survivors are the payloads' rows with bid <= 5, and the
    words fetch shrinks with the survivors."""
    n = 3000
    payloads = ref_bench.build_workload(n)
    staged = stage_wal_batch(*concat_payloads(payloads), 4).staged
    rts = ref_bench.make_schema().with_row_predicate(ref_parse("bid <= 5"))
    want = [i for i, (_, bid, _) in enumerate(bench.pgbench_rows(n))
            if bid <= 5]
    dev = assert_all_identical(rts, staged, want)
    assert 0.4 < dev.num_rows / n < 0.6
    assert bench.oracle_sample_ok(dev, payloads, port_schema(rts), 200,
                                  seed=3)
    ps = port_schema(rts)
    p = DeviceDecoder(ps, device="cpu").decode_async(port_staged(staged))
    p.result()
    u = DeviceDecoder(ps.with_row_predicate(None), device="cpu") \
        .decode_async(port_staged(staged))
    u.result()
    assert p.timings["fetched_bytes"] \
        <= (dev.num_rows / n + 0.11) * u.timings["fetched_bytes"]


def test_two_filtered_batches_in_flight():
    rts = make_rts([Oid.INT8, Oid.INT4], "c1 >= 250")
    rows = [[str(i), str(i)] for i in range(1000)]
    dec = DeviceDecoder(port_schema(rts), device="cpu")
    pending = [dec.decode_async(port_staged(stage_texts(rows, 2)))
               for _ in range(3)]
    first = pending[0].result()
    for p in pending:
        got = p.result()
        assert filtered_batches_identical(first, got)
        assert list(got.source_rows) == list(range(250, 1000))
        assert set(p.timings) == {"pack_ms", "launch_ms", "assemble_ms",
                                 "fetched_bytes"}


def test_selectivity_bench_on_the_cpu():
    """`python -m etl_tpu_torch.bench --selectivity`'s gates at a small
    size with the CPU decoder in the kernel's place."""
    res = bench.run_selectivity(n_rows=4096, device="cpu", n_iters=1)
    assert res["ok"]
    assert [p["target_keep"] for p in res["points"]] == [0.1, 0.5, 0.9]
    for p in res["points"]:
        assert abs(p["measured_keep"] - p["target_keep"]) < 0.05
        assert p["kernel_plain_oracle_identical"] and p["fetch_reduction_ok"]


@pytest.mark.parametrize("row_filter", [None, "c1 >= 250"])
def test_decode_timings_report_the_launch(row_filter):
    """Unfiltered and filtered decodes report the kernel wrapper's host
    time as `launch_ms` beside the same keys as before (CPU: no device
    events, so no h2d, kernel or d2h times); the oracle route runs no
    wrapper and reports no launch."""
    rts = make_rts([Oid.INT8, Oid.INT4], row_filter)
    rows = [[str(i), str(i)] for i in range(1000)]
    dec = DeviceDecoder(port_schema(rts), device="cpu")
    p = dec.decode_async(port_staged(stage_texts(rows, 2)))
    p.result()
    assert set(p.timings) == {"pack_ms", "launch_ms", "assemble_ms",
                              "fetched_bytes"}
    assert p.timings["launch_ms"] > 0
    oracle = DeviceDecoder(port_schema(rts), device="cpu",
                           device_min_rows=10**9)
    q = oracle.decode_async(port_staged(stage_texts(rows, 2)))
    q.result()
    assert "launch_ms" not in q.timings
