"""The port's DeviceDecoder on the CPU (the kernel's plain version)
against the reference's DeviceDecoder on the same staged batches: the
ColumnarBatches must be identical."""

import datetime as dt
import random

import numpy as np
import pytest

import bench as ref_bench
from etl_tpu.models import (ColumnSchema, Oid, ReplicatedTableSchema,
                            TableName, TableSchema)
from etl_tpu.models.errors import EtlError as RefEtlError
from etl_tpu.ops import DeviceDecoder as RefDecoder
from etl_tpu.ops import stage_tuples
from etl_tpu.ops.wal import concat_payloads, stage_wal_batch
from etl_tpu.postgres.codec.pgoutput import (TUPLE_NULL, TUPLE_TEXT,
                                             TUPLE_UNCHANGED_TOAST, TupleData)
from etl_tpu_torch import convert
from etl_tpu_torch.models.errors import ErrorKind, EtlError
from etl_tpu_torch.ops.engine import DeviceDecoder


def port_schema(ref):
    return convert.schema_from_plain(
        ref.id, ref.name.schema, ref.name.name,
        [(c.name, c.type_oid, c.modifier, c.nullable, c.primary_key_ordinal)
         for c in ref.table_schema.columns],
        list(ref.replication_mask), list(ref.identity_mask))


def port_staged(ref):
    return convert.staged_from_arrays(
        ref.data, ref.offsets, ref.lengths, ref.nulls, ref.toast, ref.n_rows,
        ref.cpu_fallback_rows, ref.copy_escapes)


def make_schema(oids):
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        1, TableName("public", "t"),
        tuple(ColumnSchema(f"c{i}", oid) for i, oid in enumerate(oids))))


def staged_from_texts(rows, n_cols):
    return stage_tuples([TupleData(
        [TUPLE_NULL if v is None else TUPLE_TEXT for v in r],
        [None if v is None else v.encode() for v in r]) for r in rows],
        n_cols)


def assert_same_batch(ref, port):
    assert ref.num_rows == port.num_rows
    for rc, pc in zip(ref.columns, port.columns):
        name = rc.schema.name
        np.testing.assert_array_equal(rc.validity, pc.validity, err_msg=name)
        assert (rc.toast_unchanged is None) == (pc.toast_unchanged is None)
        if rc.toast_unchanged is not None:
            np.testing.assert_array_equal(rc.toast_unchanged,
                                          pc.toast_unchanged, err_msg=name)
        assert rc.is_dense == pc.is_dense, name
        if rc.is_dense:
            assert rc.data.dtype == pc.data.dtype, name
            a = np.where(rc.validity, rc.data, 0)
            b = np.where(pc.validity, pc.data, 0)
            assert a.tobytes() == b.tobytes(), name
        for i in range(ref.num_rows):
            rv, pv = rc.value(i), pc.value(i)
            if rv != rv and pv != pv:  # NaN (float or numeric)
                continue
            assert repr(rv) == repr(pv), (name, i, rv, pv)


def decode_both(ref_schema, ref_staged, **port_kw):
    ref = RefDecoder(ref_schema, mesh=None, device_min_rows=0) \
        .decode(ref_staged)
    kw = {"device": "cpu", "device_min_rows": 0, **port_kw}
    port = DeviceDecoder(port_schema(ref_schema), **kw) \
        .decode(port_staged(ref_staged))
    return ref, port


def check_texts(oids, rows, **port_kw):
    ref, port = decode_both(make_schema(oids),
                            staged_from_texts(rows, len(oids)), **port_kw)
    assert_same_batch(ref, port)
    return port


def test_pgbench_batch():
    payloads = ref_bench.build_workload(3000)
    staged = stage_wal_batch(*concat_payloads(payloads), 4).staged
    ref, port = decode_both(ref_bench.make_schema(), staged)
    assert_same_batch(ref, port)
    assert port.columns[3].is_text
    assert port.columns[3].value(5) == " " * 84


def test_wal_batch_with_toast_and_nulls():
    from test_torch_staging import toast_payloads
    from etl_tpu.postgres.codec import pgoutput

    schema = make_schema([Oid.INT4, Oid.TEXT, Oid.INT8])
    staged = stage_wal_batch(
        *concat_payloads(toast_payloads(pgoutput, 600)), 3).staged
    ref, port = decode_both(schema, staged)
    assert_same_batch(ref, port)
    assert port.columns[1].is_toast_unchanged(0)
    assert not port.columns[1].validity[5]


def _pallas_rows_int_temporal():
    rng = random.Random(42)
    tzs = ["+0{h}", "-0{h}", "+0{h}:30", "-0{h}:30", "+0{h}:30:15"]
    rows = []
    for i in range(256):
        tz = tzs[i % len(tzs)].format(h=i % 9)
        rows.append([str(i - 128), str(rng.randrange(-2**62, 2**62)),
                     f"20{i % 100:02d}-03-{1 + i % 28:02d}",
                     f"2024-05-01 12:{i % 60:02d}:33.25{tz}"])
    return rows


def _pallas_rows_float_time_bool():
    floats = ["1.5", "-0.25", "3e4", "-2.5E-3", "0.0001", "12345.678",
              "NaN", "Infinity", "-Infinity", "1e30", "7", "-0"]
    floats8 = floats[:-3] + ["1e300"] + floats[-2:]
    rows = []
    for i in range(256):
        rows.append([
            "t" if i % 2 else "f", str(i - 128), floats[i % len(floats)],
            floats8[(i + 5) % len(floats8)],
            f"{i % 24:02d}:{i % 60:02d}:{(i * 7) % 60:02d}"
            + ("" if i % 3 == 0 else f".{i % 1_000_000:06d}"[:1 + i % 7]),
            f"19{i % 100:02d}-11-{1 + i % 28:02d} "
            f"{i % 24:02d}:00:{i % 60:02d}"])
    return rows


ROW_SETS = {
    # the row sets of tests/test_ops_decode.py::TestPallasKernel
    "pallas_int_temporal": (
        [Oid.INT4, Oid.INT8, Oid.DATE, Oid.TIMESTAMPTZ],
        _pallas_rows_int_temporal()),
    "pallas_float_time_bool": (
        [Oid.BOOL, Oid.INT2, Oid.FLOAT4, Oid.FLOAT8, Oid.TIME,
         Oid.TIMESTAMP], _pallas_rows_float_time_bool()),
    "int_extremes": (
        [Oid.INT2, Oid.INT4, Oid.INT8],
        [["-32768", "-2147483648", "-9223372036854775808"],
         ["32767", "2147483647", "9223372036854775807"],
         ["0", "-0", "+5"], [None, "1", None]]),
    "floats_fallback": (
        [Oid.FLOAT8, Oid.FLOAT4],
        [["1.5", "-0.25"], ["100", "2.5e10"], ["-1e-5", "0"],
         ["NaN", "Infinity"], [None, "-Infinity"],
         ["0.8444218515250481", "1"], ["1.7976931348623157e308", "2"],
         ["5e-324", "3"], ["123456789012345000000", "4"],
         ["0.000000000000000012345", "5"], ["-1.5e22", "1e-22"]]),
    "dates_times": (
        [Oid.DATE, Oid.TIME, Oid.TIMESTAMP],
        [["2024-02-29", "00:00:00", "2024-05-01 12:34:56"],
         ["1970-01-01", "23:59:59.999999", "2262-04-11 23:47:16.854775"],
         ["0001-01-01", "12:30:15.5", "1900-01-01 06:00:00.1"],
         ["9999-12-31", "01:02:03.123", "1970-01-01 00:00:00"],
         ["0044-03-15 BC", None, "2024-05-01 12:34:56.789123"],
         [None, "24:00:00", None]]),
    "timestamptz": (
        [Oid.TIMESTAMPTZ],
        [["2024-05-01 12:34:56+02"], ["2024-05-01 12:34:56.789-05:30"],
         ["2024-01-01 00:00:00+00"], ["1995-06-15 10:00:00.25+09:30:30"],
         ["0001-01-01 00:00:00+15:59:59"],
         ["9999-12-31 23:59:59.999999-15:59:59"], [None]]),
    "objects": (
        [Oid.TEXT, Oid.NUMERIC, Oid.UUID, Oid.JSONB],
        [["hello", "12.340", "a0eebc99-9c0b-4ef8-bb6d-6bb9bd380a11",
          '{"k": 1}'],
         [None, "NaN", None, "[1,2]"],
         ["unicode-é", "-99999999999999999999.5", None, "null"]]),
    "lazy_text_after_fixup": (
        [Oid.NUMERIC, Oid.DATE],
        [["1.25", "2024-01-01"], ["3.50", "0044-03-15 BC"]]),
    "wide_35_int4": (
        [Oid.INT4] * 35,
        [[str(i * 100 + j) for j in range(35)] for i in range(64)]),
    "random_dates_timestamps": (
        [Oid.DATE, Oid.TIMESTAMP],
        [[(dt.date(1900, 1, 1) + dt.timedelta(days=i * 263)).isoformat(),
          (dt.datetime(1950, 1, 1) + dt.timedelta(
              seconds=i * 19_999_937, microseconds=i * 7919 % 10**6))
          .isoformat(sep=" ")] for i in range(300)]),
}


@pytest.mark.parametrize("name", list(ROW_SETS))
def test_row_sets(name):
    oids, rows = ROW_SETS[name]
    check_texts(oids, rows)


def test_numeric_f64_mode():
    port = check_texts([Oid.NUMERIC], [["12.5"], ["-3"], [None]],
                       numeric_mode="text")
    assert port.columns[0].is_text
    ref_schema = make_schema([Oid.NUMERIC])
    staged = staged_from_texts([["12.5"], ["-3"], [None]], 1)
    ref = RefDecoder(ref_schema, numeric_mode="f64", mesh=None,
                     device_min_rows=0).decode(staged)
    port = DeviceDecoder(port_schema(ref_schema), device="cpu",
                         numeric_mode="f64", device_min_rows=0) \
        .decode(port_staged(staged))
    assert port.columns[0].is_dense
    assert_same_batch(ref, port)


def test_toast_passthrough():
    schema = make_schema([Oid.INT4, Oid.TEXT, Oid.INT8])
    staged = stage_tuples([
        TupleData([TUPLE_TEXT, TUPLE_UNCHANGED_TOAST, TUPLE_UNCHANGED_TOAST],
                  [b"5", None, None]),
        TupleData([TUPLE_TEXT, TUPLE_TEXT, TUPLE_NULL], [b"6", b"x", None])],
        3)
    ref, port = decode_both(schema, staged)
    assert_same_batch(ref, port)
    assert port.columns[1].is_toast_unchanged(0)
    assert port.columns[0].data[0] == 5


def test_oracle_route_below_device_min_rows():
    """Below device_min_rows (default 64) every row takes the CPU oracle,
    as in the reference below its thresholds."""
    oids = [Oid.INT8, Oid.FLOAT8, Oid.TIMESTAMPTZ, Oid.TEXT]
    rows = [[str(i * 7919 - 10**12), f"{i}.25",
             "2024-05-01 12:34:56.789+05:30", f"note-{i}"]
            for i in range(40)]
    schema = make_schema(oids)
    staged = staged_from_texts(rows, 4)
    ref = RefDecoder(schema, mesh=None, device_min_rows=10**9,
                     host_min_rows=10**9).decode(staged)
    dec = DeviceDecoder(port_schema(schema), device="cpu")
    assert dec.device_min_rows == 64
    assert dec._route(port_staged(staged))[0] == "oracle"
    port = dec.decode(port_staged(staged))
    assert_same_batch(ref, port)


def test_decode_async_two_in_flight():
    payloads = ref_bench.build_workload(1000)
    staged = stage_wal_batch(*concat_payloads(payloads), 4).staged
    ref = RefDecoder(ref_bench.make_schema(), mesh=None,
                     device_min_rows=0).decode(staged)
    dec = DeviceDecoder(port_schema(ref_bench.make_schema()), device="cpu")
    pending = [dec.decode_async(port_staged(staged)) for _ in range(2)]
    for p in pending:
        assert_same_batch(ref, p.result())
        assert set(p.timings) == {"pack_ms", "launch_ms", "assemble_ms",
                                 "fetched_bytes"}


@pytest.mark.parametrize("oid,text", [
    (Oid.INT4, "99999999999"), (Oid.INT2, "70000"),
    (Oid.INT8, "9223372036854775808")])
def test_out_of_range_raises_like_reference(oid, text):
    schema = make_schema([oid])
    staged = staged_from_texts([[text], ["5"]], 1)
    with pytest.raises(RefEtlError):
        RefDecoder(schema, mesh=None, device_min_rows=0).decode(staged)
    with pytest.raises(EtlError) as ei:
        DeviceDecoder(port_schema(schema), device="cpu", device_min_rows=0) \
            .decode(port_staged(staged))
    assert ei.value.kind is ErrorKind.ROW_CONVERSION_FAILED


def test_oversized_field_falls_back():
    check_texts([Oid.TEXT, Oid.INT4], [["x" * 5000, "7"], ["y", "8"]])
