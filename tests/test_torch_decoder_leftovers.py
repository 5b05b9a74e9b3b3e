"""The decoder's remaining parity cases, on the CPU (the kernels' plain
versions), against the reference on the same inputs: the cases of
tests/test_ops_decode.py `TestCopyStaging`, `TestVeryWideTables` and
`TestWalOldTuplesAtScale`, and of tests/test_filter_fusion.py
`TestFallbackRemap`, each restated for the port; COPY and wide tables
also with device egress (`egress="tsv"`). tests/test_torch_kernels_gpu.py
has the card's cases of the wide tables and of the fallback remap."""

import datetime as dt
import random
import string

import numpy as np
import pytest

from etl_tpu.models import ColumnSchema as RefColumnSchema
from etl_tpu.models import Oid
from etl_tpu.models import ReplicatedTableSchema as RefSchema
from etl_tpu.models import TableName as RefTableName
from etl_tpu.models import TableSchema as RefTableSchema
from etl_tpu.ops import DeviceDecoder as RefDecoder
from etl_tpu.ops import stage_copy_chunk as ref_stage_copy_chunk
from etl_tpu.ops import stage_tuples as ref_stage_tuples
from etl_tpu.ops.predicate import parse_row_filter as ref_parse
from etl_tpu.ops.wal import concat_payloads as ref_concat_payloads
from etl_tpu.ops.wal import stage_wal_batch as ref_stage_wal_batch
from etl_tpu.postgres.codec.pgoutput import TUPLE_NULL, TUPLE_TEXT, TupleData
from etl_tpu_torch import convert
from etl_tpu_torch.destinations.clickhouse import (render_batch_tsv_columnar,
                                                   render_batch_tsv_fast)
from etl_tpu_torch.destinations.util import (sequence_number_batch,
                                             sequence_number_buffer)
from etl_tpu_torch.models.errors import EtlError
from etl_tpu_torch.ops import egress as eg
from etl_tpu_torch.ops.engine import DeviceDecoder
from etl_tpu_torch.ops.staging import stage_copy_chunk
from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
from etl_tpu_torch.postgres.codec import pgoutput
from etl_tpu_torch.postgres.codec.copy_text import encode_copy_row

rng = random.Random(4321)


def make_rts(oids, row_filter=None):
    rts = RefSchema.with_all_columns(RefTableSchema(
        1, RefTableName("public", "t"),
        tuple(RefColumnSchema(f"c{i}", oid) for i, oid in enumerate(oids))))
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


def same_batch(ref, port) -> bool:
    """Two packages' batches hold the same rows: validity, dense values,
    and every other value by repr; `source_rows` alike."""
    if ref.num_rows != port.num_rows:
        return False
    sr, sp = ref.source_rows, port.source_rows
    if (sr is None) != (sp is None) or (
            sr is not None and not np.array_equal(sr, sp)):
        return False
    for rc, pc in zip(ref.columns, port.columns):
        if not np.array_equal(rc.validity, pc.validity):
            return False
        for i in range(ref.num_rows):
            if repr(rc.value(i)) != repr(pc.value(i)):
                return False
    return True


def ref_oracle(rts, staged):
    """The reference's per-row CPU codec route (no program compiled)."""
    return RefDecoder(rts, device_min_rows=10**9, host_min_rows=10**9,
                      mesh=None).decode(staged)


def tsv_identity(schema, batch) -> bool:
    n = batch.num_rows
    z = np.zeros(n, dtype=np.uint64)
    ords = np.arange(n, dtype=np.uint64)
    fast, used = render_batch_tsv_fast(
        schema, batch, "UPSERT", sequence_number_buffer(z, z, ords),
        egress=batch.device_egress)
    oracle = render_batch_tsv_columnar(
        schema, batch, "UPSERT",
        [s.decode() for s in sequence_number_batch(z, z, ords)])
    return fast == oracle and used == (batch.device_egress is not None)


# -- TestCopyStaging ------------------------------------------------------------


def _copy_rows(n):
    lines, texts = [], []
    for i in range(n):
        t = [str(i), f"name-{i}" if i % 3 else None, f"{i}.25"]
        lines.append(encode_copy_row(t))
        texts.append(t)
    return b"\n".join(lines) + b"\n", texts


@pytest.mark.parametrize("egress", [None, "tsv"])
def test_copy_chunk_roundtrip(egress):
    chunk, texts = _copy_rows(80)
    oids = [Oid.INT4, Oid.TEXT, Oid.FLOAT8]
    staged = stage_copy_chunk(chunk, 3)
    assert staged.n_rows == 80 and len(staged.cpu_fallback_rows) == 0
    rts = make_rts(oids)
    schema = port_schema(rts)
    batch = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                          egress=egress).decode(staged)
    for i, t in enumerate(texts):
        assert batch.columns[0].data[i] == i
        if t[1] is None:
            assert not batch.columns[1].validity[i]
        else:
            assert batch.columns[1].value(i) == t[1]
    assert same_batch(ref_oracle(rts, ref_stage_copy_chunk(chunk, 3)), batch)
    if egress is not None:
        dev = batch.device_egress
        assert set(dev.fields) == {0} and dev.untrusted.size == 0
        assert tsv_identity(schema, batch)


@pytest.mark.parametrize("egress", [None, "tsv"])
def test_copy_chunk_with_escapes(egress):
    """A COPY escape sends its row to the CPU oracle; with egress that row
    is untrusted and its TSV line is rendered per value."""
    lines = [encode_copy_row([str(i), "tab\there" if i == 1 else f"p{i}"])
             for i in range(70)]
    lines[2] = encode_copy_row(["2", None])
    chunk = b"\n".join(lines) + b"\n"
    staged = stage_copy_chunk(chunk, 2)
    assert list(staged.cpu_fallback_rows) == [1]
    rts = make_rts([Oid.INT4, Oid.TEXT])
    schema = port_schema(rts)
    batch = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                          egress=egress).decode(staged)
    assert batch.columns[1].value(1) == "tab\there"
    assert not batch.columns[1].validity[2]
    assert same_batch(ref_oracle(rts, ref_stage_copy_chunk(chunk, 2)), batch)
    if egress is not None:
        assert list(batch.device_egress.untrusted) == [1]
        assert tsv_identity(schema, batch)


def test_copy_chunk_ragged_raises():
    with pytest.raises(EtlError):
        stage_copy_chunk(b"1\t2\n3\n", 2)


def test_copy_against_reference_decode():
    """The reference's `test_against_cpu_copy_parser` rows, decoded on
    both packages' device routes."""
    oids = [Oid.INT8, Oid.TEXT, Oid.NUMERIC, Oid.DATE]
    lines = []
    for i in range(64):
        lines.append(encode_copy_row([
            str(rng.randrange(-10**12, 10**12)),
            "".join(rng.choice(string.printable[:60]) for _ in range(10)),
            f"{rng.randrange(0, 10**6)}.{rng.randrange(0, 100):02d}",
            (dt.date(2000, 1, 1) + dt.timedelta(days=i)).isoformat()]))
    chunk = b"\n".join(lines) + b"\n"
    rts = make_rts(oids)
    ref = RefDecoder(rts, device_min_rows=0, mesh=None).decode(
        ref_stage_copy_chunk(chunk, 4))
    port = DeviceDecoder(port_schema(rts), device="cpu",
                         device_min_rows=0).decode(stage_copy_chunk(chunk, 4))
    assert same_batch(ref, port)


# -- TestVeryWideTables -----------------------------------------------------------


def _tuples(rows):
    return [TupleData([TUPLE_NULL if v is None else TUPLE_TEXT for v in r],
                      [None if v is None else v.encode() for v in r])
            for r in rows]


def test_100_dense_columns_stay_on_device():
    """All 100 int columns decode as device columns, through the kernel
    wrapper's plain version; past EGRESS_MAX_COLS renderable columns the
    render plan is None, so the batch carries no device text."""
    oids = [Oid.INT8 if i % 2 else Oid.INT4 for i in range(100)]
    rts = make_rts(oids)
    schema = port_schema(rts)
    dec = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                        egress="tsv")
    assert len(dec._dense) == 100, "wide dense columns spilled"
    rows = [[str((i * 97 + c) % 10**6) for c in range(100)]
            for i in range(300)]
    ref_staged = ref_stage_tuples(_tuples(rows), 100)
    staged = convert.staged_from_arrays(
        ref_staged.data, ref_staged.offsets, ref_staged.lengths,
        ref_staged.nulls, ref_staged.toast, ref_staged.n_rows,
        ref_staged.cpu_fallback_rows, ref_staged.copy_escapes)
    specs = dec._specs(staged, dec._widths(staged))
    assert eg.plan_for_specs(specs, "tsv") is None
    batch = dec.decode(staged)
    assert batch.device_egress is None
    assert same_batch(ref_oracle(rts, ref_staged), batch)
    # the first EGRESS_MAX_COLS columns alone are rendered
    narrow = DeviceDecoder(port_schema(make_rts(oids[:eg.EGRESS_MAX_COLS])),
                           device="cpu", device_min_rows=0, egress="tsv")
    sub = [r[:eg.EGRESS_MAX_COLS] for r in rows]
    rs = ref_stage_tuples(_tuples(sub), eg.EGRESS_MAX_COLS)
    nb = narrow.decode(convert.staged_from_arrays(
        rs.data, rs.offsets, rs.lengths, rs.nulls, rs.toast, rs.n_rows,
        rs.cpu_fallback_rows, rs.copy_escapes))
    assert len(nb.device_egress.fields) == eg.EGRESS_MAX_COLS


def test_260_dense_columns_spill_tail_only():
    oids = [Oid.INT4] * 260
    rts = make_rts(oids)
    dec = DeviceDecoder(port_schema(rts), device="cpu", device_min_rows=0)
    assert len(dec._dense) == 250 and len(dec._object) == 10
    rows = [[str(i + c) for c in range(260)] for i in range(70)]
    ref_staged = ref_stage_tuples(_tuples(rows), 260)
    batch = dec.decode(convert.staged_from_arrays(
        ref_staged.data, ref_staged.offsets, ref_staged.lengths,
        ref_staged.nulls, ref_staged.toast, ref_staged.n_rows,
        ref_staged.cpu_fallback_rows, ref_staged.copy_escapes))
    assert batch.columns[259].value(2) == 261
    assert same_batch(ref_oracle(rts, ref_staged), batch)


# -- TestWalOldTuplesAtScale -------------------------------------------------------


def _mixed_payloads(enc, n, seed):
    """I/U/D payloads with key and full old tuples, `enc` a pgoutput
    module (the reference's or the port's)."""
    r = random.Random(seed)
    payloads, kinds = [], []
    for i in range(n):
        c = r.random()
        if c < 0.5:
            payloads.append(enc.encode_insert(
                1, [str(i).encode(), f"v{i}".encode()]))
            kinds.append(("I", False, False))
        elif c < 0.7:
            payloads.append(enc.encode_update(
                1, [str(i).encode(), f"n{i}".encode()],
                key_values=[str(i - 1).encode(), None]))
            kinds.append(("U", True, True))
        elif c < 0.8:
            payloads.append(enc.encode_update(
                1, [str(i).encode(), f"n{i}".encode()],
                old_values=[str(i - 1).encode(), f"o{i}".encode()]))
            kinds.append(("U", True, False))
        elif c < 0.9:
            payloads.append(enc.encode_update(
                1, [str(i).encode(), f"n{i}".encode()]))
            kinds.append(("U", False, False))
        else:
            full = i % 2 == 0
            payloads.append(enc.encode_delete(
                1, [str(i).encode(), f"d{i}".encode() if full else None],
                full_old=full))
            kinds.append(("D", False, full))
    return payloads, kinds


def test_wal_old_tuples_at_scale():
    """A device-scale WAL batch of mixed I/U/D with key and full old
    tuples: the port's staging maps old tuples and delete kinds exactly
    as the reference's, and both decoded batches equal the reference's."""
    from etl_tpu.postgres.codec import pgoutput as ref_pgoutput

    payloads, kinds = _mixed_payloads(pgoutput, 9000, 5)
    ref_payloads, _ = _mixed_payloads(ref_pgoutput, 9000, 5)
    assert payloads == ref_payloads
    wal = stage_wal_batch(*concat_payloads(payloads), 2)
    ref_wal = ref_stage_wal_batch(*ref_concat_payloads(ref_payloads), 2)
    assert wal.bad_from < 0 and wal.staged.n_rows == len(kinds)
    np.testing.assert_array_equal(wal.delete_is_key, np.array(
        [k == "D" and not full for k, _, full in kinds]))
    expect_old = [i for i, (k, has_old, _) in enumerate(kinds)
                  if k == "U" and has_old]
    np.testing.assert_array_equal(wal.old_rows, expect_old)
    np.testing.assert_array_equal(wal.old_is_key, ref_wal.old_is_key)
    np.testing.assert_array_equal(wal.change_types, ref_wal.change_types)
    rts = make_rts([Oid.INT4, Oid.TEXT])
    dec = DeviceDecoder(port_schema(rts), device="cpu", device_min_rows=0,
                        egress="tsv")
    main = dec.decode(wal.staged)
    old = dec.decode(wal.old_staged)
    for j, i in enumerate(expect_old):
        assert old.columns[0].data[j] == i - 1
        if not wal.old_is_key[j]:
            assert old.columns[1].value(j) == f"o{i}"
        else:
            assert not old.columns[1].validity[j]
    for i, (k, _, _) in enumerate(kinds):
        if k == "D":
            assert main.columns[0].data[i] == i
    assert same_batch(ref_oracle(rts, ref_wal.staged), main)
    assert same_batch(ref_oracle(rts, ref_wal.old_staged), old)
    # the render covers the main batch's rows; its text is the values'
    buf, lens = main.device_egress.field(0)
    assert all(bytes(buf[i, :lens[i]]) == str(main.columns[0].data[i])
               .encode() for i in range(0, 9000, 97))


# -- TestFallbackRemap ----------------------------------------------------------


def test_copy_escape_rows_fix_up_at_compacted_indices():
    """COPY rows with escapes are force-kept; after compaction their fixup
    (and its unescaped values) lands at the COMPACTED positions, as on the
    reference."""
    lines, vals = [], []
    for i in range(300):
        v = rng.randrange(-1000, 1000)
        vals.append(v)
        note = f"a\\tb{i}" if i % 7 == 0 else f"plain{i}"
        lines.append(f"{i}\t{v}\t{note}")
    chunk = ("\n".join(lines) + "\n").encode()
    staged = stage_copy_chunk(chunk, 3)
    assert len(staged.cpu_fallback_rows) > 0
    rts = make_rts([Oid.INT8, Oid.INT4, Oid.TEXT], "c1 < 0")
    schema = port_schema(rts)
    batch = DeviceDecoder(schema, device="cpu", device_min_rows=0) \
        .decode(staged)
    assert list(batch.source_rows) == [i for i, v in enumerate(vals) if v < 0]
    for pos, src in enumerate(batch.source_rows):
        want = f"a\tb{src}" if src % 7 == 0 else f"plain{src}"
        assert batch.columns[2].value(pos) == want
    assert same_batch(RefDecoder(rts, device_min_rows=0, mesh=None)
                      .decode(ref_stage_copy_chunk(chunk, 3)), batch)
    # a filtered batch carries no device text: compaction re-indexes rows
    dev = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                        egress="tsv").decode(stage_copy_chunk(chunk, 3))
    assert dev.device_egress is None and same_batch(
        ref_oracle(rts, ref_stage_copy_chunk(chunk, 3)), dev)


def test_oversized_referenced_field_forces_host_recheck():
    """A referenced int wider than its gather width is force-kept, fixed
    up and re-judged on its true value, at the compacted index."""
    rows = []
    for i in range(128):
        if i % 5 == 0:
            v = ("-" if i % 2 else "+") + "0" * 2100 + f"{i:03d}"
        else:
            v = str(rng.randrange(-1000, 1000))
        rows.append([str(i), v])
    rts = make_rts([Oid.INT8, Oid.INT4], "c1 < 0")
    ref_staged = ref_stage_tuples(_tuples(rows), 2)
    batch = DeviceDecoder(port_schema(rts), device="cpu",
                          device_min_rows=0).decode(
        convert.staged_from_arrays(
            ref_staged.data, ref_staged.offsets, ref_staged.lengths,
            ref_staged.nulls, ref_staged.toast, ref_staged.n_rows,
            ref_staged.cpu_fallback_rows, ref_staged.copy_escapes,
            ref_staged.allow_row_filter))
    allows = rts.row_predicate.compile_texts(rts.table_schema)
    assert list(batch.source_rows) == [i for i, r in enumerate(rows)
                                       if allows(r)]
    assert same_batch(ref_oracle(rts, ref_staged), batch)


# -- TestBuckets, restated as descriptor-cache tests ------------------------------
#
# The reference compiles one XLA program per (row bucket, width signature)
# and counts them in `_fn_cache`. The port compiles nothing per layout:
# the kernel reads a column-descriptor table built from the spec set
# (`decode_kernel.descriptor`), cached on the card per (specs, nibble)
# (`decode_kernel._desc_cache`). "One program" becomes "one spec set, one
# descriptor".


def _texts_staged(rows, n_cols):
    from etl_tpu_torch.ops.staging import stage_tuples
    from etl_tpu_torch.postgres.codec.pgoutput import TupleData as PTD
    from etl_tpu_torch.postgres.codec.pgoutput import TUPLE_NULL as PN
    from etl_tpu_torch.postgres.codec.pgoutput import TUPLE_TEXT as PT

    return stage_tuples([PTD([PN if v is None else PT for v in r],
                             [None if v is None else v.encode() for v in r])
                         for r in rows], n_cols)


def _descriptor_key(dec, staged):
    widths = dec._widths(staged)
    specs = dec._specs(staged, widths)
    return specs, dec._can_nibble(widths)


def _port_oracle(schema, staged):
    """The port's CPU codec, row by row (the oracle route)."""
    return DeviceDecoder(schema, device="cpu",
                         device_min_rows=10**9).decode(staged)


class TestBuckets:
    def test_one_descriptor_serves_3_100_and_250_rows(self):
        from etl_tpu_torch.ops import decode_kernel

        schema = port_schema(make_rts([Oid.INT4]))
        dec = DeviceDecoder(schema, device="cpu", device_min_rows=0)
        keys = set()
        for n in (3, 100, 250):
            staged = _texts_staged([[str(100 + i)] for i in range(n)], 1)
            batch = dec.decode(staged)
            assert list(batch.columns[0].data) == [100 + i for i in range(n)]
            keys.add(_descriptor_key(dec, staged))
        assert len(keys) == 1
        ((specs, nibble),) = keys
        # one table, built once: the same spec set gives the same table
        assert decode_kernel.descriptor(specs, nibble) == \
            decode_kernel.descriptor(specs, nibble)

    def test_one_descriptor_serves_1_and_2_digit_widths(self):
        schema = port_schema(make_rts([Oid.INT4]))
        dec = DeviceDecoder(schema, device="cpu", device_min_rows=0)
        keys = set()
        for hi in (9, 99):
            staged = _texts_staged([[str(hi)] for _ in range(8)], 1)
            assert dec.decode(staged).columns[0].data[0] == hi
            keys.add(_descriptor_key(dec, staged))
        assert len(keys) == 1

    def test_5000_byte_field_falls_back(self):
        rts = make_rts([Oid.TEXT, Oid.INT4])
        big = "x" * 5000
        staged = _texts_staged([[big, "7"]], 2)
        batch = DeviceDecoder(port_schema(rts), device="cpu",
                              device_min_rows=0).decode(staged)
        assert batch.columns[0].value(0) == big
        assert batch.columns[1].data[0] == 7
        assert same_batch(ref_oracle(rts, ref_stage_tuples(
            _tuples([[big, "7"]]), 2)), batch)


# -- TestWideOkWords and TestBitpackTransport --------------------------------------


def _decode_vs_oracles(oids, rows):
    """The device route (plain version) against the port's CPU codec and
    the reference's CPU codec on the same rows."""
    rts = make_rts(oids)
    schema = port_schema(rts)
    staged = _texts_staged(rows, len(oids))
    dev = DeviceDecoder(schema, device="cpu", device_min_rows=0) \
        .decode(staged)
    assert same_batch(_port_oracle(schema, staged), dev)
    assert same_batch(ref_oracle(rts, ref_stage_tuples(_tuples(rows),
                                                       len(oids))), dev)
    return dev


class TestWideOkWords:
    def test_35_dense_columns_use_two_ok_words(self):
        from etl_tpu_torch.ops.bitpack import layout_for_specs

        oids = [Oid.INT4] * 35
        rows = [[str(i * 100 + j) for j in range(35)] for i in range(64)]
        dev = _decode_vs_oracles(oids, rows)
        for j in (0, 30, 31, 34):
            assert dev.columns[j].data[5] == 500 + j
        dec = DeviceDecoder(port_schema(make_rts(oids)), device="cpu",
                            device_min_rows=0)
        specs, _ = _descriptor_key(dec, _texts_staged(rows, 35))
        # the port interleaves each column's ok bit with its value bits
        # (bitpack's layout): 35 ok bits, past the first word
        layout = layout_for_specs(specs)
        ok_slots = [s for col in layout.slots for s in col
                    if s.comp == "ok"]
        assert len(ok_slots) == 35
        assert max(s.bit_off for s in ok_slots) >= 32
        assert layout.n_words >= 2

    def test_lazy_text_consistent_after_fixup(self):
        from etl_tpu_torch.models.cell import PgNumeric

        dev = _decode_vs_oracles([Oid.NUMERIC, Oid.DATE],
                                 [["1.25", "2024-01-01"],
                                  ["3.50", "0044-03-15 BC"]])
        assert isinstance(dev.columns[0].value(0), PgNumeric)
        assert isinstance(dev.columns[0].value(1), PgNumeric)


class TestBitpackTransport:
    def test_extreme_values_roundtrip(self):
        _decode_vs_oracles(
            [Oid.INT2, Oid.INT4, Oid.INT8, Oid.FLOAT8],
            [["-32768", "-2147483648", "-9223372036854775808", "-1.5e22"],
             ["32767", "2147483647", "9223372036854775807", "1e-22"],
             ["0", "0", "0", "-0"]])

    def test_long_mantissa_falls_back_not_truncates(self):
        _decode_vs_oracles(
            [Oid.FLOAT8],
            [["123456789012345000000"], ["0.000000000000000012345"],
             ["999999999999999000000000"], ["1.5"]])

    def test_oversized_tz_offset_falls_back(self):
        schema = port_schema(make_rts([Oid.TIMESTAMPTZ]))
        with pytest.raises(EtlError):
            DeviceDecoder(schema, device="cpu", device_min_rows=0).decode(
                _texts_staged([["2024-01-01 00:00:00+75"]], 1))
        _decode_vs_oracles(
            [Oid.TIMESTAMPTZ],
            [["2024-01-01 00:00:00+09"],
             ["2024-06-15 23:59:59.999999-15:59:59"]])

    def test_timestamptz_extreme_valid_offsets(self):
        _decode_vs_oracles(
            [Oid.TIMESTAMPTZ],
            [["0001-01-01 00:00:00+15:59:59"],
             ["9999-12-31 23:59:59.999999-15:59:59"]])

    def test_layout_saturation_stops_new_descriptors(self):
        from etl_tpu.models.pgtypes import CellKind as RefKind
        from etl_tpu.ops.bitpack import layout_for_specs as ref_layout
        from etl_tpu_torch.models.pgtypes import CellKind
        from etl_tpu_torch.ops.bitpack import (layout_for_specs,
                                               saturation_width)

        for kind in (CellKind.I32, CellKind.I64, CellKind.TIMESTAMPTZ,
                     CellKind.DATE, CellKind.F64, CellKind.BOOL):
            sat = saturation_width(kind)
            a = layout_for_specs(((0, kind, 64, sat),))
            b = layout_for_specs(((0, kind, 64, sat),))
            assert a == b and a.n_words >= 1
            assert a.n_words == ref_layout(
                ((0, RefKind[kind.name], 64, sat),)).n_words


# -- TestPropertyDecode: the reference's generators, the port's two routes ------

PROPERTY_SEED = 20260728
PROPERTY_CASES = 60
PROPERTY_BOX_S = 60.0


def _property_case(rng):
    from etl_tpu.testing.property import GENERATORS, generate_value

    oids = list(GENERATORS)
    n_cols = rng.randint(1, 6)
    cols = [rng.choice(oids) for _ in range(n_cols)]
    n_rows = rng.randint(1, 40)
    rows = [[generate_value(rng, oid).text for oid in cols]
            for _ in range(n_rows)]
    schema = port_schema(make_rts(cols))
    staged = _texts_staged(rows, n_cols)
    dev = DeviceDecoder(schema, device="cpu", device_min_rows=0) \
        .decode(staged)
    assert same_batch(_port_oracle(schema, staged), dev), (cols, rows)


class TestPropertyDecode:
    def test_differential_random_schemas(self):
        """Seeded cases (seed PROPERTY_SEED + i), time-boxed: the device
        route equals the CPU codec on every generated schema."""
        import time

        deadline = time.monotonic() + PROPERTY_BOX_S
        ran = 0
        for i in range(PROPERTY_CASES):
            seed = PROPERTY_SEED + i
            try:
                _property_case(random.Random(seed))
            except BaseException as e:
                raise AssertionError(
                    f"property failed at seed {seed} (replay: "
                    f"_property_case(random.Random({seed})))") from e
            ran += 1
            if time.monotonic() >= deadline:
                break
        assert ran >= 10

    def test_seed_replay_reproduces_the_case(self):
        """The same seed generates the same schema and rows again."""
        from etl_tpu.testing.property import GENERATORS, generate_value

        def draw(seed):
            rng = random.Random(seed)
            cols = [rng.choice(list(GENERATORS))
                    for _ in range(rng.randint(1, 6))]
            return cols, [generate_value(rng, o).text for o in cols]

        assert draw(PROPERTY_SEED + 2) == draw(PROPERTY_SEED + 2)


# -- the codec fuzz targets, against the port's copies -----------------------------

FUZZ_SEED = 20260729
FUZZ_CASES = 300
FUZZ_BOX_S = 1.5


def _port_oid(oid):
    """Both packages' type OIDs are the catalog's integers."""
    return int(oid)


def _same_outcome(port_fn, ref_fn):
    """The port's parse and the reference's on one input: both reject
    typed, or both return the same value."""
    from etl_tpu.models.errors import EtlError as RefError

    try:
        got = ("ok", repr(port_fn()))
    except EtlError as e:
        got = ("typed", e.kind.name)
    try:
        want = ("ok", repr(ref_fn()))
    except RefError as e:
        want = ("typed", e.kind.name)
    assert got == want, (got, want)


def fuzz_parse_text_cell(rng):
    from etl_tpu.postgres.codec.text import parse_cell_text as ref_parse
    from etl_tpu.testing.fuzz import _OIDS, _SEED_TEXTS, _mutate
    from etl_tpu_torch.postgres.codec.text import parse_cell_text

    text = _mutate(rng, rng.choice(_SEED_TEXTS))
    oid = rng.choice(_OIDS)
    _same_outcome(lambda: parse_cell_text(text, _port_oid(oid)),
                  lambda: ref_parse(text, oid))


def fuzz_parse_copy_row(rng):
    from etl_tpu.postgres.codec.copy_text import parse_copy_row as ref_parse
    from etl_tpu.testing.fuzz import _OIDS, _SEED_TEXTS, _mutate
    from etl_tpu_torch.postgres.codec.copy_text import parse_copy_row

    n_cols = rng.randint(1, 6)
    oids = [rng.choice(_OIDS) for _ in range(n_cols)]
    fields = [_mutate(rng, rng.choice(_SEED_TEXTS))
              for _ in range(rng.randint(0, n_cols + 1))]
    line = "\t".join(fields).encode("utf-8", "surrogatepass")[:2048]
    try:
        got = ("ok", repr(parse_copy_row(line,
                                         [_port_oid(o) for o in oids])
                          .values))
    except (EtlError, UnicodeDecodeError) as e:
        got = ("rejected", type(e).__name__)
    from etl_tpu.models.errors import EtlError as RefError

    try:
        want = ("ok", repr(ref_parse(line, oids).values))
    except (RefError, UnicodeDecodeError) as e:
        want = ("rejected", type(e).__name__)
    assert got == want, (got, want)


def fuzz_numeric_roundtrip(rng):
    from etl_tpu.testing.fuzz import _mutate
    from etl_tpu_torch.models.cell import PgNumeric
    from etl_tpu_torch.models.pgtypes import Oid as PortOid
    from etl_tpu_torch.postgres.codec.text import parse_cell_text

    digits = rng.randint(1, 35)
    scale = rng.randint(0, digits)
    n = rng.randint(0, 10**digits - 1)
    s = str(n).rjust(scale + 1, "0")
    text = (("-" if rng.random() < 0.5 else "")
            + (s[:-scale] + "." + s[-scale:] if scale else s))
    v = parse_cell_text(text, PortOid.NUMERIC)
    assert isinstance(v, PgNumeric)
    assert v.pg_text() == text, (v.pg_text(), text)
    try:
        parse_cell_text(_mutate(rng, text), PortOid.NUMERIC)
    except EtlError:
        pass


def fuzz_bytea_hex(rng):
    from etl_tpu.models.pgtypes import Oid as RefOid
    from etl_tpu.postgres.codec.text import parse_cell_text as ref_parse
    from etl_tpu_torch.postgres.codec.text import parse_cell_text

    body = "".join(rng.choice("0123456789abcdefABCDEFxg \\")
                   for _ in range(rng.randint(0, 64)))
    for text in (f"\\x{body}", body):
        _same_outcome(lambda: parse_cell_text(text, _port_oid(Oid.BYTEA)),
                      lambda: ref_parse(text, RefOid.BYTEA))


def fuzz_framer(rng):
    """Random bytes through the port's C framer: it flags malformed
    frames or raises typed, never crashes or emits out-of-bounds
    fields — and frames what the reference's framer frames."""
    from etl_tpu.native import frame_pgoutput as ref_frame
    from etl_tpu_torch.native import frame_pgoutput

    msgs = []
    for _ in range(rng.randint(1, 8)):
        c = rng.random()
        if c < 0.4:
            msgs.append(pgoutput.encode_insert(
                rng.randrange(1, 1 << 31),
                [str(rng.randrange(1000)).encode()
                 for _ in range(rng.randint(0, 4))]))
        elif c < 0.6:
            msgs.append(pgoutput.encode_begin(rng.randrange(1 << 40),
                                              rng.randrange(1 << 50), 7))
        else:
            msgs.append(bytes(rng.randrange(256)
                              for _ in range(rng.randint(0, 64))))
    if msgs and rng.random() < 0.5:
        i = rng.randrange(len(msgs))
        b = bytearray(msgs[i])
        if b:
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        msgs[i] = bytes(b)
    buf = b"".join(msgs)
    lens = np.array([len(m) for m in msgs], dtype=np.int32)
    offs = np.zeros(len(msgs), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    n_cols = rng.randint(1, 8)
    try:
        framed, bad = frame_pgoutput(buf, offs, lens, n_cols)
    except EtlError:
        framed = None
    from etl_tpu.models.errors import EtlError as RefError

    try:
        ref_framed, ref_bad = ref_frame(buf, offs, lens, n_cols)
    except RefError:
        ref_framed = None
    assert (framed is None) == (ref_framed is None)
    if framed is None:
        return
    assert bad == ref_bad
    upto = framed.n_msgs if bad < 0 else bad
    total = len(buf)
    for name in ("new_off", "new_len", "old_off", "old_len"):
        assert np.array_equal(getattr(framed, name)[:upto],
                              getattr(ref_framed, name)[:upto]), name
    for arr_off, arr_len in ((framed.new_off[:upto], framed.new_len[:upto]),
                             (framed.old_off[:upto], framed.old_len[:upto])):
        ends = arr_off.astype(np.int64) + arr_len
        assert (arr_off >= 0).all() and (arr_len >= 0).all() \
            and (ends <= total).all(), "framer emitted out-of-bounds field"


def fuzz_pb_append_rows(rng):
    from etl_tpu_torch.destinations import bq_proto
    from etl_tpu_torch.models.cell import PgNumeric
    from etl_tpu_torch.models.pgtypes import Oid as PortOid
    from etl_tpu_torch.models.schema import (ColumnSchema,
                                             ReplicatedTableSchema,
                                             TableName, TableSchema)
    from etl_tpu_torch.testing.pb_reader import decode_append_rows

    kinds = [(PortOid.INT4, lambda: rng.randrange(-(1 << 31), 1 << 31)),
             (PortOid.INT8, lambda: rng.randrange(-(1 << 62), 1 << 62)),
             (PortOid.TEXT, lambda: "".join(chr(rng.randrange(32, 0x24F))
                                            for _ in range(rng.randint(0, 9)))),
             (PortOid.BOOL, lambda: rng.random() < 0.5),
             (PortOid.FLOAT8, lambda: rng.uniform(-1e12, 1e12)),
             (PortOid.NUMERIC,
              lambda: PgNumeric(str(rng.randrange(10 ** 12))))]
    ncols = rng.randint(1, 5)
    chosen = [kinds[rng.randrange(len(kinds))] for _ in range(ncols)]
    schema = ReplicatedTableSchema.with_all_columns(TableSchema(
        999, TableName("public", "fz"),
        tuple(ColumnSchema(f"c{i}", oid, nullable=True,
                           primary_key_ordinal=1 if i == 0 else None)
              for i, (oid, _) in enumerate(chosen))))
    rows = []
    for r in range(rng.randint(1, 4)):
        values = [None if rng.random() < 0.25 else gen()
                  for _, gen in chosen]
        rows.append(bq_proto.encode_row(schema, values, "UPSERT",
                                        f"{r:016x}"))
    buf = bq_proto.append_rows_request(
        "projects/p/datasets/d/tables/t/streams/_default",
        bq_proto.row_descriptor(schema), rows, trace_id="fz",
        offset=rng.randrange(1 << 40) if rng.random() < 0.5 else None)
    ind = decode_append_rows(buf)
    own = bq_proto.decode_append_rows_request(buf)
    assert ind["write_stream"] == own.write_stream
    assert ind["trace_id"] == own.trace_id
    assert ind.get("offset") == own.offset
    assert [(f["name"], f["number"], f["label"], f["type"])
            for f in ind["descriptor"]["fields"]] == \
        list(own.descriptor_fields)
    assert len(ind["rows"]) == len(own.serialized_rows) == len(rows)
    assert ind["rows"] == own.decode_rows(), (ind["rows"],
                                              own.decode_rows())
    raw = bytearray(buf)
    raw[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
    try:
        decode_append_rows(bytes(raw))
    except (ValueError, KeyError):
        pass


def fuzz_snowpipe_batches(rng):
    import json as _json

    import zstandard

    from etl_tpu_torch.destinations.snowpipe import (MAX_COMPRESSED_BYTES,
                                                     RowBatchBuilder)

    b = RowBatchBuilder()
    docs = []
    split_case = rng.random() < 0.05
    gens = [lambda: rng.randrange(-(1 << 60), 1 << 60),
            lambda: "".join(chr(rng.randrange(32, 0x2FF))
                            for _ in range(rng.randint(0, 2000))),
            lambda: None, lambda: rng.random() * 1e6,
            lambda: rng.random() < 0.5,
            lambda: {"nested": [1, "x", None]}]
    n = rng.randint(8, 12) if split_case else rng.randint(1, 40)
    for i in range(n):
        v = rng.randbytes(512 << 10).hex() if split_case \
            else rng.choice(gens)()
        doc = {"id": i, "v": v, "_cdc_sequence_number": f"{i:016x}"}
        b.push_row(doc, f"{i:016x}")
        docs.append(doc)
    batches = b.finish()
    if split_case:
        assert len(batches) >= 2
    dctx = zstandard.ZstdDecompressor()
    got = []
    row_total = 0
    for rb in batches:
        assert len(rb.data) <= MAX_COMPRESSED_BYTES
        lines = dctx.decompressobj().decompress(rb.data).split(b"\n")
        rows = [_json.loads(ln) for ln in lines if ln]
        assert len(rows) == rb.row_count
        assert rb.start_offset == rows[0]["_cdc_sequence_number"]
        assert rb.end_offset == rows[-1]["_cdc_sequence_number"]
        row_total += rb.row_count
        got.extend(rows)
    assert row_total == n and got == docs
    b2 = RowBatchBuilder()
    with pytest.raises(EtlError):
        b2.push_row({"v": float("inf")}, "0")


#: the reference's `etl_tpu/testing/fuzz.py` targets (`:81`, `:92`,
#: `:106`, `:129`, `:141`, `:251`, `:312`), against the port's copies
PORT_FUZZ_TARGETS = {
    "parse_text_cell": fuzz_parse_text_cell,
    "parse_copy_row": fuzz_parse_copy_row,
    "numeric_roundtrip": fuzz_numeric_roundtrip,
    "bytea_hex": fuzz_bytea_hex,
    "framer": fuzz_framer,
    "pb_append_rows": fuzz_pb_append_rows,
    "snowpipe_batches": fuzz_snowpipe_batches,
}


@pytest.mark.parametrize("target", sorted(PORT_FUZZ_TARGETS))
def test_fuzz_target(target):
    """Seeded (case i runs on seed FUZZ_SEED + i) and time-boxed: at
    least FUZZ_CASES cases, then until FUZZ_BOX_S has passed. A case
    passes when the port's parser matches the contract (and, where both
    packages parse, the reference's outcome); an untyped escape fails."""
    import time

    fn = PORT_FUZZ_TARGETS[target]
    deadline = time.monotonic() + FUZZ_BOX_S
    case = 0
    while case < FUZZ_CASES or time.monotonic() < deadline:
        seed = FUZZ_SEED + case
        try:
            fn(random.Random(seed))
        except EtlError:
            pass  # typed rejection is the contract
        except Exception as e:
            raise AssertionError(
                f"fuzz target {target} failed at seed {seed}: "
                f"{type(e).__name__}: {e}") from e
        case += 1
    assert case >= FUZZ_CASES
