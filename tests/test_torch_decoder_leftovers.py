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


# -- TestPropertyDecode: the port's generators, the port's two routes -----------

PROPERTY_SEED = 20260728
PROPERTY_CASES = 60
PROPERTY_BOX_S = 60.0


def _property_case(rng):
    from etl_tpu_torch.testing.property import GENERATORS, generate_value

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
        from etl_tpu_torch.testing.property import GENERATORS, generate_value

        def draw(seed):
            rng = random.Random(seed)
            cols = [rng.choice(list(GENERATORS))
                    for _ in range(rng.randint(1, 6))]
            return cols, [generate_value(rng, o).text for o in cols]

        assert draw(PROPERTY_SEED + 2) == draw(PROPERTY_SEED + 2)
