"""Device egress in the port, held against the reference on the same
inputs (the kernel's plain version on the CPU).

The cases of tests/test_device_egress.py — the plan, the render against
the host twins, ClickHouse TSV, Snowpipe NDJSON and BigQuery proto byte
identity with and without device text, the engine's attach and
`DeviceEgress.concat` — and the render halves of
tests/test_columnar_egress.py (the vectorized CDC metadata, BigQuery proto
parity), each restated for the port: the port's bytes must equal the
port's own columnar oracle AND the reference's encoders on a reference
batch of the same rows. Then one runtime case (the port's `Pipeline` into
a destination that declares `tsv`), and the no-fallback rule: a render
that fails fails its batch.
"""

import asyncio
import datetime as dt

import numpy as np
import pytest

import etl_tpu.models as R
from etl_tpu.destinations import bq_proto as ref_bq
from etl_tpu.destinations.clickhouse import \
    render_batch_tsv_columnar as ref_tsv_columnar
from etl_tpu.destinations.snowflake import \
    encode_batch_ndjson as ref_ndjson
from etl_tpu.destinations.util import \
    sequence_number_batch as ref_sequence_number_batch
from etl_tpu.ops import egress as ref_eg
import etl_tpu_torch.models as P
from etl_tpu_torch.destinations import bq_proto
from etl_tpu_torch.destinations.base import CoalescedBatch
from etl_tpu_torch.destinations.clickhouse import (render_batch_tsv_columnar,
                                                   render_batch_tsv_fast)
from etl_tpu_torch.destinations.snowflake import (encode_batch_ndjson,
                                                  encode_batch_ndjson_fast,
                                                  offset_token_batch)
from etl_tpu_torch.destinations.util import (change_type_batch,
                                             sequence_number_batch,
                                             sequence_number_buffer)
from etl_tpu_torch.models.pgtypes import CellKind
from etl_tpu_torch.ops import egress as eg

# -- inputs, built alike in both packages -----------------------------------------


def _schema(m, cols, tid=43001, name="dev_egress"):
    return m.ReplicatedTableSchema.with_all_columns(m.TableSchema(
        tid, m.TableName("public", name),
        tuple(m.ColumnSchema(n, oid, **kw) for n, oid, kw in cols)))


PK = {"nullable": False, "primary_key_ordinal": 1}
KINDS_COLS = [("pk", R.Oid.INT8, PK), ("b", R.Oid.BOOL, {}),
              ("i2", R.Oid.INT2, {}), ("i4", R.Oid.INT4, {}),
              ("f4", R.Oid.FLOAT4, {}), ("f8", R.Oid.FLOAT8, {}),
              ("num", R.Oid.NUMERIC, {}), ("d", R.Oid.DATE, {}),
              ("ts", R.Oid.TIMESTAMP, {}), ("tstz", R.Oid.TIMESTAMPTZ, {}),
              ("js", R.Oid.JSONB, {}), ("s", R.Oid.TEXT, {})]
INT_COLS = [("id", R.Oid.INT8, PK), ("v", R.Oid.INT4, {}),
            ("flag", R.Oid.BOOL, {}), ("d", R.Oid.DATE, {}),
            ("note", R.Oid.TEXT, {})]


def kinds_rows(m, n=16, specials=False):
    """The reference's `_kinds_rows` (and `_specials_rows`) in package
    `m`'s value classes."""
    rows = []
    for i in range(n):
        rows.append([
            (i - n // 2) * 123456789,
            bool(i % 2) if i % 5 else None,
            (i - 3) * 7 if i % 4 else None,
            -i * 1000 if i % 3 else None,
            i * 0.5,
            i * 1.25e10 if i % 6 else None,
            m.PgNumeric("9" * 20 + ".%05d" % i),
            dt.date(2024, 5, (i % 28) + 1) if i % 7 else None,
            dt.datetime(2024, 5, 1, 1, 2, 3, 100000 + i),
            dt.datetime(2031, 12, 31, 23, 59, 59, 999990 + (i % 10),
                        tzinfo=dt.timezone.utc),
            {"k": i} if i % 2 else m.JSON_NULL,
            "str-%d\twith\ttabs\nand\\back" % i if i % 2 else None,
        ])
    if specials:
        rows[2][7] = dt.date.max           # DATE past the render range
        rows[5][8] = dt.datetime.max       # TIMESTAMP at the sentinel edge
    return rows


def batch_of(m, cols, rows, tid=43001):
    schema = _schema(m, cols, tid)
    return schema, m.ColumnarBatch.from_rows(
        schema, [m.TableRow(r) for r in rows])


def int_values(n=64, start=0):
    out = []
    for i in range(n):
        out.append([
            str(start + i - n // 3).encode(),
            str((i * 37) % 211 - 100).encode() if i % 7 else None,
            (b"t" if i % 2 else b"f") if i % 5 else None,
            b"2024-0%d-1%d" % ((i % 9) + 1, i % 10),
            b"note-%d" % i if i % 3 else None,
        ])
    return out


def engine_batch(values, egress=None, tid=43002, cols=INT_COLS):
    """A port batch through the real staging and decode path (CPU), and
    the reference batch of the same rows (`from_rows` of its values)."""
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
    from etl_tpu_torch.postgres.codec.pgoutput import encode_insert

    schema = _schema(P, cols, tid, f"t{tid}")
    payloads = [encode_insert(schema.id, v) for v in values]
    wal = stage_wal_batch(*concat_payloads(payloads), len(cols))
    batch = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                          egress=egress).decode(wal.staged)
    rschema = _schema(R, cols, tid, f"t{tid}")
    rbatch = R.ColumnarBatch.from_rows(rschema, [
        R.TableRow([c.value(i) for c in batch.columns])
        for i in range(batch.num_rows)])
    return schema, batch, rschema, rbatch


def seqs_for(n, base=0x2000):
    lsns = np.arange(n, dtype=np.uint64) + base
    ords = np.arange(n, dtype=np.uint64)
    zeros = np.zeros(n, dtype=np.uint64)
    return lsns, zeros, ords


# -- 1. the plan ------------------------------------------------------------------


def _ref_plan(specs, encoder):
    return ref_eg.plan_for_specs(
        tuple((j, R.CellKind[k.name], w, b) for j, k, w, b in specs), encoder)


class TestEgressPlan:
    def test_tsv_selects_renderable_kinds_only(self):
        specs = tuple((j, k, 4, 32) for j, k in enumerate((
            CellKind.I64, CellKind.BOOL, CellKind.F64, CellKind.DATE,
            CellKind.TIMESTAMP, CellKind.STRING)))
        plan = eg.plan_for_specs(specs, eg.ENCODER_TSV)
        assert plan.slots == (0, 1, 3, 4)
        assert plan.kinds == (CellKind.I64, CellKind.BOOL, CellKind.DATE,
                              CellKind.TIMESTAMP)
        assert plan.total_width == 20 + 5 + 10 + 26
        ref = _ref_plan(specs, eg.ENCODER_TSV)
        assert (plan.slots, plan.widths, plan.offsets) \
            == (ref.slots, ref.widths, ref.offsets)

    def test_json_excludes_temporals(self):
        specs = ((0, CellKind.I32, 4, 32), (1, CellKind.DATE, 4, 32),
                 (2, CellKind.TIMESTAMP, 8, 64))
        plan = eg.plan_for_specs(specs, eg.ENCODER_JSON)
        assert plan.slots == (0,) == _ref_plan(specs, "json").slots

    def test_no_renderable_fields_is_none(self):
        specs = ((0, CellKind.F32, 4, 32), (1, CellKind.STRING, 4, 32))
        assert eg.plan_for_specs(specs, eg.ENCODER_TSV) is None
        assert eg.plan_for_specs((), eg.ENCODER_TSV) is None
        assert eg.plan_for_specs(specs, "nope") is None

    def test_too_wide_schema_is_none(self):
        specs = tuple((j, CellKind.I32, 4, 32)
                      for j in range(eg.EGRESS_MAX_COLS + 1))
        assert eg.plan_for_specs(specs, eg.ENCODER_TSV) is None
        assert _ref_plan(specs, "tsv") is None

    @pytest.mark.parametrize("rows", [1, 256, 1000])
    def test_outputs_within_the_transfer_budget(self, rows):
        """The reference's `ir-egress-output-budget`: the render's outputs
        are at most R·ΣW + 4·R·n + 64 bytes."""
        import torch

        from etl_tpu_torch.ops.bitpack import layout_for_specs

        specs = ((0, CellKind.I64, 8, 8), (1, CellKind.DATE, 16, 2))
        plan = eg.plan_for_specs(specs, eg.ENCODER_TSV)
        words = torch.zeros((layout_for_specs(specs).n_words, rows),
                            dtype=torch.int32)
        eb, el = eg.render_plain(words, specs, plan)
        n_out = eb.numel() * eb.element_size() + el.numel() * 4
        assert n_out <= rows * plan.total_width + 4 * rows \
            * len(plan.slots) + 64


# -- 2. the render against the host twins ---------------------------------------------


class TestDeviceVsHostTwins:
    def _egress_fields(self, encoder):
        _, batch, _, _ = engine_batch(int_values(64), egress=encoder)
        dev = batch.device_egress
        assert dev is not None and dev.encoder == encoder
        assert dev.untrusted.size == 0
        return batch, dev

    def test_tsv_fields_match_twins(self):
        batch, dev = self._egress_fields(eg.ENCODER_TSV)
        for j, col in enumerate(batch.columns):
            kind = col.schema.kind
            pair = dev.field(j)
            if kind is CellKind.STRING:
                assert pair is None
                continue
            buf, lens = pair
            data = np.asarray(col.data)
            twin = {CellKind.BOOL: eg.bool_text_fixed,
                    CellKind.DATE: eg.date_text_fixed}.get(
                kind, eg.int_text_fixed)
            ref_twin = {CellKind.BOOL: ref_eg.bool_text_fixed,
                        CellKind.DATE: ref_eg.date_text_fixed}.get(
                kind, ref_eg.int_text_fixed)
            (tbuf, tlens), (rbuf, rlens) = twin(data), ref_twin(data)
            assert np.array_equal(tbuf, rbuf) and np.array_equal(tlens, rlens)
            valid = np.asarray(col.validity, dtype=bool)
            assert np.array_equal(lens[valid], tlens[valid])
            for i in np.flatnonzero(valid):
                assert bytes(buf[i, :lens[i]]) == bytes(tbuf[i, :tlens[i]])

    def test_json_fields_exclude_dates(self):
        _, dev = self._egress_fields(eg.ENCODER_JSON)
        assert set(dev.fields) == {0, 1, 2}

    def test_timestamp_twin_matches_render(self):
        """TIMESTAMP, the widest render (26 B), against the host twin and
        the reference's twin."""
        cols = [("id", R.Oid.INT8, PK), ("ts", R.Oid.TIMESTAMP, {})]
        vals = [[str(i).encode(),
                 b"2024-05-01 01:02:03.%06d" % (i * 999983 % 1000000)]
                for i in range(64)]
        _, b, _, _ = engine_batch(vals, eg.ENCODER_TSV, 43005, cols)
        buf, lens = b.device_egress.field(1)
        micros = np.asarray(b.columns[1].data)
        tbuf, tlens = eg.timestamp_text_fixed(micros)
        rbuf, rlens = ref_eg.timestamp_text_fixed(micros)
        assert np.array_equal(tbuf, rbuf) and np.array_equal(tlens, lens)
        for i in range(len(vals)):
            assert bytes(buf[i, :lens[i]]) == bytes(tbuf[i, :tlens[i]])


# -- 3. destination byte identity --------------------------------------------------------


class TestClickHouseTsvIdentity:
    @pytest.mark.parametrize("specials", [False, True])
    def test_copy_shape_identity(self, specials):
        schema, batch = batch_of(P, KINDS_COLS, kinds_rows(P, 16, specials))
        rschema, rbatch = batch_of(R, KINDS_COLS, kinds_rows(R, 16, specials))
        lsns, zeros, ords = seqs_for(batch.num_rows)
        seq_buf = sequence_number_buffer(lsns, zeros, ords)
        seq_strs = [s.decode() for s in sequence_number_batch(lsns, zeros,
                                                              ords)]
        oracle = render_batch_tsv_columnar(schema, batch, "UPSERT", seq_strs)
        fast, used = render_batch_tsv_fast(schema, batch, "UPSERT", seq_buf)
        assert used is False and fast == oracle
        assert fast == ref_tsv_columnar(rschema, rbatch, "UPSERT", seq_strs)

    def test_cdc_shape_identity(self):
        schema, batch = batch_of(P, KINDS_COLS, kinds_rows(P))
        rschema, rbatch = batch_of(R, KINDS_COLS, kinds_rows(R))
        n = batch.num_rows
        cts = np.array([int(P.ChangeType.DELETE) if i % 4 == 3
                        else int(P.ChangeType.INSERT) for i in range(n)],
                       dtype=np.int8)
        ct_arr = change_type_batch(cts)
        ct_strs = [c.decode() for c in ct_arr.tolist()]
        lsns, zeros, ords = seqs_for(n)
        seq_strs = [s.decode() for s in sequence_number_batch(lsns, zeros,
                                                              ords)]
        fast, _ = render_batch_tsv_fast(
            schema, batch, ct_arr, sequence_number_buffer(lsns, zeros, ords))
        assert fast == render_batch_tsv_columnar(schema, batch, ct_strs,
                                                 seq_strs)
        assert fast == ref_tsv_columnar(rschema, rbatch, ct_strs, seq_strs)

    def test_device_egress_identity(self):
        schema, batch, rschema, rbatch = engine_batch(int_values(64),
                                                      eg.ENCODER_TSV)
        lsns, zeros, ords = seqs_for(batch.num_rows)
        seq_strs = [s.decode() for s in sequence_number_batch(lsns, zeros,
                                                              ords)]
        fast, used = render_batch_tsv_fast(
            schema, batch, "UPSERT", sequence_number_buffer(lsns, zeros,
                                                            ords),
            egress=batch.device_egress)
        assert used is True
        assert fast == render_batch_tsv_columnar(schema, batch, "UPSERT",
                                                 seq_strs)
        assert fast == ref_tsv_columnar(rschema, rbatch, "UPSERT", seq_strs)

    def test_untrusted_rows_spliced_from_the_oracle(self):
        """Rows the CPU oracle fixed up (here: fields past the gather width
        that the nibble packer flagged) are untrusted: their lines are
        rendered per value, and the body still equals the oracle's."""
        vals = int_values(64)
        vals[5][1] = b"+00000000000000000042"  # past the I32 gather width
        vals[9][0] = b"-0000000000000000000000000007"
        schema, batch, rschema, rbatch = engine_batch(vals, eg.ENCODER_TSV)
        assert {5, 9} <= set(batch.device_egress.untrusted.tolist())
        lsns, zeros, ords = seqs_for(batch.num_rows)
        seq_strs = [s.decode() for s in sequence_number_batch(lsns, zeros,
                                                              ords)]
        fast, used = render_batch_tsv_fast(
            schema, batch, "UPSERT", sequence_number_buffer(lsns, zeros,
                                                            ords),
            egress=batch.device_egress)
        assert used and fast == ref_tsv_columnar(rschema, rbatch, "UPSERT",
                                                 seq_strs)


class TestSnowflakeNdjsonIdentity:
    def _labels_seqs(self, n):
        labels = ["delete" if i % 4 == 3 else "insert" for i in range(n)]
        return labels, offset_token_batch(
            np.arange(n, dtype=np.uint64) + 0x3000,
            np.arange(n, dtype=np.uint64))

    @pytest.mark.parametrize("specials", [False, True])
    def test_host_twin_identity(self, specials):
        schema, batch = batch_of(P, KINDS_COLS, kinds_rows(P, 16, specials))
        rschema, rbatch = batch_of(R, KINDS_COLS, kinds_rows(R, 16, specials))
        labels, seqs = self._labels_seqs(batch.num_rows)
        fast, used = encode_batch_ndjson_fast(schema, batch, labels, seqs)
        assert used is False
        assert fast == encode_batch_ndjson(schema, batch, labels, seqs)
        assert fast == ref_ndjson(rschema, rbatch, labels, seqs)

    def test_device_egress_identity(self):
        schema, batch, rschema, rbatch = engine_batch(int_values(64),
                                                      eg.ENCODER_JSON)
        labels, seqs = self._labels_seqs(batch.num_rows)
        fast, used = encode_batch_ndjson_fast(schema, batch, labels, seqs,
                                              egress=batch.device_egress)
        assert used is True
        assert fast == encode_batch_ndjson(schema, batch, labels, seqs)
        assert fast == ref_ndjson(rschema, rbatch, labels, seqs)

    def test_non_finite_float_still_rejected(self):
        cols = [("pk", R.Oid.INT8, PK), ("f", R.Oid.FLOAT8, {})]
        schema, batch = batch_of(P, cols, [[1, float("inf")]], 43009)
        with pytest.raises(P.EtlError):
            encode_batch_ndjson_fast(schema, batch, "insert", "0/0")

    def test_offset_token_batch_matches_scalar(self):
        lsns = np.array([0, 1, 2**64 - 1], dtype=np.uint64)
        ords = np.array([5, 2**40, 0], dtype=np.uint64)
        assert offset_token_batch(lsns, ords) == [
            f"{int(a):016x}/{int(b):016x}" for a, b in zip(lsns, ords)]


class TestBqProtoIdentity:
    def test_date_cells_identical_with_egress(self):
        schema, batch, rschema, rbatch = engine_batch(int_values(64),
                                                      eg.ENCODER_TSV)
        n = batch.num_rows
        cts = [b"UPSERT"] * n
        seqs = sequence_number_batch(np.arange(n, dtype=np.uint64),
                                     np.zeros(n, dtype=np.uint64),
                                     np.zeros(n, dtype=np.uint64))
        oracle = bq_proto.encode_batch(schema, batch, cts, seqs)
        fast = bq_proto.encode_batch(schema, batch, cts, seqs,
                                     egress=batch.device_egress)
        assert fast == oracle == ref_bq.encode_batch(rschema, rbatch, cts,
                                                     seqs)


# -- 4. the engine seam -------------------------------------------------------------------


class TestEngineAttach:
    def test_no_egress_configured_attaches_nothing(self):
        _, batch, _, _ = engine_batch(int_values(64))
        assert batch.device_egress is None

    def test_encoder_field_selection(self):
        _, tsv, _, _ = engine_batch(int_values(64), eg.ENCODER_TSV)
        _, js, _, _ = engine_batch(int_values(64), eg.ENCODER_JSON)
        assert set(tsv.device_egress.fields) == {0, 1, 2, 3}
        assert set(js.device_egress.fields) == {0, 1, 2}

    def test_take_drops_device_buffers(self):
        _, batch, _, _ = engine_batch(int_values(64), eg.ENCODER_TSV)
        assert batch.take(np.array([1, 3, 5])).device_egress is None

    def test_oracle_routed_batch_carries_nothing(self):
        from etl_tpu_torch.ops.engine import DeviceDecoder
        from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
        from etl_tpu_torch.postgres.codec.pgoutput import encode_insert

        schema = _schema(P, INT_COLS, 43003)
        wal = stage_wal_batch(*concat_payloads(
            [encode_insert(schema.id, v) for v in int_values(20)]), 5)
        batch = DeviceDecoder(schema, device="cpu", egress="tsv") \
            .decode(wal.staged)  # 20 rows < DEVICE_MIN_ROWS: the oracle
        assert batch.device_egress is None

    def test_assembler_threads_encoder_from_destination(self):
        import inspect

        from etl_tpu_torch.runtime.assembler import EventAssembler

        params = inspect.signature(EventAssembler.__init__).parameters
        assert params["egress_encoder"].default is None

    def test_batch_config_gate(self):
        from etl_tpu_torch import bench
        from etl_tpu_torch.config import BatchConfig, PipelineConfig
        from etl_tpu_torch.destinations.base import (Destination,
                                                     egress_encoder)

        assert BatchConfig().device_egress is True
        assert Destination.egress_encoder is None
        dest = bench._tsv_destination()
        on = PipelineConfig(pipeline_id=1, publication_name="p")
        off = PipelineConfig(pipeline_id=1, publication_name="p",
                             batch=BatchConfig(device_egress=False))
        assert egress_encoder(on, dest) == "tsv"
        assert egress_encoder(off, dest) is None

    def test_timings_and_fetched_bytes(self):
        from etl_tpu_torch.ops.engine import DeviceDecoder
        from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
        from etl_tpu_torch.postgres.codec.pgoutput import encode_insert

        schema = _schema(P, INT_COLS, 43004)
        wal = stage_wal_batch(*concat_payloads(
            [encode_insert(schema.id, v) for v in int_values(100)]), 5)
        plain = DeviceDecoder(schema, device="cpu").decode_async(wal.staged)
        plain.result()
        p = DeviceDecoder(schema, device="cpu",
                          egress="tsv").decode_async(wal.staged)
        b = p.result()
        plan_bytes = b.device_egress.n_rows * (20 + 11 + 5 + 10 + 4 * 4)
        assert p.timings["fetched_bytes"] \
            >= plain.timings["fetched_bytes"] + plan_bytes


class TestNoFallback:
    def test_failing_render_fails_the_batch(self, monkeypatch):
        """No fallback: a render that raises fails its batch, which does
        not ship without device text."""
        from etl_tpu_torch.ops import egress as egress_mod

        def broken(*args, **kw):
            raise RuntimeError("render refused")

        monkeypatch.setattr(egress_mod, "render", broken)
        with pytest.raises(RuntimeError, match="render refused"):
            engine_batch(int_values(64), eg.ENCODER_TSV)

    def test_failing_render_fails_the_pipelined_batch(self, monkeypatch):
        from etl_tpu_torch.ops import egress as egress_mod
        from etl_tpu_torch.ops.engine import DeviceDecoder
        from etl_tpu_torch.ops.pipeline import DecodePipeline
        from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
        from etl_tpu_torch.postgres.codec.pgoutput import encode_insert

        def broken(*args, **kw):
            raise RuntimeError("render refused")

        schema = _schema(P, INT_COLS, 43006)
        wal = stage_wal_batch(*concat_payloads(
            [encode_insert(schema.id, v) for v in int_values(100)]), 5)
        monkeypatch.setattr(egress_mod, "render", broken)
        pipe = DecodePipeline(name="egress-test")
        try:
            handle = pipe.submit(DeviceDecoder(schema, device="cpu",
                                               egress="tsv"), wal.staged)
            with pytest.raises(RuntimeError, match="render refused"):
                handle.result()
        finally:
            pipe.close()
            assert pipe.join(5.0)


class TestDeviceEgressConcat:
    def _dev(self, start=0):
        return engine_batch(int_values(64, start=start),
                            eg.ENCODER_TSV)[1].device_egress

    def test_concat_merges_offsets(self):
        a, b = self._dev(0), self._dev(100)
        merged = eg.DeviceEgress.concat([a, b])
        assert merged.n_rows == a.n_rows + b.n_rows
        buf, lens = merged.field(0)
        assert np.array_equal(buf[:a.n_rows], a.field(0)[0])
        assert np.array_equal(lens[:a.n_rows], a.field(0)[1])
        assert np.array_equal(buf[a.n_rows:], b.field(0)[0])

    def test_concat_all_or_nothing(self):
        a = self._dev()
        assert eg.DeviceEgress.concat([a, None]) is None
        assert eg.DeviceEgress.concat([]) is None
        other = eg.DeviceEgress("json", a.n_rows, dict(a.fields),
                                a.untrusted)
        assert eg.DeviceEgress.concat([a, other]) is None

    def test_concat_shifts_untrusted_rows(self):
        a = self._dev()
        b = eg.DeviceEgress(a.encoder, a.n_rows, dict(a.fields),
                            np.array([3, 7], dtype=np.int64))
        merged = eg.DeviceEgress.concat([b, a, b])
        assert merged.untrusted.tolist() == [3, 7, 131, 135]

    def test_coalesced_batch_carries_merged_egress(self):
        _, b1, _, _ = engine_batch(int_values(64, start=0), eg.ENCODER_TSV)
        schema, b2, rschema, _ = engine_batch(int_values(64, start=200),
                                              eg.ENCODER_TSV)

        def event(batch, start):
            n = batch.num_rows
            return P.DecodedBatchEvent(
                P.Lsn(start + 1), P.Lsn(start + n), schema,
                change_types=np.zeros(n, dtype=np.int8),
                commit_lsns=np.arange(start, start + n, dtype=np.uint64),
                tx_ordinals=np.arange(n, dtype=np.uint64), batch=batch)

        cb = CoalescedBatch([event(b1, 0), event(b2, 64)])
        assert cb.egress is not None and cb.egress.n_rows == 128
        assert cb.batch.num_rows == 128
        z = np.zeros(128, dtype=np.uint64)
        seq_strs = [s.decode() for s in sequence_number_batch(
            cb.commit_lsns, cb.tx_ordinals, z)]
        fast, used = render_batch_tsv_fast(
            schema, cb.batch, change_type_batch(cb.change_types),
            sequence_number_buffer(cb.commit_lsns, cb.tx_ordinals, z),
            egress=cb.egress)
        rbatch = R.ColumnarBatch.from_rows(rschema, [
            R.TableRow([c.value(i) for c in cb.batch.columns])
            for i in range(128)])
        assert used and fast == ref_tsv_columnar(rschema, rbatch,
                                                 ["UPSERT"] * 128, seq_strs)


# -- the render halves of tests/test_columnar_egress.py ----------------------------------


class TestVectorizedCdcMetadata:
    def test_sequence_numbers_match_fstring_reference(self):
        lsns = np.array([0, 1, 0xDEADBEEF, 2**64 - 1, 2**40],
                        dtype=np.uint64)
        txos = np.array([0, 7, 2**63, 1, 42], dtype=np.uint64)
        ords = np.array([0, 1, 2, 3, 2**32], dtype=np.uint64)
        got = sequence_number_batch(lsns, txos, ords)
        assert got == ref_sequence_number_batch(lsns, txos, ords)
        for i in range(len(lsns)):
            assert got[i].decode() == (f"{int(lsns[i]):016x}/"
                                       f"{int(txos[i]):016x}/"
                                       f"{int(ords[i]):016x}")

    def test_sequence_matches_event_key(self):
        key = P.EventSequenceKey(P.Lsn(0x1234), 9)
        got = sequence_number_batch(np.array([0x1234], dtype=np.uint64),
                                    np.array([9], dtype=np.uint64),
                                    np.array([3], dtype=np.uint64))
        assert got[0].decode() == key.with_ordinal(3)

    def test_change_type_labels(self):
        cts = np.array([0, 1, 2, 0, 2])
        assert change_type_batch(cts).tolist() == \
            [b"UPSERT", b"UPSERT", b"DELETE", b"UPSERT", b"DELETE"]


ALL_COLS = KINDS_COLS[:8] + [("t", R.Oid.TIME, {})] + KINDS_COLS[8:10] + [
    ("u", R.Oid.UUID, {}), ("js", R.Oid.JSONB, {}), ("by", R.Oid.BYTEA, {}),
    ("s", R.Oid.TEXT, {})]


def all_kinds_rows(m, n):
    import uuid

    rows = []
    for i in range(n):
        rows.append([
            i, bool(i % 2) if i % 5 else None, (i - 3) * 7 if i % 4 else None,
            -i * 1000 if i % 3 else None, i * 0.5, i * 1.25e10,
            m.PgNumeric("123456789012345678901234567890.%09d" % i),
            dt.date(2024, 5, (i % 28) + 1), dt.time(12, 34, 56, i),
            dt.datetime(2024, 5, 1, 1, 2, 3, 100000 + i),
            dt.datetime(2031, 12, 31, 23, 59, 59, 999990 + (i % 10),
                        tzinfo=dt.timezone.utc),
            uuid.UUID(int=i + 7), {"k": i} if i % 2 else m.JSON_NULL,
            b"\x00\xffbytes-%d" % i,
            "str-%d\twith\ttabs" % i if i % 2 else None])
    return rows


class TestBqProtoParity:
    def test_encode_batch_identical_to_encode_row_all_kinds(self):
        schema, batch = batch_of(P, ALL_COLS, all_kinds_rows(P, 32), 41001)
        rschema, rbatch = batch_of(R, ALL_COLS, all_kinds_rows(R, 32), 41001)
        n = batch.num_rows
        cts = np.array([0 if i % 3 else 2 for i in range(n)])
        lsns = np.arange(n, dtype=np.uint64) + 2**40
        txos = np.arange(n, dtype=np.uint64)
        labels = change_type_batch(cts).tolist()
        seqs = sequence_number_batch(lsns, txos, txos)
        got = bq_proto.encode_batch(schema, batch, labels, seqs)
        want = [bq_proto.encode_row(
            schema, [c.value(i) for c in batch.columns],
            labels[i].decode(), seqs[i].decode()) for i in range(n)]
        assert got == want == ref_bq.encode_batch(rschema, rbatch, labels,
                                                  seqs)
        assert bq_proto.row_descriptor(schema) \
            == ref_bq.row_descriptor(rschema)

    def test_encode_batch_identical_on_engine_batch(self):
        cols = [("id", R.Oid.INT8, PK), ("v", R.Oid.INT4, {}),
                ("note", R.Oid.TEXT, {})]
        vals = [[str(i).encode(), str(i % 97).encode(), b"note-%d" % i]
                for i in range(128)]
        schema, batch, rschema, rbatch = engine_batch(vals, None, 41002,
                                                      cols)
        n = batch.num_rows
        labels = change_type_batch(np.zeros(n)).tolist()
        seqs = sequence_number_batch(np.arange(n, dtype=np.uint64),
                                     np.zeros(n, dtype=np.uint64),
                                     np.arange(n, dtype=np.uint64))
        got = bq_proto.encode_batch(schema, batch, labels, seqs)
        want = [bq_proto.encode_row(
            schema, [c.value(i) for c in batch.columns],
            labels[i].decode(), seqs[i].decode()) for i in range(n)]
        assert got == want == ref_bq.encode_batch(rschema, rbatch, labels,
                                                  seqs)

    def test_dense_timestamptz_specials_raise_like_row_path(self):
        schema = _schema(P, [("ts", R.Oid.TIMESTAMPTZ, {})], 41017)
        col = P.Column(schema.replicated_columns[0],
                       np.array([2**63 - 1], dtype=np.int64),
                       np.array([True]))
        with pytest.raises(P.EtlError):
            bq_proto.encode_batch(schema, P.ColumnarBatch(schema, [col]),
                                  [b"UPSERT"], [b"0" * 50])


# -- the runtime ------------------------------------------------------------------------------


def test_pipeline_delivers_tsv_bodies_equal_to_the_reference():
    """The port's `Pipeline` (CUDA engine on the CPU's plain versions)
    copies and streams into a destination that declares `tsv`: every CDC
    write's body, rendered from the device text, equals the reference's
    columnar encoder on a reference batch of the same rows."""
    from etl_tpu_torch import bench
    from etl_tpu_torch.models.table_state import TableStateType
    from etl_tpu_torch.postgres.fake import FakeDatabase

    async def run():
        db = FakeDatabase()
        schema = bench.make_schema()
        db.create_table(schema.table_schema)
        db.create_publication("pub", [schema.id])
        dest = bench._tsv_destination()
        pipeline, store = bench._pipeline(db, dest, "cpu", max_fill_ms=20)
        await pipeline.start()
        await asyncio.wait_for(store.notify_on(schema.id,
                                               TableStateType.READY), 30)
        t = bench.pgbench_table(600, 3)
        payloads = bench.table_payloads(t)
        for lo in range(0, 600, 200):
            tx = db.transaction()
            for p in payloads[lo:lo + 200]:
                tx.insert_preencoded(schema.id, p)
            await tx.commit()
        for _ in range(3000):
            if dest.rows_delivered >= 600:
                break
            await asyncio.sleep(0.01)
        await pipeline.shutdown_and_wait()
        return dest

    dest = asyncio.run(run())
    assert dest.rows_delivered == 600
    assert dest.writes and all(used for _, _, used in dest.writes)
    checks = bench.tsv_checks(dest, 64)
    assert checks["bodies_identical"] and checks["device_runs_carried_text"]
    cols = [(c.name, c.type_oid, {"nullable": c.nullable,
                                  "primary_key_ordinal":
                                      c.primary_key_ordinal})
            for c in bench.make_schema().table_schema.columns]
    rschema = R.ReplicatedTableSchema.with_all_columns(R.TableSchema(
        bench.make_schema().id, R.TableName("public", "pgbench_accounts"),
        tuple(R.ColumnSchema(n, oid, **kw) for n, oid, kw in cols)))
    for cb, body, _ in dest.writes:
        n = cb.num_rows
        rbatch = R.ColumnarBatch.from_rows(rschema, [
            R.TableRow([c.value(i) for c in cb.batch.columns])
            for i in range(n)])
        labels = [s.decode() for s in change_type_batch(
            cb.change_types).tolist()]
        seqs = [s.decode() for s in ref_sequence_number_batch(
            cb.commit_lsns, cb.tx_ordinals, np.zeros(n, dtype=np.uint64))]
        assert body == ref_tsv_columnar(rschema, rbatch, labels, seqs)
