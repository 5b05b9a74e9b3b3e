"""The port's program store (`etl_tpu_torch/ops/program_store.py`) against
the reference's (`etl_tpu/ops/program_store.py`, tests/test_program_store.py):

- `canonical_plan` equal to the reference's on its matrix (ladder, sort,
  padding, order erasure, the MAX_SLOTS overflow, the switch off);
- the decoded `ColumnarBatch` under canonical layouts byte for byte the
  exact layout's, the reference decoder's and the CPU codec's, on the
  reference's byte-identity cases through `DeviceDecoder(device="cpu")`;
- the host route (the reference's TestHostVectorPath, restated);
- the observed signatures (the reference's TestObservedSignatures);
- the store's persistence contract on a small C source compiled with
  the system compiler, so that digest, dlopen and bind really run: a
  round trip with 0 builds, corrupt → invalid + deleted + rebuilt, a
  key mismatch, a version-tag invalidation, a library that does not
  bind, concurrent first uses, two processes on one directory.

Tolerance: none — equal plans, equal batches, equal counts.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from etl_tpu.models import Oid
from etl_tpu.models.pgtypes import CellKind as RefKind
from etl_tpu.ops import program_store as ref_store
from etl_tpu.ops.engine import DeviceDecoder as RefDecoder
from etl_tpu_torch.models.pgtypes import CellKind as K
from etl_tpu_torch.ops import engine, program_store
from etl_tpu_torch.ops.engine import DeviceDecoder
from etl_tpu_torch.telemetry.metrics import (ETL_COMPILE_CACHE_HITS_TOTAL,
                                             ETL_COMPILE_CACHE_MISSES_TOTAL,
                                             ETL_PROGRAMS_COMPILED_TOTAL,
                                             registry)
from tests.test_torch_decoder import (assert_same_batch, make_schema,
                                      port_schema, port_staged,
                                      staged_from_texts)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_store():
    yield
    program_store.configure(None)
    program_store.reset_for_tests()


def _specs(kind_mod, *triples):
    """Synthetic engine specs (col_idx, kind, w, bw) with sequential col
    indices, kinds named for `kind_mod` (the port's or the reference's
    CellKind)."""
    return tuple((i, kind_mod[k], w, bw)
                 for i, (k, w, bw) in enumerate(triples))


def _plain(plan) -> tuple:
    return (tuple((i, k.name, w, bw) for i, k, w, bw in plan.specs),
            plan.slot_of, plan.pack_dense, plan.phantom_slots, plan.identity)


PLAN_CASES = {
    "identity": [("I32", 12, 12)] * 2,
    "sorts_and_pads": [("I32", 12, 12)] * 2 + [("I64", 20, 20)]
    + [("I32", 12, 12)] * 3,
    "full_six": [("I32", 12, 12)] * 6 + [("I64", 20, 20)],
    "order_a": [("I64", 20, 20), ("F64", 32, 24)],
    "order_b": [("F64", 32, 24), ("I64", 20, 20)],
    "max_slots": [t for g in range(52)
                  for t in [("I32", 4 + 4 * (g % 50), 10)] * 5],
    "pgbench": [("I32", 8, 6), ("I32", 4, 2), ("I32", 12, 10)],
    "mixed": [("BOOL", 4, 2), ("DATE", 16, 10), ("I16", 8, 6),
              ("DATE", 16, 10), ("TIMESTAMPTZ", 32, 26), ("BOOL", 4, 2),
              ("BOOL", 4, 2), ("F32", 16, 12)],
}


class TestCanonicalPlan:
    def test_pad_count_ladder(self):
        assert [program_store.pad_count(n) for n in range(1, 300)] \
            == [ref_store.pad_count(n) for n in range(1, 300)]
        assert program_store._COUNT_BUCKETS == ref_store._COUNT_BUCKETS
        assert program_store.MAX_SLOTS == ref_store.MAX_SLOTS == 256

    @pytest.mark.parametrize("name", sorted(PLAN_CASES))
    @pytest.mark.parametrize("canonicalize", [True, False],
                             ids=["on", "off"])
    def test_plan_equals_the_reference(self, name, canonicalize,
                                       monkeypatch):
        monkeypatch.setattr(program_store, "CANONICALIZE", canonicalize)
        monkeypatch.setattr(ref_store, "CANONICALIZE", canonicalize)
        program_store._PLAN_CACHE.clear()
        ref_store._PLAN_CACHE.clear()
        try:
            port = program_store.canonical_plan(
                _specs(K.__members__, *PLAN_CASES[name]))
            ref = ref_store.canonical_plan(
                _specs(RefKind.__members__, *PLAN_CASES[name]))
        finally:
            program_store._PLAN_CACHE.clear()
            ref_store._PLAN_CACHE.clear()
        assert _plain(port) == _plain(ref)
        if not canonicalize:
            assert port.identity and not port.phantom_slots

    def test_max_slots_falls_back_to_sort_only(self):
        plan = program_store.canonical_plan(
            _specs(K.__members__, *PLAN_CASES["max_slots"]))
        assert plan.n_slots == 260 and not plan.phantom_slots

    def test_pgbench_is_a_permutation(self):
        """pgbench's three INT4 columns differ in width and bit width, so
        their canonical layout sorts them: a permutation, no padding."""
        plan = program_store.canonical_plan(
            _specs(K.__members__, *PLAN_CASES["pgbench"]))
        assert not plan.identity and not plan.phantom_slots
        assert plan.slot_of == (1, 0, 2)

    def test_layout_gauge_counts_distinct_layouts(self):
        from etl_tpu_torch.telemetry.metrics import \
            ETL_DECODE_CANONICAL_LAYOUTS

        program_store.reset_for_tests()
        for name in ("order_a", "order_b", "identity"):
            program_store.canonical_plan(
                _specs(K.__members__, *PLAN_CASES[name]))
        assert registry.get_gauge(ETL_DECODE_CANONICAL_LAYOUTS) == 2

    def test_host_layout_shared_across_permuted_schemas(self):
        d1 = DeviceDecoder(port_schema(make_schema(
            [Oid.INT8, Oid.FLOAT8, Oid.INT4])), device="cpu")
        d2 = DeviceDecoder(port_schema(make_schema(
            [Oid.INT4, Oid.INT8, Oid.FLOAT8])), device="cpu")
        assert program_store.canonical_plan(d1._host_specs()).specs \
            == program_store.canonical_plan(d2._host_specs()).specs


MATRIX_OIDS = [Oid.BOOL, Oid.INT2, Oid.INT4, Oid.INT8, Oid.FLOAT4,
               Oid.FLOAT8, Oid.DATE, Oid.TIME, Oid.TIMESTAMP,
               Oid.TIMESTAMPTZ, Oid.TEXT, Oid.NUMERIC]

MATRIX_ROWS = [
    ["t", "1", "2", "3", "1.5", "2.5", "2024-01-02", "03:04:05",
     "2024-01-02 03:04:05", "2024-01-02 03:04:05+00", "x", "1.0"],
    ["f", "-32768", "-2147483648", "-9223372036854775808",
     "-1.17549e-38", "-2.2250738585072014e-308", "1999-12-31",
     "23:59:59.999999", "9999-12-31 23:59:59.999999",
     "0001-01-01 00:00:00+15:59", "long text value " * 4,
     "-123456.789012"],
    [None] * 12,
    ["t", "7", "8", "9", "0.0", "-0.0", "2000-02-29", "00:00:00",
     "1970-01-01 00:00:00", "2024-06-01 12:00:00-08", "", "0"],
]




def _decode_three_ways(oids, rows, **kw):
    """The same staged batch through the port canonical, the port exact
    (the switch off) and the reference (canonical, its XLA program)."""
    ref_schema = make_schema(oids)
    staged = staged_from_texts(rows, len(oids))
    ref_kw = {"mesh": None, "device_min_rows": kw.get("device_min_rows", 0)}
    if "host_min_rows" in kw:
        ref_kw["host_min_rows"] = kw["host_min_rows"]
    ref = RefDecoder(ref_schema, **ref_kw).decode(staged)
    schema = port_schema(ref_schema)
    canon = DeviceDecoder(schema, device="cpu", **kw).decode(
        port_staged(staged))
    old = program_store.CANONICALIZE
    program_store.CANONICALIZE = False
    program_store._PLAN_CACHE.clear()
    try:
        exact = DeviceDecoder(schema, device="cpu", **kw).decode(
            port_staged(staged))
    finally:
        program_store.CANONICALIZE = old
        program_store._PLAN_CACHE.clear()
    return ref, canon, exact


def _assert_codec(batch, rows, oids):
    """The batch equals the CPU codec's rows, built into a ColumnarBatch
    (so a float4 compares as the float32 it is stored as)."""
    from etl_tpu_torch.models.table_row import ColumnarBatch, TableRow
    from etl_tpu_torch.postgres.codec.text import parse_cell_text

    codec = ColumnarBatch.from_rows(batch.schema, [TableRow(
        [None if v is None else parse_cell_text(v, oid)
         for v, oid in zip(r, oids)]) for r in rows])
    assert_same_batch(codec, batch)


class TestCanonicalByteIdentity:
    """Canonical == exact == reference == CPU codec, byte for byte."""

    def test_kind_width_matrix(self):
        rows = MATRIX_ROWS * 64
        ref, canon, exact = _decode_three_ways(MATRIX_OIDS, rows,
                                               device_min_rows=0)
        assert_same_batch(ref, canon)
        assert_same_batch(ref, exact)
        _assert_codec(canon, rows, MATRIX_OIDS)

    def test_host_route_matrix(self):
        rows = MATRIX_ROWS * 32
        b0 = engine.routed_host_batches
        ref, canon, exact = _decode_three_ways(
            MATRIX_OIDS, rows, device_min_rows=1 << 30, host_min_rows=1)
        assert engine.routed_host_batches == b0 + 2
        assert_same_batch(ref, canon)
        assert_same_batch(ref, exact)

    def test_phantom_padding_byte_identity(self):
        oids = [Oid.INT4] * 5 + [Oid.INT8]
        rows = [[str(100 + i % 800), str(100 + (i * 7) % 800),
                 None if i % 5 == 0 else str(200 + i % 700),
                 str(100 + (i * 3) % 800), str(999 - i % 800),
                 None if i % 7 == 0 else str(i * 1000)]
                for i in range(200)]
        staged = port_staged(staged_from_texts(rows, len(oids)))
        dec = DeviceDecoder(port_schema(make_schema(oids)), device="cpu",
                            device_min_rows=0)
        plan = program_store.canonical_plan(
            dec._specs(staged, dec._widths(staged)))
        assert plan.phantom_slots, "scenario must actually pad"
        ref, canon, exact = _decode_three_ways(oids, rows,
                                               device_min_rows=0)
        assert_same_batch(ref, canon)
        assert_same_batch(ref, exact)

    def test_nibble_path_with_phantoms(self):
        oids = [Oid.INT4] * 5 + [Oid.DATE]
        rows = [[str(100 + i), str(101 + i), str(102 + i), str(103 + i),
                 str(104 + i), "2024-03-0%d" % (1 + i % 9)]
                for i in range(100)]
        staged = port_staged(staged_from_texts(rows, len(oids)))
        dec = DeviceDecoder(port_schema(make_schema(oids)), device="cpu",
                            device_min_rows=0)
        packed = dec._pack_stage(staged, dec._specs(staged,
                                                    dec._widths(staged)))
        assert packed.nibble, "scenario must exercise the nibble pack"
        assert packed.plan is not None and packed.plan.phantom_slots
        # phantom slots are all-NULL: zero length, zero bytes
        assert not packed.lengths[:, list(packed.plan.phantom_slots)].any()
        ref, canon, exact = _decode_three_ways(oids, rows,
                                               device_min_rows=0)
        assert_same_batch(ref, canon)
        assert_same_batch(ref, exact)

    def test_oracle_fallback_rows_identical(self):
        oids = [Oid.INT4, Oid.INT4, Oid.TEXT]
        rows = [["0" * 57 + str(100 + i), str(i), "v"] for i in range(150)]
        ref, canon, exact = _decode_three_ways(oids, rows,
                                               device_min_rows=0)
        assert_same_batch(ref, canon)
        assert_same_batch(ref, exact)

    def test_egress_text_under_a_permuted_layout(self):
        """Device egress renders from canonical slots and materializes by
        schema column: the text equals the exact layout's."""
        oids = [Oid.INT8, Oid.INT4, Oid.DATE, Oid.INT4]
        rows = [[str(i * 1000003), str(i % 7), "2024-03-%02d" % (1 + i % 28),
                 str(-i)] for i in range(300)]
        staged = port_staged(staged_from_texts(rows, len(oids)))
        schema = port_schema(make_schema(oids))
        dec = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                            egress="tsv")
        assert not program_store.canonical_plan(
            dec._specs(staged, dec._widths(staged))).identity
        canon = dec.decode(staged).device_egress
        program_store.CANONICALIZE = False
        program_store._PLAN_CACHE.clear()
        try:
            exact = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                                  egress="tsv").decode(staged).device_egress
        finally:
            program_store.CANONICALIZE = True
            program_store._PLAN_CACHE.clear()
        assert sorted(canon.fields) == sorted(exact.fields)
        for col, (buf, lens) in exact.fields.items():
            cbuf, clens = canon.fields[col]
            np.testing.assert_array_equal(lens, clens)
            for i in range(len(lens)):
                assert bytes(buf[i, :lens[i]]) == bytes(cbuf[i, :clens[i]])


class TestHostVectorPath:
    """The reference's TestHostVectorPath on the port: batches of
    host_min_rows ≤ n < device_min_rows take the host route (X1's plain
    version on CPU tensors, fixed host widths), equal to the reference's
    host-route batch and the CPU codec."""

    OIDS = [Oid.INT8, Oid.INT4, Oid.FLOAT8, Oid.DATE, Oid.TIMESTAMPTZ,
            Oid.TEXT]

    def _rows(self, n, start=0):
        return [[str((i * 7919) % 2**62 - 2**61), str(i % 97), f"{i}.25",
                 "2024-05-01", "2024-05-01 12:34:56.789+05:30",
                 f"note-{i}"] for i in range(start, start + n)]

    def _decoder(self, oids):
        # a CUDA decoder's routing, on CPU tensors
        return DeviceDecoder(port_schema(make_schema(oids)), device="cpu",
                             device_min_rows=1 << 30,
                             host_min_rows=DeviceDecoder.HOST_MIN_ROWS)

    def test_host_route_matches_reference_and_oracle(self):
        rows = self._rows(500)
        staged = staged_from_texts(rows, len(self.OIDS))
        ref_dec = RefDecoder(make_schema(self.OIDS), mesh=None)
        assert ref_dec.host_min_rows <= 500 < ref_dec.device_min_rows
        ref = ref_dec.decode(staged)
        assert any(key[-1] for key in ref_dec._fn_cache)  # its host path
        dec = self._decoder(self.OIDS)
        h0, d0 = engine.routed_host_batches, engine.routed_device_batches
        port = dec.decode(port_staged(staged))
        assert engine.routed_host_batches == h0 + 1
        assert engine.routed_device_batches == d0
        assert_same_batch(ref, port)
        _assert_codec(port, rows, self.OIDS)

    def test_layout_stable_across_field_lengths(self):
        dec = self._decoder(self.OIDS)
        short = [["1", "2", "3.5", "2024-01-02", "2024-01-02 03:04:05+00",
                  "a"]] * 100
        long = [["-9223372036854775808", "-2147483648",
                 "-1.7976931348623157e+308", "2024-12-31",
                 "2024-12-31 23:59:59.999999+15:59:59", "b" * 300]] * 100
        routes = [dec._route(port_staged(staged_from_texts(r, 6)))
                  for r in (short, long)]
        assert routes[0] == routes[1] and routes[0][0] == "host"
        assert routes[0][1] == dec._host_specs()

    def test_oversize_fields_fall_back_correctly(self):
        oids = [Oid.INT8, Oid.DATE]
        rows = [[str(i), "2024-05-01"] for i in range(120)]
        rows[7] = [str(2**62), "0044-03-15 BC"]
        staged = staged_from_texts(rows, 2)
        ref = RefDecoder(make_schema(oids), mesh=None).decode(staged)
        port = self._decoder(oids).decode(port_staged(staged))
        assert_same_batch(ref, port)
        assert port.columns[0].value(7) == 2**62

    def test_below_host_min_uses_oracle(self):
        dec = self._decoder(self.OIDS)
        o0 = engine.routed_oracle_batches
        rows = self._rows(dec.host_min_rows - 1)
        dec.decode(port_staged(staged_from_texts(rows, len(self.OIDS))))
        assert engine.routed_oracle_batches == o0 + 1

    def test_cpu_decoder_has_no_host_route(self):
        """On `device="cpu"` "device" and "host" are one backend: the
        default decoder keeps the device route from 64 rows and no host
        route (the tests that count device-routed batches rely on it)."""
        dec = DeviceDecoder(port_schema(make_schema(self.OIDS)),
                            device="cpu")
        assert dec.device_min_rows == DeviceDecoder.DEVICE_MIN_ROWS == 64
        assert dec.host_min_rows is None
        assert dec._route(port_staged(staged_from_texts(
            self._rows(100), 6)))[0] == "device"


class TestObservedSignatures:
    def test_record_load_roundtrip_and_corruption(self, tmp_path):
        program_store.reset_for_tests()
        program_store.configure(str(tmp_path))
        key = (256, ((0, K.I32, 4, 8),), False, None, None, "device")
        program_store.record_observed(key)
        program_store.record_observed(key)  # idempotent per process
        assert program_store.load_observed() == [key]
        path = program_store._observed_path(str(tmp_path))
        with open(path, "wb") as f:
            f.write(b"garbage")
        assert program_store.load_observed() == []
        assert not os.path.exists(path)

    def test_observed_cap_ages_out_oldest(self, tmp_path):
        program_store.reset_for_tests()
        program_store.configure(str(tmp_path))
        for i in range(program_store._OBSERVED_MAX + 5):
            program_store.record_observed((i,))
        keys = program_store.load_observed()
        assert len(keys) == program_store._OBSERVED_MAX == \
            ref_store._OBSERVED_MAX
        assert keys[0] == (5,)
        assert keys[-1] == (program_store._OBSERVED_MAX + 4,)

    def test_no_cache_dir_records_nothing(self, tmp_path, monkeypatch):
        monkeypatch.delenv("ETL_TPU_PROGRAM_CACHE_DIR", raising=False)
        program_store.reset_for_tests()
        program_store.record_observed((1,))
        assert program_store.load_observed() == []

    def test_dispatch_records_its_signature(self, tmp_path):
        program_store.reset_for_tests()
        program_store.configure(str(tmp_path))
        oids = [Oid.INT4, Oid.INT8]
        rows = [[str(i), str(i * 3)] for i in range(100)]
        schema = port_schema(make_schema(oids))
        host = DeviceDecoder(schema, device="cpu", device_min_rows=1 << 30,
                             host_min_rows=1)
        host.decode(port_staged(staged_from_texts(rows, 2)))
        DeviceDecoder(schema, device="cpu").decode(
            port_staged(staged_from_texts(rows, 2)))
        keys = program_store.load_observed()
        assert {k[5] for k in keys} == {"host", "device"}
        assert {k[3] for k in keys} == {None}  # no mesh
        host_key = next(k for k in keys if k[5] == "host")
        assert host_key[1] == program_store.canonical_plan(
            host._host_specs()).specs
        assert program_store.observed_layouts() == {"device": 1, "host": 1}
        stats = program_store.warm_observed_signatures("cpu")
        assert stats == {"observed": 2, "observed_ready": 2}

    def test_probe_decoders_record_nothing(self, tmp_path):
        program_store.reset_for_tests()
        program_store.configure(str(tmp_path))
        DeviceDecoder(port_schema(make_schema([Oid.INT4])), device="cpu",
                      telemetry=False).decode(port_staged(staged_from_texts(
                          [[str(i)] for i in range(70)], 1)))
        assert program_store.load_observed() == []

    async def test_prewarm_pipeline_folds_observed(self, tmp_path):
        from etl_tpu_torch.config import BatchConfig
        from etl_tpu_torch.store import NotifyingStore

        program_store.reset_for_tests()
        cfg = BatchConfig(program_cache_dir=str(tmp_path),
                          prewarm_programs=True, device="cpu")
        program_store.configure(str(tmp_path))
        program_store.record_observed(
            (256, ((0, K.I32, 4, 8),), False, None, None, "host"))
        program_store.reset_for_tests()  # a new process's guard
        stats = await program_store.prewarm_pipeline(NotifyingStore(), cfg)
        assert stats["observed"] == 1 and stats["layouts"] == 0
        assert program_store.active_dir() == str(tmp_path)

    async def test_prewarm_dedupes_layouts_across_schemas(self, tmp_path):
        from etl_tpu_torch.config import BatchConfig
        from etl_tpu_torch.store import NotifyingStore

        from etl_tpu_torch.models import (ColumnSchema,
                                          ReplicatedTableSchema,
                                          TableName, TableSchema)
        from etl_tpu_torch.models import Oid as POid

        store = NotifyingStore()
        for tid, oids in ((1, [POid.INT8, POid.INT4, POid.DATE]),
                          (2, [POid.DATE, POid.INT8, POid.INT4]),
                          (3, [POid.BOOL])):
            await store.store_table_schema(
                ReplicatedTableSchema.with_all_columns(TableSchema(
                    tid, TableName("public", f"t{tid}"),
                    tuple(ColumnSchema(f"c{i}", o)
                          for i, o in enumerate(oids)))), 0)
        cfg = BatchConfig(program_cache_dir=str(tmp_path), device="cpu",
                          prewarm_row_buckets=(256, 1024))
        stats = await program_store.prewarm_pipeline(store, cfg)
        assert stats["layouts"] == 4  # 2 layouts × 2 buckets
        assert stats["ready"] == 4 and stats["building"] == 0

    async def test_no_cache_dir_no_prewarm(self):
        from etl_tpu_torch.config import BatchConfig
        from etl_tpu_torch.store import NotifyingStore

        assert await program_store.prewarm_pipeline(
            NotifyingStore(), BatchConfig(device="cpu")) == {}


class TestPipelineStart:
    """`Pipeline.start` builds the kernel libraries before any resource
    opens, and a prewarm that fails after the destination's startup
    stops what started: either way nothing is left running."""

    @staticmethod
    def _pipeline(device: str):
        from etl_tpu_torch.config import (BatchConfig, BatchEngine,
                                          PipelineConfig)
        from etl_tpu_torch.destinations import MemoryDestination
        from etl_tpu_torch.postgres.fake import FakeDatabase, FakeSource
        from etl_tpu_torch.runtime import Pipeline
        from etl_tpu_torch.store import NotifyingStore

        class Recording(MemoryDestination):
            events: list = []

            async def startup(self):
                self.events.append("startup")
                await super().startup()

            async def shutdown(self):
                self.events.append("shutdown")
                await super().shutdown()

        connects = []

        class Source(FakeSource):
            async def connect(self):
                connects.append(1)
                await super().connect()

        db = FakeDatabase()
        db.create_publication("pub", [])
        dest = Recording()
        dest.events = []
        pipeline = Pipeline(
            config=PipelineConfig(
                pipeline_id=1, publication_name="pub",
                batch=BatchConfig(batch_engine=BatchEngine.CUDA,
                                  device=device)),
            store=NotifyingStore(), destination=dest,
            source_factory=lambda: Source(db))
        return pipeline, dest, connects

    async def test_failed_build_opens_nothing(self, monkeypatch):
        from etl_tpu_torch.ops import autotune, decode_kernel
        from etl_tpu_torch.runtime import pipeline as pipeline_mod

        async def no_model():
            return None

        def failed_build():
            raise RuntimeError("nvcc failed")

        monkeypatch.setattr(pipeline_mod.torch.cuda, "is_available",
                            lambda: True)
        monkeypatch.setattr(autotune, "prewarm", no_model)
        monkeypatch.setattr(decode_kernel, "load", failed_build)
        pipeline, dest, connects = self._pipeline("cuda")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            await pipeline.start()
        assert connects == [] and dest.events == []
        assert pipeline.supervisor._task is None
        assert pipeline._apply_task is None

    async def test_failed_prewarm_shuts_the_destination(self, monkeypatch):
        async def failed_prewarm(*a, **kw):
            raise RuntimeError("prewarm failed")

        monkeypatch.setattr(program_store, "prewarm_pipeline",
                            failed_prewarm)
        pipeline, dest, connects = self._pipeline("cpu")
        with pytest.raises(RuntimeError, match="prewarm failed"):
            await pipeline.start()
        assert connects == [1]
        assert dest.events == ["startup", "shutdown"]
        assert pipeline.supervisor._task is None
        assert pipeline._apply_task is None


# ---------------------------------------------------------------------------
# the persistence contract, on a C library
# ---------------------------------------------------------------------------

PROBE_C = "int probe_value(void) { return %d; }\n"


def _probe_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.probe_value.restype = ctypes.c_int
    lib.probe_value.argtypes = []
    return lib


def _probe(tmp_path: Path, value: int = 7, bind=_probe_bind,
           name: str = "probe") -> program_store.Library:
    src = tmp_path / f"{name}.c"
    src.write_text(PROBE_C % value)
    return program_store.Library(name, src, lambda: "cc",
                                 ("-O1", "-shared", "-fPIC"), bind,
                                 timeout_s=60)


def _counts() -> dict:
    return {"built": registry.get_counter(ETL_PROGRAMS_COMPILED_TOTAL),
            "disk": registry.get_counter(ETL_COMPILE_CACHE_HITS_TOTAL,
                                         {"layer": "disk"}),
            "memory": registry.get_counter(ETL_COMPILE_CACHE_HITS_TOTAL,
                                           {"layer": "memory"}),
            "absent": registry.get_counter(ETL_COMPILE_CACHE_MISSES_TOTAL,
                                           {"reason": "absent"}),
            "invalid": registry.get_counter(ETL_COMPILE_CACHE_MISSES_TOTAL,
                                            {"reason": "invalid"})}


def _delta(before: dict) -> dict:
    now = _counts()
    return {k: now[k] - before[k] for k in now}


def _entry(lib: program_store.Library, cache: Path) -> tuple:
    d = cache / lib.tag()
    meta = d / (program_store.fingerprint(lib.key()) + ".meta")
    return d, meta, d / json.loads(meta.read_text())["file"]


def _garble(path: Path) -> None:
    tmp = path.with_name(path.name + ".g")
    tmp.write_bytes(b"\x7fELF garbage, not a shared library")
    os.replace(tmp, path)


class TestPersistence:
    def test_roundtrip_builds_once(self, tmp_path):
        cache = tmp_path / "cache"
        program_store.configure(str(cache))
        lib = _probe(tmp_path)
        c0 = _counts()
        got = program_store.acquire(lib)
        assert got.source == "build" and got.lib.probe_value() == 7
        assert got.build_seconds is not None
        assert _delta(c0) == {"built": 1, "disk": 0, "memory": 0,
                              "absent": 1, "invalid": 0}
        c1 = _counts()
        assert program_store.acquire(lib).source == "memory"
        program_store.forget_memory()
        again = program_store.acquire(lib)
        assert again.source == "disk" and again.lib.probe_value() == 7
        assert _delta(c1) == {"built": 0, "disk": 1, "memory": 1,
                              "absent": 0, "invalid": 0}
        d, meta, so = _entry(lib, cache)
        assert so.name.startswith(program_store.fingerprint(lib.key()))
        assert not [p for p in d.iterdir() if ".tmp" in p.name]

    @pytest.mark.parametrize("part", ["library", "metadata"])
    def test_corrupt_file_degrades_to_rebuild(self, tmp_path, part):
        cache = tmp_path / "cache"
        program_store.configure(str(cache))
        lib = _probe(tmp_path)
        program_store.acquire(lib)
        d, meta, so = _entry(lib, cache)
        _garble(so if part == "library" else meta)
        program_store.forget_memory()
        c0 = _counts()
        # the garbage is never mapped: the digest check comes first
        assert program_store.try_load(lib.key(), lib.tag(), lib.bind) is None
        assert not meta.exists() and not so.exists()
        got = program_store.acquire(lib)
        assert got.source == "build" and got.lib.probe_value() == 7
        assert _delta(c0)["invalid"] == 1 and _delta(c0)["built"] == 1

    def test_key_mismatch_is_invalid(self, tmp_path):
        cache = tmp_path / "cache"
        program_store.configure(str(cache))
        lib = _probe(tmp_path)
        program_store.acquire(lib)
        _, meta, _ = _entry(lib, cache)
        data = json.loads(meta.read_text())
        data["key"] = "('another',)"
        meta.write_text(json.dumps(data))
        program_store.forget_memory()
        c0 = _counts()
        assert program_store.acquire(lib).source == "build"
        assert _delta(c0)["invalid"] == 1

    def test_version_tag_invalidation(self, tmp_path):
        """A changed source is another tag: the old entry is never read,
        and the new library is what runs (no stale dlopen handle)."""
        cache = tmp_path / "cache"
        program_store.configure(str(cache))
        old = _probe(tmp_path, 7)
        old_tag = old.tag()
        assert program_store.acquire(old).lib.probe_value() == 7
        new = _probe(tmp_path, 8)
        assert new.tag() != old_tag
        c0 = _counts()
        got = program_store.acquire(new)
        assert got.source == "build" and got.lib.probe_value() == 8
        assert _delta(c0)["absent"] == 1
        assert (cache / old_tag).is_dir()
        flags = program_store.Library("probe", new.source, lambda: "cc",
                                      ("-O2", "-shared", "-fPIC"),
                                      _probe_bind)
        assert flags.tag() != new.tag()
        assert program_store.version_tag("a") != program_store.version_tag(
            "b")

    def test_library_that_does_not_bind(self, tmp_path):
        """A stored library that `bind` refuses is an invalid miss; a
        fresh build that does not bind raises (no fallback)."""
        cache = tmp_path / "cache"
        program_store.configure(str(cache))
        program_store.acquire(_probe(tmp_path))
        program_store.forget_memory()

        def refuse(lib):
            raise RuntimeError("does not fit its source")

        c0 = _counts()
        with pytest.raises(RuntimeError, match="does not fit"):
            program_store.acquire(_probe(tmp_path, bind=refuse))
        assert _delta(c0)["invalid"] == 1 and _delta(c0)["built"] == 1

    def test_failed_build_raises_and_leaves_nothing(self, tmp_path):
        cache = tmp_path / "cache"
        program_store.configure(str(cache))
        lib = _probe(tmp_path)
        lib.source.write_text("int probe_value(void) { return }\n")
        with pytest.raises(RuntimeError, match="failed"):
            program_store.acquire(lib)
        assert not any(cache.rglob("*.so*")) and not any(
            cache.rglob("*.meta"))

    def test_concurrent_first_uses_build_once(self, tmp_path):
        """More threads than cores acquire one library at once, with a
        shortened switch interval: one build, one library, every thread
        served (a lost update of the memory layer would build twice)."""
        import threading

        cache = tmp_path / "cache"
        program_store.configure(str(cache))
        lib = _probe(tmp_path, 5)
        c0 = _counts()
        got: list = []
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(
                target=lambda: got.append(program_store.acquire(lib)))
                for _ in range(4 * (os.cpu_count() or 4))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        assert len(got) == len(threads)
        assert _delta(c0)["built"] == 1
        assert len({id(g.lib) for g in got}) == 1
        assert all(g.lib.probe_value() == 5 for g in got)

    def test_export_entry_seeds_another_dir(self, tmp_path):
        program_store.configure(str(tmp_path / "a"))
        lib = _probe(tmp_path)
        program_store.acquire(lib)
        program_store.export_entry(lib, str(tmp_path / "b"))
        program_store.configure(str(tmp_path / "b"))
        program_store.forget_memory()
        c0 = _counts()
        assert program_store.acquire(lib).source == "disk"
        assert _delta(c0)["built"] == 0

    def test_two_process_cache_dir_sharing(self, tmp_path):
        """Process A builds into a shared dir; process B, a fresh
        interpreter, loads A's library with zero builds."""
        cache = tmp_path / "shared"
        src = tmp_path / "probe.c"
        src.write_text(PROBE_C % 11)
        code = f"""
import ctypes, json, sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from etl_tpu_torch.ops import program_store as ps
from etl_tpu_torch.telemetry.metrics import registry, \\
    ETL_PROGRAMS_COMPILED_TOTAL, ETL_COMPILE_CACHE_HITS_TOTAL
def bind(lib):
    lib.probe_value.restype = ctypes.c_int
    return lib
ps.configure({str(cache)!r})
lib = ps.Library("probe", Path({str(src)!r}), lambda: "cc",
                 ("-O1", "-shared", "-fPIC"), bind)
got = ps.acquire(lib)
print(json.dumps([got.source, got.lib.probe_value(),
    registry.get_counter(ETL_PROGRAMS_COMPILED_TOTAL),
    registry.get_counter(ETL_COMPILE_CACHE_HITS_TOTAL,
                         {{"layer": "disk"}})]))
"""
        outs = []
        for _ in range(2):
            proc = subprocess.run([sys.executable, "-c", code],
                                  capture_output=True, text=True,
                                  timeout=120, cwd=tmp_path)
            assert proc.returncode == 0, proc.stderr[-2000:]
            outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        assert outs == [["build", 11, 1, 0], ["disk", 11, 0, 1]]


class TestPortLibraries:
    def test_framer_goes_through_the_store(self, tmp_path):
        """The packers and framer are the CPU route's compiled object: a
        new process on a seeded directory loads them with no build."""
        from etl_tpu_torch import native

        program_store.export_entry(native.LIBRARY, str(tmp_path))
        program_store.configure(str(tmp_path))
        program_store.forget_memory()
        c0 = _counts()
        got = program_store.acquire(native.LIBRARY)
        assert got.source == "disk" and _delta(c0)["built"] == 0
        assert program_store.libraries("cpu") == [native.LIBRARY]

    def test_cuda_libraries_key_on_the_card(self):
        from etl_tpu_torch.ops import decode_kernel, egress_kernel

        for lib in (decode_kernel.LIBRARY, egress_kernel.LIBRARY):
            assert lib.cuda and lib.flags == decode_kernel.NVCC_FLAGS
            assert lib.source.exists()
        assert decode_kernel.LIBRARY.key() != egress_kernel.LIBRARY.key()
